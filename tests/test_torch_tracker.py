"""The port's keyframe BA tracker (tracker.py) and the demo's tracking flow
(inference_demo.apply_tracking) against the JAX package, fp32, on the CPU.

The scene is a textured plane with known poses
(``utils/synthetic.py::plane_sequence``, the role of
tests/test_tracker.py::make_plane_sequence): 160x160 frames, 48 plane
points in 64 keypoint slots. The JAX tracker runs once per module (its
fused step compiles in about 30 s); the port gets the JAX tracker's
RANSAC noise, drawn from the same key splits.

Tolerances, each with its reason:
- one track step: m0, keep, the counts and the flags equal; the pose
  within 1e-5 (measured 1.5e-7: the same hypotheses and winner, fp32
  rounding only); the two-view points within 1e-4 (measured 1.2e-5, the
  analytic 3x3 inverse of a normal matrix of about 1e5 scale); the LK
  points within 1e-3 px where tracked;
- the tracked sequence: every frame within 1.5 cm / 1.5 deg of the ground
  truth (tests/test_tracker.py's bound) and within 1e-4 of the JAX
  tracker's pose (measured 3e-7; the window BA's camera solve is well
  posed, its sums run in another order).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from onepose_tpu import tracker as jtr
from onepose_tpu_torch import tracker as ttr
from onepose_tpu_torch.inference_demo import apply_tracking
from onepose_tpu_torch.ops import epnp as tep
from onepose_tpu_torch.pipeline import PoseOutput
from onepose_tpu_torch.utils import geometry as geo
from onepose_tpu_torch.utils.synthetic import plane_sequence
from test_torch_epnp import _jax_noise

HYP, WIN, SLOTS, N_PTS = 128, 6, 64, 48
POSE_CM = POSE_DEG = 1.5


@pytest.fixture(scope="module")
def scene():
    return plane_sequence(np.random.default_rng(0), 4, hw=160, focal=150.0,
                          n_points=N_PTS, slots=SLOTS, desc_dim=64,
                          rot_step=(0.06, 0.1, 0.02),
                          trans_step=(0.01, -0.005))


def _track_noise(key, n_kf=SLOTS, n_q=SLOTS):
    """JAX's _track_step draws for ``key``, as the port's TrackNoise."""
    key_flow, key_pnp = jax.random.split(key)
    return ttr.TrackNoise(*(
        tep.RansacNoise(*(torch.from_numpy(x)[None]
                          for x in _jax_noise(k, n, HYP)))
        for k, n in ((key_flow, n_kf), (key_pnp, n_q))))


def _step_args(scene, n_known=32):
    """Keyframe 0 → query 1, with only the first ``n_known`` plane points
    carrying a 3D id (so the two-view triangulation has work)."""
    K, pts3d, frames = scene
    f0, f1 = frames
    K32 = K.astype(np.float32)
    src_ok = np.zeros(SLOTS, bool)
    src_ok[:n_known] = True
    pts = np.zeros((SLOTS, 3), np.float32)
    pts[:N_PTS] = pts3d
    return [f0["image"], f1["image"], f0["keypoints"], f0["descriptors"],
            f0["mask"], src_ok, pts, f1["keypoints"], f1["descriptors"],
            f1["mask"], np.eye(3, 4, dtype=np.float32), True, K32,
            K32 @ f0["pose"].astype(np.float32)]


def _jax_tracker(scene):
    """The JAX tracker over the sequence: (poses, infos, per-frame keys)."""
    K, pts3d, frames = scene
    f0 = frames[0]
    tr = jtr.BATracker(win_size=WIN, pnp_hypotheses=HYP, ba_iterations=6)
    assert tr.add_keyframe(f0["image"], f0["keypoints"], f0["descriptors"],
                           f0["mask"], f0["pose"], K, mkpts3d=pts3d,
                           kpt_indices=np.arange(N_PTS))
    poses, infos, keys = [], [], []
    for fr in frames[1:]:
        keys.append(jax.random.split(tr.key)[1])   # what track() draws
        pose, info = tr.track(fr["image"], fr["keypoints"],
                              fr["descriptors"], fr["mask"], K)
        poses.append(pose)
        infos.append(info)
    return poses, infos, keys


@pytest.fixture(scope="module")
def jax_runs(scene):
    """One JAX step (keyframe 0 → frame 1, partly known) and the JAX
    tracker over the sequence; both share one compile of _track_step."""
    key = jax.random.PRNGKey(3)
    args = _step_args((scene[0], scene[1], scene[2][:2]))
    vec = jtr._track_step(*[jnp.asarray(a) if not isinstance(a, bool) else a
                            for a in args], key, num_hypotheses=HYP,
                          gate_scale=1.2)
    step = jtr._unpack_track(np.asarray(vec), SLOTS, SLOTS)
    return {"step": (key, args, step), "tracker": _jax_tracker(scene)}


def _port_tracker(scene, **kw):
    K, pts3d, frames = scene
    f0 = frames[0]
    tr = ttr.BATracker(win_size=WIN, pnp_hypotheses=HYP, ba_iterations=6,
                       device="cpu", **kw)
    assert tr.add_keyframe(f0["image"], f0["keypoints"], f0["descriptors"],
                           f0["mask"], f0["pose"], K, mkpts3d=pts3d,
                           kpt_indices=np.arange(N_PTS))
    return tr


def test_tri_two_view_matches_jax():
    rng = np.random.default_rng(3)
    n = 32
    pts3d = rng.uniform(-0.15, 0.15, (n, 3)).astype(np.float32)
    K = np.array([[300.0, 0, 160], [0, 300.0, 160], [0, 0, 1]], np.float32)
    poses = [np.concatenate([geo.rodrigues(r), [[t[0]], [t[1]], [t[2]]]], 1)
             for r, t in (([0.2, 0.0, 0.0], (0.0, 0.0, 0.5)),
                          ([0.35, 0.12, 0.02], (0.02, -0.01, 0.52)))]
    uv = [geo.project_points(pts3d, K, p).astype(np.float32) for p in poses]
    uv[1][::4] += 2.0                 # some points off the epipolar line
    Ps = [(K @ p).astype(np.float32) for p in poses]
    ref = jtr._tri_two_view(*(jnp.asarray(x) for x in (*uv, *Ps)))
    got = ttr._tri_two_view(*(torch.from_numpy(x) for x in (*uv, *Ps)))
    for r, g, tol in zip(ref, got, (1e-4, 1e-3, 1e-5)):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=tol)
    assert np.abs(got[0].numpy()[1::4] - pts3d[1::4]).max() < 2e-3


def test_track_step_matches_jax(jax_runs):
    key, args, ref = jax_runs["step"]
    (pose, m0, keep, n_keep, pnp_inl, used_pnp, flow_ok, flow_inl,
     have_init, tri_xyz, tri_good) = ref
    got = ttr.track_step(*[torch.as_tensor(np.asarray(a)) for a in args],
                         _track_noise(key), 1.2)
    np.testing.assert_allclose(got.pose.numpy(), pose, atol=1e-5)
    np.testing.assert_array_equal(got.m0.numpy(), m0)
    np.testing.assert_array_equal(got.keep.numpy(), keep)
    for name, value in (("n_keep", n_keep), ("pnp_inliers", pnp_inl),
                        ("used_pnp", used_pnp), ("flow_ok", flow_ok),
                        ("flow_inliers", flow_inl), ("have_init", have_init)):
        assert getattr(got, name).item() == value, name
    np.testing.assert_array_equal(got.tri_good.numpy(), tri_good)
    np.testing.assert_allclose(got.tri_xyz.numpy()[tri_good],
                               tri_xyz[tri_good], atol=1e-4)
    assert tri_good.sum() >= 8 and flow_ok and used_pnp
    # the flow that fed the step, against JAX's LK on the same frames
    from onepose_tpu.ops import lk_flow as jlk

    flow = jlk.pyramid_lk(jnp.asarray(args[0]), jnp.asarray(args[1]),
                          jnp.asarray(args[2]))
    status = np.asarray(flow.status)
    np.testing.assert_array_equal(got.flow_status.numpy(), status)
    np.testing.assert_allclose(got.flow_points.numpy()[status],
                               np.asarray(flow.points)[status], atol=1e-3)


def test_tracked_sequence_matches_jax(scene, jax_runs):
    K, _, frames = scene
    ref_poses, ref_infos, keys = jax_runs["tracker"]
    tr = _port_tracker(scene)
    for i, (fr, key) in enumerate(zip(frames[1:], keys)):
        pose, info = tr.track(fr["image"], fr["keypoints"], fr["descriptors"],
                              fr["mask"], K, noise=_track_noise(key))
        assert pose is not None, info
        r_gt, t_gt = geo.query_pose_error(pose, fr["pose"])
        assert r_gt < POSE_DEG and t_gt < POSE_CM, (i, r_gt, t_gt)
        np.testing.assert_allclose(pose, ref_poses[i], atol=1e-4)
        for k in ("mode", "num_tracked", "flow_inliers", "pnp_inliers"):
            assert info.get(k) == ref_infos[i].get(k), (i, k)
    assert len(tr.frames) == 4 and len(tr.pose_history) == 4


def test_tracker_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttr.BATracker()


def test_keyframe_gating(scene):
    K, pts3d, frames = scene
    tr = _port_tracker(scene)
    bad = frames[1]["pose"].copy()
    bad[:3, 3] += [0.5, 0, 0]          # 50 cm: beyond the 10 cm gate
    f1 = frames[1]
    assert not tr.add_keyframe(f1["image"], f1["keypoints"],
                               f1["descriptors"], f1["mask"], bad, K)
    assert tr.add_keyframe(f1["image"], f1["keypoints"], f1["descriptors"],
                           f1["mask"], frames[1]["pose"], K)
    assert len(tr.frames) == 2


def test_motion_prediction():
    tr = ttr.BATracker(device="cpu")
    assert tr.motion_prediction() is None
    p0 = np.eye(4)[:3]
    p1 = np.eye(4)[:3].copy()
    p1[:3, 3] = [0.01, 0, 0]
    tr.pose_history = [p0, p1]
    np.testing.assert_allclose(tr.motion_prediction()[:3, 3], [0.02, 0, 0],
                               atol=1e-6)


def test_track_step_unmatched_slots_scatter_nowhere():
    """No mutual match at all (disjoint one-hot descriptors): every
    keyframe slot aims at the dropped sentinel row, so no query slot is
    assigned, the last one included."""
    rng = np.random.default_rng(7)
    nk, nq = 24, 16
    img = torch.from_numpy(rng.uniform(0, 1, (64, 64)).astype(np.float32))
    kf_desc = torch.zeros(nk, 64)
    kf_desc[torch.arange(nk), torch.arange(nk)] = 1.0
    q_desc = torch.zeros(nq, 64)
    q_desc[torch.arange(nq), 32 + torch.arange(nq)] = 1.0
    K = torch.tensor([[100.0, 0, 32], [0, 100.0, 32], [0, 0, 1]])
    eye = torch.eye(3, 4)
    f = lambda x: torch.from_numpy(x.astype(np.float32))  # noqa: E731
    got = ttr.track_step(
        img, img, f(rng.uniform(10, 54, (nk, 2))), kf_desc,
        torch.ones(nk, dtype=torch.bool), torch.ones(nk, dtype=torch.bool),
        f(rng.normal(size=(nk, 3))), f(rng.uniform(10, 54, (nq, 2))), q_desc,
        torch.ones(nq, dtype=torch.bool), eye, torch.tensor(True), K, K @ eye,
        ttr.draw_track_noise(nk, nq, 32, torch.Generator().manual_seed(0)))
    assert (got.m0 == -1).all()
    assert int(got.n_keep) == 0 and not got.keep.any()
    assert not bool(got.used_pnp)


def test_uint8_frames_are_bit_identical(scene):
    """uint8 frames upload 1 byte a pixel and convert on the device; the
    tracker's outputs equal, bit for bit, those of the same frames
    converted on the host (u / 255 in fp32)."""
    K, pts3d, frames = scene

    def run(as_uint8):
        tr = ttr.BATracker(win_size=4, pnp_hypotheses=64, ba_iterations=2,
                           seed=5, device="cpu")
        out = []
        for i, fr in enumerate(frames):
            u8 = np.clip(np.round(fr["image"] * 255.0), 0, 255).astype(
                np.uint8)
            img = u8 if as_uint8 else u8.astype(np.float32) / np.float32(255)
            if i == 0:
                assert tr.add_keyframe(img, fr["keypoints"],
                                       fr["descriptors"], fr["mask"],
                                       fr["pose"], K, mkpts3d=pts3d,
                                       kpt_indices=np.arange(N_PTS))
                continue
            pose, info = tr.track(img, fr["keypoints"], fr["descriptors"],
                                  fr["mask"], K)
            assert pose is not None, info
            out.append((pose, info["step"]))
        return out

    for (p8, s8), (p32, s32) in zip(run(True), run(False)):
        np.testing.assert_array_equal(p8, p32)
        for a, b in zip(s8, s32):
            assert torch.equal(a, b)


def _fake_out(fr):
    n = N_PTS
    return PoseOutput(
        poses=torch.from_numpy(fr["pose"].astype(np.float32))[None],
        num_inliers=torch.zeros(1, dtype=torch.int32),
        num_matches=torch.zeros(1, dtype=torch.int32),
        success=torch.ones(1, dtype=torch.bool),
        matches0=torch.arange(n)[None],
        keypoints2d=torch.from_numpy(fr["keypoints"][:n])[None],
        descriptors2d=torch.from_numpy(fr["descriptors"][:n])[None],
        kpt_mask=torch.ones((1, n), dtype=torch.bool))


def test_apply_tracking_drives_poses(scene):
    """Frame 0 seeds a keyframe with the PnP pose; later poses come from
    the tracker (not the perturbed PnP input) within 1.5 cm / 1.5 deg
    (tests/test_tracker.py::test_demo_apply_tracking_drives_poses)."""
    K, pts3d, frames = scene
    tr = ttr.BATracker(win_size=WIN, pnp_hypotheses=HYP, ba_iterations=6,
                       device="cpu")
    pose0, src0 = apply_tracking(tr, pts3d, frames[0]["image"], K,
                                 _fake_out(frames[0]), 0, frames[0]["pose"])
    assert src0 == "pnp" and len(tr.frames) == 1
    for i in (1, 2, 3):
        pnp_pose = frames[i]["pose"].copy()
        pnp_pose[:3, 3] += 0.003
        pose, src = apply_tracking(tr, pts3d, frames[i]["image"], K,
                                   _fake_out(frames[i]), i, pnp_pose)
        assert src.startswith("track:"), (i, src)
        assert not np.allclose(pose, pnp_pose)
        r_err, t_err = geo.query_pose_error(pose, frames[i]["pose"])
        assert r_err < POSE_DEG and t_err < POSE_CM, (i, r_err, t_err)


def test_apply_tracking_pnp_fallback():
    """An empty tracker and a failed PnP: the PnP result comes back
    unchanged and no keyframe is added."""
    n = 16
    out = PoseOutput(
        poses=torch.zeros((1, 3, 4)), num_inliers=torch.zeros(1),
        num_matches=torch.zeros(1), success=torch.zeros(1, dtype=torch.bool),
        matches0=-torch.ones((1, n), dtype=torch.int64),
        keypoints2d=torch.zeros((1, n, 2)),
        descriptors2d=torch.zeros((1, n, 8)),
        kpt_mask=torch.zeros((1, n), dtype=torch.bool))
    tr = ttr.BATracker(device="cpu")
    pose, src = apply_tracking(tr, np.zeros((4, 3)),
                               np.zeros((32, 32), np.float32), np.eye(3),
                               out, 0, None)
    assert pose is None and src == "pnp" and not tr.frames
