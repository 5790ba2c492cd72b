"""The tracker's ops in the port (models/nn_matcher.py, ops/lk_flow.py,
ops/lm.py) against the JAX package, fp32, on the CPU.

Tolerances, each with its reason:
- NN matcher: matches0 equal, scores within 1e-6 (one fp32 product and
  normalization; measured below 1e-7).
- LK: status equal; where tracked, points within 1e-3 px and window
  errors within 1e-4 (same gathers and blends in another order; measured
  3e-5 px and 4e-5).
- LM: cameras and points within 1e-4 for the fixed-points and
  fixed-cameras paths (measured 4e-6). The full Schur path is held at the
  same 1e-4 where the damping keeps its camera system well posed
  (init_lambda 100, measured 3.1e-5). At the default damping that system
  is singular to fp32 rounding: camera 0 fixes six of BA's seven gauge
  freedoms, the scale stays free, so whether a step's Cholesky succeeds is
  rounding luck on either side and the two runs drift along the scale (1e-2
  in the parameters). There the test holds what the gauge leaves fixed:
  the final cost within 1e-4 of JAX's, relative, and every residual within
  5e-3 px (measured 1e-5 and 9e-4).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from onepose_tpu.models.nn_matcher import mutual_nearest_neighbour as jnn
from onepose_tpu.ops import lk_flow as jlk
from onepose_tpu.ops import lm as jlm
from onepose_tpu_torch.models.nn_matcher import mutual_nearest_neighbour as tnn
from onepose_tpu_torch.ops import lk_flow as tlk
from onepose_tpu_torch.ops import lm as tlm
from test_lm import make_ba_problem


# ---------------------------------------------------------------------------
# mutual nearest neighbour
# ---------------------------------------------------------------------------

def _nn_both(d0, d1, **kw):
    masks = {k: jnp.asarray(v) for k, v in kw.items() if k.startswith("mask")}
    opts = {k: v for k, v in kw.items() if not k.startswith("mask")}
    ref = jnn(jnp.asarray(d0), jnp.asarray(d1), **masks, **opts)
    got = tnn(torch.from_numpy(d0), torch.from_numpy(d1),
              **{k: torch.from_numpy(np.asarray(v)) for k, v in masks.items()},
              **opts)
    np.testing.assert_array_equal(got.matches0.numpy(),
                                  np.asarray(ref.matches0))
    np.testing.assert_allclose(got.matching_scores0.numpy(),
                               np.asarray(ref.matching_scores0), atol=1e-6)
    return got.matches0.numpy()


def test_nn_identity():
    d = np.random.default_rng(2).normal(size=(32, 64)).astype(np.float32)
    np.testing.assert_array_equal(_nn_both(d, d), np.arange(32))


@pytest.mark.parametrize("opts", [
    {"distance_thresh": 0.8}, {"ratio_thresh": 0.7},
    {"ratio_thresh": 0.5, "distance_thresh": 0.7}])
def test_nn_thresholds(opts):
    rng = np.random.default_rng(3)
    d0 = rng.normal(size=(48, 64)).astype(np.float32)
    d1 = (d0[rng.permutation(48)]
          + rng.normal(size=(48, 64)) * rng.uniform(0.02, 3.0, (48, 1))
          ).astype(np.float32)
    m = _nn_both(d0, d1, **opts)
    assert 0 < (m >= 0).sum() < 48      # the thresholds cut some


def test_nn_masks():
    rng = np.random.default_rng(4)
    d0 = rng.normal(size=(12, 32)).astype(np.float32)
    mask0 = np.ones(12, bool)
    mask0[[2, 7]] = False
    mask1 = np.ones(12, bool)
    mask1[3] = False
    m = _nn_both(d0, d0.copy(), mask0=mask0, mask1=mask1)
    assert m[3] != 3 and (m[[2, 7]] == -1).all()


def test_nn_tie_takes_the_first_index():
    """Duplicated descriptors tie a row's maximum: both sides take the
    first index (jnp.argmax and torch.argmax both promise it)."""
    rng = np.random.default_rng(5)
    d0 = rng.normal(size=(6, 16)).astype(np.float32)
    d1 = np.concatenate([d0[:1], d0[:1], d0[1:]])     # cols 0 and 1 tie
    m = _nn_both(d0, d1)
    assert m[0] == 0


# ---------------------------------------------------------------------------
# pyramidal LK
# ---------------------------------------------------------------------------

def _texture(rng, n=8):
    """A smooth random texture f(x, y) in [0, 1] (n plane waves of periods
    12 to 40 px), as a function, so that warped frames are exact."""
    k = rng.uniform(2 * np.pi / 40, 2 * np.pi / 12, (n, 2)) * rng.choice(
        [-1, 1], (n, 2))
    ph = rng.uniform(0, 2 * np.pi, n)

    def f(x, y):
        v = sum(np.sin(k[i, 0] * x + k[i, 1] * y + ph[i]) for i in range(n))
        return np.clip(0.5 + 0.25 * v / np.sqrt(n / 2), 0, 1).astype(
            np.float32)
    return f


def _warp_pair(rng, hw, H):
    """(im0, im1) with im1 = im0 under the homography H (im0 px → im1 px)."""
    f = _texture(rng)
    ys, xs = np.mgrid[0:hw[0], 0:hw[1]].astype(np.float64)
    src = np.stack([xs, ys, np.ones_like(xs)], -1) @ np.linalg.inv(H).T
    return f(xs, ys), f(src[..., 0] / src[..., 2], src[..., 1] / src[..., 2])


def _lk_both(im0, im1, pts, **kw):
    ref = jlk.pyramid_lk(jnp.asarray(im0), jnp.asarray(im1),
                         jnp.asarray(pts), **kw)
    got = tlk.pyramid_lk(torch.from_numpy(im0), torch.from_numpy(im1),
                         torch.from_numpy(pts), **kw)
    status = np.asarray(ref.status)
    np.testing.assert_array_equal(got.status.numpy(), status)
    np.testing.assert_allclose(got.points.numpy()[status],
                               np.asarray(ref.points)[status], atol=1e-3)
    np.testing.assert_allclose(got.error.numpy()[status],
                               np.asarray(ref.error)[status], atol=1e-4)
    return got


_TRANSLATION = np.array([[1, 0, 5.3], [0, 1, -3.6], [0, 0, 1]])
_HOMOGRAPHY = np.array([[1.02, 0.03, 2.0], [-0.025, 0.99, 1.5],
                        [1e-4, -5e-5, 1]])


@pytest.mark.parametrize("H", [_TRANSLATION, _HOMOGRAPHY],
                         ids=["translation", "homography"])
@pytest.mark.parametrize("levels,min_tracked", [(3, 10), (2, 40)])
def test_lk_matches_jax(H, levels, min_tracked):
    """At 96x128 the third level is 24x32: its patch spans the image
    height, and a point whose window is clipped at the patch edge samples
    its ±0.5 px shifts from one window, fails the texture test and is
    dropped, on both sides alike. Two levels track nearly every point."""
    rng = np.random.default_rng(0)
    im0, im1 = _warp_pair(rng, (96, 128), H)
    pts = rng.uniform([16, 16], [112, 80], (48, 2)).astype(np.float32)
    got = _lk_both(im0, im1, pts, levels=levels)
    ok = got.status.numpy()
    assert ok.sum() >= min_tracked
    true = np.concatenate([pts, np.ones((48, 1), np.float32)], 1) @ H.T
    err = np.linalg.norm(got.points.numpy() - true[:, :2] / true[:, 2:],
                         axis=1)
    assert np.median(err[ok]) < 0.1


def test_lk_tiny_image_matches_jax():
    """48x48: the pyramid stops at 24x24, whose patch shrinks to the
    image (tests/test_tracking_ops.py::test_lk_tiny_image_compiles...)."""
    rng = np.random.default_rng(1)
    im0, im1 = _warp_pair(rng, (48, 48), np.array(
        [[1, 0, 2.0], [0, 1, 1.0], [0, 0, 1]]))
    pts = np.array([[20.0, 24.0], [30.0, 18.0], [12.5, 33.0]], np.float32)
    got = _lk_both(im0, im1, pts, win=15, levels=3)
    ok = got.status.numpy()
    assert ok.any()
    np.testing.assert_allclose(got.points.numpy()[ok] - pts[ok],
                               np.tile([2.0, 1.0], (ok.sum(), 1)), atol=0.75)


def test_lk_flat_region_rejected():
    im = np.zeros((100, 100), np.float32)
    pts = np.array([[50.0, 50.0]], np.float32)
    got = _lk_both(im, im, pts)
    assert not bool(got.status[0])


def test_lk_fixed_loop_equals_early_exit():
    """Where every point converges inside the loop, 10 iterations and 40
    give the same bits (a done point never moves again), and both equal
    JAX's while_loop, which exits as soon as every point is done."""
    rng = np.random.default_rng(2)
    im0, im1 = _warp_pair(rng, (96, 128), np.array(
        [[1, 0, 1.3], [0, 1, -0.8], [0, 0, 1]]))
    pts = rng.uniform([20, 20], [108, 76], (32, 2)).astype(np.float32)
    runs = [_lk_both(im0, im1, pts, levels=2, iters=n) for n in (10, 40)]
    assert runs[0].status.all()
    assert torch.equal(runs[0].points, runs[1].points)
    assert torch.equal(runs[0].error, runs[1].error)


# ---------------------------------------------------------------------------
# Levenberg–Marquardt BA
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ba_problem():
    """tests/test_lm.py's window: 6 cameras, 50 points, 37 masked padding
    observations."""
    prob, _, _ = make_ba_problem(np.random.default_rng(0), pad_obs=37)
    return prob, tlm.BAProblem(*(torch.from_numpy(np.array(x)) for x in prob))


def _solve_both(ba_problem, **kw):
    jprob, tprob = ba_problem
    return jlm.solve_ba(jprob, **kw), tlm.solve_ba(tprob, **kw)


@pytest.mark.parametrize("kw", [
    {"fix_points": True, "iterations": 10},
    {"fix_cameras": True, "iterations": 10},
    {"iterations": 8, "init_lambda": 100.0}],
    ids=["fix_points", "fix_cameras", "schur_damped"])
def test_lm_matches_jax(ba_problem, kw):
    ref, got = _solve_both(ba_problem, **kw)
    assert float(got.final_cost) < 0.9 * float(got.initial_cost)
    np.testing.assert_allclose(got.cameras.numpy(), np.asarray(ref.cameras),
                               atol=1e-4)
    np.testing.assert_allclose(got.points.numpy(), np.asarray(ref.points),
                               atol=1e-4)
    np.testing.assert_allclose(float(got.initial_cost),
                               float(ref.initial_cost), rtol=1e-6)


def test_lm_schur_converges_with_jax(ba_problem):
    """The full path at the default damping: the same cost and residuals
    at convergence, the scale gauge aside (module docstring)."""
    jprob, tprob = ba_problem
    ref, got = _solve_both(ba_problem, iterations=15)
    assert float(got.final_cost) < 0.05 * float(got.initial_cost)
    np.testing.assert_allclose(float(got.final_cost), float(ref.final_cost),
                               rtol=1e-4)
    r_ref = np.asarray(jlm.residuals(
        ref.cameras, ref.points, jprob.cam_idx, jprob.pt_idx, jprob.uv,
        jprob.K, jprob.mask.astype(jnp.float32)))
    r_got = tlm.residuals(got.cameras, got.points, tprob.cam_idx.long(),
                          tprob.pt_idx.long(), tprob.uv, tprob.K,
                          tprob.mask.float()).numpy()
    np.testing.assert_allclose(r_got, r_ref, atol=5e-3)


@pytest.mark.parametrize("kw", [
    {"fix_points": True, "init_lambda": -1e6},
    {"init_lambda": -1e3}], ids=["fix_points", "schur"])
def test_lm_rejects_a_step_that_is_not_pd(ba_problem, kw):
    """Negative damping makes the camera system indefinite: JAX's Cholesky
    factor is NaN, so its step's cost is NaN and the step is refused; the
    port's ``cholesky_ex`` reports ``info > 0`` and the step is refused
    too. Both keep the initial state."""
    ref, got = _solve_both(ba_problem, iterations=3, **kw)
    init = ba_problem[1]
    assert torch.equal(got.cameras, init.cameras)
    assert torch.equal(got.points, init.points)
    np.testing.assert_array_equal(np.asarray(ref.cameras),
                                  init.cameras.numpy())


def test_precond_solve_flags_a_matrix_that_is_not_pd():
    A = np.diag([4.0, 1.0, -2.0]).astype(np.float32)
    b = np.ones(3, np.float32)
    assert np.isnan(np.asarray(jlm._precond_solve(jnp.asarray(A),
                                                  jnp.asarray(b)))).any()
    _, ok = tlm._precond_solve(torch.from_numpy(A), torch.from_numpy(b))
    assert not bool(ok)
    x, ok = tlm._precond_solve(torch.from_numpy(np.abs(A)),
                               torch.from_numpy(b))
    assert bool(ok)
    np.testing.assert_allclose(x.numpy(), [0.25, 1.0, 0.5], rtol=1e-6)


def test_segment_sum_matches_jax():
    rng = np.random.default_rng(6)
    data = rng.normal(size=(40, 6, 3)).astype(np.float32)
    ids = rng.integers(0, 7, 40).astype(np.int32)
    ref = jax.ops.segment_sum(jnp.asarray(data), jnp.asarray(ids), 9)
    seg = tlm.segment_matrix(torch.from_numpy(ids), 9)
    got = tlm.segment_sum(torch.from_numpy(data), seg)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)
    assert not got[7:].any()                        # empty segments
    big = torch.from_numpy(rng.normal(size=(4096, 6, 6)).astype(np.float32))
    seg = tlm.segment_matrix(torch.from_numpy(rng.integers(0, 10, 4096)), 10)
    runs = [tlm.segment_sum(big, seg) for _ in range(3)]
    assert all(torch.equal(runs[0], r) for r in runs[1:])


def _largest_tensor(fn):
    """The most elements of any tensor an aten op returns while ``fn``
    runs."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Largest(TorchDispatchMode):
        numel = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in torch.utils._pytree.tree_leaves(out):
                if isinstance(t, torch.Tensor):
                    Largest.numel = max(Largest.numel, t.numel())
            return out

    with Largest():
        fn()
    return Largest.numel


@pytest.mark.parametrize("kw", [{}, {"fix_points": True},
                                {"fix_cameras": True}],
                         ids=["schur", "fix_points", "fix_cameras"])
def test_lm_operands_are_linear_in_observations(kw):
    """No tensor of a solve grows as points x observations or as cameras x
    observations: at 6 cameras and 300 points, the largest is bounded by
    the per-observation blocks (36 O), the per-point camera blocks
    (18 P C) or the dense camera system ((6 C)^2), whichever is larger, at
    O = 3,000 and at O = 12,000."""
    rng = np.random.default_rng(8)
    C, P = 6, 300
    for O in (3000, 12000):
        prob = tlm.BAProblem(
            cameras=torch.from_numpy(np.concatenate(
                [rng.normal(size=(C, 3)) * 0.1,
                 rng.normal(size=(C, 3)) * 0.1 + [0, 0, 2]], 1)).float(),
            points=torch.from_numpy(rng.normal(size=(P, 3)) * 0.3).float(),
            cam_idx=torch.from_numpy(rng.integers(0, C, O)),
            pt_idx=torch.from_numpy(rng.integers(0, P, O)),
            uv=torch.from_numpy(rng.uniform(0, 512, (O, 2))).float(),
            K=torch.tensor([[500.0, 500.0, 256.0, 256.0]]).expand(O, 4),
            mask=torch.ones(O, dtype=torch.bool))
        largest = _largest_tensor(
            lambda: tlm.solve_ba(prob, iterations=2, **kw))
        assert largest <= max(36 * O, 18 * P * C, (6 * C) ** 2), (O, largest)


def test_pose_camera_round_trip_matches_jax():
    rng = np.random.default_rng(7)
    cams = np.concatenate([rng.normal(size=(5, 3)) * 0.8,
                           rng.normal(size=(5, 3))], 1).astype(np.float32)
    poses = tlm.camera_to_pose(torch.from_numpy(cams))
    ref = np.stack([np.asarray(jlm.camera_to_pose(jnp.asarray(c)))
                    for c in cams])
    np.testing.assert_allclose(poses.numpy(), ref, atol=1e-6)
    back = tlm.pose_to_camera(poses)
    np.testing.assert_allclose(
        back.numpy(), np.stack([np.asarray(jlm.pose_to_camera(p))
                                for p in ref]), atol=1e-5)
    np.testing.assert_allclose(back.numpy(), cams, atol=1e-5)
