"""The port's PnP solvers (ops/epnp.py, ops/lie.py) against the JAX
package, fp32, on the CPU: the small solvers in isolation, ``ransac_pnp``
pose for pose with JAX's sampling noise injected, and the synthetic
success checks of tests/test_epnp.py with the port's own generator.

Tolerances: solvers within a few fp32 ulps of their output scale (stated
per test); RANSAC poses within 1e-4 (measured 6e-8: same hypotheses, same
winner, fp32 rounding only); pose accuracy as in tests/test_epnp.py."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from onepose_tpu.ops import epnp as jep
from onepose_tpu.utils import geometry as geo
from onepose_tpu_torch.ops import epnp as tep
from onepose_tpu_torch.ops import lie
from test_epnp import make_scene


def _jax_noise(key, n, num_hypotheses=512, lo_hypotheses=64):
    """The uniform draws of onepose_tpu.ops.epnp.ransac_pnp for ``key``."""
    key_s, key_lo = jax.random.split(key)
    k3, k4, k6 = jax.random.split(key_s, 3)
    n3, n4 = num_hypotheses // 2, num_hypotheses // 4
    draws = [(k3, n3), (k4, n4), (k6, num_hypotheses - n3 - n4),
             (key_lo, lo_hypotheses)]
    return [np.asarray(jax.random.uniform(k, (h, n))) for k, h in draws]


def _stack_noise(per_frame):
    return tep.RansacNoise(*(torch.from_numpy(np.stack(x))
                             for x in zip(*per_frame)))


def test_inv_psd_matches_jax():
    rng = np.random.default_rng(0)
    for d in (3, 6, 9, 12):
        a = rng.normal(size=(4, d, d)).astype(np.float32)
        a = a @ a.transpose(0, 2, 1) + np.eye(d, dtype=np.float32)
        ref = np.asarray(jax.vmap(jep._inv_psd)(jnp.asarray(a)))
        got = tep._inv_psd(torch.from_numpy(a)).numpy()
        np.testing.assert_allclose(got, ref, atol=1e-5 * np.abs(ref).max())
    with pytest.raises(ValueError):
        tep._inv_psd(torch.eye(4))


def test_eigh3_matches_jax():
    """Random symmetric matrices and the degenerate planar/needle spectra
    of tests/test_epnp.py: eigenvalues within 1e-5 of their scale,
    eigenvectors equal up to sign."""
    rng = np.random.default_rng(3)
    mats = [rng.normal(size=(3, 3)) for _ in range(8)]
    for lams in [(1e-7, 0.05, 0.05), (0.05, 0.05, 1.0), (1e-7, 0.02, 0.05)]:
        q = np.linalg.qr(rng.normal(size=(3, 3)))[0]
        mats.append((q * np.array(lams)) @ q.T)
    a = np.stack([0.5 * (m + m.T) for m in mats]).astype(np.float32)
    vj, ej = jax.vmap(jep._eigh3_sym)(jnp.asarray(a))
    vt, et = tep._eigh3_sym(torch.from_numpy(a))
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj),
                               atol=1e-5 * np.abs(a).max())
    np.testing.assert_allclose(np.abs(et.numpy()), np.abs(np.asarray(ej)),
                               atol=1e-4)


def test_quartic_roots_match_jax_and_numpy():
    rng = np.random.default_rng(3)
    c = rng.normal(size=(10, 5)).astype(np.float32)
    got = tep._quartic_roots(torch.from_numpy(c)).numpy()
    ref = np.asarray(jax.vmap(jep._quartic_roots)(jnp.asarray(c)))
    np.testing.assert_allclose(got, ref, atol=1e-4)
    for i in range(10):
        true = np.roots(c[i].astype(np.float64))
        d = np.abs(got[i][None, :] - true[:, None]).min(axis=1)
        assert d.max() < 2e-2 * max(np.abs(true).max(), 1.0)


def test_p3p_matches_jax_and_recovers_pose():
    rng = np.random.default_rng(11)
    pts, uvs, gts = [], [], []
    for _ in range(6):
        p = rng.uniform(-0.1, 0.1, (3, 3)).astype(np.float32)
        R = geo.rodrigues(rng.normal(size=3) * 0.5)
        t = np.array([0.02, -0.01, 0.5])
        cam = (R @ p.T + t[:, None]).T
        pts.append(p)
        uvs.append((cam[:, :2] / cam[:, 2:3]).astype(np.float32))
        gts.append(np.concatenate([R, t[:, None]], 1))
    pts, uvs = np.stack(pts), np.stack(uvs)
    got = tep.p3p(torch.from_numpy(pts), torch.from_numpy(uvs)).numpy()
    ref = np.asarray(jax.vmap(jep.p3p)(jnp.asarray(pts), jnp.asarray(uvs)))
    assert got.shape == (6, 4, 3, 4)
    feasible = np.abs(ref[..., 2, 3]) < 1e8
    np.testing.assert_array_equal(np.abs(got[..., 2, 3]) < 1e8, feasible)
    np.testing.assert_allclose(got[feasible], ref[feasible], atol=1e-3)
    for i in range(6):
        best = min((geo.query_pose_error(p, gts[i]) for p in got[i]),
                   key=lambda e: e[0] + e[1])
        assert best[0] < 0.3 and best[1] < 0.3, (i, best)


@pytest.mark.parametrize("scene", ["outliers", "planar", "masked"])
def test_ransac_pnp_matches_jax_pose_for_pose(scene):
    """Two frames in one batched call, each fed the JAX draws for its key:
    the same hypotheses, the same winner, the same pose."""
    rng = np.random.default_rng({"outliers": 2, "planar": 10,
                                 "masked": 3}[scene])
    frames = []
    for _ in range(2):
        if scene == "masked":
            K, p3, uv, _, mask = make_scene(rng, n=128, n_valid=60)
            uv[60:] = rng.uniform(0, 512, (68, 2))
            p3[60:] = rng.normal(size=(68, 3))
        else:
            K, p3, uv, _, mask = make_scene(rng, n=128, outlier_frac=0.3)
            if scene == "planar":
                p3[:, 2] = 0.0
        frames.append((K.astype(np.float32), p3, uv, mask))
    keys = jax.random.split(jax.random.PRNGKey(7), 2)
    ref = [jep.ransac_pnp(k, *(jnp.asarray(x) for x in (uv, p3, mask, K)))
           for k, (K, p3, uv, mask) in zip(keys, frames)]
    noise = _stack_noise([_jax_noise(k, 128) for k in keys])
    stack = lambda i: torch.from_numpy(np.stack([f[i] for f in frames]))  # noqa: E731
    got = tep.ransac_pnp(stack(2), stack(1), stack(3), stack(0), noise=noise)
    for b in range(2):
        np.testing.assert_allclose(got.pose[b].numpy(),
                                   np.asarray(ref[b].pose), atol=1e-4)
        assert int(got.num_inliers[b]) == int(ref[b].num_inliers)
        np.testing.assert_array_equal(got.inliers[b].numpy(),
                                      np.asarray(ref[b].inliers))


def _run(K, p3, uv, mask, seed=0):
    gen = torch.Generator().manual_seed(seed)
    res = tep.ransac_pnp(torch.from_numpy(uv)[None],
                         torch.from_numpy(p3)[None],
                         torch.from_numpy(mask)[None],
                         torch.from_numpy(K.astype(np.float32))[None],
                         generator=gen)
    return tep.PnPResult(*(x[0].numpy() for x in res))


@pytest.mark.parametrize("case", ["exact", "noise", "outliers", "masked",
                                  "too_few"])
def test_success_envelope(case):
    """tests/test_epnp.py's synthetic checks, with torch's own draws."""
    if case == "exact":
        K, p3, uv, gt, mask = make_scene(np.random.default_rng(0), n=64,
                                         noise_px=0.0)
        res = _run(K, p3, uv, mask)
        assert res.success and res.num_inliers == 64
        r, t = geo.query_pose_error(res.pose, gt)
        assert r < 0.05 and t < 0.05
    elif case == "noise":
        K, p3, uv, gt, mask = make_scene(np.random.default_rng(1), n=200,
                                         noise_px=1.0)
        r, t = geo.query_pose_error(_run(K, p3, uv, mask).pose, gt)
        assert r < 0.5 and t < 0.5
    elif case == "outliers":
        K, p3, uv, gt, mask = make_scene(np.random.default_rng(2), n=200,
                                         outlier_frac=0.4)
        res = _run(K, p3, uv, mask)
        r, t = geo.query_pose_error(res.pose, gt)
        assert r < 0.5 and t < 0.5 and res.num_inliers >= 100
    elif case == "masked":
        rng = np.random.default_rng(3)
        K, p3, uv, gt, mask = make_scene(rng, n=256, n_valid=100)
        uv[100:] = rng.uniform(0, 512, (156, 2))
        p3[100:] = rng.normal(size=(156, 3))
        res = _run(K, p3, uv, mask)
        r, t = geo.query_pose_error(res.pose, gt)
        assert r < 0.5 and t < 0.5 and not res.inliers[100:].any()
    else:
        K, p3, uv, gt, mask = make_scene(np.random.default_rng(4), n=16,
                                         n_valid=3)
        res = _run(K, p3, uv, mask)
        assert not res.success
        np.testing.assert_array_equal(res.pose, np.eye(3, 4))


def test_planar_object_envelope():
    """tests/test_epnp.py::test_epnp_planar_object with torch's draws."""
    rng = np.random.default_rng(10)
    for trial in range(3):
        K = np.array([[460.0, 0, 256], [0, 460.0, 256], [0, 0, 1]])
        p3 = np.concatenate([rng.uniform(-0.1, 0.1, (120, 2)),
                             np.zeros((120, 1))], 1).astype(np.float32)
        R = geo.rodrigues(rng.normal(size=3) * 0.5)
        gt = np.concatenate([R, np.array([[0.01], [-0.02], [0.45]])], 1)
        uv = geo.project_points(p3, K, gt) + rng.normal(size=(120, 2)) * 0.5
        out = rng.choice(120, 36, replace=False)
        uv[out] = rng.uniform(0, 512, (36, 2))
        res = _run(K, p3, uv.astype(np.float32), np.ones(120, bool), trial)
        r, t = geo.query_pose_error(res.pose, gt)
        assert r < 0.5 and t < 0.5 and res.num_inliers >= 70, (trial, r, t)


def test_gauss_newton_matches_jax_and_improves():
    rng = np.random.default_rng(6)
    K, p3, uv, gt, _ = make_scene(rng, n=100, noise_px=0.3)
    uvn = np.stack([(uv[:, 0] - K[0, 2]) / K[0, 0],
                    (uv[:, 1] - K[1, 2]) / K[1, 1]], 1).astype(np.float32)
    pose0 = gt.copy()
    pose0[:3, :3] = geo.rodrigues([0.02, -0.01, 0.015]) @ pose0[:3, :3]
    pose0[:3, 3] += [0.004, -0.003, 0.006]
    pose0 = pose0.astype(np.float32)
    w = np.ones(100, np.float32)
    ref = np.asarray(jep.gauss_newton_refine(
        jnp.asarray(pose0), jnp.asarray(p3), jnp.asarray(uvn),
        jnp.asarray(w), iters=8))
    got = tep.gauss_newton_refine(*map(torch.from_numpy, (pose0, p3, uvn, w)),
                                  iters=8).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5)
    r0, t0 = geo.query_pose_error(pose0, gt)
    r1, t1 = geo.query_pose_error(got, gt)
    assert r1 < 0.3 * r0 and t1 < 0.3 * t0


def test_lie_matches_jax():
    from onepose_tpu.ops import lie as jlie

    rng = np.random.default_rng(7)
    w = rng.normal(size=(16, 3)).astype(np.float32)
    R = lie.so3_exp(torch.from_numpy(w))
    np.testing.assert_allclose(R.numpy(), np.asarray(jlie.so3_exp(w)),
                               atol=1e-6)
    np.testing.assert_allclose(lie.so3_log(R).numpy(),
                               np.asarray(jlie.so3_log(jnp.asarray(R))),
                               atol=1e-4)
    small = np.full((1, 3), 1e-7, np.float32)
    np.testing.assert_allclose(lie.so3_exp(torch.from_numpy(small)).numpy(),
                               np.asarray(jlie.so3_exp(small)), atol=1e-7)
    pose = np.concatenate([R[0].numpy(), [[0.1], [0.0], [2.0]]], 1)
    pts = rng.normal(size=(5, 3)).astype(np.float32)
    K = np.array([[400, 0, 50], [0, 400, 60], [0, 0, 1]], np.float32)
    np.testing.assert_allclose(
        lie.project(*map(torch.from_numpy, (pose.astype(np.float32), K,
                                            pts))).numpy(),
        np.asarray(jlie.project(pose.astype(np.float32), K, pts)), atol=1e-3)
