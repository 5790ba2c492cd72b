"""The port's ``ransac_pnp(profile_prefix=...)`` against the JAX
package's, on the CPU: every stage prefix on the three scenes of
``test_torch_epnp.py::test_ransac_pnp_matches_jax_pose_for_pose``, each
frame fed the JAX draws of its key.

Tolerances. "lo", "refit" and "full": poses within 1e-4 (the same
hypotheses and the same winner, fp32 rounding only), inlier masks, counts
and ``success`` equal. "solve" and "score" return a raw minimal-solver
hypothesis, whose fp32 value depends on rounding order: JAX's own jitted
and eager P3P on the same sample differ by 1.6e-3, and once on whether a
root is real, on frame 1 of "outliers" and "masked". So "score" (the
ranking decision) keeps masks and counts equal and holds the pose to the
raw solvers' 1e-3 of ``test_torch_epnp.py::test_p3p_matches_jax_and_recovers_pose``
(measured 5e-4); "solve" is the port's own first P3P root on the sample
JAX's draws pick, bit for bit, and within 1e-4 of JAX's (masks and counts
equal) on every frame where JAX reproduces its own first root within
1e-4. An unknown prefix raises."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onepose_tpu.ops import epnp as jep
from onepose_tpu_torch.ops import epnp as tep
from test_epnp import make_scene
from test_torch_epnp import _jax_noise, _stack_noise

SCENES = ("outliers", "planar", "masked")


def _frames(scene):
    """The two frames of one scene, as test_torch_epnp.py builds them."""
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
    return frames


@pytest.mark.parametrize("prefix", tep.PROFILE_PREFIXES)
@pytest.mark.parametrize("scene", SCENES)
def test_prefix_matches_jax(scene, prefix):
    frames = _frames(scene)
    keys = jax.random.split(jax.random.PRNGKey(7), 2)
    jprefix = None if prefix == "full" else prefix
    ref = [jep.ransac_pnp(k, *(jnp.asarray(x) for x in (uv, p3, mask, K)),
                          profile_prefix=jprefix)
           for k, (K, p3, uv, mask) in zip(keys, frames)]
    noise = _stack_noise([_jax_noise(k, 128) for k in keys])
    stack = lambda i: torch.from_numpy(np.stack([f[i] for f in frames]))  # noqa: E731
    got = tep.ransac_pnp(stack(2), stack(1), stack(3), stack(0), noise=noise,
                         profile_prefix=prefix)
    held = [True, True]
    if prefix == "solve":
        held = _solve_checks(frames, keys, noise, got, ref)
    for b in range(2):
        if not held[b]:
            continue
        np.testing.assert_allclose(got.pose[b].numpy(),
                                   np.asarray(ref[b].pose),
                                   atol=1e-3 if prefix == "score" else 1e-4)
        assert int(got.num_inliers[b]) == int(ref[b].num_inliers)
        np.testing.assert_array_equal(got.inliers[b].numpy(),
                                      np.asarray(ref[b].inliers))
        assert bool(got.success[b]) == bool(ref[b].success)
    if prefix == "full":
        full = tep.ransac_pnp(stack(2), stack(1), stack(3), stack(0),
                              noise=noise)
        for a, b in zip(got, full):
            assert torch.equal(a, b)


def _solve_checks(frames, keys, noise, got, ref):
    """The "solve" pose is the port's P3P root 0 of the first sample that
    JAX's draws pick, computed as ``ransac_pnp`` computes it (bit-equal);
    returns, a frame each, whether JAX's first root is reproducible (its
    eager ``p3p`` on that sample within 1e-4 of its jitted prefix)."""
    stack = lambda i: torch.from_numpy(np.stack([f[i] for f in frames]))  # noqa: E731
    K, p3, uv, mask = stack(0), stack(1), stack(2), stack(3)
    uv_norm = torch.stack(
        [(uv[..., 0] - K[:, None, 0, 2]) / K[:, None, 0, 0],
         (uv[..., 1] - K[:, None, 1, 2]) / K[:, None, 1, 1]], -1)
    idx3 = tep._sample_hypothesis_indices(noise.k3, mask, 3)
    own = tep.p3p(tep._gather_points(p3, idx3),
                  tep._gather_points(uv_norm, idx3))
    assert torch.equal(got.pose, own[:, 0, 0])
    held = []
    for b in range(2):
        si = idx3[b, 0].numpy()
        eager = jep.p3p(jnp.asarray(p3[b].numpy()[si]),
                        jnp.asarray(uv_norm[b].numpy()[si]))[0]
        held.append(np.abs(np.asarray(eager)
                           - np.asarray(ref[b].pose)).max() < 1e-4)
    assert held[0], "frame 0 of every scene is reproducible in JAX"
    return held


def test_unknown_prefix_raises():
    K, p3, uv, mask = _frames("outliers")[0]
    t = lambda x: torch.from_numpy(x)[None]  # noqa: E731
    with pytest.raises(ValueError, match="profile_prefix"):
        tep.ransac_pnp(t(uv), t(p3), t(mask), t(K), profile_prefix="polish")
