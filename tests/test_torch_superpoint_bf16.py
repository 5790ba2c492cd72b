"""The port's bf16 SuperPoint modes against the JAX package's, on the CPU,
and the eval entry at its default settings (the bf16 preset) against the
root ``inference.py``.

``dense_heads`` with ``stem_dtype="bfloat16"`` under an fp32 encoder, and
with ``compute_dtype="bfloat16"`` (stems direct and polyphase: the port
computes the direct stem for both), weights bridged from
``superpoint.init_params``. Tolerances, on scores (at most about 0.21
here) and unit descriptors:

- bf16 stem, fp32 encoder: 1e-4 (measured 1.7e-5 and 6.6e-6 on scores,
  1.3e-5 on descriptors): both round the same stem to bf16; the
  reassociated fp32 encoder spreads the few one-ulp rounding flips;
- bf16 encoder: 8e-3, two bf16 ulps at 1 (measured 2.3e-3 on scores, 1.4e-3
  on descriptors): XLA's and torch's bf16 convolutions each round to the
  nearest bf16 and disagree by one ulp on a few 1e-5 of the outputs of a
  layer; over ten layers those flips grow to about the size of the bf16
  encoder's own distance from fp32 (2.6e-3 here).
"""
import os.path as osp

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from onepose_tpu import evaluators as jeval, pipeline as jpipe
from onepose_tpu.config import Config as JConfig
from onepose_tpu.models import gats_spg as jgats, superpoint as jsp
from onepose_tpu_torch import evaluators as teval, inference
from onepose_tpu_torch.config import Config
from onepose_tpu_torch.models import convert, gats_spg as tgats
from onepose_tpu_torch.models import superpoint as tsp
from onepose_tpu_torch.utils import geometry as geo
from test_torch_epnp import _jax_noise, _stack_noise
from test_torch_inference_entry import (  # noqa: F401
    KPTS, N_FRAMES, PNP, _args, _cfg, _record_evaluations, world)

PRESETS = [  # (compute_dtype, stem_dtype, stem, tolerance)
    ("float32", "bfloat16", "direct", 1e-4),
    ("float32", "bfloat16", "polyphase", 1e-4),
    ("bfloat16", "bfloat16", "direct", 8e-3),
    ("bfloat16", "float32", "polyphase", 8e-3),
]


@pytest.fixture(scope="module")
def models():
    params = jsp.init_params(jax.random.PRNGKey(0))
    return params, convert.superpoint_from_jax(jax.tree.map(np.asarray,
                                                            params))


@pytest.mark.parametrize("cdt,sdt,stem,tol", PRESETS)
def test_dense_heads_bf16_matches_jax(models, cdt, sdt, stem, tol):
    params, model = models
    img = np.random.default_rng(0).uniform(0, 1, (2, 64, 96, 1)).astype(
        np.float32)
    s_j, d_j = jsp.dense_heads(params, jnp.asarray(img), compute_dtype=cdt,
                               stem_dtype=sdt, stem=stem)
    with torch.no_grad():
        s_t, d_t = tsp.dense_heads(model, torch.from_numpy(img), cdt, sdt,
                                   stem)
    assert s_t.dtype == d_t.dtype == torch.float32
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), rtol=0,
                               atol=tol)
    np.testing.assert_allclose(d_t.numpy(), np.asarray(d_j), rtol=0,
                               atol=tol)
    # the preset moves the result off fp32 by about as much as it moves
    # JAX's: bf16 really ran
    with torch.no_grad():
        s32, _ = tsp.dense_heads(model, torch.from_numpy(img))
    assert float((s32 - s_t).abs().max()) > 1e-7


def test_entry_preset_follows_the_root_entries():
    """The root entries' rules: bf16 direct stem and bf16 encoder by
    default; stem_dtype=float32 alone selects polyphase and fp32."""
    preset = tsp.entry_preset
    assert preset({}) == {"stem_dtype": "bfloat16", "stem": "direct",
                          "compute_dtype": "bfloat16"}
    assert preset({"stem_dtype": "float32"}) == {
        "stem_dtype": "float32", "stem": "polyphase",
        "compute_dtype": "float32"}
    assert preset({"compute_dtype": "float32"}) == {
        "stem_dtype": "bfloat16", "stem": "direct",
        "compute_dtype": "float32"}


def test_eval_entry_defaults_match_the_root_script(world, monkeypatch):  # noqa: F811
    """Both eval entries at their defaults (no dtype keys: the bf16
    preset) on ``test_torch_inference_entry.py``'s plane world, the port
    fed the root script's RANSAC noise: the same success flags, every
    frame in the same cmd1/3/5 buckets, cmd1/3/5 and the report equal, and
    frame 0's pose (the planted one) within 1e-4 per entry.

    The other frames' poses are not compared entry by entry: the one-ulp
    bf16 flips reorder keypoints of near-equal score (frame 0 keeps its
    set in another slot order; frames 1-3 share 91-97% of their sets), so
    the same injected noise draws other correspondences there, and those
    frames have no planted consensus to bring both runs to one pose."""
    import inference as root_inference

    tmp, sp, gats = world
    monkeypatch.setitem(jgats.DEFAULT_CONFIG, "match_threshold", 0.0)
    monkeypatch.setitem(tgats.DEFAULT_CONFIG, "match_threshold", 0.0)
    batch_keys, call = [], jpipe.PosePipeline.__call__

    def call_and_record(self, images, Ks, keys=None):
        assert dict(self.sp_config_items)["compute_dtype"] == "bfloat16"
        batch_keys.append(keys)
        return call(self, images, Ks, keys)

    monkeypatch.setattr(jpipe.PosePipeline, "__call__", call_and_record)

    def defaults(cls, **extra):
        cfg = _cfg(tmp, cls, **extra)
        del cfg["stem_dtype"], cfg["compute_dtype"]
        cfg.output.eval_dir += "_bf16"
        return cfg

    ref_frames = _record_evaluations(monkeypatch, jeval.Evaluator)
    ref = root_inference.inference_core(
        defaults(JConfig), *_args(tmp), jax.tree.map(np.asarray, sp),
        jax.tree.map(np.asarray, gats))
    noises = [_stack_noise([_jax_noise(k, KPTS, PNP["num_hypotheses"])
                            for k in keys]) for keys in batch_keys]
    got_frames = _record_evaluations(monkeypatch, teval.Evaluator)
    got = inference.inference_core(
        defaults(Config, device="cpu"), *_args(tmp),
        convert.superpoint_from_jax(sp), convert.gats_spg_from_jax(gats),
        noises=noises)

    assert len(got_frames) == len(ref_frames) == N_FRAMES
    assert ref_frames[0][0] is not None
    for i, ((g, gt), (r, _)) in enumerate(zip(got_frames, ref_frames)):
        assert (g is None) == (r is None), i
        if r is not None:
            buckets = [[err < thr for err in geo.query_pose_error(p, gt)
                        for thr in (1, 3, 5)] for p in (g, r)]
            assert buckets[0] == buckets[1], i
    np.testing.assert_allclose(got_frames[0][0], ref_frames[0][0], rtol=0,
                               atol=1e-4)
    assert got == ref
    reports = [open(osp.join(str(tmp / "eval" / m) + "_bf16",
                             "0001-plane-boxplane-1.txt")).read()
               for m in (Config.__module__, JConfig.__module__)]
    assert reports[0] == reports[1]
