"""The port's GATsSPG (models/gats_spg.py) and weight bridge
(models/convert.py, utils/model_io.py) against the JAX package, fp32, on
the CPU, D = 256, weights bridged from ``gats_spg.init_params``.

Tolerances: matches0/matches1 exactly equal; matching scores within 1e-5
(measured max 3.7e-7 at num_blocks 1, 6.4e-7 at 2: fp32 matmuls summed in
different orders); single layers within 2e-5."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from onepose_tpu.models import gats_spg as jgs
from onepose_tpu_torch.models import convert
from onepose_tpu_torch.models import gats_spg as tgs
from onepose_tpu_torch.utils import model_io


def _unit(x):
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


def _inputs(rng, b=2, n1=64, n2=48, leaf=4, d=256):
    return {
        "descriptors2d_query": _unit(rng.normal(size=(b, n1, d))),
        "descriptors3d_db": _unit(rng.normal(size=(b, n2, d))),
        "descriptors2d_db": _unit(rng.normal(size=(b, n2 * leaf, d))),
        "mask2d": np.arange(n1)[None, :] < np.array([[n1 - 7], [n1]]),
        "mask3d": np.arange(n2)[None, :] < np.array([[n2], [n2 - 5]]),
    }


def _torch(data):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in data.items()}


@pytest.mark.parametrize("num_blocks", [1, 2])
def test_forward_matches_jax(num_blocks):
    rng = np.random.default_rng(num_blocks)
    cfg = {"num_blocks": num_blocks, "match_threshold": 1e-3}
    params = jgs.init_params(jax.random.PRNGKey(num_blocks), cfg)
    model = convert.gats_spg_from_jax(jax.tree.map(np.asarray, params))
    data = _inputs(rng)
    ref = jgs.forward(params, {k: jnp.asarray(v) for k, v in data.items()},
                      cfg)
    got = tgs.forward(model, _torch(data), cfg)
    assert (got.matches0 >= 0).sum() > 10
    np.testing.assert_array_equal(got.matches0.numpy(),
                                  np.asarray(ref.matches0))
    np.testing.assert_array_equal(got.matches1.numpy(),
                                  np.asarray(ref.matches1))
    for name in ("matching_scores0", "matching_scores1", "conf_matrix"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(ref, name)), atol=1e-5)


def _contiguous_head_attention(q, k, v, num_heads):
    """The wrong head layout: channels [h*dh, (h+1)*dh) in head h."""
    b, n, d = q.shape
    dh = d // num_heads
    split = lambda x: x.reshape(x.shape[0], x.shape[1], num_heads, dh)  # noqa: E731
    out = tgs.linear_attention(
        split(q).transpose(2, 3).reshape(b, n, d),
        split(k).transpose(2, 3).reshape(b, k.shape[1], d),
        split(v).transpose(2, 3).reshape(b, v.shape[1], d), num_heads)
    return out.reshape(b, n, dh, num_heads).transpose(2, 3).reshape(b, n, d)


def test_head_layout_is_channel_mod_heads():
    """Channel c belongs to head c % num_heads. The same attention with a
    contiguous head split (channels grouped per head) is a different
    function, and this test tells them apart."""
    rng = np.random.default_rng(5)
    q, k, v = (rng.normal(size=(2, n, 256)).astype(np.float32)
               for n in (40, 56, 56))
    ref = np.asarray(jgs.linear_attention_merged(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 4))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    np.testing.assert_allclose(
        tgs.linear_attention(tq, tk, tv, 4).numpy(), ref, atol=2e-5)
    wrong = _contiguous_head_attention(tq, tk, tv, 4).numpy()
    assert np.abs(wrong - ref).max() > 1e-2


@pytest.mark.parametrize("include_self", [True, False])
@pytest.mark.parametrize("with_linear_transform", [False, True])
@pytest.mark.parametrize("additional", [False, True])
def test_gats_layer_flag_paths(include_self, with_linear_transform,
                               additional):
    rng = np.random.default_rng(7)
    cfg = dict(jgs.DEFAULT_CONFIG, include_self=include_self,
               with_linear_transform=with_linear_transform,
               additional=additional)
    params = jgs.init_params(jax.random.PRNGKey(3), {"num_blocks": 1})
    layer = convert.gats_spg_from_jax(
        jax.tree.map(np.asarray, params)).gnn[0]
    h_2d = _unit(rng.normal(size=(2, 24 * 3, 256)))
    h_3d = _unit(rng.normal(size=(2, 24, 256)))
    ref = jgs.gats_layer(params["gnn"][0], jnp.asarray(h_2d),
                         jnp.asarray(h_3d), cfg)
    with torch.no_grad():
        got = tgs.gats_layer(layer, torch.from_numpy(h_2d),
                             torch.from_numpy(h_3d), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5)


def _reference_state_dict(params):
    """The reference GATsSPG checkpoint's key names and Conv1d layout,
    built from a JAX param pytree."""
    def conv1d(name, p):
        w = np.asarray(p["w"]).T[:, :, None]
        return {f"{name}.weight": torch.from_numpy(w.copy()),
                f"{name}.bias": torch.from_numpy(np.array(p["b"]))}

    sd = conv1d("final_proj", params["final_proj"])
    for i, p in enumerate(params["gnn"]):
        base = f"gnn.layers.{i}"
        if i % 3 == 0:
            sd[f"{base}.W"] = torch.from_numpy(np.asarray(p["W"]))
            sd[f"{base}.a"] = torch.from_numpy(np.asarray(p["a"]))
            continue
        for j, name in enumerate(("proj_q", "proj_k", "proj_v")):
            sd.update(conv1d(f"{base}.attn.proj.{j}", p[name]))
        sd.update(conv1d(f"{base}.attn.merge", p["merge"]))
        sd.update(conv1d(f"{base}.mlp.0", p["mlp0"]))
        sd.update(conv1d(f"{base}.mlp.3", p["mlp1"]))
    return sd


def test_reference_checkpoint_keys_load(tmp_path):
    """A checkpoint with the reference's key names, Lightning nesting and
    ``matcher.`` prefix loads into the same model as the JAX bridge; so
    does a ``superpoint_v1.pth``-style SuperPoint state dict."""
    from onepose_tpu.models import superpoint as jsp

    params = jgs.init_params(jax.random.PRNGKey(4))
    sd = {f"matcher.{k}": v for k, v in _reference_state_dict(params).items()}
    path = str(tmp_path / "GATsSPG.ckpt")
    torch.save({"state_dict": sd}, path)
    loaded = model_io.load_gats_spg(path).state_dict()
    bridged = convert.gats_spg_from_jax(
        jax.tree.map(np.asarray, params)).state_dict()
    assert loaded.keys() == bridged.keys()
    for k in loaded:
        torch.testing.assert_close(loaded[k], bridged[k], rtol=0, atol=0)

    sp = jsp.init_params(jax.random.PRNGKey(5))
    sp_sd = {f"{n}.{k2}": torch.from_numpy(np.asarray(
        p["w"]).transpose(3, 2, 0, 1).copy() if k2 == "weight" else np.asarray(
            p["b"])) for n, p in sp.items() for k2 in ("weight", "bias")}
    path = str(tmp_path / "superpoint_v1.pth")
    torch.save(sp_sd, path)
    loaded = model_io.load_superpoint(path).state_dict()
    bridged = convert.superpoint_from_jax(jax.tree.map(np.asarray, sp))
    for k, v in bridged.state_dict().items():
        torch.testing.assert_close(loaded[k], v, rtol=0, atol=0)
    with pytest.raises(ValueError, match="checkpoints only"):
        model_io.load_superpoint(str(tmp_path / "orbax_dir"))


def test_numpy_init_matches_jax_layout():
    """The numpy inits give the JAX pytrees' structure, shapes and scale."""
    from onepose_tpu.models import superpoint as jsp

    rng = np.random.default_rng(0)
    pairs = [(convert.init_superpoint_params(rng),
              jsp.init_params(jax.random.PRNGKey(0))),
             (convert.init_gats_spg_params(rng),
              jgs.init_params(jax.random.PRNGKey(0)))]
    for ours, ref in pairs:
        a = jax.tree_util.tree_flatten_with_path(ours)[0]
        b = jax.tree_util.tree_flatten_with_path(ref)[0]
        assert [p for p, _ in a] == [p for p, _ in b]
        for (_, x), (_, y) in zip(a, b):
            assert x.shape == y.shape and x.dtype == np.float32
            assert abs(float(np.std(x)) - float(np.std(y))) <= (
                0.1 * float(np.std(y)) + 1e-6)
