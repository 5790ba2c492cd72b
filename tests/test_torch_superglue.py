"""The port's SuperGlue (models/superglue.py) and its weight bridge
(models/convert.py, utils/model_io.py) against the JAX package, fp32, on
the CPU, at 4 layers, D=64, about 48 points, weights bridged from
``superglue.init_params``.

Tolerances: matches0/matches1 exactly equal; matching scores within 1e-5
(fp32 products summed in another order, through 4 layers and Sinkhorn);
Sinkhorn alone within 1e-5 of the log assignment."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from onepose_tpu.models import superglue as jsg
from onepose_tpu_torch.models import convert
from onepose_tpu_torch.models import superglue as tsg
from onepose_tpu_torch.utils import model_io

CFG = {"descriptor_dim": 64, "keypoint_encoder": (16, 32, 64),
       "num_gnn_layers": 4, "num_heads": 4, "sinkhorn_iterations": 100}


@pytest.fixture(scope="module")
def models():
    params = jax.tree.map(np.asarray, jsg.init_params(jax.random.PRNGKey(0),
                                                      CFG))
    # random weights leave the assignment nearly uniform (top score about
    # 0.01); a final projection ×16 makes scores pass the 0.2 threshold
    params["final_proj"]["w"] = params["final_proj"]["w"] * 16
    return params, convert.superglue_from_jax(params)


def _unit(x):
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


def _pair(rng, b=2, n0=40, n1=48, d=64, h=96, w=128):
    return {
        "keypoints0": rng.uniform(0, [w, h], (b, n0, 2)).astype(np.float32),
        "keypoints1": rng.uniform(0, [w, h], (b, n1, 2)).astype(np.float32),
        "descriptors0": _unit(rng.normal(size=(b, n0, d))),
        "descriptors1": _unit(rng.normal(size=(b, n1, d))),
        "scores0": rng.uniform(0, 1, (b, n0)).astype(np.float32),
        "scores1": rng.uniform(0, 1, (b, n1)).astype(np.float32),
        "shape0": (h, w),
        "shape1": (h, w),
    }


def _both(models, data, cfg):
    params, model = models
    ref = jsg.match(params, {k: v if k.startswith("shape") else jnp.asarray(v)
                             for k, v in data.items()}, cfg)
    got = tsg.forward(model, {k: v if k.startswith("shape")
                              else torch.from_numpy(np.asarray(v))
                              for k, v in data.items()}, cfg)
    return ref, got


def _assert_same(ref, got):
    for name in ("matches0", "matches1"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(ref, name)))
    for name in ("matching_scores0", "matching_scores1"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(ref, name)), atol=1e-5)


@pytest.mark.parametrize("masked", [False, True])
def test_forward_matches_jax(models, masked):
    rng = np.random.default_rng(1)
    data = _pair(rng)
    # the second pair shares 20 of its points
    data["descriptors1"][1, :20] = _unit(data["descriptors0"][1, :20]
                                         + 0.1 * rng.normal(size=(20, 64)))
    data["keypoints1"][1, :20] = data["keypoints0"][1, :20] + 2.0
    if masked:
        data["mask0"] = np.arange(40)[None] < np.array([[33], [40]])
        data["mask1"] = np.arange(48)[None] < np.array([[48], [41]])
    ref, got = _both(models, data, {**CFG, "match_threshold": 0.2})
    assert ((got.matches0 >= 0).sum(1) >= 10).all()
    _assert_same(ref, got)


def test_self_matching_recovers_identity(models):
    """A point set matched against itself gives the identity assignment
    for well-separated descriptors, in both packages alike."""
    rng = np.random.default_rng(2)
    data = _pair(rng, b=1, n0=16, n1=16)
    for k in ("keypoints", "descriptors", "scores"):
        data[f"{k}1"] = data[f"{k}0"].copy()
    ref, got = _both(models, data, {**CFG, "match_threshold": 0.0})
    _assert_same(ref, got)
    m0 = got.matches0[0].numpy()
    matched = m0 >= 0
    assert matched.sum() >= 12
    np.testing.assert_array_equal(m0[matched], np.arange(16)[matched])


def test_masked_padding_never_matches(models):
    """Padded slots (mask False) route to the dustbin and never appear in
    the matches, in both packages alike."""
    rng = np.random.default_rng(3)
    data = _pair(rng, b=1, n0=32, n1=32)
    data["descriptors1"][0, :24] = data["descriptors0"][0, :24]
    data["mask0"] = np.arange(32)[None] < 24
    data["mask1"] = np.arange(32)[None] < 28
    ref, got = _both(models, data, {**CFG, "match_threshold": 0.0})
    _assert_same(ref, got)
    m0, m1 = got.matches0[0].numpy(), got.matches1[0].numpy()
    assert (m0 >= 0).sum() >= 10
    assert (m0[24:] == -1).all() and (m1[28:] == -1).all()
    assert not np.isin(m0[m0 >= 0], np.arange(28, 32)).any()
    assert not np.isin(m1[m1 >= 0], np.arange(24, 32)).any()


def test_head_layout_is_channel_mod_heads():
    """Channel c belongs to head c % num_heads, as in the JAX package; a
    contiguous split is a different function, and this test tells them
    apart."""
    rng = np.random.default_rng(4)
    q, k, v = (rng.normal(size=(2, n, 64)).astype(np.float32)
               for n in (20, 28, 28))
    ref = np.asarray(jsg._merge_heads(jsg.softmax_attention(
        *(jsg._split_heads(jnp.asarray(x), 4) for x in (q, k, v)))))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    got = tsg._merge_heads(tsg.softmax_attention(
        *(tsg._split_heads(x, 4) for x in (tq, tk, tv))))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5)

    def contiguous(x):
        return x.reshape(x.shape[0], x.shape[1], 4, 16)

    wrong = tsg.softmax_attention(contiguous(tq), contiguous(tk),
                                  contiguous(tv)).reshape(2, 20, 64)
    assert np.abs(wrong.numpy() - ref).max() > 1e-2


def test_sinkhorn_matches_jax():
    rng = np.random.default_rng(5)
    scores = rng.normal(size=(2, 30, 37)).astype(np.float32) * 3
    scores[1, 25:] = -1e9   # masked rows
    ref = np.asarray(jsg.log_optimal_transport(
        jnp.asarray(scores), jnp.float32(0.7), 100))
    got = tsg.log_optimal_transport(torch.from_numpy(scores),
                                    torch.tensor(0.7), 100)
    # rows routed to the dustbin hold -1e9-scale values: compare the rest
    fin = np.abs(ref) < 1e6
    np.testing.assert_allclose(got.numpy()[fin], ref[fin], atol=1e-5)
    np.testing.assert_array_equal(np.abs(got.numpy()) < 1e6, fin)


def _reference_state_dict(params):
    """superglue_{indoor,outdoor}.pth's key names and Conv1d layout, built
    from a JAX param pytree."""
    def conv(name, p):
        return {f"{name}.weight": torch.from_numpy(
                    np.asarray(p["w"]).T[:, :, None].copy()),
                f"{name}.bias": torch.from_numpy(np.array(p["b"]))}

    def mlp(prefix, layers):
        sd = {}
        for i, layer in enumerate(layers):
            sd.update(conv(f"{prefix}.{3 * i}", layer["lin"]))
            if "bn" in layer:
                bn = {k: torch.from_numpy(np.array(v))
                      for k, v in layer["bn"].items()}
                sd.update({f"{prefix}.{3 * i + 1}.weight": bn["gamma"],
                           f"{prefix}.{3 * i + 1}.bias": bn["beta"],
                           f"{prefix}.{3 * i + 1}.running_mean": bn["mean"],
                           f"{prefix}.{3 * i + 1}.running_var": bn["var"],
                           f"{prefix}.{3 * i + 1}.num_batches_tracked":
                               torch.tensor(5)})
        return sd

    sd = mlp("kenc.encoder", params["kenc"])
    for i, p in enumerate(params["gnn"]):
        base = f"gnn.layers.{i}"
        for j, name in enumerate(("proj_q", "proj_k", "proj_v")):
            sd.update(conv(f"{base}.attn.proj.{j}", p[name]))
        sd.update(conv(f"{base}.attn.merge", p["merge"]))
        sd.update(mlp(f"{base}.mlp", p["mlp"]))
    sd.update(conv("final_proj", params["final_proj"]))
    sd["bin_score"] = torch.tensor(float(params["bin_score"]))
    return sd


def test_reference_checkpoint_keys_load(tmp_path):
    """A checkpoint with superglue_outdoor.pth's key names loads into the
    same model as the JAX bridge (BatchNorm statistics included), and the
    JAX package's own converter reads the same file to the same pytree."""
    from onepose_tpu.models import convert as jconvert

    params = jsg.init_params(jax.random.PRNGKey(6), CFG)
    rng = np.random.default_rng(6)
    params = jax.tree.map(np.asarray, params)
    for layer in params["kenc"][:-1] + [m for p in params["gnn"]
                                        for m in p["mlp"][:-1]]:
        c = layer["bn"]["mean"].shape[0]
        layer["bn"] = {"gamma": rng.uniform(0.5, 1.5, c).astype(np.float32),
                       "beta": rng.normal(size=c).astype(np.float32),
                       "mean": rng.normal(size=c).astype(np.float32),
                       "var": rng.uniform(0.5, 2, c).astype(np.float32)}
    sd = _reference_state_dict(params)
    path = str(tmp_path / "superglue_outdoor.pth")
    torch.save(sd, path)
    loaded = model_io.load_superglue(path).state_dict()
    bridged = convert.superglue_from_jax(params).state_dict()
    assert loaded.keys() == bridged.keys()
    for k in loaded:
        torch.testing.assert_close(loaded[k], bridged[k], rtol=0, atol=0)
    jparams = jconvert.superglue_from_state_dict(
        jconvert.load_state_dict(path), num_gnn_layers=4, num_kenc_convs=3)
    again = convert.superglue_from_jax(jax.tree.map(np.asarray, jparams))
    for k, v in again.state_dict().items():
        torch.testing.assert_close(loaded[k], v, rtol=0, atol=0)

    # the non-identity BatchNorm statistics are applied as the JAX package
    # applies them
    data = _pair(np.random.default_rng(7), b=1)
    ref, got = _both((params, model_io.load_superglue(path)), data,
                     {**CFG, "match_threshold": 0.0})
    _assert_same(ref, got)
    with pytest.raises(ValueError, match="checkpoints only"):
        model_io.load_superglue(str(tmp_path / "orbax_dir"))


def test_state_dict_writer_is_the_reference_layout(tmp_path):
    """``convert.superglue_to_state_dict`` writes superglue_outdoor.pth's
    keys and Conv1d layout (the batch counters aside), which both
    packages' loaders read back to the same weights."""
    params = convert.init_superglue_params(np.random.default_rng(8), CFG)
    sd = convert.superglue_to_state_dict(params)
    ref = {k: v for k, v in _reference_state_dict(params).items()
           if not k.endswith("num_batches_tracked")}
    assert sd.keys() == ref.keys()
    for k in ref:
        torch.testing.assert_close(sd[k], ref[k], rtol=0, atol=0)
    path = str(tmp_path / "superglue_outdoor.pth")
    torch.save(sd, path)
    loaded = model_io.load_superglue(path).state_dict()
    for k, v in convert.superglue_from_jax(params).state_dict().items():
        torch.testing.assert_close(loaded[k], v, rtol=0, atol=0)


def test_numpy_init_matches_jax_layout():
    ours = convert.init_superglue_params(np.random.default_rng(0))
    ref = jsg.init_params(jax.random.PRNGKey(0))
    a = jax.tree_util.tree_flatten_with_path(ours)[0]
    b = jax.tree_util.tree_flatten_with_path(ref)[0]
    assert [p for p, _ in a] == [p for p, _ in b]
    for (_, x), (_, y) in zip(a, b):
        assert x.shape == y.shape and x.dtype == np.float32
        if np.ptp(y) == 0:          # BatchNorm's identity statistics
            np.testing.assert_array_equal(x, y)
        elif x.size >= 256:         # the bound of the uniform draws
            assert abs(np.abs(x).max() - np.abs(y).max()) <= (
                0.05 * np.abs(y).max())
    model = convert.superglue_from_jax(ours)
    assert len(model.gnn) == 18 and model.final_proj.weight.shape == (256, 256)


def test_match_gate_forgives_only_near_ties():
    """Two log assignments that differ by d: a flipped match is forgiven
    where the reference's top-2 gap is within 2d, refused elsewhere, and a
    difference above GATE_REL of the assignment's scale fails alone."""
    rng = np.random.default_rng(8)
    n, d = 12, 5e-5
    inner = rng.normal(size=(1, n, n)) * 0.1
    inner[0, np.arange(n), np.arange(n)] = 3.0           # identity matches
    inner[0, 4, 7] = 3.0 - d                             # row 4: near-tie
    ref = torch.from_numpy(np.pad(inner, ((0, 0), (0, 1), (0, 1)),
                                  constant_values=-5.0)).float()
    Z = ref.clone()
    Z[0, 4, 7] += 2 * d                                  # the run flips it
    ref_m0 = tsg.mutual_matches(ref, 0.0).matches0
    m0 = tsg.mutual_matches(Z, 0.0).matches0
    assert ref_m0[0].tolist() == list(range(n)) and int(m0[0, 4]) == 7
    gate = tsg.match_gate(m0, Z, ref_m0, ref, 0.0)
    # rows 4 and 7 change (column 7 now belongs to row 4), both forgiven
    assert gate.ok and gate.diff == 2 and gate.near_ties >= 2, gate
    m0[0, 2] = 5                                         # a clear row
    gate = tsg.match_gate(m0, Z, ref_m0, ref, 0.0)
    assert not gate.ok and gate.bad == 1
    gate = tsg.match_gate(ref_m0, ref + 1e-3, ref_m0, ref, 0.0)
    assert not gate.ok and gate.bad == 0 and gate.max_rel_diff > tsg.GATE_REL


def jax_matches_and_log_assignment(params, data, cfg):
    """The JAX package's matches0 and log assignment [B, N0+1, N1+1] for
    ``data`` (numpy arrays; ``shape0``/``shape1`` tuples), as tensors:
    ``superglue.forward`` under one jit, its Sinkhorn result captured while
    it is traced."""
    shapes = {k: v for k, v in data.items() if k.startswith("shape")}
    real = jsg.log_optimal_transport
    captured = []

    def capture(*args):
        captured.append(real(*args))
        return captured[-1]

    def run(p, arrays):
        jsg.log_optimal_transport = capture
        try:
            out = jsg.forward(p, {**arrays, **shapes}, cfg)
        finally:
            jsg.log_optimal_transport = real
        return out.matches0, captured[-1]

    m0, Z = jax.jit(run)(params, {k: jnp.asarray(v) for k, v in data.items()
                                  if k not in shapes})
    return torch.from_numpy(np.array(m0)), torch.from_numpy(np.array(Z))


def _round_tf32(x):
    """x with its fp32 mantissa rounded to TF32's 10 bits (to nearest)."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & -0x2000).view(torch.float32)


def test_match_gate_accepts_fp32_refuses_tf32(models, monkeypatch):
    """The port's fp32 forward against the JAX package's passes the gate
    far inside GATE_REL; the same forward with every linear's and einsum's
    operands rounded to TF32 (what cuBLAS does with TF32 allowed) fails it
    by more than 2x."""
    params, model = models
    rng = np.random.default_rng(1)
    data = _pair(rng)
    data["descriptors1"][1, :20] = _unit(data["descriptors0"][1, :20]
                                         + 0.1 * rng.normal(size=(20, 64)))
    cfg = tsg.resolve_config({**CFG, "match_threshold": 0.2})
    ref_m0, ref_Z = jax_matches_and_log_assignment(params, data, cfg)
    tdata = {k: v if k.startswith("shape") else torch.from_numpy(v)
             for k, v in data.items()}

    def gate():
        Z = tsg.log_assignment(model, tdata, cfg)
        return tsg.match_gate(tsg.mutual_matches(Z, 0.2).matches0, Z,
                              ref_m0, ref_Z, 0.2)

    fp32 = gate()
    assert fp32.ok and fp32.max_rel_diff < tsg.GATE_REL / 10, fp32
    linear, einsum = torch.nn.functional.linear, torch.einsum
    monkeypatch.setattr(torch.nn.functional, "linear", lambda x, w, b=None:
                        linear(_round_tf32(x), _round_tf32(w), b))
    monkeypatch.setattr(torch, "einsum", lambda eq, *ops:
                        einsum(eq, *map(_round_tf32, ops)))
    tf32 = gate()
    assert not tf32.ok and tf32.max_rel_diff > 2 * tsg.GATE_REL, tf32


def test_match_gate_aligns_swapped_keypoint_slots():
    """Keypoints come sorted by score, so two runs may hold the same
    keypoints in other slots. Given both runs' keypoints, the gate compares
    them by position; a run with another keypoint set fails."""
    g = torch.Generator().manual_seed(0)
    b, n0, n1 = 2, 6, 5
    kp0 = torch.randint(0, 100, (b, n0, 2), generator=g).float()
    kp1 = torch.randint(0, 100, (b, n1, 2), generator=g).float()
    ref = torch.randn(b, n0 + 1, n1 + 1, generator=g) * 3
    p0 = torch.stack([torch.randperm(n0, generator=g) for _ in range(b)])
    p1 = torch.stack([torch.randperm(n1, generator=g) for _ in range(b)])
    Z = ref.clone()
    Z[:, :-1, :-1] = ref[:, :-1, :-1].gather(
        1, p0[..., None].expand(-1, -1, n1)).gather(
        2, p1[:, None].expand(-1, n0, -1))
    kp = (kp0.gather(1, p0[..., None].expand(-1, -1, 2)),
          kp1.gather(1, p1[..., None].expand(-1, -1, 2)))
    ref_m0 = tsg.mutual_matches(ref, 0.0).matches0
    m0 = tsg.mutual_matches(Z, 0.0).matches0
    gate = tsg.match_gate(m0, Z, ref_m0, ref, 0.0, kp, (kp0, kp1))
    assert gate.ok and gate.max_abs_diff == 0 and gate.diff == 0, gate
    assert not tsg.match_gate(m0, Z, ref_m0, ref, 0.0).ok
    moved = (kp[0].clone(), kp[1])
    moved[0][0, 0] += 1
    gate = tsg.match_gate(m0, Z, ref_m0, ref, 0.0, moved, (kp0, kp1))
    assert not gate.ok and not gate.same_keypoints
