"""The port's SfM extraction and pair matching (sfm/extract.py::
extract_to_h5, sfm/match.py::match_pairs_to_h5) against the JAX
package's, fp32, on the CPU, through the HDF5 files each writes.

Extraction: three 64x96 images, a budget of 64 keypoints, batches of 2
(a full batch and a tail of 1), full-width SuperPoint with weights from
``superpoint.init_params``, the JAX side with ``stem="direct"`` (the plain
math the port runs). Keypoints and their slot order exactly equal;
descriptors and scores within 1e-5.

Matching: SuperGlue at 2 layers, D=64, 10 Sinkhorn iterations, threshold
0.7, weights bridged from ``superglue.init_params`` (the final projection
x24, so that scores pass the threshold); features written directly, with
keypoint counts that fall into two buckets (256 and 512) and descriptors
that share points between the images. Each file holds what its package's
SuperGlue gives on the padded batch, and the two agree under
``superglue.match_gate`` (log assignments within 5e-5 of their scale,
matches0 equal outside near-ties); scores within 1e-5.
"""
import h5py
import jax
import numpy as np
import pytest
import torch

from onepose_tpu.models import superglue as jsg, superpoint as jsp
from onepose_tpu.sfm import extract as jextract, match as jmatch
from onepose_tpu_torch.models import convert, superglue as tsg
from onepose_tpu_torch.sfm import extract as textract, match as tmatch
from test_torch_superglue import jax_matches_and_log_assignment

SG_CFG = {"descriptor_dim": 64, "keypoint_encoder": (16, 32, 64),
          "num_gnn_layers": 2, "num_heads": 4, "sinkhorn_iterations": 10}


def _read(path):
    with h5py.File(path, "r") as f:
        out = {}
        f.visititems(lambda name, obj: out.__setitem__(name, obj[()])
                     if isinstance(obj, h5py.Dataset) else None)
    return out


def test_extract_to_h5_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    params = jsp.init_params(jax.random.PRNGKey(0))
    names = [f"/data/seq/color/{i}.png" for i in range(3)]
    images = {n: rng.uniform(0, 1, (64, 96)).astype(np.float32)
              for n in names}
    conf = {**jextract.CONFS["superpoint"],
            "conf": {**jextract.CONFS["superpoint"]["conf"],
                     "max_keypoints": 64}}
    jconf = {**conf, "conf": {**conf["conf"], "stem": "direct"}}
    ref_p = jextract.extract_to_h5(params, names, str(tmp_path / "j.h5"),
                                   conf=jconf, batch_size=2, images=images)
    got_p = textract.extract_to_h5(
        convert.superpoint_from_jax(jax.tree.map(np.asarray, params)),
        names, str(tmp_path / "t.h5"), conf=conf, batch_size=2,
        images=images, device="cpu")
    ref, got = _read(ref_p), _read(got_p)
    assert sorted(got) == sorted(ref)
    assert len(ref) == 4 * len(names)
    for key, r in ref.items():
        g = got[key]
        assert g.dtype == r.dtype and g.shape == r.shape, key
        if key.endswith(("keypoints", "image_size")):
            np.testing.assert_array_equal(g, r, err_msg=key)
        else:
            np.testing.assert_allclose(g, r, rtol=0, atol=1e-5, err_msg=key)
    for n in names:
        assert 0 < len(got[n[1:] + "/scores"]) <= 64
        np.testing.assert_array_equal(got[n[1:] + "/image_size"], [96, 64])


def test_extract_to_h5_refuses_a_mesh_and_defaults_to_the_card(tmp_path):
    model = convert.superpoint_from_jax(convert.init_superpoint_params(
        np.random.default_rng(0)))
    with pytest.raises(NotImplementedError, match="mesh"):
        textract.extract_to_h5(model, [], str(tmp_path / "x.h5"),
                               device="cpu", mesh=object())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            textract.extract_to_h5(model, [], str(tmp_path / "x.h5"))


def _unit(x):
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


def _write_features(path, rng, counts, shared=120, d=64):
    """Features of len(counts) images in the HDF5 layout: the first
    ``shared`` keypoints of every image are views of the same points
    (noisy copies of one descriptor each, positions shifted a little)."""
    base = _unit(rng.normal(size=(shared, d)))
    base_kp = rng.uniform(0, [96, 64], (shared, 2))
    names = [f"/data/seq/color/{i}.png" for i in range(len(counts))]
    with h5py.File(path, "w") as f:
        for i, (name, n) in enumerate(zip(names, counts)):
            desc = _unit(rng.normal(size=(n, d)))
            desc[:shared] = _unit(base + 0.1 * rng.normal(size=base.shape))
            kp = rng.uniform(0, [96, 64], (n, 2))
            kp[:shared] = base_kp + i
            perm = rng.permutation(n)
            g = f.create_group(name)
            g.create_dataset("keypoints", data=kp[perm].astype(np.float32))
            g.create_dataset("descriptors", data=desc[perm].T)
            g.create_dataset("scores", data=rng.uniform(
                0, 1, n).astype(np.float32))
            g.create_dataset("image_size", data=np.array([96, 64]))
    return names


def test_match_pairs_to_h5_matches_jax(tmp_path):
    rng = np.random.default_rng(1)
    params = jax.tree.map(np.asarray, jsg.init_params(
        jax.random.PRNGKey(0), SG_CFG))
    params["final_proj"]["w"] = params["final_proj"]["w"] * 24
    feat = str(tmp_path / "feats.h5")
    names = _write_features(feat, rng, [200, 300, 250])
    # (0,1) and (1,2) are 256x512 and 512x256; (0,2) 256x256; (1,0) is a
    # symmetric duplicate and is skipped
    pairs = [(names[0], names[1]), (names[1], names[0]),
             (names[1], names[2]), (names[0], names[2])]
    conf = {k: v for k, v in SG_CFG.items()}
    ref_p = jmatch.match_pairs_to_h5(params, pairs, feat,
                                     str(tmp_path / "j.h5"), conf=conf)
    got_p = tmatch.match_pairs_to_h5(
        convert.superglue_from_jax(params), pairs, feat,
        str(tmp_path / "t.h5"), conf=conf, device="cpu")
    ref, got = _read(ref_p), _read(got_p)
    assert sorted(got) == sorted(ref) and len(ref) == 6
    assert tmatch.CONF == jmatch.CONF and tmatch.BUCKETS == jmatch.BUCKETS

    with h5py.File(feat, "r") as f:
        feats = {n: {k: f[n][k][()] for k in f[n]} for n in names}
    cfg = tsg.resolve_config({**jmatch.CONF, **conf})
    matched = 0
    for n0, n1 in (pairs[0], pairs[2], pairs[3]):
        key = jmatch.names_to_pair(n0, n1)
        assert key == tmatch.names_to_pair(n0, n1)
        m_ref, m_got = ref[key + "/matches0"], got[key + "/matches0"]
        assert m_got.dtype == m_ref.dtype and m_got.shape == m_ref.shape
        np.testing.assert_allclose(got[key + "/matching_scores0"],
                                   ref[key + "/matching_scores0"], rtol=0,
                                   atol=1e-5)
        matched += int((m_ref >= 0).sum())
        # the same padded batch through each package's SuperGlue: each
        # file holds its package's matches, and they agree outside
        # near-ties of the log assignment
        data = _padded(feats[n0], feats[n1])
        ref_m0, ref_Z = jax_matches_and_log_assignment(params, data, cfg)
        tdata = {k: v if k.startswith("shape") else torch.from_numpy(v)
                 for k, v in data.items()}
        Z = tsg.log_assignment(convert.superglue_from_jax(params), tdata, cfg)
        m0 = tsg.mutual_matches(Z, cfg["match_threshold"], tdata["mask0"],
                                tdata["mask1"]).matches0
        n = len(m_ref)
        np.testing.assert_array_equal(ref_m0[0, :n].numpy(), m_ref)
        np.testing.assert_array_equal(m0[0, :n].numpy(), m_got)
        gate = tsg.match_gate(m0, Z, ref_m0, ref_Z, cfg["match_threshold"])
        assert gate.ok, (key, gate)
    assert matched >= 50


def _padded(f0, f1):
    """One pair as match_pairs_to_h5 batches it: padded to its buckets."""
    out = {}
    for i, f in (("0", f0), ("1", f1)):
        kp, sc, de, m = jmatch._pad_feats(
            f["keypoints"].astype(np.float32), f["scores"].astype(np.float32),
            f["descriptors"].astype(np.float32).T,
            jmatch._bucket(len(f["keypoints"])))
        out.update({f"keypoints{i}": kp[None], f"scores{i}": sc[None],
                    f"descriptors{i}": de[None], f"mask{i}": m[None],
                    f"shape{i}": tuple(int(v) for v in f["image_size"][::-1])})
    return out
