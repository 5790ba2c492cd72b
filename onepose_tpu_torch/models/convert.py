"""Weight bridge into the port's modules.

Two sources:

- JAX parameter pytrees of ``onepose_tpu`` (as numpy or array-likes):
  conv weights HWIO → OIHW, dense ``[cin, cout]`` → ``nn.Linear``
  ``[cout, cin]``, GATs ``W [d, d]`` and ``a [2d, 1]`` as they are,
  BatchNorm ``gamma/beta/mean/var`` → ``weight/bias/running_mean/
  running_var``;
- reference PyTorch state dicts (``superpoint_v1.pth``, ``GATsSPG.ckpt``,
  ``superglue_{indoor,outdoor}.pth``), in the role of
  ``onepose_tpu/models/convert.py``: Conv1d ``[out, in, 1]`` →
  ``nn.Linear`` ``[out, in]``, SuperPoint's names load as they are.

``init_superpoint_params``, ``init_gats_spg_params`` and
``init_superglue_params`` make seeded random weights in the JAX layout
with numpy alone, with the JAX package's init schemes, so that a machine
without JAX can build the models. ``plant_superglue`` turns such weights
into a SuperGlue that matches descriptors by self-similarity.
"""
from __future__ import annotations

import copy
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from onepose_tpu_torch.models.gats_spg import DEFAULT_CONFIG as GATS_CONFIG
from onepose_tpu_torch.models.gats_spg import GATsSPG
from onepose_tpu_torch.models.superglue import DEFAULT_CONFIG as SG_CONFIG
from onepose_tpu_torch.models.superglue import SuperGlue
from onepose_tpu_torch.models.superpoint import (ENCODER_CHANNELS, HEADS,
                                                 SuperPoint)

SUPERPOINT_CONVS = tuple(e[0] for e in ENCODER_CHANNELS if e[0] != "pool") \
    + tuple(h[0] for h in HEADS) + ("convDb",)


def _t(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).cpu()
    return torch.from_numpy(np.array(x, dtype=np.float32))


# ---------------------------------------------------------------------------
# JAX layout → port
# ---------------------------------------------------------------------------

def superpoint_from_jax(params: Mapping) -> SuperPoint:
    """``onepose_tpu.models.superpoint`` params → :class:`SuperPoint`."""
    dim = np.shape(params["convDb"]["w"])[-1]
    sd = {}
    for name in SUPERPOINT_CONVS:
        sd[f"{name}.weight"] = _t(params[name]["w"]).permute(3, 2, 0, 1)
        sd[f"{name}.bias"] = _t(params[name]["b"])
    model = SuperPoint(dim)
    model.load_state_dict(sd)
    return model.eval()


def _linear(prefix: str, p: Mapping) -> Dict[str, torch.Tensor]:
    return {f"{prefix}.weight": _t(p["w"]).T, f"{prefix}.bias": _t(p["b"])}


def gats_spg_from_jax(params: Mapping) -> GATsSPG:
    """``onepose_tpu.models.gats_spg`` params → :class:`GATsSPG`."""
    layers = params["gnn"]
    d = np.shape(params["final_proj"]["w"])[0]
    sd = _linear("final_proj", params["final_proj"])
    for i, p in enumerate(layers):
        base = f"gnn.{i}"
        if i % 3 == 0:
            sd[f"{base}.W"] = _t(p["W"])
            sd[f"{base}.a"] = _t(p["a"])
        else:
            for name in ("proj_q", "proj_k", "proj_v", "merge", "mlp0",
                         "mlp1"):
                sd.update(_linear(f"{base}.{name}", p[name]))
    model = GATsSPG(d, len(layers) // 3)
    model.load_state_dict(sd)
    return model.eval()


def _mlp_bn(prefix: str, layers) -> Dict[str, torch.Tensor]:
    """JAX ``[{"lin", "bn"?}, ...]`` → :class:`superglue.MLP` keys."""
    sd = {}
    for i, layer in enumerate(layers):
        sd.update(_linear(f"{prefix}.lin.{i}", layer["lin"]))
        if "bn" in layer:
            bn = layer["bn"]
            sd.update({f"{prefix}.bn.{i}.weight": _t(bn["gamma"]),
                       f"{prefix}.bn.{i}.bias": _t(bn["beta"]),
                       f"{prefix}.bn.{i}.running_mean": _t(bn["mean"]),
                       f"{prefix}.bn.{i}.running_var": _t(bn["var"]),
                       f"{prefix}.bn.{i}.num_batches_tracked":
                           torch.tensor(0)})
    return sd


def superglue_from_jax(params: Mapping) -> SuperGlue:
    """``onepose_tpu.models.superglue`` params → :class:`SuperGlue`."""
    sd = _mlp_bn("kenc", params["kenc"])
    for i, p in enumerate(params["gnn"]):
        for name in ("proj_q", "proj_k", "proj_v", "merge"):
            sd.update(_linear(f"gnn.{i}.{name}", p[name]))
        sd.update(_mlp_bn(f"gnn.{i}.mlp", p["mlp"]))
    sd.update(_linear("final_proj", params["final_proj"]))
    sd["bin_score"] = _t(params["bin_score"]).reshape(())
    channels = [np.shape(layer["lin"]["w"])[1] for layer in params["kenc"]]
    model = SuperGlue(channels, len(params["gnn"]))
    model.load_state_dict(sd)
    return model.eval()


# ---------------------------------------------------------------------------
# Reference torch checkpoints → port
# ---------------------------------------------------------------------------

def load_state_dict(path: str, strip_prefixes=("matcher.", "model.")):
    """Load a .pth/.ckpt file into a flat state dict of tensors, with the
    given key prefixes stripped (the reference loader's convention)."""
    blob = torch.load(path, map_location="cpu", weights_only=False)
    sd = blob.get("state_dict", blob) if isinstance(blob, dict) else blob
    out = {}
    for k, v in sd.items():
        for p in strip_prefixes:
            if k.startswith(p):
                k = k[len(p):]
        out[k] = v
    return out


def superpoint_from_state_dict(sd: Mapping) -> SuperPoint:
    """Reference ``superpoint_v1.pth`` keys → :class:`SuperPoint`."""
    dim = sd["convDb.weight"].shape[0]
    model = SuperPoint(dim)
    model.load_state_dict({
        f"{n}.{k}": _t(sd[f"{n}.{k}"])
        for n in SUPERPOINT_CONVS for k in ("weight", "bias")})
    return model.eval()


def gats_spg_from_state_dict(sd: Mapping) -> GATsSPG:
    """Reference ``GATsSPG.ckpt`` keys (``matcher.`` already stripped) →
    :class:`GATsSPG`, the number of blocks read from the keys."""
    num_blocks = len({k.split(".")[2] for k in sd
                      if k.startswith("gnn.layers.")}) // 3

    def conv1d(prefix: str, name: str):
        return {f"{prefix}.weight": _t(sd[f"{name}.weight"])[:, :, 0],
                f"{prefix}.bias": _t(sd[f"{name}.bias"])}

    out = conv1d("final_proj", "final_proj")
    for i in range(3 * num_blocks):
        ref, base = f"gnn.layers.{i}", f"gnn.{i}"
        if i % 3 == 0:
            out[f"{base}.W"] = _t(sd[f"{ref}.W"])
            out[f"{base}.a"] = _t(sd[f"{ref}.a"])
            continue
        for j, name in enumerate(("proj_q", "proj_k", "proj_v")):
            out.update(conv1d(f"{base}.{name}", f"{ref}.attn.proj.{j}"))
        out.update(conv1d(f"{base}.merge", f"{ref}.attn.merge"))
        # mlp Sequential: [Conv1d, InstanceNorm1d (no params), ReLU, Conv1d]
        out.update(conv1d(f"{base}.mlp0", f"{ref}.mlp.0"))
        out.update(conv1d(f"{base}.mlp1", f"{ref}.mlp.3"))
    model = GATsSPG(out["final_proj.weight"].shape[0], num_blocks)
    model.load_state_dict(out)
    return model.eval()


def gats_spg_to_state_dict(model: GATsSPG) -> Dict[str, torch.Tensor]:
    """:class:`GATsSPG` → reference ``GATsSPG.ckpt`` keys (without the
    ``matcher.`` prefix; Conv1d weights ``[out, in, 1]``), the inverse of
    :func:`gats_spg_from_state_dict`."""
    sd = model.state_dict()
    out = {}

    def conv1d(ref: str, prefix: str):
        out[f"{ref}.weight"] = sd[f"{prefix}.weight"].detach().cpu()[..., None]
        out[f"{ref}.bias"] = sd[f"{prefix}.bias"].detach().cpu()

    conv1d("final_proj", "final_proj")
    for i in range(len(model.gnn)):
        ref, base = f"gnn.layers.{i}", f"gnn.{i}"
        if i % 3 == 0:
            out[f"{ref}.W"] = sd[f"{base}.W"].detach().cpu()
            out[f"{ref}.a"] = sd[f"{base}.a"].detach().cpu()
            continue
        for j, name in enumerate(("proj_q", "proj_k", "proj_v")):
            conv1d(f"{ref}.attn.proj.{j}", f"{base}.{name}")
        conv1d(f"{ref}.attn.merge", f"{base}.merge")
        conv1d(f"{ref}.mlp.0", f"{base}.mlp0")
        conv1d(f"{ref}.mlp.3", f"{base}.mlp1")
    return out


def superglue_from_state_dict(sd: Mapping) -> SuperGlue:
    """Reference ``superglue_{indoor,outdoor}.pth`` keys → :class:`SuperGlue`,
    through the JAX layout (the encoder's and the GNN's depth read from
    the keys)."""
    def conv(name):
        return {"w": _t(sd[f"{name}.weight"])[:, :, 0].T,
                "b": _t(sd[f"{name}.bias"])}

    def mlp(ref):
        """nn.Sequential of [Conv1d, BatchNorm1d, ReLU] * k + Conv1d."""
        convs = [j for j in range(len(sd))
                 if np.ndim(sd.get(f"{ref}.{j}.weight")) == 3]
        layers = [{"lin": conv(f"{ref}.{j}")} for j in convs]
        for layer, j in zip(layers[:-1], convs):
            bn = f"{ref}.{j + 1}"
            layer["bn"] = {"gamma": sd[f"{bn}.weight"],
                           "beta": sd[f"{bn}.bias"],
                           "mean": sd[f"{bn}.running_mean"],
                           "var": sd[f"{bn}.running_var"]}
        return layers

    n_layers = len({k.split(".")[2] for k in sd
                    if k.startswith("gnn.layers.")})
    return superglue_from_jax({
        "kenc": mlp("kenc.encoder"),
        "gnn": [{**{name: conv(f"gnn.layers.{i}.attn.proj.{j}")
                    for j, name in enumerate(("proj_q", "proj_k", "proj_v"))},
                 "merge": conv(f"gnn.layers.{i}.attn.merge"),
                 "mlp": mlp(f"gnn.layers.{i}.mlp")}
                for i in range(n_layers)],
        "final_proj": conv("final_proj"),
        "bin_score": sd["bin_score"],
    })


def superglue_to_state_dict(params: Mapping) -> Dict[str, torch.Tensor]:
    """SuperGlue params in the JAX layout → the reference checkpoint's keys
    (``superglue_outdoor.pth``'s), which :func:`superglue_from_state_dict`
    and ``utils/model_io.load_superglue`` read back."""
    sd = {}

    def conv(name, lin):
        sd[f"{name}.weight"] = _t(lin["w"]).T[:, :, None].contiguous()
        sd[f"{name}.bias"] = _t(lin["b"])

    def mlp(ref, layers):
        """[Conv1d, BatchNorm1d, ReLU] * k + Conv1d, as nn.Sequential."""
        for i, layer in enumerate(layers):
            conv(f"{ref}.{3 * i}", layer["lin"])
            if "bn" in layer:
                bn = layer["bn"]
                for key, name in (("weight", "gamma"), ("bias", "beta"),
                                  ("running_mean", "mean"),
                                  ("running_var", "var")):
                    sd[f"{ref}.{3 * i + 1}.{key}"] = _t(bn[name])

    mlp("kenc.encoder", params["kenc"])
    for i, p in enumerate(params["gnn"]):
        for j, name in enumerate(("proj_q", "proj_k", "proj_v")):
            conv(f"gnn.layers.{i}.attn.proj.{j}", p[name])
        conv(f"gnn.layers.{i}.attn.merge", p["merge"])
        mlp(f"gnn.layers.{i}.mlp", p["mlp"])
    conv("final_proj", params["final_proj"])
    sd["bin_score"] = _t(params["bin_score"]).reshape(())
    return sd


# ---------------------------------------------------------------------------
# Seeded init in the JAX layout, numpy only
# ---------------------------------------------------------------------------

def init_superpoint_params(rng: np.random.Generator,
                           descriptor_dim: int = 256) -> Dict:
    """He-normal convs (HWIO) with zero biases, the JAX package's scheme."""
    def conv(cin, cout, k):
        w = rng.standard_normal((k, k, cin, cout), np.float32)
        w *= np.float32(np.sqrt(2.0 / (cin * k * k)))
        return {"w": w, "b": np.zeros(cout, np.float32)}

    params = {e[0]: conv(e[1], e[2], 3)
              for e in ENCODER_CHANNELS if e[0] != "pool"}
    for name, cin, cout, k in HEADS:
        params[name] = conv(cin, cout, k)
    params["convDb"] = conv(256, descriptor_dim, 1)
    return params


def init_gats_spg_params(rng: np.random.Generator,
                         config: Optional[dict] = None) -> Dict:
    """Kaiming-uniform dense layers ([cin, cout]) and xavier-normal GATs
    weights (gain 1.414), the JAX package's scheme."""
    cfg = dict(GATS_CONFIG)
    cfg.update(config or {})
    d = cfg["descriptor_dim"]

    def dense(cin, cout):
        bound = np.float32(np.sqrt(1.0 / cin))
        return {"w": rng.uniform(-bound, bound, (cin, cout)).astype(np.float32),
                "b": rng.uniform(-bound, bound, cout).astype(np.float32)}

    def gats():
        std_w = 1.414 * np.sqrt(2.0 / (d + d))
        std_a = 1.414 * np.sqrt(2.0 / (2 * d + 1))
        return {"W": (std_w * rng.standard_normal((d, d))).astype(np.float32),
                "a": (std_a * rng.standard_normal((2 * d, 1))
                      ).astype(np.float32)}

    def attn():
        return {"proj_q": dense(d, d), "proj_k": dense(d, d),
                "proj_v": dense(d, d), "merge": dense(d, d),
                "mlp0": dense(2 * d, 2 * d), "mlp1": dense(2 * d, d)}

    layers = [gats() if i % 3 == 0 else attn()
              for i in range(3 * cfg["num_blocks"])]
    return {"gnn": layers, "final_proj": dense(d, d)}


def init_superglue_params(rng: np.random.Generator,
                          config: Optional[dict] = None) -> Dict:
    """Uniform ±sqrt(1/cin) dense layers ([cin, cout]), identity
    BatchNorm and a dustbin score of 1, the JAX package's scheme."""
    cfg = dict(SG_CONFIG)
    cfg.update(config or {})
    d = cfg["descriptor_dim"]

    def dense(cin, cout):
        bound = np.float32(np.sqrt(1.0 / cin))
        return {"w": rng.uniform(-bound, bound, (cin, cout)).astype(np.float32),
                "b": rng.uniform(-bound, bound, cout).astype(np.float32)}

    def mlp_bn(channels):
        layers = []
        for i in range(1, len(channels)):
            entry = {"lin": dense(channels[i - 1], channels[i])}
            if i < len(channels) - 1:
                c = channels[i]
                entry["bn"] = {"gamma": np.ones(c, np.float32),
                               "beta": np.zeros(c, np.float32),
                               "mean": np.zeros(c, np.float32),
                               "var": np.ones(c, np.float32)}
            layers.append(entry)
        return layers

    return {
        "kenc": mlp_bn([3, *cfg["keypoint_encoder"]]),
        "gnn": [{"proj_q": dense(d, d), "proj_k": dense(d, d),
                 "proj_v": dense(d, d), "merge": dense(d, d),
                 "mlp": mlp_bn([2 * d, 2 * d, d])}
                for _ in range(cfg["num_gnn_layers"])],
        "final_proj": dense(d, d),
        "bin_score": np.array(1.0, np.float32),
    }


def plant_superglue(params, db_det, delta, target=50.0):
    """Planted SuperGlue weights for checks without a trained checkpoint:
    a copy of ``params`` (JAX layout, numpy) whose keypoint encoder's and
    GNN layers' last linears are scaled by ``delta`` (0: every delta is
    zero) and whose final projection is s·(x - mu). Random SuperPoint
    descriptors share one dominant direction (cosines about 0.999), so mu
    is the mean of ``db_det``'s valid descriptors (a
    :class:`superpoint.SuperPointOutput` of the DB views), and s puts a
    typical self-match score at ``target``. Matching is then descriptor
    self-similarity: a view pasted into a frame is found where it was
    pasted."""
    params = copy.deepcopy(params)
    for lin in [params["kenc"][-1]["lin"]] + [p["mlp"][-1]["lin"]
                                              for p in params["gnn"]]:
        lin["w"] *= np.float32(delta)
        lin["b"] *= np.float32(delta)
    desc = db_det.descriptors[db_det.mask].double().cpu().numpy()
    mu = desc.mean(0)
    d = desc.shape[1]
    scale = np.sqrt(target * np.sqrt(d)
                    / np.median(((desc - mu) ** 2).sum(-1)))
    params["final_proj"] = {"w": (np.eye(d) * scale).astype(np.float32),
                            "b": (-scale * mu).astype(np.float32)}
    return params
