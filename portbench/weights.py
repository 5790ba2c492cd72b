"""Seeded random weights, made on the device in two large draws per model.

Each model's parameter names and shapes are listed here from its
configuration (the port's module layout, so that ``load_state_dict``
with ``strict=True`` checks them against the program), each with its
init rule: He-normal convolutions with zero biases (SuperPoint),
uniform ±sqrt(1/fan_in) linears, xavier-normal GATs weights, identity
BatchNorm and a dustbin score of 1 (the JAX package's schemes). One
``torch.randn`` and one ``torch.rand`` over all of a model's entries,
from one generator on the device, then each entry a scaled slice: the
same seed gives the same weights, in fp32, the type they are served in.
"""
from __future__ import annotations

import math

import numpy as np
import torch

SP_ENCODER = [("conv1a", 1, 64), ("conv1b", 64, 64), ("conv2a", 64, 64),
              ("conv2b", 64, 64), ("conv3a", 64, 128), ("conv3b", 128, 128),
              ("conv4a", 128, 128), ("conv4b", 128, 128)]


def sub_seed(seed: int, tag: str) -> int:
    """A 63-bit seed for the draw named ``tag`` of run ``seed``."""
    words = [int(seed) & 0xFFFFFFFF, (int(seed) >> 32) & 0xFFFFFFFF,
             *tag.encode()]
    return int(np.random.SeedSequence(words).generate_state(
        1, np.uint64)[0] >> np.uint64(1))


def generator(seed: int, tag: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, tag))


def superpoint_shapes(cfg: dict) -> dict:
    """name → (shape, rule) for SuperPoint's VGG encoder and heads."""
    d = cfg["descriptor_dim"]
    convs = SP_ENCODER + [("convPa", 128, 256), ("convPb", 256, 65),
                          ("convDa", 128, 256), ("convDb", 256, d)]
    out = {}
    for name, cin, cout in convs:
        k = 1 if name in ("convPb", "convDb") else 3
        out[f"{name}.weight"] = ((cout, cin, k, k),
                                 ("normal", math.sqrt(2.0 / (cin * k * k))))
        out[f"{name}.bias"] = ((cout,), ("const", 0.0))
    return out


def _linear(out, name, cin, cout):
    bound = math.sqrt(1.0 / cin)
    out[f"{name}.weight"] = ((cout, cin), ("uniform", bound))
    out[f"{name}.bias"] = ((cout,), ("uniform", bound))


def gats_spg_shapes(cfg: dict) -> dict:
    """GATsSPG: ``num_blocks`` × [GATs, self, cross] and the final
    projection."""
    d = cfg["descriptor_dim"]
    out = {}
    for i in range(3 * cfg["num_blocks"]):
        p = f"gnn.{i}"
        if i % 3 == 0:
            out[f"{p}.W"] = ((d, d), ("normal", 1.414 * math.sqrt(1.0 / d)))
            out[f"{p}.a"] = ((2 * d, 1),
                             ("normal", 1.414 * math.sqrt(2.0 / (2 * d + 1))))
        else:
            for name, cin, cout in (("proj_q", d, d), ("proj_k", d, d),
                                    ("proj_v", d, d), ("merge", d, d),
                                    ("mlp0", 2 * d, 2 * d),
                                    ("mlp1", 2 * d, d)):
                _linear(out, f"{p}.{name}", cin, cout)
    _linear(out, "final_proj", d, d)
    return out


def _mlp_bn(out, prefix, channels):
    for i in range(1, len(channels)):
        _linear(out, f"{prefix}.lin.{i - 1}", channels[i - 1], channels[i])
        if i < len(channels) - 1:
            c, bn = channels[i], f"{prefix}.bn.{i - 1}"
            out[f"{bn}.weight"] = ((c,), ("const", 1.0))
            out[f"{bn}.bias"] = ((c,), ("const", 0.0))
            out[f"{bn}.running_mean"] = ((c,), ("const", 0.0))
            out[f"{bn}.running_var"] = ((c,), ("const", 1.0))
            out[f"{bn}.num_batches_tracked"] = ((), ("count", 0))


def superglue_shapes(cfg: dict) -> dict:
    """SuperGlue: keypoint encoder, ``num_gnn_layers`` attention layers,
    final projection and dustbin score."""
    d = cfg["descriptor_dim"]
    out = {}
    _mlp_bn(out, "kenc", [3, *cfg["keypoint_encoder"]])
    for i in range(cfg["num_gnn_layers"]):
        for name in ("proj_q", "proj_k", "proj_v", "merge"):
            _linear(out, f"gnn.{i}.{name}", d, d)
        _mlp_bn(out, f"gnn.{i}.mlp", [2 * d, 2 * d, d])
    _linear(out, "final_proj", d, d)
    out["bin_score"] = ((), ("const", 1.0))
    return out


def make_weights(shapes: dict, seed: int, tag: str, device) -> dict:
    """name → tensor on ``device``, drawn by the rules of ``shapes``."""
    sizes = [math.prod(shape) for shape, _ in shapes.values()]
    total = sum(sizes)
    gen = generator(seed, tag, device)
    normal = torch.randn(total, generator=gen, device=device)
    uniform = torch.rand(total, generator=gen, device=device)
    out, at = {}, 0
    for (name, (shape, (rule, arg))), n in zip(shapes.items(), sizes):
        if rule == "normal":
            t = normal[at:at + n] * arg
        elif rule == "uniform":
            t = (uniform[at:at + n] * 2.0 - 1.0) * arg
        elif rule == "const":
            t = torch.full((n,), float(arg), device=device)
        else:   # BatchNorm's step counter
            t = torch.full((n,), int(arg), dtype=torch.int64, device=device)
        out[name] = t.reshape(shape).clone()
        at += n
    return out


def load_module(cls, sd: dict, *args):
    """An instance of the program's module ``cls(*args)`` holding copies
    of ``sd``'s tensors (its layout checked name by name), in eval mode.
    It is built on the tensors' device (building on the meta device
    imports ``torch.distributed.tensor``, seconds of set-up)."""
    with torch.device(next(iter(sd.values())).device):
        module = cls(*args)
    module.load_state_dict({k: v.clone() for k, v in sd.items()},
                           strict=True, assign=True)
    return module.eval()
