"""Collectives across ranks, written out on ``torch.distributed``.

Counterpart of ``onepose_tpu/parallel/collectives.py``: rank and world
queries, a barrier, an all-gather of fixed-shape arrays with a leading
rank axis, metric reduction, a shared seed, and a sum over a mesh axis.
They carry tensors and fixed-shape numpy data only; there is no pickled
object path. With one process (no world initialized) each degrades to
the JAX package's single-process behaviour.

The tensor helpers (:func:`all_reduce`, :func:`broadcast`,
:func:`all_gather`) take a tensor on the rank's device and work in place
or return on that device. NCCL needs CUDA tensors; gloo takes CPU tensors,
and CUDA tensors too for all three (ranks that share a card run over
gloo; ``chip_smoke.py`` phase 14 runs them so). Booleans travel as uint8.

Under autograd (GATsSPG's token-sharded model axis): :func:`all_reduce_sum`
(its backward all-reduces the gradient), :func:`all_gather_cat` (its
backward sums the gradient over the group and keeps this rank's slice, a
reduce-scatter) and :func:`all_reduce_max` (no gradient: a softmax's
shift). Each takes CUDA tensors on NCCL and on gloo (``chip_smoke.py``
phase 15 runs both), so none stages through the host.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.distributed as dist


def _world() -> bool:
    return dist.is_available() and dist.is_initialized()


def get_world_size() -> int:
    return dist.get_world_size() if _world() else 1


def get_rank() -> int:
    return dist.get_rank() if _world() else 0


def is_main_process() -> bool:
    return get_rank() == 0


def group_size(group=None) -> int:
    return dist.get_world_size(group) if _world() else 1


def synchronize():
    """Barrier across the world (no-op with one process)."""
    if get_world_size() == 1:
        return
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


def comm_device(group=None) -> torch.device:
    """Where host data goes for a collective on ``group``: the current
    card under NCCL, else the CPU."""
    if _world() and dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _wire(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.uint8) if t.dtype == torch.bool else t


def all_reduce(t: torch.Tensor, op: str = "sum", group=None
               ) -> torch.Tensor:
    """``t`` reduced over ``group`` in place (``op`` "sum" or "max");
    returns ``t``."""
    if group_size(group) == 1:
        return t
    red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
    if t.dtype == torch.bool:
        w = t.to(torch.uint8)
        dist.all_reduce(w, red, group=group)
        t.copy_(w.bool())
    else:
        dist.all_reduce(t, red, group=group)
    return t


def broadcast(t: torch.Tensor, src: int = 0, group=None) -> torch.Tensor:
    """``t`` overwritten in place with global rank ``src``'s; returns
    ``t``."""
    if group_size(group) == 1:
        return t
    w = _wire(t)
    dist.broadcast(w, src, group=group)
    if w is not t:
        t.copy_(w.bool())
    return t


def all_gather(t: torch.Tensor, group=None) -> torch.Tensor:
    """[group size, *t.shape]: every rank's ``t`` in group-rank order, on
    ``t``'s device."""
    if group_size(group) == 1:
        return t[None]
    w = _wire(t).contiguous()
    out = [torch.empty_like(w) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, w, group=group)
    res = torch.stack(out)
    return res.bool() if t.dtype == torch.bool else res


def all_gather_arrays(tree, group=None):
    """All-gather a tree (dict, list, tuple) of equal-shape numpy arrays
    across ranks → the same tree with a leading rank axis."""
    if isinstance(tree, dict):
        return {k: all_gather_arrays(v, group) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(all_gather_arrays(v, group) for v in tree)
    arr = np.asarray(tree)
    if group_size(group) == 1:
        return arr[None]
    t = torch.from_numpy(np.ascontiguousarray(arr)).to(comm_device(group))
    return all_gather(t, group).cpu().numpy()


def reduce_dict(metrics: Dict[str, float], average: bool = True,
                group=None) -> Dict[str, float]:
    """Scalar metrics reduced across ranks over sorted keys (mean, or sum
    with ``average=False``)."""
    if group_size(group) == 1:
        return dict(metrics)
    keys = sorted(metrics)
    vec = np.asarray([float(metrics[k]) for k in keys], np.float64)
    gathered = all_gather_arrays(vec, group)          # [P, K]
    red = gathered.mean(axis=0) if average else gathered.sum(axis=0)
    return {k: float(v) for k, v in zip(keys, red)}


def shared_random_seed() -> int:
    """A seed all ranks agree on: rank 0's draw."""
    seed = np.random.randint(0, 2 ** 31)
    gathered = all_gather_arrays(np.asarray([seed], np.int64))
    return int(np.asarray(gathered).reshape(-1)[0])


def psum_metrics(values: Dict[str, torch.Tensor], mesh=None,
                 axis_name: str = "data") -> Dict[str, torch.Tensor]:
    """Each tensor summed over the ranks of ``mesh``'s ``axis_name`` (the
    whole world without a mesh); new tensors, the inputs untouched."""
    group = mesh.get_group(axis_name) if mesh is not None else None
    return {k: all_reduce(v.clone(), "sum", group) for k, v in values.items()}


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return all_reduce(t.clone(memory_format=torch.contiguous_format),
                          "sum", group)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad.clone(memory_format=torch.contiguous_format),
                          "sum", ctx.group), None


class _AllGatherCat(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, dim, group):
        ctx.dim, ctx.group, ctx.n = dim, group, t.shape[dim]
        return torch.cat(tuple(all_gather(t, group)), dim)

    @staticmethod
    def backward(ctx, grad):
        total = all_reduce(grad.clone(memory_format=torch.contiguous_format),
                           "sum", ctx.group)
        rank = dist.get_rank(ctx.group)
        return total.narrow(ctx.dim, rank * ctx.n, ctx.n), None, None


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """Σ of every rank's ``t`` over ``group``, a new tensor, under
    autograd: each rank's loss is its share of the group's, so the
    gradient of ``t`` is the sum of every rank's gradient of the result."""
    if group_size(group) == 1:
        return t
    return _AllReduceSum.apply(t, group)


def all_gather_cat(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    """Every rank's ``t`` concatenated along ``dim`` in group-rank order
    (equal shapes), under autograd: the gradient of ``t`` is this rank's
    slice of the group's summed gradient."""
    if group_size(group) == 1:
        return t
    return _AllGatherCat.apply(t, dim, group)


def all_reduce_max(t: torch.Tensor, group) -> torch.Tensor:
    """Elementwise max of every rank's ``t`` over ``group``, detached: a
    softmax's shift, which moves no gradient."""
    return all_reduce(t.detach().clone(
        memory_format=torch.contiguous_format), "max", group)
