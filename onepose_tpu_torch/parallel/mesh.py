"""Device mesh and batch placement over a world of ranks.

Counterpart of ``onepose_tpu/parallel/mesh.py``. The JAX ``("data",
"model")`` mesh becomes a ``torch.distributed.device_mesh.DeviceMesh``
with the same axis names over the world's ranks, one card each; each
axis's process group stands in for a ``PartitionSpec`` axis, and the
collectives that XLA would insert are written out by the callers
(``parallel/collectives.py``). Ranks are laid out row-major, as the JAX
package reshapes its device list: rank = data index × model size + model
index.

- ``data``: the batch (data parallelism);
- ``model``: serving's object catalog (``serving.PoseServer``), and
  GATsSPG's 3D tokens in the pipeline and the train steps
  (``PosePipeline``, ``train/trainer.py``): each rank of a model group
  holds a contiguous shard of the N2 tokens (:func:`token_rows`) and the
  GNN runs over the group's process group (``gats_spg``'s
  ``token_group``).
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from onepose_tpu_torch.parallel import collectives as comm


def make_mesh(n_devices: Optional[int] = None,
              axis_shapes: Optional[Sequence[int]] = None,
              axis_names: Sequence[str] = ("data", "model")):
    """A mesh over the world's ``n_devices`` ranks (default: all of
    them), all on ``data`` unless ``axis_shapes`` says otherwise (e.g.
    ``(n // 2, 2)``). The world must be initialized
    (``launch.run_local`` or ``launch.maybe_initialize``) and hold exactly
    ``n_devices`` ranks: one rank drives one card."""
    from torch.distributed.device_mesh import init_device_mesh

    world = comm.get_world_size()
    if n_devices is None:
        n_devices = world
    if axis_shapes is None:
        axis_shapes = (n_devices, 1)
    if int(np.prod(axis_shapes)) != n_devices:
        raise ValueError(f"axis_shapes {tuple(axis_shapes)} != {n_devices} "
                         "devices")
    if not dist.is_initialized() or n_devices != world:
        raise ValueError(f"make_mesh: {n_devices} devices need a world of "
                         f"{n_devices} ranks, one a card (this world has "
                         f"{world}; see parallel/launch.py)")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, tuple(int(s) for s in axis_shapes),
                            mesh_dim_names=tuple(axis_names))


def axis_size(mesh, name: str) -> int:
    """The size of ``mesh``'s axis ``name`` (1 without a mesh or without
    that axis)."""
    if mesh is None or name not in (mesh.mesh_dim_names or ()):
        return 1
    return mesh.size(mesh.mesh_dim_names.index(name))


def axis_index(mesh, name: str) -> int:
    """This rank's coordinate along ``mesh``'s axis ``name``."""
    if axis_size(mesh, name) == 1:
        return 0
    return mesh.get_local_rank(name)


def axis_group(mesh, name: str):
    """The process group of this rank's ``name`` axis (of one rank when
    the axis has size 1: the collectives then do nothing)."""
    return mesh.get_group(name)


def data_rows(mesh, n: int) -> slice:
    """This rank's rows of a global batch of ``n`` along the data axis;
    the data-axis size must divide ``n``."""
    size = axis_size(mesh, "data")
    if n % size:
        raise ValueError(f"batch {n} not divisible by the data axis {size}")
    per = n // size
    lo = axis_index(mesh, "data") * per
    return slice(lo, lo + per)


def token_group(mesh, n2: int):
    """The model axis's process group when it shards ``n2`` 3D tokens:
    an axis above 1 that divides ``n2``. Else None: every rank holds the
    whole tokens (replicated over ``model``). The JAX pipeline decides by
    each DB tensor's leading axis; the three it shards (``descriptors3d``
    [N2, D], ``descriptors2d_db`` [N2·L, D], ``mask3d`` [N2]) all divide
    when N2 does, so one decision by N2 is the same rule. Either way the
    math is the same."""
    m = axis_size(mesh, "model")
    if m == 1 or n2 % m:
        return None
    return axis_group(mesh, "model")


def token_rows(mesh, n2: int) -> slice:
    """This rank's contiguous slice of ``n2`` 3D tokens: the model
    index's n2/m of them when :func:`token_group` shards them, else all."""
    if token_group(mesh, n2) is None:
        return slice(0, n2)
    per = n2 // axis_size(mesh, "model")
    lo = axis_index(mesh, "model") * per
    return slice(lo, lo + per)


def token_shard(mesh, n2: int, tensors: dict, dim: int = 0) -> dict:
    """Each tensor's part of this rank's :func:`token_rows` along ``dim``,
    whose length is a multiple k of ``n2`` (token-major: rows [lo·k,
    hi·k), as the point-major leaf rows of ``descriptors2d_db`` lie).
    Views, not copies."""
    rows = token_rows(mesh, n2)
    out = {}
    for name, t in tensors.items():
        k = t.shape[dim] // n2
        out[name] = t.narrow(dim, rows.start * k, (rows.stop - rows.start) * k)
    return out


def shard_batch(mesh, batch, device):
    """This rank's rows of the global batch on ``device``: each rank
    passes its local slice, as in the JAX package's multi-process
    contract, so the global batch is the local one times the data axis.
    ``batch`` is a dict (or list or tuple) of numpy arrays or tensors."""
    if isinstance(batch, dict):
        return {k: shard_batch(mesh, v, device) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(shard_batch(mesh, v, device) for v in batch)
    return torch.as_tensor(np.asarray(batch) if not isinstance(
        batch, torch.Tensor) else batch).to(device)


def replicate(mesh, tree, device):
    """``tree`` on ``device``; under a mesh broadcast from rank 0 over the
    world, so that every rank holds rank 0's values. A module (its
    parameters and buffers, in place), or a dict, list or tuple of arrays
    or tensors."""
    if isinstance(tree, torch.nn.Module):
        tree = tree.to(device)
        if mesh is not None:
            with torch.no_grad():
                for t in list(tree.parameters()) + list(tree.buffers()):
                    comm.broadcast(t.data, 0)
        return tree
    if isinstance(tree, dict):
        return {k: replicate(mesh, v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(replicate(mesh, v, device) for v in tree)
    t = torch.as_tensor(np.asarray(tree) if not isinstance(
        tree, torch.Tensor) else tree).to(device)
    return t if mesh is None else comm.broadcast(t.contiguous(), 0)
