"""Trainer for the GATsSPG matcher on one device.

Port of ``onepose_tpu/train/trainer.py``: focal loss on the dual-softmax
confidence matrix, and the optimizer of the reference's Lightning module
as the JAX package chains it in optax: clip to global norm 0.5, decayed
weights when ``weight_decay > 0``, Adam, a multi-step LR, inside gradient
accumulation. :class:`Optimizer` computes that chain in fp32 with optax's
order of operations, so the port's updates follow the JAX package's to
fp32 rounding:

- clipping passes a gradient whose global norm is below ``grad_clip``
  unchanged and scales it by ``(g / norm) * grad_clip`` otherwise, with no
  epsilon (``torch.nn.utils.clip_grad_norm_`` divides by ``norm + 1e-6``);
- accumulation over k micro-steps keeps the running mean
  ``acc + (g - acc) / (n + 1)`` (``optax.MultiSteps``), and clipping, Adam
  and the schedule advance once per k micro-steps;
- Adam's bias corrections ``1 - b**t`` are fp32 (``b**t`` the fp32
  rounding of the power, as XLA computes it) and ``1 - b`` an fp32
  constant, as optax forms them (``torch.optim.Adam`` forms them in fp64,
  about 6.6e-6 relative apart in each update);
- the LR is ``base_lr * gamma**(milestones passed)``, scaled once the
  update count reaches a milestone (``optax.piecewise_constant_schedule``).

The device-resident input path (``materialize_light_batch``) keeps every
object's observation descriptors on the device; a batch ships leaf
indices, or the uniforms of ``sample_leaves_on_device``, the query
descriptors and the sparse ground-truth pairs. The leaf uniforms come
from a ``torch.Generator`` seeded by the dataset's per-item seed
(:func:`leaf_uniforms`): torch cannot replay ``jax.random``, so tests
inject the JAX package's uniforms.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from onepose_tpu_torch.models import convert, gats_spg
from onepose_tpu_torch.train.loss import focal_loss


def multistep_schedule(base_lr: float, milestones_steps: Iterable[int],
                       gamma: float) -> Callable[[int], np.float32]:
    """MultiStepLR in steps (callers convert epochs → steps): the fp32 LR
    at update count ``count``, scaled by ``gamma`` for every milestone
    with ``count >= milestone``."""
    boundaries = sorted({int(m): gamma for m in milestones_steps}.items())

    def schedule(count: int) -> np.float32:
        lr = np.float32(base_lr)
        for threshold, scale in boundaries:
            if count >= threshold:
                lr = np.float32(scale) * lr
        return lr

    return schedule


class Optimizer:
    """Accumulate k micro-steps, then clip → [decay] → Adam → LR → apply.

    ``named_params`` are the (name, parameter) pairs to update, read in
    that order; :meth:`step` reads their ``.grad`` (None counts as zero).
    ``grad_transforms`` run first on every micro-step, before the
    accumulation: each is called with the names and the gradients and
    returns the gradients (``callbacks.unfreeze_after``)."""

    def __init__(self, named_params: Iterable[Tuple[str, torch.Tensor]],
                 base_lr: float = 1e-3, weight_decay: float = 0.0,
                 milestones_steps: Sequence[int] = (), gamma: float = 0.5,
                 grad_clip: float = 0.5, accumulate_steps: int = 1,
                 grad_transforms: Sequence = (), b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        named = list(named_params)
        self.names = [n for n, _ in named]
        self.params = [p for _, p in named]
        self.schedule = multistep_schedule(base_lr, milestones_steps, gamma)
        self.weight_decay = weight_decay
        self.grad_clip = grad_clip
        self.k = int(accumulate_steps)
        self.grad_transforms = list(grad_transforms)
        self.b1, self.b2, self.eps = b1, b2, eps
        self.mini_step = 0     # micro-steps accumulated since the update
        self.updates = 0       # Adam's and the schedule's count
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.acc = [torch.zeros_like(p) for p in self.params] \
            if self.k > 1 else None

    @torch.no_grad()
    def step(self) -> bool:
        """One micro-step; True when it updated the parameters."""
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in self.params]
        for transform in self.grad_transforms:
            grads = transform(self.names, grads)
        if self.k > 1:
            diff = torch._foreach_sub(grads, self.acc)
            torch._foreach_div_(diff, float(self.mini_step + 1))
            torch._foreach_add_(self.acc, diff)
            self.mini_step += 1
            if self.mini_step < self.k:
                return False
            self.mini_step = 0
            grads = self.acc
        self._update(grads)
        if self.k > 1:
            for a in self.acc:
                a.zero_()
        return True

    def _update(self, grads: List[torch.Tensor]) -> None:
        # clip by global norm: (g / norm) * max where norm >= max
        norm = torch.stack([g.square().sum() for g in grads]).sum().sqrt()
        clipped = torch._foreach_div(grads, norm)
        torch._foreach_mul_(clipped, self.grad_clip)
        keep = norm < self.grad_clip
        grads = [torch.where(keep, g, c) for g, c in zip(grads, clipped)]
        if self.weight_decay > 0:
            grads = torch._foreach_add(
                grads, torch._foreach_mul(self.params, self.weight_decay))
        # Adam: moments, fp32 bias corrections, u = m̂ / (sqrt(v̂) + eps)
        b1, b2 = self.b1, self.b2
        self.mu = torch._foreach_add(torch._foreach_mul(grads, 1 - b1),
                                     torch._foreach_mul(self.mu, b1))
        self.nu = torch._foreach_add(
            torch._foreach_mul(torch._foreach_mul(grads, grads), 1 - b2),
            torch._foreach_mul(self.nu, b2))
        count = self.updates + 1
        bc1, bc2 = (float(np.float32(1) - np.float32(
            np.float64(np.float32(b)) ** count)) for b in (b1, b2))
        den = torch._foreach_sqrt(torch._foreach_div(self.nu, bc2))
        torch._foreach_add_(den, self.eps)
        upd = torch._foreach_div(torch._foreach_div(self.mu, bc1), den)
        torch._foreach_mul_(upd, float(-self.schedule(self.updates)))
        torch._foreach_add_(self.params, upd)
        self.updates = count

    def state_dict(self) -> dict:
        def named(ts):
            return dict(zip(self.names, ts)) if ts is not None else None

        return {"mini_step": self.mini_step, "updates": self.updates,
                "mu": named(self.mu), "nu": named(self.nu),
                "acc": named(self.acc),
                "grad_transforms": [t.state_dict()
                                    for t in self.grad_transforms]}

    def load_state_dict(self, sd: dict) -> None:
        self.mini_step, self.updates = sd["mini_step"], sd["updates"]
        for key in ("mu", "nu", "acc"):
            if getattr(self, key) is not None:
                setattr(self, key, [sd[key][n].to(p.device) for n, p in
                                    zip(self.names, self.params)])
        for t, tsd in zip(self.grad_transforms, sd["grad_transforms"]):
            t.load_state_dict(tsd)


def make_optimizer(base_lr: float = 1e-3, weight_decay: float = 0.0,
                   milestones_steps: Sequence[int] = (), gamma: float = 0.5,
                   grad_clip: float = 0.5, accumulate_steps: int = 1,
                   grad_transforms: Sequence = ()
                   ) -> Callable[..., Optimizer]:
    """The optimizer's settings; called with (name, parameter) pairs it
    builds the :class:`Optimizer` (``init_train_state`` does)."""
    return functools.partial(
        Optimizer, base_lr=base_lr, weight_decay=weight_decay,
        milestones_steps=tuple(milestones_steps), gamma=gamma,
        grad_clip=grad_clip, accumulate_steps=accumulate_steps,
        grad_transforms=tuple(grad_transforms))


@dataclasses.dataclass
class TrainState:
    model: gats_spg.GATsSPG
    optimizer: Optimizer
    step: int = 0      # micro-steps taken


def init_train_state(tx: Callable[..., Optimizer],
                     gats_config: Optional[dict] = None,
                     model: Optional[gats_spg.GATsSPG] = None,
                     seed: int = 0,
                     device: torch.device | str = "cuda") -> TrainState:
    """``model`` on ``device`` (else one made from ``seed`` with the JAX
    package's init schemes, ``convert.init_gats_spg_params``) and its
    optimizer."""
    cfg = gats_spg.resolve_config(gats_config)
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("init_train_state: no CUDA device; pass "
                           "device='cpu' to train on the CPU")
    if model is None:
        model = convert.gats_spg_from_jax(convert.init_gats_spg_params(
            np.random.default_rng(seed), cfg))
    model = model.to(device).train()
    return TrainState(model, tx(model.named_parameters()), 0)


def compute_loss(model: gats_spg.GATsSPG, batch: Dict[str, torch.Tensor],
                 gats_config: Optional[dict] = None,
                 loss_config: Optional[dict] = None) -> torch.Tensor:
    """batch keys: descriptors2d_query / descriptors3d_db /
    descriptors2d_db ([B, N, D]) and conf_gt [B, N1, N2] (pads encoded as
    negatives, the reference's convention). The conf matrix is
    ``forward_train``'s; its matches are not formed."""
    cfg = gats_spg.resolve_config(gats_config)
    m0, m1 = gats_spg.gnn_body(model, batch, cfg)
    conf = gats_spg.dual_softmax_conf(m0, m1, cfg["scale_factor"])
    return focal_loss(conf, batch["conf_gt"], **(loss_config or {}))


def train_step(state: TrainState, batch: Dict[str, torch.Tensor],
               gats_config: Optional[dict] = None
               ) -> Tuple[TrainState, torch.Tensor]:
    """Loss, gradients and one optimizer micro-step → (state, loss)."""
    loss = compute_loss(state.model, batch, gats_config)
    loss.backward()
    state.optimizer.step()
    state.model.zero_grad(set_to_none=True)
    state.step += 1
    return state, loss.detach()


def make_train_step(gats_config: Optional[dict] = None):
    """step(state, batch) -> (state, loss) on dense batches."""
    return functools.partial(train_step, gats_config=gats_config)


def leaf_uniforms(seeds: Sequence[int], num_leaf: int,
                  shape3d: int) -> np.ndarray:
    """[B, num_leaf, shape3d] uniforms in [0, 1), item b's from a CPU
    ``torch.Generator`` seeded ``seeds[b]``: the same on every device."""
    return np.stack([torch.rand(
        (num_leaf, shape3d),
        generator=torch.Generator().manual_seed(int(s))).numpy()
        for s in seeds])


def sample_leaves_on_device(uniform: torch.Tensor, counts: torch.Tensor,
                            offsets: torch.Tensor, num_leaf: int,
                            dustbin_row: int) -> torch.Tensor:
    """Leaf sampling on the device, the counterpart of
    ``datasets.anno.sample_leaf_indices`` (uniform without replacement per
    point's segment of observations).

    Sparse Fisher–Yates, vectorized over points: draw j ∈ [0, num_leaf)
    picks v0 uniform over the c−j values not yet chosen, then maps it past
    the j chosen ones by the monotone fixed point v ← v0 + #{chosen ≤ v}
    (converges in ≤ j steps). The draws are an exchangeable uniform
    ordered sample.

    uniform [..., num_leaf, S] in [0, 1); counts, offsets [..., S] (each
    point's observation count and segment start) → [..., S, num_leaf]
    int32 rows into the observation stack (``dustbin_row`` where a point
    has fewer than ``num_leaf`` observations)."""
    counts = counts.to(torch.int32)
    big = torch.iinfo(torch.int32).max
    chosen = torch.full(uniform.shape, big, dtype=torch.int32,
                        device=uniform.device)
    for j in range(num_leaf):
        rem = counts - j
        v0 = torch.minimum((uniform[..., j, :] * rem).to(torch.int32).clamp(
            min=0), (rem - 1).clamp(min=0))
        v = v0
        for _ in range(j):
            v = v0 + (chosen[..., :j, :] <= v[..., None, :]).sum(
                -2, dtype=torch.int32)
        chosen[..., j, :] = torch.where(rem > 0, v, big)
    pick = torch.where(chosen == big, dustbin_row,
                       offsets[..., None, :].to(torch.int32) + chosen)
    return pick.transpose(-1, -2)


def materialize_light_batch(db: Dict[str, torch.Tensor],
                            light: Dict[str, torch.Tensor], shape2d: int,
                            shape3d: int, pad_val: int = 0,
                            num_leaf: int = 8) -> Dict[str, torch.Tensor]:
    """Expand a light batch into the dense training batch on its device.

    db: ``GATsSPGDataset.device_db()``'s stacks on the device: clt_stack
    [O, T+1, D] (row T the dustbin, ones), avg_stack [O, S3, D], and for
    ``leaf_uniform`` batches count_stack / offset_stack [O, S3].
    light: obj_idx [B], leaf_idx [B, S3*L] (rows of the T+1 axis) or
    leaf_uniform [B, L, S3], descriptors2d_query [B, S2, D], pairs
    [B, P, 2] (padded with (shape2d, shape3d)), num2d [B], num3d [B].

    The leaf gather and the dense conf_gt are made here, exactly as
    ``GATsSPGDataset.get`` makes them (dustbin ones, the assignment
    scattered, ``pad_val`` rows and columns). A pair outside [0, shape2d)
    x [0, shape3d) after negative indices wrap is dropped, as JAX's
    ``mode="drop"`` scatter drops it."""
    obj = light["obj_idx"].long()
    b = obj.shape[0]
    clt = db["clt_stack"]
    if "leaf_uniform" in light:
        leaf_idx = sample_leaves_on_device(
            light["leaf_uniform"], db["count_stack"][obj],
            db["offset_stack"][obj], num_leaf,
            clt.shape[1] - 1).reshape(b, -1)
    else:
        leaf_idx = light["leaf_idx"]
    d2db = clt[obj[:, None], leaf_idx.long()]          # [B, S3*L, D]
    d3db = db["avg_stack"][obj]                        # [B, S3, D]

    pairs = light["pairs"].long()
    i = torch.where(pairs[..., 0] < 0, pairs[..., 0] + shape2d,
                    pairs[..., 0])
    j = torch.where(pairs[..., 1] < 0, pairs[..., 1] + shape3d,
                    pairs[..., 1])
    inside = (i >= 0) & (i < shape2d) & (j >= 0) & (j < shape3d)
    cells = shape2d * shape3d
    base = torch.arange(b, device=obj.device)[:, None] * cells
    flat = torch.where(inside, base + i * shape3d + j, b * cells)
    conf = torch.zeros(b * cells + 1, dtype=torch.int32, device=obj.device)
    conf[flat.reshape(-1)] = 1
    conf = conf[:-1].view(b, shape2d, shape3d)
    r2 = torch.arange(shape2d, device=obj.device)[None, :, None]
    r3 = torch.arange(shape3d, device=obj.device)[None, None, :]
    pad = ((r2 >= light["num2d"][:, None, None])
           | (r3 >= light["num3d"][:, None, None]))
    conf = torch.where(pad, pad_val, conf)
    return {"descriptors2d_query": light["descriptors2d_query"],
            "descriptors3d_db": d3db, "descriptors2d_db": d2db,
            "conf_gt": conf}


def gather_train_step(state: TrainState, light: Dict[str, torch.Tensor],
                      db: Dict[str, torch.Tensor],
                      gats_config: Optional[dict], shape2d: int,
                      shape3d: int, pad_val: int = 0, num_leaf: int = 8
                      ) -> Tuple[TrainState, torch.Tensor]:
    """:func:`materialize_light_batch`, then :func:`train_step`."""
    with torch.no_grad():
        batch = materialize_light_batch(db, light, shape2d, shape3d,
                                        pad_val, num_leaf)
    return train_step(state, batch, gats_config)


def make_gather_train_step(gats_config: Optional[dict],
                           db: Dict[str, torch.Tensor], shape2d: int,
                           shape3d: int, pad_val: int = 0,
                           num_leaf: int = 8):
    """Device-resident-DB training step: step(state, light_batch).

    ``db`` already on the training device; light batches carrying
    ``leaf_uniform`` (instead of ``leaf_idx``) sample their leaves on the
    device, from the db's ``count_stack`` / ``offset_stack``."""
    return functools.partial(
        gather_train_step, db=db, gats_config=gats_config, shape2d=shape2d,
        shape3d=shape3d, pad_val=pad_val, num_leaf=num_leaf)
