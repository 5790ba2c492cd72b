"""Model loading and training checkpoints for the port.

- Reference PyTorch checkpoints (``superpoint_v1.pth``, ``GATsSPG.ckpt``,
  ``superglue_outdoor.pth``) load into the port's modules with the
  reference loader's prefix stripping (``extractor.``, ``matcher.``,
  ``model.``). A LoFTR state dict under LoFTR's module names loads into
  ``models/loftr.LoFTR`` by name, with a configuration of the variant
  that module builds (``temp_bug_fix`` True; ``resolve_config`` refuses
  the others).
- Training checkpoints are torch files too: ``state_dict`` holds the
  matcher's parameters under the reference's key names (``matcher.gnn.
  layers.{i}...``), so :func:`load_gats_spg` reads one directly; beside it
  the file holds the optimizer state and the step. :func:`latest_checkpoint`
  finds the highest ``epoch=N`` file.

The JAX package's native orbax checkpoints need JAX to read and are not
loaded here.
"""
from __future__ import annotations

import glob
import os
import os.path as osp
import re
from typing import Optional

import torch

from onepose_tpu_torch.models import convert
from onepose_tpu_torch.models.gats_spg import GATsSPG
from onepose_tpu_torch.models.loftr import LoFTR
from onepose_tpu_torch.models.superglue import SuperGlue
from onepose_tpu_torch.models.superpoint import SuperPoint

TORCH_SUFFIXES = (".pth", ".ckpt", ".pt")


def _check_torch_ckpt(path: str) -> None:
    if not path.endswith(TORCH_SUFFIXES):
        raise ValueError(
            f"{path}: the PyTorch port loads {'/'.join(TORCH_SUFFIXES)} "
            "checkpoints only")


def load_superpoint(path: str) -> SuperPoint:
    _check_torch_ckpt(path)
    return convert.superpoint_from_state_dict(
        convert.load_state_dict(path, strip_prefixes=("extractor.",)))


def load_gats_spg(path: str) -> GATsSPG:
    """GATsSPG from a reference checkpoint or a training checkpoint of the
    port, its depth read from the keys."""
    _check_torch_ckpt(path)
    return convert.gats_spg_from_state_dict(
        convert.load_state_dict(path, strip_prefixes=("matcher.",)))


def load_superglue(path: str) -> SuperGlue:
    _check_torch_ckpt(path)
    return convert.superglue_from_state_dict(convert.load_state_dict(path))


def load_loftr(path: str, config=None) -> LoFTR:
    """LoFTR from a state dict under its module names (a ``matcher.``
    prefix, as LoFTR's Lightning module saves it, stripped), strictly by
    name; ``config`` as ``models/loftr.resolve_config`` takes it (a
    variant the module does not build raises ``ValueError``). The positional
    encoding's buffer, which older checkpoints hold, is rebuilt, not
    read."""
    _check_torch_ckpt(path)
    sd = convert.load_state_dict(path, strip_prefixes=("matcher.",))
    sd = {k: v for k, v in sd.items() if not k.startswith("pos_encoding.")}
    model = LoFTR(config)
    model.load_state_dict(sd, strict=True)
    return model.eval()


# ---------------------------------------------------------------------------
# Training checkpoints
# ---------------------------------------------------------------------------

def _matcher_state_dict(model: GATsSPG) -> dict:
    return {f"matcher.{k}": v
            for k, v in convert.gats_spg_to_state_dict(model).items()}


def save_gats_spg(model: GATsSPG, path: str) -> None:
    """The matcher's parameters alone, in the reference layout."""
    _check_torch_ckpt(path)
    os.makedirs(osp.dirname(path) or ".", exist_ok=True)
    torch.save({"state_dict": _matcher_state_dict(model)}, path)


def save_train_state(state, path: str) -> None:
    """A ``trainer.TrainState``: the matcher's parameters (reference
    layout), the optimizer state and the step."""
    _check_torch_ckpt(path)
    os.makedirs(osp.dirname(path) or ".", exist_ok=True)
    torch.save({"state_dict": _matcher_state_dict(state.model),
                "optimizer": state.optimizer.state_dict(),
                "step": state.step}, path)


def load_train_state(path: str, state):
    """Restore a checkpoint of :func:`save_train_state` into ``state`` (a
    ``trainer.TrainState`` of the same model shape), in place."""
    blob = torch.load(path, map_location="cpu", weights_only=False)
    model = convert.gats_spg_from_state_dict(
        {k.removeprefix("matcher."): v for k, v in blob["state_dict"].items()})
    with torch.no_grad():
        for p, src in zip(state.model.parameters(), model.parameters()):
            p.copy_(src)
    state.optimizer.load_state_dict(blob["optimizer"])
    state.step = int(blob["step"])
    return state


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    """The highest-epoch checkpoint named ``epoch=<n>...`` in ``ckpt_dir``
    (the reference's epoch-numbered discovery), or None."""
    best, best_epoch = None, -1
    for c in glob.glob(osp.join(ckpt_dir, "epoch=*")):
        m = re.search(r"epoch=(\d+)", osp.basename(c))
        if m and int(m.group(1)) > best_epoch:
            best, best_epoch = c, int(m.group(1))
    return best
