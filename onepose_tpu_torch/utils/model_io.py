"""Model loading for the port: reference PyTorch checkpoints
(``superpoint_v1.pth``, ``GATsSPG.ckpt``, ``superglue_outdoor.pth``) into
the port's modules, with the reference loader's prefix stripping
(``extractor.``, ``matcher.``, ``model.``).

The JAX package's native orbax checkpoints need JAX to read and are not
loaded here.
"""
from __future__ import annotations

from onepose_tpu_torch.models import convert
from onepose_tpu_torch.models.gats_spg import GATsSPG
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
    """GATsSPG from a reference checkpoint, its depth read from the keys."""
    _check_torch_ckpt(path)
    return convert.gats_spg_from_state_dict(
        convert.load_state_dict(path, strip_prefixes=("matcher.",)))


def load_superglue(path: str) -> SuperGlue:
    _check_torch_ckpt(path)
    return convert.superglue_from_state_dict(convert.load_state_dict(path))
