"""Boundaries of the PyTorch port: it never imports JAX, importing it
builds nothing, its pipeline pins fp32, and chip_smoke.py has no CPU path."""
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = """
import importlib, pkgutil, sys
import onepose_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    onepose_tpu_torch.__path__, "onepose_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
assert "jax" not in sys.modules, sorted(m for m in sys.modules if "jax" in m)
assert "triton" not in sys.modules
print(len(names))
"""


def _clean_env():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return env


def test_port_never_imports_jax():
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO,
                         capture_output=True, text=True, timeout=300,
                         env=_clean_env())
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 12


def test_precision_pinned_after_pipeline_is_built():
    from onepose_tpu_torch.models import convert
    from onepose_tpu_torch.ops.precision import fp32_pinned
    from onepose_tpu_torch.pipeline import PosePipeline
    from onepose_tpu.datasets import anno

    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32,
             torch.get_float32_matmul_precision())
    try:
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.set_float32_matmul_precision("high")
        assert not fp32_pinned()
        rng = np.random.default_rng(0)
        db = anno.build_object_db(
            avg_keypoints3d=np.zeros((4, 3), np.float32),
            avg_descriptors3d=np.ones((256, 4), np.float32),
            avg_scores3d=np.ones((4, 1), np.float32),
            clt_descriptors=np.ones((256, 8), np.float32),
            clt_scores=np.ones((8, 1), np.float32),
            idxs=np.full(4, 2), num_leaf=2, shape3d=8)
        PosePipeline(
            convert.superpoint_from_jax(convert.init_superpoint_params(rng)),
            convert.gats_spg_from_jax(convert.init_gats_spg_params(
                rng, {"num_blocks": 1})), db)
        assert fp32_pinned()
        assert not torch.backends.cudnn.allow_tf32
        assert not torch.backends.cuda.matmul.allow_tf32
        assert torch.get_float32_matmul_precision() == "highest"
    finally:
        torch.backends.cudnn.allow_tf32 = saved[0]
        torch.backends.cuda.matmul.allow_tf32 = saved[1]
        torch.set_float32_matmul_precision(saved[2])


def test_chip_smoke_refuses_without_cuda(tmp_path):
    """No card: exit 1 and no result line, both in the repository and in a
    directory that holds chip_smoke.py alone."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")

    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    for cwd in (REPO, str(tmp_path)):
        out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                             capture_output=True, text=True, timeout=300,
                             env=_clean_env())
        assert out.returncode != 0
        assert '"ok": true' not in out.stdout
