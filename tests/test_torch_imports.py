"""Boundaries of the PyTorch port: it never imports JAX nor the JAX
package, importing it builds nothing, its pipeline pins fp32 and runs on
the card unless asked for the CPU, and chip_smoke.py has no CPU path."""
import ast
import glob
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
assert "onepose_tpu" not in sys.modules
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


def _jax_package_imports(path):
    """(line, module) of every import of ``onepose_tpu`` or a module in
    it in the Python file at ``path``."""
    def hit(name):
        return name == "onepose_tpu" or name.startswith("onepose_tpu.")

    found = []
    for node in ast.walk(ast.parse(open(path).read(), path)):
        if isinstance(node, ast.Import):
            found += [(node.lineno, a.name) for a in node.names if hit(a.name)]
        elif (isinstance(node, ast.ImportFrom) and node.level == 0
              and hit(node.module or "")):
            found.append((node.lineno, node.module))
    return found


def test_port_never_imports_the_jax_package():
    files = sorted(glob.glob(os.path.join(REPO, "onepose_tpu_torch", "**",
                                          "*.py"), recursive=True))
    assert len(files) >= 20
    files += [os.path.join(REPO, "chip_smoke.py"),
              os.path.join(REPO, "tests", "test_torch_cuda.py")]
    bad = {os.path.relpath(f, REPO): _jax_package_imports(f) for f in files}
    assert not {k: v for k, v in bad.items() if v}


def test_import_scan_sees_jax_package_imports(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("import onepose_tpu\nimport onepose_tpu_torch.ops\n"
                   "from onepose_tpu.utils import geometry\n"
                   "from onepose_tpu_torch import pipeline\n"
                   "def f():\n    import onepose_tpu.config as c\n"
                   "from . import onepose_tpu\n")
    assert _jax_package_imports(str(src)) == [
        (1, "onepose_tpu"), (3, "onepose_tpu.utils"),
        (6, "onepose_tpu.config")]


def _tiny_pipeline_args(rng):
    from onepose_tpu_torch.datasets import anno
    from onepose_tpu_torch.models import convert

    db = anno.build_object_db(
        avg_keypoints3d=np.zeros((4, 3), np.float32),
        avg_descriptors3d=np.ones((256, 4), np.float32),
        avg_scores3d=np.ones((4, 1), np.float32),
        clt_descriptors=np.ones((256, 8), np.float32),
        clt_scores=np.ones((8, 1), np.float32),
        idxs=np.full(4, 2), num_leaf=2, shape3d=8)
    return (convert.superpoint_from_jax(convert.init_superpoint_params(rng)),
            convert.gats_spg_from_jax(convert.init_gats_spg_params(
                rng, {"num_blocks": 1})), db)


def test_pipeline_defaults_to_the_card():
    """Without a card the default device raises; the CPU runs only when
    asked for."""
    from onepose_tpu_torch.pipeline import PosePipeline

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    args = _tiny_pipeline_args(np.random.default_rng(0))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PosePipeline(*args)
    pipe = PosePipeline(*args, sp_config={"max_keypoints": 16},
                        num_hypotheses=8, refine_iters=1, device="cpu")
    assert pipe.device.type == "cpu"
    rng = np.random.default_rng(1)
    out = pipe(rng.uniform(0, 1, (1, 32, 32, 1)).astype(np.float32),
               np.eye(3, dtype=np.float32)[None],
               generator=torch.Generator().manual_seed(0))
    assert out.poses.device.type == "cpu" and out.poses.shape == (1, 3, 4)


def test_precision_pinned_after_pipeline_is_built():
    from onepose_tpu_torch.ops.precision import fp32_pinned
    from onepose_tpu_torch.pipeline import PosePipeline

    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32,
             torch.get_float32_matmul_precision())
    try:
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.set_float32_matmul_precision("high")
        assert not fp32_pinned()
        PosePipeline(*_tiny_pipeline_args(np.random.default_rng(0)),
                     device="cpu")
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
