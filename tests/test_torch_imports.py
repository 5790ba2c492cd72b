"""Boundaries of the PyTorch port: it never imports JAX, the JAX package
nor the repository's root scripts, importing it builds nothing, its pipeline pins fp32 and runs on
the card unless asked for the CPU, every entry reaches the card through
``runtime.resolve_device``, and chip_smoke.py has no CPU path."""
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
assert "optax" not in sys.modules and "orbax" not in sys.modules
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


# the JAX system's root scripts, importable as top-level modules from the
# repository root (inference.py, feature_matching_object_detector.py, ...);
# chip_smoke.py is the port's own
ROOT_SCRIPTS = sorted(os.path.basename(f)[:-3]
                      for f in glob.glob(os.path.join(REPO, "*.py"))
                      if os.path.basename(f) != "chip_smoke.py")
# and the JAX side's scripts (scripts/eval_real.py, scripts/profile_pnp.py,
# ...): those whose source names the JAX package
JAX_SCRIPTS = sorted(
    os.path.basename(f)[:-3]
    for f in glob.glob(os.path.join(REPO, "scripts", "*.py"))
    if "onepose_tpu" in open(f).read().replace("onepose_tpu_torch", ""))


def _jax_package_imports(path):
    """(line, module) of every import of ``onepose_tpu``, a module in it
    or a root script of the repository in the Python file at ``path``."""
    def hit(name):
        return any(name == m or name.startswith(m + ".")
                   for m in ("onepose_tpu", *ROOT_SCRIPTS, *JAX_SCRIPTS))

    found = []
    for node in ast.walk(ast.parse(open(path).read(), path)):
        if isinstance(node, ast.Import):
            found += [(node.lineno, a.name) for a in node.names if hit(a.name)]
        elif (isinstance(node, ast.ImportFrom) and node.level == 0
              and hit(node.module or "")):
            found.append((node.lineno, node.module))
    return sorted(found)


def test_port_never_imports_the_jax_package():
    files = sorted(glob.glob(os.path.join(REPO, "onepose_tpu_torch", "**",
                                          "*.py"), recursive=True))
    assert len(files) >= 44
    rel = {os.path.relpath(f, os.path.join(REPO, "onepose_tpu_torch"))
           for f in files}
    assert {"serving.py", "detector.py", "feature_matching_object_detector.py",
            "models/superglue.py", "ops/similarity.py",
            "utils/colmap_io.py", "models/nn_matcher.py", "ops/lk_flow.py",
            "ops/lm.py", "tracker.py", "inference_demo.py",
            "sfm/extract.py", "sfm/pairs.py", "sfm/match.py",
            "sfm/triangulate.py", "sfm/global_ba.py", "sfm/postprocess.py",
            "sfm/runner.py", "runtime/native.py", "utils/colmap_db.py",
            "datasets/merge.py", "run.py", "parse_scanned_data.py",
            "video2img.py", "utils/hdf5.py", "eval_real.py",
            "bench.py", "profile_stages.py", "bench_serving.py",
            "bench_tracker.py", "bench_train.py", "demo_pipeline.py",
            *TRAINING_MODULES} <= rel
    files += [os.path.join(REPO, "chip_smoke.py"),
              os.path.join(REPO, "tests", "test_torch_cuda.py")]
    bad = {os.path.relpath(f, REPO): _jax_package_imports(f) for f in files}
    assert not {k: v for k, v in bad.items() if v}


# the training slice's modules
TRAINING_MODULES = ("train/loss.py", "train/trainer.py", "train/callbacks.py",
                    "train/logging.py", "train/entry.py", "train/__main__.py",
                    "datasets/gats_dataset.py",
                    "datasets/normalized_dataset.py")


def test_training_modules_import_no_jax_optax_orbax():
    """No import of jax, optax, orbax or the JAX package anywhere in the
    training slice's modules, at any depth of the code."""
    banned = ("jax", "optax", "orbax", "onepose_tpu")
    for rel in TRAINING_MODULES:
        path = os.path.join(REPO, "onepose_tpu_torch", rel)
        for node in ast.walk(ast.parse(open(path).read(), path)):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     else [])
            for name in names:
                assert not any(name == b or name.startswith(b + ".")
                               for b in banned), (rel, node.lineno, name)


def test_train_entry_runs_as_a_module():
    """``python -m onepose_tpu_torch.train`` reaches the entry's main (a
    config with no ``type`` stops it at the dispatch)."""
    out = subprocess.run(
        [sys.executable, "-m", "onepose_tpu_torch.train", "type=none"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
        env=_clean_env())
    assert out.returncode != 0 and "KeyError: 'none'" in out.stderr, \
        out.stderr[-2000:]


def test_import_scan_sees_jax_package_imports(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("import onepose_tpu\nimport onepose_tpu_torch.ops\n"
                   "from onepose_tpu.utils import geometry\n"
                   "from onepose_tpu_torch import pipeline\n"
                   "def f():\n    import onepose_tpu.config as c\n"
                   "from . import onepose_tpu\n"
                   "import feature_matching_object_detector as fm\n"
                   "from onepose_tpu_torch import inference\n"
                   "from inference import main\n")
    assert "inference" in ROOT_SCRIPTS
    assert _jax_package_imports(str(src)) == [
        (1, "onepose_tpu"), (3, "onepose_tpu.utils"),
        (6, "onepose_tpu.config"), (8, "feature_matching_object_detector"),
        (10, "inference")]


def test_import_scan_sees_the_jax_scripts(tmp_path):
    """The port's eval entry shares its name with the JAX side's
    scripts/eval_real.py: the scan tells the two apart."""
    assert {"eval_real", "profile_pnp"} <= set(JAX_SCRIPTS)
    assert "time_torch_stem" not in JAX_SCRIPTS
    src = tmp_path / "m.py"
    src.write_text("import eval_real\n"
                   "from onepose_tpu_torch import eval_real\n"
                   "import onepose_tpu_torch.eval_real\n"
                   "def f():\n    from profile_pnp import main\n")
    assert _jax_package_imports(str(src)) == [(1, "eval_real"),
                                              (5, "profile_pnp")]


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


class _Refused(Exception):
    """Raised by the stand-in for ``runtime.resolve_device``."""


# every caller of ``runtime.resolve_device``, by the name it passes
CARD_RULE_SITES = (
    "PosePipeline", "LocalFeatureObjectDetector", "LoFTRObjectDetector",
    "BATracker", "PoseServer", "init_train_state", "train", "run_local",
    "bench", "profile_stages", "bench_serving", "bench_tracker",
    "bench_train", "run_sfm", "extract_to_h5", "match_pairs_to_h5",
    "verify_matches", "triangulate_from_h5", "run_bundle_adjuster")


def _entry_sites():
    """{who: call(tmp_path)}: each call asks for the card, as little work
    as possible ahead of the rule."""
    from onepose_tpu_torch import (bench, bench_serving, bench_tracker,
                                   bench_train, detector, pipeline,
                                   profile_stages, serving, tracker)
    from onepose_tpu_torch.config import Config
    from onepose_tpu_torch.parallel import launch
    from onepose_tpu_torch.sfm import (extract, global_ba, match, runner,
                                       triangulate)
    from onepose_tpu_torch.train import entry, trainer

    def server(tmp):
        sp, gats, db = _tiny_pipeline_args(np.random.default_rng(0))
        serving.PoseServer(sp, gats, {"obj": db}, device="cuda")

    return {
        "PosePipeline": lambda tmp: pipeline.PosePipeline(
            None, None, None, device="cuda"),
        "LocalFeatureObjectDetector":
            lambda tmp: detector.LocalFeatureObjectDetector(
                None, None, [], device="cuda"),
        "LoFTRObjectDetector": lambda tmp: detector.LoFTRObjectDetector(
            None, [], device="cuda"),
        "BATracker": lambda tmp: tracker.BATracker(device="cuda"),
        "PoseServer": server,
        "init_train_state": lambda tmp: trainer.init_train_state(
            None, device="cuda"),
        "train": lambda tmp: entry.train(Config({"device": "cuda"})),
        "run_local": lambda tmp: launch.run_local(print, 2, device="cuda"),
        "bench": lambda tmp: bench.run(device="cuda"),
        "profile_stages": lambda tmp: profile_stages.run(device="cuda"),
        "bench_serving": lambda tmp: bench_serving.run(
            bench_serving.parser().parse_args(["--device", "cuda"])),
        "bench_tracker": lambda tmp: bench_tracker.run(
            bench_tracker.parser().parse_args(["--device", "cuda"])),
        "bench_train": lambda tmp: bench_train.run(str(tmp), device="cuda"),
        "run_sfm": lambda tmp: runner.run_sfm(
            [], str(tmp), None, None, {}, {}, {}, device="cuda"),
        "extract_to_h5": lambda tmp: extract.extract_to_h5(
            None, [], str(tmp / "f.h5"), device="cuda"),
        "match_pairs_to_h5": lambda tmp: match.match_pairs_to_h5(
            None, [], str(tmp / "f.h5"), str(tmp / "m.h5"), device="cuda"),
        "verify_matches": lambda tmp: triangulate.verify_matches(
            str(tmp / "f.h5"), str(tmp / "m.h5"), [], {}, {}, device="cuda"),
        "triangulate_from_h5": lambda tmp: triangulate.triangulate_from_h5(
            "", "", [], {}, {}, {}, str(tmp / "model"),
            verification=({}, [], {}), device="cuda"),
        "run_bundle_adjuster": lambda tmp: global_ba.run_bundle_adjuster(
            str(tmp), device="cuda"),
    }


@pytest.mark.parametrize("who", CARD_RULE_SITES)
def test_entries_reach_the_one_card_rule(who, tmp_path, monkeypatch):
    """Every entry that defaults to the card asks ``runtime.resolve_device``
    first, naming itself: with the rule replaced by one that refuses, each
    refuses before it does any work."""
    from onepose_tpu_torch import runtime

    def refuse(device, who):
        raise _Refused(torch.device(device).type, who)

    monkeypatch.setattr(runtime, "resolve_device", refuse)
    sites = _entry_sites()
    assert tuple(sites) == CARD_RULE_SITES
    with pytest.raises(_Refused) as refused:
        sites[who](tmp_path)
    assert refused.value.args == ("cuda", who)


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
