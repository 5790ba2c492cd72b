"""The port's real-assets eval entry (onepose_tpu_torch/eval_real.py) on
the CPU: ``--check`` against the root ``scripts/eval_real.py`` (the same
report and return code, BLOCKED and READY), a full ``--skip-sfm`` run on
``test_torch_inference_entry.py``'s world (the appended cmd1/3/5 are the
means of the port's ``inference.inference`` on the same config), and a run
without ``--skip-sfm``, whose SfM step is a spy: the port's ``run.sfm``
called with ``+preprocess=sfm_spp_spg_sample``, no SfM run on the CPU."""
import os
import os.path as osp
import shutil
import sys

import numpy as np
import pytest
import torch

from onepose_tpu_torch import eval_real, inference, run
from onepose_tpu_torch.config import load_config
from onepose_tpu_torch.models import convert, gats_spg as tgats
from onepose_tpu_torch.utils import model_io
from test_torch_inference_entry import KPTS, PNP, build_world

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
OBJ, SEQ = "0001-plane-box", "plane-1"


def _root_eval_real():
    sys.path.insert(0, osp.join(REPO, "scripts"))
    try:
        import eval_real as root
    finally:
        sys.path.remove(osp.join(REPO, "scripts"))
    return root


def _main(mod, argv):
    cwd = os.getcwd()
    try:
        return mod.main(argv)
    finally:
        os.chdir(cwd)


def _ready_assets(root):
    """The files and directories test_sample's asset check probes."""
    for path in ("models/checkpoints/onepose/GATsSPG.ckpt",
                 "models/extractors/SuperPoint/superpoint_v1.pth"):
        os.makedirs(osp.dirname(root / path), exist_ok=True)
        (root / path).write_bytes(b"")
    os.makedirs(root / "onepose_datasets" / "sample_data"
                / "0501-matchafranzzi-box" / "matchafranzzi-4")


@pytest.mark.parametrize("state", ["BLOCKED", "READY"])
def test_check_matches_the_root_script(tmp_path, capsys, state):
    if state == "READY":
        _ready_assets(tmp_path)
        argv = ["--check", "--experiments", "test_sample", "-o",
                f"data_dir={tmp_path}"]
    else:
        argv = ["--check", "-o", f"data_dir={tmp_path}/nonexistent"]
    outs = []
    for mod in (eval_real, _root_eval_real()):
        rc = _main(mod, argv)
        outs.append((rc, capsys.readouterr().out))
    assert outs[0] == outs[1]
    assert outs[0][0] == (0 if state == "READY" else 1)
    assert f"test_sample: {state}" in outs[0][1]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The inference entry's world, its weights written as the port's
    checkpoint files and its object listed for the experiment."""
    tmp, sp, gats = build_world(tmp_path_factory.mktemp("eval_real_world"))
    torch.save(convert.superpoint_from_jax(sp).state_dict(),
               str(tmp / "superpoint.pth"))
    model_io.save_gats_spg(convert.gats_spg_from_jax(gats),
                           str(tmp / "gats.ckpt"))
    (tmp / "eval_list.txt").write_text(f"{OBJ} {SEQ}\n")
    (tmp / "eval_sfm.txt").write_text(f"{OBJ}\n")
    return tmp


def _overrides(tmp, sfm_model_dir):
    return [f"model.onepose_model_path={tmp}/gats.ckpt",
            f"model.extractor_model_path={tmp}/superpoint.pth",
            f"scan_data_dir={tmp}/data", f"sfm_model_dir={sfm_model_dir}",
            f"input.data_list={tmp}/eval_list.txt",
            f"input.sfm_list={tmp}/eval_sfm.txt",
            "num_leaf=2", "shape3d=64", f"max_keypoints={KPTS}",
            "batch_size=2", f"pnp.num_hypotheses={PNP['num_hypotheses']}",
            f"pnp.refine_iters={PNP['refine_iters']}",
            f"output.eval_dir={tmp}/eval_real", "device=cpu",
            "print_config=False"]


def _appended(path):
    """The metric rows of the baseline section(s) at ``path``."""
    text = open(path).read()
    rows = dict(line.strip("| \n").split(" | ") for line in text.splitlines()
                if line.startswith("| cmd"))
    return text, rows


def test_full_run_appends_the_entrys_means(world, monkeypatch, tmp_path):
    monkeypatch.setitem(tgats.DEFAULT_CONFIG, "match_threshold", 0.0)
    overrides = _overrides(world, world / "sfm_model")
    baseline = tmp_path / "BASELINE.md"
    rc = _main(eval_real, ["--experiments", "test_sample", "--skip-sfm",
                           "--baseline-out", str(baseline), "-o",
                           *overrides])
    assert rc == 0
    text, rows = _appended(baseline)
    assert "PyTorch port on cpu" in text and "test_sample" in text
    cfg = load_config(["+experiment=test_sample", *overrides],
                      config_dir=osp.join(REPO, "configs"))
    results = inference.inference(cfg)
    means = {k: float(np.mean([r[k] for r in results.values()]))
             for k in ("cmd1", "cmd3", "cmd5")}
    assert rows == {k: f"{v:.4f}" for k, v in means.items()}
    assert osp.exists(world / "eval_real" / f"{OBJ}{SEQ}.txt")


def test_missing_annos_run_the_ports_sfm(world, monkeypatch, tmp_path):
    """Without ``--skip-sfm`` an object without annos goes through
    ``run.sfm`` with the sample preprocess config and the same overrides;
    the spy puts the world's annos where SfM writes them."""
    monkeypatch.setitem(tgats.DEFAULT_CONFIG, "match_threshold", 0.0)
    sfm_model_dir = tmp_path / "sfm_model"
    overrides = _overrides(world, sfm_model_dir) + [
        f"dataset.outputs_dir={sfm_model_dir}/{{}}"]
    calls = []

    def spy(cfg):
        calls.append(cfg)
        shutil.copytree(world / "sfm_model" / OBJ,
                        cfg.dataset.outputs_dir.format(OBJ))

    monkeypatch.setattr(run, "sfm", spy)
    rc = _main(eval_real, ["--experiments", "test_sample", "--baseline-out",
                           str(tmp_path / "BASELINE.md"), "-o", *overrides])
    assert rc == 0 and len(calls) == 1
    want = load_config(["+preprocess=sfm_spp_spg_sample", *overrides],
                       config_dir=osp.join(REPO, "configs"))
    assert calls[0] == want and calls[0].type == "sfm"
    assert calls[0].dataset.data_list.endswith("configs/datasets/"
                                               "sfm_sample.txt")
    assert set(_appended(tmp_path / "BASELINE.md")[1]) == {"cmd1", "cmd3",
                                                           "cmd5"}
