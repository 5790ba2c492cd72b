"""Real-assets eval of the PyTorch port: the acceptance run on the
reference checkpoints and the OnePose data, in one command.

Counterpart of the repository's ``scripts/eval_real.py``, driving the
port's entries. Once ``superpoint_v1.pth`` / ``GATsSPG.ckpt`` (and, to
build missing SfM annos, ``superglue_outdoor.pth``) and the dataset lie
under ``data/``, it runs the reference protocol and records cmd1/3/5:

  1. asset check: weights, data lists, sequence dirs, per-object SfM anno
  2. SfM for any object whose anno files are missing (``run.sfm``)
  3. ``inference.inference`` for ``+experiment=test_sample`` then
     ``test_GATsSPG``
  4. the aggregate metrics appended to BASELINE.md (timestamped), under
     a heading that names the port and the device, with the stages'
     seconds beside the card's name and power limit

Usage:
  python -m onepose_tpu_torch.eval_real --check          # asset report only
  python -m onepose_tpu_torch.eval_real                  # full protocol
  python -m onepose_tpu_torch.eval_real --experiments test_sample
  python -m onepose_tpu_torch.eval_real -o data_dir=/elsewhere device=cpu

SfM and inference run on the device the config key ``device`` names
(default ``cuda``; ``-o device=cpu`` for the CPU).
"""
from __future__ import annotations

import argparse
import datetime
import os
import os.path as osp
import subprocess
import time

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))

# experiment -> the preprocess config that builds its SfM annos
SFM_PREPROCESS = {
    "test_sample": "sfm_spp_spg_sample",
    "test_GATsSPG": "sfm_spp_spg_test",
}


def _read_list(path):
    with open(path) as f:
        return [line.strip() for line in f if line.strip()]


def check_assets(cfg):
    """Returns (ok, present, missing): asset availability for one
    experiment config."""
    present, missing = [], []

    def probe(path, label):
        (present if osp.exists(path) else missing).append(f"{label}: {path}")

    probe(cfg.model.onepose_model_path, "GATsSPG checkpoint")
    probe(cfg.model.extractor_model_path, "SuperPoint weights")
    probe(cfg.input.data_list, "data list")
    probe(cfg.input.sfm_list, "sfm list")
    if osp.exists(cfg.input.data_list):
        for entry in _read_list(cfg.input.data_list):
            parts = entry.split(" ")
            obj_dir, seqs = parts[0], parts[1:]
            for seq in seqs:
                probe(osp.join(cfg.scan_data_dir, obj_dir, seq),
                      f"sequence {obj_dir}/{seq}")
    return not missing, present, missing


def missing_sfm_objects(cfg):
    """Objects in the sfm list whose anno files don't exist yet."""
    from onepose_tpu_torch.utils import path_utils

    if not osp.exists(cfg.input.sfm_list):
        return []
    todo = []
    for sfm_name in _read_list(cfg.input.sfm_list):
        anno_dir = path_utils.get_anno_dir(
            osp.join(cfg.sfm_model_dir, sfm_name),
            cfg.network.detection, cfg.network.matching)
        if not osp.exists(osp.join(anno_dir, "anno_3d_average.npz")):
            todo.append(sfm_name)
    return todo


def device_description(device) -> str:
    """The device a run used: for a card, nvidia-smi's name and power
    limit (``name, power.limit``), else the device's name."""
    import torch

    device = torch.device(device)
    if device.type != "cuda":
        return device.type
    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", f"--id={device.index or 0}"],
            capture_output=True, text=True, timeout=60)
        if smi.returncode == 0 and smi.stdout.strip():
            return smi.stdout.strip().splitlines()[0]
    except (OSError, subprocess.TimeoutExpired):
        pass
    return torch.cuda.get_device_name(device)


def run_experiment(experiment, overrides, baseline_out, skip_sfm=False):
    """One experiment's protocol; its aggregate metrics, or None when it
    was blocked or evaluated nothing."""
    import numpy as np

    from onepose_tpu_torch import inference, run
    from onepose_tpu_torch.config import load_config

    cfg = load_config([f"+experiment={experiment}"] + list(overrides))
    ok, present, missing = check_assets(cfg)
    if missing:
        print(f"[eval_real] {experiment}: BLOCKED — missing assets:")
        for m in missing:
            print(f"  - {m}")
        return None

    seconds = {}
    todo = missing_sfm_objects(cfg)
    if todo and not skip_sfm:
        pre = SFM_PREPROCESS.get(experiment)
        if pre is None:
            print(f"[eval_real] {experiment}: no preprocess mapping; "
                  f"{len(todo)} objects lack SfM annos: {todo}")
            return None
        print(f"[eval_real] building SfM annos for {len(todo)} objects "
              f"via +preprocess={pre}")
        sfm_cfg = load_config([f"+preprocess={pre}"] + list(overrides))
        t0 = time.perf_counter()
        run.sfm(sfm_cfg)
        seconds["sfm"] = time.perf_counter() - t0

    print(f"[eval_real] running inference +experiment={experiment}")
    t0 = time.perf_counter()
    results = inference.inference(cfg)
    seconds["inference"] = time.perf_counter() - t0
    if not results:
        print(f"[eval_real] {experiment}: no sequences evaluated")
        return None

    agg = {k: float(np.mean([r[k] for r in results.values()]))
           for k in next(iter(results.values()))}
    device = device_description(cfg.get("device", "cuda"))
    times = ", ".join(f"{k} {v:.1f} s" for k, v in seconds.items())
    stamp = datetime.datetime.now().strftime("%Y-%m-%d %H:%M")
    lines = [
        "",
        f"## Measured on real assets — `{experiment}` ({stamp}), "
        f"PyTorch port on {device}",
        "",
        f"Sequences: {len(results)}. Stage times: {times} ({device}).",
        "",
        "| metric | value |",
        "|---|---|",
    ]
    for k in sorted(agg):
        lines.append(f"| {k} | {agg[k]:.4f} |")
    with open(baseline_out, "a") as f:
        f.write("\n".join(lines) + "\n")
    print(f"[eval_real] {experiment}: {agg}; {times} ({device}) → "
          f"appended to {baseline_out}")
    return agg


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--experiments", nargs="+",
                    default=["test_sample", "test_GATsSPG"])
    ap.add_argument("--check", action="store_true",
                    help="asset report only, no runs")
    ap.add_argument("-o", "--overrides", nargs="*", default=[],
                    help="dotted config overrides, e.g. data_dir=/x")
    ap.add_argument("--baseline-out", default=osp.join(REPO, "BASELINE.md"))
    ap.add_argument("--skip-sfm", action="store_true",
                    help="fail instead of building missing SfM annos")
    args = ap.parse_args(argv)

    os.chdir(REPO)
    if args.check:
        from onepose_tpu_torch.config import load_config

        all_ok = True
        for exp in args.experiments:
            cfg = load_config([f"+experiment={exp}"] + args.overrides)
            ok, present, missing = check_assets(cfg)
            state = "READY" if ok else "BLOCKED"
            print(f"[eval_real] {exp}: {state} "
                  f"({len(present)} present, {len(missing)} missing)")
            for m in missing:
                print(f"  - missing {m}")
            all_ok &= ok
        return 0 if all_ok else 1

    any_ran = False
    for exp in args.experiments:
        if run_experiment(exp, args.overrides, args.baseline_out,
                          skip_sfm=args.skip_sfm) is not None:
            any_ran = True
    return 0 if any_ran else 1


if __name__ == "__main__":
    raise SystemExit(main())
