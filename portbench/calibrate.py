"""The readings that a cell's limits are set from, on the card.

    python3 portbench/calibrate.py --workload <name> --seeds 1,2,3 --seconds 14 [--control]

For each seed, in one process: the cell's set-up and a window of
``--seconds`` (long enough to finish every batch or frame the check draws),
then the check's numbers for the program (sound runs: the lower readings)
and, with ``--control``, for the control: the plain reference run with
TF32 in the program's place, one precision below the configurations'
fp32 (the upper readings). One JSON line a seed. The benchmark's own runs
never run this.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def readings(work: dict, seed: int, seconds: float, control: bool,
             device="cuda") -> dict:
    import torch

    from portbench import common, manifest

    cell = manifest.driver(work["traffic_data"]).Cell(work, seed, device)
    with common.precision(tf32=False):
        cell.setup()
        rec = cell.window(seconds, False)
    cell.release()
    out = {"seed": seed, "frames": rec["frames"], "checked": len(cell.kept),
           "program": cell.check()}
    if control:
        out["control"] = cell.check(control=True)
    del cell
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--control", action="store_true")
    args = p.parse_args(argv)
    import torch

    from portbench import manifest

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    work = manifest.cell(manifest.load(ROOT), args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        row = readings(work, seed, args.seconds, args.control)
        row["s"] = time.perf_counter() - t0
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
