"""Run one cell of the benchmark once.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

(or ``python -m portbench.run ...``), from the root of a checkout. The
cell's driver (named by its traffic file) makes its inputs and weights
from the seed, builds the program and warms up every shape it uses (the
set-up), runs the closed loop for ``--seconds``, reads the peak memory,
frees the program, and holds what the timed path produced to the plain
reference (``portbench/judge.py``). The last line of standard output is
one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics``
(the cell's end-to-end metrics, or with ``--trace 1`` its per-layer
metrics, each read by ``portbench/metrics/<name>.py``), ``device``, with
``--trace 1`` ``breakdown``, and last ``check``: each number compared
with its limit. Without a card, with fewer cards than the cell asks for,
or with a JAX module loaded once the window has closed, it prints no
result and exits 2.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
# every cache the program or its libraries keep stays in the checkout
os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                      str(ROOT / "build" / "torch_extensions"))
os.environ["USE_FLAX"] = "0"


def parse(argv=None):
    p = argparse.ArgumentParser(description="Run one benchmark cell once.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def say(*args) -> None:
    print(*args, file=sys.stderr, flush=True)


def run_cell(work: dict, seed: int, seconds: float, traced: bool, device,
             t0: float = None) -> dict:
    """One run of the cell ``work`` (``manifest.cell``) on ``device``:
    the result object, ``check`` last. Used by the command line (on the
    card) and by the tests (on the CPU, at small sizes)."""
    import numpy as np
    import torch

    from portbench import common, judge, manifest

    t0 = T0 if t0 is None else t0
    torch.set_num_threads(2)
    cell = manifest.driver(work["traffic_data"]).Cell(work, seed, device)
    cell.marks.append(("imports", time.perf_counter()))
    with common.precision(tf32=False):
        cell.setup()
        setup_s = time.perf_counter() - t0
        ends = [t0] + [t for _, t in cell.marks]
        split = ", ".join(f"{name} {b - a:.3f}" for (name, _), a, b in zip(
            cell.marks, ends, ends[1:]))
        say(f"set-up {setup_s:.3f} s ({split}); {cell.describe()}")
        rec = cell.window(seconds, traced)
        q = np.percentile(rec["step_s"], [5, 25, 50, 75, 95]) * 1e3
        say(f"window {rec['wall_s']:.3f} s, {rec['frames']} frames; ms a "
            f"step at 5/25/50/75/95%: {np.round(q, 2).tolist()}")
        slow = np.argsort(rec["step_s"])[::-1][:5]
        say("longest steps (index: ms): " + ", ".join(
            f"{i}: {rec['step_s'][i] * 1e3:.1f}" for i in slow))
        if rec.get("pnp_host_s"):
            h = np.asarray(rec["pnp_host_s"]) * 1e3
            say(f"PnP on the host, ms: median {np.median(h):.1f}, longest "
                f"{np.round(np.sort(h)[::-1][:5], 1).tolist()}")
        tr = cell.profile() if traced else None
    on_card = torch.device(device).type == "cuda"
    dev = common.device_info(work["chips"]) if on_card else {
        "platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    if tr is not None:
        dev["busy_s"] = tr.busy_us / 1e6
        dev["window_s"] = tr.window_us / 1e6
    shapes = cell.shapes()
    cell.release()
    if on_card:
        torch.cuda.empty_cache()
    numbers = cell.check()
    say("readings " + json.dumps(numbers))
    correct, table = judge.verdict(numbers, work["config_data"]["limits"])

    ctx = SimpleNamespace(window=rec, setup_s=setup_s, trace=tr,
                          shapes=shapes, stages=rec.get("stages", {}))
    metrics = {}
    for m in work["per_layer" if traced else "end_to_end"]:
        value = manifest.reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": correct, "attempted": rec["frames"], "failed": 0,
              "metrics": metrics, "device": dev}
    if tr is not None:
        result["breakdown"] = {
            "device_ops": [list(x) for x in tr.top_kernels()],
            "idle_gaps": [list(x) for x in tr.top_gaps()]}
    result["check"] = table
    return result


def main(argv=None) -> int:
    args = parse(argv)
    import torch

    from portbench import common, manifest

    work = manifest.cell(manifest.load(ROOT), args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < work["chips"]:
        say(f"portbench: {work['name']} needs {work['chips']} CUDA "
            f"device(s); this machine has "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    say(f"portbench {work['name']} seed {args.seed}: load "
        f"{common.load_average()}")
    result = run_cell(work, args.seed, args.seconds, bool(args.trace), "cuda")
    say(f"card: {common.power_limit()}")
    found = common.forbidden_modules()
    if found:
        say(f"portbench: forbidden modules loaded: {found}")
        return 2
    for name, row in result["check"].items():
        say(f"check {name} {row['value']} limit {row['limit']}")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
