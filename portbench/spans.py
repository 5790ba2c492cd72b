"""The program's own spans in a profile, and what they tell of each layer.

The port names its work with ``onepose.<name>`` records
(``onepose_tpu_torch/utils/profiling.span``): a child inside its parent,
on the thread that runs the work, in the same trace as the CUDA activity.
:func:`table` reduces a profile's events to one entry a span name:

- ``calls``;
- ``host_us``, and ``self_us``: the host time less what its child spans
  cover;
- ``device_us``: the kernels launched inside it, by the profiler's
  correlation of each kernel with the host operation that launched it
  (``FunctionEvent.device_time_total``), not by overlap in time, since two
  streams overlap in the pose cell;
- ``launches``: kernel and graph launch calls on its thread inside it;
- ``waits``: host waits on its thread inside it (stream, device and
  event synchronises, and blocking copies);
- ``intervals``: (thread, start, end) of each call;
- ``parents``: the names of the spans directly around its calls on their
  thread (None: none).

:data:`QUANTITIES` are the per-layer numbers read from the table, each
None where its span is absent (a program without the spans). A profile of
every host thread is needed for the spans of other threads than the
loop's (:func:`profiled`).

    python3 portbench/spans.py --workload <name> --seed <n> [--seconds 10]

runs the cell's set-up and an untraced window, then its traced steps
without a profiler, under the harness's profiler (the loop's thread) and
under one of every thread, and prints one JSON line: the step medians, the
accepted trace metrics of each profile, the quantities of each profile of
every thread, and the span table of the last.
The benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import bisect
import contextlib
import json
import re
import sys
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import trace  # noqa: E402

PREFIX = "onepose."
WAIT = re.compile(r"^cuda(Stream|Device|Event)Synchronize$"
                  r"|^cudaMemcpy(?!.*Async)")


def table(events) -> dict:
    """{span name without the prefix: its entry} of a profile's events
    (``profile.events()``)."""
    from torch.autograd import DeviceType

    spans, runtime = [], defaultdict(list)
    for e in events:
        if e.device_type != DeviceType.CPU:
            continue
        s, t = e.time_range.start, e.time_range.end
        if e.name.startswith(PREFIX):
            spans.append((e.name[len(PREFIX):], e.thread, s, t,
                          e.device_time_total))
        elif trace.LAUNCH.search(e.name):
            runtime[e.thread].append((s, "launch"))
        elif WAIT.search(e.name):
            runtime[e.thread].append((s, "wait"))
    for calls in runtime.values():
        calls.sort()
    parent = _parents(spans)
    child_us = [0.0] * len(spans)
    for (_, _, s, t, _), p in zip(spans, parent):
        if p is not None:
            child_us[p] += t - s
    out = {}
    for (name, thread, s, t, dev), p, covered in zip(spans, parent,
                                                      child_us):
        calls = runtime.get(thread, [])
        inside = calls[bisect.bisect_left(calls, (s, "")):
                       bisect.bisect_right(calls, (t, "~"))]
        row = out.setdefault(name, {
            "calls": 0, "host_us": 0.0, "self_us": 0.0, "device_us": 0.0,
            "launches": 0, "waits": 0, "intervals": [], "parents": set()})
        row["calls"] += 1
        row["host_us"] += t - s
        row["self_us"] += t - s - covered
        row["device_us"] += dev
        row["launches"] += sum(kind == "launch" for _, kind in inside)
        row["waits"] += sum(kind == "wait" for _, kind in inside)
        row["intervals"].append((thread, s, t))
        row["parents"].add(None if p is None else spans[p][0])
    return out


def _parents(spans) -> list:
    """For each span, the index of the span directly around it on its
    thread (None: none)."""
    parent = [None] * len(spans)
    by_thread = defaultdict(list)
    for i, sp in enumerate(spans):
        by_thread[sp[1]].append(i)
    for order in by_thread.values():
        stack = []
        for i in sorted(order, key=lambda i: (spans[i][2], -spans[i][3])):
            while stack and spans[stack[-1]][3] <= spans[i][2]:
                stack.pop()
            parent[i] = stack[-1] if stack else None
            stack.append(i)
    return parent


def per_call(tab: dict, name: str, key: str, scale: float = 1.0):
    """``key`` of span ``name`` a call, times ``scale``; None without the
    span."""
    row = (tab or {}).get(name)
    if not row or not row["calls"]:
        return None
    return scale * row[key] / row["calls"]


def idle_holes(tr) -> list:
    """(start, end) of each stretch of the traced window in which nothing
    ran on the card, as ``trace.reduce`` finds them."""
    w0, w1 = tr.window
    merged = []
    for _, s, t in sorted((k for k in tr.kernels
                           if not k[0].startswith(PREFIX)),
                          key=lambda k: k[1]):
        s, t = max(s, w0), min(t, w1)
        if t <= s:
            continue
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t)
        else:
            merged.append([s, t])
    edges = [w0] + [x for iv in merged for x in iv] + [w1]
    return [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]


def idle_unnamed(tr, tab: dict):
    """%: the share of the window's idle time in stretches at whose middle
    no span of the program is open on any thread; None without spans."""
    if tr is None or not tab:
        return None
    open_ = sorted((s, t) for row in tab.values()
                   for _, s, t in row["intervals"])
    starts = [s for s, _ in open_]
    idle = unnamed = 0.0
    for s, t in idle_holes(tr):
        mid = 0.5 * (s + t)
        i = bisect.bisect_right(starts, mid)
        named = any(open_[j][1] >= mid for j in range(i))
        idle += t - s
        unnamed += 0.0 if named else t - s
    return 100.0 * unnamed / idle if idle > 0 else None


# per-layer quantities: name → reader of (trace, table); ms, calls or %
QUANTITIES = {
    "pnp_host_waits": lambda tr, tab: per_call(tab, "pnp", "waits"),
    "pnp_busy_ms": lambda tr, tab: per_call(tab, "pnp", "device_us", 1e-3),
    "encoder_ms": lambda tr, tab: per_call(tab, "extract.encoder",
                                           "device_us", 1e-3),
    "gnn_ms": lambda tr, tab: per_call(tab, "match.gnn", "device_us", 1e-3),
    "sinkhorn_ms": lambda tr, tab: per_call(tab, "superglue.sinkhorn",
                                            "device_us", 1e-3),
    "loader_wait_ms": lambda tr, tab: per_call(tab, "loader.wait",
                                               "host_us", 1e-3),
    "idle_unnamed": idle_unnamed,
}


@contextlib.contextmanager
def profiled():
    """``trace.profiled`` with the host operations of every thread
    recorded; the list it yields holds (the :class:`trace.Trace`,
    :func:`table`) once the block has ended."""
    import torch
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile

    holder = []
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 experimental_config=_ExperimentalConfig(
                     profile_all_threads=True)) as prof:
        with trace.span("window"):
            yield holder
            torch.cuda.synchronize()
    events = prof.events()
    holder.append((trace.reduce(events), table(events)))


# -- the command line ------------------------------------------------------
def _steps(cell) -> list:
    """The cell's traced batches or frames, as its ``profile`` runs them:
    → ms of each step."""
    import numpy as np

    if hasattr(cell, "run_batches"):
        _, _, starts, _, _ = cell.run_batches(
            "trace", cell.tr["trace_batches"], spans=True)
        return (np.diff(starts) * 1e3).tolist()
    return [x * 1e3 for x in cell.run_frames(
        "trace", cell.tr["trace_frames"], spans=True)]


def _accepted(tr, rec, shapes, work) -> dict:
    """The accepted per-layer metrics that a trace feeds."""
    from types import SimpleNamespace

    from portbench import manifest

    ctx = SimpleNamespace(window=rec, setup_s=0.0, trace=tr, shapes=shapes,
                          stages={})
    out = {}
    for m in work["per_layer"]:
        if m["source"] == "device_trace":
            value = manifest.reader(m["name"])(ctx)
            if value is not None:
                out[m["name"]] = value
    return out


def main(argv=None) -> int:
    import statistics

    import torch

    from portbench import common, manifest

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--rounds", type=int, default=2)
    args = p.parse_args(argv)
    work = manifest.cell(manifest.load(ROOT), args.workload)
    cell = manifest.driver(work["traffic_data"]).Cell(work, args.seed,
                                                      "cuda")
    out = {"workload": args.workload, "seed": args.seed,
           "device": common.power_limit()}
    with common.precision(tf32=False):
        cell.setup()
        rec = cell.window(args.seconds, False)
        out["window_step_ms_median"] = 1e3 * statistics.median(
            rec["step_s"])
        steps = defaultdict(list)
        for _ in range(args.rounds):
            steps["off"] += _steps(cell)
            with trace.profiled() as got:
                steps["loop_thread"] += _steps(cell)
            out.setdefault("loop_thread", []).append(dict(
                _accepted(got[0], rec, cell.shapes(), work),
                idle_gaps=got[0].top_gaps()))
            with profiled() as got:
                steps["all_threads"] += _steps(cell)
            tr, tab = got[0]
            out.setdefault("all_threads", []).append(dict(
                _accepted(tr, rec, cell.shapes(), work),
                idle_gaps=tr.top_gaps(),
                **{name: fn(tr, tab) for name, fn in QUANTITIES.items()}))
    out["step_ms_median"] = {k: statistics.median(v)
                             for k, v in steps.items()}
    out["steps"] = len(steps["off"])
    out["spans"] = {
        name: {"calls": row["calls"],
               "threads": len({th for th, _, _ in row["intervals"]}),
               "parents": sorted(str(x) for x in row["parents"]),
               **{k: row[k] / row["calls"] for k in (
                   "host_us", "self_us", "device_us", "launches",
                   "waits")},
               "host_ms_each": [round((t - s) / 1e3, 3)
                                for _, s, t in row["intervals"]]}
        for name, row in sorted(tab.items())}
    cell.release()
    torch.cuda.empty_cache()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
