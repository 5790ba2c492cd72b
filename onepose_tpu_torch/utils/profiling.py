"""Tracing and timing helpers.

Counterpart of ``onepose_tpu/utils/profiling.py``: :class:`Timer` is a
host copy of the original (named tick/tock totals with mean/total
reports); :func:`trace` records a ``torch.profiler`` trace of the CPU and,
on a card, of CUDA, and writes it to ``log_dir`` as a Chrome trace;
:func:`block_and_time` times one call until the card has finished it.
"""
from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict


class Timer:
    """Named tick/tock accumulator with mean/total reporting."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self._starts: Dict[str, float] = {}

    def tick(self, name: str = "default"):
        self._starts[name] = time.perf_counter()

    def tock(self, name: str = "default") -> float:
        dt = time.perf_counter() - self._starts.pop(name)
        self.totals[name] += dt
        self.counts[name] += 1
        return dt

    @contextlib.contextmanager
    def scope(self, name: str):
        self.tick(name)
        try:
            yield
        finally:
            self.tock(name)

    def summary(self) -> Dict[str, dict]:
        return {
            name: {
                "total_s": self.totals[name],
                "count": self.counts[name],
                "mean_ms": 1000.0 * self.totals[name]
                / max(self.counts[name], 1),
            }
            for name in self.totals
        }

    def report(self):
        for name, s in sorted(self.summary().items()):
            print(f"[timer] {name}: {s['mean_ms']:.2f} ms x {s['count']} "
                  f"(total {s['total_s']:.2f}s)")


@contextlib.contextmanager
def trace(log_dir: str, enabled: bool = True):
    """``torch.profiler`` over the block (CPU, and CUDA when a card is
    present); the trace goes to ``log_dir/trace.json`` (Chrome trace
    format: chrome://tracing or Perfetto) when enabled."""
    if not enabled:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def block_and_time(fn, *args, sync=True, **kwargs):
    """(seconds, output) of one call of ``fn``; with ``sync`` the clock
    stops after every CUDA device that holds a tensor of the output has
    finished its work."""
    import torch

    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    if sync:
        for index in sorted(_cuda_devices(out)):
            torch.cuda.synchronize(index)
    return time.perf_counter() - t0, out


def _cuda_devices(tree) -> set:
    """Indices of the CUDA devices holding tensors in ``tree`` (tensors,
    and lists, tuples and dicts of them)."""
    import torch

    if isinstance(tree, torch.Tensor):
        return {tree.device.index} if tree.is_cuda else set()
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return set().union(*(_cuda_devices(x) for x in tree)) if tree \
            else set()
    return set()
