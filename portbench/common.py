"""What every driver shares: the table of peaks, precision switches,
stage clocks, the device's description, and the check that no JAX module
was loaded.
"""
from __future__ import annotations

import contextlib
import os
import subprocess
import sys
import time

import torch

# One NVIDIA H100 SXM (data sheet, dense): TF32 tensor cores, the fastest
# rate from which the port builds an fp32-accurate product (3xTF32), and
# HBM3 bytes/s. Both assume the full 700 W power limit.
PEAK_FLOPS = 495e12
PEAK_BYTES = 3.35e12

# top-level module names that may not be loaded (compared whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "onepose_tpu")


@contextlib.contextmanager
def precision(tf32: bool):
    """fp32 products with TF32 off (the configurations' precision), or
    TF32 on for cuBLAS and cuDNN (the controls'), restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    torch.set_float32_matmul_precision("high" if tf32 else "highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved[0]
        torch.backends.cudnn.allow_tf32 = saved[1]
        torch.set_float32_matmul_precision(saved[2])


class StageClock:
    """Stage times at a call's boundaries, as the port's
    ``utils/profiling.StageClock`` places them: ``mark(name)`` after each
    stage (a first mark before the first), CUDA events on the current
    stream (device time, dispatch gaps included) or ``perf_counter`` off
    the card. ``totals()`` waits for the last event once, at the end."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self.marks: list = []

    def mark(self, name: str) -> None:
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append((name, ev))
        else:
            self.marks.append((name, time.perf_counter()))

    def totals(self) -> dict:
        """{stage: [ms of each call]}; a mark named "start" opens a
        call."""
        if self.cuda and self.marks:
            self.marks[-1][1].synchronize()
        out: dict = {}
        for (_, a), (name, b) in zip(self.marks, self.marks[1:]):
            if name == "start":
                continue
            ms = a.elapsed_time(b) if self.cuda else (b - a) * 1e3
            out.setdefault(name, []).append(ms)
        return out


def sync(device) -> None:
    """Wait for the card's queue (nothing to wait for off the card)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def device_info(n: int) -> dict:
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": n,
            "memory_peak_bytes": max(torch.cuda.max_memory_allocated(i)
                                     for i in range(n))}


def power_limit() -> str:
    """nvidia-smi's name and power limit of the first card, or ''."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0] if out.stdout else ""
    except (OSError, subprocess.SubprocessError):
        return ""


def load_average() -> str:
    try:
        return " ".join(f"{x:.2f}" for x in os.getloadavg())
    except OSError:
        return "unknown"


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})
