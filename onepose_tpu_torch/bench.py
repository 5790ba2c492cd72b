"""Benchmark: frame→pose throughput of the PyTorch port on one card.

Counterpart of the repository's ``bench.py``, at its protocol: batch 8,
512x512 crops, max_keypoints 1024, shape3d 2000 with 8 padded slots, leaf
8, 512 hypotheses, refine 5, and its preset: SuperPoint with a bf16
direct stem and a bf16 encoder (so the stem kernel does not run; the match
kernel does). The DB and the images are drawn from ``default_rng(0)`` as
``bench.py`` draws them; the weights are random from ``default_rng(0)``;
RANSAC's noise comes from a ``torch.Generator`` seeded 1.

    python -m onepose_tpu_torch.bench [--device cpu]

Protocol ``torch-cuda-events-r1`` (not comparable with ``bench.py``'s
chained-dispatch numbers): a call is the pipeline's step on inputs already
on the card, in its three public pieces (``PosePipeline.extract``,
``.match``, ``.pose``: the work of ``PosePipeline.__call__``). One
throwaway block, then 8 counted blocks of 20 calls, each block timed by
CUDA events around it (``utils/profiling.time_blocks``); the headline is
the median over blocks of frames/s, with its IQR. ``total_ms`` is the
median block's ms a call; the stages are CUDA events at the boundaries
of every call (``StageClock``), averaged over the calls of the block (or
the two blocks) that median takes, so they split that total up to the
gaps between calls.

FLOPs: ``torch.utils.flop_counter.FlopCounterMode`` over one call, stage by
stage. It cannot see the two hand-written kernels (launched through
ctypes), so their work is added by hand, as PERF.md §6 counts it: the
match kernel's one S = d0·d1ᵀ, ``2·B·N1·N2·D`` (8.39 GFLOP at the
protocol); the stem kernel does not run under the preset. ``mfu`` is against NVIDIA's dense bf16 peak of the H100 SXM,
989.4 TFLOP/s, as ``bench.py`` divides by a chip's bf16 peak; on another
device it is null. ``roofline`` has each stage's FLOPs, the least ms
they take at that peak, the measured ms and their ratio; ``bytes_mb``
and ``bound`` are null: eager torch has no cost analysis of the bytes a
stage moves.

The host-load gate: the 1-min load average over the host's cores must be
at most ``LOADAVG_IDLE_MAX``; the entry waits up to 8 minutes for it and
then exits with 3, unless ``BENCH_IGNORE_LOAD`` is set. (``bench.py``
reads the raw load average against 0.5, for its one-core host.)
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Optional

import numpy as np

REF_CPU_FPS = 0.625  # the reference's torch-CPU frames/s (BASELINE.md)
PROTOCOL = "torch-cuda-events-r1"
LOADAVG_IDLE_MAX = 0.5   # 1-min load average a core
GATE_WAITS, GATE_WAIT_S = 8, 60

BATCH = 8
H = W = 512
MAX_KPTS = 1024
SHAPE3D = 2000
NUM_LEAF = 8
NUM_HYPOTHESES = 512
REFINE_ITERS = 5
FOCAL = 460.0
N_ITERS, BLOCKS = 20, 8
PRESET = {"stem_dtype": "bfloat16", "stem": "direct",
          "compute_dtype": "bfloat16"}

# dense bf16 tensor-core FLOP/s by device name (NVIDIA's data sheet,
# H100 SXM)
PEAK_FLOPS = {"H100": 989.4e12}


def host_load() -> float:
    """The 1-min load average over the host's cores, -1 if unreadable."""
    try:
        with open("/proc/loadavg") as f:
            return float(f.read().split()[0]) / (os.cpu_count() or 1)
    except (OSError, ValueError, IndexError):
        return -1.0


def wait_for_idle() -> float:
    """The gate: the load a core once it is at most ``LOADAVG_IDLE_MAX``,
    after up to ``GATE_WAITS`` waits of a minute; exits with 3 if it stays
    above (``BENCH_IGNORE_LOAD`` skips the gate)."""
    load1 = host_load()
    if os.environ.get("BENCH_IGNORE_LOAD"):
        return load1
    for attempt in range(GATE_WAITS):
        if load1 <= LOADAVG_IDLE_MAX:
            return load1
        print(f"bench: 1-min load {load1:.2f} a core > {LOADAVG_IDLE_MAX}; "
              f"waiting {GATE_WAIT_S}s for it to drain "
              f"[{attempt + 1}/{GATE_WAITS}] (set BENCH_IGNORE_LOAD=1 to "
              "measure anyway)...", file=sys.stderr)
        time.sleep(GATE_WAIT_S)
        load1 = host_load()
    if load1 <= LOADAVG_IDLE_MAX:
        return load1
    print(f"bench: host still loaded ({load1:.2f} a core) after "
          f"{GATE_WAITS} min; refusing to emit a host-bound number",
          file=sys.stderr)
    sys.exit(3)


def entry_device(device, who: str):
    """``device`` as a torch device; a card that is missing raises."""
    import torch

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{who}: no CUDA device; pass --device cpu to "
                           "run on the CPU")
    return device


def batch_K(batch: int, hw: int, device):
    """The entries' intrinsics, ``FOCAL`` px on hw x hw, for ``batch``
    frames: [batch, 3, 3] float32 on ``device``."""
    import torch

    from onepose_tpu_torch.utils.synthetic import pinhole

    kmat = pinhole(hw, FOCAL).astype(np.float32)
    return torch.from_numpy(np.broadcast_to(kmat, (batch, 3, 3)).copy()).to(
        device)


def random_models(seed: int = 0, gats_config: Optional[dict] = None):
    """SuperPoint and GATsSPG with the JAX package's init schemes, random
    from ``default_rng(seed)``."""
    from onepose_tpu_torch.models import convert

    rng = np.random.default_rng(seed)
    return (convert.superpoint_from_jax(convert.init_superpoint_params(rng)),
            convert.gats_spg_from_jax(convert.init_gats_spg_params(
                rng, gats_config)))


def peak_of(table: dict, device) -> Optional[float]:
    """The table's rate for a CUDA ``device`` whose name holds a key."""
    import torch

    device = torch.device(device)
    if device.type != "cuda":
        return None
    name = torch.cuda.get_device_name(device)
    return next((v for k, v in table.items() if k in name), None)


def run(batch: int = BATCH, hw: int = H, max_keypoints: int = MAX_KPTS,
        shape3d: int = SHAPE3D, n_iters: int = N_ITERS, blocks: int = BLOCKS,
        gats_config: Optional[dict] = None, device="cuda",
        load1: Optional[float] = None) -> dict:
    """The benchmark's JSON line as a dict (module docstring). The shape
    arguments and ``gats_config`` (GATsSPG's depth) are for small runs;
    ``load1`` is the load the gate read (read now when None)."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from onepose_tpu_torch import pipeline
    from onepose_tpu_torch.eval_real import device_description
    from onepose_tpu_torch.utils.profiling import StageClock, time_blocks
    from onepose_tpu_torch.utils.synthetic import random_db

    device = entry_device(device, "bench")
    load1 = host_load() if load1 is None else load1
    rng = np.random.default_rng(0)
    sp_model, gats_model = random_models(0, gats_config)
    # bench.py's DB: a few padded slots, num_leaf to 3·num_leaf
    # observations a point
    db = random_db(rng, shape3d - 8, shape3d, NUM_LEAF,
                   obs=(NUM_LEAF, 3 * NUM_LEAF))
    pipe = pipeline.PosePipeline(
        sp_model, gats_model, db,
        sp_config=dict(PRESET, max_keypoints=max_keypoints),
        gats_config=gats_config, num_hypotheses=NUM_HYPOTHESES,
        refine_iters=REFINE_ITERS, device=device)
    images = torch.from_numpy(rng.uniform(0, 1, (batch, hw, hw, 1)).astype(
        np.float32)).to(device)
    Ks = batch_K(batch, hw, device)
    gen = torch.Generator(device=device).manual_seed(1)
    clocks = []

    @torch.no_grad()
    def call():
        clock = StageClock(device)
        clocks.append(clock)
        clock.mark("start")
        det = pipe.extract(images)
        clock.mark("extract")
        match = pipe.match(det)
        clock.mark("match")
        pipe.pose(det, match, Ks, generator=gen)
        clock.mark("pnp")

    ms_samples = time_blocks(call, n_iters, blocks, device)
    total_ms = float(np.median(ms_samples))
    fps_samples = [batch / ms * 1000 for ms in ms_samples]
    fps = float(np.median(fps_samples))
    q25, q75 = np.percentile(fps_samples, [25, 75])
    # each stage's mean over the calls of the block(s) whose ms the median
    # takes, so that the stages split that total (reading a clock waits
    # for the card)
    order = np.argsort(ms_samples)
    middle = order[(blocks - 1) // 2: blocks // 2 + 1] + 1   # 0: throwaway
    splits = [c.split() for b in middle
              for c in clocks[b * n_iters:(b + 1) * n_iters]]
    stage_ms = {k: float(np.mean([s[k] for s in splits]))
                for k in ("extract", "match", "pnp")}
    stages = {"extract_ms": round(stage_ms["extract"], 2),
              "match_ms": round(stage_ms["match"], 2),
              "pnp_ms": round(stage_ms["pnp"], 2),
              "total_ms": round(total_ms, 2)}

    # FLOPs a call, stage by stage, the kernels' added by hand
    with torch.no_grad():
        counters = {k: FlopCounterMode(display=False)
                    for k in ("extract", "match", "pnp")}
        with counters["extract"]:
            det = pipe.extract(images)
        with counters["match"]:
            match = pipe.match(det)
        with counters["pnp"]:
            pipe.pose(det, match, Ks, generator=gen)
    flops = {k: float(c.get_total_flops()) for k, c in counters.items()}
    # the match kernel's S = d0·d1ᵀ
    flops["match"] += 2.0 * batch * max_keypoints * len(db.keypoints3d) * 256
    flops_per_batch = sum(flops.values())
    tflops = flops_per_batch * fps / batch / 1e12
    peak = peak_of(PEAK_FLOPS, device)
    mfu = roofline = None
    if peak is not None:
        mfu = tflops * 1e12 / peak
        roofline = {}
        for name in ("extract", "match", "pnp"):
            lo = flops[name] / peak * 1e3
            roofline[name] = {
                "flops_g": round(flops[name] / 1e9, 1), "bytes_mb": None,
                "bound": None, "bytes_bound_frac": None,
                "min_ms": round(lo, 3),
                "measured_ms": round(stage_ms[name], 2),
                "roofline_eff": round(lo / max(stage_ms[name], 1e-9), 4)}
        roofline["total_min_ms"] = round(flops_per_batch / peak * 1e3, 3)

    return {
        "metric": "frames_per_sec_per_chip_frame_to_pose",
        "value": round(fps, 2),
        "unit": "frames/s",
        "vs_baseline": round(fps / REF_CPU_FPS, 2),
        "iqr": [round(float(q25), 2), round(float(q75), 2)],
        "blocks": len(fps_samples),
        "stages": stages,
        "mfu": round(mfu, 6) if mfu is not None else None,
        "tflops_per_sec": round(tflops, 4),
        "roofline": roofline,
        "protocol": PROTOCOL,
        "stem_dtype": pipe.sp_config["stem_dtype"],
        "stem": pipe.sp_config["stem"],
        "compute_dtype": pipe.sp_config["compute_dtype"],
        "loadavg_1min": round(load1, 2),
        "host_idle": bool(0.0 <= load1 <= LOADAVG_IDLE_MAX),
        "device": device_description(device),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu for a CPU run)")
    args = ap.parse_args(argv)
    load1 = wait_for_idle()
    print(json.dumps(run(device=args.device, load1=load1)))


if __name__ == "__main__":
    main()
