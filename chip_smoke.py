#!/usr/bin/env python
"""Smoke run of the PyTorch port (onepose_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py [--out DIR]

Builds the hand-written CUDA kernels from ``onepose_tpu_torch/csrc`` at
first use (into ``build/onepose_tpu_torch/``, counted in this run's time)
and runs nineteen phases; weights and inputs come from fixed seeds.

  1. card name and power limit (nvidia-smi);
  2. kernel build time, ptxas register use, and the count of tensor-core
     instructions (HGMMA) in each kernel's own SASS, which must not be 0
     for the stem or the match kernel;
  3. stem kernel vs its plain PyTorch version at [8,512,512,1] and at
     [2,64,128,1], max|Δ| < 1e-4·max(|ref|, 1), and both times; beside
     it the kernel's, plain fp32's and cuDNN-with-TF32's error against an
     fp64 reference, and the kernel's bound;
  4. match kernel vs its plain version at [8,1024,256]x[8,2000,256] and
     ragged [2,1000,256]x[2,1990,256], each on random unit descriptors and
     on peaked ones (DB slots j < N1 hold noisy copies of query j), under
     ``match.match_gate``: max conf within 3e-5 of plain, relative, and
     indices equal except in relative near-ties;
  5. known-pose RANSAC-PnP on the card (the scene of
     tests/test_pipeline.py::test_poses_from_matches_synthetic);
  6. card vs CPU run of the whole pipeline at B=2, 128x128, K=256,
     shape3d=256, leaf 4, with injected RANSAC noise, on a scene whose
     3D points are planted so that the matches the model makes are
     consistent with a known pose per frame;
  7. the whole pipeline at the protocol shape (B=8, 512x512, K=1024,
     shape3d=2000, leaf 8, 512 hypotheses, refine 5): finite outputs,
     both kernels launched by that run, per-stage times;
  8. multi-object serving at the same shape with 8 resident objects:
     a mixed batch (one request per object, injected noise) equal to a
     PosePipeline per object and recovering each object's planted pose;
     the match kernel on the per-element DBs under ``match_gate``; the
     uniform fast path equal to the mixed step; the bf16 catalog close to
     fp32; ``infer_many`` over 24 requests equal to ``infer_batch``; the
     async path answering full and partial batches; serve-step times;
  9. the feature-matching detector at full width (SuperGlue outdoor shape,
     15 DB views of 512x512, K=1024, a 1440x1920 query): the stem kernel
     vs plain at [15,512,512,1] and [1,1440,1920,1]; a planted similarity
     recovered by ``ransac_similarity``; a planted detection (one view
     pasted into the frame) recovered within 1 px; ``detect_bbox`` on the
     card vs the CPU under ``superglue.match_gate``, and the card's
     SuperGlue with TF32 products refused by the same gate; detect times
     split into extract, SuperGlue, RANSAC;
 10. the tracked video path on a textured plane with known poses (26
     frames of 512x512, K as phase 7's, 1024 keypoint slots of D=256, 400
     of them real): (a) BATracker at its defaults, every tracked frame
     within 1.5 cm / 1.5 deg of the truth, card vs CPU over frames 1-3
     with the same injected noise (LK points within 1e-3 px where both
     track, matches and assignments equal, poses within 1e-4), uint8
     frames bit-identical to float32 ones on the card, ms a frame of
     ``track()`` split by CUDA events at the tracker's stage marks, one
     frame profiled; (b) the demo's path, ``PosePipeline`` at batch 1
     (phase 7's model and DB shape) then ``inference_demo.apply_tracking``,
     the DB planted on the plane for frame 0's matches: both kernels
     launched once a frame, frame 0's PnP pose within phase 8's bound,
     card vs CPU over frames 0-3 (PnP inliers equal, PnP poses within
     0.05 deg / 0.05 cm, sources equal, tracked poses within phase 8's
     0.5 deg / 0.5 cm, every NN flip a near-tie), ms a frame split into
     pipeline and tracking; the stem at [1,512,512,1] and the match at
     [1,1024,256]x[1,2000,256] against their plain versions;
 11. SfM on the card: (a) ``runner.run_sfm`` from images, at full width
     (60 views of 512x512 along an arc of a ring around a textured
     plane, known poses; SuperPoint with a budget of 4096 and nms radius
     3 in batches of 16; SuperGlue at 18 layers, 100 Sinkhorn
     iterations, threshold 0.7, planted on the views' descriptors; covis
     10): the stem kernel vs plain at [16,512,512,1] and launched once a
     batch, the native track builder loaded, the HDF5, model, database
     and anno files in the JAX layout, ``load_object_db`` reading the
     port's DB and ``PosePipeline`` posing a frame on it, one pair card
     vs CPU (keypoints by position, descriptors and scores within 1e-5,
     SuperGlue under ``superglue.match_gate``), ms a stage, peak memory,
     the match stage's busy share; (b) the reference scale from features
     (180 images, 4,000 points, ``utils/synthetic.ring_features``):
     triangulation within 2 mm median of the truth, postprocess at most
     2,500 points, global BA (max_obs 65536) lowering its cost and
     repeating its bits over two runs, peak memory, ms a stage. Their
     files go to ``build/chip_smoke_sfm/``;
 12. training at ``configs/experiment/train_GATsSPG.yaml``'s width
     (GATsSPG D=256, 4 heads, 4 x [GATs, self, cross]; batch 8, shape2d
     1000, shape3d 2000, leaf 8; Adam 1e-3, clip 0.5, accumulation 2) on
     the DB that 11a built, merged by ``merge_anno``: (a) the gather
     path's batch on the card equal to the host path's dense batch, and
     its leaves sampled on the card equal to the CPU's from the same
     uniforms; (b) one step at batch 1 on the card and on the CPU from
     the same parameters, each against an fp64 reference: the card's loss
     within twice the CPU's fp32 error, its gradients within 5e-2 of their
     largest entry (fp32 reads 2e-3 to 1e-2 on this model; the card with
     TF32 products allowed must exceed it), the parameters within Adam's
     bound of the two devices' disagreement; (c)
     micro-steps timed by CUDA events on one fixed batch (the loss falls),
     samples/s, peak memory, one step profiled; (d) the train entry for an
     epoch, its validation through ``PosePipeline`` launching both
     kernels, the checkpoint read by ``load_gats_spg`` and a batch posed
     with it;
 13. SuperPoint's bf16 preset (the eval entries' default): extract ms at
     [8,512,512,1] in fp32 (the stem kernel) and in the preset (no stem
     kernel), the preset's keypoint Jaccard against fp32, and
     ``scripts/stem_dtype_gate.py``'s rule over planted worlds with the
     RANSAC noise injected: the preset's pose delta against fp32 within
     twice fp32's own key-to-key noise floor (two noise draws; medians and
     95th percentiles, floors at least 0.05 and 0.1 deg) and no more
     cmd1/3/5 bucket flips than that floor makes;
 14. several cards: a world of max(2, cards) ranks, one card each (they
     share a card over gloo where there are fewer; NCCL otherwise), spawned
     by ``parallel/launch.py::run_local``; it prints the world, the backend
     and the card count. Against one rank on the same inputs: (a) the
     pipeline at phase 7's shape (batch 8 split over the world, match
     threshold 0, the DB planted for frame 0), (b) serving 8 planted
     objects over a (world/2, 2) mesh (the catalog split over the model
     axis) and ``MultiHostPoseServer.serve_forever`` over two batches,
     (c) SfM extraction and matching of 16 of 11a's images and 16 pairs
     (SuperGlue planted on their descriptors): outputs bit-equal to one
     rank's on the same rows, poses within phase 8's 1e-4 of one rank's
     batch of 8 (its matches differ where one rank's own calls on those
     rows differ: cuBLAS takes other paths at other row counts), the
     planted poses recovered, the HDF5 files equal by keypoint
     position; (d) the train entry for an epoch of phase 12's data at
     ``n_devices`` = the world: rank 0's checkpoint read by
     ``load_gats_spg``, the losses within 1e-5 of phase 12 (d)'s; (e)
     GATsSPG in bf16 at phase 7's width on a planted world against fp32:
     match Jaccard, the descriptors' RMS gap, ms of the match stage. Stage
     times come from ``utils/profiling.Timer``;
 15. the token-sharded model axis: the same world on a (world/2, 2) mesh,
     GATsSPG's 3D tokens split over its model axis; first the collectives
     under autograd probed on CUDA tensors (none staged through the
     host), then against one rank on the same rows: (a) the pipeline at
     phase 7's shape, the DB planted for frame 0 (each rank holds 1000 of
     the 2000 token rows): matches equal outside relative near-ties
     (``match_gate``'s rule on one rank's conf), success equal, poses
     within 1e-4, frame 0's planted pose within phase 8's bound; (b) the
     matcher at tests/test_mp4.py's [2,256] x [2,4096] tokens, leaf 8, 4
     blocks: matches as in (a), scores within rtol 1e-4, atol 1e-6, and
     the match kernel on the ranks' gathered descriptors against its
     plain version under ``match_gate``, with both times and the bound;
     (c) the dense train step at the JAX dryrun's protocol shape (b=8,
     n1=1000, n2=2000, leaf 8, 4 blocks): the first step's gradients
     within rtol 1e-3 and atol 1e-3·max|g|, two steps' losses within
     rtol 1e-4, every rank's parameters after them bit-equal; ms a
     pipeline batch and a train step, and peak memory, a rank and one
     rank;
 16. PnP's stages: ``ransac_pnp``'s cumulative ``profile_prefix`` stages
     (solve, score, lo, refit, full) at scripts/profile_pnp.py's protocol
     shape (B=8, N=1024, 35% inliers, 512 hypotheses, LO 64, refine 5),
     one injected noise for all: median ms of 10 calls (CUDA events around
     the call, dispatch included), busy ms, device ops and host waits of
     one profiled call, each stage's increment; the full prefix bit-equal
     to ``profile_prefix=None``, each prefix on the card against the CPU
     on a small scene (B=2, N=128; poses within 1e-4, inliers equal), the
     full solve's pose within phase 5's bound. Measurement calls: no
     kernel runs in PnP;
 17. the real-assets eval entry: ``onepose_tpu_torch.eval_real.main``
     end to end on a synthetic capture in the dataset layout under
     ``build/chip_smoke_eval/`` (48 ring views of 512x512: 32 to SfM, 16
     evaluated; the object and sequence names of configs/datasets/
     *_sample.txt), the weights written as the reference's checkpoint
     files (SuperPoint and GATsSPG at full width, random from seeds;
     SuperGlue planted as in 11a), SfM not skipped (at most 2000 points,
     test_sample's shape3d, so the DB of a larger object is padded to a
     multiple of 8 above its points): rc 0, cmd1/3/5 in [0, 1] in the baseline
     appended under ``--out``, the per-sequence report written, the stem
     kernel launched by SfM and the match kernel by inference (the bf16
     preset skips the stem there), ``--check`` on a missing data_dir
     returning 1; each stage's seconds;
 18. the measurement entries, in this process through each entry's
     ``run``: ``onepose_tpu_torch.bench`` at its protocol in full (the bf16
     preset: the match kernel only; stages summing to the total within 5%,
     the total within 2x of phase 7's, mfu finite), ``profile_stages`` in
     full (its nine rows), ``bench_serving`` at 81 objects (catalog about
     1,494 MB) and ``--latency`` at 8 objects over 48 requests a point,
     ``bench_tracker`` at 12 frames with ``--breakdown`` (errors within
     phase 10a's bounds), ``bench_train`` at its defaults, each line's
     keys those of the JAX-side file's and every number finite; then
     ``demo_pipeline``'s chain on a raw capture of the textured plane (40
     annotate views, 8 test frames, mp4v video): parse, SfM (the stem
     kernel), the demo (the match kernel), its DB and video written. The
     runs cut from the defaults are listed under ``reduced``;
 19. rows batched together: phase 7's models, DB and frames, the first 4
     frames extracted and matched at batch 4 and inside batch 8, every
     aten op's (and kernel's) outputs fingerprinted: the first op whose
     4-row outputs differ from the 8-row call's first half, and the gap
     between the final outputs; the 8-row call repeating its bits.

``--phases 2,11a,12,14,15`` runs a subset (phase 1 always; 14 needs 11a
and 12) and prints neither the kernels line nor the final line. Each main
path (phases 7, 8, 9, 10b, 11a, 12d, 14's (a)-(c), 15's (a)-(b) on
every rank, 17, and 18's bench, profile_stages, serving and demo chain)
is driven once with the launch counts set to 0 just
before it and read just after; the kernels line sums those counts, every
rank's included. Every
phase's launches, comparisons included, are in the JSON. Detailed
results go to ``DIR/chip_smoke.json`` and ``DIR/profile.txt`` (default
``build/chip_smoke``). Any failed phase makes the script exit 1 without
the kernels line and the final line. The last line of a passing
run is ``{"ok": true, "device": {...}}``. There is no CPU path: without a
CUDA device the script exits 1.
"""
from __future__ import annotations

import argparse
import copy
import dataclasses
import glob
import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

STEM_TOL = 1e-4        # relative to max(|ref|, 1): the fused-stem gate's
# NVIDIA H100 SXM peaks (data sheet, dense): TF32 tensor cores, fp32 FMA on
# the CUDA cores, HBM bytes/s
PEAK_TF32, PEAK_FP32, PEAK_BYTES = 495e12, 67e12, 3.35e12
POSE_DEG, POSE_CM = 0.5, 0.5
PARITY_DEG, PARITY_CM = 0.05, 0.05   # card vs CPU pose agreement

B, H, W, K_PTS, SHAPE3D, LEAF, HYP = 8, 512, 512, 1024, 2000, 8, 512
KMAT = np.array([[460.0, 0, W / 2], [0, 460.0, H / 2], [0, 0, 1]],
                np.float32)
N_OBJECTS = 8                      # resident objects of phase 8
N_VIEWS, FRAME_HW = 15, (1440, 1920)   # phase 9: DB views, query frame
PASTE_XY, PASTED_VIEW = (648, 464), 7  # multiples of 8
# phase 10: a keyframe, 6 warm-up frames, 18 timed, 1 profiled; the CPU
# side of each card-vs-CPU comparison runs the first 4 frames
TRACK_FRAMES, TRACK_WARMUP, TRACK_TIMED, CPU_FRAMES = 26, 6, 18, 4
TRACK_HYP = 256                    # BATracker's default hypotheses
TRACK_DEG, TRACK_CM = 1.5, 1.5     # tests/test_tracker.py's bound
TRACK_PX = 1e-3                    # card vs CPU LK points, px
TRACK_POSE = 1e-4                  # card vs CPU tracked pose, per entry
# 10b, card vs CPU tracked poses once a step decided differently: twice
# the largest reading on an H100 (0.063-0.072 deg, 0.017-0.028 cm)
DEMO_DIVERGED_DEG, DEMO_DIVERGED_CM = 0.15, 0.06
# phase 11a: images of a ring capture, SfM's extraction batch and budget
SFM_IMAGES, SFM_BATCH, SFM_KPTS = 60, 16, 4096
# phase 11's files (about 1 GB), apart from the results directory
SFM_WORK = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "chip_smoke_sfm")
# phase 12 trains the configuration of configs/experiment/train_GATsSPG.yaml
# (tests/test_torch_train.py holds these values equal to the file, which
# the card's machine cannot parse: it has no yaml)
TRAIN_YAML = {
    "model": {"lr": 1e-3, "weight_decay": 0.0, "milestones": [5, 10, 15, 20],
              "gamma": 0.5, "descriptor_dim": 256, "match_threshold": 0.2,
              "scale_factor": 0.07, "include_self": True,
              "with_linear_transform": False, "additional": False},
    "trainer": {"gradient_clip_val": 0.5, "accumulate_grad_batches": 2},
    "datamodule": {"batch_size": 8, "num_leaf": 8, "shape2d": 1000,
                   "shape3d": 2000, "assign_pad_val": 0,
                   "device_resident": True},
}
TRAIN_ITEMS, VAL_ITEMS = 16, 8     # 12: frames of 11a's capture per split
TRAIN_WARMUP, TRAIN_TIMED = 6, 24  # 12c: micro-steps
# 12b: the card's gradients against fp64, of their largest entry: above
# fp32's 2e-3 to 1e-2 on this model (train_card_vs_cpu says why)
TRAIN_GRAD_GATE = 5e-2
# phase 16: scripts/profile_pnp.py's protocol shape
PNP_B, PNP_N = 8, 1024
# phase 17: the synthetic capture's object and sequences, those that
# configs/datasets/{sfm,eval}_sample.txt name; views along the ring, every
# third held out from SfM for evaluation (32 SfM, 16 evaluated)
EVAL_OBJECT, SFM_SEQ, EVAL_SEQ = ("0501-matchafranzzi-box", "matchafranzzi-1",
                                  "matchafranzzi-4")
EVAL_VIEWS = 48
EVAL_WORK = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                         "chip_smoke_eval")
# phase 18: the entries' files (the demo's capture, bench_train's dataset),
# the demo capture's object, its annotate views and test frames, and the
# key sets of the entries' JSON lines (tests/test_torch_bench_entries.py
# holds them to the JAX-side files')
ENTRIES_WORK = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "build", "chip_smoke_entries")
DEMO_OBJECT, DEMO_VIEWS = "0600-plane-box", (40, 8)
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "iqr", "blocks",
              "stages", "mfu", "tflops_per_sec", "roofline", "protocol",
              "stem_dtype", "stem", "compute_dtype", "loadavg_1min",
              "host_idle", "device"}
PROFILE_ROWS = ["sp stem (conv1a+1b+pool)", "sp dense_heads fp32",
                "sp dense_heads bf16", "sp extract (dense+nms+select)",
                "gats matcher fp32", "gats matcher bf16",
                "pnp 512 hypotheses", "pnp 256 hypotheses", "FULL pipeline"]
SERVING_KEYS = {"serve_ms_per_batch8", "req_per_s", "catalog_mb",
                "n_objects", "uniform", "device"}
SERVING_LATENCY_KEYS = {"metric", "n_objects", "batch_size",
                        "assembly_timeout_ms", "sync_batch_wall_ms",
                        "capacity_req_per_s", "points", "device"}
TRACKER_KEYS = {"track_ms_median", "track_ms_p90", "frames",
                "r_err_deg_max", "t_err_cm_max", "breakdown", "device"}
TRAIN_KEYS = {"light+host-leaf-sampling", "light+device-leaf-sampling",
              "+ staged uploads", "step-only ceiling", "device"}
# phase 19: the most match slots of the first 4 frames (4·K_PTS) that may
# differ between batch 4 and batch 8, four times the 20 measured on an H100
BATCH_ROWS_MAX_SLOTS = 80
# phase 13: the bf16 gate's seeds, frames a seed, their size and keypoints,
# and the DB points each frame plants
GATE_SEEDS, GATE_FRAMES, GATE_HW, GATE_KPTS, GATE_POINTS = 4, 4, 256, 512, 96


def log(*args):
    print(*args, flush=True)


def cuda_ms(fn, iters=20, warmup=3) -> float:
    """Mean device time of ``fn`` over ``iters`` calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_profile(fn):
    """Profile one call of ``fn``: kernels (and copies) run on the card,
    the union of their device intervals (busy ms), the window from the
    first start to the last end, the host's waits on the card (CUDA
    runtime ``*Synchronize`` calls, the profiler's closing one included)
    and the top of the kernel table. The profiler slows the host, so the
    busy share is a lower bound."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    busy, (s0, e0) = 0.0, spans[0]
    for s, e in spans[1:]:
        if s > e0:
            busy += e0 - s0
            s0, e0 = s, e
        else:
            e0 = max(e0, e)
    busy += e0 - s0
    window = spans[-1][1] - spans[0][0]
    syncs = sum(1 for e in prof.events() if "Synchronize" in e.name)
    stats = {"device_ops": len(spans), "busy_ms": busy / 1e3,
             "window_ms": window / 1e3, "busy_share": busy / window,
             "host_syncs": syncs}
    table = prof.key_averages().table(sort_by="self_device_time_total",
                                      row_limit=15)
    return stats, table


class Smoke:
    def __init__(self, out_dir: str):
        self.out_dir = out_dir
        self.failures = []
        self.results = {}
        self.dev = torch.device("cuda")

    def check(self, ok: bool, msg: str):
        log(("PASS " if ok else "FAIL ") + msg)
        if not ok:
            self.failures.append(msg)

    def phase(self, name, fn):
        log(f"== {name}")
        t0 = time.perf_counter()
        before = launch_counts()
        try:
            fn()
        except Exception:  # report every phase, then fail the run
            traceback.print_exc()
            self.failures.append(f"{name}: exception")
        after = launch_counts()
        self.results.setdefault("launches_by_phase", {})[name] = {
            k: after[k] - before[k] for k in after}
        seconds = time.perf_counter() - t0
        self.results.setdefault("phase_s", {})[name] = seconds
        log(f"   ({seconds:.1f} s)")

    def path_launches(self, path, fn, kernels=("stem", "match")):
        """Drive a main path: every launch count set to 0 just before
        ``fn``, read just after (then restored, so that the per-phase
        counts stay whole). Fails the run if a kernel of the path was not
        launched."""
        saved = launch_counts()
        set_launch_counts({k: 0 for k in saved})
        try:
            out = fn()
            torch.cuda.synchronize()
        finally:
            got = launch_counts()
            set_launch_counts({k: saved[k] + got[k] for k in saved})
        self.results.setdefault("launches", {})[path] = got
        self.check(all(got[k] > 0 for k in kernels),
                   f"{path} path launched its kernels: {got}")
        return out

    # -- 1 ----------------------------------------------------------------
    def card(self):
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        self.smi = smi.stdout.strip().splitlines()[0] if smi.stdout else "?"
        self.results["nvidia_smi"] = self.smi
        self.results["device"] = torch.cuda.get_device_name(0)
        self.results["torch"] = torch.__version__
        self.results["cuda"] = torch.version.cuda
        log(f"nvidia-smi: {self.smi}")
        log(f"device: {self.results['device']}  torch {torch.__version__} "
            f"cuda {torch.version.cuda}")

    # -- 2 ----------------------------------------------------------------
    def build(self):
        from onepose_tpu_torch.ops import _kernels

        t0 = time.perf_counter()
        path = _kernels.build()
        _kernels.library()
        self.results["build_s"] = time.perf_counter() - t0
        log(f"kernel build: {self.results['build_s']:.2f} s -> {path}")
        for line in path.with_name(path.name + ".log").read_text().splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                log("   ptxas: " + line.strip())
        # tensor-core instructions per kernel: HGMMA is wgmma's SASS
        sass = subprocess.run(
            [os.path.join(_kernels.cuda_home(), "bin", "cuobjdump"), "-sass",
             str(path)], capture_output=True, text=True, timeout=300).stdout
        hgmma = hgmma_by_function(sass)
        self.results["sass_hgmma"] = hgmma
        for kernel in ("stem_kernel", "match_pass"):
            n = sum(v for k, v in hgmma.items() if kernel in k)
            self.check(n > 0,
                       f"{kernel}: {n} HGMMA instructions in its own SASS")

    # -- 3 ----------------------------------------------------------------
    def stem(self):
        rng = np.random.default_rng(0)
        for shape in ((B, H, W, 1), (2, 64, 128, 1)):
            self.stem_case(shape, rng)

    def stem_case(self, shape, rng):
        """The stem kernel vs plain at ``shape`` (random weights), errors
        against fp64, both times and the bound, into results["stem"]."""
        from onepose_tpu_torch.ops import stem
        from onepose_tpu_torch.ops.precision import pin_fp32

        img = torch.from_numpy(
            rng.uniform(0, 1, shape).astype(np.float32)).to(self.dev)
        w1a = torch.from_numpy(rng.normal(size=(3, 3, 1, 64)).astype(
            np.float32) * np.float32(np.sqrt(2 / 9))).to(self.dev)
        w1b = torch.from_numpy(rng.normal(size=(3, 3, 64, 64)).astype(
            np.float32) * np.float32(np.sqrt(2 / 576))).to(self.dev)
        b1a = torch.from_numpy(
            rng.normal(size=64).astype(np.float32) * 0.1).to(self.dev)
        b1b = torch.from_numpy(
            rng.normal(size=64).astype(np.float32) * 0.1).to(self.dev)
        args = (img, w1a, b1a, w1b, b1b)
        got = stem.fused_stem(*args)
        ref = stem.stem_reference(*args)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        gate = STEM_TOL * max(float(ref.abs().max()), 1.0)
        ref64 = stem.stem_reference(*(a.double() for a in args))
        try:
            torch.backends.cudnn.allow_tf32 = True
            tf32 = stem.stem_reference(*args)
        finally:
            pin_fp32()
        errs64 = {k: float((v.double() - ref64).abs().max()) for k, v in
                  (("kernel", got), ("plain_fp32", ref),
                   ("cudnn_tf32", tf32))}
        del ref64, tf32
        ms = cuda_ms(lambda: stem.fused_stem(*args))
        plain_ms = cuda_ms(lambda: stem.stem_reference(*args))
        bound_ms, bound_by = stem_bound_ms(*shape[:3])
        self.results.setdefault("stem", {})[str(shape)] = {
            "max_abs_err": err, "gate": gate, "err_vs_fp64": errs64,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by}
        self.check(got.shape == ref.shape and err < gate,
                   f"stem {list(shape)}: max|d|={err:.3e} < {gate:.3e}; "
                   f"vs fp64: kernel {errs64['kernel']:.3e}, plain fp32 "
                   f"{errs64['plain_fp32']:.3e}, cuDNN TF32 "
                   f"{errs64['cudnn_tf32']:.3e}; kernel {ms:.3f} ms, "
                   f"plain {plain_ms:.3f} ms, bound {bound_ms:.3f} ms "
                   f"({bound_by})  [{self.smi}]")

    # -- 4 ----------------------------------------------------------------
    def match(self):
        for b, n1, n2 in ((B, K_PTS, SHAPE3D), (2, 1000, 1990)):
            for kind in ("random", "peaked"):
                self.match_case(b, n1, n2, kind)

    def match_case(self, b, n1, n2, kind):
        """The match kernel vs plain on unit descriptors [b,n1,256] x
        [b,n2,256], random or peaked (DB slots j < n1 noisy copies of
        query j), under ``match_gate``, with both times and the bound,
        into results["match"]."""
        from onepose_tpu_torch.ops import match

        rng = np.random.default_rng(1)
        d0 = unit(rng.normal(size=(b, n1, 256)))
        d1 = unit(rng.normal(size=(b, n2, 256)))
        if kind == "peaked":
            d1[:, :n1] = unit(d0 + 0.05 * rng.normal(size=d0.shape))
        d0, d1 = (torch.from_numpy(x).to(self.dev) for x in (d0, d1))
        got = match.dual_softmax_argmax(d0, d1, 0.07)
        torch.cuda.synchronize()
        gate = match.match_gate(got, d0, d1, 0.07)
        ms = cuda_ms(lambda: match.dual_softmax_argmax(d0, d1, 0.07))
        plain_ms = cuda_ms(lambda: match.match_reference(d0, d1, 0.07))
        bound_ms, bound_by = match_bound_ms(b, n1, n2, 256)
        key = f"[{b},{n1},256]x[{b},{n2},256] {kind}"
        self.results.setdefault("match", {})[key] = {
            **dataclasses.asdict(gate), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}
        self.check(gate.ok,
                   f"match {key}: max rel err {gate.max_rel_err:.3e} "
                   f"(gate {match.GATE_REL:.0e}), index mismatches "
                   f"outside near-ties {gate.bad_idx} (all "
                   f"{gate.idx_diff}, near-tie rows+cols "
                   f"{gate.near_ties}); kernel {ms:.3f} ms, plain "
                   f"{plain_ms:.3f} ms, bound {bound_ms:.4f} ms "
                   f"({bound_by})  [{self.smi}]")

    # -- 5 ----------------------------------------------------------------
    def known_pose(self):
        from onepose_tpu_torch import pipeline
        from onepose_tpu_torch.utils import geometry as geo

        rng = np.random.default_rng(0)
        nb, nk, n2 = 3, 128, 256
        kmat = np.array([[460.0, 0, 256], [0, 460.0, 256], [0, 0, 1]],
                        np.float32)
        pts3d = rng.uniform(-0.1, 0.1, (n2, 3)).astype(np.float32)
        kpts2d = np.zeros((nb, nk, 2), np.float32)
        matches0 = np.full((nb, nk), -1, np.int64)
        kpt_mask = np.zeros((nb, nk), bool)
        poses_gt = []
        for b in range(nb):
            R = geo.rodrigues(rng.normal(size=3) * 0.5)
            t = np.array([0.01 * b, -0.02, 0.4 + 0.1 * b])
            pose = np.concatenate([R, t[:, None]], axis=1)
            poses_gt.append(pose)
            sel = rng.choice(n2, 100, replace=False)
            uv = geo.project_points(pts3d[sel], kmat, pose)
            uv += rng.normal(size=uv.shape) * 0.5
            kpts2d[b, :100] = uv
            matches0[b, :100] = sel
            kpt_mask[b, :100] = True
            matches0[b, 90:100] = rng.choice(n2, 10)   # 10 wrong matches
        gen = torch.Generator(device=self.dev).manual_seed(0)
        t = lambda x: torch.from_numpy(x).to(self.dev)  # noqa: E731
        res = pipeline.poses_from_matches(
            t(kpts2d), t(kpt_mask), t(matches0), t(pts3d),
            t(np.broadcast_to(kmat, (nb, 3, 3)).copy()), generator=gen)
        for b in range(nb):
            r_err, t_err = geo.query_pose_error(
                res.pose[b].cpu().numpy(), poses_gt[b])
            n_in = int(res.num_inliers[b])
            self.check(r_err < POSE_DEG and t_err < POSE_CM and n_in >= 80,
                       f"known pose frame {b}: {r_err:.4f} deg, "
                       f"{t_err:.4f} cm, {n_in} inliers")

    # -- 6 ----------------------------------------------------------------
    def parity(self):
        from onepose_tpu_torch import pipeline
        from onepose_tpu_torch.ops import epnp
        from onepose_tpu_torch.utils import geometry as geo
        from onepose_tpu_torch.utils.synthetic import random_db

        rng = np.random.default_rng(2)
        sp_model, gats_model = random_models(rng)
        db = random_db(rng, points=240, shape3d=256, leaf=4)
        nb, hw = 2, 128
        kmat = np.array([[400.0, 0, hw / 2], [0, 400.0, hw / 2], [0, 0, 1]],
                        np.float32)
        Ks = np.broadcast_to(kmat, (nb, 3, 3)).copy()
        images = rng.uniform(0, 1, (nb, hw, hw, 1)).astype(np.float32)
        kw = dict(sp_config={"max_keypoints": 256, "nms_radius": 3},
                  # random weights give conf far below the trained 0.2
                  gats_config={"match_threshold": 1e-3},
                  num_hypotheses=HYP, refine_iters=5)
        gen = torch.Generator().manual_seed(0)
        noise = epnp.draw_noise(nb, 256, HYP, 64, gen)

        first = pipeline.PosePipeline(sp_model, gats_model, db,
                                      device="cpu", **kw)(
            images, Ks, noise=noise)
        poses_gt = [np.concatenate([geo.rodrigues(rng.normal(size=3) * 0.3),
                                    np.array([[0.0], [0.0], [0.5]])], 1)
                    for _ in range(nb)]
        db = plant_geometry(db, first.matches0, first.keypoints2d, kmat,
                            poses_gt, rng)
        cpu = pipeline.PosePipeline(sp_model, gats_model, db,
                                    device="cpu", **kw)(
            images, Ks, noise=noise)
        card = pipeline.PosePipeline(sp_model, gats_model, db,
                                     device=self.dev, **kw)(
            images, Ks, noise=epnp.RansacNoise(
                *(n.to(self.dev) for n in noise)))
        card = type(card)(*(x.cpu() for x in card))
        stats = {}
        for b in range(nb):
            m = cpu.kpt_mask[b]
            same_kpts = (torch.equal(cpu.kpt_mask[b], card.kpt_mask[b])
                         and torch.equal(cpu.keypoints2d[b][m],
                                         card.keypoints2d[b][m]))
            diff = int((cpu.matches0[b] != card.matches0[b]).sum())
            r_gt, t_gt = geo.query_pose_error(card.poses[b].numpy(),
                                              poses_gt[b])
            r_cc, t_cc = geo.query_pose_error(card.poses[b].numpy(),
                                              cpu.poses[b].numpy())
            n_match = int(card.num_matches[b])
            stats[b] = {"matches": n_match, "matches0_diff": diff,
                        "inliers": int(card.num_inliers[b]),
                        "card_vs_gt": [r_gt, t_gt],
                        "card_vs_cpu": [r_cc, t_cc]}
            self.check(same_kpts, f"parity frame {b}: keypoint sets equal")
            self.check(diff == 0 and n_match >= 20,
                       f"parity frame {b}: matches0 differ at {diff} of "
                       f"{cpu.matches0.shape[1]} slots, {n_match} matches")
            self.check(r_cc < PARITY_DEG and t_cc < PARITY_CM
                       and bool(card.success[b]) and bool(cpu.success[b]),
                       f"parity frame {b}: card vs CPU pose {r_cc:.5f} deg, "
                       f"{t_cc:.5f} cm; card vs planted pose {r_gt:.4f} deg, "
                       f"{t_gt:.4f} cm, {int(card.num_inliers[b])} inliers")
            self.check(r_gt < POSE_DEG and t_gt < POSE_CM,
                       f"parity frame {b}: planted pose recovered")
        self.results["parity"] = stats

    # -- 7 ----------------------------------------------------------------
    def protocol(self):
        from onepose_tpu_torch import pipeline
        from onepose_tpu_torch.utils.synthetic import random_db

        rng = np.random.default_rng(0)
        sp_model, gats_model = random_models(rng)
        db = random_db(rng, points=SHAPE3D - 8, shape3d=SHAPE3D, leaf=LEAF,
                       obs=(LEAF, LEAF * 3))
        pipe = pipeline.PosePipeline(
            sp_model, gats_model, db, sp_config={"max_keypoints": K_PTS},
            num_hypotheses=HYP, refine_iters=5, device=self.dev)
        images = torch.from_numpy(
            rng.uniform(0, 1, (B, H, W, 1)).astype(np.float32)).to(self.dev)
        Ks = torch.from_numpy(
            np.broadcast_to(KMAT, (B, 3, 3)).copy()).to(self.dev)
        gen = torch.Generator(device=self.dev).manual_seed(1)

        out = self.path_launches("pipeline",
                                 lambda: pipe(images, Ks, generator=gen))
        finite = all(bool(torch.isfinite(x.float()).all()) for x in
                     (out.poses, out.keypoints2d, out.descriptors2d))
        shapes = (tuple(out.poses.shape) == (B, 3, 4)
                  and tuple(out.matches0.shape) == (B, K_PTS))
        self.check(finite and shapes, "protocol run: finite outputs, shapes")
        log(f"   keypoints/frame {out.kpt_mask.sum(1).tolist()}, matches "
            f"{out.num_matches.tolist()}, success {out.success.tolist()}")

        # per-stage device time of a batch of 8 (5 calls each: phase 8
        # times the same steps again)
        det = pipe.extract(images)
        mt = pipe.match(det)
        stage = {
            "extract_ms": cuda_ms(lambda: pipe.extract(images), 5, 1),
            "match_ms": cuda_ms(lambda: pipe.match(det), 5, 1),
            "pnp_ms": cuda_ms(lambda: pipe.pose(det, mt, Ks, generator=gen),
                              5, 1),
            "total_ms": cuda_ms(lambda: pipe(images, Ks, generator=gen),
                                5, 1),
        }
        stage["frames_per_s"] = B * 1000.0 / stage["total_ms"]
        self.results["protocol"] = stage
        log("   " + ", ".join(f"{k} {v:.3f}" for k, v in stage.items())
            + f"  [{self.smi}]")

        # where the device time goes, and how idle the card is, per stage
        prof, tables = {}, []
        for name, fn in (
                ("extract", lambda: pipe.extract(images)),
                ("match", lambda: pipe.match(det)),
                ("pnp", lambda: pipe.pose(det, mt, Ks, generator=gen)),
                ("total", lambda: pipe(images, Ks, generator=gen))):
            prof[name], table = device_profile(fn)
            tables.append(f"== {name}: {prof[name]}\n{table}")
            log(f"   profile {name}: " + ", ".join(
                f"{k} {v:.3f}" if isinstance(v, float) else f"{k} {v}"
                for k, v in prof[name].items()))
        self.results["profile"] = prof
        with open(os.path.join(self.out_dir, "profile.txt"), "w") as f:
            f.write("\n".join(tables))
        self.check(prof["total"]["busy_ms"] > 0, "protocol run used the card")

    # -- 8 ----------------------------------------------------------------
    def serving(self):
        from onepose_tpu_torch import pipeline, serving
        from onepose_tpu_torch.models import gats_spg, superpoint
        from onepose_tpu_torch.ops import epnp, match
        from onepose_tpu_torch.utils import geometry as geo
        from onepose_tpu_torch.utils.synthetic import random_db

        rng = np.random.default_rng(8)
        sp_model, gats_model = random_models(rng)
        dbs = {f"obj{i}": random_db(rng, points=SHAPE3D - 8, shape3d=SHAPE3D,
                                    leaf=LEAF, obs=(LEAF, LEAF * 3))
               for i in range(N_OBJECTS)}
        # random weights keep every conf far below the trained 0.2: every
        # mutual nearest neighbour counts as a match, so PnP gets work
        kw = dict(sp_config={"max_keypoints": K_PTS},
                  gats_config={"match_threshold": 0.0}, batch_size=B,
                  num_hypotheses=HYP, refine_iters=5, device=self.dev)
        images = rng.uniform(0, 1, (B, H, W)).astype(np.float32)
        reqs = [serving.PoseRequest(f"obj{b}", images[b], KMAT)
                for b in range(B)]
        noise = epnp.draw_noise(B, K_PTS, HYP, 64, torch.Generator(
            device=self.dev).manual_seed(8), self.dev)

        # plant each object's 3D points on its frame's matches and a known
        # pose (matching reads descriptors only, so the matches stay)
        first = serving.PoseServer(sp_model, gats_model, dbs, **kw).run(
            reqs, noise)
        poses_gt = [np.concatenate([geo.rodrigues(rng.normal(size=3) * 0.3),
                                    np.array([[0.0], [0.0], [0.5]])], 1)
                    for _ in range(B)]
        dbs = {f"obj{b}": plant_geometry(
            dbs[f"obj{b}"], first.matches0[b:b + 1],
            first.keypoints2d[b:b + 1], KMAT, poses_gt[b:b + 1], rng)
            for b in range(B)}
        del first
        server = serving.PoseServer(sp_model, gats_model, dbs, **kw)
        stack_mb = sum(t.numel() * t.element_size()
                       for t in server.db_stack.values()) / 1e6
        out = self.path_launches("serving", lambda: server.run(reqs, noise))
        stats = self.results["serving"] = {
            "objects": N_OBJECTS, "db_stack_mb": stack_mb,
            "matches": out.num_matches.tolist(),
            "inliers": out.num_inliers.tolist()}

        # the same frames through a PosePipeline per object
        Ks = np.broadcast_to(KMAT, (B, 3, 3)).copy()
        for b in range(B):
            ref = pipeline.PosePipeline(
                sp_model, gats_model, dbs[f"obj{b}"],
                sp_config=kw["sp_config"], gats_config=kw["gats_config"],
                num_hypotheses=HYP, refine_iters=5, device=self.dev)(
                images[..., None], Ks, noise=noise)
            diff = int((out.matches0[b] != ref.matches0[b]).sum())
            pose_d = float((out.poses[b] - ref.poses[b]).abs().max())
            r_gt, t_gt = geo.query_pose_error(out.poses[b].cpu().numpy(),
                                              poses_gt[b])
            self.check(diff == 0 and pose_d <= 1e-4
                       and bool(out.success[b]) == bool(ref.success[b]),
                       f"serving obj{b}: matches0 differ from its pipeline at "
                       f"{diff} slots, pose by {pose_d:.2e}")
            self.check(bool(out.success[b]) and r_gt < POSE_DEG
                       and t_gt < POSE_CM,
                       f"serving obj{b}: planted pose {r_gt:.4f} deg, "
                       f"{t_gt:.4f} cm, {int(out.num_inliers[b])} inliers of "
                       f"{int(out.num_matches[b])} matches")

        # the match kernel on the per-element DBs, against plain
        with torch.no_grad():
            img_t = torch.from_numpy(images[..., None]).to(self.dev)
            det = superpoint.extract(server.sp_model, img_t,
                                     server.sp_config)
            idx = torch.arange(B, device=self.dev)
            data = {"descriptors2d_query": det.descriptors,
                    "descriptors3d_db": server.db_stack[
                        "descriptors3d"].index_select(0, idx),
                    "descriptors2d_db": server.db_stack[
                        "descriptors2d_db"].index_select(0, idx)}
            m0, m1 = gats_spg.gnn_body(server.gats_model, data,
                                       server.gats_config)
        scale = server.gats_config["scale_factor"]
        got = match.dual_softmax_argmax(m0, m1, scale)
        torch.cuda.synchronize()
        gates = [match.match_gate([g[b:b + 1] for g in got], m0[b:b + 1],
                                  m1[b:b + 1], scale) for b in range(B)]
        stats["match_gate"] = [dataclasses.asdict(g) for g in gates]
        self.check(all(g.ok for g in gates),
                   "serving: match kernel on per-element DBs under "
                   f"match_gate: max rel err "
                   f"{max(g.max_rel_err for g in gates):.3e}, index "
                   f"differences {[g.idx_diff for g in gates]}, outside "
                   f"near-ties {sum(g.bad_idx for g in gates)}")

        # the uniform fast path against the mixed step
        uni = [serving.PoseRequest("obj3", images[b], KMAT) for b in range(B)]
        staged = server._assemble(uni, to_device=False)
        fast = server._launch(staged, noise)
        mixed = server._launch(staged._replace(uniform=False), noise)
        diff = int((fast.matches0 != mixed.matches0).sum())
        pose_d = float((fast.poses - mixed.poses).abs().max())
        self.check(staged.uniform and diff == 0 and pose_d <= 1e-5,
                   f"serving: uniform fast path vs mixed step: matches0 "
                   f"differ at {diff} slots, poses by {pose_d:.2e}")

        # the bf16 catalog against fp32 (tests/test_serving.py's contract)
        s16 = serving.PoseServer(sp_model, gats_model, dbs, db_dtype="bfloat16",
                                 **kw)
        out16 = s16.run(reqs, noise)
        del s16
        both = (out.matches0 >= 0) | (out16.matches0 >= 0)
        agree = float(((out.matches0 == out16.matches0) & both).sum()
                      / both.sum())
        inl, inl16 = out.num_inliers.tolist(), out16.num_inliers.tolist()
        stats["bf16_match_agreement"] = agree
        self.check(agree >= 0.9 and torch.equal(out.success, out16.success)
                   and all(abs(a - b) <= max(3, 0.2 * a)
                           for a, b in zip(inl, inl16)),
                   f"serving: bf16 catalog: {agree:.4f} of matched slots "
                   f"agree with fp32, inliers {inl16} vs {inl}")

        # infer_many over 24 requests against infer_batch of its chunks
        many_reqs = [serving.PoseRequest(
            f"obj{i % N_OBJECTS}", rng.uniform(0, 1, (H, W)).astype(
                np.float32), KMAT) for i in range(3 * B)]
        server.generator.manual_seed(3)
        many = server.infer_many(many_reqs, depth=2, max_in_flight=2)
        server.generator.manual_seed(3)
        serial = [r for i in range(0, len(many_reqs), B)
                  for r in server.infer_batch(many_reqs[i:i + B])]
        same = len(many) == len(serial) == 3 * B and all(
            a["success"] == b["success"]
            and a["num_inliers"] == b["num_inliers"]
            and (a["pose"] is None
                 or np.abs(a["pose"] - b["pose"]).max() <= 1e-5)
            for a, b in zip(many, serial))
        self.check(same, f"serving: infer_many gave {len(many)} results, "
                   "equal to infer_batch of the same chunks")

        # the async path: a partial batch after max_latency_s, a full one
        server.max_latency_s = 0.05
        server.start()
        try:
            t0 = time.perf_counter()
            partial = [server.submit(r) for r in many_reqs[:5]]
            res = [f.result(timeout=120) for f in partial]
            partial_s = time.perf_counter() - t0
            full = [server.submit(r) for r in many_reqs[5:5 + B]]
            res += [f.result(timeout=120) for f in full]
        finally:
            server.stop()
        stats["async_partial_s"] = partial_s
        self.check(len(res) == 5 + B and all("success" in r for r in res)
                   and not server._worker.is_alive(),
                   f"serving: async path answered {len(res)} submits (a "
                   f"partial batch of 5 in {partial_s:.3f} s, then {B})")

        # serve-step time a batch and the card's busy share
        ms = event_ms(lambda: server.run(reqs), 10, 2)
        stats["serve_ms"] = {"median": float(np.median(ms)),
                             "min": min(ms), "max": max(ms), "all": ms}
        stats["profile"], table = device_profile(lambda: server.run(reqs))
        with open(os.path.join(self.out_dir, "profile.txt"), "a") as f:
            f.write(f"\n== serving: {stats['profile']}\n{table}")
        log(f"   serve step at {N_OBJECTS} objects ({stack_mb:.1f} MB of DB): "
            f"median {stats['serve_ms']['median']:.3f} ms a batch of {B} "
            f"(min {min(ms):.3f}, max {max(ms):.3f}); busy "
            f"{stats['profile']['busy_ms']:.3f} ms, share "
            f"{stats['profile']['busy_share']:.3f}  [{self.smi}]")

    # -- 9 ----------------------------------------------------------------
    def detector(self):
        from onepose_tpu_torch import detector as tdet
        from onepose_tpu_torch.models import convert, superglue
        from onepose_tpu_torch.ops import similarity
        from onepose_tpu_torch.ops.precision import pin_fp32

        rng = np.random.default_rng(9)
        stats = self.results["detector"] = {}
        for shape in ((N_VIEWS, H, W, 1), (1, *FRAME_HW, 1)):
            self.stem_case(shape, rng)

        # a planted similarity per view, 30% outliers
        n = K_PTS
        ang = rng.uniform(-np.pi, np.pi, N_VIEWS)
        sc = rng.uniform(0.5, 2.0, N_VIEWS)
        A_gt = sc[:, None, None] * np.stack(
            [np.stack([np.cos(ang), -np.sin(ang)], -1),
             np.stack([np.sin(ang), np.cos(ang)], -1)], -2)
        t_gt = rng.uniform(-200, 200, (N_VIEWS, 2))
        src = rng.uniform(0, W, (N_VIEWS, n, 2))
        dst = src @ A_gt.transpose(0, 2, 1) + t_gt[:, None] + rng.normal(
            size=src.shape) * 0.5
        out_idx = rng.random((N_VIEWS, n)) < 0.3
        dst[out_idx] = rng.uniform(0, FRAME_HW[1], (int(out_idx.sum()), 2))
        t = lambda x: torch.from_numpy(np.asarray(x, np.float32)).to(self.dev)  # noqa: E731
        fit = similarity.ransac_similarity(
            t(src), t(dst), torch.ones(N_VIEWS, n, dtype=torch.bool,
                                       device=self.dev),
            generator=torch.Generator(device=self.dev).manual_seed(9))
        a_err = float(np.abs(fit.A.cpu().numpy() - A_gt).max())
        t_err = float(np.abs(fit.t.cpu().numpy() - t_gt).max())
        # 0.5 px noise against a 6 px threshold: the inliers are exactly
        # the planted correspondences
        wrong = int((fit.inliers.cpu().numpy() != ~out_idx).sum())
        stats["similarity"] = {"A_err": a_err, "t_err": t_err,
                               "wrong_inliers": wrong}
        self.check(a_err < 1e-2 and t_err < 2.0 and wrong == 0,
                   f"detector: planted similarity on {N_VIEWS} views: "
                   f"|dA| {a_err:.2e}, |dt| {t_err:.3f} px, inlier sets "
                   f"differ from the planted ones at {wrong} of "
                   f"{N_VIEWS * n}")

        # the scene: one DB view pasted into a black frame
        sp_model = convert.superpoint_from_jax(
            convert.init_superpoint_params(rng))
        views = [rng.uniform(0, 1, (H, W)).astype(np.float32)
                 for _ in range(N_VIEWS)]
        frame = np.zeros(FRAME_HW, np.float32)
        (ox, oy) = PASTE_XY
        frame[oy:oy + H, ox:ox + W] = views[PASTED_VIEW]
        rect = np.array([ox, oy, ox + W, oy + H])
        sg_params = convert.init_superglue_params(rng)
        probe = tdet.LocalFeatureObjectDetector(
            sp_model, convert.superglue_from_jax(sg_params), views,
            max_keypoints=K_PTS, device=self.dev)
        planted = convert.plant_superglue(sg_params, probe.db_det, 0.0)
        del probe

        def detector_path():   # the DB views' extraction, then one frame
            d = tdet.LocalFeatureObjectDetector(
                sp_model, convert.superglue_from_jax(planted), views,
                max_keypoints=K_PTS, device=self.dev)
            return d, d.detect_bbox(frame)

        det, (box, inliers) = self.path_launches(
            "detector", detector_path, kernels=("stem",))
        stats["planted_box"] = {"box": box.tolist(), "rect": rect.tolist(),
                                "inliers": inliers}
        self.check(np.abs(box - rect).max() <= 1 and inliers >= 100,
                   f"detector: planted detection: box {box.tolist()} vs "
                   f"pasted {rect.tolist()} (1 px), {inliers} inliers")

        # card vs CPU, small random GNN deltas, the same injected noise
        perturbed = convert.plant_superglue(sg_params, det.db_det, 0.05)
        noise = torch.rand((N_VIEWS, 256, K_PTS),
                           generator=torch.Generator().manual_seed(10))
        sides, dets = {}, {}
        for side, dev in (("card", self.dev), ("cpu", torch.device("cpu"))):
            # a module moves to its detector's device: one copy each
            d = tdet.LocalFeatureObjectDetector(
                copy.deepcopy(sp_model), convert.superglue_from_jax(perturbed),
                views, max_keypoints=K_PTS, device=dev)
            t0 = time.perf_counter()
            q = d.extract(torch.from_numpy(frame).to(dev)[None, :, :, None])
            data = d.match_data(q, FRAME_HW)
            Z = superglue.log_assignment(d.sg_model, data, d.sg_config)
            m = superglue.mutual_matches(Z, d.sg_config["match_threshold"],
                                         data["mask0"], data["mask1"])
            fits = d.fit(q, m, noise.to(dev))
            sides[side] = (d.box(fits, FRAME_HW), m.matches0.cpu(),
                           Z.cpu(), (data["keypoints0"].cpu(),
                                     data["keypoints1"].cpu()))
            dets[side] = d, data
            log(f"   detect on the {side}: {time.perf_counter() - t0:.1f} s")
        card_det, card_data = dets["card"]
        thr = card_det.sg_config["match_threshold"]
        (c_box, c_inl), c_m0, c_Z, c_kp = sides["card"]
        (h_box, h_inl), h_m0, h_Z, h_kp = sides["cpu"]
        gate = superglue.match_gate(c_m0, c_Z, h_m0, h_Z, thr, c_kp, h_kp)
        stats["card_vs_cpu"] = {"card": [c_box.tolist(), c_inl],
                                "cpu": [h_box.tolist(), h_inl],
                                "gate": dataclasses.asdict(gate),
                                "matches": int((h_m0 >= 0).sum())}
        self.check(np.array_equal(c_box, h_box) and c_inl == h_inl
                   and gate.ok,
                   f"detector: card vs CPU: same keypoint positions "
                   f"{gate.same_keypoints}, box {c_box.tolist()} / "
                   f"{h_box.tolist()}, inliers {c_inl} / {h_inl}; log "
                   f"assignments differ by {gate.max_abs_diff:.3e} "
                   f"({gate.max_rel_diff:.2e} of their scale, gate "
                   f"{superglue.GATE_REL:.0e}); matches0 differ at "
                   f"{gate.diff} of {int((h_m0 >= 0).sum())} matched rows, "
                   f"outside near-ties {gate.bad} ({gate.near_ties} near-tie "
                   f"rows+cols)")

        # control: the card's SuperGlue with TF32 products, on the card
        # side's own inputs, must fail the same gate
        try:
            torch.backends.cuda.matmul.allow_tf32 = True
            torch.set_float32_matmul_precision("high")
            tf_Z = superglue.log_assignment(card_det.sg_model, card_data,
                                            card_det.sg_config)
            tf_m = superglue.mutual_matches(tf_Z, thr, card_data["mask0"],
                                            card_data["mask1"])
            torch.cuda.synchronize()
        finally:
            pin_fp32()
        ctrl = superglue.match_gate(tf_m.matches0.cpu(), tf_Z.cpu(), h_m0,
                                    h_Z, thr, c_kp, h_kp)
        stats["tf32_control"] = dataclasses.asdict(ctrl)
        self.check(not ctrl.ok and ctrl.max_rel_diff > superglue.GATE_REL,
                   f"detector: TF32 control refused: log assignments "
                   f"{ctrl.max_abs_diff:.3e} apart ({ctrl.max_rel_diff:.2e} "
                   f"of their scale, gate {superglue.GATE_REL:.0e}); "
                   f"matches0 differ at {ctrl.diff} rows, outside near-ties "
                   f"{ctrl.bad}")
        del card_data, tf_Z, tf_m

        # detect time a frame, split into its three device stages
        q_img = torch.from_numpy(frame).to(self.dev)[None, :, :, None]
        q = card_det.extract(q_img)
        m = card_det.match(q, FRAME_HW)
        gen = torch.Generator(device=self.dev).manual_seed(11)
        split = {
            "extract_ms": event_ms(lambda: card_det.extract(q_img), 5, 1),
            "superglue_ms": event_ms(lambda: card_det.match(q, FRAME_HW),
                                     5, 1),
            "ransac_ms": event_ms(lambda: card_det.fit(q, m, generator=gen),
                                 5, 1),
            "detect_ms": event_ms(lambda: card_det.detect_bbox(frame), 5, 1)}
        stats["times"] = {k: {"median": float(np.median(v)), "all": v}
                          for k, v in split.items()}
        stats["profile"], table = device_profile(
            lambda: card_det.detect_bbox(frame))
        with open(os.path.join(self.out_dir, "profile.txt"), "a") as f:
            f.write(f"\n== detect: {stats['profile']}\n{table}")
        log("   detect a frame: " + ", ".join(
            f"{k} {np.median(v):.3f}" for k, v in split.items())
            + f"; busy {stats['profile']['busy_ms']:.3f} ms, share "
            f"{stats['profile']['busy_share']:.3f}  [{self.smi}]")

    # -- 10 ---------------------------------------------------------------
    def plane(self):
        """Phase 10's sequence (both halves): a textured plane at 512x512,
        1024 keypoint slots of D=256, 400 of them real."""
        from onepose_tpu_torch.utils.synthetic import plane_sequence

        if not hasattr(self, "_plane"):
            self._plane = plane_sequence(np.random.default_rng(10),
                                         TRACK_FRAMES)
        return self._plane

    def tracking(self):
        """10a: BATracker (defaults: win 10, 256 hypotheses, 8 BA
        iterations, max_obs 4096) over the plane sequence on the card."""
        from onepose_tpu_torch import tracker as ttr
        from onepose_tpu_torch.utils import geometry as geo

        K, pts3d, frames = self.plane()
        stats = self.results["tracker"] = {}
        gen = torch.Generator().manual_seed(10)
        noises = [ttr.draw_track_noise(K_PTS, K_PTS, TRACK_HYP, gen)
                  for _ in frames[1:]]

        def seeded(device):
            tr = ttr.BATracker(device=device)
            f0 = frames[0]
            if not tr.add_keyframe(f0["image"], f0["keypoints"],
                                   f0["descriptors"], f0["mask"], f0["pose"],
                                   K, mkpts3d=pts3d,
                                   kpt_indices=np.arange(len(pts3d))):
                raise RuntimeError("tracker: keyframe 0 refused")
            return tr

        # the card over the sequence: every frame's wall time and stage
        # split (CUDA events at the tracker's stage marks), the last frame
        # under the profiler
        tr = seeded(self.dev)
        wall, splits, steps, errs = [], [], [], []
        for i, fr in enumerate(frames[1:], 1):
            noise = to_device(noises[i - 1], self.dev)
            args = (fr["image"], fr["keypoints"], fr["descriptors"],
                    fr["mask"], K)
            if i == len(frames) - 1:
                tr.mark = None
                box = []
                stats["profile"], table = device_profile(
                    lambda: box.append(tr.track(*args, noise=noise)))
                pose, info = box[0]
                with open(os.path.join(self.out_dir, "profile.txt"),
                          "a") as f:
                    f.write(f"\n== tracked frame: {stats['profile']}\n"
                            f"{table}")
            else:
                pose, info, ms, split = timed_track(tr, args, noise)
                if i > TRACK_WARMUP:
                    wall.append(ms)
                    splits.append(split)
            steps.append(info["step"])
            errs.append(geo.query_pose_error(pose, fr["pose"]))
        r_max = max(e[0] for e in errs)
        t_max = max(e[1] for e in errs)
        stats["max_err_deg_cm"] = [r_max, t_max]
        self.check(len(wall) == TRACK_TIMED and r_max < TRACK_DEG
                   and t_max < TRACK_CM,
                   f"tracker: {len(errs)} tracked frames within "
                   f"{r_max:.4f} deg, {t_max:.4f} cm of the truth "
                   f"(bound {TRACK_DEG} deg / {TRACK_CM} cm)")

        split_med = {k: float(np.median([s[k] for s in splits]))
                     for k in splits[0]}
        step_ms = [sum(sp[k] for k in ("lk", "flow_pnp", "nn", "pnp", "tri"))
                   for sp in splits]
        ba_ms = [sp["host"] + sp["ba"] for sp in splits]
        stats["track_ms"] = {"median": float(np.median(wall)),
                             "min": min(wall), "max": max(wall), "all": wall}
        stats["step_ms_median"] = float(np.median(step_ms))
        stats["ba_ms_median"] = float(np.median(ba_ms))
        stats["stage_ms_median"] = split_med
        log(f"   track() a frame: median {stats['track_ms']['median']:.3f} "
            f"ms (min {min(wall):.3f}, max {max(wall):.3f}) over "
            f"{len(wall)} frames; track step {stats['step_ms_median']:.3f} "
            f"ms, window BA {stats['ba_ms_median']:.3f} ms; stages "
            + ", ".join(f"{k} {v:.3f}" for k, v in split_med.items())
            + f"; one frame profiled: {stats['profile']['device_ops']} "
            f"device ops, {stats['profile']['host_syncs']} host syncs, busy "
            f"{stats['profile']['busy_ms']:.3f} ms, share "
            f"{stats['profile']['busy_share']:.3f}  [{self.smi}]")

        # card vs CPU on the first frames, the same injected noise
        cpu = seeded("cpu")
        diffs = []
        for i, fr in enumerate(frames[1:CPU_FRAMES], 1):
            pose, info = cpu.track(fr["image"], fr["keypoints"],
                                   fr["descriptors"], fr["mask"], K,
                                   noise=noises[i - 1])
            c, g = info["step"], steps[i - 1]
            both = c.flow_status & g.flow_status
            px = float((c.flow_points - g.flow_points)[both].abs().max())
            pose_d = float(np.abs(pose - tr.pose_history[i]).max())
            diffs.append({
                "lk_px": px, "status_diff": int((c.flow_status
                                                 != g.flow_status).sum()),
                "m0_equal": torch.equal(c.m0, g.m0),
                "keep_equal": torch.equal(c.keep, g.keep),
                "pose": pose_d})
        stats["card_vs_cpu"] = diffs
        self.check(all(d["lk_px"] <= TRACK_PX and d["m0_equal"]
                       and d["keep_equal"] and d["pose"] <= TRACK_POSE
                       for d in diffs),
                   f"tracker: card vs CPU over frames 1-{CPU_FRAMES - 1}: "
                   f"LK points {max(d['lk_px'] for d in diffs):.2e} px apart "
                   f"where both track (bound {TRACK_PX}), statuses differ at "
                   f"{[d['status_diff'] for d in diffs]}, m0 and keep equal "
                   f"{[d['m0_equal'] and d['keep_equal'] for d in diffs]}, "
                   f"poses {max(d['pose'] for d in diffs):.2e} apart (bound "
                   f"{TRACK_POSE})")

        # uint8 frames against their float32 frames, on the card
        runs = {}
        for name in ("uint8", "float32"):
            t8 = seeded(self.dev)
            out = []
            for i, fr in enumerate(frames[1:CPU_FRAMES], 1):
                u8 = np.clip(np.round(fr["image"] * 255.0), 0, 255).astype(
                    np.uint8)
                img = u8 if name == "uint8" else (u8.astype(np.float32)
                                                  / np.float32(255.0))
                pose, info = t8.track(img, fr["keypoints"],
                                      fr["descriptors"], fr["mask"], K,
                                      noise=to_device(noises[i - 1],
                                                      self.dev))
                out.append((pose, info["step"]))
            runs[name] = out
        same = all(np.array_equal(a[0], b[0])
                   and all(torch.equal(x, y) for x, y in zip(a[1], b[1]))
                   for a, b in zip(runs["uint8"], runs["float32"]))
        stats["uint8_bit_identical"] = same
        self.check(same, f"tracker: uint8 frames bit-identical to their "
                   f"float32 frames on the card over {CPU_FRAMES - 1} frames")

    def demo(self):
        """10b: the demo's tracked path, PosePipeline at batch 1 and then
        apply_tracking, over the same frames, with the kernels."""
        from onepose_tpu_torch import inference_demo, pipeline
        from onepose_tpu_torch import tracker as ttr
        from onepose_tpu_torch.ops import epnp
        from onepose_tpu_torch.sfm.extract import CONFS
        from onepose_tpu_torch.utils import geometry as geo
        from onepose_tpu_torch.utils.synthetic import (plant_on_plane,
                                                       random_db)

        K, _, frames = self.plane()
        K32 = K.astype(np.float32)
        stats = self.results["demo"] = {}
        rng = np.random.default_rng(11)
        sp_model, gats_model = random_models(rng)
        db = random_db(rng, points=SHAPE3D - 8, shape3d=SHAPE3D, leaf=LEAF,
                       obs=(LEAF, LEAF * 3))
        sp_conf = dict(CONFS["superpoint"]["conf"])   # the demo's extract conf
        sp_conf["max_keypoints"] = K_PTS
        # random weights: every mutual nearest neighbour is a match
        kw = dict(sp_config=sp_conf, gats_config={"match_threshold": 0.0},
                  num_hypotheses=HYP, refine_iters=5)
        gen = torch.Generator().manual_seed(11)
        noises = [inference_demo.DemoNoise(
            epnp.draw_noise(1, K_PTS, HYP, 64, gen),
            ttr.draw_track_noise(K_PTS, K_PTS, TRACK_HYP, gen))
            for _ in frames]

        # plant the DB's points matched in frame 0 on the plane
        probe = pipeline.PosePipeline(sp_model, gats_model, db,
                                      device=self.dev, **kw)(
            frames[0]["image"][None, :, :, None], K32[None],
            noise=to_device(noises[0].pose, self.dev))
        db = plant_on_plane(db, probe.matches0[0].cpu().numpy(),
                            probe.keypoints2d[0].cpu().numpy(), K,
                            frames[0]["pose"])
        del probe

        def run():
            """Every frame through pose_frame on the card: (DemoFrames,
            wall ms, pipeline ms, the pipeline's outputs on the host, the
            tracker's steps)."""
            pipe = TimedCall(pipeline.PosePipeline(
                copy.deepcopy(sp_model), copy.deepcopy(gats_model), db,
                device=self.dev, **kw))
            tracker, steps = keeping_steps(ttr.BATracker(device=self.dev))
            out, wall, pipe_out = [], [], []
            for fi, fr in enumerate(frames):
                t0 = time.perf_counter()
                out.append(inference_demo.pose_frame(
                    pipe, tracker, db.keypoints3d, fr["image"], K32, fi,
                    noise=to_device(noises[fi], self.dev)))
                wall.append((time.perf_counter() - t0) * 1e3)
                pipe_out.append(type(pipe.last)(
                    *(x.cpu() for x in pipe.last)))   # batch 1
            return out, wall, pipe.ms, pipe_out, steps

        card, wall, pipe_ms, card_pipe, card_steps = self.path_launches(
            "demo", run)
        got = self.results["launches"]["demo"]
        self.check(got["stem"] == got["match"] == len(frames),
                   f"demo: stem and match launched {got['stem']} and "
                   f"{got['match']} times for {len(frames)} frames")
        r0, t0 = geo.query_pose_error(card[0].pose, frames[0]["pose"])
        stats["frame0"] = {"source": card[0].source,
                           "inliers": card[0].inliers, "err": [r0, t0]}
        self.check(card[0].source == "pnp" and card[0].success
                   and r0 < POSE_DEG and t0 < POSE_CM,
                   f"demo: frame 0 from {card[0].source} with "
                   f"{card[0].inliers} inliers, {r0:.4f} deg, {t0:.4f} cm "
                   f"from the planted pose")
        sources = [f.source for f in card]
        stats["sources"] = sources
        # random SuperPoint weights keep most keypoints on the same pixels
        # from frame to frame, so the tracked poses drift from the truth:
        # recorded, not held
        stats["vs_truth_deg_cm"] = [geo.query_pose_error(f.pose, fr["pose"])
                                    for f, fr in zip(card, frames)]
        k0, k1 = (set(map(tuple, o.keypoints2d[0].tolist()))
                  for o in card_pipe[:2])
        stats["keypoints_on_frame0_pixels"] = len(k0 & k1) / len(k1)
        self.check(all(s == "track:flow" for s in sources[1:]),
                   f"demo: frames 1-{len(frames) - 1} tracked from flow: "
                   f"{sorted(set(sources[1:]))}")

        # card vs CPU, the pipeline: frames 0-3 through a CPU PosePipeline
        # with the card's noise. Keypoints come sorted by score, and scores
        # equal to rounding take each other's slots on the card and the
        # CPU (ROADMAP Queue 3), while RANSAC's noise is drawn per slot: the
        # card's noise goes into the CPU's slots.
        t_cpu = time.perf_counter()
        cpu_pipe = pipeline.PosePipeline(
            copy.deepcopy(sp_model), copy.deepcopy(gats_model), db,
            device="cpu", **kw)
        pipe_d, same = [], []
        for fi, fr in enumerate(frames[:CPU_FRAMES]):
            img = fr["image"][None, :, :, None]
            own = cpu_pipe.extract(torch.from_numpy(img)).keypoints[0]
            c = cpu_pipe(img, K32[None], noise=permute_noise(
                noises[fi].pose, slot_map(card_pipe[fi].keypoints2d[0], own)))
            g = card_pipe[fi]
            same.append(bool(g.success[0] == c.success[0]
                             and g.num_inliers[0] == c.num_inliers[0]))
            pipe_d.append(geo.query_pose_error(g.poses[0].numpy(),
                                               c.poses[0].numpy()))
        self.check(all(same) and all(r < PARITY_DEG and t < PARITY_CM
                                     for r, t in pipe_d),
                   f"demo: card vs CPU pipeline over frames 0-"
                   f"{CPU_FRAMES - 1}: PnP success and inliers equal {same}, "
                   f"poses within {max(r for r, _ in pipe_d):.5f} deg, "
                   f"{max(t for _, t in pipe_d):.5f} cm (bound "
                   f"{PARITY_DEG} / {PARITY_CM})")

        # card vs CPU, the tracking: a CPU tracker fed the card's pipeline
        # outputs and the card's noise through apply_tracking, so both see
        # the same inputs. (1) The tracker's NN match, run alone on both
        # devices from the same descriptors, must equal each step's m0, and
        # a match that differs must be a near-tie (nn_flips). (2) Before
        # the first frame whose step decides anything differently (a
        # match, a gated assignment, a triangulation kept, an LK status, an
        # inlier count, a flag), the tracked poses agree within TRACK_POSE;
        # up to and with that frame, whose step still had the same inputs,
        # the step's poses do. (3) From that frame on, the window BA and
        # the next steps work from other points and assignments: poses
        # agree within DEMO_DIVERGED_DEG / DEMO_DIVERGED_CM. Random
        # SuperPoint keypoints that stay on their pixels make the
        # triangulation and the BA here ill-conditioned, so such decisions
        # at their thresholds come early (on an H100: from frame 1).
        cpu_tr, cpu_steps = keeping_steps(ttr.BATracker(device="cpu"))
        fed, diffs = [], []
        for fi, fr in enumerate(frames[:CPU_FRAMES]):
            fed.append(inference_demo.apply_tracking(
                cpu_tr, db.keypoints3d, fr["image"], K32, card_pipe[fi], fi,
                card[fi].pnp_pose, noises[fi].track))
        for i in range(1, CPU_FRAMES):
            g, c = card_steps[i - 1], cpu_steps[i - 1]
            flips = nn_flips(card_pipe[i - 1], card_pipe[i], self.dev)
            matches = (flips.pop("card_m0"), flips.pop("cpu_m0"))
            both = c.flow_status & g.flow_status
            diffs.append({
                **flips,
                "steps_are_the_matches": bool(
                    torch.equal(g.m0, matches[0])
                    and torch.equal(c.m0, matches[1])),
                "decided_apart": {
                    f: int((getattr(g, f) != getattr(c, f)).sum())
                    for f in ("m0", "keep", "n_keep", "pnp_inliers",
                              "used_pnp", "flow_ok", "flow_inliers",
                              "have_init", "tri_good", "flow_status")
                    if not torch.equal(getattr(g, f), getattr(c, f))},
                "keep_diff": int((g.keep != c.keep).sum()),
                "status_diff": int((g.flow_status != c.flow_status).sum()),
                "lk_px": float((c.flow_points - g.flow_points)[both]
                               .abs().max()),
                "flow_inliers": [int(g.flow_inliers), int(c.flow_inliers)],
                "pnp_inliers": [int(g.pnp_inliers), int(c.pnp_inliers)],
                "step_pose": float((g.pose - c.pose).abs().max()),
                "pose": float(np.abs(card[i].pose - fed[i][0]).max()),
                "pose_deg_cm": geo.query_pose_error(
                    card[i].pose.astype(np.float64),
                    fed[i][0].astype(np.float64))})
        stats["cpu_s"] = time.perf_counter() - t_cpu
        same = [not d["decided_apart"] for d in diffs]
        first = same.index(False) if False in same else len(diffs)
        stats["card_vs_cpu"] = {"pipeline_pose_deg_cm": pipe_d,
                                "tracking": diffs,
                                "first_diverged_frame": first + 1}
        step_apart = [f"{d['step_pose']:.1e}" for d in diffs]
        apart = [f"{d['pose']:.1e}" for d in diffs]
        deg_cm = [f"{r:.4f}/{t:.4f}" for r, t in
                  (d["pose_deg_cm"] for d in diffs)]
        self.check(
            [f.source for f in card[:CPU_FRAMES]] == [s for _, s in fed]
            and all(d["steps_are_the_matches"]
                    and d["flips"] == d["near_ties"] for d in diffs)
            and all(d["step_pose"] <= TRACK_POSE for d in diffs[:first + 1])
            and all(d["pose"] <= TRACK_POSE for d in diffs[:first])
            and all(d["pose_deg_cm"][0] < DEMO_DIVERGED_DEG
                    and d["pose_deg_cm"][1] < DEMO_DIVERGED_CM
                    for d in diffs[first:]),
            f"demo: card vs CPU tracking on the card's pipeline outputs "
            f"over frames 1-{CPU_FRAMES - 1}: sources equal; NN match flips "
            f"{[d['flips'] for d in diffs]}, near-ties "
            f"{[d['near_ties'] for d in diffs]} (similarities "
            f"{max(d['sim_diff'] for d in diffs):.1e} apart), each step's "
            f"m0 these {[d['steps_are_the_matches'] for d in diffs]}; "
            f"decided apart {[d['decided_apart'] for d in diffs]}; step "
            f"poses {step_apart} apart (bound {TRACK_POSE} up to frame "
            f"{first + 1}); poses {apart} apart (bound {TRACK_POSE} up to "
            f"frame {first}), {deg_cm} deg/cm (bound {DEMO_DIVERGED_DEG} / "
            f"{DEMO_DIVERGED_CM} from frame {first + 1})")

        # per-frame ms after the warm-up, split into pipeline and tracking
        w, p = wall[TRACK_WARMUP:], pipe_ms[TRACK_WARMUP:]
        stats["frame_ms"] = {"median": float(np.median(w)), "all": w}
        stats["pipeline_ms_median"] = float(np.median(p))
        stats["tracking_ms_median"] = float(np.median(
            [a - b for a, b in zip(w, p)]))
        log(f"   demo frame: median {stats['frame_ms']['median']:.3f} ms "
            f"over {len(w)} frames, pipeline "
            f"{stats['pipeline_ms_median']:.3f} ms, tracking "
            f"{stats['tracking_ms_median']:.3f} ms  [{self.smi}]")

        # the kernels at the demo's shapes, against their plain versions
        self.stem_case((1, H, W, 1), rng)
        self.match_case(1, K_PTS, SHAPE3D, "random")

    # -- 11 ---------------------------------------------------------------
    def sfm_images(self):
        """11a: SfM from images, ``runner.run_sfm`` on the card at full
        width: extraction through the stem kernel in batches of 16,
        SuperGlue matching, verification, tracks, DLT, the database and
        postprocess; then the DB it wrote read by ``load_object_db`` and a
        frame posed on it."""
        import shutil

        from onepose_tpu_torch.utils import hdf5

        from onepose_tpu_torch import pipeline
        from onepose_tpu_torch.datasets import anno
        from onepose_tpu_torch.models import convert, superpoint
        from onepose_tpu_torch.runtime import native
        from onepose_tpu_torch.sfm import extract, runner, triangulate
        from onepose_tpu_torch.sfm.match import names_to_pair
        from onepose_tpu_torch.utils import colmap_io
        from onepose_tpu_torch.utils.synthetic import ring_views

        stats = self.results["sfm_images"] = {}
        rng = np.random.default_rng(12)
        self.stem_case((SFM_BATCH, H, W, 1), rng)
        lib = native.load_library()
        stats["native_library"] = str(lib._name) if lib else None
        self.check(lib is not None, f"native track builder loaded: {lib}")

        K, poses, images = ring_views(rng, SFM_IMAGES, hw=H,
                                      focal=float(KMAT[0, 0]))
        root = os.path.join(SFM_WORK, "capture")
        names = [os.path.join(root, "seq", "color", f"{i}.png")
                 for i in range(SFM_IMAGES)]
        sp_model = convert.superpoint_from_jax(
            convert.init_superpoint_params(np.random.default_rng(0)))
        sp_conf = {k: v for k, v in extract.CONFS["superpoint"]["conf"].items()
                   if k != "descriptor_dim"}
        # SuperGlue at the reference's depth, planted on the views'
        # descriptors: matching is their self-similarity
        det = superpoint.extract(sp_model.to(self.dev), torch.from_numpy(
            images[:SFM_BATCH, ..., None]).to(self.dev), sp_conf)
        sg_model = convert.superglue_from_jax(convert.plant_superglue(
            convert.init_superglue_params(rng), det, 0.0))
        del det
        out = os.path.join(SFM_WORK, "images")
        shutil.rmtree(root, ignore_errors=True)
        calib = ({n: K for n in names}, dict(zip(names, poses)),
                 {n: (W, H) for n in names})
        marks = []

        def mark(stage):
            torch.cuda.synchronize()
            marks.append((stage, time.perf_counter()))

        def sfm_path():
            marks.append(("start", time.perf_counter()))
            return runner.run_sfm(
                names, out, sp_model, sg_model, *calib, redo=True,
                images=dict(zip(names, images)), covis_num=10,
                device=self.dev, mark=mark)

        torch.cuda.reset_peak_memory_stats()
        res = self.path_launches("sfm", sfm_path, kernels=("stem",))
        # phase 12 trains on this capture's DB
        self.sfm_capture = {"names": names, "K": K, "poses": poses,
                            "images": images, "sp_model": sp_model,
                            "out": out}
        stats["peak_gb"] = torch.cuda.max_memory_allocated() / 2 ** 30
        stats["stage_ms"] = {name: (t - t0) * 1e3 for (_, t0), (name, t)
                             in zip(marks, marks[1:])}
        stats["result"] = res
        stem_launches = self.results["launches"]["sfm"]["stem"]
        want = -(-SFM_IMAGES // SFM_BATCH)
        self.check(stem_launches == want,
                   f"sfm: the stem kernel launched {stem_launches} times for "
                   f"{SFM_IMAGES} images in batches of {SFM_BATCH} "
                   f"(want {want})")

        lay = runner.sfm_outputs_layout(out, 10)
        pair_list = [tuple(x.split()) for x in open(
            lay["covis_pairs_out"]).read().splitlines()]
        ok = True
        with hdf5.File(lay["feature_out"], "r") as f:
            for n in names:
                g = f[n]
                kp, de, sc = (g[k][()] for k in ("keypoints", "descriptors",
                                                 "scores"))
                ok &= (kp.dtype == np.float32 and kp.shape[1] == 2
                       and 0 < len(kp) <= SFM_KPTS and de.shape == (256, len(kp))
                       and sc.shape == (len(kp),)
                       and list(g["image_size"][()]) == [W, H])
            stats["keypoints_per_image"] = [len(f[n]["keypoints"])
                                            for n in names[:SFM_BATCH]]
        with hdf5.File(lay["matches_out"], "r") as f:
            groups = sorted(f)
            a, b = pair_list[0]
            g = f[names_to_pair(a, b)]
            ok &= (g["matches0"].dtype == np.int32 and
                   g["matching_scores0"].shape == g["matches0"].shape)
            stats["matched_pairs"] = len(groups)
            stats["matches"] = int(sum((f[k]["matches0"][()] >= 0).sum()
                                       for k in groups))
        files = [os.path.join(lay["model_dir"], x) for x in (
            "cameras.bin", "images.bin", "points3D.bin")] + [
            os.path.join(lay["empty_dir"], "images.bin"),
            os.path.join(lay["deep_sfm_dir"], "database.db")] + [
            os.path.join(lay["anno_dir"], x) for x in (
                "anno_3d_average.npz", "anno_3d_collect.npz", "idxs.npy",
                "anno_2d.json")]
        missing = [x for x in files if not os.path.exists(x)]
        _, images_m, points3d = colmap_io.read_model(lay["model_dir"])
        xyz = np.stack([p.xyz for p in points3d.values()])
        stats["points"] = len(xyz)
        # the capture is the plane z = 0: random SuperPoint weights keep
        # most keypoints on fixed pixels, so this records, not gates
        stats["median_abs_z_mm"] = float(np.median(np.abs(xyz[:, 2]))) * 1e3
        self.check(ok and not missing and len(images_m) == SFM_IMAGES
                   and len(xyz) > 0,
                   f"sfm: HDF5 and model files in the JAX layout ({len(groups)}"
                   f" matched pairs, {stats['matches']} matches, {len(xyz)} "
                   f"points, median |z| {stats['median_abs_z_mm']:.1f} mm); "
                   f"missing {missing}")

        # the DB the port wrote, read and posed on
        db = anno.load_object_db(*(os.path.join(lay["anno_dir"], x) for x in (
            "anno_3d_average.npz", "anno_3d_collect.npz", "idxs.npy")),
            num_leaf=LEAF)
        gats_model = convert.gats_spg_from_jax(convert.init_gats_spg_params(
            rng))
        pipe = pipeline.PosePipeline(
            sp_model, gats_model, db, sp_config={**sp_conf,
                                                 "max_keypoints": K_PTS},
            gats_config={"match_threshold": 0.0}, num_hypotheses=HYP,
            device=self.dev)
        pose_out = pipe(images[:1, ..., None], K[None].astype(np.float32),
                        generator=torch.Generator(self.dev).manual_seed(3))
        stats["db_points"] = int(db.num_points)
        stats["frame_on_db"] = {"inliers": int(pose_out.num_inliers[0]),
                                "success": bool(pose_out.success[0])}
        self.check(db.num_points == res["num_points"] > 0 and bool(
            torch.isfinite(pose_out.poses).all()),
            f"sfm: load_object_db read the port's anno files "
            f"({db.num_points} points) and PosePipeline posed a frame on "
            f"them: {stats['frame_on_db']}")

        # tracks and the DLT timed apart, on the run's verified matches
        ver = triangulate.verify_matches(lay["feature_out"], lay["matches_out"],
                                         pair_list, *calib[:2], device=self.dev)
        t0 = time.perf_counter()
        tracks = triangulate.build_tracks(
            {n: len(ver[0][n]) for n in names}, ver[1])
        t1 = time.perf_counter()
        triangulate.triangulate_tracks(tracks, ver[0], *calib[:2],
                                       device=self.dev)
        torch.cuda.synchronize()
        stats["stage_ms"]["tracks"] = (t1 - t0) * 1e3
        stats["stage_ms"]["dlt"] = (time.perf_counter() - t1) * 1e3
        stats["tracks"] = len(tracks)

        # the match stage's busy share, over its first 16 pairs
        from onepose_tpu_torch.sfm import match

        stats["match_profile"], table = device_profile(
            lambda: match.match_pairs_to_h5(
                sg_model, pair_list[:16], lay["feature_out"],
                os.path.join(out, "profiled_matches.h5"), device=self.dev))
        with open(os.path.join(self.out_dir, "profile.txt"), "a") as f:
            f.write(f"\n== sfm match: {stats['match_profile']}\n{table}")
        log("   sfm ms: " + ", ".join(f"{k} {v:.1f}" for k, v in
                                      stats["stage_ms"].items())
            + f"; peak {stats['peak_gb']:.2f} GiB; match busy share "
            f"{stats['match_profile']['busy_share']:.3f}  [{self.smi}]")

        self.sfm_card_vs_cpu(sp_model, sg_model, names, images, pair_list[0],
                             out)

    def sfm_card_vs_cpu(self, sp_model, sg_model, names, images, pair, out):
        """11a's card-vs-CPU check on one pair: extract_to_h5 on both
        devices (keypoints by position, descriptors and scores at the same
        positions within 1e-5), then each side's SuperGlue on its own
        features under ``superglue.match_gate``."""
        from onepose_tpu_torch.utils import hdf5

        from onepose_tpu_torch.models import superglue
        from onepose_tpu_torch.sfm import extract, match

        stats = self.results["sfm_images"]["card_vs_cpu"] = {}
        idx = [names.index(n) for n in pair]
        imgs = {n: images[i] for n, i in zip(pair, idx)}
        sides = {}
        for side, dev in (("card", self.dev), ("cpu", torch.device("cpu"))):
            path = os.path.join(out, f"pair_feats_{side}.h5")
            extract.extract_to_h5(copy.deepcopy(sp_model), list(pair), path,
                                  images=imgs, device=dev)
            with hdf5.File(path, "r") as f:
                feats = {n: {k: f[n][k][()] for k in f[n]} for n in pair}
            data = {}
            for i, n in zip("01", pair):
                fe = feats[n]
                kp, sc, de, m = match._pad_feats(
                    fe["keypoints"], fe["scores"], fe["descriptors"].T,
                    match._bucket(len(fe["keypoints"])))
                data.update({f"keypoints{i}": kp, f"scores{i}": sc,
                             f"descriptors{i}": de, f"mask{i}": m})
            data = {k: torch.from_numpy(v[None]).to(dev)
                    for k, v in data.items()}
            data["shape0"] = data["shape1"] = (H, W)
            cfg = superglue.resolve_config(match.CONF)
            model = copy.deepcopy(sg_model).to(dev)
            Z = superglue.log_assignment(model, data, cfg)
            m0 = superglue.mutual_matches(Z, cfg["match_threshold"],
                                          data["mask0"], data["mask1"])
            sides[side] = (feats, m0.matches0.cpu(), Z.cpu(),
                           (data["keypoints0"].cpu(), data["keypoints1"].cpu()))
        (c_feats, c_m0, c_Z, c_kp), (h_feats, h_m0, h_Z, h_kp) = (
            sides["card"], sides["cpu"])
        same, d_err, s_err = True, 0.0, 0.0
        for n in pair:
            c, h = c_feats[n], h_feats[n]
            co = np.lexsort((c["keypoints"][:, 0], c["keypoints"][:, 1]))
            ho = np.lexsort((h["keypoints"][:, 0], h["keypoints"][:, 1]))
            same &= np.array_equal(c["keypoints"][co], h["keypoints"][ho])
            if same:
                d_err = max(d_err, float(np.abs(c["descriptors"][:, co]
                                                - h["descriptors"][:, ho]).max()))
                s_err = max(s_err, float(np.abs(c["scores"][co]
                                                - h["scores"][ho]).max()))
        gate = superglue.match_gate(c_m0, c_Z, h_m0, h_Z,
                                    match.CONF["match_threshold"], c_kp, h_kp)
        stats.update({"same_keypoint_positions": bool(same),
                      "descriptor_err": d_err, "score_err": s_err,
                      "gate": dataclasses.asdict(gate),
                      "matches": int((h_m0 >= 0).sum())})
        self.check(same and d_err < 1e-5 and s_err < 1e-5 and gate.ok,
                   f"sfm: card vs CPU on one pair: keypoints at the same "
                   f"positions {same}, descriptors within {d_err:.2e}, scores "
                   f"within {s_err:.2e} (1e-5); log assignments "
                   f"{gate.max_rel_diff:.2e} of their scale apart (gate "
                   f"{superglue.GATE_REL:.0e}), matches0 differ at {gate.diff} "
                   f"of {stats['matches']} matched rows, outside near-ties "
                   f"{gate.bad}")

    def sfm_features(self):
        """11b: SfM at the reference's scale from features (180 images,
        4,000 points, keypoints within the 4096 budget, covis-10 pairs):
        triangulation, postprocess and global BA (max_obs 65536) on the
        card."""
        import shutil

        from onepose_tpu_torch.sfm import global_ba, postprocess, triangulate
        from onepose_tpu_torch.utils import colmap_io
        from onepose_tpu_torch.utils.synthetic import ring_features

        stats = self.results["sfm_features"] = {}
        out = os.path.join(SFM_WORK, "features")
        shutil.rmtree(out, ignore_errors=True)
        os.makedirs(out)
        t0 = time.perf_counter()
        w = ring_features(out, np.random.default_rng(11))
        ms = {"features": (time.perf_counter() - t0) * 1e3}
        model_dir = os.path.join(out, "sfm_ws", "model")
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        tri = triangulate.triangulate_from_h5(
            w["feature_path"], w["match_path"], w["pair_list"], w["Ks"],
            w["poses"], w["sizes"], model_dir, verbose=False, device=self.dev)
        ms["triangulate"] = (time.perf_counter() - t0) * 1e3
        stats["triangulate_peak_gb"] = (torch.cuda.max_memory_allocated()
                                        / 2 ** 30)
        _, _, points3d = colmap_io.read_model(model_dir)
        xyz = np.stack([p.xyz for p in points3d.values()])
        d = np.sqrt(((xyz[:, None] - w["pts3d"][None]) ** 2).sum(-1)).min(1)
        stats["median_err_mm"] = float(np.median(d)) * 1e3
        t0 = time.perf_counter()
        pp = postprocess.postprocess(model_dir, w["feature_path"], w["names"],
                                     os.path.join(out, "anno"),
                                     max_num_points=2500)
        ms["postprocess"] = (time.perf_counter() - t0) * 1e3
        self.check(stats["median_err_mm"] < 2.0 and pp["num_points"] <= 2500
                   and tri["num_sparse_points"] >= 2500,
                   f"sfm features: {tri['num_sparse_points']} points, median "
                   f"{stats['median_err_mm']:.3f} mm from the truth (2 mm); "
                   f"postprocess kept {pp['num_points']} (<= 2500)")

        runs = []
        for i in range(2):
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            ba = global_ba.run_bundle_adjuster(
                model_dir, os.path.join(out, f"ba{i}"), device=self.dev)
            ms[f"bundle_adjust_{i}"] = (time.perf_counter() - t0) * 1e3
            stats[f"ba_peak_gb_{i}"] = (torch.cuda.max_memory_allocated()
                                        / 2 ** 30)
            runs.append((ba, [open(os.path.join(out, f"ba{i}", x), "rb").read()
                              for x in ("images.bin", "points3D.bin")]))
        (ba, bits0), (ba1, bits1) = runs
        stats["ba"] = ba
        stats["stage_ms"] = ms
        self.check(ba["final_cost"] < ba["initial_cost"] and bits0 == bits1
                   and ba == ba1 and stats["ba_peak_gb_0"] < 4.0,
                   f"sfm features: BA cost {ba['initial_cost']:.1f} -> "
                   f"{ba['final_cost']:.1f}, the same bits over two runs "
                   f"{bits0 == bits1}, peak {stats['ba_peak_gb_0']:.2f} GiB "
                   f"(< 4)")
        log("   sfm features ms: " + ", ".join(f"{k} {v:.1f}" for k, v in
                                               ms.items()) + f"  [{self.smi}]")

    # -- 12 ---------------------------------------------------------------
    def training(self):
        """12: the GATsSPG matcher trained at train_GATsSPG.yaml's width on
        the DB that 11a built (11a's ``sfm_capture``): the training and
        validation indices, then (a)-(d) of the module docstring."""
        import shutil

        from onepose_tpu_torch.datasets.merge import merge_anno

        stats = self.results["training"] = {}
        cap = self.sfm_capture
        work = os.path.join(SFM_WORK, "train")
        shutil.rmtree(work, ignore_errors=True)
        link = os.path.join(work, "sfm_model", "ring",
                            "outputs_superpoint_superglue")
        os.makedirs(os.path.dirname(link))
        os.symlink(cap["out"], link)
        merged = os.path.join(work, "all.json")
        stats["items"] = merge_anno(os.path.join(work, "sfm_model"),
                                    ["ring"], merged)
        with open(merged) as f:
            index = json.load(f)
        paths = {}
        for split, n in (("train", TRAIN_ITEMS), ("val", VAL_ITEMS)):
            paths[split] = os.path.join(work, f"{split}.json")
            with open(paths[split], "w") as f:
                json.dump({k: v[:n] for k, v in index.items()}, f)
        # the intrinsics and poses the validation reads beside each frame
        for name, pose in zip(cap["names"], cap["poses"]):
            for sub, arr in (("intrin_ba", cap["K"]),
                             ("poses_ba", np.vstack([pose, [0, 0, 0, 1]]))):
                path = name.replace("/color/", f"/{sub}/").replace(
                    ".png", ".txt")
                os.makedirs(os.path.dirname(path), exist_ok=True)
                np.savetxt(path, arr)
        self.check(stats["items"] >= TRAIN_ITEMS,
                   f"training: merge_anno indexed {stats['items']} frames of "
                   f"11a's capture (train on {TRAIN_ITEMS}, validate on "
                   f"{VAL_ITEMS})")
        self.train_paths, self.train_work = paths, work   # phase 14 (d)
        self.train_gather_vs_host(paths["train"], stats)
        self.train_card_vs_cpu(paths["train"], stats)
        self.train_timed(paths["train"], stats)
        self.train_entry(paths, work, stats)

    def train_gather_vs_host(self, train_json, stats):
        """12a: the gather path's batch on the card against the host
        path's dense batch, and leaves sampled on the card against the
        CPU's from the same uniforms: both exact."""
        from onepose_tpu_torch.datasets.gats_dataset import GATsSPGDataset
        from onepose_tpu_torch.train import trainer

        dm = TRAIN_YAML["datamodule"]
        bs, leaf, s2, s3 = (dm[k] for k in ("batch_size", "num_leaf",
                                            "shape2d", "shape3d"))
        kw = dict(num_leaf=leaf, shape2d=s2, shape3d=s3,
                  pad_val=dm["assign_pad_val"], seed=0)

        def dataset():
            return GATsSPGDataset(train_json, split="train", **kw)

        t0 = time.perf_counter()
        ds = dataset()
        db_np, obj_index = ds.device_db()
        self.train_db = (db_np, obj_index)
        host = next(dataset().batches(bs, seed=1, num_threads=1))
        stats["data_s"] = time.perf_counter() - t0
        keys = ("clt_stack", "avg_stack", "count_stack", "offset_stack")

        def materialize(light, dev):
            return trainer.materialize_light_batch(
                {k: torch.as_tensor(db_np[k], device=dev) for k in keys},
                {k: torch.as_tensor(v, device=dev) for k, v in light.items()},
                s2, s3, dm["assign_pad_val"], leaf)

        light = next(ds.light_batches(obj_index, db_np["t_max"], bs, seed=1))
        got = materialize(light, self.dev)
        diff = {k: int((got[k].cpu() != torch.from_numpy(host[k])).sum())
                for k in host if k in got}
        seeded = next(dataset().light_batches(
            obj_index, db_np["t_max"], bs, seed=1, on_device_leaves=True))
        seeded["leaf_uniform"] = trainer.leaf_uniforms(
            seeded.pop("leaf_seed"), leaf, s3)
        card = materialize(seeded, self.dev)
        cpu = materialize(seeded, torch.device("cpu"))
        leaf_diff = {k: int((card[k].cpu() != cpu[k]).sum()) for k in cpu}
        stats["gather"] = {"host_diff": diff, "leaf_card_vs_cpu": leaf_diff,
                           "clt_mb": db_np["clt_stack"].nbytes / 1e6,
                           "t_max": int(db_np["t_max"])}
        self.check(len(diff) == 4 and not any(diff.values())
                   and not any(leaf_diff.values()),
                   f"training (a): the gather path's batch on the card "
                   f"equals the host path's, elements apart {diff}; leaves "
                   f"sampled on the card equal the CPU's, apart "
                   f"{leaf_diff} ({stats['data_s']:.1f} s to read the data)")

    def train_card_vs_cpu(self, train_json, stats):
        """12b: one step (no accumulation) of the full model at batch 1 on
        11a's data, on the card and on the CPU from the same parameters and
        uniforms, each against an fp64 reference of the loss and gradients
        (on the CPU); then the card again with TF32 products allowed, a
        control the gate must refuse.

        At D=256 and 4 blocks fp32's gradients stand 2e-3 to 1e-2 of their
        largest entry from fp64 on the CPU too (random descriptors read the
        same): the mlp0 weights' gradients are sums over the tokens that
        instance norm makes cancel, around a message that linear attention
        makes nearly constant across tokens. So the card's loss is held
        within twice the CPU's fp32 error plus 1e-6, its gradients within
        TRAIN_GRAD_GATE of fp64 (which the TF32 control must exceed), and
        the parameters within what Adam makes of the gradients' measured
        disagreement δ: its first step is lr·ĝ/(|ĝ|+ε) of the clipped
        gradient ĝ, so an entry may move by lr·min(2, 2δ/(|ĝ|+ε)), plus
        2e-6 of rounding."""
        from onepose_tpu_torch.datasets.gats_dataset import GATsSPGDataset
        from onepose_tpu_torch.models import convert
        from onepose_tpu_torch.ops.precision import pin_fp32
        from onepose_tpu_torch.train import trainer

        dm = TRAIN_YAML["datamodule"]
        leaf, s2, s3 = dm["num_leaf"], dm["shape2d"], dm["shape3d"]
        cfg = train_gats_config()
        params = convert.init_gats_spg_params(np.random.default_rng(5), cfg)
        opt = {**train_optimizer_kwargs(1), "accumulate_steps": 1}
        cpu = torch.device("cpu")
        ds = GATsSPGDataset(train_json, split="train", num_leaf=leaf,
                            shape2d=s2, shape3d=s3, seed=0)
        db_np, obj_index = self.train_db
        light = next(ds.light_batches(obj_index, db_np["t_max"], 1, seed=2,
                                      on_device_leaves=True))
        light["leaf_uniform"] = trainer.leaf_uniforms(
            light.pop("leaf_seed"), leaf, s3)
        keys = ("clt_stack", "avg_stack", "count_stack", "offset_stack")

        def batch(dev):
            return trainer.materialize_light_batch(
                {k: torch.as_tensor(db_np[k], device=dev) for k in keys},
                {k: torch.as_tensor(v, device=dev) for k, v in light.items()},
                s2, s3, dm["assign_pad_val"], leaf)

        def step(dev):
            grads = []

            def keep(names, gs):
                grads.append([g.detach().cpu().double() for g in gs])
                return gs

            state = trainer.init_train_state(
                trainer.make_optimizer(**opt, grad_transforms=[keep]), cfg,
                model=convert.gats_spg_from_jax(params), device=dev)
            state, loss = trainer.train_step(state, batch(dev), cfg)
            return (float(loss), grads[0],
                    [p.detach().cpu() for p in state.model.parameters()])

        model = convert.gats_spg_from_jax(params).double()
        loss64 = trainer.compute_loss(model, batch(cpu), cfg)
        loss64.backward()
        ref_loss = loss64.item()
        ref = [p.grad for p in model.parameters()]
        scale = max(float(g.abs().max()) for g in ref)
        sides = {"card": step(self.dev), "cpu": step(cpu)}
        try:
            torch.backends.cuda.matmul.allow_tf32 = True
            torch.set_float32_matmul_precision("high")
            sides["card_tf32"] = step(self.dev)
        finally:
            pin_fp32()
        err = {side: {"loss": abs(v[0] / ref_loss - 1),
                      "grad": max(float((g - r).abs().max())
                                  for g, r in zip(v[1], ref)) / scale}
               for side, v in sides.items()}
        (_, g_card, p_card), (_, g_cpu, p_cpu) = (sides["card"],
                                                  sides["cpu"])
        delta = max(float((a - c).abs().max()) for a, c in zip(g_card, g_cpu))
        norm = float(torch.sqrt(sum((g ** 2).sum() for g in g_cpu)))
        clip = min(1.0, opt["grad_clip"] / norm)
        worst = p_err = 0.0
        for a, c, g in zip(p_card, p_cpu, g_cpu):
            bound = 2e-6 + opt["base_lr"] * torch.clamp(
                2 * delta * clip / (g.abs() * clip + 1e-8), max=2.0)
            worst = max(worst, float(((a - c).abs() / bound).max()))
            p_err = max(p_err, float((a - c).abs().max()))
        positives = int((batch(cpu)["conf_gt"] == 1).sum())
        stats["card_vs_cpu"] = {
            "shape": [1, s2, s3, leaf], "loss_fp64": ref_loss,
            "err_vs_fp64": err, "grad_delta": delta, "param_err": p_err,
            "bound_used": worst, "positives": positives}
        ok = (err["card"]["loss"] <= 2 * err["cpu"]["loss"] + 1e-6
              and err["card"]["grad"] < TRAIN_GRAD_GATE
              and err["card_tf32"]["grad"] > TRAIN_GRAD_GATE
              and worst <= 1.0 and positives > 0)
        self.check(ok, f"training (b): one step at [1,{s2},{s3}] on 11a's "
                   f"data ({positives} GT matches) against fp64: card loss "
                   f"{err['card']['loss']:.2e}, CPU {err['cpu']['loss']:.2e} "
                   f"(the card within 2x + 1e-6); gradients card "
                   f"{err['card']['grad']:.2e}, CPU {err['cpu']['grad']:.2e}"
                   f" of their largest (gate {TRAIN_GRAD_GATE:.0e}), the card "
                   f"with TF32 {err['card_tf32']['grad']:.2e} (must exceed "
                   f"it; loss {err['card_tf32']['loss']:.2e}); parameters "
                   f"{p_err:.2e} apart, {worst:.3f} of Adam's bound")

    def train_timed(self, train_json, stats):
        """12c: full-width micro-steps (the gather step: leaf sampling and
        conf_gt on the card, forward, backward, the optimizer) on one fixed
        batch, each timed by CUDA events after warm-up; the loss must be
        finite and fall."""
        from onepose_tpu_torch.datasets.gats_dataset import GATsSPGDataset
        from onepose_tpu_torch.train import trainer

        dm = TRAIN_YAML["datamodule"]
        bs, leaf, s2, s3 = (dm[k] for k in ("batch_size", "num_leaf",
                                            "shape2d", "shape3d"))
        db_np, obj_index = self.train_db
        ds = GATsSPGDataset(train_json, split="train", num_leaf=leaf,
                            shape2d=s2, shape3d=s3, seed=0)
        light = next(ds.light_batches(obj_index, db_np["t_max"], bs, seed=3,
                                      on_device_leaves=True))
        light["leaf_uniform"] = trainer.leaf_uniforms(
            light.pop("leaf_seed"), leaf, s3)
        light = {k: torch.as_tensor(v, device=self.dev)
                 for k, v in light.items()}
        cfg = train_gats_config()
        torch.cuda.reset_peak_memory_stats()
        state = trainer.init_train_state(
            trainer.make_optimizer(**train_optimizer_kwargs(
                max(self.results["training"]["items"] // bs, 1))),
            cfg, seed=0, device=self.dev)
        step = trainer.make_gather_train_step(
            cfg, {k: torch.as_tensor(db_np[k], device=self.dev) for k in (
                "clt_stack", "avg_stack", "count_stack", "offset_stack")},
            s2, s3, dm["assign_pad_val"], leaf)
        losses = []

        def micro():
            nonlocal state
            state, loss = step(state, light)
            losses.append(loss)

        ms = event_ms(micro, TRAIN_TIMED, TRAIN_WARMUP)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        prof, table = device_profile(micro)
        with open(os.path.join(self.out_dir, "profile.txt"), "a") as f:
            f.write(f"\n== train micro-step: {prof}\n{table}")
        losses = [float(x) for x in losses]
        med = float(np.median(ms))
        t = stats["timed"] = {
            "micro_step_ms": ms, "median_ms": med, "min_ms": min(ms),
            "max_ms": max(ms), "p10_ms": float(np.percentile(ms, 10)),
            "p90_ms": float(np.percentile(ms, 90)),
            "samples_per_s": bs * 1000.0 / med, "peak_gb": peak,
            "losses": losses, "updates": state.optimizer.updates,
            "profile": prof}
        falls = float(np.mean(losses[-4:])) < losses[0]
        self.check(all(np.isfinite(losses)) and falls,
                   f"training (c): {TRAIN_TIMED} micro-steps at batch {bs}, "
                   f"[{s2}]x[{s3}], leaf {leaf}: median {med:.3f} ms "
                   f"(p10 {t['p10_ms']:.3f}, p90 {t['p90_ms']:.3f}, min "
                   f"{t['min_ms']:.3f}, max {t['max_ms']:.3f}), "
                   f"{t['samples_per_s']:.1f} samples/s, peak {peak:.2f} "
                   f"GiB; busy share {prof['busy_share']:.3f}; loss "
                   f"{losses[0]:.4f} -> {losses[-1]:.4f} over "
                   f"{len(losses)} steps on one batch  [{self.smi}]")

    def train_entry(self, paths, work, stats):
        """12d: ``train/entry.train`` for an epoch at the yaml's width (its
        validation runs ``PosePipeline``: both kernels), then the epoch
        checkpoint read by ``load_gats_spg`` and a batch posed with it.
        The card's machine has no cv2: the validation reads the capture's
        frames from memory, and its match figures are counted, not
        drawn."""
        from onepose_tpu_torch import pipeline
        from onepose_tpu_torch.config import Config
        from onepose_tpu_torch.datasets import anno
        from onepose_tpu_torch.sfm import extract
        from onepose_tpu_torch.train import entry
        from onepose_tpu_torch.utils import model_io, vis_utils

        cap = self.sfm_capture
        sp_path = os.path.join(work, "superpoint.pth")
        torch.save(cap["sp_model"].state_dict(), sp_path)
        ckpts = os.path.join(work, "ckpts")
        def wrap(d):
            return Config({k: wrap(v) if isinstance(v, dict) else v
                           for k, v in d.items()})

        cfg = wrap({
            "type": "train", "seed": 0, "device": str(self.dev),
            "parallel": {"n_devices": 1},
            "model": {**TRAIN_YAML["model"], "spp_model_path": sp_path},
            "trainer": {**TRAIN_YAML["trainer"], "max_epochs": 1,
                        "log_every_n_steps": 1},
            "datamodule": {**TRAIN_YAML["datamodule"],
                           "train_anno_file": paths["train"],
                           "val_anno_file": paths["val"]},
            "checkpoint": {"dirpath": ckpts},
            "logging": {"log_dir": os.path.join(work, "logs"),
                        "wandb_project": None}})
        frames = dict(zip(cap["names"], cap["images"]))
        drawn = []
        saved = extract.load_gray, vis_utils.draw_matches
        extract.load_gray = lambda path, resize_hw=None: frames[path]
        vis_utils.draw_matches = lambda *a, **k: drawn.append(
            k.get("save_path"))
        t0 = time.perf_counter()
        try:
            state, metrics = self.path_launches("train",
                                                lambda: entry.train(cfg))
        finally:
            extract.load_gray, vis_utils.draw_matches = saved
        entry_s = time.perf_counter() - t0
        ckpt = model_io.latest_checkpoint(ckpts)
        model = model_io.load_gats_spg(ckpt)
        same = all(torch.equal(a, c.detach().cpu()) for a, c in zip(
            model.parameters(), state.model.parameters()))
        dm = TRAIN_YAML["datamodule"]
        db = anno.load_object_db(*(os.path.join(cap["out"], "anno", x) for x in (
            "anno_3d_average.npz", "anno_3d_collect.npz", "idxs.npy")),
            num_leaf=dm["num_leaf"])
        pipe = pipeline.PosePipeline(
            cap["sp_model"], model, db, gats_config=train_gats_config(),
            sp_config={"max_keypoints": K_PTS}, num_hypotheses=HYP,
            device=self.dev)
        Ks = np.broadcast_to(cap["K"].astype(np.float32), (B, 3, 3)).copy()
        gen = torch.Generator(device=self.dev).manual_seed(4)
        out = self.path_launches(
            "train-validate",
            lambda: pipe(cap["images"][:B, ..., None], Ks, generator=gen))
        finite = bool(torch.isfinite(out.poses).all())
        with open(os.path.join(work, "logs", "metrics.jsonl")) as f:
            logged = [json.loads(line) for line in f]
        stats["entry"] = {"s": entry_s, "checkpoint": os.path.basename(ckpt),
                          "steps": state.step,
                          "updates": state.optimizer.updates,
                          "metrics": metrics, "logged": logged,
                          "figures": len(drawn),
                          "validate_matches": out.num_matches.tolist()}
        self.check(same and finite and state.step == TRAIN_ITEMS // dm[
            "batch_size"] and {"train_loss", "5cm@5degree",
                               "val_f1/match_correct"} <= set(metrics),
                   f"training (d): the entry trained {state.step} "
                   f"micro-steps and validated in {entry_s:.1f} s, "
                   f"{os.path.basename(ckpt)} read by load_gats_spg "
                   f"(parameters equal {same}) and a batch of {B} posed with "
                   f"it (finite {finite}); metrics {metrics}")

    # -- 13 ---------------------------------------------------------------
    def bf16_preset(self):
        """13: SuperPoint's bf16 preset against fp32 at [8,512,512,1] (ring
        views of the textured plane): extract ms, stem launches, keypoint
        Jaccard; then the gate."""
        from onepose_tpu_torch.models import convert, superpoint
        from onepose_tpu_torch.utils.synthetic import ring_views

        stats = self.results["bf16_preset"] = {}
        rng = np.random.default_rng(13)
        sp_model = convert.superpoint_from_jax(
            convert.init_superpoint_params(rng)).to(self.dev)
        _, _, views = ring_views(rng, B, hw=H, focal=float(KMAT[0, 0]))
        images = torch.from_numpy(views[..., None]).to(self.dev)
        fp32 = {"max_keypoints": K_PTS, "nms_radius": 3}
        preset = {**fp32, **superpoint.entry_preset({})}
        before = launch_counts()["stem"]
        det16 = superpoint.extract(sp_model, images, preset)
        torch.cuda.synchronize()
        stem_launches = launch_counts()["stem"] - before
        det32 = superpoint.extract(sp_model, images, fp32)
        jac = [keypoint_jaccard(det32, det16, i) for i in range(B)]
        stats.update({
            "preset": preset, "stem_launches_in_preset": stem_launches,
            "extract_ms": {
                "fp32": cuda_ms(lambda: superpoint.extract(
                    sp_model, images, fp32), 10, 2),
                "preset": cuda_ms(lambda: superpoint.extract(
                    sp_model, images, preset), 10, 2)},
            "kpt_jaccard": jac})
        ms = stats["extract_ms"]
        self.check(stem_launches == 0 and bool(
            torch.isfinite(det16.descriptors).all()) and min(jac) > 0.5,
                   f"bf16 preset at [{B},{H},{W},1]: extract {ms['preset']:.3f}"
                   f" ms (fp32 with the stem kernel {ms['fp32']:.3f}), stem "
                   f"launches in the preset {stem_launches}, keypoint "
                   f"Jaccard against fp32 median {np.median(jac):.4f}, min "
                   f"{min(jac):.4f}  [{self.smi}]")
        self.bf16_gate(stats)

    def bf16_gate(self, stats):
        """13, ``scripts/stem_dtype_gate.py``'s rule on the card: per seed,
        ring views of the textured plane with known poses; a DB planted from
        each frame's fp32 keypoints (``planted_world``) and a GATsSPG that
        matches by descriptor self-similarity (``plant_gats_spg``); fp32
        with noise draws A and B (the solver's key-to-key floor) and the
        preset with draw A."""
        from onepose_tpu_torch import pipeline
        from onepose_tpu_torch.models import convert, superpoint
        from onepose_tpu_torch.ops import epnp
        from onepose_tpu_torch.utils import geometry as geo
        from onepose_tpu_torch.utils.synthetic import ring_views

        res = {k: [] for k in ("dr_bf16", "dt_bf16", "dr_floor", "dt_floor",
                               "kpt_jaccard", "match_jaccard")}
        buckets = {"fp32": [], "bf16": [], "floor": []}
        base = {"max_keypoints": GATE_KPTS, "nms_radius": 3}
        nb, leaf = GATE_FRAMES, 4
        for seed in range(GATE_SEEDS):
            rng = np.random.default_rng(100 + seed)
            sp_model = convert.superpoint_from_jax(
                convert.init_superpoint_params(rng)).to(self.dev)
            kmat, poses, views = ring_views(rng, nb, hw=GATE_HW, focal=230.0,
                                            arc_deg=40.0)
            images = views[..., None]
            det = superpoint.extract(sp_model, torch.from_numpy(images).to(
                self.dev), base)
            db, gats = planted_world(det, kmat, poses, rng, GATE_POINTS, leaf)
            kw = dict(num_hypotheses=HYP, refine_iters=5, device=self.dev)
            gats_model = convert.gats_spg_from_jax(gats)
            pipe32 = pipeline.PosePipeline(sp_model, gats_model, db,
                                           sp_config=base, **kw)
            pipe16 = pipeline.PosePipeline(
                sp_model, gats_model, db,
                sp_config={**base, **superpoint.entry_preset({})}, **kw)
            gen = torch.Generator().manual_seed(seed)
            noise_a, noise_b = (to_device(epnp.draw_noise(
                nb, GATE_KPTS, HYP, 64, gen), self.dev) for _ in range(2))
            Ks = np.broadcast_to(kmat.astype(np.float32), (nb, 3, 3)).copy()
            a = pipe32(images, Ks, noise=noise_a)
            floor = pipe32(images, Ks, noise=noise_b)
            b16 = pipe16(images, Ks, noise=noise_a)
            for i in range(nb):
                p = {n: o.poses[i].cpu().numpy() for n, o in (
                    ("fp32", a), ("floor", floor), ("bf16", b16))}
                dr, dt = geo.query_pose_error(p["bf16"], p["fp32"])
                fr, ft = geo.query_pose_error(p["floor"], p["fp32"])
                res["dr_bf16"].append(float(dr))
                res["dt_bf16"].append(float(dt))
                res["dr_floor"].append(float(fr))
                res["dt_floor"].append(float(ft))
                res["kpt_jaccard"].append(keypoint_jaccard(a, b16, i))
                res["match_jaccard"].append(match_jaccard(a, b16, i))
                for name, pose in p.items():
                    r, t = geo.query_pose_error(pose, poses[i])
                    buckets[name].append([bool(r < th and t < th)
                                          for th in (1.0, 3.0, 5.0)])

        def flips(name):
            return sum(x != y for u, v in zip(buckets["fp32"], buckets[name])
                       for x, y in zip(u, v))

        med = {k: float(np.median(v)) for k, v in res.items()}
        p95 = {k: float(np.percentile(v, 95)) for k, v in res.items()}
        rule = {
            "median": med["dr_bf16"] <= 2 * max(med["dr_floor"], 0.05),
            "p95": p95["dr_bf16"] <= 2 * max(p95["dr_floor"], 0.1),
            "flips": flips("bf16") <= max(flips("floor"), 1)}
        stats["gate"] = {
            "frames": len(res["dr_bf16"]), "median": med, "p95": p95,
            "flips_bf16": flips("bf16"), "flips_floor": flips("floor"),
            "cmd": {n: np.mean(v, 0).tolist() for n, v in buckets.items()},
            "rule": rule, "per_frame": res}
        self.check(all(rule.values()),
                   f"bf16 gate over {len(res['dr_bf16'])} frames: pose delta "
                   f"against fp32 median {med['dr_bf16']:.4f} / p95 "
                   f"{p95['dr_bf16']:.4f} deg, fp32's key-to-key floor "
                   f"{med['dr_floor']:.4f} / {p95['dr_floor']:.4f}; cmd "
                   f"bucket flips {flips('bf16')} (floor {flips('floor')}); "
                   f"keypoint Jaccard median {med['kpt_jaccard']:.4f}, match "
                   f"Jaccard median {med['match_jaccard']:.4f}; {rule}")

    # -- 14 ---------------------------------------------------------------
    def several_cards(self):
        """14: the paths over a world of ``max(2, cards)`` ranks, one card
        each (ranks share a card over gloo where there are fewer cards),
        each against one rank of the same inputs: (a) the pipeline at
        phase 7's shape on a planted DB, (b) serving 8 planted objects
        over a model axis of 2 and the multi-process server, (c) SfM
        extraction and matching of 16 of 11a's images, then (d) the train
        entry for an epoch of phase 12's data at ``n_devices`` = the world
        and (e) GATsSPG in bf16 at phase 7's width against fp32. Stage
        times by ``utils/profiling.Timer``; the ranks' launch counts of
        (a)-(c) are summed into the kernels line."""
        from onepose_tpu_torch.parallel import launch
        from onepose_tpu_torch.utils.profiling import Timer

        cards = torch.cuda.device_count()
        world = max(2, cards)
        backend = launch.pick_backend("cuda", world, cards)
        stats = self.results["several_cards"] = {
            "world": world, "backend": backend, "cards": cards}
        log(f"   world {world} ranks, backend {backend}, {cards} card(s)  "
            f"[{self.smi}]")
        timer = Timer()
        torch.cuda.empty_cache()
        with timer.scope("setup"):
            payload = cards_payload(self.sfm_capture, self.dev)
        with timer.scope("one rank"):
            one = drive_cards(payload, None, None, self.dev,
                              split=(world, world // 2))
        with timer.scope("world"):
            ranks = launch.run_local(several_cards_rank, world, payload,
                                     device="cuda", timeout=600)
        self.results.setdefault("launches", {})["several cards"] = launched = {
            k: sum(r["launches"][k] for r in ranks) for k in ("stem", "match")}
        stats["launches_per_rank"] = [r["launches"] for r in ranks]
        stats["backend_seen"] = [r["backend"] for r in ranks]
        self.check(all(launched[k] > 0 for k in launched)
                   and all(r["backend"] == backend for r in ranks),
                   f"several cards: the ranks ran {backend} and launched "
                   f"their kernels {stats['launches_per_rank']}")
        self.cards_compare(one, ranks, stats)
        with timer.scope("train entry"):
            self.cards_train_entry(world, stats)
        with timer.scope("bf16 matcher"):
            self.cards_bf16(stats)
        stats["ms"] = {"one rank pipeline batch": one["pipeline_ms"],
                       "world pipeline batch": [r["pipeline_ms"]
                                                for r in ranks]}
        stats["timer"] = timer.summary()
        log("   stage s: " + ", ".join(f"{k} {v['total_s']:.1f}" for k, v
                                       in stats["timer"].items()))

    def cards_compare(self, one, ranks, stats):
        """14 (a)-(c): every rank's whole-batch outputs against one
        rank's on the same rows (matches and success equal, poses within
        1e-6) and against one rank's batch of 8 (poses within phase 8's
        1e-4, the matches that differ being those one rank's own calls on
        the ranks' rows differ in), the planted poses recovered; the
        multi-process server's results equal to one process's; the
        world's HDF5 files (rank 0's) equal to one rank's by keypoint
        position."""
        from onepose_tpu_torch.utils import geometry as geo

        res = stats["compare"] = {}
        for r in ranks:
            for path in ("pipeline", "serving"):
                got, rows, whole = r[path], one[path + "_rows"], one[path]

                def apart(a, b):
                    return (int((a["matches0"] != b["matches0"]).sum()),
                            float(np.abs(a["poses"] - b["poses"]).max()),
                            bool((a["success"] == b["success"]).all()))

                same, whole_d, own_d = (apart(got, rows), apart(got, whole),
                                        apart(rows, whole))
                res.setdefault(path, []).append({
                    "vs_same_rows": same, "vs_whole_batch": whole_d,
                    "one_rank_rows_vs_whole_batch": own_d})
                # the same rows: the same arithmetic, so the same bits; the
                # whole batch of 8: cuBLAS takes other paths at other row
                # counts, and one rank's own calls on the ranks' rows part
                # from its batch of 8 at the same slots
                self.check(same[0] == 0 and same[1] <= 1e-6 and same[2]
                           and whole_d[0] == own_d[0] and whole_d[1] <= 1e-4
                           and whole_d[2],
                           f"several cards ({path}) rank {r['rank']}: "
                           f"against one rank on the same rows matches0 "
                           f"differ at {same[0]} slots, poses by "
                           f"{same[1]:.2e}; against one rank's batch of {B} "
                           f"at {whole_d[0]} slots (one rank's own calls on "
                           f"these rows at {own_d[0]}), poses by "
                           f"{whole_d[1]:.2e}")
        # the pipeline's one DB is planted for frame 0 (the first frame to
        # claim a point keeps it); each served object for its own frame
        gt = one["poses_gt"]
        for path, frames in (("pipeline", 1), ("serving", B)):
            errs = [geo.query_pose_error(p, g) for p, g in zip(
                ranks[0][path]["poses"][:frames], gt[:frames])]
            res[path + "_vs_planted"] = errs
            self.check(all(r < POSE_DEG and t < POSE_CM for r, t in errs)
                       and bool(ranks[0][path]["success"][:frames].all()),
                       f"several cards ({path}): planted poses of "
                       f"{frames} frame(s) within "
                       f"{POSE_DEG} deg / {POSE_CM} cm, worst "
                       f"{max(e[0] for e in errs):.4f} deg, "
                       f"{max(e[1] for e in errs):.4f} cm")
        root = ranks[0]["multihost"]
        same = len(root) == len(one["multihost"]) and all(
            a["success"] == b["success"] and a["num_inliers"] ==
            b["num_inliers"] and (a["pose"] is None or float(np.abs(
                a["pose"] - b["pose"]).max()) <= 1e-4)
            for a, b in zip(root, one["multihost"]))
        self.check(same and all(r["multihost"] == [] for r in ranks[1:])
                   and all(r["served"] == 2 for r in ranks),
                   f"several cards: the multi-process server's "
                   f"{len(root)} results equal one process's; every rank "
                   f"served {[r['served'] for r in ranks]} batches")
        ok, n_kpts, n_matches = sfm_equal_by_position(
            one["sfm_dir"], ranks[0]["sfm_dir"], one["names"], one["pairs"])
        res["sfm"] = {"keypoints": n_kpts, "matches": n_matches}
        self.check(ok and n_kpts > 0 and n_matches > 0,
                   f"several cards (SfM): extraction and matching of "
                   f"{len(one['names'])} images and {len(one['pairs'])} "
                   f"pairs equal to one rank's by position ({n_kpts} "
                   f"keypoints, {n_matches} matches)")

    def cards_train_entry(self, world, stats):
        """14 (d): the train entry for an epoch of phase 12's data at
        ``parallel.n_devices`` = the world (it spawns its ranks; no
        validation: the frames live in this process only); rank 0's
        checkpoint read by ``load_gats_spg`` equals the state returned,
        and the logged losses are phase 12 (d)'s one-process ones."""
        import shutil

        from onepose_tpu_torch.config import Config
        from onepose_tpu_torch.train import entry
        from onepose_tpu_torch.utils import model_io

        work = os.path.join(SFM_WORK, "train_cards")
        shutil.rmtree(work, ignore_errors=True)

        def wrap(d):
            return Config({k: wrap(v) if isinstance(v, dict) else v
                           for k, v in d.items()})

        cfg = wrap({
            "type": "train", "seed": 0, "device": "cuda",
            "parallel": {"n_devices": world},
            "model": {**TRAIN_YAML["model"],
                      "spp_model_path": os.path.join(work, "missing.pth")},
            "trainer": {**TRAIN_YAML["trainer"], "max_epochs": 1,
                        "log_every_n_steps": 1},
            "datamodule": {**TRAIN_YAML["datamodule"],
                           "train_anno_file": self.train_paths["train"],
                           "val_anno_file": os.path.join(work, "none.json")},
            "checkpoint": {"dirpath": os.path.join(work, "ckpts")},
            "logging": {"log_dir": os.path.join(work, "logs"),
                        "wandb_project": None}})
        t0 = time.perf_counter()
        state, metrics = entry.train(cfg)
        entry_s = time.perf_counter() - t0
        ckpt = model_io.latest_checkpoint(cfg.checkpoint.dirpath)
        loaded = model_io.load_gats_spg(ckpt)
        same = all(torch.equal(a, b.detach().cpu()) for a, b in zip(
            loaded.parameters(), state.model.parameters()))
        logs = {}
        for tag, d in (("world", work), ("one", self.train_work)):
            with open(os.path.join(d, "logs", "metrics.jsonl")) as f:
                logs[tag] = [(r["step"], r["train_loss"]) for r in map(
                    json.loads, f) if "train_loss" in r]
        rel = max(abs(a[1] - b[1]) / abs(b[1]) for a, b in zip(
            logs["world"], logs["one"]))
        stats["train_entry"] = {"s": entry_s, "checkpoint": ckpt,
                                "files": sorted(os.listdir(
                                    cfg.checkpoint.dirpath)),
                                "losses": logs, "max_rel_loss_diff": rel,
                                "metrics": metrics}
        self.check(same and [s for s, _ in logs["world"]] == [
            s for s, _ in logs["one"]] and rel <= 1e-5
                   and stats["train_entry"]["files"] == [
                       "epoch=0.ckpt", "last.ckpt"],
                   f"several cards (train entry): {world} ranks trained "
                   f"{state.step} micro-steps in {entry_s:.1f} s, rank 0's "
                   f"{os.path.basename(ckpt)} read by load_gats_spg "
                   f"(parameters equal {same}), losses within {rel:.1e} of "
                   f"phase 12's one process")

    def cards_bf16(self, stats):
        """14 (e): GATsSPG with ``compute_dtype="bfloat16"`` at phase 7's
        width ([8,1024] query x [8,2000] DB tokens, leaf 8, D=256, 4
        blocks) on a planted world (``planted_world``: matching by
        descriptor self-similarity) against fp32: match Jaccard, the
        descriptors' RMS gap, the match kernel launched, and ms of the
        match stage (GNN and kernel) in each mode."""
        from onepose_tpu_torch.models import convert, gats_spg, superpoint
        from onepose_tpu_torch.utils.synthetic import ring_views

        rng = np.random.default_rng(15)
        sp_model = convert.superpoint_from_jax(
            convert.init_superpoint_params(rng)).to(self.dev)
        kmat, poses, views = ring_views(rng, B, hw=H,
                                        focal=float(KMAT[0, 0]),
                                        arc_deg=40.0)
        det = superpoint.extract(sp_model, torch.from_numpy(
            views[..., None]).to(self.dev), {"max_keypoints": K_PTS,
                                             "nms_radius": 3})
        db, gats = planted_world(det, kmat, poses, rng, SHAPE3D // B, LEAF)
        model = convert.gats_spg_from_jax(gats).to(self.dev).eval()
        t = lambda x: torch.as_tensor(np.asarray(x)).to(self.dev)  # noqa
        n2 = len(db.keypoints3d)
        data = {"descriptors2d_query": det.descriptors,
                "descriptors3d_db": t(db.descriptors3d).expand(B, n2, -1),
                "descriptors2d_db": t(db.descriptors2d_db).expand(
                    B, n2 * LEAF, -1),
                "mask2d": det.mask, "mask3d": t(db.mask3d).expand(B, n2)}
        out, ms, desc = {}, {}, {}
        for dtype in ("float32", "bfloat16"):
            cfg = {"match_threshold": 0.0, "compute_dtype": dtype}
            before = launch_counts()["match"]
            out[dtype] = gats_spg.forward_match_only(model, data, cfg)
            torch.cuda.synchronize()
            launched = launch_counts()["match"] - before
            with torch.no_grad():
                desc[dtype] = gats_spg.gnn_body(
                    model, data, gats_spg.resolve_config(cfg))
            ms[dtype] = cuda_ms(lambda: gats_spg.forward_match_only(
                model, data, cfg), 5, 1)
        jac = []
        for i in range(B):
            sets = [{(k, m) for k, m in enumerate(o.matches0[i].tolist())
                     if m >= 0} for o in out.values()]
            jac.append(len(sets[0] & sets[1]) / max(len(sets[0] | sets[1]),
                                                    1))
        rms = float(torch.sqrt(torch.mean(torch.stack([
            (a - b).square().mean() for a, b in zip(
                desc["bfloat16"], desc["float32"])]))))
        finite = all(bool(torch.isfinite(d).all()) and d.dtype ==
                     torch.float32 for d in desc["bfloat16"])
        stats["bf16"] = {"ms": ms, "match_jaccard": jac, "rms_gap": rms,
                         "matches": [int((o.matches0 >= 0).sum())
                                     for o in out.values()]}
        self.check(finite and launched == 1 and float(np.median(jac)) > 0.5,
                   f"several cards (bf16 GATsSPG): match Jaccard against "
                   f"fp32 median {np.median(jac):.4f}, min {min(jac):.4f}; "
                   f"descriptor RMS gap {rms:.2e}; match stage "
                   f"{ms['bfloat16']:.3f} ms in bf16, {ms['float32']:.3f} "
                   f"ms in fp32  [{self.smi}]")

    # -- 15 ---------------------------------------------------------------
    def token_axis(self):
        """15: GATsSPG's 3D tokens sharded over the model axis of a
        (world/2, 2) mesh, the world ``max(2, cards)`` ranks as in phase
        14, each path against one rank on the same rows: (a) the pipeline
        at phase 7's shape, the DB planted for frame 0; (b) the matcher
        at [2,256] x [2,4096] tokens, leaf 8, 4 blocks, and the match
        kernel at that shape on the ranks' gathered descriptors against
        its plain version; (c) the dense train step at the dryrun's
        protocol shape (b=8, n1=1000, n2=2000, leaf 8, 4 blocks). Every
        rank's launches of (a) and (b) go into the kernels line; ms a
        batch and peak memory a rank beside one rank's."""
        from onepose_tpu_torch.parallel import launch

        cards = torch.cuda.device_count()
        world = max(2, cards)
        backend = launch.pick_backend("cuda", world, cards)
        stats = self.results["token_axis"] = {
            "world": world, "mesh": (world // 2, 2), "backend": backend}
        log(f"   world {world} ranks on a ({world // 2}, 2) mesh, backend "
            f"{backend}, {cards} card(s)  [{self.smi}]")
        torch.cuda.empty_cache()
        sp_model, gats_model, pipe_db, _, images = cards_world()
        poses_gt, points = plant_pipeline(
            sp_model, gats_model, pipe_db, images,
            np.random.default_rng(CARDS_SEED + 1), self.dev)
        one = drive_tokens(points, None, self.dev, world // 2)
        ranks = launch.run_local(tokens_rank, world, points, device="cuda",
                                 timeout=600)
        self.results.setdefault("launches", {})["token axis"] = launched = {
            k: sum(r["launches"][k] for r in ranks) for k in ("stem", "match")}
        stats["launches_per_rank"] = [r["launches"] for r in ranks]
        probe = [r["probe"] for r in ranks]
        stats["collectives"] = probe[0]
        self.check(all(launched[k] > 0 for k in launched)
                   and all(r["backend"] == backend for r in ranks)
                   and all(p["ok"] for p in probe),
                   f"token axis: the ranks ran {backend}, took CUDA tensors "
                   f"in every collective under autograd ({probe[0]['ops']}; "
                   f"{probe[0]['staged']} staged through the host) and "
                   f"launched {stats['launches_per_rank']}")
        heads = [r for r in ranks if r["model_index"] == 0]
        self.tokens_pipeline(one, ranks, heads, poses_gt, stats)
        self.tokens_matcher(one, heads, stats)
        self.tokens_train(one, ranks, stats)
        stats["ms"] = {k: {"one rank": one[k + "_ms"],
                           "ranks": [r[k + "_ms"] for r in ranks]}
                       for k in ("pipeline", "train")}
        stats["peak_gib"] = {k: {"one rank": one[k + "_gib"],
                                 "ranks": [r[k + "_gib"] for r in ranks]}
                             for k in ("pipeline", "train")}
        for k in ("pipeline", "train"):
            log(f"   {k}: ms a batch one rank {one[k + '_ms']:.1f}, ranks "
                f"{[round(r[k + '_ms'], 1) for r in ranks]}; peak GiB one "
                f"rank {one[k + '_gib']:.2f}, ranks "
                f"{[round(r[k + '_gib'], 2) for r in ranks]}  [{self.smi}]")

    def tokens_pipeline(self, one, ranks, heads, poses_gt, stats):
        """15 (a): every rank's whole-batch outputs against one rank's on
        the same rows: matches equal outside relative near-ties (one
        rank's conf on those rows, ``match_gate``'s rule), success
        equal, poses within 1e-4; the planted pose of frame 0."""
        from onepose_tpu_torch.ops import match
        from onepose_tpu_torch.utils import geometry as geo

        res = stats["pipeline"] = []
        for r in ranks:
            got, ref = r["pipeline"], one["pipeline"]
            diff, bad = near_tie_flips(one["pipeline_conf"],
                                       got["matches0"], ref["matches0"],
                                       match.GATE_REL)
            dpose = float(np.abs(got["poses"] - ref["poses"]).max())
            same = bool((got["success"] == ref["success"]).all())
            res.append({"rank": r["rank"], "matches_differ": diff,
                        "outside_near_ties": bad, "poses": dpose,
                        "success_equal": same, "held": r["held"]})
            self.check(bad == 0 and same and dpose <= 1e-4
                       and r["held"]["descriptors3d"] == SHAPE3D // 2
                       and r["held"]["keypoints3d"] == SHAPE3D,
                       f"token axis (a) rank {r['rank']}: DB rows held "
                       f"{r['held']}; against one rank on the same rows "
                       f"matches0 differ at {diff} slots ({bad} outside "
                       f"near-ties), success equal {same}, poses by "
                       f"{dpose:.2e}")
        err = geo.query_pose_error(heads[0]["pipeline"]["poses"][0],
                                   poses_gt[0])
        stats["planted_frame0"] = err
        self.check(err[0] < POSE_DEG and err[1] < POSE_CM
                   and bool(heads[0]["pipeline"]["success"][0]),
                   f"token axis (a): frame 0's planted pose within "
                   f"{POSE_DEG} deg / {POSE_CM} cm: {err[0]:.4f} deg, "
                   f"{err[1]:.4f} cm")

    def tokens_matcher(self, one, heads, stats):
        """15 (b): the matcher's outputs, reassembled over the data axis,
        against one rank's (matches equal outside near-ties, scores of
        the slots that match alike within rtol 1e-4, atol 1e-6), and the
        match kernel on the ranks' gathered descriptors against its
        plain version under ``match_gate``, with both times and the
        bound."""
        from onepose_tpu_torch.ops import match

        got = {k: np.concatenate([r["matcher"][k] for r in heads])
               for k in heads[0]["matcher"]}
        ref = one["matcher"]
        flips = {}
        for name, dim in (("matches0", 2), ("matches1", 1)):
            flips[name] = near_tie_flips(ref["conf"], got[name], ref[name],
                                         match.GATE_REL, dim)
        alike = got["matches0"] == ref["matches0"]
        score = float(np.abs(got["scores0"] - ref["scores0"])[alike].max())
        close = np.allclose(got["scores0"][alike], ref["scores0"][alike],
                            rtol=1e-4, atol=1e-6)
        b, n1, n2, _ = TOKENS_MATCHER.values()
        d0, d1 = (torch.from_numpy(got[k]).to(self.dev) for k in ("m0", "m1"))
        out = match.dual_softmax_argmax(d0, d1, 0.07)
        torch.cuda.synchronize()
        gate = match.match_gate(out, d0, d1, 0.07)
        ms = cuda_ms(lambda: match.dual_softmax_argmax(d0, d1, 0.07))
        plain_ms = cuda_ms(lambda: match.match_reference(d0, d1, 0.07))
        bound_ms, bound_by = match_bound_ms(b, n1, n2, 256)
        key = f"[{b},{n1},256]x[{b},{n2},256] gathered"
        self.results.setdefault("match", {})[key] = {
            **dataclasses.asdict(gate), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}
        stats["matcher"] = {"flips": flips, "max_score_diff": score,
                            "matches": int((ref["matches0"] >= 0).sum())}
        self.check(all(bad == 0 for _, bad in flips.values()) and close,
                   f"token axis (b): the matcher at [{b},{n1}] x "
                   f"[{b},{n2}] tokens against one rank: (differ, outside "
                   f"near-ties) {flips}, scores by {score:.2e}")
        self.check(gate.ok,
                   f"token axis (b): match {key}: max rel err "
                   f"{gate.max_rel_err:.3e} (gate {match.GATE_REL:.0e}), "
                   f"index mismatches outside near-ties {gate.bad_idx}; "
                   f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
                   f"{bound_ms:.4f} ms ({bound_by})  [{self.smi}]")

    def tokens_train(self, one, ranks, stats):
        """15 (c): the first step's gradients (summed over the world)
        within rtol 1e-3 and atol 1e-3·max|g| of one rank's (the dryrun's
        rule), two steps' losses within rtol 1e-4, and every rank's
        parameters after them bit-equal."""
        ref, got = one["train"], ranks[0]["train"]
        scale = max(float(np.abs(g).max()) for g in ref["grads"].values())
        g64 = ref["grads64"]
        scale64 = max(float(np.abs(g).max()) for g in g64.values())
        vs64 = {who: max(float(np.abs(g[k] - g64[k]).max()) for k in g64)
                / scale64 for who, g in (("one rank", ref["grads"]),
                                         ("world", got["grads"]))}
        worst = max(float((np.abs(got["grads"][k] - g) - 1e-3 * np.abs(g))
                          .max()) for k, g in ref["grads"].items())
        rel = [abs(a - b) / abs(b) for a, b in zip(got["losses"],
                                                   ref["losses"])]
        same = all(np.array_equal(r["train"]["params"], got["params"])
                   for r in ranks[1:])
        stats["train"] = {"losses": got["losses"], "one_rank": ref["losses"],
                          "loss_rel": rel, "grad_excess": worst,
                          "grad_scale": scale, "vs_fp64_of_max": vs64}
        self.check(worst <= 1e-3 * scale and max(rel) <= 1e-4 and same,
                   f"token axis (c): the dense train step at {TOKENS_TRAIN}: "
                   f"gradients within rtol 1e-3 + "
                   f"{1e-3 * scale:.2e} of one rank's (excess over rtol "
                   f"{worst:.2e}), losses {got['losses']} against "
                   f"{ref['losses']} (rel {max(rel):.1e}), ranks' "
                   f"parameters bit-equal {same}; fp32 against fp64, of the "
                   f"largest entry: one rank {vs64['one rank']:.2e}, the "
                   f"world {vs64['world']:.2e}")

    # -- 16 ---------------------------------------------------------------
    def pnp_stages(self):
        """16: ``ransac_pnp``'s cumulative stage prefixes on the card at
        scripts/profile_pnp.py's protocol shape (B=8, N=1024, 35% inliers,
        512 hypotheses, LO 64, refine 5), one injected noise for every
        prefix: median ms of 10 calls after 3 warm-up by CUDA events
        around the call (dispatch included: PnP is host-bound; the
        prefixes in turns), busy ms,
        device ops and host waits of one profiled call, and each prefix's
        increment. The full prefix bit-equal to ``profile_prefix=None``,
        every prefix on the card against the CPU on a small scene (B=2,
        N=128) with the same noise, and the full solve's pose within
        phase 5's bound."""
        from onepose_tpu_torch.ops import epnp
        from onepose_tpu_torch.utils import geometry as geo

        stats = self.results["pnp_stages"] = {"shape": [PNP_B, PNP_N],
                                              "card": self.smi}
        t = lambda x: torch.from_numpy(x).to(self.dev)  # noqa: E731
        k2, k3, msk, Ks, pose_gt = pnp_profile_scene(PNP_B, PNP_N)
        args = tuple(t(x) for x in (k2, k3, msk, Ks))
        noise = epnp.draw_noise(PNP_B, PNP_N, HYP, 64, torch.Generator(
            self.dev).manual_seed(16), self.dev)

        def solve(prefix, args=args, noise=noise):
            return epnp.ransac_pnp(*args, reproj_threshold=5.0,
                                   num_hypotheses=HYP, refine_iters=5,
                                   noise=noise, profile_prefix=prefix)

        # the prefixes timed in turns, so that the host's drift between
        # calls falls on each of them alike
        times = {p: [] for p in epnp.PROFILE_PREFIXES}
        for prefix in times:
            event_ms(lambda: solve(prefix), 0, 3)
        for _ in range(10):
            for prefix in times:
                times[prefix] += event_ms(lambda: solve(prefix), 1, 0)
        rows, prev = {}, 0.0
        for prefix in epnp.PROFILE_PREFIXES:
            ms = float(np.median(times[prefix]))
            prof, table = device_profile(lambda: solve(prefix))
            rows[prefix] = {"ms": ms, "increment_ms": ms - prev,
                            "spread_ms": [min(times[prefix]),
                                          max(times[prefix])],
                            "busy_ms": prof["busy_ms"],
                            "device_ops": prof["device_ops"],
                            "host_syncs": prof["host_syncs"]}
            prev = ms
            with open(os.path.join(self.out_dir, "profile.txt"), "a") as f:
                f.write(f"\n== pnp prefix {prefix}: {prof}\n{table}")
        stats["prefixes"] = rows
        for prefix, r in rows.items():
            log(f"   pnp {prefix:6s} {r['ms']:8.3f} ms "
                f"(+{r['increment_ms']:8.3f}), busy {r['busy_ms']:.3f} ms, "
                f"{r['device_ops']} "
                f"device ops, {r['host_syncs']} host waits  [{self.smi}]")

        full, whole = solve("full"), solve(None)
        same = all(torch.equal(a, b) for a, b in zip(full, whole))
        self.check(same, "pnp stages: the full prefix bit-equal to "
                   "profile_prefix=None")
        errs = [geo.query_pose_error(full.pose[b].cpu().numpy(), pose_gt)
                for b in range(PNP_B)]
        stats["full_pose_err"] = errs
        self.check(all(r < POSE_DEG and c < POSE_CM for r, c in errs),
                   f"pnp stages: the full solve recovers the scene's pose "
                   f"within {POSE_DEG} deg / {POSE_CM} cm: worst "
                   f"{max(e[0] for e in errs):.4f} deg, "
                   f"{max(e[1] for e in errs):.4f} cm")
        self.pnp_card_vs_cpu(stats)

    def pnp_card_vs_cpu(self, stats):
        """16: every prefix on the card and on the CPU, a small scene of
        the same kind (B=2, N=128) with the same injected noise: poses
        within 1e-4, inlier counts and masks equal."""
        from onepose_tpu_torch.ops import epnp

        k2, k3, msk, Ks, _ = pnp_profile_scene(2, 128)
        noise = epnp.draw_noise(2, 128, HYP, 64,
                                torch.Generator().manual_seed(16))
        cpu = tuple(torch.from_numpy(x) for x in (k2, k3, msk, Ks))
        rows = {}
        for prefix in epnp.PROFILE_PREFIXES:
            res = {}
            for side, dev in (("card", self.dev), ("cpu", torch.device(
                    "cpu"))):
                res[side] = epnp.ransac_pnp(
                    *(x.to(dev) for x in cpu), reproj_threshold=5.0,
                    num_hypotheses=HYP, refine_iters=5,
                    noise=to_device(noise, dev), profile_prefix=prefix)
            a, b = (epnp.PnPResult(*(x.cpu() for x in res[s]))
                    for s in ("card", "cpu"))
            rows[prefix] = {
                "pose_diff": float((a.pose - b.pose).abs().max()),
                "counts": [a.num_inliers.tolist(), b.num_inliers.tolist()],
                "masks_equal": bool(torch.equal(a.inliers, b.inliers))}
        stats["card_vs_cpu"] = rows
        self.check(all(r["pose_diff"] <= 1e-4 and r["masks_equal"]
                       and r["counts"][0] == r["counts"][1]
                       for r in rows.values()),
                   "pnp stages: card vs CPU at B=2, N=128 (pose max diff, "
                   "masks equal): " + ", ".join(
                       f"{p} {r['pose_diff']:.1e} {r['masks_equal']}"
                       for p, r in rows.items()))

    # -- 17 ---------------------------------------------------------------
    def eval_entry(self):
        """17: ``python -m onepose_tpu_torch.eval_real``'s ``main`` end to
        end on a synthetic capture in the dataset layout, SfM not skipped:
        the SfM step (``run.sfm``: the stem kernel in ``extract_to_h5``,
        SuperGlue planted on the views' descriptors) builds the object's
        annos, then ``inference.inference`` at test_sample's width (the
        entries' bf16 preset, which skips the stem; the match kernel)
        evaluates the held-out views; the metrics appended to a baseline
        under ``--out``. Weights random from seeds, written as the
        reference's checkpoint files."""
        import shutil

        from onepose_tpu_torch import eval_real
        from onepose_tpu_torch.models import convert
        from onepose_tpu_torch.utils.synthetic import write_checkpoints

        stats = self.results["eval_entry"] = {"card": self.smi}
        shutil.rmtree(EVAL_WORK, ignore_errors=True)
        data = os.path.join(EVAL_WORK, "data")
        rng = np.random.default_rng(17)
        sp_model, sg_params = write_eval_capture(data, rng, self.dev)
        write_checkpoints(data, sp_model, sg_params, convert.gats_spg_from_jax(
            convert.init_gats_spg_params(rng)))

        # the baseline and the reports go to --out, each run's own
        baseline = os.path.join(self.out_dir, "BASELINE_eval_entry.md")
        eval_dir = os.path.join(self.out_dir, "eval_entry")
        shutil.rmtree(eval_dir, ignore_errors=True)
        if os.path.exists(baseline):
            os.remove(baseline)
        # SfM keeps up to sfm_spp_spg_sample's 2500 points (this capture
        # gives 2362), more than test_sample's shape3d of 2000: the entry
        # pads such an object's DB to a multiple of 8 above its count
        overrides = [f"data_dir={data}", f"output.eval_dir={eval_dir}",
                     "print_config=False"]
        cwd = os.getcwd()
        try:
            rc = self.path_launches("eval_entry", lambda: eval_real.main(
                ["--experiments", "test_sample", "--baseline-out", baseline,
                 "-o", *overrides]))
            rc_missing = eval_real.main(
                ["--check", "--experiments", "test_sample", "-o",
                 f"data_dir={EVAL_WORK}/missing", "print_config=False"])
        finally:
            os.chdir(cwd)
        # the appended section: the metric rows, and the stages' seconds
        # on its "Stage times: sfm 36.6 s, inference 0.9 s (card)" line
        text = open(baseline).read()
        metrics = {k: float(v) for k, v in (
            line.strip("| ").split(" | ") for line in text.splitlines()
            if line.startswith("| cmd"))}
        times = text.split("Stage times: ")[-1].split(" (")[0]
        seconds = {k: float(v) for k, v in (
            t.split()[:2] for t in times.split(", "))}
        report = os.path.join(eval_dir, f"{EVAL_OBJECT}{EVAL_SEQ}.txt")
        idxs = glob.glob(os.path.join(data, "sfm_model", "*", "outputs_*",
                                      "anno", "idxs.npy"))
        stats.update(rc=rc, rc_check_missing=rc_missing, metrics=metrics,
                     stage_s=seconds, report=os.path.exists(report),
                     db_points=[len(np.load(f)) for f in idxs],
                     launches=self.results["launches"]["eval_entry"])
        log(f"   eval entry: rc {rc}, {metrics}, stages " + ", ".join(
            f"{k} {v:.1f} s" for k, v in seconds.items())
            + f", launches {stats['launches']}  [{self.smi}]")
        self.check(rc == 0 and set(metrics) == {"cmd1", "cmd3", "cmd5"}
                   and all(0.0 <= v <= 1.0 for v in metrics.values())
                   and stats["report"] and set(seconds) == {"sfm",
                                                            "inference"},
                   f"eval entry: rc {rc}, cmd1/3/5 {metrics} in [0, 1], "
                   f"report written {stats['report']}, SfM and inference "
                   f"run ({sorted(seconds)})")
        self.check(rc_missing == 1,
                   f"eval entry: --check against a missing data_dir "
                   f"returns {rc_missing} (want 1)")
        self.check(len(idxs) == 1 and stats["db_points"][0] > SHAPE3D,
                   f"eval entry: the object's {stats['db_points']} points "
                   f"evaluated uncapped, more than shape3d {SHAPE3D}")

    # -- 18 ---------------------------------------------------------------
    def entries(self):
        """18: the measurement entries in this process on the card, each
        through its ``run`` as its ``main`` calls it: ``bench`` at its
        protocol in full (the gate off, the load it read recorded),
        ``profile_stages`` in full, ``bench_serving`` at 81 objects then
        ``--latency`` at 8 objects over 48 requests a point,
        ``bench_tracker`` at 12 frames with ``--breakdown``,
        ``bench_train`` at its defaults, and the demo chain on a short
        raw capture. Launch counts zeroed around each driven path."""
        import shutil

        from onepose_tpu_torch import (bench, bench_serving, bench_tracker,
                                       bench_train, profile_stages)

        stats = self.results["entries"] = {"card": self.smi, "reduced": {
            "bench_serving --latency": "8 objects (default 81), 48 requests "
                                       "a point (default 240)",
            "bench_tracker": "12 frames (default 24), --breakdown",
            "demo_pipeline": f"a synthetic capture: {DEMO_VIEWS[0]} "
                             f"annotate views, {DEMO_VIEWS[1]} test frames",
        }}
        shutil.rmtree(ENTRIES_WORK, ignore_errors=True)

        # bench: the protocol, the bf16 preset (the match kernel only)
        load1 = bench.host_load()
        out = stats["bench"] = self.path_launches(
            "entry_bench", lambda: bench.run(load1=load1),
            kernels=("match",))
        log("   bench: " + json.dumps(out))
        st = out["stages"]
        parts = st["extract_ms"] + st["match_ms"] + st["pnp_ms"]
        ref_ms = self.results.get("protocol", {}).get("total_ms")
        self.check(set(out) == BENCH_KEYS and not nonfinite(out)
                   and out["mfu"] is not None
                   and self.results["launches"]["entry_bench"]["stem"] == 0,
                   f"bench: keys, finite values, mfu {out['mfu']}, no stem "
                   "launch in the preset")
        self.check(abs(parts - st["total_ms"]) <= 0.05 * st["total_ms"],
                   f"bench: stages sum {parts:.2f} ms within 5% of total "
                   f"{st['total_ms']:.2f}")
        self.check(ref_ms is None or st["total_ms"] <= 2 * ref_ms,
                   f"bench: total {st['total_ms']:.2f} ms within 2x of phase "
                   f"7's {ref_ms}  [{self.smi}]")

        out = stats["profile_stages"] = self.path_launches(
            "entry_profile_stages",
            lambda: profile_stages.run(log=lambda m: log("   " + m)))
        self.check(list(out["rows"]) == PROFILE_ROWS
                   and not nonfinite(out),
                   f"profile_stages: {len(out['rows'])} rows, finite  "
                   f"[{self.smi}]")

        for name, argv, kw in (
                ("bench_serving", [], {}),
                ("bench_serving_latency", [
                    "--n-objects", "8", "--latency", "--latency-requests",
                    "48"], {})):
            args = bench_serving.parser().parse_args(argv)
            out = stats[name] = self.path_launches(
                f"entry_{name}", lambda: bench_serving.run(
                    args, log=lambda m: log("   " + m), **kw))
            log(f"   {name}: " + json.dumps(out))
            keys = SERVING_LATENCY_KEYS if args.latency else SERVING_KEYS
            self.check(set(out) == keys and not nonfinite(out),
                       f"{name}: keys, finite values  [{self.smi}]")
        catalog = stats["bench_serving"]["catalog_mb"]
        self.check(abs(catalog - 1494) <= 2, f"bench_serving: catalog "
                   f"{catalog} MB at 81 objects (about 1,494)")

        args = bench_tracker.parser().parse_args(["--frames", "12",
                                                  "--breakdown"])
        out = stats["bench_tracker"] = bench_tracker.run(
            args, log=lambda m: log("   " + m))
        log("   bench_tracker: " + json.dumps(out))
        self.check(set(out) == TRACKER_KEYS and not nonfinite(out)
                   and out["r_err_deg_max"] < TRACK_DEG
                   and out["t_err_cm_max"] < TRACK_CM,
                   f"bench_tracker: keys, finite values, errors "
                   f"{out['r_err_deg_max']} deg / {out['t_err_cm_max']} cm "
                   f"within phase 10a's {TRACK_DEG} / {TRACK_CM}  "
                   f"[{self.smi}]")

        out = stats["bench_train"] = bench_train.run(
            os.path.join(ENTRIES_WORK, "train"),
            log=lambda m: log("   " + m))
        self.check(set(out) == TRAIN_KEYS and not nonfinite(out),
                   f"bench_train: keys, finite values  [{self.smi}]")

        self.demo_chain(stats)

    def demo_chain(self, stats):
        """18: ``python -m onepose_tpu_torch.demo_pipeline``'s ``main`` on
        a raw capture of the textured plane under ``ENTRIES_WORK`` (mp4v
        video through cv2, ARKit poses, the box), the weights written as
        phase 17 writes them (SuperGlue planted on the annotate views'
        descriptors): parse, SfM (the stem kernel), the demo (the match
        kernel; the entry's bf16 preset skips the stem)."""
        import cv2

        from onepose_tpu_torch import demo_pipeline
        from onepose_tpu_torch.models import convert, superpoint
        from onepose_tpu_torch.sfm import extract
        from onepose_tpu_torch.utils import synthetic

        rng = np.random.default_rng(18)
        demo = os.path.join(ENTRIES_WORK, "data", "demo")
        cap = synthetic.raw_capture(os.path.join(demo, DEMO_OBJECT),
                                    DEMO_OBJECT, rng, *DEMO_VIEWS)
        video = cv2.VideoCapture(os.path.join(
            demo, DEMO_OBJECT, f"{DEMO_OBJECT}-annotate", "Frames.m4v"))
        n_video = int(video.get(cv2.CAP_PROP_FRAME_COUNT))
        video.release()
        sp = convert.superpoint_from_jax(convert.init_superpoint_params(
            np.random.default_rng(0)))
        conf = {k: v for k, v in extract.CONFS["superpoint"]["conf"].items()
                if k != "descriptor_dim"}
        views = cap[f"{DEMO_OBJECT}-annotate"][1][::5]
        det = superpoint.extract(sp.to(self.dev), torch.from_numpy(
            views[..., None].astype(np.float32)).to(self.dev), conf)
        synthetic.write_checkpoints(
            os.path.join(ENTRIES_WORK, "data"), sp.cpu(),
            convert.plant_superglue(convert.init_superglue_params(rng), det,
                                    0.0),
            convert.gats_spg_from_jax(convert.init_gats_spg_params(rng)))
        t0 = time.perf_counter()
        self.path_launches("entry_demo_pipeline", lambda: demo_pipeline.main(
            [DEMO_OBJECT, "--data-root", demo, "-o",
             f"work_dir={ENTRIES_WORK}", "print_config=False"]))
        anno = os.path.join(ENTRIES_WORK, "data", "sfm_model", DEMO_OBJECT,
                            "outputs_superpoint_superglue", "anno",
                            "idxs.npy")
        n_points = len(np.load(anno)) if os.path.exists(anno) else 0
        out_dir = os.path.join(ENTRIES_WORK, "runs", "demo", "demo")
        stats["demo_pipeline"] = {
            "s": time.perf_counter() - t0, "video_frames": n_video,
            "db_points": n_points,
            "outputs": sorted(os.listdir(out_dir)) if os.path.isdir(
                out_dir) else []}
        log("   demo_pipeline: " + json.dumps(stats["demo_pipeline"]))
        self.check(n_video == DEMO_VIEWS[0] and n_points > 0
                   and "demo_video.mp4" in stats["demo_pipeline"]["outputs"],
                   f"demo_pipeline: {n_video} video frames, a DB of "
                   f"{n_points} points, the demo's video written")

    # -- 19 ---------------------------------------------------------------
    def batch_rows(self):
        """19: does a frame's extraction and matching depend on the rows
        batched with it? Phase 7's models, DB and frames, fp32, the first 4
        frames at batch 4 and inside batch 8: every aten op's tensor
        outputs (and the two kernels') fingerprinted by the sum of their
        bits, each 4-row output against the first half of its 8-row twin;
        the first op that differs, and how far apart the final outputs are
        (the bound the card gives; on the CPU both packages give the same
        bits, tests/test_torch_repairs.py)."""
        from onepose_tpu_torch import pipeline
        from onepose_tpu_torch.models import gats_spg, superpoint
        from onepose_tpu_torch.utils.synthetic import random_db

        rng = np.random.default_rng(0)
        sp_model, gats_model = random_models(rng)
        db = random_db(rng, points=SHAPE3D - 8, shape3d=SHAPE3D, leaf=LEAF,
                       obs=(LEAF, LEAF * 3))
        pipe = pipeline.PosePipeline(
            sp_model, gats_model, db, sp_config={"max_keypoints": K_PTS},
            gats_config={"match_threshold": 0.0}, device=self.dev)
        images = torch.from_numpy(
            rng.uniform(0, 1, (B, H, W, 1)).astype(np.float32)).to(self.dev)

        def traced(rows):
            trace = RowTrace()
            stem, match = superpoint.fused_stem, gats_spg.dual_softmax_argmax
            superpoint.fused_stem = trace.wrap("fused_stem (kernel)", stem)
            gats_spg.dual_softmax_argmax = trace.wrap(
                "dual_softmax_argmax (kernel)", match)
            try:
                with torch.no_grad(), trace:
                    det = pipe.extract(images[:rows])
                    m = pipe.match(det)
            finally:
                superpoint.fused_stem = stem
                gats_spg.dual_softmax_argmax = match
            torch.cuda.synchronize()
            return trace, (det.keypoints[:4], det.descriptors[:4],
                           det.scores[:4], m.matches0[:4],
                           m.matching_scores0[:4])

        four, out4 = traced(4)
        eight, out8 = traced(B)
        again, out8b = traced(B)
        first, compared = four.first_difference(eight)
        names = ("keypoints", "descriptors", "scores", "matches0",
                 "matching_scores0")
        gap = {n: float((a.double() - b.double()).abs().max())
               for n, a, b in zip(names, out4, out8)}
        gap["matches0_slots_differ"] = int((out4[3] != out8[3]).sum())
        gap["keypoints_equal"] = bool(torch.equal(out4[0], out8[0]))
        repeat = all(torch.equal(a, b) for a, b in zip(out8, out8b)) and \
            eight.first_difference(again, halves=False)[0] is None
        stats = self.results["batch_rows"] = {
            "ops": [len(four.ops), len(eight.ops)], "compared": compared,
            "first_difference": first, "final_gap": gap,
            "eight_rows_repeat": repeat, "card": self.smi}
        log(f"   batch rows: {json.dumps(stats)}")
        self.check(repeat, "batch rows: the 8-row call repeats its bits")
        self.check(len(four.ops) == len(eight.ops) and compared > 0,
                   f"batch rows: the same {len(four.ops)} ops at 4 and 8 "
                   f"rows, {compared} compared; first difference: {first}")
        # the bound PERF.md states: the rows part at an aten op (cuDNN's
        # algorithm by batch), never inside the two kernels, and the
        # matches by at most BATCH_ROWS_MAX_SLOTS of B/2·K_PTS slots
        self.check(first is None or "(kernel)" not in first,
                   f"batch rows: the first difference is not a kernel's "
                   f"({first})")
        self.check(gap["matches0_slots_differ"] <= BATCH_ROWS_MAX_SLOTS,
                   f"batch rows: {gap['matches0_slots_differ']} match slots "
                   f"differ, at most {BATCH_ROWS_MAX_SLOTS}")

    def kernels_line(self):
        st = self.results.get("stem", {}).get(str((B, H, W, 1)), {})
        mt = self.results.get("match", {}).get(
            f"[{B},{K_PTS},256]x[{B},{SHAPE3D},256] random", {})
        # launches of the main paths (every phase's that drives one)
        launches = {k: sum(p.get(k, 0) for p in
                           self.results.get("launches", {}).values())
                    for k in ("stem", "match")}
        # no single PyTorch call computes either function (the stem is two
        # convs, two ReLUs and a pool; the match an einsum, two softmaxes
        # and two argmaxes), so library_ms is null
        return {"kernels": [
            {"name": "fused_stem", "route": "cuda",
             "source": "onepose_tpu_torch/csrc/stem.cu",
             "replaces": "onepose_tpu/ops/pallas_stem.py:133",
             "launches": launches.get("stem", 0),
             "max_abs_err": st.get("max_abs_err"), "ms": st.get("ms"),
             "plain_ms": st.get("plain_ms"), "bound_ms": st.get("bound_ms"),
             "bound_by": st.get("bound_by"), "library_ms": None},
            {"name": "dual_softmax_argmax", "route": "cuda",
             "source": "onepose_tpu_torch/csrc/match.cu",
             "replaces": "onepose_tpu/ops/pallas_match.py:113",
             "launches": launches.get("match", 0),
             "max_abs_err": mt.get("max_abs_err"), "ms": mt.get("ms"),
             "plain_ms": mt.get("plain_ms"), "bound_ms": mt.get("bound_ms"),
             "bound_by": mt.get("bound_by"), "library_ms": None},
        ]}


CARDS_SEED = 14
CARDS_SFM_IMAGES = 16


def cards_world(planted=None):
    """14's models, the pipeline's DB, the serving catalog and the
    frames, rebuilt from ``CARDS_SEED`` in every process; ``planted``
    replaces the DBs' 3D points with the planted ones."""
    from onepose_tpu_torch.utils.synthetic import random_db

    rng = np.random.default_rng(CARDS_SEED)
    sp_model, gats_model = random_models(rng)
    kw = dict(points=SHAPE3D - 8, shape3d=SHAPE3D, leaf=LEAF,
              obs=(LEAF, LEAF * 3))
    pipe_db = random_db(rng, **kw)
    serve_dbs = {f"obj{i}": random_db(rng, **kw) for i in range(N_OBJECTS)}
    images = rng.uniform(0, 1, (B, H, W)).astype(np.float32)
    if planted is not None:
        pipe_db = dataclasses.replace(pipe_db, keypoints3d=planted["pipe"])
        serve_dbs = {n: dataclasses.replace(
            db, keypoints3d=planted.get(n, db.keypoints3d))
            for n, db in serve_dbs.items()}
    return sp_model, gats_model, pipe_db, serve_dbs, images


def cards_noise(dev):
    from onepose_tpu_torch.ops import epnp

    return epnp.draw_noise(B, K_PTS, HYP, 64, torch.Generator(
        device=dev).manual_seed(CARDS_SEED), dev)


def cards_payload(capture, dev) -> dict:
    """What every rank of phase 14 gets: the planted 3D points (the
    frames' one-rank matches back-projected under known poses), 16 of
    11a's frames with a SuperGlue planted on their descriptors, and the
    poses planted."""
    from onepose_tpu_torch import serving
    from onepose_tpu_torch.models import convert, superpoint
    from onepose_tpu_torch.sfm import extract

    sp_model, gats_model, pipe_db, serve_dbs, images = cards_world()
    rng = np.random.default_rng(CARDS_SEED + 1)
    poses_gt, pipe_points = plant_pipeline(sp_model, gats_model, pipe_db,
                                           images, rng, dev)
    planted = {"pipe": pipe_points}
    noise = cards_noise(dev)
    kw = dict(sp_config={"max_keypoints": K_PTS},
              gats_config={"match_threshold": 0.0}, num_hypotheses=HYP,
              refine_iters=5, device=dev)
    reqs = cards_requests(images)
    first = serving.PoseServer(sp_model, gats_model, serve_dbs,
                               batch_size=B, **kw).run(reqs, noise)
    for b, r in enumerate(reqs):
        planted[r.object_name] = plant_geometry(
            serve_dbs[r.object_name], first.matches0[b:b + 1],
            first.keypoints2d[b:b + 1], KMAT, poses_gt[b:b + 1],
            rng).keypoints3d
    names = capture["names"][:CARDS_SFM_IMAGES]
    sfm_images = capture["images"][:CARDS_SFM_IMAGES]
    sp_conf = {k: v for k, v in extract.CONFS["superpoint"]["conf"].items()
               if k != "descriptor_dim"}
    det = superpoint.extract(capture["sp_model"].to(dev), torch.from_numpy(
        sfm_images[..., None]).to(dev), sp_conf)
    sg = convert.plant_superglue(convert.init_superglue_params(rng), det, 0.0)
    return {"planted": planted, "poses_gt": poses_gt, "names": names,
            "sfm_images": sfm_images, "sg": sg,
            "pairs": [(names[i], names[(i + 1 + i % 3) % len(names)])
                      for i in range(len(names))]}


def plant_pipeline(sp_model, gats_model, pipe_db, images, rng, dev):
    """B known poses drawn from ``rng`` and the pipeline DB's 3D points
    planted for them (``plant_geometry``) on one rank's matches of the
    frames under ``cards_noise``: frame 0 claims its points first."""
    from onepose_tpu_torch import pipeline
    from onepose_tpu_torch.utils import geometry as geo

    poses_gt = [np.concatenate([geo.rodrigues(rng.normal(size=3) * 0.3),
                                np.array([[0.0], [0.0], [0.5]])], 1)
                for _ in range(B)]
    first = pipeline.PosePipeline(
        sp_model, gats_model, pipe_db, sp_config={"max_keypoints": K_PTS},
        gats_config={"match_threshold": 0.0}, num_hypotheses=HYP,
        refine_iters=5, device=dev)(
            images[..., None], np.broadcast_to(KMAT, (B, 3, 3)).copy(),
            noise=cards_noise(dev))
    return poses_gt, plant_geometry(pipe_db, first.matches0,
                                    first.keypoints2d, KMAT, poses_gt,
                                    rng).keypoints3d


def cards_requests(images):
    """One request per object, in the order that sends half the batch to
    objects held by the other model shard."""
    from onepose_tpu_torch import serving

    order = [0, 5, 2, 7, 4, 1, 6, 3]
    return [serving.PoseRequest(f"obj{order[b]}", images[b], KMAT)
            for b in range(B)]


def drive_cards(payload, mesh_data, mesh_serve, dev, split=(1, 1)) -> dict:
    """Phase 14's paths (a)-(c) in this process: one rank without meshes,
    a rank of the world with them. Outputs on the host; launch counts of
    the one drive of the paths; the pipeline's mean ms a batch over 3
    calls after it (``Timer``). One rank also runs the pipeline and the
    serve step on the rows each rank of the world gets (the batch in
    ``split`` calls: the world's data-axis sizes of the two meshes)."""
    from onepose_tpu_torch import pipeline, serving
    from onepose_tpu_torch.models import convert
    from onepose_tpu_torch.parallel import collectives as comm
    from onepose_tpu_torch.parallel import serve_launch
    from onepose_tpu_torch.sfm import extract, match
    from onepose_tpu_torch.utils.profiling import Timer

    sp_model, gats_model, pipe_db, serve_dbs, images = cards_world(
        payload["planted"])
    noise = cards_noise(dev)
    Ks = np.broadcast_to(KMAT, (B, 3, 3)).copy()
    kw = dict(sp_config={"max_keypoints": K_PTS},
              gats_config={"match_threshold": 0.0}, num_hypotheses=HYP,
              refine_iters=5, device=dev)
    pipe = pipeline.PosePipeline(sp_model, gats_model, pipe_db,
                                 mesh=mesh_data, **kw)
    server_kw = dict(batch_size=B, seed=CARDS_SEED, **kw)
    server = serving.PoseServer(sp_model, gats_model, serve_dbs,
                                mesh=mesh_serve, **server_kw)
    reqs = cards_requests(images)
    batches = [reqs, reqs[::-1][:5]]
    sfm_dir = os.path.join(SFM_WORK, "cards",
                           "one" if mesh_data is None else "world")
    os.makedirs(sfm_dir, exist_ok=True)
    sg_model = convert.superglue_from_jax(payload["sg"])
    sp_sfm = convert.superpoint_from_jax(convert.init_superpoint_params(
        np.random.default_rng(0)))    # 11a's extractor
    feats = os.path.join(sfm_dir, "feats.h5")
    saved = launch_counts()
    set_launch_counts({k: 0 for k in saved})
    out = {"pipeline": pipe(images[..., None], Ks, noise=noise),
           "serving": server.run(reqs, noise)}
    if mesh_serve is None:
        out["multihost"] = [r for b in batches for r in
                            serving.PoseServer(sp_model, gats_model,
                                               serve_dbs, **server_kw)
                            .infer_batch(b)]
        out["served"] = len(batches)
    else:
        multi = serve_launch.MultiHostPoseServer(
            sp_model, gats_model, serve_dbs, mesh=mesh_serve, **server_kw)
        out["multihost"], queue = [], iter(batches)
        root = comm.is_main_process()
        out["served"] = serve_launch.serve_forever(
            multi, (H, W), next_batch=(lambda: next(queue, None)) if root
            else None, deliver=out["multihost"].extend if root else None)
    extract.extract_to_h5(sp_sfm, payload["names"], feats,
                          images=dict(zip(payload["names"],
                                          payload["sfm_images"])),
                          device=dev, mesh=mesh_data)
    match.match_pairs_to_h5(sg_model, payload["pairs"], feats,
                            os.path.join(sfm_dir, "matches.h5"),
                            device=dev, mesh=mesh_data)
    torch.cuda.synchronize()
    out["launches"] = launch_counts()
    set_launch_counts({k: saved[k] + out["launches"][k] for k in saved})
    for path in ("pipeline", "serving"):
        out[path] = {k: v.cpu().numpy() for k, v in out[path]._asdict().items()
                     if k in ("poses", "success", "matches0", "num_inliers")}
    if mesh_data is None:   # the arithmetic of each rank's rows
        def by_rows(run, per):
            outs = [run(slice(i, i + per)) for i in range(0, B, per)]
            return {k: np.concatenate([getattr(o, k).cpu().numpy()
                                       for o in outs])
                    for k in ("poses", "success", "matches0")}

        def rows_noise(s):
            return type(noise)(*(x[s] for x in noise))

        per = B // split[0]
        out["pipeline_rows"] = by_rows(lambda s: pipe(
            images[s, ..., None], Ks[s], noise=rows_noise(s)), per)
        per = B // split[1]
        server_rows = serving.PoseServer(sp_model, gats_model, serve_dbs,
                                         **{**server_kw, "batch_size": per})
        out["serving_rows"] = by_rows(lambda s: server_rows.run(
            reqs[s], rows_noise(s)), per)
    pipe(images[..., None], Ks, noise=noise)    # warm-up
    timer = Timer()
    for _ in range(3):
        with timer.scope("pipeline"):
            pipe(images[..., None], Ks, noise=noise)
            torch.cuda.synchronize()
    out["pipeline_ms"] = timer.summary()["pipeline"]["mean_ms"]
    out.update(sfm_dir=sfm_dir, names=payload["names"],
               pairs=payload["pairs"], poses_gt=payload["poses_gt"])
    return out


def several_cards_rank(payload) -> dict:
    """One rank of phase 14's world: (a)-(c) over a data mesh of the
    whole world and a serving mesh with a model axis of 2."""
    import torch.distributed as dist

    from onepose_tpu_torch.ops.precision import pin_fp32
    from onepose_tpu_torch.parallel import collectives as comm
    from onepose_tpu_torch.parallel import mesh as pmesh

    pin_fp32()
    world = comm.get_world_size()
    dev = torch.device("cuda", torch.cuda.current_device())
    out = drive_cards(payload, pmesh.make_mesh(world),
                      pmesh.make_mesh(world, (world // 2, 2)), dev)
    out.update(rank=comm.get_rank(), backend=dist.get_backend())
    return out


TOKENS_SEED = 16
TOKENS_MATCHER = {"b": 2, "n1": 256, "n2": 4096, "leaf": 8}
TOKENS_TRAIN = {"b": 8, "n1": 1000, "n2": 2000, "leaf": 8}
# random weights score no pair above the trained 0.2: every mutual pair
# matches at 0, so that (b) compares matches
TOKENS_MATCH_CFG = {"match_threshold": 0.0}


def tokens_matcher_data():
    """15 (b)'s inputs: tests/test_mp4.py::test_matcher_mp4_shape3d_4096's
    shapes and masks, from ``TOKENS_SEED``, and GATsSPG at full width."""
    from onepose_tpu_torch.models import convert

    rng = np.random.default_rng(TOKENS_SEED)
    b, n1, n2, leaf = TOKENS_MATCHER.values()
    mask2d = np.ones((b, n1), bool)
    mask2d[:, n1 - 17:] = False
    mask3d = np.ones((b, n2), bool)
    mask3d[:, n2 - 33:] = False
    data = {"descriptors2d_query": rng.normal(size=(b, n1, 256)),
            "descriptors3d_db": rng.normal(size=(b, n2, 256)),
            "descriptors2d_db": rng.normal(size=(b, n2 * leaf, 256)),
            "mask2d": mask2d, "mask3d": mask3d}
    data = {k: torch.from_numpy(v.astype(np.float32) if v.dtype ==
                                np.float64 else v) for k, v in data.items()}
    return convert.gats_spg_from_jax(convert.init_gats_spg_params(rng)), data


def tokens_train_batch():
    """15 (c)'s batch: the dryrun's (``__graft_entry__._dryrun_impl``)
    shapes and positive rate, from ``TOKENS_SEED`` + 1."""
    rng = np.random.default_rng(TOKENS_SEED + 1)
    b, n1, n2, leaf = TOKENS_TRAIN.values()
    batch = {"descriptors2d_query": rng.normal(size=(b, n1, 256)),
             "descriptors3d_db": rng.normal(size=(b, n2, 256)),
             "descriptors2d_db": rng.normal(size=(b, n2 * leaf, 256))}
    batch = {k: torch.from_numpy(v.astype(np.float32))
             for k, v in batch.items()}
    batch["conf_gt"] = torch.from_numpy(
        (rng.uniform(size=(b, n1, n2)) < 0.002).astype(np.int32))
    return batch


def near_tie_flips(conf, a, b, rel, dim=2):
    """(entries where the matches ``a`` and ``b`` differ, those outside
    relative near-ties): under ``match_gate``'s rule an entry may differ
    where its own conf row (``dim`` 2: a query's row; 1: a DB point's
    column) has a top-2 gap below ``rel`` x its top-1, or where the
    conf line of either side's match has (the mutual check reads it)."""
    conf = torch.as_tensor(conf)
    top = conf.topk(2, dim=2).values
    row_tie = (top[..., 0] - top[..., 1]) < rel * top[..., 0]
    top = conf.topk(2, dim=1).values
    col_tie = (top[:, 0] - top[:, 1]) < rel * top[:, 0]
    own, other = (row_tie, col_tie) if dim == 2 else (col_tie, row_tie)
    a, b = torch.as_tensor(a).long(), torch.as_tensor(b).long()
    ok = own.clone()
    for m in (a, b):
        ok |= (m >= 0) & torch.gather(other, 1, m.clamp(min=0))
    diff = a != b
    return int(diff.sum()), int((diff & ~ok).sum())


def drive_tokens(points, mesh, dev, n_data=1) -> dict:
    """Phase 15's paths in this process: a rank of the world with
    ``mesh``, one rank without it, which runs (a) and (b) on each of the
    ``n_data`` data ranks' rows (so on the rows each rank runs) and (c)
    on the whole batch. Outputs on the host; launch counts of one drive
    of (a) and (b); ms a pipeline batch and a train step (3 calls after a
    warm-up, ``Timer``) and the peak memory of each path."""
    from onepose_tpu_torch import pipeline
    from onepose_tpu_torch.models import gats_spg
    from onepose_tpu_torch.parallel import collectives as comm
    from onepose_tpu_torch.parallel import mesh as pmesh
    from onepose_tpu_torch.utils.profiling import Timer

    sp_model, gats_model, pipe_db, _, images = cards_world(
        {"pipe": points})
    noise = cards_noise(dev)
    Ks = np.broadcast_to(KMAT, (B, 3, 3)).copy()
    pipe = pipeline.PosePipeline(
        sp_model, gats_model, pipe_db, sp_config={"max_keypoints": K_PTS},
        gats_config={"match_threshold": 0.0}, num_hypotheses=HYP,
        refine_iters=5, device=dev, mesh=mesh)
    model, data = tokens_matcher_data()
    model = model.to(dev).eval()
    group = pmesh.token_group(mesh, TOKENS_MATCHER["n2"])
    out = {"held": {k: len(v) for k, v in pipe.db.items()}}

    def matcher(rows):
        local = {k: v[rows].to(dev) for k, v in data.items()}
        local.update(pmesh.token_shard(mesh, TOKENS_MATCHER["n2"], {
            k: local[k] for k in ("descriptors3d_db", "descriptors2d_db",
                                  "mask3d")}, dim=1))
        got = gats_spg.forward_match_only(model, local, TOKENS_MATCH_CFG,
                                          group)
        with torch.no_grad():
            m0, m1 = gats_spg.gnn_body(
                model, local, gats_spg.resolve_config(TOKENS_MATCH_CFG),
                group)
            if group is not None:
                m1 = comm.all_gather_cat(m1, 1, group)
        return {"matches0": got.matches0, "matches1": got.matches1,
                "scores0": got.matching_scores0, "m0": m0, "m1": m1}

    def stack(parts):
        return {k: np.concatenate([p[k].cpu().numpy() for p in parts])
                for k in parts[0]}

    def rows_noise(s):
        return type(noise)(*(x[s] for x in noise))

    torch.cuda.reset_peak_memory_stats()
    saved = launch_counts()
    set_launch_counts({k: 0 for k in saved})
    if mesh is not None:
        res = pipe(images[..., None], Ks, noise=noise)
        out["pipeline"] = {k: getattr(res, k).cpu().numpy() for k in (
            "poses", "success", "matches0")}
        out["pipeline_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        out["matcher"] = stack([matcher(pmesh.data_rows(
            mesh, TOKENS_MATCHER["b"]))])
    else:
        per = B // n_data
        parts = [pipe(images[i:i + per, ..., None], Ks[i:i + per],
                      noise=rows_noise(slice(i, i + per)))
                 for i in range(0, B, per)]
        out["pipeline"] = {k: np.concatenate([getattr(p, k).cpu().numpy()
                                              for p in parts])
                           for k in ("poses", "success", "matches0")}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()   # one rank's batch of 8
        pipe(images[..., None], Ks, noise=noise)
        out["pipeline_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        per = TOKENS_MATCHER["b"] // n_data
        out["matcher"] = stack([matcher(slice(i, i + per)) for i in range(
            0, TOKENS_MATCHER["b"], per)])
    torch.cuda.synchronize()
    out["launches"] = launch_counts()
    set_launch_counts({k: saved[k] + out["launches"][k] for k in saved})
    if mesh is None:   # what the near-tie rule reads: one rank's conf
        with torch.no_grad():
            det = pipe.extract(torch.from_numpy(images[..., None]).to(dev))
            rows = pipe.rows(B)
            m0, m1 = gats_spg.gnn_body(pipe.gats_model, {
                "descriptors2d_query": det.descriptors,
                "descriptors3d_db": rows["descriptors3d"],
                "descriptors2d_db": rows["descriptors2d_db"]},
                pipe.gats_config)
            out["pipeline_conf"] = gats_spg.dual_softmax_conf(
                m0, m1, 0.07).cpu()
            out["matcher"]["conf"] = gats_spg.dual_softmax_conf(
                *(torch.from_numpy(out["matcher"][k]).to(dev)
                  for k in ("m0", "m1")), 0.07).cpu()
    timer = Timer()
    pipe(images[..., None], Ks, noise=noise)    # warm-up
    for _ in range(3):
        with timer.scope("pipeline"):
            pipe(images[..., None], Ks, noise=noise)
            torch.cuda.synchronize()
    out["pipeline_ms"] = timer.summary()["pipeline"]["mean_ms"]
    del pipe, model, data
    torch.cuda.empty_cache()
    out.update(train_tokens(mesh, dev))
    return out


def train_tokens(mesh, dev) -> dict:
    """15 (c) in this process: two steps of the dense train step on this
    rank's rows and tokens of ``tokens_train_batch`` (the whole batch
    without a mesh) from the same parameters, the first step's
    gradients (as the optimizer reads them: summed over the world), the
    losses, the parameters after, and the ms of 3 more steps and the
    step's peak memory; without a mesh also the fp64 gradients of the
    first step (what fp32's reduction-order noise is measured against)."""
    from onepose_tpu_torch.models import convert
    from onepose_tpu_torch.parallel import mesh as pmesh
    from onepose_tpu_torch.train import trainer
    from onepose_tpu_torch.utils.profiling import Timer

    batch = tokens_train_batch()
    rows = pmesh.data_rows(mesh, TOKENS_TRAIN["b"])
    local = {k: v[rows].to(dev) for k, v in batch.items()}
    n2 = TOKENS_TRAIN["n2"]
    local.update(pmesh.token_shard(mesh, n2, {
        k: local[k] for k in ("descriptors3d_db", "descriptors2d_db")},
        dim=1))
    local.update(pmesh.token_shard(mesh, n2, {"conf_gt": local["conf_gt"]},
                                   dim=2))
    grads = []

    def keep(names, gs):
        if not grads:
            grads.append({n: g.cpu().numpy() for n, g in zip(names, gs)})
        return gs

    model = convert.gats_spg_from_jax(convert.init_gats_spg_params(
        np.random.default_rng(TOKENS_SEED + 2)))
    state = trainer.init_train_state(
        trainer.make_optimizer(base_lr=1e-3, milestones_steps=[100],
                               grad_clip=0.5, grad_transforms=[keep]),
        None, model=model, device=dev)
    step = trainer.make_train_step(None, mesh=mesh)
    torch.cuda.reset_peak_memory_stats()
    losses = []
    for _ in range(2):
        state, loss = step(state, local)
        losses.append(float(loss))
    params = torch.cat([p.detach().reshape(-1) for p in
                        state.model.parameters()]).cpu().numpy()
    timer = Timer()
    for _ in range(3):
        with timer.scope("step"):
            state, loss = step(state, local)
            torch.cuda.synchronize()
    out = {"train": {"losses": losses, "grads": grads[0], "params": params},
           "train_ms": timer.summary()["step"]["mean_ms"],
           "train_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    if mesh is None:
        del state
        model = convert.gats_spg_from_jax(convert.init_gats_spg_params(
            np.random.default_rng(TOKENS_SEED + 2))).to(dev).double()
        trainer.compute_loss(model, {k: v.double() if v.is_floating_point()
                                     else v for k, v in local.items()}
                             ).backward()
        out["train"]["grads64"] = {n: p.grad.cpu().numpy()
                                   for n, p in model.named_parameters()}
    return out


def probe_collectives(group, dev) -> dict:
    """The autograd collectives on CUDA tensors over ``group`` (2 ranks),
    values and gradients against what each must give. ``collectives.py``
    has no host staging: an op the backend refused would raise here."""
    import torch.distributed as dist

    from onepose_tpu_torch.parallel import collectives as comm

    r = dist.get_rank(group)
    x = torch.full((3, 4), float(r + 1), device=dev, requires_grad=True)
    y = comm.all_reduce_sum(x, group)
    (y * (r + 1)).sum().backward()
    g = torch.full((2, 3), float(r), device=dev, requires_grad=True)
    cat = comm.all_gather_cat(g, 1, group)
    (cat * (r + 1)).sum().backward()
    top = comm.all_reduce_max(x, group)
    ok = (y.is_cuda and bool((y == 3).all()) and bool((x.grad == 3).all())
          and tuple(cat.shape) == (2, 6) and bool((cat[:, :3] == 0).all())
          and bool((cat[:, 3:] == 1).all()) and bool((g.grad == 3).all())
          and bool((top == 2).all()) and not top.requires_grad)
    return {"ok": ok, "ops": "all_reduce_sum, all_gather_cat, "
            "all_reduce_max", "staged": 0}


def tokens_rank(points) -> dict:
    """One rank of phase 15's world: the collectives probed, then
    ``drive_tokens`` over a (world/2, 2) mesh."""
    import torch.distributed as dist

    from onepose_tpu_torch.ops.precision import pin_fp32
    from onepose_tpu_torch.parallel import collectives as comm
    from onepose_tpu_torch.parallel import mesh as pmesh

    pin_fp32()
    world = comm.get_world_size()
    dev = torch.device("cuda", torch.cuda.current_device())
    mesh = pmesh.make_mesh(world, (world // 2, 2))
    probe = probe_collectives(pmesh.axis_group(mesh, "model"), dev)
    out = drive_tokens(points, mesh, dev)
    out.update(rank=comm.get_rank(), backend=dist.get_backend(),
               probe=probe, model_index=pmesh.axis_index(mesh, "model"))
    return out


def sfm_equal_by_position(dir1, dir2, names, pairs):
    """(equal, keypoints, matches): two extract+match runs' HDF5 files
    compared by keypoint position: each image's keypoint rows sorted by
    (x, y), positions equal, scores and descriptors within 1e-5, each
    pair's matches the same pairs of positions."""
    from onepose_tpu_torch.sfm.match import names_to_pair
    from onepose_tpu_torch.utils import hdf5

    ok, n_kpts, n_matches = True, 0, 0
    with hdf5.File(os.path.join(dir1, "feats.h5"), "r") as f1, \
            hdf5.File(os.path.join(dir2, "feats.h5"), "r") as f2, \
            hdf5.File(os.path.join(dir1, "matches.h5"), "r") as m1, \
            hdf5.File(os.path.join(dir2, "matches.h5"), "r") as m2:
        kps = {}
        for n in names:
            rows = []
            for f in (f1, f2):
                kp = f[n]["keypoints"][()]
                o = np.lexsort((kp[:, 1], kp[:, 0]))
                rows.append((kp[o], f[n]["scores"][()][o],
                             f[n]["descriptors"][()][:, o]))
            (k1, s1, d1), (k2, s2, d2) = rows
            ok &= (k1.shape == k2.shape and bool((k1 == k2).all())
                   and float(np.abs(s1 - s2).max()) <= 1e-5
                   and float(np.abs(d1 - d2).max()) <= 1e-5)
            n_kpts += len(k1)
            kps[n] = (f1[n]["keypoints"][()], f2[n]["keypoints"][()])
        for a, b in pairs:
            sets = []
            for i, m in enumerate((m1, m2)):
                m0 = m[names_to_pair(a, b)]["matches0"][()]
                sets.append({(tuple(kps[a][i][k]), tuple(kps[b][i][j]))
                             for k, j in enumerate(m0) if j >= 0})
            ok &= sets[0] == sets[1]
            n_matches += len(sets[0])
    return ok, n_kpts, n_matches


def nonfinite(value, path="") -> list:
    """Paths of the numbers in a JSON-like ``value`` that are not finite
    (None is not a number)."""
    if isinstance(value, dict):
        return sum((nonfinite(v, f"{path}.{k}") for k, v in value.items()),
                   [])
    if isinstance(value, list):
        return sum((nonfinite(v, f"{path}[{i}]")
                    for i, v in enumerate(value)), [])
    if isinstance(value, float) and not np.isfinite(value):
        return [path]
    return []


def fingerprint(t: torch.Tensor) -> torch.Tensor:
    """The sum of a tensor's bits read as integers of its element size
    (a 0-dim int64 on its device): equal for equal bits, and for tensors
    that differ almost surely not."""
    x = t.detach()
    x = (x.to(torch.uint8) if x.dtype == torch.bool else x).contiguous()
    ints = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    return x.view(ints[x.element_size()]).to(torch.int64).sum()


class RowTrace(TorchDispatchMode):
    """Under it, every aten op's tensor outputs in call order, as (op,
    [(shape, fingerprint of the whole, of the first half along dim 0)]);
    ``wrap`` records a function's outputs the same way (the kernels, whose
    launches no aten op sees). Allocations (``empty``) are left out: their
    bits are whatever the memory held."""

    SKIP = ("empty", "empty_like", "empty_strided", "new_empty")

    def __init__(self):
        super().__init__()
        self.ops = []
        self.busy = False

    def record(self, name, out):
        self.busy = True
        try:
            ts = [t for t in (out if isinstance(out, (tuple, list))
                              else [out]) if isinstance(t, torch.Tensor)]
            self.ops.append((name, [(
                tuple(t.shape), fingerprint(t),
                fingerprint(t[:t.shape[0] // 2]) if t.dim()
                and t.shape[0] % 2 == 0 else None) for t in ts]))
        finally:
            self.busy = False

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not self.busy and func.overloadpacket.__name__ not in self.SKIP:
            self.record(str(func), out)
        return out

    def wrap(self, name, fn):
        def call(*args, **kwargs):
            out = fn(*args, **kwargs)
            self.record(name, out)
            return out
        return call

    def first_difference(self, other, halves=True):
        """(the first op, "index name shape", whose outputs differ from
        ``other``'s, or None; the count of outputs compared). ``halves``:
        ``other`` ran twice the rows, and each output whose first dim is
        twice this one's is held to its first half (outputs of other
        shapes are not compared); else outputs of equal shape are held
        whole."""
        compared = 0
        for i, ((name, outs), (name2, outs2)) in enumerate(zip(self.ops,
                                                             other.ops)):
            if name != name2:
                return f"{i} {name} (the other call: {name2})", compared
            for (s1, whole1, _), (s2, whole2, half2) in zip(outs, outs2):
                if halves and len(s1) and s2 == (2 * s1[0],) + s1[1:]:
                    same = bool(whole1 == half2)
                elif not halves and s1 == s2:
                    same = bool(whole1 == whole2)
                else:
                    continue
                compared += 1
                if not same:
                    return f"{i} {name} {list(s1)} vs {list(s2)}", compared
        return None, compared


def launch_counts() -> dict:
    from onepose_tpu_torch.ops import match, stem

    return {"stem": stem.fused_stem.launches,
            "match": match.dual_softmax_argmax.launches}


def set_launch_counts(counts: dict) -> None:
    from onepose_tpu_torch.ops import match, stem

    stem.fused_stem.launches = counts["stem"]
    match.dual_softmax_argmax.launches = counts["match"]


def event_ms(fn, iters, warmup):
    """CUDA-event time of each of ``iters`` calls of ``fn``, after
    ``warmup`` calls, in ms."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return times


def record_event():
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


def timed_track(tracker, args, noise):
    """One ``tracker.track`` call: (pose, info, wall ms, {stage: ms}),
    the stages timed by CUDA events recorded at the tracker's marks."""
    marks = [("start", record_event())]
    tracker.mark = lambda name: marks.append((name, record_event()))
    t0 = time.perf_counter()
    pose, info = tracker.track(*args, noise=noise)
    wall = (time.perf_counter() - t0) * 1e3
    marks[-1][1].synchronize()
    split = {name: prev.elapsed_time(ev)
             for (_, prev), (name, ev) in zip(marks, marks[1:])}
    return pose, info, wall, split


class TimedCall:
    """A callable's wrapper that keeps the wall ms of each call, through
    the card's synchronize, and the last call's output."""

    def __init__(self, fn):
        self.fn = fn
        self.ms = []
        self.last = None

    def __call__(self, *args, **kwargs):
        t0 = time.perf_counter()
        self.last = self.fn(*args, **kwargs)
        torch.cuda.synchronize()
        self.ms.append((time.perf_counter() - t0) * 1e3)
        return self.last


def keeping_steps(tracker):
    """``tracker`` with its ``track`` wrapped to keep every step's outputs
    (``info["step"]``), and the list they go to."""
    steps, track = [], tracker.track

    def track_and_keep(*args, **kwargs):
        pose, info = track(*args, **kwargs)
        steps.append(info.get("step"))
        return pose, info

    tracker.track = track_and_keep
    return tracker, steps


def nn_flips(kf_out, q_out, dev):
    """The tracker's keyframe→query NN match on the card and on the CPU
    from the same descriptors (two batch-1 PoseOutputs on the host): the
    rows whose match differs and how many of them are near-ties, i.e. the
    card's top-2 similarity gap of the row or of a column it matched, or
    its best similarity's distance to the 0.7 threshold, within twice the
    largest card-vs-CPU similarity difference (a flip needs two
    similarities to swap order, and each moved by at most that much)."""
    from onepose_tpu_torch.models.nn_matcher import (
        _unit_rows, mutual_nearest_neighbour)

    args = (kf_out.descriptors2d[0], q_out.descriptors2d[0],
            kf_out.kpt_mask[0], q_out.kpt_mask[0])
    m0, sims = [], []
    for d in (dev, torch.device("cpu")):
        a = [x.to(d) for x in args]
        m0.append(mutual_nearest_neighbour(*a, distance_thresh=0.7)
                  .matches0.cpu())
        sim = _unit_rows(a[0]) @ _unit_rows(a[1]).T
        sims.append(torch.where(a[2][:, None] & a[3][None, :], sim, -2.0)
                    .cpu())
    tol = 2 * float((sims[0] - sims[1]).abs().max())
    sim = sims[0]
    row_gap = sim.topk(2, dim=1).values.diff(dim=1).abs()[:, 0]
    col_gap = sim.topk(2, dim=0).values.diff(dim=0).abs()[0]
    to_thresh = (sim.amax(dim=1) - 0.7).abs()
    rows = torch.nonzero(m0[0] != m0[1])[:, 0].tolist()
    near = 0
    for r in rows:
        cols = [int(m[r]) for m in m0 if m[r] >= 0]
        near += bool(row_gap[r] <= tol or to_thresh[r] <= tol
                     or any(col_gap[c] <= tol for c in cols))
    return {"flips": len(rows), "near_ties": near, "sim_diff": tol / 2,
            "gaps": [float(row_gap[r]) for r in rows],
            "cosine_range": [float(sim[sim > -2].min()), float(sim.max())],
            "card_m0": m0[0], "cpu_m0": m0[1]}


def slot_map(ref_kpts: torch.Tensor, kpts: torch.Tensor) -> torch.Tensor:
    """For each slot of ``kpts`` [K, 2], the slot of ``ref_kpts`` that
    holds the same position; raises KeyError where the sets differ."""
    index = {tuple(p): j for j, p in enumerate(ref_kpts.tolist())}
    return torch.tensor([index[tuple(p)] for p in kpts.tolist()])


def permute_noise(noise, slots):
    """RANSAC noise ``[..., N]`` of a NamedTuple, its last axis taken in
    the order ``slots``."""
    return type(noise)(*(x[..., slots] for x in noise))


def pnp_profile_scene(b, n):
    """scripts/profile_pnp.py's scene, seed 0: points uniform in ±0.1 seen
    at z = 0.6 with f = 460 on 512², 35% of them inliers and the rest
    uniform clutter → (pts2d, pts3d, mask, Ks, the true pose [3, 4])."""
    rng = np.random.default_rng(0)
    k3 = rng.uniform(-0.1, 0.1, (b, n, 3)).astype(np.float32)
    Rt = np.concatenate([np.eye(3), [[0], [0], [0.6]]], axis=1)
    cam = k3 @ Rt[:, :3].T + Rt[:, 3]
    px = cam[..., :2] / cam[..., 2:] * 460.0 + 256.0
    outl = rng.uniform(0, 512, (b, n, 2)).astype(np.float32)
    is_in = rng.uniform(size=(b, n)) < 0.35
    k2 = np.where(is_in[..., None], px, outl).astype(np.float32)
    Ks = np.broadcast_to(np.array([[460., 0, 256], [0, 460., 256], [0, 0, 1]],
                                  np.float32), (b, 3, 3)).copy()
    return k2, k3, np.ones((b, n), bool), Ks, Rt


def mkdirs(*parts):
    path = os.path.join(*parts)
    os.makedirs(path, exist_ok=True)
    return path


def write_eval_capture(data, rng, dev):
    """17's capture in the dataset layout under ``data``: ring views of the
    textured plane (phase 11a's kind), as 8-bit PNGs with their crop
    intrinsics and ground-truth poses; the SfM sequence's files are
    numbered 5k, which sfm_spp_spg_sample's down ratio of 5 keeps. →
    (SuperPoint as phase 11a's, SuperGlue params planted on the SfM views'
    descriptors as 11a's)."""
    import cv2

    from onepose_tpu_torch.models import convert, superpoint
    from onepose_tpu_torch.sfm import extract
    from onepose_tpu_torch.utils.synthetic import ring_views

    K, poses, images = ring_views(rng, EVAL_VIEWS, hw=H,
                                  focal=float(KMAT[0, 0]))
    images = np.round(images * 255) / 255
    held = np.arange(EVAL_VIEWS) % 3 == 2
    obj = os.path.join(data, "onepose_datasets", "sample_data", EVAL_OBJECT)
    for seq, sel, step in ((SFM_SEQ, ~held, 5), (EVAL_SEQ, held, 1)):
        dirs = [mkdirs(obj, seq, d) for d in ("color", "intrin_ba",
                                              "poses_ba")]
        for k, i in enumerate(np.flatnonzero(sel)):
            name = str(step * k)
            cv2.imwrite(os.path.join(dirs[0], name + ".png"),
                        (images[i] * 255).astype(np.uint8))
            np.savetxt(os.path.join(dirs[1], name + ".txt"), K)
            np.savetxt(os.path.join(dirs[2], name + ".txt"),
                       np.vstack([poses[i], [0, 0, 0, 1]]))
    sp_model = convert.superpoint_from_jax(
        convert.init_superpoint_params(np.random.default_rng(0)))
    sp_conf = {k: v for k, v in extract.CONFS["superpoint"]["conf"].items()
               if k != "descriptor_dim"}
    det = superpoint.extract(sp_model.to(dev), torch.from_numpy(
        images[~held][:SFM_BATCH, ..., None].astype(np.float32)).to(dev),
        sp_conf)
    sg_params = convert.plant_superglue(convert.init_superglue_params(rng),
                                        det, 0.0)
    return sp_model.cpu(), sg_params


def to_device(noise, device):
    """A NamedTuple of tensors (or of such tuples) moved to ``device``."""
    if isinstance(noise, torch.Tensor):
        return noise.to(device)
    if noise is None:
        return None
    return type(noise)(*(to_device(x, device) for x in noise))


def hgmma_by_function(sass: str) -> dict:
    """Count of HGMMA instructions in each function of ``cuobjdump -sass``
    output, by (mangled) function name."""
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            counts[name] = 0
        elif name is not None and "HGMMA" in line:
            counts[name] += 1
    return counts


def _bound(times: dict):
    """(least ms, what bounds it) from {"bytes" or "operations": s}."""
    by = max(times, key=times.get)
    return times[by] * 1e3, by


def stem_bound_ms(b, h, w):
    """Least time of the stem at [b,h,w,1]: the larger of its bytes over HBM
    (input read once, pooled output written once) and its operations:
    conv1b as three TF32 tensor-core products, conv1a in fp32 FMA on the
    CUDA cores (the two units run side by side, so the larger counts)."""
    pix = b * h * w
    conv1b = 2 * pix * 9 * 64 * 64
    conv1a = 2 * pix * 9 * 64
    return _bound({
        "bytes": (pix * 4 + pix // 4 * 64 * 4) / PEAK_BYTES,
        "operations": max(3 * conv1b / PEAK_TF32, conv1a / PEAK_FP32)})


def match_bound_ms(b, n1, n2, d):
    """Least time of the dual-softmax argmax: S = d0 . d1^T as three TF32
    products, or reading the descriptors and writing two (index, max)
    pairs per row and column, whichever is longer."""
    return _bound({
        "bytes": (b * (n1 + n2) * d * 4 + b * (n1 + n2) * 8) / PEAK_BYTES,
        "operations": 3 * 2 * b * n1 * n2 * d / PEAK_TF32})


def train_gats_config() -> dict:
    """GATsSPG's settings in TRAIN_YAML, as the train entry reads them."""
    return {k: TRAIN_YAML["model"][k] for k in (
        "descriptor_dim", "scale_factor", "match_threshold", "include_self",
        "additional", "with_linear_transform")}


def train_optimizer_kwargs(steps_per_epoch: int) -> dict:
    """``trainer.make_optimizer``'s arguments from TRAIN_YAML, milestones
    in micro-steps as the train entry converts them."""
    m, t = TRAIN_YAML["model"], TRAIN_YAML["trainer"]
    return {"base_lr": m["lr"], "weight_decay": m["weight_decay"],
            "milestones_steps": [x * steps_per_epoch for x in m["milestones"]],
            "gamma": m["gamma"], "grad_clip": t["gradient_clip_val"],
            "accumulate_steps": t["accumulate_grad_batches"]}


def keypoint_jaccard(a, b, i) -> float:
    """Jaccard index of frame ``i``'s valid keypoint positions in two
    outputs (SuperPoint's or PosePipeline's)."""
    def kset(o):
        kp = getattr(o, "keypoints", None)
        kp = kp if kp is not None else o.keypoints2d
        mask = o.mask if hasattr(o, "mask") else o.kpt_mask
        return {tuple(p) for p in kp[i][mask[i]].tolist()}

    sa, sb = kset(a), kset(b)
    return len(sa & sb) / max(len(sa | sb), 1)


def match_jaccard(a, b, i) -> float:
    """Jaccard index of frame ``i``'s (keypoint position, 3D index)
    matches in two PosePipeline outputs."""
    def mset(o):
        return {(tuple(p), m) for p, m in zip(o.keypoints2d[i].tolist(),
                                              o.matches0[i].tolist())
                if m >= 0}

    sa, sb = mset(a), mset(b)
    return len(sa & sb) / max(len(sa | sb), 1)


def plant_gats_spg(params, mu):
    """A copy of GATsSPG weights (JAX layout, numpy) that match a 2D
    descriptor to the DB point holding the same one: each attention
    layer's last linear is zero (no message reaches the tokens), each GATs
    layer attends to its leaves alone (``a``'s 3D half zero, ``W`` the
    identity, ``a``'s 2D half a large multiple of the descriptors' mean
    direction) and returns elu(mean of the leaves), and the final
    projection is x - mu, so matching is the cosine of the centred
    descriptors (random SuperPoint descriptors share one dominant
    direction)."""
    params = copy.deepcopy(params)
    d = len(mu)
    for i, layer in enumerate(params["gnn"]):
        if i % 3 == 0:
            a = np.zeros((2 * d, 1), np.float32)
            a[:d, 0] = 50.0 * mu / np.linalg.norm(mu)
            layer.update(W=np.eye(d, dtype=np.float32), a=a)
        else:
            layer["mlp1"]["w"][:] = 0
            layer["mlp1"]["b"][:] = 0
    params["final_proj"] = {"w": np.eye(d, dtype=np.float32),
                            "b": (-mu).astype(np.float32)}
    return params


def planted_world(det, kmat, poses, rng, per_frame, leaf):
    """The bf16 gate's DB and matcher: each frame's first ``per_frame``
    valid fp32 keypoints become DB points, back-projected at a random
    depth under the frame's known pose, each holding the keypoint's
    descriptor, its leaves elu⁻¹ of it (so a GATs layer of
    ``plant_gats_spg`` returns the descriptor itself); the matcher is
    ``plant_gats_spg`` around the DB descriptors' mean. → (ObjectDB,
    GATsSPG weights in the JAX layout)."""
    from onepose_tpu_torch.datasets import anno
    from onepose_tpu_torch.models import convert

    kinv = np.linalg.inv(np.asarray(kmat, np.float64))
    pts, descs = [], []
    for b, pose in enumerate(poses):
        m = det.mask[b].cpu().numpy()
        kp = det.keypoints[b].cpu().numpy()[m][:per_frame].astype(np.float64)
        rays = np.concatenate([kp, np.ones((len(kp), 1))], 1) @ kinv.T
        cam = rays * rng.uniform(0.4, 0.6, (len(kp), 1))
        pts.append((cam - pose[:, 3]) @ pose[:, :3])
        descs.append(det.descriptors[b].cpu().numpy()[m][:per_frame])
    pts, descs = np.concatenate(pts), np.concatenate(descs).astype(np.float64)
    n = len(pts)
    leaves = np.where(descs > 0, descs, np.log1p(descs))
    db = anno.build_object_db(
        avg_keypoints3d=pts.astype(np.float32),
        avg_descriptors3d=descs.T.astype(np.float32),
        avg_scores3d=np.ones((n, 1), np.float32),
        clt_descriptors=np.repeat(leaves, leaf, axis=0).T.astype(np.float32),
        clt_scores=np.ones((n * leaf, 1), np.float32),
        idxs=np.full(n, leaf), num_leaf=leaf,
        shape3d=((n + 7) // 8) * 8)
    gats = plant_gats_spg(convert.init_gats_spg_params(rng),
                          descs.mean(0).astype(np.float32))
    return db, gats


def unit(x):
    """Rows of ``x`` scaled to unit length, as float32."""
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


def random_models(rng):
    from onepose_tpu_torch.models import convert

    return (convert.superpoint_from_jax(convert.init_superpoint_params(rng)),
            convert.gats_spg_from_jax(convert.init_gats_spg_params(rng)))


def plant_geometry(db, matches0, keypoints2d, kmat, poses_gt, rng):
    """A copy of ``db`` whose 3D points are the back-projections, at a
    random depth and under frame b's known pose, of the keypoints that
    frame b matched to them (the first frame to claim a point keeps it;
    for the others it is an outlier). Matching reads descriptors only, so
    the same matches follow, now consistent with the known poses."""
    kpts3d = db.keypoints3d.copy()
    taken = np.zeros(len(kpts3d), bool)
    kinv = np.linalg.inv(kmat.astype(np.float64))
    m0 = matches0.cpu().numpy()
    kp = keypoints2d.cpu().numpy()
    for b, pose in enumerate(poses_gt):
        for k in np.flatnonzero(m0[b] >= 0):
            j = m0[b, k]
            if taken[j]:
                continue
            ray = kinv @ np.array([kp[b, k, 0], kp[b, k, 1], 1.0])
            cam = ray * rng.uniform(0.4, 0.6)
            kpts3d[j] = pose[:, :3].T @ (cam - pose[:, 3])
            taken[j] = True
    return dataclasses.replace(db, keypoints3d=kpts3d.astype(np.float32))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", default=os.path.join("build", "chip_smoke"),
                        help="directory for chip_smoke.json and profile.txt")
    parser.add_argument("--phases", default=None,
                        help="comma-separated phases to run (e.g. "
                        "2,11a,12,14,15; 14 needs 11a and 12); default all. "
                        "A partial run prints no final line")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script has no CPU path",
              file=sys.stderr)
        return 1
    from onepose_tpu_torch.ops.precision import pin_fp32

    pin_fp32()
    os.makedirs(args.out, exist_ok=True)
    smoke = Smoke(args.out)
    phases = [
        ("1 card", smoke.card), ("2 kernel build", smoke.build),
        ("3 stem kernel vs plain", smoke.stem),
        ("4 match kernel vs plain", smoke.match),
        ("5 known-pose PnP on the card", smoke.known_pose),
        ("6 card vs CPU parity", smoke.parity),
        ("7 protocol-shape pipeline", smoke.protocol),
        ("8 multi-object serving", smoke.serving),
        ("9 feature-matching detector", smoke.detector),
        ("10a keyframe BA tracker", smoke.tracking),
        ("10b tracked demo path", smoke.demo),
        ("11a SfM from images", smoke.sfm_images),
        ("11b SfM at the reference scale from features",
         smoke.sfm_features),
        ("12 training at full width", smoke.training),
        ("13 bf16 preset", smoke.bf16_preset),
        ("14 several cards", smoke.several_cards),
        ("15 token-sharded model axis", smoke.token_axis),
        ("16 PnP stage profile", smoke.pnp_stages),
        ("17 real-assets eval entry", smoke.eval_entry),
        ("18 measurement entries", smoke.entries),
        ("19 rows batched together", smoke.batch_rows)]
    chosen = None if args.phases is None else set(args.phases.split(","))
    if chosen is not None:
        chosen.add("1")     # the card's name and power limit
    for name, fn in phases:
        if chosen is None or name.split()[0] in chosen:
            smoke.phase(name, fn)
    smoke.check("jax" not in sys.modules, "no JAX imported")

    smoke.results["failures"] = smoke.failures
    with open(os.path.join(args.out, "chip_smoke.json"), "w") as f:
        json.dump(smoke.results, f, indent=1, default=str)
    if smoke.failures:
        log(f"chip_smoke: {len(smoke.failures)} failure(s): "
            f"{smoke.failures}")
        return 1
    if chosen is not None:
        log(f"chip_smoke: phases {sorted(chosen)} passed (a partial run: "
            "no kernels line, no final line)")
        return 0
    log(json.dumps(smoke.kernels_line()))
    log(smoke.smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
