#!/usr/bin/env python
"""Smoke run of the PyTorch port (onepose_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py [--out DIR]

Builds the hand-written CUDA kernels from ``onepose_tpu_torch/csrc`` at
first use (into ``build/onepose_tpu_torch/``, counted in this run's time)
and runs nine phases; weights and inputs come from fixed seeds.

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
     split into extract, SuperGlue, RANSAC.

Each main path (phases 7, 8 and 9) is driven once with the launch counts
set to 0 just before it and read just after; the kernels line sums those
counts. Every phase's launches, comparisons included, are in the JSON.
Detailed results go to ``DIR/chip_smoke.json`` and ``DIR/profile.txt``
(default ``build/chip_smoke``). Any failed phase makes the script exit 1
without the kernels line and the final line. The last line of a passing
run is ``{"ok": true, "device": {...}}``. There is no CPU path: without a
CUDA device the script exits 1.
"""
from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np
import torch

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
    first start to the last end, and the top of the kernel table. The
    profiler slows the host, so the busy share is a lower bound."""
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
    stats = {"device_ops": len(spans), "busy_ms": busy / 1e3,
             "window_ms": window / 1e3, "busy_share": busy / window}
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
        from onepose_tpu_torch.ops import match

        stats = {}
        for b, n1, n2 in ((B, K_PTS, SHAPE3D), (2, 1000, 1990)):
            for kind in ("random", "peaked"):
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
                stats[key] = {**dataclasses.asdict(gate), "ms": ms,
                              "plain_ms": plain_ms, "bound_ms": bound_ms,
                              "bound_by": bound_by}
                self.check(gate.ok,
                           f"match {key}: max rel err {gate.max_rel_err:.3e} "
                           f"(gate {match.GATE_REL:.0e}), index mismatches "
                           f"outside near-ties {gate.bad_idx} (all "
                           f"{gate.idx_diff}, near-tie rows+cols "
                           f"{gate.near_ties}); kernel {ms:.3f} ms, plain "
                           f"{plain_ms:.3f} ms")
        self.results["match"] = stats

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

    def kernels_line(self):
        st = self.results.get("stem", {}).get(str((B, H, W, 1)), {})
        mt = self.results.get("match", {}).get(
            f"[{B},{K_PTS},256]x[{B},{SHAPE3D},256] random", {})
        # launches of the main paths (pipeline, serving, detector)
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


def unit(x):
    """Rows of ``x`` scaled to unit length, as float32."""
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


def random_models(rng):
    from onepose_tpu_torch.models import convert

    return (convert.superpoint_from_jax(convert.init_superpoint_params(rng)),
            convert.gats_spg_from_jax(convert.init_gats_spg_params(rng)))


def random_db(rng, points, shape3d, leaf, obs=(2, 10)):
    from onepose_tpu_torch.datasets import anno

    idxs = rng.integers(obs[0], obs[1], points)
    total = int(idxs.sum())
    return anno.build_object_db(
        avg_keypoints3d=rng.uniform(-0.1, 0.1, (points, 3)).astype(np.float32),
        avg_descriptors3d=rng.normal(size=(256, points)).astype(np.float32),
        avg_scores3d=rng.uniform(0, 1, (points, 1)).astype(np.float32),
        clt_descriptors=rng.normal(size=(256, total)).astype(np.float32),
        clt_scores=rng.uniform(0, 1, (total, 1)).astype(np.float32),
        idxs=idxs, num_leaf=leaf, shape3d=shape3d)


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
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script has no CPU path",
              file=sys.stderr)
        return 1
    from onepose_tpu_torch.ops.precision import pin_fp32

    pin_fp32()
    os.makedirs(args.out, exist_ok=True)
    smoke = Smoke(args.out)
    smoke.phase("1 card", smoke.card)
    smoke.phase("2 kernel build", smoke.build)
    smoke.phase("3 stem kernel vs plain", smoke.stem)
    smoke.phase("4 match kernel vs plain", smoke.match)
    smoke.phase("5 known-pose PnP on the card", smoke.known_pose)
    smoke.phase("6 card vs CPU parity", smoke.parity)
    smoke.phase("7 protocol-shape pipeline", smoke.protocol)
    smoke.phase("8 multi-object serving", smoke.serving)
    smoke.phase("9 feature-matching detector", smoke.detector)
    smoke.check("jax" not in sys.modules, "no JAX imported")

    smoke.results["failures"] = smoke.failures
    with open(os.path.join(args.out, "chip_smoke.json"), "w") as f:
        json.dump(smoke.results, f, indent=1, default=str)
    if smoke.failures:
        log(f"chip_smoke: {len(smoke.failures)} failure(s): "
            f"{smoke.failures}")
        return 1
    log(json.dumps(smoke.kernels_line()))
    log(smoke.smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
