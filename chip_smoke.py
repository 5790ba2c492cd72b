#!/usr/bin/env python
"""Smoke run of the PyTorch port (onepose_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py [--out DIR]

Builds the hand-written CUDA kernels from ``onepose_tpu_torch/csrc`` at
first use (into ``build/onepose_tpu_torch/``, counted in this run's time)
and runs seven phases; weights and inputs come from fixed seeds.

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
     both kernels launched by that run, per-stage times.

Detailed results go to ``DIR/chip_smoke.json`` and ``DIR/profile.txt``
(default ``build/chip_smoke``). Any failed phase makes the script exit 1
without the kernels line and the final line. The last line of a passing
run is ``{"ok": true, "device": {...}}``. There is no CPU path: without a
CUDA device the script exits 1.
"""
from __future__ import annotations

import argparse
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
        try:
            fn()
        except Exception:  # report every phase, then fail the run
            traceback.print_exc()
            self.failures.append(f"{name}: exception")
        log(f"   ({time.perf_counter() - t0:.1f} s)")

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
        from onepose_tpu_torch.ops import stem
        from onepose_tpu_torch.ops.precision import pin_fp32

        rng = np.random.default_rng(0)
        stats = {}
        for shape in ((B, H, W, 1), (2, 64, 128, 1)):
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
            stats[str(shape)] = {"max_abs_err": err, "gate": gate,
                                 "err_vs_fp64": errs64, "ms": ms,
                                 "plain_ms": plain_ms, "bound_ms": bound_ms,
                                 "bound_by": bound_by}
            self.check(got.shape == ref.shape and err < gate,
                       f"stem {list(shape)}: max|d|={err:.3e} < {gate:.3e}; "
                       f"vs fp64: kernel {errs64['kernel']:.3e}, plain fp32 "
                       f"{errs64['plain_fp32']:.3e}, cuDNN TF32 "
                       f"{errs64['cudnn_tf32']:.3e}; kernel {ms:.3f} ms, "
                       f"plain {plain_ms:.3f} ms, bound {bound_ms:.3f} ms "
                       f"({bound_by})  [{self.smi}]")
        self.results["stem"] = stats

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
        db = plant_geometry(db, first, kmat, poses_gt, rng)
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
        from onepose_tpu_torch.ops import match, stem

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

        stem.fused_stem.launches = 0
        match.dual_softmax_argmax.launches = 0
        out = pipe(images, Ks, generator=gen)
        torch.cuda.synchronize()
        launches = {"stem": stem.fused_stem.launches,
                    "match": match.dual_softmax_argmax.launches}
        self.results["launches"] = launches
        finite = all(bool(torch.isfinite(x.float()).all()) for x in
                     (out.poses, out.keypoints2d, out.descriptors2d))
        shapes = (tuple(out.poses.shape) == (B, 3, 4)
                  and tuple(out.matches0.shape) == (B, K_PTS))
        self.check(finite and shapes, "protocol run: finite outputs, shapes")
        self.check(launches["stem"] > 0 and launches["match"] > 0,
                   f"protocol run launched the kernels: {launches}")
        log(f"   keypoints/frame {out.kpt_mask.sum(1).tolist()}, matches "
            f"{out.num_matches.tolist()}, success {out.success.tolist()}")

        # per-stage device time of a batch of 8
        det = pipe.extract(images)
        mt = pipe.match(det)
        stage = {
            "extract_ms": cuda_ms(lambda: pipe.extract(images), 10, 2),
            "match_ms": cuda_ms(lambda: pipe.match(det), 10, 2),
            "pnp_ms": cuda_ms(lambda: pipe.pose(det, mt, Ks, generator=gen),
                              10, 2),
            "total_ms": cuda_ms(lambda: pipe(images, Ks, generator=gen),
                                10, 2),
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

    def kernels_line(self):
        st = self.results.get("stem", {}).get(str((B, H, W, 1)), {})
        mt = self.results.get("match", {}).get(
            f"[{B},{K_PTS},256]x[{B},{SHAPE3D},256] random", {})
        launches = self.results.get("launches", {})
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


def plant_geometry(db, out, kmat, poses_gt, rng):
    """A copy of ``db`` whose 3D points are the back-projections, at a
    random depth and under frame b's known pose, of the keypoints that
    frame b matched to them (the first frame to claim a point keeps it;
    for the others it is an outlier). Matching reads descriptors only, so
    the same matches follow, now consistent with the known poses."""
    kpts3d = db.keypoints3d.copy()
    taken = np.zeros(len(kpts3d), bool)
    kinv = np.linalg.inv(kmat.astype(np.float64))
    m0 = out.matches0.cpu().numpy()
    kp = out.keypoints2d.cpu().numpy()
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
