"""Driver ``pose_closed``: a closed loop of frame batches through
``PosePipeline``, as ``inference.py`` drives an evaluation, without the
disk.

Each batch holds ``batch`` crops drawn from the plane scene's pool in an
order drawn from the seed. A background thread assembles the next batches
on the host and stages them on the card (``runtime.loader.stage_ahead``
with a ``DeviceStager``: pinned memory, a side stream); the loop waits for
a staged batch, runs the pipeline's three stages (``extract``, ``match``,
``pose``: ``PosePipeline.run_rows`` is exactly these on one card), and
drains the poses, inlier counts and matches to the host with at most
``in_flight`` batches outstanding. RANSAC's noise is drawn on the card
from the seed for each batch, so the reference can draw it again.

With ``pnp_overlap`` the stages run as a two-deep pipeline, as a
deployment that serves a stream of batches runs them: a second host
thread extracts and matches batch i on one stream while the loop's own
thread dispatches PnP of batch i - 1 on another, of higher priority.
PnP's host waits (blocking copies of host constants) then wait for PnP's
stream alone, and the card runs the next batch's extraction and matching
under PnP's host dispatch instead of standing idle. A batch's PnP waits
on an event for its matches. PnP stays on the loop's thread because the
profiler records host operations of that thread only.

Traffic keys: ``batch``, ``pool``, ``shift_steps``, ``plane_depth``,
``tilt``, ``in_flight``, ``stage_depth``, ``pnp_overlap``,
``warmup_batches``, ``trace_batches``, ``check_batches`` (drawn among the
first ``check_from``).
"""
from __future__ import annotations

import concurrent.futures as cf
import contextlib
import time

import numpy as np
import torch

from portbench import flops, judge, scenes, trace
from portbench.common import StageClock, precision, sync
from portbench.reference import epnp as ref_pnp
from portbench.reference import gats_spg as ref_gats
from portbench.reference import superpoint as ref_sp
from portbench.weights import (gats_spg_shapes, generator, load_module,
                               make_weights, sub_seed, superpoint_shapes)


class Cell:
    def __init__(self, work: dict, seed: int, device):
        self.cfg, self.tr = work["config_data"], work["traffic_data"]
        self.seed, self.device = seed, torch.device(device)
        self.kept = []
        self.marks = []     # (set-up phase, host clock at its end)

    # -- inputs and the program -------------------------------------------
    def setup(self) -> None:
        from onepose_tpu_torch import pipeline
        from onepose_tpu_torch.datasets.anno import ObjectDB
        from onepose_tpu_torch.models import gats_spg, superpoint
        from onepose_tpu_torch.runtime.loader import DeviceStager

        cfg, dev = self.cfg, self.device
        self.marks.append(("port import", time.perf_counter()))
        self.sp_sd = make_weights(superpoint_shapes(cfg["superpoint"]),
                                  self.seed, "superpoint", dev)
        self.gats_sd = make_weights(gats_spg_shapes(cfg["gats_spg"]),
                                    self.seed, "gats_spg", dev)
        self.marks.append(("weights", time.perf_counter()))
        self.scene = scenes.plane_scene(cfg, self.tr, self.seed, self.sp_sd,
                                        self.gats_sd, dev)
        s = self.scene
        self.marks.append(("scene", time.perf_counter()))
        db = ObjectDB(keypoints3d=s["keypoints3d"].clone(),
                      descriptors3d=s["descriptors3d"].clone(),
                      scores3d=None,
                      descriptors2d_db=s["descriptors2d_db"].clone(),
                      scores2d_db=None, mask3d=s["mask3d"].clone(),
                      num_leaf=cfg["db"]["num_leaf"],
                      num_points=cfg["db"]["shape3d"])
        sp_model = load_module(superpoint.SuperPoint, self.sp_sd,
                               cfg["superpoint"]["descriptor_dim"])
        g = cfg["gats_spg"]
        gats_model = load_module(gats_spg.GATsSPG, self.gats_sd,
                                 g["descriptor_dim"], g["num_blocks"])
        pnp = cfg["pnp"]
        self.pipe = pipeline.PosePipeline(
            sp_model, gats_model, db, sp_config=cfg["superpoint"],
            gats_config=g, reproj_threshold=pnp["reproj_threshold"],
            num_hypotheses=pnp["num_hypotheses"],
            refine_iters=pnp["refine_iters"], device=dev)
        self.stager = DeviceStager(dev)
        self.Ks = s["K"].expand(self.tr["batch"], 3, 3).contiguous()
        # with pnp_overlap: the thread of extraction and matching, and the
        # streams [extraction and matching, PnP], made once so that warm-up
        # meets every handle. PnP's stream has the higher priority: its
        # small kernels, which its host waits wait for, go ahead of the
        # next batch's blocks.
        overlap = bool(self.tr.get("pnp_overlap", False))
        self.pool = cf.ThreadPoolExecutor(1) if overlap else None
        self.streams = [torch.cuda.Stream(dev, priority=p)
                        if overlap and dev.type == "cuda" else None
                        for p in (0, -1)]
        self.marks.append(("program", time.perf_counter()))
        self.run_batches("warm", self.tr["warmup_batches"])
        sync(dev)
        self.marks.append(("warm-up", time.perf_counter()))

    def order(self, tag: str, i: int) -> torch.Tensor:
        """The pool frames of batch ``i``: the pool repeated to the batch
        size, in an order drawn from the seed."""
        b, pool = self.tr["batch"], self.tr["pool"]
        rng = np.random.default_rng(sub_seed(self.seed, f"{tag}{i}"))
        return torch.from_numpy(rng.permutation(
            np.resize(np.arange(pool), b)))

    def noise(self, tag: str, i: int) -> ref_pnp.RansacNoise:
        """RANSAC's four uniform draws for batch ``i``, the same for the
        program and the reference."""
        pnp = self.cfg["pnp"]
        return ref_pnp.draw_noise(
            self.tr["batch"], self.cfg["superpoint"]["max_keypoints"],
            pnp["num_hypotheses"], pnp["lo_hypotheses"],
            generator(self.seed, f"{tag}-pnp{i}", self.device), self.device)

    def _stage(self, item):
        tag, i = item
        idx = self.order(tag, i)
        images = self.scene["frames"].index_select(0, idx)[..., None]
        return tag, i, idx, self.stager({"images": images, "Ks": self.Ks})

    # -- the loop ---------------------------------------------------------
    def run_batches(self, tag, count=None, deadline=None, timed=False,
                    spans=False, keep=()):
        """Batches ``tag`` 0, 1, ... until ``count`` have run or the
        clock passes ``deadline``, then every batch begun is finished and
        drained; → (batches, stage waits in s, the host clock at each
        batch's start, stage times in ms when ``timed``, and with the PnP
        thread the host seconds of each PnP on this thread)."""
        from onepose_tpu_torch.runtime.loader import stage_ahead

        def source():
            i = 0
            while count is None or i < count:
                yield tag, i
                i += 1

        def span(name):
            return trace.span(name) if spans else _null()

        streams = self.streams
        clocks = [StageClock(self.device) if timed else None
                  for _ in range(2)]
        pending, waits, starts, pnp_host, n = [], [], [], [], 0

        def front(item):
            """Extraction and matching of one staged batch, on the first
            stream; → what PnP needs, with an event after the matches."""
            tag_, i, idx, staged = item
            with torch.no_grad(), _on(streams[0]):
                if clocks[0]:
                    clocks[0].mark("start")
                t0 = time.perf_counter()
                with span("stage_wait"):
                    batch = staged.wait()
                waits.append(time.perf_counter() - t0)
                with span("extract"):
                    det = self.pipe.extract(batch["images"])
                if clocks[0]:
                    clocks[0].mark("extract")
                with span("match"):
                    mt = self.pipe.match(det)
                if clocks[0]:
                    clocks[0].mark("match")
                ready = None
                if streams[0] is not None:
                    ready = torch.cuda.Event()
                    ready.record()
            return tag_, i, idx, batch, det, mt, ready

        def pose(item):
            """PnP of one matched batch, on the second stream, then the
            drain of the batch ``in_flight`` before it. ``pending`` keeps
            each batch's inputs until its outputs are on the host, so that
            no block of them is reused while PnP's stream may still read
            it."""
            tag_, i, idx, batch, det, mt, ready = item
            with _on(streams[1]):
                if ready is not None:
                    torch.cuda.current_stream().wait_event(ready)
                noise = self.noise(tag_, i)
                if clocks[1]:
                    clocks[1].mark("start")
                with span("pnp"):
                    pnp = self.pipe.pose(det, mt, batch["Ks"], noise=noise)
                if clocks[1]:
                    clocks[1].mark("pnp")
                pending.append(((pnp.pose, pnp.num_inliers, pnp.success,
                                 mt.matches0), item))
                if i in keep:
                    self.kept.append((i, idx, det, mt.matches0,
                                      mt.matching_scores0, pnp.pose,
                                      pnp.num_inliers))
                if len(pending) > self.tr["in_flight"]:
                    _drain(pending.pop(0)[0])

        # With the PnP thread, the front stages of batch i run there while
        # this thread (the one the profiler follows) runs PnP of batch
        # i - 1; without it, each batch's stages run here in turn.
        with torch.no_grad():
            ahead = None      # the front stages of the batch before
            for tag_, i, idx, staged in stage_ahead(
                    source(), self._stage, self.tr["stage_depth"]):
                starts.append(time.perf_counter())
                if self.pool is None:
                    pose(front((tag_, i, idx, staged)))
                else:
                    fut = self.pool.submit(front, (tag_, i, idx, staged))
                    if ahead is not None:
                        item = ahead.result()
                        t0 = time.perf_counter()
                        pose(item)
                        pnp_host.append(time.perf_counter() - t0)
                    ahead = fut
                n += 1
                if deadline is not None and time.perf_counter() >= deadline:
                    break
            if ahead is not None:
                pose(ahead.result())
            with _on(streams[1]):
                for out, _ in pending:
                    _drain(out)
        stages = {}
        for c in clocks:
            if c:
                stages.update(c.totals())
        return n, waits, starts, stages, pnp_host

    def window(self, seconds: float, traced: bool) -> dict:
        rng = np.random.default_rng(sub_seed(self.seed, "check"))
        keep = set(rng.choice(self.tr["check_from"],
                              self.tr["check_batches"],
                              replace=False).tolist())
        t0 = time.perf_counter()
        n, waits, starts, stages, pnp_host = self.run_batches(
            "win", deadline=t0 + seconds, timed=traced, keep=keep)
        sync(self.device)
        wall = time.perf_counter() - t0
        return {"frames": n * self.tr["batch"], "wall_s": wall,
                "step_s": np.diff(starts + [t0 + wall]).tolist(),
                "stage_wait_s": waits, "stages": stages,
                "pnp_host_s": pnp_host}

    def profile(self) -> trace.Trace:
        with trace.profiled() as out:
            self.run_batches("trace", self.tr["trace_batches"], spans=True)
        return out[0]

    def shapes(self) -> dict:
        c, b = self.cfg, self.tr["batch"]
        h, w = c["crop"]["height"], c["crop"]["width"]
        g = c["gats_spg"]
        return {"stem": (b, h, w),
                "match": (b, c["superpoint"]["max_keypoints"],
                          c["db"]["shape3d"], g["descriptor_dim"]),
                "flops_per_frame": flops.superpoint(1, h, w, g[
                    "descriptor_dim"]) + flops.gats_spg(
                    1, c["superpoint"]["max_keypoints"], c["db"]["shape3d"],
                    c["db"]["num_leaf"], g["descriptor_dim"], g["num_heads"],
                    g["num_blocks"])}

    def release(self) -> None:
        if self.pool is not None:
            self.pool.shutdown()
        del self.pipe, self.stager, self.streams

    # -- the check --------------------------------------------------------
    def check(self, control: bool = False) -> dict:
        """The comparison of the kept batches with the reference, or with
        ``control`` the same comparison of the reference run with TF32 in
        the program's place."""
        readings = []
        for i, idx, det, m0, ms0, pose, inl in self.kept:
            images = self.scene["frames"].index_select(0, idx).to(
                self.device)[..., None]
            noise = self.noise("win", i)
            if control:
                det, m0, ms0, pose, inl = self.reference_outputs(
                    images, noise, tf32=True)
            readings.append(self.judge(images, idx, noise, det, m0, ms0,
                                       pose, inl))
        return judge.merge(readings)

    def reference_outputs(self, images, noise, tf32):
        """The reference's own outputs of a batch, stage after stage."""
        with torch.no_grad(), precision(tf32):
            det = ref_sp.extract(self.sp_sd, images, self.cfg["superpoint"])
            m = self._ref_match(det.descriptors, det.mask)
            pose, inl = self._ref_pnp(det.keypoints, det.mask, m.matches0,
                                      noise)
        return det, m.matches0, m.matching_scores0, pose, inl

    def judge(self, images, idx, noise, det, m0, ms0, pose, inl) -> dict:
        """Each stage against the reference on the program's own inputs
        to it; beside them, what the scene shows (not compared): the
        median frame's pose error against its planted pose, and the
        fewest PnP inliers of a frame."""
        sp = self.cfg["superpoint"]
        with torch.no_grad(), precision(tf32=False):
            scores, desc = ref_sp.dense_heads(self.sp_sd, images)
            feats = ref_sp.select_keypoints(
                ref_sp.simple_nms(scores, sp["nms_radius"]), desc, sp)
            out = judge.features(det, scores, desc, feats,
                                 sp["keypoint_threshold"])
            del scores, desc
            ref_m = self._ref_match(det.descriptors, det.mask)
            out.update(judge.gats_matches(m0, ms0, ref_m))
            ref_pose, ref_inl = self._ref_pnp(det.keypoints, det.mask, m0,
                                              noise)
            out.update(judge.poses(pose, inl, ref_pose, ref_inl))
            truth = self.scene["poses"].to(pose.device)[idx]
            out["pose_truth_err"] = float((pose - truth).abs().amax(
                (1, 2)).median())
            out["inliers_min"] = float(inl.min())
        return out

    def _ref_match(self, desc2d, mask2d):
        s, b = self.scene, desc2d.shape[0]
        return ref_gats.match(
            self.gats_sd, desc2d, mask2d, s["descriptors3d"].expand(b, -1, -1),
            s["descriptors2d_db"].expand(b, -1, -1),
            s["mask3d"].expand(b, -1), self.cfg["gats_spg"])

    def _ref_pnp(self, kpts, mask, m0, noise):
        b, pnp = kpts.shape[0], self.cfg["pnp"]
        kp3 = self.scene["keypoints3d"].expand(b, -1, -1)
        mk3 = torch.gather(kp3, 1, m0.clamp(min=0).long()[..., None].expand(
            -1, -1, 3))
        res = ref_pnp.ransac_pnp(
            kpts, mk3, (m0 >= 0) & mask, self.scene["K"].to(
                kpts.device).expand(b, 3, 3),
            reproj_threshold=pnp["reproj_threshold"],
            num_hypotheses=pnp["num_hypotheses"],
            refine_iters=pnp["refine_iters"],
            lo_hypotheses=pnp["lo_hypotheses"],
            noise=noise)
        return res.pose, res.num_inliers

    def describe(self) -> str:
        s = self.scene
        return (f"plane scene: {s['planted']} of "
                f"{self.cfg['db']['shape3d']} DB points planted; matches of "
                f"the pool frames {s['matches']}")


def _on(stream):
    """``torch.cuda.stream(stream)``, or nothing without one."""
    return (torch.cuda.stream(stream) if stream is not None
            else contextlib.nullcontext())


def _drain(item) -> None:
    """What a user of the poses consumes: copied to the host."""
    for t in item:
        t.cpu()


class _null:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False
