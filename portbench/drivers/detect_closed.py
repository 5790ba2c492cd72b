"""Driver ``detect_closed``: a closed loop of full frames through
``LocalFeatureObjectDetector``, one frame at a time, as the offline
detection of every frame and the demo run it.

The DB views are extracted when the detector is built (set-up). Each
frame, drawn from the paste scene's pool in an order drawn from the seed,
goes through the detector's own steps in ``detect_bbox``'s order: the
upload and SuperPoint of the frame, SuperGlue against every view (its
log assignment, then the mutual matches, as ``superglue.forward`` runs
them), the similarity RANSAC per view, and the box on the host. A frame's
time runs from its submission to its box on the host. RANSAC's noise is
drawn on the card from the seed for each frame.

Traffic keys: ``pool``, ``warmup_frames``, ``trace_frames``,
``check_frames`` (drawn among the first ``check_from``).
"""
from __future__ import annotations

import time

import numpy as np
import torch

from portbench import flops, judge, scenes, trace
from portbench.common import StageClock, precision, sync
from portbench.reference import similarity as ref_sim
from portbench.reference import superglue as ref_sg
from portbench.reference import superpoint as ref_sp
from portbench.weights import (generator, load_module, make_weights,
                               sub_seed, superglue_shapes, superpoint_shapes)

SIM_HYPOTHESES = 256      # the detector's similarity RANSAC


class Cell:
    def __init__(self, work: dict, seed: int, device):
        self.cfg, self.tr = work["config_data"], work["traffic_data"]
        self.seed, self.device = seed, torch.device(device)
        self.kept = []
        self.marks = []     # (set-up phase, host clock at its end)

    def setup(self) -> None:
        from onepose_tpu_torch import detector
        from onepose_tpu_torch.models import superglue, superpoint

        cfg, dev = self.cfg, self.device
        self.marks.append(("port import", time.perf_counter()))
        self.sp_sd = make_weights(superpoint_shapes(cfg["superpoint"]),
                                  self.seed, "superpoint", dev)
        self.marks.append(("weights", time.perf_counter()))
        self.scene = scenes.paste_scene(cfg, self.tr, self.seed, dev)
        with torch.no_grad(), precision(tf32=False):
            ref_views = ref_sp.extract(
                self.sp_sd, torch.from_numpy(self.scene["views"]).to(dev)[
                    ..., None], cfg["superpoint"])
        sg = cfg["superglue"]
        self.sg_sd = scenes.plant_superglue(
            make_weights(superglue_shapes(sg), self.seed, "superglue", dev),
            sg, ref_views, cfg["planted_delta"], cfg["planted_dustbin"])
        self.marks.append(("scene", time.perf_counter()))
        sp_model = load_module(superpoint.SuperPoint, self.sp_sd,
                               cfg["superpoint"]["descriptor_dim"])
        sg_model = load_module(superglue.SuperGlue, self.sg_sd,
                               tuple(sg["keypoint_encoder"]),
                               sg["num_gnn_layers"])
        sp = cfg["superpoint"]
        self.det = detector.LocalFeatureObjectDetector(
            sp_model, sg_model, list(self.scene["views"]), sp_config=sp,
            sg_config=sg, max_keypoints=sp["max_keypoints"], device=dev)
        self.marks.append(("program", time.perf_counter()))
        self.run_frames("warm", self.tr["warmup_frames"])
        sync(dev)
        self.marks.append(("warm-up", time.perf_counter()))

    def frame(self, tag: str, i: int) -> int:
        rng = np.random.default_rng(sub_seed(self.seed, f"{tag}{i}"))
        return int(rng.integers(self.tr["pool"]))

    def noise(self, tag: str, i: int) -> torch.Tensor:
        return torch.rand((self.cfg["n_ref_view"], SIM_HYPOTHESES,
                           self.cfg["superpoint"]["max_keypoints"]),
                          generator=generator(self.seed, f"{tag}-sim{i}",
                                              self.device),
                          device=self.device)

    def step(self, tag, i, clock=None, spans=False):
        """One frame through the detector's steps → (latency s, the
        outputs the check reads)."""
        from onepose_tpu_torch.models import superglue

        det, frames = self.det, self.scene["frames"]
        img = frames[self.frame(tag, i)]
        noise = self.noise(tag, i)
        span = trace.span if spans else _null
        if clock:
            clock.mark("start")
        t0 = time.perf_counter()
        with span("extract"):
            q = det.extract(torch.as_tensor(img, device=self.device)[
                None, :, :, None])
        if clock:
            clock.mark("extract")
        with span("superglue"):
            data = det.match_data(q, img.shape)
            Z = superglue.log_assignment(det.sg_model, data, det.sg_config)
            m = superglue.mutual_matches(Z, det.sg_config["match_threshold"],
                                         data["mask0"], data["mask1"])
        if clock:
            clock.mark("superglue")
        with span("fit"):
            fits = det.fit(q, m, noise)
            box, inliers = det.box(fits, img.shape)
        if clock:
            clock.mark("fit")
        return time.perf_counter() - t0, (q, Z, m.matches0, fits, box,
                                          inliers)

    def run_frames(self, tag, count=None, deadline=None, clock=None,
                   spans=False, keep=()):
        lat, i = [], 0
        with torch.no_grad():
            while count is None or i < count:
                dt, out = self.step(tag, i, clock, spans)
                lat.append(dt)
                if i in keep:
                    self.kept.append((i, out))
                i += 1
                if deadline is not None and time.perf_counter() >= deadline:
                    break
        return lat

    def window(self, seconds: float, traced: bool) -> dict:
        rng = np.random.default_rng(sub_seed(self.seed, "check"))
        keep = set(rng.choice(self.tr["check_from"], self.tr["check_frames"],
                              replace=False).tolist())
        clock = StageClock(self.device) if traced else None
        t0 = time.perf_counter()
        lat = self.run_frames("win", deadline=t0 + seconds, clock=clock,
                              keep=keep)
        sync(self.device)
        wall = time.perf_counter() - t0
        return {"frames": len(lat), "wall_s": wall,
                "latency_ms": [x * 1e3 for x in lat], "step_s": lat,
                "stages": clock.totals() if clock else {}}

    def profile(self) -> trace.Trace:
        with trace.profiled() as out:
            self.run_frames("trace", self.tr["trace_frames"], spans=True)
        return out[0]

    def shapes(self) -> dict:
        c = self.cfg
        fh, fw = c["frame"]
        k, sg = c["superpoint"]["max_keypoints"], c["superglue"]
        return {"stem": (1, fh, fw),
                "flops_per_frame": flops.superpoint(
                    1, fh, fw, c["superpoint"]["descriptor_dim"])
                + flops.superglue(c["n_ref_view"], k, k, sg["descriptor_dim"],
                                  tuple(sg["keypoint_encoder"]),
                                  sg["num_gnn_layers"])}

    def release(self) -> None:
        self.db_det = self.det.db_det
        del self.det

    # -- the check --------------------------------------------------------
    def check(self, control: bool = False) -> dict:
        """The DB views' features (the detector's set-up) and each kept
        frame's stages against the reference on the program's own inputs
        to them, or with ``control`` the same of the reference run with
        TF32 in the program's place. Beside them, what the scene shows
        (not compared): the box's largest distance from the pasted one,
        and the fewest inliers of a kept frame."""
        sp = self.cfg["superpoint"]
        views = torch.from_numpy(self.scene["views"]).to(self.device)[..., None]
        db = self.db_det
        if control:
            with torch.no_grad(), precision(tf32=True):
                db = ref_sp.extract(self.sp_sd, views, sp)
        readings = [self.judge_features(views, db)]
        for i, (q, Z, m0, fits, box, inliers) in self.kept:
            k = self.frame("win", i)
            img = torch.from_numpy(self.scene["frames"][k]).to(
                self.device)[None, :, :, None]
            noise = self.noise("win", i)
            if control:
                q, Z, m0, fits, inliers = self.reference_outputs(img, db,
                                                                 noise)
            r = self.judge_features(img, q)
            with torch.no_grad(), precision(tf32=False):
                data = self._data(db, q, img.shape[1:3])
                r.update(judge.log_assignment(Z, ref_sg.log_assignment(
                    self.sg_sd, data, self.cfg["superglue"])))
                ref_fits = self._fit(db, q, m0, noise)
            corners = self._corners(fits)
            r.update(judge.boxes(corners, inliers, self._corners(ref_fits),
                                 self._inliers(ref_fits)))
            truth = torch.as_tensor(self.scene["boxes"][k],
                                    dtype=torch.float32, device=self.device)
            r["box_truth_err"] = float((torch.cat([
                corners.amin(0), corners.amax(0)]) - truth).abs().max())
            r["inliers_min"] = float(inliers)
            readings.append(r)
        return judge.merge(readings)

    def reference_outputs(self, img, db, noise):
        with torch.no_grad(), precision(tf32=True):
            q = ref_sp.extract(self.sp_sd, img, self.cfg["superpoint"])
            data = self._data(db, q, img.shape[1:3])
            Z = ref_sg.log_assignment(self.sg_sd, data, self.cfg["superglue"])
            m = ref_sg.mutual_matches(Z, self.cfg["superglue"][
                "match_threshold"], data["mask0"], data["mask1"])
            fits = self._fit(db, q, m.matches0, noise, tf32=True)
        return q, Z, m.matches0, fits, self._inliers(fits)

    def judge_features(self, images, feats) -> dict:
        sp = self.cfg["superpoint"]
        with torch.no_grad(), precision(tf32=False):
            scores, desc = ref_sp.dense_heads(self.sp_sd, images)
            ref = ref_sp.select_keypoints(
                ref_sp.simple_nms(scores, sp["nms_radius"]), desc, sp)
            return judge.features(feats, scores, desc, ref,
                                  sp["keypoint_threshold"])

    def _data(self, db, q, shape):
        v, k = self.cfg["n_ref_view"], q.keypoints.shape[1]
        return {"keypoints0": db.keypoints, "scores0": db.scores,
                "descriptors0": db.descriptors, "mask0": db.mask,
                "keypoints1": q.keypoints.expand(v, k, 2),
                "scores1": q.scores.expand(v, k),
                "descriptors1": q.descriptors.expand(v, k, -1),
                "mask1": q.mask.expand(v, k),
                "shape0": tuple(self.cfg["view"]), "shape1": tuple(shape)}

    def _fit(self, db, q, m0, noise, tf32=False):
        m0 = m0.long()
        dst = q.keypoints[0][m0.clamp(min=0)]
        return ref_sim.ransac_similarity(
            db.keypoints, dst, m0 >= 0, threshold=self.cfg["similarity"][
                "threshold"], num_hypotheses=SIM_HYPOTHESES, noise=noise,
            tf32=tf32)

    def _best(self, fits) -> int:
        return int(fits.num_inliers.argmax())

    def _inliers(self, fits) -> int:
        """The best view's count, 0 where the detector falls back to the
        whole frame."""
        n = int(fits.num_inliers.max())
        return n if n >= self.cfg["similarity"]["min_inliers"] else 0

    def _corners(self, fits) -> torch.Tensor:
        """The view's corners warped by the best view's similarity."""
        b = self._best(fits)
        h, w = self.cfg["view"]
        c = torch.tensor([[0, 0], [w, 0], [0, h], [w, h]],
                         dtype=torch.float32, device=fits.A.device)
        return c @ fits.A[b].T + fits.t[b]

    def describe(self) -> str:
        return (f"paste scene: frames' views {self.scene['which']}, boxes "
                f"{self.scene['boxes'][:4].tolist()} ...")


class _null:
    def __init__(self, *args):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False
