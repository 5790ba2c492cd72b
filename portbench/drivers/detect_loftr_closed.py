"""Driver ``detect_loftr_closed``: a closed loop of full frames through
``LoFTRObjectDetector``, one frame at a time, as the offline detection
of every frame runs with LoFTR as the detector's matcher.

The views' backbone, tokens and fine windows are computed when the
detector is built (set-up). Each frame, drawn from the paste scene's pool
in an order drawn from the seed, goes through ``detect_bbox``'s steps: the
upload, the LoFTR matcher (``loftr.Matcher.__call__``: the frame's
backbone, the coarse transformer over the 15 pairs, the match kernel and
the mask rule, the fine stage over every slot), the similarity RANSAC per
view on the [views, view cells] slates, and the box on the host. After the
box the frame's mutual coarse matches (the matcher's ``last_matches``, a
device tensor) are read. A frame's time runs from its submission to its
box on the host. RANSAC's noise is drawn on the card from the seed for
each frame. With ``--trace 1`` the matcher's ``mark`` hook places CUDA
events at its stage ends (``backbone``, ``coarse``, ``match``, ``fine``)
and one more after the box (``fit``).

The check judges each stage on the program's own inputs to it (the
matcher keeps a checked frame's maps and features on request): the
frame's backbone maps and the views' tokens, the coarse transformer's
output, the coarse slate, the refined points of the program's matches
(the reference's fine stage on the matched rows, its view fine maps its
own), and the box from the reference fit on the program's matches with
the same noise. The reference runs in blocks of ``REF_BLOCK`` views.

Traffic keys: ``pool``, ``warmup_frames``, ``trace_frames``,
``check_frames`` (drawn among the first ``check_from``).
"""
from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from portbench import flops, flops_loftr, judge, loftr_scene, scenes, trace
from portbench.common import StageClock, precision, sync
from portbench.reference import loftr as ref
from portbench.reference import similarity as ref_sim
from portbench.weights import generator, sub_seed

SIM_HYPOTHESES = 256      # the detector's similarity RANSAC
REF_BLOCK = 3             # views per block of the reference


class Cell:
    def __init__(self, work: dict, seed: int, device):
        self.cfg, self.tr = work["config_data"], work["traffic_data"]
        self.seed, self.device = seed, torch.device(device)
        self.kept = []
        self.marks = []     # (set-up phase, host clock at its end)

    def setup(self) -> None:
        from onepose_tpu_torch import detector
        from onepose_tpu_torch.models import loftr

        cfg, dev = self.cfg, self.device
        self.lcfg = loftr.resolve_config(cfg["loftr"])
        self.marks.append(("port import", time.perf_counter()))
        sd = loftr_scene.loftr_weights(self.lcfg, self.seed, dev)
        self.marks.append(("weights", time.perf_counter()))
        self.scene = scenes.paste_scene(cfg, self.tr, self.seed, dev)
        self.views = torch.from_numpy(self.scene["views"]).to(dev)[:, None]
        self.marks.append(("scene", time.perf_counter()))
        p = cfg["planted"]
        self.sd = loftr_scene.plant_loftr(sd, self.lcfg, self.views,
                                          p["delta"], p["self_score"],
                                          p["fine_score"])
        self.marks.append(("planting", time.perf_counter()))
        with torch.device(dev):
            model = loftr.LoFTR(self.lcfg)
        model.load_state_dict(self.sd, strict=True)
        self.det = detector.LoFTRObjectDetector(
            model, list(self.scene["views"]), device=dev)
        self.n0 = self.det.matcher.view_tokens.shape[1]
        self.marks.append(("program", time.perf_counter()))
        self.run_frames("warm", self.tr["warmup_frames"])
        sync(dev)
        self.marks.append(("warm-up", time.perf_counter()))

    def frame(self, tag: str, i: int) -> int:
        rng = np.random.default_rng(sub_seed(self.seed, f"{tag}{i}"))
        return int(rng.integers(self.tr["pool"]))

    def noise(self, tag: str, i: int) -> torch.Tensor:
        return torch.rand((self.cfg["n_ref_view"], SIM_HYPOTHESES, self.n0),
                          generator=generator(self.seed, f"{tag}-sim{i}",
                                              self.device),
                          device=self.device)

    def step(self, tag, i, clock=None, spans=False, keep=None):
        """One frame through the detector's steps → (latency s, matches,
        the outputs the check reads)."""
        det = self.det
        img = self.scene["frames"][self.frame(tag, i)]
        noise = self.noise(tag, i)
        span = trace.span if spans else contextlib.nullcontext
        det.matcher.mark = clock.mark if clock else None
        if clock:
            clock.mark("start")
        t0 = time.perf_counter()
        with span("loftr"):
            frame = torch.as_tensor(img, device=self.device)[None, None]
            m = det.matcher(frame, keep)
        with span("fit"):
            fits = det.fit(m, noise)
            box, inliers = det.box(fits, img.shape)
        if clock:
            clock.mark("fit")
        dt = time.perf_counter() - t0
        return dt, int(det.matcher.last_matches), (m, fits, inliers)

    def run_frames(self, tag, count=None, deadline=None, clock=None,
                   spans=False, keep=(), counts=None):
        lat, i = [], 0
        with torch.no_grad():
            while count is None or i < count:
                kept = {} if i in keep else None
                dt, n, out = self.step(tag, i, clock, spans, kept)
                lat.append(dt)
                if counts is not None:
                    counts.append(n)
                if kept is not None:
                    self.kept.append((i, kept, out))
                i += 1
                if deadline is not None and time.perf_counter() >= deadline:
                    break
        return lat

    def window(self, seconds: float, traced: bool) -> dict:
        rng = np.random.default_rng(sub_seed(self.seed, "check"))
        keep = set(rng.choice(self.tr["check_from"], self.tr["check_frames"],
                              replace=False).tolist())
        clock = StageClock(self.device) if traced else None
        counts = []
        t0 = time.perf_counter()
        lat = self.run_frames("win", deadline=t0 + seconds, clock=clock,
                              keep=keep, counts=counts)
        sync(self.device)
        wall = time.perf_counter() - t0
        self.det.matcher.mark = None
        return {"frames": len(lat), "wall_s": wall,
                "latency_ms": [x * 1e3 for x in lat], "step_s": lat,
                "matches": counts,
                "stages": clock.totals() if clock else {}}

    def profile(self) -> trace.Trace:
        with trace.profiled() as out:
            self.run_frames("trace", self.tr["trace_frames"], spans=True)
        return out[0]

    def shapes(self) -> dict:
        c, v = self.cfg, self.cfg["n_ref_view"]
        s = self.lcfg["resolution"][0]
        n0 = c["view"][0] // s * (c["view"][1] // s)
        n1 = c["frame"][0] // s * (c["frame"][1] // s)
        return {"match": (v, n0, n1, self.lcfg["coarse"]["d_model"]),
                "flops_per_frame": flops_loftr.frame(
                    v, tuple(c["view"]), tuple(c["frame"]), self.lcfg)}

    def release(self) -> None:
        self.view_tokens = self.det.matcher.view_tokens
        self.points0 = self.det.matcher.points0
        del self.det

    # -- the check --------------------------------------------------------
    def check(self, control: bool = False) -> dict:
        """Each kept frame's stages against the reference on the program's
        own inputs to them, or with ``control`` the same of the reference
        run with TF32 in the program's place. Beside them, what the scene
        shows (not compared): the box's largest distance from the pasted
        one, the fewest inliers and matches of a kept frame, and the
        kept frames whose best view is not the pasted one."""
        with torch.no_grad(), precision(tf32=False):
            ref_c0, ref_f0 = ref.backbone(self.sd, self.views)
            ref_tok0 = ref.add_position_encoding(ref_c0)
        readings = []
        for i, kept, (m, fits, inliers) in self.kept:
            k = self.frame("win", i)
            img = torch.from_numpy(self.scene["frames"][k]).to(
                self.device)[None, None]
            noise = self.noise("win", i)
            tok0 = self.view_tokens
            if control:
                kept, m, tok0 = self.reference_outputs(img)
                fits = self._fit(m, noise, tf32=True)
                inliers = self._inliers(fits)
            r = self.judge_frame(img, kept, m, tok0, ref_tok0, ref_f0)
            with torch.no_grad(), precision(tf32=False):
                ref_fits = self._fit(m, noise)
            corners = self._corners(fits)
            r.update(judge.boxes(corners, inliers, self._corners(ref_fits),
                                 self._inliers(ref_fits)))
            truth = torch.as_tensor(self.scene["boxes"][k],
                                    dtype=torch.float32, device=self.device)
            r["box_truth_err"] = float((torch.cat([
                corners.amin(0), corners.amax(0)]) - truth).abs().max())
            r["inliers_min"] = float(inliers)
            r["matches_min"] = float(m.valid.sum())
            r["wrong_view"] = (int(int(fits.num_inliers.argmax())
                                   != self.scene["which"][k]), 1)
            readings.append(r)
        return judge.merge(readings)

    def judge_frame(self, img, kept, m, tok0, ref_tok0, ref_f0) -> dict:
        """The readings of one frame: ``kept`` holds the frame's maps and
        the transformer's output that gave the slate ``m``."""
        sd, lc = self.sd, self.lcfg
        c = lc["coarse"]
        hw1 = tuple(kept["coarse1"].shape[2:])
        hw0 = (self.cfg["view"][0] // 8, self.cfg["view"][1] // 8)
        out = {"match_moved": (0, 0), "mconf_err": 0.0, "fine_err": 0.0,
               "coarse_feat_err": 0.0}
        with torch.no_grad(), precision(tf32=False):
            c1, f1 = ref.backbone(sd, img)
            out["coarse_map_err"] = max(_rel(kept["coarse1"], c1),
                                        _rel(tok0, ref_tok0))
            out["fine_map_err"] = _rel(kept["fine1"], f1)
            tok1 = ref.add_position_encoding(kept["coarse1"])
            for a in range(0, len(tok0), REF_BLOCK):
                blk = slice(a, a + REF_BLOCK)
                f0, f1b = kept["feat0"][blk], kept["feat1"][blk]
                rf0, rf1 = ref.transformer(sd, "loftr_coarse",
                                           c["layer_names"], tok0[blk],
                                           tok1.expand(len(f0), -1, -1),
                                           c["nhead"])
                out["coarse_feat_err"] = max(out["coarse_feat_err"],
                                             _rel(f0, rf0), _rel(f1b, rf1))
                mc = lc["match_coarse"]
                rm = ref.coarse_match(f0, f1b, hw0, hw1, mc["thr"],
                                      mc["border_rm"],
                                      mc["dsmax_temperature"])
                valid, j, conf = m.valid[blk], m.j[blk], m.conf[blk]
                rv = torch.zeros_like(valid)
                rj = torch.full_like(j, -1)
                rconf = torch.zeros_like(conf)
                rv[rm.b_ids, rm.i_ids] = True
                rj[rm.b_ids, rm.i_ids] = rm.j_ids
                rconf[rm.b_ids, rm.i_ids] = rm.mconf
                differ = (valid != rv) | (valid & rv & (j != rj))
                n, tot = out["match_moved"]
                out["match_moved"] = (n + int(differ.sum()),
                                      tot + int((valid | rv).sum()))
                both = valid & rv & (j == rj)
                if both.any():
                    out["mconf_err"] = max(out["mconf_err"], float(
                        ((conf - rconf).abs() / rconf)[both].max()))
                b, i = torch.nonzero(valid, as_tuple=True)
                mine = ref.CoarseMatches(b, i, j[b, i], conf[b, i], None)
                _, p1 = ref.fine(sd, lc, ref_f0[blk],
                                 kept["fine1"].expand(len(f0), -1, -1, -1),
                                 f0, f1b, mine, hw0, hw1)
                if len(b):
                    out["fine_err"] = max(out["fine_err"], float(
                        (m.points1[blk][b, i] - p1).abs().max()))
        return out

    def reference_outputs(self, img):
        """The control: the reference with TF32 in the program's place →
        (the maps and features, the slate, the view tokens)."""
        from onepose_tpu_torch.models import loftr

        sd, lc = self.sd, self.lcfg
        c, mc = lc["coarse"], lc["match_coarse"]
        with torch.no_grad():
            c0, f0 = ref.backbone(sd, self.views, tf32=True)
            tok0 = ref.add_position_encoding(c0)
            c1, f1 = ref.backbone(sd, img, tf32=True)
            tok1 = ref.add_position_encoding(c1)
            hw0, hw1 = tuple(c0.shape[2:]), tuple(c1.shape[2:])
            v, n0 = tok0.shape[:2]
            valid = torch.zeros(v, n0, dtype=torch.bool, device=img.device)
            j = torch.zeros(v, n0, dtype=torch.long, device=img.device)
            conf = torch.zeros(v, n0, device=img.device)
            points1 = self.points0.clone()
            feats = []
            for a in range(0, v, REF_BLOCK):
                blk = slice(a, a + REF_BLOCK)
                g0, g1 = ref.transformer(sd, "loftr_coarse",
                                         c["layer_names"], tok0[blk],
                                         tok1.expand(len(tok0[blk]), -1, -1),
                                         c["nhead"], tf32=True)
                feats.append((g0, g1))
                rm = ref.coarse_match(g0, g1, hw0, hw1, mc["thr"],
                                      mc["border_rm"],
                                      mc["dsmax_temperature"], tf32=True)
                _, p1 = ref.fine(sd, lc, f0[blk],
                                 f1.expand(len(g0), -1, -1, -1), g0, g1, rm,
                                 hw0, hw1, tf32=True)
                b = rm.b_ids + a
                valid[b, rm.i_ids] = True
                j[b, rm.i_ids] = rm.j_ids
                conf[b, rm.i_ids] = rm.mconf
                points1[b, rm.i_ids] = p1
        kept = {"coarse1": c1, "fine1": f1,
                "feat0": torch.cat([f[0] for f in feats]),
                "feat1": torch.cat([f[1] for f in feats])}
        return kept, loftr.Matches(valid, self.points0, points1, conf, j), \
            tok0

    def _fit(self, m, noise, tf32=False):
        return ref_sim.ransac_similarity(
            m.points0, m.points1, m.valid,
            threshold=self.cfg["similarity"]["threshold"],
            num_hypotheses=SIM_HYPOTHESES, noise=noise, tf32=tf32)

    def _inliers(self, fits) -> int:
        """The best view's count, 0 where the detector falls back to the
        whole frame."""
        n = int(fits.num_inliers.max())
        return n if n >= self.cfg["similarity"]["min_inliers"] else 0

    def _corners(self, fits) -> torch.Tensor:
        """The view's corners warped by the best view's similarity."""
        b = int(fits.num_inliers.argmax())
        h, w = self.cfg["view"]
        c = torch.tensor([[0, 0], [w, 0], [0, h], [w, h]],
                         dtype=torch.float32, device=fits.A.device)
        return c @ fits.A[b].T + fits.t[b]

    def describe(self) -> str:
        return (f"paste scene: frames' views {self.scene['which']}, boxes "
                f"{self.scene['boxes'][:4].tolist()} ...; match shape "
                f"{self.shapes()['match']}, "
                f"{flops.match(*self.shapes()['match']) / 1e12:.3f} TFLOP "
                f"an S")


def _rel(a, b) -> float:
    """Largest |a - b| over the largest |b|."""
    return float((a - b).abs().max() / b.abs().max())

