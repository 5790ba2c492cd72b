"""Feature-matching 2D object detector, on one device.

Port of ``onepose_tpu/detector.py``: detect the object in a full query
frame by SuperGlue-matching it against ``n_ref_view`` database views
(:class:`LocalFeatureObjectDetector`), or by LoFTR's detector-free
matching against them (:class:`LoFTRObjectDetector`),
estimate a similarity transform per view, warp the view's corners into the
query to get a bounding box and keep the box with the most inliers; or
project the 3D box with the previous pose.

The DB views' SuperPoint features are extracted once, on the device, when
the detector is built. Per query frame there is one SuperPoint extraction
of the full frame (its stem through the fused stem kernel on a card), one
SuperGlue forward over all views (views are the batch dimension, the query
broadcast to each) and one batched similarity RANSAC. Only the final box
and the crop (cv2) run on the host.

With LoFTR the views' backbone runs once, when the detector is built;
per query frame ``models/loftr.Matcher`` gives every view a static slate
over its coarse cells (the mutual coarse matches, their refined frame
points), and the same batched similarity RANSAC and box follow.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from onepose_tpu_torch import runtime
from onepose_tpu_torch.models import loftr, superglue, superpoint
from onepose_tpu_torch.ops import similarity
from onepose_tpu_torch.ops.precision import pin_fp32
from onepose_tpu_torch.sfm.extract import CONFS
from onepose_tpu_torch.utils import geometry as geo
from onepose_tpu_torch.utils.profiling import span

# below this many inliers the detector falls back to the whole frame
MIN_INLIERS = 6
SIMILARITY_THRESHOLD = 6.0   # pixels, the reference's RANSAC threshold


class DetectResult(NamedTuple):
    bbox: np.ndarray        # [4] x0, y0, x1, y1 (int)
    crop: np.ndarray        # [crop_size, crop_size] float32 in [0, 1]
    K_crop: np.ndarray      # [3, 3]
    inliers: int


def crop_img_by_bbox(image: np.ndarray, bbox, K: Optional[np.ndarray],
                     crop_size: int = 512):
    """Two-stage crop and resize with the intrinsics updated: crop to the
    box at native resolution, then resize to crop_size x crop_size."""
    x0, y0, x1, y1 = [int(v) for v in bbox]
    resize_shape = np.array([y1 - y0, x1 - x0])
    K_crop = None
    if K is not None:
        K_crop, _ = geo.get_K_crop_resize(bbox, K, resize_shape)
    image_crop, _ = geo.get_image_crop_resize(image, bbox, resize_shape)

    bbox_new = np.array([0, 0, x1 - x0, y1 - y0])
    resize_shape = np.array([crop_size, crop_size])
    if K is not None:
        K_crop, _ = geo.get_K_crop_resize(bbox_new, K_crop, resize_shape)
    image_crop, _ = geo.get_image_crop_resize(
        image_crop, bbox_new, resize_shape)
    return image_crop, K_crop


class LocalFeatureObjectDetector:
    """Holds the DB views' features on ``device``; detects per query frame
    with one batched SuperGlue forward and a batched similarity RANSAC.
    The device is the card unless the caller names another; without a card
    the default raises."""

    def __init__(self, sp_model: superpoint.SuperPoint,
                 sg_model: superglue.SuperGlue,
                 db_images: Sequence[np.ndarray],
                 sp_config: Optional[dict] = None,
                 sg_config: Optional[dict] = None,
                 max_keypoints: int = 1024,
                 device: torch.device | str = "cuda"):
        """db_images: grayscale [H, W] float arrays in [0, 1] (the sampled
        reference views), H and W divisible by 8."""
        pin_fp32()
        self.device = runtime.resolve_device(device,
                                             "LocalFeatureObjectDetector")
        # the detector's SuperPoint runs with the extract conf (nms_radius
        # 3), as the reference's does, not the model's own defaults
        self.sp_config = dict(superpoint.DEFAULT_CONFIG)
        self.sp_config.update(CONFS["superpoint"]["conf"])
        self.sp_config.update(sp_config or {})
        self.sp_config["max_keypoints"] = max_keypoints
        self.sg_config = superglue.resolve_config(sg_config)
        self.sp_model = sp_model.to(self.device).eval()
        self.sg_model = sg_model.to(self.device).eval()

        db_stack = torch.as_tensor(
            np.stack([np.asarray(im, np.float32) for im in db_images]),
            device=self.device)[..., None]
        self.db_shape = tuple(db_stack.shape[1:3])  # (H, W)
        self.n_views = db_stack.shape[0]
        self.db_det = self.extract(db_stack)

    def extract(self, images: torch.Tensor) -> superpoint.SuperPointOutput:
        """[B, H, W, 1] on the device → SuperPoint keypoints."""
        return superpoint.extract(self.sp_model, images, self.sp_config)

    def match_data(self, q_det: superpoint.SuperPointOutput,
                   query_shape) -> dict:
        """SuperGlue's input: every DB view (set 0) against the query
        (set 1), the query expanded over the views."""
        v = self.n_views
        k = q_det.keypoints.shape[1]
        return {
            "keypoints0": self.db_det.keypoints,
            "scores0": self.db_det.scores,
            "descriptors0": self.db_det.descriptors,
            "mask0": self.db_det.mask,
            "keypoints1": q_det.keypoints.expand(v, k, 2),
            "scores1": q_det.scores.expand(v, k),
            "descriptors1": q_det.descriptors.expand(
                v, k, q_det.descriptors.shape[-1]),
            "mask1": q_det.mask.expand(v, k),
            "shape0": self.db_shape,
            "shape1": tuple(query_shape),
        }

    def match(self, q_det: superpoint.SuperPointOutput,
              query_shape) -> superglue.SuperGlueOutput:
        return superglue.forward(self.sg_model,
                                 self.match_data(q_det, query_shape),
                                 self.sg_config)

    def fit(self, q_det: superpoint.SuperPointOutput,
            match: superglue.SuperGlueOutput,
            noise: Optional[torch.Tensor] = None,
            generator: Optional[torch.Generator] = None
            ) -> similarity.SimilarityResult:
        """Similarity RANSAC per view on its (DB keypoint → query keypoint)
        matches."""
        m0 = match.matches0.long()
        dst = q_det.keypoints[0][m0.clamp(min=0)]
        return similarity.ransac_similarity(
            self.db_det.keypoints, dst, m0 >= 0,
            threshold=SIMILARITY_THRESHOLD, noise=noise, generator=generator)

    @torch.no_grad()
    def detect_bbox(self, query_img: np.ndarray,
                    noise: Optional[torch.Tensor] = None,
                    generator: Optional[torch.Generator] = None):
        """query_img [H, W] grayscale in [0, 1] → (bbox [4], inliers).

        RANSAC's sampling noise [n_views, 256, max_keypoints] is ``noise``
        when given, else drawn from ``generator`` (on the detector's
        device), else from a generator seeded 0."""
        if noise is None and generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        qh, qw = query_img.shape[:2]
        q_det = self.extract(torch.as_tensor(
            np.asarray(query_img, np.float32),
            device=self.device)[None, :, :, None])
        fits = self.fit(q_det, self.match(q_det, (qh, qw)), noise, generator)
        return self.box(fits, (qh, qw))

    def box(self, fits: similarity.SimilarityResult, query_shape):
        """The DB view corners warped by the best view's similarity →
        (bbox [4], inliers); the whole frame under MIN_INLIERS. A call is the
        span ``box``: its reads of the fit to the host."""
        with span("box"):
            qh, qw = query_shape
            counts = fits.num_inliers.cpu().numpy()
            best = int(np.argmax(counts))
            if counts[best] < MIN_INLIERS:
                # the reference's fallback: the whole frame
                return np.array([0, 0, qw, qh], np.int32), 0

            A = fits.A[best].cpu().numpy()
            t = fits.t[best].cpu().numpy()
            h, w = self.db_shape
            corners = np.array([[0, 0], [w, 0], [0, h], [w, h]], np.float32)
            warped = corners @ A.T + t
            x0, y0 = np.floor(warped.min(axis=0)).astype(np.int32)
            x1, y1 = np.ceil(warped.max(axis=0)).astype(np.int32)
            return np.array([x0, y0, x1, y1], np.int32), int(counts[best])

    def detect(self, query_img: np.ndarray, K: np.ndarray,
               crop_size: int = 512,
               noise: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None) -> DetectResult:
        """Full-frame detection → crop_size² crop + updated intrinsics."""
        bbox, inliers = self.detect_bbox(query_img, noise, generator)
        img_u8 = np.asarray(query_img, np.float32) * 255.0
        crop, K_crop = crop_img_by_bbox(img_u8, bbox, K, crop_size)
        return DetectResult(bbox, crop.astype(np.float32) / 255.0,
                            K_crop, inliers)

    def previous_pose_detect(self, query_img: np.ndarray, K: np.ndarray,
                             pre_pose: np.ndarray,
                             bbox3d_corners: np.ndarray,
                             crop_size: int = 512) -> DetectResult:
        """Track by projection: project the 8 3D box corners with the last
        pose and crop around their 2D bounds."""
        proj = geo.project_points(np.asarray(bbox3d_corners), K,
                                  np.asarray(pre_pose))
        x0, y0 = np.floor(proj.min(axis=0)).astype(np.int32)
        x1, y1 = np.ceil(proj.max(axis=0)).astype(np.int32)
        bbox = np.array([x0, y0, x1, y1], np.int32)
        img_u8 = np.asarray(query_img, np.float32) * 255.0
        crop, K_crop = crop_img_by_bbox(img_u8, bbox, K, crop_size)
        return DetectResult(bbox, crop.astype(np.float32) / 255.0,
                            K_crop, -1)


class LoFTRObjectDetector:
    """The detector with LoFTR as its matcher: the views' backbone, tokens
    and fine windows are computed once, on ``device``; per query frame one
    :class:`loftr.Matcher` call (all views as the batch) and the batched
    similarity RANSAC on the [n_views, view cells] slates, view cell →
    refined frame point. ``box``, ``detect`` and
    ``previous_pose_detect`` are :class:`LocalFeatureObjectDetector`'s.
    The device is the card unless the caller names another; without a
    card the default raises."""

    def __init__(self, loftr_model: loftr.LoFTR,
                 db_images: Sequence[np.ndarray],
                 device: torch.device | str = "cuda"):
        """db_images: grayscale [H, W] float arrays in [0, 1] (the sampled
        reference views), H and W divisible by 8."""
        pin_fp32()
        self.device = runtime.resolve_device(device, "LoFTRObjectDetector")
        db_stack = torch.as_tensor(
            np.stack([np.asarray(im, np.float32) for im in db_images]),
            device=self.device)[:, None]
        self.db_shape = tuple(db_stack.shape[2:])  # (H, W)
        self.n_views = db_stack.shape[0]
        self.matcher = loftr.Matcher(loftr_model.to(self.device).eval(),
                                     db_stack)

    def match(self, query_img: np.ndarray) -> loftr.Matches:
        """query_img [H, W] → LoFTR's slates against every view."""
        return self.matcher(torch.as_tensor(
            np.asarray(query_img, np.float32), device=self.device)[None, None])

    def fit(self, matches: loftr.Matches,
            noise: Optional[torch.Tensor] = None,
            generator: Optional[torch.Generator] = None
            ) -> similarity.SimilarityResult:
        """Similarity RANSAC per view on its (view cell → refined frame
        point) matches."""
        return similarity.ransac_similarity(
            matches.points0, matches.points1, matches.valid,
            threshold=SIMILARITY_THRESHOLD, noise=noise, generator=generator)

    @torch.no_grad()
    def detect_bbox(self, query_img: np.ndarray,
                    noise: Optional[torch.Tensor] = None,
                    generator: Optional[torch.Generator] = None):
        """query_img [H, W] grayscale in [0, 1] → (bbox [4], inliers).

        RANSAC's sampling noise [n_views, 256, view cells] is ``noise``
        when given, else drawn from ``generator`` (on the detector's
        device), else from a generator seeded 0."""
        if noise is None and generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        fits = self.fit(self.match(query_img), noise, generator)
        return self.box(fits, query_img.shape[:2])

    box = LocalFeatureObjectDetector.box
    detect = LocalFeatureObjectDetector.detect
    previous_pose_detect = LocalFeatureObjectDetector.previous_pose_detect
