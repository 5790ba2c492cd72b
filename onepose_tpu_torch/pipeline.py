"""Frame→pose inference pipeline on one device.

Port of ``onepose_tpu/pipeline.py`` without the mesh: SuperPoint
extraction → GATsSPG 2D-3D matching (``forward_match_only``, through the
fused dual-softmax kernel on a card) → batched LO-RANSAC PnP. Everything
stays on the pipeline's device between the image upload and the poses.

Importing this module pins fp32 (``ops.precision.pin_fp32``): the PnP
solvers need it, and cuDNN would otherwise run the convs in TF32.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from onepose_tpu_torch.datasets.anno import ObjectDB
from onepose_tpu_torch.models import gats_spg, superpoint
from onepose_tpu_torch.ops import epnp
from onepose_tpu_torch.ops.precision import pin_fp32

pin_fp32()


class PoseOutput(NamedTuple):
    poses: torch.Tensor          # [B, 3, 4] world→camera
    num_inliers: torch.Tensor    # [B] int32
    num_matches: torch.Tensor    # [B] int32
    success: torch.Tensor        # [B] bool
    matches0: torch.Tensor       # [B, K] 3D indices, -1 none
    keypoints2d: torch.Tensor    # [B, K, 2]
    descriptors2d: torch.Tensor  # [B, K, D]
    kpt_mask: torch.Tensor       # [B, K]


def poses_from_matches(keypoints2d: torch.Tensor, kpt_mask: torch.Tensor,
                       matches0: torch.Tensor, keypoints3d: torch.Tensor,
                       Ks: torch.Tensor,
                       noise: Optional[epnp.RansacNoise] = None,
                       generator: Optional[torch.Generator] = None,
                       reproj_threshold: float = 5.0,
                       num_hypotheses: int = 512,
                       refine_iters: int = 5) -> epnp.PnPResult:
    """Gather matched 3D points and run RANSAC-PnP per frame.

    keypoints2d [B, K, 2]; kpt_mask [B, K]; matches0 [B, K] (-1 = none);
    keypoints3d [N2, 3] (shared) or [B, N2, 3]; Ks [B, 3, 3]."""
    b = keypoints2d.shape[0]
    if keypoints3d.dim() == 2:
        keypoints3d = keypoints3d.expand(b, *keypoints3d.shape)
    valid = (matches0 >= 0) & kpt_mask
    mkpts3d = torch.gather(
        keypoints3d, 1, matches0.clamp(min=0).long()[..., None].expand(-1, -1, 3))
    return epnp.ransac_pnp(keypoints2d, mkpts3d, valid, Ks,
                           reproj_threshold=reproj_threshold,
                           num_hypotheses=num_hypotheses,
                           refine_iters=refine_iters, noise=noise,
                           generator=generator)


class PosePipeline:
    """One object's pose estimator: the two models and the object's 3D
    descriptor DB on ``device``, and a batched frame→pose call. The
    device is the card unless the caller names another; without a card
    the default raises."""

    def __init__(self, sp_model: superpoint.SuperPoint,
                 gats_model: gats_spg.GATsSPG, db: ObjectDB,
                 sp_config: Optional[dict] = None,
                 gats_config: Optional[dict] = None,
                 reproj_threshold: float = 5.0,
                 num_hypotheses: int = 512,
                 refine_iters: int = 5,
                 device: torch.device | str = "cuda"):
        pin_fp32()
        self.sp_config = dict(superpoint.DEFAULT_CONFIG)
        self.sp_config.update(sp_config or {})
        superpoint.check_fp32(self.sp_config)
        self.gats_config = gats_spg.resolve_config(gats_config)
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("PosePipeline: no CUDA device; pass "
                               "device='cpu' to run on the CPU")
        self.sp_model = sp_model.to(self.device).eval()
        self.gats_model = gats_model.to(self.device).eval()

        def put(x):
            return torch.as_tensor(np.asarray(x), device=self.device)

        self.db = {
            "keypoints3d": put(db.keypoints3d),
            "descriptors3d": put(db.descriptors3d),
            "descriptors2d_db": put(db.descriptors2d_db),
            "mask3d": put(db.mask3d),
        }
        self.reproj_threshold = reproj_threshold
        self.num_hypotheses = num_hypotheses
        self.refine_iters = refine_iters

    def extract(self, images: torch.Tensor) -> superpoint.SuperPointOutput:
        return superpoint.extract(self.sp_model, images, self.sp_config)

    def match(self, det: superpoint.SuperPointOutput) -> gats_spg.MatchOutput:
        b = det.descriptors.shape[0]
        db = self.db
        data = {
            "descriptors2d_query": det.descriptors,
            "descriptors3d_db": db["descriptors3d"].expand(
                b, *db["descriptors3d"].shape),
            "descriptors2d_db": db["descriptors2d_db"].expand(
                b, *db["descriptors2d_db"].shape),
            "mask2d": det.mask,
            "mask3d": db["mask3d"].expand(b, *db["mask3d"].shape),
        }
        return gats_spg.forward_match_only(self.gats_model, data,
                                           self.gats_config)

    def pose(self, det: superpoint.SuperPointOutput,
             match: gats_spg.MatchOutput, Ks: torch.Tensor,
             noise: Optional[epnp.RansacNoise] = None,
             generator: Optional[torch.Generator] = None) -> epnp.PnPResult:
        return poses_from_matches(
            det.keypoints, det.mask, match.matches0, self.db["keypoints3d"],
            Ks, noise=noise, generator=generator,
            reproj_threshold=self.reproj_threshold,
            num_hypotheses=self.num_hypotheses,
            refine_iters=self.refine_iters)

    @torch.no_grad()
    def __call__(self, images, Ks,
                 generator: Optional[torch.Generator] = None,
                 noise: Optional[epnp.RansacNoise] = None) -> PoseOutput:
        """images [B, H, W, 1] float in [0, 1]; Ks [B, 3, 3]. RANSAC's
        sampling noise is ``noise`` when given, else drawn from
        ``generator`` (a generator on the pipeline's device)."""
        images = torch.as_tensor(images, dtype=torch.float32,
                                 device=self.device)
        Ks = torch.as_tensor(Ks, dtype=torch.float32, device=self.device)
        det = self.extract(images)
        match = self.match(det)
        pnp = self.pose(det, match, Ks, noise, generator)
        return PoseOutput(
            poses=pnp.pose,
            num_inliers=pnp.num_inliers,
            num_matches=(match.matches0 >= 0).sum(1).to(torch.int32),
            success=pnp.success,
            matches0=match.matches0,
            keypoints2d=det.keypoints,
            descriptors2d=det.descriptors,
            kpt_mask=det.mask,
        )
