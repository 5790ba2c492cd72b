"""Frame→pose inference pipeline.

Port of ``onepose_tpu/pipeline.py``: SuperPoint extraction → GATsSPG 2D-3D
matching (``forward_match_only``, through the fused dual-softmax kernel on
a card) → batched LO-RANSAC PnP. Everything stays on the pipeline's device
between the image upload and the poses. With ``mesh=`` (a world of ranks,
one card each, ``parallel/mesh.py``) the batch is split over the data
axis, the object's 3D tokens over the model axis, and every rank returns
the whole batch's outputs.

Importing this module pins fp32 (``ops.precision.pin_fp32``): the PnP
solvers need it, and cuDNN would otherwise run the convs in TF32.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from onepose_tpu_torch import runtime
from onepose_tpu_torch.datasets.anno import ObjectDB
from onepose_tpu_torch.models import gats_spg, superpoint
from onepose_tpu_torch.ops import epnp
from onepose_tpu_torch.ops.precision import pin_fp32
from onepose_tpu_torch.parallel import collectives as comm
from onepose_tpu_torch.parallel import mesh as pmesh

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


def match_rows(gats_model: gats_spg.GATsSPG,
               det: superpoint.SuperPointOutput, db_rows: dict,
               gats_config: dict, token_group=None) -> gats_spg.MatchOutput:
    """GATsSPG 2D-3D matching of B frames, frame b against DB row b.

    ``db_rows`` holds ``descriptors3d``, ``descriptors2d_db`` and ``mask3d``
    with a leading [B] axis: one object's DB expanded over the batch, or
    rows gathered from a stack of objects. Descriptors stored in a lower
    precision are upcast here; the matcher computes in fp32.
    ``token_group``: the three hold this rank's shard of the group's 3D
    tokens (``gats_spg.forward_match_only``); the matches index the whole
    tokens."""
    data = {
        "descriptors2d_query": det.descriptors,
        "descriptors3d_db": db_rows["descriptors3d"].float(),
        "descriptors2d_db": db_rows["descriptors2d_db"].float(),
        "mask2d": det.mask,
        "mask3d": db_rows["mask3d"],
    }
    return gats_spg.forward_match_only(gats_model, data, gats_config,
                                       token_group)


@torch.no_grad()
def frame_step(sp_model: superpoint.SuperPoint,
               gats_model: gats_spg.GATsSPG, db_rows: dict,
               images: torch.Tensor, Ks: torch.Tensor, sp_config: dict,
               gats_config: dict, noise: Optional[epnp.RansacNoise] = None,
               generator: Optional[torch.Generator] = None,
               reproj_threshold: float = 5.0, num_hypotheses: int = 512,
               refine_iters: int = 5, token_group=None) -> PoseOutput:
    """Frames → poses: extraction, :func:`match_rows` and
    :func:`poses_from_matches`. images [B, H, W, 1]; Ks [B, 3, 3];
    ``db_rows`` as for :func:`match_rows` (``token_group`` too), with
    ``keypoints3d`` [B, N2, 3] whole. Both :class:`PosePipeline` and the
    multi-object server run this (the server with whole tokens: its model
    axis shards objects)."""
    det = superpoint.extract(sp_model, images, sp_config)
    match = match_rows(gats_model, det, db_rows, gats_config, token_group)
    pnp = poses_from_matches(
        det.keypoints, det.mask, match.matches0, db_rows["keypoints3d"], Ks,
        noise=noise, generator=generator, reproj_threshold=reproj_threshold,
        num_hypotheses=num_hypotheses, refine_iters=refine_iters)
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


def gather_rows(mesh, out: PoseOutput) -> PoseOutput:
    """Each rank's rows of a batch's outputs all-gathered over ``mesh``'s
    data axis, in batch order: every rank gets the whole batch."""
    group = pmesh.axis_group(mesh, "data")
    return PoseOutput(*(comm.all_gather(x, group).flatten(0, 1) for x in out))


def rank_rows(mesh, n: int, noise: Optional[epnp.RansacNoise],
              generator: Optional[torch.Generator], n_kpts: int,
              num_hypotheses: int, device) -> tuple:
    """(this rank's rows of a batch of ``n``, their RANSAC noise). The
    noise is the global batch's (``noise``, or drawn from ``generator`` as
    one process draws it for the whole batch), so that a world of any size
    reproduces one rank's run."""
    rows = pmesh.data_rows(mesh, n)
    if noise is None:
        noise = epnp.draw_noise(n, n_kpts, num_hypotheses, 64, generator,
                                device=device)
    return rows, epnp.RansacNoise(*(x[rows] for x in noise))


class PosePipeline:
    """One object's pose estimator: the two models and the object's 3D
    descriptor DB on ``device``, and a batched frame→pose call. The
    device is the card unless the caller names another; without a card
    the default raises.

    ``mesh`` (``parallel/mesh.py``, ("data", "model") axes over a world
    of ranks): the models and the DB are broadcast from rank 0, each rank
    runs its rows of the batch on its card (the data-axis size must
    divide the batch), and the outputs are all-gathered over ``data``, so
    every rank returns the whole batch's. A model axis of m > 1 shards the
    object's N2 3D tokens when m divides N2 (``pmesh.token_rows``): each
    rank keeps its N2/m rows of ``descriptors3d``, ``descriptors2d_db``
    and ``mask3d``, and ``keypoints3d`` whole (PnP gathers from it); the
    ranks of a model group run the same rows' extraction and PnP, and
    the GNN over the group (``gats_spg``'s ``token_group``). When m does
    not divide N2 every rank holds the whole DB: the same math."""

    def __init__(self, sp_model: superpoint.SuperPoint,
                 gats_model: gats_spg.GATsSPG, db: ObjectDB,
                 sp_config: Optional[dict] = None,
                 gats_config: Optional[dict] = None,
                 reproj_threshold: float = 5.0,
                 num_hypotheses: int = 512,
                 refine_iters: int = 5,
                 device: torch.device | str = "cuda",
                 mesh=None):
        pin_fp32()
        self.sp_config = dict(superpoint.DEFAULT_CONFIG)
        self.sp_config.update(sp_config or {})
        self.gats_config = gats_spg.resolve_config(gats_config)
        self.device = runtime.resolve_device(device, "PosePipeline")
        self.mesh = mesh
        db = {k: getattr(db, k) for k in (
            "keypoints3d", "descriptors3d", "descriptors2d_db", "mask3d")}
        self.sp_model = pmesh.replicate(mesh, sp_model, self.device).eval()
        self.gats_model = pmesh.replicate(mesh, gats_model,
                                          self.device).eval()
        self.db = pmesh.replicate(mesh, db, self.device)
        n2 = len(self.db["keypoints3d"])
        self.token_group = pmesh.token_group(mesh, n2)
        if self.token_group is not None:    # keep this rank's shard only
            self.db.update({k: v.clone() for k, v in pmesh.token_shard(
                mesh, n2, {k: self.db[k] for k in (
                    "descriptors3d", "descriptors2d_db", "mask3d")}).items()})
        self.reproj_threshold = reproj_threshold
        self.num_hypotheses = num_hypotheses
        self.refine_iters = refine_iters

    def extract(self, images: torch.Tensor) -> superpoint.SuperPointOutput:
        return superpoint.extract(self.sp_model, images, self.sp_config)

    def rows(self, b: int) -> dict:
        """The object's DB expanded over a batch of ``b`` frames."""
        return {k: v.expand(b, *v.shape) for k, v in self.db.items()}

    def match(self, det: superpoint.SuperPointOutput) -> gats_spg.MatchOutput:
        return match_rows(self.gats_model, det,
                          self.rows(det.descriptors.shape[0]),
                          self.gats_config, self.token_group)

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
        ``generator`` (a generator on the pipeline's device). Under a mesh
        every rank passes the whole batch (and the same ``noise``, or a
        generator in the same state) and gets the whole batch's outputs."""
        images = torch.as_tensor(images, dtype=torch.float32)
        Ks = torch.as_tensor(Ks, dtype=torch.float32)
        rows = pmesh.data_rows(self.mesh, images.shape[0])
        return self.run_rows(images[rows].to(self.device),
                             Ks[rows].to(self.device), generator, noise)

    @torch.no_grad()
    def run_rows(self, images: torch.Tensor, Ks: torch.Tensor,
                 generator: Optional[torch.Generator] = None,
                 noise: Optional[epnp.RansacNoise] = None) -> PoseOutput:
        """The frame step on this rank's rows of a batch (under a mesh,
        ``pmesh.data_rows`` of it; else the whole batch), already on the
        pipeline's device. ``noise`` is the whole batch's, or drawn for
        the whole batch from ``generator``; the outputs are the whole
        batch's."""
        if self.mesh is not None:
            n = images.shape[0] * pmesh.axis_size(self.mesh, "data")
            _, noise = rank_rows(self.mesh, n, noise, generator,
                                 self.sp_config["max_keypoints"],
                                 self.num_hypotheses, self.device)
        out = frame_step(
            self.sp_model, self.gats_model, self.rows(images.shape[0]),
            images, Ks, self.sp_config, self.gats_config, noise=noise,
            generator=generator, reproj_threshold=self.reproj_threshold,
            num_hypotheses=self.num_hypotheses,
            refine_iters=self.refine_iters, token_group=self.token_group)
        return out if self.mesh is None else gather_rows(self.mesh, out)
