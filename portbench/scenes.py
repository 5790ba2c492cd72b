"""The traffic generators: inputs made from the seed, on the device, in a
few large draws, and handed the same to the program and to the reference.

- :func:`plane_scene`: crops of one textured plane under a camera that
  translates parallel to it (the pool of host frames of the pose cells),
  an object DB of random descriptors, and the DB's 3D points planted on
  the reference's own matches of the pool, so that PnP has real inliers.
- :func:`paste_scene`: DB views of random texture and full frames with
  one view pasted at a known place (the detection cells), with SuperGlue
  weights planted so that a pasted view is found where it was pasted.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from portbench.common import precision
from portbench.reference import gats_spg as ref_gats
from portbench.reference import superpoint as ref_sp
from portbench.weights import generator


def pinhole(h, w, focal):
    return torch.tensor([[focal, 0.0, w / 2.0], [0.0, focal, h / 2.0],
                         [0.0, 0.0, 1.0]])


def rodrigues(v: torch.Tensor) -> torch.Tensor:
    theta = torch.linalg.vector_norm(v)
    k = v / theta
    kx = torch.tensor([[0.0, -k[2], k[1]], [k[2], 0.0, -k[0]],
                       [-k[1], k[0], 0.0]], dtype=v.dtype, device=v.device)
    return (torch.eye(3, dtype=v.dtype, device=v.device)
            + torch.sin(theta) * kx + (1 - torch.cos(theta)) * kx @ kx)


def unit(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)


def plane_scene(cfg: dict, tr: dict, seed: int, sp_sd: dict, gats_sd: dict,
                device) -> dict:
    """The pose cells' world. A random texture of (crop + 8·shift_steps)²
    pixels is a plane at ``plane_depth`` metres; the pool's ``pool``
    frames are crops of it at offsets drawn in steps of 8 px, so a
    feature keeps its descriptor and moves by the offset. The object DB
    holds ``shape3d`` points of random unit descriptors and leaves; the
    reference extracts the pool and matches it against the DB, and each
    DB point that a frame matches first is put on the plane where that
    frame saw it. The other points stay random in a 0.2 m cube. → frames
    [P, H, W] (host), K [3, 3], the DB tensors, the pool's planted poses,
    its matches a frame and the planted points."""
    h, w, f = cfg["crop"]["height"], cfg["crop"]["width"], cfg["crop"]["focal"]
    steps, pool = tr["shift_steps"], tr["pool"]
    n2, leaf, d = cfg["db"]["shape3d"], cfg["db"]["num_leaf"], \
        cfg["superpoint"]["descriptor_dim"]
    gen = generator(seed, "plane", device)
    texture = torch.rand((h + 8 * steps, w + 8 * steps), generator=gen,
                         device=device)
    offsets = torch.randint(0, steps + 1, (pool, 2), generator=gen,
                            device=device) * 8
    frames = torch.stack([texture[oy:oy + h, ox:ox + w]
                          for ox, oy in offsets.tolist()])
    desc3d = unit(torch.randn((n2, d), generator=gen, device=device))
    leaves = unit(torch.randn((n2 * leaf, d), generator=gen, device=device))
    kpts3d = (torch.rand((n2, 3), generator=gen, device=device) - 0.5) * 0.2
    mask3d = torch.ones(n2, dtype=torch.bool, device=device)
    tilt = (torch.rand(3, generator=gen, device=device) - 0.5) * 2 * tr["tilt"]
    R0 = rodrigues(tilt.double()).float()
    z = tr["plane_depth"]

    gcfg = cfg["gats_spg"]
    with torch.no_grad(), precision(tf32=False):
        feats = ref_sp.extract(sp_sd, frames[..., None], cfg["superpoint"])
        m0 = torch.cat([ref_gats.match(
            gats_sd, feats.descriptors[i:i + 4], feats.mask[i:i + 4],
            desc3d.expand(len(feats.mask[i:i + 4]), -1, -1),
            leaves.expand(len(feats.mask[i:i + 4]), -1, -1),
            mask3d.expand(len(feats.mask[i:i + 4]), -1), gcfg).matches0
            for i in range(0, pool, 4)])
    taken = torch.zeros(n2, dtype=torch.bool, device=device)
    for i in range(pool):
        hit = m0[i] >= 0
        j = m0[i][hit]
        new = ~taken[j]
        uv = feats.keypoints[i][hit][new] + offsets[i].float()
        cam0 = torch.stack([(uv[:, 0] - w / 2.0) * z / f,
                            (uv[:, 1] - h / 2.0) * z / f,
                            torch.full_like(uv[:, 0], z)], -1)
        cam0[:, 2] -= z
        kpts3d[j[new]] = cam0 @ R0        # R0^T (X_cam0 - (0, 0, z))
        taken[j[new]] = True
    t = torch.stack([-offsets[:, 0].float() * z / f,
                     -offsets[:, 1].float() * z / f,
                     torch.full((pool,), z, device=device)], -1)
    poses = torch.cat([R0.expand(pool, 3, 3), t[..., None]], -1)
    return {"frames": frames.cpu(), "K": pinhole(h, w, f),
            "keypoints3d": kpts3d,
            "descriptors3d": desc3d, "descriptors2d_db": leaves,
            "mask3d": mask3d, "poses": poses.cpu(),
            "matches": (m0 >= 0).sum(1).tolist(),
            "planted": int(taken.sum())}


def paste_scene(cfg: dict, tr: dict, seed: int, device) -> dict:
    """The detection cells' world: ``n_ref_view`` DB views of random
    texture, and ``pool`` full frames of random texture each with one
    view pasted at an offset in steps of 8 px (so the view's features
    keep their descriptors). → views [V, h, w] and frames [P, H, W] on
    the host, and each frame's view and pasted box."""
    v, (vh, vw) = cfg["n_ref_view"], cfg["view"]
    fh, fw = cfg["frame"]
    pool = tr["pool"]
    gen = generator(seed, "paste", device)
    views = torch.rand((v, vh, vw), generator=gen, device=device)
    frames = torch.rand((pool, fh, fw), generator=gen, device=device)
    which = torch.randint(0, v, (pool,), generator=gen, device=device)
    ox = torch.randint(0, (fw - vw) // 8 + 1, (pool,), generator=gen,
                       device=device) * 8
    oy = torch.randint(0, (fh - vh) // 8 + 1, (pool,), generator=gen,
                       device=device) * 8
    boxes = []
    for i, (k, x, y) in enumerate(zip(which.tolist(), ox.tolist(),
                                      oy.tolist())):
        frames[i, y:y + vh, x:x + vw] = views[k]
        boxes.append([x, y, x + vw, y + vh])
    return {"views": views.cpu().numpy(), "frames": frames.cpu().numpy(),
            "which": which.tolist(), "boxes": np.array(boxes)}


def plant_superglue(sd: dict, cfg: dict, db_feats, delta: float,
                    dustbin: float, target: float = 50.0) -> dict:
    """SuperGlue weights for a check without a trained checkpoint: the
    keypoint encoder's and each layer's last linear scaled by ``delta``,
    a final projection s·W(x - mu) that whitens the DB views' valid
    descriptors (random SuperPoint descriptors share one dominant
    direction and vary in few others; W is their covariance's inverse
    square root, its eigenvalues floored at a tenth of their mean), s
    such that a typical self-match scores ``target`` and an unrelated
    pair about target/16, and a dustbin score of ``dustbin`` between the
    two. Matching is then descriptor self-similarity, moved a little by
    every layer: a pasted view is found where it was pasted."""
    sd = {k: v.clone() for k, v in sd.items()}
    last = len(cfg["keypoint_encoder"]) - 1
    for name in [f"kenc.lin.{last}"] + [f"gnn.{i}.mlp.lin.1"
                                        for i in range(cfg["num_gnn_layers"])]:
        sd[f"{name}.weight"] *= delta
        sd[f"{name}.bias"] *= delta
    desc = db_feats.descriptors[db_feats.mask].double()
    mu = desc.mean(0)
    d = desc.shape[1]
    lam, vec = torch.linalg.eigh(torch.cov((desc - mu).T))
    lam = lam.clamp(min=0.1 * float(lam.mean()))
    white = vec @ torch.diag(lam.rsqrt()) @ vec.T
    scale = math.sqrt(target * math.sqrt(d) / float(
        ((desc - mu) @ white).square().sum(-1).median()))
    sd["final_proj.weight"] = (white * scale).float()
    sd["final_proj.bias"] = (-scale * (white @ mu)).float()
    sd["bin_score"] = torch.full_like(sd["bin_score"], dustbin)
    return sd
