"""SfM feature extraction: batched SuperPoint over an image list → HDF5.

Port of ``onepose_tpu/sfm/extract.py``. One HDF5 group per image path with
``keypoints`` [N, 2], ``descriptors`` [D, N] (dim first), ``scores`` [N]
and ``image_size`` (w, h), as the reference writes them; N is the image's
valid keypoints, in slot order (score-sorted, the lower index winning
ties). Frames go through ``models/superpoint.py`` in batches of 16, so the
stem runs as the hand-written kernel on the card; a batch's outputs come
back to the host in one copy.

The conf's ``keypoint_threshold`` is 0.005, the value the reference's
extraction effectively runs with: its conf spells the key
``keypoints_threshold``, which the model never reads. ``nms_radius`` is 3,
not the model's default 4.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

CONFS = {
    "superpoint": {
        "output": "feats-superpoint",
        "preprocessing": {"grayscale": True, "resize_h": 512,
                          "resize_w": 512},
        "conf": {
            "descriptor_dim": 256,
            "nms_radius": 3,
            "max_keypoints": 4096,
            "keypoint_threshold": 0.005,
        },
    }
}


def load_gray(img_path: str, resize_hw=None) -> np.ndarray:
    """Grayscale image as float32 in [0, 1], resized to ``resize_hw``
    (h, w) when given."""
    import cv2

    img = cv2.imread(img_path, cv2.IMREAD_GRAYSCALE)
    if img is None:
        raise FileNotFoundError(img_path)
    if resize_hw is not None and tuple(img.shape[:2]) != tuple(resize_hw):
        img = cv2.resize(img, (resize_hw[1], resize_hw[0]),
                         interpolation=cv2.INTER_LINEAR)
    return img.astype(np.float32) / 255.0


def extract_to_h5(sp_model, img_lists: List[str], feature_out: str,
                  conf: Optional[dict] = None, batch_size: int = 16,
                  images: Optional[Dict[str, np.ndarray]] = None,
                  device="cuda", mesh=None) -> str:
    """Extract features of every image path in ``img_lists`` into
    ``feature_out`` (HDF5) with ``sp_model`` (a ``SuperPoint``) on
    ``device``. ``images`` optionally holds grayscale float arrays in
    [0, 1] keyed by path (in-memory runs); the others are read from disk
    and resized to the conf's 512x512. ``mesh``: the batches are split
    over its data axis (module docstring; collective: every rank calls
    this, and ``batch_size`` must be a multiple of the data axis)."""
    import contextlib

    from onepose_tpu_torch.utils import hdf5

    from onepose_tpu_torch import runtime
    from onepose_tpu_torch.models import superpoint
    from onepose_tpu_torch.ops.precision import pin_fp32
    from onepose_tpu_torch.parallel import collectives as comm
    from onepose_tpu_torch.parallel import mesh as pmesh

    n_data = pmesh.axis_size(mesh, "data")
    if batch_size % n_data:
        raise ValueError(f"batch_size {batch_size} not divisible by data "
                         f"axis {n_data}")
    device = runtime.resolve_device(device, "extract_to_h5")
    pin_fp32()
    conf = conf or CONFS["superpoint"]
    prep = conf["preprocessing"]
    resize_hw = (prep["resize_h"], prep["resize_w"])
    sp_cfg = dict(conf["conf"])
    sp_cfg.pop("descriptor_dim", None)
    sp_model = pmesh.replicate(mesh, sp_model, device).eval()
    main = comm.is_main_process()

    with (hdf5.File(feature_out, "w") if main
          else contextlib.nullcontext()) as f:
        for start in range(0, len(img_lists), batch_size):
            chunk = img_lists[start:start + batch_size]
            # a tail padded by repeating its last image, split over ranks
            padded = chunk + chunk[-1:] * (-len(chunk) % n_data)
            arrs = [np.asarray(images[p], np.float32)
                    if images is not None and p in images
                    else load_gray(p, resize_hw)
                    for p in padded[pmesh.data_rows(mesh, len(padded))]]
            batch = torch.from_numpy(np.stack(arrs)[..., None]).to(device)
            out = superpoint.extract(sp_model, batch, sp_cfg)
            # one copy a batch: [B, K, 4 + D] of (x, y, score, valid, desc)
            packed = torch.cat([out.keypoints, out.scores[..., None],
                                out.mask[..., None].float(),
                                out.descriptors], dim=-1)
            if mesh is not None:
                packed = comm.all_gather(
                    packed, pmesh.axis_group(mesh, "data")).flatten(0, 1)
            if not main:
                continue
            packed = packed.cpu().numpy()
            for bi, path in enumerate(chunk):
                rows = packed[bi][packed[bi, :, 3] > 0]
                grp = f.create_group(path)
                grp.create_dataset("keypoints", data=rows[:, :2])
                grp.create_dataset("scores", data=rows[:, 2])
                grp.create_dataset("descriptors",
                                   data=np.ascontiguousarray(rows[:, 4:].T))
                # a batch's images share one size
                grp.create_dataset("image_size",
                                   data=np.array(arrs[0].shape[::-1]))
    comm.synchronize()   # the file is whole before any rank reads it
    return feature_out
