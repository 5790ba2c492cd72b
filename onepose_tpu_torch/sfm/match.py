"""SfM pair matching: batched SuperGlue over covisible pairs → HDF5.

Port of ``onepose_tpu/sfm/match.py``. One group per pair named
``name0.replace('/','-') + '_' + name1.replace('/','-')`` with datasets
``matches0`` and ``matching_scores0``; symmetric duplicates are skipped,
as the reference does. Pairs are matched in batches of 8 through
``models/superglue.py`` (100 Sinkhorn iterations, threshold 0.7), with
keypoint counts padded up to shared bucket sizes (``BUCKETS``): padded
descriptors are ones, padded slots masked by ``mask0`` / ``mask1``. A
batch's matches come back to the host in one copy.

With ``mesh=`` (``parallel/mesh.py``) each batch of pairs is padded to a
multiple of the data axis by repeating its last pair and split over it;
the matches are all-gathered and rank 0 alone writes the file.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

CONF = {
    "sinkhorn_iterations": 100,
    "match_threshold": 0.7,  # reference SfM conf (match_features.py:8-17)
}

BUCKETS = (256, 512, 1024, 2048, 4096)


def names_to_pair(name0: str, name1: str) -> str:
    return "_".join((name0.replace("/", "-"), name1.replace("/", "-")))


def _bucket(n: int) -> int:
    for b in BUCKETS:
        if n <= b:
            return b
    return BUCKETS[-1]


def _pad_feats(kpts, scores, descs, size):
    k = kpts.shape[0]
    if k > size:
        kpts, scores, descs = kpts[:size], scores[:size], descs[:size]
        k = size
    pad = size - k
    kpts = np.concatenate([kpts, np.zeros((pad, 2), np.float32)])
    scores = np.concatenate([scores, np.zeros(pad, np.float32)])
    descs = np.concatenate(
        [descs, np.ones((pad, descs.shape[1]), np.float32)])
    mask = np.zeros(size, bool)
    mask[:k] = True
    return kpts, scores, descs, mask


def match_pairs_to_h5(sg_model, pairs: Sequence[Tuple[str, str]],
                      feature_path: str, match_out: str,
                      conf: Optional[dict] = None, batch_size: int = 8,
                      device="cuda", mesh=None) -> str:
    """Match each (name0, name1) pair with ``sg_model`` (a ``SuperGlue``)
    on ``device``, from the features in ``feature_path``, into
    ``match_out``. ``mesh``: the pair batches are split over its data axis
    (module docstring; collective, and ``batch_size`` must be a multiple
    of the data axis)."""
    import contextlib

    from onepose_tpu_torch.utils import hdf5

    from onepose_tpu_torch import runtime
    from onepose_tpu_torch.models import superglue
    from onepose_tpu_torch.ops.precision import pin_fp32
    from onepose_tpu_torch.parallel import collectives as comm
    from onepose_tpu_torch.parallel import mesh as pmesh

    n_data = pmesh.axis_size(mesh, "data")
    if batch_size % n_data:
        raise ValueError(f"batch_size {batch_size} not divisible by data "
                         f"axis {n_data}")
    device = runtime.resolve_device(device, "match_pairs_to_h5")
    pin_fp32()
    sg_conf = dict(CONF)
    sg_conf.update(conf or {})
    sg_model = pmesh.replicate(mesh, sg_model, device).eval()
    main = comm.is_main_process()

    # dedup symmetric pairs (the reference's match_features.py:47-56)
    seen = set()
    todo = []
    for name0, name1 in pairs:
        if (name0, name1) in seen or (name1, name0) in seen:
            continue
        seen.add((name0, name1))
        todo.append((name0, name1))

    feats: Dict[str, dict] = {}
    with hdf5.File(feature_path, "r") as ff:
        for name in dict.fromkeys(n for pair in todo for n in pair):
            g = ff[name]
            feats[name] = {
                "keypoints": g["keypoints"][()].astype(np.float32),
                "scores": g["scores"][()].astype(np.float32),
                "descriptors": g["descriptors"][()].astype(np.float32).T,
                "image_size": g["image_size"][()],
            }

    # group by (bucket0, bucket1, shapes): a batch shares its shapes
    groups: Dict[tuple, List[Tuple[str, str]]] = {}
    for name0, name1 in todo:
        b0 = _bucket(feats[name0]["keypoints"].shape[0])
        b1 = _bucket(feats[name1]["keypoints"].shape[0])
        s0 = tuple(int(v) for v in feats[name0]["image_size"][::-1])
        s1 = tuple(int(v) for v in feats[name1]["image_size"][::-1])
        groups.setdefault((b0, b1, s0, s1), []).append((name0, name1))

    keys = ("keypoints", "scores", "descriptors", "mask")
    with (hdf5.File(match_out, "w") if main
          else contextlib.nullcontext()) as out:
        for (b0, b1, s0, s1), group_pairs in groups.items():
            for start in range(0, len(group_pairs), batch_size):
                chunk = group_pairs[start:start + batch_size]
                # a tail padded by repeating its last pair, split over ranks
                padded = chunk + chunk[-1:] * (-len(chunk) % n_data)
                data = {f"{k}{i}": [] for i in "01" for k in keys}
                for name0, name1 in padded[pmesh.data_rows(mesh,
                                                           len(padded))]:
                    for i, name, b in (("0", name0, b0), ("1", name1, b1)):
                        f = feats[name]
                        for k, v in zip(keys, _pad_feats(
                                f["keypoints"], f["scores"],
                                f["descriptors"], b)):
                            data[f"{k}{i}"].append(v)
                batch = {k: torch.from_numpy(np.stack(v)).to(device)
                         for k, v in data.items()}
                batch["shape0"], batch["shape1"] = s0, s1
                res = superglue.forward(sg_model, batch, sg_conf)
                # one copy a batch; indices < 2^24 are exact in fp32
                packed = torch.stack([res.matches0.float(),
                                      res.matching_scores0], -1)
                if mesh is not None:
                    packed = comm.all_gather(
                        packed, pmesh.axis_group(mesh, "data")).flatten(0, 1)
                if not main:
                    continue
                packed = packed.cpu().numpy()
                for bi, (name0, name1) in enumerate(chunk):
                    n0 = feats[name0]["keypoints"].shape[0]
                    grp = out.create_group(names_to_pair(name0, name1))
                    grp.create_dataset(
                        "matches0", data=packed[bi, :n0, 0].astype(np.int32))
                    grp.create_dataset(
                        "matching_scores0", data=packed[bi, :n0, 1])
    comm.synchronize()   # the file is whole before any rank reads it
    return match_out
