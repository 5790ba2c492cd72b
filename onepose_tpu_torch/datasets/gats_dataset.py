"""Training and validation dataset for the GATsSPG matcher.

The port's copy of ``onepose_tpu/datasets/gats_dataset.py`` (the
reference's ``GATs_spg_dataset.py`` and ``data_utils`` padding), numpy
only: per item, the 2D annotation (keypoints / descriptors / scores / GT
assign matrix) padded to ``shape2d`` with random keypoints and dustbin
descriptors, the 3D annotation padded to ``shape3d``, ``num_leaf`` leaf
descriptors resampled per access (train-time augmentation), and the GT
confidence matrix with pads as negatives. The merged ``train.json`` index
is a plain dict (images + annotations); batches are numpy, drawn from the
same seeded RNG streams as the JAX package's, so both packages batch the
same samples.
"""
from __future__ import annotations

import json
import os
import os.path as osp
from typing import Dict, Iterator, Optional

import numpy as np

from onepose_tpu_torch.datasets import anno as anno_mod


def load_anno_index(anno_file: str):
    """Load the merged annotation index {'images': [...],
    'annotations': [...]} (run.py merge_anno format, reference run.py:40-77),
    joined on image_id."""
    with open(anno_file, "r") as f:
        data = json.load(f)
    img_by_id = {im["id"]: im for im in data["images"]}
    items = []
    for ann in data["annotations"]:
        im = img_by_id[ann["image_id"]]
        items.append({**ann, "img_file": im["img_file"]})
    return items


def pad_keypoints2d_random(kpts, descs, scores, img_h, img_w, target,
                           rng: np.random.Generator):
    """Pad with random integer pixel positions (dustbin descriptor = ones,
    score = 0), or truncate (reference data_utils.py:60-82)."""
    n = kpts.shape[0]
    dim = descs.shape[1]
    if n >= target:
        return kpts[:target], descs[:target], scores[:target]
    n_pad = target - n
    rand_xy = np.stack([
        rng.integers(0, img_w, n_pad),
        rng.integers(0, img_h, n_pad),
    ], axis=1).astype(kpts.dtype)
    kpts = np.concatenate([kpts, rand_xy])
    descs = np.concatenate([descs, np.ones((n_pad, dim), descs.dtype)])
    scores = np.concatenate([scores, np.zeros(n_pad, scores.dtype)])
    return kpts, descs, scores


def pad_keypoints3d_random(kpts, target, rng: np.random.Generator):
    """Pad with zero-mean uniform random points (data_utils.py:120-140)."""
    n = kpts.shape[0]
    if n >= target:
        return kpts[:target]
    n_pad = target - n
    rand = (rng.random((n_pad, 3)) - 0.5).astype(kpts.dtype)
    return np.concatenate([kpts, rand])


def reshape_assign_matrix(assign, num2d, num3d, shape2d, shape3d,
                          pad_val=0):
    """[2, k] index pairs → dense [shape2d, shape3d] GT confidence matrix;
    rows/cols beyond the real counts set to ``pad_val``
    (data_utils.py:208-230)."""
    conf = np.zeros((shape2d, shape3d), np.int32)
    if assign.size:
        valid = (assign[0] < shape2d) & (assign[1] < shape3d)
        a = assign[:, valid].astype(np.int64)
        conf[a[0], a[1]] = 1
    conf[min(num2d, shape2d):] = pad_val
    conf[:, min(num3d, shape3d):] = pad_val
    return conf


class GATsSPGDataset:
    def __init__(self, anno_file: str, num_leaf: int = 8,
                 split: str = "train", shape2d: int = 1000,
                 shape3d: int = 2000, pad_val: int = 0,
                 load_pose_gt: bool = False, seed: int = 12345):
        self.items = load_anno_index(anno_file)
        self.num_leaf = num_leaf
        self.split = split
        self.shape2d = shape2d
        self.shape3d = shape3d
        self.pad_val = pad_val
        self.load_pose_gt = load_pose_gt
        self.rng = np.random.default_rng(seed)
        self._anno3d_cache: Dict[str, dict] = {}

    def __len__(self):
        return len(self.items)

    # ------------------------------------------------------------------
    @staticmethod
    def _atomic_save(path: str, arr: np.ndarray):
        """Write a .npy sidecar atomically (safe under concurrent item
        threads/processes racing on first access)."""
        import threading

        tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}.npy"
        try:
            np.save(tmp, arr)
            os.replace(tmp, path)
        except OSError:
            if osp.exists(tmp):
                os.remove(tmp)

    def _anno3d_arrays(self, ann):
        """Per-object 3D anno arrays, cheap on re-access.

        The npz artifacts are re-read per item per epoch in the naive
        path (~30 MB of zip-decompress each time). First access converts
        the big members to .npy sidecars; later accesses np.load them
        with mmap, so the OS page cache—not Python—holds the hot bytes
        across items and epochs."""
        key = ann["collect_anno3d_file"]
        cached = self._anno3d_cache.get(key)
        if cached is not None:
            return cached

        sidecar_ok = True
        members = {}
        specs = [
            ("clt_desc", ann["collect_anno3d_file"], "descriptors3d"),
            ("clt_scores", ann["collect_anno3d_file"], "scores3d"),
            ("avg_descT", ann["avg_anno3d_file"], "descriptors3d"),
        ]
        for name, src, _ in specs:
            side = f"{src}.{name}.npy"
            if not (osp.exists(side)
                    and os.path.getmtime(side) >= os.path.getmtime(src)):
                sidecar_ok = False
        if not sidecar_ok:
            avg = np.load(ann["avg_anno3d_file"])
            clt = np.load(ann["collect_anno3d_file"])
            raw = {
                "clt_desc": np.asarray(clt["descriptors3d"], np.float32),
                "clt_scores": np.asarray(clt["scores3d"], np.float32),
                "avg_descT": np.asarray(
                    avg["descriptors3d"], np.float32).T.copy(),
            }
            kpts3d = np.asarray(clt["keypoints3d"], np.float32)
            for name, src, _ in specs:
                self._atomic_save(f"{src}.{name}.npy", raw[name])
            # re-open via mmap so the cache holds page-backed views, not
            # ~30 MB of Python-owned arrays per object
            for name, src, _ in specs:
                side = f"{src}.{name}.npy"
                try:
                    members[name] = np.load(side, mmap_mode="r")
                except OSError:
                    members[name] = raw[name]
        else:
            for name, src, _ in specs:
                members[name] = np.load(f"{src}.{name}.npy", mmap_mode="r")
            kpts3d = np.asarray(
                np.load(ann["collect_anno3d_file"])["keypoints3d"],
                np.float32)
        cached = {
            "kpts3d": kpts3d,
            "idxs": np.asarray(np.load(ann["idxs_file"]), np.int64),
            **members,
        }
        self._anno3d_cache[key] = cached
        return cached

    def _anno2d_arrays(self, ann):
        """2D anno arrays with a .npz sidecar cache.

        The per-image anno JSON carries a [D, n2d] descriptor matrix as
        text (~5 MB) whose json.load costs ~100 ms — the dominant item
        cost. First access parses once and writes ``<anno>.cache.npz``;
        later epochs load it in ~1 ms. Falls back to plain JSON when the
        sidecar can't be written (read-only dataset dirs)."""
        path = ann["anno2d_file"]
        cache = f"{path}.cache.npz"
        if (osp.exists(cache)
                and os.path.getmtime(cache) >= os.path.getmtime(path)):
            z = np.load(cache)
            return (z["keypoints2d"], z["descriptors2d"], z["scores2d"],
                    z["assign_matrix"])
        with open(path, "r") as f:
            a2d = json.load(f)
        kpts2d = np.asarray(a2d["keypoints2d"], np.float32)
        desc2d = np.asarray(a2d["descriptors2d"], np.float32).T.copy()
        scores2d = np.asarray(a2d["scores2d"], np.float32).reshape(-1)
        assign = np.asarray(a2d["assign_matrix"], np.int64)
        import threading

        tmp = f"{cache}.tmp.{os.getpid()}.{threading.get_ident()}.npz"
        try:
            with open(tmp, "wb") as f:
                np.savez(f, keypoints2d=kpts2d, descriptors2d=desc2d,
                         scores2d=scores2d, assign_matrix=assign)
            os.replace(tmp, cache)
        except OSError:
            if osp.exists(tmp):
                os.remove(tmp)
        return kpts2d, desc2d, scores2d, assign

    def _read_anno3d(self, ann, rng):
        """3D side: padded keypoints/avg descriptors + resampled leaves."""
        a3 = self._anno3d_arrays(ann)
        kpts3d = a3["kpts3d"]
        num3d = kpts3d.shape[0]
        avg_desc = a3["avg_descT"]  # [m, D]
        dim = avg_desc.shape[1]

        leaf_desc, leaf_scores = anno_mod.build_leaves(
            a3["clt_desc"], a3["clt_scores"], a3["idxs"], self.num_leaf,
            rng)

        # pad to shape3d
        kpts3d = pad_keypoints3d_random(kpts3d, self.shape3d, rng)
        if num3d >= self.shape3d:
            avg_desc = avg_desc[: self.shape3d]
            leaf_desc = leaf_desc[: self.shape3d * self.num_leaf]
        else:
            n_pad = self.shape3d - num3d
            avg_desc = np.concatenate(
                [avg_desc, np.ones((n_pad, dim), np.float32)])
            leaf_desc = np.concatenate(
                [leaf_desc,
                 np.ones((n_pad * self.num_leaf, dim), np.float32)])
        return kpts3d, avg_desc, leaf_desc, num3d

    def get(self, index: int, rng: Optional[np.random.Generator] = None):
        rng = rng or self.rng
        ann = self.items[index]
        kpts3d, avg_desc, leaf_desc, num3d = self._read_anno3d(ann, rng)

        item = {
            "keypoints3d": kpts3d,
            "descriptors3d_db": avg_desc,
            "descriptors2d_db": leaf_desc,
        }

        if self.split == "train":
            kpts2d, desc2d, scores2d, assign = self._anno2d_arrays(ann)
            num2d = kpts2d.shape[0]

            # image size for random pad positions; 512 crops by contract
            kpts2d, desc2d, scores2d = pad_keypoints2d_random(
                kpts2d, desc2d, scores2d, 512, 512, self.shape2d, rng)
            conf_gt = reshape_assign_matrix(
                assign, num2d, num3d, self.shape2d, self.shape3d,
                self.pad_val)
            item.update({
                "keypoints2d": kpts2d,
                "descriptors2d_query": desc2d,
                "scores2d_query": scores2d,
                "conf_gt": conf_gt,
            })
        else:
            from onepose_tpu_torch.sfm.extract import load_gray

            item["image"] = load_gray(ann["img_file"])

        if self.load_pose_gt:
            from onepose_tpu_torch.utils import path_utils

            color = ann["img_file"]
            item["query_intrinsic"] = np.loadtxt(
                path_utils.get_intrin_path_by_color(color)).astype(
                    np.float32)
            item["query_pose_gt"] = np.loadtxt(
                ann["pose_file"]).astype(np.float32)
        return item

    def get_query(self, index: int):
        """Query-side only (image + GT intrinsics/pose) — for batched
        validation where the object DB is built once per object instead of
        re-read per item."""
        from onepose_tpu_torch.sfm.extract import load_gray
        from onepose_tpu_torch.utils import path_utils

        ann = self.items[index]
        item = {"image": load_gray(ann["img_file"])}
        color = ann["img_file"]
        item["query_intrinsic"] = np.loadtxt(
            path_utils.get_intrin_path_by_color(color)).astype(np.float32)
        item["query_pose_gt"] = np.loadtxt(
            ann["pose_file"]).astype(np.float32)
        return item

    # ------------------------------------------------------------------
    # Device-resident training input path: every object's observation
    # descriptors live on the device once; per item the host ships only
    # leaf *indices* (or a leaf seed), the query-side descriptors, and the
    # sparse GT pairs. The leaf gather and the dense conf_gt scatter happen
    # inside the train step (trainer.make_gather_train_step) — the gathered
    # leaf descriptors and the dense conf matrix never exist on the host.
    # ------------------------------------------------------------------
    def device_db(self):
        """Stack all objects' anno arrays for device residence.

        Returns (db dict of numpy arrays, obj_index mapping file→row):
          clt_stack [O, Tmax+1, D]  observation descriptors; row Tmax is
                                    the shared dustbin (ones)
          avg_stack [O, shape3d, D] averaged descriptors (ones padding)
          idxs_list                 per-object observation counts
        """
        files = []
        for ann in self.items:
            if ann["collect_anno3d_file"] not in files:
                files.append(ann["collect_anno3d_file"])
        obj_index = {f: i for i, f in enumerate(files)}

        per_obj = []
        for f in files:
            ann = next(a for a in self.items
                       if a["collect_anno3d_file"] == f)
            per_obj.append(self._anno3d_arrays(ann))
        dim = per_obj[0]["avg_descT"].shape[1]
        t_max = max(int(o["idxs"].sum()) for o in per_obj)

        O = len(files)
        clt_stack = np.ones((O, t_max + 1, dim), np.float32)
        avg_stack = np.ones((O, self.shape3d, dim), np.float32)
        num3d = np.zeros(O, np.int32)
        # per-point observation counts + segment starts, for on-device
        # leaf sampling (trainer.sample_leaves_on_device)
        count_stack = np.zeros((O, self.shape3d), np.int32)
        offset_stack = np.zeros((O, self.shape3d), np.int32)
        for i, o in enumerate(per_obj):
            t = int(o["idxs"].sum())
            clt_stack[i, :t] = np.asarray(o["clt_desc"]).T
            m = min(o["avg_descT"].shape[0], self.shape3d)
            avg_stack[i, :m] = o["avg_descT"][:m]
            num3d[i] = min(o["kpts3d"].shape[0], self.shape3d)
            idxs = np.asarray(o["idxs"], np.int64)
            lower = np.cumsum(idxs) - idxs
            mp = min(len(idxs), self.shape3d)
            count_stack[i, :mp] = idxs[:mp]
            offset_stack[i, :mp] = lower[:mp]
        db = {"clt_stack": clt_stack, "avg_stack": avg_stack,
              "num3d": num3d, "t_max": t_max,
              "count_stack": count_stack, "offset_stack": offset_stack}
        return db, obj_index

    def get_light(self, index: int, obj_index, t_max: int,
                  rng: np.random.Generator, max_pairs: int = 2048,
                  on_device_leaves: bool = False):
        """Host-light train item: indices + query side only.

        With ``on_device_leaves=False`` it consumes the SAME rng stream as
        :meth:`get` (leaf sampling, 3D pad draw, 2D pad) so the gather
        path is sample-for-sample identical to the host path. With
        ``on_device_leaves=True`` the item ships a 4-byte ``leaf_seed``
        instead of ``leaf_idx`` and the per-point sampling lexsort (the
        dominant host cost, ~10 ms/item) runs inside the train step
        (trainer.sample_leaves_on_device)."""
        ann = self.items[index]
        a3 = self._anno3d_arrays(ann)
        num3d = min(a3["kpts3d"].shape[0], self.shape3d)
        total = int(a3["idxs"].sum())

        if on_device_leaves:
            leaf_seed = np.uint32(rng.integers(1 << 31))
            leaf_idx = None
        else:
            pick = anno_mod.sample_leaf_indices(
                a3["idxs"], self.num_leaf, rng)
            # sentinel `total` and padded points → shared dustbin row t_max
            pick = np.where(pick >= total, t_max, pick)
            leaf_idx = np.full(
                (self.shape3d, self.num_leaf), t_max, np.int32)
            m = min(pick.shape[0], self.shape3d)
            leaf_idx[:m] = pick[:m]

        # keep the rng stream aligned with get(): 3D pad positions are
        # drawn there even though the loss never reads them
        n_pad3 = max(self.shape3d - a3["kpts3d"].shape[0], 0)
        if n_pad3:
            rng.random((n_pad3, 3))

        kpts2d, desc2d, scores2d, assign = self._anno2d_arrays(ann)
        num2d = kpts2d.shape[0]
        kpts2d, desc2d, scores2d = pad_keypoints2d_random(
            kpts2d, desc2d, scores2d, 512, 512, self.shape2d, rng)

        # Pad value must be genuinely out of bounds for the trainer's
        # mode="drop" scatter: -1 would wrap to the (shape2d-1, shape3d-1)
        # corner of conf_gt whenever the item saturates both budgets.
        pairs = np.full((max_pairs, 2),
                        (self.shape2d, self.shape3d), np.int32)
        if assign.size:
            valid = (assign[0] < self.shape2d) & (assign[1] < self.shape3d)
            a = assign[:, valid].astype(np.int32).T[:max_pairs]
            pairs[: len(a)] = a
        item = {
            "obj_idx": np.int32(obj_index[ann["collect_anno3d_file"]]),
            "descriptors2d_query": desc2d,
            "pairs": pairs,
            "num2d": np.int32(min(num2d, self.shape2d)),
            "num3d": np.int32(num3d),
        }
        if on_device_leaves:
            item["leaf_seed"] = leaf_seed
        else:
            item["leaf_idx"] = leaf_idx.reshape(-1)
        return item

    def light_batches(self, obj_index, t_max: int, batch_size: int,
                      shuffle: bool = True, drop_last: bool = True,
                      seed: Optional[int] = None,
                      prefetch: int = 2,
                      on_device_leaves: bool = False) -> Iterator[Dict]:
        """Collated light batches (see :meth:`get_light`), produced one
        batch ahead on a background thread."""
        order = np.arange(len(self))
        rng = np.random.default_rng(seed if seed is not None else 0)
        if shuffle:
            rng.shuffle(order)
        chunks = []
        for start in range(0, len(order), batch_size):
            idx = order[start:start + batch_size]
            if drop_last and len(idx) < batch_size:
                break
            chunks.append(idx)

        import queue as queue_mod
        import threading

        out: "queue_mod.Queue" = queue_mod.Queue(maxsize=max(prefetch, 1))

        def producer():
            try:
                for idx in chunks:
                    items = [self.get_light(
                        int(i), obj_index, t_max, rng,
                        on_device_leaves=on_device_leaves) for i in idx]
                    out.put({k: np.stack([it[k] for it in items])
                             for k in items[0]})
                out.put(None)
            except BaseException as e:
                out.put(e)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        while True:
            item = out.get()
            if item is None:
                break
            if isinstance(item, BaseException):
                raise item
            yield item
        t.join()

    # ------------------------------------------------------------------
    def batches(self, batch_size: int, shuffle: bool = True,
                drop_last: bool = True,
                seed: Optional[int] = None,
                num_threads: int = 8,
                prefetch: int = 2) -> Iterator[Dict]:
        """Yield collated numpy batches.

        Item builds (npz/json IO, leaf resampling, padding) run on a
        thread pool and whole batches are produced ``prefetch`` ahead on a
        background thread, overlapping input preparation with the device
        step — the reference's num_workers=16 DataLoader role
        (train_GATsSPG.yaml:76). Deterministic for a given seed: per-item
        RNGs are spawned from the epoch RNG in order, independent of
        thread scheduling. ``num_threads<=1`` gives the serial path.
        """
        order = np.arange(len(self))
        rng = np.random.default_rng(seed if seed is not None else 0)
        if shuffle:
            rng.shuffle(order)
        chunks = []
        for start in range(0, len(order), batch_size):
            idx = order[start:start + batch_size]
            if drop_last and len(idx) < batch_size:
                break
            chunks.append(idx)

        def collate(items):
            return {k: np.stack([it[k] for it in items]) for k in items[0]}

        if num_threads <= 1:
            for idx in chunks:
                yield collate([self.get(int(i), rng) for i in idx])
            return

        import concurrent.futures as cf
        import queue as queue_mod
        import threading

        out: "queue_mod.Queue" = queue_mod.Queue(maxsize=max(prefetch, 1))

        def producer():
            try:
                with cf.ThreadPoolExecutor(num_threads) as pool:
                    for idx in chunks:
                        rngs = rng.spawn(len(idx))
                        items = list(pool.map(
                            lambda a: self.get(int(a[0]), a[1]),
                            zip(idx, rngs)))
                        out.put(collate(items))
                out.put(None)
            except BaseException as e:  # surface worker errors to consumer
                out.put(e)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        while True:
            item = out.get()
            if item is None:
                break
            if isinstance(item, BaseException):
                raise item
            yield item
        t.join()
