"""End-to-end training throughput of the PyTorch port at protocol shapes on
one card.

Counterpart of the repository's ``scripts/bench_train.py``: the same
synthetic dataset on disk (1 object, 2000 3D points, about 45k stacked
observations, 96 images with their sidecar caches written), then epoch
items/s of the port's input paths (``datasets/gats_dataset.py``'s light
batches with leaf indices sampled on the host, with leaf uniforms for the
card's sampling, and the latter staged ahead by ``runtime/loader.py``'s
``stage_ahead`` and ``DeviceStager``), each the best of 2 epochs after one
warm-up, and the step-only ceiling of ``trainer``'s gather step: 30 steps
on one batch. GATsSPG at its default width (4 blocks), random from seed 0,
Adam 1e-3.

    python -m onepose_tpu_torch.bench_train [--root DIR] [--device cpu]

The dataset is built once under ``--root`` (default
``build/onepose_train_bench`` of the working directory, in the place of
the JAX script's ``/tmp/onepose_train_bench``). Prints the JAX script's
lines, then one JSON line of the four items/s and the device.
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import Optional

import numpy as np

D, P, NIMG, N2D = 256, 2000, 96, 600
B, S2, S3, L = 8, 1000, 2000, 8
MODES = (("light+host-leaf-sampling", False, False),
         ("light+device-leaf-sampling", True, False),
         ("+ staged uploads", True, True))
CEILING = "step-only ceiling"
CEILING_STEPS = 30


def build_dataset(root: str, n_points: int = P, n_images: int = NIMG,
                  n2d: int = N2D, dim: int = D):
    """The JAX script's dataset under ``root``: one object's anno files,
    ``n_images`` 2D annos with their binary sidecars, ``train.json``, and
    a ``done`` marker."""
    os.makedirs(f"{root}/anno", exist_ok=True)
    rng = np.random.default_rng(0)
    idxs = rng.integers(8, 40, n_points).astype(np.int64)
    total = int(idxs.sum())
    np.save(f"{root}/idxs.npy", idxs)
    np.savez(f"{root}/anno_3d_collect.npz",
             keypoints3d=rng.uniform(-.1, .1, (n_points, 3)).astype(
                 np.float32),
             descriptors3d=rng.standard_normal((dim, total)).astype(
                 np.float32),
             scores3d=rng.uniform(0, 1, (total, 1)).astype(np.float32))
    np.savez(f"{root}/anno_3d_average.npz",
             descriptors3d=rng.standard_normal((dim, n_points)).astype(
                 np.float32),
             scores3d=rng.uniform(0, 1, (n_points, 1)).astype(np.float32))
    images, annos = [], []
    for i in range(n_images):
        ap = f"{root}/anno/{i}.json"
        with open(ap, "w") as f:
            json.dump({"synthetic": True}, f)
        # the sidecar the dataset's JSON parse would write: steady-state
        # epochs read only the cache
        np.savez(f"{ap}.cache.npz",
                 keypoints2d=rng.uniform(0, 511, (n2d, 2)).astype(np.float32),
                 descriptors2d=rng.standard_normal(
                     (n2d, dim)).astype(np.float32),
                 scores2d=rng.uniform(0, 1, n2d).astype(np.float32),
                 assign_matrix=np.stack([
                     rng.choice(n2d, n2d // 2, replace=False),
                     rng.choice(n_points, n2d // 2, replace=False)]).astype(
                         np.int64))
        images.append({"id": i, "img_file": f"{root}/color/{i}.png"})
        annos.append({"image_id": i, "anno2d_file": ap,
                      "avg_anno3d_file": f"{root}/anno_3d_average.npz",
                      "collect_anno3d_file": f"{root}/anno_3d_collect.npz",
                      "idxs_file": f"{root}/idxs.npy"})
    with open(f"{root}/train.json", "w") as f:
        json.dump({"images": images, "annotations": annos}, f)
    with open(f"{root}/done", "w") as f:
        f.write("1")


def run(root: str, batch: int = B, shape2d: int = S2, shape3d: int = S3,
        gats_config: Optional[dict] = None,
        epochs: int = 2, ceiling_steps: int = CEILING_STEPS, device="cuda",
        log=print, **dataset) -> dict:
    """Items/s of each input path and of the step ceiling (module
    docstring), the dataset built under ``root`` first if it is not
    there (``dataset``: :func:`build_dataset`'s sizes)."""
    import torch

    from onepose_tpu_torch.bench import entry_device
    from onepose_tpu_torch.datasets.gats_dataset import GATsSPGDataset
    from onepose_tpu_torch.eval_real import device_description
    from onepose_tpu_torch.runtime.loader import DeviceStager, stage_ahead
    from onepose_tpu_torch.train import trainer

    device = entry_device(device, "bench_train")
    if not os.path.exists(f"{root}/done"):
        build_dataset(root, **dataset)
        log("dataset built")
    ds = GATsSPGDataset(f"{root}/train.json", num_leaf=L,
                        split="train", shape2d=shape2d, shape3d=shape3d)
    tx = trainer.make_optimizer(base_lr=1e-3, milestones_steps=[1000])
    state = trainer.init_train_state(tx, gats_config, device=device)
    db_np, obj_index = ds.device_db()
    db = {k: torch.as_tensor(db_np[k], device=device) for k in
          ("clt_stack", "avg_stack", "count_stack", "offset_stack")}
    step = trainer.make_gather_train_step(gats_config, db, shape2d, shape3d,
                                          0, num_leaf=L)
    stager = DeviceStager(device)

    def host_batch(lb):
        """A light batch's leaf seeds as uniforms (the port's on-card
        sampling draws from them)."""
        if "leaf_seed" in lb:
            lb = dict(lb)
            lb["leaf_uniform"] = trainer.leaf_uniforms(
                lb.pop("leaf_seed"), L, shape3d)
        return lb

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def run_epoch(on_device_leaves, staged):
        nonlocal state
        n, loss = 0, None
        t0 = time.perf_counter()
        it = map(host_batch, ds.light_batches(
            obj_index, db_np["t_max"], batch, shuffle=True, seed=1,
            on_device_leaves=on_device_leaves))
        if staged:
            for item in stage_ahead(it, stager):
                state, loss = step(state, item.wait())
                n += batch
        else:
            for lb in it:
                state, loss = step(state, {
                    k: torch.as_tensor(v, device=device)
                    for k, v in lb.items()})
                n += batch
        float(loss)
        return n / (time.perf_counter() - t0)

    out = {}
    for name, dev_leaves, staged in MODES:
        run_epoch(dev_leaves, staged)   # warm
        out[name] = max(run_epoch(dev_leaves, staged) for _ in range(epochs))
        log(f"{name:26s}: {out[name]:6.1f} items/s")

    lb = next(ds.light_batches(obj_index, db_np["t_max"], batch, seed=1,
                               on_device_leaves=True))
    lbt = {k: torch.as_tensor(v, device=device)
           for k, v in host_batch(lb).items()}
    state, loss = step(state, lbt)
    float(loss)
    t0 = time.perf_counter()
    for _ in range(ceiling_steps):
        state, loss = step(state, lbt)
    float(loss)
    sync()
    out[CEILING] = ceiling_steps * batch / (time.perf_counter() - t0)
    log(f"{CEILING:26s}: {out[CEILING]:6.1f} items/s")
    out["device"] = device_description(device)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=os.path.join("build",
                                                   "onepose_train_bench"))
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu for a CPU run)")
    args = ap.parse_args(argv)
    print(json.dumps(run(args.root, device=args.device)))


if __name__ == "__main__":
    main()
