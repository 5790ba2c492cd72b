"""Steady-state multi-object serving of the PyTorch port on one card.

Counterpart of the repository's ``scripts/bench_serving.py``: the serve
step with the whole catalog resident (81 objects by default, the
reference's test split) at protocol shapes (shape3d 2000, leaf 8, 512x512
crops, max_keypoints 1024, fp32: both kernels), random weights from
``default_rng(0)`` and the same ``make_db``.

    python -m onepose_tpu_torch.bench_serving [--n-objects 81] [--uniform]
        [--latency [--latency-requests 240] [--max-latency-ms 20]]
        [--device cpu]

The saturation line times ``serving.serve_step`` on the resident catalog
with a mixed batch (``obj_idx`` cycling through the objects) or a uniform
one (``--uniform``): one throwaway block, then 6 blocks of 20 steps
timed by CUDA events (``utils/profiling.time_blocks``), the median
block's ms a step: {"serve_ms_per_batch8", "req_per_s", "catalog_mb",
"n_objects", "uniform", "device"}. ``--latency`` drives the async path
(``PoseServer.submit`` and its worker's batching) with Poisson arrivals
at fractions of the synchronous capacity and prints
``run_latency_sweep``'s line.
"""
from __future__ import annotations

import argparse
import json
import threading
import time
from typing import Optional

import numpy as np

LOAD_FRACTIONS = (0.25, 0.5, 0.75, 0.9, 1.2)


def make_db(rng, shape3d: int = 2000, num_leaf: int = 8):
    """One object: shape3d - 8 points of 2 to 9 observations each."""
    from onepose_tpu_torch.utils.synthetic import random_db

    return random_db(rng, shape3d - 8, shape3d, num_leaf)


def run_latency_sweep(server, n_objects: int, args, hw: int = 512,
                      log=print) -> dict:
    """Per-request latency against offered load through the async path.
    Capacity: the synchronous per-batch wall time (upload, step, fetch)
    over 6 batches after one warm-up; offered loads are Poisson arrivals
    at ``LOAD_FRACTIONS`` of it, one past the knee. ``args`` carries
    ``latency_requests`` (requests a point)."""
    from onepose_tpu_torch import serving as serving_mod
    from onepose_tpu_torch.bench import FOCAL
    from onepose_tpu_torch.utils.synthetic import pinhole

    rng = np.random.default_rng(7)
    img = rng.uniform(0, 1, (hw, hw)).astype(np.float32)
    K = pinhole(hw, FOCAL).astype(np.float32)

    def req(j):
        return serving_mod.PoseRequest(server.names[j % n_objects], img, K)

    warm = [req(j) for j in range(server.batch_size)]
    server.infer_batch(warm)
    t0 = time.perf_counter()
    reps = 6
    for _ in range(reps):
        server.infer_batch(warm)
    batch_wall_ms = (time.perf_counter() - t0) / reps * 1000.0
    capacity = server.batch_size / batch_wall_ms * 1000.0  # req/s

    server.start()
    points = []
    try:
        for frac in LOAD_FRACTIONS:
            rate = capacity * frac
            n_req = args.latency_requests
            lats, futs = [], []
            # a future's callbacks run after its result() waiters wake:
            # count them in before reading the latencies
            recorded = threading.Semaphore(0)
            arr = np.random.default_rng(int(frac * 100)).exponential(
                1.0 / rate, n_req).cumsum()
            start = time.perf_counter()
            for j in range(n_req):
                while time.perf_counter() - start < arr[j]:
                    time.sleep(0.0002)
                ts = time.perf_counter()
                fut = server.submit(req(j))
                fut.add_done_callback(
                    lambda f, ts=ts: (lats.append(
                        (time.perf_counter() - ts) * 1000.0),
                        recorded.release()))
                futs.append(fut)
            for f in futs:
                f.result(timeout=120)
            for _ in futs:
                if not recorded.acquire(timeout=120):
                    raise RuntimeError("bench_serving: a latency was not "
                                       "recorded")
            wall = time.perf_counter() - start
            p50, p95, p99 = np.percentile(lats, [50, 95, 99])
            points.append({
                "offered_frac": frac,
                "offered_req_per_s": round(rate, 1),
                "achieved_req_per_s": round(n_req / wall, 1),
                "p50_ms": round(float(p50), 1),
                "p95_ms": round(float(p95), 1),
                "p99_ms": round(float(p99), 1),
            })
            log(f"[bench_serving] load {frac:.2f}x: {points[-1]}")
    finally:
        server.stop()
    return {
        "metric": "serving_latency_sweep",
        "n_objects": n_objects,
        "batch_size": server.batch_size,
        "assembly_timeout_ms": round(server.max_latency_s * 1000.0, 1),
        "sync_batch_wall_ms": round(batch_wall_ms, 2),
        "capacity_req_per_s": round(capacity, 1),
        "points": points,
    }


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n-objects", type=int, default=81,
                    help="resident objects (81: the test split's catalog)")
    ap.add_argument("--uniform", action="store_true",
                    help="time the one-object path (every request of a "
                         "batch names one object) instead of the mixed step")
    ap.add_argument("--latency", action="store_true",
                    help="drive the async batching path at several offered "
                         "loads and report per-request p50/p95/p99 latency "
                         "instead of the saturation number")
    ap.add_argument("--latency-requests", type=int, default=240,
                    help="requests per offered-load point")
    ap.add_argument("--max-latency-ms", type=float, default=20.0,
                    help="server batch-assembly timeout (max_latency_s)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu for a CPU run)")
    return ap


def run(args, batch: int = 8, hw: int = 512, max_keypoints: int = 1024,
        shape3d: int = 2000, num_hypotheses: int = 512, gats_config: Optional[dict] = None,
        n_iters: int = 20, blocks: int = 6, log=print) -> dict:
    """The entry's JSON line for parsed ``args`` (:func:`parser`); the
    keyword arguments set the protocol's shape for small runs."""
    import torch

    from onepose_tpu_torch import serving
    from onepose_tpu_torch.bench import batch_K, entry_device, random_models
    from onepose_tpu_torch.eval_real import device_description
    from onepose_tpu_torch.utils.profiling import time_blocks

    device = entry_device(args.device, "bench_serving")
    rng = np.random.default_rng(0)
    sp_model, gats_model = random_models(0, gats_config)
    n_objects = args.n_objects
    t0 = time.time()
    dbs = {f"obj{i:02d}": make_db(rng, shape3d)
           for i in range(n_objects)}
    log(f"[bench_serving] built {n_objects} DBs in {time.time() - t0:.0f}s")
    catalog_mb = sum(db.descriptors3d.nbytes + db.descriptors2d_db.nbytes
                     + db.keypoints3d.nbytes for db in dbs.values()) / 1e6
    server = serving.PoseServer(
        sp_model, gats_model, dbs, sp_config={"max_keypoints": max_keypoints},
        gats_config=gats_config, batch_size=batch,
        num_hypotheses=num_hypotheses,
        seed=1, max_latency_s=args.max_latency_ms / 1000.0, device=device)
    if args.latency:
        out = run_latency_sweep(server, n_objects, args, hw, log)
        out["device"] = device_description(device)
        return out

    B = batch
    images = torch.from_numpy(rng.uniform(0, 1, (B, hw, hw, 1)).astype(
        np.float32)).to(device)
    Ks = batch_K(B, hw, device)
    idx = (np.full(B, n_objects // 2) if args.uniform
           else (np.arange(B * 7) % n_objects)[:B])
    obj_idx = torch.from_numpy(idx.astype(np.int64)).to(device)
    gen = torch.Generator(device=device).manual_seed(1)

    def step():
        with torch.no_grad():
            serving.serve_step(
                server.sp_model, server.gats_model, server.db_stack, obj_idx,
                images, Ks, server.sp_config, server.gats_config,
                uniform=args.uniform, generator=gen, reproj_threshold=5.0,
                num_hypotheses=num_hypotheses, refine_iters=5)

    ms = float(np.median(time_blocks(step, n_iters, blocks, device)))
    return {
        "serve_ms_per_batch8": round(ms, 2),
        "req_per_s": round(B / ms * 1000, 1),
        "catalog_mb": round(catalog_mb, 0),
        "n_objects": n_objects,
        "uniform": bool(args.uniform),
        "device": device_description(device),
    }


def main(argv=None):
    print(json.dumps(run(parser().parse_args(argv))))


if __name__ == "__main__":
    main()
