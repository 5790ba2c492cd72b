"""Per-stage device time of the PyTorch port on one card.

Counterpart of the repository's ``scripts/profile_stages.py``, with its
rows in its order, each timed in isolation at batch 8, 512x512, K=1024,
shape3d 2000, leaf 8: the SuperPoint stem (conv1a + conv1b + pool: the
port's ``ops/stem.py::fused_stem``, the stem kernel), ``dense_heads`` in
fp32 (the stem kernel) and in bf16, the whole extraction, the GATsSPG
matcher (``gats_spg.forward``, the conf matrix in memory, as the JAX
script's) in fp32 and in bf16, PnP at 512 and at 256 hypotheses, and the
fp32 pipeline (both kernels) with its frames/s. Weights random from
``default_rng(0)``, inputs from the same generator in the JAX script's
order.

    python -m onepose_tpu_torch.profile_stages [--device cpu]

Each row: one throwaway block, then 3 blocks of 30 calls timed by CUDA
events (``utils/profiling.time_blocks``), the best block's ms a call, as
the JAX script's ``chain_time`` reports. Prints the JAX script's lines,
then one JSON line: {"rows": {row: ms}, "frames_per_s", "device"}.
Isolated times differ from a stage's in the pipeline: ``bench.py``'s
stages are the in-context ones.
"""
from __future__ import annotations

import argparse
import json
from typing import Optional

import numpy as np

N_ITERS, BLOCKS = 30, 3


def run(batch: int = 8, hw: int = 512, max_keypoints: int = 1024,
        shape3d: int = 2000, gats_config: Optional[dict] = None, n_iters: int = N_ITERS,
        blocks: int = BLOCKS, device="cuda", log=print) -> dict:
    """Every row's ms (module docstring); ``gats_config`` sets GATsSPG's
    depth for small runs; each row is passed to ``log`` as it is timed."""
    import torch

    from onepose_tpu_torch import pipeline, runtime
    from onepose_tpu_torch.bench import NUM_LEAF, batch_K, random_models
    from onepose_tpu_torch.eval_real import device_description
    from onepose_tpu_torch.models import gats_spg, superpoint
    from onepose_tpu_torch.ops.stem import fused_stem
    from onepose_tpu_torch.utils.profiling import time_blocks
    from onepose_tpu_torch.utils.synthetic import random_db

    device = runtime.resolve_device(device, "profile_stages")
    rng = np.random.default_rng(0)
    sp, gp = random_models(0, gats_config)
    sp, gp = sp.to(device).eval(), gp.to(device).eval()
    B, n2 = batch, shape3d

    def put(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    img = put(rng.uniform(0, 1, (B, hw, hw, 1)).astype(np.float32))
    rows = {}

    def report(name, fn):
        with torch.no_grad():
            ms = min(time_blocks(fn, n_iters, blocks, device))
        rows[name] = ms
        log(f"{name:40s} {ms:8.2f} ms/batch-{B}")

    # --- SuperPoint pieces ---
    stem_w = [superpoint._hwio(sp.conv1a.weight), sp.conv1a.bias,
              superpoint._hwio(sp.conv1b.weight), sp.conv1b.bias]
    report("sp stem (conv1a+1b+pool)",
           lambda: fused_stem(img, stem_w[0], stem_w[1], stem_w[2],
                              stem_w[3]))
    report("sp dense_heads fp32", lambda: superpoint.dense_heads(sp, img))
    report("sp dense_heads bf16",
           lambda: superpoint.dense_heads(sp, img, "bfloat16"))
    cfg = dict(superpoint.DEFAULT_CONFIG, max_keypoints=max_keypoints)
    report("sp extract (dense+nms+select)",
           lambda: superpoint.extract(sp, img, cfg))

    # --- GATs matcher ---
    data = {
        "descriptors2d_query": put(rng.normal(
            size=(B, max_keypoints, 256)).astype(np.float32)),
        "descriptors3d_db": put(rng.normal(size=(B, n2, 256)).astype(
            np.float32)),
        "descriptors2d_db": put(rng.normal(
            size=(B, n2 * NUM_LEAF, 256)).astype(np.float32)),
        "mask2d": put(np.ones((B, max_keypoints), bool)),
        "mask3d": put(np.ones((B, n2), bool)),
    }
    gcfg = dict(gats_config or {})
    report("gats matcher fp32", lambda: gats_spg.forward(gp, data, gcfg))
    gcfg_bf = dict(gcfg, compute_dtype="bfloat16")
    report("gats matcher bf16", lambda: gats_spg.forward(gp, data, gcfg_bf))

    # --- PnP ---
    k2 = put(rng.uniform(0, hw, (B, max_keypoints, 2)).astype(np.float32))
    k3 = put(rng.uniform(-0.1, 0.1, (B, n2, 3)).astype(np.float32))
    m0 = put(rng.integers(-1, n2, (B, max_keypoints)).astype(np.int64))
    msk = put(np.ones((B, max_keypoints), bool))
    Ks = batch_K(B, hw, device)
    gen = torch.Generator(device=device).manual_seed(1)
    for nh in (512, 256):
        report(f"pnp {nh} hypotheses", lambda nh=nh: (
            pipeline.poses_from_matches(
                k2, msk, m0, k3, Ks, generator=gen, reproj_threshold=5.0,
                num_hypotheses=nh, refine_iters=5)))

    # --- full pipeline, fp32 ---
    # bench.py's DB: a few padded slots, num_leaf to 3·num_leaf
    # observations a point
    db = random_db(rng, shape3d - 8, shape3d, NUM_LEAF,
                   obs=(NUM_LEAF, 3 * NUM_LEAF))
    pipe = pipeline.PosePipeline(
        sp, gp, db, sp_config={"max_keypoints": max_keypoints},
        gats_config=gats_config, num_hypotheses=512, device=device)
    report("FULL pipeline", lambda: pipe(img, Ks, generator=gen))
    fps = B / rows["FULL pipeline"] * 1000
    log(f"device throughput: {fps:.1f} frames/s")
    return {"rows": rows, "frames_per_s": fps,
            "device": device_description(device)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu for a CPU run)")
    args = ap.parse_args(argv)
    print(json.dumps(run(device=args.device)))


if __name__ == "__main__":
    main()
