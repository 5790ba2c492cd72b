"""Per-frame ``BATracker`` latency of the PyTorch port on one card.

Counterpart of the repository's ``scripts/bench_tracker.py``: the warm
wall time of ``BATracker.track()`` (the track step, the host's reads of
its outputs, the window BA) on a synthetic textured-plane sequence at the
demo's shapes (512x512 frames, 512 keypoint slots of 400 real points,
256-d descriptors), ``BATracker(win_size=10, pnp_hypotheses=256,
ba_iterations=8)``.

    python -m onepose_tpu_torch.bench_tracker [--frames 24] [--warmup 6]
        [--breakdown] [--uint8] [--device cpu]

Prints {"track_ms_median", "track_ms_p90", "frames", "r_err_deg_max",
"t_err_cm_max", "device"}. ``--breakdown`` adds the timed frames' median
ms of each stage, by CUDA events at the tracker's marks (the track step's
``lk``, ``flow_pnp``, ``nn``, ``pnp``, ``tri``; then ``host``, the
outputs read and the map updated; then ``ba``, the window BA), and
``rtt_ms`` (one trivial launch and its synchronize), ``upload_ms`` (a
frame's image, keypoints, descriptors and mask to the card, less the
RTT) and ``upload_bytes``.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np

N_SLOTS = 512
STAGES = ("lk", "flow_pnp", "nn", "pnp", "tri", "host", "ba")


def make_sequence(rng, n_frames, n_points=400, hw=512, desc_dim=256):
    """The textured plane z = 0 under a slowly moving camera, the exact
    homography warp of its texture each frame (``utils/synthetic.py``'s
    ``plane_sequence``, numpy and torch) → (K, pts3d [n_points, 3],
    frames: image, pose, keypoints [n_points, 2] with 0.3 px noise,
    descriptors [n_points, desc_dim] with 0.02 noise)."""
    from onepose_tpu_torch.utils.synthetic import plane_sequence

    K, pts3d, frames = plane_sequence(rng, n_frames, hw=hw,
                                      n_points=n_points, slots=n_points,
                                      desc_dim=desc_dim)
    for fr in frames:
        del fr["mask"]
    return K, pts3d, frames


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--frames", type=int, default=24)
    ap.add_argument("--warmup", type=int, default=6,
                    help="tracked frames excluded from timing")
    ap.add_argument("--breakdown", action="store_true",
                    help="also split each timed frame by stage, and give "
                         "the round trip and a frame's upload")
    ap.add_argument("--uint8", action="store_true",
                    help="feed frames as uint8 (normalised on the card); "
                         "bit-identical to feeding u/255 as float32")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu for a CPU run)")
    return ap


def run(args, n_points: int = 400, hw: int = 512, n_slots: int = N_SLOTS,
        log=print) -> dict:
    """The entry's JSON line for parsed ``args`` (:func:`parser`); the
    keyword arguments set the sequence's size for small runs. Raises when
    the tracker loses the object."""
    import torch

    from onepose_tpu_torch import runtime
    from onepose_tpu_torch.eval_real import device_description
    from onepose_tpu_torch.tracker import BATracker
    from onepose_tpu_torch.utils import geometry as geo
    from onepose_tpu_torch.utils.profiling import StageClock

    if args.warmup >= args.frames:
        raise ValueError(f"--warmup ({args.warmup}) must be < --frames "
                         f"({args.frames}): no timed frames would remain")
    device = runtime.resolve_device(args.device, "bench_tracker")
    rng = np.random.default_rng(0)
    K, pts3d, frames = make_sequence(rng, args.frames + 1, n_points, hw)
    n = len(pts3d)
    if args.uint8:
        for fr in frames:
            fr["image"] = np.clip(np.round(fr["image"] * 255.0), 0,
                                  255).astype(np.uint8)

    def padded(fr):
        kp = np.zeros((n_slots, 2), np.float32)
        ds = np.zeros((n_slots, fr["descriptors"].shape[1]), np.float32)
        mask = np.zeros(n_slots, bool)
        kp[:n], ds[:n], mask[:n] = fr["keypoints"], fr["descriptors"], True
        return kp, ds, mask

    tracker = BATracker(win_size=10, pnp_hypotheses=256, ba_iterations=8,
                        device=device)
    clock = StageClock(device) if args.breakdown else None
    tracker.mark = clock.mark if clock else None
    kp, ds, mask = padded(frames[0])
    if not tracker.add_keyframe(frames[0]["image"], kp, ds, mask,
                                frames[0]["pose"], K, mkpts3d=pts3d,
                                kpt_indices=np.arange(n)):
        raise RuntimeError("bench_tracker: the first add_keyframe failed")

    times_ms, r_errs, t_errs, splits = [], [], [], []
    for i in range(1, args.frames + 1):
        kp, ds, mask = padded(frames[i])
        if clock:
            clock.mark("start")
        t0 = time.perf_counter()
        pose, info = tracker.track(frames[i]["image"], kp, ds, mask, K)
        dt = (time.perf_counter() - t0) * 1000.0
        split = clock.split() if clock else {}
        if pose is None:
            raise RuntimeError(
                f"bench_tracker: track() lost the object at frame {i} "
                f"({info}): latency numbers would be meaningless")
        r_err, t_err = geo.query_pose_error(pose, frames[i]["pose"])
        r_errs.append(r_err)
        t_errs.append(t_err)
        if i > args.warmup:
            times_ms.append(dt)
            splits.append(split)
        log(f"[bench_tracker] frame {i:02d}: {dt:7.1f} ms  "
            f"mode={info['mode']} tracked={info.get('num_tracked')} "
            f"r={r_err:.2f}deg t={t_err:.2f}cm")

    out = {
        "track_ms_median": round(float(np.median(times_ms)), 1),
        "track_ms_p90": round(float(np.percentile(times_ms, 90)), 1),
        "frames": len(times_ms),
        "r_err_deg_max": round(float(np.max(r_errs)), 2),
        "t_err_cm_max": round(float(np.max(t_errs)), 2),
        "device": device_description(device),
    }
    if args.breakdown:
        brk = {f"{s}_ms": round(float(np.median(
            [sp.get(s, 0.0) for sp in splits])), 2) for s in STAGES}
        brk["rtt_ms"] = round(_median_ms(lambda: torch.zeros(
            (), device=device).add_(1.0).item(), device), 3)
        kp_h, ds_h, mask_h = padded(frames[1])
        host = (frames[1]["image"], kp_h, ds_h, mask_h)
        brk["upload_ms"] = round(_median_ms(lambda: [
            torch.as_tensor(x).to(device) for x in host], device)
            - brk["rtt_ms"], 3)
        brk["upload_bytes"] = int(sum(x.nbytes for x in host))
        out["breakdown"] = brk
    return out


def _median_ms(fn, device, reps: int = 20) -> float:
    """Median wall ms of ``fn`` and a synchronize, after one warm-up."""
    import torch

    def sync():
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)

    fn()
    sync()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def main(argv=None):
    print(json.dumps(run(parser().parse_args(argv))))


if __name__ == "__main__":
    main()
