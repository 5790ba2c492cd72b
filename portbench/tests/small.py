"""The cells at a size a CPU test can hold: the real files of each cell,
with widths, counts and images cut down (the limits stay the cell's)."""
from __future__ import annotations

from portbench import manifest

SMALL = {
    "pose-fp32-b128": {
        "config_data": {
            "superpoint": {"descriptor_dim": 32, "max_keypoints": 64},
            "gats_spg": {"descriptor_dim": 32, "num_blocks": 1},
            "db": {"shape3d": 64, "num_leaf": 2},
            "pnp": {"num_hypotheses": 32, "lo_hypotheses": 8},
            "crop": {"height": 64, "width": 64, "focal": 60.0}},
        "traffic_data": {"batch": 4, "pool": 4, "shift_steps": 2,
                         "warmup_batches": 1, "trace_batches": 1,
                         "check_batches": 2, "check_from": 2}},
    "detect-fp32-15views": {
        "config_data": {
            "superpoint": {"descriptor_dim": 32, "max_keypoints": 64},
            "superglue": {"descriptor_dim": 32, "keypoint_encoder": [8, 16, 32],
                          "num_gnn_layers": 2, "sinkhorn_iterations": 5},
            "n_ref_view": 3, "view": [64, 64], "frame": [96, 128]},
        "traffic_data": {"pool": 3, "warmup_frames": 1, "trace_frames": 1,
                         "check_frames": 2, "check_from": 2}},
}


def _merge(into: dict, over: dict) -> None:
    for k, v in over.items():
        if isinstance(v, dict) and isinstance(into.get(k), dict):
            _merge(into[k], v)
        else:
            into[k] = v


def small_work(name: str, sizes: dict = None) -> dict:
    """``manifest.cell(name)`` with ``sizes`` (default: :data:`SMALL`'s)
    merged into its configuration and traffic."""
    work = manifest.cell(manifest.load(), name)
    _merge(work, SMALL[name] if sizes is None else sizes)
    return work
