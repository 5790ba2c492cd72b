"""%: the whole step's model operations (``portbench/flops.py``: SuperPoint
and the matcher of each frame) times the frames of the traced run's
window, over its wall time, against the TF32 peak."""
from portbench.common import PEAK_FLOPS


def read(ctx):
    w = ctx.window
    if not w.get("wall_s"):
        return None
    rate = ctx.shapes["flops_per_frame"] * w["frames"] / w["wall_s"]
    return 100.0 * rate / PEAK_FLOPS
