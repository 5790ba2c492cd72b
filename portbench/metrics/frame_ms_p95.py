"""ms: the 95th percentile of each frame's time from its submission to
its box on the host, over every frame of the window (host clock; linear
interpolation between order statistics)."""
import numpy as np


def read(ctx):
    lat = ctx.window.get("latency_ms")
    return float(np.percentile(lat, 95)) if lat else None
