"""ms: the mean time of the PnP stage (LO-RANSAC, dispatch included) a call over the traced run's window, by
CUDA events at the stage boundaries (device time, dispatch gaps
included)."""


def read(ctx):
    ms = ctx.stages.get("pnp")
    return sum(ms) / len(ms) if ms else None
