"""ms: the mean time of the extraction stage (SuperPoint, the stem kernel inside) a call over the traced run's window, by
CUDA events at the stage boundaries (device time, dispatch gaps
included)."""


def read(ctx):
    ms = ctx.stages.get("extract")
    return sum(ms) / len(ms) if ms else None
