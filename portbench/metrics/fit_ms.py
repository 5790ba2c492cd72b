"""ms: the mean time of the similarity RANSAC and the box on the host a call over the traced run's window, by
CUDA events at the stage boundaries (device time, dispatch gaps
included)."""


def read(ctx):
    ms = ctx.stages.get("fit")
    return sum(ms) / len(ms) if ms else None
