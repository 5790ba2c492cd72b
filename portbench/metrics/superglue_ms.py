"""ms: the mean time of SuperGlue's log assignment and mutual matches a call over the traced run's window, by
CUDA events at the stage boundaries (device time, dispatch gaps
included)."""


def read(ctx):
    ms = ctx.stages.get("superglue")
    return sum(ms) / len(ms) if ms else None
