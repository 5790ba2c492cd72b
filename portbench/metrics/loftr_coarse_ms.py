"""ms: the mean time of LoFTR's coarse stage (the positional encoding and
the coarse transformer over the 15 pairs) a frame over the traced run's
window, by CUDA events at the stage boundaries (device time, dispatch
gaps included)."""


def read(ctx):
    ms = ctx.stages.get("coarse")
    return sum(ms) / len(ms) if ms else None
