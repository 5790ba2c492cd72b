"""ms: the mean time of LoFTR's fine stage (windows, coarse tokens, the
fine transformer and the expectation over every slot of the slate) a
frame over the traced run's window, by CUDA events at the stage
boundaries (device time, dispatch gaps included)."""


def read(ctx):
    ms = ctx.stages.get("fine")
    return sum(ms) / len(ms) if ms else None
