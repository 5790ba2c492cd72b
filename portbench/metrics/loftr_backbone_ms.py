"""ms: the mean time of LoFTR's backbone stage (the frame's ResNet-FPN,
from the frame's submission: its upload included) a frame over the traced
run's window, by CUDA events at the stage boundaries (device time,
dispatch gaps included)."""


def read(ctx):
    ms = ctx.stages.get("backbone")
    return sum(ms) / len(ms) if ms else None
