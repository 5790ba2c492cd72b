"""ms: the mean time of the similarity RANSAC on the [views, view cells]
slates and the box on the host a frame over the traced run's window, by
CUDA events at the stage boundaries (device time, dispatch gaps
included): ``fit_ms``'s reader, in the LoFTR cell."""
from portbench.metrics.fit_ms import read  # noqa: F401
