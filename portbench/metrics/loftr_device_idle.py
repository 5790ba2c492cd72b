"""%: the share of the traced frames' window in which no kernel, copy or
set ran on the card: ``device_idle``'s reader, in the LoFTR cell."""
from portbench.metrics.device_idle import read  # noqa: F401
