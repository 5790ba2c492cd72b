"""%: the whole step's model operations (``portbench/flops_loftr.py``: the
frame's backbone, the coarse transformer over the pairs, one S, the
fine stage over every slot) times the frames of the traced run's window,
over its wall time, against the TF32 peak: ``mfu``'s reader, in the
LoFTR cell, whose ``shapes()["flops_per_frame"]`` is flops_loftr's."""
from portbench.metrics.mfu import read  # noqa: F401
