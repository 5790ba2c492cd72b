"""%: the match kernel's share of its roofline at LoFTR's shape in the
traced steps: ``match_roofline``'s reader (the larger of one
S = f0 f1^T, 2·B·N1·N2·D, over the TF32 peak and its input and output
bytes over HBM's, over its time a call), in the LoFTR cell, whose
``shapes()["match"]`` is [15, 4096, 43200, 256]."""
from portbench.metrics.match_roofline import read  # noqa: F401
