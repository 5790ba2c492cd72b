"""%: the match kernel's share of its roofline in the traced steps: the
larger of one S = m0 m1^T (2·B·N1·N2·D) over the TF32 peak and its input
and output bytes over HBM's, over its time a call (split, passes and
merge; one merge a call)."""
from portbench import flops
from portbench.common import PEAK_BYTES, PEAK_FLOPS


def read(ctx):
    if ctx.trace is None or "match" not in ctx.shapes:
        return None
    us, _ = ctx.trace.kernel_us(r"match_(split|pass|merge)")
    _, calls = ctx.trace.kernel_us(r"match_merge")
    if not calls:
        return None
    shape = ctx.shapes["match"]
    bound = max(flops.match(*shape) / PEAK_FLOPS,
                flops.match_bytes(*shape) / PEAK_BYTES)
    return 100.0 * bound / (us / calls / 1e6)
