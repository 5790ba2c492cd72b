"""%: the stem kernel's share of its roofline in the traced steps: the
larger of its operations (counted once) over the TF32 peak and its bytes
over HBM's, over its mean time a launch in the trace."""
from portbench import flops
from portbench.common import PEAK_BYTES, PEAK_FLOPS


def read(ctx):
    if ctx.trace is None or "stem" not in ctx.shapes:
        return None
    us, n = ctx.trace.kernel_us(r"stem_kernel")
    if not n:
        return None
    shape = ctx.shapes["stem"]
    bound = max(flops.stem(*shape) / PEAK_FLOPS,
                flops.stem_bytes(*shape) / PEAK_BYTES)
    return 100.0 * bound / (us / n / 1e6)
