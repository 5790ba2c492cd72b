"""%: the encoder kernel's share of its roofline in the traced steps: the
operations (counted once) of SuperPoint's seven 3x3 convolutions after the
stem, on the stem's pooled output, over the TF32 peak, against the
kernel's time an extract call (seven launches). Operations bound these
convolutions: their activations are a fifth of the bound in bytes."""
from portbench import flops
from portbench.common import PEAK_FLOPS

# (Cin, Cout, the pools before it): conv2a, conv2b, conv3a, conv3b, conv4a,
# conv4b, convPa|convDa; the stem's pool halves the crop before them all
CONVS = ((64, 64, 0), (64, 64, 0), (64, 128, 1), (128, 128, 1),
         (128, 128, 2), (128, 128, 2), (128, 512, 2))


def read(ctx):
    if ctx.trace is None or "stem" not in ctx.shapes:
        return None
    us, n = ctx.trace.kernel_us(r"encoder_conv")
    if not n:
        return None
    b, h, w = ctx.shapes["stem"]
    ops = sum(flops.conv(b, h >> (1 + p), w >> (1 + p), cin, cout, 3)
              for cin, cout, p in CONVS)
    return 100.0 * ops / PEAK_FLOPS / (us / (n / len(CONVS)) / 1e6)
