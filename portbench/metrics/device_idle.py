"""%: the share of the traced steps' window in which no kernel, copy or
set ran on the card."""


def read(ctx):
    t = ctx.trace
    if t is None or t.window_us <= 0:
        return None
    return 100.0 * (1.0 - t.busy_us / t.window_us)
