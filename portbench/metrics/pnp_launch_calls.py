"""calls: kernel launches (and graph launches) that the host makes inside
one PnP call, counted from the runtime events of the trace within the
harness's ``pnp`` spans: the count a CUDA graph moves."""


def read(ctx):
    if ctx.trace is None:
        return None
    n, spans = ctx.trace.launches_in("pnp")
    return n / spans if spans else None
