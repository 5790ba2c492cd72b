"""ms: the mean host time a batch waits for the loader's staged upload
(``Staged.wait``) over the traced run's window (host clock)."""


def read(ctx):
    waits = ctx.window.get("stage_wait_s")
    return 1e3 * sum(waits) / len(waits) if waits else None
