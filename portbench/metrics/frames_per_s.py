"""frames/s: every frame completed in the window over the window's wall
time, from its first submission to the device synchronise after the last
drain (host clock)."""


def read(ctx):
    w = ctx.window
    return w["frames"] / w["wall_s"] if w.get("wall_s") else None
