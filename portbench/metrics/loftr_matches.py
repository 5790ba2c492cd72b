"""matches: the mean count of a frame's mutual coarse matches over the
window's frames (the matcher's ``last_matches``, read after each box)."""


def read(ctx):
    n = ctx.window.get("matches")
    return sum(n) / len(n) if n else None
