"""analysis_s: the window's wall time (host clock, from its start to the
last analysis's results on the host) over the analyses it completed."""


def read(ctx):
    return ctx["window_s"] / ctx["n"] if ctx.get("n") else None
