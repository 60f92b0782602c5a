"""idle_share: the share of the traced analyses' wall time in which the
device runs no kernel and no copy, in %."""


def read(ctx):
    t = ctx.get("trace")
    if not t or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
