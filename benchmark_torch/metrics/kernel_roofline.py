"""kernel_roofline: the hand-written launches' bounds (``costs/<op>.py``
over ``peaks.py``) summed over the traced analyses, as a share of their
kernels' device time, in %."""


def read(ctx):
    t = ctx.get("trace")
    if not t or t["kernel_s"] <= 0 or ctx.get("bound_s") is None:
        return None
    return 100.0 * ctx["bound_s"] / t["kernel_s"]
