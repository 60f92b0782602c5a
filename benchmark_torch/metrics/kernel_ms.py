"""kernel_ms: device time of the hand-written kernels (the ``__global__``
functions of the program's csrc) per traced analysis (profiler trace)."""


def read(ctx):
    t = ctx.get("trace")
    return 1e3 * t["kernel_s"] / t["n"] if t and t["kernel_s"] > 0 else None
