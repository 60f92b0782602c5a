"""glue_ms: device time of every kernel that is not a ``__global__`` of the
program's csrc, with PyTorch's fills and device-to-device copies, per
traced analysis (profiler trace)."""


def read(ctx):
    t = ctx.get("trace")
    return 1e3 * t["glue_s"] / t["n"] if t and t["glue_s"] > 0 else None
