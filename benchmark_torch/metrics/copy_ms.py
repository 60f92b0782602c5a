"""copy_ms: device time of the host-to-device and device-to-host copies
per traced analysis (profiler trace)."""


def read(ctx):
    t = ctx.get("trace")
    return 1e3 * t["copy_s"] / t["n"] if t and t["copy_s"] > 0 else None
