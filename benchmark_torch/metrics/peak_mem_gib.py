"""peak_mem_gib: ``torch.cuda.max_memory_allocated()`` over the window's
analyses (reset as the window starts), in GiB."""


def read(ctx):
    peak = ctx.get("peak_bytes")
    return peak / 2 ** 30 if peak else None
