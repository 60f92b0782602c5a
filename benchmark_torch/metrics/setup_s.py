"""setup_s: process start to the first timed analysis (imports, the CUDA
context, the kernel library, the densities made and copied to the host,
one warm analysis of each grid shape)."""


def read(ctx):
    return ctx.get("setup_s")
