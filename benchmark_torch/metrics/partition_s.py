"""partition_s: the program's stage time of "Calculating Bader volumes"
(``Bader.stage_seconds``; the hybrid's internal refinement included), the
mean over the traced analyses."""

STAGE = "Calculating Bader volumes"


def read(ctx):
    vals = [s[STAGE] for s in ctx.get("stages", []) if STAGE in s]
    return sum(vals) / len(vals) if vals else None
