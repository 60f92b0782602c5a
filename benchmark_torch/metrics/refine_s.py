"""refine_s: the program's stage time of "Refining volume edges"
(``Bader.stage_seconds``), the mean over the traced analyses."""

STAGE = "Refining volume edges"


def read(ctx):
    vals = [s[STAGE] for s in ctx.get("stages", []) if STAGE in s]
    return sum(vals) / len(vals) if vals else None
