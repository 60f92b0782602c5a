"""The NVIDIA H100 SXM's peaks that bound a hand-written kernel, and the
bound of one launch.

Copied from ``chip_smoke.py``: bytes over the device memory's 3.35 TB/s,
and operations over the card's instruction rate for their type outside the
tensor cores (132 SMs x 64 FP64 or 128 FP32 lanes x 1.98 GHz).  The
kernels build with -fmad=false, so each counted add, subtract or multiply
is one instruction (the data sheet's 34 and 67 TFLOP/s count a fused
multiply-add as two), and a correctly rounded f64 division counts the
FP64 instructions of its fast path.
"""
HBM_BYTES_PER_S = 3.35e12
F64_OPS_PER_S = 132 * 64 * 1.98e9
F32_OPS_PER_S = 132 * 128 * 1.98e9
# FP64 instructions of one __ddiv_rn's fast path on sm_90a (a SASS count)
DDIV_F64_OPS = 8


def bound_s(cost: dict) -> float:
    """The least seconds a launch of ``cost`` ({"bytes", "f64_ops",
    "f32_ops"}) could take: its bytes over the memory rate or its
    operations over their rates, whichever is longer."""
    t_bytes = cost.get("bytes", 0) / HBM_BYTES_PER_S
    t_ops = (cost.get("f64_ops", 0) / F64_OPS_PER_S
             + cost.get("f32_ops", 0) / F32_OPS_PER_S)
    return max(t_bytes, t_ops)
