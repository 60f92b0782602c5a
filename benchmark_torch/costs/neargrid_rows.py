"""neargrid_rows: 8 + 1 bytes read and 32 written a voxel; 35 f64
operations (6 compares, 3 differences, 3 halvings, 9 products, 9 sums, 3
absolute values, 2 maxima) and three divisions of DDIV_F64_OPS FP64
instructions each (chip_smoke ``rows_cost``)."""
from peaks import DDIV_F64_OPS

WRAPPER = "pybader_tpu_torch.ops.neargrid:neargrid_rows_cuda"
KERNELS = ("rows_march_kernel",)


def cost(reference, codes, t_grad, strict_grad):
    n = reference.numel()
    return {"bytes": (8 + 1 + 32) * n, "f64_ops": (35 + 3 * DDIV_F64_OPS) * n}
