"""stop_bitmap: the known grid read once (a byte a voxel), the bitmap
written once (4 bytes a 32 voxels) (chip_smoke ``neargrid_phase``)."""
WRAPPER = "pybader_tpu_torch.ops.neargrid:stop_bitmap_cuda"
KERNELS = ("stop_bitmap_kernel",)


def cost(known, value=2):
    n = known.numel()
    return {"bytes": n + 4 * -(-n // 32)}
