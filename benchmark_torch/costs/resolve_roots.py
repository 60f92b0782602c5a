"""resolve_roots: each voxel's parent read and its root written, 8 bytes a
voxel (chip_smoke ``partition_kernels``)."""
WRAPPER = "pybader_tpu_torch.ops.pointer:resolve_roots_cuda"
KERNELS = ("tile_roots_kernel", "jump_kernel")


def cost(parent, stats=None):
    return {"bytes": 8 * parent.numel()}
