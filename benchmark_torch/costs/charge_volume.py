"""charge_volume: the 8-byte density and 4-byte label of every voxel read,
an 8-byte sum and an 8-byte count a label written; one f64 add a voxel
(chip_smoke ``partition_kernels``)."""
WRAPPER = "pybader_tpu_torch.ops.reductions:charge_volume_cuda"
KERNELS = ("charge_volume_kernel", "charge_volume_blocks_kernel",
           "zero_sums_kernel")


def cost(density, labels, num_segments):
    n = labels.numel()
    return {"bytes": 12 * n + 16 * num_segments, "f64_ops": n}
