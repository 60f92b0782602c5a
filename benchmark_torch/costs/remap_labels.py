"""remap_labels: every 4-byte label read and written, the 4-byte table
read once (chip_smoke ``partition_kernels``)."""
WRAPPER = "pybader_tpu_torch.ops.reductions:remap_labels_cuda"
KERNELS = ("remap_kernel",)


def cost(labels, table, num_segments):
    return {"bytes": 8 * labels.numel() + 4 * num_segments}
