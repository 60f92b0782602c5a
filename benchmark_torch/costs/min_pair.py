"""min_pair: the 4-byte label and 1-byte mask of every voxel read, two
4-byte minima a label written (chip_smoke ``partition_kernels``)."""
WRAPPER = "pybader_tpu_torch.ops.reductions:min_pair_cuda"
KERNELS = ("min_pair_runs_kernel", "fill_pair_kernel")


def cost(labels, mask, num_segments):
    return {"bytes": 5 * labels.numel() + 8 * num_segments}
