"""edge_find, from this launch's data: labels read and known written
everywhere (5 bytes a voxel), is_max where the function reads it: the
non-vacuum voxels whose 27-box holds another non-vacuum label (chip_smoke
``find_cost``)."""
from reference import is_edge

WRAPPER = "pybader_tpu_torch.ops.edges:edge_find_cuda"
KERNELS = ("edge_find_kernel",)


def cost(labels, is_max):
    reads = (labels != -1) & is_edge(labels)
    return {"bytes": 5 * labels.numel() + int(reads.sum())}
