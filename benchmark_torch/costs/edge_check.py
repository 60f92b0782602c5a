"""edge_check, from this launch's data: known read and written everywhere
(2 bytes a voxel), the 4-byte labels within 1 of a -2 and within 1 of a
candidate, the 1-byte is_max at the candidates that are edges (chip_smoke
``check_cost``, the reads of ``edges.check_reads``)."""
import torch

from reference import box, is_edge

WRAPPER = "pybader_tpu_torch.ops.edges:edge_check_cuda"
KERNELS = ("edge_check_kernel",)


def cost(known, labels, is_max):
    near = box(known == -2, torch.logical_or)
    cand = near & (labels != -1)
    lab = near | box(cand, torch.logical_or)
    mx = cand & is_edge(labels)
    return {"bytes": 2 * known.numel() + 4 * int(lab.sum()) + int(mx.sum())}
