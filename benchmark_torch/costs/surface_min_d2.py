"""surface_min_d2, from this launch's data: one mask byte a voxel, the
32-byte label sectors that hold an edge voxel, 32 bytes an atom (its
position read, d2 written); for each edge voxel whose label is an atom, 3
f32 products (its fractional position), 15 f64 operations (its cartesian
position) and per image 3 differences, 3 squares and 2 sums (the images
atom + shift are formed once an atom, and not counted).  (chip_smoke
``surface_cost``.)"""
import torch

WRAPPER = "pybader_tpu_torch.ops.atoms:surface_min_d2_cuda"
KERNELS = ("surface_min_d2_kernel", "fill_u64_kernel")


def cost(labels, edge_mask, lattice, atoms_cart, num_atoms, origin=(0, 0, 0),
         shape=None):
    idx = torch.nonzero(edge_mask.reshape(-1)).reshape(-1)
    lab = labels.reshape(-1)[idx]
    n_edge = int(((lab >= 0) & (lab < num_atoms)).sum())
    sectors = int(torch.unique(idx // 8).numel())
    return {"bytes": edge_mask.numel() + 32 * sectors + 32 * num_atoms,
            "f64_ops": (15 + 27 * 8) * n_edge, "f32_ops": 3 * n_edge}
