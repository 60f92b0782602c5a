"""ongrid_step_codes: 8 bytes read and 1 written a voxel; 26 candidates of
(rho_n - rho_p) * w + rho_p, 78 f64 operations a voxel (chip_smoke
``stencil_cost``)."""
WRAPPER = "pybader_tpu_torch.ops.stencil:ongrid_step_codes_cuda"
KERNELS = ("ongrid_step_codes_kernel",)


def cost(reference, weights):
    n = reference.numel()
    return {"bytes": 9 * n, "f64_ops": 78 * n}
