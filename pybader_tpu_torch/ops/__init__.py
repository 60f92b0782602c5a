"""Device ops of the port: stencil, roots and labels, reductions, edges,
neargrid walk rows and walker, atoms.  Kernel-backed ops dispatch on their input's device (see
:func:`pybader_tpu_torch.ops._cuda.on_cuda`)."""
