from repro_torch.kernels.msj_probe import ops, ref  # noqa: F401
