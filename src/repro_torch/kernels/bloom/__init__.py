from repro_torch.kernels.bloom import ops, ref  # noqa: F401
