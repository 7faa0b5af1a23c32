"""PyTorch/CUDA port of the multi-semi-join engine.

Mirrors the layout and names of the JAX package ``repro`` module for
module (``repro_torch.core.msj`` is the counterpart of ``repro.core.msj``),
with the Pallas TPU kernels replaced by CUDA kernels written for Hopper.
Entry points place data on the CUDA card unless the caller passes
``device="cpu"``.
"""
