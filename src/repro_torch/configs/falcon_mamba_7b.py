"""Falcon-Mamba-7B [ssm] — pure Mamba-1, attention-free [arXiv:2410.05355; unverified]."""
from dataclasses import replace

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="falcon-mamba-7b",
    family="ssm",
    n_layers=64,
    d_model=4096,
    n_heads=0,
    n_kv=0,
    d_ff=0,  # attention-free, FFN folded into the mamba block
    vocab=65024,
    ssm_state=16,
    ssm_variant="mamba1",
    ssm_expand=2,
    ssm_conv=4,
    train_microbatches=8,
)

SMOKE = replace(
    CONFIG,
    name="falcon-mamba-smoke",
    n_layers=3,
    d_model=64,
    vocab=512,
    ssm_state=8,
    ssm_chunk=16,
    ce_chunk=32,
)
