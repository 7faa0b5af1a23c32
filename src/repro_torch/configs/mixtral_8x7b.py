"""Mixtral-8x7B [moe] — 8 experts top-2, SWA 4096 [arXiv:2401.04088; hf]."""
from dataclasses import replace

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mixtral-8x7b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv=8,
    d_ff=14336,
    vocab=32000,
    head_dim=128,
    n_experts=8,
    top_k=2,
    window=4096,  # sliding-window attention
    rope_theta=1e6,
    train_microbatches=8,
)

SMOKE = replace(
    CONFIG,
    name="mixtral-smoke",
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv=2,
    head_dim=32,
    d_ff=128,
    vocab=512,
    n_experts=4,
    top_k=2,
    window=64,
    q_chunk=32,
    kv_chunk=32,
    ce_chunk=32,
)
