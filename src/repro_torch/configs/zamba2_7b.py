"""Zamba2-7B [hybrid] — Mamba2 backbone + shared attention block
[arXiv:2411.15242; unverified].

81 Mamba-2 layers; the single shared attention+MLP block (width 2·d_model,
input = concat(hidden, embeddings)) runs before every 6-layer group.
``decode_window`` caps the shared block's decode cache so the long_500k
shape stays sub-quadratic (DESIGN.md §4)."""
from dataclasses import replace

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv=32,
    d_ff=14336,
    vocab=32000,
    ssm_state=64,
    ssm_variant="mamba2",
    ssm_expand=2,
    ssm_head_dim=64,
    shared_attn_period=6,
    decode_window=4096,
    rope_theta=1e4,
    train_microbatches=8,
)

SMOKE = replace(
    CONFIG,
    name="zamba2-smoke",
    n_layers=5,  # 2 groups of 2 + 1 tail layer
    shared_attn_period=2,
    d_model=64,
    n_heads=4,
    n_kv=4,
    d_ff=128,
    vocab=512,
    ssm_state=8,
    ssm_head_dim=16,
    ssm_chunk=16,
    decode_window=64,
    q_chunk=32,
    kv_chunk=32,
    ce_chunk=32,
)
