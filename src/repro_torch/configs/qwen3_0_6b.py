"""Qwen3-0.6B [dense] — qk_norm, GQA kv=8 [hf:Qwen/Qwen3-8B family; hf]."""
from dataclasses import replace

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-0.6b",
    family="dense",
    n_layers=28,
    d_model=1024,
    n_heads=16,
    n_kv=8,
    d_ff=3072,
    vocab=151936,
    head_dim=128,  # decoupled from d_model/n_heads in Qwen3
    qk_norm=True,
    rope_theta=1e6,
    train_microbatches=2,
)

SMOKE = replace(
    CONFIG,
    name="qwen3-0.6b-smoke",
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv=2,
    head_dim=32,
    d_ff=256,
    vocab=512,
    q_chunk=32,
    kv_chunk=32,
    ce_chunk=32,
)
