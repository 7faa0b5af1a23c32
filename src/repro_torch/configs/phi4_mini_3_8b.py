"""Phi-4-mini 3.8B [dense] — RoPE SwiGLU GQA, 200k vocab [arXiv:2412.08905; hf]."""
from dataclasses import replace

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="phi4-mini-3.8b",
    family="dense",
    n_layers=32,
    d_model=3072,
    n_heads=24,
    n_kv=8,
    d_ff=8192,
    vocab=200064,
    head_dim=128,
    rope_theta=1e4,
    train_microbatches=4,
)

SMOKE = replace(
    CONFIG,
    name="phi4-mini-smoke",
    n_layers=2,
    d_model=96,
    n_heads=3,
    n_kv=1,
    head_dim=32,
    d_ff=256,
    vocab=640,  # keep the embedding-dominated character, scaled down
    q_chunk=32,
    kv_chunk=32,
    ce_chunk=32,
)
