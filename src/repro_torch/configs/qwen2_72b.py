"""Qwen2-72B [dense] — GQA kv=8, QKV bias [arXiv:2407.10671; hf]."""
from dataclasses import replace

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-72b",
    family="dense",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv=8,
    d_ff=29568,
    vocab=152064,
    head_dim=128,
    qkv_bias=True,
    rope_theta=1e6,
    train_microbatches=16,
)

SMOKE = replace(
    CONFIG,
    name="qwen2-72b-smoke",
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
