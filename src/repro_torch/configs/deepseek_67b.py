"""DeepSeek-67B [dense] — llama-arch, GQA kv=8 [arXiv:2401.02954; hf]."""
from dataclasses import replace

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-67b",
    family="dense",
    n_layers=95,
    d_model=8192,
    n_heads=64,
    n_kv=8,
    d_ff=22016,
    vocab=102400,
    head_dim=128,
    rope_theta=1e4,
    train_microbatches=16,
)

SMOKE = replace(
    CONFIG,
    name="deepseek-67b-smoke",
    n_layers=3,  # odd layer count, like the 95L original
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
