"""OLMoE-1B-7B [moe] — 64 experts top-8, fine-grained FFN [arXiv:2409.02060; hf]."""
from dataclasses import replace

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="olmoe-1b-7b",
    family="moe",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv=16,
    d_ff=1024,
    vocab=50304,
    head_dim=128,
    n_experts=64,
    top_k=8,
    rope_theta=1e4,
    train_microbatches=2,
)

SMOKE = replace(
    CONFIG,
    name="olmoe-smoke",
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv=4,
    head_dim=32,
    d_ff=64,
    vocab=512,
    n_experts=8,
    top_k=2,
    q_chunk=32,
    kv_chunk=32,
    ce_chunk=32,
)
