"""Phi-3-Vision 4.2B [vlm] — phi3-mini backbone + CLIP stub frontend
[hf:microsoft/Phi-3-vision-128k-instruct; hf].

Backbone only per the brief: ``input_specs()`` provides 576 precomputed
patch embeddings (CLIP ViT-L/14 @336px) prepended to the text tokens."""
from dataclasses import replace

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="phi-3-vision-4.2b",
    family="vlm",
    n_layers=32,
    d_model=3072,
    n_heads=32,
    n_kv=32,
    d_ff=8192,
    vocab=32064,
    head_dim=96,  # 3072 / 32
    frontend="vision",
    frontend_tokens=576,
    rope_theta=1e4,
    train_microbatches=4,
)

SMOKE = replace(
    CONFIG,
    name="phi3v-smoke",
    n_layers=2,
    d_model=128,
    n_heads=4,
    n_kv=4,
    head_dim=32,
    d_ff=256,
    vocab=512,
    frontend_tokens=16,
    q_chunk=32,
    kv_chunk=32,
    ce_chunk=32,
)
