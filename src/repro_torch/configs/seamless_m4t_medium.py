"""SeamlessM4T-medium [audio] — enc-dec, speech stub frontend
[arXiv:2308.11596; hf].

Backbone only per the brief: ``input_specs()`` provides precomputed frame
embeddings for the encoder (seq_len/4 frames); the decoder consumes
seq_len·3/4 text tokens.  Encoder is bidirectional, so there is no
encoder decode step; decode shapes exercise the decoder with its self +
cross caches."""
from dataclasses import replace

from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-medium",
    family="audio",
    n_layers=24,  # 12 enc + 12 dec
    enc_layers=12,
    dec_layers=12,
    d_model=1024,
    n_heads=16,
    n_kv=16,
    d_ff=4096,
    vocab=256206,
    head_dim=64,
    frontend="audio",
    rope_theta=1e4,
    train_microbatches=2,
)

SMOKE = replace(
    CONFIG,
    name="seamless-smoke",
    n_layers=4,
    enc_layers=2,
    dec_layers=2,
    d_model=64,
    n_heads=4,
    n_kv=4,
    head_dim=16,
    d_ff=128,
    vocab=512,
    q_chunk=32,
    kv_chunk=32,
    ce_chunk=32,
)
