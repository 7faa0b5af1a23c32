"""Architecture configs, input-shape sets, and the ``--arch`` registry.

Every assigned architecture is a module ``repro_torch.configs.<id>`` exporting
``CONFIG`` (the exact published hyperparameters) and ``SMOKE`` (a reduced
same-family config for CPU smoke tests).  ``get_config(arch)`` resolves
ids; ``SHAPES`` defines the four assigned input shapes.

Shape semantics (brief):
* ``train_4k``    — lowers ``train_step``  (seq 4096, global batch 256)
* ``prefill_32k`` — lowers the prefill ``serve_step`` (seq 32768, batch 32)
* ``decode_32k``  — one-token ``serve_step`` vs a 32768 KV cache, batch 128
* ``long_500k``   — one-token ``serve_step`` vs a 524288-token context,
  batch 1; requires a sub-quadratic history path, so it is *skipped* for
  pure full-attention archs and *run* for SSM / hybrid / SWA archs
  (DESIGN.md §4).

Multimodal shape convention: the [vlm] family prepends
``frontend_tokens`` stub patch embeddings (text tokens fill the rest of
seq_len); the [audio] enc-dec family splits seq_len as 1/4 encoder frames
and 3/4 decoder text tokens.
"""
from __future__ import annotations

import importlib
from dataclasses import dataclass, field, replace


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    head_dim: int = 128
    rope_theta: float = 1e4
    qkv_bias: bool = False
    qk_norm: bool = False
    rmsnorm_eps: float = 1e-6
    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_impl: str = "dense"  # "dense" (baseline) | "sort" (capacity dispatch)
    capacity_factor: float = 1.25
    expert_parallel: bool = False  # shard experts over the model axis
    # SSM
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_variant: str = ""  # mamba1 | mamba2
    ssm_head_dim: int = 64
    ssm_chunk: int = 128
    # attention
    window: int = 0  # sliding-window attention (0 = full causal)
    decode_window: int = 0  # cap on decode cache length (hybrid long-ctx)
    # hybrid
    shared_attn_period: int = 0
    # enc-dec
    enc_layers: int = 0
    dec_layers: int = 0
    # modality stub frontend
    frontend: str = "none"  # none | vision | audio
    frontend_tokens: int = 0
    # numerics / performance knobs (§Perf iterates these)
    dtype: str = "bfloat16"
    remat: str = "full"  # none | full | dots
    q_chunk: int = 512
    kv_chunk: int = 1024
    ce_chunk: int = 512
    # gradient-accumulation microbatches for train_4k: bounds the per-layer
    # saved-residual stack (L, B/mb, S, d) to fit 16 GB HBM
    train_microbatches: int = 1
    # sequence-parallel activations (Megatron SP): shard the residual
    # stream's seq dim over the model axis between attention regions
    seq_shard: bool = False
    # cast layer-stacked params to the compute dtype BEFORE the layer scan,
    # so FSDP all-gathers move bf16 instead of f32 (halves gather bytes)
    bf16_weight_gather: bool = False

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """Has an O(1)-or-windowed decode path (long_500k applicability)."""
        return self.family in ("ssm", "hybrid") or self.window > 0

    def param_count(self) -> int:
        """Analytic parameter count (drives roofline MODEL_FLOPS)."""
        d, v = self.d_model, self.vocab
        total = v * d  # embed
        total += d * v  # lm_head
        if self.family in ("dense", "moe", "vlm"):
            attn = d * self.n_heads * self.head_dim * 2 + d * self.n_kv * self.head_dim * 2
            if self.family == "moe":
                ffn = self.n_experts * 3 * d * self.d_ff + d * self.n_experts
            else:
                ffn = 3 * d * self.d_ff
            total += self.n_layers * (attn + ffn + 2 * d)
        elif self.family == "ssm":
            di = self.ssm_expand * d
            dtr = max(1, d // 16)
            per = (
                d * 2 * di + di * self.ssm_conv + di * (dtr + 2 * self.ssm_state)
                + dtr * di + di * self.ssm_state + 2 * di + di * d + d
            )
            total += self.n_layers * per
        elif self.family == "hybrid":
            di = self.ssm_expand * d
            H = di // self.ssm_head_dim
            per = d * (2 * di + 2 * self.ssm_state + H) + (di + 2 * self.ssm_state) * self.ssm_conv + di * d + 2 * di + 3 * H
            total += self.n_layers * per
            d2 = 2 * d
            hd = d2 // self.n_heads
            shared = (
                d2 * self.n_heads * hd + 2 * d2 * self.n_kv * hd
                + self.n_heads * hd * d2 + 3 * d2 * self.d_ff + d2 * d + 2 * d2
            )
            total += shared
        elif self.family == "audio":
            attn = d * self.n_heads * self.head_dim * 2 + d * self.n_kv * self.head_dim * 2
            ffn = 2 * d * self.d_ff
            total += self.enc_layers * (attn + ffn + 2 * d)
            total += self.dec_layers * (2 * attn + ffn + 3 * d)
        return int(total)

    def active_param_count(self) -> int:
        """MoE: params touched per token (for MODEL_FLOPS = 6·N_active·D)."""
        if self.family != "moe":
            return self.param_count()
        d = self.d_model
        attn = d * self.n_heads * self.head_dim * 2 + d * self.n_kv * self.head_dim * 2
        ffn = self.top_k * 3 * d * self.d_ff + d * self.n_experts
        dense_part = self.vocab * d * 2 + self.n_layers * (attn + ffn + 2 * d)
        return int(dense_part)


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}

ARCH_IDS = [
    "qwen2-72b",
    "qwen3-0.6b",
    "deepseek-67b",
    "phi4-mini-3.8b",
    "zamba2-7b",
    "mixtral-8x7b",
    "olmoe-1b-7b",
    "falcon-mamba-7b",
    "phi-3-vision-4.2b",
    "seamless-m4t-medium",
]


def _module(arch: str):
    return importlib.import_module("repro_torch.configs." + arch.replace("-", "_").replace(".", "_"))


def get_config(arch: str, *, smoke: bool = False, **overrides) -> ArchConfig:
    cfg = _module(arch).SMOKE if smoke else _module(arch).CONFIG
    return replace(cfg, **overrides) if overrides else cfg


def list_archs() -> list[str]:
    return list(ARCH_IDS)


def shape_applicable(cfg: ArchConfig, shape: str) -> tuple[bool, str]:
    """(runnable, reason-if-skipped) per the brief's skip rules."""
    if shape == "long_500k" and not cfg.sub_quadratic:
        return False, (
            "pure full-attention arch: 512k-token decode has no "
            "sub-quadratic path (DESIGN.md §4 skip)"
        )
    return True, ""
