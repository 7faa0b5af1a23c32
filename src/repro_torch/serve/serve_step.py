"""Serve-step factories: prefill and decode functions and the greedy
generation loop.

The counterpart of ``repro.serve.serve_step``.  PyTorch runs eagerly, so
where the reference returns ``jax.jit``-ed functions the port returns
plain closures that run under ``torch.inference_mode()``.  Tensors made
there (the caches) are inference tensors: keep feeding them to these
closures, not to the model functions outside inference mode, which may
not update them in place.
"""
from __future__ import annotations

import torch

from repro_torch.models import model


def make_prefill(cfg, max_len: int):
    @torch.inference_mode()
    def prefill_step(params, batch):
        return model.prefill(cfg, params, batch, max_len)

    return prefill_step


def make_decode(cfg):
    @torch.inference_mode()
    def decode_step(params, cache, tokens):
        return model.decode_step(cfg, params, cache, tokens)

    return decode_step


@torch.inference_mode()
def greedy_generate(cfg, params, batch, *, steps: int, max_len: int) -> torch.Tensor:
    """Prefill + greedy decode ``steps`` tokens. Returns (B, steps) int64
    (int32 in the reference)."""
    prefill_step = make_prefill(cfg, max_len)
    decode = make_decode(cfg)
    cache, logits = prefill_step(params, batch)
    toks = []
    tok = torch.argmax(logits, dim=-1)[:, None]
    for _ in range(steps):
        toks.append(tok)
        cache, logits = decode(params, cache, tok)
        tok = torch.argmax(logits, dim=-1)[:, None]
    return torch.cat(toks, dim=1)
