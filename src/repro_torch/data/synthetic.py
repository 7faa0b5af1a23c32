"""Synthetic data: deterministic token streams + corpus metadata relations.

The counterpart of ``repro.data.synthetic``, with the same numpy draws.
Token batches are seeded per step (``SeedSequence([seed, step])``), so
restarts resume the exact stream; they are returned as tensors on the card
unless ``device`` says otherwise.  ``corpus_relations`` builds the
relational *metadata* view of a synthetic corpus (documents,
hash-duplicate and blocklist relations) that the SGF data pipeline
(:mod:`repro_torch.data.pipeline`) filters with multi-semi-join plans; it
is pure numpy.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.relation import resolve_device


def token_batch(cfg, shape_kind: str, batch: int, seq: int, step: int, *, seed: int = 0,
                device=None) -> dict:
    """One (batch, seq) int32 token batch, deterministic in (seed, step);
    a ``vlm`` config's batch keeps ``seq - frontend_tokens`` tokens and adds
    ``frontend_tokens`` patch embeddings, an ``audio`` config's keeps
    ``3/4`` of ``seq`` tokens and adds ``seq / 4`` frame embeddings (in
    ``cfg.dtype``)."""
    device = resolve_device(device)
    rng = np.random.default_rng(np.random.SeedSequence([seed, step]))
    tokens = rng.integers(0, cfg.vocab, (batch, seq)).astype(np.int32)
    embeds = None
    if cfg.family == "vlm":
        tokens = tokens[:, : seq - cfg.frontend_tokens]
        embeds = rng.normal(0, 0.1, (batch, cfg.frontend_tokens, cfg.d_model))
    elif cfg.family == "audio":
        tokens = tokens[:, : (seq * 3) // 4]
        embeds = rng.normal(0, 0.1, (batch, seq // 4, cfg.d_model))
    out = {"tokens": torch.as_tensor(np.ascontiguousarray(tokens), device=device)}
    if embeds is not None:
        # float64 -> float32 on the host, then to cfg.dtype
        out["embeds"] = torch.as_tensor(embeds.astype(np.float32), device=device).to(
            getattr(torch, cfg.dtype))
    return out


def make_batch_fn(cfg, batch: int, seq: int, *, seed: int = 0, device=None):
    return lambda step: token_batch(cfg, "train", batch, seq, step, seed=seed, device=device)


def corpus_relations(
    n_docs: int = 4096,
    *,
    dup_frac: float = 0.2,
    blocked_frac: float = 0.1,
    n_domains: int = 64,
    seed: int = 0,
) -> dict[str, np.ndarray]:
    """Metadata relations for a synthetic crawl:

    * ``Docs(doc, domain, h1, h2)`` — document id, source domain and two
      content fingerprints (shingle hashes).
    * ``Dup(h)`` — fingerprints seen in an earlier crawl (dedup list).
    * ``Blocked(domain)`` — domain blocklist.
    * ``Quality(doc)`` — docs passing the quality classifier.
    """
    rng = np.random.default_rng(seed)
    hash_space = n_docs * 4
    docs = np.stack(
        [
            np.arange(n_docs),
            rng.integers(0, n_domains, n_docs),
            rng.integers(0, hash_space, n_docs),
            rng.integers(0, hash_space, n_docs),
        ],
        axis=1,
    ).astype(np.int32)
    n_dup = int(n_docs * dup_frac)
    dup_hashes = np.unique(
        np.concatenate([docs[:n_dup, 2], rng.integers(0, hash_space, n_dup)])
    ).astype(np.int32)[:, None]
    blocked = rng.choice(n_domains, int(n_domains * blocked_frac), replace=False)
    blocked = blocked.astype(np.int32)[:, None]
    quality = rng.choice(n_docs, int(n_docs * 0.8), replace=False)
    quality = np.sort(quality).astype(np.int32)[:, None]
    return {"Docs": docs, "Dup": dup_hashes, "Blocked": blocked, "Quality": quality}
