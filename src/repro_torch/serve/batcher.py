"""Static-slot continuous batcher for decode serving.

The counterpart of ``repro.serve.batcher``.  Maintains ``max_batch``
decode slots; finished or empty slots are refilled from the request queue
at step boundaries (prefill for one request, then its cache rows are copied
into the batch cache).  The decode step always runs at the full batch
width: every slot's clock advances, active or not, and a slot's stale
tail is masked by its own clock, so the batched tokens equal the
unbatched ones.  Requests are served on the device of ``params``.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.models import model
from repro_torch.serve.serve_step import make_decode, make_prefill


@dataclass
class Request:
    rid: int
    prompt: np.ndarray  # (S,) integer token ids
    max_new: int
    out: list = field(default_factory=list)
    done: bool = False


class Batcher:
    @torch.inference_mode()
    def __init__(self, cfg, params, *, max_batch: int, max_len: int, eos: int = -1):
        self.cfg, self.params = cfg, params
        self.max_batch, self.max_len, self.eos = max_batch, max_len, eos
        self.device = params.device
        self.decode = make_decode(cfg)
        # one prefill closure (the reference builds, and jits, one per request)
        self.prefill = make_prefill(cfg, max_len)
        self.queue: list[Request] = []
        self.slots: list[Request | None] = [None] * max_batch
        self.cache = model.init_cache(cfg, max_batch, max_len, device=self.device)
        self.tokens = torch.zeros((max_batch, 1), dtype=torch.int64, device=self.device)
        self.remaining = np.zeros(max_batch, np.int64)

    def submit(self, req: Request):
        self.queue.append(req)

    def _fill_slots(self):
        for i in range(self.max_batch):
            if self.slots[i] is None and self.queue:
                req = self.queue.pop(0)
                # single-request prefill at the slot's position
                batch = {"tokens": torch.as_tensor(req.prompt[None, :], dtype=torch.int64,
                                                   device=self.device)}
                cache1, logits = self.prefill(self.params, batch)
                tok = int(torch.argmax(logits[0]))
                self.cache = _copy_slot(self.cache, cache1, i)
                self.tokens[i, 0] = tok
                req.out.append(tok)
                self.remaining[i] = req.max_new - 1
                self.slots[i] = req

    @torch.inference_mode()
    def step(self) -> int:
        """One decode wave over all active slots; returns #active."""
        self._fill_slots()
        active = [i for i, s in enumerate(self.slots) if s is not None]
        if not active:
            return 0
        self.cache, logits = self.decode(self.params, self.cache, self.tokens)
        next_tok = torch.argmax(logits, dim=-1)
        self.tokens = next_tok[:, None]
        toks = next_tok.tolist()
        for i in active:
            req = self.slots[i]
            tok = toks[i]
            req.out.append(tok)
            self.remaining[i] -= 1
            if self.remaining[i] <= 0 or tok == self.eos:
                req.done = True
                self.slots[i] = None
        return len(active)

    def run(self) -> None:
        while self.queue or any(s is not None for s in self.slots):
            self.step()


def _copy_slot(batch_cache: dict, single_cache: dict, slot: int) -> dict:
    """Copy a single-request cache (batch 1) into batch slot ``slot``, in
    place, by the reference's rule: ``len`` is the per-slot clock; the
    batch axis is dim 2 for the hybrid's grouped ``conv``/``ssm`` leaves
    (``(g, per, B, ...)``, ndim ≥ 5) and dim 1 for every other leaf."""
    for name, big in batch_cache.items():
        small = single_cache[name]
        if name == "len":
            big[slot] = small[0]
        elif big.ndim >= 5 and name in ("conv", "ssm"):
            big[:, :, slot:slot + 1] = small
        else:
            big[:, slot:slot + 1] = small
    return batch_cache
