"""Pure-torch oracle for the MSJ probe: quadratic all-pairs compare."""
from __future__ import annotations

import torch


def probe(
    build_sig: torch.Tensor,
    build_keys: torch.Tensor,
    build_ok: torch.Tensor,
    probe_sig: torch.Tensor,
    probe_keys: torch.Tensor,
    probe_ok: torch.Tensor,
    *,
    build_fp: torch.Tensor | None = None,
    probe_fp: torch.Tensor | None = None,
) -> torch.Tensor:
    del build_fp, probe_fp  # exact oracle; fingerprints are routing-only
    eq_sig = probe_sig[:, None] == build_sig[None, :]
    eq_key = (probe_keys[:, None, :] == build_keys[None, :, :]).all(-1)
    m = eq_sig & eq_key & probe_ok[:, None] & build_ok[None, :]
    return m.any(dim=1)
