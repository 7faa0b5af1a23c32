"""The MSJ probes: CUDA kernels for the card and their plain torch
versions, behind the engine's ``probe_fn`` interface.

``probe_fn`` signature: ``(build_sig, build_keys, build_ok, probe_sig,
probe_keys, probe_ok, *, build_fp=None, probe_fp=None) -> hits``, where
``hits[i]`` says that probe row i is valid and some valid build row has the
same (signature, key).

* :func:`probe_bucketed` — the executor's ``"kernel"`` backend (DESIGN.md
  §6).  Both sides are sorted by a fingerprint *prune key* (one stable
  single-column sort each), each tile of :data:`TILE` probe rows compares
  only against the band of build rows whose prune keys fall in the tile's
  range, and the hits are scattered back to the probe side's order.  On
  CUDA tensors the band compare is the hand-written kernel
  ``csrc/probe_bucketed.cu`` (it replaces the reference's Pallas kernel
  ``probe_bucketed_blocked``); on CPU tensors it is the plain version.
* :func:`probe_bucketed_plain` — the same arithmetic in torch on any
  device: the same sort, each tile's band by ``torch.searchsorted`` and an
  all-pairs compare inside the band.  Tests and ``chip_smoke.py`` hold the
  kernel against it.

* :func:`probe` — the unbucketed all-pairs probe, a drop-in ``probe_fn``
  for ``run_msj`` kept as the worst-case reference: every valid probe row
  against every build row, no sort, fingerprints ignored.  On CUDA tensors
  it launches the second kernel of ``csrc/probe_bucketed.cu`` (which
  replaces the reference's Pallas kernel ``probe_blocked``); on CPU
  tensors it takes the plain version, chunked all-pairs in torch
  (:func:`probe_blocked_plain` on any device).

Matching inside a band is exact on (signature, key), so fingerprint
collisions — including adversarially colliding ``*_fp`` inputs — only
widen the band, never change the result.  ``probe_bucketed.launches`` and
``probe.launches`` count kernel launches.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.engine import hashing
from repro_torch.kernels import build as kbuild

#: probe rows per kernel block (and per band of the plain version)
TILE = 128
#: build rows per work item of the plain version's band compare
_PLAIN_SEG = 1024
#: (probe row, build row) pairs the plain version compares per step
_PLAIN_PAIRS = 1 << 24

SOURCE = Path(__file__).resolve().parent / "csrc" / "probe_bucketed.cu"


def _default_fp(sig: torch.Tensor, keys: torch.Tensor) -> torch.Tensor:
    """Standalone fingerprint for callers outside run_msj: any function of
    (sig, key) works as long as build and probe agree."""
    rows = torch.cat([sig.to(torch.int32)[:, None], keys.to(torch.int32)], 1)
    return hashing.to_i32(hashing.hash_cols(rows))


def _sorted_side(sig, keys, ok, fp):
    """Sort one side by prune key, stably.  Rows that are not valid take
    prune key -1 and sort to the front.  Returns ``(cols (N, KW+1) int32
    [sig, keys...], pk (N,) int32, ok (N,) bool, order)``, all contiguous
    and in sorted order."""
    pk = torch.where(ok, hashing.prune_key(fp), -1).to(torch.int32)
    pk_s, order = torch.sort(pk, stable=True)
    cols = torch.cat([sig.to(torch.int32)[:, None], keys.to(torch.int32)], 1)
    return cols[order].contiguous(), pk_s.contiguous(), ok[order].contiguous(), order


def _sides(build_sig, build_keys, build_ok, probe_sig, probe_keys, probe_ok,
           build_fp, probe_fp):
    if build_fp is None:
        build_fp = _default_fp(build_sig, build_keys)
    if probe_fp is None:
        probe_fp = _default_fp(probe_sig, probe_keys)
    b_cols, b_pk, b_ok, _ = _sorted_side(build_sig, build_keys, build_ok, build_fp)
    p_cols, p_pk, p_ok, p_order = _sorted_side(probe_sig, probe_keys, probe_ok, probe_fp)
    return (p_cols, p_pk, p_ok, b_cols, b_pk, b_ok), p_order


def _bucketed(band, build_sig, build_keys, build_ok, probe_sig, probe_keys, probe_ok,
              build_fp, probe_fp) -> torch.Tensor:
    """Sort both sides, run ``band`` (the kernel or its plain version) and
    scatter the hits back to the probe side's order."""
    n_p, n_b = probe_sig.shape[0], build_sig.shape[0]
    if n_p == 0 or n_b == 0:  # a grid of 0 blocks is not a valid launch
        return torch.zeros((n_p,), dtype=torch.bool, device=probe_sig.device)
    sides, p_order = _sides(build_sig, build_keys, build_ok, probe_sig, probe_keys,
                            probe_ok, build_fp, probe_fp)
    out = torch.zeros_like(probe_ok)
    out[p_order] = band(*sides)
    return out & probe_ok


def tile_bands(p_pk: torch.Tensor, b_pk: torch.Tensor):
    """Each probe tile's band of build rows, as the kernel finds it:
    ``(starts, b0, b1)`` — tile t covers probe rows ``[starts[t],
    starts[t] + TILE)`` and compares build rows ``[b0[t], b1[t])``, those
    whose prune keys lie in the tile's ``[lo, hi]`` (empty for a tile of
    invalid rows, whose prune keys are -1)."""
    NP = p_pk.shape[0]
    starts = torch.arange(0, NP, TILE, device=p_pk.device)
    lasts = torch.clamp(starts + TILE, max=NP) - 1
    hi = p_pk[lasts]
    b0 = torch.searchsorted(b_pk, torch.clamp(p_pk[starts], min=0), right=False)
    b1 = torch.where(hi < 0, b0, torch.searchsorted(b_pk, hi, right=True))
    return starts, b0, b1


def band_probe_plain(p_cols, p_pk, p_ok, b_cols, b_pk, b_ok) -> torch.Tensor:
    """Plain torch band compare over sorted sides (the kernel's contract):
    ``(NP,) bool`` hits in the probe side's sorted order."""
    NP, n_cols = p_cols.shape
    NB = b_cols.shape[0]
    dev = p_cols.device
    hits = torch.zeros((NP,), dtype=torch.int32, device=dev)
    starts, b0, b1 = tile_bands(p_pk, b_pk)
    n_tiles = starts.shape[0]
    # cut each band into work items of at most _PLAIN_SEG build rows
    n_seg = (b1 - b0 + _PLAIN_SEG - 1) // _PLAIN_SEG
    total = int(n_seg.sum())
    item_tile = torch.repeat_interleave(torch.arange(n_tiles, device=dev), n_seg)
    first = torch.cumsum(n_seg, 0) - n_seg
    item_j0 = b0[item_tile] + (
        torch.arange(total, device=dev) - first[item_tile]
    ) * _PLAIN_SEG
    item_j1 = torch.minimum(item_j0 + _PLAIN_SEG, b1[item_tile])
    p_active = p_ok & (p_pk >= 0)
    ar_t = torch.arange(TILE, device=dev)
    ar_s = torch.arange(_PLAIN_SEG, device=dev)
    per_step = max(1, _PLAIN_PAIRS // (TILE * _PLAIN_SEG))
    for c0 in range(0, total, per_step):
        t = item_tile[c0 : c0 + per_step]
        i = starts[t][:, None] + ar_t  # (m, TILE) probe rows
        i_in = i < NP
        i = torch.clamp(i, max=NP - 1)
        j = item_j0[c0 : c0 + per_step][:, None] + ar_s  # (m, SEG) build rows
        j_in = j < item_j1[c0 : c0 + per_step][:, None]
        j = torch.clamp(j, max=NB - 1)
        eq = (p_active[i] & i_in)[:, :, None] & (b_ok[j] & j_in)[:, None, :]
        for c in range(n_cols):
            eq &= p_cols[i, c][:, :, None] == b_cols[j, c][:, None, :]
        hits.index_put_(
            (i.reshape(-1),), eq.any(2).reshape(-1).to(torch.int32), accumulate=True
        )
    return hits > 0


@functools.lru_cache(maxsize=None)
def _launchers():
    lib = kbuild.load(SOURCE)
    bucketed, blocked = lib.probe_bucketed_launch, lib.probe_blocked_launch
    tail = [ctypes.c_int64, ctypes.c_int64, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    bucketed.argtypes = [ctypes.c_void_p] * 6 + tail
    blocked.argtypes = [ctypes.c_void_p] * 4 + tail
    bucketed.restype = blocked.restype = ctypes.c_int
    return bucketed, blocked


def band_probe_cuda(p_cols, p_pk, p_ok, b_cols, b_pk, b_ok) -> torch.Tensor:
    """Launch the CUDA band-compare kernel on sorted sides (both non-empty).
    Returns ``(NP,) bool`` hits in the probe side's sorted order."""
    NP, n_cols = p_cols.shape
    NB = b_cols.shape[0]
    dev = p_cols.device
    kbuild.check_inputs("probe", ((p_cols, torch.int32), (p_pk, torch.int32),
                                  (p_ok, torch.bool), (b_cols, torch.int32),
                                  (b_pk, torch.int32), (b_ok, torch.bool)), dev)
    if b_cols.shape[1] != n_cols or NP == 0 or NB == 0:
        raise ValueError("probe kernel needs non-empty sides of equal key width")
    hits = torch.empty((NP,), dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        rc = _launchers()[0](
            p_cols.data_ptr(), p_pk.data_ptr(), p_ok.data_ptr(),
            b_cols.data_ptr(), b_pk.data_ptr(), b_ok.data_ptr(),
            NP, NB, n_cols, hits.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"probe_bucketed kernel launch failed: CUDA error {rc}")
    probe_bucketed.launches += 1
    return hits.view(torch.bool)


def probe_bucketed(
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
    """Bucketed existence probe — the executor's ``"kernel"`` backend.

    ``build_fp``/``probe_fp`` are the map-time fingerprints (run_msj passes
    the message column straight through); when absent a standalone
    fingerprint is derived from the exact rows.  On a CUDA tensor the band
    compare launches the kernel (or raises); on a CPU tensor it runs
    :func:`band_probe_plain`.
    """
    band = band_probe_cuda if probe_sig.is_cuda else band_probe_plain
    return _bucketed(band, build_sig, build_keys, build_ok, probe_sig, probe_keys,
                     probe_ok, build_fp, probe_fp)


probe_bucketed.launches = 0


def probe_bucketed_plain(
    build_sig, build_keys, build_ok, probe_sig, probe_keys, probe_ok,
    *, build_fp=None, probe_fp=None,
) -> torch.Tensor:
    """:func:`probe_bucketed` with the plain band compare on any device."""
    return _bucketed(band_probe_plain, build_sig, build_keys, build_ok, probe_sig,
                     probe_keys, probe_ok, build_fp, probe_fp)


# --------------------------------------------------------------------------
# the unbucketed all-pairs probe
# --------------------------------------------------------------------------


def allpairs_plain(p_cols, p_ok, b_cols, b_ok) -> torch.Tensor:
    """Plain torch all-pairs compare (the blocked kernel's contract):
    ``(NP,) bool``, True where a valid probe row's ``n_cols`` key words
    equal those of some valid build row.  Chunked so that one step holds
    at most ``_PLAIN_PAIRS`` (probe row, build row) pairs."""
    NP, n_cols = p_cols.shape
    hits = torch.zeros((NP,), dtype=torch.bool, device=p_cols.device)
    rows = torch.nonzero(p_ok).squeeze(1)
    builds = b_cols[b_ok]
    if rows.numel() == 0 or builds.shape[0] == 0:
        return hits
    probes = p_cols[rows]
    seg = min(builds.shape[0], _PLAIN_SEG)
    step = max(1, _PLAIN_PAIRS // seg)
    for a0 in range(0, probes.shape[0], step):
        pa = probes[a0 : a0 + step]
        found = torch.zeros((pa.shape[0],), dtype=torch.bool, device=p_cols.device)
        for b0 in range(0, builds.shape[0], seg):
            bb = builds[b0 : b0 + seg]
            eq = pa[:, None, 0] == bb[None, :, 0]
            for c in range(1, n_cols):
                eq &= pa[:, None, c] == bb[None, :, c]
            found |= eq.any(dim=1)
        hits[rows[a0 : a0 + step]] = found
    return hits


def allpairs_cuda(p_cols, p_ok, b_cols, b_ok) -> torch.Tensor:
    """Launch the CUDA all-pairs kernel (both sides non-empty).  Returns
    ``(NP,) bool`` hits, as :func:`allpairs_plain`."""
    NP, n_cols = p_cols.shape
    NB = b_cols.shape[0]
    dev = p_cols.device
    kbuild.check_inputs("blocked probe", ((p_cols, torch.int32), (p_ok, torch.bool),
                                          (b_cols, torch.int32), (b_ok, torch.bool)), dev)
    if b_cols.shape[1] != n_cols or NP == 0 or NB == 0:
        raise ValueError("blocked probe kernel needs non-empty sides of equal key width")
    hits = torch.empty((NP,), dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        rc = _launchers()[1](
            p_cols.data_ptr(), p_ok.data_ptr(), b_cols.data_ptr(), b_ok.data_ptr(),
            NP, NB, n_cols, hits.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"probe_blocked kernel launch failed: CUDA error {rc}")
    probe.launches += 1
    return hits.view(torch.bool)


def _blocked(allpairs, build_sig, build_keys, build_ok, probe_sig, probe_keys,
             probe_ok) -> torch.Tensor:
    n_p, n_b = probe_sig.shape[0], build_sig.shape[0]
    if n_p == 0 or n_b == 0:  # a grid of 0 blocks is not a valid launch
        return torch.zeros((n_p,), dtype=torch.bool, device=probe_sig.device)

    def cols(sig, keys):
        return torch.cat([sig.to(torch.int32)[:, None], keys.to(torch.int32)], 1).contiguous()

    hits = allpairs(cols(probe_sig, probe_keys), probe_ok.contiguous(),
                    cols(build_sig, build_keys), build_ok.contiguous())
    return hits & probe_ok


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
    """Existence probe: hits[i] = any valid build row with equal (sig, key).

    Unbucketed O(NP·NB) sweep; fingerprints are accepted (``probe_fn``
    interface) but unused.  On a CUDA tensor it launches the kernel (or
    raises); on a CPU tensor it runs :func:`allpairs_plain`.
    """
    del build_fp, probe_fp
    allpairs = allpairs_cuda if probe_sig.is_cuda else allpairs_plain
    return _blocked(allpairs, build_sig, build_keys, build_ok, probe_sig, probe_keys,
                    probe_ok)


probe.launches = 0


def probe_blocked_plain(
    build_sig, build_keys, build_ok, probe_sig, probe_keys, probe_ok,
    *, build_fp=None, probe_fp=None,
) -> torch.Tensor:
    """:func:`probe` with the plain all-pairs compare on any device."""
    del build_fp, probe_fp
    return _blocked(allpairs_plain, build_sig, build_keys, build_ok, probe_sig,
                    probe_keys, probe_ok)
