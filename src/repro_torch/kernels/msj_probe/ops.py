"""The MSJ probes: CUDA kernels for the card and their plain torch
versions, behind the engine's ``probe_fn`` interface.

``probe_fn`` signature: ``(build_sig, build_keys, build_ok, probe_sig,
probe_keys, probe_ok, *, build_fp=None, probe_fp=None) -> hits``, where
``hits[i]`` says that probe row i is valid and some valid build row has the
same (signature, key).

On CUDA tensors both wrappers run the same hash join, the two kernels of
``csrc/probe_hash.cu`` (which replace the reference's Pallas kernels
``probe_bucketed_blocked`` and ``probe_blocked``): :func:`hash_probe_cuda`
fills a table of :func:`table_slots` int32 slots with -1, inserts every
valid build row (:func:`table_build_cuda`) and probes it with every probe
row (:func:`table_probe_cuda`).  The slot hash is the exact row; the
fingerprints are not read on the card.  The inputs are read in place,
strides and all: no sort, no concatenation, no scatter and no read back to
the host.

* :func:`probe_bucketed` — the executor's ``"kernel"`` backend (DESIGN.md
  §6).  On CPU tensors it runs the plain band version of the reference's
  algorithm: both sides sorted by a fingerprint *prune key* (one stable
  single-column sort each), each tile of :data:`TILE` probe rows compared
  against the band of build rows whose prune keys fall in the tile's range
  (:func:`band_probe_plain`), and the hits scattered back to the probe
  side's order.
* :func:`probe_bucketed_plain` — that plain band version on any device;
  tests and ``chip_smoke.py`` hold the kernels against it.
* :func:`probe` — the unbucketed all-pairs probe, a drop-in ``probe_fn``
  for ``run_msj`` kept as the worst-case reference; fingerprints are
  ignored.  On CPU tensors it runs the chunked all-pairs compare in torch
  (:func:`probe_blocked_plain` on any device).

Every match is decided on the exact (signature, key), so fingerprint
collisions — including adversarially colliding ``*_fp`` inputs — only cost
the plain band version time (a wider band), never change the result.
``probe_bucketed.launches`` and ``probe.launches`` count the kernels each
wrapper launched (two per hash join: table build and table probe);
``table_build_cuda.launches`` and ``table_probe_cuda.launches`` count each
kernel's launches.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.engine import hashing
from repro_torch.kernels import build as kbuild

#: probe rows per band of the plain band version (a tile of the reference kernel)
TILE = 128
#: build rows per work item of the plain version's band compare
_PLAIN_SEG = 1024
#: (probe row, build row) pairs the plain version compares per step
_PLAIN_PAIRS = 1 << 24

SOURCE = Path(__file__).resolve().parent / "csrc" / "probe_hash.cu"


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


def tile_bands(p_pk: torch.Tensor, b_pk: torch.Tensor):
    """Each probe tile's band of build rows, as the plain version finds it:
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
    """Plain torch band compare over sorted sides (the reference kernel's):
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


def table_slots(nb: int) -> int:
    """Slots of the hash table for ``nb`` build rows: the next power of two
    >= 2 * nb, counting every build row, valid or not, so that sizing reads
    nothing back from the card and the load stays <= 0.5.  Raises when row
    indices would not fit the table's int32 words."""
    if nb >= 2**31:
        raise ValueError(f"hash probe: {nb} build rows do not fit int32 row indices")
    return 1 << max(0, 2 * nb - 1).bit_length()


@functools.lru_cache(maxsize=None)
def _launchers():
    lib = kbuild.load(SOURCE)
    side = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64]
    build, probe_ = lib.probe_hash_build_launch, lib.probe_hash_probe_launch
    build.argtypes = side + [ctypes.c_int64, ctypes.c_int, ctypes.c_void_p,
                             ctypes.c_int64, ctypes.c_void_p]
    probe_.argtypes = side + side + [ctypes.c_int64, ctypes.c_int, ctypes.c_void_p,
                                     ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p]
    build.restype = probe_.restype = ctypes.c_int
    return build, probe_


def check_join(build, probe_side) -> None:
    """Raise unless the hash join's sides are what its kernels assume: each
    ``(sig, keys, ok)`` int32 ``(N,)``, int32 ``(N, KW)`` with the build
    side's KW and bool ``(N,)``, any strides, all on one CUDA device."""
    dev, kw = build[0].device, build[1].shape[1]
    if not build[0].is_cuda:
        raise ValueError(f"hash probe: inputs must be on a cuda device, got {dev}")
    for what, (sig, keys, ok) in (("build", build), ("probe", probe_side)):
        n = sig.shape[0]
        kbuild.check_inputs(f"hash join {what} side", ((sig, torch.int32, (n,)),
                            (keys, torch.int32, (n, kw)), (ok, torch.bool, (n,))),
                            dev, strided=True)


def _side(sig, keys, ok) -> list:
    """ctypes arguments of one side: pointers and element strides, read in
    place."""
    return [sig.data_ptr(), sig.stride(0), keys.data_ptr(), keys.stride(0), keys.stride(1),
            ok.data_ptr(), ok.stride(0)]


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _launch(kernel, which: int, counter, dev, *args) -> None:
    """Call one ctypes entry point on the caller's stream; only when it
    reports a launch, count one for ``kernel`` and for ``counter`` (the
    wrapper that asked for it, if any)."""
    with torch.cuda.device(dev):
        rc = _launchers()[which](*args, _stream(dev))
    if rc != 0:
        raise RuntimeError(f"hash probe {kernel.__name__} launch failed: CUDA error {rc}")
    kernel.launches += 1
    if counter is not None:
        counter.launches += 1


def table_build_cuda(table, sig, keys, ok, counter=None) -> None:
    """Launch the table-build kernel: insert every valid row of one side
    (non-empty, as :func:`check_join` checks it) into ``table``, int32
    ``(table_slots(N),)`` filled with -1."""
    _launch(table_build_cuda, 0, counter, sig.device, *_side(sig, keys, ok), sig.shape[0],
            keys.shape[1], table.data_ptr(), table.numel())


def table_probe_cuda(table, build, probe_side, counter=None) -> torch.Tensor:
    """Launch the table-probe kernel over a table that
    :func:`table_build_cuda` filled from ``build``; each side is ``(sig,
    keys, ok)``, as :func:`check_join` checks them.  Returns the ``(NP,)
    bool`` hits, ANDed with the probe side's valid flags."""
    dev, np_ = probe_side[0].device, probe_side[0].shape[0]
    hits = torch.empty((np_,), dtype=torch.uint8, device=dev)
    _launch(table_probe_cuda, 1, counter, dev, *_side(*build), *_side(*probe_side), np_,
            build[1].shape[1], table.data_ptr(), table.numel(), hits.data_ptr())
    return hits.view(torch.bool)


table_build_cuda.launches = 0
table_probe_cuda.launches = 0


def hash_probe_cuda(build_sig, build_keys, build_ok, probe_sig, probe_keys, probe_ok,
                    counter=None) -> torch.Tensor:
    """The hash join on the card (both sides non-empty): a table filled
    with -1 on the caller's stream, built from the build side and probed
    by the probe side; each kernel launch counts one for ``counter``."""
    build = (build_sig, build_keys, build_ok)
    probe_side = (probe_sig, probe_keys, probe_ok)
    check_join(build, probe_side)
    table = torch.full((table_slots(build_sig.shape[0]),), -1, dtype=torch.int32,
                       device=build_sig.device)
    table_build_cuda(table, *build, counter=counter)
    return table_probe_cuda(table, build, probe_side, counter=counter)


def _on_card(wrapper, build_sig, build_keys, build_ok, probe_sig, probe_keys,
             probe_ok) -> torch.Tensor:
    """The hash join for ``wrapper``, which counts its kernels' launches."""
    if probe_sig.shape[0] == 0 or build_sig.shape[0] == 0:  # no rows, no launch
        return torch.zeros((probe_sig.shape[0],), dtype=torch.bool, device=probe_sig.device)
    return hash_probe_cuda(build_sig, build_keys, build_ok, probe_sig, probe_keys, probe_ok,
                           counter=wrapper)


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
    the message column straight through).  On a CUDA tensor it launches the
    hash join over the exact rows (or raises) and does not read them; on a
    CPU tensor it runs :func:`probe_bucketed_plain`, which buckets by them
    and derives a standalone fingerprint from the exact rows for a side
    that has none.
    """
    if probe_sig.is_cuda:
        return _on_card(probe_bucketed, build_sig, build_keys, build_ok, probe_sig,
                        probe_keys, probe_ok)
    return probe_bucketed_plain(build_sig, build_keys, build_ok, probe_sig, probe_keys,
                                probe_ok, build_fp=build_fp, probe_fp=probe_fp)


probe_bucketed.launches = 0


def probe_bucketed_plain(
    build_sig, build_keys, build_ok, probe_sig, probe_keys, probe_ok,
    *, build_fp=None, probe_fp=None,
) -> torch.Tensor:
    """The plain band version on any device: sort both sides, run
    :func:`band_probe_plain` and scatter the hits back to the probe side's
    order."""
    n_p, n_b = probe_sig.shape[0], build_sig.shape[0]
    if n_p == 0 or n_b == 0:
        return torch.zeros((n_p,), dtype=torch.bool, device=probe_sig.device)
    sides, p_order = _sides(build_sig, build_keys, build_ok, probe_sig, probe_keys,
                            probe_ok, build_fp, probe_fp)
    out = torch.zeros_like(probe_ok)
    out[p_order] = band_probe_plain(*sides)
    return out & probe_ok


# --------------------------------------------------------------------------
# the unbucketed all-pairs probe
# --------------------------------------------------------------------------


def allpairs_plain(p_cols, p_ok, b_cols, b_ok) -> torch.Tensor:
    """Plain torch all-pairs compare (the reference's blocked kernel's):
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

    Fingerprints are accepted (``probe_fn`` interface) but unused.  On a
    CUDA tensor it launches the same hash join as :func:`probe_bucketed`
    (or raises);
    on a CPU tensor it runs :func:`probe_blocked_plain`, the unbucketed
    O(NP·NB) sweep.
    """
    del build_fp, probe_fp
    if probe_sig.is_cuda:
        return _on_card(probe, build_sig, build_keys, build_ok, probe_sig, probe_keys,
                        probe_ok)
    return probe_blocked_plain(build_sig, build_keys, build_ok, probe_sig, probe_keys,
                               probe_ok)


probe.launches = 0


def probe_blocked_plain(
    build_sig, build_keys, build_ok, probe_sig, probe_keys, probe_ok,
    *, build_fp=None, probe_fp=None,
) -> torch.Tensor:
    """The plain all-pairs version on any device: :func:`allpairs_plain`
    over ``[sig, keys...]`` columns."""
    del build_fp, probe_fp
    n_p, n_b = probe_sig.shape[0], build_sig.shape[0]
    if n_p == 0 or n_b == 0:
        return torch.zeros((n_p,), dtype=torch.bool, device=probe_sig.device)

    def cols(sig, keys):
        return torch.cat([sig.to(torch.int32)[:, None], keys.to(torch.int32)], 1).contiguous()

    hits = allpairs_plain(cols(probe_sig, probe_keys), probe_ok.contiguous(),
                          cols(build_sig, build_keys), build_ok.contiguous())
    return hits & probe_ok
