"""The MSJ bloom prefilter: CUDA kernels for the card and their plain torch
versions.

``run_msj(bloom_bits > 0)`` (DESIGN.md §7) builds a filter over each
shard's Assert (signature, key) rows, exchanges the shards' filters, ORs
them and drops the Req messages whose (signature, key) cannot match before
the forward exchange.

* :func:`positions` — the :data:`NPROBE` bit positions of each row,
  bit-exact with the reference; the plain versions start from them.
* :func:`build` — the ``(n_words, 128)`` int32 0/1 filter that shards
  exchange.  On a CUDA tensor one entry point of ``csrc/bloom.cu`` hashes
  each row in the kernel, sets its bits with atomics in a packed scratch
  bitset that fits L2 and expands the bitset into the filter; on a CPU
  tensor :func:`build_plain` scatters the positions.
* :func:`pack` — the received ``(S, n_words, 128)`` stack OR-ed over its
  sources into a packed bitset: ``n_words * 4`` int32 words, bit b at word
  ``b >> 5``, bit ``b & 31`` (the ``bloom_pack`` kernel, or
  :func:`pack_plain`).
* :func:`probe_packed` — ``(N,) bool``, True iff both bits of the row are
  set in a packed bitset: the kernel hashes each row and tests two bits
  (``bloom_probe_packed``), or :func:`probe_packed_plain` gathers them.
* :func:`probe` — the reference's contract, a probe of one ``(n_words,
  128)`` filter: on a CUDA tensor :func:`pack` and :func:`probe_packed`, on
  a CPU tensor :func:`probe_plain`.

``run_msj`` calls :func:`build`, :func:`pack` once per shard and
:func:`probe_packed` once per semi-join.  The kernels replace the
reference's Pallas kernels ``build_blocked`` and ``probe_blocked``; a CUDA
tensor launches them or raises.  ``build.launches``, ``pack.launches`` and
``probe_packed.launches`` count each kernel's launches (a build is one
entry point: a memset and two kernels); ``probe.launches`` counts the
launches the :func:`probe` wrapper made.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.engine import hashing
from repro_torch.kernels import build as kbuild

LANES = 128
NPROBE = 2  # hash functions per key
#: golden-ratio constant the reference multiplies each probe's salt by
_PROBE_MIX = 0x9E3779B9

SOURCE = Path(__file__).resolve().parent / "csrc" / "bloom.cu"


def n_words(bits: int) -> int:
    return max(1, (bits + LANES - 1) // LANES)


def positions(
    keys: torch.Tensor,
    sigs: torch.Tensor,
    bits: int,
    fp: torch.Tensor | None = None,
) -> torch.Tensor:
    """``(N, NPROBE)`` int32 bit positions for each (sig, key) row.

    When the map stage already computed the (sig, key) fingerprint
    (DESIGN.md §5) the positions remix that one column — one ``mix32`` per
    probe, with the signature folded back in (the exact KW == 1
    fingerprint is the bare key); otherwise they hash the ``[sig, keys]``
    rows with salt ``1000 + j``.  Build and probe must agree on ``fp``
    provenance, which ``run_msj`` guarantees.
    """
    b = n_words(bits) * LANES
    if fp is not None:
        base = hashing.u32(fp) ^ hashing.mix32(sigs)
        cols = [
            hashing.bucket_of(
                hashing.mix32(base ^ ((_PROBE_MIX * (1000 + j)) & hashing.MASK32)), b
            )
            for j in range(NPROBE)
        ]
        return torch.stack(cols, dim=1)
    rows = torch.cat([sigs.to(torch.int32)[:, None], keys.to(torch.int32)], dim=1)
    cols = [
        hashing.bucket_of(hashing.hash_cols(rows, salt=1000 + j), b)
        for j in range(NPROBE)
    ]
    return torch.stack(cols, dim=1)


# --------------------------------------------------------------------------
# the plain versions: positions in, filter, packed bitset or bool per row out
# --------------------------------------------------------------------------


def build_plain(pos: torch.Tensor, mask: torch.Tensor, nw: int) -> torch.Tensor:
    """Plain torch build: the ``(nw, 128)`` int32 0/1 filter with the bits
    of every active row set (a scatter-max into the flat filter, as the
    reference's jnp path)."""
    flat = torch.zeros((nw * LANES,), dtype=torch.int32, device=pos.device)
    upd = mask[:, None].expand(pos.shape).to(torch.int32)
    flat.scatter_reduce_(0, pos.reshape(-1).long(), upd.reshape(-1), "amax")
    return flat.view(nw, LANES)


def probe_plain(pos: torch.Tensor, filt: torch.Tensor) -> torch.Tensor:
    """Plain torch probe: ``(N,)`` bool, True iff all of the row's bits are
    set (a gather from the flat filter)."""
    return (filt.reshape(-1)[pos.long()] > 0).all(dim=1)


def pack_plain(words: torch.Tensor) -> torch.Tensor:
    """Plain torch pack: bit b is set iff some source's word b is > 0 (the
    max over the sources of a ``(S, nw, 128)`` stack, or one ``(nw, 128)``
    filter); 32 bits per int32 word, weighed in int64 and then narrowed so
    that bit 31 does not overflow."""
    on = words > 0
    if on.dim() == 3:
        on = on.any(dim=0)
    weights = 1 << torch.arange(32, dtype=torch.int64, device=words.device)
    return hashing.to_i32((on.reshape(-1, 32).to(torch.int64) * weights).sum(dim=1))


def probe_packed_plain(packed: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Plain torch probe of a packed bitset: ``(N,)`` bool, True iff all of
    the row's bits are set (a gather of their words)."""
    pos = pos.long()
    return ((hashing.u32(packed)[pos >> 5] >> (pos & 31)) & 1).bool().all(dim=1)


# --------------------------------------------------------------------------
# the kernels
# --------------------------------------------------------------------------

_ROWS = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,  # keys, strides, KW
         ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64]  # sig, fp


@functools.lru_cache(maxsize=None)
def _launchers():
    lib = kbuild.load(SOURCE)
    build_, pack_, probe_ = lib.bloom_build_launch, lib.bloom_pack_launch, lib.bloom_probe_launch
    i64, ptr = ctypes.c_int64, ctypes.c_void_p
    build_.argtypes = _ROWS + [ptr, i64, i64, ptr, ptr, ptr]
    pack_.argtypes = [ptr, i64, i64, i64, ptr, ptr]
    probe_.argtypes = _ROWS + [i64, i64, ptr, ptr, ptr]
    for fn in (build_, pack_, probe_):
        fn.restype = ctypes.c_int
    return build_, pack_, probe_


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _launch(kernel, which: int, counter, dev, *args) -> None:
    """Call one ctypes entry point on the caller's stream; only when it
    reports a launch, count one for ``kernel`` and for ``counter`` (the
    wrapper that asked for it, if any)."""
    with torch.cuda.device(dev):
        rc = _launchers()[which](*args, _stream(dev))
    if rc != 0:
        raise RuntimeError(f"bloom {kernel.__name__} kernel launch failed: CUDA error {rc}")
    kernel.launches += 1
    if counter is not None:
        counter.launches += 1


def _nbits(bits: int) -> int:
    nbits = n_words(bits) * LANES
    if nbits > 2**31:
        raise ValueError(f"bloom filter of {nbits} bits: positions must fit int32")
    return nbits


def _rows(kind, keys, sigs, fp, extra=()) -> list:
    """Check one side's columns (int32, any strides, one CUDA device) and
    return their ctypes arguments: pointers and element strides."""
    n, dev = sigs.shape[0], sigs.device
    if not sigs.is_cuda:
        raise ValueError(f"bloom {kind}: inputs must be on a cuda device, got {dev}")
    cols = [(keys, torch.int32, (n, keys.shape[1])), (sigs, torch.int32, (n,))]
    if fp is not None:
        cols.append((fp, torch.int32, (n,)))
    kbuild.check_inputs(f"bloom {kind}", cols, dev, strided=True)
    kbuild.check_inputs(f"bloom {kind}", extra, dev)
    return [keys.data_ptr(), keys.stride(0), keys.stride(1), keys.shape[1], sigs.data_ptr(),
            sigs.stride(0), None if fp is None else fp.data_ptr(),
            0 if fp is None else fp.stride(0)]


def build_cuda(keys, sigs, mask, bits, fp=None) -> torch.Tensor:
    """The build on the card: the same filter as
    ``build_plain(positions(keys, sigs, bits, fp=fp), mask, n_words(bits))``
    from one entry point — a zeroed packed bitset, the hashing build
    kernel, the expand kernel."""
    nw, nbits, n = n_words(bits), _nbits(bits), sigs.shape[0]
    args = _rows("build", keys, sigs, fp, ((mask, torch.bool, (n,)),))
    if n == 0:  # no rows, no launch
        return torch.zeros((nw, LANES), dtype=torch.int32, device=sigs.device)
    scratch = torch.empty((nbits // 32,), dtype=torch.int32, device=sigs.device)
    filt = torch.empty((nw, LANES), dtype=torch.int32, device=sigs.device)
    _launch(build, 0, None, sigs.device, *args, mask.data_ptr(), n, nbits,
            scratch.data_ptr(), filt.data_ptr())
    return filt


def pack_cuda(words, counter=None) -> torch.Tensor:
    """The pack on the card: one ``bloom_pack`` launch over a ``(S, nw,
    128)`` stack (each source's block contiguous, the sources at any
    stride) or one ``(nw, 128)`` filter."""
    dev = words.device
    stack = words if words.dim() == 3 else words[None]
    if (not words.is_cuda or stack.dim() != 3 or stack.shape[2] != LANES
            or stack.dtype != torch.int32 or stack.stride(2) != 1
            or (stack.shape[1] > 1 and stack.stride(1) != LANES)):
        raise ValueError(
            f"bloom pack kernel input must be an int32 (S, nw, {LANES}) stack or (nw, {LANES}) "
            f"filter on a cuda device, each filter contiguous; got {words.dtype} "
            f"{tuple(words.shape)} strides {words.stride()} on {dev}")
    nbits = stack.shape[1] * LANES
    if stack.shape[0] == 0:  # no sources, no launch
        return torch.zeros((nbits // 32,), dtype=torch.int32, device=dev)
    packed = torch.empty((nbits // 32,), dtype=torch.int32, device=dev)
    _launch(pack, 1, counter, dev, stack.data_ptr(), stack.shape[0], stack.stride(0), nbits,
            packed.data_ptr())
    return packed


def probe_packed_cuda(packed, keys, sigs, bits, fp=None, counter=None) -> torch.Tensor:
    """The probe on the card: one ``bloom_probe_packed`` launch, the same
    flags as ``probe_packed_plain(packed, positions(...))``."""
    nbits, n = _nbits(bits), sigs.shape[0]
    args = _rows("probe", keys, sigs, fp, ((packed, torch.int32, (nbits // 32,)),))
    found = torch.empty((n,), dtype=torch.bool, device=sigs.device)
    if n == 0:
        return found
    _launch(probe_packed, 2, counter, sigs.device, *args, n, nbits, packed.data_ptr(),
            found.data_ptr())
    return found


# --------------------------------------------------------------------------
# what run_msj calls
# --------------------------------------------------------------------------


def build(
    keys: torch.Tensor,
    sigs: torch.Tensor,
    mask: torch.Tensor,
    bits: int,
    *,
    fp: torch.Tensor | None = None,
) -> torch.Tensor:
    """Build the ``(n_words, 128)`` int32 0/1 filter over the active
    (sig, key) rows: the kernels on a CUDA tensor, the plain version on a
    CPU tensor."""
    if sigs.is_cuda:
        return build_cuda(keys, sigs, mask.contiguous(), bits, fp=fp)
    return build_plain(positions(keys, sigs, bits, fp=fp), mask, n_words(bits))


build.launches = 0


def pack(words: torch.Tensor) -> torch.Tensor:
    """The packed bitset of a ``(S, n_words, 128)`` stack of filters OR-ed
    over S, or of one ``(n_words, 128)`` filter: ``n_words * 4`` int32
    words, bit b at word ``b >> 5``, bit ``b & 31``.  The kernel on a CUDA
    tensor, the plain version on a CPU tensor."""
    return pack_cuda(words) if words.is_cuda else pack_plain(words)


pack.launches = 0


def probe_packed(
    packed: torch.Tensor,
    keys: torch.Tensor,
    sigs: torch.Tensor,
    bits: int,
    *,
    fp: torch.Tensor | None = None,
) -> torch.Tensor:
    """``(N,)`` bool — True iff all NPROBE bits of the row are set in the
    packed bitset of :func:`pack` (maybe a match; never a false negative):
    the kernel on a CUDA tensor, the plain version on a CPU tensor.  The
    columns may be views at any stride, ``sigs`` a stride-0 broadcast."""
    if sigs.is_cuda:
        return probe_packed_cuda(packed, keys, sigs, bits, fp=fp)
    return probe_packed_plain(packed, positions(keys, sigs, bits, fp=fp))


probe_packed.launches = 0


def probe(
    filt: torch.Tensor,
    keys: torch.Tensor,
    sigs: torch.Tensor,
    bits: int,
    *,
    fp: torch.Tensor | None = None,
) -> torch.Tensor:
    """``(N,)`` bool — True iff all NPROBE bits of the row are set in the
    ``(n_words, 128)`` filter: on a CUDA tensor :func:`pack` and
    :func:`probe_packed` (two launches), on a CPU tensor the plain
    version."""
    if sigs.is_cuda:
        return probe_packed_cuda(pack_cuda(filt, counter=probe), keys, sigs, bits, fp=fp,
                                 counter=probe)
    return probe_plain(positions(keys, sigs, bits, fp=fp), filt)


probe.launches = 0
