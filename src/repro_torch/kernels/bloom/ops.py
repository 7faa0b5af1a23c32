"""The MSJ bloom prefilter: CUDA kernels for the card and their plain torch
versions.

``run_msj(bloom_bits > 0)`` (DESIGN.md §7) builds a filter over each
shard's Assert (signature, key) rows, ORs the shards' filters together and
drops the Req messages whose (signature, key) cannot match before the
forward exchange.

* :func:`positions` — the :data:`NPROBE` bit positions of each row,
  bit-exact with the reference.
* :func:`build` / :func:`probe` — what ``run_msj`` calls.  On CUDA tensors
  they launch the hand-written kernels of ``csrc/bloom.cu`` (which replace
  the reference's Pallas kernels ``build_blocked`` and ``probe_blocked``)
  or raise; on CPU tensors they take the plain versions
  :func:`build_plain` and :func:`probe_plain`.  ``build.launches`` and
  ``probe.launches`` count kernel launches.

The filter keeps the reference's layout, since shards exchange it and the
tests compare it array for array: ``(n_words, 128)`` int32 holding 0/1,
bit b at ``(b // 128, b % 128)`` — one int32 per bit, 32 times the bytes of
a packed bitset.
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
# the kernels' contract: positions in, filter (build) or bool per row (probe)
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


@functools.lru_cache(maxsize=None)
def _launchers():
    lib = kbuild.load(SOURCE)
    fns = lib.bloom_build_launch, lib.bloom_probe_launch
    for fn in fns:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                       ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fns


def build_cuda(pos: torch.Tensor, mask: torch.Tensor, nw: int) -> torch.Tensor:
    """Launch the CUDA build kernel: the same filter as :func:`build_plain`."""
    n, dev = pos.shape[0], pos.device
    kbuild.check_inputs("bloom build", ((pos, torch.int32, (n, NPROBE)),
                                        (mask, torch.bool, (n,))), dev)
    flat = torch.zeros((nw * LANES,), dtype=torch.int32, device=dev)
    if n == 0:  # a grid of 0 blocks is not a valid launch
        return flat.view(nw, LANES)
    with torch.cuda.device(dev):
        rc = _launchers()[0](pos.data_ptr(), mask.data_ptr(), n, flat.numel(),
                             flat.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"bloom build kernel launch failed: CUDA error {rc}")
    build.launches += 1
    return flat.view(nw, LANES)


def probe_cuda(pos: torch.Tensor, filt: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA probe kernel: the same flags as :func:`probe_plain`."""
    n, dev = pos.shape[0], pos.device
    kbuild.check_inputs("bloom probe", ((pos, torch.int32, (n, NPROBE)),
                                        (filt, torch.int32)), dev)
    if pos.data_ptr() % 8:
        raise ValueError("bloom probe kernel reads each row's positions as one 8-byte load")
    found = torch.empty((n,), dtype=torch.bool, device=dev)
    if n == 0:
        return found
    with torch.cuda.device(dev):
        rc = _launchers()[1](pos.data_ptr(), filt.data_ptr(), n, filt.numel(),
                             found.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"bloom probe kernel launch failed: CUDA error {rc}")
    probe.launches += 1
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
    (sig, key) rows: the kernel on a CUDA tensor, the plain version on a
    CPU tensor."""
    pos = positions(keys, sigs, bits, fp=fp)
    return (build_cuda if pos.is_cuda else build_plain)(pos, mask.contiguous(), n_words(bits))


build.launches = 0


def probe(
    filt: torch.Tensor,
    keys: torch.Tensor,
    sigs: torch.Tensor,
    bits: int,
    *,
    fp: torch.Tensor | None = None,
) -> torch.Tensor:
    """``(N,)`` bool — True iff all NPROBE bits of the row are set (maybe a
    match; never a false negative): the kernel on a CUDA tensor, the plain
    version on a CPU tensor."""
    pos = positions(keys, sigs, bits, fp=fp)
    return (probe_cuda if pos.is_cuda else probe_plain)(pos, filt)


probe.launches = 0
