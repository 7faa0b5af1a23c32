// Existence probe for the MSJ reducer as a hash join, hand-written for
// Hopper (sm_90a).  It replaces both Pallas TPU kernels of
// src/repro/kernels/msj_probe/kernel.py:
//   :110 probe_bucketed_blocked (body _bucketed_kernel; ops.probe_bucketed)
//   :148 probe_blocked          (body _probe_kernel;    ops.probe)
//
// What it computes: hits[i] = probe row i is valid and some valid build row
// has equal [sig, key_0 .. key_{KW-1}].  Both TPU kernels compute this one
// function, by sweeping tile pairs (all of them, or those whose sorted
// fingerprint ranges overlap).  On this card it is a hash-join probe:
//
//   table build  one thread per build row; a row that is not valid is
//                skipped.  Linear probing from slot h = hash & mask: a
//                plain L2 read of the slot, and atomicCAS(&table[h], -1,
//                row) only where it reads empty.  On an occupied slot the
//                thread compares the stored row's key words with its own,
//                read from the input arrays (immutable, so there is no race
//                on key publication); if they are equal it stops, so each
//                distinct row is stored once.  Equal rows walk the same
//                slots and a claimed slot never changes, so the first claim
//                wins and the others find it.
//   table probe  one thread per probe row; a row that is not valid writes 0.
//                It walks from its slot until an empty slot (miss) or a slot
//                whose row has its key words (hit), and writes the hit byte
//                already ANDed with its valid flag.
//
// Both wrappers run the same two kernels.  The slot hash is murmur3 over
// [sig, keys...] as uint32 words; it is exact, because a hit is always
// decided by comparing every key word as int32.  Map-time fingerprints are
// not read: in run_msj they are the bare key, without the signature, so
// hashing them would put the rows of every semi-join that shares a key into
// one probe chain.
//
// Inputs are read as they are: each side is sig (N,), keys (N, KW) and
// ok (N,), each with its own element strides, so the wrapper neither
// copies, concatenates nor sorts; in run_msj both sides are views of one
// received buffer and nothing is copied.  The table is int32 row indices,
// -1 for empty, with a power of two >= 2 * NB slots (all build rows, valid
// or not: no host read of a count), so its load is <= 0.5 and a probe
// always reaches an empty slot.  The wrapper allocates and fills it on the
// caller's stream.
//
// Bound on this card: bytes.  The function reads each input once and writes
// one byte per probe row; the design adds a few random 32-byte sectors per
// valid row (the slot, and the stored row's sig and key words for each
// occupied slot it passes).  At 2^25 slots (128 MiB) the table is larger
// than the 50 MB L2, so those sectors come from DRAM; at 2^20 rows it is
// 4 MiB and stays in L2.
//
// Worst case: rows whose hashes share a slot (only inputs built against
// the hash do that) form one cluster, so inserts and probes walk
// O(distinct rows) slots each: still exact, O(distinct^2) steps, as an
// all-equal prune key was the band kernel's worst case.  Duplicate rows
// cost nothing extra: they stop at their stored copy.  Wide keys (KW = 126)
// compare up to 127 words per candidate, read from global memory (L2).

#include <cuda_runtime.h>
#include <stdint.h>

#define THREADS 256
#define HASH_SEED 0x9747b28cu

// One side of the probe, with element strides.
struct Rows {
  const int32_t* sig;
  const int32_t* keys;
  const uint8_t* ok;
  int64_t s_sig, s_row, s_col, s_ok;
};

__device__ __forceinline__ uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85ebca6bu;
  h ^= h >> 13;
  h *= 0xc2b2ae35u;
  h ^= h >> 16;
  return h;
}

__device__ __forceinline__ uint32_t mix_in(uint32_t h, uint32_t k) {
  k *= 0xcc9e2d51u;
  k = (k << 15) | (k >> 17);
  k *= 0x1b873593u;
  h ^= k;
  h = (h << 13) | (h >> 19);
  return h * 5u + 0xe6546b64u;
}

__device__ __forceinline__ uint32_t row_hash(const Rows& r, int64_t i, int kw) {
  uint32_t h = mix_in(HASH_SEED, (uint32_t)r.sig[i * r.s_sig]);
  const int32_t* k = r.keys + i * r.s_row;
  for (int c = 0; c < kw; ++c) h = mix_in(h, (uint32_t)k[c * r.s_col]);
  return fmix32(h ^ (uint32_t)(kw + 1));
}

__device__ __forceinline__ bool same_row(const Rows& a, int64_t i, const Rows& b,
                                         int64_t j, int kw) {
  if (a.sig[i * a.s_sig] != b.sig[j * b.s_sig]) return false;
  const int32_t* ka = a.keys + i * a.s_row;
  const int32_t* kb = b.keys + j * b.s_row;
  for (int c = 0; c < kw; ++c) {
    if (ka[c * a.s_col] != kb[c * b.s_col]) return false;
  }
  return true;
}

__global__ void __launch_bounds__(THREADS)
table_build_kernel(Rows b, int64_t nb, int kw, int32_t* __restrict__ table,
                   uint32_t mask) {
  const int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (i >= nb || !b.ok[i * b.s_ok]) return;
  uint32_t h = row_hash(b, i, kw) & mask;
  while (true) {
    // a claimed slot never changes, so a plain read from L2 that finds one
    // is final; only a slot read as empty takes the atomic.  Duplicate rows
    // so read their stored copy instead of serialising on its slot.
    int32_t cur = __ldcg(table + h);
    if (cur < 0) cur = atomicCAS(table + h, -1, (int32_t)i);
    if (cur < 0 || same_row(b, cur, b, i, kw)) return;
    h = (h + 1) & mask;
  }
}

__global__ void __launch_bounds__(THREADS)
table_probe_kernel(Rows b, Rows p, int64_t np, int kw,
                   const int32_t* __restrict__ table, uint32_t mask,
                   uint8_t* __restrict__ hits) {
  const int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (i >= np) return;
  uint8_t hit = 0;
  if (p.ok[i * p.s_ok]) {
    uint32_t h = row_hash(p, i, kw) & mask;
    while (true) {
      const int32_t cur = table[h];
      if (cur < 0) break;
      if (same_row(b, cur, p, i, kw)) { hit = 1; break; }
      h = (h + 1) & mask;
    }
  }
  hits[i] = hit;
}

static Rows rows_of(const void* sig, int64_t s_sig, const void* keys, int64_t s_row,
                    int64_t s_col, const void* ok, int64_t s_ok) {
  Rows r;
  r.sig = (const int32_t*)sig;
  r.keys = (const int32_t*)keys;
  r.ok = (const uint8_t*)ok;
  r.s_sig = s_sig;
  r.s_row = s_row;
  r.s_col = s_col;
  r.s_ok = s_ok;
  return r;
}

#define SIDE_PARAMS(x)                                                      \
  const void *x##_sig, int64_t x##_s_sig, const void *x##_keys,             \
      int64_t x##_s_row, int64_t x##_s_col, const void *x##_ok,             \
      int64_t x##_s_ok
#define SIDE_ARGS(x)                                                        \
  x##_sig, x##_s_sig, x##_keys, x##_s_row, x##_s_col, x##_ok, x##_s_ok

static bool bad_table(int64_t slots) {
  // a power of two that a uint32 mask covers
  return slots < 1 || slots > (int64_t(1) << 32) || (slots & (slots - 1)) != 0;
}

// Plain C entry points (loaded with ctypes).  Pointers are device pointers,
// strides are in elements; stream is the caller's cudaStream_t.  Each
// returns cudaGetLastError() after its launch (0 = launched).  The caller
// guarantees n > 0 and a table of `slots` int32 words filled with -1
// (build: slots >= 2 * nb, nb < 2^31) or built from the same build side
// (probe).
extern "C" int probe_hash_build_launch(SIDE_PARAMS(b), int64_t nb, int kw,
                                       void* table, int64_t slots, void* stream) {
  if (nb <= 0 || nb >= (int64_t(1) << 31) || kw < 0 || bad_table(slots) ||
      slots < 2 * nb)
    return (int)cudaErrorInvalidValue;
  const Rows b = rows_of(SIDE_ARGS(b));
  const int64_t grid = (nb + THREADS - 1) / THREADS;
  table_build_kernel<<<(unsigned int)grid, THREADS, 0, (cudaStream_t)stream>>>(
      b, nb, kw, (int32_t*)table, (uint32_t)(slots - 1));
  return (int)cudaGetLastError();
}

extern "C" int probe_hash_probe_launch(SIDE_PARAMS(b), SIDE_PARAMS(p), int64_t np,
                                       int kw, const void* table, int64_t slots,
                                       void* hits, void* stream) {
  if (np <= 0 || kw < 0 || bad_table(slots)) return (int)cudaErrorInvalidValue;
  const Rows b = rows_of(SIDE_ARGS(b));
  const Rows p = rows_of(SIDE_ARGS(p));
  const int64_t grid = (np + THREADS - 1) / THREADS;
  table_probe_kernel<<<(unsigned int)grid, THREADS, 0, (cudaStream_t)stream>>>(
      b, p, np, kw, (const int32_t*)table, (uint32_t)(slots - 1), (uint8_t*)hits);
  return (int)cudaGetLastError();
}
