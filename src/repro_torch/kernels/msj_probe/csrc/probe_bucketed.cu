// Bucketed existence probe for the MSJ reducer, hand-written for Hopper
// (sm_90a).  Replaces the Pallas TPU kernel
// src/repro/kernels/msj_probe/kernel.py:110 (probe_bucketed_blocked, body
// _bucketed_kernel).
//
// What it computes: hits[i] = probe row i is valid and some valid build row
// has equal [sig, key_0 .. key_{KW-1}] (the n_cols = KW + 1 key columns).
//
// Layout (prepared by repro_torch/kernels/msj_probe/ops.py): both sides are
// sorted by their prune key pk (the fingerprint as uint32, shifted right by
// one, as a non-negative int32); rows that are not valid carry pk = -1 and
// so sort to the front.  Key columns are row-major (N, n_cols) int32, the
// valid flags one byte per row.  The output is one byte per probe row, in
// the probe side's sorted order; the wrapper scatters it back.
//
// Design: one block per tile of TILE probe rows, one thread per row.  The
// block takes its tile's [lo, hi] prune-key range (the ends of the sorted
// tile), binary-searches the build prune keys for the band
// [lower_bound(lo), upper_bound(hi)) and walks that band in shared-memory
// chunks of under 48 KB, whatever n_cols is.  A row whose (sig, key)
// equals a probe row's has the same fingerprint, so it lies in the band:
// the result is exact whenever the fingerprint is a function of
// (sig, key), which the MSJ operator guarantees (forced collisions only
// widen the band).  Tiles of invalid probe rows and the invalid build
// prefix are never compared.  The TPU kernel's (N, 128) lane packing and
// its sweep over all tile pairs are not carried over.
//
// Bound on this card: bytes.  It reads (NP + NB) * (KW + 3) * 4 bytes
// (key columns, prune key, valid flag) and writes NP hit flags; the
// compares inside a band are a few integer operations per pair, and for
// the bands the MSJ path produces the traffic dominates at HBM bandwidth.
// The simple design leaves the band re-reads to L2; TMA staging, warp
// specialisation and one launch over all P shards are later work.
//
// The file also holds probe_blocked_kernel, the unbucketed all-pairs probe
// (ops.probe, the reference's probe_blocked), which shares the chunked
// walk over build rows (walk_build) with a band of every build row.

#include <cuda_runtime.h>
#include <stdint.h>

#define TILE 128
// int32 words of dynamic shared memory per block: under the 48 KB a block
// may use without opting in, with room for the static band[] words
#define SMEM_WORDS 12160

__device__ __forceinline__ int64_t lower_bound(const int32_t* __restrict__ a,
                                               int64_t n, int32_t v) {
  int64_t lo = 0, hi = n;
  while (lo < hi) {
    int64_t mid = (lo + hi) >> 1;
    if (a[mid] < v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__device__ __forceinline__ int64_t upper_bound(const int32_t* __restrict__ a,
                                               int64_t n, int32_t v) {
  int64_t lo = 0, hi = n;
  while (lo < hi) {
    int64_t mid = (lo + hi) >> 1;
    if (a[mid] <= v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// Walks the build rows [b0, b1) in shared-memory chunks; returns 1 if a
// valid one has the n_cols key words of prow, else 0.  Every thread of the
// block calls it (it holds block barriers); a thread whose row is not
// active only helps load.  The walk ends once every active row has a hit.
__device__ __forceinline__ int walk_build(const int32_t* __restrict__ bkeys,
                                          const uint8_t* __restrict__ bok,
                                          int64_t b0, int64_t b1, int n_cols,
                                          int chunk, bool active,
                                          const int32_t* __restrict__ prow,
                                          int32_t* smem) {
  const int32_t p0 = active ? prow[0] : 0;
  const int32_t p1 = (active && n_cols > 1) ? prow[1] : 0;

  int32_t* s_keys = smem;                          // [c * chunk + r]
  int32_t* s_ok = smem + (int64_t)chunk * n_cols;  // [r]
  int hit = 0;

  for (int64_t base = b0; base < b1; base += chunk) {
    // barrier: the previous chunk is consumed; leave once every row is done
    if (__syncthreads_and(hit || !active)) break;
    const int len = (int)((b1 - base) < chunk ? (b1 - base) : chunk);
    const int64_t words = (int64_t)len * n_cols;
    const int32_t* src = bkeys + base * n_cols;
    for (int64_t w = threadIdx.x; w < words; w += TILE) {
      const int r = (int)(w / n_cols);
      const int c = (int)(w - (int64_t)r * n_cols);
      s_keys[(int64_t)c * chunk + r] = src[w];
    }
    for (int r = threadIdx.x; r < len; r += TILE) s_ok[r] = bok[base + r];
    __syncthreads();
    if (active && !hit) {
      for (int r = 0; r < len; ++r) {
        if (s_keys[r] != p0) continue;
        if (n_cols > 1 && s_keys[chunk + r] != p1) continue;
        if (!s_ok[r]) continue;
        bool eq = true;
        for (int c = 2; c < n_cols; ++c) {
          if (s_keys[(int64_t)c * chunk + r] != prow[c]) { eq = false; break; }
        }
        if (eq) { hit = 1; break; }
      }
    }
  }
  return hit;
}

__global__ void __launch_bounds__(TILE)
probe_bucketed_kernel(const int32_t* __restrict__ pkeys,
                      const int32_t* __restrict__ ppk,
                      const uint8_t* __restrict__ pok,
                      const int32_t* __restrict__ bkeys,
                      const int32_t* __restrict__ bpk,
                      const uint8_t* __restrict__ bok,
                      int64_t np, int64_t nb, int n_cols, int chunk,
                      uint8_t* __restrict__ hits) {
  extern __shared__ int32_t smem[];  // chunk * n_cols key words, chunk ok words
  __shared__ int64_t band[2];

  const int64_t t0 = (int64_t)blockIdx.x * TILE;
  const int64_t last = (t0 + TILE < np ? t0 + TILE : np) - 1;
  const int64_t row = t0 + threadIdx.x;

  if (threadIdx.x == 0) {
    const int32_t hi = ppk[last];
    if (hi < 0) {  // the whole tile is invalid probe rows
      band[0] = 0;
      band[1] = 0;
    } else {
      const int32_t lo = ppk[t0] < 0 ? 0 : ppk[t0];
      band[0] = lower_bound(bpk, nb, lo);
      band[1] = upper_bound(bpk, nb, hi);
    }
  }
  __syncthreads();

  const bool active = row < np && pok[row] != 0 && ppk[row] >= 0;
  const int32_t* prow = pkeys + (active ? row : 0) * (int64_t)n_cols;
  const int hit = walk_build(bkeys, bok, band[0], band[1], n_cols, chunk, active,
                             prow, smem);
  if (row < np) hits[row] = (uint8_t)hit;
}

// The unbucketed all-pairs probe (replaces the Pallas TPU kernel
// src/repro/kernels/msj_probe/kernel.py:148, probe_blocked, body
// _probe_kernel): the same walk over every build row [0, nb) of unsorted
// input, with no prune keys.  O(NP * NB) compares: operations, not bytes,
// bound it at any size the MSJ path gives it.  The design keeps each
// compare to one broadcast shared-memory read and one integer compare per
// (probe row, build row) for the first key word, skips warps with no
// active row, and stops a block once all its rows have hit; loading
// several probe rows per thread to reuse each read is later work.
__global__ void __launch_bounds__(TILE)
probe_blocked_kernel(const int32_t* __restrict__ pkeys,
                     const uint8_t* __restrict__ pok,
                     const int32_t* __restrict__ bkeys,
                     const uint8_t* __restrict__ bok,
                     int64_t np, int64_t nb, int n_cols, int chunk,
                     uint8_t* __restrict__ hits) {
  extern __shared__ int32_t smem[];
  const int64_t row = (int64_t)blockIdx.x * TILE + threadIdx.x;
  const bool active = row < np && pok[row] != 0;
  const int32_t* prow = pkeys + (active ? row : 0) * (int64_t)n_cols;
  const int hit = walk_build(bkeys, bok, 0, nb, n_cols, chunk, active, prow, smem);
  if (row < np) hits[row] = (uint8_t)hit;
}

// Rows of build keys per shared-memory chunk, for n_cols key words a row.
static int chunk_rows(int n_cols) {
  const int chunk = SMEM_WORDS / (n_cols + 1);
  return chunk > 2048 ? 2048 : chunk;
}

// Plain C entry points (loaded with ctypes).  Pointers are device
// pointers; stream is the caller's cudaStream_t.  Each returns
// cudaGetLastError() after its launch (0 = launched).  The caller
// guarantees np > 0 and nb > 0.
extern "C" int probe_bucketed_launch(const void* pkeys, const void* ppk,
                                     const void* pok, const void* bkeys,
                                     const void* bpk, const void* bok,
                                     int64_t np, int64_t nb, int n_cols,
                                     void* hits, void* stream) {
  if (np <= 0 || nb <= 0 || n_cols < 1) return (int)cudaErrorInvalidValue;
  const int chunk = chunk_rows(n_cols);
  const size_t smem = (size_t)chunk * (n_cols + 1) * sizeof(int32_t);
  const int64_t grid = (np + TILE - 1) / TILE;
  probe_bucketed_kernel<<<(unsigned int)grid, TILE, smem, (cudaStream_t)stream>>>(
      (const int32_t*)pkeys, (const int32_t*)ppk, (const uint8_t*)pok,
      (const int32_t*)bkeys, (const int32_t*)bpk, (const uint8_t*)bok, np, nb,
      n_cols, chunk, (uint8_t*)hits);
  return (int)cudaGetLastError();
}

extern "C" int probe_blocked_launch(const void* pkeys, const void* pok,
                                    const void* bkeys, const void* bok,
                                    int64_t np, int64_t nb, int n_cols,
                                    void* hits, void* stream) {
  if (np <= 0 || nb <= 0 || n_cols < 1) return (int)cudaErrorInvalidValue;
  const int chunk = chunk_rows(n_cols);
  const size_t smem = (size_t)chunk * (n_cols + 1) * sizeof(int32_t);
  const int64_t grid = (np + TILE - 1) / TILE;
  probe_blocked_kernel<<<(unsigned int)grid, TILE, smem, (cudaStream_t)stream>>>(
      (const int32_t*)pkeys, (const uint8_t*)pok, (const int32_t*)bkeys,
      (const uint8_t*)bok, np, nb, n_cols, chunk, (uint8_t*)hits);
  return (int)cudaGetLastError();
}
