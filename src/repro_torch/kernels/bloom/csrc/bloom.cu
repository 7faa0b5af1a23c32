// Bloom filter build and probe for the MSJ prefilter, hand-written for
// Hopper (sm_90a).  Replaces the Pallas TPU kernels
// src/repro/kernels/bloom/kernel.py:85 (build_blocked, body _build_kernel)
// and src/repro/kernels/bloom/kernel.py:106 (probe_blocked, body
// _probe_kernel).
//
// What they compute, over the bit positions pos (N, 2) int32 row-major
// that repro_torch/kernels/bloom/ops.py:positions derives from each
// (signature, key) row:
//   build:  filt[b] = 1 if some row i with mask[i] has pos[i, j] == b
//           (j < 2), else 0
//   probe:  found[i] = filt[pos[i, 0]] > 0 && filt[pos[i, 1]] > 0
// The filter keeps the reference's layout: one int32 holding 0/1 per bit,
// (n_words, 128) row-major, so bit b is word b of the flat array.  Shards
// exchange it and the tests compare it array for array with the
// reference, so the layout stays for now; a packed bitset (32 times fewer
// bytes) changes the exchanged array and is later work.
//
// Design.  The TPU has no fast scatter or gather, so its kernels compare
// every position against every bit of a filter tile (a one-hot compare,
// O(N * bits) work) on a lane-padded (N, 128) copy of the positions.
// Here they are what they compute, a scatter and a gather over the
// (N, 2) positions as they are, O(N) work:
//   build: one thread per (row, probe).  An active row stores 1 at its bit
//          in a filter that the wrapper zeroed (torch.zeros).  Every
//          writer of a word stores the same value, so the result is
//          deterministic without atomics.
//   probe: one thread per row.  It reads its two positions with one 8-byte
//          load, gathers two filter words and writes one byte: the
//          reference wrapper's all(found[:, :2]) is fused in.
// Positions outside [0, nbits) (ops.positions never makes them) set no
// bit and are never found, so a bad input cannot write out of bounds.
//
// Bound on this card: bytes.  Build reads 9 bytes per row (two positions
// and the mask byte) and writes 4 bytes per bit of filter (the zeroing
// pass and the scattered stores, of which the first is the floor); probe
// reads 8 bytes per row plus two 4-byte filter words at random places and
// writes one byte per row.  There is no arithmetic to speak of.  The
// random filter reads and writes are served by L2 while the filter fits
// its 50 MB (up to 2^23 bits in this layout); beyond that every one is an
// HBM sector of 32 bytes for 4 useful ones, which the packed bitset would
// cut by 32.

#include <cuda_runtime.h>
#include <stdint.h>

#define BLOCK 256

__global__ void __launch_bounds__(BLOCK)
bloom_build_kernel(const int32_t* __restrict__ pos,
                   const uint8_t* __restrict__ mask, int64_t n,
                   int64_t nbits, int32_t* __restrict__ filt) {
  const int64_t t = (int64_t)blockIdx.x * BLOCK + threadIdx.x;  // 2 * row + j
  if (t >= 2 * n || !mask[t >> 1]) return;
  const int32_t b = pos[t];
  if (b >= 0 && b < nbits) filt[b] = 1;
}

__global__ void __launch_bounds__(BLOCK)
bloom_probe_kernel(const int2* __restrict__ pos,
                   const int32_t* __restrict__ filt, int64_t n,
                   int64_t nbits, uint8_t* __restrict__ found) {
  const int64_t i = (int64_t)blockIdx.x * BLOCK + threadIdx.x;
  if (i >= n) return;
  const int2 p = pos[i];
  const bool in0 = p.x >= 0 && p.x < nbits;
  const bool in1 = p.y >= 0 && p.y < nbits;
  found[i] = (uint8_t)(in0 && in1 && __ldg(filt + p.x) > 0 && __ldg(filt + p.y) > 0);
}

// Plain C entry points (loaded with ctypes).  Pointers are device pointers;
// stream is the caller's cudaStream_t.  Each returns cudaGetLastError()
// after its launch (0 = launched).  The caller guarantees n > 0, a zeroed
// filter of nbits words for build, and 8-byte aligned positions for probe.
extern "C" int bloom_build_launch(const void* pos, const void* mask, int64_t n,
                                  int64_t nbits, void* filt, void* stream) {
  if (n <= 0 || nbits <= 0) return (int)cudaErrorInvalidValue;
  const int64_t grid = (2 * n + BLOCK - 1) / BLOCK;
  bloom_build_kernel<<<(unsigned int)grid, BLOCK, 0, (cudaStream_t)stream>>>(
      (const int32_t*)pos, (const uint8_t*)mask, n, nbits, (int32_t*)filt);
  return (int)cudaGetLastError();
}

extern "C" int bloom_probe_launch(const void* pos, const void* filt, int64_t n,
                                  int64_t nbits, void* found, void* stream) {
  if (n <= 0 || nbits <= 0) return (int)cudaErrorInvalidValue;
  const int64_t grid = (n + BLOCK - 1) / BLOCK;
  bloom_probe_kernel<<<(unsigned int)grid, BLOCK, 0, (cudaStream_t)stream>>>(
      (const int2*)pos, (const int32_t*)filt, n, nbits, (uint8_t*)found);
  return (int)cudaGetLastError();
}
