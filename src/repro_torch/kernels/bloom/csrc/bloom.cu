// Bloom filter build, pack and probe for the MSJ prefilter, hand-written for
// Hopper (sm_90a).  Replaces the Pallas TPU kernels
// src/repro/kernels/bloom/kernel.py:85 (build_blocked, body _build_kernel)
// and src/repro/kernels/bloom/kernel.py:106 (probe_blocked, body
// _probe_kernel).
//
// What they compute, over the (signature, key) rows of
// repro_torch/kernels/bloom/ops.py, each row hashed to NPROBE = 2 bit
// positions in [0, nbits) exactly as ops.positions does:
//   build:  filt[b] = 1 if some row i with mask[i] has a position b, else 0
//   pack:   bit b of the packed bitset = max over sources s of words[s][b] > 0
//   probe:  found[i] = both bits of row i are set in the packed bitset
// The exchanged filter keeps the reference's layout: one int32 holding 0/1
// per bit, (n_words, 128) row-major, so bit b is word b of the flat array.
// Shards exchange it and the tests compare it array for array with the
// reference.  The packed bitset holds bit b at word b >> 5, bit b & 31: 32
// times fewer bytes, 2 MiB at 2^24 bits, which fits the 50 MB L2.
//
// Design.  The TPU has no fast scatter or gather, so its kernels take
// precomputed positions and compare every position against every bit of a
// filter tile (a one-hot compare, O(N * bits) work).  Here each row is hashed
// in registers (mix32 and hash_cols below, the uint32 arithmetic that
// ops.positions emulates in int64) and the bits are set and tested in the
// packed bitset, O(N) work:
//   build  (bloom_build_launch): zero the packed bitset (cudaMemsetAsync),
//          bloom_build_bits (one thread per row: hash, then atomicOr each
//          bit; the return value is unused, so the atomic is a reduction
//          that the thread does not wait for), then bloom_expand (the int32
//          0/1 filter from the bitset, one 16-byte store per thread, every
//          word written).  The random atomics land in the L2-resident
//          bitset, not in the 64 MiB int32 filter.  Reading the word from
//          L2 first and skipping the atomic when the bit is set was slower
//          on the H100 (0.213 against 0.133 ms at 4 M rows, PERF.md): it
//          makes each bit a round trip.
//   pack   (bloom_pack_launch): one thread per bit, the max over the
//          sources (each source's block read coalesced, the source axis
//          by its element stride), a warp ballot makes the 32-bit word.
//   probe  (bloom_probe_launch): one thread per row: hash, test two bits of
//          the packed bitset (in L2), write one byte.
// Every column is read through an element stride, so a column view or a
// stride-0 broadcast is read in place.
//
// Bound on this card: bytes.  Build reads 9 bytes per row (a fingerprint or
// key word, the signature, the mask byte) and writes 4 bytes per bit of the
// int32 filter; pack reads S * 4 bytes per bit and writes 1/8; probe reads
// its columns once, the packed words it tests, and writes 1 byte per row.
// The hash is a few dozen integer operations per row, far below the bytes.

#include <cuda_runtime.h>
#include <stdint.h>

#define BLOCK 256
#define NPROBE 2
#define GOLDEN 0x9E3779B9u
#define SALT 1000u  // probe j hashes with salt SALT + j

// One side's (signature, key) rows, each column read through its element
// stride.  fp == nullptr: hash the [sig, keys] row; else remix fp.
struct Rows {
  const int32_t* keys;
  int64_t key_row, key_col;
  int kw;
  const int32_t* sig;
  int64_t sig_stride;
  const int32_t* fp;
  int64_t fp_stride;
};

// repro_torch/engine/hashing.py:mix32 (triple32-style finalizer)
__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

// one column of repro_torch/engine/hashing.py:hash_cols
__device__ __forceinline__ uint32_t fold(uint32_t h, uint32_t c) {
  return mix32(h ^ (c + GOLDEN + (h << 6) + (h >> 2)));
}

// ops.positions of row i: NPROBE bit positions, each taken % nbits
__device__ __forceinline__ void positions(const Rows& r, int64_t i, uint32_t nbits,
                                          uint32_t (&p)[NPROBE]) {
  const uint32_t sig = (uint32_t)r.sig[i * r.sig_stride];
  if (r.fp != nullptr) {
    const uint32_t base = (uint32_t)r.fp[i * r.fp_stride] ^ mix32(sig);
#pragma unroll
    for (int j = 0; j < NPROBE; ++j) p[j] = mix32(base ^ (GOLDEN * (SALT + j))) % nbits;
    return;
  }
  uint32_t h[NPROBE];
#pragma unroll
  for (int j = 0; j < NPROBE; ++j) h[j] = fold((SALT + j) ^ GOLDEN, sig);
  const int32_t* key = r.keys + i * r.key_row;
  for (int k = 0; k < r.kw; ++k) {
    const uint32_t c = (uint32_t)key[k * r.key_col];
#pragma unroll
    for (int j = 0; j < NPROBE; ++j) h[j] = fold(h[j], c);
  }
#pragma unroll
  for (int j = 0; j < NPROBE; ++j) p[j] = h[j] % nbits;
}

__global__ void __launch_bounds__(BLOCK)
bloom_build_bits(Rows r, const uint8_t* __restrict__ mask, int64_t n, uint32_t nbits,
                 uint32_t* __restrict__ bits) {
  const int64_t i = (int64_t)blockIdx.x * BLOCK + threadIdx.x;
  if (i >= n || !mask[i]) return;
  uint32_t p[NPROBE];
  positions(r, i, nbits, p);
#pragma unroll
  for (int j = 0; j < NPROBE; ++j) {
    uint32_t* word = bits + (p[j] >> 5);
    const uint32_t bit = 1u << (p[j] & 31);
    atomicOr(word, bit);  // result unused: a reduction (RED), no round trip
  }
}

// thread t writes filter words 4t .. 4t + 3 (nbits is a multiple of 128)
__global__ void __launch_bounds__(BLOCK)
bloom_expand(const uint32_t* __restrict__ bits, int64_t n4, int4* __restrict__ filt) {
  const int64_t t = (int64_t)blockIdx.x * BLOCK + threadIdx.x;
  if (t >= n4) return;
  const uint32_t w = __ldg(bits + (t >> 3)) >> ((t & 7) * 4);
  filt[t] = make_int4(w & 1, (w >> 1) & 1, (w >> 2) & 1, (w >> 3) & 1);
}

// thread t decides bit t; nbits is a multiple of 32, so a warp is all in or
// all out and its ballot is word t >> 5
__global__ void __launch_bounds__(BLOCK)
bloom_pack(const int32_t* __restrict__ words, int64_t n_src, int64_t src_stride,
           int64_t nbits, uint32_t* __restrict__ packed) {
  const int64_t t = (int64_t)blockIdx.x * BLOCK + threadIdx.x;
  if (t >= nbits) return;
  int32_t v = 0;
#pragma unroll 8
  for (int64_t s = 0; s < n_src; ++s) v = max(v, __ldg(words + s * src_stride + t));
  const uint32_t word = __ballot_sync(0xFFFFFFFFu, v > 0);
  if ((t & 31) == 0) packed[t >> 5] = word;
}

__global__ void __launch_bounds__(BLOCK)
bloom_probe_packed(Rows r, int64_t n, uint32_t nbits, const uint32_t* __restrict__ packed,
                   uint8_t* __restrict__ found) {
  const int64_t i = (int64_t)blockIdx.x * BLOCK + threadIdx.x;
  if (i >= n) return;
  uint32_t p[NPROBE];
  positions(r, i, nbits, p);
  uint32_t hit = 1;
#pragma unroll
  for (int j = 0; j < NPROBE; ++j) hit &= __ldg(packed + (p[j] >> 5)) >> (p[j] & 31);
  found[i] = (uint8_t)(hit & 1);
}

static unsigned int blocks(int64_t threads) {
  return (unsigned int)((threads + BLOCK - 1) / BLOCK);
}

static bool bad_bits(int64_t nbits) {
  return nbits <= 0 || nbits % 128 != 0 || nbits > ((int64_t)1 << 31);
}

// Plain C entry points (loaded with ctypes).  Pointers are device pointers
// (fp may be null: hash the key columns); stream is the caller's
// cudaStream_t.  Each returns 0 once all its work is enqueued, else the
// first CUDA error (nothing after it is enqueued).  The caller guarantees
// n > 0 rows and a bitset of nbits / 32 words.

extern "C" int bloom_build_launch(const void* keys, int64_t key_row, int64_t key_col, int kw,
                                  const void* sig, int64_t sig_stride, const void* fp,
                                  int64_t fp_stride, const void* mask, int64_t n,
                                  int64_t nbits, void* bits, void* filt, void* stream) {
  if (n <= 0 || kw < 0 || bad_bits(nbits)) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const Rows r{(const int32_t*)keys, key_row, key_col, kw, (const int32_t*)sig, sig_stride,
               (const int32_t*)fp, fp_stride};
  cudaError_t rc = cudaMemsetAsync(bits, 0, (size_t)(nbits / 8), s);
  if (rc != cudaSuccess) return (int)rc;
  bloom_build_bits<<<blocks(n), BLOCK, 0, s>>>(r, (const uint8_t*)mask, n, (uint32_t)nbits,
                                                (uint32_t*)bits);
  rc = cudaGetLastError();
  if (rc != cudaSuccess) return (int)rc;
  bloom_expand<<<blocks(nbits / 4), BLOCK, 0, s>>>((const uint32_t*)bits, nbits / 4,
                                                    (int4*)filt);
  return (int)cudaGetLastError();
}

extern "C" int bloom_pack_launch(const void* words, int64_t n_src, int64_t src_stride,
                                 int64_t nbits, void* packed, void* stream) {
  if (n_src <= 0 || bad_bits(nbits)) return (int)cudaErrorInvalidValue;
  bloom_pack<<<blocks(nbits), BLOCK, 0, (cudaStream_t)stream>>>(
      (const int32_t*)words, n_src, src_stride, nbits, (uint32_t*)packed);
  return (int)cudaGetLastError();
}

extern "C" int bloom_probe_launch(const void* keys, int64_t key_row, int64_t key_col, int kw,
                                  const void* sig, int64_t sig_stride, const void* fp,
                                  int64_t fp_stride, int64_t n, int64_t nbits,
                                  const void* packed, void* found, void* stream) {
  if (n <= 0 || kw < 0 || bad_bits(nbits)) return (int)cudaErrorInvalidValue;
  const Rows r{(const int32_t*)keys, key_row, key_col, kw, (const int32_t*)sig, sig_stride,
               (const int32_t*)fp, fp_stride};
  bloom_probe_packed<<<blocks(n), BLOCK, 0, (cudaStream_t)stream>>>(
      r, n, (uint32_t)nbits, (const uint32_t*)packed, (uint8_t*)found);
  return (int)cudaGetLastError();
}
