// Bloom-filter membership on Hopper (sm_90a): XXH64 of the raw key bytes,
// the odd-h2 split and the K double-hashing probes, fused in one launch.
//
// Replaces the XLA-jitted device functions of the JAX package's Bloom path
// (no Pallas kernel there):
//   yadcc_bloom_membership  <- yadcc_tpu/ops/bloom_pipeline.py:
//                              bloom_membership_from_keys (xxh64_jax.py:
//                              xxh64_device + bloom_probe.py:probe_body)
//   yadcc_bloom_cascade     <- yadcc_tpu/parallel/mesh.py:
//                              sharded_bloom_cascade_fn, on one card
//   yadcc_bloom_probe       <- yadcc_tpu/ops/bloom_probe.py:bloom_may_contain
//   yadcc_bloom_scatter_or  <- yadcc_tpu/ops/bloom_probe.py:bloom_scatter_add
// What each computes is its plain version's result (ops/bloom_pipeline.py:
// membership_plain and cascade_plain, ops/bloom_probe.py:probe_body and
// scatter_add_plain); chip_smoke.py holds them equal on the card.
//
// What bounds it on this card: bytes.  At the production batch (1M keys of
// 80 bytes against 27,584,639 bits) one membership call must read 80 MB of
// key rows, the 3.4 MB filter once and write 1 MB of verdicts: ~25 us at
// 3.35 TB/s.  The digest is ~280 32-bit operations a key and the probes ~5
// each, ~5 us at the 67 T/s 32-bit peak.  The filter fits the 50 MB L2, so
// the probes' random word reads are L2 hits after the first touch.
//
// The design is the simple one: one thread per key, native uint64_t XXH64
// straight from the spec (the 32-byte stripe loop, the 8- and 4-byte tails,
// the byte tail) over the row's little-endian u32 words, then for i < K
// idx = (h1 + i*h2) mod num_bits in uint32 arithmetic (it wraps as the
// reference's does) and a test of that bit, stopping at the first zero bit
// (the verdict is the same).  The key length is a run-time argument, so one
// compiled kernel serves every length class.  Rows are read a word at a
// time by one thread each, so a warp's loads are strided by the row width;
// coalesced or 16-byte row loads are left for a later change.
//
// The scatter-OR runs one thread per (key, probe) and sets its bit with an
// atomicOr into the word array the wrapper copied, so the call returns the
// new words as the JAX function does.
//
// Integer traps: words and keys arrive as the int32 bit pattern of uint32
// arrays and are read as uint32_t; num_bits need not be a multiple of 32
// (27,584,639 is not); a zero-width row (length 0) is never read.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

constexpr uint64_t kP1 = 0x9E3779B185EBCA87ULL;
constexpr uint64_t kP2 = 0xC2B2AE3D27D4EB4FULL;
constexpr uint64_t kP3 = 0x165667B19E3779F9ULL;
constexpr uint64_t kP4 = 0x85EBCA77C2B2AE63ULL;
constexpr uint64_t kP5 = 0x27D4EB2F165667C5ULL;

__device__ __forceinline__ uint64_t rotl64(uint64_t x, int r) {
  return (x << r) | (x >> (64 - r));
}

__device__ __forceinline__ uint64_t xxh_round(uint64_t acc, uint64_t lane) {
  acc += lane * kP2;
  return rotl64(acc, 31) * kP1;
}

__device__ __forceinline__ uint64_t merge_round(uint64_t h, uint64_t acc) {
  h ^= xxh_round(0, acc);
  return h * kP1 + kP4;
}

__device__ __forceinline__ uint64_t lane_at(const uint32_t* row, int pos) {
  return (uint64_t)row[pos >> 2] | ((uint64_t)row[(pos >> 2) + 1] << 32);
}

// XXH64 of the first `length` bytes of `row` (little-endian u32 words).
__device__ uint64_t xxh64_row(const uint32_t* row, int length,
                              uint64_t seed) {
  int pos = 0;
  uint64_t h;
  if (length >= 32) {
    uint64_t v1 = seed + kP1 + kP2, v2 = seed + kP2, v3 = seed,
             v4 = seed - kP1;
    for (; pos + 32 <= length; pos += 32) {
      v1 = xxh_round(v1, lane_at(row, pos));
      v2 = xxh_round(v2, lane_at(row, pos + 8));
      v3 = xxh_round(v3, lane_at(row, pos + 16));
      v4 = xxh_round(v4, lane_at(row, pos + 24));
    }
    h = rotl64(v1, 1) + rotl64(v2, 7) + rotl64(v3, 12) + rotl64(v4, 18);
    h = merge_round(h, v1);
    h = merge_round(h, v2);
    h = merge_round(h, v3);
    h = merge_round(h, v4);
  } else {
    h = seed + kP5;
  }
  h += (uint64_t)length;
  for (; pos + 8 <= length; pos += 8) {
    h ^= xxh_round(0, lane_at(row, pos));
    h = rotl64(h, 27) * kP1 + kP4;
  }
  if (pos + 4 <= length) {
    h ^= (uint64_t)row[pos >> 2] * kP1;
    h = rotl64(h, 23) * kP2 + kP3;
    pos += 4;
  }
  for (; pos < length; ++pos) {
    const uint64_t byte = (row[pos >> 2] >> (8 * (pos & 3))) & 0xFFu;
    h ^= byte * kP5;
    h = rotl64(h, 11) * kP1;
  }
  h ^= h >> 33;
  h *= kP2;
  h ^= h >> 29;
  h *= kP3;
  h ^= h >> 32;
  return h;
}

// All K probe bits of (h1, h2) set?  uint32 wrap-around, then mod num_bits
// (common/bloom.py:probe_indices).
__device__ __forceinline__ bool probe(const uint32_t* __restrict__ words,
                                      uint32_t num_bits, int num_hashes,
                                      uint32_t h1, uint32_t h2) {
  for (int i = 0; i < num_hashes; ++i) {
    const uint32_t idx = (h1 + (uint32_t)i * h2) % num_bits;
    if (!((words[idx >> 5] >> (idx & 31)) & 1u)) return false;
  }
  return true;
}

__device__ __forceinline__ bool member(const uint32_t* __restrict__ words,
                                       uint32_t num_bits, int num_hashes,
                                       uint64_t seed, const uint32_t* row,
                                       int length) {
  const uint64_t d = xxh64_row(row, length, seed);
  return probe(words, num_bits, num_hashes, (uint32_t)d,
               (uint32_t)(d >> 32) | 1u);
}

__global__ void __launch_bounds__(kThreads)
membership_kernel(const uint32_t* __restrict__ words, uint32_t num_bits,
                  int num_hashes, uint64_t seed,
                  const uint32_t* __restrict__ packed, int row_words,
                  int length, int n, bool* __restrict__ out) {
  const int k = blockIdx.x * kThreads + threadIdx.x;
  if (k >= n) return;
  out[k] = member(words, num_bits, num_hashes, seed,
                  packed + (size_t)k * row_words, length);
}

__global__ void __launch_bounds__(kThreads)
cascade_kernel(const uint32_t* __restrict__ region, int region_hashes,
               uint64_t region_seed, const uint32_t* __restrict__ fleet,
               int fleet_hashes, uint64_t fleet_seed, uint32_t num_bits,
               const uint32_t* __restrict__ packed, int row_words,
               int length, int n, bool* __restrict__ out) {
  const int k = blockIdx.x * kThreads + threadIdx.x;
  if (k >= n) return;
  const uint32_t* row = packed + (size_t)k * row_words;
  // The region's AND over its probes completes before the OR; a key the
  // region admits needs no fleet digest.
  out[k] = member(region, num_bits, region_hashes, region_seed, row,
                  length) ||
           member(fleet, num_bits, fleet_hashes, fleet_seed, row, length);
}

__global__ void __launch_bounds__(kThreads)
probe_kernel(const uint32_t* __restrict__ words, uint32_t num_bits,
             int num_hashes, const uint32_t* __restrict__ fps, int n,
             bool* __restrict__ out) {
  const int k = blockIdx.x * kThreads + threadIdx.x;
  if (k >= n) return;
  out[k] = probe(words, num_bits, num_hashes, fps[2 * k], fps[2 * k + 1]);
}

__global__ void __launch_bounds__(kThreads)
scatter_or_kernel(uint32_t* __restrict__ words, uint32_t num_bits,
                  int num_hashes, const uint32_t* __restrict__ fps,
                  long long total) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= total) return;
  const long long k = t / num_hashes;
  const uint32_t i = (uint32_t)(t - k * num_hashes);
  const uint32_t idx = (fps[2 * k] + i * fps[2 * k + 1]) % num_bits;
  atomicOr(&words[idx >> 5], 1u << (idx & 31));
}

int blocks_for(long long threads) {
  return (int)((threads + kThreads - 1) / kThreads);
}

}  // namespace

// Every entry point launches on `stream`, does not synchronise, and returns
// the launch's CUDA error (0 when it was accepted).  The wrappers check
// shapes, types and the words' length (>= ceil(num_bits / 32)) and never
// call with n == 0.
extern "C" int yadcc_bloom_membership(const void* words,
                                      unsigned int num_bits, int num_hashes,
                                      unsigned long long seed,
                                      const void* packed, int row_words,
                                      int length, int n, void* out,
                                      void* stream) {
  membership_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)words, num_bits, num_hashes, seed,
      (const uint32_t*)packed, row_words, length, n, (bool*)out);
  return (int)cudaGetLastError();
}

extern "C" int yadcc_bloom_cascade(const void* region_words,
                                   int region_hashes,
                                   unsigned long long region_seed,
                                   const void* fleet_words, int fleet_hashes,
                                   unsigned long long fleet_seed,
                                   unsigned int num_bits, const void* packed,
                                   int row_words, int length, int n,
                                   void* out, void* stream) {
  cascade_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)region_words, region_hashes, region_seed,
      (const uint32_t*)fleet_words, fleet_hashes, fleet_seed, num_bits,
      (const uint32_t*)packed, row_words, length, n, (bool*)out);
  return (int)cudaGetLastError();
}

extern "C" int yadcc_bloom_probe(const void* words, unsigned int num_bits,
                                 int num_hashes, const void* fingerprints,
                                 int n, void* out, void* stream) {
  probe_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)words, num_bits, num_hashes,
      (const uint32_t*)fingerprints, n, (bool*)out);
  return (int)cudaGetLastError();
}

extern "C" int yadcc_bloom_scatter_or(void* words, unsigned int num_bits,
                                      int num_hashes,
                                      const void* fingerprints, int n,
                                      void* stream) {
  const long long total = (long long)n * num_hashes;
  scatter_or_kernel<<<blocks_for(total), kThreads, 0,
                      (cudaStream_t)stream>>>(
      (uint32_t*)words, num_bits, num_hashes,
      (const uint32_t*)fingerprints, total);
  return (int)cudaGetLastError();
}
