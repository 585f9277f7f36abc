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
// What bounds it on this card.  Counted as chip_smoke.py counts it, bytes:
// at the production batch (1M keys of 80 bytes against 27,584,639 bits and
// 10 hashes) one membership call must read 80 MB of key rows, the 3.4 MB
// filter once and write 1 MB of verdicts, ~25 us at 3.35 TB/s; the digest
// is ~250 32-bit operations a key.  What that bound does not see is that
// every probe moves one 32-byte L2 sector to the SM for the one bit it
// tests: 1.44 probes for an absent key, 10 for a member, 5.72 a key at the
// production batch (183 MB).  Those sectors, not the rows, set the time
// once the rows are staged: with every probe confined to an L1-resident
// corner of the filter the kernel runs at ~0.031 ms at 1% and at 50% hits;
// with the real probes, 0.037 and 0.062 (chip_bloom_probe.py, PERF.md).
//
// The first version of these kernels (one thread a key, its row read
// straight from global memory with a warp's loads strided by the row, the
// filter at the rows' L2 priority, a `% num_bits` of ~20 instructions a
// probe, the cascade reading each row twice and diverging inside warps)
// measured 0.072 ms at 50% hits and 0.098 ms for the cascade.
//
// This design, for the membership and cascade kernels:
// * Rows whose width is a multiple of 16 bytes from 32 to 128 (an 80-byte
//   key's row among them) are staged.  A block owns a tile of kTile
//   consecutive keys, whose rows are contiguous in `packed`; it copies the
//   tile into shared memory with 16-byte cp.async (4-byte copies when
//   `packed` is not 16-byte aligned, e.g. a view one word in), evict-first
//   in L2, and each thread reads its row from there with 16-byte loads (an
//   80-byte row is 5 16-byte chunks, odd, so a quarter-warp's loads fall
//   in 8 distinct bank groups).  One block a tile: a block's copy runs
//   under the other resident blocks' digests.  A persistent grid walking
//   the tiles with two buffers measured slower (its per-tile barriers
//   hold every warp to the block's slowest probe chain; PERF.md).
// * Other rows (shorter than an XXH64 stripe: too little work a block to
//   hide the copy; wider than the buffer; or 8 bytes past a multiple of
//   16) are read from global memory in the same kernel, 4-byte loads
//   through L1, where a warp's lanes share their neighbours' lines,
//   evict-first in L2, at up to 32 registers so a full SM of threads fits.
// * The filter is held in L2: its words are loaded evict-last
//   (createpolicy + ld.global.nc.L2::cache_hint); without the hints the
//   kernel is ~1.3x slower at 50% hits.
// * Probes are chained, stopping at the first zero bit: they are bound by
//   the L2's sector rate, not by latency, and issuing a group of loads
//   together fetches sectors an absent key never needed (groups of 2, 4
//   and 8 measured no faster, most of them slower; chip_bloom_probe.py).
//   idx = (h1 + i*h2) mod num_bits in uint32 arithmetic (it wraps as the
//   reference's does), the mod by Lemire's multiply-shift remainder with a
//   64-bit constant the launcher computes (exact for every uint32).
// * The cascade digests each row once with the region's seed; the keys the
//   region rejects are compacted into a shared list, and the block runs
//   the fleet digest over that list alone, from the same copy of the rows.
//
// The probe and scatter-OR kernels keep the first version: one thread per
// key (per key and probe for the scatter), the chained `probe` below, and
// an atomicOr into the word array the wrapper copied, so the call returns
// the new words as the JAX function does.
//
// Integer traps: words and keys arrive as the int32 bit pattern of uint32
// arrays and are read as uint32_t; num_bits need not be a multiple of 32
// (27,584,639 is not); a zero-width row (length 0) is never read.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = kThreads;             // keys a block stages
constexpr int kMaxStagedRowBytes = 128;     // a tile of them is 32 KB
// Rows evict-first and filter words evict-last in L2; both evict-normal
// when false (chip_bloom_probe.py times that build).
constexpr bool kL2Hints = true;

constexpr uint64_t kP1 = 0x9E3779B185EBCA87ULL;
constexpr uint64_t kP2 = 0xC2B2AE3D27D4EB4FULL;
constexpr uint64_t kP3 = 0x165667B19E3779F9ULL;
constexpr uint64_t kP4 = 0x85EBCA77C2B2AE63ULL;
constexpr uint64_t kP5 = 0x27D4EB2F165667C5ULL;

// ---------------------------------------------------------------------------
// Cache policies, loads and asynchronous copies.

__device__ __forceinline__ uint64_t policy_evict_last() {
  uint64_t p;
  if (kL2Hints)
    asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;"
                 : "=l"(p));
  else
    asm volatile("createpolicy.fractional.L2::evict_normal.b64 %0, 1.0;"
                 : "=l"(p));
  return p;
}

__device__ __forceinline__ uint64_t policy_evict_first() {
  uint64_t p;
  if (kL2Hints)
    asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;"
                 : "=l"(p));
  else
    asm volatile("createpolicy.fractional.L2::evict_normal.b64 %0, 1.0;"
                 : "=l"(p));
  return p;
}

// A read-only 4-byte load through L1, with an L2 cache policy.
__device__ __forceinline__ uint32_t load_word(const uint32_t* p,
                                              uint64_t policy) {
  uint32_t v;
  asm("ld.global.nc.L2::cache_hint.u32 %0, [%1], %2;"
      : "=r"(v)
      : "l"(p), "l"(policy));
  return v;
}

__device__ __forceinline__ void copy16(uint32_t* dst, const uint32_t* src,
                                       uint64_t policy) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, %2;"
               ::"r"(s), "l"(src), "l"(policy)
               : "memory");
}

__device__ __forceinline__ void copy4(uint32_t* dst, const uint32_t* src,
                                      uint64_t policy) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global.L2::cache_hint [%0], [%1], 4, %2;"
               ::"r"(s), "l"(src), "l"(policy)
               : "memory");
}

__device__ __forceinline__ void copies_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// ---------------------------------------------------------------------------
// XXH64 over a key row, read through one of two row readers.

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

__device__ __forceinline__ uint64_t join(uint32_t lo, uint32_t hi) {
  return (uint64_t)lo | ((uint64_t)hi << 32);
}

// A row staged in shared memory at a 16-byte aligned address, its width a
// multiple of 16 bytes: 16-byte loads for the stripes.
struct SharedRow16 {
  const uint32_t* p;
  __device__ uint32_t word(int pos) const { return p[pos >> 2]; }
  __device__ uint64_t lane(int pos) const {
    const uint2 v = *reinterpret_cast<const uint2*>(p + (pos >> 2));
    return join(v.x, v.y);
  }
  __device__ void stripe(int pos, uint64_t (&l)[4]) const {
    const uint4 a = *reinterpret_cast<const uint4*>(p + (pos >> 2));
    const uint4 b = *reinterpret_cast<const uint4*>(p + (pos >> 2) + 4);
    l[0] = join(a.x, a.y);
    l[1] = join(a.z, a.w);
    l[2] = join(b.x, b.y);
    l[3] = join(b.z, b.w);
  }
};

// A row read from global memory (the base may be only 4-byte aligned):
// 4-byte loads through L1, where a warp's lanes share the lines of their
// neighbouring rows, evict-first in L2.
struct GlobalRow {
  const uint32_t* p;
  uint64_t policy;
  __device__ uint32_t word(int pos) const {
    return load_word(p + (pos >> 2), policy);
  }
  __device__ uint64_t lane(int pos) const {
    return join(word(pos), word(pos + 4));
  }
  __device__ void stripe(int pos, uint64_t (&l)[4]) const {
    for (int i = 0; i < 4; ++i) l[i] = lane(pos + 8 * i);
  }
};

// XXH64 of the first `length` bytes of `row` (little-endian u32 words).
template <class Row>
__device__ uint64_t xxh64_row(const Row& row, int length, uint64_t seed) {
  int pos = 0;
  uint64_t h;
  if (length >= 32) {
    uint64_t v1 = seed + kP1 + kP2, v2 = seed + kP2, v3 = seed,
             v4 = seed - kP1;
    for (; pos + 32 <= length; pos += 32) {
      uint64_t l[4];
      row.stripe(pos, l);
      v1 = xxh_round(v1, l[0]);
      v2 = xxh_round(v2, l[1]);
      v3 = xxh_round(v3, l[2]);
      v4 = xxh_round(v4, l[3]);
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
    h ^= xxh_round(0, row.lane(pos));
    h = rotl64(h, 27) * kP1 + kP4;
  }
  if (pos + 4 <= length) {
    h ^= (uint64_t)row.word(pos) * kP1;
    h = rotl64(h, 23) * kP2 + kP3;
    pos += 4;
  }
  if (pos < length) {
    const uint32_t w = row.word(pos);
    for (; pos < length; ++pos) {
      const uint64_t byte = (w >> (8 * (pos & 3))) & 0xFFu;
      h ^= byte * kP5;
      h = rotl64(h, 11) * kP1;
    }
  }
  h ^= h >> 33;
  h *= kP2;
  h ^= h >> 29;
  h *= kP3;
  h ^= h >> 32;
  return h;
}

// ---------------------------------------------------------------------------
// Probes.

// All K probe bits of (h1, h2) set?  uint32 wrap-around, then mod num_bits
// (common/bloom.py:probe_indices).  One dependent load a probe: the probe
// kernel's design.
__device__ __forceinline__ bool probe(const uint32_t* __restrict__ words,
                                      uint32_t num_bits, int num_hashes,
                                      uint32_t h1, uint32_t h2) {
  for (int i = 0; i < num_hashes; ++i) {
    const uint32_t idx = (h1 + (uint32_t)i * h2) % num_bits;
    if (!((words[idx >> 5] >> (idx & 31)) & 1u)) return false;
  }
  return true;
}

// One filter as the membership and cascade kernels see it.  `magic` is
// floor((2^64 - 1) / num_bits) + 1 (0 for num_bits = 1), for mod_bits.
struct Filter {
  const uint32_t* words;
  uint32_t num_bits;
  int num_hashes;
  uint64_t magic;
  uint64_t seed;
};

// x mod d for every uint32 x and 1 <= d < 2^32 (Lemire, Kaser and Kurz,
// "Faster remainder by direct computation", 2019): the high 64 bits of
// ((magic * x) mod 2^64) * d.
__device__ __forceinline__ uint32_t mod_bits(uint32_t x, uint64_t magic,
                                             uint32_t d) {
  const uint64_t low = magic * x;
  const uint64_t hi = (uint64_t)(uint32_t)(low >> 32) * d +
                      __umulhi((uint32_t)low, d);
  return (uint32_t)(hi >> 32);
}

// All K probe bits of the key with digest `d` set?  Chained: each probe
// waits on the one before and the walk stops at the first zero bit.
__device__ __forceinline__ bool probe_chained(const Filter& f, uint64_t d,
                                             uint64_t keep) {
  const uint32_t h2 = (uint32_t)(d >> 32) | 1u;
  uint32_t x = (uint32_t)d;  // h1 + i * h2, wrapping
  for (int i = 0; i < f.num_hashes; ++i, x += h2) {
    const uint32_t idx = mod_bits(x, f.magic, f.num_bits);
    if (!((load_word(f.words + (idx >> 5), keep) >> (idx & 31u)) & 1u))
      return false;
  }
  return true;
}

template <class Row>
__device__ __forceinline__ bool member(const Filter& f, const Row& row,
                                       int length, uint64_t keep) {
  return probe_chained(f, xxh64_row(row, length, f.seed), keep);
}

// ---------------------------------------------------------------------------
// The tile.  Block b owns keys [b * kTile, b * kTile + kTile); kStaged says
// whether their rows are staged in shared memory or read from `packed`.

// Row t of the tile starting at key `first`: in the staged copy `rows`,
// or in `packed`, read with the `stream` policy.
template <bool kStaged>
__device__ __forceinline__
    typename std::conditional<kStaged, SharedRow16, GlobalRow>::type
    row_of(const uint32_t* rows, const uint32_t* packed, int row_words,
           int first, int t, uint64_t stream) {
  if constexpr (kStaged)
    return {rows + t * row_words};
  else
    return {packed + ((size_t)first + t) * row_words, stream};
}

// Copy this block's tile of rows into `dst` and wait for it, the block
// included.
__device__ __forceinline__ void stage_tile(const uint32_t* packed,
                                           int row_words, int n,
                                           uint32_t* dst, uint64_t stream) {
  const int first = blockIdx.x * kTile;
  const int words = min(kTile, n - first) * row_words;
  const uint32_t* src = packed + (size_t)first * row_words;
  int w = threadIdx.x;
  // A tile starts a multiple of 16 bytes past `packed` (kTile rows of a
  // multiple of 8 bytes), so either every tile's source is 16-byte aligned
  // or none is.
  if ((reinterpret_cast<uintptr_t>(packed) & 15u) == 0) {
    const int chunks = words >> 2;
    for (int c = threadIdx.x; c < chunks; c += kThreads)
      copy16(dst + 4 * c, src + 4 * c, stream);
    w += 4 * chunks;
  }
  for (; w < words; w += kThreads) copy4(dst + w, src + w, stream);
  copies_wait_all();
  __syncthreads();
}

// __launch_bounds__'s second argument: 8 blocks an SM (at most 32
// registers) for rows read from global memory, none asked for staged ones.
template <bool kStaged>
__global__ void __launch_bounds__(kThreads, kStaged ? 1 : 8)
membership_kernel(Filter f, const uint32_t* __restrict__ packed,
                  int row_words, int length, int n, bool* __restrict__ out) {
  extern __shared__ __align__(16) uint32_t stage[];
  const uint64_t keep = policy_evict_last(), stream = policy_evict_first();
  const int first = blockIdx.x * kTile, t = threadIdx.x;
  if constexpr (kStaged) stage_tile(packed, row_words, n, stage, stream);
  if (first + t < n) {
    const auto row = row_of<kStaged>(stage, packed, row_words, first, t,
                                     stream);
    out[first + t] = member(f, row, length, keep);
  }
}

template <bool kStaged>
__global__ void __launch_bounds__(kThreads, kStaged ? 1 : 8)
cascade_kernel(Filter region, Filter fleet,
               const uint32_t* __restrict__ packed, int row_words,
               int length, int n, bool* __restrict__ out) {
  extern __shared__ __align__(16) uint32_t stage[];
  __shared__ uint16_t rejected[kTile];
  __shared__ int n_rejected;
  const uint64_t keep = policy_evict_last(), stream = policy_evict_first();
  const int first = blockIdx.x * kTile, t = threadIdx.x;
  if (t == 0) n_rejected = 0;
  if constexpr (kStaged)
    stage_tile(packed, row_words, n, stage, stream);
  else
    __syncthreads();
  // The region's AND over its probes completes before the OR; a key the
  // region admits needs no fleet digest.
  if (first + t < n) {
    if (member(region,
               row_of<kStaged>(stage, packed, row_words, first, t, stream),
               length, keep))
      out[first + t] = true;
    else
      rejected[atomicAdd(&n_rejected, 1)] = (uint16_t)t;
  }
  __syncthreads();
  if (t < n_rejected) {
    const int r = rejected[t];
    out[first + r] = member(
        fleet, row_of<kStaged>(stage, packed, row_words, first, r, stream),
        length, keep);
  }
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

Filter filter(const void* words, unsigned int num_bits, int num_hashes,
              unsigned long long seed) {
  return {(const uint32_t*)words, num_bits, num_hashes,
          ~0ULL / num_bits + 1, seed};
}

// Rows staged in shared memory: a multiple of 16 bytes, at least one XXH64
// stripe and at most kMaxStagedRowBytes.
bool staged(int row_words) {
  const int row_bytes = row_words * 4;
  return row_bytes % 16 == 0 && row_bytes >= 32 &&
         row_bytes <= kMaxStagedRowBytes;
}

int tiles_for(int n) { return (n + kTile - 1) / kTile; }

template <bool kStaged>
int launch_membership(const Filter& f, const void* packed, int row_words,
                      int length, int n, void* out, cudaStream_t stream) {
  const size_t smem = kStaged ? (size_t)kTile * row_words * 4 : 0;
  membership_kernel<kStaged><<<tiles_for(n), kThreads, smem, stream>>>(
      f, (const uint32_t*)packed, row_words, length, n, (bool*)out);
  return (int)cudaGetLastError();
}

template <bool kStaged>
int launch_cascade(const Filter& region, const Filter& fleet,
                   const void* packed, int row_words, int length, int n,
                   void* out, cudaStream_t stream) {
  const size_t smem = kStaged ? (size_t)kTile * row_words * 4 : 0;
  cascade_kernel<kStaged><<<tiles_for(n), kThreads, smem, stream>>>(
      region, fleet, (const uint32_t*)packed, row_words, length, n,
      (bool*)out);
  return (int)cudaGetLastError();
}

}  // namespace

// Every entry point launches on `stream`, does not synchronise, and returns
// the launch's CUDA error (0 when it was accepted).  The wrappers check
// shapes, types and the words' length (>= ceil(num_bits / 32)) and never
// call with n == 0.  `packed` need only be 4-byte aligned.
extern "C" int yadcc_bloom_membership(const void* words,
                                      unsigned int num_bits, int num_hashes,
                                      unsigned long long seed,
                                      const void* packed, int row_words,
                                      int length, int n, void* out,
                                      void* stream) {
  const Filter f = filter(words, num_bits, num_hashes, seed);
  const cudaStream_t s = (cudaStream_t)stream;
  return staged(row_words)
             ? launch_membership<true>(f, packed, row_words, length, n, out, s)
             : launch_membership<false>(f, packed, row_words, length, n, out,
                                        s);
}

extern "C" int yadcc_bloom_cascade(const void* region_words,
                                   int region_hashes,
                                   unsigned long long region_seed,
                                   const void* fleet_words, int fleet_hashes,
                                   unsigned long long fleet_seed,
                                   unsigned int num_bits, const void* packed,
                                   int row_words, int length, int n,
                                   void* out, void* stream) {
  const Filter region = filter(region_words, num_bits, region_hashes,
                               region_seed);
  const Filter fleet = filter(fleet_words, num_bits, fleet_hashes,
                              fleet_seed);
  const cudaStream_t s = (cudaStream_t)stream;
  return staged(row_words) ? launch_cascade<true>(region, fleet, packed,
                                                  row_words, length, n, out, s)
                           : launch_cascade<false>(region, fleet, packed,
                                                   row_words, length, n, out,
                                                   s);
}

// The staged kernels' tile, in keys (chip_smoke.py sizes its edge batches
// around it).
extern "C" int yadcc_bloom_tile_keys() { return kTile; }

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
