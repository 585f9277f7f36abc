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
//   yadcc_placement_call    <- yadcc_tpu/parallel/mesh.py:placement_score_fn,
//                              the cells x tasks spill-placement score
// What each computes is its plain version's result (ops/bloom_pipeline.py:
// membership_plain, cascade_plain and placement_score_plain,
// ops/bloom_probe.py:probe_body and scatter_add_plain); chip_smoke.py holds
// them equal on the card.
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
// The probe kernel (given fingerprints, no digest) is bound by the same
// sectors: at the production batch 8 MB of fingerprints are ~2.4 us of
// bytes, its 5.72M probe sectors ~0.042 ms at the ~135G random 32-byte
// L2 sector reads a second an H100 80GB HBM3 at 700 W sustains
// (chip_bloom_probe.py).  Its
// design is the membership kernel's probe loop without the rows: one
// thread a key (8 blocks an SM), its fingerprint one 8-byte load
// evict-first, the filter evict-last, the mod by mod_bits, chained
// probes.  h2 is the fingerprint's own (even or 0 included); only a
// digest's split forces it odd (probe_digest).  It runs within ~8% of
// that floor, as the first version did: loads past L1, `%` in place of
// mod_bits and no register cap measured no faster.
//
// The scatter-OR build (1M keys x 10 probes into 862,020 words at the
// production build) is bound by where its 10M bit-sets land.  The first
// version made them as global atomicOrs, ~11.6 to a word from every SM,
// each a read-modify-write at an L2 slice (0.12 ms on that card; one
// thread a key with mod_bits and red.global.or is no faster).  This
// design has no global atomic: two launches a pass, the filter read once
// and written once.
// * Bin: a block takes up to kBinProbes (key, probe) pairs (keys_per_thread
//   keys a thread, hash_chunk of their probes), counts them by filter
//   slice with shared-memory atomics, scans the counts, writes its column
//   of the [slices + 1] x [segments] offsets table, recomputes the probes
//   to place each at its slice's cursor, and copies the sorted list to its
//   own segment of the scratch in 16-byte chunks.  An entry is the bit's
//   offset within its slice, 2 bytes for slices of up to 2^11 words, so
//   the production build's scratch (21 MB) stays in L2.
// * Own: block s owns the 2^slice_shift words of slice s.  It loads them
//   from `words` into shared memory, ORs in slice s's run of every segment
//   with shared-memory atomicOrs (two lanes a run, 16-byte chunks, so a
//   warp's load covers 16 runs), and stores the slice to `out` once.
// Nothing is sized from an assumed spread: a batch whose probes all land
// in one slice is one block's work, slow but exact.  The wrapper plans the
// geometry (ops/cuda_bloom.py:scatter_plan) and allocates the output, the
// scratch and the table; a batch larger than the scratch runs in several
// passes, each reading the last one's output.
//
// The placement score (one spill decision: C peer cells, N <= 32 candidate
// keys, T = 1 task on the federation path) needs C x N digests and their
// probes, ~7 x 32 x 10 L2 sectors: far below one launch's cost, so what
// the card can save is launches and latency, not bytes.  One launch a
// decision: a thread a (cell, key) pair (7 x 32 = 224 pairs, one block),
// the key's K probe loads issued together, a warp's hits to one (cell,
// task) added into a per-call scratch as one atomic, and the last block
// to finish (a ticket taken after a fence) writes the score rows and each
// task's argmin and zeroes the scratch and ticket for the next call on
// them.  The host side is one native call (yadcc_placement_call): the
// staged inputs up from pinned memory, the launch, the results back into
// pinned memory, one wait.  The cells' filters are whatever resident
// copies the caller points the table at (scheduler/placement.py uploads
// each snapshot once).
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

// One filter as the kernels see it.  `magic` is floor((2^64 - 1) /
// num_bits) + 1 (0 for num_bits = 1), for mod_bits.
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

// All K probe bits of the fingerprint (h1, h2) set, h2 as given?  idx =
// (h1 + i*h2) mod num_bits in uint32 arithmetic (common/bloom.py:
// probe_indices).  Chained: each probe waits on the one before and the
// walk stops at the first zero bit.
__device__ __forceinline__ bool probe_h(const Filter& f, uint32_t h1,
                                        uint32_t h2, uint64_t keep) {
  uint32_t x = h1;  // h1 + i * h2, wrapping
  for (int i = 0; i < f.num_hashes; ++i, x += h2) {
    const uint32_t idx = mod_bits(x, f.magic, f.num_bits);
    if (!((load_word(f.words + (idx >> 5), keep) >> (idx & 31u)) & 1u))
      return false;
  }
  return true;
}

// The key with digest `d`: its fingerprint is the digest's split, h2
// forced odd (common/bloom.py:_split_digests).
__device__ __forceinline__ bool probe_digest(const Filter& f, uint64_t d,
                                             uint64_t keep) {
  return probe_h(f, (uint32_t)d, (uint32_t)(d >> 32) | 1u, keep);
}

template <class Row>
__device__ __forceinline__ bool member(const Filter& f, const Row& row,
                                       int length, uint64_t keep) {
  return probe_digest(f, xxh64_row(row, length, f.seed), keep);
}

// Fingerprint k of an [N, 2] uint32 array: one 8-byte load when the array
// is 8-byte aligned (`pairs`), else two 4-byte loads.
__device__ __forceinline__ uint2 load_fingerprint(const uint32_t* fps,
                                                  long long k, bool pairs,
                                                  uint64_t policy) {
  const uint32_t* p = fps + 2 * k;
  uint2 v;
  if (pairs)
    asm("ld.global.nc.L2::cache_hint.v2.u32 {%0, %1}, [%2], %3;"
        : "=r"(v.x), "=r"(v.y)
        : "l"(p), "l"(policy));
  else
    v = make_uint2(load_word(p, policy), load_word(p + 1, policy));
  return v;
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

__global__ void __launch_bounds__(kThreads, 8)
probe_kernel(Filter f, const uint32_t* __restrict__ fps, bool pairs, int n,
             bool* __restrict__ out) {
  const uint64_t keep = policy_evict_last(), stream = policy_evict_first();
  const int k = blockIdx.x * kThreads + threadIdx.x;
  if (k >= n) return;
  const uint2 fp = load_fingerprint(fps, k, pairs, stream);
  out[k] = probe_h(f, fp.x, fp.y, keep);
}

// ---------------------------------------------------------------------------
// The scatter-OR build, binned by filter slice (see the note at the top).

constexpr int kBinThreads = 512;
constexpr int kBinProbes = 16384;  // (key, probe) pairs a bin block sorts
constexpr int kOwnThreads = 512;

// Exclusive prefix sum of a[0, len) in place, by a bin block (each thread
// sums a contiguous part; warps scan the parts' sums).
__device__ void block_exclusive_scan(int* a, int len) {
  constexpr int kBlock = kBinThreads;
  __shared__ int warp_sums[kBlock / 32];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int per = (len + kBlock - 1) / kBlock;
  const int lo = min(len, t * per), hi = min(len, lo + per);
  int sum = 0;
  for (int i = lo; i < hi; ++i) sum += a[i];
  int incl = sum;
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(~0u, incl, d);
    if (lane >= d) incl += v;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int w = lane < kBlock / 32 ? warp_sums[lane] : 0;
    int wi = w;
    for (int d = 1; d < 32; d <<= 1) {
      const int v = __shfl_up_sync(~0u, wi, d);
      if (lane >= d) wi += v;
    }
    if (lane < kBlock / 32) warp_sums[lane] = wi - w;
  }
  __syncthreads();
  int run = warp_sums[warp] + incl - sum;
  for (int i = lo; i < hi; ++i) {
    const int v = a[i];
    a[i] = run;
    run += v;
  }
  __syncthreads();
}

// Calls fn(idx) for each probe index of this bin block's pairs: keys
// first + j * kBinThreads + threadIdx.x (j < keys_per_thread, key < m),
// probes [i0, i0 + hk).
template <class Fn>
__device__ __forceinline__ void for_each_probe(
    const Filter& f, const uint32_t* fps, bool pairs, int m, int first,
    int keys_per_thread, uint32_t i0, int hk, uint64_t stream, Fn fn) {
  for (int j = 0; j < keys_per_thread; ++j) {
    const int key = first + j * kBinThreads + threadIdx.x;
    if (key >= m) break;
    const uint2 fp = load_fingerprint(fps, key, pairs, stream);
    uint32_t x = fp.x + i0 * fp.y;  // wrapping
#pragma unroll 2
    for (int i = 0; i < hk; ++i, x += fp.y)
      fn(mod_bits(x, f.magic, f.num_bits));
  }
}

// A scratch entry is a probe's bit offset within its slice: uint16 for
// slices of at most 2^kNarrowShift words (65,536 bits; the production
// filter's 2^11-word slices among them), uint32 for larger ones.
constexpr int kNarrowShift = 11;

// 16 bytes of entries, read-only, with an L2 policy.
__device__ __forceinline__ uint4 load_chunk(const void* p, uint64_t policy) {
  uint4 v;
  asm("ld.global.nc.L2::cache_hint.v4.u32 {%0, %1, %2, %3}, [%4], %5;"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p), "l"(policy));
  return v;
}

// OR into `bits` (a slice) the entries of chunk v, entries [c, c + 16 /
// sizeof(Entry)) of a run, that lie in [a, b).
template <class Entry>
__device__ __forceinline__ void or_chunk(uint32_t* bits, const uint4& v,
                                         int c, int a, int b) {
  constexpr int kPerWord = 4 / sizeof(Entry);
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int j = 0; j < 4 * kPerWord; ++j) {
    const uint32_t e = kPerWord == 1 ? w[j]
                                     : (w[j / kPerWord] >> (16 * (j & 1))) &
                                           0xFFFFu;
    if (c + j >= a && c + j < b) atomicOr(&bits[e >> 5], 1u << (e & 31u));
  }
}

// Pass (a).  Block (x, y) is segment y * gridDim.x + x: keys [x *
// kBinThreads * keys_per_thread, ...) of this pass's m, probes [y *
// hash_chunk, ...).  Writes its entries sorted by slice to its kBinProbes
// entries of `scratch` and slice s's start among them to table[s *
// segments + segment], s in [0, slices] (the last is the count).
template <class Entry>
__global__ void __launch_bounds__(kBinThreads)
scatter_bin_kernel(Filter f, const uint32_t* __restrict__ fps, bool pairs,
                   int m, int keys_per_thread, int hash_chunk,
                   int slice_shift, int slices, Entry* __restrict__ scratch,
                   int* __restrict__ table) {
  extern __shared__ __align__(16) uint32_t smem[];
  Entry* sorted = reinterpret_cast<Entry*>(smem);  // 16-byte aligned
  int* cursor = reinterpret_cast<int*>(sorted + kBinProbes);  // slices + 1
  const int segments = gridDim.x * gridDim.y;
  const int seg = blockIdx.y * gridDim.x + blockIdx.x;
  const int i0 = blockIdx.y * hash_chunk;
  const int hk = min(hash_chunk, f.num_hashes - i0);
  const int first = blockIdx.x * kBinThreads * keys_per_thread;
  const int shift = slice_shift + 5;  // bit index -> slice
  const uint32_t offset = (32u << slice_shift) - 1;
  const uint64_t stream = policy_evict_first();
  for (int s = threadIdx.x; s <= slices; s += kBinThreads) cursor[s] = 0;
  __syncthreads();
  for_each_probe(f, fps, pairs, m, first, keys_per_thread, i0, hk, stream,
                 [&](uint32_t idx) { atomicAdd(&cursor[idx >> shift], 1); });
  __syncthreads();
  block_exclusive_scan(cursor, slices + 1);
  for (int s = threadIdx.x; s <= slices; s += kBinThreads)
    table[(size_t)s * segments + seg] = cursor[s];
  __syncthreads();
  for_each_probe(f, fps, pairs, m, first, keys_per_thread, i0, hk, stream,
                 [&](uint32_t idx) {
                   sorted[atomicAdd(&cursor[idx >> shift], 1)] =
                       (Entry)(idx & offset);
                 });
  __syncthreads();
  // The sorted list out in 16-byte chunks (the last one's tail is stale
  // entries past the count, which pass (b) never reads).
  constexpr int kPerChunk = 16 / sizeof(Entry);
  const int chunks = (cursor[slices] + kPerChunk - 1) / kPerChunk;
  uint4* dst = reinterpret_cast<uint4*>(scratch + (size_t)seg * kBinProbes);
  const uint4* src = reinterpret_cast<const uint4*>(sorted);
  for (int c = threadIdx.x; c < chunks; c += kBinThreads) dst[c] = src[c];
}

// Pass (b).  Block s ORs slice s's runs of every segment into words [s <<
// slice_shift, ...) of `in` and stores them to `out` (`in` may be `out`:
// the block reads its words before it writes them).  Two lanes take a
// run, each a 16-byte chunk of it at a time, so a warp reads 16 runs with
// each load.
template <class Entry>
__global__ void __launch_bounds__(kOwnThreads)
scatter_own_kernel(const uint32_t* in, uint32_t* out, int nw,
                   int slice_shift, const Entry* __restrict__ scratch,
                   const int* __restrict__ table, int segments) {
  constexpr int kPerChunk = 16 / sizeof(Entry);
  constexpr int kLanes = 2;  // lanes a run
  extern __shared__ __align__(16) uint32_t smem[];
  const int t = threadIdx.x;
  const int s = blockIdx.x;
  const int w0 = s << slice_shift;
  const int len = min(1 << slice_shift, nw - w0);
  uint32_t* bits = smem;                                     // the slice
  int* lo = reinterpret_cast<int*>(smem + (1 << slice_shift));  // run starts
  int* hi = lo + segments;                                      // run ends
  const uint64_t stream = policy_evict_first();
  for (int w = t; w < len; w += kOwnThreads) bits[w] = in[w0 + w];
  for (int g = t; g < segments; g += kOwnThreads) {
    lo[g] = table[(size_t)s * segments + g];
    hi[g] = table[(size_t)(s + 1) * segments + g];
  }
  __syncthreads();
  for (int g = t / kLanes; g < segments; g += kOwnThreads / kLanes) {
    const int a = lo[g], b = hi[g];
    const Entry* run = scratch + (size_t)g * kBinProbes;
    for (int c = (a & -kPerChunk) + (t % kLanes) * kPerChunk; c < b;
         c += kLanes * kPerChunk)
      or_chunk<Entry>(bits, load_chunk(run + c, stream), c, a, b);
  }
  __syncthreads();
  for (int w = t; w < len; w += kOwnThreads) out[w0 + w] = bits[w];
}

// ---------------------------------------------------------------------------
// Scored spill placement: the cells x tasks cost matrix (yadcc_tpu/parallel/
// mesh.py:placement_score_fn; plain version ops/bloom_pipeline.py:
// placement_score_plain), one launch a call.
// * Thread p of the grid takes pair p: cell p / N, key p % N (a block holds
//   256 consecutive pairs, however many cells they span, so a spill
//   decision's 224 pairs are one block).  It digests the key's row, read
//   from global memory, with the cell's seed and probes the cell's filter
//   (xxh64_row, as the membership kernel), its K loads issued together and
//   ANDed: a member waits for one L2 round trip, not ten chained ones.
// * A warp's hits to one (cell, task) are one atomicAdd into `scratch`
//   ([C, T] int32, zero on entry): __match_any_sync groups the lanes, the
//   lowest lane adds their count.  A block's 256 pairs can span 256 cells
//   (N = 1), so a shared [cells, T] tally has no fixed size; the warp's
//   group does, and the scratch takes every shape.
// * After a block barrier thread 0 fences the block's adds and takes a
//   ticket (atomicAdd on `ticket`, zero on entry); the block that takes
//   the last one fences again and reads the
//   hits from L2, writes the score rows with the JAX package's int32
//   arithmetic, wrapping as it wraps, zeroes the scratch and the ticket, and
//   takes each task's argmin as it goes, a shared-memory atomicMin of
//   (score, cell) a task ([T] 64-bit, at most 32 KB), so the lowest cell
//   wins a tie as jnp.argmin's first occurrence does.  No memset and no
//   second launch; with one block the ticket is trivially the last, on the
//   same code path.
// * No thread-block cluster: it would cap C at 8 (16 non-portable).

constexpr int kPlaceThreads = 256;
constexpr int kPlaceMaxTasks = 4096;   // the most tasks a call takes
constexpr int kPlaceBig = 1 << 30;     // an ineligible cell's score
constexpr int kPlaceProbes = 16;       // probe loads issued together

// The call's header, the first 64 bytes of its staged input (written by
// ops/cuda_bloom.py:placement_pack).  Offsets are bytes from the input's
// start; the table (C word pointers, 0 for a cell without a filter, then C
// 64-bit seeds) sits at byte 64, so it is 8-byte aligned.
struct PlaceHeader {
  int cells, tasks, n, row_words, length;
  unsigned int num_bits;
  int num_hashes, warm_scale, w_warm, w_load, w_topo;
  int in_bytes, off_terms, off_counts, off_task, off_packed;
};
static_assert(sizeof(PlaceHeader) == 64, "the wrapper writes 16 int32");
constexpr int kPlaceTable = 64;

struct PlaceArgs {
  const unsigned long long* table;
  const int* terms;   // rows util_q, topo_q, eligible, has_filter; C each
  const int* counts;
  const int* task_of_key;
  const uint32_t* packed;
  int cells, tasks, n, row_words, length;
  int warm_scale, w_warm, w_load, w_topo;
  int* out;           // scores [C, T], then best cell [T], best score [T]
  int* scratch;       // [C, T] hit counts, zero between calls
  unsigned int* ticket;
};

// floor(a / b) for b >= 1, as jnp's // rounds.
__device__ __forceinline__ int floor_div(int a, int b) {
  const int q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}

// All K probe bits of (h1, h2) set?  The probe_h indices, their loads
// issued kPlaceProbes at a time and ANDed (the verdict is probe_h's).
__device__ __forceinline__ bool probe_together(const Filter& f, uint32_t h1,
                                               uint32_t h2, uint64_t keep) {
  uint32_t x = h1;  // h1 + i * h2, wrapping
  for (int i = 0; i < f.num_hashes; i += kPlaceProbes) {
    uint32_t all = 1u;
#pragma unroll
    for (int j = 0; j < kPlaceProbes; ++j, x += h2) {
      if (i + j < f.num_hashes) {
        const uint32_t idx = mod_bits(x, f.magic, f.num_bits);
        all &= load_word(&f.words[idx >> 5], keep) >> (idx & 31u);
      }
    }
    if (!(all & 1u)) return false;
  }
  return true;
}

__global__ void __launch_bounds__(kPlaceThreads)
placement_kernel(Filter f, PlaceArgs a) {
  extern __shared__ unsigned long long best[];  // [T] (score, cell) minima
  __shared__ bool last;
  const uint32_t pair = blockIdx.x * kPlaceThreads + threadIdx.x;
  int slot = -1;  // c * T + task when this pair's key hits
  if (pair < (uint32_t)a.cells * (uint32_t)a.n) {
    const int c = (int)(pair / a.n), i = (int)(pair % a.n);
    const int task = a.task_of_key[i];
    f.words = reinterpret_cast<const uint32_t*>(a.table[c]);
    f.seed = a.table[a.cells + c];
    // Every pair's row is digested, so its loads go out beside the task's
    // and the table's; padding keys (task -1) and cells without a filter
    // probe nothing.
    const GlobalRow row{a.packed + (size_t)i * a.row_words,
                        policy_evict_first()};
    const uint64_t d = xxh64_row(row, a.length, f.seed);
    if (task >= 0 && task < a.tasks && f.words != nullptr &&
        probe_together(f, (uint32_t)d, (uint32_t)(d >> 32) | 1u,
                       policy_evict_last()))
      slot = c * a.tasks + task;
  }
  const unsigned peers = __match_any_sync(~0u, slot);
  if (slot >= 0 && (threadIdx.x & 31) == __ffs(peers) - 1)
    atomicAdd(&a.scratch[slot], __popc(peers));
  // The block's adds are ordered before its ticket, and every block's
  // before the last block's reads, by thread 0's fences on either side of
  // the ticket after a block barrier (as cooperative groups' grid sync).
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    last = atomicAdd(a.ticket, 1u) == gridDim.x - 1;
    __threadfence();
  }
  __syncthreads();
  if (!last) return;
  const int C = a.cells, T = a.tasks;
  for (int t = threadIdx.x; t < T; t += kPlaceThreads) best[t] = ~0ULL;
  __syncthreads();
  for (int k = threadIdx.x; k < C * T; k += kPlaceThreads) {
    const int c = k / T, t = k % T;
    const int hits = __ldcg(&a.scratch[k]);  // the adds landed in L2
    a.scratch[k] = 0;
    const uint32_t load = (uint32_t)a.w_load * (uint32_t)a.terms[c] +
                          (uint32_t)a.w_topo * (uint32_t)a.terms[C + c];
    int miss = a.warm_scale;
    if (a.terms[3 * C + c] > 0)
      miss = floor_div((int)(((uint32_t)a.counts[t] - (uint32_t)hits) *
                             (uint32_t)a.warm_scale),
                       max(a.counts[t], 1));
    const int score = a.terms[2 * C + c] > 0
                          ? (int)((uint32_t)a.w_warm * (uint32_t)miss + load)
                          : kPlaceBig;
    a.out[k] = score;
    // (score, cell) as one unsigned key: the sign bit flipped so the int32
    // order holds, the cell below it so the lowest cell wins a tie.
    atomicMin(&best[t], ((unsigned long long)((uint32_t)score ^ 0x80000000u)
                         << 32) | (uint32_t)c);
  }
  if (threadIdx.x == 0) *a.ticket = 0;
  __syncthreads();
  for (int t = threadIdx.x; t < T; t += kPlaceThreads) {
    a.out[(size_t)C * T + t] = (int)(uint32_t)best[t];
    a.out[(size_t)C * T + T + t] =
        (int)((uint32_t)(best[t] >> 32) ^ 0x80000000u);
  }
}

// The launch floor: an empty kernel of one placement block.
__global__ void __launch_bounds__(kPlaceThreads) empty_kernel() {}

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

bool eight_byte_aligned(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 7u) == 0;
}

// Dynamic shared memory past 48 KB must be asked for, kernel by kernel.
template <class Kernel>
int launchable(Kernel kernel, size_t smem) {
  constexpr size_t kDefault = 48 * 1024, kMax = 227 * 1024;
  if (smem > kMax) return (int)cudaErrorInvalidValue;
  if (smem <= kDefault) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// One pass after another of the binned scatter, entries of type Entry.
template <class Entry>
int scatter_passes(const uint32_t* words, uint32_t* out, const Filter& f,
                   const uint32_t* fps, int n, Entry* scratch, int* table,
                   int slice_shift, int keys_per_thread, int hash_chunk,
                   int key_blocks, cudaStream_t stream) {
  const int nw = (int)(((unsigned long long)f.num_bits + 31) / 32);
  const int slices = (nw + (1 << slice_shift) - 1) >> slice_shift;
  const int hash_blocks = (f.num_hashes + hash_chunk - 1) / hash_chunk;
  const size_t bin_smem = (size_t)(slices + 1) * 4 +
                          (size_t)kBinProbes * sizeof(Entry);
  const bool pairs = eight_byte_aligned(fps);
  const long long block_keys = (long long)kBinThreads * keys_per_thread;
  const long long pass_keys = block_keys * key_blocks;
  for (long long k0 = 0; k0 < n; k0 += pass_keys) {
    const int m = (int)(n - k0 < pass_keys ? n - k0 : pass_keys);
    const int gx = (int)((m + block_keys - 1) / block_keys);
    const int used = gx * hash_blocks;
    const size_t own_smem = ((size_t)(1 << slice_shift) + 2 * used) * 4;
    int err = launchable(scatter_bin_kernel<Entry>, bin_smem);
    if (err == 0) err = launchable(scatter_own_kernel<Entry>, own_smem);
    if (err != 0) return err;
    scatter_bin_kernel<Entry><<<dim3(gx, hash_blocks), kBinThreads,
                                bin_smem, stream>>>(
        f, fps + 2 * k0, pairs, m, keys_per_thread, hash_chunk, slice_shift,
        slices, scratch, table);
    if ((err = (int)cudaGetLastError()) != 0) return err;
    scatter_own_kernel<Entry><<<slices, kOwnThreads, own_smem, stream>>>(
        k0 == 0 ? words : out, out, nw, slice_shift, scratch, table, used);
    if ((err = (int)cudaGetLastError()) != 0) return err;
  }
  return 0;
}

int launch_scatter(const void* words, void* out, unsigned int num_bits,
                   int num_hashes, const void* fingerprints, int n,
                   void* scratch, void* table, int slice_shift,
                   int keys_per_thread, int hash_chunk, int segments,
                   cudaStream_t stream) {
  if (num_bits < 1 || num_hashes < 1 || n < 1 || slice_shift < 0 ||
      slice_shift > 20 || keys_per_thread < 1 || hash_chunk < 1 ||
      (long long)keys_per_thread * hash_chunk * kBinThreads > kBinProbes)
    return (int)cudaErrorInvalidValue;
  const int key_blocks =
      segments / ((num_hashes + hash_chunk - 1) / hash_chunk);
  if (key_blocks < 1) return (int)cudaErrorInvalidValue;
  const Filter f = filter(nullptr, num_bits, num_hashes, 0);
  const uint32_t* w = (const uint32_t*)words;
  const uint32_t* fps = (const uint32_t*)fingerprints;
  if (slice_shift <= kNarrowShift)
    return scatter_passes(w, (uint32_t*)out, f, fps, n, (uint16_t*)scratch,
                          (int*)table, slice_shift, keys_per_thread,
                          hash_chunk, key_blocks, stream);
  return scatter_passes(w, (uint32_t*)out, f, fps, n, (uint32_t*)scratch,
                        (int*)table, slice_shift, keys_per_thread,
                        hash_chunk, key_blocks, stream);
}

// The header's refusals: C >= 1, T in [1, kPlaceMaxTasks], N >= 0,
// num_bits >= 1, parts that lie after the table and inside the staged
// input, scores and picks of fewer than 2^29 ints (their bytes an int),
// fewer than 2^31 (cell, key) pairs (the kernel counts them in 32 bits).
// (The wrapper also refuses counts above PLACE_MAX_COUNT and filters of
// differing geometry: every cell's words hold ceil(num_bits / 32) words.)
bool placement_shape_ok(const PlaceHeader& h) {
  const long long c = h.cells, t = h.tasks, n = h.n;
  return c >= 1 && t >= 1 && t <= kPlaceMaxTasks && n >= 0 &&
         h.row_words >= 0 && h.num_bits >= 1 && h.num_hashes >= 0 &&
         h.off_terms >= kPlaceTable + 16 * c &&
         h.off_packed + 4 * n * h.row_words <= h.in_bytes &&
         c * t + 2 * t < (1LL << 29) && c * n < (1LL << 31);
}

int placement_out_bytes(const PlaceHeader& h) {
  return (h.cells * h.tasks + 2 * h.tasks) * 4;
}

int launch_placement(const PlaceHeader& h, const void* dev_in, void* dev_out,
                     void* scratch, void* ticket, cudaStream_t stream) {
  const char* in = (const char*)dev_in;
  PlaceArgs a;
  a.table = (const unsigned long long*)(in + kPlaceTable);
  a.terms = (const int*)(in + h.off_terms);
  a.counts = (const int*)(in + h.off_counts);
  a.task_of_key = (const int*)(in + h.off_task);
  a.packed = (const uint32_t*)(in + h.off_packed);
  a.cells = h.cells;
  a.tasks = h.tasks;
  a.n = h.n;
  a.row_words = h.row_words;
  a.length = h.length;
  a.warm_scale = h.warm_scale;
  a.w_warm = h.w_warm;
  a.w_load = h.w_load;
  a.w_topo = h.w_topo;
  a.out = (int*)dev_out;
  a.scratch = (int*)scratch;
  a.ticket = (unsigned int*)ticket;
  const long long pairs = (long long)h.cells * h.n;
  const int blocks =
      pairs == 0 ? 1 : (int)((pairs + kPlaceThreads - 1) / kPlaceThreads);
  placement_kernel<<<blocks, kPlaceThreads, sizeof(unsigned long long) *
                                                h.tasks, stream>>>(
      filter(nullptr, h.num_bits, h.num_hashes, 0), a);
  return (int)cudaGetLastError();
}

// Makes `device` current for the call's thread; restores it on scope exit.
struct OnDevice {
  int prev = -1;
  int err = 0;
  explicit OnDevice(int device) {
    err = (int)cudaGetDevice(&prev);
    if (err == 0 && prev != device) err = (int)cudaSetDevice(device);
  }
  ~OnDevice() {
    int now = -1;
    if (prev >= 0 && cudaGetDevice(&now) == cudaSuccess && now != prev)
      cudaSetDevice(prev);
  }
};

}  // namespace

// Every entry point but yadcc_placement_call launches on `stream`, does not
// synchronise, and returns the launch's CUDA error (0 when it was accepted).  The wrappers check
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
      filter(words, num_bits, num_hashes, 0), (const uint32_t*)fingerprints,
      eight_byte_aligned(fingerprints), n, (bool*)out);
  return (int)cudaGetLastError();
}

// The binned scatter-OR: `out` = `words` with every probe bit of the n
// fingerprints set, for num_hashes >= 1 and n >= 1.  The geometry is the
// wrapper's plan (ops/cuda_bloom.py:scatter_plan): slices of 2^slice_shift
// words, keys_per_thread keys and hash_chunk probes a bin block, at most
// `segments` bin blocks a pass.  `scratch` holds segments * kBinProbes
// uint32, `table` (slices + 1) * segments int32, slices = ceil(ceil(
// num_bits / 32) / 2^slice_shift).  Two launches a pass; returns the first
// launch error, or cudaErrorInvalidValue for a plan the kernels cannot
// take.
extern "C" int yadcc_bloom_scatter_or(const void* words, void* out,
                                      unsigned int num_bits, int num_hashes,
                                      const void* fingerprints, int n,
                                      void* scratch, void* table,
                                      int slice_shift, int keys_per_thread,
                                      int hash_chunk, int segments,
                                      void* stream) {
  return launch_scatter(words, out, num_bits, num_hashes, fingerprints, n,
                        scratch, table, slice_shift, keys_per_thread,
                        hash_chunk, segments, (cudaStream_t)stream);
}

// The binned scatter's constants, for the wrapper's plan.
extern "C" int yadcc_bloom_scatter_bin_threads() { return kBinThreads; }
extern "C" int yadcc_bloom_scatter_bin_probes() { return kBinProbes; }

// One placement decision, on `device` and `stream`, from the pinned staged
// input `host_in` (PlaceHeader, then its parts) into the pinned `host_out`
// (scores [C, T], best cell [T], best score [T]): the input copied up to
// `dev_in`, one launch of placement_kernel into `dev_out` with `scratch`
// ([C, T] int32) and `ticket` (one uint32), both zero on entry and left
// zero, the results copied back, and a wait for the stream.  The wait runs
// whatever failed before it, so no copy is in flight on return.  Returns
// the first CUDA error, or cudaErrorInvalidValue for a header the kernel
// does not take (placement_shape_ok).  The GIL is not held across it.
extern "C" int yadcc_placement_call(const void* host_in, void* dev_in,
                                    void* host_out, void* dev_out,
                                    void* scratch, void* ticket, int device,
                                    void* stream) {
  const PlaceHeader& h = *(const PlaceHeader*)host_in;
  if (!placement_shape_ok(h)) return (int)cudaErrorInvalidValue;
  const OnDevice on(device);
  if (on.err != 0) return on.err;
  const cudaStream_t s = (cudaStream_t)stream;
  int err = (int)cudaMemcpyAsync(dev_in, host_in, h.in_bytes,
                                 cudaMemcpyHostToDevice, s);
  if (err == 0) err = launch_placement(h, dev_in, dev_out, scratch, ticket, s);
  if (err == 0)
    err = (int)cudaMemcpyAsync(host_out, dev_out, placement_out_bytes(h),
                               cudaMemcpyDeviceToHost, s);
  const int waited = (int)cudaStreamSynchronize(s);
  return err != 0 ? err : waited;
}

// The kernel alone, on an input a call already staged on the card (the
// header read from `host_in`): one launch on `stream`, no copy, no wait.
// For timing the kernel; returns the launch's error.
extern "C" int yadcc_placement_launch(const void* host_in, const void* dev_in,
                                      void* dev_out, void* scratch,
                                      void* ticket, int device, void* stream) {
  const PlaceHeader& h = *(const PlaceHeader*)host_in;
  if (!placement_shape_ok(h)) return (int)cudaErrorInvalidValue;
  const OnDevice on(device);
  if (on.err != 0) return on.err;
  return launch_placement(h, dev_in, dev_out, scratch, ticket,
                          (cudaStream_t)stream);
}

// An empty one-block launch on `stream`: the floor under any one-launch
// call (chip_smoke.py times it beside the placement kernel).
extern "C" int yadcc_empty_launch(void* stream) {
  empty_kernel<<<1, kPlaceThreads, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

// The most tasks one placement call takes.
extern "C" int yadcc_placement_max_tasks() { return kPlaceMaxTasks; }
