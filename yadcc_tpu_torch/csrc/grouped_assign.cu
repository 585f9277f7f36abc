// Grouped threshold-search assignment (kernel K1) for Hopper (sm_90a).
//
// Replaces the TPU kernel yadcc_tpu/ops/pallas_grouped.py:pallas_assign_grouped
// (body _kernel_body, tie split _take_lowest_slots).  What it computes is the
// plain version's result, yadcc_tpu_torch/ops/assignment_grouped.py:
// assign_grouped: G request groups run IN ORDER with `running` carried from
// group to group; for each group a bisect over the integer score domain
// [-bonus_q-1, UTIL_SCALE+1] finds the least tau with sum_s count_leq(tau) >= m,
// and the grants scored exactly tau go to the lowest slots first.
//
// What bounds it on this card: neither bytes nor operations.  The pool is a
// few hundred KB and the arithmetic a few dozen integer operations per slot
// per step; the work is a SERIAL chain of block-wide reductions (about 20 a
// group), each of which must finish before the next bisect step can choose
// its midpoint.  So the design is latency-first, and every step is short:
//   * one thread block of 1024 threads a pool: the groups are serial,
//     and a single block keeps every reduction inside one SM;
//   * a group first COMPACTS its active slots (eligible, with room) in slot
//     order: each warp owns a contiguous run of slots, a ballot gives each
//     active lane its place inside the warp's run, one block scan places the
//     warps.  Each compact entry holds what the steps read (slot, max(cap,1),
//     running, avail, pref_total), so every bisect step and the tie split
//     walk only the active slots; an inactive slot counts 0 at every tau
//     (each closed form ends in min(., avail)), so its counts are written 0
//     during the compaction and nothing reads it again;
//   * the count is branch-free: pref_total (the grants a dedicated slot
//     keeps in the preferred tier) is computed once a group and is 0 for a
//     plain slot, which makes the dedicated formula reduce to the plain one,
//     so no warp diverges on the dedicated flag;
//   * floor(x / UTIL_SCALE) is `x >> 16` on int64 (UTIL_SCALE = 2^16, which
//     the wrapper pins), not an emulated 64-bit division;
//   * the bisect stops as soon as the rest of its 22 steps could change
//     nothing: hi == lo, or hi - lo == 1 with lo known to count below m;
//   * a group with m <= 0 is skipped (zero row, `running` unchanged) when
//     the plain version provably grants nothing for it: every `running`
//     entry >= 0 at the start (it only grows within the call), bonus_q >= 0,
//     and a domain the 22 steps converge on;
//   * one barrier per reduction: warp shuffles, one shared word per warp in
//     a double-buffered array, then every warp finishes the 32 partials with
//     shuffles;
//   * the tie split is one block scan over the compact list, each thread
//     owning a contiguous run of entries.
// The per-slot state (running for the whole call, the compact list per
// group: 24 bytes a slot, plus one ballot word per 32 slots) lives in shared
// memory up to about 9,590 slots; a larger pool keeps the same arrays in a
// global scratch buffer the wrapper allocates (same code through a generic
// pointer), so any S is served.
//
// A grid of shards (the sharded control plane's fused step, the counterpart
// of yadcc_tpu/parallel/mesh.py:resident_control_plane_step_fn): the
// shards are independent pools, so the launch takes gridDim.x = n_shards
// blocks, one a shard, each on an SM of its own.  Block k reads and writes
// shard k's slice: every per-slot array from slot k*S (the environment
// bitmap from row k*S), the group arrays from k*G, counts from row k*G, the
// global scratch from k*scratch_bytes(S).  A single pool is the grid of
// one.
//
// Team mode (the counterpart of yadcc_tpu/parallel/mesh.py:
// _make_sharded_group_step, as sharded_assign_grouped_fn and the stream's
// sharded_assign_grouped_picks_stream_fn run it; plain versions
// ops/assignment_grouped.py:assign_grouped_team and
// assign_grouped_picks_stream_team): ONE pool split into equal slices over
// a team (parallel/mesh.py), one launch a card, one block a slice, the
// blocks of a card launched together as a cooperative launch.  Block b owns
// slice ids[b] (its slots from b*S in this card's part, global slots from
// ids[b]*S); every block reads the same groups.  Each cross-slice step is
// an exchange (csrc/team_exchange.cuh) after the block's own reduction:
//   * once a launch, whether every slice's `running` is >= 0 (the m <= 0
//     skip must be decided from the whole pool, not one block's
//     __syncthreads_and);
//   * each bisect step's count: the slices' sums are added, and every
//     block moves lo and hi, and decides the early stop, from that total;
//   * the tie split: each slice posts its (count below tau, count at tau);
//     the tau-ties go to the slices in linear order, slice k's share
//     starting after the ties of slices 0..k-1, so the lowest global slots
//     win as in the single pool.  From the same words each block also
//     writes, a group, the grants on the slices before it and the team's
//     total (`info`), which the stream's per-slice expansion reads.
// A group with no active slot in one slice still takes every step there
// (the single pool's `n == 0` shortcut would leave the others waiting).
// About 20 exchanges a group, each a PCIe round trip, against a block
// reduction over S/N slots instead of S.  Where trouble lies (deadlock,
// bounded waits, reuse, one path): team_exchange.cuh.
//
// Integer traps, all mirrored from the plain version:
//   * floor, not truncation: ((x+1)*cap-1) // UTIL_SCALE has a negative
//     numerator whenever tau < 0, and so can (lo+hi) // 2; an arithmetic
//     right shift floors, C++ `/` would truncate;
//   * the product is taken in int64: at tau = -bonus_q-1 it reaches -2^31
//     already at cap 8192;
//   * the environment bitmap arrives as the int32 bit pattern of the uint32
//     words; an arithmetic shift reads the same bit after `& 1`.  A word
//     index in [-E, 0) wraps to word + E and one outside [-E, E) reads
//     0xFFFFFFFF, as the JAX device functions' `jnp.take` does.

#include <cuda_runtime.h>
#include <stdint.h>

#include "team_exchange.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kUtilShift = 16;           // models/cost.py UTIL_SCALE = 2^16
constexpr long long kUtilScale = 1LL << kUtilShift;
constexpr int kSearchIters = 22;         // ops/assignment_grouped.py _SEARCH_ITERS
// running (whole call) + the compact list: slot, cap1, run, avail,
// pref_total (int32 each).
constexpr int kSlotBytes = 24;
constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ long long scratch_bytes(int S) {
  return (long long)S * kSlotBytes + (long long)((S + 31) / 32) * 4;
}

struct SlotState {
  int32_t* run;     // running, carried across groups (by slot)
  int32_t* c_slot;  // compact list of the group's active slots, slot order
  int32_t* c_cap1;  // max(capacity, 1)
  int32_t* c_run;   // running at the group's start
  int32_t* c_avail; // grantable count (> 0)
  int32_t* c_pref;  // grants kept in the preferred tier (0: plain slot)
  uint32_t* masks;  // one ballot word per 32 slots
};

struct Params {
  long long pref_thresh_q;
  long long bonus_q;
};

// Grants k < avail with u(k) = (run+k)*U // cap1 <= x.
__device__ __forceinline__ long long ks_with_u_leq(long long x, long long cap1,
                                                   long long run,
                                                   long long avail) {
  long long k = (((x + 1) * cap1 - 1) >> kUtilShift) - run + 1;
  k = k < 0 ? 0 : k;
  return k < avail ? k : avail;
}

// count_leq of the plain version, with pref_total = 0 for a plain slot.
__device__ __forceinline__ long long count_leq(long long tau, long long cap1,
                                               long long run, long long avail,
                                               long long pref_total,
                                               const Params& p) {
  long long x = tau + p.bonus_q;
  if (x > p.pref_thresh_q - 1) x = p.pref_thresh_q - 1;
  long long pref_cap = ks_with_u_leq(x, cap1, run, avail);
  long long above = ks_with_u_leq(tau, cap1, run, avail) - pref_total;
  above = above < 0 ? 0 : above;
  return (pref_cap < pref_total ? pref_cap : pref_total) + above;
}

__device__ __forceinline__ long long warp_sum(long long v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ long long warp_inclusive_scan(long long v,
                                                         int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    long long n = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v += n;
  }
  return v;
}

// Sum over the block; every thread gets the total.  One barrier: `buf` is
// the half of a double buffer this reduction owns, and the caller flips
// halves between reductions, so the next reduction's writes can never
// meet this one's reads.
__device__ __forceinline__ long long block_sum(long long v, long long* buf) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_sum(v);
  if (lane == 0) buf[warp] = v;
  __syncthreads();
  return warp_sum(buf[lane]);
}

// Exclusive prefix sum of `a` over the block in thread order, and the
// block's totals of `a` and `b`; one barrier, `buf` holds 2 x kWarps words.
__device__ __forceinline__ long long block_scan_and_sum(long long a,
                                                        long long b,
                                                        long long* buf,
                                                        long long* a_total,
                                                        long long* b_total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long incl = warp_inclusive_scan(a, lane);
  b = warp_sum(b);
  if (lane == 31) buf[warp] = incl;
  if (lane == 0) buf[kWarps + warp] = b;
  __syncthreads();
  const long long w = buf[lane];
  const long long w_incl = warp_inclusive_scan(w, lane);
  *a_total = __shfl_sync(kFull, w_incl, 31);
  *b_total = warp_sum(buf[kWarps + lane]);
  return __shfl_sync(kFull, w_incl - w, warp) + incl - a;
}

template <bool kTeam>
__global__ void __launch_bounds__(kThreads, 1) grouped_assign_kernel(
    const uint8_t* __restrict__ alive, const int32_t* __restrict__ capacity,
    const int32_t* __restrict__ running_in, const uint8_t* __restrict__ dedicated,
    const int32_t* __restrict__ version, const int32_t* __restrict__ env_bitmap,
    int env_words, const int32_t* __restrict__ g_env,
    const int32_t* __restrict__ g_minv, const int32_t* __restrict__ g_req,
    const int32_t* __restrict__ g_count, int S, int G, Params p, int avoid_self,
    int32_t* __restrict__ counts_out, int32_t* __restrict__ running_out,
    uint8_t* global_scratch, int use_shared, int32_t* __restrict__ info_out,
    team::Args team_args) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ long long red_buf[2][2 * kWarps];
  __shared__ long long team_got[kTeam ? 2 * team::kMaxSlices *
                                          team::kMaxPayload : 1];
  __shared__ int team_fail;

  // This block's shard: its slots start at `so` in every per-slot array,
  // its groups at `gi` (a team's blocks share theirs) and its rows of
  // counts at `go`.  The offsets enter each index, not the pointers, so
  // the pointers stay kernel parameters (no registers held across the
  // loops).  A team slice's slots are global slots from `gbase`.
  const int so = blockIdx.x * S;
  const int go = blockIdx.x * G;
  const int gi = kTeam ? 0 : go;
  const int slice = kTeam ? team_args.ids[blockIdx.x] : 0;
  const long long gbase = (long long)slice * S;
  team::Block tb{0u, &team_fail, team_got};
  if (kTeam && threadIdx.x == 0) team_fail = 0;  // read after a barrier

  uint8_t* base = use_shared
      ? smem : global_scratch + blockIdx.x * scratch_bytes(S);
  SlotState st;
  st.run = reinterpret_cast<int32_t*>(base);
  st.c_slot = st.run + S;
  st.c_cap1 = st.c_slot + S;
  st.c_run = st.c_cap1 + S;
  st.c_avail = st.c_run + S;
  st.c_pref = st.c_avail + S;
  st.masks = reinterpret_cast<uint32_t*>(st.c_pref + S);

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  // Warp w owns slots [w*chunk, (w+1)*chunk): a multiple of 32, so each of
  // its 32-slot steps is one ballot word.
  const int chunk = ((S + kThreads - 1) / kThreads) * 32;
  const int w_lo = warp * chunk < S ? warp * chunk : S;
  const int w_hi = w_lo + chunk < S ? w_lo + chunk : S;

  bool nonneg = true;
  for (int s = tid; s < S; s += kThreads) {
    const int32_t r = running_in[so + s];
    st.run[s] = r;
    nonneg = nonneg && r >= 0;
  }
  bool all_nonneg = __syncthreads_and(nonneg) != 0;
  if constexpr (kTeam) {
    bool ok;
    const long long mine = all_nonneg ? 1 : 0;
    const long long* got = team::exchange(team_args, tb, slice, &mine, 1, &ok);
    if (!ok) return;
    for (int k = 0; k < team_args.n_slices; ++k)
      all_nonneg = all_nonneg && got[k] != 0;
  }

  const long long lo0 = -p.bonus_q - 1;
  const long long hi0 = kUtilScale + 1;
  // Under these conditions the plain version's tau for m <= 0 reaches lo0,
  // where every slot counts 0: its row is zero and `running` stays.
  const bool skip_empty = all_nonneg && p.bonus_q >= 0 &&
                          hi0 - lo0 < (1LL << kSearchIters);
  int half = 0;  // which half of red_buf the next reduction uses

  for (int g = 0; g < G; ++g) {
    const long long m = g_count[gi + g];
    int32_t* row = counts_out + (long long)(go + g) * S;
    if (m <= 0 && skip_empty) {
      for (int s = tid; s < S; s += kThreads) row[s] = 0;
      if (kTeam && tid == 0) {
        info_out[(go + g) * 2] = 0;
        info_out[(go + g) * 2 + 1] = 0;
      }
      continue;
    }
    const int env = g_env[gi + g];
    const int word = env >> 5;
    const int bit = env & 31;
    const bool word_inside = word >= -env_words && word < env_words;
    const int word_col = word < 0 ? word + env_words : word;
    const int minv = g_minv[gi + g];
    const long long req = g_req[gi + g];

    // Compaction, pass 1: which slots are active; inactive ones count 0.
    int w_active = 0;
#pragma unroll 4
    for (int b = w_lo; b < w_hi; b += 32) {
      const int s = b + lane;
      bool active = false;
      if (s < w_hi) {
        const int32_t w = word_inside
            ? env_bitmap[(long long)(so + s) * env_words + word_col] : -1;
        const bool eligible = alive[so + s] && ((w >> bit) & 1) != 0 &&
                              version[so + s] >= minv &&
                              !(avoid_self && gbase + s == req);
        active = eligible && (long long)capacity[so + s] - st.run[s] > 0;
        if (!active) row[s] = 0;
      }
      const uint32_t mask = __ballot_sync(kFull, active);
      if (lane == 0) st.masks[b >> 5] = mask;
      w_active += __popc(mask);
    }
    // Place the warps: an exclusive scan of their counts (one barrier).
    if (lane == 0) red_buf[half][warp] = w_active;
    __syncthreads();
    const long long wc = red_buf[half][lane];
    const long long wc_incl = warp_inclusive_scan(wc, lane);
    half ^= 1;
    const int n = (int)__shfl_sync(kFull, wc_incl, 31);
    // Nothing to grant: the row is already zero.  A team slice takes every
    // step all the same: the others wait for its words.
    if (!kTeam && n == 0) continue;
    int pos = (int)__shfl_sync(kFull, wc_incl - wc, warp);

    // Pass 2: write the compact entries in slot order.
    for (int b = w_lo; b < w_hi; b += 32) {
      const uint32_t mask = st.masks[b >> 5];
      if ((mask >> lane) & 1u) {
        const int s = b + lane;
        const int i = pos + __popc(mask & ((1u << lane) - 1u));
        const int32_t c = capacity[so + s];
        const int32_t r = st.run[s];
        const int32_t a = (int32_t)((long long)c - r);
        const int32_t c1 = c > 1 ? c : 1;
        st.c_slot[i] = s;
        st.c_cap1[i] = c1;
        st.c_run[i] = r;
        st.c_avail[i] = a;
        st.c_pref[i] = dedicated[so + s]
            ? (int32_t)ks_with_u_leq(p.pref_thresh_q - 1, c1, r, a) : 0;
      }
      pos += __popc(mask);
    }
    __syncthreads();

    long long lo = lo0, hi = hi0;
    bool lo_known = false;  // a step has shown total(lo) < m
    for (int it = 0; it < kSearchIters; ++it) {
      if (hi == lo || (hi - lo == 1 && lo_known)) break;
      const long long mid = (lo + hi) >> 1;
      long long part = 0;
      for (int i = tid; i < n; i += kThreads)
        part += count_leq(mid, st.c_cap1[i], st.c_run[i], st.c_avail[i],
                          st.c_pref[i], p);
      long long total = block_sum(part, red_buf[half]);
      half ^= 1;
      if constexpr (kTeam) {
        bool ok;
        const long long* got =
            team::exchange(team_args, tb, slice, &total, 1, &ok);
        if (!ok) return;
        total = 0;
        for (int k = 0; k < team_args.n_slices; ++k) total += got[k];
      }
      if (total >= m) {
        hi = mid;
      } else {
        lo = mid;
        lo_known = true;
      }
    }
    const long long tau = hi;

    // Tie split over the compact list: thread t owns entries [i0, i1).
    const int per = (n + kThreads - 1) / kThreads;
    const int i0 = tid * per < n ? tid * per : n;
    const int i1 = i0 + per < n ? i0 + per : n;
    long long sum_below = 0, sum_at = 0;
    for (int i = i0; i < i1; ++i) {
      const long long below = count_leq(tau - 1, st.c_cap1[i], st.c_run[i],
                                        st.c_avail[i], st.c_pref[i], p);
      sum_below += below;
      sum_at += count_leq(tau, st.c_cap1[i], st.c_run[i], st.c_avail[i],
                          st.c_pref[i], p) - below;
    }
    long long total_at, total_below;
    long long before = block_scan_and_sum(sum_at, sum_below, red_buf[half],
                                          &total_at, &total_below);
    half ^= 1;
    if constexpr (kTeam) {
      // Every slice's (below, at); the ties go in linear slice order.
      bool ok;
      const long long mine[2] = {total_below, total_at};
      const long long* got = team::exchange(team_args, tb, slice, mine, 2, &ok);
      if (!ok) return;
      long long below_all = 0, at_before = 0;
      for (int k = 0; k < team_args.n_slices; ++k) {
        below_all += got[2 * k];
        if (k < slice) at_before += got[2 * k + 1];
      }
      before += at_before;
      if (tid == 0) {
        // Each slice's grants: its below, and its share of the ties.
        long long need = m - below_all, at_run = 0, grants_before = 0,
                  grants_all = 0;
        for (int k = 0; k < team_args.n_slices; ++k) {
          long long take = need - at_run;
          take = take < 0 ? 0 : take;
          take = take < got[2 * k + 1] ? take : got[2 * k + 1];
          at_run += got[2 * k + 1];
          const long long grants = got[2 * k] + take;
          if (k < slice) grants_before += grants;
          grants_all += grants;
        }
        info_out[(go + g) * 2] = (int32_t)grants_before;
        info_out[(go + g) * 2 + 1] = (int32_t)grants_all;
      }
      total_below = below_all;
    }
    const long long need_at = m - total_below;
    for (int i = i0; i < i1; ++i) {
      const long long c1 = st.c_cap1[i], r = st.c_run[i], a = st.c_avail[i],
                      pt = st.c_pref[i];
      const long long below = count_leq(tau - 1, c1, r, a, pt, p);
      const long long at = count_leq(tau, c1, r, a, pt, p) - below;
      long long take = need_at - before;
      take = take < 0 ? 0 : take;
      take = take < at ? take : at;
      before += at;
      const int s = st.c_slot[i];
      const int32_t c = (int32_t)(below + take);
      row[s] = c;
      st.run[s] += c;
    }
    // `running` and the compact list are read by the next group.
    __syncthreads();
  }

  for (int s = tid; s < S; s += kThreads) running_out[so + s] = st.run[s];
}

}  // namespace

extern "C" {

// Bytes of per-slot state of one shard; the wrapper sizes the global
// scratch as n_shards times this.
long long yadcc_grouped_assign_scratch_bytes(int S) {
  return scratch_bytes(S);
}

}  // extern "C"

namespace {

// Shared-memory plan of one block (the exchange's arrays in a team).
int plan(int S, bool team_mode, int* use_shared, int* dyn) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  int optin = 0;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (err != cudaSuccess) return (int)err;
  const long long need = scratch_bytes(S);
  // Leave room for the kernel's static shared memory (the reduction words).
  const long long stat = 2 * 2 * kWarps * (long long)sizeof(long long) +
                         (team_mode ? team::kSharedBytes : 0) + 16;
  *use_shared = need <= (long long)optin - stat ? 1 : 0;
  *dyn = *use_shared ? (int)need : 0;
  return 0;
}

}  // namespace

extern "C" {

// Launches K1 on `stream` over n_shards pools of S slots and G groups each,
// laid out shard after shard (one block a shard).  Returns
// cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue when n_shards * S or n_shards * G does not fit the
// kernel's int32 indices; the caller raises on anything but 0.
int yadcc_grouped_assign(const void* alive, const void* capacity,
                         const void* running_in, const void* dedicated,
                         const void* version, const void* env_bitmap,
                         int env_words, const void* g_env, const void* g_minv,
                         const void* g_req, const void* g_count, int S, int G,
                         int n_shards, long long pref_thresh_q,
                         long long bonus_q, int avoid_self, void* counts_out,
                         void* running_out, void* global_scratch,
                         void* stream) {
  if (n_shards < 1 || (long long)n_shards * S > 0x7fffffffLL ||
      (long long)n_shards * G > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  int use_shared = 0, dyn = 0;
  int e = plan(S, false, &use_shared, &dyn);
  if (e != 0) return e;
  cudaError_t err = cudaFuncSetAttribute(
      grouped_assign_kernel<false>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, dyn);
  if (err != cudaSuccess) return (int)err;
  Params p{pref_thresh_q, bonus_q};
  team::Args none{};
  grouped_assign_kernel<false>
      <<<n_shards, kThreads, dyn, (cudaStream_t)stream>>>(
          (const uint8_t*)alive, (const int32_t*)capacity,
          (const int32_t*)running_in, (const uint8_t*)dedicated,
          (const int32_t*)version, (const int32_t*)env_bitmap, env_words,
          (const int32_t*)g_env, (const int32_t*)g_minv,
          (const int32_t*)g_req, (const int32_t*)g_count, S, G, p,
          avoid_self, (int32_t*)counts_out, (int32_t*)running_out,
          (uint8_t*)global_scratch, use_shared, (int32_t*)nullptr, none);
  return (int)cudaGetLastError();
}

// Launches K1's team mode on `stream`: n_blocks slices of S slots each,
// laid one after another in every per-slot array (this card's part), block
// b the team's slice ids[b] of n_slices; every block reads the same G
// groups and writes its own rows of counts (int32[n_blocks, G, S]) and
// `info` (int32[n_blocks, G, 2]: grants on the slices before it, the
// team's grants, a group).  `exchange` the team's buffer, `epoch` this
// launch's number, `spin_limit` the bound of every wait in clock cycles.
// Returns cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for a team the kernel cannot take.
int yadcc_grouped_assign_team(
    const void* alive, const void* capacity, const void* running_in,
    const void* dedicated, const void* version, const void* env_bitmap,
    int env_words, const void* g_env, const void* g_minv, const void* g_req,
    const void* g_count, int S, int G, long long pref_thresh_q,
    long long bonus_q, int avoid_self, void* counts_out, void* running_out,
    void* global_scratch, void* info_out, int n_blocks, const int* ids,
    int n_slices, void* exchange, long long epoch, long long spin_limit,
    void* stream) {
  if (n_blocks < 1 || n_blocks > n_slices || n_slices > team::kMaxSlices ||
      (long long)n_blocks * S > 0x7fffffffLL ||
      (long long)n_blocks * G * 2 > 0x7fffffffLL || epoch < 1)
    return (int)cudaErrorInvalidValue;
  int use_shared = 0, dyn = 0;
  int e = plan(S, true, &use_shared, &dyn);
  if (e != 0) return e;
  cudaError_t err = cudaFuncSetAttribute(
      grouped_assign_kernel<true>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, dyn);
  if (err != cudaSuccess) return (int)err;
  Params p{pref_thresh_q, bonus_q};
  team::Args t{};
  t.buf = (unsigned long long*)exchange;
  t.epoch = epoch;
  t.spin_limit = spin_limit;
  t.n_slices = n_slices;
  for (int b = 0; b < n_blocks; ++b) t.ids[b] = ids[b];
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_blocks);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = dyn;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(
      &cfg, grouped_assign_kernel<true>, (const uint8_t*)alive,
      (const int32_t*)capacity, (const int32_t*)running_in,
      (const uint8_t*)dedicated, (const int32_t*)version,
      (const int32_t*)env_bitmap, env_words, (const int32_t*)g_env,
      (const int32_t*)g_minv, (const int32_t*)g_req,
      (const int32_t*)g_count, S, G, p, avoid_self, (int32_t*)counts_out,
      (int32_t*)running_out, (uint8_t*)global_scratch, use_shared,
      (int32_t*)info_out, t);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

void* yadcc_team_alloc(long long bytes) { return team::alloc(bytes); }

void yadcc_team_free(void* p) { cudaFreeHost(p); }

}  // extern "C"
