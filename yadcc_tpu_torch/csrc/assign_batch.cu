// Exact sequential assignment scan (kernel K2) for Hopper (sm_90a).
//
// Replaces the TPU kernel yadcc_tpu/ops/pallas_assign.py:pallas_assign_batch
// (body _kernel_body).  What it computes is the plain version's result,
// yadcc_tpu_torch/ops/assignment.py:assign_batch: T tasks IN ORDER, `running`
// carried from task to task; each task scores every slot (eligible: alive,
// has the environment, version >= min, not the requestor when avoid_self;
// feasible: running < capacity; score = running*U // max(cap,1), minus
// bonus_q for a dedicated slot under the preference threshold; infeasible
// slots score infeasible_q), picks the lowest slot at the minimum score, and
// grants it only when that score is feasible and the task is not padding.
//
// What bounds it on this card: neither bytes nor operations.  One call reads
// the pool once (a few hundred KB at S=8192) and the function needs an
// eligibility test per slot only when the task's descriptor changes; the
// work is a SERIAL chain of T block-wide argmins, because each task must see
// the grant of the one before.  So the design is latency-first, and it takes
// out of that chain everything the function does not need:
//   * one launch, one thread block of 1024 threads, the tasks in a loop
//     inside the block (the TPU kernel's sequential grid becomes this loop);
//   * slot s belongs to thread s % 1024, which alone reads and writes its
//     state: nothing about a slot crosses threads, so a task needs one
//     barrier (the reduction's), and the prologue none;
//   * each slot's task-independent part, key = score*S + s (kNoKey when the
//     slot is dead or full), is computed once in the prologue and kept in
//     shared memory; after a grant the owner of the granted slot recomputes
//     that one key.  The key is unique and orders by (score, slot), so the
//     least key is the lowest slot at the minimum score; the owner is the one
//     thread whose local minimum equals the block's, so the slot is never
//     decoded from the key;
//   * a task whose descriptor (env, min_version, requestor) differs from the
//     one before tests every slot's eligibility (version from shared memory,
//     the environment word from a transposed [E, S] copy of the bitmap that
//     the prologue writes to the global scratch, so a warp reads 128
//     contiguous bytes of one column) and takes each thread's minimum;
//   * a task that repeats the descriptor keeps every eligibility and every
//     key but the granted slot's, so only that slot's owner rescans its
//     slots (eligibility bits of its first 32 slots kept in a register);
//     after a task that granted nothing, not even that: the minimum stands;
//   * the block minimum: 64-bit keys as (high, low) word pairs through
//     `redux.sync` (two a warp), one word per warp in a double-buffered
//     shared array, then every warp finishes the 32 partials the same way;
//   * the utilization's floor division is one 32-bit unsigned division when
//     0 <= running < 2^16 (exact: the numerator running << 16 fits 32 bits),
//     the emulated int64 floor division otherwise; either runs once a grant.
// The per-slot state (key, running, version, capacity, dedicated: 21 bytes a
// slot) lives in shared memory up to about 10,400 slots; a larger pool keeps
// the same arrays in the global scratch the wrapper allocates (the same code,
// instantiated for it), so any S is served.  The task descriptors are staged
// in shared memory, 1,024 at a time, so a task reads them at shared-memory
// latency.  Each scan is branch-free inside a group of 8 slots.  The kernel
// counts the descriptor changes, the owner rescans and the reductions it
// made, for the host model of this design (chip_smoke.py:k2_model) to be
// checked against.
//
// Team mode (the counterpart of yadcc_tpu/parallel/mesh.py:sharded_assign_fn;
// plain version ops/assignment.py:assign_batch_team): the pool split into
// equal slices over a team (parallel/mesh.py), one launch a card, one block
// a slice, the blocks of a card launched together as a cooperative launch.
// Block b owns slice ids[b]: its per-slot arrays from slot b*S of its card's
// part, global slots from ids[b]*S.  A key is score*S_key + global slot,
// S_key the whole pool, so keys stay unique and comparable across slices.
// Each reduction is followed by one exchange (csrc/team_exchange.cuh) of the
// slice's least key; every block takes the least of the team's and decodes
// the winner, so every block sees the same grant and the same descriptor
// changes and makes the same exchanges; only the slice owning the winning
// slot adds it to `running`, and block 0 of each card writes the picks.  A
// task whose descriptor and minimum stand makes no exchange, in every slice
// alike.  Where trouble lies (deadlock, bounded waits, reuse, one path):
// team_exchange.cuh.
//
// Integer traps, all mirrored from the plain version:
//   * the utilization product is int64 and the division floors (a running
//     count folded below zero never reaches this kernel, but floor keeps the
//     plain version's semantics for any input);
//   * a feasible slot's score is below infeasible_q exactly when its key is
//     below infeasible_q*S (0 <= s < S), the product the plain version forms
//     for every infeasible slot;
//   * the bitmap arrives as the int32 bit pattern of the uint32 words; an
//     arithmetic shift reads the same bit after `& 1`.  A word index in
//     [-E, 0) wraps to word + E and one outside [-E, E) reads 0xFFFFFFFF,
//     as the JAX device functions' `jnp.take` does.

#include <cuda_runtime.h>
#include <stdint.h>

#include "team_exchange.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kUtilShift = 16;           // models/cost.py UTIL_SCALE = 2^16
constexpr long long kUtilScale = 1LL << kUtilShift;
constexpr long long kNoKey = 0x7fffffffffffffffLL;
constexpr int kMaskSlots = 32;           // eligibility bits kept in a register
constexpr int kGroup = 8;                // slots whose column loads go together
static_assert(kMaskSlots % kGroup == 0, "a group is all in or all out");
constexpr int kTaskChunk = 1024;         // descriptors staged at a time
// Static shared memory: the reduction words and the staged descriptors.
constexpr long long kStaticSmem =
    2 * kWarps * sizeof(long long) + kTaskChunk * (3 * sizeof(int32_t) + 1);
constexpr unsigned kFull = 0xffffffffu;
// key (8) + running, version, capacity (4 each) + dedicated (1).
constexpr int kSlotBytes = 21;

long long slot_bytes(int S) {
  return ((long long)S * kSlotBytes + 15) / 16 * 16;
}

long long scratch_bytes(int S, int env_words) {
  return slot_bytes(S) + (long long)S * env_words * 4;
}

// One block's region of the global scratch, 16-byte aligned.
long long block_scratch_bytes(int S, int env_words) {
  return (scratch_bytes(S, env_words) + 15) / 16 * 16;
}

struct Params {
  long long pref_thresh_q;
  long long bonus_q;
  long long infeasible_q;
};

__device__ __forceinline__ long long floor_div(long long a, long long b) {
  // b > 0 at every call site.
  long long q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}

// The key of a live slot: score*S_key + its global slot g, or kNoKey when
// it has no room.
__device__ __forceinline__ long long live_key(long long g, int32_t r,
                                              int32_t c, bool ded,
                                              long long S_key,
                                              const Params& p) {
  if (r >= c) return kNoKey;
  const int32_t c1 = c > 1 ? c : 1;
  const long long util =
      (r >= 0 && r < (1 << kUtilShift))
          ? (long long)(((uint32_t)r << kUtilShift) / (uint32_t)c1)
          : floor_div((long long)r * kUtilScale, c1);
  const long long score =
      (ded && util < p.pref_thresh_q) ? util - p.bonus_q : util;
  return score * S_key + g;
}

__device__ __forceinline__ long long floor_mod(long long a, long long b) {
  const long long m = a % b;
  return m < 0 ? m + b : m;
}

// Signed 64-bit minimum over the warp, in every lane: the high words
// (sign-flipped, so unsigned order is signed order), then the low words of
// the lanes holding the least high word.
__device__ __forceinline__ long long warp_min(long long v) {
  const unsigned hi = (unsigned)((unsigned long long)v >> 32) ^ 0x80000000u;
  const unsigned lo = (unsigned)v;
  const unsigned min_hi = __reduce_min_sync(kFull, hi);
  const unsigned min_lo = __reduce_min_sync(kFull, hi == min_hi ? lo : kFull);
  return (long long)(((unsigned long long)(min_hi ^ 0x80000000u) << 32) |
                     min_lo);
}

// Minimum over the block; every thread gets it.  One barrier: `buf` is the
// half of a double buffer this reduction owns, and the caller flips halves
// between reductions, so the next reduction's writes can never meet this
// one's reads.
__device__ __forceinline__ long long block_min(long long v, long long* buf) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_min(v);
  if (lane == 0) buf[warp] = v;
  __syncthreads();
  return warp_min(buf[lane]);
}

// kShared: the per-slot state lives in shared memory (else in the global
// scratch); a compile-time choice, so every access to it is a shared-memory
// instruction, not a generic one.  kTeam: the team mode (block b a slice).
template <bool kShared, bool kTeam>
__global__ void __launch_bounds__(kThreads, 1) assign_batch_kernel(
    const uint8_t* __restrict__ alive, const int32_t* __restrict__ capacity,
    const int32_t* __restrict__ running_in,
    const uint8_t* __restrict__ dedicated, const int32_t* __restrict__ version,
    const int32_t* __restrict__ env_bitmap, int env_words,
    const int32_t* __restrict__ t_env, const int32_t* __restrict__ t_minv,
    const int32_t* __restrict__ t_req, const uint8_t* __restrict__ t_valid,
    int S, int T, Params p, int avoid_self, int32_t* __restrict__ picks_out,
    int32_t* __restrict__ running_out, uint8_t* global_scratch,
    long long env_offset, long long block_scratch, long long* work_out,
    team::Args team_args) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ long long red_buf[2][kWarps];
  __shared__ int32_t s_env[kTaskChunk], s_minv[kTaskChunk], s_req[kTaskChunk];
  __shared__ uint8_t s_valid[kTaskChunk];
  __shared__ long long team_got[kTeam ? 2 * team::kMaxSlices *
                                          team::kMaxPayload : 1];
  __shared__ int team_fail;

  // This block's slice: its slots start at `so` in every per-slot array of
  // the card's part, and at global slot `gbase`; keys count S_key slots.
  const int slice = kTeam ? team_args.ids[blockIdx.x] : 0;
  const long long so = kTeam ? (long long)blockIdx.x * S : 0;
  const long long gbase = (long long)slice * S;
  const long long S_key = kTeam ? (long long)team_args.n_slices * S : S;
  team::Block tb{0u, &team_fail, team_got};
  if (kTeam && threadIdx.x == 0) team_fail = 0;  // read after a barrier

  uint8_t* my_scratch = global_scratch + blockIdx.x * block_scratch;
  uint8_t* base = kShared ? smem : my_scratch;
  long long* key = reinterpret_cast<long long*>(base);
  int32_t* run = reinterpret_cast<int32_t*>(key + S);
  int32_t* ver = run + S;
  int32_t* cap = ver + S;
  uint8_t* ded = reinterpret_cast<uint8_t*>(cap + S);
  // The bitmap transposed, [E, S]: written and read by each slot's owner
  // only, so plain (not read-only-cache) loads see the writes.
  int32_t* env_t = reinterpret_cast<int32_t*>(my_scratch + env_offset);

  const int tid = threadIdx.x;

  for (int s = tid; s < S; s += kThreads) {
    const int32_t r = running_in[so + s], c = capacity[so + s];
    const bool d = dedicated[so + s] != 0;
    run[s] = r;
    ver[s] = version[so + s];
    cap[s] = c;
    ded[s] = d;
    key[s] = alive[so + s] ? live_key(gbase + s, r, c, d, S_key, p) : kNoKey;
    for (int w = 0; w < env_words; ++w)
      env_t[(long long)w * S + s] =
          env_bitmap[(so + s) * env_words + w];
  }

  // A feasible key with score >= infeasible_q grants nothing.
  const long long no_grant_from = p.infeasible_q * S_key;
  long long best = kNoKey;  // this thread's least eligible key
  int best_slot = -1;
  uint32_t elig_bits = 0;   // eligibility of this thread's first 32 slots
  long long gmin = kNoKey;  // the block's least eligible key
  // The current descriptor, and its environment column (null: all ones).
  int d_env = 0, d_minv = 0, d_req = -1, bit = 0;
  const int32_t* col = nullptr;
  bool have_desc = false, prev_granted = false, owned_grant = false;
  long long n_changes = 0, n_rescans = 0, n_reductions = 0;
  int half = 0;  // which half of red_buf the next reduction uses

  // Both scans walk this thread's slots in groups of kGroup, branch-free
  // inside a group (the per-slot work is predicated, so a lone owner
  // thread runs a short straight line).
  auto take = [&](bool e, int s) {
    const long long k = e ? key[s] : kNoKey;
    const bool lower = k < best;
    best = lower ? k : best;
    best_slot = lower ? s : best_slot;
  };
  // Tests every slot of a group against the descriptor; the group's
  // column words are all requested before the first is used.
  auto test_group = [&](int s0, int i0, bool keep_bits) {
    int32_t w[kGroup];
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      const int s = s0 + j * kThreads;
      w[j] = s >= S ? 0 : col != nullptr ? col[s] : -1;
    }
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      const int s = s0 + j * kThreads;
      const bool e = ((w[j] >> bit) & 1) != 0 &&
                     ver[s < S ? s : 0] >= d_minv &&
                     !(avoid_self && gbase + s == d_req);
      take(e, s);
      if (keep_bits) elig_bits |= (uint32_t)e << (i0 + j);
    }
  };
  // A descriptor change: every slot tested, the first 32 slots'
  // eligibility kept in elig_bits.
  auto full_scan = [&]() {
    best = kNoKey;
    best_slot = -1;
    elig_bits = 0;
    for (int s0 = tid, i0 = 0; s0 < S; s0 += kGroup * kThreads, i0 += kGroup)
      test_group(s0, i0, i0 < kMaskSlots);
  };
  // The owner's rescan after its grant: eligibility is unchanged, so the
  // first 32 slots read only their keys, under elig_bits.
  auto rescan = [&]() {
    best = kNoKey;
    best_slot = -1;
    for (int s0 = tid, i0 = 0; s0 < S;
         s0 += kGroup * kThreads, i0 += kGroup) {
      if (i0 < kMaskSlots) {
#pragma unroll
        for (int j = 0; j < kGroup; ++j)
          take(((elig_bits >> (i0 + j)) & 1u) != 0, s0 + j * kThreads);
      } else {
        test_group(s0, i0, false);
      }
    }
  };

  for (int t0 = 0; t0 < T; t0 += kTaskChunk) {
    // Stage the chunk's descriptors in shared memory: each task then reads
    // them at shared-memory latency, not a global load's.  The first
    // barrier lets the previous chunk's last reads finish.
    const int n = T - t0 < kTaskChunk ? T - t0 : kTaskChunk;
    __syncthreads();
    for (int j = tid; j < n; j += kThreads) {
      s_env[j] = t_env[t0 + j];
      s_minv[j] = t_minv[t0 + j];
      s_req[j] = t_req[t0 + j];
      s_valid[j] = t_valid[t0 + j];
    }
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      const int env = s_env[j], minv = s_minv[j], req = s_req[j];
      // Uniform over the block: every thread sees the same descriptors and
      // the same grants, so every thread takes the same branch.
      bool reduce = true;
      if (!have_desc || env != d_env || minv != d_minv || req != d_req) {
        d_env = env;
        d_minv = minv;
        d_req = req;
        const int word = env >> 5;
        bit = env & 31;
        // A word index in [-E, 0) wraps; one outside [-E, E) reads all
        // ones.
        col = (word >= -env_words && word < env_words)
                  ? env_t +
                        (long long)(word < 0 ? word + env_words : word) * S
                  : nullptr;
        have_desc = true;
        full_scan();
        ++n_changes;
      } else if (prev_granted) {
        // Only the granted slot's key moved: its owner alone rescans.
        if (owned_grant) rescan();
        ++n_rescans;
      } else {
        reduce = false;  // nothing moved: the minimum stands
      }
      if (reduce) {
        gmin = block_min(best, red_buf[half]);
        half ^= 1;
        ++n_reductions;
        if constexpr (kTeam) {
          // The team's least key: every slice's, least taken in every
          // block, so every block holds the same winner.
          bool ok;
          const long long* got =
              team::exchange(team_args, tb, slice, &gmin, 1, &ok);
          if (!ok) return;
          long long m = got[0];
          for (int k = 1; k < team_args.n_slices; ++k)
            m = got[k] < m ? got[k] : m;
          gmin = m;
        }
      }
      const bool granted = s_valid[j] != 0 && gmin < no_grant_from;
      // Keys are unique over the team, so when a grant is made exactly
      // one thread of one block owns it.
      owned_grant = granted && best == gmin;
      if (owned_grant) {
        const int s = best_slot;
        const int32_t r = run[s] + 1;
        run[s] = r;
        key[s] = live_key(gbase + s, r, cap[s], ded[s] != 0, S_key, p);
        if (!kTeam) picks_out[t0 + j] = s;
      } else if (!kTeam && !granted && tid == 0) {
        picks_out[t0 + j] = -1;
      }
      if (kTeam && blockIdx.x == 0 && tid == 0)
        picks_out[t0 + j] = granted ? (int32_t)floor_mod(gmin, S_key) : -1;
      prev_granted = granted;
    }
  }

  for (int s = tid; s < S; s += kThreads) running_out[so + s] = run[s];
  if (work_out != nullptr && blockIdx.x == 0 && tid == 0) {
    work_out[0] = n_changes;
    work_out[1] = n_rescans;
    work_out[2] = n_reductions;
  }
}

// The exchange alone: `rounds` exchanges of one word by the blocks of one
// team launch, each block's word the one it read from the next slice the
// round before.  It times the exchange's round trip at a team's size, the
// part of the team kernels' bound that is not their own work
// (chip_smoke.py, phase 22a).
__global__ void __launch_bounds__(kThreads, 1) team_rounds_kernel(
    int rounds, team::Args team_args, long long* out) {
  __shared__ long long team_got[2 * team::kMaxSlices * team::kMaxPayload];
  __shared__ int team_fail;
  team::Block tb{0u, &team_fail, team_got};
  if (threadIdx.x == 0) team_fail = 0;
  __syncthreads();
  const int slice = team_args.ids[blockIdx.x];
  long long v = slice;
  for (int r = 0; r < rounds; ++r) {
    bool ok;
    const long long* got = team::exchange(team_args, tb, slice, &v, 1, &ok);
    if (!ok) return;
    v = got[(slice + 1) % team_args.n_slices];
  }
  if (threadIdx.x == 0) out[blockIdx.x] = v;
}

// A cooperative launch of `kernel` on n_blocks blocks of kThreads.
template <typename... KernelArgs, typename... Args>
int launch_team(void (*kernel)(KernelArgs...), int n_blocks, int dyn,
                void* stream, Args... args) {
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
  cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The exchange's part of a team launch's arguments.
team::Args team_args(int n_blocks, const int* ids, int n_slices,
                     void* exchange, long long epoch, long long spin_limit) {
  team::Args t{};
  t.buf = (unsigned long long*)exchange;
  t.epoch = epoch;
  t.spin_limit = spin_limit;
  t.n_slices = n_slices;
  for (int b = 0; b < n_blocks; ++b) t.ids[b] = ids[b];
  return t;
}

// Shared-memory plan of one block: whether the per-slot state fits beside
// the static shared memory (the exchange's included in a team), and the
// dynamic bytes; returns a CUDA error or 0.
int plan(int S, bool team_mode, bool* use_shared, int* dyn) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  int optin = 0;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (err != cudaSuccess) return (int)err;
  const long long need = slot_bytes(S);
  const long long stat =
      kStaticSmem + (team_mode ? team::kSharedBytes : 0) + 16;
  *use_shared = need <= (long long)optin - stat;
  *dyn = *use_shared ? (int)need : 0;
  return 0;
}

}  // namespace

extern "C" {

// Bytes of the global scratch for a pool of S slots and E bitmap words: the
// per-slot state (used when it does not fit in shared memory) and the
// transposed bitmap.  A team launch takes one such region a block.
long long yadcc_assign_batch_scratch_bytes(int S, int env_words) {
  return block_scratch_bytes(S, env_words);
}

// Launches K2 on `stream`.  `work_out` (int64[3], or null) receives the
// descriptor changes, owner rescans and block reductions of the call.
// Returns cudaGetLastError() after the launch (0 = launched); the caller
// raises on anything else.
int yadcc_assign_batch(const void* alive, const void* capacity,
                       const void* running_in, const void* dedicated,
                       const void* version, const void* env_bitmap,
                       int env_words, const void* t_env, const void* t_minv,
                       const void* t_req, const void* t_valid, int S, int T,
                       long long pref_thresh_q, long long bonus_q,
                       long long infeasible_q, int avoid_self,
                       void* picks_out, void* running_out,
                       void* global_scratch, void* work_out, void* stream) {
  bool use_shared = false;
  int dyn = 0;
  int e = plan(S, false, &use_shared, &dyn);
  if (e != 0) return e;
  auto kernel = use_shared ? assign_batch_kernel<true, false>
                           : assign_batch_kernel<false, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, dyn);
  if (err != cudaSuccess) return (int)err;
  Params p{pref_thresh_q, bonus_q, infeasible_q};
  team::Args none{};
  kernel<<<1, kThreads, dyn, (cudaStream_t)stream>>>(
      (const uint8_t*)alive, (const int32_t*)capacity,
      (const int32_t*)running_in, (const uint8_t*)dedicated,
      (const int32_t*)version, (const int32_t*)env_bitmap, env_words,
      (const int32_t*)t_env, (const int32_t*)t_minv, (const int32_t*)t_req,
      (const uint8_t*)t_valid, S, T, p, avoid_self, (int32_t*)picks_out,
      (int32_t*)running_out, (uint8_t*)global_scratch, slot_bytes(S),
      block_scratch_bytes(S, env_words), (long long*)work_out, none);
  return (int)cudaGetLastError();
}

// Launches K2's team mode on `stream`: n_blocks slices of S slots each,
// laid one after another in every per-slot array (this card's part), block
// b the team's slice ids[b] of n_slices; `exchange` the team's buffer,
// `epoch` this launch's number, `spin_limit` the bound of every wait in
// clock cycles.  The picks (int32[T], global slots) are written by block 0.
// Returns cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for a team the kernel cannot take; the caller
// raises on anything but 0.
int yadcc_assign_batch_team(
    const void* alive, const void* capacity, const void* running_in,
    const void* dedicated, const void* version, const void* env_bitmap,
    int env_words, const void* t_env, const void* t_minv, const void* t_req,
    const void* t_valid, int S, int T, long long pref_thresh_q,
    long long bonus_q, long long infeasible_q, int avoid_self,
    void* picks_out, void* running_out, void* global_scratch, int n_blocks,
    const int* ids, int n_slices, void* exchange, long long epoch,
    long long spin_limit, void* stream) {
  if (n_blocks < 1 || n_blocks > n_slices || n_slices > team::kMaxSlices ||
      (long long)n_blocks * S > 0x7fffffffLL || epoch < 1)
    return (int)cudaErrorInvalidValue;
  bool use_shared = false;
  int dyn = 0;
  int e = plan(S, true, &use_shared, &dyn);
  if (e != 0) return e;
  auto kernel = use_shared ? assign_batch_kernel<true, true>
                           : assign_batch_kernel<false, true>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, dyn);
  if (err != cudaSuccess) return (int)err;
  Params p{pref_thresh_q, bonus_q, infeasible_q};
  team::Args t = team_args(n_blocks, ids, n_slices, exchange, epoch,
                           spin_limit);
  return launch_team(
      kernel, n_blocks, dyn, stream, (const uint8_t*)alive,
      (const int32_t*)capacity, (const int32_t*)running_in,
      (const uint8_t*)dedicated, (const int32_t*)version,
      (const int32_t*)env_bitmap, env_words, (const int32_t*)t_env,
      (const int32_t*)t_minv, (const int32_t*)t_req, (const uint8_t*)t_valid,
      S, T, p, avoid_self, (int32_t*)picks_out, (int32_t*)running_out,
      (uint8_t*)global_scratch, slot_bytes(S),
      block_scratch_bytes(S, env_words), (long long*)nullptr, t);
}

// Launches `rounds` exchanges alone on n_blocks blocks (slices ids[b] of
// n_slices), writing each block's last word to out[b] (int64); returns as
// yadcc_assign_batch_team does.
int yadcc_team_rounds(int rounds, void* out, int n_blocks, const int* ids,
                      int n_slices, void* exchange, long long epoch,
                      long long spin_limit, void* stream) {
  if (n_blocks < 1 || n_blocks > n_slices || n_slices > team::kMaxSlices ||
      rounds < 0 || epoch < 1)
    return (int)cudaErrorInvalidValue;
  team::Args t = team_args(n_blocks, ids, n_slices, exchange, epoch,
                           spin_limit);
  return launch_team(team_rounds_kernel, n_blocks, 0, stream, rounds, t,
                     (long long*)out);
}

void* yadcc_team_alloc(long long bytes) { return team::alloc(bytes); }

void yadcc_team_free(void* p) { cudaFreeHost(p); }

}  // extern "C"
