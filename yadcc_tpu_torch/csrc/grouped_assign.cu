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
// per step; the work is a SERIAL chain of G x (22 + a few) block-wide
// reductions, each of which must finish before the next bisect step can
// choose its midpoint.  So the design is latency-first:
//   * one launch, one thread block of 1024 threads: the groups are serial,
//     and a single block keeps every reduction inside one SM (no grid-wide
//     synchronisation, no second pass);
//   * the per-slot state the bisect reads every step (running, max(cap,1),
//     the group's available grants, the dedicated flag) lives in shared
//     memory for the whole call, 13 bytes a slot; `running` stays there
//     between groups.  A pool too large for shared memory keeps the same
//     arrays in a global scratch buffer the wrapper allocates (same code
//     through a generic pointer), so any S is served;
//   * thread t owns slots t, t+1024, ... throughout, so slot state needs no
//     synchronisation; only the sums do (warp shuffles, then one shared
//     word per warp);
//   * the tie split is a block exclusive prefix scan of the at-tau counts,
//     tile by tile in slot order (the TPU kernel ran a second bisect only
//     because Mosaic could not lower cumsum).
//
// Integer traps, all mirrored from the plain version:
//   * floor, not truncation: ((x+1)*cap-1) // UTIL_SCALE has a negative
//     numerator whenever tau < 0, and so can (lo+hi) // 2; C++ `/` truncates,
//     which would count a phantom grant at running 0 — floor_div below;
//   * the product is taken in int64: at tau = -bonus_q-1 it reaches -2^31
//     already at cap 8192;
//   * the environment bitmap arrives as the int32 bit pattern of the uint32
//     words; an arithmetic shift reads the same bit after `& 1`.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr long long kUtilScale = 65536;  // models/cost.py UTIL_SCALE
constexpr int kSearchIters = 22;         // ops/assignment_grouped.py _SEARCH_ITERS
constexpr int kSlotBytes = 13;           // run, cap1, avail (int32) + ded (u8)

__device__ __forceinline__ long long floor_div(long long a, long long b) {
  // b > 0 at every call site.
  long long q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}

struct SlotState {
  int32_t* run;     // running, carried across groups
  int32_t* cap1;    // max(capacity, 1)
  int32_t* avail;   // this group's grantable count (0 when ineligible)
  uint8_t* ded;     // dedicated flag
};

struct Params {
  long long pref_thresh_q;
  long long bonus_q;
};

// Grants k < avail with u(k) = (run+k)*U // cap1 <= x.
__device__ __forceinline__ long long ks_with_u_leq(long long x, long long cap1,
                                                   long long run,
                                                   long long avail) {
  long long hi = floor_div((x + 1) * cap1 - 1, kUtilScale);
  long long k = hi - run + 1;
  k = k < 0 ? 0 : k;
  return k < avail ? k : avail;
}

__device__ __forceinline__ long long count_leq(long long tau, long long cap1,
                                               long long run, long long avail,
                                               bool ded, const Params& p) {
  long long plain = ks_with_u_leq(tau, cap1, run, avail);
  if (!ded) return plain;
  long long pref_total = ks_with_u_leq(p.pref_thresh_q - 1, cap1, run, avail);
  long long x = tau + p.bonus_q;
  if (x > p.pref_thresh_q - 1) x = p.pref_thresh_q - 1;
  long long pref_cap = ks_with_u_leq(x, cap1, run, avail);
  long long plain_above = plain - pref_total;
  plain_above = plain_above < 0 ? 0 : plain_above;
  return (pref_cap < pref_total ? pref_cap : pref_total) + plain_above;
}

// Sum over the block; every thread gets the total.  The leading barrier
// keeps a fast warp from overwriting `buf` while a slow one still reads
// the previous call's partials.
__device__ long long block_sum(long long v, long long* buf) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) buf[warp] = v;
  __syncthreads();
  long long total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) total += buf[w];
  return total;
}

// Exclusive prefix sum over the block in thread order; *tile_total gets
// the block's sum.
__device__ long long block_exclusive_scan(long long v, long long* buf,
                                          long long* tile_total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  long long incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    long long n = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += n;
  }
  __syncthreads();
  if (lane == 31) buf[warp] = incl;
  __syncthreads();
  long long before = 0, total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    long long t = buf[w];
    before += (w < warp) ? t : 0;
    total += t;
  }
  *tile_total = total;
  return before + incl - v;
}

__global__ void __launch_bounds__(kThreads, 1) grouped_assign_kernel(
    const uint8_t* __restrict__ alive, const int32_t* __restrict__ capacity,
    const int32_t* __restrict__ running_in, const uint8_t* __restrict__ dedicated,
    const int32_t* __restrict__ version, const int32_t* __restrict__ env_bitmap,
    int env_words, const int32_t* __restrict__ g_env,
    const int32_t* __restrict__ g_minv, const int32_t* __restrict__ g_req,
    const int32_t* __restrict__ g_count, int S, int G, Params p, int avoid_self,
    int32_t* __restrict__ counts_out, int32_t* __restrict__ running_out,
    uint8_t* global_scratch, int use_shared) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ long long red_buf[kWarps];

  uint8_t* base = use_shared ? smem : global_scratch;
  SlotState st;
  st.run = reinterpret_cast<int32_t*>(base);
  st.cap1 = st.run + S;
  st.avail = st.cap1 + S;
  st.ded = reinterpret_cast<uint8_t*>(st.avail + S);

  const int tid = threadIdx.x;
  const int tiles = (S + kThreads - 1) / kThreads;

  for (int s = tid; s < S; s += kThreads) {
    st.run[s] = running_in[s];
    int32_t c = capacity[s];
    st.cap1[s] = c > 1 ? c : 1;
    st.ded[s] = dedicated[s] ? 1 : 0;
  }

  const long long lo0 = -p.bonus_q - 1;
  const long long hi0 = kUtilScale + 1;

  for (int g = 0; g < G; ++g) {
    const int env = g_env[g];
    const int word = env >> 5;
    const int bit = env & 31;
    const int minv = g_minv[g];
    const int req = g_req[g];
    const long long m = g_count[g];

    // Group setup: eligibility folds into avail.
    for (int s = tid; s < S; s += kThreads) {
      bool has_env = false;
      if (word >= 0 && word < env_words) {
        int32_t w = env_bitmap[(long long)s * env_words + word];
        has_env = ((w >> bit) & 1) != 0;
      }
      bool eligible = alive[s] && has_env && version[s] >= minv &&
                      !(avoid_self && s == req);
      long long a = (long long)capacity[s] - st.run[s];
      st.avail[s] = eligible ? (int32_t)(a > 0 ? a : 0) : 0;
    }

    long long lo = lo0, hi = hi0;
    for (int it = 0; it < kSearchIters; ++it) {
      const long long mid = floor_div(lo + hi, 2);
      long long part = 0;
      for (int s = tid; s < S; s += kThreads)
        part += count_leq(mid, st.cap1[s], st.run[s], st.avail[s],
                          st.ded[s] != 0, p);
      const long long total = block_sum(part, red_buf);
      if (total >= m) hi = mid; else lo = mid;
    }
    const long long tau = hi;

    long long part_below = 0;
    for (int s = tid; s < S; s += kThreads)
      part_below += count_leq(tau - 1, st.cap1[s], st.run[s], st.avail[s],
                              st.ded[s] != 0, p);
    const long long need_at = m - block_sum(part_below, red_buf);

    // Tie split, tile by tile in slot order: slot s = tile*1024 + tid is
    // exactly the slot this thread owns, so `run` updates stay private.
    long long carry = 0;
    int32_t* row = counts_out + (long long)g * S;
    for (int t = 0; t < tiles; ++t) {
      const int s = t * kThreads + tid;
      long long below = 0, at = 0;
      if (s < S) {
        const long long c1 = st.cap1[s], r = st.run[s], a = st.avail[s];
        const bool d = st.ded[s] != 0;
        below = count_leq(tau - 1, c1, r, a, d, p);
        at = count_leq(tau, c1, r, a, d, p) - below;
      }
      long long tile_total;
      const long long before = carry + block_exclusive_scan(at, red_buf,
                                                            &tile_total);
      carry += tile_total;
      if (s < S) {
        long long take = need_at - before;
        take = take < 0 ? 0 : take;
        take = take < at ? take : at;
        const int32_t c = (int32_t)(below + take);
        row[s] = c;
        st.run[s] += c;
      }
    }
  }

  for (int s = tid; s < S; s += kThreads) running_out[s] = st.run[s];
}

}  // namespace

extern "C" {

// Bytes of per-slot state; the wrapper sizes the global scratch with it.
long long yadcc_grouped_assign_scratch_bytes(int S) {
  return (long long)S * kSlotBytes;
}

// Launches K1 on `stream`.  Returns cudaGetLastError() after the launch
// (0 = launched); the caller raises on anything else.
int yadcc_grouped_assign(const void* alive, const void* capacity,
                         const void* running_in, const void* dedicated,
                         const void* version, const void* env_bitmap,
                         int env_words, const void* g_env, const void* g_minv,
                         const void* g_req, const void* g_count, int S, int G,
                         long long pref_thresh_q, long long bonus_q,
                         int avoid_self, void* counts_out, void* running_out,
                         void* global_scratch, void* stream) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  int optin = 0;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (err != cudaSuccess) return (int)err;
  const long long need = (long long)S * kSlotBytes;
  // Leave room for the kernel's static shared memory (the reduction words).
  const int use_shared = need <= (long long)optin - 1024 ? 1 : 0;
  const int dyn = use_shared ? (int)need : 0;
  err = cudaFuncSetAttribute(grouped_assign_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, dyn);
  if (err != cudaSuccess) return (int)err;
  Params p{pref_thresh_q, bonus_q};
  grouped_assign_kernel<<<1, kThreads, dyn, (cudaStream_t)stream>>>(
      (const uint8_t*)alive, (const int32_t*)capacity,
      (const int32_t*)running_in, (const uint8_t*)dedicated,
      (const int32_t*)version, (const int32_t*)env_bitmap, env_words,
      (const int32_t*)g_env, (const int32_t*)g_minv, (const int32_t*)g_req,
      (const int32_t*)g_count, S, G, p, avoid_self, (int32_t*)counts_out,
      (int32_t*)running_out, (uint8_t*)global_scratch, use_shared);
  return (int)cudaGetLastError();
}

}  // extern "C"
