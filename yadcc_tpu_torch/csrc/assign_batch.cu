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
// the pool once (a few hundred KB at S=8192) and does a few dozen integer
// operations per slot per task; the work is a SERIAL chain of T block-wide
// argmin reductions, because each task must see the grant of the one before.
// So the design is latency-first, like K1's:
//   * one launch, one thread block of 1024 threads, the tasks in a loop
//     inside the block (the TPU kernel's sequential grid becomes this loop);
//   * `running` lives in shared memory for the whole call (4 bytes a slot);
//     a pool too large for shared memory keeps it in a global scratch buffer
//     the wrapper allocates, through the same pointer, so any S is served;
//   * each task is one block argmin of the int64 key score*S + slot: the
//     key is unique and orders by (score, slot), so the minimum key is the
//     lowest slot at the minimum score, and negative scores (the dedicated
//     bonus) order correctly; warp shuffles, then one shared word per warp;
//   * thread 0 writes the pick and the `running` increment between the two
//     barriers of each task, so every thread scores the next task against
//     the updated count;
//   * the environment bitmap is read in its [S, E/32] layout: at E=256 a
//     slot's row is one 32-byte sector, so each read is one sector whether
//     or not the layout is transposed (the TPU kernel transposed it only
//     because Mosaic slices the leading axis).
//
// Integer traps, all mirrored from the plain version:
//   * the utilization product is int64 and the division floors (a running
//     count folded below zero never reaches this kernel, but floor keeps the
//     plain version's semantics for any input);
//   * the bitmap arrives as the int32 bit pattern of the uint32 words; an
//     arithmetic shift reads the same bit after `& 1`.  A word index in
//     [-E, 0) wraps to word + E and one outside [-E, E) reads 0xFFFFFFFF,
//     as the JAX device functions' `jnp.take` does.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr long long kUtilScale = 65536;  // models/cost.py UTIL_SCALE
constexpr long long kNoKey = 0x7fffffffffffffffLL;

__device__ __forceinline__ long long floor_div(long long a, long long b) {
  // b > 0 at every call site.
  long long q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
}

struct Params {
  long long pref_thresh_q;
  long long bonus_q;
  long long infeasible_q;
};

__global__ void __launch_bounds__(kThreads, 1) assign_batch_kernel(
    const uint8_t* __restrict__ alive, const int32_t* __restrict__ capacity,
    const int32_t* __restrict__ running_in,
    const uint8_t* __restrict__ dedicated, const int32_t* __restrict__ version,
    const int32_t* __restrict__ env_bitmap, int env_words,
    const int32_t* __restrict__ t_env, const int32_t* __restrict__ t_minv,
    const int32_t* __restrict__ t_req, const uint8_t* __restrict__ t_valid,
    int S, int T, Params p, int avoid_self, int32_t* __restrict__ picks_out,
    int32_t* __restrict__ running_out, int32_t* global_scratch,
    int use_shared) {
  extern __shared__ __align__(16) int32_t smem[];
  __shared__ long long red_buf[kWarps];

  int32_t* run = use_shared ? smem : global_scratch;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;

  for (int s = tid; s < S; s += kThreads) run[s] = running_in[s];
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    const int env = t_env[t];
    const int word = env >> 5;
    const int bit = env & 31;
    // A word index in [-E, 0) wraps; one outside [-E, E) reads all ones.
    const bool word_inside = word >= -env_words && word < env_words;
    const int word_col = word < 0 ? word + env_words : word;
    const int minv = t_minv[t];
    const int req = t_req[t];

    long long best = kNoKey;
    for (int s = tid; s < S; s += kThreads) {
      const int32_t w = word_inside
          ? env_bitmap[(long long)s * env_words + word_col] : -1;
      const bool has_env = ((w >> bit) & 1) != 0;
      const long long r = run[s];
      const long long c = capacity[s];
      const bool feasible = alive[s] && has_env && version[s] >= minv &&
                            !(avoid_self && s == req) && r < c;
      long long score = p.infeasible_q;
      if (feasible) {
        const long long util = floor_div(r * kUtilScale, c > 1 ? c : 1);
        score = (dedicated[s] && util < p.pref_thresh_q) ? util - p.bonus_q
                                                         : util;
      }
      const long long key = score * S + s;
      best = key < best ? key : best;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const long long other = __shfl_down_sync(0xffffffffu, best, o);
      best = other < best ? other : best;
    }
    if (lane == 0) red_buf[warp] = best;
    __syncthreads();
    if (tid == 0) {
      long long key = red_buf[0];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) key = red_buf[w] < key ? red_buf[w] : key;
      const long long score = floor_div(key, S);
      const int slot = (int)(key - score * S);
      const bool granted = score < p.infeasible_q && t_valid[t] != 0;
      picks_out[t] = granted ? slot : -1;
      if (granted) run[slot] += 1;
    }
    // Publishes run[slot] to every thread and frees red_buf for the next
    // task's partials.
    __syncthreads();
  }

  for (int s = tid; s < S; s += kThreads) running_out[s] = run[s];
}

}  // namespace

extern "C" {

// Bytes of the `running` scratch for a pool of S slots; the wrapper sizes
// the global scratch with it.
long long yadcc_assign_batch_scratch_bytes(int S) {
  return (long long)S * (long long)sizeof(int32_t);
}

// Launches K2 on `stream`.  Returns cudaGetLastError() after the launch
// (0 = launched); the caller raises on anything else.
int yadcc_assign_batch(const void* alive, const void* capacity,
                       const void* running_in, const void* dedicated,
                       const void* version, const void* env_bitmap,
                       int env_words, const void* t_env, const void* t_minv,
                       const void* t_req, const void* t_valid, int S, int T,
                       long long pref_thresh_q, long long bonus_q,
                       long long infeasible_q, int avoid_self,
                       void* picks_out, void* running_out,
                       void* global_scratch, void* stream) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  int optin = 0;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (err != cudaSuccess) return (int)err;
  const long long need = yadcc_assign_batch_scratch_bytes(S);
  // Leave room for the kernel's static shared memory (the reduction words).
  const int use_shared = need <= (long long)optin - 1024 ? 1 : 0;
  const int dyn = use_shared ? (int)need : 0;
  err = cudaFuncSetAttribute(assign_batch_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, dyn);
  if (err != cudaSuccess) return (int)err;
  Params p{pref_thresh_q, bonus_q, infeasible_q};
  assign_batch_kernel<<<1, kThreads, dyn, (cudaStream_t)stream>>>(
      (const uint8_t*)alive, (const int32_t*)capacity,
      (const int32_t*)running_in, (const uint8_t*)dedicated,
      (const int32_t*)version, (const int32_t*)env_bitmap, env_words,
      (const int32_t*)t_env, (const int32_t*)t_minv, (const int32_t*)t_req,
      (const uint8_t*)t_valid, S, T, p, avoid_self, (int32_t*)picks_out,
      (int32_t*)running_out, (int32_t*)global_scratch, use_shared);
  return (int)cudaGetLastError();
}

}  // extern "C"
