// The cross-slice exchange of the team-mode kernels (K1 and K2 over a team,
// yadcc_tpu_torch/parallel/mesh.py), for Hopper (sm_90a).
//
// Replaces the collectives of the JAX package's shard_map bodies
// (yadcc_tpu/parallel/mesh.py: the pmin pair of sharded_assign_fn, the
// psums of _make_sharded_group_step).  A team launch is one launch a card
// and one block a slice; at every cross-slice step each block posts a few
// 64-bit words and reads every slice's words back, in slice order, and
// reduces them itself (a sum, a min, a prefix), so every block computes
// the same result from the same words and takes the same branch after it.
//
// One design: the exchange lives in mapped pinned host memory (the wrapper
// allocates it with yadcc_team_alloc), which every card reaches with or
// without peer access, so one card and several run the same code.  Slot
// (launch parity, round parity, slice) holds a generation word and up to
// kMaxPayload payload words.  The poster writes the payload with
// st.relaxed.sys and then the generation with st.release.sys; a reader
// loads the generation with ld.acquire.sys until it equals (epoch << 32) |
// round, then the payload with ld.relaxed.sys: the PTX memory model's
// message passing at system scope.  No read-modify-write touches host
// memory (a PCIe host need not support them).
//
// Where trouble lies, and how it is met:
//   * Deadlock.  A block that waits for another needs that block running.
//     N blocks of one launch on one card are made co-resident by launching
//     them cooperatively (cudaLaunchAttributeCooperative; the launch fails,
//     it does not hang, when they cannot all be resident), each at one
//     block an SM.  N single-block launches on N streams would carry no
//     such guarantee, so the slices of one card are never split over
//     launches.  Across cards it is one launch a card, every one issued
//     before the host waits on any.
//   * Every wait is bounded.  A spin that runs past `spin_limit` clock
//     cycles writes kErrSpin into the error word (word 0) and the block
//     leaves the kernel; a block that sees the error word set leaves too,
//     so every block of every card ends within about one bound.  The
//     wrapper raises on the word (ops/team_exchange.py); nothing hangs.
//   * Reuse without a reset.  Generations carry the launch's epoch, which
//     rises launch to launch, so a stale slot never matches.  Rounds
//     alternate between two slot rows: a block posts round r+2 only after
//     every slice posted round r+1, which each did only after reading
//     round r.  Launches alternate between two row pairs: a card can begin
//     launch L+1 while another card still reads launch L's last round, but
//     it cannot complete L+1's first round before that card posts it.
//   * Every slice must take the same path.  Each decision that follows an
//     exchange is made from the exchanged words, never from a slice's own
//     data alone, and a round counter in each block numbers the exchanges;
//     a slice that took a different number of rounds would wait for a
//     generation nobody posts and end on the bound, not in silence.
//
// What bounds an exchange: latency.  A post is two posted PCIe writes; a
// read is one PCIe round trip (about a microsecond), made for all slices at
// once by N threads.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace team {

constexpr int kMaxSlices = 64;           // ops/team_exchange.py MAX_SLICES
constexpr int kSlotWords = 4;            // generation + payload
constexpr int kMaxPayload = kSlotWords - 1;
constexpr int kHeaderWords = 8;          // word 0: the error word
constexpr unsigned long long kErrSpin = 1;

// What a block needs to take part: the buffer, this launch's epoch, the
// bound, the team's size and the slice of each block of this launch.
struct Args {
  unsigned long long* buf;
  long long epoch;
  long long spin_limit;
  int n_slices;
  int ids[kMaxSlices];
};

__device__ __forceinline__ unsigned long long ld_acquire_sys(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.sys.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ unsigned long long ld_relaxed_sys(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.sys.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_relaxed_sys(unsigned long long* p,
                                               unsigned long long v) {
  asm volatile("st.relaxed.sys.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ void st_release_sys(unsigned long long* p,
                                               unsigned long long v) {
  asm volatile("st.release.sys.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

// A block's state in the exchange: its round counter, the fault flag
// (shared), and two rows of received words (shared, by round parity).
struct Block {
  unsigned round;
  int* fail;
  long long* got;  // 2 x kMaxSlices * kMaxPayload
};

// Block-wide: post `nvals` words (thread 0's `vals`) as this slice's part
// of the next round and wait for every slice's part.  With *ok true, the
// returned row holds slice k's word j at [k * nvals + j] for every slice,
// for every thread.  *ok false: a wait ran out or another block faulted;
// the caller leaves the kernel at once (uniformly: the flag is read after
// a barrier).
__device__ __forceinline__ const long long* exchange(const Args& t,
                                                     Block& b, int slice,
                                                     const long long* vals,
                                                     int nvals, bool* ok) {
  const unsigned r = b.round++;
  const unsigned long long gen =
      ((unsigned long long)t.epoch << 32) | (unsigned long long)r;
  unsigned long long* row =
      t.buf + kHeaderWords +
      (long long)(((t.epoch & 1) * 2 + (r & 1)) * kMaxSlices) * kSlotWords;
  long long* got = b.got + (r & 1) * kMaxSlices * kMaxPayload;
  if (threadIdx.x == 0) {
    unsigned long long* mine = row + (long long)slice * kSlotWords;
    for (int j = 0; j < nvals; ++j)
      st_relaxed_sys(mine + 1 + j, (unsigned long long)vals[j]);
    st_release_sys(mine, gen);
  }
  if ((int)threadIdx.x < t.n_slices) {
    const unsigned long long* slot = row + (long long)threadIdx.x * kSlotWords;
    const long long start = clock64();
    bool arrived = true;
    while (ld_acquire_sys(slot) != gen) {
      if (ld_relaxed_sys(t.buf) != 0) {
        arrived = false;
        break;
      }
      if (clock64() - start > t.spin_limit) {
        st_relaxed_sys(t.buf, kErrSpin);
        arrived = false;
        break;
      }
    }
    if (arrived) {
      for (int j = 0; j < nvals; ++j)
        got[threadIdx.x * nvals + j] = (long long)ld_relaxed_sys(slot + 1 + j);
    } else {
      *b.fail = 1;
    }
  }
  __syncthreads();
  *ok = *b.fail == 0;
  return got;
}

// The exchange buffer: `bytes` of pinned host memory, mapped into every
// card's address space (unified addressing: one address for the host and
// every card), zeroed.  Null on failure.  Each library that includes this
// header exports it as yadcc_team_alloc, with yadcc_team_free.
inline void* alloc(long long bytes) {
  void* p = nullptr;
  if (cudaHostAlloc(&p, (size_t)bytes,
                    cudaHostAllocMapped | cudaHostAllocPortable) !=
      cudaSuccess)
    return nullptr;
  for (long long i = 0; i < bytes; ++i) ((volatile char*)p)[i] = 0;
  return p;
}

// Shared memory a team block keeps for the exchange (Block's arrays).
constexpr long long kSharedBytes =
    2LL * kMaxSlices * kMaxPayload * sizeof(long long) + sizeof(int);

}  // namespace team
