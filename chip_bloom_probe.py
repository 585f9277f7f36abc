#!/usr/bin/env python3
"""Where the Bloom kernels' time goes (yadcc_tpu_torch/csrc/bloom.cu), on
one NVIDIA card.

    python3 chip_bloom_probe.py [OTHER.cu]

Builds the source as it is and probes of it, each with one part changed,
and times them on the bench's batches at 1% and 50% hits (1M
production-format keys of 80 bytes against a 1M-key filter of 27,584,639
bits and 10 hashes, as tools/bloom_bench.py makes them) and on 1M of the
JAX bench's 23-byte keys: the membership and cascade kernels from the
keys, the probe kernel from their fingerprints; and the scatter-OR build
of the filter from its 1M members' fingerprints.

* kernel        the source as it is;
* staging_only  rows staged and read as the digest reads them, folded by
                XOR, no digest and no probe (its verdicts are wrong on
                purpose): the row stream's own cost;
* digest_only   staged rows and XXH64, no probe (wrong on purpose);
* no_hints      the full kernels with both L2 policies evict-normal;
* probe_l1      the full kernel with every probe confined to the filter's
                first 4 KB (wrong on purpose): what the probes would cost
                if they hit in L1;
* min_blocks8   the full kernel with staged rows compiled for 8 blocks
                an SM (at most 32 registers a thread);
* direct_min1   the full kernel with rows read from global memory
                compiled without a minimum of blocks an SM;
* unstaged      the full kernel with every row read from global memory,
                as rows the kernel does not stage are (no shared memory);
* group2, group4, group8
                the full kernel with that many probe loads issued
                together (independent loads, their bits ANDed) in place of
                the chained probe;
* probe_mod     the probe loop with `% num_bits` in place of mod_bits;
* probe_min1    the probe kernel compiled without a minimum of blocks an
                SM (no 32-register cap);
* probe_cg, probe_l1na
                the filter's words loaded past L1 (ld.global.cg) or without
                allocating in L1 (.L1::no_allocate), both evict-last in L2;
* scatter_atomic
                the scatter-OR's alternative design: the words copied to
                the output, then one thread a key ORing its probe bits in
                with fire-and-forget global reductions (red.global.or);
* scatter_bin_only, scatter_own_only
                the binned scatter-OR's pass (a) alone (its result wrong on
                purpose), and pass (b) alone on the scratch and table the
                kernel build left;
* place_chained the placement kernel with each key's probes chained
                (probe_h, stopping at the first zero bit) in place of its
                loads issued together;
* place_no_probe, place_no_digest, place_no_ticket
                the placement kernel without its probes (a digest bit for
                the verdict), with a one-word mix in place of the digest,
                and without the fence and ticket (every block scores):
                all wrong on purpose, what each part costs.

The placement kernel of the kernel, place_chained and other builds is
timed (CUDA events over 50 warm launches on one staged input, each
build's result held against the host oracle) at chip_smoke.py's two
shapes, a spill decision (7 cells, 32 keys of 80 bytes, T = 1, the
production geometry) and 8 cells x 256 keys x 8 tasks, beside an empty
one-block launch; a first-version OTHER (two launches, the score then its
argmin, from device pointers) is fed the same staged bytes.

The binned scatter-OR of the kernel build is also timed with slices half
and twice the plan's size (the plan is the wrapper's argument, no other
build), and on a batch whose every probe falls in one slice.

OTHER.cu, when given, is another version of bloom.cu (e.g. the parent
commit's, unpacked with `git archive`), built and timed beside these as
"other", so two designs compare on one card.  Its scatter-OR may take the
first version's arguments (the words ORed in place): it is then timed
with the copy of the words its wrapper made.  Every build whose verdicts
are meant to be right is held against the host filter before it is
timed.  A small kernel measures the card's rate of random 32-byte L2
sector reads (one 4-byte load a sector of the filter's 3.4 MB, evict-last,
16 independent loads a thread; through L1 as the kernels load, and past
it); each batch's probes evaluated over the first rate are the "L2 floor"
of the membership, cascade and probe kernels.
Prints ptxas's registers, shared memory and spills for every kernel of
the kernel and other builds (for the variants, the kernels they change),
then one JSON line a build and batch.  Needs nvcc and a card; exits 2
otherwise.
"""

from __future__ import annotations

import ctypes
import json
import pathlib
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

REPO = pathlib.Path(__file__).resolve().parent
OUT = REPO / "yadcc_tpu_torch" / "_build" / "bloom_probe"
# Builds whose membership and cascade kernels are timed (the probe-only
# and scatter-only variants leave them as in "kernel").
PROBE_ONLY = ("probe_mod", "probe_min1", "probe_cg", "probe_l1na")
SCATTER_ONLY = ("scatter_atomic", "scatter_bin_only", "scatter_own_only")
PLACE_ONLY = ("place_chained", "place_no_probe", "place_no_digest",
              "place_no_ticket")
INEXACT_PLACE = ("place_no_probe", "place_no_digest", "place_no_ticket")
# The placement kernel's probe call, its fence and ticket, and the same with
# every block taken for the last (right only for a one-block grid, and
# only when the block's adds happen to have landed: timing alone).
PLACE_PROBE = "        probe_together(f, "
PLACE_PROBE_ARGS = ("(uint32_t)d, (uint32_t)(d >> 32) | 1u,\n"
                    "                       policy_evict_last()))")
PLACE_TICKET = ("    __threadfence();\n"
                "    last = atomicAdd(a.ticket, 1u) == gridDim.x - 1;\n"
                "    __threadfence();\n")
PLACE_NO_TICKET = "    last = true;\n"
PLACE = ("kernel", *PLACE_ONLY, "other")
INEXACT = ("staging_only", "digest_only", "probe_l1", "scatter_bin_only")
CASCADE = ("kernel", "no_hints", "min_blocks8", "direct_min1", "unstaged",
           "other")
PROBE = ("kernel", "no_hints", *PROBE_ONLY, "other")
SCATTER = ("kernel", *SCATTER_ONLY, "other")
# The chained probe loop of bloom.cu:probe_h, and the same probes issued
# in groups of G independent loads whose bits are ANDed.
CHAINED = """\
  for (int i = 0; i < f.num_hashes; ++i, x += h2) {
    const uint32_t idx = mod_bits(x, f.magic, f.num_bits);
    if (!((load_word(f.words + (idx >> 5), keep) >> (idx & 31u)) & 1u))
      return false;
  }
"""
GROUPED = """\
  for (int i = 0; i < f.num_hashes; i += GROUP) {
    uint32_t w[GROUP], b[GROUP];
#pragma unroll
    for (int j = 0; j < GROUP; ++j, x += h2) {
      w[j] = 1u;
      b[j] = 0u;
      if (i + j < f.num_hashes) {
        const uint32_t idx = mod_bits(x, f.magic, f.num_bits);
        w[j] = load_word(f.words + (idx >> 5), keep);
        b[j] = idx & 31u;
      }
    }
    uint32_t all = 1u;
#pragma unroll
    for (int j = 0; j < GROUP; ++j) all &= w[j] >> b[j];
    if (!(all & 1u)) return false;
  }
"""
# The scatter-OR's alternative: copy, then one thread a key with global
# reductions.  Inserted before the end of bloom.cu's anonymous namespace.
SCATTER_ATOMIC = """\
__global__ void __launch_bounds__(kThreads)
scatter_atomic_kernel(Filter f, const uint32_t* __restrict__ fps, bool pairs,
                      int n, uint32_t* __restrict__ out) {
  const int k = blockIdx.x * kThreads + threadIdx.x;
  if (k >= n) return;
  const uint2 fp = load_fingerprint(fps, k, pairs, policy_evict_first());
  uint32_t x = fp.x;
  for (int i = 0; i < f.num_hashes; ++i, x += fp.y) {
    const uint32_t idx = mod_bits(x, f.magic, f.num_bits);
    asm volatile("red.global.or.b32 [%0], %1;"
                 ::"l"(out + (idx >> 5)), "r"(1u << (idx & 31u))
                 : "memory");
  }
}

int launch_scatter_atomic(const void* words, void* out,
                          unsigned int num_bits, int num_hashes,
                          const void* fingerprints, int n, void*, void*, int,
                          int, int, int, cudaStream_t stream) {
  const size_t bytes = (((unsigned long long)num_bits + 31) / 32) * 4;
  int err = (int)cudaMemcpyAsync(out, words, bytes,
                                 cudaMemcpyDeviceToDevice, stream);
  if (err != 0) return err;
  scatter_atomic_kernel<<<blocks_for(n), kThreads, 0, stream>>>(
      filter(nullptr, num_bits, num_hashes, 0),
      (const uint32_t*)fingerprints, eight_byte_aligned(fingerprints), n,
      (uint32_t*)out);
  return (int)cudaGetLastError();
}

}  // namespace
"""
# The card's random-sector L2 read rate, by load instruction.
L2_LOADS = 16
LOAD_NC = "ld.global.nc.L2::cache_hint.u32"
L2_LOADS_BY = {"l2_nc": LOAD_NC, "l2_cg": "ld.global.cg.L2::cache_hint.u32",
               "l2_l1na": "ld.global.nc.L1::no_allocate.L2::cache_hint.u32"}
L2_SOURCE = f"""\
#include <cuda_runtime.h>
#include <stdint.h>

// {L2_LOADS} loads a thread, each one 4-byte load of a random 32-byte
// sector of `buf` (evict-last, through L1 as the Bloom kernels load), all
// independent: the addresses come from a xorshift chain, not from loads.
__global__ void __launch_bounds__(256)
l2_sectors(const uint32_t* buf, uint32_t sectors, uint32_t* out,
           uint32_t seed) {{
  uint64_t keep;
  asm volatile("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;"
               : "=l"(keep));
  const uint32_t t = blockIdx.x * blockDim.x + threadIdx.x;
  uint32_t h = (t + 1) * 0x9E3779B9u ^ seed, acc = 0;
#pragma unroll
  for (int i = 0; i < {L2_LOADS}; ++i) {{
    h ^= h << 13;
    h ^= h >> 17;
    h ^= h << 5;
    uint32_t v;
    asm volatile("LOAD %0, [%1], %2;"
                 : "=r"(v)
                 : "l"(buf + 8ull * __umulhi(h, sectors)), "l"(keep));
    acc ^= v;
  }}
  if (acc == seed) out[t] = acc;
}}

extern "C" int l2_sector_reads(const void* buf, unsigned int sectors,
                               void* out, int threads, unsigned int seed,
                               void* stream) {{
  l2_sectors<<<threads / 256, 256, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)buf, sectors, (uint32_t*)out, seed);
  return (int)cudaGetLastError();
}}
"""
L2_THREADS = 1 << 20


def variants(src: str) -> dict:
    def cut(s, old, new, times=1):
        if s.count(old) != times:
            raise RuntimeError(f"probe anchor not found {times}x: {old!r}")
        return s.replace(old, new)

    verdict = "    out[first + t] = member(f, row, length, keep);\n"
    fold = ("    out[first + t] = [&] {\n"
            "      uint64_t x = 0, l[4];\n"
            "      int pos = 0;\n"
            "      for (; pos + 32 <= length; pos += 32) {\n"
            "        row.stripe(pos, l);\n"
            "        x ^= l[0] ^ l[1] ^ l[2] ^ l[3];\n"
            "      }\n"
            "      for (; pos + 8 <= length; pos += 8) x ^= row.lane(pos);\n"
            "      return (x & 1u) != 0;\n"
            "    }();\n")
    bounds = "kStaged ? 1 : 8"
    probe_bounds = "__launch_bounds__(kThreads, 8)\nprobe_kernel"
    return {
        "kernel": src,
        "staging_only": cut(src, verdict, fold),
        "digest_only": cut(src, verdict, "    out[first + t] = "
                           "(xxh64_row(row, length, f.seed) & 1u) != 0;\n"),
        "no_hints": cut(src, "constexpr bool kL2Hints = true;",
                        "constexpr bool kL2Hints = false;"),
        "probe_l1": cut(src, "load_word(f.words + (idx >> 5), keep)",
                        "load_word(f.words + ((idx >> 5) & 1023), keep)"),
        "min_blocks8": cut(src, bounds, "kStaged ? 8 : 8", 2),
        "direct_min1": cut(src, bounds, "kStaged ? 1 : 1", 2),
        "unstaged": cut(src, "bool staged(int row_words) {\n",
                        "bool staged(int row_words) {\n  return false;\n"),
        **{f"group{g}": cut(src, CHAINED, GROUPED.replace("GROUP", str(g)))
           for g in (2, 4, 8)},
        "probe_mod": cut(src, "mod_bits(x, f.magic, f.num_bits);\n    if",
                         "x % f.num_bits;\n    if"),
        "probe_min1": cut(src, probe_bounds,
                          "__launch_bounds__(kThreads)\nprobe_kernel"),
        **{f"probe_{k[3:]}": cut(src, LOAD_NC, L2_LOADS_BY[k])
           for k in ("l2_cg", "l2_l1na")},
        "scatter_atomic": cut(
            cut(src, "}  // namespace\n", SCATTER_ATOMIC),
            "  return launch_scatter(", "  return launch_scatter_atomic("),
        "scatter_bin_only": cut(src, "    scatter_own_kernel<Entry><<<",
                                "    if (false) scatter_own_kernel<Entry><<<"),
        "scatter_own_only": cut(src, "    scatter_bin_kernel<Entry><<<",
                                "    if (false) scatter_bin_kernel<Entry><<<"),
        "place_chained": cut(src, PLACE_PROBE, "        probe_h(f, "),
        "place_no_probe": cut(src, PLACE_PROBE + PLACE_PROBE_ARGS,
                              "        ((d & 1u) != 0))"),
        "place_no_digest": cut(src, "    const uint64_t d = xxh64_row(row, "
                               "a.length, f.seed);",
                               "    const uint64_t d = f.seed ^ (uint64_t)"
                               "row.word(0) * kP1;"),
        "place_no_ticket": cut(src, PLACE_TICKET, PLACE_NO_TICKET),
    }


KERNEL_NAMES = ("membership_kernel", "cascade_kernel", "probe_kernel",
                "scatter_bin_kernel", "scatter_own_kernel",
                "scatter_atomic_kernel", "placement_score_kernel",
                "placement_argmin_kernel", "placement_kernel")


def ptxas_lines(stderr: str) -> list:
    """(kernel, resource line) for the Bloom kernels."""
    out, fn = [], None
    for line in stderr.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?(\w+)", line)
        if m:
            fn = m.group(1)
            continue
        name = next((k for k in KERNEL_NAMES if fn and k in fn), None)
        if name and ("registers" in line or "spill" in line):
            name = name.replace("_kernel", "")
            staged = re.search(r"ILb([01])E", fn)
            if staged:
                name += {"1": "<staged>", "0": "<global>"}[staged.group(1)]
            entry = re.search(r"scatter_\w+_kernelI([tj])E", fn)
            if entry:
                name += {"t": "<u16>", "j": "<u32>"}[entry.group(1)]
            out.append(f"{name}: {line.strip()}")
    return out


def build(name: str, src: str) -> tuple:
    from yadcc_tpu_torch.ops import _build

    OUT.mkdir(parents=True, exist_ok=True)
    cu, lib = OUT / f"{name}.cu", OUT / f"lib{name}.so"
    cu.write_text(src)
    proc = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS,
                           "-Xptxas", "-v", "-o", str(lib), str(cu)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stderr}")
    return name, ptxas_lines(proc.stderr)


def l2_sector_rate(words, name: str) -> dict:
    """Random 32-byte sector reads a second from the L2-resident ``words``
    (the filter) by build ``name`` of L2_SOURCE, best of five timed runs
    after a warm one."""
    import torch

    import chip_smoke as c

    lib = ctypes.CDLL(str(OUT / f"lib{name}.so"))
    fn = lib.l2_sector_reads
    fn.argtypes = [ctypes.c_void_p, ctypes.c_uint, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_uint, ctypes.c_void_p]
    sectors = words.numel() // 8
    sink = torch.empty(L2_THREADS, dtype=torch.int32, device=words.device)

    def call():
        err = fn(words.data_ptr(), sectors, sink.data_ptr(), L2_THREADS, 7,
                 torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"l2_sectors: CUDA error {err}")

    ms = min(c.timed(call, 20) for _ in range(5))
    loads = L2_THREADS * L2_LOADS
    return {"ms": ms, "loads": loads, "sectors_in_buffer": sectors,
            "sectors_per_s": loads / (ms * 1e-3)}


def main(argv: list) -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_bloom_probe: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as c
    from yadcc_tpu_torch.common import bloom
    from yadcc_tpu_torch.ops import bloom_pipeline as bpl
    from yadcc_tpu_torch.ops import cuda_bloom as kb
    from yadcc_tpu_torch.tools.bloom_bench import (FLEET_HASHES, FLEET_SALT,
                                                   SALT, production_keys)

    print(c.card_line(), flush=True)
    srcs = variants((REPO / "yadcc_tpu_torch" / "csrc" / kb.SOURCE)
                    .read_text())
    if argv:
        srcs["other"] = pathlib.Path(argv[0]).read_text()
    jobs = {**srcs, **{k: L2_SOURCE.replace("LOAD", v)
                       for k, v in L2_LOADS_BY.items()}}
    with ThreadPoolExecutor(len(jobs)) as ex:
        for name, info in ex.map(lambda kv: build(*kv), jobs.items()):
            for line in info:
                if name in ("kernel", "other") or line.startswith(
                        ("membership<", "probe", "scatter_atomic")) or (
                        name in PLACE_ONLY and line.startswith("placement")):
                    print(name, line, flush=True)
    for name in PLACE:
        if name in srcs:
            for line in time_placement(name, srcs[name]):
                print(name, line, flush=True)

    dev = torch.device("cuda")
    n = c.BLOOM_N
    members = production_keys(n, seed=1)
    region = bloom.SaltedBloomFilter(salt=SALT)
    region.add_many(members)
    fleet_only = production_keys(n // 2, seed=2)
    fleet = bloom.SaltedBloomFilter(num_hashes=FLEET_HASHES,
                                    salt=FLEET_SALT)
    fleet.add_many(fleet_only + members[:n // 10])
    nb, k = region.num_bits, region.num_hashes
    nw = region.words.shape[0]
    words = bpl.as_device_words(region.words, dev)
    fwords = bpl.as_device_words(fleet.words, dev)
    seed = kb._seed64(bpl.seed_pair(SALT))
    fseed = kb._seed64(bpl.seed_pair(FLEET_SALT))
    for name in L2_LOADS_BY:
        rate = l2_sector_rate(words, name)
        print("l2 random sector reads", name, json.dumps(rate), flush=True)
        if name == "l2_nc":
            l2 = rate

    def batch(keys):
        ((length, _, packed_np),) = bpl.pack_key_buckets(keys)
        want = region.may_contain_batch(keys)
        fps = bloom.key_fingerprints(keys, SALT)
        per_key, _ = c.probes_needed(region.words, fps, nb, k)
        per_key_f, _ = c.probes_needed(
            fleet.words, bloom.key_fingerprints(keys, FLEET_SALT), nb,
            FLEET_HASHES)
        probes = int(per_key.sum())
        cascade_probes = probes + int(per_key_f[~want].sum())
        floor = {"probes": probes, "cascade_probes": cascade_probes,
                 "l2_floor_ms": probes / l2["sectors_per_s"] * 1e3,
                 "cascade_l2_floor_ms":
                     cascade_probes / l2["sectors_per_s"] * 1e3}
        return (length, bpl.as_device_words(packed_np, dev), want,
                want | fleet.may_contain_batch(keys),
                bpl.as_device_words(fps, dev),
                c.membership_bound(n, packed_np.shape[1] * 4, nw, length,
                                   per_key), floor)

    batches = {f"hits {rate}": batch(c.hit_batch(members, fleet_only, n,
                                                 rate, bseed))
               for rate, bseed in ((0.01, 300), (0.5, 302))}
    # The JAX bench's 23-byte keys (no stripe loop), nearly all absent.
    batches["23 bytes"] = batch([f"ytpu-cxx2-entry-{i:07d}"
                                 for i in range(n)])
    for name, b in batches.items():
        print("l2 floor", name, json.dumps(b[-1]), flush=True)

    # The build: the members' fingerprints into a zero filter, and a batch
    # whose every probe falls in one slice of the plan.
    mfps = bpl.as_device_words(bloom.key_fingerprints(members, SALT), dev)
    zeros = torch.zeros_like(words)
    plan = kb.scatter_plan(nb, k, n)
    rng = np.random.default_rng(73)
    slice_bits = 32 << plan.slice_shift
    step = slice_bits // (4 * k)
    one_slice = bpl.as_device_words(np.stack([
        (plan.slices // 2) * slice_bits
        + rng.integers(0, slice_bits - k * step, n, dtype=np.uint64),
        rng.integers(0, step, n, dtype=np.uint64)], axis=1)
        .astype(np.uint32), dev)
    scatter_bound = c.bloom_bound(n * 8 + 2 * nw * 4,
                                  n * k * c.BLOOM_PROBE_OPS)

    P, I, U, ULL = (ctypes.c_void_p, ctypes.c_int, ctypes.c_uint,
                    ctypes.c_ulonglong)
    stream = torch.cuda.current_stream().cuda_stream
    for name, src in srcs.items():
        lib = ctypes.CDLL(str(OUT / f"lib{name}.so"))
        mem = lib.yadcc_bloom_membership
        mem.argtypes = [P, U, I, ULL, P, I, I, I, P, P]
        cas = lib.yadcc_bloom_cascade
        cas.argtypes = [P, I, ULL, P, I, ULL, U, P, I, I, I, P, P]
        prb = lib.yadcc_bloom_probe
        prb.argtypes = [P, U, I, P, I, P, P]
        for batch_name, (length, packed, want, want_c, fps, bound,
                         floor) in batches.items():
            out = torch.empty(n, dtype=torch.bool, device=dev)

            def run(fn, *args):
                err = fn(*args)
                if err != 0:
                    raise RuntimeError(f"{name}: CUDA error {err}")

            def call_mem():
                run(mem, words.data_ptr(), nb, k, seed, packed.data_ptr(),
                    packed.shape[1], length, n, out.data_ptr(), stream)

            def call_cas():
                run(cas, words.data_ptr(), k, seed, fwords.data_ptr(),
                    FLEET_HASHES, fseed, nb, packed.data_ptr(),
                    packed.shape[1], length, n, out.data_ptr(), stream)

            def call_prb():
                run(prb, words.data_ptr(), nb, k, fps.data_ptr(), n,
                    out.data_ptr(), stream)

            rec = {}
            if name not in PROBE_ONLY + SCATTER_ONLY + PLACE_ONLY:
                call_mem()
                if name not in INEXACT:
                    c.check(np.array_equal(out.cpu().numpy(), want),
                            f"{name}: membership differs from the host "
                            f"filter on {batch_name}")
                rec["ms"] = c.timed(call_mem, 50)
                rec["share_of_bound"] = bound["bound_ms"] / rec["ms"]
                rec["bound_ms"] = bound["bound_ms"]
            if name in CASCADE:
                call_cas()
                c.check(np.array_equal(out.cpu().numpy(), want_c),
                        f"{name}: cascade differs from the host OR on "
                        f"{batch_name}")
                rec["cascade_ms"] = c.timed(call_cas, 50)
            if name in PROBE:
                call_prb()
                c.check(np.array_equal(out.cpu().numpy(), want),
                        f"{name}: probe differs from the host filter on "
                        f"{batch_name}")
                rec["probe_ms"] = c.timed(call_prb, 50)
            if rec:
                rec.update(floor)
                print(name, batch_name, json.dumps(rec), flush=True)
        if name in SCATTER:
            for line in time_scatter(name, src, words, zeros, mfps,
                                     one_slice, plan, region.words,
                                     scatter_bound):
                print(name, line, flush=True)
    return 0


def time_scatter(name, src, words, zeros, mfps, one_slice, plan,
                 want, bound) -> list:
    """The build's scatter-OR on the members' fingerprints into zeros,
    held against the host filter and timed (for the binned design also
    with other slice sizes and on the one-slice batch)."""
    import numpy as np
    import torch

    import chip_smoke as c
    from yadcc_tpu_torch.ops import bloom_probe as bpr
    from yadcc_tpu_torch.ops import cuda_bloom as kb

    P, I, U = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
    nb, k, n = 27_584_639, 10, mfps.shape[0]
    stream = torch.cuda.current_stream().cuda_stream
    out = torch.empty_like(words)

    def check(err):
        if err != 0:
            raise RuntimeError(f"{name}: scatter CUDA error {err}")

    if "void* scratch" not in src:
        # The first version: ORs into the words in place; its wrapper
        # copied them first.
        fn = ctypes.CDLL(str(OUT / f"lib{name}.so")).yadcc_bloom_scatter_or
        fn.argtypes = [P, U, I, P, I, P]

        def call():
            out.copy_(zeros)
            check(fn(out.data_ptr(), nb, k, mfps.data_ptr(), n, stream))

        plans = {"as wrapped (copy + kernel)": (call, mfps)}
    else:
        def caller(build, p, fps):
            lib = ctypes.CDLL(str(OUT / f"lib{build}.so"))
            fn = lib.yadcc_bloom_scatter_or
            fn.argtypes = [P, P, U, I, P, I, P, P, I, I, I, I, P]
            # One scratch and table a plan, shared by the builds.
            scratch, table = _BUFFERS.setdefault(p, (
                torch.empty(p.segments * kb.BIN_PROBES, dtype=torch.int32,
                            device=words.device),
                torch.empty((p.slices + 1) * p.segments, dtype=torch.int32,
                            device=words.device)))
            return lambda: check(fn(
                zeros.data_ptr(), out.data_ptr(), nb, k, fps.data_ptr(), n,
                scratch.data_ptr(), table.data_ptr(), p.slice_shift,
                p.keys_per_thread, p.hash_chunk, p.segments, stream))

        if name == "scatter_own_only":
            # Pass (b) on the scratch and table of the members' pass (a).
            caller("kernel", plan, mfps)()
        plans = {f"slices {plan.slices}": (caller(name, plan, mfps), mfps)}
        if name == "kernel":
            nw = -(-nb // 32)
            for shift in (plan.slice_shift - 1, plan.slice_shift + 1):
                p = plan._replace(slice_shift=shift,
                                  slices=-(-nw // (1 << shift)))
                plans[f"slices {p.slices}"] = (caller(name, p, mfps), mfps)
            plans["one-slice batch"] = (caller(name, plan, one_slice),
                                        one_slice)
    lines = []
    for what, (call, fps) in plans.items():
        call()
        got = out.cpu().numpy().view(np.uint32)
        if name in INEXACT:
            pass
        elif fps is mfps:
            c.check(np.array_equal(got, want),
                    f"{name}: scatter ({what}) differs from add_many")
        else:
            c.check(np.array_equal(got, bpr.scatter_add_plain(
                zeros, fps, nb, k).cpu().numpy().view(np.uint32)),
                f"{name}: scatter ({what}) differs from its plain version")
        ms = c.timed(call, 50 if fps is mfps else 3)
        lines.append(f"scatter_or {what} " + json.dumps(
            {"ms": ms, "bound_ms": bound["bound_ms"],
             "share_of_bound": bound["bound_ms"] / ms}))
    return lines


_BUFFERS: dict = {}


def time_placement(name: str, src: str) -> list:
    """Build ``name``'s placement kernel on chip_smoke.time_placement's
    two inputs (the same seed), staged once into a slot's device input:
    its result against the host oracle, then its time and an empty
    launch's (the kernel build's), CUDA events over 50 warm launches."""
    import numpy as np
    import torch

    import chip_smoke as c
    from yadcc_tpu_torch.ops import cuda_bloom as kb

    P, I, U = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
    lib = ctypes.CDLL(str(OUT / f"lib{name}.so"))
    one_launch = "yadcc_placement_launch" in src
    if one_launch:
        fn = lib.yadcc_placement_launch
        fn.argtypes = [P, P, P, P, P, I, P]
    else:
        fn = lib.yadcc_placement_score
        fn.argtypes = [P, I, U, I, P, P, I, P, P, I, I, I, I, I, I, I, P, P,
                       P, P]
    empty = ctypes.CDLL(str(OUT / "libkernel.so")).yadcc_empty_launch
    empty.argtypes = [P]
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    rng = np.random.default_rng(111)
    lines = []
    for shape, (c_n, n, t_n) in (("path", c.PLACE_PATH),
                                 ("wide", c.PLACE_WIDE)):
        args, kw, want, _, _ = c.placement_case(
            rng, c_n, t_n, n, 80, *c.PLACE_GEOMETRIES[0], dev)
        want = np.concatenate([w.reshape(-1) for w in want])
        slot = kb.PlacementSlot(dev)
        lay = kb.placement_pack(slot, [0 if w is None else w.data_ptr()
                                       for w in args[0]], *args[1:], **kw)
        slot.dev_in[:lay.in_bytes].copy_(slot.host_in[:lay.in_bytes])
        slot.dev_out.zero_()
        host_in, dev_in, _, dev_out, scratch, ticket = slot._ptrs

        def at(off):
            return dev_in + off

        def call():
            if one_launch:
                err = fn(host_in, dev_in, dev_out, scratch, ticket,
                         slot.device.index, stream)
            else:
                err = fn(at(kb.PLACE_TABLE), c_n, kw["num_bits"],
                         kw["num_hashes"], at(lay.off_terms),
                         at(lay.off_counts), t_n, at(lay.off_task),
                         at(lay.off_packed), lay.row_words, kw["length"],
                         lay.n, kw["warm_scale"], kw["w_warm"],
                         kw["w_load"], kw["w_topo"], dev_out,
                         dev_out + 4 * c_n * t_n,
                         dev_out + 4 * (c_n * t_n + t_n), stream)
            if err != 0:
                raise RuntimeError(f"{name} placement: CUDA error {err}")

        exact = name not in INEXACT_PLACE
        call()
        torch.cuda.synchronize()
        c.check(not exact or np.array_equal(
            slot.dev_out[:want.size].cpu().numpy(), want),
                f"{name}: placement differs from the host oracle ({shape})")
        ms = c.timed(call, 50)
        torch.cuda.synchronize()
        c.check(not exact or np.array_equal(
            slot.dev_out[:want.size].cpu().numpy(), want),
                f"{name}: placement after 50 launches ({shape})")
        floor = c.timed(lambda: empty(stream), 50)
        lines.append(f"placement {shape} C {c_n} N {n} T {t_n} " + json.dumps(
            {"ms": ms, "launch_floor_ms": floor,
             "launches_a_call": 1 if one_launch else 2}))
    return lines


if __name__ == "__main__":
    sys.path.insert(0, str(REPO))
    sys.exit(main(sys.argv[1:]))
