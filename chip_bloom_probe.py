#!/usr/bin/env python3
"""Where the Bloom membership kernel's time goes (yadcc_tpu_torch/csrc/
bloom.cu), on one NVIDIA card.

    python3 chip_bloom_probe.py [OTHER.cu]

Builds the source as it is and probes of it, each with one part changed,
and times each build's membership kernel on the bench's batches at 1% and
50% hits (1M production-format keys of 80 bytes against a 1M-key filter of
27,584,639 bits and 10 hashes, as tools/bloom_bench.py makes them) and on
1M of the JAX bench's 23-byte keys:

* kernel        the source as it is;
* staging_only  rows staged and read as the digest reads them, folded by
                XOR, no digest and no probe (its verdicts are wrong on
                purpose): the row stream's own cost;
* digest_only   staged rows and XXH64, no probe (wrong on purpose);
* no_hints      the full kernel with both L2 policies evict-normal;
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
                the chained probe.

OTHER.cu, when given, is another version of bloom.cu with the same C
interface (e.g. the parent commit's, unpacked with `git archive`), built
and timed beside these as "other", so two designs compare on one card.
The exact builds (all but staging_only, digest_only and probe_l1) are held
against the host filter before they are timed.  The cascade kernel of the
builds in CASCADE is timed too.  Prints ptxas's registers, shared memory
and spills for the membership and cascade kernels, then one JSON line a
build and batch with ms and the share of the bytes bound.  Needs nvcc and
a card; exits 2 otherwise.
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
EXACT = ("kernel", "no_hints", "min_blocks8", "direct_min1", "unstaged",
         "group2", "group4", "group8", "other")
CASCADE = ("kernel", "no_hints", "min_blocks8", "direct_min1", "unstaged",
           "other")
# The chained probe loop of bloom.cu:probe_chained, and the same probes
# issued in groups of G independent loads whose bits are ANDed.
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
    }


def ptxas_lines(stderr: str) -> list:
    """(kernel, resource line) for the membership and cascade kernels."""
    out, fn = [], None
    for line in stderr.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?(\w+)", line)
        if m:
            fn = m.group(1)
            continue
        if fn and ("membership_kernel" in fn or "cascade_kernel" in fn) \
                and ("registers" in line or "spill" in line):
            staged = re.search(r"ILb([01])E", fn)
            name = ("membership" if "membership" in fn else "cascade") + \
                ({"1": "<staged>", "0": "<global>"}[staged.group(1)]
                 if staged else "")
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
    with ThreadPoolExecutor(len(srcs)) as ex:
        for name, info in ex.map(lambda kv: build(*kv), srcs.items()):
            for line in info:
                if name in ("kernel", "other") or line.startswith(
                        "membership<"):
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
    batches = {}
    for rate, bseed in ((0.01, 300), (0.5, 302)):
        keys = c.hit_batch(members, fleet_only, n, rate, bseed)
        ((length, _, packed_np),) = bpl.pack_key_buckets(keys)
        want = region.may_contain_batch(keys)
        per_key, _ = c.probes_needed(
            region.words, bloom.key_fingerprints(keys, SALT), nb, k)
        batches[f"hits {rate}"] = (
            length, bpl.as_device_words(packed_np, dev), want,
            want | fleet.may_contain_batch(keys),
            c.membership_bound(n, packed_np.shape[1] * 4, nw, length,
                               per_key))
        del keys
    # The JAX bench's 23-byte keys (no stripe loop), nearly all absent.
    keys = [f"ytpu-cxx2-entry-{i:07d}" for i in range(n)]
    ((length, _, packed_np),) = bpl.pack_key_buckets(keys)
    want = region.may_contain_batch(keys)
    per_key, _ = c.probes_needed(
        region.words, bloom.key_fingerprints(keys, SALT), nb, k)
    batches["23 bytes"] = (
        length, bpl.as_device_words(packed_np, dev), want,
        want | fleet.may_contain_batch(keys),
        c.membership_bound(n, packed_np.shape[1] * 4, nw, length, per_key))

    P, I, U, ULL = (ctypes.c_void_p, ctypes.c_int, ctypes.c_uint,
                    ctypes.c_ulonglong)
    for name in srcs:
        lib = ctypes.CDLL(str(OUT / f"lib{name}.so"))
        mem = lib.yadcc_bloom_membership
        mem.argtypes = [P, U, I, ULL, P, I, I, I, P, P]
        cas = lib.yadcc_bloom_cascade
        cas.argtypes = [P, I, ULL, P, I, ULL, U, P, I, I, I, P, P]
        for batch, (length, packed, want, want_c, bound) in batches.items():
            out = torch.empty(n, dtype=torch.bool, device=dev)

            def call(fn, *args):
                err = fn(*args, packed.data_ptr(), packed.shape[1], length,
                         n, out.data_ptr(),
                         torch.cuda.current_stream().cuda_stream)
                if err != 0:
                    raise RuntimeError(f"{name}: CUDA error {err}")

            def call_mem():
                call(mem, words.data_ptr(), nb, k, seed)

            def call_cas():
                call(cas, words.data_ptr(), k, seed, fwords.data_ptr(),
                     FLEET_HASHES, fseed, nb)

            call_mem()
            if name in EXACT:
                c.check(np.array_equal(out.cpu().numpy(), want),
                        f"{name}: membership differs from the host filter "
                        f"on {batch}")
            ms = c.timed(call_mem, 50)
            rec = {"ms": ms, "share_of_bound": bound["bound_ms"] / ms,
                   "bound_ms": bound["bound_ms"]}
            if name in CASCADE:
                call_cas()
                c.check(np.array_equal(out.cpu().numpy(), want_c),
                        f"{name}: cascade differs from the host OR on "
                        f"{batch}")
                rec["cascade_ms"] = c.timed(call_cas, 50)
            print(name, batch, json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(REPO))
    sys.exit(main(sys.argv[1:]))
