#!/usr/bin/env python3
"""K1 (yadcc_tpu_torch/csrc/grouped_assign.cu) beside another version of
its source, on one NVIDIA card.

    python3 chip_k1_ab.py OTHER.cu [ROUNDS]

Builds this checkout's grouped_assign.cu and OTHER.cu (e.g. the parent
commit's, unpacked with `git archive`), one nvcc each, started together,
and times one launch of each on phase 2's three K1 pools of chip_smoke.py
(the timing pool at G=8 and G=64, the serving-like pool at G=64; S=8192,
2048 tasks), in turns other, this, this, other, ROUNDS times (default 3),
50 launches a turn with CUDA events.  Both libraries launch on the same
inputs into the same outputs, and their counts and running are held equal
before any is timed.  OTHER.cu may be a version from before the shard
grid, whose entry point takes no shard count: the script reads which from
its source.  Prints the card's name and power limit, one line a pool, and
one "K1AB {json}" line with every turn's time.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import chip_smoke as c


def build_other(path: Path) -> Path:
    from yadcc_tpu_torch.ops import _build

    src = path.read_bytes()
    out = _build.BUILD_DIR / (
        f"libk1_other_{hashlib.sha256(src).hexdigest()[:12]}.so")
    if not out.exists():
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        proc = subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-o",
                               str(out), str(path)], capture_output=True,
                              text=True)
        c.check(proc.returncode == 0,
                f"nvcc failed for {path}:\n{proc.stdout}\n{proc.stderr}")
    return out


def entry(lib: ctypes.CDLL, sharded: bool):
    """lib's launch as f(pool, groups, counts, running, scratch) -> error,
    on the current stream, over one pool."""
    import torch

    from yadcc_tpu_torch.models.cost import DEFAULT_COST_MODEL as cm

    fn = lib.yadcc_grouped_assign
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = ([p] * 6 + [i] + [p] * 4 + [i, i] + [i] * sharded
                   + [ll, ll, i, p, p, p, p])
    fn.restype = ctypes.c_int
    lib.yadcc_grouped_assign_scratch_bytes.argtypes = [i]
    lib.yadcc_grouped_assign_scratch_bytes.restype = ll

    def launch(pool, groups, counts, running, scratch):
        s, g = pool.alive.shape[0], groups[0].shape[0]
        return fn(pool.alive.data_ptr(), pool.capacity.data_ptr(),
                  pool.running.data_ptr(), pool.dedicated.data_ptr(),
                  pool.version.data_ptr(), pool.env_bitmap.data_ptr(),
                  pool.env_bitmap.shape[1], *(a.data_ptr() for a in groups),
                  s, g, *((1,) if sharded else ()),
                  int(cm.dedicated_preference_utilization_q),
                  int(cm.preference_bonus_q), int(bool(cm.avoid_self)),
                  counts.data_ptr(), running.data_ptr(), scratch.data_ptr(),
                  torch.cuda.current_stream().cuda_stream)

    return launch, lib.yadcc_grouped_assign_scratch_bytes


def main() -> int:
    import numpy as np
    import torch

    from yadcc_tpu_torch.ops import _build
    from yadcc_tpu_torch.ops import assignment as asn
    from yadcc_tpu_torch.ops import assignment_grouped as asg
    from yadcc_tpu_torch.ops import cuda_grouped as kg

    c.check(torch.cuda.is_available(), "no CUDA device")
    other = Path(sys.argv[1]).resolve()
    rounds = int(sys.argv[2]) if len(sys.argv) > 2 else 3
    print(c.card_line(), flush=True)
    with ThreadPoolExecutor(2) as ex:
        this_so, other_so = ex.map(lambda f: f(), (
            lambda: _build.build(kg.SOURCE), lambda: build_other(other)))
    signature = re.search(r"int yadcc_grouped_assign\(([^)]*)\)",
                          other.read_text())
    c.check(signature is not None, f"{other}: no yadcc_grouped_assign")
    builds = {
        "this": entry(ctypes.CDLL(str(this_so)), True),
        "other": entry(ctypes.CDLL(str(other_so)),
                       "n_shards" in signature.group(1)),
    }

    dev = torch.device("cuda")
    # phase 2's pools and batches, drawn as time_kernel draws them.
    rng = np.random.default_rng(7)
    p = c.np_pool(rng, c.MAIN_S, cap_lo=8, cap_hi=65, run_hi=8, ded_frac=0.2)
    pool = asn.pool_from_numpy(*(p[k] for k in asn.PoolArrays._fields), dev)
    sp = c.serving_pool(np.random.default_rng(8))
    spool = asn.pool_from_numpy(*(sp[k] for k in asn.PoolArrays._fields),
                                dev)
    cases = (
        ("timing_G8", pool, c.seeded_groups(rng, 8, c.MAIN_TASKS, c.MAIN_S),
         8),
        ("timing_G64", pool,
         c.seeded_groups(rng, c.MAIN_G, c.MAIN_TASKS, c.MAIN_S), c.MAIN_G),
        ("serving_like_G64", spool,
         c.serving_groups(np.random.default_rng(9), c.MAIN_G, c.MAIN_TASKS),
         c.MAIN_G),
    )
    out = {}
    for name, pt, groups, pad in cases:
        batch = asg.make_grouped_batch(groups, pad, dev)
        gs = [getattr(batch, f) for f in kg.GROUP_FIELDS]
        counts = torch.empty((pad, c.MAIN_S), dtype=torch.int32, device=dev)
        running = torch.empty(c.MAIN_S, dtype=torch.int32, device=dev)
        results = {}
        calls = {}
        for which, (launch, scratch_bytes) in builds.items():
            scratch = torch.empty(max(1, scratch_bytes(c.MAIN_S)),
                                  dtype=torch.uint8, device=dev)
            calls[which] = (lambda launch=launch, scratch=scratch: launch(
                pt, gs, counts, running, scratch))
            counts.fill_(-7)
            running.fill_(-7)
            c.check(calls[which]() == 0, f"{which}: launch failed")
            torch.cuda.synchronize()
            results[which] = (counts.cpu(), running.cpu())
        c.check(all(torch.equal(a, b) for a, b in
                    zip(results["this"], results["other"])),
                f"{name}: the two builds' counts or running differ")
        turns = []
        for _ in range(rounds):
            for which in ("other", "this", "this", "other"):
                turns.append((which, c.timed(calls[which], 50)))
        mean = {w: float(np.mean([ms for t, ms in turns if t == w]))
                for w in builds}
        out[name] = dict(turns=turns, mean_ms=mean,
                         this_over_other=mean["this"] / mean["other"])
        print(f"  {name} S={c.MAIN_S} G={pad} tasks={c.MAIN_TASKS}: this "
              f"{mean['this']:.4f} ms, other {mean['other']:.4f} ms "
              f"(this/other {mean['this'] / mean['other']:.4f}); turns "
              + ", ".join(f"{w} {ms:.4f}" for w, ms in turns), flush=True)
    print("K1AB " + json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
