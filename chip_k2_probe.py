#!/usr/bin/env python3
"""Where a task's time goes in K2 (yadcc_tpu_torch/csrc/assign_batch.cu), on
one NVIDIA card.

    python3 chip_k2_probe.py

Builds the kernel as it is and three probes of it, each with one piece of the
per-task chain cut out, and times each on chip_smoke.py's two K2 timing
batches (S=8192, T=256: the timing pool, a new descriptor every task; the
serving-like pool, two runs of 128 identical descriptors).  The probes' picks
are wrong on purpose: only their times mean anything, and the kernel's own
picks are held against the plain version first.

* kernel      the source as it is;
* no_rescan   the owner's rescan after its grant removed;
* no_key      the granted slot's key recomputation (the division) replaced
              by a constant step;
* chain_only  no scan and no grant: the descriptor reads, one block minimum
              and the grant test a task, the floor of this loop's structure.

Prints ptxas's registers and spills for each build, then one line a build
and batch with ms and us a task.  Needs nvcc and a card; exits 2 otherwise.
"""

from __future__ import annotations

import ctypes
import json
import pathlib
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

REPO = pathlib.Path(__file__).resolve().parent
OUT = REPO / "yadcc_tpu_torch" / "_build" / "k2_probe"


def variants(src: str) -> dict:
    def cut(s, old, new):
        if s.count(old) != 1:
            raise RuntimeError(f"probe anchor not found once: {old!r}")
        return s.replace(old, new)

    rescan = "        if (owned_grant) rescan();\n"
    return {
        "kernel": src,
        "no_rescan": cut(src, rescan, ""),
        "no_key": cut(src, "        key[s] = live_key(s, r, cap[s], ded[s] != 0, "
                      "S, p);", "        key[s] += S;"),
        "chain_only": cut(cut(cut(
            src, "        full_scan();\n", "        best = tid == 0 ? 0 : "
            "kNoKey;\n"), rescan, ""), "      if (owned_grant) {",
            "      if (false) {"),
    }


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
    return name, [line.strip() for line in proc.stderr.splitlines()
                  if "registers" in line or "spill" in line]


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_k2_probe: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as c
    from yadcc_tpu_torch.models.cost import DEFAULT_COST_MODEL as cm
    from yadcc_tpu_torch.ops import assignment as asn
    from yadcc_tpu_torch.ops import cuda_assign as ka

    print(c.card_line(), flush=True)
    srcs = variants((REPO / "yadcc_tpu_torch" / "csrc" / ka.SOURCE)
                    .read_text())
    with ThreadPoolExecutor(len(srcs)) as ex:
        for name, info in ex.map(lambda kv: build(*kv), srcs.items()):
            print(name, "; ".join(info), flush=True)

    dev = torch.device("cuda")
    rng = np.random.default_rng(2027)
    p = c.np_pool(np.random.default_rng(7), c.MAIN_S, cap_lo=8, cap_hi=65,
                  run_hi=8, ded_frac=0.2)
    sp = c.serving_pool(np.random.default_rng(8))
    srng = np.random.default_rng(10)
    runs = [(int(srng.integers(0, c.N_ENVS)), 0,
             int(srng.integers(0, c.N_SERVANTS))) for _ in range(2)]
    batches = {
        "timing": (p, [(int(rng.integers(0, 256)), 1, -1)
                       for _ in range(c.MAIN_T)]),
        "runs": (sp, [runs[0]] * 128 + [runs[1]] * 128)}
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for name in srcs:
        lib = ctypes.CDLL(str(OUT / f"lib{name}.so"))
        fn = lib.yadcc_assign_batch
        fn.argtypes = [P, P, P, P, P, P, I, P, P, P, P, I, I, L, L, L, I,
                       P, P, P, P, P]
        lib.yadcc_assign_batch_scratch_bytes.argtypes = [I, I]
        lib.yadcc_assign_batch_scratch_bytes.restype = L
        for bname, (pn, tasks) in batches.items():
            pool = asn.pool_from_numpy(
                *(pn[k] for k in asn.PoolArrays._fields), dev)
            b = c.k2_batch(tasks, len(tasks), dev)
            s, t, e = c.MAIN_S, len(tasks), pool.env_bitmap.shape[1]
            picks = torch.empty(t, dtype=torch.int32, device=dev)
            run = torch.empty(s, dtype=torch.int32, device=dev)
            scratch = torch.empty(lib.yadcc_assign_batch_scratch_bytes(s, e),
                                  dtype=torch.uint8, device=dev)

            def call():
                err = fn(*(x.data_ptr() for x in pool[:6]), e,
                         *(x.data_ptr() for x in b), s, t,
                         cm.dedicated_preference_utilization_q,
                         cm.preference_bonus_q, cm.infeasible_score_q, 1,
                         picks.data_ptr(), run.data_ptr(), scratch.data_ptr(),
                         None, torch.cuda.current_stream().cuda_stream)
                if err != 0:
                    raise RuntimeError(f"{name}: CUDA error {err}")

            call()
            if name == "kernel":
                want = asn.assign_batch(pool, b, cm)[0]
                c.check(torch.equal(picks.cpu(), want.cpu()),
                        f"kernel build: picks differ on {bname}")
            ms = c.timed(call, 50)
            print(name, bname, json.dumps(
                {"ms": ms, "us_per_task": ms * 1e3 / t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(REPO))
    sys.exit(main())
