#!/usr/bin/env python3
"""On-card smoke test of yadcc_tpu_torch, the scheduler's grant path on CUDA.

Run from the root of a checkout on a machine with one NVIDIA card:

    python3 chip_smoke.py

Phases (any failure exits non-zero without printing the result line):

1. card and build: the card's name and power limit, then every kernel
   source built from csrc/ with nvcc, one nvcc per source, all started
   together: the grouped assignment (K1), the sequential scan (K2) and
   the Bloom kernels (bloom.cu);
2. kernels vs plain: K1 and its five wrappers (the resident step chained
   over cycles with churn among them), and K2, held against the plain
   PyTorch versions on the card, exactly (integer arithmetic, so the
   tolerance is 0), on seeded and edge pools; K1's counts and K2's
   (descriptor changes, owner rescans, reductions) held against the host
   models of their designs (k1_model, k2_model); the wrappers must refuse
   tensors the kernels do not take; the kernels' times;
3. main path, pipelined: the scheduler entry with its defaults (auto
   policy, pipeline depth 16 on the card, 8192 slots) on loopback, 5,000
   servants registered by Heartbeat, 24 delegates driving >= 200,000
   grants with WaitForStartingTask(immediate_reqs=128) and FreeTask;
   every grant checked against the servants' facts, no servant over its
   capacity, no duplicate grant id, and kernel launches > 0 (the entry
   sets its launch counts to 0 after its warmup; the script reads 0 from
   /inspect/vars just before driving and the phase's counts just after);
4. main path, synchronous: phase 3 with --dispatch-pipeline-depth 0;
5. the scan policy: phase 4's drive with --dispatch-policy torch_batched,
   every grant through K2 (launches of 256 tasks, one collect a cycle);
6. the device-resident stream: phase 3's drive with --dispatch-policy
   torch_resident_grouped, K1 inside the resident step, the resident
   pool's statics oracle clean;
7. the Bloom path: (a) the four Bloom kernels (membership, cascade,
   probe, scatter-OR) held against their plain versions and the host
   filter at tolerance 0 on an edge pool (every key length 0..34, 63-65,
   80, 100, 200; 1, 257 and 1,000 keys; 64, 1,000 and 27,584,639 bits;
   1, 7 and 10 hashes; salts 0, 17 and 2^63 + 5), the empty batch and the
   refusals; (b, c) the same at the main path's shapes (1M
   production-format keys of 80 bytes, the production geometry; the
   membership also at 23-byte keys), each kernel's time beside its plain
   version's and its bound; (d) the slice's entry point,
   tools/bloom_bench.run(1M, 1M) on the card, with every Bloom launch
   count set to 0 just before and each > 0 just after.

The second-to-last line is the kernels' JSON record, the last line
{"ok": true, "device": {...}}.  Logs of the scheduler processes go to
smoke_logs/.
"""

from __future__ import annotations

import json
import os
import pathlib
import random
import socket
import subprocess
import sys
import threading
import time
import urllib.request

REPO = pathlib.Path(__file__).resolve().parent
LOG_DIR = REPO / "smoke_logs"

N_SERVANTS = 5000
N_ENVS = 64
N_DELEGATES = 24
ENVS_PER_DELEGATE = 16
IMMEDIATE = 128
MIN_GRANTS = 200_000
PHASE_LIMIT_S = 240.0
HB_INTERVAL_MS = 4000          # servant lease = 10x this
HB_REPEAT_S = 10.0             # re-beat well inside the lease
MAIN_S, MAIN_G, MAIN_TASKS = 8192, 64, 2048   # the policy's largest chunk
MAIN_T = 256                   # torch_batched's chunk (max_batch)
H100_BYTES_PER_S = 3.35e12     # HBM3, H100 SXM data sheet
H100_OPS_PER_S = 67e12         # 32-bit non-tensor peak, H100 SXM data sheet
KERNELS = ("grouped_assign", "assign_batch")   # /inspect/vars yadcc/kernels


class SmokeFailure(AssertionError):
    pass


def check(cond, msg) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# Phase 1: card and build.
# ---------------------------------------------------------------------------


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=30)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def build_kernels() -> dict:
    """Every kernel source's library, one nvcc per source started
    together; {source: {library, nvcc_s}} plus the wall time of the whole
    phase."""
    from concurrent.futures import ThreadPoolExecutor

    from yadcc_tpu_torch.ops import (_build, cuda_assign, cuda_bloom,
                                     cuda_grouped)

    sources = (cuda_grouped.SOURCE, cuda_assign.SOURCE, cuda_bloom.SOURCE)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(sources)) as ex:
        paths = list(ex.map(_build.build, sources))
    out = {}
    for source, path in zip(sources, paths):
        _build.load(source)
        out[source] = {"library": str(path.relative_to(REPO)),
                       "nvcc_s": _build.build_seconds[source]}
    out["total_s"] = time.perf_counter() - t0
    return out


# ---------------------------------------------------------------------------
# Phase 2: kernel vs plain.
# ---------------------------------------------------------------------------


def np_pool(rng, s, e_words=8, cap_lo=1, cap_hi=64, run_hi=32,
            ded_frac=0.3):
    import numpy as np

    cap = rng.integers(cap_lo, cap_hi, s).astype(np.int32)
    return dict(
        alive=rng.random(s) < 0.9,
        capacity=cap,
        running=rng.integers(0, run_hi, s).astype(np.int32),
        dedicated=rng.random(s) < ded_frac,
        version=rng.integers(1, 4, s).astype(np.int32),
        env_bitmap=rng.integers(0, 2**32, (s, e_words),
                                dtype=np.uint64).astype(np.uint32),
    )


def seeded_groups(rng, g, total, s):
    """g groups whose counts sum to ~total, env ids over all 256."""
    import numpy as np

    cuts = np.sort(rng.integers(0, total + 1, g - 1))
    counts = np.diff(np.concatenate(([0], cuts, [total])))
    return [(int(rng.integers(0, 256)), int(rng.integers(0, 4)),
             int(rng.integers(-1, s)), int(c)) for c in counts]


def edge_cases(rng):
    """(name, numpy pool, groups) at the corners of the closed form."""
    import numpy as np

    s = MAIN_S
    full = np.full((s, 8), 0xFFFFFFFF, np.uint32)

    def base(**kw):
        p = dict(alive=np.ones(s, bool), capacity=np.full(s, 8, np.int32),
                 running=np.zeros(s, np.int32), dedicated=np.zeros(s, bool),
                 version=np.ones(s, np.int32), env_bitmap=full.copy())
        p.update(kw)
        return p

    out = [
        ("all_ineligible", base(alive=np.zeros(s, bool)),
         [(5, 1, -1, 400), (9, 1, -1, 3)]),
        ("m_above_free",
         base(capacity=rng.integers(0, 3, s).astype(np.int32),
              running=rng.integers(0, 2, s).astype(np.int32)),
         [(1, 1, -1, 100_000), (2, 1, -1, 7)]),
        ("requestor_excluded", base(capacity=np.full(s, 2, np.int32)),
         [(0, 1, 0, 5), (0, 1, 3, 3000), (0, 1, s - 1, 2)]),
    ]
    cap = rng.integers(2, 16, s).astype(np.int32)
    out.append(("dedicated_around_half", base(
        capacity=cap,
        running=(cap // 2 + rng.integers(-1, 2, s)).clip(0).astype(np.int32),
        dedicated=rng.random(s) < 0.5),
        [(7, 1, -1, 900), (7, 1, 4, 500), (8, 1, -1, 2000)]))
    out.append(("tiny_caps_idle_tau_below_zero", base(
        capacity=rng.integers(1, 3, s).astype(np.int32),
        dedicated=rng.random(s) < 0.5),
        [(0, 1, -1, 1), (1, 1, -1, 0), (2, 1, -1, 37)]))
    out.append(("capacity_zero", base(
        capacity=np.where(rng.random(s) < 0.5, 0, 4).astype(np.int32),
        running=np.where(rng.random(s) < 0.2, 1, 0).astype(np.int32)),
        [(3, 1, -1, 1200)]))
    bits = np.zeros((s, 8), np.uint32)
    groups = []
    for w in range(8):
        env = w * 32 + int(rng.integers(0, 32))
        holders = rng.choice(s, 300, replace=False)
        bits[holders, w] |= np.uint32(1 << (env & 31))
        groups.append((env, 1, -1, int(rng.integers(1, 700))))
    out.append(("env_ids_in_every_word",
                base(env_bitmap=bits, capacity=np.full(s, 3, np.int32)),
                groups))
    # Geometry: a partial last tile, a single slot, and a pool too large
    # for shared memory (the kernel's global-scratch route).
    for name, size in (("ragged_tile", 1000), ("one_slot", 1),
                       ("beyond_shared_memory", 70_000)):
        out.append((name, np_pool(rng, size),
                    seeded_groups(rng, 4, min(3 * size, 2048), size)))
    # Groups the kernel skips: every other count 0, then the padding that
    # group_pad adds (56 groups padded to 64).
    out.append(("zero_count_groups", np_pool(rng, s), [
        (e, v, r, 0 if i % 2 else c) for i, (e, v, r, c) in
        enumerate(seeded_groups(rng, 56, MAIN_TASKS, s))]))
    out.append(("serving_like", serving_pool(rng),
                serving_groups(rng, MAIN_G, MAIN_TASKS)))
    out.append(("env_beyond_bitmap", np_pool(rng, s),
                [(e, 1, -1, int(rng.integers(1, 300))) for e in ODD_ENVS]))
    return out


# Environment ids whose bitmap word lies outside [0, E) for E = 8: the
# kernels read them as the JAX device functions do (a word in [-E, 0)
# wraps, one outside [-E, E) reads all ones).
ODD_ENVS = (256, 261, 10**6, -1, -257, -256, -33)


def serving_pool(rng):
    """The serving path's pool: 5,000 of 8,192 slots alive, capacities
    8-64, ~20% dedicated, a few grants held, each servant holding ~25% of
    64 compiler digests (bitmap words 0-1; words 2-7 empty)."""
    import numpy as np

    s = MAIN_S
    alive = np.zeros(s, bool)
    alive[:N_SERVANTS] = True
    cap = rng.integers(8, 65, s).astype(np.int32)
    bits = rng.random((s, N_ENVS)) < 0.25
    words = np.zeros((s, 8), np.uint32)
    for b in range(N_ENVS):
        words[:, b // 32] |= bits[:, b].astype(np.uint32) << np.uint32(b % 32)
    return dict(alive=alive, capacity=cap,
                running=rng.integers(0, 4, s).astype(np.int32),
                dedicated=rng.random(s) < 0.2,
                version=np.ones(s, np.int32), env_bitmap=words)


def serving_groups(rng, g, total):
    """g groups over the 64 digests, min_version 0, requestors among the
    live servants, counts summing to total."""
    import numpy as np

    cuts = np.sort(rng.integers(0, total + 1, g - 1))
    counts = np.diff(np.concatenate(([0], cuts, [total])))
    return [(int(rng.integers(0, N_ENVS)), 0,
             int(rng.integers(-1, N_SERVANTS)), int(c)) for c in counts]


def compare_kernel(report: list) -> dict:
    import numpy as np
    import torch

    from yadcc_tpu_torch.ops import assignment as asn
    from yadcc_tpu_torch.ops import assignment_grouped as asg
    from yadcc_tpu_torch.ops import cuda_grouped as kg

    dev = torch.device("cuda")

    def pools(p):
        return (asn.pool_from_numpy(*(p[k] for k in asn.PoolArrays._fields),
                                    dev),
                asn.pool_from_numpy(*(p[k] for k in asn.PoolArrays._fields),
                                    "cpu"))

    def same(a, b, what):
        check(torch.equal(a.cpu(), b.cpu()), f"kernel != plain: {what}")

    rng = np.random.default_rng(2026)
    cases = []
    for g in (1, 8, 64):
        for total in (g, 512, MAIN_TASKS):
            cases.append((f"seeded_S{MAIN_S}_G{g}_m{total}",
                          np_pool(rng, MAIN_S),
                          seeded_groups(rng, g, total, MAIN_S)))
    cases += edge_cases(rng)
    for name, p, groups in cases:
        gpu, cpu = pools(p)
        pad = asg.group_pad(len(groups))
        bg = asg.make_grouped_batch(groups, pad, dev)
        kc, kr = kg.cuda_assign_grouped(gpu, bg)
        pc, pr = asg.assign_grouped(gpu, bg)
        same(kc, pc, f"{name} counts")
        same(kr, pr, f"{name} running")
        cc, cr = asg.assign_grouped(cpu, asg.make_grouped_batch(groups, pad))
        same(kc, cc, f"{name} counts vs CPU")
        same(kr, cr, f"{name} running vs CPU")
        report.append(f"  {name}: S={len(p['alive'])} G={pad} "
                      f"granted={int(kc.sum())} equal")

    # The four wrappers against their plain twins.
    p = np_pool(rng, MAIN_S)
    gpu, _ = pools(p)
    groups = seeded_groups(rng, 16, 1500, MAIN_S)
    packed = asg.make_grouped_packed(groups, 16, dev)
    batch = asg.unpack_grouped(packed)
    t_max = asg.task_pad(1500)
    for what, got, want in (
            ("picks", kg.cuda_assign_grouped_picks(gpu, batch, t_max),
             asg.assign_grouped_picks(gpu, batch, t_max)),
            ("picks_packed",
             kg.cuda_assign_grouped_picks_packed(gpu, packed, t_max),
             asg.assign_grouped_picks_packed(gpu, packed, t_max))):
        same(got[0], want[0], f"{what} picks")
        same(got[1], want[1], f"{what} running")
    s = MAIN_S
    adj = torch.from_numpy(rng.integers(-3, 2, s).astype(np.int32)).to(dev)
    rmask = torch.from_numpy(rng.random(s) < 0.05).to(dev)
    rval = torch.from_numpy(rng.integers(0, 5, s).astype(np.int32)).to(dev)
    got = kg.cuda_assign_grouped_picks_stream(gpu, packed, adj, rmask, rval,
                                              t_max)
    want = asg.assign_grouped_picks_stream(gpu, packed, adj, rmask, rval,
                                           t_max)
    same(got[0], want[0], "picks_stream picks")
    same(got[1], want[1], "picks_stream running")
    report.append("  wrappers picks/picks_packed/picks_stream: equal")

    # Refusals: a non-contiguous tensor, a wrong dtype, a stray device.
    bad = [
        ("non-contiguous running",
         gpu._replace(running=torch.zeros(2 * s, dtype=torch.int32,
                                          device=dev)[::2]), batch),
        ("int64 capacity",
         gpu._replace(capacity=gpu.capacity.long()), batch),
        ("uint8 alive", gpu._replace(alive=gpu.alive.to(torch.uint8)),
         batch),
        ("batch on the CPU", gpu,
         asg.make_grouped_batch(groups, 16, "cpu")),
    ]
    for what, bp, bb in bad:
        before = kg.launches
        try:
            kg.cuda_assign_grouped(bp, bb)
        except (TypeError, ValueError):
            check(kg.launches == before, f"{what}: counted a launch")
            continue
        raise SmokeFailure(f"wrapper accepted {what}")
    report.append("  refusals (non-contiguous, dtype, device): raised")
    torch.cuda.synchronize()
    return time_kernel(report)


def timed(fn, reps: int) -> float:
    """Mean ms of ``fn`` over ``reps`` calls after one warm call, with
    CUDA events on the current stream."""
    import torch

    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(True), torch.cuda.Event(True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


# Integer operations (32-bit equivalents) that K1's function needs on
# this data, for its bound: the eligibility test of every slot for each
# group that grants (alive, env bit, version, requestor, room), and one
# int64 closed form (multiply-add, shift, subtract, two clamps) for each
# slot with room in each count_leq the exact search evaluates, two for a
# dedicated slot (its tau-independent third once a group), with one add
# to sum it.
K1_OPS_TEST, K1_OPS_FORM = 8, 12
K1_SEARCH_ITERS = 22
H100_SMS = 132


def k1_avail(p, run, env, minv, req, cm):
    """A group's room per slot (0 where a slot is not eligible), reading
    an environment word outside the bitmap as K1 does."""
    import numpy as np

    s, e = p["env_bitmap"].shape
    w = env >> 5
    has = (np.ones(s, bool) if not -e <= w < e else
           (p["env_bitmap"][:, w % e].astype(np.int64) >> (env & 31) & 1)
           == 1)
    ok = p["alive"] & has & (p["version"] >= minv)
    if cm.avoid_self:
        ok &= np.arange(s) != req
    return np.where(ok, np.maximum(p["capacity"] - run, 0), 0)


def k1_count(cap1, run, avail, dedicated, cm):
    """K1's count_leq(tau) over compacted slots: branch-free, with
    pref_total (0 for a plain slot) computed once, dividing by
    UTIL_SCALE as ``>> 16``."""
    import numpy as np

    pref_q = int(cm.dedicated_preference_utilization_q)
    bonus = int(cm.preference_bonus_q)

    def ks(x):
        k = (((x + 1) * cap1 - 1) >> 16) - run + 1
        return np.minimum(np.maximum(k, 0), avail)

    pref_total = np.where(dedicated, ks(pref_q - 1), 0)

    def count(tau):
        return (np.minimum(ks(min(tau + bonus, pref_q - 1)), pref_total)
                + np.maximum(ks(tau) - pref_total, 0))

    return count


def k1_model(p, groups, cm=None):
    """K1's design in int64 numpy, group by group: the m <= 0 skip, the
    compaction of the slots that are eligible and have room (in slot
    order), the branch-free count with pref_total (0 for a plain slot)
    and ``>> 16``, the early-stopping bisect, and the tie split by an
    exclusive scan over the compact list.  Returns (counts int32[G, S], running int32[S], work), where work
    holds per group (active slots, active dedicated slots, bisect
    steps)."""
    import numpy as np

    from yadcc_tpu_torch.models.cost import DEFAULT_COST_MODEL, UTIL_SCALE

    cm = cm or DEFAULT_COST_MODEL
    s = p["env_bitmap"].shape[0]
    run = p["running"].astype(np.int64)
    cap1 = np.maximum(p["capacity"].astype(np.int64), 1)
    bonus = int(cm.preference_bonus_q)
    lo0, hi0 = -bonus - 1, UTIL_SCALE + 1
    skip = (bool((run >= 0).all()) and bonus >= 0
            and hi0 - lo0 < 1 << K1_SEARCH_ITERS)
    counts = np.zeros((len(groups), s), np.int32)
    work = []
    for g, (env, minv, req, m) in enumerate(groups):
        if m <= 0 and skip:
            work.append((0, 0, 0))
            continue
        avail = k1_avail(p, run, env, minv, req, cm)
        idx = np.flatnonzero(avail > 0)                     # compaction
        ded = p["dedicated"][idx]
        count = k1_count(cap1[idx], run[idx], avail[idx], ded, cm)
        lo, hi, known, it = lo0, hi0, False, 0
        while idx.size and it < K1_SEARCH_ITERS and not (
                hi == lo or (hi - lo == 1 and known)):
            mid = (lo + hi) >> 1
            it += 1
            if count(mid).sum() >= m:
                hi = mid
            else:
                lo, known = mid, True
        work.append((idx.size, int(ded.sum()), it))
        if not idx.size:
            continue
        below = count(hi - 1)
        at = count(hi) - below
        before = np.cumsum(at) - at            # the compact list's scan
        c = below + np.clip(m - below.sum() - before, 0, at)
        counts[g, idx] = c
        run[idx] += c
    return counts, run.astype(np.int32), work


# K2's block (csrc/assign_batch.cu kThreads): slot s belongs to thread
# s % K2_THREADS.
K2_THREADS = 1024
K2_NO_KEY = (1 << 63) - 1
# Integer operations (32-bit equivalents) that K2's function needs on this
# data, for its bound: for a task whose descriptor differs from the one
# before, an eligibility test and a key compare of every slot; for every
# grant, one int64 closed form (the granted slot's new key); for a task
# that repeats the descriptor after a grant, log2(S) compares to find the
# new minimum (a heap's update).  A repeat after a task that granted nothing
# needs nothing: no key moved.
K2_OPS_SLOT, K2_OPS_FORM = 10, 12


def k2_model(p, tasks, cm=None):
    """K2's design in int64 numpy, task by task: the per-slot keys
    (score*S + slot, K2_NO_KEY for a dead or full slot) computed once and
    only the granted slot's recomputed; each of K2_THREADS owners' least
    eligible key, from a full scan when the descriptor (env, min_version,
    requestor) changes, from the granted slot's owner alone when it repeats
    after a grant, and kept as it was when it repeats after no grant (no
    reduction then); a grant when the task is valid and the block minimum
    is below infeasible_q*S, to the one owner holding it.  ``tasks`` holds
    (env, min_version, requestor[, valid]).  Returns (picks int32[T],
    running int32[S], work) where work counts descriptor_changes,
    owner_rescans, reductions and grants."""
    import numpy as np

    from yadcc_tpu_torch.models.cost import DEFAULT_COST_MODEL, UTIL_SCALE

    cm = cm or DEFAULT_COST_MODEL
    s, e = p["env_bitmap"].shape
    slots = np.arange(s)
    run = p["running"].astype(np.int64)
    cap = p["capacity"].astype(np.int64)
    ded = p["dedicated"].astype(bool)
    pref = int(cm.dedicated_preference_utilization_q)
    bonus = int(cm.preference_bonus_q)

    def live_keys(idx):
        util = run[idx] * UTIL_SCALE // np.maximum(cap[idx], 1)
        score = np.where(ded[idx] & (util < pref), util - bonus, util)
        return np.where(run[idx] < cap[idx], score * s + idx, K2_NO_KEY)

    key = np.where(p["alive"], live_keys(slots), K2_NO_KEY)
    rows = -(-s // K2_THREADS)
    grid_slots = np.arange(rows * K2_THREADS).reshape(rows, K2_THREADS)
    lanes = np.arange(K2_THREADS)

    def eligible(env, minv, req):
        w = env >> 5
        has = (np.ones(s, bool) if not -e <= w < e else
               (p["env_bitmap"][:, w % e].astype(np.int64) >> (env & 31) & 1)
               == 1)
        ok = has & (p["version"] >= minv)
        if cm.avoid_self:
            ok &= slots != req
        return ok

    no_grant_from = int(cm.infeasible_score_q) * s
    best = np.full(K2_THREADS, K2_NO_KEY, np.int64)
    best_slot = np.full(K2_THREADS, -1)
    picks = np.full(len(tasks), -1, np.int32)
    work = dict(descriptor_changes=0, owner_rescans=0, reductions=0,
                grants=0)
    desc, elig, owner, granted, gmin = None, None, -1, False, K2_NO_KEY
    for t, task in enumerate(tasks):
        valid = bool(task[3]) if len(task) > 3 else True
        reduce = True
        if tuple(task[:3]) != desc:
            desc = tuple(task[:3])
            elig = eligible(*desc)
            grid = np.full(rows * K2_THREADS, K2_NO_KEY, np.int64)
            grid[:s] = np.where(elig, key, K2_NO_KEY)
            grid = grid.reshape(rows, K2_THREADS)
            i = grid.argmin(axis=0)
            best, best_slot = grid[i, lanes], grid_slots[i, lanes]
            work["descriptor_changes"] += 1
        elif granted:
            own = slots[owner::K2_THREADS]
            mine = np.where(elig[own], key[own], K2_NO_KEY)
            best[owner], best_slot[owner] = mine.min(), own[mine.argmin()]
            work["owner_rescans"] += 1
        else:
            reduce = False      # nothing moved: the minimum stands
        if reduce:
            gmin = int(best.min())
            work["reductions"] += 1
        granted = valid and gmin < no_grant_from
        if granted:
            holders = np.flatnonzero(best == gmin)
            assert holders.size == 1, "a grant needs exactly one owner"
            owner = int(holders[0])
            slot = int(best_slot[owner])
            picks[t] = slot
            run[slot] += 1
            key[slot] = live_keys(np.array([slot]))[0]
            work["grants"] += 1
    return picks, run.astype(np.int32), work


def k2_ops(s, work) -> int:
    """K2's operations on the data ``work`` (k2_model's) describes."""
    import math

    return (work["descriptor_changes"] * s * K2_OPS_SLOT
            + work["grants"] * K2_OPS_FORM
            + work["owner_rescans"] * math.ceil(math.log2(max(s, 2))))


def time_k1(p, pool, groups, pad, reps=50) -> dict:
    """K1 and its plain version on one pool and batch, with CUDA events;
    the bound from what this data needs."""
    import numpy as np

    from yadcc_tpu_torch.ops import assignment_grouped as asg
    from yadcc_tpu_torch.ops import cuda_grouped as kg

    batch = asg.make_grouped_batch(groups, pad, pool.alive.device)
    ms = timed(lambda: kg.cuda_assign_grouped(pool, batch), reps)
    plain_ms = timed(lambda: asg.assign_grouped(pool, batch), 3)
    counts = kg.cuda_assign_grouped(pool, batch)[0].cpu().numpy()
    padded = list(groups) + [(0, 0, -1, 0)] * (pad - len(groups))
    model_counts, _, work = k1_model(p, padded)
    check(np.array_equal(model_counts, counts),
          "K1 timing: the host model's counts differ from the kernel's")
    active = [n for n, _, _ in work]
    steps = [it for _, _, it in work]
    s = len(p["alive"])
    e = pool.env_bitmap.shape[1]
    moved = s * (6 + e) * 4 + pad * s * 4 + s * 4
    bytes_ms = moved / H100_BYTES_PER_S * 1e3
    # The search's evaluations plus the tie split's two (tau - 1, tau).
    ops = (s * K1_OPS_TEST * sum(1 for *_, m in padded if m > 0)
           + sum((it + 2) * ((n + nd) * K1_OPS_FORM + n) + nd * K1_OPS_FORM
                 for n, nd, it in work))
    ops_ms = ops / H100_OPS_PER_S * 1e3
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                bytes_ms=bytes_ms, ops_ms=ops_ms,
                one_sm_floor_ms=ops / (H100_OPS_PER_S / H100_SMS) * 1e3,
                us_per_group=ms * 1e3 / pad, groups=pad,
                searched_groups=sum(1 for n in active if n),
                mean_active_slots=float(np.mean([n for n in active if n]
                                                or [0])),
                bisect_steps=sum(steps), max_steps=max(steps))


def time_kernel(report: list) -> dict:
    """The kernel and the plain version at the main path's largest chunk
    (S=8192, G=64, 2048 tasks) and at G=8 on the timing pool, and at G=64
    on the serving-like pool, with CUDA events."""
    import numpy as np
    import torch

    from yadcc_tpu_torch.ops import assignment as asn
    from yadcc_tpu_torch.ops import assignment_grouped as asg
    from yadcc_tpu_torch.ops import cuda_grouped as kg

    dev = torch.device("cuda")
    rng = np.random.default_rng(7)
    p = np_pool(rng, MAIN_S, cap_lo=8, cap_hi=65, run_hi=8, ded_frac=0.2)
    pool = asn.pool_from_numpy(*(p[k] for k in asn.PoolArrays._fields), dev)
    out = {}
    sp = serving_pool(np.random.default_rng(8))
    spool = asn.pool_from_numpy(*(sp[k] for k in asn.PoolArrays._fields),
                                dev)
    for key, pn, pt, groups, pad in (
            (8, p, pool, seeded_groups(rng, 8, MAIN_TASKS, MAIN_S), 8),
            (MAIN_G, p, pool, seeded_groups(rng, MAIN_G, MAIN_TASKS, MAIN_S),
             MAIN_G),
            ("serving_like", sp, spool,
             serving_groups(np.random.default_rng(9), MAIN_G, MAIN_TASKS),
             MAIN_G)):
        t = out[key] = time_k1(pn, pt, groups, pad)
        report.append(
            f"  timing {'serving-like' if key == 'serving_like' else 'timing'}"
            f" pool S={MAIN_S} G={pad} tasks={MAIN_TASKS}: kernel "
            f"{t['ms']:.4f} ms (50 launches) = {t['us_per_group']:.2f} us a "
            f"group, plain {t['plain_ms']:.2f} ms, bound "
            f"{t['bound_ms'] * 1e3:.3f} us ({t['bound_by']}; bytes "
            f"{t['bytes_ms'] * 1e3:.3f} us, ops {t['ops_ms'] * 1e3:.3f} us), "
            f"one-SM floor {t['one_sm_floor_ms'] * 1e3:.2f} us; "
            f"{t['searched_groups']} groups searched over "
            f"{t['mean_active_slots']:.0f} active slots on average, "
            f"{t['bisect_steps']} bisect steps (at most {t['max_steps']})")

    # The two wrappers the main path calls (synchronous: picks_packed,
    # pipelined: picks_stream) at the same chunk: K1 plus the expansion
    # (and the stream's delta fold).  Their bound adds the picks written
    # and the expansion's t_max x S compare to K1's.
    packed = asg.make_grouped_packed(
        seeded_groups(rng, MAIN_G, MAIN_TASKS, MAIN_S), MAIN_G, dev)
    t_max = asg.task_pad(MAIN_TASKS)
    adj = torch.zeros(MAIN_S, dtype=torch.int32, device=dev)
    rmask = torch.zeros(MAIN_S, dtype=torch.bool, device=dev)
    k1 = out[MAIN_G]
    bytes_ms = (k1["bytes_ms"] + t_max * 4 / H100_BYTES_PER_S * 1e3)
    ops_ms = k1["ops_ms"] + 2 * t_max * MAIN_S / H100_OPS_PER_S * 1e3
    batch = asg.unpack_grouped(packed)
    for name, kern, plain in (
            ("picks",
             lambda: kg.cuda_assign_grouped_picks(pool, batch, t_max),
             lambda: asg.assign_grouped_picks(pool, batch, t_max)),
            ("picks_packed",
             lambda: kg.cuda_assign_grouped_picks_packed(pool, packed, t_max),
             lambda: asg.assign_grouped_picks_packed(pool, packed, t_max)),
            ("picks_stream",
             lambda: kg.cuda_assign_grouped_picks_stream(
                 pool, packed, adj, rmask, adj, t_max),
             lambda: asg.assign_grouped_picks_stream(
                 pool, packed, adj, rmask, adj, t_max))):
        w = dict(ms=timed(kern, 50), plain_ms=timed(plain, 3),
                 bound_ms=max(bytes_ms, ops_ms),
                 bound_by="bytes" if bytes_ms >= ops_ms else "operations")
        out[name] = w
        report.append(
            f"  timing {name} S={MAIN_S} G={MAIN_G} tasks={MAIN_TASKS} "
            f"t_max={t_max}: wrapper {w['ms']:.4f} ms (50 calls), plain "
            f"{w['plain_ms']:.2f} ms, bound {w['bound_ms'] * 1e3:.3f} us "
            f"({w['bound_by']})")

    # The resident step (phase 6's wrapper): a 64-row delta with 40 dirty
    # slots, the fold resetting every slot to the same running (so each
    # call does the same work on the in-place pool), K1, the expansion.
    # Its bound adds the delta rows read and scattered and the fold's
    # three S-vectors read.
    rpool = asn.PoolArrays(*(x.clone() for x in pool))
    ppool = asn.PoolArrays(*(x.clone() for x in pool))
    dirty = np.sort(rng.choice(MAIN_S, 40, replace=False))
    delta = asg.make_pool_delta(dirty, p, asg.delta_pad(40), MAIN_S, dev)
    all_reset = torch.ones(MAIN_S, dtype=torch.bool, device=dev)
    run0 = pool.running.clone()
    e = pool.env_bitmap.shape[1]
    r_bytes = (bytes_ms + (asg.delta_pad(40) * (6 + e) * 4 * 2
                           + MAIN_S * 9) / H100_BYTES_PER_S * 1e3)
    r_ops = ops_ms + 3 * MAIN_S / H100_OPS_PER_S * 1e3
    w = dict(
        ms=timed(lambda: kg.cuda_resident_grouped_step(
            rpool, delta, packed, adj, all_reset, run0, t_max), 50),
        plain_ms=timed(lambda: asg.resident_grouped_step(
            ppool, delta, packed, adj, all_reset, run0, t_max), 3),
        bound_ms=max(r_bytes, r_ops),
        bound_by="bytes" if r_bytes >= r_ops else "operations")
    out["resident_step"] = w
    report.append(
        f"  timing resident_step S={MAIN_S} G={MAIN_G} tasks={MAIN_TASKS} "
        f"t_max={t_max} delta 40/{asg.delta_pad(40)}: wrapper "
        f"{w['ms']:.4f} ms (50 calls), plain {w['plain_ms']:.2f} ms, bound "
        f"{w['bound_ms'] * 1e3:.3f} us ({w['bound_by']})")
    return out


def compare_resident_step(report: list) -> None:
    """The resident step through K1 (in place on the card) against the
    plain step (functional, on the card), chained over cycles with statics
    churn, running corrections and resets: picks, running and every
    static equal after every cycle."""
    import numpy as np
    import torch

    from yadcc_tpu_torch.ops import assignment as asn
    from yadcc_tpu_torch.ops import assignment_grouped as asg
    from yadcc_tpu_torch.ops import cuda_grouped as kg

    dev = torch.device("cuda")
    rng = np.random.default_rng(11)
    for s, cycles in ((MAIN_S, 5), (1000, 3)):
        p = np_pool(rng, s, cap_lo=1, cap_hi=24, run_hi=8)
        p["running"] = np.minimum(p["running"], p["capacity"])
        kpool = asn.pool_from_numpy(*(p[k] for k in asn.PoolArrays._fields),
                                    dev)
        ppool = asn.PoolArrays(*(x.clone() for x in kpool))
        granted = 0
        for cycle in range(cycles):
            dirty = np.sort(rng.choice(s, min(s // 10, 50), replace=False))
            for i in dirty:
                p["capacity"][i] = rng.integers(0, 24)
                p["alive"][i] = rng.random() < 0.9
                p["env_bitmap"][i, rng.integers(0, 8)] ^= np.uint32(
                    rng.integers(0, 2**32))
            delta = asg.make_pool_delta(dirty, p, asg.delta_pad(len(dirty)),
                                        s, dev)
            adj = torch.from_numpy(
                rng.integers(-2, 2, s).astype(np.int32)).to(dev)
            rmask = torch.from_numpy(rng.random(s) < 0.03).to(dev)
            rval = torch.from_numpy(
                rng.integers(0, 4, s).astype(np.int32)).to(dev)
            groups = seeded_groups(rng, 16, min(1500, 3 * s), s)
            packed = asg.make_grouped_packed(groups, 16, dev)
            t_max = asg.task_pad(sum(g[3] for g in groups))
            got, kpool = kg.cuda_resident_grouped_step(
                kpool, delta, packed, adj, rmask, rval, t_max)
            want, ppool = asg.resident_grouped_step(
                ppool, delta, packed, adj, rmask, rval, t_max)
            check(torch.equal(got.cpu(), want.cpu()),
                  f"resident step S={s} cycle {cycle}: picks differ")
            for f in asn.PoolArrays._fields:
                check(torch.equal(getattr(kpool, f).cpu(),
                                  getattr(ppool, f).cpu()),
                      f"resident step S={s} cycle {cycle}: {f} differs")
            granted += int((got != -1).sum())
        report.append(f"  resident step S={s}: {cycles} chained cycles "
                      f"with churn, {granted} grants, picks/running/statics "
                      f"equal")


def k2_cases(rng):
    """(name, numpy pool, tasks, avoid_self) for K2 against its plain
    version: seeded pools, the corners of the scan, runs of identical
    descriptors (the serving path's shape), and the geometries."""
    import numpy as np

    s, t = MAIN_S, MAIN_T

    def base(**kw):
        p = dict(alive=np.ones(s, bool), capacity=np.full(s, 8, np.int32),
                 running=np.zeros(s, np.int32), dedicated=np.zeros(s, bool),
                 version=np.ones(s, np.int32),
                 env_bitmap=np.full((s, 8), 0xFFFFFFFF, np.uint32))
        p.update(kw)
        return p

    def tasks(size, n=t, envs=256):
        return [(int(rng.integers(0, envs)), int(rng.integers(0, 4)),
                 int(rng.integers(-1, size))) for _ in range(n)]

    out = [(f"seeded_S{s}_T{t}_{i}", np_pool(rng, s), tasks(s), True)
           for i in range(3)]
    # Contended: capacities 1-3, half the requested environments served
    # by nobody — grants and denials in one batch.
    bits = rng.random((s, 8, 32)) < 0.02
    bits[:, 4:, :] = False
    words = np.zeros((s, 8), np.uint32)
    for b in range(32):
        words |= bits[:, :, b].astype(np.uint32) << np.uint32(b)
    cap = rng.integers(1, 4, s).astype(np.int32)
    out.append(("contended", base(
        alive=rng.random(s) < 0.9, capacity=cap,
        running=np.minimum(rng.integers(0, 4, s), cap).astype(np.int32),
        dedicated=rng.random(s) < 0.3, env_bitmap=words),
        [(int(e), 1, -1) for e in rng.integers(0, 256, t)], True))
    out.append(("all_infeasible", base(alive=np.zeros(s, bool)), tasks(s),
                True))
    out.append(("ties_identical_slots", base(), [(3, 1, -1)] * t, True))
    capd = rng.integers(2, 16, s).astype(np.int32)
    out.append(("negative_scores_dedicated", base(
        capacity=capd, running=(capd // 2 + rng.integers(-1, 2, s)).clip(
            0).astype(np.int32), dedicated=rng.random(s) < 0.5),
        tasks(s), True))
    for avoid in (True, False):
        out.append((f"requestors_avoid_self_{avoid}",
                    base(capacity=np.full(s, 2, np.int32)),
                    [(0, 1, int(r)) for r in rng.integers(0, 8, t)], avoid))
    out.append(("env_beyond_bitmap", np_pool(rng, s),
                [(int(e), 1, -1) for e in rng.choice(ODD_ENVS, t)], True))
    # Runs of 128 identical descriptors over 40 holders each with
    # capacities 1-5: slots fill to capacity inside a run (their owners
    # rescan), dedicated ones cross the preference threshold, and each
    # run's tail is denied.
    envs = rng.choice(256, 2, replace=False)
    bits = np.zeros((s, 8), np.uint32)
    for env in envs:
        bits[rng.choice(s, 40, replace=False), env >> 5] |= np.uint32(
            1 << (env & 31))
    cap = rng.integers(1, 6, s).astype(np.int32)
    out.append(("descriptor_runs", base(
        capacity=cap, running=np.minimum(rng.integers(0, 3, s), cap).astype(
            np.int32), dedicated=rng.random(s) < 0.3, env_bitmap=bits),
        [(int(envs[0]), 1, -1)] * 128 + [(int(envs[1]), 1, -1)] * 128,
        True))
    # Runs of 64 whose requestor is one of the least loaded slots.
    run = np.ones(s, np.int32)
    run[:8] = 0
    out.append(("runs_avoid_self", base(capacity=np.full(s, 3, np.int32),
                                        running=run),
                [(0, 1, int(r)) for r in rng.integers(0, 8, t // 64)
                 for _ in range(64)], True))
    for size in (1000, 5000, 1, 70_000):
        out.append((f"S{size}", np_pool(rng, size), tasks(size, 64), True))
    return out


def k2_batch(tasks, pad_to, dev):
    from yadcc_tpu_torch.ops import assignment as asn

    return asn.make_batch([x[0] for x in tasks], [x[1] for x in tasks],
                          [x[2] for x in tasks], pad_to, dev)


def k2_run(p, pool, tasks, cm=None):
    """K2 on the card against its plain version and k2_model, exactly:
    picks, running, and the kernel's counts of descriptor changes, owner
    rescans and reductions against the model's.  Returns (picks, model
    work)."""
    import numpy as np
    import torch

    from yadcc_tpu_torch.models.cost import DEFAULT_COST_MODEL
    from yadcc_tpu_torch.ops import assignment as asn
    from yadcc_tpu_torch.ops import cuda_assign as ka

    cm = cm or DEFAULT_COST_MODEL
    batch = k2_batch(tasks, len(tasks), pool.alive.device)
    work = torch.zeros(len(ka.WORK_FIELDS), dtype=torch.int64,
                       device=pool.alive.device)
    kp, kr = ka.cuda_assign_batch(pool, batch, cm, work=work)
    pp, pr = asn.assign_batch(pool, batch, cm)
    mp, mr, mw = k2_model(p, tasks, cm)
    kp, kr = kp.cpu(), kr.cpu()
    check(torch.equal(kp, pp.cpu()) and np.array_equal(kp.numpy(), mp),
          "K2 picks differ from the plain version's or the model's")
    check(torch.equal(kr, pr.cpu()) and np.array_equal(kr.numpy(), mr),
          "K2 running differs from the plain version's or the model's")
    got = dict(zip(ka.WORK_FIELDS, work.cpu().tolist()))
    want = {k: mw[k] for k in ka.WORK_FIELDS}
    check(got == want, f"K2 counts {got} differ from the model's {want}")
    return kp, mw


def time_k2(p, pool, tasks, reps=50) -> dict:
    """K2 and its plain version on one pool and batch, with CUDA events,
    after the kernel's picks and counts are held against k2_model's; the
    bound from what this data needs (k2_model's counts)."""
    from yadcc_tpu_torch.ops import assignment as asn
    from yadcc_tpu_torch.ops import cuda_assign as ka

    _, work = k2_run(p, pool, tasks)
    batch = k2_batch(tasks, len(tasks), pool.alive.device)
    ms = timed(lambda: ka.cuda_assign_batch(pool, batch), reps)
    plain_ms = timed(lambda: asn.assign_batch(pool, batch), 3)
    s, t = len(p["alive"]), len(tasks)
    e = pool.env_bitmap.shape[1]
    # The pool read once (alive, capacity, running, dedicated, version,
    # bitmap), the tasks read, the picks and running written.
    moved = s * (14 + 4 * e) + t * 13 + t * 4 + s * 4
    bytes_ms = moved / H100_BYTES_PER_S * 1e3
    ops = k2_ops(s, work)
    ops_ms = ops / H100_OPS_PER_S * 1e3
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                bytes_ms=bytes_ms, ops_ms=ops_ms,
                one_sm_floor_ms=ops / (H100_OPS_PER_S / H100_SMS) * 1e3,
                us_per_task=ms * 1e3 / t, tasks=t, work=work)


def compare_assign_batch(report: list) -> dict:
    """K2 against assign_batch and k2_model on the card, exactly; the
    wrapper's refusals; K2's time at S=8192, T=256 on the timing pool and
    on a batch of two runs of 128 on the serving-like pool."""
    from dataclasses import replace

    import numpy as np
    import torch

    from yadcc_tpu_torch.models.cost import DEFAULT_COST_MODEL
    from yadcc_tpu_torch.ops import assignment as asn
    from yadcc_tpu_torch.ops import cuda_assign as ka

    dev = torch.device("cuda")
    rng = np.random.default_rng(2027)

    def up(p):
        return asn.pool_from_numpy(*(p[k] for k in asn.PoolArrays._fields),
                                   dev)

    for name, p, tasks, avoid in k2_cases(rng):
        cm = replace(DEFAULT_COST_MODEL, avoid_self=avoid)
        kp, work = k2_run(p, up(p), tasks, cm)
        granted = int((kp != -1).sum())
        if name == "contended":
            check(0 < granted < len(tasks), "contended: need grants and "
                  f"denials, got {granted}/{len(tasks)}")
        if name == "all_infeasible":
            check(granted == 0, "all_infeasible granted")
        if name == "ties_identical_slots":
            check(kp.tolist() == list(range(len(tasks))),
                  "ties: picks are not the lowest slots in order")
        if name == "descriptor_runs":
            check(0 < granted < len(tasks) and work["owner_rescans"] > 0,
                  f"descriptor_runs: {granted} grants, {work}")
        report.append(f"  K2 {name}: S={len(p['alive'])} T={len(tasks)} "
                      f"granted={granted} equal; descriptor changes "
                      f"{work['descriptor_changes']}, owner rescans "
                      f"{work['owner_rescans']}, reductions "
                      f"{work['reductions']} as the model's")

    # Padding rows are inert: the same tasks padded to 2x grant the same
    # and pick nothing in the padding.
    p = np_pool(rng, MAIN_S)
    tasks = [(int(rng.integers(0, 256)), 1, -1) for _ in range(100)]
    pool = up(p)
    kp, kr = ka.cuda_assign_batch(pool, k2_batch(tasks, 100, dev))
    kp2, kr2 = ka.cuda_assign_batch(pool, k2_batch(tasks, 200, dev))
    check(torch.equal(kp2[:100].cpu(), kp.cpu())
          and bool((kp2[100:] == -1).all()) and torch.equal(kr2, kr),
          "K2 padding rows not inert")
    report.append("  K2 padded rows (100 tasks padded to 200): inert")

    batch = k2_batch(tasks, 100, dev)
    bad = [
        ("non-contiguous running",
         pool._replace(running=torch.zeros(2 * MAIN_S, dtype=torch.int32,
                                           device=dev)[::2]), batch, None),
        ("int64 capacity", pool._replace(capacity=pool.capacity.long()),
         batch, None),
        ("int32 valid", pool, batch._replace(valid=batch.valid.int()), None),
        ("batch on the CPU", pool, asn.make_batch([0], [0], [-1], 1), None),
        ("int32 work", pool, batch,
         torch.zeros(len(ka.WORK_FIELDS), dtype=torch.int32, device=dev)),
    ]
    for what, bp, bb, work in bad:
        before = ka.launches
        try:
            ka.cuda_assign_batch(bp, bb, work=work)
        except (TypeError, ValueError):
            check(ka.launches == before, f"K2 {what}: counted a launch")
            continue
        raise SmokeFailure(f"K2 wrapper accepted {what}")
    report.append("  K2 refusals (non-contiguous, dtype, device, work "
                  "dtype): raised")
    torch.cuda.synchronize()

    # Time at the policy's chunk, S=8192, T=256: on the pool of K1's timing
    # (a new descriptor every task), and on the serving-like pool with two
    # runs of 128 identical descriptors (the serving path's requests).
    p = np_pool(np.random.default_rng(7), MAIN_S, cap_lo=8, cap_hi=65,
                run_hi=8, ded_frac=0.2)
    out = {"timing": time_k2(p, up(p), [(int(rng.integers(0, 256)), 1, -1)
                                        for _ in range(MAIN_T)])}
    sp = serving_pool(np.random.default_rng(8))
    srng = np.random.default_rng(10)
    runs = [(int(srng.integers(0, N_ENVS)), 0,
             int(srng.integers(0, N_SERVANTS))) for _ in range(2)]
    out["runs"] = time_k2(sp, up(sp), [runs[0]] * 128 + [runs[1]] * 128)
    for key, what in (("timing", "timing pool, a new descriptor a task"),
                      ("runs", "serving-like pool, two runs of 128")):
        r = out[key]
        w = r["work"]
        report.append(
            f"  K2 timing S={MAIN_S} T={r['tasks']} on the {what}: kernel "
            f"{r['ms']:.4f} ms (50 launches) = {r['us_per_task']:.3f} us a "
            f"task, plain {r['plain_ms']:.2f} ms, bound "
            f"{r['bound_ms'] * 1e3:.3f} us ({r['bound_by']}; bytes "
            f"{r['bytes_ms'] * 1e3:.3f} us, ops {r['ops_ms'] * 1e3:.3f} us),"
            f" one-SM floor {r['one_sm_floor_ms'] * 1e3:.2f} us; "
            f"{w['descriptor_changes']} descriptor changes, "
            f"{w['owner_rescans']} owner rescans, {w['reductions']} "
            f"reductions, {w['grants']} grants")
    return out


# ---------------------------------------------------------------------------
# Phases 3 to 6: the scheduler entry on loopback.
# ---------------------------------------------------------------------------


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Fleet:
    """5,000 synthetic servants: their facts, and the client-side count of
    grants each holds right now (raised on grant, lowered BEFORE the
    FreeTask leaves, so it never exceeds what the scheduler counts)."""

    def __init__(self, seed: int):
        rng = random.Random(seed)
        self.envs = [f"compiler-digest-{i:03d}" for i in range(N_ENVS)]
        self.servants = []
        for i in range(N_SERVANTS):
            cap = rng.randint(8, 64)
            self.servants.append(dict(
                location=f"127.0.0.1:{20000 + i}", capacity=cap,
                dedicated=rng.random() < 0.2,
                envs=frozenset(rng.sample(self.envs, rng.randint(8, 24)))))
        self.by_loc = {s["location"]: s for s in self.servants}
        self.lock = threading.Lock()
        self.held = {s["location"]: 0 for s in self.servants}
        self.violations: list = []

    def heartbeat(self, api, s):
        req = api.scheduler.HeartbeatRequest(
            token="stok", next_heartbeat_in_ms=HB_INTERVAL_MS,
            location=s["location"], version=1,
            num_processors=s["capacity"], current_load=0,
            capacity=s["capacity"], total_memory_in_bytes=64 << 30,
            memory_available_in_bytes=32 << 30,
            priority=(api.scheduler.SERVANT_PRIORITY_DEDICATED
                      if s["dedicated"]
                      else api.scheduler.SERVANT_PRIORITY_USER))
        for e in sorted(s["envs"]):
            req.env_descs.add(compiler_digest=e)
        return req


def inspect_vars(port: int) -> dict:
    with urllib.request.urlopen(
            f"http://127.0.0.1:{port}/inspect/vars", timeout=10) as r:
        return json.loads(r.read())


def run_main_path(name: str, extra_args: list, fleet: Fleet,
                  report: list, kernel: str = "grouped_assign") -> dict:
    """Start the scheduler entry, drive it, check it, stop it; ``kernel``
    must have launched in the drive."""
    port, iport = free_port(), free_port()
    LOG_DIR.mkdir(parents=True, exist_ok=True)
    log_path = LOG_DIR / f"entry_{name}.log"
    cmd = [sys.executable, "-m", "yadcc_tpu_torch.scheduler.entry",
           "--port", str(port), "--inspect-port", str(iport),
           "--acceptable-user-tokens", "utok",
           "--acceptable-servant-tokens", "stok", *extra_args]
    env = dict(os.environ, PYTHONPATH=str(REPO))
    stop = threading.Event()
    threads: list = []
    with open(log_path, "w") as log_file:
        proc = subprocess.Popen(cmd, cwd=REPO, env=env, stdout=log_file,
                                stderr=subprocess.STDOUT)
        try:
            return _drive(name, proc, port, iport, fleet, report, stop,
                          threads, kernel)
        finally:
            stop.set()
            for t in threads:
                t.join(timeout=30)
            proc.terminate()
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=30)


def _drive(name, proc, port, iport, fleet, report, stop, threads,
           kernel) -> dict:
    from yadcc_tpu_torch import api
    from yadcc_tpu_torch.rpc import Channel, RpcError
    from yadcc_tpu_torch.scheduler.service import SERVICE_NAME

    sch = api.scheduler
    t_boot = time.perf_counter()
    ch = Channel(f"grpc://127.0.0.1:{port}")
    deadline = time.monotonic() + 300
    while True:
        check(proc.poll() is None, f"{name}: scheduler exited at boot "
                                   f"(rc {proc.returncode})")
        try:
            ch.call(SERVICE_NAME, "GetConfig",
                    sch.GetConfigRequest(token="utok"),
                    sch.GetConfigResponse, timeout=2.0)
            break
        except RpcError:
            check(time.monotonic() < deadline, f"{name}: boot timed out")
            time.sleep(0.2)
    boot_s = time.perf_counter() - t_boot

    def beat_all(chan, servants):
        for s in servants:
            chan.call(SERVICE_NAME, "Heartbeat",
                      fleet.heartbeat(api, s), sch.HeartbeatResponse,
                      timeout=10.0)

    # The first servant registers alone: it takes slot 0, the slot every
    # loopback delegate's requestor address resolves to (self-avoidance).
    beat_all(ch, fleet.servants[:1])
    requestor_loc = fleet.servants[0]["location"]
    chunks = [fleet.servants[1 + i::8] for i in range(8)]
    t0 = time.perf_counter()
    regs = [threading.Thread(target=beat_all, args=(Channel(
        f"grpc://127.0.0.1:{port}"), c)) for c in chunks]
    for t in regs:
        t.start()
    for t in regs:
        t.join()
    reg_s = time.perf_counter() - t0
    state = inspect_vars(iport)["yadcc"]
    check(len(state["task_dispatcher"]["servants"]) == N_SERVANTS,
          f"{name}: {len(state['task_dispatcher']['servants'])} servants "
          f"registered")
    before = {k: v["launches"] for k, v in state["kernels"].items()}
    check(set(before) == set(KERNELS) and not any(before.values()),
          f"{name}: launch counts {before} before driving")
    stream_before = state["task_dispatcher"]["stream"]

    def rebeat():
        chan = Channel(f"grpc://127.0.0.1:{port}")
        while not stop.wait(HB_REPEAT_S):
            beat_all(chan, fleet.servants)

    hb_thread = threading.Thread(target=rebeat, daemon=True)
    hb_thread.start()
    threads.append(hb_thread)

    lock = threading.Lock()
    totals = {"grants": 0, "calls": 0, "empty": 0}
    latencies: list = []
    grant_ids: set = set()
    errors: list = []
    done = threading.Event()

    def delegate(d: int):
        rng = random.Random(1000 + d)
        envs = rng.sample(fleet.envs, ENVS_PER_DELEGATE)
        chan = Channel(f"grpc://127.0.0.1:{port}")
        k = 0
        try:
            while not done.is_set():
                env = envs[k % len(envs)]
                k += 1
                req = sch.WaitForStartingTaskRequest(
                    token="utok", milliseconds_to_wait=2000,
                    next_keep_alive_in_ms=15000, immediate_reqs=IMMEDIATE,
                    min_version=0)
                req.env_desc.compiler_digest = env
                t = time.perf_counter()
                try:
                    resp, _ = chan.call(SERVICE_NAME, "WaitForStartingTask",
                                        req, sch.WaitForStartingTaskResponse,
                                        timeout=30.0)
                except RpcError as e:
                    if e.status == sch.SCHEDULER_STATUS_NO_QUOTA_AVAILABLE:
                        with lock:
                            totals["empty"] += 1
                        continue
                    raise
                lat = time.perf_counter() - t
                ids = [g.task_grant_id for g in resp.grants]
                with fleet.lock:
                    for g in resp.grants:
                        s = fleet.by_loc.get(g.servant_location)
                        if s is None:
                            fleet.violations.append(
                                f"grant on unknown servant "
                                f"{g.servant_location}")
                            continue
                        if env not in s["envs"]:
                            fleet.violations.append(
                                f"{s['location']} lacks {env}")
                        if s["location"] == requestor_loc:
                            fleet.violations.append(
                                "grant on the requestor's own servant")
                        fleet.held[s["location"]] += 1
                        held = fleet.held[s["location"]]
                        if held > s["capacity"]:
                            fleet.violations.append(
                                f"{s['location']} over capacity "
                                f"{held}/{s['capacity']}")
                with lock:
                    dup = grant_ids.intersection(ids)
                    if dup or len(set(ids)) != len(ids):
                        fleet.violations.append(f"duplicate ids {dup}")
                    grant_ids.update(ids)
                    totals["grants"] += len(ids)
                    totals["calls"] += 1
                    latencies.append(lat)
                    if totals["grants"] >= MIN_GRANTS:
                        done.set()
                with fleet.lock:
                    for g in resp.grants:
                        fleet.held[g.servant_location] -= 1
                if ids:
                    chan.call(SERVICE_NAME, "FreeTask",
                              sch.FreeTaskRequest(token="utok",
                                                  task_grant_ids=ids),
                              sch.FreeTaskResponse, timeout=30.0)
        except Exception as e:  # reported by the main thread below
            errors.append(f"delegate {d}: {e!r}")
            done.set()

    t0 = time.perf_counter()
    workers = [threading.Thread(target=delegate, args=(d,))
               for d in range(N_DELEGATES)]
    for t in workers:
        t.start()
    while not done.wait(1.0):
        check(proc.poll() is None, f"{name}: scheduler died "
                                   f"(rc {proc.returncode})")
        check(time.perf_counter() - t0 < PHASE_LIMIT_S,
              f"{name}: {totals['grants']} grants in {PHASE_LIMIT_S}s")
    for t in workers:
        t.join(timeout=60)
        check(not t.is_alive(), f"{name}: a delegate hung")
    elapsed = time.perf_counter() - t0
    check(not errors, f"{name}: {errors[:3]}")
    check(not fleet.violations, f"{name}: {fleet.violations[:5]}")
    check(totals["grants"] >= MIN_GRANTS,
          f"{name}: only {totals['grants']} grants")

    state = inspect_vars(iport)["yadcc"]
    launches = {k: v["launches"] for k, v in state["kernels"].items()}
    td = state["task_dispatcher"]
    check(td["failure"] is None, f"{name}: dispatcher failed: "
                                 f"{td['failure']}")
    check(td["grants_outstanding"] == 0,
          f"{name}: {td['grants_outstanding']} grants still outstanding "
          f"after every delegate freed its grants")
    check(td["stats"]["granted"] == totals["grants"],
          f"{name}: scheduler granted {td['stats']['granted']}, delegates "
          f"saw {totals['grants']}")
    check(launches[kernel] > 0, f"{name}: {kernel} never launched")
    # The resident pool's counters over the drive (its warmup's are
    # subtracted); absent for the other policies.
    resident = {k: v - stream_before.get(k, 0)
                for k, v in td["stream"].items()
                if k in ("seeds", "delta_launches", "delta_slots",
                         "full_syncs", "oracle_checks", "oracle_mismatches")}

    lat = sorted(latencies)
    res = dict(
        grants=totals["grants"], calls=totals["calls"],
        empty_calls=totals["empty"], seconds=elapsed,
        grants_per_s=totals["grants"] / elapsed,
        p50_ms=lat[len(lat) // 2] * 1e3,
        p99_ms=lat[min(len(lat) - 1, int(len(lat) * 0.99))] * 1e3,
        launches=launches, boot_s=boot_s, register_s=reg_s,
        resident=resident)
    report.append(
        f"  {name}: {res['grants']} grants in {elapsed:.2f} s = "
        f"{res['grants_per_s']:.1f} grants/s over {res['calls']} calls "
        f"({res['empty_calls']} empty); WaitForStartingTask p50 "
        f"{res['p50_ms']:.2f} ms p99 {res['p99_ms']:.2f} ms; kernel "
        f"launches {json.dumps(launches)}; boot {boot_s:.1f} s, "
        f"{N_SERVANTS} servants registered in {reg_s:.1f} s; no "
        f"violations")
    report.append(f"  {name} dispatcher stages: "
                  f"{json.dumps(td['latency_breakdown'])}")
    return res


# ---------------------------------------------------------------------------
# Phase 7: the Bloom path.
# ---------------------------------------------------------------------------

BLOOM_N = 1_000_000                   # the batch and the populated keys
BLOOM_EDGE_LENGTHS = tuple(range(35)) + (63, 64, 65, 80, 100, 200)
BLOOM_EDGE_BITS = (64, 1000, 27_584_639)
BLOOM_EDGE_HASHES = (1, 7, 10)
BLOOM_EDGE_SALTS = (0, 17, (1 << 63) + 5)
BLOOM_EDGE_N = (1, 257, 1000)         # 257: not a multiple of the block
# 32-bit operations charged to each 64-bit step of XXH64 (a 64-bit
# multiply's low half is a wide 32x32 product and two cross products; an
# add, xor, rotate or shift is two 32-bit operations), to each probe
# evaluated (multiply-add, mod, word index, bit shift, test) and to each
# probe bit set by the scatter (the same, with the atomic OR for the test).
XXH_MUL, XXH_STEP = 4, 2
BLOOM_PROBE_OPS = 5


def xxh64_ops(length: int) -> int:
    """32-bit operations XXH64 needs for one key of ``length`` bytes, step
    by step as csrc/bloom.cu:xxh64_row takes them."""
    m, s = XXH_MUL, XXH_STEP
    rnd = 2 * m + 2 * s                  # acc + lane*P2, rotl, *P1
    ops, pos = 0, 0
    if length >= 32:
        stripes = length // 32
        ops += 3 * s + stripes * 4 * rnd + 4 * s + 3 * s
        ops += 4 * (2 * m + s + s + m + s)   # four merge rounds
        pos = stripes * 32
    else:
        ops += s
    ops += s                             # h += length
    while pos + 8 <= length:
        ops += (2 * m + s) + s + s + m + s
        pos += 8
    if pos + 4 <= length:
        ops += m + s + s + m + s
        pos += 4
    ops += (length - pos) * (m + s + s + m + 2)   # byte extract: 2
    ops += 3 * 2 * s + 2 * m + 1         # avalanche, then the split's OR
    return ops


def probes_needed(words, fps, num_bits: int, num_hashes: int):
    """Probes the early-exit test evaluates for each key on this data: up
    to and including the first zero bit, all K for a member."""
    import numpy as np

    i = np.arange(num_hashes, dtype=np.uint32)[None, :]
    idx = (fps[:, :1] + i * fps[:, 1:]) % np.uint32(num_bits)
    bits = (words[idx >> 5] >> (idx & 31)) & 1
    zero = bits == 0
    first = np.where(zero.any(axis=1), zero.argmax(axis=1) + 1, num_hashes)
    return first.astype(np.int64), ~zero.any(axis=1)


def bloom_bound(nbytes: int, ops: int) -> dict:
    by_bytes = nbytes / H100_BYTES_PER_S * 1e3
    by_ops = ops / H100_OPS_PER_S * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations",
            "bytes": nbytes, "ops": ops}


def _bloom_filter(rng, num_bits, num_hashes, salt, members, dense):
    """A host filter of the given geometry whose words are random bits,
    each set with probability 7/8 (``dense``) or 1/4, with ``members``
    added on top."""
    import numpy as np

    from yadcc_tpu_torch.common import bloom

    nw = (num_bits + 31) // 32
    a, b, c = (rng.integers(0, 1 << 32, nw, dtype=np.uint32)
               for _ in range(3))
    words = ~(a & b & c) if dense else a & b
    f = bloom.SaltedBloomFilter(num_bits, num_hashes, salt, words)
    f.add_many(members)
    return f


def compare_bloom_edges(report: list) -> None:
    """Phase 7 (a): every Bloom kernel against its plain version on the
    card, and both against the host filter, at tolerance 0 on the edge
    pool; the empty batch; the refusals."""
    import numpy as np
    import torch

    from yadcc_tpu_torch.common import bloom
    from yadcc_tpu_torch.ops import bloom_pipeline as bpl
    from yadcc_tpu_torch.ops import bloom_probe as bpr
    from yadcc_tpu_torch.ops import cuda_bloom as kb
    from yadcc_tpu_torch.ops.xxh64_torch import pack_keys

    dev = torch.device("cuda")
    rng = np.random.default_rng(70)
    nb3, nk3, ns3 = (len(BLOOM_EDGE_BITS), len(BLOOM_EDGE_HASHES),
                     len(BLOOM_EDGE_SALTS))
    cases = 0
    for j, length in enumerate(BLOOM_EDGE_LENGTHS):
        n = BLOOM_EDGE_N[(j // 2) % len(BLOOM_EDGE_N)]
        nbits = BLOOM_EDGE_BITS[j % nb3]
        k = BLOOM_EDGE_HASHES[(j // nb3) % nk3]
        salt = BLOOM_EDGE_SALTS[(j // (nb3 * nk3)) % ns3]
        fk = BLOOM_EDGE_HASHES[(j + 1) % nk3]
        fsalt = BLOOM_EDGE_SALTS[(j + 1) % ns3]
        keys = [rng.bytes(length) for _ in range(n)]
        region = _bloom_filter(rng, nbits, k, salt, keys[::2], True)
        fleet = _bloom_filter(rng, nbits, fk, fsalt, keys[1::3], True)
        want = region.may_contain_batch(keys)
        want_fleet = fleet.may_contain_batch(keys)
        words = bpl.as_device_words(region.words, dev)
        fwords = bpl.as_device_words(fleet.words, dev)
        packed = bpl.as_device_words(pack_keys(keys, length), dev)
        seed, fseed = bpl.seed_pair(salt), bpl.seed_pair(fsalt)
        fps_host = bloom.key_fingerprints(keys, salt)
        fps = bpl.as_device_words(fps_host, dev)
        geo = dict(num_bits=nbits, num_hashes=k)
        tag = f"length {length} n {n} bits {nbits} K {k} salt {salt}"

        got = kb.bloom_membership(words, packed, length, seed, **geo)
        plain = bpl.membership_plain(words, packed, length, seed, nbits, k)
        check(torch.equal(got, plain), f"membership != plain: {tag}")
        check(np.array_equal(got.cpu().numpy(), want),
              f"membership != host: {tag}")
        got = kb.bloom_cascade(words, fwords, packed, length, seed, fseed,
                               num_bits=nbits, num_hashes_region=k,
                               num_hashes_fleet=fk)
        plain = bpl.cascade_plain(words, fwords, packed, length, seed,
                                  fseed, nbits, k, fk)
        check(torch.equal(got, plain), f"cascade != plain: {tag}")
        check(np.array_equal(got.cpu().numpy(), want | want_fleet),
              f"cascade != host OR: {tag}")
        got = kb.bloom_probe(words, fps, **geo)
        check(torch.equal(got, bpr.probe_body(words, fps, nbits, k)),
              f"probe != plain: {tag}")
        check(np.array_equal(got.cpu().numpy(), want),
              f"probe != host: {tag}")
        base = _bloom_filter(rng, nbits, k, salt, [], False)
        base_words = base.words.copy()
        bwords = bpl.as_device_words(base_words, dev)
        got = kb.bloom_scatter_or(bwords, fps, **geo)
        check(torch.equal(got, bpr.scatter_add_plain(bwords, fps, nbits, k)),
              f"scatter_or != plain: {tag}")
        base.add_many(keys)
        check(np.array_equal(got.cpu().numpy().view(np.uint32), base.words),
              f"scatter_or != add_many: {tag}")
        check(np.array_equal(bwords.cpu().numpy().view(np.uint32),
                             base_words),
              f"scatter_or changed its input: {tag}")
        cases += 1
    torch.cuda.synchronize()

    # The empty batch: an empty result, no launch.
    before = dict(kb.launches)
    geo = dict(num_bits=1000, num_hashes=7)
    w = torch.zeros(32, dtype=torch.int32, device=dev)
    e0 = torch.zeros((0, 2), dtype=torch.int32, device=dev)
    check(kb.bloom_membership(w, torch.zeros((0, 4), dtype=torch.int32,
                                             device=dev), 9, (0, 0),
                              **geo).shape == (0,), "empty membership")
    check(kb.bloom_cascade(w, w, torch.zeros((0, 0), dtype=torch.int32,
                                             device=dev), 0, (0, 0), (0, 1),
                           num_bits=1000, num_hashes_region=7,
                           num_hashes_fleet=3).shape == (0,),
          "empty cascade")
    check(kb.bloom_probe(w, e0, **geo).shape == (0,), "empty probe")
    check(torch.equal(kb.bloom_scatter_or(w, e0, **geo), w), "empty scatter")
    check(kb.launches == before, "an empty batch launched a kernel")

    # Refusals: dtype, device, shape, contiguity, geometry.
    packed = torch.zeros((4, 2), dtype=torch.int32, device=dev)
    fps = torch.zeros((4, 2), dtype=torch.int32, device=dev)
    bad = [
        ("int64 words", lambda: kb.bloom_membership(
            w.long(), packed, 5, (0, 0), **geo)),
        ("packed keys on the CPU", lambda: kb.bloom_membership(
            w, packed.cpu(), 5, (0, 0), **geo)),
        ("packed width for another length", lambda: kb.bloom_membership(
            w, packed, 9, (0, 0), **geo)),
        ("int64 fingerprints", lambda: kb.bloom_probe(w, fps.long(), **geo)),
        ("non-contiguous fingerprints", lambda: kb.bloom_probe(
            w, torch.zeros((4, 4), dtype=torch.int32, device=dev)[:, ::2],
            **geo)),
        ("fleet words on the CPU", lambda: kb.bloom_cascade(
            w, w.cpu(), packed, 5, (0, 0), (0, 0), num_bits=1000,
            num_hashes_region=7, num_hashes_fleet=7)),
        ("words shorter than num_bits", lambda: kb.bloom_scatter_or(
            w, fps, num_bits=1025, num_hashes=7)),
        ("[N, 3] fingerprints", lambda: kb.bloom_scatter_or(
            w, torch.zeros((4, 3), dtype=torch.int32, device=dev), **geo)),
    ]
    for what, call in bad:
        try:
            call()
        except (TypeError, ValueError):
            continue
        raise SmokeFailure(f"bloom wrapper accepted {what}")
    check(kb.launches == before, "a refused call launched a kernel")
    report.append(f"  bloom edge pool: {cases} cases (lengths "
                  f"{BLOOM_EDGE_LENGTHS[0]}..{BLOOM_EDGE_LENGTHS[-1]}, n "
                  f"{BLOOM_EDGE_N}, bits {BLOOM_EDGE_BITS}, K "
                  f"{BLOOM_EDGE_HASHES}, salts {BLOOM_EDGE_SALTS}): "
                  f"membership, cascade, probe and scatter_or equal to "
                  f"their plain versions and to the host filter; empty "
                  f"batch and {len(bad)} refusals without a launch")


def compare_bloom_main(report: list) -> dict:
    """Phase 7 (b, c): every Bloom kernel against its plain version and
    the host chain at the main path's shapes (1M production-format keys,
    27,584,639 bits, 10 hashes; the cascade's fleet filter with 7 hashes
    and another salt), then each kernel's time beside its plain version's
    and its bound.  Membership also at the JAX bench's 23-byte keys."""
    import numpy as np
    import torch

    from yadcc_tpu_torch.common import bloom
    from yadcc_tpu_torch.ops import bloom_pipeline as bpl
    from yadcc_tpu_torch.ops import bloom_probe as bpr
    from yadcc_tpu_torch.ops import cuda_bloom as kb
    from yadcc_tpu_torch.tools.bloom_bench import (FLEET_HASHES, FLEET_SALT,
                                                   SALT, production_keys)

    dev = torch.device("cuda")
    n = BLOOM_N
    members = production_keys(n, seed=11)
    region = bloom.SaltedBloomFilter(salt=SALT)
    region.add_many(members)
    fleet_only = production_keys(n // 4, seed=12)
    fleet = bloom.SaltedBloomFilter(num_hashes=FLEET_HASHES,
                                    salt=FLEET_SALT)
    fleet.add_many(fleet_only + members[:n // 10])
    nb, k = region.num_bits, region.num_hashes
    nw = region.words.shape[0]
    words = bpl.as_device_words(region.words, dev)
    fwords = bpl.as_device_words(fleet.words, dev)
    seed, fseed = bpl.seed_pair(SALT), bpl.seed_pair(FLEET_SALT)
    # Half members, a tenth fleet keys, the rest absent from both.
    batches = {
        "production": (members[: n // 2] + fleet_only[: n // 10]
                       + production_keys(n - n // 2 - n // 10, seed=13)),
        "bench_23_bytes": [f"ytpu-cxx2-entry-{i:07d}" for i in range(n)],
    }
    out = {}
    for name, keys in batches.items():
        ((length, _, packed_np),) = bpl.pack_key_buckets(keys)
        packed = bpl.as_device_words(packed_np, dev)
        row_bytes = packed_np.shape[1] * 4
        want = region.may_contain_batch(keys)
        fps_np = bloom.key_fingerprints(keys, SALT)
        per_key, member = probes_needed(region.words, fps_np, nb, k)
        check(np.array_equal(member, want), f"{name}: probe model != host")
        got = kb.bloom_membership(words, packed, length, seed, num_bits=nb,
                                  num_hashes=k)
        plain = bpl.membership_plain(words, packed, length, seed, nb, k)
        check(torch.equal(got, plain), f"{name}: membership != plain")
        check(np.array_equal(got.cpu().numpy(), want),
              f"{name}: membership != host filter")
        if name == "production":
            check(bool(want[: n // 2].all()), "members must test positive")
            check(not bool(want[n // 2:].all()), "absent keys all positive")
        digest = xxh64_ops(length)
        mem = {
            "ms": timed(lambda: kb.bloom_membership(
                words, packed, length, seed, num_bits=nb, num_hashes=k), 50),
            "plain_ms": timed(lambda: bpl.membership_plain(
                words, packed, length, seed, nb, k), 3),
            "key_bytes": length, "positive_rate": float(want.mean()),
            "probes_per_key": float(per_key.mean()),
            **bloom_bound(n * row_bytes + nw * 4 + n,
                          n * digest + int(per_key.sum()) * BLOOM_PROBE_OPS),
        }
        out[name] = mem
        if name != "production":
            continue
        # The cascade: the fleet digest runs only for keys the region
        # rejects.
        fps_fleet = bloom.key_fingerprints(keys, FLEET_SALT)
        per_key_f, _ = probes_needed(fleet.words, fps_fleet, nb,
                                     FLEET_HASHES)
        want_c = want | fleet.may_contain_batch(keys)
        cas_args = (words, fwords, packed, length, seed, fseed)
        cas_geo = dict(num_bits=nb, num_hashes_region=k,
                       num_hashes_fleet=FLEET_HASHES)
        got = kb.bloom_cascade(*cas_args, **cas_geo)
        check(torch.equal(got, bpl.cascade_plain(
            *cas_args, nb, k, FLEET_HASHES)), "cascade != plain")
        check(np.array_equal(got.cpu().numpy(), want_c),
              "cascade != the host OR")
        rejected = ~want
        out["cascade"] = {
            "ms": timed(lambda: kb.bloom_cascade(*cas_args, **cas_geo), 50),
            "plain_ms": timed(lambda: bpl.cascade_plain(
                *cas_args, nb, k, FLEET_HASHES), 3),
            "positive_rate": float(want_c.mean()),
            **bloom_bound(
                n * row_bytes + 2 * nw * 4 + n,
                (n + int(rejected.sum())) * digest
                + (int(per_key.sum()) + int(per_key_f[rejected].sum()))
                * BLOOM_PROBE_OPS),
        }
        # The probe from host fingerprints.
        fps = bpl.as_device_words(fps_np, dev)
        got = kb.bloom_probe(words, fps, num_bits=nb, num_hashes=k)
        check(torch.equal(got, bpr.probe_body(words, fps, nb, k)),
              "probe != plain")
        check(np.array_equal(got.cpu().numpy(), want), "probe != host")
        out["probe"] = {
            "ms": timed(lambda: kb.bloom_probe(words, fps, num_bits=nb,
                                               num_hashes=k), 50),
            "plain_ms": timed(lambda: bpr.probe_body(words, fps, nb, k), 3),
            **bloom_bound(n * 8 + nw * 4 + n,
                          int(per_key.sum()) * BLOOM_PROBE_OPS),
        }
        # The filter built on the card from the members' fingerprints.
        mfps = bpl.as_device_words(bloom.key_fingerprints(members, SALT),
                                   dev)
        empty = torch.zeros_like(words)
        got = kb.bloom_scatter_or(empty, mfps, num_bits=nb, num_hashes=k)
        check(torch.equal(got, bpr.scatter_add_plain(empty, mfps, nb, k)),
              "scatter_or != plain")
        check(np.array_equal(got.cpu().numpy().view(np.uint32),
                             region.words), "scatter_or != add_many")
        out["scatter_or"] = {
            "ms": timed(lambda: kb.bloom_scatter_or(
                empty, mfps, num_bits=nb, num_hashes=k), 50),
            "plain_ms": timed(lambda: bpr.scatter_add_plain(
                empty, mfps, nb, k), 3),
            **bloom_bound(n * 8 + 2 * nw * 4, n * k * BLOOM_PROBE_OPS),
        }
    torch.cuda.synchronize()
    for name, r in out.items():
        report.append(
            f"  bloom {name}: kernel {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.3f} ms, bound {r['bound_ms']:.5f} ms "
            f"({r['bound_by']}: {r['bytes']:,} B, {r['ops']:,} ops); equal "
            f"to plain and host")
    return out


def run_bloom_main_path(report: list) -> dict:
    """Phase 7 (d): the slice's entry point, tools/bloom_bench.run at 1M
    production-format keys against a 1M-key filter on the card, with every
    Bloom launch count set to 0 just before and read just after."""
    from yadcc_tpu_torch.ops import cuda_bloom as kb
    from yadcc_tpu_torch.tools import bloom_bench

    for name in kb.launches:
        kb.launches[name] = 0
    t0 = time.perf_counter()
    res = bloom_bench.run(BLOOM_N, BLOOM_N, device="cuda")
    wall = time.perf_counter() - t0
    launched = dict(kb.launches)
    for name, count in launched.items():
        check(count > 0, f"bloom main path: kernel {name} never launched")
    report.append(f"  bloom_bench.run({BLOOM_N:,}, {BLOOM_N:,}) in "
                  f"{wall:.1f} s, launches {launched}; device build "
                  f"{res['device_build']['kernel_seconds'] * 1e3:.4f} ms")
    for s in res["sweep"]:
        hv, df, cs = s["host_vectorized"], s["device_fused"], s["cascade"]
        report.append(
            f"  hit rate {s['hit_rate']}: positive "
            f"{s['observed_positive_rate']} (cascade "
            f"{s['cascade_positive_rate']}); host-vectorized pack "
            f"{hv['pack_seconds'] * 1e3:.2f} + digest "
            f"{hv['fingerprint_seconds'] * 1e3:.2f} + upload "
            f"{hv['upload_seconds'] * 1e3:.2f} + probe "
            f"{hv['probe_seconds'] * 1e3:.4f} ms; device-fused pack "
            f"{df['pack_seconds'] * 1e3:.2f} + upload "
            f"{df['upload_seconds'] * 1e3:.2f} + kernel "
            f"{df['kernel_seconds'] * 1e3:.4f} ms, end to end "
            f"{df['end_to_end_seconds'] * 1e3:.2f} ms "
            f"({df['keys_per_sec']:,.0f} keys/s); cascade kernel "
            f"{cs['kernel_seconds'] * 1e3:.4f} ms, end to end "
            f"{cs['end_to_end_seconds'] * 1e3:.2f} ms")
    return {"launches": launched, "bench": res, "wall_s": wall}


# ---------------------------------------------------------------------------


def main() -> int:
    try:
        import torch
    except ImportError as e:
        print(f"chip_smoke: torch unavailable: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    try:
        import yadcc_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: run from a checkout of the repository: {e}",
              file=sys.stderr)
        return 2

    t_start = time.perf_counter()
    card = card_line()
    log(card)   # as nvidia-smi prints it: name, power limit
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    built = build_kernels()
    log(f"phase 1 build (wall {built.pop('total_s'):.2f} s): " + "; ".join(
        f"{src} -> {b['library']} (nvcc {b['nvcc_s']:.2f} s)"
        for src, b in built.items()))

    report: list = []
    timing = compare_kernel(report)
    compare_resident_step(report)
    k2 = compare_assign_batch(report)
    log("phase 2 kernels vs plain (tolerance 0):")
    for line in report:
        log(line)

    report = []
    phases = {
        "pipelined": run_main_path("pipelined", [], Fleet(seed=1), report),
        "synchronous": run_main_path(
            "synchronous", ["--dispatch-pipeline-depth", "0"], Fleet(seed=2),
            report),
        "batched": run_main_path(
            "batched", ["--dispatch-policy", "torch_batched"], Fleet(seed=3),
            report, kernel="assign_batch"),
        "resident": run_main_path(
            "resident", ["--dispatch-policy", "torch_resident_grouped",
                         "--dispatch-pipeline-depth", "16"], Fleet(seed=4),
            report),
    }
    rs = phases["resident"]["resident"]
    check(rs["delta_launches"] + rs["full_syncs"] > 0,
          "resident: no resident step ran")
    check(rs["oracle_checks"] > 0, "resident: the statics oracle never ran")
    check(rs["oracle_mismatches"] == 0,
          f"resident: {rs['oracle_mismatches']} oracle mismatches")
    report.append(
        f"  resident pool over the drive: seeds {rs['seeds']} / "
        f"delta_launches {rs['delta_launches']} / delta_slots "
        f"{rs['delta_slots']} / full_syncs {rs['full_syncs']}; oracle "
        f"checks {rs['oracle_checks']}, mismatches "
        f"{rs['oracle_mismatches']}")
    log("phases 3-6 main paths:")
    for line in report:
        log(line)

    report = []
    t7 = time.perf_counter()
    compare_bloom_edges(report)
    bloom_timing = compare_bloom_main(report)
    bloom_run = run_bloom_main_path(report)
    log(f"phase 7 the Bloom path ({time.perf_counter() - t7:.1f} s; "
        f"kernels vs plain at tolerance 0):")
    for line in report:
        log(line)

    def by_phase(kernel):
        return {name: r["launches"][kernel] for name, r in phases.items()}

    main = timing[MAIN_G]
    record = {"kernels": [{
        "name": "grouped_assign",
        "route": "cuda",
        "source": "yadcc_tpu_torch/csrc/grouped_assign.cu",
        "replaces": "yadcc_tpu/ops/pallas_grouped.py:201",
        "launches": sum(by_phase("grouped_assign").values()),
        "max_abs_err": 0,
        "ms": main["ms"],
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"],
        "library_ms": None,
        "one_sm_floor_ms": main["one_sm_floor_ms"],
        "us_per_group": main["us_per_group"],
        "shape": {"S": MAIN_S, "G": MAIN_G, "tasks": MAIN_TASKS, "E": 8},
        "at_G8": {k: timing[8][k] for k in ("ms", "plain_ms", "bound_ms")},
        "serving_like": {k: timing["serving_like"][k] for k in
                         ("ms", "plain_ms", "bound_ms", "one_sm_floor_ms",
                          "mean_active_slots", "bisect_steps")},
        "launches_by_phase": by_phase("grouped_assign"),
        "wrappers": {name: {k: timing[name][k] for k in
                            ("ms", "plain_ms", "bound_ms", "bound_by")}
                     for name in ("picks", "picks_packed", "picks_stream",
                                  "resident_step")},
    }, {
        "name": "assign_batch",
        "route": "cuda",
        "source": "yadcc_tpu_torch/csrc/assign_batch.cu",
        "replaces": "yadcc_tpu/ops/pallas_assign.py:118",
        "launches": sum(by_phase("assign_batch").values()),
        "max_abs_err": 0,
        "ms": k2["timing"]["ms"],
        "plain_ms": k2["timing"]["plain_ms"],
        "bound_ms": k2["timing"]["bound_ms"],
        "bound_by": k2["timing"]["bound_by"],
        "library_ms": None,
        "one_sm_floor_ms": k2["timing"]["one_sm_floor_ms"],
        "us_per_task": k2["timing"]["us_per_task"],
        "work": k2["timing"]["work"],
        "shape": {"S": MAIN_S, "T": MAIN_T, "E": 8},
        "runs_batch": {k: k2["runs"][k] for k in
                       ("ms", "plain_ms", "bound_ms", "bound_by",
                        "one_sm_floor_ms", "us_per_task", "work")},
        "launches_by_phase": by_phase("assign_batch"),
    }]}
    bloom_shape = {"N": BLOOM_N, "key_bytes": 80, "num_bits": 27_584_639,
                   "num_hashes": 10}
    bloom_kernels = (
        ("bloom", "membership", "production",
         "yadcc_tpu/ops/bloom_pipeline.py:43"),
        ("bloom_cascade", "cascade", "cascade",
         "yadcc_tpu/parallel/mesh.py:478"),
        ("bloom_probe", "probe", "probe", "yadcc_tpu/ops/bloom_probe.py:46"),
        ("bloom_scatter_or", "scatter_or", "scatter_or",
         "yadcc_tpu/ops/bloom_probe.py:58"),
    )
    for name, kernel, timing_key, replaces in bloom_kernels:
        t = bloom_timing[timing_key]
        record["kernels"].append({
            "name": name,
            "route": "cuda",
            "source": "yadcc_tpu_torch/csrc/bloom.cu",
            "replaces": replaces,
            "launches": bloom_run["launches"][kernel],
            "max_abs_err": 0,
            "ms": t["ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"],
            "library_ms": None,
            "shape": bloom_shape,
        })
    record["kernels"][2]["at_23_bytes"] = {
        k: bloom_timing["bench_23_bytes"][k]
        for k in ("ms", "plain_ms", "bound_ms", "bound_by")}
    record["kernels"][2]["fused_split_ms"] = {
        str(s["hit_rate"]): {
            k.replace("_seconds", ""): s["device_fused"][k] * 1e3
            for k in ("pack_seconds", "upload_seconds", "kernel_seconds",
                      "end_to_end_seconds")}
        for s in bloom_run["bench"]["sweep"]}
    log("main paths ({}): {}; total {:.1f} s".format(card, "; ".join(
        f"{name} {r['grants_per_s']:.1f} grants/s p99 {r['p99_ms']:.2f} ms"
        for name, r in phases.items()), time.perf_counter() - t_start))
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
