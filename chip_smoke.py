#!/usr/bin/env python3
"""On-card smoke test of yadcc_tpu_torch, the scheduler's grant path on CUDA.

Run from the root of a checkout on a machine with one NVIDIA card:

    python3 chip_smoke.py

Phases (any failure exits non-zero without printing the result line):

1. card and build: the card's name and power limit, then every kernel
   source built from csrc/ with nvcc, one nvcc per source, all started
   together: the grouped assignment (K1), the sequential scan (K2) and
   the Bloom and placement kernels (bloom.cu);
2. kernels vs plain: K1 and its five wrappers (the resident step chained
   over cycles with churn among them), and K2, held against the plain
   PyTorch versions on the card, exactly (integer arithmetic, so the
   tolerance is 0), on seeded and edge pools; K1's counts and K2's
   (descriptor changes, owner rescans, reductions) held against the host
   models of their designs (k1_model, k2_model); the wrappers must refuse
   tensors the kernels do not take; K1 over a grid of shards (the fused
   control-plane step, one block a shard) against the plain fused step,
   chained, at N = 1, 2 and 8 shards with uneven loads, an idle shard,
   padding beside the next shard's slot 0 and shards beyond shared
   memory; the kernels' times, the grid at 8 shards x 8,192 slots beside
   one and eight single-shard launches; the spill-placement kernel
   (csrc/bloom.cu: the cells x tasks score and its argmin in one launch,
   through one native call from the staged input to the readback)
   against placement_score_plain and the host oracle at 1, 3, 7 and 8
   cells, 1 and 8 tasks, 1, 32 and 256 keys of 23 and 80 bytes, three
   salts, two geometries, with filterless, ineligible and all-ineligible
   cells, a tie, padding keys and a mixed batch; on grids of several
   blocks (C x N of 264 to 9,000 pairs, most not a multiple of 256, 300
   cells, 4,096 tasks); one slot reused 100 times across three shapes and
   8 threads calling at once on their own slots, every result against
   the host oracle; its refusals; and its time at a spill decision's
   shape and at 8 cells x 256 keys x 8 tasks beside an empty launch's;
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
   80, 100, 200, 4096; 1, 257 and 1,000 keys; 64, 1,000 and 27,584,639
   bits; 1, 7 and 10 hashes; salts 0, 17 and 2^63 + 5), the empty batch
   and the refusals; (a'') the probe and scatter-OR kernels on
   fingerprints drawn from a seed, not from a digest (even h2, h2 = 0,
   h2 = 2^32 - 1, h1 + i*h2 wrapping; 1, 33, 1,000, 27,584,639 and
   2^31 + 11 bits; 0, 1, 7 and 10 hashes; 1, 255, 257 and 1M keys; a
   batch whose every probe falls in one slice of the scatter; a build in
   two passes; fingerprints only 4-byte aligned; words longer than the
   filter's), against their plain versions and the host arithmetic,
   the scatter's input and extra words unchanged; (a') the membership
   and cascade kernels around their tile (tile - 1, tile, tile + 1 and
   2 * tile + 1 keys; staged and unstaged row widths; `packed` views 0-3
   words past a 16-byte boundary); (b, c) every kernel at the main path's shapes (1M
   production-format keys of 80 bytes, the production geometry; the
   membership also at 23-byte keys), each kernel's time beside its plain
   version's and its bound; (c') the membership and cascade kernels on
   the bench's batches at 1%, 10% and 50% hits, each with its time and
   the share of its bound; (d) the slice's entry point,
   tools/bloom_bench.run(1M, 1M) on the card, with every Bloom launch
   count set to 0 just before and each > 0 just after;
8. the sharded scheduler: phase 3's drive with --shards 4 (four shard
   dispatchers behind the consistent-hash router, each policy on a CUDA
   stream of its own), >= 100,000 grants, phase 3's checks plus: every
   grant id routes to the shard that issued it and is freed there; then
   the same scheduler built in process and driven without RPC under
   torch.profiler: how many K1 launches overlap, the card's busy share;
9. the fused control plane, in process: a ShardRouter of 8 shards x
   8,192 slots, 40,000 servants, two tenants with budgets, delegate
   threads ruled by admission and granted through >= 1,000 fused cycles
   (each one launch of K1 over the grid of 8 shards); no tenant's ledger
   above its budget, every ledger 0 at the end, the fused oracle clean,
   the load summary equal to the host's; the routing hash's cost a call;
10. the warm-standby takeover: a --standby entry (its policy warmed on
   the card at boot) behind an active entry with phase 3's defaults and
   --replicate-to; 5,000 servants; 24 delegates drive >= 50,000 grants,
   each holding its first 8 (renewed); SIGKILL of the active mid-drive,
   the grants of its last 0.1 s held as well (the journal's gap); before
   the promotion the standby refuses (REJECT with a retry-after,
   NOT_SERVING with the hint); after it the fleet re-heartbeats with what
   it runs, every held grant renews once, >= 100,000 more grants go
   through the standby's K1; phase 3's checks across the kill (adopted
   grants counted), no id issued twice, the standby's outstanding grants
   0 at the end, its K1 launches 0 before the promotion and > 0 after;
11. the federation plane, in process: 8 cells of 1,024 slots (auto on
   the card, each on its own stream), phase 3's servants split by cell,
   cell 0 held at the spillover rung, each peer's production-geometry
   filter built on the card by the scatter-OR; >= 2,000 scored spill
   decisions, every pick and score row equal to the host oracle's, the
   kernel's launches equal to the scored decisions, spilled grants'
   renewals and frees routed home, no id in two cells;
12. the aio front end: phase 3's drive through --rpc-frontend aio (the
   event-loop server; WaitForStartingTask parked as a continuation in
   the dispatcher's pending table, fired by the pipelined dispatch
   thread), every client dialling aio://, phase 3's checks plus no
   refused second reply (`yadcc/rpc_server` double_replies 0); then
   phase 4's synchronous drive on it (>= 100,000 grants: the inline
   leader runs each cycle on the event loop, one request deep, so K1's
   launches there are reported, not required), with the loop's lag; then a
   parked burst on the pipelined entry: 2,000 AsyncAioChannel delegates
   on one client loop each park one wait on an env whose slots are all
   held, 1,500 answered with one grant each once the slots are freed,
   500 with NO_QUOTA at their deadline, the entry's RSS and threads read
   before the burst and with every wait parked; each beside its
   threaded twin of the same call;
13. the sharded scheduler on aio: phase 8's drive through --rpc-frontend
   aio --accept-loops 4 --shards 4 (>= 100,000 grants), phase 8's checks;
   then on the same entry a hot delegate asks for more grants than its
   home shard's whole capacity: the router's asynchronous steal must pull
   grants from the other shards (stolen > 0 in the reply and in
   task_dispatcher.steal), every grant valid and freed.

The second-to-last line is the kernels' JSON record, the last line
{"ok": true, "device": {...}}.  Logs of the scheduler processes go to
smoke_logs/.
"""

from __future__ import annotations

import collections
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
SHARDS = 4                     # phase 8's --shards
SHARDED_MIN_GRANTS = 100_000
OVERLAP_WINDOW_S = 3.0         # phase 8's in-process profile
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
    CUDA events on the current stream.  The calls are queued behind a
    device-side spin twice as long as their host time (at most 0.25 s),
    so that a kernel shorter than its wrapper's launch overhead is timed
    back to back on the card, not at the host's pace."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(True), torch.cuda.Event(True)
    # _sleep spins for a count of SM clock cycles; at most 2 GHz on an H100.
    torch.cuda._sleep(int(min(0.25, 2 * reps * host_s) * 2e9))
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


def k1_cost(p, groups, pad) -> dict:
    """What K1's function needs on one pool and batch (``groups`` padded
    to ``pad`` with count-0 groups): k1_model's counts and per-group work,
    the operations, and the bytes (each input read once, each output
    written once)."""
    padded = list(groups) + [(0, 0, -1, 0)] * (pad - len(groups))
    counts, _, work = k1_model(p, padded)
    s, e = p["env_bitmap"].shape
    # The search's evaluations plus the tie split's two (tau - 1, tau).
    ops = (s * K1_OPS_TEST * sum(1 for *_, m in padded if m > 0)
           + sum((it + 2) * ((n + nd) * K1_OPS_FORM + n) + nd * K1_OPS_FORM
                 for n, nd, it in work))
    return dict(counts=counts, work=work, ops=ops,
                bytes=s * (6 + e) * 4 + pad * s * 4 + s * 4)


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
    cost = k1_cost(p, groups, pad)
    check(np.array_equal(cost["counts"], counts),
          "K1 timing: the host model's counts differ from the kernel's")
    work, ops = cost["work"], cost["ops"]
    active = [n for n, _, _ in work]
    steps = [it for _, _, it in work]
    bytes_ms = cost["bytes"] / H100_BYTES_PER_S * 1e3
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


# The fused step's shard grid (the sharded control plane, phase 9's K1):
# N shard pools of `per` slots in one launch, one block a shard.
GRID_N = 8


def fused_cycle_inputs(rng, hosts, loads, dev):
    """One cycle of the fused step's stacked inputs for the shard pools
    ``hosts`` (numpy, mutated by the cycle's statics churn): ``loads[k]``
    is (groups, tasks) for shard k or None for a shard with no work (zero
    descriptors, an all-padding delta).  Every working shard after the
    first also sends its slot 0, so in the flattened delta a padding entry
    sits right before a real row for the next shard's slot 0.  G and the
    delta are padded to the cycle's maxima, as the router pads them."""
    import numpy as np
    import torch

    from yadcc_tpu_torch.ops import assignment_grouped as asg

    n, per = len(hosts), len(hosts[0]["alive"])
    groups, dirties = [], []
    for k, load in enumerate(loads):
        if load is None:
            groups.append([])
            dirties.append([])
            continue
        g, total = load
        groups.append(seeded_groups(rng, g, total, per))
        dirty = set(rng.choice(per, min(per, 40), replace=False).tolist())
        if k:
            dirty.add(0)
        dirty = sorted(dirty)
        h = hosts[k]
        for i in dirty:
            h["capacity"][i] = rng.integers(1, 24)
            h["alive"][i] = i == 0 or rng.random() < 0.9
            h["version"][i] = rng.integers(1, 4)
            h["env_bitmap"][i, rng.integers(0, h["env_bitmap"].shape[1])] \
                ^= np.uint32(rng.integers(0, 2**32))
        dirties.append(dirty)
    g_pad = max(asg.group_pad(len(g)) for g in groups)
    d_pad = max(asg.delta_pad(len(d)) for d in dirties)
    t_max = max(asg.task_pad(sum(x[3] for x in g)) for g in groups)
    packed = np.zeros((n, 4, g_pad), np.int32)
    idx = np.full((n, d_pad), per, np.int32)
    rows = {f: np.zeros((n, d_pad), np.int32)
            for f in ("alive", "capacity", "dedicated", "version")}
    env = np.zeros((n, d_pad, hosts[0]["env_bitmap"].shape[1]), np.uint32)
    for k, (g, d) in enumerate(zip(groups, dirties)):
        if loads[k] is None:
            continue
        packed[k] = asg.make_grouped_packed_host(g, g_pad)
        di = np.asarray(d, np.int64)
        idx[k, :len(di)] = di
        for f, a in rows.items():
            a[k, :len(di)] = hosts[k][f][di]
        env[k, :len(di)] = hosts[k]["env_bitmap"][di]

    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    delta = asg.PoolDelta(idx=up(idx), alive=up(rows["alive"]),
                          capacity=up(rows["capacity"]),
                          dedicated=up(rows["dedicated"]),
                          version=up(rows["version"]),
                          env_rows=up(env.view(np.int32)))
    s = n * per
    return dict(delta=delta, packed=up(packed),
                adj=up(rng.integers(-2, 2, s).astype(np.int32)),
                rmask=up(rng.random(s) < 0.03),
                rval=up(rng.integers(0, 4, s).astype(np.int32)),
                t_max=t_max, g_pad=g_pad)


def compare_shard_grid(report: list) -> None:
    """K1 over a grid of shards, through the fused step's wrapper
    (cuda_resident_control_plane_step, in place), against the plain fused
    step (functional) on the card, chained over cycles: picks or counts,
    and every pool field, equal after every cycle.  N = 1, 2 and 8;
    uneven loads, a shard with no work, G padded to the cycle's maximum,
    padding beside the next shard's slot 0, and shards too wide for
    shared memory (the global-scratch path)."""
    import numpy as np
    import torch

    from yadcc_tpu_torch.ops import assignment as asn
    from yadcc_tpu_torch.ops import assignment_grouped as asg
    from yadcc_tpu_torch.ops import cuda_grouped as kg

    dev = torch.device("cuda")
    rng = np.random.default_rng(31)
    cases = (
        ("N1", MAIN_S, [(16, 1500)]),
        ("N2_uneven", MAIN_S, [(16, 2000), (3, 40)]),
        ("N8_uneven_one_idle", 2048,
         [(8, 600), (2, 10), None, (16, 2000), (1, 1), (4, 300), (64, 2048),
          (3, 90)]),
        ("N8_main_width", MAIN_S, [(MAIN_G // (1 + k % 4), 256 * (k + 1))
                                   for k in range(GRID_N)]),
        ("N2_beyond_shared_memory", 70_000, [(4, 3000), (2, 500)]),
    )
    for name, per, loads in cases:
        hosts = []
        for _ in loads:
            h = np_pool(rng, per, cap_lo=1, cap_hi=24, run_hi=8)
            h["running"] = np.minimum(h["running"], h["capacity"])
            hosts.append(h)
        kpool = asn.pool_from_numpy(*(np.concatenate([h[f] for h in hosts])
                                      for f in asn.PoolArrays._fields), dev)
        ppool = asn.PoolArrays(*(x.clone() for x in kpool))
        granted = 0
        for cycle in range(3):
            c = fused_cycle_inputs(rng, hosts, loads, dev)
            picks = cycle != 1        # the counts route on the middle cycle
            args = (c["delta"], c["packed"], c["adj"], c["rmask"],
                    c["rval"], c["t_max"])
            before = kg.launches
            got, kpool = kg.cuda_resident_control_plane_step(
                kpool, *args, return_picks=picks)
            check(kg.launches == before + 1,
                  f"grid {name}: {kg.launches - before} launches, not 1")
            want, ppool = asg.resident_control_plane_step(
                ppool, *args, return_picks=picks)
            check(torch.equal(got.cpu(), want.cpu()),
                  f"grid {name} cycle {cycle}: "
                  f"{'picks' if picks else 'counts'} differ")
            for f in asn.PoolArrays._fields:
                check(torch.equal(getattr(kpool, f).cpu(),
                                  getattr(ppool, f).cpu()),
                      f"grid {name} cycle {cycle}: {f} differs")
            granted += (int((got != -1).sum()) if picks
                        else int(got.sum()))
        report.append(f"  shard grid {name}: N={len(loads)} per={per} "
                      f"G up to {c['g_pad']}, 3 chained cycles (picks, "
                      f"counts, picks), {granted} grants, picks/counts/pool "
                      f"equal to the plain fused step")

    # Refusals (on the last case's two shards): a pool that does not
    # split into N shards, a non-int32 descriptor block, the delta on the
    # CPU.
    c = fused_cycle_inputs(rng, hosts, [(2, 10), (2, 10)], dev)
    two = asn.pool_from_numpy(*(np.concatenate([h[f] for h in hosts])
                                for f in asn.PoolArrays._fields), dev)
    args = [c["delta"], c["packed"], c["adj"], c["rmask"], c["rval"],
            c["t_max"]]
    bad = [
        ("a pool that does not split",
         two._replace(**{f: getattr(two, f)[:-1]
                         for f in asn.PoolArrays._fields}), args),
        ("int64 descriptors", two,
         [args[0], args[1].long()] + args[2:]),
        ("delta on the CPU", two,
         [asg.PoolDelta(*(x.cpu() for x in args[0]))] + args[1:]),
    ]
    for what, bp, ba in bad:
        before = kg.launches
        try:
            kg.cuda_resident_control_plane_step(bp, *ba)
        except (TypeError, ValueError):
            check(kg.launches == before, f"grid {what}: counted a launch")
            continue
        raise SmokeFailure(f"grid wrapper accepted {what}")
    report.append("  shard grid refusals (split, dtype, device): raised")
    torch.cuda.synchronize()


def time_shard_grid(report: list) -> dict:
    """The fused launch at N = 8 shards x 8,192 slots, G = 64, 2,048 tasks
    a shard, on the timing pool (each shard a copy of it, with its own
    groups): K1 over the grid of 8 blocks, beside one single-shard launch,
    eight single-shard launches in a row on one stream, and eight on
    eight streams; the whole fused step (delta scatter, fold, K1, eight
    expansions) beside its plain version.  Exactness: each shard's
    counts from the grid equal its single launch's and k1_model's.  The
    bound: the blocks run on separate SMs, so the largest one-SM floor
    over the shards."""
    import numpy as np
    import torch

    from yadcc_tpu_torch.models.cost import DEFAULT_COST_MODEL
    from yadcc_tpu_torch.ops import assignment as asn
    from yadcc_tpu_torch.ops import assignment_grouped as asg
    from yadcc_tpu_torch.ops import cuda_grouped as kg

    dev = torch.device("cuda")
    n, s = GRID_N, MAIN_S
    p = np_pool(np.random.default_rng(7), s, cap_lo=8, cap_hi=65, run_hi=8,
                ded_frac=0.2)
    grng = np.random.default_rng(12)
    groups = [seeded_groups(grng, MAIN_G, MAIN_TASKS, s) for _ in range(n)]
    pool = asn.pool_from_numpy(*(np.concatenate([p[f]] * n)
                                 for f in asn.PoolArrays._fields), dev)
    packed = torch.from_numpy(np.stack([
        asg.make_grouped_packed_host(g, MAIN_G) for g in groups])).to(dev)
    fields = list(packed.permute(1, 0, 2).contiguous())
    views = [asn.PoolArrays(*(a[k * s:(k + 1) * s] for a in pool))
             for k in range(n)]
    batches = [asg.unpack_grouped(packed[k]) for k in range(n)]
    cm = DEFAULT_COST_MODEL

    grid_counts = kg._launch(pool, fields, n, cm)[0].cpu().numpy()
    costs = []
    for k in range(n):
        single = kg.cuda_assign_grouped(views[k], batches[k])[0]
        check(np.array_equal(grid_counts[k], single.cpu().numpy()),
              f"grid timing: shard {k} differs from its single launch")
        costs.append(k1_cost(p, groups[k], MAIN_G))
        check(np.array_equal(grid_counts[k], costs[-1]["counts"]),
              f"grid timing: shard {k} differs from k1_model")

    def eight_in_a_row():
        for v, b in zip(views, batches):
            kg.cuda_assign_grouped(v, b)

    streams = [torch.cuda.Stream(dev) for _ in range(n)]

    def eight_on_eight_streams():
        cur = torch.cuda.current_stream(dev)
        for st, v, b in zip(streams, views, batches):
            st.wait_stream(cur)
            with torch.cuda.stream(st):
                kg.cuda_assign_grouped(v, b)
        for st in streams:
            cur.wait_stream(st)

    grid_ms = timed(lambda: kg._launch(pool, fields, n, cm), 20)
    one_ms = timed(lambda: kg.cuda_assign_grouped(views[0], batches[0]), 20)
    row_ms = timed(eight_in_a_row, 5)
    streams_ms = timed(eight_on_eight_streams, 5)

    # The whole fused step, each call doing the same work on the in-place
    # pool: 40 dirty slots a shard, every slot's running reset to the
    # same value by the fold.
    drng = np.random.default_rng(13)
    d_pad = asg.delta_pad(40)
    idx = np.stack([np.sort(drng.choice(s, 40, replace=False))
                    for _ in range(n)])
    per_shard = [asg.make_pool_delta(idx[k], p, d_pad, s, dev)
                 for k in range(n)]
    delta = asg.PoolDelta(*(torch.stack([getattr(d, f) for d in per_shard])
                            for f in asg.PoolDelta._fields))
    zeros = torch.zeros(n * s, dtype=torch.int32, device=dev)
    all_reset = torch.ones(n * s, dtype=torch.bool, device=dev)
    run0 = pool.running.clone()
    t_max = asg.task_pad(MAIN_TASKS)
    kpool = asn.PoolArrays(*(x.clone() for x in pool))
    ppool = asn.PoolArrays(*(x.clone() for x in pool))
    step_ms = timed(lambda: kg.cuda_resident_control_plane_step(
        kpool, delta, packed, zeros, all_reset, run0, t_max), 20)
    plain_ms = timed(lambda: asg.resident_control_plane_step(
        ppool, delta, packed, zeros, all_reset, run0, t_max), 1)

    floors = [c["ops"] / (H100_OPS_PER_S / H100_SMS) * 1e3 for c in costs]
    bytes_ms = sum(c["bytes"] for c in costs) / H100_BYTES_PER_S * 1e3
    ops_ms = sum(c["ops"] for c in costs) / H100_OPS_PER_S * 1e3
    out = dict(ms=grid_ms, one_shard_ms=one_ms, eight_in_a_row_ms=row_ms,
               eight_on_eight_streams_ms=streams_ms, fused_step_ms=step_ms,
               plain_ms=plain_ms, bound_ms=max(floors),
               bound_by="one-SM operations", card_bound_ms=max(bytes_ms,
                                                               ops_ms),
               N=n, S=s, G=MAIN_G, tasks=MAIN_TASKS)
    report.append(
        f"  timing shard grid N={n} x S={s}, G={MAIN_G}, {MAIN_TASKS} tasks "
        f"a shard: one launch of {n} blocks {grid_ms:.4f} ms; one shard "
        f"alone {one_ms:.4f} ms; {n} single launches in a row "
        f"{row_ms:.4f} ms, on {n} streams {streams_ms:.4f} ms; the fused "
        f"step (scatter, fold, K1 grid, {n} expansions) {step_ms:.4f} ms, "
        f"plain {plain_ms:.2f} ms; bound {max(floors) * 1e3:.2f} us (the "
        f"largest one-SM floor of the {n} shards; the whole card's "
        f"{out['card_bound_ms'] * 1e3:.3f} us); counts equal to each "
        f"shard's single launch and k1_model")
    return out


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
                  report: list, kernel: str = "grouped_assign",
                  shards: int = 1, min_grants: int = MIN_GRANTS,
                  post=None) -> dict:
    """Start the scheduler entry, drive it, check it, stop it; ``kernel``
    (unless None) must have launched in the drive.  With ``shards`` > 1 the entry runs
    --shards and every grant id must route to the shard that issued it.
    With ``--rpc-frontend aio`` among the arguments every client dials
    aio:// and the front end must have refused no second reply.
    ``post(port, iport, scheme, fleet, report)`` runs on the entry after
    the drive's checks; its result is the result's ``post``."""
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
            res = _drive(name, proc, port, iport, fleet, report, stop,
                         threads, kernel, shards, min_grants, extra_args)
            if post is not None:
                res["post"] = post(port, iport, res["scheme"], fleet, report)
            return res
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
           kernel, shards, min_grants, extra_args) -> dict:
    from yadcc_tpu_torch import api
    from yadcc_tpu_torch.rpc import Channel, RpcError
    from yadcc_tpu_torch.scheduler.service import SERVICE_NAME

    sch = api.scheduler
    t_boot = time.perf_counter()
    aio = "--rpc-frontend" in extra_args and \
        extra_args[extra_args.index("--rpc-frontend") + 1] == "aio"
    scheme = "aio" if aio else "grpc"
    ch = Channel(f"{scheme}://127.0.0.1:{port}")
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
        f"{scheme}://127.0.0.1:{port}"), c)) for c in chunks]
    for t in regs:
        t.start()
    for t in regs:
        t.join()
    reg_s = time.perf_counter() - t0
    state = inspect_vars(iport)["yadcc"]
    td = state["task_dispatcher"]
    # A router reports the count of servants over its shards.
    registered = (td["servants"] if shards > 1 else len(td["servants"]))
    check(registered == N_SERVANTS,
          f"{name}: {registered} servants registered")
    check(td.get("n_shards", 1) == shards,
          f"{name}: {td.get('n_shards', 1)} shards, expected {shards}")
    before = {k: v["launches"] for k, v in state["kernels"].items()}
    check(set(before) == set(KERNELS) and not any(before.values()),
          f"{name}: launch counts {before} before driving")
    stream_before = td.get("stream", {})

    def rebeat():
        chan = Channel(f"{scheme}://127.0.0.1:{port}")
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
        # gRPC channels to one address share one connection, so every
        # delegate would reach the scheduler from one peer address and
        # home on one shard.  With --shards each delegate dials its own
        # loopback address (the connection still comes from 127.0.0.1, on
        # a port of its own), as delegates on separate machines would.
        # (An aio:// channel has a connection of its own either way.)
        host = f"127.0.0.{2 + d}" if shards > 1 else "127.0.0.1"
        chan = Channel(f"{scheme}://{host}:{port}")
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
                if shards > 1:
                    for g in resp.grants:
                        if (g.task_grant_id - 1) % shards != g.shard_id:
                            fleet.violations.append(
                                f"grant {g.task_grant_id} issued by shard "
                                f"{g.shard_id} routes to shard "
                                f"{(g.task_grant_id - 1) % shards}")
                with lock:
                    dup = grant_ids.intersection(ids)
                    if dup or len(set(ids)) != len(ids):
                        fleet.violations.append(f"duplicate ids {dup}")
                    grant_ids.update(ids)
                    totals["grants"] += len(ids)
                    totals["calls"] += 1
                    latencies.append(lat)
                    totals["stolen"] = (totals.get("stolen", 0)
                                        + resp.stolen_grants)
                    if totals["grants"] >= min_grants:
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
    check(totals["grants"] >= min_grants,
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
    if kernel is not None:
        check(launches[kernel] > 0, f"{name}: {kernel} never launched")
    if shards > 1:
        # Every grant was freed through the shard its id routes to.
        left = [p["grants_outstanding"] for p in td["per_shard"]]
        check(left == [0] * shards,
              f"{name}: grants outstanding per shard {left}")
        check(sum(p["stats"]["granted"] for p in td["per_shard"])
              == totals["grants"], f"{name}: per-shard grants do not sum")
    # The resident pool's counters over the drive (its warmup's are
    # subtracted); absent for the other policies.
    resident = {k: v - stream_before.get(k, 0)
                for k, v in td.get("stream", {}).items()
                if k in ("seeds", "delta_launches", "delta_slots",
                         "full_syncs", "oracle_checks", "oracle_mismatches")}

    front = frontend_summary(state)
    if aio:
        check(front["double_replies"] == 0,
              f"{name}: {front['double_replies']} double replies")
    lat = sorted(latencies)
    res = dict(
        grants=totals["grants"], calls=totals["calls"],
        empty_calls=totals["empty"], seconds=elapsed,
        grants_per_s=totals["grants"] / elapsed,
        p50_ms=lat[len(lat) // 2] * 1e3,
        p99_ms=lat[min(len(lat) - 1, int(len(lat) * 0.99))] * 1e3,
        launches=launches, boot_s=boot_s, register_s=reg_s,
        resident=resident, stolen=totals.get("stolen", 0),
        stages=td["latency_breakdown"], frontend=front, scheme=scheme,
        steal=td.get("steal", {}),
        per_shard_granted=[p["stats"]["granted"]
                           for p in td.get("per_shard", [])])
    report.append(
        f"  {name}: {res['grants']} grants in {elapsed:.2f} s = "
        f"{res['grants_per_s']:.1f} grants/s over {res['calls']} calls "
        f"({res['empty_calls']} empty); WaitForStartingTask p50 "
        f"{res['p50_ms']:.2f} ms p99 {res['p99_ms']:.2f} ms; kernel "
        f"launches {json.dumps(launches)}; boot {boot_s:.1f} s, "
        f"{N_SERVANTS} servants registered in {reg_s:.1f} s; no "
        f"violations")
    if shards > 1:
        report.append(f"  {name}: {shards} shards granted "
                      f"{res['per_shard_granted']}, {res['stolen']} grants "
                      f"stolen; every grant id routes to its issuing shard "
                      f"and was freed there")
    report.append(f"  {name} dispatcher stages: "
                  f"{json.dumps(td['latency_breakdown'])}")
    report.append(f"  {name} front end: {json.dumps(front)}")
    return res


HOT_STEAL_MARGIN = 512   # grants asked beyond the home shard's capacity


def hot_steal_step(port, iport, scheme, fleet, report) -> dict:
    """One hot delegate on a sharded entry after its drive: it asks for
    more grants than its home shard's whole capacity, so the home shard
    is outrun by definition and the router steals for it from the
    least-loaded donors (at most one op a donor, each up to the steal
    batch).  Every grant is checked as in the drive and freed; the
    response must carry stolen grants, each issued by another shard."""
    from yadcc_tpu_torch import api
    from yadcc_tpu_torch.rpc import Channel
    from yadcc_tpu_torch.scheduler.service import SERVICE_NAME

    sch = api.scheduler
    name = "hot_steal"
    chan = Channel(f"{scheme}://127.0.0.1:{port}")
    env = fleet.envs[0]
    try:
        def ask(n, wait_ms):
            req = sch.WaitForStartingTaskRequest(
                token="utok", milliseconds_to_wait=wait_ms,
                next_keep_alive_in_ms=15000, immediate_reqs=n)
            req.env_desc.compiler_digest = env
            resp, _ = chan.call(SERVICE_NAME, "WaitForStartingTask", req,
                                sch.WaitForStartingTaskResponse,
                                timeout=60.0)
            return resp

        def free(resp):
            ids = [g.task_grant_id for g in resp.grants]
            if ids:
                chan.call(SERVICE_NAME, "FreeTask",
                          sch.FreeTaskRequest(token="utok",
                                              task_grant_ids=ids),
                          sch.FreeTaskResponse, timeout=60.0)

        probe = ask(1, 2000)       # learns this connection's home shard
        free(probe)
        home = probe.shard_id
        td = inspect_vars(iport)["yadcc"]["task_dispatcher"]
        cap = sum(v["effective_capacity"]
                  for v in td["per_shard"][home]["servants"].values())
        steal_before = td["steal"]["stolen_grants"]
        t0 = time.perf_counter()
        resp = ask(cap + HOT_STEAL_MARGIN, 2000)
        seconds = time.perf_counter() - t0
        held: dict = {}
        bad = []
        for g in resp.grants:
            s = fleet.by_loc.get(g.servant_location)
            held[g.servant_location] = held.get(g.servant_location, 0) + 1
            if s is None or env not in s["envs"] or \
                    held[g.servant_location] > s["capacity"]:
                bad.append(g.servant_location)
            if (g.task_grant_id - 1) % SHARDS != g.shard_id or \
                    g.stolen != (g.shard_id != home):
                bad.append(f"grant {g.task_grant_id} shard {g.shard_id}")
        ids = [g.task_grant_id for g in resp.grants]
        free(resp)
        td = inspect_vars(iport)["yadcc"]["task_dispatcher"]
        stolen = sum(1 for g in resp.grants if g.stolen)
        check(not bad, f"{name}: {bad[:5]}")
        check(len(set(ids)) == len(ids), f"{name}: duplicate grant ids")
        check(resp.stolen_grants == stolen > 0,
              f"{name}: {resp.stolen_grants} stolen in the reply, {stolen} "
              f"flagged")
        check(td["steal"]["stolen_grants"] - steal_before == stolen,
              f"{name}: steal stats moved by "
              f"{td['steal']['stolen_grants'] - steal_before}, not {stolen}")
        check(td["grants_outstanding"] == 0,
              f"{name}: {td['grants_outstanding']} grants outstanding")
        res = dict(home=home, home_capacity=cap,
                   asked=cap + HOT_STEAL_MARGIN, granted=len(ids),
                   stolen=stolen, seconds=seconds,
                   donors=sorted({g.shard_id for g in resp.grants
                                  if g.stolen}),
                   steal=td["steal"])
        report.append(
            f"  {name}: a delegate homed on shard {home} (capacity {cap}) "
            f"asked {cap + HOT_STEAL_MARGIN}: {len(ids)} granted in "
            f"{seconds:.2f} s, {stolen} stolen from shards {res['donors']}; "
            f"every grant valid and freed")
        return res
    finally:
        chan.close()


def frontend_summary(state: dict) -> dict:
    """The RPC front end as /inspect/vars shows it after a drive: the
    WaitForStartingTask handler stage (both front ends; on aio it spans
    the parked wait), and on aio the transport stages (accept, read,
    parse, write), the loops' lag and the refused second replies."""
    rpc = state.get("scheduler_rpc", {})
    out = {"handler": rpc.get("WaitForStartingTask:handler"),
           "serialize": rpc.get("WaitForStartingTask:serialize")}
    srv = state.get("rpc_server")
    if srv is None:
        return out
    loops = srv.get("per_loop", [srv])
    out.update(double_replies=srv["double_replies"],
               connections=srv["connections"],
               stages=[lp["stages"] for lp in loops],
               loop_lag=[lp["loop_lag"] for lp in loops])
    return out


def interval_stats(spans):
    """(union length, sum of lengths, count of spans overlapping another)
    for [(start, end)] intervals."""
    spans = sorted(spans)
    union, total, overlapping = 0.0, 0.0, set()
    cur_s = cur_e = None
    open_end, open_i = float("-inf"), -1
    for i, (s, e) in enumerate(spans):
        total += e - s
        if s < open_end:
            overlapping.update((i, open_i))
        if e > open_end:
            open_end, open_i = e, i
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                union += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        union += cur_e - cur_s
    return union, total, len(overlapping)


def measure_shard_overlap(report: list) -> dict:
    """Phase 8's scheduler built in process (the entry's build_dispatcher
    with --shards 4 and its other defaults: four pipelined shard
    policies, each on its own CUDA stream), 5,000 servants, 24 delegate
    threads calling the router directly (no RPC front end), profiled
    with torch.profiler for OVERLAP_WINDOW_S: how many K1 launches ran
    at the same time as another, and the card's busy share of the
    window.  Reports "not measured" when the profiler returns no device
    events."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from yadcc_tpu_torch.scheduler import entry
    from yadcc_tpu_torch.scheduler.task_dispatcher import ServantInfo

    args = entry.build_arg_parser().parse_args(["--shards", str(SHARDS)])
    router = entry.build_dispatcher(args)
    fleet = Fleet(seed=6)
    stop = threading.Event()
    lock = threading.Lock()
    errors, totals = [], {"grants": 0}

    def delegate(d: int):
        rng = random.Random(2000 + d)
        envs = rng.sample(fleet.envs, ENVS_PER_DELEGATE)
        who = f"127.0.0.1:{30000 + d}"
        k = 0
        try:
            while not stop.is_set():
                got = router.wait_for_starting_new_task(
                    envs[k % len(envs)], requestor=who,
                    immediate=IMMEDIATE, timeout_s=2.0)
                k += 1
                with lock:
                    totals["grants"] += len(got)
                if got:
                    router.free_task([g for g, _ in got])
        except Exception as e:  # reported below
            errors.append(f"delegate {d}: {e!r}")

    threads = [threading.Thread(target=delegate, args=(d,), daemon=True)
               for d in range(N_DELEGATES)]
    try:
        for s in fleet.servants:
            check(router.keep_servant_alive(ServantInfo(
                location=s["location"], version=1,
                num_processors=s["capacity"], dedicated=s["dedicated"],
                capacity=s["capacity"], total_memory=64 << 30,
                memory_available=32 << 30,
                env_digests=tuple(sorted(s["envs"]))), 600.0),
                "overlap: a servant was refused")
        for t in threads:
            t.start()
        time.sleep(1.0)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            g0, t0 = totals["grants"], time.perf_counter()
            time.sleep(OVERLAP_WINDOW_S)
            window_s = time.perf_counter() - t0
            granted = totals["grants"] - g0
        stop.set()
        for t in threads:
            t.join(timeout=30)
            check(not t.is_alive(), "overlap: a delegate hung")
        check(not errors, f"overlap: {errors[:3]}")
        check(router.failure is None, f"overlap: {router.failure!r}")
    finally:
        stop.set()
        router.stop()
    device = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    k1 = [(e.time_range.start, e.time_range.end) for e in device
          if "grouped_assign_kernel" in e.name]
    res = dict(window_s=window_s, grants=granted, k1_launches=len(k1))
    if not k1:
        report.append(f"  overlap: {granted} grants in {window_s:.2f} s; "
                      f"the profiler returned {len(device)} device events, "
                      f"no K1 kernel: overlap not measured")
        return res
    k1_union, k1_sum, k1_overlapping = interval_stats(k1)
    busy, _, _ = interval_stats([(e.time_range.start, e.time_range.end)
                                 for e in device])
    res.update(k1_overlapping=k1_overlapping, k1_busy_us=k1_union,
               k1_sum_us=k1_sum, device_busy_us=busy,
               device_busy_share=busy / (window_s * 1e6))
    report.append(
        f"  overlap (phase 8's scheduler in process, no RPC, torch.profiler "
        f"over {window_s:.2f} s): {granted} grants, {len(k1)} K1 launches, "
        f"{k1_overlapping} of them running beside another; K1 time "
        f"{k1_sum / 1e3:.2f} ms over {k1_union / 1e3:.2f} ms of wall "
        f"({k1_sum / max(k1_union, 1e-9):.2f} launches at a time on "
        f"average); the card busy {busy / 1e3:.2f} ms, "
        f"{res['device_busy_share'] * 100:.1f}% of the window")
    return res


# ---------------------------------------------------------------------------
# Phase 9: the fused control plane, in process.
# ---------------------------------------------------------------------------

FUSED_SHARDS = 8
FUSED_SLOTS = 8192
FUSED_SERVANTS = 40_000
FUSED_CYCLES = 1000
# tenant: (tier, max_outstanding); a budget binds per shard, on the ledger
# of the home shard that rules on the tenant's admission.
FUSED_TENANTS = {"acme": ("interactive", 48), "ci": ("batch", 32)}
FUSED_ASK = 16


def run_fused_path(report: list) -> dict:
    """A ShardRouter of 8 shards x 8,192 slots on the card with fused
    dispatch: 40,000 servants, two tenants with max_outstanding budgets,
    one delegate thread per (tenant, shard) calling admission_check and
    then wait_for_starting_new_task with its tenant, a churn thread
    re-beating servants with new capacities, and this thread driving
    run_fused_cycle (one launch of K1 over the grid of 8 shards a cycle)
    for >= 1,000 cycles.  The router steals nothing here, so each grant is
    charged to the home shard whose ledger ruled on its admission.
    Checks: no tenant's ledger ever above its budget, every ledger at 0
    at the end, the fused oracle clean, every cycle one K1 launch, the
    load summary equal to the host's truth; the routing hash's cost a
    call and the load summary's time on the card."""
    import numpy as np
    import torch

    from yadcc_tpu_torch.ops import cuda_assign as ka
    from yadcc_tpu_torch.ops import cuda_grouped as kg
    from yadcc_tpu_torch.parallel import mesh
    from yadcc_tpu_torch.scheduler.admission import FLOW_NONE, FLOW_REJECT
    from yadcc_tpu_torch.scheduler.policy import make_policy
    from yadcc_tpu_torch.scheduler.shard_router import (ShardRouter,
                                                        StealConfig)
    from yadcc_tpu_torch.scheduler.task_dispatcher import ServantInfo
    from yadcc_tpu_torch.tenancy import TenantDirectory, TenantSpec

    dev = torch.device("cuda")
    n = FUSED_SHARDS
    router = ShardRouter.build(
        lambda k: make_policy("torch_grouped", device=dev), n,
        max_servants_per_shard=FUSED_SLOTS, device=dev,
        steal=StealConfig(enabled=False), start_dispatch_thread=False,
        min_memory_for_new_task=1 << 30,
        tenant_directory=TenantDirectory([
            TenantSpec(t, tier=tier, max_outstanding=b)
            for t, (tier, b) in FUSED_TENANTS.items()]))
    rng = random.Random(9)
    envs = [f"compiler-digest-{i:03d}" for i in range(N_ENVS)]
    fleet = {}
    for i in range(FUSED_SERVANTS):
        cap = rng.randint(8, 64)
        fleet[f"10.{i >> 16 & 255}.{i >> 8 & 255}.{i & 255}:8335"] = dict(
            capacity=cap, dedicated=rng.random() < 0.2,
            envs=tuple(sorted(rng.sample(envs, rng.randint(8, 24)))))

    def beat(loc, s):
        return router.keep_servant_alive(ServantInfo(
            location=loc, version=1, num_processors=s["capacity"],
            dedicated=s["dedicated"], capacity=s["capacity"],
            total_memory=64 << 30, memory_available=32 << 30,
            env_digests=s["envs"]), 600.0)

    locs = list(fleet)
    sample = locs[:10_000]
    t0 = time.perf_counter()
    for loc in sample:
        router.shard_for_location(loc)
    hash_us = (time.perf_counter() - t0) / len(sample) * 1e6
    t0 = time.perf_counter()
    for loc in locs:
        check(beat(loc, fleet[loc]), f"fused: {loc} refused")
    reg_s = time.perf_counter() - t0
    homes = [router.shard_for_location(loc) for loc in locs]
    by_shard = [homes.count(k) for k in range(n)]
    check([len(d.inspect()["servants"]) for d in router.shards] == by_shard,
          "fused: servants not on their ring shards")
    router.enable_fused_dispatch(oracle_interval=16)

    done = threading.Event()
    lock = threading.Lock()
    violations, seen = [], set()
    peak = {}                       # (tenant, shard) -> highest ledger seen
    totals = {"grants": 0, "rejected": 0, "calls": 0}

    def delegate(tenant, shard):
        tier, budget = FUSED_TENANTS[tenant]
        who = next(w for w in (f"{tenant}-delegate-{shard}-{j}"
                               for j in range(10_000))
                   if router.resolve_home(w) == shard)
        ledger = router.shards[shard].tenant_ledger
        drng = random.Random(f"{tenant}-{shard}")
        held = []
        try:
            while not done.is_set():
                dec = router.admission_check(
                    immediate=FUSED_ASK, requestor=who, tenant=tenant,
                    tier=tier, home=shard)
                if dec.flow == FLOW_REJECT:
                    with lock:
                        totals["rejected"] += 1
                    if held:
                        router.free_task(held.pop(0))
                    continue
                if dec.flow != FLOW_NONE:
                    violations.append(f"{who}: ladder verdict {dec}")
                    return
                env = drng.choice(envs)
                got = router.wait_for_starting_new_task(
                    env, requestor=who, immediate=FUSED_ASK, tenant=tenant,
                    timeout_s=10.0)
                ids = [g for g, _ in got]
                out = ledger.outstanding(tenant)
                with lock:
                    totals["calls"] += 1
                    totals["grants"] += len(ids)
                    peak[(tenant, shard)] = max(
                        peak.get((tenant, shard), 0), out)
                    if out > budget:
                        violations.append(f"{tenant} on shard {shard}: "
                                          f"{out} > budget {budget}")
                    if seen.intersection(ids):
                        violations.append("duplicate grant ids")
                    seen.update(ids)
                for gid, loc in got:
                    if (gid - 1) % n != shard:
                        violations.append(f"grant {gid} not from shard "
                                          f"{shard}")
                    if env not in fleet[loc]["envs"]:
                        violations.append(f"{loc} lacks {env}")
                if ids:
                    held.append(ids)
                if held and drng.random() < 0.3:
                    router.free_task(held.pop(0))
        except Exception as e:  # reported by the phase below
            violations.append(f"{who}: {e!r}")
        finally:
            for ids in held:
                router.free_task(ids)

    def churn():
        crng = random.Random(10)
        while not done.wait(0.005):
            for loc in crng.sample(locs, 16):
                s = fleet[loc]
                s["capacity"] = crng.randint(8, 64)
                if crng.random() < 0.1:
                    s["dedicated"] = not s["dedicated"]
                beat(loc, s)

    threads = [threading.Thread(target=delegate, args=(t, k), daemon=True)
               for t in FUSED_TENANTS for k in range(n)]
    threads.append(threading.Thread(target=churn, daemon=True))
    kg.launches = 0
    ka.launches = 0
    for t in threads:
        t.start()
    t0 = time.perf_counter()
    cycle_s = []
    while True:
        stats = router.fused_stats()
        if stats["fused_cycles"] >= FUSED_CYCLES or violations:
            break
        check(time.perf_counter() - t0 < PHASE_LIMIT_S,
              f"fused: {stats['fused_cycles']} cycles in {PHASE_LIMIT_S} s")
        tc = time.perf_counter()
        router.run_fused_cycle()
        if router.fused_stats()["fused_cycles"] > stats["fused_cycles"]:
            cycle_s.append(time.perf_counter() - tc)
        else:
            time.sleep(0.0002)
    elapsed = time.perf_counter() - t0
    launched = kg.launches
    launched_k2 = ka.launches
    done.set()
    # Drain: requests still waiting get their last cycles.
    while any(t.is_alive() for t in threads):
        router.run_fused_cycle()
        time.sleep(0.001)
        check(time.perf_counter() - t0 < PHASE_LIMIT_S + 30,
              "fused: a delegate hung")
    check(not violations, f"fused: {violations[:5]}")
    stats = router.fused_stats()
    check(stats["fused_cycles"] >= FUSED_CYCLES,
          f"fused: {stats['fused_cycles']} cycles")
    check(stats["fused_shard_launches"] > 0, "fused: no shard launched")
    check(stats["oracle_checks"] > 0 and stats["oracle_mismatches"] == 0,
          f"fused: oracle {stats}")
    check(launched > 0 and launched == len(cycle_s),
          f"fused: {launched} K1 launches over {len(cycle_s)} cycles")
    check(launched_k2 == 0, f"fused: {launched_k2} K2 launches on a path "
                            f"that runs only K1")
    check(totals["rejected"] > 0, "fused: no budget ever bound")

    # The load summary against the host's truth (every grant freed, the
    # churned capacities in place).
    slices = [d.pool_load_arrays() for d in router.shards]
    truth = np.array([[a.sum(), np.where(a, np.maximum(c - r, 0), 0).sum(),
                       np.where(a, r, 0).sum()] for a, c, r in slices],
                     np.int64)
    t1 = time.perf_counter()
    rows = router.refresh_load_summary()
    refresh_ms = (time.perf_counter() - t1) * 1e3
    check(np.array_equal(rows, truth), f"fused: load summary {rows} "
                                       f"!= host {truth}")
    a, c, r = (torch.from_numpy(np.concatenate([s[i] for s in slices])).to(
        dev) for i in range(3))
    summary_ms = timed(lambda: mesh.shard_load_summary(a, c, r, n), 50)
    ins = router.inspect()
    check(ins["grants_outstanding"] == 0,
          f"fused: {ins['grants_outstanding']} grants outstanding")
    for k, d in enumerate(router.shards):
        left = d.tenant_ledger.inspect()["outstanding"]
        check(not left, f"fused: shard {k} ledger ends at {left}")
    by_tenant = {t: {key: sum(p["stats_by_tenant"].get(t, {}).get(key, 0)
                              for p in ins["per_shard"])
                     for key in ("granted", "rejected_over_budget")}
                 for t in FUSED_TENANTS}
    router.stop()
    cyc = np.array(cycle_s) * 1e3
    res = dict(cycles=stats["fused_cycles"], launches=launched,
               k2_launches=launched_k2,
               shard_launches=stats["fused_shard_launches"],
               oracle_checks=stats["oracle_checks"],
               grants=totals["grants"], seconds=elapsed,
               cycle_ms_p50=float(np.percentile(cyc, 50)),
               cycle_ms_p99=float(np.percentile(cyc, 99)),
               hash_us_per_call=hash_us, register_s=reg_s,
               servants_by_shard=by_shard, load_summary_ms=summary_ms,
               load_refresh_ms=refresh_ms, by_tenant=by_tenant,
               peak_ledger={f"{t}@{k}": v for (t, k), v in peak.items()},
               stages=ins["latency_breakdown"],
               fused_stages=ins["fused_stages"])
    report.append(
        f"  fused: {res['cycles']} cycles ({launched} K1 launches, one a "
        f"cycle; {res['shard_launches']} shard launches) in {elapsed:.2f} "
        f"s, cycle p50 {res['cycle_ms_p50']:.3f} ms p99 "
        f"{res['cycle_ms_p99']:.3f} ms; {res['grants']} grants over "
        f"{totals['calls']} calls, {totals['rejected']} over-budget "
        f"refusals; per tenant {json.dumps(by_tenant)}; peak ledger "
        f"{json.dumps(res['peak_ledger'])} within "
        f"{json.dumps({t: b for t, (_, b) in FUSED_TENANTS.items()})}; "
        f"every ledger 0 at the end; oracle {stats['oracle_checks']} checks "
        f"clean")
    report.append(
        f"  fused: {FUSED_SERVANTS} servants registered in {reg_s:.1f} s, "
        f"{by_shard} a shard; routing hash {hash_us:.2f} us a call "
        f"(shard_for_location, host); load summary {rows.tolist()} equal to "
        f"the host's, {summary_ms:.4f} ms on the card (50 calls), refresh "
        f"(gather, upload, reduce, download) {refresh_ms:.2f} ms")
    report.append(f"  fused cycle stages: "
                  f"{json.dumps(ins['fused_stages'])}; dispatcher stages: "
                  f"{json.dumps(ins['latency_breakdown'])}")
    return res


# ---------------------------------------------------------------------------
# Phase 7: the Bloom path.
# ---------------------------------------------------------------------------

BLOOM_N = 1_000_000                   # the batch and the populated keys
BLOOM_EDGE_LENGTHS = tuple(range(35)) + (63, 64, 65, 80, 100, 200, 4096)
BLOOM_EDGE_BITS = (64, 1000, 27_584_639)
BLOOM_EDGE_HASHES = (1, 7, 10)
BLOOM_EDGE_SALTS = (0, 17, (1 << 63) + 5)
BLOOM_EDGE_N = (1, 257, 1000)         # 257: not a multiple of the block
# Phase 7 (a'): key lengths for the staged kernels' layouts (rows of 16n,
# 16n + 8 and 0 bytes, a row past the staging width, 4,096 bytes), each
# at counts around the tile (tile - 1, tile, tile + 1, two tiles + 1) and
# with `packed` 0-3 words past a 16-byte boundary.
BLOOM_LAYOUT_LENGTHS = (0, 5, 23, 64, 80, 100, 129, 4096)
# Phase 7 (a''): geometries of the raw-fingerprint pools (2^31 + 11 bits:
# a 256 MB filter, 2,049 slices of the scatter), each with every hash
# count and the small counts, and 1M keys at 10 hashes.
BLOOM_RAW_BITS = (1, 33, 1000, 27_584_639, (1 << 31) + 11)
BLOOM_RAW_HASHES = (0, 1, 7, 10)
BLOOM_RAW_N = (1, 255, 257)
# 32-bit operations charged to each 64-bit step of XXH64 (a 64-bit
# multiply's low half is a wide 32x32 product and two cross products; an
# add, xor, rotate or shift is two 32-bit operations), to each probe
# evaluated (multiply-add, mod, word index, bit shift, test) and to each
# probe bit set by the scatter (the same, with the atomic OR for the test).
XXH_MUL, XXH_STEP = 4, 2
BLOOM_PROBE_OPS = 5
# The Bloom path's kernels (bloom_bench.run launches each of them).
BLOOM_PATH_KERNELS = ("membership", "cascade", "probe", "scatter_or")


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


def membership_bound(n: int, row_bytes: int, nw: int, length: int,
                     per_key) -> dict:
    """The membership kernel's bound: each row, the filter's ``nw`` words
    and each verdict moved once; each key's digest and the probes its
    early exit evaluates (``per_key``)."""
    return bloom_bound(n * row_bytes + nw * 4 + n,
                       n * xxh64_ops(length)
                       + int(per_key.sum()) * BLOOM_PROBE_OPS)


def cascade_bound(n: int, row_bytes: int, nw: int, length: int, per_key,
                  per_key_fleet, rejected) -> dict:
    """The cascade kernel's bound: both filters read once; the fleet digest
    and probes only for the keys the region ``rejected``."""
    return bloom_bound(n * row_bytes + 2 * nw * 4 + n,
                       (n + int(rejected.sum())) * xxh64_ops(length)
                       + (int(per_key.sum())
                          + int(per_key_fleet[rejected].sum()))
                       * BLOOM_PROBE_OPS)


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


def raw_fingerprints(rng, n: int, num_hashes: int, num_bits: int):
    """[n, 2] uint32 (h1, h2) drawn from a seed, every h2 even, the first
    rows set to cases a digest's split never gives: h2 = 0, h2 = 2^32 - 1,
    h1 within K * h2 of 2^32 (h1 + i*h2 wraps), h1 = num_bits - 1 with
    h2 = 2, and h1 = 2^32 - 1 with h2 = 2^32 - 2."""
    import numpy as np

    fps = rng.integers(0, 1 << 32, (n, 2), dtype=np.uint64).astype(np.uint32)
    fps[:, 1] &= ~np.uint32(1)
    h2 = (1 << 32) // max(1, 2 * num_hashes)
    special = [(int(fps[0, 0]), 0), (int(fps[0, 0]), 0xFFFFFFFF),
               ((1 << 32) - max(1, num_hashes // 2) * h2, h2),
               (num_bits - 1, 2), ((1 << 32) - 1, 0xFFFFFFFE)]
    for r, (a, b) in enumerate(special[:n]):
        fps[r] = (a & 0xFFFFFFFF, b & 0xFFFFFFFF)
    return fps


def host_probe_or(words, fps, num_bits: int, num_hashes: int):
    """The host's arithmetic on uint32 words (common/bloom.py:
    probe_indices_batch): (the verdict of each fingerprint, the words with
    every probe bit set)."""
    import numpy as np

    from yadcc_tpu_torch.common import bloom

    idx = bloom.probe_indices_batch(fps, num_hashes, num_bits)
    member = ((words[idx >> 5] >> (idx & 31)) & 1).astype(bool).all(axis=1)
    out = words.copy()
    idx = idx.ravel()
    np.bitwise_or.at(out, idx >> 5, np.uint32(1) << (idx & 31).astype(
        np.uint32))
    return member, out


def compare_bloom_raw(report: list) -> None:
    """Phase 7 (a''): the probe and scatter-OR kernels on fingerprints
    drawn from a seed, each result held at tolerance 0 against its plain
    version on the card and the host arithmetic; the scatter's input and
    the words past the filter's unchanged."""
    import numpy as np
    import torch

    from yadcc_tpu_torch.ops import bloom_pipeline as bpl
    from yadcc_tpu_torch.ops import bloom_probe as bpr
    from yadcc_tpu_torch.ops import cuda_bloom as kb

    dev = torch.device("cuda")
    rng = np.random.default_rng(72)
    cases = [(bits, k, n, "raw") for bits in BLOOM_RAW_BITS
             for k in BLOOM_RAW_HASHES for n in BLOOM_RAW_N]
    cases += [(bits, 10, BLOOM_N, "raw") for bits in BLOOM_RAW_BITS]
    cases += [(27_584_639, 10, BLOOM_N, "one slice"),
              (1000, 10, 257, "one bit"), (27_584_639, 10, 20_000, "passes")]
    pool = {}   # the last geometry's random words, a quarter of bits set
    for j, (nbits, k, n, kind) in enumerate(cases):
        nw, extra = -(-nbits // 32), j % 3
        if nbits not in pool:
            pool = {nbits: rng.integers(0, 1 << 32, nw + 2, dtype=np.uint32)
                    & rng.integers(0, 1 << 32, nw + 2, dtype=np.uint32)}
        base = pool[nbits][:nw + extra]
        if kind in ("raw", "passes"):
            fps = raw_fingerprints(rng, n, k, nbits)
        elif kind == "one bit":
            fps = np.tile(np.array([[nbits // 3, 0]], np.uint32), (n, 1))
        else:
            # Every probe inside one slice of the scatter's plan.
            plan = kb.scatter_plan(nbits, k, n)
            slice_bits = 32 << plan.slice_shift
            step = slice_bits // (4 * k)
            h1 = (plan.slices // 2) * slice_bits + rng.integers(
                0, slice_bits - k * step, n, dtype=np.uint64)
            fps = np.stack([h1, rng.integers(0, step, n, dtype=np.uint64)],
                           axis=1).astype(np.uint32)
        tag = f"{kind} bits {nbits} K {k} n {n} +{extra} words"
        fps_d = bpl.as_device_words(fps, dev)
        if j % 4 == 3:
            # A view one word in: 4-byte aligned, not 8.
            fps_d = packed_view(fps_d, 1)
            tag += ", fingerprints 4 bytes past 8"
        geo = dict(num_bits=nbits, num_hashes=k)

        bwords = bpl.as_device_words(base, dev)
        max_segments = kb.MAX_SEGMENTS
        if kind == "passes":
            # A scratch of 8 bin blocks: the build runs in 2 passes, the
            # second reading the first's output.
            kb.MAX_SEGMENTS = 8
            check(kb.scatter_plan(nbits, k, n).passes == 2, tag)
        try:
            got = kb.bloom_scatter_or(bwords, fps_d, **geo)
        finally:
            kb.MAX_SEGMENTS = max_segments
        check(torch.equal(got, bpr.scatter_add_plain(bwords, fps_d, nbits,
                                                     k)),
              f"scatter_or != plain: {tag}")
        _, want_words = host_probe_or(base, fps, nbits, k)
        got_np = got.cpu().numpy().view(np.uint32)
        check(np.array_equal(got_np, want_words),
              f"scatter_or != host: {tag}")
        check(np.array_equal(got_np[nw:], base[nw:]),
              f"scatter_or changed the words past the filter's: {tag}")
        check(np.array_equal(bwords.cpu().numpy().view(np.uint32), base),
              f"scatter_or changed its input: {tag}")

        # The probe against a dense filter holding every other fingerprint.
        _, words = host_probe_or(~base, fps[::2], nbits, k)
        want, _ = host_probe_or(words, fps, nbits, k)
        pwords = bpl.as_device_words(words, dev)
        got = kb.bloom_probe(pwords, fps_d, **geo)
        check(torch.equal(got, bpr.probe_body(pwords, fps_d, nbits, k)),
              f"probe != plain: {tag}")
        check(np.array_equal(got.cpu().numpy(), want), f"probe != host: {tag}")
        check(bool(want[::2].all()), f"a member tested absent: {tag}")
        del bwords, pwords, got
    torch.cuda.synchronize()
    report.append(f"  bloom raw fingerprints: {len(cases)} cases (bits "
                  f"{BLOOM_RAW_BITS}, K {BLOOM_RAW_HASHES}, n "
                  f"{BLOOM_RAW_N} and {BLOOM_N:,} at K 10, a {BLOOM_N:,}-key "
                  f"batch in one slice, 257 keys on one bit, a build in 2 "
                  f"passes; even h2, h2 0 and 2^32 - 1, wrapping h1; "
                  f"fingerprints 8- and 4-byte aligned; 0-2 words past the "
                  f"filter's): "
                  f"probe and scatter_or equal to their plain versions and "
                  f"the host, the scatter's input unchanged")


def packed_view(packed, offset: int):
    """``packed`` copied into a buffer ``offset`` words in: a contiguous
    view whose base is 4 * offset bytes past the buffer's (16-byte
    aligned) start."""
    import torch

    n, w = packed.shape
    buf = torch.zeros(n * w + offset, dtype=torch.int32, device=packed.device)
    view = buf[offset:].view(n, w)
    view.copy_(packed)
    return view


def compare_bloom_layouts(report: list) -> None:
    """Phase 7 (a'): the membership and cascade kernels against their plain
    versions and the host filter at tolerance 0 around their tile: counts
    of tile - 1, tile, tile + 1 and 2 * tile + 1 keys, `packed` views 0-3
    words past a 16-byte boundary, staged and unstaged row widths."""
    import numpy as np
    import torch

    from yadcc_tpu_torch.ops import bloom_pipeline as bpl
    from yadcc_tpu_torch.ops import cuda_bloom as kb
    from yadcc_tpu_torch.ops.xxh64_torch import pack_keys

    dev = torch.device("cuda")
    tile = kb.tile_keys()
    counts = (tile - 1, tile, tile + 1, 2 * tile + 1)
    rng = np.random.default_rng(71)
    nbits, k, fk = 27_584_639, 10, 7
    seed, fseed = bpl.seed_pair(17), bpl.seed_pair((1 << 63) + 5)
    cases = 0
    for length in BLOOM_LAYOUT_LENGTHS:
        for j, n in enumerate(counts):
            offsets = (j,) if length not in (23, 80) else (0, 1, 2, 3)
            keys = [rng.bytes(length) for _ in range(n)]
            region = _bloom_filter(rng, nbits, k, 17, keys[::2], True)
            fleet = _bloom_filter(rng, nbits, fk, (1 << 63) + 5, keys[1::3],
                                  True)
            want = region.may_contain_batch(keys)
            want_c = want | fleet.may_contain_batch(keys)
            words = bpl.as_device_words(region.words, dev)
            fwords = bpl.as_device_words(fleet.words, dev)
            base = bpl.as_device_words(pack_keys(keys, length), dev)
            plain = bpl.membership_plain(words, base, length, seed, nbits, k)
            plain_c = bpl.cascade_plain(words, fwords, base, length, seed,
                                        fseed, nbits, k, fk)
            check(np.array_equal(plain.cpu().numpy(), want),
                  f"layout plain != host: length {length} n {n}")
            for off in offsets:
                packed = packed_view(base, off)
                check(packed.numel() == 0
                      or packed.data_ptr() % 16 == 4 * off,
                      f"view {off} words in: base {packed.data_ptr() % 16}"
                      f" bytes past 16")
                tag = f"length {length} n {n} view {off} words in"
                got = kb.bloom_membership(words, packed, length, seed,
                                          num_bits=nbits, num_hashes=k)
                check(torch.equal(got, plain), f"membership != plain: {tag}")
                got = kb.bloom_cascade(words, fwords, packed, length, seed,
                                       fseed, num_bits=nbits,
                                       num_hashes_region=k,
                                       num_hashes_fleet=fk)
                check(torch.equal(got, plain_c), f"cascade != plain: {tag}")
                check(np.array_equal(got.cpu().numpy(), want_c),
                      f"cascade != host OR: {tag}")
                cases += 1
    torch.cuda.synchronize()
    report.append(f"  bloom layouts: {cases} cases (lengths "
                  f"{BLOOM_LAYOUT_LENGTHS}, n {counts} around the "
                  f"{tile}-key tile, packed 0-3 words past 16 bytes): "
                  f"membership and cascade equal to their plain versions "
                  f"and the host filter")


def hit_batch(members, fleet_only, n: int, hit_rate: float, seed: int):
    """tools/bloom_bench.py's batch at ``hit_rate``: that share of members,
    a tenth of the rest fleet keys, the others absent from both filters."""
    import numpy as np

    from yadcc_tpu_torch.tools.bloom_bench import production_keys

    rng = np.random.default_rng(seed)
    n_hits = int(n * hit_rate)
    n_fleet = (n - n_hits) // 10
    keys = [members[i] for i in rng.integers(0, len(members), n_hits)]
    keys += [fleet_only[i] for i in
             rng.integers(0, len(fleet_only), n_fleet)]
    return keys + production_keys(n - n_hits - n_fleet, seed=seed + 1)


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
        mem = {
            "ms": timed(lambda: kb.bloom_membership(
                words, packed, length, seed, num_bits=nb, num_hashes=k), 50),
            "plain_ms": timed(lambda: bpl.membership_plain(
                words, packed, length, seed, nb, k), 3),
            "key_bytes": length, "positive_rate": float(want.mean()),
            "probes_per_key": float(per_key.mean()),
            **membership_bound(n, row_bytes, nw, length, per_key),
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
        out["cascade"] = {
            "ms": timed(lambda: kb.bloom_cascade(*cas_args, **cas_geo), 50),
            "plain_ms": timed(lambda: bpl.cascade_plain(
                *cas_args, nb, k, FLEET_HASHES), 3),
            "positive_rate": float(want_c.mean()),
            **cascade_bound(n, row_bytes, nw, length, per_key, per_key_f,
                            ~want),
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
    out["hits"] = compare_bloom_hits(report, members, fleet_only, region,
                                     fleet)
    return out


def compare_bloom_hits(report: list, members, fleet_only, region,
                       fleet) -> dict:
    """Phase 7 (c'): the membership and cascade kernels on the bench's
    batches (1M production keys at 1%, 10% and 50% hits), each held
    against its plain version and the host filter, then timed beside its
    bound."""
    import numpy as np
    import torch

    from yadcc_tpu_torch.common import bloom
    from yadcc_tpu_torch.ops import bloom_pipeline as bpl
    from yadcc_tpu_torch.ops import cuda_bloom as kb
    from yadcc_tpu_torch.tools.bloom_bench import (FLEET_HASHES, FLEET_SALT,
                                                   HIT_RATES, SALT)

    dev = torch.device("cuda")
    n, nb, k = BLOOM_N, region.num_bits, region.num_hashes
    nw = region.words.shape[0]
    words = bpl.as_device_words(region.words, dev)
    fwords = bpl.as_device_words(fleet.words, dev)
    seed, fseed = bpl.seed_pair(SALT), bpl.seed_pair(FLEET_SALT)
    geo = dict(num_bits=nb, num_hashes=k)
    cas_geo = dict(num_bits=nb, num_hashes_region=k,
                   num_hashes_fleet=FLEET_HASHES)
    out = {}
    for ri, rate in enumerate(HIT_RATES):
        keys = hit_batch(members, fleet_only, n, rate, seed=200 + 2 * ri)
        ((length, _, packed_np),) = bpl.pack_key_buckets(keys)
        packed = bpl.as_device_words(packed_np, dev)
        row_bytes = packed_np.shape[1] * 4
        want = region.may_contain_batch(keys)
        want_c = want | fleet.may_contain_batch(keys)
        per_key, _ = probes_needed(
            region.words, bloom.key_fingerprints(keys, SALT), nb, k)
        per_key_f, _ = probes_needed(
            fleet.words, bloom.key_fingerprints(keys, FLEET_SALT), nb,
            FLEET_HASHES)
        got = kb.bloom_membership(words, packed, length, seed, **geo)
        check(torch.equal(got, bpl.membership_plain(
            words, packed, length, seed, nb, k)),
            f"hits {rate}: membership != plain")
        check(np.array_equal(got.cpu().numpy(), want),
              f"hits {rate}: membership != host filter")
        cas_args = (words, fwords, packed, length, seed, fseed)
        got = kb.bloom_cascade(*cas_args, **cas_geo)
        check(torch.equal(got, bpl.cascade_plain(
            *cas_args, nb, k, FLEET_HASHES)), f"hits {rate}: cascade != plain")
        check(np.array_equal(got.cpu().numpy(), want_c),
              f"hits {rate}: cascade != host OR")
        mem = {"ms": timed(lambda: kb.bloom_membership(
                   words, packed, length, seed, **geo), 50),
               "positive_rate": float(want.mean()),
               "probes_per_key": float(per_key.mean()),
               **membership_bound(n, row_bytes, nw, length, per_key)}
        cas = {"ms": timed(lambda: kb.bloom_cascade(*cas_args, **cas_geo),
                           50),
               "positive_rate": float(want_c.mean()),
               **cascade_bound(n, row_bytes, nw, length, per_key, per_key_f,
                               ~want)}
        for name, r in (("membership", mem), ("cascade", cas)):
            r["share_of_bound"] = r["bound_ms"] / r["ms"]
            report.append(
                f"  bloom {name} at {rate:.0%} hits: kernel {r['ms']:.4f} "
                f"ms, bound {r['bound_ms']:.5f} ms ({r['bound_by']}), "
                f"{r['share_of_bound']:.1%} of its bound; positive "
                f"{r['positive_rate']:.4f}; equal to plain and host")
        out[str(rate)] = {"membership": mem, "cascade": cas}
        del packed
    torch.cuda.synchronize()
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
    launched = {name: kb.launches[name] for name in BLOOM_PATH_KERNELS}
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


# ---------------------------------------------------------------------------
# Phase 2 (placement): the cells x tasks spill-placement kernel.
# ---------------------------------------------------------------------------

PLACE_CELLS = (1, 3, 7, 8)
PLACE_TASKS = (1, 8)
PLACE_N = (1, 32, 256)
PLACE_LENGTHS = (23, 80)
PLACE_SALTS = (0, 17, (1 << 63) + 5)
PLACE_GEOMETRIES = ((27_584_639, 10), (1000, 7))
PLACE_PATH = (7, 32, 1)        # a spill decision: 7 peers, 32 keys, T = 1
PLACE_WIDE = (8, 256, 8)
# (C, T, N, key length, geometry): C x N pairs over several blocks of 256,
# so the last block's ticket takes the score; most not a multiple of 256.
PLACE_GRIDS = ((5, 3, 100, 23, 0), (9, 8, 1000, 80, 0), (33, 1, 8, 80, 0),
               (300, 2, 1, 80, 1), (2, 4096, 64, 23, 1), (4, 8, 512, 80, 0))
PLACE_REUSE = 100              # calls on one slot, back to back
PLACE_THREADS = 8              # threads calling at once, a slot each


def placement_kw(length: int, num_bits: int, num_hashes: int) -> dict:
    from yadcc_tpu_torch.scheduler import placement as pl

    return dict(length=length, num_bits=num_bits, num_hashes=num_hashes,
                warm_scale=pl.WARM_SCALE, w_warm=pl.W_WARM,
                w_load=pl.W_LOAD, w_topo=pl.W_TOPO)


def placement_case(rng, c_n, t_n, n, length, num_bits, num_hashes, dev, *,
                   pad=0, salt0=0, no_filter=(), ineligible=(),
                   tie=False, hit=0.5):
    """One placement call's inputs from a seed: ``n`` keys of ``length``
    bytes owned by tasks 0..t_n-2 (the last task owns none when t_n > 1),
    ``pad`` padding keys with task -1, one host filter a cell holding a
    ``hit`` share of the keys (with ``tie``, every cell the same filter,
    salt and terms).  Returns (the wrapper's arguments with the words on
    ``dev``, its keywords, the host oracle's three results, the host
    filters and the keys)."""
    import numpy as np

    from yadcc_tpu_torch.common import bloom
    from yadcc_tpu_torch.ops import bloom_pipeline as bpl
    from yadcc_tpu_torch.scheduler import placement as pl

    keys = [bytes(rng.integers(97, 123, length, dtype=np.uint8)).decode()
            for _ in range(n + pad)]
    owner = np.concatenate([rng.integers(0, max(1, t_n - 1), n),
                            np.full(pad, -1)]).astype(np.int32)
    filters = []
    for c in range(c_n):
        if c in no_filter:
            filters.append(None)
        elif tie and filters and filters[0] is not None:
            filters.append(filters[0])
        else:
            salt = PLACE_SALTS[(salt0 + c) % len(PLACE_SALTS)]
            f = bloom.SaltedBloomFilter(num_bits, num_hashes, salt)
            members = [k for k in keys if rng.random() < hit]
            f.add_many(members + [f"other-{c}-{i}" for i in range(64)])
            filters.append(f)
    (_, idx, packed), = bpl.pack_key_buckets(keys)
    counts = np.bincount(owner[owner >= 0], minlength=t_n).astype(np.int32)
    terms = np.stack([rng.integers(0, 4096, c_n), rng.integers(0, 5, c_n),
                      [c not in ineligible for c in range(c_n)],
                      [f is not None for f in filters]]).astype(np.int32)
    if tie:
        terms[:2] = terms[:2, :1]
    hits = np.zeros((c_n, t_n), np.int32)
    for c, f in enumerate(filters):
        if f is not None:
            ok = f.may_contain_batch(keys)
            np.add.at(hits[c], owner[ok & (owner >= 0)], 1)
    want = pl.reference_scores(hits, counts, terms[0], terms[1], terms[2],
                               terms[3])
    words = [None if f is None else bpl.as_device_words(f.words, dev)
             for f in filters]
    seeds = np.stack([bpl.seed_pair(f.salt if f is not None else 0)
                      for f in filters])
    return ((words, seeds, terms, packed, owner, counts),
            placement_kw(length, num_bits, num_hashes), want, filters, keys)


def compare_placement_call(args, kw, want, tag) -> None:
    """The kernel against its plain version on the card and the host."""
    import numpy as np
    import torch

    from yadcc_tpu_torch.ops import bloom_pipeline as bpl
    from yadcc_tpu_torch.ops import cuda_bloom as kb

    got = kb.placement_score(*args, **kw)
    plain = bpl.placement_score_plain(*args, device=torch.device("cuda"),
                                      **kw)
    for name, g, p, w in zip(("scores", "best_cell", "best_score"), got,
                             plain, want):
        check(torch.equal(g, p), f"placement {name} != plain: {tag}")
        check(np.array_equal(g.cpu().numpy(), w),
              f"placement {name} != host: {tag}")


def compare_placement(report: list) -> None:
    """Phase 2: the placement kernel against placement_score_plain on the
    card and the host oracle, at tolerance 0: 1, 3, 7 and 8 cells, 1 and 8
    tasks, 1, 32 and 256 keys of 23 and 80 bytes, salts 0, 17 and 2^63 +
    5, the production geometry and a 1,000-bit filter, with a cell
    without a filter, an ineligible cell, padding keys and a task without
    keys; every cell ineligible; a tie across cells; a mixed batch through
    prepare_probe_batch; the refusals."""
    import itertools

    import numpy as np
    import torch

    from yadcc_tpu_torch.common import bloom
    from yadcc_tpu_torch.ops import cuda_bloom as kb
    from yadcc_tpu_torch.scheduler import placement as pl

    dev = torch.device("cuda")
    rng = np.random.default_rng(110)
    cases = 0
    for i, (c_n, t_n, n, length) in enumerate(itertools.product(
            PLACE_CELLS, PLACE_TASKS, PLACE_N, PLACE_LENGTHS)):
        bits, k = PLACE_GEOMETRIES[i % 2]
        extra = dict(salt0=i, pad=3 if t_n > 1 else 0,
                     no_filter=(1,) if c_n >= 3 else (),
                     ineligible=(c_n - 1,) if c_n >= 3 else ())
        args, kw, want, _, _ = placement_case(rng, c_n, t_n, n, length, bits,
                                              k, dev, **extra)
        compare_placement_call(args, kw, want, f"C {c_n} T {t_n} N {n} "
                               f"length {length} bits {bits}")
        cases += 1
    # Every cell ineligible: each best score is 2^30, the best cell 0.
    args, kw, want, _, _ = placement_case(
        rng, 7, 8, 32, 80, *PLACE_GEOMETRIES[0], dev,
        ineligible=tuple(range(7)))
    compare_placement_call(args, kw, want, "all ineligible")
    check((want[2] == pl.BIG).all() and (want[1] == 0).all(),
          "all ineligible: the host oracle's best is not 2^30 at cell 0")
    # A tie across cells: the lowest cell wins.
    args, kw, want, _, _ = placement_case(
        rng, 8, 8, 256, 23, *PLACE_GEOMETRIES[1], dev, tie=True)
    compare_placement_call(args, kw, want, "tie")
    check((want[1] == 0).all() and (want[0] == want[0][:1]).all(),
          "tie: the cells' scores differ")
    # Grids of several blocks: the ticket's last block scores.
    for c_n, t_n, n, length, g in PLACE_GRIDS:
        args, kw, want, _, _ = placement_case(
            rng, c_n, t_n, n, length, *PLACE_GEOMETRIES[g], dev, pad=2,
            no_filter=(1,), ineligible=(c_n - 1,))
        compare_placement_call(args, kw, want, f"grid C {c_n} T {t_n} N "
                               f"{n}")
        cases += 1
    reuse_s, threaded = compare_placement_slots(rng, dev)
    # A mixed batch: prepare_probe_batch keeps the dominant length class.
    mixed = [[f"k{i:022d}" for i in range(12)] + ["short", "mid-len-key"],
             [f"v{i:078d}" for i in range(5)] + ["x" * 23] * 3, []]
    batch = pl.prepare_probe_batch(mixed)
    check(batch.length == 23 and batch.dropped == 7, "mixed batch classes")
    cells = []
    for c, salt in enumerate(PLACE_SALTS):
        f = bloom.SaltedBloomFilter(*PLACE_GEOMETRIES[0], salt)
        f.add_many(mixed[0][c::2])
        cells.append(pl.CellCandidate(c, 0.25 * c, c, True, f))
    want = pl.host_reference_placement(cells, mixed)
    got = pl.DevicePlacementScorer().score(cells, mixed)
    for f in ("scores", "best_cell", "best_score"):
        check(np.array_equal(getattr(got, f), getattr(want, f)),
              f"mixed batch {f}: scorer != host")
    cases += 3

    # Refusals, before any launch.
    before = dict(kb.launches)
    args, kw, _, _, _ = placement_case(rng, 2, 2, 8, 23, 1000, 7, dev)
    words, seeds, terms, packed, owner, counts = args
    bad = [
        ("4,097 tasks", (words, seeds, terms, packed, owner,
                         np.zeros(kb.PLACE_MAX_TASKS + 1, np.int32))),
        ("a count above 2^21", (words, seeds, terms, packed, owner,
                                np.array([kb.PLACE_MAX_COUNT + 1, 0],
                                         np.int32))),
        ("filters of differing geometry", ([words[0], words[1][:-1]],
                                           seeds, terms, packed, owner,
                                           counts)),
        ("words on the CPU and the card", ([words[0], words[1].cpu()],
                                           seeds, terms, packed, owner,
                                           counts)),
        ("int64 words", ([words[0].long(), words[1]], seeds, terms, packed,
                         owner, counts)),
        ("non-contiguous words", ([torch.stack([words[0], words[0]], 1)[:, 0],
                                   words[1]], seeds, terms, packed, owner,
                                  counts)),
        ("no cell", ([], seeds[:0], terms[:, :0], packed, owner, counts)),
        ("packed rows for another length", (words, seeds, terms,
                                            packed[:, :2], owner, counts)),
    ]
    for what, call in bad:
        try:
            kb.placement_score(*call, **kw)
        except (TypeError, ValueError):
            continue
        raise SmokeFailure(f"placement wrapper accepted {what}")
    check(kb.launches == before, "a refused placement call launched")
    torch.cuda.synchronize()
    report.append(f"  placement: {cases} cases (C {PLACE_CELLS}, T "
                  f"{PLACE_TASKS}, N {PLACE_N}, lengths {PLACE_LENGTHS}, "
                  f"salts {PLACE_SALTS}, geometries {PLACE_GEOMETRIES}; a "
                  f"cell without a filter, an ineligible cell, padding keys, "
                  f"a task without keys, every cell ineligible, a tie, a "
                  f"mixed batch; grids (C, T, N) "
                  f"{[g[:3] for g in PLACE_GRIDS]}) equal to the plain "
                  f"version and the host oracle; one slot reused "
                  f"{PLACE_REUSE} times across three shapes ({reuse_s:.2f} "
                  f"s) and {PLACE_THREADS} threads x {threaded} calls at "
                  f"once on their own slots, every result equal to the host "
                  f"oracle's; {len(bad)} refusals without a launch")


def placement_slot_call(slot, args, kw):
    """One decision through ``slot`` as the scorer makes it: the pack,
    then the one native call; the int32 [C*T + 2*T] result, copied."""
    from yadcc_tpu_torch.ops import cuda_bloom as kb

    words = args[0]
    lay = kb.placement_pack(slot, [0 if w is None else w.data_ptr()
                                   for w in words], *args[1:], **kw)
    return kb.placement_call(slot, lay, words).copy()


def compare_placement_slots(rng, dev) -> tuple:
    """One slot reused PLACE_REUSE times back to back across three shapes
    (a stale scratch or ticket would add hits or score early), then
    PLACE_THREADS threads calling at once, each on its own slot of one
    pool; every result against the host oracle.  Returns (the reuse's
    seconds, calls a thread)."""
    import numpy as np

    from yadcc_tpu_torch.ops import cuda_bloom as kb

    shapes = ((7, 1, 32, 80, 0), (9, 8, 1000, 80, 0), (3, 8, 32, 23, 1))
    cases = []
    for c_n, t_n, n, length, g in shapes:
        args, kw, want, _, _ = placement_case(
            rng, c_n, t_n, n, length, *PLACE_GEOMETRIES[g], dev, pad=1)
        cases.append((args, kw, np.concatenate([w.reshape(-1)
                                                for w in want])))
    slot = kb.PlacementSlot(dev)
    t0 = time.perf_counter()
    for i in range(PLACE_REUSE):
        args, kw, want = cases[i % len(cases)]
        check(np.array_equal(placement_slot_call(slot, args, kw), want),
              f"placement slot reused: call {i} != host")
    reuse_s = time.perf_counter() - t0
    pool = kb.PlacementSlots(dev)
    calls = 25
    errors: list = []
    start = threading.Barrier(PLACE_THREADS)

    def worker(k):
        try:
            mine = pool.take()
            start.wait(timeout=60)
            for i in range(calls):
                args, kw, want = cases[(k + i) % len(cases)]
                if not np.array_equal(placement_slot_call(mine, args, kw),
                                      want):
                    errors.append(f"thread {k} call {i} != host")
            pool.give(mine)
        except Exception as e:  # reported below
            errors.append(f"thread {k}: {e!r}")

    threads = [threading.Thread(target=worker, args=(k,))
               for k in range(PLACE_THREADS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        check(not t.is_alive(), "placement: a calling thread hung")
    check(not errors, f"placement threads: {errors[:3]}")
    check(pool.created == PLACE_THREADS,
          f"placement threads: {pool.created} slots for {PLACE_THREADS}")
    return reuse_s, calls


def placement_bound(filters, keys, counts_shape, length, num_bits,
                    num_hashes) -> dict:
    """The placement call's bound on this data: each key row, the cells'
    terms and seeds, the counts and each key's task read once, each filter
    word a probe needs read once (the early exit's probes, per cell),
    the scores and picks written once; each cell's digest of every key and
    the probes its early exit evaluates."""
    import numpy as np

    from yadcc_tpu_torch.common import bloom

    c_n, (t_n,) = len(filters), counts_shape
    n = len(keys)
    row_bytes = -(-length // 8) * 8
    words_needed, probes = 0, 0
    for f in filters:
        if f is None:
            continue
        fps = bloom.key_fingerprints(keys, f.salt)
        per_key, _ = probes_needed(f.words, fps, num_bits, num_hashes)
        i = np.arange(num_hashes, dtype=np.uint32)[None, :]
        idx = (fps[:, :1] + i * fps[:, 1:]) % np.uint32(num_bits)
        used = i < per_key[:, None]
        words_needed += len(np.unique(idx[used] >> 5))
        probes += int(per_key.sum())
    nbytes = (n * row_bytes + n * 4 + c_n * (16 + 16) + t_n * 4
              + words_needed * 4 + (c_n * t_n + 2 * t_n) * 4)
    ops = (c_n * n * xxh64_ops(length) + probes * BLOOM_PROBE_OPS
           + c_n * t_n * 8)
    return bloom_bound(nbytes, ops)


def time_placement(report: list) -> dict:
    """The placement kernel's time (CUDA events over 50 warm launches on
    an input a call staged), an empty one-block launch's timed the same
    way (the floor of a one-launch call), the plain version's, and on the
    host clock the whole call as the scorer makes it (the pack into a
    slot, then the one native call: copy up, launch, copy back, wait) and
    the native call alone; at a spill decision's shape (7 peers, 32 keys
    of 80 bytes, T = 1, the production geometry, half the keys warm) and
    at 8 cells, 256 keys, T = 8; each beside its bound."""
    import numpy as np
    import torch

    from yadcc_tpu_torch.ops import bloom_pipeline as bpl
    from yadcc_tpu_torch.ops import cuda_bloom as kb

    dev = torch.device("cuda")
    rng = np.random.default_rng(111)
    out = {}
    for name, (c_n, n, t_n) in (("path", PLACE_PATH), ("wide", PLACE_WIDE)):
        args, kw, want, filters, keys = placement_case(
            rng, c_n, t_n, n, 80, *PLACE_GEOMETRIES[0], dev)
        want = np.concatenate([w.reshape(-1) for w in want])
        words = args[0]
        slot = kb.PlacementSlot(dev)
        check(np.array_equal(placement_slot_call(slot, args, kw), want),
              f"{name} placement call")
        ms = timed(lambda: kb.placement_launch(slot), 50)
        torch.cuda.synchronize()
        check(np.array_equal(slot.dev_out[:want.size].cpu().numpy(), want),
              f"timed {name} placement")
        floor_ms = timed(lambda: kb.empty_launch(dev), 50)
        plain_ms = timed(lambda: bpl.placement_score_plain(
            *args, device=dev, **kw), 10)
        reps = 200
        t0 = time.perf_counter()
        for _ in range(reps):
            placement_slot_call(slot, args, kw)
        call_ms = (time.perf_counter() - t0) / reps * 1e3
        lay = kb.placement_pack(slot, [0 if w is None else w.data_ptr()
                                       for w in words], *args[1:], **kw)
        t0 = time.perf_counter()
        for _ in range(reps):
            kb.placement_call(slot, lay, words)
        native_ms = (time.perf_counter() - t0) / reps * 1e3
        bound = placement_bound(filters, keys, (t_n,), 80,
                                *PLACE_GEOMETRIES[0])
        out[name] = dict(ms=ms, launch_floor_ms=floor_ms, plain_ms=plain_ms,
                         call_ms=call_ms, native_call_ms=native_ms, C=c_n,
                         N=n, T=t_n, **bound)
        report.append(
            f"  placement at C {c_n} N {n} T {t_n} (80-byte keys, "
            f"production geometry): kernel {ms:.4f} ms (one launch), an "
            f"empty launch {floor_ms:.4f} ms, plain {plain_ms:.4f} ms; the "
            f"whole call {call_ms:.4f} ms, the native call alone "
            f"{native_ms:.4f} ms (host clock); bound "
            f"{bound['bound_ms'] * 1e3:.4f} us by {bound['bound_by']} "
            f"({bound['bytes']} bytes, {bound['ops']} ops)")
    return out


# ---------------------------------------------------------------------------
# Phase 10: the warm-standby takeover.
# ---------------------------------------------------------------------------

TAKEOVER_PRE_GRANTS = 50_000      # through the active, before the kill
TAKEOVER_POST_GRANTS = 100_000    # through the promoted standby
TAKEOVER_HELD = 8                 # grants a delegate holds across the kill
TAKEOVER_SILENCE_S = 1.0
TAKEOVER_RENEW_S = 3.0
TAKEOVER_SETTLE_S = 60.0          # for stale adoptions to be released
# A delegate's pause between requests the promoted standby serves before
# the fleet's re-beat has landed.  The rig beats 5,000 servants through 8
# client threads; unpaced, 24 delegates slow that re-beat past the 10 s
# lease the takeover gives replayed servants, and a servant whose lease
# lapses first loses the grants it reports (PERF.md §7).
TAKEOVER_GAP_PACE_S = 0.5


def start_entry(name: str, port: int, iport: int, extra: list):
    """The scheduler entry as a process on loopback, its log in
    smoke_logs/entry_<name>.log."""
    LOG_DIR.mkdir(parents=True, exist_ok=True)
    log_file = open(LOG_DIR / f"entry_{name}.log", "w")
    cmd = [sys.executable, "-m", "yadcc_tpu_torch.scheduler.entry",
           "--port", str(port), "--inspect-port", str(iport),
           "--acceptable-user-tokens", "utok",
           "--acceptable-servant-tokens", "stok", *extra]
    proc = subprocess.Popen(cmd, cwd=REPO, env=dict(
        os.environ, PYTHONPATH=str(REPO)), stdout=log_file,
        stderr=subprocess.STDOUT)
    proc.log_file = log_file
    return proc


def stop_entry(proc) -> None:
    if proc.poll() is None:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=30)
    proc.log_file.close()


class Failover:
    """A client of an active scheduler with a warm standby behind it: its
    calls go to the active until ``killed`` is set, then to the standby,
    whose refusals before the takeover (NOT_SERVING with a retry-after
    hint in the message) it counts in ``stats`` and retries after the
    hint."""

    def __init__(self, pa: int, ps: int, killed, stats, lock):
        from yadcc_tpu_torch.rpc import Channel

        self.chans = (Channel(f"grpc://127.0.0.1:{pa}"),
                      Channel(f"grpc://127.0.0.1:{ps}"))
        self.killed, self.stats, self.lock = killed, stats, lock

    def call(self, method, req, resp_cls, timeout=30.0, switch=True):
        """(response, True when the standby answered); (None, False) when
        the active died under a call made with ``switch=False``."""
        from yadcc_tpu_torch.rpc import (STATUS_NOT_SERVING, RpcError,
                                         retry_after_ms_from_error)
        from yadcc_tpu_torch.scheduler.service import SERVICE_NAME

        while True:
            standby = self.killed.is_set()
            try:
                resp, _ = self.chans[standby].call(
                    SERVICE_NAME, method, req, resp_cls, timeout=timeout)
                return resp, standby
            except RpcError as e:
                if not standby and self.killed.is_set():
                    if not switch:
                        return None, False
                    continue        # the active died under the call
                if not (standby and e.status == STATUS_NOT_SERVING):
                    raise
                hint = retry_after_ms_from_error(e, default_ms=-1)
                with self.lock:
                    self.stats[f"not_serving:{method}"] = \
                        self.stats.get(f"not_serving:{method}", 0) + 1
                    if hint <= 0:
                        self.stats["not_serving_without_hint"] = \
                            self.stats.get("not_serving_without_hint", 0) + 1
                time.sleep(max(hint, 50) / 1000.0)

    def close(self) -> None:
        for c in self.chans:
            c.close()


# ---------------------------------------------------------------------------
# Phase 12's parked burst: thousands of waits parked on the aio front end.
# ---------------------------------------------------------------------------

BURST_CLIENTS = 2000           # AsyncAioChannel delegates, one client loop
BURST_FREED_CLIENTS = 1500     # on the env whose capacity is then freed
BURST_FREED_SERVANTS = 64      # x BURST_SLOTS slots, all held by a filler
BURST_FULL_SERVANTS = 4        # the env that stays full to the deadline
BURST_SLOTS = 4
# Servants of a third env, so that the parked demand stays well under the
# admission ladder's first step (1.5x the fleet's capacity): the burst
# measures parked waits, not shedding.
BURST_OTHER_SERVANTS = 400
BURST_OTHER_SLOTS = 8
BURST_WAIT_MS = 10_000         # the service's cap on a wait
BURST_FULL_WAIT_MS = 8_000     # the full env's deadline (NO_QUOTA then)
AIO_SYNC_MIN_GRANTS = 100_000  # phase 12's synchronous part


def proc_status(pid: int) -> dict:
    """VmRSS and VmSize (kB) and the thread count of a process."""
    out = {}
    with open(f"/proc/{pid}/status") as f:
        for line in f:
            key, _, val = line.partition(":")
            if key in ("VmRSS", "VmSize", "Threads"):
                out[key] = int(val.split()[0])
    return out


def raise_fd_limit(need: int) -> int:
    """Raise this process's open-file limit to ``need`` (a child started
    afterwards inherits it); fails the phase if the hard limit is lower."""
    import resource

    soft, hard = resource.getrlimit(resource.RLIMIT_NOFILE)
    if soft < need:
        target = need if hard == resource.RLIM_INFINITY else min(need, hard)
        resource.setrlimit(resource.RLIMIT_NOFILE, (target, hard))
        soft = resource.getrlimit(resource.RLIMIT_NOFILE)[0]
    check(soft >= need, f"open-file limit {soft} < {need} (hard {hard})")
    return soft


def wait_ready(name: str, proc, chan) -> float:
    """Poll GetConfig until the entry answers; returns the boot time."""
    from yadcc_tpu_torch import api
    from yadcc_tpu_torch.rpc import RpcError
    from yadcc_tpu_torch.scheduler.service import SERVICE_NAME

    t0 = time.perf_counter()
    deadline = time.monotonic() + 300
    while True:
        check(proc.poll() is None, f"{name}: scheduler exited at boot "
                                   f"(rc {proc.returncode})")
        try:
            chan.call(SERVICE_NAME, "GetConfig",
                      api.scheduler.GetConfigRequest(token="utok"),
                      api.scheduler.GetConfigResponse, timeout=2.0)
            return time.perf_counter() - t0
        except RpcError:
            check(time.monotonic() < deadline, f"{name}: boot timed out")
            time.sleep(0.2)


def run_parked_burst(report: list) -> dict:
    """Phase 12's burst on a pipelined aio entry: every slot of two envs
    held by a filler; BURST_CLIENTS AsyncAioChannel delegates on one
    client loop each park one wait (BURST_FREED_CLIENTS on the env whose
    slots the filler then frees, each freeing its grant at once; the
    rest on the env that stays full).  Every wait is answered exactly
    once: one grant, or NO_QUOTA at its deadline.  The entry's RSS and
    thread count are read before the burst and with every wait parked."""
    import asyncio

    from yadcc_tpu_torch import api
    from yadcc_tpu_torch.rpc import Channel, RpcError
    from yadcc_tpu_torch.rpc.aio_server import (AsyncAioChannel,
                                                EventLoopThread)
    from yadcc_tpu_torch.scheduler.service import SERVICE_NAME

    sch = api.scheduler
    name = "aio_burst"
    fd_limit = raise_fd_limit(2 * BURST_CLIENTS + 1024)
    port, iport = free_port(), free_port()
    proc = start_entry(name, port, iport, ["--rpc-frontend", "aio"])
    ch = Channel(f"aio://127.0.0.1:{port}")
    loops = None
    chans: list = []
    try:
        boot_s = wait_ready(name, proc, ch)
        # The first servant takes slot 0, the slot every loopback
        # delegate resolves to (self-avoidance): it holds neither env.
        servants = [("127.0.0.1:29000", "burst-other", BURST_SLOTS)]
        servants += [(f"127.0.0.1:{29001 + i}", "burst-freed", BURST_SLOTS)
                     for i in range(BURST_FREED_SERVANTS)]
        servants += [(f"127.0.0.1:{29101 + i}", "burst-full", BURST_SLOTS)
                     for i in range(BURST_FULL_SERVANTS)]
        servants += [(f"127.0.0.1:{30000 + i}", "burst-other",
                      BURST_OTHER_SLOTS)
                     for i in range(BURST_OTHER_SERVANTS)]
        for loc, env, slots in servants:
            hb = sch.HeartbeatRequest(
                token="stok", next_heartbeat_in_ms=HB_INTERVAL_MS,
                location=loc, version=1, num_processors=slots,
                capacity=slots, total_memory_in_bytes=64 << 30,
                memory_available_in_bytes=32 << 30)
            hb.env_descs.add(compiler_digest=env)
            ch.call(SERVICE_NAME, "Heartbeat", hb, sch.HeartbeatResponse,
                    timeout=10.0)

        def ask(env, n, wait_ms):
            req = sch.WaitForStartingTaskRequest(
                token="utok", milliseconds_to_wait=wait_ms,
                next_keep_alive_in_ms=60_000, immediate_reqs=n)
            req.env_desc.compiler_digest = env
            return req

        held = {}
        for env, n in (("burst-freed", BURST_FREED_SERVANTS * BURST_SLOTS),
                       ("burst-full", BURST_FULL_SERVANTS * BURST_SLOTS)):
            resp, _ = ch.call(SERVICE_NAME, "WaitForStartingTask",
                              ask(env, n, 5000),
                              sch.WaitForStartingTaskResponse, timeout=30)
            held[env] = [g.task_grant_id for g in resp.grants]
            check(len(held[env]) == n,
                  f"{name}: the filler got {len(held[env])} of {n} on {env}")
        try:
            ch.call(SERVICE_NAME, "WaitForStartingTask",
                    ask("burst-freed", 1, 200),
                    sch.WaitForStartingTaskResponse, timeout=30)
            check(False, f"{name}: a slot was left after the filler")
        except RpcError as e:
            check(e.status == sch.SCHEDULER_STATUS_NO_QUOTA_AVAILABLE,
                  f"{name}: {e!r}")
        before = proc_status(proc.pid)

        results: list = [None] * BURST_CLIENTS
        loops = EventLoopThread(name="burst-clients")

        async def one(i: int, chan) -> None:
            freed = i < BURST_FREED_CLIENTS
            req = ask("burst-freed" if freed else "burst-full", 1,
                      BURST_WAIT_MS if freed else BURST_FULL_WAIT_MS)
            t = time.perf_counter()
            try:
                resp, _ = await chan.call(
                    SERVICE_NAME, "WaitForStartingTask", req,
                    sch.WaitForStartingTaskResponse, timeout=60)
            except RpcError as e:
                results[i] = ("error", e.status, time.perf_counter() - t)
                return
            ids = [g.task_grant_id for g in resp.grants]
            results[i] = ("grants", [(g.task_grant_id, g.servant_location)
                                     for g in resp.grants],
                          time.perf_counter() - t, resp.flow_control)
            if ids:
                await chan.call(SERVICE_NAME, "FreeTask",
                                sch.FreeTaskRequest(token="utok",
                                                    task_grant_ids=ids),
                                sch.FreeTaskResponse, timeout=60)

        async def drive() -> None:
            chans.extend(AsyncAioChannel(f"127.0.0.1:{port}")
                         for _ in range(BURST_CLIENTS))
            await asyncio.gather(*(one(i, c) for i, c in enumerate(chans)))

        t0 = time.perf_counter()
        fut = asyncio.run_coroutine_threadsafe(drive(), loops.loop)
        deadline = time.monotonic() + 60
        while True:
            state = inspect_vars(iport)["yadcc"]
            parked = state["task_dispatcher"]["pending_requests"]
            if parked >= BURST_CLIENTS:
                break
            if fut.done():
                check(False, f"{name}: the burst ended early "
                             f"({fut.exception()!r})")
            check(time.monotonic() < deadline,
                  f"{name}: only {parked} waits parked")
            time.sleep(0.05)
        park_s = time.perf_counter() - t0
        during = proc_status(proc.pid)
        connections = state["rpc_server"]["connections"]
        t_free = time.perf_counter()
        ch.call(SERVICE_NAME, "FreeTask",
                sch.FreeTaskRequest(token="utok",
                                    task_grant_ids=held["burst-freed"]),
                sch.FreeTaskResponse, timeout=30)
        fut.result(timeout=120)
        burst_s = time.perf_counter() - t0
        ch.call(SERVICE_NAME, "FreeTask",
                sch.FreeTaskRequest(token="utok",
                                    task_grant_ids=held["burst-full"]),
                sch.FreeTaskResponse, timeout=30)

        check(all(r is not None for r in results),
              f"{name}: {sum(r is None for r in results)} waits unanswered")
        freed, full = (results[:BURST_FREED_CLIENTS],
                       results[BURST_FREED_CLIENTS:])
        bad = [r for r in freed if r[0] != "grants" or len(r[1]) != 1
               or r[3] != 0
               or not r[1][0][1].startswith("127.0.0.1:290")
               or int(r[1][0][1].rsplit(":", 1)[1]) - 29001
               not in range(BURST_FREED_SERVANTS)]
        check(not bad, f"{name}: freed-env answers {bad[:3]}")
        ids = [r[1][0][0] for r in freed]
        check(len(set(ids)) == len(ids), f"{name}: a grant id twice")
        no_quota = sch.SCHEDULER_STATUS_NO_QUOTA_AVAILABLE
        bad = [r for r in full if r[:2] != ("error", no_quota)
               or r[2] < 0.9 * BURST_FULL_WAIT_MS / 1e3]
        check(not bad, f"{name}: full-env answers {bad[:3]}")
        state = inspect_vars(iport)["yadcc"]
        td = state["task_dispatcher"]
        check(td["failure"] is None, f"{name}: {td['failure']}")
        check(td["pending_requests"] == 0 and td["grants_outstanding"] == 0,
              f"{name}: {td['pending_requests']} pending, "
              f"{td['grants_outstanding']} outstanding after the burst")
        check(td["stats"]["granted"] == sum(held_n for held_n in map(
            len, held.values())) + BURST_FREED_CLIENTS,
            f"{name}: granted {td['stats']['granted']}")
        check(state["rpc_server"]["double_replies"] == 0,
              f"{name}: {state['rpc_server']['double_replies']} double "
              f"replies")
        launches = {k: v["launches"] for k, v in state["kernels"].items()}
        check(launches["grouped_assign"] > 0,
              f"{name}: grouped_assign never launched")
        grant_lat = sorted(r[2] for r in freed)
        res = dict(
            clients=BURST_CLIENTS, boot_s=boot_s, park_s=park_s,
            burst_s=burst_s, fd_limit=fd_limit,
            connections_parked=connections,
            rss_kb_before=before["VmRSS"], rss_kb_parked=during["VmRSS"],
            rss_kb_per_wait=(during["VmRSS"] - before["VmRSS"])
            / BURST_CLIENTS,
            vmsize_kb_before=before["VmSize"],
            vmsize_kb_parked=during["VmSize"],
            threads_before=before["Threads"],
            threads_parked=during["Threads"],
            freed_grant_p50_ms=grant_lat[len(grant_lat) // 2] * 1e3,
            freed_grant_max_ms=grant_lat[-1] * 1e3,
            all_granted_after_free_s=max(
                t0 + r[2] for r in freed) - t_free,
            launches=launches, frontend=frontend_summary(state))
        check(during["Threads"] - before["Threads"] < 64,
              f"{name}: {during['Threads'] - before['Threads']} threads "
              f"for {BURST_CLIENTS} parked waits")
        report.append(
            f"  {name}: {BURST_CLIENTS} waits parked in {park_s:.2f} s over "
            f"{connections} connections; entry RSS {before['VmRSS']} kB "
            f"before, {during['VmRSS']} kB parked "
            f"({res['rss_kb_per_wait']:.2f} kB a wait), VmSize "
            f"{before['VmSize']} -> {during['VmSize']} kB, threads "
            f"{before['Threads']} -> {during['Threads']}; "
            f"{BURST_FREED_CLIENTS} answered with one grant each once the "
            f"filler freed (wait p50 {res['freed_grant_p50_ms']:.1f} ms, "
            f"all within {res['all_granted_after_free_s']:.2f} s of the "
            f"free), {BURST_CLIENTS - BURST_FREED_CLIENTS} with NO_QUOTA at "
            f"their {BURST_FULL_WAIT_MS} ms deadline; double replies 0; K1 "
            f"launches {launches['grouped_assign']}; open-file limit "
            f"{fd_limit}")
        return res
    finally:
        for c in chans:
            if loops is not None:
                loops.call_soon(c.close)
        if loops is not None:
            loops.stop()
        ch.close()
        stop_entry(proc)


def aio_line(name: str, aio: dict, base: dict, base_name: str) -> str:
    """One phase on the aio front end beside its threaded twin."""
    front, bfront = aio["frontend"], base["frontend"]

    def stage(st, key):
        return (f"{st[key]['p50_ms']:.3f}/{st[key]['p99_ms']:.3f}"
                if st and key in st else "-")

    stages = "; ".join(
        f"loop {k}: " + ", ".join(
            f"{key} {stage(st, key)}"
            for key in ("accept", "read", "parse", "write"))
        for k, st in enumerate(front.get("stages", [])))
    lags = "; ".join(
        f"loop {k} p50 {lg['p50_ms']:.3f} p99 {lg['p99_ms']:.3f} max "
        f"{lg['max_ms']:.3f} ({lg['count']} ticks)"
        for k, lg in enumerate(front.get("loop_lag", [])))
    return (
        f"  {name} (aio) beside {base_name} (threaded), same call: "
        f"{aio['grants_per_s']:.1f} vs {base['grants_per_s']:.1f} grants/s "
        f"({aio['grants_per_s'] / base['grants_per_s']:.2f}x); "
        f"WaitForStartingTask p50 {aio['p50_ms']:.2f} vs "
        f"{base['p50_ms']:.2f} ms, p99 {aio['p99_ms']:.2f} vs "
        f"{base['p99_ms']:.2f} ms; handler p50/p99 "
        f"{stage({'h': front['handler']}, 'h')} vs "
        f"{stage({'h': bfront['handler']}, 'h')} ms; aio stages p50/p99 "
        f"ms: {stages}; loop lag ms: {lags}")


def run_aio_path(report: list, phases: dict) -> None:
    """Phases 12-13: phases 3, 4 and 8's drives through the aio front
    end, the parked burst and the hot delegate.  ``phases`` holds phases
    3, 4 and 8's results (``pipelined``, ``synchronous``, ``sharded``:
    the threaded twins each is printed beside) and receives the new
    ones."""
    phases["aio_pipelined"] = run_main_path(
        "aio_pipelined", ["--rpc-frontend", "aio"], Fleet(seed=6), report)
    # The inline leader runs every cycle on the loop, one request deep
    # (the loop reads nothing while it leads), so `auto` may keep every
    # cycle on the host: K1's launches are reported, not required.
    phases["aio_synchronous"] = run_main_path(
        "aio_synchronous", ["--rpc-frontend", "aio",
                            "--dispatch-pipeline-depth", "0"],
        Fleet(seed=7), report, kernel=None, min_grants=AIO_SYNC_MIN_GRANTS)
    burst = run_parked_burst(report)
    phases["aio_burst"] = {"launches": burst["launches"]}
    report.append(aio_line("aio_pipelined", phases["aio_pipelined"],
                           phases["pipelined"], "phase 3"))
    report.append(aio_line("aio_synchronous", phases["aio_synchronous"],
                           phases["synchronous"], "phase 4"))
    phases["aio_sharded"] = run_main_path(
        "aio_sharded", ["--rpc-frontend", "aio", "--accept-loops", "4",
                        "--shards", str(SHARDS)], Fleet(seed=8), report,
        shards=SHARDS, min_grants=SHARDED_MIN_GRANTS, post=hot_steal_step)
    hot = phases["aio_sharded"]["post"]
    report.append(aio_line("aio_sharded", phases["aio_sharded"],
                           phases["sharded"], "phase 8"))
    report.append(
        f"  aio_sharded: the drive stole {phases['aio_sharded']['stolen']} "
        f"grants (phase 8: {phases['sharded']['stolen']}); the hot "
        f"delegate {hot['stolen']} through the asynchronous steal "
        f"(task_dispatcher.steal after it: {json.dumps(hot['steal'])})")


def run_takeover_path(report: list) -> dict:
    """Phase 10: a standby entry (--standby, policy warmed on the card at
    boot) behind an active entry with phase 3's defaults and
    --replicate-to; 5,000 servants; 24 delegates drive >=
    TAKEOVER_PRE_GRANTS grants, each holding its first TAKEOVER_HELD
    grants (renewed by KeepTaskAlive); the active is killed (SIGKILL)
    mid-drive, the grants of responses that arrive in its last 0.1 s held
    too (some never shipped: the journal's gap).  The delegates and the
    fleet redial the standby at once and keep calling it: before the
    promotion it must refuse, WaitForStartingTask with FLOW_CONTROL_REJECT
    and a retry-after (the delegates count them), the other methods with
    NOT_SERVING and the in-band hint.  After it the delegates are served
    at once (paced by TAKEOVER_GAP_PACE_S) while every servant
    re-heartbeats with the grants it runs; then every held grant renews exactly once, the delegates drive >=
    TAKEOVER_POST_GRANTS more grants through the standby's K1, and
    everything is freed.  Every grant checked against the servants' facts,
    no grant id issued twice across the kill, the standby's outstanding
    grants 0 at the end (stale adoptions, grants freed on the active after
    its last shipped batch, released after their lease), its K1 launches 0
    before the promotion and > 0 after.  No servant over its capacity
    (held and adopted grants counted), with one exception the design
    shares with the reference (ROADMAP Queue 3): a grant requested before
    its servant's re-heartbeat reached the promoted standby, on a servant
    that holds grants of the active's last 0.1 s, by no more than their
    number, is counted as a gap fault and reported, not failed."""
    from yadcc_tpu_torch import api
    from yadcc_tpu_torch.rpc import Channel, RpcError
    from yadcc_tpu_torch.scheduler.service import SERVICE_NAME

    sch = api.scheduler
    fleet = Fleet(seed=7)
    ids_at = {s["location"]: set() for s in fleet.servants}
    pa, ia, ps, is_ = free_port(), free_port(), free_port(), free_port()
    t_boot = time.perf_counter()
    standby = start_entry("standby", ps, is_, [
        "--standby", "--standby-takeover-silence", str(TAKEOVER_SILENCE_S),
        "--replication-token", "rtok"])
    active = start_entry("active", pa, ia, [
        "--replicate-to", f"grpc://127.0.0.1:{ps}",
        "--replication-token", "rtok"])
    lock = threading.Lock()
    stats: dict = {}
    killed, freeze, resume, done = (threading.Event() for _ in range(4))
    renew_on = threading.Event()
    threads: list = []
    early_held: list = []       # (gid, loc): each delegate's first grants
    kill_held: list = []        # grants of responses in the active's end
    grant_ids: set = set()
    totals = {"pre": 0, "gap": 0, "post": 0, "calls": 0, "empty": 0,
              "reject": 0}
    errors: list = []
    first_standby_grant = []
    kill_at: dict = collections.Counter()   # kill-time grants a servant holds
    beat_at: dict = {}          # servant -> its first beat the promoted
    gap_faults: list = []       # standby answered; (servant, excess)

    def standby_vars():
        return inspect_vars(is_)["yadcc"]

    try:
        # Boot: the active serves; the standby answers its inspect port
        # (its dispatcher built and warmed on the card).
        deadline = time.monotonic() + 300
        ch = Channel(f"grpc://127.0.0.1:{pa}")
        while True:
            check(active.poll() is None and standby.poll() is None,
                  "takeover: an entry exited at boot")
            check(time.monotonic() < deadline, "takeover: boot timed out")
            try:
                ch.call(SERVICE_NAME, "GetConfig",
                        sch.GetConfigRequest(token="utok"),
                        sch.GetConfigResponse, timeout=2.0)
                sv = standby_vars()
                if "standby" in sv:
                    break
            except (RpcError, OSError):
                pass
            time.sleep(0.2)
        boot_s = time.perf_counter() - t_boot
        check(not sv["standby"]["promoted"], "takeover: promoted at boot")
        check(sv["kernels"]["grouped_assign"]["launches"] == 0,
              "takeover: the standby launched before its promotion")

        def heartbeat(s):
            req = fleet.heartbeat(api, s)
            with fleet.lock:
                held_here = sorted(ids_at[s["location"]])
            for gid in held_here:
                req.running_tasks.add(servant_task_id=gid,
                                      task_grant_id=gid)
            return req

        def beat_all(fo, servants):
            try:
                for s in servants:
                    resp, on_standby = fo.call("Heartbeat", heartbeat(s),
                                               sch.HeartbeatResponse,
                                               timeout=10.0)
                    killed_ids = set(resp.expired_tasks)
                    with fleet.lock:
                        if on_standby:
                            beat_at.setdefault(s["location"],
                                               time.perf_counter())
                        lost = killed_ids & held_set
                    if lost:
                        fleet.violations.append(
                            f"held grants {sorted(lost)[:5]} killed on "
                            f"{s['location']}")
            except Exception as e:  # reported by the main thread
                errors.append(f"heartbeat: {e!r}")

        held_set: set = set()
        clients = [Failover(pa, ps, killed, stats, lock) for _ in range(8)]
        beat_all(clients[0], fleet.servants[:1])
        requestor_loc = fleet.servants[0]["location"]
        chunks = [fleet.servants[1 + i::8] for i in range(8)]

        def beat_round(first=False):
            regs = [threading.Thread(target=beat_all, args=(clients[i], c))
                    for i, c in enumerate(chunks)]
            if first:
                regs.append(threading.Thread(
                    target=beat_all, args=(clients[0], fleet.servants[:1])))
            for t in regs:
                t.start()
            for t in regs:
                t.join()

        beat_round()
        td = inspect_vars(ia)["yadcc"]["task_dispatcher"]
        check(len(td["servants"]) == N_SERVANTS,
              f"takeover: {len(td['servants'])} servants registered")

        def rebeat():
            while not done.wait(HB_REPEAT_S):
                if not killed.is_set() or resume.is_set():
                    beat_round()

        def renewer():
            fo = Failover(pa, ps, killed, stats, lock)
            try:
                while not done.wait(TAKEOVER_RENEW_S):
                    if not renew_on.is_set():
                        continue
                    with fleet.lock:
                        ids = [g for g, _ in early_held]
                    if not ids:
                        continue
                    resp, _ = fo.call("KeepTaskAlive",
                                      sch.KeepTaskAliveRequest(
                                          token="utok", task_grant_ids=ids,
                                          next_keep_alive_in_ms=15000),
                                      sch.KeepTaskAliveResponse)
                    if renew_on.is_set() and not all(resp.statuses):
                        fleet.violations.append("a held grant's renewal "
                                                "failed")
            except Exception as e:
                errors.append(f"renewer: {e!r}")
            finally:
                fo.close()

        def validate(resp, env, on_standby, t_req):
            """Phase 3's checks on one response; the grants counted as held
            by their servants.  An over-capacity grant of the standby's,
            requested before its servant's re-beat landed there, by no more
            than the kill-time grants the servant holds, is a gap fault."""
            ids = [g.task_grant_id for g in resp.grants]
            with fleet.lock:
                for g in resp.grants:
                    s = fleet.by_loc.get(g.servant_location)
                    if s is None:
                        fleet.violations.append(
                            f"grant on unknown servant {g.servant_location}")
                        continue
                    if env not in s["envs"]:
                        fleet.violations.append(f"{s['location']} lacks {env}")
                    if s["location"] == requestor_loc:
                        fleet.violations.append(
                            "grant on the requestor's own servant")
                    fleet.held[s["location"]] += 1
                    ids_at[s["location"]].add(g.task_grant_id)
                    excess = fleet.held[s["location"]] - s["capacity"]
                    if excess <= 0:
                        continue
                    landed = beat_at.get(s["location"])
                    if on_standby and (landed is None or t_req < landed) \
                            and excess <= kill_at[s["location"]]:
                        gap_faults.append((s["location"], excess))
                    else:
                        fleet.violations.append(
                            f"{s['location']} over capacity "
                            f"{fleet.held[s['location']]}/{s['capacity']}")
            with lock:
                dup = grant_ids.intersection(ids)
                if dup or len(set(ids)) != len(ids):
                    fleet.violations.append(f"duplicate ids {sorted(dup)[:5]}")
                grant_ids.update(ids)

        def release(pairs):
            with fleet.lock:
                for gid, loc in pairs:
                    fleet.held[loc] -= 1
                    ids_at[loc].discard(gid)

        def delegate(d: int):
            rng = random.Random(3000 + d)
            envs = rng.sample(fleet.envs, ENVS_PER_DELEGATE)
            fo = Failover(pa, ps, killed, stats, lock)
            k = 0
            try:
                while not done.is_set():
                    env = envs[k % len(envs)]
                    k += 1
                    req = sch.WaitForStartingTaskRequest(
                        token="utok", milliseconds_to_wait=2000,
                        next_keep_alive_in_ms=15000,
                        immediate_reqs=IMMEDIATE)
                    req.env_desc.compiler_digest = env
                    t_req = time.perf_counter()
                    try:
                        # A request the active died under is not sent
                        # again: the delegate asks the standby anew.
                        resp, on_standby = fo.call(
                            "WaitForStartingTask", req,
                            sch.WaitForStartingTaskResponse, switch=False)
                    except RpcError as e:
                        if e.status == sch.SCHEDULER_STATUS_NO_QUOTA_AVAILABLE:
                            with lock:
                                totals["empty"] += 1
                            continue
                        raise
                    if resp is None:
                        continue
                    if resp.flow_control == sch.FLOW_CONTROL_REJECT:
                        # The standby's gate before its promotion: no
                        # grants, and a retry-after the delegate honours.
                        with lock:
                            totals["reject"] += on_standby
                            if resp.grants or resp.retry_after_ms <= 0:
                                fleet.violations.append(
                                    f"a REJECT with {len(resp.grants)} "
                                    f"grants, retry_after_ms "
                                    f"{resp.retry_after_ms}")
                        time.sleep(max(resp.retry_after_ms, 50) / 1000.0)
                        continue
                    validate(resp, env, on_standby, t_req)
                    pairs = [(g.task_grant_id, g.servant_location)
                             for g in resp.grants]
                    with lock:
                        totals["pre" if not on_standby else
                               "post" if resume.is_set() else "gap"] += \
                            len(pairs)
                        totals["calls"] += 1
                        if on_standby and not first_standby_grant and pairs:
                            first_standby_grant.append(time.time())
                        if totals["pre"] >= TAKEOVER_PRE_GRANTS and \
                                not freeze.is_set():
                            freeze.set()
                        if totals["post"] >= TAKEOVER_POST_GRANTS:
                            done.set()
                    if not on_standby and len(early_held) < \
                            TAKEOVER_HELD * N_DELEGATES and k == 1:
                        keep, pairs = pairs[:TAKEOVER_HELD], \
                            pairs[TAKEOVER_HELD:]
                        with fleet.lock:
                            early_held.extend(keep)
                            held_set.update(g for g, _ in keep)
                    elif not on_standby and freeze.is_set():
                        with fleet.lock:
                            kill_held.extend(pairs)
                            held_set.update(g for g, _ in pairs)
                            kill_at.update(loc for _, loc in pairs)
                        continue
                    release(pairs)
                    if pairs:
                        fo.call("FreeTask", sch.FreeTaskRequest(
                            token="utok", task_grant_ids=[g for g, _ in pairs]),
                            sch.FreeTaskResponse)
                    if on_standby and not resume.is_set():
                        done.wait(TAKEOVER_GAP_PACE_S)
            except Exception as e:  # reported by the main thread below
                errors.append(f"delegate {d}: {e!r}")
                done.set()
            finally:
                fo.close()

        for target in (rebeat, renewer):
            t = threading.Thread(target=target, daemon=True)
            t.start()
            threads.append(t)
        renew_on.set()
        workers = [threading.Thread(target=delegate, args=(d,))
                   for d in range(N_DELEGATES)]
        t0 = time.perf_counter()
        for t in workers:
            t.start()
        while not freeze.wait(1.0):
            check(active.poll() is None, "takeover: the active died")
            check(not errors, f"takeover: {errors[:3]}")
            check(time.perf_counter() - t0 < PHASE_LIMIT_S,
                  f"takeover: {totals['pre']} grants before the kill")
        pre_s = time.perf_counter() - t0
        active_td = inspect_vars(ia)["yadcc"]
        time.sleep(0.1)
        renew_on.clear()
        journal_seq = standby_vars()["standby"]["journal_seq"]
        killed.set()
        active.kill()
        t_kill = time.perf_counter()
        t_kill_wall = time.time()   # beside the standby's promoted_at
        active.wait(timeout=30)
        # The fleet redials the standby at once, its heartbeats refused
        # (NOT_SERVING with the hint) until the promotion; they carry the
        # grants each servant runs, so the journal gap's are adopted.
        rebeat_thread = threading.Thread(target=beat_round, args=(True,))
        rebeat_thread.start()

        # Before the promotion: the gate's refusals, probed without side
        # effects (an environment no servant has, no grant ids).
        probe = Channel(f"grpc://127.0.0.1:{ps}")
        probes = {"reject": 0, "not_serving": 0, "hint_ms": set()}

        def promoted_soon():
            """The gate forwards once the takeover has promoted it; the
            entry publishes the promotion right after the takeover
            returns."""
            deadline = time.monotonic() + 2.0
            while not standby_vars()["standby"]["promoted"]:
                if time.monotonic() > deadline:
                    return False
                time.sleep(0.01)
            return True
        promoted = None
        from yadcc_tpu_torch.rpc import (STATUS_NOT_SERVING,
                                         retry_after_ms_from_error)
        while promoted is None:
            check(time.perf_counter() - t_kill < 60,
                  "takeover: no promotion within 60 s of the kill")
            sv = standby_vars()
            if sv["standby"]["promoted"]:
                promoted = time.perf_counter()
                break
            # Read before the probe: if the gate then still refuses, the
            # count is one from before the promotion.
            k1_before = sv["kernels"]["grouped_assign"]["launches"]
            req = sch.WaitForStartingTaskRequest(
                token="utok", milliseconds_to_wait=50, immediate_reqs=1)
            req.env_desc.compiler_digest = "no-such-environment"
            try:
                resp, _ = probe.call(SERVICE_NAME, "WaitForStartingTask",
                                     req, sch.WaitForStartingTaskResponse,
                                     timeout=5.0)
                if resp.flow_control == sch.FLOW_CONTROL_REJECT:
                    check(resp.retry_after_ms > 0 and not resp.grants,
                          "takeover: a REJECT without retry_after_ms")
                    check(k1_before == 0, "takeover: K1 launched on the "
                                          "standby before its promotion")
                    probes["reject"] += 1
                else:
                    check(promoted_soon(),
                          "takeover: the standby served before promotion")
            except RpcError as e:
                check(e.status == sch.SCHEDULER_STATUS_NO_QUOTA_AVAILABLE
                      and promoted_soon(),
                      f"takeover: WaitForStartingTask before promotion "
                      f"answered {e.status}")
            for method, preq, pcls in (
                    ("KeepTaskAlive", sch.KeepTaskAliveRequest(token="utok"),
                     sch.KeepTaskAliveResponse),
                    ("FreeTask", sch.FreeTaskRequest(token="utok"),
                     sch.FreeTaskResponse)):
                try:
                    probe.call(SERVICE_NAME, method, preq, pcls, timeout=5.0)
                except RpcError as e:
                    check(e.status == STATUS_NOT_SERVING,
                          f"takeover: {method} answered {e.status}")
                    probes["not_serving"] += 1
                    probes["hint_ms"].add(retry_after_ms_from_error(e, -1))
            time.sleep(0.05)
        probe.close()
        check(probes["reject"] > 0 and probes["not_serving"] > 0,
              f"takeover: the gate was never probed before promotion "
              f"({probes})")
        check(-1 not in probes["hint_ms"],
              "takeover: a NOT_SERVING without its retry-after hint")
        takeover = sv["standby"]["report"]
        promoted_at = sv["standby"]["promoted_at"]

        # After it: the fleet's re-heartbeat lands (the journal gap's
        # grants adopted off the reports), then every held grant renews
        # exactly once, then the kill-time grants are freed.
        rebeat_thread.join(timeout=120)
        check(not rebeat_thread.is_alive(), "takeover: the re-beat hung")
        check(not errors, f"takeover: {errors[:3]}")
        rebeat_s = time.time() - sv["standby"]["promoted_at"]
        with fleet.lock:
            held_ids = [g for g, _ in early_held + kill_held]
        renew = Channel(f"grpc://127.0.0.1:{ps}")
        resp, _ = renew.call(SERVICE_NAME, "KeepTaskAlive",
                             sch.KeepTaskAliveRequest(
                                 token="utok", task_grant_ids=held_ids,
                                 next_keep_alive_in_ms=15000),
                             sch.KeepTaskAliveResponse, timeout=30.0)
        renewed = sum(resp.statuses)
        check(renewed == len(held_ids) == len(set(held_ids)),
              f"takeover: {renewed} of {len(held_ids)} held grants renewed "
              f"once after the promotion (re-beat {rebeat_s:.2f} s; "
              f"{fleet.violations[:3]})")
        adopted_now = standby_vars()["task_dispatcher"]["stats"][
            "adopted_grants"]
        release(kill_held)
        renew.call(SERVICE_NAME, "FreeTask", sch.FreeTaskRequest(
            token="utok", task_grant_ids=[g for g, _ in kill_held]),
            sch.FreeTaskResponse, timeout=30.0)
        with fleet.lock:
            held_set.difference_update(g for g, _ in kill_held)
            kill_at.clear()
        renew_on.set()
        t_resume = time.perf_counter()
        resume.set()
        while not done.wait(1.0):
            check(standby.poll() is None, "takeover: the standby died")
            check(time.perf_counter() - t_resume < PHASE_LIMIT_S,
                  f"takeover: {totals['post']} grants after the promotion")
        for t in workers:
            t.join(timeout=60)
            check(not t.is_alive(), "takeover: a delegate hung")
        post_s = time.perf_counter() - t_resume
        check(not errors, f"takeover: {errors[:3]}")
        check(not fleet.violations, f"takeover: {fleet.violations[:5]}")
        check(totals["reject"] > 0, "takeover: no delegate saw the "
                                    "standby's REJECT before the promotion")

        # Free the held grants; stale adoptions zombie after their lease
        # and go at their servant's next report.
        release(early_held)
        renew.call(SERVICE_NAME, "FreeTask", sch.FreeTaskRequest(
            token="utok", task_grant_ids=[g for g, _ in early_held]),
            sch.FreeTaskResponse, timeout=30.0)
        with fleet.lock:
            held_set.clear()
        t_settle = time.perf_counter()
        while True:
            td = standby_vars()["task_dispatcher"]
            if td["grants_outstanding"] == 0:
                break
            check(time.perf_counter() - t_settle < TAKEOVER_SETTLE_S,
                  f"takeover: {td['grants_outstanding']} grants outstanding "
                  f"on the standby {TAKEOVER_SETTLE_S} s after the drive")
            beat_round()
            time.sleep(1.0)
        settle_s = time.perf_counter() - t_settle
        renew.close()
        sv = standby_vars()
        td = sv["task_dispatcher"]
        check(td["failure"] is None, f"takeover: {td['failure']}")
        launches = {k: v["launches"] for k, v in sv["kernels"].items()}
        check(launches["grouped_assign"] > 0,
              "takeover: K1 never launched on the standby")
        check(active.returncode == -9, f"takeover: the active exited "
                                       f"{active.returncode}")
    finally:
        done.set()
        resume.set()
        for t in threads:
            t.join(timeout=30)
        stop_entry(active)
        stop_entry(standby)
    check(standby.returncode == 0, f"takeover: the standby exited "
                                   f"{standby.returncode}")
    res = dict(
        boot_s=boot_s, pre_grants=totals["pre"], pre_s=pre_s,
        pre_grants_per_s=totals["pre"] / pre_s,
        post_grants=totals["post"], post_s=post_s,
        post_grants_per_s=totals["post"] / post_s,
        kill_to_promotion_ms=(promoted_at - t_kill_wall) * 1e3,
        kill_to_first_grant_ms=(first_standby_grant[0] - t_kill_wall) * 1e3,
        promotion_to_first_grant_ms=(first_standby_grant[0] - promoted_at)
        * 1e3, rebeat_s=rebeat_s, settle_s=settle_s,
        takeover=takeover, journal_seq_at_kill=journal_seq,
        held=len(held_ids), renewed=renewed,
        kill_held=len(kill_held), adopted_after_reports=adopted_now,
        gap_adopted=adopted_now - takeover["grants_adopted"],
        gate_probes={k: (sorted(v) if isinstance(v, set) else v)
                     for k, v in probes.items()},
        delegate_rejects=totals["reject"], gap_grants=totals["gap"],
        gap_faults=len(gap_faults),
        gap_fault_servants=len({loc for loc, _ in gap_faults}),
        gap_fault_max_excess=max((e for _, e in gap_faults), default=0),
        refused=dict(stats), launches=launches,
        active_launches={k: v["launches"] for k, v
                         in active_td["kernels"].items()},
        stats=td["stats"], stages=td["latency_breakdown"])
    report.append(
        f"  takeover: boot {boot_s:.1f} s; {totals['pre']} grants through "
        f"the active in {pre_s:.2f} s; SIGKILL; promotion "
        f"{res['kill_to_promotion_ms']:.1f} ms after it (takeover "
        f"{takeover['takeover_ms']:.2f} ms: {takeover['servants_replayed']} "
        f"servants replayed, {takeover['grants_adopted']} grants adopted of "
        f"{takeover['grants_journaled']} journaled, seq "
        f"{takeover['replayed_seq']}); before it {probes['reject']} "
        f"REJECTs and {probes['not_serving']} NOT_SERVINGs with hints "
        f"{sorted(probes['hint_ms'])} ms to the probe, "
        f"{totals['reject']} REJECTs to the delegates")
    report.append(
        f"  takeover: the fleet's re-beat done {rebeat_s:.2f} s after the "
        f"promotion; "
        f"{len(held_ids)} held grants ({len(kill_held)} of the active's last "
        f"0.1 s) each renewed once; adopted {adopted_now} in all "
        f"({res['gap_adopted']} off the servants' reports: the journal's "
        f"gap); first "
        f"grant {res['kill_to_first_grant_ms']:.1f} ms after the kill "
        f"({res['promotion_to_first_grant_ms']:.1f} ms after the promotion);"
        f" {totals['gap']} grants while the fleet re-beat, "
        f"{len(gap_faults)} of them over capacity on "
        f"{res['gap_fault_servants']} servants that ran grants unknown to "
        f"the standby (gap faults, at most "
        f"{res['gap_fault_max_excess']} over); then {totals['post']} "
        f"grants in {post_s:.2f} s = {res['post_grants_per_s']:.1f} grants/s "
        f"({res['pre_grants_per_s']:.1f} before the kill); K1 launches on "
        f"the standby {launches['grouped_assign']}; outstanding 0 "
        f"{settle_s:.1f} s after the drive (stats {json.dumps(td['stats'])})"
        f"; no other grant over capacity, no violations, no id issued "
        f"twice")
    report.append(f"  takeover refusals seen by the fleet: "
                  f"{json.dumps(dict(stats))}")
    return res


# ---------------------------------------------------------------------------
# Phase 11: the federation plane, in process.
# ---------------------------------------------------------------------------

FED_CELLS = 8
FED_SLOTS = 1024
FED_DECISIONS = 2000
FED_DELEGATES = 8
FED_MEMBERS = 200_000           # each peer's region filter: its members
FED_WARM_ENVS = 16              # envs whose candidate keys a peer holds
FED_TOPOLOGY = (0, 1, 1, 2, 2, 3, 3, 4)
FED_BITS, FED_HASHES = 27_584_639, 10   # the production geometry
FED_REPLAY = 500                # scorer calls replayed with the cells idle
FED_SPIN_REPLAY = 20            # and beside threads spinning in Python


def fed_key(env: str, i: int) -> str:
    """A production-format 80-byte cache key of an environment."""
    return f"{env}/obj/{i:08d}".ljust(80, ".")


def run_federation_path(report: list, place_timing: dict) -> dict:
    """Phase 11: eight cells, each a TaskDispatcher with the auto policy on
    the card (pipelined, its own CUDA stream), 1,024 slots a cell, phase
    3's 5,000 servants split by cell; a FederationRouter for cell 0, whose
    ladder is held at RUNG_SPILLOVER; each peer's production-geometry
    region filter (its own salt and members, the candidate keys of
    FED_WARM_ENVS environments among them) built on the card by the
    scatter-OR and installed as its snapshot.  Delegate threads drive >=
    FED_DECISIONS scored spill decisions of up to 8 grants, renewing and
    freeing through the router.  Every scored pick and score row must
    equal host_reference_placement's on the host; spilled grants' renewals
    and frees route home by cell_of_grant; no grant id is shared by two
    cells; the kernel's launches equal the scored decisions."""
    import numpy as np
    import torch

    from yadcc_tpu_torch.common import bloom
    from yadcc_tpu_torch.ops import bloom_pipeline as bpl
    from yadcc_tpu_torch.ops import cuda_assign, cuda_grouped
    from yadcc_tpu_torch.ops import cuda_bloom as kb
    from yadcc_tpu_torch.scheduler import placement as pl
    from yadcc_tpu_torch.scheduler.admission import RUNG_SPILLOVER
    from yadcc_tpu_torch.scheduler.entry import resolve_pipeline_depth
    from yadcc_tpu_torch.scheduler.federation import (
        CellHandle, FederationRouter, cell_of_grant,
        grant_namespace_for_cell)
    from yadcc_tpu_torch.scheduler.policy import make_policy
    from yadcc_tpu_torch.scheduler.task_dispatcher import (ServantInfo,
                                                           TaskDispatcher)

    dev = torch.device("cuda")
    t_build = time.perf_counter()
    cells = []
    for c in range(FED_CELLS):
        policy = make_policy("auto", device=dev)
        depth = resolve_pipeline_depth("auto", policy, dev)
        policy.stream_warmup(FED_SLOTS)
        start, stride = grant_namespace_for_cell(c, FED_CELLS)
        cells.append(TaskDispatcher(policy, max_servants=FED_SLOTS,
                                    pipeline_depth=depth,
                                    grant_id_start=start,
                                    grant_id_stride=stride))
    fleet = Fleet(seed=8)
    cell_of_servant = {}
    for i, s in enumerate(fleet.servants):
        cell_of_servant[s["location"]] = i % FED_CELLS
        check(cells[i % FED_CELLS].keep_servant_alive(ServantInfo(
            location=s["location"], version=1,
            num_processors=s["capacity"], dedicated=s["dedicated"],
            capacity=s["capacity"], total_memory=64 << 30,
            memory_available=32 << 30,
            env_digests=tuple(sorted(s["envs"]))), 600.0),
            "federation: a servant was refused")

    class RecordingScorer(pl.DevicePlacementScorer):
        """The production scorer, its inputs and results kept for the host
        oracle."""

        def __init__(self):
            super().__init__("cuda")
            self.calls = []
            self.calls_lock = threading.Lock()

        def score(self, cands, keys_per_task):
            res = super().score(cands, keys_per_task)
            with self.calls_lock:
                self.calls.append((list(cands),
                                   [list(k) for k in keys_per_task], res))
            return res

    scorer = RecordingScorer()
    router = FederationRouter(
        [CellHandle(c, d) for c, d in enumerate(cells)], 0,
        topology_distance=FED_TOPOLOGY, placement_scorer=scorer,
        device="cuda")
    rng = np.random.default_rng(112)
    warm = {}
    t_filters = time.perf_counter()
    for c in range(1, FED_CELLS):
        salt = int(rng.integers(0, 1 << 63))
        warm[c] = set(rng.choice(fleet.envs, FED_WARM_ENVS,
                                 replace=False).tolist())
        members = [fed_key(e, i) for e in sorted(warm[c]) for i in range(32)]
        members += [f"cell{c}/member/{i:010d}".ljust(80, ".")
                    for i in range(FED_MEMBERS - len(members))]
        fps = bpl.as_device_words(bloom.key_fingerprints(members, salt), dev)
        zero = torch.zeros(-(-FED_BITS // 32), dtype=torch.int32,
                           device=dev)
        words = kb.bloom_scatter_or(zero, fps, num_bits=FED_BITS,
                                    num_hashes=FED_HASHES)
        snap = bloom.SaltedBloomFilter(FED_BITS, FED_HASHES, salt,
                                       words.cpu().numpy().view(np.uint32))
        check(snap.may_contain_batch(members[:1000]).all(),
              f"federation: cell {c}'s card-built filter misses a member")
        router.update_cell_filter(c, snap)
    filters_s = time.perf_counter() - t_filters
    check(scorer.resident_cells() == list(range(1, FED_CELLS)),
          "federation: the snapshots are not resident on the card")
    for e in fleet.envs:
        router.note_candidate_keys(e, [fed_key(e, i) for i in range(32)])
    cells[0].restore_admission_rung(RUNG_SPILLOVER)
    build_s = time.perf_counter() - t_build

    lock = threading.Lock()
    errors: list = []
    seen: dict = {}
    totals = {"calls": 0, "grants": 0, "spilled": 0, "renewed": 0}
    done = threading.Event()

    def delegate(d: int):
        drng = random.Random(4000 + d)
        who = f"10.99.0.{d + 1}:40000"
        try:
            while not done.is_set():
                env = drng.choice(fleet.envs)
                routed = router.wait_for_starting_new_task_routed(
                    env, requestor=who, immediate=drng.randint(1, 8),
                    timeout_s=2.0)
                pairs = [(g.grant_id, g.servant_location)
                         for g in routed.grants]
                with fleet.lock:
                    for g in routed.grants:
                        s = fleet.by_loc.get(g.servant_location)
                        c = cell_of_servant.get(g.servant_location)
                        if s is None or env not in s["envs"]:
                            fleet.violations.append(
                                f"grant {g.grant_id} on {g.servant_location}"
                                f" for {env}")
                            continue
                        if c != g.cell_id or c != cell_of_grant(
                                g.grant_id, FED_CELLS):
                            fleet.violations.append(
                                f"grant {g.grant_id} of cell {g.cell_id} on "
                                f"a servant of cell {c}")
                        if g.spilled != (g.cell_id != 0):
                            fleet.violations.append(
                                f"grant {g.grant_id} spilled={g.spilled} "
                                f"from cell {g.cell_id}")
                        fleet.held[s["location"]] += 1
                        if fleet.held[s["location"]] > s["capacity"]:
                            fleet.violations.append(
                                f"{s['location']} over capacity")
                with lock:
                    for gid, _ in pairs:
                        if gid in seen:
                            fleet.violations.append(f"id {gid} twice")
                        seen[gid] = cell_of_grant(gid, FED_CELLS)
                    totals["calls"] += 1
                    totals["grants"] += len(pairs)
                    totals["spilled"] += routed.spilled_count
                if pairs:
                    ok = router.keep_task_alive([g for g, _ in pairs], 15.0)
                    if not all(ok):
                        fleet.violations.append("a renewal routed home "
                                                "failed")
                    with lock:
                        totals["renewed"] += len(ok)
                    with fleet.lock:
                        for _, loc in pairs:
                            fleet.held[loc] -= 1
                    router.free_task([g for g, _ in pairs])
                if router.stats()["placement_scored"] >= FED_DECISIONS:
                    done.set()
        except Exception as e:  # reported below
            errors.append(f"delegate {d}: {e!r}")
            done.set()

    for name in kb.launches:
        kb.launches[name] = 0
    cuda_grouped.launches = 0
    cuda_assign.launches = 0
    threads = [threading.Thread(target=delegate, args=(d,))
               for d in range(FED_DELEGATES)]
    t0 = time.perf_counter()
    try:
        for t in threads:
            t.start()
        while not done.wait(1.0):
            check(time.perf_counter() - t0 < PHASE_LIMIT_S,
                  f"federation: {router.stats()} in {PHASE_LIMIT_S} s")
        for t in threads:
            t.join(timeout=60)
            check(not t.is_alive(), "federation: a delegate hung")
        drive_s = time.perf_counter() - t0
        launches = dict(kb.launches)
        k1, k2 = cuda_grouped.launches, cuda_assign.launches
        check(not errors, f"federation: {errors[:3]}")
        check(not fleet.violations, f"federation: {fleet.violations[:5]}")
        stats = router.stats()
        for c, d in enumerate(cells):
            out = d.inspect()
            check(out["failure"] is None, f"federation: cell {c} failed: "
                                          f"{out['failure']}")
            check(out["grants_outstanding"] == 0,
                  f"federation: cell {c} holds {out['grants_outstanding']} "
                  f"grants after every free")
    finally:
        done.set()
        for d in cells:
            d.stop()

    # Every scored decision against the host oracle.
    t_oracle = time.perf_counter()
    scored = warm_picks = 0
    for cands, keys, res in scorer.calls:
        want = pl.host_reference_placement(cands, keys)
        check(res is not None and want is not None,
              "federation: a scored call without a result")
        for f in ("scores", "best_cell", "best_score"):
            check(np.array_equal(getattr(res, f), getattr(want, f)),
                  f"federation: the scorer's {f} != the host oracle's")
        if int(res.best_score[0]) < pl.BIG:
            scored += 1
            env = keys[0][0].split("/obj/")[0]
            warm_picks += env in warm[cands[int(res.best_cell[0])].cell_id]
    oracle_s = time.perf_counter() - t_oracle
    check(stats["placement_scored"] > 0, "federation: nothing scored")
    check(launches["placement_score"] == len(scorer.calls) == scored
          == stats["placement_scored"],
          f"federation: {launches['placement_score']} kernel launches, "
          f"{len(scorer.calls)} scorer calls, {scored} scored picks, "
          f"{stats['placement_scored']} counted")
    check(stats["placement_failures"] == 0, "federation: scorer failures")
    check(stats["foreign_renewals"] > 0 and stats["foreign_frees"] > 0,
          "federation: no spilled grant was renewed or freed home")
    check(k2 == 0, f"federation: K2 launched {k2} times under the auto "
                   f"policy")
    # The placement stage split: the peer signals and the scorer's call
    # (its pack and its one native call) under the drive's 8 delegates and
    # 8 cells' dispatch threads, then the same scorer calls replayed from
    # one thread with the cells stopped.
    split = router.inspect()["federation"]["latency_breakdown"]
    stage = split["placement"]
    share = place_timing["path"]["ms"] / stage["p50_ms"]
    scorer.stage_timer.reset()
    t_replay = time.perf_counter()
    for cands, keys, _ in scorer.calls[:FED_REPLAY]:
        t0 = time.perf_counter()
        pl.DevicePlacementScorer.score(scorer, cands, keys)
        scorer.stage_timer.record("score", time.perf_counter() - t0)
    replay_s = time.perf_counter() - t_replay
    idle = scorer.stage_timer.percentiles()
    # The same calls beside FED_CELLS threads that spin in Python and call
    # no CUDA: what contention for the interpreter alone costs them.
    stop_spin = threading.Event()

    def spin():
        n = 0
        while not stop_spin.is_set():
            n += 1

    spinners = [threading.Thread(target=spin) for _ in range(FED_CELLS)]
    for t in spinners:
        t.start()
    scorer.stage_timer.reset()
    try:
        for cands, keys, _ in scorer.calls[:FED_SPIN_REPLAY]:
            t0 = time.perf_counter()
            pl.DevicePlacementScorer.score(scorer, cands, keys)
            scorer.stage_timer.record("score", time.perf_counter() - t0)
    finally:
        stop_spin.set()
        for t in spinners:
            t.join()
    spun = scorer.stage_timer.percentiles()
    res = dict(cells=FED_CELLS, slots=FED_SLOTS, build_s=build_s,
               filters_s=filters_s, drive_s=drive_s, oracle_s=oracle_s,
               decisions=scored, warm_picks=warm_picks, stats=stats,
               totals=totals, placement_stage=stage,
               placement_split={k: v for k, v in split.items()
                                if k.startswith("placement")},
               idle_replay=idle, replay_s=replay_s, spin_replay=spun,
               kernel_share_of_p50=share, launches=launches, k1_launches=k1,
               k2_launches=k2)
    report.append(
        f"  federation: {FED_CELLS} cells x {FED_SLOTS} slots built and "
        f"warmed, {FED_CELLS - 1} card-built filters installed, in "
        f"{build_s:.1f} s (filters {filters_s:.1f} s); {scored} scored spill "
        f"decisions ({warm_picks} onto a peer warm for the environment) in "
        f"{drive_s:.2f} s, {totals['grants']} grants ({totals['spilled']} "
        f"spilled) over {totals['calls']} calls, {totals['renewed']} renewed "
        f"and all freed through the router (foreign renewals "
        f"{stats['foreign_renewals']}, frees {stats['foreign_frees']}); "
        f"every pick and score row equal to the host oracle's (checked in "
        f"{oracle_s:.1f} s); no id in two cells; kernel launches "
        f"{launches['placement_score']} = scored decisions; K1 launches "
        f"{k1}, K2 {k2}")
    report.append(
        f"  federation placement stage: p50 {stage['p50_ms']:.4f} ms, p99 "
        f"{stage['p99_ms']:.4f} ms over {stage['count']} decisions; the "
        f"kernel's {place_timing['path']['ms']:.4f} ms (phase 2) is "
        f"{share * 100:.1f}% of the p50")

    def p50_99(d, k):
        return f"{k} {d[k]['p50_ms']:.4f} / {d[k]['p99_ms']:.4f}"

    report.append(
        "  federation placement split under the drive (p50 / p99 ms): "
        + "; ".join(p50_99(split, k) for k in (
            "placement_signals", "placement_score", "placement_pack",
            "placement_call")))
    parts = ("score", "pack", "call")
    report.append(
        f"  the same {min(FED_REPLAY, len(scorer.calls))} scorer calls "
        f"replayed from one thread, the cells stopped, in {replay_s:.2f} s "
        f"(p50 / p99 ms): " + "; ".join(p50_99(idle, k) for k in parts))
    report.append(
        f"  {min(FED_SPIN_REPLAY, len(scorer.calls))} of them beside "
        f"{FED_CELLS} threads spinning in Python (no CUDA call; p50 / p99 "
        f"ms): " + "; ".join(p50_99(spun, k) for k in parts))
    return res


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
    compare_shard_grid(report)
    grid = time_shard_grid(report)
    k2 = compare_assign_batch(report)
    compare_placement(report)
    place = time_placement(report)
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
    compare_bloom_raw(report)
    compare_bloom_layouts(report)
    bloom_timing = compare_bloom_main(report)
    bloom_run = run_bloom_main_path(report)
    log(f"phase 7 the Bloom path ({time.perf_counter() - t7:.1f} s; "
        f"kernels vs plain at tolerance 0):")
    for line in report:
        log(line)

    report = []
    phases["sharded"] = run_main_path(
        "sharded", ["--shards", str(SHARDS)], Fleet(seed=5), report,
        shards=SHARDS, min_grants=SHARDED_MIN_GRANTS)
    overlap = measure_shard_overlap(report)
    fused = run_fused_path(report)
    phases["fused"] = {"launches": {"grouped_assign": fused["launches"],
                                    "assign_batch": fused["k2_launches"]}}
    log("phases 8-9 the sharded scheduler:")
    for line in report:
        log(line)

    report = []
    takeover = run_takeover_path(report)
    phases["takeover"] = {"launches": takeover["launches"]}
    federation = run_federation_path(report, place)
    phases["federation"] = {"launches": {
        "grouped_assign": federation["k1_launches"],
        "assign_batch": federation["k2_launches"]}}
    log("phases 10-11 warm standby and federation:")
    for line in report:
        log(line)

    report = []
    t12 = time.perf_counter()
    run_aio_path(report, phases)
    log(f"phases 12-13 the aio front end ({time.perf_counter() - t12:.1f} "
        f"s):")
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
        "shard_grid": {k: grid[k] for k in
                       ("ms", "bound_ms", "bound_by", "card_bound_ms", "N",
                        "S", "G", "tasks", "one_shard_ms",
                        "eight_in_a_row_ms", "eight_on_eight_streams_ms",
                        "fused_step_ms", "plain_ms")},
        "sharded_overlap": overlap,
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
    for i, kernel in ((2, "membership"), (3, "cascade")):
        record["kernels"][i]["at_hit_rates"] = {
            rate: {k: r[kernel][k] for k in
                   ("ms", "bound_ms", "bound_by", "share_of_bound")}
            for rate, r in bloom_timing["hits"].items()}
    record["kernels"][2]["fused_split_ms"] = {
        str(s["hit_rate"]): {
            k.replace("_seconds", ""): s["device_fused"][k] * 1e3
            for k in ("pack_seconds", "upload_seconds", "kernel_seconds",
                      "end_to_end_seconds")}
        for s in bloom_run["bench"]["sweep"]}
    record["kernels"].append({
        "name": "placement_score",
        "route": "cuda",
        "source": "yadcc_tpu_torch/csrc/bloom.cu",
        "replaces": "yadcc_tpu/parallel/mesh.py:698",
        "launches": federation["launches"]["placement_score"],
        "max_abs_err": 0,
        "ms": place["path"]["ms"],
        "plain_ms": place["path"]["plain_ms"],
        "bound_ms": place["path"]["bound_ms"],
        "bound_by": place["path"]["bound_by"],
        "library_ms": None,
        "shape": {k: place["path"][k] for k in ("C", "N", "T")},
        "launch_floor_ms": place["path"]["launch_floor_ms"],
        "call_ms": place["path"]["call_ms"],
        "native_call_ms": place["path"]["native_call_ms"],
        "at_C8_N256_T8": {k: place["wide"][k] for k in
                          ("ms", "launch_floor_ms", "plain_ms", "call_ms",
                           "native_call_ms", "bound_ms", "bound_by")},
        "placement_stage": federation["placement_stage"],
    })
    log("main paths ({}): {}; fused {} cycles in {:.2f} s; total {:.1f} "
        "s".format(card, "; ".join(
            f"{name} {r['grants_per_s']:.1f} grants/s p99 {r['p99_ms']:.2f} "
            f"ms" for name, r in phases.items() if "p99_ms" in r),
            fused["cycles"], fused["seconds"], time.perf_counter() - t_start))
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
