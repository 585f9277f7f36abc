#!/usr/bin/env python3
"""On-card smoke test of yadcc_tpu_torch: the scheduler's grant path, the
Bloom kernels, the cache server's reader, the daemon (its servant and
delegate halves), the scheduler's scale harnesses and the jit workloads
(nvcc as the farm's compile worker) on CUDA.

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
   servants registered by Heartbeat, 24 delegates driving >= 50,000
   grants with WaitForStartingTask(immediate_reqs=128) and FreeTask;
   every grant checked against the servants' facts, no servant over its
   capacity, no duplicate grant id, and kernel launches > 0 (the entry
   sets its launch counts to 0 after its warmup; the script reads 0 from
   /inspect/vars just before driving and the phase's counts just after);
4. main path, synchronous: phase 3 with --dispatch-pipeline-depth 0;
5. the scan policy: phase 4's drive with --dispatch-policy torch_batched,
   every grant through K2 (launches of 256 tasks, one collect a cycle);
6. the device-resident stream: phase 3's drive with --dispatch-policy
   torch_resident_grouped to >= 100,000 grants (the statics oracle runs
   every 64 resident launches), K1 inside the resident step, the
   resident pool's statics oracle clean;
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
   stream of its own), >= 50,000 grants, phase 3's checks plus: every
   grant id routes to the shard that issued it and is freed there; then
   the same scheduler built in process and driven without RPC under
   torch.profiler: how many K1 launches overlap, the card's busy share;
9. the fused control plane, in process: a ShardRouter of 8 shards x
   8,192 slots, 40,000 servants, two tenants with budgets, delegate
   threads ruled by admission and granted through >= 400 fused cycles
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
   it runs, every held grant renews once, >= 50,000 more grants go
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
   phase 4's synchronous drive on it (>= 50,000 grants: the inline
   leader runs each cycle on the event loop, one request deep, so K1's
   launches there are reported, not required), with the loop's lag; then a
   parked burst on the pipelined entry: 2,000 AsyncAioChannel delegates
   on one client loop each park one wait on an env whose slots are all
   held, 1,500 answered with one grant each once the slots are freed,
   500 with NO_QUOTA at their deadline, the entry's RSS and threads read
   before the burst and with every wait parked; each beside its
   threaded twin of the same call;
13. the sharded scheduler on aio: phase 8's drive through --rpc-frontend
   aio --accept-loops 4 --shards 4 (>= 50,000 grants), phase 8's checks;
   then on the same entry a hot delegate asks for more grants than its
   home shard's whole capacity: the router's asynchronous steal must pull
   grants from the other shards (stolen > 0 in the reply and in
   task_dispatcher.steal), every grant valid and freed;
14. the cache server and the daemon's cache reader: two port cache
   entries on loopback over one shared L3 root (--l3-engine objstore),
   each with its own disk L2; region B on --rpc-frontend aio takes 2,000
   fills, and once its L3 write-backs have drained region A (threaded,
   --l1-capacity 4M) boots and takes 3,000, each through the port's
   DistributedCacheWriter under the servant token from 16 threads (keys
   of the daemon's shapes, 80 and 88 bytes, two tenants; values 1-16 KiB
   log-uniform); a user token's PutEntry is refused; a port
   DistributedCacheReader on the card full-fetches both filters from A;
   batch_may_contain on 1M keys at 1%, 10% and 50% hits (drawn from A's
   keys and the bucket's listing) through the cascade kernel and, on a
   second reader with use_device_cascade=False, the membership kernel,
   every verdict equal to the host replicas' region OR fleet, no key held
   by A or listed in the bucket False, the launch counts up by one a key
   length class (two with the membership kernel); hits read back with
   the bytes written; L3-only keys NOT_FOUND first, then a hit once A's
   background promotion lands; one more L3-only key's bucket object made
   a FIFO, so its promotion's GET blocks until the script writes: its
   TryGetEntry answers NOT_FOUND before and while that GET is held, and
   the promotion lands the bytes once released (the reply path never
   waits on the bucket); 1,000 more fills arrive by an incremental
   sync and read True on the card; A restarted on its dirs: the next sync
   is a full fetch whose filter holds every key of A's L2;
15. the daemon, both halves: the scheduler entry with its defaults and
   phase 3's 5,000 synthetic servants, one port cache entry (threaded,
   disk L2), and port daemon entries running both roles as processes
   (python -m yadcc_tpu_torch.daemon.entry: a servant on --serving-port
   and a delegate on --local-port; --extra-compiler-dirs at the host
   g++'s directory; non-dedicated, so int(0.40 x nprocs) slots each;
   --ignore-cgroup-limits, --no-privilege-drop, --allow-poor-machine at
   <= 16 cores, --temporary-dir in the run's directory always: every
   servant boot empties its temporary root of ytpu_* directories, so a
   shared /dev/shm would take another checkout's live workspaces); a
   build of 24 TUs (files that include the repo's
   native/client/ytpu-cxx.cc or ytpu-testtool.cc and add one function
   of their own drawn from the seed; flags -O2, -O0 -g or -O2 -g; 8
   compiled twice at once; 4 ending in #error) by the port's client
   (yadcc_tpu_torch/client/yadcc_cxx.py), one process a TU behind a
   wrapper named g++ in a farm directory first on PATH, 32 at once as
   make -j32 runs them: each preprocesses under the delegate's quota,
   submits, long-polls, sends an answer without a compile again up to 5
   tries and compiles locally where its own rules say so (an #error
   TU's preprocessing fails with this g++, so it is compiled locally):
   the first 12 through two threaded daemons, which then leave
   gracefully, the other 12 through two aio daemons (their quota and
   wait long polls parked on the loop; a delegate dials every servant
   with its fleet's one scheme); then the cached rebuild of all 24
   through one aio delegate once its reader has synced past the last
   fill.  Every grant on a real servant (the delegates dial what they
   are granted), none over the capacity the heartbeats report, running
   tasks reported during each build and none after it, no grant
   outstanding after either fleet left, K1 launched over the builds
   (counts read from /inspect/vars just before and just after); no
   client compiled locally after the cloud ladder or for an unreachable
   daemon (counted from each client's own log lines), every other local
   compile counted; the delegates' actually_run + reused + hit_cache +
   failed, plus the answers without a grant, equal to the clients'
   submissions, failed 0, and each delegate's grant wait, queue and
   output wait (p50/p99) printed; every client run's exit code, stdout
   and stderr equal to a local compile's (the client's own log lines
   aside); every answer a servant or the cache gave an ok TU's runs
   (kept by the wrapper before the client patches it) byte-equal to a
   local compile of the bytes the client preprocessed, run as the
   servant ran it (a -g object in that servant's own workspace path),
   each run's object equal to its answer once patched to the client's
   directory, and each cache entry one of the build's answers; the
   cache's fills equal to the successful compiles the servants ran; in
   the rebuild every ok TU a cache hit and grants taken only for #error
   TUs that reach a servant; the first client's imports hold no torch,
   jax, numpy or JAX package; no libtorch mapped in any daemon, no
   double reply on the aio ones (servant RPC and local HTTP), every
   daemon exiting 0 on SIGTERM; the local HTTP's connections and loop
   lag and each daemon's most threads printed;
16. the scale harnesses (yadcc_tpu_torch/tools/trace_replay.py and
   pod_sim.py), in process: (a) a trace of 6,000 tasks over 128 servants
   (seed 0, batches of 64, 16 envs; BASELINE configs[1]) replayed through
   greedy_cpu, torch_batched (K2), torch_grouped (K1) and auto, every
   policy's grants equal to greedy_cpu's batch by batch, and the
   pipelined stream (K1's stream wrapper) at depth 16 pick for pick
   equal to depth 0; (b) the same at 5,000 servants; (c) pod_sim with
   5,000 servants of capacities uniform 4-16, auto, 30 ms compiles, 2
   servants churned a second and 30% duplicate TUs through the
   in-process RPC grant path for 20,000 tasks (configs[4] has 100,000):
   every task a hit, a join or a run, no grant id issued twice, the
   client's grants equal to the scheduler's; once synchronous (depth 0:
   auto's cycles below its measured crossover on the host, K1 for each
   one above it) and once at pipeline depth 16 (the entry's default on
   the card), where every K1 launch of the run goes through its stream
   wrapper, the two arms' tasks/s, assignments/s, grant-call p50/p99,
   latency breakdowns, auto's routes and launches printed side by side; (d) pod_sim's own gates:
   smoke_device (the fused grid of 4 shards, 20 lock-step cycles, every
   shard's picks against greedy_assign_reference) and smoke (4 shards, a
   zipf:1.5 hotspot: the steal engages, the load summary on the card);
   K1 and K2 launched in (a)-(b), K1 in (c)'s depth-16 arm and in
   smoke_device, no Bloom kernel in the phase;
17. the jit, AOT and autotune workloads, on phase 15's two aio daemons
   before they leave (their servants' worker runs nvcc for the card:
   --jit-backends auto found it), through the port's jit clients with
   YTPU_JIT_LOCAL_FALLBACK=0 (an artifact not from the farm fails the
   phase): (a) csrc/grouped_assign.cu, assign_batch.cu and bloom.cu
   through build_library with empty options, each source's nvcc seconds
   and peak child RSS on the servant beside phase 1's local builds, and
   K1 launched through the farm's grouped_assign library (loaded
   RTLD_LOCAL beside the local one) on phase 2's seeded pools at S =
   8,192 and its edge pools: counts, picks and running equal to the
   plain version and the local library at tolerance 0, the refusals
   kept; (c) a source ending in #error smoke: exit 1, not retried, its
   line in the raised diagnostics; (d) AOT of grouped_assign.cu over
   (1,) sm_90a, (1,) sm_90, (2,2) sm_90a and (8,) sm_80 (each
   topology's compile options name its arch): four artifacts with
   verdict ok, each one's target read back with cuobjdump --list-elf,
   the (1,) sm_90a one running K1 on the seeded pools; (e) a .cu
   template with {BLOCK} and {ITEMS} swept over 4 configs at width 4
   (8 until phase 22), children on both servants, the winner evaluated
   4 and in the space;
   (f) a 1 MiB jit_cache_put through one delegate; once every fill has
   landed and both readers synced past it: (b) the three sources again
   from the other delegate, hit_cache 3, no servant run, artifacts
   byte-equal to (a)'s; (e') the same sweep from the other delegate
   served from the sweep cache with no child run; (f') the shim read
   back byte-equal through it; (d') the AOT resubmitted with a fifth
   topology: 4 cached, 1 ok; K1 launched in the scheduler over the
   phase, the per-kind stats, the daemons' RSS printed and no libtorch
   mapped; every grant freed (0 outstanding once the fleet left);
18. lock-order tracing and the cluster sweep, in process: (a) the
   scheduler as the entry builds it with its defaults (auto, pipelined,
   on the card), 5,000 servants, 24 delegate threads for 5 s, once
   untraced and once built and driven inside locktrace.installed(): no
   lock-order cycle through a lock of the port, the graph not saturated,
   K1 launched, every grant freed, grants/s printed beside the untraced
   drive's; (b) yadcc_tpu_torch/tools/cluster_sim.run's cxx sweep, 200
   TUs (300 until phase 21; 2,000, the tool's default, takes ~2
   minutes: its grant wait is 1-2 s once 32 submissions share the 16
   slots) on 4 servants of 4
   slots, 20% duplicates, torch_grouped on the card; (c) its jit sweep of
   60 modules (100 until phase 22, 200 until phase 19) through the fake
   worker: no
   failure, every submission a
   hit, a join or a run, every unique source run, K1 launched, no grant
   outstanding in the scheduler at the end, (c) deduped;
19. the hostile-world scenarios and the native client, in process
   (yadcc_tpu_torch/tools/scenarios.py at full size, torch_grouped on the
   card): (a) overload-ladder (16 storm threads x 6 tasks against 4
   slots: the admission ladder reaches REJECT and walks back to NORMAL,
   no flapping, REJECT p99 <= 250 ms), (b) cell-kill (two federated
   cells, a warm standby on cell 0 killed mid-spike: spillover before
   any local-only verdict, the promoted standby's dispatcher
   torch_grouped on the card and granting, failover within one 3 s
   keep-alive, no grant issued twice, every straddling lease renewed;
   at its smoke size, 8 storm threads x 6 tasks: its full size fails
   its own bound in both packages, see HOSTILE_CARD; as the rig stops,
   PROMOTED_DRIVE requests for cell 0's own servants through the
   promoted standby, at least one granted there: a storm spilled to
   its end leaves the standby at SPILLOVER with nothing of its own),
   (c) spill-affinity (three cells, scored placement through the
   placement kernel against the least-loaded baseline: >= 1.3x the
   baseline's post-spill hit rate, placement_score_p99_us printed);
   every scenario's own SLO checks pass, K1 launches in each, the
   placement kernel in (c); (d) tools/install_client.py builds the port's
   native client (yadcc_tpu_torch/native/, the frames of this host's
   daemon) into yadcc_tpu_torch/_build/native/ and installs a farm whose
   g++ links to it, then 8 TUs of phase 15's corpus at -O2 go through
   that g++ against the port's LocalCluster (torch_grouped on the card):
   every object byte-equal to a local compile, K1 granting the slots, no
   grant left; the same TUs through the Python client's farm, and the
   CPU seconds a TU of both clients' process trees printed;
20. the static analyzer, the proto builder and the torch-free host path,
   in one subprocess with torch and jax blocked (sys.modules[...] =
   None), started before phase 18 and joined after phase 19: the port's
   analyzer over yadcc_tpu_torch/ (--no-cache --stats
   --strict-suppressions: no unsuppressed finding, each family's ms
   printed), `python -m yadcc_tpu_torch.api.build_protos --check` (every
   pure-built module byte-identical), and cell-kill at its smoke size on
   greedy_cpu (its SLO checks pass, the standby promoted, no double
   run); the phase fails on any finding, any drift, or torch or jax in
   the subprocess's modules;
21. the scenario canaries on the card, in one subprocess started before
   phase 15 and joined after it (their time is mostly their rigs'
   sleeps and deadlines, phase 15's its g++ processes and long polls):
   quick_hostile_metrics (overload-ladder, flaky-servant and cell-kill
   at their smoke sizes), quick_spill_affinity_metrics,
   quick_coldregion_metrics and
   quick_tenancy_metrics (noisy-neighbor and cache-poisoning) from
   yadcc_tpu_torch/tools/scenarios.py with device="cuda" (policy auto):
   every value a finite number, every rate within [0, 1], the tenancy
   isolation bit 1, the placement kernel launched in spill-affinity;
   each canary's values and K1, K2 and placement launches printed;
22. the team (yadcc_tpu_torch/parallel/mesh.py), in process, on
   TEAM_SLICES slices over min(4, count) cards, cycled (on one card all
   four on it: the team's code and exchange, the cross-card case not
   exercised): (a) the exchange alone (TEAM_ROUNDS rounds, each slice
   ending on the word the rounds predict; its round trip a round), K1's
   team mode at S=8,192 with G=64 and G=8 and its stream over two chained
   launches with an adjustment and a reset, K2's at T=256, on phase 2's
   timing pool: bit-equal to the plain team versions and the
   single-pool kernels, timed beside them (CUDA events, 50 warm
   launches); K1 and K2 told of a fifth slice that never launches run
   out of their bounded wait, set the error word and the wrappers
   raise; (b) torch_sharded_grouped serving configs[4]'s fleet through
   pod_sim at pipeline depth 16 for TEAM_POD_TASKS tasks with 16c's
   gates (every task a hit, a join or a run; no id twice; client grants
   = scheduler grants; the team's K1 launches counted at the wrapper
   from after the build, one a card a stream call; no stream resync),
   then torch_sharded synchronous for TEAM_SCAN_TASKS, K2's team
   launches above 0; (c) the filter-sharded membership and cascade on
   phase 7's batches (1M keys of 80 bytes, 27,584,639 bits, 10 hashes,
   1/10/50% hits): bit-equal to the host filters and the one-card
   kernels, each slice's range kernels to their plain versions, timed
   beside the one-card kernels; DeviceBloomCascade(team=...) and the
   membership's team entry with their launches counted.

Each kernel's plain version is timed with one call (timed_once) beside
its comparison; the kernel itself with CUDA events over many calls.

The second-to-last line is the kernels' JSON record, the last line
{"ok": true, "device": {...}}.  Logs of the scheduler, cache and servant
processes go to smoke_logs/; phase 14's directories live in smoke_cache/
and phase 15's in smoke_servant/ while they run.
"""

from __future__ import annotations

import base64
import collections
import contextlib
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
MIN_GRANTS = 50_000            # 200,000, then 100,000 (PR 20), then this
#                                to pay for phase 18
PHASE_LIMIT_S = 240.0
HB_INTERVAL_MS = 4000          # servant lease = 10x this
HB_REPEAT_S = 10.0             # re-beat well inside the lease
MAIN_S, MAIN_G, MAIN_TASKS = 8192, 64, 2048   # the policy's largest chunk
MAIN_T = 256                   # torch_batched's chunk (max_batch)
SHARDS = 4                     # phase 8's --shards
SHARDED_MIN_GRANTS = 50_000    # 100,000 until phase 18
RESIDENT_MIN_GRANTS = 100_000  # phase 6: its statics oracle runs every
#                                64 resident launches (~90 at 100,000)
OVERLAP_WINDOW_S = 3.0         # phase 8's in-process profile
OVERLAP_WARMUP_S = 1.0         # its drive before the profile starts
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


WALLS: dict = {}   # seconds of each step of main(), in order


def walled(name: str, fn, *args, **kw):
    """fn(*args, **kw), its wall time kept in WALLS[name] and written to
    stderr, so a failed or cut run still shows where its time went."""
    t0 = time.perf_counter()
    try:
        return fn(*args, **kw)
    finally:
        WALLS[name] = round(time.perf_counter() - t0, 1)
        print(f"chip_smoke: {name} {WALLS[name]} s", file=sys.stderr,
              flush=True)


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


def timed_once(fn) -> float:
    """ms of one call of ``fn`` with CUDA events: a plain version's time
    for the kernels' record.  One call, no warm call and no repeats
    (``timed`` makes five): the plain versions are no yardstick, and the
    comparison beside each has already run it on these inputs."""
    import torch

    torch.cuda.synchronize()
    a, b = torch.cuda.Event(True), torch.cuda.Event(True)
    a.record()
    fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b)


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
    plain_ms = timed_once(lambda: asg.assign_grouped(pool, batch))
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
        w = dict(ms=timed(kern, 50), plain_ms=timed_once(plain),
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
        plain_ms=timed_once(lambda: asg.resident_grouped_step(
            ppool, delta, packed, adj, all_reset, run0, t_max)),
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
    plain_ms = timed_once(lambda: asg.resident_control_plane_step(
        ppool, delta, packed, zeros, all_reset, run0, t_max))

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
    plain_ms = timed_once(lambda: asn.assign_batch(pool, batch))
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


# The synthetic servants and delegates of the phases below name ports
# 20000-30399 of 127.0.0.1 as their locations (Fleet, the aio burst, the
# in-process delegates).  A real servant listening on one of them would
# share its entry in the scheduler's table with a synthetic one, each
# heartbeat overwriting the other's, so no real process is given one.
SYNTHETIC_PORTS = range(20000, 31000)


def free_port() -> int:
    while True:
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        if port not in SYNTHETIC_PORTS:
            return port


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


def inspect_vars(port: int, prefix: str = "") -> dict:
    """The process's /inspect/vars, or only the subtree under ``prefix``
    (a path such as ``yadcc/task_dispatcher``)."""
    with urllib.request.urlopen(
            f"http://127.0.0.1:{port}/inspect/vars/{prefix}",
            timeout=10) as r:
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


def register_fleet(dispatcher, fleet: Fleet, tag: str) -> None:
    """Every servant of ``fleet`` registered in process (no RPC)."""
    from yadcc_tpu_torch.scheduler.task_dispatcher import ServantInfo

    for s in fleet.servants:
        check(dispatcher.keep_servant_alive(ServantInfo(
            location=s["location"], version=1,
            num_processors=s["capacity"], dedicated=s["dedicated"],
            capacity=s["capacity"], total_memory=64 << 30,
            memory_available=32 << 30,
            env_digests=tuple(sorted(s["envs"]))), 600.0),
            f"{tag}: a servant was refused")


class InProcessDrive:
    """N_DELEGATES threads calling a dispatcher (or a shard router)
    directly, without RPC: each asks for IMMEDIATE grants on its envs in
    turn and frees what it got at once.  ``grants`` counts what they
    were granted."""

    def __init__(self, dispatcher, fleet: Fleet, tag: str, seed: int):
        self.d, self.tag = dispatcher, tag
        self.stop = threading.Event()
        self.lock = threading.Lock()
        self.errors: list = []
        self.grants = 0
        self.threads = [
            threading.Thread(target=self._delegate, daemon=True,
                             args=(d, random.Random(seed + d), fleet))
            for d in range(N_DELEGATES)]

    def _delegate(self, d: int, rng, fleet: Fleet) -> None:
        envs = rng.sample(fleet.envs, ENVS_PER_DELEGATE)
        who = f"127.0.0.1:{30000 + d}"
        k = 0
        try:
            while not self.stop.is_set():
                got = self.d.wait_for_starting_new_task(
                    envs[k % len(envs)], requestor=who,
                    immediate=IMMEDIATE, timeout_s=0.5)
                k += 1
                with self.lock:
                    self.grants += len(got)
                if got:
                    self.d.free_task([g for g, _ in got])
        except Exception as e:  # reported by join()
            self.errors.append(f"delegate {d}: {e!r}")

    def start(self) -> None:
        for t in self.threads:
            t.start()

    def join(self) -> None:
        self.stop.set()
        for t in self.threads:
            t.join(timeout=30)
            check(not t.is_alive(), f"{self.tag}: a delegate hung")
        check(not self.errors, f"{self.tag}: {self.errors[:3]}")
        check(self.d.failure is None, f"{self.tag}: {self.d.failure!r}")


def preload_profiler_imports() -> threading.Thread:
    """torch.profiler's first start imports torch._inductor (its
    prepare_trace asks ``hasattr(torch, "_inductor")``): ~9 s of host time
    on the card's host, ~26 s inside phase 8's probe, where 24 delegate
    threads contend for the GIL.  Import it on a thread of its own while
    phase 3's entry boots instead (this process only polls the entry
    then; phase 2's host work would contend with it); main() joins it
    before the probe."""
    def load():
        import torch._inductor  # noqa: F401

    t = threading.Thread(target=load, name="profiler-imports", daemon=True)
    t.start()
    return t


def device_spans(prof) -> list:
    """(name, start_us, end_us) of every device event of a finished
    torch.profiler window, read from its raw kineto results: building
    the profile's function-event tree (``prof.events()``) for a window
    of thousands of launches costs seconds of host time and the probe
    needs only the device intervals."""
    from torch.autograd import DeviceType

    return [(e.name(), e.start_ns() / 1e3, e.end_ns() / 1e3)
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA]


def measure_shard_overlap(report: list) -> dict:
    """Phase 8's scheduler built in process (the entry's build_dispatcher
    with --shards 4 and its other defaults: four pipelined shard
    policies, each on its own CUDA stream), 5,000 servants, 24 delegate
    threads calling the router directly (no RPC front end), profiled
    with torch.profiler for OVERLAP_WINDOW_S: how many K1 launches ran
    at the same time as another, and the card's busy share of the
    window.  Reports "not measured" when the profiler returns no device
    events.  Each stage's seconds (build, register, warm-up, window,
    the profile's exit, reading its device events, join, stop) go to
    ``stages``."""
    from torch.profiler import ProfilerActivity, profile

    from yadcc_tpu_torch.scheduler import entry

    stages = {}
    t = time.perf_counter()

    def stage(name):
        nonlocal t
        now = time.perf_counter()
        stages[name] = round(now - t, 3)
        t = now

    args = entry.build_arg_parser().parse_args(["--shards", str(SHARDS)])
    router = entry.build_dispatcher(args)
    stage("build")
    fleet = Fleet(seed=6)
    drive = InProcessDrive(router, fleet, "overlap", 2000)
    try:
        register_fleet(router, fleet, "overlap")
        stage("register")
        drive.start()
        time.sleep(OVERLAP_WARMUP_S)
        stage("warmup")
        prof = profile(activities=[ProfilerActivity.CUDA])
        prof.start()
        g0, t0 = drive.grants, time.perf_counter()
        time.sleep(OVERLAP_WINDOW_S)
        window_s = time.perf_counter() - t0
        granted = drive.grants - g0
        stage("window")
        prof.stop()
        stage("profile_exit")
        drive.join()
        stage("join")
    finally:
        drive.stop.set()
        router.stop()
    stage("stop")
    device = device_spans(prof)
    stage("events")
    k1 = [(s, e) for name, s, e in device if "grouped_assign_kernel" in name]
    res = dict(window_s=window_s, grants=granted, k1_launches=len(k1),
               stages=stages)
    split = ", ".join(f"{k} {v:.2f}" for k, v in stages.items())
    if not k1:
        report.append(f"  overlap: {granted} grants in {window_s:.2f} s; "
                      f"the profiler returned {len(device)} device events, "
                      f"no K1 kernel: overlap not measured; stages (s): "
                      f"{split}")
        return res
    k1_union, k1_sum, k1_overlapping = interval_stats(k1)
    busy, _, _ = interval_stats([(s, e) for _, s, e in device])
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
        f"{res['device_busy_share'] * 100:.1f}% of the window; stages "
        f"(s): {split}")
    return res


# ---------------------------------------------------------------------------
# Phase 9: the fused control plane, in process.
# ---------------------------------------------------------------------------

FUSED_SHARDS = 8
FUSED_SLOTS = 8192
FUSED_SERVANTS = 40_000
FUSED_CYCLES = 400             # 1,000 until the smoke outgrew 1,200 s
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
    for >= FUSED_CYCLES cycles.  The router steals nothing here, so each grant is
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
            "plain_ms": timed_once(lambda: bpl.membership_plain(
                words, packed, length, seed, nb, k)),
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
            "plain_ms": timed_once(lambda: bpl.cascade_plain(
                *cas_args, nb, k, FLEET_HASHES)),
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
            "plain_ms": timed_once(lambda: bpr.probe_body(words, fps, nb,
                                                          k)),
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
            "plain_ms": timed_once(lambda: bpr.scatter_add_plain(
                empty, mfps, nb, k)),
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
        # For phase 22c: the batch, the host's verdicts and the bounds.
        BLOOM_STASH.setdefault("batches", {})[rate] = dict(
            length=length, packed=packed_np, want=want, want_c=want_c,
            membership_bound={k: mem[k] for k in ("bound_ms", "bound_by")},
            cascade_bound={k: cas[k] for k in ("bound_ms", "bound_by")})
        if ri == 0:
            BLOOM_STASH["keys"] = (rate, keys)
        del packed
    BLOOM_STASH.update(region=region, fleet=fleet)
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
        plain_ms = timed_once(lambda: bpl.placement_score_plain(
            *args, device=dev, **kw))
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
TAKEOVER_POST_GRANTS = 50_000     # through the promoted standby
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


def start_entry(name: str, port: int, iport: int, extra: list,
                repo: pathlib.Path = REPO):
    """The scheduler entry of the checkout at ``repo`` as a process on
    loopback, its log in smoke_logs/entry_<name>.log."""
    LOG_DIR.mkdir(parents=True, exist_ok=True)
    log_file = open(LOG_DIR / f"entry_{name}.log", "w")
    cmd = [sys.executable, "-m", "yadcc_tpu_torch.scheduler.entry",
           "--port", str(port), "--inspect-port", str(iport),
           "--acceptable-user-tokens", "utok",
           "--acceptable-servant-tokens", "stok", *extra]
    proc = subprocess.Popen(cmd, cwd=repo, env=dict(
        os.environ, PYTHONPATH=str(repo)), stdout=log_file,
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
AIO_SYNC_MIN_GRANTS = 50_000   # phase 12's synchronous part (100,000
#                                until phase 18)


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


def run_parked_burst(report: list, repo: pathlib.Path = REPO) -> dict:
    """Phase 12's burst on a pipelined aio entry (the checkout at
    ``repo``'s; chip_ab.sh --burst runs other checkouts' entries under
    this rig): every slot of two envs
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
    proc = start_entry(name, port, iport, ["--rpc-frontend", "aio"], repo)
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
            # A reply may carry fewer grants than asked when a servant's
            # first heartbeat is still staged in the pipelined dispatcher
            # (12 of 16 once on the card): ask again for the rest.
            held[env] = []
            deadline = time.monotonic() + 30.0
            while len(held[env]) < n and time.monotonic() < deadline:
                try:
                    resp, _ = ch.call(SERVICE_NAME, "WaitForStartingTask",
                                      ask(env, n - len(held[env]), 5000),
                                      sch.WaitForStartingTaskResponse,
                                      timeout=30)
                except RpcError as e:
                    check(e.status == sch.SCHEDULER_STATUS_NO_QUOTA_AVAILABLE,
                          f"{name}: {e!r}")
                    continue
                held[env] += [g.task_grant_id for g in resp.grants]
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
            # The dispatcher's vars alone: the whole dump runs every
            # producer of the entry on its GIL, beside the loop that
            # parks the burst.
            parked = inspect_vars(iport, "yadcc/task_dispatcher")["yadcc"][
                "task_dispatcher"]["pending_requests"]
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
        connections = inspect_vars(iport, "yadcc/rpc_server")["yadcc"][
            "rpc_server"]["connections"]
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
    re-heartbeats with the grants it runs, and keep their held grants
    alive from the promotion on; then every held grant renews exactly once, the delegates drive >=
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
    gap_on = threading.Event()  # the kill-time grants kept alive too
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
    gap_renewals: list = []     # held grants renewed, per gap keep-alive

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
            """The delegates' keep-alive of the grants they hold: the
            first grants always, each renewal checked; from the promotion
            to the check after the re-beat the kill-time grants too, and
            then a refusal is counted, not failed: the standby knows only
            the journaled grants until their servants' reports land, and
            drops a servant whose replayed lease lapses before its
            report (its grants adopted again off that report)."""
            fo = Failover(pa, ps, killed, stats, lock)
            try:
                while not done.wait(TAKEOVER_RENEW_S):
                    if not renew_on.is_set():
                        continue
                    with fleet.lock:
                        ids = [g for g, _ in early_held]
                        gap_ids = ([g for g, _ in kill_held]
                                   if gap_on.is_set() else [])
                    if not ids + gap_ids:
                        continue
                    resp, _ = fo.call("KeepTaskAlive",
                                      sch.KeepTaskAliveRequest(
                                          token="utok",
                                          task_grant_ids=ids + gap_ids,
                                          next_keep_alive_in_ms=15000),
                                      sch.KeepTaskAliveResponse)
                    if gap_ids:
                        with lock:
                            gap_renewals.append(sum(resp.statuses))
                    elif renew_on.is_set() and not all(resp.statuses):
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
        # The delegates keep their grants alive on the standby from now
        # on, as a delegate's keep-alive does whatever the fleet is
        # doing: the takeover gives journaled grants a 15 s lease, which
        # a slow host's re-beat can outlast.
        gap_on.set()
        renew_on.set()

        # After it: the fleet's re-heartbeat lands (the journal gap's
        # grants adopted off the reports), then every held grant renews
        # exactly once, then the kill-time grants are freed.
        rebeat_thread.join(timeout=120)
        check(not rebeat_thread.is_alive(), "takeover: the re-beat hung")
        check(not errors, f"takeover: {errors[:3]}")
        rebeat_s = time.time() - sv["standby"]["promoted_at"]
        gap_on.clear()
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
        gap_keep_alives=len(gap_renewals),
        gap_held_renewed=list(gap_renewals),
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
        f"0.1 s) each renewed once, kept alive meanwhile by "
        f"{len(gap_renewals)} keep-alives (held grants the standby knew "
        f"at each: {gap_renewals}); adopted {adopted_now} in all "
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


# ---------------------------------------------------------------------------
# Phase 14: the cache server and the daemon's cache reader on the card.
# ---------------------------------------------------------------------------

CACHE_SEED = 14
CACHE_B_PUTS = 2_000           # region B (aio), drained into L3 first
CACHE_A_PUTS = 3_000           # region A (threaded); 20,000 and B's
                               # 5,000 took the smoke past 1,200 s on a
                               # slow host; 5,000 until phase 18
CACHE_A_L1 = "4M"              # A's --l1-capacity: most hits are L2 hits
                               # (26M held a quarter of 20,000 fills)
CACHE_MORE_PUTS = 1_000        # into A before the incremental sync
CACHE_PUT_THREADS = 16         # the fixed pool of writer threads
CACHE_BATCH = 1_000_000        # keys a batch_may_contain call
CACHE_TENANTS = ("tenant-a", "tenant-b")
CACHE_READS = 2_000            # TryGetEntry timed on hit and on miss
CACHE_L3_ONLY = 50             # keys read through A's L3 promotion
CACHE_PROMOTE_WAIT_S = 10.0    # bound on a promotion's landing
CACHE_DIR = REPO / "smoke_cache"


def cache_fill_keys(n: int, seed: int) -> list:
    """n keys as the daemon makes them, a third each: the plain
    ``ytpu-cxx2-entry-`` + 64 hex (80 bytes) and its tenant-scoped form
    ``ytpu-t-<16>-<64>`` (88 bytes) for each of two tenants."""
    from yadcc_tpu_torch.tenancy.keys import tenant_scoped_key

    rng = random.Random(seed)
    out = []
    for i in range(n):
        plain = f"ytpu-cxx2-entry-{rng.getrandbits(256):064x}"
        out.append(plain if i % 3 == 0 else tenant_scoped_key(
            f"secret-{CACHE_TENANTS[i % 3 - 1]}", plain))
    return out


def cache_miss_keys(n: int, seed: int) -> list:
    """n absent keys of the same shapes and tenants (random hex in place
    of the MAC), made in bulk."""
    import numpy as np

    prefixes = ["ytpu-cxx2-entry-"] + [
        k[:24] for k in cache_fill_keys(3, seed)[1:3]]
    hexes = np.random.default_rng(seed).bytes(32 * n).hex()
    return [prefixes[i % 3] + hexes[64 * i:64 * i + 64] for i in range(n)]


class CacheValues:
    """Values of 1-16 KiB, log-uniform, from a seed: slices of one random
    pool, so a key's bytes can be checked after the round trip."""

    def __init__(self, seed: int):
        rng = random.Random(seed)
        self._rng = rng
        self._pool = rng.randbytes(1 << 20)
        self._of = {}

    def add(self, keys) -> None:
        for k in keys:
            size = int(2 ** self._rng.uniform(10, 14))
            self._of[k] = (self._rng.randrange(len(self._pool) - size), size)

    def __getitem__(self, key: str) -> bytes:
        off, size = self._of[key]
        return self._pool[off:off + size]


def start_cache_entry(name: str, port: int, iport: int, extra: list):
    """The port's cache entry as a process on loopback, its log in
    smoke_logs/cache_<name>.log."""
    LOG_DIR.mkdir(parents=True, exist_ok=True)
    log_file = open(LOG_DIR / f"cache_{name}.log", "a")
    cmd = [sys.executable, "-m", "yadcc_tpu_torch.cache.entry",
           "--port", str(port), "--inspect-port", str(iport),
           "--acceptable-user-tokens", "utok",
           "--acceptable-servant-tokens", "stok", *extra]
    proc = subprocess.Popen(cmd, cwd=REPO, env=dict(
        os.environ, PYTHONPATH=str(REPO)), stdout=log_file,
        stderr=subprocess.STDOUT)
    proc.log_file = log_file
    return proc


def wait_cache_ready(name: str, proc, uri: str) -> float:
    """Poll TryGetEntry until the entry answers NOT_FOUND; the boot time."""
    from yadcc_tpu_torch import api
    from yadcc_tpu_torch.rpc import Channel, RpcError

    chan = Channel(uri)
    t0 = time.perf_counter()
    deadline = time.monotonic() + 120
    try:
        while True:
            check(proc.poll() is None,
                  f"cache {name} exited at boot (rc {proc.returncode})")
            try:
                chan.call("ytpu.CacheService", "TryGetEntry",
                          api.cache.TryGetEntryRequest(token="utok",
                                                       key="ytpu-boot"),
                          api.cache.TryGetEntryResponse, timeout=2.0)
            except RpcError as e:
                if e.status == api.cache.CACHE_STATUS_NOT_FOUND:
                    return time.perf_counter() - t0
            check(time.monotonic() < deadline, f"cache {name}: boot timed out")
            time.sleep(0.1)
    finally:
        chan.close()


def cache_fill(uri: str, keys, values: CacheValues) -> dict:
    """PutEntry of ``keys`` under the servant token through the port's
    DistributedCacheWriter (its synchronous write, the body async_write
    runs on a thread a fill), from a fixed pool of threads, one writer
    each; per-call latency on the host clock."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from yadcc_tpu_torch.daemon.cloud.distributed_cache_writer import \
        DistributedCacheWriter

    def run(part):
        w = DistributedCacheWriter(uri, lambda: "stok")
        lat = []
        try:
            for k in part:
                t0 = time.perf_counter()
                w._write(k, values[k])
                lat.append(time.perf_counter() - t0)
        finally:
            w._chan().close()
        return lat

    parts = [keys[i::CACHE_PUT_THREADS] for i in range(CACHE_PUT_THREADS)]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(CACHE_PUT_THREADS) as ex:
        lat = np.concatenate([np.asarray(x) for x in ex.map(run, parts)])
    wall = time.perf_counter() - t0
    return {"puts": len(keys), "puts_per_s": len(keys) / wall,
            "p50_ms": float(np.percentile(lat, 50)) * 1e3,
            "p99_ms": float(np.percentile(lat, 99)) * 1e3}


def cache_drained(iport: int, fills: int) -> dict:
    """Wait until the entry has taken ``fills`` fills and no L3 promotion
    or write-back is in flight; its cache counters."""
    deadline = time.monotonic() + 60
    while True:
        c = inspect_vars(iport)["yadcc"]["cache"]
        if c["fills"] >= fills and c["l3"]["inflight"] == 0:
            return c
        check(time.monotonic() < deadline,
              f"L3 write-backs did not drain: {c['fills']} fills, "
              f"{c['l3']['inflight']} in flight")
        time.sleep(0.1)


def l3_listing(root: pathlib.Path) -> list:
    """Every key the shared bucket holds (object names are url-quoted
    keys; temporaries are skipped, as the engine's listing does)."""
    import urllib.parse

    return [urllib.parse.unquote(p.name) for p in root.iterdir()
            if p.is_file() and not p.name.startswith(".tmp.")]


class FetchRecorder:
    """The reader's channel, recording each filter fetch: method, ms on
    the host clock, full or incremental, attachment bytes, key count."""

    def __init__(self, chan):
        self.chan = chan
        self.fetches = []

    def call(self, service, method, request, response_cls, **kw):
        t0 = time.perf_counter()
        resp, att = self.chan.call(service, method, request, response_cls,
                                   **kw)
        if method.startswith("Fetch"):
            self.fetches.append({
                "method": method, "ms": (time.perf_counter() - t0) * 1e3,
                "incremental": bool(resp.incremental), "bytes": len(att),
                "keys": len(resp.newly_populated_keys)})
        return resp, att

    def close(self):
        self.chan.close()


def cache_reader(uri: str, **kw):
    """A port DistributedCacheReader on the card whose fetches are
    recorded (its sync thread is not started: sync_once is called)."""
    from yadcc_tpu_torch.daemon.local.distributed_cache_reader import \
        DistributedCacheReader
    from yadcc_tpu_torch.rpc import Channel

    r = DistributedCacheReader(uri, "utok", device="cuda", **kw)
    r._channel = FetchRecorder(Channel(uri))
    return r


def sync_recorded(reader) -> dict:
    """One sync_once; {method: the fetch it made}."""
    rec = reader._channel
    n = len(rec.fetches)
    reader.sync_once()
    return {f["method"]: f for f in rec.fetches[n:]}


def reader_batch(reader, keys, launched: dict) -> tuple:
    """Phase 14's main path: one batch_may_contain on the card, with the
    Bloom launch counts set to 0 just before and read just after (added
    to ``launched``); (verdicts, seconds on the host clock, launches)."""
    from yadcc_tpu_torch.ops import cuda_bloom as kb

    for name in kb.launches:
        kb.launches[name] = 0
    t0 = time.perf_counter()
    got = reader.batch_may_contain(keys)
    s = time.perf_counter() - t0
    now = {k: kb.launches[k] for k in ("membership", "cascade")}
    for k, v in now.items():
        launched[k] += v
    return got, s, now


def host_verdicts(reader, keys):
    """The reader's host replicas on ``keys``: region OR fleet."""
    return (reader._filter.may_contain_batch(keys)
            | reader._fleet_filter.may_contain_batch(keys))


def check_reader_batch(reader, keys, want, held, tag: str,
                       launched: dict) -> dict:
    """The reader's verdicts on ``keys`` against ``want``, its host
    replicas' (tolerance 0), no False for a key in ``held``, and the
    kernel launched once a length class (twice with the membership
    kernel: a call a filter)."""
    import numpy as np

    got, s, now = reader_batch(reader, keys, launched)
    check(np.array_equal(got, want), f"{tag}: verdicts != host region|fleet "
          f"({int((got != want).sum())} differ)")
    missed = [k for k, v in zip(keys, got) if not v and k in held]
    check(not missed, f"{tag}: {len(missed)} held keys read False "
          f"(first {missed[:1]})")
    classes = len({len(k) for k in keys})       # ASCII: bytes = chars
    if reader._use_device_cascade:
        expect = {"membership": 0, "cascade": classes}
    else:
        expect = {"membership": 2 * classes, "cascade": 0}
    check(now == expect, f"{tag}: launches {now}, expected {expect}")
    return {"seconds": s, "positive_rate": float(got.mean()),
            "launches": now}


def batch_split(reader, keys) -> dict:
    """The split of a batch like phase 7's fused one: the host pack, the
    upload (both filters' words and the packed keys, synchronised) and
    the kernel (CUDA events), summed over the batch's length classes."""
    import torch

    from yadcc_tpu_torch.ops import bloom_pipeline as bpl
    from yadcc_tpu_torch.ops import cuda_bloom as kb

    dev = torch.device("cuda")
    region, fleet = reader._filter, reader._fleet_filter
    t0 = time.perf_counter()
    buckets = bpl.pack_key_buckets(keys)
    pack = time.perf_counter() - t0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rw = bpl.as_device_words(region.words, dev)
    fw = bpl.as_device_words(fleet.words, dev)
    packed = [(length, bpl.as_device_words(p, dev))
              for length, _, p in buckets]
    torch.cuda.synchronize()
    upload = time.perf_counter() - t0
    rseed, fseed = bpl.seed_pair(region.salt), bpl.seed_pair(fleet.salt)
    kernel = 0.0
    for length, p in packed:
        if reader._use_device_cascade:
            kernel += timed(lambda: kb.bloom_cascade(
                rw, fw, p, length, rseed, fseed, num_bits=region.num_bits,
                num_hashes_region=region.num_hashes,
                num_hashes_fleet=fleet.num_hashes), 20)
        else:
            kernel += sum(timed(lambda f=f, w=w, s=s: kb.bloom_membership(
                w, p, length, s, num_bits=f.num_bits,
                num_hashes=f.num_hashes), 20)
                for f, w, s in ((region, rw, rseed), (fleet, fw, fseed)))
    return {"pack_ms": pack * 1e3, "upload_ms": upload * 1e3,
            "kernel_ms": kernel}


def cache_reads(uri: str, hits, misses) -> dict:
    """TryGetEntry p50/p99 (host clock) on hits and on misses."""
    import numpy as np

    from yadcc_tpu_torch import api
    from yadcc_tpu_torch.rpc import Channel, RpcError

    chan = Channel(uri)
    out = {}
    try:
        for name, keys in (("hit", hits), ("miss", misses)):
            lat = []
            for k in keys:
                t0 = time.perf_counter()
                try:
                    chan.call("ytpu.CacheService", "TryGetEntry",
                              api.cache.TryGetEntryRequest(token="utok",
                                                           key=k),
                              api.cache.TryGetEntryResponse, timeout=10.0)
                    ok = True
                except RpcError as e:
                    check(e.status == api.cache.CACHE_STATUS_NOT_FOUND,
                          f"TryGetEntry: status {e.status}")
                    ok = False
                lat.append(time.perf_counter() - t0)
                check(ok == (name == "hit"), f"TryGetEntry {name}: {k}")
            out[name] = {"p50_ms": float(np.percentile(lat, 50)) * 1e3,
                         "p99_ms": float(np.percentile(lat, 99)) * 1e3,
                         "max_ms": max(lat) * 1e3}
    finally:
        chan.close()
    return out


def reply_beside_a_held_get(uri: str, l3_root: pathlib.Path, key: str,
                            want: bytes, read, token: str = "utok") -> dict:
    """The reply path never waits on the bucket, shown with a GET that
    cannot finish: ``key``'s object in the shared bucket becomes a FIFO,
    so the promotion's read blocks until this function writes into it.
    A TryGetEntry of ``key`` must answer NOT_FOUND before any writer
    exists, and again once the server is seen blocked in that GET (the
    FIFO has a reader); then the object's bytes go through the FIFO, the
    promotion lands ``want`` (``read(key)`` returns bytes or None), and
    the regular object is put back.  Host noise cannot fail this, and a
    reply that waited on the GET, whatever it answered, does."""
    import errno
    import fcntl
    import urllib.parse

    from yadcc_tpu_torch import api
    from yadcc_tpu_torch.rpc import Channel, RpcError

    obj = l3_root / urllib.parse.quote(key, safe="")
    data = obj.read_bytes()
    fifo = obj.with_name(f".fifo.{obj.name}")
    os.mkfifo(fifo)
    os.replace(fifo, obj)
    chan = Channel(uri)
    out = {"reply_ms": []}
    wfd = None

    def not_found_now() -> None:
        t0 = time.perf_counter()
        try:
            chan.call("ytpu.CacheService", "TryGetEntry",
                      api.cache.TryGetEntryRequest(token=token, key=key),
                      api.cache.TryGetEntryResponse, timeout=10.0)
            check(False, f"{key} hit while its bucket GET was held")
        except RpcError as e:
            check(e.status == api.cache.CACHE_STATUS_NOT_FOUND,
                  f"TryGetEntry beside a held GET: status {e.status}")
        out["reply_ms"].append((time.perf_counter() - t0) * 1e3)

    try:
        not_found_now()
        deadline = time.monotonic() + CACHE_PROMOTE_WAIT_S
        while wfd is None:
            try:
                wfd = os.open(obj, os.O_WRONLY | os.O_NONBLOCK)
            except OSError as e:
                if e.errno != errno.ENXIO:   # ENXIO: no reader yet
                    raise
                check(time.monotonic() < deadline,
                      f"no promotion of {key} opened its bucket object")
                time.sleep(0.002)
        not_found_now()
        fcntl.fcntl(wfd, fcntl.F_SETFL,
                    fcntl.fcntl(wfd, fcntl.F_GETFL) & ~os.O_NONBLOCK)
        view = memoryview(data)
        while view:
            view = view[os.write(wfd, view):]
        os.close(wfd)
        wfd = None
        t0 = time.perf_counter()
        deadline = time.monotonic() + CACHE_PROMOTE_WAIT_S
        while (got := read(key)) is None:
            check(time.monotonic() < deadline,
                  f"the held promotion of {key} did not land")
            time.sleep(0.002)
        out["land_ms"] = (time.perf_counter() - t0) * 1e3
        check(bytes(got) == want, f"held promotion of {key}: bytes differ")
    finally:
        if wfd is None:
            try:
                wfd = os.open(obj, os.O_WRONLY | os.O_NONBLOCK)
            except OSError:
                pass        # no GET is held
        if wfd is not None:
            os.close(wfd)   # a held GET reads EOF and gives up
        chan.close()
        tmp = obj.with_name(f".tmp.{obj.name}")
        tmp.write_bytes(data)
        os.replace(tmp, obj)
    return out


def run_cache_path(report: list) -> dict:
    """Phase 14: two regional cache entries of the port over one shared
    L3 root, filled through the servant's writer, read by the daemon's
    reader on the card (see the module docstring)."""
    import shutil

    from yadcc_tpu_torch import api
    from yadcc_tpu_torch.common import compress
    from yadcc_tpu_torch.rpc import Channel, RpcError
    from yadcc_tpu_torch.tools.bloom_bench import HIT_RATES

    shutil.rmtree(CACHE_DIR, ignore_errors=True)
    l3_root = CACHE_DIR / "l3"
    values = CacheValues(CACHE_SEED)
    b_keys = cache_fill_keys(CACHE_B_PUTS, CACHE_SEED + 1)
    a_keys = cache_fill_keys(CACHE_A_PUTS, CACHE_SEED + 2)
    more_keys = cache_fill_keys(CACHE_MORE_PUTS, CACHE_SEED + 3)
    values.add(b_keys + a_keys + more_keys)
    common = ["--cache-engine", "disk", "--l3-engine", "objstore",
              "--l3-root", str(l3_root)]
    b_port, b_iport = free_port(), free_port()
    a_port, a_iport = free_port(), free_port()
    a_args = common + ["--cache-dirs", f"{CACHE_DIR}/a-l2-0,"
                       f"{CACHE_DIR}/a-l2-1", "--l1-capacity", CACHE_A_L1]
    a_uri, b_uri = f"grpc://127.0.0.1:{a_port}", f"aio://127.0.0.1:{b_port}"
    launched = {"membership": 0, "cascade": 0}
    out = {"backend": "zstd" if compress.zstandard is not None else "zlib",
           "stages_s": {}}
    procs = {}
    t_phase = time.perf_counter()

    def stage(name: str) -> None:
        out["stages_s"][name] = time.perf_counter() - t_phase
        log(f"  phase 14: {name} at {out['stages_s'][name]:.1f} s")
    try:
        # Region B on the aio front end: filled, then drained into L3.
        procs["b"] = start_cache_entry("b", b_port, b_iport, common + [
            "--cache-dirs", f"{CACHE_DIR}/b-l2", "--rpc-frontend", "aio"])
        wait_cache_ready("b", procs["b"], b_uri)
        out["fill_b"] = cache_fill(b_uri, b_keys, values)
        b_cache = cache_drained(b_iport, CACHE_B_PUTS)
        stage("B filled and drained")
        check(b_cache["fills"] == CACHE_B_PUTS,
              f"B took {b_cache['fills']} fills of {CACHE_B_PUTS}")
        # Region A (threaded), started after B's write-backs drained: its
        # fleet filter is built from the bucket's listing at boot.
        procs["a"] = start_cache_entry("a", a_port, a_iport, a_args)
        out["boot_a_s"] = wait_cache_ready("a", procs["a"], a_uri)
        reply_max = out["reply_ms_max_after"] = {}

        def note_reply_max(when: str) -> None:
            reply_max[when] = inspect_vars(a_iport)["yadcc"]["cache"][
                "tryget_reply_ms_max"]

        note_reply_max("boot")
        chan = Channel(a_uri)
        try:
            chan.call("ytpu.CacheService", "PutEntry",
                      api.cache.PutEntryRequest(token="utok", key=a_keys[0]),
                      api.cache.PutEntryResponse, attachment=b"evil",
                      timeout=10.0)
            check(False, "a user token's PutEntry was accepted")
        except RpcError as e:
            check(e.status == api.cache.CACHE_STATUS_ACCESS_DENIED,
                  f"user PutEntry: status {e.status}, not ACCESS_DENIED")
        finally:
            chan.close()
        out["fill_a"] = cache_fill(a_uri, a_keys, values)
        a_cache = cache_drained(a_iport, CACHE_A_PUTS)
        stage("A filled and drained")
        check(a_cache["fills"] == CACHE_A_PUTS,
              f"A took {a_cache['fills']} fills of {CACHE_A_PUTS}")
        listed = set(l3_listing(l3_root))
        a_held = set(a_keys)
        l3_only = sorted(listed - a_held)
        check(len(l3_only) > CACHE_L3_ONLY,
              f"only {len(l3_only)} L3 keys A does not hold")
        out["l3"] = {"listed": len(listed), "a_shed": a_cache["l3"]["shed"],
                     "b_shed": b_cache["l3"]["shed"],
                     "a_writebacks": a_cache["l3"]["writebacks"],
                     "b_writebacks": b_cache["l3"]["writebacks"],
                     "a_dedup": a_cache["l3"]["writeback_dedup"]}

        # The reader on the card: a full fetch of both filters.
        reader = cache_reader(a_uri)
        full = sync_recorded(reader)
        check(set(full) == {"FetchBloomFilter", "FetchFleetBloomFilter"}
              and not any(f["incremental"] for f in full.values()),
              f"first sync not a full fetch of both filters: {full}")
        out["full_fetch"] = full
        plain = cache_reader(a_uri, use_device_cascade=False)
        sync_recorded(plain)
        check(plain._filter.to_bytes() == reader._filter.to_bytes()
              and plain._fleet_filter.to_bytes()
              == reader._fleet_filter.to_bytes(),
              "two readers synced in turn hold different filters")
        held = a_held | listed
        pool = sorted(held)
        out["batches"] = {}
        for ri, rate in enumerate(HIT_RATES):
            rng = random.Random(CACHE_SEED + 10 + ri)
            n_hits = int(CACHE_BATCH * rate)
            keys = ([pool[rng.randrange(len(pool))] for _ in range(n_hits)]
                    + cache_miss_keys(CACHE_BATCH - n_hits,
                                      CACHE_SEED + 20 + ri))
            rng.shuffle(keys)
            want = host_verdicts(reader, keys)
            row = {}
            for name, r in (("cascade", reader), ("membership", plain)):
                res = check_reader_batch(r, keys, want, held,
                                         f"{name} at {rate:.0%}", launched)
                res.update(batch_split(r, keys))
                row[name] = res
            out["batches"][str(rate)] = row
            del keys
            stage(f"batches at {rate:.0%}")

        # Reads: predicted hits of A (bytes as written), the latencies on
        # hit and on miss, and L3-only keys through A's promotion.
        rng = random.Random(CACHE_SEED + 30)
        sample = rng.sample(a_keys, 200)
        check(bool(reader.batch_may_contain(sample).all()),
              "a sample of A's keys predicted absent")
        note_reply_max("fill")
        for k in sample:
            got = reader.try_read(k)
            check(got is not None and bytes(got) == values[k],
                  f"try_read({k}) != the bytes written")
        note_reply_max("try_read")
        out["reads"] = cache_reads(
            a_uri, rng.sample(a_keys, CACHE_READS),
            cache_miss_keys(CACHE_READS, CACHE_SEED + 31))
        note_reply_max("hits and misses")
        promote = []
        promoted = rng.sample(l3_only, CACHE_L3_ONLY)
        for k in promoted:
            t0 = time.perf_counter()
            check(reader.try_read(k) is None,
                  f"L3-only key {k} hit before its promotion")
            deadline = time.monotonic() + CACHE_PROMOTE_WAIT_S
            while (got := reader.try_read(k)) is None:
                check(time.monotonic() < deadline,
                      f"L3 promotion of {k} did not land")
                time.sleep(0.002)
            promote.append(time.perf_counter() - t0)
            check(bytes(got) == values[k], f"promoted {k}: bytes differ")
        held_key = min(set(l3_only) - set(promoted))
        out["held_get"] = reply_beside_a_held_get(
            a_uri, l3_root, held_key, values[held_key], reader.try_read)
        # A promotion serves from L1 before its pool thread has finished
        # the L2 write and counted it: read the counters once it has.
        a_cache = cache_drained(a_iport, CACHE_A_PUTS)
        note_reply_max("promotions")
        stage("reads")
        promote.sort()
        out["promotion_ms"] = {
            "p50": promote[len(promote) // 2] * 1e3,
            "max": promote[-1] * 1e3}
        out["tryget_reply_ms_max"] = a_cache["tryget_reply_ms_max"]
        out["a_counts"] = {k: a_cache[k] for k in ("l2_hits", "fills")}
        out["a_counts"]["l3_hits"] = a_cache["l3"]["hits"]
        # The reply path never waits on the bucket: every L3-only key's
        # first read was NOT_FOUND, and a key whose bucket GET was held
        # open answered NOT_FOUND beside it (above).  The worst reply of
        # these stages is reported, not held to a time: host noise on a
        # hit alone has set it above the slowest promotion (a bucket GET
        # on a local directory, a few ms).  The counter is a maximum
        # since the entry started.
        read_max = max(reply_max[s] for s in
                       ("try_read", "hits and misses", "promotions"))
        out["reply_ms_max_in_reads"] = (
            read_max if read_max > reply_max["fill"] else None)
        check(a_cache["l2_hits"] > 0, "no L2 hit promoted into A's L1")
        check(a_cache["l3"]["hits"] >= CACHE_L3_ONLY,
              f"{a_cache['l3']['hits']} L3 promotions")

        # Incremental sync: 1,000 more fills; the next sync carries them
        # as a key list ORed into the replicas, and they read True.
        out["fill_more"] = cache_fill(a_uri, more_keys, values)
        cache_drained(a_iport, CACHE_A_PUTS + CACHE_MORE_PUTS)
        # The reader asks for a full fetch within a second of its last one
        # (it sends whole seconds, and 0 means "no filter held").
        time.sleep(max(0.0, 1.1 - (time.monotonic()
                                   - reader._last_full_fetch)))
        inc = sync_recorded(reader)
        region = inc["FetchBloomFilter"]
        check(region["incremental"] and region["keys"] >= CACHE_MORE_PUTS,
              f"the sync after {CACHE_MORE_PUTS} fills: {region}")
        out["incremental_fetch"] = inc
        got, _, now = reader_batch(reader, more_keys, launched)
        check(bool(got.all()), f"{int((~got).sum())} incrementally synced "
              f"keys read False")
        check(now["cascade"] > 0, "incremental check: no cascade launch")
        a_held |= set(more_keys)
        out["rss_kb"] = {name: proc_status(p.pid)["VmRSS"]
                         for name, p in procs.items()}

        stage("incremental sync")
        # Restart A on the same dirs: the next sync is a full fetch whose
        # filter holds every key of A's L2.
        stopped = procs.pop("a")
        stop_entry(stopped)
        check(stopped.returncode == 0,
              f"A exited {stopped.returncode} on SIGTERM")
        procs["a"] = start_cache_entry("a", a_port, a_iport, a_args)
        out["restart_boot_s"] = wait_cache_ready("a", procs["a"], a_uri)
        restarted = sync_recorded(reader)
        region = restarted["FetchBloomFilter"]
        check(not region["incremental"],
              f"the sync after A's restart was incremental: {region}")
        out["restart_fetch"] = restarted
        manifest = (CACHE_DIR / "a-l2-0" / "keys.manifest").read_text()
        l2_keys = [line.partition(" ")[2] for line in manifest.splitlines()]
        check(len(l2_keys) >= len(a_held),
              f"A's L2 manifest holds {len(l2_keys)} keys")
        check(bool(reader._filter.may_contain_batch(l2_keys).all()),
              "the filter after the restart misses a key of A's L2")
        keys = (random.Random(CACHE_SEED + 40).choices(
                    pool, k=CACHE_BATCH // 10)
                + cache_miss_keys(CACHE_BATCH - CACHE_BATCH // 10,
                                  CACHE_SEED + 41))
        out["restart_batch"] = check_reader_batch(
            reader, keys, host_verdicts(reader, keys), held,
            "cascade after the restart", launched)
        for r in (reader, plain):
            r._channel.close()
        stage("restart")
    finally:
        for p in procs.values():
            stop_entry(p)
        shutil.rmtree(CACHE_DIR, ignore_errors=True)
    out["launches"] = launched
    cache_report(report, out)
    return out


def cache_report(report: list, out: dict) -> None:
    for name in ("fill_b", "fill_a", "fill_more"):
        f = out[name]
        report.append(f"  {name}: {f['puts']:,} puts at "
                      f"{f['puts_per_s']:,.1f}/s, PutEntry p50 "
                      f"{f['p50_ms']:.3f} ms p99 {f['p99_ms']:.3f} ms "
                      f"({CACHE_PUT_THREADS} writer threads)")
    report.append(f"  L3: {out['l3']}")
    for tag in ("full_fetch", "incremental_fetch", "restart_fetch"):
        for method, f in out[tag].items():
            report.append(
                f"  {tag} {method}: {f['ms']:.2f} ms, "
                f"{'incremental' if f['incremental'] else 'full'}, "
                f"{f['bytes']:,} bytes ({out['backend']}), {f['keys']:,} "
                f"keys")
    for rate, row in out["batches"].items():
        for name, r in row.items():
            report.append(
                f"  batch_may_contain ({name}) at {float(rate):.0%} hits: "
                f"{r['seconds'] * 1e3:.2f} ms for {CACHE_BATCH:,} keys "
                f"({CACHE_BATCH / r['seconds']:,.0f} keys/s; pack "
                f"{r['pack_ms']:.2f} + upload {r['upload_ms']:.2f} + kernel "
                f"{r['kernel_ms']:.4f} ms); positive "
                f"{r['positive_rate']:.4f}; launches {r['launches']}; "
                f"equal to the host filters")
    rd = out["reads"]
    report.append(
        f"  TryGetEntry on A: hit p50 {rd['hit']['p50_ms']:.3f} / p99 "
        f"{rd['hit']['p99_ms']:.3f} ms, miss p50 {rd['miss']['p50_ms']:.3f}"
        f" / p99 {rd['miss']['p99_ms']:.3f} ms; L3 promotion p50 "
        f"{out['promotion_ms']['p50']:.2f} ms, max "
        f"{out['promotion_ms']['max']:.2f} ms; worst reply "
        f"{out['tryget_reply_ms_max']:.3f} ms (after each stage: "
        f"{out['reply_ms_max_after']}); {out['a_counts']}")
    held = out["held_get"]
    report.append(
        f"  a bucket GET held open: TryGetEntry answered NOT_FOUND in "
        f"{held['reply_ms'][0]:.3f} ms, and {held['reply_ms'][1]:.3f} ms "
        f"with the GET blocked; the promotion landed "
        f"{held['land_ms']:.2f} ms after its release")
    report.append(
        f"  RSS kB {out['rss_kb']}; A boot {out['boot_a_s']:.2f} s, restart "
        f"boot {out['restart_boot_s']:.2f} s; after the restart "
        f"{out['restart_batch']['seconds'] * 1e3:.2f} ms, positive "
        f"{out['restart_batch']['positive_rate']:.4f}; launches "
        f"{out['launches']}")


# ---------------------------------------------------------------------------
# Phase 15: the daemon, both halves.
# ---------------------------------------------------------------------------

SERVANT_SEED = 15
SERVANT_TUS = 24               # translation units of the build (512 took
                               # 331-353 s with the local re-compiles,
                               # past the smoke's time on an 8-core host;
                               # 224 through the port's client 315.0 s,
                               # each client's start and g++ -E on the
                               # same cores; 128 took the whole smoke
                               # past 1,200 s on a slow host; 48 until
                               # phase 18, 32 until phase 21)
SERVANT_JOINED = 8             # compiled twice at once through a delegate
SERVANT_ERRORS = 4             # ending in `#error smoke`
SERVANT_CLIENTS = 32           # compiler wrappers at once, as make -j32
SERVANT_FLEETS = ("threaded", "aio")   # two daemons each, one after the
                                       # other under one scheduler
SERVANT_SOURCES = ("native/client/ytpu-cxx.cc",
                   "native/client/ytpu-testtool.cc")
SERVANT_FLAGS = ("-O2", "-O0 -g", "-O2 -g")
SERVANT_LIMIT_S = 900.0        # bound on a build
SERVANT_DIR = REPO / "smoke_servant"
SERVANT_BUILD = SERVANT_DIR / "build"  # the TUs' sources and objects
SERVANT_FARM = SERVANT_DIR / "farm"    # the wrapper named g++
# Why a client compiled locally, by the words of its own log line.
LOCAL_REASONS = (("falling back locally", "after the cloud ladder"),
                 ("local daemon unreachable", "daemon unreachable"),
                 ("preprocessing failed", "preprocessing failed"),
                 ("tiny TU", "tiny TU"),
                 ("not distributable", "not distributable"),
                 ("YTPU_DEBUGGING_COMPILE_LOCALLY", "forced local"))
FORBIDDEN_LOCAL = ("after the cloud ladder", "daemon unreachable")

# The zstd declarations native/client/ytpu-cxx.cc uses, for a host
# without libzstd's header (the compiles only need the declarations).
ZSTD_STUB = b"""#pragma once
#include <stddef.h>
extern "C" {
typedef struct ZSTD_CCtx_s ZSTD_CCtx;
typedef struct ZSTD_DCtx_s ZSTD_DCtx;
typedef struct { const void *src; size_t size; size_t pos; } ZSTD_inBuffer;
typedef struct { void *dst; size_t size; size_t pos; } ZSTD_outBuffer;
typedef enum { ZSTD_c_compressionLevel = 100 } ZSTD_cParameter;
typedef enum { ZSTD_e_continue = 0, ZSTD_e_flush = 1, ZSTD_e_end = 2 }
    ZSTD_EndDirective;
ZSTD_CCtx *ZSTD_createCCtx(void);
size_t ZSTD_freeCCtx(ZSTD_CCtx *cctx);
size_t ZSTD_CCtx_setParameter(ZSTD_CCtx *cctx, ZSTD_cParameter param,
                              int value);
size_t ZSTD_compressStream2(ZSTD_CCtx *cctx, ZSTD_outBuffer *output,
                            ZSTD_inBuffer *input,
                            ZSTD_EndDirective endOp);
ZSTD_DCtx *ZSTD_createDCtx(void);
size_t ZSTD_freeDCtx(ZSTD_DCtx *dctx);
size_t ZSTD_decompressStream(ZSTD_DCtx *zds, ZSTD_outBuffer *output,
                             ZSTD_inBuffer *input);
unsigned ZSTD_isError(size_t code);
}
"""


def servant_includes(gxx: str) -> list:
    """The flags that find libzstd's header: none where the host has it,
    else ``-I`` a directory holding ZSTD_STUB."""
    probe = subprocess.run([gxx, "-E", "-x", "c++", "-"],
                           input=b"#include <zstd.h>\n",
                           capture_output=True, timeout=60)
    if probe.returncode == 0:
        return []
    stub = SERVANT_DIR / "include"
    stub.mkdir(parents=True, exist_ok=True)
    (stub / "zstd.h").write_bytes(ZSTD_STUB)
    return ["-I", str(stub)]


class ServantTU:
    """One translation unit of the build: a source file that includes a
    source of the repo and adds a function of its own (so every TU has
    its own digest), or a trailing `#error smoke`."""

    def __init__(self, i: int, rng: random.Random, error: bool,
                 joined: bool, includes: list):
        self.i = i
        self.base = rng.choice(SERVANT_SOURCES)
        self.flags = rng.choice(SERVANT_FLAGS)
        self.tail = (f"\nint ytpu_smoke_tu_{i}(int x) {{ return x * "
                     f"{rng.randrange(1, 1 << 20)} + "
                     f"{rng.randrange(1 << 20)}; }}\n").encode()
        if error:
            self.tail += b"#error smoke\n"
        self.error = error
        self.joined = joined
        self.includes = includes
        self.src = SERVANT_BUILD / "src" / f"tu{i}.cc"
        self.invocation = None   # what the client forwards (the cache key)
        self.pre = None          # the bytes the client preprocessed
        self.result = None       # the build's client run
        self.twin = None         # a joined TU's second run
        self.rebuilt = None      # the cached rebuild's run

    def write(self) -> None:
        self.src.write_bytes(f'#include "{REPO / self.base}"\n'.encode()
                             + self.tail)

    def args(self, obj: pathlib.Path) -> list:
        """The compiler's arguments, as a makefile passes them."""
        return [*self.flags.split(), *self.includes, "-c", str(self.src),
                "-o", str(obj)]


def servant_tus(includes: list) -> list:
    rng = random.Random(SERVANT_SEED)
    order = list(range(SERVANT_TUS))
    rng.shuffle(order)
    errors = set(order[:SERVANT_ERRORS])
    joined = set(order[SERVANT_ERRORS:SERVANT_ERRORS + SERVANT_JOINED])
    return [ServantTU(i, rng, i in errors, i in joined, includes)
            for i in range(SERVANT_TUS)]

def start_daemon(name: str, frontend: str, ports: dict, sched_port: int,
                 cache_port: int, gxx_dir: str, temp_dir, nprocs: int):
    """The port's daemon entry as a process on loopback, both roles (the
    servant on ``ports["serve"]``, the delegate's HTTP on
    ``ports["local"]``), its log in smoke_logs/servant_<name>.log.  The
    card's host is a container (--ignore-cgroup-limits), may have few
    cores (--allow-poor-machine) and the script may run as root
    (--no-privilege-drop).  Its workspaces go under ``temp_dir`` in the
    run's directory, never a shared root such as /dev/shm that another
    checkout's servants use.  One token for both roles, as a user's
    daemon has: the scheduler and the cache take it as a servant's and as
    a user's."""
    LOG_DIR.mkdir(parents=True, exist_ok=True)
    log_file = open(LOG_DIR / f"servant_{name}.log", "w")
    cmd = [sys.executable, "-m", "yadcc_tpu_torch.daemon.entry",
           "--scheduler-uri", f"grpc://127.0.0.1:{sched_port}",
           "--cache-server-uri", f"grpc://127.0.0.1:{cache_port}",
           "--token", "stok", "--serving-port", str(ports["serve"]),
           "--local-port", str(ports["local"]),
           "--inspect-port", str(ports["inspect"]),
           "--location", f"127.0.0.1:{ports['serve']}",
           "--extra-compiler-dirs", gxx_dir, "--rpc-frontend", frontend,
           "--ignore-cgroup-limits", "--no-privilege-drop"]
    if nprocs <= 16:
        cmd.append("--allow-poor-machine")
    cmd += ["--temporary-dir", str(temp_dir)]
    proc = subprocess.Popen(cmd, cwd=REPO, env=dict(
        os.environ, PYTHONPATH=str(REPO)), stdout=log_file,
        stderr=subprocess.STDOUT)
    proc.log_file = log_file
    return proc


def percentiles_ms(xs) -> dict:
    xs = sorted(xs)
    if not xs:
        return {"p50": None, "p99": None}
    return {"p50": xs[len(xs) // 2] * 1e3,
            "p99": xs[min(len(xs) - 1, int(len(xs) * 0.99))] * 1e3}


def patch_regions(data: bytes, patches, client_dir: bytes) -> bytes:
    """The client's patch: each region replaced by ``client_dir`` + the
    suffix, NUL-padded to the region's length."""
    buf = bytearray(data)
    for pos, total, suffix in patches:
        repl = client_dir + bytes(suffix)
        check(len(repl) <= total, f"patch of {total} bytes cannot hold "
                                  f"{len(repl)}")
        buf[pos:pos + total] = repl.ljust(total, b"\x00")
    return bytes(buf)


class BuildClient:
    """The compiler wrappers of a build: SERVANT_CLIENTS threads, each
    running one port client process a TU as `make -j32` would
    (yadcc_tpu_torch/client/yadcc_cxx.py behind a wrapper named g++ in a
    farm directory first on PATH, YTPU_WRAPPER_DIR set to it,
    YTPU_DAEMON_PORT to a delegate's --local-port).  The client
    preprocesses under the delegate's quota, submits, long-polls, sends
    an answer without a compile again up to 5 tries and compiles locally
    where its own rules say so; it logs every such decision at DEBUG,
    and those lines (``ytpu-client ...``) are counted here and taken out
    of the stderr that is held against a local compile's.  A joined TU
    runs as two processes at once, the second writing its own object.
    The wrapper runs the client's main() and keeps what the daemon
    answered, before the client patched it, in the file SMOKE_ANSWER
    names: each run's object is then held against a local compile in
    the workspace its own servant used."""

    def __init__(self, gxx_dir: str):
        SERVANT_FARM.mkdir(parents=True, exist_ok=True)
        (SERVANT_BUILD / "answers").mkdir(parents=True, exist_ok=True)
        wrapper = SERVANT_FARM / "g++"
        wrapper.write_text(
            f"#!{sys.executable}\n"
            "import base64, json, os\n"
            "from yadcc_tpu_torch.client import yadcc_cxx\n"
            "patch = yadcc_cxx.apply_path_patches\n"
            "def keep(files, patches, client_dir):\n"
            "    with open(os.environ['SMOKE_ANSWER'], 'w') as f:\n"
            "        json.dump({'o': base64.b64encode(files['.o']).decode(),\n"
            "                   'patches': patches.get('.o', [])}, f)\n"
            "    return patch(files, patches, client_dir)\n"
            "yadcc_cxx.apply_path_patches = keep\n"
            "yadcc_cxx.main()\n")
        wrapper.chmod(0o755)
        self.wrapper = str(wrapper)
        self.env = dict(
            os.environ, PYTHONPATH=str(REPO), YTPU_LOG_LEVEL="DEBUG",
            YTPU_WRAPPER_DIR=str(SERVANT_FARM),
            PATH=os.pathsep.join([str(SERVANT_FARM), gxx_dir,
                                  os.environ.get("PATH", "")]))
        self.lock = threading.Lock()
        self.errors: list = []
        self.seconds: list = []        # a TU's process, start to exit
        self.runs = 0
        self.cloud_runs = 0            # answered by the cloud
        self.submissions = 0
        self.retries = 0               # sent again after a non-compile
        self.no_grant = 0              # of them "no compile capacity"
        self.cloud_errors = 0          # "cloud attempt N failed"
        self.digest_reports = 0
        self.local = collections.Counter()   # local compiles by reason
        self.imports: list = []        # one client's -X importtime lines

    def run(self, jobs: list) -> float:
        """``jobs``: (tu, delegate's local port, attribute of the tu that
        takes the run, object file name, extra environment)."""
        import queue as queue_mod

        q = queue_mod.Queue()
        for job in jobs:
            q.put(job)
        t0 = time.perf_counter()
        threads = [threading.Thread(target=self._worker, args=(q,),
                                    name=f"client-{i}")
                   for i in range(SERVANT_CLIENTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=SERVANT_LIMIT_S)
            check(not t.is_alive(), "build: a client hung")
        check(not self.errors, f"build: {self.errors[:3]}")
        return time.perf_counter() - t0

    def _worker(self, q) -> None:
        import queue as queue_mod

        try:
            while not self.errors:
                try:
                    tu, port, attr, obj_name, extra = q.get_nowait()
                except queue_mod.Empty:
                    return
                setattr(tu, attr, self._one(tu, port, obj_name, extra))
        except Exception as e:  # reported by run()
            self.errors.append(f"{threading.current_thread().name}: {e!r}")

    def _one(self, tu, port: int, obj_name: str, extra: dict) -> dict:
        obj = SERVANT_BUILD / "obj" / obj_name
        answer = SERVANT_BUILD / "answers" / f"{obj_name}.json"
        for f in (obj, answer):
            if f.exists():
                f.unlink()
        env = dict(self.env, YTPU_DAEMON_PORT=str(port),
                   SMOKE_ANSWER=str(answer), **extra)
        t0 = time.perf_counter()
        r = subprocess.run([self.wrapper, *tu.args(obj)], cwd=SERVANT_BUILD,
                           env=env, capture_output=True,
                           timeout=SERVANT_LIMIT_S)
        seconds = time.perf_counter() - t0
        lines = r.stderr.splitlines(keepends=True)
        own = [ln.decode(errors="replace").rstrip() for ln in lines
               if ln.startswith(b"ytpu-client ")]
        imports = [ln.decode().rstrip() for ln in lines
                   if ln.startswith(b"import time:")]
        stderr = b"".join(ln for ln in lines if not ln.startswith(
            (b"ytpu-client ", b"import time:")))
        local = next((reason for key, reason in LOCAL_REASONS
                      if any(key in ln for ln in own)), None)
        retries = sum(ln.endswith("; retrying") for ln in own)
        with self.lock:
            self.runs += 1
            self.seconds.append(seconds)
            self.retries += retries
            self.no_grant += sum("no compile capacity" in ln for ln in own)
            self.cloud_errors += sum("cloud attempt" in ln for ln in own)
            self.digest_reports += sum("reporting compiler digest" in ln
                                       for ln in own)
            if local is None:
                self.cloud_runs += 1
                self.submissions += 1 + retries
            else:
                self.local[local] += 1
            if imports:
                self.imports = imports
        raw, patches = None, None
        if answer.exists():
            kept = json.loads(answer.read_text())
            raw = base64.b64decode(kept["o"])
            patches = [(int(p["position"]), int(p["total_size"]),
                        base64.b64decode(p.get("suffix_to_keep", "")))
                       for p in kept["patches"]]
        return {"rc": r.returncode, "stdout": r.stdout, "stderr": stderr,
                "log": own, "local": local, "seconds": seconds,
                "obj": obj.read_bytes() if obj.exists() else None,
                "raw": raw, "patches": patches}

class ServantMonitor:
    """Each servant's last heartbeat (its capacity, load and running
    count, from its /inspect/vars), printed once a second; no report may
    run more than its capacity.  With ``pids``, each daemon's thread
    count too, the most kept."""

    def __init__(self, iports: dict, pids: dict = None):
        self.iports = iports
        self.pids = pids or {}
        self.stop = threading.Event()
        self.max_running = {name: 0 for name in iports}
        self.max_threads = {name: 0 for name in self.pids}
        self.violations: list = []
        self.thread = threading.Thread(target=self._loop, daemon=True)

    def read(self) -> dict:
        out = {}
        for name, iport in self.iports.items():
            s = inspect_vars(iport)["yadcc"]["daemon"]["servant"]
            out[name] = dict(s["last_heartbeat"], beats=s["heartbeats"],
                             engine_running=s["engine"]["running"])
        return out

    def _loop(self) -> None:
        t0 = time.perf_counter()
        while not self.stop.wait(1.0):
            try:
                now = self.read()
            except OSError as e:
                self.violations.append(f"servant inspect failed: {e!r}")
                return
            for name, pid in self.pids.items():
                try:
                    self.max_threads[name] = max(self.max_threads[name],
                                                 proc_status(pid)["Threads"])
                except OSError:
                    pass
            for name, b in now.items():
                self.max_running[name] = max(self.max_running[name],
                                             b.get("running", 0))
                if b.get("running", 0) > b.get("capacity", 0):
                    self.violations.append(f"{name} reported {b}")
            log("  phase 15 t={:.0f}s: {}".format(
                time.perf_counter() - t0, "; ".join(
                    f"{name} capacity {b.get('capacity')} load "
                    f"{b.get('current_load')} running {b.get('running')}"
                    for name, b in now.items())))


def daemon_names(frontend: str) -> list:
    return [f"{frontend}{k}" for k in range(2)]


def boot_fleet(frontend: str, daemons: dict, procs: dict, siport: int,
               sport: int, cport: int, gxx_dir: str, nprocs: int) -> float:
    """Start the fleet's two daemons and wait until both servants are in
    the scheduler's table, report their capacity, and both delegates
    answer /local/get_version; returns the boot time."""
    import urllib.error

    t0 = time.perf_counter()
    names = daemon_names(frontend)
    for n in names:
        procs[n] = start_daemon(n, frontend, daemons[n], sport, cport,
                                gxx_dir, SERVANT_DIR / f"tmp-{n}", nprocs)
    monitor = ServantMonitor({n: daemons[n]["inspect"] for n in names})
    deadline = time.monotonic() + 120
    while True:
        for n in names:
            check(procs[n].poll() is None,
                  f"daemon {n} exited at boot (rc {procs[n].returncode})")
        td = inspect_vars(siport)["yadcc"]["task_dispatcher"]
        reg = {n: td["servants"].get(daemons[n]["loc"]) for n in names}
        try:
            beats = monitor.read()
            for n in names:
                urllib.request.urlopen(
                    f"http://127.0.0.1:{daemons[n]['local']}"
                    f"/local/get_version", timeout=5).read()
        except (OSError, KeyError, urllib.error.URLError):
            beats = {}   # an inspect or local server not serving yet
        if (all(reg.values()) and len(beats) == 2
                and all(b.get("capacity") for b in beats.values())
                and len(td["servants"]) == N_SERVANTS + 2):
            break
        check(time.monotonic() < deadline,
              f"the {frontend} daemons did not register: {reg}, "
              f"{len(td['servants'])} servants in the table")
        time.sleep(0.2)
    return time.perf_counter() - t0


def delegate_state(daemons: dict, names) -> dict:
    return {n: inspect_vars(daemons[n]["inspect"])["yadcc"]["daemon"]
            for n in names}


def leave(procs: dict, names, siport: int) -> None:
    """SIGTERM each daemon: it leaves the scheduler, returns its grants
    and exits 0; then no grant of it stays outstanding."""
    for n in names:
        procs[n].terminate()
    for n in names:
        check(procs[n].wait(timeout=60) == 0,
              f"daemon {n} exited {procs[n].returncode} on SIGTERM")
    deadline = time.monotonic() + 30
    while True:
        td = inspect_vars(siport)["yadcc"]["task_dispatcher"]
        if td["grants_outstanding"] == 0:
            return
        check(time.monotonic() < deadline,
              f"{td['grants_outstanding']} grants outstanding after "
              f"{', '.join(names)} left")
        time.sleep(0.2)


def run_daemon_path(report: list) -> dict:
    """Phase 15: the port's scheduler on the card with phase 3's 5,000
    synthetic servants, one port cache entry, and port daemons running
    both roles: a build of SERVANT_TUS TUs with the host's g++, one port
    client process a TU behind a wrapper named g++ (32 at once), half
    through two threaded daemons and half through two aio daemons (the
    threaded pair leaves first), then the cached rebuild of all of them
    through one delegate; the clients' outputs held against local
    compiles and the port's cache server (see the module docstring)."""
    import shutil

    from concurrent.futures import ThreadPoolExecutor

    from yadcc_tpu_torch import api
    from yadcc_tpu_torch.client.compiler_args import CompilerArgs
    from yadcc_tpu_torch.client.rewrite_file import rewrite_file
    from yadcc_tpu_torch.client.yadcc_cxx import remote_invocation
    from yadcc_tpu_torch.common import compress
    from yadcc_tpu_torch.common.hashing import digest_bytes, digest_file
    from yadcc_tpu_torch.daemon import cache_format
    from yadcc_tpu_torch.daemon.cloud.cxx_task import (
        _PADDED_WORKSPACE_LEN, find_patch_locations)
    from yadcc_tpu_torch.rpc import Channel, RpcError
    from yadcc_tpu_torch.scheduler.service import SERVICE_NAME

    t_phase = time.perf_counter()
    gxx = shutil.which("g++")
    check(gxx is not None, "phase 15 needs the host's g++")
    gxx_real = os.path.realpath(gxx)
    gxx_digest = digest_file(gxx_real)
    nprocs = os.cpu_count() or 1
    st = os.statvfs("/dev/shm") if os.path.isdir("/dev/shm") else None
    shm = st.f_frsize * st.f_blocks if st else 0
    shutil.rmtree(SERVANT_DIR, ignore_errors=True)
    for d in (SERVANT_BUILD / "src", SERVANT_BUILD / "obj"):
        d.mkdir(parents=True)
    try:
        with open("/proc/sys/net/ipv4/ip_local_port_range") as f:
            port_range = "-".join(f.read().split())
    except OSError:
        port_range = "unknown"
    # The Python client preloads the shim the installer builds beside
    # the native client (phase 19d builds it, after this phase).
    shim = next((REPO / "yadcc_tpu_torch" / "_build" / "native").glob(
        "*/libytpufakeroot.so"), None)
    report.append(
        f"  host: nprocs {nprocs} ({'--allow-poor-machine' if nprocs <= 16 else 'not poor'}), "
        f"/dev/shm {shm / 2**20:,.0f} MiB (not used: workspaces under "
        f"--temporary-dir {SERVANT_DIR}/tmp-<name>); "
        f"g++ {gxx} -> {gxx_real}, digest {gxx_digest[:16]}; "
        f"fakeroot shim {'present' if shim else 'absent'}; "
        f"ephemeral ports {port_range} (none taken from {SYNTHETIC_PORTS.start}-"
        f"{SYNTHETIC_PORTS.stop - 1})")
    includes = servant_includes(gxx)
    tus = servant_tus(includes)
    for tu in tus:
        tu.write()
    ok = [tu for tu in tus if not tu.error]
    report.append(f"  {SERVANT_TUS} TUs, each a file including one of "
                  f"{', '.join(SERVANT_SOURCES)}"
                  f"{' (no zstd.h on this host: ZSTD_STUB declared its API)' if includes else ''}; "
                  f"flags {SERVANT_FLAGS}, {SERVANT_JOINED} joined, "
                  f"{SERVANT_ERRORS} with #error")

    fleet = Fleet(seed=6)
    sport, siport = free_port(), free_port()
    cport, ciport = free_port(), free_port()
    daemons = {}
    for frontend in SERVANT_FLEETS:
        for n in daemon_names(frontend):
            daemons[n] = {"frontend": frontend, "serve": free_port(),
                          "inspect": free_port(), "local": free_port()}
            daemons[n]["loc"] = f"127.0.0.1:{daemons[n]['serve']}"
    procs = {}
    stop = threading.Event()
    threads: list = []
    monitors: list = []
    fleets: dict = {}
    # The daemons' one token is a user's token too (grants, reads).
    tokens = ["--acceptable-user-tokens", "utok,stok"]
    try:
        procs["scheduler"] = start_entry("servant", sport, siport, tokens)
        sched = Channel(f"grpc://127.0.0.1:{sport}")
        boot_s = wait_ready("servant", procs["scheduler"], sched)
        # The first synthetic servant registers alone: slot 0 is what a
        # loopback delegate's address resolves to (self-avoidance), so
        # the real servants stay eligible.
        def beat_all(chan, servants):
            for s in servants:
                chan.call(SERVICE_NAME, "Heartbeat", fleet.heartbeat(api, s),
                          api.scheduler.HeartbeatResponse, timeout=10.0)

        beat_all(sched, fleet.servants[:1])
        regs = [threading.Thread(target=beat_all, args=(Channel(
            f"grpc://127.0.0.1:{sport}"), fleet.servants[1 + i::8]))
            for i in range(8)]
        for t in regs:
            t.start()
        for t in regs:
            t.join()

        def rebeat():
            chan = Channel(f"grpc://127.0.0.1:{sport}")
            while not stop.wait(HB_REPEAT_S):
                beat_all(chan, fleet.servants)

        threads.append(threading.Thread(target=rebeat, daemon=True))
        threads[-1].start()

        cache_dir = SERVANT_DIR / "cache-l2"
        procs["cache"] = start_cache_entry(
            "servant", cport, ciport, ["--cache-engine", "disk",
                                       "--cache-dirs", str(cache_dir),
                                       *tokens])
        cache_uri = f"grpc://127.0.0.1:{cport}"
        wait_cache_ready("servant", procs["cache"], cache_uri)

        # Each object against a local compile of the bytes the client
        # preprocessed, run as cxx_task.prepare runs it; a -g object in
        # the servant's own workspace path (read back at its first patch
        # location: GCC orders debug strings by their hashes, so another
        # directory of that length can permute them).  An #error TU
        # against the plain local compile a build without the client
        # runs.
        local_root = SERVANT_DIR / "local"
        local_root.mkdir()
        client_dir = str(SERVANT_BUILD / "src").encode()

        def local(job):
            tu, k, raw, patches = job
            if raw is None:
                out = subprocess.run(
                    [gxx, *tu.args(local_root / f"{tu.i}.o")],
                    cwd=SERVANT_BUILD, capture_output=True, timeout=300)
                return tu, (out.returncode, out.stdout, out.stderr), None, 0
            if patches:
                pos, total, suffix = patches[0]
                wdir = pathlib.Path(raw[pos:pos + total - len(suffix)]
                                    .decode())
                check(len(str(wdir)) == _PADDED_WORKSPACE_LEN,
                      f"TU {tu.i}: workspace {wdir}")
            else:
                wdir = local_root / f"{tu.i}-{k}"
            wdir.mkdir()
            try:
                (wdir / "src.ii").write_bytes(tu.pre)
                t = time.perf_counter()
                out = subprocess.run(
                    f"{gxx} -x c++-cpp-output {tu.invocation} -c -o "
                    f"{wdir}/output.o {wdir}/src.ii", shell=True, cwd=wdir,
                    capture_output=True, timeout=300)
                s = time.perf_counter() - t
                mine = ((wdir / "output.o").read_bytes()
                        if out.returncode == 0 else None)
            finally:
                shutil.rmtree(wdir, ignore_errors=True)
            check(mine == raw, f"TU {tu.i} ({tu.flags}): the servant's "
                               f"object differs from a local compile")
            if patches:
                check(find_patch_locations(mine, str(wdir).encode())
                      == patches, f"TU {tu.i}: patch locations differ")
            return tu, (out.returncode, out.stdout, out.stderr), mine, s

        state = inspect_vars(siport)["yadcc"]
        before = {k: v["launches"] for k, v in state["kernels"].items()}
        check(not any(before.values()),
              f"launch counts {before} before the build")
        hb_before = state["scheduler_rpc"].get("Heartbeat:handler",
                                               {}).get("count", 0)
        client = BuildClient(os.path.dirname(gxx))
        half = SERVANT_TUS // len(SERVANT_FLEETS)
        t_build = time.perf_counter()
        build_s = 0.0
        for i, frontend in enumerate(SERVANT_FLEETS):
            names = daemon_names(frontend)
            boot = boot_fleet(frontend, daemons, procs, siport, sport, cport,
                              os.path.dirname(gxx), nprocs)
            capacity = {}
            for n, b in ServantMonitor(
                    {n: daemons[n]["inspect"] for n in names}).read().items():
                capacity[n] = b["capacity"]
            want_cap = max(1, int(nprocs * 0.40))
            check(all(c == want_cap for c in capacity.values()),
                  f"{frontend}: capacities {capacity}, not int(0.40 x "
                  f"{nprocs})")
            for n in names:
                comp = inspect_vars(daemons[n]["inspect"])["yadcc"][
                    "daemon"]["servant"]
                check(gxx_digest in comp["compilers"],
                      f"daemon {n} does not advertise the host g++")
            monitor = ServantMonitor({n: daemons[n]["inspect"]
                                      for n in names},
                                     {n: procs[n].pid for n in names})
            monitors.append(monitor)
            monitor.thread.start()
            part = tus[i * half:(i + 1) * half]
            # Clients split over the fleet's two delegates, as a build's
            # wrappers on two machines would be; a joined TU's two
            # processes go to one delegate, one after the other in the
            # queue, so they run at once.  The first client of the build
            # lists its imports (-X importtime).
            jobs = []
            for k, tu in enumerate(part):
                port = daemons[names[k % 2]]["local"]
                extra = ({"PYTHONPROFILEIMPORTTIME": "1"}
                         if i == k == 0 else {})
                jobs.append((tu, port, "result", f"tu{tu.i}.o", extra))
                if tu.joined:
                    jobs.append((tu, port, "twin", f"tu{tu.i}.twin.o", {}))
            try:
                seconds = client.run(jobs)
            except SmokeFailure:
                # What each delegate saw: counters, stages, its keeper.
                for n, st in delegate_state(daemons, names).items():
                    log(f"  {n}: {json.dumps(st['dispatcher'])}")
                raise
            build_s += seconds
            monitor.stop.set()
            monitor.thread.join(timeout=10)
            check(not monitor.violations,
                  f"servant reports: {monitor.violations[:5]}")
            for n in names:
                check(monitor.max_running[n] > 0,
                      f"daemon {n}'s heartbeats never reported a running "
                      f"task")
            deadline = time.monotonic() + 10
            while True:
                beats = monitor.read()
                if all(b["running"] == 0 and b["engine_running"] == 0
                       for b in beats.values()):
                    break
                check(time.monotonic() < deadline,
                      f"servants still report running tasks: {beats}")
                time.sleep(0.2)
            st = delegate_state(daemons, names)
            fleets[frontend] = {
                "tus": len(part), "seconds": seconds, "boot_s": boot,
                "capacity": capacity,
                "max_running": dict(monitor.max_running),
                "max_threads": dict(monitor.max_threads),
                "state": st,
                "rss_kb": {n: proc_status(procs[n].pid)["VmRSS"]
                           for n in names}}
            log(f"  phase 15 {frontend} fleet: {len(part)} TUs in "
                f"{seconds:.2f} s; " + "; ".join(
                    f"{n} stats {s['dispatcher']['stats']}, grant "
                    f"timeouts {s['dispatcher']['grant_timeouts']}, "
                    f"stages {s['dispatcher']['stages']}, local HTTP "
                    f"{s['local_http']}"
                    for n, s in st.items()))
            for n in names:
                with open(f"/proc/{procs[n].pid}/maps") as f:
                    check("libtorch" not in f.read(),
                          f"daemon {n} mapped libtorch")
            if i < len(SERVANT_FLEETS) - 1:
                leave(procs, names, siport)
        build_wall = time.perf_counter() - t_build
        check(client.imports and not any(
            ln.rsplit("|", 1)[-1].strip().split(".")[0] in
            ("torch", "jax", "jaxlib", "yadcc_tpu", "numpy")
            for ln in client.imports),
              f"a client imported torch, jax, numpy or the JAX package "
              f"({len(client.imports)} imports listed)")

        # What each TU's client sent: its preprocessed bytes (the
        # client's own rewrite_file) and forwarded arguments.
        def preprocess(tu) -> None:
            args = CompilerArgs.parse(["g++", *tu.args(
                SERVANT_BUILD / "obj" / f"tu{tu.i}.o")])
            rw = rewrite_file(args, gxx)
            if rw is not None:
                tu.pre = compress.decompress(rw.compressed_source.join())
                tu.invocation = remote_invocation(args, rw.directives_only)

        with ThreadPoolExecutor(nprocs) as ex:
            list(ex.map(preprocess, tus))
        cloud_errors = [tu for tu in tus if tu.error and tu.pre is not None]

        # The cache: every compile the servants ran filled once but for
        # the #error TUs that reached them (a joined TU compiled on both
        # servants fills twice).
        runs = sum(fl["state"][n]["engine"]["tasks_run_ever"]
                   for fl in fleets.values() for n in fl["state"])
        want_fills = runs - len(cloud_errors)
        deadline = time.monotonic() + 60
        while True:
            fills = inspect_vars(ciport)["yadcc"]["cache"]["fills"]
            if fills >= want_fills:
                break
            check(time.monotonic() < deadline,
                  f"the cache took {fills} fills of {want_fills}")
            time.sleep(0.2)
        t_filled = time.monotonic()
        check(fills == want_fills, f"{fills} fills for {want_fills} ok "
                                   f"compiles ({runs} runs)")
        check(len(ok) <= want_fills <= len(ok) + SERVANT_JOINED,
              f"{want_fills} ok compiles for {len(ok)} ok TUs")

        # Every run against its TU: an #error TU fails with the text and
        # writes no object, an ok TU writes one; a joined TU's second
        # run too.
        for tu in tus:
            for tag, r in (("build", tu.result), ("twin", tu.twin)):
                if tag == "twin" and not tu.joined:
                    continue
                check(r is not None, f"TU {tu.i} has no {tag} run")
                if tu.error:
                    check(r["rc"] != 0 and b"#error smoke" in r["stderr"]
                          and r["obj"] is None,
                          f"TU {tu.i}: #error compiled: {r['rc']}")
                else:
                    check(r["rc"] == 0 and r["obj"],
                          f"TU {tu.i} ({tag}) failed: {r['rc']} "
                          f"{r['stderr'][-500:]!r} {r['log'][-3:]}")
            if tu.joined and not tu.error and "-g" not in tu.flags.split():
                check(tu.twin["obj"] == tu.result["obj"],
                      f"TU {tu.i}: the joined runs' objects differ")

        # The rebuild through one delegate, once its reader has synced
        # past the last fill: every ok TU a cache hit, no grant taken but
        # for #error TUs that reach a servant.
        rb = daemon_names(SERVANT_FLEETS[-1])[0]
        deadline = time.monotonic() + 40
        while True:
            t_req = time.monotonic()
            reader = inspect_vars(daemons[rb]["inspect"])["yadcc"]["daemon"][
                "cache_reader"]
            ago = reader["last_sync_s_ago"]
            if ago is not None and ago < t_req - t_filled:
                break
            check(time.monotonic() < deadline,
                  f"{rb}'s reader did not sync past the last fill: {reader}")
            time.sleep(0.5)
        sync_wait_s = time.monotonic() - t_filled
        before_rb = inspect_vars(daemons[rb]["inspect"])["yadcc"]["daemon"][
            "dispatcher"]
        granted_before = inspect_vars(siport)["yadcc"]["task_dispatcher"][
            "stats"]["granted"]
        local_before = sum(client.local.values())
        rebuild_s = client.run([(tu, daemons[rb]["local"], "rebuilt",
                                 f"tu{tu.i}.rebuilt.o", {}) for tu in tus])
        after_rb = delegate_state(daemons, [rb])[rb]
        granted_rb = inspect_vars(siport)["yadcc"]["task_dispatcher"][
            "stats"]["granted"] - granted_before
        delta = {k: after_rb["dispatcher"]["stats"][k]
                 - before_rb["stats"][k] for k in before_rb["stats"]}
        # The grant waits, less those that ended without a grant.
        rb_grants = (after_rb["dispatcher"]["stages"]["grant_wait"]["count"]
                     - before_rb["stages"]["grant_wait"]["count"]
                     - after_rb["dispatcher"]["grant_timeouts"]
                     + before_rb["grant_timeouts"])
        # One client alone, after the rebuild: its wall time beside a
        # bare interpreter's start and the TU's g++ -E, on an idle host.
        solo_tu = ok[0]
        t = time.perf_counter()
        subprocess.run([sys.executable, "-c", "pass"], check=True)
        solo = {"python_s": time.perf_counter() - t}
        t = time.perf_counter()
        subprocess.run([gxx, "-E", "-fdirectives-only",
                        "-fno-working-directory", *solo_tu.includes,
                        str(solo_tu.src)], check=True, cwd=SERVANT_BUILD,
                       stdout=subprocess.DEVNULL)
        solo["preprocess_s"] = time.perf_counter() - t
        solo_run = client._one(solo_tu, daemons[rb]["local"],
                               f"tu{solo_tu.i}.solo.o", {})
        solo["client_s"] = solo_run["seconds"]
        check(solo_run["obj"] == solo_tu.rebuilt["obj"]
              and solo_run["local"] is None,
              f"TU {solo_tu.i}: the lone client's object is not the "
              f"rebuild's")
        check(delta["hit_cache"] == len(ok) and delta["failed"] == 0
              and delta["actually_run"] == len(cloud_errors),
              f"rebuild: {delta}, {len(ok)} ok TUs, {len(cloud_errors)} "
              f"#error TUs sent to the cloud")
        check(rb_grants == len(cloud_errors),
              f"rebuild: {rb_grants} grants taken for {len(cloud_errors)} "
              f"#error TUs sent to the cloud")
        rebuild_local = sum(client.local.values()) - local_before
        for tu in tus:
            r = tu.rebuilt
            if tu.error:
                check(r["rc"] != 0 and b"#error smoke" in r["stderr"],
                      f"rebuild TU {tu.i}: #error compiled")
            else:
                check(r["rc"] == 0 and r["local"] is None and r["obj"] in (
                    tu.result["obj"], (tu.twin or {}).get("obj")),
                      f"rebuild TU {tu.i}: not the build's object")

        # The cache entries: each ok TU's read back under the key of what
        # its client sent, equal to the rebuild's object once patched to
        # the client's directory; no #error TU has one.
        cache = Channel(cache_uri)
        for tu in tus:
            check(tu.error or tu.pre is not None,
                  f"TU {tu.i}: the client's preprocessing failed here")
            if tu.pre is None:
                continue
            key = cache_format.get_cache_key(
                gxx_digest, tu.invocation, digest_bytes(tu.pre))
            try:
                _, value = cache.call(
                    "ytpu.CacheService", "TryGetEntry",
                    api.cache.TryGetEntryRequest(token="utok", key=key),
                    api.cache.TryGetEntryResponse, timeout=10.0)
            except RpcError as e:
                check(tu.error and e.status ==
                      api.cache.CACHE_STATUS_NOT_FOUND,
                      f"TU {tu.i}: TryGetEntry {e}")
                continue
            check(not tu.error, f"TU {tu.i} (#error) has a cache entry")
            entry = cache_format.try_parse_cache_entry(value)
            check(entry is not None, f"TU {tu.i}: the entry does not parse")
            check(set(entry.files) == {".o"} and (
                entry.exit_code, entry.standard_output,
                entry.standard_error) == (0, b"", b""),
                  f"TU {tu.i}: the cache entry holds {sorted(entry.files)}, "
                  f"exit {entry.exit_code}")
            raw = compress.decompress(bytes(entry.files[".o"]))
            patches = entry.patches.get(".o", [])
            check(bool(patches) == ("-g" in tu.flags.split()),
                  f"TU {tu.i} ({tu.flags}): patches {entry.patches}")
            patched = (patch_regions(raw, patches, client_dir) if patches
                       else raw)
            check(tu.rebuilt["obj"] == patched,
                  f"TU {tu.i}: the rebuild's object is not the cache "
                  f"entry's patched to the client's directory")
            check(raw in (tu.result["raw"], (tu.twin or {}).get("raw")),
                  f"TU {tu.i}: the cache entry is no build run's answer")
        cache.close()

        # The aio fleet: its front ends' double replies, then it leaves.
        last = daemon_names(SERVANT_FLEETS[-1])
        for n in last:
            with open(f"/proc/{procs[n].pid}/maps") as f:
                check("libtorch" not in f.read(),
                      f"daemon {n} mapped libtorch")
        final = delegate_state(daemons, last)
        for n in last:
            for front in ("servant_rpc", "local_http"):
                check(final[n][front]["double_replies"] == 0,
                      f"aio daemon {n}: {final[n][front]['double_replies']} "
                      f"double replies on {front}")
            check(final[n]["local_http"]["frontend"] == "aio",
                  f"aio daemon {n}: local HTTP {final[n]['local_http']}")
            fleets[SERVANT_FLEETS[-1]]["state"][n] = final[n]
        state = inspect_vars(siport)["yadcc"]
        launches = {k: v["launches"] - before[k]
                    for k, v in state["kernels"].items()}
        hb_after = state["scheduler_rpc"]["Heartbeat:handler"]["count"]
        # The delegates' grant polls as the scheduler served them: a lap
        # the scheduler cannot fill whole ends at its deadline (1 s).
        polls = state["scheduler_rpc"].get("WaitForStartingTask:handler")
        check(state["task_dispatcher"]["failure"] is None,
              f"dispatcher failed: {state['task_dispatcher']['failure']}")
        # Phase 17 on this fleet before it leaves: its grants are freed
        # by the time leave() reads 0 outstanding.
        jit = run_jit_path(daemons, last, procs, siport,
                           f"grpc://127.0.0.1:{cport}")
        leave(procs, last, siport)
        check(launches["grouped_assign"] > 0,
              "phase 15: K1 never launched over the builds")

        # No silent local compile; the delegates' counters: every
        # submission answered, none failed.
        forbidden = {k: v for k, v in client.local.items()
                     if k in FORBIDDEN_LOCAL}
        check(not forbidden and client.cloud_errors == 0,
              f"clients compiled locally {dict(client.local)}, "
              f"{client.cloud_errors} cloud attempts failed")
        totals = collections.Counter()
        for fl in fleets.values():
            for s in fl["state"].values():
                totals.update(s["dispatcher"]["stats"])
        answered = sum(totals[k] for k in ("actually_run", "reused",
                                           "hit_cache", "failed"))
        timeouts = sum(s["dispatcher"]["grant_timeouts"]
                       for fl in fleets.values()
                       for s in fl["state"].values())
        check(answered + timeouts == client.submissions
              and timeouts == client.no_grant == client.retries
              and totals["shed_to_local"] == 0,
              f"delegates answered {answered} + {timeouts} without a grant "
              f"of {client.submissions} submissions ({client.retries} "
              f"retries, {client.no_grant} seen without a grant): "
              f"{dict(totals)}")
        check(totals["failed"] == 0, f"delegates failed {totals['failed']}")
        # Every run not compiled locally was a TU the cloud answered.
        check(client.cloud_runs + sum(client.local.values()) == client.runs
              and sum(client.local.values())
              == 2 * (SERVANT_ERRORS - len(cloud_errors)) + sum(
                  tu.error and tu.joined for tu in tus),
              f"{client.cloud_runs} cloud runs, local {dict(client.local)} "
              f"of {client.runs} runs")

        # Every run's exit code, stdout and stderr against a local
        # compile's; every answer a servant or the cache gave an ok TU's
        # runs (as the daemon sent it, before the client's patch) against
        # a local compile in its own workspace, and each run's object
        # equal to its answer patched to the client's directory.
        t0 = time.perf_counter()
        jobs = []
        for tu in tus:
            runs_of = [r for r in (tu.result, tu.twin, tu.rebuilt) if r]
            if tu.error:
                jobs.append((tu, 0, None, None))
                continue
            answers = {}
            for r in runs_of:
                check(r["raw"] is not None,
                      f"TU {tu.i}: a run has no answer from the daemon")
                answers.setdefault(r["raw"], r["patches"])
            jobs += [(tu, k, raw, patches)
                     for k, (raw, patches) in enumerate(answers.items())]
        with ThreadPoolExecutor(nprocs) as ex:
            done = list(ex.map(local, jobs))
        local_wall = time.perf_counter() - t0
        local_s = [s for _, _, mine, s in done if mine is not None]
        outcomes = {}
        for tu, outcome, _, _ in done:
            check(outcomes.setdefault(tu.i, outcome) == outcome,
                  f"TU {tu.i}: two local compiles' outcomes differ")
        for tu in tus:
            for r in (tu.result, tu.twin, tu.rebuilt):
                if r is None:
                    continue
                outcome = outcomes[tu.i]
                check((r["rc"], r["stdout"], r["stderr"]) == outcome,
                      f"TU {tu.i}: the client's (exit code, stdout, "
                      f"stderr) {(r['rc'], r['stdout'][-200:], r['stderr'][-200:])} "
                      f"differ from a local compile's "
                      f"{(outcome[0], outcome[1][-200:], outcome[2][-200:])}")
                if not tu.error:
                    check(bool(r["patches"]) == ("-g" in tu.flags.split()),
                          f"TU {tu.i} ({tu.flags}): patches "
                          f"{r['patches']}")
                    check(r["obj"] == (patch_regions(
                        r["raw"], r["patches"], client_dir)
                        if r["patches"] else r["raw"]),
                          f"TU {tu.i} ({tu.flags}): a client's object is "
                          f"not its answer patched to its directory")
    finally:
        stop.set()
        for m in monitors:
            m.stop.set()
        for t in threads:
            t.join(timeout=30)
        for n in [*daemons, "cache", "scheduler"]:
            if n in procs:
                stop_entry(procs[n])
        shutil.rmtree(SERVANT_DIR, ignore_errors=True)

    stages = {n: s["dispatcher"]["stages"] for fl in fleets.values()
              for n, s in fl["state"].items()}
    no_grant = {n: s["dispatcher"]["grant_timeouts"]
                for fl in fleets.values() for n, s in fl["state"].items()}
    by_flags = collections.Counter(tu.flags for tu in ok)
    build_runs = [r for tu in tus for r in (tu.result, tu.twin) if r]
    res = {
        "tus": SERVANT_TUS, "seconds": build_s,
        "compiles_per_s": SERVANT_TUS / build_s,
        "client_ms": percentiles_ms(r["seconds"] for r in build_runs),
        "stages": stages,
        "compile_ms": {n: s["engine"]["run_ms"] for fl in fleets.values()
                       for n, s in fl["state"].items()},
        "local_compile_ms": percentiles_ms(local_s),
        "heartbeats_per_s": (hb_after - hb_before) / build_wall,
        "cache_fills": fills, "runs": runs,
        "jit": jit,
        "rss_kb": {n: v for fl in fleets.values()
                   for n, v in fl["rss_kb"].items()},
        "threads": {n: v for fl in fleets.values()
                    for n, v in fl["max_threads"].items()},
        "local_http": {n: {k: s["local_http"].get(k) for k in
                           ("frontend", "connections", "double_replies",
                            "loop_lag")}
                       for fl in fleets.values()
                       for n, s in fl["state"].items()},
        "fleets": {f: {k: fl[k] for k in ("tus", "seconds", "boot_s",
                                          "capacity", "max_running")}
                   for f, fl in fleets.items()},
        "delegate_stats": dict(totals), "submissions": client.submissions,
        "grant_timeouts": timeouts, "retries": client.retries,
        "digest_reports": client.digest_reports,
        "client_runs": client.runs, "local": dict(client.local),
        "cloud_errors_tus": len(cloud_errors),
        "client_imports": len(client.imports),
        # The self times of every import the first client made (us).
        "client_import_ms": sum(
            int(f) for f in (ln.split("|")[0].split(":")[1].strip()
                             for ln in client.imports) if f.isdigit()) / 1e3,
        "solo": solo,
        "rebuild": {"seconds": rebuild_s,
                    "tus_per_s": SERVANT_TUS / rebuild_s,
                    "sync_wait_s": sync_wait_s, "delta": delta,
                    "grants_taken": rb_grants, "local": rebuild_local,
                    "scheduler_granted": granted_rb},
        "wait_for_starting_task_ms": polls,
        "launches": launches, "boot_s": boot_s, "build_wall_s": build_wall,
        "local_wall_s": local_wall,
        "phase_s": time.perf_counter() - t_phase,
    }

    def pq(d, unit="p50", tail="p99"):
        return f"{d[unit]:.2f} / {d[tail]:.2f}"

    for f, fl in res["fleets"].items():
        report.append(
            f"  {f} fleet: {fl['tus']} TUs in {fl['seconds']:.2f} s = "
            f"{fl['tus'] / fl['seconds']:.2f} compiles/s through 2 "
            f"daemons (both roles; capacity {fl['capacity']}, the most "
            f"running {fl['max_running']}), booted in {fl['boot_s']:.1f} s")
    report.append(
        f"  build: {SERVANT_TUS} TUs ({len(ok)} ok: {dict(by_flags)}) in "
        f"{build_s:.2f} s = {res['compiles_per_s']:.2f} compiles/s from "
        f"{SERVANT_CLIENTS} client processes at once, each a port client "
        f"(python -m yadcc_tpu_torch.client.yadcc_cxx behind a wrapper "
        f"named g++; the wall of both builds {build_wall:.1f} s with the "
        f"boots); {client.runs} client runs in all with the rebuild, "
        f"{client.cloud_runs} answered by the cloud, local compiles "
        f"{dict(client.local)} (the #error TUs: their preprocessing "
        f"fails here, so the client compiles them locally; "
        f"{len(cloud_errors)} reached a servant), none after the cloud "
        f"ladder or for an unreachable daemon; {client.submissions} "
        f"submissions ({client.retries} again after no grant in the "
        f"keeper's 10 s), {client.digest_reports} compiler digests "
        f"reported after a 400; the delegates' actually_run + reused + "
        f"hit_cache + failed = {answered} ({dict(totals)}) + {timeouts} "
        f"answered without a grant; every grant on a real servant, none "
        f"over capacity, none outstanding after either fleet left; every "
        f"run's exit code, stdout and stderr (the client's own "
        f"`ytpu-client` lines aside) equal to a local compile's; the "
        f"first client's {len(client.imports)} imports "
        f"({res['client_import_ms']:.1f} ms) hold no torch, jax, numpy or "
        f"JAX package")
    report.append(
        "  per submission p50 / p99 ms, as each delegate sees it (a grant "
        "wait that ended without a grant included): " + "; ".join(
            f"{n} grant wait {pq(s['grant_wait'], 'p50_ms', 'p99_ms')} "
            f"({s['grant_wait']['count']} waits, {no_grant[n]} without a "
            f"grant), queue {pq(s['queue'], 'p50_ms', 'p99_ms')}, output "
            f"wait {pq(s['output_wait'], 'p50_ms', 'p99_ms')}"
            for n, s in stages.items() if "grant_wait" in s))
    report.append(
        "  grant keepers (fetches / grants / dry laps / flow verdicts): "
        + "; ".join(
            f"{n} " + ", ".join(
                f"{c['fetches']} / {c['grants']} / {c['dry']} / {c['flow']}"
                for c in s["dispatcher"]["grant_keeper"]["fetchers"].values())
            for fl in fleets.values() for n, s in fl["state"].items()))
    report.append(
        "  compile (the engine's run time) " + ", ".join(
            f"{n} {pq(c)} ({c['count']} tasks)"
            for n, c in res["compile_ms"].items())
        + f"; the client process (start to exit, a TU, submit to answer "
          f"included) {pq(res['client_ms'])}; the same compiles locally, "
          f"{nprocs} at once: {pq(res['local_compile_ms'])}")
    report.append(
        "  local HTTP and threads (the most a daemon had during its "
        "build): " + "; ".join(
            f"{n} {h['frontend']}, threads {res['threads'][n]}"
            + (f", connections {h['connections']}, double replies "
               f"{h['double_replies']}, loop lag p50 / p99 / max "
               f"{h['loop_lag']['p50_ms']:.2f} / "
               f"{h['loop_lag']['p99_ms']:.2f} / "
               f"{h['loop_lag']['max_ms']:.2f} ms"
               if h["frontend"] == "aio" else "")
            for n, h in res["local_http"].items()))
    rb_ = res["rebuild"]
    report.append(
        f"  cached rebuild through {rb}: {SERVANT_TUS} client processes in "
        f"{rb_['seconds']:.2f} s = {rb_['tus_per_s']:.2f} TUs/s (each "
        f"preprocesses locally), its reader synced "
        f"{rb_['sync_wait_s']:.1f} s after the last fill; hit_cache "
        f"{rb_['delta']['hit_cache']} (every ok TU), actually_run "
        f"{rb_['delta']['actually_run']}, local compiles {rebuild_local} "
        f"(the #error TUs), grants taken {rb_grants}, the scheduler "
        f"granted {granted_rb} (prefetch included); one client alone "
        f"afterwards {solo['client_s'] * 1e3:.1f} ms (a bare interpreter's "
        f"start {solo['python_s'] * 1e3:.1f} ms, the TU's g++ -E "
        f"{solo['preprocess_s'] * 1e3:.1f} ms)")
    if polls:
        report.append(
            f"  the delegates' WaitForStartingTask laps at the scheduler: "
            f"{polls['count']} polls, handler p50 {polls['p50_ms']:.2f} / "
            f"p99 {polls['p99_ms']:.2f} ms (a lap holds its grants until "
            f"it is filled or its 1 s deadline)")
    report.append(
        f"  scheduler took {res['heartbeats_per_s']:.1f} heartbeats/s "
        f"({N_SERVANTS:,} synthetic servants every {HB_REPEAT_S:.0f} s + 2 "
        f"real every 1 s); cache fills {fills} for {runs} compiles "
        f"(every ok TU's entry read back, parsed and equal to the "
        f"rebuild's object once patched; no #error TU filled); K1 "
        f"launches {launches}; daemons' RSS kB {res['rss_kb']} (no "
        f"libtorch mapped); aio double replies 0 (servant RPC and local "
        f"HTTP)")
    report.append(
        f"  every answer ({len(local_s)} distinct ones: each ok TU's, a "
        f"joined TU's two where its servants' objects differ) byte-equal "
        f"to a local compile of the client's preprocessed bytes in its "
        f"servant's workspace ({nprocs} at once after the builds: "
        f"{local_wall:.1f} s), and every client run's object equal to its "
        f"answer after the client's patch; boot: scheduler "
        f"{boot_s:.1f} s; phase "
        f"{res['phase_s']:.1f} s")
    return res


# ---------------------------------------------------------------------------
# Phase 17: the jit, AOT and autotune workloads on phase 15's last fleet.
# ---------------------------------------------------------------------------

JIT_SOURCES = ("grouped_assign.cu", "assign_batch.cu", "bloom.cu")
JIT_TOPOLOGIES = (((1,), "sm_90a"), ((1,), "sm_90"), ((2, 2), "sm_90a"),
                  ((8,), "sm_80"))
JIT_FIFTH = ((4,), "sm_90a")
JIT_SWEEP = {"BLOCK": (64, 256), "ITEMS": (1, 4)}   # 4 configs: one round
#          at JIT_SWEEP_WIDTH (8 until phase 22, 16 until phase 18)
JIT_SWEEP_WIDTH = 4
JIT_SHIM_BYTES = 1 << 20
JIT_SYNC_LIMIT_S = 45.0       # bound on the fills' landing and a sync
JIT_SWEEP_TEMPLATE = r"""// Autotune template of chip_smoke.py's phase 17: {BLOCK} threads a
// block, {ITEMS} items a thread.
#include <cuda_runtime.h>
#include <stdint.h>

#define BLOCK {BLOCK}
#define ITEMS {ITEMS}

__global__ void __launch_bounds__(BLOCK)
ytpu_sweep_scale(const int32_t* __restrict__ x, int32_t* __restrict__ y,
                 int n) {
  int base = blockIdx.x * BLOCK * ITEMS + threadIdx.x;
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    int j = base + i * BLOCK;
    if (j < n) y[j] = 3 * x[j] + 1;
  }
}

extern "C" int ytpu_sweep_launch(const int32_t* x, int32_t* y, int n,
                                 void* stream) {
  int per = BLOCK * ITEMS;
  int grid = (n + per - 1) / per;
  if (grid > 0)
    ytpu_sweep_scale<<<grid, BLOCK, 0, (cudaStream_t)stream>>>(x, y, n);
  return (int)cudaGetLastError();
}
"""


def farm_k1_compare(lib, tag: str, full: bool = True) -> int:
    """K1 launched through another loaded copy of its library (``lib``,
    built by the farm) on phase 2's seeded pools at the main shape (S =
    8,192, G up to 64) and, with ``full``, its edge pools: counts, picks
    and running equal to the plain version and to the checkout's own
    library at tolerance 0, and the wrapper's refusals unchanged.
    Returns the number of pools."""
    import numpy as np
    import torch

    from yadcc_tpu_torch.ops import assignment as asn
    from yadcc_tpu_torch.ops import assignment_grouped as asg
    from yadcc_tpu_torch.ops import cuda_grouped as kg

    dev = torch.device("cuda")
    rng = np.random.default_rng(2026)
    cases = []
    for g in (1, 8, 64):
        for total in (g, 512, MAIN_TASKS):
            cases.append((f"seeded_G{g}_m{total}", np_pool(rng, MAIN_S),
                          seeded_groups(rng, g, total, MAIN_S)))
    if full:
        cases += edge_cases(rng)
    for name, p, groups in cases:
        pool = asn.pool_from_numpy(*(p[k] for k in asn.PoolArrays._fields),
                                   dev)
        pad = asg.group_pad(len(groups))
        bg = asg.make_grouped_batch(groups, pad, dev)
        t_max = asg.task_pad(max(1, sum(c for *_, c in groups)))
        got = kg.cuda_assign_grouped(pool, bg, lib=lib)
        for ref, want in (("plain", asg.assign_grouped(pool, bg)),
                          ("local", kg.cuda_assign_grouped(pool, bg))):
            check(torch.equal(got[0], want[0]),
                  f"phase 17 {tag}: {name} counts != {ref}")
            check(torch.equal(got[1], want[1]),
                  f"phase 17 {tag}: {name} running != {ref}")
            check(torch.equal(asg.expand_counts(got[0], bg.count, t_max),
                              asg.expand_counts(want[0], bg.count, t_max)),
                  f"phase 17 {tag}: {name} picks != {ref}")
    p = np_pool(rng, MAIN_S)
    pool = asn.pool_from_numpy(*(p[k] for k in asn.PoolArrays._fields), dev)
    bg = asg.make_grouped_batch(seeded_groups(rng, 8, 512, MAIN_S), 8, dev)
    for what, bp in (
            ("non-contiguous running", pool._replace(running=torch.zeros(
                2 * MAIN_S, dtype=torch.int32, device=dev)[::2])),
            ("int64 capacity", pool._replace(capacity=pool.capacity.long()))):
        try:
            kg.cuda_assign_grouped(bp, bg, lib=lib)
        except (TypeError, ValueError):
            continue
        raise SmokeFailure(f"phase 17 {tag}: the wrapper accepted {what}")
    torch.cuda.synchronize()
    return len(cases)


def run_jit_path(daemons: dict, names, procs: dict, siport: int,
                 cache_uri: str) -> dict:
    """Phase 17 (see the module docstring): the jit, AOT and autotune
    workloads through the two aio daemons of phase 15, whose servants'
    worker runs nvcc for the card (--jit-backends auto found it), with
    YTPU_JIT_LOCAL_FALLBACK=0: an artifact that did not come from the
    farm fails the phase.  Returns its numbers and report lines."""
    import ctypes
    import re
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from yadcc_tpu_torch import api
    from yadcc_tpu_torch.client import daemon_call
    from yadcc_tpu_torch.common.hashing import digest_bytes
    from yadcc_tpu_torch.daemon.cache_format import (
        get_aot_cache_key, get_autotune_sweep_key, get_jit_cache_key)
    from yadcc_tpu_torch.daemon.local.http_service import shim_cache_key
    from yadcc_tpu_torch.jit import aot, autotune, fanout, frontend
    from yadcc_tpu_torch.jit.cache_shim import ClusterCompileCache
    from yadcc_tpu_torch.jit.compile_worker import options_json
    from yadcc_tpu_torch.jit.env import find_nvcc, local_jit_environment
    from yadcc_tpu_torch.ops import _build
    from yadcc_tpu_torch.rpc import Channel, RpcError

    t_phase = time.perf_counter()
    lines: list = []
    a, b = names
    env = local_jit_environment()
    check(env.toolchain_version, "phase 17: no nvcc on this machine")

    def daemon(n):
        return inspect_vars(daemons[n]["inspect"])["yadcc"]["daemon"]

    for n in names:
        served = daemon(n)["servant"]["jit_environments"]
        check([e["digest"] for e in served] == [env.digest],
              f"phase 17: daemon {n} serves {served}, not {env}")

    def runs():
        return {n: daemon(n)["engine"]["tasks_run_ever"] for n in names}

    def k1():
        return inspect_vars(siport)["yadcc"]["kernels"]["grouped_assign"][
            "launches"]

    def kinds(n):
        return daemon(n)["dispatcher"]["stats_by_kind"]

    def use(n):
        os.environ["YTPU_DAEMON_PORT"] = str(daemons[n]["local"])

    def nvcc_of(lib):
        m = re.search(r"nvcc (\d+) run\(s\) ([0-9.]+) s, peak child RSS "
                      r"(\d+) kB", lib.output)
        check(m is not None, f"phase 17: no nvcc line in {lib.output!r}")
        return float(m.group(2)), int(m.group(3))

    saved = {k: os.environ.get(k) for k in (
        "YTPU_DAEMON_PORT", "YTPU_JIT_OFFLOAD", "YTPU_JIT_LOCAL_FALLBACK",
        "YTPU_JIT_TIMEOUT_S")}
    os.environ.update(YTPU_JIT_OFFLOAD="1", YTPU_JIT_LOCAL_FALLBACK="0",
                      YTPU_JIT_TIMEOUT_S="300")
    daemon_call.set_daemon_call_handler(None)
    walls = {}
    try:
        sources = {s: _build.source_bytes(s) for s in JIT_SOURCES}
        gsrc = sources["grouped_assign.cu"]
        k1_before, runs0 = k1(), runs()

        # (a) the three sources, one build_library each, at once.
        use(a)
        t0 = time.perf_counter()
        with ThreadPoolExecutor(len(sources)) as ex:
            libs = dict(zip(sources, ex.map(
                lambda s: frontend.build_library(
                    sources[s], name=pathlib.Path(s).stem), sources)))
        walls["a"] = time.perf_counter() - t0
        arts = {}
        nvcc = {}
        for s, lib in libs.items():
            check(lib.remote, f"phase 17: {s} not built by the farm")
            arts[s] = lib.path.read_bytes()
            nvcc[s] = nvcc_of(lib)
        farm = ctypes.CDLL(os.fspath(libs["grouped_assign.cu"]))
        pools = farm_k1_compare(farm, "jit")
        runs_a = runs()
        check(sum(runs_a.values()) - sum(runs0.values()) == len(sources),
              f"phase 17 (a): servants ran {runs0} -> {runs_a}")
        lines.append(
            f"  (a) jit: {', '.join(JIT_SOURCES)} built by the farm with "
            f"empty options in {walls['a']:.2f} s wall; nvcc on the servant "
            + ", ".join(f"{s} {t:.2f} s (peak child RSS {kb:,} kB)"
                        for s, (t, kb) in nvcc.items())
            + " under the worker's 8 GiB address-space limit; phase 1's "
            "local builds "
            + ", ".join(f"{s} {_build.build_seconds.get(s, 0.0):.2f} s"
                        for s in JIT_SOURCES)
            + f"; the farm's grouped_assign library (RTLD_LOCAL beside the "
            f"local one) ran K1 on {pools} pools (phase 2's seeded at S = "
            f"{MAIN_S:,}, G up to {MAIN_G}, and edge pools): counts, picks "
            f"and running equal to the plain version and the local "
            f"library at tolerance 0")

        # (c) a compile error: not retried, raised with its diagnostics.
        runs_c, jit_c = runs(), kinds(a).get("jit", {})
        t0 = time.perf_counter()
        try:
            frontend.build_library(gsrc + b"\n#error smoke\n",
                                   name="error_smoke")
            raise SmokeFailure("phase 17 (c): a source ending in #error "
                               "built")
        except RuntimeError as e:
            msg = str(e)
        walls["c"] = time.perf_counter() - t0
        check("remote jit build failed (exit 1)" in msg
              and "#error smoke" in msg,
              f"phase 17 (c): diagnostics {msg[-400:]!r}")
        check(sum(runs().values()) == sum(runs_c.values()) + 1,
              "phase 17 (c): the failed build was retried or not run")
        jit_c1 = kinds(a)["jit"]
        check(jit_c1["actually_run"] == jit_c.get("actually_run", 0) + 1
              and jit_c1["failed"] == jit_c.get("failed", 0),
              f"phase 17 (c): jit stats {jit_c} -> {jit_c1}")
        err_line = next(ln for ln in msg.splitlines() if "#error" in ln)
        lines.append(f"  (c) a source ending in #error smoke: exit 1, not "
                     f"retried, raised with the servant's diagnostics "
                     f"({err_line.strip()[-100:]!r}) in {walls['c']:.2f} s")

        # (d) AOT across four topologies, each its own target.
        def topology(shape, arch):
            count = int(np.prod(shape))
            return fanout.TopologySpec(
                mesh_shape=tuple(shape), device_count=count,
                compile_options=options_json(arch=arch)).validate()

        topos = [topology(*t) for t in JIT_TOPOLOGIES]
        t0 = time.perf_counter()
        out = aot.submit_aot_build(gsrc, topos)
        walls["d"] = time.perf_counter() - t0
        check(out.ok and out.exit_code == 0
              and [v["status"] for v in out.verdicts] == ["ok"] * 4,
              f"phase 17 (d): {out.exit_code} {out.error[-300:]} "
              f"{out.verdicts}")
        cuobjdump = os.path.join(os.path.dirname(find_nvcc()), "cuobjdump")
        targets = {}
        aot_paths = {}
        for t, (shape, arch) in zip(topos, JIT_TOPOLOGIES):
            data = out.artifact_for(t)
            check(data is not None, f"phase 17 (d): no artifact for {t}")
            path = frontend.BUILD_DIR / f"libaot_{t.tag()}.so"
            path.write_bytes(data)
            aot_paths[t.tag()] = path
            listed = subprocess.run([cuobjdump, "--list-elf", str(path)],
                                    capture_output=True, text=True,
                                    timeout=60).stdout
            targets[t.tag()] = sorted(set(re.findall(r"sm_\d+a?", listed)))
            check(targets[t.tag()] == [arch],
                  f"phase 17 (d): {t.tag()} asked for {arch}, "
                  f"cuobjdump lists {listed!r}")
        aot_lib = ctypes.CDLL(str(aot_paths[topos[0].tag()]))
        aot_pools = farm_k1_compare(aot_lib, "aot (1,) sm_90a", full=False)
        lines.append(
            f"  (d) AOT of grouped_assign.cu over "
            + ", ".join(f"{s} {a_}" for s, a_ in JIT_TOPOLOGIES)
            + f": 4 artifacts, verdicts ok, in {walls['d']:.2f} s; "
            f"cuobjdump --list-elf targets {targets}; the (1,) sm_90a "
            f"artifact ran K1 on {aot_pools} seeded pools equal to the "
            f"plain version")

        # (e) the sweep: 4 configs at width 4 over both servants.
        space = autotune.SearchSpace.of(**JIT_SWEEP)
        configs = [json.loads(c) for c in space.expand()]
        template = JIT_SWEEP_TEMPLATE.encode()
        runs_e = runs()
        t0 = time.perf_counter()
        res = autotune.sweep(template, space, fanout_width=JIT_SWEEP_WIDTH)
        walls["e"] = time.perf_counter() - t0
        check(res.ok and res.exit_code == 0, f"phase 17 (e): {res.error}")
        check(res.winner["evaluated"] == len(configs) == 4
              and res.winning_config in configs
              and [v["status"] for v in res.verdicts] == ["ok"] * 4,
              f"phase 17 (e): {res.winner} {res.verdicts}")
        runs_e1 = runs()
        per_servant = {n: runs_e1[n] - runs_e[n] for n in names}
        check(sum(per_servant.values()) == JIT_SWEEP_WIDTH
              and all(per_servant.values()),
              f"phase 17 (e): children ran {per_servant}")
        lines.append(
            f"  (e) autotune: {len(configs)} configs of a .cu template "
            f"({{BLOCK}} x {{ITEMS}}) at width {JIT_SWEEP_WIDTH}, children "
            f"per servant {per_servant}, in {walls['e']:.2f} s: winner "
            f"{res.winning_config} (score {res.winner['score']:.3f} = "
            f"minus nvcc seconds), evaluated {res.winner['evaluated']}")

        # (f) the shim: a 1 MiB put through the first delegate.
        blob = np.random.default_rng(17).integers(
            0, 256, JIT_SHIM_BYTES, dtype=np.uint8).tobytes()
        ClusterCompileCache().put("chip-smoke-phase17", blob)

        # Every fill landed, then both readers synced past it.
        keys = [get_jit_cache_key(env.digest, b"", digest_bytes(src))
                for src in sources.values()]
        keys += [get_aot_cache_key(env.digest, t.digest(),
                                   digest_bytes(gsrc)) for t in topos]
        keys.append(get_autotune_sweep_key(
            env.digest, fanout.search_space_digest(space.expand()),
            digest_bytes(template)))
        keys.append(shim_cache_key("chip-smoke-phase17"))
        chan = Channel(cache_uri)
        t0 = time.monotonic()
        pending = list(keys)
        while pending:
            try:
                chan.call("ytpu.CacheService", "TryGetEntry",
                          api.cache.TryGetEntryRequest(token="utok",
                                                       key=pending[0]),
                          api.cache.TryGetEntryResponse, timeout=5.0)
                pending.pop(0)
                continue
            except RpcError:
                pass
            check(time.monotonic() - t0 < JIT_SYNC_LIMIT_S,
                  f"phase 17: {len(pending)} fills never landed")
            time.sleep(0.2)
        chan.close()
        t_filled = time.monotonic()
        for n in names:
            while True:
                t_req = time.monotonic()
                ago = daemon(n)["cache_reader"]["last_sync_s_ago"]
                if ago is not None and ago < t_req - t_filled:
                    break
                check(time.monotonic() - t_filled < JIT_SYNC_LIMIT_S,
                      f"phase 17: {n}'s reader did not sync past the fills")
                time.sleep(0.5)
        walls["sync"] = time.monotonic() - t_filled

        # (b) the same three from the other delegate: cache hits.
        use(b)
        runs_b, jit_b = runs(), kinds(b).get("jit", {})
        t0 = time.perf_counter()
        with ThreadPoolExecutor(len(sources)) as ex:
            again = dict(zip(sources, ex.map(
                lambda s: frontend.build_library(
                    sources[s], name=pathlib.Path(s).stem), sources)))
        walls["b"] = time.perf_counter() - t0
        for s, lib in again.items():
            check(lib.remote and lib.path.read_bytes() == arts[s],
                  f"phase 17 (b): {s} not the farm's first artifact")
        jit_b1 = kinds(b)["jit"]
        check(runs() == runs_b and jit_b1["hit_cache"]
              - jit_b.get("hit_cache", 0) == len(sources),
              f"phase 17 (b): runs {runs_b} -> {runs()}, jit {jit_b} -> "
              f"{jit_b1}")
        lines.append(f"  (b) after both readers synced past the fills "
                     f"({walls['sync']:.1f} s): the three again from the "
                     f"other delegate in {walls['b']:.2f} s, hit_cache 3, "
                     f"tasks_run_ever unchanged, artifacts byte-equal to "
                     f"(a)'s")

        # (e') the same sweep from the other delegate: the sweep cache.
        runs_e2 = runs()
        t0 = time.perf_counter()
        res2 = autotune.sweep(template, space, fanout_width=JIT_SWEEP_WIDTH)
        walls["e2"] = time.perf_counter() - t0
        check(res2.ok and res2.verdicts == [] and res2.winner == res.winner
              and runs() == runs_e2,
              f"phase 17 (e): second sweep {res2.winner} {res2.verdicts}")
        # (f') the shim read back through the other delegate.
        got = ClusterCompileCache().get("chip-smoke-phase17")
        check(got == blob, "phase 17 (f): the shim read back other bytes")
        lines.append(f"  (e') the sweep from the other delegate: the winner "
                     f"from the sweep cache, no child run, in "
                     f"{walls['e2']:.3f} s; (f) a {JIT_SHIM_BYTES:,}-byte "
                     f"jit_cache_put through {a} read back byte-equal by "
                     f"jit_cache_get through {b}")

        # (d') resubmitted with a fifth topology: 4 cached, 1 ok.
        use(a)
        fifth = topology(*JIT_FIFTH)
        runs_d = runs()
        t0 = time.perf_counter()
        out2 = aot.submit_aot_build(gsrc, topos + [fifth])
        walls["d2"] = time.perf_counter() - t0
        check(out2.ok and out2.exit_code == 0 and [
            v["status"] for v in out2.verdicts] == ["cached"] * 4 + ["ok"]
              and sum(runs().values()) == sum(runs_d.values()) + 1,
              f"phase 17 (d): resubmission {out2.verdicts}")
        for t in topos:
            check(out2.artifact_for(t) == out.artifact_for(t),
                  f"phase 17 (d): {t.tag()} cached artifact differs")
        lines.append(f"  (d') resubmitted with {JIT_FIFTH[0]} "
                     f"{JIT_FIFTH[1]}: 4 cached, 1 ok in "
                     f"{walls['d2']:.2f} s")

        launches = k1() - k1_before
        check(launches > 0, "phase 17: K1 never launched for its grants")
        by_kind = {n: kinds(n) for n in names}
        rss = {n: proc_status(procs[n].pid)["VmRSS"] for n in names}
        for n in names:
            with open(f"/proc/{procs[n].pid}/maps") as f:
                check("libtorch" not in f.read(),
                      f"phase 17: daemon {n} mapped libtorch")
        lines.append(f"  K1 launches in the scheduler over the phase "
                     f"{launches} (every build granted through it); "
                     f"stats_by_kind {json.dumps(by_kind, sort_keys=True)}; "
                     f"daemons' RSS kB {rss} (no libtorch mapped); walls "
                     + ", ".join(f"{k} {v:.2f} s" for k, v in walls.items()))
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    seconds = time.perf_counter() - t_phase
    return {"seconds": seconds, "lines": lines, "walls": walls,
            "nvcc_s": {s: t for s, (t, _) in nvcc.items()},
            "nvcc_peak_rss_kb": {s: kb for s, (_, kb) in nvcc.items()},
            "launches": {"grouped_assign": launches, "assign_batch": 0},
            "targets": targets, "winner": res.winner, "by_kind": by_kind,
            "rss_kb": rss}


def run_jit_fleet(entry_args=()) -> dict:
    """Phase 17 alone, on a fleet of its own (about a minute): the
    scheduler entry with its defaults (plus ``entry_args``), one synthetic
    servant registered first at the delegates' loopback address (so both
    real servants stay eligible), one port cache entry and two aio
    daemons; then run_jit_path.  Call build_kernels() first: the farm's
    library is held against the local one."""
    import shutil

    from yadcc_tpu_torch import api
    from yadcc_tpu_torch.rpc import Channel
    from yadcc_tpu_torch.scheduler.service import SERVICE_NAME

    shutil.rmtree(SERVANT_DIR, ignore_errors=True)
    SERVANT_DIR.mkdir(parents=True)
    sport, siport, cport, ciport = (free_port() for _ in range(4))
    tokens = ["--acceptable-user-tokens", "utok,stok"]
    daemons, procs = {}, {}
    names = daemon_names("aio")
    try:
        procs["scheduler"] = start_entry("jit", sport, siport,
                                         [*tokens, *entry_args])
        sched = Channel(f"grpc://127.0.0.1:{sport}")
        wait_ready("jit", procs["scheduler"], sched)
        fleet = Fleet(seed=17)
        sched.call(SERVICE_NAME, "Heartbeat",
                   fleet.heartbeat(api, fleet.servants[0]),
                   api.scheduler.HeartbeatResponse, timeout=10.0)
        procs["cache"] = start_cache_entry(
            "jit", cport, ciport, ["--cache-engine", "disk", "--cache-dirs",
                                   str(SERVANT_DIR / "cache-l2"), *tokens])
        wait_cache_ready("jit", procs["cache"], f"grpc://127.0.0.1:{cport}")
        gxx = shutil.which("g++") or "/usr/bin/g++"
        for n in names:
            daemons[n] = {"serve": free_port(), "inspect": free_port(),
                          "local": free_port()}
            daemons[n]["loc"] = f"127.0.0.1:{daemons[n]['serve']}"
            procs[n] = start_daemon(n, "aio", daemons[n], sport, cport,
                                    os.path.dirname(gxx),
                                    SERVANT_DIR / f"tmp-{n}",
                                    os.cpu_count() or 1)
        deadline = time.monotonic() + 120
        while True:
            td = inspect_vars(siport)["yadcc"]["task_dispatcher"]
            try:
                up = all(inspect_vars(daemons[n]["inspect"])["yadcc"][
                    "daemon"]["servant"]["last_heartbeat"].get("capacity")
                         for n in names)
            except (OSError, KeyError):
                up = False
            if up and len(td["servants"]) == 3:
                break
            for n in names:
                check(procs[n].poll() is None, f"daemon {n} exited at boot")
            check(time.monotonic() < deadline, "the jit fleet did not boot")
            time.sleep(0.2)
        res = run_jit_path(daemons, names, procs, siport,
                           f"grpc://127.0.0.1:{cport}")
        leave(procs, names, siport)
        return res
    finally:
        for p in procs.values():
            stop_entry(p)
        shutil.rmtree(SERVANT_DIR, ignore_errors=True)


# ---------------------------------------------------------------------------
# Phase 16: the scheduler's scale harnesses (trace replay, pod simulation).
# ---------------------------------------------------------------------------

SCALE_TRACE = dict(tasks=6000, batch=64, envs=16, seed=0)   # configs[1]
SCALE_TRACE_SERVANTS = (("16a", 128), ("16b", 5000))
SCALE_STREAM_DEPTHS = (0, 16)
SCALE_POD_SERVANTS = 5000
SCALE_POD_TASKS = 20_000       # configs[4] has 100,000: cut to fit the budget
SCALE_POD = dict(capacity=8, policy="auto", exec_ms=30.0, churn_per_s=2,
                 capacity_dist="uniform:4:16", check_unique=True)
SCALE_POD_DUP = 0.3
SCALE_POD_SUBMITTERS = 8
SCALE_POD_DEPTH = 16           # 16c's second arm: the entry's default on
                               # the card (--dispatch-pipeline-depth auto)


def zero_launches() -> None:
    from yadcc_tpu_torch.ops import cuda_assign as ka
    from yadcc_tpu_torch.ops import cuda_grouped as kg

    kg.launches = 0
    ka.launches = 0


def read_launches() -> dict:
    from yadcc_tpu_torch.ops import cuda_assign as ka
    from yadcc_tpu_torch.ops import cuda_grouped as kg

    return {"grouped_assign": kg.launches, "assign_batch": ka.launches}


def run_scale_path(report: list) -> dict:
    """Phase 16: the port's scale harnesses on the card.  16a/16b: a
    trace of 6,000 tasks (seed 0, batches of 64, 16 envs) over 128 and
    then 5,000 servants, replayed through the panel (greedy_cpu,
    torch_batched = K2, torch_grouped = K1, auto), every policy equal to
    the greedy reference batch by batch, and the pipelined stream (K1's
    stream wrapper) at depth 16 pick for pick equal to depth 0.  16c: a
    PodSim of 5,000 servants (capacities uniform 4-16, auto, 30 ms
    compiles, 2 servants churned a second, 30% duplicates) through the
    in-process RPC grant path for 20,000 tasks: every task accounted
    for, no grant id issued twice, the client's grants equal to the
    scheduler's; once synchronous (depth 0: auto sends a cycle below
    its measured crossover to the host, one above it to K1 through
    _picks_packed) and once pipelined at SCALE_POD_DEPTH, the mode the
    scheduler entry takes on the card, where every cycle launches K1
    through its stream wrapper (cuda_assign_grouped_picks_stream).  16d: pod_sim's own gates on the card: smoke_device (4
    shards x 20 lock-step cycles of the fused grid, one K1 launch each,
    every shard's picks against greedy_assign_reference) and smoke (4
    shards, zipf:1.5 hotspot: the steal engages, no id twice, the
    aggregate equal to the sum over shards, the load summary on the
    card).  Every launch count is set to 0 just before each run and read
    just after it."""
    import logging

    import torch

    from yadcc_tpu_torch.ops import cuda_bloom
    from yadcc_tpu_torch.tools import trace_replay as tr

    dev = torch.device("cuda")
    t_phase = time.perf_counter()
    bloom_before = dict(cuda_bloom.launches)
    LOG_DIR.mkdir(exist_ok=True)
    res = {"launches": {}, "replay": {}, "stream": {}}
    for tag, servants in SCALE_TRACE_SERVANTS:
        path = LOG_DIR / f"scale_trace_{servants}.jsonl"
        tr.generate_trace(str(path), servants=servants, **SCALE_TRACE)
        t0 = time.perf_counter()
        zero_launches()
        replay = tr.replay(str(path), device=dev)
        n_replay = read_launches()
        zero_launches()
        stream = tr.replay_stream(str(path), depths=SCALE_STREAM_DEPTHS,
                                  device=dev)
        n_stream = read_launches()
        seconds = time.perf_counter() - t0
        for name, r in replay.items():
            check(r["matches_reference"],
                  f"phase {tag}: {name} diverges from greedy_cpu")
            check(r["granted"] == replay["greedy_cpu"]["granted"] > 0,
                  f"phase {tag}: {name} granted {r['granted']}")
        for key, r in stream.items():
            check(r["matches_serialized"] and r["picks_equal_serialized"],
                  f"phase {tag}: the stream at {key} differs from depth 0")
        check(stream["stream_serialized"]["granted"] > 0,
              f"phase {tag}: the stream granted nothing")
        check(n_replay["grouped_assign"] > 0 and
              n_replay["assign_batch"] > 0,
              f"phase {tag}: replay launches {n_replay}")
        check(n_stream["grouped_assign"] > 0,
              f"phase {tag}: stream launches {n_stream}")
        check(n_stream["assign_batch"] == 0,
              f"phase {tag}: K2 in the K1 stream {n_stream}")
        res["launches"][f"phase16_replay_{servants}"] = n_replay
        res["launches"][f"phase16_stream_{servants}"] = n_stream
        res["replay"][servants] = replay
        res["stream"][servants] = stream
        report.append(
            f"  {tag} replay of {SCALE_TRACE['tasks']} tasks x {servants} "
            f"servants ({seconds:.1f} s with warmups): " + "; ".join(
                f"{name} {r['assignments_per_sec']:.1f} assignments/s "
                f"({r['granted']} granted, final running "
                f"{r['final_running']})" for name, r in replay.items())
            + f"; every policy matches greedy_cpu; launches {n_replay}")
        report.append(
            f"  {tag} stream: " + "; ".join(
                f"{key} {r['assignments_per_sec']:.1f} assignments/s "
                f"({r['granted']} granted)" for key, r in stream.items())
            + f"; depth {SCALE_STREAM_DEPTHS[-1]} pick for pick equal to "
              f"depth 0; launches {n_stream}")

    # The cache server logs a line a fill at INFO: 14,000 stderr writes
    # on the measured path (pod_sim's main runs at WARNING for this).
    root_log = logging.getLogger()
    level = root_log.level
    root_log.setLevel(logging.WARNING)
    try:
        pod_sim_gates(res, report, dev)
    finally:
        root_log.setLevel(level)
    res["bloom_launches"] = {k: v - bloom_before.get(k, 0)
                             for k, v in cuda_bloom.launches.items()}
    check(not any(res["bloom_launches"].values()),
          f"phase 16 ran a Bloom kernel: {res['bloom_launches']}")
    res["seconds"] = time.perf_counter() - t_phase
    return res


def pod_sim_arm(res: dict, report: list, dev, depth: int) -> dict:
    """One arm of 16c at ``depth`` (see run_scale_path).  Both arms set
    the counts to 0 after the build and its warmups (auto's calibration
    ladder launches K1) and read them after the run, and both count the
    stream wrapper's calls in the run.  Depth 0: auto sends each cycle
    below its measured crossover to the host greedy route and the rest
    to K1, so the run launches K1 for, and only for, the cycles it sent
    to the device (none, where every cycle is below the crossover), and
    never through the stream wrapper.  Depth 16: every cycle takes the
    stream, and every K1 launch of the run goes through the stream
    wrapper, with no stale-stream resync."""
    from yadcc_tpu_torch.ops import cuda_grouped as kg
    from yadcc_tpu_torch.tools import pod_sim

    tag = "16c" if depth == 0 else f"16c depth {depth}"
    t0 = time.perf_counter()
    sim = pod_sim.PodSim(SCALE_POD_SERVANTS, device=dev,
                         pipeline_depth=depth, **SCALE_POD)
    built_s = time.perf_counter() - t0
    stream_calls = [0]
    real = kg.cuda_assign_grouped_picks_stream

    def counted(*a, **kw):
        stream_calls[0] += 1
        return real(*a, **kw)

    # auto's two routes, cycles counted in the run.
    pol = sim.dispatcher._policy
    routes = {"host": 0, "device": 0}

    def route(name, assign):
        def counted_assign(*a, **kw):
            routes[name] += 1
            return assign(*a, **kw)
        return counted_assign

    pol._greedy.assign = route("host", pol._greedy.assign)
    pol._grouped.assign = route("device", pol._grouped.assign)
    zero_launches()
    kg.cuda_assign_grouped_picks_stream = counted
    try:
        out = sim.run(SCALE_POD_TASKS, SCALE_POD_DUP, SCALE_POD_SUBMITTERS)
    finally:
        kg.cuda_assign_grouped_picks_stream = real
    n_pod = read_launches()
    b = out["breakdown"]
    check(out["tasks"] == SCALE_POD_TASKS,
          f"{tag}: {out['tasks']} of {SCALE_POD_TASKS} tasks accounted for")
    check(b["hit_cache"] + b["reused"] + b["actually_run"]
          == SCALE_POD_TASKS, f"{tag}: the ladder does not sum: {b}")
    check(sim._dup_gids == 0,
          f"{tag}: {sim._dup_gids} grant ids issued twice")
    check(out["grants_granted"] == out["scheduler_stats"]["granted"],
          f"{tag}: client grants {out['grants_granted']} != scheduler "
          f"{out['scheduler_stats']['granted']}")
    check(n_pod["assign_batch"] == 0, f"{tag}: K2 launched {n_pod}")
    stream = sim.dispatcher.inspect()["stream"]
    crossover = pol._measured_threshold
    if depth == 0:
        check(routes["host"] + routes["device"] > 0,
              f"{tag}: auto routed no cycle ({routes})")
        check(n_pod["grouped_assign"] >= routes["device"]
              and (n_pod["grouped_assign"] > 0) == (routes["device"] > 0),
              f"{tag}: K1 launches {n_pod} for auto's routes {routes}")
        check(stream_calls[0] == 0,
              f"{tag}: the synchronous arm called K1's stream wrapper "
              f"{stream_calls[0]} times")
    else:
        check(n_pod["grouped_assign"] > 0,
              f"{tag}: K1 never launched in the run ({n_pod})")
        check(routes["host"] == 0,
              f"{tag}: a pipelined cycle took the host route ({routes})")
        check(stream_calls[0] == n_pod["grouped_assign"],
              f"{tag}: {stream_calls[0]} stream wrapper calls for "
              f"{n_pod['grouped_assign']} K1 launches")
        check(stream["resyncs"] == 0,
              f"{tag}: the stale-stream guard resynced: {stream}")
    key = "phase16_pod_sim" + ("" if depth == 0 else f"_depth{depth}")
    res["launches"][key] = n_pod
    lb = out["latency_breakdown"]
    pod = {k: out[k] for k in (
        "tasks", "servants", "total_capacity", "wall_seconds",
        "tasks_per_sec", "assignments_per_sec", "breakdown", "grant_calls",
        "grants_granted", "grant_call_p50_ms", "grant_call_p99_ms",
        "dispatch_only_p99_ms")}
    pod["latency_breakdown"] = {
        k: v for k, v in lb.items() if k != "frontend_stages"}
    pod["stream_wrapper_calls"] = stream_calls[0]
    pod["stream"] = stream
    pod["auto_routes"] = routes
    pod["auto_crossover"] = crossover
    res["pod" if depth == 0 else f"pod_depth{depth}"] = pod
    report.append(
        f"  {tag} pod_sim: {out['tasks']} tasks x {out['servants']} "
        f"servants (capacity {out['total_capacity']}, "
        f"{SCALE_POD['capacity_dist']}, {SCALE_POD['policy']}, pipeline "
        f"depth {depth}; built and warmed in {built_s:.1f} s) in "
        f"{out['wall_seconds']} s: {out['tasks_per_sec']} tasks/s, "
        f"{out['assignments_per_sec']} assignments/s; breakdown "
        f"{json.dumps(b)}; grant call p50 {out['grant_call_p50_ms']} ms "
        f"p99 {out['grant_call_p99_ms']} ms; dispatch_only_p99_ms "
        f"{out['dispatch_only_p99_ms']}; no id twice; launches in the run "
        f"{n_pod}; auto's cycles by route {routes} (measured crossover "
        f"{crossover} tasks)"
        + (f"; stream wrapper calls {stream_calls[0]}, dispatcher stream "
           f"{stream}" if depth > 0 else ""))
    report.append(f"  {tag} latency_breakdown (ms): " + json.dumps(
        {k: v and {q: v[q] for q in ("count", "p50_ms", "p99_ms")}
         for k, v in pod["latency_breakdown"].items()}))
    return {"pod": pod, "launches": n_pod}


def pod_sim_gates(res: dict, report: list, dev) -> None:
    """Phase 16c and 16d (see run_scale_path)."""
    import contextlib
    import io

    from yadcc_tpu_torch.tools import pod_sim

    arm0 = walled("16c depth 0", pod_sim_arm, res, report, dev, 0)
    arm = walled(f"16c depth {SCALE_POD_DEPTH}", pod_sim_arm, res, report,
                 dev, SCALE_POD_DEPTH)
    report.append(
        f"  16c depth {SCALE_POD_DEPTH} beside depth 0: "
        + "; ".join(f"{k} {arm['pod'][k]} vs {arm0['pod'][k]}" for k in (
            "tasks_per_sec", "assignments_per_sec", "grant_call_p50_ms",
            "grant_call_p99_ms", "dispatch_only_p99_ms"))
        + f"; launches {arm['launches']} vs {arm0['launches']}")

    for name, gate in (("smoke_device", pod_sim.smoke_device),
                       ("smoke", pod_sim.smoke)):
        args = pod_sim.build_arg_parser().parse_args(
            ["--device", str(dev), "--shards", "4"])
        t0 = time.perf_counter()
        zero_launches()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = gate(args)
        n = read_launches()
        got = json.loads(buf.getvalue())
        check(rc == 0 and not got["failures"],
              f"16d {name}: {got['failures']}")
        res["launches"][f"phase16_{name}"] = n
        res[name] = got
        keys = (("cycles", "grants_issued", "parity_runs_checked",
                 "duplicate_grant_ids", "fused") if name == "smoke_device"
                else ("shards", "hotspot", "tasks", "assignments_per_sec",
                      "steal_rate", "stolen_grants", "duplicate_grant_ids",
                      "load_summary"))
        report.append(
            f"  16d {name} ({time.perf_counter() - t0:.1f} s): "
            + json.dumps({k: got[k] for k in keys}) + f"; launches {n}")
    check(res["launches"]["phase16_smoke_device"]["grouped_assign"]
          >= res["smoke_device"]["cycles"],
          "16d smoke_device: fewer K1 launches than fused cycles")


# ---------------------------------------------------------------------------
# Phase 18: lock-order tracing and the cluster sweep on the card.
# ---------------------------------------------------------------------------

TOOLS_DRIVE_S = 5.0            # phase 18a's drive, untraced then traced
SWEEP_TASKS = 200              # phase 18b (the tool's 2,000 take ~2 min;
                               # 300 until phase 21)
SWEEP_JIT_TASKS = 100          # phase 18c's jit sweep (200 until phase
                               # 19; at 60 its dedup check found 1 and 0
                               # hits, so it stays at 100)
SWEEP_SHAPE = dict(servants=4, concurrency=4, dup_rate=0.2)


def run_locktrace_drive(report: list) -> dict:
    """Phase 18a: the scheduler as the entry builds it with its defaults
    (auto, pipelined, on the card), 5,000 servants, 24 delegate threads
    for TOOLS_DRIVE_S without RPC; once untraced, then with the dispatcher
    built and driven inside locktrace.installed(), so every lock it
    constructs is traced.  The traced run: no lock-order cycle through a
    lock of the port (torch's own locks are nodes too, filtered by module
    name), the graph not saturated, K1 launched, every grant freed, no
    failure.  Launch counts are set to 0 just before each build and read
    just after its drive."""
    import contextlib

    from yadcc_tpu_torch.scheduler import entry
    from yadcc_tpu_torch.utils import locktrace

    args = entry.build_arg_parser().parse_args([])
    fleet = Fleet(seed=18)
    res = {}
    for traced in (False, True):
        tag = "18a traced" if traced else "18a untraced"
        zero_launches()
        with (locktrace.installed() if traced
              else contextlib.nullcontext()) as graph:
            d = entry.build_dispatcher(args)
            drive = InProcessDrive(d, fleet, tag, 1800)
            try:
                register_fleet(d, fleet, tag)
                drive.start()
                t0 = time.perf_counter()
                time.sleep(TOOLS_DRIVE_S)
                granted, seconds = drive.grants, time.perf_counter() - t0
                drive.join()
                deadline = time.monotonic() + 10
                while d.inspect()["grants_outstanding"] and \
                        time.monotonic() < deadline:
                    time.sleep(0.05)
                state = d.inspect()
            finally:
                drive.stop.set()
                d.stop()
        launches = read_launches()
        k1 = launches["grouped_assign"]
        check(state["failure"] is None, f"{tag}: {state['failure']}")
        check(state["grants_outstanding"] == 0,
              f"{tag}: {state['grants_outstanding']} grants outstanding")
        check(granted > 0, f"{tag}: no grant")
        check(k1 > 0, f"{tag}: K1 never launched")
        res["traced" if traced else "untraced"] = dict(
            grants=granted, seconds=seconds,
            grants_per_s=granted / seconds, launches=k1,
            counts=launches, policy=state["policy"])
    snap = graph.inspect()
    bad = locktrace.framework_violations(graph)
    check(not snap["saturated"], "18a: the lock graph saturated")
    check(not bad, f"18a: lock-order cycles through the port: {bad[:3]}")
    ours = [n for n in snap["locks"] if n.startswith("yadcc_tpu_torch.")]
    check(ours, "18a: no lock of the port was traced")
    res["graph"] = dict(nodes=len(snap["locks"]), port_nodes=len(ours),
                        edges=snap["edges"],
                        violations=len(snap["violations"]),
                        framework_violations=len(bad))
    g, u, t = res["graph"], res["untraced"], res["traced"]
    report.append(
        f"  18a lock order on the grant path ({t['policy']}, pipelined, "
        f"{N_SERVANTS} servants, {N_DELEGATES} delegate threads in "
        f"process): traced "
        f"{t['grants']} grants in {t['seconds']:.2f} s "
        f"({t['grants_per_s']:.1f}/s, {t['launches']} K1 launches) beside "
        f"untraced {u['grants']} ({u['grants_per_s']:.1f}/s, "
        f"{u['launches']} K1 launches) in the same call; graph "
        f"{g['nodes']} nodes ({g['port_nodes']} of the port), {g['edges']} "
        f"edges, {g['violations']} cycles, {g['framework_violations']} "
        f"through the port; not saturated; every grant freed")
    return res


def run_sweeps(report: list) -> dict:
    """Phase 18b-c: yadcc_tpu_torch/tools/cluster_sim.run on the card
    (torch_grouped: K1 for every cycle), 4 servants of 4 slots, 20%
    duplicates, instant fake compiles: (b) SWEEP_TASKS C++ TUs, (c)
    SWEEP_JIT_TASKS jit modules through the fake worker.  No failure,
    every submission resolved (hit, join or run), every unique source run,
    K1 launched, no grant outstanding in the scheduler once the rig has
    stopped; (c) deduped.  Counts of hits and joins vary with timing and
    are printed, not held."""
    import logging

    from yadcc_tpu_torch import testing
    from yadcc_tpu_torch.tools import cluster_sim

    made: list = []

    class Recording(testing.LocalCluster):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    res = {"launches": {}}
    rig, testing.LocalCluster = testing.LocalCluster, Recording
    # The cache server logs a line a fill at INFO.
    root_log = logging.getLogger()
    level = root_log.level
    root_log.setLevel(logging.WARNING)
    try:
        for tag, workload, tasks in (("18b", "cxx", SWEEP_TASKS),
                                     ("18c", "jit", SWEEP_JIT_TASKS)):
            made.clear()
            zero_launches()
            out = cluster_sim.run(
                tasks, SWEEP_SHAPE["servants"], SWEEP_SHAPE["concurrency"],
                SWEEP_SHAPE["dup_rate"], "torch_grouped", compile_s=0.0,
                workload=workload, device="cuda")
            launches = read_launches()
            k1 = launches["grouped_assign"]
            b = out["breakdown"]
            unique = max(1, int(tasks * (1.0 - SWEEP_SHAPE["dup_rate"])))
            outstanding = made[0].sched_dispatcher.inspect()[
                "grants_outstanding"]
            check(out["failures"] == 0, f"{tag}: {out['failures']} failed")
            check(b["hit_cache"] + b["reused"] + b["actually_run"] >= tasks,
                  f"{tag}: unresolved submissions {b}")
            check(b["actually_run"] >= unique,
                  f"{tag}: {b['actually_run']} runs for {unique} sources")
            check(k1 > 0, f"{tag}: K1 never launched")
            check(outstanding == 0, f"{tag}: {outstanding} grants left")
            if workload == "jit":
                check(out["dedup_ratio"] > 0, f"{tag}: no dedup")
            res[workload] = out
            res["launches"][f"phase18{tag[-1]}_{workload}_sweep"] = launches
            report.append(
                f"  {tag} {workload} sweep of {tasks} tasks "
                f"({SWEEP_SHAPE['servants']} servants x "
                f"{SWEEP_SHAPE['concurrency']} slots, "
                f"{SWEEP_SHAPE['dup_rate']:.0%} duplicates, torch_grouped on "
                f"the card): "
                f"{out['tasks_per_sec']} tasks/s over "
                f"{out['wall_seconds']} s, p50 {out['p50_latency_ms']} ms, "
                f"p99 {out['p99_latency_ms']} ms; hit {b['hit_cache']} / "
                f"joined {b['reused']} / run {b['actually_run']} for "
                f"{unique} unique; "
                + (f"dedup ratio {out['dedup_ratio']}; "
                   if workload == "jit" else "")
                + f"K1 launches {k1}; 0 failures, 0 grants outstanding")
    finally:
        testing.LocalCluster = rig
        root_log.setLevel(level)
    return res


def run_tools_path(report: list) -> dict:
    """Phase 18 (see run_locktrace_drive and run_sweeps)."""
    t0 = time.perf_counter()
    res = {"locktrace": run_locktrace_drive(report)}
    res.update(run_sweeps(report))
    for run in ("untraced", "traced"):
        res["launches"][f"phase18a_{run}"] = res["locktrace"][run]["counts"]
    res["seconds"] = time.perf_counter() - t0
    return res


# ---------------------------------------------------------------------------
# Phase 19: the hostile-world scenarios and the native client farm.
# ---------------------------------------------------------------------------

# (scenario, smoke size): cell-kill runs at its smoke size (8 storm
# threads x 6 tasks).  At its full size (12 x 10) the JAX package's
# scenario fails its own local_only_verdicts_max 0 on every policy: 12
# waiters on cell 0's 2 slots are 6x its capacity, the ladder's
# LOCAL_ONLY threshold (both packages, PERF.md).
HOSTILE_CARD = (("overload-ladder", False), ("cell-kill", True),
                ("spill-affinity", False))
NATIVE_TUS = 8                 # phase 15's corpus at -O2 through the farm
PROMOTED_DRIVE = 3             # 19b: grants the promoted standby must make
NATIVE_DIR = REPO / "smoke_native"

# Runs one client process, its stdout and stderr passed through, and
# writes its exit code and the CPU seconds of its process tree (the
# client and the g++ it runs) to argv[1].
CPU_WRAPPER = (
    "import json, resource, subprocess, sys\n"
    "r = subprocess.run(sys.argv[2:])\n"
    "u = resource.getrusage(resource.RUSAGE_CHILDREN)\n"
    "open(sys.argv[1], 'w').write(json.dumps("
    "{'rc': r.returncode, 'cpu_s': u.ru_utime + u.ru_stime}))\n"
    "sys.exit(r.returncode)\n")


def run_scenario_on_card(report: list, name: str, smoke: bool) -> dict:
    """One scenario of yadcc_tpu_torch/tools/scenarios.py (HOSTILE_CARD's
    size), torch_grouped on the card; every SLO check must pass and K1
    must launch (cell-kill: the promoted standby's dispatcher runs
    torch_grouped on the card too, and grants after the promotion)."""
    import torch

    from yadcc_tpu_torch.ops import cuda_bloom as kb
    from yadcc_tpu_torch.testing import federated_cluster
    from yadcc_tpu_torch.tools import scenarios

    made: list = []
    drives: list = []

    class Recording(federated_cluster.FederatedCluster):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

        def stop(self):
            # cell-kill: before the rig goes, demand for cell 0's own
            # servants through the promoted standby (a storm that spilled
            # everything after the kill left it nothing to grant).
            if name == "cell-kill" and self.standby.dispatcher is not None:
                drives.append(self.drive_promoted(want=PROMOTED_DRIVE))
            super().stop()

    rig, federated_cluster.FederatedCluster = \
        federated_cluster.FederatedCluster, Recording
    zero_launches()
    for k in kb.launches:
        kb.launches[k] = 0
    t0 = time.perf_counter()
    try:
        out = scenarios.run_scenario(name, smoke=smoke,
                                     policy="torch_grouped", device="cuda")
    finally:
        federated_cluster.FederatedCluster = rig
    wall = time.perf_counter() - t0
    launches = read_launches()
    launches["placement_score"] = kb.launches["placement_score"]
    bad = {k: (out.get(k.rsplit("_", 1)[0]), out["slo"][k])
           for k, ok in out["slo_checks"].items() if not ok}
    check(out["slo_ok"], f"19 {name}: SLO checks failed "
                         f"(measured, bound): {bad}")
    check(launches["grouped_assign"] > 0, f"19 {name}: K1 never launched")
    measured = {k: out.get(k.rsplit("_", 1)[0]) for k in out["slo"]}
    line = (f"  19 {name} (torch_grouped on the card, "
            f"{'smoke' if smoke else 'full'} size, {wall:.1f} s): every SLO "
            f"check passed "
            f"{json.dumps(measured)}; K1 launches "
            f"{launches['grouped_assign']}")
    if name == "overload-ladder":
        line += (f"; storm {out['storm_seconds']} s, back to NORMAL "
                 f"{out['recovery_seconds_after_storm']} s after it, "
                 f"{out['grant_calls']} grant calls, {out['ok_remote']} "
                 f"remote / {out['local_fallback']} local")
    if name == "cell-kill":
        check(len(made) == 1, "19 cell-kill: no federated rig recorded")
        promoted = made[0].standby.dispatcher
        check(promoted is not None, "19 cell-kill: no promoted dispatcher")
        pol = promoted._policy
        check(type(pol).__name__ == "TorchGroupedPolicy"
              and pol._device.type == "cuda",
              f"19 cell-kill: the promoted dispatcher runs "
              f"{type(pol).__name__} on {getattr(pol, '_device', None)}")
        check(len(drives) == 1, "19 cell-kill: the promoted standby was "
                                "never driven")
        drive = drives[0]
        check(drive["granted_here"] >= 1,
              f"19 cell-kill: the promoted standby granted none of the "
              f"drive's calls {drive}")
        after = promoted.inspect()["stats"]["granted"]
        check(after > 0, "19 cell-kill: no grant after the promotion")
        check(out["double_runs"] == 0, "19 cell-kill: a grant issued twice")
        line += (f"; promoted standby torch_grouped on "
                 f"{pol._device}, {after} grants after the promotion "
                 f"({drive['granted_before']} in the storm; the drive "
                 f"{drive['granted_here']} of {drive['calls']} calls, "
                 f"{drive['spilled']} spilled), "
                 f"failover {out['failover_time_ms']} ms, 0 double runs")
    if name == "spill-affinity":
        check(launches["placement_score"] > 0,
              "19 spill-affinity: the placement kernel never launched")
        line += (f"; placement kernel launches "
                 f"{launches['placement_score']}, scored hit rate "
                 f"{out['scored_hit_rate']} vs least-loaded "
                 f"{out['baseline']['post_spill_hit_rate']} (ratio "
                 f"{out['warm_hit_rate_ratio']}), placement_score_p99_us "
                 f"{out['placement_score_p99_us']}")
    report.append(line)
    torch.cuda.synchronize()
    return {"out": out, "launches": launches, "seconds": wall}


def run_client_build(farm, tus: list, port: int, gxx_dir: str,
                     tag: str) -> list:
    """Each TU through ``farm``'s g++ (one client process a TU, all at
    once, as make -j runs them), its object beside its source as
    <tag>.o; ``farm`` None runs the host g++ itself (the local
    reference).  The exit code and the CPU seconds of each run's process
    tree (the client and the g++ it runs)."""
    wrapper = NATIVE_DIR / "cpu_wrapper.py"
    wrapper.write_text(CPU_WRAPPER)
    path = f"{gxx_dir}:{os.environ['PATH']}"
    env = dict(os.environ, PATH=f"{farm}:{path}" if farm else path,
               YTPU_DAEMON_PORT=str(port),
               YTPU_COMPILE_ON_CLOUD_SIZE_THRESHOLD="1")
    procs = []
    for tu in tus:
        rec = tu.src.with_suffix(f".{tag}.json")
        obj = tu.src.with_suffix(f".{tag}.o")
        procs.append((tu, rec, obj, subprocess.Popen(
            [sys.executable, str(wrapper), str(rec), "g++",
             *tu.args(obj)], cwd=tu.src.parent, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE)))
    runs = []
    for tu, rec, obj, p in procs:
        out, err = p.communicate(timeout=SERVANT_LIMIT_S)
        check(p.returncode == 0, f"19d {tag} tu{tu.i}: exit "
                                 f"{p.returncode}: {err[-800:]!r}")
        runs.append(dict(json.loads(rec.read_text()), obj=obj))
    return runs


def run_native_farm(report: list, make_s: float) -> dict:
    """Phase 19d: the port's native client, built on this host into
    yadcc_tpu_torch/_build/native/ by tools/install_client.py with its
    fakeroot shim (which the Python client then preloads too, so the two
    clients' cache keys agree), installed as a farm whose g++ links to
    it; NATIVE_TUS TUs of phase 15's corpus at -O2 through that g++
    against the port's LocalCluster (two servants of 4 slots,
    torch_grouped on the card): every object byte-equal to a local
    compile, K1 granting the slots.  Then, once the fills have landed
    and the delegate's reader has synced, the same TUs through the
    native farm and the Python client's farm (every one a cache hit, so
    no servant compiles beside them) and the host g++'s
    -E -fdirectives-only alone, each batch all at once: the clients' CPU
    seconds a TU, with and without the preprocessing they run.
    ``make_s``: the build's wall (run_hostile_path runs it on a thread
    beside the scenarios; here make finds it up to date, or fails the
    phase)."""
    import shutil

    from yadcc_tpu_torch.daemon.cloud.cxx_task import shutdown_pack_executor
    from yadcc_tpu_torch.testing import LocalCluster
    from yadcc_tpu_torch.tools import install_client

    t0 = time.perf_counter()
    shutil.rmtree(NATIVE_DIR, ignore_errors=True)
    (NATIVE_DIR / "src").mkdir(parents=True)
    gxx = shutil.which("g++")
    check(gxx is not None, "19d: no g++ on this host")
    gxx_dir = str(pathlib.Path(gxx).resolve().parent)
    native = install_client._native_client()
    check(native is not None, "19d: the native client did not build")
    farm, pyfarm = NATIVE_DIR / "farm", NATIVE_DIR / "pyfarm"
    install_client.install(str(farm))
    install_client.install(str(pyfarm), use_python_client=True)
    built = (REPO / "yadcc_tpu_torch" / "_build" / "native").resolve()
    link = farm / "g++"
    check(link.is_symlink() and built in link.resolve().parents,
          f"19d: the farm's g++ is not a link into {built}: {link}")
    check((link.resolve().parent / "libytpufakeroot.so").exists(),
          "19d: no fakeroot shim beside the native client")

    includes = servant_includes(gxx)
    tus = [tu for tu in servant_tus(includes) if not tu.error][:NATIVE_TUS]
    for tu in tus:
        tu.flags = "-O2"
        tu.src = NATIVE_DIR / "src" / f"tu{tu.i}.cc"
        tu.write()
    (NATIVE_DIR / "rig").mkdir()
    cluster = LocalCluster(NATIVE_DIR / "rig", n_servants=2,
                           policy="torch_grouped", device="cuda",
                           servant_concurrency=4, compiler_dirs=[gxx_dir])
    try:
        zero_launches()
        t1 = time.perf_counter()
        cold = run_client_build(farm, tus, cluster.http.port, gxx_dir,
                                "native")
        cold_s = time.perf_counter() - t1
        launches = read_launches()
        stats = dict(cluster.delegate.inspect()["stats"])
        deadline = time.monotonic() + 60
        while cluster.cache_service.inspect()["fills"] < NATIVE_TUS:
            check(time.monotonic() < deadline, "19d: fills never landed")
            time.sleep(0.05)
        cluster.cache_reader.sync_once()
        warm = run_client_build(farm, tus, cluster.http.port, gxx_dir,
                                "warm")
        warm_stats = {k: v - stats[k] for k, v in
                      cluster.delegate.inspect()["stats"].items()}
        py = run_client_build(pyfarm, tus, cluster.http.port, gxx_dir,
                              "python")
        py_stats = {k: v - stats[k] - warm_stats[k] for k, v in
                    cluster.delegate.inspect()["stats"].items()}
    finally:
        cluster.stop()
        shutdown_pack_executor()
    # Read once the rig has stopped: the delegate's grant keeper holds
    # spare grants while it runs.
    outstanding = cluster.sched_dispatcher.inspect()["grants_outstanding"]
    ref = run_client_build(None, tus, 0, gxx_dir, "ref")
    for tu in tus:
        tu.includes = [*includes, "-E", "-fdirectives-only"]
    pre = run_client_build(None, tus, 0, gxx_dir, "pre")
    for i, tu in enumerate(tus):
        want = ref[i]["obj"].read_bytes()
        for runs in (cold, warm, py):
            check(runs[i]["obj"].read_bytes() == want,
                  f"19d tu{tu.i}: {runs[i]['obj'].name} differs from a "
                  f"local compile")
    check(launches["grouped_assign"] > 0, "19d: K1 never launched")
    check(stats["actually_run"] == NATIVE_TUS and stats["failed"] == 0,
          f"19d: the native build's delegate stats {stats}")
    for name, st in (("native", warm_stats), ("Python", py_stats)):
        check(st["hit_cache"] == NATIVE_TUS and st["failed"] == 0,
              f"19d: the {name} client's cached run {st}")
    check(outstanding == 0, f"19d: {outstanding} grants left")
    cpu = {name: sum(r["cpu_s"] for r in runs) / NATIVE_TUS
           for name, runs in (("native", warm), ("python", py),
                              ("preprocess", pre))}
    report.append(
        f"  19d native client built in {make_s:.2f} s beside 19a-c (frames "
        f"{install_client.native_frames()}), farm g++ -> "
        f"{link.resolve().relative_to(REPO)}; {NATIVE_TUS} TUs "
        f"of phase 15's corpus at -O2 through it in {cold_s:.2f} s: every "
        f"object byte-equal to a local compile, delegate {stats}, K1 "
        f"launches {launches['grouped_assign']}, 0 grants outstanding; "
        f"cached, all {NATIVE_TUS} at once, native and Python clients "
        f"byte-equal too; CPU seconds a TU of the client's process tree "
        f"(its g++ -E included): native {cpu['native']:.3f}, Python "
        f"{cpu['python']:.3f}; g++ -E -fdirectives-only alone "
        f"{cpu['preprocess']:.3f}, so the client's own "
        f"{cpu['native'] - cpu['preprocess']:.3f} vs "
        f"{cpu['python'] - cpu['preprocess']:.3f}")
    shutil.rmtree(NATIVE_DIR, ignore_errors=True)
    return {"launches": launches, "cpu_s": cpu,
            "seconds": time.perf_counter() - t0}


def run_hostile_path(report: list) -> dict:
    """Phase 19 (see run_scenario_on_card and run_native_farm)."""
    import logging

    from yadcc_tpu_torch.tools import install_client

    t0 = time.perf_counter()
    res = {"launches": {}, "scenarios": {}}
    # 19d's native build (make, one core) runs beside the scenarios,
    # which mostly wait on sleeps and RPCs; 19d joins it.
    make = {}

    def build():
        t = time.perf_counter()
        try:
            install_client.build_native()
        except RuntimeError:
            pass   # 19d builds again and fails with make's output
        make["s"] = time.perf_counter() - t

    builder = threading.Thread(target=build, name="native-make")
    builder.start()
    # The rigs' cache servers log a line a fill at INFO.
    root_log = logging.getLogger()
    level = root_log.level
    root_log.setLevel(logging.WARNING)
    try:
        for tag, (name, smoke) in zip("abc", HOSTILE_CARD):
            r = run_scenario_on_card(report, name, smoke)
            res["scenarios"][name] = r
            res["launches"][f"phase19{tag}_{name}"] = {
                k: r["launches"][k] for k in KERNELS}
            if name == "spill-affinity":
                res["placement_launches"] = r["launches"]["placement_score"]
                res["placement_score_p99_us"] = \
                    r["out"]["placement_score_p99_us"]
        builder.join()
        res["native"] = run_native_farm(report, make["s"])
        res["launches"]["phase19d_native_farm"] = \
            res["native"]["launches"]
    finally:
        builder.join()
        root_log.setLevel(level)
    res["seconds"] = time.perf_counter() - t0
    return res


# ---------------------------------------------------------------------------
# Phase 22: the team (yadcc_tpu_torch/parallel/mesh.py) on the card.
# ---------------------------------------------------------------------------

TEAM_SLICES = 4                # slices over min(4, count) cards, cycled
TEAM_POD_TASKS = 10_000        # 22b: torch_sharded_grouped at depth 16
TEAM_SCAN_TASKS = 2_000        # 22b: torch_sharded, synchronous
TEAM_SPIN_CYCLES = 20_000_000  # 22a's bounded wait (~10 ms of SM clock)
TEAM_ROUNDS = 200              # 22a: the exchange's round trip
TEAM_RT_SLICES = (1, 2, 4, 8)  # 22a: its round trip by slices, one card

# Filled by phase 7 (compare_bloom_hits) for phase 22c: the filters and,
# per hit rate, the packed batch, the host's verdicts and the bounds.
BLOOM_STASH: dict = {}


def k1_team_exchanges(p, groups, pad) -> int:
    """The exchanges K1's team mode makes on this data: one for the
    m <= 0 skip, then, for each group it does not skip, one a bisect step
    and one for the tie split.  The steps are k1_model's (the team's
    totals are the whole pool's), and a group with no active slot in the
    whole team steps on a total of 0 where the single pool skips it."""
    from yadcc_tpu_torch.models.cost import DEFAULT_COST_MODEL, UTIL_SCALE

    padded = list(groups) + [(0, 0, -1, 0)] * (pad - len(groups))
    _, _, work = k1_model(p, padded)
    lo0 = -int(DEFAULT_COST_MODEL.preference_bonus_q) - 1
    hi0 = UTIL_SCALE + 1
    empty_steps, lo, known = 0, lo0, False
    while empty_steps < K1_SEARCH_ITERS and not (
            hi0 == lo or (hi0 - lo == 1 and known)):
        lo, known = (lo + hi0) >> 1, True
        empty_steps += 1
    n = 1
    for (_, _, _, m), (active, _, it) in zip(padded, work):
        if m > 0:    # the phase's pools hold no negative running
            n += (it if active else empty_steps) + 1
    return n


def compare_team_kernels(report: list, team) -> dict:
    """22a: K1's team mode (sync at G=64 and G=8, and the stream over two
    chained launches with an adjustment and a reset) and K2's at T=256 on
    phase 2's timing pool over the team, each held bit-equal to its plain
    team version and to the single-pool kernel, then timed beside it (CUDA
    events, 50 warm launches); a team told of a slice that never launches
    raises on its bounded wait instead of hanging, and the next call, and
    a team policy's next cycle, run as before."""
    import numpy as np
    import torch

    from yadcc_tpu_torch.ops import assignment as asn
    from yadcc_tpu_torch.ops import assignment_grouped as asg
    from yadcc_tpu_torch.ops import cuda_assign as ka
    from yadcc_tpu_torch.ops import cuda_grouped as kg
    from yadcc_tpu_torch.ops import team_exchange as tx
    from yadcc_tpu_torch.parallel import mesh
    from yadcc_tpu_torch.scheduler import policy as pol

    dev, n = team[0], len(team)
    ex = tx.TeamExchange()
    rng = np.random.default_rng(7)       # time_kernel's pool and groups
    p = np_pool(rng, MAIN_S, cap_lo=8, cap_hi=65, run_hi=8, ded_frac=0.2)
    pool = asn.pool_from_numpy(*(p[k] for k in asn.PoolArrays._fields), dev)
    tpool = mesh.shard_pool(pool, team)
    per = tpool.per

    def same(a, b, what):
        check(torch.equal(a.cpu(), b.cpu()), f"22a: {what}")

    def team_k1(batch):
        c, r = kg.cuda_assign_grouped_team(tpool, batch, exchange=ex)
        return mesh.unshard_counts(c, tpool), mesh.unshard_vector(r, team,
                                                                  per)

    def round_trip_ms(slices):
        """The exchange alone over ``slices``: TEAM_ROUNDS exchanges less
        a launch of none, a round."""
        words = ka.cuda_team_rounds(slices, TEAM_ROUNDS, ex)
        torch.cuda.synchronize()
        ex.check(slices)
        k = len(slices)
        check(words.tolist() == [(j + TEAM_ROUNDS) % k for j in range(k)],
              f"22a: the exchange's rounds over {k} ended on "
              f"{words.tolist()}")
        return max(0.0, (
            timed(lambda: ka.cuda_team_rounds(slices, TEAM_ROUNDS, ex), 20)
            - timed(lambda: ka.cuda_team_rounds(slices, 0, ex), 20))
            / TEAM_ROUNDS)

    # The team's round trip is the design's cost.  The bound's floor is
    # one slice's: a post and an acquire read of one slot in host memory,
    # the least any exchange through that memory takes a step.
    team_rt_ms = round_trip_ms(team)
    ladder = {k: round_trip_ms([dev] * k) * 1e3 for k in TEAM_RT_SLICES}
    floor_ms = ladder[1] / 1e3
    out = {"round_trip_us": team_rt_ms * 1e3, "floor_us": ladder[1],
           "round_trip_us_by_slices_one_card": ladder}
    report.append(
        f"  22a the exchange alone: {TEAM_ROUNDS} rounds, each slice "
        f"ending on the word the rounds predict; the team's {n} slices "
        f"{out['round_trip_us']:.3f} us a round; on one card by slices "
        + ", ".join(f"{k}: {v:.3f}" for k, v in ladder.items())
        + f" us (20 launches each of {TEAM_ROUNDS} rounds and of none); "
        f"the bounds take the 1-slice {ladder[1]:.3f} us a step")
    groups = {8: seeded_groups(rng, 8, MAIN_TASKS, MAIN_S)}
    groups[MAIN_G] = seeded_groups(rng, MAIN_G, MAIN_TASKS, MAIN_S)
    for g, gs in groups.items():
        batch = asg.make_grouped_batch(gs, g, dev)
        kc, kr = team_k1(batch)
        torch.cuda.synchronize()
        ex.check()
        pc, pr = asg.assign_grouped_team(pool, n, batch)
        sc, sr = kg.cuda_assign_grouped(pool, batch)
        same(kc, pc, f"K1 team G={g} counts != plain team")
        same(kr, pr, f"K1 team G={g} running != plain team")
        same(kc, sc, f"K1 team G={g} counts != single pool")
        same(kr, sr, f"K1 team G={g} running != single pool")
        ms = timed(lambda: team_k1(batch), 50)
        single_ms = timed(lambda: kg.cuda_assign_grouped(pool, batch), 50)
        ex.check()
        plain_ms = timed_once(lambda: asg.assign_grouped_team(pool, n,
                                                              batch))
        cost = k1_cost(p, gs, g)
        exch = k1_team_exchanges(p, gs, g)
        bytes_ms = cost["bytes"] / H100_BYTES_PER_S * 1e3
        ops_ms = cost["ops"] / H100_OPS_PER_S * 1e3
        out[g] = dict(ms=ms, single_ms=single_ms, plain_ms=plain_ms,
                      exchanges=exch, exchange_ms=exch * team_rt_ms,
                      bound_ms=max(bytes_ms, ops_ms) + exch * floor_ms,
                      bound_by="bytes" if bytes_ms >= ops_ms
                      else "operations", granted=int(kc.sum()))
        report.append(
            f"  22a K1 team of {n} S={MAIN_S} G={g} tasks={MAIN_TASKS}: "
            f"counts and running equal to the plain team version and to "
            f"single-pool K1 ({out[g]['granted']} granted); team "
            f"{ms:.4f} ms vs single pool {single_ms:.4f} ms (50 launches "
            f"each); plain {plain_ms:.2f} ms; {exch} exchanges, "
            f"{out[g]['exchange_ms']:.4f} ms at the team's round trip; "
            f"bound {out[g]['bound_ms']:.5f} ms (bytes/ops "
            f"{max(bytes_ms, ops_ms):.6f} ms, {out[g]['bound_by']}, + the "
            f"exchanges at the 1-slice floor)")

    # The stream: two chained launches with an adjustment and a reset.
    gs = seeded_groups(rng, 16, 1500, MAIN_S)
    packed = asg.make_grouped_packed(gs, 16, dev)
    t_max = asg.task_pad(1500)
    adj = torch.zeros(MAIN_S, dtype=torch.int32, device=dev)
    adj[:4] = -1
    rmask = torch.zeros(MAIN_S, dtype=torch.bool, device=dev)
    rmask[5] = True
    rval = torch.zeros(MAIN_S, dtype=torch.int32, device=dev)
    delta = [mesh.shard_vector(v, team, per) for v in (adj, rmask, rval)]

    def team_stream(running):
        tp = tpool._replace(parts=tuple(
            part._replace(running=r)
            for part, r in zip(tpool.parts, running)))
        return kg.cuda_assign_grouped_picks_stream_team(
            tp, packed, *delta, t_max, exchange=ex)

    run_t = mesh.shard_vector(pool.running.clone(), team, per)
    run_p = run_s = pool.running.clone()
    for step in range(2):
        kp, run_t = team_stream(run_t)
        pp, run_p = asg.assign_grouped_picks_stream_team(
            pool._replace(running=run_p), n, packed, adj, rmask, rval, t_max)
        sp, run_s = kg.cuda_assign_grouped_picks_stream(
            pool._replace(running=run_s), packed, adj, rmask, rval, t_max)
        torch.cuda.synchronize()
        ex.check()
        krun = mesh.unshard_vector(run_t, team, per)
        same(kp, pp, f"stream launch {step} picks != plain team")
        same(krun, run_p, f"stream launch {step} running != plain team")
        same(kp, sp, f"stream launch {step} picks != single pool")
        same(krun, run_s, f"stream launch {step} running != single pool")
    run0 = mesh.shard_vector(pool.running.clone(), team, per)
    stream = dict(
        ms=timed(lambda: team_stream(run0), 50),
        single_ms=timed(lambda: kg.cuda_assign_grouped_picks_stream(
            pool, packed, adj, rmask, rval, t_max), 50),
        plain_ms=timed_once(lambda: asg.assign_grouped_picks_stream_team(
            pool, n, packed, adj, rmask, rval, t_max)),
        granted=int((kp >= 0).sum()))
    ex.check()
    out["stream"] = stream
    report.append(
        f"  22a K1 team stream S={MAIN_S} G=16 tasks=1500 t_max={t_max}, "
        f"two chained launches with an adjustment and a reset: picks and "
        f"running equal to the plain team stream and to the single-pool "
        f"stream each launch ({stream['granted']} granted in the second); "
        f"team {stream['ms']:.4f} ms vs single pool "
        f"{stream['single_ms']:.4f} ms; plain {stream['plain_ms']:.2f} ms")

    # K2 at the policy's chunk.
    trng = np.random.default_rng(2207)
    tasks = [(int(trng.integers(0, 256)), 1, -1) for _ in range(MAIN_T)]
    batch = k2_batch(tasks, MAIN_T, dev)
    kp, kr = ka.cuda_assign_batch_team(tpool, batch, exchange=ex)
    torch.cuda.synchronize()
    ex.check()
    kr = mesh.unshard_vector(kr, team, per)
    pp, pr = asn.assign_batch_team(pool, n, batch)
    sp, sr = ka.cuda_assign_batch(pool, batch)
    same(kp, pp, "K2 team picks != plain team")
    same(kr, pr, "K2 team running != plain team")
    same(kp, sp, "K2 team picks != single pool")
    same(kr, sr, "K2 team running != single pool")
    _, _, work = k2_model(p, tasks)
    e = pool.env_bitmap.shape[1]
    moved = MAIN_S * (14 + 4 * e) + MAIN_T * 13 + MAIN_T * 4 + MAIN_S * 4
    bytes_ms = moved / H100_BYTES_PER_S * 1e3
    ops_ms = k2_ops(MAIN_S, work) / H100_OPS_PER_S * 1e3
    exch = work["reductions"]
    k2 = dict(
        ms=timed(lambda: ka.cuda_assign_batch_team(tpool, batch,
                                                   exchange=ex), 50),
        single_ms=timed(lambda: ka.cuda_assign_batch(pool, batch), 50),
        plain_ms=timed_once(lambda: asn.assign_batch_team(pool, n, batch)),
        exchanges=exch, exchange_ms=exch * team_rt_ms,
        bound_ms=max(bytes_ms, ops_ms) + exch * floor_ms,
        bound_by="bytes" if bytes_ms >= ops_ms else "operations",
        granted=int((kp >= 0).sum()))
    ex.check()
    out["k2"] = k2
    report.append(
        f"  22a K2 team of {n} S={MAIN_S} T={MAIN_T}: picks and running "
        f"equal to the plain team version and to single-pool K2 "
        f"({k2['granted']} granted); team {k2['ms']:.4f} ms vs single pool "
        f"{k2['single_ms']:.4f} ms (50 launches each); plain "
        f"{k2['plain_ms']:.2f} ms; {exch} exchanges, "
        f"{k2['exchange_ms']:.4f} ms at the team's round trip; bound "
        f"{k2['bound_ms']:.5f} ms ({k2['bound_by']} + the exchanges at the "
        f"1-slice floor)")

    # The bounded wait.  Each kernel's entry, told of n + 1 slices, waits
    # for one that never launches, runs out and sets the error word;
    # nothing hangs.  The wrapper's next call raises without launching and
    # clears the word, and the call after it runs as before.  A policy's
    # cycle that meets a fault fails, and its next cycle runs as before.
    k1_batch = asg.make_grouped_batch(gs[:4], 4, dev)
    k1_want = asg.assign_grouped_team(pool, n, k1_batch)

    def k2_call(x):
        got, run = ka.cuda_assign_batch_team(tpool, batch, exchange=x)
        return got, mesh.unshard_vector(run, team, per)

    def k1_call(x):
        c, r = kg.cuda_assign_grouped_team(tpool, k1_batch, exchange=x)
        return mesh.unshard_counts(c, tpool), mesh.unshard_vector(r, team,
                                                                  per)

    waits = {}
    for name, mod, call, want in (("K2", ka, k2_call, (pp, pr)),
                                  ("K1", kg, k1_call, k1_want)):
        bad = tx.TeamExchange()
        t0 = time.perf_counter()
        with planted_fault(mod, n):
            call(bad)
        torch.cuda.synchronize()
        waits[name] = time.perf_counter() - t0
        check(bad.error() == tx.ERR_SPIN,
              f"22a: {name} told of a missing slice set error word "
              f"{bad.error()}")
        before = (ka.team_launches, kg.team_launches)
        try:
            call(bad)
        except RuntimeError:
            check((ka.team_launches, kg.team_launches) == before,
                  f"22a: {name} launched on a faulted exchange")
        else:
            raise SmokeFailure(f"22a: {name} did not raise on its fault")
        check(bad.error() == 0, f"22a: {name}'s fault was not cleared")
        got = call(bad)
        torch.cuda.synchronize()
        bad.check(team)
        for a, b, what in zip(got, want, ("outputs", "running")):
            same(a, b, f"{name}'s {what} after a fault != plain team")
    snap = pol.PoolSnapshot(**{k: p[k] for k in asn.PoolArrays._fields})
    reqs = [pol.AssignRequest(e, v, r) for e, v, r in tasks]
    for name, mod, policy in (
            ("torch_sharded", ka, pol.TorchShardedPolicy(team=team)),
            ("torch_sharded_grouped", kg,
             pol.TorchShardedGroupedPolicy(team=team))):
        want = policy.assign(snap, reqs)
        with planted_fault(mod, n):
            try:
                policy.assign(snap, reqs)
            except RuntimeError:
                pass
            else:
                raise SmokeFailure(f"22a: {name} did not raise on its "
                                   f"fault")
        got = policy.assign(snap, reqs)
        check(got == want and sum(x >= 0 for x in got) > 0,
              f"22a: {name}'s cycle after a fault differs from before it")
    out["bounded_wait_s"] = waits
    report.append(
        "  22a bounded wait: K1 and K2 told of a fifth slice that never "
        "launches ran out of their "
        f"{TEAM_SPIN_CYCLES:,}-cycle wait, set the error word and ended "
        + ", ".join(f"{k} in {v:.3f} s" for k, v in waits.items())
        + "; each wrapper then raised without launching, cleared the word "
        "and ran its next call equal to the plain team version; "
        "torch_sharded's and torch_sharded_grouped's cycle with the fault "
        "raised and their next cycle assigned as before it")
    return out


@contextlib.contextmanager
def planted_fault(mod, n: int):
    """Every team launch of ``mod`` (ops/cuda_assign.py or cuda_grouped.py)
    inside the block calls its kernel's entry told of n + 1 slices and a
    TEAM_SPIN_CYCLES bound: its blocks wait for a slice that never comes."""
    from yadcc_tpu_torch.ops import team_exchange as tx

    fn, scratch_bytes, lib = mod._team_kernel()

    def entry(*args):
        # (..., slice ids, team size, buffer, epoch, spin limit, stream)
        args = list(args)
        check(args[-5] == n and args[-2] == tx.SPIN_LIMIT_CYCLES,
              f"22a: the team entry's arguments moved: {args[-5:]}")
        args[-5], args[-2] = n + 1, TEAM_SPIN_CYCLES
        return fn(*args)

    mod._team_fn = (entry, scratch_bytes, lib)
    try:
        yield
    finally:
        mod._team_fn = (fn, scratch_bytes, lib)


def run_team_pod(report: list, team) -> dict:
    """22b: torch_sharded_grouped serving configs[4]'s fleet (SCALE_POD,
    5,000 servants) in process over the team, pipelined at depth 16,
    with 16c's gates; then torch_sharded, synchronous.  The counts are
    set to 0 after the build and the warmups and read after the run; the
    team's K1 launches are counted at the wrapper."""
    from yadcc_tpu_torch.ops import cuda_assign as ka
    from yadcc_tpu_torch.ops import cuda_grouped as kg
    from yadcc_tpu_torch.parallel import mesh
    from yadcc_tpu_torch.scheduler import policy as tpol
    from yadcc_tpu_torch.tools import pod_sim

    parts = len(mesh.team_parts(team))
    out = {"launches": {}}
    for name, policy, depth, tasks in (
            ("sharded_grouped", "torch_sharded_grouped", SCALE_POD_DEPTH,
             TEAM_POD_TASKS),
            ("sharded", "torch_sharded", 0, TEAM_SCAN_TASKS)):
        tag = f"22b {policy}"
        t0 = time.perf_counter()
        sim = pod_sim.PodSim(SCALE_POD_SERVANTS, device=team[0],
                             pipeline_depth=depth, team=team,
                             **dict(SCALE_POD, policy=policy))
        built_s = time.perf_counter() - t0
        pol = sim.dispatcher._policy
        check(type(pol) in (tpol.TorchShardedGroupedPolicy,
                            tpol.TorchShardedPolicy)
              and pol._team == tuple(team),
              f"{tag}: the sim runs {type(pol).__name__} on "
              f"{getattr(pol, '_team', None)}")
        stream_calls = [0]
        real = mesh.sharded_assign_grouped_picks_stream

        def counted(*a, **kw):
            stream_calls[0] += 1
            return real(*a, **kw)

        zero_launches()
        kg.team_launches = ka.team_launches = 0
        mesh.sharded_assign_grouped_picks_stream = counted
        try:
            res = sim.run(tasks, SCALE_POD_DUP, SCALE_POD_SUBMITTERS)
        finally:
            mesh.sharded_assign_grouped_picks_stream = real
        n = dict(read_launches(), grouped_assign_team=kg.team_launches,
                 assign_batch_team=ka.team_launches)
        pol._exchange.check()
        b = res["breakdown"]
        check(res["tasks"] == tasks,
              f"{tag}: {res['tasks']} of {tasks} tasks accounted for")
        check(b["hit_cache"] + b["reused"] + b["actually_run"] == tasks,
              f"{tag}: the ladder does not sum: {b}")
        check(sim._dup_gids == 0, f"{tag}: {sim._dup_gids} ids twice")
        check(res["grants_granted"] == res["scheduler_stats"]["granted"],
              f"{tag}: client grants {res['grants_granted']} != scheduler "
              f"{res['scheduler_stats']['granted']}")
        check(n["grouped_assign"] == 0 and n["assign_batch"] == 0,
              f"{tag}: a single-pool kernel launched: {n}")
        stream = sim.dispatcher.inspect()["stream"]
        if depth:
            check(n["grouped_assign_team"] > 0
                  and n["assign_batch_team"] == 0,
                  f"{tag}: team launches {n}")
            check(n["grouped_assign_team"] == stream_calls[0] * parts,
                  f"{tag}: {stream_calls[0]} stream calls for "
                  f"{n['grouped_assign_team']} team K1 launches")
            check(stream["resyncs"] == 0,
                  f"{tag}: the stale-stream guard resynced: {stream}")
        else:
            check(n["assign_batch_team"] > 0
                  and n["grouped_assign_team"] == 0,
                  f"{tag}: team launches {n}")
        out["launches"][name] = n
        out[name] = {k: res[k] for k in (
            "tasks", "servants", "total_capacity", "wall_seconds",
            "tasks_per_sec", "assignments_per_sec", "breakdown",
            "grants_granted", "grant_call_p50_ms", "grant_call_p99_ms")}
        report.append(
            f"  {tag} pod_sim over the team ({len(team)} slices on "
            f"{parts} card(s)): {res['tasks']} tasks x {res['servants']} "
            f"servants (capacity {res['total_capacity']}, depth {depth}; "
            f"built and warmed in {built_s:.1f} s) in "
            f"{res['wall_seconds']} s: {res['tasks_per_sec']} tasks/s; "
            f"breakdown {json.dumps(b)}; grant call p50 "
            f"{res['grant_call_p50_ms']} ms p99 {res['grant_call_p99_ms']} "
            f"ms; no id twice; client grants = scheduler grants; launches "
            f"in the run {n}"
            + (f"; stream wrapper calls {stream_calls[0]}, dispatcher "
               f"stream {stream}" if depth else ""))
    return out


def team_bloom(report: list, team) -> dict:
    """22c: the filter-sharded membership and cascade over the team on
    phase 7's batches (1M keys of 80 bytes, 27,584,639 bits, 10 hashes;
    1/10/50% hits), held bit-equal to the host filters and to the
    one-card kernels, each slice's range kernels to their plain versions
    at 50%, timed beside the one-card kernels and the cascade's pair form
    over the whole filter (what its early exit saves); then the cascade through
    DeviceBloomCascade(team=...) and the membership through its team
    entry, with the counts set to 0 before and read after."""
    import numpy as np
    import torch

    from yadcc_tpu_torch.cache.bloom_filter_generator import \
        DeviceBloomCascade
    from yadcc_tpu_torch.ops import bloom_pipeline as bpl
    from yadcc_tpu_torch.ops import cuda_bloom as kb
    from yadcc_tpu_torch.parallel import mesh
    from yadcc_tpu_torch.tools.bloom_bench import (FLEET_HASHES, FLEET_SALT,
                                                   SALT)

    check(BLOOM_STASH.get("batches"), "22c: phase 7 left no batches")
    dev = team[0]
    region, fleet = BLOOM_STASH["region"], BLOOM_STASH["fleet"]
    nb, k = region.num_bits, region.num_hashes
    rw = mesh.shard_bloom_words(region.words, team, nb)
    fw = mesh.shard_bloom_words(fleet.words, team, nb)
    words = bpl.as_device_words(region.words, dev)
    fwords = bpl.as_device_words(fleet.words, dev)
    seed, fseed = bpl.seed_pair(SALT), bpl.seed_pair(FLEET_SALT)
    geo = dict(num_bits=nb, num_hashes=k)
    cas_geo = dict(num_bits=nb, num_hashes_region=k,
                   num_hashes_fleet=FLEET_HASHES)
    out = {}
    top = max(BLOOM_STASH["batches"])
    for rate, st in sorted(BLOOM_STASH["batches"].items()):
        length = st["length"]
        packed = bpl.as_device_words(st["packed"], dev)

        def team_m():
            return mesh.sharded_bloom_membership(rw, packed, length, seed,
                                                 team=team, **geo)

        def team_c():
            return mesh.sharded_bloom_cascade(rw, fw, packed, length, seed,
                                              fseed, team=team, **cas_geo)

        tm, tc = team_m(), team_c()
        om = kb.bloom_membership(words, packed, length, seed, **geo)
        oc = kb.bloom_cascade(words, fwords, packed, length, seed, fseed,
                              **cas_geo)
        check(np.array_equal(tm.cpu().numpy(), st["want"]),
              f"22c {rate}: team membership != host filter")
        check(np.array_equal(tc.cpu().numpy(), st["want_c"]),
              f"22c {rate}: team cascade != host OR")
        check(torch.equal(tm, om) and torch.equal(tc, oc),
              f"22c {rate}: team != one-card kernels")

        def whole_pair():
            # The pair form over the whole filter: the one-card cascade
            # without its early exit.
            return kb.bloom_cascade_pair(words, fwords, packed, length,
                                         seed, fseed, word_lo=0,
                                         **cas_geo) != 0

        check(torch.equal(whole_pair(), oc),
              f"22c {rate}: the pair form over the whole filter != the "
              f"one-card cascade")
        row = {"membership": dict(
                   ms=timed(team_m, 50),
                   one_card_ms=timed(lambda: kb.bloom_membership(
                       words, packed, length, seed, **geo), 50),
                   **st["membership_bound"]),
               "cascade": dict(
                   ms=timed(team_c, 50),
                   one_card_ms=timed(lambda: kb.bloom_cascade(
                       words, fwords, packed, length, seed, fseed,
                       **cas_geo), 50),
                   pair_whole_filter_ms=timed(whole_pair, 50),
                   **st["cascade_bound"])}
        if rate == top:
            # Each slice's range kernels against their plain versions.
            for (kk, sdev, w, lo), (_, _, f, _) in zip(
                    mesh._bloom_slices(team, rw, nb),
                    mesh._bloom_slices(team, fw, nb)):
                sp = packed.to(sdev)
                check(torch.equal(
                    kb.bloom_membership_range(w, sp, length, seed,
                                              word_lo=lo, **geo),
                    bpl.membership_range_plain(w, sp, length, seed, nb, k,
                                               lo)),
                    f"22c: slice {kk} membership range != plain")
                check(torch.equal(
                    kb.bloom_cascade_pair(w, f, sp, length, seed, fseed,
                                          word_lo=lo, **cas_geo),
                    bpl.cascade_pair_plain(w, f, sp, length, seed, fseed,
                                           nb, k, FLEET_HASHES, lo)),
                    f"22c: slice {kk} cascade pair != plain")

            def plain_m():
                return torch.stack([
                    bpl.membership_range_plain(w, packed, length, seed, nb,
                                               k, lo)
                    for _, _, w, lo in mesh._bloom_slices(team, rw,
                                                          nb)]).all(0)

            def plain_c():
                code = None
                for (_, _, w, lo), (_, _, f, _) in zip(
                        mesh._bloom_slices(team, rw, nb),
                        mesh._bloom_slices(team, fw, nb)):
                    c = bpl.cascade_pair_plain(w, f, packed, length, seed,
                                               fseed, nb, k, FLEET_HASHES,
                                               lo)
                    code = c if code is None else code & c
                return code != 0

            row["membership"]["plain_ms"] = timed_once(plain_m)
            row["cascade"]["plain_ms"] = timed_once(plain_c)
        out[str(rate)] = row
        report.append(
            f"  22c at {rate:.0%} hits ({len(st['want']):,} keys of "
            f"{length} bytes): team "
            f"membership and cascade equal to the host filters and the "
            f"one-card kernels; membership team {row['membership']['ms']:.4f}"
            f" ms vs one card {row['membership']['one_card_ms']:.4f} ms, "
            f"cascade team {row['cascade']['ms']:.4f} ms vs one card "
            f"{row['cascade']['one_card_ms']:.4f} ms (the pair form over "
            f"the whole filter, no early exit, "
            f"{row['cascade']['pair_whole_filter_ms']:.4f} ms) (50 calls "
            f"each; a team call is {len(team)} launches and the AND)")
        del packed
    # The entry points, counted: the cascade through the reader's class,
    # the membership through its team entry.
    rate, keys = BLOOM_STASH["keys"]
    st = BLOOM_STASH["batches"][rate]
    for name in kb.launches:
        kb.launches[name] = 0
    got = DeviceBloomCascade(team=team).may_contain_batch(region, fleet,
                                                          keys)
    packed = bpl.as_device_words(st["packed"], dev)
    mesh.sharded_bloom_membership(rw, packed, st["length"], seed,
                                  team=team, **geo)
    torch.cuda.synchronize()
    launched = dict(kb.launches)
    check(np.array_equal(got, st["want_c"]),
          "22c: DeviceBloomCascade(team) != host OR")
    check(launched["cascade_pair"] >= len(team)
          and launched["membership_range"] == len(team)
          and launched["cascade"] == 0 and launched["membership"] == 0,
          f"22c: entry launches {launched}")
    out["launches"] = {k: launched[k] for k in ("membership_range",
                                                "cascade_pair")}
    report.append(
        f"  22c entry points at {rate:.0%} hits: DeviceBloomCascade(team) "
        f"equal to the host OR; launches {out['launches']} (one a slice "
        f"a call)")
    return out


def run_team_path(report: list) -> dict:
    """Phase 22: 22a-c on a team of TEAM_SLICES slices over min(4, count)
    cards, cycled (on a one-card host all four on that card: the code
    and the exchange N cards would use, the cross-card case unproved)."""
    import torch

    from yadcc_tpu_torch.parallel import mesh

    team = mesh.make_team(TEAM_SLICES)
    t0 = time.perf_counter()
    out = {"team": [str(d) for d in team],
           "cards": torch.cuda.device_count()}
    out["kernels"] = walled("22a team kernels", compare_team_kernels,
                            report, team)
    out["pod"] = walled("22b team pod_sim", run_team_pod, report, team)
    out["bloom"] = walled("22c team bloom", team_bloom, report, team)
    out["seconds"] = time.perf_counter() - t0
    return out


# Phase 20's subprocess: torch and jax blocked before anything is imported.
HOST_PATH_SCRIPT = r"""
import contextlib, io, json, sys, tempfile, time
for name in ("torch", "jax", "jaxlib", "yadcc_tpu"):
    sys.modules[name] = None
from yadcc_tpu_torch.analysis.__main__ import main as analyze
from yadcc_tpu_torch.api import build_protos
from yadcc_tpu_torch.tools.scenarios import run_scenario

out = {}
t = time.perf_counter()
with tempfile.NamedTemporaryFile(suffix=".json") as rep:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out["analyze_rc"] = analyze(["yadcc_tpu_torch", "--no-cache",
                                     "--stats", "--strict-suppressions",
                                     "--json", rep.name])
    out["analyze_s"] = time.perf_counter() - t
    out["analyze_lines"] = [x for x in buf.getvalue().splitlines()
                            if "[" in x or x.startswith("ytpu-analyze")]
    out["stats"] = json.load(open(rep.name))["stats"]
t = time.perf_counter()
buf = io.StringIO()
with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(buf):
    out["check_rc"] = build_protos.check_pure()
out["check_lines"] = buf.getvalue().splitlines()
out["check_s"] = time.perf_counter() - t
t = time.perf_counter()
r = run_scenario("cell-kill", True, policy="greedy_cpu", device="cpu")
out["cell_kill"] = {k: r[k] for k in (
    "slo_ok", "slo_checks", "promoted", "double_runs", "grants_issued",
    "failover_time_ms", "compile_success_rate", "spilled_grants_stamped")}
out["cell_kill_s"] = time.perf_counter() - t
out["loaded"] = sorted(n for n in sys.modules if sys.modules[n] is not None
                       and n.split(".")[0] in ("torch", "jax", "jaxlib",
                                               "yadcc_tpu"))
print("PHASE20 " + json.dumps(out), flush=True)
"""


def start_host_path() -> subprocess.Popen:
    """Phase 20's subprocess, started while the card-bound phases 18-19
    run (its work is host CPU and loopback RPC only)."""
    return subprocess.Popen(
        [sys.executable, "-c", HOST_PATH_SCRIPT], cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def join_host_path(proc: subprocess.Popen, report: list) -> dict:
    """Phase 20: join the subprocess and hold its results."""
    try:
        stdout, stderr = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    line = next((x for x in stdout.splitlines()
                 if x.startswith("PHASE20 ")), None)
    check(proc.returncode == 0 and line is not None,
          f"20: the subprocess failed (rc {proc.returncode}): "
          f"{stderr[-2000:]}")
    r = json.loads(line[len("PHASE20 "):])
    st = r["stats"]
    check(not r["loaded"], f"20: the host path loaded {r['loaded']}")
    check(r["analyze_rc"] == 0 and st["findings"] == 0,
          "20: analyzer findings: " + "; ".join(r["analyze_lines"][-20:]))
    check(r["check_rc"] == 0,
          "20: build_protos --check drift: " + "; ".join(r["check_lines"]))
    ck = r["cell_kill"]
    check(ck["slo_ok"], f"20: cell-kill on greedy_cpu: {ck['slo_checks']}")
    check(ck["promoted"] == 1 and ck["double_runs"] == 0,
          f"20: cell-kill promoted {ck['promoted']}, double runs "
          f"{ck['double_runs']}")
    fam = ", ".join(f"{k} {v * 1e3:.1f}" for k, v in sorted(
        st["timings"].items(), key=lambda kv: -kv[1]))
    report.append(
        f"  20a analyzer over yadcc_tpu_torch/ (torch and jax blocked): "
        f"{st['files_analyzed']} files, {st['findings']} findings, "
        f"{st['suppressed']} suppressed, strict; {r['analyze_s']:.2f} s "
        f"wall; families (ms): {fam}")
    report.append(
        f"  20b build_protos --check: rc {r['check_rc']} in "
        f"{r['check_s']:.2f} s: " + "; ".join(r["check_lines"]))
    report.append(
        f"  20c cell-kill (smoke size) on greedy_cpu without torch: slo_ok "
        f"{ck['slo_ok']}, promoted {ck['promoted']}, double runs "
        f"{ck['double_runs']}, {ck['grants_issued']} grants, failover "
        f"{ck['failover_time_ms']} ms, {ck['spilled_grants_stamped']} "
        f"spilled, in {r['cell_kill_s']:.2f} s; modules loaded of torch, "
        f"jax, the JAX package: none")
    return r


# ---------------------------------------------------------------------------
# Phase 21: the scenario canaries on the card.
# ---------------------------------------------------------------------------

# The canaries whose scenarios run a scheduler or the placement scorer on
# the card (the policy is auto).  The other nine name greedy_cpu or run
# host code only; the CPU tests hold them.
CARD_CANARIES = ("quick_hostile_metrics", "quick_spill_affinity_metrics",
                 "quick_coldregion_metrics", "quick_tenancy_metrics")
RATE_KEYS = ("survival_compile_success_rate", "cell_kill_success_rate",
             "placement_warm_hit_rate", "l3_read_through_hit_rate")


def run_canary_path(report: list) -> dict:
    """Phase 21: each canary of CARD_CANARIES with device="cuda", its
    launch counts set to 0 just before it and read just after.  Every
    value must be a finite number, every rate within [0, 1], the tenancy
    isolation bit 1, and the placement kernel must launch in
    spill-affinity; K1's count is printed (auto keeps a shallow cycle on
    the host)."""
    import logging
    import math

    import torch

    from yadcc_tpu_torch.ops import cuda_bloom as kb
    from yadcc_tpu_torch.tools import scenarios

    t0 = time.perf_counter()
    res = {"launches": {}, "values": {}, "placement_launches": 0}
    # The rigs' cache servers log a line a fill at INFO.
    root_log = logging.getLogger()
    level = root_log.level
    root_log.setLevel(logging.WARNING)
    try:
        for tag, name in zip("abcd", CARD_CANARIES):
            zero_launches()
            for k in kb.launches:
                kb.launches[k] = 0
            t = time.perf_counter()
            values = getattr(scenarios, name)(device="cuda")
            wall = time.perf_counter() - t
            launches = read_launches()
            placed = kb.launches["placement_score"]
            for k, v in values.items():
                check(isinstance(v, (int, float)) and math.isfinite(v),
                      f"21 {name}: {k} = {v!r}")
                if k in RATE_KEYS:
                    check(0.0 <= v <= 1.0, f"21 {name}: {k} = {v}")
            if name == "quick_tenancy_metrics":
                check(values["cross_tenant_isolation_ok"] == 1,
                      f"21 {name}: cache isolation broke: {values}")
            if name == "quick_spill_affinity_metrics":
                check(placed > 0,
                      "21 spill-affinity: the placement kernel never "
                      "launched")
                res["placement_launches"] = placed
            res["values"][name] = values
            res["launches"][f"phase21{tag}_{name}"] = launches
            report.append(
                f"  21{tag} {name}(device='cuda') ({wall:.1f} s): "
                f"{json.dumps(values)}; K1 launches "
                f"{launches['grouped_assign']}, K2 "
                f"{launches['assign_batch']}, placement kernel {placed}")
    finally:
        root_log.setLevel(level)
    torch.cuda.synchronize()
    res["seconds"] = time.perf_counter() - t0
    res["report"] = report
    return res


# Phase 21's subprocess: the canaries and their counts in a process of
# their own, on the libraries phase 1 built.
CANARY_SCRIPT = r"""
import json
import chip_smoke
res = chip_smoke.run_canary_path([])
print("PHASE21 " + json.dumps(res), flush=True)
"""


def start_canary_path() -> subprocess.Popen:
    """Phase 21's subprocess, started while phase 15 runs (whose time
    goes to g++ processes and the clients' long polls); its output goes
    to files in LOG_DIR, read when it is joined."""
    LOG_DIR.mkdir(exist_ok=True)
    with open(LOG_DIR / "phase21.out", "w") as out, \
            open(LOG_DIR / "phase21.err", "w") as err:
        return subprocess.Popen([sys.executable, "-c", CANARY_SCRIPT],
                                cwd=REPO, stdout=out, stderr=err)


def join_canary_path(proc: subprocess.Popen, report: list) -> dict:
    """Phase 21: join the subprocess and take its results."""
    try:
        proc.wait(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    stdout = (LOG_DIR / "phase21.out").read_text()
    line = next((x for x in stdout.splitlines()
                 if x.startswith("PHASE21 ")), None)
    check(proc.returncode == 0 and line is not None,
          f"21: the subprocess failed (rc {proc.returncode}): "
          f"{(LOG_DIR / 'phase21.err').read_text()[-3000:]}")
    res = json.loads(line[len("PHASE21 "):])
    report.extend(res["report"])
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

    built = walled("1 build", build_kernels)
    log(f"phase 1 build (wall {built.pop('total_s'):.2f} s): " + "; ".join(
        f"{src} -> {b['library']} (nvcc {b['nvcc_s']:.2f} s)"
        for src, b in built.items()))

    report: list = []
    timing = walled("2 compare_kernel", compare_kernel, report)
    walled("2 compare_resident_step", compare_resident_step, report)
    walled("2 compare_shard_grid", compare_shard_grid, report)
    grid = walled("2 time_shard_grid", time_shard_grid, report)
    k2 = walled("2 compare_assign_batch", compare_assign_batch, report)
    walled("2 compare_placement", compare_placement, report)
    place = walled("2 time_placement", time_placement, report)
    log("phase 2 kernels vs plain (tolerance 0):")
    for line in report:
        log(line)

    report = []
    profiler_imports = preload_profiler_imports()
    phases = {
        "pipelined": walled("3 pipelined", run_main_path, "pipelined", [],
                            Fleet(seed=1), report),
        "synchronous": walled(
            "4 synchronous", run_main_path, "synchronous",
            ["--dispatch-pipeline-depth", "0"], Fleet(seed=2), report),
        "batched": walled(
            "5 batched", run_main_path, "batched",
            ["--dispatch-policy", "torch_batched"], Fleet(seed=3), report,
            kernel="assign_batch"),
        "resident": walled(
            "6 resident", run_main_path, "resident",
            ["--dispatch-policy", "torch_resident_grouped",
             "--dispatch-pipeline-depth", "16"], Fleet(seed=4), report,
            min_grants=RESIDENT_MIN_GRANTS),
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
    walled("7 compare_bloom_edges", compare_bloom_edges, report)
    walled("7 compare_bloom_raw", compare_bloom_raw, report)
    walled("7 compare_bloom_layouts", compare_bloom_layouts, report)
    bloom_timing = walled("7 compare_bloom_main", compare_bloom_main, report)
    bloom_run = walled("7 bloom_bench", run_bloom_main_path, report)
    log(f"phase 7 the Bloom path ({time.perf_counter() - t7:.1f} s; "
        f"kernels vs plain at tolerance 0):")
    for line in report:
        log(line)

    report = []
    phases["sharded"] = walled(
        "8 sharded", run_main_path, "sharded", ["--shards", str(SHARDS)],
        Fleet(seed=5), report, shards=SHARDS, min_grants=SHARDED_MIN_GRANTS)
    walled("8 profiler imports", profiler_imports.join)
    overlap = walled("8 overlap", measure_shard_overlap, report)
    fused = walled("9 fused", run_fused_path, report)
    phases["fused"] = {"launches": {"grouped_assign": fused["launches"],
                                    "assign_batch": fused["k2_launches"]}}
    log("phases 8-9 the sharded scheduler:")
    for line in report:
        log(line)

    report = []
    takeover = walled("10 takeover", run_takeover_path, report)
    phases["takeover"] = {"launches": takeover["launches"]}
    federation = walled("11 federation", run_federation_path, report, place)
    phases["federation"] = {"launches": {
        "grouped_assign": federation["k1_launches"],
        "assign_batch": federation["k2_launches"]}}
    log("phases 10-11 warm standby and federation:")
    for line in report:
        log(line)

    report = []
    t12 = time.perf_counter()
    walled("12-13 aio", run_aio_path, report, phases)
    log(f"phases 12-13 the aio front end ({time.perf_counter() - t12:.1f} "
        f"s):")
    for line in report:
        log(line)

    report = []
    t14 = time.perf_counter()
    cache = walled("14 cache", run_cache_path, report)
    log(f"phase 14 the cache server and its reader on the card "
        f"({time.perf_counter() - t14:.1f} s; {card}):")
    for line in report:
        log(line)

    report = []
    t15 = time.perf_counter()
    canary_path = start_canary_path()
    try:
        daemon = walled("15 daemon with 17 jit", run_daemon_path, report)
    except BaseException:
        canary_path.kill()
        canary_path.wait()
        raise
    phases["daemon"] = {"launches": daemon["launches"]}
    log(f"phase 15 the daemon, both halves "
        f"({time.perf_counter() - t15:.1f} s; {card}):")
    for line in report:
        log(line)

    report = []
    canaries = walled("21 join", join_canary_path, canary_path, report)
    for name, n in canaries["launches"].items():
        phases[name] = {"launches": n}
    log(f"phase 21 the scenario canaries on the card (a subprocess beside "
        f"phase 15: {canaries['seconds']:.1f} s; join "
        f"{WALLS['21 join']:.2f} s; {card}):")
    for line in report:
        log(line)

    report = []
    scale = walled("16 scale", run_scale_path, report)
    for name, n in scale["launches"].items():
        phases[name] = {"launches": n}
    log(f"phase 16 the scale harnesses: trace replay and pod_sim "
        f"({scale['seconds']:.1f} s; {card}):")
    for line in report:
        log(line)

    jit = daemon["jit"]
    phases["jit"] = {"launches": jit["launches"]}
    log(f"phase 17 the jit, AOT and autotune workloads on phase 15's aio "
        f"fleet, nvcc on its servants ({jit['seconds']:.1f} s; {card}):")
    for line in jit["lines"]:
        log(line)

    host_path = start_host_path()
    try:
        report = []
        tools = walled("18 tools", run_tools_path, report)
        for name, n in tools["launches"].items():
            phases[name] = {"launches": n}
        log(f"phase 18 lock-order tracing and the cluster sweep "
            f"({tools['seconds']:.1f} s; {card}):")
        for line in report:
            log(line)

        report = []
        hostile = walled("19 hostile", run_hostile_path, report)
        for name, n in hostile["launches"].items():
            phases[name] = {"launches": n}
        log(f"phase 19 the hostile-world scenarios and the native client "
            f"farm ({hostile['seconds']:.1f} s; {card}):")
        for line in report:
            log(line)
    except BaseException:
        host_path.kill()
        host_path.communicate()
        raise

    report = []
    walled("20 join", join_host_path, host_path, report)
    log(f"phase 20 the static analyzer, build_protos and the torch-free "
        f"host path (subprocess started before phase 18; join "
        f"{WALLS['20 join']:.2f} s):")
    for line in report:
        log(line)

    report = []
    team = walled("22 team", run_team_path, report)
    BLOOM_STASH.clear()
    log(f"phase 22 the team: {TEAM_SLICES} slices on {team['team']} "
        f"({team['cards']} card(s) on this host: with one, every slice on "
        f"it, the cross-card exchange unproved) in {team['seconds']:.1f} "
        f"s; {card}:")
    for line in report:
        log(line)
    log(f"walls of phases 17, 18 and 22 (s): 17 {jit['seconds']:.1f}, 18 "
        f"{WALLS['18 tools']}, 22 {WALLS['22 team']}")

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
    for i, kernel in ((2, "membership"), (3, "cascade")):
        by = {"phase7_bloom_bench": bloom_run["launches"][kernel],
              "phase14_cache_reader": cache["launches"][kernel],
              "phase16_scale": scale["bloom_launches"].get(kernel, 0)}
        record["kernels"][i]["launches"] = sum(by.values())
        record["kernels"][i]["launches_by_phase"] = by
        record["kernels"][i]["cache_reader_batch_ms"] = {
            rate: row[kernel]["seconds"] * 1e3
            for rate, row in cache["batches"].items()}
    record["kernels"][2]["fused_split_ms"] = {
        str(s["hit_rate"]): {
            k.replace("_seconds", ""): s["device_fused"][k] * 1e3
            for k in ("pack_seconds", "upload_seconds", "kernel_seconds",
                      "end_to_end_seconds")}
        for s in bloom_run["bench"]["sweep"]}
    place_by = {"phase11_federation": federation["launches"][
                    "placement_score"],
                "phase19c_spill_affinity": hostile["placement_launches"],
                "phase21b_spill_affinity": canaries["placement_launches"]}
    record["kernels"].append({
        "name": "placement_score",
        "route": "cuda",
        "source": "yadcc_tpu_torch/csrc/bloom.cu",
        "replaces": "yadcc_tpu/parallel/mesh.py:698",
        "launches": sum(place_by.values()),
        "launches_by_phase": place_by,
        "spill_affinity_placement_score_p99_us":
            hostile["placement_score_p99_us"],
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
    tk, tpod, tbl = team["kernels"], team["pod"], team["bloom"]
    team_shape = {"slices": TEAM_SLICES, "team": team["team"],
                  "cards": team["cards"]}
    record["kernels"].append({
        "name": "grouped_assign_team",
        "route": "cuda",
        "source": "yadcc_tpu_torch/csrc/grouped_assign.cu",
        "replaces": "yadcc_tpu/parallel/mesh.py:257",
        "launches": tpod["launches"]["sharded_grouped"][
            "grouped_assign_team"],
        "launches_by_phase": {
            "phase22b_sharded_grouped": tpod["launches"]["sharded_grouped"][
                "grouped_assign_team"]},
        "max_abs_err": 0,
        "ms": tk[MAIN_G]["ms"],
        "plain_ms": tk[MAIN_G]["plain_ms"],
        "bound_ms": tk[MAIN_G]["bound_ms"],
        "bound_by": tk[MAIN_G]["bound_by"],
        "library_ms": None,
        "single_pool_ms": tk[MAIN_G]["single_ms"],
        "exchanges": tk[MAIN_G]["exchanges"],
        "exchange_ms": tk[MAIN_G]["exchange_ms"],
        "exchange_round_trip_us": tk["round_trip_us"],
        "exchange_floor_us": tk["floor_us"],
        "exchange_round_trip_us_by_slices_one_card":
            tk["round_trip_us_by_slices_one_card"],
        "at_G8": {k: tk[8][k] for k in ("ms", "single_ms", "plain_ms",
                                         "bound_ms", "exchanges",
                                         "exchange_ms")},
        "stream": tk["stream"],
        "shape": {"S": MAIN_S, "G": MAIN_G, "tasks": MAIN_TASKS, "E": 8,
                  **team_shape},
    })
    record["kernels"].append({
        "name": "assign_batch_team",
        "route": "cuda",
        "source": "yadcc_tpu_torch/csrc/assign_batch.cu",
        "replaces": "yadcc_tpu/parallel/mesh.py:131",
        "launches": tpod["launches"]["sharded"]["assign_batch_team"],
        "launches_by_phase": {
            "phase22b_sharded": tpod["launches"]["sharded"][
                "assign_batch_team"]},
        "max_abs_err": 0,
        "ms": tk["k2"]["ms"],
        "plain_ms": tk["k2"]["plain_ms"],
        "bound_ms": tk["k2"]["bound_ms"],
        "bound_by": tk["k2"]["bound_by"],
        "library_ms": None,
        "single_pool_ms": tk["k2"]["single_ms"],
        "exchanges": tk["k2"]["exchanges"],
        "exchange_ms": tk["k2"]["exchange_ms"],
        "exchange_floor_us": tk["floor_us"],
        "shape": {"S": MAIN_S, "T": MAIN_T, "E": 8, **team_shape},
    })
    top = max(tbl, key=lambda r: float(r) if r != "launches" else -1)
    for name, kernel, fn, replaces in (
            ("bloom_membership_range", "membership_range", "membership",
             "yadcc_tpu/parallel/mesh.py:421"),
            ("bloom_cascade_pair", "cascade_pair", "cascade",
             "yadcc_tpu/parallel/mesh.py:478")):
        t = tbl[top][fn]
        record["kernels"].append({
            "name": name,
            "route": "cuda",
            "source": "yadcc_tpu_torch/csrc/bloom.cu",
            "replaces": replaces,
            "launches": tbl["launches"][kernel],
            "launches_by_phase": {"phase22c_entry": tbl["launches"][kernel]},
            "max_abs_err": 0,
            "ms": t["ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"],
            "library_ms": None,
            "one_card_ms": t["one_card_ms"],
            "at_hit_rates": {r: {k: tbl[r][fn][k] for k in
                                 ("ms", "one_card_ms", "bound_ms")}
                             for r in tbl if r != "launches"},
            "shape": dict(bloom_shape, **team_shape),
        })
    log("main paths ({}): {}; fused {} cycles in {:.2f} s; total {:.1f} "
        "s".format(card, "; ".join(
            f"{name} {r['grants_per_s']:.1f} grants/s p99 {r['p99_ms']:.2f} "
            f"ms" for name, r in phases.items() if "p99_ms" in r),
            fused["cycles"], fused["seconds"], time.perf_counter() - t_start))
    log("walls (s): " + json.dumps(WALLS))
    print(json.dumps(record), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
