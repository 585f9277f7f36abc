"""Synthetic build sweep through the full control plane (a copy of the
JAX package's yadcc_tpu/tools/cluster_sim.py whose cluster is the
port's: the scheduler's policy runs on ``--device``, the card unless
the caller asks for the CPU).

Boots the REAL cluster (scheduler + cache server + N servant daemons +
delegate, over real loopback gRPC) with a fake instant compiler, then
pushes a synthetic build of `--tasks` translation units through the
delegate's production pipeline (Bloom gate, cache read, duplicate-task
join, grant acquisition, servant RPC, execution engine, async cache
fill) and reports end-to-end task throughput and latency percentiles
plus the hit/reuse/run breakdown.

    python -m yadcc_tpu_torch.tools.cluster_sim --tasks 2000 --servants 4
    python -m yadcc_tpu_torch.tools.cluster_sim --device cpu --tasks 200

Duplicate sources (--dup-rate) exercise the dedup/join path; a second
pass over the same sources exercises the distributed cache.  Numbers
scale with host cores (each "compile" is a real subprocess); the point
is a reproducible end-to-end artifact, not a hardware claim.  Which
duplicates are hits, joins or runs depends on timing, so two runs (or
the two packages) agree on the corpus and on the invariants (no
failure, every task resolved, every unique source run at least once),
not on the counts.

`--workload jit` swaps the TU corpus for a synthetic module corpus with
a duplicate-heavy pick distribution (a fleet builds the same handful of
steps over and over: far more duplication than a C++ build) and runs it
through the SAME delegates via the jit DistributedTask.  Compiles are
the deterministic fake worker (YTPU_JIT_FAKE_WORKER=1 for the cluster's
lifetime): the farm is under test.  The module text is the JAX
package's corpus byte for byte, an opaque payload to the fake worker,
not something nvcc builds; the tasks name the port's environment
(``("cuda", nvcc's release line)``, jit/env.py).  Adds
``jit_compiles_per_sec`` and ``dedup_ratio`` (fraction of submissions
that did NOT cost a servant compile) to the report.

`--workload aot` and `--workload autotune` drive the fan-out kinds:
every submission is a PARENT that the delegate expands into
per-topology compiles / per-slice sweeps, so the sim measures the one
scheduler shape the 1:1 workloads never stress.  Parents are
Zipf-duplicated like the jit corpus; reports add
``aot_topology_compiles_per_sec`` / ``autotune_sweeps_per_sec``, the
fan-out width distribution, per-workload ``dedup_ratio`` (fraction of
child resolutions that did NOT cost a servant compile), and explicit
``lost_or_hung`` accounting.

`--clients N` (the connection storm), `--servant-park N` and
`--steal-ab N` price the front ends and the loop-native steal path.
`--scenario NAME|all` runs the hostile-world matrix instead
(tools/scenarios.py).
The module imports no torch at the top: the storm's server subprocess
(`_storm_server_main`) prices only the delegate's front end and must
not load it.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import tempfile
import threading
import time
from pathlib import Path

import numpy as np


def _parse_tu_size_dist(spec: str):
    """Size sampler for --tu-size-dist: ``fixed:N``, ``uniform:MIN:MAX``,
    or the ``byte-heavy`` preset (uniform 1MB..4MB: preprocessed-C++
    scale TUs that make the byte path, not the control plane, the
    bottleneck).  Returns sampler(rng) -> int, or None for the classic
    tiny synthetic TUs."""
    if not spec:
        return None
    if spec == "byte-heavy":
        spec = "uniform:1048576:4194304"
    kind, _, rest = spec.partition(":")
    if kind == "fixed":
        n = int(rest)
        return lambda rng: n
    if kind == "uniform":
        lo_s, _, hi_s = rest.partition(":")
        lo, hi = int(lo_s), int(hi_s)
        return lambda rng: int(rng.integers(lo, hi + 1))
    raise ValueError(f"bad --tu-size-dist {spec!r}")


def _make_sized_sources(n_unique: int, sampler, rng):
    """Unique TU sources at sampled sizes.  Content is code-like text —
    repetitive tokens with per-line variation, compressing roughly like
    preprocessed C++ (~10:1) rather than like random bytes — plus a
    unique header so every TU digests differently."""
    pool = b"".join(
        b"inline int ytpu_fn_%d(int v) { return v * %d + %d; }\n"
        % (i, i % 97, i % 13) for i in range(10000))
    sources = []
    for i in range(n_unique):
        size = sampler(rng)
        head = f"// TU {i}\nint f{i}() {{ return {i}; }}\n".encode()
        body = b""
        need = max(0, size - len(head))
        off = int(rng.integers(0, max(1, len(pool) - 1)))
        while len(body) < need:
            body += pool[off:off + need - len(body)]
            off = 0
        sources.append(head + body)
    return sources


def _make_stablehlo_corpus(n_unique: int, rng):
    """Unique synthetic StableHLO-text modules of build-realistic sizes
    (a lowered train step is tens-to-hundreds of KB of MLIR text), byte
    for byte the JAX package's corpus for a seed.  Content is
    module-shaped text so the compression ratio resembles real
    lowerings, with a unique header so every module digests
    differently.  An opaque payload to the fake worker: nvcc never
    builds it."""
    body_pool = b"".join(
        b'    %%v%d = "stablehlo.add"(%%a%d, %%b%d) : '
        b"(tensor<8x128xf32>, tensor<8x128xf32>) -> tensor<8x128xf32>\n"
        % (i, i % 331, i % 257) for i in range(4000))
    modules = []
    for i in range(n_unique):
        size = int(rng.integers(16 << 10, 192 << 10))
        head = (f"module @jit_step_{i} attributes "
                f"{{ytpu.sim_id = {i} : i32}} {{\n").encode()
        modules.append(head + body_pool[:size] + b"}\n")
    return modules


def _zipf_picks(tasks: int, n_unique: int, rng):
    """Duplicate-heavy pick distribution: every unique module appears
    at least once, and the duplicate mass is Zipf-weighted toward a hot
    head — a fleet re-jitting the same few model steps, not a uniform
    spread of duplicates."""
    extra = tasks - n_unique
    ranks = rng.zipf(1.3, size=extra)
    picks = list(range(n_unique)) + [int(r - 1) % n_unique for r in ranks]
    rng.shuffle(picks)
    return picks


# Topology family the AOT sim draws from: the 1- and 2-level mesh
# shapes of parallel/mesh.py's partitioned_shard_bounds layouts.
_AOT_TOPOLOGY_FAMILY = ((1,), (2,), (4,), (2, 2), (8,), (2, 4))


def _make_aot_plans(n_unique: int, rng):
    """Per-unique-parent topology lists (2..5 distinct topologies from
    the family).  Duplicated parents reuse the SAME list — identical
    submissions must produce identical child sets or the dedup
    measurement lies."""
    from ..jit.fanout import TopologySpec

    plans = []
    for _ in range(n_unique):
        k = int(rng.integers(2, min(5, len(_AOT_TOPOLOGY_FAMILY)) + 1))
        chosen = rng.choice(len(_AOT_TOPOLOGY_FAMILY), size=k,
                            replace=False)
        topos = []
        for idx in sorted(int(i) for i in chosen):
            shape = _AOT_TOPOLOGY_FAMILY[idx]
            count = 1
            for d in shape:
                count *= d
            topos.append(TopologySpec(mesh_shape=shape,
                                      device_count=count).validate())
        plans.append(topos)
    return plans


def _make_autotune_plans(n_unique: int, rng):
    """Per-unique-kernel (config list, fan-out width) pairs: a small
    block/grid cartesian space, swept 2..4 slices wide."""
    from ..jit.autotune import SearchSpace

    plans = []
    for _ in range(n_unique):
        blocks_m = [int(b) for b in
                    rng.choice([32, 64, 128, 256], size=2, replace=False)]
        blocks_n = [int(b) for b in
                    rng.choice([32, 64, 128, 256], size=2, replace=False)]
        grids = [int(g) for g in rng.choice([1, 2, 4, 8], size=2,
                                            replace=False)]
        configs = SearchSpace.of(block_m=sorted(blocks_m),
                                 block_n=sorted(blocks_n),
                                 grid=sorted(grids)).expand()
        plans.append((configs, int(rng.integers(2, 5))))
    return plans


def _make_kernel_corpus(n_unique: int, rng):
    """Unique synthetic kernel templates ({block_m}/{block_n}/{grid}
    placeholders, Pallas-shaped text) at realistic sizes, byte for byte
    the JAX package's for a seed: an opaque payload to the fake worker,
    not something nvcc builds."""
    body = (b"    acc = jnp.zeros(({block_m}, {block_n}), "
            b"jnp.float32)  # grid {grid}\n") * 64
    kernels = []
    for i in range(n_unique):
        head = (f"# kernel {i}\ndef matmul_kernel_{i}"
                f"(x_ref, y_ref, o_ref):\n").encode()
        size = int(rng.integers(2 << 10, 24 << 10))
        kernels.append(head + body[:size])
    return kernels


def make_corpus(workload: str, tasks: int, n_unique: int,
                tu_size_dist: str, rng):
    """(sources, picks, aot_plans, tune_plans) of one sweep: the unique
    sources and which of them each of ``tasks`` submissions sends, drawn
    from ``rng`` exactly as the JAX package's run() draws them, so a
    seed gives both packages the same bytes."""
    aot_plans = tune_plans = None
    if workload in ("jit", "aot", "autotune"):
        picks = _zipf_picks(tasks, n_unique, rng)
        if workload == "aot":
            sources = _make_stablehlo_corpus(n_unique, rng)
            aot_plans = _make_aot_plans(n_unique, rng)
        elif workload == "autotune":
            sources = _make_kernel_corpus(n_unique, rng)
            tune_plans = _make_autotune_plans(n_unique, rng)
        else:
            sources = _make_stablehlo_corpus(n_unique, rng)
        return sources, picks, aot_plans, tune_plans
    sampler = _parse_tu_size_dist(tu_size_dist)
    if sampler is None:
        sources = [
            f"// TU {i}\nint f{i}() {{ return {i}; }}\n".encode()
            for i in range(n_unique)]
    else:
        sources = _make_sized_sources(n_unique, sampler, rng)
    picks = list(range(n_unique)) + list(
        rng.integers(0, n_unique, tasks - n_unique))
    # Interleave duplicates with their originals so some arrive while the
    # original is still compiling (the join/ReferenceTask path), and some
    # after (the cache path).
    rng.shuffle(picks)
    return sources, picks, aot_plans, tune_plans


def run(tasks: int, servants: int, concurrency: int, dup_rate: float,
        policy: str = "auto", in_flight: int = 0, compile_s: float = 0.05,
        delegates: int = 1, tu_size_dist: str = "",
        workload: str = "cxx", device: str = "cuda") -> dict:
    """One sweep; ``policy`` is the scheduler's --dispatch-policy name,
    run on ``device``."""
    from ..common import compress
    from ..common.hashing import digest_bytes, digest_file
    from ..common.payload import copy_stats
    from ..daemon.local.aot_task import AotBuildTask
    from ..daemon.local.autotune_task import AutotuneSweepTask
    from ..daemon.local.cxx_task import CxxCompilationTask
    from ..daemon.local.jit_task import JitCompilationTask
    from ..jit.env import local_jit_environment
    from ..testing import LocalCluster, make_fake_compiler

    if workload not in ("cxx", "jit", "aot", "autotune"):
        raise ValueError(f"unknown workload {workload!r}")
    worker_workloads = ("jit", "aot", "autotune")
    # NB: no "ytpu" in the path: CompilerRegistry treats paths
    # containing the client-wrapper markers as wrappers and skips them.
    tmp = Path(tempfile.mkdtemp(prefix="csim_"))
    saved_env = {k: os.environ.get(k)
                 for k in ("YTPU_JIT_FAKE_WORKER", "YTPU_JIT_FAKE_SLEEP_S")}
    if workload in worker_workloads:
        # Deterministic pseudo-compiles with the same duration knob the
        # fake g++ gets: measure the farm, not the compiler.
        os.environ["YTPU_JIT_FAKE_WORKER"] = "1"
        os.environ["YTPU_JIT_FAKE_SLEEP_S"] = str(compile_s)
        compiler_dirs = []
    else:
        compiler = make_fake_compiler(str(tmp / "bin"),
                                      compile_s=compile_s)
        compiler_digest = digest_file(compiler)
        compiler_dirs = [str(tmp / "bin")]
    cluster = LocalCluster(
        tmp, n_servants=servants, policy=policy, device=device,
        servant_concurrency=concurrency,
        compiler_dirs=compiler_dirs)
    # Several "build machines": each extra delegate owns its own grant
    # keeper and running-task snapshot, so duplicate TUs can join
    # across machines (the cluster-wide dedup path).
    delegates = max(1, delegates)
    all_delegates = [cluster.delegate] + [
        cluster.make_extra_delegate() for _ in range(delegates - 1)]

    n_unique = max(1, int(tasks * (1.0 - dup_rate)))
    sources, picks, aot_plans, tune_plans = make_corpus(
        workload, tasks, n_unique, tu_size_dist, np.random.default_rng(1))
    if workload in worker_workloads:
        jit_env = local_jit_environment()

    def make_task(i: int):
        src = sources[picks[i]]
        if workload == "jit":
            return JitCompilationTask(
                requestor_pid=1,
                computation_digest=digest_bytes(src),
                compile_options=b"",
                backend=jit_env.backend,
                toolchain_version=jit_env.toolchain_version,
                cache_control=1,
                compressed_computation=compress.compress(src),
            )
        if workload == "aot":
            return AotBuildTask(
                requestor_pid=1,
                computation_digest=digest_bytes(src),
                backend=jit_env.backend,
                toolchain_version=jit_env.toolchain_version,
                cache_control=1,
                topologies=list(aot_plans[picks[i]]),
                compressed_computation=compress.compress(src),
            )
        if workload == "autotune":
            configs, width = tune_plans[picks[i]]
            return AutotuneSweepTask(
                requestor_pid=1,
                kernel_digest=digest_bytes(src),
                backend=jit_env.backend,
                toolchain_version=jit_env.toolchain_version,
                cache_control=1,
                configs=list(configs),
                fanout_width=width,
                compressed_kernel=compress.compress(src),
            )
        return CxxCompilationTask(
            requestor_pid=1,
            source_path=f"/src/tu{picks[i]}.cc",
            source_digest=digest_bytes(src),
            invocation_arguments="-O2",
            cache_control=1,
            compiler_digest=compiler_digest,
            compressed_source=compress.compress(src),
        )

    # Like a build system's -j: keep some queuing pressure but don't
    # oversubscribe the rig (each in-flight TU is a thread + RPCs).
    # Fan-out parents each expand into ~mean-width grant waiters, so
    # the parent window shrinks by that factor — otherwise child-level
    # demand runs at width× the other workloads' pressure and the
    # scheduler's overload ladder (correctly) walks to REJECT and
    # sheds the whole sim, which has no local-compile fallback to
    # shed to.
    if not in_flight:
        in_flight = 2 * servants * concurrency
        if workload == "aot":
            mean_w = float(np.mean([len(p) for p in aot_plans]))
            in_flight = max(2, int(in_flight / mean_w))
        elif workload == "autotune":
            mean_w = float(np.mean([w for _, w in tune_plans]))
            in_flight = max(2, int(in_flight / mean_w))
    latencies = []
    failures = []
    lost = []  # hung past every retry's generous timeout
    lock = threading.Lock()
    work = list(range(tasks))

    def submit_and_wait(i: int):
        delegate = all_delegates[i % len(all_delegates)]
        t0 = time.perf_counter()
        # The real client retries infrastructure failures (negative
        # exit codes) up to 5 times before giving up — backpressure
        # under load is expected, not fatal (reference
        # yadcc-cxx.cc:191-248).
        for _ in range(5):
            tid = delegate.queue_task(make_task(i))
            result = delegate.wait_for_task(tid, timeout_s=120.0)
            delegate.free_task(tid)
            if result is not None and result.exit_code >= 0:
                break
        dt = time.perf_counter() - t0
        with lock:
            if result is None:
                lost.append(i)
                failures.append(i)
            elif result.exit_code != 0:
                failures.append(i)
            else:
                latencies.append(dt)

    def worker():
        while True:
            with lock:
                if not work:
                    return
                i = work.pop()
            submit_and_wait(i)

    source_bytes_total = sum(len(sources[picks[i]]) for i in range(tasks))
    copies0 = copy_stats()["copies"]
    # Tight Bloom sync for the rig: the production 10s replica cadence
    # is longer than a whole smoke run, which would misreport the dedup
    # ratio as near-zero when the cache in fact absorbed the
    # duplicates.  One syncer covers every delegate (they share the
    # cluster's reader).
    sync_stop = threading.Event()

    def _bloom_syncer():
        while not sync_stop.wait(timeout=0.25):
            cluster.cache_reader.sync_once()

    threading.Thread(target=_bloom_syncer, name="sim-bloom-sync",
                     daemon=True).start()
    try:
        t_start = time.perf_counter()
        threads = [threading.Thread(target=worker, daemon=True)
                   for _ in range(in_flight)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        wall = time.perf_counter() - t_start

        def pctl(q):
            if not latencies:  # all-failed run: report, don't crash
                return None
            return round(float(np.percentile(
                np.array(latencies) * 1000, q)), 1)

        stats = {k: sum(d.inspect()["stats"][k] for d in all_delegates)
                 for k in ("hit_cache", "reused", "actually_run", "failed")}
        out = {
            "workload": workload,
            "tasks": tasks,
            "delegates": delegates,
            "servants": servants,
            "servant_concurrency": concurrency,
            "policy": policy,
            "wall_seconds": round(wall, 2),
            "tasks_per_sec": round(tasks / wall, 1),
            "failures": len(failures),
            "p50_latency_ms": pctl(50),
            "p99_latency_ms": pctl(99),
            "breakdown": stats,
        }
        if workload == "jit":
            # Dedup ratio: fraction of resolved submissions that did
            # NOT cost a servant compile (cache hit or in-flight join)
            # — the cluster-wide dedup claim in one number.
            resolved = sum(stats.values()) - stats["failed"]
            out["jit_compiles_per_sec"] = round(tasks / wall, 1)
            out["servant_compiles"] = stats["actually_run"]
            out["dedup_ratio"] = round(
                1.0 - stats["actually_run"] / max(1, resolved), 3)
        if workload in ("aot", "autotune"):
            # Fan-out provenance comes from the per-kind counters:
            # children (and, for autotune, sweep-level parent hits)
            # bump hit_cache/reused/actually_run through the normal
            # dispatch path, so "resolved" counts every child verdict
            # plus every whole-sweep cache shortcut.
            kind = {k: sum(d.inspect()["stats_by_kind"]
                           .get(workload, {}).get(k, 0)
                           for d in all_delegates)
                    for k in ("hit_cache", "reused", "actually_run",
                              "failed")}
            resolved = (kind["hit_cache"] + kind["reused"]
                        + kind["actually_run"])
            widths = [len(aot_plans[picks[i]]) if workload == "aot"
                      else tune_plans[picks[i]][1]
                      for i in range(tasks)]
            out["breakdown"] = kind
            out["lost_or_hung"] = len(lost)
            out["servant_compiles"] = kind["actually_run"]
            out["dedup_ratio"] = round(
                1.0 - kind["actually_run"] / max(1, resolved), 3)
            out["fanout_width"] = {
                "min": int(np.min(widths)),
                "p50": float(np.percentile(widths, 50)),
                "mean": round(float(np.mean(widths)), 2),
                "max": int(np.max(widths)),
            }
            if workload == "aot":
                out["aot_topology_compiles_per_sec"] = round(
                    resolved / wall, 1)
            else:
                out["autotune_sweeps_per_sec"] = round(tasks / wall, 1)
                out["configs_evaluated"] = int(
                    sum(len(tune_plans[picks[i]][0])
                        for i in range(tasks)))
        if tu_size_dist:
            # Byte-heavy mode: the workload is about moving bytes, so
            # report how many moved and how often they were copied
            # (payload-layer meter, process-wide across the whole rig).
            out["tu_size_dist"] = tu_size_dist
            out["source_mb_total"] = round(source_bytes_total / 1e6, 1)
            out["source_mb_per_sec"] = round(
                source_bytes_total / 1e6 / wall, 1)
            out["payload_copies_per_task"] = round(
                (copy_stats()["copies"] - copies0) / max(1, tasks), 1)
        return out
    finally:
        sync_stop.set()
        cluster.stop()
        shutil.rmtree(tmp, ignore_errors=True)
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


# ---------------------------------------------------------------------------
# Connection-storm mode (--clients N): the front ends' A/B driver.
# ---------------------------------------------------------------------------


def _read_vm_rss_kb() -> int:
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1])
    return 0


async def _read_http_response(reader) -> tuple:
    """Minimal HTTP/1.1 response read: (status, body)."""
    head = await reader.readuntil(b"\r\n\r\n")
    lines = head.decode("latin-1").split("\r\n")
    status = int(lines[0].split()[1])
    length = 0
    for ln in lines[1:]:
        if ln.lower().startswith("content-length:"):
            length = int(ln.split(":", 1)[1])
    body = await reader.readexactly(length) if length else b""
    return status, body


def _storm_server_main(frontend: str) -> None:
    """Subprocess entry for the ISOLATED parked-memory measurement: a
    minimal delegate HTTP front end with a saturated heavy-quota table
    (every acquire_quota parks for its full window) and nothing else in
    the process, so /proc/<pid>/status prices exactly what one parked
    long-poll client costs the SERVER — a thread stack on the threaded
    front end, a continuation + timer on the aio one."""
    from ..daemon.local.config_keeper import ConfigKeeper
    from ..daemon.local.distributed_task_dispatcher import \
        DistributedTaskDispatcher
    from ..daemon.local.file_digest_cache import FileDigestCache
    from ..daemon.local.http_service import LocalHttpService
    from ..daemon.local.local_task_monitor import LocalTaskMonitor
    from ..daemon.local.task_grant_keeper import TaskGrantKeeper

    monitor = LocalTaskMonitor(nprocs=2, max_heavy_tasks=1,
                               pid_prober=lambda p: True)
    assert monitor.wait_for_running_new_task_permission(1, False, 1.0)
    svc = LocalHttpService(
        monitor=monitor, digest_cache=FileDigestCache(),
        dispatcher=DistributedTaskDispatcher(
            grant_keeper=TaskGrantKeeper("mock://storm-sched", token=""),
            config_keeper=ConfigKeeper("mock://storm-sched", token=""),
            pid_prober=lambda p: True),
        port=0, frontend=frontend)
    svc.start()
    print(f"PORT {svc.port}", flush=True)
    threading.Event().wait()  # parent kills us


def measure_parked_memory(clients: int, frontend: str, *,
                          ramp_per_s: float = 400.0) -> dict:
    """Server-side-only memory per parked long-poll client: spawn the
    minimal front-end subprocess, park `clients` full-window
    acquire_quota long-polls against it, and read ITS VmRSS before and
    at the plateau."""
    import asyncio
    import signal
    import subprocess
    import sys

    from ..rpc.aio_server import EventLoopThread

    proc = subprocess.Popen(
        [sys.executable, "-c",
         "from yadcc_tpu_torch.tools.cluster_sim import "
         "_storm_server_main; "
         f"_storm_server_main({frontend!r})"],
        stdout=subprocess.PIPE, text=True,
        cwd=str(Path(__file__).resolve().parents[2]))
    try:
        line = proc.stdout.readline()
        port = int(line.split()[1])

        def child_mem_kb() -> tuple:
            rss = vsz = 0
            with open(f"/proc/{proc.pid}/status") as f:
                for ln in f:
                    if ln.startswith("VmRSS:"):
                        rss = int(ln.split()[1])
                    elif ln.startswith("VmSize:"):
                        vsz = int(ln.split()[1])
            return rss, vsz

        wait_ms = int((clients / ramp_per_s + 20.0) * 1000)
        errors = [0]

        async def park(i: int, release: asyncio.Event) -> None:
            body = (b'{"milliseconds_to_wait": %d, "lightweight_task": '
                    b'false, "requestor_pid": %d}' % (wait_ms, 2 + i))
            req = (b"POST /local/acquire_quota HTTP/1.1\r\n"
                   b"Host: l\r\nContent-Type: application/json\r\n"
                   b"Content-Length: %d\r\n\r\n" % len(body)) + body
            try:
                reader, writer = await asyncio.open_connection(
                    "127.0.0.1", port)
                writer.write(req)
                await writer.drain()
                await release.wait()
                writer.close()
            except Exception:
                errors[0] += 1

        rss0, vsz0 = child_mem_kb()
        peak = [0, 0]

        async def drive() -> None:
            release = asyncio.Event()
            period = 1.0 / ramp_per_s
            tasks = []
            for i in range(clients):
                tasks.append(asyncio.ensure_future(park(i, release)))
                await asyncio.sleep(period)
            await asyncio.sleep(2.0)  # let the server settle
            peak[0], peak[1] = child_mem_kb()
            release.set()
            await asyncio.gather(*tasks, return_exceptions=True)

        loops = EventLoopThread(name="parked-mem")
        try:
            asyncio.run_coroutine_threadsafe(
                drive(), loops.loop).result(
                    timeout=clients / ramp_per_s + 120)
        finally:
            loops.stop()
        held = max(1, clients - errors[0])
        return {
            "frontend": frontend,
            "clients": clients,
            "errors": errors[0],
            "server_rss_before_kb": rss0,
            "server_rss_peak_kb": peak[0],
            # Touched pages per parked client (heap objects + whatever
            # stack pages the serving model dirties)...
            "server_kb_per_parked_client": round(
                max(0, peak[0] - rss0) / held, 2),
            # ...and reserved address space per parked client: the
            # threaded front end's 8MB-stack-per-waiter reservation is
            # the cost the reference's fiber runtime exists to avoid —
            # RSS alone understates it (stacks are lazily touched).
            "server_virtual_kb_per_parked_client": round(
                max(0, peak[1] - vsz0) / held, 1),
        }
    finally:
        proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=10)


def _ensure_fd_headroom(clients: int) -> None:
    """A storm holds ~2 fds per client (both loopback ends live in this
    process); raise RLIMIT_NOFILE toward the hard limit when the soft
    one would starve the run.  Best-effort — a refused raise surfaces
    later as connect_errors, not a crash here."""
    import resource

    need = int(clients * 2.2) + 4096
    try:
        soft, hard = resource.getrlimit(resource.RLIMIT_NOFILE)
        if soft >= need:
            return
        if hard != resource.RLIM_INFINITY:
            need = min(need, hard) if hard >= need else hard
        resource.setrlimit(resource.RLIMIT_NOFILE, (need, hard))
    except (ValueError, OSError):
        pass


def _fd_budget() -> tuple:
    """(soft RLIMIT_NOFILE, direct-connection budget).  Each direct
    storm client costs TWO fds in this process (both loopback ends);
    the reserve covers the cluster's own sockets, the compile stream,
    probes and slack.  Clients past the budget multiplex instead
    (run_storm docstring)."""
    import resource

    soft, _ = resource.getrlimit(resource.RLIMIT_NOFILE)
    return soft, max(256, (soft - 4096) // 2)


def _arm_park_anchor(cluster, anchor_compiler: str, http_port: int) -> dict:
    """One real slow compile through the delegate — real grant, real
    keep-alives, a real servant slot — whose servant-side task id
    anchors the storm's multiplexed overflow waiters.  Returns the
    servant index, RPC port, task id and serving-daemon token the
    waiters need.  Must run before the compile stream starts (the
    anchor is identified as the only running task)."""
    import http.client
    import json as _json

    from ..common import compress as _compress
    from ..common.hashing import digest_bytes, digest_file
    from ..common.multi_chunk import make_multi_chunk

    src = b"int ytpu_storm_anchor() { return 50000; }\n"
    conn = http.client.HTTPConnection("127.0.0.1", http_port, timeout=30)

    def post(path, body):
        conn.request("POST", path, body=body, headers={
            "Content-Type": "application/octet-stream"})
        resp = conn.getresponse()
        return resp.status, resp.read()

    try:
        post("/local/set_file_digest", _json.dumps({
            "file_desc": {"path": anchor_compiler, "size": str(
                os.path.getsize(anchor_compiler)), "timestamp": str(int(
                    os.path.getmtime(anchor_compiler)))},
            "digest": digest_file(anchor_compiler)}).encode())
        st, _ = post("/local/submit_cxx_task", make_multi_chunk([
            _json.dumps({
                "requestor_process_id": 1,
                "source_path": "/src/storm_anchor.cc",
                "source_digest": digest_bytes(src),
                "compiler_invocation_arguments": "-O2",
                "cache_control": 0,
                "compiler": {"path": anchor_compiler,
                             "size": str(os.path.getsize(anchor_compiler)),
                             "timestamp": str(int(
                                 os.path.getmtime(anchor_compiler)))},
            }).encode(),
            _compress.compress(src)]))
        if st != 200:
            raise RuntimeError(f"anchor submit failed with HTTP {st}")
    finally:
        conn.close()
    deadline = time.monotonic() + 30.0
    while time.monotonic() < deadline:
        for si, servant in enumerate(cluster.servants):
            running = servant.engine.running_tasks()
            if running:
                cluster.config_keeper.refresh_once()
                return {
                    "servant": si,
                    "port": servant.server.port,
                    "task_id": running[0][0],
                    "token": cluster.config_keeper.serving_daemon_token(),
                }
        time.sleep(0.05)
    raise RuntimeError("anchor compile never reached a servant")


def run_storm(clients: int, rpc_frontend: str, *, ramp_per_s: float = 300.0,
              hold_s: float = 8.0, probes_per_s: float = 20.0,
              compile_tasks: int = 30, compile_s: float = 0.02,
              accept_loops: int = 1) -> dict:
    """Thousands of idle long-poll clients + steady compile traffic
    against the delegate's local HTTP front end (threaded vs aio).  Every
    storm client parks a full-window /local/acquire_quota long-poll
    against a saturated quota table: on the threaded front end that is
    one serving THREAD each; on the aio front end, one parked
    continuation + loop timer each.  Meanwhile
    probe GETs measure accept responsiveness and a compile stream
    proves the data path still works.  Reports concurrent_connections,
    per-connection RSS, accept p50/p99 and the error ledger.

    Clients past the RLIMIT_NOFILE budget (2 fds per direct loopback
    connection — a 50k run needs >100k fds, more than a capped box
    grants one process) MULTIPLEX instead, aio front end only: each
    overflow client parks a full-window WaitForCompilationOutput
    long-poll against one real slow anchor compile, pipelined over a
    bounded socket set exactly the way an HTTP/2-era peer would.  The
    serving-side cost is identical per REQUEST — one parked
    continuation + one loop timer on the servant's AioServerGroup —
    so the parked-client claim measures the serving path, not the
    box's fd ceiling; the report breaks out direct vs multiplexed and
    records the fd limit that set the split."""
    import asyncio
    import http.client

    from .. import api
    from ..common.hashing import digest_bytes, digest_file
    from ..common import compress as _compress
    from ..common.multi_chunk import make_multi_chunk, try_parse_multi_chunk
    from ..rpc.aio_server import AsyncAioChannel, EventLoopThread
    from ..testing import LocalCluster, make_fake_compiler

    _ensure_fd_headroom(clients)
    fd_soft, budget = _fd_budget()
    direct = min(clients, budget)
    overflow = clients - direct
    if overflow and rpc_frontend != "aio":
        raise ValueError(
            f"{clients} clients need ~{clients * 2} fds and RLIMIT_NOFILE "
            f"is {fd_soft} (budget {budget}); only the aio front end can "
            "multiplex the overflow")
    ramp_s = clients / max(1.0, ramp_per_s)
    tmp = Path(tempfile.mkdtemp(prefix="cstorm_"))
    compiler = make_fake_compiler(str(tmp / "bin"), compile_s=compile_s)
    compiler_digest = digest_file(compiler)
    compiler_dirs = [str(tmp / "bin")]
    anchor_compiler = None
    if overflow:
        # The anchor toolchain "compiles" for the whole storm: every
        # overflow waiter's window (which starts as late as ramp end)
        # must expire while the anchor is still RUNNING.
        anchor_compiler = make_fake_compiler(
            str(tmp / "anchor_bin"),
            compile_s=ramp_s * 2 + hold_s + 40.0)
        compiler_dirs.append(str(tmp / "anchor_bin"))
    cluster = LocalCluster(
        tmp, n_servants=2, policy="greedy_cpu", servant_concurrency=2,
        compiler_dirs=compiler_dirs,
        rpc_frontend=("aio" if rpc_frontend == "aio" else "grpc"),
        http_frontend=("aio" if rpc_frontend == "aio" else "threaded"),
        accept_loops=accept_loops)
    port = cluster.http.port
    monitor = cluster.http.monitor

    # Saturate the heavy quota class so every storm acquire parks for
    # its whole window (the long-poll the front end must hold cheaply).
    heavy_limit = monitor.inspect()["heavy_limit"]
    for i in range(heavy_limit):
        assert monitor.wait_for_running_new_task_permission(
            800000 + i, False, 1.0)

    # Every parked client must still be parked when the ramp completes
    # and the hold window ends (that is the "concurrent" in
    # concurrent_connections); direct clients all answer 503 at the
    # deadline, multiplexed ones ride their window out as re-parked
    # RUNNING polls (the servant clamps a single park at 10s).
    wait_ms = int((ramp_s + hold_s + 10.0) * 1000)

    anchor = None
    if overflow:
        anchor = _arm_park_anchor(cluster, anchor_compiler, port)

    stats_lock = threading.Lock()
    state = {"connected": 0, "peak": 0, "replies_503": 0,
             "replies_running": 0, "replies_other": 0,
             "connect_errors": 0, "response_errors": 0, "lost": 0}
    accept_lat: list = []
    rpc_accept_lat: list = []
    probe_errors = [0]
    rpc_probe_errors = [0]
    parked_peak = [0]
    rss = {"before": _read_vm_rss_kb(), "peak": 0}
    stop_probe = threading.Event()

    async def storm_client(i: int) -> None:
        body = (b'{"milliseconds_to_wait": %d, "lightweight_task": '
                b'false, "requestor_pid": %d}' % (wait_ms, 900000 + i))
        req = (b"POST /local/acquire_quota HTTP/1.1\r\n"
               b"Host: l\r\nContent-Type: application/json\r\n"
               b"Content-Length: %d\r\n\r\n" % len(body)) + body
        try:
            reader, writer = await asyncio.wait_for(
                asyncio.open_connection("127.0.0.1", port), timeout=15.0)
        except Exception:
            with stats_lock:
                state["connect_errors"] += 1
            return
        with stats_lock:
            state["connected"] += 1
            state["peak"] = max(state["peak"], state["connected"])
        try:
            writer.write(req)
            await writer.drain()
            status, _ = await asyncio.wait_for(
                _read_http_response(reader),
                timeout=wait_ms / 1000.0 + 30.0)
            with stats_lock:
                if status == 503:
                    state["replies_503"] += 1
                else:
                    state["replies_other"] += 1
        except asyncio.TimeoutError:
            with stats_lock:
                state["lost"] += 1
        except Exception:
            with stats_lock:
                state["response_errors"] += 1
        finally:
            with stats_lock:
                state["connected"] -= 1
            writer.close()

    async def overflow_client(i: int, mux: list) -> None:
        # One multiplexed parked client: full-window long-poll against
        # the anchor compile, re-parking each time the servant's 10s
        # single-park clamp answers RUNNING — the delegate's own poll
        # discipline, pipelined over a shared socket.
        ch = mux[i % len(mux)]
        end = time.monotonic() + wait_ms / 1000.0
        with stats_lock:
            state["connected"] += 1
            state["peak"] = max(state["peak"], state["connected"])
        try:
            while True:
                remaining_ms = int((end - time.monotonic()) * 1000)
                if remaining_ms <= 0:
                    with stats_lock:
                        state["replies_running"] += 1
                    return
                req = api.daemon.WaitForCompilationOutputRequest(
                    token=anchor["token"], task_id=anchor["task_id"],
                    milliseconds_to_wait=remaining_ms)
                resp, _ = await ch.call(
                    "ytpu.DaemonService", "WaitForCompilationOutput",
                    req,
                    api.daemon.WaitForCompilationOutputResponse,
                    timeout=min(remaining_ms / 1000.0, 10.0) + 30.0)
                if resp.status != \
                        api.daemon.COMPILATION_TASK_STATUS_RUNNING:
                    # The anchor outlives every window; any DONE /
                    # NOT_FOUND here means the rig lost its anchor.
                    with stats_lock:
                        state["replies_other"] += 1
                    return
        except asyncio.TimeoutError:
            with stats_lock:
                state["lost"] += 1
        except Exception:
            with stats_lock:
                state["response_errors"] += 1
        finally:
            with stats_lock:
                state["connected"] -= 1

    async def prober() -> None:
        while not stop_probe.is_set():
            t0 = time.perf_counter()
            try:
                reader, writer = await asyncio.wait_for(
                    asyncio.open_connection("127.0.0.1", port),
                    timeout=10.0)
                writer.write(b"GET /local/get_version HTTP/1.1\r\n"
                             b"Host: l\r\n\r\n")
                await writer.drain()
                status, _ = await asyncio.wait_for(
                    _read_http_response(reader), timeout=10.0)
                writer.close()
                if status != 200:
                    probe_errors[0] += 1
                else:
                    accept_lat.append(time.perf_counter() - t0)
            except Exception:
                probe_errors[0] += 1
            await asyncio.sleep(1.0 / probes_per_s)

    async def rpc_prober(target: str, token: str) -> None:
        # Accept responsiveness of the surface --accept-loops shards:
        # a fresh TCP dial into the servant's AioServerGroup each lap,
        # answered by the unknown-id NOT_FOUND fast path.  Samples are
        # timestamped so the report can separate the ramp (the client
        # rig launching flat-out, pure CPU saturation of the box) from
        # the plateau (every client parked — the state the storm
        # exists to measure).
        while not stop_probe.is_set():
            ts = time.monotonic()
            t0 = time.perf_counter()
            ch = AsyncAioChannel(target)
            try:
                req = api.daemon.WaitForCompilationOutputRequest(
                    token=token, task_id=999_999_999,
                    milliseconds_to_wait=0)
                resp, _ = await ch.call(
                    "ytpu.DaemonService", "WaitForCompilationOutput",
                    req,
                    api.daemon.WaitForCompilationOutputResponse,
                    timeout=10.0)
                if resp.status == \
                        api.daemon.COMPILATION_TASK_STATUS_NOT_FOUND:
                    rpc_accept_lat.append((ts, time.perf_counter() - t0))
                else:
                    rpc_probe_errors[0] += 1
            except Exception:
                rpc_probe_errors[0] += 1
            finally:
                ch.close()
            await asyncio.sleep(1.0 / probes_per_s)

    # Which global ramp positions get the direct fds: spread evenly
    # over the schedule so direct and multiplexed clients arrive
    # interleaved, not in two phases.
    is_direct = [((i + 1) * direct) // clients
                 - (i * direct) // clients > 0 for i in range(clients)]

    async def ramp_slice(offset: int, stride: int) -> None:
        # One client loop's share of the storm, launched against the
        # GLOBAL schedule (position i fires at i/ramp_per_s) with
        # self-correction — a lagging loop launches flat-out instead
        # of compounding per-iteration sleep error.
        mux = []
        if overflow:
            n_mux = max(2, min(16, (overflow // stride) // 1024 + 2))
            mux = [AsyncAioChannel(f"127.0.0.1:{anchor['port']}")
                   for _ in range(n_mux)]
        tasks = []
        t0 = time.monotonic()
        try:
            for i in range(offset, clients, stride):
                lag = i / ramp_per_s - (time.monotonic() - t0)
                if lag > 0:
                    await asyncio.sleep(lag)
                elif len(tasks) % 64 == 0:
                    await asyncio.sleep(0)
                if is_direct[i]:
                    tasks.append(asyncio.ensure_future(storm_client(i)))
                else:
                    tasks.append(asyncio.ensure_future(
                        overflow_client(i, mux)))
            await asyncio.gather(*tasks, return_exceptions=True)
        finally:
            for ch in mux:
                ch.close()

    # Steady compile traffic on a plain thread (the real client is
    # synchronous HTTP): submit/wait through the storming front end.
    compile_lat: list = []
    compile_failures = [0]

    def compile_stream() -> None:
        import json as _json

        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)

        def post(path, body):
            conn.request("POST", path, body=body, headers={
                "Content-Type": "application/octet-stream"})
            resp = conn.getresponse()
            return resp.status, resp.read()

        post("/local/set_file_digest", _json.dumps({
            "file_desc": {"path": compiler, "size": str(
                os.path.getsize(compiler)), "timestamp": str(int(
                    os.path.getmtime(compiler)))},
            "digest": compiler_digest}).encode())
        deadline = time.monotonic() + ramp_s + hold_s
        i = 0
        while time.monotonic() < deadline and not sync_stop.is_set():
            i += 1
            src = f"// storm TU {i}\nint f{i}() {{ return {i}; }}\n" \
                .encode()
            submit = {
                "requestor_process_id": 1,
                "source_path": f"/src/storm{i}.cc",
                "source_digest": digest_bytes(src),
                "compiler_invocation_arguments": "-O2",
                "cache_control": 0,
                "compiler": {"path": compiler,
                             "size": str(os.path.getsize(compiler)),
                             "timestamp": str(int(
                                 os.path.getmtime(compiler)))},
            }
            t0 = time.perf_counter()
            try:
                st, data = post("/local/submit_cxx_task",
                                make_multi_chunk([
                                    _json.dumps(submit).encode(),
                                    _compress.compress(src)]))
                if st != 200:
                    compile_failures[0] += 1
                    continue
                task_id = _json.loads(data)["task_id"]
                while True:
                    st, data = post(
                        "/local/wait_for_cxx_task",
                        _json.dumps({"task_id": task_id,
                                     "milliseconds_to_wait": 9000})
                        .encode())
                    if st != 503:
                        break
                chunks = try_parse_multi_chunk(data) if st == 200 else None
                if st != 200 or not chunks or \
                        _json.loads(chunks[0])["exit_code"] != 0:
                    compile_failures[0] += 1
                else:
                    compile_lat.append(time.perf_counter() - t0)
            except Exception:
                compile_failures[0] += 1
                conn.close()
                conn = http.client.HTTPConnection("127.0.0.1", port,
                                                  timeout=60)
            if len(compile_lat) + compile_failures[0] >= compile_tasks:
                break
        conn.close()

    sync_stop = threading.Event()
    # One client EventLoopThread per ~8k clients: a single loop cannot
    # dial + park 50k clients on schedule, and a lagging CLIENT rig
    # would read as serving-path error.  The probers get a loop of
    # their OWN for the same reason: sharing a loop with thousands of
    # storm coroutines would fold the rig's ready-queue lag into every
    # latency sample.
    n_loops = max(1, min(4, (clients + 7999) // 8000))
    loop_threads = [EventLoopThread(name=f"storm-clients-{k}")
                    for k in range(n_loops)]
    probe_loop = EventLoopThread(name="storm-probe")
    loop_threads.append(probe_loop)
    try:
        t_start = time.perf_counter()
        compile_thread = threading.Thread(target=compile_stream,
                                          daemon=True)
        compile_thread.start()
        import asyncio as _asyncio

        t_ramp0 = time.monotonic()
        futs = [_asyncio.run_coroutine_threadsafe(
                    ramp_slice(k, n_loops), loop_threads[k].loop)
                for k in range(n_loops)]
        probe_futs = [_asyncio.run_coroutine_threadsafe(
            prober(), probe_loop.loop)]
        if rpc_frontend == "aio":
            cluster.config_keeper.refresh_once()
            probe_futs.append(_asyncio.run_coroutine_threadsafe(
                rpc_prober(
                    f"127.0.0.1:{cluster.servants[0].server.port}",
                    cluster.config_keeper.serving_daemon_token()),
                probe_loop.loop))
        # Plateau sampling from this thread: RSS and the servant-side
        # parked-waiter gauge, peak over the whole run.
        overall_deadline = (time.monotonic() + ramp_s + hold_s
                            + wait_ms / 1000.0 + 120)
        while not all(f.done() for f in futs):
            if time.monotonic() > overall_deadline:
                break
            rss["peak"] = max(rss["peak"], _read_vm_rss_kb())
            if overflow:
                parked = sum(
                    s.engine.inspect()["parked_waiters"]
                    for s in cluster.servants)
                parked_peak[0] = max(parked_peak[0], parked)
            time.sleep(0.2)
        for f in futs:
            f.result(timeout=60)
        stop_probe.set()
        for f in probe_futs:
            f.result(timeout=30)
        sync_stop.set()
        compile_thread.join(timeout=60)
        wall = time.perf_counter() - t_start
    finally:
        sync_stop.set()
        stop_probe.set()
        for lt in loop_threads:
            lt.stop()
        cluster.stop()
        shutil.rmtree(tmp, ignore_errors=True)
    answered = (state["replies_503"] + state["replies_running"]
                + state["replies_other"])
    errors = (state["connect_errors"] + state["response_errors"]
              + state["lost"])
    acc = (np.array(accept_lat) * 1000.0) if accept_lat else \
        np.array([0.0])
    # The headline rpc accept percentiles come from the PLATEAU —
    # every client parked, [ramp end, ramp end + hold_s].  During the
    # ramp the client rig itself is launching tens of thousands of
    # coroutines flat-out, so ramp-window samples measure the box's
    # CPU saturation by the rig, not the serving path under parked
    # load.  The all-samples tail is reported alongside.
    racc_all = (np.array([d for _, d in rpc_accept_lat]) * 1000.0
                if rpc_accept_lat else None)
    plateau = [d for ts, d in rpc_accept_lat
               if t_ramp0 + ramp_s <= ts <= t_ramp0 + ramp_s + hold_s]
    racc = (np.array(plateau) * 1000.0 if len(plateau) >= 20
            else racc_all)
    clat = (np.array(compile_lat) * 1000.0) if compile_lat else None
    per_conn_kb = (max(0, rss["peak"] - rss["before"])
                   / max(1, state["peak"]))
    return {
        "mode": "connection_storm",
        "frontend": rpc_frontend,
        "clients": clients,
        "ramp_per_s": ramp_per_s,
        "accept_loops": accept_loops,
        "fd_limit_nofile": fd_soft,
        "direct_clients": direct,
        "multiplexed_clients": overflow,
        "wall_seconds": round(wall, 2),
        "concurrent_connections": state["peak"],
        "parked_replies_503": state["replies_503"],
        "parked_replies_running": state["replies_running"],
        "replies_other": state["replies_other"],
        "connect_errors": state["connect_errors"],
        "response_errors": state["response_errors"],
        "lost_or_hung": state["lost"],
        "error_rate": round(errors / max(1, clients), 4),
        "servant_parked_waiters_peak": parked_peak[0],
        "rss_before_kb": rss["before"],
        "rss_peak_kb": rss["peak"],
        "rss_per_connection_kb": round(per_conn_kb, 1),
        "accept_probes": int(acc.size),
        "probe_errors": probe_errors[0],
        "accept_p50_ms": round(float(np.percentile(acc, 50)), 2),
        "accept_p99_ms": round(float(np.percentile(acc, 99)), 2),
        "rpc_accept_probes": (int(racc_all.size) if racc_all is not None
                              else 0),
        "rpc_accept_plateau_probes": len(plateau),
        "rpc_probe_errors": rpc_probe_errors[0],
        "rpc_accept_p50_ms": (round(float(np.percentile(racc, 50)), 2)
                              if racc is not None else None),
        "rpc_accept_p99_ms": (round(float(np.percentile(racc, 99)), 2)
                              if racc is not None else None),
        "rpc_accept_p99_ms_all": (
            round(float(np.percentile(racc_all, 99)), 2)
            if racc_all is not None else None),
        "compile": {
            "completed": len(compile_lat),
            "failures": compile_failures[0],
            "p50_ms": (round(float(np.percentile(clat, 50)), 1)
                       if clat is not None else None),
            "p99_ms": (round(float(np.percentile(clat, 99)), 1)
                       if clat is not None else None),
        },
        "_answered": answered,
    }


def run_servant_park(waiters: int = 5000, *, hold_s: float = 6.0,
                     connections: int = 8) -> dict:
    """Servant-park proof: N peers long-poll
    WaitForCompilationOutput for ONE slow compile on an aio-front-end
    servant.  On the parked path each peer costs the engine one
    continuation + one loop timer — the OS thread count of the serving
    process stays flat while thousands of waiters are parked (the
    threaded front end would need a worker thread per waiter)."""
    import asyncio

    from .. import api
    from ..common import compress
    from ..common.hashing import digest_file
    from ..daemon.cloud.compiler_registry import CompilerRegistry
    from ..daemon.cloud.daemon_service import DaemonService
    from ..daemon.cloud.execution_engine import ExecutionEngine
    from ..daemon.config import DaemonConfig
    from ..rpc.aio_server import (
        AioRpcServer,
        AsyncAioChannel,
        EventLoopThread,
    )
    from ..testing import make_fake_compiler

    _ensure_fd_headroom(connections)
    tmp = Path(tempfile.mkdtemp(prefix="cpark_"))
    make_fake_compiler(str(tmp / "bin"), compile_s=hold_s)
    saved_path = os.environ.get("PATH", "")
    os.environ["PATH"] = str(tmp / "bin")
    try:
        registry = CompilerRegistry()
    finally:
        os.environ["PATH"] = saved_path
    (tmp / "ws").mkdir()
    engine = ExecutionEngine(max_concurrency=2,
                             min_memory_for_new_task=1)
    svc = DaemonService(
        DaemonConfig(temporary_dir=str(tmp / "ws"),
                     location="127.0.0.1:8335"),
        engine=engine, registry=registry,
        allow_poor_machine=True, cgroup_present=False)
    svc.set_acceptable_tokens_for_testing(["tok"])
    srv = AioRpcServer("127.0.0.1:0")
    svc.attach_frontend(srv)
    srv.add_service(svc.spec())
    client_loops = EventLoopThread(name="park-clients")
    try:
        # One slow compile every waiter will long-poll.
        src = b"int park() { return 16; }\n"
        qreq = api.daemon.QueueCxxCompilationTaskRequest(
            token="tok", task_grant_id=1, source_path="/src/park.cc",
            invocation_arguments="-O2",
            compression_algorithm=api.daemon.COMPRESSION_ALGORITHM_ZSTD)
        qreq.env_desc.compiler_digest = registry.environments()[0]
        from ..rpc import Channel

        ch = Channel(f"aio://127.0.0.1:{srv.port}")
        qresp, _ = ch.call(
            "ytpu.DaemonService", "QueueCxxCompilationTask", qreq,
            api.daemon.QueueCxxCompilationTaskResponse,
            attachment=compress.compress(src), timeout=30)
        task_id = qresp.task_id

        wait_ms = int((hold_s + 60.0) * 1000)
        threads_before = threading.active_count()
        statuses: list = []

        async def drive() -> None:
            # A handful of pipelined connections carry every waiter:
            # the park cost under test is per-REQUEST on the servant
            # (continuation + timer), not per-socket.
            chans = [AsyncAioChannel(f"127.0.0.1:{srv.port}")
                     for _ in range(connections)]

            async def one(i: int) -> None:
                req = api.daemon.WaitForCompilationOutputRequest(
                    token="tok", task_id=task_id,
                    milliseconds_to_wait=wait_ms)
                req.acceptable_compression_algorithms.append(
                    api.daemon.COMPRESSION_ALGORITHM_ZSTD)
                resp, _ = await chans[i % connections].call(
                    "ytpu.DaemonService", "WaitForCompilationOutput",
                    req, api.daemon.WaitForCompilationOutputResponse,
                    timeout=wait_ms / 1000.0 + 60.0)
                statuses.append(resp.status)

            try:
                await asyncio.gather(*[one(i) for i in range(waiters)])
            finally:
                for c in chans:
                    c.close()

        fut = asyncio.run_coroutine_threadsafe(drive(),
                                               client_loops.loop)
        # Plateau: every waiter parked on the engine at once.
        parked_peak = 0
        threads_at_peak = threads_before
        deadline = time.monotonic() + hold_s + 120.0
        while time.monotonic() < deadline:
            parked = engine.inspect()["parked_waiters"]
            if parked > parked_peak:
                parked_peak = parked
                threads_at_peak = threading.active_count()
            if parked >= waiters or fut.done():
                break
            time.sleep(0.05)
        fut.result(timeout=hold_s + 180.0)
        done = sum(1 for s in statuses
                   if s == api.daemon.COMPILATION_TASK_STATUS_DONE)
        ch.close()
        return {
            "mode": "servant_park",
            "waiters": waiters,
            "connections": connections,
            "parked_waiters_peak": parked_peak,
            "threads_before": threads_before,
            "threads_at_peak": threads_at_peak,
            # The headline number: extra OS threads per parked waiter
            # (0.0 on the parked path; ~1.0 on a thread-per-wait one).
            "threads_per_waiter": round(
                max(0, threads_at_peak - threads_before)
                / max(1, parked_peak), 4),
            "replies_done": done,
            "replies_other": len(statuses) - done,
        }
    finally:
        client_loops.stop()
        srv.stop()
        engine.stop()
        shutil.rmtree(tmp, ignore_errors=True)


def run_steal_storm_ab(requests: int = 64, *, timeout_s: float = 2.0,
                       device: str = "cuda") -> dict:
    """Steal-storm A/B: the same burst of hot-shard demand
    through the blocking routed wait and through the loop-native submit
    path, against a fully saturated 2-shard router.  On the blocking
    path every in-flight donor wait IS a pool thread; on the async path
    outstanding demand parks as continuations and the process thread
    count stays flat — occupancy no longer tracks donor-wait
    concurrency."""
    from ..scheduler.policy import make_policy
    from ..scheduler.shard_router import ShardRouter
    from ..scheduler.task_dispatcher import ServantInfo

    env = "e" * 64

    def build_router():
        return ShardRouter.build(
            lambda k: make_policy("greedy_cpu", avoid_self=False,
                                  device=device),
            2, max_servants_per_shard=256, min_memory_for_new_task=1,
            batch_window_s=0.0)

    def saturate(router) -> str:
        # Servants on both shards, every slot granted away: a steal op
        # finds a donor signal but no free capacity, so each request
        # rides its full wait window — the worst-case occupancy.
        for i in range(8):
            router.keep_servant_alive(ServantInfo(
                location=f"10.1.0.{i}:8335", version=1,
                num_processors=8, current_load=0, dedicated=True,
                capacity=4, total_memory=1 << 36,
                memory_available=1 << 35, env_digests=(env,)), 600.0)
        hot = next(f"delegate-{i}" for i in range(10000)
                   if router.shard_for_location(f"delegate-{i}") == 0)
        while router.wait_for_starting_new_task(
                env, requestor=hot, immediate=8, timeout_s=0.2):
            pass
        return hot

    out: dict = {"mode": "steal_storm_ab", "requests": requests,
                 "timeout_s": timeout_s}

    # -- A: blocking routed wait (one pool thread per in-flight wait) --
    router = build_router()
    try:
        hot = saturate(router)
        base = threading.active_count()
        peak = [base]
        started = threading.Barrier(requests + 1)

        def blocking_one() -> None:
            started.wait(timeout=30)
            router.wait_for_starting_new_task_routed(
                env, requestor=hot, immediate=1, timeout_s=timeout_s)

        threads = [threading.Thread(target=blocking_one, daemon=True)
                   for _ in range(requests)]
        for t in threads:
            t.start()
        started.wait(timeout=30)
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            peak[0] = max(peak[0], threading.active_count())
            time.sleep(0.01)
        for t in threads:
            t.join(timeout=timeout_s + 30)
        out["threaded"] = {
            "threads_base": base,
            "threads_peak": peak[0],
            "extra_threads_at_peak": peak[0] - base,
        }
    finally:
        router.stop()

    # -- B: loop-native submit path (continuations, flat threads) -----
    router = build_router()
    try:
        hot = saturate(router)
        base = threading.active_count()
        answered = threading.Event()
        left = [requests]
        lock = threading.Lock()

        def on_done(pairs) -> None:
            with lock:
                left[0] -= 1
                if left[0] == 0:
                    answered.set()

        for _ in range(requests):
            router.submit_wait_for_starting_new_task(
                env, requestor=hot, immediate=1, timeout_s=timeout_s,
                on_done=on_done)
        peak = base
        outstanding_at_peak = 0
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            n = threading.active_count()
            if n >= peak:
                peak = n
                with lock:
                    outstanding_at_peak = left[0]
            time.sleep(0.01)
        if not answered.wait(timeout=timeout_s + 30):
            raise RuntimeError(
                f"steal storm async arm: {left[0]} requests unanswered")
        out["aio"] = {
            "threads_base": base,
            "threads_peak": peak,
            "extra_threads_at_peak": peak - base,
            "outstanding_requests_at_peak": outstanding_at_peak,
        }
    finally:
        router.stop()

    # Decoupling claim: with ~all requests outstanding, the async arm
    # added (close to) zero threads while the blocking arm added ~one
    # per request.
    out["decoupled"] = (
        out["aio"]["extra_threads_at_peak"]
        < max(4, out["threaded"]["extra_threads_at_peak"] // 4))
    return out


def quick_async_steal_engages() -> int:
    """Smoke-gate helper: hot-shard demand through the loop-native
    submit path against donors with free capacity MUST steal.  Returns
    the stolen-grant count (>0, or the gate fails)."""
    from ..scheduler.policy import make_policy
    from ..scheduler.shard_router import ShardRouter
    from ..scheduler.task_dispatcher import ServantInfo

    env = "e" * 64
    router = ShardRouter.build(
        lambda k: make_policy("greedy_cpu", avoid_self=False),
        2, max_servants_per_shard=64, min_memory_for_new_task=1,
        batch_window_s=0.0)
    try:
        hot = next(f"delegate-{i}" for i in range(10000)
                   if router.shard_for_location(f"delegate-{i}") == 0)
        # Capacity only AWAY from the hot requestor's home shard.
        for i in range(32):
            loc = f"10.2.0.{i}:8335"
            if router.shard_for_location(loc) != 0:
                router.keep_servant_alive(ServantInfo(
                    location=loc, version=1, num_processors=8,
                    current_load=0, dedicated=True, capacity=4,
                    total_memory=1 << 36, memory_available=1 << 35,
                    env_digests=(env,)), 60.0)
        box: list = []
        done = threading.Event()
        router.submit_wait_for_starting_new_task_routed(
            env, requestor=hot, immediate=2, timeout_s=5.0,
            on_done=lambda r: (box.append(r), done.set()))
        if not done.wait(10.0):
            raise RuntimeError("async routed steal never answered")
        stolen = box[0].stolen_count
        if stolen != len(box[0].grants) or stolen == 0:
            raise RuntimeError(
                f"async steal did not engage: {box[0].grants}")
        return stolen
    finally:
        router.stop()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser("python -m yadcc_tpu_torch.tools.cluster_sim")
    ap.add_argument("--tasks", type=int, default=2000)
    ap.add_argument("--servants", type=int, default=4)
    ap.add_argument("--concurrency", type=int, default=4)
    ap.add_argument("--dup-rate", type=float, default=0.2)
    ap.add_argument("--delegates", type=int, default=1,
                    help="simulated build machines (cross-machine dedup)")
    ap.add_argument("--policy", default="auto",
                    help="the scheduler's dispatch policy (the entry's "
                         "--dispatch-policy names)")
    ap.add_argument("--device", default="cuda",
                    help="where the scheduler's policy runs: cuda (the "
                         "default) or cpu (the kernels' plain versions)")
    ap.add_argument("--workload", default="cxx",
                    choices=("cxx", "jit", "aot", "autotune"),
                    help="task corpus: C++ TUs, a duplicate-heavy "
                         "synthetic module corpus through the jit "
                         "DistributedTask, or the fan-out kinds: aot "
                         "multi-topology builds / autotune sweeps")
    ap.add_argument("--tu-size-dist", default="",
                    help="TU size distribution: fixed:N, uniform:MIN:MAX,"
                         " or 'byte-heavy' (uniform 1MB..4MB)")
    ap.add_argument("--compile-s", type=float, default=0.05,
                    help="fake compile duration per task (seconds)")
    ap.add_argument("--clients", type=int, default=0,
                    help="connection-storm mode: park N idle long-poll "
                         "clients against the local HTTP front end while "
                         "a compile stream runs; reports "
                         "concurrent_connections, per-connection RSS and "
                         "accept p99")
    ap.add_argument("--rpc-frontend", default="aio",
                    choices=("threaded", "aio"),
                    help="which HTTP front end the storm targets "
                         "(threaded = ThreadingHTTPServer baseline)")
    ap.add_argument("--storm-ramp", type=float, default=300.0,
                    help="storm connection ramp, clients/s")
    ap.add_argument("--storm-hold", type=float, default=8.0,
                    help="plateau seconds with every client parked")
    ap.add_argument("--accept-loops", type=int, default=1,
                    help="event-loop count for every aio RPC front end "
                         "in the simulated cluster (SO_REUSEPORT "
                         "AioServerGroup)")
    ap.add_argument("--servant-park", type=int, default=0,
                    help="servant-park mode: park N "
                         "WaitForCompilationOutput long-polls for one "
                         "slow compile on an aio servant and report "
                         "threads-per-parked-waiter")
    ap.add_argument("--steal-ab", type=int, default=0,
                    help="steal-storm A/B mode: N hot-shard requests "
                         "through the blocking vs loop-native steal "
                         "path; reports thread occupancy of each arm")
    ap.add_argument("--scenario", default="",
                    help="run a hostile-world scenario (or 'all') "
                         "instead of the friendly sweep: one of "
                         "tools/scenarios.py's SCENARIO_NAMES, with "
                         "--smoke, --out, --policy and --device passed "
                         "through; exits 1 on any SLO miss")
    ap.add_argument("--out", default="",
                    help="write the JSON report here")
    ap.add_argument("--smoke", action="store_true",
                    help="gate: small run; exit 1 on any failure or, "
                         "for jit, if dedup never engaged")
    args = ap.parse_args(argv)
    if args.scenario:
        from . import scenarios

        sargv = ["--scenario", args.scenario, "--policy", args.policy,
                 "--device", args.device]
        if args.smoke:
            sargv.append("--smoke")
        if args.out:
            sargv += ["--out", args.out]
        return scenarios.main(sargv)
    if args.servant_park:
        out = run_servant_park(args.servant_park)
        print(json.dumps(out, indent=2))
        if args.out:
            Path(args.out).write_text(json.dumps(out, indent=2) + "\n")
        ok = (out["replies_done"] == out["waiters"]
              and out["threads_per_waiter"] <= 0.01)
        if not ok:
            print("SERVANT PARK FAILED")
        return 0 if ok else 1
    if args.steal_ab:
        out = run_steal_storm_ab(args.steal_ab, device=args.device)
        print(json.dumps(out, indent=2))
        if args.out:
            Path(args.out).write_text(json.dumps(out, indent=2) + "\n")
        if not out["decoupled"]:
            print("STEAL A/B FAILED: async arm's thread occupancy "
                  "still tracks donor-wait concurrency")
            return 1
        return 0
    if args.clients:
        if args.smoke:
            args.clients = min(args.clients, 200)
        out = run_storm(args.clients, args.rpc_frontend,
                        ramp_per_s=args.storm_ramp,
                        hold_s=args.storm_hold,
                        compile_s=0.0 if args.smoke else 0.02,
                        accept_loops=args.accept_loops)
        print(json.dumps(out, indent=2))
        if args.out:
            Path(args.out).write_text(json.dumps(out, indent=2) + "\n")
        if args.smoke:
            fails = []
            if out["lost_or_hung"]:
                fails.append(f"{out['lost_or_hung']} lost/hung clients")
            if out["error_rate"] > 0:
                fails.append(f"error rate {out['error_rate']}")
            if out["accept_p99_ms"] > 250.0:
                fails.append(
                    f"accept p99 {out['accept_p99_ms']}ms > 250ms")
            if out["compile"]["failures"]:
                fails.append(
                    f"{out['compile']['failures']} compile failures "
                    f"under storm")
            # The gate also proves the loop-native steal path engages:
            # a multi-loop front end that silently lost work stealing
            # would pass the storm alone.
            try:
                stolen = quick_async_steal_engages()
                print(f"async steal check: {stolen} grants stolen")
            except RuntimeError as e:
                fails.append(str(e))
            if fails:
                print("SMOKE FAILED: " + "; ".join(fails))
                return 1
        return 0
    if args.smoke:
        # Fan-out parents each expand into several children: fewer
        # parents keep the smoke gate's task count comparable.
        args.tasks = min(args.tasks,
                         30 if args.workload in ("aot", "autotune")
                         else 60)
        args.servants = min(args.servants, 2)
        args.dup_rate = max(args.dup_rate, 0.5)
    from ..device import resolve_device

    resolve_device(args.device)  # no card and no --device cpu: raise now
    out = run(args.tasks, args.servants, args.concurrency,
              args.dup_rate, args.policy,
              compile_s=args.compile_s if not args.smoke else 0.0,
              delegates=args.delegates,
              tu_size_dist=args.tu_size_dist,
              workload=args.workload, device=args.device)
    print(json.dumps(out, indent=2))
    if args.out:
        Path(args.out).write_text(json.dumps(out, indent=2) + "\n")
    if args.smoke:
        if out["failures"]:
            print(f"SMOKE FAILED: {out['failures']} failed tasks")
            return 1
        if args.workload in ("jit", "aot", "autotune") \
                and out["dedup_ratio"] <= 0:
            print(f"SMOKE FAILED: duplicate-heavy {args.workload} run "
                  f"never deduped")
            return 1
        if out.get("lost_or_hung"):
            print(f"SMOKE FAILED: {out['lost_or_hung']} lost/hung tasks")
            return 1
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
