"""Hostile-world scenario matrix for cluster_sim (doc/robustness.md): a
copy of the JAX package's yadcc_tpu/tools/scenarios.py over the port's
programs.  Every scheduler, rig and dispatch policy a scenario builds
runs ``policy`` on ``device`` (``run_scenario(name, smoke, policy=,
device=)``; ``--policy``/``--device``, default ``auto`` on ``cuda``),
and spill-affinity's placement scorer runs on ``device`` too.  Nothing
here imports torch at module level: the cache and tenancy scenarios
(cold-region, cache-poisoning, noisy-neighbor) load none.

Every sim before this file was a friendly LAN: instant RPCs, loyal
servants, polite clients, a cache server that never dies.  The
reference system's core survival property — graceful degradation to
local compilation when the cloud can't serve (yadcc/README.md:21-27) —
only shows up under hostility, so this module makes hostility
composable and measured:

  * **fault injectors** on the real RPC wire path
    (rpc.transport.install_fault_injector): WAN latency/jitter
    distributions, flaky peers, slow-loris servants;
  * **arrival processes**: steady and bursty-diurnal submission
    schedules, per-client rates, adversarial parallelism;
  * **mid-run chaos hooks**: cache-server restart mid-spike, servant
    death with tasks in flight;
  * **SLO measurement** per scenario: compile success rate with local
    fallback counted, end-to-end latency percentiles bucketed by the
    overload-ladder rung active at submission, fairness dispersion
    across clients, 0 lost/hung accounting.

Scenarios (``cluster_sim --scenario <name>|all``):

    wan-jitter       every RPC pays a jittered WAN delay
    burst            bursty diurnal arrivals against a small pool
    flaky-servant    one servant's RPC surface fails ~20% of calls
    slow-loris       one servant answers, but seconds late
    oversized-tu     one adversarial client: 10x parallelism, megabyte
                     TUs; fairness quotas must protect the others
    cache-restart    the cache server restarts mid-spike
    overload-ladder  4x-capacity grant storm straight at the
                     scheduler; the admission ladder must walk
                     NORMAL -> ... -> REJECT and back, no flapping
    aot-storm        one client submits 16-topology AOT fan-outs
                     (doc/workloads.md) against a 4-slot pool while
                     interactive jit clients keep compiling; the
                     fairness-weight split (children inherit the
                     parent's key at 1/width weight) must hold every
                     victim at >= 80% of its share, and every parent
                     must still complete with explicit verdicts
    cell-kill        two federated cells, warm standby on cell 0;
                     overload must spill to the peer BEFORE local-only
                     degradation, then the active scheduler dies
                     mid-spike and the standby must take over within
                     one keep-alive interval with zero double-issued
                     grants and every pre-kill lease renewable
    cold-region      region A fills a shared L3 bucket, then an
                     EMPTY second region serves a paced key stream
                     over the same bucket twice — trace-prefetched vs
                     stone cold; zero errors in both arms, and
                     prefetch must reach 90% of the warm region's
                     steady hit rate >= 2x faster than read-through
                     promotion alone
    spill-affinity   three federated cells, the home cell pinned at
                     the spillover rung; a zipf key stream spills
                     under scored placement (device cost matrix:
                     warmth + load + topology) vs the least-loaded
                     baseline.  Scored must land spills on the WARM
                     peer despite its higher load — >= 1.3x the
                     baseline's post-spill hit rate, 0 errors — and
                     must divert to the cold peer once the warm one
                     fills solid (the load term still binds)
    noisy-neighbor   multi-tenant fairness (doc/tenancy.md): one
                     adversary tenant fanning demand across 100
                     client pids against a single-pid victim tenant
                     on one shared grant queue; the two-level stride
                     must hold the victim at >= 0.8 of its tenant
                     share no matter how many pids the adversary
                     spreads across
    cache-poisoning  cryptographic cache isolation: an adversary who
                     KNOWS a victim's plaintext cache key (determinism
                     makes it guessable) must neither read the
                     victim's artifact nor plant an entry the victim
                     will consume; the victim's own fill and read-back
                     must still work, and the legacy empty-secret
                     domain must stay byte-identical
    tier-inversion   tier x rung shedding matrix: drive the ladder to
                     SHED_OPTIONAL and SPILLOVER with real held
                     grants; best-effort demand must be refused with
                     native REJECT+retry-after while interactive
                     demand keeps MINTING grants at the same rungs —
                     and the ladder's own LOCAL_ONLY/REJECT verdicts
                     are never softened for anyone

Each scenario returns a JSON-able dict with its measurements, its SLO
bounds, and a per-bound pass flag; ``run_matrix`` aggregates them (and
``--out`` writes them to a file).  ``--smoke`` shrinks the task counts
(exit 1 on any SLO miss):

    python -m yadcc_tpu_torch.tools.scenarios --smoke --device cpu \
        --policy greedy_cpu
"""

from __future__ import annotations

import json
import os
import random
import shutil
import tempfile
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np

from ..rpc import transport
from ..rpc.transport import RpcError, STATUS_TRANSPORT_FAILURE
from ..scheduler.admission import (RUNG_NAMES, RUNG_NORMAL, RUNG_REJECT,
                                   AdmissionConfig)

SCENARIO_NAMES = ("wan-jitter", "burst", "flaky-servant", "slow-loris",
                  "oversized-tu", "cache-restart", "overload-ladder",
                  "aot-storm", "cell-kill", "cold-region",
                  "spill-affinity", "noisy-neighbor", "cache-poisoning",
                  "tier-inversion")


# --------------------------------------------------------------------------
# Fault injectors: callables for rpc.transport.install_fault_injector.
# --------------------------------------------------------------------------


class WanJitter:
    """Every matching call pays base + Exp(mean) extra milliseconds —
    a long-haul link with queueing jitter, clipped so a pathological
    draw can't exceed an RPC deadline."""

    def __init__(self, base_ms: float = 5.0, jitter_mean_ms: float = 10.0,
                 clip_ms: float = 80.0, seed: int = 7):
        self._base = base_ms
        self._jitter = jitter_mean_ms
        self._clip = clip_ms
        self._rng = random.Random(seed)

    def __call__(self, target: str, service: str, method: str) -> None:
        delay = min(self._base + self._rng.expovariate(1.0 / self._jitter),
                    self._clip)
        time.sleep(delay / 1000.0)


class FlakyTarget:
    """Calls to one target fail with probability p — a servant with a
    dying NIC.  Deterministic rng: reruns reproduce."""

    def __init__(self, target: str, fail_prob: float = 0.2,
                 service: str = "ytpu.DaemonService", seed: int = 11):
        self._target = target
        self._p = fail_prob
        self._service = service
        self._rng = random.Random(seed)
        self.injected = 0

    def __call__(self, target: str, service: str, method: str) -> None:
        if (target == self._target and service == self._service
                and self._rng.random() < self._p):
            self.injected += 1
            raise RpcError(STATUS_TRANSPORT_FAILURE,
                           "scenario: injected flaky-servant failure")


class SlowLoris:
    """One servant answers everything late — alive enough to hold
    leases, slow enough to stall anyone who waits politely."""

    def __init__(self, target: str, delay_s: float = 1.5,
                 service: str = "ytpu.DaemonService"):
        self._target = target
        self._delay = delay_s
        self._service = service

    def __call__(self, target: str, service: str, method: str) -> None:
        if target == self._target and service == self._service:
            time.sleep(self._delay)


def compose(*injectors) -> Callable[[str, str, str], None]:
    def fn(target: str, service: str, method: str) -> None:
        for inj in injectors:
            inj(target, service, method)
    return fn


class installed_faults:
    """Context manager installing/clearing the process fault hook."""

    def __init__(self, injector) -> None:
        self._injector = injector

    def __enter__(self):
        transport.install_fault_injector(self._injector)
        return self._injector

    def __exit__(self, *exc):
        transport.install_fault_injector(None)
        return False


# --------------------------------------------------------------------------
# Measurement plumbing shared by every scenario.
# --------------------------------------------------------------------------


@dataclass
class ClientSpec:
    """One simulated build client (a distinct requestor on the box)."""

    name: str
    pid: int
    n_tasks: int
    parallelism: int = 1
    tu_bytes: int = 256
    # Seconds to sleep between submissions per worker thread; callables
    # get (task_index, elapsed_s) — bursty schedules live here.
    inter_arrival: object = 0.0
    adversary: bool = False


@dataclass
class _Counts:
    submitted: int = 0
    ok_remote: int = 0
    local_fallback: int = 0
    hard_failures: int = 0
    lost_or_hung: int = 0
    latencies: List[float] = field(default_factory=list)
    lat_when: List[float] = field(default_factory=list)


class _RungMonitor:
    """Samples the scheduler's admission rung on a short cadence; the
    timeline buckets client latencies per rung and proves ladder
    transitions (reach REJECT, recover, no flapping)."""

    def __init__(self, dispatcher, period_s: float = 0.05):
        self._d = dispatcher
        self._period = period_s
        self._stop = threading.Event()
        # (elapsed_s, rung) samples.
        self.samples: List[tuple] = []  # guarded by: self._lock
        self._lock = threading.Lock()
        self._t0 = time.monotonic()
        self._thread = threading.Thread(target=self._loop,
                                        name="rung-monitor", daemon=True)

    def start(self):
        self._t0 = time.monotonic()
        self._thread.start()
        return self

    def _loop(self):
        while not self._stop.wait(self._period):
            rung = self._d.admission.rung()
            with self._lock:
                self.samples.append((time.monotonic() - self._t0, rung))

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=2)

    def rung_at(self, elapsed: float) -> int:
        with self._lock:
            rung = RUNG_NORMAL
            for t, r in self.samples:
                if t > elapsed:
                    break
                rung = r
            return rung

    def max_rung(self) -> int:
        with self._lock:
            return max((r for _, r in self.samples), default=RUNG_NORMAL)


def _pctl(values_ms: List[float], q: float) -> Optional[float]:
    if not values_ms:
        return None
    return round(float(np.percentile(np.array(values_ms), q)), 1)


def _check_slo(measured: dict, slo: dict) -> dict:
    """{bound_name: ok} for every bound; missing measurements fail
    loudly rather than pass silently."""
    checks = {}
    for key, bound in slo.items():
        if key.endswith("_min"):
            v = measured.get(key[: -len("_min")])
            checks[key] = v is not None and v >= bound
        elif key.endswith("_max"):
            v = measured.get(key[: -len("_max")])
            checks[key] = v is not None and v <= bound
        else:
            checks[key] = False
    return checks


# --------------------------------------------------------------------------
# The full-stack hostile world runner (every scenario except the raw
# overload-ladder storm drives the REAL client -> delegate -> scheduler
# -> servant -> cache pipeline).
# --------------------------------------------------------------------------


def _run_world(
    *,
    clients: List[ClientSpec],
    servants: int = 2,
    concurrency: int = 2,
    compile_s: float = 0.02,
    cache_control: int = 1,
    injector_factory=None,      # (cluster) -> injector or None
    mid_run=None,               # (cluster, counts_so_far) -> None
    mid_run_after_frac: float = 0.4,
    task_timeout_s: float = 60.0,
    retries: int = 2,
    admission_config: Optional[AdmissionConfig] = None,
    policy: str = "greedy_cpu",
    device: str = "cuda",
) -> dict:
    from ..common import compress
    from ..common.hashing import digest_bytes, digest_file
    from ..daemon.local.cxx_task import CxxCompilationTask
    from ..testing import LocalCluster, make_fake_compiler

    tmp = Path(tempfile.mkdtemp(prefix="chaos_"))
    compiler = make_fake_compiler(str(tmp / "bin"), compile_s=compile_s)
    compiler_digest = digest_file(compiler)
    cluster = LocalCluster(tmp, n_servants=servants, policy=policy,
                           device=device,
                           servant_concurrency=concurrency,
                           compiler_dirs=[str(tmp / "bin")],
                           admission_config=admission_config)
    monitor = _RungMonitor(cluster.sched_dispatcher).start()
    counts: Dict[str, _Counts] = {c.name: _Counts() for c in clients}
    counts_lock = threading.Lock()
    total_tasks = sum(c.n_tasks for c in clients)
    done_total = [0]
    mid_run_fired = [False]
    t0 = time.monotonic()

    def make_task(spec: ClientSpec, i: int) -> CxxCompilationTask:
        filler = (b"/* %d */ " % i) * max(1, spec.tu_bytes // 10)
        src = (f"// {spec.name} tu{i}\n".encode() + filler
               + f"\nint f_{spec.pid}_{i}() {{ return {i}; }}\n".encode())
        return CxxCompilationTask(
            requestor_pid=spec.pid,
            source_path=f"/src/{spec.name}/tu{i}.cc",
            source_digest=digest_bytes(src),
            invocation_arguments="-O2",
            cache_control=cache_control,
            compiler_digest=compiler_digest,
            compressed_source=compress.compress(src),
        )

    def submit_one(spec: ClientSpec, i: int) -> None:
        t_sub = time.monotonic()
        outcome = "lost"
        for _ in range(1 + retries):
            tid = cluster.delegate.queue_task(make_task(spec, i))
            result = cluster.delegate.wait_for_task(tid, task_timeout_s)
            cluster.delegate.free_task(tid)
            if result is None:
                outcome = "lost"       # hung past the generous timeout
                break
            if result.exit_code == 0:
                outcome = "remote"
                break
            if result.exit_code > 0:
                outcome = "hard"       # deterministic compile failure
                break
            outcome = "infra"          # retry, then fall back local
        if outcome == "infra":
            # The survival contract (yadcc/README.md:21-27): the client
            # compiles locally when the cloud can't serve.  Local CPU
            # time is simulated; the SUBMISSION still succeeded.
            time.sleep(compile_s)
            outcome = "local"
        dt_ms = (time.monotonic() - t_sub) * 1000.0
        with counts_lock:
            c = counts[spec.name]
            c.submitted += 1
            c.latencies.append(dt_ms)
            c.lat_when.append(t_sub - t0)
            if outcome == "remote":
                c.ok_remote += 1
            elif outcome == "local":
                c.local_fallback += 1
            elif outcome == "hard":
                c.hard_failures += 1
            else:
                c.lost_or_hung += 1
            done_total[0] += 1
            fire_mid = (mid_run is not None and not mid_run_fired[0]
                        and done_total[0] >= total_tasks
                        * mid_run_after_frac)
            if fire_mid:
                mid_run_fired[0] = True
        if fire_mid:
            mid_run(cluster, dict(done=done_total[0]))

    def client_worker(spec: ClientSpec, worker_idx: int, todo: List[int]):
        while True:
            with counts_lock:
                if not todo:
                    return
                i = todo.pop()
            delay = spec.inter_arrival
            if callable(delay):
                delay = delay(i, time.monotonic() - t0)
            if delay:
                time.sleep(delay)
            submit_one(spec, i)

    injector = injector_factory(cluster) if injector_factory else None
    try:
        with installed_faults(injector):
            threads = []
            for spec in clients:
                todo = list(range(spec.n_tasks))
                for w in range(spec.parallelism):
                    t = threading.Thread(
                        target=client_worker, args=(spec, w, todo),
                        name=f"client-{spec.name}-{w}", daemon=True)
                    threads.append(t)
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=600)
        wall = time.monotonic() - t0
    finally:
        monitor.stop()
        cluster.stop()
        shutil.rmtree(tmp, ignore_errors=True)

    all_lat = [l for c in counts.values() for l in c.latencies]
    all_when = [w for c in counts.values() for w in c.lat_when]
    per_rung: Dict[str, List[float]] = {}
    for lat, when in zip(all_lat, all_when):
        per_rung.setdefault(RUNG_NAMES[monitor.rung_at(when)],
                            []).append(lat)
    total = sum(c.submitted for c in counts.values())
    survived = sum(c.ok_remote + c.local_fallback for c in counts.values())
    out = {
        "tasks": total,
        "wall_seconds": round(wall, 2),
        "ok_remote": sum(c.ok_remote for c in counts.values()),
        "local_fallback": sum(c.local_fallback for c in counts.values()),
        "hard_failures": sum(c.hard_failures for c in counts.values()),
        "lost_or_hung": sum(c.lost_or_hung for c in counts.values()),
        "compile_success_rate": round(survived / max(1, total), 4),
        "latency_p50_ms": _pctl(all_lat, 50),
        "latency_p99_ms": _pctl(all_lat, 99),
        "latency_p99_ms_by_rung": {k: _pctl(v, 99)
                                   for k, v in per_rung.items()},
        "max_rung": RUNG_NAMES[monitor.max_rung()],
        "per_client": {
            name: {"submitted": c.submitted, "ok_remote": c.ok_remote,
                   "local_fallback": c.local_fallback,
                   "lost_or_hung": c.lost_or_hung}
            for name, c in counts.items()
        },
    }
    return out


# --------------------------------------------------------------------------
# Scenario definitions.
# --------------------------------------------------------------------------


def _steady_clients(n_clients: int, tasks_each: int,
                    parallelism: int = 2) -> List[ClientSpec]:
    return [ClientSpec(name=f"c{i}", pid=1000 + i, n_tasks=tasks_each,
                       parallelism=parallelism)
            for i in range(n_clients)]


def _servant_target(cluster, idx: int) -> str:
    return f"127.0.0.1:{cluster.servants[idx].server.port}"


def _scn_wan_jitter(smoke: bool, policy: str, device: str) -> dict:
    tasks = 20 if smoke else 60
    out = _run_world(
        policy=policy, device=device,
        clients=_steady_clients(2, tasks),
        compile_s=0.01,
        injector_factory=lambda cluster: WanJitter(
            base_ms=5.0, jitter_mean_ms=10.0, clip_ms=80.0),
    )
    slo = {"compile_success_rate_min": 0.99, "lost_or_hung_max": 0,
           "latency_p99_ms_max": 20_000.0}
    out["slo"] = slo
    out["slo_checks"] = _check_slo(out, slo)
    return out


def _scn_burst(smoke: bool, policy: str, device: str) -> dict:
    tasks = 24 if smoke else 80

    def diurnal(i: int, elapsed: float) -> float:
        # 2s cycle: a quiet half (trickle) and a spike half (burst).
        return 0.12 if (elapsed % 2.0) < 1.0 else 0.0

    clients = [ClientSpec(name=f"c{i}", pid=1100 + i, n_tasks=tasks,
                          parallelism=3, inter_arrival=diurnal)
               for i in range(2)]
    out = _run_world(clients=clients, compile_s=0.01, policy=policy,
                     device=device)
    slo = {"compile_success_rate_min": 0.99, "lost_or_hung_max": 0,
           "latency_p99_ms_max": 20_000.0}
    out["slo"] = slo
    out["slo_checks"] = _check_slo(out, slo)
    return out


def _scn_flaky_servant(smoke: bool, policy: str, device: str) -> dict:
    tasks = 20 if smoke else 60
    holder = {}

    def factory(cluster):
        holder["inj"] = FlakyTarget(_servant_target(cluster, 0),
                                    fail_prob=0.25)
        return holder["inj"]

    out = _run_world(
        policy=policy, device=device,
        clients=_steady_clients(2, tasks),
        compile_s=0.01,
        injector_factory=factory,
        retries=3,
    )
    out["injected_failures"] = holder["inj"].injected
    slo = {"compile_success_rate_min": 0.99, "lost_or_hung_max": 0,
           "injected_failures_min": 1,  # the storm actually happened
           "latency_p99_ms_max": 30_000.0}
    out["slo"] = slo
    out["slo_checks"] = _check_slo(out, slo)
    return out


def _scn_slow_loris(smoke: bool, policy: str, device: str) -> dict:
    tasks = 12 if smoke else 36
    out = _run_world(
        policy=policy, device=device,
        clients=_steady_clients(2, tasks),
        compile_s=0.01,
        servants=2,
        injector_factory=lambda cluster: SlowLoris(
            _servant_target(cluster, 0), delay_s=1.2),
        task_timeout_s=90.0,
    )
    slo = {"compile_success_rate_min": 0.99, "lost_or_hung_max": 0,
           "latency_p99_ms_max": 60_000.0}
    out["slo"] = slo
    out["slo_checks"] = _check_slo(out, slo)
    return out


def _scn_oversized_tu(smoke: bool, policy: str, device: str) -> dict:
    """One adversary: 10x the parallelism, megabyte TUs, cache
    disabled so every submission needs a grant.  Weighted-fair
    admission must hold every victim at >= 80% of its fair share."""
    victim_tasks = 10 if smoke else 30
    adv_tasks = victim_tasks * 10
    clients = [
        ClientSpec(name="adversary", pid=666, n_tasks=adv_tasks,
                   parallelism=10, tu_bytes=1 << 20, adversary=True),
    ] + [
        ClientSpec(name=f"victim{i}", pid=2000 + i, n_tasks=victim_tasks,
                   parallelism=1, tu_bytes=512)
        for i in range(3)
    ]
    out = _run_world(
        policy=policy, device=device,
        clients=clients,
        servants=2, concurrency=2,
        compile_s=0.05,
        cache_control=0,  # force the grant path for every task
        # Isolate fairness from admission: the ladder must not convert
        # the adversary's storm into LOCAL_ONLY verdicts here.
        admission_config=AdmissionConfig(
            up_thresholds=(1e9, 1e9, 1e9, 1e9)),
        task_timeout_s=120.0,
    )
    # Fairness dispersion: while the adversary saturates, victims each
    # submit serially — their throughput is their share.  Compare each
    # victim's remote-compile rate against the no-contention ideal of
    # one fair share of servant capacity.
    per = out["per_client"]
    victims = {k: v for k, v in per.items() if k != "adversary"}
    n_clients = len(per)
    fair_share = out["tasks"] / n_clients
    # A victim that finished all its tasks had its demand met — demand
    # below fair share caps the achievable "share".
    shares = {}
    for k, v in victims.items():
        demand = v["submitted"]
        served = v["ok_remote"] + v["local_fallback"]
        shares[k] = round(served / min(fair_share, demand), 3)
    out["fairness"] = {
        "fair_share_tasks": round(fair_share, 1),
        "victim_share_ratio": shares,
        "min_victim_share_ratio": round(min(shares.values()), 3),
        "adversary_served": per["adversary"]["ok_remote"]
        + per["adversary"]["local_fallback"],
    }
    out["min_victim_share_ratio"] = out["fairness"][
        "min_victim_share_ratio"]
    slo = {"compile_success_rate_min": 0.99, "lost_or_hung_max": 0,
           "min_victim_share_ratio_min": 0.8}
    out["slo"] = slo
    out["slo_checks"] = _check_slo(out, slo)
    return out


def _scn_cache_restart(smoke: bool, policy: str, device: str) -> dict:
    tasks = 20 if smoke else 60

    def mid_run(cluster, progress):
        cluster.restart_cache_server(down_for_s=0.5)

    out = _run_world(
        policy=policy, device=device,
        clients=_steady_clients(2, tasks),
        compile_s=0.01,
        mid_run=mid_run,
        mid_run_after_frac=0.3,
        retries=3,
    )
    slo = {"compile_success_rate_min": 0.99, "lost_or_hung_max": 0,
           "latency_p99_ms_max": 30_000.0}
    out["slo"] = slo
    out["slo_checks"] = _check_slo(out, slo)
    return out


def _scn_overload_ladder(smoke: bool, policy: str, device: str) -> dict:
    """4x-capacity grant storm straight at the real SchedulerService
    over loopback gRPC.  Asserts the tentpole contract: the ladder
    climbs to REJECT (fast, explicit verdicts with server-computed
    retry-after), recovers to NORMAL once the storm ends, and does not
    flap.  Storm clients behave like real delegates: they honor
    retry-after, and when retries exhaust their budget they fall back
    to local compilation — every task resolves."""
    from .. import api
    from ..jit.env import local_jit_environment
    from ..rpc import Channel
    from ..testing import LocalCluster

    tasks_per_thread = 3 if smoke else 6
    n_threads = 16  # vs pool capacity 4: the synthetic 4x overload
    cfg = AdmissionConfig(
        up_thresholds=(1.2, 1.6, 2.0, 3.0),
        up_dwell_s=0.15, down_dwell_s=0.6,
        demand_window_s=1.5,
        retry_after_base_ms=100, retry_after_max_ms=800)
    tmp = Path(tempfile.mkdtemp(prefix="ladder_"))
    cluster = LocalCluster(tmp, n_servants=2, policy=policy, device=device,
                           servant_concurrency=2, admission_config=cfg)
    monitor = _RungMonitor(cluster.sched_dispatcher, period_s=0.03).start()
    # The environment the rig's servants serve (this host's jit
    # environment): the storm's grant requests match it.
    env = local_jit_environment().digest

    # Production runs a 1s expiration sweep (scheduler/entry.py) that
    # also re-evaluates the ladder; the rig needs one for the ladder to
    # step down while the pool is quiet.
    sweep_stop = threading.Event()

    def sweeper():
        while not sweep_stop.wait(0.25):
            cluster.sched_dispatcher.on_expiration_timer()

    threading.Thread(target=sweeper, name="ladder-sweep",
                     daemon=True).start()

    lock = threading.Lock()
    calls: List[dict] = []
    results = {"remote": 0, "local": 0, "lost": 0}

    def wait_call(chan, wait_ms: int):
        req = api.scheduler.WaitForStartingTaskRequest(
            token="", milliseconds_to_wait=wait_ms, immediate_reqs=1,
            next_keep_alive_in_ms=5000)
        req.env_desc.compiler_digest = env
        t0 = time.monotonic()
        flow, rung, retry_after_s, grants = 0, 0, 0.0, []
        try:
            resp, _ = chan.call(
                "ytpu.SchedulerService", "WaitForStartingTask", req,
                api.scheduler.WaitForStartingTaskResponse,
                timeout=wait_ms / 1000.0 + 2.0)
            flow = resp.flow_control
            rung = resp.degradation_rung
            retry_after_s = resp.retry_after_ms / 1000.0
            grants = [g.task_grant_id for g in resp.grants]
        except RpcError:
            pass  # NO_QUOTA refusal after the wait window: a dry answer
        wall_ms = (time.monotonic() - t0) * 1000.0
        with lock:
            calls.append({"ms": wall_ms, "flow": flow, "rung": rung})
        return grants, flow, retry_after_s

    def storm_thread(idx: int):
        chan = Channel(cluster.sched_uri)
        for _ in range(tasks_per_thread):
            deadline = time.monotonic() + 3.0
            outcome = None
            while outcome is None:
                grants, flow, retry_after_s = wait_call(chan, wait_ms=300)
                if grants:
                    time.sleep(0.3)  # the "compile" holds the grant
                    chan.call("ytpu.SchedulerService", "FreeTask",
                              api.scheduler.FreeTaskRequest(
                                  token="", task_grant_ids=grants),
                              api.scheduler.FreeTaskResponse, timeout=5.0)
                    outcome = "remote"
                elif flow == 1:         # FLOW_CONTROL_COMPILE_LOCALLY
                    outcome = "local"
                elif time.monotonic() > deadline:
                    # Retry budget exhausted under REJECT: the survival
                    # contract says compile locally, not hang.
                    outcome = "local"
                elif flow == 2:         # FLOW_CONTROL_REJECT
                    time.sleep(min(retry_after_s or 0.1, 0.8))
            with lock:
                results[outcome] += 1

    threads = [threading.Thread(target=storm_thread, args=(i,),
                                name=f"storm-{i}", daemon=True)
               for i in range(n_threads)]
    t_storm = time.monotonic()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        if t.is_alive():
            with lock:
                results["lost"] += 1
    storm_s = time.monotonic() - t_storm

    # Recovery: a low-rate probe (one delegate still poking the
    # scheduler) while the sweep re-evaluates; the ladder must walk
    # back down to NORMAL with hysteresis.
    probe = Channel(cluster.sched_uri)
    recovered_at = None
    recovery_deadline = time.monotonic() + (12.0 if smoke else 20.0)
    try:
        while time.monotonic() < recovery_deadline:
            grants, _, _ = wait_call(probe, wait_ms=50)
            if grants:
                probe.call("ytpu.SchedulerService", "FreeTask",
                           api.scheduler.FreeTaskRequest(
                               token="", task_grant_ids=grants),
                           api.scheduler.FreeTaskResponse, timeout=5.0)
            if cluster.sched_dispatcher.admission.rung() == RUNG_NORMAL:
                recovered_at = time.monotonic() - t_storm
                break
            time.sleep(0.4)
    finally:
        transitions = cluster.sched_dispatcher.admission.transitions()
        admission = cluster.sched_dispatcher.admission.inspect()
        sweep_stop.set()
        monitor.stop()
        cluster.stop()
        shutil.rmtree(tmp, ignore_errors=True)

    reject_ms = [c["ms"] for c in calls if c["flow"] == 2]
    local_ms = [c["ms"] for c in calls if c["flow"] == 1]
    total_tasks = n_threads * tasks_per_thread
    survived = results["remote"] + results["local"]
    per_rung: Dict[str, List[float]] = {}
    for c in calls:
        per_rung.setdefault(RUNG_NAMES[c["rung"]], []).append(c["ms"])
    out = {
        "tasks": total_tasks,
        "storm_threads": n_threads,
        "pool_capacity": 4,
        "overload_factor": 4.0,
        "storm_seconds": round(storm_s, 2),
        "ok_remote": results["remote"],
        "local_fallback": results["local"],
        "hard_failures": 0,
        "lost_or_hung": results["lost"]
        + (total_tasks - survived - results["lost"]),
        "compile_success_rate": round(survived / total_tasks, 4),
        "grant_calls": len(calls),
        "reject_verdicts": len(reject_ms),
        "local_only_verdicts": len(local_ms),
        "reject_p99_ms": _pctl(reject_ms, 99),
        "latency_p99_ms_by_rung": {k: _pctl(v, 99)
                                   for k, v in per_rung.items()},
        "max_rung": RUNG_NAMES[monitor.max_rung()],
        "reached_reject": int(monitor.max_rung() >= RUNG_REJECT),
        "recovered_to_normal": int(recovered_at is not None),
        "recovery_seconds_after_storm": (
            round(recovered_at - storm_s, 2)
            if recovered_at is not None else None),
        "rung_transitions": admission["transitions"],
        "transition_count": len(transitions),
        "admission_stats": admission["stats"],
    }
    slo = {
        "compile_success_rate_min": 0.99,
        "lost_or_hung_max": 0,
        "reached_reject_min": 1,
        "recovered_to_normal_min": 1,
        # Hysteresis: one climb + one descent, small slack — a flapping
        # ladder would blow straight through this.
        "transition_count_max": 10,
        "reject_verdicts_min": 1,
        # A REJECT answer is an immediate verdict, not a queue wait.
        "reject_p99_ms_max": 250.0,
    }
    out["slo"] = slo
    out["slo_checks"] = _check_slo(out, slo)
    return out


def _scn_cell_kill(smoke: bool, policy: str, device: str) -> dict:
    """Federation tentpole proof (doc/robustness.md "Failover state
    machine"): two scheduler cells, warm standby on cell 0, a grant
    storm aimed at cell 0's key range, then a kill -9 of cell 0's
    active scheduler mid-spike.

    Two claims, one artifact:

    * **spillover before LOCAL_ONLY** — cell 0's ladder reaches
      SPILLOVER and sheds grants to cell 1 (provenance stamped on the
      wire: ``grants[].cell_id``/``spilled``) while the fleet's
      success rate stays at 1.0 and nobody is told to compile locally;
    * **failover ≤ one keep-alive interval** — the standby's silence
      monitor promotes the mirror; storm clients ride the failover
      URI list (active,standby) through NOT_SERVING refusals with
      server-computed retry-after and land grants on the promoted
      scheduler, with zero double-issued grant ids across the
      takeover (the two-level namespace + adoption floor) and every
      pre-kill grant renewable exactly once (lease adoption).
    """
    from .. import api
    from ..rpc import Channel
    from ..scheduler.admission import RUNG_SPILLOVER
    from ..testing.federated_cluster import FederatedCluster

    tasks_per_thread = 6 if smoke else 10
    n_threads = 8 if smoke else 12
    keep_alive_ms = 3000  # the failover SLO bound: one renewal interval
    compile_s = 0.15
    # Cell 0: tiny pool, ladder tuned to hit SPILLOVER early but
    # LOCAL_ONLY only under absurd pressure — the rung between
    # SHED_OPTIONAL and LOCAL_ONLY is the whole point.
    cfg0 = AdmissionConfig(up_thresholds=(1.2, 1.6, 6.0, 9.0),
                           up_dwell_s=0.05, down_dwell_s=0.6,
                           demand_window_s=1.2,
                           retry_after_base_ms=100,
                           retry_after_max_ms=500)
    fc = FederatedCluster(2, servants_per_cell=2, servant_capacity=1,
                          env_digests=("env-fed",),
                          admission_configs=[cfg0, None],
                          streamer_interval_s=0.05,
                          heartbeat_ms=400, policy=policy, device=device)
    # The storm targets cell 0's key range: with one env digest the
    # client-side CellDirectory pick is a constant; dial cell 0.
    dial0 = fc.cell_dial_uri(0)

    sweep_stop = threading.Event()

    def sweeper():
        while not sweep_stop.wait(0.2):
            for r in fc.routers:
                try:
                    r.on_expiration_timer()
                except Exception:
                    pass  # mid-takeover: the handle swap is racy here

    threading.Thread(target=sweeper, name="fed-sweep",
                     daemon=True).start()

    lock = threading.Lock()
    issued: List[int] = []            # every grant id ever received
    spilled_seen = [0]                # provenance-stamped spill grants
    local_verdicts = [0]              # flow==1 answers (must stay 0)
    results = {"remote": 0, "local": 0, "lost": 0}
    first_grant_after_kill = [None]   # monotonic time of first success
    adopted_renews = [0, 0]           # [ok, failed] renewals of
    max_rung = [0]                    # pre-kill grants post-takeover

    kill_evt = threading.Event()

    def worker(idx: int) -> None:
        chan = Channel(dial0)
        for _ in range(tasks_per_thread):
            deadline = time.monotonic() + 8.0
            outcome = None
            while outcome is None:
                req = api.scheduler.WaitForStartingTaskRequest(
                    token="", milliseconds_to_wait=250, immediate_reqs=1,
                    next_keep_alive_in_ms=keep_alive_ms)
                req.env_desc.compiler_digest = "env-fed"
                flow, retry_s, grants = 0, 0.1, []
                try:
                    resp, _ = chan.call(
                        "ytpu.SchedulerService", "WaitForStartingTask",
                        req, api.scheduler.WaitForStartingTaskResponse,
                        timeout=2.5)
                    flow = resp.flow_control
                    retry_s = (resp.retry_after_ms or 100) / 1000.0
                    grants = list(resp.grants)
                    with lock:
                        max_rung[0] = max(max_rung[0],
                                          resp.degradation_rung)
                except RpcError:
                    retry_s = 0.1  # active dead / standby pre-promote
                if grants:
                    g = grants[0]
                    t_granted = time.monotonic()
                    with lock:
                        issued.append(g.task_grant_id)
                        if g.spilled:
                            spilled_seen[0] += 1
                        if (kill_evt.is_set()
                                and first_grant_after_kill[0] is None):
                            first_grant_after_kill[0] = t_granted
                    fc.note_run_start(g.servant_location,
                                      g.task_grant_id)
                    pre_kill = not kill_evt.is_set()
                    time.sleep(compile_s)
                    # A grant that straddled the kill is the adoption
                    # proof: the promoted scheduler must honor its
                    # lease exactly once.  Retry the renewal through
                    # the standby's NOT_SERVING window (one keep-alive
                    # interval budget), then free.
                    straddled = pre_kill and kill_evt.is_set()
                    renew_deadline = time.monotonic() + (
                        keep_alive_ms / 1000.0 if straddled else 0.0)
                    while True:
                        try:
                            kr = api.scheduler.KeepTaskAliveRequest(
                                token="",
                                task_grant_ids=[g.task_grant_id],
                                next_keep_alive_in_ms=keep_alive_ms)
                            kresp, _ = chan.call(
                                "ytpu.SchedulerService",
                                "KeepTaskAlive", kr,
                                api.scheduler.KeepTaskAliveResponse,
                                timeout=2.5)
                            if (straddled and not kresp.statuses[0]
                                    and time.monotonic()
                                    < renew_deadline):
                                # Journal-gap grant: the replica never
                                # saw it, so renewal answers False
                                # until the servant's next heartbeat
                                # re-reports it inside the adoption
                                # grace window.  Keep renewing — the
                                # delegate's real retry discipline.
                                time.sleep(0.15)
                                continue
                            if straddled:
                                with lock:
                                    adopted_renews[
                                        0 if kresp.statuses[0]
                                        else 1] += 1
                            chan.call(
                                "ytpu.SchedulerService", "FreeTask",
                                api.scheduler.FreeTaskRequest(
                                    token="",
                                    task_grant_ids=[g.task_grant_id]),
                                api.scheduler.FreeTaskResponse,
                                timeout=2.5)
                            break
                        except RpcError:
                            # Active dead / standby pre-promote: the
                            # delegate keeps renewing until promote.
                            if time.monotonic() >= renew_deadline:
                                break  # lease expiry cleans up
                            time.sleep(0.1)
                    fc.note_run_end(g.servant_location, g.task_grant_id)
                    outcome = "remote"
                elif flow == 1:
                    with lock:
                        local_verdicts[0] += 1
                    outcome = "local"
                elif time.monotonic() > deadline:
                    outcome = "local"  # survival contract: never hang
                else:
                    time.sleep(min(retry_s, 0.5))
            with lock:
                results[outcome] += 1
        chan.close()

    fc.arm_monitor(silence_s=0.5)
    threads = [threading.Thread(target=worker, args=(i,),
                                name=f"fed-storm-{i}", daemon=True)
               for i in range(n_threads)]
    t0 = time.monotonic()
    for t in threads:
        t.start()

    # Let phase A (spillover under overload) run, then kill the
    # active mid-spike — early enough that most of the storm still
    # has to ride through the failover.
    time.sleep(0.8 if smoke else 1.5)
    rung_at_kill = fc.routers[0].admission_rung()
    spill_stats_at_kill = fc.routers[0].stats()
    t_kill = fc.kill_active()
    kill_evt.set()

    promoted = fc.wait_promoted(10.0)
    for t in threads:
        t.join(timeout=60)
        if t.is_alive():
            with lock:
                results["lost"] += 1
    storm_s = time.monotonic() - t0
    sweep_stop.set()

    report = fc.takeover_report or {}
    post_stats = fc.routers[0].stats()
    failover_ms = (
        (first_grant_after_kill[0] - t_kill) * 1000.0
        if first_grant_after_kill[0] is not None else None)
    fc.stop()

    total = n_threads * tasks_per_thread
    survived = results["remote"] + results["local"]
    dupes = len(issued) - len(set(issued))
    out = {
        "tasks": total,
        "storm_threads": n_threads,
        "storm_seconds": round(storm_s, 2),
        "cells": 2,
        "ok_remote": results["remote"],
        "local_fallback": results["local"],
        "lost_or_hung": results["lost"] + (total - survived
                                           - results["lost"]),
        "compile_success_rate": round(survived / total, 4),
        # -- spillover (phase A) --
        "rung_at_kill": rung_at_kill,
        "max_rung_seen": max_rung[0],
        "spilled_grants_stamped": spilled_seen[0],
        "spilled_grants_at_kill": spill_stats_at_kill.get(
            "spilled_grants", 0),
        "spillover_engaged": int(
            spill_stats_at_kill.get("spilled_grants", 0) > 0
            or spilled_seen[0] > 0),
        "local_only_verdicts": local_verdicts[0],
        # -- failover (phase B) --
        "promoted": int(promoted),
        "failover_time_ms": (round(failover_ms, 1)
                             if failover_ms is not None else None),
        "keep_alive_interval_ms": keep_alive_ms,
        "takeover_ms": round(report.get("takeover_ms", -1.0), 2),
        "servants_replayed": report.get("servants_replayed", 0),
        "grants_adopted": report.get("grants_adopted", 0),
        "adoption_floor": report.get("adoption_floor", 0),
        "restored_rung": report.get("restored_rung", -1),
        "adopted_renewals_ok": adopted_renews[0],
        "adopted_renewals_failed": adopted_renews[1],
        # -- exactly-once accounting --
        "grants_issued": len(issued),
        "double_runs": dupes,
        "foreign_frees_routed": post_stats.get("foreign_frees", 0),
    }
    slo = {
        "compile_success_rate_min": 0.99,
        "double_runs_max": 0,
        "promoted_min": 1,
        # A scheduler death costs one renewal interval, not the fleet.
        "failover_time_ms_max": float(keep_alive_ms),
        # Spillover is the rung BEFORE local-only: it must have
        # engaged, and nobody may have been degraded to local compiles.
        "spillover_engaged_min": 1,
        "local_only_verdicts_max": 0,
        "adopted_renewals_failed_max": 0,
        "lost_or_hung_max": 0,
    }
    out["spillover_rung"] = RUNG_SPILLOVER  # what rung_at_kill is read against
    out["slo"] = slo
    out["slo_checks"] = _check_slo(out, slo)
    return out


def _scn_aot_storm(smoke: bool, policy: str, device: str) -> dict:
    """Fan-out/fairness interaction (doc/workloads.md): one bulk
    client hammers the pool with 16-topology AOT submissions while
    interactive jit clients keep submitting single compiles THROUGH
    THE SAME env-matched grant queue.  Because fan-out children
    inherit the parent requestor's fairness key and split its weight
    (jit/fanout.py split_fairness), the whole storm draws one
    submission's share per parent from FairGrantQueue — the victims'
    interactive latency survives, and the parents still complete with
    explicit per-child verdicts (starved children retry, then report
    infra; nothing hangs)."""
    from ..common import compress
    from ..common.hashing import digest_bytes
    from ..daemon.local.aot_task import AotBuildTask
    from ..daemon.local.jit_task import JitCompilationTask
    from ..jit.env import local_jit_environment
    from ..jit.fanout import TopologySpec
    from ..testing import LocalCluster

    victim_tasks = 6 if smoke else 14
    n_victims = 3
    n_parents = 2 if smoke else 4
    width = 16
    saved = {k: os.environ.get(k)
             for k in ("YTPU_JIT_FAKE_WORKER", "YTPU_JIT_FAKE_SLEEP_S")}
    os.environ["YTPU_JIT_FAKE_WORKER"] = "1"
    os.environ["YTPU_JIT_FAKE_SLEEP_S"] = "0.05"
    tmp = Path(tempfile.mkdtemp(prefix="aotstorm_"))
    # The rig's servants serve this host's jit environment explicitly
    # (with or without nvcc), and the fake worker builds: the storm
    # needs no toolchain.
    env = local_jit_environment()
    cluster = LocalCluster(tmp, n_servants=2, policy=policy, device=device,
                           servant_concurrency=2, jit_environments=[env])
    topologies = [TopologySpec(mesh_shape=(n,), device_count=n).validate()
                  for n in range(1, width + 1)]

    lock = threading.Lock()
    victim_counts = {f"victim{i}": _Counts() for i in range(n_victims)}
    parent_results: List[dict] = []

    def submit(delegate, task, timeout_s: float):
        tid = delegate.queue_task(task)
        result = delegate.wait_for_task(tid, timeout_s)
        delegate.free_task(tid)
        return result

    def victim_worker(idx: int):
        name = f"victim{idx}"
        pid = 2000 + idx
        for i in range(victim_tasks):
            hlo = (f"module @v{pid}_{i} {{ func.func public @main() "
                   f"{{ return }} }}").encode()
            t_sub = time.monotonic()
            outcome = "lost"
            for _ in range(3):
                result = submit(cluster.delegate, JitCompilationTask(
                    requestor_pid=pid,
                    computation_digest=digest_bytes(hlo),
                    compile_options=b"", backend=env.backend,
                    toolchain_version=env.toolchain_version,
                    cache_control=0,
                    compressed_computation=compress.compress(hlo),
                ), timeout_s=60.0)
                if result is None:
                    break
                if result.exit_code == 0:
                    outcome = "remote"
                    break
                outcome = "infra"
            if outcome == "infra":
                outcome = "local"  # survival contract: compile locally
            dt_ms = (time.monotonic() - t_sub) * 1000.0
            with lock:
                c = victim_counts[name]
                c.submitted += 1
                c.latencies.append(dt_ms)
                if outcome == "remote":
                    c.ok_remote += 1
                elif outcome == "local":
                    c.local_fallback += 1
                else:
                    c.lost_or_hung += 1

    def adversary_worker(idx: int):
        hlo = (f"module @storm{idx} {{ func.func public @main() "
               f"{{ return }} }}").encode()
        result = submit(cluster.delegate, AotBuildTask(
            requestor_pid=666,
            computation_digest=digest_bytes(hlo),
            backend=env.backend,
            toolchain_version=env.toolchain_version,
            cache_control=0,
            topologies=list(topologies),
            compressed_computation=compress.compress(hlo),
        ), timeout_s=300.0)
        with lock:
            parent_results.append({
                "completed": result is not None,
                "exit_code": (result.exit_code if result is not None
                              else None),
                "verdicts": (len(result.verdicts)
                             if result is not None else 0),
                "children_ok": (sum(1 for v in result.verdicts
                                    if v.status in ("ok", "cached",
                                                    "joined"))
                                if result is not None else 0),
            })

    t0 = time.monotonic()
    try:
        threads = [threading.Thread(target=adversary_worker, args=(i,),
                                    name=f"storm-parent-{i}", daemon=True)
                   for i in range(n_parents)]
        threads += [threading.Thread(target=victim_worker, args=(i,),
                                     name=f"victim-{i}", daemon=True)
                    for i in range(n_victims)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        wall = time.monotonic() - t0
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        cluster.stop()
        shutil.rmtree(tmp, ignore_errors=True)

    # Victim share, the oversized-tu measure: demand below fair share
    # caps the achievable ratio at 1.0; a starved victim (lost tasks,
    # unmet demand) drops below it.
    total_units = (n_victims * victim_tasks + n_parents * width)
    fair_share = total_units / (n_victims + 1)
    shares = {}
    for name, c in victim_counts.items():
        served = c.ok_remote + c.local_fallback
        shares[name] = round(served / min(fair_share,
                                          max(1, c.submitted)), 3)
    victim_lat = [l for c in victim_counts.values()
                  for l in c.latencies]
    out = {
        "tasks": total_units,
        "wall_seconds": round(wall, 2),
        "storm_parents": n_parents,
        "fanout_width": width,
        "ok_remote": sum(c.ok_remote for c in victim_counts.values()),
        "local_fallback": sum(c.local_fallback
                              for c in victim_counts.values()),
        "lost_or_hung": sum(c.lost_or_hung
                            for c in victim_counts.values())
        + sum(1 for p in parent_results if not p["completed"]),
        "victim_latency_p50_ms": _pctl(victim_lat, 50),
        "victim_latency_p99_ms": _pctl(victim_lat, 99),
        "min_victim_share_ratio": round(min(shares.values()), 3),
        "victim_share_ratio": shares,
        "parents_completed": sum(1 for p in parent_results
                                 if p["completed"]),
        "parents_with_full_verdicts": sum(
            1 for p in parent_results if p["verdicts"] == width),
        "parent_children_ok_total": sum(p["children_ok"]
                                        for p in parent_results),
        "parent_results": parent_results,
    }
    out["compile_success_rate"] = round(
        (out["ok_remote"] + out["local_fallback"])
        / max(1, n_victims * victim_tasks), 4)
    slo = {
        "compile_success_rate_min": 0.99,
        "lost_or_hung_max": 0,
        # The fairness satellite's headline bound: no victim drops
        # below 80% of its share under the fan-out storm.
        "min_victim_share_ratio_min": 0.8,
        # The storm itself must terminate with explicit verdicts —
        # a hung parent is a fan-out bug, not a fairness win.
        "parents_completed_min": n_parents,
        "parents_with_full_verdicts_min": n_parents,
        "victim_latency_p99_ms_max": 60_000.0,
    }
    out["slo"] = slo
    out["slo_checks"] = _check_slo(out, slo)
    return out


def _scn_cold_region(smoke: bool, policy: str, device: str) -> dict:
    tmp = Path(tempfile.mkdtemp(prefix="coldregion_"))
    try:
        return _scn_cold_region_in(tmp, smoke, policy, device)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _scn_cold_region_in(tmp: Path, smoke: bool, policy: str,
        device: str) -> dict:
    """Cold-region rebuild A/B over the three-level cache.

    Region A fills a shared L3 bucket (the fleet's steady state), then
    a SECOND region boots with empty L1/L2 over the same bucket and
    serves a paced replay of "today's" key stream — twice: once warmed
    beforehand by the trace-driven prefetcher replaying "yesterday's"
    stream (cache/prefetcher.py), once stone cold, relying purely on
    L3 read-through promotion.  Measured per arm: windowed hit-rate
    curve, time to reach 90% of the warm region's steady-state hit
    rate, and errors (anything besides a clean NOT_FOUND).  The SLOs
    pin the tentpole's claims: zero errors while serving cold from L3,
    and prefetch reaching the warm threshold >= 2x faster."""
    del policy, device  # no scheduler: the cache tiers alone
    from .. import api
    from ..cache.disk_engine import DiskCacheEngine
    from ..cache.in_memory_cache import InMemoryCache
    from ..cache.object_store_engine import (FsObjectStoreBackend,
                                             ObjectStoreEngine)
    from ..cache.prefetcher import TracePrefetcher
    from ..cache.service import CacheService
    from ..common.disk_cache import ShardSpec
    from ..rpc import Channel, make_rpc_server
    from .trace_replay import generate_key_trace, load_key_trace

    n_keys = 40 if smoke else 300
    yesterday_draws = 300 if smoke else 2500
    today_draws = 400 if smoke else 3000
    payload = b"OBJ" * 340            # ~1KB entries
    pace_s = 0.002                    # ~500 req/s arrival stream
    window = 50                       # rolling hit-rate window

    bucket = tmp / "bucket"
    bucket.mkdir()
    yesterday = str(tmp / "yesterday.jsonl")
    today = str(tmp / "today.jsonl")
    universe = generate_key_trace(yesterday, keys=n_keys,
                                  draws=yesterday_draws, seed=17)
    generate_key_trace(today, keys=n_keys, draws=today_draws, seed=18)
    today_keys = load_key_trace(today)

    def boot_region(tag: str):
        svc = CacheService(
            InMemoryCache(64 << 20),
            DiskCacheEngine([ShardSpec(str(tmp / f"l2-{tag}"), 1 << 30)]),
            l3=ObjectStoreEngine(FsObjectStoreBackend(str(bucket)),
                                 resync_interval_s=0.0))
        server = make_rpc_server("threaded", "127.0.0.1:0")
        server.add_service(svc.spec())
        server.start()
        return svc, server, Channel(f"grpc://127.0.0.1:{server.port}")

    def try_get(ch, key):
        """(hit, error) over the real wire."""
        try:
            ch.call("ytpu.CacheService", "TryGetEntry",
                    api.cache.TryGetEntryRequest(token="", key=key),
                    api.cache.TryGetEntryResponse, timeout=10.0)
            return True, False
        except RpcError as e:
            return False, e.status != api.cache.CACHE_STATUS_NOT_FOUND
        except Exception:
            return False, True

    # -- steady state: region A fills the bucket and serves warm -----------
    svc_a, srv_a, ch_a = boot_region("a")
    try:
        for key in universe:
            ch_a.call("ytpu.CacheService", "PutEntry",
                      api.cache.PutEntryRequest(token="", key=key),
                      api.cache.PutEntryResponse, attachment=payload)
        assert svc_a.drain_l3_for_testing(timeout_s=60.0), \
            "L3 write-backs failed to drain"
        warm_hits = warm_errors = 0
        for key in today_keys:
            hit, err = try_get(ch_a, key)
            warm_hits += hit
            warm_errors += err
        steady_hit_rate = warm_hits / max(1, len(today_keys))
        a_reply_ms_max = svc_a.inspect()["tryget_reply_ms_max"]
    finally:
        srv_a.stop(grace=0)
        svc_a.stop()
    threshold = 0.9 * steady_hit_rate

    # -- the two cold arms --------------------------------------------------
    def run_arm(tag: str, prefetch: bool) -> dict:
        svc, srv, ch = boot_region(tag)
        try:
            prefetch_stats = None
            t_pf = time.monotonic()
            if prefetch:
                prefetch_stats = TracePrefetcher(svc).warm(
                    load_key_trace(yesterday))
            prefetch_seconds = time.monotonic() - t_pf if prefetch else 0.0
            from collections import deque
            recent: deque = deque(maxlen=window)
            curve = []
            hits = errors = 0
            time_to_warm = None
            t0 = time.monotonic()
            for i, key in enumerate(today_keys):
                hit, err = try_get(ch, key)
                hits += hit
                errors += err
                recent.append(hit)
                now = time.monotonic() - t0
                rate = sum(recent) / len(recent)
                if (time_to_warm is None and len(recent) == window
                        and rate >= threshold):
                    time_to_warm = now
                if i % (window // 2) == 0:
                    curve.append([round(now, 3), round(rate, 3)])
                time.sleep(pace_s)
            wall = time.monotonic() - t0
            svc.drain_l3_for_testing(timeout_s=60.0)
            return {
                "prefetch": prefetch,
                "prefetch_seconds": round(prefetch_seconds, 3),
                "prefetch_stats": prefetch_stats,
                "requests": len(today_keys),
                "hits": hits,
                "errors": errors,
                "final_hit_rate": round(hits / max(1, len(today_keys)), 4),
                # Never reaching the threshold scores the full wall time
                # (a loud SLO miss, not a silent None).
                "time_to_warm_s": round(
                    wall if time_to_warm is None else time_to_warm, 3),
                "reached_threshold": time_to_warm is not None,
                "hit_rate_curve": curve,
                "tryget_reply_ms_max": svc.inspect()["tryget_reply_ms_max"],
                "l3": svc.inspect()["l3"],
            }
        finally:
            srv.stop(grace=0)
            svc.stop()

    arm_on = run_arm("on", prefetch=True)
    arm_off = run_arm("off", prefetch=False)

    out = {
        "keys": n_keys,
        "stream_draws": today_draws,
        "steady_hit_rate": round(steady_hit_rate, 4),
        "warm_threshold": round(threshold, 4),
        "warm_region_errors": warm_errors,
        "warm_region_tryget_reply_ms_max": a_reply_ms_max,
        "prefetch_on": arm_on,
        "prefetch_off": arm_off,
        "errors": warm_errors + arm_on["errors"] + arm_off["errors"],
        "arms_reached_threshold": int(arm_on["reached_threshold"])
        + int(arm_off["reached_threshold"]),
        "time_to_warm_on_s": arm_on["time_to_warm_s"],
        "time_to_warm_off_s": arm_off["time_to_warm_s"],
        "warm_speedup": round(
            arm_off["time_to_warm_s"]
            / max(1e-9, arm_on["time_to_warm_s"]), 2),
        # The tentpole's reply-path contract, measured where it is
        # hardest: a cold region whose every early request falls
        # through to the bucket.
        "cold_tryget_reply_ms_max": max(
            arm_on["tryget_reply_ms_max"], arm_off["tryget_reply_ms_max"]),
    }
    slo = {
        "errors_max": 0,                    # both arms + warm region
        "arms_reached_threshold_min": 2,    # cold regions DO warm
        "warm_speedup_min": 2.0,            # prefetch >= 2x faster
        "steady_hit_rate_min": 0.95,        # the bucket really fills
        # One paced request is 2ms; a reply that waited on a bucket
        # round trip (listing + GET on real object stores) would blow
        # far past this bound.
        "cold_tryget_reply_ms_max_max": 250.0,
    }
    out["slo"] = slo
    out["slo_checks"] = _check_slo(out, slo)
    return out


def _scn_spill_affinity(smoke: bool, policy: str, device: str) -> dict:
    tmp = Path(tempfile.mkdtemp(prefix="spillaffinity_"))
    try:
        return _scn_spill_affinity_in(tmp, smoke, policy, device)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _scn_spill_affinity_in(tmp: Path, smoke: bool, policy: str,
        device: str) -> dict:
    """Warm-vs-cold spill placement A/B.

    Three federated cells, home cell 0 pinned at the spillover rung.
    Cell 1 is WARM — its cache tiers hold the whole key universe, its
    region-filter snapshot is installed on the router — but carries a
    sticky load (parked grants) that keeps its utilization above cell
    2's.  Cell 2 is COLD and idle.  A zipf key stream then spills,
    twice: once with scored placement (the device cells×tasks cost
    matrix, scheduler/placement.py) and once with the pre-scoring
    least-loaded baseline.  A spill "hits" when the chosen cell's
    cache already held the key; either way the artifact then warms the
    chosen cell (cache set + filter), so the baseline gets full credit
    for the locality it builds on its own.

    The SLOs pin the tentpole's claims: scored placement lands on the
    warm peer despite the load gap (>= 1.3x the baseline's post-spill
    hit rate, every decision scored, 0 errors), the TTL'd signal cache
    absorbs the storm's peer reads, load balance stays equal (no
    residual outstanding on either peer), and once the warm peer fills
    solid the load term diverts the next spill to the cold peer after
    one signal-staleness window."""
    from ..common.bloom import SaltedBloomFilter
    from ..scheduler.admission import RUNG_SPILLOVER
    from ..scheduler.federation import (CellHandle, FederationRouter,
                                        grant_namespace_for_cell)
    from ..scheduler.policy import make_policy
    from ..scheduler.task_dispatcher import ServantInfo, TaskDispatcher
    from ..utils.clock import REAL_CLOCK
    from .trace_replay import generate_key_trace, load_key_trace

    env = "feedc0de" * 8
    n_keys = 120 if smoke else 200
    draws = 160 if smoke else 240
    sticky = 2           # grants parked on the warm peer (load gap)
    capacity = 4

    trace_path = str(tmp / "stream.jsonl")
    # Flat-ish zipf: the baseline arm's hit rate is its repeat-draw
    # fraction, and a flatter stream keeps that honest headroom below
    # the scored arm's warm-cell rate.
    universe = generate_key_trace(trace_path, keys=n_keys, draws=draws,
                                  zipf_a=1.05, seed=23)
    stream = load_key_trace(trace_path)

    def run_arm(scored: bool) -> dict:
        ds = []
        for c in range(3):
            start, stride = grant_namespace_for_cell(c, 3)
            ds.append(TaskDispatcher(
                make_policy(policy, device=device), max_servants=16,
                max_envs=16,
                clock=REAL_CLOCK, batch_window_s=0.0,
                grant_id_start=start, grant_id_stride=stride))
        try:
            handles = [CellHandle(c, d) for c, d in enumerate(ds)]
            # Warmth state: per-cell cache key sets plus the Bloom
            # snapshots the scorer probes (the cold peer's EMPTY
            # filter is installed too — "verifiably cold" beats "no
            # data", which would force the least-loaded fallback).
            cache_sets = {1: set(universe), 2: set()}
            filters = {c: SaltedBloomFilter(1 << 15, 7, 1000 + c)
                       for c in (1, 2)}
            filters[1].add_many(list(universe))
            scorer = None
            if scored:
                # Pre-compile the scorer's shape variants (candidate
                # ring grows 1->32 keys, so n pads through 8/16/32),
                # as a production boot would: the placement-stage p99
                # then measures the launch, not trace-time.
                from ..scheduler.placement import (CellCandidate,
                                                   DevicePlacementScorer)
                scorer = DevicePlacementScorer(device=device)
                warm_cands = [CellCandidate(cell_id=c,
                                            filter=filters[c])
                              for c in (1, 2)]
                for n in (8, 16, 32):
                    scorer.score(warm_cands, [[universe[0]] * n])
            router = FederationRouter(handles, 0,
                                      use_scored_placement=scored,
                                      placement_scorer=scorer,
                                      device=device)
            for c, d in enumerate(ds):
                d.keep_servant_alive(ServantInfo(
                    location=f"10.9.{c}.1:1", version=1,
                    num_processors=32, capacity=capacity,
                    total_memory=64 << 30, memory_available=64 << 30,
                    env_digests=(env,)), 60)
            for c in (1, 2):
                router.update_cell_filter(c, filters[c])
            parked = ds[1].wait_for_starting_new_task(
                env, immediate=sticky, timeout_s=2.0)
            assert len(parked) == sticky, "sticky load failed to park"

            hits = errors = local_fallthrough = 0
            placements: Dict[int, int] = {}
            for key in stream:
                router.note_candidate_keys(env, [key])
                ds[0].restore_admission_rung(RUNG_SPILLOVER)
                routed = router.wait_for_starting_new_task_routed(
                    env, timeout_s=2.0)
                if not routed.grants:
                    errors += 1
                    continue
                g = routed.grants[0]
                if not g.spilled:
                    local_fallthrough += 1
                else:
                    placements[g.cell_id] = \
                        placements.get(g.cell_id, 0) + 1
                    hits += int(key in cache_sets[g.cell_id])
                    cache_sets[g.cell_id].add(key)
                    filters[g.cell_id].add(key)
                router.free_task([x.grant_id for x in routed.grants])

            # Busy phase: fill the warm peer solid; after one signal
            # staleness window the next spill must divert to the cold
            # peer — warmth never overrides "no free capacity".
            busy_diverted = None
            if scored:
                hold = ds[1].wait_for_starting_new_task(
                    env, immediate=capacity, timeout_s=2.0)
                time.sleep(0.15)        # one signal-TTL window
                ds[0].restore_admission_rung(RUNG_SPILLOVER)
                routed = router.wait_for_starting_new_task_routed(
                    env, timeout_s=2.0)
                busy_diverted = int(bool(routed.grants)
                                    and routed.grants[0].spilled
                                    and routed.grants[0].cell_id != 1)
                ds[1].free_task([gid for gid, _ in hold])
                router.free_task([x.grant_id for x in routed.grants])

            stats = router.stats()
            pct = router.stage_timer.percentiles().get("placement", {})
            spilled = sum(placements.values())
            residual = [ds[1].load_signal().outstanding - sticky,
                        ds[2].load_signal().outstanding]
            return {
                "scored": scored,
                "requests": len(stream),
                "spilled": spilled,
                "hits": hits,
                "errors": errors,
                "local_fallthrough": local_fallthrough,
                "post_spill_hit_rate": round(hits / max(1, spilled), 4),
                "placements": {str(c): n
                               for c, n in sorted(placements.items())},
                "busy_diverted": busy_diverted,
                "residual_outstanding": residual,
                "placement_scored": stats["placement_scored"],
                "placement_fallback_least_loaded":
                    stats["placement_fallback_least_loaded"],
                "signal_refreshes": stats["signal_refreshes"],
                "signal_cache_hits": stats["signal_cache_hits"],
                "spilled_grants_by_peer": {
                    str(c): n for c, n in sorted(
                        stats["spilled_grants_by_peer"].items())},
                "placement_p99_ms": round(pct.get("p99_ms", 0.0), 4),
            }
        finally:
            for d in ds:
                d.stop()

    arm_scored = run_arm(scored=True)
    arm_baseline = run_arm(scored=False)

    ratio = (arm_scored["post_spill_hit_rate"]
             / max(1e-9, arm_baseline["post_spill_hit_rate"]))
    out = {
        "keys": n_keys,
        "stream_draws": draws,
        "scored": arm_scored,
        "baseline": arm_baseline,
        "warm_hit_rate_ratio": round(ratio, 2),
        "errors": arm_scored["errors"] + arm_baseline["errors"],
        "local_fallthrough": arm_scored["local_fallthrough"]
        + arm_baseline["local_fallthrough"],
        "scored_hit_rate": arm_scored["post_spill_hit_rate"],
        "scored_fallbacks":
            arm_scored["placement_fallback_least_loaded"],
        "baseline_scored_decisions": arm_baseline["placement_scored"],
        "signal_cache_hits": arm_scored["signal_cache_hits"],
        "busy_diverted": arm_scored["busy_diverted"],
        "residual_outstanding_abs_max": max(
            abs(x) for arm in (arm_scored, arm_baseline)
            for x in arm["residual_outstanding"]),
        "placement_score_p99_us": round(
            arm_scored["placement_p99_ms"] * 1000.0, 1),
    }
    slo = {
        "errors_max": 0,
        "local_fallthrough_max": 0,
        # The tentpole's headline: scored placement >= 1.3x the
        # least-loaded baseline on post-spill cache hit rate.
        "warm_hit_rate_ratio_min": 1.3,
        "scored_hit_rate_min": 0.9,       # the warm peer really wins
        "scored_fallbacks_max": 0,        # every decision was scored
        "baseline_scored_decisions_max": 0,  # the A/B arms are clean
        "signal_cache_hits_min": 1,       # the TTL cache engaged
        "busy_diverted_min": 1,           # load term still binds
        "residual_outstanding_abs_max_max": 0,  # equal load balance
    }
    out["slo"] = slo
    out["slo_checks"] = _check_slo(out, slo)
    return out


# --------------------------------------------------------------------------
# Multi-tenant QoS scenarios (doc/tenancy.md).
# --------------------------------------------------------------------------


def _scn_noisy_neighbor(smoke: bool, policy: str, device: str) -> dict:
    """One shared FairGrantQueue, two tenants of equal weight: a
    single-pid victim against an adversary fanning its demand across
    100 distinct client pids.  Under per-CLIENT stride alone the
    adversary would draw ~100/101 of the grants; the tenant level of
    the two-level queue must arbitrate tenants first, so the victim
    holds >= 0.8 of its half regardless of the fan-out."""
    del policy, device  # no scheduler: one FairGrantQueue
    from ..daemon.local.fair_admission import FairGrantQueue

    total_grants = 60 if smoke else 300
    adversary_pids = 100
    q = FairGrantQueue()
    counts = {"victim": 0, "adversary": 0}
    lock = threading.Lock()
    stop = threading.Event()

    def consumer(tenant: str, pid: str):
        while not stop.is_set():
            g = q.get(pid, 1.0, timeout_s=0.05, tenant=tenant,
                      tenant_weight=1.0)
            if g is None:
                continue
            with lock:
                counts[tenant] += 1
            # A real delegate does work per grant; a tiny hold keeps
            # every consumer in contention for the next put.
            time.sleep(0.0005)

    threads = [threading.Thread(
        target=consumer, args=("victim", "victim-pid"), daemon=True)]
    # The adversary's demand arrives through many pids but few OS
    # threads (a make -j storm multiplexed over one box): each thread
    # rotates through a disjoint slice of the 100 pids.
    n_adv_threads = 10
    per = adversary_pids // n_adv_threads

    def adv_consumer(idx: int):
        pids = [f"adv-{idx}-{i}" for i in range(per)]
        k = 0
        while not stop.is_set():
            g = q.get(pids[k % per], 1.0, timeout_s=0.05,
                      tenant="adversary", tenant_weight=1.0)
            k += 1
            if g is None:
                continue
            with lock:
                counts["adversary"] += 1
            time.sleep(0.0005)

    threads += [threading.Thread(target=adv_consumer, args=(i,),
                                 daemon=True)
                for i in range(n_adv_threads)]
    for t in threads:
        t.start()
    # Grants trickle in one at a time: contention at every hand-out is
    # what the stride queue arbitrates.
    for i in range(total_grants):
        q.put(object())
        time.sleep(0.002)
    deadline = time.monotonic() + 5.0
    while time.monotonic() < deadline:
        with lock:
            served = counts["victim"] + counts["adversary"]
        if served >= total_grants or q.qsize() == 0:
            break
        time.sleep(0.01)
    stop.set()
    for t in threads:
        t.join(timeout=2.0)

    served = counts["victim"] + counts["adversary"]
    fair_share = served / 2.0
    victim_share_ratio = (counts["victim"] / fair_share
                          if fair_share else 0.0)
    tenant_counts = q.tenant_share_counts()
    out = {
        "grants_offered": total_grants,
        "grants_served": served,
        "adversary_pids": adversary_pids,
        "victim_got": counts["victim"],
        "adversary_got": counts["adversary"],
        "tenant_share_counts": tenant_counts,
        "victim_share_ratio": round(victim_share_ratio, 3),
        "lost_or_hung": total_grants - served - q.qsize(),
    }
    slo = {"victim_share_ratio_min": 0.8, "lost_or_hung_max": 0}
    out["slo"] = slo
    out["slo_checks"] = _check_slo(out, slo)
    return out


def _scn_cache_poisoning(smoke: bool, policy: str, device: str) -> dict:
    """Cryptographic cache isolation against an adversary who knows
    the victim's PLAINTEXT key (compilation is deterministic, so key
    material is guessable from public inputs — tenancy/keys.py).

    Four claims on a real CacheService:

    1. victim's fill actually runs and lands (actually_run == 1);
    2. cross-namespace read: the adversary probing the plaintext key
       AND its own scoped derivation of it both miss;
    3. poison: entries the adversary plants at every key it CAN write
       are never returned to the victim — the victim's next read still
       yields its own bytes;
    4. the legacy empty-secret domain stays byte-identical (scoped key
       with no secret == plaintext key).
    """
    del smoke, policy, device  # no scheduler; the rig is O(1)
    import types

    from ..cache.in_memory_cache import InMemoryCache
    from ..cache.service import CacheService
    from ..common.disk_cache import ShardSpec
    from ..cache.disk_engine import DiskCacheEngine
    from ..common.token_verifier import TokenVerifier
    from ..rpc import RpcContext
    from ..tenancy.budgets import CacheBytesLedger
    from ..tenancy.keys import key_namespace, tenant_scoped_key

    tmp = Path(tempfile.mkdtemp(prefix="poison_"))
    ledger = CacheBytesLedger()
    svc = CacheService(
        InMemoryCache(1 << 20),
        DiskCacheEngine([ShardSpec(str(tmp / "l2"), 1 << 20)]),
        user_tokens=TokenVerifier({"user"}),
        servant_tokens=TokenVerifier({"servant"}),
        tenant_bytes=ledger)
    ctx = RpcContext()
    ctx.peer = "10.0.0.9:1"

    def put(key: str, value: bytes) -> bool:
        try:
            svc.PutEntry(types.SimpleNamespace(token="servant", key=key),
                         value, ctx)
            return True
        except RpcError:
            return False

    def get(key: str) -> Optional[bytes]:
        try:
            svc.TryGetEntry(
                types.SimpleNamespace(token="user", key=key), b"", ctx)
            return bytes(ctx.response_attachment)
        except RpcError:
            return None

    try:
        victim_secret = "v" * 64
        adversary_secret = "a" * 64
        plain = "ytpu-cxx2-entry-deadbeef"  # guessable: deterministic inputs
        victim_key = tenant_scoped_key(victim_secret, plain)
        victim_bytes = b"victim-object-code"

        # 1. Victim compiles and fills (the actually_run=1 of this rig).
        victim_fill_ok = int(put(victim_key, victim_bytes))

        # 2. Cross-namespace read: plaintext probe and the adversary's own
        # derivation both miss (it cannot compute victim_key without the
        # victim's secret).
        adv_key_guess = tenant_scoped_key(adversary_secret, plain)
        cross_read_blocked = int(get(plain) is None
                                 and get(adv_key_guess) is None
                                 and adv_key_guess != victim_key)

        # 3. Poison: the adversary plants garbage at every key it can
        # write — the plaintext key and its own scoped domain.  The
        # victim's next read must still return the victim's bytes.
        put(plain, b"poison-legacy")
        put(adv_key_guess, b"poison-scoped")
        poison_blocked = int(get(victim_key) == victim_bytes)

        # 4. Legacy passthrough: empty secret == plaintext domain,
        # byte-identical (pre-tenancy entries stay reachable).
        legacy_ok = int(tenant_scoped_key("", plain) == plain
                        and get(plain) == b"poison-legacy")

        # Rider: the adversary's namespace is byte-budgeted; a flood stops
        # at the quota while the victim's namespace is untouched.
        adv_ns = key_namespace(adv_key_guess)
        ledger.set_budget(adv_ns, 64)
        flood_admitted = 0
        for i in range(8):
            if put(tenant_scoped_key(adversary_secret, f"flood-{i}"),
                   b"x" * 32):
                flood_admitted += 1
        stats = svc.inspect()
    finally:
        svc.stop()
        shutil.rmtree(tmp, ignore_errors=True)
    out = {
        "victim_fill_actually_run": victim_fill_ok,
        "cross_tenant_read_blocked": cross_read_blocked,
        "poison_blocked": poison_blocked,
        "legacy_passthrough_ok": legacy_ok,
        "adversary_flood_admitted": flood_admitted,
        "adversary_flood_attempted": 8,
        "stats_by_tenant": stats["stats_by_tenant"],
        "tenant_bytes": stats["tenant_bytes"],
    }
    slo = {
        "victim_fill_actually_run_min": 1,
        "cross_tenant_read_blocked_min": 1,
        "poison_blocked_min": 1,
        "legacy_passthrough_ok_min": 1,
        # 64-byte budget, 32-byte entries (plus the poison-scoped one
        # already in the namespace): the flood must be cut off.
        "adversary_flood_admitted_max": 2,
    }
    out["slo"] = slo
    out["slo_checks"] = _check_slo(out, slo)
    return out


def _scn_tier_inversion(smoke: bool, policy: str, device: str) -> dict:
    """Tier x rung matrix on a real TaskDispatcher with held grants.

    Drive the ladder to SHED_OPTIONAL, then SPILLOVER, by holding the
    pool's capacity and pressing immediate demand.  At each rung,
    probe all three tiers through the production admission path:
    best_effort must get a native FLOW_REJECT with a retry-after at
    SHED_OPTIONAL, batch must join it at SPILLOVER, and interactive
    must not merely be admitted on paper but actually MINT a grant
    while the others are being shed."""
    del smoke  # already O(seconds); the rungs are driven, not waited
    from ..scheduler.admission import (FLOW_NONE, FLOW_REJECT,
                                       RUNG_SHED_OPTIONAL, RUNG_SPILLOVER)
    from ..scheduler.policy import make_policy
    from ..scheduler.task_dispatcher import ServantInfo, TaskDispatcher
    from ..tenancy.identity import TenantDirectory, TenantSpec

    directory = TenantDirectory([
        TenantSpec(tenant_id="live", tier="interactive"),
        TenantSpec(tenant_id="nightly", tier="batch"),
        TenantSpec(tenant_id="scavenger", tier="best_effort"),
    ])
    d = TaskDispatcher(
        make_policy(policy, avoid_self=False, device=device),
        max_servants=8, batch_window_s=0.0,
        admission_config=AdmissionConfig(
            up_thresholds=(0.5, 0.9, 1e9, 1e9),
            up_dwell_s=0.0, down_dwell_s=60.0),
        tenant_directory=directory)
    env = "e" * 64
    d.keep_servant_alive(ServantInfo(
        location="10.0.0.1:8335", version=1, num_processors=8,
        capacity=4, total_memory=1 << 36, memory_available=1 << 35,
        env_digests=(env,)), 60.0)

    def probe(tier_tenant: str, tier: str) -> dict:
        dec = d.admission_check(immediate=1, tenant=tier_tenant,
                                tier=tier)
        return {"flow": dec.flow, "rung": dec.rung,
                "retry_after_ms": dec.retry_after_ms}

    held: List[int] = []
    results: Dict[str, dict] = {}
    granted_under_shed = 0
    try:
        # Baseline: NORMAL admits everyone.
        results["normal"] = {
            t: probe(n, t) for n, t in (("live", "interactive"),
                                        ("nightly", "batch"),
                                        ("scavenger", "best_effort"))}

        # Hold half the pool: utilization 0.5 >= threshold 0.5 ->
        # SHED_OPTIONAL (dwell 0 makes the climb immediate).
        held += [g for g, _ in d.wait_for_starting_new_task(
            env, immediate=2, timeout_s=5.0, tenant="live")]
        for _ in range(8):
            if d.admission_check(immediate=2).rung \
                    >= RUNG_SHED_OPTIONAL:
                break
            time.sleep(0.02)
        results["shed_optional"] = {
            t: probe(n, t) for n, t in (("live", "interactive"),
                                        ("nightly", "batch"),
                                        ("scavenger", "best_effort"))}
        # Interactive does not just pass the check — it mints.
        got = d.wait_for_starting_new_task(
            env, immediate=1, timeout_s=5.0, tenant="live")
        granted_under_shed += len(got)
        held += [g for g, _ in got]

        # Interactive mints AGAIN (the whole pool is now held by the
        # protected tier), pushing utilization to 1.0 >= 0.9 ->
        # SPILLOVER.  Pressure from refused probes alone cannot climb
        # this rung: only real held grants count while nothing sheds.
        got = d.wait_for_starting_new_task(
            env, immediate=1, timeout_s=5.0, tenant="live")
        granted_under_shed += len(got)
        held += [g for g, _ in got]
        for _ in range(8):
            if d.admission_check(immediate=4).rung >= RUNG_SPILLOVER:
                break
            time.sleep(0.02)
        results["spillover"] = {
            t: probe(n, t) for n, t in (("live", "interactive"),
                                        ("nightly", "batch"),
                                        ("scavenger", "best_effort"))}
        by_tenant = d.inspect()["stats_by_tenant"]
    finally:
        d.free_task(held)
        d.stop()

    def ok(phase: str, tier: str, flow: int) -> bool:
        return results[phase][tier]["flow"] == flow

    matrix_ok = int(
        all(ok("normal", t, FLOW_NONE)
            for t in ("interactive", "batch", "best_effort"))
        and ok("shed_optional", "interactive", FLOW_NONE)
        and ok("shed_optional", "batch", FLOW_NONE)
        and ok("shed_optional", "best_effort", FLOW_REJECT)
        and results["shed_optional"]["best_effort"]["retry_after_ms"] > 0
        and ok("spillover", "interactive", FLOW_NONE)
        and ok("spillover", "batch", FLOW_REJECT)
        and ok("spillover", "best_effort", FLOW_REJECT))
    out = {
        "probes": results,
        "tier_matrix_ok": matrix_ok,
        "interactive_granted_under_shed": granted_under_shed,
        "best_effort_shed_count":
            by_tenant.get("scavenger", {}).get("shed_by_tier", 0),
        "batch_shed_count":
            by_tenant.get("nightly", {}).get("shed_by_tier", 0),
        "stats_by_tenant": by_tenant,
    }
    slo = {
        "tier_matrix_ok_min": 1,
        "interactive_granted_under_shed_min": 2,
        "best_effort_shed_count_min": 2,
        "batch_shed_count_min": 1,
    }
    out["slo"] = slo
    out["slo_checks"] = _check_slo(out, slo)
    return out


def run_scenario(name: str, smoke: bool = False, *,
                 policy: str = "auto", device: str = "cuda") -> dict:
    """One scenario; every scheduler, rig and policy it builds runs
    ``policy`` (a --dispatch-policy name) on ``device``."""
    fn = {
        "wan-jitter": _scn_wan_jitter,
        "burst": _scn_burst,
        "flaky-servant": _scn_flaky_servant,
        "slow-loris": _scn_slow_loris,
        "oversized-tu": _scn_oversized_tu,
        "cache-restart": _scn_cache_restart,
        "overload-ladder": _scn_overload_ladder,
        "aot-storm": _scn_aot_storm,
        "cell-kill": _scn_cell_kill,
        "cold-region": _scn_cold_region,
        "spill-affinity": _scn_spill_affinity,
        "noisy-neighbor": _scn_noisy_neighbor,
        "cache-poisoning": _scn_cache_poisoning,
        "tier-inversion": _scn_tier_inversion,
    }[name]
    out = fn(smoke, policy, device)
    out["scenario"] = name
    out["smoke"] = smoke
    out["slo_ok"] = all(out["slo_checks"].values())
    return out


def run_matrix(names=None, smoke: bool = False, *, policy: str = "auto",
               device: str = "cuda") -> dict:
    scenarios = {}
    for name in names or SCENARIO_NAMES:
        scenarios[name] = run_scenario(name, smoke=smoke, policy=policy,
                                       device=device)
    return {
        "harness": "cluster_sim_hostile",
        "smoke": smoke,
        "policy": policy,
        "device": device,
        "scenarios": scenarios,
        "all_slo_ok": all(s["slo_ok"] for s in scenarios.values()),
    }


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser("python -m yadcc_tpu_torch.tools.scenarios")
    ap.add_argument("--scenario", default="all",
                    help="one of %s or 'all'" % (SCENARIO_NAMES,))
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--policy", default="auto",
                    help="the schedulers' dispatch policy (the entry's "
                         "--dispatch-policy names)")
    ap.add_argument("--device", default="cuda",
                    help="where the dispatch policies and the placement "
                         "scorer run: cuda (the default) or cpu (the "
                         "kernels' plain versions)")
    ap.add_argument("--out", default="",
                    help="write the matrix here as well as stdout")
    args = ap.parse_args(argv)
    names = (SCENARIO_NAMES if args.scenario == "all"
             else (args.scenario,))
    out = run_matrix(names, smoke=args.smoke, policy=args.policy,
                     device=args.device)
    text = json.dumps(out, indent=2)
    print(text)
    if args.out:
        Path(args.out).write_text(text + "\n")
    return 0 if out["all_slo_ok"] else 1


if __name__ == "__main__":
    import sys

    sys.exit(main())
