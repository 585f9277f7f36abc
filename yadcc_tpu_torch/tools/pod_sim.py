"""Pod-scale control-plane simulation: >=50k TUs over hundreds of
virtual servants (BASELINE configs[0]/[2] analogue at fleet scale, and
configs[4]'s 100k tasks x 5k workers heterogeneous-capacity bin-pack).
A copy of the JAX package's yadcc_tpu/tools/pod_sim.py whose scheduler
is the port's: every device policy, the sharded router's load summary
and the fused control plane run on ``--device`` (the card unless the
caller asks for the CPU).

`cluster_sim` drives the full wire path (real loopback gRPC, real
subprocess compiles) at small scale; this tool answers the scale
question the reference answers with its production cluster
(yadcc/doc/benchmark.md:25-37): what does the CONTROL PLANE sustain
when a build farm pushes tens of thousands of TUs at a fleet of
hundreds of servants, with the distributed cache, Bloom gating,
duplicate-task joining, and servant churn all live?

Everything stateful is the REAL component, called in-process:

* `TaskDispatcher` — the production scheduler core (policy kernels,
  batched dispatch cycles, leases, churn bookkeeping);
* `CacheService` — real ARC L1 + Bloom generator, driven through its
  RPC handlers (FetchBloomFilter / TryGetEntry / PutEntry) with the
  production sync-age protocol;
* `SaltedBloomFilter` client replica, synced incrementally like
  DistributedCacheReader;
* `RunningTaskBookkeeper` — fed from virtual heartbeats, queried for
  cross-machine dedup like RunningTaskKeeper.

Virtual: the servants (no subprocesses — each "compile" is an event on
a heap with a configurable duration) and the build clients (a submit
loop replaces the per-TU client/daemon HTTP hop).  Task *latency* here
is therefore not an end-to-end claim — cluster_sim covers that — but
tasks/s, grant p99, and the hit/join/run breakdown exercise the same
code a deployment does.

Grant calls go through the REAL RPC path — SchedulerService handlers
behind the wire framing (request/response protobuf encode + frame
codec) on the mock transport — so `grant_call_p99_ms` prices the full
service path, and the `latency_breakdown` section decomposes it:
queue-wait / snapshot / policy / apply from the dispatcher's stage
timer, handler / serialize from the service spec's, transport measured
client-side.  `dispatch_cycle_ms` (snapshot+policy+apply) is the
"dispatch-only" number the <2ms BASELINE budget refers to.

Servant capacities are heterogeneous (`--capacity-dist`), matching
BASELINE configs[4]'s heterogeneous-capacity bin-pack.

    python -m yadcc_tpu_torch.tools.pod_sim --tasks 100000 \
        --servants 5000 --capacity-dist uniform:4:16 [--device cpu]

`--pipeline-depth N` runs the dispatchers on the policy's stream API
with N cycles in flight, the mode the scheduler entry takes on the card
(`--dispatch-pipeline-depth auto` = 16); 0 (the default) is synchronous.
A policy without the stream API (greedy_cpu) refuses a depth above 0.

Sharded control plane (`--shards N`, doc/scheduler.md): the dispatcher
becomes a ShardRouter over N TaskDispatchers — servant heartbeats and
grant requests route by consistent hash, grant demand arrives through a
pool of synthetic delegate identities (each its own mock channel, so
the RPC peer — the routing key — is real), and `--hotspot zipf:S`
skews which delegate asks, concentrating demand on the hot delegates'
home shards so the cross-shard steal path actually runs.  The JSON
gains `steal_rate`, per-shard `latency_breakdown`s, a
`demand_balance` section (max-shard demand vs mean, sampled ~20Hz) and
the router's `load_summary` (parallel/mesh.py:shard_load_summary on the
device; `--mesh-loads off` keeps it off).  `PodSim(team=...)` takes a
parallel/mesh.py team where the JAX tool builds a mesh: sharded, one
device a shard for the load summary; unsharded, the team of a
torch_sharded or torch_sharded_grouped policy.
`--smoke` is the CI gate (small fleet, hotspot skew, assertions on
steal engagement, unique grant ids, and aggregate==Σ per-shard).
`--ab` runs the sharded-vs-single + steal-on/off A/B; its single-
dispatcher baseline is measured first, in the same call.
`--device-resident [--smoke]` is the fused control plane: K1 over a
grid of shards (parallel/mesh.py:resident_control_plane_step), A/B'd
against per-shard host loops, or gated against
ops/assignment.py:greedy_assign_reference every cycle.  Output goes to
stdout and, with `--out`, to a file.
"""

from __future__ import annotations

import argparse
import heapq
import json
import math
import queue
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np


class _Completion:
    """One running (possibly shared) compilation: joiners piggyback."""

    __slots__ = ("digest", "grant_id", "location", "done", "joiners")

    def __init__(self, digest: str, grant_id: int, location: str):
        self.digest = digest
        self.grant_id = grant_id
        self.location = location
        self.done = threading.Event()
        self.joiners = 1


def parse_capacity_dist(spec: str, base_capacity: int):
    """`--capacity-dist` -> sampler(rng) for per-servant capacities.

    fixed            every servant gets --capacity (legacy behavior)
    uniform:LO:HI    integer-uniform in [LO, HI]
    bimodal:A:B:F    capacity B with probability F, else A
    """
    if spec == "fixed":
        return lambda rng: base_capacity
    kind, _, rest = spec.partition(":")
    parts = rest.split(":") if rest else []
    if kind == "uniform" and len(parts) == 2:
        lo, hi = int(parts[0]), int(parts[1])
        if not 0 < lo <= hi:
            raise ValueError(f"bad uniform bounds in {spec!r}")
        return lambda rng: int(rng.integers(lo, hi + 1))
    if kind == "bimodal" and len(parts) == 3:
        a, b, frac = int(parts[0]), int(parts[1]), float(parts[2])
        if not (a > 0 and b > 0 and 0.0 <= frac <= 1.0):
            raise ValueError(f"bad bimodal params in {spec!r}")
        return lambda rng: b if rng.random() < frac else a
    raise ValueError(f"unknown capacity dist {spec!r}")


def parse_hotspot(spec: Optional[str], n_delegates: int):
    """`--hotspot zipf:S` -> per-call delegate sampler CDF (rank-based
    Zipf over the delegate pool: P(rank r) ∝ 1/(r+1)^S), or None for
    uniform demand."""
    if not spec or spec == "none":
        return None
    kind, _, rest = spec.partition(":")
    if kind != "zipf" or not rest:
        raise ValueError(f"unknown hotspot spec {spec!r} "
                         "(expected zipf:<exponent>)")
    s = float(rest)
    if s <= 0:
        raise ValueError(f"zipf exponent must be positive: {spec!r}")
    w = 1.0 / np.power(np.arange(1, n_delegates + 1, dtype=np.float64), s)
    return np.cumsum(w / w.sum())


class PodSim:
    def __init__(self, servants: int, capacity: int, policy: str,
                 exec_ms: float, churn_per_s: int, seed: int = 7,
                 pipeline_depth: int = 0, capacity_dist: str = "fixed",
                 shards: int = 1, hotspot: Optional[str] = None,
                 steal: bool = True, delegates: int = 32,
                 pumps: Optional[int] = None, hb_interval: float = 0.5,
                 mesh_loads: str = "auto", check_unique: bool = False,
                 arrival_rate: float = 0.0, pump_batch: int = 128,
                 steal_batch: int = 64, frontend: str = "mock",
                 device="cuda", team=None):
        from ..cache.cache_engine import NullCacheEngine
        from ..device import resolve_device
        from ..cache.in_memory_cache import InMemoryCache
        from ..cache.service import CacheService
        from ..rpc import Channel, register_mock_server
        from ..scheduler.policy import make_policy
        from ..scheduler.running_task_bookkeeper import \
            RunningTaskBookkeeper
        from ..scheduler.service import SchedulerService
        from ..scheduler.task_dispatcher import ServantInfo, TaskDispatcher
        from ..utils.stagetimer import StageTimer

        self.rng = np.random.default_rng(seed)
        self.device = resolve_device(str(device))
        self.exec_ms = exec_ms
        self.churn_per_s = churn_per_s
        self.capacity = capacity
        self.capacity_dist = capacity_dist
        self._cap_sampler = parse_capacity_dist(capacity_dist, capacity)
        self.env = "c" * 64
        self.shards = max(1, shards)
        self.hotspot = hotspot
        self.hb_interval = hb_interval
        # Paced arrivals (tasks/s across all submitters; 0 = flood):
        # "sustained rate R" is a different claim from "drain a burst as
        # fast as the box allows", and on a small host the flood's
        # client CPU writes its own preemption stalls into the
        # scheduler's stage percentiles.
        self.arrival_rate = arrival_rate
        self.pump_batch = max(1, pump_batch)
        # Pump-rig pacing: aggregate grant-call rate across pumps
        # (0 = flood).  A latency instrument must run BELOW saturation
        # or it measures queueing, not the path.
        self.rig_call_rate = 0.0
        self._pump_phase_seq = 0  # guarded by: self.need_lock
        # Pump-rig mode: the pump itself frees its grants and returns
        # the demand (no binder/free thread = no GIL ping-pong per
        # grant batch on the measured path).
        self._rig_inline_free = False
        # Whole-fleet heartbeat sweeps are phase-spread in chunks this
        # big; the latency rig shrinks them so a sweep burst never
        # holds the GIL across a grant round trip.
        self._hb_chunk = 256
        self.router = None
        self._mesh_loads = mesh_loads
        if self.shards == 1:
            # ~12% slot headroom over the fleet, rounded to 256 (churn
            # replaces leavers slot-for-slot, so occupancy stays ~flat);
            # oversizing the pool just inflates every O(S)
            # policy/snapshot operation — at 5k servants a power-of-two
            # pool would be 64% dead slots that every mask and score
            # pass still scans.
            pool = max(512, (servants * 9 // 8 + 64 + 255) // 256 * 256)
            pol = make_policy(policy, avoid_self=False,
                              device=self.device, team=team,
                              max_servants=pool)
            # Like scheduler/entry.py: device kernels compile before
            # serving, never inside a live grant cycle.
            if pipeline_depth > 0:
                pol.stream_warmup(pool)
            else:
                pol.warmup(pool)
            self.dispatcher = TaskDispatcher(
                pol, max_servants=pool, batch_window_s=0.001,
                min_memory_for_new_task=1,
                pipeline_depth=pipeline_depth)
        else:
            # Sharded control plane: the same headroom math per shard
            # (the consistent hash spreads the fleet ~evenly; the
            # scheduler vnode density bounds the max/min share at
            # ~1.14x, covered by the 25% headroom + ring slack).
            from ..scheduler.shard_router import ShardRouter, StealConfig

            per = servants // self.shards
            pool = max(256, (per * 10 // 8 + 64 + 255) // 256 * 256)
            policies = [make_policy(policy, avoid_self=False,
                                    device=self.device,
                                    max_servants=pool)
                        for _ in range(self.shards)]
            for pol in policies:
                if pipeline_depth > 0:
                    pol.stream_warmup(pool)
                else:
                    pol.warmup(pool)
            # The cross-shard load summary runs on the device ('auto'),
            # each shard's slice on its own device of ``team`` when one
            # is given (the JAX tool's mesh, one device a shard), or not
            # at all ('off').
            on = mesh_loads != "off"
            self.router = ShardRouter.build(
                lambda k: policies[k], self.shards,
                max_servants_per_shard=pool,
                steal=StealConfig(enabled=steal,
                                  max_batch=max(1, steal_batch)),
                device=self.device if on and team is None else None,
                team=team if on else None,
                batch_window_s=0.001,
                min_memory_for_new_task=1,
                pipeline_depth=pipeline_depth)
            self.dispatcher = self.router
        self.bookkeeper = RunningTaskBookkeeper()
        self.cache = CacheService(InMemoryCache(256 << 20),
                                  NullCacheEngine())
        self._ServantInfo = ServantInfo

        # The grant path goes through the production RPC service: real
        # handlers, real message/frame codec, in-process transport —
        # or, with --frontend grpc|aio, over real loopback sockets
        # through the matching server (the front-end A/B: "grpc" is the
        # threaded baseline, "aio" the event-loop path with
        # WaitForStartingTask parked).
        self.service = SchedulerService(self.dispatcher)
        self.frontend = frontend
        self.n_delegates = max(1, delegates)
        self.n_pumps = pumps if pumps else max(1, self.shards)
        self._mock_name = f"podsim-{id(self):x}"
        self._rpc_server = None
        self.delegate_channels: Optional[list] = None
        if frontend == "mock":
            register_mock_server(self._mock_name, self.service.spec())
            # Synthetic delegate identities: each its own channel so
            # the observed RPC peer — the router's consistent-hash
            # routing key — is a real, distinct delegate address
            # (servants live in 10.0/16; delegates in 10.254/16).
            self.delegate_channels = [
                Channel(f"mock://{self._mock_name}"
                        f"@10.254.{d >> 8 & 255}.{d & 255}:7")
                for d in range(self.n_delegates)
            ]
        else:
            from ..rpc import make_rpc_server

            self._rpc_server = make_rpc_server(
                "aio" if frontend == "aio" else "threaded",
                "127.0.0.1:0")
            self._rpc_server.add_service(self.service.spec())
            self._rpc_server.start()
            if frontend == "grpc":
                self.delegate_channels = [
                    Channel(f"grpc://127.0.0.1:{self._rpc_server.port}")
                    for _ in range(self.n_delegates)
                ]
            # aio: AsyncAioChannels are created ON the client loop by
            # the pump coroutines (run()).
        self._hotspot_cdf = parse_hotspot(hotspot, self.n_delegates)
        # Unique-grant-id oracle (the stolen-grant never-double-issued
        # invariant): smoke/test rigs flip check_unique on; production-
        # scale runs skip the per-grant set cost.
        self._check_unique = check_unique
        self._seen_gids: set = set()
        self._dup_gids = 0
        self._gid_lock = threading.Lock()
        # Per-shard demand-balance samples ((outstanding + queued) per
        # shard, ~20Hz) — the hotspot A/B's headline series.
        self._demand_samples: List[np.ndarray] = []
        self._backlog_samples: List[int] = []
        # Client-observed stages (grant_call total + derived transport).
        self.client_timer = StageTimer(maxlen=16384)

        # Virtual fleet.
        self._next_servant = 0
        self.servant_running: Dict[str, Dict[int, str]] = {}
        self.servant_caps: Dict[str, int] = {}
        self._hb_nonempty: set = set()
        self.fleet_lock = threading.Lock()
        for _ in range(servants):
            self._join_fleet()

        # Client-side state (one logical build farm client).
        self.replica = None          # SaltedBloomFilter
        self._last_full_fetch = 0.0
        self._last_fetch = 0.0
        self.running: Dict[str, _Completion] = {}
        self.run_lock = threading.Lock()
        self.grants: "queue.Queue[Tuple[int, str]]" = queue.Queue()
        self.bind_q: "queue.Queue[_Completion]" = queue.Queue()
        self.need = 0                # tasks waiting for a grant
        self.need_lock = threading.Lock()
        self.events: List[Tuple[float, int, _Completion]] = []
        self.ev_lock = threading.Lock()
        self.ev_cv = threading.Condition(self.ev_lock)
        self._seq = 0
        self.stats = {"hit_cache": 0, "reused": 0, "actually_run": 0,
                      "bloom_rejects": 0, "retries": 0,
                      "servants_churned": 0}
        self.grant_lat_ms: List[float] = []
        self.grant_calls = 0
        self.grants_granted = 0
        self.grants_stolen = 0
        self._stop = threading.Event()

    # -- fleet ---------------------------------------------------------------

    def _join_fleet(self) -> str:
        """Register a fresh virtual servant.  Takes fleet_lock itself —
        callers must NOT hold it (lock order: fleet_lock is a leaf)."""
        with self.fleet_lock:
            loc = f"10.{self._next_servant >> 16 & 255}." \
                  f"{self._next_servant >> 8 & 255}." \
                  f"{self._next_servant & 255}:8335"
            self._next_servant += 1
            self.servant_running[loc] = {}
            self.servant_caps[loc] = self._cap_sampler(self.rng)
        self._heartbeat_one(loc)
        return loc

    def _heartbeat_one(self, loc: str) -> None:
        from ..scheduler.running_task_bookkeeper import RunningTaskRecord

        with self.fleet_lock:
            running = dict(self.servant_running.get(loc, {}))
            cap = self.servant_caps.get(loc, self.capacity)
        info = self._ServantInfo(
            location=loc, version=1,
            num_processors=cap * 2,
            current_load=0, dedicated=True,
            capacity=cap,
            total_memory=64 << 30, memory_available=32 << 30,
            env_digests=(self.env,),
        )
        self.dispatcher.keep_servant_alive(info, 10.0)
        # Running-set reconciliation only when there is something to
        # reconcile: an idle servant whose previous beat was also idle
        # has nothing to report and nothing to reap — at a 5k fleet the
        # unconditional version was ~10k no-op bookkeeper/dispatcher
        # round-trips per second of pure sweep overhead.
        if running or loc in self._hb_nonempty:
            self.dispatcher.notify_servant_running_tasks(
                loc, list(running.keys()))
            self.bookkeeper.set_servant_running_tasks(
                loc, [RunningTaskRecord(servant_task_id=gid,
                                        task_grant_id=gid,
                                        servant_location=loc,
                                        task_digest=digest)
                      for gid, digest in running.items()])
            if running:
                self._hb_nonempty.add(loc)
            else:
                self._hb_nonempty.discard(loc)

    def _heartbeat_loop(self) -> None:
        # `--hb-interval` paces the whole-fleet beat cycle: at 50k
        # servants a 0.5s cadence would spend a third of a core
        # re-beating an unchanged fleet (leases are 10s — a 2s cadence
        # is still 5x margin).  Beats are PHASE-SPREAD across the
        # interval in 256-servant chunks, matching production (every
        # servant runs its own pacemaker; 50k of them do not arrive as
        # one phase-locked burst) — the monolithic pass was a ~250ms
        # CPU burst whose GIL convoys landed in the co-hosted
        # dispatchers' stage percentiles.
        while not self._stop.is_set():
            with self.fleet_lock:
                locs = list(self.servant_running)
            if not locs:
                if self._stop.wait(self.hb_interval):
                    return
                continue
            chunk = self._hb_chunk
            pause = self.hb_interval * chunk / len(locs)
            for i in range(0, len(locs), chunk):
                for loc in locs[i:i + chunk]:
                    self._heartbeat_one(loc)
                if self._stop.wait(min(pause, 1.0)):
                    return
            self.dispatcher.on_expiration_timer()

    def _churn_loop(self) -> None:
        """Every second: `churn_per_s` random servants leave gracefully
        and are replaced by fresh machines — the scheduler's pool
        arrays, env rows, and grant bookkeeping all take the hit."""
        while not self._stop.wait(1.0):
            for _ in range(self.churn_per_s):
                with self.fleet_lock:
                    locs = list(self.servant_running)
                    if len(locs) < 2:
                        continue
                    loc = locs[int(self.rng.integers(len(locs)))]
                    orphans = list(self.servant_running.pop(loc).values())
                    self.servant_caps.pop(loc, None)
                self._join_fleet()
                info = self._ServantInfo(location=loc)
                self.dispatcher.keep_servant_alive(info, 0.0)  # leave
                self.bookkeeper.drop_servant(loc)
                self.stats["servants_churned"] += 1
                # Tasks that were running there restart elsewhere (the
                # delegate's retry ladder).
                for digest in orphans:
                    with self.run_lock:
                        comp = self.running.get(digest)
                    if comp is not None and not comp.done.is_set():
                        self.stats["retries"] += 1
                        self._dispatch(comp)

    # -- scheduler interaction ----------------------------------------------

    def _pick_delegate(self, rng) -> int:
        """Which synthetic delegate asks next: Zipf-skewed under
        --hotspot (demand concentrates on the hot delegates' home
        shards), uniform otherwise.  Each pump passes its own
        random.Random — the shared numpy Generator is not thread-safe
        and must not be hit from every fetcher."""
        if self._hotspot_cdf is None:
            return rng.randrange(self.n_delegates)
        return int(np.searchsorted(self._hotspot_cdf, rng.random()))

    def _grant_pump(self) -> None:
        """TaskGrantKeeper analogue: a fetcher batching `immediate` to
        the current number of waiters.  `--pumps` of these run
        concurrently (default: one per shard); each call RESERVES its
        demand so two pumps never double-fetch for the same waiters,
        and returns the unserved remainder.

        Calls ride the production RPC path (WaitForStartingTask handler
        + message/frame codec) through a per-delegate channel, so the
        observed peer — the shard router's routing key — is a real
        delegate address; `transport` is the client-observed wall minus
        the server-side inner time, which the in-process mock transport
        makes exact (rpc.transport.last_server_inner_s)."""
        import random

        from .. import api
        from ..rpc import RpcError
        from ..rpc import transport as rpc_transport

        rng = random.Random(threading.get_ident() ^ id(self))
        period = (self.n_pumps / self.rig_call_rate
                  if self.rig_call_rate > 0 else 0.0)
        # Phase-spread across pumps, EQUALLY: paced pumps with fixed
        # periods keep their relative phases all run long, so two
        # pumps that start near each other collide on every single
        # call (the whole run's p50 doubles) — deterministic 1/N
        # spacing is the only clustering-free assignment.
        with self.need_lock:
            pump_idx = self._pump_phase_seq
            self._pump_phase_seq += 1
        next_at = time.monotonic() + period * pump_idx / max(
            1, self.n_pumps)
        while not self._stop.is_set():
            if period > 0.0:
                ahead = next_at - time.monotonic()
                if ahead > 0:
                    time.sleep(ahead)
                next_at += period
                behind = time.monotonic() - next_at
                if behind > 0:
                    # Overran: skip the missed slots but KEEP the 1/N
                    # phase — resetting to "now" would let this pump
                    # drift into a permanent collision with another.
                    next_at += period * math.ceil(behind / period)
            with self.need_lock:
                n = min(self.need, self.pump_batch)
                if n > 0:
                    self.need -= n          # reserve
            if n <= 0:
                time.sleep(0.0005)
                continue
            chan = self.delegate_channels[self._pick_delegate(rng)]
            # Short in-scheduler wait (reference task_grant_keeper
            # polls on a demand window): a saturated shard then returns
            # its PARTIAL grant batch quickly instead of parking the
            # whole free capacity inside the pending request for the
            # full wait — grants must circulate back to the client to
            # run, complete, and free, or the request starves itself.
            req = api.scheduler.WaitForStartingTaskRequest(
                token="", immediate_reqs=n,
                milliseconds_to_wait=250, next_keep_alive_in_ms=15000)
            req.env_desc.compiler_digest = self.env
            t0 = time.perf_counter()
            try:
                resp, _ = chan.call(
                    "ytpu.SchedulerService", "WaitForStartingTask", req,
                    api.scheduler.WaitForStartingTaskResponse)
                got = [(g.task_grant_id, g.servant_location)
                       for g in resp.grants]
                stolen = int(resp.stolen_grants)
            except RpcError:
                got, stolen = [], 0  # NO_QUOTA (timeout w/o capacity)
            total = time.perf_counter() - t0
            self.grant_lat_ms.append(total * 1000.0)
            self.client_timer.record("grant_call", total)
            inner = rpc_transport.last_server_inner_s()
            if inner is not None:
                self.client_timer.record(
                    "transport", max(0.0, total - inner))
            with self.need_lock:
                self.need += n - len(got)   # return unserved demand
                self.grant_calls += 1
                self.grants_granted += len(got)
                self.grants_stolen += stolen
            if self._check_unique and got:
                with self._gid_lock:
                    for gid, _ in got:
                        if gid in self._seen_gids:
                            self._dup_gids += 1
                        self._seen_gids.add(gid)
            if self._rig_inline_free and got:
                # Pump-rig recycle: free on the spot, return the
                # demand — no per-grant queue handoff to a free thread.
                self.dispatcher.free_task([gid for gid, _ in got])
                with self.need_lock:
                    self.need += len(got)
            else:
                for g in got:
                    self.grants.put(g)

    def _demand_monitor(self) -> None:
        """~20Hz per-shard demand sampler (outstanding grants + queued
        immediate — the admission signal's numerator).  The hotspot
        A/B's claim lives here: with stealing the max-shard demand
        stays within ~2x the mean; without it the hot shard's backlog
        grows unbounded while its neighbours idle."""
        interval = 0.05 if self._hotspot_cdf is not None else 0.25
        while not self._stop.wait(interval):
            loads = [d.load_signal() for d in self.router.shards]
            self._demand_samples.append(np.array(
                [s.outstanding + s.queued_immediate for s in loads],
                np.int64))
            # Client-side backlog (tasks holding demand but not yet
            # bound to a grant): the part of "unbounded growth" the
            # scheduler-side queues — bounded by pump concurrency —
            # cannot show.
            self._backlog_samples.append(self.bind_q.qsize())

    def demand_balance(self) -> Optional[dict]:
        """Summary of the per-shard demand series: for each sample with
        any demand, max/mean across shards; reported as p50/p95 plus
        the peak absolute max-shard demand."""
        if not self._demand_samples:
            return None
        m = np.stack(self._demand_samples)        # [T, n_shards]
        totals = m.sum(axis=1)
        live = m[totals > 0]
        if live.size == 0:
            return None
        ratios = live.max(axis=1) / np.maximum(live.mean(axis=1), 1e-9)
        backlog = np.asarray(self._backlog_samples, np.int64) \
            if self._backlog_samples else np.zeros(1, np.int64)
        return {
            "samples": int(m.shape[0]),
            "live_samples": int(live.shape[0]),
            "max_over_mean_p50": round(float(np.percentile(ratios, 50)), 2),
            "max_over_mean_p95": round(float(np.percentile(ratios, 95)), 2),
            "peak_max_shard_demand": int(live.max()),
            "peak_mean_demand": round(float(live.mean(axis=1).max()), 1),
            # Ungranted client demand over time: flat/draining when the
            # plane keeps up, linear growth when a hot shard is
            # starving demand it cannot serve and will not steal for.
            "client_backlog_p50": int(np.percentile(backlog, 50)),
            "client_backlog_peak": int(backlog.max()),
        }

    async def _grant_pump_async(self, channels: dict) -> None:
        """Event-loop twin of _grant_pump (--frontend aio): each pump
        is a coroutine on the client loop, so hundreds of them cost no
        thread stacks and their outstanding calls pipeline over one
        persistent connection per delegate identity.  The server side
        parks each request as a continuation (WaitForStartingTaskParked)
        — grant_call here prices the whole parked round trip."""
        import asyncio
        import random
        import time as _t

        from .. import api
        from ..rpc import RpcError
        from ..rpc.aio_server import AsyncAioChannel

        rng = random.Random()
        target = f"127.0.0.1:{self._rpc_server.port}"
        period = (self.n_pumps / self.rig_call_rate
                  if self.rig_call_rate > 0 else 0.0)
        # Equal 1/N phase spacing — see _grant_pump: with fixed
        # periods, randomly-clustered phases collide on EVERY call for
        # the whole run.
        with self.need_lock:
            pump_idx = self._pump_phase_seq
            self._pump_phase_seq += 1
        next_at = _t.monotonic() + period * pump_idx / max(
            1, self.n_pumps)
        while not self._stop.is_set():
            if period > 0.0:
                ahead = next_at - _t.monotonic()
                if ahead > 0:
                    await asyncio.sleep(ahead)
                next_at += period
                behind = _t.monotonic() - next_at
                if behind > 0:
                    # Overran: skip missed slots, KEEP the 1/N phase
                    # (see _grant_pump).
                    next_at += period * math.ceil(behind / period)
            with self.need_lock:
                n = min(self.need, self.pump_batch)
                if n > 0:
                    self.need -= n          # reserve
            if n <= 0:
                await asyncio.sleep(0.0005)
                continue
            d = self._pick_delegate(rng)
            chan = channels.get(d)
            if chan is None:
                # call() dials under the channel's own lock, so pumps
                # racing on a fresh delegate identity share one socket.
                chan = channels[d] = AsyncAioChannel(target)
            req = api.scheduler.WaitForStartingTaskRequest(
                token="", immediate_reqs=n,
                milliseconds_to_wait=250, next_keep_alive_in_ms=15000)
            req.env_desc.compiler_digest = self.env
            t0 = _t.perf_counter()
            try:
                resp, _ = await chan.call(
                    "ytpu.SchedulerService", "WaitForStartingTask", req,
                    api.scheduler.WaitForStartingTaskResponse,
                    timeout=10.0)
                got = [(g.task_grant_id, g.servant_location)
                       for g in resp.grants]
                stolen = int(resp.stolen_grants)
            except RpcError:
                got, stolen = [], 0  # NO_QUOTA (timeout w/o capacity)
            total = _t.perf_counter() - t0
            self.grant_lat_ms.append(total * 1000.0)
            self.client_timer.record("grant_call", total)
            with self.need_lock:
                self.need += n - len(got)   # return unserved demand
                self.grant_calls += 1
                self.grants_granted += len(got)
                self.grants_stolen += stolen
            if self._check_unique and got:
                with self._gid_lock:
                    for gid, _ in got:
                        if gid in self._seen_gids:
                            self._dup_gids += 1
                        self._seen_gids.add(gid)
            if self._rig_inline_free and got:
                # Pump-rig recycle: free on the spot, return the
                # demand — no per-grant queue handoff to a free thread.
                self.dispatcher.free_task([gid for gid, _ in got])
                with self.need_lock:
                    self.need += len(got)
            else:
                for g in got:
                    self.grants.put(g)

    def _dispatch(self, comp: _Completion) -> None:
        """Register demand for `comp`; the binder marries it to a grant
        when one lands.  Submitters do NOT block per task — that design
        needed one thread per in-flight task to keep the pump's batches
        full, and on a small host the resulting thread herd wrote its
        own preemption stalls into the dispatch-stage percentiles."""
        with self.need_lock:
            self.need += 1
        self.bind_q.put(comp)

    def _binder_loop(self) -> None:
        """Marry arriving grants to pending tasks (the delegate's
        grant-pool consumer) and schedule their completions."""
        import random

        while not self._stop.is_set():
            try:
                gid, loc = self.grants.get(timeout=0.2)
            except queue.Empty:
                continue
            # A grant is only fetched against reserved demand, so a
            # pending task always exists (or arrives immediately).
            comp = self.bind_q.get()
            comp.grant_id, comp.location = gid, loc
            with self.fleet_lock:
                srv = self.servant_running.get(loc)
                if srv is not None:
                    srv[gid] = comp.digest
            dt = random.expovariate(1000.0 / self.exec_ms) \
                if self.exec_ms > 0 else 0.0
            with self.ev_cv:
                self._seq += 1
                heapq.heappush(self.events,
                               (time.monotonic() + dt, self._seq, comp))
                self.ev_cv.notify()

    def _completion_loop(self) -> None:
        from .. import api
        from ..rpc import RpcContext

        while not self._stop.is_set():
            batch: List[_Completion] = []
            with self.ev_cv:
                while not self.events and not self._stop.is_set():
                    self.ev_cv.wait(0.2)
                if self._stop.is_set():
                    return
                # Drain due events in small passes (16): the grant
                # frees amortize into ONE FreeTask batch — at a 1M-task
                # run the per-completion lock round-trip was a
                # first-order cost — while the pass stays a sub-ms GIL
                # hold so it cannot smear the dispatch-stage
                # percentiles it shares the core with.
                now = time.monotonic()
                while self.events and len(batch) < 16:
                    due, _, comp = self.events[0]
                    if due > now:
                        break
                    heapq.heappop(self.events)
                    batch.append(comp)
                if not batch:
                    due = self.events[0][0]
                    self.ev_cv.wait(min(due - now, 0.2))
                    continue
            # "Compile" finished: fill the cache (real PutEntry with the
            # servant token path), free the grants, wake joiners.
            for comp in batch:
                key = f"ytpu-cxx2-entry-{comp.digest}"
                req = api.cache.PutEntryRequest(token="", key=key)
                ctx = RpcContext(peer=comp.location)
                self.cache.PutEntry(req, b"OBJ" + comp.digest.encode(),
                                    ctx)
            self.dispatcher.free_task([c.grant_id for c in batch])
            with self.fleet_lock:
                for comp in batch:
                    srv = self.servant_running.get(comp.location)
                    if srv is not None:
                        srv.pop(comp.grant_id, None)
            with self.run_lock:
                for comp in batch:
                    self.running.pop(comp.digest, None)
            for comp in batch:
                comp.done.set()

    # -- client side ---------------------------------------------------------

    def _sync_replica(self) -> None:
        from .. import api
        from ..common import compress
        from ..common.bloom import SaltedBloomFilter
        from ..rpc import RpcContext

        now = time.monotonic()
        req = api.cache.FetchBloomFilterRequest(
            token="",
            seconds_since_last_fetch=int(
                max(1, now - self._last_fetch)),
            seconds_since_last_full_fetch=(
                int(max(1, now - self._last_full_fetch))
                if self.replica is not None else 0),
        )
        ctx = RpcContext(peer="10.255.0.1:9")
        resp = self.cache.FetchBloomFilter(req, b"", ctx)
        if resp.incremental:
            self.replica.add_many(list(resp.newly_populated_keys))
        else:
            raw = compress.decompress(ctx.response_attachment)
            salt = int.from_bytes(raw[:4], "little")
            self.replica = SaltedBloomFilter.from_bytes(
                raw[4:], num_hashes=resp.num_hashes, salt=salt)
            self._last_full_fetch = now
        self._last_fetch = now

    def _replica_loop(self) -> None:
        while not self._stop.wait(1.0):
            self._sync_replica()

    def submit(self, digest: str) -> str:
        """One TU through the delegate decision ladder:
        cache -> join running -> grant & run.  Returns the outcome."""
        key = f"ytpu-cxx2-entry-{digest}"
        if self.replica is not None and self.replica.may_contain(key):
            from .. import api
            from ..rpc import RpcContext, RpcError

            try:
                self.cache.TryGetEntry(
                    api.cache.TryGetEntryRequest(token="", key=key),
                    b"", RpcContext(peer="10.255.0.1:9"))
                self.stats["hit_cache"] += 1
                return "hit"
            except RpcError:
                pass  # Bloom false positive
        else:
            self.stats["bloom_rejects"] += 1
        with self.run_lock:
            comp = self.running.get(digest)
            if comp is not None:
                comp.joiners += 1
                self.stats["reused"] += 1
                return "join"
            comp = _Completion(digest, -1, "")
            self.running[digest] = comp
        # Cross-machine visibility parity: the bookkeeper snapshot other
        # delegates would consult (RunningTaskKeeper.TryFindTask).
        self.stats["actually_run"] += 1
        self._dispatch(comp)
        return "run"

    # -- pump rig (grant-path latency instrument) ----------------------------

    def run_pump_rig(self, calls: int, demand: int,
                     call_rate: float = 0.0,
                     time_limit_s: float = 300.0,
                     warmup_s: float = 2.0) -> dict:
        """The grant-path latency instrument: steady grant
        demand through the full RPC front end with NOTHING else on the
        box — no synthetic build clients, no cache fills, no completion
        heap.  pod_sim's full runs co-host a whole build farm in this
        process, so their grant_call tails price the farm's GIL holds,
        not the serving path; production runs those clients on other
        machines.  The rig A/Bs front ends apples-to-apples: same
        demand, same fleet, only the transport/parking model changes."""
        import sys as _sys

        from ..utils import gctune

        # The rig owns its GIL slice policy (callers may not have gone
        # through main()): long co-tenant slices land straight in the
        # client-observed tail on a 1-core box.
        prev_switch = _sys.getswitchinterval()
        _sys.setswitchinterval(0.0002)
        self.rig_call_rate = call_rate
        self._rig_inline_free = True
        # Chunks BELOW the dispatcher's staged-heartbeat flush
        # threshold (64): a chunk that hits it makes the hb thread
        # flush synchronously under the main lock — a periodic lock
        # hold the latency instrument would bill to the serving path
        # (cycles flush the small staged batches instead, under the
        # lock they already hold).
        self._hb_chunk = 16
        with self.need_lock:
            self.need = demand
        loops = [(self._heartbeat_loop, "hb")]
        if self.frontend != "aio":
            loops += [(self._grant_pump, f"grants-{i}")
                      for i in range(self.n_pumps)]
        threads = [threading.Thread(target=f, daemon=True, name=n)
                   for f, n in loops]
        pump_futs = None
        pump_channels: dict = {}
        if self.frontend == "aio":
            import asyncio

            pump_futs = [
                asyncio.run_coroutine_threadsafe(
                    self._grant_pump_async(pump_channels),
                    self._rpc_server.loops.loop)
                for _ in range(self.n_pumps)
            ]
        with gctune.guard():
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            warm_cut = None
            while True:
                with self.need_lock:
                    done = self.grant_calls
                if warm_cut is None and \
                        time.perf_counter() - t0 >= warmup_s:
                    # Channel dials, first-cycle jit of nothing-in-
                    # particular, allocator warmup: the first seconds
                    # measure the rig settling, not the path.
                    warm_cut = len(self.grant_lat_ms)
                if done >= calls or \
                        time.perf_counter() - t0 > time_limit_s:
                    break
                time.sleep(0.05)
            wall = time.perf_counter() - t0
        self._stop.set()
        for t in threads:
            t.join(timeout=10)
        if pump_futs is not None:
            for f in pump_futs:
                try:
                    f.result(timeout=5)
                except Exception:
                    pass
            self._rpc_server.loops.call_soon(
                lambda: [c.close() for c in pump_channels.values()])
        self.dispatcher.stop()
        if self._rpc_server is not None:
            self._rpc_server.stop()
        if self.frontend == "mock":
            from ..rpc import unregister_mock_server

            unregister_mock_server(self._mock_name)
        _sys.setswitchinterval(prev_switch)
        measured = self.grant_lat_ms[warm_cut or 0:]
        lat = np.array(measured) if measured else np.array([0.0])
        disp = self.dispatcher.inspect()
        disp_lat = disp["latency_breakdown"]
        svc_lat = self.service.stage_timer.percentiles()
        frontend_stages = (self._rpc_server.stage_timer.percentiles()
                          if self._rpc_server is not None
                          and hasattr(self._rpc_server, "stage_timer")
                          else None)
        return {
            "mode": "pump_rig",
            "warmup_s": warmup_s,
            "measured_calls": int(lat.size),
            "frontend": self.frontend,
            "servants": len(self.servant_running),
            "demand": demand,
            "call_rate": call_rate,
            "grant_calls_per_sec": round(self.grant_calls / wall, 1),
            "pumps": self.n_pumps,
            "pump_batch": self.pump_batch,
            "wall_seconds": round(wall, 2),
            "grant_calls": int(self.grant_calls),
            "grants_granted": int(self.grants_granted),
            "assignments_per_sec": round(self.grants_granted / wall, 1),
            "grant_call_p50_ms": round(float(np.percentile(lat, 50)), 2),
            "grant_call_p99_ms": round(float(np.percentile(lat, 99)), 2),
            "latency_breakdown": {
                "queue_wait_ms": disp_lat.get("queue_wait"),
                "dispatch_cycle_ms": disp_lat.get("dispatch_cycle"),
                "rpc_handler_ms": svc_lat.get(
                    "WaitForStartingTask:handler"),
                "rpc_serialize_ms": svc_lat.get(
                    "WaitForStartingTask:serialize"),
                "frontend_stages": frontend_stages,
            },
        }

    # -- run -----------------------------------------------------------------

    def run(self, tasks: int, dup_rate: float,
            submitters: int = 8) -> dict:
        from ..utils import gctune

        n_unique = max(1, int(tasks * (1.0 - dup_rate)))
        sources = [f"{i:08x}" + "s" * 56 for i in range(n_unique)]
        picks = np.concatenate([
            np.arange(n_unique),
            self.rng.integers(0, n_unique, tasks - n_unique)])
        self.rng.shuffle(picks)

        self._sync_replica()
        loops = [(self._heartbeat_loop, "hb"),
                 (self._churn_loop, "churn"),
                 (self._completion_loop, "complete"),
                 (self._binder_loop, "binder"),
                 (self._replica_loop, "bloom")]
        if self.frontend != "aio":
            loops += [(self._grant_pump, f"grants-{i}")
                      for i in range(self.n_pumps)]
        if self.router is not None:
            loops.append((self._demand_monitor, "demand"))
        pump_loop = pump_futs = None
        pump_channels: dict = {}
        if self.frontend == "aio":
            # All pumps are coroutines on ONE loop — the server's: N
            # pumps cost N coroutine frames, not N thread stacks, their
            # calls pipeline over per-delegate persistent connections,
            # and the whole grant round trip (send -> parse -> parked
            # handler -> inline cycle -> write -> response) runs with
            # ZERO thread handoffs, the fiber model this front end
            # reproduces.  (In production client and scheduler are
            # different machines; co-hosting the pump coroutines on the
            # scheduler's loop is the 1-core rig's closest analogue
            # that doesn't bill OS thread scheduling to the wire.)
            import asyncio

            pump_loop = self._rpc_server.loops
            pump_futs = [
                asyncio.run_coroutine_threadsafe(
                    self._grant_pump_async(pump_channels), pump_loop.loop)
                for _ in range(self.n_pumps)
            ]
        threads = [threading.Thread(target=f, daemon=True, name=n)
                   for f, n in loops]
        work = queue.Queue()
        for p in picks:
            work.put(sources[p])
        outcomes: List[_Completion] = []
        out_lock = threading.Lock()

        def submitter():
            pending = []
            share = (self.arrival_rate / submitters
                     if self.arrival_rate > 0 else 0.0)
            t_start = time.monotonic()
            n_done = 0
            while True:
                try:
                    digest = work.get_nowait()
                except queue.Empty:
                    break
                self.submit(digest)
                n_done += 1
                if share > 0 and n_done % 32 == 0:
                    ahead = t_start + n_done / share - time.monotonic()
                    if ahead > 0:
                        time.sleep(ahead)
                with self.run_lock:
                    c = self.running.get(digest)
                if c is not None:
                    pending.append(c)
            with out_lock:
                outcomes.extend(pending)

        # The measured phase runs under the same GC configuration the
        # scheduler serves with (scheduler/entry.py LatencyGcGuard):
        # the cyclic collector's gen-2 stop-the-world pauses are
        # multi-ms p99 outliers production takes off the grant path.
        with gctune.guard():
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            subs = [threading.Thread(target=submitter, daemon=True)
                    for _ in range(submitters)]
            for t in subs:
                t.start()
            for t in subs:
                t.join(timeout=900)
            # Wait for in-flight compiles to land.
            deadline = time.monotonic() + 120
            for c in outcomes:
                c.done.wait(timeout=max(0.0, deadline - time.monotonic()))
            wall = time.perf_counter() - t0
        self._stop.set()
        with self.ev_cv:
            self.ev_cv.notify_all()
        for t in threads:
            t.join(timeout=10)
        if pump_futs is not None:
            for f in pump_futs:
                try:
                    f.result(timeout=5)
                except Exception:
                    pass
            pump_loop.call_soon(
                lambda: [c.close() for c in pump_channels.values()])
            # The loop is the rpc server's; its stop() below owns it.
        self.dispatcher.stop()
        if self._rpc_server is not None:
            self._rpc_server.stop()
        if self.frontend == "mock":
            from ..rpc import unregister_mock_server

            unregister_mock_server(self._mock_name)
        if self.router is not None and self._mesh_loads != "off":
            # The sweep refreshes it once a heartbeat pass (~1 s): a run
            # shorter than that still reports the device's load view.
            self.router.refresh_load_summary()
        lat = np.array(self.grant_lat_ms) if self.grant_lat_ms else \
            np.array([0.0])
        disp = self.dispatcher.inspect()
        done = sum(self.stats[k] for k in
                   ("hit_cache", "reused", "actually_run"))
        disp_lat = disp["latency_breakdown"]
        svc_lat = self.service.stage_timer.percentiles()
        client_lat = self.client_timer.percentiles()
        dispatch_cycle = disp_lat.get("dispatch_cycle")
        with self.fleet_lock:
            caps = np.array(list(self.servant_caps.values()), np.int64)
        # Sharded-plane extras: steal accounting, per-shard stage
        # breakdowns, the demand-balance series and the device load
        # summary.
        sharded: dict = {}
        if self.router is not None:
            per_shard = []
            shard_cycle_p99 = []
            for k, ins in enumerate(disp["per_shard"]):
                lb = ins["latency_breakdown"]
                cyc = lb.get("dispatch_cycle")
                if cyc:
                    shard_cycle_p99.append(cyc["p99_ms"])
                per_shard.append({
                    "shard": k,
                    "servants": len(ins["servants"]),
                    "granted": ins["stats"]["granted"],
                    "grants_outstanding": ins["grants_outstanding"],
                    "latency_breakdown": lb,
                })
            sharded = {
                "shards": self.shards,
                "hotspot": self.hotspot or "none",
                "steal": disp["steal"],
                "steal_rate": round(
                    self.grants_stolen / max(1, self.grants_granted), 4),
                "duplicate_grant_ids": (
                    self._dup_gids if self._check_unique else None),
                "dispatch_only_p99_ms_max_shard": (
                    round(max(shard_cycle_p99), 4)
                    if shard_cycle_p99 else None),
                "demand_balance": self.demand_balance(),
                "load_summary": disp.get("load_summary"),
                "per_shard": per_shard,
            }
        # aio front end: the server's accept/read/parse/write stages
        # (rpc/aio_server.py's StageTimer) make the residual transport
        # time attributable instead of a lump.
        frontend_stages = (self._rpc_server.stage_timer.percentiles()
                          if self._rpc_server is not None
                          and hasattr(self._rpc_server, "stage_timer")
                          else None)
        return {
            "frontend": self.frontend,
            "tasks": int(done),
            "servants": len(self.servant_running),
            "servant_capacity": self.capacity,
            "capacity_dist": self.capacity_dist,
            "total_capacity": int(caps.sum()),
            "capacity_min_max": [int(caps.min()), int(caps.max())],
            "policy": disp["policy"],
            "exec_ms_mean": self.exec_ms,
            "churn_per_s": self.churn_per_s,
            "wall_seconds": round(wall, 2),
            "tasks_per_sec": round(done / wall, 1),
            # The control-plane headline: grants issued per second
            # through the full RPC grant path (the --ab axis).
            "assignments_per_sec": round(self.grants_granted / wall, 1),
            "breakdown": {k: int(self.stats[k]) for k in
                          ("hit_cache", "reused", "actually_run",
                           "retries", "servants_churned")},
            "grant_calls": int(self.grant_calls),
            "grants_granted": int(self.grants_granted),
            "grants_stolen": int(self.grants_stolen),
            "sharded": sharded or None,
            "grant_call_p50_ms": round(float(np.percentile(lat, 50)), 2),
            "grant_call_p99_ms": round(float(np.percentile(lat, 99)), 2),
            # Per-stage decomposition of the grant path (each entry:
            # {count, mean_ms, p50_ms, p99_ms}; doc/scheduler.md
            # "Grant-path stage budget" explains how to read it).
            "latency_breakdown": {
                "queue_wait_ms": disp_lat.get("queue_wait"),
                "snapshot_ms": disp_lat.get("snapshot"),
                "policy_ms": disp_lat.get("policy"),
                "apply_ms": disp_lat.get("apply"),
                "dispatch_cycle_ms": dispatch_cycle,
                "rpc_handler_ms": svc_lat.get(
                    "WaitForStartingTask:handler"),
                "rpc_serialize_ms": svc_lat.get(
                    "WaitForStartingTask:serialize"),
                "transport_ms": client_lat.get("transport"),
                "grant_call_ms": client_lat.get("grant_call"),
                "frontend_stages": frontend_stages,
            },
            # The BASELINE "<2ms dispatch" budget: scheduler-side work
            # per cycle (snapshot + policy + apply), excluding the
            # client's own wait semantics.
            "dispatch_only_p99_ms": (
                dispatch_cycle["p99_ms"] if dispatch_cycle else None),
            "scheduler_stats": disp["stats"],
            "cache": self.cache.inspect(),
            "_meta": {
                "virtual": "servant execution + build clients "
                           "(event-driven); scheduler, cache, bloom, "
                           "bookkeeper are the production classes",
            },
        }


def run_one(args, *, shards: int, hotspot: Optional[str], steal: bool,
            tasks: int, check_unique: bool = False) -> dict:
    sim = PodSim(args.servants, args.capacity, args.policy,
                 args.exec_ms, args.churn_per_s,
                 pipeline_depth=args.pipeline_depth,
                 capacity_dist=args.capacity_dist,
                 shards=shards, hotspot=hotspot, steal=steal,
                 delegates=args.delegates, pumps=args.pumps,
                 hb_interval=args.hb_interval,
                 mesh_loads=args.mesh_loads,
                 check_unique=check_unique,
                 arrival_rate=args.arrival_rate,
                 pump_batch=args.pump_batch,
                 steal_batch=args.steal_batch,
                 frontend=args.frontend,
                 device=args.device)
    return sim.run(tasks, args.dup_rate, args.submitters)


def smoke(args) -> int:
    """CI gate (`pod_sim --shards 4 --smoke`): a small hotspot-skewed
    sharded run asserting the sharded plane's invariants — steal
    engages, no grant id is ever double-issued, aggregate counters ==
    Σ per-shard, and nothing is lost.  With the default --mesh-loads
    the router's load summary runs on the device, and the gate requires
    one."""
    args.servants = min(args.servants, 96)
    args.capacity = 2
    args.capacity_dist = "fixed"
    args.exec_ms = 40.0
    args.churn_per_s = 0
    args.policy = "greedy_cpu"
    args.dup_rate = 0.2
    args.submitters = 6
    out = run_one(args, shards=max(2, args.shards),
                  hotspot=args.hotspot or "zipf:1.5", steal=True,
                  tasks=1500, check_unique=True)
    sh = out["sharded"]
    b = out["breakdown"]
    failures = []
    if out["tasks"] != 1500:
        failures.append(f"lost tasks: {out['tasks']}/1500")
    if b["hit_cache"] + b["reused"] + b["actually_run"] != 1500:
        failures.append("outcome ladder does not sum")
    if sh["duplicate_grant_ids"] != 0:
        failures.append(
            f"DOUBLE-ISSUED grant ids: {sh['duplicate_grant_ids']}")
    if sh["steal"]["stolen_grants"] <= 0:
        failures.append("steal path never engaged under hotspot skew")
    if out["grants_granted"] != out["scheduler_stats"]["granted"]:
        failures.append("aggregate granted != client-observed grants")
    per_shard_granted = sum(p["granted"] for p in sh["per_shard"])
    if per_shard_granted != out["scheduler_stats"]["granted"]:
        failures.append("aggregate stats != Σ per-shard stats")
    if args.mesh_loads != "off" and sh["load_summary"] is None:
        failures.append("the device load summary never ran")
    print(json.dumps({
        "smoke": "pod_sim_sharded",
        "shards": sh["shards"],
        "hotspot": sh["hotspot"],
        "tasks": out["tasks"],
        "assignments_per_sec": out["assignments_per_sec"],
        "steal_rate": sh["steal_rate"],
        "stolen_grants": sh["steal"]["stolen_grants"],
        "duplicate_grant_ids": sh["duplicate_grant_ids"],
        "load_summary": sh["load_summary"],
        "failures": failures,
    }, indent=2))
    return 1 if failures else 0


def run_ab(args) -> dict:
    """The sharded-vs-single + steal-on/off A/B.  Four sections:

    1. `sharded` — the throughput run (flood arrivals, deep batches):
       assignments/s vs a single-dispatcher run of the same arguments
       made first in this call, on the same device and host.
    2. `sharded_latency` + `single_50k_control` — the latency pair:
       the SAME fleet at the baseline run's task pressure, sharded vs
       one dispatcher, so the per-shard dispatch-cycle cost is compared
       apples-to-apples at scale.
    3. `hotspot_ab` — the same Zipf-skewed workload twice, stealing on
       and off, on a deliberately overloadable fleet.

    Throughput and unpolluted latency are measured in separate runs on
    purpose: the sim co-hosts scheduler and clients in one process, so
    a flood's client CPU dilates every stage percentile it shares the
    core with (see the GIL slice in main)."""
    import sys

    sys.setswitchinterval(0.001)
    print(f"== single-dispatcher baseline: {args.servants} servants, "
          f"{args.tasks} tasks ==", flush=True)
    b = run_one(args, shards=1, hotspot=None, steal=True, tasks=args.tasks)
    baseline = {
        "source": "a single-dispatcher run in this call",
        "servants": b["servants"],
        "tasks": b["tasks"],
        "assignments_per_sec": round(
            b["grants_granted"] / b["wall_seconds"], 1),
        "tasks_per_sec": b["tasks_per_sec"],
        "dispatch_only_p99_ms": b["dispatch_only_p99_ms"],
        "grant_call_p99_ms": b["grant_call_p99_ms"],
    }

    # Best-of-2 (the repo's bench convention — bloom_bench is
    # best-of-3): on a 1-core co-hosted rig, run-to-run thread
    # scheduling moves whole-run throughput by ±15%; both runs are
    # recorded.
    runs = []
    for i in range(2):
        print(f"== sharded throughput run {i + 1}/2: {args.shards} "
              f"shards, {args.servants} servants, {args.tasks} "
              f"tasks ==", flush=True)
        runs.append(run_one(args, shards=args.shards, hotspot=None,
                            steal=True, tasks=args.tasks))
    sharded = max(runs, key=lambda r: r["assignments_per_sec"])

    # Latency pair: the baseline's task pressure, same fleet, quieter
    # rig (few threads, coarse GIL slice) so the stage percentiles price
    # the scheduler, not its co-tenants.
    lat = argparse.Namespace(**vars(args))
    lat.submitters = 2
    lat.pumps = 1
    lat.pump_batch = 32
    lat.hb_interval = max(args.hb_interval, 3.0)
    lat.arrival_rate = baseline["tasks_per_sec"]
    lat_tasks = min(args.tasks, 60000)
    sys.setswitchinterval(0.002)
    print(f"== latency pair at {lat.arrival_rate:.0f} tasks/s: "
          f"{args.shards} shards ==", flush=True)
    sharded_lat = run_one(lat, shards=args.shards, hotspot=None,
                          steal=True, tasks=lat_tasks)
    print("== latency pair: single dispatcher, same fleet ==",
          flush=True)
    single_lat = run_one(lat, shards=1, hotspot=None, steal=True,
                         tasks=lat_tasks)
    sys.setswitchinterval(0.001)

    # Hotspot A/B: a deliberately overloadable fleet (small capacity,
    # long execution) with Zipf-skewed demand, stealing on vs off.
    hs = argparse.Namespace(**vars(args))
    hs.servants = max(args.shards * 64, 256)
    hs.capacity = 2
    hs.capacity_dist = "fixed"
    hs.exec_ms = 120.0
    hs.churn_per_s = 0
    hs.submitters = 4
    hs.dup_rate = 0.0
    # Flood arrivals: the contrast is sharpest at saturation, where
    # placement is capacity-bound — the stealing plane spreads the hot
    # delegates' demand across every shard's servants (max/mean demand
    # near 1, backlog drains at the whole fleet's rate) while the
    # no-steal plane grinds at its hot shards' capacity with the rest
    # of the fleet idle.
    hs.arrival_rate = 0.0
    hs.pump_batch = 32
    hs.steal_batch = 128
    hotspot = args.hotspot or "zipf:1.4"
    hs_tasks = min(args.tasks, 20000)
    print(f"== hotspot A/B ({hotspot}): steal ON ==", flush=True)
    steal_on = run_one(hs, shards=args.shards, hotspot=hotspot,
                       steal=True, tasks=hs_tasks, check_unique=True)
    print(f"== hotspot A/B ({hotspot}): steal OFF ==", flush=True)
    steal_off = run_one(hs, shards=args.shards, hotspot=hotspot,
                        steal=False, tasks=hs_tasks)

    def cyc(run, key):
        c = run["latency_breakdown"].get("dispatch_cycle_ms")
        return c and c.get(key)

    speedup = round(sharded["assignments_per_sec"]
                    / max(baseline["assignments_per_sec"], 1e-9), 2)
    return {
        "metric": "pod_sim_sharded_ab",
        "single_dispatcher_baseline": baseline,
        "sharded": sharded,
        "sharded_throughput_runs": [
            r["assignments_per_sec"] for r in runs],
        "sharded_vs_single_assignments_speedup": speedup,
        "latency_pair": {
            "arrival_rate": lat.arrival_rate,
            "tasks": lat_tasks,
            "sharded_dispatch_cycle_p50_ms": cyc(sharded_lat, "p50_ms"),
            "sharded_dispatch_cycle_p99_ms_max_shard":
                sharded_lat["sharded"]["dispatch_only_p99_ms_max_shard"],
            "single_dispatch_cycle_p50_ms": cyc(single_lat, "p50_ms"),
            "single_dispatch_cycle_p99_ms":
                single_lat["dispatch_only_p99_ms"],
            "sharded": sharded_lat,
            "single_50k_control": single_lat,
        },
        "hotspot_ab": {
            "hotspot": hotspot,
            "tasks": hs_tasks,
            "steal_on": steal_on,
            "steal_off": steal_off,
            "max_over_mean_p95_steal_on": (
                steal_on["sharded"]["demand_balance"] or {}
            ).get("max_over_mean_p95"),
            "max_over_mean_p95_steal_off": (
                steal_off["sharded"]["demand_balance"] or {}
            ).get("max_over_mean_p95"),
        },
        "_meta": {
            "rig": "co-hosted process: scheduler shards, virtual fleet, "
                   "and build clients share one GIL; the throughput "
                   "run's stage p99s are dilated by client CPU, hence "
                   "the separate baseline-pressure latency pair",
            "device": _device_name(args.device),
        },
    }


# -- device-resident dispatch (doc/scheduler.md "Device-resident
# dispatch"): the A/B and CI gate for the fused one-launch control
# plane, where the concatenated pool lives on the device and N per-shard
# policy calls become ONE launch of K1 over a grid of shards. ----------


def _device_name(device) -> str:
    import torch

    dev = torch.device(device)
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def _build_resident_rig(n_shards: int, n_servants: int, width: int,
                        policy_name: str, cap_sampler, rng,
                        fused: bool, oracle_interval: int = 32,
                        device="cuda"):
    """A ShardRouter with thread-less shards (external stream driving)
    and the virtual fleet registered, its policies and fused pool on
    ``device``.  `fused=True` arms the device-resident plane (one launch
    of K1 over a grid of shards a sweep); `fused=False` is the host-loop
    control arm (each shard's own policy, N sync cycles per sweep)."""
    from ..device import resolve_device
    from ..scheduler.policy import make_policy
    from ..scheduler.shard_router import ShardRouter
    from ..scheduler.task_dispatcher import ServantInfo

    dev = resolve_device(str(device))
    router = ShardRouter.build(
        lambda k: make_policy(policy_name, device=dev),
        n_shards, max_servants_per_shard=width, device=dev,
        batch_window_s=0.0, start_dispatch_thread=False)
    for i in range(n_servants):
        router.keep_servant_alive(ServantInfo(
            location=f"10.{i >> 16}.{(i >> 8) & 255}.{i & 255}:8335",
            version=1, capacity=int(cap_sampler(rng)),
            num_processors=8, memory_available=32 << 30,
            dedicated=False,
            env_digests=(f"env{i % 8}",)), 3600.0)
    if fused:
        router.enable_fused_dispatch(oracle_interval=oracle_interval)
    return router


def _drive_resident_cycles(router, cycles: int, demand: int, fused: bool,
                           rng, cap_sampler, n_servants: int,
                           churn_every: int = 4, warmup: int = 3,
                           on_cycle=None) -> dict:
    """The lock-step demand/cycle/free loop both A/B arms share: park
    `demand` immediate grants per shard, run one control-plane sweep
    (ONE fused launch, or N per-shard sync cycles), retire what
    completed, churn a few servants' capacities (dirty slots -> the
    fused arm's scatter deltas).  Returns throughput + cycle timing +
    the full, order-preserving grant-id list (the double-issue check)."""
    from ..scheduler.task_dispatcher import ServantInfo

    # One persistent completion list, drained once per cycle: a
    # partially-satisfied request delivers its grants on a LATER
    # cycle's sweep, and they must still reach free_task.  Lock-step
    # keeps this single-threaded (on_done fires inside our own sweep
    # or submit calls).
    got: list = []

    def sweep():
        if fused:
            return router.run_fused_cycle()
        return sum(d.run_dispatch_cycle_for_testing()
                   for d in router.shards)

    def submit(c):
        for k, d in enumerate(router.shards):
            d.submit_wait_for_starting_new_task(
                f"env{(c + k) % 8}", immediate=demand,
                timeout_s=30.0, on_done=got.extend)

    def drain() -> list:
        gids = [g for g, _ in got]
        got.clear()
        return gids

    def churn(c):
        # A trickle of capacity heartbeats: real fleet churn, and the
        # thing the delta protocol exists for.
        for _ in range(4):
            i = int(rng.integers(0, n_servants))
            router.keep_servant_alive(ServantInfo(
                location=f"10.{i >> 16}.{(i >> 8) & 255}.{i & 255}:8335",
                version=1, capacity=int(cap_sampler(rng)),
                num_processors=8, memory_available=32 << 30,
                dedicated=False,
                env_digests=(f"env{i % 8}",)), 3600.0)

    for c in range(warmup):            # compile + prime, untimed
        submit(c)
        sweep()
        router.free_task(drain())

    all_gids: list = []
    cycle_s: list = []
    issued_total = 0
    t0 = time.perf_counter()
    for c in range(cycles):
        submit(c)
        tc = time.perf_counter()
        issued_total += sweep()
        cycle_s.append(time.perf_counter() - tc)
        gids = drain()
        all_gids.extend(gids)
        router.free_task(gids)
        if churn_every and c % churn_every == churn_every - 1:
            churn(c)
        if on_cycle is not None:
            on_cycle(c)
    wall = time.perf_counter() - t0
    cyc = np.array(cycle_s) * 1000.0
    return {
        "cycles": cycles,
        "grants_issued": issued_total,
        "grants_completed": len(all_gids),
        "assignments_per_sec": round(issued_total / wall, 1),
        "cycle_ms_p50": round(float(np.percentile(cyc, 50)), 3),
        "cycle_ms_p99": round(float(np.percentile(cyc, 99)), 3),
        "wall_seconds": round(wall, 3),
        "grant_ids": all_gids,
    }


def run_device_ab(args) -> dict:
    """The host-loop vs fused-resident A/B: the SAME fleet, demand, and
    churn trickle through two control planes —

    A. host loop: each shard's own torch_grouped policy, N sync
       dispatch cycles per sweep (per-cycle pool upload, one K1 launch
       per shard);
    B. fused resident: ONE launch of K1 over a grid of shards per
       sweep, the concatenated pool device-resident across cycles,
       churn arriving as scatter deltas, every shard's picks applied
       through its unmodified grant bookkeeping.

    On ``--device cpu`` both planes run their plain versions on the
    host, so the A/B prices the mechanics (per-sweep launch count,
    upload bytes), not the card — the regime label says which reading
    applies."""
    import torch

    shards = args.shards if args.shards > 1 else 8
    servants = args.servants if args.servants != 512 else 50000
    per = (servants + shards - 1) // shards
    # The hash-imbalance sizing: consistent-hash shards don't split
    # the fleet exactly evenly.
    width = max(256, (per * 10 // 8 + 64 + 255) // 256 * 256)
    demand = max(8, args.pump_batch // 2)
    cycles = max(20, min(300, args.tasks // (demand * shards)))
    cap = parse_capacity_dist(args.capacity_dist, args.capacity)

    out: dict = {
        "metric": "pod_sim_device_resident_ab",
        "shards": shards, "servants": servants,
        "shard_width": width, "demand_per_shard_cycle": demand,
        "rtt_regime": ("device" if torch.device(args.device).type == "cuda"
                       else "host"),
    }
    for arm, fused, policy in (("host_loop", False, "torch_grouped"),
                               ("fused_resident", True, "greedy_cpu")):
        print(f"== {arm}: {shards} shards x {servants} servants, "
              f"{cycles} cycles ==", flush=True)
        rng = np.random.default_rng(11)
        router = _build_resident_rig(shards, servants, width, policy,
                                     cap, rng, fused=fused,
                                     device=args.device)
        try:
            res = _drive_resident_cycles(router, cycles, demand, fused,
                                         rng, cap, servants)
            gids = res.pop("grant_ids")
            res["duplicate_grant_ids"] = len(gids) - len(set(gids))
            if fused:
                res["fused"] = router.fused_stats()
                res["policy"] = "resident_control_plane_step"
            else:
                res["policy"] = policy
            out[arm] = res
        finally:
            router.stop()
    a, b = out["host_loop"], out["fused_resident"]
    if a["assignments_per_sec"]:
        out["fused_vs_host_loop_speedup"] = round(
            b["assignments_per_sec"] / a["assignments_per_sec"], 2)
    out["_meta"] = {
        "rig": "single-process lock-step sweeps; both arms share the "
               "demand/free/churn loop, only the control plane "
               "differs.  On the CPU the fused arm's win is per-sweep "
               "launch count and upload bytes, not device compute; on "
               "the card the host loop also pays a launch and a "
               "picks download per shard per sweep.",
        "device": _device_name(args.device),
    }
    return out


def smoke_device(args) -> int:
    """CI gate (`pod_sim --device-resident --smoke`): a
    small fused-resident run asserting the device plane's correctness
    invariants, lock-step so every launch is exactly reconstructable:

    * every shard's picks each cycle == greedy_assign_reference run on
      that shard's launch snapshot (per-descriptor-run multisets — the
      grouped kernel permutes within a run of identical requests);
    * the advanced device running slice == the reference's mutated
      running (the fused fold + in-kernel grant delta agree with the
      host's authoritative bookkeeping);
    * no grant id is ever double-issued;
    * the per-cycle statics oracle (interval=1) never trips."""
    from ..models.cost import DEFAULT_COST_MODEL
    from ..ops.assignment import greedy_assign_reference

    shards = args.shards if args.shards > 1 else 4
    servants, width, demand, cycles = 128, 256, 16, 20
    rng = np.random.default_rng(23)
    cap = parse_capacity_dist("uniform:2:6", 4)
    router = _build_resident_rig(shards, servants, width, "greedy_cpu",
                                 cap, rng, fused=True, oracle_interval=1,
                                 device=args.device)
    cm = getattr(router.shards[0]._policy, "_cm", DEFAULT_COST_MODEL)
    failures: list = []
    parity_runs = [0]
    per = router.shards[0].max_servants

    def check_cycle(c):
        fused = router._fused
        dev_running = fused["pool"].running.cpu().numpy()
        for entry in fused.get("last_cycle", ()):
            k = entry["shard"]
            work, descr, snap, gen, adj, resets, lid, dirty = \
                entry["launch"]
            picks = entry["picks"]
            pool_np = {
                "alive": snap.alive.copy(),
                "capacity": snap.capacity.astype(np.int64).copy(),
                "running": snap.running.astype(np.int64).copy(),
                "dedicated": snap.dedicated.copy(),
                "version": snap.version.copy(),
                "env_bitmap": snap.env_bitmap.copy(),
            }
            tasks = []
            for env, mv, avoid, count in descr:
                tasks.extend([(env, mv, avoid)] * count)
            ref = greedy_assign_reference(pool_np, tasks, cm)
            off = 0
            for env, mv, avoid, count in descr:
                if sorted(picks[off:off + count]) != \
                        sorted(ref[off:off + count]):
                    failures.append(
                        f"cycle {c} shard {k}: picks diverge from "
                        f"greedy_assign_reference in run env={env} "
                        f"(dev={sorted(picks[off:off + count])} "
                        f"ref={sorted(ref[off:off + count])})")
                    return
                parity_runs[0] += 1
                off += count
            if not np.array_equal(dev_running[k * per:(k + 1) * per],
                                  pool_np["running"]):
                failures.append(
                    f"cycle {c} shard {k}: device running slice "
                    "diverges from the reference's bookkeeping")

    res = _drive_resident_cycles(router, cycles, demand, True, rng, cap,
                                 servants, churn_every=3,
                                 on_cycle=check_cycle)
    gids = res.pop("grant_ids")
    stats = router.fused_stats() or {}
    router.stop()
    dupes = len(gids) - len(set(gids))
    if res["grants_issued"] <= 0:
        failures.append("fused plane issued no grants")
    if parity_runs[0] <= 0:
        failures.append("parity oracle never saw a launch")
    if dupes:
        failures.append(f"DOUBLE-ISSUED grant ids: {dupes}")
    if stats.get("oracle_mismatches"):
        failures.append(
            f"statics oracle tripped {stats['oracle_mismatches']}x")
    if not stats.get("oracle_checks"):
        failures.append("statics oracle never ran at interval=1")
    print(json.dumps({
        "smoke": "pod_sim_device_resident",
        "shards": shards,
        "cycles": res["cycles"],
        "grants_issued": res["grants_issued"],
        "parity_runs_checked": parity_runs[0],
        "duplicate_grant_ids": dupes,
        "fused": stats,
        "failures": failures,
    }, indent=2))
    return 1 if failures else 0


def quick_sharded_assignments_per_sec(device: str = "cuda") -> float:
    """Canary: grants/s through a small 4-shard router (hotspot-free,
    steal armed) on the full RPC grant path; greedy_cpu, with the
    cross-shard load summary on ``device``."""
    ap = build_arg_parser()
    args = ap.parse_args([
        "--servants", "256", "--capacity", "8", "--policy", "greedy_cpu",
        "--exec-ms", "4", "--churn-per-s", "0", "--dup-rate", "0.2",
        "--submitters", "8", "--shards", "4", "--hb-interval", "0.5",
        "--device", str(device),
    ])
    out = run_one(args, shards=4, hotspot=None, steal=True, tasks=6000)
    return float(out["assignments_per_sec"])


def run_pump_rig_one(args) -> dict:
    sim = PodSim(args.servants, args.capacity, args.policy,
                 0.0, args.churn_per_s,
                 capacity_dist=args.capacity_dist,
                 shards=args.shards,
                 delegates=args.delegates,
                 pumps=args.pumps or 4,
                 hb_interval=args.hb_interval,
                 mesh_loads="off",
                 pump_batch=args.pump_batch,
                 frontend=args.frontend,
                 device=args.device)
    return sim.run_pump_rig(args.rig_calls, args.rig_demand,
                            call_rate=args.rig_rate)


def quick_aio_grant_call_p99_ms(device: str = "cuda") -> float:
    """Canary: grant_call p99 through the aio front end (parked
    WaitForStartingTask, coroutine pumps, real loopback sockets) on a
    small single-dispatcher pump rig."""
    ap = build_arg_parser()
    args = ap.parse_args([
        "--servants", "256", "--capacity", "8", "--policy", "greedy_cpu",
        "--churn-per-s", "0", "--pumps", "4", "--pump-batch", "16",
        "--hb-interval", "2.0", "--frontend", "aio",
        "--rig-calls", "4000", "--rig-demand", "128", "--rig-rate", "400",
        "--device", str(device),
    ])
    return float(run_pump_rig_one(args)["grant_call_p99_ms"])


def build_arg_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser("ytpu-torch-pod-sim")
    ap.add_argument("--device", default="cuda",
                    help="where the device policies, the load summary "
                         "and the fused plane run: cuda (the default; "
                         "raises without a card) or cpu (their plain "
                         "versions)")
    ap.add_argument("--tasks", type=int, default=50000)
    ap.add_argument("--servants", type=int, default=512)
    ap.add_argument("--capacity", type=int, default=8)
    ap.add_argument("--dup-rate", type=float, default=0.3)
    ap.add_argument("--exec-ms", type=float, default=30.0)
    ap.add_argument("--churn-per-s", type=int, default=2)
    ap.add_argument("--policy", default="auto")
    ap.add_argument("--pipeline-depth", type=int, default=0)
    ap.add_argument("--submitters", type=int, default=8)
    ap.add_argument("--capacity-dist", default="fixed",
                    help="per-servant capacity distribution: fixed | "
                         "uniform:LO:HI | bimodal:A:B:FRAC "
                         "(BASELINE configs[4] heterogeneous bin-pack)")
    ap.add_argument("--shards", type=int, default=1,
                    help="scheduler control-plane shards "
                         "(doc/scheduler.md \"Sharded control plane\")")
    ap.add_argument("--hotspot", default=None,
                    help="arrival skew over the synthetic delegates: "
                         "zipf:<exponent> (concentrates demand on the "
                         "hot delegates' home shards, exercising the "
                         "cross-shard steal path)")
    ap.add_argument("--no-steal", action="store_true",
                    help="disable cross-shard work stealing (the "
                         "hotspot A/B's control arm)")
    ap.add_argument("--delegates", type=int, default=32,
                    help="synthetic delegate identities (each a "
                         "distinct RPC peer = routing key)")
    ap.add_argument("--pumps", type=int, default=None,
                    help="concurrent grant fetchers (default: one per "
                         "shard)")
    ap.add_argument("--hb-interval", type=float, default=0.5,
                    help="whole-fleet heartbeat sweep period, seconds")
    ap.add_argument("--switch-interval", type=float, default=0.001,
                    help="sys.setswitchinterval for the rig (see main; "
                         "0.005 for latency-focused runs)")
    ap.add_argument("--arrival-rate", type=float, default=0.0,
                    help="paced task arrivals/s across submitters "
                         "(0 = flood as fast as the box allows)")
    ap.add_argument("--pump-batch", type=int, default=128,
                    help="max grants requested per WaitForStartingTask "
                         "call")
    ap.add_argument("--steal-batch", type=int, default=64,
                    help="max grants per cross-shard steal op "
                         "(StealConfig.max_batch)")
    ap.add_argument("--mesh-loads", default="auto",
                    choices=["auto", "off"],
                    help="cross-shard load summary on --device "
                         "(parallel/mesh.py:shard_load_summary) or none")
    ap.add_argument("--frontend", default="mock",
                    choices=["mock", "grpc", "aio"],
                    help="grant-call transport: 'mock' = in-process, "
                         "'grpc' = the threaded server over real "
                         "loopback sockets, 'aio' = the event-loop front "
                         "end with parked WaitForStartingTask and "
                         "coroutine pumps")
    ap.add_argument("--pump-rig", action="store_true",
                    help="grant-path latency instrument: steady grant "
                         "demand (see --rig-demand) through the chosen "
                         "--frontend with no synthetic build clients "
                         "co-hosted, reporting grant_call percentiles")
    ap.add_argument("--rig-calls", type=int, default=20000,
                    help="pump-rig: grant calls to record")
    ap.add_argument("--rig-demand", type=int, default=256,
                    help="pump-rig: steady outstanding grant demand")
    ap.add_argument("--rig-rate", type=float, default=0.0,
                    help="pump-rig: aggregate grant calls/s across "
                         "pumps (0 = flood; a latency claim needs a "
                         "below-saturation rate)")
    ap.add_argument("--device-resident", action="store_true",
                    help="fused device-resident control plane (one "
                         "launch of K1 over a grid of shards a sweep): "
                         "alone = host-loop vs fused-resident A/B, with "
                         "--smoke = the picks-parity CI gate against "
                         "greedy_assign_reference")
    ap.add_argument("--smoke", action="store_true",
                    help="CI gate: small sharded hotspot run with "
                         "invariant assertions (exit 1 on violation)")
    ap.add_argument("--ab", action="store_true",
                    help="run the sharded-vs-single + steal-on/off A/B")
    ap.add_argument("--out", default=None,
                    help="write the JSON here as well as stdout")
    return ap


def main(argv=None) -> None:
    import os
    import sys

    # Same CPU priority a production scheduler daemon runs at: on a
    # small shared host, background work must not write its own pauses
    # into the stage percentiles.
    try:
        os.setpriority(os.PRIO_PROCESS, 0, -10)
    except (OSError, AttributeError):
        pass
    # Per-event INFO logging (one "cache fill" line per completed
    # task) is measurement noise at 1M tasks — a million formatted
    # stderr writes land straight in the stage percentiles.  The env
    # default must land BEFORE the first get_logger() configures the
    # root logger (utils/logging.py); the setLevel covers the
    # already-configured case.
    import logging

    os.environ.setdefault("YTPU_LOG_LEVEL", "WARNING")
    logging.getLogger().setLevel(logging.WARNING)
    args = build_arg_parser().parse_args(argv)
    from ..device import resolve_device

    resolve_device(args.device)   # no card and no --device cpu: raise now
    # The sim co-hosts the scheduler with its own virtual build clients
    # and fleet threads; in production those are REMOTE processes that
    # never share the scheduler's cores.  The GIL switch interval
    # trades the two measurement artifacts a co-hosted rig can have: a
    # SMALL slice preempts mid-stage (a sub-ms dispatch stage reads as
    # many ms of other threads' time), a LARGE slice delays stage
    # STARTS (queue-wait and grant-call tails grow).  The default (1 ms)
    # favors call latency; latency-focused sharded runs pass
    # --switch-interval 0.005 so a dispatch stage, once entered, usually
    # runs to completion and the dispatch-only percentiles price the
    # scheduler, not its co-tenants.  run_ab's latency pair takes 2 ms.
    sys.setswitchinterval(args.switch_interval)
    if args.device_resident and args.smoke:
        sys.exit(smoke_device(args))
    if args.smoke:
        sys.exit(smoke(args))
    if args.device_resident:
        out = run_device_ab(args)
    elif args.pump_rig:
        out = run_pump_rig_one(args)
    elif args.ab:
        out = run_ab(args)
    else:
        out = run_one(args, shards=args.shards, hotspot=args.hotspot,
                      steal=not args.no_steal, tasks=args.tasks)
    text = json.dumps(out, indent=2)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    print(text)


if __name__ == "__main__":
    main()
