"""Sharded scheduler control plane: N dispatchers + routing + steal, on one
card (the port of yadcc_tpu/scheduler/shard_router.py).

* The servant pool is partitioned into N shards; each shard runs an
  unchanged ``TaskDispatcher`` on its slice, so a shard's lock covers
  S/N servants and lock hold times, snapshot sizes and policy batches
  all shrink by N.
* Servant heartbeats and grant requests are routed shard-ward by the
  weighted consistent hash (``common/consistent_hash.py``, scheduler
  vnode density): a servant's location string owns exactly one shard,
  before and after shard membership churn (``ring_join``/``ring_leave``
  remap only the keys the affected shard owned).
* Grant ids are namespaced by construction — shard k of N issues
  k+1, k+1+N, k+1+2N, … — so a bare grant id routes its renewal/free
  back to the owning shard (``shard_of_grant``) and a stolen grant can
  never be re-issued by another shard.
* Cross-shard work stealing: when a shard's queued-immediate backlog
  outruns its free capacity (``TaskDispatcher.load_signal``), the router
  pulls grants for it from the least-loaded donor shard through a
  bounded steal channel (semaphore-bounded concurrency, per-shard
  ``common/backoff.py`` pacing on dry steals).  A donor is only robbed
  while demonstrably underloaded, which prevents steal ping-pong.
* The cross-shard LOAD view is computed on the router's ``device`` when
  one is given: the concatenated (alive, effective capacity, running)
  pool vectors go up and ``parallel/mesh.py:shard_load_summary`` reduces
  them per shard, refreshed from the expiration sweep, surfaced in
  ``inspect()``.  (The JAX router takes a device mesh here; on one card
  every shard slice lives on that card.)
* The fused cycle (``enable_fused_dispatch``/``run_fused_cycle``) keeps
  the concatenated pool resident on the card and runs every shard's
  resident step in ONE launch of K1 over a grid of shards.

``inspect()`` aggregates across shards — counters sum, the admission
rung is the max over shards, stage percentiles pool every shard's
samples — with the per-shard detail under ``per_shard``.

Warm-standby adoption (``adopt_grants``, ``set_adoption_window``) routes
each journaled grant to its owning shard by id and opens every shard's
window.  The parked wait (``submit_wait_for_starting_new_task_routed``,
the aio front end's path) runs the same steal-first plan with every wait
a continuation: donor ops chain through ``_try_steal_async`` and the home
remainder parks on the home dispatcher's pending queue.
"""

from __future__ import annotations

import itertools
import threading
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..common.backoff import Backoff
from ..common.consistent_hash import (SCHEDULER_VNODES_PER_WEIGHT,
                                      ConsistentHash)
from ..models.cost import DEFAULT_COST_MODEL
from ..ops import assignment_grouped as asg
from ..ops.assignment import NO_PICK, PoolArrays
from ..parallel import mesh
from ..utils.clock import REAL_CLOCK, Clock
from ..utils.logging import get_logger
from ..utils.stagetimer import StageTimer
from .admission import RUNG_NAMES, AdmissionDecision
from .task_dispatcher import (TAKEOVER_GAP_SLACK, DispatcherFailed,
                              LoadSignal, ServantInfo, TaskDispatcher)

logger = get_logger("scheduler.shard_router")


@dataclass
class StealConfig:
    """Cross-shard steal tuning."""

    enabled: bool = True
    # A donor must sit below this utilization (and have free capacity,
    # and an EMPTY immediate queue — the real "the donor needs it
    # itself" signal, and what structurally prevents ping-pong: a shard
    # with queued demand is never robbed).
    donor_max_util: float = 1.0
    # Most grants one steal op may pull.
    max_batch: int = 64
    # Concurrent steal ops across the whole router (the bounded steal
    # channel): excess demand falls back to the home shard's queue.
    channel_bound: int = 4
    # Donor-side wait bound per steal op.
    donor_timeout_s: float = 0.05
    # Pacing for DRY steals (nothing stolen): per-home-shard backoff so
    # a starved fleet does not hammer its neighbours' locks.
    dry_backoff_initial_s: float = 0.005
    dry_backoff_max_s: float = 0.25
    # Load-signal cache refresh period (donor ranking reads the cache;
    # the router must not take N dispatcher locks per request).
    load_refresh_s: float = 0.02
    # Minimum period between device load-summary refreshes
    # (observability; the gather touches every shard's lock).
    summary_refresh_s: float = 10.0


@dataclass
class RoutedGrant:
    """One grant plus its provenance on the sharded plane."""

    grant_id: int
    servant_location: str
    shard_id: int          # shard whose dispatcher issued (owns) it
    stolen: bool           # True when shard_id != the serving shard
    # Federation provenance (scheduler/federation.py): the cell whose
    # dispatcher issued the grant, and whether it was spilled there
    # from an overloaded home cell.  Single-cell planes leave the
    # defaults — cell 0, nothing spilled.
    cell_id: int = 0
    spilled: bool = False


@dataclass
class RoutedGrants:
    """wait_for_starting_new_task_routed result."""

    shard_id: int                  # home (serving) shard
    grants: List[RoutedGrant] = field(default_factory=list)
    cell_id: int = 0               # home (serving) cell

    def pairs(self) -> List[Tuple[int, str]]:
        return [(g.grant_id, g.servant_location) for g in self.grants]

    @property
    def stolen_count(self) -> int:
        return sum(1 for g in self.grants if g.stolen)

    @property
    def spilled_count(self) -> int:
        return sum(1 for g in self.grants if g.spilled)


class ShardRouter:
    """N TaskDispatchers behind the single-dispatcher surface
    SchedulerService consumes.

    The router's own lock is a LEAF guarding counters and caches; it is
    never held across a shard dispatcher call, so it can never nest
    with (or deadlock against) any dispatcher's lock."""

    def __init__(
        self,
        shards: Sequence[TaskDispatcher],
        *,
        clock: Clock = REAL_CLOCK,
        steal: Optional[StealConfig] = None,
        device=None,
        vnodes_per_weight: int = SCHEDULER_VNODES_PER_WEIGHT,
    ):
        if not shards:
            raise ValueError("need at least one shard")
        n = len(shards)
        for k, d in enumerate(shards):
            # Any positive multiple of N as the stride preserves the
            # routing invariant shard_of_grant relies on: ids ≡ k+1
            # (mod N).
            if (d._grant_id_stride % n != 0
                    or d._next_grant_id % n != (k + 1) % n):
                raise ValueError(
                    f"shard {k} must be built with grant_id_start ≡ "
                    f"{k + 1} (mod {n}) and a stride that is a multiple "
                    f"of {n} (use ShardRouter.build)")
        self._shards = list(shards)
        self._clock = clock
        self._cfg = steal or StealConfig()
        self._ring = ConsistentHash(
            [(self._ring_name(k), 1) for k in range(n)],
            vnodes_per_weight=vnodes_per_weight)

        self._lock = threading.Lock()
        self._rr = itertools.count()  # guarded by: self._lock
        self._stats = {
            "steals_attempted": 0,
            "stolen_grants": 0,
            "steal_dry": 0,
            "steal_paced": 0,
            "steal_channel_full": 0,
            "steal_no_donor": 0,
        }  # guarded by: self._lock
        self._loads: Optional[List] = None  # guarded by: self._lock
        self._loads_at = -1.0  # guarded by: self._lock
        # now-timestamp before which shard k must not attempt another
        # steal (set on dry steals from its Backoff schedule).
        self._steal_next_ok = [0.0] * n  # guarded by: self._lock
        self._steal_backoffs = [
            Backoff(initial_s=self._cfg.dry_backoff_initial_s,
                    max_s=self._cfg.dry_backoff_max_s,
                    sleep=lambda _s: None)
            for _ in range(n)
        ]  # guarded by: self._lock
        # The bounded steal channel.
        self._steal_sem = threading.BoundedSemaphore(
            self._cfg.channel_bound)

        # Device load summary: one reduction over the concatenated pool
        # on ``device``, refreshed from the expiration sweep; read by
        # inspect().  None: no device view (the host load cache only).
        self._device = None if device is None else torch.device(device)
        self._summary_rows: Optional[np.ndarray] = None  # guarded by: self._lock
        self._summary_at = -1.0  # guarded by: self._lock
        self._fused: Optional[dict] = None

    # -- construction -------------------------------------------------------

    @classmethod
    def build(cls, policy_factory, n_shards: int, *,
              max_servants_per_shard: int = 8192,
              clock: Clock = REAL_CLOCK,
              steal: Optional[StealConfig] = None,
              device=None,
              grant_namespace: Tuple[int, int] = (0, 1),
              **dispatcher_kwargs) -> "ShardRouter":
        """Construct the N shard dispatchers with the grant-id
        namespacing the router requires.  ``policy_factory(k)`` builds
        shard k's DispatchPolicy (each shard owns its policy instance —
        device kernels must not be shared across dispatch threads).

        ``grant_namespace=(cell_index, n_cells)`` places the whole
        router inside a two-level id namespace: cell c's shard k issues
        ids ≡ c*N + k + 1 (mod C*N).  Because c*N + k + 1 ≡ k + 1
        (mod N), within-cell routing is untouched, while ids stay
        disjoint ACROSS cells.  The default (0, 1) is the single-cell
        plane."""
        cell, n_cells = grant_namespace
        if not (0 <= cell < n_cells):
            raise ValueError(
                f"grant_namespace cell {cell} outside [0, {n_cells})")
        shards = [
            TaskDispatcher(
                policy_factory(k),
                max_servants=max_servants_per_shard,
                clock=clock,
                grant_id_start=cell * n_shards + k + 1,
                grant_id_stride=n_cells * n_shards,
                **dispatcher_kwargs,
            )
            for k in range(n_shards)
        ]
        return cls(shards, clock=clock, steal=steal, device=device)

    # -- routing ------------------------------------------------------------

    @staticmethod
    def _ring_name(k: int) -> str:
        return f"shard{k}"

    @property
    def n_shards(self) -> int:
        return len(self._shards)

    @property
    def shards(self) -> Tuple[TaskDispatcher, ...]:
        return tuple(self._shards)

    def shard_for_location(self, location: str) -> int:
        """Owning shard for a servant id — THE routing function: every
        servant id maps to exactly one shard, before and after shard
        membership churn."""
        return int(self._ring.pick(location)[len("shard"):])

    def resolve_home(self, requestor: str, env_digest: str = "") -> int:
        """Home shard for a grant request: the requestor's consistent-
        hash shard (delegates are pinned, so their keep-alive/free
        traffic and their grants co-locate).  Anonymous callers WITH an
        ``env_digest`` pin to the digest's ring shard instead.  Only
        when BOTH are empty does round-robin apply, and it draws a FRESH
        shard per call: a caller pairing an admission ruling with a
        grant request must resolve once and pass the shard to both (the
        ``home`` kwarg)."""
        if requestor:
            return self.shard_for_location(requestor)
        if env_digest:
            return int(self._ring.pick("env:" + env_digest)[
                len("shard"):])
        with self._lock:
            return next(self._rr) % len(self._shards)

    def shard_of_grant(self, grant_id: int) -> int:
        """Owning shard from the id alone (the namespacing invariant:
        shard k issues ids ≡ k+1 mod N)."""
        return (int(grant_id) - 1) % len(self._shards)

    def ring_join(self, shard_id: int, weight: int = 1) -> None:
        """(Re-)enter a shard into the routing ring.  Only the keys the
        new vnodes own move."""
        self._ring.add_node(self._ring_name(shard_id), weight)

    def ring_leave(self, shard_id: int) -> None:
        """Drain routing away from a shard (decommission): its servants
        remap to surviving shards on their next heartbeat; its standing
        registrations age out by lease.  Grant-id routing is untouched
        — outstanding grants stay renewable on the owning dispatcher
        until freed."""
        if len(self._ring) <= 1:
            raise ValueError("cannot drain the last shard")
        self._ring.remove_node(self._ring_name(shard_id))

    # -- TaskDispatcher surface (SchedulerService) --------------------------

    @property
    def failure(self) -> Optional[BaseException]:
        """The first shard's policy failure (None: every shard healthy).
        A failed shard stops as a lone dispatcher does; the entry stops
        serving on it."""
        return next((d.failure for d in self._shards
                     if d.failure is not None), None)

    def keep_servant_alive(self, info: ServantInfo,
                           expires_in_s: float) -> bool:
        return self._shards[self.shard_for_location(info.location)] \
            .keep_servant_alive(info, expires_in_s)

    def notify_servant_running_tasks(
            self, location: str, reported_grant_ids: Sequence[int]
    ) -> List[int]:
        """Reconcile per GRANT, not per servant: each reported grant is
        judged by its OWNING dispatcher (``shard_of_grant``), the only
        registry that can know it.  The servant's current ring shard is
        always consulted too (with its subset, possibly empty) so
        zombie release keeps happening where the servant is
        registered."""
        by_shard: Dict[int, List[int]] = defaultdict(list)
        for gid in reported_grant_ids:
            by_shard[self.shard_of_grant(gid)].append(gid)
        by_shard.setdefault(self.shard_for_location(location), [])
        kill: List[int] = []
        for s, ids in by_shard.items():
            kill.extend(
                self._shards[s].notify_servant_running_tasks(location, ids))
        return kill

    def admission_check(self, immediate: int = 1, prefetch: int = 0,
                        requestor: str = "",
                        tenant: str = "", tier: str = "",
                        home: Optional[int] = None) -> AdmissionDecision:
        """Rule on the HOME shard's ladder — the shard this requestor's
        grants queue on.  Shards shed independently.  Pass ``home``
        (from ``resolve_home``) when the same request will also take
        the grant path.  Tenant budget/tier shaping rules on the home
        shard's ledger, the same one the grant path will charge."""
        if home is None:
            home = self.resolve_home(requestor)
        return self._shards[home].admission_check(
            immediate, prefetch, tenant=tenant, tier=tier)

    def admission_rung(self) -> int:
        """Max rung over shards — the replication journal and the
        federation spillover check treat the hottest shard as the
        cell's degradation level (same convention as inspect())."""
        return max(d.admission_rung() for d in self._shards)

    def restore_admission_rung(self, rung: int) -> None:
        """Warm-standby takeover: restart every shard's ladder at the
        journaled rung (the journal records the max; restoring it on
        all shards errs toward shedding for one update interval)."""
        for d in self._shards:
            d.restore_admission_rung(rung)

    def load_signal(self) -> LoadSignal:
        """Aggregate pool load across shards — the federation router's
        peer-ranking signal (least-loaded cell for spillover)."""
        sigs = [d.load_signal() for d in self._shards]
        cap = sum(s.capacity for s in sigs)
        outstanding = sum(s.outstanding for s in sigs)
        queued = sum(s.queued_immediate for s in sigs)
        return LoadSignal(
            capacity=cap,
            outstanding=outstanding,
            queued_immediate=queued,
            utilization=((outstanding + queued) / cap) if cap > 0 else 0.0,
            free=sum(s.free for s in sigs),
        )

    def wait_for_starting_new_task(self, env_digest: str, *,
                                   min_version: int = 0,
                                   requestor: str = "",
                                   immediate: int = 1,
                                   prefetch: int = 0,
                                   lease_s: float = 15.0,
                                   timeout_s: float = 5.0,
                                   tenant: str = "",
                                   ) -> List[Tuple[int, str]]:
        return self.wait_for_starting_new_task_routed(
            env_digest, min_version=min_version, requestor=requestor,
            immediate=immediate, prefetch=prefetch, lease_s=lease_s,
            timeout_s=timeout_s, tenant=tenant).pairs()

    def wait_for_starting_new_task_routed(self, env_digest: str, *,
                                          min_version: int = 0,
                                          requestor: str = "",
                                          immediate: int = 1,
                                          prefetch: int = 0,
                                          lease_s: float = 15.0,
                                          timeout_s: float = 5.0,
                                          home: Optional[int] = None,
                                          tenant: str = "",
                                          ) -> RoutedGrants:
        """The sharded grant path: steal first when the home shard is
        demonstrably outrun, then the blocking allocation on the home
        shard for the remainder (which also services the prefetch —
        prefetch is never stolen, only home-queued).  ``home`` pins the
        shard ``resolve_home`` already picked for this request's
        admission ruling."""
        if home is None:
            home = self.resolve_home(requestor)
        d = self._shards[home]
        out = RoutedGrants(shard_id=home)
        need = max(0, immediate)
        t0 = self._clock.now()
        if self._cfg.enabled and need > 0 and len(self._shards) > 1:
            sig = d.load_signal()
            if sig.queued_immediate + need > sig.free:
                # Pull from donors until the demand fits or they run
                # dry; each op targets the CURRENT least-loaded donor.
                # Bounded: at most one op per shard per request.
                for _ in range(len(self._shards) - 1):
                    if need <= 0:
                        break
                    got = self._try_steal(
                        home, env_digest, min_version, requestor,
                        min(need, self._cfg.max_batch), lease_s,
                        tenant=tenant)
                    if not got:
                        break
                    for gid, loc, donor in got:
                        out.grants.append(
                            RoutedGrant(gid, loc, donor, True))
                        need -= 1
        if need > 0 or prefetch > 0:
            # need == 0 with prefetch > 0 (stealing covered all the
            # immediate demand): still call home with immediate=0 so
            # the allowed prefetch is allocated.
            remaining = max(0.0, timeout_s - (self._clock.now() - t0))
            for gid, loc in d.wait_for_starting_new_task(
                    env_digest, min_version=min_version,
                    requestor=requestor, immediate=need,
                    prefetch=prefetch, lease_s=lease_s,
                    timeout_s=remaining, tenant=tenant):
                out.grants.append(RoutedGrant(gid, loc, home, False))
        return out

    def submit_wait_for_starting_new_task(
            self, env_digest: str, *,
            min_version: int = 0,
            requestor: str = "",
            immediate: int = 1,
            prefetch: int = 0,
            lease_s: float = 15.0,
            timeout_s: float = 5.0,
            tenant: str = "",
            on_done) -> None:
        """Continuation twin of :meth:`wait_for_starting_new_task`:
        fires ``on_done([(grant_id, location)])`` exactly once.  Its
        presence is what enables the service's parked registration on
        the sharded plane."""
        self.submit_wait_for_starting_new_task_routed(
            env_digest, min_version=min_version, requestor=requestor,
            immediate=immediate, prefetch=prefetch, lease_s=lease_s,
            timeout_s=timeout_s, tenant=tenant,
            on_done=lambda routed: on_done(routed.pairs()))

    def submit_wait_for_starting_new_task_routed(
            self, env_digest: str, *,
            min_version: int = 0,
            requestor: str = "",
            immediate: int = 1,
            prefetch: int = 0,
            lease_s: float = 15.0,
            timeout_s: float = 5.0,
            home: Optional[int] = None,
            tenant: str = "",
            on_done) -> None:
        """Continuation twin of :meth:`wait_for_starting_new_task_routed`:
        the same steal-first plan, but every wait is a parked
        continuation — donor ops chain through :meth:`_try_steal_async`
        (no thread blocks on a donor) and the home remainder parks on
        the home dispatcher's pending queue.  Steal predicate, op bound
        (one per shard per request), batch clamp, pacing, channel bound
        and backoff are the blocking path's.  Exactly one
        ``on_done(RoutedGrants)`` fires; a failed shard ends the chain
        with what it has, and the caller reads ``failure``."""
        if home is None:
            home = self.resolve_home(requestor)
        d = self._shards[home]
        out = RoutedGrants(shard_id=home)
        state = {"need": max(0, immediate), "ops": 0}
        t0 = self._clock.now()

        def on_home(pairs) -> None:
            for gid, loc in pairs:
                out.grants.append(RoutedGrant(gid, loc, home, False))
            on_done(out)

        def finish() -> None:
            # The blocking path's remainder rule — prefetch is never
            # stolen, only home-queued.  This always goes through the
            # home submit: with no immediate demand left and no
            # prefetch, the dispatcher's empty-demand fast path answers
            # [] inline, the same outcome with one reply shape.
            remaining = max(0.0, timeout_s - (self._clock.now() - t0))
            try:
                d.submit_wait_for_starting_new_task(
                    env_digest, min_version=min_version,
                    requestor=requestor, immediate=state["need"],
                    prefetch=prefetch, lease_s=lease_s,
                    timeout_s=remaining, tenant=tenant, on_done=on_home)
            except DispatcherFailed:
                on_home([])

        steal = False
        if self._cfg.enabled and state["need"] > 0 \
                and len(self._shards) > 1:
            sig = d.load_signal()
            steal = sig.queued_immediate + state["need"] > sig.free
        if not steal:
            finish()
            return
        max_ops = len(self._shards) - 1

        def next_op() -> None:
            if state["need"] <= 0 or state["ops"] >= max_ops:
                finish()
                return
            state["ops"] += 1
            self._try_steal_async(
                home, env_digest, min_version, requestor,
                min(state["need"], self._cfg.max_batch), lease_s,
                tenant, on_got=on_got)

        def on_got(got) -> None:
            # A dry/paced/full op ends the steal phase, as the blocking
            # loop's `if not got: break` does.  Chain depth is bounded
            # by max_ops even when donors answer inline.
            if not got:
                finish()
                return
            for gid, loc, donor in got:
                out.grants.append(RoutedGrant(gid, loc, donor, True))
                state["need"] -= 1
            next_op()

        next_op()

    def adopt_grants(self, location: str,
                     grants: Sequence[Tuple[int, str, str]],
                     lease_s: float = 15.0) -> int:
        """Warm-standby replay (scheduler/replication.py): route each
        journaled grant to its owning shard by id."""
        by_shard: Dict[int, List[Tuple[int, str, str]]] = defaultdict(list)
        for item in grants:
            by_shard[self.shard_of_grant(item[0])].append(item)
        return sum(self._shards[s].adopt_grants(location, items, lease_s)
                   for s, items in by_shard.items())

    def set_adoption_window(self, floor_grant_id: int,
                            grace_s: float, *,
                            gap_slack: int = TAKEOVER_GAP_SLACK) -> None:
        """Open every shard's takeover grace window: any of them may be
        the owner of a journal-gap grant a servant reports."""
        for d in self._shards:
            d.set_adoption_window(floor_grant_id, grace_s,
                                  gap_slack=gap_slack)

    def keep_task_alive(self, grant_ids: Sequence[int],
                        next_keep_alive_s: float) -> List[bool]:
        out = [False] * len(grant_ids)
        by_shard: Dict[int, List[Tuple[int, int]]] = defaultdict(list)
        for i, gid in enumerate(grant_ids):
            by_shard[self.shard_of_grant(gid)].append((i, gid))
        for s, items in by_shard.items():
            res = self._shards[s].keep_task_alive(
                [gid for _, gid in items], next_keep_alive_s)
            for (i, _), ok in zip(items, res):
                out[i] = ok
        return out

    def free_task(self, grant_ids: Sequence[int]) -> None:
        by_shard: Dict[int, List[int]] = defaultdict(list)
        for gid in grant_ids:
            by_shard[self.shard_of_grant(gid)].append(gid)
        for s, ids in by_shard.items():
            self._shards[s].free_task(ids)

    def on_expiration_timer(self) -> None:
        for d in self._shards:
            d.on_expiration_timer()
        if self._device is None:
            return
        now = self._clock.now()
        with self._lock:
            due = (self._summary_at < 0
                   or now - self._summary_at >= self._cfg.summary_refresh_s)
            if due:
                self._summary_at = now
        if due:
            self.refresh_load_summary()

    def run_dispatch_cycle_for_testing(self) -> int:
        return sum(d.run_dispatch_cycle_for_testing()
                   for d in self._shards)

    def stop(self) -> None:
        for d in self._shards:
            d.stop()

    # -- stealing -----------------------------------------------------------

    def _shard_loads(self, now: float) -> List:
        with self._lock:
            if (self._loads is not None
                    and now - self._loads_at < self._cfg.load_refresh_s
                    and self._loads_at <= now):
                return self._loads
        # Outside the router lock: load_signal takes each dispatcher's
        # lock (leaf discipline — never nested under ours).  Concurrent
        # refreshes are benign; last writer wins.
        loads = [d.load_signal() for d in self._shards]
        with self._lock:
            self._loads = loads
            self._loads_at = now
        return loads

    def _pick_donor(self, home: int,
                    now: float) -> Tuple[Optional[int], int]:
        """Least-loaded eligible donor: underloaded, idle queue, free
        capacity; ties broken toward the most free capacity.  Returns
        (donor, free) so the steal op can clamp to what is actually
        there instead of parking on a drained donor."""
        cfg = self._cfg
        loads = self._shard_loads(now)
        best, best_free = None, 0
        for k, sig in enumerate(loads):
            if k == home or sig.free <= 0 or sig.queued_immediate > 0:
                continue
            if sig.utilization >= cfg.donor_max_util:
                continue
            if sig.free > best_free:
                best, best_free = k, sig.free
        return best, best_free

    def _try_steal(self, home: int, env_digest: str, min_version: int,
                   requestor: str, want: int, lease_s: float,
                   tenant: str = "",
                   ) -> List[Tuple[int, str, int]]:
        """One bounded steal op on behalf of shard `home`; returns
        [(grant_id, servant_location, donor_shard)].  The grants are
        issued by the DONOR's dispatcher through its normal path, so
        they live in exactly one registry and renew/free by id."""
        cfg = self._cfg
        now = self._clock.now()
        with self._lock:
            if now < self._steal_next_ok[home]:
                self._stats["steal_paced"] += 1
                return []
        if not self._steal_sem.acquire(blocking=False):
            with self._lock:
                self._stats["steal_channel_full"] += 1
            return []
        try:
            donor, donor_free = self._pick_donor(home, now)
            if donor is None:
                with self._lock:
                    self._stats["steal_no_donor"] += 1
                self._note_dry(home, now)
                return []
            with self._lock:
                self._stats["steals_attempted"] += 1
            got = self._shards[donor].wait_for_starting_new_task(
                env_digest, min_version=min_version, requestor=requestor,
                immediate=min(want, donor_free), prefetch=0,
                lease_s=lease_s, timeout_s=cfg.donor_timeout_s,
                tenant=tenant)
            if got:
                with self._lock:
                    self._stats["stolen_grants"] += len(got)
                    self._steal_backoffs[home].reset()
                    self._steal_next_ok[home] = 0.0
                    # The donor's free capacity just moved; make the
                    # next donor pick see it.
                    self._loads_at = -1.0
            else:
                with self._lock:
                    self._stats["steal_dry"] += 1
                self._note_dry(home, now)
            return [(gid, loc, donor) for gid, loc in got]
        finally:
            self._steal_sem.release()

    def _try_steal_async(self, home: int, env_digest: str,
                         min_version: int, requestor: str, want: int,
                         lease_s: float, tenant: str = "",
                         *, on_got) -> None:
        """Continuation twin of :meth:`_try_steal`: the same pacing,
        channel bound, donor pick and stats, but the donor wait parks
        on the donor dispatcher's pending queue instead of blocking this
        thread for up to ``donor_timeout_s``.  The channel semaphore is
        released by the donor continuation (the op outlives this frame).
        Fires ``on_got([(grant_id, location, donor_shard)])`` exactly
        once; empty on pacing/full/no-donor, as the blocking path."""
        cfg = self._cfg
        now = self._clock.now()
        with self._lock:
            paced = now < self._steal_next_ok[home]
            if paced:
                self._stats["steal_paced"] += 1
        if paced:
            on_got([])
            return
        if not self._steal_sem.acquire(blocking=False):
            with self._lock:
                self._stats["steal_channel_full"] += 1
            on_got([])
            return
        try:
            donor, donor_free = self._pick_donor(home, now)
        except Exception:
            self._steal_sem.release()
            raise
        if donor is None:
            with self._lock:
                self._stats["steal_no_donor"] += 1
            self._note_dry(home, now)
            self._steal_sem.release()
            on_got([])
            return
        with self._lock:
            self._stats["steals_attempted"] += 1

        def on_donor(pairs) -> None:
            # Donor continuation (the donor's dispatch thread, or inline
            # when its leader satisfied us).  Settle the stats and the
            # channel slot first, then hand up.
            try:
                if pairs:
                    with self._lock:
                        self._stats["stolen_grants"] += len(pairs)
                        self._steal_backoffs[home].reset()
                        self._steal_next_ok[home] = 0.0
                        # The donor's free capacity just moved; make
                        # the next donor pick see it.
                        self._loads_at = -1.0
                else:
                    with self._lock:
                        self._stats["steal_dry"] += 1
                    self._note_dry(home, self._clock.now())
            finally:
                self._steal_sem.release()
            on_got([(gid, loc, donor) for gid, loc in pairs])

        try:
            self._shards[donor].submit_wait_for_starting_new_task(
                env_digest, min_version=min_version, requestor=requestor,
                immediate=min(want, donor_free), prefetch=0,
                lease_s=lease_s, timeout_s=cfg.donor_timeout_s,
                tenant=tenant, on_done=on_donor)
        except DispatcherFailed:
            on_donor([])

    def _note_dry(self, home: int, now: float) -> None:
        with self._lock:
            delay = self._steal_backoffs[home].next_delay()
            self._steal_next_ok[home] = now + delay

    # -- device load view ---------------------------------------------------

    def refresh_load_summary(self) -> np.ndarray:
        """Gather each shard's (alive, capacity, running) slice, pad to
        the common slice width, reduce per shard on the router's device
        (parallel/mesh.py:shard_load_summary); returns and keeps the
        [n_shards, 3] (alive, free, running) rows."""
        dev = self._device
        if dev is None:
            raise RuntimeError("the router has no device for its load "
                               "summary (ShardRouter(device=...))")
        slices = [d.pool_load_arrays() for d in self._shards]
        per = max(a.shape[0] for a, _, _ in slices)

        def cat(i):
            return torch.from_numpy(np.concatenate([
                np.pad(s[i], (0, per - s[i].shape[0])) for s in slices
            ])).to(dev)

        rows = mesh.shard_load_summary(cat(0), cat(1), cat(2),
                                       len(self._shards)).cpu().numpy()
        with self._lock:
            self._summary_rows = rows
        return rows

    def load_summary(self) -> Optional[np.ndarray]:
        """Latest device-computed [n_shards, 3] (alive, free, running)
        rows, or None before the first refresh / without a device."""
        with self._lock:
            return None if self._summary_rows is None \
                else self._summary_rows.copy()

    # -- fused device-resident dispatch -------------------------------------
    #
    # The per-shard control plane runs N policy calls per sweep: N
    # Python dispatches, N upload sets, N picks downloads.  The fused
    # path keeps the CONCATENATED pool (N*per slots) resident on the
    # card, and each cycle is ONE step (parallel/mesh.py:
    # resident_control_plane_step) in which every shard's dirty-slot
    # delta is scattered, its running corrections folded, and its
    # grouped assignment run — one launch of K1 over a grid of N
    # blocks, no cross-shard traffic, because shards are independent
    # pools.  Per-shard picks route back through each shard's UNMODIFIED
    # grant bookkeeping (apply_stream_picks — the same validation path
    # the in-process pipelined loop uses).

    def enable_fused_dispatch(self, *, oracle_interval: int = 64,
                              cost_model=None) -> None:
        """Seed the device-resident concatenated pool and arm every
        shard's stream delta machinery.  Requires shards built with
        start_dispatch_thread=False (the fused cycle alone drives their
        streams) and equal pool widths.  The pool lives on the router's
        ``device``: the card unless the router was given the CPU."""
        from ..device import resolve_device

        dev = self._device if self._device is not None \
            else resolve_device("cuda")
        widths = {d.max_servants for d in self._shards}
        if len(widths) != 1:
            raise ValueError(
                f"fused dispatch needs equal shard pool widths, got "
                f"{sorted(widths)}")
        snaps = [d.begin_external_stream() for d in self._shards]

        def cat(name, dtype):
            a = np.concatenate([getattr(s, name) for s in snaps])
            return torch.from_numpy(
                np.ascontiguousarray(a.astype(dtype, copy=False))).to(dev)

        pool = PoolArrays(
            alive=cat("alive", np.bool_),
            capacity=cat("capacity", np.int32),
            running=cat("running", np.int32),
            dedicated=cat("dedicated", np.bool_),
            version=cat("version", np.int32),
            env_bitmap=torch.from_numpy(np.ascontiguousarray(
                np.concatenate([s.env_bitmap for s in snaps]),
                np.uint32).view(np.int32)).to(dev),
        )
        if cost_model is None:
            cost_model = getattr(self._shards[0]._policy, "_cm",
                                 DEFAULT_COST_MODEL)
        self._fused = {
            "device": dev, "pool": pool, "per": widths.pop(),
            "cm": cost_model, "cycles": 0,
            "oracle_interval": max(1, oracle_interval),
            "stats": {"fused_cycles": 0, "fused_shard_launches": 0,
                      "oracle_checks": 0, "oracle_mismatches": 0},
            # Host clock around a launching cycle's three parts: every
            # shard's launch preparation, the one step (host arrays,
            # uploads, the launch, the picks' download), every shard's
            # apply (with the oracle on its cycles).
            "timer": StageTimer(("prepare", "step", "apply"),
                                maxlen=16384),
        }

    def run_fused_cycle(self) -> int:
        """One fused control-plane cycle: prepare every shard's launch,
        run ONE step for all shards, apply each shard's picks through
        its own grant bookkeeping.  Returns grants issued.  Synchronous
        by design — the point is one launch for N shards, and the
        per-shard apply happens as soon as the single picks array
        lands."""
        fused = self._fused
        if fused is None:
            raise RuntimeError("call enable_fused_dispatch() first")
        n, per, dev = len(self._shards), fused["per"], fused["device"]
        clock = self._clock
        t0 = clock.now()
        launches = [d.prepare_stream_launch() for d in self._shards]
        if all(l is None for l in launches):
            return 0
        t1 = clock.now()
        try:
            # Common pad geometry: every shard rides the same launch, so
            # shapes unify to the cycle's maxima.
            g_pad = max(asg.group_pad(len(l[1]) if l else 0)
                        for l in launches)
            t_max = max(asg.task_pad(len(l[0]) if l else 0)
                        for l in launches)
            d_pad = max(asg.delta_pad(len(l[7]) if l else 0)
                        for l in launches)
            e_words = self._shards[0]._env_words
            packed = np.zeros((n, 4, g_pad), np.int32)
            adj = np.zeros(n * per, np.int32)
            rmask = np.zeros(n * per, bool)
            rval = np.zeros(n * per, np.int32)
            # Shard-local slot numbers; idx == per marks padding.
            idx = np.full((n, d_pad), per, np.int32)
            rows = {f: np.zeros((n, d_pad), np.int32) for f in
                    ("alive", "capacity", "dedicated", "version")}
            env = np.zeros((n, d_pad, e_words), np.uint32)
            for k, l in enumerate(launches):
                if l is None:
                    continue
                work, descr, snap, gen, adjk, resets, lid, dirty = l
                packed[k] = asg.make_grouped_packed_host(descr,
                                                         pad_to=g_pad)
                adj[k * per:(k + 1) * per] = adjk
                for slot, val in resets.items():
                    rmask[k * per + slot] = True
                    rval[k * per + slot] = val
                nd = len(dirty)
                if nd:
                    di = np.asarray(dirty, np.int64)
                    if np.unique(di).size != nd:
                        raise ValueError(
                            "a delta sends each dirty slot at most once")
                    idx[k, :nd] = di
                    for f, a in rows.items():
                        a[k, :nd] = getattr(snap, f)[di]
                    env[k, :nd] = snap.env_bitmap[di]

            def up(a):
                return torch.from_numpy(a).to(dev)

            delta = asg.PoolDelta(
                idx=up(idx), alive=up(rows["alive"]),
                capacity=up(rows["capacity"]),
                dedicated=up(rows["dedicated"]),
                version=up(rows["version"]),
                env_rows=up(env.view(np.int32)))
            on_device = self._fused_expand_on_device()
            out_dev, fused["pool"] = mesh.resident_control_plane_step(
                fused["pool"], delta, up(packed), up(adj), up(rmask),
                up(rval), t_max, fused["cm"], return_picks=on_device)
            # The one device-to-host copy of the cycle: collecting the
            # fused picks IS the apply boundary.
            out = out_dev.cpu().numpy()
            if on_device:
                picks = [None if l is None else out[k, :len(l[0])]
                         for k, l in enumerate(launches)]
            else:
                # Host expansion from the [n, G, per] counts: within a
                # run every entry is the identical request, so
                # slot-order repeat preserves the per-run pick multiset
                # the apply validates.
                picks = []
                for k, l in enumerate(launches):
                    if l is None:
                        picks.append(None)
                        continue
                    row = np.full(len(l[0]), NO_PICK, np.int32)
                    off = 0
                    for gi, (_, _, _, cnt) in enumerate(l[1]):
                        cs = out[k, gi]
                        nz = np.nonzero(cs)[0]
                        exp = np.repeat(nz, cs[nz])
                        row[off:off + len(exp)] = exp
                        off += cnt
                    picks.append(row)
        except Exception:
            for d, l in zip(self._shards, launches):
                if l is not None:
                    d.release_stream_launch(l)
            raise
        t2 = clock.now()
        fused["cycles"] += 1
        fused["stats"]["fused_cycles"] += 1
        if fused["cycles"] % fused["oracle_interval"] == 0:
            self._fused_oracle(launches)
        # Last-cycle detail for the parity checks: the picks rows are
        # copies, but the launch tuples reference leased snapshot
        # buffers — consumers must copy anything they keep before the
        # NEXT prepare recycles them.
        fused["last_cycle"] = [
            {"shard": k, "picks": picks[k].copy(), "launch": l}
            for k, l in enumerate(launches) if l is not None]
        issued = 0
        for k, (d, l) in enumerate(zip(self._shards, launches)):
            if l is None:
                continue
            work, descr, snap, gen, adjk, resets, lid, dirty = l
            fused["stats"]["fused_shard_launches"] += 1
            issued += d.apply_stream_picks(picks[k], work,
                                           gen, lid, snap=snap)
        timer = fused["timer"]
        timer.record("prepare", t1 - t0)
        timer.record("step", t2 - t1)
        timer.record("apply", clock.now() - t2)
        return issued

    def _fused_expand_on_device(self) -> bool:
        """Device vs host picks expansion for the fused step — the
        grouped policy's _decide_expand at router scope: on the card the
        expansion keeps the download at O(T) picks; on the CPU the
        counts matrix and one np.repeat win."""
        return self._fused["device"].type != "cpu"

    def _fused_oracle(self, launches) -> None:
        """Periodic equivalence oracle over the resident statics: each
        shard that launched this cycle compares its device slice
        against the host snapshot the delta was gathered from (so they
        must match bit-for-bit).  Mismatch -> log, count, repair the
        slice in place.  `running` stays out — it legitimately carries
        this cycle's not-yet-applied device grants."""
        fused = self._fused
        per = fused["per"]
        pool = fused["pool"]
        fields = ("alive", "capacity", "dedicated", "version")
        # One download per field, oracle cadence only — the oracle is
        # the explicit periodic sync point.
        host = {f: getattr(pool, f).cpu().numpy() for f in fields}
        host["env_bitmap"] = pool.env_bitmap.cpu().numpy().view(np.uint32)
        for k, l in enumerate(launches):
            if l is None:
                continue
            snap = l[2]
            sl = slice(k * per, (k + 1) * per)
            fused["stats"]["oracle_checks"] += 1
            if all(np.array_equal(host[f][sl], getattr(snap, f))
                   for f in fields + ("env_bitmap",)):
                continue
            fused["stats"]["oracle_mismatches"] += 1
            logger.error("fused resident statics diverged on shard %d; "
                         "re-syncing its slice", k)
            for f in fields:
                getattr(pool, f)[sl] = torch.from_numpy(np.ascontiguousarray(
                    getattr(snap, f), host[f].dtype)).to(fused["device"])
            pool.env_bitmap[sl] = torch.from_numpy(np.ascontiguousarray(
                snap.env_bitmap, np.uint32).view(np.int32)).to(
                    fused["device"])

    def fused_stats(self) -> Optional[Dict[str, int]]:
        return dict(self._fused["stats"]) if self._fused else None

    # -- observability ------------------------------------------------------

    def steal_stats(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._stats)

    def inspect(self) -> dict:
        """Aggregate view: counters SUM across shards, the admission
        rung is the MAX over shards (the fleet is as degraded as its
        most degraded shard), stage percentiles pool every shard's
        retained samples.  Per-shard detail rides under ``per_shard``."""
        per_shard = [d.inspect() for d in self._shards]
        stats: Dict[str, int] = {}
        adm_stats: Dict[str, int] = {}
        for ins in per_shard:
            for k, v in ins["stats"].items():
                stats[k] = stats.get(k, 0) + v
            for k, v in ins["admission"]["stats"].items():
                adm_stats[k] = adm_stats.get(k, 0) + v
        rung = max(ins["admission"]["rung"] for ins in per_shard)
        failure = self.failure
        summary = self.load_summary()
        return {
            "n_shards": len(self._shards),
            "ring": self._ring.nodes(),
            "policy": per_shard[0]["policy"],
            "servants": sum(len(ins["servants"]) for ins in per_shard),
            "grants_outstanding": sum(
                ins["grants_outstanding"] for ins in per_shard),
            "zombies": sum(ins["zombies"] for ins in per_shard),
            "pending_requests": sum(
                ins["pending_requests"] for ins in per_shard),
            "envs_interned": sum(
                ins["envs_interned"] for ins in per_shard),
            "stats": stats,
            "steal": self.steal_stats(),
            "failure": None if failure is None else repr(failure),
            "admission": {
                "rung": rung,
                "rung_name": RUNG_NAMES[rung],
                "stats": adm_stats,
            },
            "latency_breakdown": self.aggregate_latency_breakdown(),
            "load_summary": None if summary is None else summary.tolist(),
            # Fused device-resident cycle counters and stages (None
            # unless enable_fused_dispatch was called).
            "fused": self.fused_stats(),
            "fused_stages": (None if self._fused is None
                             else self._fused["timer"].percentiles()),
            "per_shard": per_shard,
        }

    def aggregate_latency_breakdown(self) -> Dict[str, Dict[str, float]]:
        """Pooled stage percentiles: every shard's retained samples
        concatenated per stage (exact over the pooled window — NOT an
        average of per-shard percentiles, which has no meaning)."""
        pooled: Dict[str, List[np.ndarray]] = defaultdict(list)
        counts: Dict[str, int] = defaultdict(int)
        for d in self._shards:
            for stage, (samples, count) in d.stage_timer.samples().items():
                pooled[stage].append(samples)
                counts[stage] += count
        out: Dict[str, Dict[str, float]] = {}
        for stage, chunks in pooled.items():
            arr = np.concatenate(chunks)
            out[stage] = {
                "count": int(counts[stage]),
                "mean_ms": round(float(arr.mean()) * 1000.0, 4),
                "p50_ms": round(float(np.percentile(arr, 50)) * 1000.0, 4),
                "p99_ms": round(float(np.percentile(arr, 99)) * 1000.0, 4),
            }
        return out
