"""Multi-cell federation: N scheduler cells, one fleet.

The port of yadcc_tpu/scheduler/federation.py.  One difference by design:
a failure of the placement scorer (the kernel on the card) raises and is
counted (``placement_failures``); the JAX router logs it and falls back
to the least-loaded peer.  The ladder's data-driven rungs are the JAX
package's: no candidate keys, or no eligible peer with a filter snapshot,
picks the least-loaded peer; no eligible peer, ``spill_no_peer``.

A *cell* is a full control plane — a TaskDispatcher or a sharded
ShardRouter with its own servant registry, admission ladder, and
(optionally) a warm standby (scheduler/replication.py).  Cells are
routed *cell-ward* by consistent hash on the environment digest — the
cache-key prefix — so a given toolchain's compilations concentrate
where its artifacts are warm.

Two cross-cell mechanisms, both deliberately narrow:

* **Spillover** (the admission rung between SHED_OPTIONAL and
  LOCAL_ONLY; scheduler/admission.py): when the home cell's ladder has
  climbed to RUNG_SPILLOVER, new grant requests are forwarded to a
  peer cell that still has headroom — remote capacity beats telling
  the delegate to burn its local CPU.  The peer is picked by a SCORED
  placement decision (scheduler/placement.py): a cells×tasks cost
  matrix fusing cache warmth (per-cell region-filter snapshots probed
  for the request's candidate keys), load, and topology distance,
  computed in one device call with the argmin on the device; the ladder
  degrades scored → least-loaded → ``spill_no_peer`` when warmth data
  is missing.  Grants carry cell provenance (``cell_id`` / ``spilled``
  on the wire) and stay *cell-namespaced*: renewals and frees route
  home by grant-id arithmetic alone, no table.
* **Takeover swap**: a cell's dispatcher is reached through its
  :class:`CellHandle`; a standby promotion swaps the handle's
  dispatcher in place and every peer's spillover path follows without
  re-configuration.

Grant-id namespace: cell ``c`` of ``C`` cells running ``n`` shards
issues ids with ``start = c*n + k + 1`` and ``stride = C*n`` (shard
``k``).  Within a cell the shard residue is untouched —
``ShardRouter.shard_of_grant`` still works — and across cells
``cell_of_grant`` recovers the owner, so the two-level namespace costs
one modulo.  Grant ids stay globally unique across a takeover, which
is what makes the cell-kill double-run check meaningful.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict, deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional, Sequence, Tuple

from ..common.bloom import SaltedBloomFilter
from ..common.consistent_hash import (SCHEDULER_VNODES_PER_WEIGHT,
                                      ConsistentHash)
from ..utils.clock import REAL_CLOCK, Clock
from ..utils.logging import get_logger
from ..utils.stagetimer import StageTimer
from .admission import RUNG_SPILLOVER, AdmissionDecision
from .placement import (BIG as _SCORE_BIG, CellCandidate,
                        DevicePlacementScorer, host_reference_placement)
from .shard_router import RoutedGrant, RoutedGrants

logger = get_logger("scheduler.federation")


def cell_of_grant(grant_id: int, n_cells: int,
                  shards_per_cell: int = 1) -> int:
    """Owning cell of a grant id under the two-level namespace."""
    return ((grant_id - 1) % (n_cells * shards_per_cell)) // shards_per_cell


def grant_namespace_for_cell(cell: int, n_cells: int,
                             shards_per_cell: int = 1
                             ) -> Tuple[int, int]:
    """(grant_id_start, grant_id_stride) for a SINGLE-dispatcher cell
    (shard 0); sharded cells pass ``grant_namespace=(cell, n_cells)``
    to ShardRouter.build, which applies the same arithmetic per
    shard."""
    return cell * shards_per_cell + 1, n_cells * shards_per_cell


@dataclass
class CellHandle:
    """One cell as its peers see it.  ``dispatcher`` is read at call
    time, never cached — a warm-standby takeover swaps it in place and
    spillover from peer cells follows to the promoted scheduler."""

    cell_id: int
    dispatcher: object
    uris: List[str] = field(default_factory=list)  # dialing order: active,standby


class CellDirectory:
    """Client-side cell pick: env digest -> home cell, by consistent
    hash (same ring discipline the shard router uses server-side, so a
    digest's home is stable under cell membership changes; the port's own
    common/consistent_hash.py, on its own XXH64)."""

    def __init__(self, cell_uris: Sequence[str], *,
                 vnodes_per_weight: int = SCHEDULER_VNODES_PER_WEIGHT):
        if not cell_uris:
            raise ValueError("CellDirectory needs at least one cell URI")
        self._uris = list(cell_uris)
        self._ring = ConsistentHash(
            [(str(i), 1) for i in range(len(self._uris))],
            vnodes_per_weight=vnodes_per_weight)

    def __len__(self) -> int:
        return len(self._uris)

    def home_cell(self, env_digest: str) -> int:
        return int(self._ring.pick(env_digest))

    def home_cell_scored(self, env_digest: str,
                         keys: Sequence[str] = (),
                         filters: Optional[Sequence[
                             Optional[SaltedBloomFilter]]] = None,
                         utilizations: Optional[Sequence[float]] = None,
                         ) -> int:
        """Affinity homing for clients that know their candidate cache
        keys: score every cell with the HOST reference scorer
        (scheduler/placement.py — the client has no accelerator
        mandate; the arithmetic is the same int32 math the device
        kernel runs server-side) and home to the warmest.  Keyless
        clients, or clients without any per-cell filter snapshot, fall
        back to the consistent-hash pick — the ring stays the stability
        anchor, scoring only refines it when warmth data exists."""
        if (not keys or filters is None
                or not any(f is not None for f in filters)):
            return self.home_cell(env_digest)
        n = len(self._uris)
        utils = list(utilizations) if utilizations is not None else []
        cells = [CellCandidate(
                     cell_id=i,
                     utilization=(utils[i] if i < len(utils) else 0.0),
                     filter=(filters[i] if i < len(filters) else None))
                 for i in range(n)]
        res = host_reference_placement(cells, [list(keys)])
        if res is None or int(res.best_score[0]) >= _SCORE_BIG:
            return self.home_cell(env_digest)
        return int(res.best_cell[0])

    def uri(self, cell: int) -> str:
        """The cell's dialing URI — possibly a comma-separated
        active,standby list (the JAX package's rpc.FailoverChannel; the
        port's comes with the daemon)."""
        return self._uris[cell]


class FederationRouter:
    """One cell's view of the federated plane.

    Drop-in where a TaskDispatcher/ShardRouter was (SchedulerService
    feature-detects with hasattr): local-plane operations — heartbeats,
    registry, sweeps — always hit the *local* cell; the grant path adds
    the spillover rung, and renew/free route by ``cell_of_grant`` so a
    spilled grant's lease lives exactly one place, its issuing cell.

    The parked-continuation API (``submit_wait_for_starting_new_task``)
    is deliberately NOT exposed: parking happens inside one dispatcher
    and cannot span cells, so the aio front end serves a federated
    service's ``WaitForStartingTask`` through the blocking handler on its
    bounded pool, as in the reference.
    """

    # Candidate-key ring sizing: enough recent keys per env for a
    # meaningful warmth sample, bounded envs so a digest churn can't
    # grow the table without limit.
    _KEYS_PER_ENV = 32
    _MAX_ENVS = 256

    def __init__(self, cells: Sequence[CellHandle], my_cell: int, *,
                 shards_per_cell: int = 1,
                 spill_max_batch: int = 8,
                 signal_ttl_s: float = 0.1,
                 topology_distance: Optional[Sequence[int]] = None,
                 use_scored_placement: bool = True,
                 placement_scorer: Optional[object] = None,
                 device="cuda",
                 clock: Clock = REAL_CLOCK):
        if not cells:
            raise ValueError("federation needs at least one cell")
        if not 0 <= my_cell < len(cells):
            raise ValueError(f"my_cell {my_cell} out of range")
        self._cells = list(cells)
        self._my_cell = my_cell
        self._n_shards = max(1, shards_per_cell)
        self._spill_max_batch = spill_max_batch
        self._signal_ttl_s = signal_ttl_s
        self._use_scored = use_scored_placement
        self._topo = (list(topology_distance)
                      if topology_distance is not None
                      else [0] * len(self._cells))
        if len(self._topo) != len(self._cells):
            raise ValueError(
                f"topology_distance needs {len(self._cells)} entries, "
                f"got {len(self._topo)}")
        self._clock = clock
        # Where the lazily built scorer runs (the card unless the caller
        # asks for the CPU).
        self._device = device
        self._lock = threading.Lock()  # leaf: counters only
        self._stats = {"spilled_requests": 0, "spilled_grants": 0,
                       "spill_no_peer": 0,
                       "foreign_renewals": 0,
                       "foreign_frees": 0,
                       "signal_refreshes": 0,
                       "signal_cache_hits": 0,
                       "placement_scored": 0,
                       "placement_fallback_least_loaded": 0,
                       "placement_failures": 0,
                       }  # guarded by: self._lock
        self._spill_by_peer: Dict[int, int] = {}  # guarded by: self._lock
        # Affinity state for the scored spill path — a separate leaf
        # lock so warmth bookkeeping never contends with the counter
        # path, and NEVER held across a dispatcher or device call.
        self._affinity_lock = threading.Lock()
        self._scorer = placement_scorer  # guarded by: self._affinity_lock (lazy init)
        self._keys_by_env: "OrderedDict[str, Deque[str]]" = \
            OrderedDict()  # guarded by: self._affinity_lock
        self._cell_filters: Dict[int, SaltedBloomFilter] = \
            {}  # guarded by: self._affinity_lock
        self._signal_cache: Dict[int, Tuple[float, Optional[tuple]]] = \
            {}  # guarded by: self._affinity_lock
        # Placement-stage latency budget, surfaced in
        # inspect()["federation"]["latency_breakdown"].
        self.stage_timer = StageTimer()

    # -- plumbing ------------------------------------------------------------

    @property
    def cell_id(self) -> int:
        return self._my_cell

    @property
    def n_cells(self) -> int:
        return len(self._cells)

    def _local(self):
        return self._cells[self._my_cell].dispatcher

    def __getattr__(self, name):
        # Local-plane passthrough (keep_servant_alive, notify_*,
        # get_running_tasks, adopt_grants, admission_rung, inspect,
        # ...).  The parked submit API must stay invisible — see class
        # docstring — so the hasattr probe in SchedulerService.spec()
        # answers False even when the local dispatcher has it.
        if name == "submit_wait_for_starting_new_task":
            raise AttributeError(name)
        return getattr(self._cells[self._my_cell].dispatcher, name)

    def cell_of(self, grant_id: int) -> int:
        return cell_of_grant(grant_id, len(self._cells), self._n_shards)

    def stats(self) -> Dict[str, object]:
        with self._lock:
            out: Dict[str, object] = dict(self._stats)
            out["spilled_grants_by_peer"] = dict(self._spill_by_peer)
        return out

    def _bump(self, key: str, n: int = 1) -> None:
        with self._lock:
            self._stats[key] += n

    def _bump_peer(self, cell_id: int, n: int) -> None:
        with self._lock:
            self._spill_by_peer[cell_id] = \
                self._spill_by_peer.get(cell_id, 0) + n

    def inspect(self) -> dict:
        """Local-cell inspect() plus the federation block (the /inspect
        surface rides this): spill counters with per-peer provenance
        and the placement-stage latency budget, so an A/B can attribute
        post-spill hit rate to placement decisions.  The breakdown splits
        ``placement`` into the peer signals, the scorer call and, for a
        scorer that times them, its pack and its one native call."""
        out = dict(self._local().inspect())
        breakdown = self.stage_timer.percentiles()
        with self._affinity_lock:
            timer = getattr(self._scorer, "stage_timer", None)
        if timer is not None:
            breakdown.update({f"placement_{k}": v
                              for k, v in timer.percentiles().items()})
        out["federation"] = {
            "cell_id": self._my_cell,
            "n_cells": len(self._cells),
            "stats": self.stats(),
            "latency_breakdown": breakdown,
        }
        return out

    # -- affinity plumbing (scored spill placement) --------------------------

    def note_candidate_keys(self, env_digest: str,
                            keys: Sequence[str]) -> None:
        """Record candidate cache keys for an env digest — the warmth
        probes for the next spill decision under that digest.  Bounded
        per-env ring + bounded env table (LRU eviction); dropping keys
        only softens the warmth sample, never correctness."""
        if not env_digest or not keys:
            return
        with self._affinity_lock:
            ring = self._keys_by_env.get(env_digest)
            if ring is None:
                ring = deque(maxlen=self._KEYS_PER_ENV)
                self._keys_by_env[env_digest] = ring
            else:
                self._keys_by_env.move_to_end(env_digest)
            ring.extend(keys)
            while len(self._keys_by_env) > self._MAX_ENVS:
                self._keys_by_env.popitem(last=False)

    def candidate_keys(self, env_digest: str) -> List[str]:
        """Deduped recent candidate keys for a digest, oldest first."""
        with self._affinity_lock:
            ring = self._keys_by_env.get(env_digest)
            snap = list(ring) if ring else []
        seen: set = set()
        out: List[str] = []
        for k in snap:
            if k not in seen:
                seen.add(k)
                out.append(k)
        return out

    def update_cell_filter(self, cell_id: int,
                           snapshot: Optional[SaltedBloomFilter]) -> None:
        """Install a peer cell's region-filter snapshot
        (cache/bloom_filter_generator.py:snapshot) for warmth scoring,
        and upload it to the scorer's device once.  None clears it.
        Staleness contract: a snapshot answers "was this key warm as of
        the snapshot" — the scorer never assumes fresher; refresh
        cadence is the deployment's filter-sync cadence."""
        scorer = self._scorer_obj()
        with self._affinity_lock:
            if snapshot is None:
                self._cell_filters.pop(cell_id, None)
            else:
                self._cell_filters[cell_id] = snapshot
        scorer.install(cell_id, snapshot)

    def _scorer_obj(self):
        with self._affinity_lock:
            if self._scorer is None:
                self._scorer = DevicePlacementScorer(device=self._device)
            return self._scorer

    def _peer_state(self, cell: CellHandle) -> Optional[tuple]:
        """(admission_rung, LoadSignal) for a peer, TTL-cached
        (~signal_ttl_s) so a spill storm reads each peer once per
        window instead of once per spill.  Failures (cell mid-takeover)
        negative-cache for the same TTL.  The dispatcher calls happen
        OUTSIDE every federation lock."""
        now = self._clock.now()
        with self._affinity_lock:
            hit = self._signal_cache.get(cell.cell_id)
        if hit is not None and now - hit[0] <= self._signal_ttl_s:
            self._bump("signal_cache_hits")
            return hit[1]
        try:
            state = (cell.dispatcher.admission_rung(),
                     cell.dispatcher.load_signal())
        except Exception:
            state = None
        with self._affinity_lock:
            self._signal_cache[cell.cell_id] = (now, state)
        self._bump("signal_refreshes")
        return state

    # -- admission / home resolution ----------------------------------------

    def resolve_home(self, requestor: str, env_digest: str = "") -> int:
        """Home SHARD within the local cell (cell-level homing happened
        client-side via CellDirectory; requests that reach this cell
        are already cell-homed — or deliberately spilled here)."""
        local = self._local()
        inner = getattr(local, "resolve_home", None)
        if inner is None:
            return 0
        return inner(requestor, env_digest)

    def admission_check(self, immediate: int = 1, prefetch: int = 0,
                        requestor: str = "",
                        home: Optional[int] = None,
                        tenant: str = "",
                        tier: str = "") -> AdmissionDecision:
        local = self._local()
        if getattr(local, "resolve_home", None) is not None:
            return local.admission_check(immediate, prefetch, requestor,
                                         home=home, tenant=tenant,
                                         tier=tier)
        return local.admission_check(immediate, prefetch, requestor,
                                     tenant=tenant, tier=tier)

    # -- the grant path ------------------------------------------------------

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
        """Local allocation, with the SPILLOVER rung in front: an
        overloaded home cell forwards the immediate demand to the
        least-loaded peer with headroom BEFORE degrading to LOCAL_ONLY
        (admission ruled FLOW_NONE at the spillover rung precisely so
        this path gets the request).  Prefetch never spills — it is
        opportunistic load the fleet can drop, not forward."""
        local = self._local()
        if (len(self._cells) > 1
                and local.admission_rung() >= RUNG_SPILLOVER):
            peer = self._pick_spill_peer(env_digest)
            if peer is not None:
                got = self._spill_to(peer, env_digest, min_version,
                                     requestor, immediate, lease_s,
                                     timeout_s, tenant=tenant)
                if got.grants:
                    return got
                # Peer came up dry (its headroom evaporated): fall
                # through to the local path rather than failing the
                # request outright.
            else:
                self._bump("spill_no_peer")
        routed_fn = getattr(local, "wait_for_starting_new_task_routed",
                            None)
        if routed_fn is not None:
            out = routed_fn(env_digest, min_version=min_version,
                            requestor=requestor, immediate=immediate,
                            prefetch=prefetch, lease_s=lease_s,
                            timeout_s=timeout_s, home=home,
                            tenant=tenant)
        else:
            out = RoutedGrants(shard_id=0)
            for gid, loc in local.wait_for_starting_new_task(
                    env_digest, min_version=min_version,
                    requestor=requestor, immediate=immediate,
                    prefetch=prefetch, lease_s=lease_s,
                    timeout_s=timeout_s, tenant=tenant):
                out.grants.append(RoutedGrant(gid, loc, 0, False))
        out.cell_id = self._my_cell
        for g in out.grants:
            g.cell_id = self._my_cell
        return out

    def _pick_spill_peer(self, env_digest: str = ""
                         ) -> Optional[CellHandle]:
        """Spill target by the placement fallback ladder:

        1. **Scored** — when candidate keys were noted for this digest
           and at least one eligible peer has a filter snapshot, build
           the cells×tasks cost matrix (warmth + load + topology) in
           ONE device call (scheduler/placement.py) and take its
           argmin.  No per-peer host loop: the peers enter the call as
           one batch.  A scorer failure raises (and is counted).
        2. **Least-loaded** — no warmth data (or the scorer declined):
           the pre-scoring behavior, lowest cached utilization.
        3. **None** — no peer is eligible at all; the caller bumps
           ``spill_no_peer`` and the request stays local.

        Eligibility everywhere: a peer below the spillover rung — never
        shift load onto a cell that is also shedding — with free
        capacity per its (TTL-cached) signal.  Peer signals are read
        through _peer_state outside any federation lock."""
        t0 = time.perf_counter()
        try:
            return self._pick_spill_peer_inner(env_digest)
        finally:
            self.stage_timer.record("placement",
                                    time.perf_counter() - t0)

    def _pick_spill_peer_inner(self, env_digest: str
                               ) -> Optional[CellHandle]:
        peers = [c for c in self._cells if c.cell_id != self._my_cell]
        t0 = time.perf_counter()
        states = [self._peer_state(c) for c in peers]
        self.stage_timer.record("placement_signals",
                                time.perf_counter() - t0)
        eligible = [s is not None and s[0] < RUNG_SPILLOVER
                    and s[1].free > 0 for s in states]
        if not any(eligible):
            return None

        if self._use_scored and env_digest:
            keys = self.candidate_keys(env_digest)
            with self._affinity_lock:
                filters = dict(self._cell_filters)
            if keys and any(filters.get(p.cell_id) is not None
                            for p, ok in zip(peers, eligible) if ok):
                cands = [CellCandidate(
                             cell_id=p.cell_id,
                             utilization=(s[1].utilization
                                          if s is not None else 0.0),
                             topo_distance=self._topo[p.cell_id],
                             eligible=ok,
                             filter=filters.get(p.cell_id))
                         for p, s, ok in zip(peers, states, eligible)]
                t0 = time.perf_counter()
                try:
                    res = self._scorer_obj().score(cands, [keys])
                except Exception:
                    self._bump("placement_failures")
                    raise
                self.stage_timer.record("placement_score",
                                        time.perf_counter() - t0)
                if (res is not None
                        and int(res.best_score[0]) < _SCORE_BIG):
                    self._bump("placement_scored")
                    return peers[int(res.best_cell[0])]

        best: Optional[CellHandle] = None
        best_util = float("inf")
        for p, s, ok in zip(peers, states, eligible):
            if ok and s[1].utilization < best_util:
                best, best_util = p, s[1].utilization
        if best is not None:
            self._bump("placement_fallback_least_loaded")
        return best

    def _spill_to(self, peer: CellHandle, env_digest: str,
                  min_version: int, requestor: str, immediate: int,
                  lease_s: float, timeout_s: float,
                  tenant: str = "") -> RoutedGrants:
        out = RoutedGrants(shard_id=0, cell_id=self._my_cell)
        pairs = peer.dispatcher.wait_for_starting_new_task(
            env_digest, min_version=min_version, requestor=requestor,
            immediate=min(immediate, self._spill_max_batch), prefetch=0,
            lease_s=lease_s, tenant=tenant,
            # A spill is a detour on an already-ruled request: give the
            # peer a short slice of the budget so a dry peer cannot eat
            # the whole wait the delegate granted the home cell.
            timeout_s=min(timeout_s, 1.0))
        for gid, loc in pairs:
            out.grants.append(RoutedGrant(
                gid, loc, 0, False, cell_id=peer.cell_id, spilled=True))
        if pairs:
            self._bump("spilled_requests")
            self._bump("spilled_grants", len(pairs))
            self._bump_peer(peer.cell_id, len(pairs))
            logger.debug("spilled %d grant(s) cell %d -> %d",
                         len(pairs), self._my_cell, peer.cell_id)
        return out

    # -- lease upkeep: route home by grant-id arithmetic ---------------------

    def keep_task_alive(self, grant_ids: Sequence[int],
                        next_keep_alive_s: float) -> List[bool]:
        out = [False] * len(grant_ids)
        by_cell: Dict[int, List[Tuple[int, int]]] = {}
        for i, gid in enumerate(grant_ids):
            by_cell.setdefault(self.cell_of(gid), []).append((i, gid))
        for c, items in by_cell.items():
            if c != self._my_cell:
                self._bump("foreign_renewals", len(items))
            try:
                res = self._cells[c].dispatcher.keep_task_alive(
                    [gid for _, gid in items], next_keep_alive_s)
            except Exception:
                # Owning cell mid-takeover: the renewal fails closed
                # (False) and the delegate retries next beat — by then
                # the standby has adopted the lease.
                continue
            for (i, _), ok in zip(items, res):
                out[i] = ok
        return out

    def free_task(self, grant_ids: Sequence[int]) -> None:
        by_cell: Dict[int, List[int]] = {}
        for gid in grant_ids:
            by_cell.setdefault(self.cell_of(gid), []).append(gid)
        for c, ids in by_cell.items():
            if c != self._my_cell:
                self._bump("foreign_frees", len(ids))
            try:
                self._cells[c].dispatcher.free_task(ids)
            except Exception:
                pass  # lease expiry reclaims; free is best-effort

    # -- lifecycle (local cell only) -----------------------------------------

    def on_expiration_timer(self) -> None:
        self._local().on_expiration_timer()

    def stop(self) -> None:
        self._local().stop()
