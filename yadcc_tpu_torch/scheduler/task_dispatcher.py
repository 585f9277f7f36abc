"""TaskDispatcher: the scheduler's core state machine.

Capability parity with reference yadcc/scheduler/task_dispatcher.{h,cc}
(servant registry + grant registry, blocking grant allocation, lease
renewal, zombie/orphan GC) with one deliberate architectural change: the
reference resolves each WaitForStartingTask request individually inside a
global mutex — a documented scaling bottleneck (task_dispatcher.h:283-288)
— whereas here requests park in a queue and a single dispatch loop
resolves the whole backlog per cycle through the DispatchPolicy SPI
(the host greedy oracle, or the grouped kernel on the card).
Bookkeeping (leases, zombies, wakeups) stays host-side: it's I/O-shaped
state, not math.

A waiter either blocks (``wait_for_starting_new_task``, one RPC worker
thread a wait) or parks (``submit_wait_for_starting_new_task``, the aio
front end): its continuation fires exactly once, outside the lock, from
whichever thread completes it (a cycle's apply, the pipelined drain, the
deadline sweep, stop or a policy failure).

Multi-tenant QoS: given a tenant directory, every grant is charged to its
verified tenant's ledger at issue and released on every exit path, and
admission rules on the tenant's budget before the overload ladder
(tenancy/).  The sharded control plane (shard_router.py) builds N of
these with namespaced grant ids and, for its fused cycle, drives their
stream machinery from outside (begin_external_stream and friends).

Lifecycle parity notes:
* Servants live by heartbeat lease (reference: 1s beat / 10s lease); an
  expired servant is dropped and its grants orphan-swept
  (task_dispatcher.cc:498-536, :478-496).
* Grants are leases too (15s, renewed in batches).  An expired grant
  turns *zombie*: it stops being renewable but keeps occupying servant
  capacity until the servant's heartbeat confirms the task is gone —
  dropping it instantly would over-schedule the servant
  (task_dispatcher.h:207-214).
* The servant's heartbeat carries its actually-running task list; the
  scheduler answers with the grant ids it has expired so the servant can
  kill them (task_dispatcher.cc:222-277).

A failure of the policy (a device error) is not survived: it is logged,
the dispatcher stops, and every waiter — present and future — gets the
error instead of a grant.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from ..utils.clock import REAL_CLOCK, Clock
from ..utils.logging import get_logger
from ..utils.stagetimer import StageTimer
from ..ops.assignment import NO_PICK
from ..tenancy import TenantDirectory, TenantLedger, apply_tier
from .admission import (FLOW_REJECT, AdmissionConfig, AdmissionDecision,
                        OverloadLadder)
from .policy import AssignRequest, DispatchPolicy, EnvRegistry, PoolSnapshot

logger = get_logger("scheduler.dispatcher")


class DispatcherFailed(RuntimeError):
    """The dispatcher stopped after a policy (device) failure."""

# Grants whose zombie state outlives this many seconds are dropped even
# without servant confirmation (e.g. the servant died as well and its
# registry entry vanished before reporting).
_ZOMBIE_TIMEOUT_S = 60.0

# Staged heartbeats are force-applied once this many accumulate, so a
# beat is never more than ~threshold/beat-rate stale even if no grant
# cycle runs (a 5k/s fleet flushes every ~13ms).
_HB_FLUSH_THRESHOLD = 64

# Lease granted to a journal-gap grant adopted off a servant's report
# during the takeover grace window (scheduler/replication.py): long
# enough for its delegate's next keep-alive to land, short enough that
# a grant whose delegate died with the old active expires promptly.
_ADOPTED_LEASE_S = 15.0

# Ids (in the dispatcher's namespace) above the journaled maximum that a
# takeover's adoption window lets reporting servants claim, and above
# which the promoted dispatcher starts issuing.  It must exceed every id
# the dead active issued after its last acked batch: at tens of thousands
# of grants a second that is far more than the JAX package's 1,024 (which
# then kills reported gap grants and issues their ids again;
# tests/test_torch_replication.py).  Grant ids are uint64 on the wire, so
# 2^32 ids a takeover costs nothing.
TAKEOVER_GAP_SLACK = 1 << 32

# A snapshot buffer whose dirty set covers more than this fraction of
# the pool rebuilds vectorized instead of via fancy-index updates.
_SNAP_FULL_REBUILD_FRAC = 8  # 1/8 of slots


@dataclass
class ServantInfo:
    """Facts reported via heartbeat (api.scheduler.HeartbeatRequest)."""

    location: str
    version: int = 1
    num_processors: int = 0
    current_load: int = 0
    dedicated: bool = False
    not_accepting_reason: int = 0
    capacity: int = 0
    total_memory: int = 0
    memory_available: int = 0
    env_digests: Tuple[str, ...] = ()


@dataclass
class _Servant:
    slot: int
    info: ServantInfo
    expires_at: float = 0.0
    running_grants: Set[int] = field(default_factory=set)


@dataclass
class _Grant:
    grant_id: int
    slot: int
    servant_location: str
    env_digest: str
    expires_at: float
    zombie_since: Optional[float] = None
    requestor: str = ""
    # Verified tenant the grant is charged to ("" = untenanted); every
    # release path credits the tenant ledger through this field, so
    # per-tenant outstanding counts are exact.
    tenant: str = ""


class _SnapBuffer:
    """One prepared PoolSnapshot backing store, maintained incrementally.

    The arrays are only written during publication (under the dispatcher
    lock, while not leased); a leased buffer is read-only until released,
    so the policy can consume it outside the lock while heartbeats keep
    mutating the live pool arrays."""

    __slots__ = ("alive", "capacity", "running", "dedicated", "version",
                 "env", "dirty", "leased", "full_rebuild")

    def __init__(self, max_servants: int, env_words: int):
        self.alive = np.zeros(max_servants, bool)
        self.capacity = np.zeros(max_servants, np.int32)
        self.running = np.zeros(max_servants, np.int32)
        self.dedicated = np.zeros(max_servants, bool)
        self.version = np.zeros(max_servants, np.int32)
        self.env = np.zeros((max_servants, env_words), np.uint32)
        self.dirty: Set[int] = set()
        self.leased = False
        self.full_rebuild = True


@dataclass
class LoadSignal:
    """One shard's load, as the steal path sees it (load_signal())."""

    capacity: int
    outstanding: int
    queued_immediate: int
    utilization: float
    free: int


@dataclass
class _Pending:
    env_id: int
    env_digest: str
    min_version: int
    requestor_slot: int
    requestor: str
    lease_s: float
    immediate_left: int
    prefetch_left: int
    deadline: float
    # Verified tenant this demand is attributed to ("" = untenanted):
    # queued-demand budgeting and minted-grant attribution key on it.
    tenant: str = ""
    enqueued_at: float = 0.0
    queue_wait_recorded: bool = False
    first_cycle_done: bool = False
    abandoned: bool = False  # caller gave up; grants must not be issued
    # Pipelined mode: entries launched but not yet drained.  Selection
    # subtracts these so a request in flight is never launched twice.
    inflight_imm: int = 0
    inflight_pre: int = 0
    prefetch_launched: bool = False
    grants: List[_Grant] = field(default_factory=list)
    done: threading.Event = field(default_factory=threading.Event)
    # Parked-continuation requests (aio front end): called once with
    # [(grant_id, location)] when the request completes, instead of a
    # thread blocking on `done`.  Fired OUTSIDE the dispatcher lock by
    # _fire_async_done().
    on_done: Optional[Callable] = None


class TaskDispatcher:
    def __init__(
        self,
        policy: DispatchPolicy,
        *,
        max_servants: int = 8192,
        max_envs: int = 256,
        min_memory_for_new_task: int = 10 << 30,
        clock: Clock = REAL_CLOCK,
        batch_window_s: float = 0.002,
        batch_target: int = 64,
        start_dispatch_thread: bool = True,
        pipeline_depth: int = 0,
        admission_config: Optional[AdmissionConfig] = None,
        grant_id_start: int = 1,
        grant_id_stride: int = 1,
        # Multi-tenant QoS: the directory carries per-tenant budgets and
        # tiers; None = untenanted deployment (every tenant-typed surface
        # degenerates to the legacy path).
        tenant_directory: Optional[TenantDirectory] = None,
    ):
        self._policy = policy
        self._clock = clock
        self._min_memory = min_memory_for_new_task
        self._batch_window = batch_window_s
        self._batch_target = max(2, batch_target)
        self.max_servants = max_servants

        self._lock = threading.Lock()
        self._work = threading.Condition(self._lock)
        self._envs = EnvRegistry(max_envs)
        # Round UP: max_envs below 32 must still get one bitmap word
        # (integer floor gave a zero-width bitmap and an IndexError on
        # the first heartbeat).
        self._env_words = (max_envs + 31) // 32

        self._slots: List[Optional[_Servant]] = \
            [None] * max_servants  # guarded by: self._lock
        self._free_slots = list(
            range(max_servants - 1, -1, -1))  # guarded by: self._lock
        self._by_location: Dict[str, int] = {}  # guarded by: self._lock
        # ip -> slots on that machine: requestor self-avoidance lookups
        # happen per grant request and must not scan 5k locations.
        self._by_ip: Dict[str, set] = {}  # guarded by: self._lock
        # The struct-of-arrays pool view, maintained INCREMENTALLY —
        # the per-cycle snapshot is a handful of vectorized numpy ops,
        # not an O(S) Python rebuild (the host-side scan this design
        # exists to eliminate; the reference's per-request version is
        # its documented bottleneck, task_dispatcher.h:283-288).
        # Heartbeats write the REPORTED values; grants/frees touch only
        # the running counter; effective capacity is derived vectorized
        # at snapshot time, so the grant hot path never recomputes it
        # per slot in Python.
        self._arr_alive = np.zeros(max_servants, bool)  # guarded by: self._lock
        self._arr_cap_rep = np.zeros(max_servants, np.int32)  # guarded by: self._lock
        self._arr_nprocs = np.zeros(max_servants, np.int32)  # guarded by: self._lock
        self._arr_load = np.zeros(max_servants, np.int32)  # guarded by: self._lock
        self._arr_mem_ok = np.zeros(max_servants, bool)  # guarded by: self._lock
        self._arr_accepting = np.zeros(max_servants, bool)  # guarded by: self._lock
        self._arr_running = np.zeros(max_servants, np.int32)  # guarded by: self._lock
        self._arr_dedicated = np.zeros(max_servants, bool)  # guarded by: self._lock
        self._arr_version = np.zeros(max_servants, np.int32)  # guarded by: self._lock
        self._arr_env = np.zeros((max_servants, self._env_words),
                                 np.uint32)  # guarded by: self._lock
        self._pool_epoch = 0  # guarded by: self._lock
        # Slot occupancy generation: bumped when a slot changes hands.
        # The apply phase compares against its snapshot-time copy so a
        # slot recycled to a DIFFERENT machine while the policy ran
        # unlocked never receives a grant scored for the old occupant
        # (whose envs/version/identity the decision was based on).
        self._slot_generation = np.zeros(
            max_servants, np.int64)  # guarded by: self._lock

        self._grants: Dict[int, _Grant] = {}  # guarded by: self._lock
        # Sharded control plane (shard_router.py): shard k of N issues
        # ids k+1, k+1+N, k+1+2N, ... — disjoint by construction, so a
        # grant id alone routes its renewal/free back to the owning
        # shard and a stolen grant can never collide with (or be
        # re-issued by) another shard.
        if not (1 <= grant_id_start <= grant_id_stride):
            raise ValueError(
                f"grant_id_start must be in [1, stride]: "
                f"{grant_id_start=} {grant_id_stride=}")
        self._next_grant_id = grant_id_start  # guarded by: self._lock
        self._grant_id_stride = grant_id_stride

        self._pending: List[_Pending] = []  # guarded by: self._lock
        # Completed parked-continuation requests awaiting their
        # callback fire (drained outside the lock; see
        # _fire_async_done).
        self._async_done: List[_Pending] = []  # guarded by: self._lock
        self._stopping = False  # guarded by: self._lock
        # The policy error that stopped the dispatcher (None: healthy).
        self.failure: Optional[BaseException] = None  # guarded by: self._lock
        self._stats = {"granted": 0, "expired_grants": 0,
                       "zombies_killed": 0,
                       "adopted_grants": 0}  # guarded by: self._lock
        # Per-tenant grant provenance ("" entries never created).
        self._stats_by_tenant: Dict[str, Dict[str, int]] = \
            {}  # guarded by: self._lock
        self._tenant_directory = tenant_directory
        # Outstanding-grant ledger: charged at issue, released on EVERY
        # grant exit path (free, zombie kill, servant drop).
        self.tenant_ledger = TenantLedger(tenant_directory)

        # Lease adoption (warm-standby takeover, scheduler/
        # replication.py): journal-replayed grants for servants that
        # have not heartbeated into THIS dispatcher yet are parked here
        # and attached when the servant joins; set_adoption_window()
        # additionally lets a reporting servant claim ids the journal
        # never carried (issued after the last shipped batch).
        self._pending_adoptions: Dict[str, List[Tuple[int, str, str]]] = \
            {}  # guarded by: self._lock
        self._adopt_floor = 0  # guarded by: self._lock
        self._adopt_until = -1.0  # guarded by: self._lock
        # Per-stage grant-path latency (admission -> queue-wait ->
        # snapshot -> policy -> apply), timed with the injectable
        # clock; surfaces in inspect().
        self.stage_timer = StageTimer(
            ("admission", "queue_wait", "snapshot", "policy", "apply",
             "dispatch_cycle"), maxlen=16384)

        # Overload ladder (scheduler admission control): consulted by SchedulerService BEFORE a grant
        # request queues.  Owns its own leaf lock; the dispatcher only
        # feeds it utilization computed under the main lock, so the
        # two locks never nest.
        self.admission = OverloadLadder(admission_config)
        self._cap_total = 0  # guarded by: self._lock
        self._cap_total_at = -1.0  # guarded by: self._lock

        # Heartbeat staging: steady-state beats of ALREADY-REGISTERED
        # servants are recorded under a cheap leaf lock and applied in
        # batches (cycle start / expiration sweep / threshold), so a 5k
        # beats/s fleet doesn't contend slot-by-slot with dispatch on
        # the main lock.  Joins, leaves, and registry-full detection
        # stay synchronous on the main lock.
        self._hb_lock = threading.Lock()
        self._hb_staged: Dict[str, Tuple[ServantInfo, float]] = \
            {}  # guarded by: self._hb_lock

        # Prepared-snapshot buffers (see _snapshot_locked): dispatch
        # cycles read an incrementally-maintained snapshot instead of
        # copying six pool arrays under the lock every cycle.
        self._snap_buffers: List[_SnapBuffer] = []  # guarded by: self._lock
        # Sync mode releases each lease when the policy returns, so two
        # buffers suffice (one leased, one publishing); pipelined mode
        # holds a lease per in-flight launch until its drain.
        self._max_snap_buffers = (
            pipeline_depth + 3 if pipeline_depth > 0 else 2)

        # Pipelined dispatch (device-resident running chain): the host
        # folds mutations it makes between launches into a per-launch
        # delta upload.  _pipe_adj accumulates signed running
        # corrections (frees, host-rejected device grants); _pipe_resets
        # marks slots needing an absolute overwrite (death/recycle);
        # _pipe_reset_barrier records WHICH launch carried each slot's
        # last reset so corrections from launches before the reset are
        # discarded (the reset already erased their effect).
        self._pipeline_depth = pipeline_depth
        self._pipelined = bool(
            pipeline_depth > 0
            and getattr(policy, "supports_stream", False))
        self._pipe_active = False  # guarded by: self._lock
        self._pipe_adj = np.zeros(max_servants, np.int64)  # guarded by: self._lock
        self._pipe_resets: Dict[int, int] = {}  # guarded by: self._lock
        self._pipe_reset_barrier = np.full(
            max_servants, -1, np.int64)  # guarded by: self._lock
        self._pipe_launch_seq = 0  # guarded by: self._lock
        # Slots whose snapshot row (statics or effective capacity) changed
        # since the last launch, while the stream is live.  Taken in the
        # same locked region that publishes the launch's snapshot, so the
        # delta a resident policy gathers from that snapshot covers
        # exactly these slots (policy.TorchResidentGroupedPolicy).
        self._stream_dirty: Set[int] = set()  # guarded by: self._lock
        # Inline-leader dispatch: the first waiter of an idle backlog
        # runs the cycle on its own thread (two condvar handoffs and
        # the batch window fall off the lone-request latency path);
        # concurrent arrivals coalesce into the leader's cycle.  A
        # parked submit leads the same way, on the submitting thread
        # (the aio front end's event loop).  Only in sync mode with a
        # live dispatch thread — manual-cycle tests and benches
        # (start_dispatch_thread=False) keep the invariant that no
        # cycle runs unless they run one.
        self._inline_dispatch = bool(
            start_dispatch_thread and not self._pipelined)
        self._inline_busy = False  # guarded by: self._lock

        self._thread: Optional[threading.Thread] = None
        if start_dispatch_thread:
            self._thread = threading.Thread(
                target=(self._pipelined_loop if self._pipelined
                        else self._dispatch_loop),
                name="dispatch", daemon=True,
            )
            self._thread.start()

    # ------------------------------------------------------------------
    # Servant registry (heartbeat side).
    # ------------------------------------------------------------------

    def keep_servant_alive(self, info: ServantInfo,
                           expires_in_s: float) -> bool:
        """Upsert a servant; expires_in_s <= 0 is a graceful leave
        (reference scheduler_service_impl.cc:164-170).  Returns False
        when the registry is full and the servant was NOT registered —
        the caller must surface that as a heartbeat failure.

        Steady-state renewals of a known servant are STAGED (leaf lock
        only) and batch-applied at the next dispatch cycle, expiration
        sweep, or flush threshold; joins and leaves stay synchronous so
        registration outcomes and registry-full are reported truthfully
        on the beat that caused them."""
        if expires_in_s <= 0:
            with self._lock:
                with self._hb_lock:
                    # A staged renewal applied later must not resurrect
                    # a servant that has gracefully left.
                    self._hb_staged.pop(info.location, None)
                slot = self._by_location.get(info.location)
                if slot is not None:
                    self._drop_servant_locked(slot)
                    self._work.notify_all()
                return True
        # Benign unlocked read: a concurrent drop just means the staged
        # beat re-joins at flush time (the servant IS alive — it beat).
        if info.location in self._by_location:  # ytpu: allow(guarded-by)  # racy membership probe is the staging fast path's point; any outcome is repaired at flush (see comment above)
            expires_at = self._clock.now() + expires_in_s
            with self._hb_lock:
                self._hb_staged[info.location] = (info, expires_at)
                n_staged = len(self._hb_staged)
            if n_staged >= _HB_FLUSH_THRESHOLD:
                with self._lock:
                    if self._flush_heartbeats_locked():
                        self._work.notify_all()
            return True
        with self._lock:
            ok = self._apply_heartbeat_locked(
                info, self._clock.now() + expires_in_s)
            if ok:
                self._work.notify_all()
            return ok

    def _apply_heartbeat_locked(self, info: ServantInfo,
                                expires_at: float) -> bool:
        slot = self._by_location.get(info.location)
        if slot is not None and info == self._slots[slot].info:
            # Steady-state beat repeating the previous report: a pure
            # lease renewal.  Skipping the array refresh keeps batch
            # flushes (up to _HB_FLUSH_THRESHOLD applies inside one
            # dispatch cycle's setup) off the stage budget — at 5k
            # beats/s virtually every flush is all-renewals.
            self._slots[slot].expires_at = expires_at
            return True
        if slot is None:
            if not self._free_slots:
                logger.warning("servant registry full; rejecting %s",
                               info.location)
                return False
            slot = self._free_slots.pop()
            self._slots[slot] = _Servant(slot=slot, info=info)
            self._by_location[info.location] = slot
            self._slot_generation[slot] += 1
            ip = info.location.rsplit(":", 1)[0]
            self._by_ip.setdefault(ip, set()).add(slot)
        servant = self._slots[slot]
        servant.info = info
        servant.expires_at = expires_at
        for digest in info.env_digests:
            self._envs.intern(digest)
        self._refresh_slot_arrays_locked(slot, envs_too=True)
        parked = self._pending_adoptions.pop(info.location, None)
        if parked:
            for gid, env_digest, requestor in parked:
                self._attach_adopted_locked(
                    servant, gid, env_digest, requestor, expires_at)
        return True

    def _flush_heartbeats_locked(self) -> int:
        """Apply every staged heartbeat; returns how many applied.
        Lock order: main -> hb (staging alone takes only hb)."""
        with self._hb_lock:
            if not self._hb_staged:
                return 0
            staged = self._hb_staged
            self._hb_staged = {}
        for info, expires_at in staged.values():
            # A servant dropped (lease sweep) after its beat was staged
            # re-joins here; registry-full at that point is only logged
            # — the servant's next beat takes the synchronous join path
            # and surfaces the error.
            self._apply_heartbeat_locked(info, expires_at)
        return len(staged)

    def notify_servant_running_tasks(
        self, location: str, reported_grant_ids: Sequence[int]
    ) -> List[int]:
        """Reconcile the servant's actually-running set with ours.

        Returns grant ids the servant should kill: ids it reports that we
        have expired (zombies) or never knew.  Zombies *not* reported any
        more are finally released.
        """
        kill: List[int] = []
        with self._lock:
            slot = self._by_location.get(location)
            if slot is None:
                return list(reported_grant_ids)
            servant = self._slots[slot]
            reported = set(reported_grant_ids)
            now = self._clock.now()
            for gid in reported:
                g = self._grants.get(gid)
                if g is None and self._adoptable_locked(gid, now):
                    # Journal-gap grant (issued by the dead active
                    # after its last shipped batch): the servant is
                    # running it, so believe the servant instead of
                    # killing real work.  Env/requestor are lost with
                    # the journal tail; the lease restarts now.
                    self._attach_adopted_locked(
                        servant, gid, "", "", now + _ADOPTED_LEASE_S)
                    continue
                if g is None or g.zombie_since is not None or g.slot != slot:
                    kill.append(gid)
            # A zombie this servant no longer reports is truly gone.
            for gid in list(servant.running_grants):
                g = self._grants.get(gid)
                if g is not None and g.zombie_since is not None and (
                    gid not in reported
                ):
                    self._release_grant_locked(g)
                    self._stats["zombies_killed"] += 1
            if kill:
                self._work.notify_all()
        return kill

    # ------------------------------------------------------------------
    # Lease adoption (warm-standby takeover, scheduler/replication.py).
    # ------------------------------------------------------------------

    def adopt_grants(self, location: str,
                     grants: Sequence[Tuple[int, str, str]],
                     lease_s: float = 15.0) -> int:
        """Attach journal-replayed grants (id, env_digest, requestor)
        to ``location`` with a FRESH full lease — adoption never starts
        a run, so re-arming cannot double-run, and the grace keeps live
        compiles alive until their delegates re-heartbeat renewals.

        Grants for a servant that has not registered with THIS
        dispatcher yet (standby replayed the journal before the fleet
        re-heartbeated) are parked and attached on its join.  Ids must
        belong to this dispatcher's grant-id namespace; already-known
        ids are idempotently skipped.  Returns how many attached
        immediately."""
        attached = 0
        with self._lock:
            now = self._clock.now()
            for gid, env_digest, requestor in grants:
                if gid <= 0 or (gid % self._grant_id_stride
                                != self._next_grant_id
                                % self._grant_id_stride):
                    raise ValueError(
                        f"grant {gid} is outside this dispatcher's id "
                        f"namespace (stride {self._grant_id_stride}, "
                        f"residue {self._next_grant_id % self._grant_id_stride})")
                if gid in self._grants:
                    continue
                slot = self._by_location.get(location)
                if slot is None:
                    self._pending_adoptions.setdefault(location, []) \
                        .append((gid, env_digest, requestor))
                    # Parked entries live until the grace window closes
                    # (at least one lease, even with no window set).
                    self._adopt_until = max(self._adopt_until,
                                            now + lease_s)
                    self._advance_grant_id_locked(gid)
                    continue
                self._attach_adopted_locked(
                    self._slots[slot], gid, env_digest, requestor,
                    now + lease_s)
                attached += 1
        return attached

    def set_adoption_window(self, floor_grant_id: int,
                            grace_s: float, *,
                            gap_slack: int = TAKEOVER_GAP_SLACK) -> None:
        """Open the takeover grace window.

        ``floor_grant_id`` is the highest id the replica SAW; the dead
        active may have issued up to ``gap_slack`` more ids in this
        namespace after its last acked batch (the journal tail dies
        with it).  For ``grace_s`` a reporting servant may claim any
        unknown id up to ``floor + gap_slack*stride`` —
        notify_servant_running_tasks adopts them instead of killing
        real work.  Our own issue counter starts ABOVE the whole
        claimed range, so a gap id can never be double-issued.  After
        the window closes, unknown ids go back to being killed."""
        with self._lock:
            ceiling = (int(floor_grant_id)
                       + max(0, gap_slack) * self._grant_id_stride)
            self._adopt_floor = max(self._adopt_floor, ceiling)
            # max(): adopt_grants may already have parked entries whose
            # lease extends past grace_s; a later window-open must never
            # SHRINK the deadline under them or the purge at the window
            # close kills work the journal proved was running.
            self._adopt_until = max(self._adopt_until,
                                    self._clock.now() + max(0.0, grace_s))
            self._advance_grant_id_locked(self._adopt_floor)

    def _adoptable_locked(self, gid: int, now: float) -> bool:
        return (now < self._adopt_until
                and 0 < gid <= self._adopt_floor
                and gid % self._grant_id_stride
                == self._next_grant_id % self._grant_id_stride)

    def _attach_adopted_locked(self, servant: _Servant, gid: int,
                               env_digest: str, requestor: str,
                               expires_at: float) -> None:
        if gid in self._grants:
            return
        g = _Grant(
            grant_id=gid,
            slot=servant.slot,
            servant_location=servant.info.location,
            env_digest=env_digest,
            expires_at=expires_at,
            requestor=requestor,
        )
        self._grants[gid] = g
        servant.running_grants.add(gid)
        self._arr_running[servant.slot] += 1
        # Both device views must learn of a grant no launch made: the
        # dirty mark sends the slot's new running in a resident pool's
        # next delta, and the stream's device running chain takes the
        # +1 with its next launch.  Without either, K1 on the card
        # over-grants the adopted servant.
        self._mark_slot_dirty_locked(servant.slot)
        if self._pipe_active:
            self._pipe_adj[servant.slot] += 1
        self._advance_grant_id_locked(gid)
        self._stats["adopted_grants"] += 1

    def _advance_grant_id_locked(self, gid: int) -> None:
        """Future issues must never collide with an adopted id."""
        if self._next_grant_id <= gid:
            stride = self._grant_id_stride
            self._next_grant_id += (
                (gid - self._next_grant_id) // stride + 1) * stride

    # ------------------------------------------------------------------
    # Grant allocation (delegate side).
    # ------------------------------------------------------------------

    def wait_for_starting_new_task(
        self,
        env_digest: str,
        *,
        min_version: int = 0,
        requestor: str = "",
        immediate: int = 1,
        prefetch: int = 0,
        lease_s: float = 15.0,
        timeout_s: float = 5.0,
        tenant: str = "",
    ) -> List[Tuple[int, str]]:
        """Blocking allocation; returns [(grant_id, servant_location)].

        May return fewer grants than requested (reference semantics).
        Returns [] when no eligible servant frees up within timeout_s.
        ``tenant`` attributes minted grants to a verified tenant for
        budget/provenance accounting ("" = untenanted legacy path).
        Raises DispatcherFailed once a policy failure stopped the
        dispatcher.
        """
        env_id = self._envs.intern(env_digest)
        if env_id is None:
            return []
        with self._lock:
            self._raise_if_failed_locked()
            now = self._clock.now()
            req = _Pending(
                env_id=env_id,
                env_digest=env_digest,
                min_version=min_version,
                requestor_slot=self._requestor_slot_locked(requestor),
                requestor=requestor,
                tenant=tenant,
                lease_s=lease_s,
                immediate_left=max(0, immediate),
                prefetch_left=max(0, prefetch),
                deadline=now + timeout_s,
                enqueued_at=now,
            )
            if req.immediate_left + req.prefetch_left == 0:
                return []
            self._pending.append(req)
            self._work.notify_all()
            lead = self._inline_dispatch and not self._inline_busy
            if lead:
                self._inline_busy = True
        if lead:
            # Inline-leader fast path: resolve the backlog on THIS
            # thread (any requests that arrived meanwhile ride the same
            # cycle).  Unsatisfied remainders fall back to the dispatch
            # thread, which was notified above.
            try:
                self._run_cycle()
            except Exception as e:
                self._fail(e)
            finally:
                with self._lock:
                    self._inline_busy = False
        if not req.done.is_set():
            req.done.wait(timeout=timeout_s + 1.0)
        with self._lock:
            # From here on a racing apply phase must not issue us grants
            # we'd never see (they would leak the servant's capacity).
            req.abandoned = True
            if req in self._pending:
                self._pending.remove(req)
            self._raise_if_failed_locked()
            return [(g.grant_id, g.servant_location) for g in req.grants]

    def submit_wait_for_starting_new_task(
        self,
        env_digest: str,
        *,
        min_version: int = 0,
        requestor: str = "",
        immediate: int = 1,
        prefetch: int = 0,
        lease_s: float = 15.0,
        timeout_s: float = 5.0,
        tenant: str = "",
        on_done: Callable,
    ) -> None:
        """Parked-continuation twin of wait_for_starting_new_task (the
        aio front end's long-poll path): enqueue the request and return
        immediately; ``on_done`` fires exactly once with
        [(grant_id, servant_location)] — from the completing thread
        (dispatch cycle, pipelined drain, the deadline sweep, stop or a
        policy failure), never under the dispatcher lock.  A parked
        client costs this pending entry, not a thread.  Raises
        DispatcherFailed, as the blocking wait does, once a policy
        failure stopped the dispatcher; a request pending when the
        failure struck fires with what it got, and its caller reads
        ``failure``.

        The inline-leader fast path applies here as it does to blocking
        waiters: the submitting thread (the event loop) runs the cycle
        itself when no cycle is in flight, so an uncontended grant
        completes — callback fired — within this call.  The loop is
        held for that cycle; in pipelined mode (the card's default)
        there is no inline leader and the dispatch thread fires the
        continuation."""
        env_id = self._envs.intern(env_digest)
        if env_id is None:
            on_done([])
            return
        with self._lock:
            self._raise_if_failed_locked()
            now = self._clock.now()
            req = _Pending(
                env_id=env_id,
                env_digest=env_digest,
                min_version=min_version,
                requestor_slot=self._requestor_slot_locked(requestor),
                requestor=requestor,
                tenant=tenant,
                lease_s=lease_s,
                immediate_left=max(0, immediate),
                prefetch_left=max(0, prefetch),
                deadline=now + timeout_s,
                enqueued_at=now,
                on_done=on_done,
            )
            lead = False
            if req.immediate_left + req.prefetch_left == 0 \
                    or self._stopping:
                req = None
            else:
                self._pending.append(req)
                lead = self._inline_dispatch and not self._inline_busy
                if lead:
                    self._inline_busy = True
                else:
                    self._work.notify_all()
        if req is None:
            on_done([])
            return
        if lead:
            # Leading inline: the notify is deferred until we know the
            # cycle left work behind — waking the dispatch thread just
            # to find the leader already did everything costs a context
            # switch on every uncontended grant call.  The leader
            # DRAINS: requests that arrived mid-cycle (they could not
            # lead) are served by the leader's next pass; the drain
            # stops when a pass stops producing (capacity-blocked
            # parked requests belong to the dispatch thread's deadline
            # machinery, not a spin).
            try:
                for _ in range(8):
                    issued = self._run_cycle()
                    with self._lock:
                        more = bool(self._pending)
                    if not issued or not more:
                        break
            except Exception as e:
                self._fail(e)
            finally:
                with self._lock:
                    self._inline_busy = False
                    if self._pending:
                        self._work.notify_all()

    def _fire_async_done(self) -> None:
        """Deliver completed parked requests' grants to their
        continuations.  Callbacks run outside the dispatcher lock (they
        typically hop onto an event loop); abandoned is set first so a
        racing pipelined drain can never issue into a request whose
        grants were already reported."""
        with self._lock:
            if not self._async_done:
                return
            fired, self._async_done = self._async_done, []
            batches = []
            for req in fired:
                req.abandoned = True
                batches.append((req.on_done,
                                [(g.grant_id, g.servant_location)
                                 for g in req.grants]))
                req.on_done = None
        for cb, grants in batches:
            try:
                cb(grants)
            except Exception:
                logger.exception("parked grant continuation failed")

    def _complete_parked_locked(self) -> None:
        """Move every parked request off the pending queue into the fire
        list (stop, policy failure): a parked continuation must not
        dangle.  Each fires with whatever grants it accumulated."""
        for req in self._pending:
            if req.on_done is not None:
                req.done.set()
                self._async_done.append(req)
        self._pending = [r for r in self._pending if r.on_done is None]

    def _raise_if_failed_locked(self) -> None:
        if self.failure is not None:
            raise DispatcherFailed(
                f"dispatcher stopped after a policy failure: "
                f"{self.failure!r}") from self.failure

    def _fail(self, exc: BaseException) -> None:
        """Stop serving after a policy failure: log it, wake every
        waiter (they raise DispatcherFailed) and end the dispatch loop.
        Grants already issued stay valid; nothing degrades to another
        policy."""
        logger.error("dispatch policy failed; stopping the dispatcher",
                     exc_info=exc)
        with self._lock:
            if self.failure is None:
                self.failure = exc
            self._stopping = True
            for req in self._pending:
                req.done.set()
            self._complete_parked_locked()
            self._work.notify_all()
        self._fire_async_done()

    def keep_task_alive(
        self, grant_ids: Sequence[int], next_keep_alive_s: float
    ) -> List[bool]:
        now = self._clock.now()
        out = []
        with self._lock:
            for gid in grant_ids:
                g = self._grants.get(gid)
                if g is None or g.zombie_since is not None:
                    out.append(False)
                    continue
                g.expires_at = now + next_keep_alive_s
                out.append(True)
        return out

    def free_task(self, grant_ids: Sequence[int]) -> None:
        with self._lock:
            for gid in grant_ids:
                g = self._grants.get(gid)
                if g is not None:
                    self._release_grant_locked(g)
            # Capacity arrival only matters to a parked request; waking
            # the dispatch thread with nothing pending is a pure
            # context-switch tax (it costs the serving path its GIL
            # slice on small hosts).
            # While an inline leader is mid-cycle the wake is deferred
            # too: the leader re-checks pending on exit and notifies
            # then, so the capacity cannot be lost — but the dispatch
            # thread no longer contends for the lock the cycle holds.
            if self._pending and not self._inline_busy:
                self._work.notify_all()

    def get_running_tasks(self) -> List[_Grant]:
        with self._lock:
            return [g for g in self._grants.values()
                    if g.zombie_since is None]

    # ------------------------------------------------------------------
    # Admission control (overload ladder).
    # ------------------------------------------------------------------

    def admission_check(self, immediate: int = 1,
                        prefetch: int = 0,
                        requestor: str = "",
                        tenant: str = "",
                        tier: str = "") -> AdmissionDecision:
        """Rule on one grant request BEFORE it queues.  Called by
        SchedulerService.WaitForStartingTask; cheap enough for the
        grant hot path (one cached-capacity read + a pending-list sum
        under the lock, ladder bookkeeping under its leaf lock).
        ``requestor`` exists for surface parity with the shard router
        (which routes the check to the requestor's home shard); a
        single dispatcher has one ladder and ignores it.

        Tenancy order matters: the per-tenant budget is ruled on FIRST
        and answers with a native FLOW_REJECT that never touches the
        ladder — an over-budget tenant's refused demand must not press
        the global signal and degrade everyone else.  The ladder rules
        second, and the tenant's TIER then only ever *escalates* the
        verdict (apply_tier)."""
        del requestor
        clock = self._clock
        t0 = clock.now()
        with self._lock:
            util, cap = self._utilization_locked(t0)
            over = (tenant != ""
                    and self._tenant_over_budget_locked(tenant, immediate))
        if over:
            with self._lock:
                self._bump_tenant_locked(tenant, "rejected_over_budget")
            decision = AdmissionDecision(
                rung=self.admission.rung(), flow=FLOW_REJECT,
                retry_after_ms=500, prefetch_allowed=False, signal=util)
            self.stage_timer.record("admission", clock.now() - t0)
            return decision
        decision = self.admission.decide(util, cap, immediate, prefetch,
                                         clock.now())
        if tenant != "" or tier != "":
            shaped = apply_tier(decision, tier)
            if shaped.flow != decision.flow and tenant != "":
                with self._lock:
                    self._bump_tenant_locked(tenant, "shed_by_tier")
            decision = shaped
        self.stage_timer.record("admission", clock.now() - t0)
        return decision

    def _tenant_over_budget_locked(self, tenant: str,
                                   immediate: int) -> bool:
        """Budget verdict under the dispatcher lock: outstanding comes
        from the ledger (exact), queued demand is summed live from the
        pending table — no shadow counter that could leak on one of the
        many pending-exit paths."""
        spec = (self._tenant_directory.get(tenant)
                if self._tenant_directory is not None else None)
        if spec is None:
            return False
        if spec.max_outstanding and (
                self.tenant_ledger.outstanding(tenant) + immediate
                > spec.max_outstanding):
            return True
        if spec.max_queued and sum(
                r.immediate_left for r in self._pending
                if r.tenant == tenant and not r.abandoned
                ) >= spec.max_queued:
            return True
        return False

    def _bump_tenant_locked(self, tenant: str, counter: str) -> None:
        per = self._stats_by_tenant.setdefault(
            tenant, {"granted": 0, "rejected_over_budget": 0,
                     "shed_by_tier": 0})
        per[counter] += 1

    def admission_rung(self) -> int:
        """Current overload-ladder rung, exported for the replication
        journal and the federation spillover check (same accessor on
        ShardRouter, where it is the max over shards)."""
        return self.admission.rung()

    def restore_admission_rung(self, rung: int) -> None:
        """Warm-standby takeover: restart the ladder at the journaled
        rung so the promoted scheduler does not greet the backlog that
        killed its predecessor at RUNG_NORMAL."""
        self.admission.restore_rung(rung, self._clock.now())

    def load_signal(self) -> LoadSignal:
        """The admission load signal, exported for the shard router's
        steal decision: demand = outstanding grants + queued immediate;
        free capacity is what a donor shard could give away right now.
        Same definitions as _utilization_locked — one signal, two
        consumers (ladder and steal), so they can never disagree about
        what "overloaded" means."""
        with self._lock:
            now = self._clock.now()
            cap = self._capacity_total_locked(now)
            outstanding = len(self._grants)
            queued = sum(r.immediate_left for r in self._pending)
        util = (outstanding + queued) / cap if cap > 0 else 0.0
        return LoadSignal(
            capacity=cap, outstanding=outstanding,
            queued_immediate=queued, utilization=util,
            free=max(0, cap - outstanding))

    def pool_load_arrays(self):
        """(alive, effective_capacity, running) copies for the shard
        router's cross-shard load summary (parallel/mesh.py:
        shard_load_summary).  One O(S) vectorized copy under the lock;
        callers own the result."""
        with self._lock:
            return (self._arr_alive.copy(),
                    self._effective_capacity_at_locked(slice(None)),
                    self._arr_running.copy())

    def _utilization_locked(self, now: float) -> Tuple[float, int]:
        """(demand / capacity, capacity).  Demand counts every
        outstanding grant — zombies included, they still occupy servant
        capacity — plus queued immediate requests."""
        cap = self._capacity_total_locked(now)
        if cap <= 0:
            return 0.0, 0
        pending_imm = sum(r.immediate_left for r in self._pending)
        return (len(self._grants) + pending_imm) / cap, cap

    def _capacity_total_locked(self, now: float) -> int:
        """Total effective pool capacity, cached for 0.5s — the
        admission signal is coarse by design and must not put a
        full-array reduction on every grant request at 5k req/s."""
        if now - self._cap_total_at > 0.5 or self._cap_total_at > now:
            self._cap_total_at = now
            foreign = np.maximum(self._arr_load - self._arr_running, 0)
            eff = np.minimum(self._arr_cap_rep,
                             self._arr_nprocs - foreign)
            eff = np.where(self._arr_accepting & self._arr_mem_ok,
                           np.maximum(eff, 0), 0)
            self._cap_total = int(eff.sum())
        return self._cap_total

    # ------------------------------------------------------------------
    # Timers.
    # ------------------------------------------------------------------

    def on_expiration_timer(self) -> None:
        """1s-cadence sweep: expire servants, zombify expired grants,
        orphan-sweep grants on dead servants."""
        now = self._clock.now()
        with self._lock:
            # Staged renewals land before the sweep judges leases.
            self._flush_heartbeats_locked()
            for slot, servant in enumerate(self._slots):
                if servant is not None and servant.expires_at <= now:
                    self._drop_servant_locked(slot)
            for g in list(self._grants.values()):
                if g.zombie_since is None and g.expires_at <= now:
                    g.zombie_since = now
                    self._stats["expired_grants"] += 1
                elif g.zombie_since is not None and (
                    now - g.zombie_since > _ZOMBIE_TIMEOUT_S
                ):
                    self._release_grant_locked(g)
            # Parked adoptions whose servant never re-heartbeated by
            # the time the takeover grace closed are dead leases.
            if self._pending_adoptions and now >= self._adopt_until:
                self._pending_adoptions.clear()
            self._work.notify_all()
            util, cap = self._utilization_locked(now)
        # Outside the lock (the ladder's leaf lock must never nest
        # under the main one): periodic update lets the ladder step
        # down while no requests arrive to drive decide().
        self.admission.update(util, cap, self._clock.now())
        # Backstop delivery for parked continuations (normally fired by
        # the cycle that completed them).
        self._fire_async_done()

    # ------------------------------------------------------------------
    # The dispatch cycle.
    # ------------------------------------------------------------------

    def run_dispatch_cycle_for_testing(self) -> int:
        return self._run_cycle()

    def _adaptive_window(self) -> float:
        """Accumulation window scaled by backlog depth.

        A lone waiter dispatches immediately — a millisecond latency
        target leaves no room for a fixed sleep when
        there is nothing to batch.  As the backlog deepens toward
        `batch_target` the window grows to its configured maximum so
        one kernel call amortizes over a large batch; past the target
        the batch is already full and further waiting only adds
        latency, so the window stays capped.
        """
        if self._batch_window <= 0:
            return 0.0
        with self._lock:
            backlog = sum(
                r.immediate_left
                + (0 if r.first_cycle_done else r.prefetch_left)
                for r in self._pending
            )
        if backlog <= 1:
            return 0.0
        return self._batch_window * min(1.0, backlog / self._batch_target)

    def _dispatch_loop(self) -> None:
        while True:
            with self._lock:
                while not self._pending and not self._stopping:
                    self._work.wait(timeout=0.1)
                if self._stopping:
                    return
            window = self._adaptive_window()
            if window > 0:
                # Let a burst of requests accumulate into one kernel call.
                REAL_CLOCK.sleep(window)
            try:
                self._run_cycle()
            except Exception as e:
                # A device failure is not survived: retrying would keep
                # driving the same broken device, and a host fallback
                # would hide it.  Stop, and let every waiter see it.
                self._fail(e)
                return
            with self._lock:
                # Park until something can change the outcome — every
                # state change (new request, free_task, heartbeat,
                # expiration sweep) notifies _work; the timeout only
                # bounds deadline handling for parked waiters.
                if self._pending and not self._stopping:
                    self._work.wait(timeout=0.25)

    def _run_cycle(self) -> int:
        """One policy pass over the backlog; returns grants issued.

        Stage accounting (injectable clock; see utils/stagetimer.py):
        `snapshot` covers cycle setup under the lock (staged-heartbeat
        flush, deadline sweep, work-list build, prepared-snapshot
        publication), `policy` the kernel outside the lock, `apply` the
        locked validation/issue pass — the three sum exactly to
        `dispatch_cycle` (same timestamps), and each request's time
        from enqueue to its first cycle is `queue_wait`."""
        clock = self._clock
        snap = None
        try:
            with self._lock:
                t0 = clock.now()
                self._flush_heartbeats_locked()
                self._expire_pending_locked(t0)
                if not self._pending:
                    return 0
                work: List[Tuple[_Pending, bool]] = []  # (req, is_prefetch)
                queue_waits: List[float] = []
                for req in self._pending:
                    if not req.queue_wait_recorded:
                        req.queue_wait_recorded = True
                        queue_waits.append(t0 - req.enqueued_at)
                    for _ in range(req.immediate_left):
                        work.append((req, False))
                    if not req.first_cycle_done:
                        for _ in range(req.prefetch_left):
                            work.append((req, True))
                if not work:
                    return 0
                snap = self._snapshot_locked()
                snap_generation = self._slot_generation.copy()
                reqs = [
                    AssignRequest(r.env_id, r.min_version, r.requestor_slot)
                    for r, _ in work
                ]
                t1 = clock.now()

            picks = self._policy.assign(snap, reqs)
            t2 = clock.now()

            issued = 0
            cap_cache: Dict[int, Optional[Tuple[int, int, int]]] = {}
            with self._lock:
                self._release_snapshot_locked(snap)
                snap = None
                now = clock.now()
                for (req, is_prefetch), pick in zip(work, picks):
                    if self._try_issue_locked(req, is_prefetch, int(pick),
                                              snap_generation, cap_cache,
                                              now):
                        issued += 1
                # Prefetch never waits — but only for requests that
                # actually participated in this cycle; one that arrived
                # mid-assign keeps its prefetch for the next cycle.
                participated = {id(r) for r, _ in work}
                for req in self._pending:
                    if id(req) in participated:
                        req.first_cycle_done = True
                        req.prefetch_left = 0
                self._finish_satisfied_locked(clock.now())
            t3 = clock.now()
            timer = self.stage_timer
            for qw in queue_waits:
                timer.record("queue_wait", qw)
            timer.record("snapshot", t1 - t0)
            timer.record("policy", t2 - t1)
            timer.record("apply", t3 - t2)
            timer.record("dispatch_cycle", t3 - t0)
            return issued
        finally:
            if snap is not None:
                with self._lock:
                    self._release_snapshot_locked(snap)
            # Parked continuations completed by this cycle fire here —
            # on the granting thread, right after the apply phase, with
            # no waiter-thread wakeup in between.
            self._fire_async_done()

    def _try_issue_locked(self, req, is_prefetch: bool, pick: int,
                          snap_generation, cap_cache, now: float,
                          ) -> Optional[bool]:
        """Validate one policy pick against CURRENT state and issue the
        grant.  Returns True = issued, False = rejected (the pick was a
        real slot but state moved), None = nothing to do (NO_PICK).
        Shared by the sync apply phase and the pipelined drain — the
        validation semantics must be one definition."""
        if pick == NO_PICK:
            return None
        if req.abandoned:
            return False
        # Concurrent cycles (inline leader + dispatch thread) may both
        # carry work entries for the same request; the counters gate so
        # a request is never over-granted.
        if (req.prefetch_left if is_prefetch else req.immediate_left) <= 0:
            return False
        servant = self._slots[pick] if pick < len(self._slots) else None
        if servant is None:
            return False  # died between snapshot and apply
        # Re-validate at apply time; the snapshot may be stale.  A slot
        # recycled to a different machine while the policy ran unlocked
        # invalidates the whole scoring decision (envs, version gate,
        # self-avoidance were all judged against the OLD occupant) —
        # the generation check rejects it wholesale.  Capacity is
        # re-checked because other grants may have applied meanwhile.
        if self._slot_generation[pick] != snap_generation[pick]:
            return False
        # Capacity re-check, split into a per-cycle static part (gate
        # flags + reported numbers, cached — ~512 grants per cycle
        # often land on far fewer slots) and the running-count-dependent
        # arithmetic which must track every grant applied in THIS
        # cycle.  Semantics identical to _effective_capacity_locked.
        static = cap_cache.get(pick, False)
        if static is False:
            info = servant.info
            static = cap_cache[pick] = (
                (info.capacity, info.num_processors, info.current_load)
                if info.not_accepting_reason == 0
                and info.memory_available >= self._min_memory
                else None)
        if static is None:
            return False
        cap, nprocs, load = static
        n_running = len(servant.running_grants)
        if n_running >= min(cap, nprocs - max(0, load - n_running)):
            return False
        g = _Grant(
            grant_id=self._next_grant_id,
            slot=pick,
            servant_location=servant.info.location,
            env_digest=req.env_digest,
            expires_at=now + req.lease_s,
            requestor=req.requestor,
            tenant=req.tenant,
        )
        self._next_grant_id += self._grant_id_stride
        self._grants[g.grant_id] = g
        servant.running_grants.add(g.grant_id)
        self._arr_running[pick] += 1
        self._mark_slot_dirty_locked(pick)
        req.grants.append(g)
        if is_prefetch:
            # Clamped: a drained earlier ticket may already have zeroed
            # prefetch_left while this entry was still in flight.
            req.prefetch_left = max(0, req.prefetch_left - 1)
        else:
            req.immediate_left -= 1
        self._stats["granted"] += 1
        if g.tenant:
            self.tenant_ledger.charge(g.tenant)
            self._bump_tenant_locked(g.tenant, "granted")
        return True

    # ------------------------------------------------------------------
    # The pipelined dispatch loop (device-resident running chain).
    #
    # The sync loop above blocks inside policy.assign() for the full
    # host->device->host round-trip every cycle; fine when the device
    # sits on the host's PCIe, fatal when it is tens of ms away.  Here
    # each cycle LAUNCHES without waiting (the policy chains `running`
    # on device) and the picks of completed launches are applied as
    # their async D2H copies land, up to `pipeline_depth` in flight.
    # Host-side mutations between launches ride the next launch as a
    # delta upload (see policy.TorchGroupedPolicy stream_* docs).
    # ------------------------------------------------------------------

    def _pipelined_loop(self) -> None:
        import collections

        policy = self._policy
        tickets: "collections.deque" = collections.deque()
        # Grants issued / tickets drained since the in-flight window was
        # last empty: the starvation park below must look at the WHOLE
        # window, not just the last ticket (one racy zero-grant ticket
        # after a productive one is not starvation).
        window_issued = 0
        window_drains = 0
        try:
            # Seed the chain from host truth.  Full-copy snapshot: the
            # copy's lifetime is the policy's to manage.
            with self._lock:
                if self._stopping:
                    return
                snap = self._snapshot_full_locked()
                self._pipe_active = True
                self._pipe_adj[:] = 0
                self._pipe_resets.clear()
                # The full upload below covers every slot.
                self._stream_dirty.clear()
            policy.stream_begin(snap)
            resident = getattr(policy, "supports_resident", False)
            while True:
                # Apply whatever has landed; never hold more than depth.
                while tickets and (
                        len(tickets) > self._pipeline_depth
                        or policy.stream_ready(tickets[0][0])):
                    window_issued += self._drain_ticket(*tickets.popleft())
                    window_drains += 1
                if not tickets and window_drains:
                    if window_issued == 0:
                        # The whole in-flight window produced zero
                        # grants (every pick rejected or NO_PICK) — an
                        # unsatisfiable backlog.  Relaunching
                        # immediately would burn an O(S) snapshot plus
                        # a device launch per round trip until deadlines
                        # expire; park like the sync loop until a state
                        # change (heartbeat/free/queue) or a timeout.
                        with self._lock:
                            if self._stopping:
                                break
                            self._work.wait(timeout=0.25)
                    window_issued = 0
                    window_drains = 0
                with self._lock:
                    if self._stopping:
                        break
                    launch = self._select_stream_work_locked()
                    idle = launch is None and not tickets
                    if idle and not self._async_done:
                        self._work.wait(timeout=0.1)
                # Deadline sweeps inside the selection may have
                # completed parked requests; deliver before continuing.
                self._fire_async_done()
                if idle:
                    continue
                if launch is None:
                    # Nothing new to launch: finish the oldest in-flight
                    # launch so its waiters wake (blocking here costs
                    # one round trip and there is nothing else to do).
                    window_issued += self._drain_ticket(*tickets.popleft())
                    window_drains += 1
                    continue
                work, descr, snap, gen, adj, resets, lid, dirty = launch
                # The host-side cost of the policy stage: delta assembly
                # plus an asynchronous launch; the device round trip
                # itself is pipelined away.
                t_pol = self._clock.now()
                try:
                    if resident:
                        ticket = policy.stream_launch(snap, descr, adj,
                                                      resets, dirty=dirty)
                    else:
                        ticket = policy.stream_launch(snap, descr, adj,
                                                      resets)
                except BaseException:
                    with self._lock:
                        self._release_snapshot_locked(snap)
                    raise
                self.stage_timer.record("policy",
                                        self._clock.now() - t_pol)
                # The prepared-snapshot lease rides the ticket until it
                # drains.
                tickets.append((ticket, work, gen, lid, snap))
            # Shutdown: drain what's left so accounting stays consistent
            # for anyone inspecting state after stop().
            while tickets:
                self._drain_ticket(*tickets.popleft())
        except Exception as e:
            # A device error poisons the running chain and is not
            # survived: the in-flight launches are dropped with the
            # dispatcher, and every waiter sees the error.
            with self._lock:
                for _, _, _, _, held in tickets:
                    self._release_snapshot_locked(held)
            tickets.clear()
            self._fail(e)

    def _select_stream_work_locked(self):
        """Pick the next launch's work under the chunk caps (at most
        max_groups descriptor runs, at most _TASK_CAP entries — the
        policy's warmed shape ladder).  Entries already in flight are
        excluded; prefetch is all-or-nothing (it is opportunistic and
        must never outlive the first cycle)."""
        now = self._clock.now()
        self._flush_heartbeats_locked()
        self._expire_pending_locked(now)
        for req in self._pending:
            if not req.queue_wait_recorded:
                req.queue_wait_recorded = True
                self.stage_timer.record("queue_wait", now - req.enqueued_at)
        max_groups = getattr(self._policy, "_max_groups", 64)
        task_cap = getattr(self._policy, "_TASK_CAP", 2048)
        work: List[Tuple[_Pending, bool]] = []
        descr: List[List[int]] = []

        def emit(req, is_prefetch: bool, n: int) -> int:
            """Append up to n entries of req; returns how many fit."""
            key = (req.env_id, req.min_version, req.requestor_slot)
            taken = 0
            while n > 0 and len(work) < task_cap:
                if not (descr and (descr[-1][0], descr[-1][1],
                                   descr[-1][2]) == key):
                    if len(descr) >= max_groups:
                        break
                    descr.append([key[0], key[1], key[2], 0])
                t = min(n, task_cap - len(work))
                descr[-1][3] += t
                work.extend([(req, is_prefetch)] * t)
                taken += t
                n -= t
            return taken

        for req in self._pending:
            n_imm = max(0, req.immediate_left - req.inflight_imm)
            req.inflight_imm += emit(req, False, n_imm)
            if (not req.prefetch_launched and not req.first_cycle_done
                    and req.prefetch_left > 0
                    and len(work) + req.prefetch_left <= task_cap
                    and len(descr) < max_groups):
                took = emit(req, True, req.prefetch_left)
                if took == req.prefetch_left:
                    req.inflight_pre += took
                    req.prefetch_launched = True
                else:   # didn't all fit: roll back, skip prefetch
                    del work[len(work) - took:]
                    descr[-1][3] -= took
                    if descr[-1][3] == 0:
                        descr.pop()
            if len(work) >= task_cap:
                break
        if not work:
            return None
        t_snap = self._clock.now()
        snap = self._snapshot_locked()
        self.stage_timer.record("snapshot", self._clock.now() - t_snap)
        gen = self._slot_generation.copy()
        adj = self._pipe_adj.copy()
        self._pipe_adj[:] = 0
        resets = dict(self._pipe_resets)
        self._pipe_resets.clear()
        lid = self._pipe_launch_seq
        self._pipe_launch_seq += 1
        for slot in resets:
            self._pipe_reset_barrier[slot] = lid
        dirty = sorted(self._stream_dirty)
        self._stream_dirty.clear()
        return (work, [tuple(d) for d in descr], snap, gen, adj,
                resets, lid, dirty)

    def _drain_ticket(self, ticket, work, snap_generation, lid,
                      snap=None) -> int:
        """Collect one completed launch and apply its picks."""
        return self.apply_stream_picks(
            self._policy.stream_collect(ticket), work, snap_generation,
            lid, snap)

    # -- external stream driving (the fused shard router) -----------------
    #
    # The router's one-launch-for-N-shards cycle drives each shard's
    # stream machinery from ITS thread: it prepares every shard's
    # launch, runs ONE fused device step, and routes each shard's picks
    # back through apply_stream_picks — the SAME validation/issue/
    # correction path the in-process pipelined loop uses, so grant
    # bookkeeping semantics cannot fork.  Requires
    # start_dispatch_thread=False (exactly one caller drives a
    # dispatcher's stream).

    def begin_external_stream(self) -> PoolSnapshot:
        """Arm the stream delta machinery (adj/reset/dirty tracking)
        and return a full snapshot to seed the device chain from."""
        with self._lock:
            if self._thread is not None:
                raise RuntimeError(
                    "external stream driving needs "
                    "start_dispatch_thread=False: the dispatch thread "
                    "already drives this dispatcher's stream")
            self._pipe_active = True
            self._pipe_adj[:] = 0
            self._pipe_resets.clear()
            self._stream_dirty.clear()
            return self._snapshot_full_locked()

    def prepare_stream_launch(self):
        """One locked launch preparation: (work, descr, snap, gen, adj,
        resets, lid, dirty) or None when nothing is launchable.  The
        snapshot lease rides the tuple until apply_stream_picks (pass
        it as `snap=`) or release_stream_launch."""
        with self._lock:
            return self._select_stream_work_locked()

    def release_stream_launch(self, launch) -> None:
        """Roll back a prepared launch that never reached the device
        (mirror of the pipelined loop's error path)."""
        with self._lock:
            work, _, snap, _, _, _, _, _ = launch
            self._release_snapshot_locked(snap)
            for req, is_prefetch in work:
                if is_prefetch:
                    req.inflight_pre -= 1
                    req.prefetch_launched = False
                else:
                    req.inflight_imm -= 1

    def apply_stream_picks(self, picks, work, snap_generation, lid,
                           snap=None) -> int:
        """Apply one completed launch: validate each pick against
        current state, issue grants, and convert host rejections into
        running-chain corrections for the next launch."""
        t0 = self._clock.now()
        issued = 0
        cap_cache: Dict[int, Optional[Tuple[int, int, int]]] = {}
        with self._lock:
            if snap is not None:
                self._release_snapshot_locked(snap)
            now = self._clock.now()
            for (req, is_prefetch), pick in zip(work, picks):
                if is_prefetch:
                    req.inflight_pre -= 1
                else:
                    req.inflight_imm -= 1
                ok = self._try_issue_locked(req, is_prefetch, int(pick),
                                            snap_generation, cap_cache,
                                            now)
                if ok:
                    issued += 1
                elif ok is False and int(pick) != NO_PICK:
                    # The device counted this grant in its chain; the
                    # host refused it.  Correct the chain — unless a
                    # LATER launch already reset this slot absolutely
                    # (the reset erased the phantom grant with
                    # everything else).
                    if self._pipe_reset_barrier[int(pick)] <= lid:
                        self._pipe_adj[int(pick)] -= 1
            participated = {id(r) for r, _ in work}
            for req in self._pending:
                if id(req) in participated:
                    req.first_cycle_done = True
                    # A LATER in-flight ticket may still carry this
                    # request's prefetch entries; zeroing now would
                    # drive prefetch_left negative when they land.
                    if req.inflight_pre == 0:
                        req.prefetch_left = 0
            self._finish_satisfied_locked(self._clock.now())
            self._work.notify_all()
        self.stage_timer.record("apply", self._clock.now() - t0)
        self._fire_async_done()
        return issued

    # ------------------------------------------------------------------
    # Locked helpers.
    # ------------------------------------------------------------------

    def _requestor_slot_locked(self, requestor: str) -> int:
        """Map a delegate's observed peer address to its servant slot, if
        the same machine also serves (self-avoidance: reference
        task_dispatcher.cc:370-379).  Delegates call from an ephemeral
        port, so match on the IP alone."""
        if not requestor:
            return -1
        slot = self._by_location.get(requestor)
        if slot is not None:
            return slot
        slots = self._by_ip.get(requestor.rsplit(":", 1)[0])
        return min(slots) if slots else -1

    def _expire_pending_locked(self, now: float) -> None:
        still = []
        for req in self._pending:
            # A prefetch-only request (immediate=0) rides exactly one
            # cycle — which zeroes prefetch_left — before completing;
            # sweeping it on immediate_left alone would expire it before
            # any cycle could allocate its prefetch.
            prefetch_pending = (req.prefetch_left > 0
                                and not req.first_cycle_done)
            if (req.immediate_left <= 0 and not prefetch_pending) \
                    or now >= req.deadline:
                req.done.set()
                if req.on_done is not None:
                    # Parked continuation: queue the fire; the caller's
                    # unlocked epilogue (_fire_async_done) delivers it.
                    self._async_done.append(req)
            else:
                still.append(req)
        self._pending[:] = still

    def _finish_satisfied_locked(self, now: float) -> None:
        self._expire_pending_locked(now)

    def _refresh_slot_arrays_locked(self, slot: int,
                                    envs_too: bool = False) -> None:
        """Bring the pool arrays in line with slot state.  O(1) (plus
        the env row when requested); called on heartbeat upserts and
        slot drops — NOT on grants/frees, which only adjust
        _arr_running.  The pool epoch (the device policies' cache key
        for their resident static arrays) advances ONLY when a
        device-cached field actually changes: at a 1s heartbeat cadence
        with thousands of servants, load/memory/capacity churn every
        beat but alive/dedicated/version/envs almost never do — an
        unconditional bump would defeat the cache in exactly the
        production scenario it exists for."""
        servant = self._slots[slot]
        if servant is None:
            self._mark_slot_dirty_locked(slot)
            if self._arr_alive[slot]:
                self._pool_epoch += 1
            self._arr_alive[slot] = False
            self._arr_cap_rep[slot] = 0
            self._arr_nprocs[slot] = 0
            self._arr_load[slot] = 0
            self._arr_mem_ok[slot] = False
            self._arr_accepting[slot] = False
            self._arr_running[slot] = 0
            self._arr_dedicated[slot] = False
            self._arr_version[slot] = 0
            self._arr_env[slot] = 0
            return
        info = servant.info
        mem_ok = info.memory_available >= self._min_memory
        accepting = info.not_accepting_reason == 0
        n_running = len(servant.running_grants)
        # Steady-state beats mostly repeat the previous report; the
        # prepared snapshot buffers are only dirtied on a REAL change,
        # otherwise a 5k/s fleet re-dirties the whole pool every sweep
        # and every snapshot degenerates to a full rebuild.
        dyn_changed = (
            int(self._arr_cap_rep[slot]) != info.capacity
            or int(self._arr_nprocs[slot]) != info.num_processors
            or int(self._arr_load[slot]) != info.current_load
            or bool(self._arr_mem_ok[slot]) != mem_ok
            or bool(self._arr_accepting[slot]) != accepting
            or int(self._arr_running[slot]) != n_running)
        # Re-uploaded every cycle (capacity/running vectors): no epoch.
        self._arr_cap_rep[slot] = info.capacity
        self._arr_nprocs[slot] = info.num_processors
        self._arr_load[slot] = info.current_load
        self._arr_mem_ok[slot] = mem_ok
        self._arr_accepting[slot] = accepting
        self._arr_running[slot] = n_running
        # Device-cached statics: epoch bump only on change.
        changed = (not self._arr_alive[slot]
                   or bool(self._arr_dedicated[slot]) != info.dedicated
                   or int(self._arr_version[slot]) != info.version)
        self._arr_alive[slot] = True
        self._arr_dedicated[slot] = info.dedicated
        self._arr_version[slot] = info.version
        if envs_too:
            row = np.zeros(self._env_words, np.uint32)
            for digest in info.env_digests:
                env_id = self._envs.lookup(digest)
                if env_id is not None:
                    row[env_id >> 5] |= np.uint32(1 << (env_id & 31))
            if not np.array_equal(row, self._arr_env[slot]):
                changed = True
                self._arr_env[slot] = row
        if changed:
            self._pool_epoch += 1
        if changed or dyn_changed:
            self._mark_slot_dirty_locked(slot)

    def _effective_capacity_locked(self, servant: _Servant) -> int:
        """Reference GetCapacityAvailable (task_dispatcher.cc:283-313):
        zero if not accepting or memory-starved, else reported capacity
        minus load not attributable to tasks we placed there."""
        info = servant.info
        if info.not_accepting_reason != 0:
            return 0
        if info.memory_available < self._min_memory:
            return 0
        foreign_load = max(
            0, info.current_load - len(servant.running_grants)
        )
        return max(0, min(info.capacity, info.num_processors - foreign_load))

    def _mark_slot_dirty_locked(self, slot: int) -> None:
        for buf in self._snap_buffers:
            buf.dirty.add(slot)
        if self._pipe_active:
            self._stream_dirty.add(slot)

    def _effective_capacity_at_locked(self, idx: np.ndarray) -> np.ndarray:
        """Vectorized _effective_capacity_locked over a slot index
        vector: zero unless accepting with enough memory, else
        min(reported, nprocs - foreign load)."""
        foreign = np.maximum(self._arr_load[idx] - self._arr_running[idx], 0)
        effective = np.minimum(self._arr_cap_rep[idx],
                               self._arr_nprocs[idx] - foreign)
        return np.where(self._arr_accepting[idx] & self._arr_mem_ok[idx],
                        np.maximum(effective, 0), 0).astype(np.int32)

    def _snapshot_full_locked(self) -> PoolSnapshot:
        """From-scratch snapshot: six full-array copies under the lock.
        Kept as the fallback when every prepared buffer is leased and
        as the oracle the incremental path is equivalence-tested
        against (tests/test_latency_breakdown.py)."""
        foreign = np.maximum(self._arr_load - self._arr_running, 0)
        effective = np.minimum(self._arr_cap_rep,
                               self._arr_nprocs - foreign)
        effective = np.where(self._arr_accepting & self._arr_mem_ok,
                             np.maximum(effective, 0), 0).astype(np.int32)
        return PoolSnapshot(
            self._arr_alive.copy(),
            effective,
            self._arr_running.copy(),
            self._arr_dedicated.copy(),
            self._arr_version.copy(),
            self._arr_env.copy(),
            epoch=self._pool_epoch,
        )

    def _snapshot_locked(self) -> PoolSnapshot:
        """Publish the prepared snapshot: bring one double-buffer up to
        date by touching ONLY the slots dirtied since that buffer last
        published (heartbeats, grants, frees, drops), instead of
        copying six pool arrays per cycle — at a 5-8k-slot pool the
        old full copy (env bitmap included) moved ~0.5MB under the
        dispatcher lock every cycle.  The returned snapshot's arrays
        are read-only until released (_release_snapshot_locked); the
        buffer is only mutated here, under the lock, while unleased."""
        buf = next((b for b in self._snap_buffers if not b.leased), None)
        if buf is None:
            if len(self._snap_buffers) >= self._max_snap_buffers:
                # Every buffer is in flight (deep pipeline): fall back
                # to a one-off full copy rather than grow unboundedly.
                return self._snapshot_full_locked()
            buf = _SnapBuffer(self.max_servants, self._env_words)
            self._snap_buffers.append(buf)
        s = self.max_servants
        if buf.full_rebuild or len(buf.dirty) * _SNAP_FULL_REBUILD_FRAC > s:
            np.copyto(buf.alive, self._arr_alive)
            foreign = np.maximum(self._arr_load - self._arr_running, 0)
            effective = np.minimum(self._arr_cap_rep,
                                   self._arr_nprocs - foreign)
            np.copyto(buf.capacity,
                      np.where(self._arr_accepting & self._arr_mem_ok,
                               np.maximum(effective, 0), 0))
            np.copyto(buf.running, self._arr_running)
            np.copyto(buf.dedicated, self._arr_dedicated)
            np.copyto(buf.version, self._arr_version)
            np.copyto(buf.env, self._arr_env)
            buf.full_rebuild = False
        elif buf.dirty:
            idx = np.fromiter(buf.dirty, np.int64, len(buf.dirty))
            buf.alive[idx] = self._arr_alive[idx]
            buf.capacity[idx] = self._effective_capacity_at_locked(idx)
            buf.running[idx] = self._arr_running[idx]
            buf.dedicated[idx] = self._arr_dedicated[idx]
            buf.version[idx] = self._arr_version[idx]
            buf.env[idx] = self._arr_env[idx]
        buf.dirty.clear()
        buf.leased = True
        snap = PoolSnapshot(
            buf.alive, buf.capacity, buf.running, buf.dedicated,
            buf.version, buf.env, epoch=self._pool_epoch,
        )
        snap._snap_buf = buf  # type: ignore[attr-defined]
        return snap

    def _release_snapshot_locked(self, snap: PoolSnapshot) -> None:
        buf = getattr(snap, "_snap_buf", None)
        if buf is not None:
            buf.leased = False
            snap._snap_buf = None  # type: ignore[attr-defined]

    def _drop_servant_locked(self, slot: int) -> None:
        servant = self._slots[slot]
        if servant is None:
            return
        # Orphan sweep: grants on a dead servant are unrecoverable.
        for gid in list(servant.running_grants):
            g = self._grants.pop(gid, None)
            if g is not None:
                servant.running_grants.discard(gid)
                if g.tenant:
                    self.tenant_ledger.release(g.tenant)
        del self._by_location[servant.info.location]
        ip = servant.info.location.rsplit(":", 1)[0]
        slots = self._by_ip.get(ip)
        if slots is not None:
            slots.discard(slot)
            if not slots:
                del self._by_ip[ip]
        self._slots[slot] = None
        self._free_slots.append(slot)
        self._refresh_slot_arrays_locked(slot)
        if self._pipe_active:
            # Slot identity changed: the device value is garbage for
            # any future occupant.  Overwrite absolutely on the next
            # launch and void pending per-grant corrections (the reset
            # subsumes them).
            self._pipe_resets[slot] = 0
            self._pipe_adj[slot] = 0

    def _release_grant_locked(self, g: _Grant) -> None:
        if self._grants.pop(g.grant_id, None) is not None and g.tenant:
            self.tenant_ledger.release(g.tenant)
        servant = self._slots[g.slot] if g.slot < len(self._slots) else None
        if servant is not None and servant.info.location == g.servant_location:
            if g.grant_id in servant.running_grants:
                servant.running_grants.discard(g.grant_id)
                self._arr_running[g.slot] -= 1
                self._mark_slot_dirty_locked(g.slot)
                if self._pipe_active:
                    # The device running chain counted this grant (it
                    # was issued through a drained launch); stream the
                    # free to the device with the next launch.
                    self._pipe_adj[g.slot] -= 1

    # ------------------------------------------------------------------

    def stop(self) -> None:
        with self._lock:
            self._stopping = True
            self._work.notify_all()
            # Parked continuations must not dangle past shutdown: hand
            # each whatever grants it accumulated (usually none).
            self._complete_parked_locked()
        self._fire_async_done()
        if self._thread is not None:
            self._thread.join(timeout=2)

    def inspect(self) -> dict:
        # Ladder snapshot BEFORE the main lock: its leaf lock must not
        # nest inside ours.
        admission = self.admission.inspect()
        with self._lock:
            self._flush_heartbeats_locked()
            servants = {}
            for servant in self._slots:
                if servant is None:
                    continue
                servants[servant.info.location] = {
                    "slot": servant.slot,
                    "capacity": servant.info.capacity,
                    "effective_capacity":
                        self._effective_capacity_locked(servant),
                    "running": len(servant.running_grants),
                    "dedicated": servant.info.dedicated,
                    "version": servant.info.version,
                    "envs": list(servant.info.env_digests),
                    "expires_at": servant.expires_at,
                }
            return {
                "policy": self._policy.name,
                # Device policies cache static pool arrays keyed on
                # this; a rapidly-advancing epoch with a stable fleet
                # means something is churning servant statics.
                "pool_epoch": self._pool_epoch,
                "servants": servants,
                "grants_outstanding": len(self._grants),
                "zombies": sum(1 for g in self._grants.values()
                               if g.zombie_since is not None),
                "pending_requests": len(self._pending),
                "stats": dict(self._stats),
                # Per-tenant grant/budget provenance; outstanding and
                # queued live in the ledger snapshot.
                "stats_by_tenant": {k: dict(v) for k, v
                                    in self._stats_by_tenant.items()},
                "tenant_budgets": self.tenant_ledger.inspect(),
                "failure": (None if self.failure is None
                            else repr(self.failure)),
                "envs_interned": len(self._envs),
                # Overload-ladder state (rung, signal, shed counters,
                # recent transitions).
                "admission": admission,
                # Grant-path stage percentiles.
                "latency_breakdown": self.stage_timer.percentiles(),
                # Stream health (stale-stream guard resyncs, last seen
                # epoch).
                "stream": (self._policy.stream_stats()
                           if hasattr(self._policy, "stream_stats")
                           else {}),
            }
