"""Warm-standby scheduler failover: lease-journal replication.

The port of yadcc_tpu/scheduler/replication.py; its journal JSON is
byte-for-byte the JAX package's, so either package's standby applies the
other's stream (tests/test_torch_replication.py).

A scheduler death should cost the fleet one renewal interval, not a
cold restart.  The active
scheduler streams an append-only journal of its *lease state* — servant
joins/leaves, grant issue/renew/free, admission-rung transitions — to a
standby over the ordinary RPC transport (``ytpu.ReplicationService/
Replicate``).  The standby applies entries to an in-memory mirror
(:class:`ReplicaState`); on active death it replays the mirror into a
fresh dispatcher, adopts the journaled grants, opens the adoption grace
window for anything the journal missed, restores the overload-ladder
rung, and starts serving.  The standby builds and warms its policy on
the card at boot (scheduler/entry.py), so the takeover replays into a
dispatcher whose kernels are already built and launched once.

Layering:

* :class:`LeaseJournal` — active side.  Bounded deque of ``(seq,
  entry)`` pairs over a compacted base snapshot; appended at the RPC
  call boundary by :class:`ReplicatingDispatcher`, AFTER the wrapped
  dispatcher call returns.  The journal lock is a leaf, never taken
  while a dispatcher lock is held, so journaling can never deadlock or
  slow the dispatch cycle.
* :class:`JournalStreamer` — active side.  Ships batches to the
  standby; empty batches double as stream-liveness heartbeats, so the
  standby's death detector measures *silence*, not traffic.
* :class:`ReplicationService` / :class:`StandbyScheduler` — standby
  side.  Until takeover the standby refuses scheduler RPCs fast
  (:class:`StandbyGate`): ``WaitForStartingTask`` answers a native
  ``FLOW_CONTROL_REJECT`` with ``retry_after_ms``, everything else
  fails with ``STATUS_NOT_SERVING`` carrying a ``retry-after-ms=N``
  hint that :func:`rpc.retry_after_ms_from_error` parses client-side.
* :class:`StandbyMonitor` — fires the takeover callback exactly once
  after the journal stream has been silent for ``silence_s``.

What the journal deliberately does NOT carry: grant expirations.  The
active's sweep releases leases locally without journaling; a grant that
expired just before takeover is adopted stale on the standby, gets a
fresh short adoption lease, is never renewed by its (gone) delegate,
and is swept within one zombie interval — a transient overcount that
self-heals, in exchange for a journal that only grows on real state
changes.
"""

from __future__ import annotations

import dataclasses
import json
import threading
from collections import defaultdict, deque
from typing import Callable, Deque, Dict, List, Optional, Sequence, Tuple

from .. import api
from ..common.backoff import Backoff
from ..rpc import STATUS_NOT_SERVING, Channel, RpcError, ServiceSpec
from ..utils.clock import REAL_CLOCK, Clock
from ..utils.logging import get_logger
from . import admission
from .task_dispatcher import TAKEOVER_GAP_SLACK, ServantInfo

logger = get_logger("scheduler.replication")

REPLICATION_SERVICE_NAME = "ytpu.ReplicationService"

# Default lease the takeover re-arms adopted grants with; matches the
# dispatcher's _ADOPTED_LEASE_S — long enough for the delegate's next
# KeepTaskAlive beat, short enough that stale adoptions die fast.
_TAKEOVER_GRANT_LEASE_S = 15.0
_TAKEOVER_SERVANT_LEASE_S = 10.0


class ReplicaState:
    """The standby's mirror of the active's lease state.

    Pure data + apply(); no locks (owners serialize access).  Everything
    is JSON-shaped so snapshots cross the wire as-is.
    """

    def __init__(self):
        self.servants: Dict[str, dict] = {}  # location -> {info, lease_s}
        self.grants: Dict[int, dict] = {}    # gid -> {location, env, requestor}
        self.rung = 0
        self.max_grant_id = 0
        self.seq = 0  # last applied journal sequence

    def apply(self, seq: int, entry: dict) -> None:
        op = entry["op"]
        if op == "servant":
            self.servants[entry["location"]] = {
                "info": entry["info"], "lease_s": entry["lease_s"]}
        elif op == "servant_leave":
            loc = entry["location"]
            self.servants.pop(loc, None)
            # The dispatcher releases a leaver's grants; mirror that.
            self.grants = {g: v for g, v in self.grants.items()
                           if v["location"] != loc}
        elif op == "issue":
            for gid, loc in entry["grants"]:
                self.grants[gid] = {"location": loc,
                                    "env": entry["env"],
                                    "requestor": entry["requestor"]}
                if gid > self.max_grant_id:
                    self.max_grant_id = gid
        elif op == "renew":
            pass  # liveness only; the mirror tracks existence, not expiry
        elif op == "free":
            for gid in entry["ids"]:
                self.grants.pop(gid, None)
        elif op == "rung":
            self.rung = entry["rung"]
        else:
            logger.warning("unknown journal op %r (newer active?)", op)
        self.seq = seq

    def to_json(self) -> str:
        return json.dumps({
            "servants": self.servants,
            "grants": {str(g): v for g, v in self.grants.items()},
            "rung": self.rung,
            "max_grant_id": self.max_grant_id,
            "seq": self.seq,
        })

    @classmethod
    def from_json(cls, blob: str) -> "ReplicaState":
        raw = json.loads(blob)
        st = cls()
        st.servants = dict(raw["servants"])
        st.grants = {int(g): v for g, v in raw["grants"].items()}
        st.rung = raw["rung"]
        st.max_grant_id = raw["max_grant_id"]
        st.seq = raw["seq"]
        return st


class LeaseJournal:
    """Append-only lease journal with snapshot compaction (active side).

    Entries older than the retention window are folded into a base
    :class:`ReplicaState`; a standby whose ack falls behind the base
    receives the snapshot plus the retained tail instead of a gap.
    """

    def __init__(self, *, compact_keep: int = 4096):
        # LEAF lock: acquired only at the RPC call boundary, never
        # while a dispatcher lock is held.
        self._lock = threading.Lock()
        self._entries: Deque[Tuple[int, dict]] = deque()  # guarded by: self._lock
        self._next_seq = 1  # guarded by: self._lock
        self._base = ReplicaState()  # guarded by: self._lock
        self._compact_keep = compact_keep

    def append(self, entry: dict) -> int:
        with self._lock:
            seq = self._next_seq
            self._next_seq += 1
            self._entries.append((seq, entry))
            while len(self._entries) > self._compact_keep:
                s, e = self._entries.popleft()
                self._base.apply(s, e)
            return seq

    def last_seq(self) -> int:
        with self._lock:
            return self._next_seq - 1

    def since(self, acked_seq: int
              ) -> Tuple[Optional[str], int, List[Tuple[int, dict]]]:
        """Everything a standby at ``acked_seq`` is missing:
        ``(snapshot_json | None, snapshot_seq, entries)``.  The snapshot
        is non-None iff the ack fell behind the compaction horizon."""
        with self._lock:
            if acked_seq < self._base.seq:
                return (self._base.to_json(), self._base.seq,
                        list(self._entries))
            return (None, 0,
                    [(s, e) for s, e in self._entries if s > acked_seq])


class ReplicatingDispatcher:
    """Wraps a TaskDispatcher / ShardRouter and journals every lease
    mutation at the call boundary — AFTER the inner call returns, so
    the journal lock (a leaf) is never taken under a dispatcher lock
    and a wedged standby can never stall the grant path.

    Everything not explicitly wrapped delegates via ``__getattr__``, so
    the wrapper is drop-in wherever the inner dispatcher was (the
    SchedulerService feature-detects optional methods with getattr and
    hasattr; the routed and parked wrappers are therefore bound as
    instance attributes only when the inner dispatcher has the method).

    The parked waits (the aio front end) are journaled inside the
    continuation: the grants land in the journal before the reply is
    handed to the loop.  The JAX wrapper journals the plain parked wait
    only, so on a sharded plane its routed parked grants never reach the
    journal; the port wraps the routed one too.
    """

    def __init__(self, inner, journal: LeaseJournal):
        self._inner = inner
        self._journal = journal
        self._last_rung = 0
        if hasattr(inner, "wait_for_starting_new_task_routed"):
            self.wait_for_starting_new_task_routed = self._routed
        if hasattr(inner, "submit_wait_for_starting_new_task"):
            self.submit_wait_for_starting_new_task = self._submit
        if hasattr(inner, "submit_wait_for_starting_new_task_routed"):
            self.submit_wait_for_starting_new_task_routed = \
                self._submit_routed

    def __getattr__(self, name):
        return getattr(self._inner, name)

    @property
    def inner(self):
        return self._inner

    # -- journaled mutators --------------------------------------------------

    def keep_servant_alive(self, info: ServantInfo,
                           expires_in_s: float) -> bool:
        ok = self._inner.keep_servant_alive(info, expires_in_s)
        if expires_in_s <= 0:
            self._journal.append(
                {"op": "servant_leave", "location": info.location})
        elif ok:
            self._journal.append(
                {"op": "servant", "location": info.location,
                 "info": dataclasses.asdict(info),
                 "lease_s": expires_in_s})
        return ok

    def wait_for_starting_new_task(self, env_digest: str, *,
                                   min_version: int = 0,
                                   requestor: str = "",
                                   immediate: int = 1,
                                   prefetch: int = 0,
                                   lease_s: float = 15.0,
                                   timeout_s: float = 5.0,
                                   tenant: str = "",
                                   ) -> List[Tuple[int, str]]:
        pairs = self._inner.wait_for_starting_new_task(
            env_digest, min_version=min_version, requestor=requestor,
            immediate=immediate, prefetch=prefetch, lease_s=lease_s,
            timeout_s=timeout_s, tenant=tenant)
        self._journal_issue(env_digest, requestor, lease_s,
                            [(gid, loc) for gid, loc in pairs])
        return pairs

    def _routed(self, env_digest: str, **kwargs):
        routed = self._inner.wait_for_starting_new_task_routed(
            env_digest, **kwargs)
        self._journal_issue(
            env_digest, kwargs.get("requestor", ""),
            kwargs.get("lease_s", 15.0),
            [(g.grant_id, g.servant_location) for g in routed.grants])
        return routed

    def _submit(self, env_digest: str, *, on_done: Callable,
                **kwargs) -> None:
        requestor = kwargs.get("requestor", "")
        lease_s = kwargs.get("lease_s", 15.0)

        def journaling_done(pairs):  # fired outside dispatcher locks
            self._journal_issue(env_digest, requestor, lease_s, pairs)
            on_done(pairs)

        self._inner.submit_wait_for_starting_new_task(
            env_digest, on_done=journaling_done, **kwargs)

    def _submit_routed(self, env_digest: str, *, on_done: Callable,
                       **kwargs) -> None:
        requestor = kwargs.get("requestor", "")
        lease_s = kwargs.get("lease_s", 15.0)

        def journaling_done(routed):  # fired outside dispatcher locks
            self._journal_issue(
                env_digest, requestor, lease_s,
                [(g.grant_id, g.servant_location) for g in routed.grants])
            on_done(routed)

        self._inner.submit_wait_for_starting_new_task_routed(
            env_digest, on_done=journaling_done, **kwargs)

    def keep_task_alive(self, grant_ids: Sequence[int],
                        next_keep_alive_s: float) -> List[bool]:
        out = self._inner.keep_task_alive(grant_ids, next_keep_alive_s)
        renewed = [gid for gid, ok in zip(grant_ids, out) if ok]
        if renewed:
            self._journal.append({"op": "renew", "ids": renewed,
                                  "lease_s": next_keep_alive_s})
        return out

    def free_task(self, grant_ids: Sequence[int]) -> None:
        self._inner.free_task(grant_ids)
        if grant_ids:
            self._journal.append({"op": "free", "ids": list(grant_ids)})

    def on_expiration_timer(self) -> None:
        # Expiration frees are deliberately unjournaled: a stale
        # adoption self-heals within one zombie sweep (module docstring).
        self._inner.on_expiration_timer()
        # Rung transitions ride the sweep cadence (1s): coarse enough
        # to stay cheap, fine enough that a takeover restores a ladder
        # at most one sweep stale.
        rung = self._inner.admission_rung()
        if rung != self._last_rung:
            self._last_rung = rung
            self._journal.append({"op": "rung", "rung": rung})

    def _journal_issue(self, env_digest: str, requestor: str,
                       lease_s: float,
                       pairs: Sequence[Tuple[int, str]]) -> None:
        if pairs:
            self._journal.append(
                {"op": "issue", "env": env_digest, "requestor": requestor,
                 "lease_s": lease_s,
                 "grants": [[gid, loc] for gid, loc in pairs]})


class JournalStreamer:
    """Active-side shipping thread: journal -> standby, with acks.

    Sends a batch every ``interval_s`` even when the journal is idle —
    the empty batch is the liveness beacon the standby's
    :class:`StandbyMonitor` watches.  A standby whose ack regresses
    below the compaction horizon transparently receives a snapshot
    (``LeaseJournal.since`` decides; this thread just ships).
    """

    def __init__(self, journal: LeaseJournal, standby_uri: str, *,
                 token: str = "", interval_s: float = 0.2,
                 max_batch: int = 1024, clock: Clock = REAL_CLOCK):
        self._journal = journal
        self._uri = standby_uri
        self._token = token
        self._interval = interval_s
        self._max_batch = max_batch
        self._clock = clock
        self._lock = threading.Lock()
        self._acked = 0  # guarded by: self._lock
        self._chan: Optional[Channel] = None
        self._backoff = Backoff(initial_s=0.05, max_s=1.0)
        self._stop = threading.Event()
        self._wake = threading.Event()
        self._thread = threading.Thread(
            target=self._run, name="journal-streamer", daemon=True)

    def start(self) -> None:
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        self._wake.set()
        if self._thread.is_alive():
            self._thread.join(timeout=2.0)
        if self._chan is not None:
            self._chan.close()

    def kick(self) -> None:
        """Hint that the journal grew; the loop ships early."""
        self._wake.set()

    def acked_seq(self) -> int:
        with self._lock:
            return self._acked

    def flush_once(self) -> bool:
        """One synchronous ship; True when the standby acked.  Used by
        the loop and directly by tests/scenarios that want
        deterministic replication points."""
        snapshot, snap_seq, entries = self._journal.since(self.acked_seq())
        entries = entries[: self._max_batch]
        req = api.scheduler.ReplicateRequest(
            token=self._token,
            first_seq=entries[0][0] if entries else 0,
            entries_json=json.dumps(entries).encode(),
            snapshot_json=(snapshot or "").encode(),
            snapshot_seq=snap_seq)
        try:
            if self._chan is None:
                self._chan = Channel(self._uri)
            resp, _ = self._chan.call(
                REPLICATION_SERVICE_NAME, "Replicate", req,
                api.scheduler.ReplicateResponse, timeout=2.0)
        except RpcError as err:
            # Streaming must never take the active down; drop the
            # channel so a standby restart re-dials cleanly.
            logger.debug("replication ship failed: %s", err)
            if self._chan is not None:
                self._chan.close()
                self._chan = None
            return False
        with self._lock:
            self._acked = max(self._acked, resp.acked_seq)
        self._backoff.reset()
        return True

    def _run(self) -> None:
        while not self._stop.is_set():
            if not self.flush_once():
                self._stop.wait(self._backoff.next_delay())
                continue
            # More retained than one batch carried: ship again now.
            if self._journal.last_seq() > self.acked_seq():
                continue
            self._wake.wait(timeout=self._interval)
            self._wake.clear()


class ReplicationService:
    """Standby-side receiver for the journal stream."""

    def __init__(self, *, token: str = "", clock: Clock = REAL_CLOCK):
        self._token = token
        self._clock = clock
        self._lock = threading.Lock()
        self._state = ReplicaState()  # guarded by: self._lock
        self._last_stream_at = -1.0  # guarded by: self._lock
        self._frozen = False  # guarded by: self._lock; takeover fence

    def spec(self) -> ServiceSpec:
        s = ServiceSpec(REPLICATION_SERVICE_NAME)
        s.add("Replicate", api.scheduler.ReplicateRequest, self.Replicate)
        return s

    def Replicate(self, req, attachment, ctx):
        if self._token and req.token != self._token:
            raise RpcError(api.scheduler.SCHEDULER_STATUS_ACCESS_DENIED,
                           "bad replication token")
        entries = json.loads(req.entries_json) if req.entries_json else []
        with self._lock:
            self._last_stream_at = self._clock.now()
            if self._frozen:
                # Takeover underway: stop advancing so the replayed
                # state and the mirror cannot diverge mid-promotion.
                return api.scheduler.ReplicateResponse(
                    acked_seq=self._state.seq)
            if req.snapshot_json:
                self._state = ReplicaState.from_json(
                    req.snapshot_json.decode())
            for seq, entry in entries:
                if seq <= self._state.seq:
                    continue  # duplicate delivery after an ack race
                if seq != self._state.seq + 1:
                    # Gap (standby restarted / journal compacted past
                    # us): ack what we have; the streamer answers with
                    # a snapshot next round.
                    break
                self._state.apply(seq, entry)
            return api.scheduler.ReplicateResponse(
                acked_seq=self._state.seq)

    def last_stream_at(self) -> float:
        with self._lock:
            return self._last_stream_at

    def state_seq(self) -> int:
        with self._lock:
            return self._state.seq

    def freeze(self) -> ReplicaState:
        """Stop applying batches and hand the mirror to the takeover.
        Late batches from a not-quite-dead active are acked at the
        frozen seq and discarded."""
        with self._lock:
            self._frozen = True
            return self._state


class StandbyGate:
    """``ytpu.SchedulerService`` as mounted on the standby's port.

    Pre-takeover every call is refused FAST — a parked delegate must
    not burn its RPC timeout discovering the standby isn't serving:

    * ``WaitForStartingTask`` answers a well-formed response with
      ``flow_control=FLOW_CONTROL_REJECT`` and ``retry_after_ms`` (the
      native backoff channel every delegate already understands).
    * Every other method raises ``STATUS_NOT_SERVING`` with a
      ``retry-after-ms=N`` hint in the message, which
      :func:`rpc.retry_after_ms_from_error` parses (the JAX
      package's ``FailoverChannel`` rotates on it; the port's comes
      with the daemon, ROADMAP Queue 1 item 6).

    Post-takeover (:meth:`promote`) calls forward to the promoted
    SchedulerService.  The gate registers only the blocking handlers: a
    promoted standby behind the aio front end answers
    ``WaitForStartingTask`` on its bounded pool, as in the reference.
    """

    _METHODS = (
        ("Heartbeat", "HeartbeatRequest"),
        ("GetConfig", "GetConfigRequest"),
        ("WaitForStartingTask", "WaitForStartingTaskRequest"),
        ("KeepTaskAlive", "KeepTaskAliveRequest"),
        ("FreeTask", "FreeTaskRequest"),
        ("GetRunningTasks", "GetRunningTasksRequest"),
    )

    def __init__(self, *, retry_after_ms: int = 250):
        self._retry_after_ms = retry_after_ms
        self._lock = threading.Lock()
        self._promoted = None  # guarded by: self._lock

    def spec(self) -> ServiceSpec:
        from .service import SERVICE_NAME  # cycle: service imports dispatcher

        s = ServiceSpec(SERVICE_NAME)
        for mname, req_name in self._METHODS:
            s.add(mname, getattr(api.scheduler, req_name),
                  self._handler(mname))
        return s

    def promote(self, service) -> None:
        with self._lock:
            self._promoted = service

    def promoted(self):
        with self._lock:
            return self._promoted

    def _handler(self, mname: str):
        def handle(req, attachment, ctx):
            inner = self.promoted()
            if inner is not None:
                return getattr(inner, mname)(req, attachment, ctx)
            if mname == "WaitForStartingTask":
                return api.scheduler.WaitForStartingTaskResponse(
                    flow_control=admission.FLOW_REJECT,
                    retry_after_ms=self._retry_after_ms)
            raise RpcError(
                STATUS_NOT_SERVING,
                "standby: journal not yet replayed; "
                f"retry-after-ms={self._retry_after_ms}")

        handle.__name__ = mname
        return handle


class StandbyScheduler:
    """The standby's brain: receiver + gate + takeover procedure."""

    def __init__(self, *, token: str = "", retry_after_ms: int = 250,
                 clock: Clock = REAL_CLOCK):
        self._clock = clock
        self.receiver = ReplicationService(token=token, clock=clock)
        self.gate = StandbyGate(retry_after_ms=retry_after_ms)
        self.dispatcher = None  # set by takeover()

    def takeover(self, dispatcher_factory: Callable[[], object], *,
                 service_factory: Optional[Callable] = None,
                 servant_lease_s: float = _TAKEOVER_SERVANT_LEASE_S,
                 grant_lease_s: float = _TAKEOVER_GRANT_LEASE_S,
                 grace_s: float = 20.0) -> dict:
        """Promote this standby to active; returns a timing report.

        Sequence:

        1. freeze the mirror (late journal batches are discarded),
        2. build a fresh dispatcher and replay servant registrations,
        3. adopt journaled grants onto their servants (idempotent;
           renewal RPCs landing mid-takeover succeed exactly once),
        4. open the adoption grace window at the journaled
           ``max_grant_id`` (plus TAKEOVER_GAP_SLACK ids) so servants
           re-reporting journal-gap grants via heartbeat keep them
           instead of being killed, and new ids start above it,
        5. restore the overload-ladder rung,
        6. open the gate (``service_factory`` result, when given).
        """
        t0 = self._clock.now()
        state = self.receiver.freeze()
        dispatcher = dispatcher_factory()
        replayed = 0
        for loc, s in state.servants.items():
            raw = dict(s["info"])
            raw["env_digests"] = tuple(raw.get("env_digests", ()))
            dispatcher.keep_servant_alive(ServantInfo(**raw),
                                          servant_lease_s)
            replayed += 1
        by_loc: Dict[str, List[Tuple[int, str, str]]] = defaultdict(list)
        for gid, g in state.grants.items():
            by_loc[g["location"]].append((gid, g["env"], g["requestor"]))
        adopted = sum(
            dispatcher.adopt_grants(loc, items, grant_lease_s)
            for loc, items in by_loc.items())
        dispatcher.set_adoption_window(state.max_grant_id, grace_s,
                                       gap_slack=TAKEOVER_GAP_SLACK)
        dispatcher.restore_admission_rung(state.rung)
        self.dispatcher = dispatcher
        if service_factory is not None:
            self.gate.promote(service_factory(dispatcher))
        takeover_ms = (self._clock.now() - t0) * 1000.0
        report = {
            "takeover_ms": takeover_ms,
            "servants_replayed": replayed,
            "grants_adopted": adopted,
            "grants_journaled": len(state.grants),
            "replayed_seq": state.seq,
            "restored_rung": state.rung,
            "adoption_floor": state.max_grant_id,
        }
        logger.info("standby takeover complete: %s", report)
        return report


class StandbyMonitor:
    """Fires ``on_dead`` exactly once after the journal stream has been
    silent for ``silence_s``.  Arms only after the first batch arrives
    (a standby booted before its active must not take over an empty
    mirror); pass ``require_stream=False`` to arm immediately."""

    def __init__(self, receiver: ReplicationService,
                 on_dead: Callable[[], None], *,
                 silence_s: float = 1.0, poll_s: float = 0.05,
                 require_stream: bool = True,
                 clock: Clock = REAL_CLOCK):
        self._receiver = receiver
        self._on_dead = on_dead
        self._silence = silence_s
        self._poll = poll_s
        self._require_stream = require_stream
        self._clock = clock
        self._stop = threading.Event()
        self._armed_at = clock.now()
        self._thread = threading.Thread(
            target=self._run, name="standby-monitor", daemon=True)

    def start(self) -> None:
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(timeout=2.0)

    def _run(self) -> None:
        while not self._stop.wait(self._poll):
            last = self._receiver.last_stream_at()
            if last < 0:
                if self._require_stream:
                    continue
                last = self._armed_at
            if self._clock.now() - last >= self._silence:
                try:
                    self._on_dead()
                except Exception:
                    logger.exception("standby takeover callback failed")
                return
