"""Delegate-side task dispatcher: one state machine per in-flight task (a
copy of the JAX package's yadcc_tpu/daemon/local/
distributed_task_dispatcher.py).

Workload-agnostic: everything task-specific (cache key, dedup digest,
servant submission, output parsing) lives behind the DistributedTask
SPI, and the servant's wait/reference/free RPC surface is shared by all
task kinds — C++ TUs and jit builds run through this same machine,
interleaved, with per-kind provenance counters, and a fan-out parent
(AOT, autotune) expands into children that each re-enter it.

Parity with reference yadcc/daemon/local/distributed_task_dispatcher
.{h,cc}: a queued task runs Pending -> ReadyToFire -> Dispatched -> Done
(:146-158), trying in order (1) the distributed cache, (2) joining an
identical task already running somewhere in the cluster, (3) acquiring
a grant and dispatching to the chosen servant (:197-234), then long-
polling the servant with a retry budget (:365-421).  Four 1s timers keep
the world consistent: abort deadline, batched scheduler keep-alives,
orphan kill (submitter PID died), completed-task GC (:550-706).

The reference runs one fiber per task; here it's one thread per task —
the daemon's in-flight TU count is bounded by the client-side quota
(LocalTaskMonitor), so thread counts stay in the tens.

Each task's stages as the delegate sees them (``grant_wait``: the grant
keeper's hand-out, a wait that ended without a grant included;
``queue``: QueueCxxCompilationTask on the servant; ``output_wait``: the
long polls until the output) are recorded in a StageTimer and reported
by ``inspect()["stages"]``, beside the count of tasks that got no grant
in the keeper's window (``grant_timeouts``).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from enum import Enum
from typing import Dict, Optional

from ... import api
from ...jit import fanout
from ...rpc import Channel, RpcError
from ...tenancy import TenantLedger, TenantOverBudget
from ...utils.logging import get_logger
from ...utils.stagetimer import StageTimer
from .config_keeper import ConfigKeeper
from .distributed_cache_reader import DistributedCacheReader
from .distributed_task import DistributedTask, TaskResult
from .running_task_keeper import RunningTaskKeeper
from .task_grant_keeper import TaskGrantKeeper

logger = get_logger("daemon.task_dispatcher")

_LONG_POLL_MS = 2000
_LONG_POLL_RETRIES = 4
_ABORT_AFTER_S = 300.0     # hard ceiling per TU
_COMPLETED_RETENTION_S = 60.0
_KEEP_ALIVE_BATCH_S = 10.0
STAGES = ("grant_wait", "queue", "output_wait")


class TaskState(Enum):
    PENDING = "pending"
    DISPATCHED = "dispatched"
    DONE = "done"


@dataclass
class _Entry:
    task_id: int
    task: DistributedTask
    state: TaskState = TaskState.PENDING
    started_at: float = field(default_factory=time.monotonic)
    completed_at: Optional[float] = None
    grant_id: Optional[int] = None
    servant_location: Optional[str] = None
    servant_task_id: Optional[int] = None
    result: Optional[TaskResult] = None
    done: threading.Event = field(default_factory=threading.Event)
    aborted: bool = False
    thread: Optional[threading.Thread] = None
    # Parked long-poll continuations (aio front end): fired once with
    # the TaskResult when the task completes; a waiting client costs
    # this list entry, not a serving thread.
    waiters: list = field(default_factory=list)


class DistributedTaskDispatcher:
    def __init__(
        self,
        *,
        grant_keeper: TaskGrantKeeper,
        config_keeper: ConfigKeeper,
        cache_reader: Optional[DistributedCacheReader] = None,
        running_task_keeper: Optional[RunningTaskKeeper] = None,
        pid_prober=None,
        debugging_always_use_servant_at: str = "",
        # Transport scheme for dialing peer servants (their registry
        # locations are bare host:port).  "aio://" when the fleet runs
        # the event-loop front end (--rpc-frontend aio).
        servant_scheme: str = "grpc://",
        # Delegate-side per-tenant budget ledger: an over-budget
        # tenant's submission is refused AT THE DOOR (queue_task raises
        # TenantOverBudget -> HTTP 503 + Retry-After) instead of
        # occupying a task thread.  None = unbudgeted (single-tenant
        # deployments).
        tenant_ledger: Optional[TenantLedger] = None,
        # Delegate-side cache fills, used only by fan-out parents whose
        # reduced verdict is itself cacheable (the autotune sweep's
        # winner record); children fill servant-side like every other
        # task.  None = no parent fills.
        cache_writer=None,
    ):
        self._grants = grant_keeper
        self._config = config_keeper
        self._cache = cache_reader
        self._running = running_task_keeper
        self._pid_alive = pid_prober or _default_pid_alive
        # Debug override (reference --debugging_always_use_servant_at):
        # every servant dial goes HERE; grants still flow normally.
        self._debug_servant = debugging_always_use_servant_at
        self._servant_scheme = servant_scheme
        self._tenant_ledger = tenant_ledger
        self._cache_writer = cache_writer
        self._stages = StageTimer(STAGES)
        self._lock = threading.Lock()
        self._tasks: Dict[int, _Entry] = {}  # guarded by: self._lock
        self._next_id = 1  # guarded by: self._lock
        self._channels: Dict[str, Channel] = {}  # guarded by: self._lock
        self._last_keep_alive = 0.0  # on_timer's thread only
        # Tasks answered "no compile capacity": no grant within the
        # keeper's window (the client retries or compiles locally).  Not
        # one of the provenance counters below, which the JAX package
        # shares.
        self.grant_timeouts = 0  # guarded by: self._lock
        self.stats = {"hit_cache": 0, "reused": 0, "actually_run": 0,
                      "failed": 0,
                      "shed_to_local": 0}  # guarded by: self._lock
        # Same counters split per task kind and per tenant ("" entries
        # are never created).
        self.stats_by_kind: Dict[str, Dict[str, int]] = {}  # guarded by: self._lock
        self.stats_by_tenant: Dict[str, Dict[str, int]] = {}  # guarded by: self._lock

    # -- public API ----------------------------------------------------------

    def stop(self, join_timeout_s: float = 10.0) -> None:
        """Ordered shutdown: abort every in-flight task, stop the grant
        keeper (joins its fetcher threads and returns queued grants; a
        task waiting for a grant gets none) and the cache reader's
        refresh loop, then join the task threads (bounded: an aborted
        task ends at its next long-poll lap).  A task thread frees its
        grant on its own thread once the keeper is stopping, so every
        grant a joined task held is freed when this returns.  A task
        that ends in the join fires its parked waiters as always; the
        waiters of one that outlives the join are dropped, so no
        continuation outlives the dispatcher."""
        with self._lock:
            entries = list(self._tasks.values())
            for entry in entries:
                entry.aborted = True
        self._grants.stop()
        if self._cache is not None:
            self._cache.stop()
        deadline = time.monotonic() + join_timeout_s
        for entry in entries:
            if entry.thread is not None:
                entry.thread.join(
                    timeout=max(0.0, deadline - time.monotonic()))
        with self._lock:
            for entry in self._tasks.values():
                entry.waiters.clear()
            chans, self._channels = list(self._channels.values()), {}
        for ch in chans:
            ch.close()

    def queue_task(self, task: DistributedTask) -> int:
        tenant = task.fairness_tenant()
        if self._tenant_ledger is not None and tenant:
            # Budget check at the door: an over-budget tenant is
            # refused before a task thread or queue slot exists, so
            # its refused demand is invisible to everyone else.
            if self._tenant_ledger.over_budget(tenant, want_immediate=1):
                raise TenantOverBudget(tenant)
            self._tenant_ledger.charge(tenant)
        with self._lock:
            entry = _Entry(task_id=self._next_id, task=task)
            self._next_id += 1
            self._tasks[entry.task_id] = entry
            entry.thread = threading.Thread(
                target=self._perform_one_task, args=(entry,),
                name=f"{task.kind}-{entry.task_id}", daemon=True)
        entry.thread.start()
        return entry.task_id

    def _bump_locked(self, kind: str, counter: str,
                     tenant: str = "") -> None:
        """Increment a provenance counter; caller holds self._lock."""
        self.stats[counter] += 1
        per = self.stats_by_kind.setdefault(
            kind, {k: 0 for k in self.stats})
        per[counter] += 1
        if tenant:
            pt = self.stats_by_tenant.setdefault(
                tenant, {k: 0 for k in self.stats})
            pt[counter] += 1

    def wait_for_task(self, task_id: int,
                      timeout_s: float) -> Optional[TaskResult]:
        with self._lock:
            entry = self._tasks.get(task_id)
        if entry is None:
            return None
        entry.done.wait(timeout=timeout_s)
        return entry.result

    def wait_for_task_async(self, task_id: int, on_done) -> bool:  # ytpu: responder(on_done)  # ytpu: allow(reply-drop)  # unknown id: the False return hands the reply back to the caller, which answers 404
        """Parked-continuation twin of wait_for_task (aio front end):
        ``on_done(result)`` fires from the completing task thread, or
        immediately when the task already finished.  Returns False for
        an unknown task id (the caller answers 404 — same contract as
        wait_for_task returning None on unknown).  The caller owns the
        long-poll deadline: its loop timer answers 503 and the late
        completion callback becomes a no-op (reply-once responder)."""
        with self._lock:
            entry = self._tasks.get(task_id)
            if entry is None:
                return False
            if entry.state != TaskState.DONE:
                entry.waiters.append(on_done)
                return True
            result = entry.result
        on_done(result)
        return True

    def free_task(self, task_id: int) -> None:
        with self._lock:
            self._tasks.pop(task_id, None)

    def is_known(self, task_id: int) -> bool:
        with self._lock:
            return task_id in self._tasks

    # -- the per-TU state machine -------------------------------------------

    def _perform_one_task(self, entry: _Entry) -> None:
        try:
            result = self._try_read_cache(entry)
            if result is None:
                result = self._try_join_existing(entry)
            if result is None and entry.task.is_fanout:
                result = self._perform_fanout(entry)
            if result is None:
                result = self._start_new_servant_task(entry)
        except Exception as e:  # never leave a waiter hanging
            logger.exception("task %d failed", entry.task_id)
            result = TaskResult(
                exit_code=-1,
                standard_error=f"ytpu daemon error: {e!r}".encode())
            # The failure path must not raise: the task object that just
            # blew up may not implement the full SPI, and an exception
            # here would leave the waiter hanging after all.
            tenant = getattr(entry.task, "fairness_tenant", lambda: "")()
            with self._lock:
                self._bump_locked(entry.task.kind, "failed", tenant)
        if self._tenant_ledger is not None:
            # Every exit path lands here (the try/except above never
            # re-raises), so the outstanding count is exact.
            self._tenant_ledger.release(
                getattr(entry.task, "fairness_tenant", lambda: "")())
        with self._lock:
            entry.result = result
            entry.state = TaskState.DONE
            entry.completed_at = time.monotonic()
            waiters, entry.waiters = entry.waiters, []
        entry.done.set()
        for cb in waiters:  # parked long polls (aio front end)
            try:
                cb(result)
            except Exception:
                logger.exception("parked wait continuation failed")

    def _try_read_cache(self, entry: _Entry) -> Optional[TaskResult]:
        if self._cache is None or not self._cache.enabled:
            return None
        # Only CACHE_ALLOW reads; REFILL (the reference's cache-cold
        # benchmark mode, YADCC_CACHE_CONTROL=2) skips the lookup but
        # still fills on completion (reference distributed_task.h:36,
        # distributed_task_dispatcher.cc:237).
        if entry.task.get_cache_setting() != entry.task.CACHE_ALLOW:
            return None
        key = entry.task.get_cache_key()
        if key is None:
            return None
        data = self._cache.try_read(key)
        if data is None:
            return None
        result = entry.task.parse_cache_entry(data)
        if result is None:
            logger.warning("corrupted cache entry for %s", key)
            return None
        with self._lock:
            self._bump_locked(entry.task.kind, "hit_cache",
                              entry.task.fairness_tenant())
        return result

    def _perform_fanout(self, entry: _Entry) -> TaskResult:
        """Fan-out parents (jit/fanout.py): expand into child tasks — each
        a normal DistributedTask re-entering this dispatcher's cache,
        join and dispatch with its own cache key, digest and grant — then
        join them with bounded retries and reduce to one result with
        per-child verdicts.  The parent holds no grant and no engine
        slot; the children bump the per-kind counters through the normal
        path, the parent bumps nothing on success."""
        children = entry.task.expand_children()
        if entry.task.tenant_fanout_cap:
            # The tier's fan-out cap, however generous the global
            # YTPU_FANOUT_MAX_WIDTH bound is.
            fanout.checked_fanout_width(
                len(children), cap=entry.task.tenant_fanout_cap)
        outcomes = fanout.run_fanout(
            children,
            queue=self.queue_task,
            wait=self.wait_for_task,
            free=self.free_task,
            aborted=lambda: entry.aborted,
        )
        result = entry.task.reduce(outcomes)
        make = getattr(entry.task, "make_parent_cache_entry", None)
        if self._cache_writer is not None and make is not None:
            filled = make(result)
            if filled is not None:
                self._cache_writer.async_write(*filled)
        return result

    def _try_join_existing(self, entry: _Entry) -> Optional[TaskResult]:
        """Duplicate-compilation joining (reference :256-300): if some
        servant is already compiling this digest, reference it and wait
        for ITS output instead of burning another grant."""
        if self._running is None:
            return None
        found = self._running.try_find_task(entry.task.get_digest())
        if found is None:
            return None
        token = self._config.serving_daemon_token()
        ch = self._channel(found.servant_location)
        try:
            ch.call("ytpu.DaemonService", "ReferenceTask",
                    api.daemon.ReferenceTaskRequest(
                        token=token, task_id=found.servant_task_id),
                    api.daemon.ReferenceTaskResponse, timeout=5.0)
        except RpcError:
            return None  # task finished or servant gone: fall through
        with self._lock:
            entry.state = TaskState.DISPATCHED
            entry.servant_location = found.servant_location
            entry.servant_task_id = found.servant_task_id
        result = self._wait_servant(entry, token)
        # Release the reference we took, or the joined task's refcount
        # never reaches zero and it leaks until servant GC.
        self._free_servant_task(entry, token)
        if result is not None:
            result.reused_existing = True
            with self._lock:
                self._bump_locked(entry.task.kind, "reused",
                                  entry.task.fairness_tenant())
        return result

    def _start_new_servant_task(self, entry: _Entry) -> TaskResult:
        t0 = time.perf_counter()
        grant = self._grants.get(entry.task.get_env_digest(), timeout_s=10.0,
                                 client_key=entry.task.fairness_key(),
                                 weight=entry.task.fairness_weight,
                                 tenant=entry.task.fairness_tenant(),
                                 tenant_weight=entry.task.tenant_weight)
        t1 = time.perf_counter()
        self._stages.record("grant_wait", t1 - t0)
        if grant is None:
            if self._grants.local_only_active():
                # Explicit overload-ladder verdict, not a timeout: the
                # scheduler told this box to use its own CPU.  Count it
                # so a fleet shedding load is visible in /inspect.
                with self._lock:
                    self._bump_locked(entry.task.kind, "shed_to_local",
                                      entry.task.fairness_tenant())
                return TaskResult(
                    exit_code=-1,
                    standard_error=b"cluster overloaded (LOCAL_ONLY "
                                   b"verdict): compile locally")
            with self._lock:
                self.grant_timeouts += 1
            return TaskResult(
                exit_code=-1,
                standard_error=b"no compile capacity available in cluster")
        token = self._config.serving_daemon_token()
        ch = self._channel(grant.servant_location)
        try:
            servant_task_id = entry.task.start_task(ch, token,
                                                    grant.grant_id)
        except RpcError as e:
            self._grants.free([grant.grant_id])
            return TaskResult(
                exit_code=-1,
                standard_error=f"servant rejected task: {e}".encode())
        t2 = time.perf_counter()
        self._stages.record("queue", t2 - t1)
        with self._lock:
            entry.state = TaskState.DISPATCHED
            entry.grant_id = grant.grant_id
            entry.servant_location = grant.servant_location
            entry.servant_task_id = servant_task_id
        result = self._wait_servant(entry, token)
        self._stages.record("output_wait", time.perf_counter() - t2)
        self._free_servant_task(entry, token)
        self._grants.free([grant.grant_id])
        if result is None:
            result = TaskResult(
                exit_code=-1,
                standard_error=b"servant lost while compiling")
        else:
            with self._lock:
                self._bump_locked(entry.task.kind, "actually_run",
                                  entry.task.fairness_tenant())
        return result

    def _wait_servant(self, entry: _Entry,
                      token: str) -> Optional[TaskResult]:
        ch = self._channel(entry.servant_location)
        retries = 0
        while retries <= _LONG_POLL_RETRIES:
            if entry.aborted:
                return None
            req = api.daemon.WaitForCompilationOutputRequest(
                token=token,
                task_id=entry.servant_task_id,
                milliseconds_to_wait=_LONG_POLL_MS,
            )
            req.acceptable_compression_algorithms.append(
                api.daemon.COMPRESSION_ALGORITHM_ZSTD)
            try:
                resp, att = ch.call(
                    "ytpu.DaemonService", "WaitForCompilationOutput", req,
                    api.daemon.WaitForCompilationOutputResponse,
                    timeout=_LONG_POLL_MS / 1000.0 + 5.0)
            except RpcError:
                retries += 1
                continue
            if resp.status == api.daemon.COMPILATION_TASK_STATUS_RUNNING:
                continue  # still compiling: poll again, no retry charge
            if resp.status == api.daemon.COMPILATION_TASK_STATUS_DONE:
                return entry.task.parse_servant_output(resp, att)
            return None  # NOT_FOUND / FAILED
        return None

    def _free_servant_task(self, entry: _Entry, token: str) -> None:
        if entry.servant_task_id is None:
            return
        ch = self._channel(entry.servant_location)
        try:
            ch.call("ytpu.DaemonService", "FreeTask",
                    api.daemon.FreeDaemonTaskRequest(
                        token=token, task_id=entry.servant_task_id),
                    api.daemon.FreeDaemonTaskResponse, timeout=5.0)
        except RpcError:
            pass  # servant GC will reclaim

    # -- timers (call each ~1s from the daemon's timer thread) ---------------

    def on_timer(self) -> None:
        now = time.monotonic()
        keep_alive_ids = []
        with self._lock:
            for entry in list(self._tasks.values()):
                if entry.state == TaskState.DONE:
                    if (entry.completed_at is not None
                            and now - entry.completed_at
                            > _COMPLETED_RETENTION_S):
                        del self._tasks[entry.task_id]
                    continue
                if now - entry.started_at > _ABORT_AFTER_S:
                    entry.aborted = True
                    continue
                if not self._pid_alive(entry.task.requestor_pid):
                    # Orphan: the submitting client died.
                    entry.aborted = True
                    continue
                if entry.grant_id is not None:
                    keep_alive_ids.append(entry.grant_id)
        if keep_alive_ids and (now - self._last_keep_alive
                               >= _KEEP_ALIVE_BATCH_S):
            self._last_keep_alive = now
            self._grants.keep_alive(keep_alive_ids)

    # -- plumbing ------------------------------------------------------------

    def _channel(self, location: str) -> Channel:
        if self._debug_servant:
            location = self._debug_servant
        with self._lock:
            ch = self._channels.get(location)
            if ch is None:
                scheme = "" if "://" in location else self._servant_scheme
                ch = Channel(scheme + location)
                self._channels[location] = ch
            return ch

    def inspect(self) -> dict:
        with self._lock:
            out = {
                "in_flight": sum(1 for e in self._tasks.values()
                                 if e.state != TaskState.DONE),
                "retained": sum(1 for e in self._tasks.values()
                                if e.state == TaskState.DONE),
                "stats": dict(self.stats),
                "grant_timeouts": self.grant_timeouts,
                "stats_by_kind": {k: dict(v) for k, v
                                  in self.stats_by_kind.items()},
                "stats_by_tenant": {k: dict(v) for k, v
                                    in self.stats_by_tenant.items()},
            }
        out["stages"] = self._stages.percentiles()
        out["grant_keeper"] = self._grants.inspect()
        if self._tenant_ledger is not None:
            out["tenant_budgets"] = self._tenant_ledger.inspect()
        return out


def _default_pid_alive(pid: int) -> bool:
    from .local_task_monitor import _pid_alive

    if pid <= 0:
        return True  # unknown submitter: never orphan-kill
    return _pid_alive(pid)
