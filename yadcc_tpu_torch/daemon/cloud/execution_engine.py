"""ExecutionEngine: the servant's subprocess farm (a copy of the JAX
package's yadcc_tpu/daemon/cloud/execution_engine.py).

Parity with reference yadcc/daemon/cloud/execution_engine.{h,cc}:

* Capacity policy (:48-162): dedicated servants offer 95% of cores, user
  desktops 40%; machines with <=16 cores ("poor") or running inside a
  constraining cgroup offer zero — their numbers lie or their owners
  need them.
* Admission control (:363-390): a task starts only when concurrency and
  free memory (--min-memory-for-starting-new-task, default 2G) allow.
* Every task runs in its own process group, SIGKILLed wholesale on
  overrun/expiry (:329-343); a dedicated waiter watches each child and
  fires the completion callback (:416-489).
* Tasks are reference-counted: several delegates may wait on one task
  (duplicate-compilation joining), and its output survives until the
  last one frees it (:227-281).
* Grants the scheduler has expired are killed on heartbeat feedback
  (:294-310).
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from ...utils.logging import get_logger
from ..sysinfo import read_cgroup_present, read_memory_available
from .execute_command import kill_process_group, start_program

logger = get_logger("daemon.execution_engine")

# Reference constants (execution_engine.cc:48-65,124-162).
_DEDICATED_CORE_FRACTION = 0.95
_USER_CORE_FRACTION = 0.40
_POOR_MACHINE_CORES = 16

NOT_ACCEPTING_NONE = 0
NOT_ACCEPTING_USER_INSTRUCTED = 1
NOT_ACCEPTING_POOR_MACHINE = 2
NOT_ACCEPTING_CGROUPS = 3

# Completed tasks are kept for late WaitForCompilationOutput retries,
# then GC'd (reference daemon frees them after a grace period).
_COMPLETED_RETENTION_S = 60.0


def decide_capacity(
    nprocs: int,
    dedicated: bool,
    *,
    allow_poor_machine: bool = False,
    cgroup_present: Optional[bool] = None,
) -> tuple:
    """(capacity, not_accepting_reason)."""
    if cgroup_present is None:
        cgroup_present = read_cgroup_present()
    if cgroup_present:
        return 0, NOT_ACCEPTING_CGROUPS
    if nprocs <= _POOR_MACHINE_CORES and not allow_poor_machine:
        return 0, NOT_ACCEPTING_POOR_MACHINE
    frac = _DEDICATED_CORE_FRACTION if dedicated else _USER_CORE_FRACTION
    return max(1, int(nprocs * frac)), NOT_ACCEPTING_NONE


@dataclass
class TaskOutput:
    exit_code: int
    standard_output: bytes
    standard_error: bytes


@dataclass
class _Task:
    task_id: int
    grant_id: int
    digest: str
    cmdline: str
    # Called as on_completion(task_id, output) from the waiter thread.
    on_completion: Callable[[int, TaskOutput], None]
    proc: object = None
    ref_count: int = 1
    started_at: float = field(default_factory=time.monotonic)
    completed_at: Optional[float] = None
    output: Optional[TaskOutput] = None
    done: threading.Event = field(default_factory=threading.Event)
    # Parked continuations from wait_for_task_async, fired on
    # completion.  Guarded by the engine lock.
    waiters: List[Callable[[TaskOutput], None]] = field(
        default_factory=list)


class ExecutionEngine:
    def __init__(
        self,
        *,
        max_concurrency: int,
        min_memory_for_new_task: int = 2 << 30,
        memory_reader: Callable[[], int] = read_memory_available,
    ):
        self._max_concurrency = max_concurrency
        self._min_memory = min_memory_for_new_task
        self._memory_reader = memory_reader
        self._lock = threading.Lock()
        self._tasks: Dict[int, _Task] = {}  # guarded by: self._lock
        self._next_task_id = 1  # guarded by: self._lock
        self.tasks_run_ever = 0  # guarded by: self._lock
        self._rejected = 0  # guarded by: self._lock
        # Seconds from admission to exit of the last completed tasks:
        # the compile as the servant sees it (inspect's run_ms).
        self._run_s = deque(maxlen=4096)  # guarded by: self._lock

    # -- submission ----------------------------------------------------------

    def try_queue_task(
        self,
        *,
        grant_id: int,
        digest: str,
        cmdline: str,
        on_completion: Callable[[int, TaskOutput], None],
        env: Optional[dict] = None,
        cwd: str = "/",
    ) -> Optional[int]:
        """Start a task now or refuse (admission control).  Returns the
        servant task id, or None when the node is saturated."""
        # Sample memory BEFORE taking the lock: the reader's contract is
        # /proc/meminfo I/O, and every RPC worker thread funnels through
        # this admission check — a slow read under the lock would stall
        # heartbeat reporting (running_tasks) and completions behind it.
        # The check is advisory; a grant-sized TOCTOU window is fine.
        memory_ok = self._memory_reader() >= self._min_memory
        with self._lock:
            running = sum(1 for t in self._tasks.values()
                          if t.completed_at is None)
            if running >= self._max_concurrency:
                self._rejected += 1
                return None
            if not memory_ok:
                self._rejected += 1
                return None
            task = _Task(
                task_id=self._next_task_id,
                grant_id=grant_id,
                digest=digest,
                cmdline=cmdline,
                on_completion=on_completion,
            )
            self._next_task_id += 1
            self._tasks[task.task_id] = task
            self.tasks_run_ever += 1
        try:
            proc = start_program(cmdline, env=env, cwd=cwd)
        except OSError as e:
            with self._lock:
                self._tasks.pop(task.task_id, None)
            logger.error("cannot start %r: %s", cmdline, e)
            return None
        with self._lock:
            task.proc = proc
            # A concurrent kill_expired_tasks()/stop() may have already
            # removed the task while the process was being spawned; the
            # fresh process must not escape untracked.
            killed_meanwhile = task.task_id not in self._tasks
        if killed_meanwhile:
            kill_process_group(proc)
            proc.wait()
            return None
        threading.Thread(
            target=self._wait_for_process, args=(task,),
            name=f"task-waiter-{task.task_id}", daemon=True,
        ).start()
        return task.task_id

    def _wait_for_process(self, task: _Task) -> None:
        stdout, stderr = task.proc.communicate()
        output = TaskOutput(task.proc.returncode, stdout, stderr)
        try:
            task.on_completion(task.task_id, output)
        except Exception:
            logger.exception("completion callback failed for task %d",
                             task.task_id)
        with self._lock:
            task.output = output
            task.completed_at = time.monotonic()
            self._run_s.append(task.completed_at - task.started_at)
            waiters = task.waiters
            task.waiters = []
        task.done.set()
        # Parked continuations fire AFTER on_completion and done.set():
        # the owning service populates its result table inside
        # on_completion, so by the time a continuation runs the result
        # is ready — same ordering a blocking wait_for_task observes.
        for on_done in waiters:
            try:
                on_done(output)
            except Exception:
                logger.exception(
                    "parked wait continuation failed for task %d",
                    task.task_id)

    # -- querying ------------------------------------------------------------

    def reference_task(self, task_id: int) -> bool:
        """Join a running/completed task (dup-compilation)."""
        with self._lock:
            task = self._tasks.get(task_id)
            if task is None:
                return False
            task.ref_count += 1
            return True

    def find_task_by_digest(self, digest: str) -> Optional[int]:
        with self._lock:
            for t in self._tasks.values():
                if t.digest == digest:
                    return t.task_id
            return None

    def wait_for_task(self, task_id: int,
                      timeout_s: float) -> Optional[TaskOutput]:
        """Long-poll: None while still running (or unknown)."""
        with self._lock:
            task = self._tasks.get(task_id)
        if task is None:
            return None
        task.done.wait(timeout=timeout_s)
        return task.output

    def wait_for_task_async(self, task_id: int, on_done) -> bool:  # ytpu: responder(on_done)  # ytpu: allow(reply-drop)  # unknown id: the False return hands the reply back to the caller, which answers NOT_FOUND (mirrors DistributedTaskDispatcher.wait_for_task_async)
        """Loop-native twin of :meth:`wait_for_task`: registers a
        completion continuation instead of blocking a thread.

        Returns False when the task id is unknown (caller replies
        NOT_FOUND).  Otherwise ``on_done(output)`` fires exactly once —
        immediately (from this thread) when the task already completed,
        else from the task's waiter thread at completion.  A parked
        peer costs this closure, zero pool threads."""
        with self._lock:
            task = self._tasks.get(task_id)
            if task is None:
                return False
            if task.output is None:
                task.waiters.append(on_done)
                return True
            output = task.output
        # Completed already: fire outside the lock (the continuation
        # replies on the RPC front end; never under the engine lock).
        on_done(output)
        return True

    def cancel_wait(self, task_id: int, on_done) -> bool:
        """Deregister a parked continuation whose deadline already
        answered.  Without this, every expired long-poll would sit in
        the waiter table until the task completes (the peer re-polls
        with a FRESH request, so at storm scale one slow compile would
        accumulate waiters × re-polls stale closures, all refused at
        completion).  False when the continuation already left the
        table — completion is firing it concurrently; the reply-once
        responder settles that race."""
        with self._lock:
            task = self._tasks.get(task_id)
            if task is None:
                return False
            try:
                task.waiters.remove(on_done)
                return True
            except ValueError:
                return False

    def is_known(self, task_id: int) -> bool:
        with self._lock:
            return task_id in self._tasks

    def running_tasks(self) -> List[tuple]:
        """[(servant_task_id, grant_id, digest)] for heartbeats."""
        with self._lock:
            return [(t.task_id, t.grant_id, t.digest)
                    for t in self._tasks.values() if t.completed_at is None]

    # -- freeing / killing ---------------------------------------------------

    def free_task(self, task_id: int) -> bool:
        """Drop one reference; True when the task is fully released (so
        the caller may also discard any associated results)."""
        with self._lock:
            task = self._tasks.get(task_id)
            if task is None:
                return True
            task.ref_count -= 1
            if task.ref_count > 0:
                return False
            self._tasks.pop(task_id, None)
        self._kill(task)
        return True

    def kill_expired_tasks(self, expired_grant_ids: List[int]) -> None:
        """Heartbeat feedback: the scheduler disowned these grants
        (reference execution_engine.cc:294-310)."""
        expired = set(expired_grant_ids)
        victims = []
        with self._lock:
            for tid, t in list(self._tasks.items()):
                # Only RUNNING work is killed: a finished compile whose
                # grant lapsed still has a waiter coming for its output
                # (completed retention is the GC timer's job).
                if t.grant_id in expired and t.completed_at is None:
                    victims.append(self._tasks.pop(tid))
        for t in victims:
            logger.warning("killing task %d (grant %d expired)", t.task_id,
                           t.grant_id)
            self._kill(t)

    def gc_completed_tasks(self) -> None:
        """1s-cadence: drop finished tasks nobody freed."""
        cutoff = time.monotonic() - _COMPLETED_RETENTION_S
        with self._lock:
            for tid, t in list(self._tasks.items()):
                if t.completed_at is not None and t.completed_at < cutoff:
                    del self._tasks[tid]

    def stop(self) -> None:
        with self._lock:
            victims = list(self._tasks.values())
            self._tasks.clear()
        for t in victims:
            self._kill(t)

    @staticmethod
    def _kill(task: _Task) -> None:
        if task.proc is not None and task.proc.returncode is None:
            kill_process_group(task.proc)

    # -- introspection -------------------------------------------------------

    def inspect(self) -> dict:
        with self._lock:
            run = sorted(self._run_s)
            return {
                "max_concurrency": self._max_concurrency,
                "running": sum(1 for t in self._tasks.values()
                               if t.completed_at is None),
                "retained_completed": sum(
                    1 for t in self._tasks.values()
                    if t.completed_at is not None),
                "tasks_run_ever": self.tasks_run_ever,
                "rejected": self._rejected,
                # Parked WaitForCompilationOutput continuations.  A
                # deadline-expired waiter stays registered until the
                # task completes (its reply-once guard makes the late
                # fire a no-op) — same accepted slack as the local
                # dispatcher's waiter table.
                "parked_waiters": sum(len(t.waiters)
                                      for t in self._tasks.values()),
                # Not in the JAX package's inspect: the run time's
                # p50/p99 over the last completed tasks.
                "run_ms": {
                    "count": len(run),
                    "p50": run[len(run) // 2] * 1e3 if run else None,
                    "p99": (run[min(len(run) - 1, int(len(run) * 0.99))]
                            * 1e3 if run else None)},
            }
