"""Local concurrency governor for client processes (a copy of the JAX
package's yadcc_tpu/daemon/local/local_task_monitor.py, both halves: the
blocking acquisition of the threaded front end and the parked one of the
aio front end).

Parity with reference yadcc/daemon/local/local_task_monitor.{h,cc} and
the policy in yadcc/doc/daemon.md:66-71: the daemon hands out run-quota
to local compiler wrappers in two classes — *lightweight* tasks
(preprocessing, which must flow freely so work reaches the cloud fast)
may over-provision to 1.5x cores, while *heavy* tasks (local compiles,
fallbacks) are capped at 0.5x cores.  Quota is keyed by requestor PID
and reclaimed automatically when the PID dies (crashed clients must not
leak quota forever).  A parked acquisition (``acquire_async``) is woken
by every release and reclaim, FIFO per class, its continuation fired
once and outside the monitor's lock.
"""

from __future__ import annotations

import os
import threading
import time
from collections import defaultdict
from typing import Callable, Dict, List

_LIGHT_RATIO = 1.5
_HEAVY_RATIO = 0.5


class QuotaWaiter:
    """A parked quota acquisition (aio front end): the continuation
    fires exactly once — with True when quota is claimed for the pid,
    with False when `expire()` (the loop's deadline timer) wins the
    race.  Costs this object in a list, not a serving thread."""

    __slots__ = ("pid", "lightweight", "_on_grant", "_monitor", "_state")

    def __init__(self, monitor: "LocalTaskMonitor", pid: int,
                 lightweight: bool, on_grant: Callable[[bool], None]):
        self._monitor = monitor
        self.pid = pid
        self.lightweight = lightweight
        self._on_grant = on_grant
        self._state = "waiting"  # state moves only under the monitor lock

    def expire(self) -> None:
        """Deadline: if still waiting, answer False (the threaded
        path's timeout semantics)."""
        mon = self._monitor
        with mon._cv:
            if self._state != "waiting":
                return
            self._state = "expired"
            try:
                mon._async_waiters.remove(self)
            except ValueError:
                pass
        self._on_grant(False)


def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True
    return True


class LocalTaskMonitor:
    def __init__(self, nprocs: int = 0,
                 pid_prober=_pid_alive,
                 max_heavy_tasks: int = 0,
                 light_ratio: float = _LIGHT_RATIO):
        n = nprocs or os.cpu_count() or 1
        self._light_limit = max(1, int(n * light_ratio))
        # The >=1 floor applies to the override too: a non-positive
        # --max-local-tasks must not block every heavy compile forever.
        self._heavy_limit = max(1, max_heavy_tasks) if max_heavy_tasks \
            else max(1, int(n * _HEAVY_RATIO))
        self._pid_alive = pid_prober
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        # pid -> counts per class.
        self._light: Dict[int, int] = defaultdict(int)  # guarded by: self._lock
        self._heavy: Dict[int, int] = defaultdict(int)  # guarded by: self._lock
        # Parked acquisitions (aio front end), FIFO.
        self._async_waiters: List[QuotaWaiter] = []  # guarded by: self._lock

    # -- acquisition ---------------------------------------------------------

    def wait_for_running_new_task_permission(
        self, pid: int, lightweight: bool, timeout_s: float
    ) -> bool:
        deadline = time.monotonic() + timeout_s
        with self._cv:
            while not self._has_room_locked(lightweight):
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._cv.wait(timeout=min(remaining, 0.5))
            (self._light if lightweight else self._heavy)[pid] += 1
            return True

    def acquire_async(self, pid: int, lightweight: bool,
                      on_grant: Callable[[bool], None]) -> QuotaWaiter:  # ytpu: responder(on_grant)
        """Parked-continuation twin of
        wait_for_running_new_task_permission (aio front end): claims
        quota and fires ``on_grant(True)`` immediately when there is
        room, otherwise parks a waiter that the next release/reclaim
        wakes.  The caller owns the deadline: schedule
        ``waiter.expire()`` on its loop timer.  ``on_grant`` fires
        exactly once, never under the monitor lock."""
        waiter = QuotaWaiter(self, pid, lightweight, on_grant)
        with self._cv:
            if self._has_room_locked(lightweight):
                (self._light if lightweight else self._heavy)[pid] += 1
                waiter._state = "granted"
            else:
                self._async_waiters.append(waiter)
        if waiter._state == "granted":
            on_grant(True)
        return waiter

    def _claim_async_waiters_locked(self) -> List[QuotaWaiter]:
        """Grant parked waiters while room lasts (FIFO); returns the
        claimed waiters whose callbacks the CALLER fires after
        releasing the lock."""
        claimed: List[QuotaWaiter] = []
        remaining: List[QuotaWaiter] = []
        for w in self._async_waiters:
            # FIFO per class: a heavy waiter out of room must not
            # head-of-line-block a light waiter whose class has room.
            if self._has_room_locked(w.lightweight):
                (self._light if w.lightweight else self._heavy)[w.pid] += 1
                w._state = "granted"
                claimed.append(w)
            else:
                remaining.append(w)
        self._async_waiters[:] = remaining
        return claimed

    def drop_task_permission(self, pid: int) -> None:
        """Clients don't say which class they release; heavy is assumed
        first (it's the scarcer resource)."""
        with self._cv:
            if self._heavy.get(pid, 0) > 0:
                self._heavy[pid] -= 1
                if not self._heavy[pid]:
                    del self._heavy[pid]
            elif self._light.get(pid, 0) > 0:
                self._light[pid] -= 1
                if not self._light[pid]:
                    del self._light[pid]
            self._cv.notify_all()
            claimed = self._claim_async_waiters_locked()
        for w in claimed:
            w._on_grant(True)

    # -- reclamation ---------------------------------------------------------

    def on_reclaim_timer(self) -> int:
        """1s-cadence: reclaim quota held by dead PIDs; returns count."""
        reclaimed = 0
        claimed = []
        with self._cv:
            for table in (self._light, self._heavy):
                for pid in list(table):
                    if not self._pid_alive(pid):
                        reclaimed += table.pop(pid)
            if reclaimed:
                self._cv.notify_all()
                claimed = self._claim_async_waiters_locked()
        for w in claimed:
            w._on_grant(True)
        return reclaimed

    # -- internals -----------------------------------------------------------

    def _has_room_locked(self, lightweight: bool) -> bool:
        if lightweight:
            return sum(self._light.values()) < self._light_limit
        return sum(self._heavy.values()) < self._heavy_limit

    def inspect(self) -> dict:
        with self._lock:
            return {
                "light_limit": self._light_limit,
                "heavy_limit": self._heavy_limit,
                "light_held": sum(self._light.values()),
                "heavy_held": sum(self._heavy.values()),
                "holders": len(set(self._light) | set(self._heavy)),
                "parked_waiters": len(self._async_waiters),
            }
