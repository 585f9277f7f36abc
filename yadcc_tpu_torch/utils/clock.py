"""Injectable time source.

The reference tests lease expiry with real 2-second sleeps
(yadcc/scheduler/task_dispatcher_test.cc:110-145); this framework makes
every lease-bearing component take a Clock so tests advance time
virtually and stay fast and deterministic."""

from __future__ import annotations

import threading
import time


class Clock:
    """Real monotonic clock."""

    def now(self) -> float:
        return time.monotonic()

    def sleep(self, seconds: float) -> None:
        time.sleep(seconds)


class VirtualClock(Clock):
    """Manually-advanced clock for tests."""

    def __init__(self, start: float = 0.0):
        self._now = start  # guarded by: self._lock
        self._lock = threading.Lock()

    def now(self) -> float:
        with self._lock:
            return self._now

    def sleep(self, seconds: float) -> None:
        self.advance(seconds)

    def advance(self, seconds: float) -> None:
        with self._lock:
            self._now += seconds


REAL_CLOCK = Clock()
