"""Event-loop lag watchdog.

A parked continuation, a C extension or an accidental blocking call can
stall the serving loop of the aio front end (``rpc/aio_server.py``) at
run time.  This module catches it: a process-wide installable sentinel
that tests wrap around their body and assert clean.

* :func:`register` — ``EventLoopThread.__init__`` registers every loop
  it creates (weakly; dead loops cost nothing).  Loops created while a
  watch session is active are picked up immediately, so module-scoped
  server fixtures and per-test fixtures both land under the watch.
* :func:`installed` — context manager: attaches a self-rearming tick
  (every ``interval_s``) to every registered loop via the threadsafe
  seam and runs a watcher thread that flags any loop whose most recent
  tick is older than ``threshold_s`` (default 250ms).  Violations
  collect on the yielded session; tests assert ``not session.violations``.

The tick runs ON the loop, so a stalled loop (handler doing blocking
I/O, lock convoy, sync RPC) stops ticking and the watcher — a plain
thread — observes the gap.  Stopped/closed loops are skipped, not
flagged: teardown is not lag.
"""

from __future__ import annotations

import threading
import time
import weakref
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

DEFAULT_THRESHOLD_S = 0.25
DEFAULT_INTERVAL_S = 0.05

_lock = threading.Lock()
# loop id -> (weakref to loop, name).  Ids recycle only after the loop
# is collected, at which point the weakref is dead and the entry is
# pruned on the next sweep.
_loops: Dict[int, Tuple[weakref.ref, str]] = {}
_session: Optional["WatchSession"] = None


@dataclass
class Violation:
    loop_name: str
    gap_s: float

    def render(self) -> str:
        return (f"loop '{self.loop_name}' stalled {self.gap_s * 1e3:.0f}ms "
                f"between turns")


class WatchSession:
    """One active watch: per-loop tick timestamps + a watcher thread."""

    def __init__(self, threshold_s: float, interval_s: float):
        self.threshold_s = threshold_s
        self.interval_s = interval_s
        self.violations: List[Violation] = []
        self._last: Dict[int, float] = {}
        self._armed: set = set()
        self._stop = threading.Event()
        self._watcher = threading.Thread(
            target=self._watch, name="looplag-watch", daemon=True)

    # -- loop attachment ---------------------------------------------------

    def attach(self, loop, name: str) -> None:
        lid = id(loop)
        with _lock:
            if lid in self._armed:
                return
            self._armed.add(lid)
            self._last[lid] = time.monotonic()

        def tick() -> None:
            self._last[lid] = time.monotonic()
            if not self._stop.is_set():
                loop.call_later(self.interval_s, tick)

        try:
            loop.call_soon_threadsafe(tick)
        except RuntimeError:
            pass  # loop already closed; the watcher skips it

    # -- the watcher thread ------------------------------------------------

    def _watch(self) -> None:
        while not self._stop.wait(self.interval_s):
            now = time.monotonic()
            with _lock:
                snapshot = list(self._last.items())
                registry = dict(_loops)
            for lid, last in snapshot:
                entry = registry.get(lid)
                loop = entry[0]() if entry else None
                if loop is None or loop.is_closed() or \
                        not loop.is_running():
                    continue
                gap = now - last
                if gap > self.threshold_s:
                    name = entry[1] if entry else "?"
                    self.violations.append(Violation(name, gap))
                    # Re-base so one long stall reports once per
                    # threshold window, not once per watcher turn.
                    self._last[lid] = now

    def start(self) -> None:
        self._watcher.start()

    def stop(self) -> None:
        self._stop.set()
        self._watcher.join(timeout=2.0)


def register(loop, name: str = "aio-loop") -> None:
    """Record a live loop; attach it to the active session if any.
    Called by EventLoopThread at construction — costs a dict entry."""
    with _lock:
        _loops[id(loop)] = (weakref.ref(loop), name)
        # Prune dead entries opportunistically.
        dead = [lid for lid, (ref, _) in _loops.items() if ref() is None]
        for lid in dead:
            _loops.pop(lid, None)
        session = _session
    if session is not None:
        session.attach(loop, name)


@contextmanager
def installed(threshold_s: float = DEFAULT_THRESHOLD_S,
              interval_s: float = DEFAULT_INTERVAL_S):
    """Watch every registered loop for the duration of the block.

    Yields the session; callers assert ``not session.violations``.
    Nested installs are rejected — one watcher owns the registry."""
    global _session
    session = WatchSession(threshold_s, interval_s)
    with _lock:
        if _session is not None:
            raise RuntimeError("looplag session already active")
        _session = session
        existing = [(ref(), name) for ref, name in _loops.values()]
    for loop, name in existing:
        if loop is not None and not loop.is_closed():
            session.attach(loop, name)
    session.start()
    try:
        yield session
    finally:
        session.stop()
        with _lock:
            _session = None
