"""Cyclic-GC control for the latency-critical serving path.

CPython's reference counting reclaims almost everything a dispatch cycle
allocates; the cyclic collector exists only for reference cycles, yet
its gen-2 passes stop every thread for milliseconds once the process
holds a large live heap (a 5k-servant registry, torch, RPC machinery).
Those pauses land in the middle of grant cycles.  The guard:

  * ``freeze()``s the post-startup heap out of the collector's sight;
  * disables the automatic threshold-triggered collector, so a
    collection never preempts a dispatch cycle;
  * collects the young generations from the 1 s maintenance sweep, with
    a full pass about once a minute for genuine long-lived cycles.

The scheduler entry calls `start()` after warmup, `maintain()` from its
sweep and `stop()` at exit.  A copy, trimmed to the guard, of the JAX
package's module of the same name.
"""

from __future__ import annotations

import gc

from . import exposed_vars
from .clock import REAL_CLOCK

# A full (gen-2) pass every ~60 s of maintenance calls: long-lived cycles
# must not accumulate forever, but the pass runs on the sweep thread.
_FULL_PASS_PERIOD_S = 60.0


class LatencyGcGuard:
    """Process-wide: owns the automatic collector's on/off state."""

    def __init__(self, clock=REAL_CLOCK):
        self._clock = clock
        self._active = False
        self._last_full = 0.0
        self._young_passes = 0
        self._full_passes = 0
        self._was_enabled = True
        self._prior_frozen = 0
        exposed_vars.expose("yadcc/gc_guard", self.inspect)

    def start(self) -> None:
        """Call once, after warmup built the long-lived heap."""
        # stop() restores the state found here: a host that runs with GC
        # off (or with its own frozen set) must find it so afterwards.
        self._was_enabled = gc.isenabled()
        self._prior_frozen = gc.get_freeze_count()
        gc.collect()          # drain pre-existing garbage first
        gc.freeze()           # startup heap: immortal, stop scanning it
        gc.disable()          # no threshold-triggered pauses hereafter
        self._active = True
        self._last_full = self._clock.now()

    def maintain(self) -> None:
        """Idle-time collection from the ~1 s sweep: young generations,
        with a rare full pass."""
        if not self._active:
            return
        now = self._clock.now()
        if now - self._last_full >= _FULL_PASS_PERIOD_S:
            gc.collect()
            self._last_full = now
            self._full_passes += 1
        else:
            gc.collect(1)     # gen 0+1: the per-cycle allocations
            self._young_passes += 1

    def stop(self) -> None:
        if self._active:
            self._active = False
            if self._was_enabled:
                gc.enable()
            # gc.unfreeze() is all-or-nothing: undo our freeze only when
            # nothing was frozen before start().
            if self._prior_frozen == 0:
                gc.unfreeze()

    def inspect(self) -> dict:
        return {
            "active": self._active,
            "auto_collector_enabled": gc.isenabled(),
            "frozen_objects": gc.get_freeze_count(),
            "young_passes": self._young_passes,
            "full_passes": self._full_passes,
        }
