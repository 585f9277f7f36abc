"""Bounded exponential backoff with jitter (a copy of the JAX package's
yadcc_tpu/common/backoff.py, kept in the port so that it stands alone;
the shard router paces its dry steals with it).

  * exponential growth with a hard ceiling;
  * full jitter (uniform in (0, delay], floored at 10%): callers knocked
    over by the same event must not re-arrive in lockstep;
  * server hints win: a retry-after replaces the locally-computed delay.

Deterministic in tests: inject ``rng`` and ``sleep``.
"""

from __future__ import annotations

import random
import time
from typing import Callable, Optional


class Backoff:
    """One retry loop's pacing state.  Not thread-safe: each loop owns
    its instance (two threads sharing one would double-advance the
    schedule)."""

    def __init__(
        self,
        initial_s: float = 0.05,
        max_s: float = 2.0,
        multiplier: float = 2.0,
        jitter: bool = True,
        rng: Optional[random.Random] = None,
        sleep: Callable[[float], None] = time.sleep,
    ):
        if initial_s <= 0 or max_s < initial_s or multiplier < 1.0:
            raise ValueError("backoff schedule must grow from a positive "
                             f"base: {initial_s=} {max_s=} {multiplier=}")
        self._initial = initial_s
        self._max = max_s
        self._multiplier = multiplier
        self._jitter = jitter
        self._rng = rng or random
        self._sleep = sleep
        self._next = initial_s
        self.retries = 0  # consecutive failures since the last reset()

    def reset(self) -> None:
        """Call on success: the next failure starts the schedule over."""
        self._next = self._initial
        self.retries = 0

    def next_delay(self, retry_after_s: Optional[float] = None) -> float:
        """The delay to wait before the next attempt (advances the
        schedule).  ``retry_after_s`` is a server hint: it replaces the
        computed delay, still clamped to the ceiling (a hostile or
        confused server must not park a client for an hour) and still
        jittered (every rejected client got the same hint)."""
        if retry_after_s is not None and retry_after_s > 0:
            base = min(retry_after_s, self._max)
        else:
            base = self._next
        self._next = min(self._next * self._multiplier, self._max)
        self.retries += 1
        if self._jitter:
            # Full jitter, floored at 10% of base so a pathological rng
            # draw can't turn backoff into a spin.
            return base * (0.1 + 0.9 * self._rng.random())
        return base

    def wait(self, retry_after_s: Optional[float] = None) -> float:
        """Sleep for next_delay(); returns the slept duration."""
        d = self.next_delay(retry_after_s)
        self._sleep(d)
        return d
