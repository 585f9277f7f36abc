"""Trace-driven cache prefetcher: warm a cold region's L1/L2 from L3 (a
copy of the JAX package's yadcc_tpu/cache/prefetcher.py).  It runs in
the cache server's process and loads no torch: the key-trace loader it
calls (tools/trace_replay.py) imports the dispatch policies only inside
the replay functions.

A freshly provisioned (or rebuilt) regional cache server starts with an
empty L1/L2; every request misses, every miss schedules an async L3
promotion, and the region only warms at the pace of the live traffic
that is *already suffering*.  The diurnal build spike makes this worse:
the cold region meets its heaviest traffic with its coldest cache.

The prefetcher closes that gap by replaying *yesterday's key stream*
(`tools/trace_replay.py` key histories — the same trace discipline the
arrival-replay harness uses) against the L3 bucket BEFORE the spike:
each traced key still present in L3 is pulled down and planted in
L1/L2 + the region Bloom filter, so the first real request is a hit.

Budget discipline — prefetch is strictly OPTIONAL traffic:

* bytes/s throttle and entry/byte caps bound the bucket egress,
* the admission rung is probed between fetches and anything at or above
  ``RUNG_SHED_OPTIONAL`` pauses the sweep (prefetch sheds FIRST — the
  same contract the scheduler applies to opportunistic compile
  prefetch, scheduler/admission.py),
* traced keys pass the declared key-domain sanitizer before they touch
  the cache — a trace file is daemon-adjacent input, not trusted state.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Iterable, List, Optional

from ..scheduler.admission import RUNG_SHED_OPTIONAL
from ..utils.logging import get_logger

logger = get_logger("cache.prefetcher")

# Traced keys must look like cache keys (daemon/cache_format.py derives
# every real key with a "ytpu-" kind prefix) and stay far below the
# protocol's key-size envelope.
_KEY_DOMAIN_PREFIX = "ytpu-"
_MAX_KEY_LEN = 512

DEFAULT_BYTES_PER_S = 64 << 20
DEFAULT_MAX_ENTRIES = 100_000
DEFAULT_MAX_BYTES = 8 << 30


def sanitize_prefetch_key(key) -> Optional[str]:  # ytpu: sanitizes(key-domain, size-cap)
    """None unless `key` is a plausible cache key: str, bounded length,
    and inside the ytpu-* key domain every real key derivation uses.
    Trace files are replayed input — never let one plant arbitrary
    object names into the fetch stream."""
    if not isinstance(key, str):
        return None
    if len(key) > _MAX_KEY_LEN or not key.startswith(_KEY_DOMAIN_PREFIX):
        return None
    return key


class TracePrefetcher:
    """Synchronous budgeted warm sweep over a traced key list.

    Drives a CacheService's L3 tier directly (the prefetcher runs inside
    the regional cache server process, next to the tiers it warms).
    ``rung_probe`` returns the current admission rung; the sweep skips
    keys while it reads at or above RUNG_SHED_OPTIONAL.
    """

    def __init__(self, service, *,
                 bytes_per_s: float = DEFAULT_BYTES_PER_S,
                 max_entries: int = DEFAULT_MAX_ENTRIES,
                 max_bytes: int = DEFAULT_MAX_BYTES,
                 rung_probe: Callable[[], int] = lambda: 0,
                 clock=time):
        self._service = service
        self._bytes_per_s = max(1.0, float(bytes_per_s))
        self._max_entries = max_entries
        self._max_bytes = max_bytes
        self._rung_probe = rung_probe
        self._clock = clock
        self._lock = threading.Lock()
        self._fetched = 0  # guarded by: self._lock
        self._fetched_bytes = 0  # guarded by: self._lock
        self._skipped_present = 0  # guarded by: self._lock
        self._skipped_invalid = 0  # guarded by: self._lock
        self._skipped_shed = 0  # guarded by: self._lock
        self._missing = 0  # guarded by: self._lock
        self._errors = 0  # guarded by: self._lock

    def warm(self, keys: Iterable[str]) -> dict:
        """Replay `keys` (yesterday's stream, most-recent-first works
        best) against L3; returns the stats dict (same shape as
        inspect()).  Stops at the entry/byte caps; dedups repeated trace
        keys; never raises for a bad key or a failed fetch."""
        svc = self._service
        if svc.l3 is None:
            logger.warning("prefetch requested but service has no L3 tier")
            return self.inspect()
        start = self._clock.monotonic()
        seen: set = set()
        budget_bytes = 0
        for raw in keys:
            key = sanitize_prefetch_key(raw)
            if key is None:
                with self._lock:
                    self._skipped_invalid += 1
                continue
            if key in seen:
                continue
            seen.add(key)
            if self._rung_probe() >= RUNG_SHED_OPTIONAL:
                # Optional traffic sheds first: the region is already
                # under pressure, and a prefetch GET would compete with
                # the live misses it was meant to prevent.
                with self._lock:
                    self._skipped_shed += 1
                continue
            with self._lock:
                if (self._fetched >= self._max_entries
                        or self._fetched_bytes >= self._max_bytes):
                    break
            if svc.l1.try_get(key) is not None \
                    or svc.l2.try_get(key) is not None:
                with self._lock:
                    self._skipped_present += 1
                continue
            try:
                value = svc.l3.try_get(key)
            except Exception as e:
                with self._lock:
                    self._errors += 1
                logger.warning("prefetch fetch failed for %s: %s", key, e)
                continue
            if value is None:
                with self._lock:
                    self._missing += 1
                continue
            svc.l1.put(key, value)
            svc.l2.put(key, value)
            svc.bloom.add(key)
            with self._lock:
                self._fetched += 1
                self._fetched_bytes += len(value)
            budget_bytes += len(value)
            # bytes/s throttle: sleep off any debt against the budget
            # rather than bursting the bucket's egress.
            elapsed = self._clock.monotonic() - start
            owed = budget_bytes / self._bytes_per_s - elapsed
            if owed > 0:
                self._clock.sleep(min(owed, 1.0))
        return self.inspect()

    def inspect(self) -> dict:
        with self._lock:
            return {
                "fetched": self._fetched,
                "fetched_bytes": self._fetched_bytes,
                "skipped_present": self._skipped_present,
                "skipped_invalid": self._skipped_invalid,
                "skipped_shed": self._skipped_shed,
                "missing": self._missing,
                "errors": self._errors,
            }


def load_and_warm(service, trace_path: str, **kw) -> dict:
    """Convenience front door: load a key trace file and warm from it.
    The loader itself sanitizes and caps (tools/trace_replay.py), and
    warm() re-sanitizes — defense in depth on replayed input."""
    from ..tools.trace_replay import load_key_trace

    keys = load_key_trace(trace_path)
    pf = TracePrefetcher(service, **kw)
    return pf.warm(keys)
