"""Per-stage latency reservoirs for the grant path.

The full-RPC-path artifact (artifacts/pod_sim_50k.json) showed a
grant_call_p99 of 11.58ms with no way to tell WHERE the time went —
dispatch kernel, lock waits, serialization, or thread handoffs.  Every
stage of the grant path (queue-wait → snapshot → policy → apply →
serialize → transport) records into one of these; `percentiles()` is
the `latency_breakdown` section of pod_sim artifacts and /inspect.

Time sources are injectable: components that already take a Clock
(TaskDispatcher) time their stages with it, so the accounting is
testable with VirtualClock — see tests/test_latency_breakdown.py.
"""

from __future__ import annotations

import threading
from typing import Dict, Iterable

import numpy as np

# The serving front end's transport stages (rpc/aio_server.py records
# them; pod_sim surfaces them as `latency_breakdown.frontend_stages`):
# `accept` = connection open -> first complete request, `read` = first
# byte of a request -> the byte completing it, `parse` = incremental
# decode CPU, `write` = response gather-write to the transport.  With
# these, the residual grant_call time that used to lump into
# "queue-wait/transport" is attributable stage by stage
# (doc/scheduler.md "Grant-path stage budget").
FRONTEND_STAGES = ("accept", "read", "parse", "write")


class _Reservoir:
    """Fixed-size ring of the most recent samples plus a total count."""

    __slots__ = ("buf", "n", "count", "total")

    def __init__(self, maxlen: int):
        self.buf = np.empty(maxlen, np.float64)
        self.n = 0          # filled entries (<= maxlen)
        self.count = 0      # lifetime samples (ring write cursor source)
        self.total = 0.0

    def add(self, seconds: float) -> None:
        self.buf[self.count % len(self.buf)] = seconds
        self.count += 1
        self.n = min(self.n + 1, len(self.buf))
        self.total += seconds


class StageTimer:
    """Thread-safe named-stage latency recorder.

    Stages are created on first record; `record()` is O(1) (one ring
    write under a short lock) so it is safe on the dispatch hot path.
    """

    def __init__(self, stages: Iterable[str] = (), maxlen: int = 4096):
        self._maxlen = maxlen
        self._lock = threading.Lock()
        self._stages: Dict[str, _Reservoir] = {
            s: _Reservoir(maxlen) for s in stages
        }  # guarded by: self._lock

    def record(self, stage: str, seconds: float) -> None:
        with self._lock:
            r = self._stages.get(stage)
            if r is None:
                r = self._stages[stage] = _Reservoir(self._maxlen)
            r.add(seconds)

    def reset(self) -> None:
        with self._lock:
            for r in self._stages.values():
                r.n = r.count = 0
                r.total = 0.0

    def samples(self) -> Dict[str, tuple]:
        """{stage: (retained samples in seconds, lifetime count)} for
        every stage that recorded — what a caller pooling several timers
        (the shard router's aggregate breakdown) needs."""
        with self._lock:
            return {name: (r.buf[: r.n].copy(), r.count)
                    for name, r in self._stages.items() if r.n > 0}

    def percentiles(self) -> Dict[str, Dict[str, float]]:
        """{stage: {count, mean_ms, p50_ms, p99_ms}} over the retained
        window (the last `maxlen` samples per stage)."""
        with self._lock:
            snap = [(name, r.buf[: r.n].copy(), r.count, r.total)
                    for name, r in self._stages.items() if r.n > 0]
        out: Dict[str, Dict[str, float]] = {}
        for name, samples, count, total in snap:
            p50, p99 = np.percentile(samples * 1000.0, (50, 99))
            out[name] = {
                "count": int(count),
                "mean_ms": round(float(total / count) * 1000.0, 4),
                "p50_ms": round(float(p50), 4),
                "p99_ms": round(float(p99), 4),
            }
        return out
