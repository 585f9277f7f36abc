"""Scheduler admission control: the overload ladder.

The reference system's survival property is graceful degradation — when
the cloud can't serve, clients fall back to local compilation instead
of queueing unboundedly (yadcc/README.md:21-27).  This module gives the
scheduler the server half of that contract: an explicit, hysteresis-
guarded ladder of degradation rungs over the dispatcher's live
pool/backlog state, consulted on every WaitForStartingTask BEFORE the
request queues.

    NORMAL        grants flow, prefetch honored
    SHED_OPTIONAL prefetch (opportunistic, low-priority) is dropped;
                  immediate demand still grants
    SPILLOVER     immediate demand still grants, but the cell is
                  overloaded enough that a federated deployment
                  (scheduler/federation.py) forwards grant requests to
                  the least-loaded peer cell before anyone is told to
                  compile locally; a single-cell scheduler treats this
                  rung exactly like SHED_OPTIONAL
    LOCAL_ONLY    grant requests are answered immediately with an
                  explicit compile-locally verdict — the client's CPU
                  is the capacity the cluster no longer has
    REJECT        requests are refused with a server-computed
                  retry-after; even queue admission costs more than the
                  cluster can pay

A request is never silently dropped: every shed action is an explicit
verdict on the wire (api.scheduler.FlowControlVerdict), a counter in
``inspect()``, and a rung in the transition history.

Signal.  ``signal = (outstanding grants + queued immediate demand)/
capacity + shed pressure``, where shed pressure is the demand the
ladder itself turned away within ``demand_window_s``, normalized by
capacity.  The second term is what makes the ladder honest while it is
shedding: under LOCAL_ONLY/REJECT nothing queues, so a purely
queue-based signal would instantly read "idle" and flap.  Instead the
refused demand keeps the signal high exactly as long as the storm
lasts, and decays with the window once it stops.

Hysteresis.  Transitions move ONE rung at a time and only after a
minimum dwell on the current rung (``up_dwell_s`` fast, ``down_dwell_s``
slow), with the step-down threshold a ``down_fraction`` of the step-up
threshold.  Both together bound the transition rate structurally — no
rung flapping, asserted in tests/test_robustness.py with a virtual
clock.

The ladder is deliberately free of dispatcher internals: the dispatcher
computes utilization under its own lock and calls ``decide()`` outside
it, so the ladder's leaf lock never nests inside ``TaskDispatcher._lock``.
"""

from __future__ import annotations

import threading
from collections import deque
from dataclasses import dataclass
from typing import Deque, List, Optional, Tuple

# Rungs, lowest (healthy) first.  Values travel the wire as
# WaitForStartingTaskResponse.degradation_rung.
RUNG_NORMAL = 0
RUNG_SHED_OPTIONAL = 1
RUNG_SPILLOVER = 2
RUNG_LOCAL_ONLY = 3
RUNG_REJECT = 4
RUNG_NAMES = ("NORMAL", "SHED_OPTIONAL", "SPILLOVER", "LOCAL_ONLY",
              "REJECT")

# Flow-control verdicts, mirroring api.scheduler.FlowControlVerdict
# (kept as plain ints so this module never imports protobuf).
FLOW_NONE = 0
FLOW_COMPILE_LOCALLY = 1
FLOW_REJECT = 2


@dataclass
class AdmissionConfig:
    """Ladder tuning.  Defaults are production-shaped: a pool running
    flat-out but draining (signal ~1) never sheds; sustained demand
    beyond ~1.5x capacity starts dropping prefetch, ~2.2x marks the
    cell spillover-eligible (federated deployments forward to a peer
    cell), ~3x pushes clients to their local CPUs, ~6x refuses
    outright."""

    # Step-up thresholds indexed by CURRENT rung: leaving rung r upward
    # requires signal >= up_thresholds[r].
    up_thresholds: Tuple[float, float, float, float] = (1.5, 2.2, 3.0, 6.0)
    # Step down from rung r when signal <= up_thresholds[r-1] * this.
    down_fraction: float = 0.6
    # Minimum dwell on a rung before stepping up / down.  Up is fast
    # (overload hurts now), down is slow (recovery must be proven).
    up_dwell_s: float = 0.25
    down_dwell_s: float = 2.0
    # How long refused demand keeps pressing on the signal.
    demand_window_s: float = 5.0
    # REJECT retry-after: base scaled by overload ratio, clamped.
    retry_after_base_ms: int = 250
    retry_after_max_ms: int = 5000
    # Transition history retained for inspect()/flap analysis.
    history: int = 64


@dataclass
class AdmissionDecision:
    """One admission verdict, consumed by SchedulerService."""

    rung: int
    flow: int                 # FLOW_* (FlowControlVerdict value)
    retry_after_ms: int = 0
    prefetch_allowed: bool = True
    signal: float = 0.0


class OverloadLadder:
    def __init__(self, config: Optional[AdmissionConfig] = None):
        self.config = config or AdmissionConfig()
        self._lock = threading.Lock()
        self._rung = RUNG_NORMAL  # guarded by: self._lock
        self._last_transition = 0.0  # guarded by: self._lock
        self._signal = 0.0  # guarded by: self._lock
        # (when, immediate demand) refused at LOCAL_ONLY/REJECT.
        self._shed: Deque[Tuple[float, int]] = deque()  # guarded by: self._lock
        self._shed_sum = 0  # guarded by: self._lock
        self._transitions: Deque[Tuple[float, int, int]] = deque(
            maxlen=self.config.history)  # guarded by: self._lock
        self._stats = {
            "admitted": 0,
            "prefetch_shed": 0,
            "spillover_eligible": 0,
            "local_only_verdicts": 0,
            "rejected": 0,
        }  # guarded by: self._lock

    # -- the one entry point -------------------------------------------------

    def decide(self, utilization: float, capacity: int, immediate: int,
               prefetch: int, now: float) -> AdmissionDecision:
        """Update the rung from the current signal and rule on one
        request asking for ``immediate``+``prefetch`` grants.

        ``utilization`` is (outstanding grants + queued immediate
        demand) / capacity, computed by the dispatcher under its lock;
        ``capacity`` the pool's total effective capacity.  A pool with
        no capacity at all never engages the ladder — "no servants" has
        its own long-standing failure mode (empty grants after timeout)
        that clients already survive."""
        with self._lock:
            self._advance_locked(utilization, capacity, now)
            rung = self._rung
            if rung >= RUNG_REJECT:
                self._note_shed_locked(immediate, now)
                self._stats["rejected"] += 1
                return AdmissionDecision(
                    rung=rung, flow=FLOW_REJECT,
                    retry_after_ms=self._retry_after_ms_locked(),
                    prefetch_allowed=False, signal=self._signal)
            if rung >= RUNG_LOCAL_ONLY:
                self._note_shed_locked(immediate, now)
                self._stats["local_only_verdicts"] += 1
                return AdmissionDecision(
                    rung=rung, flow=FLOW_COMPILE_LOCALLY,
                    prefetch_allowed=False, signal=self._signal)
            self._stats["admitted"] += 1
            if rung >= RUNG_SPILLOVER:
                # Still admitted here; a FederationRouter in front of
                # this cell forwards the demand to a peer instead.
                self._stats["spillover_eligible"] += 1
            shed_prefetch = rung >= RUNG_SHED_OPTIONAL and prefetch > 0
            if shed_prefetch:
                self._stats["prefetch_shed"] += 1
            return AdmissionDecision(
                rung=rung, flow=FLOW_NONE,
                prefetch_allowed=not shed_prefetch, signal=self._signal)

    def update(self, utilization: float, capacity: int,
               now: float) -> int:
        """Periodic re-evaluation with no request attached (expiration
        sweep): lets the ladder step down while nobody is asking."""
        with self._lock:
            self._advance_locked(utilization, capacity, now)
            return self._rung

    def restore_rung(self, rung: int, now: float) -> None:
        """Warm-standby takeover (scheduler/replication.py): seed the
        ladder with the rung the dead active last journaled, so the new
        scheduler does not greet a mid-storm fleet from NORMAL.  The
        dwell clock restarts — recovery is proven from takeover, not
        inherited."""
        rung = max(RUNG_NORMAL, min(int(rung), RUNG_REJECT))
        with self._lock:
            if rung != self._rung:
                self._step_locked(rung, now)

    # -- read side -----------------------------------------------------------

    def rung(self) -> int:
        with self._lock:
            return self._rung

    def transitions(self) -> List[Tuple[float, int, int]]:
        with self._lock:
            return list(self._transitions)

    def inspect(self) -> dict:
        with self._lock:
            return {
                "rung": self._rung,
                "rung_name": RUNG_NAMES[self._rung],
                "signal": round(self._signal, 3),
                "shed_demand_window": self._shed_sum,
                "stats": dict(self._stats),
                "transitions": [
                    {"at": round(t, 3), "from": RUNG_NAMES[a],
                     "to": RUNG_NAMES[b]}
                    for t, a, b in self._transitions
                ],
            }

    # -- locked internals ----------------------------------------------------

    def _advance_locked(self, utilization: float, capacity: int,
                        now: float) -> None:
        cfg = self.config
        while self._shed and now - self._shed[0][0] > cfg.demand_window_s:
            self._shed_sum -= self._shed.popleft()[1]
        if capacity <= 0:
            self._signal = 0.0
        else:
            self._signal = utilization + self._shed_sum / capacity
        rung = self._rung
        dwell = now - self._last_transition
        if (rung < RUNG_REJECT
                and self._signal >= cfg.up_thresholds[rung]
                and dwell >= cfg.up_dwell_s):
            self._step_locked(rung + 1, now)
        elif (rung > RUNG_NORMAL
                and self._signal
                <= cfg.up_thresholds[rung - 1] * cfg.down_fraction
                and dwell >= cfg.down_dwell_s):
            self._step_locked(rung - 1, now)

    def _step_locked(self, to: int, now: float) -> None:
        self._transitions.append((now, self._rung, to))
        self._rung = to
        self._last_transition = now

    def _note_shed_locked(self, immediate: int, now: float) -> None:
        demand = max(1, immediate)
        self._shed.append((now, demand))
        self._shed_sum += demand

    def _retry_after_ms_locked(self) -> int:
        """Server-computed backoff: scale the base by how far past the
        REJECT threshold the signal sits — the deeper the overload, the
        longer clients stay away — clamped so a confused signal can't
        park the fleet."""
        cfg = self.config
        overshoot = max(1.0, self._signal - cfg.up_thresholds[-1] + 1.0)
        return int(min(cfg.retry_after_base_ms * overshoot,
                       cfg.retry_after_max_ms))
