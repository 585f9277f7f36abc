"""Dispatch cost model: the scheduling policy's constants, declaratively.

The reference hard-codes its servant-selection heuristics inside
TaskDispatcher (yadcc/scheduler/task_dispatcher.cc:362-451): never pick
ineligible servants, prefer dedicated servants under 50% load (SMT
heuristic — the second hyperthread of a core contributes far less), avoid
assigning a requestor its own task, and among the rest pick the minimum
running/capacity utilization.  This framework expresses the same policy
as a small set of named constants consumed by both implementations of the
DispatchPolicy SPI — the greedy CPU oracle and the batched device kernel
— so the two can never drift apart silently.
"""

from __future__ import annotations

from dataclasses import dataclass


# Utilization is fixed-point (util_q = running * UTIL_SCALE // capacity):
# float division is backend-dependent at the last ulp (XLA may lower f32
# div to reciprocal-multiply), which broke device-vs-oracle tie-breaking
# on mathematically equal utilizations like 12/28 vs 9/21.  Integer math
# is exact, deterministic everywhere, and cheaper on TPU.  With capacity
# bounded by ~4096 cores, running*65536 stays far inside int32.
UTIL_SCALE = 65536


@dataclass(frozen=True)
class DispatchCostModel:
    # Dedicated servants below this utilization are preferred outright
    # over any non-dedicated servant (reference task_dispatcher.cc:399-410).
    # Fixed-point, UTIL_SCALE denominator (default: 50%).
    dedicated_preference_utilization_q: int = UTIL_SCALE // 2

    # Never hand a requestor its own task: compiling locally through the
    # network path would only add overhead (reference :370-379).
    avoid_self: bool = True

    # Score offset subtracted for preferred-dedicated candidates; larger
    # than any possible utilization (UTIL_SCALE) so the tier ordering is
    # strict.
    preference_bonus_q: int = 4 * UTIL_SCALE

    # Score assigned to non-candidates; dominates every real score.
    infeasible_score_q: int = 1 << 30


DEFAULT_COST_MODEL = DispatchCostModel()
