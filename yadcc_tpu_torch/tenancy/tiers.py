"""Tier x admission-rung shedding matrix and per-tier fan-out rights (a
copy of the JAX package's yadcc_tpu/tenancy/tiers.py, over the port's
own scheduler/admission.py).

The overload ladder (scheduler/admission.py) is tenant-blind: one
global rung decides for everyone.  Tiers make shedding *ordered*: as
the cell degrades, best-effort work is turned away first, batch second,
and interactive traffic keeps its grants until the ladder itself
refuses everyone.

    rung \\ tier       interactive   batch          best_effort
    NORMAL            grant         grant          grant
    SHED_OPTIONAL     grant (no pf) grant (no pf)  REJECT+retry
    SPILLOVER         grant         REJECT+retry   REJECT+retry
    LOCAL_ONLY        compile-local compile-local  compile-local
    REJECT            REJECT        REJECT         REJECT

``apply_tier`` only ever *escalates*: it converts an admission the
ladder would have granted into a native FLOW_REJECT with the ladder's
own retry-after once the rung reaches the tier's shed rung.  Ladder
verdicts at LOCAL_ONLY/REJECT pass through untouched — a tier is a
right to be shed later, never a bypass of the cell's survival valve.
Tier rejections are counted into the ladder's shed-pressure signal by
the caller exactly like native rejections, so a storm of best-effort
demand keeps the signal honest while being refused.

Fan-out rights follow the same ordering: an interactive tenant may hedge
and fan out wide (AOT topologies, autotune sweeps), best-effort gets a
narrow cap.
"""

from __future__ import annotations

from ..scheduler.admission import (
    FLOW_NONE,
    FLOW_REJECT,
    RUNG_LOCAL_ONLY,
    RUNG_REJECT,
    RUNG_SHED_OPTIONAL,
    RUNG_SPILLOVER,
    AdmissionDecision,
)
from .identity import (
    TIER_BATCH,
    TIER_BEST_EFFORT,
    TIER_INTERACTIVE,
)

# The rung at which a tier's *admitted* requests start being refused.
# Interactive maps to RUNG_REJECT: only the ladder itself sheds it.
TIER_SHED_RUNG = {
    TIER_INTERACTIVE: RUNG_REJECT,
    TIER_BATCH: RUNG_SPILLOVER,
    TIER_BEST_EFFORT: RUNG_SHED_OPTIONAL,
}

# Fan-out width caps (children per expansion) by tier; the global
# DEFAULT_MAX_FANOUT_WIDTH (64) still applies on top.
TIER_FANOUT_CAPS = {
    TIER_INTERACTIVE: 64,
    TIER_BATCH: 16,
    TIER_BEST_EFFORT: 4,
}

# Retry-after handed out with a tier rejection when the ladder's own
# decision carried none (the ladder only computes one at RUNG_REJECT).
_TIER_RETRY_AFTER_MS = 500


def tier_shed_rung(tier: str) -> int:
    """Unknown/empty tiers shed first — fail-closed, like identity."""
    return TIER_SHED_RUNG.get(tier, RUNG_SHED_OPTIONAL)


def tier_fanout_cap(tier: str) -> int:
    return TIER_FANOUT_CAPS.get(tier, TIER_FANOUT_CAPS[TIER_BEST_EFFORT])


def apply_tier(decision: AdmissionDecision, tier: str) -> AdmissionDecision:
    """Escalate an admission decision per the tier matrix.

    No-tier callers ("" from a pre-tenancy daemon) are treated as
    best_effort by ``tier_shed_rung`` — an unauthenticated workload
    cannot outrank a paying batch tenant.
    """
    if decision.flow != FLOW_NONE or decision.rung >= RUNG_LOCAL_ONLY:
        return decision  # the ladder already shed; never soften it
    if decision.rung < tier_shed_rung(tier):
        return decision
    return AdmissionDecision(
        rung=decision.rung, flow=FLOW_REJECT,
        retry_after_ms=decision.retry_after_ms or _TIER_RETRY_AFTER_MS,
        prefetch_allowed=False, signal=decision.signal)
