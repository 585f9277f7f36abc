"""Multi-tenant QoS for the scheduler: verified tenant identity, tiers and
budgets (the port's copy of yadcc_tpu/tenancy/, trimmed to what the
scheduler uses; the cache-side pieces, ``keys`` and the cache-bytes
ledger, wait for the port's cache server).

``identity``   per-tenant credentials HMAC-derived from the scheduler's
               rotating token window, verified fail-closed.
``tiers``      the fairness classes — interactive / batch / best_effort
               — and the tier x admission-rung shedding matrix.
``budgets``    per-tenant outstanding-grant and queued-demand ledger.
"""

from .identity import (
    TIER_BATCH,
    TIER_BEST_EFFORT,
    TIER_INTERACTIVE,
    TenancyControl,
    TenantBinding,
    TenantDirectory,
    TenantSpec,
    derive_tenant_credential,
    tenant_key_secret,
    verify_tenant_credential,
)
from .tiers import (
    TIER_FANOUT_CAPS,
    TIER_SHED_RUNG,
    apply_tier,
    tier_fanout_cap,
    tier_shed_rung,
)
from .budgets import TenantLedger, TenantOverBudget

__all__ = [
    "TIER_BATCH",
    "TIER_BEST_EFFORT",
    "TIER_FANOUT_CAPS",
    "TIER_INTERACTIVE",
    "TIER_SHED_RUNG",
    "TenancyControl",
    "TenantBinding",
    "TenantDirectory",
    "TenantLedger",
    "TenantOverBudget",
    "TenantSpec",
    "apply_tier",
    "derive_tenant_credential",
    "tenant_key_secret",
    "tier_fanout_cap",
    "tier_shed_rung",
    "verify_tenant_credential",
]
