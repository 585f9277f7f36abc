"""Multi-tenant QoS: verified tenant identity, tiers, budgets and
tenant-scoped cache keys (the port's copy of yadcc_tpu/tenancy/).

``identity``   per-tenant credentials HMAC-derived from the scheduler's
               rotating token window, verified fail-closed.
``tiers``      the fairness classes — interactive / batch / best_effort
               — and the tier x admission-rung shedding matrix.
``budgets``    per-tenant outstanding-grant, queued-demand and
               cache-bytes ledgers.
``keys``       the tenant-domain cache-key separator and the public
               namespace tag the cache server accounts by.
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
from .budgets import CacheBytesLedger, TenantLedger, TenantOverBudget
from .keys import key_namespace, tenant_scoped_key

__all__ = [
    "CacheBytesLedger",
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
    "key_namespace",
    "tenant_key_secret",
    "tenant_scoped_key",
    "tier_fanout_cap",
    "tier_shed_rung",
    "verify_tenant_credential",
]
