"""Per-tenant budget ledgers: grants, queued demand and cache bytes (a
copy of the JAX package's yadcc_tpu/tenancy/budgets.py).

Budgets answer a different question than fairness.  The two-level
stride queue shares *available* capacity by weight; a budget bounds
what one tenant may *hold* regardless of how idle the rest of the
fleet is — the blast-radius bound that makes a runaway CI loop a
tenant-local incident.  Enforcement points:

* scheduler grant mint / release  — TenantLedger.charge / release
* scheduler admission (pre-ladder) — TenantLedger.over_budget; an
  over-budget tenant gets a native FLOW_REJECT + retry-after WITHOUT
  touching the ladder, so its refused demand never pushes the global
  signal and cannot starve other tenants into degradation rungs
* cache-entry fill               — CacheBytesLedger.try_charge

All ledgers are leaf locks (nothing is called while they are held).
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

from .identity import TenantDirectory, TenantSpec


class TenantOverBudget(Exception):
    """Raised at an enforcement point when admitting one more unit
    would exceed the tenant's budget.  Carries the tenant id and the
    retry hint the transport layer should surface (HTTP 503 +
    Retry-After at the delegate, FLOW_REJECT + retry_after_ms at the
    scheduler)."""

    def __init__(self, tenant: str, retry_after_ms: int = 500):
        super().__init__(f"tenant {tenant!r} over budget")
        self.tenant = tenant
        self.retry_after_ms = retry_after_ms


class TenantLedger:
    """Outstanding-grant and queued-demand counts per tenant.

    The dispatcher charges at grant mint and releases on every exit
    path (free, expire, zombie-kill, adoption hand-back), so
    ``outstanding`` is exact, not sampled.  Queued demand is the
    pending-waiter immediate count, charged while a request waits.
    """

    def __init__(self, directory: Optional[TenantDirectory] = None):
        self._directory = directory
        self._lock = threading.Lock()
        self._outstanding: Dict[str, int] = {}  # guarded by: self._lock
        self._queued: Dict[str, int] = {}  # guarded by: self._lock

    def _spec(self, tenant: str) -> Optional[TenantSpec]:
        if not tenant or self._directory is None:
            return None
        return self._directory.get(tenant)

    def charge(self, tenant: str, n: int = 1) -> None:
        if not tenant:
            return
        with self._lock:
            self._outstanding[tenant] = self._outstanding.get(tenant, 0) + n

    def release(self, tenant: str, n: int = 1) -> None:
        if not tenant:
            return
        with self._lock:
            left = self._outstanding.get(tenant, 0) - n
            if left > 0:
                self._outstanding[tenant] = left
            else:
                self._outstanding.pop(tenant, None)

    def charge_queued(self, tenant: str, n: int = 1) -> None:
        if not tenant:
            return
        with self._lock:
            self._queued[tenant] = self._queued.get(tenant, 0) + n

    def release_queued(self, tenant: str, n: int = 1) -> None:
        if not tenant:
            return
        with self._lock:
            left = self._queued.get(tenant, 0) - n
            if left > 0:
                self._queued[tenant] = left
            else:
                self._queued.pop(tenant, None)

    def outstanding(self, tenant: str) -> int:
        with self._lock:
            return self._outstanding.get(tenant, 0)

    def queued(self, tenant: str) -> int:
        with self._lock:
            return self._queued.get(tenant, 0)

    def over_budget(self, tenant: str, want_immediate: int = 0) -> bool:
        """Would granting ``want_immediate`` more put the tenant over
        either budget?  Tenants without a directory row (or with 0
        limits) are unbudgeted — budgets are an opt-in bound, identity
        is the fail-closed part."""
        spec = self._spec(tenant)
        if spec is None:
            return False
        with self._lock:
            out = self._outstanding.get(tenant, 0)
            queued = self._queued.get(tenant, 0)
        if spec.max_outstanding and out + want_immediate > spec.max_outstanding:
            return True
        if spec.max_queued and queued >= spec.max_queued:
            return True
        return False

    def inspect(self) -> dict:
        with self._lock:
            return {
                "outstanding": dict(self._outstanding),
                "queued": dict(self._queued),
            }


class CacheBytesLedger:
    """Write-quota accounting per cache namespace (keys.key_namespace).

    Tracks an UPPER BOUND on live bytes: per-key sizes are remembered
    so a same-key overwrite adjusts rather than double-counts, but
    evictions below this service are not observed — the quota bounds
    what a tenant may *write into* the cache, which is the poisoning/
    flooding vector budgets exist for.  The legacy "" namespace (shared
    single-tenant domain) is never budgeted.
    """

    def __init__(self, budgets: Optional[Dict[str, int]] = None):
        # namespace tag -> byte budget (0/absent = unlimited).
        self._budgets = dict(budgets or {})
        self._lock = threading.Lock()
        self._key_bytes: Dict[str, Dict[str, int]] = {}  # guarded by: self._lock
        self._usage: Dict[str, int] = {}  # guarded by: self._lock
        self._rejected: Dict[str, int] = {}  # guarded by: self._lock

    def set_budget(self, namespace: str, budget_bytes: int) -> None:
        with self._lock:
            if budget_bytes:
                self._budgets[namespace] = budget_bytes
            else:
                self._budgets.pop(namespace, None)

    def try_charge(self, namespace: str, key: str, size: int) -> bool:
        """Account one fill; False = over budget (caller must refuse
        the write).  Unbudgeted namespaces always charge successfully
        (usage is still tracked for inspect())."""
        if not namespace:
            return True
        with self._lock:
            per_key = self._key_bytes.setdefault(namespace, {})
            old = per_key.get(key, 0)
            budget = self._budgets.get(namespace, 0)
            new_usage = self._usage.get(namespace, 0) - old + size
            if budget and new_usage > budget:
                self._rejected[namespace] = self._rejected.get(namespace, 0) + 1
                return False
            per_key[key] = size
            self._usage[namespace] = new_usage
            return True

    def usage(self, namespace: str) -> int:
        with self._lock:
            return self._usage.get(namespace, 0)

    def inspect(self) -> dict:
        with self._lock:
            return {
                "usage_bytes": dict(self._usage),
                "budgets": dict(self._budgets),
                "rejected_fills": dict(self._rejected),
            }
