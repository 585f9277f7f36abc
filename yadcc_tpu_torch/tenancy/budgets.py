"""Per-tenant budget ledgers: grants and queued demand (a copy of the JAX
package's yadcc_tpu/tenancy/budgets.py without its cache-bytes ledger,
which waits for the port's cache server).

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
