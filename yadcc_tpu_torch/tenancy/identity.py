"""Tenant identity: credentials, tiers, and the tenant directory (a copy
of the JAX package's yadcc_tpu/tenancy/identity.py, kept in the port so
that it stands alone: credentials minted by either package verify in the
other).

Credentials ride the scheduler's existing trust anchor instead of
inventing a second one.  The scheduler already rotates a serving-daemon
token window hourly (scheduler/service.py ServingDaemonTokenRoll) and
every daemon learns the acceptable window via GetConfig/Heartbeat.  A
tenant credential is an HMAC sub-token of a window token:

    ytpu-tn1.<tenant_id>.<mac>
    mac = BLAKE2b(person="ytpu-tenant-cred", window_token, tenant_id)[:32]

Properties this buys for free:

* **Offline-derivable** — any component holding a window token (the
  delegate daemon, the scheduler, a provisioning job) can mint a
  tenant's credential without a round trip or a credential database.
* **Revocable by rotation** — credentials die with their window token;
  the whole fleet's tenant credentials roll over on the scheduler's
  existing hourly cadence with zero extra machinery.
* **Fail-closed** — verification against an EMPTY acceptable-token set
  rejects everything, exactly like the daemon-token check it mirrors.

The *cache* secret is deliberately NOT derived from the rotating
window: cache keys must survive rotation or every tenant would go cold
hourly.  ``tenant_key_secret`` derives a stable per-tenant secret from
a long-lived root secret held only by trusted infrastructure (the
delegate daemon and the servant — never the client), so tenant B can
neither compute tenant A's cache namespace nor forge entries into it.
"""

from __future__ import annotations

import hmac
import threading
from dataclasses import dataclass
from typing import Callable, Dict, Iterable, Optional

from ..common.hashing import digest_keyed

# Fairness classes (tiers), ordered most- to least-latency-sensitive.
# The tier decides when a tenant is shed by the overload ladder
# (tiers.TIER_SHED_RUNG) and how wide it may fan out (TIER_FANOUT_CAPS).
TIER_INTERACTIVE = "interactive"
TIER_BATCH = "batch"
TIER_BEST_EFFORT = "best_effort"
TIERS = (TIER_INTERACTIVE, TIER_BATCH, TIER_BEST_EFFORT)

_CRED_PREFIX = "ytpu-tn1"
_CRED_DOMAIN = "ytpu-tenant-cred"
_ROOT_DOMAIN = "ytpu-tenant-root"
_MAC_HEX_LEN = 32


def derive_tenant_credential(window_token: str, tenant_id: str) -> str:
    """Mint the credential for ``tenant_id`` under one window token.

    Dots delimit the wire form, so tenant ids must not contain them;
    ids are operator-assigned short names (org slugs), not user input.
    """
    if not window_token or not tenant_id or "." in tenant_id:
        raise ValueError("tenant_id must be non-empty and dot-free")
    mac = digest_keyed(_CRED_DOMAIN, window_token.encode(),
                       tenant_id.encode())[:_MAC_HEX_LEN]
    return f"{_CRED_PREFIX}.{tenant_id}.{mac}"


def verify_tenant_credential(credential: str,
                             acceptable_tokens: Iterable[str]
                             ) -> Optional[str]:
    """Verify a credential against the acceptable window tokens.

    Returns the tenant id on success, None otherwise.  Fail-closed: an
    empty window rejects everything.  Comparison is constant-time per
    candidate token (hmac.compare_digest), mirroring the hardened
    daemon-token check in daemon_service._verify.
    """
    if not credential:
        return None
    parts = credential.split(".")
    if len(parts) != 3 or parts[0] != _CRED_PREFIX:
        return None
    tenant_id, mac = parts[1], parts[2]
    if not tenant_id or "." in tenant_id:
        return None
    ok = False
    for token in acceptable_tokens:
        want = digest_keyed(_CRED_DOMAIN, token.encode(),
                            tenant_id.encode())[:_MAC_HEX_LEN]
        # No early exit: every candidate is compared so timing does not
        # reveal which window position (if any) matched.
        if hmac.compare_digest(mac, want):
            ok = True
    return tenant_id if ok else None


def tenant_key_secret(root_secret: str, tenant_id: str) -> str:
    """Stable per-tenant cache secret, derived from the long-lived root.

    Held by trusted infrastructure only (delegate + servant).  Knowing
    one tenant's secret reveals nothing about another's — each is an
    independent keyed digest of the root.
    """
    if not root_secret or not tenant_id:
        return ""
    return digest_keyed(_ROOT_DOMAIN, root_secret.encode(),
                        tenant_id.encode())


@dataclass(frozen=True)
class TenantSpec:
    """Operator-declared per-tenant policy (the directory row)."""

    tenant_id: str
    tier: str = TIER_BATCH
    # Fairness weight at the tenant stride level (FairGrantQueue): two
    # tenants with weights 3 and 1 share grants 3:1 under contention.
    weight: float = 1.0
    # Scheduler-side budget: outstanding grants this tenant may hold
    # across the pool.  0 = unlimited.
    max_outstanding: int = 0
    # Scheduler-side budget: immediate demand this tenant may have
    # queued (pending waiters) before new asks are refused.  0 = unlimited.
    max_queued: int = 0
    # Cache-fill write quota in bytes (cache/service.py).  0 = unlimited.
    cache_bytes_budget: int = 0
    # Fan-out width cap for this tenant's AOT/autotune expansions;
    # 0 = the tier default (tiers.TIER_FANOUT_CAPS).
    fanout_cap: int = 0


@dataclass(frozen=True)
class TenantBinding:
    """A verified identity plus everything the dataplane needs from it.

    Produced by TenancyControl.authenticate; stamped onto tasks at the
    delegate HTTP surface and threaded to the scheduler and the cache
    key derivation.  ``key_secret`` never leaves trusted daemons.
    """

    tenant_id: str
    tier: str
    weight: float
    key_secret: str
    spec: TenantSpec


class TenantDirectory:
    """The set of tenants this cell serves.

    Fail-closed: authenticating a credential for a tenant id that has
    no directory row is a rejection, not a default admission — an
    attacker who mints a syntactically valid credential for a made-up
    tenant (possible for anyone holding a window token) still gets 403.
    """

    def __init__(self, specs: Iterable[TenantSpec] = ()):
        self._specs: Dict[str, TenantSpec] = {}
        for spec in specs:
            self.add(spec)

    def add(self, spec: TenantSpec) -> None:
        if spec.tier not in TIERS:
            raise ValueError(f"unknown tier {spec.tier!r}")
        self._specs[spec.tenant_id] = spec

    def get(self, tenant_id: str) -> Optional[TenantSpec]:
        return self._specs.get(tenant_id)

    def tenant_ids(self) -> list:
        return sorted(self._specs)

    def __len__(self) -> int:
        return len(self._specs)


class TenancyControl:
    """Authentication + policy lookup for one trust surface.

    Wraps the three inputs every surface needs — the tenant directory,
    the long-lived root cache secret, and a provider of the currently
    acceptable window tokens — behind one ``authenticate`` call, so the
    delegate HTTP front end, the scheduler service, and tests all share
    the identical fail-closed path.
    """

    def __init__(self, directory: TenantDirectory, root_secret: str,
                 acceptable_tokens: Callable[[], Iterable[str]]):
        self.directory = directory
        self._root_secret = root_secret
        self._acceptable_tokens = acceptable_tokens
        self._lock = threading.Lock()
        self._stats = {"authenticated": 0, "rejected": 0}  # guarded by: self._lock

    def authenticate(self, credential: str) -> Optional[TenantBinding]:
        tenant_id = verify_tenant_credential(
            credential, self._acceptable_tokens())
        spec = self.directory.get(tenant_id) if tenant_id else None
        if spec is None:
            with self._lock:
                self._stats["rejected"] += 1
            return None
        with self._lock:
            self._stats["authenticated"] += 1
        return TenantBinding(
            tenant_id=spec.tenant_id, tier=spec.tier, weight=spec.weight,
            key_secret=tenant_key_secret(self._root_secret, spec.tenant_id),
            spec=spec)

    def credential_for(self, tenant_id: str) -> str:
        """Mint a credential under the newest acceptable token (test and
        provisioning convenience; offline derivation needs no server)."""
        tokens = list(self._acceptable_tokens())
        if not tokens:
            raise RuntimeError("no acceptable window tokens")
        return derive_tenant_credential(tokens[0], tenant_id)

    def inspect(self) -> dict:
        with self._lock:
            stats = dict(self._stats)
        return {"tenants": self.directory.tenant_ids(), "stats": stats}
