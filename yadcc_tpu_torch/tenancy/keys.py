"""Tenant-domain cache-key derivation (a copy of the JAX package's
yadcc_tpu/tenancy/keys.py on the port's common/hashing.py).

The determinism that makes fleet-wide cache sharing valuable is also
the leak: identical computations hash to identical keys (PAPERS.md,
Frostig et al.), so tenant B can *guess* tenant A's plaintext cache key
from public inputs and either read A's artifact or poison the entry A
will read next.  Prefix conventions don't help — B can write any key
string it likes.  Isolation must be cryptographic:

    tenant key = "ytpu-t-" + ns + "-" + MAC
    ns  = BLAKE2b(person="ytpu-tenant-ns",    key_secret)[:16]
    MAC = BLAKE2b(person="ytpu-tenant-cache", key_secret, plain_key)

``key_secret`` is the tenant's stable cache secret
(identity.tenant_key_secret), held only by trusted daemons.  Without
it, B can neither compute A's key for a known computation (no read)
nor produce a key A will later derive (no poison) — a forged write
lands in whatever namespace B's own secret spans.  The ``ns`` tag is
deliberately public-by-construction (it reveals *which* tenant, never
*what* computation): the cache service groups per-tenant usage
accounting and byte budgets by it without holding any secrets.

An EMPTY secret returns the plaintext key unchanged.  That is the
single-tenant/legacy mode: every historical entry, the dataplane
parity gate, and any deployment that never configures tenancy keep
byte-identical keys.

Shared probabilistic structures stay shared.  Bloom filters and
prefetch traces operate on these derived keys: a membership bit or a
trace line reveals only that *some* opaque MAC exists, and without the
tenant secret no observer can map a MAC back to a computation or
derive a colliding key — so sharing them across tenants leaks nothing
useful (doc/tenancy.md "Threat model").
"""

from __future__ import annotations

from ..common.hashing import digest_keyed

_SCOPED_PREFIX = "ytpu-t-"
_NS_DOMAIN = "ytpu-tenant-ns"
_MAC_DOMAIN = "ytpu-tenant-cache"
_NS_HEX_LEN = 16


def tenant_scoped_key(tenant_secret: str, key: str) -> str:  # ytpu: sanitizes(tenant-domain, key-domain)
    """Derive the tenant-scoped form of ``key``.

    Empty ``tenant_secret`` is the legacy/shared domain: the key passes
    through unchanged (byte-for-byte compatible with every entry ever
    written).  The derived form keeps no plaintext: the MAC covers the
    full original key, prefix included, so the per-workload versioned
    namespaces (``ytpu-cxx2-entry-`` ...) survive inside the MAC domain.
    """
    if not tenant_secret:
        return key
    ns = digest_keyed(_NS_DOMAIN, tenant_secret.encode())[:_NS_HEX_LEN]
    mac = digest_keyed(_MAC_DOMAIN, tenant_secret.encode(), key.encode())
    return f"{_SCOPED_PREFIX}{ns}-{mac}"


def key_namespace(key: str) -> str:
    """The public namespace tag of a scoped key; "" for legacy keys.

    The cache service keys its per-tenant byte ledgers on this — it
    needs no secrets, only the ability to group writes by tenant.
    """
    if not key.startswith(_SCOPED_PREFIX):
        return ""
    rest = key[len(_SCOPED_PREFIX):]
    ns, sep, mac = rest.partition("-")
    if not sep or len(ns) != _NS_HEX_LEN or not mac:
        return ""
    return ns
