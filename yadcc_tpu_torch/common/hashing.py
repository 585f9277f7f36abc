"""Domain-separated content digests (a copy of the JAX package's
``digest_keyed``, yadcc_tpu/common/hashing.py, kept in the port so that
it stands alone).

BLAKE2b-256 from the standard library's hashlib, personalised by the
domain; the hex digests are opaque strings to every protocol.  Tenant
credentials and cache secrets are keyed digests (tenancy/identity.py).
"""

from __future__ import annotations

import hashlib

_DIGEST_SIZE = 32


def digest_keyed(domain: str, *parts: bytes) -> str:
    """Domain-separated digest: each part is length-prefixed so component
    boundaries can't be confused (unlike plain concatenation)."""
    h = hashlib.blake2b(digest_size=_DIGEST_SIZE, person=domain.encode()[:16])
    for p in parts:
        h.update(len(p).to_bytes(8, "little"))
        h.update(p)
    return h.hexdigest()
