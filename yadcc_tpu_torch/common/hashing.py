"""Content digests (a copy of the JAX package's yadcc_tpu/common/hashing.py,
trimmed to what the port uses, kept in the port so that it stands alone).

BLAKE2b-256 from the standard library's hashlib; the hex digests are
opaque strings to every protocol.  Tenant credentials and cache secrets
are keyed digests (tenancy/identity.py, tenancy/keys.py); the disk cache
names its files by ``digest_bytes`` of the key (common/disk_cache.py), so
a directory either package filled reads back through the other.  The
servant's compiler registry names each compiler by ``digest_file``, so a
delegate of either package asks for the same environment.  The client
digests its preprocessed source as it streams (``DigestingWriter``).
"""

from __future__ import annotations

import hashlib
import os
from typing import BinaryIO

_DIGEST_SIZE = 32


def new_digest():
    return hashlib.blake2b(digest_size=_DIGEST_SIZE)


def digest_bytes(*parts: bytes) -> str:
    """Digest of the concatenation of `parts`, hex-encoded."""
    h = new_digest()
    for p in parts:
        h.update(p)
    return h.hexdigest()


def digest_keyed(domain: str, *parts: bytes) -> str:  # ytpu: sanitizes(key-domain)
    """Domain-separated digest: each part is length-prefixed so component
    boundaries can't be confused (unlike plain concatenation)."""
    h = hashlib.blake2b(digest_size=_DIGEST_SIZE, person=domain.encode()[:16])
    for p in parts:
        h.update(len(p).to_bytes(8, "little"))
        h.update(p)
    return h.hexdigest()


def digest_stream(fp: BinaryIO, chunk_size: int = 1 << 20) -> str:
    h = new_digest()
    while True:
        chunk = fp.read(chunk_size)
        if not chunk:
            break
        h.update(chunk)
    return h.hexdigest()


def digest_file(path: str | os.PathLike) -> str:
    with open(path, "rb") as fp:
        return digest_stream(fp)


class DigestingWriter:
    """Output-stream sink that digests everything written through it.

    Mirrors the client's Blake3OutputStream (reference
    yadcc/client/common/output_stream.{h,cc}) so preprocessing can stream
    into compression and hashing in a single pass.
    """

    def __init__(self):
        self._h = new_digest()
        self.bytes_written = 0

    def write(self, data: bytes) -> int:
        self._h.update(data)
        self.bytes_written += len(data)
        return len(data)

    def hexdigest(self) -> str:
        return self._h.hexdigest()
