"""Compilation cache-entry wire format (a copy of the JAX package's
yadcc_tpu/daemon/cache_format.py: the entry format and the C++, jit, AOT
and autotune keys and kinds, byte for byte, so both packages' servants,
delegates and caches share entries).

Parity with reference yadcc/daemon/cache_format.cc:35-127: an entry
bundles the compiler's exit code, stdout/stderr, the produced output
files (individually zstd-compressed) and their path-patch locations,
with an integrity digest so a corrupted entry is detected instead of
linking garbage into the user's build.  The digest covers the file
payloads AND the meta fields (exit code, streams, patch offsets): a
flipped patch offset corrupts the object just as surely as a flipped
payload byte.

Layout:  b"YTC2" + u32 meta_len + CacheMeta-JSON + multi_chunk(files)
where CacheMeta.entry_digest = digest(meta-sans-digest + body)

Cache keys are derived from the task digest (reference :56-64), i.e.
compiler + args + preprocessed source.  Every key helper then routes
through the tenant-domain separator (tenancy/keys.py): with a tenant
secret the key is HMAC-scoped to that tenant's namespace (cross-tenant
reads and poisons are cryptographically impossible); with the default
empty secret the legacy key passes through byte-identical, which is
what the dataplane parity gate and historical entries rely on.
"""

from __future__ import annotations

import json
import struct
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ..common.hashing import new_digest
from ..common.multi_chunk import try_parse_multi_chunk_views
from ..common.payload import Payload
from ..common.hashing import digest_keyed
from ..tenancy.keys import tenant_scoped_key
from .task_digest import (
    get_aot_task_digest,
    get_autotune_task_digest,
    get_cxx_task_digest,
    get_jit_task_digest,
)

_MAGIC = b"YTC2"
_LEN = struct.Struct("<I")

# Bump the key prefix on any format change: old entries become silent
# misses instead of parse failures (reference cache_format.cc:56-64).
_KEY_PREFIX = "ytpu-cxx2-entry-"
# Second workload, own versioned namespace: a jit artifact can never be
# read back as a C++ object file even if key derivation ever collided.
_JIT_KEY_PREFIX = "ytpu-jit1-entry-"
# Workloads 3 & 4 (doc/workloads.md): per-topology AOT executables and
# autotune winning-config records — separate versioned namespaces, same
# two-factor guarantee (prefix + integrity-covered kind field).
_AOT_KEY_PREFIX = "ytpu-aot1-entry-"
_AUTOTUNE_KEY_PREFIX = "ytpu-tune1-entry-"

# Entry kinds.  "cxx" is the wire default and is OMITTED from the
# serialized meta, so every historical entry (and the dataplane A/B
# parity gate against the legacy writer) stays byte-identical.
KIND_CXX = "cxx"
KIND_JIT = "jit"
KIND_AOT = "aot"
KIND_AUTOTUNE = "autotune"


@dataclass
class CacheEntry:
    exit_code: int
    standard_output: bytes
    standard_error: bytes
    # file key (extension like ".o") -> zstd-compressed content
    # (bytes-like: parsed entries hand back views into the entry buffer).
    files: Dict[str, bytes]
    # file key -> [(position, total_size, suffix_to_keep)].
    patches: Dict[str, List[Tuple[int, int, bytes]]] = field(
        default_factory=dict)
    # Workload kind (KIND_*): parsers reject an entry of the wrong kind
    # as a miss, so a task type can only ever consume its own entries.
    kind: str = KIND_CXX


def get_cache_key(compiler_digest: str, invocation_arguments: str,
                  source_digest: str,
                  tenant_secret: str = "") -> str:  # ytpu: sanitizes(key-domain, tenant-domain)
    return tenant_scoped_key(tenant_secret, _KEY_PREFIX + get_cxx_task_digest(
        compiler_digest, invocation_arguments, source_digest))


def get_jit_cache_key(env_digest: str, compile_options: bytes,
                      computation_digest: str,
                      tenant_secret: str = "") -> str:  # ytpu: sanitizes(key-domain, tenant-domain)
    return tenant_scoped_key(
        tenant_secret, _JIT_KEY_PREFIX + get_jit_task_digest(
            env_digest, compile_options, computation_digest))


def get_aot_cache_key(env_digest: str, topology_digest: str,
                      computation_digest: str,
                      tenant_secret: str = "") -> str:  # ytpu: sanitizes(key-domain, tenant-domain)
    """One AOT child's executable: topology-tagged, so a resubmission
    that adds topologies re-reads the hits and compiles only the
    misses (partial-hit reuse, doc/workloads.md)."""
    return tenant_scoped_key(
        tenant_secret, _AOT_KEY_PREFIX + get_aot_task_digest(
            env_digest, topology_digest, computation_digest))


def get_autotune_cache_key(env_digest: str, slice_digest: str,
                           kernel_digest: str,
                           tenant_secret: str = "") -> str:  # ytpu: sanitizes(key-domain, tenant-domain)
    """One autotune child's slice-winner record."""
    return tenant_scoped_key(
        tenant_secret, _AUTOTUNE_KEY_PREFIX + get_autotune_task_digest(
            env_digest, slice_digest, kernel_digest))


def get_autotune_sweep_key(env_digest: str, space_digest: str,
                           kernel_digest: str,
                           tenant_secret: str = "") -> str:  # ytpu: sanitizes(key-domain, tenant-domain)
    """The SWEEP-level winner record — (kernel digest, search-space
    digest, env digest) — filled by the delegate after the reduce, so
    a second host sweeping the identical space gets the final answer
    in one cache read with zero fan-out.  Domain-separated from the
    per-slice child keys: a slice record can never be read back as a
    sweep verdict."""
    return tenant_scoped_key(
        tenant_secret, _AUTOTUNE_KEY_PREFIX + digest_keyed(
            "ytpu-autotune-sweep", env_digest.encode(),
            space_digest.encode(), kernel_digest.encode()))


def write_cache_entry_payload(entry: CacheEntry) -> Payload:
    """Gather form: [magic+len+meta] ++ [chunk header] ++ file buffers.

    The integrity digest is fed incrementally (meta, then the body
    segments) instead of materializing ``canonical + body`` — for a
    multi-MB object that concatenation was a full extra copy of the
    entry just to hash it.  Wire bytes are identical to the historical
    single-buffer writer (parity-tested)."""
    file_keys = sorted(entry.files)
    chunks = [entry.files[k] for k in file_keys]
    # The multi-chunk body = length header + concatenated chunks; keep
    # the header as its own segment so chunks are never copied.
    body_header = ",".join(str(len(c)) for c in chunks).encode() + b"\r\n"
    meta = {
        "exit_code": entry.exit_code,
        "stdout_hex": entry.standard_output.hex(),
        "stderr_hex": entry.standard_error.hex(),
        "file_keys": file_keys,
        "patches": {
            k: [[p, t, s.hex()] for p, t, s in v]
            for k, v in entry.patches.items()
        },
    }
    if entry.kind != KIND_CXX:
        # "cxx" stays implicit (see KIND_CXX note): the kind key is
        # integrity-covered like every other meta field.
        meta["kind"] = entry.kind
    # Digest over the serialized meta (sort_keys: canonical form) plus
    # the body, so every field is integrity-protected.
    h = new_digest()
    h.update(json.dumps(meta, sort_keys=True).encode())
    h.update(body_header)
    for c in chunks:
        h.update(c)
    meta["entry_digest"] = h.hexdigest()
    meta_bytes = json.dumps(meta).encode()
    return Payload.of(_MAGIC + _LEN.pack(len(meta_bytes)) + meta_bytes,
                      body_header, *chunks)


def write_cache_entry(entry: CacheEntry) -> bytes:
    return write_cache_entry_payload(entry).join()


def try_parse_cache_entry(data,
                          expect_kind: str = KIND_CXX
                          ) -> Optional[CacheEntry]:
    """None on any corruption — a bad entry must read as a miss.

    ``expect_kind`` guards cross-workload reads: an entry of another
    kind parses as a miss, not as garbage handed to the wrong consumer
    (the key-prefix namespaces should already prevent this; the kind
    check makes it a two-factor guarantee).

    Accepts ``bytes``, a ``memoryview`` (an RPC attachment still backed
    by its frame) or a ``Payload``; file contents come back as views
    into the entry buffer — one digest pass, zero body copies."""
    try:
        if isinstance(data, Payload):
            data = data.join()
        mv = memoryview(data)
        if bytes(mv[:4]) != _MAGIC:
            return None
        (meta_len,) = _LEN.unpack_from(mv, 4)
        meta_end = 8 + meta_len
        meta = json.loads(bytes(mv[8:meta_end]))
        body = mv[meta_end:]
        claimed = meta.pop("entry_digest")
        canonical = json.dumps(meta, sort_keys=True).encode()
        h = new_digest()
        h.update(canonical)
        h.update(body)
        if claimed != h.hexdigest():
            return None  # integrity failure (meta or body tampered)
        if meta.get("kind", KIND_CXX) != expect_kind:
            return None  # wrong workload's entry: a miss, not data
        chunks = try_parse_multi_chunk_views(body)
        if chunks is None or len(chunks) != len(meta["file_keys"]):
            return None
        return CacheEntry(
            exit_code=meta["exit_code"],
            standard_output=bytes.fromhex(meta["stdout_hex"]),
            standard_error=bytes.fromhex(meta["stderr_hex"]),
            files=dict(zip(meta["file_keys"], chunks)),
            patches={
                k: [(p, t, bytes.fromhex(s)) for p, t, s in v]
                for k, v in meta.get("patches", {}).items()
            },
            kind=meta.get("kind", KIND_CXX),
        )
    except Exception:
        return None
