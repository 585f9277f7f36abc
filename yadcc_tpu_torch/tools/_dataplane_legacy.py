"""The pre-zero-copy data plane, preserved for A/B measurement (a copy of
the JAX package's yadcc_tpu/tools/_dataplane_legacy.py over the port's
payload, compress, hashing and cache-format modules).

These are byte-identical re-implementations of the byte path as it
existed before the Payload refactor: every chunk body copied on parse,
every frame built by concatenation, the cache entry digested over a
``canonical + body`` concatenation, the servant source decompressed and
then re-scanned to digest, per-file outputs compressed serially.  Their
materializations are charged to the same copy meter the Payload layer
uses (``common.payload.count_copy``), so "copies per task" is measured
identically on both sides of the A/B.

Used by ``tools/dataplane_bench`` (stage sweeps, the e2e cluster A/B,
and the parity smoke).  Not imported by any production code path.
"""

from __future__ import annotations

import json
import threading
from contextlib import ExitStack, contextmanager
from typing import Dict, List, Optional, Tuple

from ..common import compress
from ..common.hashing import digest_bytes
from ..common.payload import Payload, count_copy
from ..daemon.cache_format import _KEY_PREFIX  # noqa: F401  (same keys)
from ..daemon.cache_format import _LEN, _MAGIC, CacheEntry

# ---------------------------------------------------------------------------
# multi-chunk framing (pre-PR: join on make, copy-per-chunk on parse)
# ---------------------------------------------------------------------------


def legacy_make_multi_chunk(chunks) -> bytes:
    header = ",".join(str(len(c)) for c in chunks).encode()
    body = b"".join(bytes(c) if not isinstance(c, (bytes, bytearray))
                    else c for c in chunks)
    count_copy(len(body))                      # the chunk join
    out = header + b"\r\n" + body
    count_copy(len(out))                       # the header+body concat
    return out


def legacy_try_parse_multi_chunk(data) -> Optional[List[bytes]]:
    if not isinstance(data, (bytes, bytearray)):
        data = bytes(data)
    eol = data.find(b"\r\n")
    if eol < 0:
        return None
    header = data[:eol]
    body = memoryview(data)[eol + 2:]
    if not header:
        return [] if len(body) == 0 else None
    try:
        lengths = [int(x) for x in header.split(b",")]
    except ValueError:
        return None
    if any(l < 0 for l in lengths) or sum(lengths) != len(body):
        return None
    chunks: List[bytes] = []
    off = 0
    for l in lengths:
        chunks.append(bytes(body[off:off + l]))
        off += l
    count_copy(sum(lengths))                   # per-chunk body copies
    return chunks


def legacy_try_parse_multi_chunk_views(data):
    # Drop-in for the views seam: same copying behavior, and bytes ARE
    # views' supertype for every downstream consumer.
    return legacy_try_parse_multi_chunk(data)


def legacy_make_multi_chunk_payload(chunks) -> Payload:
    return Payload.from_bytes(legacy_make_multi_chunk(chunks))


# ---------------------------------------------------------------------------
# keyed buffers (servant output attachment)
# ---------------------------------------------------------------------------


def legacy_pack_keyed_buffers(buffers: Dict[str, bytes]) -> bytes:
    chunks: List[bytes] = []
    for key in sorted(buffers):
        chunks.append(key.encode())
        chunks.append(buffers[key])
    return legacy_make_multi_chunk(chunks)


def legacy_pack_keyed_buffers_payload(buffers) -> Payload:
    return Payload.from_bytes(legacy_pack_keyed_buffers(buffers))


def legacy_try_unpack_keyed_buffers(data) -> Optional[Dict[str, bytes]]:
    chunks = legacy_try_parse_multi_chunk(data)
    if chunks is None or len(chunks) % 2 != 0:
        return None
    out: Dict[str, bytes] = {}
    for i in range(0, len(chunks), 2):
        try:
            key = chunks[i].decode()
        except UnicodeDecodeError:
            return None
        out[key] = chunks[i + 1]
    return out


# ---------------------------------------------------------------------------
# cache-entry format (pre-PR: digest over `canonical + body` concat)
# ---------------------------------------------------------------------------


def legacy_write_cache_entry(entry: CacheEntry) -> bytes:
    file_keys = sorted(entry.files)
    chunks = [entry.files[k] for k in file_keys]
    body = legacy_make_multi_chunk(chunks)
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
    canonical = json.dumps(meta, sort_keys=True).encode()
    concat = canonical + body
    count_copy(len(concat))                    # digest-input concat
    meta["entry_digest"] = digest_bytes(concat)
    meta_bytes = json.dumps(meta).encode()
    out = _MAGIC + _LEN.pack(len(meta_bytes)) + meta_bytes + body
    count_copy(len(out))                       # final frame concat
    return out


def legacy_write_cache_entry_payload(entry: CacheEntry) -> Payload:
    return Payload.from_bytes(legacy_write_cache_entry(entry))


def legacy_try_parse_cache_entry(data) -> Optional[CacheEntry]:
    try:
        if isinstance(data, Payload):
            data = data.join()
        elif not isinstance(data, (bytes, bytearray)):
            data = bytes(data)
        if not data.startswith(_MAGIC):
            return None
        (meta_len,) = _LEN.unpack_from(data, 4)
        meta_end = 8 + meta_len
        meta = json.loads(data[8:meta_end])
        body = data[meta_end:]
        count_copy(len(body))                  # body slice copy
        claimed = meta.pop("entry_digest")
        canonical = json.dumps(meta, sort_keys=True).encode()
        concat = canonical + body
        count_copy(len(concat))                # digest-input concat
        if claimed != digest_bytes(concat):
            return None
        chunks = legacy_try_parse_multi_chunk(body)
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
        )
    except Exception:
        return None


# ---------------------------------------------------------------------------
# servant source intake (pre-PR: decompress everything, re-scan to digest)
# ---------------------------------------------------------------------------


def legacy_two_pass_decompress_digest(data) -> Tuple[bytes, str]:
    src = compress.try_decompress(bytes(data)
                                  if not isinstance(data, (bytes, bytearray))
                                  else data)
    if src is None:
        raise compress.CompressionError("not a valid frame")
    return src, digest_bytes(src)              # the second full scan


# ---------------------------------------------------------------------------
# serial output packing (pre-PR: one file at a time on the waiter thread)
# ---------------------------------------------------------------------------


class _InlineFuture:
    def __init__(self, value):
        self._value = value

    def result(self):
        return self._value


class InlineExecutorShim:
    """Stands in for cloud.cxx_task._PACK_EXECUTOR: submit() runs the
    job inline, restoring the pre-PR serial pack behavior."""

    def get(self):
        return self

    def submit(self, fn, *args, **kwargs):
        return _InlineFuture(fn(*args, **kwargs))


# ---------------------------------------------------------------------------
# patch contexts — swap the production seams to the legacy path
# ---------------------------------------------------------------------------


@contextmanager
def _patched(*patches):
    """Swap each (module, attribute, replacement) for the block.  A
    target the module does not have raises: setting it would patch
    nothing that runs, and the A/B would compare zero-copy with
    itself."""
    for obj, name, _ in patches:
        if not hasattr(obj, name):
            raise AttributeError(
                f"legacy patch target {obj.__name__}.{name} does not "
                f"exist")
    with ExitStack() as stack:
        for obj, name, repl in patches:
            orig = getattr(obj, name)
            setattr(obj, name, repl)
            stack.callback(setattr, obj, name, orig)
        yield


def servant_legacy_patches():
    """Producer half: two-pass source intake, serial output pack,
    concat-built cache entries and reply attachments."""
    from ..daemon import cache_format, packing
    from ..daemon.cloud import cxx_task as cloud_cxx

    return _patched(
        (cloud_cxx, "_decompress_and_digest",
         legacy_two_pass_decompress_digest),
        (cloud_cxx, "_PACK_EXECUTOR", InlineExecutorShim()),
        (cache_format, "write_cache_entry_payload",
         legacy_write_cache_entry_payload),
        (packing, "pack_keyed_buffers_payload",
         legacy_pack_keyed_buffers_payload),
    )


def delegate_legacy_patches():
    """Consumer half: copying parsers for servant replies, cache
    entries, and client submissions."""
    from ..common import multi_chunk
    from ..daemon import cache_format, packing

    return _patched(
        (packing, "try_unpack_keyed_buffers_views",
         legacy_try_unpack_keyed_buffers),
        (cache_format, "try_parse_cache_entry",
         legacy_try_parse_cache_entry),
        (multi_chunk, "try_parse_multi_chunk_views",
         legacy_try_parse_multi_chunk_views),
        (multi_chunk, "make_multi_chunk_payload",
         legacy_make_multi_chunk_payload),
    )


@contextmanager
def full_legacy_patches():
    """Whole-process pre-PR byte path (both halves) — the "before" side
    of the e2e cluster A/B."""
    with servant_legacy_patches(), delegate_legacy_patches():
        yield
