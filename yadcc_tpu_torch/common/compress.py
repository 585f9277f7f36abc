"""zstd helpers (a copy of the JAX package's yadcc_tpu/common/compress.py,
trimmed to what the port uses: the one-shot calls, with which the full
Bloom filter travels as ``compress(u32 salt + words)`` and a servant
compresses its outputs; the fused streaming decompress-and-digest of a
servant's source intake; the client's streaming writers, which tee
its preprocessor's output into a compressor and a digest in one pass;
and decompress_iter, their chunked reader, kept for parity: only the
tests call it).

When the `zstandard` wheel is absent (minimal containers), a stdlib
zlib stand-in keeps the same API: framed one-shot payloads carry a
declared-size header so the pre-allocation cap check still works.  The
two formats do not interoperate — every component in a zstd-less process
speaks the fallback, which is the only deployment such a process can be
part of anyway (the wire peer would need the same build)."""

from __future__ import annotations

import os
import threading
from typing import Iterable, Optional, Tuple

try:
    import zstandard
except ImportError:  # gated: minimal containers ship no zstd wheel
    zstandard = None
    from . import _zlib_frames as _fallback

from .hashing import new_digest

# The reference tunes for throughput, not ratio (level 3).
_LEVEL = 3

# YTPU_COMPRESS_LEVEL bounds; values outside fall back to the default
# rather than erroring.  The zlib stand-in caps at 9.
_MAX_LEVEL = 19 if zstandard is not None else 9

# The error type callers may catch regardless of which backend is
# compiled in (zstandard.ZstdError when the wheel is present).
CompressionError = (zstandard.ZstdError if zstandard is not None
                    else _fallback.Error)

# zstandard (de)compressor objects are not safe for concurrent use from
# multiple threads, and the servers serve RPCs on thread pools — keep one
# per thread.
_tls = threading.local()


def current_level() -> int:
    """Active compression level: YTPU_COMPRESS_LEVEL when it parses to a
    level the backend supports, else 3.  Read per call so a changed
    environment is seen."""
    raw = os.environ.get("YTPU_COMPRESS_LEVEL")
    if not raw:
        return _LEVEL
    try:
        v = int(raw)
    except ValueError:
        return _LEVEL
    return v if 1 <= v <= _MAX_LEVEL else _LEVEL


def _ctx() -> tuple:
    level = current_level()
    trio = getattr(_tls, "trio", None)
    if trio is None or trio[0] != level:
        trio = (
            level,
            zstandard.ZstdCompressor(level=level),
            zstandard.ZstdDecompressor(),
        )
        _tls.trio = trio
    return trio[1:]


def compress(data: bytes) -> bytes:
    if zstandard is None:
        return _fallback.compress(data, current_level())
    return _ctx()[0].compress(data)


# Decompressed payloads beyond this are treated as corruption.
_MAX_DECOMPRESSED = 1 << 31


def decompress(data: bytes, max_output_size: int = _MAX_DECOMPRESSED) -> bytes:  # ytpu: sanitizes(size-cap)
    # max_output_size only binds STREAMING frames (no content size in
    # the header) — python-zstandard ignores it when the frame declares
    # a size, so a hostile frame declaring terabytes would attempt the
    # full allocation.  Check the declared size before touching the
    # allocator (-1 = streaming/unknown; raises on malformed headers).
    if zstandard is None:
        return _fallback.decompress(data, max_output_size)
    declared = zstandard.frame_content_size(data)
    if declared > max_output_size:
        raise zstandard.ZstdError(
            f"declared content size {declared} exceeds cap")
    return _ctx()[1].decompress(data, max_output_size=max_output_size)


def try_decompress(data: bytes) -> Optional[bytes]:  # ytpu: sanitizes(size-cap)
    try:
        return decompress(data)
    except (CompressionError, MemoryError, ValueError):
        # Corruption — including allocation-level failures — must read
        # as a miss, never take down the serving thread.
        return None


class CompressingWriter:
    """Streaming compressor chaining into a downstream writer (a zstd
    frame, or the zlib stand-in's streaming frame without the wheel);
    composable with hashing.DigestingWriter into the client's
    single-pass preprocess -> (digest, compressed source) tee."""

    def __init__(self, sink):
        self._sink = sink
        level = current_level()
        self._obj = (_fallback.StreamCompressor(level)
                     if zstandard is None
                     else zstandard.ZstdCompressor(level=level)
                     .compressobj())
        self._closed = False

    def write(self, data: bytes) -> int:
        out = self._obj.compress(data)
        if out:
            self._sink.write(out)
        return len(data)

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            out = self._obj.flush()
            if out:
                self._sink.write(out)


class TeeWriter:
    """Fan a write out to several sinks (ForwardingOutputStream parity)."""

    def __init__(self, *sinks):
        self._sinks = sinks

    def write(self, data: bytes) -> int:
        for s in self._sinks:
            s.write(data)
        return len(data)


def decompress_iter(chunks: Iterable[bytes]) -> bytes:
    """One frame fed in ``chunks`` (the output of CompressingWriter or
    compress, however it was split), decompressed whole.  Either frame
    kind, on zstd and on the zlib stand-in alike (the JAX package's
    stand-in refuses a one-shot frame here).  No caller in either
    package but the tests: kept for parity."""
    obj = (_fallback.AnyFrameDecompressor() if zstandard is None
           else _ctx()[1].decompressobj())
    return b"".join(obj.decompress(c) for c in chunks)


class DecompressingDigestReader:
    """Fused streaming decompress ⊕ BLAKE2b-256 — one pass over the
    bytes instead of decompress-everything-then-rescan-to-digest.

    The servant-side mirror of the client's compress⊕digest tee (the
    JAX package's CompressingWriter + hashing.DigestingWriter): feed
    compressed chunks with :meth:`feed`, each decompressed piece is digested as it
    appears; :meth:`finish` verifies stream completeness.  The output
    cap binds on *produced* bytes, so a hostile frame aborts mid-stream
    instead of after a giant allocation.  All failures raise
    :data:`CompressionError`; callers discard any partial output.
    """

    def __init__(self, max_output_size: int = _MAX_DECOMPRESSED):
        self._h = new_digest()
        self._cap = max_output_size
        self.bytes_out = 0
        self._obj = (_fallback.AnyFrameDecompressor() if zstandard is None
                     else zstandard.ZstdDecompressor().decompressobj())

    def feed(self, chunk) -> bytes:  # ytpu: sanitizes(size-cap)
        out = self._obj.decompress(chunk)
        self.bytes_out += len(out)
        if self.bytes_out > self._cap:
            raise CompressionError(f"output exceeds cap {self._cap}")
        if out:
            self._h.update(out)
        return out

    def finish(self) -> None:
        if zstandard is None:
            self._obj.verify_eof()
        elif not getattr(self._obj, "eof", True):
            raise CompressionError("truncated stream")

    def hexdigest(self) -> str:
        return self._h.hexdigest()


def decompress_and_digest(
    data,
    max_output_size: int = _MAX_DECOMPRESSED,
    chunk_size: int = 1 << 20,
) -> Tuple[bytes, str]:  # ytpu: sanitizes(size-cap, digest)
    """Single-pass (decompressed bytes, hex digest) of a complete frame.

    Error contract matches :func:`decompress` — corruption, truncation,
    a hostile declared size, or cap overflow raise
    :data:`CompressionError`; no partial output escapes."""
    mv = memoryview(data)
    # Same fail-fast declared-size check as decompress(): a tiny frame
    # declaring terabytes is refused before any work.
    declared = (_fallback.frame_content_size(mv) if zstandard is None
                else zstandard.frame_content_size(data))
    if declared > max_output_size:
        raise CompressionError(
            f"declared content size {declared} exceeds cap")
    reader = DecompressingDigestReader(max_output_size)
    pieces = []
    for off in range(0, len(mv), chunk_size):
        out = reader.feed(mv[off:off + chunk_size])
        if out:
            pieces.append(out)
    reader.finish()
    return b"".join(pieces), reader.hexdigest()
