"""zlib-framed stand-in for the zstd helpers on hosts without the
`zstandard` wheel (a copy of the JAX package's
yadcc_tpu/common/_zlib_frames.py, trimmed to what the cache protocol,
the servant's source intake and the client's source stream use; see
common/compress.py for the gating story).

A one-shot frame is ``YZF1`` + u64le declared size + zlib stream:
frame_content_size reads the declared size, like a zstd frame header with
the content size set, so the size-cap check in compress.decompress keeps
working.  A ``YZFS`` (streaming) frame of the JAX package decodes here
too, one-shot or fed in pieces (``AnyFrameDecompressor``, the engine
under compress.DecompressingDigestReader and compress.decompress_iter on
a host without the wheel).
Pure stdlib; never imported when the real wheel is present.
"""

from __future__ import annotations

import zlib

_ONE_SHOT_MAGIC = b"YZF1"
_STREAM_MAGIC = b"YZFS"


class Error(Exception):
    """Stands in for zstandard.ZstdError in except clauses."""


def compress(data: bytes, level: int = 3) -> bytes:
    return (_ONE_SHOT_MAGIC + len(data).to_bytes(8, "little")
            + zlib.compress(data, level))


def frame_content_size(data: bytes) -> int:
    """Declared decompressed size; -1 for streaming frames.  Raises on
    anything that isn't one of our frames — same contract as
    zstandard.frame_content_size on a malformed header."""
    if data[:4] == _ONE_SHOT_MAGIC and len(data) >= 12:
        return int.from_bytes(data[4:12], "little")
    if data[:4] == _STREAM_MAGIC:
        return -1
    raise Error("not a framed payload")


def decompress(data: bytes, max_output_size: int) -> bytes:
    declared = frame_content_size(data)        # raises on bad magic
    body = data[12:] if declared >= 0 else data[4:]
    obj = zlib.decompressobj()
    try:
        out = obj.decompress(body, max_output_size)
    except zlib.error as e:
        raise Error(str(e)) from None
    if obj.unconsumed_tail:
        raise Error(f"output exceeds cap {max_output_size}")
    if not obj.eof:
        raise Error("truncated stream")
    if declared >= 0 and len(out) != declared:
        raise Error("declared size mismatch")
    return out


class StreamCompressor:
    """compressobj() twin: .compress(bytes) / .flush(), magic-prefixed
    (the client's streaming source frame, ``YZFS``)."""

    def __init__(self, level: int = 3):
        self._obj = zlib.compressobj(level)
        self._first = True

    def _prefix(self, out: bytes) -> bytes:
        if self._first:
            self._first = False
            return _STREAM_MAGIC + out
        return out

    def compress(self, data: bytes) -> bytes:
        return self._prefix(self._obj.compress(data))

    def flush(self) -> bytes:
        return self._prefix(self._obj.flush())


class AnyFrameDecompressor:
    """Streaming twin of :func:`decompress`: accepts EITHER frame kind
    (one-shot ``YZF1`` or streaming ``YZFS``) fed in arbitrary chunk
    sizes — the engine under compress.DecompressingDigestReader when the
    zstd wheel is absent.  Error semantics match the one-shot path:
    truncation and declared-size mismatch raise :class:`Error`; trailing
    bytes after the stream end are ignored (zlib routes them to
    ``unused_data``), exactly as ``decompress`` accepts them."""

    def __init__(self):
        self._obj = zlib.decompressobj()
        self._head = b""
        self._declared = None  # None until the magic is seen; -1 = stream
        self._out = 0

    def decompress(self, chunk) -> bytes:
        if self._declared is None:
            self._head += bytes(chunk)
            if len(self._head) < 4:
                return b""
            if self._head[:4] == _STREAM_MAGIC:
                self._declared = -1
                chunk, self._head = self._head[4:], b""
            elif self._head[:4] == _ONE_SHOT_MAGIC:
                if len(self._head) < 12:
                    return b""
                self._declared = int.from_bytes(self._head[4:12], "little")
                chunk, self._head = self._head[12:], b""
            else:
                raise Error("not a framed payload")
        try:
            out = self._obj.decompress(chunk)
        except zlib.error as e:
            raise Error(str(e)) from None
        self._out += len(out)
        return out

    def verify_eof(self) -> None:
        if self._declared is None or not self._obj.eof:
            raise Error("truncated stream")
        if self._declared >= 0 and self._out != self._declared:
            raise Error("declared size mismatch")

