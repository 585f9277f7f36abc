r"""Multi-chunk framing codec shared by the client and the daemon (a copy
of the JAX package's yadcc_tpu/common/multi_chunk.py).

Format (reference yadcc/daemon/local/README.md:13-27): a first line of
comma-separated decimal chunk lengths terminated by \r\n, followed by the
chunks' bytes concatenated:

    b"2,10\r\nXX0123456789"  ==  [b"XX", b"0123456789"]

An empty chunk list encodes as just b"\r\n".

Two API tiers:

* ``make_multi_chunk_payload`` / ``try_parse_multi_chunk_views`` — the
  zero-copy tier: building returns a :class:`~.payload.Payload` whose
  segments are the header plus the callers' own chunk buffers, and
  parsing returns ``memoryview`` slices into the received buffer.  The
  data plane uses these.
* ``make_multi_chunk`` / ``try_parse_multi_chunk`` — the materializing
  compat tier (byte-identical wire format), kept for callers that need
  owned ``bytes``; their copies are charged to the payload copy meter.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Union

from .payload import Payload, Segment, count_copy

# The header scan reads the buffer in small windows so locating "\r\n"
# never materializes a multi-MB frame (views must stay zero-copy).
_HEADER_SCAN_WINDOW = 4096


def _find_crlf(mv: memoryview) -> int:
    n = len(mv)
    pos = 0
    while pos < n:
        # +1 overlap so a "\r|\n" split across windows is still found.
        window = bytes(mv[pos:pos + _HEADER_SCAN_WINDOW + 1])
        i = window.find(b"\r\n")
        if i >= 0:
            return pos + i
        if pos + len(window) >= n:
            return -1
        pos += _HEADER_SCAN_WINDOW
    return -1


def make_multi_chunk_payload(
        chunks: Sequence[Union[Segment, Payload]]) -> Payload:
    """Gather form: header segment + the chunk buffers themselves."""
    header = ",".join(str(len(c)) for c in chunks).encode() + b"\r\n"
    return Payload((header, *chunks))


def try_parse_multi_chunk_views(data) -> Optional[List[memoryview]]:  # ytpu: sanitizes(framing)
    """Zero-copy parse: chunk bodies are views into ``data``.

    ``data`` may be ``bytes``, ``bytearray`` or a ``memoryview`` (e.g.
    an RPC attachment still backed by its frame).  The views pin that
    buffer alive; callers wanting owned bytes use the compat parser.
    """
    mv = memoryview(data)
    eol = _find_crlf(mv)
    if eol < 0:
        return None
    header = bytes(mv[:eol])
    body = mv[eol + 2:]
    if not header:
        return [] if len(body) == 0 else None
    try:
        lengths = [int(x) for x in header.split(b",")]
    except ValueError:
        return None
    if any(l < 0 for l in lengths) or sum(lengths) != len(body):
        return None
    chunks: List[memoryview] = []
    off = 0
    for l in lengths:
        chunks.append(body[off:off + l])
        off += l
    return chunks


def make_multi_chunk(chunks: Sequence[bytes]) -> bytes:
    return make_multi_chunk_payload(chunks).join()


def try_parse_multi_chunk(data: bytes) -> Optional[List[bytes]]:
    views = try_parse_multi_chunk_views(data)
    if views is None:
        return None
    count_copy(sum(len(v) for v in views))
    return [bytes(v) for v in views]
