"""Keyed buffer packing for attachments (a copy of the JAX package's
yadcc_tpu/daemon/packing.py).

Parity with the reference's keyed KV attachment packing
(yadcc/daemon/local/packing.cc, consumed by remote_task.cc:69-75 and the
delegate): output files travel as one attachment holding alternating
key/value chunks in multi-chunk framing.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from ..common.multi_chunk import (make_multi_chunk_payload,
                                  try_parse_multi_chunk_views)
from ..common.payload import Payload, count_copy


def pack_keyed_buffers_payload(buffers: Dict[str, bytes]) -> Payload:
    """Gather form: the value buffers ride as their own segments, so a
    response attachment of N output files costs zero concatenations
    until the socket-boundary join."""
    chunks: List[bytes] = []
    for key in sorted(buffers):
        chunks.append(key.encode())
        chunks.append(buffers[key])
    return make_multi_chunk_payload(chunks)


def pack_keyed_buffers(buffers: Dict[str, bytes]) -> bytes:
    return pack_keyed_buffers_payload(buffers).join()


def try_unpack_keyed_buffers_views(
        data) -> Optional[Dict[str, memoryview]]:
    """Zero-copy unpack: values are views into ``data`` (pinned alive by
    them); keys are decoded (they're tiny)."""
    chunks = try_parse_multi_chunk_views(data)
    if chunks is None or len(chunks) % 2 != 0:
        return None
    out: Dict[str, memoryview] = {}
    for i in range(0, len(chunks), 2):
        try:
            key = bytes(chunks[i]).decode()
        except UnicodeDecodeError:
            return None
        out[key] = chunks[i + 1]
    return out


def try_unpack_keyed_buffers(data) -> Optional[Dict[str, bytes]]:
    views = try_unpack_keyed_buffers_views(data)
    if views is None:
        return None
    count_copy(sum(len(v) for v in views.values()))
    return {k: bytes(v) for k, v in views.items()}
