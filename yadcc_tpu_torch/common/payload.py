"""Chunked payload buffers — the data plane's scatter/gather primitive.

The reference builds all of its transport on flare's NoncontiguousBuffer
(SNIPPETS/COMPONENTS §2.7): a task's bytes move from the preprocessor to
the servant and back as a *sequence of segments*, and the only place the
segments are ever flattened into one contiguous buffer is the socket
write.  This module is that analogue for the python data plane:

* ``Payload`` — an immutable sequence of ``bytes``/``memoryview``
  segments with ``len``, ``slice``, ``iter_segments`` and a single
  ``join`` reserved for the socket boundary.
* a process-wide **copy counter** — every materializing ``join`` (and
  every legacy-path concatenation routed through :func:`count_copy`)
  is recorded, so "how many times did this task's bytes get copied?"
  is a measured number (``tools/dataplane_bench``), asserted in tests
  rather than merely graphed.

Segments are never mutated and never defensively copied: callers hand
over ``bytes`` (already immutable) or views into buffers they keep
alive (a parsed RPC frame, an HTTP body).  A view pins its backing
buffer — for this data plane that is always the frame the segment was
parsed out of, which has the same lifetime anyway.
"""

from __future__ import annotations

import threading
from typing import Iterable, Iterator, List, Tuple, Union

Segment = Union[bytes, bytearray, memoryview]


class _CopyCounter:
    """Process-wide tally of full-buffer materializations.

    One "copy" is one event that re-materializes a buffer that already
    existed in memory (a ``join``, a parse that duplicates chunk bodies,
    a concatenation of already-built parts).  First-time allocations —
    compressor output, a file read — are not copies; both the legacy
    and the zero-copy path pay those identically.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._copies = 0  # guarded by: self._lock
        self._bytes = 0  # guarded by: self._lock

    def count(self, nbytes: int, events: int = 1) -> None:
        with self._lock:
            self._copies += events
            self._bytes += nbytes

    def snapshot(self) -> Tuple[int, int]:
        with self._lock:
            return self._copies, self._bytes


_COUNTER = _CopyCounter()


def count_copy(nbytes: int, events: int = 1) -> None:
    """Record `events` buffer copies totalling `nbytes` bytes.

    Exposed so the legacy-path models in ``tools/_dataplane_legacy`` and
    compat shims charge their concatenations to the same meter the
    Payload layer uses."""
    _COUNTER.count(nbytes, events)


def copy_stats() -> dict:
    copies, nbytes = _COUNTER.snapshot()
    return {"copies": copies, "bytes": nbytes}


class copy_counting:
    """Context manager capturing the copy-counter delta across a block::

        with copy_counting() as c:
            ...byte path under test...
        assert c.copies <= 4

    The counter is process-global; meaningful deltas come from
    single-threaded modeled paths (tests, the microbench) or from
    dividing a whole cluster run's delta by its task count.
    """

    copies: int = 0
    bytes: int = 0

    def __enter__(self) -> "copy_counting":
        self._c0, self._b0 = _COUNTER.snapshot()
        return self

    def __exit__(self, *exc) -> None:
        c1, b1 = _COUNTER.snapshot()
        self.copies = c1 - self._c0
        self.bytes = b1 - self._b0


class Payload:
    """Immutable sequence of byte segments; flattened only at ``join``."""

    __slots__ = ("_segments", "_length")

    def __init__(self, segments: Iterable[Segment] = ()):
        segs: List[Segment] = []
        total = 0
        for s in segments:
            if isinstance(s, Payload):
                # Flatten nested payloads: segments stay shared, no copy.
                segs.extend(s._segments)
                total += s._length
                continue
            if isinstance(s, memoryview) and (
                    not s.contiguous or s.format != "B"):
                # Join/socket writes need plain contiguous byte buffers;
                # exotic views (a reversed slice, a typed array) are
                # normalized here, at the edge.
                s = s.tobytes()
            n = len(s)
            if n == 0:
                continue
            segs.append(s)
            total += n
        self._segments: Tuple[Segment, ...] = tuple(segs)
        self._length = total

    @classmethod
    def of(cls, *parts: Union[Segment, "Payload"]) -> "Payload":
        return cls(parts)

    @classmethod
    def from_bytes(cls, data: Segment) -> "Payload":
        return cls((data,))

    def __len__(self) -> int:
        return self._length

    def __bool__(self) -> bool:
        return self._length > 0

    def iter_segments(self) -> Iterator[Segment]:
        return iter(self._segments)

    @property
    def num_segments(self) -> int:
        return len(self._segments)

    def slice(self, start: int, stop: int) -> "Payload":
        """Payload view of [start, stop) — segment views, no copying."""
        start = max(0, min(start, self._length))
        stop = max(start, min(stop, self._length))
        out: List[Segment] = []
        off = 0
        for seg in self._segments:
            n = len(seg)
            if off + n <= start:
                off += n
                continue
            if off >= stop:
                break
            lo = max(0, start - off)
            hi = min(n, stop - off)
            out.append(memoryview(seg)[lo:hi] if (lo, hi) != (0, n)
                       else seg)
            off += n
        return Payload(out)

    def join(self) -> bytes:
        """Materialize into one contiguous ``bytes`` — THE copy.

        Reserved for the socket boundary (and compat shims).  A payload
        that is already a single ``bytes`` segment is returned as-is
        and counts nothing."""
        if not self._segments:
            return b""
        if len(self._segments) == 1 and isinstance(self._segments[0], bytes):
            return self._segments[0]
        _COUNTER.count(self._length)
        return b"".join(self._segments)

    def update_into(self, hasher) -> None:
        """Feed every segment to `hasher.update` — the incremental-digest
        partner of ``hashing.new_digest()`` (no concatenation)."""
        for seg in self._segments:
            hasher.update(seg)

    def __repr__(self) -> str:
        return (f"Payload({self._length} bytes, "
                f"{len(self._segments)} segments)")


def as_payload(data: Union[Segment, Payload]) -> Payload:
    return data if isinstance(data, Payload) else Payload.from_bytes(data)
