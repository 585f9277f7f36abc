"""Validated bounds for untrusted quantities at the trust boundary (a
copy of the JAX package's yadcc_tpu/common/limits.py).

Every helper here is a declared sanitizer for the static taint pass
(doc/static_analysis.md): routing an intake value through one of these
is what lets ``ytpu-analyze`` prove the size-cap discipline instead of
trusting that each handler remembered it.

The caps mirror the reference's wire limits: packets cap at 1GB
compressed (reference daemon/entry.cc — sized for Java jars), and the
decompression side enforces its own 2GB produced-bytes cap
(common/compress.py).
"""

from __future__ import annotations

from typing import Optional, Union

# One HTTP request / RPC attachment may not exceed the wire packet cap.
MAX_WIRE_BODY = 1 << 30

# A client-supplied long-poll / quota wait may park a serving thread at
# most this long; clients re-poll (they already do — both wait routes
# are long-poll loops with their own deadline handling).
MAX_WAIT_S = 60.0


class BodyTooLarge(ValueError):
    """Request body exceeds the wire cap; HTTP layer answers 413."""


def checked_content_length(raw: Optional[Union[str, int]],
                           cap: int = MAX_WIRE_BODY) -> int:  # ytpu: sanitizes(size-cap)
    """Parse and bound a Content-Length header BEFORE buffering the
    body: a hostile local client claiming terabytes must be refused at
    the header, not at the allocator."""
    try:
        n = int(raw or 0)
    except (TypeError, ValueError):
        raise BodyTooLarge(f"unparseable content length {raw!r}")
    if n < 0 or n > cap:
        raise BodyTooLarge(f"content length {n} exceeds cap {cap}")
    return n


def checked_attachment(data, cap: int = MAX_WIRE_BODY):  # ytpu: sanitizes(size-cap)
    """Bound an already-buffered attachment (compressed source /
    StableHLO) to the wire cap; returns it unchanged.  The factory-side
    twin of the servant's decompression cap — the delegate must not
    queue (and re-send N times on retry) a payload no servant will
    accept."""
    if len(data) > cap:
        raise ValueError(f"attachment of {len(data)} bytes exceeds "
                         f"wire cap {cap}")
    return data


def clamp_wait_s(milliseconds: Union[int, float],
                 max_s: float = MAX_WAIT_S) -> float:  # ytpu: sanitizes(size-cap)
    """Client-supplied wait-milliseconds -> bounded seconds.  Negative
    and NaN-ish inputs clamp to zero."""
    try:
        s = float(milliseconds) / 1000.0
    except (TypeError, ValueError):
        return 0.0
    if not (s > 0):  # catches NaN too
        return 0.0
    return min(s, max_s)
