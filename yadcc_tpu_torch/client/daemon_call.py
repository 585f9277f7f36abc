"""Minimal HTTP client to the local daemon (a copy of the JAX package's
yadcc_tpu/client/daemon_call.py).

Parity with reference yadcc/client/common/daemon_call.{h,cc}: blocking
loopback HTTP to ``YTPU_DAEMON_PORT`` with an injectable handler seam so
tests fake the daemon without sockets (the reference's
SetDaemonCallGatheredHandler, daemon_call.h:46-52).  One keep-alive
connection a thread serves every call, the tenant credential rides each
request, and the connection stats count dials against reuses."""

from __future__ import annotations

import http.client
import threading
from dataclasses import dataclass
from typing import Callable, Dict, Optional

from ..common.payload import Payload
from .env_options import daemon_port, tenant_token


@dataclass
class DaemonResponse:
    status: int
    body: bytes
    # Server pacing hint (seconds), parsed from a Retry-After header on
    # backpressure replies (503 under quota/overload); None when the
    # daemon sent none.  Retry loops feed it to common.backoff.Backoff.
    retry_after_s: Optional[float] = None


# Test seam: when set, calls go here instead of the network.
_handler: Optional[Callable[[str, str, bytes], DaemonResponse]] = None


def set_daemon_call_handler(
    handler: Optional[Callable[[str, str, bytes], DaemonResponse]]
) -> None:
    global _handler
    _handler = handler


# One persistent HTTP/1.1 connection per thread serves every poll: a
# quota or wait loop does not dial per lap (on the aio front end, one
# parked server-side connection instead of a fresh accept per poll).
_conn_tls = threading.local()
_conn_stats_lock = threading.Lock()
_conn_stats = {"connects": 0, "reuses": 0, "retries": 0}  # guarded by: _conn_stats_lock


def daemon_connection_stats() -> Dict[str, int]:
    with _conn_stats_lock:
        return dict(_conn_stats)


def _bump(key: str) -> None:
    with _conn_stats_lock:
        _conn_stats[key] += 1


def _drop_conn() -> None:
    conn = getattr(_conn_tls, "conn", None)
    if conn is not None:
        try:
            conn.close()
        except OSError:
            pass
    _conn_tls.conn = None
    _conn_tls.port = None


def _request_once(method: str, path: str, body, timeout_s: float):
    """One attempt on the thread's persistent connection; raises on any
    transport trouble (the caller decides whether to retry on a fresh
    connection)."""
    port = daemon_port()
    conn = getattr(_conn_tls, "conn", None)
    if conn is None or getattr(_conn_tls, "port", None) != port:
        _drop_conn()
        conn = http.client.HTTPConnection("127.0.0.1", port,
                                          timeout=timeout_s)
        _conn_tls.conn = conn
        _conn_tls.port = port
        _bump("connects")
    else:
        conn.timeout = timeout_s
        _bump("reuses")
    headers = {"Content-Type": "application/octet-stream"}
    cred = tenant_token()
    if cred:
        # Re-read per request so a rotated credential is picked up.
        headers["X-Ytpu-Tenant"] = cred
    conn.request(method, path, body=body or None, headers=headers)
    resp = conn.getresponse()
    data = resp.read()
    return DaemonResponse(resp.status, data,
                          retry_after_s=_parse_retry_after(
                              resp.getheader("Retry-After")))


def call_daemon(method: str, path: str, body=b"",
                timeout_s: float = 30.0) -> DaemonResponse:
    """Returns status -1 on connection failure (daemon not running).

    `body` may be a chunked Payload; this is the client's socket
    boundary, so it is flattened here — exactly once — for the
    Content-Length HTTP write (and for the injected test handler, which
    stands in for the wire)."""
    if isinstance(body, Payload):
        body = body.join()
    if _handler is not None:
        return _handler(method, path, body)
    fresh = getattr(_conn_tls, "conn", None) is None
    try:
        return _request_once(method, path, body, timeout_s)
    except (OSError, http.client.HTTPException):
        # A kept-alive connection the daemon quietly closed (restart,
        # idle timeout) surfaces here: retry ONCE on a fresh dial.  A
        # failure on an already-fresh connection means no daemon.
        _drop_conn()
        if fresh:
            return DaemonResponse(-1, b"")
        _bump("retries")
        try:
            return _request_once(method, path, body, timeout_s)
        except (OSError, http.client.HTTPException):
            _drop_conn()
            return DaemonResponse(-1, b"")


def _parse_retry_after(value: Optional[str]) -> Optional[float]:
    """Delay-seconds form only (the daemon is the only server we talk
    to and it sends numbers); dates and garbage read as no hint."""
    if not value:
        return None
    try:
        v = float(value)
    except ValueError:
        return None
    return v if v >= 0 else None
