"""Transport-agnostic RPC core: frames, service specs, channels.

Wire frame (both directions, same on grpc and raw usage):

    [u32 status][u32 meta_len][meta bytes][attachment bytes...]

``status`` is 0 on success; non-zero values are application status codes
(the per-service ``*_STATUS_*`` enums in api/).  Attachments are
whatever bytes follow the message — the transport never copies them into
a protobuf field (reference flare attachments, e.g. yadcc/api/cache.proto
comment on TryGetEntry).
"""

from __future__ import annotations

import struct
import threading
import time as _time
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional, Tuple, Union

from ..common.payload import Payload, as_payload

_HEADER = struct.Struct("<II")

# Attachments travel as bytes-likes or chunked Payloads; the transport
# flattens them exactly once, at the socket boundary.
Attachment = Union[bytes, bytearray, memoryview, Payload]


class RpcError(Exception):
    """Application-level RPC failure with a numeric status code."""

    def __init__(self, status: int, message: str = ""):
        super().__init__(f"rpc failed: status={status} {message}")
        self.status = status
        self.message = message


# Transport-level status codes (distinct range from app statuses).
STATUS_TRANSPORT_FAILURE = 1
STATUS_METHOD_NOT_FOUND = 2
STATUS_TIMEOUT = 3
# A live endpoint that is deliberately not serving yet — a warm standby
# awaiting takeover (scheduler/replication.py).  The wire's 503: the
# error message carries a machine-readable "retry-after-ms=N" hint
# (parse with retry_after_ms_from_error).
STATUS_NOT_SERVING = 4


def retry_after_ms_from_error(err: "RpcError",
                              default_ms: int = 250) -> int:
    """Extract the "retry-after-ms=N" hint a NOT_SERVING standby embeds
    in its error message.  Error frames carry only (status, message),
    so the hint travels in-band."""
    marker = "retry-after-ms="
    msg = err.message or ""
    at = msg.find(marker)
    if at < 0:
        return default_ms
    digits = []
    for ch in msg[at + len(marker):]:
        if not ch.isdigit():
            break
        digits.append(ch)
    return int("".join(digits)) if digits else default_ms
@dataclass
class RpcContext:
    """Per-call server-side context."""

    # Peer address as observed by the transport ("ip:port"), used e.g.
    # for the scheduler's NAT detection (observed vs reported endpoint).
    peer: str = ""
    # Response attachment, set by the handler — bytes or a chunked
    # Payload (flattened once, into the reply frame).
    response_attachment: Attachment = b""


# A handler takes (request_message, request_attachment, context) and
# returns the response message (attachment goes via ctx).
Handler = Callable[[object, bytes, RpcContext], object]

# A parked handler additionally takes a `done` continuation and returns
# nothing: it registers the continuation with the owning component and
# the COMPLETING thread calls done(response) (or done(None, error=
# RpcError(...))) exactly once, from any thread.  Only the aio front
# end (rpc/aio_server.py) consults these; thread-per-request transports
# keep using the blocking twin registered under the same name.
ParkedHandler = Callable[[object, bytes, RpcContext, Callable], None]

@dataclass
class MethodSpec:
    name: str
    request_cls: type
    handler: Handler


@dataclass
class ServiceSpec:
    """A mountable service: name plus method table.

    `stage_timer` (optional, a utils.stagetimer.StageTimer) makes
    dispatch_frame record per-method `<Method>:handler` and
    `<Method>:serialize` stages — the server-side half of the grant
    path's latency decomposition.

    `parked` maps long-poll methods to their continuation-style
    handlers (see ParkedHandler): on the aio front end a waiting client
    is a parked continuation on the event loop instead of a parked
    worker thread.  Methods without a parked variant run their blocking
    handler on the front end's bounded pool."""

    service_name: str
    methods: Dict[str, MethodSpec] = field(default_factory=dict)
    stage_timer: Optional[object] = None
    parked: Dict[str, MethodSpec] = field(default_factory=dict)

    def add(self, name: str, request_cls: type, handler: Handler) -> None:
        self.methods[name] = MethodSpec(name, request_cls, handler)

    def add_parked(self, name: str, request_cls: type,
                   handler: ParkedHandler) -> None:
        self.parked[name] = MethodSpec(name, request_cls, handler)

def encode_frame_payload(status: int, meta: bytes,
                         attachment: Attachment = b"") -> Payload:
    """Gather form of a wire frame: [header+meta] ++ attachment segments.

    The attachment's buffers are referenced, never copied — the single
    flatten happens in the caller's ``join()`` at the socket boundary
    (header and meta are small; packing them into one segment keeps the
    hot no-attachment case a single allocation)."""
    return Payload.of(_HEADER.pack(status, len(meta)) + meta,
                      as_payload(attachment))


def encode_frame(status: int, meta: bytes,
                 attachment: Attachment = b"") -> bytes:
    return encode_frame_payload(status, meta, attachment).join()


def decode_frame_views(data) -> Tuple[int, memoryview, memoryview]:
    """Zero-copy decode: meta and attachment are views into ``data``
    (which they pin alive — for a reply frame that is the buffer the
    transport handed back anyway)."""
    status, meta_len = _HEADER.unpack_from(data)
    off = _HEADER.size
    mv = memoryview(data)
    return status, mv[off:off + meta_len], mv[off + meta_len:]


def decode_frame(data: bytes) -> Tuple[int, bytes, bytes]:
    """Copying decode (the pre-zero-copy form, kept for the data plane's
    A/B in tools/dataplane_bench.py): meta and attachment are slices."""
    status, meta_len = _HEADER.unpack_from(data)
    off = _HEADER.size
    return status, data[off : off + meta_len], data[off + meta_len :]


# Per-thread duration of the last dispatch_frame call (decode + handler
# + serialize), in seconds.  An in-process transport (mock://) runs the
# server on the caller's thread, so the client can subtract this from
# its wall time to get the pure transport/framing stage — how
# tools/pod_sim.py decomposes grant_call latency.
_tls = threading.local()


def last_server_inner_s() -> Optional[float]:
    return getattr(_tls, "server_inner_s", None)


def dispatch_frame_payload(spec: ServiceSpec, name: str, data,
                           peer: str) -> Payload:  # ytpu: untrusted(data)
    """Server-side: decode a request frame, run the handler, encode the
    reply as a gather Payload (joined once by dispatch_frame below).

    Never raises: malformed frames, undecodable messages and handler
    crashes all turn into status frames.
    """
    timer = spec.stage_timer
    t0 = _time.perf_counter()
    ms = spec.methods.get(name)
    if ms is None:
        return encode_frame_payload(STATUS_METHOD_NOT_FOUND, b"")
    try:
        # Views, not slices: a multi-MB source attachment reaches the
        # handler without being copied out of the request frame.
        _, meta, attachment = decode_frame_views(data)
        req = ms.request_cls.FromString(meta)
    except Exception as e:
        return encode_frame_payload(STATUS_TRANSPORT_FAILURE,
                                    f"malformed request: {e!r}".encode())
    ctx = RpcContext(peer=peer)
    try:
        resp = ms.handler(req, attachment, ctx)
    except RpcError as e:
        out = encode_frame_payload(e.status, e.message.encode())
        _tls.server_inner_s = _time.perf_counter() - t0
        return out
    except Exception as e:
        out = encode_frame_payload(STATUS_TRANSPORT_FAILURE,
                                   f"handler error: {e!r}".encode())
        _tls.server_inner_s = _time.perf_counter() - t0
        return out
    t1 = _time.perf_counter()
    out = encode_frame_payload(0, resp.SerializeToString(),
                               ctx.response_attachment)
    t2 = _time.perf_counter()
    if timer is not None:
        # handler covers request decode too (both are message-codec
        # work on the request side; the response side is `serialize`).
        timer.record(f"{name}:handler", t1 - t0)
        timer.record(f"{name}:serialize", t2 - t1)
    _tls.server_inner_s = t2 - t0
    return out


def dispatch_frame(spec: ServiceSpec, name: str, data: bytes, peer: str) -> bytes:  # ytpu: untrusted(data)
    return dispatch_frame_payload(spec, name, data, peer).join()


# --------------------------------------------------------------------------
# Fault-injection seam.
#
# Tests impose latency, drops and refusals on the real call path without
# forking the transports: one process-global hook, called by the mock
# channel before the request leaves.  It may sleep (latency), raise
# RpcError (drop/refuse), or do nothing.  Production never installs one:
# the None fast path is a single global read.
# --------------------------------------------------------------------------

# fn(target, service, method) -> None; may sleep or raise RpcError.
_fault_injector: Optional[Callable[[str, str, str], None]] = None


def install_fault_injector(
        fn: Optional[Callable[[str, str, str], None]]) -> None:
    """Install (or, with None, clear) the process-wide RPC fault hook.
    ``target`` is the channel's destination (a mock name), so an
    injector can single out one server."""
    global _fault_injector
    _fault_injector = fn


def apply_faults(target: str, service: str, method_name: str) -> None:
    fn = _fault_injector
    if fn is not None:
        fn(target, service, method_name)


# --------------------------------------------------------------------------
# mock:// transport — in-process server registry for tests.
# --------------------------------------------------------------------------

_mock_servers: Dict[str, Dict[str, ServiceSpec]] = {}
_mock_lock = threading.Lock()


def register_mock_server(name: str, *services: ServiceSpec) -> None:
    with _mock_lock:
        _mock_servers[name] = {s.service_name: s for s in services}


def unregister_mock_server(name: str) -> None:
    with _mock_lock:
        _mock_servers.pop(name, None)


class Channel:
    """Client-side channel; scheme-dispatched factory.

    ``Channel("grpc://10.0.0.1:8336")``, ``Channel("aio://10.0.0.1:8336")``
    (the event-loop front end's raw-TCP frame transport) or
    ``Channel("mock://scheduler")`` (an in-process server registered with
    register_mock_server); a bare "host:port" is treated as grpc.

    A comma-separated URI list ("grpc://a:8336,grpc://b:8336") builds a
    FailoverChannel over the members in order of preference: how
    daemons dial an active scheduler with a warm standby behind it.
    """

    def __new__(cls, uri: str):
        if cls is not Channel:
            return super().__new__(cls)
        # Return the concrete subclass instance; Python's call protocol
        # then runs its __init__ exactly once (do NOT call it here).
        if "," in uri:
            return object.__new__(FailoverChannel)
        if uri.startswith("mock://"):
            return object.__new__(_MockChannel)
        if uri.startswith("aio://"):
            from .aio_server import AioChannel

            return object.__new__(AioChannel)
        from .grpc_transport import GrpcChannel

        return object.__new__(GrpcChannel)

    def call(
        self,
        service: str,
        method_name: str,
        request,
        response_cls: type,
        attachment: bytes = b"",
        timeout: Optional[float] = None,
    ) -> Tuple[object, bytes]:
        raise NotImplementedError

    def close(self) -> None:
        pass


class FailoverChannel(Channel):
    """A channel over an ordered URI list ("active,standby,...").

    Calls go to the currently-preferred member; on a transport-shaped
    failure (TRANSPORT_FAILURE, TIMEOUT, NOT_SERVING) the channel
    rotates to the next URI under common/backoff.py pacing and retries,
    up to two laps around the list before surfacing the last error.
    Application-status errors (NO_QUOTA, refusals, ...) pass straight
    through: a different scheduler would answer them the same way.

    Member channels are built lazily and cached, so a standby that was
    never needed is never dialed.  Fault injection stays per-member:
    each underlying channel applies the process-wide injector against
    its own target, exactly as a directly-dialed channel would."""

    # Failures that mean "this endpoint can't serve me right now", as
    # opposed to "my request was ruled on".
    _ROTATE_STATUSES = frozenset(
        (STATUS_TRANSPORT_FAILURE, STATUS_TIMEOUT, STATUS_NOT_SERVING))

    def __init__(self, uri: str):
        self._uris = tuple(u.strip() for u in uri.split(",") if u.strip())
        if len(self._uris) < 2:
            raise ValueError(f"failover channel needs >= 2 URIs: {uri!r}")
        self._lock = threading.Lock()
        self._chans: Dict[int, Channel] = {}  # guarded by: self._lock
        self._preferred = 0  # guarded by: self._lock
        self._failovers = 0  # guarded by: self._lock

    def _member(self, idx: int) -> Channel:
        with self._lock:
            ch = self._chans.get(idx)
            if ch is None:
                ch = self._chans[idx] = Channel(self._uris[idx])
            return ch

    def call(self, service, method_name, request, response_cls,
             attachment=b"", timeout=None):
        from ..common.backoff import Backoff

        with self._lock:
            start = self._preferred
        backoff = Backoff(initial_s=0.02, max_s=0.5)
        last: Optional[RpcError] = None
        for attempt in range(2 * len(self._uris)):
            idx = (start + attempt) % len(self._uris)
            try:
                result = self._member(idx).call(
                    service, method_name, request, response_cls,
                    attachment, timeout)
            except RpcError as e:
                if e.status not in self._ROTATE_STATUSES:
                    raise
                last = e
                retry_after_s = None
                if e.status == STATUS_NOT_SERVING:
                    retry_after_s = retry_after_ms_from_error(e) / 1000.0
                # Drop the dead member's channel so the next attempt
                # re-dials instead of reusing a wedged connection.
                with self._lock:
                    stale = self._chans.pop(idx, None)
                if stale is not None:
                    stale.close()
                backoff.wait(retry_after_s)
                continue
            with self._lock:
                if self._preferred != idx:
                    self._failovers += 1
                    self._preferred = idx
            return result
        raise last

    def preferred_uri(self) -> str:
        with self._lock:
            return self._uris[self._preferred]

    def failovers(self) -> int:
        with self._lock:
            return self._failovers

    def close(self) -> None:
        with self._lock:
            chans, self._chans = list(self._chans.values()), {}
        for ch in chans:
            ch.close()


class _MockChannel(Channel):
    """``mock://name`` — optionally ``mock://name@ip:port`` to control the
    peer address the server-side context observes."""

    def __init__(self, uri: str):
        rest = uri[len("mock://") :]
        self._name, _, peer = rest.partition("@")
        self._peer = peer or "127.0.0.1:0"

    def call(self, service, method_name, request, response_cls,
             attachment=b"", timeout=None):
        apply_faults(self._name, service, method_name)
        with _mock_lock:
            services = _mock_servers.get(self._name)
        if services is None or service not in services:
            raise RpcError(STATUS_TRANSPORT_FAILURE,
                           f"no mock server for {self._name}/{service}")
        frame = encode_frame(0, request.SerializeToString(), attachment)
        reply = dispatch_frame(services[service], method_name, frame,
                               peer=self._peer)
        status, meta, att = decode_frame_views(reply)
        if status != 0:
            raise RpcError(status, bytes(meta).decode(errors="replace"))
        return response_cls.FromString(meta), att
