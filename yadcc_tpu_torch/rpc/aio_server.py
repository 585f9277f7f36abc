"""Event-loop RPC front end (``--rpc-frontend aio``).

The threaded front end (``grpc_transport.GrpcServer``) parks one worker
thread per waiting ``WaitForStartingTask`` for its whole wait.  This
module serves the same ``ServiceSpec`` objects on ONE selector event loop
(asyncio) while keeping the wire *frame* byte-identical to the gRPC
transport's (``transport.py``: ``[u32 status][u32 meta_len][meta]
[attachment]``):

* :class:`AioRpcServer` — hosts ServiceSpecs over a raw-TCP
  length-prefixed envelope.  Frames are parsed incrementally from
  non-blocking sockets (:class:`FrameStreamParser`: partial reads,
  pipelining and a slow-loris byte-drip are all states of the parser);
  blocking handlers run unmodified on a BOUNDED worker pool, and replies
  gather-write their ``Payload`` segments straight to the transport.
* *Parked* methods (``ServiceSpec.add_parked``): long-poll handlers take
  a ``done`` continuation instead of holding a worker thread.  A waiting
  client costs a pending-table entry in the owning component; the
  completing thread (the scheduler's dispatch thread) calls ``done`` and
  the loop writes the bytes.  ``done`` answers once: a second call is
  refused and counted (``double_replies`` in ``inspect()``).
* :class:`AioServerGroup` — N accept loops on one port (SO_REUSEPORT).
* :class:`AioChannel` — the matching sync client (``aio://host:port``):
  one persistent connection per channel with seq-matched pipelining.
  :class:`AsyncAioChannel` is the loop-native client that holds
  thousands of concurrent calls on one thread.

Stage accounting: the servers record ``accept`` / ``read`` / ``parse`` /
``write`` into a ``utils.stagetimer.StageTimer`` (``inspect()["stages"]``),
and each loop records how late its own tick fires (``loop_lag``): the
time a handler, a parked continuation or an inline dispatch cycle held
the loop.

Coroutines and parked handlers here must never block — no sleep, file
or socket I/O or sync RPC on the loop — or the loop regresses to the
thread-per-connection latency profile it replaces.  The HTTP half of the
JAX module (the daemon's local HTTP service) is not ported here.
"""

from __future__ import annotations

import asyncio
import itertools
import socket
import struct
import threading
import time as _time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..utils import looplag
from ..utils.logging import get_logger
from ..utils.stagetimer import FRONTEND_STAGES, StageTimer
from .transport import (
    Channel,
    Payload,
    RpcContext,
    RpcError,
    ServiceSpec,
    STATUS_METHOD_NOT_FOUND,
    STATUS_TIMEOUT,
    STATUS_TRANSPORT_FAILURE,
    decode_frame_views,
    dispatch_frame_payload,
    encode_frame,
    encode_frame_payload,
)

logger = get_logger("rpc.aio")

# Envelope framing over the TCP stream.  Both directions:
#
#     [u32 len][u32 seq][payload bytes...]      (len counts seq+payload)
#
# Request payload:  [u16 svc_len][u16 method_len][svc][method][frame]
# Response payload: [frame]
#
# The *frame* bytes are byte-identical to what the gRPC transport carries
# for the same call (tests/test_torch_aio_frontend.py holds them so).
_ENVELOPE = struct.Struct("<II")
_REQ_PREAMBLE = struct.Struct("<HH")
_MAX_ENVELOPE = (1 << 30) + 64  # the gRPC message cap + preamble


class ProtocolError(Exception):
    """Unrecoverable stream corruption; the connection must close."""


class FrameStreamParser:
    """Incremental envelope parser for the raw-TCP frame transport.

    ``feed(data)`` returns every complete ``(seq, payload)`` message the
    stream holds so far — zero on a partial read, many on a pipelined
    burst; a slow-loris byte-drip simply keeps returning [].  Oversized
    or nonsense lengths raise :class:`ProtocolError` (the stream cannot
    be resynchronized).
    """

    __slots__ = ("_buf", "_need", "_seq")

    def __init__(self):
        self._buf = bytearray()
        self._need = -1  # payload bytes still unknown
        self._seq = 0

    def feed(self, data) -> List[Tuple[int, bytes]]:
        self._buf += data
        out: List[Tuple[int, bytes]] = []
        while True:
            if self._need < 0:
                if len(self._buf) < _ENVELOPE.size:
                    break
                length, seq = _ENVELOPE.unpack_from(self._buf)
                if length < 4 or length > _MAX_ENVELOPE:
                    raise ProtocolError(f"bad envelope length {length}")
                self._need = length - 4  # seq already consumed
                self._seq = seq
                del self._buf[:_ENVELOPE.size]
            if len(self._buf) < self._need:
                break
            payload = bytes(self._buf[: self._need])
            del self._buf[: self._need]
            self._need = -1
            out.append((self._seq, payload))
        return out

    def pending_bytes(self) -> int:
        return len(self._buf)


def split_request_payload(payload) -> Tuple[str, str, memoryview]:
    """Request payload -> (service, method, frame_view)."""
    if len(payload) < _REQ_PREAMBLE.size:
        raise ProtocolError("truncated request preamble")
    svc_len, m_len = _REQ_PREAMBLE.unpack_from(payload)
    off = _REQ_PREAMBLE.size
    if off + svc_len + m_len > len(payload):
        raise ProtocolError("request preamble overruns payload")
    mv = memoryview(payload)
    service = bytes(mv[off:off + svc_len]).decode("utf-8", "replace")
    method = bytes(
        mv[off + svc_len:off + svc_len + m_len]).decode("utf-8", "replace")
    return service, method, mv[off + svc_len + m_len:]


def make_request_payload(service: str, method: str, frame) -> List[bytes]:
    svc = service.encode()
    m = method.encode()
    return [_REQ_PREAMBLE.pack(len(svc), len(m)), svc, m, frame]


def _envelope_segments(seq: int, payload_segments: List[bytes]) -> List:
    total = 4 + sum(len(s) for s in payload_segments)
    return [_ENVELOPE.pack(total, seq)] + payload_segments


# ---------------------------------------------------------------------------
# The event loop host.
# ---------------------------------------------------------------------------


# Cadence of the always-on per-loop tick.  Each tick records how late it
# fired (the loop's lag: how long something else held the loop when the
# tick fell due) and keeps lag_s() current for /inspect/vars.  At 20 Hz a
# few seconds of serving give the percentiles a few hundred samples for a
# negligible share of the loop.
_TICK_INTERVAL_S = 0.05


class EventLoopThread:
    """One asyncio loop on one daemon thread, shared by any number of
    servers.  ``--rpc-frontend aio`` processes run one of these per
    accept loop (N with SO_REUSEPORT — see AioServerGroup); tests create
    and dispose of them freely."""

    def __init__(self, name: str = "aio-loop"):
        self.name = name
        self.loop = asyncio.new_event_loop()
        self._thread = threading.Thread(
            target=self._run, name=name, daemon=True)
        self._started = threading.Event()
        self._last_tick = _time.monotonic()
        self._lag_lock = threading.Lock()
        self._lag = np.zeros(4096, np.float64)  # guarded by: self._lag_lock
        self._lag_count = 0  # guarded by: self._lag_lock
        self._lag_max = 0.0  # guarded by: self._lag_lock
        self._thread.start()
        self._started.wait(5.0)
        looplag.register(self.loop, name)
        try:
            self.loop.call_soon_threadsafe(self._tick, None)
        except RuntimeError:
            pass  # loop already closed (teardown race in tests)

    def _run(self) -> None:
        asyncio.set_event_loop(self.loop)
        self.loop.call_soon(self._started.set)
        self.loop.run_forever()

    def _tick(self, due: Optional[float]) -> None:  # loop thread only
        now = _time.monotonic()
        self._last_tick = now
        if due is not None:
            late = max(0.0, now - due)
            with self._lag_lock:
                self._lag[self._lag_count % len(self._lag)] = late
                self._lag_count += 1
                self._lag_max = max(self._lag_max, late)
        if not self.loop.is_closed():
            # Self-rearming; it dies with the loop, nothing to cancel.
            self.loop.call_later(_TICK_INTERVAL_S, self._tick,
                                 now + _TICK_INTERVAL_S)

    def lag_s(self) -> float:
        """Seconds the loop is overdue for its tick; ~0.0 on a healthy
        loop, grows while a handler stalls it."""
        return max(0.0,
                   _time.monotonic() - self._last_tick - _TICK_INTERVAL_S)

    def lag_stats(self) -> Dict[str, float]:
        """How late the loop's tick fired over the retained window (the
        last 4,096 ticks): count (lifetime), p50, p99 and the worst stall
        (lifetime), in ms."""
        with self._lag_lock:
            n = min(self._lag_count, len(self._lag))
            samples = self._lag[:n].copy()
            count, worst = self._lag_count, self._lag_max
        if n == 0:
            return {"count": 0, "p50_ms": 0.0, "p99_ms": 0.0, "max_ms": 0.0}
        p50, p99 = np.percentile(samples * 1e3, (50, 99))
        return {"count": int(count), "p50_ms": round(float(p50), 4),
                "p99_ms": round(float(p99), 4),
                "max_ms": round(worst * 1e3, 4)}

    def run_sync(self, coro, timeout: float = 10.0):
        """Run a coroutine on the loop from a foreign thread, blocking
        for its result (setup/teardown plumbing, never the data path)."""
        return asyncio.run_coroutine_threadsafe(
            coro, self.loop).result(timeout)

    def call_soon(self, fn, *args) -> None:
        self.loop.call_soon_threadsafe(fn, *args)

    def stop(self) -> None:
        if self.loop.is_closed():
            return
        self.loop.call_soon_threadsafe(self.loop.stop)
        self._thread.join(timeout=5.0)
        if not self.loop.is_running():
            self.loop.close()


class LoopTimer:
    """Thread-safe cancel handle for a ``call_later`` armed from any
    thread.  The loop's own TimerHandle only exists after the
    call_soon_threadsafe hop lands; ``cancel()`` before the hop
    suppresses arming, ``cancel()`` after it cancels on the loop.
    Either way the timer dies — a parked continuation that wins the
    race against its deadline must cancel, or the deadline fires into
    the settled responder and the handle pins the closure until the
    deadline elapses."""

    __slots__ = ("_loops", "_lock", "_handle", "_cancelled")

    def __init__(self, loops: EventLoopThread):
        self._loops = loops
        self._lock = threading.Lock()
        self._handle = None
        self._cancelled = False

    def _arm(self, delay_s: float, fn, args) -> None:  # loop thread only
        with self._lock:
            if self._cancelled:
                return
            self._handle = self._loops.loop.call_later(
                delay_s, fn, *args)

    def cancel(self) -> None:
        with self._lock:
            self._cancelled = True
            handle, self._handle = self._handle, None
        if handle is not None:
            # TimerHandle.cancel is not thread-safe; hop to the loop.
            # A loop already stopped (teardown racing a completion
            # continuation) has no timers left to fire — nothing to do.
            try:
                self._loops.call_soon(handle.cancel)
            except RuntimeError:
                pass

    @property
    def cancelled(self) -> bool:
        with self._lock:
            return self._cancelled


# ---------------------------------------------------------------------------
# RPC server.
# ---------------------------------------------------------------------------


class _RpcConnection(asyncio.Protocol):
    __slots__ = ("server", "parser", "transport", "peer",
                 "_accepted_at", "_first_request_seen",
                 "_read_started_at")

    def __init__(self, server: "AioRpcServer"):
        self.server = server
        self.parser = FrameStreamParser()
        self.transport: Optional[asyncio.Transport] = None
        self.peer = ""
        self._accepted_at = _time.perf_counter()
        self._first_request_seen = False
        self._read_started_at: Optional[float] = None

    def connection_made(self, transport) -> None:
        self.transport = transport
        peername = transport.get_extra_info("peername") or ("?", 0)
        self.peer = f"{peername[0]}:{peername[1]}"
        self.server._conn_opened(self)

    def connection_lost(self, exc) -> None:
        self.server._conn_closed(self)

    def data_received(self, data) -> None:  # loop thread only
        timer = self.server.stage_timer
        now = _time.perf_counter()
        if self._read_started_at is None:
            self._read_started_at = now
        try:
            t0 = _time.perf_counter()
            messages = self.parser.feed(data)
            timer.record("parse", _time.perf_counter() - t0)
        except ProtocolError as e:
            logger.warning("rpc stream error from %s: %s", self.peer, e)
            self.transport.close()
            return
        if not messages:
            return
        # A request's `read` stage: first byte of its envelope to the
        # byte that completed it (pipelined requests completing in one
        # chunk share the chunk's read span).
        timer.record("read", now - self._read_started_at)
        self._read_started_at = (
            None if self.parser.pending_bytes() == 0 else now)
        if not self._first_request_seen:
            self._first_request_seen = True
            timer.record("accept", now - self._accepted_at)
        for seq, payload in messages:
            self.server._dispatch(self, seq, payload)

    def send_payload(self, seq: int, payload: Payload) -> None:  # loop only
        if self.transport is None or self.transport.is_closing():
            return
        t0 = _time.perf_counter()
        segments = list(payload.iter_segments())
        self.transport.writelines(_envelope_segments(seq, segments))
        self.server.stage_timer.record("write", _time.perf_counter() - t0)


class AioRpcServer:
    """Hosts ServiceSpecs on a TCP port via one event loop.

    Blocking handlers run on a bounded ``ThreadPoolExecutor`` (default 8
    — handlers are short; long-polls belong in parked methods).  Methods
    registered via ``ServiceSpec.add_parked`` run ON the loop with a
    ``done`` continuation and must not block.
    """

    def __init__(self, address: str = "127.0.0.1:0", *,
                 loops: Optional[EventLoopThread] = None,
                 max_workers: int = 8,
                 reuse_port: bool = False):
        self._services: Dict[str, ServiceSpec] = {}
        self._own_loops = loops is None
        self.loops = loops or EventLoopThread(name="aio-rpc")
        self.stage_timer = StageTimer(FRONTEND_STAGES, maxlen=16384)
        self._pool = ThreadPoolExecutor(
            max_workers=max_workers, thread_name_prefix="aio-rpc-worker")
        self._conns: set = set()  # guarded by: self._conn_lock
        self._conn_lock = threading.Lock()
        self._stats_lock = threading.Lock()
        self._double_replies = 0  # guarded by: self._stats_lock
        host, _, port = address.rpartition(":")
        self._asyncio_server = self.loops.run_sync(
            self._start_server(host or "127.0.0.1", int(port),
                               reuse_port))
        self.port = self._asyncio_server.sockets[0].getsockname()[1]

    async def _start_server(self, host, port, reuse_port):
        return await self.loops.loop.create_server(
            lambda: _RpcConnection(self), host, port,
            reuse_port=reuse_port or None, backlog=1024)

    def add_service(self, spec: ServiceSpec) -> None:
        self._services[spec.service_name] = spec

    def start(self) -> None:
        pass  # serving from construction; kept for GrpcServer parity

    def stop(self, grace: Optional[float] = 1.0) -> None:
        async def _close():
            self._asyncio_server.close()
            # Close the live connections first: since Python 3.12.1
            # wait_closed() waits for every connection to end.
            with self._conn_lock:
                conns = list(self._conns)
            for c in conns:
                if c.transport is not None:
                    c.transport.close()
            await self._asyncio_server.wait_closed()

        try:
            self.loops.run_sync(_close())
        except Exception:
            logger.exception("aio server close failed")
        self._pool.shutdown(wait=False)
        if self._own_loops:
            self.loops.stop()

    # -- connection registry -------------------------------------------------

    def _conn_opened(self, conn) -> None:
        with self._conn_lock:
            self._conns.add(conn)

    def _conn_closed(self, conn) -> None:
        with self._conn_lock:
            self._conns.discard(conn)

    def connection_count(self) -> int:
        with self._conn_lock:
            return len(self._conns)

    def _note_double_reply(self) -> None:
        with self._stats_lock:
            self._double_replies += 1

    def inspect(self) -> Dict[str, object]:
        """Serving stats: connections, every refused second reply
        (``double_replies``), the loop's lag and the front-end stages."""
        with self._stats_lock:
            doubles = self._double_replies
        return {"connections": self.connection_count(),
                "double_replies": doubles, "port": self.port,
                "loop_lag_s": round(self.loops.lag_s(), 4),
                "loop_lag": self.loops.lag_stats(),
                "stages": self.stage_timer.percentiles()}

    # -- dispatch (loop thread) ----------------------------------------------

    def _dispatch(self, conn: _RpcConnection, seq: int, payload) -> None:
        try:
            service, method, frame = split_request_payload(payload)
        except ProtocolError as e:
            logger.warning("rpc preamble error from %s: %s", conn.peer, e)
            conn.transport.close()
            return
        spec = self._services.get(service)
        if spec is None:
            conn.send_payload(seq, encode_frame_payload(
                STATUS_METHOD_NOT_FOUND,
                f"no service {service}".encode()))
            return
        parked = spec.parked.get(method)
        if parked is not None:
            self._dispatch_parked(conn, seq, spec, parked, frame)
            return
        fut = self.loops.loop.run_in_executor(
            self._pool, dispatch_frame_payload, spec, method, frame,
            conn.peer)
        fut.add_done_callback(
            lambda f: self._send_result(conn, seq, f))

    def _send_result(self, conn, seq, fut) -> None:  # loop thread only
        try:
            reply = fut.result()
        except Exception as e:  # handler pool died; keep the connection
            logger.exception("aio dispatch failed")
            reply = encode_frame_payload(
                STATUS_TRANSPORT_FAILURE, f"dispatch error: {e!r}".encode())
        conn.send_payload(seq, reply)

    def _dispatch_parked(self, conn, seq, spec: ServiceSpec, ms,
                         frame) -> None:  # loop thread only
        """Long-poll path: the handler runs on the loop, registers its
        continuation with the owning component and returns without a
        response.  The completing thread calls ``done``, which encodes
        the reply and hands the write to the loop.  ``done`` answers
        once; a second call is refused and counted."""
        timer = spec.stage_timer
        t0 = _time.perf_counter()
        try:
            _, meta, attachment = decode_frame_views(frame)
            req = ms.request_cls.FromString(meta)
        except Exception as e:
            conn.send_payload(seq, encode_frame_payload(
                STATUS_TRANSPORT_FAILURE,
                f"malformed request: {e!r}".encode()))
            return
        ctx = RpcContext(peer=conn.peer)
        fired = [False]
        fired_lock = threading.Lock()

        def done(resp, *, error: Optional[RpcError] = None) -> None:
            with fired_lock:
                if fired[0]:
                    self._note_double_reply()
                    return
                fired[0] = True
            t1 = _time.perf_counter()
            if error is not None:
                reply = encode_frame_payload(error.status,
                                             error.message.encode())
            else:
                reply = encode_frame_payload(
                    0, resp.SerializeToString(), ctx.response_attachment)
            if timer is not None:
                timer.record(f"{ms.name}:handler", t1 - t0)
                timer.record(f"{ms.name}:serialize",
                             _time.perf_counter() - t1)
            try:
                self.loops.call_soon(conn.send_payload, seq, reply)
            except RuntimeError:
                pass  # the loop stopped (server teardown): no one to answer

        try:
            ms.handler(req, attachment, ctx, done)
        except RpcError as e:
            done(None, error=e)
        except Exception as e:
            logger.exception("parked handler %s failed", ms.name)
            done(None, error=RpcError(STATUS_TRANSPORT_FAILURE,
                                      f"handler error: {e!r}"))

    def call_later(self, delay_s: float, fn, *args) -> LoopTimer:
        """Schedule ``fn`` on the loop — the timer half of a parked
        continuation (deadline replies, poll re-arms).  Returns a
        thread-safe handle; the continuation that beats its deadline
        must ``cancel()`` it."""
        timer = LoopTimer(self.loops)
        self.loops.call_soon(timer._arm, delay_s, fn, args)
        return timer


class AioServerGroup:
    """N accept loops on ONE port: each loop owns a full ``AioRpcServer``
    bound with ``SO_REUSEPORT``, so the kernel shards incoming
    connections across loops and every connection's parser, parked
    continuations and deadline timers live on the loop that accepted it
    — no cross-loop state, no shared accept lock.

    ``inspect()`` returns the sum of the per-loop counters plus a
    ``per_loop`` list; the sum equals what a single-loop server reports
    for the same workload.  The group quacks like ``AioRpcServer``
    (``port`` / ``add_service`` / ``start`` / ``stop`` / ``call_later``
    / ``connection_count`` / ``inspect``), so the entry swaps it in via
    ``make_rpc_server(..., accept_loops=N)``.
    """

    def __init__(self, address: str = "127.0.0.1:0", *,
                 accept_loops: int = 2, max_workers: int = 8):
        if accept_loops < 1:
            raise ValueError(f"accept_loops must be >= 1, "
                             f"got {accept_loops}")
        self.accept_loops = accept_loops
        # The pool exists only for non-parked methods; split it so the
        # group's total worker count matches a single-loop server's.
        per_workers = max(1, max_workers // accept_loops)
        host, _, port = address.rpartition(":")
        host = host or "127.0.0.1"
        self._loops: List[EventLoopThread] = []
        self._servers: List[AioRpcServer] = []
        bind_port = int(port)
        for i in range(accept_loops):
            loops = EventLoopThread(name=f"aio-rpc-{i}")
            server = AioRpcServer(f"{host}:{bind_port}", loops=loops,
                                  max_workers=per_workers,
                                  reuse_port=True)
            # Loop 0 resolves ":0"; the rest must land on the same port
            # for SO_REUSEPORT to shard instead of scatter.
            bind_port = server.port
            self._loops.append(loops)
            self._servers.append(server)
        self.port = self._servers[0].port
        self._rr = itertools.count()

    def add_service(self, spec: ServiceSpec) -> None:
        # One ServiceSpec shared by all loops: specs are read-only after
        # registration and handlers hand thread-safety to the owning
        # component, exactly as with a single server.
        for server in self._servers:
            server.add_service(spec)

    def start(self) -> None:
        pass  # serving from construction; GrpcServer parity

    def stop(self, grace: Optional[float] = 1.0) -> None:
        for server in self._servers:
            server.stop(grace)
        # The servers were handed their loops, so they did not stop
        # them (_own_loops is False); the group owns loop lifetime.
        for loops in self._loops:
            loops.stop()

    def call_later(self, delay_s: float, fn, *args) -> LoopTimer:
        """Timer for component-side deadlines that are not tied to a
        connection.  Round-robins across loops so a timer storm does not
        pile onto loop 0."""
        server = self._servers[next(self._rr) % len(self._servers)]
        return server.call_later(delay_s, fn, *args)

    def connection_count(self) -> int:
        return sum(s.connection_count() for s in self._servers)

    def inspect(self) -> Dict[str, object]:
        per_loop = []
        for i, server in enumerate(self._servers):
            entry = dict(server.inspect())
            entry["loop"] = f"aio-rpc-{i}"
            per_loop.append(entry)
        return {
            "connections": sum(e["connections"] for e in per_loop),
            "double_replies": sum(e["double_replies"] for e in per_loop),
            "port": self.port,
            "accept_loops": self.accept_loops,
            "per_loop": per_loop,
        }


# ---------------------------------------------------------------------------
# Clients.
# ---------------------------------------------------------------------------

# Process-wide connection accounting: dials is sockets actually
# connected, reuses is calls served on an existing connection.
_conn_stats_lock = threading.Lock()
_conn_stats = {"dials": 0, "reuses": 0}  # guarded by: _conn_stats_lock


def _note_dial() -> None:
    with _conn_stats_lock:
        _conn_stats["dials"] += 1


def _note_reuse() -> None:
    with _conn_stats_lock:
        _conn_stats["reuses"] += 1


def aio_connection_stats() -> Dict[str, int]:
    with _conn_stats_lock:
        return dict(_conn_stats)


class _SyncReader(threading.Thread):
    """Reader side of AioChannel's persistent socket: demuxes pipelined
    responses to per-seq waiters."""

    def __init__(self, channel: "AioChannel", sock):
        super().__init__(name="aio-chan-reader", daemon=True)
        self.channel = channel
        self.sock = sock

    def run(self) -> None:
        parser = FrameStreamParser()
        try:
            while True:
                data = self.sock.recv(1 << 16)
                if not data:
                    break
                for seq, payload in parser.feed(data):
                    self.channel._complete(seq, payload)
        except (OSError, ProtocolError):
            pass
        self.channel._reader_died(self)


class AioChannel(Channel):
    """Sync client channel for ``aio://host:port``.

    One persistent connection per channel; concurrent callers pipeline
    over it with seq matching (the reader thread demuxes).  Dials are
    counted once per socket (``aio_connection_stats``)."""

    def __init__(self, uri: str):
        target = uri[len("aio://"):] if uri.startswith("aio://") else uri
        self._target = target
        host, _, port = target.rpartition(":")
        self._addr = (host or "127.0.0.1", int(port))
        self._lock = threading.Lock()
        self._sock = None  # guarded by: self._lock
        self._reader: Optional[_SyncReader] = None  # guarded by: self._lock
        self._next_seq = 1  # guarded by: self._lock
        self._waiters: Dict[int, list] = {}  # guarded by: self._lock

    # -- connection lifecycle ------------------------------------------------

    def _ensure_sock(self):
        with self._lock:
            if self._sock is not None:
                _note_reuse()
                return self._sock
        sock = socket.create_connection(self._addr, timeout=10.0)
        sock.settimeout(None)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        with self._lock:
            if self._sock is not None:  # raced; keep the winner
                sock.close()
                _note_reuse()
                return self._sock
            self._sock = sock
            self._reader = _SyncReader(self, sock)
            self._reader.start()
        _note_dial()
        return sock

    def _complete(self, seq: int, payload: bytes) -> None:
        with self._lock:
            waiter = self._waiters.pop(seq, None)
        if waiter is not None:
            waiter[1] = payload
            waiter[0].set()

    def _reader_died(self, reader) -> None:
        with self._lock:
            if self._reader is not reader:
                return  # an old generation; the live socket is fine
            sock, self._sock, self._reader = self._sock, None, None
            waiters, self._waiters = self._waiters, {}
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass
        for waiter in waiters.values():
            waiter[0].set()  # payload stays None -> transport failure

    # -- the call ------------------------------------------------------------

    def _send(self, service, method_name, frame):
        """Register a waiter and send one request; returns the waiter
        ([event, reply payload or None])."""
        try:
            sock = self._ensure_sock()
        except OSError as e:
            raise RpcError(STATUS_TRANSPORT_FAILURE,
                           f"connect {self._target}: {e}") from e
        waiter = [threading.Event(), None]
        with self._lock:
            seq = self._next_seq
            self._next_seq += 1
            self._waiters[seq] = waiter
        data = b"".join(_envelope_segments(
            seq, make_request_payload(service, method_name, frame)))
        try:
            with self._lock:
                live = self._sock
            if live is not sock or live is None:
                raise OSError("connection replaced")
            sock.sendall(data)
        except OSError as e:
            with self._lock:
                self._waiters.pop(seq, None)
            self._teardown()
            raise RpcError(STATUS_TRANSPORT_FAILURE,
                           f"send {self._target}: {e}") from e
        return seq, waiter

    def _wait(self, seq, waiter, timeout) -> bytes:
        if not waiter[0].wait(timeout):
            with self._lock:
                self._waiters.pop(seq, None)
            raise RpcError(STATUS_TIMEOUT,
                           f"timed out waiting on {self._target}")
        if waiter[1] is None:
            raise RpcError(STATUS_TRANSPORT_FAILURE,
                           f"connection to {self._target} lost")
        return waiter[1]

    def call(self, service, method_name, request, response_cls,
             attachment=b"", timeout=None):
        frame = encode_frame(0, request.SerializeToString(), attachment)
        seq, waiter = self._send(service, method_name, frame)
        reply = self._wait(seq, waiter,
                           timeout if timeout is not None else 300.0)
        status, meta, att = decode_frame_views(reply)
        if status != 0:
            raise RpcError(status, bytes(meta).decode(errors="replace"))
        return response_cls.FromString(meta), att

    def call_raw(self, service, method_name, frame: bytes,
                 timeout: Optional[float] = None) -> bytes:
        """Send a pre-encoded request frame, return the raw reply frame
        (the byte-parity harness; production uses call())."""
        seq, waiter = self._send(service, method_name, frame)
        return self._wait(seq, waiter,
                          timeout if timeout is not None else 30.0)

    def _teardown(self) -> None:
        with self._lock:
            sock, self._sock, self._reader = self._sock, None, None
        if sock is not None:
            try:
                # shutdown() first: close() alone neither wakes the reader
                # thread blocked in recv() nor sends the FIN until it does.
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                sock.close()
            except OSError:
                pass

    def close(self) -> None:
        self._teardown()


class AsyncAioChannel:
    """Loop-native client: thousands of concurrent calls on one
    connection, each an awaiting coroutine instead of a parked thread.
    Construct and use from ON the loop."""

    def __init__(self, target: str):
        target = target[len("aio://"):] if target.startswith("aio://") \
            else target
        self._target = target
        host, _, port = target.rpartition(":")
        self._addr = (host or "127.0.0.1", int(port))
        self._transport = None
        self._pending: Dict[int, asyncio.Future] = {}
        self._next_seq = 1
        self._parser = FrameStreamParser()
        self._conn_lock: Optional[asyncio.Lock] = None

    async def connect(self) -> None:
        loop = asyncio.get_running_loop()
        chan = self

        class _Proto(asyncio.Protocol):
            def data_received(self, data):
                for seq, payload in chan._parser.feed(data):
                    fut = chan._pending.pop(seq, None)
                    if fut is not None and not fut.done():
                        fut.set_result(payload)

            def connection_lost(self, exc):
                chan._fail_all()

        self._transport, _ = await loop.create_connection(
            _Proto, *self._addr)
        _note_dial()

    def _fail_all(self) -> None:
        pending, self._pending = self._pending, {}
        for fut in pending.values():
            if not fut.done():
                fut.set_exception(RpcError(
                    STATUS_TRANSPORT_FAILURE, "connection lost"))

    async def call(self, service, method_name, request, response_cls,
                   attachment=b"", timeout: Optional[float] = None):
        if self._conn_lock is None:
            self._conn_lock = asyncio.Lock()
        async with self._conn_lock:  # concurrent callers dial once
            if self._transport is None or self._transport.is_closing():
                await self.connect()
            else:
                _note_reuse()
        frame = encode_frame(0, request.SerializeToString(), attachment)
        seq = self._next_seq
        self._next_seq += 1
        fut = asyncio.get_running_loop().create_future()
        self._pending[seq] = fut
        self._transport.writelines(_envelope_segments(
            seq, make_request_payload(service, method_name, frame)))
        try:
            payload = await asyncio.wait_for(fut, timeout)
        except asyncio.TimeoutError:
            self._pending.pop(seq, None)
            raise RpcError(STATUS_TIMEOUT, "call timed out") from None
        status, meta, att = decode_frame_views(payload)
        if status != 0:
            raise RpcError(status, bytes(meta).decode(errors="replace"))
        return response_cls.FromString(meta), att

    def close(self) -> None:
        if self._transport is not None:
            self._transport.close()
            self._transport = None
