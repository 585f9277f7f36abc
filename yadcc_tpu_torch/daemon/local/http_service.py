"""Client-facing loopback HTTP API (a copy of the JAX package's
yadcc_tpu/daemon/local/http_service.py, both front ends).

Parity with reference yadcc/daemon/local/http_service_impl.{h,cc} and
the wire format in yadcc/daemon/local/README.md: plain HTTP/1.1 on
127.0.0.1, JSON message bodies (uint64 as strings, per proto3 JSON),
multi-chunk framing when attachments are present.  Routes:

    GET  /local/get_version
    POST /local/ask_to_leave
    POST /local/acquire_quota        (200 granted / 503 timeout)
    POST /local/release_quota
    POST /local/set_file_digest
    POST /local/jit_cache_get        (the jit cache shim; 404: miss)
    POST /local/jit_cache_put

plus one submit/wait route PAIR per registered task kind
(task_registry.py — cxx, jit, aot, autotune):

    POST /local/submit_<kind>_task   (multi-chunk: json + attachment;
                                      400: fix the submission and retry
                                      — e.g. report compiler digest
                                      or jit environment first)
    POST /local/wait_for_<kind>_task (503: still running, retry;
                                      404: unknown task id)

With a TenancyControl every POST route fails closed (403) without a
valid X-Ytpu-Tenant credential; an over-budget tenant's submission gets
503 + Retry-After, and its tier's fan-out cap bounds its AOT and
autotune submissions.

``frontend="threaded"`` serves on a ThreadingHTTPServer, a thread a
connection; ``"aio"`` (``--rpc-frontend aio``) on the event-loop front
end (rpc/aio_server.py): acquire_quota and wait_for_<kind>_task park as
continuations with a loop timer for their deadline, the other POST
routes run on its bounded pool, and both front ends answer alike.
"""

from __future__ import annotations

import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional

from google.protobuf import json_format

from ... import api
from ...common import multi_chunk
from ...common.hashing import digest_keyed
from ...common.limits import (MAX_WIRE_BODY, BodyTooLarge,
                              checked_content_length, clamp_wait_s)
from ...common.payload import Payload
from ...tenancy.budgets import TenantOverBudget
from ...tenancy.keys import tenant_scoped_key
from ...tenancy.tiers import tier_fanout_cap
from ...utils.logging import get_logger
from ...version import BUILT_AT, VERSION_FOR_UPGRADE
from .distributed_task_dispatcher import DistributedTaskDispatcher
from .file_digest_cache import FileDigestCache
from .local_task_monitor import LocalTaskMonitor
from .task_registry import default_registry

logger = get_logger("daemon.http")

# Sentinel distinct from None: None = tenancy disabled (anonymous OK),
# _TENANT_DENIED = tenancy enabled and this request failed verification.
_TENANT_DENIED = object()
_TENANT_HEADER = "x-ytpu-tenant"
_DENIED_BODY = b'{"error":"valid tenant credential required"}'

_DENIED_BUDGET_BODY = b'{"error":"tenant over budget"}'

# Shim keys are opaque client strings; they are domain-hashed into a
# versioned namespace (the JAX package's, byte for byte) so they never
# collide with task-derived cache keys.
_SHIM_KEY_PREFIX = "ytpu-jitext1-"
_SHIM_KEY_DOMAIN = "ytpu-jit-extcache"


def shim_cache_key(client_key: str,
                   tenant_secret: str = "") -> str:  # ytpu: sanitizes(key-domain, tenant-domain)
    return tenant_scoped_key(
        tenant_secret,
        _SHIM_KEY_PREFIX + digest_keyed(_SHIM_KEY_DOMAIN,
                                        client_key.encode()))


def _to_json(msg) -> bytes:
    # Zero-valued fields (e.g. exit_code 0) must appear explicitly: the
    # zero-dependency client reads them without proto schema knowledge.
    return json_format.MessageToJson(
        msg, preserving_proto_field_name=True,
        always_print_fields_with_no_presence=True).encode()


def _from_json(cls, data: bytes):
    msg = cls()
    json_format.Parse(data.decode(), msg, ignore_unknown_fields=True)
    return msg


class LocalHttpService:
    def __init__(
        self,
        *,
        monitor: LocalTaskMonitor,
        digest_cache: FileDigestCache,
        dispatcher: DistributedTaskDispatcher,
        on_leave: Optional[Callable[[], None]] = None,
        port: int = 8334,
        host: str = "127.0.0.1",
        # The jit cache shim: reads through the delegate's reader, puts
        # through the servant role's cache writer.  Either absent = that
        # route answers 404.
        cache_reader=None,
        cache_writer=None,
        # "threaded" = ThreadingHTTPServer; "aio" = the event-loop front
        # end, where long polls (acquire_quota, wait_for_*) park as
        # continuations plus a loop timer instead of a serving thread.
        frontend: str = "threaded",
        # aio: the loop to serve on (the entry's RPC loop); None = one
        # of the server's own.
        loops=None,
        # Multi-tenant QoS: a tenancy.TenancyControl makes every POST
        # route fail-closed on the X-Ytpu-Tenant credential; the
        # verified binding is stamped onto tasks (tenant-weighted
        # fairness, tenant cache domain).  None (default) = single-
        # tenant mode.
        tenancy=None,
    ):
        self.monitor = monitor
        self.digest_cache = digest_cache
        self.dispatcher = dispatcher
        self.on_leave = on_leave or (lambda: None)
        self.registry = default_registry(digest_cache)
        self.cache_reader = cache_reader
        self.cache_writer = cache_writer
        self.frontend = frontend
        self.tenancy = tenancy
        service = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *args):
                pass

            def _reply(self, code: int, body=b"",
                       content_type: str = "application/json",
                       retry_after_s: Optional[float] = None):
                # `body` may be a chunked Payload: gather-write its
                # segments (wfile buffers small ones; a multi-MB object
                # file goes straight from the servant-reply buffer to
                # the socket, never joined).
                self.send_response(code)
                self.send_header("Content-Type", content_type)
                self.send_header("Content-Length", str(len(body)))
                if retry_after_s is not None:
                    # Backpressure pacing hint; clients feed it to
                    # their backoff instead of guessing.
                    self.send_header("Retry-After", f"{retry_after_s:g}")
                self.end_headers()
                if isinstance(body, Payload):
                    for seg in body.iter_segments():
                        self.wfile.write(seg)
                elif body:
                    self.wfile.write(body)

            def do_GET(self):
                if self.path == "/local/get_version":
                    resp = api.local.GetVersionResponse(
                        built_at=BUILT_AT,
                        version_for_upgrade=VERSION_FOR_UPGRADE)
                    self._reply(200, _to_json(resp))
                else:
                    self._reply(404)

            def do_POST(self):  # ytpu: untrusted(self.headers, self.rfile)
                # Cap BEFORE buffering: any local process can open this
                # socket, and a claimed Content-Length of terabytes
                # must be refused at the header, not handed to the
                # allocator.  413 mirrors the cap the servants enforce
                # on the decompression side.
                try:
                    length = checked_content_length(
                        self.headers.get("Content-Length", 0))
                except BodyTooLarge:
                    self._reply(413, b'{"error":"body exceeds wire cap"}')
                    return
                body = self.rfile.read(length) if length else b""
                try:
                    service._route_post(self, self.path, body)
                except Exception:
                    logger.exception("error handling %s", self.path)
                    try:
                        self._reply(500)
                    except OSError:
                        pass

        if frontend == "aio":
            from ...rpc.aio_server import AioHttpServer

            self._httpd = None
            self._aio = AioHttpServer(
                self._handle_aio, address=f"{host}:{port}", loops=loops,
                max_body=MAX_WIRE_BODY,
                too_large_body=b'{"error":"body exceeds wire cap"}')
            self.port = self._aio.port
        else:
            self._aio = None
            self._httpd = ThreadingHTTPServer((host, port), Handler)
            self.port = self._httpd.server_port
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> None:
        if self._aio is not None:
            return  # the event loop serves from construction
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="local-http", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        if self._aio is not None:
            self._aio.stop()
            return
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)

    def inspect(self) -> dict:
        out = ({"frontend": "threaded", "port": self.port}
               if self._aio is None else self._aio.inspect())
        if self.tenancy is not None:
            out["tenancy"] = self.tenancy.inspect()
        return out

    # -- tenant verification -------------------------------------------------

    def _tenant_binding(self, headers):
        """Resolve the request's tenant from its headers: a
        TenantBinding, None (tenancy disabled — anonymous requests keep
        their legacy behavior), or _TENANT_DENIED (tenancy enabled,
        credential missing/invalid/unknown — the caller must 403).
        Fail-closed: with tenancy on, there is no anonymous path to any
        POST route."""
        if self.tenancy is None:
            return None
        # Both header shapes: the threaded front end's case-insensitive
        # Message and the aio dict (lower-cased keys).
        cred = headers.get(_TENANT_HEADER, "") if headers else ""
        binding = self.tenancy.authenticate(cred)
        return binding if binding is not None else _TENANT_DENIED

    # -- aio front end (event-loop routing) ----------------------------------

    def _handle_aio(self, responder) -> None:  # ytpu: loop-only  # ytpu: responder(responder)
        """Runs ON the loop for every request: long polls park, the
        version route answers inline, every route that may block (task
        submission, set_file_digest, the jit cache shim) goes to the
        bounded worker pool.
        Route semantics and reply bodies match the threaded front end."""
        if responder.method == "GET":
            if responder.path == "/local/get_version":
                responder._reply(200, _to_json(api.local.GetVersionResponse(
                    built_at=BUILT_AT,
                    version_for_upgrade=VERSION_FOR_UPGRADE)))
            else:
                responder._reply(404)
            return
        if responder.method != "POST":
            responder._reply(501)
            return
        # Tenant check BEFORE parking: parked routes drop their headers
        # (release_request), so this is the one place the credential
        # exists.  Pooled routes resolve it again in _route_post (their
        # headers are kept), which also stamps it onto submitted tasks.
        if self._tenant_binding(responder.headers) is _TENANT_DENIED:
            responder._reply(403, _DENIED_BODY)
            return
        path, body = responder.path, responder.request.body
        if path == "/local/acquire_quota":
            self._acquire_quota_parked(responder, body)
            return
        task_type = self.registry.for_wait(path)
        if task_type is not None:
            self._wait_parked(responder, task_type, body)
            return
        self._aio.submit(self._route_post_pooled, responder, path, body)

    def _route_post_pooled(self, responder, path: str, body: bytes) -> None:  # ytpu: responder(responder)
        try:
            self._route_post(responder, path, body)
        except Exception:
            logger.exception("error handling %s", path)
            # A route that replied and then raised must not fire a
            # second 500 into the settled stream.
            if not responder.replied:
                responder._reply(500)

    def _acquire_quota_parked(self, responder, body: bytes) -> None:  # ytpu: untrusted(body)  # ytpu: responder(responder)
        req = _from_json(api.local.AcquireQuotaRequest, body)
        deadline_timer = []

        def on_grant(ok: bool) -> None:
            # The continuation won: its deadline timer dies with it.  The
            # box is filled after acquire_async returns; an inline grant
            # leaves the timer to fire waiter.expire as a no-op.
            if deadline_timer:
                deadline_timer[0].cancel()
            if ok:
                responder._reply(200,
                                 _to_json(api.local.AcquireQuotaResponse()))
            else:
                # The threaded route's pacing: the caller already waited
                # its window server-side.
                responder._reply(503,
                                 _to_json(api.local.AcquireQuotaResponse()),
                                 retry_after_s=0.5)

        responder.release_request()  # parked: keep the continuation only
        waiter = self.monitor.acquire_async(
            req.requestor_pid, req.lightweight_task, on_grant)
        # The deadline half of the parked continuation: a loop timer,
        # not a polling thread (the threaded route's clamp).
        deadline_timer.append(self._aio.call_later(
            clamp_wait_s(req.milliseconds_to_wait), waiter.expire))

    def _wait_parked(self, responder, task_type, body: bytes) -> None:  # ytpu: untrusted(body)  # ytpu: responder(responder)
        req = _from_json(task_type.wait_request_cls, body)
        task_id = req.task_id
        deadline_timer = []
        finishing = []

        def on_done(result) -> None:
            if responder.replied or result is None:
                return
            finishing.append(True)
            # We are going to reply: the deadline timer dies now instead
            # of pinning this closure until the window ends.
            if deadline_timer:
                deadline_timer[0].cancel()
            # Building the answer (a multi-MB object file's framing)
            # belongs on the pool, not on the completing thread.
            self._aio.submit(self._finish_wait_pooled, responder,
                             task_type, task_id, result)

        if not self.dispatcher.wait_for_task_async(task_id, on_done):
            responder._reply(404)
            return
        if finishing:
            return  # the task had finished: answered, no deadline to arm
        responder.release_request()  # parked: keep the continuation only

        def on_deadline() -> None:  # ytpu: allow(reply-drop)  # a completion that fired first answers through _finish_wait_pooled; the deadline yields the reply to it
            if finishing:
                return
            # Still running at the window's end: 503 + Retry-After, the
            # client polls again (the threaded route's answer).
            if not self.dispatcher.is_known(task_id):
                responder._reply(404)
            else:
                responder._reply(503, retry_after_s=0.5)

        # The threaded route's clamp, so both front ends time out alike.
        deadline_timer.append(self._aio.call_later(
            clamp_wait_s(req.milliseconds_to_wait, 10.0), on_deadline))

    def _finish_wait_pooled(self, responder, task_type, task_id: int,
                            result) -> None:  # ytpu: responder(responder)
        resp, out_chunks = task_type.build_wait_response(result)
        payload = multi_chunk.make_multi_chunk_payload(
            [_to_json(resp)] + list(out_chunks))
        # Free only if OUR reply won: when the deadline already answered
        # 503, the client never saw this result and will poll for it
        # again — freeing here would turn that into a 404.
        if responder._reply(200, payload,
                            content_type="application/octet-stream"):
            self.dispatcher.free_task(task_id)

    # -- routing -------------------------------------------------------------

    def _route_post(self, handler, path: str, body: bytes) -> None:  # ytpu: untrusted(body)  # ytpu: responder(handler)
        binding = self._tenant_binding(
            getattr(handler, "headers", None))
        if binding is _TENANT_DENIED:
            handler._reply(403, _DENIED_BODY)
            return
        if path == "/local/ask_to_leave":
            handler._reply(200, _to_json(api.local.AskToLeaveResponse()))
            self.on_leave()
            return
        if path == "/local/acquire_quota":
            req = _from_json(api.local.AcquireQuotaRequest, body)
            # Clamp the client-supplied window: an unbounded value
            # parked this serving thread (and its quota waiter slot)
            # for arbitrary time.  Clients long-poll and re-ask.
            ok = self.monitor.wait_for_running_new_task_permission(
                req.requestor_pid, req.lightweight_task,
                clamp_wait_s(req.milliseconds_to_wait))
            if ok:
                handler._reply(200,
                               _to_json(api.local.AcquireQuotaResponse()))
            else:
                # The machine is saturated and the caller already waited
                # its full window; come back after a beat, not instantly.
                handler._reply(503,
                               _to_json(api.local.AcquireQuotaResponse()),
                               retry_after_s=0.5)
            return
        if path == "/local/release_quota":
            req = _from_json(api.local.ReleaseQuotaRequest, body)
            self.monitor.drop_task_permission(req.requestor_pid)
            handler._reply(200, _to_json(api.local.ReleaseQuotaResponse()))
            return
        if path == "/local/set_file_digest":
            req = _from_json(api.local.SetFileDigestRequest, body)
            self.digest_cache.set(req.file_desc.path, req.file_desc.size,
                                  req.file_desc.timestamp, req.digest)
            handler._reply(200, _to_json(api.local.SetFileDigestResponse()))
            return
        if path == "/local/jit_cache_get":
            self._jit_cache_get(handler, body, binding)
            return
        if path == "/local/jit_cache_put":
            self._jit_cache_put(handler, body, binding)
            return
        task_type = self.registry.for_submit(path)
        if task_type is not None:
            self._submit_task(handler, task_type, body, binding)
            return
        task_type = self.registry.for_wait(path)
        if task_type is not None:
            self._wait_for_task(handler, task_type, body)
            return
        handler._reply(404)

    # -- generic task submit/wait (one flow for every registered kind) -------

    def _submit_task(self, handler, task_type, body: bytes,
                     binding=None) -> None:  # ytpu: untrusted(body)  # ytpu: responder(handler)
        # Views: the (possibly multi-MB) attachment chunk stays a view
        # into the request body all the way to the servant RPC.
        chunks = multi_chunk.try_parse_multi_chunk_views(body)
        if not chunks or len(chunks) != 2:
            handler._reply(400, task_type.bad_chunks_error)
            return
        req = _from_json(task_type.submit_request_cls, bytes(chunks[0]))
        try:
            task = task_type.make_task(req, chunks[1])
        except Exception as e:
            err = task_type.submit_error(e)
            if err is None:
                raise
            handler._reply(400, err)
            return
        if binding is not None:
            # Instance-level stamp of the VERIFIED identity (never the
            # request body): cache domain, two-level fairness, the
            # tier's fan-out rights.
            task.tenant_id = binding.tenant_id
            task.tenant_tier = binding.tier
            task.tenant_key_secret = binding.key_secret
            task.tenant_weight = binding.weight
            task.tenant_fanout_cap = (binding.spec.fanout_cap
                                      or tier_fanout_cap(binding.tier))
        try:
            task_id = self.dispatcher.queue_task(task)
        except TenantOverBudget as e:
            # Budget refusal is backpressure, not an error: same 503 +
            # Retry-After contract the quota and long-poll routes use,
            # so existing client backoff handles it unchanged.
            handler._reply(503, _DENIED_BUDGET_BODY,
                           retry_after_s=e.retry_after_ms / 1000.0)
            return
        # Every submit response is {task_id}; the registered response
        # classes share the field by convention.
        handler._reply(200, _to_json(
            api.local.SubmitCxxTaskResponse(task_id=task_id)))

    def _wait_for_task(self, handler, task_type, body: bytes) -> None:  # ytpu: untrusted(body)  # ytpu: responder(handler)
        req = _from_json(task_type.wait_request_cls, body)
        result = self.dispatcher.wait_for_task(
            req.task_id, clamp_wait_s(req.milliseconds_to_wait, 10.0))
        if result is None:
            if not self.dispatcher.is_known(req.task_id):
                handler._reply(404)
            else:
                handler._reply(503, retry_after_s=0.5)
            return
        resp, out_chunks = task_type.build_wait_response(result)
        self.dispatcher.free_task(req.task_id)
        handler._reply(
            200,
            multi_chunk.make_multi_chunk_payload(
                [_to_json(resp)] + list(out_chunks)),
            content_type="application/octet-stream")

    # -- the jit cache shim's routes -----------------------------------------

    def _jit_cache_get(self, handler, body: bytes,
                       binding=None) -> None:  # ytpu: untrusted(body)  # ytpu: responder(handler)
        req = _from_json(api.jit.JitCacheGetRequest, body)
        if self.cache_reader is None or not req.key:
            handler._reply(404)
            return
        secret = binding.key_secret if binding is not None else ""
        data = self.cache_reader.try_read(shim_cache_key(req.key, secret))
        if data is None:
            handler._reply(404)
            return
        handler._reply(
            200,
            multi_chunk.make_multi_chunk_payload(
                [_to_json(api.jit.JitCacheGetResponse()), data]),
            content_type="application/octet-stream")

    def _jit_cache_put(self, handler, body: bytes,
                       binding=None) -> None:  # ytpu: untrusted(body)  # ytpu: responder(handler)
        chunks = multi_chunk.try_parse_multi_chunk_views(body)
        if not chunks or len(chunks) != 2:
            handler._reply(400, b'{"error":"expect json+value chunks"}')
            return
        req = _from_json(api.jit.JitCachePutRequest, bytes(chunks[0]))
        if self.cache_writer is None or not req.key:
            handler._reply(404)
            return
        secret = binding.key_secret if binding is not None else ""
        self.cache_writer.async_write(shim_cache_key(req.key, secret),
                                      bytes(chunks[1]))
        handler._reply(200, _to_json(api.jit.JitCachePutResponse()))
