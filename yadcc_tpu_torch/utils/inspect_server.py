"""Loopback-friendly HTTP introspection endpoint shared by all servers.

Parity with the reference's /inspect/vars JSON dumps on every process
(yadcc/doc/debugging.md:26-174), gated by optional basic auth
(yadcc/common/inspect_auth.h).  A copy of the JAX package's
yadcc_tpu/utils/inspect_server.py, both front ends."""

from __future__ import annotations

import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from ..common.inspect_auth import InspectAuth
from . import exposed_vars


class _Handler(BaseHTTPRequestHandler):
    auth: InspectAuth = InspectAuth("")

    def log_message(self, *args):  # silence per-request stderr noise
        pass

    def do_GET(self):
        if not self.path.startswith("/inspect/vars"):
            self.send_error(404)
            return
        if not self.auth.check(self.headers.get("Authorization")):
            self.send_response(401)
            self.send_header("WWW-Authenticate", 'Basic realm="inspect"')
            self.end_headers()
            return
        prefix = self.path[len("/inspect/vars"):].strip("/")
        body = exposed_vars.dump_json(prefix).encode()
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)


class InspectServer:
    """``frontend="threaded"``: a ThreadingHTTPServer on its own thread;
    ``"aio"`` (``--rpc-frontend aio``): an AioHttpServer on ``loops``
    (the entry's RPC loop; one of its own when None), whose loop routes
    the request and whose bounded pool runs the dump (it may call any
    exposed callable, so it stays off the loop)."""

    def __init__(self, port: int = 0, credential: str = "",
                 host: str = "127.0.0.1", frontend: str = "threaded",
                 loops=None):
        self._auth = InspectAuth(credential)
        if frontend == "aio":
            from ..rpc.aio_server import AioHttpServer

            self._httpd = None
            self._aio = AioHttpServer(self._handle_aio,
                                      address=f"{host}:{port}", loops=loops)
            self.port = self._aio.port
        else:
            self._aio = None
            handler = type("BoundHandler", (_Handler,),
                           {"auth": self._auth})
            self._httpd = ThreadingHTTPServer((host, port), handler)
            self.port = self._httpd.server_port
        self._thread: Optional[threading.Thread] = None

    def _handle_aio(self, responder) -> None:  # ytpu: loop-only
        if responder.method != "GET" or \
                not responder.path.startswith("/inspect/vars"):
            responder._reply(404, content_type="text/plain")
            return
        if not self._auth.check(responder.headers.get("authorization")):
            # The threaded handler's answer: 401 with the challenge.
            responder._reply(401, content_type="text/plain",
                             extra_headers=(("WWW-Authenticate",
                                             'Basic realm="inspect"'),))
            return
        prefix = responder.path[len("/inspect/vars"):].strip("/")

        def dump() -> None:
            responder._reply(200, exposed_vars.dump_json(prefix).encode())

        self._aio.submit(dump)

    def start(self) -> None:
        if self._aio is not None:
            return  # the loop serves from construction
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="inspect", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        if self._aio is not None:
            self._aio.stop()
            return
        self._httpd.shutdown()
        self._httpd.server_close()
