"""Loopback-friendly HTTP introspection endpoint shared by all servers.

Parity with the reference's /inspect/vars JSON dumps on every process
(yadcc/doc/debugging.md:26-174), gated by optional basic auth
(yadcc/common/inspect_auth.h)."""

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
    def __init__(self, port: int = 0, credential: str = "",
                 host: str = "127.0.0.1"):
        self._auth = InspectAuth(credential)
        handler = type("BoundHandler", (_Handler,), {"auth": self._auth})
        self._httpd = ThreadingHTTPServer((host, port), handler)
        self.port = self._httpd.server_port
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="inspect", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
