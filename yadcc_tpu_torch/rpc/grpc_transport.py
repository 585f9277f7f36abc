"""grpc-backed transport.

Uses grpc's generic (bytes-in/bytes-out) handler API so no grpc_tools
codegen is required: every method is a unary-unary call on the path
``/<service_name>/<method>`` whose payload is the frame defined in
transport.py.  Attachments therefore never pass through protobuf
serialization, mirroring the reference's flare attachments.

Connection pools are deliberately tiny (one channel per target): the
reference keeps 2 connections per server to dodge TCP idle slow-start
(yadcc/daemon/entry.cc:88-98); HTTP/2 multiplexing gives us the same
property with one.
"""

from __future__ import annotations

import threading
from concurrent import futures
from typing import Dict, Optional, Tuple

import grpc

from .transport import (
    Channel,
    RpcError,
    ServiceSpec,
    STATUS_TIMEOUT,
    STATUS_TRANSPORT_FAILURE,
    decode_frame_views,
    dispatch_frame,
    encode_frame,
)

_MAX_MESSAGE = 1 << 30  # 1 GiB, matches the reference's largest packet cap.

_CHANNEL_OPTIONS = [
    ("grpc.max_send_message_length", _MAX_MESSAGE),
    ("grpc.max_receive_message_length", _MAX_MESSAGE),
]


def _peer_to_hostport(peer: str) -> str:
    # grpc peers look like "ipv4:1.2.3.4:56" or "ipv6:[::1]:56".
    if peer.startswith("ipv4:"):
        return peer[5:]
    if peer.startswith("ipv6:"):
        return peer[5:]
    return peer


class _GenericService(grpc.GenericRpcHandler):
    def __init__(self, services: Dict[str, ServiceSpec]):
        self._services = services

    def service(self, handler_call_details):
        # Path: /<service>/<method>
        _, service, method_name = handler_call_details.method.split("/", 2)
        spec = self._services.get(service)
        if spec is None:
            return None

        def unary(request: bytes, context) -> bytes:
            return dispatch_frame(
                spec, method_name, request,
                peer=_peer_to_hostport(context.peer()))

        return grpc.unary_unary_rpc_method_handler(
            unary,
            request_deserializer=None,  # raw bytes
            response_serializer=None,
        )


class GrpcServer:
    """Hosts ServiceSpecs on a TCP port."""

    def __init__(self, address: str = "0.0.0.0:0", max_workers: int = 32):
        self._services: Dict[str, ServiceSpec] = {}
        self._server = grpc.server(
            futures.ThreadPoolExecutor(max_workers=max_workers),
            options=_CHANNEL_OPTIONS,
        )
        self._server.add_generic_rpc_handlers(
            (_GenericService(self._services),))
        self.port = self._server.add_insecure_port(address)
        if self.port == 0:
            raise RuntimeError(f"cannot bind {address}")

    def add_service(self, spec: ServiceSpec) -> None:
        self._services[spec.service_name] = spec

    def start(self) -> None:
        self._server.start()

    def stop(self, grace: Optional[float] = 1.0) -> None:
        self._server.stop(grace).wait()


class GrpcChannel(Channel):
    def __init__(self, uri: str):
        target = uri[len("grpc://") :] if uri.startswith("grpc://") else uri
        self._target = target
        self._channel = grpc.insecure_channel(target, options=_CHANNEL_OPTIONS)
        self._lock = threading.Lock()
        self._callables: Dict[Tuple[str, str], grpc.UnaryUnaryMultiCallable] \
            = {}  # guarded by: self._lock

    def _callable(self, service: str, method_name: str):
        key = (service, method_name)
        with self._lock:
            c = self._callables.get(key)
            if c is None:
                c = self._channel.unary_unary(
                    f"/{service}/{method_name}",
                    request_serializer=None,
                    response_deserializer=None,
                )
                self._callables[key] = c
        return c

    def call(self, service, method_name, request, response_cls,
             attachment=b"", timeout=None):
        # The socket boundary: encode_frame flattens header + meta +
        # attachment segments exactly once (a Payload attachment arrives
        # here never having been copied).
        frame = encode_frame(0, request.SerializeToString(), attachment)
        try:
            reply = self._callable(service, method_name)(frame, timeout=timeout)
        except grpc.RpcError as e:  # transport-level failure
            code = e.code() if hasattr(e, "code") else None
            status = (STATUS_TIMEOUT
                      if code == grpc.StatusCode.DEADLINE_EXCEEDED
                      else STATUS_TRANSPORT_FAILURE)
            raise RpcError(status, str(code)) from e
        status, meta, att = decode_frame_views(reply)
        if status != 0:
            raise RpcError(status, bytes(meta).decode(errors="replace"))
        return response_cls.FromString(meta), att

    def call_raw(self, service, method_name, frame: bytes,
                 timeout: Optional[float] = None) -> bytes:
        """Send a pre-encoded request frame, return the raw reply frame
        (the byte-parity harness for the aio front end; production uses
        call())."""
        return self._callable(service, method_name)(frame, timeout=timeout)

    def close(self) -> None:
        self._channel.close()
