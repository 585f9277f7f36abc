"""Transport layer for the control plane.

``grpc://host:port`` is the threaded transport over grpc's generic
(bytes in / bytes out) API, ``aio://host:port`` the event-loop front end
(``aio_server.py``: long-polls parked as continuations, not threads),
``mock://name`` an in-process server for tests; every call carries a
length-prefixed frame
(a serialized message plus an optional attachment).  Services are plain
objects exposing ``service_name`` and a ``methods`` table.
"""

from .transport import (
    STATUS_NOT_SERVING,
    Channel,
    RpcContext,
    RpcError,
    ServiceSpec,
    register_mock_server,
    retry_after_ms_from_error,
    unregister_mock_server,
)
from .grpc_transport import GrpcServer

__all__ = [
    "STATUS_NOT_SERVING",
    "Channel",
    "GrpcServer",
    "RpcContext",
    "RpcError",
    "ServiceSpec",
    "make_rpc_server",
    "register_mock_server",
    "retry_after_ms_from_error",
    "unregister_mock_server",
]


def make_rpc_server(frontend: str, address: str, *, max_workers: int = 32,
                    accept_loops: int = 1):
    """Factory for the entry's ``--rpc-frontend threaded|aio``:
    "threaded" (alias "grpc") is the gRPC thread-pool server, "aio" the
    event-loop front end (rpc/aio_server.py).  ``accept_loops`` > 1
    shards the aio accept path across N SO_REUSEPORT event loops
    (AioServerGroup); the threaded front end ignores it — its pool is
    the concurrency knob."""
    if frontend == "aio":
        from .aio_server import AioRpcServer, AioServerGroup

        if accept_loops > 1:
            return AioServerGroup(address, accept_loops=accept_loops,
                                  max_workers=max_workers)
        return AioRpcServer(address, max_workers=max_workers)
    if frontend in ("threaded", "grpc"):
        return GrpcServer(address, max_workers=max_workers)
    raise ValueError(f"unknown rpc frontend {frontend!r}")
