"""Transport layer for the control plane.

``grpc://host:port`` is the threaded transport over grpc's generic
(bytes in / bytes out) API, ``mock://name`` an in-process server for
tests; every call carries a length-prefixed frame
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
    "register_mock_server",
    "retry_after_ms_from_error",
    "unregister_mock_server",
]
