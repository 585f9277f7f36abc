"""Transport layer for the control plane.

``grpc://host:port`` is the threaded transport over grpc's generic
(bytes in / bytes out) API; every call carries a length-prefixed frame
(a serialized message plus an optional attachment).  Services are plain
objects exposing ``service_name`` and a ``methods`` table.
"""

from .transport import (
    Channel,
    RpcContext,
    RpcError,
    ServiceSpec,
)
from .grpc_transport import GrpcServer

__all__ = [
    "Channel",
    "GrpcServer",
    "RpcContext",
    "RpcError",
    "ServiceSpec",
]
