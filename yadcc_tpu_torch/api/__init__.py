"""Wire contract of the scheduler, the cache server, the servant and the
delegate's loopback HTTP API: protobuf messages + service names.

The generated modules under ``gen/`` are byte-identical copies of the
ones the JAX package ships, so both packages speak the same wire format
(and can load into one process: the descriptors land in one pool)."""

from .gen import cache_pb2 as cache
from .gen import daemon_pb2 as daemon
from .gen import env_desc_pb2 as env_desc
from .gen import extra_info_pb2 as extra_info
from .gen import fanout_pb2 as fanout
from .gen import jit_pb2 as jit
from .gen import local_pb2 as local
from .gen import patch_pb2 as patch
from .gen import scheduler_pb2 as scheduler

EnvironmentDesc = env_desc.EnvironmentDesc

__all__ = ["cache", "daemon", "env_desc", "extra_info", "fanout", "jit",
           "local", "patch", "scheduler", "EnvironmentDesc"]
