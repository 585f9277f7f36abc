"""Wire contract of the scheduler: protobuf messages + service names.

The generated modules under ``gen/`` are byte-identical copies of the
ones the JAX package ships, so both packages speak the same wire format
(and can load into one process: the descriptors land in one pool)."""

from .gen import env_desc_pb2 as env_desc
from .gen import scheduler_pb2 as scheduler

EnvironmentDesc = env_desc.EnvironmentDesc

__all__ = ["env_desc", "scheduler", "EnvironmentDesc"]
