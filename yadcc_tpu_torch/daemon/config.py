"""Daemon-wide configuration (a copy of the JAX package's
yadcc_tpu/daemon/config.py, the whole dataclass: the delegate's fields
wait for the delegate's slice).

Parity with reference yadcc/daemon/common_flags.{h,cc}: the scheduler
URI (deliberately ONE host — the reference scopes out scheduler HA,
common_flags.cc:19-28, and so do we), the cache-server URI, the access
token, and the protocol version ledger (see version.py).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .temp_dir import default_temp_root


@dataclass
class DaemonConfig:
    scheduler_uri: str = "grpc://127.0.0.1:8336"
    cache_server_uri: str = ""  # empty: cache disabled
    token: str = ""

    # Servant side.
    serving_port: int = 8335
    location: str = ""  # ip:port advertised to the scheduler
    servant_priority_dedicated: bool = False
    max_remote_tasks: int = 0  # 0: derive from capacity policy

    # Delegate side.
    local_port: int = 8334
    # 0 = derive heavy limit from cores (reference --max_local_tasks).
    max_local_tasks: int = 0
    # Reference --lightweight_local_task_overprovisioning_ratio.
    lightweight_overprovisioning_ratio: float = 1.5
    # Reference --debugging_always_use_servant_at: dial THIS servant
    # for every dispatched task instead of the granted one (grants
    # still come from the scheduler).  Debug/testing only.
    debugging_always_use_servant_at: str = ""

    # Reference --cpu_load_average_seconds / --compiler_rescan_interval.
    cpu_load_average_seconds: int = 15
    compiler_rescan_interval: float = 60.0

    temporary_dir: str = field(default_factory=default_temp_root)
    inspect_port: int = 9335
    inspect_credential: str = ""
