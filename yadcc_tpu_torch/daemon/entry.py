"""Daemon main, the servant role (a copy of the servant half of the JAX
package's yadcc_tpu/daemon/entry.py; the delegate role, with its flags
--local-port, --max-local-tasks, --lightweight-ratio and
--debugging-always-use-servant-at, comes with the delegate's slice, and
until then argparse refuses those flags).

Parity with reference yadcc/daemon/entry.cc:69-262: a *servant* serving
peer daemons over RPC (:8335), environment scrubbing (LC_ALL,
GCC_COMPARE_DEBUG, SOURCE_DATE_EPOCH would make outputs differ across
machines and poison the cache), privilege drop, stale temp cleanup,
ordered shutdown.  The servant runs nothing on the card, so the entry
loads no torch and takes no ``--device``.  Run:

    python -m yadcc_tpu_torch.daemon.entry \\
        --scheduler-uri grpc://scheduler:8336 \\
        --cache-server-uri grpc://cache:8337 --token SERVANT_TOKEN
"""

from __future__ import annotations

import argparse
import os
import signal
import socket
import threading
import time

from ..rpc import make_rpc_server
from ..utils import exposed_vars
from ..utils.inspect_server import InspectServer
from ..utils.logging import get_logger
from .cloud.compiler_registry import CompilerRegistry
from .cloud.cxx_task import shutdown_pack_executor
from .cloud.daemon_service import DaemonService
from .cloud.distributed_cache_writer import DistributedCacheWriter
from .cloud.execution_engine import ExecutionEngine, decide_capacity
from .config import DaemonConfig
from .privilege import drop_privileges
from .sysinfo import LoadAverageSampler
from .temp_dir import clean_stale_temp_dirs

logger = get_logger("daemon.entry")

# Vars that make compiler output machine-dependent (reference entry.cc
# env scrub): clear before any compile subprocess inherits them.
_SCRUBBED_ENV = ("LC_ALL", "GCC_COMPARE_DEBUG", "SOURCE_DATE_EPOCH")


def _load_window(v: str) -> int:
    n = int(v)
    if not 1 <= n <= 60:
        # The sampler ring holds 61 one-second samples; outside this
        # range the math silently degrades (0 reports a permanently idle
        # machine and the scheduler over-grants).
        raise argparse.ArgumentTypeError(
            "--cpu-load-average-seconds must be in 1..60")
    return n


def _scheduler_uri(v: str) -> str:
    # The reference hands a ','-list to a failover channel; the port
    # has none yet, and heartbeats sent only to the first URI would
    # keep going to a dead active after a standby takes over.
    if "," in v.split(";")[0]:
        raise argparse.ArgumentTypeError(
            "a ','-separated failover list in --scheduler-uri needs the "
            "failover channel, which this package does not have yet")
    return v


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("yadcc-tpu-torch-daemon")
    p.add_argument("--scheduler-uri", default="grpc://127.0.0.1:8336",
                   type=_scheduler_uri,
                   help="scheduler endpoint; of a ';'-separated list of "
                        "federation cells the servant belongs to the "
                        "first (a ','-separated failover list is "
                        "refused)")
    p.add_argument("--cache-server-uri", default="")
    p.add_argument("--token", default="",
                   help="the servant token: the scheduler and the cache "
                        "server check it (--acceptable-servant-tokens)")
    p.add_argument("--serving-port", type=int, default=8335)
    p.add_argument("--inspect-port", type=int, default=9335)
    p.add_argument("--inspect-credential", default="")
    p.add_argument("--location", default="",
                   help="ip:port advertised to the scheduler")
    p.add_argument("--dedicated", action="store_true")
    p.add_argument("--max-remote-tasks", type=int, default=0)
    p.add_argument("--extra-compiler-dirs", default="")
    p.add_argument("--extra-compiler-bundle-dirs", default="",
                   help="parent dirs of whole toolchain bundles; every "
                   "<bundle>/*/bin is scanned (reference "
                   "--extra_compiler_bundle_dirs)")
    p.add_argument("--temporary-dir", default="")
    p.add_argument("--allow-poor-machine", action="store_true",
                   help="serve even with <=16 cores (small test rigs)")
    p.add_argument("--ignore-cgroup-limits", action="store_true",
                   help="serve even inside a cgroup/container; only safe "
                        "when the container really owns its cores")
    p.add_argument("--no-privilege-drop", action="store_true")
    p.add_argument("--cpu-load-average-seconds", type=_load_window,
                   default=15, help="loadavg window reported in "
                                    "heartbeats (1..60)")
    p.add_argument("--compiler-rescan-interval", type=float, default=60.0)
    p.add_argument("--rpc-frontend", default="threaded",
                   choices=["threaded", "aio"],
                   help="servant RPC front end: 'threaded' = grpc thread "
                        "pool; 'aio' = the event-loop front end, where "
                        "WaitForCompilationOutput parks as a loop "
                        "continuation (peers dial aio://)")
    p.add_argument("--accept-loops", type=int, default=1,
                   help="aio front end only: shard the accept path "
                        "across N SO_REUSEPORT event loops; 1 = single "
                        "loop")
    return p


def _guess_local_ip(scheduler_uri: str) -> str:
    # Of ';'-separated cells, route discovery only needs ONE reachable
    # peer: the first.
    first = scheduler_uri.split(";")[0].strip()
    target = first.split("://")[-1]
    host, _, port = target.rpartition(":")
    try:
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    except OSError:
        return "127.0.0.1"
    try:
        s.connect((host or "8.8.8.8", int(port or 443)))
        return s.getsockname()[0]
    except OSError:
        # The fd must not leak on the failure path.
        return "127.0.0.1"
    finally:
        s.close()


def daemon_start(args) -> None:
    """Serve until SIGINT or SIGTERM, then leave the scheduler gracefully
    and kill what still runs."""
    for var in _SCRUBBED_ENV:
        os.environ.pop(var, None)
    if not args.no_privilege_drop:
        drop_privileges()

    # A servant BELONGS to one cell: heartbeats dial the first group.
    cell_uri = args.scheduler_uri.split(";")[0].strip()
    config = DaemonConfig(
        scheduler_uri=cell_uri,
        cache_server_uri=args.cache_server_uri,
        token=args.token,
        serving_port=args.serving_port,
        servant_priority_dedicated=args.dedicated,
        max_remote_tasks=args.max_remote_tasks,
        cpu_load_average_seconds=args.cpu_load_average_seconds,
        compiler_rescan_interval=args.compiler_rescan_interval,
        inspect_port=args.inspect_port,
        inspect_credential=args.inspect_credential,
    )
    if args.temporary_dir:
        config.temporary_dir = args.temporary_dir
    # A missing temp root otherwise surfaces much later as a cryptic
    # FileNotFoundError when the servant prepares its first workspace.
    os.makedirs(config.temporary_dir, exist_ok=True)
    removed = clean_stale_temp_dirs(config.temporary_dir)
    if removed:
        logger.info("removed %d stale temp dirs", removed)

    sampler = LoadAverageSampler()
    cgroup_present = False if args.ignore_cgroup_limits else None
    capacity, _ = decide_capacity(sampler.nprocs, args.dedicated,
                                  allow_poor_machine=args.allow_poor_machine,
                                  cgroup_present=cgroup_present)
    registry = CompilerRegistry(
        [d for d in args.extra_compiler_dirs.split(",") if d],
        bundle_dirs=[d for d in
                     args.extra_compiler_bundle_dirs.split(",") if d])
    engine = ExecutionEngine(max_concurrency=max(capacity, 1))
    server = make_rpc_server(args.rpc_frontend,
                             f"0.0.0.0:{args.serving_port}",
                             accept_loops=args.accept_loops)
    config.location = args.location or \
        f"{_guess_local_ip(cell_uri)}:{server.port}"
    # PutEntry authenticates with the daemon's STATIC token (the cache
    # server checks --acceptable-servant-tokens; reference
    # distributed_cache_writer.cc:68 sends FLAGS_token) — NOT the
    # rotating serving-daemon token, which the cache server never sees.
    cache_writer = DistributedCacheWriter(args.cache_server_uri,
                                          lambda: args.token)
    service = DaemonService(
        config, engine=engine, registry=registry, cache_writer=cache_writer,
        sampler=sampler, allow_poor_machine=args.allow_poor_machine,
        cgroup_present=cgroup_present)
    # Before spec(): an aio front end parks WaitForCompilationOutput on
    # the accept loop (engine continuation + loop deadline timer).
    service.attach_frontend(server)
    server.add_service(service.spec())
    server.start()
    service.start_heartbeat()

    inspect = InspectServer(args.inspect_port, args.inspect_credential)
    inspect.start()
    exposed_vars.expose("yadcc/daemon/engine", engine.inspect)
    exposed_vars.expose("yadcc/daemon/servant", service.inspect)
    # Front-end serving stats: on aio these carry `double_replies`.
    if hasattr(server, "inspect"):
        exposed_vars.expose("yadcc/daemon/servant_rpc", server.inspect)
    logger.info("servant up: RPC :%d (as %s, %s), capacity %d, compilers "
                "%d, inspect :%d", server.port, config.location,
                args.rpc_frontend, capacity, len(registry.environments()),
                inspect.port)

    stop = threading.Event()
    for sig in (signal.SIGINT, signal.SIGTERM):
        signal.signal(sig, lambda *_: stop.set())
    last_rescan = time.monotonic()
    while not stop.wait(1.0):
        if time.monotonic() - last_rescan >= config.compiler_rescan_interval:
            registry.rescan()
            last_rescan = time.monotonic()

    logger.info("shutting down")
    service.stop_heartbeat(graceful_leave=True)
    server.stop()
    inspect.stop()
    for path in ("yadcc/daemon/engine", "yadcc/daemon/servant",
                 "yadcc/daemon/servant_rpc"):
        exposed_vars.unexpose(path)
    engine.stop()
    shutdown_pack_executor()


def main() -> None:
    daemon_start(build_arg_parser().parse_args())


if __name__ == "__main__":
    main()
