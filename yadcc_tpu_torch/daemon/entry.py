"""Daemon main: one process, two roles (a copy of the JAX package's
yadcc_tpu/daemon/entry.py): C++ compiles, and the jit, AOT and autotune
builds, whose servant worker runs nvcc for the card (``--jit-backends``).

Parity with reference yadcc/daemon/entry.cc:69-262: a *delegate* serving
local clients over loopback HTTP (:8334, ``--local-port``) and a
*servant* serving peer daemons over RPC (:8335); environment scrubbing
(LC_ALL, GCC_COMPARE_DEBUG, SOURCE_DATE_EPOCH would make outputs differ
across machines and poison the cache); privilege drop; stale temp
cleanup; ordered shutdown.  Neither role runs anything on the card (the
delegate checks the cache one key at a time on its host filter, and the
servant's build worker only runs nvcc), so the entry loads no torch and
takes no ``--device``.  Under ``--rpc-frontend
aio`` the servant's RPC, the delegate's loopback HTTP (its quota and
wait long polls parked as continuations on the loop) and the inspect
port are all served by the event-loop front end.  Run:

    python -m yadcc_tpu_torch.daemon.entry \\
        --scheduler-uri grpc://scheduler:8336 \\
        --cache-server-uri grpc://cache:8337 --token DAEMON_TOKEN

and point a compiler wrapper at ``--local-port`` (YTPU_DAEMON_PORT).
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
from .local.config_keeper import ConfigKeeper
from .local.distributed_cache_reader import DistributedCacheReader
from .local.distributed_task_dispatcher import DistributedTaskDispatcher
from .local.file_digest_cache import FileDigestCache
from .local.http_service import LocalHttpService
from .local.local_task_monitor import LocalTaskMonitor
from .local.running_task_keeper import RunningTaskKeeper
from .local.task_grant_keeper import TaskGrantKeeper
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


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("yadcc-tpu-torch-daemon")
    p.add_argument("--scheduler-uri", default="grpc://127.0.0.1:8336",
                   help="scheduler endpoint(s).  Comma-separated URIs "
                        "are an ordered active,standby failover list "
                        "(dialed through FailoverChannel: on transport "
                        "failure or NOT_SERVING the daemon rotates and "
                        "re-dials under backoff); ';'-separated groups "
                        "are federation cells, each group its own "
                        "failover list.  The servant role belongs to the "
                        "first cell; the delegate homes each compiler "
                        "env on a cell by consistent hash on its digest")
    p.add_argument("--cache-server-uri", default="")
    p.add_argument("--token", default="",
                   help="the daemon's token: the scheduler and the cache "
                        "server check it as a servant's (heartbeats, "
                        "fills) and as a user's (grants, reads)")
    p.add_argument("--local-port", type=int, default=8334,
                   help="the delegate's loopback HTTP port, which "
                        "compiler wrappers call")
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
    p.add_argument("--max-local-tasks", type=int, default=0,
                   help="heavy-class local quota; 0 = cores/2 "
                        "(reference --max_local_tasks)")
    p.add_argument("--lightweight-ratio", type=float, default=1.5,
                   help="lightweight-class quota as a multiple of cores "
                        "(reference "
                        "--lightweight_local_task_overprovisioning_ratio)")
    p.add_argument("--cpu-load-average-seconds", type=_load_window,
                   default=15, help="loadavg window reported in "
                                    "heartbeats (1..60)")
    p.add_argument("--compiler-rescan-interval", type=float, default=60.0)
    p.add_argument("--debugging-always-use-servant-at", default="",
                   help="debug only: dial THIS servant for every "
                        "dispatched task instead of the granted one")
    p.add_argument("--rpc-frontend", default="threaded",
                   choices=["threaded", "aio"],
                   help="servant RPC front end, and the scheme the "
                        "delegate dials peer servants with (a fleet-wide "
                        "choice): 'threaded' = grpc thread pool; 'aio' = "
                        "the event-loop front end, where "
                        "WaitForCompilationOutput parks as a loop "
                        "continuation (peers dial aio://), and so do "
                        "the local HTTP service's long polls")
    p.add_argument("--jit-backends", default="auto",
                   choices=["auto", "none", "cuda"],
                   help="jit, AOT and autotune builds this servant serves "
                        "(its worker runs nvcc for the card): 'auto' = "
                        "cuda when nvcc is found; 'none' = no jit "
                        "serving; 'cuda' = cuda, and nvcc must be found")
    p.add_argument("--accept-loops", type=int, default=1,
                   help="aio front end only: shard the accept path "
                        "across N SO_REUSEPORT event loops; 1 = single "
                        "loop")
    return p


def _guess_local_ip(scheduler_uri: str) -> str:
    # Multi-URI forms (cell groups ';', failover lists ','): route
    # discovery only needs ONE reachable peer — use the first URI.
    first = scheduler_uri.split(";")[0].split(",")[0].strip()
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
    """Serve until SIGINT, SIGTERM or a client's ask_to_leave, then leave
    the scheduler gracefully, return the delegate's grants and kill what
    still runs."""
    from ..utils.locktrace import install_from_env

    install_from_env()  # YTPU_LOCKTRACE=1: lock-order checking tier
    for var in _SCRUBBED_ENV:
        os.environ.pop(var, None)
    if not args.no_privilege_drop:
        drop_privileges()

    # Federation: a servant BELONGS to one cell — heartbeats, config
    # pulls, and running-task renewal dial only the first ';'-group (its
    # own cell's active,standby failover list, through FailoverChannel).
    # Only the grant keeper (delegate role) federates across all cells,
    # homing each compiler env by digest.
    cell_uri = args.scheduler_uri.split(";")[0].strip()
    config = DaemonConfig(
        scheduler_uri=cell_uri,
        cache_server_uri=args.cache_server_uri,
        token=args.token,
        serving_port=args.serving_port,
        local_port=args.local_port,
        servant_priority_dedicated=args.dedicated,
        max_remote_tasks=args.max_remote_tasks,
        max_local_tasks=args.max_local_tasks,
        lightweight_overprovisioning_ratio=args.lightweight_ratio,
        debugging_always_use_servant_at=args.debugging_always_use_servant_at,
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

    # ---- servant role ----
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
    if args.jit_backends == "auto":
        jit_envs = None  # DaemonService's default: cuda iff nvcc is found
    elif args.jit_backends == "none":
        jit_envs = []
    else:
        from ..jit.env import local_jit_environment

        jit_envs = [local_jit_environment(args.jit_backends)]
        if not jit_envs[0].toolchain_version:
            raise SystemExit("--jit-backends cuda: nvcc not found "
                             "(PATH, $CUDA_HOME/bin, /usr/local/cuda/bin)")
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
        cgroup_present=cgroup_present, jit_environments=jit_envs)
    # Before spec(): an aio front end parks WaitForCompilationOutput on
    # the accept loop (engine continuation + loop deadline timer).
    service.attach_frontend(server)
    server.add_service(service.spec())
    server.start()

    # ---- delegate role ----
    # Grants over the whole --scheduler-uri (cells and failover lists);
    # the serving-daemon token and the running tasks from our own cell.
    grant_keeper = TaskGrantKeeper(args.scheduler_uri, args.token)
    config_keeper = ConfigKeeper(cell_uri, args.token)
    cache_reader = DistributedCacheReader(args.cache_server_uri, args.token)
    running_keeper = RunningTaskKeeper(cell_uri)
    dispatcher = DistributedTaskDispatcher(
        grant_keeper=grant_keeper,
        config_keeper=config_keeper,
        cache_reader=cache_reader,
        running_task_keeper=running_keeper,
        debugging_always_use_servant_at=config.debugging_always_use_servant_at,
        # The front end is a fleet-wide choice: an aio daemon's peers
        # serve aio:// too.
        servant_scheme=("aio://" if args.rpc_frontend == "aio"
                        else "grpc://"),
        # Fan-out parents fill their reduced verdict (the autotune sweep's
        # winner record) through the servant role's writer.
        cache_writer=cache_writer,
    )
    monitor = LocalTaskMonitor(
        max_heavy_tasks=config.max_local_tasks,
        light_ratio=config.lightweight_overprovisioning_ratio)
    digest_cache = FileDigestCache()
    stop = threading.Event()
    # On aio the loopback HTTP and the inspect port serve on the servant
    # RPC's loop: one loop thread for the process.
    loops = server.loops if args.rpc_frontend == "aio" else None
    http = LocalHttpService(
        monitor=monitor, digest_cache=digest_cache, dispatcher=dispatcher,
        on_leave=stop.set, port=args.local_port,
        # The jit cache shim: gets through the delegate's reader, puts
        # through the servant role's writer (static token).
        cache_reader=cache_reader, cache_writer=cache_writer,
        frontend=args.rpc_frontend, loops=loops)

    config_keeper.start()
    cache_reader.start()
    running_keeper.start()
    service.start_heartbeat()
    http.start()
    inspect = InspectServer(args.inspect_port, args.inspect_credential,
                            frontend=args.rpc_frontend, loops=loops)
    inspect.start()
    exposed = {
        "yadcc/daemon/engine": engine.inspect,
        "yadcc/daemon/servant": service.inspect,
        "yadcc/daemon/dispatcher": dispatcher.inspect,
        "yadcc/daemon/monitor": monitor.inspect,
        "yadcc/daemon/cache_reader": cache_reader.inspect,
        "yadcc/daemon/local_http": http.inspect,
    }
    # Front-end serving stats: on aio these carry `double_replies`.
    if hasattr(server, "inspect"):
        exposed["yadcc/daemon/servant_rpc"] = server.inspect
    for path, producer in exposed.items():
        exposed_vars.expose(path, producer)
    logger.info("daemon up: local HTTP :%d, servant RPC :%d (as %s, %s), "
                "capacity %d, compilers %d, inspect :%d", http.port,
                server.port, config.location, args.rpc_frontend, capacity,
                len(registry.environments()), inspect.port)

    for sig in (signal.SIGINT, signal.SIGTERM):
        signal.signal(sig, lambda *_: stop.set())
    last_rescan = time.monotonic()
    while not stop.wait(1.0):
        dispatcher.on_timer()
        monitor.on_reclaim_timer()
        if time.monotonic() - last_rescan >= config.compiler_rescan_interval:
            registry.rescan()
            last_rescan = time.monotonic()

    logger.info("shutting down")
    service.stop_heartbeat(graceful_leave=True)
    http.stop()
    # Aborts in-flight tasks, returns the grant keeper's queued grants
    # and stops the cache reader.
    dispatcher.stop()
    inspect.stop()  # before the server whose loop it may share
    server.stop()
    for c in (config_keeper, running_keeper):
        c.stop()
    for path in exposed:
        exposed_vars.unexpose(path)
    engine.stop()
    shutdown_pack_executor()


def main() -> None:
    daemon_start(build_arg_parser().parse_args())


if __name__ == "__main__":
    main()
