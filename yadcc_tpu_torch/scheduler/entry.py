"""Scheduler server main, on the card.

Parity with reference yadcc/scheduler/entry.cc (server on :8336) plus
the inspect endpoint.  Grants are computed on the CUDA device unless
``--device cpu`` is passed; a missing card is an error, not a fallback.
Run:

    python -m yadcc_tpu_torch.scheduler.entry --port 8336

With ``--shards N`` (N > 1) the servant pool is split over N shard
dispatchers behind a ShardRouter (consistent-hash routing, cross-shard
steal), each with its own policy, warmed before serving, launching on a
CUDA stream of its own.

With ``--rpc-frontend aio`` the RPC port is served by the event-loop
front end (rpc/aio_server.py; ``--accept-loops N`` runs N SO_REUSEPORT
loops): a delegate's ``WaitForStartingTask`` long-poll is a parked
continuation in the dispatcher's pending table, not a worker thread, and
delegates dial ``aio://host:port``.  ``yadcc/rpc_server`` in
``/inspect/vars`` carries its connections, ``double_replies``, the
loops' lag and the front-end stages.  The inspect endpoint is served on
the same front end (an AioHttpServer on the RPC server's first loop).

Warm standby (scheduler/replication.py): an active started with
``--replicate-to grpc://STANDBY`` streams its lease journal to a
scheduler started with ``--standby``.  The standby builds and warms its
dispatcher on the card at boot, refuses scheduler RPCs until the stream
falls silent for ``--standby-takeover-silence`` seconds, then replays
the journal into that dispatcher and serves:

    python -m yadcc_tpu_torch.scheduler.entry --port 8337 --standby \
        --replication-token SECRET
    python -m yadcc_tpu_torch.scheduler.entry --port 8336 \
        --replicate-to grpc://127.0.0.1:8337 --replication-token SECRET
"""

from __future__ import annotations

import argparse
import signal
import sys
import threading
import time

from ..common.parse_size import parse_size
from ..common.token_verifier import make_token_verifier_from_flag
from ..device import resolve_device
from ..rpc import make_rpc_server
from ..utils import exposed_vars
from ..utils.gctune import LatencyGcGuard
from ..utils.inspect_server import InspectServer
from ..utils.logging import get_logger
from .host_policy import POLICY_NAMES, make_policy
from .replication import (JournalStreamer, LeaseJournal,
                          ReplicatingDispatcher, StandbyMonitor,
                          StandbyScheduler)
from .service import SchedulerService
from .shard_router import ShardRouter
from .task_dispatcher import TaskDispatcher

logger = get_logger("scheduler.entry")


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("yadcc-tpu-torch-scheduler")
    p.add_argument("--port", type=int, default=8336)
    p.add_argument("--inspect-port", type=int, default=9336)
    p.add_argument("--inspect-credential", default="")
    p.add_argument("--dispatch-policy", default="auto",
                   choices=list(POLICY_NAMES),
                   help="auto = host greedy for small backlogs, the "
                        "grouped kernel above a crossover measured at "
                        "startup; torch_batched = the exact sequential "
                        "scan; torch_resident_grouped = the grouped "
                        "kernel on a device-resident pool (pipelined)")
    p.add_argument("--max-servants", type=int, default=8192)
    p.add_argument("--rpc-frontend", default="threaded",
                   choices=["threaded", "aio"],
                   help="serving front end: 'threaded' = the gRPC "
                        "thread-pool server, 'aio' = the event-loop "
                        "server — WaitForStartingTask long-polls park as "
                        "continuations instead of worker threads; "
                        "delegates then dial aio://host:port")
    p.add_argument("--accept-loops", type=int, default=1,
                   help="aio front end only: shard the accept path "
                        "across N SO_REUSEPORT event loops; 1 = a single "
                        "loop")
    p.add_argument("--shards", type=int, default=1,
                   help="scheduler control-plane shards: N>1 partitions "
                        "the servant pool over N dispatchers routed by "
                        "consistent hash, with cross-shard work stealing; "
                        "--max-servants is the WHOLE fleet's pool, split "
                        "per shard")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the grouped assignment runs; 'cuda' "
                        "requires a card")
    p.add_argument("--min-daemon-version", type=int, default=0)
    p.add_argument("--acceptable-user-tokens", default="")
    p.add_argument("--acceptable-servant-tokens", default="")
    p.add_argument("--servant-min-memory-for-new-task",
                   default="10G")
    p.add_argument("--token-rollout-interval", type=float, default=3600.0,
                   help="serving-daemon token rotation period, seconds "
                        "(reference --serving_daemon_token_rollout_interval)")
    p.add_argument("--allow-self-dispatch", action="store_true",
                   help="let a machine compile its own submissions via "
                        "the network path (single-machine rigs/tests; "
                        "normally wasteful, hence off)")
    p.add_argument("--dispatch-pipeline-depth", default="auto",
                   help="in-flight policy launches (device-resident "
                        "running chain).  'auto' = 16 on the card, 0 "
                        "(synchronous) on the CPU; an integer forces a "
                        "depth")
    p.add_argument("--replicate-to", default="",
                   help="warm-standby replication: stream the lease "
                        "journal to this standby URI; on our death the "
                        "standby replays it and takes over within one "
                        "keep-alive interval")
    p.add_argument("--standby", action="store_true",
                   help="boot as the warm standby: refuse scheduler "
                        "RPCs fast (REJECT verdict / NOT_SERVING + "
                        "retry-after), apply the active's journal "
                        "stream, and take over when it falls silent; "
                        "the dispatch policy is warmed at BOOT so "
                        "takeover replays into a ready dispatcher")
    p.add_argument("--standby-takeover-silence", type=float, default=1.0,
                   help="seconds of journal-stream silence before the "
                        "standby declares the active dead")
    p.add_argument("--replication-token", default="",
                   help="shared secret on the journal stream (empty = "
                        "unauthenticated, test rigs only)")
    return p


def resolve_pipeline_depth(flag: str, policy, device) -> int:
    """'auto' = pipeline on the card (where a synchronous policy round
    trip is the cycle bottleneck), synchronous on the CPU; integers
    force.  Policies without the stream API always run synchronously."""
    if not getattr(policy, "supports_stream", False):
        return 0
    if flag != "auto":
        return max(0, int(flag))
    return 16 if device.type == "cuda" else 0


def sharded_registry_size(max_servants: int, n_shards: int) -> int:
    """Per-shard registry/pool size for the sharded control plane: the
    ceil-split of the fleet plus headroom (+25%, join slack, rounded up
    to 256 slots).  Consistent-hash routing is not an even split — the
    ring's measured max/min key share is ~1.14x — so a registry sized to
    the exact split overflows whenever a shard draws its expected
    above-mean share, and keep-alives fail with "servant registry full"
    while the fleet still fits --max-servants."""
    from ..parallel.mesh import control_plane_shard_slices

    slices = control_plane_shard_slices(max_servants, n_shards)
    base = max(hi - lo for lo, hi in slices)
    return max(256, (base * 10 // 8 + 64 + 255) // 256 * 256)


def _host_only(args) -> bool:
    """greedy_cpu on --device cpu: the host path, which loads no torch."""
    return args.dispatch_policy == "greedy_cpu" and args.device == "cpu"


def _policy_device(args):
    """The policies' device: the card unless --device cpu; None on the
    host path, where no policy reads it."""
    return None if _host_only(args) else resolve_device(args.device)


def _load_device_path(args) -> None:
    """Import the device policies, and with them torch, unless on the host
    path.  Called before the lock-order tracer is installed, so torch's
    import-time locks stay real ones (a traced lock has no
    ``_at_fork_reinit``, which ``concurrent.futures`` asks of its locks)."""
    if not _host_only(args):
        from . import policy  # noqa: F401


def build_dispatcher(args):
    """Policy selection + warmup + dispatcher construction, shared by the
    active path and the standby's boot (the "warm" in warm standby: the
    takeover replays into a dispatcher whose kernels are already built and
    launched once).  The policies' kernels are built and run once for the
    serving shapes BEFORE the server accepts requests.  With --shards N >
    1: N policies (each shard owns its policy and its CUDA stream; device
    kernels are not shared across dispatch threads) behind a
    ShardRouter."""
    device = _policy_device(args)
    n = args.shards
    if n < 1:
        raise ValueError(f"--shards must be >= 1, got {n}")
    width = (sharded_registry_size(args.max_servants, n) if n > 1
             else args.max_servants)
    policies = [make_policy(args.dispatch_policy,
                            avoid_self=not args.allow_self_dispatch,
                            device=device, max_servants=width)
                for _ in range(n)]
    depth = resolve_pipeline_depth(args.dispatch_pipeline_depth,
                                   policies[0], device)
    for policy in policies:
        if depth > 0:
            policy.stream_warmup(width)
        else:
            policy.warmup(width)
    kwargs = dict(min_memory_for_new_task=parse_size(
                      args.servant_min_memory_for_new_task),
                  pipeline_depth=depth)
    if n > 1:
        return ShardRouter.build(lambda k: policies[k], n,
                                 max_servants_per_shard=width, **kwargs)
    return TaskDispatcher(policies[0], max_servants=width, **kwargs)


def build_service(dispatcher, args) -> SchedulerService:
    return SchedulerService(
        dispatcher,
        user_tokens=make_token_verifier_from_flag(
            args.acceptable_user_tokens),
        servant_tokens=make_token_verifier_from_flag(
            args.acceptable_servant_tokens),
        min_daemon_version=args.min_daemon_version,
        token_rotation_s=args.token_rollout_interval,
    )


def _reset_kernel_counts(args) -> None:
    """Count the launches made while serving, not the warmup's.  The
    host path launches nothing and loads no kernel module: its counts
    stay 0."""
    if _host_only(args):
        exposed_vars.expose("yadcc/kernels", lambda: {
            "grouped_assign": {"launches": 0},
            "assign_batch": {"launches": 0}})
        return
    from ..ops import cuda_assign, cuda_grouped

    cuda_grouped.launches = 0
    cuda_assign.launches = 0
    exposed_vars.expose("yadcc/kernels", lambda: {
        "grouped_assign": {"launches": cuda_grouped.launches},
        "assign_batch": {"launches": cuda_assign.launches}})


def _serve(args, services, stop, gc_guard: bool, tick) -> int:
    """Mount ``services`` on the RPC port (``--rpc-frontend``) and the
    inspect endpoint, then run ``tick()`` once a second until ``stop`` is
    set (SIGINT/SIGTERM when None) or ``tick`` returns False (a
    dispatcher failure: rc 1)."""
    # The heap is built (policy warmed, dispatcher constructed): freeze it
    # and take the automatic cyclic collector off the grant path; the
    # sweep below collects the young generations instead.
    guard = LatencyGcGuard() if gc_guard else None
    if guard is not None:
        guard.start()
    server = make_rpc_server(args.rpc_frontend, f"0.0.0.0:{args.port}",
                             accept_loops=args.accept_loops)
    for spec in services:
        server.add_service(spec)
    server.start()
    # The aio front end's serving stats, `double_replies` among them.
    if hasattr(server, "inspect"):
        exposed_vars.expose("yadcc/rpc_server", server.inspect)
    # On aio the inspect port serves on the RPC server's loop.
    inspect = InspectServer(
        args.inspect_port, args.inspect_credential,
        frontend=args.rpc_frontend,
        loops=server.loops if args.rpc_frontend == "aio" else None)
    inspect.start()
    logger.info("%s on :%d (policy=%s, device=%s, shards=%d, frontend=%s), "
                "inspect on :%d",
                "standby" if args.standby else "scheduler serving",
                server.port, args.dispatch_policy, args.device, args.shards,
                args.rpc_frontend, inspect.port)
    if stop is None:
        stop = threading.Event()
        for sig in (signal.SIGINT, signal.SIGTERM):
            signal.signal(sig, lambda *_: stop.set())
    rc = 0
    # 1s expiration sweep (reference task_dispatcher.cc:498-536).
    while not stop.wait(1.0):
        if not tick():
            rc = 1
            break
        if guard is not None:
            guard.maintain()
    logger.info("shutting down")
    if guard is not None:
        guard.stop()
        exposed_vars.unexpose("yadcc/gc_guard")
    inspect.stop()  # before the server whose loop it may share
    server.stop()
    exposed_vars.unexpose("yadcc/rpc_server")
    return rc


def _sweep(dispatcher) -> bool:
    """One expiration sweep; False once the dispatcher has failed."""
    if dispatcher.failure is not None:
        logger.error("dispatcher failed (%r); shutting down",
                     dispatcher.failure)
        return False
    dispatcher.on_expiration_timer()
    return True


def scheduler_standby_start(args, stop: "threading.Event | None" = None,
                            gc_guard: bool = True) -> int:
    """The warm-standby role: build and warm the dispatcher on the card
    NOW, mount the replication receiver and the refusing gate, and
    promote when the journal stream falls silent.  ``yadcc/standby``
    exposes the last journal sequence applied and, once promoted, the
    takeover's report.  Returns the exit code, as scheduler_start does; a
    takeover that raises ends the process with 1."""
    from ..utils.locktrace import install_from_env

    _load_device_path(args)
    install_from_env()  # YTPU_LOCKTRACE=1: lock-order checking tier
    dispatcher = build_dispatcher(args)  # warmed NOW, replayed at takeover
    _reset_kernel_counts(args)
    standby = StandbyScheduler(token=args.replication_token)
    promoted, failed = threading.Event(), threading.Event()
    state = {"promoted": False, "report": None, "promoted_at": None}
    exposed_vars.expose("yadcc/standby", lambda: dict(
        state, journal_seq=standby.receiver.state_seq()))

    def promoted_service(d) -> SchedulerService:
        service = build_service(d, args)
        exposed_vars.expose("yadcc/scheduler_rpc",
                            service.stage_timer.percentiles)
        return service

    def on_dead():
        try:
            report = standby.takeover(lambda: dispatcher,
                                      service_factory=promoted_service)
        except BaseException:
            failed.set()
            raise
        exposed_vars.expose("yadcc/task_dispatcher", dispatcher.inspect)
        state.update(promoted=True, report=report, promoted_at=time.time())
        logger.info("promoted to active: %s", report)
        promoted.set()

    monitor = StandbyMonitor(standby.receiver, on_dead,
                             silence_s=args.standby_takeover_silence)
    monitor.start()

    def tick() -> bool:
        if failed.is_set():
            logger.error("takeover failed; shutting down")
            return False
        if dispatcher.failure is not None or promoted.is_set():
            return _sweep(dispatcher)
        return True

    try:
        return _serve(args, [standby.receiver.spec(), standby.gate.spec()],
                      stop, gc_guard, tick)
    finally:
        monitor.stop()
        dispatcher.stop()
        for name in ("yadcc/standby", "yadcc/task_dispatcher",
                     "yadcc/scheduler_rpc", "yadcc/kernels"):
            exposed_vars.unexpose(name)


def scheduler_start(args, stop: "threading.Event | None" = None,
                    gc_guard: bool = True) -> int:
    """Serve until ``stop`` is set (SIGINT/SIGTERM when run as a program)
    or the dispatcher fails.  Returns the process exit code: 0 after a
    clean stop, 1 after a dispatcher failure.  ``gc_guard=False`` builds
    no guard and leaves the process's cyclic collector as it is (a caller
    that embeds the server in a process it does not own).  With
    ``--standby`` the process is a warm standby
    (scheduler_standby_start); with ``--replicate-to`` every lease
    mutation is journaled at the call boundary and shipped there."""
    from ..utils.locktrace import install_from_env

    if args.standby:
        return scheduler_standby_start(args, stop, gc_guard)
    _load_device_path(args)
    install_from_env()  # YTPU_LOCKTRACE=1: lock-order checking tier
    dispatcher = build_dispatcher(args)
    _reset_kernel_counts(args)
    streamer = None
    if args.replicate_to:
        journal = LeaseJournal()
        dispatcher = ReplicatingDispatcher(dispatcher, journal)
        streamer = JournalStreamer(journal, args.replicate_to,
                                   token=args.replication_token)
        streamer.start()
        logger.info("replicating lease journal to %s", args.replicate_to)
    service = build_service(dispatcher, args)
    exposed_vars.expose("yadcc/task_dispatcher", dispatcher.inspect)
    exposed_vars.expose("yadcc/scheduler_rpc",
                        service.stage_timer.percentiles)
    try:
        return _serve(args, [service.spec()], stop, gc_guard,
                      lambda: _sweep(dispatcher))
    finally:
        if streamer is not None:
            streamer.stop()
        dispatcher.stop()
        for name in ("yadcc/task_dispatcher", "yadcc/scheduler_rpc",
                     "yadcc/kernels"):
            exposed_vars.unexpose(name)


def main() -> None:
    sys.exit(scheduler_start(build_arg_parser().parse_args()))


if __name__ == "__main__":
    main()
