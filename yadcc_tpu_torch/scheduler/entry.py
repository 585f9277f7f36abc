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
"""

from __future__ import annotations

import argparse
import signal
import sys
import threading

from ..common.parse_size import parse_size
from ..common.token_verifier import make_token_verifier_from_flag
from ..device import resolve_device
from ..ops import cuda_assign, cuda_grouped
from ..parallel.mesh import control_plane_shard_slices
from ..rpc import GrpcServer
from ..utils import exposed_vars
from ..utils.gctune import LatencyGcGuard
from ..utils.inspect_server import InspectServer
from ..utils.logging import get_logger
from .policy import POLICY_NAMES, make_policy
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
    slices = control_plane_shard_slices(max_servants, n_shards)
    base = max(hi - lo for lo, hi in slices)
    return max(256, (base * 10 // 8 + 64 + 255) // 256 * 256)


def build_dispatcher(args):
    """Policy selection + warmup + dispatcher construction.  The policies'
    kernels are built and run once for the serving shapes BEFORE the
    server accepts requests.  With --shards N > 1: N policies (each
    shard owns its policy and its CUDA stream; device kernels are not
    shared across dispatch threads) behind a ShardRouter."""
    device = resolve_device(args.device)
    n = args.shards
    if n < 1:
        raise ValueError(f"--shards must be >= 1, got {n}")
    width = (sharded_registry_size(args.max_servants, n) if n > 1
             else args.max_servants)
    policies = [make_policy(args.dispatch_policy,
                            avoid_self=not args.allow_self_dispatch,
                            device=device) for _ in range(n)]
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


def scheduler_start(args, stop: "threading.Event | None" = None,
                    gc_guard: bool = True) -> int:
    """Serve until ``stop`` is set (SIGINT/SIGTERM when run as a program)
    or the dispatcher fails.  Returns the process exit code: 0 after a
    clean stop, 1 after a dispatcher failure.  ``gc_guard=False`` builds
    no guard and leaves the process's cyclic collector as it is (a caller
    that embeds the server in a process it does not own)."""
    dispatcher = build_dispatcher(args)
    # Count the launches made while serving, not the warmup's.
    cuda_grouped.launches = 0
    cuda_assign.launches = 0
    service = build_service(dispatcher, args)
    exposed_vars.expose("yadcc/task_dispatcher", dispatcher.inspect)
    exposed_vars.expose("yadcc/kernels", lambda: {
        "grouped_assign": {"launches": cuda_grouped.launches},
        "assign_batch": {"launches": cuda_assign.launches}})
    exposed_vars.expose("yadcc/scheduler_rpc",
                        service.stage_timer.percentiles)

    # The heap is built (policy warmed, dispatcher constructed): freeze it
    # and take the automatic cyclic collector off the grant path; the
    # sweep below collects the young generations instead.
    guard = LatencyGcGuard() if gc_guard else None
    if guard is not None:
        guard.start()

    server = GrpcServer(f"0.0.0.0:{args.port}")
    server.add_service(service.spec())
    server.start()
    inspect = InspectServer(args.inspect_port, args.inspect_credential)
    inspect.start()
    logger.info("scheduler serving on :%d (policy=%s, device=%s, "
                "shards=%d), inspect on :%d", server.port,
                dispatcher.inspect()["policy"], args.device, args.shards,
                inspect.port)

    if stop is None:
        stop = threading.Event()
        for sig in (signal.SIGINT, signal.SIGTERM):
            signal.signal(sig, lambda *_: stop.set())
    rc = 0
    # 1s expiration sweep (reference task_dispatcher.cc:498-536).
    while not stop.wait(1.0):
        if dispatcher.failure is not None:
            logger.error("dispatcher failed (%r); shutting down",
                         dispatcher.failure)
            rc = 1
            break
        dispatcher.on_expiration_timer()
        if guard is not None:
            guard.maintain()
    logger.info("shutting down")
    if guard is not None:
        guard.stop()
        exposed_vars.unexpose("yadcc/gc_guard")
    server.stop()
    inspect.stop()
    dispatcher.stop()
    exposed_vars.unexpose("yadcc/task_dispatcher")
    exposed_vars.unexpose("yadcc/scheduler_rpc")
    exposed_vars.unexpose("yadcc/kernels")
    return rc


def main() -> None:
    sys.exit(scheduler_start(build_arg_parser().parse_args()))


if __name__ == "__main__":
    main()
