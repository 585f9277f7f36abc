"""Cache server main (a copy of the JAX package's yadcc_tpu/cache/entry.py).

Parity with reference yadcc/cache/entry.cc (port 8337, 128MB packet cap
enforced in the service).  The cache server runs nothing on the card: its
Bloom filters are host filters that daemons replicate and probe on theirs
(daemon/local/distributed_cache_reader.py), so the entry takes no
``--device``.  Run:

    python -m yadcc_tpu_torch.cache.entry --cache-engine disk \\
        --cache-dirs /var/cache/ytpu1,/var/cache/ytpu2

or over an S3-compatible bucket for both the L2 and the shared L3:

    python -m yadcc_tpu_torch.cache.entry --cache-engine s3 \\
        --l3-engine s3 --s3-endpoint HOST:PORT --s3-bucket BUCKET
"""

from __future__ import annotations

import argparse
import os
import signal
import threading
import time

from ..common.parse_size import parse_size
from ..common.token_verifier import make_token_verifier_from_flag
from ..rpc import make_rpc_server
from ..utils import exposed_vars
from ..utils.inspect_server import InspectServer
from ..utils.logging import get_logger
from . import disk_engine, object_store_engine  # noqa: F401 (register)
from .cache_engine import make_engine
from .in_memory_cache import InMemoryCache
from .service import CacheService

logger = get_logger("cache.entry")

# Timer periods of the serving loop (reference
# cache_service_impl.cc:172-180 runs the two independently).
_REBUILD_S = 60.0
_PURGE_S = 60.0


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("yadcc-tpu-torch-cache")
    p.add_argument("--port", type=int, default=8337)
    p.add_argument("--inspect-port", type=int, default=9337)
    p.add_argument("--inspect-credential", default="")
    p.add_argument("--cache-engine", default="null",
                   choices=["disk", "null", "objstore", "s3"])
    p.add_argument("--cache-dirs", default="",
                   help="comma-separated shard dirs (disk) or root (objstore)")
    # S3-compatible engine (reference cos_cache_engine.cc:38-51 exposes
    # the same shape: credentials, bucket, dir prefix, capacity).
    # Credentials come from flags or YTPU_S3_ACCESS_KEY/YTPU_S3_SECRET_KEY
    # so they need not appear on the command line.
    p.add_argument("--s3-endpoint", default="", help="host:port")
    p.add_argument("--s3-bucket", default="")
    p.add_argument("--s3-prefix", default="ytpu-cache/")
    p.add_argument("--s3-region", default="us-east-1")
    p.add_argument("--s3-access-key", default="")
    p.add_argument("--s3-secret-key", default="")
    p.add_argument("--s3-tls", action="store_true")
    p.add_argument("--l2-capacity", default="64G")
    p.add_argument("--misplaced-entry-action", default="move",
                   choices=["move", "delete", "ignore"],
                   help="startup policy for disk entries found in the "
                        "wrong shard after a topology change (reference "
                        "--disk_engine_action_on_misplaced_cache_entry)")
    p.add_argument("--l1-capacity", default="4G")
    p.add_argument("--l1-ttl", type=float, default=4 * 3600.0,
                   help="idle seconds before the 1-min purge timer "
                        "expires an L1 entry (0 disables expiry)")
    # Shared L3 tier: a bucket this regional server reads through to
    # and writes back into, shared with peer regions.  "s3" reuses the
    # --s3-* connection flags with its own prefix so one object store can
    # host both tiers.
    p.add_argument("--l3-engine", default="none",
                   choices=["none", "objstore", "s3"],
                   help="shared L3 object-store tier (none = two-level "
                        "server)")
    p.add_argument("--l3-root", default="",
                   help="objstore L3: shared bucket root directory")
    p.add_argument("--l3-capacity", default="1T")
    p.add_argument("--l3-s3-prefix", default="ytpu-l3/")
    p.add_argument("--l3-workers", type=int, default=2,
                   help="background pool threads for async L3 "
                        "promotions and write-backs")
    p.add_argument("--acceptable-user-tokens", default="")
    p.add_argument("--acceptable-servant-tokens", default="")
    p.add_argument("--rpc-frontend", default="threaded",
                   choices=["threaded", "aio"],
                   help="serving front end: grpc thread pool or the "
                        "event-loop server (clients then dial "
                        "aio://host:port)")
    p.add_argument("--accept-loops", type=int, default=1,
                   help="aio front end only: shard the accept path "
                        "across N SO_REUSEPORT event loops; "
                        "1 = single loop")
    return p


def _s3_engine(args, prefix: str, capacity: str):
    return make_engine(
        "s3",
        endpoint=args.s3_endpoint,
        bucket=args.s3_bucket,
        prefix=prefix,
        region=args.s3_region,
        access_key=args.s3_access_key
        or os.environ.get("YTPU_S3_ACCESS_KEY", ""),
        secret_key=args.s3_secret_key
        or os.environ.get("YTPU_S3_SECRET_KEY", ""),
        use_tls=args.s3_tls,
        capacity=parse_size(capacity),
    )


def build_service(args) -> CacheService:
    if args.cache_engine == "disk":
        l2 = make_engine("disk", dirs=args.cache_dirs,
                         capacity=parse_size(args.l2_capacity),
                         on_misplaced=args.misplaced_entry_action)
    elif args.cache_engine == "objstore":
        l2 = make_engine("objstore", root=args.cache_dirs,
                         capacity=parse_size(args.l2_capacity))
    elif args.cache_engine == "s3":
        l2 = _s3_engine(args, args.s3_prefix, args.l2_capacity)
    else:
        l2 = make_engine("null")
    l3 = None
    if args.l3_engine == "objstore":
        l3 = make_engine("objstore", root=args.l3_root,
                         capacity=parse_size(args.l3_capacity))
    elif args.l3_engine == "s3":
        l3 = _s3_engine(args, args.l3_s3_prefix, args.l3_capacity)
    return CacheService(
        InMemoryCache(parse_size(args.l1_capacity)),
        l2,
        l3=l3,
        l3_workers=args.l3_workers,
        l1_ttl_s=args.l1_ttl or float("inf"),
        user_tokens=make_token_verifier_from_flag(
            args.acceptable_user_tokens),
        servant_tokens=make_token_verifier_from_flag(
            args.acceptable_servant_tokens),
    )


def cache_server_start(args, stop: "threading.Event | None" = None) -> None:
    """Serve until ``stop`` is set (SIGINT/SIGTERM when None), then drain
    the L3 pool and close the engines."""
    from ..utils.locktrace import install_from_env

    install_from_env()  # YTPU_LOCKTRACE=1: lock-order checking tier
    service = build_service(args)
    exposed_vars.expose("yadcc/cache", service.inspect)

    server = make_rpc_server(args.rpc_frontend, f"0.0.0.0:{args.port}",
                             max_workers=32,
                             accept_loops=args.accept_loops)
    server.add_service(service.spec())
    server.start()
    # aio front-end serving stats, `double_replies` among them.
    if hasattr(server, "inspect"):
        exposed_vars.expose("yadcc/rpc_server", server.inspect)
    # On aio the inspect port serves on the RPC server's loop.
    inspect = InspectServer(
        args.inspect_port, args.inspect_credential,
        frontend=args.rpc_frontend,
        loops=server.loops if args.rpc_frontend == "aio" else None)
    inspect.start()
    logger.info("cache server on :%d (engine=%s, l3=%s, frontend=%s), "
                "inspect on :%d", server.port, service.l2.name,
                args.l3_engine, args.rpc_frontend, inspect.port)

    if stop is None:
        stop = threading.Event()
        for sig in (signal.SIGINT, signal.SIGTERM):
            signal.signal(sig, lambda *_: stop.set())
    last_rebuild = last_purge = time.monotonic()
    while not stop.wait(1.0):
        if time.monotonic() - last_rebuild >= _REBUILD_S:
            service.rebuild_bloom_filter()
            last_rebuild = time.monotonic()
        if time.monotonic() - last_purge >= _PURGE_S:
            service.purge()
            last_purge = time.monotonic()
    logger.info("shutting down")
    inspect.stop()  # before the server whose loop it may share
    server.stop()
    exposed_vars.unexpose("yadcc/rpc_server")
    service.stop()  # drain the async L3 pool before the engines close
    exposed_vars.unexpose("yadcc/cache")
    service.l2.stop()
    if service.l3 is not None:
        service.l3.stop()


def main() -> None:
    cache_server_start(build_arg_parser().parse_args())


if __name__ == "__main__":
    main()
