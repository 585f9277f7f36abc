"""Boot a full cluster in one process, on ephemeral loopback ports (a copy
of the JAX package's yadcc_tpu/testing/local_cluster.py, trimmed to what
the port's tests and tools/cluster_sim.py drive: the C++ and jit
workloads (every servant serves an explicit jit environment), the
control-plane servers on either RPC front end (``rpc_frontend``,
``accept_loops``), the delegate's HTTP on either front end
(``http_frontend``), the disk L2, extra delegates
(``make_extra_delegate``), the scheduler's admission ladder
(``admission_config``) and the cache-restart chaos hook
(``restart_cache_server``, tools/scenarios.py)).

It boots the REAL services over real loopback RPC — the port's
scheduler (its policy on ``device``), cache server, N servant daemons,
one delegate with its loopback HTTP API — so integration tests exercise
the production wire path end to end.
"""

from __future__ import annotations

import pathlib
import stat
import time
from typing import List, Optional

from ..cache.disk_engine import DiskCacheEngine
from ..cache.in_memory_cache import InMemoryCache
from ..cache.service import CacheService
from ..common.disk_cache import ShardSpec
from ..daemon.cloud.compiler_registry import CompilerRegistry
from ..daemon.cloud.daemon_service import DaemonService
from ..daemon.cloud.distributed_cache_writer import DistributedCacheWriter
from ..daemon.cloud.execution_engine import ExecutionEngine
from ..daemon.config import DaemonConfig
from ..daemon.local.config_keeper import ConfigKeeper
from ..daemon.local.distributed_cache_reader import DistributedCacheReader
from ..daemon.local.distributed_task_dispatcher import \
    DistributedTaskDispatcher
from ..daemon.local.file_digest_cache import FileDigestCache
from ..daemon.local.http_service import LocalHttpService
from ..daemon.local.local_task_monitor import LocalTaskMonitor
from ..daemon.local.running_task_keeper import RunningTaskKeeper
from ..daemon.local.task_grant_keeper import TaskGrantKeeper
from ..daemon.sysinfo import LoadAverageSampler
from ..jit.env import JitEnvironment, local_jit_environment
from ..rpc import make_rpc_server
from ..scheduler.host_policy import make_policy
from ..scheduler.service import SchedulerService
from ..scheduler.task_dispatcher import TaskDispatcher

FAKE_COMPILER = """#!/bin/sh
# Fake g++ for the in-process cluster rig: parses -o, writes a
# deterministic object derived from the source bytes, exits 0
# ("-DFAIL" anywhere fails like a compile error).
{sleep}out=""; src=""; prev=""
for a in "$@"; do
  if [ "$prev" = "-o" ]; then out="$a"; fi
  if [ "$a" = "-DFAIL" ]; then echo "fake: error" >&2; exit 1; fi
  case "$a" in -*) ;; *) if [ "$prev" != "-x" ]; then src="$a"; fi;; esac
  prev="$a"
done
{ echo "FAKEOBJ"; cat "$src" 2>/dev/null; } > "$out"
"""


def make_fake_compiler(dir_path: str, compile_s: float = 0.0) -> str:
    """Install a fake `g++` into dir_path; returns its path.

    `compile_s` > 0 makes each "compile" take that long (lets tests
    exercise in-flight behavior: joins, keep-alives, saturation).
    dir_path must not contain any CompilerRegistry wrapper marker
    ("ccache", "distcc", "icecc", "ytpu", "yadcc") or the registry will
    rightly refuse to register the binary.
    """
    p = pathlib.Path(dir_path)
    p.mkdir(parents=True, exist_ok=True)
    gxx = p / "g++"
    sleep = f"sleep {compile_s}\n" if compile_s > 0 else ""
    gxx.write_text(FAKE_COMPILER.replace("{sleep}", sleep, 1))
    gxx.chmod(gxx.stat().st_mode | stat.S_IXUSR | stat.S_IXGRP)
    return str(gxx)


class _IdleSampler(LoadAverageSampler):
    """A rig servant's 'machine' reports zero foreign load."""

    def sample(self) -> None:
        pass

    def loadavg(self, n: int) -> int:
        return 0


class _Servant:
    def __init__(self, cluster: "LocalCluster", tmp: pathlib.Path,
                 index: int, max_concurrency: int,
                 compiler_dirs: List[str],
                 jit_environments: List[JitEnvironment]):
        self.server = make_rpc_server(cluster.rpc_frontend, "127.0.0.1:0",
                                      accept_loops=cluster.accept_loops)
        config = DaemonConfig(
            scheduler_uri=cluster.sched_uri,
            cache_server_uri=cluster.cache_uri,
            temporary_dir=str(tmp / f"shm{index}"),
            location=f"127.0.0.1:{self.server.port}",
            max_remote_tasks=max_concurrency,
        )
        (tmp / f"shm{index}").mkdir(exist_ok=True)
        self.registry = CompilerRegistry(extra_dirs=compiler_dirs)
        self.engine = ExecutionEngine(max_concurrency=max_concurrency,
                                      min_memory_for_new_task=1)
        # Same wiring as daemon/entry.py: cache fills authenticate with
        # the daemon's STATIC token, never the rotating serving-daemon
        # token.
        cache_writer = DistributedCacheWriter(cluster.cache_uri,
                                              lambda: "")
        # Synthetic machine: big enough to advertise `max_concurrency`
        # slots regardless of this host's real core count, and ALWAYS
        # idle — N rig servants share one real box, and each would
        # otherwise read the whole machine's load (the test workload
        # itself!) as its own foreign load.
        sampler = _IdleSampler(nprocs=max(4, max_concurrency * 3))
        self.service = DaemonService(
            config, engine=self.engine, registry=self.registry,
            cache_writer=cache_writer, sampler=sampler,
            allow_poor_machine=True, cgroup_present=False,
            # An explicit jit environment (YTPU_JIT_FAKE_WORKER=1 stands
            # the worker's nvcc down for control-plane tests).
            jit_environments=jit_environments)
        self.service.attach_frontend(self.server)
        self.server.add_service(self.service.spec())
        self.server.start()

    def start(self):
        self.service.start_heartbeat()

    def stop(self):
        self.service.stop_heartbeat(graceful_leave=False)
        self.server.stop(grace=0)
        self.engine.stop()


class LocalCluster:
    """scheduler + cache + n servant daemons + one delegate, all real
    services on real loopback ports inside this process."""

    def __init__(
        self,
        tmp: pathlib.Path,
        *,
        n_servants: int = 1,
        policy: str = "greedy_cpu",
        device: str = "cuda",
        servant_concurrency: int = 4,
        compiler_dirs: Optional[List[str]] = None,
        http_frontend: Optional[str] = None,
        admission_config=None,
        # "aio" boots every control-plane server (scheduler, cache,
        # servants) on the event-loop front end with aio:// dialing, and
        # the delegate's HTTP on the aio HTTP server unless
        # ``http_frontend`` says otherwise; ``accept_loops`` > 1 shards
        # each aio server's accept path (AioServerGroup).
        rpc_frontend: str = "threaded",
        accept_loops: int = 1,
        # What every servant serves; None = this host's cuda
        # environment (local_jit_environment()).
        jit_environments: Optional[List[JitEnvironment]] = None,
    ):
        self.rpc_frontend = "threaded" if rpc_frontend == "grpc" \
            else rpc_frontend
        self._scheme = scheme = \
            "aio" if self.rpc_frontend == "aio" else "grpc"
        self.accept_loops = accept_loops
        http_frontend = http_frontend or (
            "aio" if self.rpc_frontend == "aio" else "threaded")
        # Single-process rig: self-avoidance must be off, or the
        # requesting machine (ourselves) is never eligible.  A device
        # policy runs on ``device``.
        self.sched_dispatcher = TaskDispatcher(
            make_policy(policy, avoid_self=False, device=device),
            max_servants=max(16, n_servants), max_envs=64,
            batch_window_s=0.0, admission_config=admission_config)
        self.sched = SchedulerService(self.sched_dispatcher)
        self.sched_server = make_rpc_server(self.rpc_frontend,
                                            "127.0.0.1:0",
                                            accept_loops=accept_loops)
        self.sched_server.add_service(self.sched.spec())
        self.sched_server.start()
        self.sched_uri = f"{scheme}://127.0.0.1:{self.sched_server.port}"

        self.cache_service = CacheService(
            InMemoryCache(64 << 20),
            DiskCacheEngine([ShardSpec(str(tmp / "l2"), 1 << 30)]))
        self.cache_server = make_rpc_server(self.rpc_frontend,
                                            "127.0.0.1:0",
                                            accept_loops=accept_loops)
        self.cache_server.add_service(self.cache_service.spec())
        self.cache_server.start()
        self.cache_uri = f"{scheme}://127.0.0.1:{self.cache_server.port}"

        if jit_environments is None:
            jit_environments = [local_jit_environment()]
        self.servants = [
            _Servant(self, tmp, i, servant_concurrency,
                     compiler_dirs or [], jit_environments)
            for i in range(n_servants)
        ]

        self.config_keeper = ConfigKeeper(self.sched_uri, "")
        # The reader's batch would run on ``device``; the delegate reads
        # one key at a time (try_read) and never batches.
        self.cache_reader = DistributedCacheReader(self.cache_uri, "",
                                                   device=device)
        self.running_keeper = RunningTaskKeeper(self.sched_uri,
                                                refresh_interval_s=0.5)
        # The jit cache shim and the fan-out parents' fills, wired as
        # entry.py wires them: reads through the delegate's reader, puts
        # through a servant-role cache writer.
        self.shim_cache_writer = DistributedCacheWriter(self.cache_uri,
                                                        lambda: "")
        self.delegate = DistributedTaskDispatcher(
            grant_keeper=TaskGrantKeeper(self.sched_uri, ""),
            config_keeper=self.config_keeper,
            cache_reader=self.cache_reader,
            running_task_keeper=self.running_keeper,
            cache_writer=self.shim_cache_writer,
            servant_scheme=f"{scheme}://",
        )
        self.http = LocalHttpService(
            monitor=LocalTaskMonitor(nprocs=8, pid_prober=lambda p: True),
            digest_cache=FileDigestCache(),
            dispatcher=self.delegate,
            port=0,
            cache_reader=self.cache_reader,
            cache_writer=self.shim_cache_writer,
            frontend=http_frontend,
        )
        # Extra delegates (make_extra_delegate), stopped with the rig.
        self._extra: List = []
        self.config_keeper.start()
        self.cache_reader.start()
        self.running_keeper.start()
        for servant in self.servants:
            servant.start()
        self.http.start()
        # First heartbeats must land before grants can be issued.
        deadline = time.time() + 10
        while time.time() < deadline and len(
                self.sched_dispatcher.inspect()["servants"]) < n_servants:
            time.sleep(0.05)
        if len(self.sched_dispatcher.inspect()["servants"]) != n_servants:
            self.stop()
            raise RuntimeError("servants failed to register")

    def restart_cache_server(self, down_for_s: float = 0.0) -> None:
        """Chaos hook (tools/scenarios.py, cache-restart scenario):
        stop the cache server's listener, optionally stay dark, then
        serve the SAME engines again on the SAME port — a cache-server
        crash/upgrade mid-build.  Readers and writers are expected to
        ride it out: compiles proceed, hit rate drops, nothing errors
        to clients."""
        port = self.cache_server.port
        self.cache_server.stop(grace=0)
        if down_for_s > 0:
            time.sleep(down_for_s)
        self.cache_server = make_rpc_server(self.rpc_frontend,
                                            f"127.0.0.1:{port}",
                                            accept_loops=self.accept_loops)
        self.cache_server.add_service(self.cache_service.spec())
        self.cache_server.start()

    def make_extra_delegate(self) -> DistributedTaskDispatcher:
        """A second delegate, as another build machine runs one: its own
        grant keeper and running-task snapshot, sharing the cluster's
        services and this rig's cache reader.  stop() stops it."""
        keeper = RunningTaskKeeper(self.sched_uri, refresh_interval_s=0.5)
        keeper.start()
        delegate = DistributedTaskDispatcher(
            grant_keeper=TaskGrantKeeper(self.sched_uri, ""),
            config_keeper=self.config_keeper,
            cache_reader=self.cache_reader,
            running_task_keeper=keeper,
            cache_writer=self.shim_cache_writer,
            servant_scheme=f"{self._scheme}://",
        )
        self._extra.append((delegate, keeper))
        return delegate

    def stop(self):
        self.http.stop()
        self.delegate.stop()  # joins its fetchers and its task threads
        for delegate, keeper in self._extra:
            delegate.stop()  # the shared reader's stop is idempotent
            keeper.stop()
        self.running_keeper.stop()
        self.config_keeper.stop()
        self.cache_reader.stop()
        for servant in self.servants:
            servant.stop()
        for s in (self.cache_server, self.sched_server):
            s.stop(grace=0)
        self.cache_service.stop()
        self.sched_dispatcher.stop()
