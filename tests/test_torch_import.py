"""The port stands alone: yadcc_tpu_torch imports no jax, nothing of the
JAX package and no `xxhash` wheel (and runs without the `zstandard` one),
and its entry points refuse to run without a card unless the caller asks
for the CPU."""

from __future__ import annotations

import json
import os
import pathlib
import re
import subprocess
import sys
import textwrap

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
PKG = REPO / "yadcc_tpu_torch"

_FORBIDDEN = re.compile(
    r"^\s*(?:import|from)\s+(?:jax|jaxlib|yadcc_tpu|xxhash)(?:\.|\s|$)",
    re.M)
# The Bloom slice's modules, each imported by name below.
_BLOOM_MODULES = (
    "common.bloom", "common.xxh64_np", "ops.xxh64_torch", "ops.bloom_probe",
    "ops.bloom_pipeline", "ops.cuda_bloom", "cache.bloom_filter_generator",
    "tools.bloom_bench")
# The sharded, multi-tenant scheduler's modules, each imported by name.
_SHARD_MODULES = (
    "common.hashing", "common.backoff", "common.consistent_hash",
    "tenancy", "tenancy.identity", "tenancy.tiers", "tenancy.budgets",
    "parallel.mesh", "scheduler.shard_router", "ops.team_exchange")
# Replication, standby, federation and scored placement, each by name.
_REPLICATION_MODULES = (
    "rpc.transport", "scheduler.replication", "scheduler.placement",
    "scheduler.federation", "scheduler.entry")
# The aio front end and the parked wait, each by name.
_AIO_MODULES = ("rpc.aio_server", "utils.looplag", "rpc.grpc_transport",
                "scheduler.service", "scheduler.task_dispatcher")
# The cache server and the daemon's cache client, each by name.
_CACHE_MODULES = (
    "api.gen.cache_pb2", "common._zlib_frames", "common.compress",
    "common.disk_cache", "tenancy.keys", "cache.cache_engine",
    "cache.in_memory_cache", "cache.disk_engine", "cache.object_store_engine",
    "cache.service", "cache.entry", "daemon", "daemon.local", "daemon.cloud",
    "daemon.cloud.distributed_cache_writer",
    "daemon.local.distributed_cache_reader")
# The servant half of the daemon and its entry, each imported by name.
_SERVANT_MODULES = (
    "api.gen.daemon_pb2", "api.gen.extra_info_pb2", "api.gen.patch_pb2",
    "version", "common.limits", "common.multi_chunk",
    "common.cacheability", "daemon.task_digest", "daemon.cache_format",
    "daemon.packing", "daemon.config", "daemon.sysinfo", "daemon.temp_dir",
    "daemon.privilege", "daemon.cloud.execute_command",
    "daemon.cloud.temporary", "daemon.cloud.compiler_registry",
    "daemon.cloud.execution_engine", "daemon.cloud.cxx_task",
    "daemon.cloud.daemon_service", "daemon.entry")
# The delegate half of the daemon, each imported by name.
_DELEGATE_MODULES = (
    "api.gen.local_pb2", "daemon.local.distributed_task",
    "daemon.local.cxx_task", "daemon.local.file_digest_cache",
    "daemon.local.task_registry", "daemon.local.fair_admission",
    "daemon.local.task_grant_keeper", "daemon.local.config_keeper",
    "daemon.local.running_task_keeper", "daemon.local.local_task_monitor",
    "daemon.local.distributed_task_dispatcher", "daemon.local.http_service")
# The in-process rig: it runs the scheduler, so it loads torch.
_RIG_MODULES = ("testing", "testing.local_cluster")
# The compiler-masquerading client and the inspect server, each by name.
_CLIENT_MODULES = (
    "client", "client.env_options", "client.logging", "client.command",
    "client.compiler_args", "client.daemon_call", "client.task_quota",
    "client.rewrite_file", "client.compilation_saas", "client.yadcc_cxx",
    "client.universal_wrapper", "utils.inspect_server")
# The S3 engine, the trace prefetcher and the scheduler's scale harnesses.
_SCALE_MODULES = ("cache.s3_backend", "cache.prefetcher",
                  "tools.trace_replay", "tools.pod_sim")
# Lock-order tracing, the interleaving explorer and the cluster sweep;
# the federated rig, the hostile-world matrix, the front-end and data
# plane benches and the client installer.
_TOOL_MODULES = ("utils.locktrace", "testing.interleave",
                 "tools.cluster_sim", "testing.federated_cluster",
                 "tools.scenarios", "tools.rpc_frontend_bench",
                 "tools._dataplane_legacy", "tools.dataplane_bench",
                 "tools.install_client")
# The static analyzer, the proto builder and the scheduler's torch-free
# host modules, each by name.
_ANALYSIS_MODULES = (
    "analysis", "analysis.__main__", "analysis.core", "analysis.minitoml",
    "analysis.cache", "analysis.sarif", "analysis.lockrules",
    "analysis.device_sync", "analysis.jit_hygiene", "analysis.taint",
    "analysis.lifecycle", "analysis.replproto", "analysis.asyncproto",
    "analysis.wirecompat", "api.build_protos", "ops.greedy",
    "ops.bloom_pack", "scheduler.host_policy", "scheduler.placement_host",
    "scheduler.routed")
# The jit, AOT and autotune workloads, each by name; none loads torch.
_JIT_MODULES = (
    "api.gen.jit_pb2", "api.gen.fanout_pb2", "jit", "jit.env",
    "jit.fanout", "jit.compile_worker", "jit.frontend", "jit.aot",
    "jit.autotune", "jit.cache_shim", "daemon.cloud.jit_task",
    "daemon.cloud.aot_task", "daemon.cloud.autotune_task",
    "daemon.local.jit_task", "daemon.local.aot_task",
    "daemon.local.autotune_task")


def _port_sources():
    return sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py",
                                        REPO / "chip_k1_ab.py",
                                        REPO / "chip_k2_probe.py",
                                        REPO / "chip_bloom_probe.py",
                                        REPO / "chip_cache_probe.py",
                                        REPO / "chip_scale_probe.py",
                                        REPO / "chip_overlap_probe.py"]


def test_sources_import_no_jax_and_no_jax_package():
    offenders = []
    for path in _port_sources():
        for m in _FORBIDDEN.finditer(path.read_text()):
            offenders.append(f"{path.relative_to(REPO)}: {m.group(0).strip()}")
    assert not offenders, offenders


def test_every_module_imports_with_jax_and_jax_package_blocked():
    script = textwrap.dedent(r"""
        import importlib, importlib.abc, pkgutil, sys

        class Refuse(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path=None, target=None):
                if name in ("jax", "jaxlib", "xxhash", "zstandard") \
                        or name == "yadcc_tpu" \
                        or name.startswith(("jax.", "jaxlib.", "yadcc_tpu.",
                                            "xxhash.", "zstandard.")):
                    raise ImportError(f"blocked import of {name}")
                return None

        sys.modules["jax"] = None
        sys.modules["xxhash"] = None
        sys.modules["zstandard"] = None
        sys.meta_path.insert(0, Refuse())
        import yadcc_tpu_torch
        names = ["yadcc_tpu_torch"]
        for info in pkgutil.walk_packages(yadcc_tpu_torch.__path__,
                                          "yadcc_tpu_torch."):
            names.append(info.name)
        for name in names:
            importlib.import_module(name)
        for name in ("yadcc_tpu_torch.ops.cuda_assign",
                     "yadcc_tpu_torch.scheduler.device_pool") + tuple(
                "yadcc_tpu_torch." + m
                for m in BLOOM + SHARD + REPL + AIO + CACHE + SERVANT
                + DELEGATE + RIG + CLIENT + SCALE + JIT + TOOLS
                + ANALYSIS):
            assert name in names, name
            importlib.import_module(name)
        import chip_bloom_probe, chip_cache_probe  # noqa: F401
        import chip_scale_probe, chip_overlap_probe  # noqa: F401
        import chip_k1_ab, chip_k2_probe  # noqa: F401
        import chip_smoke  # noqa: F401
        leaked = sorted(n for n in sys.modules
                        if n == "yadcc_tpu" or n.startswith("yadcc_tpu.")
                        or (n.startswith(("jax", "xxhash", "zstandard"))
                            and sys.modules[n]))
        assert not leaked, leaked
        from yadcc_tpu_torch.common import compress
        assert compress.zstandard is None
        assert compress.decompress(compress.compress(b"x" * 99)) == b"x" * 99
        from yadcc_tpu_torch.rpc import (Channel, FailoverChannel,
                                         make_rpc_server)
        from yadcc_tpu_torch.rpc.aio_server import AioChannel
        assert type(Channel("aio://127.0.0.1:1")) is AioChannel
        assert type(Channel("mock://a,mock://b")) is FailoverChannel
        assert callable(make_rpc_server)
        print(len(names))
    """)
    script = (f"BLOOM = {_BLOOM_MODULES!r}\n"
              f"SHARD = {_SHARD_MODULES!r}\n"
              f"REPL = {_REPLICATION_MODULES!r}\n"
              f"AIO = {_AIO_MODULES!r}\n"
              f"CACHE = {_CACHE_MODULES!r}\n"
              f"SERVANT = {_SERVANT_MODULES!r}\n"
              f"DELEGATE = {_DELEGATE_MODULES!r}\n"
              f"RIG = {_RIG_MODULES!r}\n"
              f"CLIENT = {_CLIENT_MODULES!r}\n"
              f"SCALE = {_SCALE_MODULES!r}\n"
              f"JIT = {_JIT_MODULES!r}\n"
              f"TOOLS = {_TOOL_MODULES!r}\n"
              f"ANALYSIS = {_ANALYSIS_MODULES!r}\n" + script)
    out = subprocess.run([sys.executable, "-c", script], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert int(out.stdout.strip().splitlines()[-1]) >= 50


def test_cache_entry_loads_no_torch():
    """The cache server runs nothing on the card: its entry and service,
    its S3 engine and its trace prefetcher (with the key-trace half of
    the replay tool) load no torch (only the daemon's reader and the card
    replicas do)."""
    script = ("import sys, yadcc_tpu_torch.cache.entry, "
              "yadcc_tpu_torch.daemon.cloud.distributed_cache_writer, "
              "yadcc_tpu_torch.cache.s3_backend, "
              "yadcc_tpu_torch.cache.prefetcher, "
              "yadcc_tpu_torch.tools.trace_replay, "
              "yadcc_tpu_torch.tools.pod_sim; "
              "assert 'torch' not in sys.modules; print('ok')")
    out = subprocess.run([sys.executable, "-c", script], cwd=REPO,
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr[-2000:]


def test_daemon_entry_loads_no_torch(tmp_path, monkeypatch):
    """Neither role of the daemon runs anything on the card: the entry's
    --help and every module of both halves run with torch and jax
    blocked, and the reader constructs without either.  Then the entry
    as a program, both roles, against a scheduler stub: a client's TU
    goes in over loopback HTTP, through the delegate (grant, queue,
    wait, free) to its own servant and back, and the process maps no
    torch; on the threaded front end, then on aio, where the quota and
    the wait long polls are parked routes and the inspect port is the
    aio server too."""
    script = textwrap.dedent(r"""
        import importlib, runpy, sys
        for name in ("torch", "jax", "jaxlib"):
            sys.modules[name] = None
        for m in SERVANT + DELEGATE + CLIENT:
            importlib.import_module("yadcc_tpu_torch." + m)
        from yadcc_tpu_torch.daemon.local.distributed_cache_reader import \
            DistributedCacheReader
        DistributedCacheReader("grpc://127.0.0.1:1", "user")
        sys.argv = ["yadcc_tpu_torch.daemon.entry", "--help"]
        try:
            runpy.run_module("yadcc_tpu_torch.daemon.entry",
                             run_name="__main__")
        except SystemExit as e:
            assert e.code == 0, e.code
        assert not any(n.startswith(("torch.", "yadcc_tpu."))
                       for n in sys.modules), "torch or the JAX package"
    """)
    out = subprocess.run(
        [sys.executable, "-c", f"SERVANT = {_SERVANT_MODULES!r}\n"
         f"DELEGATE = {_DELEGATE_MODULES!r}\n"
         f"CLIENT = {_CLIENT_MODULES!r}\n" + script],
        cwd=REPO, capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr[-3000:]
    for flag in ("--scheduler-uri", "--local-port", "--max-local-tasks",
                 "--lightweight-ratio", "--debugging-always-use-servant-at"):
        assert flag in out.stdout, flag
    # As a program: `python -m yadcc_tpu_torch.daemon.entry --help`,
    # with every import it makes listed by -X importtime.
    out = subprocess.run(
        [sys.executable, "-X", "importtime", "-m",
         "yadcc_tpu_torch.daemon.entry", "--help"],
        cwd=REPO, capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "--rpc-frontend" in out.stdout
    imported = {line.rsplit("|", 1)[-1].strip()
                for line in out.stderr.splitlines()
                if line.startswith("import time:")}
    assert {"yadcc_tpu_torch.daemon.cloud.daemon_service",
            "yadcc_tpu_torch.daemon.local.http_service"} <= imported
    assert not {n for n in imported
                if n.split(".")[0] in ("torch", "jax", "yadcc_tpu")}
    for frontend in ("threaded", "aio"):
        _entry_serves_a_tu_over_http(tmp_path, monkeypatch, frontend)


def test_jit_clients_and_worker_load_no_torch(tmp_path):
    """The jit clients, the cache shim and the build worker run with
    torch, jax and the JAX package blocked: every jit module imports, and
    the worker as a program (fake mode) builds a request."""
    script = textwrap.dedent(r"""
        import importlib, json, os, subprocess, sys
        for name in ("torch", "jax", "jaxlib", "yadcc_tpu"):
            sys.modules[name] = None
        for m in JIT:
            importlib.import_module("yadcc_tpu_torch." + m)
        from yadcc_tpu_torch.common.multi_chunk import make_multi_chunk
        ws = sys.argv[1]
        with open(os.path.join(ws, "request.bin"), "wb") as f:
            f.write(make_multi_chunk([json.dumps({"backend": "cuda"}).encode(),
                                      b"int x;"]))
        sys.argv = ["w", "--workspace", ws, "--fake"]
        import runpy
        try:
            runpy.run_module("yadcc_tpu_torch.jit.compile_worker",
                             run_name="__main__")
        except SystemExit as e:
            assert e.code == 0, e.code
        assert open(os.path.join(ws, "artifact.bin"), "rb").read(
            ).startswith(b"FAKEXLA1")
        assert not any(n == "torch" or n.startswith(("torch.", "jax",
                                                     "yadcc_tpu."))
                       for n in sys.modules if sys.modules[n] is not None)
        print("ok")
    """)
    out = subprocess.run(
        [sys.executable, "-c", f"JIT = {_JIT_MODULES!r}\n" + script,
         str(tmp_path)], cwd=REPO, capture_output=True, text=True,
        timeout=60)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("ok")


def test_daemon_entry_serves_jit_with_nvcc_and_no_torch(tmp_path,
                                                        monkeypatch):
    """The entry with --jit-backends cuda and a stub nvcc first on PATH:
    its heartbeat advertises the cuda environment of the stub's release
    line, a jit build through its delegate runs the worker in real mode
    on its own servant (nvcc's argv is _build.NVCC_FLAGS), and the
    process maps no torch.  Without nvcc, --jit-backends cuda refuses to
    start."""
    import signal
    import socket
    import time

    import yadcc_tpu_torch.api as tapi
    import yadcc_tpu_torch.rpc as trpc
    from yadcc_tpu_torch.client import daemon_call
    from yadcc_tpu_torch.jit import frontend
    from yadcc_tpu_torch.jit.env import jit_env_digest
    from yadcc_tpu_torch.ops import _build

    from .test_torch_jit_offload import STUB_NVCC, STUB_RELEASE

    bindir = tmp_path / "stubbin"
    bindir.mkdir()
    (bindir / "nvcc").write_text(STUB_NVCC)
    (bindir / "nvcc").chmod(0o755)
    log = tmp_path / "nvcc.log"
    env = dict(os.environ, PATH=f"{bindir}{os.pathsep}{os.environ['PATH']}",
               STUB_NVCC_LOG=str(log), CUDA_HOME=str(tmp_path / "none"))
    S = tapi.scheduler
    seen = {"beats": [], "grants": 0}

    def wait_for_starting_task(req, att, ctx):
        if not seen["beats"]:
            return S.WaitForStartingTaskResponse()
        seen["grants"] += 1
        resp = S.WaitForStartingTaskResponse()
        for i in range(req.immediate_reqs + req.prefetch_reqs):
            resp.grants.add(task_grant_id=100 * seen["grants"] + i,
                            servant_location=seen["beats"][-1].location)
        return resp

    sched = trpc.ServiceSpec("ytpu.SchedulerService")
    sched.add("Heartbeat", S.HeartbeatRequest, lambda req, att, ctx: (
        seen["beats"].append(req),
        S.HeartbeatResponse(acceptable_tokens=["dtok"]))[1])
    sched.add("GetConfig", S.GetConfigRequest, lambda req, att, ctx:
              S.GetConfigResponse(serving_daemon_token="dtok"))
    sched.add("GetRunningTasks", S.GetRunningTasksRequest,
              lambda req, att, ctx: S.GetRunningTasksResponse())
    sched.add("WaitForStartingTask", S.WaitForStartingTaskRequest,
              wait_for_starting_task)
    sched.add("KeepTaskAlive", S.KeepTaskAliveRequest, lambda req, att, ctx:
              S.KeepTaskAliveResponse(
                  statuses=[True] * len(req.task_grant_ids)))
    sched.add("FreeTask", S.FreeTaskRequest,
              lambda req, att, ctx: S.FreeTaskResponse())
    server = trpc.make_rpc_server("threaded", "127.0.0.1:0")
    server.add_service(sched)
    server.start()
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        local_port = s.getsockname()[1]
    argv = [sys.executable, "-m", "yadcc_tpu_torch.daemon.entry",
            "--scheduler-uri", f"grpc://127.0.0.1:{server.port}",
            "--token", "stok", "--local-port", str(local_port),
            "--serving-port", "0", "--inspect-port", "0",
            "--max-remote-tasks", "2",
            "--temporary-dir", str(tmp_path / "shm"),
            "--jit-backends", "cuda", "--allow-poor-machine",
            "--ignore-cgroup-limits", "--no-privilege-drop"]
    proc = subprocess.Popen(argv, cwd=REPO, env=env,
                            stdout=subprocess.DEVNULL,
                            stderr=subprocess.PIPE)
    try:
        deadline = time.monotonic() + 30
        while not seen["beats"]:
            assert proc.poll() is None, proc.stderr.read().decode()[-2000:]
            assert time.monotonic() < deadline, "the entry never beat"
            time.sleep(0.05)
        digest = jit_env_digest("cuda", STUB_RELEASE)
        assert digest in [e.compiler_digest
                          for e in seen["beats"][-1].env_descs]
        monkeypatch.setenv("YTPU_DAEMON_PORT", str(local_port))
        monkeypatch.setenv("YTPU_JIT_OFFLOAD", "1")
        daemon_call.set_daemon_call_handler(None)
        src = b'extern "C" int entry_probe(void) { return 3; }\n'
        out = frontend.offload_compile(src, toolchain_version=STUB_RELEASE,
                                       cache_control=0, timeout_s=60)
        assert out.ok and out.exit_code == 0, out.error
        assert out.library == b"STUBLIB" + src
        assert out.output.startswith("built ")
        (run,) = [json.loads(line) for line in open(log)]
        assert tuple(run["argv"][:-3]) == _build.NVCC_FLAGS
        assert run["tmpdir"].startswith(str(tmp_path / "shm"))
        with open(f"/proc/{proc.pid}/maps") as f:
            assert "libtorch" not in f.read()
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        proc.stderr.close()
        server.stop(grace=0)
        daemon_call._drop_conn()
    if not os.path.exists("/usr/local/cuda/bin/nvcc"):
        out = subprocess.run(argv, cwd=REPO, capture_output=True, text=True,
                             timeout=60, env=dict(
                                 os.environ, PATH=os.defpath,
                                 CUDA_HOME=str(tmp_path / "none")))
        assert out.returncode != 0
        assert "--jit-backends cuda: nvcc not found" in out.stderr


def test_daemon_entry_with_locktrace_loads_no_torch(tmp_path, monkeypatch):
    """YTPU_LOCKTRACE=1 hooks lock-order tracing into the daemon entry
    (utils/locktrace.py imports no torch): the entry serves a TU as
    before, maps no libtorch, and /inspect/vars shows yadcc/locktrace
    with no violation."""
    monkeypatch.setenv("YTPU_LOCKTRACE", "1")
    _entry_serves_a_tu_over_http(tmp_path, monkeypatch, "aio",
                                 locktrace=True)


def test_cache_entry_with_locktrace_loads_no_torch(tmp_path):
    """The cache entry with YTPU_LOCKTRACE=1 as a program: a put and a
    get go through, /inspect/vars shows yadcc/locktrace with no
    violation, the process maps no libtorch and exits 0 on SIGTERM
    without a locktrace report."""
    import json
    import os
    import signal
    import socket
    import time
    import urllib.request

    import yadcc_tpu_torch.api as tapi
    import yadcc_tpu_torch.rpc as trpc

    ports = []
    for _ in range(2):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            ports.append(s.getsockname()[1])
    port, iport = ports
    proc = subprocess.Popen(
        [sys.executable, "-m", "yadcc_tpu_torch.cache.entry",
         "--port", str(port), "--inspect-port", str(iport),
         "--cache-engine", "disk", "--cache-dirs", str(tmp_path / "l2"),
         "--acceptable-user-tokens", "user",
         "--acceptable-servant-tokens", "servant"],
        cwd=REPO, env=dict(os.environ, YTPU_LOCKTRACE="1"),
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
    chan = None
    try:
        deadline = time.monotonic() + 30
        while True:
            assert proc.poll() is None, proc.stderr.read()[-2000:]
            assert time.monotonic() < deadline, "the entry never came up"
            try:
                socket.create_connection(("127.0.0.1", port), 1).close()
                break
            except OSError:
                time.sleep(0.05)
        chan = trpc.Channel(f"grpc://127.0.0.1:{port}")
        key, value = "ytpu-cxx2-entry-" + "ab" * 32, b"v" * 4096
        chan.call("ytpu.CacheService", "PutEntry",
                  tapi.cache.PutEntryRequest(token="servant", key=key),
                  tapi.cache.PutEntryResponse, attachment=value,
                  timeout=10.0)
        _, got = chan.call("ytpu.CacheService", "TryGetEntry",
                           tapi.cache.TryGetEntryRequest(token="user",
                                                         key=key),
                           tapi.cache.TryGetEntryResponse, timeout=5.0)
        assert bytes(got) == value
        with urllib.request.urlopen(
                f"http://127.0.0.1:{iport}/inspect/vars/yadcc/locktrace",
                timeout=10) as r:
            trace = json.loads(r.read())["yadcc"]["locktrace"]
        assert trace["violations"] == [] and not trace["saturated"]
        with open(f"/proc/{proc.pid}/maps") as f:
            assert "libtorch" not in f.read()
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
        assert "locktrace:" not in proc.stderr.read()
    finally:
        if chan is not None:
            chan.close()
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        proc.stderr.close()


def _entry_serves_a_tu_over_http(tmp_path, monkeypatch, frontend,
                                 locktrace=False):
    import json
    import os
    import signal
    import urllib.request
    import socket
    import time

    from yadcc_tpu.client import compilation_saas, daemon_call
    import yadcc_tpu_torch.api as tapi
    import yadcc_tpu_torch.rpc as trpc
    from yadcc_tpu_torch.common import compress
    from yadcc_tpu_torch.common.hashing import digest_bytes

    toolchain = REPO / "tests" / "testdata" / "toolchains" / "bin"
    S = tapi.scheduler
    seen = {"beats": [], "freed": [], "grants": 0}

    def heartbeat(req, att, ctx):
        seen["beats"].append(req)
        return S.HeartbeatResponse(acceptable_tokens=["dtok"])

    def wait_for_starting_task(req, att, ctx):
        if not seen["beats"]:
            return S.WaitForStartingTaskResponse()
        seen["grants"] += 1
        resp = S.WaitForStartingTaskResponse()
        for i in range(req.immediate_reqs + req.prefetch_reqs):
            resp.grants.add(task_grant_id=100 * seen["grants"] + i,
                            servant_location=seen["beats"][-1].location)
        return resp

    def free(req, att, ctx):
        seen["freed"].extend(req.task_grant_ids)
        return S.FreeTaskResponse()

    sched = trpc.ServiceSpec("ytpu.SchedulerService")
    sched.add("Heartbeat", S.HeartbeatRequest, heartbeat)
    sched.add("GetConfig", S.GetConfigRequest, lambda req, att, ctx:
              S.GetConfigResponse(serving_daemon_token="dtok"))
    sched.add("GetRunningTasks", S.GetRunningTasksRequest,
              lambda req, att, ctx: S.GetRunningTasksResponse())
    sched.add("WaitForStartingTask", S.WaitForStartingTaskRequest,
              wait_for_starting_task)
    sched.add("KeepTaskAlive", S.KeepTaskAliveRequest, lambda req, att, ctx:
              S.KeepTaskAliveResponse(
                  statuses=[True] * len(req.task_grant_ids)))
    sched.add("FreeTask", S.FreeTaskRequest, free)
    server = trpc.make_rpc_server("threaded", "127.0.0.1:0")
    server.add_service(sched)
    server.start()
    ports = []
    for _ in range(2):
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            ports.append(s.getsockname()[1])
    local_port, inspect_port = ports
    proc = subprocess.Popen(
        [sys.executable, "-m", "yadcc_tpu_torch.daemon.entry",
         "--scheduler-uri", f"grpc://127.0.0.1:{server.port}",
         "--token", "stok", "--local-port", str(local_port),
         "--serving-port", "0", "--inspect-port", str(inspect_port),
         "--extra-compiler-dirs", str(toolchain), "--max-remote-tasks", "2",
         "--max-local-tasks", "3",
         "--temporary-dir", str(tmp_path / f"shm-{frontend}"),
         "--rpc-frontend", frontend,
         "--allow-poor-machine", "--ignore-cgroup-limits",
         "--no-privilege-drop"],
        cwd=REPO, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
    try:
        deadline = time.monotonic() + 30
        while True:
            assert proc.poll() is None, proc.stderr.read().decode()[-2000:]
            assert time.monotonic() < deadline, "the entry never came up"
            try:
                with socket.create_connection(("127.0.0.1", local_port),
                                              timeout=1):
                    pass
                if seen["beats"]:
                    break
            except OSError:
                pass
            time.sleep(0.05)
        monkeypatch.setenv("YTPU_DAEMON_PORT", str(local_port))
        daemon_call.set_daemon_call_handler(None)
        src = b"int served(int x) { return x + 2; }\n"
        tid = compilation_saas.submit_compilation_task(
            compiler_path=str(toolchain / "g++"), source_path="/src/e.cc",
            source_digest=digest_bytes(src),
            compressed_source=compress.compress(src),
            invocation_arguments="-O2", cache_control=1)
        result, _ = compilation_saas.wait_for_compilation_task(
            tid, timeout_s=60)
        assert result.exit_code == 0, result.standard_error
        assert set(result.files) == {".o", ".gcno"}
        assert seen["grants"] >= 1
        for path in ("acquire_quota", "release_quota"):
            r = daemon_call.call_daemon("POST", f"/local/{path}", json.dumps(
                {"requestor_pid": os.getpid(), "lightweight_task": True,
                 "milliseconds_to_wait": 1000}).encode())
            assert r.status == 200, (path, r.status)
        with urllib.request.urlopen(
                f"http://127.0.0.1:{inspect_port}/inspect/vars",
                timeout=10) as resp:
            yadcc = json.loads(resp.read())["yadcc"]
        daemon = yadcc["daemon"]
        assert ("locktrace" in yadcc) == locktrace
        if locktrace:
            assert yadcc["locktrace"]["violations"] == []
            assert yadcc["locktrace"]["edges"] > 0
        assert daemon["local_http"]["frontend"] == frontend
        if frontend == "aio":
            assert daemon["local_http"]["double_replies"] == 0
            assert daemon["servant_rpc"]["double_replies"] == 0
        with open(f"/proc/{proc.pid}/maps") as f:
            maps = f.read()
        assert "libtorch" not in maps
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
        # The grant it ran on, and the one it prefetched, went back.
        assert {100, 101} <= set(seen["freed"]), seen["freed"]
        assert seen["beats"][-1].next_heartbeat_in_ms == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        proc.stderr.close()
        server.stop(grace=0)
        daemon_call._drop_conn()


def test_client_loads_no_torch(tmp_path):
    """The compiler wrapper runs once a TU, so it must not load torch: a
    client process with torch, jax and the JAX package blocked compiles
    one TU through a port daemon (the in-process rig, a fake compiler
    that preprocesses), and `-X importtime` lists none of them."""
    from tests.test_torch_client import FAKE_GXX
    from yadcc_tpu_torch.daemon.cloud.cxx_task import shutdown_pack_executor
    from yadcc_tpu_torch.testing import LocalCluster

    fake = tmp_path / "fake" / "tc"
    fake.mkdir(parents=True)
    (fake / "g++").write_text(FAKE_GXX)
    (fake / "g++").chmod(0o755)
    (tmp_path / "rig").mkdir()
    rig = LocalCluster(tmp_path / "rig", device="cpu",
                       compiler_dirs=[str(fake)], http_frontend="aio")
    try:
        (tmp_path / "a.cc").write_text("int a(int x) { return x; }\n")
        script = textwrap.dedent(r"""
            import runpy, sys
            for name in ("torch", "jax", "jaxlib", "yadcc_tpu"):
                sys.modules[name] = None
            sys.argv = ["yadcc_cxx.py", "g++", "-O2", "-c", "a.cc",
                        "-o", "a.o"]
            runpy.run_module("yadcc_tpu_torch.client.yadcc_cxx",
                             run_name="__main__")
        """)
        env = dict(os.environ, PYTHONPATH=str(REPO),
                   PATH=str(fake) + os.pathsep + os.environ["PATH"],
                   YTPU_DAEMON_PORT=str(rig.http.port),
                   YTPU_COMPILE_ON_CLOUD_SIZE_THRESHOLD="1")
        out = subprocess.run(
            [sys.executable, "-X", "importtime", "-c", script],
            cwd=tmp_path, env=env, capture_output=True, text=True,
            timeout=60)
        assert out.returncode == 0, out.stderr[-2000:]
        assert (tmp_path / "a.o").read_bytes() == \
            b"FAKEOBJ\nint a(int x) { return x; }\n"
        assert rig.delegate.inspect()["stats"]["actually_run"] == 1
        imported = {line.rsplit("|", 1)[-1].strip()
                    for line in out.stderr.splitlines()
                    if line.startswith("import time:")}
        assert "yadcc_tpu_torch.client.compilation_saas" in imported
        assert not {n for n in imported if n.split(".")[0] in
                    ("torch", "jax", "jaxlib", "yadcc_tpu", "numpy")}
    finally:
        rig.stop()
        shutdown_pack_executor()


def test_resolve_device_refuses_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from yadcc_tpu_torch.device import resolve_device

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("mps")


def test_entry_defaults_to_the_card_and_refuses_without_one():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from yadcc_tpu_torch.scheduler import entry

    args = entry.build_arg_parser().parse_args([])
    assert args.device == "cuda"
    assert args.dispatch_policy == "auto"
    assert args.max_servants == 8192
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        entry.build_dispatcher(args)


def test_wrapper_routes_cpu_tensors_to_the_plain_version():
    """A CPU pool takes the plain version; the launch counter counts
    kernel launches only."""
    import numpy as np

    from yadcc_tpu_torch.ops import assignment as asn
    from yadcc_tpu_torch.ops import assignment_grouped as asg
    from yadcc_tpu_torch.ops import cuda_grouped as kg

    s = 64
    pool = asn.pool_from_numpy(
        np.ones(s, bool), np.full(s, 4, np.int32), np.zeros(s, np.int32),
        np.zeros(s, bool), np.ones(s, np.int32),
        np.full((s, 8), 0xFFFFFFFF, np.uint32), "cpu")
    batch = asg.make_grouped_batch([(3, 1, -1, 10)], pad_to=4)
    before = kg.launches
    counts, running = kg.cuda_assign_grouped(pool, batch)
    want_c, want_r = asg.assign_grouped(pool, batch)
    assert kg.launches == before
    assert torch.equal(counts, want_c) and torch.equal(running, want_r)
    assert int(counts.sum()) == 10


# Each host-only tool as a program, with torch, jax and the JAX package
# blocked: a tool that drives only host programs loads no torch.
_HOST_TOOL_RUNS = {
    "scenarios_noisy_neighbor": (
        "yadcc_tpu_torch.tools.scenarios",
        ["--scenario", "noisy-neighbor", "--policy", "greedy_cpu",
         "--device", "cpu", "--smoke"], '"all_slo_ok": true'),
    "rpc_frontend_parity": (
        "yadcc_tpu_torch.tools.rpc_frontend_bench", ["--parity-smoke"],
        '"parity_smoke": "ok"'),
    "dataplane_smoke": (
        "yadcc_tpu_torch.tools.dataplane_bench", ["--smoke"],
        "dataplane parity OK"),
    "install_client_python": (
        "yadcc_tpu_torch.tools.install_client",
        ["--python-client", "{tmp}/pyfarm"], "python client wrappers"),
    "install_client_native": (
        "yadcc_tpu_torch.tools.install_client", ["{tmp}/farm"],
        "quota wrappers"),
}


@pytest.mark.parametrize("run", sorted(_HOST_TOOL_RUNS))
def test_host_tool_loads_no_torch(run, tmp_path):
    module, argv, want = _HOST_TOOL_RUNS[run]
    argv = [a.format(tmp=tmp_path) for a in argv]
    script = textwrap.dedent(f"""
        import runpy, sys
        for name in ("torch", "jax", "jaxlib", "yadcc_tpu"):
            sys.modules[name] = None
        sys.argv = [{module!r}] + {argv!r}
        try:
            runpy.run_module({module!r}, run_name="__main__")
        except SystemExit as e:
            assert not e.code, e.code
        loaded = sorted(n for n in sys.modules if sys.modules[n] is not None
                        and n.split(".")[0] in ("torch", "jax", "yadcc_tpu"))
        assert not loaded, loaded
        print("NO_TORCH_OK")
    """)
    out = subprocess.run([sys.executable, "-c", script], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=str(REPO)),
                         capture_output=True, text=True, timeout=180)
    assert out.returncode == 0, out.stderr[-3000:]
    assert want in out.stdout and "NO_TORCH_OK" in out.stdout


def test_federated_rig_runs_without_jax_on_the_cpu():
    """The federated rig runs the port's scheduler on its host path: with
    torch, jax and the JAX package blocked it boots two cells and a
    standby on greedy_cpu, promotes the standby after a kill, and loads
    none of them."""
    script = textwrap.dedent(r"""
        import sys
        for name in ("torch", "jax", "jaxlib", "yadcc_tpu"):
            sys.modules[name] = None
        from yadcc_tpu_torch.testing import FederatedCluster
        rig = FederatedCluster(2, policy="greedy_cpu", device="cpu",
                               heartbeat_ms=300)
        try:
            rig.arm_monitor(silence_s=0.3)
            rig.kill_active()
            assert rig.wait_promoted(15.0)
            assert type(rig.standby.dispatcher._policy).__name__ ==                 "GreedyCpuPolicy"
        finally:
            rig.stop()
        assert not any(n.startswith(("torch", "jax", "yadcc_tpu."))
                       for n in sys.modules if sys.modules[n] is not None)
        print("RIG_OK")
    """)
    out = subprocess.run([sys.executable, "-c", script], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "RIG_OK" in out.stdout


_HOST_PATH_PRELUDE = r"""
import os, pathlib, subprocess, sys, threading, time
for name in ("torch", "jax", "jaxlib", "yadcc_tpu"):
    sys.modules[name] = None


def loaded_forbidden():
    return sorted(n for n in sys.modules if sys.modules[n] is not None
                  and n.split(".")[0] in ("torch", "jax", "jaxlib",
                                          "yadcc_tpu"))
"""


def _run_host_path(script: str, *args, timeout: float = 120):
    out = subprocess.run(
        [sys.executable, "-c", _HOST_PATH_PRELUDE + textwrap.dedent(script),
         *args], cwd=REPO, capture_output=True, text=True, timeout=timeout)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def test_local_rig_on_greedy_cpu_runs_without_torch(tmp_path):
    """The local rig on greedy_cpu (its default policy) with torch, jax
    and the JAX package blocked: a TU goes from the port's client through
    the delegate, the scheduler and a servant, and none of them loads."""
    from tests.test_torch_client import FAKE_GXX

    fake = tmp_path / "fake"
    fake.mkdir()
    (fake / "g++").write_text(FAKE_GXX)
    (fake / "g++").chmod(0o755)
    (tmp_path / "rig").mkdir()
    (tmp_path / "a.cc").write_text("int a(int x) { return x; }\n")
    out = _run_host_path(r"""
        from yadcc_tpu_torch.daemon.cloud.cxx_task import \
            shutdown_pack_executor
        from yadcc_tpu_torch.testing import LocalCluster

        tmp, fake = pathlib.Path(sys.argv[1]), sys.argv[2]
        rig = LocalCluster(tmp / "rig", device="cpu", compiler_dirs=[fake])
        try:
            assert type(rig.sched_dispatcher._policy).__name__ == \
                "GreedyCpuPolicy"
            env = dict(os.environ, PYTHONPATH=os.getcwd(),
                       PATH=fake + os.pathsep + os.environ["PATH"],
                       YTPU_DAEMON_PORT=str(rig.http.port),
                       YTPU_COMPILE_ON_CLOUD_SIZE_THRESHOLD="1")
            run = subprocess.run(
                [sys.executable, "-m", "yadcc_tpu_torch.client.yadcc_cxx",
                 "g++", "-O2", "-c", "a.cc", "-o", "a.o"], cwd=tmp, env=env,
                capture_output=True, text=True, timeout=60)
            assert run.returncode == 0, run.stderr[-2000:]
            assert rig.delegate.inspect()["stats"]["actually_run"] == 1
        finally:
            rig.stop()
            shutdown_pack_executor()
        assert not loaded_forbidden(), loaded_forbidden()
        print("LOCAL_OK")
    """, str(tmp_path), str(fake))
    assert "LOCAL_OK" in out
    assert (tmp_path / "a.o").read_bytes() == \
        b"FAKEOBJ\nint a(int x) { return x; }\n"


def test_scheduler_entry_on_greedy_cpu_runs_without_torch():
    """The scheduler entry with --device cpu --dispatch-policy greedy_cpu
    serves a heartbeat and a grant, and stops, with torch, jax and the
    JAX package blocked; its kernel counters read 0."""
    out = _run_host_path(r"""
        from yadcc_tpu_torch import api
        from yadcc_tpu_torch.rpc import Channel, RpcError
        from yadcc_tpu_torch.scheduler import entry
        from yadcc_tpu_torch.scheduler.service import SERVICE_NAME
        from yadcc_tpu_torch.utils import exposed_vars

        import socket
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        args = entry.build_arg_parser().parse_args([
            "--port", str(port), "--inspect-port", "0", "--device", "cpu",
            "--dispatch-policy", "greedy_cpu", "--max-servants", "64",
            "--acceptable-user-tokens", "utok",
            "--acceptable-servant-tokens", "stok", "--allow-self-dispatch"])
        stop = threading.Event()
        rc = []
        server = threading.Thread(target=lambda: rc.append(
            entry.scheduler_start(args, stop, gc_guard=False)), daemon=True)
        server.start()
        ch = Channel(f"grpc://127.0.0.1:{port}")
        sch = api.scheduler
        try:
            deadline = time.monotonic() + 30
            while True:
                try:
                    ch.call(SERVICE_NAME, "GetConfig",
                            sch.GetConfigRequest(token="utok"),
                            sch.GetConfigResponse, timeout=1.0)
                    break
                except RpcError:
                    assert time.monotonic() < deadline, "entry never served"
                    time.sleep(0.05)
            hb = sch.HeartbeatRequest(
                token="stok", next_heartbeat_in_ms=1000,
                location="127.0.0.1:20001", version=1, num_processors=8,
                capacity=4, total_memory_in_bytes=64 << 30,
                memory_available_in_bytes=64 << 30)
            hb.env_descs.add(compiler_digest="gcc-12")
            ch.call(SERVICE_NAME, "Heartbeat", hb, sch.HeartbeatResponse,
                    timeout=5.0)
            wreq = sch.WaitForStartingTaskRequest(
                token="utok", milliseconds_to_wait=2000, immediate_reqs=2,
                next_keep_alive_in_ms=10_000)
            wreq.env_desc.compiler_digest = "gcc-12"
            wresp, _ = ch.call(SERVICE_NAME, "WaitForStartingTask", wreq,
                               sch.WaitForStartingTaskResponse, timeout=10.0)
            ids = [g.task_grant_id for g in wresp.grants]
            assert len(set(ids)) == 2, ids
            ch.call(SERVICE_NAME, "FreeTask",
                    sch.FreeTaskRequest(token="utok", task_grant_ids=ids),
                    sch.FreeTaskResponse, timeout=5.0)
            kernels = exposed_vars.collect("yadcc/kernels")["yadcc"]["kernels"]
        finally:
            stop.set()
            server.join(timeout=30)
        assert rc == [0], rc
        assert kernels == {"grouped_assign": {"launches": 0},
                           "assign_batch": {"launches": 0}}, kernels
        assert not loaded_forbidden(), loaded_forbidden()
        print("ENTRY_OK")
    """)
    assert "ENTRY_OK" in out


def test_analyzer_and_build_protos_run_with_torch_and_jax_blocked():
    """The port's analyzer (over the api tree: the wire checks and every
    per-file family; the whole package's self-check is
    tests/test_torch_analysis.py's) and build_protos --check run with
    torch, jax and the JAX package blocked."""
    out = _run_host_path(r"""
        from yadcc_tpu_torch.analysis.__main__ import main
        from yadcc_tpu_torch.api import build_protos

        assert main(["yadcc_tpu_torch/api", "--no-cache"]) == 0
        assert build_protos.check_pure() == 0
        assert not loaded_forbidden(), loaded_forbidden()
        print("ANALYSIS_OK")
    """)
    assert "ANALYSIS_OK" in out
    assert "0 finding(s)" in out


def test_device_policies_still_load_torch_on_demand():
    """make_policy builds the device policies (and with them torch) only
    when asked for one; the names stay importable from policy.py."""
    from yadcc_tpu_torch.scheduler import host_policy, policy

    assert policy.make_policy is host_policy.make_policy
    assert policy.GreedyCpuPolicy is host_policy.GreedyCpuPolicy
    for name, cls in (("torch_grouped", policy.TorchGroupedPolicy),
                      ("torch_batched", policy.TorchBatchedPolicy),
                      ("torch_resident_grouped",
                       policy.TorchResidentGroupedPolicy),
                      ("auto", policy.AutoPolicy)):
        assert type(host_policy.make_policy(name, device="cpu")) is cls
    with pytest.raises(ValueError):
        host_policy.make_policy("jax_grouped")

