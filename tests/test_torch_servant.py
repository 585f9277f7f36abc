"""The port's servant held against the JAX package's.

Both packages' DaemonService run on the mock transport with the test
fake compiler (tests/testdata/toolchains/bin/g++, which embeds its
workspace path in its outputs) and take the same requests, made from a
numpy seed; their replies must be equal: task ids in order, status, exit
code, stdout and stderr, the files once both are patched to one client
directory, the patch locations, and the heartbeats they send.  Then: the
JAX package's cluster rig with a JAX servant and a port servant on
loopback, its delegate pinned to each; the port servant compiling with
the real g++ against a local compile; the aio front end's parked output
wait.  Every engine is stopped (process groups killed) and every pack
pool joined at teardown."""

from __future__ import annotations

import os
import pathlib
import shutil
import subprocess
import threading
import time

import numpy as np
import pytest

import yadcc_tpu.api as japi
import yadcc_tpu.daemon.cloud.cxx_task as jcxx
import yadcc_tpu.daemon.cloud.daemon_service as jsvc
import yadcc_tpu.rpc as jrpc
from yadcc_tpu.daemon.cloud.compiler_registry import \
    CompilerRegistry as JRegistry
from yadcc_tpu.daemon.cloud.execution_engine import \
    ExecutionEngine as JEngine
from yadcc_tpu.daemon.config import DaemonConfig as JConfig
import yadcc_tpu_torch.api as tapi
import yadcc_tpu_torch.daemon.cloud.cxx_task as tcxx
import yadcc_tpu_torch.daemon.cloud.daemon_service as tsvc
import yadcc_tpu_torch.rpc as trpc
from yadcc_tpu_torch.common import compress as tcompress
from yadcc_tpu_torch.common.hashing import digest_bytes, digest_file
from yadcc_tpu_torch.daemon import cache_format, packing
from yadcc_tpu_torch.daemon.cloud.compiler_registry import \
    CompilerRegistry as TRegistry
from yadcc_tpu_torch.daemon.cloud.execution_engine import \
    ExecutionEngine as TEngine
from yadcc_tpu_torch.daemon.config import DaemonConfig as TConfig

REPO = pathlib.Path(__file__).resolve().parent.parent
TOOLCHAIN = REPO / "tests" / "testdata" / "toolchains" / "bin"
CLIENT_DIR = "/home/user/project/build"
LOCATION = "127.0.0.1:8335"
PKGS = {
    "jax": (japi, jrpc, jsvc, JEngine, JRegistry, JConfig, jcxx),
    "port": (tapi, trpc, tsvc, TEngine, TRegistry, TConfig, tcxx),
}
D = tapi.daemon


class FixedSampler:
    """A machine of 32 processors with a foreign load of 3."""

    nprocs = 32

    def sample(self) -> None:
        pass

    def loadavg(self, seconds: int = 15) -> int:
        return 3


def join_pack_pools() -> None:
    tcxx.shutdown_pack_executor()
    pool = jcxx._PACK_EXECUTOR._pool
    jcxx._PACK_EXECUTOR._pool = None
    if pool is not None:
        pool.shutdown(wait=True)


def patch_files(files: dict, patches: dict, client_dir: str) -> dict:
    """The client's patch: each region replaced by ``client_dir`` + the
    suffix, NUL-padded to the region's length."""
    out = {}
    for ext, data in files.items():
        buf = bytearray(data)
        for pos, total, suffix in patches.get(ext, []):
            repl = client_dir.encode() + bytes(suffix)
            assert len(repl) <= total
            buf[pos:pos + total] = repl.ljust(total, b"\x00")
        out[ext] = bytes(buf)
    return out


class Pair:
    """Both packages' servants, their mock schedulers and their calls."""

    def __init__(self, tmp_path):
        self.servants = {}
        self.heartbeats = {name: [] for name in PKGS}
        self.sched_reply = {"tokens": ["tok"], "expired": []}
        for name, (api, rpc, svc_mod, Engine, Registry, Config, _) in \
                PKGS.items():
            (tmp_path / name).mkdir()
            config = Config(temporary_dir=str(tmp_path / name),
                            location=LOCATION, token="servant-token",
                            scheduler_uri=f"mock://sched-{name}")
            engine = Engine(max_concurrency=4, min_memory_for_new_task=1)
            kw = {"jit_environments": []} if name == "jax" else {}
            svc = svc_mod.DaemonService(
                config, engine=engine, registry=Registry(),
                sampler=FixedSampler(), allow_poor_machine=True,
                cgroup_present=False, **kw)
            svc.set_acceptable_tokens_for_testing(["tok"])
            rpc.register_mock_server(f"servant-{name}", svc.spec())
            sched = rpc.ServiceSpec("ytpu.SchedulerService")
            sched.add("Heartbeat", api.scheduler.HeartbeatRequest,
                      self._heartbeat_handler(name, api))
            rpc.register_mock_server(f"sched-{name}", sched)
            self.servants[name] = svc

    def _heartbeat_handler(self, name, api):
        def handle(req, attachment, ctx):
            self.heartbeats[name].append(req)
            return api.scheduler.HeartbeatResponse(
                acceptable_tokens=self.sched_reply["tokens"],
                expired_tasks=self.sched_reply["expired"])
        return handle

    def stop(self) -> None:
        for name, svc in self.servants.items():
            rpc = PKGS[name][1]
            rpc.unregister_mock_server(f"servant-{name}")
            rpc.unregister_mock_server(f"sched-{name}")
            svc.engine.stop()
        join_pack_pools()

    @property
    def compiler(self) -> str:
        envs = self.servants["port"].registry.environments()
        assert envs == self.servants["jax"].registry.environments()
        return envs[0]

    def call(self, method, req_name, resp_name, attachment=b"", **fields):
        """The same request to both servants: {package: (status, reply,
        attachment)}, status 0 on success."""
        out = {}
        for name, (api, rpc, *_rest) in PKGS.items():
            req = getattr(api.daemon, req_name)(**fields)
            try:
                resp, att = rpc.Channel(f"mock://servant-{name}").call(
                    "ytpu.DaemonService", method, req,
                    getattr(api.daemon, resp_name), attachment=attachment)
                out[name] = (0, resp, bytes(att))
            except PKGS[name][1].RpcError as e:
                out[name] = (e.status, None, b"")
        return out

    def queue(self, source: bytes, args: str, grant_id: int = 5,
              token: str = "tok", env: str = None, algo: int = 2,
              attachment: bytes = None) -> dict:
        env_desc = tapi.EnvironmentDesc(compiler_digest=env or self.compiler)
        got = self.call(
            "QueueCxxCompilationTask", "QueueCxxCompilationTaskRequest",
            "QueueCxxCompilationTaskResponse",
            attachment=(tcompress.compress(source) if attachment is None
                        else attachment),
            token=token, task_grant_id=grant_id, source_path="/src/tu.cc",
            invocation_arguments=args, compression_algorithm=algo,
            env_desc=env_desc)
        return {name: (status, resp.task_id if resp else None)
                for name, (status, resp, _) in got.items()}

    def wait(self, task_id: int, ms: int = 8000, token: str = "tok") -> dict:
        got = self.call(
            "WaitForCompilationOutput", "WaitForCompilationOutputRequest",
            "WaitForCompilationOutputResponse", token=token, task_id=task_id,
            milliseconds_to_wait=ms, acceptable_compression_algorithms=[2])
        return {name: normalise(status, resp, att)
                for name, (status, resp, att) in got.items()}

    def simple(self, method: str, task_id: int, token: str = "tok") -> dict:
        req, resp = {"ReferenceTask": ("ReferenceTaskRequest",
                                       "ReferenceTaskResponse"),
                     "FreeTask": ("FreeDaemonTaskRequest",
                                  "FreeDaemonTaskResponse")}[method]
        got = self.call(method, req, resp, token=token, task_id=task_id)
        return {name: status for name, (status, _, _) in got.items()}


def normalise(status, resp, att):
    """A wait reply as comparable values: the files decompressed and
    patched to one client directory."""
    if status:
        return ("error", status)
    if resp.status != D.COMPILATION_TASK_STATUS_DONE:
        return ("status", resp.status)
    patches = {p.file_key: [(loc.position, loc.total_size,
                             loc.suffix_to_keep) for loc in p.locations]
               for p in resp.cxx_info.patches}
    files = {k: tcompress.decompress(bytes(v)) for k, v in
             (packing.try_unpack_keyed_buffers(att) or {}).items()}
    return ("done", resp.exit_code, resp.standard_output,
            resp.standard_error, resp.compression_algorithm, patches,
            patch_files(files, patches, CLIENT_DIR))


@pytest.fixture
def pair(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(TOOLCHAIN))
    for mod in (jsvc, tsvc):
        monkeypatch.setattr(mod, "read_memory_available", lambda: 32 << 30)
        monkeypatch.setattr(mod, "read_memory_total", lambda: 64 << 30)
    p = Pair(tmp_path)
    yield p
    p.stop()


def both_equal(got: dict):
    assert got["port"] == got["jax"], got
    return got["port"]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_replies_equal_on_a_seeded_build(pair, seed):
    rng = np.random.default_rng(seed)
    flags = ["-O2", "-O0 -g", "-DFAIL", "-O2 -DX=1"]
    tasks = []
    for i in range(6):
        if i and rng.random() < 0.3:
            tasks.append(tasks[int(rng.integers(len(tasks)))])
            continue
        src = rng.integers(32, 127, int(rng.integers(10, 200)),
                           dtype=np.uint8).tobytes()
        tasks.append((src, str(rng.choice(flags))))
    ids = []
    for src, args in tasks:
        status, task_id = both_equal(pair.queue(src, args))
        assert status == 0
        ids.append(task_id)
    # Duplicates join the first submission's task (find_task_by_digest).
    assert len(set(ids)) == len(set(tasks))
    outputs = [both_equal(pair.wait(t)) for t in ids]
    for (src, args), out in zip(tasks, outputs):
        assert out[0] == "done"
        if "-DFAIL" in args:
            assert out[1] == 1 and b"induced failure" in out[3]
            assert out[6] == {}
        else:
            assert out[1] == 0 and set(out[6]) == {".o", ".gcno"}
            assert out[6][".o"].startswith(b"ELFOBJ:" + CLIENT_DIR.encode())
    for t in ids:
        assert both_equal(pair.simple("FreeTask", t)) == 0
    for t in set(ids):
        assert both_equal(pair.wait(t)) == \
            ("status", D.COMPILATION_TASK_STATUS_NOT_FOUND)


def test_join_through_reference_task_and_free(pair):
    status, t = both_equal(pair.queue(b"int joined();", "-O2"))
    assert status == 0
    assert both_equal(pair.simple("ReferenceTask", t)) == 0
    first = both_equal(pair.wait(t))
    assert first[0] == "done" and first[1] == 0
    # Two references: the first FreeTask leaves the output to the joiner.
    assert both_equal(pair.simple("FreeTask", t)) == 0
    assert both_equal(pair.wait(t)) == first
    assert both_equal(pair.simple("FreeTask", t)) == 0
    assert both_equal(pair.wait(t)) == \
        ("status", D.COMPILATION_TASK_STATUS_NOT_FOUND)
    assert both_equal(pair.simple("ReferenceTask", t)) == \
        D.DAEMON_STATUS_TASK_NOT_FOUND
    # Freeing an unknown task is not an error.
    assert both_equal(pair.simple("FreeTask", 999)) == 0


def test_refusals_equal(pair):
    denied = D.DAEMON_STATUS_ACCESS_DENIED
    assert both_equal(pair.queue(b"x", "-O2", token="evil")) == (denied,
                                                                  None)
    assert both_equal(pair.wait(1, token="evil")) == ("error", denied)
    assert both_equal(pair.simple("ReferenceTask", 1, token="evil")) == \
        denied
    assert both_equal(pair.simple("FreeTask", 1, token="evil")) == denied
    assert both_equal(pair.queue(b"x", "-O2", env="f" * 64)) == (
        D.DAEMON_STATUS_ENVIRONMENT_NOT_AVAILABLE, None)
    invalid = (D.DAEMON_STATUS_INVALID_ARGUMENT, None)
    assert both_equal(pair.queue(b"x", "-O2", algo=1)) == invalid
    assert both_equal(pair.queue(b"x", "-O2", attachment=b"junk")) == invalid
    assert both_equal(pair.wait(99999)) == \
        ("status", D.COMPILATION_TASK_STATUS_NOT_FOUND)
    # A rejected submission leaves no workspace behind.
    for svc in pair.servants.values():
        assert not list(pathlib.Path(svc.config.temporary_dir).iterdir())


def sleepers(tag: str, want: int) -> int:
    """How many ``/bin/sleep 30 <tag>`` processes live once their count
    reaches ``want`` or 10 s pass.  The tag makes the command this
    test's own, so other tests' processes never count."""
    argv = b"\0".join([b"/bin/sleep", b"30", tag.encode()]) + b"\0"
    deadline = time.monotonic() + 10
    while True:
        n = 0
        for cmdline in pathlib.Path("/proc").glob("[0-9]*/cmdline"):
            try:
                n += cmdline.read_bytes() == argv
            except OSError:
                pass   # a process that ended while we looked
        if n == want or time.monotonic() > deadline:
            return n
        time.sleep(0.05)


def test_heartbeats_equal_and_the_kill_list(pair):
    # Each servant runs the slow command in its task's process group:
    # the kill list, and later the engine's stop, must end those
    # processes, not only forget the tasks.
    killed, stopped = (f"0.{os.getpid()}{k}" for k in (1, 2))
    status, slow = both_equal(pair.queue(
        b"int slow();", f"-Dslow; /bin/sleep 30 {killed};", grant_id=41))
    assert status == 0
    assert sleepers(killed, 2) == 2
    status, quick = both_equal(pair.queue(b"int quick();", "-O2",
                                          grant_id=42))
    assert both_equal(pair.wait(quick))[1] == 0
    pair.sched_reply["expired"] = [41]
    for svc in pair.servants.values():
        svc.heartbeat_once()
    beats = {name: hb[-1] for name, hb in pair.heartbeats.items()}
    assert beats["port"] == beats["jax"]
    beat = beats["port"]
    assert (beat.token, beat.location, beat.version, beat.capacity,
            beat.num_processors, beat.current_load,
            beat.next_heartbeat_in_ms) == ("servant-token", LOCATION, 2,
                                            12, 32, 3, 1000)
    assert [e.compiler_digest for e in beat.env_descs] == [pair.compiler]
    assert [(t.servant_task_id, t.task_grant_id) for t in
            beat.running_tasks] == [(slow, 41)]
    # The kill list took the slow task: unknown from then on, and the
    # next beat reports nothing running.
    assert both_equal(pair.wait(slow)) == \
        ("status", D.COMPILATION_TASK_STATUS_NOT_FOUND)
    pair.sched_reply["tokens"] = ["tok2"]
    assert sleepers(killed, 0) == 0
    for svc in pair.servants.values():
        assert svc.engine.running_tasks() == []
        svc.heartbeat_once()
        svc.heartbeat_once(leaving=True)
    for i in (-2, -1):
        assert pair.heartbeats["port"][i] == pair.heartbeats["jax"][i]
    assert not pair.heartbeats["port"][-2].running_tasks
    assert pair.heartbeats["port"][-1].next_heartbeat_in_ms == 0
    # The token window rolled: the old token is refused.
    assert both_equal(pair.wait(quick)) == \
        ("error", D.DAEMON_STATUS_ACCESS_DENIED)
    assert both_equal(pair.wait(quick, token="tok2"))[1] == 0
    # Stopping an engine kills what it still runs.
    assert both_equal(pair.queue(
        b"int stop();", f"-Dstop; /bin/sleep 30 {stopped};", grant_id=43,
        token="tok2"))[0] == 0
    assert sleepers(stopped, 2) == 2
    for svc in pair.servants.values():
        svc.engine.stop()
    assert sleepers(stopped, 0) == 0


def _compile_through(delegate, compiler, src: bytes, cache_control: int):
    from yadcc_tpu.daemon.local.cxx_task import CxxCompilationTask

    task = CxxCompilationTask(
        requestor_pid=1, source_path="/src/tu.cc",
        source_digest=digest_bytes(src), invocation_arguments="-O2 -g",
        cache_control=cache_control, compiler_digest=compiler,
        compressed_source=tcompress.compress(src))
    tid = delegate.queue_task(task)
    result = delegate.wait_for_task(tid, 60)
    delegate.free_task(tid)
    return result


def _cache_entry(uri: str, key: str, not_equal_to=None):
    ch = trpc.Channel(uri)
    deadline = time.monotonic() + 20
    while True:
        try:
            _, value = ch.call("ytpu.CacheService", "TryGetEntry",
                               tapi.cache.TryGetEntryRequest(key=key),
                               tapi.cache.TryGetEntryResponse, timeout=5.0)
            if bytes(value) != not_equal_to:
                return bytes(value)
        except trpc.RpcError:
            pass
        assert time.monotonic() < deadline, "cache entry never filled"
        time.sleep(0.05)


def _entry_files(data: bytes):
    entry = cache_format.try_parse_cache_entry(data)
    assert entry is not None
    files = {k: tcompress.decompress(bytes(v)) for k, v in
             entry.files.items()}
    return (entry.exit_code, entry.standard_output, entry.standard_error,
            entry.patches, patch_files(files, entry.patches, CLIENT_DIR))


def test_jax_cluster_compiles_the_same_on_a_port_servant(tmp_path):
    """The JAX package's rig (scheduler, cache, delegate, one JAX
    servant) with a port servant heartbeating into its scheduler; the
    same TU compiled through a delegate pinned to each servant
    (debugging_always_use_servant_at): outputs and cache entries equal
    after the patch."""
    from yadcc_tpu.daemon.local.distributed_task_dispatcher import \
        DistributedTaskDispatcher
    from yadcc_tpu.daemon.local.task_grant_keeper import TaskGrantKeeper
    from yadcc_tpu.testing import LocalCluster

    from yadcc_tpu_torch.daemon.cloud.distributed_cache_writer import \
        DistributedCacheWriter

    cluster = LocalCluster(tmp_path, n_servants=1, servant_concurrency=2,
                           compiler_dirs=[str(TOOLCHAIN)])
    server = trpc.make_rpc_server("threaded", "127.0.0.1:0")
    (tmp_path / "port-shm").mkdir()
    config = TConfig(scheduler_uri=cluster.sched_uri,
                     cache_server_uri=cluster.cache_uri,
                     temporary_dir=str(tmp_path / "port-shm"),
                     location=f"127.0.0.1:{server.port}",
                     max_remote_tasks=2)
    engine = TEngine(max_concurrency=2, min_memory_for_new_task=1)
    port = tsvc.DaemonService(
        config, engine=engine, registry=TRegistry([str(TOOLCHAIN)]),
        cache_writer=DistributedCacheWriter(cluster.cache_uri, lambda: ""),
        sampler=FixedSampler(), allow_poor_machine=True,
        cgroup_present=False)
    port.attach_frontend(server)
    server.add_service(port.spec())
    server.start()
    port.start_heartbeat()
    delegates = []
    try:
        deadline = time.monotonic() + 10
        while len(cluster.sched_dispatcher.inspect()["servants"]) < 2:
            assert time.monotonic() < deadline, "port servant never joined"
            time.sleep(0.05)
        compiler = digest_file(TOOLCHAIN / "g++")
        src = b"int pinned(int x) { return x + 1; }\n"
        key = cache_format.get_cache_key(compiler, "-O2 -g",
                                         digest_bytes(src))
        out, entries = {}, {}
        for name, location in (
                ("jax", f"127.0.0.1:{cluster.servants[0].server.port}"),
                ("port", config.location)):
            delegate = DistributedTaskDispatcher(
                grant_keeper=TaskGrantKeeper(cluster.sched_uri, ""),
                config_keeper=cluster.config_keeper,
                running_task_keeper=None,
                debugging_always_use_servant_at=location)
            delegates.append(delegate)
            # Refill: compile (no cache read), then fill the entry.
            result = _compile_through(delegate, compiler, src, 2)
            assert result is not None and result.exit_code == 0, \
                result and result.standard_error
            files = {k: tcompress.decompress(bytes(v))
                     for k, v in result.files.items()}
            out[name] = (result.exit_code, result.standard_output,
                         result.standard_error, result.patches,
                         patch_files(files, result.patches, CLIENT_DIR))
            entries[name] = _cache_entry(cluster.cache_uri, key,
                                         entries.get("jax"))
            assert delegate.inspect()["stats"]["actually_run"] == 1
        assert out["port"] == out["jax"]
        assert out["port"][4][".o"].startswith(
            b"ELFOBJ:" + CLIENT_DIR.encode())
        assert _entry_files(entries["port"]) == _entry_files(entries["jax"])
        assert engine.inspect()["tasks_run_ever"] == 1
    finally:
        for delegate in delegates:
            delegate.stop()
        port.stop_heartbeat(graceful_leave=False)
        server.stop(grace=0)
        engine.stop()
        cluster.stop()
        join_pack_pools()


def _local_compile(gxx: str, args: str, src: bytes, workdir: pathlib.Path):
    """A compile as cxx_task.prepare runs it, in ``workdir``."""
    workdir.mkdir(parents=True)
    (workdir / "src.ii").write_bytes(src)
    subprocess.run(f"{gxx} -x c++-cpp-output {args} -c -o "
                   f"{workdir}/output.o {workdir}/src.ii", shell=True,
                   cwd=workdir, check=True, capture_output=True)
    return (workdir / "output.o").read_bytes()


@pytest.mark.skipif(shutil.which("g++") is None, reason="no g++ on PATH")
def test_real_gxx_through_the_port_servant(tmp_path):
    gxx = shutil.which("g++")
    registry = TRegistry([str(pathlib.Path(gxx).parent)])
    compiler = digest_file(pathlib.Path(gxx).resolve())
    assert registry.try_get_compiler_path(compiler) is not None
    (tmp_path / "shm").mkdir()
    engine = TEngine(max_concurrency=2, min_memory_for_new_task=1)
    svc = tsvc.DaemonService(
        TConfig(temporary_dir=str(tmp_path / "shm"), location=LOCATION),
        engine=engine, registry=registry, sampler=FixedSampler(),
        allow_poor_machine=True, cgroup_present=False)
    svc.set_acceptable_tokens_for_testing(["tok"])
    trpc.register_mock_server("servant-gxx", svc.spec())
    ch = trpc.Channel("mock://servant-gxx")
    # Preprocessed, as a client sends it: the line marker names the
    # source, so the workspace enters the debug info as DW_AT_comp_dir
    # alone (a bare src.ii would be named by its workspace path too, and
    # GCC orders those two strings by their bytes).
    src = (b'# 0 "twice.cc"\nint twice(int x) { return 2 * x; }\n'
           b"int g = twice(21);\n")
    try:
        for args in ("-O2", "-O2 -g"):
            req = D.QueueCxxCompilationTaskRequest(
                token="tok", task_grant_id=1, source_path="/src/t.cc",
                invocation_arguments=args, compression_algorithm=2)
            req.env_desc.compiler_digest = compiler
            resp, _ = ch.call("ytpu.DaemonService",
                              "QueueCxxCompilationTask", req,
                              D.QueueCxxCompilationTaskResponse,
                              attachment=tcompress.compress(src))
            wait = D.WaitForCompilationOutputRequest(
                token="tok", task_id=resp.task_id,
                milliseconds_to_wait=30000)
            out, att = ch.call("ytpu.DaemonService",
                               "WaitForCompilationOutput", wait,
                               D.WaitForCompilationOutputResponse)
            assert out.status == D.COMPILATION_TASK_STATUS_DONE
            assert out.exit_code == 0, out.standard_error
            obj = tcompress.decompress(
                bytes(packing.try_unpack_keyed_buffers(att)[".o"]))
            patches = {p.file_key: [(loc.position, loc.total_size,
                                     loc.suffix_to_keep)
                                    for loc in p.locations]
                       for p in out.cxx_info.patches}
            if "-g" not in args:
                # No path in the object: equal to a compile anywhere.
                local_dir = tmp_path / f"local{len(args)}"
                assert obj == _local_compile(gxx, args, src, local_dir)
                continue
            # The workspace enters a -g object as DW_AT_comp_dir.  GCC
            # orders its debug strings by their hashes, so a directory
            # of the same length but other bytes can permute them: the
            # local compile runs in the servant's own (removed)
            # workspace, read back at the first patch location.
            assert patches.get(".o"), "no patch locations in a -g object"
            pos, total, suffix = patches[".o"][0]
            workspace = obj[pos:pos + total - len(suffix)].decode()
            assert len(workspace) == tcxx._PADDED_WORKSPACE_LEN
            assert workspace.startswith(str(tmp_path / "shm"))
            local = _local_compile(gxx, args, src, pathlib.Path(workspace))
            assert obj == local
            assert patches[".o"] == tcxx.find_patch_locations(
                local, workspace.encode())
            assert patch_files({".o": obj}, patches, CLIENT_DIR) == \
                patch_files({".o": local}, patches, CLIENT_DIR)
    finally:
        trpc.unregister_mock_server("servant-gxx")
        engine.stop()
        join_pack_pools()


def test_aio_parked_output_wait_answers_once(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(TOOLCHAIN))
    (tmp_path / "shm").mkdir()
    server = trpc.make_rpc_server("aio", "127.0.0.1:0")
    engine = TEngine(max_concurrency=2, min_memory_for_new_task=1)
    svc = tsvc.DaemonService(
        TConfig(temporary_dir=str(tmp_path / "shm"), location=LOCATION),
        engine=engine, registry=TRegistry(), sampler=FixedSampler(),
        allow_poor_machine=True, cgroup_present=False)
    svc.set_acceptable_tokens_for_testing(["tok"])
    svc.attach_frontend(server)
    spec = svc.spec()
    assert "WaitForCompilationOutput" in spec.parked
    server.add_service(spec)
    server.start()
    chans = []

    def wait(task_id, ms):
        ch = trpc.Channel(f"aio://127.0.0.1:{server.port}")
        chans.append(ch)
        return ch.call("ytpu.DaemonService", "WaitForCompilationOutput",
                       D.WaitForCompilationOutputRequest(
                           token="tok", task_id=task_id,
                           milliseconds_to_wait=ms),
                       D.WaitForCompilationOutputResponse, timeout=30)

    try:
        ch = trpc.Channel(f"aio://127.0.0.1:{server.port}")
        chans.append(ch)
        req = D.QueueCxxCompilationTaskRequest(
            token="tok", task_grant_id=1, source_path="/src/t.cc",
            invocation_arguments="-O2; /bin/sleep 1.5 0;",
            compression_algorithm=2)
        req.env_desc.compiler_digest = svc.registry.environments()[0]
        task_id = ch.call("ytpu.DaemonService", "QueueCxxCompilationTask",
                          req, D.QueueCxxCompilationTaskResponse,
                          attachment=tcompress.compress(b"int p;"))[0].task_id
        replies = {}
        threads = [threading.Thread(
            target=lambda k=k, ms=ms: replies.__setitem__(k, wait(task_id,
                                                                  ms)))
            for k, ms in (("short", 200), ("long", 10_000))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert replies["short"][0].status == \
            D.COMPILATION_TASK_STATUS_RUNNING
        done, att = replies["long"]
        assert done.status == D.COMPILATION_TASK_STATUS_DONE
        # The command ends in the shell's `-c: not found` (127).
        assert done.exit_code == 127
        again, att2 = wait(task_id, 10_000)
        assert again == done and bytes(att2) == bytes(att)
        assert wait(777, 100)[0].status == \
            D.COMPILATION_TASK_STATUS_NOT_FOUND
        assert server.inspect()["double_replies"] == 0
        assert engine.inspect()["parked_waiters"] == 0
    finally:
        for c in chans:
            c.close()
        server.stop(grace=0)
        engine.stop()
        join_pack_pools()


def test_servant_entry_serves_a_compile_and_leaves_on_sigterm(tmp_path):
    """`python -m yadcc_tpu_torch.daemon.entry` against a scheduler stub:
    it heartbeats its capacity and compilers, compiles a task under the
    token the scheduler rolled out, and leaves gracefully on SIGTERM."""
    import signal
    import sys

    beats = []
    sched = trpc.ServiceSpec("ytpu.SchedulerService")

    def heartbeat(req, attachment, ctx):
        beats.append(req)
        return tapi.scheduler.HeartbeatResponse(acceptable_tokens=["dtok"])

    sched.add("Heartbeat", tapi.scheduler.HeartbeatRequest, heartbeat)
    server = trpc.make_rpc_server("threaded", "127.0.0.1:0")
    server.add_service(sched)
    server.start()
    proc = subprocess.Popen(
        [sys.executable, "-m", "yadcc_tpu_torch.daemon.entry",
         "--scheduler-uri", f"grpc://127.0.0.1:{server.port}",
         "--token", "stok", "--serving-port", "0", "--inspect-port", "0",
         "--local-port", "0",
         "--extra-compiler-dirs", str(TOOLCHAIN), "--max-remote-tasks", "2",
         "--temporary-dir", str(tmp_path / "shm"), "--allow-poor-machine",
         "--ignore-cgroup-limits", "--no-privilege-drop"],
        cwd=REPO, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
    try:
        deadline = time.monotonic() + 30
        while len(beats) < 2:
            assert proc.poll() is None, proc.stderr.read().decode()[-2000:]
            assert time.monotonic() < deadline, "no heartbeat"
            time.sleep(0.05)
        beat = beats[-1]
        fake = digest_file(TOOLCHAIN / "g++")
        assert beat.token == "stok" and beat.version == 2
        assert 0 < beat.capacity <= 2
        assert fake in [e.compiler_digest for e in beat.env_descs]
        ch = trpc.Channel(f"grpc://{beat.location}")
        req = D.QueueCxxCompilationTaskRequest(
            token="dtok", task_grant_id=3, source_path="/src/e.cc",
            invocation_arguments="-O2", compression_algorithm=2)
        req.env_desc.compiler_digest = fake
        task_id = ch.call("ytpu.DaemonService", "QueueCxxCompilationTask",
                          req, D.QueueCxxCompilationTaskResponse,
                          attachment=tcompress.compress(b"int e;"))[0].task_id
        out, att = ch.call("ytpu.DaemonService", "WaitForCompilationOutput",
                           D.WaitForCompilationOutputRequest(
                               token="dtok", task_id=task_id,
                               milliseconds_to_wait=10_000),
                           D.WaitForCompilationOutputResponse, timeout=20)
        assert out.status == D.COMPILATION_TASK_STATUS_DONE
        assert out.exit_code == 0
        assert set(packing.try_unpack_keyed_buffers(att)) == {".o", ".gcno"}
        ch.close()
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=20) == 0
        assert beats[-1].next_heartbeat_in_ms == 0   # the graceful leave
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        proc.stderr.close()
        server.stop(grace=0)


@pytest.mark.parametrize("argv,field,value", [
    (["--local-port", "8334"], "local_port", 8334),
    (["--max-local-tasks", "4"], "max_local_tasks", 4),
    (["--lightweight-ratio", "2"], "lightweight_ratio", 2.0),
    (["--debugging-always-use-servant-at", "127.0.0.1:8335"],
     "debugging_always_use_servant_at", "127.0.0.1:8335"),
    (["--scheduler-uri", "grpc://a:8336,grpc://b:8336"], "scheduler_uri",
     "grpc://a:8336,grpc://b:8336"),
    (["--scheduler-uri", "grpc://a:8336,grpc://b:8336;grpc://c:8336"],
     "scheduler_uri", "grpc://a:8336,grpc://b:8336;grpc://c:8336"),
])
def test_servant_entry_refuses_what_it_cannot_serve(argv, field, value,
                                                    capsys):
    """What the entry refused while it had no delegate role and no
    failover channel (the delegate's flags, a ','-separated failover
    list) it now takes: each parses to its value, and nothing is
    refused."""
    from yadcc_tpu_torch.daemon.entry import build_arg_parser

    args = build_arg_parser().parse_args(argv)
    assert getattr(args, field) == value
    assert capsys.readouterr().err == ""


def test_servant_entry_takes_the_first_cell():
    from yadcc_tpu_torch.daemon.entry import build_arg_parser

    uri = "grpc://a:8336;grpc://b:8336,grpc://c:8336"
    assert build_arg_parser().parse_args(
        ["--scheduler-uri", uri]).scheduler_uri == uri
