"""The port's delegate held against the JAX package's, end to end.

The JAX client (yadcc_tpu/client/compilation_saas.py) compiles the same
TUs through the port's in-process rig (yadcc_tpu_torch/testing/
local_cluster.py: scheduler with its policy on the CPU, cache server,
two servants, one delegate behind its loopback HTTP API) and through the
JAX package's LocalCluster, with the rig's fake compiler: outputs, exit
codes and the delegates' counters must be equal, and a rebuild must hit
the cache in both.  The same raw HTTP script (the 400 -> set_file_digest
flow, wait 404 and 503, quota 200 and 503, ask_to_leave) gets the same
answers from both, and so does each package's HTTP service with tenancy
on (403 without a valid credential, 503 + Retry-After over budget).
Then the cross-package pairs: the port's delegate on
the JAX rig's scheduler, servants and cache, and the JAX delegate on the
port's; and the JAX client's whole pipeline with the real g++ through
the port's rig.  Every delegate, rig and pack pool is stopped at
teardown."""

from __future__ import annotations

import http.client
import json
import os
import shutil
import subprocess
import time

import pytest

import yadcc_tpu.daemon.cloud.cxx_task as jcloud
from yadcc_tpu.client import compilation_saas, daemon_call
from yadcc_tpu.daemon.local.config_keeper import ConfigKeeper as JConfig
from yadcc_tpu.daemon.local.distributed_cache_reader import \
    DistributedCacheReader as JReader
from yadcc_tpu.daemon.local.distributed_task_dispatcher import \
    DistributedTaskDispatcher as JDispatcher
from yadcc_tpu.daemon.local.file_digest_cache import \
    FileDigestCache as JDigests
from yadcc_tpu.daemon.local.http_service import \
    LocalHttpService as JHttp
from yadcc_tpu.daemon.local.local_task_monitor import \
    LocalTaskMonitor as JMonitor
from yadcc_tpu.daemon.local.task_grant_keeper import \
    TaskGrantKeeper as JKeeper
from yadcc_tpu.testing import LocalCluster as JCluster
import yadcc_tpu_torch.daemon.cloud.cxx_task as tcloud
from yadcc_tpu_torch.common import compress
from yadcc_tpu_torch.common.hashing import digest_bytes
from yadcc_tpu_torch.daemon.local.config_keeper import \
    ConfigKeeper as TConfig
from yadcc_tpu_torch.daemon.local.distributed_cache_reader import \
    DistributedCacheReader as TReader
from yadcc_tpu_torch.daemon.local.distributed_task_dispatcher import \
    DistributedTaskDispatcher as TDispatcher
from yadcc_tpu_torch.daemon.local.file_digest_cache import \
    FileDigestCache as TDigests
from yadcc_tpu_torch.daemon.local.http_service import \
    LocalHttpService as THttp
from yadcc_tpu_torch.daemon.local.local_task_monitor import \
    LocalTaskMonitor as TMonitor
from yadcc_tpu_torch.daemon.local.task_grant_keeper import \
    TaskGrantKeeper as TKeeper
from yadcc_tpu_torch.testing import LocalCluster as TCluster
from yadcc_tpu_torch.testing import make_fake_compiler
from yadcc_tpu_torch.testing.local_cluster import FAKE_COMPILER

GXX = shutil.which("g++")
N_TUS = 6                    # the last one fails (-DFAIL)
# `sleep 1 0` sleeps one second, and its command line is not what the
# hygiene sentinel looks for (a bare `sleep N`).
SLOW_COMPILER = FAKE_COMPILER.replace("{sleep}", "sleep 1 0\n", 1)


def join_pack_pools() -> None:
    tcloud.shutdown_pack_executor()
    pool = jcloud._PACK_EXECUTOR._pool
    jcloud._PACK_EXECUTOR._pool = None
    if pool is not None:
        pool.shutdown(wait=True)


@pytest.fixture(scope="module")
def rigs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("delegate")
    # Not under a `bin/`: the hygiene sentinel looks for `/bin/g++ ...
    # output.o` processes, host-wide.
    fake = make_fake_compiler(str(tmp / "fake" / "tc"))
    slow = tmp / "slow" / "tc"
    slow.mkdir(parents=True)
    (slow / "g++").write_text(SLOW_COMPILER)
    (slow / "g++").chmod(0o755)
    dirs = [str(tmp / "fake" / "tc"), str(slow)]
    (tmp / "jax").mkdir()
    (tmp / "port").mkdir()
    jax = JCluster(tmp / "jax", n_servants=2, compiler_dirs=dirs)
    try:
        port = TCluster(tmp / "port", n_servants=2, device="cpu",
                        compiler_dirs=dirs)
    except BaseException:
        jax.stop()
        raise
    try:
        yield {"jax": jax, "port": port, "fake": fake,
               "slow": str(slow / "g++"), "tmp": tmp}
    finally:
        port.stop()
        jax.stop()
        join_pack_pools()


def _tus():
    tus = []
    for i in range(N_TUS):
        src = f"int tu_{i}(int x) {{ return x * {i + 3}; }}\n".encode()
        args = "-O2 -DFAIL" if i == N_TUS - 1 else ("-O2", "-O0 -g")[i % 2]
        tus.append((f"/home/u/p/tu{i}.cc", src, args))
    return tus


def _compile(port: int, compiler: str, tus, cache_control: int,
             monkeypatch) -> list:
    """The JAX client's submit and wait for each TU, as a wrapper would
    call them; the results with their files decompressed."""
    monkeypatch.setenv("YTPU_DAEMON_PORT", str(port))
    daemon_call.set_daemon_call_handler(None)
    out = []
    for path, src, args in tus:
        tid = compilation_saas.submit_compilation_task(
            compiler_path=compiler, source_path=path,
            source_digest=digest_bytes(src),
            compressed_source=compress.compress(src),
            invocation_arguments=args, cache_control=cache_control)
        result, patches = compilation_saas.wait_for_compilation_task(
            tid, timeout_s=60)
        out.append((result.exit_code, result.standard_output,
                    result.standard_error, result.files, patches))
    return out


def _stats(dispatcher) -> dict:
    s = dispatcher.inspect()
    return {"stats": s["stats"], "stats_by_kind": s["stats_by_kind"]}


def _wait_fills(rig, n: int) -> None:
    deadline = time.monotonic() + 20
    while rig.cache_service.inspect()["fills"] < n:
        assert time.monotonic() < deadline, "the cache never filled"
        time.sleep(0.05)


def test_jax_client_compiles_the_same_through_both_rigs(rigs, monkeypatch):
    tus = _tus()
    first = {name: _compile(rigs[name].http.port, rigs["fake"], tus, 1,
                            monkeypatch) for name in ("jax", "port")}
    assert first["port"] == first["jax"]
    assert [r[0] for r in first["jax"]] == [0] * (N_TUS - 1) + [1]
    assert first["jax"][0][3][".o"].startswith(b"FAKEOBJ\nint tu_0")
    stats = {name: _stats(rigs[name].delegate) for name in ("jax", "port")}
    assert stats["port"] == stats["jax"]
    assert stats["jax"]["stats"]["actually_run"] == N_TUS
    # The rebuild, once the fills landed and each reader synced.
    for name in ("jax", "port"):
        _wait_fills(rigs[name], N_TUS - 1)
        rigs[name].cache_reader.sync_once()
    again = {name: _compile(rigs[name].http.port, rigs["fake"], tus, 1,
                            monkeypatch) for name in ("jax", "port")}
    assert again["port"] == again["jax"] == first["jax"]
    stats = {name: _stats(rigs[name].delegate) for name in ("jax", "port")}
    assert stats["port"] == stats["jax"]
    assert stats["jax"]["stats"]["hit_cache"] == N_TUS - 1
    assert stats["jax"]["stats"]["actually_run"] == N_TUS + 1
    assert stats["jax"]["stats"]["failed"] == 0


def _http(port: int, method: str, path: str, body: bytes = b"",
          headers=None) -> tuple:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request(method, path, body=body, headers=headers or {})
        resp = conn.getresponse()
        return resp.status, resp.getheader("Retry-After"), resp.read()
    finally:
        conn.close()


def _submit_body(compiler: str, src: bytes, pid: int) -> bytes:
    from yadcc_tpu_torch.common.multi_chunk import make_multi_chunk

    st = os.stat(compiler)
    msg = {"requestor_process_id": pid, "source_path": "/home/u/p/slow.cc",
           "source_digest": digest_bytes(src),
           "compiler_invocation_arguments": "-O2", "cache_control": 1,
           "compiler": {"path": compiler, "size": str(st.st_size),
                        "timestamp": str(int(st.st_mtime))}}
    return make_multi_chunk([json.dumps(msg).encode(),
                             compress.compress(src)])


def _http_script(port: int, compiler: str) -> list:
    from yadcc_tpu_torch.common.hashing import digest_file

    out = [_http(port, "GET", "/local/get_version"),
           _http(port, "GET", "/local/nope"),
           _http(port, "POST", "/local/nope", b"{}")]

    def quota(path, pid, ms=50, light=False):
        return _http(port, "POST", f"/local/{path}", json.dumps(
            {"requestor_pid": pid, "lightweight_task": light,
             "milliseconds_to_wait": ms}).encode())

    # nprocs 8: four heavy slots, twelve light ones.
    out += [quota("acquire_quota", 9) for _ in range(5)]
    out += [quota("release_quota", 9), quota("acquire_quota", 10),
            quota("acquire_quota", 11, light=True)]
    out += [quota("release_quota", p) for p in (9, 9, 9, 10, 11)]
    src = b"int slow_tu(int x) { return x - 1; }\n"
    body = _submit_body(compiler, src, os.getpid())
    out.append(_http(port, "POST", "/local/submit_cxx_task", body))
    st = os.stat(compiler)
    out.append(_http(port, "POST", "/local/set_file_digest", json.dumps(
        {"file_desc": {"path": compiler, "size": str(st.st_size),
                       "timestamp": str(int(st.st_mtime))},
         "digest": digest_file(compiler)}).encode()))
    status, _, reply = _http(port, "POST", "/local/submit_cxx_task", body)
    out.append((status, None, reply))
    task_id = json.loads(reply)["task_id"]

    def wait(tid, ms):
        return _http(port, "POST", "/local/wait_for_cxx_task", json.dumps(
            {"task_id": str(tid), "milliseconds_to_wait": ms}).encode())

    out.append(wait(task_id, 100))          # still compiling: 503
    out.append(wait(task_id, 10_000))       # the output
    out.append(wait(task_id, 100))          # freed: 404
    out.append(wait(99_999, 100))           # never known: 404
    out.append(_http(port, "POST", "/local/submit_cxx_task", b"{}"))
    out.append(_http(port, "POST", "/local/submit_cxx_task", b"",
                     {"Content-Length": str(1 << 40)}))
    out.append(_http(port, "POST", "/local/ask_to_leave", b"{}"))
    return out


def test_http_routes_answer_alike(rigs):
    got = {name: _http_script(rigs[name].http.port, rigs["slow"])
           for name in ("jax", "port")}
    assert got["port"] == got["jax"]
    statuses = [s for s, _, _ in got["jax"]]
    assert statuses == [200, 404, 404, 200, 200, 200, 200, 503, 200, 200,
                        200, 200, 200, 200, 200, 200, 400, 200, 200, 503,
                        200, 404, 404, 400, 413, 200]
    retry = [r for _, r, _ in got["jax"]]
    assert retry[7] == "0.5" and retry[19] == "0.5"
    assert got["jax"][16][2] == (b'{"error":"compiler digest unknown; '
                                 b'set_file_digest first"}')


def _tenant_script(kind: str, compiler: str) -> list:
    """The delegate's HTTP service with a TenancyControl and a tenant
    ledger (no cluster behind it: nothing here reaches a servant)."""
    import importlib

    pkg = "yadcc_tpu_torch" if kind == "port" else "yadcc_tpu"
    ten = importlib.import_module(pkg + ".tenancy")
    local = pkg + ".daemon.local."
    http_mod = importlib.import_module(local + "http_service")
    window = ["tok-b", "tok-a"]
    directory = ten.TenantDirectory([
        ten.TenantSpec("acme", tier="interactive", weight=2.0),
        ten.TenantSpec("busy", max_outstanding=1)])
    control = ten.TenancyControl(directory, "root", lambda: window)
    ledger = ten.TenantLedger(directory)
    ledger.charge("busy")
    dispatcher = importlib.import_module(
        local + "distributed_task_dispatcher").DistributedTaskDispatcher(
        grant_keeper=importlib.import_module(
            local + "task_grant_keeper").TaskGrantKeeper("mock://none", ""),
        config_keeper=importlib.import_module(
            local + "config_keeper").ConfigKeeper("mock://none", ""),
        tenant_ledger=ledger)
    svc = http_mod.LocalHttpService(
        monitor=importlib.import_module(local + "local_task_monitor")
        .LocalTaskMonitor(nprocs=8, pid_prober=lambda p: True),
        digest_cache=importlib.import_module(local + "file_digest_cache")
        .FileDigestCache(), dispatcher=dispatcher, port=0, tenancy=control)
    svc.start()
    release = json.dumps({"requestor_pid": 3}).encode()
    st = os.stat(compiler)
    digest = json.dumps(
        {"file_desc": {"path": compiler, "size": str(st.st_size),
                       "timestamp": str(int(st.st_mtime))},
         "digest": "f" * 64}).encode()

    def cred(tenant, token="tok-a"):
        return {"X-Ytpu-Tenant": ten.derive_tenant_credential(token,
                                                               tenant)}

    try:
        out = [_http(svc.port, "GET", "/local/get_version"),
               _http(svc.port, "POST", "/local/release_quota", release),
               _http(svc.port, "POST", "/local/release_quota", release,
                     {"X-Ytpu-Tenant": "ytpu-tn1.acme.00"}),
               _http(svc.port, "POST", "/local/release_quota", release,
                     cred("acme", "tok-old")),
               _http(svc.port, "POST", "/local/release_quota", release,
                     cred("ghost")),
               _http(svc.port, "POST", "/local/release_quota", release,
                     cred("acme")),
               _http(svc.port, "POST", "/local/set_file_digest", digest,
                     cred("busy")),
               _http(svc.port, "POST", "/local/submit_cxx_task",
                     _submit_body(compiler, b"int busy;", 5),
                     cred("busy"))]
        return out + [svc.inspect()["tenancy"]["stats"]]
    finally:
        svc.stop()
        dispatcher.stop()


def test_tenant_binding_answers_alike(rigs):
    """With tenancy on every POST route fails closed: no, a forged, a
    stale-window or an unknown tenant's credential gets 403; a valid one
    is served; an over-budget tenant's submission gets 503 with
    Retry-After."""
    got = {kind: _tenant_script(kind, rigs["fake"])
           for kind in ("jax", "port")}
    assert got["port"] == got["jax"]
    assert [r[0] for r in got["jax"][:-1]] == [200, 403, 403, 403, 403,
                                               200, 200, 503]
    assert got["jax"][1][2] == (b'{"error":"valid tenant credential '
                                b'required"}')
    assert got["jax"][7][1:] == ("0.5", b'{"error":"tenant over budget"}')


def _foreign_delegate(kind: str, rig, scheme: str):
    """A delegate of package ``kind`` with its HTTP service, dialing the
    rig's scheduler, servants and cache."""
    if kind == "port":
        Keeper, Config, Reader, Dispatcher, Http, Monitor, Digests = (
            TKeeper, TConfig, TReader, TDispatcher, THttp, TMonitor,
            TDigests)
        reader = Reader(rig.cache_uri, "", device="cpu")
    else:
        Keeper, Config, Reader, Dispatcher, Http, Monitor, Digests = (
            JKeeper, JConfig, JReader, JDispatcher, JHttp, JMonitor,
            JDigests)
        reader = Reader(rig.cache_uri, "", use_device_cascade=False)
    config = Config(rig.sched_uri, "")
    config.start()
    reader.start()
    dispatcher = Dispatcher(grant_keeper=Keeper(rig.sched_uri, ""),
                            config_keeper=config, cache_reader=reader,
                            servant_scheme=scheme)
    http_service = Http(monitor=Monitor(nprocs=8,
                                        pid_prober=lambda p: True),
                        digest_cache=Digests(), dispatcher=dispatcher,
                        port=0)
    http_service.start()
    return http_service, dispatcher, config, reader


def test_cross_package_delegates(rigs, monkeypatch):
    """The port's delegate on the JAX rig, the JAX delegate on the
    port's: the same TUs compiled again (REFILL: no read), then read
    back from the cache once the foreign reader synced."""
    tus = _tus()
    want = _compile(rigs["jax"].http.port, rigs["fake"], tus, 1,
                    monkeypatch)
    pairs = {"port-on-jax": ("port", "jax"), "jax-on-port": ("jax", "port")}
    stats = {}
    for name, (kind, rig_name) in pairs.items():
        svc, dispatcher, config, reader = _foreign_delegate(
            kind, rigs[rig_name], "grpc://")
        try:
            got = _compile(svc.port, rigs["fake"], tus, 2, monkeypatch)
            assert got == want, name
            reader.sync_once()
            got = _compile(svc.port, rigs["fake"], tus, 1, monkeypatch)
            assert got == want, name
            stats[name] = _stats(dispatcher)
        finally:
            svc.stop()
            dispatcher.stop()
            config.stop()
            reader.stop()
    assert stats["port-on-jax"] == stats["jax-on-port"]
    assert stats["jax-on-port"]["stats"] == {
        "hit_cache": N_TUS - 1, "reused": 0, "actually_run": N_TUS + 1,
        "failed": 0, "shed_to_local": 0}


@pytest.mark.skipif(GXX is None, reason="no g++ on PATH")
def test_real_gxx_through_the_port_rig(rigs, tmp_path, monkeypatch):
    """The JAX client's whole pipeline (quota, preprocess, submit, wait,
    write) with the real g++ through the port's delegate: the object
    links and runs, and equals a local compile of the preprocessed
    source."""
    from yadcc_tpu.client.yadcc_cxx import entry as client_entry

    rig = rigs["port"]
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("YTPU_DAEMON_PORT", str(rig.http.port))
    monkeypatch.setenv("YTPU_COMPILE_ON_CLOUD_SIZE_THRESHOLD", "1")
    daemon_call.set_daemon_call_handler(None)
    (tmp_path / "hello.cc").write_text(
        "#include <cstdio>\nint main() { std::puts(\"hello from the port\"); "
        "return 0; }\n")
    before = rig.delegate.inspect()["stats"]["actually_run"]
    assert client_entry(["g++", "-O2", "-c", "hello.cc", "-o",
                         "hello.o"]) == 0
    assert rig.delegate.inspect()["stats"]["actually_run"] == before + 1
    subprocess.run([GXX, "-E", "-o", "hello.ii", "hello.cc"], check=True)
    subprocess.run([GXX, "-x", "c++-cpp-output", "-O2", "-c", "-o",
                    "local.o", "hello.ii"], check=True)
    assert (tmp_path / "hello.o").read_bytes() == \
        (tmp_path / "local.o").read_bytes()
    subprocess.run([GXX, "hello.o", "-o", "hello"], check=True)
    out = subprocess.run(["./hello"], capture_output=True, text=True)
    assert out.stdout.strip() == "hello from the port"
