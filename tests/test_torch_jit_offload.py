"""The port's jit workload held against the JAX package's.

Digests, cache keys, kinds and cache entries, the fake worker's artifacts
and scores, the servant's gating, the heartbeat's environments, the
YTPU_JIT_* knobs: byte for byte or integer for integer equal to the JAX
package's (tolerance 0).  Then both packages' rigs with equal environment
strings (backend "cpu" and this host's jaxlib version, the JAX rig's
own): the same source through both gives equal artifacts and cache
entries, a second delegate hits the cache, concurrent identical
submissions build once, cxx and jit mix through one delegate, the HTTP
routes answer alike, and the cross-package pairs (a JAX delegate on the
port's servants, the port's delegate on the JAX servants) build the
same.  The worker runs fake (YTPU_JIT_FAKE_WORKER=1) on the rigs; its
real mode runs against a stub nvcc on PATH that records its argv and
environment, which the tests hold to the compile-options contract."""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
from google.protobuf import json_format

from yadcc_tpu import api as japi
from yadcc_tpu.client import env_options as jenv_options
from yadcc_tpu.common import compress as jcompress
from yadcc_tpu.daemon import cache_format as jcache
from yadcc_tpu.daemon import task_digest as jdigest
from yadcc_tpu.daemon.local import http_service as jhttp
from yadcc_tpu.jit import compile_worker as jworker
from yadcc_tpu.jit import env as jenv
from yadcc_tpu.testing import LocalCluster as JCluster
from yadcc_tpu_torch import api as tapi
from yadcc_tpu_torch.client import env_options as tenv_options
from yadcc_tpu_torch.common import compress as tcompress
from yadcc_tpu_torch.common import multi_chunk
from yadcc_tpu_torch.common.hashing import digest_bytes, digest_file
from yadcc_tpu_torch.daemon import cache_format as tcache
from yadcc_tpu_torch.daemon import task_digest as tdigest
from yadcc_tpu_torch.daemon.local import http_service as thttp
from yadcc_tpu_torch.jit import compile_worker as tworker
from yadcc_tpu_torch.jit import env as tenv
from yadcc_tpu_torch.ops import _build
from yadcc_tpu_torch.testing import LocalCluster as TCluster
from yadcc_tpu_torch.testing import make_fake_compiler

from .conftest import post_local

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The JAX rig's own environment; the port's rig serves the same strings.
JENV = jenv.local_jit_environment("cpu")
TENV = tenv.JitEnvironment(JENV.backend, JENV.jaxlib_version)
SRC = b'extern "C" int ytpu_jit_probe(void) { return 7; }\n'
STUB_RELEASE = "Cuda compilation tools, release 12.4, V12.4.131"
# The stub splits a -D value at an unescaped comma as the real nvcc does.
STUB_NVCC = f"""#!{sys.executable}
import json, os, re, sys
if "--version" in sys.argv:
    print("nvcc: NVIDIA (R) Cuda compiler driver")
    print("{STUB_RELEASE}")
    sys.exit(0)
with open(os.environ["STUB_NVCC_LOG"], "a") as f:
    f.write(json.dumps({{"argv": sys.argv[1:],
                        "tmpdir": os.environ.get("TMPDIR", ""),
                        "cwd": os.getcwd()}}) + "\\n")
if any(a.startswith("-D") and re.search(r"(?<!\\\\),", a)
       for a in sys.argv[1:]):
    sys.stderr.write("<command-line>: error: macro names must be "
                     "identifiers\\n")
    sys.exit(1)
src = open(sys.argv[-1], "rb").read()
if b"#error" in src:
    sys.stderr.write(sys.argv[-1] + ": error: #error smoke\\n")
    sys.exit(2)
out = sys.argv[sys.argv.index("-o") + 1]
open(out, "wb").write(b"STUBLIB" + src)
"""


def seeded_inputs(seed: int, n: int = 6):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        blob = rng.integers(0, 256, int(rng.integers(0, 64)),
                            dtype=np.uint8).tobytes()
        hexs = [rng.integers(0, 256, 32, dtype=np.uint8).tobytes().hex()
                for _ in range(3)]
        out.append((blob, *hexs))
    return out


# -- digests, keys, kinds, entries --------------------------------------------


@pytest.mark.parametrize("seed", range(4))
def test_digests_and_keys_equal(seed):
    for blob, env, comp, other in seeded_inputs(seed):
        assert tdigest.get_jit_task_digest(env, blob, comp) == \
            jdigest.get_jit_task_digest(env, blob, comp)
        assert tdigest.get_aot_task_digest(env, other, comp) == \
            jdigest.get_aot_task_digest(env, other, comp)
        assert tdigest.get_autotune_task_digest(env, other, comp) == \
            jdigest.get_autotune_task_digest(env, other, comp)
        for secret in ("", other[:16]):
            assert tcache.get_jit_cache_key(env, blob, comp, secret) == \
                jcache.get_jit_cache_key(env, blob, comp, secret)
            for name in ("get_aot_cache_key", "get_autotune_cache_key",
                         "get_autotune_sweep_key"):
                assert getattr(tcache, name)(env, other, comp, secret) == \
                    getattr(jcache, name)(env, other, comp, secret), name
            assert thttp.shim_cache_key(blob.hex(), secret) == \
                jhttp.shim_cache_key(blob.hex(), secret)
        version = blob.decode(errors="replace")
        assert tenv.jit_env_digest("cuda", version) == \
            jenv.jit_env_digest("cuda", version)
        assert tenv.JitEnvironment("cpu", version).digest == \
            jenv.JitEnvironment("cpu", version).digest
    assert (tcache.KIND_JIT, tcache.KIND_AOT, tcache.KIND_AUTOTUNE) == \
        (jcache.KIND_JIT, jcache.KIND_AOT, jcache.KIND_AUTOTUNE)


@pytest.mark.parametrize("kind", ["cxx", "jit", "aot", "autotune"])
def test_cache_entries_equal_and_kind_gated(kind):
    rng = np.random.default_rng(len(kind))
    files = {".xla": rng.integers(0, 256, 300, dtype=np.uint8).tobytes()}
    blobs = {}
    for name, mod in (("jax", jcache), ("port", tcache)):
        blobs[name] = mod.write_cache_entry(mod.CacheEntry(
            exit_code=0, standard_output=b"out", standard_error=b"err",
            files=files, kind=kind))
    assert blobs["port"] == blobs["jax"]
    for other in ("cxx", "jit", "aot", "autotune"):
        got = {name: mod.try_parse_cache_entry(blobs["jax"],
                                               expect_kind=other)
               for name, mod in (("jax", jcache), ("port", tcache))}
        assert (got["port"] is None) == (got["jax"] is None) == \
            (other != kind)


# -- the worker ---------------------------------------------------------------


@pytest.mark.parametrize("seed", range(3))
def test_fake_artifacts_and_scores_equal(seed):
    rng = np.random.default_rng(100 + seed)
    for blob, *_ in seeded_inputs(seed):
        opts = {"backend": "cpu", "mem_limit_bytes": int(rng.integers(
            0, 1 << 40)), "compile_options_hex": blob.hex(),
            "mesh_shape": [int(rng.integers(1, 9))],
            "device_count": int(rng.integers(1, 9))}
        assert tworker._fake_artifact(opts, blob) == \
            jworker._fake_artifact(opts, blob)
        config = {"BLOCK": int(rng.integers(1, 1024)), "s": blob.hex()}
        assert tworker._config_score_fake(config, blob) == \
            jworker._config_score_fake(config, blob)
        assert tworker._instantiate_kernel(b"{BLOCK} {s} {x}", config) == \
            jworker._instantiate_kernel(b"{BLOCK} {s} {x}", config)


def _stage_request(ws, options: dict, payload: bytes) -> None:
    os.makedirs(ws, exist_ok=True)
    with open(os.path.join(ws, "request.bin"), "wb") as fp:
        fp.write(multi_chunk.make_multi_chunk(
            [json.dumps(options, sort_keys=True).encode(), payload]))


def _run_worker(module: str, ws, *flags, env=None):
    out = subprocess.run(
        [sys.executable, "-m", module, "--workspace", str(ws), *flags],
        cwd=REPO, env=env or dict(os.environ, PYTHONPATH=REPO),
        capture_output=True, timeout=120)
    art = os.path.join(ws, "artifact.bin")
    data = open(art, "rb").read() if os.path.exists(art) else None
    return out.returncode, out.stdout, data


@pytest.mark.parametrize("request_kind", ["jit", "aot", "autotune"])
def test_fake_worker_programs_equal(tmp_path, request_kind):
    """Both packages' workers as programs on one request: exit code,
    output line and artifact equal."""
    options = {"backend": "cpu", "mem_limit_bytes": 8 << 30,
               "compile_options_hex": b'{"arch":"sm_80"}'.hex()}
    if request_kind == "aot":
        options.update(mesh_shape=[2, 2], device_count=4)
    if request_kind == "autotune":
        options = {"backend": "cpu", "mem_limit_bytes": 8 << 30,
                   "autotune_configs": [{"BLOCK": b} for b in (32, 64,
                                                                128)]}
    got = {}
    for name, module in (("jax", "yadcc_tpu.jit.compile_worker"),
                         ("port", "yadcc_tpu_torch.jit.compile_worker")):
        ws = tmp_path / name
        _stage_request(ws, options, SRC)
        got[name] = _run_worker(module, ws, "--fake")
    assert got["port"] == got["jax"]
    assert got["port"][0] == 0 and got["port"][2]


@pytest.fixture
def stub_nvcc(tmp_path, monkeypatch):
    """A stub nvcc first on PATH; returns the file its runs log to."""
    bindir = tmp_path / "stubbin"
    bindir.mkdir()
    (bindir / "nvcc").write_text(STUB_NVCC)
    (bindir / "nvcc").chmod(0o755)
    log = tmp_path / "nvcc.log"
    monkeypatch.setenv("PATH", f"{bindir}{os.pathsep}{os.environ['PATH']}")
    monkeypatch.setenv("STUB_NVCC_LOG", str(log))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    return log


def _real_build(tmp_path, options: dict, payload: bytes = SRC,
                name: str = "ws"):
    ws = tmp_path / name
    _stage_request(ws, dict({"backend": "cuda", "mem_limit_bytes": 0},
                            **options), payload)
    rc, out, data = _run_worker("yadcc_tpu_torch.jit.compile_worker", ws,
                                env=dict(os.environ, PYTHONPATH=REPO))
    return rc, out, data, ws


def _runs(log) -> list:
    return [json.loads(line) for line in open(log)] if log.exists() else []


@pytest.mark.parametrize("case", [
    ("empty", b"", None),
    ("sm_80", b'{"arch":"sm_80"}', ["-gencode", "arch=compute_80,code=sm_80"]),
    ("sm_90", b'{"arch":"sm_90","opt":1}',
     ["-gencode", "arch=compute_90,code=sm_90", "-std=c++17", "-O1"]),
    ("flags", tworker.options_json(std="c++20", fast_math=True,
                                   lineinfo=True,
                                   defines={"N": 4, "TAG": "a.b"}),
     ["-std=c++20", "-use_fast_math", "-lineinfo", "-DN=4", "-DTAG=a.b"]),
    ("comma", tworker.options_json(defines={"PAIR": "1,2"}),
     ["-DPAIR=1\\,2"]),
])
def test_real_mode_argv_from_options(tmp_path, stub_nvcc, case):
    name, raw, want = case
    rc, out, data, ws = _real_build(
        tmp_path, {"compile_options_hex": raw.hex()})
    assert rc == 0, out
    assert data == b"STUBLIB" + SRC
    (run,) = _runs(stub_nvcc)
    argv = run["argv"]
    assert argv[-3:] == ["-o", f"{ws}/lib.so", f"{ws}/src.cu"]
    if want is None:
        assert tuple(argv[:-3]) == _build.NVCC_FLAGS
    else:
        for flag in want:
            assert flag in argv, (flag, argv)
    assert run["tmpdir"] == str(ws) and run["cwd"] == str(ws)
    assert out.startswith(b"built ")
    assert sorted(os.listdir(ws)) == ["artifact.bin", "request.bin",
                                      "src.cu"]


def test_real_mode_topology_macros_and_arch(tmp_path, stub_nvcc):
    rc, _, _, _ = _real_build(tmp_path, {
        "compile_options_hex": b'{"arch":"sm_80"}'.hex(),
        "mesh_shape": [2, 4], "device_count": 8})
    assert rc == 0
    (run,) = _runs(stub_nvcc)
    assert run["argv"][:2] == ["-gencode", "arch=compute_80,code=sm_80"]
    assert "-DYTPU_DEVICE_COUNT=8" in run["argv"]
    # nvcc splits option values at commas: the comma goes escaped.
    assert "-DYTPU_MESH_SHAPE=2\\,4" in run["argv"]


@pytest.mark.parametrize("raw", [
    b'{"arch":"sm_75"}', b'{"flags":"-rdc=true"}', b'{"opt":4}',
    b'{"opt":true}', b'{"defines":{"X":"a b"}}', b'{"defines":{"1X":1}}',
    b'{"defines":{"YTPU_DEVICE_COUNT":2}}', b'{"std":"gnu++17"}',
    b'{"fast_math":"yes"}', b'[1]', b'not json'])
def test_unknown_option_is_a_build_failure(tmp_path, stub_nvcc, raw):
    rc, out, data, _ = _real_build(tmp_path,
                                   {"compile_options_hex": raw.hex()})
    assert rc == 1 and data is None
    assert _runs(stub_nvcc) == []  # nvcc never ran


def test_real_mode_compile_error_and_sweep(tmp_path, stub_nvcc):
    rc, _, data, ws = _real_build(tmp_path, {},
                                  SRC + b"#error smoke\n", "err")
    assert rc == 1 and data is None
    rc, out, data, _ = _real_build(
        tmp_path, {"autotune_configs": [{"B": b} for b in (1, 2, 3)]},
        b"// {B}\n" + SRC, "tune")
    assert rc == 0
    record = json.loads(data)
    assert record["evaluated"] == 3 and record["metric"] == \
        "neg_compile_seconds" and record["score"] < 0
    assert record["config"] in [{"B": b} for b in (1, 2, 3)]
    assert [r["argv"][-1].endswith("src.cu") for r in _runs(stub_nvcc)] \
        == [True] * 4


def test_environment_from_stub_nvcc(stub_nvcc):
    env = tenv.local_jit_environment()
    assert env == tenv.JitEnvironment("cuda", STUB_RELEASE)
    assert tenv.default_jit_environments() == [env]
    assert env.digest == jenv.jit_env_digest("cuda", STUB_RELEASE)


def test_no_nvcc_serves_no_environment(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "none"))
    if os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("this host has /usr/local/cuda/bin/nvcc")
    assert tenv.default_jit_environments() == []


# -- the servant: gating, heartbeat, lease expiry ----------------------------


def _services(tmp_path, monkeypatch):
    monkeypatch.setenv("YTPU_JIT_FAKE_WORKER", "1")
    from yadcc_tpu.daemon.cloud.compiler_registry import \
        CompilerRegistry as JRegistry
    from yadcc_tpu.daemon.cloud.daemon_service import \
        DaemonService as JService
    from yadcc_tpu.daemon.cloud.execution_engine import \
        ExecutionEngine as JEngine
    from yadcc_tpu.daemon.config import DaemonConfig as JConfig
    from yadcc_tpu_torch.daemon.cloud.compiler_registry import \
        CompilerRegistry as TRegistry
    from yadcc_tpu_torch.daemon.cloud.daemon_service import \
        DaemonService as TService
    from yadcc_tpu_torch.daemon.cloud.execution_engine import \
        ExecutionEngine as TEngine
    from yadcc_tpu_torch.daemon.config import DaemonConfig as TConfig

    out = {}
    for name, Svc, Eng, Reg, Cfg, env in (
            ("jax", JService, JEngine, JRegistry, JConfig, JENV),
            ("port", TService, TEngine, TRegistry, TConfig, TENV)):
        (tmp_path / name).mkdir()
        engine = Eng(max_concurrency=2, min_memory_for_new_task=1)
        svc = Svc(Cfg(temporary_dir=str(tmp_path / name)), engine=engine,
                  registry=Reg(extra_dirs=[str(tmp_path / "nobin")]),
                  cgroup_present=False, jit_environments=[env])
        svc.set_acceptable_tokens_for_testing({"tkn"})
        out[name] = svc
    return out


def _gate_requests():
    """(name, method, api module attr, request builder, attachment)."""
    good = JENV.digest
    bad = jenv.jit_env_digest("cpu", "some-other-jaxlib")
    cases = []

    def jit(api, env, claimed=""):
        req = api.jit.QueueJitCompilationTaskRequest(
            token="tkn", task_grant_id=7,
            computation_digest=claimed or digest_bytes(SRC), backend="cpu",
            compression_algorithm=api.daemon.COMPRESSION_ALGORITHM_ZSTD)
        req.env_desc.compiler_digest = env
        return req

    def aot(api, env, count=1, shape=(1,)):
        req = api.fanout.QueueAotCompilationTaskRequest(
            token="tkn", task_grant_id=8,
            computation_digest=digest_bytes(SRC), backend="cpu",
            compression_algorithm=api.daemon.COMPRESSION_ALGORITHM_ZSTD)
        req.env_desc.compiler_digest = env
        req.topology.device_count = count
        req.topology.mesh_shape.extend(shape)
        return req

    def tune(api, env, configs=('{"B":1}',)):
        req = api.fanout.QueueAutotuneTaskRequest(
            token="tkn", task_grant_id=9, kernel_digest=digest_bytes(SRC),
            backend="cpu",
            compression_algorithm=api.daemon.COMPRESSION_ALGORITHM_ZSTD)
        req.env_desc.compiler_digest = env
        req.configs.extend(configs)
        return req

    z = None  # compressed SRC, per package
    cases.append(("version-mismatch", "QueueJitCompilationTask",
                  lambda a: jit(a, bad), z))
    cases.append(("forged-digest", "QueueJitCompilationTask",
                  lambda a: jit(a, good, "0" * 64), z))
    cases.append(("garbage", "QueueJitCompilationTask",
                  lambda a: jit(a, good), b"not zstd at all"))
    cases.append(("aot-version", "QueueAotCompilationTask",
                  lambda a: aot(a, bad), z))
    cases.append(("aot-no-topology", "QueueAotCompilationTask",
                  lambda a: aot(a, good, 0, ()), z))
    cases.append(("tune-garbage", "QueueAutotuneTask",
                  lambda a: tune(a, good), b"\x00garbage"))
    cases.append(("tune-bad-config", "QueueAutotuneTask",
                  lambda a: tune(a, good, ("[1, 2]",)), z))
    cases.append(("tune-empty", "QueueAutotuneTask",
                  lambda a: tune(a, good, ()), z))
    return cases


def test_servant_gating_answers_alike(tmp_path, monkeypatch):
    from yadcc_tpu.rpc import RpcError as JError
    from yadcc_tpu_torch.rpc import RpcError as TError

    svcs = _services(tmp_path, monkeypatch)
    try:
        for name, method, build, att in _gate_requests():
            got = {}
            for pkg, api, comp, err in (
                    ("jax", japi, jcompress, JError),
                    ("port", tapi, tcompress, TError)):
                with pytest.raises(err) as exc:
                    getattr(svcs[pkg], method)(
                        build(api), att if att is not None
                        else comp.compress(SRC), None)
                got[pkg] = exc.value.status
            assert got["port"] == got["jax"], name
            want = (tapi.daemon.DAEMON_STATUS_ENVIRONMENT_NOT_AVAILABLE
                    if "version" in name else
                    tapi.daemon.DAEMON_STATUS_INVALID_ARGUMENT)
            assert got["port"] == want, name
        # Nothing staged survives a refusal.
        for pkg in ("jax", "port"):
            assert os.listdir(tmp_path / pkg) == []
    finally:
        for svc in svcs.values():
            svc.engine.stop()


def test_heartbeat_carries_the_jit_environment(tmp_path, monkeypatch):
    svcs = _services(tmp_path, monkeypatch)
    sent = {}

    class Chan:
        def __init__(self, name, api):
            self.name, self.api = name, api

        def call(self, service, method, req, resp_cls, **kw):
            compilers = set(svcs[self.name].registry.environments())
            sent[self.name] = [e.compiler_digest for e in req.env_descs
                               if e.compiler_digest not in compilers]
            return resp_cls(), b""

    try:
        for name, api in (("jax", japi), ("port", tapi)):
            svcs[name]._scheduler = (lambda c=Chan(name, api): c)
            svcs[name].heartbeat_once()
        assert sent["port"] == sent["jax"] == [JENV.digest]
        (envs,) = [svcs["port"].inspect()["jit_environments"]]
        assert envs == [{"backend": TENV.backend,
                         "toolchain_version": TENV.toolchain_version,
                         "digest": JENV.digest}]
    finally:
        for svc in svcs.values():
            svc.engine.stop()


def test_lease_expiry_kills_build_no_workspace_leak(tmp_path, monkeypatch):
    monkeypatch.setenv("YTPU_JIT_FAKE_WORKER", "1")
    monkeypatch.setenv("YTPU_JIT_FAKE_SLEEP_S", "60")
    from yadcc_tpu_torch.daemon.cloud.execution_engine import \
        ExecutionEngine
    from yadcc_tpu_torch.daemon.cloud.jit_task import \
        CloudJitCompilationTask

    task = CloudJitCompilationTask(
        env_digest=TENV.digest, backend="cpu", compile_options=b"",
        claimed_computation_digest=digest_bytes(SRC),
        temp_root=str(tmp_path))
    task.prepare(tcompress.compress(SRC))
    ws = task.workspace.path
    assert os.path.isdir(ws) and task.worker_env()["TMPDIR"] == ws
    engine = ExecutionEngine(max_concurrency=1, min_memory_for_new_task=1)
    done = threading.Event()
    outputs = {}

    def on_completion(task_id, output):
        outputs["files"], _, outputs["entry"] = task.collect_outputs(output)
        outputs["exit_code"] = output.exit_code
        done.set()

    try:
        tid = engine.try_queue_task(
            grant_id=42, digest=task.task_digest, cmdline=task.cmdline,
            on_completion=on_completion, env=task.worker_env(), cwd=ws)
        assert tid is not None
        time.sleep(1.0)
        engine.kill_expired_tasks([42])
        assert done.wait(timeout=20), "waiter never fired after SIGKILL"
        assert outputs["exit_code"] != 0
        assert outputs["files"] == {} and outputs["entry"] is None
        assert not os.path.exists(ws), "workspace leaked after kill"
        assert os.listdir(tmp_path) == []
    finally:
        engine.stop()


# -- both rigs, end to end ----------------------------------------------------


def _join_pack_pools() -> None:
    import yadcc_tpu.daemon.cloud.cxx_task as jcloud
    import yadcc_tpu_torch.daemon.cloud.cxx_task as tcloud

    tcloud.shutdown_pack_executor()
    pool = jcloud._PACK_EXECUTOR._pool
    jcloud._PACK_EXECUTOR._pool = None
    if pool is not None:
        pool.shutdown(wait=True)


@pytest.fixture(scope="module")
def rigs(tmp_path_factory):
    """Both packages' rigs, two servants each, the fake worker and the
    fake compiler; the port's servants serve the JAX rig's environment
    strings."""
    old = os.environ.get("YTPU_JIT_FAKE_WORKER")
    os.environ["YTPU_JIT_FAKE_WORKER"] = "1"
    tmp = tmp_path_factory.mktemp("jit_rigs")
    fake = make_fake_compiler(str(tmp / "fake" / "tc"))
    dirs = [str(tmp / "fake" / "tc")]
    (tmp / "jax").mkdir()
    (tmp / "port").mkdir()
    jax = JCluster(tmp / "jax", n_servants=2, compiler_dirs=dirs)
    try:
        port = TCluster(tmp / "port", n_servants=2, device="cpu",
                        compiler_dirs=dirs, jit_environments=[TENV])
    except BaseException:
        jax.stop()
        raise
    try:
        yield {"jax": jax, "port": port, "fake": fake, "tmp": tmp}
    finally:
        port.stop()
        jax.stop()
        _join_pack_pools()
        if old is None:
            os.environ.pop("YTPU_JIT_FAKE_WORKER", None)
        else:
            os.environ["YTPU_JIT_FAKE_WORKER"] = old


def jit_task(pkg: str, src: bytes = SRC, cache_control: int = 1,
             compile_options: bytes = b""):
    if pkg == "jax":
        from yadcc_tpu.daemon.local.jit_task import JitCompilationTask

        return JitCompilationTask(
            requestor_pid=1, computation_digest=digest_bytes(src),
            compile_options=compile_options, backend=JENV.backend,
            jaxlib_version=JENV.jaxlib_version,
            cache_control=cache_control,
            compressed_computation=jcompress.compress(src))
    from yadcc_tpu_torch.daemon.local.jit_task import JitCompilationTask

    return JitCompilationTask(
        requestor_pid=1, computation_digest=digest_bytes(src),
        compile_options=compile_options, backend=TENV.backend,
        toolchain_version=TENV.toolchain_version,
        cache_control=cache_control,
        compressed_computation=tcompress.compress(src))


def submit(delegate, task, timeout_s: float = 60.0):
    tid = delegate.queue_task(task)
    result = delegate.wait_for_task(tid, timeout_s)
    delegate.free_task(tid)
    return result


def servant_runs(rig) -> int:
    return sum(s.engine.tasks_run_ever for s in rig.servants)


def cache_entry(rig, key: str) -> bytes:
    """The rig's cache server's entry under ``key`` (polled: fills are
    asynchronous)."""
    from yadcc_tpu_torch.rpc import Channel, RpcError

    ch = Channel(rig.cache_uri)
    deadline = time.monotonic() + 20
    while True:
        try:
            _, value = ch.call("ytpu.CacheService", "TryGetEntry",
                               tapi.cache.TryGetEntryRequest(key=key),
                               tapi.cache.TryGetEntryResponse, timeout=5.0)
            return bytes(value)
        except RpcError:
            assert time.monotonic() < deadline, f"{key} never filled"
            time.sleep(0.05)


def until_from_cache(reader, delegate, make, attempts: int = 40):
    """sync, submit, until the submission is served from the cache."""
    for _ in range(attempts):
        reader.sync_once()
        r = submit(delegate, make())
        if r is not None and r.from_cache:
            return r
        time.sleep(0.25)
    return None


def result_bytes(r) -> tuple:
    return (r.exit_code, bytes(r.standard_output), bytes(r.standard_error),
            {k: bytes(v) for k, v in r.files.items()})


def test_same_source_same_artifact_and_entry_then_a_second_delegate_hits(
        rigs):
    src = b"// both rigs\n" + SRC
    got = {pkg: submit(rigs[pkg].delegate, jit_task(pkg, src))
           for pkg in ("jax", "port")}
    assert result_bytes(got["port"]) == result_bytes(got["jax"])
    art = tcompress.decompress(bytes(got["port"].files[".xla"]))
    assert art.startswith(b"FAKEXLA1")
    key = tcache.get_jit_cache_key(TENV.digest, b"", digest_bytes(src))
    assert cache_entry(rigs["port"], key) == cache_entry(rigs["jax"], key)

    rig = rigs["port"]
    runs0 = servant_runs(rig)
    d2 = rig.make_extra_delegate()
    r2 = until_from_cache(rig.cache_reader, d2,
                          lambda: jit_task("port", src))
    assert r2 is not None, "the second delegate never hit the cache"
    assert tcompress.decompress(bytes(r2.files[".xla"])) == art
    assert servant_runs(rig) == runs0
    assert d2.inspect()["stats_by_kind"]["jit"]["hit_cache"] >= 1


def test_concurrent_identical_submissions_build_once(rigs, monkeypatch):
    monkeypatch.setenv("YTPU_JIT_FAKE_SLEEP_S", "4.0")
    rig = rigs["port"]
    src = b"// herd\n" + SRC
    d2 = rig.make_extra_delegate()
    runs0 = servant_runs(rig)

    def stats(d):
        return d.inspect()["stats_by_kind"].get(
            "jit", {"actually_run": 0, "reused": 0})

    before = [stats(rig.delegate), stats(d2)]
    results = {}

    def go(name, delegate, delay):
        time.sleep(delay)
        results[name] = submit(delegate, jit_task("port", src, 0))

    threads = [threading.Thread(target=go, args=("a", rig.delegate, 0.0)),
               threading.Thread(target=go, args=("b", d2, 2.5))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=90)
    assert results["a"].exit_code == 0 and results["b"].exit_code == 0
    assert result_bytes(results["a"])[3] == result_bytes(results["b"])[3]
    assert servant_runs(rig) == runs0 + 1
    after = [stats(rig.delegate), stats(d2)]
    assert sum(a["actually_run"] - b["actually_run"]
               for a, b in zip(after, before)) == 1
    assert sum(a["reused"] - b["reused"]
               for a, b in zip(after, before)) == 1


def test_cxx_and_jit_mixed_through_one_delegate(rigs):
    from yadcc_tpu_torch.daemon.local.cxx_task import CxxCompilationTask

    rig = rigs["port"]
    src = b"int mixed_workload();"
    r_cxx = submit(rig.delegate, CxxCompilationTask(
        requestor_pid=1, source_path="/src/mix.cc",
        source_digest=digest_bytes(src), invocation_arguments="-O2",
        cache_control=0, compiler_digest=digest_file(rigs["fake"]),
        compressed_source=tcompress.compress(src)))
    r_jit = submit(rig.delegate, jit_task("port", b"// mix\n" + SRC, 0))
    assert r_cxx.exit_code == 0 and r_jit.exit_code == 0
    snap = rig.delegate.inspect()
    by_kind = snap["stats_by_kind"]
    assert by_kind["cxx"]["actually_run"] >= 1
    assert by_kind["jit"]["actually_run"] >= 1
    for counter, total in snap["stats"].items():
        assert total == sum(v[counter] for v in by_kind.values())


def _jit_body(api, with_env: bool, src: bytes = SRC) -> bytes:
    req = api.jit.SubmitJitTaskRequest(
        requestor_process_id=1, computation_digest=digest_bytes(src),
        backend=JENV.backend, cache_control=0)
    if with_env:
        req.jaxlib_version = JENV.jaxlib_version
    return multi_chunk.make_multi_chunk([
        json_format.MessageToJson(req).encode(),
        tcompress.compress(src)])


def _http_script(rig, api) -> list:
    port = rig.http.port
    out = [post_local(port, "/local/submit_jit_task",
                      _jit_body(api, False)),
           post_local(port, "/local/submit_jit_task", b"garbage"),
           post_local(port, "/local/jit_cache_get",
                      json_format.MessageToJson(api.jit.JitCacheGetRequest(
                          key="never-put")).encode()),
           post_local(port, "/local/jit_cache_put", b"one chunk")]
    status, data = post_local(port, "/local/submit_jit_task",
                              _jit_body(api, True, b"// http\n" + SRC))
    out.append((status, sorted(json.loads(data))))
    tid = int(json.loads(data)["task_id"])
    deadline = time.monotonic() + 60
    while True:
        wreq = api.jit.WaitForJitTaskRequest(task_id=tid,
                                             milliseconds_to_wait=1000)
        status, data = post_local(port, "/local/wait_for_jit_task",
                                  json_format.MessageToJson(wreq).encode())
        if status != 503 or time.monotonic() > deadline:
            break
    chunks = multi_chunk.try_parse_multi_chunk(data)
    out.append((status, bytes(chunks[0]), [bytes(c) for c in chunks[1:]]))
    out.append(post_local(port, "/local/wait_for_jit_task",
                          json_format.MessageToJson(wreq).encode()))
    return out


def test_http_routes_answer_alike(rigs):
    """400 without an environment, then 200 with it; 400 on bad
    chunking; the shim's miss and malformed put; the wait's 200 reply
    and then 404: equal from both packages' delegates."""
    got = {pkg: _http_script(rigs[pkg], api)
           for pkg, api in (("jax", japi), ("port", tapi))}
    assert got["port"] == got["jax"]
    assert [r[0] for r in got["port"]] == [400, 400, 404, 400, 200, 200,
                                           404]
    assert b"jit environment" in got["port"][0][1]


def test_cache_shim_round_trip_across_delegates(rigs, monkeypatch):
    """A 64 KiB put through the port's client and delegate is read back
    byte-equal through another delegate's HTTP service on the same
    cache; the entry is the JAX shim's key."""
    from yadcc_tpu_torch.client import daemon_call
    from yadcc_tpu_torch.jit.cache_shim import ClusterCompileCache

    rig = rigs["port"]
    value = np.random.default_rng(7).integers(
        0, 256, 64 << 10, dtype=np.uint8).tobytes()
    daemon_call.set_daemon_call_handler(None)
    monkeypatch.setenv("YTPU_DAEMON_PORT", str(rig.http.port))
    shim = ClusterCompileCache()
    assert shim.get("shim-key") is None
    shim.put("shim-key", value)
    assert cache_entry(rig, jhttp.shim_cache_key("shim-key")) == value
    svc, dispatcher, config, reader = _foreign_delegate("port", rig)
    try:
        monkeypatch.setenv("YTPU_DAEMON_PORT", str(svc.port))
        got = None
        for _ in range(40):
            reader.sync_once()
            got = shim.get("shim-key")
            if got is not None:
                break
            time.sleep(0.25)
        assert got == value
    finally:
        _stop_foreign(svc, dispatcher, config, reader)


@pytest.mark.parametrize("seed", range(3))
def test_jit_knobs_equal(seed, monkeypatch):
    rng = np.random.default_rng(seed)
    values = ["", "0", "1", "2", "-1", "abc", "1.5", "30", "0.25", " 1"]
    for _ in range(8):
        for name in ("YTPU_JIT_OFFLOAD", "YTPU_JIT_TIMEOUT_S",
                     "YTPU_JIT_LOCAL_FALLBACK"):
            v = values[int(rng.integers(len(values)))]
            if v == "":
                monkeypatch.delenv(name, raising=False)
            else:
                monkeypatch.setenv(name, v)
        for fn in ("jit_offload_enabled", "jit_timeout_s",
                   "jit_local_fallback"):
            assert getattr(tenv_options, fn)() == \
                getattr(jenv_options, fn)(), fn


def _foreign_delegate(kind: str, rig):
    """A delegate of package ``kind`` with its HTTP service (the shim
    wired), dialing the rig's scheduler, servants and cache."""
    if kind == "port":
        from yadcc_tpu_torch.daemon.cloud.distributed_cache_writer import \
            DistributedCacheWriter as Writer
        from yadcc_tpu_torch.daemon.local.config_keeper import \
            ConfigKeeper as Config
        from yadcc_tpu_torch.daemon.local.distributed_cache_reader import \
            DistributedCacheReader as Reader
        from yadcc_tpu_torch.daemon.local.distributed_task_dispatcher \
            import DistributedTaskDispatcher as Dispatcher
        from yadcc_tpu_torch.daemon.local.file_digest_cache import \
            FileDigestCache as Digests
        from yadcc_tpu_torch.daemon.local.http_service import \
            LocalHttpService as Http
        from yadcc_tpu_torch.daemon.local.local_task_monitor import \
            LocalTaskMonitor as Monitor
        from yadcc_tpu_torch.daemon.local.task_grant_keeper import \
            TaskGrantKeeper as Keeper
        reader = Reader(rig.cache_uri, "", device="cpu")
    else:
        from yadcc_tpu.daemon.cloud.distributed_cache_writer import \
            DistributedCacheWriter as Writer
        from yadcc_tpu.daemon.local.config_keeper import \
            ConfigKeeper as Config
        from yadcc_tpu.daemon.local.distributed_cache_reader import \
            DistributedCacheReader as Reader
        from yadcc_tpu.daemon.local.distributed_task_dispatcher import \
            DistributedTaskDispatcher as Dispatcher
        from yadcc_tpu.daemon.local.file_digest_cache import \
            FileDigestCache as Digests
        from yadcc_tpu.daemon.local.http_service import \
            LocalHttpService as Http
        from yadcc_tpu.daemon.local.local_task_monitor import \
            LocalTaskMonitor as Monitor
        from yadcc_tpu.daemon.local.task_grant_keeper import \
            TaskGrantKeeper as Keeper
        reader = Reader(rig.cache_uri, "", use_device_cascade=False)
    config = Config(rig.sched_uri, "")
    config.start()
    reader.start()
    writer = Writer(rig.cache_uri, lambda: "")
    dispatcher = Dispatcher(grant_keeper=Keeper(rig.sched_uri, ""),
                            config_keeper=config, cache_reader=reader,
                            cache_writer=writer)
    svc = Http(monitor=Monitor(nprocs=8, pid_prober=lambda p: True),
               digest_cache=Digests(), dispatcher=dispatcher, port=0,
               cache_reader=reader, cache_writer=writer)
    svc.start()
    return svc, dispatcher, config, reader


def _stop_foreign(svc, dispatcher, config, reader) -> None:
    svc.stop()
    dispatcher.stop()
    config.stop()
    reader.stop()


def test_cross_package_pairs_build_the_same(rigs):
    """The port's delegate on the JAX rig's servants, the JAX delegate on
    the port's: the same source builds to the same result as each rig's
    own delegate gives, and then reads back from the cache."""
    src = b"// cross\n" + SRC
    want = result_bytes(submit(rigs["jax"].delegate,
                               jit_task("jax", src, 0)))
    for name, (kind, rig_name) in {"port-on-jax": ("port", "jax"),
                                   "jax-on-port": ("jax", "port")}.items():
        rig = rigs[rig_name]
        runs0 = servant_runs(rig)
        svc, dispatcher, config, reader = _foreign_delegate(kind, rig)
        try:
            got = submit(dispatcher, jit_task(kind, src, 2))  # refill
            assert result_bytes(got) == want, name
            assert servant_runs(rig) == runs0 + 1, name
            hit = until_from_cache(reader, dispatcher,
                                   lambda: jit_task(kind, src))
            assert hit is not None and result_bytes(hit)[3] == want[3], \
                name
        finally:
            _stop_foreign(svc, dispatcher, config, reader)


def test_frontend_build_library_and_its_fallback(rigs, tmp_path,
                                                 monkeypatch, stub_nvcc):
    """build_library through the port's rig writes the farm's artifact
    under _build/; with the daemon gone it builds locally with nvcc (the
    stub, with _build.NVCC_FLAGS) or raises when
    YTPU_JIT_LOCAL_FALLBACK=0."""
    from yadcc_tpu_torch.client import daemon_call
    from yadcc_tpu_torch.jit import frontend

    daemon_call.set_daemon_call_handler(None)
    monkeypatch.setenv("YTPU_DAEMON_PORT", str(rigs["port"].http.port))
    monkeypatch.setenv("YTPU_JIT_OFFLOAD", "1")
    monkeypatch.setattr(frontend, "BUILD_DIR", tmp_path / "_build")
    env = dict(backend=TENV.backend,
               toolchain_version=TENV.toolchain_version)
    src = b"// frontend\n" + SRC
    lib = frontend.build_library(src, name="probe", **env)
    assert lib.remote and lib.path.parent == tmp_path / "_build"
    data = lib.path.read_bytes()
    assert data.startswith(b"FAKEXLA1") and os.fspath(lib) == str(lib.path)
    assert "compiled" in lib.output
    assert _runs(stub_nvcc) == []

    out = frontend.offload_compile(src, **env)
    assert out.ok and out.library == data

    monkeypatch.setenv("YTPU_DAEMON_PORT", "1")  # no daemon there
    monkeypatch.setenv("YTPU_JIT_LOCAL_FALLBACK", "0")
    with pytest.raises(RuntimeError, match="local fallback is disabled"):
        frontend.build_library(src)
    monkeypatch.setenv("YTPU_JIT_LOCAL_FALLBACK", "1")
    local = frontend.build_library(src, name="probe")
    assert not local.remote and local.path.read_bytes() == b"STUBLIB" + src
    assert tuple(_runs(stub_nvcc)[0]["argv"][:-3]) == _build.NVCC_FLAGS
