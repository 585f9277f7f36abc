"""The delegate's parts held against the JAX package's: the same inputs,
made from a numpy seed, through both packages' fair grant queue, local
task monitor, file digest memo, the grant keeper's home-cell pick and
its grant requests, the C++ task (cache key, digest, the
QueueCxxCompilationTask request, the servant-output and cache-entry
parsers), the registry's wait response, and the failover channel under
the same injected faults.  The tolerance is exact: these are byte and
decision outcomes.  One case holds where the port's scheduler differs
by design: which of two delegates' requests a freed slot goes to."""

from __future__ import annotations

import threading
import time

import numpy as np
import pytest

import yadcc_tpu.api as japi
import yadcc_tpu.rpc as jrpc
import yadcc_tpu.rpc.transport as jtransport
from yadcc_tpu.daemon import cache_format as jformat
from yadcc_tpu.daemon.local import cxx_task as jcxx
from yadcc_tpu.daemon.local import http_service as jhttp
from yadcc_tpu.daemon.local.fair_admission import \
    FairGrantQueue as JQueue
from yadcc_tpu.daemon.local.file_digest_cache import \
    FileDigestCache as JDigests
from yadcc_tpu.daemon.local.local_task_monitor import \
    LocalTaskMonitor as JMonitor
from yadcc_tpu.daemon.local.task_grant_keeper import \
    TaskGrantKeeper as JKeeper
from yadcc_tpu.daemon.local.task_registry import \
    default_registry as jregistry
import yadcc_tpu_torch.api as tapi
import yadcc_tpu_torch.rpc as trpc
import yadcc_tpu_torch.rpc.transport as ttransport
from yadcc_tpu_torch.common import compress as tcompress
from yadcc_tpu_torch.common.hashing import digest_bytes
from yadcc_tpu_torch.daemon import cache_format as tformat
from yadcc_tpu_torch.daemon import packing as tpacking
from yadcc_tpu_torch.daemon.local import cxx_task as tcxx
from yadcc_tpu_torch.daemon.local import http_service as thttp
from yadcc_tpu_torch.daemon.local.fair_admission import \
    FairGrantQueue as TQueue
from yadcc_tpu_torch.daemon.local.file_digest_cache import \
    FileDigestCache as TDigests
from yadcc_tpu_torch.daemon.local.local_task_monitor import \
    LocalTaskMonitor as TMonitor
from yadcc_tpu_torch.daemon.local.task_grant_keeper import \
    TaskGrantKeeper as TKeeper
from yadcc_tpu_torch.daemon.local.task_registry import \
    default_registry as tregistry

SEEDS = (0, 1, 2)


def _hex(rng, n=64) -> str:
    return "".join("0123456789abcdef"[int(v)] for v in rng.integers(0, 16, n))


# -- the fair grant queue -----------------------------------------------------


def _fair_script(seed: int) -> list:
    """A seeded interleaving of gets (client key, weight, tenant, tenant
    weight) and puts, with the clock's advance before each op; every get
    is served by the end."""
    rng = np.random.default_rng(seed)
    ops, gets, puts = [], 0, 0
    for _ in range(60):
        dt = float(rng.choice([0.0, 0.5, 700.0], p=[0.7, 0.25, 0.05]))
        if rng.random() < 0.55:
            tenant = ["", "t1", "t2"][int(rng.integers(0, 3))]
            ops.append(("get", dt, str(int(rng.integers(0, 4))),
                        float(rng.choice([0.5, 1.0, 2.0])), tenant,
                        float(rng.choice([1.0, 3.0]))))
            gets += 1
        else:
            ops.append(("put", dt, puts))
            puts += 1
    for i in range(puts, max(puts, gets)):
        ops.append(("put", 0.0, i))
    return ops


def _run_fair(queue_cls, ops) -> tuple:
    clock = [0.0]
    q = queue_cls(time_fn=lambda: clock[0])
    got, threads = {}, []
    n_gets = n_puts = 0
    for i, op in enumerate(ops):
        clock[0] += op[1]
        if op[0] == "put":
            q.put(op[2])
            n_puts += 1
        else:
            _, _, key, weight, tenant, tenant_weight = op

            def get(i=i, key=key, weight=weight, tenant=tenant,
                    tenant_weight=tenant_weight):
                got[i] = q.get(key, weight, timeout_s=1e9, tenant=tenant,
                               tenant_weight=tenant_weight)

            t = threading.Thread(target=get, daemon=True)
            t.start()
            threads.append(t)
            n_gets += 1
        # Settled: every get registered, matched or still waiting.
        deadline = time.monotonic() + 10
        while q.waiter_count() + (n_puts - q.qsize()) != n_gets:
            assert time.monotonic() < deadline, "a get never registered"
            time.sleep(0.0005)
    for t in threads:
        t.join(timeout=10)
        assert not t.is_alive()
    return got, q.share_counts(), q.tenant_share_counts(), q.qsize()


@pytest.mark.parametrize("seed", SEEDS)
def test_fair_queues_hand_out_in_the_same_order(seed):
    ops = _fair_script(seed)
    want = _run_fair(JQueue, ops)
    assert _run_fair(TQueue, ops) == want
    assert len(want[0]) == sum(op[0] == "get" for op in ops)


def test_closed_fair_queue_keeps_items_for_drain():
    for cls in (JQueue, TQueue):
        q = cls(time_fn=lambda: 0.0)
        q.close()
        q.put("g1")
        assert q.get("a", timeout_s=0.01) is None
        assert q.drain() == ["g1"] and q.qsize() == 0


# -- the local task monitor ---------------------------------------------------


@pytest.mark.parametrize("seed", SEEDS)
def test_monitors_grant_deny_and_reclaim_alike(seed):
    rng = np.random.default_rng(seed)
    dead = set()
    heavy = int(rng.integers(0, 3))
    monitors = {name: cls(nprocs=4, pid_prober=lambda p: p not in dead,
                          max_heavy_tasks=heavy)
                for name, cls in (("jax", JMonitor), ("port", TMonitor))}
    out = {k: [] for k in monitors}
    for _ in range(80):
        op = rng.random()
        pid = int(rng.integers(1, 6))
        if op < 0.05:
            dead.add(pid)
        elif op < 0.1:
            dead.discard(pid)
        for name, m in monitors.items():
            if op < 0.1:
                out[name].append(("reclaim", m.on_reclaim_timer()))
            elif op < 0.6:
                light = bool(pid % 2)
                out[name].append((
                    "acquire", pid,
                    m.wait_for_running_new_task_permission(pid, light,
                                                           0.0)))
            else:
                m.drop_task_permission(pid)
            state = m.inspect()
            state.pop("parked_waiters", None)
            out[name].append(state)
    assert out["port"] == out["jax"]
    verdicts = [e[2] for e in out["jax"]
                if isinstance(e, tuple) and e[0] == "acquire"]
    assert True in verdicts and False in verdicts


# -- the file digest memo -----------------------------------------------------


@pytest.mark.parametrize("seed", SEEDS)
def test_file_digest_caches_equal(seed):
    rng = np.random.default_rng(seed)
    caches = {"jax": JDigests(capacity=8), "port": TDigests(capacity=8)}
    out = {k: [] for k in caches}
    for _ in range(200):
        key = (f"/usr/bin/g++-{int(rng.integers(0, 12))}",
               int(rng.integers(1, 3)), int(rng.integers(0, 2)))
        digest = _hex(rng)
        setting = rng.random() < 0.4
        for name, c in caches.items():
            if setting:
                c.set(*key, digest)
            else:
                out[name].append(c.try_get(*key))
    assert out["port"] == out["jax"]
    assert caches["port"].inspect() == caches["jax"].inspect()
    assert any(v is not None for v in out["jax"])


# -- the grant keeper's home cell ---------------------------------------------


def test_grant_keepers_pick_the_same_home_cell():
    uri = ("grpc://10.0.0.1:8336,grpc://10.0.0.2:8336;grpc://10.0.1.1:8336;"
           "grpc://10.0.2.1:8336")
    keepers = {"jax": JKeeper(uri, "tok"), "port": TKeeper(uri, "tok")}
    rng = np.random.default_rng(7)
    digests = [_hex(rng) for _ in range(1000)]
    try:
        picks = {name: [int(k._ring.pick(d)) for d in digests]
                 for name, k in keepers.items()}
        assert picks["port"] == picks["jax"]
        assert set(picks["jax"]) == {0, 1, 2}
        assert keepers["port"]._cell_uris == keepers["jax"]._cell_uris
    finally:
        for k in keepers.values():
            k.stop()


# -- the C++ task and the registry --------------------------------------------


class _Recorder:
    """A channel that records the call and answers with a task id."""

    def __init__(self, resp_cls):
        self.calls = []
        self.resp_cls = resp_cls

    def call(self, service, method, req, resp_cls, attachment=b"",
             timeout=None):
        self.calls.append((service, method, req.SerializeToString(),
                           bytes(attachment), timeout))
        return resp_cls(task_id=41), b""


def _submit_msg(api, rng, src: bytes):
    msg = api.local.SubmitCxxTaskRequest(
        requestor_process_id=int(rng.integers(1, 1 << 20)),
        source_path=f"/home/u/p/{int(rng.integers(0, 99))}.cc",
        source_digest=digest_bytes(src),
        compiler_invocation_arguments=str(rng.choice(
            ["-O2", "-O0 -g", "-O2 -g -fPIC"])),
        cache_control=int(rng.integers(0, 4)),
        ignore_timestamp_macros=bool(rng.integers(0, 2)))
    msg.compiler.path = "/usr/bin/g++"
    msg.compiler.size = 123
    msg.compiler.timestamp = 456
    return msg


def _result_fields(r):
    return (r.exit_code, r.standard_output, r.standard_error,
            {k: bytes(v) for k, v in r.files.items()}, r.patches,
            r.from_cache, r.reused_existing)


@pytest.mark.parametrize("seed", SEEDS)
def test_cxx_tasks_equal(seed):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, 256, int(rng.integers(1, 4096)),
                       dtype=np.uint8).tobytes()
    compressed = tcompress.compress(src)
    compiler = _hex(rng)
    tasks = {}
    for name, api, cxx, digests in (("jax", japi, jcxx, JDigests()),
                                    ("port", tapi, tcxx, TDigests())):
        msg = _submit_msg(api, np.random.default_rng(seed + 100), src)
        with pytest.raises(cxx.NeedCompilerDigest):
            cxx.make_cxx_task(msg, compressed, digests)
        digests.set("/usr/bin/g++", 123, 456, compiler)
        tasks[name] = cxx.make_cxx_task(msg, compressed, digests)
    j, t = tasks["jax"], tasks["port"]
    for task in (j, t):
        task.tenant_key_secret = "s3cret" if seed == 2 else ""
    assert (t.get_cache_setting(), t.get_cache_key(), t.get_digest(),
            t.get_env_digest(), t.fairness_key(), t.fairness_tenant()) == \
        (j.get_cache_setting(), j.get_cache_key(), j.get_digest(),
         j.get_env_digest(), j.fairness_key(), j.fairness_tenant())
    chans = {}
    for name, task, api in (("jax", j, japi), ("port", t, tapi)):
        chans[name] = _Recorder(api.daemon.QueueCxxCompilationTaskResponse)
        assert task.start_task(chans[name], "dtok", 77) == 41
    assert chans["port"].calls == chans["jax"].calls

    # The servant's reply and a cache entry, parsed by both.
    obj = tcompress.compress(rng.integers(0, 256, 300,
                                          dtype=np.uint8).tobytes())
    files = {".o": obj, ".gcno": tcompress.compress(b"gcno")}
    patches = {".o": [(int(rng.integers(0, 200)), 96, b"/x.cc")]}
    resp = tapi.daemon.WaitForCompilationOutputResponse(
        status=tapi.daemon.COMPILATION_TASK_STATUS_DONE,
        exit_code=int(rng.integers(0, 2)), standard_output=b"out",
        standard_error=b"warn")
    for key, locs in patches.items():
        pl = resp.cxx_info.patches.add(file_key=key)
        for pos, total, suffix in locs:
            pl.locations.add(position=pos, total_size=total,
                             suffix_to_keep=suffix)
    att = tpacking.pack_keyed_buffers(files)
    jresp = japi.daemon.WaitForCompilationOutputResponse.FromString(
        resp.SerializeToString())
    got_j = j.parse_servant_output(jresp, memoryview(att))
    got_t = t.parse_servant_output(resp, memoryview(att))
    assert _result_fields(got_t) == _result_fields(got_j)
    assert {k: bytes(v) for k, v in got_t.files.items()} == files
    entry = tformat.write_cache_entry(tformat.CacheEntry(
        exit_code=0, standard_output=b"o", standard_error=b"",
        files=files, patches=patches))
    assert entry == jformat.write_cache_entry(jformat.CacheEntry(
        exit_code=0, standard_output=b"o", standard_error=b"",
        files=files, patches=patches))
    hit_j, hit_t = j.parse_cache_entry(entry), t.parse_cache_entry(entry)
    assert _result_fields(hit_t) == _result_fields(hit_j)
    assert hit_t.from_cache
    assert t.parse_cache_entry(b"garbage") is None is \
        j.parse_cache_entry(b"garbage")

    # The cxx wait response the registry builds, message and chunks.
    built = {}
    for name, reg, http, res in (("jax", jregistry(JDigests()), jhttp, got_j),
                                 ("port", tregistry(TDigests()), thttp,
                                  got_t)):
        tt = reg.for_wait("/local/wait_for_cxx_task")
        assert reg.for_submit("/local/submit_cxx_task") is not None
        msg, chunks = tt.build_wait_response(res)
        built[name] = (msg.SerializeToString(), http._to_json(msg),
                       [bytes(c) for c in chunks], tt.bad_chunks_error,
                       tt.submit_error(tcxx.NeedCompilerDigest("x"))
                       if name == "port" else
                       tt.submit_error(jcxx.NeedCompilerDigest("x")))
    assert built["port"] == built["jax"]


# -- the failover channel under injected faults -------------------------------


def _failover_run(rpc, transport, api, tag: str, seed: int) -> tuple:
    rng = np.random.default_rng(seed)
    names = [f"fo-{tag}-{seed}-{i}" for i in range(3)]
    calls = {n: 0 for n in names}
    # Per target: the call numbers that fail, and how.
    plan = {n: {int(c): int(rng.integers(0, 4)) for c in
                rng.choice(40, int(rng.integers(5, 20)), replace=False)}
            for n in names}

    def injector(target, service, method):
        if target not in calls:
            return
        calls[target] += 1
        how = plan[target].get(calls[target])
        if how == 0:
            raise rpc.RpcError(transport.STATUS_TRANSPORT_FAILURE, "down")
        if how == 1:
            raise rpc.RpcError(transport.STATUS_NOT_SERVING,
                               "standby; retry-after-ms=1")
        if how == 2:
            raise rpc.RpcError(transport.STATUS_TIMEOUT, "slow")
        if how == 3:
            raise rpc.RpcError(
                api.scheduler.SCHEDULER_STATUS_NO_QUOTA_AVAILABLE,
                "ruled on")

    for n in names:
        spec = rpc.ServiceSpec("ytpu.SchedulerService")
        spec.add("GetConfig", api.scheduler.GetConfigRequest,
                 lambda req, att, ctx, n=n: api.scheduler.GetConfigResponse(
                     serving_daemon_token=n))
        rpc.register_mock_server(n, spec)
    transport.install_fault_injector(injector)
    out = []
    try:
        ch = rpc.Channel(",".join(f"mock://{n}" for n in names))
        assert isinstance(ch, transport.FailoverChannel)
        for _ in range(30):
            try:
                resp, _ = ch.call("ytpu.SchedulerService", "GetConfig",
                                  api.scheduler.GetConfigRequest(),
                                  api.scheduler.GetConfigResponse)
                out.append(("ok", resp.serving_daemon_token[-1]))
            except rpc.RpcError as e:
                out.append(("err", e.status))
            out.append(ch.preferred_uri()[-1])
        failovers = ch.failovers()
        ch.close()
    finally:
        transport.install_fault_injector(None)
        for n in names:
            rpc.unregister_mock_server(n)
    return out, failovers, [calls[n] for n in names]


@pytest.mark.parametrize("seed", (0, 1))
def test_failover_channels_rotate_alike_under_the_same_faults(seed):
    want = _failover_run(jrpc, jtransport, japi, "jax", seed)
    got = _failover_run(trpc, ttransport, tapi, "port", seed)
    assert got == want
    assert want[1] > 0
    with pytest.raises(ValueError):
        trpc.FailoverChannel("mock://only-one")


def test_servant_beats_into_its_cells_failover_list(tmp_path):
    """The servant role dials a ','-list through the failover channel:
    with the active down its heartbeat reaches the standby, and the next
    one goes there first."""
    from yadcc_tpu_torch.daemon.cloud.compiler_registry import \
        CompilerRegistry
    from yadcc_tpu_torch.daemon.cloud.daemon_service import DaemonService
    from yadcc_tpu_torch.daemon.cloud.execution_engine import \
        ExecutionEngine
    from yadcc_tpu_torch.daemon.config import DaemonConfig

    class Idle:
        nprocs = 32

        def sample(self):
            pass

        def loadavg(self, seconds=15):
            return 0

    beats = []
    S = tapi.scheduler
    spec = trpc.ServiceSpec("ytpu.SchedulerService")
    spec.add("Heartbeat", S.HeartbeatRequest, lambda req, att, ctx: (
        beats.append(req) or S.HeartbeatResponse(acceptable_tokens=["d"])))
    trpc.register_mock_server("fo-standby", spec)
    engine = ExecutionEngine(max_concurrency=2, min_memory_for_new_task=1)
    svc = DaemonService(
        DaemonConfig(scheduler_uri="mock://fo-active,mock://fo-standby",
                     temporary_dir=str(tmp_path), location="127.0.0.1:1",
                     max_remote_tasks=2),
        engine=engine, registry=CompilerRegistry([]), sampler=Idle(),
        allow_poor_machine=True, cgroup_present=False)
    try:
        svc.heartbeat_once()
        chan = svc._scheduler()
        assert isinstance(chan, ttransport.FailoverChannel)
        assert chan.failovers() == 1
        assert chan.preferred_uri() == "mock://fo-standby"
        svc.heartbeat_once()
        assert len(beats) == 2 and beats[-1].location == "127.0.0.1:1"
        assert chan.failovers() == 1
    finally:
        trpc.unregister_mock_server("fo-standby")
        engine.stop()


def _keeper_fetches(pkg: str, seed: int) -> tuple:
    """A grant keeper's fetcher with a seeded number of waiters against a
    stub scheduler that answers the first poll with a seeded number of
    grants and every later one with none.  Returns the first two
    WaitForStartingTask requests as bytes and the grant ids freed at
    stop()."""
    import importlib

    api = importlib.import_module(pkg + ".api")
    rpc = importlib.import_module(pkg + ".rpc")
    keeper_mod = importlib.import_module(
        pkg + ".daemon.local.task_grant_keeper")
    sch = api.scheduler
    rng = np.random.default_rng(seed)
    waiters = int(rng.integers(2, 9))
    first = int(rng.integers(0, waiters + 1))
    polls, freed, lock = [], [], threading.Lock()

    def wait(req, att, ctx):
        with lock:
            polls.append(req.SerializeToString())
            n = first if len(polls) == 1 else 0
        resp = sch.WaitForStartingTaskResponse()
        for i in range(n):
            resp.grants.add(task_grant_id=100 + i,
                            servant_location=f"10.0.0.{i + 1}:8335")
        return resp

    def free(req, att, ctx):
        with lock:
            freed.extend(req.task_grant_ids)
        return sch.FreeTaskResponse()

    name = f"keeper-fetch-{pkg}-{seed}"
    spec = rpc.ServiceSpec("ytpu.SchedulerService")
    spec.add("WaitForStartingTask", sch.WaitForStartingTaskRequest, wait)
    spec.add("FreeTask", sch.FreeTaskRequest, free)
    rpc.register_mock_server(name, spec)
    env = _hex(rng)
    keeper = keeper_mod.TaskGrantKeeper(
        f"mock://{name}", "tok", min_version=int(rng.integers(0, 3)))
    try:
        f = keeper_mod._EnvFetcher(keeper, env)
        with keeper._lock:
            keeper._fetchers[env] = f
        with f.lock:
            f.waiters = waiters
        f.wake.set()
        deadline = time.monotonic() + 10
        while len(polls) < 2:
            assert time.monotonic() < deadline, polls
            time.sleep(0.01)
        with f.lock:
            f.waiters = 0
    finally:
        keeper.stop()
    deadline = time.monotonic() + 10
    while len(freed) < first:       # the JAX keeper frees on a thread
        assert time.monotonic() < deadline, freed
        time.sleep(0.01)
    rpc.unregister_mock_server(name)
    return polls[:2], sorted(freed)


@pytest.mark.parametrize("seed", SEEDS)
def test_grant_keepers_fetch_alike(seed):
    """The port's keeper asks as the JAX one does: immediate = waiters
    less the grants queued, prefetch one, the same request bytes; and it
    returns the queued grants at stop()."""
    want = _keeper_fetches("yadcc_tpu", seed)
    got = _keeper_fetches("yadcc_tpu_torch", seed)
    assert got == want
    req = tapi.scheduler.WaitForStartingTaskRequest.FromString(got[0][1])
    assert req.prefetch_reqs == 1


def test_keeper_frees_on_the_callers_thread_after_stop():
    """A task thread that still holds a grant when the daemon stops frees
    it through a stopped keeper: the free has reached the scheduler when
    free() returns, and the keeper keeps no channel open."""
    sch = tapi.scheduler
    freed = []
    spec = trpc.ServiceSpec("ytpu.SchedulerService")
    spec.add("FreeTask", sch.FreeTaskRequest,
             lambda req, att, ctx: (freed.extend(req.task_grant_ids),
                                    sch.FreeTaskResponse())[1])
    trpc.register_mock_server("keeper-stopped", spec)
    keeper = TKeeper("mock://keeper-stopped", "tok")
    try:
        keeper.free([7])
        deadline = time.monotonic() + 10
        while freed != [7]:             # before stop: on a thread
            assert time.monotonic() < deadline, freed
            time.sleep(0.01)
        keeper.stop()
        keeper.free([8, 9])
        assert freed == [7, 8, 9]
        assert keeper._channels == {}
        assert keeper.get("ab" * 32, timeout_s=5.0) is None
    finally:
        trpc.unregister_mock_server("keeper-stopped")


def _first_freed_slot(pkg: str) -> dict:
    """One servant of two slots on a dispatcher cycled by hand on a
    virtual clock.  A filler holds one slot; then request A (two grants)
    and request B (two grants) queue in that order, from two delegates.
    Cycle 1 grants the free slot; the filler's grant is freed; cycle 2
    grants that slot; the clock passes every deadline; cycle 3.  Returns
    each request's grants and whether A had returned after cycle 1."""
    import importlib

    policy = importlib.import_module(pkg + ".scheduler.policy")
    td = importlib.import_module(pkg + ".scheduler.task_dispatcher")
    clock = importlib.import_module(pkg + ".utils.clock").VirtualClock(100.0)
    kw = {"device": "cpu"} if pkg == "yadcc_tpu_torch" else \
        {"max_servants": 16}
    d = td.TaskDispatcher(
        policy.make_policy("greedy_cpu", avoid_self=False, **kw),
        max_servants=16, max_envs=8, clock=clock, batch_window_s=0.0,
        start_dispatch_thread=False)
    env = "ab" * 32
    assert d.keep_servant_alive(td.ServantInfo(
        location="10.0.0.1:8335", version=2, num_processors=32,
        current_load=0, dedicated=False, capacity=2,
        total_memory=64 << 30, memory_available=64 << 30,
        env_digests=(env,)), 600.0)
    out = {}

    def ask(key, requestor, n):
        got = d.wait_for_starting_new_task(
            env, requestor=requestor, immediate=n, timeout_s=60.0)
        out[key] = sorted(gid for gid, _ in got)

    def queue(key, requestor, n):
        t = threading.Thread(target=ask, args=(key, requestor, n))
        t.start()
        deadline = time.monotonic() + 10
        while not any(r.requestor == requestor for r in d._pending):
            assert time.monotonic() < deadline
            time.sleep(0.001)
        return t

    try:
        filler = queue("filler", "10.0.0.9:1", 1)
        d.run_dispatch_cycle_for_testing()
        filler.join(timeout=10)
        a = queue("a", "10.0.0.2:1", 2)
        b = queue("b", "10.0.0.3:1", 2)
        d.run_dispatch_cycle_for_testing()
        a.join(timeout=0.2 if pkg == "yadcc_tpu" else 10)
        a_after_cycle_1 = out.get("a")
        d.free_task(out["filler"])
        d.run_dispatch_cycle_for_testing()
        clock.advance(120.0)
        d.run_dispatch_cycle_for_testing()
        for t in (a, b):
            t.join(timeout=10)
            assert not t.is_alive()
    finally:
        d.stop()
    return dict(out, a_after_cycle_1=a_after_cycle_1)


def test_two_delegates_share_the_slots_unlike_the_reference():
    """The JAX scheduler holds a request until it is filled or its
    deadline passes and hands a freed slot to the oldest request: A keeps
    its grant unused and takes the freed slot too, and B gets nothing.
    The port's returns A's grant at once, because B is waiting, and the
    freed slot goes to B."""
    jax = _first_freed_slot("yadcc_tpu")
    port = _first_freed_slot("yadcc_tpu_torch")
    assert jax["filler"] == port["filler"] == [1]
    assert jax["a_after_cycle_1"] is None
    assert jax["a"] == [2, 3] and jax["b"] == []
    assert port["a_after_cycle_1"] == port["a"] == [2]
    assert port["b"] == [3]
