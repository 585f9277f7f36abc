"""The port's scheduler against the JAX package's, on the CPU.

One dispatch cycle of each package's TaskDispatcher over the same
heartbeats and wait requests must issue identical grants (grouped and
batched-scan policies); the pipelined loop, the resident pool's dirty-slot
export under churn and the failure path are exercised on the port alone;
and loopback gRPC drives run the port's entry end to end with --device
cpu, synchronous and resident-pipelined.
"""

from __future__ import annotations

import socket
import threading

import numpy as np
import pytest

from yadcc_tpu.scheduler import policy as jpol
from yadcc_tpu.scheduler import task_dispatcher as jtd
from yadcc_tpu.utils.clock import VirtualClock as JClock
from yadcc_tpu_torch.scheduler import policy as tpol
from yadcc_tpu_torch.scheduler import task_dispatcher as ttd
from yadcc_tpu_torch.utils.clock import VirtualClock as TClock

ENVS = [f"env-{i:02d}" for i in range(12)]


def fleet(rng, n):
    """Heartbeat facts for n servants (capacity, load, memory, envs,
    versions and dedication all vary)."""
    out = []
    for i in range(n):
        envs = tuple(sorted(str(e) for e in rng.choice(
            ENVS, int(rng.integers(1, 6)), replace=False)))
        out.append(dict(
            location=f"10.0.{i // 200}.{i % 200 + 1}:8335",
            version=int(rng.integers(1, 4)),
            num_processors=int(rng.integers(4, 33)),
            current_load=int(rng.integers(0, 3)),
            dedicated=bool(rng.random() < 0.3),
            capacity=int(rng.integers(0, 9)),
            total_memory=64 << 30,
            memory_available=(64 << 30) if rng.random() < 0.9 else 1 << 30,
            env_digests=envs))
    return out


def wait_requests(rng, n, n_servants):
    out = []
    for _ in range(n):
        requestor = ""
        if rng.random() < 0.4:   # a delegate that also serves
            i = int(rng.integers(0, n_servants))
            requestor = f"10.0.{i // 200}.{i % 200 + 1}:40000"
        out.append(dict(env_digest=str(rng.choice(ENVS)),
                        min_version=int(rng.integers(0, 3)),
                        requestor=requestor,
                        immediate=int(rng.integers(1, 30)),
                        prefetch=int(rng.integers(0, 3)),
                        lease_s=15.0, timeout_s=5.0))
    return out


def one_cycle(d, servant_cls, clock, servants, requests):
    """Beat the fleet in, queue the requests IN ORDER, run one cycle,
    expire the rest; returns each request's grants."""
    for info in servants:
        assert d.keep_servant_alive(servant_cls(**info), 60.0)
    results = [None] * len(requests)
    threads = []
    for i, r in enumerate(requests):
        def wait(i=i, r=r):
            results[i] = d.wait_for_starting_new_task(**r)

        t = threading.Thread(target=wait, daemon=True)
        t.start()
        threads.append(t)
        for _ in range(2000):      # keep the queue order deterministic
            if len(d._pending) == i + 1:
                break
            threading.Event().wait(0.001)
        assert len(d._pending) == i + 1
    issued = d.run_dispatch_cycle_for_testing()
    clock.advance(10.0)            # past every deadline
    d.run_dispatch_cycle_for_testing()
    for t in threads:
        t.join(timeout=10)
        assert not t.is_alive()
    return issued, results


@pytest.mark.parametrize("seed", [0, 1])
def test_one_cycle_grants_match_jax(seed):
    rng = np.random.default_rng(seed)
    servants = fleet(rng, 96)
    requests = wait_requests(rng, 16, 96)
    jclock, tclock = JClock(100.0), TClock(100.0)
    jd = jtd.TaskDispatcher(jpol.JaxGroupedPolicy(), max_servants=128,
                            clock=jclock, batch_window_s=0.0,
                            start_dispatch_thread=False)
    td = ttd.TaskDispatcher(tpol.TorchGroupedPolicy("cpu"),
                            max_servants=128, clock=tclock,
                            batch_window_s=0.0, start_dispatch_thread=False)
    try:
        j_issued, j_grants = one_cycle(jd, jtd.ServantInfo, jclock,
                                       servants, requests)
        t_issued, t_grants = one_cycle(td, ttd.ServantInfo, tclock,
                                       servants, requests)
        assert t_issued == j_issued > 0
        assert t_grants == j_grants
        j_state, t_state = jd.inspect(), td.inspect()
        assert t_state["grants_outstanding"] == j_state["grants_outstanding"]
        assert {k: v["running"] for k, v in t_state["servants"].items()} == \
            {k: v["running"] for k, v in j_state["servants"].items()}
        assert t_state["stats"]["granted"] == j_state["stats"]["granted"]
    finally:
        jd.stop()
        td.stop()


@pytest.mark.parametrize("jax_policy", ["jax_batched", "jax_pallas"])
def test_batched_one_cycle_grants_match_jax(jax_policy):
    """torch_batched's dispatch cycle against jax_batched's (XLA scan) and
    jax_pallas's (the Pallas K2 in interpret mode)."""
    rng = np.random.default_rng(5)
    servants = fleet(rng, 64)
    requests = wait_requests(rng, 10, 64)
    jclock, tclock = JClock(100.0), TClock(100.0)
    jd = jtd.TaskDispatcher(jpol.make_policy(jax_policy, 128),
                            max_servants=128, clock=jclock,
                            batch_window_s=0.0, start_dispatch_thread=False)
    td = ttd.TaskDispatcher(tpol.make_policy("torch_batched", device="cpu"),
                            max_servants=128, clock=tclock,
                            batch_window_s=0.0, start_dispatch_thread=False)
    try:
        j_issued, j_grants = one_cycle(jd, jtd.ServantInfo, jclock,
                                       servants, requests)
        t_issued, t_grants = one_cycle(td, ttd.ServantInfo, tclock,
                                       servants, requests)
        assert t_issued == j_issued > 0
        assert t_grants == j_grants
    finally:
        jd.stop()
        td.stop()


def _check_grants(servants, grants_by_req, requests):
    by_loc = {s["location"]: s for s in servants}
    held = {}
    for req, grants in zip(requests, grants_by_req):
        for gid, loc in grants:
            info = by_loc[loc]
            assert req["env_digest"] in info["env_digests"]
            assert info["version"] >= req.get("min_version", 0)
            held[loc] = held.get(loc, 0) + 1
    for loc, n in held.items():
        info = by_loc[loc]
        assert n <= min(info["capacity"], info["num_processors"])
    ids = [gid for g in grants_by_req for gid, _ in g]
    assert len(ids) == len(set(ids))


def test_pipelined_loop_issues_valid_grants():
    """The dispatch thread's pipelined loop (the card's default mode)
    running the plain version: every grant valid, no servant over its
    capacity, no duplicate ids, all frees land."""
    rng = np.random.default_rng(3)
    servants = fleet(rng, 64)
    for s in servants:
        s.update(memory_available=64 << 30, current_load=0,
                 num_processors=s["capacity"])
    d = ttd.TaskDispatcher(tpol.TorchGroupedPolicy("cpu"), max_servants=64,
                           pipeline_depth=4)
    try:
        for info in servants:
            assert d.keep_servant_alive(ttd.ServantInfo(**info), 60.0)
        requests = [dict(env_digest=ENVS[i % 4], immediate=3,
                         timeout_s=2.0) for i in range(24)]
        results = [None] * len(requests)

        def wait(i):
            results[i] = d.wait_for_starting_new_task(**requests[i])

        threads = [threading.Thread(target=wait, args=(i,), daemon=True)
                   for i in range(len(requests))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=20)
            assert not t.is_alive()
        assert sum(len(r) for r in results) > 0
        _check_grants(servants, results, requests)
        d.free_task([gid for r in results for gid, _ in r])
        assert d.inspect()["grants_outstanding"] == 0
        assert d.inspect()["failure"] is None
    finally:
        d.stop()


def test_resident_pipelined_loop_exports_every_dirty_slot():
    """The resident policy in the pipelined loop while servants churn
    (capacity, version and env changes, leaves and joins) and grants are
    issued and freed: with the statics oracle run at EVERY launch, a slot
    whose snapshot row changed without being exported as dirty would
    show as a mismatch.  Every grant stays valid."""
    rng = np.random.default_rng(8)
    servants = fleet(rng, 48)
    for s in servants:
        s.update(memory_available=64 << 30, current_load=0,
                 num_processors=16, capacity=int(rng.integers(1, 5)))
    policy = tpol.TorchResidentGroupedPolicy("cpu", max_groups=8,
                                             oracle_interval=1)
    d = ttd.TaskDispatcher(policy, max_servants=64, pipeline_depth=3)
    try:
        for info in servants:
            assert d.keep_servant_alive(ttd.ServantInfo(**info), 60.0)
        stop = threading.Event()
        results, requests = [], []
        lock = threading.Lock()

        def delegate(i):
            k = 0
            while not stop.is_set():
                req = dict(env_digest=ENVS[(i + k) % 6], immediate=2,
                           timeout_s=0.5)
                k += 1
                got = d.wait_for_starting_new_task(**req)
                with lock:
                    results.append(got)
                    requests.append(req)
                d.free_task([gid for gid, _ in got])

        def churn():
            crng = np.random.default_rng(9)
            while not stop.is_set():
                i = int(crng.integers(0, len(servants)))
                info = dict(servants[i])
                kind = int(crng.integers(0, 4))
                if kind == 0:
                    info["capacity"] = int(crng.integers(1, 5))
                elif kind == 1:
                    info["version"] = int(crng.integers(1, 4))
                elif kind == 2:
                    info["env_digests"] = tuple(sorted(crng.choice(
                        ENVS, 3, replace=False).tolist()))
                else:           # leave, then join again
                    d.keep_servant_alive(ttd.ServantInfo(**info), 0)
                servants[i] = info
                d.keep_servant_alive(ttd.ServantInfo(**info), 60.0)
                threading.Event().wait(0.002)

        threads = [threading.Thread(target=delegate, args=(i,), daemon=True)
                   for i in range(6)]
        threads.append(threading.Thread(target=churn, daemon=True))
        for t in threads:
            t.start()
        threading.Event().wait(1.5)
        stop.set()
        for t in threads:
            t.join(timeout=20)
            assert not t.is_alive()
        state = d.inspect()
        assert state["failure"] is None
        assert state["grants_outstanding"] == 0
        stream = state["stream"]
        assert stream["delta_launches"] > 0
        assert stream["oracle_checks"] == stream["delta_launches"]
        assert stream["oracle_mismatches"] == 0
        assert stream["delta_slots"] + stream["full_syncs"] > 0
        assert sum(len(r) for r in results) > 0
        ids = [gid for r in results for gid, _ in r]
        assert len(ids) == len(set(ids))
    finally:
        d.stop()


class _Broken(tpol.TorchGroupedPolicy):
    def assign(self, snap, requests):
        raise RuntimeError("device lost")

    def stream_launch(self, snap, descr, adj, reset_slots):
        raise RuntimeError("device lost")


@pytest.mark.parametrize("depth", [0, 2])
def test_policy_failure_stops_the_dispatcher(depth):
    """No fallback: a failing device policy stops the dispatcher and
    every waiter gets the error instead of a grant or a silent retry."""
    d = ttd.TaskDispatcher(_Broken("cpu"), max_servants=8,
                           pipeline_depth=depth)
    try:
        info = fleet(np.random.default_rng(0), 1)[0]
        info.update(capacity=4, memory_available=64 << 30,
                    env_digests=(ENVS[0],))
        assert d.keep_servant_alive(ttd.ServantInfo(**info), 60.0)
        with pytest.raises(ttd.DispatcherFailed, match="device lost"):
            d.wait_for_starting_new_task(ENVS[0], timeout_s=5.0)
        assert isinstance(d.failure, RuntimeError)
        with pytest.raises(ttd.DispatcherFailed):
            d.wait_for_starting_new_task(ENVS[0], timeout_s=5.0)
    finally:
        d.stop()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_entry_loopback_drive_on_cpu():
    """Heartbeat -> WaitForStartingTask -> KeepTaskAlive -> FreeTask ->
    GetRunningTasks through the port's entry over real gRPC."""
    from yadcc_tpu_torch import api
    from yadcc_tpu_torch.rpc import Channel, RpcError
    from yadcc_tpu_torch.scheduler import entry
    from yadcc_tpu_torch.scheduler.service import SERVICE_NAME

    port = _free_port()
    args = entry.build_arg_parser().parse_args([
        "--port", str(port), "--inspect-port", "0", "--device", "cpu",
        "--max-servants", "64", "--acceptable-user-tokens", "utok",
        "--acceptable-servant-tokens", "stok", "--allow-self-dispatch"])
    stop = threading.Event()
    rc = []
    server = threading.Thread(
        target=lambda: rc.append(entry.scheduler_start(args, stop,
                                                       gc_guard=False)),
        daemon=True)
    server.start()
    ch = Channel(f"grpc://127.0.0.1:{port}")
    sch = api.scheduler
    try:
        for _ in range(300):
            try:
                ch.call(SERVICE_NAME, "GetConfig",
                        sch.GetConfigRequest(token="utok"),
                        sch.GetConfigResponse, timeout=1.0)
                break
            except RpcError:
                threading.Event().wait(0.05)
        hb = sch.HeartbeatRequest(
            token="stok", next_heartbeat_in_ms=1000,
            location="127.0.0.1:20001", version=1, num_processors=8,
            capacity=4, total_memory_in_bytes=64 << 30,
            memory_available_in_bytes=64 << 30)
        hb.env_descs.add(compiler_digest="gcc-12")
        hb.running_tasks.add(servant_task_id=7, task_grant_id=0,
                             task_digest="d0")
        resp, _ = ch.call(SERVICE_NAME, "Heartbeat", hb,
                          sch.HeartbeatResponse, timeout=5.0)
        assert len(resp.acceptable_tokens) == 3
        with pytest.raises(RpcError):
            ch.call(SERVICE_NAME, "Heartbeat",
                    sch.HeartbeatRequest(token="bad"),
                    sch.HeartbeatResponse, timeout=5.0)
        wreq = sch.WaitForStartingTaskRequest(
            token="utok", milliseconds_to_wait=2000, immediate_reqs=3,
            next_keep_alive_in_ms=10_000)
        wreq.env_desc.compiler_digest = "gcc-12"
        wresp, _ = ch.call(SERVICE_NAME, "WaitForStartingTask", wreq,
                           sch.WaitForStartingTaskResponse, timeout=10.0)
        ids = [g.task_grant_id for g in wresp.grants]
        assert len(ids) == 3 and len(set(ids)) == 3
        assert {g.servant_location for g in wresp.grants} == \
            {"127.0.0.1:20001"}
        kresp, _ = ch.call(SERVICE_NAME, "KeepTaskAlive",
                           sch.KeepTaskAliveRequest(
                               token="utok", task_grant_ids=ids + [999],
                               next_keep_alive_in_ms=10_000),
                           sch.KeepTaskAliveResponse, timeout=5.0)
        assert list(kresp.statuses) == [True, True, True, False]
        ch.call(SERVICE_NAME, "FreeTask",
                sch.FreeTaskRequest(token="utok", task_grant_ids=ids),
                sch.FreeTaskResponse, timeout=5.0)
        kresp, _ = ch.call(SERVICE_NAME, "KeepTaskAlive",
                           sch.KeepTaskAliveRequest(
                               token="utok", task_grant_ids=ids),
                           sch.KeepTaskAliveResponse, timeout=5.0)
        assert list(kresp.statuses) == [False, False, False]
        rresp, _ = ch.call(SERVICE_NAME, "GetRunningTasks",
                           sch.GetRunningTasksRequest(),
                           sch.GetRunningTasksResponse, timeout=5.0)
        assert [t.servant_task_id for t in rresp.running_tasks] == [7]
    finally:
        ch.close()
        stop.set()
        server.join(timeout=15)
    assert not server.is_alive()
    assert rc == [0]


def test_entry_serves_resident_pipelined_on_cpu():
    """The port's entry with --dispatch-policy torch_resident_grouped
    --dispatch-pipeline-depth 4 --device cpu serves grants over real
    gRPC to concurrent delegates: every grant on a servant that has the
    environment and room for it, no duplicate ids, every grant freed,
    and the resident pool's oracle clean."""
    from yadcc_tpu_torch import api
    from yadcc_tpu_torch.rpc import Channel, RpcError
    from yadcc_tpu_torch.scheduler import entry
    from yadcc_tpu_torch.scheduler.service import SERVICE_NAME
    from yadcc_tpu_torch.utils import exposed_vars

    port = _free_port()
    args = entry.build_arg_parser().parse_args([
        "--port", str(port), "--inspect-port", "0", "--device", "cpu",
        "--max-servants", "64", "--acceptable-user-tokens", "utok",
        "--acceptable-servant-tokens", "stok", "--allow-self-dispatch",
        "--dispatch-policy", "torch_resident_grouped",
        "--dispatch-pipeline-depth", "4"])
    stop = threading.Event()
    rc = []
    server = threading.Thread(
        target=lambda: rc.append(entry.scheduler_start(args, stop,
                                                       gc_guard=False)),
        daemon=True)
    server.start()
    sch = api.scheduler
    rng = np.random.default_rng(21)
    servants = {f"127.0.0.1:{20001 + i}": dict(
        capacity=int(rng.integers(1, 5)),
        envs=set(rng.choice(ENVS[:4], 2, replace=False).tolist()))
        for i in range(24)}
    held = {loc: 0 for loc in servants}
    violations, seen = [], []
    lock = threading.Lock()
    ch = Channel(f"grpc://127.0.0.1:{port}")
    try:
        for _ in range(300):
            try:
                ch.call(SERVICE_NAME, "GetConfig",
                        sch.GetConfigRequest(token="utok"),
                        sch.GetConfigResponse, timeout=1.0)
                break
            except RpcError:
                threading.Event().wait(0.05)
        for loc, s in servants.items():
            hb = sch.HeartbeatRequest(
                token="stok", next_heartbeat_in_ms=10_000, location=loc,
                version=1, num_processors=s["capacity"],
                capacity=s["capacity"], total_memory_in_bytes=64 << 30,
                memory_available_in_bytes=64 << 30)
            for e in sorted(s["envs"]):
                hb.env_descs.add(compiler_digest=e)
            ch.call(SERVICE_NAME, "Heartbeat", hb, sch.HeartbeatResponse,
                    timeout=5.0)

        def delegate(d):
            chan = Channel(f"grpc://127.0.0.1:{port}")
            try:
                for k in range(6):
                    env = ENVS[(d + k) % 4]
                    req = sch.WaitForStartingTaskRequest(
                        token="utok", milliseconds_to_wait=1000,
                        immediate_reqs=3, next_keep_alive_in_ms=10_000)
                    req.env_desc.compiler_digest = env
                    try:
                        resp, _ = chan.call(
                            SERVICE_NAME, "WaitForStartingTask", req,
                            sch.WaitForStartingTaskResponse, timeout=10.0)
                    except RpcError as e:
                        if e.status == sch.SCHEDULER_STATUS_NO_QUOTA_AVAILABLE:
                            continue
                        raise
                    with lock:
                        for g in resp.grants:
                            s = servants[g.servant_location]
                            held[g.servant_location] += 1
                            if env not in s["envs"]:
                                violations.append(f"{env} not on server")
                            if held[g.servant_location] > s["capacity"]:
                                violations.append("over capacity")
                            seen.append(g.task_grant_id)
                        for g in resp.grants:
                            held[g.servant_location] -= 1
                    ids = [g.task_grant_id for g in resp.grants]
                    if ids:
                        chan.call(SERVICE_NAME, "FreeTask",
                                  sch.FreeTaskRequest(token="utok",
                                                      task_grant_ids=ids),
                                  sch.FreeTaskResponse, timeout=5.0)
            finally:
                chan.close()

        threads = [threading.Thread(target=delegate, args=(d,), daemon=True)
                   for d in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
        assert not violations, violations[:5]
        assert seen and len(seen) == len(set(seen))
        td = exposed_vars.collect("yadcc")["yadcc"]["task_dispatcher"]
        assert td["policy"] == "torch_resident_grouped"
        assert td["failure"] is None
        assert td["grants_outstanding"] == 0
        assert td["stats"]["granted"] == len(seen)
        assert td["stream"]["delta_launches"] > 0
        assert td["stream"]["oracle_mismatches"] == 0
    finally:
        ch.close()
        stop.set()
        server.join(timeout=15)
    assert not server.is_alive()
    assert rc == [0]
