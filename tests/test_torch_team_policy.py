"""The port's team policies, torch_sharded and torch_sharded_grouped
(yadcc_tpu_torch/scheduler/policy.py), against the JAX package's
jax_sharded and jax_sharded_grouped on the CPU: the JAX policies over
conftest's 8 CPU devices, the port's over teams of 2, 4 and 8 CPU
slices, the same seeded snapshots and requests, exact.  Then both
through the dispatcher, synchronous and pipelined at depth 16; the
router's load summary on a team; the scheduler entry serving
--dispatch-policy torch_sharded_grouped on the CPU; the parsers' policy
choices."""

from __future__ import annotations

import copy
import threading
import time

import numpy as np
import pytest

from yadcc_tpu.scheduler import policy as jpol
from yadcc_tpu.scheduler.task_dispatcher import ServantInfo as JServant
from yadcc_tpu.scheduler.task_dispatcher import TaskDispatcher as JDispatcher
from yadcc_tpu_torch.parallel import mesh as tmesh
from yadcc_tpu_torch.scheduler import policy as tpol
from yadcc_tpu_torch.scheduler.task_dispatcher import ServantInfo
from yadcc_tpu_torch.scheduler.task_dispatcher import TaskDispatcher

TEAMS = (2, 4, 8)


def snapshot_np(rng, s, cap_hi=12):
    cap = rng.integers(0, cap_hi, s).astype(np.int32)
    return dict(
        alive=rng.random(s) < 0.92,
        capacity=cap,
        running=np.minimum(rng.integers(0, 4, s), cap).astype(np.int32),
        dedicated=rng.random(s) < 0.25,
        version=rng.integers(1, 3, s).astype(np.int32),
        env_bitmap=rng.integers(0, 2**32, (s, 8),
                                dtype=np.uint64).astype(np.uint32))


def snaps(p, epoch=-1):
    return (jpol.PoolSnapshot(**copy.deepcopy(p), epoch=epoch),
            tpol.PoolSnapshot(**copy.deepcopy(p), epoch=epoch))


def request_mix(rng, s, n_runs, run_hi):
    reqs = []
    for _ in range(n_runs):
        e, v, r = (int(rng.integers(0, 256)), int(rng.integers(1, 3)),
                   int(rng.integers(-1, s)))
        reqs += [(e, v, r)] * int(rng.integers(1, run_hi))
    return reqs


def team(n):
    return tmesh.make_team(n, "cpu")


@pytest.mark.parametrize("n", TEAMS)
def test_sharded_policies_match_jax(n):
    """test_scheduler.py:378 for both policies: the same picks as the
    JAX sharded policies and, up to order within a run of identical
    requests, as the greedy oracle."""
    rng = np.random.default_rng(21 + n)
    s = 64
    p = snapshot_np(rng, s)
    reqs = [(int(rng.integers(0, 256)), 1, -1) for _ in range(40)]
    jr = [jpol.AssignRequest(*r) for r in reqs]
    tr = [tpol.AssignRequest(*r) for r in reqs]
    js, ts = snaps(p)
    want = jpol.JaxShardedPolicy(max_servants=s).assign(js, jr)
    got = tpol.TorchShardedPolicy(s, team=team(n)).assign(ts, tr)
    assert got == want == tpol.GreedyCpuPolicy().assign(
        tpol.PoolSnapshot(**copy.deepcopy(p)), tr)

    reqs = request_mix(rng, s, 12, 30)
    jr = [jpol.AssignRequest(*r) for r in reqs]
    tr = [tpol.AssignRequest(*r) for r in reqs]
    js, ts = snaps(p)
    want = jpol.JaxShardedGroupedPolicy().assign(js, jr)
    got = tpol.TorchShardedGroupedPolicy(team=team(n)).assign(ts, tr)
    assert got == want
    assert sorted(got) == sorted(tpol.GreedyCpuPolicy().assign(
        tpol.PoolSnapshot(**copy.deepcopy(p)), tr))
    assert sum(x >= 0 for x in got) > 0


def test_sharded_grouped_stream_sequence_matches_jax():
    """begin, launches with host corrections and resets, collect: the
    same picks a launch and the same resident running as
    JaxShardedGroupedPolicy's stream."""
    rng = np.random.default_rng(12)
    s = 256
    p = snapshot_np(rng, s, cap_hi=20)
    jp = jpol.JaxShardedGroupedPolicy()
    tp = tpol.TorchShardedGroupedPolicy(team=team(4))
    js, ts = snaps(p, epoch=1)
    jp.stream_begin(js)
    tp.stream_begin(ts)
    for step in range(4):
        descr = [(int(rng.integers(0, 256)), 1, int(rng.integers(-1, s)),
                  int(rng.integers(1, 60))) for _ in range(1 + step)]
        adj = np.zeros(s, np.int64)
        adj[rng.integers(0, s, 20)] -= 1
        resets = {int(k): int(rng.integers(0, 3))
                  for k in rng.integers(0, s, step)}
        js, ts = snaps(p, epoch=1 + step)
        jt = jp.stream_launch(js, descr, adj, resets)
        tt = tp.stream_launch(ts, descr, adj, resets)
        assert tp.stream_ready(tt)
        assert tt.launch_id == jt.launch_id == step
        assert np.array_equal(tp.stream_collect(tt), jp.stream_collect(jt))
        running = tmesh.unshard_vector(tp._stream_running, tp._team,
                                       s // 4)
        assert np.array_equal(running.numpy(),
                              np.asarray(jp._stream_running))
    assert tp.stream_stats() == jp.stream_stats()


def make_dispatcher(cls, servant_cls, policy, depth, n_servants=6,
                    capacity=2):
    d = cls(policy, max_servants=64, max_envs=64,
            min_memory_for_new_task=1 << 30, batch_window_s=0.0,
            pipeline_depth=depth, start_dispatch_thread=True)
    for i in range(n_servants):
        assert d.keep_servant_alive(servant_cls(
            location=f"10.0.0.{i}:8335", version=1, num_processors=32,
            capacity=capacity, memory_available=64 << 30,
            env_digests=("envA",)), 3600.0)
    return d


def drain_idle(d, timeout=10.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        with d._lock:
            idle = not d._pending
        if idle:
            time.sleep(0.3)
            return
        time.sleep(0.05)
    pytest.fail("dispatcher did not go idle")


def chain_invariant(d, running):
    """Resident running + the host's pending corrections = the host's
    running, slot by slot (test_pipelined_dispatch.py:chain_invariant)."""
    dev = np.asarray(running).astype(np.int64)
    with d._lock:
        host = d._arr_running.astype(np.int64).copy()
        adj = d._pipe_adj.copy()
        resets = dict(d._pipe_resets)
    for slot in range(len(host)):
        if slot in resets:
            assert resets[slot] == host[slot], slot
        else:
            assert dev[slot] + adj[slot] == host[slot], slot


@pytest.mark.parametrize("depth", [0, 16])
def test_sharded_grouped_dispatcher_matches_jax(depth):
    """test_pipelined_dispatch.py:377 in both packages: 8 grants, freed,
    8 again, synchronous and pipelined at depth 16; at depth 16 the
    resident chain holds the invariant."""
    out = {}
    for name, cls, srv, policy in (
            ("jax", JDispatcher, JServant,
             jpol.JaxShardedGroupedPolicy(max_groups=8)),
            ("port", TaskDispatcher, ServantInfo,
             tpol.TorchShardedGroupedPolicy(team=team(4), max_groups=8))):
        d = make_dispatcher(cls, srv, policy, depth)
        try:
            got = []
            for _ in range(2):
                grants = d.wait_for_starting_new_task(
                    "envA", immediate=8, timeout_s=15.0)
                got.append(len(grants))
                d.free_task([gid for gid, _ in grants])
            if depth:
                drain_idle(d)
                running = policy._stream_running
                if name == "port":
                    running = tmesh.unshard_vector(running, policy._team,
                                                   16).numpy()
                chain_invariant(d, running)
            out[name] = (got, d.inspect()["stats"]["granted"])
        finally:
            d.stop()
    assert out["port"] == out["jax"] == ([8, 8], 16)


def test_sharded_scan_dispatcher_matches_jax():
    """torch_sharded behind the dispatcher (synchronous, as jax_sharded
    serves): the same grants as the JAX dispatcher on the same fleet."""
    out = {}
    for name, cls, srv, policy in (
            ("jax", JDispatcher, JServant,
             jpol.JaxShardedPolicy(max_servants=64)),
            ("port", TaskDispatcher, ServantInfo,
             tpol.TorchShardedPolicy(64, team=team(4)))):
        d = make_dispatcher(cls, srv, policy, 0)
        try:
            grants = d.wait_for_starting_new_task("envA", immediate=10,
                                                  timeout_s=15.0)
            out[name] = sorted(loc for _, loc in grants)
        finally:
            d.stop()
    assert out["port"] == out["jax"] and len(out["port"]) == 10


def test_router_reads_load_summary_on_its_team():
    """ShardRouter(team=...) (the JAX router's mesh): each shard's slice
    is reduced on its team device; the rows equal the one-device
    summary's, and a team of the wrong size raises the JAX message."""
    from yadcc_tpu_torch.scheduler.shard_router import ShardRouter

    def build(**kw):
        r = ShardRouter.build(lambda k: tpol.GreedyCpuPolicy(), 4,
                              max_servants_per_shard=16,
                              start_dispatch_thread=False, **kw)
        for i in range(12):
            r.keep_servant_alive(ServantInfo(
                location=f"10.0.1.{i}:8335", version=1, num_processors=8,
                capacity=1 + i % 3, memory_available=64 << 30,
                env_digests=("envA",)), 60.0)
        return r

    on_team, on_device = build(team=team(4)), build(device="cpu")
    try:
        rows = on_team.refresh_load_summary()
        assert np.array_equal(rows, on_device.refresh_load_summary())
        assert rows[:, 0].sum() == 12
    finally:
        on_team.stop()
        on_device.stop()
    with pytest.raises(ValueError, match="4 devices for 2 shards"):
        ShardRouter.build(lambda k: tpol.GreedyCpuPolicy(), 2,
                          max_servants_per_shard=16, team=team(4),
                          start_dispatch_thread=False)


def test_entry_serves_sharded_grouped_on_cpu():
    """--dispatch-policy torch_sharded_grouped --device cpu serves a
    grant over gRPC; the two entries' policy choices match, name for
    name (each JAX name has its port counterpart)."""
    import socket

    from yadcc_tpu.scheduler import entry as jentry
    from yadcc_tpu_torch import api
    from yadcc_tpu_torch.rpc import Channel, RpcError
    from yadcc_tpu_torch.scheduler import entry
    from yadcc_tpu_torch.scheduler.service import SERVICE_NAME

    def choices(parser):
        return next(a.choices for a in parser._actions
                    if a.dest == "dispatch_policy")

    counterpart = {"auto": "auto", "greedy_cpu": "greedy_cpu",
                   "jax_batched": "torch_batched",
                   "jax_pallas": "torch_batched",
                   "jax_grouped": "torch_grouped",
                   "jax_pallas_grouped": "torch_grouped",
                   "jax_sharded": "torch_sharded",
                   "jax_sharded_grouped": "torch_sharded_grouped"}
    jax_names = choices(jentry.build_arg_parser())
    port_names = choices(entry.build_arg_parser())
    assert sorted(jax_names) == sorted(counterpart)
    assert {counterpart[n] for n in jax_names} <= set(port_names)
    assert set(port_names) - {counterpart[n] for n in jax_names} == {
        "torch_resident_grouped"}

    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    args = entry.build_arg_parser().parse_args([
        "--port", str(port), "--inspect-port", "0", "--device", "cpu",
        "--max-servants", "64", "--acceptable-user-tokens", "utok",
        "--acceptable-servant-tokens", "stok", "--allow-self-dispatch",
        "--dispatch-policy", "torch_sharded_grouped"])
    stop = threading.Event()
    rc = []
    server = threading.Thread(
        target=lambda: rc.append(entry.scheduler_start(args, stop,
                                                       gc_guard=False)),
        daemon=True)
    server.start()
    sch = api.scheduler
    ch = Channel(f"grpc://127.0.0.1:{port}")
    try:
        for _ in range(300):
            try:
                ch.call(SERVICE_NAME, "GetConfig",
                        sch.GetConfigRequest(token="utok"),
                        sch.GetConfigResponse, timeout=1.0)
                break
            except RpcError:
                time.sleep(0.05)
        hb = sch.HeartbeatRequest(
            token="stok", next_heartbeat_in_ms=10_000,
            location="127.0.0.1:20001", version=1, num_processors=4,
            capacity=4, total_memory_in_bytes=64 << 30,
            memory_available_in_bytes=64 << 30)
        hb.env_descs.add(compiler_digest="env-a")
        ch.call(SERVICE_NAME, "Heartbeat", hb, sch.HeartbeatResponse,
                timeout=5.0)
        req = sch.WaitForStartingTaskRequest(
            token="utok", milliseconds_to_wait=2000, immediate_reqs=3,
            next_keep_alive_in_ms=10_000)
        req.env_desc.compiler_digest = "env-a"
        resp, _ = ch.call(SERVICE_NAME, "WaitForStartingTask", req,
                          sch.WaitForStartingTaskResponse, timeout=10.0)
        assert len(resp.grants) == 3
        assert {g.servant_location for g in resp.grants} == {
            "127.0.0.1:20001"}
    finally:
        ch.close()
        stop.set()
        server.join(timeout=30)
    assert rc == [0]


def plant_fault(policy):
    """The error word a card leaves when a slice's wait runs out, in a
    host buffer standing in for the policy's exchange buffer."""
    import ctypes

    from yadcc_tpu_torch.ops import team_exchange as tx

    buf = (ctypes.c_uint64 * tx.BUFFER_WORDS)()
    policy._exchange._ptr = ctypes.addressof(buf)
    buf[0] = tx.ERR_SPIN
    return buf


@pytest.mark.parametrize("name", ["torch_sharded", "torch_sharded_grouped"])
def test_a_fault_fails_one_cycle_and_the_next_cycle_runs(name):
    """A wait that ran out fails the cycle that sees it, and the same
    policy then assigns as before: the fault does not stick."""
    rng = np.random.default_rng(31)
    s = 64
    p = snapshot_np(rng, s)
    reqs = [tpol.AssignRequest(*r) for r in request_mix(rng, s, 8, 12)]
    policy = (tpol.TorchShardedPolicy(s, team=team(4))
              if name == "torch_sharded"
              else tpol.TorchShardedGroupedPolicy(team=team(4)))
    want = policy.assign(tpol.PoolSnapshot(**copy.deepcopy(p)), reqs)
    buf = plant_fault(policy)
    with pytest.raises(RuntimeError, match="ran out"):
        policy.assign(tpol.PoolSnapshot(**copy.deepcopy(p)), reqs)
    assert buf[0] == 0
    assert policy.assign(tpol.PoolSnapshot(**copy.deepcopy(p)),
                         reqs) == want
    assert sum(x >= 0 for x in want) > 0


def test_a_stream_fault_reseeds_the_chain():
    """A fault seen at a stream collect voids the chain's resident
    running: the next launch reseeds from the snapshot (one resync) and
    its picks are a fresh chain's."""
    rng = np.random.default_rng(32)
    s = 64
    p = snapshot_np(rng, s, cap_hi=20)
    descr = [(7, 1, -1, 9), (11, 1, 3, 5)]
    adj = np.zeros(s, np.int64)

    def chain():
        policy = tpol.TorchShardedGroupedPolicy(team=team(4))
        policy.stream_begin(tpol.PoolSnapshot(**copy.deepcopy(p), epoch=1))
        return policy

    fresh = chain()
    want = fresh.stream_collect(fresh.stream_launch(
        tpol.PoolSnapshot(**copy.deepcopy(p), epoch=1), descr, adj, {}))
    policy = chain()
    ticket = policy.stream_launch(
        tpol.PoolSnapshot(**copy.deepcopy(p), epoch=1), descr, adj, {})
    buf = plant_fault(policy)
    with pytest.raises(RuntimeError, match="ran out"):
        policy.stream_collect(ticket)
    assert buf[0] == 0
    ticket = policy.stream_launch(
        tpol.PoolSnapshot(**copy.deepcopy(p), epoch=2), descr, adj, {})
    assert np.array_equal(policy.stream_collect(ticket), want)
    assert policy.stream_stats()["resyncs"] == 1
    assert (want >= 0).sum() > 0
