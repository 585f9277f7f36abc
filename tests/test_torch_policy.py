"""The port's dispatch policies against the JAX package's, on the CPU.

Same snapshots (numpy, from a seed) and request lists through each JAX
policy and its port on device="cpu": the grouped, batched-scan and
resident-stream policies, the greedy oracle of both packages, AutoPolicy
routing, and identical pipelined stream sequences."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from yadcc_tpu.scheduler import policy as jpol
from yadcc_tpu_torch.ops import assignment as tasn
from yadcc_tpu_torch.scheduler import policy as tpol


def snapshot_np(rng, s, cap_hi=12):
    cap = rng.integers(0, cap_hi, s).astype(np.int32)
    return dict(
        alive=rng.random(s) < 0.92,
        capacity=cap,
        running=np.minimum(rng.integers(0, 4, s), cap).astype(np.int32),
        dedicated=rng.random(s) < 0.25,
        version=rng.integers(1, 3, s).astype(np.int32),
        env_bitmap=rng.integers(0, 2**32, (s, 8),
                                dtype=np.uint64).astype(np.uint32),
    )


def snaps(p, epoch=-1):
    """The same arrays as one snapshot of each package (copies: policies
    never share buffers)."""
    j = jpol.PoolSnapshot(**{k: v.copy() for k, v in p.items()},
                          epoch=epoch)
    t = tpol.PoolSnapshot(**{k: v.copy() for k, v in p.items()},
                          epoch=epoch)
    return j, t


def request_mix(rng, s, n_runs, run_hi, long_run=0):
    """Runs of identical descriptors, as a dispatcher's backlog forms
    them; `long_run` adds one run longer than the policy's task cap."""
    reqs = []
    for _ in range(n_runs):
        e, v, r = (int(rng.integers(0, 256)), int(rng.integers(1, 3)),
                   int(rng.integers(-1, s)))
        reqs += [(e, v, r)] * int(rng.integers(1, run_hi))
    if long_run:
        reqs += [(int(rng.integers(0, 256)), 1, -1)] * long_run
    return reqs


def both(reqs):
    return ([jpol.AssignRequest(*r) for r in reqs],
            [tpol.AssignRequest(*r) for r in reqs])


@pytest.fixture(params=["host", "device"])
def expand_route(request, monkeypatch):
    """Both expansion routes: counts expanded on the host, and picks
    expanded where the assignment ran (the port's route on the card)."""
    monkeypatch.setenv("YTPU_GROUPED_EXPAND", request.param)
    return request.param


def torch_grouped(route):
    pol = tpol.TorchGroupedPolicy("cpu")
    if route == "device":
        pol._decide_expand = lambda: True
    return pol


@pytest.mark.parametrize("seed,s,n_runs,run_hi,long_run", [
    (0, 256, 12, 40, 0),
    (1, 512, 90, 6, 0),          # more than 64 groups: several chunks
    (2, 384, 5, 20, 2300),       # one run longer than _TASK_CAP
])
def test_grouped_policy_matches_jax(expand_route, seed, s, n_runs, run_hi,
                                    long_run):
    rng = np.random.default_rng(seed)
    p = snapshot_np(rng, s, cap_hi=40 if long_run else 12)
    reqs = request_mix(rng, s, n_runs, run_hi, long_run)
    jr, tr = both(reqs)
    js, ts = snaps(p)
    want = jpol.JaxGroupedPolicy().assign(js, jr)
    got = torch_grouped(expand_route).assign(ts, tr)
    assert got == want
    # ...and equal to the greedy oracle up to permutation within runs.
    oracle = tpol.GreedyCpuPolicy().assign(ts, tr)
    assert sorted(got) == sorted(oracle)
    assert sum(x != tasn.NO_PICK for x in got) > 0


def test_greedy_policy_matches_jax():
    rng = np.random.default_rng(4)
    p = snapshot_np(rng, 300)
    reqs = request_mix(rng, 300, 20, 15)
    jr, tr = both(reqs)
    js, ts = snaps(p)
    assert tpol.GreedyCpuPolicy().assign(ts, tr) == \
        jpol.GreedyCpuPolicy().assign(js, jr)
    assert tpol.compress_runs(tr) == jpol.compress_runs(jr)


def test_auto_routing_matches_jax():
    for s in (16, 128, 800, 5120, 8192):
        jsnap, tsnap = snaps(snapshot_np(np.random.default_rng(s), s))
        for n in (0, 1, 2, 3, 7, 64, 5000):
            for thr in (None, 1, 100):
                ja = jpol.AutoPolicy(device_threshold=thr)
                ta = tpol.AutoPolicy("cpu", device_threshold=thr)
                assert ta._use_greedy(tsnap, n) == \
                    ja._use_greedy(jsnap, n), (s, n, thr)


def test_auto_policy_outcomes_match_jax():
    rng = np.random.default_rng(6)
    p = snapshot_np(rng, 256)
    for thr in (1, 10_000):      # device route, then greedy route
        reqs = request_mix(rng, 256, 8, 30)
        jr, tr = both(reqs)
        js, ts = snaps(p)
        assert tpol.AutoPolicy("cpu", device_threshold=thr).assign(ts, tr) \
            == jpol.AutoPolicy(device_threshold=thr).assign(js, jr)


def test_make_policy_names():
    assert tpol.make_policy("greedy_cpu").name == "greedy_cpu"
    assert tpol.make_policy("torch_grouped", device="cpu").name == \
        "torch_grouped"
    auto = tpol.make_policy("auto", avoid_self=False, device="cpu")
    assert auto.name == "auto" and not auto._greedy._cm.avoid_self
    with pytest.raises(ValueError):
        tpol.make_policy("jax_grouped")


def test_stream_sequence_matches_jax():
    """begin, several launches with host corrections (adj) and absolute
    resets, collect: identical picks per launch and an identical chained
    running array."""
    rng = np.random.default_rng(12)
    s = 256
    p = snapshot_np(rng, s, cap_hi=20)
    jp, tp = jpol.JaxGroupedPolicy(), tpol.TorchGroupedPolicy("cpu")
    js, ts = snaps(p, epoch=1)
    jp.stream_begin(js)
    tp.stream_begin(ts)
    for step in range(5):
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
        assert np.array_equal(tp._stream_running.numpy(),
                              np.asarray(jp._stream_running))
    assert tp.stream_stats() == jp.stream_stats()
    js, ts = snaps(p, epoch=0)
    with pytest.raises(ValueError, match="moved backward"):
        tp.stream_launch(ts, [(0, 1, -1, 1)], np.zeros(s, np.int64), {})


@pytest.mark.parametrize("seed,s,n_req", [(20, 200, 70), (21, 96, 40)])
def test_batched_policy_matches_jax(seed, s, n_req):
    """torch_batched against jax_batched (XLA scan) and jax_pallas (the
    Pallas K2 in interpret mode), in chunks of 32 with running carried
    between them: the same picks, request for request, which are also
    the greedy oracle's."""
    rng = np.random.default_rng(seed)
    p = snapshot_np(rng, s, cap_hi=2)     # contended: grants and denials
    reqs = request_mix(rng, s, 12, 12)[:n_req]
    jr, tr = both(reqs)
    got = tpol.TorchBatchedPolicy("cpu", max_batch=32).assign(snaps(p)[1],
                                                              tr)
    for jp in (jpol.JaxBatchedPolicy(s, max_batch=32),
               jpol.JaxPallasPolicy(s, max_batch=32)):
        assert got == jp.assign(snaps(p)[0], jr), jp.name
    assert got == tpol.GreedyCpuPolicy().assign(snaps(p)[1], tr)
    assert 0 < sum(x != tasn.NO_PICK for x in got) < len(got)


def test_batched_policy_collects_once_per_cycle(monkeypatch):
    """A cycle of 2.5 x max_batch requests: three launches with `running`
    chained between them, one collect of all 80 picks at the end (the
    cycle's only .tolist()), and jax_pallas's picks."""
    rng = np.random.default_rng(22)
    s = 128
    p = snapshot_np(rng, s, cap_hi=3)
    reqs = request_mix(rng, s, 40, 10)[:80]
    jr, tr = both(reqs)
    launches, collects = [], []
    launch, tolist = tpol.kassign.cuda_assign_batch, torch.Tensor.tolist
    monkeypatch.setattr(tpol.kassign, "cuda_assign_batch",
                        lambda *a, **k: launches.append(1) or launch(*a, **k))
    monkeypatch.setattr(torch.Tensor, "tolist",
                        lambda t: collects.append(t.shape) or tolist(t))
    got = tpol.TorchBatchedPolicy("cpu", max_batch=32).assign(snaps(p)[1],
                                                              tr)
    monkeypatch.undo()
    assert len(launches) == 3 and collects == [torch.Size([80])]
    assert got == jpol.JaxPallasPolicy(s, max_batch=32).assign(snaps(p)[0],
                                                               jr)
    assert 0 < sum(x != tasn.NO_PICK for x in got) < len(got)
    assert tpol.TorchBatchedPolicy("cpu").assign(snaps(p)[1], []) == []


def test_resident_stream_sequence_matches_jax():
    """torch_resident_grouped against jax_resident_grouped: begin, then
    launches with statics churn streamed as dirty deltas (one of them past
    S/8, one with lost tracking), host corrections and resets — identical
    picks per launch, an identical resident running array, and identical
    stream counters, the oracle included."""
    from .test_device_resident import churn_slots

    rng = np.random.default_rng(13)
    s = 128
    p = snapshot_np(rng, s, cap_hi=20)
    jp = jpol.JaxResidentGroupedPolicy(use_pallas=False, oracle_interval=2)
    tp = tpol.TorchResidentGroupedPolicy("cpu", oracle_interval=2)
    assert tp.supports_resident and tp.supports_stream
    js, ts = snaps(p, epoch=1)
    jp.stream_begin(js)
    tp.stream_begin(ts)
    for step in range(6):
        dirty = churn_slots(rng, p, {3: s // 4}.get(step, 3))
        if step == 4:
            dirty = None
        descr = [(int(rng.integers(0, 256)), 1, int(rng.integers(-1, s)),
                  int(rng.integers(1, 40))) for _ in range(1 + step)]
        adj = np.zeros(s, np.int64)
        adj[rng.integers(0, s, 10)] -= 1
        resets = {int(k): int(rng.integers(0, 3))
                  for k in rng.integers(0, s, 2)}
        js, ts = snaps(p, epoch=2 + step)
        jt = jp.stream_launch(js, descr, adj, resets, dirty=dirty)
        tt = tp.stream_launch(ts, descr, adj, resets, dirty=dirty)
        assert tp.stream_ready(tt)
        assert tt.launch_id == jt.launch_id == step
        assert np.array_equal(tp.stream_collect(tt), jp.stream_collect(jt))
        assert np.array_equal(tp.resident_pool.running.numpy(),
                              np.asarray(jp.resident_pool.running))
    stats = tp.stream_stats()
    assert stats == jp.stream_stats()
    assert stats["full_syncs"] == 2 and stats["oracle_checks"] == 3
    assert stats["oracle_mismatches"] == 0


def test_make_policy_port_names():
    """Every --dispatch-policy name of the port builds its policy; each
    stands for JAX policies of the same semantics."""
    assert tpol.POLICY_NAMES == ("auto", "greedy_cpu", "torch_grouped",
                                 "torch_batched", "torch_resident_grouped",
                                 "torch_sharded", "torch_sharded_grouped")
    for name in tpol.POLICY_NAMES:
        assert tpol.make_policy(name, device="cpu").name == name
    assert isinstance(tpol.make_policy("torch_batched", device="cpu"),
                      tpol.TorchBatchedPolicy)
    res = tpol.make_policy("torch_resident_grouped", avoid_self=False,
                           device="cpu")
    assert res.supports_resident and not res.resident_pool._cm.avoid_self
    team = (torch.device("cpu"),) * 4
    sharded = tpol.make_policy("torch_sharded_grouped", avoid_self=False,
                               device="cpu", team=team)
    assert isinstance(sharded, tpol.TorchShardedGroupedPolicy)
    assert sharded._team == team and not sharded._cm.avoid_self
    assert tpol.make_policy("torch_sharded", device="cpu")._team == \
        (torch.device("cpu"),)
    with pytest.raises(ValueError, match="must divide evenly"):
        tpol.make_policy("torch_sharded", device="cpu", team=team,
                         max_servants=66)
    for name in ("jax_batched", "jax_pallas", "jax_resident_grouped"):
        with pytest.raises(ValueError):
            tpol.make_policy(name, device="cpu")


def test_auto_calibration_measures_a_crossover():
    """warmup() runs both routes and places the crossover from the
    measurement (the plain version stands in for the kernel here)."""
    auto = tpol.AutoPolicy("cpu")
    auto.warmup(128)
    assert auto._measured_threshold is not None
    assert auto._measured_threshold >= 1.0
    _, tsnap = snaps(snapshot_np(np.random.default_rng(9), 128))
    n = 4096
    assert auto._use_greedy(tsnap, n) == (n < auto._measured_threshold)
