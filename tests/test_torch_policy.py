"""The port's dispatch policies against the JAX package's, on the CPU.

Same snapshots (numpy, from a seed) and request lists through
JaxGroupedPolicy and TorchGroupedPolicy(device="cpu"), the greedy
oracle of both packages, AutoPolicy routing, and an identical pipelined
stream sequence."""

from __future__ import annotations

import numpy as np
import pytest

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
