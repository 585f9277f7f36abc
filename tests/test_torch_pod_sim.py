"""The port's pod-scale simulation (yadcc_tpu_torch/tools/pod_sim.py)
against the JAX package's: the capacity and hotspot parsers draw equal
fleets from one generator; a small threaded run holds the same
invariants in both packages (its outcomes depend on thread timing, so
they are not compared); the fused-grid gate and the aio pump rig run on
the CPU."""

from __future__ import annotations

import numpy as np
import pytest

from yadcc_tpu.tools import pod_sim as jps
from yadcc_tpu_torch.tools import pod_sim as tps


@pytest.mark.parametrize("spec", ["fixed", "uniform:4:16", "uniform:1:1",
                                  "bimodal:2:32:0.25", "bimodal:8:4:1.0"])
def test_capacity_dist_draws_equal_fleets(spec):
    draws = []
    for m in (jps, tps):
        rng = np.random.default_rng(3)
        sampler = m.parse_capacity_dist(spec, 7)
        draws.append([sampler(rng) for _ in range(500)])
    assert draws[0] == draws[1]
    assert all(type(v) is int for v in draws[1])


@pytest.mark.parametrize("bad", ["uniform:9:4", "bimodal:1:2", "nope",
                                 "uniform:0:4", "bimodal:0:2:0.5",
                                 "bimodal:1:2:1.5"])
def test_capacity_dist_refusals(bad):
    for m in (jps, tps):
        with pytest.raises(ValueError):
            m.parse_capacity_dist(bad, 8)


@pytest.mark.parametrize("spec,n", [(None, 32), ("none", 5),
                                    ("zipf:1.5", 32), ("zipf:0.4", 1000),
                                    ("zipf:3", 1)])
def test_hotspot_cdf_and_draws_equal(spec, n):
    j, t = jps.parse_hotspot(spec, n), tps.parse_hotspot(spec, n)
    if j is None:
        assert t is None
        return
    assert t.dtype == j.dtype and np.array_equal(t, j)
    u = np.random.default_rng(5).random(2000)
    assert np.array_equal(np.searchsorted(t, u), np.searchsorted(j, u))
    for bad in ("zipf:0", "zipf:-1", "zipf:", "pareto:1"):
        for m in (jps, tps):
            with pytest.raises(ValueError):
                m.parse_hotspot(bad, n)


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_small_run_holds_the_invariants(pkg):
    m, kw = (jps, {}) if pkg == "jax" else (tps, {"device": "cpu"})
    sim = m.PodSim(servants=48, capacity=4, policy="greedy_cpu",
                   exec_ms=4.0, churn_per_s=1, capacity_dist="uniform:2:8",
                   check_unique=True, **kw)
    out = sim.run(300, dup_rate=0.3, submitters=4)
    assert sim._dup_gids == 0 and len(sim._seen_gids) == \
        out["grants_granted"] > 0
    b = out["breakdown"]
    assert out["tasks"] == 300
    assert b["hit_cache"] + b["reused"] + b["actually_run"] == 300
    assert b["actually_run"] >= 210      # at least the unique TUs
    assert out["grants_granted"] == out["scheduler_stats"]["granted"]
    assert out["cache"]["fills"] == b["actually_run"] + b["retries"]
    lo, hi = out["capacity_min_max"]
    assert 2 <= lo <= hi <= 8
    lb = out["latency_breakdown"]
    for stage in ("queue_wait_ms", "snapshot_ms", "policy_ms",
                  "apply_ms", "dispatch_cycle_ms", "rpc_handler_ms",
                  "rpc_serialize_ms", "transport_ms", "grant_call_ms"):
        assert lb[stage] is not None and lb[stage]["count"] > 0, stage
    assert out["dispatch_only_p99_ms"] == lb["dispatch_cycle_ms"]["p99_ms"]


def test_sim_refuses_the_card_without_one():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tps.PodSim(servants=4, capacity=2, policy="greedy_cpu",
                   exec_ms=1.0, churn_per_s=0)
    args = tps.build_arg_parser().parse_args([])
    assert args.device == "cuda" and args.policy == "auto"


def test_smoke_device_on_the_cpu(capsys):
    """The fused grid gate at its own size: 4 shards, 20 lock-step
    cycles, every shard's picks against greedy_assign_reference."""
    args = tps.build_arg_parser().parse_args(
        ["--device", "cpu", "--device-resident", "--smoke"])
    assert tps.smoke_device(args) == 0
    assert '"failures": []' in capsys.readouterr().out


def test_aio_pump_rig_on_the_cpu():
    args = tps.build_arg_parser().parse_args([
        "--device", "cpu", "--pump-rig", "--frontend", "aio",
        "--servants", "64", "--capacity", "4", "--policy", "greedy_cpu",
        "--churn-per-s", "0", "--pumps", "4", "--pump-batch", "16",
        "--hb-interval", "2.0", "--rig-calls", "300", "--rig-demand", "64"])
    out = tps.run_pump_rig_one(args)
    assert out["frontend"] == "aio" and out["grant_calls"] >= 300
    assert out["grants_granted"] > 0
    assert out["grant_call_p99_ms"] >= out["grant_call_p50_ms"] > 0
    assert out["latency_breakdown"]["frontend_stages"] is not None


def test_sharded_smoke_on_the_cpu(capsys):
    args = tps.build_arg_parser().parse_args(
        ["--device", "cpu", "--shards", "4", "--smoke"])
    assert tps.smoke(args) == 0
    assert '"failures": []' in capsys.readouterr().out
