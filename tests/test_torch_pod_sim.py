"""The port's pod-scale simulation (yadcc_tpu_torch/tools/pod_sim.py)
against the JAX package's: the capacity and hotspot parsers draw equal
fleets from one generator; a small threaded run holds the same
invariants in both packages, synchronous and pipelined (its outcomes
depend on thread timing, so they are not compared); both refuse a
pipeline depth on a policy without the stream API; the command lines
and run_one's hand-over are equal; the fused-grid gate and the aio pump
rig run on the CPU."""

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


# (package, policy, pipeline depth): the host policy synchronous under
# the ids this test had before it took depths, and the grouped device
# policy synchronous and at depth 16.
RUNS = [pytest.param("jax", "greedy_cpu", 0, id="jax"),
        pytest.param("port", "greedy_cpu", 0, id="port"),
        pytest.param("jax", "grouped", 0, id="jax-grouped"),
        pytest.param("port", "grouped", 0, id="port-grouped"),
        pytest.param("jax", "grouped", 16, id="jax-grouped-depth16"),
        pytest.param("port", "grouped", 16, id="port-grouped-depth16"),
        pytest.param("port", "sharded_grouped", 16,
                     id="port-sharded-grouped-depth16")]


@pytest.mark.parametrize("pkg,policy,depth", RUNS)
def test_small_run_holds_the_invariants(pkg, policy, depth):
    """greedy_cpu synchronous, and the grouped device policy
    (jax_grouped / torch_grouped on the CPU) synchronous and at pipeline
    depth 16, the mode the entry takes on the card, and the port's
    torch_sharded_grouped over a team of 4 CPU slices at depth 16 (the
    team where the JAX tool builds a mesh): every task
    accounted for, no grant id twice, the client's grants equal to the
    scheduler's, every stage timed."""
    if policy in ("grouped", "sharded_grouped"):
        policy = ("jax_" if pkg == "jax" else "torch_") + policy
    m, kw = ((jps, {"policy": policy}) if pkg == "jax" else
             (tps, {"policy": policy, "device": "cpu"}))
    if policy == "torch_sharded_grouped":
        from yadcc_tpu_torch.parallel import mesh
        kw["team"] = mesh.make_team(4, "cpu")
    sim = m.PodSim(servants=48, capacity=4, exec_ms=4.0, churn_per_s=1,
                   capacity_dist="uniform:2:8", check_unique=True,
                   pipeline_depth=depth, **kw)
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
    stages = ["queue_wait_ms", "snapshot_ms", "policy_ms", "apply_ms",
              "rpc_handler_ms", "rpc_serialize_ms", "transport_ms",
              "grant_call_ms"]
    if depth == 0:
        stages.append("dispatch_cycle_ms")
        assert out["dispatch_only_p99_ms"] == lb["dispatch_cycle_ms"][
            "p99_ms"]
    else:
        # The pipelined loop times no synchronous cycle.
        assert lb["dispatch_cycle_ms"] is None
        assert sim.dispatcher._pipelined
        assert sim.dispatcher.inspect()["stream"]["resyncs"] == 0
    for stage in stages:
        assert lb[stage] is not None and lb[stage]["count"] > 0, stage


def test_stream_depth_on_a_host_policy_raises_in_both():
    """greedy_cpu has no stream API: both packages refuse a depth above 0
    while they build the sim, with the same error."""
    errors = []
    for m, kw in ((jps, {}), (tps, {"device": "cpu"})):
        with pytest.raises(AttributeError) as e:
            m.PodSim(servants=8, capacity=2, policy="greedy_cpu",
                     exec_ms=1.0, churn_per_s=0, pipeline_depth=16, **kw)
        errors.append(str(e.value))
    assert errors[0] == errors[1] and "stream_warmup" in errors[0]


def _options(ap):
    return {a.dest: (tuple(a.option_strings), a.default, a.type, a.choices,
                     type(a).__name__)
            for a in ap._actions if a.dest != "help"}


def test_parsers_take_the_jax_options():
    """The port's command line is the JAX tool's, defaults included, plus
    --device (the card unless the caller asks for the CPU)."""
    j = _options(jps.build_arg_parser())
    t = _options(tps.build_arg_parser())
    assert t.pop("device")[1] == "cuda"
    assert t == j
    argv = ["--pipeline-depth", "16", "--delegates", "7", "--arrival-rate",
            "250", "--steal-batch", "9", "--no-steal", "--switch-interval",
            "0.004"]
    assert vars(tps.build_arg_parser().parse_args(argv)) == dict(
        vars(jps.build_arg_parser().parse_args(argv)), device="cuda")


def test_run_one_passes_the_options_through(monkeypatch):
    """run_one hands the command line's depth, delegates, arrival rate and
    steal batch to PodSim, as the JAX tool's does."""
    seen = {}

    class Recording:
        def __init__(self, *a, **kw):
            seen.update(kw)

        def run(self, tasks, dup_rate, submitters):
            return {"tasks": tasks}

    for m, extra in ((jps, []), (tps, ["--device", "cpu"])):
        seen.clear()
        monkeypatch.setattr(m, "PodSim", Recording)
        args = m.build_arg_parser().parse_args(
            ["--pipeline-depth", "16", "--delegates", "7", "--arrival-rate",
             "250", "--steal-batch", "9"] + extra)
        assert m.run_one(args, shards=2, hotspot=None, steal=False,
                         tasks=5) == {"tasks": 5}
        assert {k: seen[k] for k in ("pipeline_depth", "delegates",
                                     "arrival_rate", "steal_batch",
                                     "steal", "shards")} == {
            "pipeline_depth": 16, "delegates": 7, "arrival_rate": 250.0,
            "steal_batch": 9, "steal": False, "shards": 2}


def test_main_honours_switch_interval_and_no_steal(monkeypatch, capsys):
    import logging
    import os
    import sys

    seen = {}

    def fake_run_one(args, *, shards, hotspot, steal, tasks):
        seen.update(steal=steal, switch=sys.getswitchinterval())
        return {"ok": 1}

    monkeypatch.setattr(tps, "run_one", fake_run_one)
    monkeypatch.setattr(os, "setpriority", lambda *a: None)
    monkeypatch.setenv("YTPU_LOG_LEVEL", "WARNING")
    level = logging.getLogger().level
    switch = sys.getswitchinterval()
    try:
        tps.main(["--device", "cpu", "--no-steal", "--switch-interval",
                  "0.004"])
    finally:
        sys.setswitchinterval(switch)
        logging.getLogger().setLevel(level)
    assert seen == {"steal": False, "switch": 0.004}
    assert '"ok": 1' in capsys.readouterr().out


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
