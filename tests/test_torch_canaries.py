"""The thirteen riding-along canaries of the port's tools
(yadcc_tpu_torch/tools/{cluster_sim,dataplane_bench,pod_sim,scenarios}.py)
against the JAX package's twins.

A canary is a fixed small run of a runner and a few numbers read from
its result, so each package's canary is given the same stub runner, which
records its calls and returns seeded results: the calls must be equal
(apart from the port's ``device``, which the port passes on where its
runner takes one), and so must the returned values and the raises.  The
literal arguments of each canary are read from both sources with ``ast``
and held equal.  The cheap ones run for real on the CPU: the data-plane
sweep, and a cluster_sim workload on greedy_cpu with torch, jax and the
JAX package blocked (greedy_cpu never reads the device)."""

from __future__ import annotations

import argparse
import ast
import inspect
import math
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

from yadcc_tpu.tools import cluster_sim as jcs
from yadcc_tpu.tools import dataplane_bench as jdb
from yadcc_tpu.tools import pod_sim as jps
from yadcc_tpu.tools import scenarios as jsc
from yadcc_tpu_torch.tools import cluster_sim as tcs
from yadcc_tpu_torch.tools import dataplane_bench as tdb
from yadcc_tpu_torch.tools import pod_sim as tps
from yadcc_tpu_torch.tools import scenarios as tsc

REPO = Path(__file__).resolve().parent.parent
MODULES = {"cluster_sim": (jcs, tcs), "dataplane_bench": (jdb, tdb),
           "pod_sim": (jps, tps), "scenarios": (jsc, tsc)}

# canary -> (module, runner, whether the port's runner takes the device)
CANARIES = {
    "quick_accept_loops_scaling": ("cluster_sim", "run_storm", False),
    "quick_servant_parked_waiters": ("cluster_sim", "run_servant_park",
                                     False),
    "quick_storm_concurrent_connections": ("cluster_sim", "run_storm",
                                           False),
    "quick_jit_compiles_per_sec": ("cluster_sim", "run", True),
    "quick_aot_fanout_compiles_per_sec": ("cluster_sim", "run", True),
    "quick_autotune_sweep_dedup_ratio": ("cluster_sim", "run", True),
    "quick_dataplane_mb_per_sec": ("dataplane_bench", "run_sweep", False),
    "quick_sharded_assignments_per_sec": ("pod_sim", "run_one", True),
    "quick_aio_grant_call_p99_ms": ("pod_sim", "run_pump_rig_one", True),
    "quick_hostile_metrics": ("scenarios", "run_scenario", True),
    "quick_spill_affinity_metrics": ("scenarios", "run_scenario", True),
    "quick_coldregion_metrics": ("scenarios", "run_scenario", True),
    "quick_tenancy_metrics": ("scenarios", "run_scenario", True),
}


def seeded_result(seed: int) -> dict:
    """A runner result holding every key a canary reads, drawn from
    ``seed``: the clean case (no errors, no failures, every reply)."""
    rng = np.random.default_rng(seed)

    def num():
        return round(float(rng.uniform(0.01, 500.0)), 3)

    return {
        # run_storm
        "error_rate": 0.0, "lost_or_hung": 0, "rpc_accept_p99_ms": num(),
        "accept_p99_ms": num(),
        "concurrent_connections": int(rng.integers(1, 500)),
        # run_servant_park
        "waiters": 600, "replies_done": 600,
        "threads_per_waiter": float(rng.uniform(0.0, 0.01)),
        "parked_waiters_peak": int(rng.integers(1, 600)),
        # cluster_sim.run
        "failures": [], "jit_compiles_per_sec": num(),
        "aot_topology_compiles_per_sec": num(), "dedup_ratio": num(),
        # dataplane_bench.run_sweep
        "copy_path": {"zero_copy_mb_per_sec": num()},
        # pod_sim
        "assignments_per_sec": num(), "grant_call_p99_ms": num(),
        # scenarios.run_scenario
        "reject_p99_ms": num(), "compile_success_rate": num(),
        "failover_time_ms": num(), "scored_hit_rate": num(),
        "placement_score_p99_us": num(),
        "prefetch_off": {"final_hit_rate": num()},
        "prefetch_on": {"time_to_warm_s": num()},
        "victim_share_ratio": num(),
        "victim_fill_actually_run": bool(rng.integers(0, 2)),
        "cross_tenant_read_blocked": bool(rng.integers(0, 2)),
        "poison_blocked": bool(rng.integers(0, 2)),
    }


# Results that take another branch of a canary: each but the accept-p99
# fallback is one that a JAX twin which checks its run refuses.
BRANCHES = {
    "error_rate": {"error_rate": 0.25},
    "lost_or_hung": {"lost_or_hung": 3},
    "rpc_accept_fallback": {"rpc_accept_p99_ms": None},
    "replies_missing": {"replies_done": 599},
    "threads_per_waiter": {"threads_per_waiter": 0.5},
    "failures": {"failures": ["task 7 lost"]},
}


def _normalise(value, device_seen: list):
    """A call's argument with the port's device taken out and recorded."""
    if isinstance(value, argparse.Namespace):
        d = dict(vars(value))
        if "device" in d:
            device_seen.append(d.pop("device"))
        return ("Namespace", d)
    return value


def drive(mod, name: str, runner: str, result: dict):
    """(calls, devices, outcome) of canary ``name`` of ``mod`` with its
    runner replaced by a recorder returning ``result`` for each call."""
    calls, devices = [], []

    def stub(*args, **kw):
        if "device" in kw:
            devices.append(kw.pop("device"))
        calls.append(([_normalise(a, devices) for a in args],
                      {k: _normalise(v, devices) for k, v in kw.items()}))
        return result

    real = getattr(mod, runner)
    setattr(mod, runner, stub)
    try:
        outcome = ("value", getattr(mod, name)())
    except Exception as e:   # the raises are compared, type and text
        outcome = ("raise", type(e).__name__, str(e))
    finally:
        setattr(mod, runner, real)
    return calls, devices, outcome


@pytest.mark.parametrize("name", sorted(CANARIES))
def test_canary_equals_its_jax_twin_on_one_stub(name):
    module, runner, takes_device = CANARIES[name]
    jmod, tmod = MODULES[module]
    results = [("clean", seeded_result(s)) for s in (0, 1, 2)] + [
        (branch, dict(seeded_result(3), **patch))
        for branch, patch in BRANCHES.items()]
    raised = 0
    for label, result in results:
        j_calls, j_dev, j_out = drive(jmod, name, runner, result)
        t_calls, t_dev, t_out = drive(tmod, name, runner, result)
        assert t_calls == j_calls, (label, t_calls, j_calls)
        assert t_out == j_out, label
        assert not j_dev
        assert t_dev == (["cuda"] * len(t_calls) if takes_device else [])
        assert j_calls
        raised += j_out[0] == "raise"
    # Every canary that checks its run refuses at least one fault.
    assert raised > 0 or name not in (
        "quick_accept_loops_scaling", "quick_servant_parked_waiters",
        "quick_storm_concurrent_connections", "quick_jit_compiles_per_sec",
        "quick_aot_fanout_compiles_per_sec",
        "quick_autotune_sweep_dedup_ratio")


def _literals(func) -> list:
    """The constants of ``func``'s body (its docstring aside), in source
    order; the port's "--device" flag is not one of the JAX tool's."""
    tree = ast.parse(textwrap.dedent(inspect.getsource(func)))
    body = tree.body[0].body
    if (body and isinstance(body[0], ast.Expr)
            and isinstance(body[0].value, ast.Constant)):
        body = body[1:]
    out = []
    for stmt in body:
        for node in ast.walk(stmt):
            if isinstance(node, ast.Constant) and node.value != "--device":
                out.append((node.lineno, node.col_offset, node.value))
    return [v for _, _, v in sorted(out, key=lambda x: x[:2])]


@pytest.mark.parametrize("name", sorted(CANARIES))
def test_canary_literals_are_the_jax_sources(name):
    """Sizes, rates, policy names and gates as the JAX source writes
    them, read from both sources."""
    jmod, tmod = MODULES[CANARIES[name][0]]
    want = _literals(getattr(jmod, name))
    assert want, name
    assert _literals(getattr(tmod, name)) == want


@pytest.mark.parametrize("name", sorted(CANARIES))
def test_port_canary_takes_the_card_by_default(name):
    """Where the port's runner takes a device, the canary takes one too,
    the card unless the caller asks for the CPU."""
    params = inspect.signature(
        getattr(MODULES[CANARIES[name][0]][1], name)).parameters
    if CANARIES[name][2]:
        assert params["device"].default == "cuda"
    else:
        assert "device" not in params


def test_dataplane_canary_runs_on_the_cpu():
    mb_s = tdb.quick_dataplane_mb_per_sec()
    assert isinstance(mb_s, float) and math.isfinite(mb_s) and mb_s > 0


def test_greedy_cpu_workload_canary_runs_without_torch():
    """quick_autotune_sweep_dedup_ratio runs the whole loopback farm on
    greedy_cpu: with torch, jax and the JAX package blocked and its
    default device (no card here), it runs and loads none of them."""
    script = textwrap.dedent(r"""
        import sys
        for name in ("torch", "jax", "jaxlib", "yadcc_tpu"):
            sys.modules[name] = None
        from yadcc_tpu_torch.tools import cluster_sim
        ratio = cluster_sim.quick_autotune_sweep_dedup_ratio()
        loaded = sorted(n for n in sys.modules if sys.modules[n] is not None
                        and n.split(".")[0] in ("torch", "jax", "jaxlib",
                                                "yadcc_tpu"))
        assert not loaded, loaded
        print("RATIO", ratio)
    """)
    out = subprocess.run([sys.executable, "-c", script], cwd=REPO,
                         capture_output=True, text=True, timeout=180)
    assert out.returncode == 0, out.stderr[-3000:]
    ratio = float(out.stdout.split("RATIO")[-1])
    assert 0.0 <= ratio <= 1.0
