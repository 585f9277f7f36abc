"""The port's cluster sweep (yadcc_tpu_torch/tools/cluster_sim.py)
against the JAX package's (yadcc_tpu/tools/cluster_sim.py), on the CPU.

Which duplicate is a cache hit, a join or a run depends on timing, so
the two packages are held to the same corpus (byte for byte, for two
seeds), the same report keys and the same invariants, not to equal
counts: no failure, every submission resolved, every unique source run
at least once, dedup engaged on the duplicate-heavy corpora, and no
grant outstanding in the scheduler once the rig has stopped.  The JAX
package's own run is driven by tests/test_cluster_rig.py; here only its
corpus functions run.  Here the C++ and jit sweeps, the steal
helpers and the entry's refusal without a card; the fan-out sweeps and
the servant park are in tests/test_torch_cluster_fanout.py, the
connection storm and its server subprocess in
tests/test_torch_cluster_storm.py.
"""

from __future__ import annotations

import ast
import inspect

import numpy as np
import pytest

import yadcc_tpu_torch.testing as ttesting
from yadcc_tpu.tools import cluster_sim as jcs
from yadcc_tpu_torch.tools import cluster_sim as tcs


def _jax_corpus(workload, tasks, n_unique, tu_size_dist, rng):
    """The JAX run()'s corpus, drawn as its body draws it (the block
    after `rng = np.random.default_rng(1)` in
    yadcc_tpu/tools/cluster_sim.py:run), from the JAX helpers."""
    aot_plans = tune_plans = None
    if workload in ("jit", "aot", "autotune"):
        picks = jcs._zipf_picks(tasks, n_unique, rng)
        if workload == "aot":
            sources = jcs._make_stablehlo_corpus(n_unique, rng)
            aot_plans = jcs._make_aot_plans(n_unique, rng)
        elif workload == "autotune":
            sources = jcs._make_kernel_corpus(n_unique, rng)
            tune_plans = jcs._make_autotune_plans(n_unique, rng)
        else:
            sources = jcs._make_stablehlo_corpus(n_unique, rng)
        return sources, picks, aot_plans, tune_plans
    sampler = jcs._parse_tu_size_dist(tu_size_dist)
    if sampler is None:
        sources = [f"// TU {i}\nint f{i}() {{ return {i}; }}\n".encode()
                   for i in range(n_unique)]
    else:
        sources = jcs._make_sized_sources(n_unique, sampler, rng)
    picks = list(range(n_unique)) + list(
        rng.integers(0, n_unique, tasks - n_unique))
    rng.shuffle(picks)
    return sources, picks, aot_plans, tune_plans


def _topo(t):
    return (tuple(t.mesh_shape), t.device_count)


@pytest.mark.parametrize("seed", [1, 2])
@pytest.mark.parametrize("workload,tu_size_dist", [
    ("cxx", ""), ("cxx", "uniform:100:3000"), ("jit", ""), ("aot", ""),
    ("autotune", "")])
def test_corpus_byte_equal_to_the_jax_package(seed, workload, tu_size_dist):
    tasks, n_unique = 300, 210
    want = _jax_corpus(workload, tasks, n_unique, tu_size_dist,
                       np.random.default_rng(seed))
    got = tcs.make_corpus(workload, tasks, n_unique, tu_size_dist,
                          np.random.default_rng(seed))
    assert got[0] == want[0]                       # source bytes
    assert [int(p) for p in got[1]] == [int(p) for p in want[1]]
    assert sorted(set(int(p) for p in got[1])) == list(range(n_unique))
    if workload == "aot":
        assert [[_topo(t) for t in plan] for plan in got[2]] == \
            [[_topo(t) for t in plan] for plan in want[2]]
    if workload == "autotune":
        assert got[3] == want[3]                   # canonical-JSON configs


def _keys(fn):
    """Every string key the report of ``fn`` (a run function) can carry:
    its `out = {...}` literal, every `out[...] = ...` assignment and the
    dict it returns as a literal."""
    tree = ast.parse(inspect.getsource(fn).lstrip())
    keys = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Return) and isinstance(node.value, ast.Dict):
            keys |= {k.value for k in node.value.keys
                     if isinstance(k, ast.Constant)}
        if isinstance(node, ast.AnnAssign) and \
                isinstance(node.value, ast.Dict) and \
                getattr(node.target, "id", None) == "out":
            keys |= {k.value for k in node.value.keys
                     if isinstance(k, ast.Constant)}
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            target = node.targets[0]
            if isinstance(target, ast.Name) and target.id == "out" and \
                    isinstance(node.value, ast.Dict):
                keys |= {k.value for k in node.value.keys
                         if isinstance(k, ast.Constant)}
            if isinstance(target, ast.Subscript) and \
                    isinstance(target.value, ast.Name) and \
                    target.value.id == "out" and \
                    isinstance(target.slice, ast.Constant):
                keys.add(target.slice.value)
    return keys


@pytest.mark.parametrize("name", ["run", "run_storm", "run_servant_park",
                                  "run_steal_storm_ab"])
def test_report_keys_equal_to_the_jax_package(name):
    assert _keys(getattr(tcs, name)) == _keys(getattr(jcs, name))
    assert _keys(tcs.run) >= {"tasks_per_sec", "p99_latency_ms",
                              "breakdown", "dedup_ratio", "lost_or_hung"}


class _Recording(ttesting.LocalCluster):
    made: list = []

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        _Recording.made.append(self)


def _run_checked(monkeypatch, workload, tasks, dup_rate, concurrency=2,
                 in_flight=4):
    """The port's run() on the CPU (2 servants of 2 slots, K1's plain
    version) with phase 18's invariants.  As many submissions in flight
    as the rig has slots: past that, a waiting request is picked up on
    the delegate's next grant poll (1 to 2 s a wait, in both packages),
    which the card's phase 18 sweep runs into and this test would only
    spend time on."""
    monkeypatch.setattr(ttesting, "LocalCluster", _Recording)
    _Recording.made.clear()
    out = tcs.run(tasks, 2, concurrency, dup_rate, "torch_grouped",
                  in_flight=in_flight, compile_s=0.0, workload=workload,
                  device="cpu")
    assert set(out) <= _keys(jcs.run)
    assert out["workload"] == workload and out["tasks"] == tasks
    assert out["failures"] == 0, out
    assert out["tasks_per_sec"] > 0
    (cluster,) = _Recording.made
    # Every grant went back: the rig has stopped and the scheduler holds
    # none.
    assert cluster.sched_dispatcher.inspect()["grants_outstanding"] == 0
    return out


@pytest.mark.parametrize("workload", ["cxx", "jit"])
def test_run_cxx_and_jit_on_cpu_keeps_the_invariants(monkeypatch, workload):
    tasks, dup_rate = 40, 0.3
    out = _run_checked(monkeypatch, workload, tasks, dup_rate)
    b = out["breakdown"]
    # Retried infrastructure failures re-enter the delegate, so the
    # stats may exceed the task count by the retry count.
    assert b["hit_cache"] + b["reused"] + b["actually_run"] >= tasks
    assert b["actually_run"] >= int(tasks * (1 - dup_rate))
    assert b["failed"] == 0
    if workload == "jit":
        assert out["dedup_ratio"] > 0
        assert out["servant_compiles"] == b["actually_run"]


def test_async_steal_engages():
    assert tcs.quick_async_steal_engages() > 0


def test_steal_storm_ab_decouples_threads_from_waits():
    """The loop-native submit path parks its donor waits as
    continuations: the blocking arm adds a thread a request, the async
    arm none."""
    out = tcs.run_steal_storm_ab(16, timeout_s=0.5, device="cpu")
    assert set(out) <= _keys(jcs.run_steal_storm_ab)
    assert out["decoupled"] is True
    assert out["threaded"]["extra_threads_at_peak"] >= 8
    assert out["aio"]["outstanding_requests_at_peak"] > 0


def test_main_refuses_without_a_card_unless_asked_for_the_cpu(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tcs.main(["--tasks", "4"])
