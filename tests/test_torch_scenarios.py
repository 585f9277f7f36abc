"""The hostile-world matrix on the port (yadcc_tpu_torch/tools/scenarios.py)
against the JAX package's yadcc_tpu/tools/scenarios.py.

The fault injectors, the percentile and the SLO check are deterministic,
so they are held equal on seeded inputs.  A scenario's measurements vary
from run to run in one package too (threads, sleeps, the wall clock), so
the scenarios are held by their verdicts: the six cheap ones run in both
packages with equal SLO bounds and checks; the others run in the port
(here and in tests/test_torch_scenarios_*.py, one heavy scenario a file)
with the SLO bounds the JAX source states, read from its ``slo = {...}``
literals.  Every run is the smoke size on the CPU (``device="cpu"``)."""

from __future__ import annotations

import ast
import inspect
import random
import time

import pytest

from yadcc_tpu.tools import scenarios as jsc
from yadcc_tpu_torch.tools import scenarios as tsc

CHEAP = ("flaky-servant", "cache-restart", "cell-kill", "noisy-neighbor",
         "cache-poisoning", "tier-inversion")
PORT_ONLY = ("wan-jitter", "slow-loris", "cold-region", "spill-affinity")
# Names the JAX slo literals read, at the smoke size.
SLO_NAMES = {"n_parents": 2, "keep_alive_ms": 3000}


def jax_slo_bounds(name: str) -> dict:
    """The ``slo = {...}`` literal of the JAX scenario ``name``, evaluated
    at the smoke size."""
    tree = ast.parse(inspect.getsource(jsc))
    func = "_scn_" + name.replace("-", "_")
    for node in ast.walk(tree):
        # cold-region and spill-affinity run in a helper, _scn_<name>_in.
        if isinstance(node, ast.FunctionDef) and node.name in (
                func, func + "_in"):
            for sub in ast.walk(node):
                if (isinstance(sub, ast.Assign)
                        and isinstance(sub.targets[0], ast.Name)
                        and sub.targets[0].id == "slo"):
                    expr = ast.Expression(sub.value)
                    return eval(compile(expr, func, "eval"),
                                {"float": float}, dict(SLO_NAMES))
    raise AssertionError(f"no slo literal in {func}")


def run_port(name: str, policy: str = "greedy_cpu") -> dict:
    out = tsc.run_scenario(name, smoke=True, policy=policy, device="cpu")
    assert out["slo_ok"], (name, {k: out.get(k.rsplit("_", 1)[0])
                                  for k, ok in out["slo_checks"].items()
                                  if not ok})
    return out


def assert_port_scenario(name: str, policy: str = "greedy_cpu") -> dict:
    """The port's smoke run passes every check, with the JAX source's
    bounds and keys."""
    out = run_port(name, policy)
    want = jax_slo_bounds(name)
    assert out["slo"] == want
    assert set(out["slo_checks"]) == set(want)
    return out


def test_scenario_names_are_the_jax_packages():
    assert tsc.SCENARIO_NAMES == jsc.SCENARIO_NAMES
    assert len(tsc.SCENARIO_NAMES) == 14


@pytest.fixture
def sleeps(monkeypatch):
    got: list = []
    monkeypatch.setattr(time, "sleep", got.append)
    return got


def test_wan_jitter_delays_equal(sleeps):
    for mod in (jsc, tsc):
        inj = mod.WanJitter(base_ms=5.0, jitter_mean_ms=10.0, clip_ms=80.0,
                            seed=7)
        for i in range(500):
            inj(f"127.0.0.1:{i % 3}", "ytpu.SchedulerService", "Heartbeat")
    j, t = sleeps[:500], sleeps[500:]
    assert j == t and len(set(j)) > 100 and max(j) <= 0.08


def _flaky_trace(mod, calls):
    inj = mod.FlakyTarget("127.0.0.1:7", fail_prob=0.25, seed=11)
    out = []
    for target, service in calls:
        try:
            inj(target, service, "QueueCxxCompilationTask")
            out.append(0)
        except Exception as e:  # the package's RpcError
            out.append((type(e).__name__, e.status))
    return out, inj.injected


def test_flaky_target_failures_equal():
    rng = random.Random(3)
    calls = [(rng.choice(["127.0.0.1:7", "127.0.0.1:8"]),
              rng.choice(["ytpu.DaemonService", "ytpu.CacheService"]))
             for _ in range(400)]
    j, t = _flaky_trace(jsc, calls), _flaky_trace(tsc, calls)
    assert j == t and j[1] > 10
    # The failure is the transport's: the client's retry ladder reads it.
    assert {x for x in j[0] if x} == {("RpcError",
                                       jsc.STATUS_TRANSPORT_FAILURE)}
    assert tsc.STATUS_TRANSPORT_FAILURE == jsc.STATUS_TRANSPORT_FAILURE


def test_slow_loris_and_compose_equal(sleeps):
    calls = [("127.0.0.1:9", "ytpu.DaemonService"),
             ("127.0.0.1:9", "ytpu.SchedulerService"),
             ("127.0.0.1:8", "ytpu.DaemonService")] * 20
    traces = []
    for mod in (jsc, tsc):
        del sleeps[:]
        fn = mod.compose(mod.WanJitter(seed=5),
                         mod.SlowLoris("127.0.0.1:9", delay_s=1.2),
                         mod.FlakyTarget("127.0.0.1:8", fail_prob=0.5,
                                         seed=2))
        out = []
        for target, service in calls:
            try:
                fn(target, service, "m")
                out.append("ok")
            except Exception as e:
                out.append(type(e).__name__)
        traces.append((out, list(sleeps)))
    assert traces[0] == traces[1]
    assert traces[0][1].count(1.2) == 20


def test_installed_faults_hooks_the_ports_transport():
    from yadcc_tpu_torch.rpc import transport

    seen = []
    with tsc.installed_faults(lambda *a: seen.append(a)):
        transport.apply_faults("t", "s", "m")
    transport.apply_faults("t", "s", "m")
    assert seen == [("t", "s", "m")]


PCTL_CASES = [[], [1.0], [3.0, 1.0, 2.0], list(range(100)),
              [0.123456, 9.87654, 5.5, 5.5, 1e6]]


@pytest.mark.parametrize("values", PCTL_CASES)
@pytest.mark.parametrize("q", [50, 99, 0, 100])
def test_pctl_equal(values, q):
    assert tsc._pctl(list(values), q) == jsc._pctl(list(values), q)


SLO_FIXTURES = [
    ({"a": 1.0, "b": 0}, {"a_min": 0.99, "b_max": 0}),
    ({"a": 0.98}, {"a_min": 0.99}),
    ({"a": None}, {"a_min": 0.0, "a_max": 1.0}),
    ({}, {"missing_min": 1, "missing_max": 1}),
    ({"x": 5}, {"x_exact": 5}),
    ({"ratio": 1.3, "p99": 250.0}, {"ratio_min": 1.3, "p99_max": 250.0}),
    ({"count": 11}, {"count_max": 10, "count_min": 11}),
]


@pytest.mark.parametrize("measured,slo", SLO_FIXTURES)
def test_check_slo_equal(measured, slo):
    assert tsc._check_slo(measured, slo) == jsc._check_slo(measured, slo)


def test_rung_monitor_equal():
    """The rung timeline reads the same samples the same way."""
    class Adm:
        def __init__(self):
            self.r = 0

        def rung(self):
            return self.r

    class D:
        admission = Adm()

    mons = []
    for mod in (jsc, tsc):
        m = mod._RungMonitor(D())
        m.samples = [(0.1, 1), (0.2, 3), (0.5, 0)]
        mons.append(m)
    for t in (0.0, 0.1, 0.15, 0.3, 0.6):
        assert mons[0].rung_at(t) == mons[1].rung_at(t)
    assert mons[0].max_rung() == mons[1].max_rung() == 3


@pytest.mark.parametrize("name", CHEAP)
def test_cheap_scenario_verdicts_equal_in_both_packages(name):
    # The verdicts are compared on a pair in which both packages ran
    # within their bounds.  The bounds are wall-clock ones (cell-kill:
    # failover within one 3 s keep-alive, an 8 s deadline a task, a
    # straddled lease renewed within 3 s), and the scenario code is the
    # same in both packages, so on a loaded host either side of a pair
    # can miss one.  Pairs run until both pass, for at most 90 s; every
    # assertion below holds on the last pair.
    deadline = time.monotonic() + 90
    while True:
        port = tsc.run_scenario(name, smoke=True, policy="greedy_cpu",
                                device="cpu")
        ref = jsc.run_scenario(name, smoke=True)
        if (port["slo_ok"] and ref["slo_ok"]) or \
                time.monotonic() > deadline:
            break
    assert port["slo_ok"], (name, {k: port.get(k.rsplit("_", 1)[0])
                                   for k, ok in port["slo_checks"].items()
                                   if not ok})
    assert ref["slo_ok"], (name, ref["slo_checks"])
    assert port["slo"] == ref["slo"]
    assert port["slo_checks"] == ref["slo_checks"]
    assert set(port) == set(ref)


@pytest.mark.parametrize("name", PORT_ONLY)
def test_scenario_passes_in_the_port(name):
    out = assert_port_scenario(name)
    if name == "spill-affinity":
        assert out["placement_score_p99_us"] > 0


def test_cell_kill_on_torch_grouped():
    """The path the card takes: every cell's dispatcher, and the
    promoted standby's, on torch_grouped (K1's plain version here)."""
    out = assert_port_scenario("cell-kill", policy="torch_grouped")
    assert out["promoted"] == 1 and out["double_runs"] == 0


class _SlowPaceSleeps:
    """The scenarios module's ``time`` with each pace sleep of the first
    arm overshooting by ``extra`` seconds: a host busy while that arm ran
    and idle for the other."""

    def __init__(self, pace: float, calls: int, extra: float):
        self._pace, self._left, self._extra = pace, calls, extra

    def __getattr__(self, name):
        return getattr(time, name)

    def sleep(self, seconds):
        if seconds == self._pace and self._left > 0:
            self._left -= 1
            seconds += self._extra
        time.sleep(seconds)


def test_cold_region_speedup_holds_when_one_arm_sleeps_long(monkeypatch):
    """The cold-region SLO is the ratio of two arms' times-to-warm, run
    one after the other.  A busy host while the prefetched arm runs (each
    of its 400 pace sleeps 4 ms late) must not move it: each arm's clock
    is the open-loop arrival stream's (request i at i * pace, its reply a
    round trip later), which a sleep's overshoot does not delay.  The
    bound is still the JAX source's warm_speedup_min."""
    monkeypatch.setattr(tsc, "time", _SlowPaceSleeps(0.002, 400, 0.004))
    out = assert_port_scenario("cold-region")
    assert jax_slo_bounds("cold-region")["warm_speedup_min"] == 2.0
    assert out["warm_speedup"] >= 2.0
    # 50 requests to the window: the nominal pace alone is 0.1 s, the
    # overshoot would add 0.2 s more.
    assert out["time_to_warm_on_s"] < 0.1 + 0.2
