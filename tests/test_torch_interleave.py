"""The interleaving explorer of the port (yadcc_tpu_torch/testing/
interleave.py) against the JAX package's, on each package's own
scheduler objects.

Every scenario explored at preemption bound 2 (150 runs at most) comes
out clean in both packages; every seeded mutant of ``MUTANTS`` is caught
in both; the dropped-lock canary is benign on the serial schedule and
caught once schedules are explored, in both (as
tests/test_replproto.py holds it for the JAX package); and the port's
``main(["--smoke"])`` exits 0.  The verdicts are compared, not the
schedule counts: the two dispatchers take their locks at different
points, so their schedule spaces may differ in size.

Both explorers save ``threading.Lock`` when first imported, so both are
imported here, at the top, and never run inside each other's window.
"""

from __future__ import annotations

import pytest

from yadcc_tpu.testing import interleave as jil
from yadcc_tpu_torch.testing import interleave as til

EXPLORERS = {"jax": jil, "port": til}


def _scenario(il, name):
    return {s.name: s for s in il.SCENARIOS}[name]


def test_both_packages_define_the_same_scenarios_and_mutants():
    assert [s.name for s in til.SCENARIOS] == [s.name for s in jil.SCENARIOS]
    assert til.MUTANTS == jil.MUTANTS
    assert len(til.MUTANTS) == 5


@pytest.mark.parametrize("name", [s.name for s in jil.SCENARIOS])
def test_scenario_clean_at_bound_2_in_both(name):
    runs = {}
    for pkg, il in EXPLORERS.items():
        res = il.explore(_scenario(il, name), preemption_bound=2,
                         max_runs=150)
        assert res.violation is None, (
            f"{pkg} {name}: {res.violation} (schedule {res.schedule})")
        runs[pkg] = res.runs
    print(f"{name}: schedules explored {runs}")


@pytest.mark.parametrize("sname,mutation", list(jil.MUTANTS),
                         ids=[f"{s}:{m}" for s, m in jil.MUTANTS])
def test_mutant_caught_in_both(sname, mutation):
    for pkg, il in EXPLORERS.items():
        res = il.explore(_scenario(il, sname), mutation=mutation,
                         preemption_bound=2, max_runs=150)
        assert res.violation is not None, (
            f"{pkg}: mutant {sname}:{mutation} survived the sweep")


def test_dropped_lock_needs_a_found_interleaving_in_both():
    # On the serial default schedule the lockless append is benign; only
    # an explored preemption inside the read-modify-write window
    # produces the duplicate seq: the canary that tells "the checkers
    # work" from "the explorer works".
    for pkg, il in EXPLORERS.items():
        scenario = _scenario(il, "issue_renew_free")
        serial = il.explore(scenario, mutation="dropped-lock",
                            preemption_bound=0, max_runs=1)
        assert serial.violation is None, pkg
        explored = il.explore(scenario, mutation="dropped-lock",
                              preemption_bound=2, max_runs=150)
        assert explored.violation is not None, pkg
        assert "monoton" in explored.violation or \
            "gap" in explored.violation


def test_port_main_smoke_exits_0(capsys):
    assert til.main(["--smoke"]) == 0
    out = capsys.readouterr().out
    assert "scenario takeover" in out
    assert "SURVIVED" not in out
