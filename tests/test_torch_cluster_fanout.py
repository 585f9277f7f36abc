"""The port's cluster sweep on the fan-out workloads (aot, autotune) and
the servant park, on the CPU, with the invariants of
tests/test_torch_cluster_sim.py: no failure, nothing lost, dedup
engaged, every unique parent's children run, no grant outstanding once
the rig has stopped; the report's keys are the JAX package's.
"""

from __future__ import annotations

import time

import pytest

from yadcc_tpu.tools import cluster_sim as jcs
from yadcc_tpu_torch.tools import cluster_sim as tcs

from .test_torch_cluster_sim import _keys, _run_checked


@pytest.mark.parametrize("workload", ["aot", "autotune"])
def test_run_fanout_on_cpu_keeps_the_invariants(monkeypatch, workload):
    parents, dup_rate = 8, 0.5
    # A duplicate parent's children dedup only if they reach their cache
    # check after the rig's Bloom sync (every 0.25 s) has caught the
    # original's fills, or find its children in flight.  On a loaded
    # host a round can have neither, so rounds (a fresh rig each, every
    # invariant held in each) run until one dedups, for at most 60 s.
    deadline = time.monotonic() + 60
    while True:
        # Two parents of at most 5 children each in flight on 8 slots.
        out = _run_checked(monkeypatch, workload, parents, dup_rate,
                           concurrency=4, in_flight=2)
        b = out["breakdown"]
        assert out["lost_or_hung"] == 0
        assert b["failed"] == 0
        if out["dedup_ratio"] > 0 or time.monotonic() > deadline:
            break
    assert out["dedup_ratio"] > 0
    assert out["fanout_width"]["min"] >= 2
    # Each unique parent's children ran on a servant at least once.
    assert b["actually_run"] >= int(parents * (1 - dup_rate)) * 2


def test_servant_park_costs_no_thread_a_waiter():
    """Waiters long-poll one slow compile on an aio servant: each is a
    parked continuation, no OS thread, and every one is answered DONE."""
    out = tcs.run_servant_park(waiters=200, hold_s=1.0)
    assert set(out) <= _keys(jcs.run_servant_park)
    assert out["parked_waiters_peak"] == 200
    assert out["replies_done"] == 200 and out["replies_other"] == 0
    assert out["threads_per_waiter"] <= 0.01
