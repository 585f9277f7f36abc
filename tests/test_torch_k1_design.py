"""The CPU model of the grouped-assignment kernel's design
(`chip_smoke.k1_model`, which chip_smoke.py also uses for K1's bound),
held equal to the plain version of both packages.

The model does, in int64 numpy, what the kernel (csrc/grouped_assign.cu)
does for each group:

* skips a group with count <= 0 (a zero row, `running` as it was) when
  every `running` entry was >= 0 at the start of the call, the bonus is
  >= 0 and the bisect domain converges within 22 steps;
* compacts the group's active slots (eligible, with room) in slot order,
  with `pref_total` per slot (0 for a plain one) computed once;
* counts without a branch on the dedicated flag, dividing by UTIL_SCALE
  as `>> 16`;
* stops the bisect once hi == lo, or hi - lo == 1 with lo known to count
  below m, with the plain version's 22 steps as the cap;
* splits ties by one exclusive scan over the compact list;

and reports the active slots and bisect steps of each group."""

from __future__ import annotations

from dataclasses import replace

import numpy as np
import pytest
import torch

from chip_smoke import K1_SEARCH_ITERS, k1_avail, k1_count, k1_model
from yadcc_tpu.models.cost import DEFAULT_COST_MODEL as JAX_CM
from yadcc_tpu.ops import assignment_grouped as jasg
from yadcc_tpu_torch.models.cost import DEFAULT_COST_MODEL, UTIL_SCALE
from yadcc_tpu_torch.ops import assignment_grouped as tasg

from .test_torch_assignment_grouped import (edge_pools, jax_pool,
                                            random_pool_np, torch_pool)

assert UTIL_SCALE == 1 << 16


def _check(p, groups, cm=DEFAULT_COST_MODEL, jax_cm=JAX_CM, with_jax=True):
    pad = tasg.group_pad(len(groups))
    padded = groups + [(0, 0, -1, 0)] * (pad - len(groups))
    got_c, got_r, work = k1_model(p, padded, cm)
    steps = [it for *_, it in work]
    want_c, want_r = tasg.assign_grouped(
        torch_pool(p), tasg.make_grouped_batch(groups, pad), cm)
    assert np.array_equal(got_c, want_c.numpy())
    assert np.array_equal(got_r, want_r.numpy())
    if with_jax:
        jc, jr = jasg.assign_grouped(
            jax_pool(p), jasg.make_grouped_batch(groups, pad_to=pad), jax_cm)
        assert np.array_equal(got_c, np.asarray(jc))
        assert np.array_equal(got_r, np.asarray(jr))
    assert max(steps) <= K1_SEARCH_ITERS
    if cm == DEFAULT_COST_MODEL:
        assert max(steps) <= 20
    return got_c, steps


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_seeded_pools(seed):
    rng = np.random.default_rng(seed)
    s = 256 if seed else 1024
    p = random_pool_np(rng, s)
    groups = [(int(e), 1, int(r), int(m)) for e, r, m in
              zip(rng.integers(0, 256, 6), rng.integers(-1, s, 6),
                  rng.integers(1, 400, 6))]
    counts, steps = _check(p, groups)
    assert counts.sum() > 0 and min(steps[:6]) > 0


@pytest.mark.parametrize("case", sorted(edge_pools()))
def test_edge_pools(case):
    p, groups = edge_pools()[case]
    _check(p, groups)


def test_zero_count_groups_and_all_padding():
    rng = np.random.default_rng(7)
    p = random_pool_np(rng, 512)
    groups = [(int(rng.integers(0, 256)), 1, -1, (0 if g % 2 else 40))
              for g in range(9)]                # zeros inside, pad after
    _, steps = _check(p, groups)
    assert steps[1:9:2] == [0] * 4 and steps[9:] == [0] * 7
    counts, steps = _check(p, [(3, 1, -1, 0)] * 4)
    assert counts.sum() == 0 and steps == [0] * 4


def test_pool_mostly_at_capacity():
    rng = np.random.default_rng(8)
    p = random_pool_np(rng, 512)
    full = rng.random(512) < 0.9
    p["running"] = np.where(full, p["capacity"],
                            p["running"] % p["capacity"]).astype(np.int32)
    counts, _ = _check(p, [(int(rng.integers(0, 256)), 1, -1, 60)
                           for _ in range(5)])
    assert counts.sum() > 0
    assert counts[:, full].sum() == 0


def test_env_ids_beyond_the_bitmap():
    p = random_pool_np(np.random.default_rng(9), 256, e_words=2)
    _check(p, [(e, 1, -1, 9) for e in (64, 69, 10**6, -1, -65, -64, 31)])


def test_negative_running_runs_the_full_search():
    """A negative `running` entry (no valid pool has one) turns the skip
    off: the plain version grants on such a slot even for count 0."""
    p, _ = edge_pools()["requestor_excluded"]
    p = dict(p, running=p["running"].copy())
    p["running"][5] = -100
    counts, steps = _check(p, [(0, 1, -1, 0), (0, 1, -1, 3)])
    assert counts[0].sum() > 0 and steps[0] > 0


def test_wide_domain_hits_the_step_cap():
    """A bonus of 2^22 widens the domain past what 22 steps converge on:
    the skip is off and the cap binds, as in the plain version."""
    p = random_pool_np(np.random.default_rng(10), 256)
    groups = [(5, 1, -1, 0), (6, 1, -1, 30), (7, 1, -1, 2000)]
    cm = replace(DEFAULT_COST_MODEL, preference_bonus_q=1 << 22)
    _, steps = _check(p, groups, cm, replace(JAX_CM,
                                             preference_bonus_q=1 << 22))
    assert max(steps) == K1_SEARCH_ITERS


def test_branch_free_count_matches_count_leq():
    """At every tau the compact count equals the port's count_leq on the
    slots the compaction keeps, and count_leq is 0 on the others."""
    rng = np.random.default_rng(11)
    p = random_pool_np(rng, 300, cap_hi=4096, run_hi=40)
    p["dedicated"] = rng.random(300) < 0.7
    tp = torch_pool(p)
    cm = DEFAULT_COST_MODEL
    run = p["running"].astype(np.int64)
    for env, req in ((17, -1), (200, 3)):
        f = tasg.make_count_leq(tp, tp.running, env, 1, req, cm)
        avail = k1_avail(p, run, env, 1, req, cm)
        idx = np.flatnonzero(avail > 0)
        count = k1_count(
            np.maximum(p["capacity"][idx].astype(np.int64), 1), run[idx],
            avail[idx], p["dedicated"][idx], cm)
        lo, hi = tasg.search_bounds(cm)
        for tau in (lo - 1, lo, -70_000, -1, 0, 5, 32767, 40_000, hi):
            want = f(torch.tensor(tau)).numpy()
            assert np.array_equal(count(tau), want[idx])
            assert not want[avail == 0].any()


def test_work_counts_the_active_slots():
    """The work behind K1's bound: a searched group's active slots are the
    eligible slots with room at its turn (dedicated ones among them), and
    a skipped group has none."""
    rng = np.random.default_rng(12)
    p = random_pool_np(rng, 512)
    p["dedicated"] = rng.random(512) < 0.3
    groups = [(int(rng.integers(0, 256)), 1, int(rng.integers(-1, 512)),
               int(m)) for m in (0, 40, 0, 300, 7)] + [(0, 0, -1, 0)] * 3
    counts, _, work = k1_model(p, groups)
    run = p["running"].astype(np.int64)
    for g, (env, minv, req, m) in enumerate(groups):
        n, nd, it = work[g]
        if m <= 0:
            assert (n, nd, it) == (0, 0, 0)
        else:
            room = k1_avail(p, run, env, minv, req, DEFAULT_COST_MODEL) > 0
            assert n == room.sum() > 0 and it > 0
            assert nd == (room & p["dedicated"]).sum()
        run += counts[g]
