"""The CPU model of the sequential-scan kernel's design
(`chip_smoke.k2_model`, which chip_smoke.py also checks the kernel's
counts against and takes K2's bound from), held equal to the port's plain
`assign_batch` and to the JAX package's Pallas K2 in interpret mode.

The model does, in int64 numpy, what the kernel (csrc/assign_batch.cu)
does for each task:

* keeps each slot's key (score*S + slot; none for a dead or full slot)
  and recomputes only the granted slot's;
* gives slot s to owner s % 1024 and keeps each owner's least eligible key:
  all owners scan when the descriptor (env, min_version, requestor)
  changes, the granted slot's owner alone when it repeats after a grant,
  and none (no reduction) when it repeats after no grant;
* grants when the task is valid and the block minimum is below
  infeasible_q*S, to the one owner holding it;

and counts the descriptor changes, owner rescans, reductions and grants.
All arithmetic is integer: every comparison is exact."""

from __future__ import annotations

from dataclasses import replace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import k2_model
from yadcc_tpu.models.cost import DEFAULT_COST_MODEL as JAX_CM
from yadcc_tpu.ops import assignment as jasn
from yadcc_tpu.ops.pallas_assign import pallas_assign_batch
from yadcc_tpu_torch.models.cost import DEFAULT_COST_MODEL
from yadcc_tpu_torch.ops import assignment as tasn

from .test_assignment import random_pool_np

T = 64      # one task count for every case: one Pallas shape per pool size


def runs(rng, s, n, run_hi=12, n_envs=256):
    """n tasks in runs of identical descriptors, as a backlog forms them."""
    out = []
    while len(out) < n:
        d = (int(rng.integers(0, n_envs)), int(rng.integers(1, 4)),
             int(rng.integers(-1, s)))
        out += [d] * int(rng.integers(1, run_hi))
    return out[:n]


def flat_pool(s, **kw):
    p = dict(alive=np.ones(s, bool), capacity=np.full(s, 8, np.int32),
             running=np.zeros(s, np.int32), dedicated=np.zeros(s, bool),
             version=np.ones(s, np.int32),
             env_bitmap=np.full((s, 2), 0xFFFFFFFF, np.uint32))
    p.update(kw)
    return p


def _check(p, tasks, avoid_self=True, pallas=True):
    """(picks, running, work) of the model, after holding them equal to the
    port's plain version and the JAX Pallas kernel (interpret mode)."""
    tasks = [tuple(x) + (True,) if len(x) == 3 else tuple(x) for x in tasks]
    cm = replace(DEFAULT_COST_MODEL, avoid_self=avoid_self)
    jcm = replace(JAX_CM, avoid_self=avoid_self)
    cols = [np.array([x[i] for x in tasks], np.int32) for i in range(3)]
    valid = np.array([x[3] for x in tasks], bool)
    picks, running, work = k2_model(p, tasks, cm)

    tpool = tasn.pool_from_numpy(*(p[k] for k in tasn.PoolArrays._fields),
                                 "cpu")
    tb = tasn.TaskBatch(*(torch.from_numpy(c) for c in cols),
                        torch.from_numpy(valid))
    got_p, got_r = tasn.assign_batch(tpool, tb, cm)
    assert np.array_equal(picks, got_p.numpy())
    assert np.array_equal(running, got_r.numpy())

    jpool = jasn.PoolArrays(**{k: jnp.asarray(v) for k, v in p.items()})
    jb = jasn.TaskBatch(*(jnp.asarray(c) for c in cols), jnp.asarray(valid))
    fn = ((lambda: pallas_assign_batch(jpool, jb, jcm, interpret=True))
          if pallas else (lambda: jasn.assign_batch(jpool, jb, jcm)))
    want_p, want_r = fn()
    assert np.array_equal(picks, np.asarray(want_p))
    assert np.array_equal(running, np.asarray(want_r))

    assert work["reductions"] == (work["descriptor_changes"]
                                  + work["owner_rescans"])
    assert work["owner_rescans"] <= work["grants"]
    assert work["grants"] == int((picks >= 0).sum())
    return picks, running, work


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_seeded_pools(seed):
    rng = np.random.default_rng(seed)
    p = random_pool_np(rng, 64)
    picks, _, work = _check(p, runs(rng, 64, T))
    assert (picks >= 0).sum() > 0 and work["owner_rescans"] > 0


def test_run_fills_slots_to_capacity():
    """A run of 40 over 6 holders of capacity 1-4 fills them mid-run: each
    filled slot leaves the minimum, and the run's tail is denied."""
    s = 64
    bits = np.zeros((s, 2), np.uint32)
    holders = [3, 9, 10, 30, 41, 63]
    bits[holders, 0] = 1 << 7
    cap = np.array([1, 2, 3, 4, 2, 1] + [8] * (s - 6), np.int32)
    cap[holders] = cap[:6].copy()
    p = flat_pool(s, env_bitmap=bits, capacity=cap,
                  dedicated=np.arange(s) % 3 == 0)
    tasks = [(7, 1, -1)] * 40 + [(33, 1, -1)] * (T - 40)
    picks, running, work = _check(p, tasks)
    assert (picks[:13] >= 0).all() and (picks[13:40] == -1).all()
    assert np.array_equal(running[holders], cap[holders])
    assert work["descriptor_changes"] == 2
    # Tasks 1-13 follow a grant; run b grants nothing, so it never rescans.
    assert work["owner_rescans"] == 13
    assert work["reductions"] == 2 + 13


def test_dedicated_slot_crosses_the_preference_threshold():
    """A dedicated slot keeps the run while under half load, then scores
    as a plain one (its bonus gone) and the run moves to slot 0."""
    s = 64
    ded = np.zeros(s, bool)
    ded[20] = True
    run = np.zeros(s, np.int32)
    run[20] = 2
    p = flat_pool(s, dedicated=ded, running=run)
    picks, _, work = _check(p, [(1, 1, -1)] * T)
    assert picks[:2].tolist() == [20, 20]    # running 2, 3 of 8: preferred
    assert picks[2:5].tolist() == [0, 1, 2]  # slot 20 at 4/8 = threshold
    assert work["descriptor_changes"] == 1
    assert work["owner_rescans"] == T - 1


def test_ties_go_to_the_lowest_slot():
    s = 64
    alive = np.arange(s) < 32
    p = flat_pool(s, alive=alive, capacity=np.full(s, 2, np.int32))
    picks, running, _ = _check(p, [(5, 1, -1)] * T)
    assert picks.tolist() == list(range(32)) * 2
    assert (running[:32] == 2).all() and (running[32:] == 0).all()


def test_all_infeasible():
    """Nothing to grant: repeats reuse the minimum without a reduction."""
    rng = np.random.default_rng(4)
    p = random_pool_np(rng, 64)
    p["alive"][:] = False
    picks, _, work = _check(p, runs(rng, 64, T))
    assert (picks == -1).all()
    assert work["owner_rescans"] == 0
    assert work["reductions"] == work["descriptor_changes"] < T


@pytest.mark.parametrize("avoid_self", [True, False])
def test_requestor_inside_a_run(avoid_self):
    """The requestor's slot is the pool's least loaded; avoid_self keeps a
    run of its requests off it, and off, the run starts there."""
    s = 64
    run = np.full(s, 2, np.int32)
    run[6] = 0
    p = flat_pool(s, running=run)
    tasks = [(0, 1, 6)] * 20 + [(0, 1, 9)] * 20 + [(0, 1, 6)] * (T - 40)
    picks, _, _ = _check(p, tasks, avoid_self=avoid_self)
    assert (6 in picks[:20].tolist()) == (not avoid_self)
    if not avoid_self:
        assert picks[:2].tolist() == [6, 6]


def test_padding_rows_between_runs():
    """Invalid rows inside a run, between runs and at the end grant
    nothing; a valid repeat after a padding row takes the same minimum."""
    rng = np.random.default_rng(5)
    p = random_pool_np(rng, 64)
    p["alive"][:] = True
    p["capacity"][:] = 16
    p["running"][:] = 0
    a, b = (3, 1, -1), (40, 2, 5)
    tasks = ([a + (True,)] * 10 + [a + (False,)] * 3 + [a + (True,)] * 10
             + [(0, 0, -1, False)] * 2 + [b + (True,)] * 20
             + [(0, 0, -1, False)] * (T - 45))
    picks, _, work = _check(p, tasks)
    valid = np.array([x[3] for x in tasks])
    assert (picks[~valid] == -1).all() and (picks[valid] >= 0).all()
    # The rows after padding inside run `a` reuse its minimum; the padding
    # tail is one descriptor change and no reduction after it.
    assert work["descriptor_changes"] == 4


def test_env_ids_beyond_the_bitmap():
    """Words in [-E, 0) wrap, words outside [-E, E) read all ones.  The
    Pallas kernel's dynamic slice clamps such a word instead, so the JAX
    side here is its XLA scan, which reads them through `jnp.take`."""
    rng = np.random.default_rng(6)
    p = random_pool_np(rng, 64, e_words=2)
    ids = (64, 69, 10**6, -1, -65, -64, -33, 31)
    tasks = [(e, 1, -1) for e in ids for _ in range(8)]
    picks, _, _ = _check(p, tasks, pallas=False)
    assert (picks[:8] >= 0).all()


@pytest.mark.parametrize("s", [1, 1000, 1025])
def test_pool_sizes(s):
    """One slot, a pool under one slot per owner, and one just over (owner
    0 holds slots 0 and 1024)."""
    rng = np.random.default_rng(s)
    p = random_pool_np(rng, s)
    p["capacity"] = np.maximum(p["capacity"], 1)
    tasks = runs(rng, s, T, run_hi=20)
    if s == 1025:
        # Every slot busy but 0 and 1024, which one owner holds: the run
        # takes 0 then 1024 through that owner's rescans.
        p["alive"][:] = True
        p["dedicated"][:] = False
        p["version"][:] = 1
        p["env_bitmap"][:] = 0xFFFFFFFF
        p["capacity"][:] = 4
        p["running"][:] = 4
        p["running"][[0, 1024]] = [2, 1]
        tasks = [(0, 1, -1)] * T
    picks, _, work = _check(p, tasks)
    if s == 1025:
        assert picks[:4].tolist() == [1024, 0, 1024, 0]
        assert (picks[5:] == -1).all()
        assert work["owner_rescans"] == 5
