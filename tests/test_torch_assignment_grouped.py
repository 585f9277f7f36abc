"""The port's grouped assignment against the JAX package's, on the CPU.

The same numpy pools (made from a seed) go through the Pallas kernel in
interpret mode, the XLA grouped kernel, and the port's plain version
(directly and through the kernel wrappers, which route CPU tensors to
it).  All arithmetic is integer: every comparison is exact."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yadcc_tpu.ops import assignment as jasn
from yadcc_tpu.ops import assignment_grouped as jasg
from yadcc_tpu.ops.pallas_grouped import (pallas_assign_grouped,
                                          pallas_assign_grouped_picks_stream)
from yadcc_tpu_torch.ops import assignment as tasn
from yadcc_tpu_torch.ops import assignment_grouped as tasg
from yadcc_tpu_torch.ops import cuda_grouped as kg


def random_pool_np(rng, s, e_words=8, cap_hi=32, run_hi=16):
    """The pools of tests/test_pallas_grouped.py, as numpy arrays."""
    return dict(
        alive=rng.random(s) < 0.9,
        capacity=rng.integers(1, cap_hi, s).astype(np.int32),
        running=rng.integers(0, run_hi, s).astype(np.int32),
        dedicated=rng.random(s) < 0.3,
        version=np.ones(s, np.int32),
        env_bitmap=rng.integers(0, 2**32, (s, e_words),
                                dtype=np.uint64).astype(np.uint32),
    )


def jax_pool(p):
    return jasn.PoolArrays(**{k: jnp.asarray(v) for k, v in p.items()})


def torch_pool(p):
    return tasn.pool_from_numpy(p["alive"], p["capacity"], p["running"],
                                p["dedicated"], p["version"],
                                p["env_bitmap"], "cpu")


def edge_pools():
    """Pools at the corners of the closed form, each with its groups."""
    s = 128
    rng = np.random.default_rng(99)
    full = np.full((s, 8), 0xFFFFFFFF, np.uint32)

    def base(**kw):
        p = dict(alive=np.ones(s, bool),
                 capacity=np.full(s, 8, np.int32),
                 running=np.zeros(s, np.int32),
                 dedicated=np.zeros(s, bool),
                 version=np.ones(s, np.int32),
                 env_bitmap=full.copy())
        p.update(kw)
        return p

    cases = {}
    cases["all_ineligible"] = (base(alive=np.zeros(s, bool)),
                               [(5, 1, -1, 40), (9, 1, -1, 3)])
    cases["m_above_free"] = (
        base(capacity=rng.integers(0, 3, s).astype(np.int32),
             running=rng.integers(0, 2, s).astype(np.int32)),
        [(1, 1, -1, 10_000), (2, 1, -1, 7)])
    cases["requestor_excluded"] = (
        base(capacity=np.full(s, 2, np.int32)),
        [(0, 1, 0, 5), (0, 1, 3, 300), (0, 1, s - 1, 2)])
    # Dedicated slots straddling the 50% preference threshold.
    cap = rng.integers(2, 16, s).astype(np.int32)
    cases["dedicated_around_half"] = (
        base(capacity=cap,
             running=(cap // 2 + rng.integers(-1, 2, s)).clip(0).astype(
                 np.int32),
             dedicated=rng.random(s) < 0.5),
        [(7, 1, -1, 90), (7, 1, 4, 50), (8, 1, -1, 200)])
    # running 0 with tiny caps: the tau < 0 region, where truncating
    # division would count phantom grants.
    cases["tiny_caps_idle"] = (
        base(capacity=rng.integers(1, 3, s).astype(np.int32),
             dedicated=rng.random(s) < 0.5),
        [(0, 1, -1, 1), (1, 1, -1, 0), (2, 1, -1, 37)])
    cases["capacity_zero"] = (
        base(capacity=np.where(rng.random(s) < 0.5, 0, 4).astype(np.int32),
             running=np.where(rng.random(s) < 0.2, 1, 0).astype(np.int32)),
        [(3, 1, -1, 120)])
    # One env id in every bitmap word, each held by a sparse slot set.
    bits = np.zeros((s, 8), np.uint32)
    groups = []
    for w in range(8):
        env = w * 32 + int(rng.integers(0, 32))
        holders = rng.choice(s, 12, replace=False)
        bits[holders, w] |= np.uint32(1 << (env & 31))
        groups.append((env, 1, -1, int(rng.integers(1, 30))))
    cases["env_every_word"] = (
        base(env_bitmap=bits, capacity=np.full(s, 3, np.int32)), groups)
    cases["version_gate"] = (
        base(version=rng.integers(0, 4, s).astype(np.int32)),
        [(4, 2, -1, 60), (4, 3, -1, 60), (4, 9, -1, 5)])
    return cases


def _assert_port_matches(p, groups, pad, check_pallas=True):
    jp = jax_pool(p)
    jb = jasg.make_grouped_batch(groups, pad_to=pad)
    want_c, want_r = jasg.assign_grouped(jp, jb)
    want_c, want_r = np.asarray(want_c), np.asarray(want_r)
    if check_pallas:
        pc, pr = pallas_assign_grouped(jp, jb, interpret=True)
        assert np.array_equal(np.asarray(pc), want_c)
        assert np.array_equal(np.asarray(pr), want_r)
    tp = torch_pool(p)
    tb = tasg.make_grouped_batch(groups, pad_to=pad)
    for fn in (tasg.assign_grouped, kg.cuda_assign_grouped):
        got_c, got_r = fn(tp, tb)
        assert got_c.dtype == torch.int32 and got_r.dtype == torch.int32
        assert np.array_equal(got_c.numpy(), want_c)
        assert np.array_equal(got_r.numpy(), want_r)
    return want_c


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("s", [256, 1024])
def test_random_pools_match_jax(seed, s):
    rng = np.random.default_rng(seed)
    p = random_pool_np(rng, s)
    groups = [(int(e), 1, int(r), int(m)) for e, r, m in
              zip(rng.integers(0, 256, 6), rng.integers(-1, s, 6),
                  rng.integers(1, 60 if s == 256 else 400, 6))]
    counts = _assert_port_matches(p, groups, pad=8,
                                  check_pallas=(s == 256))
    assert counts.sum() > 0


@pytest.mark.parametrize("case", sorted(edge_pools()))
def test_edge_pools_match_jax(case):
    p, groups = edge_pools()[case]
    _assert_port_matches(p, groups, pad=tasg.group_pad(len(groups)))


def test_tiny_caps_grant_nothing_below_zero():
    """The floor-division trap: with running 0 and a zero-count group,
    no slot may be counted a grant (truncating division would give
    every idle slot one)."""
    p, _ = edge_pools()["tiny_caps_idle"]
    counts, running = tasg.assign_grouped(
        torch_pool(p), tasg.make_grouped_batch([(1, 1, -1, 0)], 4))
    assert int(counts.abs().sum()) == 0
    assert np.array_equal(running.numpy(), p["running"])


def test_count_leq_and_scores_match_jax():
    from yadcc_tpu.models.cost import DEFAULT_COST_MODEL as jcm
    from yadcc_tpu_torch.models.cost import DEFAULT_COST_MODEL as tcm

    rng = np.random.default_rng(5)
    p = random_pool_np(rng, 300, cap_hi=4096, run_hi=40)
    jp, tp = jax_pool(p), torch_pool(p)
    for env, req in ((17, -1), (200, 3), (31, 299)):
        jf = jasg.make_count_leq(jp, jp.running, jnp.int32(env),
                                 jnp.int32(1), jnp.int32(req), jcm)
        tf = tasg.make_count_leq(tp, tp.running, env, 1, req, tcm)
        lo, hi = tasg.search_bounds(tcm)
        assert (lo, hi) == tuple(int(x) for x in jasg.search_bounds(jcm))
        for tau in (lo, lo + 1, -70_000, -1, 0, 1, 5, 32767, 40_000,
                    hi - 1, hi):
            assert np.array_equal(np.asarray(jf(jnp.int32(tau))),
                                  tf(torch.tensor(tau)).numpy())
        js = jasn._scores(jp, jp.running, jnp.int32(env), jnp.int32(1),
                          jnp.int32(req), jcm)
        ts = tasn._scores(tp, tp.running, env, 1, req, tcm)
        assert np.array_equal(np.asarray(js), ts.numpy())


@pytest.mark.parametrize("t_max", [256, 512])
def test_expand_and_packing_match_jax(t_max):
    rng = np.random.default_rng(3)
    p = random_pool_np(rng, 512)
    groups = [(int(e), 1, -1, int(m)) for e, m in
              zip(rng.integers(0, 256, 5), rng.integers(0, 90, 5))]
    assert np.array_equal(jasg.make_grouped_packed_host(groups, 8),
                          tasg.make_grouped_packed_host(groups, 8))
    jpk = jasg.make_grouped_packed(groups, 8)
    tpk = tasg.make_grouped_packed(groups, 8)
    assert np.array_equal(np.asarray(jpk), tpk.numpy())
    for a, b in zip(jasg.unpack_grouped(jpk), tasg.unpack_grouped(tpk)):
        assert np.array_equal(np.asarray(a), b.numpy())

    jp, tp = jax_pool(p), torch_pool(p)
    jc, _ = jasg.assign_grouped(jp, jasg.unpack_grouped(jpk))
    tc, _ = tasg.assign_grouped(tp, tasg.unpack_grouped(tpk))
    want = np.asarray(jasg.expand_counts(jc, jpk[3], t_max))
    got = tasg.expand_counts(tc, tpk[3], t_max)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)

    for jfn, tfn in ((jasg.assign_grouped_picks_packed,
                      tasg.assign_grouped_picks_packed),
                     (jasg.assign_grouped_picks_packed,
                      kg.cuda_assign_grouped_picks_packed)):
        jpk_, jr = jfn(jp, jpk, t_max)
        tpk_, tr = tfn(tp, tpk, t_max)
        assert np.array_equal(np.asarray(jpk_), tpk_.numpy())
        assert np.array_equal(np.asarray(jr), tr.numpy())
    jpick, jr = jasg.assign_grouped_picks(jp, jasg.unpack_grouped(jpk),
                                          t_max)
    for fn in (tasg.assign_grouped_picks, kg.cuda_assign_grouped_picks):
        tpick, tr = fn(tp, tasg.unpack_grouped(tpk), t_max)
        assert np.array_equal(np.asarray(jpick), tpick.numpy())
        assert np.array_equal(np.asarray(jr), tr.numpy())


def test_stream_fold_and_step_match_jax():
    rng = np.random.default_rng(8)
    s = 256
    p = random_pool_np(rng, s)
    adj = rng.integers(-20, 5, s).astype(np.int32)
    rmask = rng.random(s) < 0.1
    rval = rng.integers(0, 9, s).astype(np.int32)
    jf = jasg.fold_stream_delta(jnp.asarray(p["running"]), jnp.asarray(adj),
                                jnp.asarray(rmask), jnp.asarray(rval))
    tf = tasg.fold_stream_delta(torch.from_numpy(p["running"]),
                                torch.from_numpy(adj),
                                torch.from_numpy(rmask),
                                torch.from_numpy(rval))
    assert tf.dtype == torch.int32
    assert np.array_equal(np.asarray(jf), tf.numpy())

    groups = [(int(e), 1, -1, int(m)) for e, m in
              zip(rng.integers(0, 256, 3), rng.integers(1, 80, 3))]
    jp, tp = jax_pool(p), torch_pool(p)
    jpk = jasg.make_grouped_packed(groups, 4)
    tpk = tasg.make_grouped_packed(groups, 4)
    args_j = (jnp.asarray(adj), jnp.asarray(rmask), jnp.asarray(rval), 256)
    args_t = (torch.from_numpy(adj), torch.from_numpy(rmask),
              torch.from_numpy(rval), 256)
    want_p, want_r = jasg.assign_grouped_picks_stream(jp, jpk, *args_j)
    pal_p, pal_r = pallas_assign_grouped_picks_stream(jp, jpk, *args_j,
                                                      interpret=True)
    assert np.array_equal(np.asarray(pal_p), np.asarray(want_p))
    for fn in (tasg.assign_grouped_picks_stream,
               kg.cuda_assign_grouped_picks_stream):
        got_p, got_r = fn(tp, tpk, *args_t)
        assert np.array_equal(got_p.numpy(), np.asarray(want_p))
        assert np.array_equal(got_r.numpy(), np.asarray(want_r))


def test_grouped_matches_sequential_oracle():
    """Per-group grant multisets and the final running equal the greedy
    oracle's (the port's own copy of it)."""
    rng = np.random.default_rng(21)
    p = random_pool_np(rng, 200)
    p["running"] = np.minimum(p["running"], p["capacity"])
    groups = [(int(e), 1, int(r), int(m)) for e, r, m in
              zip(rng.integers(0, 256, 4), rng.integers(-1, 200, 4),
                  rng.integers(1, 70, 4))]
    counts, running = tasg.assign_grouped(
        torch_pool(p), tasg.make_grouped_batch(groups, 4))
    oracle = dict(p, running=p["running"].copy())
    for g, (e, v, r, m) in enumerate(groups):
        picks = tasn.greedy_assign_reference(oracle, [(e, v, r)] * m)
        want = np.bincount([x for x in picks if x >= 0], minlength=200)
        assert np.array_equal(counts[g].numpy(), want)
    assert np.array_equal(running.numpy(), oracle["running"])
    fast = dict(p, running=p["running"].copy())
    tasks = [(e, v, r) for e, v, r, m in groups for _ in range(m)]
    slow = dict(p, running=p["running"].copy())
    assert tasn.greedy_assign(fast, tasks) == \
        tasn.greedy_assign_reference(slow, tasks)
