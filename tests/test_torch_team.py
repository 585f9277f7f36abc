"""The port's team (yadcc_tpu_torch/parallel/mesh.py) against the JAX
package's mesh, on the CPU.

The JAX side runs its sharded functions on N of conftest's 8 CPU
devices; the port runs the plain versions of its team-mode kernels on a
team of N CPU slices.  Every input is made from a seed with numpy and
handed to both; every comparison is exact (tolerance 0): K2's team mode
against sharded_assign_fn and the single-pool scan under churn, K1's
team mode against sharded_assign_grouped_fn, its stream over chained
launches against sharded_assign_grouped_picks_stream_fn, and the flat
team of 8 against the 2-level mesh.  The filter-sharded Bloom path is in
test_torch_team_bloom.py, the team policies in
test_torch_team_policy.py."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yadcc_tpu.ops import assignment as jasn
from yadcc_tpu.ops import assignment_grouped as jasg
from yadcc_tpu.parallel import mesh as jmesh
from yadcc_tpu_torch.ops import assignment as tasn
from yadcc_tpu_torch.ops import assignment_grouped as tasg
from yadcc_tpu_torch.parallel import mesh as tmesh

TEAMS = (2, 4, 8)


def pool_np(rng, s, e_words=8, cap_hi=32):
    cap = rng.integers(0, cap_hi, s).astype(np.int32)
    return {
        "alive": rng.random(s) < 0.8,
        "capacity": cap,
        "running": np.minimum(rng.integers(0, 32, s), cap).astype(np.int32),
        "dedicated": rng.random(s) < 0.3,
        "version": rng.integers(1, 5, s).astype(np.int32),
        "env_bitmap": rng.integers(0, 2**32, (s, e_words),
                                   dtype=np.uint64).astype(np.uint32),
    }


def jax_pool(p):
    return jasn.PoolArrays(**{k: jnp.asarray(v) for k, v in p.items()})


def port_team_pool(p, n):
    return tmesh.shard_pool(tasn.pool_from_numpy(**p, device="cpu"),
                            tmesh.make_team(n, "cpu"))


def tasks(rng, t, s):
    return [(int(rng.integers(0, 256)), int(rng.integers(1, 4)),
             int(rng.integers(-1, s))) for _ in range(t)]


def churn(rng, p, running):
    """Between steps: ~2% of slots flip liveness (the dead lose their
    load), ~1% change capacity, the rest carry their running over."""
    s = p["alive"].shape[0]
    p["running"] = np.array(running, np.int32)
    flips = rng.random(s) < 0.02
    p["alive"] = p["alive"] ^ flips
    p["running"][flips & ~p["alive"]] = 0
    recap = rng.random(s) < 0.01
    p["capacity"][recap] = rng.integers(4, 64, int(recap.sum()))


@pytest.mark.parametrize("n", TEAMS)
def test_k2_team_matches_jax_and_the_single_pool_under_churn(n):
    """TestShardedAssignAtScaleUnderChurn at S=256: every step's picks and
    running equal sharded_assign_fn's and the port's single-pool scan's."""
    rng = np.random.default_rng(40 + n)
    s, t = 256, 96
    p = pool_np(rng, s, cap_hi=3)   # contended: some tasks find no slot
    mesh = jmesh.make_mesh(n)
    fn = jmesh.sharded_assign_fn(mesh)
    granted = 0
    for step in range(3):
        tk = tasks(rng, t, s)
        jb = jasn.make_batch(*zip(*tk), pad_to=t)
        want_p, want_r = fn(jmesh.shard_pool(jax_pool(p), mesh), jb)
        tb = tasn.make_batch(*zip(*tk), pad_to=t)
        got_p, got_r = tmesh.sharded_assign(port_team_pool(p, n), tb)
        one_p, one_r = tasn.assign_batch(
            tasn.pool_from_numpy(**p, device="cpu"), tb)
        assert np.array_equal(got_p.numpy(), np.asarray(want_p)), step
        assert np.array_equal(got_r[0].numpy(), np.asarray(want_r)), step
        assert np.array_equal(got_p.numpy(), one_p.numpy()), step
        assert np.array_equal(got_r[0].numpy(), one_r.numpy()), step
        granted += int((got_p >= 0).sum())
        churn(rng, p, want_r)
    assert 0 < granted < 3 * t


def groups(rng, s, n=4):
    return [(int(rng.integers(0, 256)), 1, int(rng.integers(-1, s)),
             int(rng.integers(1, 300))) for _ in range(n)]


@pytest.mark.parametrize("n", TEAMS)
def test_k1_team_matches_jax_under_churn(n):
    """TestShardedGroupedAssign at S=256: counts and running equal
    sharded_assign_grouped_fn's, the cross-slice tie split included."""
    rng = np.random.default_rng(70 + n)
    s = 256
    p = pool_np(rng, s)
    mesh = jmesh.make_mesh(n)
    fn = jmesh.sharded_assign_grouped_fn(mesh)
    for step in range(3):
        gs = groups(rng, s)
        want_c, want_r = fn(jmesh.shard_pool(jax_pool(p), mesh),
                            jasg.make_grouped_batch(gs, pad_to=4))
        tpool = port_team_pool(p, n)
        got_c, got_r = tmesh.sharded_assign_grouped(
            tpool, tasg.make_grouped_batch(gs, pad_to=4))
        got_c = tmesh.unshard_counts(got_c, tpool)
        assert np.array_equal(got_c.numpy(), np.asarray(want_c)), step
        assert np.array_equal(got_r[0].numpy(), np.asarray(want_r)), step
        assert int(got_c.sum()) > 0
        churn(rng, p, want_r)


def test_k1_team_caps_an_oversubscribed_group():
    """A group far beyond the pool's capacity grants what the pool has,
    on the JAX mesh and on the team alike."""
    rng = np.random.default_rng(78)
    p = pool_np(rng, 512)
    gs = [(3, 1, -1, 10_000)]
    mesh = jmesh.make_mesh(4)
    want_c, want_r = jmesh.sharded_assign_grouped_fn(mesh)(
        jmesh.shard_pool(jax_pool(p), mesh),
        jasg.make_grouped_batch(gs, pad_to=4))
    tpool = port_team_pool(p, 4)
    got_c, got_r = tmesh.sharded_assign_grouped(
        tpool, tasg.make_grouped_batch(gs, pad_to=4))
    assert np.array_equal(tmesh.unshard_counts(got_c, tpool).numpy(),
                          np.asarray(want_c))
    assert np.array_equal(got_r[0].numpy(), np.asarray(want_r))


@pytest.mark.parametrize("n", TEAMS)
def test_k1_team_stream_matches_jax_over_chained_launches(n):
    """test_pipelined_dispatch.py:332 on the team: chained launches with
    host corrections (adj) and resets; picks and the resident running
    equal sharded_assign_grouped_picks_stream_fn's launch after launch."""
    rng = np.random.default_rng(11 + n)
    s, e_words, t_max = 64, 8, 64
    mesh = jmesh.make_mesh(n)
    team = tmesh.make_team(n, "cpu")
    fn = jmesh.sharded_assign_grouped_picks_stream_fn(mesh, t_max)
    statics = dict(
        alive=rng.random(s) < 0.9,
        capacity=rng.integers(1, 6, s).astype(np.int32),
        dedicated=rng.random(s) < 0.3,
        version=np.ones(s, np.int32),
        env_bitmap=rng.integers(0, 2**32, (s, e_words),
                                dtype=np.uint64).astype(np.uint32))
    run_j = jnp.zeros(s, jnp.int32)
    tpool = tmesh.shard_pool(tasn.pool_from_numpy(
        **statics, running=np.zeros(s, np.int32), device="cpu"), team)
    for step in range(3):
        gs = [(int(e), 1, -1, int(m)) for e, m in
              zip(rng.integers(0, 256, 3), rng.integers(1, 20, 3))]
        packed = tasg.make_grouped_packed_host(gs, 4)
        adj = rng.integers(-1, 2, s).astype(np.int32)
        rmask = rng.random(s) < 0.05
        rval = rng.integers(0, 2, s).astype(np.int32)
        want_p, run_j = fn(
            jasn.PoolArrays(running=run_j, **{
                k: jnp.asarray(v) for k, v in statics.items()}),
            jnp.asarray(packed), jnp.asarray(adj), jnp.asarray(rmask),
            jnp.asarray(rval))

        def shard(a):
            return tmesh.shard_vector(torch.from_numpy(a), team)

        got_p, running = tmesh.sharded_assign_grouped_picks_stream(
            tpool, torch.from_numpy(packed), shard(adj), shard(rmask),
            shard(rval), t_max)
        tpool = tpool._replace(parts=tuple(
            part._replace(running=r)
            for part, r in zip(tpool.parts, running)))
        assert np.array_equal(got_p.numpy(), np.asarray(want_p)), step
        assert np.array_equal(running[0].numpy(), np.asarray(run_j)), step


def test_flat_team_of_8_matches_the_2_level_mesh():
    """The port's flat team of 8 against make_mesh_2d(2, 4), on the
    scan and on the grouped search (the JAX tests hold 2-level equal to
    1-level)."""
    rng = np.random.default_rng(9)
    s, t = 256, 64
    p = pool_np(rng, s)
    mesh2 = jmesh.make_mesh_2d(2, 4)
    tk = tasks(rng, t, s)
    want_p, want_r = jmesh.sharded_assign_fn_2d(mesh2)(
        jmesh.shard_pool_2d(jax_pool(p), mesh2),
        jasn.make_batch(*zip(*tk), pad_to=t))
    got_p, got_r = tmesh.sharded_assign(
        port_team_pool(p, 8), tasn.make_batch(*zip(*tk), pad_to=t))
    assert np.array_equal(got_p.numpy(), np.asarray(want_p))
    assert np.array_equal(got_r[0].numpy(), np.asarray(want_r))
    gs = groups(rng, s)
    want_c, want_r = jmesh.sharded_assign_grouped_fn(mesh2)(
        jmesh.shard_pool_2d(jax_pool(p), mesh2),
        jasg.make_grouped_batch(gs, pad_to=4))
    tpool = port_team_pool(p, 8)
    got_c, got_r = tmesh.sharded_assign_grouped(
        tpool, tasg.make_grouped_batch(gs, pad_to=4))
    assert np.array_equal(tmesh.unshard_counts(got_c, tpool).numpy(),
                          np.asarray(want_c))
    assert np.array_equal(got_r[0].numpy(), np.asarray(want_r))


def test_team_layout_and_uneven_pools():
    """A team lists its slices in linear order (a card may repeat); a
    pool that does not divide evenly raises in both packages, with the
    JAX messages."""
    from yadcc_tpu.scheduler import policy as jpol
    from yadcc_tpu_torch.scheduler import policy as tpol

    team = (torch.device("cpu"),) * 3
    assert tmesh.team_parts(team) == ((torch.device("cpu"), (0, 1, 2)),)
    assert tmesh.make_team(3, "cpu") == team
    assert tmesh.device_linear_index(team, 2) == 2
    assert tmesh.pool_sharding(team) == tmesh.team_parts(team)
    assert [tmesh.pad_to_multiple(n, 4) for n in (0, 1, 4, 10)] == \
        [jmesh.pad_to_multiple(n, 4) for n in (0, 1, 4, 10)] == [0, 4, 4, 12]
    v = torch.arange(12)
    parts = tmesh.shard_vector(v, team)
    assert torch.equal(tmesh.unshard_vector(parts, team, 4), v)
    assert tmesh.bloom_words_padded(np.ones(10, np.uint32), team,
                                    10 * 32).shape == (12,)
    with pytest.raises(ValueError, match="must divide evenly") as jerr:
        jpol.JaxShardedPolicy(max_servants=66)
    with pytest.raises(ValueError, match="must divide evenly") as terr:
        tpol.TorchShardedPolicy(66, team=tmesh.make_team(8, "cpu"))
    assert str(terr.value) == str(jerr.value)
    rng = np.random.default_rng(3)
    p = pool_np(rng, 66)
    with pytest.raises(ValueError) as jerr:
        jpol.JaxShardedGroupedPolicy()._prepare_grouped_pool(
            jpol.PoolSnapshot(**p), p["running"])
    with pytest.raises(ValueError) as terr:
        tpol.TorchShardedGroupedPolicy(
            team=tmesh.make_team(8, "cpu"))._prepare_grouped_pool(
                tpol.PoolSnapshot(**p), p["running"])
    assert str(terr.value) == str(jerr.value)
    with pytest.raises(ValueError, match="must divide evenly"):
        tmesh.shard_pool(tasn.pool_from_numpy(**p, device="cpu"),
                         tmesh.make_team(4, "cpu"))


def test_exchange_fault_raises_once_voids_the_launches_in_flight_and_clears():
    """TeamExchange.check on a fault a card left in the error word (here a
    host buffer standing in for the mapped one): it raises, clears the
    word and voids every launch issued before it, so a later check of one
    of those launches raises too, while a launch issued after it runs
    clean."""
    import ctypes

    from yadcc_tpu_torch.ops import team_exchange as tx

    ex = tx.TeamExchange()
    buf = (ctypes.c_uint64 * tx.BUFFER_WORDS)()
    ex._ptr = ctypes.addressof(buf)
    first, second = ex.next_epoch(), ex.next_epoch()
    ex.check(("cpu",), first)
    buf[0] = tx.ERR_SPIN
    assert ex.error() == tx.ERR_SPIN
    with pytest.raises(RuntimeError, match="ran out"):
        ex.check(("cpu",), second)
    assert ex.error() == 0
    with pytest.raises(RuntimeError, match="not valid"):
        ex.check(("cpu",), first)
    third = ex.next_epoch()
    ex.check(("cpu",), third)
    ex.check(("cpu",), 0)
