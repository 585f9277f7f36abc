"""The port's device-resident pool against the JAX package's, on the CPU.

The same numpy pools, churn and descriptor sequences (made from a seed)
go through the JAX resident step (XLA, and the Pallas K1 step in
interpret mode) and the port's plain step; DeviceResidentPool runs its
delta protocol under churn beside the JAX package's.  All arithmetic is
integer: every comparison is exact."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yadcc_tpu.ops import assignment as jasn
from yadcc_tpu.ops import assignment_grouped as jasg
from yadcc_tpu.ops.pallas_grouped import pallas_resident_grouped_step
from yadcc_tpu.scheduler import policy as jpol
from yadcc_tpu.scheduler.device_pool import \
    DeviceResidentPool as JaxResidentPool
from yadcc_tpu_torch.ops import assignment as tasn
from yadcc_tpu_torch.ops import assignment_grouped as tasg
from yadcc_tpu_torch.ops import cuda_grouped as kg
from yadcc_tpu_torch.scheduler import policy as tpol
from yadcc_tpu_torch.scheduler.device_pool import DeviceResidentPool

from .test_device_resident import (churn_slots, make_host_pool,
                                   random_descr, statics_of)

STATICS = ("alive", "capacity", "dedicated", "version", "env_bitmap")


def torch_pool(host):
    return tasn.pool_from_numpy(*(host[k] for k in tasn.PoolArrays._fields),
                                "cpu")


def jax_pool(host):
    return jasn.PoolArrays(**{k: jnp.asarray(v) for k, v in host.items()})


def assert_pool_equal(tpool, jpool):
    for f in tasn.PoolArrays._fields:
        got = getattr(tpool, f).numpy()
        if f == "env_bitmap":
            got = got.view(np.uint32)
        assert np.array_equal(got, np.asarray(getattr(jpool, f))), f


def test_apply_pool_delta_leaves_padding_untouched():
    """idx == S padding writes nothing — least of all the last slot,
    where -1 would land — and the input pool is not modified."""
    rng = np.random.default_rng(1)
    s = 16
    host = make_host_pool(rng, s, "uniform")
    before = {k: v.copy() for k, v in host.items()}
    pool = torch_pool(host)
    new = {k: v.copy() for k, v in statics_of(host).items()}
    for k in ("capacity", "version"):
        new[k] = new[k] + 5
    new["alive"] = ~new["alive"]
    new["env_bitmap"] = new["env_bitmap"] ^ np.uint32(0xFFFF0000)
    delta = tasg.make_pool_delta([2, 7], new, pad_to=64, pool_size=s)
    assert delta.idx[2:].eq(s).all()
    out = tasg.apply_pool_delta(pool, delta)
    jout = jasg.apply_pool_delta(
        jax_pool(host), jasg.make_pool_delta(np.asarray([2, 7]), new,
                                             pad_to=64, pool_size=s))
    assert_pool_equal(out, jout)
    for f in STATICS:
        got = getattr(out, f).numpy()
        if f == "env_bitmap":
            got = got.view(np.uint32)
        for i in range(s):
            want = new[f][i] if i in (2, 7) else before[f][i]
            assert np.array_equal(got[i], want), (f, i)
    assert_pool_equal(pool, jax_pool(before))
    with pytest.raises(ValueError, match="at most once"):
        tasg.make_pool_delta([3, 3], new, pad_to=64, pool_size=s)
    dup = delta._replace(idx=torch.tensor([5, 5] + [s] * 62,
                                          dtype=torch.int32))
    with pytest.raises(ValueError, match="at most once"):
        tasg.apply_pool_delta(pool, dup)


@pytest.mark.parametrize("dist", ["fixed", "uniform", "bimodal"])
def test_chained_resident_steps_match_jax(dist):
    """The resident step chained over cycles with churn, resets and
    corrections: picks, running and statics equal to the JAX XLA step and
    to the Pallas K1 step in interpret mode, every cycle; the kernel
    wrapper routes the CPU pool to the same plain step."""
    rng = np.random.default_rng({"fixed": 0, "uniform": 1, "bimodal": 2}[dist])
    s = 64
    host = make_host_pool(rng, s, dist)
    tp, jp, kp = torch_pool(host), jax_pool(host), jax_pool(host)
    cm = jpol.DEFAULT_COST_MODEL
    for step in range(4):
        dirty = churn_slots(rng, host, int(rng.integers(0, 6)))
        d_pad = jasg.delta_pad(len(dirty))
        jdelta = jasg.make_pool_delta(np.asarray(dirty, np.int64),
                                      statics_of(host), pad_to=d_pad,
                                      pool_size=s)
        tdelta = tasg.make_pool_delta(dirty, statics_of(host), pad_to=d_pad,
                                      pool_size=s)
        adj = np.zeros(s, np.int32)
        adj[rng.choice(s, 8, replace=False)] = rng.integers(-2, 3, 8)
        rmask = np.zeros(s, bool)
        rval = np.zeros(s, np.int32)
        rmask[rng.choice(s, 2, replace=False)] = True
        rval[rmask] = rng.integers(0, 4, 2)
        descr = random_descr(rng, s, int(rng.integers(1, 4)))
        t_pad = jasg.task_pad(sum(d[3] for d in descr))
        packed = jasg.make_grouped_packed(descr, jasg.group_pad(len(descr)))
        jargs = (packed, jnp.asarray(adj), jnp.asarray(rmask),
                 jnp.asarray(rval), t_pad, cm)
        want, jp = jasg.resident_grouped_step(jp, jdelta, *jargs)
        kern, kp = pallas_resident_grouped_step(kp, jdelta, *jargs,
                                                interpret=True)
        got, tp = kg.cuda_resident_grouped_step(
            tp, tdelta, torch.tensor(np.asarray(packed)),
            torch.from_numpy(adj), torch.from_numpy(rmask),
            torch.from_numpy(rval), t_pad)
        assert np.array_equal(got.numpy(), np.asarray(want)), step
        assert np.array_equal(got.numpy(), np.asarray(kern)), step
        assert_pool_equal(tp, jp)
        assert_pool_equal(tp, kp)
    assert int((got != tasn.NO_PICK).sum()) > 0


def test_counts_twin_matches_jax():
    rng = np.random.default_rng(7)
    s = 64
    host = make_host_pool(rng, s, "uniform")
    descr = random_descr(rng, s, 3)
    packed = jasg.make_grouped_packed(descr, jasg.group_pad(len(descr)))
    dirty = churn_slots(rng, host, 4)
    jdelta = jasg.make_pool_delta(np.asarray(dirty, np.int64),
                                  statics_of(host), 64, s)
    tdelta = tasg.make_pool_delta(dirty, statics_of(host), 64, s)
    z = np.zeros(s, np.int32)
    want, jp = jasg.resident_grouped_step_counts(
        jax_pool(host), jdelta, packed, jnp.asarray(z),
        jnp.zeros(s, bool), jnp.asarray(z))
    tz = torch.from_numpy(z)
    got, tp = tasg.resident_grouped_step_counts(
        torch_pool(host), tdelta, torch.tensor(np.asarray(packed)), tz,
        torch.zeros(s, dtype=torch.bool), tz)
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert_pool_equal(tp, jp)


def _snap(cls, host):
    return cls(alive=host["alive"], capacity=host["capacity"],
               running=host["running"], dedicated=host["dedicated"],
               version=host["version"], env_bitmap=host["env_bitmap"])


def test_resident_pool_under_churn_matches_jax():
    """DeviceResidentPool.step under sustained churn, beside the JAX
    package's pool: the same picks, running and counters every step; the
    oracle stays clean; lost dirty tracking and a dirty set past S/8 are
    counted full re-syncs."""
    rng = np.random.default_rng(31)
    s = 80
    host = make_host_pool(rng, s, "uniform")
    tp = DeviceResidentPool("cpu", oracle_interval=4)
    jp = JaxResidentPool(use_pallas=False, oracle_interval=4)
    tp.seed(_snap(tpol.PoolSnapshot, host))
    jp.seed(_snap(jpol.PoolSnapshot, host))
    for step in range(16):
        if step == 5:
            churn_slots(rng, host, 3)
            dirty = None            # lost dirty tracking
        elif step == 9:
            dirty = churn_slots(rng, host, s // 4)   # past S/8
        else:
            dirty = churn_slots(rng, host, int(rng.integers(0, 5)))
        adj = np.zeros(s, np.int32)
        adj[rng.choice(s, 6, replace=False)] = rng.integers(-2, 3, 6)
        resets = {int(i): int(rng.integers(0, 3))
                  for i in rng.choice(s, 2, replace=False)}
        descr = random_descr(rng, s, int(rng.integers(1, 4)))
        t_pad = tasg.task_pad(sum(d[3] for d in descr))
        got = tp.step(_snap(tpol.PoolSnapshot, host), dirty, descr, adj,
                      resets, t_pad)
        want = jp.step(_snap(jpol.PoolSnapshot, host), dirty, descr, adj,
                       resets, t_pad)
        assert np.array_equal(got.numpy(), np.asarray(want)), step
        assert np.array_equal(tp.running.numpy(), np.asarray(jp.running))
    stats = tp.inspect()
    assert stats == jp.inspect()
    assert stats["full_syncs"] == 2
    assert stats["oracle_checks"] == 4 and stats["oracle_mismatches"] == 0
    assert stats["delta_launches"] == 16 and stats["seeds"] == 1


def test_oracle_detects_counts_and_repairs_a_corrupted_static():
    rng = np.random.default_rng(5)
    s = 32
    host = make_host_pool(rng, s, "fixed")
    rp = DeviceResidentPool("cpu", oracle_interval=10**9)
    snap = _snap(tpol.PoolSnapshot, host)
    rp.seed(snap)
    assert rp.oracle_check(snap)
    rp._pool.env_bitmap[3, 1] ^= 1      # a lost scatter, say
    assert not rp.oracle_check(snap)
    assert rp.inspect()["oracle_mismatches"] == 1
    assert rp.inspect()["full_syncs"] == 1
    assert rp.oracle_check(snap)
    host["capacity"][7] += 2            # churn the device never hears about
    assert not rp.oracle_check(_snap(tpol.PoolSnapshot, host))
    assert rp.inspect()["oracle_mismatches"] == 2
    assert rp.oracle_check(_snap(tpol.PoolSnapshot, host))
