"""The port's sequential assignment scan against the JAX package's, on the CPU.

The same numpy pools and task lists (made from a seed) go through the JAX
XLA scan (assign_batch), the Pallas scan kernel K2 in interpret mode,
and the port's plain version (directly and through the kernel wrapper,
which routes CPU tensors to it).  All arithmetic is integer: every
comparison is exact."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yadcc_tpu.ops import assignment as jasn
from yadcc_tpu.ops.pallas_assign import pallas_assign_batch
from yadcc_tpu_torch.models.cost import DEFAULT_COST_MODEL
from yadcc_tpu_torch.ops import assignment as tasn
from yadcc_tpu_torch.ops import cuda_assign as ka

from .test_assignment import random_pool_np, random_tasks


def torch_pool(p):
    return tasn.pool_from_numpy(p["alive"], p["capacity"], p["running"],
                                p["dedicated"], p["version"],
                                p["env_bitmap"], "cpu")


def jax_pool(p):
    return jasn.PoolArrays(**{k: jnp.asarray(v) for k, v in p.items()})


def batches(tasks, pad_to):
    cols = ([x[0] for x in tasks], [x[1] for x in tasks],
            [x[2] for x in tasks])
    return (jasn.make_batch(*cols, pad_to=pad_to),
            tasn.make_batch(*cols, pad_to=pad_to))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_matches_jax_scan_and_pallas_kernel(seed):
    """S=64, T=64, as tests/test_pallas_assign.py runs the TPU kernel."""
    rng = np.random.default_rng(seed)
    s, t = 64, 64
    p = random_pool_np(rng, s)
    tasks = random_tasks(rng, t, s, n_envs=256)
    jb, tb = batches(tasks, t)
    want_p, want_r = jasn.assign_batch(jax_pool(p), jb)
    kern_p, kern_r = pallas_assign_batch(jax_pool(p), jb, interpret=True)
    got_p, got_r = tasn.assign_batch(torch_pool(p), tb)
    assert got_p.dtype == torch.int32 and got_r.dtype == torch.int32
    assert np.array_equal(got_p.numpy(), np.asarray(want_p))
    assert np.array_equal(got_r.numpy(), np.asarray(want_r))
    assert np.array_equal(got_p.numpy(), np.asarray(kern_p))
    assert np.array_equal(got_r.numpy(), np.asarray(kern_r))
    # ...and the greedy oracle of both packages.
    oracle = {k: v.copy() for k, v in p.items()}
    assert got_p.tolist() == tasn.greedy_assign(oracle, tasks)
    assert np.array_equal(got_r.numpy(), oracle["running"])
    assert int((got_p != tasn.NO_PICK).sum()) > 0


@pytest.mark.parametrize("avoid_self", [True, False])
def test_padding_rows_inert_and_avoid_self(avoid_self):
    """Padding rows grant nothing; avoid_self keeps a requestor off its
    own slot (off: the requestor's slot is the lowest-scored one)."""
    from dataclasses import replace

    cm = replace(DEFAULT_COST_MODEL, avoid_self=avoid_self)
    s = 8
    p = dict(alive=np.ones(s, bool), capacity=np.full(s, 4, np.int32),
             running=np.full(s, 1, np.int32), dedicated=np.zeros(s, bool),
             version=np.ones(s, np.int32),
             env_bitmap=np.full((s, 2), 0xFFFFFFFF, np.uint32))
    p["running"][3] = 0
    tasks = [(0, 1, 3), (0, 1, 3)]
    jb, tb = batches(tasks, 8)
    got_p, got_r = ka.cuda_assign_batch(torch_pool(p), tb, cm)
    want_p, want_r = jasn.assign_batch(jax_pool(p), jb, cm)
    assert np.array_equal(got_p.numpy(), np.asarray(want_p))
    assert np.array_equal(got_r.numpy(), np.asarray(want_r))
    assert (got_p[2:] == tasn.NO_PICK).all()
    assert int(got_r.sum()) == int(p["running"].sum()) + 2
    assert (3 in got_p.tolist()) == (not avoid_self)


def test_parity_at_production_shape():
    """S=8192, T=512 on a contended pool (tiny capacities, half the
    requested environments served by nobody): a real mix of grants and
    denials against the JAX scan."""
    rng = np.random.default_rng(11)
    s, t = 8192, 512
    capacity = rng.integers(1, 4, s).astype(np.int32)
    env_density = rng.random((s, 8, 32)) < 0.02
    env_density[:, 4:, :] = False
    env_words = np.zeros((s, 8), np.uint32)
    for b in range(32):
        env_words |= env_density[:, :, b].astype(np.uint32) << b
    p = dict(alive=rng.random(s) < 0.9, capacity=capacity,
             running=np.minimum(rng.integers(0, 4, s),
                                capacity).astype(np.int32),
             dedicated=rng.random(s) < 0.3, version=np.ones(s, np.int32),
             env_bitmap=env_words)
    tasks = [(int(e), 1, -1) for e in rng.integers(0, 256, t)]
    jb, tb = batches(tasks, t)
    want_p, want_r = jasn.assign_batch(jax_pool(p), jb)
    got_p, got_r = tasn.assign_batch(torch_pool(p), tb)
    assert np.array_equal(got_p.numpy(), np.asarray(want_p))
    assert np.array_equal(got_r.numpy(), np.asarray(want_r))
    denied = int((got_p == tasn.NO_PICK).sum())
    assert 0 < denied < t, f"need grants AND denials, got {denied}/{t}"


def test_wrapper_routes_cpu_tensors_to_the_plain_version():
    """A CPU pool takes the plain version and counts no launch; a device
    with no kernel raises."""
    rng = np.random.default_rng(3)
    p = random_pool_np(rng, 48)
    tasks = random_tasks(rng, 20, 48, n_envs=256)
    _, tb = batches(tasks, 24)
    before = ka.launches
    got = ka.cuda_assign_batch(torch_pool(p), tb)
    want = tasn.assign_batch(torch_pool(p), tb)
    assert ka.launches == before
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    with pytest.raises(ValueError, match="work counts come from the kernel"):
        ka.cuda_assign_batch(torch_pool(p), tb,
                             work=torch.zeros(3, dtype=torch.int64))
    meta =tasn.PoolArrays(*(x.to("meta") for x in torch_pool(p)))
    with pytest.raises(ValueError, match="no assignment-scan kernel"):
        ka.cuda_assign_batch(meta, tb)
    with pytest.raises(ValueError, match="do not fit"):
        tasn.make_batch([0] * 3, [0] * 3, [-1] * 3, pad_to=2)
