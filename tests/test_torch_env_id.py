"""Environment ids whose bitmap word lies outside [0, E): the port's plain
scan and grouped assignment read them as the JAX device functions do.

`jnp.take` in fill mode wraps a word index in [-E, 0) to word + E and
reads 0xFFFFFFFF for one outside [-E, E), so every eligible slot "has"
such an environment.  No valid request reaches this (ids stay below
32 * E); the port's CUDA kernels follow the same rule, which
`chip_smoke.py` holds on the card."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yadcc_tpu.ops import assignment as jasn
from yadcc_tpu.ops import assignment_grouped as jasg
from yadcc_tpu_torch.ops import assignment as tasn
from yadcc_tpu_torch.ops import assignment_grouped as tasg
from yadcc_tpu_torch.ops import cuda_assign as ka
from yadcc_tpu_torch.ops import cuda_grouped as kg

S, E = 96, 2            # E bitmap words: ids 0..63 are inside
ODD_IDS = (32 * E, 32 * E + 5, 10**6, -1, -32 * E - 1, -32 * E, -33)


def pool_np(seed):
    rng = np.random.default_rng(seed)
    return dict(
        alive=rng.random(S) < 0.9,
        capacity=rng.integers(1, 8, S).astype(np.int32),
        running=rng.integers(0, 4, S).astype(np.int32),
        dedicated=rng.random(S) < 0.3,
        version=np.ones(S, np.int32),
        env_bitmap=rng.integers(0, 2**32, (S, E),
                                dtype=np.uint64).astype(np.uint32),
    )


def pools(p):
    return (jasn.PoolArrays(**{k: jnp.asarray(v) for k, v in p.items()}),
            tasn.pool_from_numpy(*(p[k] for k in tasn.PoolArrays._fields),
                                 "cpu"))


@pytest.mark.parametrize("env", ODD_IDS)
def test_has_env_bits_match_jax_take(env):
    p = pool_np(0)
    jp, tp = pools(p)
    word = jnp.take(jp.env_bitmap, jnp.int32(env) >> 5, axis=1)
    want = np.asarray((word >> (jnp.int32(env) & 31)) & 1)
    got = tasn.has_env_bits(tp.env_bitmap, env)
    assert np.array_equal(got.numpy(), want.astype(np.int32))
    assert np.array_equal(
        tasn.has_env_bits(tp.env_bitmap, torch.tensor(env)).numpy(), got)


def test_scan_matches_jax_on_ids_beyond_the_bitmap():
    p = pool_np(1)
    jp, tp = pools(p)
    ids = [e for e in ODD_IDS for _ in range(3)] + [3, 40]
    cols = (ids, [1] * len(ids), [-1] * len(ids))
    want_p, want_r = jasn.assign_batch(jp, jasn.make_batch(*cols,
                                                           pad_to=32))
    for fn in (tasn.assign_batch, ka.cuda_assign_batch):
        got_p, got_r = fn(tp, tasn.make_batch(*cols, pad_to=32))
        assert np.array_equal(got_p.numpy(), np.asarray(want_p))
        assert np.array_equal(got_r.numpy(), np.asarray(want_r))
    # An id past the bitmap reaches servants: all ones, not none.
    assert (np.asarray(want_p)[:3] >= 0).all()


def test_grouped_matches_jax_on_ids_beyond_the_bitmap():
    p = pool_np(2)
    jp, tp = pools(p)
    groups = [(e, 1, -1, 7) for e in ODD_IDS] + [(9, 1, 4, 5)]
    pad = tasg.group_pad(len(groups))
    want_c, want_r = jasg.assign_grouped(
        jp, jasg.make_grouped_batch(groups, pad_to=pad))
    for fn in (tasg.assign_grouped, kg.cuda_assign_grouped):
        got_c, got_r = fn(tp, tasg.make_grouped_batch(groups, pad))
        assert np.array_equal(got_c.numpy(), np.asarray(want_c))
        assert np.array_equal(got_r.numpy(), np.asarray(want_r))
    assert np.asarray(want_c)[0].sum() == 7
