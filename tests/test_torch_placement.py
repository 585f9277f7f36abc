"""The port's scored spill placement against the JAX package's, on the CPU.

The same seeded cells, filters and candidate keys go through the JAX
DevicePlacementScorer on the 8-device CPU mesh (placement_score_fn under
XLA) and the port's DevicePlacementScorer(device="cpu") (the plain version
of csrc/bloom.cu's placement kernel): scores, picks and best scores are
bit-equal, ties, ineligible and filterless cells and mixed key lengths
included, and both refuse filters of differing geometry.  The host oracle
(reference_scores, prepare_probe_batch, host_reference_placement) is held
equal across the packages, and the kernel's wrapper (ops/cuda_bloom.py:
placement_score) against the host arithmetic at the salts, key counts and
padding the card's checks use, with its refusals.  Every quantity compared
is an integer: the tolerance is 0."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from yadcc_tpu.common import bloom as jbloom
from yadcc_tpu.parallel import mesh as jmesh
from yadcc_tpu.scheduler import placement as jpl
from yadcc_tpu_torch.common import bloom as tbloom
from yadcc_tpu_torch.ops import cuda_bloom
from yadcc_tpu_torch.ops.bloom_pipeline import (as_device_words,
                                                pack_key_buckets, seed_pair)
from yadcc_tpu_torch.scheduler import placement as tpl

KW = dict(warm_scale=tpl.WARM_SCALE, w_warm=tpl.W_WARM, w_load=tpl.W_LOAD,
          w_topo=tpl.W_TOPO)


def filters_with(keys, *, salt, num_bits=1 << 15, num_hashes=7):
    """The same filter in both packages (words held equal)."""
    out = []
    for mod in (jbloom, tbloom):
        f = mod.SaltedBloomFilter(num_bits=num_bits, num_hashes=num_hashes,
                                  salt=salt)
        if keys:
            f.add_many(list(keys))
        out.append(f)
    assert np.array_equal(out[0].words, out[1].words)
    return out


def cells_both(specs):
    """specs: [(utilization, topo, eligible, keys or None, salt)] ->
    (JAX cells, port cells)."""
    jc, tc = [], []
    for i, (util, topo, ok, keys, salt) in enumerate(specs):
        jf = tf = None
        if keys is not None:
            jf, tf = filters_with(keys, salt=salt)
        jc.append(jpl.CellCandidate(i, util, topo, ok, jf))
        tc.append(tpl.CellCandidate(i, util, topo, ok, tf))
    return jc, tc


def assert_same(a, b):
    assert a is not None and b is not None
    assert a.batch.length == b.batch.length
    assert a.batch.dropped == b.batch.dropped
    assert np.array_equal(a.scores, b.scores), (a.scores, b.scores)
    assert np.array_equal(a.best_cell, b.best_cell)
    assert np.array_equal(a.best_score, b.best_score)


@pytest.fixture(scope="module")
def scorers():
    return (jpl.DevicePlacementScorer(jmesh.make_mesh(8)),
            tpl.DevicePlacementScorer(device="cpu"))


def seeded_case(seed):
    rng = np.random.default_rng(seed)
    universe = [f"obj-{i:04d}" for i in range(64)]
    specs = []
    for ci in range(5):
        keys = (None if ci == 4 else
                [universe[i] for i in rng.choice(64, 20, replace=False)])
        specs.append((float(rng.uniform(0.0, 3.0)),
                      int(rng.integers(0, 5)), ci != 2, keys, 100 + ci))
    tasks = [[universe[i] for i in rng.choice(64, 6, replace=False)]
             for _ in range(3)]
    return specs, tasks


def test_seeded_matrix_matches_jax_scorer(scorers):
    jsc, tsc = scorers
    specs, tasks = seeded_case(7)
    jc, tc = cells_both(specs)
    want = jsc.score(jc, tasks)
    got = tsc.score(tc, tasks)
    assert_same(got, want)
    assert_same(got, tpl.host_reference_placement(tc, tasks))
    assert (got.best_cell != 2).all()


def test_ties_and_mixed_lengths_match_jax_scorer(scorers):
    jsc, tsc = scorers
    keys = [f"tiekey-{i}" for i in range(8)]
    jc, tc = cells_both([(0.0, 0, True, keys[:4], 42),
                         (0.0, 0, True, keys[:4], 42)])
    got = tsc.score(tc, [keys])
    assert_same(got, jsc.score(jc, [keys]))
    assert (got.best_cell == 0).all()
    jc, tc = cells_both([(0.0, 0, True, ["warm-a-1", "warm-a-2"], 1),
                         (0.5, 0, True, [], 2)])
    tasks = [["warm-a-1", "warm-a-2", "sh"], ["cold-b-1", "xy"]]
    got = tsc.score(tc, tasks)
    assert_same(got, jsc.score(jc, tasks))
    assert got.batch.dropped == 2 and list(got.best_cell) == [0, 0]


def test_declines_and_geometry_refusal_match_jax(scorers):
    jsc, tsc = scorers
    jc, tc = cells_both([(0.0, 0, True, None, 0), (0.0, 0, True, None, 0)])
    assert tsc.score(tc, [["k1"]]) is None and jsc.score(jc, [["k1"]]) is None
    jc, tc = cells_both([(0.0, 0, True, [], 3)])
    assert tsc.score(tc, [[]]) is None and jsc.score(jc, [[]]) is None
    small = filters_with([], salt=1, num_bits=1 << 14)
    for mod, sc, f in ((jpl, jsc, small[0]), (tpl, tsc, small[1])):
        cells = [mod.CellCandidate(0, filter=filters_with([], salt=1)[
                     0 if mod is jpl else 1]),
                 mod.CellCandidate(1, filter=f)]
        with pytest.raises(ValueError, match="geometry"):
            sc.score(cells, [["kk"]])


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_reference_scores_match_jax(seed):
    rng = np.random.default_rng(seed)
    c, t = int(rng.integers(1, 9)), int(rng.integers(1, 9))
    counts = rng.integers(0, 40, t).astype(np.int32)
    hits = np.minimum(rng.integers(0, 40, (c, t)), counts).astype(np.int32)
    util = np.array([tpl.quantize_utilization(u)
                     for u in rng.uniform(-1, 40, c)], np.int32)
    topo = rng.integers(0, 6, c).astype(np.int32)
    elig = (rng.random(c) < 0.8).astype(np.int32)
    has = (rng.random(c) < 0.8).astype(np.int32)
    if seed == 3:                        # a tie across every cell
        hits[:] = hits[0]
        util[:] = util[0]
        topo[:] = topo[0]
        has[:] = 1
    got = tpl.reference_scores(hits, counts, util, topo, elig, has)
    want = jpl.reference_scores(hits, counts, util, topo, elig, has)
    for g, w in zip(got, want):
        assert np.array_equal(g, w)
    assert [tpl.quantize_utilization(u) for u in (-1, 0.3, 2.5, 99)] == \
        [jpl.quantize_utilization(u) for u in (-1, 0.3, 2.5, 99)]


def test_probe_batch_and_host_reference_match_jax():
    for tasks in ([["k" * 8, "a" * 8, "zz" * 2], ["b" * 8, "c" * 8, "d" * 4],
                   ["e" * 8]], [[], []], [], [["x" * 23] * 3, ["y" * 80]]):
        got, want = tpl.prepare_probe_batch(tasks), \
            jpl.prepare_probe_batch(tasks)
        if want is None:
            assert got is None
            continue
        assert (got.length, got.dropped, got.kept) == \
            (want.length, want.dropped, want.kept)
        for f in ("packed", "task_of_key", "counts"):
            assert np.array_equal(getattr(got, f), getattr(want, f))
    specs, tasks = seeded_case(9)
    jc, tc = cells_both(specs)
    assert_same(tpl.host_reference_placement(tc, tasks),
                jpl.host_reference_placement(jc, tasks))


# --------------------------------------------------------------------------
# The kernel's wrapper (its plain version on the CPU) against the host.
# --------------------------------------------------------------------------


def wrapper_inputs(rng, c_n, t_n, n, length, salts, num_bits=1000,
                   num_hashes=7, no_filter=(), pad=0):
    """Seeded filters (half their keys members), keys of ``length`` bytes
    owned by seeded tasks (task t_n - 1 owns none), ``pad`` padding keys
    with task -1; returns the wrapper's arguments and the host oracle."""
    keys = [bytes(rng.integers(97, 123, length, dtype=np.uint8)).decode()
            for _ in range(n + pad)]
    owner = np.concatenate([rng.integers(0, max(1, t_n - 1), n),
                            np.full(pad, -1)]).astype(np.int32)
    filters = []
    for c in range(c_n):
        if c in no_filter:
            filters.append(None)
            continue
        f = tbloom.SaltedBloomFilter(num_bits=num_bits,
                                     num_hashes=num_hashes,
                                     salt=salts[c % len(salts)])
        f.add_many([k for k in keys if rng.random() < 0.5] or keys[:1])
        filters.append(f)
    (_, idx, packed), = pack_key_buckets(keys)
    assert isinstance(idx, slice)
    counts = np.bincount(owner[owner >= 0], minlength=t_n).astype(np.int32)
    terms = np.stack([rng.integers(0, 4096, c_n), rng.integers(0, 5, c_n),
                      (rng.random(c_n) < 0.8).astype(int),
                      [f is not None for f in filters]]).astype(np.int32)
    hits = np.zeros((c_n, t_n), np.int32)
    for c, f in enumerate(filters):
        if f is not None:
            ok = f.may_contain_batch(keys)
            for i in np.flatnonzero(ok & (owner >= 0)):
                hits[c, owner[i]] += 1
    want = tpl.reference_scores(hits, counts, terms[0], terms[1], terms[2],
                                terms[3])
    args = ([None if f is None else as_device_words(f.words, "cpu")
             for f in filters],
            np.stack([seed_pair(f.salt if f is not None else 0)
                      for f in filters]),
            terms, packed, owner, counts)
    return args, dict(length=length, num_bits=num_bits,
                      num_hashes=num_hashes, **KW), want


@pytest.mark.parametrize("c_n,t_n,n,length,pad", [
    (1, 1, 1, 23, 0), (3, 8, 32, 80, 5), (7, 1, 32, 23, 0),
    (8, 8, 256, 80, 3)])
def test_wrapper_matches_host_arithmetic(c_n, t_n, n, length, pad):
    rng = np.random.default_rng(c_n * 100 + n)
    args, kw, want = wrapper_inputs(
        rng, c_n, t_n, n, length, salts=(0, 17, (1 << 63) + 5),
        no_filter=(1,) if c_n > 2 else (), pad=pad)
    before = dict(cuda_bloom.launches)
    out = torch.empty(c_n * t_n + 2 * t_n, dtype=torch.int32)
    got = cuda_bloom.placement_score(*args, out=out, **kw)
    assert cuda_bloom.launches == before       # the CPU runs the plain one
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), w)
    assert np.array_equal(out.numpy(), np.concatenate(
        [w.reshape(-1) for w in want]))


def test_wrapper_ineligible_and_production_geometry():
    rng = np.random.default_rng(5)
    args, kw, want = wrapper_inputs(rng, 3, 2, 32, 80, salts=(17,),
                                    num_bits=27_584_639, num_hashes=10)
    args[2][2] = 0                               # every cell ineligible
    got = cuda_bloom.placement_score(*args, **kw)
    assert (got[0].numpy() == tpl.BIG).all()
    assert (got[1].numpy() == 0).all() and (got[2].numpy() == tpl.BIG).all()


def test_wrapper_refusals():
    rng = np.random.default_rng(6)
    args, kw, _ = wrapper_inputs(rng, 2, 2, 8, 23, salts=(3,))
    words, seeds, terms, packed, owner, counts = args
    ok = cuda_bloom.placement_score(*args, **kw)
    assert ok[0].shape == (2, 2)
    bad = [
        ((words, seeds, terms, packed, owner,
          np.zeros(cuda_bloom.PLACE_MAX_TASKS + 1, np.int32)), "tasks"),
        ((words, seeds, terms, packed, owner,
          np.array([cuda_bloom.PLACE_MAX_COUNT + 1, 0], np.int32)),
         "wrap"),
        (([words[0], words[1][:-1]], seeds, terms, packed, owner, counts),
         "shape"),
        (([], seeds[:0], terms[:, :0], packed, owner, counts), "one cell"),
        ((words, seeds[:1], terms, packed, owner, counts), "cells"),
        ((words, seeds, terms, packed[:, :2], owner, counts), "packed"),
        (([None, None], seeds, terms, packed, owner, counts), "device"),
    ]
    for call, match in bad:
        with pytest.raises(ValueError, match=match):
            cuda_bloom.placement_score(*call, **kw)
    with pytest.raises(TypeError):
        cuda_bloom.placement_score([words[0].to(torch.int64), words[1]],
                                   *args[1:], **kw)
