"""The port's filter-sharded Bloom path (yadcc_tpu_torch/parallel/mesh.py:
sharded_bloom_membership, sharded_bloom_cascade, sharded_bloom_probe, and
DeviceBloomCascade over a team) against the JAX package's mesh functions
and the host filters, on the CPU: the JAX side on N of conftest's 8 CPU
devices, the port's plain versions on a team of N CPU slices, the same
seeded filters and keys, exact."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yadcc_tpu.common import bloom as jbloom
from yadcc_tpu.ops import bloom_pipeline as jbp
from yadcc_tpu.parallel import mesh as jmesh
from yadcc_tpu_torch.ops import bloom_pipeline as tbp
from yadcc_tpu_torch.parallel import mesh as tmesh

TEAMS = (1, 2, 4, 8)


BLOOM_BITS = 100_003     # not a multiple of 32, nor of the slices' words


@pytest.fixture(scope="module")
def filters():
    region = jbloom.SaltedBloomFilter(num_bits=BLOOM_BITS, num_hashes=7,
                                      salt=5)
    fleet = jbloom.SaltedBloomFilter(num_bits=BLOOM_BITS, num_hashes=4,
                                     salt=9)
    keys = [f"key-{i:06d}-{i * 7919 % 1000:03d}" for i in range(400)]
    region.add_many(keys[:120])
    fleet.add_many(keys[80:240])
    return region, fleet, keys


@pytest.mark.parametrize("n", TEAMS)
def test_filter_sharded_bloom_matches_jax_and_the_host(n, filters):
    """The filter-sharded membership and cascade against
    sharded_bloom_membership_fn and sharded_bloom_cascade_fn (jitted: one
    key length, ~1 s of compile each; op by op they take a minute) and
    the host filters; the key-sharded probe against
    sharded_bloom_probe_fn."""
    region, fleet, keys = filters
    mesh = jmesh.make_mesh(n)
    team = tmesh.make_team(n, "cpu")
    want_m = np.array([region.may_contain(k) for k in keys])
    want_c = want_m | np.array([fleet.may_contain(k) for k in keys])
    [(length, rows, packed)] = jbp.pack_key_buckets(keys)
    rw = jnp.asarray(jmesh.bloom_words_padded(region.words, mesh,
                                              BLOOM_BITS))
    fw = jnp.asarray(jmesh.bloom_words_padded(fleet.words, mesh,
                                              BLOOM_BITS))
    jm = np.asarray(jmesh.sharded_bloom_membership_fn(
        mesh, length=length, num_bits=BLOOM_BITS, num_hashes=7)(
            rw, jnp.asarray(packed), jbp.seed_pair(5)))
    jc = np.asarray(jmesh.sharded_bloom_cascade_fn(
        mesh, length=length, num_bits=BLOOM_BITS, num_hashes_region=7,
        num_hashes_fleet=4)(rw, fw, jnp.asarray(packed),
                            jbp.seed_pair(5), jbp.seed_pair(9)))
    tpacked = tbp.as_device_words(packed, "cpu")
    tr = tmesh.shard_bloom_words(region.words, team, BLOOM_BITS)
    tf = tmesh.shard_bloom_words(fleet.words, team, BLOOM_BITS)
    tm = tmesh.sharded_bloom_membership(
        tr, tpacked, length, tbp.seed_pair(5), num_bits=BLOOM_BITS,
        num_hashes=7, team=team).numpy()
    tc = tmesh.sharded_bloom_cascade(
        tr, tf, tpacked, length, tbp.seed_pair(5), tbp.seed_pair(9),
        num_bits=BLOOM_BITS, num_hashes_region=7, num_hashes_fleet=4,
        team=team).numpy()
    assert np.array_equal(tm, jm) and np.array_equal(tm, want_m[rows])
    assert np.array_equal(tc, jc) and np.array_equal(tc, want_c[rows])
    assert 0 < tm.sum() < tc.sum() < len(keys)

    fps = jbloom.key_fingerprints(keys[:256], salt=5)
    jp = np.asarray(jmesh.sharded_bloom_probe_fn(
        mesh, num_bits=BLOOM_BITS, num_hashes=7)(
            jnp.asarray(region.words), jnp.asarray(fps)))
    tp = tmesh.sharded_bloom_probe(
        tbp.as_device_words(region.words, "cpu"),
        torch.from_numpy(fps.view(np.int32)), num_bits=BLOOM_BITS,
        num_hashes=7, team=team).numpy()
    assert np.array_equal(tp, jp) and tp[:120].all()


def test_device_bloom_cascade_over_a_team(filters):
    """DeviceBloomCascade(team=...) (the JAX class's mesh) answers as the
    one-card path and the host filters do."""
    from yadcc_tpu_torch.cache.bloom_filter_generator import \
        DeviceBloomCascade
    from yadcc_tpu_torch.common import bloom as tbloom

    region, fleet, keys = filters
    r = tbloom.SaltedBloomFilter.from_bytes(
        region.to_bytes(), region.num_hashes, region.salt,
        num_bits=BLOOM_BITS)
    f = tbloom.SaltedBloomFilter.from_bytes(
        fleet.to_bytes(), fleet.num_hashes, fleet.salt,
        num_bits=BLOOM_BITS)
    mixed = keys + ["short", "a-much-longer-key-" * 5]
    want = np.array([r.may_contain(k) or f.may_contain(k) for k in mixed])
    team = DeviceBloomCascade(team=tmesh.make_team(4, "cpu"))
    one = DeviceBloomCascade(device="cpu")
    assert np.array_equal(team.may_contain_batch(r, f, mixed), want)
    assert np.array_equal(one.may_contain_batch(r, f, mixed), want)
