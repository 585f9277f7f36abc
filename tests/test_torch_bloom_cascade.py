"""The port's Bloom cascade, replica, generator and bench against the JAX
package and the host chain (device="cpu": the plain versions).

The JAX cascade is the filter-sharded shard_map over the 8-device CPU
mesh and jit-compiles once per key length, so the JAX calls here keep to
one short length class; the port's cascade also runs at the production
key length against the host OR.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from yadcc_tpu.cache import bloom_filter_generator as jgen
from yadcc_tpu.common import bloom as jbloom
from yadcc_tpu.utils.clock import VirtualClock as JVirtualClock
from yadcc_tpu_torch.cache import bloom_filter_generator as tgen
from yadcc_tpu_torch.common import bloom as tbloom
from yadcc_tpu_torch.ops import bloom_pipeline as tpipe
from yadcc_tpu_torch.ops import cuda_bloom
from yadcc_tpu_torch.tools import bloom_bench
from yadcc_tpu_torch.utils.clock import VirtualClock as TVirtualClock

BITS = 999_983


def _pair(cls, num_hashes, salt, keys):
    f = cls(num_bits=BITS, num_hashes=num_hashes, salt=salt)
    f.add_many(keys)
    return f


@pytest.fixture(scope="module")
def filters():
    """(region, fleet) in both packages: region 10 hashes, fleet 7 with a
    salt whose hi word is set; some keys live in both levels."""
    region_keys = [f"r-{i:05d}" for i in range(1500)]
    fleet_keys = [f"f-{i:05d}" for i in range(1200)] + region_keys[:200]
    out = {}
    for name, cls in (("port", tbloom.SaltedBloomFilter),
                      ("jax", jbloom.SaltedBloomFilter)):
        out[name] = (_pair(cls, 10, 0xABCD1234, region_keys),
                     _pair(cls, 7, (1 << 63) + 5, fleet_keys))
    np.testing.assert_array_equal(out["port"][0].words, out["jax"][0].words)
    np.testing.assert_array_equal(out["port"][1].words, out["jax"][1].words)
    return out


def test_cascade_matches_jax_and_host(filters):
    """Keys in the region only, the fleet only, both, and neither (one
    7-byte length class: each class compiles the JAX cascade anew)."""
    keys = ([f"r-{i:05d}" for i in range(0, 1500, 30)]          # region
            + [f"f-{i:05d}" for i in range(0, 1200, 30)]        # fleet
            + [f"r-{i:05d}" for i in range(0, 200, 20)]         # both
            + [f"n-{i:05d}" for i in range(60)])                # neither
    region, fleet = filters["port"]
    want = region.may_contain_batch(keys) | fleet.may_contain_batch(keys)
    got = tgen.DeviceBloomCascade(device="cpu").may_contain_batch(
        region, fleet, keys)
    np.testing.assert_array_equal(got, want)
    jr, jf = filters["jax"]
    np.testing.assert_array_equal(
        jgen.DeviceBloomCascade().may_contain_batch(jr, jf, keys), want)
    assert got[:100].all() and not got.all()


def test_cascade_at_production_keys(filters):
    region, fleet = filters["port"]
    keys = bloom_bench.production_keys(300, seed=4)
    region.add_many(keys[:100])         # the fixture's copy: port only
    fleet.add_many(keys[80:160])
    want = region.may_contain_batch(keys) | fleet.may_contain_batch(keys)
    cas = tgen.DeviceBloomCascade(device="cpu")
    got = cas.may_contain_batch(region, fleet, keys)
    np.testing.assert_array_equal(got, want)
    assert got[:160].all() and not got.all()
    # One call of the function beneath, on the one length class.
    ((length, _, packed),) = tpipe.pack_key_buckets(keys)
    direct = tpipe.bloom_cascade_from_keys(
        tpipe.as_device_words(region.words, "cpu"),
        tpipe.as_device_words(fleet.words, "cpu"),
        tpipe.as_device_words(packed, "cpu"), length,
        tpipe.seed_pair(region.salt), tpipe.seed_pair(fleet.salt),
        num_bits=BITS, num_hashes_region=10, num_hashes_fleet=7)
    np.testing.assert_array_equal(direct.numpy(), want)
    assert cas.may_contain_batch(region, fleet, []).shape == (0,)
    with pytest.raises(ValueError, match="share num_bits"):
        cas.may_contain_batch(region, tbloom.SaltedBloomFilter(
            num_bits=1009, num_hashes=3, salt=1), ["k"])


def test_replica_matches_jax(filters):
    region, _ = filters["port"]
    jr, _ = filters["jax"]
    rep = tgen.DeviceBloomReplica(region.to_bytes(), 10, region.salt,
                                  num_bits=BITS, device="cpu")
    keys = ([f"r-{i:05d}" for i in range(40)]
            + [f"n-{i:05d}" for i in range(40)])
    got = rep.may_contain_batch(keys)
    jrep = jgen.DeviceBloomReplica(jr.to_bytes(), 10, jr.salt,
                                   num_bits=BITS)
    want = jrep.may_contain_batch(keys)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, region.may_contain_batch(keys))
    assert got[:40].all() and not got.all()
    assert rep.may_contain_batch([]).shape == (0,)


def test_replica_and_cascade_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    data = tbloom.SaltedBloomFilter(num_bits=64, num_hashes=2).to_bytes()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tgen.DeviceBloomReplica(data, 2, 0, num_bits=64)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tgen.DeviceBloomCascade()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bloom_bench.run(10, 10)


def test_generator_matches_jax():
    """Both generators, same salt, same virtual clock steps: incremental
    keys, rebuild with its compensation window, filter bytes, snapshot
    and can_serve_incremental."""
    tclock, jclock = TVirtualClock(100.0), JVirtualClock(100.0)
    tg = tgen.BloomFilterGenerator(num_bits=BITS, num_hashes=10,
                                   clock=tclock, salt=42)
    jg = jgen.BloomFilterGenerator(num_bits=BITS, num_hashes=10,
                                   clock=jclock, salt=42)

    def both(fn):
        a, b = fn(tg), fn(jg)
        if isinstance(a, bytes):
            assert a == b
        else:
            assert a == b, (a, b)
        return a

    for step, keys in enumerate(([f"a-{i}" for i in range(50)],
                                 [f"b-{i}" for i in range(30)],
                                 [f"c-{i}" for i in range(20)])):
        for k in keys:
            tg.add(k)
            jg.add(k)
        tclock.advance(1000.0)
        jclock.advance(1000.0)
        both(lambda g: g.get_newly_populated_keys(1500.0))
        both(lambda g: [g.can_serve_incremental(a) for a in
                        (0.0, 500.0, 1999.0, 2500.0, 3539.0, 3541.0)])
    both(lambda g: g.filter_bytes())
    # Rebuild from an enumeration that misses the "c" keys: the
    # compensation window (the last hour's adds) keeps them.
    both(lambda g: g.rebuild([f"a-{i}" for i in range(50)]
                             + [f"d-{i}" for i in range(40)]))
    assert both(lambda g: g.may_contain("c-3"))
    assert both(lambda g: g.may_contain("d-7"))
    both(lambda g: g.filter_bytes())
    both(lambda g: g.snapshot().to_bytes())
    both(lambda g: g.fill_ratio())
    both(lambda g: (g.salt, g.num_hashes))
    tclock.advance(4000.0)
    jclock.advance(4000.0)
    assert both(lambda g: g.get_newly_populated_keys(1e9)) == []
    both(lambda g: g.rebuild(iter([f"e-{i}" for i in range(10)])))
    assert not both(lambda g: g.may_contain("c-3"))
    both(lambda g: g.filter_bytes())
    assert tgen.BloomFilterGenerator(num_bits=64, num_hashes=2).salt < 2**32


def test_bench_runs_on_the_cpu_with_every_check():
    res = bloom_bench.run(300, 200, device="cpu", reps=1)
    assert res["device"] == "cpu" and res["timer"] == "host_clock"
    assert res["filter_bits"] == 27_584_639 and res["num_hashes"] == 10
    assert res["key_bytes"] == 80
    assert [s["hit_rate"] for s in res["sweep"]] == [0.01, 0.10, 0.50]
    for s in res["sweep"]:
        assert s["observed_positive_rate"] >= s["hit_rate"]
        assert s["cascade_positive_rate"] >= s["observed_positive_rate"]
        assert set(s["device_fused"]) >= {"pack_seconds", "upload_seconds",
                                          "kernel_seconds",
                                          "end_to_end_seconds"}
        assert "host_loop" not in s
    keys = bloom_bench.production_keys(3, seed=1)
    assert all(len(k) == 80 and k.startswith("ytpu-cxx2-entry-")
               for k in keys)
    assert keys == bloom_bench.production_keys(3, seed=1)
    assert cuda_bloom.launches == dict.fromkeys(cuda_bloom.KERNELS, 0)
