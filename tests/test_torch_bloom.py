"""The port's Bloom path held against the JAX package, bit for bit.

Inputs come from numpy seeds and go through both packages as numpy
arrays; the arithmetic is integer, so every comparison is exact.  The
JAX digest and fused pipeline unroll the XXH64 loop per key length at
trace time, so a jitted call compiles for seconds per length class;
these tests run them under ``jax.disable_jit()`` (the same code, op by
op), which costs a fraction of that.  The `xxhash` wheel appears here
only: the port's host chain digests with its own numpy XXH64.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import xxhash

from yadcc_tpu.common import bloom as jbloom
from yadcc_tpu.common import xxh64_np as jxxh_np
from yadcc_tpu.ops import bloom_pipeline as jpipe
from yadcc_tpu.ops import bloom_probe as jprobe
from yadcc_tpu.ops import xxh64_jax as jxxh
from yadcc_tpu_torch.common import bloom as tbloom
from yadcc_tpu_torch.common import xxh64_np as txxh_np
from yadcc_tpu_torch.ops import bloom_pipeline as tpipe
from yadcc_tpu_torch.ops import bloom_probe as tprobe
from yadcc_tpu_torch.ops import cuda_bloom
from yadcc_tpu_torch.ops import xxh64_torch as txxh

LENGTHS = tuple(range(35)) + (63, 64, 65, 80, 100, 200)
SEEDS = (0, 17, (1 << 63) + 5)
BIG_SEED = (1 << 63) + 5


def _words(arr: np.ndarray) -> torch.Tensor:
    return tpipe.as_device_words(arr, "cpu")


def _digests(hi, lo) -> list:
    return [(int(h) << 32) | int(l) for h, l in
            zip(np.asarray(hi), np.asarray(lo))]


@pytest.mark.parametrize("length", LENGTHS)
def test_xxh64_every_tail_class(length):
    """The port's plain xxh64_device and numpy XXH64, the JAX
    xxh64_device and the wheel agree on every tail-length class, the
    stripe boundaries and multi-stripe keys."""
    rng = np.random.default_rng(1000 + length)
    # 64 keys, as in every JAX call of this file (see _class_keys).
    keys = [rng.bytes(length) for _ in range(63)]
    keys.append(b"\x00" * length)                  # all NUL bytes
    packed = txxh.pack_keys(keys, length)
    np.testing.assert_array_equal(packed, jxxh.pack_keys(keys, length))
    for seed in SEEDS:
        want = [xxhash.xxh64_intdigest(k, seed=seed) for k in keys]
        got = _digests(*txxh.xxh64_device(_words(packed), length,
                                          tpipe.seed_pair(seed)))
        assert got == want, seed
        assert list(txxh_np.xxh64_keys(keys, seed)) == want
        assert list(jxxh_np.xxh64_keys(keys, seed)) == want
    with jax.disable_jit():
        hi, lo = jxxh.xxh64_device(jnp.asarray(packed), length,
                                   jpipe.seed_pair(BIG_SEED))
    assert _digests(hi, lo) == [xxhash.xxh64_intdigest(k, seed=BIG_SEED)
                                for k in keys]


def test_xxh64_np_chunks_and_mixed_lengths(monkeypatch):
    """The copied numpy digest across chunk boundaries and over a mixed
    batch with NULs and non-ASCII text."""
    rng = np.random.default_rng(3)
    monkeypatch.setattr(txxh_np, "_CHUNK_ROWS", 7)
    keys = [rng.bytes(int(n)) for n in rng.integers(0, 90, 50)]
    keys += ["héllo", "\x00a\x00", ""]
    want = [xxhash.xxh64_intdigest(
        k.encode() if isinstance(k, str) else k, seed=BIG_SEED)
        for k in keys]
    assert list(txxh_np.xxh64_keys(keys, BIG_SEED)) == want
    mat, lens = txxh_np.pack_key_matrix(keys[:50])
    jmat, jlens = jxxh_np.pack_key_matrix(keys[:50])
    np.testing.assert_array_equal(mat, jmat)
    np.testing.assert_array_equal(lens, jlens)


@pytest.mark.parametrize("salt", SEEDS + (0xABCD1234,))
def test_key_fingerprints_match_jax(salt):
    keys = ([f"ytpu-cxx2-entry-{i:05d}" for i in range(70)]
            + ["", "a", "ünïcode-key", "x" * 33, "nul\x00inside"])
    for k in keys[::7] + keys[-5:]:
        assert tbloom.key_fingerprint(k, salt) == \
            jbloom.key_fingerprint(k, salt)
    want = jbloom.key_fingerprints(keys, salt)
    np.testing.assert_array_equal(tbloom.key_fingerprints(keys, salt), want)
    np.testing.assert_array_equal(
        tbloom.key_fingerprints_loop(keys, salt), want)
    np.testing.assert_array_equal(tbloom.key_fingerprints(keys[:5], salt),
                                  want[:5])
    assert tbloom.key_fingerprints([], salt).shape == (0, 2)


def test_host_filter_matches_jax():
    tf = tbloom.SaltedBloomFilter(num_bits=999_983, num_hashes=10,
                                  salt=0xABCD1234)
    jf = jbloom.SaltedBloomFilter(num_bits=999_983, num_hashes=10,
                                  salt=0xABCD1234)
    members = [f"ytpu-cxx2-entry-{i:05d}" for i in range(800)]
    tf.add_many(members)
    jf.add_many(members)
    tf.add("single-key")
    jf.add("single-key")
    np.testing.assert_array_equal(tf.words, jf.words)
    probe = members[::9] + [f"absent-{i}" for i in range(300)]
    want = jf.may_contain_batch(probe)
    np.testing.assert_array_equal(tf.may_contain_batch(probe), want)
    assert [tf.may_contain(k) for k in probe] == list(want)
    assert tf.fill_ratio() == jf.fill_ratio()
    back = tbloom.SaltedBloomFilter.from_bytes(tf.to_bytes(), 10,
                                               0xABCD1234, num_bits=999_983)
    np.testing.assert_array_equal(back.words, tf.words)
    fps = tbloom.key_fingerprints(probe[:20], 5)
    np.testing.assert_array_equal(
        tbloom.probe_indices_batch(fps, 10, 999_983),
        jbloom.probe_indices_batch(fps, 10, 999_983))
    with pytest.raises(ValueError):
        tbloom.SaltedBloomFilter.from_bytes(b"\x00" * 12, 3, 1)


@pytest.mark.parametrize("num_bits,num_hashes", [(999_983, 10), (64, 7),
                                                 (1000, 1)])
def test_probe_matches_jax(num_bits, num_hashes):
    """bloom_may_contain: the uint32 wrap of h1 + i*h2 (h2 near 2^32),
    num_bits not a multiple of 32, a dense filter so verdicts mix."""
    rng = np.random.default_rng(num_bits)
    nw = (num_bits + 31) // 32
    words = ~(rng.integers(0, 1 << 32, nw, dtype=np.uint32)
              & rng.integers(0, 1 << 32, nw, dtype=np.uint32)
              & rng.integers(0, 1 << 32, nw, dtype=np.uint32))
    fps = rng.integers(0, 1 << 32, (300, 2), dtype=np.uint32)
    fps[:10, 1] = 0xFFFFFFFF
    fps[:, 1] |= 1
    want = np.asarray(jprobe.bloom_may_contain(
        jnp.asarray(words), jnp.asarray(fps), num_bits=num_bits,
        num_hashes=num_hashes))
    got = tprobe.bloom_may_contain(_words(words), _words(fps),
                                   num_bits=num_bits, num_hashes=num_hashes)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.any() and not want.all()


def test_scatter_add_matches_jax_and_host():
    """bloom_scatter_add: duplicate words and bits within one batch; the
    input words unchanged; equal to the host add_many."""
    num_bits, k = 1000, 7
    keys = [f"k-{i}" for i in range(120)]
    host = tbloom.SaltedBloomFilter(num_bits, k, salt=9)
    host.add_many(keys[:30])
    start = host.words.copy()
    fps = tbloom.key_fingerprints(keys, 9)
    want = np.asarray(jprobe.bloom_scatter_add(
        jnp.asarray(start), jnp.asarray(fps), num_bits=num_bits,
        num_hashes=k))
    words = _words(start)
    got = tprobe.bloom_scatter_add(words, _words(fps), num_bits=num_bits,
                                   num_hashes=k)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    np.testing.assert_array_equal(words.numpy().view(np.uint32), start)
    host.add_many(keys)
    np.testing.assert_array_equal(want, host.words)
    # The production geometry, port against the host only.
    prod = tbloom.SaltedBloomFilter(salt=BIG_SEED)
    prod.add_many(keys)
    got = tprobe.bloom_scatter_add(
        _words(np.zeros_like(prod.words)),
        _words(tbloom.key_fingerprints(keys, BIG_SEED)),
        num_bits=prod.num_bits, num_hashes=prod.num_hashes)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), prod.words)


@pytest.fixture(scope="module")
def filt():
    f = tbloom.SaltedBloomFilter(num_bits=999_983, num_hashes=10,
                                 salt=BIG_SEED)
    f.add_many([f"ytpu-cxx2-entry-{i:05d}" for i in range(2000)])
    f.add_many([f"ytpu-cxx2-entry-{'%064x' % i}" for i in range(500)])
    return f


def _class_keys(length: int) -> list:
    """64 str keys of ``length`` utf-8 bytes: members of `filt`, absent
    keys, NUL bytes and non-ASCII text.  Every JAX call below sees 64
    keys of one of three lengths, so its op-by-op executables are
    compiled once and reused."""
    if length == 0:
        return [""] * 64
    if length == 21:
        return ([f"ytpu-cxx2-entry-{i:05d}" for i in range(0, 1200, 40)]
                + [f"ytpu-cxx2-absnt-{i:05d}" for i in range(30)]
                + ["ytpu-cxx2-\x00ntry-00000", "ytpu-cxx2-éntry-0000",
                   "\x00" * 21, "é" * 10 + "x"])
    return ([f"ytpu-cxx2-entry-{'%064x' % i}" for i in range(0, 500, 10)]
            + [f"ytpu-cxx2-absnt-{'%064x' % i}" for i in range(10)]
            + ["\x00" * 80, "é" * 40, "ytpu-cxx2-\x00" + "é" * 34 + "x",
               "x" * 79 + "\x00"])


@pytest.mark.parametrize("length", (0, 21, 80))
def test_membership_from_keys_matches_jax(filt, length):
    """The fused digest->split->probe call on one length class."""
    keys = [k.encode() for k in _class_keys(length)]
    assert {len(k) for k in keys} == {length} and len(keys) == 64
    packed = txxh.pack_keys(keys, length)
    with jax.disable_jit():
        want = np.asarray(jpipe.bloom_membership_from_keys(
            jnp.asarray(filt.words), jnp.asarray(packed), length,
            jpipe.seed_pair(filt.salt), num_bits=filt.num_bits,
            num_hashes=filt.num_hashes))
    got = tpipe.bloom_membership_from_keys(
        _words(filt.words), _words(packed), length,
        tpipe.seed_pair(filt.salt), num_bits=filt.num_bits,
        num_hashes=filt.num_hashes)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        want, filt.may_contain_batch(_class_keys(length)))
    if length:
        assert want[:30].all() and not want.all()


def test_membership_batch_matches_jax(filt):
    """The variable-length front door: three length classes shuffled
    together, NUL bytes and non-ASCII keys, members and absent keys."""
    keys = _class_keys(0) + _class_keys(21) + _class_keys(80)
    order = np.random.default_rng(8).permutation(len(keys))
    keys = [keys[i] for i in order]
    with jax.disable_jit():
        want = jpipe.bloom_membership_batch(
            jnp.asarray(filt.words), keys, filt.salt,
            num_bits=filt.num_bits, num_hashes=filt.num_hashes)
    got = tpipe.bloom_membership_batch(
        _words(filt.words), keys, filt.salt, num_bits=filt.num_bits,
        num_hashes=filt.num_hashes)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, filt.may_contain_batch(keys))
    assert 60 < got.sum() < len(keys)
    assert tpipe.bloom_membership_batch(
        _words(filt.words), [], 1, num_bits=filt.num_bits,
        num_hashes=1).shape == (0,)


def test_pack_key_buckets_and_seed_pair_match_jax():
    keys = ["abc", "defgh", "ij", "klm", "", "é", "ytpu-" * 9]
    tb, jb = tpipe.pack_key_buckets(keys), jpipe.pack_key_buckets(keys)
    assert len(tb) == len(jb) == 5      # "ij" and "é" are both 2 bytes
    for (tl, ti, tm), (jl, ji, jm) in zip(tb, jb):
        assert tl == jl
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(tm, np.asarray(jm))
    uniform = tpipe.pack_key_buckets(["abcd", "efgh"])
    assert uniform[0][0] == 4 and uniform[0][1] == slice(None)
    for salt in SEEDS + ((1 << 64) + 3, -1):
        np.testing.assert_array_equal(tpipe.seed_pair(salt),
                                      np.asarray(jpipe.seed_pair(salt)))
    for bits, shards in ((27_584_639, 8), (1000, 3), (64, 4)):
        assert tprobe.partitioned_shard_bounds(bits, shards) == \
            jprobe.partitioned_shard_bounds(bits, shards)


def test_wrappers_route_cpu_tensors_to_the_plain_versions(filt):
    """On the CPU each wrapper runs its plain version, counts no launch,
    and refuses what the kernel would not take."""
    before = dict(cuda_bloom.launches)
    w = _words(filt.words)
    keys = [f"ytpu-cxx2-entry-{i:05d}".encode() for i in range(40)]
    packed = _words(txxh.pack_keys(keys, 21))
    seed = tpipe.seed_pair(filt.salt)
    geo = dict(num_bits=filt.num_bits, num_hashes=filt.num_hashes)
    got = cuda_bloom.bloom_membership(w, packed, 21, seed, **geo)
    assert torch.equal(got, tpipe.membership_plain(
        w, packed, 21, seed, filt.num_bits, filt.num_hashes))
    assert got.all()
    fps = _words(tbloom.key_fingerprints(keys, filt.salt))
    assert torch.equal(cuda_bloom.bloom_probe(w, fps, **geo), got)
    cas = cuda_bloom.bloom_cascade(
        w, torch.zeros_like(w), packed, 21, seed, seed,
        num_bits=filt.num_bits, num_hashes_region=10, num_hashes_fleet=0)
    assert cas.all()    # zero fleet hashes admit every key
    assert cuda_bloom.bloom_membership(
        w, packed[:0], 21, seed, **geo).shape == (0,)
    assert torch.equal(cuda_bloom.bloom_scatter_or(w, fps[:0], **geo), w)
    assert cuda_bloom.launches == before
    bad = [
        lambda: cuda_bloom.bloom_membership(w.long(), packed, 21, seed,
                                            **geo),
        lambda: cuda_bloom.bloom_membership(w, packed, 25, seed, **geo),
        lambda: cuda_bloom.bloom_membership(w, packed[:, :5], 21, seed,
                                            **geo),
        lambda: cuda_bloom.bloom_probe(w, fps.long(), **geo),
        lambda: cuda_bloom.bloom_probe(w, fps.t().contiguous().t(), **geo),
        lambda: cuda_bloom.bloom_probe(w[:10], fps, **geo),
        lambda: cuda_bloom.bloom_scatter_or(w, fps, num_bits=0,
                                            num_hashes=3),
        lambda: cuda_bloom.bloom_scatter_or(w, fps, num_bits=1 << 32,
                                            num_hashes=3),
        lambda: cuda_bloom.bloom_probe(w, fps[:, :1], **geo),
    ]
    for call in bad:
        with pytest.raises((TypeError, ValueError)):
            call()
