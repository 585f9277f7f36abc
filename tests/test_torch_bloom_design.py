"""CPU models of the staged Bloom kernels' arithmetic (csrc/bloom.cu),
held against `%` and the JAX package's probe, and the wrappers' results on
the layouts those kernels take, held against the JAX package.

The membership and cascade kernels compute each probe index as
(h1 + i*h2) mod num_bits with x += h2 in wrapping uint32 arithmetic and
the mod by a multiply-shift remainder (`mod_bits`, with the 64-bit
constant the launcher computes), and chain the probes; chip_bloom_probe.py
also builds them with the probes issued in groups.  The models below
repeat that arithmetic in numpy, step by step; chip_smoke.py phase 7
holds the kernels themselves equal to their plain versions on the card.
"""

from __future__ import annotations

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yadcc_tpu.common import bloom as jbloom
from yadcc_tpu.ops import bloom_pipeline as jpipe
from yadcc_tpu.ops import bloom_probe as jprobe
from yadcc_tpu_torch.common import bloom as tbloom
from yadcc_tpu_torch.ops import bloom_pipeline as tpipe
from yadcc_tpu_torch.ops import cuda_bloom
from yadcc_tpu_torch.ops.xxh64_torch import pack_keys

import chip_bloom_probe

M32 = np.uint64(0xFFFFFFFF)
SOURCE = Path(cuda_bloom.__file__).resolve().parent.parent / "csrc" / \
    cuda_bloom.SOURCE
DIVISORS = (1, 2, 3, 31, 32, 1000, 27_584_639, (1 << 31) - 1, 1 << 31,
            (1 << 32) - 5, (1 << 32) - 1)


def magic(d: int) -> np.uint64:
    """The launcher's constant: floor((2^64 - 1) / d) + 1, mod 2^64."""
    return np.uint64((((1 << 64) - 1) // d + 1) & ((1 << 64) - 1))


def mod_bits(x: np.ndarray, d: int) -> np.ndarray:
    """csrc/bloom.cu:mod_bits, step by step in uint64 lanes."""
    x = x.astype(np.uint64)
    with np.errstate(over="ignore"):
        low = magic(d) * x                         # mod 2^64
        hi = (low >> np.uint64(32)) * np.uint64(d) + (
            ((low & M32) * np.uint64(d)) >> np.uint64(32))
    return (hi >> np.uint64(32)).astype(np.uint32)


def probe_grouped(words, fps, num_bits: int, num_hashes: int, group: int):
    """The kernels' probe for each [h1, h2] row of ``fps``: with group 1
    csrc/bloom.cu:probe_h, else chip_bloom_probe.py's grouped build;
    the groups' bits ANDed, x stepping by h2 with uint32 wrap-around."""
    words = np.asarray(words, np.uint32)
    fps = np.asarray(fps, np.uint32)
    x, h2 = fps[:, 0].copy(), fps[:, 1]
    member = np.ones(len(fps), bool)
    for i in range(0, num_hashes, group):
        all_set = np.ones(len(fps), np.uint32)
        for j in range(group):
            if i + j < num_hashes:
                idx = mod_bits(x, num_bits)
                all_set &= words[idx >> 5] >> (idx & 31)
            with np.errstate(over="ignore"):
                x = x + h2
        member &= (all_set & 1).astype(bool)
    return member


@pytest.mark.parametrize("d", DIVISORS)
def test_mod_bits_equals_the_remainder(d):
    rng = np.random.default_rng(d % 9973)
    x = np.concatenate([
        rng.integers(0, 1 << 32, 20_000, dtype=np.uint64).astype(np.uint32),
        np.array([0, 1, d - 1, d % (1 << 32), (2 * d) % (1 << 32),
                  (1 << 32) - 1, (1 << 32) - 2, (1 << 31)], np.uint64)
        .astype(np.uint32)])
    np.testing.assert_array_equal(mod_bits(x, d),
                                  (x.astype(np.uint64) % d).astype(np.uint32))


@pytest.mark.parametrize("num_bits,num_hashes,group", [
    (27_584_639, 10, 4), (1000, 7, 1), (64, 13, 2), (1000, 0, 4),
    ((1 << 32) - 1, 3, 8)])
def test_grouped_probe_matches_jax(num_bits, num_hashes, group):
    """The kernel's probe arithmetic gives the JAX package's verdicts
    (its probe_body, jitted as bloom_may_contain); the filter's words are
    dense enough that members and non-members both occur."""
    rng = np.random.default_rng(num_bits % 977 + num_hashes)
    nw = min((num_bits + 31) // 32, 1 << 16)
    bits = min(num_bits, nw * 32)
    a, b = (rng.integers(0, 1 << 32, nw, dtype=np.uint64).astype(np.uint32)
            for _ in range(2))
    words = a | b
    fps = rng.integers(0, 1 << 32, (300, 2), dtype=np.uint64) \
        .astype(np.uint32)
    fps[:, 1] |= 1
    fps[:5, 1] = (1 << 32) - 1              # x wraps on the second probe
    want = np.asarray(jprobe.bloom_may_contain(
        jnp.asarray(words), jnp.asarray(fps), num_bits=bits,
        num_hashes=num_hashes))
    got = probe_grouped(words, fps, bits, num_hashes, group)
    np.testing.assert_array_equal(got, want)
    assert num_hashes == 0 or 0 < want.sum() < len(want)


@pytest.mark.parametrize("length", (23, 80, 129))
def test_wrappers_take_offset_views_and_wide_rows(length):
    """A contiguous `packed` view one word into its buffer, and rows past
    the staging width, are taken, not refused, and give the JAX package's
    verdicts (its fused membership; the cascade as the OR of the two
    filters' memberships, what its sharded cascade computes on one card).
    On the CPU the wrappers run their plain versions; the kernels' own
    handling of such views is held on the card by
    chip_smoke.compare_bloom_layouts."""
    rng = np.random.default_rng(length)
    keys = ["".join(map(chr, rng.integers(32, 127, length)))
            for _ in range(64)]
    fleet_salt = (1 << 63) + 5
    region, fleet = tbloom.SaltedBloomFilter(1000, 7, 17), \
        tbloom.SaltedBloomFilter(1000, 3, fleet_salt)
    jregion, jfleet = jbloom.SaltedBloomFilter(1000, 7, 17), \
        jbloom.SaltedBloomFilter(1000, 3, fleet_salt)
    for f in (region, jregion):
        f.add_many(keys[::2])
    for f in (fleet, jfleet):
        f.add_many(keys[1::3])
    packed = pack_keys([k.encode() for k in keys], length).view(np.int32)
    buf = torch.zeros(packed.size + 1, dtype=torch.int32)
    view = buf[1:].view(packed.shape)
    view.copy_(torch.from_numpy(packed))
    assert view.is_contiguous() and view.storage_offset() == 1
    words = tpipe.as_device_words(region.words, "cpu")
    fwords = tpipe.as_device_words(fleet.words, "cpu")
    seed, fseed = tpipe.seed_pair(17), tpipe.seed_pair(fleet_salt)
    with jax.disable_jit():
        want, want_fleet = (np.asarray(jpipe.bloom_membership_from_keys(
            jnp.asarray(f.words), jnp.asarray(packed.view(np.uint32)),
            length, jpipe.seed_pair(f.salt), num_bits=1000,
            num_hashes=f.num_hashes)) for f in (jregion, jfleet))
    np.testing.assert_array_equal(want, jregion.may_contain_batch(keys))
    assert 0 < want.sum() < len(keys)
    got = cuda_bloom.bloom_membership(words, view, length, seed,
                                      num_bits=1000, num_hashes=7)
    np.testing.assert_array_equal(got.numpy(), want)
    got = cuda_bloom.bloom_cascade(words, fwords, view, length, seed, fseed,
                                   num_bits=1000, num_hashes_region=7,
                                   num_hashes_fleet=3)
    np.testing.assert_array_equal(got.numpy(), want | want_fleet)
    assert (want_fleet & ~want).any()


def test_probe_script_variants_cut_the_source():
    """chip_bloom_probe.py's anchors are each in the kernel source as often
    as it expects, and every variant changes the source."""
    src = SOURCE.read_text()
    variants = chip_bloom_probe.variants(src)
    assert variants["kernel"] == src
    for name, v in variants.items():
        assert name == "kernel" or v != src
    assert {"group2", "group4", "group8", "no_hints", "staging_only",
            "digest_only", "probe_mod", "probe_min1",
            "scatter_atomic"} <= set(variants)
