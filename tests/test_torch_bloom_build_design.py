"""CPU models of the Bloom probe and scatter-OR kernels (csrc/bloom.cu),
held against the JAX package and the host filter.

The scatter-OR kernel builds the filter in two launches a pass: bin
blocks count their probes by filter slice, scan the counts into their
column of a [slices + 1] x [segments] table and write each probe's bit
offset within its slice, sorted by slice, to their own segment of a
scratch; then block s walks slice s's run in every segment and ORs it
into its slice of the words.
`binned_build` repeats that data flow in numpy on the plan the wrapper
computes (ops/cuda_bloom.py:scatter_plan), with the kernel's thread order
for the keys and probes of a bin block.  The probe kernel takes h2 as the
fingerprint gives it (even or 0), unlike a digest's split, which forces
it odd; `probe_chained` repeats its loop.  The fingerprints are
chip_smoke.py's raw pools (even h2, h2 = 0 and 2^32 - 1, wrapping h1);
its phase 7 holds the kernels themselves equal to their plain versions
on the card.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest

from yadcc_tpu.common import bloom as jbloom
from yadcc_tpu.ops import bloom_probe as jprobe
from yadcc_tpu_torch.common import bloom as tbloom
from yadcc_tpu_torch.ops import cuda_bloom

from chip_smoke import host_probe_or, raw_fingerprints

M32 = np.uint64(0xFFFFFFFF)
BIG_BITS = (1 << 31) + 11
# csrc/bloom.cu:kNarrowShift: slices of at most 2^11 words keep uint16
# entries.
NARROW_SHIFT = 11


def probe_index(x: np.ndarray, num_bits: int) -> np.ndarray:
    """csrc/bloom.cu:mod_bits, the remainder of a uint32 (held equal to
    `%` by tests/test_torch_bloom_design.py)."""
    return (x.astype(np.uint64) % np.uint64(num_bits)).astype(np.uint32)


def one_slice_fingerprints(rng, n: int, num_hashes: int, num_bits: int):
    """Fingerprints whose every probe falls in one slice of the plan."""
    plan = cuda_bloom.scatter_plan(num_bits, max(1, num_hashes), n)
    slice_bits = 32 << plan.slice_shift
    s = plan.slices // 2
    span = min(slice_bits, num_bits - s * slice_bits)
    step = max(1, span // (4 * max(1, num_hashes)))
    h2 = rng.integers(0, step, n, dtype=np.uint64)
    h1 = s * slice_bits + rng.integers(
        0, max(1, span - num_hashes * step), n, dtype=np.uint64)
    return np.stack([h1, h2], axis=1).astype(np.uint32)


def host_or(words, fps, num_bits: int, num_hashes: int) -> np.ndarray:
    """The words with every probe bit set by the host's arithmetic."""
    return host_probe_or(np.asarray(words, np.uint32),
                         np.asarray(fps, np.uint32), num_bits, num_hashes)[1]


def bin_block(fps, m: int, first: int, keys_per_thread: int, i0: int,
              hk: int, num_bits: int) -> np.ndarray:
    """The probe indices of one bin block, as its threads take them
    (key first + j * BIN_THREADS + thread; probes i0 .. i0 + hk)."""
    t = np.arange(cuda_bloom.BIN_THREADS)
    keys = (first + np.arange(keys_per_thread)[:, None]
            * cuda_bloom.BIN_THREADS + t[None, :]).ravel()
    keys = keys[keys < m]
    h1 = fps[keys, 0].astype(np.uint64)
    h2 = fps[keys, 1].astype(np.uint64)
    i = np.arange(i0, i0 + hk, dtype=np.uint64)[None, :]
    x = (h1[:, None] + i * h2[:, None]) & M32          # wrapping
    return probe_index(x.ravel(), num_bits)


def binned_build(words: np.ndarray, fps: np.ndarray, num_bits: int,
                 num_hashes: int, out=None) -> np.ndarray:
    """The scatter-OR kernel's data flow, pass by pass: returns the new
    words in ``out`` (by default a copy of ``words``, words past the
    filter's kept; ``out`` may be ``words``, as for a pass after the
    first)."""
    out = words.copy() if out is None else out
    n = len(fps)
    if n == 0 or num_hashes == 0:
        return out
    plan = cuda_bloom.scatter_plan(num_bits, num_hashes, n)
    nw = -(-num_bits // 32)
    shift = plan.slice_shift + 5
    assert plan.hash_chunk * plan.keys_per_thread * cuda_bloom.BIN_THREADS \
        <= cuda_bloom.BIN_PROBES
    assert (plan.slices - 1) << plan.slice_shift < nw <= \
        plan.slices << plan.slice_shift
    pass_keys = plan.block_keys * plan.key_blocks
    for p in range(plan.passes):
        k0 = p * pass_keys
        chunk = fps[k0:k0 + pass_keys]
        m = len(chunk)
        gx = -(-m // plan.block_keys)
        segments = gx * plan.hash_blocks
        assert segments <= plan.segments
        scratch = np.zeros(segments * cuda_bloom.BIN_PROBES, np.uint32)
        table = np.zeros((plan.slices + 1, segments), np.int64)
        # (a) Bin: count by slice, scan into the table's column, place.
        for y in range(plan.hash_blocks):
            i0 = y * plan.hash_chunk
            hk = min(plan.hash_chunk, num_hashes - i0)
            for x in range(gx):
                seg = y * gx + x
                idx = bin_block(chunk, m, x * plan.block_keys,
                                plan.keys_per_thread, i0, hk, num_bits)
                assert len(idx) <= cuda_bloom.BIN_PROBES
                sl = (idx >> shift).astype(np.int64)
                counts = np.bincount(sl, minlength=plan.slices + 1)
                table[:, seg] = np.concatenate([[0], np.cumsum(counts)])[
                    :plan.slices + 1]
                order = np.argsort(sl, kind="stable")
                # An entry is the bit's offset within its slice.
                scratch[seg * cuda_bloom.BIN_PROBES:][:len(idx)] = \
                    idx[order] & np.uint32((32 << plan.slice_shift) - 1)
        # (b) Own: slice s takes its run of every segment.
        for s in range(plan.slices):
            lo, hi = table[s], table[s + 1]
            if not (hi > lo).any():
                continue
            runs = [scratch[g * cuda_bloom.BIN_PROBES + lo[g]:
                            g * cuda_bloom.BIN_PROBES + hi[g]]
                    for g in range(segments) if hi[g] > lo[g]]
            entry = np.concatenate(runs)
            if plan.slice_shift <= NARROW_SHIFT:
                assert (entry < 1 << 16).all()      # uint16 entries
            np.bitwise_or.at(out, (s << plan.slice_shift) + (entry >> 5),
                             np.uint32(1) << (entry & 31).astype(np.uint32))
    return out


def jax_scatter(words, fps, num_bits: int, num_hashes: int) -> np.ndarray:
    return np.asarray(jprobe.bloom_scatter_add(
        jnp.asarray(words), jnp.asarray(fps), num_bits=num_bits,
        num_hashes=num_hashes))


def probe_chained(words, fps, num_bits: int, num_hashes: int) -> np.ndarray:
    """csrc/bloom.cu:probe_h for each [h1, h2] row, h2 as given: x steps
    by h2 in uint32 and the walk stops at the first zero bit."""
    words = np.asarray(words, np.uint32)
    x, h2 = fps[:, 0].astype(np.uint64), fps[:, 1].astype(np.uint64)
    member = np.ones(len(fps), bool)
    for _ in range(num_hashes):
        live = np.flatnonzero(member)
        idx = probe_index(x[live], num_bits)
        member[live] = ((words[idx >> 5] >> (idx & 31)) & 1).astype(bool)
        x = (x + h2) & M32
    return member


@pytest.mark.parametrize("num_bits,num_hashes,expect", [
    (1, 10, (8, 1, 3, 10, 1)), (33, 7, (8, 1, 4, 7, 1)),
    (27_584_639, 10, (11, 421, 3, 10, 1)),
    (27_584_639, 1, (11, 421, 32, 1, 1)),
    (BIG_BITS, 10, (15, 2049, 3, 10, 1)),
    ((1 << 32) - 1, 33, (15, 4096, 1, 32, 2)),
    (1000, 1 << 16, (8, 1, 1, 32, 2048))])
def test_scatter_plan(num_bits, num_hashes, expect):
    """The plan's slices cover the filter, at least MIN_SLICES when it is
    large enough; a bin block sorts at most BIN_PROBES pairs; a pass has at
    most MAX_SEGMENTS bin blocks; every key's probes fit in one pass."""
    plan = cuda_bloom.scatter_plan(num_bits, num_hashes, 1_000_000)
    assert (plan.slice_shift, plan.slices, plan.keys_per_thread,
            plan.hash_chunk, plan.hash_blocks) == expect
    nw = -(-num_bits // 32)
    assert plan.slices == -(-nw // (1 << plan.slice_shift))
    if nw >= cuda_bloom.MIN_SLICES << 8 and nw <= cuda_bloom.MIN_SLICES << 15:
        assert plan.slices >= cuda_bloom.MIN_SLICES
    assert plan.segments <= cuda_bloom.MAX_SEGMENTS
    assert plan.key_blocks * plan.passes * plan.block_keys >= 1_000_000
    assert plan.hash_chunk * plan.hash_blocks >= num_hashes


def test_scatter_plan_production_scratch():
    """At the production build (1M keys, 27,584,639 bits, 10 hashes) one
    pass of 652 bin blocks: uint16 entries, 21.4 MB of scratch (the
    wrapper allocates it as int32), and a 1.1 MB table."""
    plan = cuda_bloom.scatter_plan(27_584_639, 10, 1_000_000)
    assert (plan.key_blocks, plan.passes, plan.segments) == (652, 1, 652)
    assert plan.slice_shift <= NARROW_SHIFT
    assert plan.segments * cuda_bloom.BIN_PROBES * 2 == 21_364_736
    assert (plan.slices + 1) * plan.segments * 4 == 1_100_576


@pytest.mark.parametrize("num_bits,num_hashes,n,kind,extra", [
    (1, 10, 257, "raw", 0), (33, 7, 255, "raw", 2), (33, 0, 9, "raw", 0),
    (1000, 1, 3000, "raw", 1), (1000, 10, 1, "raw", 0),
    (27_584_639, 10, 1000, "raw", 3), (27_584_639, 7, 20_000, "raw", 0),
    (27_584_639, 10, 2000, "one_slice", 0), (1000, 10, 600, "one_slice", 1),
    (27_584_639, 40, 300, "raw", 0)])
def test_binned_build_matches_jax(num_bits, num_hashes, n, kind, extra):
    """The binned build equals the JAX bloom_scatter_add (jitted, as the
    JAX package's tests run it) and the host OR on raw fingerprints, a
    batch whose probes all fall in one slice and words longer than the
    filter's among them; ``words`` stays as it was."""
    rng = np.random.default_rng(num_bits % 997 + 31 * n + num_hashes)
    nw = -(-num_bits // 32)
    words = (rng.integers(0, 1 << 32, nw + extra, dtype=np.uint64)
             & rng.integers(0, 1 << 32, nw + extra, dtype=np.uint64)
             ).astype(np.uint32)
    fps = (raw_fingerprints if kind == "raw" else one_slice_fingerprints)(
        rng, n, num_hashes, num_bits)
    before = words.copy()
    got = binned_build(words, fps, num_bits, num_hashes)
    np.testing.assert_array_equal(words, before)
    np.testing.assert_array_equal(got[nw:], words[nw:])
    np.testing.assert_array_equal(got[:nw], jax_scatter(
        words[:nw], fps, num_bits, num_hashes))
    np.testing.assert_array_equal(got, host_or(words, fps, num_bits,
                                               num_hashes))
    if num_hashes and num_bits > 32:
        assert (got != words).any()


def test_binned_build_in_passes(monkeypatch):
    """A scratch of two bin blocks: the build runs in 3 passes, each
    reading the last one's output, and equals the JAX bloom_scatter_add."""
    monkeypatch.setattr(cuda_bloom, "MAX_SEGMENTS", 2)
    rng = np.random.default_rng(5)
    fps = raw_fingerprints(rng, 7000, 10, 27_584_639)
    assert cuda_bloom.scatter_plan(27_584_639, 10, 7000).passes == 3
    words = np.zeros(-(-27_584_639 // 32), np.uint32)
    np.testing.assert_array_equal(
        binned_build(words, fps, 27_584_639, 10),
        jax_scatter(words, fps, 27_584_639, 10))


def test_binned_build_matches_add_many():
    """Keys' fingerprints (odd h2) into a zero filter of the production
    geometry: the binned build equals the host add_many of both packages."""
    keys = [f"ytpu-cxx2-entry-{i:07d}" for i in range(3000)]
    host, jhost = (mod.SaltedBloomFilter(salt=5) for mod in (tbloom, jbloom))
    host.add_many(keys)
    jhost.add_many(keys)
    np.testing.assert_array_equal(host.words, jhost.words)
    fps = tbloom.key_fingerprints(keys, 5)
    got = binned_build(np.zeros_like(host.words), fps, host.num_bits,
                       host.num_hashes)
    np.testing.assert_array_equal(got, host.words)


def test_binned_build_large_filter():
    """A 256 MB filter of 2^31 + 11 bits (2,049 slices of 2^15 words),
    257 keys of raw fingerprints: equal to the host OR.  The words start
    as zeros that the OS maps lazily, so only the touched pages count."""
    rng = np.random.default_rng(11)
    nw = -(-BIG_BITS // 32)
    fps = raw_fingerprints(rng, 257, 7, BIG_BITS)
    got = np.zeros(nw, np.uint32)
    binned_build(got, fps, BIG_BITS, 7, out=got)
    idx = tbloom.probe_indices_batch(fps, 7, BIG_BITS).ravel()
    hit = np.unique(idx >> 5)
    want = np.zeros(len(hit), np.uint32)
    np.bitwise_or.at(want, np.searchsorted(hit, idx >> 5),
                     np.uint32(1) << (idx & 31).astype(np.uint32))
    assert len(hit) > 257
    np.testing.assert_array_equal(np.flatnonzero(got), hit)
    np.testing.assert_array_equal(got[hit], want)


@pytest.mark.parametrize("num_bits,num_hashes", [
    (27_584_639, 10), (1000, 7), (33, 1), (1, 10), ((1 << 32) - 1, 3)])
def test_probe_with_given_h2_matches_jax(num_bits, num_hashes):
    """The probe loop with h2 as given (even, 0, 2^32 - 1, h1 wrapping)
    gives the JAX bloom_may_contain's verdicts; forcing h2 odd, as a
    digest's split does, gives other verdicts on the same rows."""
    rng = np.random.default_rng(num_bits % 991 + num_hashes)
    nw = min(-(-num_bits // 32), 1 << 16)
    bits = min(num_bits, nw * 32)
    fps = raw_fingerprints(rng, 2000, num_hashes, bits)
    # Half the rows members, the words otherwise half set.
    words = host_or(rng.integers(0, 1 << 32, nw, dtype=np.uint64)
                    .astype(np.uint32), fps[::2], bits, num_hashes)
    want = np.asarray(jprobe.bloom_may_contain(
        jnp.asarray(words), jnp.asarray(fps), num_bits=bits,
        num_hashes=num_hashes))
    np.testing.assert_array_equal(probe_chained(words, fps, bits,
                                                num_hashes), want)
    assert want[::2].all()
    if bits > 1000:
        assert not want.all()
        odd = fps.copy()
        odd[:, 1] |= 1
        assert (probe_chained(words, odd, bits, num_hashes) != want).any()
