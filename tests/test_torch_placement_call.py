"""The placement call's staging and slot pool, on the CPU.

A scored spill decision is one native call on the card
(ops/cuda_bloom.py: placement_pack writes the decision into a staging
slot, placement_call runs it); on the CPU placement_call runs the plain
version on the parts read back from the slot, so every CPU parity test
of the scorer (tests/test_torch_placement.py, test_torch_federation.py)
also holds the staged layout the kernel reads.  Here: each part read back
at its offset equals its input for the seeded cases
test_torch_placement.py draws, the pointer table is 8-byte aligned, a
slot grows only when C, N or T outgrow it and stays exact when reused
across shapes, the pool never hands one slot to two holders at once, the
scorer refuses a bad snapshot at install (not per call) and a staged
table that points at other words.  Integers throughout: tolerance 0."""

from __future__ import annotations

import sys
import threading

import numpy as np
import pytest
import torch

from tests.test_torch_placement import KW, wrapper_inputs
from yadcc_tpu_torch.common import bloom as tbloom
from yadcc_tpu_torch.ops import cuda_bloom
from yadcc_tpu_torch.scheduler import placement as tpl

CASES = [(1, 1, 1, 23, 0), (3, 8, 32, 80, 5), (7, 1, 32, 23, 0),
         (8, 8, 256, 80, 3)]


def seeded(c_n, t_n, n, length, pad):
    rng = np.random.default_rng(c_n * 100 + n)
    return wrapper_inputs(rng, c_n, t_n, n, length,
                          salts=(0, 17, (1 << 63) + 5),
                          no_filter=(1,) if c_n > 2 else (), pad=pad)


def pack(slot, args, kw):
    words = args[0]
    return cuda_bloom.placement_pack(
        slot, [0 if w is None else w.data_ptr() for w in words], *args[1:],
        **kw)


@pytest.mark.parametrize("c_n,t_n,n,length,pad", CASES)
def test_staged_parts_read_back_at_their_offsets(c_n, t_n, n, length, pad):
    args, kw, want = seeded(c_n, t_n, n, length, pad)
    words, seeds, terms, packed, owner, counts = args
    slot = cuda_bloom.PlacementSlot("cpu")
    lay = pack(slot, args, kw)
    assert lay.in_bytes <= slot.in_bytes
    assert lay.out_ints == c_n * t_n + 2 * t_n <= slot.out_ints
    got = cuda_bloom.placement_unpack(slot, lay)
    assert [got[k] for k in ("cells", "tasks", "n", "row_words",
                             "in_bytes", "off_terms", "off_counts",
                             "off_task", "off_packed")] == \
        [c_n, t_n, n + pad, packed.shape[1], lay.in_bytes, lay.off_terms,
         lay.off_counts, lay.off_task, lay.off_packed]
    assert {k: got[k] for k in ("length", "num_bits", "num_hashes",
                                *KW)} == kw
    assert got["ptrs"].tolist() == [0 if w is None else w.data_ptr()
                                    for w in words]
    assert np.array_equal(got["seeds"], seeds)
    for k, v in (("terms", terms), ("counts", counts),
                 ("task_of_key", owner), ("packed", packed)):
        assert np.array_equal(got[k], v), k
    # The table of 64-bit pointers and seeds: 8-byte aligned in the
    # buffer and in memory; the parts follow each other with no gap.
    assert cuda_bloom.PLACE_TABLE % 8 == 0
    assert (slot.in_np.ctypes.data + cuda_bloom.PLACE_TABLE) % 8 == 0
    assert lay.off_terms == cuda_bloom.PLACE_TABLE + 16 * c_n
    assert lay.in_bytes == lay.off_packed + packed.nbytes
    # The plain version on the staged parts is the host arithmetic.
    out = cuda_bloom.placement_call(slot, lay, words)
    assert np.array_equal(out, np.concatenate([w.reshape(-1)
                                               for w in want]))


def test_slot_grows_only_when_outgrown_and_stays_exact_on_reuse():
    slot = cuda_bloom.PlacementSlot("cpu")
    sizes = []
    # Small, then each of C, N and T outgrowing the slot, then small again.
    for c_n, t_n, n, length, pad in [(1, 1, 1, 23, 0), (7, 1, 32, 23, 0),
                                     (7, 1, 32, 23, 0), (3, 8, 32, 80, 5),
                                     (8, 8, 256, 80, 3), (1, 1, 1, 23, 0)]:
        args, kw, want = seeded(c_n, t_n, n, length, pad)
        before = (slot.host_in, slot.host_out)
        caps = (slot.in_bytes, slot.out_ints)
        lay = pack(slot, args, kw)
        grew = lay.in_bytes > caps[0] or lay.out_ints > caps[1]
        assert (slot.host_in is not before[0]
                or slot.host_out is not before[1]) == grew
        sizes.append((slot.in_bytes, slot.out_ints))
        out = cuda_bloom.placement_call(slot, lay, args[0])
        assert np.array_equal(out, np.concatenate([w.reshape(-1)
                                                   for w in want]))
    assert sizes == sorted(sizes)
    assert sizes[0] < sizes[1] == sizes[2] < sizes[3] < sizes[4] == sizes[5]


def test_pool_never_hands_one_slot_to_two_holders():
    pool = cuda_bloom.PlacementSlots("cpu")
    held, lock, errors = set(), threading.Lock(), []

    def worker():
        for _ in range(300):
            slot = pool.take()
            with lock:
                if id(slot) in held:
                    errors.append("one slot held twice")
                held.add(id(slot))
            with lock:
                held.discard(id(slot))
            pool.give(slot)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not errors
    assert 1 <= pool.created <= 8


def test_scorer_from_eight_threads_matches_host():
    rng = np.random.default_rng(21)
    universe = [f"obj-{i:04d}".ljust(80, ".") for i in range(64)]
    cells = []
    for c in range(7):
        f = tbloom.SaltedBloomFilter(num_bits=1 << 12, num_hashes=7,
                                     salt=100 + c)
        f.add_many([universe[i] for i in rng.choice(64, 24, replace=False)])
        cells.append(tpl.CellCandidate(c, float(rng.uniform(0, 2)), c % 3,
                                       True, f))
    scorer = tpl.DevicePlacementScorer(device="cpu")
    tasks = [[[universe[i] for i in rng.choice(64, 32, replace=False)]]
             for _ in range(8)]
    want = [tpl.host_reference_placement(cells, t) for t in tasks]
    errors = []

    def worker(k):
        try:
            for _ in range(3):
                got = scorer.score(cells, tasks[k])
                for f in ("scores", "best_cell", "best_score"):
                    assert np.array_equal(getattr(got, f),
                                          getattr(want[k], f)), f
        except AssertionError as e:
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(k,)) for k in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert not errors
    assert 1 <= scorer._slots.created <= 8
    assert scorer.stage_timer.percentiles()["call"]["count"] == 24


def test_install_refuses_a_bad_snapshot():
    scorer = tpl.DevicePlacementScorer(device="cpu")
    good = tbloom.SaltedBloomFilter(num_bits=1000, num_hashes=7, salt=1)
    scorer.install(1, good)
    short = tbloom.SaltedBloomFilter(num_bits=1000, num_hashes=7, salt=2)
    short._words = short._words[:-1]
    with pytest.raises(ValueError, match="shape"):
        scorer.install(2, short)
    many = tbloom.SaltedBloomFilter(num_bits=1000,
                                    num_hashes=cuda_bloom.MAX_HASHES + 1)
    with pytest.raises(ValueError, match="num_hashes"):
        scorer.install(3, many)
    zero = tbloom.SaltedBloomFilter(num_bits=1, num_hashes=7, salt=3)
    zero.num_bits = 0
    with pytest.raises(ValueError, match="num_bits"):
        scorer.install(4, zero)
    assert scorer.resident_cells() == [1]


def test_call_refuses_a_table_that_points_elsewhere():
    args, kw, _ = seeded(3, 8, 32, 80, 5)
    words = args[0]
    slot = cuda_bloom.PlacementSlot("cpu")
    lay = cuda_bloom.placement_pack(
        slot, [0 if w is None else w.data_ptr() + 4 for w in words],
        *args[1:], **kw)
    with pytest.raises(ValueError, match="other word tensors"):
        cuda_bloom.placement_call(slot, lay, words)
    with pytest.raises(ValueError, match="word pointers"):
        cuda_bloom.placement_pack(slot, [0], *args[1:], **kw)
