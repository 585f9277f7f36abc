"""Scored spill placement: the cells×tasks affinity cost matrix.

The port of yadcc_tpu/scheduler/placement.py.  The device scorer runs
the hand-written kernel of csrc/bloom.cu (ops/cuda_bloom.py:
placement_pack, then placement_call: one native call a decision) on the
card, its plain version on the CPU; both equal the host oracle bit for
bit (tests/test_torch_placement.py, chip_smoke.py phases 2 and 11).

Spillover used to pick the least-loaded peer by one scalar utilization
read, landing spilled tasks on cells whose cache tiers had never seen
their keys.  This module makes placement a *scored* decision over three
fused signals — cache warmth (each cell's region Bloom filter probed
for the candidate keys), load (the peer signal the router already
reads), and topology distance — evaluated as ONE batched device call:
one native call that stages the inputs, launches the kernel once (the
score and the per-task argmin) and reads the picks back.

Two scorers, one arithmetic:

* :func:`reference_scores` — the host parity oracle.  Pure int32 numpy
  restating the kernel's exact math (integer warmth quantization,
  floor-division, BIG sentinel for ineligible cells, first-occurrence
  argmin = lowest-cell tie-break).  The tests hold the device output
  against it bit-for-bit.
* :class:`DevicePlacementScorer` — the production path: packs the
  candidate keys into a pinned staging slot, runs the device call over
  every cell at once, reads back the picks.  Each cell's filter snapshot
  lives on the card, uploaded and checked once when it is installed (the
  JAX scorer uploads a padded words matrix every decision: ~24 MB at the
  production geometry and 7 peers).  No per-peer host loop anywhere.

The warmth term is *sampled*, not exact: mixed-byte-length key batches
keep only the dominant length class (:func:`prepare_probe_batch`), so
the spill hot path stays one launch per decision instead of one per
length bucket.  Dropped stragglers only soften the warmth estimate —
placement correctness never depends on it (the fallback ladder in
scheduler/federation.py degrades to least-loaded, then spill_no_peer).

All scoring is int32 end to end:

    miss_q[c,t] = (counts[t] - hits[c,t]) * WARM_SCALE
                    // max(counts[t], 1)     (WARM_SCALE when cell c
                                              has no filter snapshot)
    score[c,t]  = W_WARM * miss_q[c,t]
                  + W_LOAD * util_q[c] + W_TOPO * topo_q[c]

with ineligible cells pinned to BIG; ``best_score >= BIG`` means "no
placeable cell" and the caller walks down the fallback ladder.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..common.bloom import SaltedBloomFilter
from ..device import resolve_device
from ..ops import cuda_bloom
from ..ops.bloom_pipeline import as_device_words, pack_key_buckets, seed_pair
from ..utils.stagetimer import StageTimer

# Warmth quantization scale: miss ratios land in [0, WARM_SCALE].  With
# W_WARM = 4 a fully-cold cell pays 4096 score points — the load term
# (utilization * WARM_SCALE) needs a 4x utilization gap to override a
# warm/cold split: warmth beats a moderate load imbalance.
WARM_SCALE = 1024
W_WARM = 4
W_LOAD = 1
W_TOPO = 1
# Same infeasible sentinel as the assignment kernels: any real score is far below it, so argmin never picks an
# ineligible cell unless every cell is ineligible.
BIG = 2 ** 30
# Utilization clamp before quantization: the ladder has long since
# shed/spilled by 32x, and the clamp keeps util_q * W_LOAD orders of
# magnitude clear of int32 overflow.
_UTIL_CLAMP = 32.0


def quantize_utilization(utilization: float) -> int:
    """Host-side load quantization (input prep, shared by both scorers
    — the parity surface starts at the int arrays, not here)."""
    u = min(max(float(utilization), 0.0), _UTIL_CLAMP)
    return int(round(u * WARM_SCALE))


@dataclass
class CellCandidate:
    """One cell as the scorer sees it: identity, the (quantized-on-
    entry) load and topology terms, and an optional region-filter
    snapshot (cache/bloom_filter_generator.py:snapshot)."""

    cell_id: int
    utilization: float = 0.0
    topo_distance: int = 0
    eligible: bool = True
    filter: Optional[SaltedBloomFilter] = None


@dataclass
class ProbeBatch:
    """The kept candidate keys, packed for the device digest.  `kept`
    mirrors `packed` row-for-row on the host side so the oracle probes
    exactly the keys the kernel probes."""

    length: int                       # byte length of the kept class
    packed: np.ndarray                # uint32[N, kw]
    task_of_key: np.ndarray           # int32[N]
    counts: np.ndarray                # int32[T] kept keys per task
    kept: List[List[str]]             # per-task kept keys (host oracle)
    dropped: int = 0                  # stragglers outside the class


@dataclass
class PlacementResult:
    scores: np.ndarray                # int32[C, T]
    best_cell: np.ndarray             # int32[T] candidate INDEX per task
    best_score: np.ndarray            # int32[T]
    batch: ProbeBatch
    device: bool = False              # which scorer produced it


def prepare_probe_batch(
        keys_per_task: Sequence[Sequence[str]]) -> Optional[ProbeBatch]:
    """Flatten per-task candidate keys and keep the dominant byte-length
    class (ops/bloom_pipeline.py:pack_key_buckets layout).  Warmth is a
    sampled signal: one launch per decision beats one per length class,
    and `dropped` records what the sample excluded.  Returns None when
    there are no keys at all (callers fall back to least-loaded)."""
    flat: List[str] = []
    owner: List[int] = []
    for t, ks in enumerate(keys_per_task):
        for k in ks:
            flat.append(k)
            owner.append(t)
    if not flat:
        return None
    buckets = pack_key_buckets(flat)
    length, idxs, packed = max(buckets, key=lambda b: b[2].shape[0])
    idx_arr = (np.arange(len(flat)) if isinstance(idxs, slice)
               else np.asarray(idxs))
    owner_arr = np.asarray(owner, np.int32)
    task_of_key = owner_arr[idx_arr]
    counts = np.bincount(task_of_key,
                         minlength=len(keys_per_task)).astype(np.int32)
    kept: List[List[str]] = [[] for _ in keys_per_task]
    for i in idx_arr:
        kept[owner_arr[i]].append(flat[i])
    return ProbeBatch(length=length,
                      packed=np.ascontiguousarray(packed),
                      task_of_key=task_of_key.astype(np.int32),
                      counts=counts, kept=kept,
                      dropped=len(flat) - len(idx_arr))


def reference_scores(hits: np.ndarray, counts: np.ndarray,
                     util_q: np.ndarray, topo_q: np.ndarray,
                     eligible: np.ndarray, has_filter: np.ndarray,
                     *, w_warm: int = W_WARM, w_load: int = W_LOAD,
                     w_topo: int = W_TOPO
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """THE host restatement of placement_score_fn's score math — int32,
    floor division, BIG sentinel, np.argmin's first occurrence as the
    lowest-cell tie-break.  Any edit here must land in the kernel and its
    plain version too; the tests hold them bit-equal."""
    hits = np.asarray(hits, np.int32)
    counts = np.asarray(counts, np.int32)
    denom = np.maximum(counts, 1)[None, :]
    miss_q = ((counts[None, :] - hits) * np.int32(WARM_SCALE)) // denom
    miss_q = np.where(np.asarray(has_filter)[:, None] > 0,
                      miss_q, np.int32(WARM_SCALE))
    score = (np.int32(w_warm) * miss_q
             + (np.int32(w_load) * np.asarray(util_q, np.int32)
                + np.int32(w_topo) * np.asarray(topo_q, np.int32))
             [:, None]).astype(np.int32)
    score = np.where(np.asarray(eligible)[:, None] > 0,
                     score, np.int32(BIG))
    best_cell = np.argmin(score, axis=0).astype(np.int32)
    best_score = score[best_cell, np.arange(score.shape[1])]
    return score, best_cell, best_score


def _candidate_arrays(cells: Sequence[CellCandidate]
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                 np.ndarray]:
    util_q = np.asarray([quantize_utilization(c.utilization)
                         for c in cells], np.int32)
    topo_q = np.asarray([int(c.topo_distance) for c in cells], np.int32)
    eligible = np.asarray([1 if c.eligible else 0 for c in cells],
                          np.int32)
    has_filter = np.asarray([1 if c.filter is not None else 0
                             for c in cells], np.int32)
    return util_q, topo_q, eligible, has_filter


def host_reference_placement(
        cells: Sequence[CellCandidate],
        keys_per_task: Sequence[Sequence[str]]
        ) -> Optional[PlacementResult]:
    """Full-chain host oracle: per-cell filter probes via the host
    may_contain path, then reference_scores.  Same dominant-bucket key
    selection as the device path, so the two chains see identical
    inputs."""
    batch = prepare_probe_batch(keys_per_task)
    if batch is None:
        return None
    hits = np.zeros((len(cells), len(batch.kept)), np.int32)
    for ci, cell in enumerate(cells):
        if cell.filter is None:
            continue
        for t, ks in enumerate(batch.kept):
            if ks:
                hits[ci, t] = int(np.count_nonzero(
                    cell.filter.may_contain_batch(ks)))
    util_q, topo_q, eligible, has_filter = _candidate_arrays(cells)
    score, best_cell, best_score = reference_scores(
        hits, batch.counts, util_q, topo_q, eligible, has_filter)
    return PlacementResult(score, best_cell, best_score, batch,
                           device=False)


class DevicePlacementScorer:
    """Production scorer: ONE device call per placement decision, on
    ``device`` (the card unless the caller asks for the CPU, where the
    call runs the plain version on the same staged input).

    Each cell's filter snapshot has one copy on the device, keyed by the
    snapshot object: :meth:`install` (FederationRouter.update_cell_filter)
    uploads and checks it once, and :meth:`score` uploads a snapshot it
    has not seen for that cell, replacing the old copy.  A snapshot is a
    point-in-time copy (cache/bloom_filter_generator.py:snapshot) and is
    not mutated after it is installed; a new sync installs a new object.
    Concurrent calls each take their own staging slot from the scorer's
    pool (ops/cuda_bloom.py:PlacementSlots)."""

    def __init__(self, device="cuda"):
        self._device = resolve_device(device)
        self._lock = threading.Lock()
        self._slots = cuda_bloom.PlacementSlots(self._device)
        # A scored call's host time: pack (the probe batch, the cells'
        # arrays and snapshot lookups, the write into a staging slot) and
        # call (the one native call: copy up, launch, copy back, wait;
        # on the CPU the plain version).
        self.stage_timer = StageTimer(("pack", "call"))
        # cell_id -> (snapshot, its words on the device, their address)
        self._resident: Dict[int, Tuple[SaltedBloomFilter, torch.Tensor,
                                        int]] = \
            {}  # guarded by: self._lock

    @property
    def device(self) -> torch.device:
        return self._device

    def install(self, cell_id: int,
                snapshot: Optional[SaltedBloomFilter]) -> None:
        """Upload ``snapshot``'s words for ``cell_id`` (None drops the
        cell's copy); raises for words the kernel cannot take."""
        if snapshot is None:
            with self._lock:
                self._resident.pop(cell_id, None)
            return
        self._words(cell_id, snapshot)

    def resident_cells(self) -> List[int]:
        with self._lock:
            return sorted(self._resident)

    def _words(self, cell_id: int, snapshot: SaltedBloomFilter
               ) -> Tuple[SaltedBloomFilter, torch.Tensor, int]:
        with self._lock:
            hit = self._resident.get(cell_id)
        if hit is not None and hit[0] is snapshot:
            return hit
        words = as_device_words(snapshot.words, self._device)
        cuda_bloom.check_placement_words(words, snapshot.num_bits,
                                         snapshot.num_hashes, self._device)
        if self._device.type == "cuda":
            # The upload lands before any stream's kernel reads it.
            torch.cuda.current_stream(self._device).synchronize()
        entry = (snapshot, words, words.data_ptr())
        with self._lock:
            self._resident[cell_id] = entry
        return entry

    def score(self, cells: Sequence[CellCandidate],
              keys_per_task: Sequence[Sequence[str]]
              ) -> Optional[PlacementResult]:
        """(scores [C, T], best candidate index per task, best score) —
        device-computed, bit-equal to host_reference_placement.
        Returns None when there are no candidate keys or no cell has a
        filter snapshot (no warmth signal: the scored path has nothing
        to add over least-loaded)."""
        t0 = time.perf_counter()
        filters = [c.filter for c in cells if c.filter is not None]
        if not cells or not filters:
            return None
        batch = prepare_probe_batch(keys_per_task)
        if batch is None:
            return None
        num_bits = filters[0].num_bits
        num_hashes = filters[0].num_hashes
        for f in filters[1:]:
            if (f.num_bits, f.num_hashes) != (num_bits, num_hashes):
                raise ValueError(
                    "placement filters must share geometry: "
                    f"({f.num_bits}, {f.num_hashes}) != "
                    f"({num_bits}, {num_hashes})")

        resident = [self._words(c.cell_id, c.filter)
                    if c.filter is not None else None for c in cells]
        # Held until the call returns: an install that replaces a
        # snapshot meanwhile cannot free words the kernel reads.
        words = [None if r is None else r[1] for r in resident]
        seeds = np.stack([seed_pair(c.filter.salt if c.filter is not None
                                    else 0) for c in cells])
        terms = np.stack(_candidate_arrays(cells))
        slot = self._slots.take()
        lay = cuda_bloom.placement_pack(
            slot, [0 if r is None else r[2] for r in resident], seeds,
            terms, batch.packed, batch.task_of_key, batch.counts,
            length=batch.length, num_bits=num_bits, num_hashes=num_hashes,
            warm_scale=WARM_SCALE, w_warm=W_WARM, w_load=W_LOAD,
            w_topo=W_TOPO)
        t1 = time.perf_counter()
        # The decision readback IS the call's product: [C*T + 2*T]
        # (scores, best cell, best score).  A call that raises drops its
        # slot.
        got = cuda_bloom.placement_call(slot, lay, words).copy()
        self._slots.give(slot)
        t2 = time.perf_counter()
        self.stage_timer.record("pack", t1 - t0)
        self.stage_timer.record("call", t2 - t1)
        c_n, t_n = lay.cells, lay.tasks
        return PlacementResult(got[:c_n * t_n].reshape(c_n, t_n),
                               got[c_n * t_n:c_n * t_n + t_n],
                               got[c_n * t_n + t_n:],
                               batch, device=True)
