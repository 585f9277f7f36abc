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
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..common.bloom import SaltedBloomFilter
from ..device import resolve_device
from ..ops import cuda_bloom
from ..ops.bloom_pipeline import as_device_words, seed_pair
from ..utils.stagetimer import StageTimer
# The host half (torch-free) lives in placement_host.py; every name of
# it stays importable from here.
from .placement_host import (BIG, W_LOAD, W_TOPO, W_WARM,  # noqa: F401
                             WARM_SCALE, CellCandidate, PlacementResult,
                             ProbeBatch, _candidate_arrays,
                             host_reference_placement, prepare_probe_batch,
                             quantize_utilization, reference_scores)


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
            torch.cuda.current_stream(self._device).synchronize()  # ytpu: allow(device-sync)  # once a filter snapshot: the upload lands before any stream's kernel reads it; cached per cell after
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
