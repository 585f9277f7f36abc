"""Scored spill placement's host half: the score terms, the candidate
and result types, and the host parity oracle (placement.py has the
arithmetic in full).

Torch-free, so a federation router on the host path (the rigs on
greedy_cpu, a router with no scorer device) loads no torch;
``placement.py`` re-exports every name and adds the device scorer.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..common.bloom import SaltedBloomFilter
from ..ops.bloom_pack import pack_key_buckets

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
               else np.asarray(idxs))  # ytpu: allow(device-sync)  # host index list
    owner_arr = np.asarray(owner, np.int32)  # ytpu: allow(device-sync)  # host list
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
    hits = np.asarray(hits, np.int32)  # ytpu: allow(device-sync)  # host oracle input
    counts = np.asarray(counts, np.int32)  # ytpu: allow(device-sync)  # host oracle input
    denom = np.maximum(counts, 1)[None, :]
    miss_q = ((counts[None, :] - hits) * np.int32(WARM_SCALE)) // denom
    miss_q = np.where(np.asarray(has_filter)[:, None] > 0,  # ytpu: allow(device-sync)  # host oracle input
                      miss_q, np.int32(WARM_SCALE))
    score = (np.int32(w_warm) * miss_q
             + (np.int32(w_load) * np.asarray(util_q, np.int32)  # ytpu: allow(device-sync)  # host oracle input
                + np.int32(w_topo) * np.asarray(topo_q, np.int32))  # ytpu: allow(device-sync)  # host oracle input
             [:, None]).astype(np.int32)
    score = np.where(np.asarray(eligible)[:, None] > 0,  # ytpu: allow(device-sync)  # host oracle input
                     score, np.int32(BIG))
    best_cell = np.argmin(score, axis=0).astype(np.int32)
    best_score = score[best_cell, np.arange(score.shape[1])]
    return score, best_cell, best_score


def _candidate_arrays(cells: Sequence[CellCandidate]
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                 np.ndarray]:
    util_q = np.asarray([quantize_utilization(c.utilization)  # ytpu: allow(device-sync)  # host list
                         for c in cells], np.int32)
    topo_q = np.asarray([int(c.topo_distance) for c in cells], np.int32)  # ytpu: allow(device-sync)  # host list
    eligible = np.asarray([1 if c.eligible else 0 for c in cells],  # ytpu: allow(device-sync)  # host list
                          np.int32)
    has_filter = np.asarray([1 if c.filter is not None else 0  # ytpu: allow(device-sync)  # host list
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
