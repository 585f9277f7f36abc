"""Pool and batch layouts of the assignment kernels and the plain
sequential scan (`assign_batch`, kernel K2's twin); the greedy oracle
lives in ops/greedy.py, torch-free, and is re-exported here.

The servant registry travels as a struct of arrays (one slot per,
possibly departed, servant; `alive` masks vacancies so shapes never
change as daemons join and leave).  The layouts are the JAX package's:
the tests hand both packages the same numpy arrays.  One deviation, for
torch's sake: the environment bitmap is carried as an int32 BIT PATTERN
of the uint32 words (torch has few CPU ops on uint32); `(word >> bit) & 1`
reads the same bit under torch's arithmetic shift.

Policy semantics are ops/greedy.py's (the reference's
yadcc/scheduler/task_dispatcher.cc:316-451).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..models.cost import DEFAULT_COST_MODEL, UTIL_SCALE, DispatchCostModel

# The host half lives in ops/greedy.py (torch-free); its names stay
# importable from here.
from .greedy import (NO_PICK, greedy_assign,  # noqa: F401
                     greedy_assign_reference)


class PoolArrays(NamedTuple):
    """Struct-of-arrays servant registry snapshot, as torch tensors."""

    alive: torch.Tensor       # bool[S]
    capacity: torch.Tensor    # int32[S]  max concurrent tasks (0: not accepting)
    running: torch.Tensor     # int32[S]  currently granted tasks
    dedicated: torch.Tensor   # bool[S]   SERVANT_PRIORITY_DEDICATED
    version: torch.Tensor     # int32[S]
    env_bitmap: torch.Tensor  # int32[S, E//32]  uint32 membership words, bit pattern


class TaskBatch(NamedTuple):
    """A padded micro-batch of grant requests."""

    env_id: torch.Tensor       # int32[T] interned environment index
    min_version: torch.Tensor  # int32[T]
    requestor: torch.Tensor    # int32[T] requestor's servant slot, -1 if none
    valid: torch.Tensor        # bool[T]  padding mask


def pool_from_numpy(alive, capacity, running, dedicated, version,
                    env_bitmap, device) -> PoolArrays:
    """Host arrays (JAX package layouts, uint32 bitmap) -> PoolArrays on
    ``device`` (the bitmap as its int32 bit pattern)."""
    def up(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(device)

    return PoolArrays(
        alive=up(alive, np.bool_),
        capacity=up(capacity, np.int32),
        running=up(running, np.int32),
        dedicated=up(dedicated, np.bool_),
        version=up(version, np.int32),
        env_bitmap=up(np.ascontiguousarray(env_bitmap, np.uint32).view(
            np.int32), np.int32),
    )


def has_env_bits(env_bitmap: torch.Tensor, env_id) -> torch.Tensor:
    """int32[S] 0/1: bit `env_id` of each slot's bitmap row, read as the
    JAX device functions read it (`jnp.take`, fill mode): a word index in
    [-E, 0) wraps to word + E, and one outside [-E, E) reads 0xFFFFFFFF,
    so every slot has that environment.  No host sync: the index stays a
    tensor."""
    env = torch.as_tensor(env_id, dtype=torch.int32, device=env_bitmap.device)
    e = env_bitmap.shape[1]
    word_idx = env >> 5
    col = (word_idx % e).reshape(1).long()     # word + E for [-E, 0)
    word = torch.where((word_idx >= -e) & (word_idx < e),
                       env_bitmap.index_select(1, col)[:, 0], -1)
    return (word >> (env & 31)) & 1


def _scores(
    pool: PoolArrays,
    running: torch.Tensor,
    env_id,
    min_version,
    requestor,
    cm: DispatchCostModel,
) -> torch.Tensor:
    """Per-servant score for one task; lower is better, infeasible is huge
    (int64[S])."""
    s = pool.alive.shape[0]
    slots = torch.arange(s, dtype=torch.int32, device=pool.alive.device)

    has_env = has_env_bits(pool.env_bitmap, env_id)

    eligible = pool.alive & (has_env == 1) & (pool.version >= min_version)
    if cm.avoid_self:
        eligible = eligible & (slots != requestor)
    feasible = eligible & (running < pool.capacity)

    # Fixed-point utilization: exact, backend-independent (see
    # models/cost.py for why float division is not usable here).
    util_q = torch.div(running.long() * UTIL_SCALE,
                       torch.clamp(pool.capacity, min=1).long(),
                       rounding_mode="floor")
    preferred = pool.dedicated & (
        util_q < cm.dedicated_preference_utilization_q)
    score = torch.where(preferred, util_q - cm.preference_bonus_q, util_q)
    return torch.where(feasible, score,
                       torch.full_like(score, cm.infeasible_score_q))


def assign_batch(
    pool: PoolArrays,
    batch: TaskBatch,
    cost_model: DispatchCostModel = DEFAULT_COST_MODEL,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Assign every task in the batch a servant slot (or NO_PICK), in
    order, consuming capacity as it goes: (picks int32[T], running
    int32[S]).

    The plain version of the sequential scan (kernel K2, csrc/
    assign_batch.cu): the exact greedy contract every other policy is
    held to.  The pick is the lowest slot at the minimum score — the
    argmin of the unique int64 key score*S + slot, as greedy_assign
    orders its heap — granted only when that score is feasible and the
    task is not padding.  State stays in device tensors, so a card never
    syncs inside the loop."""
    cm = cost_model
    s = pool.alive.shape[0]
    dev = pool.alive.device
    slots = torch.arange(s, dtype=torch.int64, device=dev)
    running = pool.running.to(torch.int32)
    picks = []
    for t in range(batch.env_id.shape[0]):
        score = _scores(pool, running, batch.env_id[t],
                        batch.min_version[t], batch.requestor[t], cm)
        pick = torch.argmin(score * s + slots)
        granted = (score[pick] < cm.infeasible_score_q) & batch.valid[t]
        running = running.index_add(0, pick.reshape(1),
                                    granted.reshape(1).to(torch.int32))
        picks.append(torch.where(granted, pick, NO_PICK))
    if not picks:
        return torch.zeros(0, dtype=torch.int32, device=dev), running
    return torch.stack(picks).to(torch.int32), running


def make_batch(env_ids, min_versions, requestors, pad_to: int,
               device="cpu") -> TaskBatch:
    """A python request list padded to ``pad_to`` tasks on ``device``;
    padding rows are env 0, requestor -1 and valid False (inert)."""
    n = len(env_ids)
    if n > pad_to:
        raise ValueError(f"{n} tasks do not fit a pad of {pad_to}")

    def pad(xs, fill):
        a = np.full(pad_to, fill, np.int32)
        a[:n] = np.asarray(xs, np.int32)
        return torch.from_numpy(a).to(device)

    valid = np.zeros(pad_to, bool)
    valid[:n] = True
    return TaskBatch(
        env_id=pad(env_ids, 0),
        min_version=pad(min_versions, 0),
        requestor=pad(requestors, -1),
        valid=torch.from_numpy(valid).to(device),
    )


def assign_batch_team(
    pool: PoolArrays,
    n: int,
    batch: TaskBatch,
    cost_model: DispatchCostModel = DEFAULT_COST_MODEL,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The sequential scan over a team of ``n`` slices: the plain version
    of K2's team mode (csrc/assign_batch.cu), the counterpart of
    yadcc_tpu/parallel/mesh.py:sharded_assign_fn.

    ``pool`` holds the team's slices one after another in linear order
    (slice k: global slots [k*per, (k+1)*per)).  For each task each slice
    takes its least key score*S + global slot over its own slots (S the
    whole pool), the slices agree on the least of those keys (the
    exchange: a min over the slices'), and only the slice owning the
    winning slot adds the grant to its `running`.  The key orders by
    (score, global slot), so the winner is the lowest global slot at the
    minimum score: picks and running equal assign_batch over the whole
    pool.  Returns (picks int32[T], running int32[S])."""
    cm = cost_model
    s = pool.alive.shape[0]
    if n < 1 or s % n:
        raise ValueError(f"{s} slots do not split into {n} slices")
    dev = pool.alive.device
    slots = torch.arange(s, dtype=torch.int64, device=dev)
    running = pool.running.to(torch.int32)
    picks = []
    for t in range(batch.env_id.shape[0]):
        score = _scores(pool, running, batch.env_id[t],
                        batch.min_version[t], batch.requestor[t], cm)
        slice_keys = (score * s + slots).view(n, -1).min(1).values
        key = slice_keys.min()
        score = torch.div(key, s, rounding_mode="floor")
        slot = key - score * s
        granted = (score < cm.infeasible_score_q) & batch.valid[t]
        running = running.index_add(0, slot.reshape(1),
                                    granted.reshape(1).to(torch.int32))
        picks.append(torch.where(granted, slot, NO_PICK))
    if not picks:
        return torch.zeros(0, dtype=torch.int32, device=dev), running
    return torch.stack(picks).to(torch.int32), running
