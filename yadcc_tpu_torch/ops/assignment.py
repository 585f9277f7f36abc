"""Pool and batch layouts of the assignment kernels, the plain sequential
scan (`assign_batch`, kernel K2's twin), and the greedy oracle.

The servant registry travels as a struct of arrays (one slot per,
possibly departed, servant; `alive` masks vacancies so shapes never
change as daemons join and leave).  The layouts are the JAX package's:
the tests hand both packages the same numpy arrays.  One deviation, for
torch's sake: the environment bitmap is carried as an int32 BIT PATTERN
of the uint32 words (torch has few CPU ops on uint32); `(word >> bit) & 1`
reads the same bit under torch's arithmetic shift.

Policy semantics match yadcc/scheduler/task_dispatcher.cc:316-451
(eligibility: alive, has environment, version, not the requestor;
feasibility: running < capacity; preference: dedicated under 50%
utilization, then minimum utilization; deterministic lowest-slot
tie-break).  `greedy_assign_reference` is the oracle every other
implementation is judged against; `greedy_assign` is its fast host twin.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..models.cost import DEFAULT_COST_MODEL, UTIL_SCALE, DispatchCostModel

NO_PICK = -1  # Emitted for tasks that found no feasible servant.


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


# ---------------------------------------------------------------------------
# Greedy CPU oracle — the reference semantics, one request at a time.
# ---------------------------------------------------------------------------


def greedy_assign_reference(
    pool_np: dict,
    tasks: list,
    cost_model: DispatchCostModel = DEFAULT_COST_MODEL,
) -> list:
    """Pure-python re-statement of UnsafePickServantFor semantics
    (yadcc/scheduler/task_dispatcher.cc:362-451): THE oracle every other
    implementation (the device kernels and greedy_assign below) is
    judged against.  O(T*S) python iterations — readable, not fast;
    production host dispatch goes through greedy_assign.

    pool_np: dict of numpy arrays with PoolArrays' fields (uint32 bitmap).
    tasks: list of (env_id, min_version, requestor) tuples.
    Returns a list of servant slots (or NO_PICK), mutating running.
    """
    cm = cost_model
    alive = pool_np["alive"]
    capacity = pool_np["capacity"]
    running = pool_np["running"]
    dedicated = pool_np["dedicated"]
    version = pool_np["version"]
    env_bitmap = pool_np["env_bitmap"]
    s = len(alive)

    picks = []
    for env_id, min_version, requestor in tasks:
        word = env_bitmap[:, env_id >> 5]
        has_env = (word >> np.uint32(env_id & 31)) & 1
        best, best_score = NO_PICK, cm.infeasible_score_q
        for i in range(s):
            if not alive[i] or not has_env[i] or version[i] < min_version:
                continue
            if cm.avoid_self and i == requestor:
                continue
            if running[i] >= capacity[i]:
                continue
            util_q = int(running[i]) * UTIL_SCALE // max(int(capacity[i]), 1)
            score = (
                util_q - cm.preference_bonus_q
                if dedicated[i]
                and util_q < cm.dedicated_preference_utilization_q
                else util_q
            )
            if score < best_score:  # strict: lowest slot wins ties
                best, best_score = i, score
        picks.append(best)
        if best != NO_PICK:
            running[best] += 1
    return picks


def greedy_assign(
    pool_np: dict,
    tasks: list,
    cost_model: DispatchCostModel = DEFAULT_COST_MODEL,
) -> list:
    """Outcome-identical fast path for greedy_assign_reference.

    The reference loop is O(T*S) python iterations — ~6ms *per request*
    at a 8192-slot pool, which is the whole <2ms dispatch budget many
    times over.  Requests are instead grouped into runs of identical
    (env, min_version, requestor) descriptors (one build floods one
    env, so runs are long); each run builds its eligibility mask and
    score vector with O(S) numpy ops once, then resolves its n requests
    off a bounded min-heap of composite integer keys `score * S + slot`:

      * with slot < S the composite key orders exactly by (score, slot)
        — the reference's strict lowest-slot tie-break, for free, on
        plain int comparisons (no tuple allocation per candidate);
      * only the k smallest keys are materialized into the heap
        (np.partition, O(F)); the (k+1)-th smallest is kept as a
        boundary, and whenever the heap minimum rises past it the next
        k candidates are merged in — heapifying ALL ~F feasible slots
        cost more than the rest of the run combined;
      * each feasible slot has exactly one live heap entry, re-keyed
        when granted, dropped when its capacity fills — entries are
        never stale, so an in-boundary pop grants directly.

    Mutates `running` in place, like the reference.
    """
    import heapq

    cm = cost_model
    alive = pool_np["alive"]
    capacity = pool_np["capacity"]
    running = pool_np["running"]
    dedicated = pool_np["dedicated"]
    version = pool_np["version"]
    env_bitmap = pool_np["env_bitmap"]
    s = len(alive)

    bonus = cm.preference_bonus_q
    pref_util = cm.dedicated_preference_utilization_q

    def score_of(slot: int) -> int:
        # Python ints: exact at any UTIL_SCALE, like the reference loop.
        u = int(running[slot]) * UTIL_SCALE // max(int(capacity[slot]), 1)
        return u - bonus if dedicated[slot] and u < pref_util else u

    picks: list = []
    i = 0
    n_tasks = len(tasks)
    while i < n_tasks:
        env_id, min_version, requestor = tasks[i]
        j = i + 1
        while j < n_tasks and tasks[j] == tasks[i]:
            j += 1
        n = j - i
        i = j

        word = env_bitmap[:, env_id >> 5]
        has_env = (word >> np.uint32(env_id & 31)) & np.uint32(1)
        eligible = alive & (has_env == 1) & (version >= min_version)
        if cm.avoid_self and 0 <= requestor < s:
            eligible = eligible.copy()
            eligible[requestor] = False
        feasible = eligible & (running < capacity)
        cand = np.nonzero(feasible)[0]
        if cand.size == 0:
            picks.extend([NO_PICK] * n)
            continue

        # int64 vector math mirrors score_of exactly for the initial
        # keys (|score| < UTIL_SCALE + bonus, so score * S fits easily).
        run64 = running[cand].astype(np.int64)
        util_q = run64 * UTIL_SCALE // np.maximum(
            capacity[cand].astype(np.int64), 1)
        score = np.where(dedicated[cand] & (util_q < pref_util),
                         util_q - bonus, util_q)
        rest = score * s + cand
        k = min(n + 32, rest.size)
        heap: list = []
        boundary = None  # smallest key still outside the heap

        def refill():
            nonlocal rest, boundary
            if rest.size > k:
                rest = np.partition(rest, k)
                heap.extend(rest[:k].tolist())
                boundary = int(rest[k])
                rest = rest[k:]
            else:
                heap.extend(rest.tolist())
                boundary = None
                rest = rest[:0]
            heapq.heapify(heap)

        refill()
        granted = 0
        while granted < n:
            if not heap:
                if not rest.size:
                    break
                refill()
                continue
            key = heap[0]
            if boundary is not None and key > boundary:
                # The true minimum lives outside the heap: merge the
                # next tranche before granting.
                refill()
                continue
            slot = key % s
            picks.append(slot)
            running[slot] += 1
            granted += 1
            if running[slot] < capacity[slot]:
                heapq.heapreplace(heap, score_of(slot) * s + slot)
            else:
                heapq.heappop(heap)
        picks.extend([NO_PICK] * (n - granted))
    return picks
