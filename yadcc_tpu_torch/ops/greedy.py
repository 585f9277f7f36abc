"""The greedy host assignment: the oracle and its fast twin.

Torch-free, so the scheduler's host path (the greedy_cpu policy, the
dispatcher's bookkeeping, the rigs) loads no torch.  ``ops/assignment.py``
re-exports every name here.

Policy semantics match yadcc/scheduler/task_dispatcher.cc:316-451
(eligibility: alive, has environment, version, not the requestor;
feasibility: running < capacity; preference: dedicated under 50%
utilization, then minimum utilization; deterministic lowest-slot
tie-break).  `greedy_assign_reference` is the oracle every other
implementation is judged against; `greedy_assign` is its fast host twin.
"""

from __future__ import annotations

import numpy as np

from ..models.cost import DEFAULT_COST_MODEL, UTIL_SCALE, DispatchCostModel

NO_PICK = -1  # Emitted for tasks that found no feasible servant.


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
