"""Grouped assignment: parallel top-m selection per request group, in torch.

The plain PyTorch version of the grouped threshold search.  It is what
the CPU runs, and what the CUDA kernel (csrc/grouped_assign.cu, bound in
cuda_grouped.py) is held against on the card.

For a group of m identical requests, the sequential greedy outcome has
a closed form.  Each servant s contributes a STRICTLY INCREASING score
sequence score(s, r_s), score(s, r_s+1), ... (fixed-point utilization
rises with every grant; the dedicated-preference bonus can only be
LOST as utilization crosses the threshold, never gained).  Sequential
greedy = merging these sorted sequences and taking the m smallest
(score, slot) pairs.  Only the grant COUNT per servant is needed, which
a binary search over the integer score domain yields in
`_SEARCH_ITERS` O(S) steps:

    count_s(tau) = #{k : score(s, r_s + k) <= tau, k < avail_s}

is computable in closed form per servant, total(tau) is monotone, so
find the smallest tau with total(tau) >= m and split ties at tau by
lowest slot (the oracle's deterministic tie-break).

Groups run in order with `running` carried between them; per-task picks
inside a group are interchangeable by construction, so the contract is:
the resulting `running` and per-group grant counts match the sequential
oracle exactly.

Integer semantics: every division here FLOORS (torch `rounding_mode=
"floor"`), as jnp's `//` does; the numerators go negative whenever
tau < 0.  The closed form is evaluated in int64 so `(tau+1) * cap` cannot
overflow at the bottom of the search domain.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..models.cost import DEFAULT_COST_MODEL, UTIL_SCALE, DispatchCostModel
from .assignment import NO_PICK, PoolArrays, has_env_bits

# Score domain bounds for the binary search: scores are in
# [-preference_bonus_q, UTIL_SCALE + preference_bonus_q).
_SEARCH_ITERS = 22  # covers a 4M-wide integer domain


class GroupedBatch(NamedTuple):
    """Up to G request groups, host-sorted by descriptor."""

    env_id: torch.Tensor       # int32[G]
    min_version: torch.Tensor  # int32[G]
    requestor: torch.Tensor    # int32[G]
    count: torch.Tensor        # int32[G] — identical requests in the group


def _floor_div(a: torch.Tensor, b) -> torch.Tensor:
    return torch.div(a, b, rounding_mode="floor")


def make_count_leq(
    pool: PoolArrays,
    running: torch.Tensor,
    env_id,
    min_version,
    requestor,
    cm: DispatchCostModel,
):
    """Build the per-servant `count_leq(tau)` closure for one group
    (int64[S] grants per servant with score <= tau).  `requestor` is a
    slot index in this pool's numbering (-1: none)."""
    s = pool.alive.shape[0]
    slots = torch.arange(s, dtype=torch.int32, device=pool.alive.device)

    has_env = has_env_bits(pool.env_bitmap, env_id)
    eligible = pool.alive & (has_env == 1) & (pool.version >= min_version)
    if cm.avoid_self:
        eligible = eligible & (slots != requestor)
    cap = torch.clamp(pool.capacity, min=1).long()
    run = running.long()
    avail = torch.where(eligible,
                        torch.clamp(pool.capacity.long() - run, min=0),
                        torch.zeros_like(run))

    pref_thresh_q = int(cm.dedicated_preference_utilization_q)
    bonus_q = int(cm.preference_bonus_q)

    def ks_with_u_leq(x):
        # Largest k count with u(k) = (run+k)*U // cap <= x:
        # run+k <= ((x+1)*cap - 1) // U  (floor division).
        hi = _floor_div((x + 1) * cap - 1, UTIL_SCALE)
        return torch.minimum(torch.clamp(hi - run + 1, min=0), avail)

    # Group-invariant: how many leading grants stay in the preferred tier.
    pref_total = ks_with_u_leq(pref_thresh_q - 1)

    def count_leq(tau):
        """score(s, r+k) = u(k) - bonus if dedicated and u(k) < thresh
                           u(k)          otherwise."""
        plain = ks_with_u_leq(tau)
        pref_cap = ks_with_u_leq(
            torch.clamp(tau + bonus_q, max=pref_thresh_q - 1))
        plain_above = torch.clamp(plain - pref_total, min=0)
        ded = torch.minimum(pref_cap, pref_total) + plain_above
        return torch.where(pool.dedicated, ded, plain)

    return count_leq


def search_bounds(cm: DispatchCostModel) -> Tuple[int, int]:
    """Bisect bounds over the integer score domain: below every possible
    score, above every feasible score."""
    return -int(cm.preference_bonus_q) - 1, UTIL_SCALE + 1


def _group_counts(
    pool: PoolArrays,
    running: torch.Tensor,
    env_id,
    min_version,
    requestor,
    m: torch.Tensor,
    cm: DispatchCostModel,
) -> torch.Tensor:
    """int32[S]: grants per servant for one group of m identical
    requests, matching sequential greedy exactly.  The bisect state
    stays in 0-d device tensors, so a card never syncs inside it."""
    count_leq = make_count_leq(pool, running, env_id, min_version,
                               requestor, cm)
    dev = pool.alive.device
    lo0, hi0 = search_bounds(cm)
    lo = torch.tensor(lo0, dtype=torch.int64, device=dev)
    hi = torch.tensor(hi0, dtype=torch.int64, device=dev)
    m = m.long()
    for _ in range(_SEARCH_ITERS):
        mid = _floor_div(lo + hi, 2)
        enough = count_leq(mid).sum() >= m
        lo = torch.where(enough, lo, mid)
        hi = torch.where(enough, mid, hi)
    tau = hi  # smallest score with cumulative count >= m

    below = count_leq(tau - 1)        # strictly better than tau
    at = count_leq(tau) - below       # exactly at tau
    need_at = m - below.sum()         # how many tau-ties to accept
    # Lowest slots win ties (oracle tie-break): prefix-sum over slots.
    cum_before = torch.cumsum(at, 0) - at
    take_at = torch.minimum(torch.clamp(need_at - cum_before, min=0), at)
    # m may exceed total feasible grants; counts then sum to the max.
    return (below + take_at).to(torch.int32)


def assign_grouped(
    pool: PoolArrays,
    batch: GroupedBatch,
    cost_model: DispatchCostModel = DEFAULT_COST_MODEL,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(grant_counts int32[G, S], updated_running int32[S]).

    Loops over the (few) groups in order; each step is one fully
    parallel threshold search instead of `count` sequential argmins."""
    running = pool.running
    rows = []
    for g in range(batch.env_id.shape[0]):
        counts = _group_counts(pool, running, batch.env_id[g],
                               batch.min_version[g], batch.requestor[g],
                               batch.count[g], cost_model)
        running = running + counts
        rows.append(counts)
    if rows:
        counts = torch.stack(rows)
    else:
        counts = torch.zeros((0, pool.alive.shape[0]), dtype=torch.int32,
                             device=pool.alive.device)
    return counts, running.to(torch.int32)


def expand_counts(counts: torch.Tensor, sizes: torch.Tensor,
                  t_max: int) -> torch.Tensor:
    """Grant expansion: (G, S) per-servant counts -> flat per-request slot
    picks, int32[t_max].

    Position t belongs to group g(t) (groups laid out consecutively by
    `sizes`); within its group it takes the q-th grant, where grants
    enumerate slots ascending with multiplicity counts[g, s] — exactly
    the host-side `np.repeat(slot, counts)` expansion.  Entries past a
    group's granted total (infeasible remainder) and past the batch
    total are NO_PICK.  On the card this keeps the download at O(T)
    picks instead of the O(G*S) counts matrix."""
    g_n, _ = counts.shape
    dev = counts.device
    c = torch.cumsum(counts.long(), dim=1)             # [G, S] inclusive
    sizes = sizes.long()
    offs_incl = torch.cumsum(sizes, 0)                 # [G]
    offs_excl = offs_incl - sizes
    t_idx = torch.arange(t_max, dtype=torch.int64, device=dev)
    # Group of each flat position: how many group ends are <= t.
    g_t = (offs_incl[None, :] <= t_idx[:, None]).sum(1)
    in_batch = g_t < g_n
    g_tc = torch.clamp(g_t, 0, g_n - 1)
    q = t_idx - offs_excl[g_tc]                        # rank within group
    c_rows = c[g_tc]                                   # [t_max, S]
    pick = (c_rows <= q[:, None]).sum(1)
    granted = q < c_rows[:, -1]     # group may grant fewer than asked
    return torch.where(in_batch & granted, pick,
                       torch.full_like(pick, NO_PICK)).to(torch.int32)


def assign_grouped_picks(
    pool: PoolArrays,
    batch: GroupedBatch,
    t_max: int,
    cost_model: DispatchCostModel = DEFAULT_COST_MODEL,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Grouped assignment + expansion: int32[t_max] picks, running."""
    counts, running = assign_grouped(pool, batch, cost_model)
    return expand_counts(counts, batch.count, t_max), running


def task_pad(n: int, floor: int = 256) -> int:
    """Pad policy for the flat picks length (power of two, floored),
    mirroring group_pad: tight for common sizes, tiny shape set."""
    pad = floor
    while pad < n:
        pad *= 2
    return pad


def group_pad(n: int, floor: int = 4) -> int:
    """The production shape policy: pad the group count to the next
    power of two with a floor.  Padding groups (count 0) grant nothing,
    but each still costs a full threshold search, so padding stays tight
    for the common few-run batch."""
    pad = floor
    while pad < n:
        pad *= 2
    return pad


def make_grouped_packed_host(groups, pad_to: int) -> np.ndarray:
    """groups: [(env_id, min_version, requestor, count)] -> the [4, G]
    int32 descriptor block as a numpy array."""
    g = len(groups)
    if g > pad_to:
        raise ValueError(f"{g} groups do not fit a pad of {pad_to}")
    a = np.zeros((4, pad_to), np.int32)
    a[2, :] = -1               # requestor padding: "no self-avoid slot"
    if g:                      # count padding stays 0: grants nothing
        a[:, :g] = np.asarray(groups, np.int32).T
    return a


def make_grouped_packed(groups, pad_to: int,
                        device="cpu") -> torch.Tensor:
    """The [4, G] descriptor block on ``device``: ONE host-to-device
    transfer per launch."""
    return torch.from_numpy(make_grouped_packed_host(groups, pad_to)).to(
        device)


def unpack_grouped(packed: torch.Tensor) -> GroupedBatch:
    """[4, G] block -> GroupedBatch row views."""
    return GroupedBatch(
        env_id=packed[0],
        min_version=packed[1],
        requestor=packed[2],
        count=packed[3],
    )


def assign_grouped_picks_packed(
    pool: PoolArrays,
    packed: torch.Tensor,
    t_max: int,
    cost_model: DispatchCostModel = DEFAULT_COST_MODEL,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """assign_grouped_picks taking the packed [4, G] descriptor block."""
    return assign_grouped_picks(pool, unpack_grouped(packed), t_max,
                                cost_model)


def fold_stream_delta(running: torch.Tensor, adj: torch.Tensor,
                      reset_mask: torch.Tensor,
                      reset_val: torch.Tensor) -> torch.Tensor:
    """The host-correction fold for the pipelined running chain — one
    definition shared by the plain and kernel stream steps (their chained
    outputs must stay bit-identical)."""
    return torch.where(reset_mask, reset_val,
                       torch.clamp(running + adj, min=0)).to(torch.int32)


def assign_grouped_picks_stream(
    pool: PoolArrays,
    packed: torch.Tensor,
    adj: torch.Tensor,
    reset_mask: torch.Tensor,
    reset_val: torch.Tensor,
    t_max: int,
    cost_model: DispatchCostModel = DEFAULT_COST_MODEL,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One step of the PIPELINED dispatch stream.

    `pool.running` is the device-resident chained running array — the
    output of the previous stream step, never downloaded.  The host
    folds in everything it learned since the last launch:

    * `adj` int32[S]: signed corrections — task frees/expirations, and
      grants a drained cycle issued on device but the host REJECTED at
      apply time (stale slot, capacity re-check);
    * `reset_mask`/`reset_val`: slots whose device value is no longer
      trustworthy (servant died / slot recycled) are overwritten
      absolutely with the host-authoritative count.

    The invariant this maintains: device running = host authoritative
    running + grants issued by still-in-flight launches."""
    running = fold_stream_delta(pool.running, adj, reset_mask, reset_val)
    return assign_grouped_picks(pool._replace(running=running),
                                unpack_grouped(packed), t_max, cost_model)


def make_grouped_batch(groups, pad_to: int, device="cpu") -> GroupedBatch:
    """groups: [(env_id, min_version, requestor, count)], host-side; all
    four descriptor vectors ride one transfer."""
    return unpack_grouped(make_grouped_packed(groups, pad_to, device))


# ----------------------------------------------------------------------
# Device-resident pool: scatter-delta updates + the resident step.
#
# The stream step above still re-uploads capacity and the (epoch-cached)
# statics every launch.  The resident protocol keeps the WHOLE PoolArrays
# on the device across launches and streams only what changed: dirty-slot
# indices plus their replacement rows.  Running corrections keep riding
# the adj/reset fold (fold_stream_delta).
# ----------------------------------------------------------------------


class PoolDelta(NamedTuple):
    """One launch's scatter-delta for the device-resident pool.

    `idx` holds dirty slot indices; padding entries use idx == S (the
    pool size), which the scatter drops (NOT -1, which negative indexing
    would land on the last slot).  Values are the full replacement rows
    for each dirty slot; `running` has no row here — it is chained device
    state corrected via fold_stream_delta."""

    idx: torch.Tensor        # int32[D] dirty slots; == S marks padding
    alive: torch.Tensor      # int32[D] 0/1
    capacity: torch.Tensor   # int32[D] effective capacity
    dedicated: torch.Tensor  # int32[D] 0/1
    version: torch.Tensor    # int32[D]
    env_rows: torch.Tensor   # int32[D, E//32] uint32 words, bit pattern


def delta_pad(n: int, floor: int = 64) -> int:
    """Pad policy for the delta length: powers of two with a floor,
    mirroring group_pad/task_pad."""
    pad = floor
    while pad < n:
        pad *= 2
    return pad


def make_pool_delta(dirty_idx, snap_arrays: dict, pad_to: int,
                    pool_size: int, device="cpu") -> PoolDelta:
    """Host-side delta assembly: gather the dirty slots' current rows from
    the (host-authoritative) snapshot arrays and pad with the idx == S
    sentinel.  Each slot is sent at most once: a scatter with duplicate
    indices has no defined winner on the card."""
    idx = np.asarray(dirty_idx, np.int64)
    d = idx.shape[0]
    if d > pad_to:
        raise ValueError(f"{d} dirty slots do not fit a pad of {pad_to}")
    if np.unique(idx).shape[0] != d:
        raise ValueError("a delta sends each dirty slot at most once")
    pidx = np.full(pad_to, pool_size, np.int32)
    pidx[:d] = idx

    def up(a):
        return torch.from_numpy(a).to(device)

    def take(name):
        a = np.zeros(pad_to, np.int32)
        a[:d] = snap_arrays[name][idx]
        return up(a)

    env = np.zeros((pad_to, snap_arrays["env_bitmap"].shape[1]), np.uint32)
    env[:d] = snap_arrays["env_bitmap"][idx]
    return PoolDelta(
        idx=up(pidx),
        alive=take("alive"),
        capacity=take("capacity"),
        dedicated=take("dedicated"),
        version=take("version"),
        env_rows=up(env.view(np.int32)),
    )


def _scatter_rows(a: torch.Tensor, idx: torch.Tensor,
                  rows: torch.Tensor) -> torch.Tensor:
    """A copy of ``a`` with rows ``idx`` replaced by ``rows``.  Index
    len(a) marks padding: the copy carries one sink row past the end for
    it to land on, and the result is the view without that row — the
    `mode="drop"` of XLA's scatter, with no mask and so no sync with the
    card."""
    ext = torch.cat((a, a[:1]))
    ext[idx.long()] = rows.to(a.dtype)
    return ext[:-1]


def apply_pool_delta(pool: PoolArrays, delta: PoolDelta) -> PoolArrays:
    """Scatter the delta rows into the pool (running untouched); padding
    indices (== S) are dropped.  Functional: the input pool is not
    modified."""
    i = delta.idx
    if i.device.type == "cpu":
        real = i[i < pool.alive.shape[0]]
        if torch.unique(real).numel() != real.numel():
            raise ValueError("a delta sends each dirty slot at most once")
    return pool._replace(
        alive=_scatter_rows(pool.alive, i, delta.alive != 0),
        capacity=_scatter_rows(pool.capacity, i, delta.capacity),
        dedicated=_scatter_rows(pool.dedicated, i, delta.dedicated != 0),
        version=_scatter_rows(pool.version, i, delta.version),
        env_bitmap=_scatter_rows(pool.env_bitmap, i, delta.env_rows),
    )


def resident_grouped_step(
    pool: PoolArrays,
    delta: PoolDelta,
    packed: torch.Tensor,
    adj: torch.Tensor,
    reset_mask: torch.Tensor,
    reset_val: torch.Tensor,
    t_max: int,
    cost_model: DispatchCostModel = DEFAULT_COST_MODEL,
) -> Tuple[torch.Tensor, PoolArrays]:
    """The device-resident dispatch step: scatter the statics delta, fold
    the running corrections, run the grouped assignment (the device
    updates its own `running` from its own picks), and expand to flat
    picks.  Returns (picks int32[t_max], the advanced pool).

    Invariant (shared with assign_grouped_picks_stream): device running =
    host authoritative running + grants of in-flight launches; device
    statics = host statics as of the last delta."""
    counts, pool = resident_grouped_step_counts(
        pool, delta, packed, adj, reset_mask, reset_val, cost_model)
    return expand_counts(counts, packed[3], t_max), pool


def resident_grouped_step_counts(
    pool: PoolArrays,
    delta: PoolDelta,
    packed: torch.Tensor,
    adj: torch.Tensor,
    reset_mask: torch.Tensor,
    reset_val: torch.Tensor,
    cost_model: DispatchCostModel = DEFAULT_COST_MODEL,
) -> Tuple[torch.Tensor, PoolArrays]:
    """The counts twin of resident_grouped_step: the same scatter, fold
    and grouped assignment, returning the per-(group, slot) grant counts
    instead of the expanded picks (the host expands them for free)."""
    pool = apply_pool_delta(pool, delta)
    running = fold_stream_delta(pool.running, adj, reset_mask, reset_val)
    counts, running = assign_grouped(pool._replace(running=running),
                                     unpack_grouped(packed), cost_model)
    return counts, pool._replace(running=running)


def resident_control_plane_step(
    pool: PoolArrays,
    delta: PoolDelta,
    packed: torch.Tensor,
    adj: torch.Tensor,
    reset_mask: torch.Tensor,
    reset_val: torch.Tensor,
    t_max: int,
    cost_model: DispatchCostModel = DEFAULT_COST_MODEL,
    *,
    return_picks: bool = True,
) -> Tuple[torch.Tensor, PoolArrays]:
    """The sharded control plane's fused step, plain: N independent shard
    pools, each advanced by the resident step over its own view.  The
    counterpart of yadcc_tpu/parallel/mesh.py:
    resident_control_plane_step_fn, with its layout: the pool over
    [N*per]; ``delta`` stacked [N, D] (env_rows [N, D, E]) with shard-
    local slot numbers, idx == per marking padding; ``packed`` [N, 4, G];
    adj/reset_mask/reset_val [N*per].  Returns (picks int32[N, t_max], or
    counts int32[N, G, per] when ``return_picks`` is False, and the
    advanced pool).  Functional, like resident_grouped_step."""
    n = packed.shape[0]
    per = pool.alive.shape[0] // n
    outs, parts = [], []
    for k in range(n):
        view = slice(k * per, (k + 1) * per)
        args = (PoolArrays(*(a[view] for a in pool)),
                PoolDelta(*(a[k] for a in delta)), packed[k], adj[view],
                reset_mask[view], reset_val[view])
        if return_picks:
            out, shard = resident_grouped_step(*args, t_max, cost_model)
        else:
            out, shard = resident_grouped_step_counts(*args, cost_model)
        outs.append(out)
        parts.append(shard)
    return torch.stack(outs), PoolArrays(
        *(torch.cat(fields) for fields in zip(*parts)))


# ----------------------------------------------------------------------
# The grouped search over a team (parallel/mesh.py): the pool split into
# equal slices in linear order, slice k holding global slots
# [k*per, (k+1)*per).  The plain versions of K1's team mode
# (csrc/grouped_assign.cu), the counterparts of yadcc_tpu/parallel/
# mesh.py:_make_sharded_group_step, sharded_assign_grouped_fn and
# sharded_assign_grouped_picks_stream_fn.  Each cross-slice step is a
# plain sum over the slices here, where the kernel exchanges it.
# ----------------------------------------------------------------------

# A pick candidate no slice owns (the JAX body's `big`).
TEAM_NO_CANDIDATE = 2 ** 30


def _team_group_counts(pool: PoolArrays, n: int, running, env_id,
                       min_version, requestor, m: torch.Tensor,
                       cm: DispatchCostModel) -> torch.Tensor:
    """One group of m identical requests over a team of ``n`` slices
    laid one after another in ``pool``: the int32[S] grant counts.  Every
    bisect step sums each slice's count and then the slices' sums (the
    JAX body's psum), so every slice walks the same tau; the tau-ties go
    to the slices in linear order, each slice's share starting after the
    ties of the slices before it (the exclusive prefix of the slices'
    tie counts), then to its own slots in order."""
    count_leq = make_count_leq(pool, running, env_id, min_version,
                               requestor, cm)
    dev = pool.alive.device
    lo0, hi0 = search_bounds(cm)
    lo = torch.tensor(lo0, dtype=torch.int64, device=dev)
    hi = torch.tensor(hi0, dtype=torch.int64, device=dev)
    m = m.long()
    for _ in range(_SEARCH_ITERS):
        mid = _floor_div(lo + hi, 2)
        enough = count_leq(mid).view(n, -1).sum(1).sum() >= m
        lo = torch.where(enough, lo, mid)
        hi = torch.where(enough, mid, hi)
    tau = hi
    below = count_leq(tau - 1).view(n, -1)
    at = count_leq(tau).view(n, -1) - below
    need_at = m - below.sum(1).sum()
    slice_at = at.sum(1)
    slices_before = torch.cumsum(slice_at, 0) - slice_at
    cum_before = slices_before[:, None] + torch.cumsum(at, 1) - at
    take = torch.minimum(torch.clamp(need_at - cum_before, min=0), at)
    return (below + take).view(-1).to(torch.int32)


def assign_grouped_team(
    pool: PoolArrays,
    n: int,
    batch: GroupedBatch,
    cost_model: DispatchCostModel = DEFAULT_COST_MODEL,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(grant counts int32[G, S], running int32[S]): the grouped search
    over a team of ``n`` slices laid one after another in ``pool``,
    groups in order with `running` carried.  Equal to assign_grouped
    over the whole pool."""
    s = pool.alive.shape[0]
    if n < 1 or s % n:
        raise ValueError(f"{s} slots do not split into {n} slices")
    running = pool.running
    rows = []
    for g in range(batch.env_id.shape[0]):
        counts = _team_group_counts(pool, n, running, batch.env_id[g],
                                    batch.min_version[g],
                                    batch.requestor[g], batch.count[g],
                                    cost_model)
        running = running + counts
        rows.append(counts)
    if rows:
        counts = torch.stack(rows)
    else:
        counts = torch.zeros((0, s), dtype=torch.int32,
                             device=pool.alive.device)
    return counts, running.to(torch.int32)


def team_group_totals(counts: torch.Tensor, n: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int64[n, G] grants on the slices before each slice, int64[G] the
    team's grants) from the team's int32[G, S] counts: what K1's team
    mode writes beside its counts, from the tie split it exchanged."""
    local = counts.long().view(counts.shape[0], n, -1).sum(2).T
    return torch.cumsum(local, 0) - local, local.sum(0)


def expand_counts_slice(counts: torch.Tensor, prefix: torch.Tensor,
                        total: torch.Tensor, sizes: torch.Tensor,
                        t_max: int, base: int) -> torch.Tensor:
    """One slice's share of the grant expansion (the local twin of
    expand_counts, as the JAX stream body computes it): flat position t
    is the q-th grant of its group g; the slice whose grants of g cover
    rank q (after ``prefix[g]`` grants on the slices before it) answers
    base + its local slot, every other slice TEAM_NO_CANDIDATE.  A min
    over the slices merges the picks (merge_team_picks)."""
    g_n = counts.shape[0]
    dev = counts.device
    c_local = torch.cumsum(counts.long(), dim=1)       # [G, per]
    local_tot = c_local[:, -1]
    sizes = sizes.to(dev).long()
    offs_incl = torch.cumsum(sizes, 0)
    offs_excl = offs_incl - sizes
    t_idx = torch.arange(t_max, dtype=torch.int64, device=dev)
    g_t = (offs_incl[None, :] <= t_idx[:, None]).sum(1)
    in_batch = g_t < g_n
    g_tc = torch.clamp(g_t, 0, g_n - 1)
    q = t_idx - offs_excl[g_tc]
    q_local = q - prefix.to(dev).long()[g_tc]
    local_pick = (c_local[g_tc] <= q_local[:, None]).sum(1)
    mine = (q_local >= 0) & (q_local < local_tot[g_tc])
    granted = in_batch & (q < total.to(dev).long()[g_tc])
    return torch.where(granted & mine, base + local_pick,
                       torch.full_like(local_pick, TEAM_NO_CANDIDATE))


def merge_team_picks(candidates, device) -> torch.Tensor:
    """int32[t_max] picks from the slices' candidates: the min over the
    slices (the JAX body's pmin), NO_PICK where no slice answered."""
    cand = torch.stack([c.to(device) for c in candidates]).min(0).values
    return torch.where(cand == TEAM_NO_CANDIDATE,
                       torch.full_like(cand, NO_PICK), cand).to(torch.int32)


def assign_grouped_picks_stream_team(
    pool: PoolArrays,
    n: int,
    packed: torch.Tensor,
    adj: torch.Tensor,
    reset_mask: torch.Tensor,
    reset_val: torch.Tensor,
    t_max: int,
    cost_model: DispatchCostModel = DEFAULT_COST_MODEL,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One pipelined stream step over a team of ``n`` slices laid one
    after another in ``pool``: the host delta folded (elementwise, each
    slice its own share), the grouped search over the team, each slice's
    share of the expansion, and a min over the slices merging the picks.
    Returns (picks int32[t_max], running int32[S]), equal to
    assign_grouped_picks_stream over the whole pool."""
    running = fold_stream_delta(pool.running, adj, reset_mask, reset_val)
    batch = unpack_grouped(packed)
    counts, running = assign_grouped_team(pool._replace(running=running), n,
                                          batch, cost_model)
    prefix, total = team_group_totals(counts, n)
    per = pool.alive.shape[0] // n
    cands = [expand_counts_slice(counts[:, k * per:(k + 1) * per],
                                 prefix[k], total, batch.count, t_max,
                                 k * per) for k in range(n)]
    return merge_team_picks(cands, pool.alive.device), running
