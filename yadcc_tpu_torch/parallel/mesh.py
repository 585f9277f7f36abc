"""The team: the counterpart of yadcc_tpu/parallel/mesh.py's device mesh,
and of the sharded control plane's device functions.

A TEAM is an explicit tuple of torch devices, one a slice, in linear
order; a card may repeat in it.  The servant pool is ONE logical array
split into equal slices: slice k owns global slots [k*per, (k+1)*per)
(the JAX mesh's device_linear_index layout, and the port's control-plane
layout).  On the card, a team launch of K1 or K2 (or of the Bloom
kernels in their filter-sharded mode) is one launch a card, each block a
slice of that card, and the slices agree on every cross-slice step
through an exchange buffer in mapped pinned host memory
(ops/team_exchange.py): the same code and the same exchange on one card
as on several.  The pool lies on each card as a PART: the concatenation
of that card's slices in linear order (on one card, the whole pool).  On
the CPU a team is ["cpu"] * n and only the plain versions run.

The JAX sharded functions and the port's team entry points:
  sharded_assign_fn                       -> sharded_assign (K2)
  sharded_assign_grouped_fn               -> sharded_assign_grouped (K1)
  sharded_assign_grouped_picks_stream_fn  -> sharded_assign_grouped_picks_stream
  sharded_bloom_membership_fn             -> sharded_bloom_membership
  sharded_bloom_cascade_fn                -> sharded_bloom_cascade
  sharded_bloom_probe_fn                  -> sharded_bloom_probe (keys split)

The control plane of N scheduler shards (mesh.py:562-784) lays every
shard on one card: the per-shard work that shard_map spread over devices
runs over an [N, per] view instead -- a torch reduction for the load
summary (or one a shard on its team device, shard_router.py), and K1
over a grid of N blocks for the fused step.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

# The fused step's one-card counterpart of resident_control_plane_step_fn
# (mesh.py:591): the plain loop on the CPU, K1 over a grid of shards on
# the card (see its docstring for the layout).
from ..ops.cuda_grouped import (  # noqa: F401
    cuda_resident_control_plane_step as resident_control_plane_step)
from ..ops.bloom_probe import partitioned_shard_bounds
# The one-card counterpart of placement_score_fn (mesh.py:698), the cells x
# tasks spill-placement score: its plain version on the CPU, the
# hand-written kernel of csrc/bloom.cu on the card.  The JAX function shards
# the cell axis over the mesh and reduces the argmin with a pmin per axis;
# on one card every cell is a block of one launch and a second launch takes
# the argmin.
from ..ops.cuda_bloom import placement_score  # noqa: F401


def control_plane_shard_slices(
        total_slots: int, n_shards: int) -> Tuple[Tuple[int, int], ...]:
    """Slot ranges ((lo, hi), ...) per scheduler shard — the
    partitioned_shard_bounds ceil-split layout applied to the servant
    axis (32 "bits" per slot makes its word math the identity)."""
    bounds = partitioned_shard_bounds(total_slots * 32, n_shards)
    return tuple((bounds[k], bounds[k + 1]) for k in range(n_shards))


def shard_load_summary(alive: torch.Tensor, capacity: torch.Tensor,
                       running: torch.Tensor,
                       n_shards: int) -> torch.Tensor:
    """int32[n_shards, 3] rows of (alive servants, free capacity, running
    total) from the concatenated (alive bool, effective capacity int32,
    running int32) pool vectors, one equal slice a shard — the
    counterpart of shard_load_summary_fn (mesh.py:667).  A plain torch
    reduction over the [N, per] view, on the tensors' device: it runs
    from the expiration sweep, not the dispatch cycle, and returns 12
    bytes a shard, so it has no hand-written kernel."""
    a = alive.view(n_shards, -1)
    c = capacity.view(n_shards, -1)
    r = running.view(n_shards, -1)
    free = torch.clamp(c - r, min=0)
    zero = torch.zeros_like(r)
    return torch.stack([
        a.sum(1),
        torch.where(a, free, zero).sum(1),
        torch.where(a, r, zero).sum(1),
    ], dim=1).to(torch.int32)


# ----------------------------------------------------------------------
# The team.
# ----------------------------------------------------------------------

Team = Tuple[torch.device, ...]


def make_team(n: Optional[int] = None, device="cuda") -> Team:
    """The counterpart of make_mesh: the first ``n`` cards, or every
    card, one slice each.  A team of more slices than the host has
    cards cycles over them (a card may repeat).  On the CPU a team is
    ``n`` slices (default 1) on the CPU.  No card raises, unless the
    CPU was asked for."""
    from ..device import resolve_device

    dev = resolve_device(str(device))
    if dev.type == "cpu":
        n = 1 if n is None else n
        if n < 1:
            raise ValueError(f"a team needs at least one slice, got {n}")
        return (dev,) * n
    count = torch.cuda.device_count()
    n = count if n is None else n
    if n < 1:
        raise ValueError(f"a team needs at least one slice, got {n}")
    return tuple(torch.device("cuda", k % count) for k in range(n))


def as_team(team: Sequence) -> Team:
    out = tuple(torch.device(d) for d in team)
    if not out:
        raise ValueError("a team needs at least one slice")
    return out


def team_parts(team: Sequence) -> Tuple[Tuple[torch.device,
                                              Tuple[int, ...]], ...]:
    """(card, its slices in linear order) for each distinct device of
    the team, in order of first appearance: one launch a part."""
    order, ids = [], {}
    for k, d in enumerate(as_team(team)):
        key = str(d)
        if key not in ids:
            ids[key] = (d, [])
            order.append(key)
        ids[key][1].append(k)
    return tuple((ids[key][0], tuple(ids[key][1])) for key in order)


def device_linear_index(team: Sequence, k: int) -> int:
    """Slice k's linear index: its place in the team (the JAX mesh's
    row-major device index).  Slice k owns global slots
    [k*per, (k+1)*per)."""
    if not 0 <= k < len(team):
        raise IndexError(f"slice {k} outside a team of {len(team)}")
    return k


def slice_size(total: int, team: Sequence) -> int:
    """Slots a slice; a pool that does not divide evenly raises with
    the JAX policies' message."""
    n = len(team)
    if total % n:
        raise ValueError(f"pool size {total} must divide evenly over {n} "
                         f"devices (pad max_servants)")
    return total // n


class TeamPool(NamedTuple):
    """A pool laid over a team: ``parts[i]`` is the PoolArrays of
    ``team_parts(team)[i]``'s card, its slices concatenated in linear
    order, ``per`` slots each."""

    team: Team
    per: int
    parts: Tuple  # of PoolArrays


def shard_vector(v: torch.Tensor, team: Sequence,
                 per: Optional[int] = None) -> Tuple[torch.Tensor, ...]:
    """A pool-axis tensor (leading axis = slots) laid over the team: one
    contiguous tensor a part, on its card."""
    team = as_team(team)
    per = slice_size(v.shape[0], team) if per is None else per
    out = []
    for dev, ids in team_parts(team):
        if ids == tuple(range(ids[0], ids[0] + len(ids))):
            piece = v[ids[0] * per:(ids[-1] + 1) * per]
        else:
            piece = torch.cat([v[k * per:(k + 1) * per] for k in ids])
        out.append(piece.to(dev).contiguous())
    return tuple(out)


def unshard_vector(parts: Sequence[torch.Tensor], team: Sequence,
                   per: int, device=None) -> torch.Tensor:
    """The inverse of shard_vector, on ``device`` (default: slice 0's),
    along the leading (slot) axis."""
    team = as_team(team)
    device = team[0] if device is None else torch.device(device)
    pieces = [None] * len(team)
    for (_, ids), part in zip(team_parts(team), parts):
        for j, k in enumerate(ids):
            pieces[k] = part[j * per:(j + 1) * per].to(device)
    return torch.cat(pieces)


def pool_sharding(team: Sequence) -> Tuple[Tuple[torch.device,
                                                 Tuple[int, ...]], ...]:
    """Where each slice of a pool lives: the counterpart of the JAX
    NamedShardings (the servant axis split over the whole team)."""
    return team_parts(team)


def shard_pool(pool, team: Sequence) -> TeamPool:
    """A PoolArrays (on any device) laid over the team."""
    team = as_team(team)
    per = slice_size(pool.alive.shape[0], team)
    fields = [shard_vector(a, team, per) for a in pool]
    return TeamPool(team, per, tuple(
        type(pool)(*(f[i] for f in fields))
        for i in range(len(team_parts(team)))))


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def bloom_words_padded(words: np.ndarray, team: Sequence,
                       num_bits: int) -> np.ndarray:
    """Filter words zero-padded to the team's slices: the
    partitioned_shard_bounds layout gives each slice ceil(W / n) words.
    The pad holds no set bit and no probe reaches it."""
    n = len(team)
    bounds = partitioned_shard_bounds(num_bits, n)
    per = bounds[1] - bounds[0]
    return np.pad(words, (0, n * per - words.shape[0]))


def shard_pool_loads(team: Sequence, alive, capacity, running):
    """The concatenated control-plane load vectors, one shard slice on
    each team device (the counterpart of mesh.py:shard_pool_loads)."""
    return tuple(shard_vector(torch.as_tensor(np.asarray(a)), team)
                 for a in (alive, capacity, running))


# ----------------------------------------------------------------------
# The team entry points.  K1 and K2 in their team modes (one launch a
# card, the slices agreeing through the exchange): the CPU team takes
# their plain versions.
# ----------------------------------------------------------------------

from ..ops.cuda_assign import (  # noqa: E402,F401
    cuda_assign_batch_team as sharded_assign)
from ..ops.cuda_grouped import (  # noqa: E402,F401
    cuda_assign_grouped_picks_stream_team as
    sharded_assign_grouped_picks_stream,
    cuda_assign_grouped_team as sharded_assign_grouped)


def unshard_counts(counts_parts, tpool: TeamPool) -> torch.Tensor:
    """int32[G, S] on slice 0's device from a K1 team call's counts (one
    [n_b, G, per] tensor a part): the JAX function's [G, S] layout."""
    rows = [None] * len(tpool.team)
    dev = tpool.team[0]
    for (_, ids), part in zip(team_parts(tpool.team), counts_parts):
        for j, k in enumerate(ids):
            rows[k] = part[j].to(dev)
    return torch.cat(rows, dim=1)


def shard_bloom_words(words: np.ndarray, team: Sequence,
                      num_bits: int) -> Tuple[torch.Tensor, ...]:
    """A filter's uint32 words padded (bloom_words_padded) and laid over
    the team: one int32 tensor (the bit pattern) a part, each holding its
    slices' words in linear order."""
    from ..ops.bloom_pipeline import as_device_words

    padded = as_device_words(bloom_words_padded(words, team, num_bits),
                             "cpu")
    return shard_vector(padded, team)


def _bloom_slices(team, parts, num_bits):
    """(slice id, its device, its words) over the team's parts."""
    per = partitioned_shard_bounds(num_bits, len(team))[1]
    for (dev, ids), part in zip(team_parts(team), parts):
        for j, k in enumerate(ids):
            yield k, dev, part[j * per:(j + 1) * per], k * per


def sharded_bloom_membership(words_parts, packed_keys: torch.Tensor,
                             length: int, seed, *, num_bits: int,
                             num_hashes: int,
                             team: Sequence) -> torch.Tensor:
    """bool[N] on slice 0's device: the FILTER-sharded membership, the
    counterpart of yadcc_tpu/parallel/mesh.py:sharded_bloom_membership_fn.
    Each slice judges the probes that land in its words (one launch of
    the range kernel a slice, csrc/bloom.cu; the plain version on the
    CPU) and the slices' verdicts are ANDed.  ``words_parts`` from
    shard_bloom_words; ``packed_keys`` replicated to every card.  A
    one-slice team holds the whole filter: the one-card kernel."""
    from ..ops.cuda_bloom import bloom_membership, bloom_membership_range

    team = as_team(team)
    if len(team) == 1:
        return bloom_membership(words_parts[0], packed_keys.to(team[0]),
                                length, seed, num_bits=num_bits,
                                num_hashes=num_hashes)
    verdicts = []
    for k, dev, words, lo in _bloom_slices(team, words_parts, num_bits):
        verdicts.append(bloom_membership_range(
            words, packed_keys.to(dev), length, seed, num_bits=num_bits,
            num_hashes=num_hashes, word_lo=lo).to(team[0]))
    return torch.stack(verdicts).all(0)


def sharded_bloom_cascade(region_parts, fleet_parts,
                          packed_keys: torch.Tensor, length: int,
                          region_seed, fleet_seed, *, num_bits: int,
                          num_hashes_region: int, num_hashes_fleet: int,
                          team: Sequence) -> torch.Tensor:
    """bool[N] on slice 0's device: the filter-sharded region-OR-fleet
    cascade, the counterpart of sharded_bloom_cascade_fn.  Each slice
    writes a code a key (bit 0 its region verdict, bit 1 its fleet
    verdict); the codes are ANDed over the slices, finishing each
    filter's AND, and only then the two bits are ORed.  A one-slice
    team: the one-card cascade."""
    from ..ops.cuda_bloom import bloom_cascade, bloom_cascade_pair

    team = as_team(team)
    if len(team) == 1:
        return bloom_cascade(
            region_parts[0], fleet_parts[0], packed_keys.to(team[0]),
            length, region_seed, fleet_seed, num_bits=num_bits,
            num_hashes_region=num_hashes_region,
            num_hashes_fleet=num_hashes_fleet)
    code = None
    for (k, dev, rw, lo), (_, _, fw, _) in zip(
            _bloom_slices(team, region_parts, num_bits),
            _bloom_slices(team, fleet_parts, num_bits)):
        c = bloom_cascade_pair(
            rw, fw, packed_keys.to(dev), length, region_seed, fleet_seed,
            num_bits=num_bits, num_hashes_region=num_hashes_region,
            num_hashes_fleet=num_hashes_fleet, word_lo=lo).to(team[0])
        code = c if code is None else code & c
    return code != 0


def sharded_bloom_probe(words: torch.Tensor, fingerprints: torch.Tensor,
                        *, num_bits: int, num_hashes: int,
                        team: Sequence) -> torch.Tensor:
    """bool[N] on slice 0's device: the KEY-sharded probe, the
    counterpart of sharded_bloom_probe_fn.  The fingerprints split into
    the team's slices in order, each slice probes its share against the
    whole filter (replicated to its card) with the probe kernel, and the
    verdicts are concatenated: no collective."""
    from ..ops.cuda_bloom import bloom_probe

    team = as_team(team)
    out = []
    for dev, chunk in zip(team, torch.tensor_split(fingerprints,
                                                   len(team))):
        out.append(bloom_probe(words.to(dev), chunk.to(dev),
                               num_bits=num_bits,
                               num_hashes=num_hashes).to(team[0]))
    return torch.cat(out)
