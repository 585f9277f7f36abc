"""One-card counterparts of the sharded control plane's device functions
(yadcc_tpu/parallel/mesh.py:562-784).

The JAX package lays an N-shard control plane over a device mesh, one
shard slice a device.  On one H100 every shard slice lives on the same
card: the servant pool is ONE logical array laid out by the
partitioned_shard_bounds ceil-split, shard k owning slots
[k*per, (k+1)*per), and the per-shard work that shard_map spread over
devices runs over an [N, per] view instead — a torch reduction for the
load summary, and K1 over a grid of N blocks for the fused step.

The mesh's sharded scan and grouped search (mesh.py:131, 257, 304)
reduce on one card to the unsharded policies, torch_batched and
torch_grouped, whose outcomes they equal by construction.
"""

from __future__ import annotations

from typing import Tuple

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
