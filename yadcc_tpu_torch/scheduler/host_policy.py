"""DispatchPolicy SPI, its host types and the greedy CPU oracle.

The scheduler's host code (task_dispatcher.py) owns all bookkeeping —
leases, zombies, wakeups.  Worker *selection* is delegated to a policy
behind this SPI.  Every policy consumes the same snapshot format and
produces identical picks for identical inputs, so flipping
--dispatch-policy can never change scheduling semantics, only
throughput.

This module loads no torch: a scheduler on greedy_cpu (and the rigs
that build one) runs without it.  ``make_policy`` imports the device
policies (policy.py) only when it builds one.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..models.cost import DEFAULT_COST_MODEL, DispatchCostModel
from ..ops import greedy


class EnvRegistry:
    """Interns environment digests to dense ids for the bitmap axis."""

    def __init__(self, max_envs: int = 256):
        self.max_envs = max_envs
        self._ids: Dict[str, int] = {}  # guarded by: self._lock
        self._lock = threading.Lock()

    def intern(self, digest: str) -> Optional[int]:
        with self._lock:
            i = self._ids.get(digest)
            if i is not None:
                return i
            if len(self._ids) >= self.max_envs:
                # Env table full: extremely unlikely (256 distinct compiler
                # binaries live at once); refuse rather than evict, since
                # ids are baked into servant bitmaps.
                return None
            i = len(self._ids)
            self._ids[digest] = i
            return i

    def lookup(self, digest: str) -> Optional[int]:
        with self._lock:
            return self._ids.get(digest)

    def __len__(self) -> int:
        with self._lock:
            return len(self._ids)


@dataclass
class PoolSnapshot:
    """Host-side struct-of-arrays view of the servant registry, produced
    under the dispatcher lock and handed to a policy."""

    alive: np.ndarray       # bool[S]
    capacity: np.ndarray    # int32[S] effective capacity (lease/memory/NAT
    running: np.ndarray     # int32[S]  already folded in by the dispatcher)
    dedicated: np.ndarray   # bool[S]
    version: np.ndarray     # int32[S]
    env_bitmap: np.ndarray  # uint32[S, E//32]
    # Bumped by the dispatcher whenever heartbeat-derived state changes;
    # device policies keep alive/dedicated/version/env_bitmap resident
    # on device across cycles with an unchanged epoch and re-upload only
    # the per-cycle capacity/running vectors.  < 0 = not cacheable
    # (snapshots built directly by tests).
    epoch: int = -1


@dataclass
class AssignRequest:
    env_id: int
    min_version: int
    requestor_slot: int  # -1 when the requestor is not a servant


class DispatchPolicy:
    """SPI: pick a servant slot for each request, consuming capacity in
    request order.  Returns a slot per request or greedy.NO_PICK."""

    name = "abstract"
    # True when the policy implements the stream_* API (pipelined
    # dispatch: launch without blocking on the device round-trip).
    supports_stream = False

    def assign(self, snap: PoolSnapshot,
               requests: Sequence[AssignRequest]) -> List[int]:
        raise NotImplementedError

    def warmup(self, pool_size: int, env_words: int = 8) -> None:
        """Prepare device kernels for the serving shapes (no-op for host
        policies).  Entry points call this before serving so the first
        real grant cycle never pays a kernel build."""


def compress_runs(requests: Sequence[AssignRequest]):
    """Consecutive identical descriptors -> [(env_id, min_version,
    requestor_slot, count)] runs, in request order.  THE descriptor
    contract for grouped kernels and stream_launch: flat pick position
    i always corresponds to request i."""
    descr = []
    for r in requests:
        key = (r.env_id, r.min_version, r.requestor_slot)
        if descr and tuple(descr[-1][:3]) == key:
            descr[-1][3] += 1
        else:
            descr.append([key[0], key[1], key[2], 1])
    return [tuple(d) for d in descr]


class GreedyCpuPolicy(DispatchPolicy):
    """Faithful restatement of the reference's UnsafePickServantFor loop
    (yadcc/scheduler/task_dispatcher.cc:362-451); the correctness oracle."""

    name = "greedy_cpu"

    def __init__(self, cost_model: DispatchCostModel = DEFAULT_COST_MODEL):
        self._cm = cost_model

    def assign(self, snap, requests):
        pool = {
            "alive": snap.alive,
            "capacity": snap.capacity,
            "running": snap.running.copy(),
            "dedicated": snap.dedicated,
            "version": snap.version,
            "env_bitmap": snap.env_bitmap,
        }
        tasks = [
            (r.env_id, r.min_version, r.requestor_slot) for r in requests
        ]
        return greedy.greedy_assign(pool, tasks, self._cm)


# The port's --dispatch-policy names.  Each stands for the JAX package's
# policies of the same semantics: torch_grouped for jax_grouped and
# jax_pallas_grouped, torch_batched for jax_batched and jax_pallas,
# torch_resident_grouped for jax_resident_grouped and
# jax_resident_pallas_grouped (the kernel follows the device, not a name),
# torch_sharded for jax_sharded and torch_sharded_grouped for
# jax_sharded_grouped (the pool split over a team, parallel/mesh.py).
POLICY_NAMES = ("auto", "greedy_cpu", "torch_grouped", "torch_batched",
                "torch_resident_grouped", "torch_sharded",
                "torch_sharded_grouped")


def make_policy(name: str, avoid_self: bool = True, device="cuda",
                team=None, max_servants: "int | None" = None
                ) -> DispatchPolicy:
    """Policy by its --dispatch-policy name; device policies run on
    ``device`` (a torch device or its name) and take any pool width.
    The team policies run over ``team`` (default: every card, or one
    CPU slice on device="cpu"); torch_sharded checks ``max_servants``
    against it, as jax_sharded does."""
    from dataclasses import replace

    cm = replace(DEFAULT_COST_MODEL, avoid_self=avoid_self)
    if name == "greedy_cpu":
        return GreedyCpuPolicy(cm)
    if name not in POLICY_NAMES:
        raise ValueError(f"unknown dispatch policy {name!r}")
    # The device policies load torch; the host path above does not.
    from .policy import (AutoPolicy, TorchBatchedPolicy,
                         TorchGroupedPolicy, TorchResidentGroupedPolicy,
                         TorchShardedGroupedPolicy, TorchShardedPolicy)

    if name == "torch_grouped":
        return TorchGroupedPolicy(device, cost_model=cm)
    if name == "torch_batched":
        return TorchBatchedPolicy(device, cost_model=cm)
    if name == "torch_resident_grouped":
        return TorchResidentGroupedPolicy(device, cost_model=cm)
    if name == "torch_sharded":
        return TorchShardedPolicy(max_servants, team=team, cost_model=cm,
                                  device=device)
    if name == "torch_sharded_grouped":
        return TorchShardedGroupedPolicy(team=team, cost_model=cm,
                                         device=device)
    return AutoPolicy(device, cost_model=cm)
