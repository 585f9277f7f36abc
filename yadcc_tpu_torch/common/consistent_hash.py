"""Weighted consistent-hash ring (a copy of the JAX package's
yadcc_tpu/common/consistent_hash.py, kept in the port so that it stands
alone), parity with reference yadcc/common/consistent_hash.h:33-71.

The scheduler's sharded control plane routes servant heartbeats and
grant requests shard-ward with it (scheduler/shard_router.py), at
``SCHEDULER_VNODES_PER_WEIGHT`` virtual nodes per weight unit.

The ring hashes with the port's own XXH64 at seed 0
(common/xxh64_np.py), bit-identical to the ``xxhash`` wheel's
``xxh64_intdigest`` that the JAX ring uses, so both packages place every
key on the same node.  A lookup hashes one short string, so it takes the
scalar digest (``xxh64_int``, a few microseconds); building the vnodes
takes the batch digest.

Membership is mutable: ``add_node``/``remove_node`` rebalance
incrementally with the classic consistent-hashing guarantee — removing
a node remaps ONLY the keys that node owned, adding a node steals only
the keys it now owns; every key unrelated to the change keeps its
mapping."""

from __future__ import annotations

import bisect
from typing import Dict, List, Sequence, Tuple

from .xxh64_np import xxh64_int, xxh64_keys

_VNODES_PER_WEIGHT = 100

# Vnode density for shard routing (scheduler/shard_router.py): enough
# points that the max/min key share across 16 equal-weight nodes stays
# within 1.25x.
SCHEDULER_VNODES_PER_WEIGHT = 512


def _hash(data: str) -> int:
    return xxh64_int(data.encode(), 0)


class EmptyRingError(ValueError):
    """Routing against a ring with no members."""


class ZeroWeightError(ValueError):
    """A node was added with weight <= 0 — it would own no vnodes, so
    membership would silently not mean what the caller thinks."""


class ConsistentHash:
    def __init__(self, nodes: Sequence[Tuple[str, int]],
                 vnodes_per_weight: int = _VNODES_PER_WEIGHT):
        """nodes: (name, weight) pairs; each weight unit maps to
        ``vnodes_per_weight`` virtual nodes on the ring."""
        if vnodes_per_weight <= 0:
            raise ValueError("vnodes_per_weight must be positive")
        self._vpw = vnodes_per_weight
        self._weights: Dict[str, int] = {}
        self._points: List[int] = []
        self._names: List[str] = []
        for name, weight in nodes:
            self.add_node(name, weight)

    # -- membership --------------------------------------------------------

    def add_node(self, name: str, weight: int = 1) -> None:
        """Insert (or re-weight) a node.  Keys the new vnodes now own
        move here; every other key keeps its mapping."""
        if weight <= 0:
            raise ZeroWeightError(
                f"weight must be positive: {name}={weight}")
        if name in self._weights:
            if self._weights[name] == weight:
                return
            self.remove_node(name)
        vnodes = [f"{name}#{i}" for i in range(weight * self._vpw)]
        pts = sorted((h, name) for h in xxh64_keys(vnodes, 0).tolist())
        merged_p: List[int] = []
        merged_n: List[str] = []
        i = j = 0
        while i < len(self._points) or j < len(pts):
            if j >= len(pts) or (i < len(self._points)
                                 and self._points[i] <= pts[j][0]):
                merged_p.append(self._points[i])
                merged_n.append(self._names[i])
                i += 1
            else:
                merged_p.append(pts[j][0])
                merged_n.append(pts[j][1])
                j += 1
        self._points = merged_p
        self._names = merged_n
        self._weights[name] = weight

    def remove_node(self, name: str) -> None:
        """Drop a node; ONLY the keys it owned remap (each to the next
        surviving point clockwise).  Unknown names are a no-op so a
        leave racing a crash-rejoin stays idempotent."""
        if name not in self._weights:
            return
        del self._weights[name]
        keep = [k for k, n in enumerate(self._names) if n != name]
        self._points = [self._points[k] for k in keep]
        self._names = [self._names[k] for k in keep]

    def nodes(self) -> Dict[str, int]:
        """Current membership: {name: weight}."""
        return dict(self._weights)

    def __len__(self) -> int:
        return len(self._weights)

    def __contains__(self, name: str) -> bool:
        return name in self._weights

    # -- lookup ------------------------------------------------------------

    def pick(self, key: str) -> str:
        if not self._points:
            raise EmptyRingError(
                "empty ring: no nodes with positive weight "
                "(membership fully drained)")
        idx = bisect.bisect_right(self._points, _hash(key))
        if idx == len(self._points):
            idx = 0
        return self._names[idx]
