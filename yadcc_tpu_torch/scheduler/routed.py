"""A grant with its provenance on the sharded and federated planes.

Torch-free, so the federation router and the rigs on the host path load
no torch; ``shard_router.py`` re-exports both types.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Tuple


@dataclass
class RoutedGrant:
    """One grant plus its provenance on the sharded plane."""

    grant_id: int
    servant_location: str
    shard_id: int          # shard whose dispatcher issued (owns) it
    stolen: bool           # True when shard_id != the serving shard
    # Federation provenance (scheduler/federation.py): the cell whose
    # dispatcher issued the grant, and whether it was spilled there
    # from an overloaded home cell.  Single-cell planes leave the
    # defaults — cell 0, nothing spilled.
    cell_id: int = 0
    spilled: bool = False


@dataclass
class RoutedGrants:
    """wait_for_starting_new_task_routed result."""

    shard_id: int                  # home (serving) shard
    grants: List[RoutedGrant] = field(default_factory=list)
    cell_id: int = 0               # home (serving) cell

    def pairs(self) -> List[Tuple[int, str]]:
        return [(g.grant_id, g.servant_location) for g in self.grants]

    @property
    def stolen_count(self) -> int:
        return sum(1 for g in self.grants if g.stolen)

    @property
    def spilled_count(self) -> int:
        return sum(1 for g in self.grants if g.spilled)
