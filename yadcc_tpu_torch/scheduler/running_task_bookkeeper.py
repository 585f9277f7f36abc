"""Cluster-wide running-task snapshot, merged from servant heartbeats and
served to delegates so they can join identical in-flight compilations
instead of re-running them.

Parity with reference yadcc/scheduler/running_task_bookkeeper.h:28-43.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Dict, List, Sequence


@dataclass(frozen=True)
class RunningTaskRecord:
    servant_task_id: int
    task_grant_id: int
    servant_location: str
    task_digest: str


class RunningTaskBookkeeper:
    def __init__(self):
        self._lock = threading.Lock()
        self._by_servant: Dict[str, List[RunningTaskRecord]] = \
            {}  # guarded by: self._lock

    def set_servant_running_tasks(
        self, location: str, tasks: Sequence[RunningTaskRecord]
    ) -> None:
        with self._lock:
            self._by_servant[location] = list(tasks)

    def drop_servant(self, location: str) -> None:
        with self._lock:
            self._by_servant.pop(location, None)

    def get_running_tasks(self) -> List[RunningTaskRecord]:
        with self._lock:
            out: List[RunningTaskRecord] = []
            for tasks in self._by_servant.values():
                out.extend(tasks)
            return out
