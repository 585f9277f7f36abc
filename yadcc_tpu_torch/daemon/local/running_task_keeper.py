"""Cluster-wide running-task snapshot for duplicate-compilation joining
(a copy of the JAX package's
yadcc_tpu/daemon/local/running_task_keeper.py).

Parity with reference yadcc/daemon/local/running_task_keeper.h:33-58:
periodically pulls the scheduler's merged running-task list; a delegate
about to compile digest D first checks whether some servant is already
compiling D and joins that task instead.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Dict, Optional

from ... import api
from ...rpc import Channel, RpcError
from ...utils.logging import get_logger

logger = get_logger("daemon.running_task_keeper")


@dataclass(frozen=True)
class FoundTask:
    servant_location: str
    servant_task_id: int


class RunningTaskKeeper:
    def __init__(self, scheduler_uri: str, refresh_interval_s: float = 5.0):
        self._uri = scheduler_uri
        self._interval = refresh_interval_s
        self._lock = threading.Lock()
        self._by_digest: Dict[str, FoundTask] = {}  # guarded by: self._lock
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._channel: Optional[Channel] = None  # guarded by: self._lock

    def start(self) -> None:
        self._thread = threading.Thread(target=self._loop,
                                        name="running-task-keeper",
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)

    def try_find_task(self, digest: str) -> Optional[FoundTask]:
        with self._lock:
            return self._by_digest.get(digest)

    def refresh_once(self) -> None:
        try:
            resp, _ = self._chan().call(
                "ytpu.SchedulerService", "GetRunningTasks",
                api.scheduler.GetRunningTasksRequest(),
                api.scheduler.GetRunningTasksResponse, timeout=5.0)
            table = {
                t.task_digest: FoundTask(t.servant_location,
                                         t.servant_task_id)
                for t in resp.running_tasks if t.task_digest
            }
            with self._lock:
                self._by_digest = table
        except RpcError as e:
            logger.warning("GetRunningTasks failed: %s", e)

    def _chan(self) -> Channel:
        with self._lock:
            if self._channel is None:
                self._channel = Channel(self._uri)
            return self._channel

    def _loop(self) -> None:
        while not self._stop.wait(timeout=self._interval):
            self.refresh_once()
