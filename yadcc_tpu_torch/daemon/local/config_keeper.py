"""Periodic scheduler-config puller (a copy of the JAX package's
yadcc_tpu/daemon/local/config_keeper.py).

Parity with reference yadcc/daemon/local/config_keeper.h:28-48: the
delegate needs the rotating serving-daemon token (to talk to servants
and to the cache server's Put gate is servant-side; here it's the
delegate->servant credential) — pulled via GetConfig every few seconds.
"""

from __future__ import annotations

import threading
from typing import Optional

from ... import api
from ...rpc import Channel, RpcError
from ...utils.logging import get_logger

logger = get_logger("daemon.config_keeper")


class ConfigKeeper:
    def __init__(self, scheduler_uri: str, token: str,
                 refresh_interval_s: float = 10.0):
        self._uri = scheduler_uri
        self._token = token
        self._interval = refresh_interval_s
        self._lock = threading.Lock()
        self._serving_daemon_token = ""  # guarded by: self._lock
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._channel: Optional[Channel] = None  # guarded by: self._lock

    def start(self) -> None:
        self.refresh_once()
        self._thread = threading.Thread(target=self._loop,
                                        name="config-keeper", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)

    def serving_daemon_token(self) -> str:
        with self._lock:
            return self._serving_daemon_token

    def refresh_once(self) -> None:
        try:
            resp, _ = self._chan().call(
                "ytpu.SchedulerService", "GetConfig",
                api.scheduler.GetConfigRequest(token=self._token),
                api.scheduler.GetConfigResponse, timeout=5.0)
            with self._lock:
                self._serving_daemon_token = resp.serving_daemon_token
        except RpcError as e:
            logger.warning("GetConfig failed: %s", e)

    def _chan(self) -> Channel:
        # start() calls refresh_once from the constructor thread before
        # the refresh loop exists, so channel creation must be locked
        # like every other _channel access.
        with self._lock:
            if self._channel is None:
                self._channel = Channel(self._uri)
            return self._channel

    def _loop(self) -> None:
        while not self._stop.wait(timeout=self._interval):
            self.refresh_once()
