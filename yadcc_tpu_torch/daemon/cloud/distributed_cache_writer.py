"""Fire-and-forget cache filling from the servant (a copy of the JAX
package's yadcc_tpu/daemon/cloud/distributed_cache_writer.py).

Parity with reference yadcc/daemon/cloud/distributed_cache_writer.h:39-55:
PutEntry is issued asynchronously — a slow or dead cache server must
never delay returning compilation results to the delegate.
"""

from __future__ import annotations

import threading
from typing import Optional

from ... import api
from ...rpc import Channel, RpcError
from ...utils.logging import get_logger

logger = get_logger("daemon.cache_writer")


class DistributedCacheWriter:
    def __init__(self, cache_server_uri: str, token_provider):
        """token_provider: callable returning the current servant token."""
        self._uri = cache_server_uri
        self._token_provider = token_provider
        self._channel: Optional[Channel] = None  # guarded by: self._lock
        self._lock = threading.Lock()

    @property
    def enabled(self) -> bool:
        return bool(self._uri)

    def _chan(self) -> Channel:
        with self._lock:
            if self._channel is None:
                self._channel = Channel(self._uri)
            return self._channel

    def async_write(self, key: str, value: bytes) -> None:
        if not self.enabled:
            return
        threading.Thread(
            target=self._write, args=(key, value),
            name="cache-fill", daemon=True,
        ).start()

    def _write(self, key: str, value: bytes) -> None:
        try:
            self._chan().call(
                "ytpu.CacheService", "PutEntry",
                api.cache.PutEntryRequest(token=self._token_provider(),
                                          key=key),
                api.cache.PutEntryResponse,
                attachment=value,
                timeout=10.0,
            )
        except RpcError as e:
            logger.warning("cache fill failed for %s: %s", key, e)
