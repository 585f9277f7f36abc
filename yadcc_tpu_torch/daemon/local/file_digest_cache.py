"""(path, size, mtime) -> digest memo (a copy of the JAX package's
yadcc_tpu/daemon/local/file_digest_cache.py).

Parity with reference yadcc/daemon/local/file_digest_cache.h:29-70: the
daemon may not have read permission on the client's compiler binary, so
the *client* digests it and reports the result; the daemon memoizes it
against the file's cheap identity attributes.

Unlike the reference (whose test build runs under gperftools
heap_check='strict', BLADE_ROOT:25-33), a long-running Python daemon
gets no allocator-level leak tier — so this map is explicitly bounded:
keys are client-supplied (any path x size x mtime), and an unbounded
memo would be a slow memory leak driven by toolchain updates or a
misbehaving client.  LRU eviction; the cap is far above any real
machine's toolchain count.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Optional, Tuple

DEFAULT_CAPACITY = 65536


class FileDigestCache:
    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        self._lock = threading.Lock()
        self._capacity = max(1, capacity)
        self._memo: "OrderedDict[Tuple[str, int, int], str]" = \
            OrderedDict()  # guarded by: self._lock

    def set(self, path: str, size: int, mtime: int, digest: str) -> None:
        with self._lock:
            key = (path, size, mtime)
            self._memo[key] = digest
            self._memo.move_to_end(key)
            while len(self._memo) > self._capacity:
                self._memo.popitem(last=False)

    def try_get(self, path: str, size: int, mtime: int) -> Optional[str]:
        with self._lock:
            digest = self._memo.get((path, size, mtime))
            if digest is not None:
                self._memo.move_to_end((path, size, mtime))
            return digest

    def inspect(self) -> dict:
        with self._lock:
            return {"entries": len(self._memo),
                    "capacity": self._capacity}
