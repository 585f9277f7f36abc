"""Disk-backed L2 engine over common.DiskCache (a copy of the JAX
package's yadcc_tpu/cache/disk_engine.py, on the port's disk cache).

Parity with reference yadcc/cache/disk_cache_engine.h:32-66.  DiskCache
stores entries under key *digests*, which is enough for get/put but not
for Bloom rebuild — the filter needs the original key strings.  The
engine therefore keeps a sidecar manifest (digest -> key) per instance,
appended on put and compacted against the surviving digests at startup.
"""

from __future__ import annotations

import os
import threading
from pathlib import Path
from typing import Dict, List, Optional, Sequence

from ..common.disk_cache import DiskCache, ShardSpec
from ..common.hashing import digest_bytes
from ..utils.logging import get_logger
from .cache_engine import CacheEngine, register_engine

logger = get_logger("cache.disk_engine")


class DiskCacheEngine(CacheEngine):
    name = "disk"

    def __init__(self, shards: Sequence[ShardSpec],
                 on_misplaced: str = DiskCache.ON_MISPLACED_MOVE):
        self._cache = DiskCache(shards, on_misplaced=on_misplaced)
        self._lock = threading.Lock()
        self._manifest_path = Path(shards[0].path) / "keys.manifest"
        # digest -> key.  Manifest appends ride the same critical
        # section (cache/ is not a latency-budgeted hot path; atomicity
        # of memo + sidecar beats shaving the write).
        self._keys: Dict[str, str] = {}  # guarded by: self._lock
        self._load_manifest()

    # -- SPI -----------------------------------------------------------------

    def try_get(self, key: str) -> Optional[bytes]:
        return self._cache.try_get(key)

    def put(self, key: str, value: bytes) -> None:
        self._cache.put(key, value)
        digest = digest_bytes(key.encode())
        with self._lock:
            if digest not in self._keys:
                self._keys[digest] = key
                with open(self._manifest_path, "a") as fp:
                    fp.write(f"{digest} {key}\n")

    def remove(self, key: str) -> None:
        self._cache.remove(key)
        with self._lock:
            self._keys.pop(digest_bytes(key.encode()), None)

    def keys(self) -> List[str]:
        # Purge may have evicted entries since the manifest was written;
        # report only keys whose digest still exists on disk.
        live = set(self._cache.digests())
        with self._lock:
            return [k for d, k in self._keys.items() if d in live]

    def stats(self) -> Dict:
        return {
            "shards": {s: {"entries": e, "bytes": b}
                       for s, (e, b) in self._cache.stats().items()},
            "total_bytes": self._cache.total_bytes(),
        }

    def purge(self) -> None:
        self._cache.purge()

    # -- manifest --------------------------------------------------------------

    def _load_manifest(self) -> None:
        # Construction-time only (no concurrent callers yet), but the
        # guarded fields keep their discipline: taking the uncontended
        # lock once beats carving out a lint exception.
        live = set(self._cache.digests())
        with self._lock:
            if self._manifest_path.exists():
                for line in self._manifest_path.read_text().splitlines():
                    digest, _, key = line.partition(" ")
                    if digest in live and key:
                        self._keys[digest] = key
            dropped = len(live) - len(self._keys)
            if dropped > 0:
                # Entries on disk with no manifest line (manifest lost
                # or partially written): they stay servable by key but
                # can't feed Bloom rebuild.
                logger.warning("%d cache entries missing from key "
                               "manifest", dropped)
            # Compact: drop manifest lines for purged entries.
            with open(self._manifest_path, "w") as fp:
                for digest, key in self._keys.items():
                    fp.write(f"{digest} {key}\n")


def _make_disk(dirs: str = "", capacity: int = 32 << 30,
               on_misplaced: str = DiskCache.ON_MISPLACED_MOVE, **kw):
    shard_dirs = [d for d in dirs.split(",") if d]
    if not shard_dirs:
        raise ValueError("disk engine requires --cache-dirs")
    per = capacity // len(shard_dirs)
    return DiskCacheEngine([ShardSpec(d, per) for d in shard_dirs],
                           on_misplaced=on_misplaced)


register_engine("disk", _make_disk)
