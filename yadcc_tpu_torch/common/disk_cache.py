"""Sharded on-disk KV store for the cache server's L2 (a copy of the JAX
package's yadcc_tpu/common/disk_cache.py, on the port's own
consistent_hash.py and hashing.py, so that a directory either package
filled reads back whole through the other: the ring places every digest
on the same shard in both).

Parity with reference yadcc/common/disk_cache.h:42-110 — deliberately NOT
an LSM/embedded DB (yadcc/doc/cache.md:29-35): entries are ~1MB blobs,
one file each, so a plain directory tree with size caps is both simpler
and faster to operate.

Layout: each configured shard is a directory with its own byte-size cap.
A key picks its shard via a weighted consistent-hash ring (stable under
shard add/remove), then lands in a 2-level / 16-way fan-out subdirectory
derived from the key digest's leading nibbles.  Values are written via a
temp file + rename so readers never observe partial entries.  An
LRU-flavored purge evicts oldest-accessed files when a shard exceeds its
cap.  On startup, shards are rescanned to rebuild size accounting, and
entries whose key no longer hashes to the shard they sit in (after a
topology change) are handled per the misplaced-entry policy:
delete / move / ignore (reference --disk_engine_action_on_misplaced_cache_entry,
yadcc/doc/cache.md:65-69).

All internal bookkeeping is keyed by the key's hex digest (which is also
the on-disk file name), so entries discovered by the startup scan — for
which the original key string is unknown — behave identically to entries
written through put().  Timestamps are epoch seconds (time.time) so
scanned file mtimes and fresh writes share one clock domain.
"""

from __future__ import annotations

import itertools
import os
import threading
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

from .consistent_hash import ConsistentHash
from .hashing import digest_bytes


@dataclass
class ShardSpec:
    path: str
    capacity_bytes: int
    weight: int = 1


@dataclass
class _Entry:
    size: int
    last_used: float  # epoch seconds


_tmp_counter = itertools.count()


class DiskCache:
    ON_MISPLACED_DELETE = "delete"
    ON_MISPLACED_MOVE = "move"
    ON_MISPLACED_IGNORE = "ignore"

    def __init__(
        self,
        shards: Sequence[ShardSpec],
        on_misplaced: str = ON_MISPLACED_MOVE,
        sweep_on_start: bool = True,
    ):
        if not shards:
            raise ValueError("at least one shard required")
        if on_misplaced not in (self.ON_MISPLACED_DELETE,
                                self.ON_MISPLACED_MOVE,
                                self.ON_MISPLACED_IGNORE):
            raise ValueError(f"unknown misplaced-entry policy {on_misplaced!r}")
        self._shards: Dict[str, ShardSpec] = {s.path: s for s in shards}
        self._ring = ConsistentHash([(s.path, s.weight) for s in shards])
        self._lock = threading.Lock()
        # Per-shard: digest -> entry bookkeeping, plus running byte total.
        self._entries: Dict[str, Dict[str, _Entry]] = {
            s.path: {} for s in shards
        }
        self._sizes: Dict[str, int] = {s.path: 0 for s in shards}
        for s in shards:
            Path(s.path).mkdir(parents=True, exist_ok=True)
        if sweep_on_start:
            self._startup_scan(on_misplaced)

    # -- key placement -----------------------------------------------------

    @staticmethod
    def _key_digest(key: str) -> str:
        return digest_bytes(key.encode())

    @staticmethod
    def _digest_path(shard: str, digest: str) -> Path:
        return Path(shard) / digest[0] / digest[1] / digest

    def _place(self, key: str) -> Tuple[str, str]:
        """key -> (shard, digest)."""
        digest = self._key_digest(key)
        return self._ring.pick(digest), digest

    # -- public API --------------------------------------------------------

    def try_get(self, key: str) -> Optional[bytes]:
        shard, digest = self._place(key)
        try:
            data = self._digest_path(shard, digest).read_bytes()
        except FileNotFoundError:
            return None
        with self._lock:
            e = self._entries[shard].get(digest)
            if e is not None:
                e.last_used = time.time()
        return data

    def put(self, key: str, value: bytes) -> None:
        shard, digest = self._place(key)
        path = self._digest_path(shard, digest)
        path.parent.mkdir(parents=True, exist_ok=True)
        # pid + thread id + counter: concurrent writers of the same key in
        # one process must not share a temp file.
        tmp = path.with_name(
            f"{path.name}.tmp{os.getpid()}_{threading.get_native_id()}"
            f"_{next(_tmp_counter)}"
        )
        tmp.write_bytes(value)
        os.replace(tmp, path)
        with self._lock:
            old = self._entries[shard].pop(digest, None)
            if old is not None:
                self._sizes[shard] -= old.size
            self._entries[shard][digest] = _Entry(len(value), time.time())
            self._sizes[shard] += len(value)
            self._purge_locked(shard)

    def remove(self, key: str) -> bool:
        shard, digest = self._place(key)
        try:
            self._digest_path(shard, digest).unlink()
        except FileNotFoundError:
            return False
        with self._lock:
            old = self._entries[shard].pop(digest, None)
            if old is not None:
                self._sizes[shard] -= old.size
        return True

    def contains(self, key: str) -> bool:
        shard, digest = self._place(key)
        with self._lock:
            if digest in self._entries[shard]:
                return True
        return self._digest_path(shard, digest).exists()

    def digests(self) -> List[str]:
        """Digests of all stored entries (key strings are not recoverable;
        callers that need keys must track them separately)."""
        with self._lock:
            out: List[str] = []
            for entries in self._entries.values():
                out.extend(entries.keys())
            return out

    def entry_count(self) -> int:
        with self._lock:
            return sum(len(e) for e in self._entries.values())

    def total_bytes(self) -> int:
        with self._lock:
            return sum(self._sizes.values())

    def stats(self) -> Dict[str, Tuple[int, int]]:
        """shard -> (entries, bytes)."""
        with self._lock:
            return {
                s: (len(self._entries[s]), self._sizes[s]) for s in self._shards
            }

    def purge(self) -> None:
        """Periodic maintenance: trim every shard back to capacity.
        The write path already purges the shard it touches; this pass
        covers shards whose capacity was reduced (restart with a
        smaller --cache-dirs quota) or that were filled by the startup
        scan rather than writes."""
        with self._lock:
            for shard in self._shards:
                self._purge_locked(shard)

    # -- internals ---------------------------------------------------------

    def _purge_locked(self, shard: str) -> None:
        cap = self._shards[shard].capacity_bytes
        if self._sizes[shard] <= cap:
            return
        victims = sorted(
            self._entries[shard].items(), key=lambda kv: kv[1].last_used
        )
        for digest, e in victims:
            if self._sizes[shard] <= cap:
                break
            try:
                self._digest_path(shard, digest).unlink(missing_ok=True)
            except OSError:
                pass
            del self._entries[shard][digest]
            self._sizes[shard] -= e.size

    def _register_scanned(self, shard: str, digest: str, size: int,
                          mtime: float) -> None:
        # A moved entry may be seen twice (once when moved in, once when
        # its new shard is scanned); register exactly once.
        if digest in self._entries[shard]:
            return
        self._entries[shard][digest] = _Entry(size, mtime)
        self._sizes[shard] += size

    def _startup_scan(self, on_misplaced: str) -> None:
        """Rebuild bookkeeping from disk; reconcile misplaced entries.

        File names are key digests, so a file's *correct* shard is
        computable from its name alone.
        """
        for shard in self._shards:
            root = Path(shard)
            for f in root.glob("*/*/*"):
                if not f.is_file():
                    continue
                if ".tmp" in f.name:  # leftover from a crashed writer
                    f.unlink(missing_ok=True)
                    continue
                digest = f.name
                correct = self._ring.pick(digest)
                try:
                    st = f.stat()
                except OSError:
                    continue
                if correct != shard:
                    if on_misplaced == self.ON_MISPLACED_DELETE:
                        f.unlink(missing_ok=True)
                        continue
                    if on_misplaced == self.ON_MISPLACED_MOVE:
                        dst = self._digest_path(correct, digest)
                        if digest in self._entries[correct] or dst.exists():
                            # The correct shard already holds this entry
                            # (same key, same digest -> same value modulo
                            # write time); drop the misplaced duplicate
                            # instead of clobbering registered accounting.
                            f.unlink(missing_ok=True)
                            continue
                        dst.parent.mkdir(parents=True, exist_ok=True)
                        try:
                            os.replace(f, dst)
                        except OSError:
                            continue
                        self._register_scanned(correct, digest, st.st_size,
                                               st.st_mtime)
                        continue
                    # ignore: account for it where it sits.
                self._register_scanned(shard, digest, st.st_size, st.st_mtime)
