"""Object-store engine (the COS-engine analogue) for the L2 and the shared
L3 (a copy of the JAX package's yadcc_tpu/cache/object_store_engine.py).

Parity with reference yadcc/cache/cos_cache_engine.{h,cc}: the reference
persists its L2 in Tencent Cloud COS via flare's CosClient.  This
engine is written against a minimal ObjectStoreBackend interface —
list/get/put/delete under a key prefix — with two implementations: a
filesystem backend (tests and on-prem NFS-style deployments) and the
S3-compatible HTTP backend in s3_backend.py (AWS/GCS/MinIO/Ceph).

Object names are the url-quoted cache key, so a bare LIST recovers every
key without downloading objects — the Bloom rebuild after a restart
(reference cache_service_impl.cc:172-180) costs one listing.  Multiple
cache servers may share one bucket: each re-lists on a resync interval
and converges on peers' writes within it (foreign writes are otherwise
invisible — object stores push no invalidations).
"""

from __future__ import annotations

import threading
import time
import urllib.parse
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from .cache_engine import CacheEngine, register_engine


class ObjectStoreBackend:
    def get(self, name: str) -> Optional[bytes]:
        raise NotImplementedError

    def put(self, name: str, data: bytes) -> None:
        raise NotImplementedError

    def delete(self, name: str) -> None:
        raise NotImplementedError

    def list_objects(self) -> List[Tuple[str, int]]:
        """All (object name, size in bytes) in the store."""
        raise NotImplementedError


class FsObjectStoreBackend(ObjectStoreBackend):
    """Objects as files under a root dir (tests / shared-filesystem use)."""

    def __init__(self, root: str):
        self._root = Path(root)
        self._root.mkdir(parents=True, exist_ok=True)

    def get(self, name: str) -> Optional[bytes]:
        try:
            return (self._root / name).read_bytes()
        except FileNotFoundError:
            return None

    def put(self, name: str, data: bytes) -> None:
        tmp = self._root / f".tmp.{name}.{threading.get_native_id()}"
        try:
            tmp.write_bytes(data)
            tmp.replace(self._root / name)
        finally:
            # A failed write_bytes (disk full) or replace must not
            # strand the temp file: list_objects filters ".tmp." names,
            # but a stranded file still eats bucket space forever.
            # After a successful replace the temp name no longer
            # exists, so this is a no-op on the happy path.
            tmp.unlink(missing_ok=True)

    def delete(self, name: str) -> None:
        (self._root / name).unlink(missing_ok=True)

    def list_objects(self) -> List[Tuple[str, int]]:
        out = []
        for p in self._root.iterdir():
            if p.is_file() and not p.name.startswith(".tmp."):
                try:
                    out.append((p.name, p.stat().st_size))
                except FileNotFoundError:
                    pass  # raced a concurrent delete
        return out


def _object_name(key: str) -> str:
    """Reversible, store-safe object name (also a valid filename)."""
    return urllib.parse.quote(key, safe="")


def _key_of_object(name: str) -> str:
    return urllib.parse.unquote(name)


class ObjectStoreEngine(CacheEngine):
    """Capacity is enforced approximately with an age-based purge (object
    stores expose no cheap LRU signal); `resync_interval_s` bounds how
    stale this server's view of a shared bucket can get."""

    name = "objstore"

    _HEADER_MAGIC = b"YTOB"

    def __init__(self, backend: ObjectStoreBackend,
                 capacity_bytes: int = 64 << 30,
                 resync_interval_s: float = 300.0):
        self._backend = backend
        self._capacity = capacity_bytes
        self._resync_interval = resync_interval_s
        self._lock = threading.Lock()
        # object name -> size
        self._sizes: Dict[str, int] = {}  # guarded by: self._lock
        self._touched: Dict[str, float] = {}  # guarded by: self._lock
        self._last_resync = 0.0  # guarded by: self._lock
        self._resync()

    def _resync(self) -> None:
        """Reconcile in-memory accounting with a fresh listing.  One
        LIST, zero downloads (names encode the keys).  The listing —
        paginated, retried network I/O on the S3 backend — runs outside
        the lock so concurrent puts/gets never stall behind it."""
        listed = dict(self._backend.list_objects())
        now = time.time()
        with self._lock:
            for name in list(self._sizes):
                if name not in listed:
                    self._sizes.pop(name, None)
            # _touched can hold names _sizes never saw (try_get of an
            # object a peer deleted before our next listing): sweep it
            # independently or it grows without bound.
            for name in list(self._touched):
                if name not in listed:
                    self._touched.pop(name, None)
            for name, size in listed.items():
                self._sizes[name] = size
                self._touched.setdefault(name, now)
            self._last_resync = now

    def _resync_due(self) -> bool:
        with self._lock:
            return time.time() - self._last_resync >= self._resync_interval

    def _pack(self, key: str, value: bytes) -> bytes:
        kb = key.encode()
        return (self._HEADER_MAGIC + len(kb).to_bytes(4, "little") + kb
                + value)

    def _unpack(self, data: bytes) -> Optional[tuple]:
        if not data.startswith(self._HEADER_MAGIC):
            return None
        klen = int.from_bytes(data[4:8], "little")
        key = data[8 : 8 + klen].decode(errors="replace")
        return key, data[8 + klen :]

    def try_get(self, key: str) -> Optional[bytes]:
        name = _object_name(key)
        data = self._backend.get(name)
        if data is None:
            return None
        unpacked = self._unpack(data)
        if unpacked is None or unpacked[0] != key:
            return None  # foreign or corrupt object; never serve it
        with self._lock:
            self._touched[name] = time.time()
        return unpacked[1]

    def put(self, key: str, value: bytes) -> None:
        name = _object_name(key)
        data = self._pack(key, value)
        self._backend.put(name, data)
        if self._resync_due():
            self._resync()
        with self._lock:
            self._sizes[name] = len(data)
            self._touched[name] = time.time()
            self._purge_locked()

    def remove(self, key: str) -> None:
        name = _object_name(key)
        self._backend.delete(name)
        with self._lock:
            self._sizes.pop(name, None)
            self._touched.pop(name, None)

    def keys(self) -> List[str]:
        if self._resync_due():
            self._resync()
        with self._lock:
            return [_key_of_object(n) for n in self._sizes]

    def contains(self, key: str) -> bool:
        """Membership against this server's *view* of the bucket — a
        pure bookkeeping lookup, no backend round trip.  The view is at
        most resync_interval_s stale, which is exactly the write-back
        dedup contract: a peer's write this server hasn't listed yet may
        be re-uploaded once, never forever."""
        name = _object_name(key)
        with self._lock:
            return name in self._sizes

    def resync_for_testing(self) -> None:
        self._resync()

    def purge(self) -> None:
        """Periodic maintenance (CacheService's 1-min purge timer):
        resync bookkeeping with the store, then trim to capacity —
        covers objects written by other cache servers sharing the
        bucket, which the write-path purge never sees."""
        self._resync()
        with self._lock:
            self._purge_locked()

    def stats(self) -> Dict:
        with self._lock:
            return {"objects": len(self._sizes),
                    "total_bytes": sum(self._sizes.values()),
                    "capacity": self._capacity}

    def _purge_locked(self) -> None:
        total = sum(self._sizes.values())
        if total <= self._capacity:
            return
        for name in sorted(self._sizes, key=lambda n: self._touched.get(n, 0)):
            if total <= self._capacity:
                break
            self._backend.delete(name)
            total -= self._sizes.pop(name)
            self._touched.pop(name, None)


def _make_objstore(root: str = "", capacity: int = 64 << 30, **kw):
    if not root:
        raise ValueError("objstore engine requires --cache-dirs (root)")
    return ObjectStoreEngine(FsObjectStoreBackend(root), capacity)


def _make_s3(endpoint: str = "", bucket: str = "", access_key: str = "",
             secret_key: str = "", region: str = "us-east-1",
             prefix: str = "", use_tls: bool = False,
             capacity: int = 64 << 30, **kw):
    from .s3_backend import S3Config, S3ObjectStoreBackend

    if not endpoint or not bucket:
        raise ValueError("s3 engine requires --s3-endpoint and --s3-bucket")
    cfg = S3Config(endpoint=endpoint, bucket=bucket, access_key=access_key,
                   secret_key=secret_key, region=region, prefix=prefix,
                   use_tls=use_tls)
    eng = ObjectStoreEngine(S3ObjectStoreBackend(cfg), capacity)
    eng.name = "s3"
    return eng


register_engine("objstore", _make_objstore)
register_engine("s3", _make_s3)
