"""Byte-size-aware ARC (Adaptive Replacement Cache) — the cache server's L1
(a copy of the JAX package's yadcc_tpu/cache/in_memory_cache.py).

Parity with reference yadcc/cache/in_memory_cache.{h,cc} (class doc at
in_memory_cache.h:33-43): ARC keeps two real LRU lists — T1 (seen once,
recency) and T2 (seen twice+, frequency) — plus two ghost lists B1/B2
remembering *recently evicted* keys.  A hit in a ghost list is evidence
the adaptive split point `p` (target share of capacity devoted to T1)
should move toward that list's side.  Unlike textbook ARC, capacities
and `p` are in BYTES, not entry counts, because compilation artifacts
vary from sub-KB stderr blobs to multi-MB objects.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

from ..utils.clock import REAL_CLOCK, Clock


class InMemoryCache:
    def __init__(self, capacity_bytes: int, *, clock: Clock = REAL_CLOCK):
        self._c = capacity_bytes
        # Adaptive target for T1 bytes.
        self._p = 0  # guarded by: self._lock
        self._clock = clock
        # key -> last get/put time; lets the purge timer expire entries
        # by idleness instead of waiting for capacity pressure
        # (reference runs cache purge on a 1-min timer,
        # cache_service_impl.cc:172-180).
        self._touched: Dict[str, float] = {}  # guarded by: self._lock
        self._lock = threading.Lock()
        # key -> value bytes; OrderedDict: LRU at the front.
        self._t1: "OrderedDict[str, bytes]" = OrderedDict()  # guarded by: self._lock
        self._t2: "OrderedDict[str, bytes]" = OrderedDict()  # guarded by: self._lock
        # Ghosts: key -> remembered size.
        self._b1: "OrderedDict[str, int]" = OrderedDict()  # guarded by: self._lock
        self._b2: "OrderedDict[str, int]" = OrderedDict()  # guarded by: self._lock
        self._t1_bytes = 0  # guarded by: self._lock
        self._t2_bytes = 0  # guarded by: self._lock
        self._b1_bytes = 0  # guarded by: self._lock
        self._b2_bytes = 0  # guarded by: self._lock
        self.hits = 0  # guarded by: self._lock
        self.misses = 0  # guarded by: self._lock

    # -- public ------------------------------------------------------------

    def try_get(self, key: str) -> Optional[bytes]:
        with self._lock:
            v = self._t1.pop(key, None)
            if v is not None:
                # Second touch: promote recency -> frequency.
                self._t1_bytes -= len(v)
                self._t2[key] = v
                self._t2_bytes += len(v)
                self._touched[key] = self._clock.now()
                self.hits += 1
                return v
            v = self._t2.get(key)
            if v is not None:
                self._t2.move_to_end(key)
                self._touched[key] = self._clock.now()
                self.hits += 1
                return v
            self.misses += 1
            return None

    def purge(self, ttl_s: float) -> int:
        """Expire entries idle for longer than ``ttl_s``.  Unlike
        capacity eviction this is a true expiry: victims do NOT enter
        the ghost lists (a re-reference of an expired artifact is a
        fresh compile, not evidence for tuning `p`).  Returns the
        number of entries dropped."""
        dropped = 0
        with self._lock:
            cutoff = self._clock.now() - ttl_s
            for lst, attr in ((self._t1, "_t1_bytes"),
                              (self._t2, "_t2_bytes")):
                for key in [k for k in lst
                            if self._touched.get(k, 0.0) < cutoff]:
                    v = lst.pop(key)
                    setattr(self, attr, getattr(self, attr) - len(v))
                    self._touched.pop(key, None)
                    dropped += 1
        return dropped

    def put(self, key: str, value: bytes) -> None:
        size = len(value)
        if size > self._c:
            return  # larger than the whole cache: don't thrash
        with self._lock:
            self._touched[key] = self._clock.now()
            # Case: resident — update in place, treat as a frequency hit.
            old = self._t1.pop(key, None)
            if old is not None:
                self._t1_bytes -= len(old)
            else:
                old = self._t2.pop(key, None)
                if old is not None:
                    self._t2_bytes -= len(old)
            if old is not None:
                self._make_room_locked(size, ghost_hit_b2=False)
                self._t2[key] = value
                self._t2_bytes += size
                return
            # Case: ghost hit — adapt p, insert into T2.
            if key in self._b1:
                gsize = self._b1.pop(key)
                self._b1_bytes -= gsize
                # B1 hit: recency list was evicted too eagerly; grow p.
                self._p = min(
                    self._c,
                    self._p + max(gsize, self._b2_bytes // max(len(self._b2), 1)
                                  if self._b2 else gsize),
                )
                self._make_room_locked(size, ghost_hit_b2=False)
                self._t2[key] = value
                self._t2_bytes += size
                return
            if key in self._b2:
                gsize = self._b2.pop(key)
                self._b2_bytes -= gsize
                # B2 hit: frequency list needs more room; shrink p.
                self._p = max(
                    0,
                    self._p - max(gsize, self._b1_bytes // max(len(self._b1), 1)
                                  if self._b1 else gsize),
                )
                self._make_room_locked(size, ghost_hit_b2=True)
                self._t2[key] = value
                self._t2_bytes += size
                return
            # Case: brand new — insert into T1; bound B1 first (ARC's
            # "case IV" list trimming, byte-approximated).
            while self._t1_bytes + self._b1_bytes + size > self._c and self._b1:
                k, s = self._b1.popitem(last=False)
                self._b1_bytes -= s
            self._make_room_locked(size, ghost_hit_b2=False)
            self._t1[key] = value
            self._t1_bytes += size
            # Total directory (T+B) bounded by 2c.
            while (self._t1_bytes + self._t2_bytes + self._b1_bytes
                   + self._b2_bytes > 2 * self._c) and (self._b1 or self._b2):
                ghosts = self._b2 if self._b2_bytes >= self._b1_bytes else self._b1
                k, s = ghosts.popitem(last=False)
                if ghosts is self._b1:
                    self._b1_bytes -= s
                else:
                    self._b2_bytes -= s

    def remove(self, key: str) -> bool:
        with self._lock:
            self._touched.pop(key, None)
            for lst, attr in ((self._t1, "_t1_bytes"), (self._t2, "_t2_bytes")):
                v = lst.pop(key, None)
                if v is not None:
                    setattr(self, attr, getattr(self, attr) - len(v))
                    return True
            for lst, attr in ((self._b1, "_b1_bytes"), (self._b2, "_b2_bytes")):
                s = lst.pop(key, None)
                if s is not None:
                    setattr(self, attr, getattr(self, attr) - s)
            return False

    def keys(self) -> List[str]:
        with self._lock:
            return list(self._t1.keys()) + list(self._t2.keys())

    def total_bytes(self) -> int:
        with self._lock:
            return self._t1_bytes + self._t2_bytes

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {
                "capacity": self._c,
                "p": self._p,
                "t1_bytes": self._t1_bytes,
                "t2_bytes": self._t2_bytes,
                "t1_entries": len(self._t1),
                "t2_entries": len(self._t2),
                "b1_entries": len(self._b1),
                "b2_entries": len(self._b2),
                "hits": self.hits,
                "misses": self.misses,
            }

    # -- internals -----------------------------------------------------------

    def _make_room_locked(self, incoming: int, ghost_hit_b2: bool) -> None:
        """ARC REPLACE: evict from T1 or T2 (into its ghost list) until the
        incoming entry fits.  (`_locked` suffix: callers hold
        self._lock — renamed when ytpu-analyze's guarded-by pass
        started enforcing the convention.)"""
        while self._t1_bytes + self._t2_bytes + incoming > self._c:
            from_t1 = bool(self._t1) and (
                self._t1_bytes > self._p
                or (ghost_hit_b2 and self._t1_bytes == self._p)
                or not self._t2
            )
            if from_t1:
                k, v = self._t1.popitem(last=False)
                self._t1_bytes -= len(v)
                self._touched.pop(k, None)
                self._b1[k] = len(v)
                self._b1_bytes += len(v)
            elif self._t2:
                k, v = self._t2.popitem(last=False)
                self._t2_bytes -= len(v)
                self._touched.pop(k, None)
                self._b2[k] = len(v)
                self._b2_bytes += len(v)
            else:
                break
