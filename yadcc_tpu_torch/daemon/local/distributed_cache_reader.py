"""Delegate-side distributed cache reader with a local Bloom replica (a
copy of the JAX package's yadcc_tpu/daemon/local/distributed_cache_reader.py
whose batch path runs on the card).

Parity with reference yadcc/daemon/local/distributed_cache_reader.h:32-56:
the daemon keeps a replica of the cache server's Bloom filter, synced
incrementally (new keys) with a jittered ~10-minute full refetch, and
TryRead() short-circuits guaranteed misses locally so cold builds don't
pay a network round trip per TU.

Card path: when a batch of keys needs testing at once (burst submits),
batch_may_contain packs the raw key bytes on the host and one
hand-written kernel (csrc/bloom.cu via ops/cuda_bloom.py) digests and
probes them on the card.

Cascade: against a cache server with a shared L3 tier, the reader also
replicates the FLEET filter (keys in the L3 bucket, synced via
FetchFleetBloomFilter on the same incremental/full protocol) and
batch_may_contain answers "region OR fleet" in one launch of the cascade
kernel a key-length class (cache/bloom_filter_generator.py:
DeviceBloomCascade) — a key the region never served but a peer region
uploaded still predicts as a hit, which is what makes L3 read-through
worth the retry.  Servers without an L3 answer NOT_FOUND once and the
reader permanently falls back to the single-filter path (the membership
kernel).

The reader's batch runs on the card unless the caller passes device="cpu"
(the kernels' plain versions); on the card a failed build or launch
raises.  Only the batch touches the card: torch, the device and the card
classes load at the first batch_may_contain, so a daemon that checks the
cache one key at a time (try_read, as the reference's delegate does)
constructs, syncs and reads without a card and without torch.
Both word arrays are uploaded on every batch: an incremental sync ORs
keys into the host filters in place, so a device copy kept between
batches would answer "definitely not" for a key the host filter holds.
"""

from __future__ import annotations

import random
import threading
import time
from typing import List, Optional

import numpy as np

from ... import api
from ...common import bloom, compress
from ...rpc import Channel, RpcError
from ...rpc.transport import STATUS_METHOD_NOT_FOUND
from ...utils.logging import get_logger

logger = get_logger("daemon.cache_reader")

_FULL_FETCH_INTERVAL_S = 600.0  # ~10min, jittered per client
_SYNC_INTERVAL_S = 10.0


class DistributedCacheReader:
    def __init__(self, cache_server_uri: str, token: str,
                 use_device_cascade: bool = True, device: str = "cuda",
                 team=None):
        self._uri = cache_server_uri
        # Resolved at the first batch (_card), with the cascade; a team
        # (parallel/mesh.py) splits the cascade's filters over its
        # slices, as the JAX reader's DeviceBloomCascade() does over the
        # mesh.
        self._device_name = device
        self._team = team
        self._device = None  # guarded by: self._lock
        self._cascade = None  # guarded by: self._lock
        self._token = token
        self._use_device_cascade = use_device_cascade
        self._lock = threading.Lock()
        # Learned from each full fetch (rides the payload); paired with
        # _filter — they must only ever be read together under the lock
        # (a full fetch replaces both; a torn read probes the new words
        # with the old salt and returns garbage membership).
        self._salt = 0  # guarded by: self._lock
        self._filter: Optional[bloom.SaltedBloomFilter] = \
            None  # guarded by: self._lock
        self._last_full_fetch = 0.0  # guarded by: self._lock
        self._last_fetch = 0.0  # guarded by: self._lock
        # Fleet-filter replica (the cascade's L3 level): same pairing
        # rule as (_salt, _filter) above.
        self._fleet_salt = 0  # guarded by: self._lock
        self._fleet_filter: Optional[bloom.SaltedBloomFilter] = \
            None  # guarded by: self._lock
        self._fleet_last_full_fetch = 0.0  # guarded by: self._lock
        self._fleet_last_fetch = 0.0  # guarded by: self._lock
        self._fleet_unsupported = False  # guarded by: self._lock
        self._full_interval = _FULL_FETCH_INTERVAL_S * random.uniform(0.9, 1.1)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._channel: Optional[Channel] = None  # guarded by: self._lock
        self.hits = 0  # guarded by: self._lock
        self.bloom_rejects = 0  # guarded by: self._lock
        self.misses = 0  # guarded by: self._lock

    @property
    def enabled(self) -> bool:
        return bool(self._uri)

    def start(self) -> None:
        if not self.enabled:
            return
        self.sync_once()
        self._thread = threading.Thread(target=self._loop,
                                        name="bloom-sync", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2)

    # -- reads ---------------------------------------------------------------

    def try_read(self, key: str) -> Optional[bytes]:
        """None on miss (including Bloom-filtered definite misses)."""
        if not self.enabled:
            return None
        with self._lock:
            flt = self._filter
            fleet = self._fleet_filter
        if (flt is not None and not flt.may_contain(key)
                and (fleet is None or not fleet.may_contain(key))):
            # Definite miss in every cascade level the reader knows
            # about.  A fleet-only maybe still goes to the server: the
            # entry lives in L3 and the async promote makes the *next*
            # read a hit even though this one answers NOT_FOUND.
            with self._lock:
                self.bloom_rejects += 1
            return None
        try:
            _, value = self._chan().call(
                "ytpu.CacheService", "TryGetEntry",
                api.cache.TryGetEntryRequest(token=self._token, key=key),
                api.cache.TryGetEntryResponse, timeout=5.0)
            with self._lock:
                self.hits += 1
            return value
        except RpcError:
            with self._lock:
                self.misses += 1
            return None

    def batch_may_contain(self, keys: List[str]) -> np.ndarray:
        """Batch Bloom test on the reader's device; numpy bool array
        (all-True when no filter is synced yet — absence of evidence
        isn't a miss).

        Rides the fused fingerprint→probe kernel: the raw key bytes go
        up and one bool[N] comes back — no host hashing, no [N, 2]
        fingerprint upload (ops/bloom_pipeline.py).  With a fleet
        replica of the same geometry synced, region and fleet filters
        resolve in ONE cascade launch a key-length class (region-maybe
        OR fleet-maybe per key)."""
        # Snapshot filters AND salts under one lock hold: a concurrent
        # full fetch swaps a (words, salt) pair, and probing new words
        # with the old salt (or vice versa) yields wrong membership
        # answers — found by ytpu-analyze (guarded-by) when _salt
        # gained its annotation.
        with self._lock:
            flt = self._filter
            salt = self._salt
            fleet = self._fleet_filter
        device, cascade = self._card()
        if flt is None or not keys:
            return np.ones(len(keys), bool)
        if (fleet is not None and self._use_device_cascade
                and fleet.num_bits == flt.num_bits):
            return cascade.may_contain_batch(flt, fleet, keys)
        from ...ops.bloom_pipeline import (as_device_words,
                                           bloom_membership_batch)

        verdict = bloom_membership_batch(
            as_device_words(flt.words, device), keys, salt,
            num_bits=flt.num_bits, num_hashes=flt.num_hashes)
        if fleet is not None:
            # Geometry mismatch (or cascade disabled): two single-filter
            # launches, host OR — same verdicts, one extra launch.
            verdict = verdict | bloom_membership_batch(
                as_device_words(fleet.words, device), keys,
                fleet.salt, num_bits=fleet.num_bits,
                num_hashes=fleet.num_hashes)
        return verdict

    def _card(self):
        """(device, cascade), resolved at the first batch: torch and the
        card classes load here, and a reader without a card raises here
        (device="cuda", the default), not at construction."""
        with self._lock:
            if self._device is None:
                from ...cache.bloom_filter_generator import \
                    DeviceBloomCascade
                from ...device import resolve_device

                device = resolve_device(self._device_name)
                self._cascade = DeviceBloomCascade(device=device,
                                                   team=self._team)
                self._device = device
            return self._device, self._cascade

    # -- sync ----------------------------------------------------------------

    def sync_once(self) -> None:
        self._sync_filter("FetchBloomFilter")
        with self._lock:
            skip_fleet = self._fleet_unsupported
        if not skip_fleet:
            self._sync_filter("FetchFleetBloomFilter")

    def _sync_filter(self, method: str) -> None:
        """One sync round for one cascade level.  Region state and fleet
        state are disjoint (method-selected below) but follow the same
        incremental/full protocol."""
        is_fleet = method == "FetchFleetBloomFilter"
        now = time.monotonic()
        with self._lock:
            if is_fleet:
                last_full = self._fleet_last_full_fetch
                last_any = self._fleet_last_fetch
                have = self._fleet_filter is not None
            else:
                last_full = self._last_full_fetch
                last_any = self._last_fetch
                have = self._filter is not None
            since_full = now - last_full if last_full else 0
            since_any = now - last_any if last_any else 0
            force_full = not have or since_full >= self._full_interval
        req = api.cache.FetchBloomFilterRequest(
            token=self._token,
            seconds_since_last_full_fetch=0 if force_full
            else int(since_full),
            seconds_since_last_fetch=0 if force_full else int(since_any),
        )
        try:
            resp, att = self._chan().call(
                "ytpu.CacheService", method, req,
                api.cache.FetchBloomFilterResponse, timeout=10.0)
        except RpcError as e:
            if is_fleet and e.status in (api.cache.CACHE_STATUS_NOT_FOUND,
                                         STATUS_METHOD_NOT_FOUND):
                # Server has no L3 tier (or predates the RPC): stop
                # asking — the single-filter path is the whole story.
                with self._lock:
                    self._fleet_unsupported = True
                logger.info("cache server has no fleet filter; "
                            "cascade disabled")
            else:
                logger.warning("bloom sync (%s) failed: %s", method, e)
            return
        with self._lock:
            if is_fleet:
                self._fleet_last_fetch = now
            else:
                self._last_fetch = now
            if resp.incremental:
                target = self._fleet_filter if is_fleet else self._filter
                if target is not None:
                    # Batched insert: one vectorized fingerprint pass
                    # over the sync window, not a digest call per key.
                    target.add_many(list(resp.newly_populated_keys))
            else:
                data = compress.try_decompress(att)
                if data is not None and len(data) > 4:
                    salt = int.from_bytes(data[:4], "little")
                    new = bloom.SaltedBloomFilter.from_bytes(
                        data[4:], resp.num_hashes, salt)
                    if is_fleet:
                        self._fleet_salt = salt
                        self._fleet_filter = new
                        self._fleet_last_full_fetch = now
                    else:
                        self._salt = salt
                        self._filter = new
                        self._last_full_fetch = now

    def _loop(self) -> None:
        while not self._stop.wait(timeout=_SYNC_INTERVAL_S):
            self.sync_once()

    def _chan(self) -> Channel:
        with self._lock:
            if self._channel is None:
                self._channel = Channel(self._uri)
            return self._channel

    def inspect(self) -> dict:
        """Counters, and when the last answered region sync was sent
        (``last_sync_s_ago``): a key filled before that moment is in the
        replica."""
        with self._lock:
            last = self._last_fetch
            return {"synced": self._filter is not None, "hits": self.hits,
                    "fleet_synced": self._fleet_filter is not None,
                    "bloom_rejects": self.bloom_rejects,
                    "misses": self.misses,
                    "last_sync_s_ago": (time.monotonic() - last
                                        if last else None)}
