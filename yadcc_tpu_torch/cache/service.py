"""CacheService RPC implementation (a copy of the JAX package's
yadcc_tpu/cache/service.py: the same RPCs on the same wire format, the
same L1/L2/L3 semantics, on the port's engines and Bloom generator).

Parity with reference yadcc/cache/cache_service_impl.{h,cc}:
FetchBloomFilter serves either an incremental key list or the full
zstd-compressed filter depending on the client's sync ages (with a
per-client jittered ~10min full-fetch interval enforced client-side,
cache_service_impl.cc:48-65,81-123); TryGetEntry reads L1 then L2 and
promotes L2 hits (:125-148); PutEntry is servant-token-gated and writes
L1 + L2 + the Bloom filter (:150-170); a 60s timer rebuilds the filter
from the engine's key enumeration (:172-180).

Beyond the reference: an optional shared L3 object-store tier behind N
regional cache servers (doc/cache.md "Three levels").  The contract is
strict about the reply path:

* TryGetEntry NEVER blocks on a bucket round trip.  An L1/L2 miss
  schedules an asynchronous L3 promotion on a bounded background pool
  and answers NOT_FOUND immediately; the promotion lands the entry in
  L1/L2 so the requester's retry (or the next requester) hits.  The
  reply-path stage timer in inspect() makes the claim measurable and
  tests/test_cache.py asserts it against a deliberately slow backend.
* PutEntry write-back to L3 also rides the pool, deduplicated two
  ways: against this server's resync view of the bucket (a peer
  already uploaded the entry -> record it in the fleet filter, skip
  the upload) and against this server's own in-flight set.
* Convergence for foreign writes is the engine's resync listing: the
  60s rebuild timer re-enumerates L3 keys into the FLEET Bloom filter
  (`bloom_l3`), served to daemons via FetchFleetBloomFilter — the
  second level of the Bloom cascade (per-region filter over L1/L2,
  fleet filter over L3).
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

from .. import api
from ..common import compress
from ..common.token_verifier import TokenVerifier
from ..rpc import RpcContext, RpcError, ServiceSpec
from ..utils.clock import REAL_CLOCK, Clock
from ..utils.logging import get_logger
from ..tenancy.budgets import CacheBytesLedger
from ..tenancy.keys import key_namespace
from .bloom_filter_generator import BloomFilterGenerator
from .cache_engine import CacheEngine
from .in_memory_cache import InMemoryCache

logger = get_logger("cache.service")

SERVICE_NAME = "ytpu.CacheService"

# Sync ages beyond this force a full filter fetch even if the deque
# could technically serve the gap (staleness bound).
_MAX_INCREMENTAL_AGE_S = 1800.0
# Compensation margin added to the sync age so clock skew and RPC
# latency can't open a sync hole.
_INCREMENTAL_COMPENSATION_S = 10.0
_MAX_ENTRY_BYTES = 128 << 20  # reference cache packet cap (entry.cc:27-28)
# Full-filter fetches are ~4MB; each client gets one roughly every 10
# minutes, jittered per client so a fleet doesn't synchronize
# (reference cache_service_impl.cc:48-65).
_FULL_FETCH_INTERVAL_S = 600.0
_FULL_FETCH_JITTER_S = 120.0
# Per-client sync records are dropped after this idle time.
_CLIENT_STATE_TTL_S = 2 * _MAX_INCREMENTAL_AGE_S
# L1 entries idle this long are expired by the purge timer (reference
# purges on a 1-min cadence, cache_service_impl.cc:172-180; its L1
# expiry is capacity-driven — ours adds an idleness TTL so a quiet
# server releases memory instead of pinning every artifact it ever
# served until capacity pressure arrives).
DEFAULT_L1_TTL_S = 4 * 3600.0
# Background L3 work (promotions + write-backs) outstanding at once is
# bounded; beyond it new work is shed, not queued — the bucket is an
# optimization tier, never a reason to hold memory proportional to a
# miss storm.  The resync-driven rebuild repairs anything shed.
DEFAULT_L3_PENDING_CAP = 1024


class CacheService:
    def __init__(
        self,
        l1: InMemoryCache,
        l2: CacheEngine,
        *,
        l3: Optional[CacheEngine] = None,
        user_tokens: TokenVerifier = TokenVerifier(),
        servant_tokens: TokenVerifier = TokenVerifier(),
        clock: Clock = REAL_CLOCK,
        l1_ttl_s: float = DEFAULT_L1_TTL_S,
        l3_workers: int = 2,
        l3_pending_cap: int = DEFAULT_L3_PENDING_CAP,
        tenant_bytes: Optional[CacheBytesLedger] = None,
    ):
        self.l1 = l1
        self.l2 = l2
        self.l3 = l3
        self._l1_ttl_s = l1_ttl_s
        self._purged_total = 0  # guarded by: self._lock
        self.bloom = BloomFilterGenerator(clock=clock)
        # Fleet-level filter over the shared L3's key enumeration (the
        # second cascade level); only a server with an L3 tier pays for
        # the second filter allocation.
        self.bloom_l3: Optional[BloomFilterGenerator] = (
            BloomFilterGenerator(clock=clock) if l3 is not None else None)
        self._user_tokens = user_tokens
        self._servant_tokens = servant_tokens
        self._clock = clock
        self._l2_hits = 0  # guarded by: self._lock
        self._fills = 0  # guarded by: self._lock
        # Per-tenant cache-bytes write quotas (doc/tenancy.md), keyed by
        # the PUBLIC namespace tag of scoped keys — this service holds
        # no tenant secrets.  None = no quotas (every fill admitted).
        self._tenant_bytes = tenant_bytes
        # namespace tag -> {hits, fills, rejected_fills}; "" (legacy
        # shared domain) is never tracked here.
        self._stats_by_ns: dict[str, dict[str, int]] = \
            {}  # guarded by: self._lock
        self._lock = threading.Lock()
        # client ip -> (last_fetch_time, last_full_fetch_time), one map
        # per served filter (region and fleet sync paces are independent).
        self._client_sync: dict[str, tuple[float, float]] = \
            {}  # guarded by: self._lock
        self._client_sync_l3: dict[str, tuple[float, float]] = \
            {}  # guarded by: self._lock
        # L3 tier state: keys with a promotion or write-back in flight
        # (per-server dedup), counters, and the TryGetEntry reply-path
        # stage timer that proves the no-blocking-bucket-RPC contract.
        self._l3_inflight: set[str] = set()  # guarded by: self._lock
        self._l3_pending_cap = l3_pending_cap
        self._l3_hits = 0  # guarded by: self._lock
        self._l3_misses = 0  # guarded by: self._lock
        self._l3_errors = 0  # guarded by: self._lock
        self._l3_writebacks = 0  # guarded by: self._lock
        self._l3_writeback_dedup = 0  # guarded by: self._lock
        self._l3_shed = 0  # guarded by: self._lock
        self._tryget_replies = 0  # guarded by: self._lock
        self._tryget_reply_ms_max = 0.0  # guarded by: self._lock
        self._l3_pool: Optional[ThreadPoolExecutor] = (
            ThreadPoolExecutor(max_workers=max(1, l3_workers),
                               thread_name_prefix="cache-l3")
            if l3 is not None else None)
        # Initial rebuild so restarts serve a filter that matches L2.
        self.rebuild_bloom_filter()

    # -- wiring ------------------------------------------------------------

    def spec(self) -> ServiceSpec:
        s = ServiceSpec(SERVICE_NAME)
        s.add("FetchBloomFilter", api.cache.FetchBloomFilterRequest,
              self.FetchBloomFilter)
        # Same request/response shapes as FetchBloomFilter — the fleet
        # filter is just a second filter stream, so no wire change.
        s.add("FetchFleetBloomFilter", api.cache.FetchBloomFilterRequest,
              self.FetchFleetBloomFilter)
        s.add("TryGetEntry", api.cache.TryGetEntryRequest, self.TryGetEntry)
        s.add("PutEntry", api.cache.PutEntryRequest, self.PutEntry)
        return s

    def rebuild_bloom_filter(self) -> None:
        """60s-cadence timer body (and startup).  With an L3 tier this
        is also the convergence mechanism for foreign writes: the L3
        engine's keys() re-lists the shared bucket when its resync
        interval has elapsed, so peers' uploads flow into the fleet
        filter within one resync + rebuild period."""
        keys = set(self.l2.keys()) | set(self.l1.keys())
        self.bloom.rebuild(keys)
        if self.l3 is not None and self.bloom_l3 is not None:
            self.bloom_l3.rebuild(self.l3.keys())

    def purge(self) -> None:
        """1-min-cadence timer body (reference
        cache_service_impl.cc:172-180): expire idle L1 entries and run
        the engine maintenance passes.  Without this, L1 entries age
        out only under capacity pressure."""
        dropped = self.l1.purge(self._l1_ttl_s)
        self.l2.purge()
        if self.l3 is not None:
            self.l3.purge()
        if dropped:
            # Under the lock like every other counter: the purge timer
            # is single-threaded today, but inspect() reads concurrently
            # and nothing pins the timer to one thread forever.
            with self._lock:
                self._purged_total += dropped
            logger.info("purged %d idle L1 entries (ttl=%.0fs)",
                        dropped, self._l1_ttl_s)

    def stop(self) -> None:
        """Join the L3 background pool (in-flight promotions and
        write-backs complete; queued work drains)."""
        if self._l3_pool is not None:
            self._l3_pool.shutdown(wait=True)

    # -- handlers ----------------------------------------------------------

    def _full_fetch_interval(self, client: str) -> float:
        """Per-client jittered interval, stable across calls so each
        client keeps its own phase instead of the fleet synchronizing."""
        h = int.from_bytes(client.encode()[-8:] or b"\0", "little")
        return _FULL_FETCH_INTERVAL_S + (h % int(2 * _FULL_FETCH_JITTER_S)
                                         - _FULL_FETCH_JITTER_S)

    def FetchBloomFilter(self, req, attachment, ctx: RpcContext):
        if not self._user_tokens.verify(req.token):
            raise RpcError(api.cache.CACHE_STATUS_ACCESS_DENIED, "bad token")
        with self._lock:
            sync = self._client_sync
        return self._serve_filter(self.bloom, sync, req, ctx)

    def FetchFleetBloomFilter(self, req, attachment, ctx: RpcContext):
        """The cascade's second level: the fleet filter over L3 keys.
        Same incremental/full protocol as the region filter, separate
        per-client pacing state.  Servers without an L3 tier answer
        NOT_FOUND and daemons fall back to the single-filter path."""
        if not self._user_tokens.verify(req.token):
            raise RpcError(api.cache.CACHE_STATUS_ACCESS_DENIED, "bad token")
        if self.bloom_l3 is None:
            raise RpcError(api.cache.CACHE_STATUS_NOT_FOUND, "no L3 tier")
        with self._lock:
            sync = self._client_sync_l3
        return self._serve_filter(self.bloom_l3, sync, req, ctx)

    def _serve_filter(self, gen: BloomFilterGenerator,
                      sync: dict, req, ctx: RpcContext):
        resp = api.cache.FetchBloomFilterResponse()
        now = self._clock.now()
        client = (ctx.peer or "?").rsplit(":", 1)[0]  # ip; ports churn

        # The sync age is tracked server-side per client: the server
        # knows when it last served this client, so a buggy or
        # malicious client can't claim ages that force a ~4MB full
        # fetch on every call (reference cache_service_impl.cc:81-123).
        with self._lock:
            for ip, st in list(sync.items()):
                if now - st[0] > _CLIENT_STATE_TTL_S:
                    del sync[ip]
            state = sync.get(client)
        claimed_age = req.seconds_since_last_fetch
        if state is None:
            # First contact since (re)start: client claims are the only
            # information; anything non-incremental gets the full filter.
            age = claimed_age if claimed_age > 0 else float("inf")
            full_due = req.seconds_since_last_full_fetch <= 0
            last_full = now - max(req.seconds_since_last_full_fetch, 0.0)
        else:
            last_fetch, last_full = state
            server_age = now - last_fetch
            age = max(server_age, claimed_age)
            # seconds_since_last_full_fetch <= 0 means "I hold no base
            # filter at all" (fresh daemon, or a restarted one reusing
            # an IP we still track): an incremental delta against a
            # base the client doesn't have would leave its replica
            # near-empty until the next periodic full fetch.
            full_due = (req.seconds_since_last_full_fetch <= 0
                        or now - last_full
                        >= self._full_fetch_interval(client))
            if (not full_due and not gen.can_serve_incremental(age)
                    and gen.can_serve_incremental(server_age)):
                # The client claims an age the key deque can't cover,
                # but the server served it recently enough that it can.
                # Serve the server-tracked span: an inflated claim must
                # not force a ~4MB full fetch per call, and any real gap
                # is repaired (at worst) by the next due full fetch —
                # Bloom staleness costs hit rate, never correctness.
                age = server_age

        can_incremental = (
            not full_due
            and age <= _MAX_INCREMENTAL_AGE_S
            and gen.can_serve_incremental(age)
        )
        if can_incremental:
            resp.incremental = True
            resp.newly_populated_keys.extend(
                gen.get_newly_populated_keys(
                    age + _INCREMENTAL_COMPENSATION_S))
            with self._lock:
                sync[client] = (now, last_full)
            return resp
        resp.incremental = False
        resp.num_hashes = gen.num_hashes
        # Attachment = zstd(u32 salt + filter words): the salt travels
        # with the filter so replicas always probe with the right layout.
        ctx.response_attachment = compress.compress(
            gen.salt.to_bytes(4, "little") + gen.filter_bytes())
        with self._lock:
            sync[client] = (now, now)
        return resp

    def TryGetEntry(self, req, attachment, ctx: RpcContext):
        t0 = time.perf_counter()
        if not self._user_tokens.verify(req.token):
            raise RpcError(api.cache.CACHE_STATUS_ACCESS_DENIED, "bad token")
        if not req.key:
            raise RpcError(api.cache.CACHE_STATUS_INVALID_ARGUMENT, "no key")
        value = self.l1.try_get(req.key)
        if value is None:
            value = self.l2.try_get(req.key)
            if value is not None:
                # Promote: an L2 hit is evidence of reuse.
                with self._lock:
                    self._l2_hits += 1
                self.l1.put(req.key, value)
        if value is None:
            # L3 read-through, strictly off the reply path: schedule an
            # asynchronous promotion (a no-op without an L3 tier) and
            # answer NOT_FOUND now.  The bucket round trip happens on
            # the background pool; the stage timer below is what CI
            # asserts to keep it that way.
            self._schedule_l3_promote(req.key)
            self._note_tryget_reply(t0)
            raise RpcError(api.cache.CACHE_STATUS_NOT_FOUND, req.key)
        self._bump_ns(key_namespace(req.key), "hits")
        ctx.response_attachment = value
        self._note_tryget_reply(t0)
        return api.cache.TryGetEntryResponse()

    def PutEntry(self, req, attachment, ctx: RpcContext):
        # Only compile servants may fill the cache: a malicious *user*
        # token must not be able to poison results served to everyone
        # (reference cache_service_impl.cc:150-156).
        if not self._servant_tokens.verify(req.token):
            raise RpcError(api.cache.CACHE_STATUS_ACCESS_DENIED,
                           "servant token required")
        if not req.key or not attachment:
            raise RpcError(api.cache.CACHE_STATUS_INVALID_ARGUMENT,
                           "key and value required")
        if len(attachment) > _MAX_ENTRY_BYTES:
            raise RpcError(api.cache.CACHE_STATUS_INVALID_ARGUMENT,
                           "entry too large")
        ns = key_namespace(req.key)
        if self._tenant_bytes is not None and not \
                self._tenant_bytes.try_charge(ns, req.key, len(attachment)):
            # Over the tenant's write quota: refuse the fill.  The
            # compile still succeeded on the servant; only the cache
            # byproduct is dropped, so the blast radius is a colder
            # cache for the over-quota tenant alone.
            self._bump_ns(ns, "rejected_fills")
            raise RpcError(api.cache.CACHE_STATUS_NO_QUOTA,
                           "tenant cache-bytes budget exhausted")
        self._bump_ns(ns, "fills")
        self.l1.put(req.key, attachment)
        self.l2.put(req.key, attachment)
        self.bloom.add(req.key)
        with self._lock:
            self._fills += 1
        self._schedule_l3_writeback(req.key, attachment)
        logger.info("cache fill: %s (%d bytes)", req.key, len(attachment))
        return api.cache.PutEntryResponse()

    def _bump_ns(self, namespace: str, counter: str) -> None:
        if not namespace:
            return
        with self._lock:
            per = self._stats_by_ns.setdefault(
                namespace, {"hits": 0, "fills": 0, "rejected_fills": 0})
            per[counter] += 1

    # -- L3 background tier --------------------------------------------------

    def _note_tryget_reply(self, t0: float) -> None:
        ms = (time.perf_counter() - t0) * 1000.0
        with self._lock:
            self._tryget_replies += 1
            if ms > self._tryget_reply_ms_max:
                self._tryget_reply_ms_max = ms

    def _l3_admit(self, key: str) -> bool:
        """Reserve `key` in the in-flight set, or shed: duplicate keys
        and anything past the pending cap are refused (both the
        promote and write-back paths funnel through here)."""
        with self._lock:
            if key in self._l3_inflight:
                return False
            if len(self._l3_inflight) >= self._l3_pending_cap:
                self._l3_shed += 1
                return False
            self._l3_inflight.add(key)
        return True

    def _l3_release(self, key: str) -> None:
        with self._lock:
            self._l3_inflight.discard(key)

    def _schedule_l3_promote(self, key: str) -> None:
        if self._l3_pool is None or not self._l3_admit(key):
            return
        try:
            self._l3_pool.submit(self._l3_promote, key)
        except RuntimeError:  # pool shut down mid-request
            self._l3_release(key)

    def _l3_promote(self, key: str) -> None:
        """Background body: one bucket GET, then promote upward.  The
        promoted entry also enters the REGION filter (it now lives in
        L1/L2) so daemon replicas start predicting the hit."""
        try:
            value = self.l3.try_get(key)
            if value is not None and len(value) <= _MAX_ENTRY_BYTES:
                self.l1.put(key, value)
                self.l2.put(key, value)
                self.bloom.add(key)
                if self.bloom_l3 is not None:
                    self.bloom_l3.add(key)
                with self._lock:
                    self._l3_hits += 1
                logger.info("L3 promote: %s (%d bytes)", key, len(value))
            else:
                with self._lock:
                    self._l3_misses += 1
        except Exception as e:
            with self._lock:
                self._l3_errors += 1
            logger.warning("L3 promote failed for %s: %s", key, e)
        finally:
            self._l3_release(key)

    def _schedule_l3_writeback(self, key: str, value: bytes) -> None:
        if self._l3_pool is None:
            return
        contains = getattr(self.l3, "contains", None)
        if contains is not None and contains(key):
            # Per-server dedup against the resync view: a peer regional
            # server already uploaded this entry — record it in the
            # fleet filter and skip the duplicate upload.
            if self.bloom_l3 is not None:
                self.bloom_l3.add(key)
            with self._lock:
                self._l3_writeback_dedup += 1
            return
        if not self._l3_admit(key):
            return
        try:
            self._l3_pool.submit(self._l3_writeback, key, value)
        except RuntimeError:
            self._l3_release(key)

    def _l3_writeback(self, key: str, value: bytes) -> None:
        try:
            self.l3.put(key, value)
            if self.bloom_l3 is not None:
                self.bloom_l3.add(key)
            with self._lock:
                self._l3_writebacks += 1
        except Exception as e:
            with self._lock:
                self._l3_errors += 1
            logger.warning("L3 write-back failed for %s: %s", key, e)
        finally:
            self._l3_release(key)

    def drain_l3_for_testing(self, timeout_s: float = 10.0) -> bool:
        """Wait until no L3 promotion/write-back is in flight (tests and
        the cold-region scenario use this to make async effects
        deterministic).  True iff drained within the timeout."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            with self._lock:
                if not self._l3_inflight:
                    return True
            time.sleep(0.005)
        return False

    # -- introspection -------------------------------------------------------

    def inspect(self) -> dict:
        with self._lock:
            l2_hits, fills, purged = (self._l2_hits, self._fills,
                                      self._purged_total)
            l3 = {
                "hits": self._l3_hits,
                "misses": self._l3_misses,
                "errors": self._l3_errors,
                "writebacks": self._l3_writebacks,
                "writeback_dedup": self._l3_writeback_dedup,
                "shed": self._l3_shed,
                "inflight": len(self._l3_inflight),
            }
            replies = self._tryget_replies
            reply_ms_max = self._tryget_reply_ms_max
            stats_by_ns = {ns: dict(per)
                           for ns, per in self._stats_by_ns.items()}
        out = {
            # Per-tenant visibility keys on the public namespace tag of
            # scoped keys (tenancy/keys.py key_namespace) — the tag
            # identifies WHICH tenant without revealing any computation.
            "stats_by_tenant": stats_by_ns,
            "l1": self.l1.stats(),
            "l2": {"engine": self.l2.name, **self.l2.stats()},
            "l2_hits": l2_hits,
            "fills": fills,
            "l1_purged": purged,
            "bloom_fill_ratio": round(self.bloom.fill_ratio(), 6),
            "tryget_replies": replies,
            # The reply-path stage timer: the worst TryGetEntry wall
            # time since start.  With an L3 tier attached this staying
            # small IS the no-blocking-bucket-round-trip contract.
            "tryget_reply_ms_max": round(reply_ms_max, 3),
        }
        if self.l3 is not None:
            out["l3"] = {"engine": self.l3.name, **self.l3.stats(), **l3}
            if self.bloom_l3 is not None:
                out["fleet_bloom_fill_ratio"] = round(
                    self.bloom_l3.fill_ratio(), 6)
        if self._tenant_bytes is not None:
            out["tenant_bytes"] = self._tenant_bytes.inspect()
        return out
