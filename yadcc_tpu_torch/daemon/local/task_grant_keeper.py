"""Grant prefetching and batching (a copy of the JAX package's
yadcc_tpu/daemon/local/task_grant_keeper.py).

Parity with reference yadcc/daemon/local/task_grant_keeper.{h,cc}: one
fetcher thread per compilation environment pulls grants from the
scheduler, requesting `immediate = waiters` plus one prefetch so the
next task usually finds a grant already queued (latency hiding —
task_grant_keeper.cc:117-183).  Grants carry a 15s lease minus a 5s
network-tolerance margin; stale queue entries are freed back rather
than handed out.  At stop() the queued grants go back to the scheduler
before the call returns, so a daemon that leaves holds no slot, and a
grant freed after stop() is freed on the caller's thread.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

from ... import api
from ...common.backoff import Backoff
from ...common.consistent_hash import (SCHEDULER_VNODES_PER_WEIGHT,
                                       ConsistentHash)
from ...rpc import Channel, RpcError
from ...rpc.transport import STATUS_TRANSPORT_FAILURE
from ...utils.logging import get_logger
from .fair_admission import FairGrantQueue

logger = get_logger("daemon.grant_keeper")

_LEASE_S = 15.0
_NETWORK_TOLERANCE_S = 5.0
# How long a scheduler flow-control verdict (the overload ladder) stays
# authoritative when the scheduler attached no retry-after of its own.
_FLOW_DEFAULT_TTL_S = 1.0
# Long-poll lap length.  The reference issues one 5s poll per demand
# window; we split it into short laps so a fetcher observes retire()/
# stop() within one lap instead of lingering in a blocked RPC for the
# whole poll (retired fetchers used to survive ~8s past retirement,
# unbounded under compiler-env churn).  A scheduler
# with grants available answers a lap instantly, so throughput is
# unaffected; only the dry-scheduler case polls more often.
_POLL_LAP_MS = 1000
_RPC_TIMEOUT_MARGIN_S = 1.5


@dataclass
class Grant:
    grant_id: int
    servant_location: str
    usable_until: float


class _EnvFetcher:
    def __init__(self, keeper: "TaskGrantKeeper", env_digest: str,
                 tenant: str = ""):
        self.keeper = keeper
        self.env_digest = env_digest
        # Multi-tenant QoS: fetchers are keyed by
        # (env, tenant) so each fetch carries exactly ONE tenant's
        # credential and the scheduler's per-tenant ledger attributes
        # every minted grant to the tenant that asked — a shared
        # fetcher would launder all demand under one identity.
        self.tenant = tenant
        # Weighted-fair hand-out keyed by requestor: one make -j500
        # must not starve the other clients on this box.
        self.queue = FairGrantQueue()
        self.waiters = 0  # guarded by: self.lock
        self.lock = threading.Lock()
        self.wake = threading.Event()
        self.retired = threading.Event()
        self.last_used = time.monotonic()
        # The fetch loop's own counters (written by its thread only).
        self.counts = {"fetches": 0, "grants": 0, "dry": 0, "flow": 0}
        self.thread = threading.Thread(
            target=self._loop, name=f"grant-fetch-{env_digest[:8]}",
            daemon=True)
        self.thread.start()

    def get(self, timeout_s: float, client_key: str = "",
            weight: float = 1.0, tenant: str = "",
            tenant_weight: float = 1.0) -> Optional[Grant]:
        deadline = time.monotonic() + timeout_s
        with self.lock:
            self.waiters += 1
            self.last_used = time.monotonic()
        self.wake.set()
        try:
            while True:
                if self._stopped():
                    # Retired under us (idle sweep / stop): the closed
                    # queue yields nothing; the keeper hands the next
                    # call a fresh fetcher, unless it is stopping.
                    return None
                if self.keeper.local_only_active():
                    # The scheduler said compile-locally; fail FAST so
                    # the caller's local fallback starts now, not after
                    # a 10s grant wait that cannot succeed.
                    return None
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return None
                g = self.queue.get(client_key, weight,
                                   timeout_s=min(remaining, 0.5),
                                   tenant=tenant,
                                   tenant_weight=tenant_weight)
                if g is None:
                    self.wake.set()  # fetcher may have gone idle
                    continue
                if g.usable_until > time.monotonic():
                    return g
                # Expired while queued: return it to the scheduler.
                self.keeper._free_async([g.grant_id])
        finally:
            with self.lock:
                self.waiters -= 1

    def retire(self) -> None:
        """Stop the fetch thread and hand queued grants back.  Called
        with no waiters; late racers re-create a fresh fetcher.  The
        queue is CLOSED first so a fetch landing after this point
        parks its grants in the backlog (freed by the loop's exit
        drain) instead of handing them to a late waiter of a dead
        fetcher; the loop drains again on exit for exactly that case."""
        self.retired.set()
        self.wake.set()
        self.queue.close()
        self._drain_and_free()

    def _drain_and_free(self, wait: bool = False) -> None:
        stale = [g.grant_id for g in self.queue.drain()]
        if stale and wait:
            self.keeper._free_now(stale)
        elif stale:
            self.keeper._free_async(stale)

    def _stopped(self) -> bool:
        return (self.keeper._stopping.is_set() or self.retired.is_set())

    def _loop(self) -> None:
        # Dry-scheduler pacing: bounded exponential backoff with full
        # jitter (common/backoff.py) instead of the old fixed 0.1s lap,
        # honoring the scheduler's retry-after when its overload ladder
        # sent one.  Sleeps ride `retired.wait` so retirement still
        # interrupts within one delay.
        backoff = Backoff(initial_s=0.05, max_s=2.0)
        while not self._stopped():
            self.wake.wait(timeout=0.5)
            self.wake.clear()
            if self._stopped():
                break
            if self.keeper.local_only_active():
                continue  # waiters are failing fast to local compiles
            with self.lock:
                waiters = self.waiters
            backlog = self.queue.qsize()
            if waiters <= backlog:
                continue  # queued grants already cover the demand
            immediate = waiters - backlog
            grants, flow, retry_after_s = self.keeper._fetch(
                self.env_digest, immediate, prefetch=1,
                tenant=self.tenant)
            self.counts["fetches"] += 1
            self.counts["grants"] += len(grants)
            now = time.monotonic()
            for gid, location in grants:
                self.queue.put(Grant(
                    gid, location,
                    usable_until=now + _LEASE_S - _NETWORK_TOLERANCE_S))
            if grants:
                self.keeper._note_flow(0, 0.0)
                backoff.reset()
                continue
            self.counts["flow" if flow else "dry"] += 1
            if flow:
                # Explicit overload verdict: record it (waiters on
                # COMPILE_LOCALLY bail fast; REJECT paces the retry by
                # the server's own backoff hint).
                self.keeper._note_flow(flow, retry_after_s)
                if flow == api.scheduler.FLOW_CONTROL_REJECT:
                    self.retired.wait(backoff.next_delay(retry_after_s))
                continue
            self.retired.wait(backoff.next_delay())  # scheduler dry
        if self.retired.is_set() or self.keeper._stopping.is_set():
            # A fetch that was in flight when retire() drained may have
            # enqueued grants after that drain: free them too, or the
            # scheduler holds those slots until the lease expires.  On
            # this thread, before it ends: stop() joins it, so a daemon
            # that leaves has returned them.
            self._drain_and_free(wait=True)


class TaskGrantKeeper:
    # A fetcher for a compiler env nobody has used in this long is
    # retired (thread stopped, queued grants freed): a delegate in a
    # fleet with rotating toolchains must not accumulate one thread +
    # queue per env digest it has EVER seen.
    IDLE_FETCHER_TTL_S = 600.0

    def __init__(self, scheduler_uri: str, token: str,
                 min_version: int = 0,
                 tenant_credential_fn=None):
        # Multi-cell federation: ``scheduler_uri`` is ";"-separated
        # cell groups, each group a comma-separated active,standby
        # failover list (the comma form dials through
        # rpc.FailoverChannel).  A compiler env's home
        # cell is picked by consistent hash on its digest — the same
        # ring discipline the cells use — so this delegate's fetches
        # land where that toolchain's artifacts are warm.  The common
        # single-cell "host:port" form takes the exact old path.
        self._cell_uris = [u.strip() for u in scheduler_uri.split(";")
                           if u.strip()]
        if not self._cell_uris:
            raise ValueError("scheduler_uri must name at least one cell")
        self._ring = (ConsistentHash(
            [(str(i), 1) for i in range(len(self._cell_uris))],
            vnodes_per_weight=SCHEDULER_VNODES_PER_WEIGHT)
            if len(self._cell_uris) > 1 else None)
        self._token = token
        self._min_version = min_version
        # tenant_id -> credential minting callable (typically
        # TenancyControl.credential_for).  None on untenanted
        # deployments; fetches then never set tenant_credential and the
        # wire stays byte-identical to the legacy form.
        self._tenant_credential_fn = tenant_credential_fn
        self._lock = threading.Lock()
        self._fetchers: Dict[str, _EnvFetcher] = {}  # guarded by: self._lock
        self._stopping = threading.Event()
        self._channels: Dict[int, Channel] = {}  # guarded by: self._lock
        self._closed = False  # guarded by: self._lock; set by stop()
        # Last scheduler flow-control verdict and when it stops being
        # authoritative: (FlowControlVerdict value, monotonic deadline).
        self._flow: Tuple[int, float] = (0, 0.0)  # guarded by: self._lock

    def get(self, env_digest: str, timeout_s: float = 10.0,
            client_key: str = "", weight: float = 1.0,
            tenant: str = "", tenant_weight: float = 1.0
            ) -> Optional[Grant]:
        """One grant for ``env_digest``, or None.  ``client_key``
        identifies the requestor for weighted-fair hand-out (empty =
        shared anonymous client); ``tenant`` selects the outer stride
        level of the two-level queue (empty = shared legacy tenant).
        Under an active compile-locally verdict, or once the keeper is
        stopping, this returns None immediately so the caller's local
        fallback starts now."""
        if self._stopping.is_set() or self.local_only_active():
            return None
        now = time.monotonic()
        # Fetchers are keyed (env, tenant) so each carries one tenant's
        # credential; "\x00" cannot appear in a hex digest, so the
        # legacy tenant-less key space is untouched.
        fkey = env_digest if not tenant else f"{env_digest}\x00{tenant}"
        retire = []
        with self._lock:
            for key, f in list(self._fetchers.items()):
                if (key != fkey and f.waiters == 0
                        and now - f.last_used > self.IDLE_FETCHER_TTL_S):
                    retire.append(self._fetchers.pop(key))
            f = self._fetchers.get(fkey)
            if f is None or f.retired.is_set():
                f = _EnvFetcher(self, env_digest, tenant=tenant)
                self._fetchers[fkey] = f
            # Refresh under the keeper lock: the idle scan above runs
            # under the same lock, so a fetcher handed out here can
            # never be judged stale before its waiter registers.
            f.last_used = now
        for r in retire:
            r.retire()
        return f.get(timeout_s, client_key=client_key, weight=weight,
                     tenant=tenant, tenant_weight=tenant_weight)

    # -- flow-control verdict state (overload ladder) ------------------------

    def _note_flow(self, flow: int, retry_after_s: float) -> None:
        with self._lock:
            if flow == 0:
                self._flow = (0, 0.0)
            else:
                ttl = (retry_after_s if retry_after_s and retry_after_s > 0
                       else _FLOW_DEFAULT_TTL_S)
                self._flow = (flow, time.monotonic() + ttl)

    def flow_state(self) -> Tuple[int, float]:
        """(FlowControlVerdict value, seconds it stays authoritative);
        (0, 0) when the last fetch saw a healthy scheduler."""
        with self._lock:
            flow, until = self._flow
        remaining = until - time.monotonic()
        return (flow, max(0.0, remaining)) if remaining > 0 else (0, 0.0)

    def local_only_active(self) -> bool:
        flow, _ = self.flow_state()
        return flow == api.scheduler.FLOW_CONTROL_COMPILE_LOCALLY

    def inspect(self) -> dict:
        """Per fetcher: waiters, queued grants and the fetch loop's
        counters (fetches, grants received, dry laps, flow verdicts)."""
        with self._lock:
            fetchers = list(self._fetchers.values())
        out = {}
        for f in fetchers:
            with f.lock:
                waiters = f.waiters
            key = f.env_digest[:16] + (f"/{f.tenant}" if f.tenant else "")
            out[key] = dict(f.counts, waiters=waiters,
                            queued=f.queue.qsize())
        flow, remaining = self.flow_state()
        return {"flow": flow, "flow_s": remaining, "fetchers": out}

    def free(self, grant_ids) -> None:
        if self._stopping.is_set():
            # A stopping keeper starts no thread: the caller (a task
            # thread that the daemon joins at shutdown) frees them.
            self._free_now(list(grant_ids))
        else:
            self._free_async(list(grant_ids))

    def keep_alive(self, grant_ids) -> list:
        """Renew leases in batch; returns per-grant success."""
        try:
            resp, _ = self._chan().call(
                "ytpu.SchedulerService", "KeepTaskAlive",
                api.scheduler.KeepTaskAliveRequest(
                    token=self._token,
                    task_grant_ids=list(grant_ids),
                    next_keep_alive_in_ms=int(_LEASE_S * 1000)),
                api.scheduler.KeepTaskAliveResponse, timeout=5.0)
            return list(resp.statuses)
        except RpcError as e:
            logger.warning("KeepTaskAlive failed: %s", e)
            return [False] * len(list(grant_ids))

    def stop(self, join_timeout_s: float = 5.0) -> None:
        """Stop all fetchers and wait (bounded) for their threads to
        exit.  Joining matters: a fetcher blocked in its long-poll lap
        exits within ~one lap, and callers (daemon shutdown, tests)
        must not strand live `grant-fetch-*` threads behind them.  Every
        queued grant is freed before this returns."""
        self._stopping.set()
        with self._lock:
            fetchers = list(self._fetchers.values())
            self._fetchers.clear()
        for f in fetchers:
            f.retired.set()
            f.wake.set()
            f.queue.close()
        deadline = time.monotonic() + join_timeout_s
        for f in fetchers:
            f.thread.join(timeout=max(0.0, deadline - time.monotonic()))
        for f in fetchers:
            f._drain_and_free(wait=True)
        with self._lock:
            chans, self._channels = list(self._channels.values()), {}
            self._closed = True
        for ch in chans:
            ch.close()

    # -- internals -----------------------------------------------------------

    def _chan(self, env_digest: str = "") -> Channel:
        """Channel to the env's home cell (empty digest = cell 0).
        Renew/free carry only grant ids, not digests; they go to cell 0
        and the federation router routes them home by the grant-id
        namespace — any cell can accept them."""
        cell = (int(self._ring.pick(env_digest))
                if self._ring is not None and env_digest else 0)
        with self._lock:
            if self._closed:
                raise RpcError(STATUS_TRANSPORT_FAILURE,
                               "the grant keeper has stopped")
            ch = self._channels.get(cell)
            if ch is None:
                ch = self._channels[cell] = Channel(self._cell_uris[cell])
            return ch

    def _fetch(self, env_digest: str, immediate: int, prefetch: int,
               tenant: str = ""):
        """One grant poll.  Returns (grants, flow_verdict,
        retry_after_s): flow_verdict is the scheduler's overload-ladder
        answer (FlowControlVerdict value, 0 = none) and retry_after_s
        its server-computed backoff hint."""
        req = api.scheduler.WaitForStartingTaskRequest(
            token=self._token,
            milliseconds_to_wait=_POLL_LAP_MS,
            immediate_reqs=immediate,
            prefetch_reqs=prefetch,
            next_keep_alive_in_ms=int(_LEASE_S * 1000),
            min_version=self._min_version,
        )
        req.env_desc.compiler_digest = env_digest
        if tenant and self._tenant_credential_fn is not None:
            try:
                req.tenant_credential = self._tenant_credential_fn(tenant)
            except Exception:
                # No mintable window token right now: send no
                # credential and let the scheduler fail closed rather
                # than killing the fetch loop.
                logger.warning("could not mint credential for tenant %r",
                               tenant)
        try:
            resp, _ = self._chan(env_digest).call(
                "ytpu.SchedulerService", "WaitForStartingTask", req,
                api.scheduler.WaitForStartingTaskResponse,
                timeout=_POLL_LAP_MS / 1000.0 + _RPC_TIMEOUT_MARGIN_S)
            return ([(g.task_grant_id, g.servant_location)
                     for g in resp.grants],
                    resp.flow_control, resp.retry_after_ms / 1000.0)
        except RpcError:
            return [], 0, 0.0

    def _free_now(self, grant_ids) -> None:
        with self._lock:
            closed = self._closed
        # Once stop() has closed the keeper's channels, on a channel of
        # its own that is closed here.
        ch = Channel(self._cell_uris[0]) if closed else None
        try:
            (ch or self._chan()).call(
                "ytpu.SchedulerService", "FreeTask",
                api.scheduler.FreeTaskRequest(
                    token=self._token, task_grant_ids=grant_ids),
                api.scheduler.FreeTaskResponse, timeout=5.0)
        except RpcError:
            pass  # lease expiry will reclaim it
        finally:
            if ch is not None:
                ch.close()

    def _free_async(self, grant_ids) -> None:
        if not grant_ids:
            return
        threading.Thread(target=self._free_now, args=(grant_ids,),
                         name="grant-free", daemon=True).start()
