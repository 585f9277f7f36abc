"""Two-level weighted-fair grant admission, delegate side (a copy of the
JAX package's yadcc_tpu/daemon/local/fair_admission.py).

The grant keeper used to hand grants to whichever waiter thread won the
``queue.Queue`` race — FIFO across *threads*, which under a `make -j500`
or an oversized-TU adversary is FIFO across *one client's* five hundred
threads: everyone else on the box starves.  This module replaces the
hand-out with stride scheduling over requestor keys: every client
carries a virtual pass; each grant goes to the waiting client with the
lowest pass, whose pass then advances by ``quantum / weight``.  Two
clients with equal weights therefore alternate no matter how many
waiter threads each parks, and a weight-2 client legitimately draws
twice the share.

Multi-tenant QoS adds a second stride level ABOVE the
client level: tenants share the grant stream by tenant weight, and
clients share *within* their tenant by client weight.  A tenant
flooding from 100 requestor pids advances its single tenant pass 100x
as fast — exactly the isolation a per-client-only stride cannot give
once one org controls many pids.  The client key also stops being
globally meaningful with tenancy on (a bare PID collides across hosts
once delegates multiplex tenants), so the tenant string partitions the
client table: the PID stays the *within-tenant* key.  The default ""
tenant is the shared legacy level — a queue used without tenants
degenerates to the original single-level scheduler, same grants in the
same order.

Properties the JAX package's tests assert (its test_robustness.py and
test_tenancy.py; tests/test_torch_daemon_local.py holds this copy's
hand-out order equal to it):

  * with an adversary submitting at 10x, every other client still
    receives >= 80% of its equal share — and the same at the tenant
    level with an adversary tenant fanning out over many pids;
  * an idle client (or tenant) returning does NOT burst accumulated
    credit — its pass is clamped to the current virtual time on
    arrival;
  * no grant is lost: items offered while a waiter times out stay in
    the backlog for the next waiter.

One instance per env fetcher; the lock is a leaf (nothing is called
out of it).
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional


class _Waiter:
    __slots__ = ("key", "weight", "item")

    def __init__(self, key: str, weight: float):
        self.key = key
        self.weight = weight
        self.item = None


class _Client:
    __slots__ = ("vpass", "waiters", "granted", "last_active")

    def __init__(self, vpass: float, now: float):
        self.vpass = vpass
        self.waiters: List[_Waiter] = []
        self.granted = 0
        self.last_active = now


class _Tenant:
    __slots__ = ("vpass", "weight", "clients", "vtime", "granted",
                 "last_active")

    def __init__(self, vpass: float, now: float):
        self.vpass = vpass
        self.weight = 1.0
        # Within-tenant client table + the tenant's own virtual time
        # (clients clamp against THEIR tenant's clock, not the global
        # one — a busy tenant must not launder credit to a client of an
        # idle tenant).
        self.clients: Dict[str, _Client] = {}
        self.vtime = vpass
        self.granted = 0
        self.last_active = now

    def has_waiters(self) -> bool:
        return any(c.waiters for c in self.clients.values())


class FairGrantQueue:
    """Weighted-fair item hand-out, tenant-then-client stride."""

    QUANTUM = 1024.0
    # Client/tenant records idle this long are dropped (their pass
    # history is clamped away on return anyway); bounds memory under
    # pid churn.
    CLIENT_TTL_S = 600.0

    def __init__(self, time_fn: Callable[[], float] = time.monotonic):
        self._time = time_fn
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._backlog: List = []  # guarded by: self._lock
        self._tenants: Dict[str, _Tenant] = {}  # guarded by: self._lock
        self._vtime = 0.0  # guarded by: self._lock
        self._closed = False  # guarded by: self._lock

    # -- producer ------------------------------------------------------------

    def put(self, item) -> None:
        with self._cond:
            self._backlog.append(item)
            self._match_locked()
            self._cond.notify_all()

    # -- consumer ------------------------------------------------------------

    def get(self, key: str = "", weight: float = 1.0,
            timeout_s: float = 10.0, tenant: str = "",
            tenant_weight: float = 1.0):
        """Block until this client is handed an item or the timeout
        lapses (returns None).  ``key`` identifies the client for
        within-tenant fairness; "" is a shared anonymous client.
        ``tenant`` selects the outer stride level; "" is the shared
        legacy tenant (single-level behavior)."""
        deadline = self._time() + timeout_s
        with self._cond:
            if self._closed:
                return None
            c = self._client_locked(tenant, tenant_weight, key)
            w = _Waiter(key, weight)
            c.waiters.append(w)
            # Registering may unblock OTHER waiters too (the backlog is
            # matched by fairness order, not arrival order): notify.
            self._match_locked()
            self._cond.notify_all()
            while w.item is None and not self._closed:
                remaining = deadline - self._time()
                if remaining <= 0:
                    break
                self._cond.wait(timeout=remaining)
            if w.item is None:
                # Timed out: deregister.  A racing put() matched under
                # this same lock, so w.item is authoritative here.
                if w in c.waiters:
                    c.waiters.remove(w)
                return None
            return w.item

    # -- introspection / lifecycle -------------------------------------------

    def qsize(self) -> int:
        with self._cond:
            return len(self._backlog)

    def waiter_count(self) -> int:
        with self._cond:
            return sum(len(c.waiters)
                       for t in self._tenants.values()
                       for c in t.clients.values())

    def close(self) -> None:
        """Stop matching: waiters return None, and every item offered
        from now on stays in the backlog for drain().  Used at fetcher
        retirement so a fetch that lands AFTER retire() hands its
        grants back to the scheduler instead of to a late waiter of a
        dead fetcher (who should re-register on a fresh one)."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    def drain(self) -> list:
        """Remove and return every unclaimed item (fetcher retirement:
        the grants go back to the scheduler)."""
        with self._cond:
            items, self._backlog = self._backlog, []
            return items

    def share_counts(self) -> Dict[str, int]:
        """Grants handed out per client key since construction — the
        fairness-dispersion measurement the scenario harness reports.
        Clients of the legacy "" tenant keep their bare keys (the
        pre-tenancy shape every caller knows); tenant clients report
        as "tenant/key"."""
        with self._cond:
            out: Dict[str, int] = {}
            for tname, t in self._tenants.items():
                for k, c in t.clients.items():
                    if c.granted:
                        out[f"{tname}/{k}" if tname else k] = c.granted
            return out

    def tenant_share_counts(self) -> Dict[str, int]:
        """Grants per tenant ("" = the shared legacy tenant)."""
        with self._cond:
            return {name: t.granted for name, t in self._tenants.items()
                    if t.granted}

    # -- locked internals ----------------------------------------------------

    def _client_locked(self, tenant: str, tenant_weight: float,
                       key: str) -> _Client:
        now = self._time()
        t = self._tenants.get(tenant)
        if t is None:
            if len(self._tenants) > 64:
                for name in [name for name, tl in self._tenants.items()
                             if not tl.has_waiters()
                             and now - tl.last_active > self.CLIENT_TTL_S]:
                    del self._tenants[name]
            t = self._tenants[tenant] = _Tenant(self._vtime, now)
        else:
            # Returning idle tenant: clamp to current virtual time so
            # accumulated "credit" from sitting out cannot burst.
            t.vpass = max(t.vpass, self._vtime)
        # Weight is re-stamped per call: the directory (not this queue)
        # owns tenant policy, and a weight change takes effect on the
        # tenant's next ask.
        t.weight = tenant_weight
        t.last_active = now
        c = t.clients.get(key)
        if c is None:
            if len(t.clients) > 256:
                for k in [k for k, cl in t.clients.items()
                          if not cl.waiters
                          and now - cl.last_active > self.CLIENT_TTL_S]:
                    del t.clients[k]
            c = t.clients[key] = _Client(t.vtime, now)
        else:
            # Same clamp at the client level, against the TENANT clock.
            c.vpass = max(c.vpass, t.vtime)
        c.last_active = now
        return c

    def _match_locked(self) -> None:
        if self._closed:
            return
        while self._backlog:
            bt: Optional[_Tenant] = None
            for t in self._tenants.values():
                if t.has_waiters() and (bt is None or t.vpass < bt.vpass):
                    bt = t
            if bt is None:
                return
            best: Optional[_Client] = None
            for c in bt.clients.values():
                if c.waiters and (best is None or c.vpass < best.vpass):
                    best = c
            w = best.waiters.pop(0)
            w.item = self._backlog.pop(0)
            # Advance both clocks: the grant costs the tenant one
            # weighted quantum of the global stream and the client one
            # weighted quantum of the tenant's stream.
            self._vtime = bt.vpass
            bt.vtime = best.vpass
            bt.vpass += self.QUANTUM / max(bt.weight, 1e-6)
            best.vpass += self.QUANTUM / max(w.weight, 1e-6)
            best.granted += 1
            bt.granted += 1
