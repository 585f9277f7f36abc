"""Deterministic interleaving explorer for the exactly-once lease path
(a copy of the JAX package's testing/interleave.py, pointed at the
port's scheduler).

It runs small issue/renew/free/takeover scenarios against the REAL
scheduler objects (scheduler/replication.py's LeaseJournal,
ReplicatingDispatcher and StandbyScheduler over task_dispatcher.py's
TaskDispatcher and policy.py's GreedyCpuPolicy) under a CHESS-style
one-thread-at-a-time sequencer, enumerates preemption-bounded thread
schedules exhaustively, and asserts the exactly-once invariants on
every schedule:

* every grant lives in exactly one registry (live dispatcher state ==
  the journal's replayed mirror; shard registries stay disjoint),
* journal sequence numbers are gapless and strictly monotone,
* no grant id is ever double-run (re-issued while a live incarnation
  exists).

Determinism comes from the same seam the lock-order tracer uses
(utils/locktrace.py): ``threading.Lock`` is swapped for a sequencer
proxy while a scenario is built and run, so every lock acquisition in
the scheduler becomes a scheduling point.  Exactly one scenario thread
executes at a time; at each scheduling point with more than one
runnable thread the sequencer consults a decision log, and the
explorer drives a DFS over those logs with a *preemption bound*:
switching away from a still-runnable thread costs one preemption,
switching at a block/finish is free.  Bound 2 (the CHESS result: most
concurrency bugs need very few preemptions) keeps the schedule space
small enough to sweep exhaustively at this scenario size.

Scenario constraints (why this stays deterministic):

* Dispatchers are built with ``start_dispatch_thread=False``: no
  background cycle thread exists, ``submit_wait_for_starting_new_task``
  purely enqueues (inline leading is off in this mode), and grants are
  issued only when a scenario thread explicitly runs
  ``run_dispatch_cycle_for_testing()``.  Parked continuations fire via
  ``_fire_async_done`` on the cycling thread.
* Only non-blocking APIs appear in thread bodies; the sequencer's
  try-acquire protocol means a schedule can never wedge on a real lock
  (a true deadlock is DETECTED (no ready thread while some are
  blocked) and reported, not hung on).
* The VirtualClock is constructed BEFORE the patch window so its
  internal lock stays a real lock and clock reads are not scheduling
  points.

Teeth are proven by seeded mutants (``MUTANTS``): a dropped journal
lock, a journal-before-commit reorder, a skipped sequence number, a
skipped adoption window, and a non-advancing grant-id counter after
adoption.  Each must produce an invariant violation on some explored
schedule; ``--smoke`` requires a clean sweep of the real scenarios
plus the killed canaries.  It runs on the host only: the greedy policy
launches nothing on the card.

Usage::

    python -m yadcc_tpu_torch.testing.interleave --smoke
    python -m yadcc_tpu_torch.testing.interleave --max-runs 400 --json
"""

from __future__ import annotations

import dataclasses
import json
import sys
import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple

_REAL_LOCK = threading.Lock  # captured pre-patch; the sequencer's own
_REAL_RLOCK = threading.RLock  # machinery must never hit its own seam


class _InjectedFault(Exception):
    """Raised by mutants that inject a failure mid-operation; scenario
    bodies catch exactly this type so the invariant checkers — not the
    stray exception — are what kills the mutant."""


class _Abort(BaseException):
    """Unwinds scenario threads when the sequencer stops a run early
    (deadlock detected).  BaseException so ordinary ``except
    Exception`` handlers in framework code cannot swallow it."""


# --------------------------------------------------------------------------
# Sequencer: one thread at a time, decisions replayed from a log.
# --------------------------------------------------------------------------


class Sequencer:
    """Cooperative scheduler for a fixed set of scenario threads.

    Threads run on real ``threading.Thread``s but hand control back at
    every scheduling point (lock acquire, explicit ``checkpoint()``);
    the sequencer lets exactly one proceed.  Decisions (which thread
    runs next when several are runnable) replay from ``decisions``;
    past the end of the log the DEFAULT choice is taken — continue the
    last-running thread when still runnable (zero preemptions), else
    the lowest-named runnable — and every point's full option set is
    recorded in ``log`` for the explorer to branch on.
    """

    def __init__(self, decisions: Sequence[str],
                 preemption_bound: int) -> None:
        self._cv = threading.Condition(_REAL_LOCK())
        self._decisions = list(decisions)
        self._bound = preemption_bound
        self._state: Dict[str, str] = {}  # name -> ready|blocked|done
        self._blocked_on: Dict[str, int] = {}  # name -> id(lock)
        self._tids: Dict[int, str] = {}  # thread ident -> name
        self._current: Optional[str] = None  # whose turn; None = scheduler
        self._aborting = False
        self._last_running: Optional[str] = None
        self._preemptions = 0
        # (chosen, runnable-set, last_running, preemptions-before)
        self.log: List[Tuple[str, Tuple[str, ...], Optional[str], int]] = []
        self.errors: List[str] = []

    # -- worker side -------------------------------------------------------

    def current_worker(self) -> Optional[str]:
        return self._tids.get(threading.get_ident())

    def worker_main(self, name: str, fn: Callable[[], None]) -> None:
        with self._cv:
            self._tids[threading.get_ident()] = name
            self._state[name] = "ready"
            self._cv.notify_all()
            while self._current != name:
                if self._aborting:
                    self._finish_locked(name)
                    return
                self._cv.wait()
        try:
            fn()
        except _InjectedFault as exc:
            self.errors.append(f"thread {name}: uncaught injected "
                               f"fault {exc!r}")
        except _Abort:
            pass
        except BaseException as exc:  # real defect surfaced mid-schedule
            self.errors.append(f"thread {name} raised {exc!r}")
        finally:
            with self._cv:
                self._finish_locked(name)

    def _finish_locked(self, name: str) -> None:
        self._state[name] = "done"
        if self._current == name:
            self._current = None
        self._cv.notify_all()

    def yield_point(self) -> None:
        """Hand control to the scheduler and wait to be picked again."""
        me = self.current_worker()
        if me is None:
            return
        with self._cv:
            self._current = None
            self._cv.notify_all()
            while self._current != me:
                if self._aborting:
                    raise _Abort()
                self._cv.wait()

    def block_on(self, lock_id: int) -> None:
        """Like yield_point but parks as blocked; the scheduler will
        not pick this thread until ``unblock(lock_id)``."""
        me = self.current_worker()
        if me is None:
            return
        with self._cv:
            self._state[me] = "blocked"
            self._blocked_on[me] = lock_id
            self._current = None
            self._cv.notify_all()
            while self._current != me:
                if self._aborting:
                    raise _Abort()
                self._cv.wait()

    def unblock(self, lock_id: int) -> None:
        with self._cv:
            for name, lid in list(self._blocked_on.items()):
                if lid == lock_id:
                    del self._blocked_on[name]
                    if self._state.get(name) == "blocked":
                        self._state[name] = "ready"
            self._cv.notify_all()

    # -- scheduler side ----------------------------------------------------

    def run(self, n_threads: int) -> None:
        with self._cv:
            while len(self._state) < n_threads:
                self._cv.wait()
            while True:
                while self._current is not None:
                    self._cv.wait()
                ready = sorted(n for n, s in self._state.items()
                               if s == "ready")
                if not ready:
                    if all(s == "done" for s in self._state.values()):
                        return
                    waiters = sorted(n for n, s in self._state.items()
                                     if s == "blocked")
                    self.errors.append(
                        "deadlock: no runnable thread; blocked: "
                        + ", ".join(waiters))
                    self._aborting = True
                    self._cv.notify_all()
                    while not all(s == "done"
                                  for s in self._state.values()):
                        self._cv.wait()
                    return
                if len(ready) == 1:
                    chosen = ready[0]  # forced move: not a decision point
                else:
                    chosen = self._choose_locked(ready)
                if (self._last_running is not None
                        and self._last_running in ready
                        and chosen != self._last_running):
                    self._preemptions += 1
                self._last_running = chosen
                self._current = chosen
                self._cv.notify_all()

    def _choose_locked(self, ready: List[str]) -> str:
        idx = len(self.log)
        if idx < len(self._decisions) and self._decisions[idx] in ready:
            chosen = self._decisions[idx]
        elif (self._last_running is not None
              and self._last_running in ready):
            chosen = self._last_running
        else:
            chosen = ready[0]
        self.log.append((chosen, tuple(ready), self._last_running,
                         self._preemptions))
        return chosen


_ACTIVE: Optional[Sequencer] = None


def checkpoint() -> None:
    """Explicit scheduling seam: a no-op outside a sequencer run, a
    yield point for managed threads inside one.  Mutants use it to
    expose read-modify-write windows; instrumented code may too."""
    seq = _ACTIVE
    if seq is not None:
        seq.yield_point()


class _SchedLock:
    """``threading.Lock`` replacement making acquisition a scheduling
    point.  Managed threads yield to the sequencer before every
    acquire and park (sequencer-side, never on the real lock) when the
    lock is held; unmanaged threads (scenario setup on the main
    thread) pass straight through.  Duck-types what
    ``threading.Condition`` probes, mirroring locktrace._TracedLock."""

    def __init__(self, seq: Sequencer):
        self._seq = seq
        self._inner = _REAL_LOCK()
        self._owner: Optional[int] = None

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        seq = self._seq
        me = seq.current_worker()
        if me is None:
            ok = self._inner.acquire(blocking, timeout)
        elif not blocking:
            seq.yield_point()
            ok = self._inner.acquire(False)
        else:
            while True:
                seq.yield_point()
                if self._inner.acquire(False):
                    ok = True
                    break
                if self._owner == threading.get_ident():
                    raise RuntimeError(
                        "self-deadlock: re-acquiring a held Lock")
                seq.block_on(id(self))
        if ok:
            self._owner = threading.get_ident()
        return ok

    def release(self) -> None:
        self._owner = None
        self._inner.release()
        self._seq.unblock(id(self))

    def locked(self) -> bool:
        return self._inner.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    # threading.Condition probes these when present.
    def _is_owned(self) -> bool:
        return self._owner == threading.get_ident()

    def _acquire_restore(self, state) -> None:
        self.acquire()

    def _release_save(self):
        self.release()
        return None


class _patched:
    """Scoped swap of ``threading.Lock`` for sequencer proxies.  RLock
    is left real: no framework state on the scenario paths uses one,
    and Condition-over-RLock under a cooperative scheduler adds noise
    without coverage."""

    def __init__(self, seq: Sequencer):
        self._seq = seq

    def __enter__(self):
        global _ACTIVE
        _ACTIVE = self._seq
        threading.Lock = lambda: _SchedLock(self._seq)  # type: ignore[misc]
        return self

    def __exit__(self, *exc) -> None:
        global _ACTIVE
        threading.Lock = _REAL_LOCK  # type: ignore[misc]
        _ACTIVE = None


# --------------------------------------------------------------------------
# Invariant checkers (run post-schedule, outside the patch window).
# --------------------------------------------------------------------------


def journal_violations(journal) -> List[str]:
    """Gapless + strictly monotone sequence numbers; per-grant
    issue/free alternation (an issue while the previous incarnation is
    still live is a double-run)."""
    out: List[str] = []
    snapshot, snap_seq, entries = journal.since(0)
    seqs = [s for s, _ in entries]
    base = snap_seq if snapshot is not None else 0
    if any(b <= a for a, b in zip(seqs, seqs[1:])):
        out.append(f"journal seqs not strictly monotone: {seqs}")
    elif seqs and seqs != list(range(base + 1, base + 1 + len(seqs))):
        out.append(
            f"journal seq gap: expected contiguous from {base + 1}, "
            f"got {seqs}")
    live: Dict[int, str] = {}  # gid -> issuing location
    for _seq, entry in entries:
        op = entry.get("op")
        if op == "issue":
            for gid, loc in entry["grants"]:
                if gid in live:
                    out.append(f"grant {gid} double-issued (still live "
                               f"on {live[gid]})")
                live[gid] = loc
        elif op == "free":
            for gid in entry["ids"]:
                live.pop(gid, None)
        elif op == "servant_leave":
            loc = entry["location"]
            for gid in [g for g, l in live.items() if l == loc]:
                del live[gid]
    return out


def mirror_violations(journal, dispatcher, label: str = "") -> List[str]:
    """Replay the journal into a fresh ReplicaState and diff against
    the dispatcher's live grant registry: a grant must live in BOTH
    (exactly-once) or NEITHER (freed everywhere)."""
    from ..scheduler.replication import ReplicaState

    state = ReplicaState()
    snapshot, _snap_seq, entries = journal.since(0)
    if snapshot is not None:
        state = ReplicaState.from_json(snapshot)
    for seq, entry in entries:
        state.apply(seq, entry)
    live = set(dispatcher._grants)
    mirror = set(state.grants)
    out: List[str] = []
    tag = f" [{label}]" if label else ""
    for gid in sorted(live - mirror):
        out.append(f"grant {gid} live but absent from the journal "
                   f"mirror{tag} (unjournaled issue or lost append)")
    for gid in sorted(mirror - live):
        out.append(f"grant {gid} in the journal mirror but not live"
                   f"{tag} (journaled op the dispatcher never ran)")
    return out


# --------------------------------------------------------------------------
# Scenarios.
# --------------------------------------------------------------------------

_ENV = "deadbeef" * 8


def _make_servant(location: str):
    from ..scheduler.task_dispatcher import ServantInfo

    mem = 64 << 30
    return ServantInfo(location=location, version=1, num_processors=32,
                       capacity=16, total_memory=mem,
                       memory_available=mem, env_digests=(_ENV,))


def _new_dispatcher(clock, *, start: int = 1, stride: int = 1):
    from ..scheduler.policy import GreedyCpuPolicy
    from ..scheduler.task_dispatcher import TaskDispatcher

    return TaskDispatcher(
        GreedyCpuPolicy(), max_servants=8, max_envs=8, clock=clock,
        batch_window_s=0.0, start_dispatch_thread=False,
        grant_id_start=start, grant_id_stride=stride)


def _issue_one(rd, sink: List[Tuple[int, str]]) -> None:
    """Enqueue one request and run a cycle; issued pairs land in
    ``sink``.  Non-blocking throughout (manual-cycle mode)."""
    rd.submit_wait_for_starting_new_task(
        _ENV, requestor="interleave", lease_s=30.0, timeout_s=30.0,
        on_done=sink.extend)
    rd.run_dispatch_cycle_for_testing()


class Scenario:
    """One concurrency scenario: build state, expose thread bodies,
    check invariants after the schedule ran to completion."""

    name = "?"
    mutations: Tuple[str, ...] = ()

    def build(self, clock, mutation: Optional[str]) -> dict:
        raise NotImplementedError

    def threads(self, ctx: dict) -> List[Tuple[str, Callable[[], None]]]:
        raise NotImplementedError

    def check(self, ctx: dict) -> List[str]:
        raise NotImplementedError


class IssueRenewFree(Scenario):
    """Concurrent issue (submit + explicit cycle) against renew + free
    of an already-journaled grant, through ReplicatingDispatcher."""

    name = "issue_renew_free"
    mutations = ("journal-gap", "dropped-lock", "reordered-append")

    def build(self, clock, mutation: Optional[str]) -> dict:
        from ..scheduler.replication import (LeaseJournal,
                                             ReplicatingDispatcher)

        journal = LeaseJournal()
        rd = ReplicatingDispatcher(_new_dispatcher(clock), journal)
        rd.keep_servant_alive(_make_servant("10.0.0.1:8336"), 60.0)
        pre: List[Tuple[int, str]] = []
        _issue_one(rd, pre)  # setup runs unmanaged: deterministic
        assert pre, "setup issue must succeed"
        if mutation == "journal-gap":
            _mutate_journal_gap(journal)
        elif mutation == "dropped-lock":
            _mutate_dropped_lock(journal)
        elif mutation == "reordered-append":
            _mutate_reordered_append(rd)
        return {"journal": journal, "rd": rd, "g0": pre[0][0],
                "issued": []}

    def threads(self, ctx: dict):
        rd, g0 = ctx["rd"], ctx["g0"]

        def issuer():
            _issue_one(rd, ctx["issued"])

        def renewer():
            rd.keep_task_alive([g0], 30.0)
            try:
                rd.free_task([g0])
            except _InjectedFault:
                pass  # the invariant checkers judge the aftermath

        return [("t1-issue", issuer), ("t2-renew-free", renewer)]

    def check(self, ctx: dict) -> List[str]:
        out = journal_violations(ctx["journal"])
        out += mirror_violations(ctx["journal"], ctx["rd"].inner)
        if len(ctx["issued"]) != 1:
            out.append(f"issuer expected exactly one grant, got "
                       f"{ctx['issued']}")
        return out


class ShardNamespaces(Scenario):
    """Two shard dispatchers with interleaved grant-id namespaces
    (start 1 and 2, stride 2) issuing concurrently: ids must stay on
    their shard's residue and never land in both registries."""

    name = "shard_namespaces"
    mutations = ()

    def build(self, clock, mutation: Optional[str]) -> dict:
        from ..scheduler.replication import (LeaseJournal,
                                             ReplicatingDispatcher)

        shards = []
        for k in (1, 2):
            journal = LeaseJournal()
            rd = ReplicatingDispatcher(
                _new_dispatcher(clock, start=k, stride=2), journal)
            rd.keep_servant_alive(
                _make_servant(f"10.0.{k}.1:8336"), 60.0)
            shards.append({"rd": rd, "journal": journal, "start": k,
                           "issued": []})
        return {"shards": shards}

    def threads(self, ctx: dict):
        bodies = []
        for shard in ctx["shards"]:
            def body(shard=shard):
                _issue_one(shard["rd"], shard["issued"])
                _issue_one(shard["rd"], shard["issued"])
            bodies.append((f"shard{shard['start']}", body))
        return bodies

    def check(self, ctx: dict) -> List[str]:
        out: List[str] = []
        registries = []
        for shard in ctx["shards"]:
            out += journal_violations(shard["journal"])
            out += mirror_violations(shard["journal"],
                                     shard["rd"].inner,
                                     f"shard{shard['start']}")
            gids = set(shard["rd"].inner._grants)
            registries.append(gids)
            bad = [g for g in gids if g % 2 != shard["start"] % 2]
            if bad:
                out.append(f"shard{shard['start']} holds off-residue "
                           f"grant ids {bad}")
            if len(shard["issued"]) != 2:
                out.append(f"shard{shard['start']} expected 2 grants, "
                           f"got {shard['issued']}")
        both = registries[0] & registries[1]
        if both:
            out.append(f"grant ids {sorted(both)} live in BOTH shard "
                       "registries")
        return out


class Takeover(Scenario):
    """Journal shipping races the standby's freeze/replay/adopt/window
    sequence; a journal-gap grant re-reported by its servant must be
    adopted, and post-takeover issues must not collide with adopted
    ids."""

    name = "takeover"
    mutations = ("double-issue", "window-regression")

    def build(self, clock, mutation: Optional[str]) -> dict:
        from ..scheduler.replication import (LeaseJournal,
                                             ReplicatingDispatcher,
                                             StandbyScheduler)

        journal = LeaseJournal()
        active = ReplicatingDispatcher(_new_dispatcher(clock), journal)
        loc = "10.0.0.1:8336"
        active.keep_servant_alive(_make_servant(loc), 60.0)
        pre: List[Tuple[int, str]] = []
        _issue_one(active, pre)  # journaled grant
        gap: List[Tuple[int, str]] = []
        _issue_one(active.inner, gap)  # bypasses journaling: the tail
        #                                the dead active never shipped
        assert pre and gap
        standby = StandbyScheduler(clock=clock)
        ctx = {"journal": journal, "active": active, "loc": loc,
               "clock": clock, "standby": standby,
               "g_journaled": pre[0][0], "g_gap": gap[0][0],
               "mutation": mutation, "kill": None, "issued_after": [],
               "report": None}
        return ctx

    def threads(self, ctx: dict):
        from .. import api

        journal, standby = ctx["journal"], ctx["standby"]
        clock, loc = ctx["clock"], ctx["loc"]
        mutation = ctx["mutation"]

        def ship():
            # JournalStreamer.flush_once without the network: same
            # request shape, delivered straight into the receiver.
            snapshot, snap_seq, entries = journal.since(0)
            req = api.scheduler.ReplicateRequest(
                token="",
                first_seq=entries[0][0] if entries else 0,
                entries_json=json.dumps(entries).encode(),
                snapshot_json=(snapshot or "").encode(),
                snapshot_seq=snap_seq)
            standby.receiver.Replicate(req, None, None)

        def take_over():
            def factory():
                d = _new_dispatcher(clock)
                if mutation == "double-issue":
                    d._advance_grant_id_locked = lambda gid: None
                elif mutation == "window-regression":
                    d.set_adoption_window = \
                        lambda floor, grace_s, **kw: None
                return d

            ctx["report"] = standby.takeover(factory, grace_s=60.0)
            new_d = standby.dispatcher
            new_d.keep_servant_alive(_make_servant(loc), 60.0)
            ctx["kill"] = new_d.notify_servant_running_tasks(
                loc, [ctx["g_journaled"], ctx["g_gap"]])
            _issue_one(new_d, ctx["issued_after"])

        return [("t1-ship", ship), ("t2-takeover", take_over)]

    def check(self, ctx: dict) -> List[str]:
        out: List[str] = []
        new_d = ctx["standby"].dispatcher
        if new_d is None:
            return ["takeover never completed"]
        live = set(new_d._grants)
        for tag, gid in (("journaled", ctx["g_journaled"]),
                         ("journal-gap", ctx["g_gap"])):
            if gid not in live:
                out.append(f"{tag} grant {gid} lost in takeover "
                           "(zero registries)")
        if ctx["kill"]:
            out.append(f"takeover killed live work: {ctx['kill']}")
        fresh = {gid for gid, _ in ctx["issued_after"]}
        collide = fresh & {ctx["g_journaled"], ctx["g_gap"]}
        if collide:
            out.append(f"post-takeover issue re-minted adopted grant "
                       f"ids {sorted(collide)} (double-run)")
        if len(ctx["issued_after"]) != 1:
            out.append("post-takeover issue expected exactly one "
                       f"grant, got {ctx['issued_after']}")
        return out


# --------------------------------------------------------------------------
# Seeded mutants (each must be killed on some explored schedule).
# --------------------------------------------------------------------------


def _mutate_journal_gap(journal) -> None:
    """Skip a sequence number on the second append: the bug a broken
    compaction or a lost in-flight append would leave behind."""
    real_append = journal.append
    n = [0]

    def append(entry):
        n[0] += 1
        if n[0] == 2:
            with journal._lock:
                journal._next_seq += 1
        return real_append(entry)

    journal.append = append


def _mutate_dropped_lock(journal) -> None:
    """Reimplement append WITHOUT the journal lock, with a checkpoint
    inside the read-modify-write window: only a schedule that preempts
    between the read and the write produces the duplicate seq.  This
    is the mutant that proves the EXPLORER has teeth, not just the
    checkers."""

    def append(entry):
        seq = journal._next_seq
        checkpoint()  # the window a real lock would close
        journal._next_seq = seq + 1
        journal._entries.append((seq, entry))
        return seq

    journal.append = append


def _mutate_reordered_append(rd) -> None:
    """Journal the free BEFORE the inner commit, then fail the commit:
    the mirror frees a grant the dispatcher still runs: exactly the
    divergence the rule "journal after the inner commit"
    (ReplicatingDispatcher) exists to forbid."""

    def free_task(grant_ids):
        if grant_ids:
            rd._journal.append({"op": "free", "ids": list(grant_ids)})
        raise _InjectedFault("inner free_task failed after journaling")

    rd.free_task = free_task


@dataclasses.dataclass
class ExploreResult:
    scenario: str
    mutation: Optional[str]
    runs: int
    violation: Optional[str]
    schedule: Optional[List[str]]  # decision log that produced it


def _run_once(scenario: Scenario, mutation: Optional[str],
              decisions: Sequence[str], bound: int):
    from ..utils.clock import VirtualClock

    clock = VirtualClock(start=100.0)  # pre-patch: its lock stays real
    seq = Sequencer(decisions, bound)
    with _patched(seq):
        ctx = scenario.build(clock, mutation)
        bodies = scenario.threads(ctx)
        workers = [
            threading.Thread(target=seq.worker_main, args=(name, fn),
                             daemon=True, name=f"ileave-{name}")
            for name, fn in bodies
        ]
        for w in workers:
            w.start()
        seq.run(len(bodies))
        for w in workers:
            w.join(timeout=10.0)
    violations = list(seq.errors) + scenario.check(ctx)
    return seq, violations


def explore(scenario: Scenario, *, mutation: Optional[str] = None,
            preemption_bound: int = 2, max_runs: int = 400
            ) -> ExploreResult:
    """DFS over decision logs.  Each run replays a prefix and extends
    it with default choices; every decision point past the prefix
    spawns sibling prefixes for the untried runnable threads, pruned
    by the preemption bound.  Stops at the first violating schedule or
    when the bounded space (or the run cap) is exhausted."""
    frontier: List[List[str]] = [[]]
    runs = 0
    while frontier and runs < max_runs:
        prefix = frontier.pop()
        seq, violations = _run_once(scenario, mutation, prefix,
                                    preemption_bound)
        runs += 1
        if violations:
            return ExploreResult(
                scenario=scenario.name, mutation=mutation, runs=runs,
                violation="; ".join(violations),
                schedule=[c for c, _, _, _ in seq.log])
        for i in range(len(prefix), len(seq.log)):
            chosen, ready, last, preempt_before = seq.log[i]
            for alt in ready:
                if alt == chosen:
                    continue
                cost = preempt_before + (
                    1 if last is not None and last in ready
                    and alt != last else 0)
                if cost > preemption_bound:
                    continue
                frontier.append(
                    [c for c, _, _, _ in seq.log[:i]] + [alt])
    return ExploreResult(scenario=scenario.name, mutation=mutation,
                         runs=runs, violation=None, schedule=None)


SCENARIOS: Tuple[Scenario, ...] = (IssueRenewFree(), ShardNamespaces(),
                                   Takeover())

MUTANTS: Tuple[Tuple[str, str], ...] = tuple(
    (s.name, m) for s in SCENARIOS for m in s.mutations)

_SMOKE_MUTANTS = (("issue_renew_free", "dropped-lock"),
                  ("takeover", "window-regression"))


def run_suite(*, preemption_bound: int = 2, max_runs: int = 400,
              smoke: bool = False) -> dict:
    """Sweep every scenario clean, then confirm the seeded mutants die.
    ``smoke`` trims the run cap and the mutant list to a gate's budget
    while keeping one schedule-dependent canary (dropped-lock)."""
    import logging

    # Hundreds of schedules re-run takeover; its per-call INFO report
    # would drown the sweep's own output.
    logging.getLogger("scheduler.replication").setLevel(logging.WARNING)
    by_name = {s.name: s for s in SCENARIOS}
    cap = min(max_runs, 120) if smoke else max_runs
    report = {"preemption_bound": preemption_bound, "max_runs": cap,
              "scenarios": {}, "mutants": {}, "ok": True}
    for scenario in SCENARIOS:
        res = explore(scenario, preemption_bound=preemption_bound,
                      max_runs=cap)
        report["scenarios"][scenario.name] = {
            "runs": res.runs, "violation": res.violation,
            "schedule": res.schedule}
        if res.violation:
            report["ok"] = False
    for sname, mutation in (_SMOKE_MUTANTS if smoke else MUTANTS):
        res = explore(by_name[sname], mutation=mutation,
                      preemption_bound=preemption_bound, max_runs=cap)
        report["mutants"][f"{sname}:{mutation}"] = {
            "runs": res.runs, "killed": res.violation is not None,
            "violation": res.violation, "schedule": res.schedule}
        if res.violation is None:
            report["ok"] = False
    return report


def main(argv: Optional[Sequence[str]] = None) -> int:
    import argparse

    parser = argparse.ArgumentParser(
        prog="python -m yadcc_tpu_torch.testing.interleave",
        description="Exhaustive preemption-bounded interleaving sweep "
                    "of the exactly-once lease scenarios.")
    parser.add_argument("--smoke", action="store_true",
                        help="gate budget: trimmed run cap + two canary "
                             "mutants")
    parser.add_argument("--bound", type=int, default=2,
                        help="preemption bound (default 2)")
    parser.add_argument("--max-runs", type=int, default=400,
                        help="schedule cap per scenario (default 400)")
    parser.add_argument("--json", action="store_true",
                        help="emit the full report as JSON")
    args = parser.parse_args(argv)

    report = run_suite(preemption_bound=args.bound,
                       max_runs=args.max_runs, smoke=args.smoke)
    if args.json:
        print(json.dumps(report, indent=2))
    else:
        for name, r in report["scenarios"].items():
            status = ("CLEAN" if not r["violation"]
                      else f"VIOLATION: {r['violation']}")
            print(f"scenario {name}: {r['runs']} schedule(s), {status}")
        for name, r in report["mutants"].items():
            status = ("killed in %d run(s)" % r["runs"] if r["killed"]
                      else "SURVIVED (explorer has no teeth!)")
            print(f"mutant {name}: {status}")
    clean = all(not r["violation"]
                for r in report["scenarios"].values())
    killed = [r for r in report["mutants"].values() if r["killed"]]
    ok = clean and len(killed) == len(report["mutants"])
    if not ok:
        print("interleave: FAILED", file=sys.stderr)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
