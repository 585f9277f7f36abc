"""Lock-order tracing (a copy of the JAX package's utils/locktrace.py).

CPython has no TSan, so this module makes the lock-ordering convention
checkable: while installed, every `threading.Lock()` /
`threading.RLock()` constructed is wrapped in a traced proxy, and every
acquisition records an edge from each lock the acquiring thread already
holds to the new one.  A cycle in that order graph is a
potential-deadlock (ABBA) pattern even if the interleaving never
actually deadlocked during the run: the same happens-before
generalization TSan's lock-order checker uses.

Usage (tests: tests/test_torch_locktrace.py):

    with locktrace.installed() as graph:
        ... construct components, hammer them from threads ...
    assert locktrace.framework_violations(graph) == []

Production opt-in: set YTPU_LOCKTRACE=1 before starting any of the
three entry points (scheduler, cache server, daemon); violations are
logged once to stderr at exit and `/inspect/vars` shows
`yadcc/locktrace`.  The module imports no torch.

Scope notes:
- Installation swaps the *factories* on the `threading` module, so only
  locks constructed while installed are traced; locks created by other
  libraries during that window (torch's, during a lazy CUDA init or in
  the profiler) are traced too, which is harmless (they simply add
  nodes): `framework_violations` keeps only cycles through a lock this
  package built.
- `threading.Condition` works with traced locks: it duck-types on
  acquire/release and falls back to `acquire(0)`-probing for
  `_is_owned`, both of which the proxy provides.
- Overhead is one dict update per acquire on a per-thread structure and
  one bounded graph probe per *new* edge, so stress tests stay fast.
"""

from __future__ import annotations

import contextlib
import os
import sys
import threading
from typing import Dict, List, Optional, Set, Tuple

_real_lock = threading.Lock
_real_rlock = threading.RLock


class LockGraph:
    """Directed lock-order graph with immediate cycle detection.

    All state (including per-thread held stacks) lives under one
    internal real lock: held stacks are keyed by thread id rather than
    thread-local so a handoff-style release from a *different* thread
    (legal for threading.Lock, used by stdlib internals) can repair the
    acquirer's stack instead of leaving a phantom entry that would
    manufacture false cycles.  Growth is bounded: a proxy's GC prunes
    its node, and a hard edge cap saturates the graph (reported in
    inspect()) rather than letting the cycle probe degrade forever in
    a long-lived traced process."""

    MAX_EDGES = 100_000

    def __init__(self) -> None:
        import collections

        self._g = _real_lock()  # guards the graph itself (never traced)
        self._edges: Dict[str, Set[str]] = {}  # guarded by: self._g
        # Reverse index: O(degree) pruning of GC'd nodes.
        self._preds: Dict[str, Set[str]] = {}  # guarded by: self._g
        self._edge_sites: Dict[Tuple[str, str], str] = \
            {}  # guarded by: self._g
        self.violations: List[str] = []  # guarded by: self._g
        self._reported: Set[Tuple[str, ...]] = set()  # guarded by: self._g
        self._stacks: Dict[int, List[str]] = {}  # guarded by: self._g
        self._n_edges = 0  # guarded by: self._g
        self.saturated = False  # guarded by: self._g
        # GC'd proxies queue their names here (deque.append is atomic,
        # so __del__ — which can fire mid-note_acquired via GC — never
        # touches _g); pruning happens at the next traced event.
        self._dead = collections.deque()

    # -- events ----------------------------------------------------------

    def note_acquired(self, name: str, site: str) -> None:
        tid = threading.get_ident()
        with self._g:
            while self._dead:
                self._forget_locked(self._dead.popleft())
            held = self._stacks.setdefault(tid, [])
            if name in held:
                # RLock re-entry: re-acquiring an owned lock can never
                # deadlock, so it adds NO ordering constraint — not
                # even from other locks acquired in between (recording
                # held->name here would turn the legal pattern
                # `with r: with a: with r:` into a bogus cycle).
                held.append(name)
                return
            for prev in held:
                succ = self._edges.setdefault(prev, set())
                if name not in succ:
                    if self._n_edges >= self.MAX_EDGES:
                        self.saturated = True
                        continue
                    succ.add(name)
                    self._preds.setdefault(name, set()).add(prev)
                    self._n_edges += 1
                    self._edge_sites[(prev, name)] = site
                    cycle = self._find_cycle_locked(name, prev)
                    if cycle is not None:
                        self._report_locked(cycle)
            held.append(name)

    def note_released(self, name: str, owner_tid: Optional[int] = None
                      ) -> None:
        """`owner_tid`: the thread that ACQUIRED the lock (the proxy
        remembers it) — a Lock may legally be released by any thread,
        and the stack to repair is the acquirer's."""
        tid = owner_tid if owner_tid is not None else threading.get_ident()
        with self._g:
            held = self._stacks.get(tid)
            if not held:
                return
            # Remove the most recent matching entry: release order need
            # not be LIFO (that by itself is not a violation).
            for i in range(len(held) - 1, -1, -1):
                if held[i] == name:
                    del held[i]
                    break
            if not held:
                del self._stacks[tid]

    def forget_later(self, name: str) -> None:
        """GC hook: NO locking here — __del__ may run at any allocation
        point, including while this thread already holds _g."""
        self._dead.append(name)

    def forget(self, name: str) -> None:
        with self._g:
            self._forget_locked(name)

    def _forget_locked(self, name: str) -> None:
        """Prune a garbage-collected lock's node (bounded growth for
        per-connection / per-task locks in long-lived processes).
        Already-reported violations keep their rendered strings."""
        out = self._edges.pop(name, None)
        if out:
            self._n_edges -= len(out)
            for b in out:
                self._edge_sites.pop((name, b), None)
                preds_b = self._preds.get(b)
                if preds_b is not None:
                    preds_b.discard(name)
        for a in self._preds.pop(name, ()):
            succ = self._edges.get(a)
            if succ is not None and name in succ:
                succ.discard(name)
                self._n_edges -= 1
                self._edge_sites.pop((a, name), None)

    # -- cycle machinery (graph lock held) -------------------------------

    def _find_cycle_locked(self, src: str, dst: str
                           ) -> Optional[List[str]]:
        """Path src->...->dst would close a cycle with the new dst->src
        edge; returns the node list if one exists."""
        stack = [(src, [src])]
        seen = {src}
        while stack:
            node, path = stack.pop()
            if node == dst:
                return path
            for nxt in self._edges.get(node, ()):
                if nxt not in seen:
                    seen.add(nxt)
                    stack.append((nxt, path + [nxt]))
        return None

    def _report_locked(self, cycle: List[str]) -> None:
        key = tuple(sorted(cycle))
        if key in self._reported:
            return
        self._reported.add(key)
        hops = []
        for a, b in zip(cycle, cycle[1:] + cycle[:1]):
            site = self._edge_sites.get((a, b), "?")
            hops.append(f"{a} -> {b} (at {site})")
        self.violations.append(
            "lock-order cycle: " + "; ".join(hops))

    def inspect(self) -> dict:
        with self._g:
            return {
                "locks": sorted(
                    set(self._edges) | {b for s in self._edges.values()
                                        for b in s}),
                "edges": sum(len(s) for s in self._edges.values()),
                "saturated": self.saturated,
                "violations": list(self.violations),
            }


class _TracedLock:
    """Proxy satisfying the Lock/RLock duck type.

    The reporting graph is resolved PER EVENT from the active layer
    (not captured at construction): a lock born inside a scoped
    installed() window but outliving it must report to the ambient
    layer afterwards, or its orderings silently vanish from the
    operator's process-wide tracing.  Each acquisition remembers which
    graph recorded it (LIFO per lock) so the matching release repairs
    the right graph even across an install/uninstall boundary."""

    def __init__(self, name: str, rlock: bool):
        self._inner = _real_rlock() if rlock else _real_lock()
        self._name = name
        self._rlock = rlock
        self._owner_tid: Optional[int] = None
        self._graph_stack: List[Optional[LockGraph]] = []
        self._seen: Set[LockGraph] = set()

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        ok = self._inner.acquire(blocking, timeout)
        if ok:
            g = _active
            self._owner_tid = threading.get_ident()
            if g is not None:
                g.note_acquired(self._name, _caller_site())
                self._seen.add(g)
            self._graph_stack.append(g)
        return ok

    def release(self) -> None:
        # For a plain Lock the releasing thread may differ from the
        # acquirer (handoff pattern); the stack to repair is the
        # ACQUIRER's.  RLocks are owner-released by definition.
        owner = threading.get_ident() if self._rlock else self._owner_tid
        self._inner.release()
        g = self._graph_stack.pop() if self._graph_stack else None
        if g is not None:
            g.note_released(self._name, owner)

    def __del__(self):
        try:
            for g in self._seen:
                g.forget_later(self._name)
        except Exception:
            pass

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def locked(self) -> bool:
        return self._inner.locked()

    # threading.Condition probes these when present (RLock only).
    def _is_owned(self):
        inner = self._inner
        if hasattr(inner, "_is_owned"):
            return inner._is_owned()
        if inner.acquire(False):
            inner.release()
            return False
        return True

    def _acquire_restore(self, state):
        inner = self._inner
        if hasattr(inner, "_acquire_restore"):
            inner._acquire_restore(state)
        else:
            inner.acquire()
        # Ownership moves to the woken waiter: a later release must
        # repair THIS thread's stack, not the last plain-acquire()
        # caller's.
        self._owner_tid = threading.get_ident()
        g = _active
        if g is not None:
            g.note_acquired(self._name, "condition-reacquire")
            self._seen.add(g)
        self._graph_stack.append(g)

    def _release_save(self):
        inner = self._inner
        if hasattr(inner, "_release_save"):
            state = inner._release_save()
        else:
            inner.release()
            state = None
        g = self._graph_stack.pop() if self._graph_stack else None
        if g is not None:
            g.note_released(self._name)
        return state

    def __repr__(self):
        return f"<TracedLock {self._name} {self._inner!r}>"


def _caller_site(depth: int = 2) -> str:
    f = sys._getframe(depth)
    # Walk out of this module's own frames (acquire/__enter__).
    while f and f.f_globals.get("__name__") == __name__:
        f = f.f_back
    if not f:
        return "?"
    return f"{os.path.basename(f.f_code.co_filename)}:{f.f_lineno}"


import itertools

_serial = itertools.count(1)  # next() is atomic in CPython — two locks
#                               born concurrently on one line must not
#                               share a name (a shared name collapses
#                               distinct instances into one node and
#                               real inter-instance cycles read as
#                               re-entry).


def _name_from_site() -> str:
    """Name a lock by construction site + per-instance serial: the site
    makes violation reports self-describing, the serial keeps distinct
    locks distinct nodes."""
    f = sys._getframe(2)
    while f and f.f_globals.get("__name__") in (__name__, "threading"):
        f = f.f_back
    n = next(_serial)
    if not f:
        return f"anonymous#{n}"
    mod = f.f_globals.get("__name__", "?")
    return f"{mod}:{f.f_lineno}#{n}"


_active: Optional[LockGraph] = None


def install() -> LockGraph:
    """Swap threading.Lock/RLock for traced factories bound to a FRESH
    graph; returns it.  Installation nests: each install() stacks over
    whatever was active (ambient YTPU_LOCKTRACE tracing included), and
    uninstall() restores the previous layer — so a scoped `installed()`
    block inside a traced process neither inherits stale edges nor
    permanently disables the operator's process-wide tracing."""
    global _active
    graph = LockGraph()
    graph._prev = (_active, threading.Lock, threading.RLock)
    _active = graph

    def make_lock():
        return _TracedLock(_name_from_site(), rlock=False)

    def make_rlock():
        return _TracedLock(_name_from_site(), rlock=True)

    threading.Lock = make_lock          # type: ignore[misc]
    threading.RLock = make_rlock        # type: ignore[misc]
    return graph


def uninstall() -> None:
    """Pop the most recent install(), restoring the previous layer."""
    global _active
    if _active is None:
        threading.Lock = _real_lock     # type: ignore[misc]
        threading.RLock = _real_rlock   # type: ignore[misc]
        return
    prev_active, prev_lock, prev_rlock = _active._prev
    threading.Lock = prev_lock          # type: ignore[misc]
    threading.RLock = prev_rlock        # type: ignore[misc]
    _active = prev_active


def active_graph() -> Optional[LockGraph]:
    return _active


@contextlib.contextmanager
def installed():
    graph = install()
    try:
        yield graph
    finally:
        uninstall()


def framework_violations(graph: LockGraph,
                         needle: str = "yadcc_tpu_torch") -> List[str]:
    """Violations involving at least one lock this package constructed.

    Lock names carry their construction module (`_name_from_site`), so
    filtering on the package name separates OUR ordering bugs from
    cycles purely among third-party locks (a traced window in which
    torch initializes CUDA or profiles wraps torch's internal locks
    too; their internal ordering is not this package's gate).  The
    stress fixtures of tests/test_torch_locktrace.py and the smoke's
    traced grant path assert this is empty.
    """
    return [v for v in graph.violations if needle in v]


def install_from_env() -> Optional[LockGraph]:
    """Entry-point hook: YTPU_LOCKTRACE=1 turns tracing on for the whole
    process, exposes the graph as `yadcc/locktrace` and registers an
    atexit report (the production analogue of the reference's always-on
    strict heap check in tests).  Never uninstalled."""
    if not os.environ.get("YTPU_LOCKTRACE"):
        return None
    graph = install()

    from . import exposed_vars

    exposed_vars.expose("yadcc/locktrace", graph.inspect)

    import atexit

    def report():
        if graph.violations:
            sys.stderr.write(
                "locktrace: %d violation(s):\n  %s\n"
                % (len(graph.violations),
                   "\n  ".join(graph.violations)))

    atexit.register(report)
    return graph
