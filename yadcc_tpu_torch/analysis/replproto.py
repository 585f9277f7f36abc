"""Replication / exactly-once protocol verifier (v4 rule pack).

The scheduler's contract is that a leased grant runs *exactly once*,
and replication makes that invariant distributed: a post-commit lease journal
(scheduler/replication.py), a two-level grant-id namespace
(cell x shard stride composition), and a standby takeover that must
open the adoption window before it starts serving.  This family checks
the code *structure* behind those invariants; the dynamic counterpart
(testing/interleave.py) model-checks the same invariants
under bounded thread schedules.

Four rules, all scoped to the replication surface
(``AnalyzerConfig.replproto_path_fragments``) or to any file carrying
the directives:

* ``repl-journal-skip`` — a method declared
  ``# ytpu: replicated(op, ...)`` must pair every mutation path (a call
  through ``self._inner.*``) with a journal append of one of the
  declared ops, and the append must come AFTER the commit (the
  post-commit ordering is what makes a journal entry a promise the
  state change happened).  A declared op that is never appended on any
  path is also a finding — that is how the deliberate no-journal
  expiration path earns its written ``allow``.
* ``repl-journal-under-lock`` — a journal append (or a call to a
  same-class helper that appends) while ANY statically-held lock is
  held.  The journal lock is a rank-4 leaf; taking it under a
  dispatcher-rank lock is how replication gets to stall the grant
  path.
* ``grant-id-arith`` — bare arithmetic on grant-id-shaped names
  outside the blessed namespace helpers, plus a symbolic check that
  every ``grant_id_start=/grant_id_stride=`` construction site
  composes with the cell x shard stride math (start's constant term
  +1, every other term sharing a symbol with the stride product, at
  most one unit-coefficient shard-index term).
* ``takeover-order`` — a function declared
  ``# ytpu: protocol(a<b<c)`` must reach its protocol steps in the
  declared order on every path (loops are assumed to execute: an
  empty replay loop must not poison the order).

Honesty notes: the path walks are intraprocedural with one-hop helper
resolution (``self._journal_issue`` counts as appending "issue"), a
closure handed to the inner call as a callback credits its ops to the
whole function (the ``_submit``/``journaling_done`` idiom), and a
branch whose test mentions an inner-derived name (or a parameter) is
*credited* — its no-append arm is taken to be deliberate.  Raising
paths are exempt: the caller sees the failure.
"""

from __future__ import annotations

import ast
from typing import Dict, FrozenSet, List, Optional, Sequence, Set, Tuple

from .core import (AnalyzerConfig, Finding, FunctionInfo, HeldWalker,
                   Hooks, LockRef, ModuleModel, _dotted, iter_functions,
                   last_segment)
from .lockrules import _in_scope

# Function names whose bodies are the sanctioned home of grant-id
# arithmetic: the namespace constructors/decoders plus the adopted-id
# counter advance.
_BLESSED_FUNCS = {
    "grant_namespace_for_cell", "cell_of_grant", "shard_of_grant",
    "grant_id_start", "grant_id_stride", "_advance_grant_id_locked",
}

# Bare names that denote a grant id even without the substring.
_GRANT_NAMES = {"gid", "gids", "grant_ids", "floor_grant_id"}

_ARITH_OPS = (ast.Add, ast.Sub, ast.Mult, ast.Div, ast.FloorDiv, ast.Mod)

# Call-name -> protocol step (exact match; the step's own name always
# matches so fixtures can use bare step calls).
_STEP_ALIASES = {
    "keep_servant_alive": "replay",
    "adopt_grants": "adopt",
    "set_adoption_window": "window",
}

_STATE_CAP = 64  # path-state explosion bound, as in asyncproto


def _cap(states: set) -> set:
    if len(states) <= _STATE_CAP:
        return states
    return set(sorted(states, key=repr)[:_STATE_CAP])


# ---------------------------------------------------------------------------
# Shared event extraction.
# ---------------------------------------------------------------------------


def _journal_append_ops(node: ast.AST) -> Optional[Set[str]]:
    """The journal ops a call appends, or None when the call is not a
    journal append.  Matched on ``<...journal...>.append(...)``; the op
    comes from the ``"op"`` key of a dict-literal first argument, with
    ``"*"`` (satisfies any declared op) when it cannot be read."""
    if not isinstance(node, ast.Call):
        return None
    f = node.func
    if not (isinstance(f, ast.Attribute) and f.attr == "append"):
        return None
    owner = last_segment(f.value)
    if owner is None or "journal" not in owner:
        return None
    ops: Set[str] = set()
    if node.args and isinstance(node.args[0], ast.Dict):
        for k, v in zip(node.args[0].keys, node.args[0].values):
            if isinstance(k, ast.Constant) and k.value == "op" and \
                    isinstance(v, ast.Constant):
                ops.add(str(v.value))
    return ops or {"*"}


def _is_commit(call: ast.Call) -> bool:
    dotted = _dotted(call.func) or ""
    return dotted.startswith("self._inner.") or \
        dotted.startswith("self.inner.")


def _iter_events(stmts: Sequence[ast.AST],
                 appenders: Dict[str, Set[str]]
                 ) -> List[Tuple[str, FrozenSet[str], int]]:
    """("commit"|"append", ops, lineno) events in source order, nested
    defs/lambdas excluded (their bodies run later, not on this path)."""
    events: List[Tuple[str, FrozenSet[str], int]] = []

    def rec(n: ast.AST) -> None:
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.Lambda)):
            return
        if isinstance(n, ast.Call):
            if _is_commit(n):
                events.append(("commit", frozenset(), n.lineno))
            else:
                ops = _journal_append_ops(n)
                if ops is None and isinstance(n.func, ast.Attribute) and \
                        isinstance(n.func.value, ast.Name) and \
                        n.func.value.id == "self" and \
                        n.func.attr in appenders:
                    ops = appenders[n.func.attr]
                if ops is not None:
                    events.append(("append", frozenset(ops), n.lineno))
        for c in ast.iter_child_nodes(n):
            rec(c)

    for s in stmts:
        rec(s)
    return events


def _class_appenders(model: ModuleModel) -> Dict[str, Dict[str, Set[str]]]:
    """class name -> {method name -> ops it DIRECTLY journal-appends}
    (one-hop helper resolution for both path walks)."""
    out: Dict[str, Dict[str, Set[str]]] = {}
    for node in ast.walk(model.tree):
        if not isinstance(node, ast.ClassDef):
            continue
        methods: Dict[str, Set[str]] = {}
        for sub in node.body:
            if not isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            ops: Set[str] = set()
            for n in ast.walk(sub):
                o = _journal_append_ops(n)
                if o:
                    ops |= o
            if ops:
                methods[sub.name] = ops
        out[node.name] = methods
    return out


# ---------------------------------------------------------------------------
# repl-journal-skip.
# ---------------------------------------------------------------------------


def _credited_names(func: ast.AST, params: Sequence[str]) -> Set[str]:
    """Names whose value derives from the inner dispatcher or a
    parameter: branches on them are deliberate journaling decisions."""
    credited = {p for p in params if p not in ("self", "cls")}

    def derived(value: ast.AST) -> bool:
        for n in ast.walk(value):
            if isinstance(n, ast.Name) and n.id in credited:
                return True
            if isinstance(n, ast.Attribute) and n.attr in ("_inner",
                                                           "inner"):
                return True
        return False

    changed = True
    while changed:
        changed = False
        for node in ast.walk(func):
            targets: List[ast.AST] = []
            if isinstance(node, ast.Assign) and derived(node.value):
                targets = list(node.targets)
            elif isinstance(node, (ast.For, ast.AsyncFor)) and \
                    derived(node.iter):
                targets = [node.target]
            for t in targets:
                for n in ast.walk(t):
                    if isinstance(n, ast.Name) and n.id not in credited:
                        credited.add(n.id)
                        changed = True
    return credited


def _handoff_ops(func: ast.AST, appenders: Dict[str, Set[str]]
                 ) -> Set[str]:
    """Ops appended by a nested def that is handed to an inner-commit
    call as a callback: they count for the whole function (the journal
    fires when the inner dispatcher completes the hand-off)."""
    nested: Dict[str, Set[str]] = {}
    for n in ast.walk(func):
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)) and \
                n is not func:
            ops = {op for kind, evops, _ in _iter_events(n.body, appenders)
                   if kind == "append" for op in evops}
            if ops:
                nested[n.name] = ops
    out: Set[str] = set()
    if not nested:
        return out
    for n in ast.walk(func):
        if isinstance(n, ast.Call) and _is_commit(n):
            for sub in list(n.args) + [kw.value for kw in n.keywords]:
                if isinstance(sub, ast.Name) and sub.id in nested:
                    out |= nested[sub.id]
    return out


class _ReplWalk:
    """Path-sensitive walk of one replicated(...) method.

    State = (committed, appended-ops, credited).  Forks at If, loops as
    0-or-1, Try handlers entered from both the try entry and the end of
    the body, Raise paths exempt."""

    def __init__(self, info: FunctionInfo, appenders: Dict[str, Set[str]],
                 relpath: str, out: List[Finding]):
        self.declared = frozenset(info.replicated)
        self.appenders = appenders
        self.relpath = relpath
        self.out = out
        self.func = info.node
        self.credited = _credited_names(self.func, info.params)
        self.handoff = _handoff_ops(self.func, appenders)
        self.states: set = {(False, frozenset(), False)}
        self.seen_ops: Set[str] = set(self.handoff)
        self._fired: Set[Tuple[str, int]] = set()

    def run(self) -> None:
        self._walk_stmts(self.func.body)
        last = self.func.body[-1] if self.func.body else self.func
        self._terminal(getattr(last, "end_lineno", None) or last.lineno)
        for op in sorted(self.declared - self.seen_ops):
            if "*" in self.seen_ops:
                break
            self._fire(
                self.func.lineno,
                f"declared journal op '{op}' is never appended on any "
                f"path of this replicated method (a standby replaying "
                f"the journal will miss the mutation)")

    # -- events ------------------------------------------------------------

    def _fire(self, line: int, message: str) -> None:
        key = (message, line)
        if key in self._fired:
            return
        self._fired.add(key)
        self.out.append(Finding("repl-journal-skip", self.relpath, line,
                                message))

    def _apply_events(self, node: ast.AST) -> None:
        for kind, ops, line in _iter_events([node], self.appenders):
            if kind == "commit":
                self.states = _cap({(True, o, cr)
                                    for _, o, cr in self.states})
                continue
            self.seen_ops |= ops
            new = set()
            for committed, have, cr in self.states:
                if not committed:
                    self._fire(
                        line,
                        "journal append before the inner commit on this "
                        "path: the entry promises a state change that "
                        "has not happened yet (post-commit ordering is "
                        "the exactly-once contract)")
                new.add((committed, have | ops, cr))
            self.states = _cap(new)

    def _terminal(self, line: int) -> None:
        for committed, have, credited in self.states:
            if not committed or credited:
                continue
            if "*" in have or (self.declared & (have | self.handoff)):
                continue
            self._fire(
                line,
                "mutation path commits via self._inner but reaches "
                "return without a journal append of any declared op "
                f"({', '.join(sorted(self.declared))}): a takeover "
                "replays a mirror that never saw this change")

    # -- control flow ------------------------------------------------------

    def _credited_test(self, test: ast.AST) -> bool:
        for n in ast.walk(test):
            if isinstance(n, ast.Name) and n.id in self.credited:
                return True
            if isinstance(n, ast.Attribute) and n.attr in ("_inner",
                                                           "inner"):
                return True
        return False

    def _walk_stmts(self, stmts: Sequence[ast.AST]) -> None:
        for s in stmts:
            self._walk_stmt(s)

    def _walk_stmt(self, s: ast.AST) -> None:
        if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.ClassDef)):
            return
        if isinstance(s, ast.If):
            self._apply_events(s.test)
            credited = self._credited_test(s.test)
            entry = set(self.states)
            if credited:
                self.states = {(c, o, True) for c, o, _ in self.states}
            self._walk_stmts(s.body)
            body_out = self.states
            self.states = ({(c, o, True) for c, o, _ in entry}
                           if credited else set(entry))
            self._walk_stmts(s.orelse)
            self.states = _cap(body_out | self.states)
            return
        if isinstance(s, (ast.For, ast.AsyncFor, ast.While)):
            self._apply_events(s.iter if isinstance(s, (ast.For,
                                                        ast.AsyncFor))
                               else s.test)
            skip = set(self.states)
            self._walk_stmts(s.body)
            self.states = _cap(self.states | skip)
            if s.orelse:
                self._walk_stmts(s.orelse)
            return
        if isinstance(s, ast.Try):
            entry = set(self.states)
            self._walk_stmts(s.body)
            after_body = set(self.states)
            handler_out: set = set()
            for h in s.handlers:
                self.states = _cap(entry | after_body)
                self._walk_stmts(h.body)
                handler_out |= self.states
            self.states = _cap(after_body | handler_out)
            if s.orelse:
                self._walk_stmts(s.orelse)
            if s.finalbody:
                self._walk_stmts(s.finalbody)
            return
        if isinstance(s, (ast.With, ast.AsyncWith)):
            for item in s.items:
                self._apply_events(item.context_expr)
            self._walk_stmts(s.body)
            return
        if isinstance(s, ast.Return):
            if s.value is not None:
                self._apply_events(s.value)
            self._terminal(s.lineno)
            self.states = set()
            return
        if isinstance(s, ast.Raise):
            self.states = set()  # propagating failure: caller sees it
            return
        self._apply_events(s)


# ---------------------------------------------------------------------------
# repl-journal-under-lock.
# ---------------------------------------------------------------------------


class _JournalLockHooks(Hooks):
    def __init__(self, relpath: str, appenders: Dict[str, Set[str]],
                 config: AnalyzerConfig, out: List[Finding]):
        self.relpath = relpath
        self.appenders = appenders
        self.config = config
        self.out = out
        self._seen: Set[int] = set()

    def on_call(self, node: ast.Call, held: List[LockRef]) -> None:
        if not held or node.lineno in self._seen:
            return
        is_append = _journal_append_ops(node) is not None
        if not is_append and isinstance(node.func, ast.Attribute) and \
                isinstance(node.func.value, ast.Name) and \
                node.func.value.id == "self" and \
                node.func.attr in self.appenders:
            is_append = True
        if not is_append:
            return
        self._seen.add(node.lineno)
        descr = []
        for ref in held:
            rank = self.config.lock_ranks.get(ref.key)
            descr.append(f"{ref.key} (rank {rank})" if rank is not None
                         else f"{ref.key} (undeclared rank)")
        self.out.append(Finding(
            "repl-journal-under-lock", self.relpath, node.lineno,
            f"journal append while holding {', '.join(descr)}: the "
            f"journal lock is a rank-4 leaf taken at the call "
            f"boundary only — appending under a dispatcher lock lets "
            f"a wedged standby stall the grant path"))


# ---------------------------------------------------------------------------
# grant-id-arith.
# ---------------------------------------------------------------------------


def _grantish(name: Optional[str]) -> bool:
    return name is not None and ("grant_id" in name or
                                 name in _GRANT_NAMES)


def _subtree_grantish(node: ast.AST) -> Optional[str]:
    """First grant-id-shaped name in the subtree, skipping ``len(...)``
    arguments (sizing a buffer by a grant list is not id math)."""

    def rec(n: ast.AST) -> Optional[str]:
        if isinstance(n, ast.Call) and last_segment(n.func) == "len":
            return None
        seg = None
        if isinstance(n, ast.Name):
            seg = n.id
        elif isinstance(n, ast.Attribute):
            seg = n.attr
        if seg is not None and _grantish(seg):
            return seg
        for c in ast.iter_child_nodes(n):
            hit = rec(c)
            if hit is not None:
                return hit
        return None

    return rec(node)


_Poly = Dict[Tuple[str, ...], int]


def _poly(node: ast.AST) -> Optional[_Poly]:
    """node -> {sorted symbol tuple -> int coeff}, or None when the
    expression is outside the +,-,* / int() fragment (site skipped)."""
    if isinstance(node, ast.Constant) and isinstance(node.value, int) \
            and not isinstance(node.value, bool):
        return {(): node.value}
    if isinstance(node, ast.Name):
        return {(node.id,): 1}
    if isinstance(node, ast.Attribute):
        d = _dotted(node) or node.attr
        return {(d,): 1}
    if isinstance(node, ast.Call) and last_segment(node.func) == "int" \
            and len(node.args) == 1 and not node.keywords:
        return _poly(node.args[0])
    if isinstance(node, ast.BinOp) and \
            isinstance(node.op, (ast.Add, ast.Sub, ast.Mult)):
        left, right = _poly(node.left), _poly(node.right)
        if left is None or right is None:
            return None
        out: _Poly = {}
        if isinstance(node.op, ast.Mult):
            for ka, va in left.items():
                for kb, vb in right.items():
                    key = tuple(sorted(ka + kb))
                    out[key] = out.get(key, 0) + va * vb
        else:
            sign = -1 if isinstance(node.op, ast.Sub) else 1
            out = dict(left)
            for k, v in right.items():
                out[k] = out.get(k, 0) + sign * v
        return {k: v for k, v in out.items() if v != 0}
    return None


def _check_namespace_site(call: ast.Call, relpath: str,
                          out: List[Finding]) -> None:
    kw = {k.arg: k.value for k in call.keywords if k.arg}
    if "grant_id_start" not in kw or "grant_id_stride" not in kw:
        return
    stride = _poly(kw["grant_id_stride"])
    start = _poly(kw["grant_id_start"])
    if stride is None or start is None:
        return  # outside the symbolic fragment: the dynamic side owns it

    def fire(msg: str) -> None:
        out.append(Finding(
            "grant-id-arith", relpath, call.lineno,
            f"(grant_id_start, grant_id_stride) construction does not "
            f"compose with the cell x shard namespace: {msg}"))

    if len(stride) != 1:
        fire("stride must be a single product term (cells x shards), "
             f"got {len(stride)} terms")
        return
    (skey, scoeff), = stride.items()
    if skey == ():
        if scoeff < 1:
            fire(f"constant stride {scoeff} < 1")
        elif set(start) - {()} or not 1 <= start.get((), 0) <= scoeff:
            fire("with a constant stride the start must be a constant "
                 "in [1, stride]")
        return
    if scoeff != 1:
        fire(f"stride product carries coefficient {scoeff} (must be 1: "
             f"one id per (cell, shard) residue)")
        return
    rest = dict(start)
    const = rest.pop((), 0)
    if const != 1:
        fire(f"start's constant term is {const}, not +1 (ids are "
             f"1-based; residue 0 would alias the unset sentinel)")
    disjoint = 0
    for tkey, tcoeff in rest.items():
        if set(tkey) & set(skey):
            continue
        disjoint += 1 if tcoeff == 1 else 2
    if disjoint > 1:
        fire("start has more than one term disjoint from the stride "
             "product: only the unit-coefficient shard index may stand "
             "alone")


class _GrantArithVisitor:
    def __init__(self, relpath: str, out: List[Finding]):
        self.relpath = relpath
        self.out = out

    def visit(self, node: ast.AST, exempt: bool = False) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) and \
                node.name in _BLESSED_FUNCS:
            return  # the sanctioned home of the arithmetic
        if isinstance(node, (ast.Compare, ast.JoinedStr)):
            # Comparisons (residue/range checks) and f-strings
            # (diagnostics) read ids; they cannot mint a wrong one.
            exempt = True
        fired = False
        if not exempt and isinstance(node, ast.BinOp) and \
                isinstance(node.op, _ARITH_OPS):
            seg = _subtree_grantish(node)
            if seg is not None:
                self._fire(node.lineno, seg)
                fired = True
        if not exempt and isinstance(node, ast.AugAssign) and \
                isinstance(node.op, _ARITH_OPS):
            seg = (_subtree_grantish(node.target)
                   or _subtree_grantish(node.value))
            if seg is not None:
                self._fire(node.lineno, seg)
                fired = True
        if isinstance(node, ast.Call):
            _check_namespace_site(node, self.relpath, self.out)
        for child in ast.iter_child_nodes(node):
            self.visit(child, exempt or fired)

    def _fire(self, line: int, seg: str) -> None:
        self.out.append(Finding(
            "grant-id-arith", self.relpath, line,
            f"bare arithmetic on grant id '{seg}' outside the blessed "
            f"namespace helpers "
            f"({', '.join(sorted(_BLESSED_FUNCS))}): id math that "
            f"ignores the cell x shard stride can collide namespaces"))


# ---------------------------------------------------------------------------
# takeover-order.
# ---------------------------------------------------------------------------


class _ProtoWalk:
    """Ordered-protocol walk: every declared step reached on a path
    must find all earlier declared steps already done.  Loops are
    assumed to execute (an empty replay loop must not fail takeover);
    Try handlers fork from the try entry; Raise paths are exempt."""

    def __init__(self, info: FunctionInfo, relpath: str,
                 out: List[Finding]):
        self.steps = list(info.protocol)
        self.relpath = relpath
        self.out = out
        self.func = info.node
        self.states: set = {frozenset()}
        self._fired: Set[Tuple[int, str, str]] = set()

    def run(self) -> None:
        self._walk_stmts(self.func.body)

    def _step_for_call(self, call: ast.Call) -> Optional[str]:
        seg = last_segment(call.func)
        if seg is None:
            return None
        if seg in self.steps:
            return seg
        alias = _STEP_ALIASES.get(seg)
        return alias if alias in self.steps else None

    def _apply_events(self, node: ast.AST) -> None:
        events: List[Tuple[str, int]] = []

        def rec(n: ast.AST) -> None:
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.Lambda)):
                return
            if isinstance(n, ast.Call):
                step = self._step_for_call(n)
                if step is not None:
                    events.append((step, n.lineno))
            for c in ast.iter_child_nodes(n):
                rec(c)

        rec(node)
        for step, line in events:
            idx = self.steps.index(step)
            new = set()
            for st in self.states:
                for earlier in self.steps[:idx]:
                    if earlier not in st:
                        key = (line, step, earlier)
                        if key not in self._fired:
                            self._fired.add(key)
                            self.out.append(Finding(
                                "takeover-order", self.relpath, line,
                                f"protocol step '{step}' reached before "
                                f"'{earlier}' (declared order: "
                                f"{' < '.join(self.steps)})"))
                new.add(st | {step})
            self.states = _cap(new)

    def _walk_stmts(self, stmts: Sequence[ast.AST]) -> None:
        for s in stmts:
            self._walk_stmt(s)

    def _walk_stmt(self, s: ast.AST) -> None:
        if isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.ClassDef)):
            return
        if isinstance(s, ast.If):
            self._apply_events(s.test)
            entry = set(self.states)
            self._walk_stmts(s.body)
            body_out = self.states
            self.states = set(entry)
            self._walk_stmts(s.orelse)
            self.states = _cap(body_out | self.states)
            return
        if isinstance(s, (ast.For, ast.AsyncFor, ast.While)):
            self._apply_events(s.iter if isinstance(s, (ast.For,
                                                        ast.AsyncFor))
                               else s.test)
            self._walk_stmts(s.body)  # executes-once: steps DO happen
            if s.orelse:
                self._walk_stmts(s.orelse)
            return
        if isinstance(s, ast.Try):
            entry = set(self.states)
            self._walk_stmts(s.body)
            after_body = set(self.states)
            handler_out: set = set()
            for h in s.handlers:
                self.states = _cap(entry | after_body)
                self._walk_stmts(h.body)
                handler_out |= self.states
            self.states = _cap(after_body | handler_out)
            if s.orelse:
                self._walk_stmts(s.orelse)
            if s.finalbody:
                self._walk_stmts(s.finalbody)
            return
        if isinstance(s, (ast.With, ast.AsyncWith)):
            for item in s.items:
                self._apply_events(item.context_expr)
            self._walk_stmts(s.body)
            return
        if isinstance(s, ast.Return):
            if s.value is not None:
                self._apply_events(s.value)
            self.states = set()
            return
        if isinstance(s, ast.Raise):
            self.states = set()
            return
        self._apply_events(s)


# ---------------------------------------------------------------------------
# Entry point.
# ---------------------------------------------------------------------------


def check_module(model: ModuleModel, functions: List[FunctionInfo],
                 config: AnalyzerConfig) -> List[Finding]:
    d = model.directives
    if not (_in_scope(model.relpath, config.replproto_path_fragments)
            or d.replicated or d.protocol):
        return []
    out: List[Finding] = []
    appenders_by_class = _class_appenders(model)

    for info in functions:
        if info.node is None:
            continue
        appenders = appenders_by_class.get(info.cls or "", {})
        if info.replicated:
            _ReplWalk(info, appenders, model.relpath, out).run()
        if info.protocol:
            _ProtoWalk(info, model.relpath, out).run()

    for cls, func in iter_functions(model):
        appenders = appenders_by_class.get(cls.name if cls else "", {})
        hooks = _JournalLockHooks(model.relpath, appenders, config, out)
        HeldWalker(model, cls, func, hooks).run()

    _GrantArithVisitor(model.relpath, out).visit(model.tree)
    return out
