"""Rule families 8-11: async-protocol verification for the parked
serving plane (reply-once / await-under-lock / loop-affinity /
async-lifecycle).

The aio front end runs the serving path on one asyncio event loop: long-polls
park as continuations (`ServiceSpec.add_parked`), replies travel
through reply-once responder objects, deadlines are `call_later`
timers.  yadcc gets the equivalent guarantees from flare's fiber
runtime; here the discipline is hand-written protocol, so this pack
machine-checks it:

* **reply-once** (`reply-drop` / `reply-double` / `reply-handoff`) —
  parameters declared ``# ytpu: responder(param)`` on a def are checked
  on every execution path: each terminating path must either invoke the
  responder's reply surface exactly once, hand the responder off to a
  callee (whose receiving parameter must itself be declared), or raise
  (the parked dispatcher's error edge completes the stream).  A path
  with zero replies drops the parked client forever; a reachable second
  direct reply double-fires into a settled stream.  The walk is a
  path-sensitive abstract interpretation over (direct, transfer) reply
  counts — branches fork the state set, exception edges count ``raise``
  as legal completion, ``if <resp>.replied:`` guards credit the guarded
  branch, and nested defs capturing the responder are checked as
  responder contexts of their own.  Hand-offs resolve interprocedurally
  by callee name with taint.py's discipline (≤3 candidates, stoplist,
  summary-driven so cache hits stay correct).
* **await-under-lock** — an ``await`` while a ``threading`` lock is
  statically held (lexically inside ``with self._lock`` or in a
  ``*_locked`` convention method) stalls every parked client behind one
  critical section.  ``asyncio.Lock`` is exempt (core._factory_kind
  ignores asyncio-rooted factories).
* **loop-affinity** (`loop-affinity`) — defs declared
  ``# ytpu: loop-only`` may only be called from loop context: async
  defs, other loop-only defs, or thunks that demonstrably travel
  through the ``call_soon``/``call_soon_threadsafe`` seam.  Direct use
  of loop-affine primitives (``loop.call_later``, ``loop.create_task``,
  ``Future.set_result``...) outside loop context is likewise flagged.
* **async-lifecycle** (`async-timer-leak` / `async-task-orphan`) —
  ``call_later`` handles must be retained (a dropped handle can never
  be cancelled, so the timer outlives the continuation it guards) and
  local handles must be cancelled or handed off on completion paths;
  ``asyncio.create_task``/``loop.create_task`` results must be
  retained and awaited/cancelled/stored (orphaned fire-and-forget
  tasks are collected mid-flight and eat exceptions).

Scope: ``asyncproto_path_fragments`` (rpc/, scheduler/, daemon/).
Like every other family the pass errs toward false negatives:
unresolvable hand-offs (escaping into containers, >3 candidates,
stoplisted names) end the check for that path rather than guessing.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .core import (
    AnalyzerConfig,
    Finding,
    FunctionInfo,
    ModuleModel,
    last_segment,
    root_segment,
)

# Callee names too generic to resolve by name (mirrors taint.py).
_RESOLUTION_STOPLIST = {
    "get", "put", "add", "pop", "update", "append", "remove", "close",
    "start", "stop", "run", "call", "write", "join", "split", "items",
    "keys", "values", "copy", "encode", "decode", "send", "recv",
    "result", "acquire", "release", "format", "strip",
}
_MAX_CANDIDATES = 3

# Reply surfaces: calling <responder>.<one of these>(...) IS the reply.
_REPLY_METHODS = {
    "_reply", "reply", "send_result", "send_error", "set_result",
    "set_exception", "fire", "complete",
}
# Executor/loop seams whose fn-reference argument is *invoked later*:
# passing the responder to fn's closure (or as a trailing arg) is a
# transfer, and the fn-reference itself gets a synthesized call edge.
_SEAM_SEGS = {"submit", "call_soon", "call_soon_threadsafe",
              "call_later", "add_done_callback"}

# Loop-affine primitives: only legal from loop context.
_LOOP_AFFINE_SEGS = {"call_later", "create_task", "ensure_future",
                     "add_reader", "add_writer"}
# Thread-safe seams that make an off-loop call legal.
_THREADSAFE_SEGS = {"call_soon_threadsafe", "run_coroutine_threadsafe",
                    "run_sync"}

# Timer-producing calls (handle must be retained): last segment.
_TIMER_SEGS = {"call_later", "call_at"}
# Task-producing calls (result must be retained): last segment.
_TASK_SEGS = {"create_task", "ensure_future"}
# Methods that legally settle a retained handle.
_SETTLE_SEGS = {"cancel", "cancelled"}


def _in_scope(relpath: str, fragments: Tuple[str, ...]) -> bool:
    parts = relpath.replace("\\", "/").split("/")
    return any(frag in parts for frag in fragments)


def _is_constructor_name(name: str) -> bool:
    base = name.lstrip("_")
    return bool(base) and base[0].isupper() and not base.isupper()


# ---------------------------------------------------------------------------
# reply-once: per-function path walk.
# ---------------------------------------------------------------------------

# A path state is (direct_replies, transfers), both capped so the state
# set stays tiny.  `None` in a state set position never occurs; states
# are frozensets of (d, t) pairs.
_CAP = 2


def _bump(states: Set[Tuple[int, int]], dd: int = 0,
          dt: int = 0) -> Set[Tuple[int, int]]:
    return {(min(d + dd, _CAP), min(t + dt, _CAP)) for d, t in states}


class _ReplyWalk:
    """All-paths walk of one responder context (a def plus the nested
    defs that do NOT capture the responder).  Produces:

    * terminal path states (fell off the end / explicit return),
    * raise path states (legal completion via the dispatcher error edge),
    * double-fire sites (line numbers where a path's direct count hit 2),
    * hand-off records for the global resolution pass,
    * closures: nested defs capturing the responder (checked separately
      as their own responder contexts by the caller).
    """

    def __init__(self, resp: str, func: ast.AST):
        self.resp = resp
        self.aliases: Set[str] = {resp}
        self.func = func
        self.doubles: List[int] = []
        self.handoffs: List[dict] = []
        self.closures: List[ast.AST] = []
        self.raise_states: Set[Tuple[int, int]] = set()
        self.escaped = False   # responder stored/escaped unresolvably

    # -- expression helpers ------------------------------------------------

    def _is_resp(self, node: ast.AST) -> bool:
        return isinstance(node, ast.Name) and node.id in self.aliases

    def _mentions_resp(self, node: ast.AST) -> bool:
        for sub in ast.walk(node):
            if self._is_resp(sub):
                return True
        return False

    def _reply_call(self, node: ast.Call) -> bool:
        """`<resp>(...)` (callable continuations like `done`/`on_done`)
        or `<resp>.reply-ish(...)` (responder objects) — the direct
        reply surface."""
        f = node.func
        if self._is_resp(f):
            return True
        return (isinstance(f, ast.Attribute) and self._is_resp(f.value)
                and f.attr in _REPLY_METHODS)

    def _capturing_def(self, node: ast.AST) -> bool:
        """Does this nested def's body reference the responder without
        redefining it as a parameter?"""
        args = getattr(node, "args", None)
        if args is not None:
            params = {p.arg for p in
                      (args.posonlyargs + args.args + args.kwonlyargs)}
            if self.aliases & params:
                return False
        body = getattr(node, "body", [])
        stmts = body if isinstance(body, list) else [body]
        for stmt in stmts:
            for sub in ast.walk(stmt):
                if self._is_resp(sub):
                    return True
        return False

    def _replied_guard(self, test: ast.AST) -> Optional[bool]:
        """`if <resp>.replied:` -> True (body branch is post-reply);
        `if not <resp>.replied:` -> False (else branch is post-reply);
        anything else -> None."""
        neg = False
        while isinstance(test, ast.UnaryOp) and \
                isinstance(test.op, ast.Not):
            neg = not neg
            test = test.operand
        # Accept the guard attribute anywhere in an `or` chain:
        # `if resp.replied or result is None:` guards its body too
        # (every reply-bearing continuation uses this shape).
        candidates = [test]
        if isinstance(test, ast.BoolOp) and isinstance(test.op, ast.Or):
            candidates = list(test.values)
        for c in candidates:
            if isinstance(c, ast.Attribute) and self._is_resp(c.value) \
                    and c.attr in ("replied", "fired", "done"):
                return not neg
        return None

    # -- call classification -----------------------------------------------

    def _classify_call(self, node: ast.Call) -> Optional[dict]:
        """If the responder flows into this call, return a hand-off
        record (callee/pos/kw/method/line) or mark escape.  Reply calls
        are handled by the caller before this."""
        fname = last_segment(node.func)
        # Executor seam: submit(fn, resp, ...) / call_soon(fn, resp...)
        # -> synthesized edge to `fn` with the responder's position
        # shifted left by one (fn receives it as its own argument).
        if fname in _SEAM_SEGS and node.args:
            fn_ref = node.args[0]
            fn_name = last_segment(fn_ref)
            # call_later(delay, fn, *args): fn is arg[1].
            shift = 1
            if fname in ("call_later", "call_at") and len(node.args) >= 2:
                fn_ref = node.args[1]
                fn_name = last_segment(fn_ref)
                shift = 2
            for i, a in enumerate(node.args[shift:]):
                if self._is_resp(a):
                    if fn_name is None:
                        self.escaped = True
                        return None
                    return {"callee": fn_name, "pos": i, "kw": None,
                            "method": isinstance(fn_ref, ast.Attribute),
                            "line": node.lineno, "seam": fname}
            # Responder captured by a closure passed through the seam is
            # handled by the closure check; a bare fn that IS an alias
            # (seam invokes the responder itself) cannot reply.
            if self._mentions_resp(node):
                for kw in node.keywords:
                    if kw.value is not None and \
                            self._mentions_resp(kw.value):
                        self.escaped = True
                        return None
            return None
        # Plain call with the responder as an argument.
        for i, a in enumerate(node.args):
            if self._is_resp(a):
                if fname is None or _is_constructor_name(fname):
                    # Constructors retain the responder as state: a
                    # transfer we cannot follow — treated as a legal
                    # hand-off (the retaining object owns the reply).
                    return {"callee": None, "pos": i, "kw": None,
                            "method": False, "line": node.lineno,
                            "seam": None}
                return {"callee": fname, "pos": i, "kw": None,
                        "method": isinstance(node.func, ast.Attribute),
                        "line": node.lineno, "seam": None}
        for kw in node.keywords:
            if kw.arg is not None and self._is_resp(kw.value):
                if fname is None or _is_constructor_name(fname):
                    return {"callee": None, "pos": None, "kw": kw.arg,
                            "method": False, "line": node.lineno,
                            "seam": None}
                return {"callee": fname, "pos": None, "kw": kw.arg,
                        "method": isinstance(node.func, ast.Attribute),
                        "line": node.lineno, "seam": None}
            if kw.arg is None and kw.value is not None and \
                    self._mentions_resp(kw.value):
                self.escaped = True
        return None

    # -- statement walk (forks state sets) ---------------------------------

    def _scan_expr(self, node: ast.AST,
                   states: Set[Tuple[int, int]]) -> Set[Tuple[int, int]]:
        """Evaluate an expression for reply/hand-off effects, in
        syntactic order.  Returns the updated state set."""
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            if self._capturing_def(node):
                self.closures.append(node)
            return states
        if isinstance(node, ast.Call):
            # Arguments evaluate first.
            for a in node.args:
                states = self._scan_expr(a, states)
            for kw in node.keywords:
                states = self._scan_expr(kw.value, states)
            states = self._scan_expr(node.func, states)
            if self._reply_call(node):
                for d, t in states:
                    if d + 1 >= 2:
                        self.doubles.append(node.lineno)
                        break
                return _bump(states, dd=1)
            rec = self._classify_call(node)
            if rec is not None:
                self.handoffs.append(rec)
                return _bump(states, dt=1)
            return states
        if isinstance(node, ast.Await):
            return self._scan_expr(node.value, states)
        # Bare `resp` in a return/assign RHS outside a call: escape.
        for child in ast.iter_child_nodes(node):
            states = self._scan_expr(child, states)
        return states

    def walk_body(self, stmts: Sequence[ast.AST],
                  states: Set[Tuple[int, int]]) -> Set[Tuple[int, int]]:
        """Returns the fall-through state set; terminated paths (return/
        raise/continue/break) leave via self.terminal/raise_states."""
        for stmt in stmts:
            states = self._walk_stmt(stmt, states)
            if not states:
                break
        return states

    def _walk_stmt(self, node: ast.AST,
                   states: Set[Tuple[int, int]]) -> Set[Tuple[int, int]]:
        if not states:
            return states
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if self._capturing_def(node):
                self.closures.append(node)
            return states
        if isinstance(node, ast.ClassDef):
            return states
        if isinstance(node, ast.Return):
            if node.value is not None:
                if self._is_resp(node.value):
                    # Returning the responder hands it to the caller.
                    states = _bump(states, dt=1)
                else:
                    states = self._scan_expr(node.value, states)
            self.terminal |= states
            return set()
        if isinstance(node, ast.Raise):
            for child in ast.iter_child_nodes(node):
                self._scan_expr(child, set(states))
            self.raise_states |= states
            return set()
        if isinstance(node, ast.If):
            states = self._scan_expr(node.test, states)
            guard = self._replied_guard(node.test)
            body_in = set(states)
            else_in = set(states)
            if guard is True:
                body_in = _bump(body_in, dt=1)
            elif guard is False:
                else_in = _bump(else_in, dt=1)
            out = self.walk_body(node.body, body_in)
            out |= self.walk_body(node.orelse, else_in)
            return out
        if isinstance(node, (ast.While, ast.For, ast.AsyncFor)):
            if isinstance(node, ast.While):
                states = self._scan_expr(node.test, states)
            else:
                states = self._scan_expr(node.iter, states)
            # Loop body: 0-or-1 executions approximate reply counting
            # (a reply in a loop that runs twice is a double; we accept
            # the false negative like the other families).
            once = self.walk_body(node.body, set(states))
            merged = states | once
            merged |= self.walk_body(node.orelse, set(merged))
            return merged
        if isinstance(node, (ast.With, ast.AsyncWith)):
            for item in node.items:
                states = self._scan_expr(item.context_expr, states)
            return self.walk_body(node.body, states)
        if isinstance(node, ast.Try):
            body_out = self.walk_body(node.body, set(states))
            # Exception edge: any prefix of the body may have run.  The
            # pre-body state enters every handler; a reply inside the
            # try is assumed settled before the raise for count
            # purposes (the runtime once-guard absorbs the overlap).
            out: Set[Tuple[int, int]] = set()
            for h in node.handlers:
                out |= self.walk_body(h.body, set(states))
            out |= self.walk_body(node.orelse, set(body_out))
            if node.finalbody:
                out = self.walk_body(node.finalbody,
                                     out | body_out if not node.orelse
                                     else out)
            elif not node.orelse:
                out |= body_out
            return out
        if isinstance(node, ast.Assign):
            states = self._scan_expr(node.value, states)
            # `alias = resp` propagates the responder name.
            if self._is_resp(node.value):
                for tgt in node.targets:
                    if isinstance(tgt, ast.Name):
                        self.aliases.add(tgt.id)
                    else:
                        # Stored into an attribute/subscript: the
                        # container owns it now — transfer.
                        states = _bump(states, dt=1)
            elif any(self._mentions_resp(t) for t in node.targets):
                pass
            return states
        if isinstance(node, (ast.AugAssign, ast.AnnAssign)):
            if node.value is not None:
                states = self._scan_expr(node.value, states)
            return states
        if isinstance(node, ast.Expr):
            return self._scan_expr(node.value, states)
        if isinstance(node, (ast.Break, ast.Continue)):
            self.terminal |= states
            return set()
        if isinstance(node, ast.Assert):
            for child in ast.iter_child_nodes(node):
                states = self._scan_expr(child, states)
            return states
        # Fallback: scan children generically.
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.stmt):
                states = self._walk_stmt(child, states)
            else:
                states = self._scan_expr(child, states)
        return states

    def run(self) -> dict:
        self.terminal: Set[Tuple[int, int]] = set()
        body = getattr(self.func, "body", [])
        stmts = body if isinstance(body, list) else [ast.Expr(body)]
        fall = self.walk_body(stmts, {(0, 0)})
        self.terminal |= fall
        return {
            "terminal": sorted(self.terminal),
            "raises": sorted(self.raise_states),
            "doubles": sorted(set(self.doubles)),
            "handoffs": self.handoffs,
            "escaped": self.escaped,
            "closures": self.closures,
        }


def _responder_params(info: FunctionInfo) -> List[str]:
    return [p for p in info.responders if p in info.params]


def summarize_functions(model: ModuleModel,
                        functions: List[FunctionInfo]) -> None:
    """Attach the JSON-serializable reply-once summary (`asyncp`) to
    each responder-annotated def so the global hand-off resolution pass
    works identically on cached and fresh files."""
    for info in functions:
        rps = _responder_params(info)
        bad = [p for p in info.responders if p not in info.params]
        if not rps and not bad:
            info.asyncp = None
            continue
        summary: dict = {"bad_decls": bad, "by_param": {}}
        if info.node is not None:
            for resp in rps:
                walk = _ReplyWalk(resp, info.node)
                res = walk.run()
                # Closures capturing the responder: each is a responder
                # context of its own; the outer body treats the closure
                # *name* as an alias so passing it through a seam is a
                # transfer.  We walk them here and fold their verdicts
                # into per-closure entries.
                closures = []
                for cnode in res.pop("closures"):
                    cwalk = _ReplyWalk(resp, cnode)
                    cres = cwalk.run()
                    cres.pop("closures")
                    closures.append({
                        "name": getattr(cnode, "name", "<lambda>"),
                        "line": cnode.lineno, **cres})
                res["closures"] = closures
                summary["by_param"][resp] = res
        info.asyncp = summary


# ---------------------------------------------------------------------------
# reply-once: verdicts (module-local part) + global hand-off resolution.
# ---------------------------------------------------------------------------


def _judge_context(name: str, relpath: str, line: int, res: dict,
                   findings: List[Finding], *,
                   outer_has_closures: bool = False) -> None:
    """Verdicts that need no interprocedural info: double-fire and
    dropped-client paths.  A context that hands the responder off or
    escapes it is exempt from the drop check (the recipient owns it);
    hand-off *target* validation happens globally."""
    for ln in res["doubles"]:
        findings.append(Finding(
            "reply-double", relpath, ln,
            f"{name}: a second direct reply is reachable on one "
            f"execution path (double-fire into a settled stream)"))
    if res["escaped"]:
        return
    drop = [s for s in res["terminal"] if s[0] + s[1] == 0]
    if drop and not outer_has_closures:
        findings.append(Finding(
            "reply-drop", relpath, line,
            f"{name}: a path neither replies, hands the responder "
            f"off, nor raises — the parked client is dropped"))


def check_module(model: ModuleModel, functions: List[FunctionInfo],
                 config: AnalyzerConfig,
                 loop_only_names: Set[str]) -> List[Finding]:
    findings: List[Finding] = []
    if not _in_scope(model.relpath, config.asyncproto_path_fragments):
        return findings
    findings.extend(_check_reply_local(model, functions))
    findings.extend(_check_await_under_lock(model, config))
    findings.extend(_check_loop_affinity(model, functions,
                                         loop_only_names))
    findings.extend(_check_async_lifecycle(model, functions))
    return findings


def _check_reply_local(model: ModuleModel,
                       functions: List[FunctionInfo]) -> List[Finding]:
    findings: List[Finding] = []
    for info in functions:
        if not info.asyncp:
            continue
        for bad in info.asyncp.get("bad_decls", ()):
            findings.append(Finding(
                "reply-drop", info.relpath, info.lineno,
                f"responder({bad}) names no parameter of {info.name}"))
        for resp, res in info.asyncp.get("by_param", {}).items():
            ctx = f"{info.name}({resp})"
            # A def whose responder only ever escapes into closures:
            # the closures carry the reply obligation.
            closures = res.get("closures", ())
            _judge_context(ctx, info.relpath, info.lineno, res, findings,
                           outer_has_closures=bool(closures))
            for c in closures:
                _judge_context(f"{info.name}.{c['name']}({resp})",
                               info.relpath, c["line"], c, findings)
    return findings


def check_global(functions: Sequence[FunctionInfo],
                 config: AnalyzerConfig) -> List[Finding]:
    """reply-handoff: every resolvable hand-off target's receiving
    parameter must itself be declared ``# ytpu: responder(param)`` —
    the chain of custody is closed by declaration, so a forgotten
    annotation (an unchecked link) is itself the finding."""
    findings: List[Finding] = []
    by_name: Dict[str, List[FunctionInfo]] = {}
    for info in functions:
        by_name.setdefault(info.name, []).append(info)

    def resolve(rec: dict) -> Optional[List[FunctionInfo]]:
        callee = rec.get("callee")
        if callee is None or callee in _RESOLUTION_STOPLIST:
            return None
        cands = by_name.get(callee, [])
        if not cands or len(cands) > _MAX_CANDIDATES:
            return None
        return cands

    for info in functions:
        if not info.asyncp or not _in_scope(
                info.relpath, config.asyncproto_path_fragments):
            continue
        contexts = []
        for resp, res in info.asyncp.get("by_param", {}).items():
            contexts.append((resp, res))
            contexts.extend((resp, c) for c in res.get("closures", ()))
        for resp, res in contexts:
            for rec in res.get("handoffs", ()):
                cands = resolve(rec)
                if cands is None:
                    continue
                for cand in cands:
                    plist = list(cand.params)
                    if rec.get("method") and plist and \
                            plist[0] == "self":
                        plist = plist[1:]
                    target: Optional[str] = None
                    if rec.get("kw") is not None:
                        if rec["kw"] in plist:
                            target = rec["kw"]
                    elif rec.get("pos") is not None and \
                            rec["pos"] < len(plist):
                        target = plist[rec["pos"]]
                    if target is None:
                        continue
                    if target not in cand.responders:
                        findings.append(Finding(
                            "reply-handoff", info.relpath, rec["line"],
                            f"{info.name} hands responder '{resp}' to "
                            f"{cand.name}({target}=...) but "
                            f"{cand.relpath}:{cand.lineno} does not "
                            f"declare '# ytpu: responder({target})'"))
    return findings


# ---------------------------------------------------------------------------
# await-under-lock.
# ---------------------------------------------------------------------------


def _check_await_under_lock(model: ModuleModel,
                            config: AnalyzerConfig) -> List[Finding]:
    from .core import HeldWalker, Hooks, iter_functions

    findings: List[Finding] = []

    class _AwaitHooks(Hooks):
        def on_await(self, node: ast.Await, held) -> None:
            if held:
                locks = ", ".join(sorted({h.key for h in held}))
                findings.append(Finding(
                    "await-under-lock", model.relpath, node.lineno,
                    f"await while holding threading lock(s) {locks}: "
                    f"every parked continuation on this loop stalls "
                    f"behind the critical section"))

    for cls, func in iter_functions(model):
        HeldWalker(model, cls, func, _AwaitHooks()).run()
    return findings


# ---------------------------------------------------------------------------
# loop-affinity.
# ---------------------------------------------------------------------------


def _loop_context_def(node: ast.AST, info: FunctionInfo) -> bool:
    """Is this def itself loop context?  Async defs and declared
    loop-only defs are; everything else is pool/thread context."""
    return isinstance(node, ast.AsyncFunctionDef) or info.loop_only


class _AffinityVisitor(ast.NodeVisitor):
    """Walks one def (loop or pool context).  In pool context, a call
    to a loop-only name or a loop-affine primitive is a finding unless
    it rides a threadsafe seam.  Nested defs switch context: a nested
    def passed through a threadsafe seam (or async by construction)
    runs ON the loop, so its body is loop context; other nested defs
    inherit.  Nested walks are deferred to `finish()` so a thunk
    scheduled *below* its def still gets loop context."""

    def __init__(self, model: ModuleModel, loop_only_names: Set[str],
                 findings: List[Finding], in_loop: bool,
                 by_node: Dict[int, FunctionInfo]):
        self.model = model
        self.loop_only = loop_only_names
        self.findings = findings
        self.in_loop = in_loop
        self.by_node = by_node
        # Names of local defs scheduled onto the loop via a seam.
        self.loop_thunks: Set[str] = set()
        self._deferred: List[ast.AST] = []

    def visit_Call(self, node: ast.Call) -> None:
        seg = last_segment(node.func)
        if seg in _THREADSAFE_SEGS:
            # Everything inside the seam's thunk runs on the loop; mark
            # fn-reference names so their defs get loop context.  The
            # seam call itself is legal from anywhere.
            for a in node.args:
                n = last_segment(a)
                if n:
                    self.loop_thunks.add(n)
                self.visit(a)
            for kw in node.keywords:
                self.visit(kw.value)
            return
        if not self.in_loop:
            if seg in self.loop_only:
                self.findings.append(Finding(
                    "loop-affinity", self.model.relpath, node.lineno,
                    f"loop-only '{seg}' called from pool/thread "
                    f"context without the call_soon_threadsafe seam"))
            elif seg in _LOOP_AFFINE_SEGS and \
                    root_segment(node.func) != "asyncio" and \
                    _looks_like_loop_receiver(node.func):
                self.findings.append(Finding(
                    "loop-affinity", self.model.relpath, node.lineno,
                    f"loop-affine '{seg}' used from pool/thread "
                    f"context; route it through call_soon_threadsafe"))
            elif seg == "set_result" and \
                    _looks_like_future_receiver(node.func):
                self.findings.append(Finding(
                    "loop-affinity", self.model.relpath, node.lineno,
                    "Future.set_result from pool/thread context; use "
                    "loop.call_soon_threadsafe(fut.set_result, ...)"))
        self.generic_visit(node)

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        self._deferred.append(node)

    def visit_AsyncFunctionDef(self, node: ast.AsyncFunctionDef) -> None:
        self._deferred.append(node)

    def finish(self) -> None:
        """Walk deferred nested defs with their resolved context."""
        for nested in self._deferred:
            ninfo = self.by_node.get(id(nested))
            nested_loop = (
                self.in_loop
                or isinstance(nested, ast.AsyncFunctionDef)
                or getattr(nested, "name", "") in self.loop_thunks
                or (ninfo is not None and ninfo.loop_only))
            sub = _AffinityVisitor(self.model, self.loop_only,
                                   self.findings, nested_loop,
                                   self.by_node)
            for stmt in nested.body:
                sub.visit(stmt)
            sub.finish()


def _looks_like_loop_receiver(func: ast.AST) -> bool:
    """`<...>.loop.call_later` / `loop.create_task` — receiver chain
    mentions a loop."""
    node = func
    while isinstance(node, ast.Attribute):
        node = node.value
        if isinstance(node, ast.Attribute) and "loop" in node.attr:
            return True
        if isinstance(node, ast.Name) and "loop" in node.id:
            return True
    return False


def _looks_like_future_receiver(func: ast.AST) -> bool:
    if not isinstance(func, ast.Attribute):
        return False
    recv = func.value
    seg = last_segment(recv)
    return seg is not None and ("future" in seg.lower()
                                or seg.lower() in ("fut", "f"))


def _check_loop_affinity(model: ModuleModel,
                         functions: List[FunctionInfo],
                         loop_only_names: Set[str]) -> List[Finding]:
    findings: List[Finding] = []
    by_node: Dict[int, FunctionInfo] = {
        id(info.node): info for info in functions
        if info.node is not None}

    # Only walk outermost defs/methods directly; nested defs are walked
    # by finish() so seam-scheduled thunks get loop context.
    seen_nested: Set[int] = set()
    for info in functions:
        if info.node is None or id(info.node) in seen_nested:
            continue
        for sub in ast.walk(info.node):
            if sub is not info.node and isinstance(
                    sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                seen_nested.add(id(sub))
        v = _AffinityVisitor(model, loop_only_names, findings,
                             _loop_context_def(info.node, info), by_node)
        for stmt in info.node.body:
            v.visit(stmt)
        v.finish()
    return findings


# ---------------------------------------------------------------------------
# async-lifecycle: timer handles and task objects.
# ---------------------------------------------------------------------------


class _LifecycleChecker:
    """Per-def: every call_later/create_task result must be retained;
    locally-retained handles must be cancelled, awaited, returned, or
    stored before every exit."""

    def __init__(self, model: ModuleModel, func: ast.AST,
                 findings: List[Finding]):
        self.model = model
        self.func = func
        self.findings = findings
        # name -> ("timer"|"task", lineno); removed once settled.
        self.live: Dict[str, Tuple[str, int]] = {}

    _RULE = {"timer": "async-timer-leak", "task": "async-task-orphan"}
    _WHAT = {"timer": "call_later handle", "task": "asyncio task"}

    def _producer_kind(self, node: ast.AST) -> Optional[str]:
        if not isinstance(node, ast.Call):
            return None
        seg = last_segment(node.func)
        if seg in _TIMER_SEGS:
            return "timer"
        if seg in _TASK_SEGS:
            return "task"
        return None

    def _settle(self, name: str) -> None:
        self.live.pop(name, None)

    def run(self) -> None:
        self._walk(self.func.body)
        # Handles still live at the natural end of the def never get
        # cancelled on this path.
        for name, (kind, line) in self.live.items():
            self.findings.append(Finding(
                self._RULE[kind], self.model.relpath, line,
                f"{self._WHAT[kind]} '{name}' in "
                f"{getattr(self.func, 'name', '<lambda>')} is never "
                f"cancelled, awaited, or handed off on some path"))

    def _walk(self, stmts: Sequence[ast.AST]) -> None:
        for stmt in stmts:
            self._stmt(stmt)

    def _stmt(self, node: ast.AST) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            return  # checked as their own defs
        if isinstance(node, ast.Expr):
            kind = self._producer_kind(node.value)
            if kind is not None:
                seg = last_segment(node.value.func)
                self.findings.append(Finding(
                    self._RULE[kind], self.model.relpath,
                    node.value.lineno,
                    f"{seg}(...) result dropped: the "
                    f"{self._WHAT[kind]} can never be cancelled"))
                return
            self._expr_effects(node.value)
            return
        if isinstance(node, ast.Assign):
            kind = self._producer_kind(node.value)
            if kind is not None and len(node.targets) == 1:
                tgt = node.targets[0]
                if isinstance(tgt, ast.Name):
                    self.live[tgt.id] = (kind, node.value.lineno)
                    return
                # self.X = call_later(...) — stored: owner's lifecycle.
                return
            self._expr_effects(node.value)
            # Reassignment of a live name loses the old handle — but a
            # common idiom re-arms (timer = call_later again after
            # cancel); keep it simple: reassignment settles.
            for tgt in node.targets:
                if isinstance(tgt, ast.Name):
                    self._settle(tgt.id)
                elif isinstance(tgt, (ast.Attribute, ast.Subscript)):
                    # handle stored somewhere: transfer.
                    if isinstance(node.value, ast.Name):
                        self._settle(node.value.id)
            return
        if isinstance(node, ast.Return):
            if node.value is not None:
                self._expr_effects(node.value)
                for sub in ast.walk(node.value):
                    if isinstance(sub, ast.Name):
                        self._settle(sub.id)
            return
        if isinstance(node, ast.Try):
            self._walk(node.body)
            for h in node.handlers:
                self._walk(h.body)
            self._walk(node.orelse)
            self._walk(node.finalbody)
            return
        if isinstance(node, (ast.If, ast.While)):
            self._expr_effects(node.test)
            self._walk(node.body)
            self._walk(node.orelse)
            return
        if isinstance(node, (ast.For, ast.AsyncFor)):
            self._expr_effects(node.iter)
            self._walk(node.body)
            self._walk(node.orelse)
            return
        if isinstance(node, (ast.With, ast.AsyncWith)):
            for item in node.items:
                self._expr_effects(item.context_expr)
            self._walk(node.body)
            return
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.stmt):
                self._stmt(child)
            else:
                self._expr_effects(child)

    def _expr_effects(self, node: ast.AST) -> None:
        for sub in ast.walk(node):
            if isinstance(sub, ast.Await):
                if isinstance(sub.value, ast.Name):
                    self._settle(sub.value.id)
                continue
            if not isinstance(sub, ast.Call):
                continue
            f = sub.func
            # handle.cancel() settles; await task settles via Await.
            if isinstance(f, ast.Attribute) and \
                    isinstance(f.value, ast.Name) and \
                    f.attr in _SETTLE_SEGS:
                self._settle(f.value.id)
            # fn(handle) / container.append(handle): hand-off.
            for a in list(sub.args) + [kw.value for kw in sub.keywords]:
                if isinstance(a, ast.Name):
                    self._settle(a.id)
                # A seam thunk whose *body is* the producer call throws
                # the handle away: call_soon(lambda: loop.call_later(
                # ...)) — the lambda's return value is discarded by the
                # loop, so nothing can ever cancel the timer.
                if isinstance(a, ast.Lambda):
                    kind = self._producer_kind(a.body)
                    if kind is not None:
                        seg = last_segment(a.body.func)
                        self.findings.append(Finding(
                            self._RULE[kind], self.model.relpath,
                            a.body.lineno,
                            f"{seg}(...) handle discarded by the "
                            f"scheduling thunk: the {self._WHAT[kind]} "
                            f"can never be cancelled"))


def _check_async_lifecycle(model: ModuleModel,
                           functions: List[FunctionInfo]
                           ) -> List[Finding]:
    findings: List[Finding] = []
    for info in functions:
        if info.node is None:
            continue
        # Each def is checked independently; nested defs are their own
        # entries in `functions`, so no double-walk guard is needed —
        # _stmt skips nested defs.
        _LifecycleChecker(model, info.node, findings).run()
    return findings
