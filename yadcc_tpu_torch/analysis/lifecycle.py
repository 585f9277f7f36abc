"""Rule family 6: resource lifecycle — acquire/release pairing across
exception paths.

Leases, temp workspaces (daemon/temp_dir.py, cloud/temporary.py),
executor pools, file/socket handles and subprocesses must not leak
when the code between acquisition and release raises.  Three rules:

* ``lifecycle-leak`` — an acquired resource bound to a local that is
  never released, never ``with``-managed and never escapes (returned,
  stored on an object, handed to a constructor/container).
* ``lifecycle-exc-path`` — a release exists, but only in straight-line
  flow with raise-capable calls between acquire and release: the happy
  path cleans up, the exception path leaks.  A release inside a
  ``finally`` or an ``except`` handler (the re-raise cleanup idiom)
  counts as exception-safe.
* ``lifecycle-view-escape`` — a ``memoryview`` over a *local mutable*
  buffer (``bytearray``) escapes the function; the receiver holds a
  view whose contents the function's caller can no longer reason
  about.  (Views over immutable ``bytes``/request frames are the data
  plane's whole point and are fine — the backing buffer is pinned and
  frozen.)

Acquire sites are a builtin table (open/mkdtemp/TemporaryDir/socket/
Popen/ThreadPoolExecutor/...) plus any function annotated
``# ytpu: acquires(<tag>)`` — calling an annotated method marks its
*receiver* as holding the resource (``task.prepare(...)`` makes
``task`` the thing that must not leak), which is how the servant
handlers' workspace discipline is checked across files.

Ownership transfer is honest, not paranoid: returning the resource,
storing it on ``self``/a container, passing it to a CamelCase
constructor, or capturing it in a closure (builtin acquires only) all
hand responsibility to someone this pass cannot see — no finding.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Sequence, Set

from .core import (
    AnalyzerConfig,
    Finding,
    ModuleModel,
    last_segment,
    root_segment,
)

# Call last segment -> resource kind.
ACQUIRE_SEGS: Dict[str, str] = {
    "open": "file handle",
    "mkdtemp": "temp dir",
    "mkstemp": "temp file",
    "make_temp_dir": "temp dir",
    "TemporaryDir": "temp workspace",
    "NamedTemporaryFile": "temp file",
    "TemporaryFile": "temp file",
    "socket": "socket",
    "create_connection": "socket",
    "ThreadPoolExecutor": "executor pool",
    "ProcessPoolExecutor": "executor pool",
    "Popen": "subprocess",
    "start_program": "subprocess",
}

RELEASE_SEGS = {"close", "remove", "shutdown", "terminate", "kill",
                "release", "stop", "cleanup", "wait", "rmtree",
                "unlink", "communicate", "__exit__"}

# Passing the resource into one of these transfers ownership to a
# container/pool the pass cannot track.
_TRANSFER_SEGS = {"append", "add", "put", "register", "submit",
                  "setdefault", "extend", "insert"}


class _Resource:
    def __init__(self, name: str, kind: str, line: int, order: int,
                 annotated: bool):
        self.names: Set[str] = {name}
        self.kind = kind
        self.line = line
        self.order = order
        self.annotated = annotated
        self.releases: List[dict] = []   # {"ctx": str, "order": int}
        self.escaped = False
        self.managed = False             # later used as `with res:`


class _FnChecker:
    def __init__(self, model: ModuleModel, fn: ast.AST,
                 acquires_names: Set[str], findings: List[Finding]):
        self.model = model
        self.fn = fn
        self.acquires_names = acquires_names
        self.findings = findings
        self.resources: List[_Resource] = []
        self.order = 0
        self.risky: List[int] = []       # order indexes of raise-capable calls
        self.mutable_locals: Set[str] = set()   # bytearray locals
        self.view_vars: Set[str] = set()        # views over them

    # -- helpers -----------------------------------------------------------

    def _res_for(self, name: str) -> Optional[_Resource]:
        for r in self.resources:
            if name in r.names:
                return r
        return None

    def _acquire_in(self, value: ast.AST) -> Optional[str]:
        """Kind when `value` is (or wraps) an acquire call."""
        for node in ast.walk(value):
            if isinstance(node, ast.Call):
                seg = last_segment(node.func)
                if seg in ACQUIRE_SEGS:
                    return ACQUIRE_SEGS[seg]
        return None

    # Calls that materialize a fresh value: a name passed INTO one of
    # these neither escapes nor transfers (``return bytes(view)`` is
    # the recommended fix for a view escape, not another escape).
    _MATERIALIZE = {"bytes", "str", "list", "tuple", "len", "sum",
                    "sorted", "min", "max", "int", "float", "bool",
                    "hash", "repr"}

    def _names_in(self, node: ast.AST) -> Set[str]:
        out: Set[str] = set()

        def visit(n: ast.AST) -> None:
            if isinstance(n, ast.Call) and \
                    last_segment(n.func) in self._MATERIALIZE:
                return
            if isinstance(n, ast.Name):
                out.add(n.id)
            for child in ast.iter_child_nodes(n):
                visit(child)

        visit(node)
        return out

    def _mark_escape(self, node: ast.AST) -> None:
        for name in self._names_in(node):
            r = self._res_for(name)
            if r is not None:
                r.escaped = True
            if name in self.view_vars:
                self.findings.append(Finding(
                    "lifecycle-view-escape", self.model.relpath,
                    getattr(node, "lineno", 1),
                    f"memoryview over local mutable buffer "
                    f"'{name}' escapes the function (hand out bytes, "
                    f"or let the caller own the buffer)"))
                self.view_vars.discard(name)

    # -- the walk ----------------------------------------------------------

    def run(self) -> None:
        self._walk(self.fn.body, ctx="plain")
        for r in self.resources:
            if r.managed or r.escaped:
                continue
            if not r.releases:
                self.findings.append(Finding(
                    "lifecycle-leak", self.model.relpath, r.line,
                    f"{r.kind} acquired here is never released, "
                    f"with-managed, or handed off"))
                continue
            if any(rel["ctx"] in ("finally", "except")
                   for rel in r.releases):
                continue
            first_rel = min(rel["order"] for rel in r.releases)
            if any(r.order < i < first_rel for i in self.risky):
                self.findings.append(Finding(
                    "lifecycle-exc-path", self.model.relpath, r.line,
                    f"{r.kind} released only on the happy path: calls "
                    f"between acquire and release can raise past the "
                    f"cleanup (use with / try-finally / except+raise)"))

    def _walk(self, stmts: Sequence[ast.AST], ctx: str) -> None:
        for stmt in stmts:
            self._stmt(stmt, ctx)

    def _stmt(self, node: ast.AST, ctx: str) -> None:
        self.order += 1
        order = self.order
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            # Closure capture: a builtin-acquired resource referenced in
            # a nested def outlives this frame in ways we cannot track.
            for name in self._names_in(node):
                r = self._res_for(name)
                if r is not None and not r.annotated:
                    r.escaped = True
                if name in self.view_vars:
                    self.view_vars.discard(name)
            return
        if isinstance(node, ast.ClassDef):
            return
        if isinstance(node, (ast.With, ast.AsyncWith)):
            for item in node.items:
                root = root_segment(item.context_expr)
                if root is not None:
                    r = self._res_for(root)
                    if r is not None:
                        r.managed = True
                self._scan_calls(item.context_expr, ctx)
            self._walk(node.body, ctx)
            return
        if isinstance(node, ast.Try):
            has_final = bool(node.finalbody)
            self._walk(node.body,
                       "try-with-finally" if has_final else ctx)
            for h in node.handlers:
                self._walk(h.body, "except")
            self._walk(node.orelse, ctx)
            self._walk(node.finalbody, "finally")
            return
        if isinstance(node, (ast.If, ast.While)):
            self._scan_calls(node.test, ctx)
            self._walk(node.body, ctx)
            self._walk(node.orelse, ctx)
            return
        if isinstance(node, ast.For):
            self._scan_calls(node.iter, ctx)
            self._walk(node.body, ctx)
            self._walk(node.orelse, ctx)
            return
        if isinstance(node, (ast.Return, ast.Yield, ast.YieldFrom)):
            if getattr(node, "value", None) is not None:
                self._mark_escape(node.value)
                self._scan_calls(node.value, ctx)
            return
        if isinstance(node, ast.Expr) and isinstance(node.value, ast.Yield):
            if node.value.value is not None:
                self._mark_escape(node.value.value)
            return
        if isinstance(node, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
            value = node.value
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            if value is not None:
                self._scan_calls(value, ctx)
                name_target = targets[0] if len(targets) == 1 and \
                    isinstance(targets[0], ast.Name) else None
                # Acquisition into a local.  The resource's order is
                # taken AFTER scanning the value, so the acquire call
                # itself never reads as a risky call "between" acquire
                # and release.
                kind = self._acquire_in(value)
                annotated_recv = self._annotated_acquire_recv(value)
                if name_target is not None and kind is not None:
                    self.resources.append(_Resource(
                        name_target.id, kind, node.lineno, self.order,
                        False))
                elif annotated_recv is not None and name_target is not None:
                    self.resources.append(_Resource(
                        name_target.id, "annotated resource",
                        node.lineno, self.order, True))
                # Aliasing: y = x.
                if name_target is not None and isinstance(value, ast.Name):
                    r = self._res_for(value.id)
                    if r is not None:
                        r.names.add(name_target.id)
                    if value.id in self.view_vars:
                        self.view_vars.add(name_target.id)
                # bytearray locals + views over them.
                if name_target is not None and isinstance(value, ast.Call):
                    seg = last_segment(value.func)
                    if seg == "bytearray":
                        self.mutable_locals.add(name_target.id)
                    if seg == "memoryview" and value.args and \
                            isinstance(value.args[0], ast.Name) and \
                            value.args[0].id in self.mutable_locals:
                        self.view_vars.add(name_target.id)
                # Store to attribute/subscript = ownership transfer.
                for tgt in targets:
                    if isinstance(tgt, (ast.Attribute, ast.Subscript)) \
                            and value is not None:
                        self._mark_escape(value)
            return
        self._scan_calls(node, ctx)

    def _annotated_acquire_recv(self, value: ast.AST) -> Optional[str]:
        for node in ast.walk(value):
            if isinstance(node, ast.Call):
                seg = last_segment(node.func)
                if seg in self.acquires_names:
                    return seg
        return None

    def _scan_calls(self, node: ast.AST, ctx: str) -> None:
        for sub in ast.walk(node):
            if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef,
                                ast.Lambda)):
                for name in self._names_in(sub):
                    r = self._res_for(name)
                    if r is not None and not r.annotated:
                        r.escaped = True
                continue
            if not isinstance(sub, ast.Call):
                continue
            seg = last_segment(sub.func)
            self.order += 1
            order = self.order
            # Annotated acquire on a receiver: `task.prepare(...)`.
            if seg in self.acquires_names and \
                    isinstance(sub.func, ast.Attribute):
                root = root_segment(sub.func)
                if root is not None and root != "self" and \
                        self._res_for(root) is None:
                    self.resources.append(_Resource(
                        root, "annotated resource", sub.lineno, order,
                        True))
                    continue
            # Release?
            released = False
            if seg in RELEASE_SEGS:
                if isinstance(sub.func, ast.Attribute):
                    root = root_segment(sub.func)
                    r = self._res_for(root) if root else None
                    if r is not None:
                        r.releases.append({"ctx": ctx, "order": order})
                        released = True
                for a in sub.args:
                    if isinstance(a, ast.Name):
                        r = self._res_for(a.id)
                        if r is not None:
                            r.releases.append({"ctx": ctx,
                                               "order": order})
                            released = True
            if released:
                continue
            # Transfer?
            if seg is not None and (
                    (seg[0].isupper() and not seg.isupper())
                    or seg in _TRANSFER_SEGS):
                for a in list(sub.args) + [kw.value
                                           for kw in sub.keywords]:
                    self._mark_escape(a)
                continue
            # Any other call can raise.
            self.risky.append(order)


def check_module(model: ModuleModel, config: AnalyzerConfig,
                 acquires_names: Set[str]) -> List[Finding]:
    findings: List[Finding] = []
    for node in ast.walk(model.tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            _FnChecker(model, node, acquires_names, findings).run()
    return findings
