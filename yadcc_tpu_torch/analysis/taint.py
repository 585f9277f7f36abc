"""Rule family 5: untrusted-taint — source → sanitizer → sink dataflow
across the trust boundary.

The servants execute bytes that arrive off the network; the delegate's
HTTP service buffers bytes from arbitrary local processes.  PRs 4-6
hand-placed the defenses (token fail-closed, claimed-digest
verification, decompression caps) at each intake — this pass makes the
discipline *structural*:

* **Sources** are declared on the intake functions with
  ``# ytpu: untrusted(req, attachment)`` trailing the ``def``.  A
  ``self.X`` entry marks an instance attribute as untrusted (the HTTP
  handler's ``self.rfile``/``self.headers``).
* **Sanitizers** are declared on the validation helpers with
  ``# ytpu: sanitizes(size-cap)`` (tags: ``size-cap``, ``path``,
  ``argv``, ``key-domain``, ``authz``, ``digest``, ``framing``...).
  Calling one applies its tags to the value (result and, for a bare
  ``self._verify(req.token)`` statement, to the argument's root).
  ``min(x, CONST)``/``max`` count as ``size-cap``; ``shlex.quote`` as
  ``argv``+``path``.
* **Sinks** require specific tags (core.SINK_REQUIRED_TAGS):
  allocation-sized reads (``size-cap``), timeout/wait durations
  (``size-cap``), filesystem path construction (``path``), subprocess
  argv (``argv``), cache keys (``key-domain``).

The pass is interprocedural by *summary*: each function records, on
the assumption its parameters are tainted, which sinks they reach and
which callees they flow into; a worklist then walks call edges from
the declared sources.  Callees resolve by name (method or function
last segment) — ambiguous names (>3 defs) and a stoplist of generic
verbs are skipped, erring toward false negatives like every other
family.  A tainted argument passed into a callee parameter whose name
says it is a duration (``timeout``/``*_to_wait``/...) is a wait sink at
the call site even when the callee body is opaque.

``taint-registry`` closes the workload seam: every ``TaskType(...)``
registration must name a factory that (transitively) routes its intake
through a ``sanitizes(size-cap)`` helper, so ROADMAP workloads 3-4
cannot land unvalidated by construction.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .core import (
    SINK_REQUIRED_TAGS,
    Finding,
    FunctionInfo,
    ModuleModel,
    _dotted,
    last_segment,
    root_segment,
)

# Builtin sanitizers, by call last segment.
_BUILTIN_SANITIZERS: Dict[str, Set[str]] = {
    "quote": {"argv", "path"},          # shlex.quote
}
# Calls whose result carries no taint regardless of arguments.
_CLEAN_CALLS = {"len", "bool", "id", "hash", "isinstance", "hasattr",
                "type", "repr", "hex", "oct", "enumerate", "range"}
# Parser-shaped calls that must NOT be treated as constructors even
# though they are CamelCase: their output is as untrusted as the input.
_PARSE_THROUGH = {"FromString", "ParseFromString", "Parse", "loads",
                  "load", "fromhex"}
# Callee names too generic to resolve by name without drowning in
# cross-class aliasing.
_RESOLUTION_STOPLIST = {
    "get", "put", "add", "pop", "update", "append", "remove", "close",
    "start", "stop", "run", "call", "write", "join", "split", "items",
    "keys", "values", "copy", "encode", "decode", "send", "recv",
    "submit", "result", "acquire", "release", "format", "strip",
}
_MAX_CANDIDATES = 3
_MAX_HOPS = 8

_WAIT_PARAM_RE = re.compile(
    r"(timeout|deadline|to_wait|wait_s$|_secs$|seconds)", re.IGNORECASE)

_PATH_CALL_LAST = {"remove", "rename", "rmtree", "unlink", "mkdir",
                   "makedirs", "replace", "join", "open"}
_ARGV_CALL_LAST = {"Popen", "start_program", "system", "check_output",
                   "check_call", "run"}
_CACHE_KEY_LAST = {"async_write", "try_read"}

_RULE_FOR_SINK = {
    "alloc": "taint-alloc",
    "wait": "taint-wait",
    "path": "taint-path",
    "argv": "taint-argv",
    "cache-key": "taint-cache-key",
}


def _is_constructor_name(name: str) -> bool:
    return bool(name) and name[0].isupper() and not name.isupper() \
        and name not in _PARSE_THROUGH


class _Summarizer:
    """Single in-order walk of one function body, assuming every
    parameter is tainted; emits the JSON summary the global worklist
    consumes."""

    def __init__(self, info: FunctionInfo,
                 sanitizer_map: Dict[str, Set[str]]):
        self.info = info
        self.sanitizers = sanitizer_map
        self.params: Set[str] = set(info.params)
        # self.X pseudo-params from untrusted(self.X) declarations.
        self.pseudo: Set[str] = {u for u in info.untrusted
                                 if u.startswith("self.")}
        self.origins: Dict[str, Set[str]] = {}
        self.applied: Dict[str, Set[str]] = {}
        self.sinks: List[dict] = []
        self.calls: List[dict] = []
        self.all_callees: Set[str] = set()
        self.returns_origins: Set[str] = set()
        self._call_seen: Set[int] = set()

    # -- expression evaluation --------------------------------------------

    def _sanitizer_tags(self, name: Optional[str]) -> Optional[Set[str]]:
        if name is None:
            return None
        if name in self.sanitizers:
            return set(self.sanitizers[name])
        if name in _BUILTIN_SANITIZERS:
            return set(_BUILTIN_SANITIZERS[name])
        return None

    def _root_spec(self, node: ast.AST) -> Optional[str]:
        """Name -> its id; self.X... -> "self.X"; else None."""
        if isinstance(node, ast.Name):
            return node.id
        chain: List[str] = []
        n = node
        while isinstance(n, ast.Attribute):
            chain.append(n.attr)
            n = n.value
        if isinstance(n, ast.Name):
            if n.id == "self" and chain:
                return f"self.{chain[-1]}"
            return n.id
        return None

    def eval_expr(self, node: ast.AST) -> Tuple[Set[str], Set[str]]:
        """(origin params, applied sanitizer tags) of an expression."""
        if isinstance(node, ast.Name):
            name = node.id
            if name in self.origins:
                return set(self.origins[name]), \
                    set(self.applied.get(name, ()))
            if name in self.params and name != "self":
                return {name}, set(self.applied.get(name, ()))
            return set(), set()
        if isinstance(node, ast.Attribute):
            spec = self._root_spec(node)
            if spec in self.pseudo:
                return {spec}, set(self.applied.get(spec, ()))
            return self.eval_expr(node.value)
        if isinstance(node, ast.Call):
            self._visit_call(node)
            name = last_segment(node.func)
            if name in _CLEAN_CALLS:
                return set(), set()
            if name is not None and _is_constructor_name(name):
                # Constructed objects carry state, not data taint; the
                # attribute-level flow is out of scope (doc honesty).
                for a in node.args:
                    self.eval_expr(a)
                return set(), set()
            origins: Set[str] = set()
            tag_sets: List[Set[str]] = []
            values = list(node.args) + [kw.value for kw in node.keywords]
            if isinstance(node.func, ast.Attribute):
                # A method call's result derives from its receiver too
                # (`self.headers.get(...)` is as untrusted as headers).
                values.append(node.func.value)
            for a in values:
                o, t = self.eval_expr(a)
                if o:
                    origins |= o
                    tag_sets.append(t)
            applied = set.intersection(*tag_sets) if tag_sets else set()
            san = self._sanitizer_tags(name)
            if san is not None:
                applied |= san
            elif name in ("min", "max") and any(
                    isinstance(a, ast.Constant) for a in node.args):
                applied |= {"size-cap"}
            return origins, applied
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda, ast.ClassDef)):
            return set(), set()
        origins = set()
        tag_sets = []
        for child in ast.iter_child_nodes(node):
            o, t = self.eval_expr(child)
            if o:
                origins |= o
                tag_sets.append(t)
        return origins, (set.intersection(*tag_sets)
                         if tag_sets else set())

    # -- call inspection (sinks + interprocedural edges) -------------------

    def _arg_state(self, node: ast.AST) -> Tuple[Set[str], Set[str]]:
        return self.eval_expr(node)

    def _record_sink(self, kind: str, line: int, origins: Set[str],
                     applied: Set[str], detail: str) -> None:
        for origin in origins:
            self.sinks.append({"param": origin, "sink": kind,
                               "line": line,
                               "applied": sorted(applied),
                               "detail": detail})

    def _visit_call(self, node: ast.Call) -> None:
        if id(node) in self._call_seen:
            return
        self._call_seen.add(id(node))
        name = last_segment(node.func)
        if name is None:
            return
        self.all_callees.add(name)
        dotted = _dotted(node.func) or name
        root = root_segment(node.func)

        def arg0():
            return node.args[0] if node.args else None

        # Sinks -----------------------------------------------------------
        if name == "read" and node.args:
            o, t = self._arg_state(node.args[0])
            if o and "size-cap" not in t:
                self._record_sink("alloc", node.lineno, o, t,
                                  f"{dotted}(n)")
        if name == "bytearray" and node.args:
            o, t = self._arg_state(node.args[0])
            if o and "size-cap" not in t:
                self._record_sink("alloc", node.lineno, o, t,
                                  "bytearray(n)")
        if name == "sleep" and node.args:
            o, t = self._arg_state(node.args[0])
            if o and "size-cap" not in t:
                self._record_sink("wait", node.lineno, o, t,
                                  f"{dotted}(t)")
        for kw in node.keywords:
            if kw.arg and _WAIT_PARAM_RE.search(kw.arg):
                o, t = self._arg_state(kw.value)
                if o and "size-cap" not in t:
                    self._record_sink("wait", node.lineno, o, t,
                                      f"{dotted}({kw.arg}=...)")
        if name in _PATH_CALL_LAST and (root in ("os", "shutil", "Path")
                                        or name == "open"):
            a = arg0()
            if a is not None:
                o, t = self._arg_state(a)
                if o and "path" not in t:
                    self._record_sink("path", node.lineno, o, t,
                                      f"{dotted}(...)")
        if name == "Path" and node.args:
            o, t = self._arg_state(node.args[0])
            if o and "path" not in t:
                self._record_sink("path", node.lineno, o, t, "Path(...)")
        if name in _ARGV_CALL_LAST:
            for a in list(node.args) + [kw.value for kw in node.keywords]:
                o, t = self._arg_state(a)
                if o and "argv" not in t:
                    self._record_sink("argv", node.lineno, o, t,
                                      f"{dotted}(...)")
        if name in _CACHE_KEY_LAST and node.args:
            o, t = self._arg_state(node.args[0])
            # Record unless the FULL required set is already applied:
            # a key-domain-only derivation must still reach the
            # worklist so the missing tenant-domain separator is
            # reported.
            if o and not SINK_REQUIRED_TAGS["cache-key"] <= t:
                self._record_sink("cache-key", node.lineno, o, t,
                                  f"{dotted}(key)")

        # Interprocedural edge --------------------------------------------
        if name in _RESOLUTION_STOPLIST or name in _CLEAN_CALLS \
                or self._sanitizer_tags(name) is not None:
            return
        args: List[dict] = []
        for i, a in enumerate(node.args):
            o, t = self._arg_state(a)
            if o:
                args.append({"pos": i, "kw": None,
                             "origins": sorted(o), "applied": sorted(t)})
        for kw in node.keywords:
            if kw.arg is None:
                continue
            o, t = self._arg_state(kw.value)
            if o:
                args.append({"pos": None, "kw": kw.arg,
                             "origins": sorted(o), "applied": sorted(t)})
        if args:
            self.calls.append({
                "callee": name, "line": node.lineno,
                "method": isinstance(node.func, ast.Attribute),
                "args": args,
            })

    # -- statement walk ----------------------------------------------------

    def _assign(self, target: ast.AST, origins: Set[str],
                applied: Set[str]) -> None:
        if isinstance(target, ast.Name):
            self.origins[target.id] = origins
            self.applied[target.id] = applied
        elif isinstance(target, (ast.Tuple, ast.List)):
            for el in target.elts:
                self._assign(el, set(origins), set(applied))
        # Attribute / subscript stores: object state is out of scope.

    def walk(self, stmts: Sequence[ast.AST]) -> None:
        for stmt in stmts:
            self._walk_stmt(stmt)

    def _walk_stmt(self, node: ast.AST) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            return  # summarized separately, without closure context
        if isinstance(node, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
            value = node.value
            if value is None:
                return
            o, t = self.eval_expr(value)
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for tgt in targets:
                if isinstance(node, ast.AugAssign) and \
                        isinstance(tgt, ast.Name):
                    prev = self.origins.get(tgt.id, set())
                    o = o | prev
                self._assign(tgt, o, t)
            return
        if isinstance(node, ast.Expr) and isinstance(node.value, ast.Call):
            call = node.value
            name = last_segment(call.func)
            san = self._sanitizer_tags(name)
            self.eval_expr(call)
            if san is not None:
                # Statement-form sanitizer (`self._verify(req.token)`)
                # blesses the argument roots from here on.
                for a in list(call.args) + [kw.value
                                            for kw in call.keywords]:
                    spec = self._root_spec(a)
                    if spec:
                        self.applied.setdefault(spec, set()).update(san)
            return
        if isinstance(node, ast.Return):
            if node.value is not None:
                o, _ = self.eval_expr(node.value)
                self.returns_origins |= o
            return
        if isinstance(node, (ast.If, ast.While)):
            self.eval_expr(node.test)
            self.walk(node.body)
            self.walk(node.orelse)
            return
        if isinstance(node, ast.For):
            o, t = self.eval_expr(node.iter)
            self._assign(node.target, o, t)
            self.walk(node.body)
            self.walk(node.orelse)
            return
        if isinstance(node, (ast.With, ast.AsyncWith)):
            for item in node.items:
                o, t = self.eval_expr(item.context_expr)
                if item.optional_vars is not None:
                    self._assign(item.optional_vars, o, t)
            self.walk(node.body)
            return
        if isinstance(node, ast.Try):
            self.walk(node.body)
            for h in node.handlers:
                self.walk(h.body)
            self.walk(node.orelse)
            self.walk(node.finalbody)
            return
        if isinstance(node, (ast.Raise, ast.Assert, ast.Delete)):
            for child in ast.iter_child_nodes(node):
                self.eval_expr(child)
            return
        if isinstance(node, ast.Expr):
            self.eval_expr(node.value)
            return
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.stmt):
                self._walk_stmt(child)
            else:
                self.eval_expr(child)


def summarize_function(info: FunctionInfo,
                       sanitizer_map: Dict[str, Set[str]]) -> dict:
    s = _Summarizer(info, sanitizer_map)
    if info.node is not None:
        s.walk(info.node.body)
    return {
        "params": list(info.params),
        "pseudo": sorted(s.pseudo),
        "sinks": s.sinks,
        "calls": s.calls,
        "all_callees": sorted(s.all_callees),
        "returns": sorted(s.returns_origins),
    }


def summarize_functions(model: ModuleModel,
                        functions: List[FunctionInfo],
                        sanitizer_map: Dict[str, Set[str]]) -> None:
    for info in functions:
        info.taint = summarize_function(info, sanitizer_map)


# ---------------------------------------------------------------------------
# Global worklist.
# ---------------------------------------------------------------------------


def check_global(functions: Sequence[FunctionInfo],
                 tasktype_sites: Sequence[dict],
                 sanitizer_map: Dict[str, Set[str]]) -> List[Finding]:
    findings: List[Finding] = []
    by_name: Dict[str, List[FunctionInfo]] = {}
    by_qual: Dict[str, FunctionInfo] = {}
    for info in functions:
        by_name.setdefault(info.name, []).append(info)
        by_qual[info.qualname] = info

    # Seeds: declared untrusted params (and self.X pseudo-params).
    work: List[Tuple[str, str, frozenset, int]] = []
    for info in functions:
        for spec in info.untrusted:
            if spec.startswith("self.") or spec in info.params:
                work.append((info.qualname, spec, frozenset(), 0))
            else:
                findings.append(Finding(
                    "taint-registry", info.relpath, info.lineno,
                    f"untrusted({spec}) names no parameter of "
                    f"{info.name}"))

    visited: Set[Tuple[str, str, frozenset]] = set()
    emitted: Set[Tuple[str, str, int, str]] = set()

    def emit(rule: str, relpath: str, line: int, msg: str) -> None:
        key = (rule, relpath, line, msg)
        if key not in emitted:
            emitted.add(key)
            findings.append(Finding(rule, relpath, line, msg))

    while work:
        qual, param, inherited, hops = work.pop()
        key = (qual, param, inherited)
        if key in visited or hops > _MAX_HOPS:
            continue
        visited.add(key)
        info = by_qual.get(qual)
        if info is None or not info.taint:
            continue
        summary = info.taint
        for sink in summary["sinks"]:
            if sink["param"] != param:
                continue
            effective = inherited | set(sink["applied"])
            required = SINK_REQUIRED_TAGS[sink["sink"]]
            missing = required - effective
            if missing:
                emit(_RULE_FOR_SINK[sink["sink"]], info.relpath,
                     sink["line"],
                     f"untrusted '{param}' in {info.name} reaches "
                     f"{sink['detail']} without a "
                     f"{'/'.join(sorted(missing))} sanitizer")
        for call in summary["calls"]:
            callee = call["callee"]
            cands = by_name.get(callee, [])
            if not cands or len(cands) > _MAX_CANDIDATES:
                continue
            for arg in call["args"]:
                if param not in arg["origins"]:
                    continue
                effective = inherited | set(arg["applied"])
                for cand in cands:
                    if not cand.taint:
                        continue
                    plist = list(cand.taint["params"])
                    if call["method"] and plist and plist[0] == "self":
                        plist = plist[1:]
                    target: Optional[str] = None
                    if arg["kw"] is not None:
                        if arg["kw"] in plist:
                            target = arg["kw"]
                    elif arg["pos"] is not None and \
                            arg["pos"] < len(plist):
                        target = plist[arg["pos"]]
                    if target is None:
                        continue
                    if _WAIT_PARAM_RE.search(target) and \
                            "size-cap" not in effective:
                        emit("taint-wait", info.relpath, call["line"],
                             f"untrusted '{param}' controls "
                             f"{callee}({target}=...) without a "
                             f"size-cap sanitizer")
                    work.append((cand.qualname, target,
                                 frozenset(effective), hops + 1))

    findings.extend(_check_registry(tasktype_sites, by_name,
                                    sanitizer_map))
    return findings


def _reaches_sanitizer(name: str, by_name: Dict[str, List[FunctionInfo]],
                       sanitizer_map: Dict[str, Set[str]],
                       want: str = "size-cap",
                       depth: int = 4,
                       class_methods: Optional[
                           Dict[str, List[FunctionInfo]]] = None
                       ) -> bool:
    """Does `name` (a factory) transitively call a helper annotated
    ``sanitizes(<want>...)``?

    ``class_methods`` (class name -> its method FunctionInfos) lets the
    walk hop through a constructor: a factory that builds
    ``CxxTask(...)`` reaches whatever the task's OWN methods reach.
    The hop resolves methods by identity, not by bare name — a
    same-named method on an unrelated class (every task class defines
    ``get_cache_key``) must not lend its sanitizers to this one."""

    def _scan(info: FunctionInfo, nxt: List[str]) -> bool:
        if want in info.sanitizes:
            return True
        if info.taint:
            for call in info.taint["calls"]:
                nxt.append(call["callee"])
            # calls without tainted args are not recorded in the
            # taint summary; fall back to the sink/call-free scan
            # recorded at summary time via all_callees.
            for c in info.taint.get("all_callees", ()):
                nxt.append(c)
        return False

    seen: Set[str] = set()
    frontier = [name]
    for _ in range(depth + 1):
        nxt: List[str] = []
        for n in frontier:
            if n in seen:
                continue
            seen.add(n)
            if want in sanitizer_map.get(n, set()):
                return True
            if class_methods and n in class_methods:
                for info in class_methods[n]:
                    if _scan(info, nxt):
                        return True
                continue
            for info in by_name.get(n, []):
                if _scan(info, nxt):
                    return True
        frontier = nxt
        if not frontier:
            break
    return False


def _check_registry(tasktype_sites: Sequence[dict],
                    by_name: Dict[str, List[FunctionInfo]],
                    sanitizer_map: Dict[str, Set[str]]
                    ) -> List[Finding]:
    findings: List[Finding] = []
    # Class name -> its method infos, for the constructor hop (a
    # factory's cache keys are derived by the task object it builds).
    class_methods: Dict[str, List[FunctionInfo]] = {}
    for infos in by_name.values():
        for info in infos:
            if "." in info.qualname:
                cls = info.qualname.rsplit(".", 2)[-2]
                class_methods.setdefault(cls, []).append(info)
    for site in tasktype_sites:
        kind = site.get("kind") or "?"
        factories = [f for f in site.get("factories", ())
                     if f in by_name or f in sanitizer_map]
        ok = any(_reaches_sanitizer(f, by_name, sanitizer_map)
                 for f in factories)
        if not ok:
            findings.append(Finding(
                "taint-registry", site["relpath"], site["line"],
                f"TaskType kind={kind!r}: make_task factory "
                f"{site.get('factories') or '<unresolved>'} cannot be "
                f"proven to route its intake through a "
                f"sanitizes(size-cap) validation helper"))
        # Tenancy seam: a kind that derives cache keys
        # (reaches a key-domain helper) must derive them through the
        # tenant-domain separator too, or its artifacts land in one
        # shared namespace and the cryptographic isolation silently
        # ends at this workload.  Kinds with no cache surface have
        # nothing to scope and are exempt.
        derives = any(_reaches_sanitizer(f, by_name, sanitizer_map,
                                         want="key-domain",
                                         class_methods=class_methods)
                      for f in factories)
        if derives and not any(
                _reaches_sanitizer(f, by_name, sanitizer_map,
                                   want="tenant-domain",
                                   class_methods=class_methods)
                for f in factories):
            findings.append(Finding(
                "taint-registry", site["relpath"], site["line"],
                f"TaskType kind={kind!r}: derives cache keys without "
                f"the sanitizes(tenant-domain) separator "
                f"(tenancy/keys.py tenant_scoped_key) — artifacts "
                f"would share one namespace across tenants"))
    return findings
