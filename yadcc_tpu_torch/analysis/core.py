"""Analyzer infrastructure: directives, lock discovery, held-lock walk.

Everything here is shared by the rule families (lockrules.py,
jit_hygiene.py): parsing ``# guarded by:`` / ``# ytpu: allow(...)``
comments, discovering which attributes of a class are locks (and which
Conditions wrap which locks), and walking a function body while
tracking the set of locks statically known to be held.

Scope and honesty notes:

* The walk is intraprocedural.  ``*_locked`` methods are assumed to
  run with their class's *primary* lock held (``self._lock`` when the
  class has one, else its only lock attribute) — that is exactly the
  convention the suffix declares.  Cross-class and cross-function
  acquisition chains are the runtime locktrace's job.
* A nested ``def`` inherits the held set of its definition site.  For
  the synchronous helper-closure idiom this is right; a closure stashed
  and called later from another thread is invisible to this pass.
* Lock acquisition is recognized on ``with`` statements only.  Raw
  ``.acquire()``/``.release()`` pairs (the locktrace proxy internals)
  are not tracked.
"""

from __future__ import annotations

import ast
import os
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

RULES: Dict[str, str] = {
    "guarded-by": "guarded attribute accessed without its declared lock",
    "locked-call": "*_locked method called from a site not holding the lock",
    "lock-order": "nested lock acquisition undeclared or inverting the "
                  "declared hierarchy (analysis/lock_hierarchy.toml)",
    "block-under-lock": "blocking call (sleep / I/O / RPC / device sync) "
                        "inside a lock body on a scheduler/daemon hot path",
    "aio-blocking": "blocking call (sleep / file or socket I/O / sync RPC "
                    ".call / bare wait) inside an async coroutine in the "
                    "event-loop front end (rpc/)",
    "jit-nondet": "wall-clock read or unseeded randomness inside a "
                  "device function (a kernel wrapper or its plain "
                  "version)",
    "jit-tracer-if": "Python branch on the value of a tensor parameter "
                     "inside a device function (a hidden .item() on "
                     "CUDA)",
    "jit-static-unhashable": "unhashable value bound to a static jit "
                             "argument (no port object: the port has "
                             "no cache keyed by call arguments)",
    "device-sync": "host-blocking device sync (np.asarray / .item() / "
                   ".tolist() / .cpu() / .numpy() / synchronize / "
                   ".to('cpu')) in a dispatcher-cycle module",
    "taint-alloc": "allocation / read sized by an untrusted integer "
                   "without a size-cap sanitizer",
    "taint-wait": "untrusted value controls a timeout/wait duration "
                  "without a size-cap sanitizer",
    "taint-path": "untrusted value reaches filesystem path construction "
                  "without a path sanitizer",
    "taint-argv": "untrusted value reaches subprocess argv without an "
                  "argv sanitizer (shlex.quote)",
    "taint-cache-key": "untrusted value used as a cache key without a "
                       "key-domain sanitizer",
    "taint-registry": "a registered TaskType whose factory cannot be "
                      "proven to route its intake through validation",
    "lifecycle-leak": "acquired resource neither released, escaped, nor "
                      "with-managed on some path",
    "lifecycle-exc-path": "resource released only on the happy path "
                          "(no with / try-finally / except cleanup)",
    "lifecycle-view-escape": "memoryview over a local mutable buffer "
                             "escapes the function",
    "wire-drift": "api/protos/*.proto disagrees with the committed "
                  "api/gen/*_pb2.py descriptor",
    "wire-golden": "wire format diverged from the committed golden "
                   "descriptor (analysis/wire_golden.json)",
    "wire-unknown-field": "message constructed with a field name the "
                          "descriptor does not define",
    "reply-drop": "a path through a responder-annotated handler or "
                  "continuation neither replies, hands the responder "
                  "off, nor raises (the parked client is dropped)",
    "reply-double": "a reachable second direct reply on one execution "
                    "path (double-fire into a settled stream)",
    "reply-handoff": "responder handed to a resolvable callee whose "
                     "receiving parameter is not declared "
                     "# ytpu: responder(param)",
    "await-under-lock": "await while a threading lock is held "
                        "(lexically or via the *_locked convention): "
                        "the whole event loop stalls behind the lock",
    "loop-affinity": "loop-only method called, or loop-affine "
                     "primitive (loop.call_later / create_task / "
                     "Future.set_result) used, outside loop context "
                     "without the call_soon_threadsafe seam",
    "async-timer-leak": "loop timer handle dropped at creation or "
                        "never cancelled / handed off: the timer "
                        "outlives the continuation it guards",
    "async-task-orphan": "asyncio task neither awaited, cancelled, "
                         "retained nor handed off (orphaned tasks "
                         "silently eat exceptions)",
    "repl-journal-skip": "a mutation path of a # ytpu: replicated(...) "
                         "method commits to the wrapped dispatcher "
                         "without a post-commit journal append (or "
                         "appends before the commit / on an exception "
                         "path)",
    "repl-journal-under-lock": "lease-journal append while a lock is "
                               "held: the rank-4 leaf journal must only "
                               "be taken at the call boundary, never "
                               "nested under dispatcher state locks",
    "grant-id-arith": "bare arithmetic on a grant id outside the "
                      "blessed namespace helpers, or a (start, stride) "
                      "construction that breaks the cell x shard "
                      "stride composition",
    "takeover-order": "a # ytpu: protocol(a<b<...) step reached on a "
                      "path where an earlier declared step has not "
                      "happened (e.g. promote before the adoption "
                      "window is established)",
    "suppression": "malformed suppression or suppression without a "
                   "written reason",
    "parse-error": "file could not be parsed",
}

# Sink kind -> sanitizer tags that clear it (taint family).  Cache
# keys require BOTH the versioned-prefix discipline (key-domain) and
# the tenant-domain separator (tenancy/keys.py): a key that reaches
# the store without passing through tenant_scoped_key (or a helper
# annotated as applying it) would silently merge tenants back into one
# namespace — exactly the cross-tenant read/poison surface the
# multi-tenant QoS work closes.
SINK_REQUIRED_TAGS: Dict[str, frozenset] = {
    "alloc": frozenset({"size-cap"}),
    "wait": frozenset({"size-cap"}),
    "path": frozenset({"path"}),
    "argv": frozenset({"argv"}),
    "cache-key": frozenset({"key-domain", "tenant-domain"}),
}

# Factories whose call result is a lock / a condition.  Matched on the
# last dotted segment so `threading.Lock`, bare `Lock` (from-import) and
# locktrace's `_real_lock` all register.
LOCK_FACTORIES = {"Lock", "allocate_lock", "_real_lock"}
RLOCK_FACTORIES = {"RLock", "_real_rlock"}
COND_FACTORIES = {"Condition"}

# Methods in which unguarded access to guarded attributes is legal: the
# object is not yet (or no longer) shared.
CONSTRUCTION_METHODS = {"__init__", "__new__", "__post_init__", "__del__"}

_SUPPRESS_RE = re.compile(
    r"#\s*ytpu:\s*allow\(\s*([A-Za-z0-9_*,\- ]*)\s*\)\s*(.*)$")
_GUARD_RE = re.compile(r"#\s*guarded by:\s*([A-Za-z0-9_.\[\]'\"]+)\s*$")
# Trust-boundary directives (taint + lifecycle families).  All three
# ride the `def` line (or a line of its signature / the line directly
# above its first decorator) as trailing comments:
#
#   def decompress(data, cap):   # ytpu: sanitizes(size-cap)
#   def prepare(self, src):      # ytpu: acquires(workspace)
#   def QueueTask(self, req, attachment, ctx):  # ytpu: untrusted(req, attachment)
_SANITIZES_RE = re.compile(r"#\s*ytpu:\s*sanitizes\(\s*([A-Za-z0-9_,\- ]*)\s*\)")
_ACQUIRES_RE = re.compile(r"#\s*ytpu:\s*acquires\(\s*([A-Za-z0-9_,\- ]*)\s*\)")
_UNTRUSTED_RE = re.compile(
    r"#\s*ytpu:\s*untrusted\(\s*([A-Za-z0-9_.,\s]*)\s*\)")
# Async-protocol directives (asyncproto family).  Both ride the def
# line the same way the trust-boundary directives do:
#
#   def WaitParked(self, req, att, ctx, done):  # ytpu: responder(done)
#   def send_payload(self, seq, payload):       # ytpu: loop-only
_RESPONDER_RE = re.compile(
    r"#\s*ytpu:\s*responder\(\s*([A-Za-z0-9_,\s]*)\s*\)")
_LOOP_ONLY_RE = re.compile(r"#\s*ytpu:\s*loop-only\b")
# Replication-protocol directives (replproto family).  Both ride the
# def line like the trust-boundary directives:
#
#   def free_task(self, loc, gids):  # ytpu: replicated(free)
#     -> every mutation path of this method must pair the commit with a
#        post-commit journal append carrying one of the declared ops.
#   def takeover(self):  # ytpu: protocol(freeze<replay<adopt<window<promote)
#     -> declared step order; every path must hit steps in order.
_REPLICATED_RE = re.compile(
    r"#\s*ytpu:\s*replicated\(\s*([A-Za-z0-9_,\s]*)\s*\)")
_PROTOCOL_RE = re.compile(
    r"#\s*ytpu:\s*protocol\(\s*([A-Za-z0-9_<\s]*)\s*\)")


@dataclass
class Finding:
    rule: str
    path: str
    line: int
    message: str
    suppressed: bool = False

    def location(self) -> str:
        return f"{self.path}:{self.line}"

    def render(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"

    def as_dict(self) -> dict:
        return {"rule": self.rule, "path": self.path, "line": self.line,
                "message": self.message, "suppressed": self.suppressed}


def baseline_key(f: Finding) -> str:
    """Line-number-free identity for --baseline files: unrelated edits
    shifting a file must not invalidate the whole baseline."""
    import hashlib

    digest = hashlib.sha256(f.message.encode()).hexdigest()[:12]
    return f"{f.rule}|{f.path}|{digest}"


@dataclass
class Suppression:
    line: int
    rules: Set[str]
    reason: str
    used: bool = False


@dataclass
class AnalyzerConfig:
    # Path fragments selecting the modules where block-under-lock
    # applies (grant/compile hot paths; the cache server's disk engine
    # legitimately does I/O under its own lock and stays out).
    hot_path_fragments: Tuple[str, ...] = ("scheduler", "daemon")
    # Path fragments selecting the modules where the device-function
    # rules (jit-*) apply: the kernel wrappers and their plain versions.
    # device_pool.py rides along: it is the scheduler-side owner of the
    # resident step; placement.py owns the scored-spill launch.
    # placement_host.py is placement.py's torch-free half.
    jit_path_fragments: Tuple[str, ...] = ("ops", "parallel",
                                           "device_pool.py",
                                           "placement.py",
                                           "placement_host.py")
    # Path fragments selecting the modules where aio-blocking applies
    # (the event-loop front end: coroutines there must never block).
    # "cloud" pulls in daemon/cloud/ — the parked servant wait
    # (WaitForCompilationOutputParked + ExecutionEngine's async
    # completion surface) runs on the accept loop.
    aio_path_fragments: Tuple[str, ...] = ("rpc", "cloud")
    # Path fragments (filename parts) selecting the dispatcher-cycle
    # modules where device-sync applies: the device-resident dispatch
    # hot loop, where any unsanctioned readback (np.asarray, .item(),
    # .tolist(), .cpu(), a synchronize) stalls the launch pipeline.
    # federation.py / replication.py ride along: cell routing and
    # journal replay sit on the same cycle and must not host-sync
    # either; placement.py hosts the scored-spill launch and its pick
    # readback.  host_policy.py, placement_host.py and routed.py are the
    # torch-free halves of policy.py, placement.py and shard_router.py:
    # the code moved there stays in scope.
    device_sync_path_fragments: Tuple[str, ...] = (
        "device_pool.py", "shard_router.py", "policy.py",
        "task_dispatcher.py", "federation.py", "replication.py",
        "placement.py", "host_policy.py", "placement_host.py",
        "routed.py")
    # Path fragments (filename parts) selecting the modules where the
    # replication / exactly-once family (repl-journal-skip,
    # repl-journal-under-lock, grant-id-arith, takeover-order) applies.
    # Any file carrying a replicated(...)/protocol(...) directive is
    # in scope regardless of name.
    replproto_path_fragments: Tuple[str, ...] = (
        "replication.py", "federation.py", "shard_router.py",
        "task_dispatcher.py")
    # Path fragments selecting the modules where the async-protocol
    # family (reply-once / await-under-lock / loop-affinity /
    # async-lifecycle) applies: the three serving layers that host
    # parked continuations.
    asyncproto_path_fragments: Tuple[str, ...] = (
        "rpc", "scheduler", "daemon")
    # Lock hierarchy: canonical lock name -> rank (lower acquired
    # first).  Loaded from lock_hierarchy.toml by the CLI.
    lock_ranks: Dict[str, int] = field(default_factory=dict)
    # Report suppressions that matched nothing (kept off the CI default:
    # rule evolution must not turn a stale-but-documented allow into a
    # gate failure).
    strict_suppressions: bool = False
    # Committed golden wire descriptor (analysis/wire_golden.json).
    # None = skip the golden comparison (proto<->gen drift and unknown-
    # field checks still run whenever an api/protos tree is analyzed).
    wire_golden: Optional[str] = None

    def digest_fields(self) -> dict:
        """The fields a cached result depends on."""
        return {"hot": list(self.hot_path_fragments),
                "jit": list(self.jit_path_fragments),
                "aio": list(self.aio_path_fragments),
                "dsync": list(self.device_sync_path_fragments),
                "asyncproto": list(self.asyncproto_path_fragments),
                "replproto": list(self.replproto_path_fragments),
                "ranks": dict(self.lock_ranks)}


# ---------------------------------------------------------------------------
# Directives (comment-level annotations).
# ---------------------------------------------------------------------------


class Directives:
    """Per-file suppressions and guard declarations, by line number.

    Guard comments are associated with an attribute by
    build_module_model, which matches them against the line span of the
    ``self.X = ...`` statement they sit on (so the comment may ride the
    closing line of a multi-line assignment)."""

    def __init__(self, source: str):
        self.suppressions: Dict[int, Suppression] = {}
        self.guards: Dict[int, str] = {}   # lineno -> lock expr
        self.sanitizes: Dict[int, Set[str]] = {}   # lineno -> tags
        self.acquires: Dict[int, Set[str]] = {}    # lineno -> tags
        self.untrusted: Dict[int, List[str]] = {}  # lineno -> param specs
        self.responders: Dict[int, List[str]] = {}  # lineno -> param names
        self.loop_only: Set[int] = set()           # lineno set
        self.replicated: Dict[int, List[str]] = {}  # lineno -> journal ops
        self.protocol: Dict[int, List[str]] = {}   # lineno -> ordered steps
        for lineno, text in enumerate(source.splitlines(), start=1):
            if "#" not in text:
                continue
            m = _SUPPRESS_RE.search(text)
            if m:
                rules = {r.strip() for r in m.group(1).split(",")
                         if r.strip()}
                reason = m.group(2).strip().lstrip("#").strip()
                self.suppressions[lineno] = Suppression(
                    lineno, rules, reason)
            g = _GUARD_RE.search(text)
            if g:
                self.guards[lineno] = g.group(1)
            s = _SANITIZES_RE.search(text)
            if s:
                self.sanitizes[lineno] = {t.strip()
                                          for t in s.group(1).split(",")
                                          if t.strip()}
            a = _ACQUIRES_RE.search(text)
            if a:
                self.acquires[lineno] = {t.strip()
                                         for t in a.group(1).split(",")
                                         if t.strip()}
            u = _UNTRUSTED_RE.search(text)
            if u:
                self.untrusted[lineno] = [t.strip()
                                          for t in u.group(1).split(",")
                                          if t.strip()]
            r = _RESPONDER_RE.search(text)
            if r:
                self.responders[lineno] = [t.strip()
                                           for t in r.group(1).split(",")
                                           if t.strip()]
            if _LOOP_ONLY_RE.search(text):
                self.loop_only.add(lineno)
            rp = _REPLICATED_RE.search(text)
            if rp:
                self.replicated[lineno] = [t.strip()
                                           for t in rp.group(1).split(",")
                                           if t.strip()]
            pr = _PROTOCOL_RE.search(text)
            if pr:
                self.protocol[lineno] = [t.strip()
                                         for t in pr.group(1).split("<")
                                         if t.strip()]

    def suppression_for(self, line: int, rule: str) -> Optional[Suppression]:
        s = self.suppressions.get(line)
        if s is None:
            return None
        if rule in s.rules or "*" in s.rules:
            return s
        return None


# ---------------------------------------------------------------------------
# Lock discovery.
# ---------------------------------------------------------------------------


def last_segment(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return None


def root_segment(node: ast.AST) -> Optional[str]:
    while isinstance(node, ast.Attribute):
        node = node.value
    if isinstance(node, ast.Name):
        return node.id
    return None


def _dotted(node: ast.AST) -> Optional[str]:
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


@dataclass
class LockRef:
    key: str                      # canonical name ("TaskDispatcher._lock")
    expr: str                     # source form at the site ("self._lock")
    kind: str                     # "lock" | "rlock" | "cond"
    underlying: Optional["LockRef"] = None   # the lock a Condition wraps


@dataclass
class ClassInfo:
    name: str
    lineno: int
    end_lineno: int
    lock_attrs: Dict[str, str] = field(default_factory=dict)  # attr -> kind
    cond_aliases: Dict[str, Optional[str]] = field(default_factory=dict)
    guards: Dict[str, str] = field(default_factory=dict)  # attr -> lock expr

    @property
    def primary_lock_attr(self) -> Optional[str]:
        """The lock `*_locked` methods are assumed to hold: `_lock` if
        present, else the class's only non-Condition lock attribute."""
        if "_lock" in self.lock_attrs:
            return "_lock"
        plain = [a for a, k in self.lock_attrs.items() if k != "cond"]
        if len(plain) == 1:
            return plain[0]
        return None

    def lock_ref_for_attr(self, attr: str, owner: str = "self"
                          ) -> Optional[LockRef]:
        kind = self.lock_attrs.get(attr)
        if kind is None:
            return None
        ref = LockRef(key=f"{self.name}.{attr}", expr=f"{owner}.{attr}",
                      kind=kind)
        if kind == "cond":
            under = self.cond_aliases.get(attr)
            if under and under in self.lock_attrs:
                ref.underlying = LockRef(
                    key=f"{self.name}.{under}", expr=f"{owner}.{under}",
                    kind=self.lock_attrs[under])
        return ref


@dataclass
class ModuleModel:
    path: str
    relpath: str
    modname: str
    tree: ast.Module
    directives: Directives
    classes: Dict[str, ClassInfo] = field(default_factory=dict)
    module_locks: Dict[str, str] = field(default_factory=dict)  # name -> kind


def _factory_kind(call: ast.AST) -> Optional[str]:
    if not isinstance(call, ast.Call):
        return None
    # asyncio.Lock() / asyncio.Condition() are loop primitives, not
    # thread locks: holding one across an await is the normal idiom.
    if root_segment(call.func) == "asyncio":
        return None
    seg = last_segment(call.func)
    if seg in LOCK_FACTORIES:
        return "lock"
    if seg in RLOCK_FACTORIES:
        return "rlock"
    if seg in COND_FACTORIES:
        return "cond"
    return None


def build_module_model(path: str, relpath: str, source: str,
                       tree: ast.Module) -> ModuleModel:
    modname = os.path.splitext(os.path.basename(path))[0]
    model = ModuleModel(path=path, relpath=relpath, modname=modname,
                        tree=tree, directives=Directives(source))

    # Module-level locks (e.g. rpc.transport._mock_lock).
    for stmt in tree.body:
        if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1 and \
                isinstance(stmt.targets[0], ast.Name):
            kind = _factory_kind(stmt.value)
            if kind:
                model.module_locks[stmt.targets[0].id] = kind

    for node in ast.walk(tree):
        if not isinstance(node, ast.ClassDef):
            continue
        info = ClassInfo(name=node.name, lineno=node.lineno,
                         end_lineno=node.end_lineno or node.lineno)
        for sub in ast.walk(node):
            target = None
            if isinstance(sub, ast.Assign) and len(sub.targets) == 1:
                target = sub.targets[0]
                value = sub.value
            elif isinstance(sub, ast.AnnAssign):
                target = sub.target
                value = sub.value
            else:
                continue
            if not (isinstance(target, ast.Attribute)
                    and isinstance(target.value, ast.Name)
                    and target.value.id == "self"):
                continue
            # Guard declaration: a `# guarded by:` comment anywhere in
            # the assignment statement's line span.
            for ln in range(sub.lineno, (sub.end_lineno or sub.lineno) + 1):
                lock_expr = model.directives.guards.get(ln)
                if lock_expr is not None:
                    info.guards[target.attr] = lock_expr
                    break
            kind = _factory_kind(value)
            if kind is None:
                continue
            info.lock_attrs[target.attr] = kind
            if kind == "cond" and isinstance(value, ast.Call) \
                    and value.args:
                arg = value.args[0]
                if isinstance(arg, ast.Attribute) and \
                        isinstance(arg.value, ast.Name) and \
                        arg.value.id == "self":
                    info.cond_aliases[target.attr] = arg.attr
                else:
                    info.cond_aliases[target.attr] = None
            elif kind == "cond":
                # Condition() with no argument owns a private RLock.
                info.cond_aliases[target.attr] = None
        model.classes[node.name] = info
    return model


# ---------------------------------------------------------------------------
# Whole-tree function collection (taint / lifecycle / registry passes).
# ---------------------------------------------------------------------------


@dataclass
class FunctionInfo:
    """One def anywhere in a module (methods, nested classes included),
    with the trust-boundary directives attached to its signature."""

    qualname: str            # "modname.Class.func" / "modname.func"
    name: str                # last segment
    relpath: str
    lineno: int
    params: List[str]
    cls: Optional[str] = None
    sanitizes: Set[str] = field(default_factory=set)
    acquires: Set[str] = field(default_factory=set)
    untrusted: List[str] = field(default_factory=list)
    responders: List[str] = field(default_factory=list)
    loop_only: bool = False
    replicated: List[str] = field(default_factory=list)  # journal ops
    protocol: List[str] = field(default_factory=list)    # ordered steps
    # Filled by the taint summary pass (taint.summarize_function);
    # JSON-serializable so the result cache can persist it.
    taint: Optional[dict] = None
    # Filled by asyncproto.summarize_functions: responder hand-off
    # edges for the global reply-once resolution pass.
    asyncp: Optional[dict] = None
    node: Optional[ast.AST] = None   # not serialized

    def to_dict(self) -> dict:
        return {"qualname": self.qualname, "name": self.name,
                "relpath": self.relpath, "lineno": self.lineno,
                "params": list(self.params), "cls": self.cls,
                "sanitizes": sorted(self.sanitizes),
                "acquires": sorted(self.acquires),
                "untrusted": list(self.untrusted),
                "responders": list(self.responders),
                "loop_only": self.loop_only,
                "replicated": list(self.replicated),
                "protocol": list(self.protocol),
                "taint": self.taint,
                "asyncp": self.asyncp}

    @classmethod
    def from_dict(cls, d: dict) -> "FunctionInfo":
        return cls(qualname=d["qualname"], name=d["name"],
                   relpath=d["relpath"], lineno=d["lineno"],
                   params=list(d["params"]), cls=d.get("cls"),
                   sanitizes=set(d.get("sanitizes", ())),
                   acquires=set(d.get("acquires", ())),
                   untrusted=list(d.get("untrusted", ())),
                   responders=list(d.get("responders", ())),
                   loop_only=bool(d.get("loop_only", False)),
                   replicated=list(d.get("replicated", ())),
                   protocol=list(d.get("protocol", ())),
                   taint=d.get("taint"),
                   asyncp=d.get("asyncp"))


def _signature_lines(node: ast.AST) -> Set[int]:
    """Line numbers where a def's directives may sit: the decorator /
    signature span, plus the line directly above it (long signatures put
    the directive on its own comment line)."""
    start = node.lineno
    for deco in getattr(node, "decorator_list", ()):
        start = min(start, deco.lineno)
    body_start = node.body[0].lineno if node.body else node.lineno + 1
    lines = set(range(start, max(body_start, node.lineno + 1)))
    lines.add(start - 1)
    lines.add(node.lineno)
    return lines


def collect_functions(model: ModuleModel) -> List[FunctionInfo]:
    """Every def in the module, depth-first, with qualified names and
    signature directives resolved.  Unlike iter_functions (which feeds
    the held-lock walk and must not descend), this sees nested defs and
    classes defined inside functions (e.g. HTTP handler classes built
    in a service __init__)."""
    out: List[FunctionInfo] = []
    d = model.directives

    def visit(node: ast.AST, prefix: str, cls: Optional[str]) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                qual = f"{prefix}.{child.name}"
                a = child.args
                params = [p.arg for p in
                          (a.posonlyargs + a.args + a.kwonlyargs)]
                info = FunctionInfo(
                    qualname=qual, name=child.name, relpath=model.relpath,
                    lineno=child.lineno, params=params, cls=cls,
                    node=child)
                for ln in _signature_lines(child):
                    if ln in d.sanitizes:
                        info.sanitizes |= d.sanitizes[ln]
                    if ln in d.acquires:
                        info.acquires |= d.acquires[ln]
                    if ln in d.untrusted:
                        info.untrusted.extend(
                            s for s in d.untrusted[ln]
                            if s not in info.untrusted)
                    if ln in d.responders:
                        info.responders.extend(
                            s for s in d.responders[ln]
                            if s not in info.responders)
                    if ln in d.loop_only:
                        info.loop_only = True
                    if ln in d.replicated:
                        info.replicated.extend(
                            s for s in d.replicated[ln]
                            if s not in info.replicated)
                    if ln in d.protocol and not info.protocol:
                        info.protocol = list(d.protocol[ln])
                out.append(info)
                visit(child, qual, cls)
            elif isinstance(child, ast.ClassDef):
                visit(child, f"{prefix}.{child.name}", child.name)
            else:
                visit(child, prefix, cls)

    visit(model.tree, model.modname, None)
    return out


# ---------------------------------------------------------------------------
# Held-lock walk.
# ---------------------------------------------------------------------------


class Hooks:
    """Rule callbacks; override what you need."""

    def on_acquire(self, ref: LockRef, held: List[LockRef],
                   node: ast.AST) -> None:
        pass

    def on_attr(self, node: ast.Attribute, held: List[LockRef]) -> None:
        pass

    def on_call(self, node: ast.Call, held: List[LockRef]) -> None:
        pass

    def on_await(self, node: ast.Await, held: List[LockRef]) -> None:
        pass


class HeldWalker:
    """Walks one function/method tracking statically-held locks."""

    def __init__(self, model: ModuleModel, cls: Optional[ClassInfo],
                 func: ast.AST, hooks: Hooks):
        self.model = model
        self.cls = cls
        self.func = func
        self.hooks = hooks
        self.held: List[LockRef] = []
        self.local_locks: Dict[str, str] = {}   # name -> kind
        self.local_conds: Dict[str, Optional[str]] = {}

    # -- lock resolution ---------------------------------------------------

    def resolve_lock(self, expr: ast.AST) -> Optional[LockRef]:
        if isinstance(expr, ast.Attribute) and \
                isinstance(expr.value, ast.Name):
            owner = expr.value.id
            if owner == "self" and self.cls is not None:
                return self.cls.lock_ref_for_attr(expr.attr)
            # cls-style or foreign-object locks are not resolvable.
            return None
        if isinstance(expr, ast.Name):
            name = expr.id
            kind = self.local_locks.get(name)
            if kind:
                fname = getattr(self.func, "name", "<lambda>")
                ref = LockRef(key=f"{self.model.modname}.{fname}.{name}",
                              expr=name, kind=kind)
                if kind == "cond":
                    under = self.local_conds.get(name)
                    if under and under in self.local_locks:
                        ref.underlying = LockRef(
                            key=f"{self.model.modname}.{fname}.{under}",
                            expr=under, kind=self.local_locks[under])
                return ref
            kind = self.model.module_locks.get(name)
            if kind:
                return LockRef(key=f"{self.model.modname}.{name}",
                               expr=name, kind=kind)
        return None

    # -- the walk ----------------------------------------------------------

    def run(self) -> None:
        name = getattr(self.func, "name", "")
        if name.endswith("_locked") and self.cls is not None:
            primary = self.cls.primary_lock_attr
            if primary is not None:
                ref = self.cls.lock_ref_for_attr(primary)
                if ref is not None:
                    self.held.append(ref)
        for stmt in self.func.body:
            self._walk(stmt)

    def _push(self, ref: LockRef) -> List[LockRef]:
        added = [ref]
        self.held.append(ref)
        if ref.underlying is not None:
            self.held.append(ref.underlying)
            added.append(ref.underlying)
        return added

    def _walk(self, node: ast.AST) -> None:
        if isinstance(node, (ast.With, ast.AsyncWith)):
            added: List[LockRef] = []
            for item in node.items:
                self._walk(item.context_expr)
                if item.optional_vars is not None:
                    self._walk(item.optional_vars)
                ref = self.resolve_lock(item.context_expr)
                if ref is not None:
                    self.hooks.on_acquire(ref, list(self.held), node)
                    added.extend(self._push(ref))
            for stmt in node.body:
                self._walk(stmt)
            for _ in added:
                self.held.pop()
            return
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            # Nested def: helper closures inherit the definition-site
            # held set (see module docstring for the limitation).
            for deco in node.decorator_list:
                self._walk(deco)
            for stmt in node.body:
                self._walk(stmt)
            return
        if isinstance(node, ast.Lambda):
            self._walk(node.body)
            return
        if isinstance(node, ast.ClassDef):
            return  # nested classes: out of scope
        if isinstance(node, ast.Assign):
            if len(node.targets) == 1 and \
                    isinstance(node.targets[0], ast.Name):
                kind = _factory_kind(node.value)
                if kind:
                    name = node.targets[0].id
                    self.local_locks[name] = kind
                    if kind == "cond" and isinstance(node.value, ast.Call) \
                            and node.value.args and \
                            isinstance(node.value.args[0], ast.Name):
                        self.local_conds[name] = node.value.args[0].id
        if isinstance(node, ast.Call):
            self.hooks.on_call(node, list(self.held))
        if isinstance(node, ast.Attribute):
            self.hooks.on_attr(node, list(self.held))
        if isinstance(node, ast.Await):
            self.hooks.on_await(node, list(self.held))
        for child in ast.iter_child_nodes(node):
            self._walk(child)


def iter_functions(model: ModuleModel):
    """Yield (classinfo_or_None, function_node) for every def in the
    module, outermost first.  Nested defs are walked by HeldWalker
    itself (they inherit held state), so only top-level defs and direct
    class methods are yielded."""

    def class_for(node: ast.ClassDef) -> Optional[ClassInfo]:
        return model.classes.get(node.name)

    for stmt in model.tree.body:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield None, stmt
        elif isinstance(stmt, ast.ClassDef):
            info = class_for(stmt)
            for sub in stmt.body:
                if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    yield info, sub


# ---------------------------------------------------------------------------
# Driver.
# ---------------------------------------------------------------------------


def _collect_py_files(paths: Sequence[str]) -> List[Tuple[str, str]]:
    """(display_relpath, path) pairs.  The display path keeps the
    input directory's own name as its first segment, so scope checks
    (`scheduler/...`, `ops/...`) see the directory structure no matter
    where the tree lives."""
    out: List[Tuple[str, str]] = []
    seen: Set[str] = set()

    def add(rel: str, path: str) -> None:
        ap = os.path.abspath(path)
        if ap not in seen:
            seen.add(ap)
            out.append((rel.replace(os.sep, "/"), path))

    for p in paths:
        if os.path.isfile(p):
            add(os.path.normpath(p), p)
            continue
        base = os.path.basename(os.path.normpath(p))
        for dirpath, dirnames, filenames in os.walk(p):
            dirnames[:] = sorted(d for d in dirnames
                                 if d != "__pycache__")
            for f in sorted(filenames):
                if f.endswith(".py"):
                    full = os.path.join(dirpath, f)
                    add(os.path.join(base, os.path.relpath(full, p)),
                        full)
    return out


@dataclass
class _FileRecord:
    relpath: str
    path: str
    source: str
    content_hash: str
    model: Optional[ModuleModel] = None        # parsed lazily / on miss
    functions: List[FunctionInfo] = field(default_factory=list)
    callsites: List[dict] = field(default_factory=list)
    local_findings: Optional[List[Finding]] = None
    from_cache: bool = False


def _collect_callsites(model: ModuleModel) -> List[dict]:
    """Flat record of every call with keyword arguments plus the
    TaskType registrations — enough for the wire-compat unknown-field
    check and the taint-registry check to run without the AST (so a
    cache hit skips parsing entirely)."""
    sites: List[dict] = []
    for node in ast.walk(model.tree):
        if not isinstance(node, ast.Call):
            continue
        last = last_segment(node.func)
        if last is None:
            continue
        kwargs = [kw.arg for kw in node.keywords if kw.arg]
        chain: List[str] = []
        f = node.func
        while isinstance(f, ast.Attribute):
            chain.append(f.attr)
            f = f.value
        if isinstance(f, ast.Name):
            chain.append(f.id)
        chain.reverse()
        if last == "TaskType" and kwargs:
            kind = None
            factories: List[str] = []
            for kw in node.keywords:
                if kw.arg == "kind" and isinstance(kw.value, ast.Constant):
                    kind = kw.value.value
                if kw.arg == "make_task":
                    for sub in ast.walk(kw.value):
                        if isinstance(sub, ast.Call):
                            seg = last_segment(sub.func)
                            if seg:
                                factories.append(seg)
                        elif isinstance(sub, ast.Name):
                            factories.append(sub.id)
            lam_params: Set[str] = set()
            for kw in node.keywords:
                if kw.arg == "make_task" and \
                        isinstance(kw.value, ast.Lambda):
                    lam_params = {a.arg for a in kw.value.args.args}
            factories = [n for n in factories
                         if n not in lam_params and n != "TaskType"]
            sites.append({"tasktype": True, "kind": kind,
                          "factories": factories, "line": node.lineno})
        if kwargs:
            sites.append({"last": last, "chain": chain,
                          "kwargs": kwargs, "line": node.lineno})
    return sites


_DEF_NAME_RE = re.compile(r"^\s*(?:async\s+)?def\s+(\w+)")


def scan_directives(sources: Dict[str, str]
                    ) -> Tuple[str, Dict[str, Set[str]], Set[str], Set[str]]:
    """Regex pre-pass over raw sources (no parsing): returns
    (fingerprint, sanitizer map, acquires name set, loop-only name set).

    Per-file analysis results depend on which *names* carry sanitizes/
    acquires/untrusted annotations anywhere in the tree (the taint pass
    resolves sanitizer calls by name across modules), so the result
    cache keys on this fingerprint alongside each file's content hash —
    retargeting an annotation invalidates everything, cheaply detected
    before any AST work."""
    import hashlib

    entries: List[Tuple[str, int, str, str]] = []
    sanitizers: Dict[str, Set[str]] = {}
    acquires: Set[str] = set()
    loop_only: Set[str] = set()
    for rel in sorted(sources):
        lines = sources[rel].splitlines()
        for i, text in enumerate(lines):
            if "ytpu:" not in text:
                continue
            hit = None
            for regex, kind in ((_SANITIZES_RE, "sanitizes"),
                                (_ACQUIRES_RE, "acquires"),
                                (_UNTRUSTED_RE, "untrusted"),
                                (_RESPONDER_RE, "responder"),
                                (_REPLICATED_RE, "replicated"),
                                (_PROTOCOL_RE, "protocol")):
                m = regex.search(text)
                if m:
                    hit = (kind, m.group(1))
                    break
            if hit is None and _LOOP_ONLY_RE.search(text):
                hit = ("loop-only", "")
            if hit is None:
                continue
            # Associate with the owning def: same line; a pure-comment
            # line binds to the def below (above-decorator style); a
            # trailing comment on a signature continuation line binds
            # to the def above.
            defname = ""
            dm = _DEF_NAME_RE.match(text)
            if dm:
                defname = dm.group(1)
            elif text.lstrip().startswith("#"):
                for j in range(i + 1, min(i + 9, len(lines))):
                    dm = _DEF_NAME_RE.match(lines[j])
                    if dm:
                        defname = dm.group(1)
                        break
            else:
                for j in range(i - 1, max(i - 9, -1), -1):
                    dm = _DEF_NAME_RE.match(lines[j])
                    if dm:
                        defname = dm.group(1)
                        break
            entries.append((rel, i + 1, defname, f"{hit[0]}({hit[1]})"))
            tags = {t.strip() for t in hit[1].split(",") if t.strip()}
            if defname and hit[0] == "sanitizes":
                sanitizers.setdefault(defname, set()).update(tags)
            elif defname and hit[0] == "acquires":
                acquires.add(defname)
            elif defname and hit[0] == "loop-only":
                loop_only.add(defname)
    fp = hashlib.sha256(repr(entries).encode()).hexdigest()
    return fp, sanitizers, acquires, loop_only


def analyze_paths(paths: Sequence[str],
                  config: Optional[AnalyzerConfig] = None,
                  cache=None,
                  ) -> Tuple[List[Finding], dict]:
    """Run every rule family over the given files/directories.

    Returns (findings, stats).  Findings matched by a
    ``# ytpu: allow(<rule>)  # reason`` comment on their line come back
    with ``suppressed=True``; a suppression without a reason adds a
    ``suppression`` finding of its own.  The process exit decision
    belongs to the caller (__main__): unsuppressed findings fail.

    ``cache`` is an optional analysis.cache.ResultCache: per-file parse
    + rule results are reused when the file's content hash, the global
    directive digest and the analyzer fingerprint all match.
    """
    import hashlib
    import time as _time

    from . import (asyncproto, device_sync, jit_hygiene, lifecycle,
                   lockrules, replproto, taint, wirecompat)

    config = config or AnalyzerConfig()
    files = _collect_py_files(paths)
    findings: List[Finding] = []
    timings: Dict[str, float] = {}
    records: List[_FileRecord] = []
    cache_hits = 0

    def _timed(name: str, fn, *args):
        t0 = _time.perf_counter()
        out = fn(*args)
        timings[name] = timings.get(name, 0.0) + _time.perf_counter() - t0
        return out

    # -- phase 0: read sources, directive pre-pass -------------------------
    t0 = _time.perf_counter()
    sources: Dict[str, str] = {}
    by_rel: Dict[str, Tuple[str, str]] = {}
    for rel, path in files:
        try:
            with open(path, "r", encoding="utf-8") as fp:
                sources[rel] = fp.read()
            by_rel[rel] = (rel, path)
        except OSError as e:
            findings.append(Finding("parse-error", rel, 1, str(e)))
    directive_fp, sanitizer_map, acquires_names, loop_only_names = \
        scan_directives(sources)
    cfg_fp = hashlib.sha256(
        repr(sorted(config.digest_fields().items())).encode()).hexdigest()
    global_key = hashlib.sha256(
        (directive_fp + cfg_fp).encode()).hexdigest()

    # -- phase 1: per-file analysis (cache-keyed on content + globals) -----
    # Cache lookups, parsing and the mutating summary passes stay
    # serial (parse errors land deterministically and the summaries
    # write into the shared FunctionInfo records); the read-only rule
    # families then fan out on a thread pool, ONE WORKER PER FAMILY,
    # each sweeping every cold file.  The content-hash cache is
    # unchanged: a cache hit removes the file from every family's
    # sweep, and per-family wall times land in stats["timings"].
    cold: List[_FileRecord] = []
    for rel, path in files:
        if rel not in sources:
            continue
        source = sources[rel]
        rec = _FileRecord(
            relpath=rel, path=path, source=source,
            content_hash=hashlib.sha256(source.encode()).hexdigest())
        entry = (cache.get(rec.content_hash, global_key)
                 if cache is not None else None)
        if entry is not None:
            rec.functions = [FunctionInfo.from_dict(d)
                             for d in entry.get("functions", ())]
            rec.callsites = list(entry.get("callsites", ()))
            rec.local_findings = [Finding(**d)
                                  for d in entry.get("findings", ())]
            rec.from_cache = True
            cache_hits += 1
        else:
            try:
                tree = ast.parse(source, filename=path)
            except SyntaxError as e:
                findings.append(Finding("parse-error", rel, 1, str(e)))
                continue
            rec.model = build_module_model(path, rel, source, tree)
            rec.functions = collect_functions(rec.model)
            _timed("taint", taint.summarize_functions,
                   rec.model, rec.functions, sanitizer_map)
            _timed("asyncproto", asyncproto.summarize_functions,
                   rec.model, rec.functions)
            rec.callsites = _collect_callsites(rec.model)
            cold.append(rec)
        records.append(rec)

    families = (
        ("lockrules",
         lambda r: lockrules.check_module(r.model, config)),
        ("jit-hygiene",
         lambda r: jit_hygiene.check_module(r.model, config)),
        ("device-sync",
         lambda r: device_sync.check_module(r.model, config)),
        ("lifecycle",
         lambda r: lifecycle.check_module(r.model, config,
                                          acquires_names)),
        ("asyncproto",
         lambda r: asyncproto.check_module(r.model, r.functions, config,
                                           loop_only_names)),
        ("replproto",
         lambda r: replproto.check_module(r.model, r.functions, config)),
    )

    def _family_sweep(name, fn):
        f0 = _time.perf_counter()
        out = {rec.relpath: fn(rec) for rec in cold}
        return name, out, _time.perf_counter() - f0

    if cold:
        from concurrent.futures import ThreadPoolExecutor
        workers = min(len(families), max(2, os.cpu_count() or 2))
        with ThreadPoolExecutor(max_workers=workers) as pool:
            swept = list(pool.map(lambda nf: _family_sweep(*nf),
                                  families))
        for name, _, secs in swept:
            timings[name] = timings.get(name, 0.0) + secs
        by_family = {name: out for name, out, _ in swept}
        for rec in cold:
            raw = [f for name, _ in families
                   for f in by_family[name].get(rec.relpath, ())]
            rec.local_findings = raw
            if cache is not None:
                cache.put(rec.content_hash, global_key, {
                    "functions": [i.to_dict() for i in rec.functions],
                    "callsites": rec.callsites,
                    "findings": [{"rule": f.rule, "path": f.path,
                                  "line": f.line, "message": f.message}
                                 for f in raw],
                })
    timings["per-file-total"] = _time.perf_counter() - t0

    all_functions: List[FunctionInfo] = []
    for rec in records:
        all_functions.extend(rec.functions)

    # -- phase 2: global passes --------------------------------------------
    tasktype_sites = [dict(s, relpath=rec.relpath)
                      for rec in records for s in rec.callsites
                      if s.get("tasktype")]
    raw_global: List[Finding] = []
    raw_global.extend(_timed(
        "taint", taint.check_global, all_functions, tasktype_sites,
        sanitizer_map))
    raw_global.extend(_timed(
        "wire-compat", wirecompat.check_paths, paths, records, config))
    raw_global.extend(_timed(
        "asyncproto", asyncproto.check_global, all_functions, config))

    # -- suppression pass --------------------------------------------------
    directives_by_rel: Dict[str, Directives] = {}

    def _directives(rel: str) -> Optional[Directives]:
        if rel not in directives_by_rel:
            rec = next((r for r in records if r.relpath == rel), None)
            if rec is None:
                return None
            if rec.model is not None:
                directives_by_rel[rel] = rec.model.directives
            else:
                directives_by_rel[rel] = Directives(rec.source)
        return directives_by_rel[rel]

    seen_keys: Set[Tuple[str, str, int, str]] = set()
    for f in [f for rec in records for f in (rec.local_findings or [])] \
            + raw_global:
        key = (f.rule, f.path, f.line, f.message)
        if key in seen_keys:
            continue
        seen_keys.add(key)
        d = _directives(f.path)
        if d is not None:
            s = d.suppression_for(f.line, f.rule)
            if s is not None:
                s.used = True
                f.suppressed = True
        findings.append(f)
    for rec in records:
        d = _directives(rec.relpath)
        if d is None:
            continue
        for s in d.suppressions.values():
            unknown = s.rules - set(RULES) - {"*"}
            if unknown:
                findings.append(Finding(
                    "suppression", rec.relpath, s.line,
                    f"unknown rule id(s) in suppression: "
                    f"{', '.join(sorted(unknown))}"))
            if not s.reason:
                findings.append(Finding(
                    "suppression", rec.relpath, s.line,
                    "suppression without a written reason "
                    "(# ytpu: allow(<rule>)  # why it is safe)"))
            elif config.strict_suppressions and not s.used:
                findings.append(Finding(
                    "suppression", rec.relpath, s.line,
                    "suppression matched no finding"))

    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    stats = {
        "files_analyzed": len(records),
        "findings": sum(1 for f in findings if not f.suppressed),
        "suppressed": sum(1 for f in findings if f.suppressed),
        "cache_hits": cache_hits,
        "timings": {k: round(v, 4) for k, v in sorted(timings.items())},
    }
    return findings, stats
