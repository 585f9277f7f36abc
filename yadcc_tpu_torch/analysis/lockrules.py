"""Rule families 1-3: guarded-by, lock-order, block-under-lock.

All three share one held-lock walk per function (core.HeldWalker); each
family is a Hooks callback recording findings.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from .core import (
    CONSTRUCTION_METHODS,
    AnalyzerConfig,
    ClassInfo,
    Finding,
    HeldWalker,
    Hooks,
    LockRef,
    ModuleModel,
    _dotted,
    iter_functions,
    last_segment,
    root_segment,
)

# ---------------------------------------------------------------------------
# block-under-lock matchers.
# ---------------------------------------------------------------------------

# Matched on the call's last dotted segment.
_BLOCKING_LAST_SEG: Dict[str, str] = {
    "sleep": "sleep",
    "open": "file I/O",
    "urlopen": "network I/O",
    "communicate": "subprocess wait",
    "accept": "socket I/O",
    "recv": "socket I/O",
    "recvfrom": "socket I/O",
    "sendall": "socket I/O",
    "connect": "socket I/O",
    "select": "blocking select",
    "call": "RPC call",
    "block_until_ready": "device sync",
    "device_get": "device transfer",
    "device_put": "device transfer",
    # torch's readbacks and fences: each waits for every kernel queued
    # on the stream before it.
    "item": "device sync",
    "tolist": "device sync",
    "cpu": "device sync",
    "numpy": "device sync",
    "synchronize": "device sync",
    # /proc samplers (daemon/sysinfo.py) and their injection points:
    # their contract is file I/O however cheap it looks at the call site.
    "_memory_reader": "/proc sampling I/O",
    "read_memory_available": "/proc sampling I/O",
    "read_memory_total": "/proc sampling I/O",
    "read_cgroup_present": "/proc sampling I/O",
    "_read_proc_stat": "/proc sampling I/O",
}

# Matched on the call's root segment (module-style prefixes).  The
# port's device dispatch is torch itself plus its kernel wrappers'
# modules, under whatever local name a module imports them
# (_device_roots adds the aliases, e.g. policy.py's kgrouped/kassign).
_BLOCKING_ROOT: Dict[str, str] = {
    "torch": "device dispatch",
    "subprocess": "subprocess",
    "socket": "socket I/O",
    "requests": "network I/O",
    "urllib": "network I/O",
}


# The port's kernel wrapper modules (ops/cuda_*.py).
_KERNEL_WRAPPER_MODULES = {"cuda_grouped", "cuda_assign", "cuda_bloom"}


def _device_roots(model: ModuleModel) -> Tuple[Dict[str, str], Set[str]]:
    """(root -> what, bare names) for this module's device dispatch:
    ``_BLOCKING_ROOT`` plus every local name bound to a kernel wrapper
    module, and the wrapper functions it from-imports by name."""
    roots = dict(_BLOCKING_ROOT)
    names: Set[str] = set()
    for node in ast.walk(model.tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name.split(".")[-1] in _KERNEL_WRAPPER_MODULES:
                    roots[a.asname or a.name.split(".")[0]] = \
                        "device dispatch"
        elif isinstance(node, ast.ImportFrom):
            mod = (node.module or "").split(".")[-1]
            for a in node.names:
                if a.name in _KERNEL_WRAPPER_MODULES:
                    roots[a.asname or a.name] = "device dispatch"
                elif mod in _KERNEL_WRAPPER_MODULES:
                    names.add(a.asname or a.name)
    return roots, names


def _blocking_what(func: ast.AST, roots: Dict[str, str],
                   names: Set[str]) -> Optional[str]:
    seg = last_segment(func)
    root = root_segment(func)
    if seg in _BLOCKING_LAST_SEG:
        return _BLOCKING_LAST_SEG[seg]
    if root in roots and root != seg:
        return roots[root]
    if isinstance(func, ast.Name) and func.id in names:
        return "device dispatch"
    return None


def _in_scope(relpath: str, fragments: Tuple[str, ...]) -> bool:
    parts = relpath.replace("\\", "/").split("/")
    return any(frag in parts for frag in fragments)


class _GuardedByHooks(Hooks):
    def __init__(self, model: ModuleModel, cls: Optional[ClassInfo],
                 func: ast.AST, findings: List[Finding]):
        self.model = model
        self.cls = cls
        self.func = func
        self.findings = findings
        name = getattr(func, "name", "")
        self.exempt = name in CONSTRUCTION_METHODS

    def _holds(self, held: List[LockRef], lock_expr: str) -> bool:
        return any(h.expr == lock_expr for h in held)

    def on_attr(self, node: ast.Attribute, held: List[LockRef]) -> None:
        if self.exempt or self.cls is None:
            return
        if not (isinstance(node.value, ast.Name)
                and node.value.id == "self"):
            return
        required = self.cls.guards.get(node.attr)
        if required is None:
            return
        if self._holds(held, required):
            return
        self.findings.append(Finding(
            "guarded-by", self.model.relpath, node.lineno,
            f"self.{node.attr} is declared guarded by {required} but "
            f"accessed in {self.cls.name}."
            f"{getattr(self.func, 'name', '?')} without it held"))

    def on_call(self, node: ast.Call, held: List[LockRef]) -> None:
        if self.exempt or self.cls is None:
            return
        func = node.func
        if not (isinstance(func, ast.Attribute)
                and isinstance(func.value, ast.Name)
                and func.value.id == "self"
                and func.attr.endswith("_locked")):
            return
        primary = self.cls.primary_lock_attr
        if primary is None:
            return
        if self._holds(held, f"self.{primary}"):
            return
        self.findings.append(Finding(
            "locked-call", self.model.relpath, node.lineno,
            f"self.{func.attr}() requires self.{primary} held "
            f"(callers must hold the lock the *_locked suffix declares)"))


class _LockOrderHooks(Hooks):
    def __init__(self, model: ModuleModel,
                 findings: List[Finding],
                 edges: List[Tuple[str, str, str, int]]):
        self.model = model
        self.findings = findings
        self.edges = edges

    @staticmethod
    def _order_key(ref: LockRef) -> Optional[str]:
        # Acquiring a Condition acquires its underlying lock; ordering
        # is defined on real locks.  A Condition over an unknown lock
        # contributes no edge.
        if ref.kind == "cond":
            return ref.underlying.key if ref.underlying else None
        return ref.key

    def on_acquire(self, ref: LockRef, held: List[LockRef],
                   node: ast.AST) -> None:
        new_key = self._order_key(ref)
        if new_key is None:
            return
        held_keys = []
        for h in held:
            k = self._order_key(h)
            if k is not None and k not in held_keys:
                held_keys.append(k)
        if new_key in held_keys and ref.kind == "lock":
            self.findings.append(Finding(
                "lock-order", self.model.relpath, node.lineno,
                f"{ref.expr} is a non-reentrant Lock already held here "
                f"(self-deadlock)"))
            return
        site = f"{self.model.relpath}:{node.lineno}"
        for prev in held_keys:
            if prev != new_key:
                self.edges.append((prev, new_key, site, node.lineno))


class _BlockUnderLockHooks(Hooks):
    def __init__(self, model: ModuleModel, cls: Optional[ClassInfo],
                 findings: List[Finding],
                 device: Tuple[Dict[str, str], Set[str]]):
        self.model = model
        self.cls = cls
        self.findings = findings
        self.device = device

    def _wait_exempt(self, recv: ast.AST, held: List[LockRef]) -> bool:
        """cv.wait() releases the lock while parked: waiting on a
        Condition (or on the held lock object itself) is the one legal
        blocking call under a lock."""
        recv_str = _dotted(recv)
        if recv_str is None:
            return False
        for h in held:
            if h.expr == recv_str:
                return True
            if h.underlying is not None and h.underlying.expr == recv_str:
                return True
        if self.cls is not None and isinstance(recv, ast.Attribute) \
                and isinstance(recv.value, ast.Name) \
                and recv.value.id == "self" \
                and self.cls.lock_attrs.get(recv.attr) == "cond":
            under = self.cls.cond_aliases.get(recv.attr)
            if under is not None and any(
                    h.expr == f"self.{under}" for h in held):
                return True
        return False

    def on_call(self, node: ast.Call, held: List[LockRef]) -> None:
        if not held:
            return
        func = node.func
        seg = last_segment(func)
        root = root_segment(func)
        held_desc = ", ".join(sorted({h.expr for h in held}))
        if seg == "wait":
            if isinstance(func, ast.Attribute) and \
                    self._wait_exempt(func.value, held):
                return
            self.findings.append(Finding(
                "block-under-lock", self.model.relpath, node.lineno,
                f"blocking wait under lock ({held_desc}): only a "
                f"Condition over the held lock may wait here"))
            return
        if seg == "join" and isinstance(func, ast.Attribute):
            recv = _dotted(func.value) or ""
            if "thread" in recv.lower() or "proc" in recv.lower():
                self.findings.append(Finding(
                    "block-under-lock", self.model.relpath, node.lineno,
                    f"thread join under lock ({held_desc})"))
            return
        what = _blocking_what(func, *self.device)
        if what is None:
            return
        self.findings.append(Finding(
            "block-under-lock", self.model.relpath, node.lineno,
            f"{what} ({_dotted(func) or seg}) inside a lock body "
            f"({held_desc}) on a hot path"))


class _AioBlockingVisitor(ast.NodeVisitor):
    """aio-blocking: blocking calls inside ``async def`` coroutines in
    the event-loop front end's scope (rpc/).  A sleep, file/socket I/O
    or sync RPC ``.call`` on the loop silently regresses every
    connection it serves to the thread-per-connection latency profile
    the front end replaced — so it is a finding, same suppression
    policy as every other rule.

    Awaited calls are exempt (``await asyncio.sleep`` / stream I/O —
    a *blocking* call is not awaitable, so awaiting one would already
    be a runtime error), as is anything rooted at ``asyncio`` and the
    executor hand-off itself (``run_in_executor`` receives a function
    reference, not a call).  The check still descends into an awaited
    call's ARGUMENTS: ``await send(sock.recv(1))`` hides a blocking
    recv in plain sight."""

    def __init__(self, model: ModuleModel, fn: ast.AsyncFunctionDef,
                 findings: List[Finding],
                 device: Tuple[Dict[str, str], Set[str]]):
        self.model = model
        self.fn = fn
        self.findings = findings
        self.device = device

    def visit_Await(self, node: ast.Await) -> None:
        value = node.value
        if isinstance(value, ast.Call):
            # The awaited call itself is exempt; its arguments are not.
            for arg in value.args:
                self.visit(arg)
            for kw in value.keywords:
                self.visit(kw.value)
            self.visit(value.func)
        else:
            self.visit(value)

    def visit_FunctionDef(self, node) -> None:
        pass  # a nested sync def runs wherever it is called, not here

    def visit_AsyncFunctionDef(self, node) -> None:
        pass  # visited in its own right by check_module's walk

    def visit_Call(self, node: ast.Call) -> None:
        self.generic_visit(node)
        func = node.func
        seg = last_segment(func)
        root = root_segment(func)
        if root == "asyncio":
            return
        what = _blocking_what(func, *self.device)
        if what is None and (seg == "wait" or seg == "join"):
            what = "thread-blocking wait"
        if what is None:
            return
        self.findings.append(Finding(
            "aio-blocking", self.model.relpath, node.lineno,
            f"{what} ({_dotted(func) or seg}) inside coroutine "
            f"{self.fn.name}: blocking the event loop stalls every "
            f"connection it serves"))


def _check_aio_blocking(model: ModuleModel, findings: List[Finding],
                        device: Tuple[Dict[str, str], Set[str]]) -> None:
    for node in ast.walk(model.tree):
        if isinstance(node, ast.AsyncFunctionDef):
            visitor = _AioBlockingVisitor(model, node, findings, device)
            for stmt in node.body:
                visitor.visit(stmt)


def _check_edges(model: ModuleModel, config: AnalyzerConfig,
                 edges: List[Tuple[str, str, str, int]],
                 findings: List[Finding]) -> None:
    ranks = config.lock_ranks
    seen: Set[Tuple[str, str, int]] = set()
    for prev, new, site, lineno in edges:
        key = (prev, new, lineno)
        if key in seen:
            continue
        seen.add(key)
        rp, rn = ranks.get(prev), ranks.get(new)
        if rp is None or rn is None:
            missing = [n for n, r in ((prev, rp), (new, rn)) if r is None]
            findings.append(Finding(
                "lock-order", model.relpath, lineno,
                f"nested acquisition {prev} -> {new} involves lock(s) "
                f"not in lock_hierarchy.toml: {', '.join(missing)} "
                f"(declare a rank or restructure)"))
        elif rp >= rn:
            findings.append(Finding(
                "lock-order", model.relpath, lineno,
                f"nested acquisition {prev} (rank {rp}) -> {new} "
                f"(rank {rn}) inverts the declared hierarchy"))


def check_module(model: ModuleModel,
                 config: AnalyzerConfig) -> List[Finding]:
    findings: List[Finding] = []
    edges: List[Tuple[str, str, str, int]] = []
    hot = _in_scope(model.relpath, config.hot_path_fragments)
    device = _device_roots(model)
    if _in_scope(model.relpath, config.aio_path_fragments):
        _check_aio_blocking(model, findings, device)
    for cls, func in iter_functions(model):
        hook_list: List[Hooks] = [
            _GuardedByHooks(model, cls, func, findings),
            _LockOrderHooks(model, findings, edges),
        ]
        if hot:
            hook_list.append(_BlockUnderLockHooks(model, cls, findings,
                                                  device))

        class _Fan(Hooks):
            def on_acquire(self, ref, held, node):
                for h in hook_list:
                    h.on_acquire(ref, held, node)

            def on_attr(self, node, held):
                for h in hook_list:
                    h.on_attr(node, held)

            def on_call(self, node, held):
                for h in hook_list:
                    h.on_call(node, held)

        HeldWalker(model, cls, func, _Fan()).run()
    _check_edges(model, config, edges, findings)
    return findings
