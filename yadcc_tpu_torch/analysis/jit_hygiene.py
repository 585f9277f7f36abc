"""Rule family 4: device-function hygiene (ops/, parallel/).

The JAX package checks its ``@jax.jit`` bodies here.  The port has no
traced functions: its device code is the kernel wrappers and their
plain versions, called eagerly.  A *device function* is a ``def`` in
scope with at least one parameter annotated as a tensor (the
annotation mentions ``Tensor``); those parameters are its *tensor
parameters*.  The rule ids and their intent stay the JAX package's:

* ``jit-nondet`` — a wall-clock read, or randomness that does not come
  from an explicit generator, inside a device function: module
  ``random``/``secrets``/``uuid``, ``os.urandom``, ``np.random.<fn>``
  (``np.random.default_rng(seed)`` with a seed is exempt), and
  ``torch.rand*``/``randint``/``randperm``/``normal``/``bernoulli``/
  ``multinomial`` without ``generator=``.  A kernel and its plain
  version must compute the same function of their inputs, every call.
* ``jit-tracer-if`` — a Python ``if``/``while``/ternary whose test
  reads the *value* of a tensor parameter.  On a CUDA tensor that is a
  hidden ``.item()``: the host waits for every queued kernel before it
  can branch.  Shape, dtype and device probes (``x.shape``, ``x.ndim``,
  ``x.dtype``, ``x.device``, ``x.is_cuda``, ``x.numel()``,
  ``x.size(...)``, ``x.dim()``, ``len(x)``, ``isinstance``,
  ``x is None``) are host metadata and exempt.
* ``jit-static-unhashable`` — keeps its id in the catalog and has no
  matcher: the port has no cache keyed by a device function's call
  arguments (no ``static_argnames``, no ``functools.lru_cache`` over a
  wrapper), so nothing can be bound to one.

Detection is conservative (direct parameter mentions only; closures
and derived locals are not tracked) — false negatives over false
positives, like the lock rules.
"""

from __future__ import annotations

import ast
from typing import List, Set

from .core import (
    AnalyzerConfig,
    Finding,
    ModuleModel,
    _dotted,
    last_segment,
    root_segment,
)
from .lockrules import _in_scope

_STATIC_ATTRS = {"shape", "ndim", "dtype", "device", "is_cuda", "is_cpu",
                 "layout", "itemsize", "nbytes", "requires_grad"}
_STATIC_METHODS = {"numel", "size", "dim", "element_size", "stride",
                   "is_contiguous", "data_ptr", "get_device",
                   "storage_offset", "nelement"}
_STATIC_CALLS = {"len", "isinstance", "issubclass", "getattr", "hasattr",
                 "callable", "type"}

_NONDET_ROOTS = {"random", "secrets", "uuid"}
_NONDET_DOTTED = {
    "time.time", "time.monotonic", "time.perf_counter", "time.time_ns",
    "time.monotonic_ns", "time.perf_counter_ns", "os.urandom",
    "datetime.now", "datetime.utcnow", "datetime.datetime.now",
    "datetime.datetime.utcnow",
}
_NONDET_PREFIXES = ("np.random.", "numpy.random.")
_SEEDED_RNG = {"np.random.default_rng", "numpy.random.default_rng"}
_TORCH_RANDOM = {"rand", "randn", "randint", "randperm", "rand_like",
                 "randn_like", "randint_like", "normal", "bernoulli",
                 "multinomial", "poisson"}


def _tensor_params(fn: ast.AST) -> Set[str]:
    args = fn.args
    out: Set[str] = set()
    for a in args.posonlyargs + args.args + args.kwonlyargs:
        if a.annotation is not None and \
                "Tensor" in ast.unparse(a.annotation):
            out.add(a.arg)
    return out


def _nondet_name(node: ast.Call) -> str:
    """The nondeterministic source a call reads, or ''."""
    dotted = _dotted(node.func) or ""
    root = root_segment(node.func)
    if dotted in _SEEDED_RNG:
        return "" if (node.args or node.keywords) else dotted
    if dotted in _NONDET_DOTTED or root in _NONDET_ROOTS or \
            any(dotted.startswith(p) for p in _NONDET_PREFIXES):
        return dotted or root or "?"
    if root == "torch" and last_segment(node.func) in _TORCH_RANDOM and \
            not any(kw.arg == "generator" for kw in node.keywords):
        return dotted
    return ""


def _reads_value(node: ast.AST, tensors: Set[str]) -> bool:
    if isinstance(node, ast.Attribute) and node.attr in _STATIC_ATTRS:
        return False
    if isinstance(node, ast.Call):
        if last_segment(node.func) in _STATIC_CALLS:
            return False
        if isinstance(node.func, ast.Attribute) and \
                node.func.attr in _STATIC_METHODS:
            return False
    if isinstance(node, ast.Compare) and all(
            isinstance(op, (ast.Is, ast.IsNot)) for op in node.ops):
        return False
    if isinstance(node, ast.Name):
        return node.id in tensors
    return any(_reads_value(c, tensors)
               for c in ast.iter_child_nodes(node))


def _check_body(model: ModuleModel, fn: ast.AST, tensors: Set[str],
                findings: List[Finding]) -> None:
    for node in ast.walk(fn):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)) and node is not fn:
            continue  # nested defs get their own entry if device code
        if isinstance(node, ast.Call):
            name = _nondet_name(node)
            if name:
                findings.append(Finding(
                    "jit-nondet", model.relpath, node.lineno,
                    f"{name} inside device function {fn.name}: the "
                    f"kernel and its plain version must compute the "
                    f"same function of their inputs (pass a seeded "
                    f"generator)"))
        test = None
        if isinstance(node, (ast.If, ast.While, ast.IfExp)):
            test = node.test
        if test is not None and _reads_value(test, tensors):
            findings.append(Finding(
                "jit-tracer-if", model.relpath, test.lineno,
                f"Python branch on a tensor parameter's value inside "
                f"device function {fn.name}: on CUDA this is a hidden "
                f".item(); branch on host metadata or use torch.where"))


def check_module(model: ModuleModel,
                 config: AnalyzerConfig) -> List[Finding]:
    if not _in_scope(model.relpath, config.jit_path_fragments):
        return []
    findings: List[Finding] = []
    for node in ast.walk(model.tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            tensors = _tensor_params(node)
            if tensors:
                _check_body(model, node, tensors, findings)
    return findings
