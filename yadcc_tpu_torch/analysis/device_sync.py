"""Rule family 7: host-blocking device syncs in dispatcher-cycle modules.

The device-resident control plane keeps the pool tensors on the card
across dispatch cycles; the whole point is that a cycle issues ONE
launch and reads back only the picks.  A single accidental synchronous
readback — ``np.asarray(tensor)``, ``.item()``, ``.tolist()``,
``.cpu()``, ``.numpy()``, ``.to("cpu")``, ``torch.cuda.synchronize()``
or ``.synchronize()`` on a stream or event — re-serializes the
pipeline: the host stalls on the PCIe round trip every cycle and the
launch degenerates back into the host loop it replaced.

``device-sync`` flags every such call in the dispatcher-cycle modules
(config.device_sync_path_fragments — filename parts, so the scope is
per-module, not per-package).  The check is syntactic: it cannot prove
the operand lives on the card, so host-side uses (``np.asarray`` over
a Python list, ``.tolist()`` of a numpy array, the one pick readback a
cycle, the periodic statics oracle) are expected and carry an
``allow(device-sync)`` directive with its written reason on the call
line — the pragma inventory IS the audit trail of sanctioned sync
points.
Like the lock rules: false positives surface for a human decision,
silent false negatives are the failure mode we refuse.
"""

from __future__ import annotations

import ast
from typing import List, Optional

from .core import AnalyzerConfig, Finding, ModuleModel, _dotted
from .lockrules import _in_scope

# Dotted call names that force a device->host transfer (or a full
# device fence) when handed a device value.
_SYNC_DOTTED = {
    "np.asarray": "np.asarray",
    "numpy.asarray": "numpy.asarray",
    "np.array": "np.array",
    "numpy.array": "numpy.array",
    "torch.cuda.synchronize": "torch.cuda.synchronize",
}

# Tensor methods that copy the value to the host (and so wait for every
# kernel queued before them), matched on the method name whatever the
# receiver.
_SYNC_METHODS = {
    "item": ".item()",
    "tolist": ".tolist()",
    "cpu": ".cpu()",
    "numpy": ".numpy()",
    "synchronize": ".synchronize()",
}


def _is_cpu_device(node: ast.AST) -> bool:
    """``"cpu"`` or ``torch.device("cpu")`` as an expression."""
    if isinstance(node, ast.Constant) and node.value == "cpu":
        return True
    return (isinstance(node, ast.Call)
            and _dotted(node.func) in ("torch.device", "device")
            and bool(node.args) and _is_cpu_device(node.args[0]))


def _sync_call_name(node: ast.Call) -> Optional[str]:
    """The sync a call performs (for the message), or None."""
    dotted = _dotted(node.func)
    if dotted in _SYNC_DOTTED:
        return _SYNC_DOTTED[dotted]
    func = node.func
    if not isinstance(func, ast.Attribute):
        return None
    if func.attr in _SYNC_METHODS:
        return _SYNC_METHODS[func.attr]
    if func.attr == "to":
        dev = [kw.value for kw in node.keywords if kw.arg == "device"]
        if any(_is_cpu_device(a) for a in list(node.args[:1]) + dev):
            return '.to("cpu")'
    return None


def check_module(model: ModuleModel,
                 config: AnalyzerConfig) -> List[Finding]:
    if not _in_scope(model.relpath, config.device_sync_path_fragments):
        return []
    findings: List[Finding] = []
    for node in ast.walk(model.tree):
        if not isinstance(node, ast.Call):
            continue
        name = _sync_call_name(node)
        if name is None:
            continue
        if "synchronize" in name:
            msg = (f"{name} fences the device stream inside a "
                   f"dispatcher-cycle module; the dispatch path must "
                   f"stay launch-and-go")
        else:
            msg = (f"{name} in a dispatcher-cycle module blocks on a "
                   f"device->host transfer when given a device value; "
                   f"keep the hot loop async or annotate the "
                   f"sanctioned sync point")
        findings.append(Finding("device-sync", model.relpath,
                                node.lineno, msg))
    return findings
