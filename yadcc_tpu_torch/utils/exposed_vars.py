"""Process-wide introspection registry.

Parity with flare::ExposedVar as used across the reference: every
long-lived component registers a callable producing a JSON-ish dict, and
each server exposes the merged tree at /inspect/vars (reference
yadcc/doc/debugging.md:26-174 shows sample dumps for the scheduler's
dispatcher, the daemon's dispatcher, the execution engine and the cache)."""

from __future__ import annotations

import json
import threading
from typing import Any, Callable, Dict

_registry: Dict[str, Callable[[], Any]] = {}
_lock = threading.Lock()


def expose(path: str, producer: Callable[[], Any]) -> None:
    """Register a producer under a slash-separated path, e.g.
    "yadcc/task_dispatcher"."""
    with _lock:
        _registry[path] = producer


def unexpose(path: str) -> None:
    with _lock:
        _registry.pop(path, None)


def collect(prefix: str = "") -> Dict[str, Any]:
    """Evaluate all producers under `prefix` into a nested dict."""
    with _lock:
        items = [(p, f) for p, f in _registry.items() if p.startswith(prefix)]
    root: Dict[str, Any] = {}
    for path, producer in items:
        try:
            value = producer()
        except Exception as e:  # producers must never break /inspect
            value = {"error": repr(e)}
        node = root
        parts = path.split("/")
        ok = True
        for part in parts[:-1]:
            nxt = node.setdefault(part, {})
            if not isinstance(nxt, dict):
                # A leaf already occupies this path component; nest the
                # colliding producer under a reserved key rather than
                # clobbering (or crashing on) the existing value.
                nxt = node[part] = {"#value": nxt}
            node = nxt
        leaf = parts[-1]
        if isinstance(node.get(leaf), dict):
            node[leaf]["#value"] = value
        else:
            node[leaf] = value
    return root


def dump_json(prefix: str = "") -> str:
    return json.dumps(collect(prefix), indent=2, sort_keys=True, default=str)
