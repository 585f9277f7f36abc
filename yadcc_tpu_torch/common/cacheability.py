"""Timestamp-macro cacheability rules, shared by client and servant (a
copy of the JAX package's yadcc_tpu/common/cacheability.py).

A TU that expands __TIME__/__DATE__/__TIMESTAMP__ produces a different
object every build; caching it would freeze the clock for the whole
fleet (reference remote_task/cxx_compilation_task.cc:46-76).  The
exception: a command-line -D override of the macro (the standard
reproducible-build workaround) makes the expansion deterministic again.

Both sides apply the SAME rule from this module — the client for its
YTPU_WARN_ON_NONCACHEABLE diagnostic, the servant for the authoritative
cache-fill decision — so the warning can never disagree with what the
cache actually does.
"""

from __future__ import annotations

import shlex
from typing import Iterable, Set

TIMESTAMP_MACROS = (b"__TIME__", b"__DATE__", b"__TIMESTAMP__")


def overridden_macros(invocation_arguments: str) -> Set[bytes]:
    """Macro names neutralized by -D on the command line."""
    out: Set[bytes] = set()
    for arg in shlex.split(invocation_arguments):
        if arg.startswith("-D"):
            out.add(arg[2:].split("=", 1)[0].encode())
    return out


def blocking_macros(found: Iterable[bytes],
                    invocation_arguments: str) -> Set[bytes]:
    """Which of the macros `found` in the source actually block caching
    (i.e. are not -D-overridden)."""
    return set(found) - overridden_macros(invocation_arguments)


def scan_source_cacheability(source: bytes,
                             invocation_arguments: str) -> bool:
    """False if the preprocessed source expands timestamp macros the
    command line doesn't override."""
    found = [m for m in TIMESTAMP_MACROS if m in source]
    return not blocking_macros(found, invocation_arguments)
