"""ytpu-analyze for the PyTorch port: AST-based concurrency, device and
wire-discipline analyzer.

The port keeps concurrency honest by convention, as the JAX package
does: ``*_locked`` method suffixes, ``# guarded by:`` comments, leaf
locks, a runtime lock-order tracer (utils/locktrace.py).  This package
checks those conventions *statically* over the port's own source
(``python -m yadcc_tpu_torch.analysis``, default path
``yadcc_tpu_torch``).  It is pure ``ast``: it imports neither torch nor
jax, and nothing of the JAX package.  Module names, rule ids, directive
syntax (``# ytpu: ...``, ``# guarded by: ...``), CLI flags and exit
codes are the JAX analyzer's, so a directive means the same in both
trees.

Rule families:

* ``guarded-by`` / ``locked-call`` — attributes declared via
  ``# guarded by: self._lock`` trailing comments may only be touched
  while that lock is held (a ``with self._lock:`` block, a Condition
  constructed over it, or a ``*_locked`` method, which by convention
  runs with the class's primary lock held); ``self.*_locked()`` calls
  require the lock too.
* ``lock-order`` — nested ``with`` acquisitions are extracted as
  edges and checked against the port's own declared hierarchy
  (analysis/lock_hierarchy.toml).
* ``block-under-lock`` — sleeps, file/socket I/O, RPC calls, torch
  readbacks and fences, and device dispatch (``torch.*`` and the kernel
  wrappers' modules, under any import alias) inside a lock body in
  scheduler/ and daemon/ hot paths.
* ``jit-nondet`` / ``jit-tracer-if`` — restated for the port's device
  functions (kernel wrappers and plain versions, in ops/, parallel/,
  device_pool.py and placement.py): unseeded randomness or wall-clock
  reads, and branches on a tensor's value (jit_hygiene.py).
  ``jit-static-unhashable`` keeps its id with no matcher.
* ``device-sync`` — torch's host-blocking syncs in the
  dispatcher-cycle modules (device_sync.py).
* ``taint-*`` — interprocedural untrusted-taint: sources declared
  ``# ytpu: untrusted(...)`` on the network intake functions,
  sanitizers declared ``# ytpu: sanitizes(size-cap|key-domain|...)``
  on the validation helpers, sinks = allocations/waits/paths/argv/
  cache keys; ``taint-registry`` proves every registered TaskType
  routes its intake through validation (taint.py).
* ``lifecycle-*`` — acquire/release pairing across exception paths
  for temp workspaces, handles, pools and subprocesses, plus
  ``# ytpu: acquires(...)`` receiver tracking and mutable-buffer view
  escapes (lifecycle.py).
* ``reply-*`` / ``await-under-lock`` / ``loop-affinity`` /
  ``async-*`` — the parked serving plane's protocol (asyncproto.py).
* ``repl-*`` / ``grant-id-arith`` / ``takeover-order`` — the journal
  and exactly-once family (replproto.py).
* ``wire-*`` — api/protos ↔ committed gen descriptors ↔ the pinned
  golden (analysis/wire_golden.json, the JAX package's content: the
  wire is byte-identical by design) ↔ field accesses in handler code
  (wirecompat.py).

Findings carry rule id + file:line and honor
``# ytpu: allow(<rule>)  # reason`` suppressions (a suppression
without a written reason is itself a finding).  ``--baseline``,
``--stats`` and a content-hash result cache
(``~/.cache/ytpu-torch-analyze/``) keep the gate incremental.
"""

from __future__ import annotations

from .core import AnalyzerConfig, Finding, analyze_paths

__all__ = ["AnalyzerConfig", "Finding", "analyze_paths"]
