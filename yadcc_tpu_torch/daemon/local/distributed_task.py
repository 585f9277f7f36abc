"""Distributed-task SPI, delegate side (a copy of the JAX package's
yadcc_tpu/daemon/local/distributed_task.py: the C++ and jit tasks, and
the fan-out parents of AOT and autotune with their per-child verdicts).

Parity with reference yadcc/daemon/local/distributed_task.h: the
dispatcher state machine is language-agnostic; a task type supplies its
cache key, dedup digest, how to start itself on a chosen servant, and
how to digest the servant's completion into a client-facing result.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple


@dataclass
class TaskResult:
    exit_code: int = -1
    standard_output: bytes = b""
    standard_error: bytes = b""
    # file key (extension) -> compressed bytes, passed through untouched.
    files: Dict[str, bytes] = field(default_factory=dict)
    patches: Dict[str, List[Tuple[int, int, bytes]]] = field(
        default_factory=dict)
    # Provenance (reference distributed_task_dispatcher.h:222-224).
    from_cache: bool = False
    reused_existing: bool = False
    # Fan-out parents only (jit/fanout.py): one ChildVerdict per child,
    # in submission order, surfaced to the client verbatim.
    verdicts: List = field(default_factory=list)


class DistributedTask:
    """SPI; implementations: CxxCompilationTask, JitCompilationTask, and
    the fan-out kinds (daemon/local/{aot,autotune}_task.py).

    Implementations must expose `requestor_pid` (0 = unknown) for the
    dispatcher's orphan-kill timer, and a class-level `kind` string
    (stable, lowercase) used for per-workload stats and diagnostics."""

    kind = "unknown"

    # Fan-out parents (jit/fanout.py) set this True and implement
    # expand_children()/reduce() instead of the servant-facing methods;
    # the dispatcher routes them through its fan-out path, where every
    # child is a normal DistributedTask of the same kind.
    is_fanout = False

    # Weighted-fair grant admission: grants are handed out fair-share
    # across fairness keys, weighted by this.
    fairness_weight = 1.0

    # Verified tenant identity, stamped onto INSTANCES by the delegate
    # HTTP surface after credential verification — never taken from the
    # request body.  Class-level defaults are the single-tenant mode: no
    # tenant, shared cache domain, full fairness weight at the
    # (degenerate, single-entry) tenant level.
    tenant_id = ""
    tenant_tier = ""
    tenant_key_secret = ""
    tenant_weight = 1.0
    # Fan-out width cap for this submission (0 = global default),
    # derived from the tenant's tier or spec at the HTTP surface.
    tenant_fanout_cap = 0

    def fairness_key(self) -> str:
        """Requestor identity for fair grant hand-out: the submitting
        process.  With tenancy enabled this is the WITHIN-tenant key;
        the tenant level above it is ``fairness_tenant()`` (two-level
        stride, daemon/local/fair_admission.py)."""
        return str(getattr(self, "requestor_pid", 0))

    def fairness_tenant(self) -> str:
        """Tenant identity for the outer stride level; "" = the shared
        legacy tenant."""
        return self.tenant_id

    # Cache policy (reference distributed_task.h:36 CacheControl):
    CACHE_DISALLOW = 0  # never read, never fill
    CACHE_ALLOW = 1     # read and fill
    CACHE_REFILL = 2    # skip the read, (re)fill on completion — used
    #                     to rebuild a suspect cache without trusting it

    def get_cache_setting(self) -> int:
        raise NotImplementedError

    def get_cache_key(self) -> Optional[str]:
        """None when this task must bypass the cache."""
        raise NotImplementedError

    def get_digest(self) -> str:
        """Cluster-wide dedup digest."""
        raise NotImplementedError

    def get_env_digest(self) -> str:
        raise NotImplementedError

    def start_task(self, channel, token: str, grant_id: int) -> int:
        """Issue Queue*Task on the servant; returns the servant task id."""
        raise NotImplementedError

    def parse_servant_output(self, resp, attachment: bytes) -> TaskResult:
        raise NotImplementedError

    def parse_cache_entry(self, data: bytes) -> Optional[TaskResult]:
        raise NotImplementedError
