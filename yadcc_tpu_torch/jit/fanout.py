"""Fan-out machinery: one logical submission, many grants (a copy of the
JAX package's yadcc_tpu/jit/fanout.py; digests, tags, slices, the
fairness split and the verdicts are equal to its own byte for byte).

The cxx and jit workloads are 1:1 — one submission, one cache key, one
grant.  Workloads 3 & 4 (AOT multi-topology builds, autotune sweeps)
share a different shape: the delegate expands ONE client submission
into MANY child tasks, each a full ``DistributedTask`` that rides the
existing cache→join→dispatch machinery independently — so every child
is cacheable and dedupable cluster-wide on its own, and a partial
cache hit fans out only the misses.  This module is the one place that
shape lives (doc/workloads.md):

  * **bounded width** — a submission may expand to at most
    ``MAX_FANOUT_WIDTH`` children (``YTPU_FANOUT_MAX_WIDTH``
    overrides, validated); an oversized submission is refused at
    intake, not queued;
  * **fairness splitting** — children inherit the parent requestor's
    fairness key and split its weight, so a 64-topology submission
    draws ONE submission's share from ``FairGrantQueue``, not 64
    clients' worth (doc/robustness.md);
  * **straggler / partial-failure semantics** — child infrastructure
    failures (no capacity, servant lost, hung past the child budget)
    retry under ``common/backoff.py``; deterministic compile failures
    do not.  The parent always completes, carrying an explicit
    per-child verdict either way.

Layering: this module never imports the daemon — the coordinator takes
the dispatcher's queue/wait/free surface as callables, so the fan-out
semantics are unit-testable against fakes (tests/test_torch_fanout.py).
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from ..common.backoff import Backoff
from ..common.hashing import digest_keyed

# Hard ceiling on children per submission.  The width bound is a
# delegate-side admission decision, like the wire cap: an unbounded
# fan-out would let one client mint thousands of grant waiters (and
# threads) from a single POST.
DEFAULT_MAX_FANOUT_WIDTH = 64

# Auto width for autotune sweeps when the client passes 0: enough
# slices to spread across a handful of servants without shattering a
# small space into single-config children.
DEFAULT_AUTOTUNE_WIDTH = 4

_TOPOLOGY_DOMAIN = "ytpu-aot-topology"
_SLICE_DOMAIN = "ytpu-autotune-slice"
_SPACE_DOMAIN = "ytpu-autotune-space"


def max_fanout_width() -> int:
    """The per-submission child cap; YTPU_FANOUT_MAX_WIDTH overrides,
    unparseable or non-positive values fall back to the default (an
    env typo must not turn the bound off)."""
    raw = os.environ.get("YTPU_FANOUT_MAX_WIDTH", "")
    try:
        n = int(raw)
    except ValueError:
        return DEFAULT_MAX_FANOUT_WIDTH
    return n if n > 0 else DEFAULT_MAX_FANOUT_WIDTH


def checked_fanout_width(n: int, cap: Optional[int] = None) -> int:  # ytpu: sanitizes(size-cap)
    """Bound a submission's requested fan-out; raises ValueError on an
    empty or oversized expansion.  Declared a sanitizer: the taint
    pass proves every fan-out factory routes its child count through
    here before the dispatcher spawns anything."""
    limit = cap if cap is not None else max_fanout_width()
    if n <= 0:
        raise ValueError("fan-out of 0 children (empty submission)")
    if n > limit:
        raise ValueError(
            f"fan-out of {n} children exceeds the per-submission "
            f"width bound {limit}")
    return n


# ---------------------------------------------------------------------------
# Topology specs (AOT) and config spaces (autotune).
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class TopologySpec:
    """One AOT build target: the device-mesh shape (1- or 2-level), its
    device count, and per-topology compile options (in the port the
    canonical JSON of jit/compile_worker.py, which may name the
    topology's ``arch``).  The worker passes the mesh to the source as
    -DYTPU_DEVICE_COUNT and -DYTPU_MESH_SHAPE."""

    mesh_shape: Tuple[int, ...]
    device_count: int
    compile_options: bytes = b""

    def validate(self) -> "TopologySpec":
        if not self.mesh_shape or len(self.mesh_shape) > 2:
            raise ValueError(
                f"mesh_shape must be 1- or 2-level, got "
                f"{self.mesh_shape!r}")
        if any(d <= 0 for d in self.mesh_shape):
            raise ValueError(f"non-positive mesh axis in "
                             f"{self.mesh_shape!r}")
        prod = 1
        for d in self.mesh_shape:
            prod *= d
        if self.device_count != prod:
            raise ValueError(
                f"device_count {self.device_count} != "
                f"prod(mesh_shape) {prod}")
        return self

    def digest(self) -> str:
        """Domain-separated digest of the full spec; the AOT child
        cache key is tagged with this, so every topology of one module
        occupies its own cache slot."""
        return digest_keyed(
            _TOPOLOGY_DOMAIN,
            ",".join(str(d) for d in self.mesh_shape).encode(),
            str(self.device_count).encode(),
            bytes(self.compile_options),
        )

    def tag(self) -> str:
        """Short human-scannable child key: mesh shape + digest head
        (``2x4-ab12cd34``) — stable, collision-checked at full-digest
        level by the cache key itself."""
        return ("x".join(str(d) for d in self.mesh_shape)
                + "-" + self.digest()[:8])


def canonical_config(config: Dict) -> str:
    """One autotune candidate as canonical JSON (sorted keys, no
    whitespace variance): the unit of search-space digesting and wire
    transport."""
    return json.dumps(config, sort_keys=True, separators=(",", ":"))


def slice_digest(configs: Sequence[str]) -> str:
    """Digest of one child's config slice (canonical-JSON strings)."""
    return digest_keyed(_SLICE_DOMAIN,
                        *[c.encode() for c in configs])


def search_space_digest(configs: Sequence[str]) -> str:
    """Digest of the WHOLE candidate list — the sweep-level cache key
    component.  Order-sensitive on purpose: the slice boundaries (and
    therefore the child keys) derive from list order, so a reordered
    space is a different sweep."""
    return digest_keyed(_SPACE_DOMAIN,
                        *[c.encode() for c in configs])


def slice_configs(configs: Sequence[str],
                  width: int) -> List[List[str]]:
    """Split the candidate list into ``width`` contiguous,
    near-equal slices (the fan-out children).  Deterministic: the same
    (space, width) pair always produces the same slices, so slice
    cache keys are stable across hosts."""
    width = min(max(1, width), len(configs))
    out: List[List[str]] = []
    base, extra = divmod(len(configs), width)
    start = 0
    for i in range(width):
        n = base + (1 if i < extra else 0)
        out.append(list(configs[start:start + n]))
        start += n
    return out


# ---------------------------------------------------------------------------
# Verdicts and the coordinator.
# ---------------------------------------------------------------------------

# Verdict statuses (doc/workloads.md, partial-failure contract).
STATUS_OK = "ok"            # servant compiled it on this submission
STATUS_CACHED = "cached"    # served from the distributed cache
STATUS_JOINED = "joined"    # joined an identical in-flight task
STATUS_FAILED = "failed"    # deterministic failure (would fail anywhere)
STATUS_INFRA = "infra"      # infrastructure failure after retries


@dataclass
class ChildVerdict:
    child_key: str
    status: str
    exit_code: int
    attempts: int
    error: str = ""


@dataclass
class ChildOutcome:
    verdict: ChildVerdict
    # The child's TaskResult (duck-typed: exit_code / files /
    # from_cache / reused_existing), None when every attempt failed to
    # produce one.
    result: object = None


@dataclass
class FanoutPolicy:
    """Retry/straggler knobs for one parent."""

    max_attempts: int = 3
    # Overall child budget: a child (including its retries) that has
    # not resolved by this deadline is an infra verdict, and the
    # parent completes without it — stragglers bound the parent, they
    # do not hang it.
    child_budget_s: float = 240.0
    backoff_initial_s: float = 0.1
    backoff_max_s: float = 2.0


def split_fairness(parent, children: Sequence[object]) -> None:
    """Children inherit the parent requestor's fairness key (they
    already share its ``requestor_pid``) and split its weight: the
    whole fan-out draws one submission's share of grants, however wide
    it is.  Weights land on the instances, not the class.

    Tenant identity (doc/tenancy.md) is inherited wholesale: a child
    compiles, queues, and caches AS its parent's tenant — children that
    fell back to the class-default empty tenant would read and fill the
    SHARED cache domain, silently undoing the isolation the parent's
    submission was granted."""
    if not children:
        return
    share = getattr(parent, "fairness_weight", 1.0) / len(children)
    for child in children:
        child.fairness_weight = share
        child.tenant_id = getattr(parent, "tenant_id", "")
        child.tenant_tier = getattr(parent, "tenant_tier", "")
        child.tenant_key_secret = getattr(parent, "tenant_key_secret", "")
        child.tenant_weight = getattr(parent, "tenant_weight", 1.0)
        child.tenant_fanout_cap = getattr(parent, "tenant_fanout_cap", 0)


def _classify(result) -> Tuple[str, int, str]:
    """(status, exit_code, error) for one attempt's result."""
    if result is None:
        return (STATUS_INFRA, -1,
                "child lost or hung past its budget")
    code = result.exit_code
    err = (bytes(result.standard_error).decode(errors="replace")
           if getattr(result, "standard_error", b"") else "")
    if code < 0:
        return STATUS_INFRA, code, err
    if code > 0:
        return STATUS_FAILED, code, err
    if getattr(result, "from_cache", False):
        return STATUS_CACHED, 0, err
    if getattr(result, "reused_existing", False):
        return STATUS_JOINED, 0, err
    return STATUS_OK, 0, err


def run_fanout(
    children: Sequence[Tuple[str, object]],
    *,
    queue: Callable[[object], int],
    wait: Callable[[int, float], object],
    free: Callable[[int], None],
    policy: Optional[FanoutPolicy] = None,
    aborted: Callable[[], bool] = lambda: False,
    sleep: Callable[[float], None] = time.sleep,
    now: Callable[[], float] = time.monotonic,
) -> Dict[str, ChildOutcome]:
    """Drive ``(child_key, task)`` pairs through a dispatcher's
    queue/wait/free surface until every child has a verdict.

    All children are queued up front (they run concurrently; the
    dispatcher runs one thread per child) and joined in order — a join
    on a finished sibling returns immediately, so wall time is the
    slowest chain, not the sum.  Infra failures requeue with jittered
    backoff up to ``policy.max_attempts``; deterministic failures and
    exhausted budgets settle immediately.  Returns outcomes keyed by
    child key, in submission order."""
    policy = policy or FanoutPolicy()
    deadline = now() + policy.child_budget_s
    outcomes: Dict[str, ChildOutcome] = {}
    backoffs = {key: Backoff(initial_s=policy.backoff_initial_s,
                             max_s=policy.backoff_max_s)
                for key, _ in children}
    pending = [(key, task, 1, queue(task)) for key, task in children]
    while pending:
        requeue = []
        for key, task, attempt, task_id in pending:
            remaining = max(0.0, deadline - now())
            result = wait(task_id, remaining)
            free(task_id)
            status, code, err = _classify(result)
            retryable = (status == STATUS_INFRA
                         and attempt < policy.max_attempts
                         and not aborted()
                         and now() < deadline)
            if retryable:
                sleep(backoffs[key].next_delay())
                requeue.append((key, task, attempt + 1, queue(task)))
                continue
            outcomes[key] = ChildOutcome(
                verdict=ChildVerdict(child_key=key, status=status,
                                     exit_code=code, attempts=attempt,
                                     error=err),
                result=result,
            )
        pending = requeue
    # Submission order, not completion order: clients see a stable
    # verdict list.
    order = {key: i for i, (key, _) in enumerate(children)}
    return dict(sorted(outcomes.items(), key=lambda kv: order[kv[0]]))


def aggregate_exit_code(outcomes: Dict[str, ChildOutcome]) -> int:
    """The parent's exit code under the partial-failure contract:
    0 when every child succeeded; -1 (infra — the client may retry the
    whole submission, partial-hit makes that cheap) when any child
    failed on infrastructure; else the first deterministic failure's
    code."""
    infra = [o for o in outcomes.values()
             if o.verdict.status == STATUS_INFRA]
    if infra:
        return -1
    for o in outcomes.values():
        if o.verdict.status == STATUS_FAILED:
            return o.verdict.exit_code
    return 0


def verdict_summary(outcomes: Dict[str, ChildOutcome]) -> str:
    counts: Dict[str, int] = {}
    for o in outcomes.values():
        counts[o.verdict.status] = counts.get(o.verdict.status, 0) + 1
    return ", ".join(f"{k}={v}" for k, v in sorted(counts.items()))
