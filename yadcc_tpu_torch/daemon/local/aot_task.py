"""Delegate-side AOT multi-topology build (a copy of the JAX package's
yadcc_tpu/daemon/local/aot_task.py).

One client submission carries a ``.cu`` source plus a list of
topology specs; the dispatcher's fan-out path (jit/fanout.py) expands
it into one ``AotTopologyCompilationTask`` per topology.  Each child is
a full DistributedTask — its own topology-tagged cache key
(``ytpu-aot1-``), its own dedup digest, its own grant — so the
cache→join→dispatch machinery gives partial-hit reuse for free: cached
topologies resolve from the distributed cache without a grant, and only
the misses fan out to servants."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from ... import api
from ...common.limits import checked_attachment
from ...jit import fanout
from ...jit.env import jit_env_digest
from .. import cache_format, packing
from ..cache_format import get_aot_cache_key
from ..task_digest import get_aot_task_digest
from .distributed_task import DistributedTask, TaskResult
from .jit_task import NeedJitEnvironment

# The one artifact key a topology child's servant packs (the library;
# see daemon/cloud/jit_task.py ARTIFACT_KEY — kept as a literal to avoid
# a local->cloud import).
_CHILD_ARTIFACT_KEY = ".xla"


@dataclass
class AotTopologyCompilationTask(DistributedTask):
    """One fan-out CHILD: compile the parent's module for exactly one
    topology.  Mirrors JitCompilationTask with the topology folded
    into every identity (digest, cache key, servant request)."""

    requestor_pid: int
    computation_digest: str
    backend: str
    toolchain_version: str
    cache_control: int
    topology: fanout.TopologySpec
    # bytes-like: the compressed source — a view shared with the parent
    # (and its sibling children); never copied per child.
    compressed_computation: bytes

    kind = "aot"

    def get_cache_setting(self) -> int:
        if self.cache_control in (self.CACHE_DISALLOW, self.CACHE_ALLOW,
                                  self.CACHE_REFILL):
            return self.cache_control
        return self.CACHE_ALLOW

    @property
    def env_digest(self) -> str:
        return jit_env_digest(self.backend, self.toolchain_version)

    def get_cache_key(self) -> Optional[str]:
        if self.get_cache_setting() == self.CACHE_DISALLOW:
            return None
        return get_aot_cache_key(self.env_digest, self.topology.digest(),
                                 self.computation_digest,
                                 tenant_secret=self.tenant_key_secret)

    def get_digest(self) -> str:
        return get_aot_task_digest(self.env_digest,
                                   self.topology.digest(),
                                   self.computation_digest)

    def get_env_digest(self) -> str:
        return self.env_digest

    def start_task(self, channel, token: str, grant_id: int) -> int:
        req = api.fanout.QueueAotCompilationTaskRequest(
            token=token,
            task_grant_id=grant_id,
            computation_digest=self.computation_digest,
            backend=self.backend,
            compression_algorithm=api.daemon.COMPRESSION_ALGORITHM_ZSTD,
            disallow_cache_fill=self.cache_control <= 0,
        )
        req.env_desc.compiler_digest = self.env_digest
        req.env_desc.tenant_scope = self.tenant_key_secret
        req.topology.mesh_shape.extend(self.topology.mesh_shape)
        req.topology.device_count = self.topology.device_count
        req.topology.compile_options = bytes(
            self.topology.compile_options)
        resp, _ = channel.call(
            "ytpu.DaemonService", "QueueAotCompilationTask", req,
            api.fanout.QueueAotCompilationTaskResponse,
            attachment=self.compressed_computation, timeout=30.0)
        return resp.task_id

    def parse_servant_output(self, resp, attachment) -> TaskResult:
        files = packing.try_unpack_keyed_buffers_views(attachment) or {}
        return TaskResult(
            exit_code=resp.exit_code,
            standard_output=resp.standard_output,
            standard_error=resp.standard_error,
            files=files,
        )

    def parse_cache_entry(self, data) -> Optional[TaskResult]:
        entry = cache_format.try_parse_cache_entry(
            data, expect_kind=cache_format.KIND_AOT)
        if entry is None:
            return None
        return TaskResult(
            exit_code=entry.exit_code,
            standard_output=entry.standard_output,
            standard_error=entry.standard_error,
            files=entry.files,
            from_cache=True,
        )


@dataclass
class AotBuildTask(DistributedTask):
    """The fan-out PARENT: never touches a servant itself — it expands
    into topology children, joins them, and reduces their artifacts
    into one topology-keyed result with explicit per-child verdicts."""

    requestor_pid: int
    computation_digest: str
    backend: str
    toolchain_version: str
    cache_control: int
    topologies: List[fanout.TopologySpec]
    compressed_computation: bytes

    kind = "aot"
    is_fanout = True

    def get_cache_setting(self) -> int:
        if self.cache_control in (self.CACHE_DISALLOW, self.CACHE_ALLOW,
                                  self.CACHE_REFILL):
            return self.cache_control
        return self.CACHE_ALLOW

    def get_cache_key(self) -> Optional[str]:
        # No parent-level entry: the unit of caching is the topology
        # (that is what makes partial hits possible at all).
        return None

    def get_digest(self) -> str:
        # Diagnostics only — parents are never deduped as a unit; the
        # children carry the cluster-wide dedup.
        return get_aot_task_digest(
            jit_env_digest(self.backend, self.toolchain_version),
            fanout.slice_digest([t.digest() for t in self.topologies]),
            self.computation_digest)

    def get_env_digest(self) -> str:
        return jit_env_digest(self.backend, self.toolchain_version)

    def parse_cache_entry(self, data) -> Optional[TaskResult]:
        return None

    # -- fan-out SPI ---------------------------------------------------------

    def expand_children(self) -> List[Tuple[str, DistributedTask]]:
        fanout.checked_fanout_width(len(self.topologies))
        children: List[Tuple[str, DistributedTask]] = []
        for topo in self.topologies:
            children.append((topo.tag(), AotTopologyCompilationTask(
                requestor_pid=self.requestor_pid,
                computation_digest=self.computation_digest,
                backend=self.backend,
                toolchain_version=self.toolchain_version,
                cache_control=self.cache_control,
                topology=topo,
                compressed_computation=self.compressed_computation,
            )))
        fanout.split_fairness(self, [c for _, c in children])
        return children

    def reduce(self, outcomes: Dict[str, fanout.ChildOutcome]
               ) -> TaskResult:
        files: Dict[str, bytes] = {}
        for key, outcome in outcomes.items():
            result = outcome.result
            if result is not None and result.exit_code == 0:
                artifact = result.files.get(_CHILD_ARTIFACT_KEY)
                if artifact is not None:
                    files[f".{key}.xla"] = artifact
        code = fanout.aggregate_exit_code(outcomes)
        return TaskResult(
            exit_code=code,
            standard_output=fanout.verdict_summary(outcomes).encode(),
            standard_error=(b"" if code == 0 else
                            b"aot fan-out completed with failures: "
                            + fanout.verdict_summary(outcomes).encode()),
            files=files,
            verdicts=[o.verdict for o in outcomes.values()],
        )


def make_aot_task(msg: "api.fanout.SubmitAotTaskRequest",
                  compressed_computation: bytes) -> AotBuildTask:
    """Build the fan-out parent from /local/submit_aot_task; raises
    NeedJitEnvironment (HTTP 400, report-and-retry) when the
    environment pair is missing, ValueError on a malformed topology
    list or an over-wide fan-out."""
    if not msg.backend or not msg.jaxlib_version:
        raise NeedJitEnvironment(
            f"backend={msg.backend!r} jaxlib_version={msg.jaxlib_version!r}")
    if not msg.computation_digest:
        raise ValueError("computation_digest is required")
    topologies = [
        fanout.TopologySpec(
            mesh_shape=tuple(t.mesh_shape),
            device_count=t.device_count,
            compile_options=bytes(t.compile_options),
        ).validate()
        for t in msg.topologies
    ]
    fanout.checked_fanout_width(len(topologies))
    if len({t.digest() for t in topologies}) != len(topologies):
        raise ValueError("duplicate topology in submission")
    return AotBuildTask(
        requestor_pid=msg.requestor_process_id,
        computation_digest=msg.computation_digest,
        backend=msg.backend,
        toolchain_version=msg.jaxlib_version,
        cache_control=msg.cache_control,
        topologies=topologies,
        # Same wire-cap-at-intake contract as make_cxx_task.
        compressed_computation=checked_attachment(compressed_computation),
    )
