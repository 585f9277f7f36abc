"""Delegate-side jit build task (a copy of the JAX package's
yadcc_tpu/daemon/local/jit_task.py; in the port the computation is one
``.cu`` source and the servant's worker builds it with nvcc).

The dispatcher's cache, join and dispatch machinery is workload-agnostic:
this class supplies the four task-specific ingredients (cache key, dedup
digest, servant submission RPC, output parsing) and inherits
cluster-wide dedup of identical in-flight builds — N hosts building the
same source at once build it once (RunningTaskKeeper join on the task
digest, as duplicate TUs do).  The environment is (backend, toolchain
version); the wire field that carries the version keeps the JAX
package's name, ``toolchain_version``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from ... import api
from ...common.limits import checked_attachment
from ...jit.env import jit_env_digest
from .. import cache_format, packing
from ..cache_format import get_jit_cache_key
from ..task_digest import get_jit_task_digest
from .distributed_task import DistributedTask, TaskResult


class NeedJitEnvironment(Exception):
    """The submission names no jit environment (backend + toolchain
    version); mapped to HTTP 400 on /local/submit_jit_task, after which
    the client fills in its local environment and retries — the
    NeedCompilerDigest pattern of the cxx route."""


@dataclass
class JitCompilationTask(DistributedTask):
    requestor_pid: int
    computation_digest: str
    compile_options: bytes
    backend: str
    toolchain_version: str
    cache_control: int  # 0 off, 1 on, 2 = refill (skip reads, still fill)
    # bytes-like: the compressed source, a view into the HTTP body.
    compressed_computation: bytes

    kind = "jit"

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
        return get_jit_cache_key(self.env_digest, self.compile_options,
                                 self.computation_digest,
                                 tenant_secret=self.tenant_key_secret)

    def get_digest(self) -> str:
        return get_jit_task_digest(self.env_digest, self.compile_options,
                                   self.computation_digest)

    def get_env_digest(self) -> str:
        return self.env_digest

    def start_task(self, channel, token: str, grant_id: int) -> int:
        req = api.jit.QueueJitCompilationTaskRequest(
            token=token,
            task_grant_id=grant_id,
            computation_digest=self.computation_digest,
            compile_options=bytes(self.compile_options),
            backend=self.backend,
            compression_algorithm=api.daemon.COMPRESSION_ALGORITHM_ZSTD,
            disallow_cache_fill=self.cache_control <= 0,
        )
        req.env_desc.compiler_digest = self.env_digest
        req.env_desc.tenant_scope = self.tenant_key_secret
        resp, _ = channel.call(
            "ytpu.DaemonService", "QueueJitCompilationTask", req,
            api.jit.QueueJitCompilationTaskResponse,
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
            data, expect_kind=cache_format.KIND_JIT)
        if entry is None:
            return None
        return TaskResult(
            exit_code=entry.exit_code,
            standard_output=entry.standard_output,
            standard_error=entry.standard_error,
            files=entry.files,
            from_cache=True,
        )


def make_jit_task(msg: "api.jit.SubmitJitTaskRequest",
                  compressed_computation: bytes) -> JitCompilationTask:
    """Build a task from the client's /local/submit_jit_task message;
    raises NeedJitEnvironment when the environment pair is missing —
    the delegate never guesses which toolchain the client builds for."""
    if not msg.backend or not msg.jaxlib_version:
        raise NeedJitEnvironment(
            f"backend={msg.backend!r} jaxlib_version={msg.jaxlib_version!r}")
    if not msg.computation_digest:
        raise ValueError("computation_digest is required")
    return JitCompilationTask(
        requestor_pid=msg.requestor_process_id,
        computation_digest=msg.computation_digest,
        compile_options=msg.compile_options,
        backend=msg.backend,
        toolchain_version=msg.jaxlib_version,
        cache_control=msg.cache_control,
        # Same wire-cap-at-intake contract as make_cxx_task.
        compressed_computation=checked_attachment(compressed_computation),
    )
