"""Delegate-side C++ compilation task (a copy of the JAX package's
yadcc_tpu/daemon/local/cxx_task.py).

Parity with reference yadcc/daemon/local/distributed_task/
cxx_compilation_task.cc:47-150: validates the client's submission,
resolves the compiler's digest through the FileDigestCache (the daemon
may not be able to read the client's compiler — the client reports the
digest via /local/set_file_digest when asked), carries the
zstd-compressed preprocessed source, and rebuilds the client-facing
response (files + patch locations) from either a servant completion or
a cache entry.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from ... import api
from ...common.limits import checked_attachment
from .. import cache_format, packing
from ..cache_format import get_cache_key
from ..task_digest import get_cxx_task_digest
from .distributed_task import DistributedTask, TaskResult


class NeedCompilerDigest(Exception):
    """The compiler's digest is unknown; the client must report it
    (mapped to HTTP 400 on /local/submit_cxx_task, after which the
    client calls /local/set_file_digest and retries — reference
    compilation_saas.cc:176-194)."""


@dataclass
class CxxCompilationTask(DistributedTask):
    requestor_pid: int
    source_path: str
    source_digest: str
    invocation_arguments: str
    cache_control: int  # 0 off, 1 on, 2 = refill (skip reads, still fill)
    compiler_digest: str
    # bytes-like: the HTTP layer hands a view into the request body, so
    # the source is never copied between loopback receive and RPC send.
    compressed_source: bytes
    ignore_timestamp_macros: bool = False

    kind = "cxx"

    def get_cache_setting(self) -> int:
        if self.cache_control in (self.CACHE_DISALLOW, self.CACHE_ALLOW,
                                  self.CACHE_REFILL):
            return self.cache_control
        return self.CACHE_ALLOW

    def get_cache_key(self) -> Optional[str]:
        if self.get_cache_setting() == self.CACHE_DISALLOW:
            return None
        return get_cache_key(self.compiler_digest,
                             self.invocation_arguments,
                             self.source_digest,
                             tenant_secret=self.tenant_key_secret)

    def get_digest(self) -> str:
        return get_cxx_task_digest(self.compiler_digest,
                                   self.invocation_arguments,
                                   self.source_digest)

    def get_env_digest(self) -> str:
        return self.compiler_digest

    def start_task(self, channel, token: str, grant_id: int) -> int:
        req = api.daemon.QueueCxxCompilationTaskRequest(
            token=token,
            task_grant_id=grant_id,
            source_path=self.source_path,
            invocation_arguments=self.invocation_arguments,
            compression_algorithm=api.daemon.COMPRESSION_ALGORITHM_ZSTD,
            disallow_cache_fill=self.cache_control <= 0,
            ignore_timestamp_macros=self.ignore_timestamp_macros,
        )
        req.env_desc.compiler_digest = self.compiler_digest
        # The servant derives the fill key in the same tenant domain
        # (env_desc.tenant_scope rides the daemon-token-authenticated
        # delegate->servant channel).
        req.env_desc.tenant_scope = self.tenant_key_secret
        resp, _ = channel.call(
            "ytpu.DaemonService", "QueueCxxCompilationTask", req,
            api.daemon.QueueCxxCompilationTaskResponse,
            attachment=self.compressed_source, timeout=30.0)
        return resp.task_id

    def parse_servant_output(self, resp, attachment) -> TaskResult:
        # Views into the reply frame — output files are not copied out
        # of the attachment; they flow into the client-facing response
        # (or the .o write) still backed by the one received buffer.
        files = packing.try_unpack_keyed_buffers_views(attachment) or {}
        patches = {
            pl.file_key: [
                (loc.position, loc.total_size, loc.suffix_to_keep)
                for loc in pl.locations
            ]
            for pl in resp.cxx_info.patches
        }
        return TaskResult(
            exit_code=resp.exit_code,
            standard_output=resp.standard_output,
            standard_error=resp.standard_error,
            files=files,
            patches=patches,
        )

    def parse_cache_entry(self, data) -> Optional[TaskResult]:
        entry = cache_format.try_parse_cache_entry(data)
        if entry is None:
            return None
        return TaskResult(
            exit_code=entry.exit_code,
            standard_output=entry.standard_output,
            standard_error=entry.standard_error,
            files=entry.files,
            patches=entry.patches,
            from_cache=True,
        )


def make_cxx_task(msg: api.local.SubmitCxxTaskRequest,
                  compressed_source: bytes,
                  file_digest_cache) -> CxxCompilationTask:
    """Build a task from the client's /local/submit_cxx_task message,
    resolving the compiler digest; raises NeedCompilerDigest when the
    memo has no entry for the reported (path, size, mtime)."""
    digest = file_digest_cache.try_get(
        msg.compiler.path, msg.compiler.size, msg.compiler.timestamp)
    if digest is None:
        raise NeedCompilerDigest(msg.compiler.path)
    return CxxCompilationTask(
        requestor_pid=msg.requestor_process_id,
        source_path=msg.source_path,
        source_digest=msg.source_digest,
        invocation_arguments=msg.compiler_invocation_arguments,
        cache_control=msg.cache_control,
        compiler_digest=digest,
        # Wire-cap the attachment at intake: no servant will accept a
        # bigger one, so queuing it only burns delegate memory and
        # retries.
        compressed_source=checked_attachment(compressed_source),
        ignore_timestamp_macros=msg.ignore_timestamp_macros,
    )
