"""Servant-side jit build task (a port of the JAX package's
yadcc_tpu/daemon/cloud/jit_task.py, with ``nvcc`` as the worker).

The jit twin of CloudCxxCompilationTask: prepare decompresses and
digests the attached ``.cu`` source (fused single pass), verifies the
client's claimed digest (a corrupted or forged attachment must fail
fast, not poison the cache under the claimed key), and stages a request
file for the build worker; completion reads the worker's artifact,
compresses it, and packs a kind="jit" cache entry.

The build is ``python -m yadcc_tpu_torch.jit.compile_worker`` in its own
process group via the execution engine that runs compilers: admission,
reference counting, kill on lease expiry and completed-task GC come with
it.  The worker's ``TMPDIR`` is the workspace, so nvcc's intermediates
die with it.  No path patching: the artifact is a shared library built
from ``src.cu`` in the workspace, and nothing reads it back by path.

The artifact key is the JAX package's ``.xla`` (and ``.{tag}.xla`` for
AOT children), kept byte for byte so both packages' delegates, servants
and caches talk on one wire; in the port it names a shared library.
"""

from __future__ import annotations

import json
import os
import shlex
import sys
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

from ...common import compress
from ...common.multi_chunk import make_multi_chunk
from ...common.payload import Payload
from .. import cache_format
from ..cache_format import CacheEntry, get_jit_cache_key
from ..task_digest import get_jit_task_digest
from .cxx_task import _PACK_EXECUTOR
from .execution_engine import TaskOutput
from .temporary import TemporaryDir

ARTIFACT_KEY = ".xla"

# Default address-space ceiling for the build worker; nvcc, cicc, ptxas
# and the host compiler inherit it.  Override (or disable with 0) with
# YTPU_JIT_WORKER_MEM_BYTES on the servant.  The JAX package's default:
# it is part of the request the fake worker digests.
_DEFAULT_WORKER_MEM_BYTES = 8 << 30


def _worker_mem_bytes() -> int:
    try:
        return int(os.environ.get("YTPU_JIT_WORKER_MEM_BYTES",
                                  _DEFAULT_WORKER_MEM_BYTES))
    except ValueError:
        return _DEFAULT_WORKER_MEM_BYTES


def _fake_worker() -> bool:
    """YTPU_JIT_FAKE_WORKER=1: deterministic pseudo-builds (tests: the
    farm, not nvcc)."""
    return os.environ.get("YTPU_JIT_FAKE_WORKER", "0") == "1"


def worker_subprocess_env(workspace: str) -> dict:
    """The daemon's environment, plus the checkout's root on PYTHONPATH
    (the engine launches from the workspace, where ``-m
    yadcc_tpu_torch...`` would not resolve) and TMPDIR in the workspace."""
    pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    env = dict(os.environ)
    existing = env.get("PYTHONPATH", "")
    env["PYTHONPATH"] = pkg_root + (os.pathsep + existing
                                    if existing else "")
    env["TMPDIR"] = workspace
    return env


class WorkerTask:
    """What the jit, AOT and autotune servant tasks share: the intake
    (decompress, digest, claimed-digest check), the staged request, the
    worker's command line, and the completion that packs the artifact
    into a cache entry and removes the workspace on every path."""

    _prefix = "jit_"
    _artifact_key = ARTIFACT_KEY
    _kind = cache_format.KIND_JIT
    _what = "source"

    def _intake(self, compressed: bytes, claimed: str) -> Tuple[bytes, str]:
        try:
            data, digest = compress.decompress_and_digest(compressed)
        except (compress.CompressionError, MemoryError, ValueError):
            raise ValueError(f"{self._what} attachment is not valid zstd")
        if claimed and digest != claimed:
            raise ValueError(f"{self._what} digest mismatch")
        return data, digest

    def _stage(self, options: dict, payload: bytes) -> None:  # ytpu: acquires(workspace)
        self.workspace = TemporaryDir(self.temp_root, self._prefix)
        with open(f"{self.workspace.path}/request.bin", "wb") as fp:
            fp.write(make_multi_chunk(
                [json.dumps(options, sort_keys=True).encode(), payload]))
        fake = " --fake" if _fake_worker() else ""
        self.cmdline = (
            f"{shlex.quote(sys.executable)} -m "
            f"yadcc_tpu_torch.jit.compile_worker "
            f"--workspace {shlex.quote(self.workspace.path)}{fake}"
        )

    def worker_env(self) -> dict:
        return worker_subprocess_env(self.workspace.path)

    def collect_outputs(self, output: TaskOutput) -> Tuple[
        Dict[str, bytes],
        Dict[str, list],
        Optional[Payload],
    ]:
        """(compressed artifacts by key, empty patches, cache-entry
        payload or None).  Removes the workspace, also when the worker
        was killed mid-build (the engine's waiter still fires this with
        the SIGKILL exit code)."""
        assert self.workspace is not None
        try:
            files: Dict[str, bytes] = {}
            artifact = None
            if output.exit_code == 0:
                try:
                    with open(f"{self.workspace.path}/artifact.bin",
                              "rb") as fp:
                        artifact = fp.read()
                except OSError:
                    artifact = None
            entry_future = None
            if artifact is not None:
                files[self._artifact_key] = compress.compress(artifact)
                if not self.disallow_cache_fill:
                    entry_future = _PACK_EXECUTOR.get().submit(
                        cache_format.write_cache_entry_payload, CacheEntry(
                            exit_code=output.exit_code,
                            standard_output=output.standard_output,
                            standard_error=output.standard_error,
                            files=files,
                            kind=self._kind,
                        ))
            return files, {}, (entry_future.result()
                               if entry_future is not None else None)
        finally:
            self.workspace.remove()


@dataclass
class CloudJitCompilationTask(WorkerTask):
    env_digest: str
    backend: str
    compile_options: bytes
    claimed_computation_digest: str
    temp_root: str
    disallow_cache_fill: bool = False
    # Tenant cache domain (env_desc.tenant_scope).
    tenant_scope: str = ""

    computation_digest: str = ""
    workspace: Optional[TemporaryDir] = None
    cmdline: str = ""

    def prepare(self, compressed_computation: bytes) -> None:  # ytpu: acquires(workspace)
        source, self.computation_digest = self._intake(
            compressed_computation, self.claimed_computation_digest)
        self._stage({
            "backend": self.backend,
            "compile_options_hex": bytes(self.compile_options).hex(),
            "mem_limit_bytes": _worker_mem_bytes(),
        }, source)

    @property
    def task_digest(self) -> str:
        return get_jit_task_digest(self.env_digest, self.compile_options,
                                   self.computation_digest)

    @property
    def cache_key(self) -> str:
        return get_jit_cache_key(self.env_digest, self.compile_options,
                                 self.computation_digest,
                                 tenant_secret=self.tenant_scope)
