"""Servant-side AOT topology build, one fan-out child (a port of the JAX
package's yadcc_tpu/daemon/cloud/aot_task.py).

The jit task's intake, with the topology carried into the worker's
options (-DYTPU_DEVICE_COUNT and -DYTPU_MESH_SHAPE, and the topology's
own compile options, which may name its ``arch``) and into the cache
identity (kind="aot" entries in the ``ytpu-aot1-`` namespace, keyed per
topology).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

from .. import cache_format
from ..cache_format import get_aot_cache_key
from ..task_digest import get_aot_task_digest
from .jit_task import WorkerTask, _worker_mem_bytes
from .temporary import TemporaryDir


@dataclass
class CloudAotCompilationTask(WorkerTask):
    env_digest: str
    backend: str
    mesh_shape: Tuple[int, ...]
    device_count: int
    compile_options: bytes
    claimed_computation_digest: str
    temp_root: str
    disallow_cache_fill: bool = False
    tenant_scope: str = ""

    computation_digest: str = ""
    workspace: Optional[TemporaryDir] = None
    cmdline: str = ""

    _prefix = "aot_"
    _kind = cache_format.KIND_AOT

    def prepare(self, compressed_computation: bytes) -> None:  # ytpu: acquires(workspace)
        source, self.computation_digest = self._intake(
            compressed_computation, self.claimed_computation_digest)
        self._stage({
            "backend": self.backend,
            "compile_options_hex": bytes(self.compile_options).hex(),
            "mem_limit_bytes": _worker_mem_bytes(),
            "mesh_shape": list(self.mesh_shape),
            "device_count": self.device_count,
        }, source)

    @property
    def topology_digest(self) -> str:
        from ...jit.fanout import TopologySpec

        return TopologySpec(mesh_shape=tuple(self.mesh_shape),
                            device_count=self.device_count,
                            compile_options=bytes(
                                self.compile_options)).digest()

    @property
    def task_digest(self) -> str:
        return get_aot_task_digest(self.env_digest, self.topology_digest,
                                   self.computation_digest)

    @property
    def cache_key(self) -> str:
        return get_aot_cache_key(self.env_digest, self.topology_digest,
                                 self.computation_digest,
                                 tenant_secret=self.tenant_scope)
