"""Servant-side autotune slice sweep, one fan-out child (a port of the JAX
package's yadcc_tpu/daemon/cloud/autotune_task.py).

Builds each config of a contiguous slice of a sweep's candidates from
the attached ``.cu`` template and writes the slice's WINNING CONFIG
RECORD — JSON ``{"config": ..., "score": ..., "metric": ...,
"evaluated": N}`` — as its one artifact.  The record is what enters the
cache (kind="autotune", ``ytpu-tune1-`` namespace, keyed by (env, slice
digest, kernel digest)), so a second host sweeping the same slice of the
same template gets the measurement for free.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import List, Optional

from ...jit.fanout import slice_digest
from .. import cache_format
from ..cache_format import get_autotune_cache_key
from ..task_digest import get_autotune_task_digest
from .jit_task import WorkerTask, _worker_mem_bytes
from .temporary import TemporaryDir

# The slice child's one artifact: its winner record.
RECORD_KEY = ".cfg"


@dataclass
class CloudAutotuneTask(WorkerTask):
    env_digest: str
    backend: str
    configs: List[str]  # canonical-JSON candidates (this slice)
    claimed_kernel_digest: str
    temp_root: str
    disallow_cache_fill: bool = False
    tenant_scope: str = ""

    kernel_digest: str = ""
    workspace: Optional[TemporaryDir] = None
    cmdline: str = ""

    _prefix = "tune_"
    _artifact_key = RECORD_KEY
    _kind = cache_format.KIND_AUTOTUNE
    _what = "kernel"

    def prepare(self, compressed_kernel: bytes) -> None:  # ytpu: acquires(workspace)
        kernel, self.kernel_digest = self._intake(
            compressed_kernel, self.claimed_kernel_digest)
        parsed = []
        for c in self.configs:
            try:
                obj = json.loads(c)
            except ValueError:
                obj = None
            if not isinstance(obj, dict):
                raise ValueError("config is not a JSON object")
            parsed.append(obj)
        if not parsed:
            raise ValueError("empty config slice")
        self._stage({
            "backend": self.backend,
            "mem_limit_bytes": _worker_mem_bytes(),
            "autotune_configs": parsed,
        }, kernel)

    @property
    def slice_digest(self) -> str:
        return slice_digest(self.configs)

    @property
    def task_digest(self) -> str:
        return get_autotune_task_digest(self.env_digest,
                                        self.slice_digest,
                                        self.kernel_digest)

    @property
    def cache_key(self) -> str:
        return get_autotune_cache_key(self.env_digest, self.slice_digest,
                                      self.kernel_digest,
                                      tenant_secret=self.tenant_scope)
