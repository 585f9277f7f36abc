"""Client side of the autotune sweep (the port's counterpart of the JAX
package's yadcc_tpu/jit/autotune.py).

A search space of block/grid configs is enumerated here, submitted as
one logical task, sliced across servants by the delegate, and answered
with the sweep's WINNING CONFIG RECORD — which is also the cached
artifact, so a fleet sweeping the same kernel measures once.  The kernel
is a ``.cu`` template; the servant's worker builds each config with nvcc
and scores it by minus nvcc's wall time.  Pure bytes, no torch; the
YTPU_JIT_* env family gates offload exactly as for the jit and aot
kinds.

    POST /local/submit_autotune_task    multi-chunk [json, kernel]
    POST /local/wait_for_autotune_task  503 running / 404 unknown /
                                        200 multi-chunk [json, records]
"""

from __future__ import annotations

import itertools
import json
import os
from dataclasses import dataclass, field
from typing import List, Optional, Sequence

from google.protobuf import json_format

from .. import api
from ..client import env_options
from ..client.daemon_call import call_daemon
from ..common import compress, multi_chunk
from ..common.hashing import digest_bytes
from .env import BACKEND, local_jit_environment
from .fanout import canonical_config
from .frontend import longpoll_task


@dataclass(frozen=True)
class SearchSpace:
    """A cartesian block/grid search space: axis name -> candidate
    values.  ``expand()`` enumerates it to the canonical-JSON config
    list the wire carries — deterministically (sorted axis names,
    itertools.product order), so the same space always digests the
    same and slices the same."""

    axes: tuple  # ((name, (values...)), ...) — hashable, frozen

    @staticmethod
    def of(**axes: Sequence) -> "SearchSpace":
        return SearchSpace(axes=tuple(
            (name, tuple(values))
            for name, values in sorted(axes.items())))

    def expand(self) -> List[str]:
        names = [name for name, _ in self.axes]
        value_lists = [values for _, values in self.axes]
        return [
            canonical_config(dict(zip(names, combo)))
            for combo in itertools.product(*value_lists)
        ]


@dataclass
class AutotuneOutcome:
    """One sweep's joined verdict.  ``winner`` is the winning config
    record (dict: config / score / metric / evaluated) — from a live
    sweep, a partial-hit sweep, or a single sweep-level cache read;
    the caller cannot tell the difference, which is the point."""

    ok: bool
    exit_code: int = -1
    error: str = ""
    winner: Optional[dict] = None
    verdicts: List[dict] = field(default_factory=list)

    @property
    def winning_config(self) -> Optional[dict]:
        return self.winner.get("config") if self.winner else None


def sweep(
    kernel: bytes,
    space: SearchSpace,
    *,
    backend: str = BACKEND,
    toolchain_version: Optional[str] = None,
    cache_control: Optional[int] = None,
    fanout_width: int = 0,
    timeout_s: Optional[float] = None,
) -> AutotuneOutcome:
    """Sweep ``space`` over ``kernel`` (``.cu`` template bytes; ``{axis}``
    placeholders are instantiated per config) and return the winning
    config record."""
    if not env_options.jit_offload_enabled():
        return AutotuneOutcome(ok=False, error="offload disabled")
    if toolchain_version is None:
        toolchain_version = local_jit_environment(backend).toolchain_version
    if not toolchain_version:
        return AutotuneOutcome(ok=False, error="no local nvcc version")
    if timeout_s is None:
        timeout_s = env_options.jit_timeout_s()
    configs = space.expand()
    if not configs:
        return AutotuneOutcome(ok=False, error="empty search space")

    req = api.fanout.SubmitAutotuneTaskRequest(
        requestor_process_id=os.getpid(),
        kernel_digest=digest_bytes(kernel),
        backend=backend,
        jaxlib_version=toolchain_version,
        cache_control=(env_options.cache_control()
                       if cache_control is None else cache_control),
        fanout_width=fanout_width,
    )
    req.configs.extend(configs)
    body = multi_chunk.make_multi_chunk_payload([
        json_format.MessageToJson(req).encode(),
        compress.compress(kernel),
    ])
    resp = call_daemon("POST", "/local/submit_autotune_task", body)
    if resp.status != 200:
        return AutotuneOutcome(
            ok=False, error=f"submit failed: HTTP {resp.status} "
                            f"{resp.body[:200]!r}")
    task_id = json_format.Parse(
        resp.body, api.jit.SubmitJitTaskResponse()).task_id
    return _wait(task_id, timeout_s)


def _wait(task_id: int, timeout_s: float) -> AutotuneOutcome:
    msg, chunks, err = longpoll_task(
        "/local/wait_for_autotune_task",
        api.fanout.WaitForAutotuneTaskRequest,
        api.fanout.WaitForAutotuneTaskResponse, task_id, timeout_s)
    if msg is None:
        return AutotuneOutcome(ok=False, error=err)
    winner: Optional[dict] = None
    if msg.winner_config_json:
        try:
            winner = json.loads(msg.winner_config_json)
        except ValueError:
            return AutotuneOutcome(ok=False,
                                   error="corrupt winner record")
    return AutotuneOutcome(
        ok=True, exit_code=msg.exit_code, error=msg.error,
        winner=winner,
        verdicts=[{
            "child_key": v.child_key, "status": v.status,
            "exit_code": v.exit_code, "attempts": v.attempts,
            "error": v.error,
        } for v in msg.verdicts])
