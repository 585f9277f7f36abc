"""Task-type registry: route / task-kind -> DistributedTask wiring (a
copy of the JAX package's yadcc_tpu/daemon/local/task_registry.py: the
cxx, jit, aot and autotune rows, whose routes, messages and error bodies
are the JAX package's byte for byte).

Each task kind contributes one ``TaskType`` row — routes, request
classes, the factory that turns a parsed submission into a
DistributedTask, and the wait-response shaper — and the HTTP layer
drives every kind through the same generic submit/wait flow.

All submit routes share the wire shape (multi-chunk [JSON, attachment])
and all wait routes share the long-poll semantics (503 running, 404
unknown, 200 multi-chunk [JSON, output chunks...]); what varies is the
message vocabulary and the task construction — exactly what a TaskType
captures.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

from ... import api
from ...common import compress
from .aot_task import make_aot_task
from .autotune_task import WINNER_RECORD_KEY, make_autotune_task
from .cxx_task import NeedCompilerDigest, make_cxx_task
from .distributed_task import DistributedTask, TaskResult
from .jit_task import NeedJitEnvironment, make_jit_task


@dataclass(frozen=True)
class TaskType:
    kind: str
    submit_route: str
    wait_route: str
    submit_request_cls: type
    wait_request_cls: type
    # (parsed submit message, attachment view) -> task; may raise —
    # exceptions are mapped to HTTP 400 via `submit_error`.
    make_task: Callable[[object, bytes], DistributedTask]
    # result -> (wait-response proto message, ordered output chunks).
    build_wait_response: Callable[[TaskResult], Tuple[object, List[bytes]]]
    # Known-bad-submission mapper: exception -> 400 body, or None to
    # treat the exception as an internal error (HTTP 500).
    submit_error: Callable[[Exception], Optional[bytes]]
    # 400 body when the multi-chunk framing is missing/miscounted.
    bad_chunks_error: bytes


class TaskTypeRegistry:
    """Immutable-after-construction lookup tables; no locking needed —
    built once at service construction, read-only afterwards."""

    def __init__(self, types: List[TaskType]):
        self._by_submit: Dict[str, TaskType] = {}
        self._by_wait: Dict[str, TaskType] = {}
        for t in types:
            if t.submit_route in self._by_submit or \
                    t.wait_route in self._by_wait:
                raise ValueError(f"duplicate route for kind {t.kind!r}")
            self._by_submit[t.submit_route] = t
            self._by_wait[t.wait_route] = t

    def for_submit(self, path: str) -> Optional[TaskType]:
        return self._by_submit.get(path)

    def for_wait(self, path: str) -> Optional[TaskType]:
        return self._by_wait.get(path)

    def kinds(self) -> List[str]:
        return sorted(t.kind for t in self._by_submit.values())


# -- the two workloads -------------------------------------------------------


def _cxx_wait_response(result: TaskResult) -> Tuple[object, List[bytes]]:
    resp = api.local.WaitForCxxTaskResponse(
        exit_code=result.exit_code,
        output=result.standard_output.decode(errors="replace"),
        error=result.standard_error.decode(errors="replace"),
    )
    chunks: List[bytes] = []
    for key in sorted(result.files):
        resp.file_extensions.append(key)
        pl = resp.patches.add(file_key=key)
        for pos, total, suffix in result.patches.get(key, []):
            pl.locations.add(position=pos, total_size=total,
                             suffix_to_keep=suffix)
        chunks.append(result.files[key])
    return resp, chunks


def _cxx_submit_error(e: Exception) -> Optional[bytes]:
    if isinstance(e, NeedCompilerDigest):
        return (b'{"error":"compiler digest unknown; '
                b'set_file_digest first"}')
    return None


def _jit_wait_response(result: TaskResult) -> Tuple[object, List[bytes]]:
    resp = api.jit.WaitForJitTaskResponse(
        exit_code=result.exit_code,
        output=result.standard_output.decode(errors="replace"),
        error=result.standard_error.decode(errors="replace"),
    )
    chunks: List[bytes] = []
    for key in sorted(result.files):
        resp.artifact_keys.append(key)
        chunks.append(result.files[key])
    return resp, chunks


def _jit_submit_error(e: Exception) -> Optional[bytes]:
    if isinstance(e, NeedJitEnvironment):
        return (b'{"error":"jit environment unknown; supply backend '
                b'and jaxlib_version"}')
    if isinstance(e, ValueError):
        return b'{"error":"invalid jit submission"}'
    return None


def _fanout_verdicts_into(resp, result: TaskResult) -> None:
    for v in result.verdicts:
        resp.verdicts.add(child_key=v.child_key, status=v.status,
                          exit_code=v.exit_code, attempts=v.attempts,
                          error=v.error)


def _aot_wait_response(result: TaskResult) -> Tuple[object, List[bytes]]:
    resp = api.fanout.WaitForAotTaskResponse(
        exit_code=result.exit_code,
        output=result.standard_output.decode(errors="replace"),
        error=result.standard_error.decode(errors="replace"),
    )
    _fanout_verdicts_into(resp, result)
    chunks: List[bytes] = []
    for key in sorted(result.files):
        resp.artifact_keys.append(key)
        chunks.append(result.files[key])
    return resp, chunks


def _autotune_wait_response(result: TaskResult
                            ) -> Tuple[object, List[bytes]]:
    resp = api.fanout.WaitForAutotuneTaskResponse(
        exit_code=result.exit_code,
        output=result.standard_output.decode(errors="replace"),
        error=result.standard_error.decode(errors="replace"),
    )
    _fanout_verdicts_into(resp, result)
    winner = result.files.get(WINNER_RECORD_KEY)
    if winner is not None:
        raw = compress.try_decompress(bytes(winner))
        if raw is not None:
            resp.winner_config_json = raw.decode(errors="replace")
    chunks: List[bytes] = []
    for key in sorted(result.files):
        resp.artifact_keys.append(key)
        chunks.append(result.files[key])
    return resp, chunks


def _fanout_submit_error(e: Exception) -> Optional[bytes]:
    if isinstance(e, NeedJitEnvironment):
        return (b'{"error":"jit environment unknown; supply backend '
                b'and jaxlib_version"}')
    if isinstance(e, ValueError):
        return b'{"error":"invalid fan-out submission"}'
    return None


def default_registry(digest_cache) -> TaskTypeRegistry:
    """The production registry: cxx (compiler digests resolved through
    the FileDigestCache) + jit + the two fan-out kinds (aot multi-
    topology builds, autotune sweeps — doc/workloads.md)."""
    return TaskTypeRegistry([
        TaskType(
            kind="cxx",
            submit_route="/local/submit_cxx_task",
            wait_route="/local/wait_for_cxx_task",
            submit_request_cls=api.local.SubmitCxxTaskRequest,
            wait_request_cls=api.local.WaitForCxxTaskRequest,
            make_task=lambda msg, att: make_cxx_task(
                msg, att, digest_cache),
            build_wait_response=_cxx_wait_response,
            submit_error=_cxx_submit_error,
            bad_chunks_error=b'{"error":"expect json+source chunks"}',
        ),
        TaskType(
            kind="jit",
            submit_route="/local/submit_jit_task",
            wait_route="/local/wait_for_jit_task",
            submit_request_cls=api.jit.SubmitJitTaskRequest,
            wait_request_cls=api.jit.WaitForJitTaskRequest,
            make_task=lambda msg, att: make_jit_task(msg, att),
            build_wait_response=_jit_wait_response,
            submit_error=_jit_submit_error,
            bad_chunks_error=b'{"error":"expect json+stablehlo chunks"}',
        ),
        TaskType(
            kind="aot",
            submit_route="/local/submit_aot_task",
            wait_route="/local/wait_for_aot_task",
            submit_request_cls=api.fanout.SubmitAotTaskRequest,
            wait_request_cls=api.fanout.WaitForAotTaskRequest,
            make_task=lambda msg, att: make_aot_task(msg, att),
            build_wait_response=_aot_wait_response,
            submit_error=_fanout_submit_error,
            bad_chunks_error=b'{"error":"expect json+stablehlo chunks"}',
        ),
        TaskType(
            kind="autotune",
            submit_route="/local/submit_autotune_task",
            wait_route="/local/wait_for_autotune_task",
            submit_request_cls=api.fanout.SubmitAutotuneTaskRequest,
            wait_request_cls=api.fanout.WaitForAutotuneTaskRequest,
            make_task=lambda msg, att: make_autotune_task(msg, att),
            build_wait_response=_autotune_wait_response,
            submit_error=_fanout_submit_error,
            bad_chunks_error=b'{"error":"expect json+kernel chunks"}',
        ),
    ])
