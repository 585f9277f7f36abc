"""Task-type registry: route / task-kind -> DistributedTask wiring (a
copy of the JAX package's yadcc_tpu/daemon/local/task_registry.py with
its cxx row only).

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
from .cxx_task import NeedCompilerDigest, make_cxx_task
from .distributed_task import DistributedTask, TaskResult


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


def default_registry(digest_cache) -> TaskTypeRegistry:
    """The production registry: cxx, compiler digests resolved through
    the FileDigestCache."""
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
    ])
