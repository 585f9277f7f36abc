"""Client side of the jit workload: submit a ``.cu`` source to the local
daemon, long-poll for the library, fall back to a local nvcc build (the
port's counterpart of the JAX package's yadcc_tpu/jit/frontend.py).

Pure bytes in, bytes out, and no torch: a build's offload decision must
not pay a torch import.  Protocol (the JAX package's routes and
messages; the version rides the wire field ``jaxlib_version``):

    POST /local/submit_jit_task    multi-chunk [json, compressed source]
         400 -> fix the submission (this client always sends its
                environment, so a 400 means the submission itself is
                malformed: no retry)
    POST /local/wait_for_jit_task  503 running (long-poll again),
                                   404 unknown id,
                                   200 multi-chunk [json, artifacts...]

Every knob is an environment variable (YTPU_JIT_*,
client/env_options.py).  ``build_library`` is the convenience a program
calls: the library for a source, from the farm when it can, written
under yadcc_tpu_torch/_build/ and loaded with ctypes by the caller.
"""

from __future__ import annotations

import os
import pathlib
import tempfile
import threading
from dataclasses import dataclass, field
from typing import Dict, Optional

from google.protobuf import json_format

from .. import api
from ..client import env_options
from ..client.daemon_call import call_daemon
from ..common import compress, multi_chunk
from ..common.hashing import digest_bytes, digest_keyed
from ..utils.logging import get_logger
from .env import BACKEND, local_jit_environment

logger = get_logger("jit.frontend")

# One long-poll leg; the overall budget is YTPU_JIT_TIMEOUT_S.
_WAIT_LEG_MS = 2000
ARTIFACT_KEY = ".xla"   # the JAX package's key; here it names a library
BUILD_DIR = pathlib.Path(__file__).resolve().parent.parent / "_build"


@dataclass
class OffloadOutcome:
    """What came back from the cluster for one source.

    ``ok`` False is an infrastructure outcome (daemon unreachable, no
    capacity, timeout: the caller may build locally); ``ok`` True with a
    non-zero ``exit_code`` is a build failure, which would fail locally
    too, with the worker's diagnostics in ``error``.  ``output`` is the
    worker's output line (nvcc's seconds and peak RSS on the servant)."""

    ok: bool
    exit_code: int = -1
    error: str = ""
    output: str = ""
    # artifact key (".xla" = the library) -> raw bytes.
    artifacts: Dict[str, bytes] = field(default_factory=dict)

    @property
    def library(self) -> Optional[bytes]:
        """The library's bytes, when the build succeeded."""
        if self.ok and self.exit_code == 0:
            return self.artifacts.get(ARTIFACT_KEY)
        return None


def offload_compile(
    source: bytes,
    *,
    compile_options: bytes = b"",
    backend: str = BACKEND,
    toolchain_version: Optional[str] = None,
    cache_control: Optional[int] = None,
    timeout_s: Optional[float] = None,
) -> OffloadOutcome:
    """Submit one ``.cu`` source for a remote build; blocks until the
    artifact, a failure or the timeout."""
    if not env_options.jit_offload_enabled():
        return OffloadOutcome(ok=False, error="offload disabled")
    if toolchain_version is None:
        toolchain_version = local_jit_environment(backend).toolchain_version
    if not toolchain_version:
        return OffloadOutcome(ok=False, error="no local nvcc version")
    if timeout_s is None:
        timeout_s = env_options.jit_timeout_s()

    req = api.jit.SubmitJitTaskRequest(
        requestor_process_id=os.getpid(),
        computation_digest=digest_bytes(source),
        compile_options=bytes(compile_options),
        backend=backend,
        jaxlib_version=toolchain_version,
        cache_control=(env_options.cache_control()
                       if cache_control is None else cache_control),
    )
    body = multi_chunk.make_multi_chunk_payload([
        json_format.MessageToJson(req).encode(),
        compress.compress(source),
    ])
    resp = call_daemon("POST", "/local/submit_jit_task", body)
    if resp.status != 200:
        return OffloadOutcome(
            ok=False, error=f"submit failed: HTTP {resp.status} "
                            f"{resp.body[:200]!r}")
    task_id = json_format.Parse(
        resp.body, api.jit.SubmitJitTaskResponse()).task_id
    return _wait(task_id, timeout_s)


def longpoll_task(route: str, wait_request_cls, response_cls,
                  task_id: int, timeout_s: float):
    """Long-poll one submitted task's wait route to completion; shared by
    the jit, AOT and autotune clients.  Returns ``(msg, chunks, error)``:
    on success msg is the parsed response and chunks the multi-chunk
    body (chunks[0] is the JSON); on an infrastructure failure msg is
    None and error says why."""
    import time

    from ..common.backoff import Backoff

    deadline = time.monotonic() + timeout_s
    # A 503 normally arrives after the full leg; fast 503s (a shedding
    # daemon) pace through the backoff with the daemon's hint.
    backoff = Backoff(initial_s=0.05, max_s=2.0)
    while True:
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            return None, [], f"timed out after {timeout_s}s"
        wreq = wait_request_cls(
            task_id=task_id,
            milliseconds_to_wait=min(_WAIT_LEG_MS,
                                     max(1, int(remaining * 1000))),
        )
        leg_start = time.monotonic()
        resp = call_daemon(
            "POST", route,
            json_format.MessageToJson(wreq).encode(),
            timeout_s=_WAIT_LEG_MS / 1000.0 + 10.0)
        if resp.status == 503:
            if time.monotonic() - leg_start < 0.5:
                backoff.wait(resp.retry_after_s)
            else:
                backoff.reset()  # a real long-poll leg: not a spin
            continue
        if resp.status != 200:
            return None, [], f"wait failed: HTTP {resp.status}"
        chunks = multi_chunk.try_parse_multi_chunk(resp.body)
        if not chunks:
            return None, [], "malformed wait reply"
        msg = json_format.Parse(bytes(chunks[0]), response_cls())
        return msg, chunks, ""


def decompress_artifacts(keys, chunks) -> Optional[Dict[str, bytes]]:
    """key -> raw bytes of a wait reply's artifact chunks; None when one
    is corrupt."""
    artifacts: Dict[str, bytes] = {}
    for key, chunk in zip(keys, chunks):
        data = compress.try_decompress(bytes(chunk))
        if data is None:
            return None
        artifacts[key] = data
    return artifacts


def _wait(task_id: int, timeout_s: float) -> OffloadOutcome:
    msg, chunks, err = longpoll_task(
        "/local/wait_for_jit_task", api.jit.WaitForJitTaskRequest,
        api.jit.WaitForJitTaskResponse, task_id, timeout_s)
    if msg is None:
        return OffloadOutcome(ok=False, error=err)
    if msg.exit_code < 0:
        # Daemon-side infrastructure failure (no grant, servant lost).
        return OffloadOutcome(ok=False, exit_code=msg.exit_code,
                              error=msg.error, output=msg.output)
    artifacts = decompress_artifacts(msg.artifact_keys, chunks[1:])
    if artifacts is None:
        return OffloadOutcome(ok=False, error="corrupt artifact chunk")
    return OffloadOutcome(ok=True, exit_code=msg.exit_code,
                          error=msg.error, output=msg.output,
                          artifacts=artifacts)


@dataclass(frozen=True)
class BuiltLibrary:
    """The library ``build_library`` wrote: its path (``os.fspath`` of
    this object), whether the farm built it, and the farm worker's
    output line ('' for a local build)."""

    path: pathlib.Path
    remote: bool
    output: str = ""

    def __fspath__(self) -> str:
        return str(self.path)


def build_locally(source: bytes, options: bytes = b"") -> bytes:
    """The library nvcc builds here from ``source`` with the worker's own
    argv for ``options``; raises RuntimeError on a build failure."""
    from .compile_worker import BuildError, Builder

    with tempfile.TemporaryDirectory(prefix="ytpu_local_build_") as ws:
        try:
            return Builder(ws).build(
                {"backend": BACKEND,
                 "compile_options_hex": bytes(options).hex()}, source)
        except BuildError as e:
            raise RuntimeError(f"local nvcc build failed: {e}")


def build_library(source: bytes, *, options: bytes = b"",
                  name: str = "farm", backend: str = BACKEND,
                  toolchain_version: Optional[str] = None) -> BuiltLibrary:
    """The shared library for one self-contained ``.cu`` source, built by
    the farm when it can: offloaded, written under
    yadcc_tpu_torch/_build/ (atomically) and returned by path, for the
    caller to load with ctypes (``ctypes.CDLL(os.fspath(lib))``, whose
    RTLD_LOCAL keeps two loaded copies of one library apart).

    A build failure raises RuntimeError with the servant's diagnostics.
    On an infrastructure miss it builds locally with nvcc when
    YTPU_JIT_LOCAL_FALLBACK=1 (the default) and raises otherwise."""
    outcome = offload_compile(source, compile_options=options,
                              backend=backend,
                              toolchain_version=toolchain_version)
    data = outcome.library
    remote = data is not None
    if data is None:
        if outcome.ok and outcome.exit_code != 0:
            raise RuntimeError(f"remote jit build failed (exit "
                               f"{outcome.exit_code}): {outcome.error}")
        if not env_options.jit_local_fallback():
            raise RuntimeError(
                f"jit offload failed and local fallback is disabled: "
                f"{outcome.error}")
        logger.info("jit offload missed (%s): building locally",
                    outcome.error)
        data = build_locally(source, options)
    key = digest_keyed("ytpu-torch-built-library", source, bytes(options))
    path = BUILD_DIR / f"lib{name}_{'farm' if remote else 'local'}_" \
                       f"{key[:16]}.so"
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".tmp{os.getpid()}_{threading.get_ident()}.so")
    tmp.write_bytes(data)
    os.replace(tmp, path)
    return BuiltLibrary(path=path, remote=remote,
                        output=outcome.output if remote else "")
