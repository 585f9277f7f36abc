"""Daemon protocol client: submit, wait, decompress, patch (a copy of the
JAX package's yadcc_tpu/client/compilation_saas.py).

Parity with reference yadcc/client/cxx/compilation_saas.cc: submit the
task as multi-chunk JSON + compressed source (:143-213); when the daemon
answers 400 it doesn't know our compiler — digest it, report via
/local/set_file_digest, retry (:176-194); long-poll wait (:215-290);
decompress outputs and apply byte patches rewriting the servant's padded
workspace path to the client-side path (required for --coverage and
debug builds).
"""

from __future__ import annotations

import base64
import json
import os
import time
from dataclasses import dataclass, field
from typing import Dict, Tuple

from ..common.backoff import Backoff
from ..common.compress import try_decompress
from ..common.hashing import digest_file
from ..common.multi_chunk import (make_multi_chunk_payload,
                                  try_parse_multi_chunk_views)
from . import logging as log
from .compiler_args import CompilerArgs
from .daemon_call import call_daemon


@dataclass
class CloudResult:
    exit_code: int
    standard_output: str
    standard_error: str
    # extension -> decompressed, patched bytes.
    files: Dict[str, bytes] = field(default_factory=dict)


class CloudError(Exception):
    pass


def _file_desc(path: str) -> dict:
    st = os.stat(path)
    return {"path": path, "size": str(st.st_size),
            "timestamp": str(int(st.st_mtime))}


def submit_compilation_task(
    *,
    compiler_path: str,
    source_path: str,
    source_digest: str,
    compressed_source,  # bytes-like or common.payload.Payload
    invocation_arguments: str,
    cache_control: int,
    ignore_timestamp_macros: bool = False,
) -> int:
    """Returns the daemon task id; raises CloudError on failure."""
    msg = {
        "requestor_process_id": os.getpid(),
        "source_path": os.path.abspath(source_path),
        "source_digest": source_digest,
        "compiler_invocation_arguments": invocation_arguments,
        "cache_control": cache_control,
        "ignore_timestamp_macros": ignore_timestamp_macros,
        "compiler": _file_desc(compiler_path),
    }
    # Gather framing: the compressor's output blocks become body
    # segments directly; call_daemon flattens once at the socket.
    body = make_multi_chunk_payload(
        [json.dumps(msg).encode(), compressed_source])
    for attempt in range(2):
        resp = call_daemon("POST", "/local/submit_cxx_task", body,
                           timeout_s=10.0)
        if resp.status == 200:
            return int(json.loads(resp.body)["task_id"])
        if resp.status == 400 and attempt == 0:
            # Daemon can't read our compiler: report its digest, retry
            # (reference compilation_saas.cc:176-194).
            log.info("reporting compiler digest to daemon")
            report = {
                "file_desc": _file_desc(compiler_path),
                "digest": digest_file(compiler_path),
            }
            r = call_daemon("POST", "/local/set_file_digest",
                            json.dumps(report).encode())
            if r.status != 200:
                raise CloudError(f"set_file_digest failed: {r.status}")
            continue
        raise CloudError(f"submit failed: HTTP {resp.status}")
    raise CloudError("submit retries exhausted")


def wait_for_compilation_task(
    task_id: int, timeout_s: float = 900.0
) -> Tuple[CloudResult, dict]:
    """Returns (result, patches): patches maps file key -> raw JSON
    patch-location dicts, consumed by apply_path_patches."""
    deadline = time.monotonic() + timeout_s
    body = json.dumps({"task_id": str(task_id),
                       "milliseconds_to_wait": 2000}).encode()
    # The daemon paces this loop server-side (each 503 already cost a
    # 2s long-poll leg).  A 503 that comes back FAST (a loaded daemon
    # shedding its wait queue) is paced through the shared backoff,
    # honoring any Retry-After the daemon attached.
    backoff = Backoff(initial_s=0.05, max_s=2.0)
    while True:
        if time.monotonic() > deadline:
            raise CloudError("compilation timed out")
        leg_start = time.monotonic()
        resp = call_daemon("POST", "/local/wait_for_cxx_task", body,
                           timeout_s=15.0)
        if resp.status == 503:
            if time.monotonic() - leg_start < 0.5:
                backoff.wait(resp.retry_after_s)
            else:
                backoff.reset()  # a real long-poll leg: not a spin
            continue  # still running
        if resp.status != 200:
            raise CloudError(f"wait failed: HTTP {resp.status}")
        chunks = try_parse_multi_chunk_views(resp.body)
        if not chunks:
            raise CloudError("malformed wait response")
        meta = json.loads(bytes(chunks[0]))
        files: Dict[str, bytes] = {}
        exts = meta.get("file_extensions", [])
        patches = {p["file_key"]: p.get("locations", [])
                   for p in meta.get("patches", [])}
        for ext, blob in zip(exts, chunks[1:]):
            data = try_decompress(blob)
            if data is None:
                raise CloudError(f"corrupt output for {ext}")
            files[ext] = data
        result = CloudResult(
            exit_code=int(meta.get("exit_code", -1)),
            standard_output=meta.get("output", ""),
            standard_error=meta.get("error", ""),
            files=files,
        )
        return result, patches


def apply_path_patches(files: Dict[str, bytes], patches: dict,
                       client_dir: str) -> Dict[str, bytes]:
    """Overwrite each reported region with <client_dir><suffix>, NUL-
    padded to the region length.  A replacement longer than the region
    (pathological client paths) leaves the region untouched — wrong
    paths in debug info beat corrupting the object file."""
    out = dict(files)
    cdir = client_dir.encode().rstrip(b"/")
    for ext, locs in patches.items():
        if ext not in out or not locs:
            continue
        data = bytearray(out[ext])
        for loc in locs:
            pos = int(loc.get("position", 0))
            total = int(loc.get("total_size", 0))
            suffix_raw = loc.get("suffix_to_keep", "")
            suffix = base64.b64decode(suffix_raw) if suffix_raw else b""
            replacement = cdir + suffix
            if len(replacement) > total or pos + total > len(data):
                log.warning(f"patch for {ext} does not fit; skipping")
                continue
            data[pos : pos + total] = replacement.ljust(total, b"\x00")
        out[ext] = bytes(data)
    return out


def write_compilation_results(files: Dict[str, bytes],
                              args: CompilerArgs) -> None:
    """Place outputs where the build system expects them (reference
    yadcc-cxx.cc:92-113): '.o' goes to -o (or <stem>.o), sibling outputs
    (.gcno, .su, ...) land next to it with matching stems."""
    out_path = args.output_file() or "a.o"
    stem = out_path[:-2] if out_path.endswith(".o") else out_path
    for ext, data in files.items():
        target = out_path if ext == ".o" else stem + ext
        with open(target, "wb") as fp:
            fp.write(data)
