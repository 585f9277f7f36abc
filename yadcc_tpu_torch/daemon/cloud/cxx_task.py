"""Servant-side C++ compilation task (a copy of the JAX package's
yadcc_tpu/daemon/cloud/cxx_task.py).

Parity with reference yadcc/daemon/cloud/remote_task/cxx_compilation_task
.{h,cc} and remote_task.{h,cc}:

* Prepare (:151-194): decompress the attached preprocessed source,
  digest it, scan for timestamp macros (__TIME__/__DATE__/__TIMESTAMP__)
  that make results uncacheable unless -D-overridden (:46-76), create a
  LENGTH-PADDED workspace directory and assemble the command line with
  the servant's own output path.
* Completion (:94-140 + remote_task.cc:47-88): collect produced files,
  locate every occurrence of the padded workspace path embedded in them
  (debug info, coverage notes) and report the byte regions as patch
  locations so the *client* can splice in its real path — which is why
  the workspace path is padded: any shorter client path fits in place.
* On success, pack a cache entry and fill the distributed cache
  asynchronously.

The compile itself is `sh -c "<compiler> <args> -o <ws>/output.o <src>"`
with no network or shared state — pure subprocess work.
"""

from __future__ import annotations

import os
import shlex
import threading
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ...common import compress
from ...common.cacheability import scan_source_cacheability
from ...common.payload import Payload
from .. import cache_format
from ..cache_format import CacheEntry, get_cache_key
from ..task_digest import get_cxx_task_digest
from .execution_engine import TaskOutput
from .temporary import TemporaryDir

# The workspace path is padded to this length so any client path of sane
# length can be patched over it (reference pads to PATH_MAX; 224 keeps
# paths well under common 255-byte component limits while still covering
# realistic client paths).
_PADDED_WORKSPACE_LEN = 224


class _PackExecutor:
    """Lazy shared thread pool for servant output packing.

    One small pool per process, shared by every completing task: a TU
    producing several outputs (.o + .gcno + .su under --coverage /
    -fstack-usage) compresses them concurrently instead of serially on
    the waiter thread, and the cache-entry pack overlaps workspace
    cleanup.  Sized small — compression is CPU work and the compile
    subprocesses own most of the machine."""

    def __init__(self, max_workers: int = 4):
        self._max_workers = max_workers
        self._lock = threading.Lock()
        self._pool: Optional[ThreadPoolExecutor] = None  # guarded by: self._lock

    def get(self) -> ThreadPoolExecutor:
        with self._lock:
            if self._pool is None:
                self._pool = ThreadPoolExecutor(
                    max_workers=self._max_workers,
                    thread_name_prefix="output-pack")
            return self._pool

    def shutdown(self) -> None:
        """Join the pool's threads (a servant's stop); the next task
        starts a fresh pool."""
        with self._lock:
            pool, self._pool = self._pool, None
        if pool is not None:
            pool.shutdown(wait=True)


_PACK_EXECUTOR = _PackExecutor()


def _decompress_and_digest(data) -> Tuple[bytes, str]:  # ytpu: sanitizes(size-cap, digest)
    """Module-level seam: the fused single-pass source intake (swapped
    for the two-pass legacy path in tools/dataplane_bench.py's A/B)."""
    return compress.decompress_and_digest(data)


def shutdown_pack_executor() -> None:
    """Join the shared pack pool's threads (the servant's stop)."""
    _PACK_EXECUTOR.shutdown()


def _pack_one_output(content: bytes, needle: bytes) -> Tuple[
        List[Tuple[int, int, bytes]], bytes]:
    """(patch locations, compressed content) for one produced file —
    the unit of work fanned out on the shared pack executor."""
    return find_patch_locations(content, needle), compress.compress(content)


def find_patch_locations(
    data: bytes, needle: bytes
) -> List[Tuple[int, int, bytes]]:
    """All (position, total_size, suffix_to_keep) regions where `needle`
    (the padded workspace path) is embedded in `data`.

    A region runs from the needle's start to the NUL terminating the
    embedded string (debug path strings are NUL-terminated); the suffix
    is whatever followed the workspace path (e.g. b"/src.cc").  The
    client overwrites the region with <client_dir> + suffix + NUL pad.
    """
    out = []
    start = 0
    while True:
        pos = data.find(needle, start)
        if pos < 0:
            break
        end = data.find(b"\x00", pos)
        if end < 0:
            end = len(data)
        suffix = data[pos + len(needle) : end]
        out.append((pos, end - pos, suffix))
        start = pos + 1
    return out


@dataclass
class CloudCxxCompilationTask:
    compiler_path: str
    compiler_digest: str
    invocation_arguments: str
    source_path: str          # client-side path, for diagnostics
    temp_root: str
    disallow_cache_fill: bool = False
    ignore_timestamp_macros: bool = False
    # Tenant cache domain (env_desc.tenant_scope, doc/tenancy.md): the
    # servant's cache fill must land in the SUBMITTING tenant's
    # namespace; "" = legacy shared domain.
    tenant_scope: str = ""

    source: bytes = b""
    source_digest: str = ""
    cacheable: bool = True
    workspace: Optional[TemporaryDir] = None
    cmdline: str = ""
    _source_ext: str = field(default=".ii", init=False)

    # -- prepare -------------------------------------------------------------

    def prepare(self, compressed_source: bytes) -> None:  # ytpu: acquires(workspace)
        # Fused single pass: each decompressed piece is digested as it
        # is produced, instead of materializing the source and then
        # re-scanning all of it for the digest (the attachment arrives
        # as a view into the RPC frame — no copy on the way in either).
        try:
            src, self.source_digest = _decompress_and_digest(
                compressed_source)
        except (compress.CompressionError, MemoryError, ValueError):
            # zstd, or the zlib frames of a host without the zstd wheel
            # (common/_zlib_frames.py): whichever compress.py speaks.
            raise ValueError("source attachment is not valid zstd")
        self.source = src
        self.cacheable = (not self.disallow_cache_fill) and (
            self.ignore_timestamp_macros
            or scan_source_cacheability(src, self.invocation_arguments))

        self.workspace = TemporaryDir(self.temp_root, "cxx_")
        # Pad the workspace path by extending the directory name.
        pad_needed = _PADDED_WORKSPACE_LEN - len(self.workspace.path)
        if pad_needed > 0:
            padded = self.workspace.path + "p" * pad_needed
            os.rename(self.workspace.path, padded)
            self.workspace.path = padded

        # The attachment is already-preprocessed source; tell the
        # compiler so via -x …-cpp-output (when the client preprocessed
        # with -fdirectives-only, it keeps "-fpreprocessed
        # -fdirectives-only" in the forwarded arguments).  Suffix check
        # is case-SENSITIVE: 'Foo.C' is C++ by GCC convention.
        language = "c" if self.source_path.endswith((".c", ".i")) else "c++"
        self._source_ext = ".i" if language == "c" else ".ii"
        src_file = f"{self.workspace.path}/src{self._source_ext}"
        with open(src_file, "wb") as fp:
            fp.write(src)
        self.cmdline = (
            f"{shlex.quote(self.compiler_path)} "
            f"-x {language}-cpp-output "
            f"{self.invocation_arguments} -c "
            f"-o {shlex.quote(self.workspace.path + '/output.o')} "
            f"{shlex.quote(src_file)}"
        )

    @property
    def task_digest(self) -> str:
        return get_cxx_task_digest(self.compiler_digest,
                                   self.invocation_arguments,
                                   self.source_digest)

    @property
    def cache_key(self) -> str:
        return get_cache_key(self.compiler_digest,
                             self.invocation_arguments,
                             self.source_digest,
                             tenant_secret=self.tenant_scope)

    # -- completion ----------------------------------------------------------

    def collect_outputs(self, output: TaskOutput) -> Tuple[
        Dict[str, bytes],
        Dict[str, List[Tuple[int, int, bytes]]],
        Optional[Payload],
    ]:
        """(compressed files by extension, patch locations by extension,
        cache-entry payload or None).  Cleans up the workspace.

        Per-file patch-scan + compression fans out on the shared pack
        executor (a --coverage TU's .o/.gcno/.su pack in parallel); the
        cache-entry pack runs there too, overlapping workspace removal.
        The entry is a gather Payload sharing the compressed file
        buffers — the servant never flattens it (the cache-fill RPC
        joins it once at the socket)."""
        assert self.workspace is not None
        try:
            files: Dict[str, bytes] = {}
            patches: Dict[str, List[Tuple[int, int, bytes]]] = {}
            needle = self.workspace.path.encode()
            if output.exit_code == 0:
                pool = _PACK_EXECUTOR.get()
                jobs = []
                for rel, content in \
                        self.workspace.read_all_files().items():
                    if rel == f"src{self._source_ext}":
                        continue  # the input, not a product
                    ext = "." + rel.split(".", 1)[1] if "." in rel else rel
                    jobs.append((ext, pool.submit(_pack_one_output,
                                                  content, needle)))
                for ext, fut in jobs:
                    locs, compressed = fut.result()
                    if locs:
                        patches[ext] = locs
                    files[ext] = compressed
            entry_future = None
            if output.exit_code == 0 and self.cacheable:
                entry_future = _PACK_EXECUTOR.get().submit(
                    cache_format.write_cache_entry_payload, CacheEntry(
                        exit_code=output.exit_code,
                        standard_output=output.standard_output,
                        standard_error=output.standard_error,
                        files=files,
                        patches=patches,
                    ))
            return files, patches, (entry_future.result()
                                    if entry_future is not None else None)
        finally:
            # A pack failure (pool shutdown mid-stop, compressor error)
            # must still reclaim the RAM-backed workspace — the waiter
            # thread reports the exception, nothing retries this task.
            self.workspace.remove()
