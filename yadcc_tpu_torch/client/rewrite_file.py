"""Local preprocessing: one pass produces compressed source + digest (a
copy of the JAX package's yadcc_tpu/client/rewrite_file.py).

Parity with reference yadcc/client/cxx/rewrite_file.cc:75-182: run
`<compiler> -E -fdirectives-only -fno-working-directory` (directives-only
preprocessing is ~4x faster and keeps macros unexpanded for better cache
hits), streaming stdout simultaneously into the compressor and the
content digest; fall back to plain -E when the compiler rejects
-fdirectives-only.  When the port's fakeroot preload library
(libytpufakeroot.so, which tools/install_client.py builds from
native/fakeroot.c beside the native client in _build/native/<frames>/)
is present it
is injected so compiler-install-dependent include paths in linemarkers
become machine-independent (higher cache hit rates across hosts); when
it is missing or the dynamic linker refuses it, preprocessing runs
without it and the client says so once (at INFO).

The preprocessor's stderr is held back: a successful run's passes
through, a failed run's is dropped, since the caller then compiles
locally and the compiler prints the real diagnostics once (the JAX
client passes every attempt's through, so a failing TU's errors appear
three times).
"""

from __future__ import annotations

import os
import sys
import tempfile
from dataclasses import dataclass
from typing import List, Optional, Tuple

from ..common import cacheability
from ..common.compress import CompressingWriter, TeeWriter
from ..common.hashing import DigestingWriter
from ..common.payload import Payload
from . import logging as log
from .command import execute_command
from .compiler_args import CompilerArgs

# What the dynamic linker prints when it cannot load an LD_PRELOAD
# object; the process goes on without it.
_PRELOAD_REFUSED = b"cannot be preloaded"
_shim_noted = False


@dataclass
class RewriteResult:
    # Chunked payload of the compressor's output blocks, exactly as they
    # streamed out of the preprocess pipe — handed segment-for-segment
    # to the submit framing; nothing joins them before the socket.
    compressed_source: Payload
    source_digest: str
    uncompressed_size: int
    directives_only: bool  # servant must compile with matching flags
    # Macros (bytes) found in the preprocessed output; whether they
    # actually block caching also depends on -D overrides
    # (common/cacheability.blocking_macros).
    timestamp_macros_found: frozenset = frozenset()


class _Collector:
    def __init__(self):
        self.chunks: List[bytes] = []

    def write(self, data: bytes) -> int:
        self.chunks.append(data)
        return len(data)


class _TimestampScanWriter:
    """Streaming scan for the cache-poisoning macros, keeping a small
    tail so a token straddling two chunks is still found (feeds the
    YTPU_WARN_ON_NONCACHEABLE diagnostic; the servant independently
    applies the same shared rule — common/cacheability.py — before
    filling the cache)."""

    def __init__(self):
        self.found: set = set()
        self._tail = b""

    def write(self, data: bytes) -> int:
        if len(self.found) < len(cacheability.TIMESTAMP_MACROS):
            window = self._tail + data
            for m in cacheability.TIMESTAMP_MACROS:
                if m in window:
                    self.found.add(m)
            self._tail = window[-15:]  # longest token minus one
        return len(data)


def _note_shim(msg: str) -> None:
    global _shim_noted
    if not _shim_noted:
        _shim_noted = True
        log.info(msg)


def _fakeroot_path() -> Optional[str]:
    """The LD_PRELOAD shim the installer built beside the native client
    (the same for either frames); optional.  The native client preloads
    the one beside it, so with both clients on a host their preprocessed
    bytes, and so their cache keys, agree."""
    build = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "_build", "native")
    for frames in ("zstd", "zlib"):
        cand = os.path.join(build, frames, "libytpufakeroot.so")
        if os.path.exists(cand):
            return cand
    _note_shim(f"no fakeroot shim under {build}; preprocessing without it")
    return None


def _run_preprocess(compiler: str, tail: List[str]
                    ) -> Tuple[Optional[RewriteResult], bytes]:
    """(the result, or None when the preprocessor failed; its stderr)."""
    collector = _Collector()
    digester = DigestingWriter()
    zw = CompressingWriter(collector)
    ts_scan = _TimestampScanWriter()
    sink = TeeWriter(digester, zw, ts_scan)
    env = {}
    preload = _fakeroot_path()
    if preload:
        env["LD_PRELOAD"] = preload
        env["YTPU_INTERNAL_COMPILER_PATH"] = os.path.dirname(
            os.path.dirname(os.path.realpath(compiler)))
    with tempfile.TemporaryFile() as err:
        rc = execute_command([compiler] + tail, sink=sink, env=env or None,
                             stderr=err)
        err.seek(0)
        diagnostics = err.read()
    if preload and _PRELOAD_REFUSED in diagnostics:
        diagnostics = b"".join(
            line for line in diagnostics.splitlines(True)
            if _PRELOAD_REFUSED not in line)
        _note_shim(f"the dynamic linker refused the fakeroot shim "
                   f"{preload}; preprocessed without it")
    if rc != 0:
        return None, diagnostics
    zw.close()
    return RewriteResult(
        compressed_source=Payload(collector.chunks),
        source_digest=digester.hexdigest(),
        uncompressed_size=digester.bytes_written,
        directives_only=False,  # caller fills in
        timestamp_macros_found=frozenset(ts_scan.found),
    ), diagnostics


def rewrite_file(args: CompilerArgs, compiler_path: str
                 ) -> Optional[RewriteResult]:
    """None when even plain -E fails (the caller falls back to local
    compilation, which prints the real diagnostics)."""
    base = args.rewrite(
        remove=["-c"],
        remove_prefix=["-o"],
        add=[],
        keep_sources=True,
    )
    fast = ["-E", "-fdirectives-only", "-fno-working-directory"] + base
    result, diagnostics = _run_preprocess(compiler_path, fast)
    if result is not None:
        result.directives_only = True
    else:
        log.info("-fdirectives-only failed; retrying with plain -E")
        slow = ["-E", "-fno-working-directory"] + base
        result, diagnostics = _run_preprocess(compiler_path, slow)
    if result is not None and diagnostics:
        sys.stderr.write(diagnostics.decode("utf-8", "replace"))
        sys.stderr.flush()
    return result
