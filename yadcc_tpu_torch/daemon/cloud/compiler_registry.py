"""Compiler discovery and digesting (a copy of the JAX package's
yadcc_tpu/daemon/cloud/compiler_registry.py).

Parity with reference yadcc/daemon/cloud/compiler_registry.cc:44-166:
scan PATH plus configured extra dirs every 60s for gcc/g++/clang/clang++
binaries, skip build-accelerator wrappers (ccache/distcc/icecc/ytpu
symlinks — executing one of those from a servant would recurse), digest
each real binary, and serve digest -> path lookups for incoming tasks.
"""

from __future__ import annotations

import os
import threading
from pathlib import Path
from typing import Dict, List, Optional, Sequence

from ...common.hashing import digest_file
from ...utils.logging import get_logger

logger = get_logger("daemon.compiler_registry")

_COMPILER_NAMES = ("gcc", "g++", "clang", "clang++", "cc", "c++")
_WRAPPER_MARKERS = ("ccache", "distcc", "icecc", "ytpu", "yadcc")


# RHEL devtoolset roots the reference probes unconditionally
# (compiler_registry.cc:224-230), each devtoolset-N bin directory.
_DEVTOOLSET_FMT = os.path.join(os.sep, "opt", "rh", "devtoolset-{}", "root",
                               "bin")


class CompilerRegistry:
    def __init__(self, extra_dirs: Sequence[str] = (),
                 bundle_dirs: Sequence[str] = ()):
        """bundle_dirs: parent directories holding whole toolchain
        bundles; every `<bundle>/*/bin` is scanned like a PATH entry
        (reference --extra_compiler_bundle_dirs,
        compiler_registry.cc:51-56,210-222)."""
        self._extra_dirs = list(extra_dirs)
        self._bundle_dirs = list(bundle_dirs)
        self._lock = threading.Lock()
        self._by_digest: Dict[str, str] = {}  # guarded by: self._lock
        # (real, size, mtime) -> digest
        self._digest_memo: Dict[tuple, str] = {}  # guarded by: self._lock
        self.rescan()

    # -- queries -------------------------------------------------------------

    def try_get_compiler_path(self, digest: str) -> Optional[str]:
        with self._lock:
            return self._by_digest.get(digest)

    def environments(self) -> List[str]:
        with self._lock:
            return sorted(self._by_digest)

    # -- scanning ------------------------------------------------------------

    def rescan(self) -> None:
        """60s-cadence timer body."""
        dirs = os.environ.get("PATH", "").split(os.pathsep) + self._extra_dirs
        dirs += self._enumerate_bundle_bins()
        found: Dict[str, str] = {}
        memo_live = set()
        for d in dirs:
            if not d:
                continue
            for name in _COMPILER_NAMES:
                p = Path(d) / name
                real = self._resolve_usable(p)
                if real is None:
                    continue
                try:
                    st = os.stat(real)
                    memo_key = (real, st.st_size, int(st.st_mtime))
                    with self._lock:
                        digest = self._digest_memo.get(memo_key)
                    if digest is None:
                        digest = digest_file(real)
                        with self._lock:
                            self._digest_memo[memo_key] = digest
                except OSError:
                    continue
                memo_live.add(memo_key)
                found.setdefault(digest, str(p))
        with self._lock:
            added = set(found) - set(self._by_digest)
            self._by_digest = found
            # Self-clean the digest memo: entries for file versions no
            # longer on disk (toolchain upgrades bump mtime/size every
            # rescan) would otherwise accumulate for the daemon's
            # lifetime.
            self._digest_memo = {k: v for k, v in
                                 self._digest_memo.items()
                                 if k in memo_live}
        for digest in added:
            logger.info("registered compiler %s (%s)", found[digest],
                        digest[:16])

    def _enumerate_bundle_bins(self) -> List[str]:
        """`<bundle>/*/bin` for every configured bundle dir, plus the
        reference's unconditional RHEL devtoolset ladder.  Non-dirs and
        unreadable entries are skipped silently, like the reference."""
        out: List[str] = []
        for bundle in self._bundle_dirs:
            try:
                subdirs = sorted(os.listdir(bundle))
            except OSError:
                continue
            for sub in subdirs:
                d = os.path.join(bundle, sub, "bin")
                if os.path.isdir(d):
                    out.append(d)
        for i in range(1, 100):
            d = _DEVTOOLSET_FMT.format(i)
            if os.path.isdir(d):
                out.append(d)
        return out

    @staticmethod
    def _resolve_usable(p: Path) -> Optional[str]:
        """Real path of a usable compiler binary; None for wrappers,
        broken symlinks, and non-executables."""
        try:
            if not p.exists() or not os.access(p, os.X_OK):
                return None
            real = p.resolve(strict=True)
        except OSError:
            return None
        # Wrapper detection matches the BASENAME only (reference
        # IsCompilerWrapper uses EndsWith): a bundle installed under a
        # directory named after the project must not disqualify every
        # compiler inside it.
        if any(m in real.name.lower() for m in _WRAPPER_MARKERS):
            return None
        # A symlink chain passing through a wrapper name also disqualifies.
        hop = p
        for _ in range(16):
            if any(m in hop.name.lower() for m in _WRAPPER_MARKERS):
                return None
            if not hop.is_symlink():
                break
            hop = hop.parent / os.readlink(hop)
        return str(real)
