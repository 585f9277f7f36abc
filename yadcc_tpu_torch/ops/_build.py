"""Build and load the port's CUDA kernels from the sources in the checkout.

Each kernel source under ``csrc/`` is compiled by ``nvcc`` for ``sm_90a``
into a shared library with a plain C interface, at first use, into
``yadcc_tpu_torch/_build/`` (listed in .gitignore).  The library's file
name carries a hash of its source and of the headers beside it, so an
edited source or header rebuilds, and two
processes compiling at once (the smoke script and the scheduler it starts)
never load a half-written file: each writes a private temporary name and
renames into place.  A failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
# Seconds spent in nvcc by this process, per source (0.0 when the
# library was already built).
build_seconds: Dict[str, float] = {}


def find_nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin)")


def library_path(source: str) -> Path:
    # The headers under csrc/ are hashed with every source, so an edited
    # header rebuilds whatever may include it.
    src = (CSRC_DIR / source).read_bytes() + b"".join(
        h.read_bytes() for h in sorted(CSRC_DIR.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{Path(source).stem}_{digest[:12]}.so"


def source_bytes(source: str) -> bytes:
    """``csrc/<source>`` with each ``#include "x.cuh"`` of a header beside
    it replaced by the header's text: one self-contained translation unit,
    for a compiler that sees only the bytes it is sent (the jit compile
    farm).  The local build compiles the same text from the file."""
    out = []
    for line in (CSRC_DIR / source).read_bytes().splitlines(keepends=True):
        m = re.match(rb'\s*#include\s+"([A-Za-z0-9_.]+\.cuh)"', line)
        if m and (CSRC_DIR / m.group(1).decode()).exists():
            out.append(source_bytes(m.group(1).decode()).replace(
                b"#pragma once\n", b""))
        else:
            out.append(line)
    return b"".join(out)


def build(source: str) -> Path:
    """Compile ``csrc/<source>`` unless its library is already built."""
    out = library_path(source)
    if out.exists():
        build_seconds.setdefault(source, 0.0)
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".tmp{os.getpid()}.so")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / source)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed for {source} (rc {proc.returncode}):\n"
            f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, out)
    build_seconds[source] = time.perf_counter() - t0
    return out


def load(source: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<source>``, built on first use."""
    with _lock:
        lib = _loaded.get(source)
        if lib is None:
            lib = ctypes.CDLL(str(build(source)))
            _loaded[source] = lib
        return lib
