"""The servant's build subprocess: ``nvcc`` for the card (the port's
counterpart of the JAX package's yadcc_tpu/jit/compile_worker.py, which
compiles StableHLO with XLA).

One process per build, launched by the execution engine in its own
process group, so lease expiry or FreeTask SIGKILLs the whole build:
nvcc, cicc, ptxas and the host compiler.  An optional address-space
ceiling (RLIMIT_AS, applied before nvcc starts, so its children inherit
it) keeps a pathological build from taking the servant down.  ``TMPDIR``
is the task's workspace, where nvcc writes its intermediates, so a killed
build leaves nothing behind once the workspace is removed.

Protocol (files in the task's workspace):

    <ws>/request.bin   multi-chunk [options-JSON, payload]
    <ws>/artifact.bin  the artifact (written on success, atomically)

options-JSON:  {"backend": "cuda",
                "compile_options_hex": "<compile options, hex>",
                "mem_limit_bytes": 0}

The payload is one self-contained ``.cu`` source (headers of the CUDA
toolkit and the C/C++ standard library only) and the artifact is what
ops/_build.py builds from such a source: a shared library with a plain C
interface.  The compile options are canonical JSON (``options_json``):

    arch       sm_80 | sm_86 | sm_89 | sm_90 | sm_90a   (default sm_90a)
    std        c++11 | c++14 | c++17 | c++20            (default c++17)
    opt        0-3                                      (default 3)
    defines    {identifier: int or plain string}        (default none)
    fast_math  bool                                     (default false)
    lineinfo   bool                                     (default false)

The worker builds nvcc's argv from these fields alone: it passes on no
flag the client wrote and never goes through a shell.  Empty options
give exactly ops/_build.NVCC_FLAGS, so a farm-built library and a local
build are interchangeable.  An unknown field or value is a build failure
(exit 1 with a diagnostic), deterministic like a compile error.

Two fan-out extensions share the protocol:

  * AOT topology children add ``"mesh_shape": [2, 2], "device_count":
    4``: the source gets YTPU_DEVICE_COUNT 4 and YTPU_MESH_SHAPE 2,2
    (-DYTPU_DEVICE_COUNT=4 -DYTPU_MESH_SHAPE=2\\,2: nvcc splits option
    values at unescaped commas), the counterpart of the JAX worker's
    num_partitions, and the topology's own compile options may name its
    ``arch``;
  * autotune sweeps add ``"autotune_configs": [{...}, ...]``: the payload
    is a ``.cu`` template whose ``{key}`` placeholders are filled from
    each config, every config is built, and artifact.bin holds the
    winning-config RECORD (JSON: config, score, metric, evaluated).  In
    real mode the score is minus nvcc's wall time.

Exit codes: 0 success, 1 build or setup failure (diagnostics on stderr).
``--fake`` (YTPU_JIT_FAKE_WORKER=1 on the servant) skips nvcc and writes
a deterministic pseudo-artifact derived from the request; its artifact,
its scores and its output line are byte-equal to the JAX package's fake
worker's for the same request, which is what the CPU tests hold the two
packages to.

This module imports no torch and nothing of ops/ but _build's flags.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time
from typing import List, Tuple

ARCHS = ("sm_80", "sm_86", "sm_89", "sm_90", "sm_90a")
STDS = ("c++11", "c++14", "c++17", "c++20")
DEFAULTS = {"arch": "sm_90a", "std": "c++17", "opt": 3, "defines": {},
            "fast_math": False, "lineinfo": False}
TOPOLOGY_MACROS = ("YTPU_DEVICE_COUNT", "YTPU_MESH_SHAPE")
_IDENT = re.compile(r"[A-Za-z_][A-Za-z0-9_]*\Z")
_PLAIN = re.compile(r"[A-Za-z0-9_.,+-]*\Z")
SOURCE_NAME = "src.cu"
LIBRARY_NAME = "lib.so"


class BuildError(Exception):
    """A deterministic build failure: the options or the source."""


def options_json(**fields) -> bytes:
    """Canonical compile-options bytes (sorted keys, no whitespace); the
    empty dict is b"", which takes every default."""
    if not fields:
        return b""
    return json.dumps(fields, sort_keys=True,
                      separators=(",", ":")).encode()


def parse_options(raw: bytes) -> dict:
    """The compile options with defaults filled in; raises BuildError on
    an unknown field or value."""
    opts = dict(DEFAULTS)
    if not raw:
        return opts
    try:
        given = json.loads(raw)
    except (ValueError, UnicodeDecodeError) as e:
        raise BuildError(f"compile options are not JSON: {e}")
    if not isinstance(given, dict):
        raise BuildError("compile options are not a JSON object")
    unknown = sorted(set(given) - set(DEFAULTS))
    if unknown:
        raise BuildError(f"unknown compile option(s) {unknown}")
    opts.update(given)
    if opts["arch"] not in ARCHS:
        raise BuildError(f"arch {opts['arch']!r} not in {list(ARCHS)}")
    if opts["std"] not in STDS:
        raise BuildError(f"std {opts['std']!r} not in {list(STDS)}")
    opt = opts["opt"]
    if isinstance(opt, bool) or not isinstance(opt, int) or \
            not 0 <= opt <= 3:
        raise BuildError(f"opt {opt!r} is not an integer in 0-3")
    for flag in ("fast_math", "lineinfo"):
        if not isinstance(opts[flag], bool):
            raise BuildError(f"{flag} {opts[flag]!r} is not a boolean")
    defines = opts["defines"]
    if not isinstance(defines, dict):
        raise BuildError("defines is not an object")
    for name, value in defines.items():
        if not _IDENT.match(name) or name in TOPOLOGY_MACROS:
            raise BuildError(f"define name {name!r} not allowed")
        if isinstance(value, bool) or not isinstance(value, (int, str)) \
                or (isinstance(value, str) and not _PLAIN.match(value)):
            raise BuildError(f"define {name}={value!r}: value must be an "
                             f"integer or a plain string")
    return opts


def nvcc_flags(opts: dict, mesh_shape=None, device_count: int = 0
               ) -> List[str]:
    """nvcc's flags from parsed options (and an AOT child's topology);
    the defaults give ops/_build.NVCC_FLAGS exactly."""
    arch = opts["arch"]
    flags = ["-gencode", f"arch=compute_{arch[3:]},code={arch}",
             f"-std={opts['std']}", f"-O{opts['opt']}",
             "-shared", "-Xcompiler", "-fPIC"]
    if opts["fast_math"]:
        flags.append("-use_fast_math")
    if opts["lineinfo"]:
        flags.append("-lineinfo")
    for name in sorted(opts["defines"]):
        flags.append(f"-D{name}={_nvcc_value(opts['defines'][name])}")
    if device_count > 0:
        flags.append(f"-DYTPU_DEVICE_COUNT={int(device_count)}")
        flags.append("-DYTPU_MESH_SHAPE=" + _nvcc_value(
            ",".join(str(int(d)) for d in mesh_shape or ())))
    return flags


def _nvcc_value(value) -> str:
    """An option value as nvcc reads it: nvcc splits values at commas
    (``-DX=2,2`` defines X=2 and a macro named 2), and a backslash keeps
    a comma in the value (the argv holds ``2\\,2``; no shell is
    involved, and the source sees ``2,2``)."""
    return str(value).replace(",", "\\,")


def _read_request(workspace: str):
    from ..common.multi_chunk import try_parse_multi_chunk

    with open(os.path.join(workspace, "request.bin"), "rb") as fp:
        chunks = try_parse_multi_chunk(fp.read())
    if chunks is None or len(chunks) != 2:
        raise ValueError("malformed request.bin")
    return json.loads(chunks[0]), chunks[1]


def _apply_mem_limit(limit_bytes: int) -> None:
    if limit_bytes <= 0:
        return
    try:
        import resource

        resource.setrlimit(resource.RLIMIT_AS, (limit_bytes, limit_bytes))
    except (ImportError, ValueError, OSError) as e:
        print(f"warning: cannot apply memory limit: {e}", file=sys.stderr)


def _fake_sleep() -> None:
    """YTPU_JIT_FAKE_SLEEP_S: make fake builds take this long, so tests
    can hold a build in flight (joins, lease expiry)."""
    try:
        delay = float(os.environ.get("YTPU_JIT_FAKE_SLEEP_S", "0"))
    except ValueError:
        delay = 0.0
    if delay > 0:
        time.sleep(delay)


def _fake_artifact(options: dict, payload: bytes) -> bytes:
    """Deterministic stand-in artifact, content-unique per (options,
    payload); the JAX package's fake artifact byte for byte."""
    from ..common.hashing import digest_keyed

    d = digest_keyed("ytpu-jit-fake-artifact",
                     json.dumps(options, sort_keys=True).encode(), payload)
    return b"FAKEXLA1" + d.encode()


def _config_score_fake(config: dict, kernel: bytes) -> float:
    """Deterministic pseudo-score in [0, 1), the JAX package's."""
    from ..common.hashing import digest_keyed

    d = digest_keyed("ytpu-autotune-fake-score",
                     json.dumps(config, sort_keys=True).encode(), kernel)
    return int(d[:12], 16) / float(1 << 48)


def _instantiate_kernel(kernel: bytes, config: dict) -> bytes:
    """Fill ``{key}`` placeholders with the config's values."""
    text = kernel.decode(errors="replace")
    for key, value in config.items():
        text = text.replace("{%s}" % key, str(value))
    return text.encode()


class Builder:
    """Runs nvcc in one workspace; keeps nvcc's wall seconds and its
    children's peak RSS for the output line."""

    def __init__(self, workspace: str):
        self.workspace = workspace
        self.nvcc_s = 0.0
        self.builds = 0

    def build(self, options: dict, source: bytes) -> bytes:
        from .env import find_nvcc

        if options.get("backend", "cuda") != "cuda":
            raise BuildError(f"backend {options.get('backend')!r} is not "
                             f"served (cuda only)")
        opts = parse_options(bytes.fromhex(
            options.get("compile_options_hex", "")))
        flags = nvcc_flags(opts, options.get("mesh_shape"),
                           int(options.get("device_count", 0)))
        nvcc = find_nvcc()
        if not nvcc:
            raise BuildError("nvcc not found on this servant")
        src = os.path.join(self.workspace, SOURCE_NAME)
        out = os.path.join(self.workspace, LIBRARY_NAME)
        with open(src, "wb") as fp:
            fp.write(source)
        env = dict(os.environ, TMPDIR=self.workspace)
        t0 = time.perf_counter()
        proc = subprocess.run([nvcc, *flags, "-o", out, src],
                              cwd=self.workspace, env=env,
                              capture_output=True)
        self.nvcc_s += time.perf_counter() - t0
        self.builds += 1
        if proc.returncode != 0:
            raise BuildError(
                f"nvcc exited {proc.returncode}\n"
                + proc.stdout.decode(errors="replace")
                + proc.stderr.decode(errors="replace"))
        with open(out, "rb") as fp:
            artifact = fp.read()
        os.unlink(out)
        return artifact

    def peak_rss_kb(self) -> int:
        import resource

        return resource.getrusage(resource.RUSAGE_CHILDREN).ru_maxrss


def _sweep(options: dict, kernel: bytes, builder) -> bytes:
    """Evaluate every candidate config; returns the winner RECORD.  Real
    mode scores by nvcc's wall time on the instantiated source (lower is
    better, so the score is its negation); fake mode by digest.  Higher
    score wins in both."""
    configs = options.get("autotune_configs") or []
    if not configs:
        raise BuildError("autotune request with no configs")
    if builder is None:
        _fake_sleep()
    best = None
    for config in configs:
        if builder is None:
            score = _config_score_fake(config, kernel)
            metric = "fake_digest_score"
        else:
            t0 = time.perf_counter()
            builder.build(dict(options, autotune_configs=None),
                          _instantiate_kernel(kernel, config))
            score = -(time.perf_counter() - t0)
            metric = "neg_compile_seconds"
        if best is None or score > best["score"]:
            best = {"config": config, "score": score, "metric": metric}
    best["evaluated"] = len(configs)
    return json.dumps(best, sort_keys=True).encode()


def run(workspace: str, fake: bool) -> Tuple[bytes, str]:
    """(artifact, output line) of one request."""
    options, payload = _read_request(workspace)
    _apply_mem_limit(int(options.get("mem_limit_bytes", 0)))
    builder = None if fake else Builder(workspace)
    if options.get("autotune_configs"):
        artifact = _sweep(options, payload, builder)
    elif builder is None:
        _fake_sleep()
        artifact = _fake_artifact(options, payload)
    else:
        artifact = builder.build(options, payload)
    if builder is None:
        # The JAX fake worker's line, so fake cache entries are equal.
        line = (f"compiled {len(payload)} bytes of StableHLO into "
                f"{len(artifact)} artifact bytes")
    else:
        line = (f"built {len(payload)} bytes of CUDA source into "
                f"{len(artifact)} artifact bytes; nvcc {builder.builds} "
                f"run(s) {builder.nvcc_s:.3f} s, peak child RSS "
                f"{builder.peak_rss_kb()} kB")
    return artifact, line


def main() -> int:
    ap = argparse.ArgumentParser("ytpu-torch-jit-compile-worker")
    ap.add_argument("--workspace", required=True)
    ap.add_argument("--fake", action="store_true",
                    help="deterministic pseudo-build (no nvcc)")
    args = ap.parse_args()
    try:
        artifact, line = run(args.workspace, args.fake)
    except (OSError, ValueError) as e:
        print(f"bad request: {e}", file=sys.stderr)
        return 1
    except BuildError as e:
        print(f"build failed: {e}", file=sys.stderr)
        return 1
    except MemoryError:
        print("build exceeded the worker memory limit", file=sys.stderr)
        return 1
    except Exception as e:
        print(f"build failed: {e!r}", file=sys.stderr)
        return 1
    tmp = os.path.join(args.workspace, "artifact.bin.part")
    with open(tmp, "wb") as fp:
        fp.write(artifact)
    # Atomic publish: a killed worker never leaves a half-written
    # artifact where the servant would pick it up.
    os.replace(tmp, os.path.join(args.workspace, "artifact.bin"))
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
