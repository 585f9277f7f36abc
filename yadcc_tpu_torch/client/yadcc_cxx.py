#!/usr/bin/env python3
"""The compiler-masquerading client (a copy of the JAX package's
yadcc_tpu/client/yadcc_cxx.py).

Parity with reference yadcc/client/cxx/yadcc-cxx.cc: installed as a
symlink named `g++`/`gcc`/`clang++` early in PATH (a symlink to this
file, or a wrapper script in a farm directory named by YTPU_WRAPPER_DIR)
or invoked as `python -m yadcc_tpu_torch.client.yadcc_cxx g++ ...`, it
decides whether the invocation is distributable (:37-65), preprocesses
locally (streaming into digest and compression), short-circuits tiny TUs
to local compilation, submits to the local daemon, long-polls for the
result with a 5-attempt cloud retry ladder and local fallback under
quota (:186-250), and finally writes the outputs exactly where the build
system expects them.

Exit codes: the remote compiler's own exit code passes through verbatim
— callers (make/ninja) must not be able to tell the difference.  Every
local compile is logged with its reason (DEBUG for a non-distributable
invocation or a tiny TU, INFO for a failed preprocess, WARNING for an
unreachable daemon or the ladder's end).
"""

from __future__ import annotations

import os
import sys

if __name__ == "__main__" and not __package__:
    # Run as a file (a symlink named g++ pointing here): the checkout's
    # root goes on sys.path in place of this directory, whose logging.py
    # would shadow the standard library's.
    sys.path[0] = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.realpath(__file__))))
    __package__ = "yadcc_tpu_torch.client"

import shlex  # noqa: E402
from typing import List, Optional  # noqa: E402

from ..common import cacheability  # noqa: E402
from . import logging as log  # noqa: E402
from .command import pass_through_to_program  # noqa: E402
from .compilation_saas import (  # noqa: E402
    CloudError,
    apply_path_patches,
    submit_compilation_task,
    wait_for_compilation_task,
    write_compilation_results,
)
from .compiler_args import CompilerArgs, is_distributable  # noqa: E402
from .env_options import (cache_control,  # noqa: E402
                          compile_on_cloud_size_threshold,
                          debugging_compile_locally,
                          ignore_timestamp_macros,
                          treat_stdin_as_lightweight,
                          warn_on_noncacheable,
                          warn_on_non_distributable)
from .rewrite_file import rewrite_file  # noqa: E402
from .task_quota import task_quota  # noqa: E402

_CLOUD_RETRIES = 5
_WRAPPER_MARKERS = ("ccache", "distcc", "icecc", "ytpu", "yadcc")


def find_real_compiler(invoked_as: str) -> Optional[str]:
    """Resolve the actual compiler on PATH, skipping ourselves and other
    build accelerators (reference yadcc-cxx.cc:118-140): the wrapper
    farm's directory (YTPU_WRAPPER_DIR) and any candidate whose resolved
    path names one (_WRAPPER_MARKERS)."""
    name = os.path.basename(invoked_as)
    me = os.path.realpath(sys.argv[0]) if sys.argv else ""
    # The farm's wrapper scripts mark their own directory: never resolve
    # back into the farm (that's a fork loop, not a compiler).
    farm = os.environ.get("YTPU_WRAPPER_DIR", "")
    for d in os.environ.get("PATH", "").split(os.pathsep):
        if not d:
            continue
        if farm and os.path.realpath(d) == os.path.realpath(farm):
            continue
        cand = os.path.join(d, name)
        if not (os.path.isfile(cand) and os.access(cand, os.X_OK)):
            continue
        real = os.path.realpath(cand)
        if real == me:
            continue
        lowered = real.lower()
        if any(m in lowered for m in _WRAPPER_MARKERS):
            continue
        return cand
    return None


def _is_lightweight_task(args: CompilerArgs) -> bool:
    """Reference IsLightweightTask (yadcc-cxx.cc:68-81): version
    probes and preprocessing barely load a core, so they take the
    1.5x-cores quota class instead of the 0.5x heavy class — a
    configure stage fires hundreds of these and must not serialize
    behind real compiles.  Stdin sources opt in via env."""
    if any(args.has(a) for a in ("-dumpversion", "-dumpmachine", "-E")):
        return True
    # has() matches parsed options only: a "-" that is the VALUE of
    # -o/-MF is data, not the stdin source, and must not reclassify a
    # real compile.
    return treat_stdin_as_lightweight() and args.has("-")


def _compile_locally(compiler: str, args: CompilerArgs) -> int:
    with task_quota(lightweight=_is_lightweight_task(args)):
        return pass_through_to_program([compiler] + args.args)


def remote_invocation(args: CompilerArgs, directives_only: bool) -> str:
    """Arguments forwarded to the servant, as one shell-quoted string:
    no -o (it picks its own), no dependency-generation or include paths
    (already resolved by preprocessing — reference
    compilation_saas.cc:57-64).

    This string feeds the task digest and cache key, so it must be
    byte-identical between this client, the JAX package's and the
    native one (native/client/ytpu-cxx.cc remote_invocation).
    shlex-quoting matters because the servant runs the command through
    `sh -c`: args with spaces/metacharacters (-DMSG='a b') must survive
    the round trip intact.
    """
    remote_args = args.rewrite(
        remove=["-c", "-include", "-imacros", "-isystem", "-iquote", "-I"],
        remove_prefix=["-o", "-M", "-I", "-iquote", "-isystem", "-include",
                       "-Wp,"],
        keep_sources=False,
    )
    if directives_only:
        remote_args += ["-fpreprocessed", "-fdirectives-only"]
    return " ".join(shlex.quote(a) for a in remote_args)


def entry(argv: List[str]) -> int:
    """argv: [invoked-name, compiler-args...].  When invoked via the
    `python -m ... g++ ...` form, argv[0] is the real compiler name."""
    args = CompilerArgs.parse(argv)
    compiler = find_real_compiler(args.compiler)
    if compiler is None:
        log.error(f"cannot find real compiler for {args.compiler!r}")
        return 127

    if debugging_compile_locally():
        # Keeps the full pipeline out of the picture: a bad object
        # produced THIS way exonerates distribution entirely.
        log.warning("YTPU_DEBUGGING_COMPILE_LOCALLY=1: compiling locally")
        return _compile_locally(compiler, args)

    ok, why = is_distributable(args)
    if not ok:
        if warn_on_non_distributable():
            log.warning(f"not distributable ({why}); running locally")
        else:
            log.debug(f"not distributable ({why}); running locally")
        return _compile_locally(compiler, args)

    # Preprocess under lightweight quota (reference rewrite_file.cc:122).
    with task_quota(lightweight=True) as granted:
        if not granted:
            log.warning("local daemon unreachable; compiling locally")
            return pass_through_to_program([compiler] + args.args)
        rewritten = rewrite_file(args, compiler)
    if rewritten is None:
        # Preprocessing failed — recompile locally so the user sees the
        # compiler's own diagnostics.
        log.info("preprocessing failed; compiling locally")
        return _compile_locally(compiler, args)

    if rewritten.uncompressed_size < compile_on_cloud_size_threshold():
        log.debug("tiny TU; compiling locally")
        return _compile_locally(compiler, args)

    invocation = remote_invocation(args, rewritten.directives_only)

    if (warn_on_noncacheable() and cache_control() != 0
            and not ignore_timestamp_macros()):
        # Same rule the servant applies (common/cacheability.py): only
        # macros NOT neutralized by a -D override block caching.
        blocking = cacheability.blocking_macros(
            rewritten.timestamp_macros_found, invocation)
        if blocking:
            names = ", ".join(sorted(m.decode() for m in blocking))
            log.warning(
                f"{args.sources[0]}: uses {names} — compiled remotely "
                "but NOT cached (set YTPU_IGNORE_TIMESTAMP_MACROS=1 to "
                "cache anyway, or -D-override the macro)")

    source = args.sources[0]
    for attempt in range(_CLOUD_RETRIES):
        try:
            task_id = submit_compilation_task(
                compiler_path=compiler,
                source_path=source,
                source_digest=rewritten.source_digest,
                compressed_source=rewritten.compressed_source,
                invocation_arguments=invocation,
                cache_control=cache_control(),
                ignore_timestamp_macros=ignore_timestamp_macros(),
            )
            result, patches = wait_for_compilation_task(task_id)
        except CloudError as e:
            log.warning(f"cloud attempt {attempt + 1} failed: {e}")
            continue
        if result.exit_code < 0 or result.exit_code == 127:
            # Negative codes are daemon-synthesized failures (no
            # capacity, servant lost, internal error) and 127 is
            # servant-side environment trouble — neither is a compile
            # error, so retry / fall back rather than failing the build
            # (reference yadcc-cxx.cc:214-222).
            log.warning(
                f"cloud infrastructure failure ({result.exit_code}): "
                f"{result.standard_error[:200]}; retrying")
            continue
        if result.exit_code != 0:
            # A genuine compile error: print diagnostics, pass it through.
            sys.stderr.write(result.standard_error)
            sys.stdout.write(result.standard_output)
            return result.exit_code
        patched = apply_path_patches(
            result.files, patches,
            client_dir=os.path.dirname(os.path.abspath(source)) or ".")
        write_compilation_results(patched, args)
        sys.stderr.write(result.standard_error)
        sys.stdout.write(result.standard_output)
        return 0

    log.warning("cloud compilation failed repeatedly; falling back locally")
    return _compile_locally(compiler, args)


def main() -> None:
    invoked = os.path.basename(sys.argv[0])
    if invoked in ("yadcc_cxx.py", "ytpu-cxx", "__main__.py") \
            and len(sys.argv) > 1:
        argv = sys.argv[1:]
    else:
        argv = [invoked] + sys.argv[1:]
    sys.exit(entry(argv))


if __name__ == "__main__":
    main()
