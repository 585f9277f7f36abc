"""Client-side subprocess execution with streaming output sinks (a copy of
the JAX package's yadcc_tpu/client/command.py).

Parity with reference yadcc/client/common/command.{h,cc}: run a program,
stream its stdout chunk-by-chunk into a sink chain (the preprocess path
tees into digest + compression in one pass), pass stderr through or into
a caller's file, and support full passthrough for non-distributable
invocations."""

from __future__ import annotations

import os
import subprocess
from typing import Dict, Optional, Sequence


def execute_command(
    argv: Sequence[str],
    *,
    sink=None,
    env: Optional[Dict[str, str]] = None,
    stderr=None,
    chunk_size: int = 256 * 1024,
) -> int:
    """Run argv; stdout streams into `sink.write` (or passes through),
    stderr passes through unless `stderr` names a file to take it.
    Returns the exit code."""
    proc = subprocess.Popen(
        list(argv),
        stdout=subprocess.PIPE if sink is not None else None,
        stderr=stderr,
        env={**os.environ, **env} if env else None,
    )
    try:
        if sink is not None:
            assert proc.stdout is not None
            while True:
                chunk = proc.stdout.read(chunk_size)
                if not chunk:
                    break
                sink.write(chunk)
        return proc.wait()
    except BaseException:
        # A sink failure (disk full mid-preprocess, Ctrl-C) must not
        # orphan the child: kill and reap before propagating.
        proc.kill()
        proc.wait()
        raise
    finally:
        if proc.stdout is not None:
            proc.stdout.close()


def pass_through_to_program(argv: Sequence[str]) -> int:
    """Exec-like passthrough (keeps our PID's exit code semantics)."""
    return subprocess.call(list(argv))
