"""Compiler subprocess launcher (a copy of the JAX package's
yadcc_tpu/daemon/cloud/execute_command.py).

Parity with reference yadcc/daemon/cloud/execute_command.cc:34-84: each
task runs `sh -c <cmdline>` in its own process group (so a runaway
compiler's children die with it), niced to 5 (foreign compiles must not
starve the machine's owner), with stdin closed and stdout/stderr
captured.
"""

from __future__ import annotations

import os
import shutil
import subprocess
from typing import Optional

# Resolved once: start_program runs once per compile task.
_NICE_BIN = shutil.which("nice")


def start_program(
    cmdline: str,
    *,
    nice_level: int = 5,
    cwd: str = "/",
    env: Optional[dict] = None,
) -> subprocess.Popen:
    """Launch detached into its own process group; caller owns wait().

    Deliberately NO preexec_fn: the daemon process runs grpc worker
    threads, and running Python between fork and exec in a
    multithreaded parent intermittently corrupts the child (observed as
    segfaults under fork pressure).  `start_new_session` does the
    setsid at the C level (a session leader is also a process-group
    leader, so killpg(pid) still nukes the whole tree), and niceness
    comes from the `nice` binary instead of os.nice in the child.
    """
    argv = ["/bin/sh", "-c", cmdline]
    if nice_level and _NICE_BIN:
        # Best-effort niceness, never a hard dependency.
        argv = [_NICE_BIN, "-n", str(nice_level)] + argv
    return subprocess.Popen(
        argv,
        cwd=cwd,
        env=env,
        stdin=subprocess.DEVNULL,
        stdout=subprocess.PIPE,
        stderr=subprocess.PIPE,
        start_new_session=True,
    )


def kill_process_group(proc: subprocess.Popen) -> None:
    """SIGKILL the whole group (reference execution_engine.cc:329-343)."""
    try:
        os.killpg(proc.pid, 9)
    except (ProcessLookupError, PermissionError):
        pass
