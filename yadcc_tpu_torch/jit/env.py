"""Jit environment descriptors (the port's counterpart of the JAX
package's yadcc_tpu/jit/env.py).

A C++ environment is the compiler binary's content digest (env_desc
.proto).  In the port a jit artifact is a shared library that ``nvcc``
builds for the card from one self-contained ``.cu`` source
(ops/_build.py), so what must match for a farm-built library to stand
in for a local build is the pair (backend, toolchain version):
``backend`` is ``"cuda"`` and ``toolchain_version`` the release line of
``nvcc --version``.  Torch's version is not part of it: the artifact
links no torch.

The digest is the JAX package's ``jit_env_digest`` (same domain, same
function), so equal strings give equal digests in both packages, and it
travels wherever compiler digests travel: the servant's heartbeat
``env_descs``, grant requests, the Queue*Task requests' EnvironmentDesc.
The scheduler's env-matched grant pools then gate jit grants to
toolchain-matching servants with no change to the scheduler.  The wire
field that carries the version keeps its name, ``jaxlib_version``.

Nothing here imports torch: the servant and the jit clients load none.
"""

from __future__ import annotations

import subprocess
from dataclasses import dataclass

from ..common.hashing import digest_keyed

_ENV_DOMAIN = "ytpu-jit-env"
BACKEND = "cuda"


def jit_env_digest(backend: str, toolchain_version: str) -> str:
    return digest_keyed(_ENV_DOMAIN, backend.encode(),
                        toolchain_version.encode())


@dataclass(frozen=True)
class JitEnvironment:
    """One servable jit environment."""

    backend: str
    toolchain_version: str

    @property
    def digest(self) -> str:
        return jit_env_digest(self.backend, self.toolchain_version)


def find_nvcc() -> str:
    """The nvcc ops/_build.py builds with ('' when there is none)."""
    from ..ops._build import find_nvcc as find

    try:
        return find()
    except RuntimeError:
        return ""


def nvcc_release(nvcc: str) -> str:
    """The release line of ``nvcc --version`` ('Cuda compilation tools,
    release 12.4, V12.4.131'), '' when it cannot be read."""
    try:
        out = subprocess.run([nvcc, "--version"], capture_output=True,
                             text=True, timeout=60).stdout
    except (OSError, subprocess.SubprocessError):
        return ""
    for line in out.splitlines():
        if "release" in line:
            return line.strip()
    return ""


def local_toolchain_version() -> str:
    """This host's nvcc release line, '' without nvcc."""
    nvcc = find_nvcc()
    return nvcc_release(nvcc) if nvcc else ""


def local_jit_environment(backend: str = BACKEND) -> JitEnvironment:
    """The environment this host builds for."""
    return JitEnvironment(backend=backend,
                          toolchain_version=local_toolchain_version())


def default_jit_environments() -> list:
    """What an unconfigured servant serves: the cuda environment when
    nvcc is found, else nothing (an empty version would advertise an
    environment no client asks for, and its builds would fail anyway)."""
    env = local_jit_environment(BACKEND)
    return [env] if env.toolchain_version else []
