"""Jit, AOT and autotune workloads on the compile farm (a port of the JAX
package's yadcc_tpu/jit/).

In the port the compile worker runs ``nvcc`` for the card: a jit task's
artifact is the shared library with a plain C interface that
ops/_build.py builds from one self-contained ``.cu`` source, so a
farm-built library and a local build are interchangeable.  The farm
machinery is the JAX package's: the Bloom-filtered distributed cache,
cluster-wide dedup of identical in-flight builds, leased grants,
toolchain-matched environments, and the fan-out of one submission into
many children.

* ``env.py``       — jit environment descriptors (backend + nvcc release
                     digest).
* ``frontend.py``  — client side: submit a source over the daemon's
                     loopback HTTP protocol, wait, ``build_library``.
* ``cache_shim.py``— get/put over the cluster cache, for programs that
                     want cache sharing without build offload.
* ``compile_worker.py`` — the servant's build subprocess (also runs AOT
                     topology builds and autotune sweeps).
* ``fanout.py``    — the fan-out machinery of AOT and autotune: bounded
                     width, fairness splitting, retries, stragglers,
                     per-child verdicts.
* ``aot.py``       — client side of AOT multi-topology builds.
* ``autotune.py``  — client side of autotune sweeps (``SearchSpace`` ->
                     winning-config record).

The delegate and servant tasks live in
``yadcc_tpu_torch/daemon/local/{jit,aot,autotune}_task.py`` and
``yadcc_tpu_torch/daemon/cloud/{jit,aot,autotune}_task.py``.  Nothing in
this package imports torch.
"""

from .env import (
    JitEnvironment,
    default_jit_environments,
    jit_env_digest,
    local_jit_environment,
)

__all__ = [
    "JitEnvironment",
    "default_jit_environments",
    "jit_env_digest",
    "local_jit_environment",
]
