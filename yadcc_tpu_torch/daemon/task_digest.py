"""Task dedup digest (a copy of the JAX package's
yadcc_tpu/daemon/task_digest.py, trimmed to the C++ digest: the jit, AOT
and autotune digests come with those workloads).

Parity with reference yadcc/daemon/task_digest.cc:25-30: identical
compilations are identified by (compiler binary, invocation arguments,
preprocessed source) — all hashed, domain-separated.  Two clients
compiling the same TU anywhere in the cluster produce the same digest,
which drives duplicate-task joining and the cache key.
"""

from __future__ import annotations

from ..common.hashing import digest_keyed

_DOMAIN = "ytpu-cxx-task"


def get_cxx_task_digest(compiler_digest: str, invocation_arguments: str,
                        source_digest: str) -> str:  # ytpu: sanitizes(key-domain)
    return digest_keyed(
        _DOMAIN,
        compiler_digest.encode(),
        invocation_arguments.encode(),
        source_digest.encode(),
    )
