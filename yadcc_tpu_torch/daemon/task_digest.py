"""Task dedup digest (a copy of the JAX package's
yadcc_tpu/daemon/task_digest.py: the C++, jit, AOT and autotune digests,
byte for byte, so both packages' delegates dedup and key alike).

Parity with reference yadcc/daemon/task_digest.cc:25-30: identical
compilations are identified by (compiler binary, invocation arguments,
preprocessed source) — all hashed, domain-separated.  Two clients
compiling the same TU anywhere in the cluster produce the same digest,
which drives duplicate-task joining and the cache key.
"""

from __future__ import annotations

from ..common.hashing import digest_keyed

_DOMAIN = "ytpu-cxx-task"
_JIT_DOMAIN = "ytpu-jit-task"
_AOT_DOMAIN = "ytpu-aot-task"
_AUTOTUNE_DOMAIN = "ytpu-autotune-task"


def get_cxx_task_digest(compiler_digest: str, invocation_arguments: str,
                        source_digest: str) -> str:  # ytpu: sanitizes(key-domain)
    return digest_keyed(
        _DOMAIN,
        compiler_digest.encode(),
        invocation_arguments.encode(),
        source_digest.encode(),
    )


def get_jit_task_digest(env_digest: str, compile_options: bytes,
                        computation_digest: str) -> str:  # ytpu: sanitizes(key-domain)
    """Jit analogue of the (compiler, args, source) triple:
    (jit environment, serialized CompileOptions, lowered StableHLO) —
    each the full determinant of the compile's output in its slot.
    Separate domain: a jit task digest can never collide with a cxx one
    even on crafted inputs."""
    return digest_keyed(
        _JIT_DOMAIN,
        env_digest.encode(),
        bytes(compile_options),
        computation_digest.encode(),
    )


def get_aot_task_digest(env_digest: str, topology_digest: str,
                        computation_digest: str) -> str:  # ytpu: sanitizes(key-domain)
    """One AOT fan-out CHILD (a single topology compile): (jit
    environment, topology spec, lowered StableHLO).  The topology
    digest (jit/fanout.py) already covers the per-topology
    CompileOptions, so the triple fully determines the executable.
    Children of one parent differ only in the topology slot — which is
    exactly what makes each independently cacheable and joinable
    cluster-wide."""
    return digest_keyed(
        _AOT_DOMAIN,
        env_digest.encode(),
        topology_digest.encode(),
        computation_digest.encode(),
    )


def get_autotune_task_digest(env_digest: str, slice_digest: str,
                             kernel_digest: str) -> str:  # ytpu: sanitizes(key-domain)
    """One autotune fan-out CHILD (a slice of the config search
    space): (jit environment, config-slice digest, kernel source).
    The cached artifact is the slice's winning-config RECORD, not an
    executable, so the digest deliberately omits anything
    machine-local — two hosts sweeping the same slice of the same
    kernel dedup to one servant sweep."""
    return digest_keyed(
        _AUTOTUNE_DOMAIN,
        env_digest.encode(),
        slice_digest.encode(),
        kernel_digest.encode(),
    )
