"""Client environment knobs (a copy of the JAX package's
yadcc_tpu/client/env_options.py, with the jit workloads' knobs).

Parity with reference yadcc/client/common/env_options.{h,cc} and the
semantics documented in yadcc/doc/client.md:15-25 / doc/client/cxx.md:
the client must not depend on any flag library (startup latency), so all
configuration is environment variables:

    YTPU_CACHE_CONTROL     0 = off, 1 = read/write (default),
                           2 = refill (skip reads, still fill — for
                           cache-cold benchmarking / cache rebuilds)
    YTPU_LOG_LEVEL         DEBUG/INFO/WARNING/ERROR (default WARNING)
    YTPU_DAEMON_PORT       local daemon port (default 8334)
    YTPU_COMPILE_ON_CLOUD_SIZE_THRESHOLD
                           preprocessed sizes below this compile locally
    YTPU_IGNORE_TIMESTAMP_MACROS
                           1 = cache even with __TIME__ et al
                           (transmitted to the servant, which skips its
                           cacheability scan)
    YTPU_WARN_ON_WAIT      1 = warn when quota waits are slow (default)
    YTPU_WARN_ON_WAIT_LONGER_THAN
                           seconds before the wait warning (default 10)
    YTPU_WARN_ON_NONCACHEABLE
                           1 = warn when a TU's __TIME__-class macros
                           block caching (override-aware)
    YTPU_WARN_ON_NON_DISTRIBUTABLE
                           1 = warn (not just debug-log) when an
                           invocation can't distribute
    YTPU_DEBUGGING_COMPILE_LOCALLY
                           1 = force every compile local (isolate
                           distribution from compiler bugs)
    YTPU_TREAT_SOURCE_FROM_STDIN_AS_LIGHTWEIGHT
                           1 = stdin-sourced compiles take lightweight
                           quota (they're usually configure-time
                           feature probes, not real TUs)
    YTPU_COMPRESS_LEVEL    compression level for the preprocessed-source
                           stream (default 3, the reference's
                           throughput-over-ratio tune); out-of-range or
                           unparsable values fall back to the default
                           (read by common/compress.py)
    YTPU_JIT_OFFLOAD       1 = offload jit, AOT and autotune builds to
                           the cluster (default 0: opt-in per process)
    YTPU_JIT_TIMEOUT_S     overall budget for one offloaded build,
                           submit through artifact (default 120;
                           unparsable or non-positive values fall back
                           to the default)
    YTPU_JIT_LOCAL_FALLBACK
                           1 (default) = build locally with nvcc when the
                           cluster can't (no daemon, no capacity, no
                           toolchain-matching servant, timeout); 0 =
                           raise instead (rigs that must not mask a
                           broken farm)
    YTPU_TENANT_TOKEN      tenant credential, sent to the local daemon
                           as the X-Ytpu-Tenant header on every request;
                           empty = anonymous (refused 403 by a daemon
                           with tenancy enabled)
    YTPU_WRAPPER_DIR       the wrapper farm's directory: never resolved
                           as the real compiler (yadcc_cxx.py)
"""

from __future__ import annotations

import os


def _int_env(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, default))
    except ValueError:
        return default


def cache_control() -> int:
    v = _int_env("YTPU_CACHE_CONTROL", 1)
    return v if v in (0, 1, 2) else 1


def log_level() -> str:
    return os.environ.get("YTPU_LOG_LEVEL", "WARNING").upper()


def daemon_port() -> int:
    return _int_env("YTPU_DAEMON_PORT", 8334)


def compile_on_cloud_size_threshold() -> int:
    # Tiny TUs aren't worth a network round trip (reference default 8K).
    return _int_env("YTPU_COMPILE_ON_CLOUD_SIZE_THRESHOLD", 8192)


def ignore_timestamp_macros() -> bool:
    return _int_env("YTPU_IGNORE_TIMESTAMP_MACROS", 0) == 1


def warn_on_wait() -> bool:
    return _int_env("YTPU_WARN_ON_WAIT", 1) == 1


def warn_on_wait_longer_than_s() -> float:
    """Seconds of quota wait before warning (reference
    YADCC_WARN_ON_WAIT_LONGER_THAN).  Default 10s: quota waits of a few
    seconds are routine backpressure on a busy machine."""
    try:
        return float(os.environ.get("YTPU_WARN_ON_WAIT_LONGER_THAN", "10"))
    except ValueError:
        return 10.0


def warn_on_noncacheable() -> bool:
    """Warn when a TU uses __TIME__-class macros and thus skips the
    cache (reference YADCC_WARN_ON_NONCACHEABLE)."""
    return _int_env("YTPU_WARN_ON_NONCACHEABLE", 0) == 1


def warn_on_non_distributable() -> bool:
    """Warn when an invocation can't distribute (reference
    YADCC_WARN_ON_NON_DISTRIBUTABLE) — spotting builds that silently
    run everything locally."""
    return _int_env("YTPU_WARN_ON_NON_DISTRIBUTABLE", 0) == 1


def debugging_compile_locally() -> bool:
    """Force every compile local, keeping the full argument pipeline
    (reference YADCC_DEBUGGING_COMPILE_LOCALLY) — isolates whether a
    bad object came from distribution or from the compiler itself."""
    return _int_env("YTPU_DEBUGGING_COMPILE_LOCALLY", 0) == 1


def treat_stdin_as_lightweight() -> bool:
    return _int_env("YTPU_TREAT_SOURCE_FROM_STDIN_AS_LIGHTWEIGHT", 0) == 1


def jit_offload_enabled() -> bool:
    """YTPU_JIT_OFFLOAD: opt-in gate of the jit workloads; anything but
    a parsable 1 means off (builds leaving the machine on a typo would
    surprise in the bad direction)."""
    return _int_env("YTPU_JIT_OFFLOAD", 0) == 1


def jit_timeout_s() -> float:
    """YTPU_JIT_TIMEOUT_S: submit-to-artifact budget of one offloaded
    build; unparsable or non-positive values fall back to the default
    rather than a deadline that fails every offload at once."""
    default = 120.0
    try:
        v = float(os.environ.get("YTPU_JIT_TIMEOUT_S", default))
    except ValueError:
        return default
    return v if v > 0 else default


def jit_local_fallback() -> bool:
    """YTPU_JIT_LOCAL_FALLBACK: build locally on any infrastructure miss
    (default).  Off = raise, for rigs that must not mask a broken farm
    behind silent local builds."""
    return _int_env("YTPU_JIT_LOCAL_FALLBACK", 1) == 1


def tenant_token() -> str:
    """YTPU_TENANT_TOKEN: the tenant credential presented to the local
    daemon.  The credential identifies and authenticates; it carries no
    cache secrets (those never reach clients)."""
    return os.environ.get("YTPU_TENANT_TOKEN", "")


def compress_level() -> int:
    """Validated YTPU_COMPRESS_LEVEL (the clamp lives in
    common.compress.current_level, which every compression call site
    reads; client code and diagnostics report the same resolved value
    the compressor will use).  Kept for parity: only the tests call it,
    in both packages."""
    from ..common.compress import current_level

    return current_level()
