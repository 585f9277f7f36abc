"""Delegate-side autotune sweep (a copy of the JAX package's
yadcc_tpu/daemon/local/autotune_task.py; the kernel is a ``.cu``
template the servant's worker builds with nvcc for each config).

One client submission carries a kernel plus a candidate config list
(block/grid parameters); the fan-out path slices the list into child
sweeps, each evaluated servant-side.  The cached artifact — at both
levels — is a *winning config record* (JSON: config, score, metric),
never an executable:

  * each CHILD caches its slice's winner under
    (env, slice digest, kernel digest) in ``ytpu-tune1-``;
  * the PARENT, after reducing slice winners to the sweep winner,
    fills a SWEEP-level entry under (env, search-space digest, kernel
    digest) through the delegate's cache writer — so a second host
    sweeping the identical space gets the final answer in ONE cache
    read, with zero fan-out and zero servant time.

A record is tiny and environment-keyed, which is what makes it safe to
share cluster-wide: the measurement machine and the consuming machine
agree on (backend, toolchain) by construction.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from ... import api
from ...common import compress
from ...common.limits import checked_attachment
from ...common.payload import Payload
from ...jit import fanout
from ...jit.env import jit_env_digest
from .. import cache_format, packing
from ..cache_format import (
    CacheEntry,
    get_autotune_cache_key,
    get_autotune_sweep_key,
)
from ..task_digest import get_autotune_task_digest
from .distributed_task import DistributedTask, TaskResult
from .jit_task import NeedJitEnvironment

# The one artifact key a slice child produces (its winner record) and
# the parent's reduced artifact key (the sweep winner record).
SLICE_RECORD_KEY = ".cfg"
WINNER_RECORD_KEY = ".winner"


def parse_winner_record(compressed: bytes) -> Optional[dict]:
    """Decode one (zstd) winner-record artifact; None on any
    corruption — records cross the cache, so a bad one must read as
    a miss, not raise into the reduce."""
    raw = compress.try_decompress(bytes(compressed))
    if raw is None:
        return None
    try:
        record = json.loads(raw)
    except ValueError:
        return None
    if not isinstance(record, dict) or "config" not in record \
            or "score" not in record:
        return None
    return record


@dataclass
class AutotuneSliceTask(DistributedTask):
    """One fan-out CHILD: evaluate a contiguous slice of the candidate
    configs on a servant and return the slice's winner record."""

    requestor_pid: int
    kernel_digest: str
    backend: str
    toolchain_version: str
    cache_control: int
    configs: List[str]  # canonical-JSON candidate configs (the slice)
    # bytes-like: zstd kernel source, shared with the parent.
    compressed_kernel: bytes

    kind = "autotune"

    def get_cache_setting(self) -> int:
        if self.cache_control in (self.CACHE_DISALLOW, self.CACHE_ALLOW,
                                  self.CACHE_REFILL):
            return self.cache_control
        return self.CACHE_ALLOW

    @property
    def env_digest(self) -> str:
        return jit_env_digest(self.backend, self.toolchain_version)

    @property
    def slice_digest(self) -> str:
        return fanout.slice_digest(self.configs)

    def get_cache_key(self) -> Optional[str]:
        if self.get_cache_setting() == self.CACHE_DISALLOW:
            return None
        return get_autotune_cache_key(self.env_digest, self.slice_digest,
                                      self.kernel_digest,
                                      tenant_secret=self.tenant_key_secret)

    def get_digest(self) -> str:
        return get_autotune_task_digest(self.env_digest,
                                        self.slice_digest,
                                        self.kernel_digest)

    def get_env_digest(self) -> str:
        return self.env_digest

    def start_task(self, channel, token: str, grant_id: int) -> int:
        req = api.fanout.QueueAutotuneTaskRequest(
            token=token,
            task_grant_id=grant_id,
            kernel_digest=self.kernel_digest,
            backend=self.backend,
            compression_algorithm=api.daemon.COMPRESSION_ALGORITHM_ZSTD,
            disallow_cache_fill=self.cache_control <= 0,
        )
        req.env_desc.compiler_digest = self.env_digest
        req.env_desc.tenant_scope = self.tenant_key_secret
        req.configs.extend(self.configs)
        resp, _ = channel.call(
            "ytpu.DaemonService", "QueueAutotuneTask", req,
            api.fanout.QueueAutotuneTaskResponse,
            attachment=self.compressed_kernel, timeout=30.0)
        return resp.task_id

    def parse_servant_output(self, resp, attachment) -> TaskResult:
        files = packing.try_unpack_keyed_buffers_views(attachment) or {}
        return TaskResult(
            exit_code=resp.exit_code,
            standard_output=resp.standard_output,
            standard_error=resp.standard_error,
            files=files,
        )

    def parse_cache_entry(self, data) -> Optional[TaskResult]:
        entry = cache_format.try_parse_cache_entry(
            data, expect_kind=cache_format.KIND_AUTOTUNE)
        if entry is None:
            return None
        return TaskResult(
            exit_code=entry.exit_code,
            standard_output=entry.standard_output,
            standard_error=entry.standard_error,
            files=entry.files,
            from_cache=True,
        )


@dataclass
class AutotuneSweepTask(DistributedTask):
    """The fan-out PARENT: slices the space, joins the slice winners,
    reduces to the sweep winner — and is itself cacheable at the
    sweep level (the one fan-out parent with a cache identity)."""

    requestor_pid: int
    kernel_digest: str
    backend: str
    toolchain_version: str
    cache_control: int
    configs: List[str]  # the WHOLE candidate list, canonical JSON
    fanout_width: int   # validated child count (>=1)
    compressed_kernel: bytes

    kind = "autotune"
    is_fanout = True

    def get_cache_setting(self) -> int:
        if self.cache_control in (self.CACHE_DISALLOW, self.CACHE_ALLOW,
                                  self.CACHE_REFILL):
            return self.cache_control
        return self.CACHE_ALLOW

    @property
    def env_digest(self) -> str:
        return jit_env_digest(self.backend, self.toolchain_version)

    @property
    def space_digest(self) -> str:
        return fanout.search_space_digest(self.configs)

    def get_cache_key(self) -> Optional[str]:
        if self.get_cache_setting() == self.CACHE_DISALLOW:
            return None
        return get_autotune_sweep_key(self.env_digest, self.space_digest,
                                      self.kernel_digest,
                                      tenant_secret=self.tenant_key_secret)

    def get_digest(self) -> str:
        return get_autotune_task_digest(self.env_digest,
                                        self.space_digest,
                                        self.kernel_digest)

    def get_env_digest(self) -> str:
        return self.env_digest

    def parse_cache_entry(self, data) -> Optional[TaskResult]:
        """A sweep-level hit: the final winner record, no fan-out."""
        entry = cache_format.try_parse_cache_entry(
            data, expect_kind=cache_format.KIND_AUTOTUNE)
        if entry is None:
            return None
        record = entry.files.get(WINNER_RECORD_KEY)
        if record is None or parse_winner_record(record) is None:
            return None  # a slice entry (or garbage) is not a verdict
        return TaskResult(
            exit_code=entry.exit_code,
            standard_output=entry.standard_output,
            standard_error=entry.standard_error,
            files={WINNER_RECORD_KEY: record},
            from_cache=True,
        )

    # -- fan-out SPI ---------------------------------------------------------

    def expand_children(self) -> List[Tuple[str, DistributedTask]]:
        width = fanout.checked_fanout_width(self.fanout_width)
        slices = fanout.slice_configs(self.configs, width)
        children: List[Tuple[str, DistributedTask]] = []
        for i, sl in enumerate(slices):
            key = f"s{i}-{fanout.slice_digest(sl)[:8]}"
            children.append((key, AutotuneSliceTask(
                requestor_pid=self.requestor_pid,
                kernel_digest=self.kernel_digest,
                backend=self.backend,
                toolchain_version=self.toolchain_version,
                cache_control=self.cache_control,
                configs=sl,
                compressed_kernel=self.compressed_kernel,
            )))
        fanout.split_fairness(self, [c for _, c in children])
        return children

    def reduce(self, outcomes: Dict[str, fanout.ChildOutcome]
               ) -> TaskResult:
        best: Optional[dict] = None
        evaluated = 0
        for outcome in outcomes.values():
            result = outcome.result
            if result is None or result.exit_code != 0:
                continue
            record = parse_winner_record(
                result.files.get(SLICE_RECORD_KEY, b""))
            if record is None:
                continue
            evaluated += int(record.get("evaluated", 0))
            if best is None or record["score"] > best["score"]:
                best = record
        code = fanout.aggregate_exit_code(outcomes)
        if best is None and code == 0:
            # Every child "succeeded" yet none produced a record:
            # corrupt records are an infra outcome, not a win.
            code = -1
        files: Dict[str, bytes] = {}
        if best is not None:
            winner = dict(best, evaluated=evaluated)
            files[WINNER_RECORD_KEY] = compress.compress(
                json.dumps(winner, sort_keys=True).encode())
        return TaskResult(
            exit_code=code,
            standard_output=fanout.verdict_summary(outcomes).encode(),
            standard_error=(b"" if code == 0 else
                            b"autotune fan-out completed with failures: "
                            + fanout.verdict_summary(outcomes).encode()),
            files=files,
            verdicts=[o.verdict for o in outcomes.values()],
        )

    def make_parent_cache_entry(self, result: TaskResult
                                ) -> Optional[Tuple[str, Payload]]:
        """The sweep-level fill (delegate-side, after reduce): only a
        fully-successful sweep may publish a winner — a partial sweep's
        'best so far' under the full-space key would lie to every
        future reader."""
        if result.exit_code != 0 or result.from_cache:
            return None
        if self.get_cache_setting() == self.CACHE_DISALLOW:
            return None
        record = result.files.get(WINNER_RECORD_KEY)
        if record is None:
            return None
        key = get_autotune_sweep_key(self.env_digest, self.space_digest,
                                     self.kernel_digest)
        entry = CacheEntry(
            exit_code=0,
            standard_output=b"",
            standard_error=b"",
            files={WINNER_RECORD_KEY: bytes(record)},
            kind=cache_format.KIND_AUTOTUNE,
        )
        return key, cache_format.write_cache_entry_payload(entry)


def make_autotune_task(msg: "api.fanout.SubmitAutotuneTaskRequest",
                       compressed_kernel: bytes) -> AutotuneSweepTask:
    """Build the sweep parent from /local/submit_autotune_task; raises
    NeedJitEnvironment when the environment pair is missing, ValueError
    on an empty/malformed config list or an over-wide fan-out."""
    if not msg.backend or not msg.jaxlib_version:
        raise NeedJitEnvironment(
            f"backend={msg.backend!r} jaxlib_version={msg.jaxlib_version!r}")
    if not msg.kernel_digest:
        raise ValueError("kernel_digest is required")
    configs = list(msg.configs)
    if not configs:
        raise ValueError("empty config search space")
    for c in configs:
        try:
            parsed = json.loads(c)
        except ValueError:
            parsed = None
        if not isinstance(parsed, dict):
            raise ValueError(f"config is not a JSON object: {c[:80]!r}")
    width = msg.fanout_width or min(len(configs),
                                    fanout.DEFAULT_AUTOTUNE_WIDTH)
    width = min(width, len(configs))
    fanout.checked_fanout_width(width)
    return AutotuneSweepTask(
        requestor_pid=msg.requestor_process_id,
        kernel_digest=msg.kernel_digest,
        backend=msg.backend,
        toolchain_version=msg.jaxlib_version,
        cache_control=msg.cache_control,
        configs=configs,
        fanout_width=width,
        # Same wire-cap-at-intake contract as make_cxx_task.
        compressed_kernel=checked_attachment(compressed_kernel),
    )
