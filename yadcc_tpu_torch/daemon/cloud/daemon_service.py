"""Servant RPC service + heartbeat pacemaker (a copy of the JAX package's
yadcc_tpu/daemon/cloud/daemon_service.py).  Besides the C++ workload it
serves the jit, AOT and autotune builds (QueueJitCompilationTask,
QueueAotCompilationTask, QueueAutotuneTask), whose worker runs nvcc for
the card, and advertises its jit environments in the heartbeat beside
its compiler digests, so the scheduler grants jit work only to servants
of a matching toolchain.

Parity with reference yadcc/daemon/cloud/daemon_service_impl.{h,cc}:
the DaemonService RPC surface (QueueCxxCompilationTask / ReferenceTask /
WaitForCompilationOutput / FreeTask, :61-186) and the 1-second heartbeat
pacemaker (:50-59, :190-242) reporting version, location, priority,
memory, capacity, nprocs, load, compiler environments and running task
digests — and consuming the scheduler's expired-task kill list plus the
rotating daemon-token window.
"""

from __future__ import annotations

import hmac
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set

from ... import api
from ...common.limits import clamp_wait_s
from ...jit.env import JitEnvironment, default_jit_environments
from ...rpc import Channel, RpcContext, RpcError, ServiceSpec
from ...utils.logging import get_logger
from ...version import VERSION_FOR_UPGRADE
from .. import packing
from ..config import DaemonConfig
from ..sysinfo import (
    LoadAverageSampler,
    read_memory_available,
    read_memory_total,
)
from .aot_task import CloudAotCompilationTask
from .autotune_task import CloudAutotuneTask
from .compiler_registry import CompilerRegistry
from .cxx_task import CloudCxxCompilationTask
from .distributed_cache_writer import DistributedCacheWriter
from .execution_engine import (
    ExecutionEngine,
    decide_capacity,
)
from .jit_task import CloudJitCompilationTask

logger = get_logger("daemon.cloud.service")

SERVICE_NAME = "ytpu.DaemonService"


@dataclass
class _TaskResult:
    exit_code: int = 0
    standard_output: bytes = b""
    standard_error: bytes = b""
    files: Dict[str, bytes] = field(default_factory=dict)
    patches: Dict[str, list] = field(default_factory=dict)


class DaemonService:
    """The servant role of the daemon process."""

    def __init__(
        self,
        config: DaemonConfig,
        *,
        engine: ExecutionEngine,
        registry: CompilerRegistry,
        cache_writer: Optional[DistributedCacheWriter] = None,
        sampler: Optional[LoadAverageSampler] = None,
        allow_poor_machine: bool = True,
        cgroup_present: Optional[bool] = None,
        jit_environments: Optional[List[JitEnvironment]] = None,
    ):
        self.config = config
        self.engine = engine
        self.registry = registry
        self.cache_writer = cache_writer
        self.sampler = sampler or LoadAverageSampler()
        self._allow_poor = allow_poor_machine
        self._cgroup = cgroup_present
        # Jit environments this servant builds for.  None = the default
        # (the cuda environment when nvcc is found, nothing otherwise);
        # [] = jit serving off.  Their digests ride the heartbeat's
        # env_descs like compiler digests.
        if jit_environments is None:
            jit_environments = default_jit_environments()
        self._jit_envs = list(jit_environments)
        self._jit_env_digests = {e.digest: e for e in self._jit_envs}
        self._lock = threading.Lock()
        # Tokens delegates may present, as rolled out by the scheduler.
        self._acceptable_tokens: Set[str] = set()  # guarded by: self._lock
        self._results: Dict[int, _TaskResult] = {}  # guarded by: self._lock
        # What the last heartbeat reported, and how many went out (not
        # in the JAX package's inspect).
        self._last_beat: dict = {}  # guarded by: self._lock
        self._beats = 0  # guarded by: self._lock
        self._beat_thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._sched_channel: Optional[Channel] = None
        # Set by attach_frontend when serving on the aio front end;
        # enables the parked WaitForCompilationOutput path.
        self._frontend = None

    # -- wiring ------------------------------------------------------------

    def attach_frontend(self, server) -> None:
        """Hand the service its RPC front end BEFORE spec() so the
        output long-poll can park: the front end supplies the loop
        deadline timers (``call_later``).  Threaded front ends have no
        timer surface — the sync path stays, as A/B and fallback."""
        self._frontend = server if hasattr(server, "call_later") else None

    def spec(self) -> ServiceSpec:
        s = ServiceSpec(SERVICE_NAME)
        s.add("QueueCxxCompilationTask",
              api.daemon.QueueCxxCompilationTaskRequest,
              self.QueueCxxCompilationTask)
        s.add("QueueJitCompilationTask",
              api.jit.QueueJitCompilationTaskRequest,
              self.QueueJitCompilationTask)
        s.add("QueueAotCompilationTask",
              api.fanout.QueueAotCompilationTaskRequest,
              self.QueueAotCompilationTask)
        s.add("QueueAutotuneTask",
              api.fanout.QueueAutotuneTaskRequest,
              self.QueueAutotuneTask)
        s.add("ReferenceTask", api.daemon.ReferenceTaskRequest,
              self.ReferenceTask)
        s.add("WaitForCompilationOutput",
              api.daemon.WaitForCompilationOutputRequest,
              self.WaitForCompilationOutput)
        s.add("FreeTask", api.daemon.FreeDaemonTaskRequest, self.FreeTask)
        if self._frontend is not None and hasattr(
                self.engine, "wait_for_task_async"):
            # aio front end attached: the output long-poll parks ON the
            # accept loop (engine continuation + loop deadline timer)
            # instead of holding a worker thread in
            # engine.wait_for_task.  Only the aio server consults
            # `parked`; the threaded front end keeps the blocking
            # handler above as A/B + fallback.
            s.add_parked("WaitForCompilationOutput",
                         api.daemon.WaitForCompilationOutputRequest,
                         self.WaitForCompilationOutputParked)
        return s

    def _verify(self, token: str) -> None:  # ytpu: sanitizes(authz)
        # Fail CLOSED: until the first heartbeat response delivers the
        # scheduler's rotating token window, this servant serves nobody.
        # An empty set must not accept-all — QueueCxxCompilationTask
        # ultimately runs caller-supplied command lines.
        with self._lock:
            candidates = sorted(self._acceptable_tokens)
        # Timing-safe sweep: compare against EVERY candidate with
        # hmac.compare_digest and no early exit, so response timing
        # reveals neither a prefix match nor which window position
        # matched (the old set-membership probe hashed the attacker's
        # guess, whose comparison cost leaks on collision probing).
        ok = False
        for candidate in candidates:
            if hmac.compare_digest(token, candidate):
                ok = True
        if not ok:
            raise RpcError(api.daemon.DAEMON_STATUS_ACCESS_DENIED,
                           "unrecognized daemon token")

    def set_acceptable_tokens_for_testing(self, tokens) -> None:
        with self._lock:
            self._acceptable_tokens = set(tokens)

    # -- RPC handlers -------------------------------------------------------

    def QueueCxxCompilationTask(self, req, attachment: bytes,
                                ctx: RpcContext):  # ytpu: untrusted(req, attachment)
        self._verify(req.token)
        if req.compression_algorithm != \
                api.daemon.COMPRESSION_ALGORITHM_ZSTD:
            raise RpcError(api.daemon.DAEMON_STATUS_INVALID_ARGUMENT,
                           "only zstd sources accepted")
        compiler = self.registry.try_get_compiler_path(
            req.env_desc.compiler_digest)
        if compiler is None:
            raise RpcError(
                api.daemon.DAEMON_STATUS_ENVIRONMENT_NOT_AVAILABLE,
                req.env_desc.compiler_digest)
        task = CloudCxxCompilationTask(
            compiler_path=compiler,
            compiler_digest=req.env_desc.compiler_digest,
            invocation_arguments=req.invocation_arguments,
            source_path=req.source_path,
            temp_root=self.config.temporary_dir,
            disallow_cache_fill=req.disallow_cache_fill,
            ignore_timestamp_macros=req.ignore_timestamp_macros,
            tenant_scope=req.env_desc.tenant_scope,
        )
        try:
            try:
                task.prepare(attachment)
            except ValueError as e:
                raise RpcError(api.daemon.DAEMON_STATUS_INVALID_ARGUMENT,
                               str(e))

            # Defensive dedup: an identical task already running here
            # can simply be joined (the delegate-side dedup usually
            # catches this first via ReferenceTask).
            existing = self.engine.find_task_by_digest(task.task_digest)
            if existing is not None and \
                    self.engine.reference_task(existing):
                task.workspace.remove()
                return api.daemon.QueueCxxCompilationTaskResponse(
                    task_id=existing)

            def on_completion(task_id: int, output):
                files, patches, cache_entry = task.collect_outputs(output)
                result = _TaskResult(
                    exit_code=output.exit_code,
                    standard_output=output.standard_output,
                    standard_error=output.standard_error,
                    files=files,
                    patches=patches,
                )
                with self._lock:
                    self._results[task_id] = result
                if cache_entry is not None and \
                        self.cache_writer is not None:
                    self.cache_writer.async_write(task.cache_key,
                                                  cache_entry)

            task_id = self.engine.try_queue_task(
                grant_id=req.task_grant_id,
                digest=task.task_digest,
                cmdline=task.cmdline,
                on_completion=on_completion,
                # Compile INSIDE the padded workspace: -g builds then
                # embed it as DW_AT_comp_dir, which patch-location
                # discovery finds and the client rewrites to its own
                # directory — debuggers on the client machine resolve
                # relative source names (reference pads the workspace
                # for exactly this, remote_task/
                # cxx_compilation_task.cc:78-92).
                cwd=task.workspace.path,
            )
            if task_id is None:
                raise RpcError(api.daemon.DAEMON_STATUS_HEAVILY_LOADED,
                               "servant saturated")
        except BaseException:
            # The RAM-backed workspace must die with the failed
            # submission — admission rejections, RPC mapping, and any
            # unexpected engine error alike (a handler crash turns
            # into a status frame upstream; nothing else would ever
            # reclaim /dev/shm space).
            if task.workspace is not None:
                task.workspace.remove()
            raise
        return api.daemon.QueueCxxCompilationTaskResponse(task_id=task_id)

    def _require_jit_env(self, req):
        """The intake gate of the worker task kinds (jit, AOT, autotune):
        a zstd attachment and an advertised jit environment.  A direct
        or stale-grant submission for a toolchain this servant does not
        serve is refused, not built into a library the requestor cannot
        use."""
        if req.compression_algorithm != \
                api.daemon.COMPRESSION_ALGORITHM_ZSTD:
            raise RpcError(api.daemon.DAEMON_STATUS_INVALID_ARGUMENT,
                           "only zstd attachments accepted")
        env = self._jit_env_digests.get(req.env_desc.compiler_digest)
        if env is None:
            raise RpcError(
                api.daemon.DAEMON_STATUS_ENVIRONMENT_NOT_AVAILABLE,
                req.env_desc.compiler_digest)
        return env

    def _queue_worker_task(self, task, grant_id: int, attachment):
        """Prepare and queue one worker task (jit, AOT, autotune) on the
        engine; returns the servant task id.  The cxx handler's
        defensive dedup, completion capture, cache fill and no-leak
        cleanup, for the three kinds."""
        try:
            try:
                task.prepare(attachment)
            except ValueError as e:
                raise RpcError(api.daemon.DAEMON_STATUS_INVALID_ARGUMENT,
                               str(e))
            existing = self.engine.find_task_by_digest(task.task_digest)
            if existing is not None and \
                    self.engine.reference_task(existing):
                task.workspace.remove()
                return existing

            def on_completion(task_id: int, output):
                files, patches, cache_entry = task.collect_outputs(output)
                result = _TaskResult(
                    exit_code=output.exit_code,
                    standard_output=output.standard_output,
                    standard_error=output.standard_error,
                    files=files,
                    patches=patches,
                )
                with self._lock:
                    self._results[task_id] = result
                if cache_entry is not None and \
                        self.cache_writer is not None:
                    self.cache_writer.async_write(task.cache_key,
                                                  cache_entry)

            task_id = self.engine.try_queue_task(
                grant_id=grant_id,
                digest=task.task_digest,
                cmdline=task.cmdline,
                on_completion=on_completion,
                env=task.worker_env(),
                cwd=task.workspace.path,
            )
            if task_id is None:
                raise RpcError(api.daemon.DAEMON_STATUS_HEAVILY_LOADED,
                               "servant saturated")
        except BaseException:
            if task.workspace is not None:
                task.workspace.remove()
            raise
        return task_id

    def QueueJitCompilationTask(self, req, attachment: bytes,
                                ctx: RpcContext):  # ytpu: untrusted(req, attachment)
        """A jit build on the engine that runs compilers, through the
        generic wait/free RPCs; only the submission is jit's own."""
        self._verify(req.token)
        env = self._require_jit_env(req)
        task = CloudJitCompilationTask(
            env_digest=env.digest,
            backend=req.backend or env.backend,
            compile_options=req.compile_options,
            claimed_computation_digest=req.computation_digest,
            temp_root=self.config.temporary_dir,
            disallow_cache_fill=req.disallow_cache_fill,
            tenant_scope=req.env_desc.tenant_scope,
        )
        task_id = self._queue_worker_task(task, req.task_grant_id,
                                          attachment)
        return api.jit.QueueJitCompilationTaskResponse(task_id=task_id)

    def QueueAotCompilationTask(self, req, attachment: bytes,
                                ctx: RpcContext):  # ytpu: untrusted(req, attachment)
        """One AOT fan-out child: the jit flow with the topology in the
        worker's options and in the cache identity."""
        self._verify(req.token)
        env = self._require_jit_env(req)
        if req.topology.device_count <= 0 or \
                not req.topology.mesh_shape:
            raise RpcError(api.daemon.DAEMON_STATUS_INVALID_ARGUMENT,
                           "aot submission names no topology")
        task = CloudAotCompilationTask(
            env_digest=env.digest,
            backend=req.backend or env.backend,
            mesh_shape=tuple(req.topology.mesh_shape),
            device_count=req.topology.device_count,
            compile_options=req.topology.compile_options,
            claimed_computation_digest=req.computation_digest,
            temp_root=self.config.temporary_dir,
            disallow_cache_fill=req.disallow_cache_fill,
            tenant_scope=req.env_desc.tenant_scope,
        )
        task_id = self._queue_worker_task(task, req.task_grant_id,
                                          attachment)
        return api.fanout.QueueAotCompilationTaskResponse(
            task_id=task_id)

    def QueueAutotuneTask(self, req, attachment: bytes,
                          ctx: RpcContext):  # ytpu: untrusted(req, attachment)
        """One autotune fan-out child: build a config slice; the artifact
        is the slice's winning-config record."""
        self._verify(req.token)
        env = self._require_jit_env(req)
        task = CloudAutotuneTask(
            env_digest=env.digest,
            backend=req.backend or env.backend,
            configs=list(req.configs),
            claimed_kernel_digest=req.kernel_digest,
            temp_root=self.config.temporary_dir,
            disallow_cache_fill=req.disallow_cache_fill,
            tenant_scope=req.env_desc.tenant_scope,
        )
        task_id = self._queue_worker_task(task, req.task_grant_id,
                                          attachment)
        return api.fanout.QueueAutotuneTaskResponse(task_id=task_id)

    def ReferenceTask(self, req, attachment, ctx):  # ytpu: untrusted(req, attachment)
        self._verify(req.token)
        if not self.engine.reference_task(req.task_id):
            raise RpcError(api.daemon.DAEMON_STATUS_TASK_NOT_FOUND,
                           str(req.task_id))
        return api.daemon.ReferenceTaskResponse()

    def _check_wait_request(self, req) -> None:
        """Validation shared by the sync and parked wait paths."""
        self._verify(req.token)
        if api.daemon.COMPRESSION_ALGORITHM_ZSTD not in list(
                req.acceptable_compression_algorithms or
                [api.daemon.COMPRESSION_ALGORITHM_ZSTD]):
            raise RpcError(api.daemon.DAEMON_STATUS_INVALID_ARGUMENT,
                           "peer cannot accept zstd")

    def _build_output_response(self, task_id: int, output,
                               ctx: RpcContext):
        """Turn a wait outcome into the response, shared by the sync
        and parked paths so their replies stay byte-identical
        (tested).  ``output`` is None while the task still runs."""
        resp = api.daemon.WaitForCompilationOutputResponse()
        if output is None:
            resp.status = api.daemon.COMPILATION_TASK_STATUS_RUNNING
            return resp
        with self._lock:
            result = self._results.get(task_id)
        if result is None:
            resp.status = api.daemon.COMPILATION_TASK_STATUS_FAILED
            return resp
        resp.status = api.daemon.COMPILATION_TASK_STATUS_DONE
        resp.exit_code = result.exit_code
        resp.standard_output = result.standard_output
        resp.standard_error = result.standard_error
        resp.compression_algorithm = api.daemon.COMPRESSION_ALGORITHM_ZSTD
        for ext, locs in result.patches.items():
            pl = resp.cxx_info.patches.add(file_key=ext)
            for pos, total, suffix in locs:
                pl.locations.add(position=pos, total_size=total,
                                 suffix_to_keep=suffix)
        # Gather attachment: the compressed output buffers ride as
        # payload segments; the transport flattens once at the socket.
        ctx.response_attachment = packing.pack_keyed_buffers_payload(
            result.files)
        return resp

    def WaitForCompilationOutput(self, req, attachment, ctx: RpcContext):  # ytpu: untrusted(req, attachment)
        self._check_wait_request(req)
        if not self.engine.is_known(req.task_id):
            resp = api.daemon.WaitForCompilationOutputResponse()
            resp.status = api.daemon.COMPILATION_TASK_STATUS_NOT_FOUND
            return resp
        output = self.engine.wait_for_task(
            req.task_id, clamp_wait_s(req.milliseconds_to_wait, 10.0))
        return self._build_output_response(req.task_id, output, ctx)

    # ytpu: loop-only
    def WaitForCompilationOutputParked(self, req, attachment, ctx,
                                       done):  # ytpu: untrusted(req, attachment)  # ytpu: responder(done)
        """Parked twin of WaitForCompilationOutput (aio front end
        only).  Runs ON the accept loop: validation raises inline,
        then the wait becomes an engine completion continuation plus a
        loop deadline timer.  A servant holding 5k peer waiters holds
        5k of these closures — zero pool threads.  ``done`` is
        reply-once; whichever of completion/deadline fires second is a
        counted no-op."""
        self._check_wait_request(req)
        if not self.engine.is_known(req.task_id):
            resp = api.daemon.WaitForCompilationOutputResponse()
            resp.status = api.daemon.COMPILATION_TASK_STATUS_NOT_FOUND
            done(resp)
            return
        replied: list = []
        deadline_timer: list = []

        def on_output(output) -> None:
            # Completion continuation: the engine's waiter thread (or
            # this loop, when the task already finished).  Response
            # assembly is CPU-only; the attachment pack is the same
            # work the sync path does on a pool thread.
            replied.append(True)
            if deadline_timer:
                deadline_timer[0].cancel()
            done(self._build_output_response(req.task_id, output, ctx))

        def on_deadline() -> None:
            # Same reply the sync path's timed-out wait produces.  Drop
            # our waiter from the engine table first: the peer re-polls
            # with a fresh request, so an expired continuation left
            # behind would accumulate (waiters × re-polls stale
            # closures on one slow compile).  Completion racing the
            # removal is settled by the reply-once responder.
            self.engine.cancel_wait(req.task_id, on_output)
            resp = api.daemon.WaitForCompilationOutputResponse()
            resp.status = api.daemon.COMPILATION_TASK_STATUS_RUNNING
            done(resp)

        if not self.engine.wait_for_task_async(req.task_id, on_output):
            # Freed/GC'd between is_known and registration: the sync
            # path's unknown-id answer.
            resp = api.daemon.WaitForCompilationOutputResponse()
            resp.status = api.daemon.COMPILATION_TASK_STATUS_NOT_FOUND
            done(resp)
            return
        if replied:
            return  # answered inline (task already complete); no timer
        # ONE clamp, shared with the sync path: the deadline timer
        # derives from the same clamp_wait_s(..., 10.0) the blocking
        # engine.wait_for_task call uses, so both front ends time out
        # identically.
        deadline_timer.append(self._frontend.call_later(
            clamp_wait_s(req.milliseconds_to_wait, 10.0), on_deadline))
        if replied:
            # Completion won the race while the timer was being armed;
            # done() already refused the second reply — just reap the
            # timer (cancel is idempotent).
            deadline_timer[0].cancel()

    def FreeTask(self, req, attachment, ctx):  # ytpu: untrusted(req, attachment)
        self._verify(req.token)
        if self.engine.free_task(req.task_id):
            # Fully released: no joined waiter still needs the result.
            with self._lock:
                self._results.pop(req.task_id, None)
        return api.daemon.FreeDaemonTaskResponse()

    # -- heartbeat pacemaker -------------------------------------------------

    def start_heartbeat(self) -> None:
        self._beat_thread = threading.Thread(
            target=self._beat_loop, name="heartbeat", daemon=True)
        self._beat_thread.start()

    def stop_heartbeat(self, graceful_leave: bool = True) -> None:
        self._stop.set()
        if self._beat_thread is not None:
            self._beat_thread.join(timeout=3)
        if graceful_leave:
            try:
                self.heartbeat_once(leaving=True)
            except RpcError:
                pass

    def _beat_loop(self) -> None:
        while not self._stop.wait(timeout=1.0):
            self.sampler.sample()
            try:
                self.heartbeat_once()
            except RpcError as e:
                logger.warning("heartbeat failed: %s", e)

    def _scheduler(self) -> Channel:
        if self._sched_channel is None:
            self._sched_channel = Channel(self.config.scheduler_uri)
        return self._sched_channel

    def heartbeat_once(self, leaving: bool = False) -> None:
        dedicated = self.config.servant_priority_dedicated
        capacity, reason = decide_capacity(
            self.sampler.nprocs, dedicated,
            allow_poor_machine=self._allow_poor,
            cgroup_present=self._cgroup,
        )
        if self.config.max_remote_tasks:
            capacity = min(capacity, self.config.max_remote_tasks) \
                if capacity else 0
        req = api.scheduler.HeartbeatRequest(
            token=self.config.token,
            next_heartbeat_in_ms=0 if leaving else 1000,
            version=VERSION_FOR_UPGRADE,
            location=self.config.location,
            num_processors=self.sampler.nprocs,
            current_load=self.sampler.loadavg(
                self.config.cpu_load_average_seconds),
            priority=(api.scheduler.SERVANT_PRIORITY_DEDICATED if dedicated
                      else api.scheduler.SERVANT_PRIORITY_USER),
            not_accepting_task_reason=reason,
            capacity=capacity if reason == 0 else 0,
            total_memory_in_bytes=read_memory_total(),
            memory_available_in_bytes=read_memory_available(),
        )
        for digest in self.registry.environments():
            req.env_descs.add(compiler_digest=digest)
        # Jit environments travel in the same list: to the scheduler an
        # environment is an opaque digest.
        for env in self._jit_envs:
            req.env_descs.add(compiler_digest=env.digest)
        for tid, grant_id, digest in self.engine.running_tasks():
            req.running_tasks.add(
                servant_task_id=tid, task_grant_id=grant_id,
                servant_location=self.config.location, task_digest=digest)
        resp, _ = self._scheduler().call(
            "ytpu.SchedulerService", "Heartbeat", req,
            api.scheduler.HeartbeatResponse, timeout=5.0)
        with self._lock:
            self._beats += 1
            self._last_beat = {
                "capacity": req.capacity, "current_load": req.current_load,
                "running": len(req.running_tasks),
                "not_accepting_reason": req.not_accepting_task_reason}
        if leaving:
            return
        with self._lock:
            if resp.acceptable_tokens:
                self._acceptable_tokens = set(resp.acceptable_tokens)
        if resp.expired_tasks:
            self.engine.kill_expired_tasks(list(resp.expired_tasks))
        self.engine.gc_completed_tasks()
        # Results must not outlive their engine-side task (the delegate
        # may never call FreeTask — crash, join path, GC race).
        with self._lock:
            self._results = {tid: r for tid, r in self._results.items()
                             if self.engine.is_known(tid)}

    # -- introspection -------------------------------------------------------

    def inspect(self) -> dict:
        with self._lock:
            beats, last = self._beats, dict(self._last_beat)
        return {
            "engine": self.engine.inspect(),
            "compilers": self.registry.environments(),
            "jit_environments": [
                {"backend": e.backend,
                 "toolchain_version": e.toolchain_version,
                 "digest": e.digest}
                for e in self._jit_envs
            ],
            "load": self.sampler.loadavg(
                self.config.cpu_load_average_seconds),
            "load_window_s": self.config.cpu_load_average_seconds,
            "heartbeats": beats,
            "last_heartbeat": last,
        }
