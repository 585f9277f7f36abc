"""SchedulerService RPC implementation.

Parity with reference yadcc/scheduler/scheduler_service_impl.{h,cc}:
token verification, NAT detection (observed vs reported endpoint forces
capacity 0), serving-daemon token rotation (3-token rolling window,
rotated hourly), version gating, the immediate+prefetch grant loop, and
heartbeat-driven registry upkeep.  Given a ``tenancy=`` control, a grant
request must carry a verifiable tenant credential, and the verified
tenant rides admission and the grant path (tenancy/).  In front of a
ShardRouter, the home shard is resolved once a request, and the reply
carries each grant's shard and whether it was stolen (behind a
FederationRouter also its cell and whether it was spilled there).  On the
aio front end ``WaitForStartingTask`` is served by a parked twin
(``WaitForStartingTaskParked``): the waiting delegate is a continuation
in the dispatcher's pending table, not a worker thread.
"""

from __future__ import annotations

import threading
from typing import List

from .. import api
from ..common.token_verifier import TokenVerifier, generate_token
from ..rpc import RpcContext, RpcError, ServiceSpec
from ..rpc.transport import STATUS_TRANSPORT_FAILURE
from . import admission
from ..utils.clock import REAL_CLOCK, Clock
from ..utils.logging import get_logger
from ..utils.stagetimer import StageTimer
from .running_task_bookkeeper import RunningTaskBookkeeper, RunningTaskRecord
from .task_dispatcher import DispatcherFailed, ServantInfo, TaskDispatcher

logger = get_logger("scheduler.service")

SERVICE_NAME = "ytpu.SchedulerService"

_MAX_WAIT_MS = 10_000
_MAX_LEASE_MS = 30_000
_TOKEN_ROTATION_S = 3600.0
_TOKEN_WINDOW = 3  # live tokens (reference :46-51,320-333)


class ServingDaemonTokenRoll:
    """Rotating token delegates use to talk to servants.  A window of the
    last N tokens stays acceptable so rotation never races in-flight
    tasks."""

    def __init__(self, clock: Clock = REAL_CLOCK,
                 rotation_s: float = _TOKEN_ROTATION_S):
        self._clock = clock
        self._rotation_s = rotation_s
        self._lock = threading.Lock()
        self._tokens: List[str] = [
            generate_token() for _ in range(_TOKEN_WINDOW)
        ]  # guarded by: self._lock
        self._last_rotation = clock.now()  # guarded by: self._lock

    def _maybe_rotate_locked(self) -> None:
        now = self._clock.now()
        while now - self._last_rotation >= self._rotation_s:
            self._tokens = [generate_token()] + self._tokens[: _TOKEN_WINDOW - 1]
            self._last_rotation += self._rotation_s

    def current(self) -> str:
        with self._lock:
            self._maybe_rotate_locked()
            return self._tokens[0]

    def acceptable(self) -> List[str]:
        with self._lock:
            self._maybe_rotate_locked()
            return list(self._tokens)

    def verify(self, token: str) -> bool:
        return token in self.acceptable()


class SchedulerService:
    def __init__(
        self,
        dispatcher: TaskDispatcher,
        *,
        user_tokens: TokenVerifier = TokenVerifier(),
        servant_tokens: TokenVerifier = TokenVerifier(),
        min_daemon_version: int = 0,
        clock: Clock = REAL_CLOCK,
        token_rotation_s: float = _TOKEN_ROTATION_S,
        # Multi-tenant QoS: a tenancy.TenancyControl.  When set,
        # WaitForStartingTask requires a verifiable tenant credential —
        # fail-closed: missing or invalid credentials are ACCESS_DENIED,
        # never silently downgraded to anonymous.
        tenancy=None,
    ):
        self.dispatcher = dispatcher
        self.bookkeeper = RunningTaskBookkeeper()
        self.daemon_tokens = ServingDaemonTokenRoll(clock, token_rotation_s)
        self._user_tokens = user_tokens
        self._servant_tokens = servant_tokens
        self._min_version = min_daemon_version
        self.tenancy = tenancy
        # RPC-side stages of the grant path (<Method>:handler /
        # <Method>:serialize, recorded by rpc.transport.dispatch_frame);
        # the dispatcher's own stage_timer covers queue-wait -> apply.
        self.stage_timer = StageTimer(maxlen=16384)

    # -- wiring ------------------------------------------------------------

    def spec(self) -> ServiceSpec:
        s = ServiceSpec(SERVICE_NAME, stage_timer=self.stage_timer)
        s.add("Heartbeat", api.scheduler.HeartbeatRequest, self.Heartbeat)
        s.add("GetConfig", api.scheduler.GetConfigRequest, self.GetConfig)
        s.add("WaitForStartingTask", api.scheduler.WaitForStartingTaskRequest,
              self.WaitForStartingTask)
        s.add("KeepTaskAlive", api.scheduler.KeepTaskAliveRequest,
              self.KeepTaskAlive)
        s.add("FreeTask", api.scheduler.FreeTaskRequest, self.FreeTask)
        s.add("GetRunningTasks", api.scheduler.GetRunningTasksRequest,
              self.GetRunningTasks)
        # Parked long-poll twin for the aio front end: a waiting
        # delegate is a pending-table entry plus the loop's
        # continuation, not a parked worker thread.  Registered only
        # when the dispatcher has the submit API — plain dispatchers
        # and the sharded router do (the router chains its donor waits
        # as continuations too); the federated router hides it.
        if hasattr(self.dispatcher, "submit_wait_for_starting_new_task"):
            s.add_parked("WaitForStartingTask",
                         api.scheduler.WaitForStartingTaskRequest,
                         self.WaitForStartingTaskParked)
        return s

    # -- handlers ----------------------------------------------------------

    def _resolve_tenant(self, req):
        """(tenant_id, tier) for a grant request, or raise.

        Tenancy disabled -> ("", "") — the legacy untenanted path.
        Tenancy enabled  -> the credential must verify against the
        serving-token window (fail-closed: absent and invalid are the
        same ACCESS_DENIED; an attacker must not learn which)."""
        if self.tenancy is None:
            return "", ""
        binding = self.tenancy.authenticate(req.tenant_credential)
        if binding is None:
            raise RpcError(api.scheduler.SCHEDULER_STATUS_ACCESS_DENIED,
                           "valid tenant credential required")
        return binding.tenant_id, binding.tier

    def Heartbeat(self, req, attachment: bytes, ctx: RpcContext):
        if not self._servant_tokens.verify(req.token):
            raise RpcError(api.scheduler.SCHEDULER_STATUS_ACCESS_DENIED,
                           "bad servant token")
        if req.version < self._min_version:
            raise RpcError(api.scheduler.SCHEDULER_STATUS_VERSION_TOO_OLD,
                           f"daemon version {req.version} < "
                           f"{self._min_version}")

        not_accepting = req.not_accepting_task_reason
        observed_ip = ctx.peer.rsplit(":", 1)[0]
        reported_ip = req.location.rsplit(":", 1)[0]
        if observed_ip and reported_ip and observed_ip != reported_ip:
            # NAT detection (reference scheduler_service_impl.cc:83-153):
            # a servant whose observed address differs from what it
            # reports is unreachable by peers; keep it registered but
            # never schedule onto it.
            not_accepting = (
                api.scheduler.NOT_ACCEPTING_TASK_REASON_BEHIND_NAT
            )

        info = ServantInfo(
            location=req.location,
            version=req.version,
            num_processors=req.num_processors,
            current_load=req.current_load,
            dedicated=(req.priority
                       == api.scheduler.SERVANT_PRIORITY_DEDICATED),
            not_accepting_reason=not_accepting,
            capacity=req.capacity if not not_accepting else 0,
            total_memory=req.total_memory_in_bytes,
            memory_available=req.memory_available_in_bytes,
            env_digests=tuple(e.compiler_digest for e in req.env_descs),
        )
        if req.next_heartbeat_in_ms == 0:
            # Graceful leave (reference daemon_service_impl.cc:183-186).
            self.dispatcher.keep_servant_alive(info, expires_in_s=0)
            self.bookkeeper.drop_servant(req.location)
            return api.scheduler.HeartbeatResponse()
        # Lease = 10x the promised beat interval (reference: 1s beat,
        # 10s lease — daemon_service_impl.cc:57-58).
        if not self.dispatcher.keep_servant_alive(
            info, expires_in_s=req.next_heartbeat_in_ms / 1000.0 * 10
        ):
            # Registry full: fail the beat loudly rather than answering
            # success and then condemning every task the servant reported.
            raise RpcError(
                api.scheduler.SCHEDULER_STATUS_NO_QUOTA_AVAILABLE,
                "servant registry full")

        self.bookkeeper.set_servant_running_tasks(
            req.location,
            [
                RunningTaskRecord(
                    servant_task_id=t.servant_task_id,
                    task_grant_id=t.task_grant_id,
                    servant_location=t.servant_location or req.location,
                    task_digest=t.task_digest,
                )
                for t in req.running_tasks
            ],
        )
        expired = self.dispatcher.notify_servant_running_tasks(
            req.location, [t.task_grant_id for t in req.running_tasks]
        )
        resp = api.scheduler.HeartbeatResponse()
        resp.acceptable_tokens.extend(self.daemon_tokens.acceptable())
        resp.expired_tasks.extend(expired)
        return resp

    def GetConfig(self, req, attachment, ctx):
        if not self._user_tokens.verify(req.token):
            raise RpcError(api.scheduler.SCHEDULER_STATUS_ACCESS_DENIED,
                           "bad user token")
        return api.scheduler.GetConfigResponse(
            serving_daemon_token=self.daemon_tokens.current()
        )

    def WaitForStartingTask(self, req, attachment, ctx):
        if not self._user_tokens.verify(req.token):
            raise RpcError(api.scheduler.SCHEDULER_STATUS_ACCESS_DENIED,
                           "bad user token")
        wait_ms = min(req.milliseconds_to_wait or 5000, _MAX_WAIT_MS)
        lease_ms = min(req.next_keep_alive_in_ms or 15000, _MAX_LEASE_MS)
        if not req.env_desc.compiler_digest:
            raise RpcError(api.scheduler.SCHEDULER_STATUS_INVALID_ARGUMENT,
                           "missing env_desc")
        # Sharded control plane: resolve the home shard ONCE for the
        # whole request so the admission ruling and the grant path land
        # on the same shard's ladder (an anonymous peer is routed
        # round-robin — two separate resolutions would rule on one
        # shard and queue on another).  A plain dispatcher has no
        # resolve_home.
        resolve_home = getattr(self.dispatcher, "resolve_home", None)
        home = (resolve_home(ctx.peer, req.env_desc.compiler_digest)
                if resolve_home is not None else None)
        # Tenancy: resolve the verified tenant BEFORE admission — the
        # per-tenant budget and tier shed ride the admission ruling.
        tenant, tier = self._resolve_tenant(req)
        # Overload ladder: rule BEFORE the request queues.  Shedding is
        # never silent — LOCAL_ONLY and REJECT answer immediately with
        # an explicit verdict (+ retry-after), SHED_OPTIONAL drops only
        # the opportunistic prefetch.
        decision = self.dispatcher.admission_check(
            immediate=req.immediate_reqs or 1,
            prefetch=req.prefetch_reqs,
            requestor=ctx.peer,
            tenant=tenant, tier=tier,
            **({} if home is None else {"home": home}))
        if decision.flow != admission.FLOW_NONE:
            return api.scheduler.WaitForStartingTaskResponse(
                flow_control=decision.flow,
                retry_after_ms=decision.retry_after_ms,
                degradation_rung=decision.rung)
        wait_kw = dict(
            min_version=max(req.min_version, self._min_version),
            requestor=ctx.peer,
            immediate=req.immediate_reqs or 1,
            prefetch=req.prefetch_reqs if decision.prefetch_allowed else 0,
            lease_s=lease_ms / 1000.0,
            timeout_s=wait_ms / 1000.0,
            tenant=tenant,
        )
        if home is not None:
            # The router may pull grants from donor shards; the
            # provenance rides the response.
            routed = self.dispatcher.wait_for_starting_new_task_routed(
                req.env_desc.compiler_digest, home=home, **wait_kw)
            if not routed.grants:
                raise RpcError(
                    api.scheduler.SCHEDULER_STATUS_NO_QUOTA_AVAILABLE,
                    "no capacity for environment")
            resp = api.scheduler.WaitForStartingTaskResponse(
                degradation_rung=decision.rung,
                shard_id=routed.shard_id,
                stolen_grants=routed.stolen_count,
                cell_id=routed.cell_id,
                spilled_grants=routed.spilled_count)
            for g in routed.grants:
                resp.grants.add(task_grant_id=g.grant_id,
                                servant_location=g.servant_location,
                                shard_id=g.shard_id, stolen=g.stolen,
                                cell_id=g.cell_id, spilled=g.spilled)
            return resp
        grants = self.dispatcher.wait_for_starting_new_task(
            req.env_desc.compiler_digest, **wait_kw)
        if not grants:
            raise RpcError(
                api.scheduler.SCHEDULER_STATUS_NO_QUOTA_AVAILABLE,
                "no capacity for environment")
        resp = api.scheduler.WaitForStartingTaskResponse(
            degradation_rung=decision.rung)
        for gid, location in grants:
            resp.grants.add(task_grant_id=gid, servant_location=location)
        return resp

    def WaitForStartingTaskParked(self, req, attachment, ctx, done):
        """Parked-continuation WaitForStartingTask (aio front end).

        Validation, tenancy, the admission ruling and the enqueue run
        inline on the event loop; the grant wait itself is a parked
        pending-table entry whose continuation the completing dispatch
        thread fires.  Clamps, verdicts, the routed fields and NO_QUOTA
        on an empty answer are the blocking handler's.  After a policy
        failure the answer is the error the blocking handler raises."""
        if not self._user_tokens.verify(req.token):
            raise RpcError(api.scheduler.SCHEDULER_STATUS_ACCESS_DENIED,
                           "bad user token")
        wait_ms = min(req.milliseconds_to_wait or 5000, _MAX_WAIT_MS)
        lease_ms = min(req.next_keep_alive_in_ms or 15000, _MAX_LEASE_MS)
        if not req.env_desc.compiler_digest:
            raise RpcError(api.scheduler.SCHEDULER_STATUS_INVALID_ARGUMENT,
                           "missing env_desc")
        # One home resolution for admission AND the grant path, as in
        # the blocking handler.
        resolve_home = getattr(self.dispatcher, "resolve_home", None)
        home = (resolve_home(ctx.peer, req.env_desc.compiler_digest)
                if resolve_home is not None else None)
        tenant, tier = self._resolve_tenant(req)
        decision = self.dispatcher.admission_check(
            immediate=req.immediate_reqs or 1,
            prefetch=req.prefetch_reqs,
            requestor=ctx.peer,
            tenant=tenant, tier=tier,
            **({} if home is None else {"home": home}))
        if decision.flow != admission.FLOW_NONE:
            done(api.scheduler.WaitForStartingTaskResponse(
                flow_control=decision.flow,
                retry_after_ms=decision.retry_after_ms,
                degradation_rung=decision.rung))
            return
        wait_kw = dict(
            min_version=max(req.min_version, self._min_version),
            requestor=ctx.peer,
            immediate=req.immediate_reqs or 1,
            prefetch=req.prefetch_reqs if decision.prefetch_allowed else 0,
            lease_s=lease_ms / 1000.0,
            timeout_s=wait_ms / 1000.0,
            tenant=tenant,
        )

        def refused(grants) -> bool:
            """Answer the failure or the empty wait; True when answered."""
            failure = getattr(self.dispatcher, "failure", None)
            if failure is not None:
                err = DispatcherFailed(
                    f"dispatcher stopped after a policy failure: "
                    f"{failure!r}")
                done(None, error=RpcError(STATUS_TRANSPORT_FAILURE,
                                          f"handler error: {err!r}"))
                return True
            if not grants:
                done(None, error=RpcError(
                    api.scheduler.SCHEDULER_STATUS_NO_QUOTA_AVAILABLE,
                    "no capacity for environment"))
                return True
            return False

        if home is not None:
            # Routed planes park with full provenance: the continuation
            # receives RoutedGrants (donor ops chained as continuations
            # inside the router).
            def on_routed(routed):
                if refused(routed.grants):
                    return
                resp = api.scheduler.WaitForStartingTaskResponse(
                    degradation_rung=decision.rung,
                    shard_id=routed.shard_id,
                    stolen_grants=routed.stolen_count,
                    cell_id=routed.cell_id,
                    spilled_grants=routed.spilled_count)
                for g in routed.grants:
                    resp.grants.add(task_grant_id=g.grant_id,
                                    servant_location=g.servant_location,
                                    shard_id=g.shard_id, stolen=g.stolen,
                                    cell_id=g.cell_id, spilled=g.spilled)
                done(resp)

            self.dispatcher.submit_wait_for_starting_new_task_routed(
                req.env_desc.compiler_digest, home=home, on_done=on_routed,
                **wait_kw)
            return

        def on_grants(grants):
            if refused(grants):
                return
            resp = api.scheduler.WaitForStartingTaskResponse(
                degradation_rung=decision.rung)
            for gid, location in grants:
                resp.grants.add(task_grant_id=gid, servant_location=location)
            done(resp)

        self.dispatcher.submit_wait_for_starting_new_task(
            req.env_desc.compiler_digest, on_done=on_grants, **wait_kw)

    def KeepTaskAlive(self, req, attachment, ctx):
        if not self._user_tokens.verify(req.token):
            raise RpcError(api.scheduler.SCHEDULER_STATUS_ACCESS_DENIED,
                           "bad user token")
        statuses = self.dispatcher.keep_task_alive(
            list(req.task_grant_ids),
            (req.next_keep_alive_in_ms or 15000) / 1000.0,
        )
        resp = api.scheduler.KeepTaskAliveResponse()
        resp.statuses.extend(statuses)
        return resp

    def FreeTask(self, req, attachment, ctx):
        if not self._user_tokens.verify(req.token):
            raise RpcError(api.scheduler.SCHEDULER_STATUS_ACCESS_DENIED,
                           "bad user token")
        self.dispatcher.free_task(list(req.task_grant_ids))
        return api.scheduler.FreeTaskResponse()

    def GetRunningTasks(self, req, attachment, ctx):
        resp = api.scheduler.GetRunningTasksResponse()
        for t in self.bookkeeper.get_running_tasks():
            resp.running_tasks.add(
                servant_task_id=t.servant_task_id,
                task_grant_id=t.task_grant_id,
                servant_location=t.servant_location,
                task_digest=t.task_digest,
            )
        return resp
