"""The JAX package's federation and warm-standby scenarios on the port.

tests/test_federation.py's grant-namespace, lease-journal, standby-gate,
takeover, spillover, scored-spillover and scored-homing scenarios, run as
written on the port's modules over its in-process mock transport (the
scored placement on the CPU, through the kernel's plain version); then the
port against the JAX package: the same grant namespaces, the same homes
for 10,000 digests on both packages' cell directories and the same scored
homes, and the port's one difference by design: a failing scorer raises
and is counted instead of falling back to the least-loaded peer.  Every
quantity compared is an integer, an id or a verdict: the tolerance is
0."""

import json
import time

import numpy as np
import pytest

from yadcc_tpu.common import bloom as jbloom
from yadcc_tpu.scheduler import federation as jfed
from yadcc_tpu_torch import api
from yadcc_tpu_torch.common import bloom
from yadcc_tpu_torch.rpc import (Channel, RpcError, register_mock_server,
                                 retry_after_ms_from_error,
                                 unregister_mock_server)
from yadcc_tpu_torch.rpc.transport import STATUS_NOT_SERVING
from yadcc_tpu_torch.scheduler.admission import (FLOW_COMPILE_LOCALLY,
                                                 FLOW_NONE, FLOW_REJECT,
                                                 RUNG_LOCAL_ONLY,
                                                 RUNG_SPILLOVER)
from yadcc_tpu_torch.scheduler.federation import (CellDirectory, CellHandle,
                                                  FederationRouter,
                                                  cell_of_grant,
                                                  grant_namespace_for_cell)
from yadcc_tpu_torch.scheduler.policy import GreedyCpuPolicy
from yadcc_tpu_torch.scheduler.replication import (JournalStreamer,
                                                   LeaseJournal,
                                                   ReplicaState,
                                                   ReplicatingDispatcher,
                                                   StandbyScheduler)
from yadcc_tpu_torch.scheduler.task_dispatcher import (ServantInfo,
                                                       TaskDispatcher)
from yadcc_tpu_torch.utils.clock import VirtualClock

ENV = "deadbeef" * 8


def make_servant(location, capacity=4, envs=(ENV,), nprocs=32,
                 mem=64 << 30):
    return ServantInfo(location=location, version=1,
                       num_processors=nprocs, capacity=capacity,
                       total_memory=mem, memory_available=mem,
                       env_digests=tuple(envs))


def make_dispatcher(cell=0, n_cells=1, clock=None, **kw):
    start, stride = grant_namespace_for_cell(cell, n_cells)
    return TaskDispatcher(
        GreedyCpuPolicy(), max_servants=16, max_envs=16,
        clock=clock or VirtualClock(start=100.0),
        batch_window_s=0.0, grant_id_start=start, grant_id_stride=stride,
        **kw)


# --------------------------------------------------------------------------
# Two-level grant-id namespace.
# --------------------------------------------------------------------------


class TestGrantNamespace:
    def test_namespaces_partition_the_id_space(self):
        for n_cells, shards in ((2, 1), (3, 1), (2, 4), (5, 3)):
            seen = {}
            for c in range(n_cells):
                start, stride = grant_namespace_for_cell(c, n_cells,
                                                         shards)
                assert stride == n_cells * shards
                for shard in range(shards):
                    for k in range(16):
                        gid = start + shard + k * stride
                        assert gid not in seen, (n_cells, shards, gid)
                        seen[gid] = c
                        assert cell_of_grant(gid, n_cells, shards) == c
            # The first len(seen) positive integers are fully covered:
            # no id is unowned, none owned twice.
            assert set(seen) == set(range(1, len(seen) + 1))

    def test_two_dispatchers_issue_disjoint_ids(self):
        ds = [make_dispatcher(cell=c, n_cells=2) for c in range(2)]
        try:
            issued = {0: [], 1: []}
            for c, d in enumerate(ds):
                d.keep_servant_alive(make_servant(f"10.0.{c}.1:1"), 10)
                for _ in range(5):
                    (gid, _), = d.wait_for_starting_new_task(
                        ENV, timeout_s=1.0)
                    issued[c].append(gid)
                    d.free_task([gid])
            assert not set(issued[0]) & set(issued[1])
            for c in range(2):
                assert all(cell_of_grant(g, 2) == c for g in issued[c])
        finally:
            for d in ds:
                d.stop()

    def test_directory_homes_are_stable_and_in_range(self):
        d = CellDirectory(["mock://a", "mock://b", "mock://c"])
        homes = {f"env-{i}": d.home_cell(f"env-{i}") for i in range(64)}
        assert set(homes.values()) <= {0, 1, 2}
        # Deterministic: the same digest always homes identically.
        for env, home in homes.items():
            assert d.home_cell(env) == home
        assert d.uri(1) == "mock://b"


# --------------------------------------------------------------------------
# Lease journal + replica state machine.
# --------------------------------------------------------------------------


class TestLeaseJournal:
    def test_incremental_since_and_ack_progress(self):
        j = LeaseJournal()
        for i in range(5):
            j.append({"op": "rung", "rung": i})
        snap, snap_seq, entries = j.since(0)
        assert snap is None and len(entries) == 5
        assert entries[0][0] == 1 and entries[-1][0] == 5
        snap, _, entries = j.since(3)
        assert snap is None and [s for s, _ in entries] == [4, 5]
        assert j.since(5)[2] == []

    def test_compaction_serves_snapshot_to_lagging_standby(self):
        j = LeaseJournal(compact_keep=8)
        j.append({"op": "servant", "location": "s:1",
                  "info": dict(make_servant("s:1").__dict__,
                               env_digests=[ENV]),
                  "lease_s": 10.0})
        for i in range(100):
            j.append({"op": "issue", "env": ENV, "requestor": "r",
                      "lease_s": 15.0, "grants": [[i * 2 + 1, "s:1"]]})
        # A standby acked long before the compaction horizon: it gets
        # a snapshot plus only the retained tail.
        snap, snap_seq, entries = j.since(2)
        assert snap is not None
        state = ReplicaState.from_json(snap)
        assert state.seq == snap_seq
        assert "s:1" in state.servants
        assert all(isinstance(k, int) for k in state.grants)
        # Snapshot + tail reconstructs everything appended.
        for seq, entry in entries:
            state.apply(seq, entry)
        assert len(state.grants) == 100
        assert state.max_grant_id == 199
        # An up-to-date standby still gets plain increments.
        assert j.since(j.last_seq())[0] is None

    def test_replica_state_applies_full_lifecycle(self):
        st = ReplicaState()
        st.apply(1, {"op": "servant", "location": "s:1",
                     "info": dict(make_servant("s:1").__dict__,
                                  env_digests=[ENV]),
                     "lease_s": 10.0})
        st.apply(2, {"op": "issue", "env": ENV, "requestor": "r",
                     "lease_s": 15.0, "grants": [[1, "s:1"], [3, "s:1"]]})
        st.apply(3, {"op": "free", "ids": [1]})
        st.apply(4, {"op": "rung", "rung": RUNG_SPILLOVER})
        assert set(st.grants) == {3}
        assert st.rung == RUNG_SPILLOVER and st.max_grant_id == 3
        st.apply(5, {"op": "servant_leave", "location": "s:1"})
        assert not st.servants and not st.grants
        # JSON round trip preserves int grant keys.
        st2 = ReplicaState.from_json(st.to_json())
        assert st2.seq == 5 and st2.max_grant_id == 3


# --------------------------------------------------------------------------
# Standby refusals before replay (the gate).
# --------------------------------------------------------------------------


class TestStandbyGate:
    @pytest.fixture
    def standby(self):
        sb = StandbyScheduler(retry_after_ms=210)
        register_mock_server("fed-standby", sb.receiver.spec(),
                             sb.gate.spec())
        yield sb
        unregister_mock_server("fed-standby")

    def test_wait_for_starting_task_rejected_fast_with_retry_after(
            self, standby):
        chan = Channel("mock://fed-standby")
        req = api.scheduler.WaitForStartingTaskRequest(
            token="", milliseconds_to_wait=5000, immediate_reqs=1,
            next_keep_alive_in_ms=5000)
        req.env_desc.compiler_digest = ENV
        t0 = time.monotonic()
        resp, _ = chan.call("ytpu.SchedulerService", "WaitForStartingTask",
                            req, api.scheduler.WaitForStartingTaskResponse,
                            timeout=2.0)
        # The refusal is an immediate verdict — the standby must not
        # burn the 5s wait the client offered.
        assert time.monotonic() - t0 < 0.5
        assert resp.flow_control == FLOW_REJECT
        assert resp.retry_after_ms == 210
        assert not resp.grants

    def test_other_methods_raise_not_serving_with_inband_hint(
            self, standby):
        chan = Channel("mock://fed-standby")
        with pytest.raises(RpcError) as ei:
            chan.call("ytpu.SchedulerService", "KeepTaskAlive",
                      api.scheduler.KeepTaskAliveRequest(
                          token="", task_grant_ids=[1],
                          next_keep_alive_in_ms=5000),
                      api.scheduler.KeepTaskAliveResponse, timeout=2.0)
        assert ei.value.status == STATUS_NOT_SERVING
        assert retry_after_ms_from_error(ei.value) == 210
        with pytest.raises(RpcError) as ei:
            chan.call("ytpu.SchedulerService", "Heartbeat",
                      api.scheduler.HeartbeatRequest(
                          token="", location="s:1",
                          next_heartbeat_in_ms=500),
                      api.scheduler.HeartbeatResponse, timeout=2.0)
        assert ei.value.status == STATUS_NOT_SERVING


# --------------------------------------------------------------------------
# Takeover edge cases.
# --------------------------------------------------------------------------


class _Rig:
    """Active (replicating) + standby over the mock transport."""

    def __init__(self, name, cell=0, n_cells=1):
        self.cell, self.n_cells = cell, n_cells
        self.clock = VirtualClock(start=100.0)
        self.journal = LeaseJournal()
        self.inner = make_dispatcher(cell, n_cells, clock=self.clock)
        self.active = ReplicatingDispatcher(self.inner, self.journal)
        self.standby = StandbyScheduler()
        self.name = name
        register_mock_server(name, self.standby.receiver.spec(),
                             self.standby.gate.spec())
        self.streamer = JournalStreamer(self.journal, f"mock://{name}")
        self.fresh = None

    def ship(self):
        assert self.streamer.flush_once()

    def takeover(self, **kw):
        self.fresh = make_dispatcher(self.cell, self.n_cells,
                                     clock=self.clock)
        return self.standby.takeover(lambda: self.fresh, **kw)

    def stop(self):
        self.inner.stop()
        if self.fresh is not None:
            self.fresh.stop()
        self.streamer.stop()
        unregister_mock_server(self.name)


class TestTakeover:
    @pytest.fixture
    def rig(self):
        r = _Rig("fed-rig")
        yield r
        r.stop()

    def test_adopted_lease_renews_exactly_once_across_takeover(self, rig):
        rig.active.keep_servant_alive(make_servant("10.0.0.1:1"), 10)
        (gid, loc), = rig.active.wait_for_starting_new_task(
            ENV, timeout_s=1.0)
        rig.ship()
        report = rig.takeover()
        assert report["servants_replayed"] == 1
        assert report["grants_adopted"] == 1
        # The in-flight renewal lands on the promoted scheduler and
        # succeeds exactly once; after the free, the id is dead forever
        # (the restart-no-double-run contract).
        assert rig.fresh.keep_task_alive([gid], 15.0) == [True]
        rig.fresh.free_task([gid])
        assert rig.fresh.keep_task_alive([gid], 15.0) == [False]

    def test_journal_gap_grant_survives_via_heartbeat_rereport(self, rig):
        servant = make_servant("10.0.0.1:1")
        rig.active.keep_servant_alive(servant, 10)
        (g1, loc), = rig.active.wait_for_starting_new_task(
            ENV, timeout_s=1.0)
        rig.ship()
        # Issued AFTER the last shipped batch: dies with the active.
        (g2, _), = rig.active.wait_for_starting_new_task(
            ENV, timeout_s=1.0)
        report = rig.takeover()
        assert report["grants_adopted"] == 1  # only g1 was replicated
        assert report["adoption_floor"] == g1
        # Before the servant re-reports, the gap grant is unknown...
        assert rig.fresh.keep_task_alive([g2], 15.0) == [False]
        # ...but inside the grace window the servant's heartbeat
        # re-report adopts it instead of killing real work.
        rig.fresh.keep_servant_alive(servant, 10)
        kill = rig.fresh.notify_servant_running_tasks(
            "10.0.0.1:1", [g1, g2])
        assert kill == []
        assert rig.fresh.keep_task_alive([g2], 15.0) == [True]
        # And the promoted dispatcher can never re-issue the gap id.
        (g3, _), = rig.fresh.wait_for_starting_new_task(
            ENV, timeout_s=1.0)
        assert g3 not in (g1, g2) and g3 > g2

    def test_unknown_ids_killed_after_grace_window_closes(self, rig):
        servant = make_servant("10.0.0.1:1")
        rig.active.keep_servant_alive(servant, 10)
        rig.ship()
        rig.takeover(grace_s=5.0)
        rig.fresh.keep_servant_alive(servant, 10)
        rig.clock.advance(6.0)  # past the adoption window
        kill = rig.fresh.notify_servant_running_tasks("10.0.0.1:1", [7])
        assert kill == [7]
        assert rig.fresh.keep_task_alive([7], 15.0) == [False]

    def test_admission_rung_restored_on_promote(self, rig):
        rig.active.keep_servant_alive(make_servant("10.0.0.1:1"), 10)
        rig.inner.restore_admission_rung(RUNG_SPILLOVER)
        rig.active.on_expiration_timer()  # journals the rung change
        rig.ship()
        report = rig.takeover()
        assert report["restored_rung"] == RUNG_SPILLOVER
        assert rig.fresh.admission_rung() == RUNG_SPILLOVER

    def test_gate_forwards_after_promote(self, rig):
        rig.active.keep_servant_alive(make_servant("10.0.0.1:1"), 10)
        rig.ship()
        from yadcc_tpu_torch.scheduler.service import SchedulerService

        rig.takeover(service_factory=lambda d: SchedulerService(d))
        chan = Channel(f"mock://{rig.name}")
        req = api.scheduler.WaitForStartingTaskRequest(
            token="", milliseconds_to_wait=500, immediate_reqs=1,
            next_keep_alive_in_ms=5000)
        req.env_desc.compiler_digest = ENV
        resp, _ = chan.call("ytpu.SchedulerService", "WaitForStartingTask",
                            req, api.scheduler.WaitForStartingTaskResponse,
                            timeout=3.0)
        assert resp.flow_control == FLOW_NONE
        assert len(resp.grants) == 1

    def test_late_journal_batches_discarded_after_freeze(self, rig):
        rig.active.keep_servant_alive(make_servant("10.0.0.1:1"), 10)
        rig.ship()
        rig.takeover()
        # The dying active's last batch straggles in: the frozen
        # receiver must ack-and-discard, not mutate the promoted state.
        (gid, _), = rig.active.wait_for_starting_new_task(
            ENV, timeout_s=1.0)
        assert rig.streamer.flush_once()
        assert rig.fresh.keep_task_alive([gid], 15.0) == [False]

    def test_gap_heal_via_snapshot_after_missed_batch(self):
        # A standby that missed a batch (seq gap) refuses to apply,
        # acks its high-water mark, and the next ship self-heals with
        # a snapshot.
        sb = StandbyScheduler()
        register_mock_server("fed-gap", sb.receiver.spec())
        try:
            chan = Channel("mock://fed-gap")

            def ship(entries, snap=None, snap_seq=0):
                req = api.scheduler.ReplicateRequest(
                    token="", first_seq=entries[0][0],
                    entries_json=json.dumps(entries).encode(),
                )
                if snap is not None:
                    req.snapshot_json = snap.encode()
                    req.snapshot_seq = snap_seq
                resp, _ = chan.call("ytpu.ReplicationService", "Replicate",
                                    req, api.scheduler.ReplicateResponse,
                                    timeout=2.0)
                return resp.acked_seq

            assert ship([[1, {"op": "rung", "rung": 1}]]) == 1
            # Batch starting at 3: seq 2 was lost — no progress.
            assert ship([[3, {"op": "rung", "rung": 3}]]) == 1
            # The streamer reads the regressed ack and ships a snapshot.
            st = ReplicaState()
            for s in (1, 2, 3):
                st.apply(s, {"op": "rung", "rung": s})
            assert ship([[4, {"op": "rung", "rung": 4}]],
                        snap=st.to_json(), snap_seq=3) == 4
            assert sb.receiver.freeze().rung == 4
        finally:
            unregister_mock_server("fed-gap")


# --------------------------------------------------------------------------
# Spillover: the rung between SHED_OPTIONAL and LOCAL_ONLY.
# --------------------------------------------------------------------------


class TestSpillover:
    @pytest.fixture
    def plane(self):
        ds = [make_dispatcher(cell=c, n_cells=2) for c in range(2)]
        handles = [CellHandle(c, ds[c]) for c in range(2)]
        routers = [FederationRouter(handles, c, device="cpu")
                   for c in range(2)]
        for c, d in enumerate(ds):
            d.keep_servant_alive(make_servant(f"10.0.{c}.1:1"), 10)
        yield ds, handles, routers
        for d in ds:
            d.stop()

    def test_overloaded_cell_spills_before_local_only(self, plane):
        ds, _, routers = plane
        ds[0].restore_admission_rung(RUNG_SPILLOVER)
        # Admission still admits at the spillover rung — the ladder
        # hands the request to the router instead of shedding it.
        assert ds[0].admission_check(1, 0, "r").flow == FLOW_NONE
        routed = routers[0].wait_for_starting_new_task_routed(
            ENV, timeout_s=1.0)
        assert routed.grants, "spill must produce a grant"
        g = routed.grants[0]
        assert g.spilled and g.cell_id == 1
        assert cell_of_grant(g.grant_id, 2) == 1
        assert routers[0].stats()["spilled_grants"] == 1
        # One rung higher the cell stops taking work entirely — the
        # ordering that makes spillover "before LOCAL_ONLY".
        ds[0].restore_admission_rung(RUNG_LOCAL_ONLY)
        assert ds[0].admission_check(1, 0, "r").flow \
            == FLOW_COMPILE_LOCALLY

    def test_spilled_lease_upkeep_routes_home(self, plane):
        ds, _, routers = plane
        ds[0].restore_admission_rung(RUNG_SPILLOVER)
        routed = routers[0].wait_for_starting_new_task_routed(
            ENV, timeout_s=1.0)
        gid = routed.grants[0].grant_id
        # Renew and free through the HOME cell's router: both must
        # route to the issuing peer by grant-id arithmetic.
        assert routers[0].keep_task_alive([gid], 15.0) == [True]
        routers[0].free_task([gid])
        assert routers[0].keep_task_alive([gid], 15.0) == [False]
        stats = routers[0].stats()
        assert stats["foreign_renewals"] == 2
        assert stats["foreign_frees"] == 1
        # The peer's own books agree: the grant lived exactly once.
        assert ds[1].keep_task_alive([gid], 15.0) == [False]

    def test_no_spill_when_peer_is_also_shedding(self, plane):
        ds, _, routers = plane
        ds[0].restore_admission_rung(RUNG_SPILLOVER)
        ds[1].restore_admission_rung(RUNG_SPILLOVER)
        routed = routers[0].wait_for_starting_new_task_routed(
            ENV, timeout_s=1.0)
        # Falls through to the local pool instead of dogpiling a peer
        # that is itself shedding.
        assert all(not g.spilled for g in routed.grants)
        assert routers[0].stats()["spill_no_peer"] == 1

    def test_parked_submit_api_is_hidden(self, plane):
        _, _, routers = plane
        assert not hasattr(routers[0], "submit_wait_for_starting_new_task")

    def test_aio_front_end_serves_a_federated_service_blocking(self, plane):
        """The federated router hides the parked API even when its local
        dispatcher has it, so the service registers no parked handler and
        the aio server answers through the blocking one (its pool), with
        the spilled grant's cell in the reply."""
        from yadcc_tpu_torch.rpc.aio_server import AioRpcServer
        from yadcc_tpu_torch.scheduler.service import SchedulerService

        ds, _, routers = plane
        assert hasattr(ds[0], "submit_wait_for_starting_new_task")
        spec = SchedulerService(routers[0]).spec()
        assert spec.parked == {}
        ds[0].restore_admission_rung(RUNG_SPILLOVER)
        srv = AioRpcServer("127.0.0.1:0")
        srv.add_service(spec)
        chan = Channel(f"aio://127.0.0.1:{srv.port}")
        req = api.scheduler.WaitForStartingTaskRequest(
            token="", immediate_reqs=1, milliseconds_to_wait=1000)
        req.env_desc.compiler_digest = ENV
        try:
            resp, _ = chan.call("ytpu.SchedulerService",
                                "WaitForStartingTask", req,
                                api.scheduler.WaitForStartingTaskResponse,
                                timeout=10)
        finally:
            chan.close()
            srv.stop()
        assert [(g.cell_id, g.spilled) for g in resp.grants] == [(1, True)]
        assert resp.spilled_grants == 1 and resp.cell_id == 0
        assert srv.inspect()["double_replies"] == 0
        assert routers[0].stats()["spilled_grants"] == 1


# --------------------------------------------------------------------------
# Scored spill placement: warmth + load + topology in one launch
# (doc/scheduler.md "Federation", scheduler/placement.py).
# --------------------------------------------------------------------------

SPILL_KEYS = [f"spillkey-{i:02d}" for i in range(12)]


def _region_filter(keys, salt=777):
    f = bloom.SaltedBloomFilter(num_bits=1 << 15, num_hashes=7, salt=salt)
    if keys:
        f.add_many(list(keys))
    return f


class TestScoredSpillover:
    @pytest.fixture
    def plane3(self):
        clock = VirtualClock(100.0)
        ds = [make_dispatcher(cell=c, n_cells=3) for c in range(3)]
        handles = [CellHandle(c, ds[c]) for c in range(3)]
        router = FederationRouter(handles, 0, clock=clock, device="cpu")
        for c, d in enumerate(ds):
            d.keep_servant_alive(make_servant(f"10.0.{c}.1:1"), 10)
        yield ds, router, clock
        for d in ds:
            d.stop()

    def test_scored_spill_prefers_warm_busier_peer(self, plane3):
        ds, router, _ = plane3
        keys = SPILL_KEYS[:8]
        router.note_candidate_keys(ENV, keys)
        # Cell 1: warm for every candidate key, but half occupied.
        # Cell 2: verifiably cold (installed-but-empty filter), idle.
        # Least-loaded would pick 2; the affinity score must pick 1.
        router.update_cell_filter(1, _region_filter(keys, salt=11))
        router.update_cell_filter(2, _region_filter([], salt=22))
        held = ds[1].wait_for_starting_new_task(ENV, immediate=2,
                                                timeout_s=1.0)
        assert len(held) == 2
        ds[0].restore_admission_rung(RUNG_SPILLOVER)
        routed = router.wait_for_starting_new_task_routed(
            ENV, timeout_s=1.0)
        assert routed.grants and routed.grants[0].spilled
        assert routed.grants[0].cell_id == 1
        stats = router.stats()
        assert stats["placement_scored"] == 1
        assert stats["placement_fallback_least_loaded"] == 0
        assert stats["spilled_grants_by_peer"] == {1: 1}

    def test_no_warmth_data_falls_back_least_loaded(self, plane3):
        ds, router, _ = plane3
        # Keys noted but NO peer filter installed: the scored rung has
        # no warmth signal, so the ladder degrades to least-loaded —
        # cell 2 (idle) over cell 1 (half occupied).
        router.note_candidate_keys(ENV, SPILL_KEYS[:4])
        held = ds[1].wait_for_starting_new_task(ENV, immediate=2,
                                                timeout_s=1.0)
        assert len(held) == 2
        ds[0].restore_admission_rung(RUNG_SPILLOVER)
        routed = router.wait_for_starting_new_task_routed(
            ENV, timeout_s=1.0)
        assert routed.grants and routed.grants[0].spilled
        assert routed.grants[0].cell_id == 2
        stats = router.stats()
        assert stats["placement_scored"] == 0
        assert stats["placement_fallback_least_loaded"] == 1
        assert stats["spilled_grants_by_peer"] == {2: 1}

    def test_signal_cache_ttl_window(self, plane3):
        ds, router, clock = plane3
        ds[0].restore_admission_rung(RUNG_SPILLOVER)

        def spill_once():
            routed = router.wait_for_starting_new_task_routed(
                ENV, timeout_s=1.0)
            assert routed.grants
            router.free_task([g.grant_id for g in routed.grants])

        spill_once()                    # cold cache: one read per peer
        assert router.stats()["signal_refreshes"] == 2
        spill_once()                    # inside the TTL: pure cache
        stats = router.stats()
        assert stats["signal_refreshes"] == 2
        assert stats["signal_cache_hits"] >= 2
        clock.advance(0.2)              # past the ~100ms TTL
        spill_once()
        assert router.stats()["signal_refreshes"] == 4

    def test_inspect_surfaces_federation_block(self, plane3):
        ds, router, _ = plane3
        router.note_candidate_keys(ENV, SPILL_KEYS[:8])
        router.update_cell_filter(1, _region_filter(SPILL_KEYS[:8]))
        ds[0].restore_admission_rung(RUNG_SPILLOVER)
        routed = router.wait_for_starting_new_task_routed(
            ENV, timeout_s=1.0)
        assert routed.grants
        fed = router.inspect()["federation"]
        assert fed["cell_id"] == 0 and fed["n_cells"] == 3
        assert fed["stats"]["spilled_grants"] == 1
        placement = fed["latency_breakdown"]["placement"]
        assert placement["count"] >= 1
        assert placement["p99_ms"] >= 0.0
        # The split: the peer signals on every decision; the scorer's
        # call, its pack and its one native call on every scored one.
        parts = {k: v["count"] for k, v in fed["latency_breakdown"].items()
                 if k.startswith("placement_")}
        assert parts["placement_signals"] == placement["count"]
        scored = fed["stats"]["placement_scored"]
        assert scored == 1
        for k in ("score", "pack", "call"):
            assert parts.get(f"placement_{k}", 0) == scored
        assert set(parts) == {"placement_signals", "placement_score",
                              "placement_pack", "placement_call"}


class TestScoredCellHoming:
    def test_keyless_clients_keep_consistent_hash(self):
        d = CellDirectory(["mock://a", "mock://b", "mock://c"])
        for digest in ("env-a", "env-b", "env-c"):
            want = d.home_cell(digest)
            assert d.home_cell_scored(digest) == want
            assert d.home_cell_scored(digest, keys=["k1"]) == want
            assert d.home_cell_scored(
                digest, keys=["k1"], filters=[None, None, None]) == want

    def test_warm_cell_wins_when_filters_known(self):
        keys = [f"homekey-{i}" for i in range(6)]
        warm = _region_filter(keys, salt=5)
        d = CellDirectory(["mock://a", "mock://b"])
        assert d.home_cell_scored("any-env", keys=keys,
                                  filters=[None, warm]) == 1
        assert d.home_cell_scored("any-env", keys=keys,
                                  filters=[warm, None]) == 0
        # Equal warmth ties back to the lowest cell, regardless of
        # where the consistent hash would have landed.
        assert d.home_cell_scored("any-env", keys=keys,
                                  filters=[warm, warm]) == 0


# --------------------------------------------------------------------------
# The port against the JAX package.
# --------------------------------------------------------------------------


@pytest.mark.parametrize("n_cells,shards", [(2, 1), (3, 1), (2, 4), (5, 3)])
def test_grant_namespace_matches_jax(n_cells, shards):
    for c in range(n_cells):
        assert grant_namespace_for_cell(c, n_cells, shards) == \
            jfed.grant_namespace_for_cell(c, n_cells, shards)
    for gid in range(1, 200):
        assert cell_of_grant(gid, n_cells, shards) == \
            jfed.cell_of_grant(gid, n_cells, shards)


def test_cell_directory_homes_match_jax_over_10000_digests():
    rng = np.random.default_rng(17)
    digests = ["".join("0123456789abcdef"[i] for i in rng.integers(0, 16, 64))
               for _ in range(10_000)]
    for n in (1, 3, 8):
        uris = [f"grpc://10.0.0.{i}:8336" for i in range(n)]
        t, j = CellDirectory(uris), jfed.CellDirectory(uris)
        homes = [t.home_cell(d) for d in digests]
        assert homes == [j.home_cell(d) for d in digests]
        assert set(homes) == set(range(n))


def test_scored_homes_match_jax():
    rng = np.random.default_rng(23)
    universe = [f"homekey-{i:03d}" for i in range(48)]
    for trial in range(6):
        n = int(rng.integers(2, 5))
        tf, jf = [], []
        for c in range(n):
            if rng.random() < 0.25:
                tf.append(None)
                jf.append(None)
                continue
            members = [universe[i] for i in
                       rng.choice(48, int(rng.integers(0, 30)),
                                  replace=False)]
            salt = int(rng.integers(0, 1 << 62))
            for mod, out in ((bloom, tf), (jbloom, jf)):
                f = mod.SaltedBloomFilter(num_bits=1 << 14, num_hashes=7,
                                          salt=salt)
                if members:
                    f.add_many(members)
                out.append(f)
        keys = [universe[i] for i in rng.choice(48, 8, replace=False)]
        utils = [float(u) for u in rng.uniform(0, 2, n)]
        uris = [f"mock://c{i}" for i in range(n)]
        got = CellDirectory(uris).home_cell_scored(
            f"env-{trial}", keys=keys, filters=tf, utilizations=utils)
        assert got == jfed.CellDirectory(uris).home_cell_scored(
            f"env-{trial}", keys=keys, filters=jf, utilizations=utils)


class _FailingScorer:
    def __init__(self):
        self.installed = []

    def install(self, cell_id, snapshot):
        self.installed.append(cell_id)

    def score(self, cells, keys_per_task):
        raise RuntimeError("device lost")


def test_scorer_failure_raises_and_is_counted():
    """No fallback hides the device: the JAX router would log and take
    the least-loaded peer; the port's raises and counts the failure."""
    ds = [make_dispatcher(cell=c, n_cells=3) for c in range(3)]
    scorer = _FailingScorer()
    router = FederationRouter([CellHandle(c, ds[c]) for c in range(3)], 0,
                              placement_scorer=scorer, device="cpu")
    try:
        for c, d in enumerate(ds):
            d.keep_servant_alive(make_servant(f"10.0.{c}.1:1"), 10)
        router.note_candidate_keys(ENV, SPILL_KEYS[:4])
        router.update_cell_filter(1, _region_filter(SPILL_KEYS[:4]))
        assert scorer.installed == [1]
        ds[0].restore_admission_rung(RUNG_SPILLOVER)
        with pytest.raises(RuntimeError, match="device lost"):
            router.wait_for_starting_new_task_routed(ENV, timeout_s=1.0)
        stats = router.stats()
        assert stats["placement_failures"] == 1
        assert stats["placement_fallback_least_loaded"] == 0
        assert stats["spilled_grants"] == 0
    finally:
        for d in ds:
            d.stop()


def test_installed_snapshots_stay_resident_on_the_scorer():
    ds = [make_dispatcher(cell=c, n_cells=3) for c in range(3)]
    router = FederationRouter([CellHandle(c, ds[c]) for c in range(3)], 0,
                              device="cpu")
    try:
        snap = _region_filter(SPILL_KEYS[:4], salt=5)
        router.update_cell_filter(1, snap)
        router.update_cell_filter(2, _region_filter([], salt=6))
        scorer = router._scorer_obj()
        assert scorer.resident_cells() == [1, 2]
        words = scorer._words(1, snap)
        assert scorer._words(1, snap) is words     # no second upload
        router.update_cell_filter(2, None)
        assert scorer.resident_cells() == [1]
    finally:
        for d in ds:
            d.stop()
