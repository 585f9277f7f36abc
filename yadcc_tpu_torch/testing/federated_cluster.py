"""Multi-cell federation rig with a warm standby on one cell (a copy of
the JAX package's yadcc_tpu/testing/federated_cluster.py over the port's
scheduler; every cell's dispatcher, and the dispatcher the standby
promotes, runs ``policy`` on ``device``).

The federated analogue of :class:`LocalCluster`: N scheduler cells,
each a real :class:`SchedulerService` over loopback gRPC fronting a
:class:`FederationRouter` over a SHARED ``CellHandle`` list, so
cross-cell spillover and foreign renew/free routing run over the same
in-process dispatcher objects production would reach by RPC.  One cell
(``replicate_cell``) runs the full warm-standby stack from
scheduler/replication.py: its dispatcher is wrapped in a
:class:`ReplicatingDispatcher`, a :class:`JournalStreamer` ships the
lease journal to a real standby server (receiver + gate specs), and a
:class:`StandbyMonitor` promotes the standby when the stream goes
silent.

Servants here are synthetic heartbeat loops, not full daemons — the
chaos under test lives entirely on the scheduler plane (grant leases,
journal replay, adoption), so the rig keeps the servant side to
exactly what the scheduler sees: periodic ``Heartbeat`` RPCs carrying
capacity and the currently-running grant ids.  Each servant dials its
cell through the same failover URI list (``active,standby``) the
scenario's storm clients use, so post-takeover re-registration rides
the identical wire path (tools/scenarios.py, cell-kill scenario).
The rig runs the port's scheduler, so it loads torch, as
testing/local_cluster.py does.

Chaos hook: :meth:`FederatedCluster.kill_active` stops the active
scheduler's listener and streamer mid-flight; the monitor's silence
timer then drives ``StandbyScheduler.takeover`` which replays the
mirror into a fresh dispatcher, swaps it into the shared
``CellHandle`` (peers' spillover follows automatically — the handle's
``dispatcher`` field is read at call time), and opens the gate on the
standby's port.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

from .. import api
from ..rpc import Channel, RpcError, make_rpc_server
from ..scheduler.admission import AdmissionConfig
from ..scheduler.federation import (CellDirectory, CellHandle,
                                    FederationRouter,
                                    grant_namespace_for_cell)
from ..scheduler.host_policy import make_policy
from ..scheduler.replication import (JournalStreamer, LeaseJournal,
                                     ReplicatingDispatcher,
                                     StandbyMonitor, StandbyScheduler)
from ..scheduler.service import SchedulerService
from ..scheduler.task_dispatcher import TaskDispatcher

__all__ = ["FederatedCluster"]


class _SyntheticServant:
    """A heartbeat loop impersonating one servant daemon.

    Reports a loopback location (fake port) so the scheduler's NAT
    check sees matching IPs, and mirrors the grant ids the scenario's
    workers register via :meth:`FederatedCluster.note_run_start` —
    that report is what the adoption grace window audits after a
    takeover (task_dispatcher.set_adoption_window)."""

    def __init__(self, cluster: "FederatedCluster", cell: int, idx: int,
                 capacity: int, env_digests: Sequence[str],
                 beat_ms: int = 500):
        self.location = f"127.0.0.1:{19000 + cell * 100 + idx}"
        self.cell = cell
        self._cluster = cluster
        self._capacity = capacity
        self._envs = tuple(env_digests)
        self._beat_ms = beat_ms
        self._stop = threading.Event()
        self._chan: Optional[Channel] = None
        self._thread = threading.Thread(
            target=self._run, name=f"fed-servant-{cell}-{idx}", daemon=True)

    def start(self) -> None:
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(timeout=3.0)
        if self._chan is not None:
            self._chan.close()

    def beat_once(self) -> bool:
        if self._chan is None:
            self._chan = Channel(self._cluster.cell_dial_uri(self.cell))
        req = api.scheduler.HeartbeatRequest(
            token="", version=1, location=self.location,
            num_processors=self._capacity, current_load=0,
            capacity=self._capacity,
            total_memory_in_bytes=64 << 30,
            memory_available_in_bytes=48 << 30,
            next_heartbeat_in_ms=self._beat_ms,
        )
        for env in self._envs:
            d = req.env_descs.add()
            d.compiler_digest = env
        for sid, (gid, digest) in enumerate(
                self._cluster.running_on(self.location)):
            t = req.running_tasks.add()
            t.servant_task_id = sid + 1
            t.task_grant_id = gid
            t.servant_location = self.location
            t.task_digest = digest
        try:
            self._chan.call("ytpu.SchedulerService", "Heartbeat", req,
                            api.scheduler.HeartbeatResponse, timeout=2.0)
            return True
        except RpcError:
            # Active down / standby not yet promoted: the daemon just
            # beats again next interval (daemon/cloud semantics).
            return False

    def _run(self) -> None:
        while not self._stop.wait(self._beat_ms / 1000.0):
            self.beat_once()


class FederatedCluster:
    """N scheduler cells + warm standby on ``replicate_cell``.

    Parameters mirror the scenario's needs: per-cell capacities and
    admission configs make one cell easy to overload (spillover
    demonstration) while its peer stays lazy."""

    def __init__(
        self,
        n_cells: int = 2,
        *,
        servants_per_cell: int = 2,
        servant_capacity: int = 2,
        env_digests: Sequence[str] = ("env-fed",),
        admission_configs: Optional[Sequence[
            Optional[AdmissionConfig]]] = None,
        replicate_cell: int = 0,
        streamer_interval_s: float = 0.05,
        standby_retry_after_ms: int = 100,
        heartbeat_ms: int = 500,
        policy: str = "greedy_cpu",
        device: str = "cuda",
    ):
        assert n_cells >= 1 and 0 <= replicate_cell < n_cells
        self.n_cells = n_cells
        self.replicate_cell = replicate_cell
        self.heartbeat_ms = heartbeat_ms
        # The promoted dispatcher runs the same policy on the same
        # device as the cell it replaces (see _make_dispatcher).
        self.policy = policy
        self.device = device
        cfgs = list(admission_configs or [None] * n_cells)
        # Kept for takeover: the promoted dispatcher must run the SAME
        # ladder the dead active ran, or restore_admission_rung lands
        # on different thresholds and the cell degrades differently
        # after failover than before.
        self._admission_configs = cfgs

        # Shared run-registry: servant location -> currently running
        # {grant_id: digest}.  Workers register runs; heartbeats report
        # them; the post-takeover adoption audit reads the reports.
        self._run_lock = threading.Lock()
        self._running: Dict[str, Dict[int, str]] = {}

        # -- cells: dispatcher (+ journal on the replicated cell) ------------
        self.handles: List[CellHandle] = []
        self.journal: Optional[LeaseJournal] = None
        self._inner_dispatchers: List[TaskDispatcher] = []
        for c in range(n_cells):
            inner = self._make_dispatcher(c)
            self._inner_dispatchers.append(inner)
            dispatcher: object = inner
            if c == replicate_cell:
                self.journal = LeaseJournal()
                dispatcher = ReplicatingDispatcher(inner, self.journal)
            self.handles.append(CellHandle(c, dispatcher, []))

        # -- per-cell router + service + loopback server ---------------------
        self.routers = [FederationRouter(self.handles, c, device=device)
                        for c in range(n_cells)]
        self.services = [SchedulerService(r) for r in self.routers]
        self.servers = []
        self.active_uris: List[str] = []
        for c in range(n_cells):
            srv = make_rpc_server("threaded", "127.0.0.1:0")
            srv.add_service(self.services[c].spec())
            srv.start()
            self.servers.append(srv)
            self.active_uris.append(f"grpc://127.0.0.1:{srv.port}")

        # -- warm standby for the replicated cell ----------------------------
        self.standby = StandbyScheduler(
            retry_after_ms=standby_retry_after_ms)
        self.standby_server = make_rpc_server("threaded", "127.0.0.1:0")
        self.standby_server.add_service(self.standby.receiver.spec())
        self.standby_server.add_service(self.standby.gate.spec())
        self.standby_server.start()
        self.standby_uri = f"grpc://127.0.0.1:{self.standby_server.port}"
        self.streamer = JournalStreamer(
            self.journal, self.standby_uri, interval_s=streamer_interval_s)
        self.streamer.start()

        # Dialing order: active first, standby second — FailoverChannel
        # (rpc/transport.py) rotates on transport failure.
        for c in range(n_cells):
            uris = [self.active_uris[c]]
            if c == replicate_cell:
                uris.append(self.standby_uri)
            self.handles[c].uris = uris
        self.directory = CellDirectory(
            [",".join(h.uris) for h in self.handles])

        self.promoted = threading.Event()
        self.takeover_report: Optional[dict] = None
        self.killed_at: Optional[float] = None
        self._monitor: Optional[StandbyMonitor] = None

        # -- synthetic servants ----------------------------------------------
        self.servants: List[_SyntheticServant] = []
        for c in range(n_cells):
            for i in range(servants_per_cell):
                self.servants.append(_SyntheticServant(
                    self, c, i, servant_capacity, env_digests,
                    beat_ms=heartbeat_ms))
        for s in self.servants:
            # Synchronous first beat so capacity exists before start.
            s.beat_once()
            s.start()
        deadline = time.time() + 10.0
        while time.time() < deadline and any(
                len(self.routers[c].inspect()["servants"])
                < servants_per_cell for c in range(n_cells)):
            time.sleep(0.05)

    def _make_dispatcher(self, cell: int) -> TaskDispatcher:
        """Cell ``cell``'s dispatcher: the rig's policy on its device,
        the cell's ladder and grant namespace.  The promoted standby
        builds its dispatcher here too."""
        start, stride = grant_namespace_for_cell(cell, self.n_cells)
        return TaskDispatcher(
            make_policy(self.policy, avoid_self=False, device=self.device),
            max_servants=16, batch_window_s=0.0,
            admission_config=self._admission_configs[cell],
            grant_id_start=start, grant_id_stride=stride)

    # -- run registry (worker <-> heartbeat handshake) -----------------------

    def note_run_start(self, location: str, grant_id: int,
                       digest: str = "tu") -> None:
        with self._run_lock:
            self._running.setdefault(location, {})[grant_id] = digest

    def note_run_end(self, location: str, grant_id: int) -> None:
        with self._run_lock:
            self._running.get(location, {}).pop(grant_id, None)

    def running_on(self, location: str) -> List[Tuple[int, str]]:
        with self._run_lock:
            return list(self._running.get(location, {}).items())

    # -- dialing -------------------------------------------------------------

    def cell_dial_uri(self, cell: int) -> str:
        """Comma list for FailoverChannel: active first, standby next."""
        return ",".join(self.handles[cell].uris)

    # -- chaos: kill + takeover ----------------------------------------------

    def arm_monitor(self, silence_s: float = 0.5) -> None:
        """Start the standby's liveness watch: after ``silence_s`` of
        journal-stream silence it runs the takeover exactly once."""
        self._monitor = StandbyMonitor(
            self.standby.receiver, self._takeover, silence_s=silence_s,
            poll_s=0.05)
        self._monitor.start()

    def kill_active(self, cell: Optional[int] = None) -> float:
        """Stop the replicated cell's active scheduler mid-flight:
        listener down with zero grace, streamer stopped (the silence
        the monitor is watching for).  Returns the kill timestamp."""
        cell = self.replicate_cell if cell is None else cell
        assert cell == self.replicate_cell, "only the replicated cell dies"
        self.streamer.stop()
        self.servers[cell].stop(grace=0)
        self.killed_at = time.monotonic()
        return self.killed_at

    def _takeover(self) -> None:
        cell = self.replicate_cell

        def dispatcher_factory():
            return self._make_dispatcher(cell)

        def service_factory(dispatcher):
            # Swap BEFORE the gate opens: the first request through the
            # promoted gate must already see peers routing to the new
            # dispatcher (CellHandle.dispatcher is read at call time).
            self.handles[cell].dispatcher = dispatcher
            return SchedulerService(FederationRouter(
                self.handles, cell, device=self.device))

        self.takeover_report = self.standby.takeover(
            dispatcher_factory, service_factory=service_factory,
            grace_s=max(10.0, self.heartbeat_ms / 1000.0 * 20))
        self.promoted.set()

    def wait_promoted(self, timeout_s: float = 10.0) -> bool:
        return self.promoted.wait(timeout_s)

    def drive_promoted(self, want: int = 1, timeout_s: float = 20.0,
                       pace_s: float = 0.05) -> dict:
        """Demand for the replicated cell's own servants through the
        promoted standby, after a takeover: WaitForStartingTask calls,
        one at a time, over the cell's dial list (the dead active
        first, the standby next) until the promoted dispatcher has
        granted ``want`` of them or ``timeout_s`` has passed; every
        grant is freed at once.

        The takeover restores the dead active's admission rung, so a
        scheduler killed mid-storm comes back at SPILLOVER and forwards
        each request to a peer cell until its ladder steps down.  The
        ladder moves only when a request or a sweep reaches it, so a
        storm that ends inside that window leaves the promoted
        scheduler with no grant of its own.  These calls are that
        demand: each one reaches the promoted ladder, and a spilled
        grant is counted and freed like a local one.

        Returns {"calls", "granted_here", "spilled", "granted_before",
        "granted_after"}; the last two are the promoted dispatcher's
        ``granted`` counter around the drive."""
        dispatcher = self.standby.dispatcher
        if dispatcher is None:
            raise RuntimeError("drive_promoted: the standby was never "
                               "promoted")
        cell = self.replicate_cell
        env = self.servants[0]._envs[0]
        before = dispatcher.inspect()["stats"]["granted"]
        out = {"calls": 0, "granted_here": 0, "spilled": 0}
        chan = Channel(self.cell_dial_uri(cell))
        deadline = time.monotonic() + timeout_s
        try:
            while (out["granted_here"] < want
                   and time.monotonic() < deadline):
                req = api.scheduler.WaitForStartingTaskRequest(
                    token="", milliseconds_to_wait=250, immediate_reqs=1,
                    next_keep_alive_in_ms=3000)
                req.env_desc.compiler_digest = env
                out["calls"] += 1
                try:
                    resp, _ = chan.call(
                        "ytpu.SchedulerService", "WaitForStartingTask",
                        req, api.scheduler.WaitForStartingTaskResponse,
                        timeout=2.5)
                except RpcError:
                    time.sleep(pace_s)
                    continue
                here = out["granted_here"]
                for g in resp.grants:
                    if g.spilled or g.cell_id != cell:
                        out["spilled"] += 1
                    else:
                        out["granted_here"] += 1
                    chan.call("ytpu.SchedulerService", "FreeTask",
                              api.scheduler.FreeTaskRequest(
                                  token="",
                                  task_grant_ids=[g.task_grant_id]),
                              api.scheduler.FreeTaskResponse, timeout=2.5)
                if out["granted_here"] == here:
                    time.sleep(pace_s)
        finally:
            chan.close()
        out["granted_before"] = before
        out["granted_after"] = dispatcher.inspect()["stats"]["granted"]
        return out

    # -- teardown ------------------------------------------------------------

    def stop(self) -> None:
        if self._monitor is not None:
            self._monitor.stop()
        for s in self.servants:
            s.stop()
        self.streamer.stop()
        for srv in self.servers:
            try:
                srv.stop(grace=0)
            except Exception:
                pass  # the killed cell's server is already down
        self.standby_server.stop(grace=0)
        for d in self._inner_dispatchers:
            d.stop()
        if (self.standby.dispatcher is not None
                and self.standby.dispatcher
                not in self._inner_dispatchers):
            self.standby.dispatcher.stop()
