"""The port's federated rig (yadcc_tpu_torch/testing/federated_cluster.py)
against the JAX package's: two cells over loopback, a warm standby on
cell 0, driven by the same seeded grant, renew and free calls, then the
active of cell 0 killed and the standby promoted.  The rigs agree on the
promotion, on every lease held across the kill renewing on the promoted
scheduler, and on no grant id issued twice; the promoted dispatcher runs
the policy the rig was given, on its device."""

from __future__ import annotations

import random
import time

import pytest

import yadcc_tpu
import yadcc_tpu_torch
from yadcc_tpu.testing import FederatedCluster as JaxRig
from yadcc_tpu_torch.testing import FederatedCluster as PortRig

ENV = "env-fed"


def _call(pkg, chan, method, req_name, resp_name, **kw):
    req = getattr(pkg.api.scheduler, req_name)(token="", **kw)
    resp, _ = chan.call("ytpu.SchedulerService", method, req,
                        getattr(pkg.api.scheduler, resp_name), timeout=5.0)
    return resp


def drive(pkg, rig, seed: int = 5) -> dict:
    """Seeded calls on both cells, a kill of cell 0's active, the
    promotion, and a renewal of every lease held across it."""
    rng = random.Random(seed)
    chans = {c: pkg.rpc.Channel(rig.cell_dial_uri(c)) for c in (0, 1)}
    issued, held = [], []
    renewed_before = 0
    try:
        for _ in range(24):
            cell = rng.choice((0, 1))
            op = rng.random()
            if op < 0.5 or not held:
                req = pkg.api.scheduler.WaitForStartingTaskRequest(
                    token="", milliseconds_to_wait=200,
                    immediate_reqs=rng.randint(1, 2),
                    next_keep_alive_in_ms=10000)
                req.env_desc.compiler_digest = ENV
                try:
                    resp, _ = chans[cell].call(
                        "ytpu.SchedulerService", "WaitForStartingTask",
                        req, pkg.api.scheduler.WaitForStartingTaskResponse,
                        timeout=5.0)
                except pkg.rpc.RpcError:
                    continue   # no slot free on this cell right now
                for g in resp.grants:
                    issued.append(g.task_grant_id)
                    held.append((cell, g.task_grant_id,
                                 g.servant_location))
                    rig.note_run_start(g.servant_location, g.task_grant_id)
            elif op < 0.75:
                cell, gid, _ = rng.choice(held)
                resp = _call(pkg, chans[cell], "KeepTaskAlive",
                             "KeepTaskAliveRequest", "KeepTaskAliveResponse",
                             task_grant_ids=[gid],
                             next_keep_alive_in_ms=10000)
                renewed_before += int(all(resp.statuses))
            else:
                cell, gid, loc = held.pop(rng.randrange(len(held)))
                _call(pkg, chans[cell], "FreeTask", "FreeTaskRequest",
                      "FreeTaskResponse", task_grant_ids=[gid])
                rig.note_run_end(loc, gid)
        # Let the journal ship everything before the kill.
        time.sleep(0.4)
        rig.arm_monitor(silence_s=0.3)
        rig.kill_active()
        promoted = rig.wait_promoted(15.0)
        pre_kill = [gid for cell, gid, _ in held if cell == 0]
        renewed_after = {}
        for gid in pre_kill:
            deadline = time.monotonic() + 10.0
            ok = False
            while not ok and time.monotonic() < deadline:
                try:
                    resp = _call(pkg, chans[0], "KeepTaskAlive",
                                 "KeepTaskAliveRequest",
                                 "KeepTaskAliveResponse",
                                 task_grant_ids=[gid],
                                 next_keep_alive_in_ms=10000)
                    ok = bool(resp.statuses[0])
                except pkg.rpc.RpcError:
                    pass
                if not ok:
                    time.sleep(0.1)
            renewed_after[gid] = ok
        for cell, gid, loc in held:
            _call(pkg, chans[cell], "FreeTask", "FreeTaskRequest",
                  "FreeTaskResponse", task_grant_ids=[gid])
            rig.note_run_end(loc, gid)
        # New grants on the promoted cell 0 must not reuse an id.
        req = pkg.api.scheduler.WaitForStartingTaskRequest(
            token="", milliseconds_to_wait=500, immediate_reqs=1,
            next_keep_alive_in_ms=10000)
        req.env_desc.compiler_digest = ENV
        after = []
        for _ in range(3):
            try:
                resp, _ = chans[0].call(
                    "ytpu.SchedulerService", "WaitForStartingTask", req,
                    pkg.api.scheduler.WaitForStartingTaskResponse,
                    timeout=5.0)
                after += [g.task_grant_id for g in resp.grants]
            except pkg.rpc.RpcError:
                pass
        return {
            "issued": issued,
            "renewed_before": renewed_before,
            "promoted": promoted,
            "pre_kill": len(pre_kill),
            "renewed_after": renewed_after,
            "after": after,
            "report": dict(rig.takeover_report or {}),
        }
    finally:
        for ch in chans.values():
            ch.close()


@pytest.fixture
def rigs():
    made = []

    def make(cls, **kw):
        rig = cls(2, servants_per_cell=2, servant_capacity=3,
                  env_digests=(ENV,), heartbeat_ms=300, **kw)
        made.append(rig)
        return rig

    yield make
    for rig in made:
        rig.stop()


@pytest.mark.parametrize("policy", ["greedy_cpu", "torch_grouped"])
def test_rigs_agree_on_the_takeover(rigs, policy):
    ref = drive(yadcc_tpu, rigs(JaxRig))
    port_rig = rigs(PortRig, policy=policy, device="cpu")
    port = drive(yadcc_tpu_torch, port_rig)
    for out in (ref, port):
        assert out["promoted"]
        assert out["pre_kill"] > 0
        # Every lease held across the kill renews once promoted.
        assert all(out["renewed_after"].values()), out["renewed_after"]
        ids = out["issued"] + out["after"]
        assert len(ids) == len(set(ids)), "a grant id issued twice"
        assert out["after"], "no grant after the promotion"
        assert out["report"]["servants_replayed"] == 2
    # The same seeded calls on the same fleet: the same grants issued,
    # held across the kill and renewed.
    assert len(port["issued"]) == len(ref["issued"])
    assert port["pre_kill"] == ref["pre_kill"]
    assert port["renewed_before"] == ref["renewed_before"]
    assert port["report"]["grants_journaled"] == \
        ref["report"]["grants_journaled"]
    # The promoted dispatcher runs the rig's policy on its device, as
    # every cell's does.
    promoted = port_rig.standby.dispatcher
    pol = promoted._policy
    cell1 = port_rig.handles[1].dispatcher._policy
    assert type(pol) is type(cell1)
    assert type(pol).__name__ == {"greedy_cpu": "GreedyCpuPolicy",
                                  "torch_grouped": "TorchGroupedPolicy"}[
                                      policy]
    if policy == "torch_grouped":
        assert pol._device.type == "cpu"
    assert port_rig.handles[0].dispatcher is promoted


def test_rig_defaults_to_the_card():
    import inspect

    sig = inspect.signature(PortRig)
    assert sig.parameters["policy"].default == "greedy_cpu"
    assert sig.parameters["device"].default == "cuda"


def test_promoted_standby_grants_after_a_storm_that_spilled_everything(
        rigs):
    """The promoted standby comes back at the dead active's rung: killed
    mid-storm, SPILLOVER, where every request goes to cell 1 and the
    standby's own ladder only moves when a request reaches it.  A storm
    spilled to the last request leaves it no grant of its own;
    drive_promoted (the card smoke's phase 19b) sends demand through it
    until its ladder steps down and it grants on cell 0's servants."""
    from yadcc_tpu_torch import api
    from yadcc_tpu_torch.rpc import Channel
    from yadcc_tpu_torch.scheduler.admission import (RUNG_SPILLOVER,
                                                     AdmissionConfig)

    # The storm's ladder (tools/scenarios.py cell-kill), with a dwell
    # long enough that the storm's calls all land on SPILLOVER.
    cfg0 = AdmissionConfig(up_thresholds=(1.2, 1.6, 6.0, 9.0),
                           up_dwell_s=0.05, down_dwell_s=2.0,
                           demand_window_s=1.2, retry_after_base_ms=100,
                           retry_after_max_ms=500)
    rig = rigs(PortRig, device="cpu", admission_configs=[cfg0, None])
    rig.arm_monitor(silence_s=0.3)
    rig.kill_active()
    assert rig.wait_promoted(15.0)
    promoted = rig.standby.dispatcher
    promoted.restore_admission_rung(RUNG_SPILLOVER)
    chan = Channel(rig.cell_dial_uri(0))
    spilled = []
    try:
        for _ in range(4):
            req = api.scheduler.WaitForStartingTaskRequest(
                token="", milliseconds_to_wait=250, immediate_reqs=1,
                next_keep_alive_in_ms=3000)
            req.env_desc.compiler_digest = ENV
            resp = _call_wait(chan, req)
            for g in resp.grants:
                spilled.append((g.cell_id, g.spilled))
                _call(yadcc_tpu_torch, chan, "FreeTask", "FreeTaskRequest",
                      "FreeTaskResponse", task_grant_ids=[g.task_grant_id])
    finally:
        chan.close()
    assert spilled == [(1, True)] * 4
    assert promoted.inspect()["stats"]["granted"] == 0
    out = rig.drive_promoted(want=2, timeout_s=30.0)
    assert out["granted_here"] >= 2, out
    assert out["granted_before"] == 0
    assert out["granted_after"] >= out["granted_before"] + 2
    assert promoted.admission_rung() < RUNG_SPILLOVER


def _call_wait(chan, req):
    resp, _ = chan.call(
        "ytpu.SchedulerService", "WaitForStartingTask", req,
        yadcc_tpu_torch.api.scheduler.WaitForStartingTaskResponse,
        timeout=5.0)
    return resp
