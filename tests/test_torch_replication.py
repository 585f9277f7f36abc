"""The port's warm-standby replication against the JAX package's, on the CPU.

One seeded sequence of joins, grants, renewals, frees, rung changes and
leaves through each package's ReplicatingDispatcher gives the same journal
entries (as JSON strings) and the same ReplicaState; each package's
ReplicationService applies the other's journal, off the wire, to the same
state; the same adoption sequence (adopt, window, join, running-task
report, expiry) leaves both dispatchers with the same grants, running
vector and next grant id, the port's pipelined and resident policies
included, where the device running chain must learn of every adopted
grant; the router adopts across shards as the JAX router does; and the
port's entry runs an active, its journal stream and a gRPC standby that
takes over, on --device cpu.  Every quantity compared is an integer, an
id, a verdict or a JSON string: the tolerance is 0."""

from __future__ import annotations

import json
import socket
import threading
import time
from collections import Counter

import numpy as np
import pytest

from yadcc_tpu import api as japi
from yadcc_tpu.scheduler import policy as jpol
from yadcc_tpu.scheduler import replication as jrep
from yadcc_tpu.scheduler import shard_router as jsr
from yadcc_tpu.scheduler import task_dispatcher as jtd
from yadcc_tpu.utils.clock import VirtualClock as JClock
from yadcc_tpu_torch import api as tapi
from yadcc_tpu_torch.scheduler import policy as tpol
from yadcc_tpu_torch.scheduler import replication as trep
from yadcc_tpu_torch.scheduler import shard_router as tsr
from yadcc_tpu_torch.scheduler import task_dispatcher as ttd
from yadcc_tpu_torch.utils.clock import VirtualClock as TClock

ENVS = [f"env-{i:02d}" for i in range(6)]
JAX = (jtd, jpol, jrep, JClock)
PORT = (ttd, tpol, trep, TClock)


def fleet(rng, n):
    out = []
    for i in range(n):
        envs = tuple(sorted(str(e) for e in rng.choice(
            ENVS, int(rng.integers(1, 4)), replace=False)))
        out.append(dict(location=f"10.1.{i // 100}.{i % 100 + 1}:8335",
                        version=1, num_processors=8,
                        capacity=int(rng.integers(2, 7)),
                        total_memory=64 << 30, memory_available=64 << 30,
                        env_digests=envs))
    return out


def manual(pkg, clock, max_servants=32, **kw):
    td, pol, _, _ = pkg
    return td.TaskDispatcher(pol.GreedyCpuPolicy(),
                             max_servants=max_servants, max_envs=16,
                             clock=clock, batch_window_s=0.0,
                             start_dispatch_thread=False, **kw)


def grant(d, clock, env, n, requestor="", lease_s=1000.0, home=None,
          parked=False):
    """One blocking grant request on a dispatcher (or a router of shards)
    without a dispatch thread: a cycle serves it, the clock passes its
    deadline, a second cycle completes it.  ``home`` takes the router's
    routed path on that shard; ``parked`` the parked (continuation) wait,
    which must answer exactly once."""
    base = getattr(d, "inner", d)
    inners = list(getattr(base, "shards", [base]))
    kw = dict(immediate=n, requestor=requestor, lease_s=lease_s,
              timeout_s=1.0)
    out = []
    if parked:
        if home is None:
            d.submit_wait_for_starting_new_task(env, on_done=out.append,
                                                **kw)
        else:
            d.submit_wait_for_starting_new_task_routed(
                env, home=home, on_done=lambda r: out.append(r.pairs()),
                **kw)
        for x in inners:
            x.run_dispatch_cycle_for_testing()
        clock.advance(1.5)
        for x in inners:
            x.run_dispatch_cycle_for_testing()
        assert len(out) == 1
        return out[0]
    if home is None:
        call = lambda: d.wait_for_starting_new_task(env, **kw)  # noqa: E731
    else:
        call = lambda: d.wait_for_starting_new_task_routed(  # noqa: E731
            env, home=home, **kw).pairs()
    t = threading.Thread(target=lambda: out.append(call()))
    t.start()
    for _ in range(2000):
        if any(x._pending for x in inners):
            break
        time.sleep(0.001)
    for x in inners:
        x.run_dispatch_cycle_for_testing()
    clock.advance(1.5)
    for x in inners:
        x.run_dispatch_cycle_for_testing()
    t.join(timeout=10)
    assert not t.is_alive()
    return out[0]


def drive_journal(pkg, seed, compact_keep=4096, parked=False):
    """The seeded sequence through one package's ReplicatingDispatcher
    (its grants through the parked wait when ``parked``); returns
    (journal, [grant pairs of every request])."""
    td, _, rep, clock_cls = pkg
    clock = clock_cls(100.0)
    d = manual(pkg, clock)
    journal = rep.LeaseJournal(compact_keep=compact_keep)
    r = rep.ReplicatingDispatcher(d, journal)
    rng = np.random.default_rng(seed)
    servants = fleet(rng, 10)
    issued, held = [], []
    try:
        for s in servants:
            assert r.keep_servant_alive(td.ServantInfo(**s), 60.0)
        for _ in range(40):
            k = int(rng.integers(0, 7))
            if k <= 2:
                got = grant(r, clock, str(rng.choice(ENVS)),
                            int(rng.integers(1, 5)),
                            requestor=f"10.9.0.{int(rng.integers(1, 9))}:1",
                            parked=parked)
                issued.append(got)
                held.extend(gid for gid, _ in got)
            elif k == 3 and held:
                ids = [int(g) for g in rng.choice(held, min(3, len(held)),
                                                  replace=False)]
                r.keep_task_alive(ids + [999_999], 15.0)
            elif k == 4 and held:
                ids = [int(g) for g in rng.choice(held, min(2, len(held)),
                                                  replace=False)]
                r.free_task(ids)
                held = [g for g in held if g not in ids]
            elif k == 5:
                d.restore_admission_rung(int(rng.integers(0, 4)))
                r.on_expiration_timer()
            else:
                s = servants[int(rng.integers(0, len(servants)))]
                r.keep_servant_alive(td.ServantInfo(**s), 0)
                r.keep_servant_alive(td.ServantInfo(**s), 60.0)
        return journal, issued
    finally:
        d.stop()


@pytest.mark.parametrize("seed", [1, 2])
def test_journal_and_replica_state_match_jax(seed):
    jj, jissued = drive_journal(JAX, seed)
    tj, tissued = drive_journal(PORT, seed)
    assert tissued == jissued
    jsnap, _, jentries = jj.since(0)
    tsnap, _, tentries = tj.since(0)
    assert jsnap is None and tsnap is None
    assert json.dumps(tentries) == json.dumps(jentries)
    assert {e["op"] for _, e in tentries} >= {"servant", "issue", "free"}
    jst, tst = jrep.ReplicaState(), trep.ReplicaState()
    for seq, entry in jentries:
        jst.apply(seq, entry)
        tst.apply(seq, entry)
    assert tst.to_json() == jst.to_json()
    assert trep.ReplicaState.from_json(jst.to_json()).to_json() == \
        jst.to_json()


def test_parked_grants_are_journaled_and_replayed_as_by_jax():
    """Grants served through the parked wait reach the journal (inside
    the continuation, before the reply), as the JAX wrapper journals
    them: the same entries as the JAX package's parked drive and as the
    blocking drive, the same replayed state, and a takeover into a fresh
    dispatcher adopts every grant still held."""
    jj, jissued = drive_journal(JAX, 1, parked=True)
    tj, tissued = drive_journal(PORT, 1, parked=True)
    bj, bissued = drive_journal(PORT, 1)
    assert tissued == jissued == bissued
    entries = [j.since(0)[2] for j in (jj, tj, bj)]
    assert json.dumps(entries[1]) == json.dumps(entries[0]) \
        == json.dumps(entries[2])
    issues = [e for _, e in entries[1] if e["op"] == "issue"]
    assert sum(len(e["grants"]) for e in issues) == \
        sum(len(g) for g in tissued) > 0
    jst, tst = jrep.ReplicaState(), trep.ReplicaState()
    for seq, entry in entries[0]:
        jst.apply(seq, entry)
        tst.apply(seq, entry)
    assert tst.to_json() == jst.to_json()
    clock = TClock(100.0)
    fresh = manual(PORT, clock)
    sb = trep.StandbyScheduler(clock=clock)
    try:
        sb.receiver.Replicate(_wire(tapi, tapi, tj, 0), b"", None)
        report = sb.takeover(lambda: fresh)
        held = json.loads(tst.to_json())["grants"]
        assert report["grants_adopted"] == len(held) > 0
        assert sorted(g.grant_id for g in fresh.get_running_tasks()) == \
            sorted(int(g) for g in held)
    finally:
        fresh.stop()


def test_compacted_journal_snapshot_matches_jax():
    jj, _ = drive_journal(JAX, 3, compact_keep=8)
    tj, _ = drive_journal(PORT, 3, compact_keep=8)
    assert tj.last_seq() == jj.last_seq() > 8
    for acked in (0, 2, jj.last_seq() - 4):
        jsnap, jseq, jentries = jj.since(acked)
        tsnap, tseq, tentries = tj.since(acked)
        assert (tsnap, tseq) == (jsnap, jseq)
        assert json.dumps(tentries) == json.dumps(jentries)


def _wire(src_api, dst_api, journal, acked, token=""):
    """A Replicate request built by one package, as the other parses it."""
    snap, snap_seq, entries = journal.since(acked)
    req = src_api.scheduler.ReplicateRequest(
        token=token, first_seq=entries[0][0] if entries else 0,
        entries_json=json.dumps(entries).encode(),
        snapshot_json=(snap or "").encode(), snapshot_seq=snap_seq)
    return dst_api.scheduler.ReplicateRequest.FromString(
        req.SerializeToString())


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_replication_service_applies_the_other_packages_journal(direction):
    jj, _ = drive_journal(JAX, 4, compact_keep=16)
    tj, _ = drive_journal(PORT, 4, compact_keep=16)
    if direction == "jax_to_port":
        src_api, dst_api, journal, svc_mod = japi, tapi, jj, trep
        want_mod = jrep
    else:
        src_api, dst_api, journal, svc_mod = tapi, japi, tj, jrep
        want_mod = trep
    svc = svc_mod.ReplicationService(token="tok")
    with pytest.raises(Exception):
        svc.Replicate(_wire(src_api, dst_api, journal, 0, "bad"), b"", None)
    # A lagging standby first gets the snapshot plus the tail, then a gap
    # it must refuse to apply past, then the increments.
    resp = svc.Replicate(_wire(src_api, dst_api, journal, 0, "tok"), b"",
                         None)
    assert resp.acked_seq == journal.last_seq()
    snap, _, entries = journal.since(0)
    want = want_mod.ReplicaState.from_json(snap)
    for seq, entry in entries:
        want.apply(seq, entry)
    assert svc.freeze().to_json() == want.to_json()


# --------------------------------------------------------------------------
# Lease adoption.
# --------------------------------------------------------------------------


def adopt_sequence(pkg, clock, start, stride):
    """Adopt, open the window, join, report and expire through one
    package's dispatcher; returns what is compared."""
    td = pkg[0]
    d = manual(pkg, clock, grant_id_start=start, grant_id_stride=stride)
    rng = np.random.default_rng(11)
    servants = fleet(rng, 8)
    out = {}
    try:
        for s in servants[:5]:
            assert d.keep_servant_alive(td.ServantInfo(**s), 60.0)
        ids = [start + k * stride for k in range(1, 40, 3)]
        plan = {}
        for i, gid in enumerate(ids):
            s = servants[i % 8]           # servants 5-7 have not joined
            plan.setdefault(s["location"], []).append(
                (gid, s["env_digests"][0], f"r{i}"))
        out["attached"] = [d.adopt_grants(loc, items, 30.0)
                           for loc, items in sorted(plan.items())]
        # Idempotent: a second replay attaches nothing new.
        out["again"] = [d.adopt_grants(loc, items, 30.0)
                        for loc, items in sorted(plan.items())]
        with pytest.raises(ValueError, match="namespace"):
            d.adopt_grants(servants[0]["location"],
                           [(start + 1, "e", "r")] if stride > 1
                           else [(0, "e", "r")], 30.0)
        d.set_adoption_window(max(ids), 20.0, gap_slack=4)
        for s in servants[5:7]:           # parked adoptions attach on join
            assert d.keep_servant_alive(td.ServantInfo(**s), 60.0)
        gap = max(ids) + 2 * stride       # within the window's ceiling
        beyond = max(ids) + 9 * stride    # past it
        out["kill"] = d.notify_servant_running_tasks(
            servants[1]["location"], [ids[1], gap, beyond])
        out["grants"] = sorted((g.grant_id, g.servant_location,
                                g.env_digest, g.requestor)
                               for g in d.get_running_tasks())
        out["running"] = d._arr_running.tolist()
        out["next"] = d._next_grant_id
        out["adopted"] = d.inspect()["stats"]["adopted_grants"]
        out["pending"] = {k: list(v) for k, v
                          in d._pending_adoptions.items()}
        out["after"] = grant(d, clock, servants[0]["env_digests"][0], 6)
        # Past the window (and the parked leases): servant 7's parked
        # adoptions are purged, unknown ids are killed again.
        clock.advance(35.0)
        d.on_expiration_timer()
        out["purged"] = {k: list(v) for k, v
                         in d._pending_adoptions.items()}
        out["kill_after"] = d.notify_servant_running_tasks(
            servants[2]["location"], [max(ids) + stride])
        out["next_after"] = d._next_grant_id
        return out, (gap, beyond, max(ids) + 4 * stride)
    finally:
        d.stop()


@pytest.mark.parametrize("start,stride", [(1, 1), (2, 3)])
def test_adoption_matches_jax(start, stride):
    want, (gap, beyond, ceiling) = adopt_sequence(JAX, JClock(100.0),
                                                  start, stride)
    got, _ = adopt_sequence(PORT, TClock(100.0), start, stride)
    assert got == want
    assert sum(want["attached"]) > 0 and not any(want["again"])
    assert want["kill"] == [beyond]
    assert gap in {g[0] for g in want["grants"]}
    assert list(want["pending"]) == [fleet(np.random.default_rng(11), 8)[7]
                                     ["location"]]
    assert want["purged"] == {} and len(want["kill_after"]) == 1
    assert want["after"] and all(gid > ceiling for gid, _ in want["after"])


def _servant(td, i):
    # current_load 3 of 6 processors: the effective capacity grows as
    # grants land (foreign load = load - running), so a slot whose
    # capacity is not refreshed after an adoption under-grants.
    return td.ServantInfo(location=f"10.3.0.{i}:8335", version=1,
                          num_processors=6, current_load=3, capacity=4,
                          total_memory=64 << 30, memory_available=64 << 30,
                          env_digests=("env-a",))


def pipelined_adoption(pkg, policy, depth):
    """Start a stream, adopt onto a joined servant, a parked one and a
    journal-gap id, then grant until the pool is full.  Returns what is
    compared across packages and the dispatcher's device-chain check."""
    td = pkg[0]
    d = td.TaskDispatcher(policy, max_servants=16, pipeline_depth=depth,
                          batch_window_s=0.0)
    try:
        s0, s1 = _servant(td, 1), _servant(td, 2)
        assert d.keep_servant_alive(s0, 60.0)
        first = d.wait_for_starting_new_task("env-a", timeout_s=2.0)
        assert len(first) == 1
        d.free_task([first[0][0]])
        # A launch after the free publishes the freed slot's row, so a
        # snapshot buffer holds it clean when the adoption lands.
        assert d.wait_for_starting_new_task("env-b", timeout_s=0.05) == []
        attached = d.adopt_grants(s0.location, [(1001, "env-a", "r1"),
                                                (1002, "env-a", "r2")], 60.0)
        parked = d.adopt_grants(s1.location, [(1003, "env-a", "r3")], 60.0)
        d.set_adoption_window(1003, 60.0, gap_slack=1024)
        assert d.keep_servant_alive(s1, 60.0)
        kill = d.notify_servant_running_tasks(s1.location, [1003, 1500])
        # Every prepared snapshot buffer publishes the adopted slots'
        # running and effective capacity (the dirty mark), as a full
        # rebuild computes them.
        with d._lock:
            full = d._snapshot_full_locked()
            snaps = []
            while any(not b.leased for b in d._snap_buffers):
                snaps.append(d._snapshot_locked())
            fresh = all(np.array_equal(x.capacity, full.capacity)
                        and np.array_equal(x.running, full.running)
                        for x in snaps)
            for x in snaps:
                d._release_snapshot_locked(x)
        state = dict(attached=attached, parked=parked, kill=kill,
                     grants=sorted((g.grant_id, g.servant_location,
                                    g.env_digest, g.requestor)
                                   for g in d.get_running_tasks()),
                     running=d._arr_running.tolist(),
                     next=d._next_grant_id)
        # Each servant: 2 adopted, foreign load 1, effective capacity 4:
        # exactly 2 more grants each, whatever the policy.
        got = d.wait_for_starting_new_task("env-a", immediate=4,
                                           timeout_s=2.0)
        got += d.wait_for_starting_new_task("env-a", immediate=1,
                                            timeout_s=0.1)
        state["more"] = sorted(Counter(loc for _, loc in got).items())
        state["ids_fresh"] = all(gid > 1003 + 1024 for gid, _ in got)
        chain = None
        if depth > 0:
            time.sleep(0.1)
            with d._lock:
                dev = (policy.resident_pool.running
                       if hasattr(policy, "resident_pool")
                       else policy._stream_running)
                chain = (dev.cpu().numpy().astype(np.int64) + d._pipe_adj
                         ).tolist() == d._arr_running.tolist()
        return state, (chain, fresh), d.inspect()
    finally:
        d.stop()


@pytest.mark.parametrize("policy", ["torch_grouped", "torch_resident_grouped"])
def test_pipelined_adoption_matches_jax_and_feeds_the_device_chain(policy):
    want, _, _ = pipelined_adoption(JAX, jpol.GreedyCpuPolicy(), 0)
    pol = (tpol.TorchResidentGroupedPolicy("cpu", oracle_interval=1)
           if policy == "torch_resident_grouped"
           else tpol.TorchGroupedPolicy("cpu"))
    got, chain, inspect = pipelined_adoption(PORT, pol, 3)
    assert got == want
    assert want["attached"] == 2 and want["parked"] == 0
    assert want["kill"] == [] and want["ids_fresh"]
    assert want["more"] == [("10.3.0.1:8335", 2), ("10.3.0.2:8335", 2)]
    # The device chain plus the pending corrections equals the host's
    # running vector (every adopted grant reached the chain), and the
    # snapshots the launches read carry the adopted slots' new rows.
    assert chain == (True, True)
    assert inspect["failure"] is None
    if policy == "torch_resident_grouped":
        assert inspect["stream"]["oracle_mismatches"] == 0


# --------------------------------------------------------------------------
# The sharded router's adoption, and a router takeover.
# --------------------------------------------------------------------------


def test_router_adoption_across_shards_matches_jax():
    def run(sr, td, pol):
        r = sr.ShardRouter.build(lambda k: pol.GreedyCpuPolicy(), 3,
                                 max_servants_per_shard=16,
                                 start_dispatch_thread=False)
        try:
            locs = [f"10.4.0.{i}:8335" for i in range(1, 7)]
            for loc in locs[:4]:
                assert r.keep_servant_alive(td.ServantInfo(
                    location=loc, num_processors=8, capacity=6,
                    total_memory=64 << 30, memory_available=64 << 30,
                    env_digests=("env-a",)), 60.0)
            ids = list(range(5, 60, 4))
            attached = [r.adopt_grants(loc, [(g, "env-a", "r")
                                             for g in ids[i::6]], 30.0)
                        for i, loc in enumerate(locs)]
            r.set_adoption_window(max(ids), 10.0, gap_slack=2)
            per = [sorted(g.grant_id for g in d.get_running_tasks())
                   for d in r.shards]
            return (attached, per, [d._next_grant_id for d in r.shards],
                    [sorted(d._pending_adoptions) for d in r.shards],
                    r.admission_rung())
        finally:
            r.stop()

    want = run(jsr, jtd, jpol)
    assert run(tsr, ttd, tpol) == want
    assert sum(want[0]) > 0 and any(want[3])


def test_router_parked_grants_are_journaled_unlike_the_reference():
    """On a sharded plane the service parks through the router's routed
    wait.  The port's wrapper journals those grants as its blocking
    routed wait does, so the journal equals the JAX package's blocking
    one; the JAX wrapper journals only the plain parked wait, so its
    routed parked grants never reach the journal (a reference gap)."""
    def run(pkg, sr, parked):
        td, pol, rep, clock_cls = pkg
        clock = clock_cls(100.0)
        active = sr.ShardRouter.build(
            lambda k: pol.GreedyCpuPolicy(), 2, max_servants_per_shard=16,
            clock=clock, steal=sr.StealConfig(enabled=False),
            start_dispatch_thread=False)
        journal = rep.LeaseJournal()
        r = rep.ReplicatingDispatcher(active, journal)
        try:
            for i in range(1, 9):
                assert r.keep_servant_alive(td.ServantInfo(
                    location=f"10.5.0.{i}:8335", num_processors=8,
                    capacity=3, total_memory=64 << 30,
                    memory_available=64 << 30, env_digests=("env-a",)),
                    60.0)
            got = [grant(r, clock, "env-a", 3, home=k, parked=parked)
                   for k in (0, 1, 1)]
            return got, json.dumps(journal.since(0)[2])
        finally:
            active.stop()

    want_grants, want = run(JAX, jsr, parked=False)
    got_grants, got = run(PORT, tsr, parked=True)
    assert got_grants == want_grants and got == want
    assert sum(len(g) for g in got_grants) == 9
    ref_grants, ref = run(JAX, jsr, parked=True)
    assert ref_grants == want_grants
    assert '"issue"' in want and '"issue"' not in ref


def test_router_takeover_adopts_every_shard_grant():
    """A ReplicatingDispatcher over a 2-shard router journals the grants
    of both shards; the standby's takeover into a fresh router routes each
    to its owning shard, where it renews exactly once."""
    clock = TClock(100.0)
    journal = trep.LeaseJournal()

    def build():
        return tsr.ShardRouter.build(
            lambda k: tpol.GreedyCpuPolicy(), 2, max_servants_per_shard=16,
            clock=clock, steal=tsr.StealConfig(enabled=False),
            start_dispatch_thread=False)

    active, fresh = build(), build()
    r = trep.ReplicatingDispatcher(active, journal)
    sb = trep.StandbyScheduler(clock=clock)
    try:
        locs = [f"10.5.0.{i}:8335" for i in range(1, 9)]
        for loc in locs:
            assert r.keep_servant_alive(ttd.ServantInfo(
                location=loc, num_processors=8, capacity=3,
                total_memory=64 << 30, memory_available=64 << 30,
                env_digests=("env-a",)), 60.0)
        ids = []
        for k in range(2):
            ids += [gid for gid, _ in grant(r, clock, "env-a", 3, home=k)]
        assert {active.shard_of_grant(g) for g in ids} == {0, 1}
        sb.receiver.Replicate(_wire(tapi, tapi, journal, 0), b"", None)
        report = sb.takeover(lambda: fresh)
        assert report["grants_adopted"] == len(ids) == 6
        assert report["servants_replayed"] == len(locs)
        assert sorted(g.grant_id for d in fresh.shards
                      for g in d.get_running_tasks()) == sorted(ids)
        assert fresh.keep_task_alive(ids, 15.0) == [True] * len(ids)
        fresh.free_task(ids)
        assert fresh.keep_task_alive(ids, 15.0) == [False] * len(ids)
    finally:
        active.stop()
        fresh.stop()


# --------------------------------------------------------------------------
# The entry: active -> journal stream -> gRPC standby -> takeover.
# --------------------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_entry_active_streams_to_a_grpc_standby_that_takes_over():
    from yadcc_tpu_torch.rpc import STATUS_NOT_SERVING, Channel, RpcError
    from yadcc_tpu_torch.scheduler import entry
    from yadcc_tpu_torch.scheduler.admission import FLOW_NONE, FLOW_REJECT
    from yadcc_tpu_torch.scheduler.service import SERVICE_NAME
    from yadcc_tpu_torch.utils import exposed_vars

    sch = tapi.scheduler
    pa, ps = _free_port(), _free_port()
    common = ["--inspect-port", "0", "--device", "cpu", "--max-servants",
              "32", "--acceptable-user-tokens", "utok",
              "--acceptable-servant-tokens", "stok", "--allow-self-dispatch",
              "--dispatch-policy", "greedy_cpu", "--replication-token", "rt"]
    standby_args = entry.build_arg_parser().parse_args(
        ["--port", str(ps), "--standby", "--standby-takeover-silence",
         "0.5", *common])
    active_args = entry.build_arg_parser().parse_args(
        ["--port", str(pa), "--replicate-to", f"grpc://127.0.0.1:{ps}",
         *common])
    stops = [threading.Event(), threading.Event()]
    rcs = []
    threads = [threading.Thread(target=lambda a=a, s=s: rcs.append(
        entry.scheduler_start(a, s, gc_guard=False)), daemon=True)
        for a, s in zip((standby_args, active_args), stops)]
    ch_a = Channel(f"grpc://127.0.0.1:{pa}")
    ch_s = Channel(f"grpc://127.0.0.1:{ps}")

    def wait_req(ms=1000):
        req = sch.WaitForStartingTaskRequest(
            token="utok", milliseconds_to_wait=ms, immediate_reqs=1,
            next_keep_alive_in_ms=10_000)
        req.env_desc.compiler_digest = "gcc-12"
        return req

    def until(fn, what, limit=10.0):
        t0 = time.monotonic()
        while time.monotonic() - t0 < limit:
            got = fn()
            if got:
                return got
            time.sleep(0.02)
        raise AssertionError(what)

    try:
        for t in threads:
            t.start()

        def active_up():
            try:
                ch_a.call(SERVICE_NAME, "GetConfig",
                          sch.GetConfigRequest(token="utok"),
                          sch.GetConfigResponse, timeout=1.0)
                return True
            except RpcError:
                return False

        until(active_up, "the active never served")
        hb = sch.HeartbeatRequest(
            token="stok", next_heartbeat_in_ms=2000,
            location="127.0.0.1:20001", version=1, num_processors=8,
            capacity=4, total_memory_in_bytes=64 << 30,
            memory_available_in_bytes=64 << 30)
        hb.env_descs.add(compiler_digest="gcc-12")
        ch_a.call(SERVICE_NAME, "Heartbeat", hb, sch.HeartbeatResponse,
                  timeout=5.0)
        resp, _ = ch_a.call(SERVICE_NAME, "WaitForStartingTask", wait_req(),
                            sch.WaitForStartingTaskResponse, timeout=5.0)
        (held,) = [g.task_grant_id for g in resp.grants]
        # Before the takeover the standby refuses fast.
        resp, _ = ch_s.call(SERVICE_NAME, "WaitForStartingTask", wait_req(),
                            sch.WaitForStartingTaskResponse, timeout=5.0)
        assert resp.flow_control == FLOW_REJECT and resp.retry_after_ms > 0
        with pytest.raises(RpcError) as err:
            ch_s.call(SERVICE_NAME, "KeepTaskAlive",
                      sch.KeepTaskAliveRequest(token="utok",
                                               task_grant_ids=[held]),
                      sch.KeepTaskAliveResponse, timeout=5.0)
        assert err.value.status == STATUS_NOT_SERVING
        until(lambda: exposed_vars.collect("yadcc/standby")["yadcc"][
            "standby"]["journal_seq"] >= 2, "the journal never shipped")
        stops[1].set()                  # the active stops streaming
        threads[1].join(timeout=10)
        until(lambda: exposed_vars.collect("yadcc/standby")["yadcc"][
            "standby"]["promoted"], "the standby never took over")
        report = exposed_vars.collect("yadcc/standby")["yadcc"]["standby"][
            "report"]
        assert report["servants_replayed"] == 1
        assert report["grants_adopted"] == 1
        kresp, _ = ch_s.call(SERVICE_NAME, "KeepTaskAlive",
                             sch.KeepTaskAliveRequest(
                                 token="utok", task_grant_ids=[held],
                                 next_keep_alive_in_ms=10_000),
                             sch.KeepTaskAliveResponse, timeout=5.0)
        assert list(kresp.statuses) == [True]
        resp, _ = ch_s.call(SERVICE_NAME, "WaitForStartingTask", wait_req(),
                            sch.WaitForStartingTaskResponse, timeout=5.0)
        assert resp.flow_control == FLOW_NONE
        (fresh,) = [g.task_grant_id for g in resp.grants]
        assert fresh > held
    finally:
        for s in stops:
            s.set()
        for t in threads:
            t.join(timeout=10)
        ch_a.close()
        ch_s.close()
    assert not any(t.is_alive() for t in threads)
    assert rcs == [0, 0]


def gap_takeover(pkg, api_mod, n_gap_requests):
    """An active ships its journal once, then issues ``n_gap_requests`` x
    128 grants that never ship and dies; the standby takes over, every
    servant re-reports what it runs, and the standby issues as many grants
    again.  Returns (ids the dead active issued after its last ship, the
    standby's new ids, the kill lists the reports got)."""
    td, _, rep, clock_cls = pkg
    clock = clock_cls(100.0)
    journal = rep.LeaseJournal()
    active = manual(pkg, clock, max_servants=64)
    fresh = manual(pkg, clock, max_servants=64)
    r = rep.ReplicatingDispatcher(active, journal)
    sb = rep.StandbyScheduler(clock=clock)
    servants = [td.ServantInfo(location=f"10.6.0.{i}:8335",
                               num_processors=256, capacity=200,
                               total_memory=64 << 30,
                               memory_available=64 << 30,
                               env_digests=("env-a",))
                for i in range(1, 41)]
    try:
        for s in servants:
            assert r.keep_servant_alive(s, 60.0)
        grant(r, clock, "env-a", 1)
        sb.receiver.Replicate(_wire(api_mod, api_mod, journal, 0), b"",
                              None)
        gap = []
        for _ in range(n_gap_requests):
            gap += grant(r, clock, "env-a", 128)
        sb.takeover(lambda: fresh)
        kills = []
        for s in servants:
            fresh.keep_servant_alive(s, 60.0)
            kills += fresh.notify_servant_running_tasks(
                s.location, [g for g, loc in gap if loc == s.location])
        new = []
        for _ in range(n_gap_requests):
            new += [g for g, _ in grant(fresh, clock, "env-a", 128)]
        return {g for g, _ in gap}, set(new), kills
    finally:
        active.stop()
        fresh.stop()


def test_takeover_after_a_gap_of_2048_ids_issues_no_id_twice():
    """At tens of thousands of grants a second the active issues far more
    than 1,024 ids between two journal ships.  The JAX takeover opens its
    adoption window 1,024 ids above the journaled maximum, so it kills the
    gap grants the servants report beyond that and issues their ids again;
    the port's opens it 2^32 ids above, adopts every reported gap grant
    and issues none of their ids."""
    gap, new, kills = gap_takeover(JAX, japi, 16)
    assert len(gap) == 2048
    assert kills and gap & new           # the reference's fault
    gap, new, kills = gap_takeover(PORT, tapi, 16)
    assert len(gap) == 2048 and len(new) == 2048
    assert kills == [] and not gap & new


def gap_over_capacity(pkg, api_mod):
    """An active grants one task on a servant of capacity 2 and ships its
    journal, then grants a second that never ships (the journal's gap) and
    dies.  The standby takes over and serves a request before the servant
    re-reports; then the servant reports all it runs.  Returns (the grant
    served before the report, the report's kill list, the servant's
    running count after it, the grant served after it)."""
    td, _, rep, clock_cls = pkg
    clock = clock_cls(100.0)
    journal = rep.LeaseJournal()
    active = manual(pkg, clock)
    fresh = manual(pkg, clock)
    r = rep.ReplicatingDispatcher(active, journal)
    sb = rep.StandbyScheduler(clock=clock)
    s = td.ServantInfo(location="10.7.0.1:8335", num_processors=8,
                       capacity=2, total_memory=64 << 30,
                       memory_available=64 << 30, env_digests=("env-a",))
    try:
        assert r.keep_servant_alive(s, 60.0)
        shipped = grant(r, clock, "env-a", 1)
        sb.receiver.Replicate(_wire(api_mod, api_mod, journal, 0), b"",
                              None)
        gap = grant(r, clock, "env-a", 1)
        sb.takeover(lambda: fresh)
        before = grant(fresh, clock, "env-a", 1)
        kill = fresh.notify_servant_running_tasks(
            s.location, [g for g, _ in shipped + gap + before])
        running = int(fresh._arr_running[fresh._by_location[s.location]])
        after = grant(fresh, clock, "env-a", 1)
        return len(shipped), len(gap), len(before), kill, running, after
    finally:
        active.stop()
        fresh.stop()


def test_gap_grant_puts_a_servant_over_capacity_as_in_the_reference():
    """A fault the port shares with the reference (ROADMAP Queue 3): until
    a servant re-reports, the promoted standby does not know the journal
    gap's grants on it, so a request served in between can take the room
    they hold.  Here the servant of capacity 2 ends up running 3; once it
    has reported, nothing more is granted on it."""
    want = gap_over_capacity(JAX, japi)
    assert gap_over_capacity(PORT, tapi) == want
    assert want == (1, 1, 1, [], 3, [])
