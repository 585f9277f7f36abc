"""The port's sharded scheduler against the JAX package's, on the CPU.

The port's consistent-hash ring (its own XXH64) picks the same shard as
the JAX ring (the xxhash wheel) for every key, before and after
membership churn; one seeded sequence of heartbeats, admission checks,
grant requests with tenants, and frees through a JAX ShardRouter and the
port's gives the same shard for every servant, the same grant ids, picks
and steal stats, and the same per-tenant stats; and the port's entry
serves grants from four shards with --shards 4 --device cpu.  Every
quantity compared is an integer or a string: the tolerance is 0."""

from __future__ import annotations

import socket
import threading

import numpy as np
import pytest

from yadcc_tpu.common.consistent_hash import ConsistentHash as JRing
from yadcc_tpu.scheduler import entry as jentry
from yadcc_tpu.scheduler import policy as jpol
from yadcc_tpu.scheduler import shard_router as jsr
from yadcc_tpu.scheduler import task_dispatcher as jtd
from yadcc_tpu.tenancy import TenantDirectory as JDir
from yadcc_tpu.tenancy import TenantSpec as JSpec
from yadcc_tpu_torch.common.consistent_hash import ConsistentHash as TRing
from yadcc_tpu_torch.common.consistent_hash import \
    SCHEDULER_VNODES_PER_WEIGHT
from yadcc_tpu_torch.common.xxh64_np import xxh64_int, xxh64_keys
from yadcc_tpu_torch.scheduler import entry as tentry
from yadcc_tpu_torch.scheduler import policy as tpol
from yadcc_tpu_torch.scheduler import shard_router as tsr
from yadcc_tpu_torch.scheduler import task_dispatcher as ttd
from yadcc_tpu_torch.tenancy import TenantDirectory as TDir
from yadcc_tpu_torch.tenancy import TenantSpec as TSpec

ENVS = ("e" * 64, "f" * 64)


def _keys(n, seed):
    rng = np.random.default_rng(seed)
    out = []
    for k in range(n):
        if k % 3 == 0:
            out.append(f"10.{rng.integers(256)}.{rng.integers(256)}."
                       f"{rng.integers(256)}:{rng.integers(1024, 65536)}")
        elif k % 3 == 1:
            out.append(f"delegate-{rng.integers(1 << 30)}")
        else:
            out.append("env:" + "".join(
                "0123456789abcdef"[i] for i in rng.integers(0, 16, 64)))
    return out


def test_scalar_xxh64_matches_batch_and_wheel():
    import xxhash

    rng = np.random.default_rng(3)
    for n in list(range(70)) + [127, 128, 129, 1000]:
        data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        for seed in (0, 7, (1 << 64) - 1):
            want = xxhash.xxh64_intdigest(data, seed)
            assert xxh64_int(data, seed) == want
            assert int(xxh64_keys([data], seed)[0]) == want


def test_ring_picks_match_for_10000_keys_through_churn():
    keys = _keys(10_000, seed=5)
    names = [(f"shard{k}", 1) for k in range(6)]
    j = JRing(names, vnodes_per_weight=SCHEDULER_VNODES_PER_WEIGHT)
    t = TRing(names, vnodes_per_weight=SCHEDULER_VNODES_PER_WEIGHT)

    def same():
        picks = [t.pick(k) for k in keys]
        assert picks == [j.pick(k) for k in keys]
        return picks

    before = same()
    for ring in (j, t):
        ring.remove_node("shard2")
    after_leave = same()
    # Only the departed node's keys moved.
    assert all(a == b for a, b in zip(before, after_leave)
               if a != "shard2")
    for ring in (j, t):
        ring.add_node("shard2", 1)
        ring.add_node("shard6", 2)
    same()
    assert j.nodes() == t.nodes()


# ---------------------------------------------------------------------------
# One seeded sequence through both routers.
# ---------------------------------------------------------------------------

N_SHARDS = 4


def _router(pkg):
    """A 4-shard router over greedy_cpu with no dispatch threads: the test
    runs every dispatch cycle itself.  Steal pacing and the load cache are
    set so no outcome depends on the wall clock."""
    if pkg == "jax":
        mod, td, Dir, Spec = jsr, jtd, JDir, JSpec
        pol = lambda k: jpol.make_policy("greedy_cpu", max_servants=64,
                                         avoid_self=False)
    else:
        mod, td, Dir, Spec = tsr, ttd, TDir, TSpec
        pol = lambda k: tpol.make_policy("greedy_cpu", avoid_self=False,
                                         device="cpu")
    directory = Dir([Spec("ci", tier="batch", max_outstanding=12),
                     Spec("dev", tier="interactive")])
    steal = mod.StealConfig(load_refresh_s=0.0, donor_timeout_s=10.0,
                            dry_backoff_initial_s=1e-9,
                            dry_backoff_max_s=1e-9)
    router = mod.ShardRouter.build(
        pol, N_SHARDS, max_servants_per_shard=64, steal=steal,
        min_memory_for_new_task=1, batch_window_s=0.0,
        start_dispatch_thread=False, tenant_directory=directory)
    return router, td


def _pumped(router, fn):
    """Run ``fn`` (a blocking router call) on a thread while this thread
    runs dispatch cycles until it returns."""
    box = []
    worker = threading.Thread(target=lambda: box.append(fn()))
    worker.start()
    while worker.is_alive():
        router.run_dispatch_cycle_for_testing()
        worker.join(0.0005)
    return box[0]


def _drive(pkg):
    router, td = _router(pkg)
    rng = np.random.default_rng(17)
    servants = [f"10.1.{k // 200}.{k % 200}:8335" for k in range(40)]
    caps = {loc: int(rng.integers(2, 7)) for loc in servants}
    total = sum(caps.values())
    log = []
    try:
        for loc in servants:
            assert router.keep_servant_alive(td.ServantInfo(
                location=loc, version=1, num_processors=8, capacity=caps[loc],
                dedicated=bool(rng.random() < 0.3), total_memory=1 << 30,
                memory_available=1 << 30, env_digests=ENVS), 60.0)
        log.append([router.shard_for_location(loc) for loc in servants])
        log.append([sorted(d.inspect()["servants"])
                    for d in router.shards])
        # A hot requestor (one home shard) and two spread ones; demand
        # up to the fleet's capacity, frees in between.
        requestors = ["hot-delegate", "delegate-a", "delegate-b"]
        held = []
        outstanding = 0
        for step in range(60):
            if held and (outstanding >= total - 2 or rng.random() < 0.25):
                k = int(rng.integers(len(held)))
                ids = held.pop(k)
                router.free_task(ids)
                outstanding -= len(ids)
                log.append(("free", ids))
                continue
            n = int(min(rng.integers(1, 9), total - outstanding))
            who = requestors[0 if rng.random() < 0.6
                             else int(rng.integers(1, 3))]
            tenant = ("ci", "dev", "")[int(rng.integers(3))]
            home = router.resolve_home(who)
            decision = router.admission_check(
                immediate=n, requestor=who, tenant=tenant,
                tier={"ci": "batch", "dev": "interactive"}.get(tenant, ""),
                home=home)
            entry = ["ask", who, tenant, n, home, decision.flow,
                     decision.rung, decision.retry_after_ms]
            if decision.flow == 0:
                routed = _pumped(router, lambda: (
                    router.wait_for_starting_new_task_routed(
                        ENVS[step % 2], requestor=who, immediate=n,
                        timeout_s=10.0, home=home, tenant=tenant)))
                got = [(g.grant_id, g.servant_location, g.shard_id, g.stolen)
                       for g in routed.grants]
                assert len(got) == n, (pkg, step)
                entry.append(got)
                ids = [g[0] for g in got]
                held.append(ids)
                outstanding += len(ids)
            log.append(entry)
        log.append(router.steal_stats())
        ins = router.inspect()

        def stats(d):
            # Lease adoption (warm-standby takeover) is not ported: its
            # counter is the JAX package's alone.
            return {k: v for k, v in d.items() if k != "adopted_grants"}

        log.append([(stats(p["stats"]), p["stats_by_tenant"],
                     p["tenant_budgets"], p["grants_outstanding"])
                    for p in ins["per_shard"]])
        log.append((stats(ins["stats"]), ins["grants_outstanding"],
                    ins["servants"]))
        # Keep-alive and free route by id alone.
        live = [g for ids in held for g in ids]
        log.append(router.keep_task_alive(live + [10 ** 6], 15.0))
        # A shard leaves the ring: its servants remap, and a remapped
        # servant's report is still judged grant by grant by the owning
        # shard (nothing in flight is killed), an unknown id is.
        router.ring_leave(1)
        log.append([router.shard_for_location(loc) for loc in servants])
        by_loc = {}
        for ids in held:
            for d in router.shards:
                for g in d.get_running_tasks():
                    if g.grant_id in ids:
                        by_loc.setdefault(g.servant_location, []).append(
                            g.grant_id)
        moved = sorted(loc for loc in by_loc
                       if router.shard_of_grant(by_loc[loc][0]) == 1)
        log.append([router.notify_servant_running_tasks(
            loc, by_loc[loc] + [10 ** 6 + 1]) for loc in moved])
        router.ring_join(1)
        log.append([router.shard_for_location(loc) for loc in servants])
        router.free_task(live)
        log.append(router.inspect()["grants_outstanding"])
    finally:
        router.stop()
    return log


def test_router_sequence_matches_jax():
    jax_log, torch_log = _drive("jax"), _drive("torch")
    assert len(jax_log) == len(torch_log)
    for i, (a, b) in enumerate(zip(jax_log, torch_log)):
        assert a == b, f"entry {i}: {a} != {b}"
    # The sequence exercised what it is meant to: steals, budget
    # refusals, grants on every shard, ids namespaced by shard.
    steal = torch_log[-8]
    assert steal["stolen_grants"] > 0
    asks = [e for e in torch_log if isinstance(e, list) and e[:1] == ["ask"]]
    assert any(e[5] != 0 for e in asks)
    granted = [g for e in asks if len(e) > 8 for g in e[8]]
    assert {g[2] for g in granted} == set(range(N_SHARDS))
    assert all((gid - 1) % N_SHARDS == shard for gid, _, shard, _ in granted)
    assert torch_log[-1] == 0
    # The ring churn: shard 1's servants moved and came back; a moved
    # servant's in-flight grants survived its report, the unknown id not.
    left, kills, back = torch_log[-4], torch_log[-3], torch_log[-2]
    assert 1 not in left and back == torch_log[0]
    assert kills and all(k == [10 ** 6 + 1] for k in kills)


def test_grant_namespacing_is_checked():
    with pytest.raises(ValueError):
        ttd.TaskDispatcher(tpol.make_policy("greedy_cpu", device="cpu"),
                           max_servants=8, grant_id_start=5,
                           grant_id_stride=4, start_dispatch_thread=False)
    ds = [ttd.TaskDispatcher(tpol.make_policy("greedy_cpu", device="cpu"),
                             max_servants=8, grant_id_start=k + 1,
                             grant_id_stride=3, start_dispatch_thread=False)
          for k in range(2)]
    with pytest.raises(ValueError):
        tsr.ShardRouter(ds)
    for d in ds:
        d.stop()
    router = tsr.ShardRouter.build(
        lambda k: tpol.make_policy("greedy_cpu", device="cpu"), 2,
        max_servants_per_shard=8, grant_namespace=(2, 3),
        start_dispatch_thread=False)
    assert [router.shard_of_grant(d._next_grant_id)
            for d in router.shards] == [0, 1]
    # The parked wait is ported: with no servant anywhere the steal finds
    # no donor, the request parks on its home shard, and stop answers it
    # once, empty.
    fired = []
    router.submit_wait_for_starting_new_task("e", timeout_s=30.0,
                                             on_done=fired.append)
    assert fired == [] and sum(len(d._pending) for d in router.shards) == 1
    assert router.steal_stats()["steal_no_donor"] == 1
    # Lease adoption is ported: an empty replay adopts nothing, and a
    # grant outside the cell's namespace is refused by its shard.
    assert router.adopt_grants("loc", []) == 0
    with pytest.raises(ValueError, match="namespace"):
        router.adopt_grants("loc", [(1, "e", "r")])
    router.stop()
    assert fired == [[]]


def _steal_run(pkg, parked):
    """tests/test_shard_router.py's async steal scenario (a hot delegate
    homed on shard 1 asks for the fleet's whole capacity, request by
    request) on one package's router, through the blocking routed wait
    or the parked one.  No dispatch threads: this thread runs every
    cycle, so no outcome depends on the wall clock."""
    router, td = _router(pkg)
    rng = np.random.default_rng(11)
    locs = [f"10.{k >> 16 & 255}.{k >> 8 & 255}.{k & 255}:8335"
            for k in range(32)]
    caps = {loc: int(rng.integers(2, 6)) for loc in locs}
    log = []
    try:
        for loc in locs:
            assert router.keep_servant_alive(td.ServantInfo(
                location=loc, version=1, num_processors=caps[loc] * 2,
                dedicated=True, capacity=caps[loc], total_memory=1 << 30,
                memory_available=1 << 30, env_digests=ENVS), 60.0)
        hot = next(f"delegate-{i}" for i in range(10000)
                   if router.shard_for_location(f"delegate-{i}") == 1)
        left = sum(caps.values())
        while left > 0:
            n = min(int(rng.integers(1, 8)), left)
            left -= n
            kw = dict(requestor=hot, immediate=n, timeout_s=5.0)
            if parked:
                box = []
                router.submit_wait_for_starting_new_task_routed(
                    ENVS[0], on_done=box.append, **kw)
                for _ in range(1000):
                    if box:
                        break
                    router.run_dispatch_cycle_for_testing()
                assert len(box) == 1, (pkg, n)
                routed = box[0]
            else:
                routed = _pumped(router, lambda: (
                    router.wait_for_starting_new_task_routed(
                        ENVS[0], **kw)))
            log.append((routed.shard_id, routed.stolen_count,
                        [(g.grant_id, g.servant_location, g.shard_id,
                          g.stolen) for g in routed.grants]))
        occ = {}
        for g in (g for d in router.shards for g in d.get_running_tasks()):
            occ[g.servant_location] = occ.get(g.servant_location, 0) + 1
        log.append(router.steal_stats())
        log.append(occ == caps)
    finally:
        router.stop()
    return log


def test_parked_routed_wait_steals_as_the_jax_router():
    """The parked routed wait and its asynchronous steal, against the
    JAX router's parked wait and both packages' blocking wait: the same
    grants request by request, the same stolen counts and steal stats,
    every servant filled to its capacity."""
    want = _steal_run("jax", parked=True)
    assert _steal_run("torch", parked=True) == want
    assert _steal_run("torch", parked=False) == want
    assert _steal_run("jax", parked=False) == want
    stats, full = want[-2], want[-1]
    assert full and stats["stolen_grants"] > 0
    assert sum(e[1] for e in want[:-2]) == stats["stolen_grants"]
    ids = [g[0] for e in want[:-2] for g in e[2]]
    assert len(ids) == len(set(ids))


@pytest.mark.parametrize("fleet,shards", [(8192, 4), (5000, 8), (100, 2),
                                          (40000, 8)])
def test_sharded_registry_size_matches_jax(fleet, shards):
    assert tentry.sharded_registry_size(fleet, shards) == \
        jentry.sharded_registry_size(fleet, shards)


# ---------------------------------------------------------------------------
# The entry: --shards 4 --device cpu on the threaded front end.
# ---------------------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_entry_serves_four_shards_on_cpu():
    from yadcc_tpu_torch import api
    from yadcc_tpu_torch.rpc import Channel, RpcError
    from yadcc_tpu_torch.scheduler.service import SERVICE_NAME
    from yadcc_tpu_torch.utils import exposed_vars

    port = _free_port()
    args = tentry.build_arg_parser().parse_args([
        "--port", str(port), "--inspect-port", "0", "--device", "cpu",
        "--shards", "4", "--max-servants", "256",
        "--acceptable-user-tokens", "utok",
        "--acceptable-servant-tokens", "stok", "--allow-self-dispatch"])
    stop = threading.Event()
    rc = []
    server = threading.Thread(
        target=lambda: rc.append(tentry.scheduler_start(args, stop,
                                                        gc_guard=False)),
        daemon=True)
    server.start()
    sch = api.scheduler
    servants = {f"127.0.0.1:{21000 + i}": 2 + i % 3 for i in range(48)}
    seen, violations = [], []
    lock = threading.Lock()
    ch = Channel(f"grpc://127.0.0.1:{port}")
    try:
        for _ in range(300):
            try:
                ch.call(SERVICE_NAME, "GetConfig",
                        sch.GetConfigRequest(token="utok"),
                        sch.GetConfigResponse, timeout=1.0)
                break
            except RpcError:
                threading.Event().wait(0.05)
        for loc, cap in servants.items():
            hb = sch.HeartbeatRequest(
                token="stok", next_heartbeat_in_ms=10_000, location=loc,
                version=1, num_processors=cap, capacity=cap,
                total_memory_in_bytes=64 << 30,
                memory_available_in_bytes=64 << 30)
            hb.env_descs.add(compiler_digest="gcc-12")
            ch.call(SERVICE_NAME, "Heartbeat", hb, sch.HeartbeatResponse,
                    timeout=5.0)

        def delegate(d):
            chan = Channel(f"grpc://127.0.0.1:{port}")
            try:
                for _ in range(10):
                    # 64 is more than any one shard's capacity (at most
                    # 57 here), so every request outruns its home shard
                    # and steals, however the delegates interleave.
                    req = sch.WaitForStartingTaskRequest(
                        token="utok", milliseconds_to_wait=300,
                        immediate_reqs=64, next_keep_alive_in_ms=10_000)
                    req.env_desc.compiler_digest = "gcc-12"
                    try:
                        resp, _ = chan.call(
                            SERVICE_NAME, "WaitForStartingTask", req,
                            sch.WaitForStartingTaskResponse, timeout=10.0)
                    except RpcError as e:
                        if e.status == sch.SCHEDULER_STATUS_NO_QUOTA_AVAILABLE:
                            continue
                        raise
                    with lock:
                        for g in resp.grants:
                            seen.append(g.task_grant_id)
                            if (g.task_grant_id - 1) % 4 != g.shard_id:
                                violations.append(
                                    f"id {g.task_grant_id} from shard "
                                    f"{g.shard_id}")
                            if g.stolen != (g.shard_id != resp.shard_id):
                                violations.append("stolen flag")
                    ids = [g.task_grant_id for g in resp.grants]
                    if ids:
                        chan.call(SERVICE_NAME, "FreeTask",
                                  sch.FreeTaskRequest(token="utok",
                                                      task_grant_ids=ids),
                                  sch.FreeTaskResponse, timeout=5.0)
            finally:
                chan.close()

        threads = [threading.Thread(target=delegate, args=(d,), daemon=True)
                   for d in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
        assert not violations, violations[:5]
        assert len(seen) >= 200 and len(seen) == len(set(seen))
        td = exposed_vars.collect("yadcc")["yadcc"]["task_dispatcher"]
        assert td["n_shards"] == 4 and td["servants"] == len(servants)
        assert td["failure"] is None
        assert td["stats"]["granted"] == len(seen)
        # Each grant was freed through its own shard: none is left on
        # any of them.  A delegate's demand outruns its home shard, so
        # the steal spreads grants over several shards.
        assert [p["grants_outstanding"] for p in td["per_shard"]] == [0] * 4
        assert [p["stats"]["granted"] for p in td["per_shard"]] == [
            sum(1 for g in seen if (g - 1) % 4 == k) for k in range(4)]
        assert len({(g - 1) % 4 for g in seen}) >= 2
        assert td["steal"]["stolen_grants"] > 0
    finally:
        ch.close()
        stop.set()
        server.join(timeout=15)
    assert not server.is_alive()
    assert rc == [0]
