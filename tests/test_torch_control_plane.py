"""The port's one-card control plane against the JAX package's mesh, on the
CPU.

The fused step (parallel/mesh.py:resident_control_plane_step) against
resident_control_plane_step_fn on a 4-device CPU mesh (conftest forces
8): N = 4 shards, chained cycles with statics churn, running corrections
and resets, delta padding beside a real index at the next shard's slot
0, one shard with no launch, G padded to the cycle's maximum, on the
picks route and the counts route.  Then run_fused_cycle on a JAX
ShardRouter and the port's from the same state, and the load summary
against shard_load_summary_fn.  Everything compared is an integer: the
tolerance is 0 (exact equality)."""

from __future__ import annotations

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yadcc_tpu.ops import assignment as jasn
from yadcc_tpu.ops import assignment_grouped as jasg
from yadcc_tpu.parallel import mesh as jmesh
from yadcc_tpu.scheduler import policy as jpol
from yadcc_tpu.scheduler import shard_router as jsr
from yadcc_tpu.scheduler import task_dispatcher as jtd
from yadcc_tpu_torch.ops import assignment as tasn
from yadcc_tpu_torch.ops import assignment_grouped as tasg
from yadcc_tpu_torch.ops import cuda_grouped as kg
from yadcc_tpu_torch.parallel import mesh as tmesh
from yadcc_tpu_torch.scheduler import policy as tpol
from yadcc_tpu_torch.scheduler import shard_router as tsr
from yadcc_tpu_torch.scheduler import task_dispatcher as ttd

from .test_device_resident import (churn_slots, make_host_pool,
                                   random_descr, statics_of)

N, PER = 4, 32          # the JAX mesh takes 4 of conftest's 8 CPU devices
FIELDS = tasn.PoolArrays._fields


def _stacked(rng, hosts, launching):
    """One cycle's inputs for every shard, stacked as both packages take
    them: churn (dirty lists) and descriptors for the launching shards,
    an all-padding delta and zero descriptors for the others."""
    descrs = [random_descr(rng, PER, int(rng.integers(1, 4)))
              if k in launching else [] for k in range(N)]
    dirties = [churn_slots(rng, hosts[k], int(rng.integers(1, 5)))
               if k in launching else [] for k in range(N)]
    # Shard 1's slot 0 is dirty whenever it launches, right after shard
    # 0's padding (idx == PER) in the flattened order.
    if 1 in launching and 0 not in dirties[1]:
        hosts[1]["capacity"][0] = rng.integers(1, 9)
        dirties[1] = sorted(dirties[1] + [0])
    g_pad = max(tasg.group_pad(len(d)) for d in descrs)
    d_pad = max(tasg.delta_pad(len(d)) for d in dirties)
    t_max = max(tasg.task_pad(sum(x[3] for x in d)) for d in descrs)
    packed = np.zeros((N, 4, g_pad), np.int32)
    idx = np.full((N, d_pad), PER, np.int32)
    rows = {f: np.zeros((N, d_pad), np.int32)
            for f in ("alive", "capacity", "dedicated", "version")}
    env = np.zeros((N, d_pad, hosts[0]["env_bitmap"].shape[1]), np.uint32)
    for k in launching:
        packed[k] = tasg.make_grouped_packed_host(descrs[k], g_pad)
        di = np.asarray(dirties[k], np.int64)
        idx[k, :len(di)] = di
        for f, a in rows.items():
            a[k, :len(di)] = hosts[k][f][di]
        env[k, :len(di)] = hosts[k]["env_bitmap"][di]
    adj = rng.integers(-2, 2, N * PER).astype(np.int32)
    rmask = rng.random(N * PER) < 0.05
    rval = rng.integers(0, 4, N * PER).astype(np.int32)
    return dict(packed=packed, idx=idx, rows=rows, env=env, adj=adj,
                rmask=rmask, rval=rval, t_max=t_max, descrs=descrs)


def _jax_delta(c):
    return jasg.PoolDelta(
        idx=jnp.asarray(c["idx"]), alive=jnp.asarray(c["rows"]["alive"]),
        capacity=jnp.asarray(c["rows"]["capacity"]),
        dedicated=jnp.asarray(c["rows"]["dedicated"]),
        version=jnp.asarray(c["rows"]["version"]),
        env_rows=jnp.asarray(c["env"]))


def _torch_delta(c):
    t = torch.from_numpy
    return tasg.PoolDelta(
        idx=t(c["idx"]), alive=t(c["rows"]["alive"]),
        capacity=t(c["rows"]["capacity"]),
        dedicated=t(c["rows"]["dedicated"]),
        version=t(c["rows"]["version"]),
        env_rows=t(c["env"].view(np.int32)))


def _torch_pool_np(pool):
    out = {f: getattr(pool, f).numpy() for f in FIELDS}
    out["env_bitmap"] = out["env_bitmap"].view(np.uint32)
    return out


@pytest.mark.parametrize("return_picks", [True, False],
                         ids=["picks", "counts"])
def test_fused_step_matches_jax_over_chained_cycles(return_picks):
    rng = np.random.default_rng(29)
    mesh = jmesh.make_mesh(N)
    hosts = [make_host_pool(rng, PER, "uniform") for _ in range(N)]
    cat = {f: np.concatenate([h[f] for h in hosts]) for f in FIELDS}
    jpool = jax.tree.map(
        jax.device_put, jasn.PoolArrays(**{f: jnp.asarray(cat[f])
                                           for f in FIELDS}),
        jmesh.pool_sharding(mesh))
    tpool = tasn.pool_from_numpy(*(cat[f] for f in FIELDS), "cpu")
    fns = {}
    granted = 0
    # Shard 2 never launches in the second cycle; shard 3 in the third.
    for cycle, launching in enumerate(([0, 1, 2, 3], [0, 1, 3], [0, 1, 2],
                                       [0, 1, 2, 3])):
        c = _stacked(rng, hosts, launching)
        key = c["t_max"] if return_picks else "counts"
        if key not in fns:
            fns[key] = jmesh.resident_control_plane_step_fn(
                mesh, c["t_max"], return_picks=return_picks)
        jout, jpool = fns[key](
            jpool, _jax_delta(c), jnp.asarray(c["packed"]),
            jnp.asarray(c["adj"]), jnp.asarray(c["rmask"]),
            jnp.asarray(c["rval"]))
        t = torch.from_numpy
        tout, tpool = tmesh.resident_control_plane_step(
            tpool, _torch_delta(c), t(c["packed"]), t(c["adj"]),
            t(c["rmask"]), t(c["rval"]), c["t_max"],
            return_picks=return_picks)
        jout = np.asarray(jout)
        assert tout.dtype == torch.int32
        assert np.array_equal(tout.numpy(), jout), f"cycle {cycle}"
        tp = _torch_pool_np(tpool)
        for f in FIELDS:
            assert np.array_equal(tp[f], np.asarray(getattr(jpool, f))), \
                f"cycle {cycle}: {f}"
        # The statics the deltas carried reached every shard's slice.
        for k in range(N):
            for f, v in statics_of(hosts[k]).items():
                assert np.array_equal(tp[f][k * PER:(k + 1) * PER], v)
        granted += int((jout != jasn.NO_PICK).sum()) if return_picks \
            else int(jout.sum())
    assert granted > 0


def test_fused_step_refuses_duplicate_indices_on_the_cpu():
    rng = np.random.default_rng(3)
    hosts = [make_host_pool(rng, PER, "uniform") for _ in range(N)]
    cat = {f: np.concatenate([h[f] for h in hosts]) for f in FIELDS}
    pool = tasn.pool_from_numpy(*(cat[f] for f in FIELDS), "cpu")
    c = _stacked(rng, hosts, [0, 1, 2, 3])
    c["idx"][2, :2] = 5
    t = torch.from_numpy
    with pytest.raises(ValueError, match="at most once"):
        kg.cuda_resident_control_plane_step(
            pool, _torch_delta(c), t(c["packed"]), t(c["adj"]),
            t(c["rmask"]), t(c["rval"]), c["t_max"])


def test_load_summary_matches_jax():
    rng = np.random.default_rng(41)
    mesh = jmesh.make_mesh(N)
    s = N * 48
    alive = rng.random(s) < 0.7
    cap = rng.integers(0, 20, s).astype(np.int32)
    run = rng.integers(0, 25, s).astype(np.int32)
    want = np.asarray(jmesh.shard_load_summary_fn(mesh)(
        *jmesh.shard_pool_loads(mesh, alive, cap, run)))
    got = tmesh.shard_load_summary(torch.from_numpy(alive),
                                   torch.from_numpy(cap),
                                   torch.from_numpy(run), N)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    assert tmesh.control_plane_shard_slices(8192, 3) == \
        jmesh.control_plane_shard_slices(8192, 3)


# ---------------------------------------------------------------------------
# run_fused_cycle on both routers from the same state.
# ---------------------------------------------------------------------------

ENVS = tuple(f"env-{i}" for i in range(4))


def _fused_router(pkg):
    if pkg == "jax":
        mod, td = jsr, jtd
        router = mod.ShardRouter.build(
            lambda k: jpol.make_policy("greedy_cpu", max_servants=PER,
                                       avoid_self=False), N,
            max_servants_per_shard=PER, mesh=jmesh.make_mesh(N),
            steal=mod.StealConfig(enabled=False),
            min_memory_for_new_task=1, start_dispatch_thread=False)
    else:
        mod, td = tsr, ttd
        router = mod.ShardRouter.build(
            lambda k: tpol.make_policy("greedy_cpu", avoid_self=False,
                                       device="cpu"), N,
            max_servants_per_shard=PER, device="cpu",
            steal=mod.StealConfig(enabled=False),
            min_memory_for_new_task=1, start_dispatch_thread=False)
    return router, td


def _fused_drive(pkg):
    router, td = _fused_router(pkg)
    rng = np.random.default_rng(53)
    log = []

    def beat(loc, cap, envs):
        router.keep_servant_alive(td.ServantInfo(
            location=loc, version=1, num_processors=16, capacity=cap,
            dedicated=loc.endswith("7:8335"), total_memory=1 << 30,
            memory_available=1 << 30, env_digests=envs), 60.0)

    fleet = {f"10.2.0.{k}:8335": (int(rng.integers(1, 6)),
                                  tuple(sorted(rng.choice(ENVS, 2,
                                                          replace=False))))
             for k in range(48)}
    try:
        for loc, (cap, envs) in fleet.items():
            beat(loc, cap, envs)
        router.enable_fused_dispatch(oracle_interval=2)
        held = []
        for cycle in range(6):
            # Requests, each enqueued before the next so every shard's
            # pending order is the same in both packages.
            waiters, box = [], []
            for i, who in enumerate(("d-1", "d-2", "d-3", "d-4", "d-5")
                                    [:2 + cycle % 4]):
                shard = router.shards[router.resolve_home(who)]
                before = shard.inspect()["pending_requests"]
                t = threading.Thread(target=lambda w=who, e=ENVS[(
                    cycle + i) % 4]: box.append((w, router.wait_for_starting_new_task(
                        e, requestor=w, immediate=1 + (cycle + i) % 3,
                        timeout_s=5.0))))
                t.start()
                waiters.append(t)
                while (t.is_alive()
                       and shard.inspect()["pending_requests"] == before):
                    t.join(0.0005)
                assert t.is_alive(), "the waiter ended before it queued"
            issued = router.run_fused_cycle()
            for t in waiters:
                t.join(10)
                assert not t.is_alive()
            got = sorted(box)
            log.append((issued, got, [
                (c["shard"], c["picks"].tolist())
                for c in router._fused["last_cycle"]]))
            held += [g for _, grants in got for g, _ in grants]
            # Frees and statics churn between cycles.
            free = held[:len(held) // 2]
            held = held[len(held) // 2:]
            router.free_task(free)
            for loc in list(fleet)[cycle::7]:
                cap, envs = fleet[loc]
                fleet[loc] = (cap % 5 + 1, envs)
                beat(loc, *fleet[loc])
        router.free_task(held)
        log.append(router.run_fused_cycle())
        ins = router.inspect()
        log.append((ins["fused"], ins["grants_outstanding"],
                    {k: v for k, v in ins["stats"].items()
                     if k != "adopted_grants"}))
    finally:
        router.stop()
    return log


def test_run_fused_cycle_matches_jax():
    jax_log, torch_log = _fused_drive("jax"), _fused_drive("torch")
    assert len(jax_log) == len(torch_log)
    for i, (a, b) in enumerate(zip(jax_log, torch_log)):
        assert a == b, f"entry {i}: {a} != {b}"
    fused = torch_log[-1][0]
    assert fused["fused_cycles"] == 6 and fused["oracle_checks"] > 0
    assert fused["oracle_mismatches"] == 0
    assert sum(issued for issued, _, _ in torch_log[:6]) > 0
    assert torch_log[-1][1] == 0
