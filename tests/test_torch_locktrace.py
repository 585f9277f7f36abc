"""Lock-order tracing of the port (yadcc_tpu_torch/utils/locktrace.py)
against the JAX package's (yadcc_tpu/utils/locktrace.py).

Every detector fixture of tests/test_locktrace.py runs on both packages'
tracers, one after the other and never nested: the edge counts, the
violation counts and the cycles' lengths are equal, and the reports
differ only by each tracer's own lock serials.  The execution engine's
fixture runs each package's own engine, whose lock names differ only
by package.  Then the port's scheduler under tracing: the churn storm
(greedy and the grouped policy's plain version) and the pipelined
churn, with no lock-order cycle through a lock of the port; and the
scheduler entry as a program with YTPU_LOCKTRACE=1, whose
/inspect/vars shows ``yadcc/locktrace`` with no violation after a few
grants.

Both tracers save ``threading.Lock`` when first imported, so both are
imported here, at the top, before either is installed.
"""

from __future__ import annotations

import gc
import json
import os
import pathlib
import random
import re
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.request

import pytest

from yadcc_tpu.utils import locktrace as jlt
from yadcc_tpu_torch.utils import locktrace as tlt

REPO = pathlib.Path(__file__).resolve().parent.parent
TRACERS = {"jax": jlt, "port": tlt}


# -- the detector fixtures of tests/test_locktrace.py, on a given tracer --


def fx_abba(lt):
    with lt.installed() as g:
        a = threading.Lock()
        b = threading.Lock()
        with a:
            with b:
                pass
        with b:
            with a:   # reverse order: potential deadlock
                pass
    assert len(g.violations) == 1
    assert "lock-order cycle" in g.violations[0]
    return g


def fx_consistent_order_and_reentry(lt):
    with lt.installed() as g:
        a = threading.Lock()
        b = threading.Lock()
        r = threading.RLock()
        for _ in range(3):
            with a:
                with b:
                    pass
        with r:
            with r:    # re-entry is not an edge
                pass
        with a:
            with r:
                pass
    assert g.violations == []
    return g


def fx_three_lock_cycle(lt):
    with lt.installed() as g:
        a, b, c = (threading.Lock() for _ in range(3))
        with a:
            with b:
                pass
        with b:
            with c:
                pass
        with c:
            with a:
                pass
    assert len(g.violations) == 1
    return g


def fx_condition_wait(lt):
    with lt.installed() as g:
        lock = threading.Lock()
        cv = threading.Condition(lock)
        other = threading.Lock()
        done = threading.Event()

        def waiter():
            with cv:
                cv.wait(timeout=5)
                done.set()

        t = threading.Thread(target=waiter, daemon=True)
        t.start()
        time.sleep(0.05)
        with cv:
            cv.notify_all()
        t.join(timeout=5)
        assert done.is_set()
        with cv:
            with other:
                pass
    assert g.violations == []
    return g


def fx_inspect_surface(lt):
    with lt.installed() as g:
        a = threading.Lock()
        b = threading.Lock()
        with a:
            with b:
                pass
        snap = g.inspect()
    assert snap["edges"] == 1
    assert snap["violations"] == []
    assert len(snap["locks"]) == 2
    return g


def fx_nested_install_restores_ambient(lt):
    outer = lt.install()
    try:
        lock_a = threading.Lock()
        with lock_a:
            pass
        with lt.installed() as inner:
            assert inner is not outer
            assert inner.violations == []
            b = threading.Lock()
            c = threading.Lock()
            with b:
                with c:
                    pass
            with c:
                with b:
                    pass
            assert len(inner.violations) == 1
        assert lt.active_graph() is outer
        d = threading.Lock()
        with lock_a:
            with d:
                pass
        assert outer.violations == []
    finally:
        lt.uninstall()
    assert lt.active_graph() is None
    return inner


def fx_cross_thread_release(lt):
    with lt.installed() as g:
        lock = threading.Lock()
        other = threading.Lock()
        acquired = threading.Event()
        release_now = threading.Event()

        def acquirer():
            lock.acquire()
            acquired.set()
            release_now.wait(5)
            with other:
                pass

        t = threading.Thread(target=acquirer, daemon=True)
        t.start()
        assert acquired.wait(5)
        lock.release()          # handoff release from the main thread
        with other:
            with lock:
                pass
        release_now.set()
        t.join(timeout=5)
    assert g.violations == [], g.violations
    return g


def fx_gc_prunes(lt):
    with lt.installed() as g:
        keep = threading.Lock()
        tmp = threading.Lock()
        with keep:
            with tmp:
                pass
        assert g.inspect()["edges"] == 1
        del tmp
        gc.collect()
        probe = threading.Lock()   # drains the GC queue on acquire
        with probe:
            pass
        assert g.inspect()["edges"] == 0
    assert g.violations == []
    return g


def fx_same_line_distinct(lt):
    with lt.installed() as g:
        out = []
        barrier = threading.Barrier(8)

        def born():
            barrier.wait()
            out.append(threading.Lock())   # same construction line x8

        ts = [threading.Thread(target=born) for _ in range(8)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(5)
        names = {lk._name for lk in out}
        assert len(names) == 8, names
        for lk in out:
            with lk:
                pass
    return g


def fx_rlock_reentry_with_intermediate(lt):
    with lt.installed() as g:
        r = threading.RLock()
        a = threading.Lock()
        with r:
            with a:
                with r:
                    pass
    assert g.violations == [], g.violations
    return g


def fx_born_in_nested_window(lt):
    outer = lt.install()
    try:
        with lt.installed():
            inner_born = threading.Lock()
        mate = threading.Lock()
        with inner_born:
            with mate:
                pass
        with mate:
            with inner_born:
                pass
        assert len(outer.violations) == 1, outer.violations
    finally:
        lt.uninstall()
    return outer


FIXTURES = [fx_abba, fx_consistent_order_and_reentry, fx_three_lock_cycle,
            fx_condition_wait, fx_inspect_surface,
            fx_nested_install_restores_ambient, fx_cross_thread_release,
            fx_gc_prunes, fx_same_line_distinct,
            fx_rlock_reentry_with_intermediate, fx_born_in_nested_window]


def _summary(g, pkg_name=None):
    """What must agree across packages: edges, lock count, violation
    count, each cycle's length, and the reports with each tracer's own
    lock serials (and, for package-built locks, the package and line)
    taken out."""
    snap = g.inspect()

    def norm(text):
        text = re.sub(r"#\d+", "#N", text)
        if pkg_name is not None:
            text = re.sub(rf"{pkg_name}\.([\w.]+):\d+", r"PKG.\1:L", text)
            text = re.sub(r"\(at [\w.]+:\d+\)", "(at SITE)", text)
        return text

    return {
        "edges": snap["edges"],
        "locks": len(snap["locks"]),
        "saturated": snap["saturated"],
        "violations": len(snap["violations"]),
        "cycle_lengths": sorted(v.count(" -> ") for v in snap["violations"]),
        "reports": sorted(norm(v) for v in snap["violations"]),
        "names": sorted(norm(n) for n in snap["locks"]),
    }


@pytest.mark.parametrize("fixture", FIXTURES, ids=lambda f: f.__name__[3:])
def test_detector_fixture_equal_in_both_packages(fixture):
    # One after the other, never nested: each tracer is fully
    # uninstalled before the other installs.
    got = {}
    for pkg, lt in TRACERS.items():
        got[pkg] = _summary(fixture(lt))
        assert lt.active_graph() is None
        assert threading.Lock is jlt._real_lock
    assert got["port"] == got["jax"]


def _engine_fixture(lt, engine_cls, tag):
    """tests/test_locktrace.py's execution engine run on a tracer:
    queue, kill and free slow commands from one thread."""
    with lt.installed() as g:
        eng = engine_cls(max_concurrency=4, min_memory_for_new_task=1)
        rng = random.Random(5)
        tids = []
        for i in range(12):
            # /bin/sleep with a tag: the hygiene sentinel flags a bare
            # `sleep N` left on the host.
            tid = eng.try_queue_task(grant_id=i, digest=f"d{i}",
                                     cmdline=f"/bin/sleep 30 {tag}",
                                     on_completion=lambda t, o: None)
            if tid is not None:
                tids.append((tid, i))
            if len(tids) >= 3:
                t0, g0 = tids.pop(rng.randrange(len(tids)))
                eng.kill_expired_tasks([g0])
                eng.free_task(t0)
        for tid, _ in tids:
            eng.free_task(tid)
        eng.stop()
        time.sleep(0.1)
    return g


def test_execution_engine_fixture_equal_in_both_packages():
    from yadcc_tpu.daemon.cloud.execution_engine import \
        ExecutionEngine as JEngine
    from yadcc_tpu_torch.daemon.cloud.execution_engine import \
        ExecutionEngine as TEngine

    jg = _engine_fixture(jlt, JEngine, "locktrace-jax")
    tg = _engine_fixture(tlt, TEngine, "locktrace-port")
    assert jg.violations == [] and tg.violations == []
    js, ts = _summary(jg, "yadcc_tpu"), _summary(tg, "yadcc_tpu_torch")
    assert ts["violations"] == js["violations"] == 0
    assert ts["edges"] == js["edges"]
    assert ts["names"] == js["names"], (ts["names"], js["names"])


def test_framework_violations_needle_is_the_port():
    """The port's filter keeps cycles through a lock the port built and
    drops cycles among other modules' locks (torch's, for example)."""
    assert tlt.framework_violations.__defaults__ == ("yadcc_tpu_torch",)
    with tlt.installed() as g:
        a, b = threading.Lock(), threading.Lock()
        with a:
            with b:
                pass
        with b:
            with a:
                pass
    assert len(g.violations) == 1
    assert tlt.framework_violations(g) == []     # built by this test
    assert tlt.framework_violations(g, needle="test_torch_locktrace")


# -- the port's scheduler under tracing ----------------------------------

ENVS = ("envA", "envB", "envC", "envD", "envE")


def _servant(i: int, capacity: int = 4):
    from yadcc_tpu_torch.scheduler.task_dispatcher import ServantInfo

    return ServantInfo(
        location=f"10.0.{i // 256}.{i % 256}:8335", version=1,
        capacity=capacity, num_processors=8, memory_available=64 << 30,
        env_digests=ENVS[i % 3: i % 3 + 3], dedicated=(i % 4 == 0))


def _churn_storm(policy, n_servants=30, ticks=10, min_granted=20,
                 deadline_s=15.0):
    """tests/test_stress.py's churn storm on the port's dispatcher
    (virtual clock, racing delegates, frees, deaths, joins, leaves and
    heartbeats); every grant freed and no capacity leaked at the end.

    The storm runs at least ``ticks`` ticks and then on until the
    dispatcher has granted more than ``min_granted`` (or ``deadline_s``
    of wall time passed): on a loaded host ten 20 ms ticks may grant
    too little, so the tick count is not what the checks depend on."""
    from yadcc_tpu_torch.scheduler.task_dispatcher import TaskDispatcher
    from yadcc_tpu_torch.utils.clock import VirtualClock

    clock = VirtualClock(1000.0)
    d = TaskDispatcher(policy, max_servants=64, max_envs=64, clock=clock,
                       batch_window_s=0.0, start_dispatch_thread=True)
    stop = threading.Event()
    state_lock = threading.Lock()
    alive = {i: clock.now() for i in range(n_servants)}
    running = {_servant(i).location: set() for i in range(n_servants)}
    held: list = []
    errors: list = []
    for i in range(n_servants):
        assert d.keep_servant_alive(_servant(i), 10.0)

    def delegate(seed):
        rng = random.Random(seed)
        try:
            while not stop.is_set():
                got = d.wait_for_starting_new_task(
                    rng.choice(ENVS[:3]), requestor="",
                    immediate=rng.randint(1, 3), prefetch=rng.randint(0, 1),
                    lease_s=15.0, timeout_s=0.05)
                with state_lock:
                    for gid, loc in got:
                        held.append((gid, loc))
                        running.setdefault(loc, set()).add(gid)
        except Exception as e:   # reported below
            errors.append(repr(e))

    def freer(seed):
        rng = random.Random(seed)
        try:
            while not stop.is_set():
                with state_lock:
                    batch = [held.pop(rng.randrange(len(held)))
                             for _ in range(min(len(held),
                                                rng.randint(1, 8)))]
                if batch:
                    if rng.random() < 0.5:
                        d.keep_task_alive([g for g, _ in batch], 15.0)
                    d.free_task([g for g, _ in batch])
                    with state_lock:
                        for gid, loc in batch:
                            running.get(loc, set()).discard(gid)
                time.sleep(0.001)
        except Exception as e:   # reported below
            errors.append(repr(e))

    threads = [threading.Thread(target=delegate, args=(s,), daemon=True)
               for s in range(4)]
    threads += [threading.Thread(target=freer, args=(100 + s,), daemon=True)
                for s in range(2)]
    for t in threads:
        t.start()
    rng = random.Random(7)
    deadline = time.monotonic() + deadline_s
    tick = 0
    try:
        while tick < ticks or (
                d.inspect()["stats"]["granted"] <= min_granted
                and time.monotonic() < deadline):
            tick += 1
            with state_lock:
                roll = rng.sample(sorted(alive), k=min(4, len(alive)))
            for i in roll:
                r = rng.random()
                if r < 0.3:
                    with state_lock:
                        alive.pop(i, None)      # silent death
                elif r < 0.5:
                    d.keep_servant_alive(_servant(i), 0.0)  # leave
                    with state_lock:
                        alive.pop(i, None)
                        running[_servant(i).location].clear()
            with state_lock:
                for i in range(n_servants):
                    if i not in alive and rng.random() < 0.3:
                        alive[i] = clock.now()
                alive_now = sorted(alive)
            for i in alive_now:
                info = _servant(i)
                if d.keep_servant_alive(info, 10.0):
                    with state_lock:
                        reported = sorted(running[info.location])
                    killed = d.notify_servant_running_tasks(info.location,
                                                            reported)
                    with state_lock:
                        for gid in killed:
                            running[info.location].discard(gid)
                            held[:] = [(g, lc) for g, lc in held
                                       if g != gid]
            clock.advance(1.0)
            d.on_expiration_timer()
            time.sleep(0.02)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=10)
    assert not errors, errors
    assert not any(t.is_alive() for t in threads)
    try:
        assert d.inspect()["stats"]["granted"] > min_granted
        with state_lock:
            d.free_task([g for g, _ in held])
            held.clear()
        clock.advance(120.0)
        d.on_expiration_timer()
        for i in range(n_servants):
            d.keep_servant_alive(_servant(i), 10.0)
            d.notify_servant_running_tasks(_servant(i).location, [])
        # Let the dispatcher's own thread finish a cycle that was in
        # flight when the storm stopped before the final snapshot.
        settle = time.monotonic() + 10
        while d.inspect()["grants_outstanding"] and \
                time.monotonic() < settle:
            time.sleep(0.05)
        snap = d.inspect()
        assert snap["grants_outstanding"] == 0
        assert all(s["running"] == 0 for s in snap["servants"].values())
        assert snap["failure"] is None
    finally:
        d.stop()


@pytest.mark.parametrize("policy_name", ["greedy_cpu", "torch_grouped"])
def test_port_churn_storm_is_lock_order_clean(policy_name):
    from yadcc_tpu_torch.scheduler import policy as tpol

    with tlt.installed() as graph:
        policy = tpol.make_policy(policy_name, avoid_self=False,
                                  device="cpu")
        _churn_storm(policy)
    assert not graph.saturated
    assert graph.inspect()["edges"] > 0
    bad = tlt.framework_violations(graph)
    assert bad == [], f"lock-order violations under churn: {bad}"
    # The dispatcher's own locks were traced: its module built nodes.
    assert any("yadcc_tpu_torch.scheduler.task_dispatcher" in n
               for n in graph.inspect()["locks"])


def test_port_pipelined_churn_is_lock_order_clean():
    """tests/test_pipelined_dispatch.py's churn on the port's pipelined
    loop (depth 4, K1's plain version): waiters, frees, servant death
    and slot recycling racing the pipeline, every grant freed."""
    from yadcc_tpu_torch.scheduler import policy as tpol
    from yadcc_tpu_torch.scheduler.task_dispatcher import TaskDispatcher

    with tlt.installed() as graph:
        policy = tpol.TorchGroupedPolicy("cpu", max_groups=8)
        d = TaskDispatcher(policy, max_servants=32, pipeline_depth=4,
                           batch_window_s=0.0)
        stop = threading.Event()
        errors: list = []
        granted = [0]
        try:
            for i in range(12):
                assert d.keep_servant_alive(_servant(i, 3), 3600.0)

            def waiter():
                try:
                    while not stop.is_set():
                        got = d.wait_for_starting_new_task(
                            "envC", immediate=2, prefetch=1, timeout_s=0.5)
                        granted[0] += len(got)
                        if got:
                            time.sleep(0.01)
                            d.free_task([gid for gid, _ in got])
                except Exception as e:   # reported below
                    errors.append(repr(e))

            def churner():
                i = 0
                try:
                    while not stop.is_set():
                        victim = 12 + (i % 6)
                        d.keep_servant_alive(_servant(victim, 3), 3600.0)
                        time.sleep(0.02)
                        d.keep_servant_alive(_servant(victim, 3), 0.0)
                        i += 1
                except Exception as e:   # reported below
                    errors.append(repr(e))

            threads = [threading.Thread(target=waiter) for _ in range(4)]
            threads.append(threading.Thread(target=churner))
            for t in threads:
                t.start()
            time.sleep(2.0)
            stop.set()
            for t in threads:
                t.join(timeout=10)
            assert not errors, errors
            assert granted[0] > 0
            d.free_task([g.grant_id for g in d.get_running_tasks()])
            deadline = time.monotonic() + 10
            while d.inspect()["grants_outstanding"] and \
                    time.monotonic() < deadline:
                time.sleep(0.05)
            snap = d.inspect()
            assert snap["grants_outstanding"] == 0
            assert snap["failure"] is None
        finally:
            stop.set()
            d.stop()
    assert not graph.saturated
    bad = tlt.framework_violations(graph)
    assert bad == [], f"lock-order violations under pipelined churn: {bad}"


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_scheduler_entry_with_locktrace_env_reports_no_violation():
    """`python -m yadcc_tpu_torch.scheduler.entry --device cpu` with
    YTPU_LOCKTRACE=1, in a process of its own (the hook is process-wide
    and never uninstalled): a few grants go through, and /inspect/vars
    shows yadcc/locktrace with edges and no violation."""
    from yadcc_tpu_torch import api
    from yadcc_tpu_torch.rpc import Channel, RpcError
    from yadcc_tpu_torch.scheduler.service import SERVICE_NAME

    port, iport = _free_port(), _free_port()
    env = dict(os.environ, YTPU_LOCKTRACE="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "yadcc_tpu_torch.scheduler.entry",
         "--port", str(port), "--inspect-port", str(iport),
         "--device", "cpu", "--max-servants", "64",
         "--acceptable-user-tokens", "utok",
         "--acceptable-servant-tokens", "stok", "--allow-self-dispatch"],
        cwd=REPO, env=env, stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE, text=True)
    ch = Channel(f"grpc://127.0.0.1:{port}")
    sch = api.scheduler
    try:
        deadline = time.monotonic() + 60
        while True:
            assert proc.poll() is None, proc.stderr.read()[-2000:]
            assert time.monotonic() < deadline, "the entry never came up"
            try:
                ch.call(SERVICE_NAME, "GetConfig",
                        sch.GetConfigRequest(token="utok"),
                        sch.GetConfigResponse, timeout=1.0)
                break
            except RpcError:
                time.sleep(0.1)
        hb = sch.HeartbeatRequest(
            token="stok", next_heartbeat_in_ms=10_000,
            location="127.0.0.1:20001", version=1, num_processors=8,
            capacity=4, total_memory_in_bytes=64 << 30,
            memory_available_in_bytes=64 << 30)
        hb.env_descs.add(compiler_digest="gcc-12")
        ch.call(SERVICE_NAME, "Heartbeat", hb, sch.HeartbeatResponse,
                timeout=5.0)
        granted = 0
        for _ in range(4):
            wreq = sch.WaitForStartingTaskRequest(
                token="utok", milliseconds_to_wait=2000, immediate_reqs=2,
                next_keep_alive_in_ms=10_000)
            wreq.env_desc.compiler_digest = "gcc-12"
            wresp, _ = ch.call(SERVICE_NAME, "WaitForStartingTask", wreq,
                               sch.WaitForStartingTaskResponse, timeout=10.0)
            ids = [g.task_grant_id for g in wresp.grants]
            granted += len(ids)
            ch.call(SERVICE_NAME, "FreeTask",
                    sch.FreeTaskRequest(token="utok", task_grant_ids=ids),
                    sch.FreeTaskResponse, timeout=5.0)
        assert granted == 8
        with urllib.request.urlopen(
                f"http://127.0.0.1:{iport}/inspect/vars/yadcc/locktrace",
                timeout=10) as r:
            trace = json.loads(r.read())["yadcc"]["locktrace"]
        assert trace["violations"] == []
        assert trace["saturated"] is False
        assert trace["edges"] > 0
        assert any(n.startswith("yadcc_tpu_torch.scheduler.")
                   for n in trace["locks"])
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
        assert "locktrace:" not in proc.stderr.read()
    finally:
        ch.close()
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        proc.stderr.close()
