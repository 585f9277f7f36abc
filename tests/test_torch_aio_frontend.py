"""The port's event-loop front end and parked grant wait against the JAX
package's, on the CPU.

The port's frame parser and request-payload helpers give the JAX ones'
frames on the same byte streams (split reads, several frames in one
read, malformed and oversized input); the port's threaded and aio servers
and the JAX aio server give byte-identical reply frames on the JAX
parity corpus; each package's aio client talks to the other's server;
the loop timer, a two-loop server group and the reply-once guard behave
as the JAX tests pin them; the parked grant wait, driven by manual
cycles on greedy_cpu and on the grouped policy's plain K1 (device cpu),
delivers the JAX dispatcher's grants to each continuation exactly once
and leaves the same running vector; the parked service path over each
package's aio server answers alike; and the entry serves a heartbeat and
a grant over aio:// with one and with two accept loops.  Every quantity
compared is bytes, an integer or a string: the tolerance is 0.  Every
test runs under the loop-lag watchdog (utils/looplag.py)."""

from __future__ import annotations

import asyncio
import socket
import struct
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from yadcc_tpu import api as japi
from yadcc_tpu.rpc import Channel as JChannel
from yadcc_tpu.rpc import ServiceSpec as JSpec
from yadcc_tpu.rpc import aio_server as jaio
from yadcc_tpu.scheduler import policy as jpol
from yadcc_tpu.scheduler import service as jsvc
from yadcc_tpu.scheduler import task_dispatcher as jtd
from yadcc_tpu.tools.rpc_frontend_bench import _make_blob
from yadcc_tpu.utils.clock import VirtualClock as JClock
from yadcc_tpu_torch import api
from yadcc_tpu_torch.common.payload import Payload
from yadcc_tpu_torch.rpc import (Channel, GrpcServer, RpcError, ServiceSpec,
                                 make_rpc_server)
from yadcc_tpu_torch.rpc import aio_server as taio
from yadcc_tpu_torch.rpc.transport import encode_frame
from yadcc_tpu_torch.scheduler import policy as tpol
from yadcc_tpu_torch.scheduler import service as tsvc
from yadcc_tpu_torch.scheduler import task_dispatcher as ttd
from yadcc_tpu_torch.utils import looplag
from yadcc_tpu_torch.utils.clock import VirtualClock as TClock

REPO = __import__("pathlib").Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _loop_lag_guard():
    """A handler that blocks a serving loop for more than 250 ms fails
    the test that caused it."""
    with looplag.installed() as session:
        yield session
    assert not session.violations, "; ".join(
        v.render() for v in session.violations)


# ---------------------------------------------------------------------------
# Frames: the parser and the request payload against the JAX module's.
# ---------------------------------------------------------------------------


def _envelope(mod, seq: int, service: str, method: str, frame) -> bytes:
    return b"".join(mod._envelope_segments(
        seq, mod.make_request_payload(service, method, frame)))


def _feed_both(chunks):
    """Feed the same chunks to both parsers; returns each one's output
    per chunk, or the exception type it raised."""
    out = []
    for mod in (jaio, taio):
        p = mod.FrameStreamParser()
        got = []
        try:
            for c in chunks:
                got.append(p.feed(c))
            got.append(p.pending_bytes())
        except mod.ProtocolError:
            got.append("ProtocolError")
        out.append(got)
    return out


def test_envelopes_and_payload_helpers_match_jax():
    rng = np.random.default_rng(3)
    for i in range(40):
        frame = rng.integers(0, 256, int(rng.integers(0, 3000)),
                             dtype=np.uint8).tobytes()
        svc, m = f"svc.{i}" * (i % 3), "Méthod" * (i % 4)
        assert _envelope(taio, i * 7919, svc, m, frame) == \
            _envelope(jaio, i * 7919, svc, m, frame)
        payload = b"".join(taio.make_request_payload(svc, m, frame))
        t, j = (taio.split_request_payload(payload),
                jaio.split_request_payload(payload))
        assert (t[0], t[1], bytes(t[2])) == (j[0], j[1], bytes(j[2]))
    for bad in (b"", b"\x01", struct.pack("<HH", 200, 200) + b"short"):
        with pytest.raises(taio.ProtocolError):
            taio.split_request_payload(bad)
        with pytest.raises(jaio.ProtocolError):
            jaio.split_request_payload(bad)


def test_parser_matches_jax_on_split_burst_and_malformed_streams():
    rng = np.random.default_rng(11)
    msgs = [_envelope(jaio, i, "s", "m", rng.integers(
        0, 256, int(rng.integers(0, 2048)), dtype=np.uint8).tobytes())
        for i in range(30)]
    stream = b"".join(msgs)
    # Several frames in one read, and random split points.
    j, t = _feed_both([stream])
    assert t == j and [s for s, _ in t[0]] == list(range(30))
    for _ in range(10):
        cuts = sorted(rng.integers(0, len(stream), 17).tolist())
        chunks = [stream[a:b] for a, b in
                  zip([0] + cuts, cuts + [len(stream)])]
        j, t = _feed_both(chunks)
        assert t == j and t[-1] == 0
    # A byte drip, and every truncation.
    one = _envelope(jaio, 3, "svc", "Method", b"y" * 300)
    j, t = _feed_both([one[i:i + 1] for i in range(len(one))])
    assert t == j and sum(len(x) for x in t[:-1]) == 1
    for cut in range(1, len(one) - 1, 7):
        j, t = _feed_both([one[:cut]])
        assert t == j and t[0] == []
    # Oversized and nonsense lengths, alone and after a good frame.
    for bad in (struct.pack("<II", 1 << 31, 1), struct.pack("<II", 3, 9),
                struct.pack("<II", (1 << 30) + 65, 2)):
        for chunks in ([bad], [one + bad], [one, bad]):
            j, t = _feed_both(chunks)
            assert t == j and t[-1] == "ProtocolError"


# ---------------------------------------------------------------------------
# Servers: byte parity on the JAX corpus, wire compatibility both ways.
# ---------------------------------------------------------------------------


def _parity_spec(spec_cls, rpc_error, api_mod):
    """tools/rpc_frontend_bench.py's parity service, on either package."""
    spec = spec_cls("ytpu.ParityProbe")

    def echo(req, attachment, ctx):
        ctx.response_attachment = bytes(attachment) + b"|echo"
        return api_mod.scheduler.GetConfigResponse(
            serving_daemon_token="parity:" + req.token)

    def fail_app(req, attachment, ctx):
        raise rpc_error(1234, "app failure, deterministically")

    def crash(req, attachment, ctx):
        raise ValueError("handler crash, deterministically")

    spec.add("Echo", api_mod.scheduler.GetConfigRequest, echo)
    spec.add("FailApp", api_mod.scheduler.GetConfigRequest, fail_app)
    spec.add("Crash", api_mod.scheduler.GetConfigRequest, crash)
    return spec


def _parity_corpus():
    corpus = []
    for size in (0, 1, 4096, 64 << 10, 1 << 20):
        req = api.scheduler.GetConfigRequest(token=f"sz{size}")
        corpus.append(("Echo", encode_frame(
            0, req.SerializeToString(), _make_blob(size))))
    meta = api.scheduler.GetConfigRequest(token="x").SerializeToString()
    corpus += [("FailApp", encode_frame(0, meta)),
               ("Crash", encode_frame(0, meta)),
               ("NoSuchMethod", encode_frame(0, meta)),
               # Malformed inner frame: claims more meta than it holds.
               ("Echo", b"\x00\x00\x00\x00\xff\xff\x00\x00abc")]
    return corpus


def test_threaded_and_aio_replies_are_byte_identical_to_jax():
    from yadcc_tpu.rpc import RpcError as JRpcError

    grpc_srv = GrpcServer("127.0.0.1:0")
    grpc_srv.add_service(_parity_spec(ServiceSpec, RpcError, api))
    grpc_srv.start()
    aio_srv = taio.AioRpcServer("127.0.0.1:0")
    aio_srv.add_service(_parity_spec(ServiceSpec, RpcError, api))
    jsrv = jaio.AioRpcServer("127.0.0.1:0")
    jsrv.add_service(_parity_spec(JSpec, JRpcError, japi))
    chans = [Channel(f"grpc://127.0.0.1:{grpc_srv.port}"),
             Channel(f"aio://127.0.0.1:{aio_srv.port}"),
             Channel(f"aio://127.0.0.1:{jsrv.port}")]
    try:
        assert isinstance(chans[1], taio.AioChannel)
        for i, (method, frame) in enumerate(_parity_corpus()):
            replies = [bytes(c.call_raw("ytpu.ParityProbe", method, frame,
                                        timeout=30)) for c in chans]
            assert replies[0] == replies[1] == replies[2], (i, method)
        assert aio_srv.inspect()["double_replies"] == 0
    finally:
        for c in chans:
            c.close()
        aio_srv.stop()
        jsrv.stop()
        grpc_srv.stop(grace=0)


def _echo_spec(spec_cls, api_mod):
    spec = spec_cls("t.Echo")

    def echo(req, att, ctx):
        ctx.response_attachment = bytes(att)[::-1]
        return api_mod.scheduler.GetConfigResponse(
            serving_daemon_token="e:" + req.token)

    spec.add("Do", api_mod.scheduler.GetConfigRequest, echo)
    return spec


@pytest.mark.parametrize("server_pkg", ["jax", "torch"])
def test_each_client_talks_to_the_other_packages_server(server_pkg):
    if server_pkg == "jax":
        srv = jaio.AioRpcServer("127.0.0.1:0")
        srv.add_service(_echo_spec(JSpec, japi))
        ch, a = Channel(f"aio://127.0.0.1:{srv.port}"), api
    else:
        srv = taio.AioRpcServer("127.0.0.1:0")
        srv.add_service(_echo_spec(ServiceSpec, api))
        ch, a = JChannel(f"aio://127.0.0.1:{srv.port}"), japi
    try:
        for i in range(6):
            resp, att = ch.call("t.Echo", "Do",
                                a.scheduler.GetConfigRequest(token=str(i)),
                                a.scheduler.GetConfigResponse,
                                attachment=b"abc" * i, timeout=10)
            assert resp.serving_daemon_token == f"e:{i}"
            assert bytes(att) == (b"abc" * i)[::-1]
        with pytest.raises(Exception) as ei:
            ch.call("no.Such", "Do", a.scheduler.GetConfigRequest(),
                    a.scheduler.GetConfigResponse, timeout=5)
        assert ei.value.status == 2
    finally:
        ch.close()
        srv.stop()


class TestAioRpcServer:
    @pytest.fixture
    def server(self):
        srv = taio.AioRpcServer("127.0.0.1:0")
        srv.add_service(_echo_spec(ServiceSpec, api))
        yield srv
        srv.stop()

    def test_one_connection_pipelines_concurrent_callers(self, server):
        before = taio.aio_connection_stats()
        ch = Channel(f"aio://127.0.0.1:{server.port}")
        errors = []

        def worker(i):
            try:
                for j in range(10):
                    resp, _ = ch.call(
                        "t.Echo", "Do",
                        api.scheduler.GetConfigRequest(token=f"{i}:{j}"),
                        api.scheduler.GetConfigResponse, timeout=15)
                    assert resp.serving_daemon_token == f"e:{i}:{j}"
            except Exception as e:  # reported below
                errors.append(e)

        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(6)]
        try:
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=30)
                assert not t.is_alive()
        finally:
            ch.close()
        assert not errors
        after = taio.aio_connection_stats()
        assert after["dials"] - before["dials"] == 1
        assert after["reuses"] - before["reuses"] == 59

    def test_async_channel_and_gather_written_payload(self, server):
        spec = ServiceSpec("t.Pay")

        def handler(req, att, ctx):
            ctx.response_attachment = Payload.of(b"seg1|", b"seg2|", b"s3")
            return api.scheduler.GetConfigResponse()

        spec.add("Do", api.scheduler.GetConfigRequest, handler)
        server.add_service(spec)
        results = []

        async def drive():
            chan = taio.AsyncAioChannel(f"127.0.0.1:{server.port}")

            async def one(i):
                resp, _ = await chan.call(
                    "t.Echo", "Do",
                    api.scheduler.GetConfigRequest(token=str(i)),
                    api.scheduler.GetConfigResponse, timeout=15)
                results.append(resp.serving_daemon_token)

            await asyncio.gather(*[one(i) for i in range(50)])
            _, att = await chan.call("t.Pay", "Do",
                                     api.scheduler.GetConfigRequest(),
                                     api.scheduler.GetConfigResponse,
                                     timeout=15)
            results.append(bytes(att))
            chan.close()

        asyncio.run_coroutine_threadsafe(
            drive(), server.loops.loop).result(timeout=30)
        assert sorted(results[:-1]) == sorted(f"e:{i}" for i in range(50))
        assert results[-1] == b"seg1|seg2|s3"

    def test_parked_double_fire_is_refused_and_counted(self, server):
        spec = ServiceSpec("t.Park")

        def handler(req, att, ctx, done):
            done(api.scheduler.GetConfigResponse(
                serving_daemon_token="first"))
            done(api.scheduler.GetConfigResponse(
                serving_daemon_token="second"))

        spec.add_parked("Do", api.scheduler.GetConfigRequest, handler)
        server.add_service(spec)
        ch = Channel(f"aio://127.0.0.1:{server.port}")
        try:
            resp, _ = ch.call("t.Park", "Do",
                              api.scheduler.GetConfigRequest(),
                              api.scheduler.GetConfigResponse, timeout=10)
        finally:
            ch.close()
        assert resp.serving_daemon_token == "first"
        ins = server.inspect()
        assert ins["double_replies"] == 1
        assert ins["loop_lag"]["count"] >= 0 and ins["loop_lag_s"] < 1.0
        assert ins["stages"]["parse"]["count"] >= 1


def test_server_group_of_two_loops_matches_one_loop():
    results = {}
    for loops in (1, 2):
        srv = make_rpc_server("aio", "127.0.0.1:0", accept_loops=loops)
        srv.add_service(_echo_spec(ServiceSpec, api))
        chans = [Channel(f"aio://127.0.0.1:{srv.port}") for _ in range(6)]
        try:
            out = []
            for i, ch in enumerate(chans):
                for j in range(4):
                    resp, att = ch.call(
                        "t.Echo", "Do",
                        api.scheduler.GetConfigRequest(token=f"{i}:{j}"),
                        api.scheduler.GetConfigResponse,
                        attachment=b"abc", timeout=15)
                    out.append((resp.serving_daemon_token, bytes(att)))
            ins = srv.inspect()
            assert ins["connections"] == 6 and ins["double_replies"] == 0
            if loops > 1:
                assert isinstance(srv, taio.AioServerGroup)
                assert ins["accept_loops"] == 2
                assert [p["loop"] for p in ins["per_loop"]] == \
                    ["aio-rpc-0", "aio-rpc-1"]
                assert ins["connections"] == sum(
                    p["connections"] for p in ins["per_loop"])
                assert all(p["port"] == srv.port for p in ins["per_loop"])
                fired = []
                timers = [srv.call_later(0.02, fired.append, k)
                          for k in range(4)]
                deadline = time.monotonic() + 5
                while len(fired) < 4 and time.monotonic() < deadline:
                    time.sleep(0.01)
                assert sorted(fired) == [0, 1, 2, 3]
                assert all(isinstance(t, taio.LoopTimer) for t in timers)
            results[loops] = sorted(out)
        finally:
            for ch in chans:
                ch.close()
            srv.stop()
    assert results[1] == results[2]
    with pytest.raises(ValueError):
        taio.AioServerGroup("127.0.0.1:0", accept_loops=0)
    with pytest.raises(ValueError):
        make_rpc_server("quic", "127.0.0.1:0")


class TestLoopTimer:
    @pytest.fixture
    def loops(self):
        lt = taio.EventLoopThread(name="looptimer-test")
        yield lt
        lt.stop()

    @staticmethod
    def _wait_for(pred, timeout_s=5.0):
        deadline = time.monotonic() + timeout_s
        while not pred() and time.monotonic() < deadline:
            time.sleep(0.01)
        return pred()

    def test_fires_and_cancels_before_and_after_arming(self, loops):
        fired = []
        timer = taio.LoopTimer(loops)
        loops.call_soon(timer._arm, 0.02, fired.append, (1,))
        assert self._wait_for(lambda: fired == [1])
        assert not timer.cancelled
        early = taio.LoopTimer(loops)
        early.cancel()  # wins the race against the call_soon hop
        loops.call_soon(early._arm, 0.01, fired.append, (2,))
        late = taio.LoopTimer(loops)
        loops.call_soon(late._arm, 0.3, fired.append, (3,))
        assert self._wait_for(lambda: late._handle is not None)
        late.cancel()
        time.sleep(0.45)
        assert fired == [1] and early.cancelled and late.cancelled

    def test_server_call_later_returns_a_cancellable_handle(self):
        srv = taio.AioRpcServer("127.0.0.1:0")
        try:
            fired = []
            t1 = srv.call_later(0.02, fired.append, 1)
            assert self._wait_for(lambda: fired == [1])
            t2 = srv.call_later(30.0, fired.append, 2)
            t2.cancel()
            assert isinstance(t1, taio.LoopTimer) and t2.cancelled
            assert fired == [1]
        finally:
            srv.stop()


def test_looplag_flags_a_stalled_loop_and_only_it():
    lt = taio.EventLoopThread(name="stall-test")
    try:
        with pytest.raises(RuntimeError):
            with looplag.installed():
                pass  # the autouse session is already active
        lt.call_soon(time.sleep, 0.4)  # blocks the loop on purpose
        time.sleep(0.7)
        stats = lt.lag_stats()
        assert stats["max_ms"] >= 300.0 and stats["count"] > 0
    finally:
        lt.stop()


@pytest.fixture(autouse=True)
def _expect_stall(request, _loop_lag_guard):
    """The stall test's one violation is the point of that test."""
    yield
    if request.node.name == "test_looplag_flags_a_stalled_loop_and_only_it":
        names = {v.loop_name for v in _loop_lag_guard.violations}
        assert names == {"stall-test"}
        _loop_lag_guard.violations.clear()


# ---------------------------------------------------------------------------
# The parked grant wait: manual cycles against the JAX dispatcher.
# ---------------------------------------------------------------------------

ENVS = [f"env-{i:02d}" for i in range(8)]


def _fleet(rng, n):
    out = []
    for i in range(n):
        envs = tuple(sorted(str(e) for e in rng.choice(
            ENVS, int(rng.integers(1, 5)), replace=False)))
        out.append(dict(
            location=f"10.0.0.{i + 1}:8335",
            version=int(rng.integers(1, 4)),
            num_processors=int(rng.integers(4, 17)),
            current_load=int(rng.integers(0, 3)),
            dedicated=bool(rng.random() < 0.3),
            capacity=int(rng.integers(0, 7)),
            total_memory=64 << 30,
            memory_available=(64 << 30) if rng.random() < 0.9 else 1 << 30,
            env_digests=envs))
    return out


def _requests(rng, n, n_servants):
    out = []
    for _ in range(n):
        requestor = ""
        if rng.random() < 0.4:   # a delegate that also serves
            requestor = f"10.0.0.{int(rng.integers(1, n_servants + 1))}:4000"
        out.append(dict(env_digest=str(rng.choice(ENVS)),
                        min_version=int(rng.integers(0, 3)),
                        requestor=requestor,
                        immediate=int(rng.integers(0, 12)),
                        prefetch=int(rng.integers(0, 3)),
                        lease_s=15.0, timeout_s=5.0))
    # Nothing asked: answered inside submit.
    out.append(dict(env_digest=ENVS[0], immediate=0, prefetch=0))
    # No servant has this env: the deadline answers it empty.
    out.append(dict(env_digest="env-none", immediate=2, timeout_s=5.0))
    return out


def _parked_run(pkg, policy, servants, requests):
    td, clock = (jtd, JClock(100.0)) if pkg == "jax" else (ttd, TClock(100.0))
    d = td.TaskDispatcher(policy, max_servants=64, clock=clock,
                          batch_window_s=0.0, start_dispatch_thread=False)
    fired = [[] for _ in requests]
    try:
        for info in servants:
            assert d.keep_servant_alive(td.ServantInfo(**info), 60.0)
        for i, r in enumerate(requests):
            d.submit_wait_for_starting_new_task(**r, on_done=fired[i].append)
        empty_at_once = [len(f) for f in fired]
        issued = d.run_dispatch_cycle_for_testing()
        after_cycle = [len(f) for f in fired]
        clock.advance(10.0)            # past every deadline
        d.run_dispatch_cycle_for_testing()
        return dict(issued=issued, empty_at_once=empty_at_once,
                    after_cycle=after_cycle, fired=fired,
                    running=d._arr_running.tolist(),
                    pending=len(d._pending),
                    granted=d.inspect()["stats"]["granted"])
    finally:
        d.stop()


@pytest.mark.parametrize("policy", ["greedy_cpu", "torch_grouped"])
def test_parked_wait_delivers_the_jax_grants_once(policy):
    rng = np.random.default_rng(21)
    servants = _fleet(rng, 40)
    requests = _requests(rng, 14, 40)
    if policy == "greedy_cpu":
        jp = jpol.make_policy("greedy_cpu", max_servants=64)
        tp = tpol.make_policy("greedy_cpu", device="cpu")
    else:
        jp, tp = jpol.JaxGroupedPolicy(), tpol.TorchGroupedPolicy("cpu")
    want = _parked_run("jax", jp, servants, requests)
    got = _parked_run("torch", tp, servants, requests)
    # The same grants, and the same answers at the deadline but one kind:
    # the port's scheduler returns a request that holds grants while
    # another waits for immediate grants (the unknown env's waits to the
    # end), so each request the cycle filled in part fires in the cycle,
    # where the JAX scheduler holds it to its deadline.
    partly = {i for i, r in enumerate(requests)
              if 0 < len(want["fired"][i][0]) < r.get("immediate", 1)}
    assert partly and all(want["after_cycle"][i] == 0 for i in partly)
    assert got["after_cycle"] == [1 if i in partly else n
                                  for i, n in enumerate(want["after_cycle"])]
    assert dict(got, after_cycle=None) == dict(want, after_cycle=None)
    # Every continuation fired exactly once; the empty-demand requests
    # answered inside submit, the satisfied ones in the cycle, the rest
    # (the unknown env among them) at the deadline.
    assert all(len(f) == 1 for f in got["fired"])
    assert got["issued"] > 0 and got["pending"] == 0
    assert got["fired"][-1] == [[]]
    zero = [i for i, r in enumerate(requests)
            if r.get("immediate", 1) + r.get("prefetch", 0) == 0]
    assert zero and all(got["empty_at_once"][i] == 1 for i in zero)
    assert got["granted"] == sum(len(f[0]) for f in got["fired"])


def test_stop_and_policy_failure_answer_parked_waits_once():
    d = ttd.TaskDispatcher(tpol.make_policy("greedy_cpu", device="cpu"),
                           max_servants=8, batch_window_s=0.0)
    d.keep_servant_alive(ttd.ServantInfo(
        location="10.0.0.9:1", version=1, num_processors=2, capacity=1,
        total_memory=1 << 36, memory_available=1 << 35,
        env_digests=("e" * 64,)), 60.0)
    fired = []
    try:
        first = d.wait_for_starting_new_task("e" * 64, timeout_s=2.0)
        assert len(first) == 1
        d.submit_wait_for_starting_new_task(
            "e" * 64, timeout_s=30.0, on_done=fired.append)
    finally:
        d.stop()
    assert fired == [[]]

    class Broken(tpol.TorchGroupedPolicy):
        def assign(self, snap, requests):
            raise RuntimeError("device lost")

    d = ttd.TaskDispatcher(Broken("cpu"), max_servants=8,
                           batch_window_s=0.0)
    fired = []
    try:
        d.keep_servant_alive(ttd.ServantInfo(
            location="10.0.0.9:1", version=1, num_processors=2,
            capacity=1, total_memory=1 << 36, memory_available=1 << 35,
            env_digests=("e" * 64,)), 60.0)
        d.submit_wait_for_starting_new_task(
            "e" * 64, timeout_s=30.0, on_done=fired.append)
        deadline = time.monotonic() + 5
        while not fired and time.monotonic() < deadline:
            time.sleep(0.01)  # the dispatch thread may fail it first
        assert fired == [[]] and isinstance(d.failure, RuntimeError)
        with pytest.raises(ttd.DispatcherFailed, match="device lost"):
            d.submit_wait_for_starting_new_task(
                "e" * 64, timeout_s=1.0, on_done=fired.append)
        assert fired == [[]]
    finally:
        d.stop()


# ---------------------------------------------------------------------------
# The parked service path over each package's aio server.
# ---------------------------------------------------------------------------


def _service_rig_run(pkg):
    """JAX tests/test_aio_frontend.py's parked-grant scenario on one
    package: grants flow, the deadline answers NO_QUOTA, freed capacity
    wakes a parked request; then a failing policy's answer."""
    if pkg == "jax":
        td, a, svc_mod, aio = jtd, japi, jsvc, jaio
        pol = jpol.make_policy("greedy_cpu", max_servants=16,
                               avoid_self=False)
    else:
        td, a, svc_mod, aio = ttd, api, tsvc, taio
        pol = tpol.make_policy("greedy_cpu", avoid_self=False, device="cpu")
    d = td.TaskDispatcher(pol, max_servants=16, batch_window_s=0.0)
    srv = aio.AioRpcServer("127.0.0.1:0")
    spec = svc_mod.SchedulerService(d).spec()
    assert "WaitForStartingTask" in spec.parked
    srv.add_service(spec)
    d.keep_servant_alive(td.ServantInfo(
        location="10.0.0.1:8335", version=1, num_processors=8, capacity=4,
        total_memory=1 << 36, memory_available=1 << 35,
        env_digests=("e" * 64,)), 60.0)
    # The port's client on both: it closes its socket at once (the JAX
    # client's close leaves the server's connection open until its
    # reader thread returns, which holds up the JAX server's stop).
    ch = Channel(f"aio://127.0.0.1:{srv.port}")
    out = []

    def ask(env, n, wait_ms):
        req = a.scheduler.WaitForStartingTaskRequest(
            token="", immediate_reqs=n, milliseconds_to_wait=wait_ms,
            next_keep_alive_in_ms=15000)
        req.env_desc.compiler_digest = env
        try:
            resp, _ = ch.call("ytpu.SchedulerService", "WaitForStartingTask",
                              req, a.scheduler.WaitForStartingTaskResponse,
                              timeout=15)
        except Exception as e:
            return ("error", e.status)
        return ("ok", [(g.task_grant_id, g.servant_location)
                       for g in resp.grants])

    try:
        two = ask("e" * 64, 2, 3000)
        out.append(two)
        d.free_task([gid for gid, _ in two[1]])
        t0 = time.monotonic()
        out.append(ask("f" * 64, 1, 200))
        out.append(time.monotonic() - t0 < 5.0)
        held = ask("e" * 64, 4, 3000)
        out.append(held)
        got = []
        waiter = threading.Thread(
            target=lambda: got.append(ask("e" * 64, 1, 8000)))
        waiter.start()
        time.sleep(0.3)
        out.append(list(got))           # parked, not failed
        d.free_task([gid for gid, _ in held[1]])
        waiter.join(timeout=10)
        assert not waiter.is_alive()
        out.append(got)
        out.append(srv.inspect()["double_replies"])
    finally:
        ch.close()
        srv.stop()
        d.stop()
    return out


def test_parked_service_path_answers_as_the_jax_one():
    want, got = _service_rig_run("jax"), _service_rig_run("torch")
    assert got == want
    no_quota = api.scheduler.SCHEDULER_STATUS_NO_QUOTA_AVAILABLE
    assert got[0] == ("ok", [(1, "10.0.0.1:8335"), (2, "10.0.0.1:8335")])
    assert got[1] == ("error", no_quota) and got[2] is True
    assert len(got[3][1]) == 4 and got[4] == []
    assert got[5] == [("ok", [(7, "10.0.0.1:8335")])]
    assert got[6] == 0


def test_parked_service_answers_a_policy_failure_as_the_blocking_one():
    class Broken(tpol.TorchGroupedPolicy):
        def assign(self, snap, requests):
            raise RuntimeError("device lost")

    d = ttd.TaskDispatcher(Broken("cpu"), max_servants=8,
                           batch_window_s=0.0)
    d.keep_servant_alive(ttd.ServantInfo(
        location="10.0.0.1:8335", version=1, num_processors=8, capacity=4,
        total_memory=1 << 36, memory_available=1 << 35,
        env_digests=("e" * 64,)), 60.0)
    srv = taio.AioRpcServer("127.0.0.1:0")
    srv.add_service(tsvc.SchedulerService(d).spec())
    ch = Channel(f"aio://127.0.0.1:{srv.port}")
    req = api.scheduler.WaitForStartingTaskRequest(
        token="", immediate_reqs=1, milliseconds_to_wait=2000)
    req.env_desc.compiler_digest = "e" * 64
    try:
        errors = []
        for _ in range(2):  # during the failing cycle, then after it
            with pytest.raises(RpcError) as ei:
                ch.call("ytpu.SchedulerService", "WaitForStartingTask", req,
                        api.scheduler.WaitForStartingTaskResponse,
                        timeout=10)
            errors.append((ei.value.status, ei.value.message))
    finally:
        ch.close()
        srv.stop()
        d.stop()
    for status, message in errors:
        assert status == 1 and "DispatcherFailed" in message
        assert "device lost" in message


# ---------------------------------------------------------------------------
# The entry: --rpc-frontend aio on the CPU, in a subprocess.
# ---------------------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("loops", [1, 2])
def test_entry_serves_a_heartbeat_and_a_grant_over_aio(loops):
    from yadcc_tpu_torch.scheduler.service import SERVICE_NAME

    port = _free_port()
    cmd = [sys.executable, "-m", "yadcc_tpu_torch.scheduler.entry",
           "--device", "cpu", "--port", str(port), "--inspect-port", "0",
           "--rpc-frontend", "aio", "--accept-loops", str(loops),
           "--max-servants", "64", "--dispatch-policy", "greedy_cpu",
           "--acceptable-user-tokens", "utok",
           "--acceptable-servant-tokens", "stok", "--allow-self-dispatch"]
    proc = subprocess.Popen(cmd, cwd=REPO, stdout=subprocess.DEVNULL,
                            stderr=subprocess.DEVNULL)
    sch = api.scheduler
    ch = Channel(f"aio://127.0.0.1:{port}")
    try:
        deadline = time.monotonic() + 60
        while True:
            assert proc.poll() is None, "the entry exited at boot"
            try:
                ch.call(SERVICE_NAME, "GetConfig",
                        sch.GetConfigRequest(token="utok"),
                        sch.GetConfigResponse, timeout=2.0)
                break
            except RpcError:
                assert time.monotonic() < deadline, "boot timed out"
                time.sleep(0.05)
        hb = sch.HeartbeatRequest(
            token="stok", next_heartbeat_in_ms=10_000,
            location="127.0.0.1:21000", version=1, num_processors=4,
            capacity=4, total_memory_in_bytes=64 << 30,
            memory_available_in_bytes=64 << 30)
        hb.env_descs.add(compiler_digest="gcc-12")
        resp, _ = ch.call(SERVICE_NAME, "Heartbeat", hb,
                          sch.HeartbeatResponse, timeout=5.0)
        assert len(resp.acceptable_tokens) == 3
        req = sch.WaitForStartingTaskRequest(
            token="utok", milliseconds_to_wait=2000, immediate_reqs=1,
            next_keep_alive_in_ms=10_000)
        req.env_desc.compiler_digest = "gcc-12"
        resp, _ = ch.call(SERVICE_NAME, "WaitForStartingTask", req,
                          sch.WaitForStartingTaskResponse, timeout=10.0)
        assert [(g.task_grant_id, g.servant_location)
                for g in resp.grants] == [(1, "127.0.0.1:21000")]
        ch.call(SERVICE_NAME, "FreeTask",
                sch.FreeTaskRequest(token="utok", task_grant_ids=[1]),
                sch.FreeTaskResponse, timeout=5.0)
    finally:
        ch.close()
        proc.terminate()
        try:
            rc = proc.wait(timeout=20)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=20)
            raise
    assert rc == 0
