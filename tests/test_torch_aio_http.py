"""The aio front end's HTTP half and the daemon's parked routes, held
against the JAX package's.

The port's ``rpc/aio_server.py`` HTTP half (HttpStreamParser,
AioHttpResponder, AioHttpServer) parses the same requests out of seeded
byte streams split at random points, refuses a second reply and counts
it, and answers a handler's raise with 500 only when nothing was sent,
as the JAX one does.  The daemon's parked routes (``acquire_quota`` and
``wait_for_cxx_task`` on an aio ``LocalHttpService``) give the same
answers in both packages for the same script: a quota waiter parked and
woken by a release, the quota deadline's 503 + Retry-After, wait 404, a
completion before the wait answered at once, a wait woken by the
completion, the wait deadline's 503.  ``LocalTaskMonitor.acquire_async``
and ``DistributedTaskDispatcher.wait_for_task_async`` are held alike
when called directly.  Then the entries: the scheduler's and the cache
server's inspect ports on ``--rpc-frontend aio`` answer /inspect/vars
with the threaded handler's Basic-auth challenge (the daemon's is held
in tests/test_torch_import.py).  Every server, loop and pool is stopped
at the end of its test."""

from __future__ import annotations

import asyncio
import base64
import http.client
import json
import random
import socket
import threading
import time
import urllib.error
import urllib.request

import pytest

import yadcc_tpu.rpc.aio_server as jaio
from yadcc_tpu.daemon.local.config_keeper import ConfigKeeper as JConfig
from yadcc_tpu.daemon.local.distributed_task_dispatcher import \
    DistributedTaskDispatcher as JDispatcher
from yadcc_tpu.daemon.local.file_digest_cache import \
    FileDigestCache as JDigests
from yadcc_tpu.daemon.local.http_service import LocalHttpService as JHttp
from yadcc_tpu.daemon.local.local_task_monitor import \
    LocalTaskMonitor as JMonitor
from yadcc_tpu.daemon.local.task_grant_keeper import \
    TaskGrantKeeper as JKeeper
import yadcc_tpu_torch.rpc.aio_server as taio
from yadcc_tpu_torch.common.multi_chunk import try_parse_multi_chunk
from yadcc_tpu_torch.daemon.local.config_keeper import \
    ConfigKeeper as TConfig
from yadcc_tpu_torch.daemon.local.distributed_task_dispatcher import \
    DistributedTaskDispatcher as TDispatcher
from yadcc_tpu_torch.daemon.local.file_digest_cache import \
    FileDigestCache as TDigests
from yadcc_tpu_torch.daemon.local.http_service import \
    LocalHttpService as THttp
from yadcc_tpu_torch.daemon.local.local_task_monitor import \
    LocalTaskMonitor as TMonitor
from yadcc_tpu_torch.daemon.local.task_grant_keeper import \
    TaskGrantKeeper as TKeeper

PKGS = {"jax": jaio, "port": taio}


def _until(cond, what: str, timeout_s: float = 10.0) -> None:
    deadline = time.monotonic() + timeout_s
    while not cond():
        assert time.monotonic() < deadline, what
        time.sleep(0.01)


# ---------------------------------------------------------------------------
# The parser.
# ---------------------------------------------------------------------------


def _stream(rng: random.Random) -> bytes:
    """Keep-alive requests back to back, as a client pipelines them."""
    out = b""
    for _ in range(rng.randrange(5, 30)):
        method = rng.choice(["GET", "POST"])
        path = "/" + "/".join(rng.choice(["local", "inspect", "vars", "x"])
                              for _ in range(rng.randrange(1, 4)))
        body = (bytes(rng.randrange(256) for _ in range(
            rng.choice([0, 1, 17, 300, 5000]))) if method == "POST" else b"")
        headers = [("Host", "l")] + [(f"X-H{k}", f"v{rng.randrange(1000)}")
                                     for k in range(rng.randrange(3))]
        if body or rng.random() < 0.5:
            headers.append(("Content-Length", str(len(body))))
        rng.shuffle(headers)
        head = f"{method} {path} HTTP/1.1\r\n" + "".join(
            f"{k}: {v}\r\n" for k, v in headers) + "\r\n"
        out += head.encode() + body
    return out


def _parse(mod, data: bytes, cuts) -> list:
    parser = mod.HttpStreamParser(1 << 20)
    got = []
    for a, b in zip([0] + cuts, cuts + [len(data)]):
        got.extend(parser.feed(data[a:b]))
    return [(r.method, r.path, r.version, r.headers, r.body) for r in got]


@pytest.mark.parametrize("seed", range(4))
def test_parsers_read_the_same_requests_from_a_split_stream(seed):
    rng = random.Random(seed)
    data = _stream(rng)
    for split in range(3):
        # A byte drip, a few random cuts, a single feed.
        cuts = (list(range(1, len(data))) if split == 0 else
                sorted(rng.sample(range(1, len(data)), 12)) if split == 1
                else [])
        got = {name: _parse(mod, data, cuts) for name, mod in PKGS.items()}
        assert got["port"] == got["jax"]
        assert len(got["jax"]) == data.count(b" HTTP/1.1\r\n")


@pytest.mark.parametrize("length", [str((1 << 20) + 1), "-1", "12x"])
def test_over_cap_or_unparseable_length(length):
    """Over the cap: both raise BodyOverCap (the server's 413).  A length
    that is not a number: the port's parser raises BodyOverCap too, as
    the threaded front end's checked_content_length answers 413; the JAX
    parser raises ProtocolError and its server closes without a reply."""
    req = (f"POST /x HTTP/1.1\r\nContent-Length: {length}\r\n\r\n").encode()
    with pytest.raises(taio.BodyOverCap):
        taio.HttpStreamParser(1 << 20).feed(req)
    want = jaio.ProtocolError if length == "12x" else jaio.BodyOverCap
    with pytest.raises(want):
        jaio.HttpStreamParser(1 << 20).feed(req)


@pytest.mark.parametrize("bad", [b"NONSENSE\r\n\r\n",
                                 b"POST /x HTTP/1.1\r\n"
                                 b"Transfer-Encoding: chunked\r\n\r\n",
                                 b"POST /x HTTP/1.1\r\n" + b"A: b\r\n" * 20000])
def test_protocol_errors_alike(bad):
    for mod in PKGS.values():
        with pytest.raises(mod.ProtocolError):
            mod.HttpStreamParser(1 << 20).feed(bad)


# ---------------------------------------------------------------------------
# The server.
# ---------------------------------------------------------------------------


def _server_script(mod) -> dict:
    """One handler, every reply path: inline, a second reply, a raise
    after and before the reply, a parked reply from a loop timer, a
    pooled one; over one keep-alive connection, then pipelined on a raw
    socket, then an oversized Content-Length."""
    box = {}

    def handler(r):
        if r.path == "/ok":
            r._reply(200, b"ok")
        elif r.path == "/double":
            box["first"] = r._reply(200, b"one")
            box["second"] = r._reply(200, b"two")
        elif r.path == "/after":
            r._reply(200, b"sent")
            raise RuntimeError("after the reply")
        elif r.path == "/before":
            raise RuntimeError("before the reply")
        elif r.path == "/park":
            r.release_request()
            server.call_later(0.05, r._reply, 200, b"late")
        elif r.path == "/pool":
            server.submit(r._reply, 200, b"pooled")
        else:
            r._reply(404)

    server = mod.AioHttpServer(handler, "127.0.0.1:0", max_body=1 << 16)
    out = {}
    try:
        conn = http.client.HTTPConnection("127.0.0.1", server.port,
                                          timeout=10)
        answers = []
        for path in ("/ok", "/double", "/after", "/before", "/park",
                     "/pool", "/nope", "/ok"):
            conn.request("POST", path, body=b"x" * 3)
            resp = conn.getresponse()
            answers.append((path, resp.status, resp.read()))
        conn.close()
        out["keepalive"] = answers
        with socket.create_connection(("127.0.0.1", server.port),
                                      timeout=10) as s:
            s.sendall(b"".join(f"GET {p} HTTP/1.1\r\nHost: l\r\n\r\n"
                               .encode() for p in ("/ok", "/park", "/ok")))
            data = b""
            while data.count(b"HTTP/1.1 ") < 3:
                chunk = s.recv(65536)
                assert chunk
                data += chunk
        # (status line, body) a reply; a parked reply is written when
        # it fires, after the replies behind it on the connection.
        out["pipelined"] = sorted(
            (part.split(b"\r\n")[0], part.split(b"\r\n\r\n", 1)[1])
            for part in data.split(b"HTTP/1.1 ")[1:])
        with socket.create_connection(("127.0.0.1", server.port),
                                      timeout=10) as s:
            s.sendall(b"POST /ok HTTP/1.1\r\nContent-Length: 99999999\r\n"
                      b"\r\n")
            data = b""
            while True:
                chunk = s.recv(65536)
                if not chunk:
                    break
                data += chunk
        out["over_cap"] = data.split(b"\r\n")[0]
        out["box"] = dict(box)
        _until(lambda: server.connection_count() == 0, "connections open")
        stats = server.inspect()
        out["double_replies"] = stats["double_replies"]
    finally:
        server.stop()
    return out


def test_servers_answer_alike():
    got = {name: _server_script(mod) for name, mod in PKGS.items()}
    assert got["port"] == got["jax"]
    ka = {p: (s, b) for p, s, b in got["jax"]["keepalive"]}
    assert ka["/double"] == (200, b"one")
    assert got["jax"]["box"] == {"first": True, "second": False}
    assert ka["/after"] == (200, b"sent")       # no 500 after the reply
    assert ka["/before"][0] == 500
    assert ka["/park"] == (200, b"late") and ka["/pool"] == (200, b"pooled")
    assert got["jax"]["pipelined"] == [(b"200 OK", b"late"),
                                       (b"200 OK", b"ok"),
                                       (b"200 OK", b"ok")]
    assert got["jax"]["over_cap"] == b"HTTP/1.1 413 Request Entity Too Large"
    # The second reply to /double, refused.
    assert got["jax"]["double_replies"] == 1


def test_stop_joins_the_loop_and_the_pool():
    before = {t.name for t in threading.enumerate()}
    server = taio.AioHttpServer(lambda r: r._reply(200), "127.0.0.1:0")
    server.submit(lambda: None)
    server.stop()
    left = {t.name for t in threading.enumerate()} - before
    assert not left, left
    # A late reply or pool hand-off after stop is dropped, not raised.
    server.submit(lambda: None)


def test_stop_leaves_a_lent_loop_running():
    # An entry lends its RPC server's loop: the HTTP server serves on it
    # and stops without stopping it.
    loops = taio.EventLoopThread(name="lent-loop")
    try:
        server = taio.AioHttpServer(lambda r: r._reply(200, b"ok"),
                                    "127.0.0.1:0", loops=loops)
        assert server.loops is loops
        with urllib.request.urlopen(
                f"http://127.0.0.1:{server.port}/x", timeout=10) as r:
            assert r.read() == b"ok"
        server.stop()
        assert loops.loop.is_running()
        assert loops.run_sync(asyncio.sleep(0, "alive")) == "alive"
    finally:
        loops.stop()


# ---------------------------------------------------------------------------
# The daemon's parked routes.
# ---------------------------------------------------------------------------


class GateTask:
    """A C++-kind task whose run waits for ``gate`` and then fails (exit
    code -1) before it asks for a grant; enough of the task SPI for both
    packages' dispatchers and the cxx row's wait response."""

    kind = "cxx"
    requestor_pid = 1
    is_fanout = False
    CACHE_ALLOW = 1
    fairness_weight = 1.0
    tenant_weight = 1.0

    def __init__(self, gate: threading.Event):
        self.gate = gate

    def get_cache_setting(self):
        return 0

    def get_digest(self):
        return "d" * 64

    def get_env_digest(self):
        self.gate.wait(30)
        raise RuntimeError("the gate task asks for no grant")

    def fairness_key(self):
        return ""

    def fairness_tenant(self):
        return ""


def _daemon(kind: str):
    Keeper, Config, Dispatcher, Http, Monitor, Digests = (
        (TKeeper, TConfig, TDispatcher, THttp, TMonitor, TDigests)
        if kind == "port" else
        (JKeeper, JConfig, JDispatcher, JHttp, JMonitor, JDigests))
    d = Dispatcher(grant_keeper=Keeper(f"mock://parked-{kind}", token=""),
                   config_keeper=Config(f"mock://parked-{kind}", token=""),
                   pid_prober=lambda p: True)
    svc = Http(monitor=Monitor(nprocs=4, pid_prober=lambda p: True),
               digest_cache=Digests(), dispatcher=d, port=0,
               frontend="aio")
    svc.start()
    return svc, d


def _post(port: int, path: str, body: bytes) -> tuple:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request("POST", path, body=body)
        resp = conn.getresponse()
        data = resp.read()
        if resp.getheader("Content-Type") == "application/octet-stream":
            # The wait answer: its JSON chunk's exit code.
            data = json.loads(try_parse_multi_chunk(data)[0])["exit_code"]
        return resp.status, resp.getheader("Retry-After"), data
    finally:
        conn.close()


def _quota(pid: int, ms: int, light: bool = False) -> bytes:
    return json.dumps({"requestor_pid": pid, "lightweight_task": light,
                       "milliseconds_to_wait": ms}).encode()


def _wait(task_id: int, ms: int) -> bytes:
    return json.dumps({"task_id": str(task_id),
                       "milliseconds_to_wait": ms}).encode()


def _in_thread(fn):
    box = {}
    t = threading.Thread(target=lambda: box.setdefault("r", fn()))
    t.start()
    return t, box


def _parked_script(kind: str) -> list:
    svc, d = _daemon(kind)
    port = svc.port
    out = []
    try:
        # nprocs 4: two heavy slots.
        out += [_post(port, "/local/acquire_quota", _quota(p, 300))
                for p in (1, 2)]
        t, box = _in_thread(lambda: _post(port, "/local/acquire_quota",
                                          _quota(3, 8000)))
        _until(lambda: svc.monitor.inspect()["parked_waiters"] == 1,
               "the quota wait never parked")
        assert "r" not in box
        out.append(_post(port, "/local/release_quota", _quota(1, 0)))
        t.join(10)
        out.append(box["r"])                       # woken: 200
        out.append(_post(port, "/local/acquire_quota", _quota(9, 300)))
        out.append(svc.monitor.inspect()["parked_waiters"])
        out += [_post(port, "/local/release_quota", _quota(p, 0))
                for p in (2, 3)]
        out.append(_post(port, "/local/wait_for_cxx_task",
                         _wait(424242, 100)))       # unknown: 404
        # A completion before the wait: answered at once, then freed.
        done = threading.Event()
        done.set()
        tid = d.queue_task(GateTask(done))
        assert d.wait_for_task(tid, 10) is not None
        out.append(_post(port, "/local/wait_for_cxx_task", _wait(tid, 300)))
        # The pool frees the task just after it queues the reply.
        _until(lambda: not d.is_known(tid), "the answered task stayed")
        out.append(_post(port, "/local/wait_for_cxx_task", _wait(tid, 100)))
        # A wait before the completion: parked, woken by it.
        gate = threading.Event()
        tid = d.queue_task(GateTask(gate))
        t, box = _in_thread(lambda: _post(port, "/local/wait_for_cxx_task",
                                          _wait(tid, 8000)))
        _until(lambda: len(d._tasks[tid].waiters) == 1,
               "the wait never parked")
        assert "r" not in box
        gate.set()
        t.join(10)
        out.append(box["r"])
        # The wait's deadline on a running task: 503, then the output.
        gate = threading.Event()
        tid = d.queue_task(GateTask(gate))
        out.append(_post(port, "/local/wait_for_cxx_task", _wait(tid, 200)))
        gate.set()
        out.append(_post(port, "/local/wait_for_cxx_task", _wait(tid, 8000)))
        out.append(svc.inspect()["double_replies"])
    finally:
        svc.stop()
        d.stop()
    return out


def test_parked_routes_answer_alike():
    got = {kind: _parked_script(kind) for kind in ("jax", "port")}
    assert got["port"] == got["jax"]
    assert [o if isinstance(o, int) else o[:2] for o in got["jax"]] == [
        (200, None), (200, None), (200, None), (200, None), (503, "0.5"), 0,
        (200, None), (200, None), (404, None), (200, None), (404, None),
        (200, None), (503, "0.5"), (200, None), 0]
    # Every answered wait carries the failed task's exit code.
    assert [o[2] for o in got["jax"] if isinstance(o, tuple)
            and isinstance(o[2], int)] == [-1, -1, -1]


def test_a_finished_wait_arms_no_deadline_unlike_the_reference():
    """A wait that finds its task finished is answered at once by both;
    the JAX route still arms its deadline, which then answers the
    settled reply again and counts a double reply; the port arms none."""
    doubles = {}
    for kind in ("jax", "port"):
        svc, d = _daemon(kind)
        try:
            done = threading.Event()
            done.set()
            tid = d.queue_task(GateTask(done))
            assert d.wait_for_task(tid, 10) is not None
            assert _post(svc.port, "/local/wait_for_cxx_task",
                         _wait(tid, 100))[0] == 200
            if kind == "jax":
                _until(lambda: svc.inspect()["double_replies"] == 1,
                       "the JAX deadline never fired")
            else:
                time.sleep(0.5)      # five times the wait's window
            doubles[kind] = svc.inspect()["double_replies"]
        finally:
            svc.stop()
            d.stop()
    assert doubles == {"jax": 1, "port": 0}


def test_client_keeps_one_connection_to_an_aio_daemon(monkeypatch):
    """Six quota laps from one client thread: one dial, eleven reuses of
    the kept-alive connection, with either package's client against its
    own package's aio daemon."""
    from yadcc_tpu.client import daemon_call as jcall
    from yadcc_tpu.client import task_quota as jquota
    from yadcc_tpu_torch.client import daemon_call as tcall
    from yadcc_tpu_torch.client import task_quota as tquota

    got = {}
    for kind, call, quota in (("jax", jcall, jquota),
                              ("port", tcall, tquota)):
        svc, d = _daemon(kind)
        try:
            monkeypatch.setenv("YTPU_DAEMON_PORT", str(svc.port))
            call._drop_conn()
            before = call.daemon_connection_stats()
            for _ in range(6):
                assert quota.acquire_task_quota(True, timeout_s=5.0)
                quota.release_task_quota()
            after = call.daemon_connection_stats()
            call._drop_conn()
            got[kind] = {k: after[k] - before[k] for k in after}
        finally:
            svc.stop()
            d.stop()
    assert got["port"] == got["jax"] == {"connects": 1, "reuses": 11,
                                         "retries": 0}


def test_acquire_async_alike():
    got = {}
    for kind, Monitor in (("jax", JMonitor), ("port", TMonitor)):
        mon = Monitor(nprocs=2, max_heavy_tasks=1, pid_prober=lambda p: True)
        calls = []
        mon.acquire_async(1, False, lambda ok: calls.append(("a", ok)))
        w2 = mon.acquire_async(2, False, lambda ok: calls.append(("b", ok)))
        # The light class is not blocked behind the parked heavy waiter.
        mon.acquire_async(3, True, lambda ok: calls.append(("c", ok)))
        parked = mon.inspect()["parked_waiters"]
        mon.drop_task_permission(1)      # wakes b
        w2.expire()                      # after the grant: no-op
        w4 = mon.acquire_async(4, False, lambda ok: calls.append(("d", ok)))
        w4.expire()                      # parked: answers False
        w4.expire()
        dead = mon.acquire_async(5, False, lambda ok: calls.append(("e", ok)))
        mon._pid_alive = lambda p: p != 2
        reclaimed = mon.on_reclaim_timer()   # pid 2 died: e woken
        dead.expire()
        got[kind] = (calls, parked, reclaimed, mon.inspect())
    assert got["port"] == got["jax"]
    assert got["jax"][0] == [("a", True), ("c", True), ("b", True),
                             ("d", False), ("e", True)]


def test_wait_for_task_async_alike():
    got = {}
    for kind in ("jax", "port"):
        svc, d = _daemon(kind)
        svc.stop()
        try:
            calls = []
            unknown = d.wait_for_task_async(424242, calls.append)
            gate = threading.Event()
            tid = d.queue_task(GateTask(gate))
            parked = d.wait_for_task_async(
                tid, lambda r: calls.append(("parked", r.exit_code)))
            assert not calls
            gate.set()
            _until(lambda: calls, "the parked wait never fired")
            again = d.wait_for_task_async(
                tid, lambda r: calls.append(("done", r.exit_code)))
            got[kind] = (unknown, parked, again, calls)
        finally:
            d.stop()
    assert got["port"] == got["jax"]
    assert got["jax"] == (False, True, True, [("parked", -1), ("done", -1)])


def test_dispatcher_stop_drops_parked_waits():
    svc, d = _daemon("port")
    svc.stop()
    gate = threading.Event()
    tid = d.queue_task(GateTask(gate))
    calls = []
    assert d.wait_for_task_async(tid, calls.append)
    d.stop(join_timeout_s=0.2)       # the task is still at its gate
    gate.set()
    _until(lambda: d._tasks[tid].done.is_set(), "the task never ended")
    assert calls == []


# ---------------------------------------------------------------------------
# The entries' inspect ports on aio.
# ---------------------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _get(port: int, auth: str = "") -> tuple:
    req = urllib.request.Request(f"http://127.0.0.1:{port}/inspect/vars")
    if auth:
        req.add_header("Authorization",
                       "Basic " + base64.b64encode(auth.encode()).decode())
    try:
        with urllib.request.urlopen(req, timeout=10) as resp:
            return resp.status, None, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("WWW-Authenticate"), None


@pytest.mark.parametrize("entry", ["scheduler", "cache"])
def test_entry_inspect_port_on_aio(entry, tmp_path):
    from yadcc_tpu_torch.cache import entry as centry
    from yadcc_tpu_torch.scheduler import entry as sentry

    iport = _free_port()
    common = ["--port", str(_free_port()), "--inspect-port", str(iport),
              "--inspect-credential", "u:pw", "--rpc-frontend", "aio"]
    stop = threading.Event()
    if entry == "scheduler":
        args = sentry.build_arg_parser().parse_args(
            common + ["--device", "cpu", "--dispatch-policy", "greedy_cpu"])
        target = lambda: sentry.scheduler_start(args, stop, gc_guard=False)
        key = "task_dispatcher"
    else:
        args = centry.build_arg_parser().parse_args(
            common + ["--cache-engine", "disk", "--cache-dirs",
                      str(tmp_path / "l2")])
        target = lambda: centry.cache_server_start(args, stop)
        key = "cache"
    before = {t.name for t in threading.enumerate()}
    server = threading.Thread(target=target, daemon=True)
    server.start()
    try:
        _until(lambda: _get_or_none(iport) is not None,
               "the inspect port never answered", timeout_s=30)
        status, challenge, _ = _get(iport)
        assert (status, challenge) == (401, 'Basic realm="inspect"')
        assert _get(iport, "u:wrong")[0] == 401
        status, _, body = _get(iport, "u:pw")
        assert status == 200 and key in body["yadcc"]
        # Served on the RPC server's loop: no loop thread of its own.
        assert not {t.name for t in threading.enumerate()
                    if t.name == "aio-http"} - before
    finally:
        stop.set()
        server.join(timeout=30)
    assert not server.is_alive()
    left = {t.name for t in threading.enumerate()} - before
    assert not {n for n in left if n.startswith("aio-http")}, left


def _get_or_none(port: int):
    try:
        return _get(port)
    except OSError:
        return None
