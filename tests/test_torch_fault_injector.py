"""The RPC fault injector on every channel of the port, against the JAX
package's.

The port counterpart of tests/test_federation.py::TestFaultInjectorParity:
one injector installed in each package records the same
``(target, service, method)`` triple for the same call on the mock
transport, on gRPC and on the aio transport (the synchronous channel's
``call`` and ``call_raw``, and the loop-native ``AsyncAioChannel``), and
an injected failure raises the same ``RpcError`` status on each, before
the request leaves.
"""

from __future__ import annotations

import asyncio

import pytest

import yadcc_tpu.api as japi
import yadcc_tpu.rpc as jrpc
import yadcc_tpu_torch.api as tapi
import yadcc_tpu_torch.rpc as trpc
from yadcc_tpu.rpc import aio_server as jaio
from yadcc_tpu.rpc import transport as jtransport
from yadcc_tpu_torch.rpc import aio_server as taio
from yadcc_tpu_torch.rpc import transport as ttransport

PACKAGES = {
    "jax": (japi, jrpc, jaio, jtransport),
    "port": (tapi, trpc, taio, ttransport),
}


class _Recorder:
    def __init__(self, transport, fail_method=None):
        self.calls = []
        self.fail_method = fail_method
        self.transport = transport

    def __call__(self, target, service, method_name):
        self.calls.append((target, service, method_name))
        if method_name == self.fail_method:
            raise self.transport.RpcError(7, "injected")


def _echo_spec(api, rpc, served):
    spec = rpc.ServiceSpec("t.Echo")

    def echo(req, attachment, ctx):
        served.append(req.token)
        return api.scheduler.GetConfigResponse(
            serving_daemon_token="e:" + req.token)

    spec.add("Do", api.scheduler.GetConfigRequest, echo)
    return spec


def _drive(pkg: str, fail: bool):
    """Every channel kind of one package, each call through one
    installed injector: (recorded triples, outcomes, requests served)."""
    api, rpc, aio, transport = PACKAGES[pkg]
    served: list = []
    mock_name = f"inject-{pkg}-{int(fail)}"
    rpc.register_mock_server(mock_name, _echo_spec(api, rpc, served))
    grpc_srv = rpc.make_rpc_server("threaded", "127.0.0.1:0")
    grpc_srv.add_service(_echo_spec(api, rpc, served))
    grpc_srv.start()
    aio_srv = aio.AioRpcServer("127.0.0.1:0")
    aio_srv.add_service(_echo_spec(api, rpc, served))
    rec = _Recorder(transport, fail_method="Do" if fail else None)
    req = api.scheduler.GetConfigRequest(token="x")
    frame = transport.encode_frame(0, req.SerializeToString(), b"")
    outcomes = []

    def outcome(fn):
        try:
            got = fn()
        except transport.RpcError as e:
            outcomes.append(("RpcError", e.status))
            return
        if isinstance(got, (bytes, bytearray, memoryview)):
            status, meta, _ = transport.decode_frame_views(got)
            got = (api.scheduler.GetConfigResponse.FromString(meta),)
            assert status == 0
        outcomes.append(("ok", got[0].serving_daemon_token))

    transport.install_fault_injector(rec)
    try:
        for uri in (f"mock://{mock_name}",
                    f"grpc://127.0.0.1:{grpc_srv.port}"):
            ch = rpc.Channel(uri)
            outcome(lambda: ch.call(
                "t.Echo", "Do", req, api.scheduler.GetConfigResponse,
                timeout=5.0))
        ch = rpc.Channel(f"aio://127.0.0.1:{aio_srv.port}")
        assert isinstance(ch, aio.AioChannel)
        try:
            outcome(lambda: ch.call(
                "t.Echo", "Do", req, api.scheduler.GetConfigResponse,
                timeout=5.0))
            outcome(lambda: ch.call_raw("t.Echo", "Do", frame, timeout=5.0))
        finally:
            ch.close()

        async def loop_native():
            ach = aio.AsyncAioChannel(f"aio://127.0.0.1:{aio_srv.port}")
            try:
                return await ach.call("t.Echo", "Do", req,
                                      api.scheduler.GetConfigResponse,
                                      timeout=5.0)
            finally:
                ach.close()

        outcome(lambda: asyncio.run(loop_native()))
    finally:
        transport.install_fault_injector(None)
        rpc.unregister_mock_server(mock_name)
        grpc_srv.stop(grace=0)
        aio_srv.stop()
    return rec.calls, outcomes, served, (grpc_srv.port, aio_srv.port)


def _normalized(calls, ports):
    """Targets with each package's own ports and mock name replaced, so
    the two packages' records compare."""
    grpc_port, aio_port = ports
    out = []
    for target, service, method in calls:
        target = (target.replace(f":{grpc_port}", ":GRPC")
                  .replace(f":{aio_port}", ":AIO"))
        if not target.startswith(("127.", "grpc", "aio")):
            target = "MOCK"
        out.append((target, service, method))
    return out


@pytest.mark.parametrize("fail", [False, True], ids=["pass", "fail"])
def test_injector_fires_identically_on_every_channel(fail):
    jcalls, jout, jserved, jports = _drive("jax", fail)
    tcalls, tout, tserved, tports = _drive("port", fail)
    # Mock, grpc, aio call, aio call_raw, AsyncAioChannel: five calls,
    # each seen once by the injector, in order.
    assert len(tcalls) == 5
    assert all(c[1:] == ("t.Echo", "Do") for c in tcalls)
    assert _normalized(tcalls, tports) == _normalized(jcalls, jports)
    assert tout == jout
    if fail:
        # The injector raises before the request leaves: no server saw
        # any of the five.
        assert tout == [("RpcError", 7)] * 5
        assert tserved == jserved == []
    else:
        assert tout == [("ok", "e:x")] * 5
        assert len(tserved) == len(jserved) == 5
