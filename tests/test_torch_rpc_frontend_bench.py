"""The port's front-end bench (yadcc_tpu_torch/tools/rpc_frontend_bench.py)
against the JAX package's yadcc_tpu/tools/rpc_frontend_bench.py: the
parity gate passes, the same request frames through each package's grpc
and aio servers give byte-equal reply frames, the local HTTP corpus gives
equal (status, body) pairs in both packages' LocalHttpService on both
front ends, and the pump rig keeps to its call rate (pod_sim's
``call_rate`` / ``--rig-rate``)."""

from __future__ import annotations

import pytest

from yadcc_tpu.tools import rpc_frontend_bench as jb
from yadcc_tpu_torch.tools import rpc_frontend_bench as tb


def test_parity_smoke_passes():
    assert tb.run_parity_smoke() == 0


def _servers(pkg_rpc, aio_mod, spec):
    g = pkg_rpc.GrpcServer("127.0.0.1:0")
    g.add_service(spec)
    g.start()
    a = aio_mod.AioRpcServer("127.0.0.1:0")
    a.add_service(spec)
    return g, a


def test_reply_frames_equal_across_packages():
    import yadcc_tpu.rpc as jrpc
    import yadcc_tpu.rpc.aio_server as jaio
    import yadcc_tpu_torch.rpc as trpc
    import yadcc_tpu_torch.rpc.aio_server as taio

    corpus = tb.frame_corpus()
    assert len(corpus) == 9
    replies = {}
    for name, rpc, aio, bench in (("jax", jrpc, jaio, jb),
                                  ("port", trpc, taio, tb)):
        g, a = _servers(rpc, aio, bench._parity_service())
        try:
            # The port's client dials both packages' servers: the JAX
            # aio client does not shut its socket down on close.
            replies[name] = (
                tb.frame_replies(f"grpc://127.0.0.1:{g.port}", corpus),
                tb.frame_replies(f"aio://127.0.0.1:{a.port}", corpus))
        finally:
            a.stop()
            g.stop(grace=0)
    for k in range(2):   # grpc, aio
        assert replies["port"][k] == replies["jax"][k]
    assert replies["port"][0] == replies["port"][1]
    # Each shape answered: the echoes carry their attachment back.
    assert len(replies["port"][0][4]) > (1 << 20)


def _http_service(pkg, frontend):
    d = pkg.DistributedTaskDispatcher(
        grant_keeper=pkg.TaskGrantKeeper("mock://parity-sched", token=""),
        config_keeper=pkg.ConfigKeeper("mock://parity-sched", token=""),
        pid_prober=lambda p: True)
    svc = pkg.LocalHttpService(
        monitor=pkg.LocalTaskMonitor(nprocs=4, pid_prober=lambda p: True),
        digest_cache=pkg.FileDigestCache(), dispatcher=d, port=0,
        frontend=frontend)
    svc.start()
    return svc, d


class _Pkg:
    def __init__(self, root):
        import importlib

        local = root + ".daemon.local."
        self.ConfigKeeper = importlib.import_module(
            local + "config_keeper").ConfigKeeper
        self.DistributedTaskDispatcher = importlib.import_module(
            local + "distributed_task_dispatcher").DistributedTaskDispatcher
        self.FileDigestCache = importlib.import_module(
            local + "file_digest_cache").FileDigestCache
        self.LocalHttpService = importlib.import_module(
            local + "http_service").LocalHttpService
        self.LocalTaskMonitor = importlib.import_module(
            local + "local_task_monitor").LocalTaskMonitor
        self.TaskGrantKeeper = importlib.import_module(
            local + "task_grant_keeper").TaskGrantKeeper


@pytest.mark.parametrize("frontend", ["threaded", "aio"])
def test_http_pairs_equal_across_packages(frontend):
    got = {}
    for name in ("yadcc_tpu", "yadcc_tpu_torch"):
        svc, d = _http_service(_Pkg(name), frontend)
        try:
            got[name] = tb.http_pairs(svc.port)
        finally:
            svc.stop()
            d.stop()
    assert got["yadcc_tpu_torch"] == got["yadcc_tpu"]
    assert len(got["yadcc_tpu"]) == len(tb.HTTP_CORPUS) == 7
    assert tb._http_parity() == [] and jb._http_parity() == []


def test_pump_rig_keeps_to_its_call_rate():
    from yadcc_tpu_torch.tools.pod_sim import PodSim

    rate = 200.0
    sim = PodSim(32, 8, "greedy_cpu", 0.0, 2, pumps=4, hb_interval=2.0,
                 mesh_loads="off", pump_batch=16, frontend="mock",
                 device="cpu")
    out = sim.run_pump_rig(300, 64, call_rate=rate, warmup_s=0.2,
                           time_limit_s=30.0)
    assert out["call_rate"] == rate
    assert out["grant_calls"] >= 300
    assert out["grant_calls_per_sec"] < 1.1 * rate, out


def test_pod_sim_parses_rig_rate():
    from yadcc_tpu_torch.tools.pod_sim import build_arg_parser

    args = build_arg_parser().parse_args(["--pump-rig", "--rig-rate", "400"])
    assert args.rig_rate == 400.0
    assert build_arg_parser().parse_args([]).rig_rate == 0.0
