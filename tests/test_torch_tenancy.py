"""The port's tenancy against the JAX package's, on the CPU.

Credentials minted by either package verify in the other; the tier x
rung shedding matrix and the ledger-before-ladder admission order run on
both packages' dispatchers with the same inputs and must rule alike; the
port's SchedulerService resolves the verified tenant before admission on
the grant path, as the JAX service does, on the direct handler and on
each package's aio front end (the parked wait).  Every quantity compared is an
integer, a string or a verdict: the tolerance is 0 (exact equality)."""

from __future__ import annotations

import numpy as np
import pytest

from yadcc_tpu import api as japi
from yadcc_tpu import tenancy as jten
from yadcc_tpu.rpc import RpcContext as JContext
from yadcc_tpu.rpc import RpcError as JRpcError
from yadcc_tpu.scheduler import admission as jadm
from yadcc_tpu.scheduler import policy as jpol
from yadcc_tpu.scheduler import service as jsvc
from yadcc_tpu.scheduler import task_dispatcher as jtd
from yadcc_tpu.utils.clock import VirtualClock as JClock
from yadcc_tpu_torch import api as tapi
from yadcc_tpu_torch import tenancy as tten
from yadcc_tpu_torch.rpc import RpcContext as TContext
from yadcc_tpu_torch.rpc import RpcError as TRpcError
from yadcc_tpu_torch.scheduler import admission as tadm
from yadcc_tpu_torch.scheduler import policy as tpol
from yadcc_tpu_torch.scheduler import service as tsvc
from yadcc_tpu_torch.scheduler import task_dispatcher as ttd
from yadcc_tpu_torch.utils.clock import VirtualClock as TClock

ENV = "e" * 64
TIERS = ("interactive", "batch", "best_effort", "", "platinum")


class Pkg:
    """One package's scheduler pieces behind the same names."""

    def __init__(self, name):
        self.name = name
        jax = name == "jax"
        self.ten = jten if jax else tten
        self.adm = jadm if jax else tadm
        self.td = jtd if jax else ttd
        self.svc = jsvc if jax else tsvc
        self.api = japi if jax else tapi
        self.Clock = JClock if jax else TClock
        self.Context = JContext if jax else TContext
        self.RpcError = JRpcError if jax else TRpcError
        self._jax = jax

    def policy(self):
        if self._jax:
            return jpol.make_policy("greedy_cpu", max_servants=8,
                                    avoid_self=False)
        return tpol.make_policy("greedy_cpu", avoid_self=False,
                                device="cpu")

    def dispatcher(self, specs, **kw):
        return self.td.TaskDispatcher(
            self.policy(), max_servants=8, batch_window_s=0.0,
            tenant_directory=self.ten.TenantDirectory(
                [self.ten.TenantSpec(**s) for s in specs]), **kw)

    def servant(self, d, capacity=8):
        d.keep_servant_alive(self.td.ServantInfo(
            location="10.0.0.1:8335", version=1, num_processors=8,
            capacity=capacity, total_memory=1 << 36,
            memory_available=1 << 35, env_digests=(ENV,)), 60.0)


PKGS = (Pkg("jax"), Pkg("torch"))


def verdict(d):
    return (d.rung, d.flow, d.retry_after_ms, d.prefetch_allowed,
            round(d.signal, 9))


# ---------------------------------------------------------------------------
# Credentials.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("minter,verifier", [(0, 1), (1, 0)])
def test_credentials_cross_verify(minter, verifier):
    mint, check = PKGS[minter].ten, PKGS[verifier].ten
    window = ["tok-new", "tok-mid", "tok-old"]
    for tenant in ("acme", "ci-fleet", "a" * 40):
        for token in window:
            cred = mint.derive_tenant_credential(token, tenant)
            assert cred == check.derive_tenant_credential(token, tenant)
            assert check.verify_tenant_credential(cred, window) == tenant
            assert check.verify_tenant_credential(cred, []) is None
            assert check.verify_tenant_credential(cred, ["other"]) is None
            tampered = cred[:-1] + ("0" if cred[-1] != "0" else "1")
            assert check.verify_tenant_credential(tampered, window) is None
        assert mint.tenant_key_secret("root", tenant) == \
            check.tenant_key_secret("root", tenant)
    for bad in ("", "ytpu-tn1.x", "nope.acme.ff", "ytpu-tn1..ff"):
        assert check.verify_tenant_credential(bad, window) is None
    with pytest.raises(ValueError):
        check.derive_tenant_credential("tok", "dotted.id")

    # TenancyControl: the full binding from the other package's credential.
    directory = check.TenantDirectory([check.TenantSpec(
        "acme", tier="interactive", weight=2.0, max_outstanding=3)])
    control = check.TenancyControl(directory, "root", lambda: window)
    binding = control.authenticate(
        mint.derive_tenant_credential(window[1], "acme"))
    assert (binding.tenant_id, binding.tier, binding.weight,
            binding.key_secret) == (
        "acme", "interactive", 2.0, mint.tenant_key_secret("root", "acme"))
    assert control.authenticate(
        mint.derive_tenant_credential(window[0], "ghost")) is None
    assert control.inspect()["stats"] == {"authenticated": 1, "rejected": 1}


def test_tier_tables_and_apply_tier_match():
    j, t = PKGS[0], PKGS[1]
    for tier in TIERS:
        assert j.ten.tier_shed_rung(tier) == t.ten.tier_shed_rung(tier)
        assert j.ten.tier_fanout_cap(tier) == t.ten.tier_fanout_cap(tier)
        for rung in range(5):
            for flow, retry in ((0, 0), (0, 1234), (1, 0), (2, 900)):
                got = [verdict(p.ten.apply_tier(p.adm.AdmissionDecision(
                    rung=rung, flow=flow, retry_after_ms=retry), tier))
                    for p in (j, t)]
                assert got[0] == got[1], (tier, rung, flow, retry)


def test_ledger_matches():
    logs = []
    for p in PKGS:
        ledger = p.ten.TenantLedger(p.ten.TenantDirectory([
            p.ten.TenantSpec("ci", max_outstanding=3, max_queued=2)]))
        log = []
        for op, tenant, n in (("charge", "ci", 2), ("charge", "", 5),
                              ("charge_queued", "ci", 2),
                              ("release", "ci", 1), ("charge", "dev", 4),
                              ("release_queued", "ci", 1),
                              ("release", "ci", 5)):
            getattr(ledger, op)(tenant, n)
            log.append((ledger.outstanding("ci"), ledger.queued("ci"),
                        ledger.over_budget("ci", 1),
                        ledger.over_budget("ci", 3),
                        ledger.over_budget("dev", 100), ledger.inspect()))
        logs.append(log)
    assert logs[0] == logs[1]


# ---------------------------------------------------------------------------
# The dispatcher: tier x rung matrix, ledger before ladder.
# ---------------------------------------------------------------------------

SPECS = [dict(tenant_id="ia", tier="interactive"),
         dict(tenant_id="ba", tier="batch", max_outstanding=2),
         dict(tenant_id="be", tier="best_effort")]


def _matrix(p):
    """Walk one package's ladder rung by rung on a virtual clock and rule
    on every (tenant, tier) at each rung."""
    clock = p.Clock()
    d = p.dispatcher(SPECS, clock=clock, start_dispatch_thread=False,
                     admission_config=p.adm.AdmissionConfig(
                         up_thresholds=(0.0, 0.0, 0.0, 0.0),
                         up_dwell_s=1.0, down_dwell_s=1e9))
    p.servant(d)
    out = []
    try:
        for rung in range(5):
            if rung:
                clock.advance(1.0)
                out.append(("step", verdict(d.admission_check(immediate=1))))
            for tenant in ("", "ia", "ba", "be", "zz"):
                for tier in TIERS:
                    out.append((rung, tenant, tier, verdict(
                        d.admission_check(immediate=1, prefetch=2,
                                          tenant=tenant, tier=tier))))
        ins = d.inspect()
        out.append((ins["stats_by_tenant"], ins["admission"]["stats"],
                    ins["admission"]["rung"]))
    finally:
        d.stop()
    return out


def test_tier_by_rung_matrix_matches_on_both_dispatchers():
    jax_out, torch_out = _matrix(PKGS[0]), _matrix(PKGS[1])
    assert jax_out == torch_out
    # The ladder really walked NORMAL -> REJECT, and the tiers shed in
    # order: best_effort at SHED_OPTIONAL, batch at SPILLOVER,
    # interactive only with the ladder itself.
    flows = {(r, t): v[1] for r, tenant, t, v in
             (x for x in torch_out[:-1] if x[0] != "step")
             if tenant == "ia"}
    assert flows[(1, "best_effort")] == tadm.FLOW_REJECT
    assert flows[(1, "batch")] == tadm.FLOW_NONE
    assert flows[(2, "batch")] == tadm.FLOW_REJECT
    assert flows[(2, "interactive")] == tadm.FLOW_NONE
    assert flows[(3, "interactive")] == tadm.FLOW_COMPILE_LOCALLY
    assert flows[(4, "interactive")] == tadm.FLOW_REJECT
    assert torch_out[-1][2] == tadm.RUNG_REJECT


def _budget_order(p):
    """The ledger rules before the ladder: an over-budget tenant is
    refused at NORMAL without the ladder counting it; freeing restores
    admission.  Returns what each step saw."""
    d = p.dispatcher(SPECS + [dict(tenant_id="q", max_queued=1)])
    p.servant(d)
    out = []
    try:
        out.append(verdict(d.admission_check(immediate=1, tenant="ba",
                                             tier="batch")))
        held = [g for g, _ in d.wait_for_starting_new_task(
            ENV, immediate=2, timeout_s=5.0, tenant="ba")]
        out.append(len(held))
        ladder_before = d.admission.inspect()["stats"]
        over = d.admission_check(immediate=1, tenant="ba", tier="batch")
        out.append(verdict(over))
        out.append(d.admission.inspect()["stats"] == ladder_before)
        out.append(verdict(d.admission_check(immediate=1)))
        out.append(verdict(d.admission_check(immediate=1, tenant="ia",
                                             tier="interactive")))
        out.append(d.tenant_ledger.outstanding("ba"))
        d.free_task(held)
        out.append(d.tenant_ledger.outstanding("ba"))
        out.append(verdict(d.admission_check(immediate=1, tenant="ba",
                                             tier="batch")))
        ins = d.inspect()
        out.append((ins["stats_by_tenant"], ins["tenant_budgets"],
                    ins["grants_outstanding"]))
    finally:
        d.stop()
    return out


def test_ledger_before_ladder_matches_on_both_dispatchers():
    jax_out, torch_out = _budget_order(PKGS[0]), _budget_order(PKGS[1])
    assert jax_out == torch_out
    assert torch_out[1] == 2
    assert torch_out[2][:2] == (tadm.RUNG_NORMAL, tadm.FLOW_REJECT)
    assert torch_out[2][2] > 0
    assert torch_out[3] is True                # the ladder never ruled
    assert torch_out[4][1] == torch_out[5][1] == tadm.FLOW_NONE
    assert (torch_out[6], torch_out[7]) == (2, 0)
    assert torch_out[8][1] == tadm.FLOW_NONE
    assert torch_out[9][0]["ba"] == {"granted": 2,
                                     "rejected_over_budget": 1,
                                     "shed_by_tier": 0}


def test_every_exit_path_releases_the_ledger():
    """Free, servant drop and zombie kill each credit the tenant."""
    d = PKGS[1].dispatcher([dict(tenant_id="ci")], clock=TClock())
    try:
        PKGS[1].servant(d)
        gids = [g for g, _ in d.wait_for_starting_new_task(
            ENV, immediate=5, timeout_s=5.0, tenant="ci")]
        assert d.tenant_ledger.outstanding("ci") == 5
        d.free_task(gids[:1])
        assert d.tenant_ledger.outstanding("ci") == 4
        # Zombie kill: an expired grant the servant stops reporting.
        d._clock.advance(20.0)
        PKGS[1].servant(d)
        d.on_expiration_timer()
        d.notify_servant_running_tasks("10.0.0.1:8335", gids[1:3])
        assert d.tenant_ledger.outstanding("ci") == 2
        # Servant drop: a graceful leave orphans the rest.
        d.keep_servant_alive(ttd.ServantInfo(location="10.0.0.1:8335"), 0)
        assert d.tenant_ledger.outstanding("ci") == 0
        assert d.inspect()["grants_outstanding"] == 0
    finally:
        d.stop()


# ---------------------------------------------------------------------------
# The service: the verified tenant rides admission and the grant path.
# ---------------------------------------------------------------------------


def _service_drive(p, frontend="direct"):
    """The tenancy sequence through one package's service: called
    directly, or over that package's aio server (the parked handler)."""
    d = p.dispatcher([dict(tenant_id="acme", tier="batch",
                           max_outstanding=3)])
    p.servant(d)
    window = ["w0", "w1", "w2"]
    control = p.ten.TenancyControl(d._tenant_directory, "root",
                                   lambda: window)
    svc = p.svc.SchedulerService(d, tenancy=control)
    sch = p.api.scheduler
    ctx = p.Context(peer="10.9.9.9:4242")
    out = []
    srv = chan = None
    if frontend == "aio":
        from yadcc_tpu.rpc import aio_server as jaio
        from yadcc_tpu_torch.rpc import Channel
        from yadcc_tpu_torch.rpc import aio_server as taio

        srv = (jaio if p.name == "jax" else taio).AioRpcServer("127.0.0.1:0")
        spec = svc.spec()
        assert "WaitForStartingTask" in spec.parked
        srv.add_service(spec)
        chan = Channel(f"aio://127.0.0.1:{srv.port}")

    def ask(cred, n):
        req = sch.WaitForStartingTaskRequest(
            token="", milliseconds_to_wait=2000, immediate_reqs=n,
            tenant_credential=cred)
        req.env_desc.compiler_digest = ENV
        try:
            if chan is None:
                resp = svc.WaitForStartingTask(req, b"", ctx)
            else:
                resp, _ = chan.call("ytpu.SchedulerService",
                                    "WaitForStartingTask", req,
                                    sch.WaitForStartingTaskResponse,
                                    timeout=10)
        except (p.RpcError, TRpcError) as e:
            return ("error", e.status)
        return ("ok", resp.flow_control, resp.retry_after_ms,
                [(g.task_grant_id, g.servant_location)
                 for g in resp.grants])

    try:
        out.append(ask("", 1))
        out.append(ask("ytpu-tn1.acme.00", 1))
        good = p.ten.derive_tenant_credential("w1", "acme")
        out.append(ask(good, 2))
        out.append(ask(good, 2))           # 2 held + 2 > 3: refused
        out.append(ask(good, 1))
        out.append(ask(p.ten.derive_tenant_credential("w0", "ghost"), 1))
        ins = d.inspect()
        out.append((ins["stats_by_tenant"], ins["tenant_budgets"],
                    control.inspect()))
        if srv is not None:
            out.append(srv.inspect()["double_replies"])
    finally:
        if chan is not None:
            chan.close()
            srv.stop()
        d.stop()
    return out


def test_service_resolves_the_tenant_before_admission():
    jax_out, torch_out = _service_drive(PKGS[0]), _service_drive(PKGS[1])
    assert jax_out == torch_out
    denied = tapi.scheduler.SCHEDULER_STATUS_ACCESS_DENIED
    assert torch_out[0] == torch_out[1] == ("error", denied)
    assert torch_out[2][0] == "ok" and len(torch_out[2][3]) == 2
    assert torch_out[3][1] == tadm.FLOW_REJECT and not torch_out[3][3]
    assert len(torch_out[4][3]) == 1
    assert torch_out[5] == ("error", denied)
    assert torch_out[6][0]["acme"]["granted"] == 3
    assert np.sum(list(torch_out[6][1]["outstanding"].values())) == 3


def test_service_resolves_the_tenant_before_admission_on_aio():
    """The aio half: the parked WaitForStartingTask over each package's
    event-loop server rules as the direct handler does."""
    want = _service_drive(PKGS[1])
    jax_aio = _service_drive(PKGS[0], "aio")
    torch_aio = _service_drive(PKGS[1], "aio")
    assert torch_aio == jax_aio == want + [0]
