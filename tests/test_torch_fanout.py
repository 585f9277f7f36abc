"""The port's AOT and autotune fan-out held against the JAX package's.

The fan-out machinery alone (width bound, TopologySpec digests and tags,
config slices and digests, the fairness split, SearchSpace expansion)
and ``run_fanout`` against the same scripted fakes in both packages
(retries, deterministic failure, stragglers, abort, the cached and
joined statuses): equal verdicts.  The delegate's factories refuse the
same submissions.  Then both packages' rigs with equal environment
strings and the fake worker: an AOT submission with one topology
pre-cached builds only the misses, with verdicts, artifacts and cache
entries equal to the JAX rig's; an autotune sweep picks the same winner
in both, and the port's sweep cache serves it to a second delegate with
no fan-out; the HTTP routes (an oversized fan-out's 400, the missing
environment's 400 then 200) answer alike; the port's AOT and autotune
clients round-trip.  Tolerance 0: everything compared is bytes or
integers (the fake scores are exact floats of integer digests)."""

from __future__ import annotations

import json
import time
from types import SimpleNamespace

import numpy as np
import pytest
from google.protobuf import json_format

from yadcc_tpu import api as japi
from yadcc_tpu.jit import aot as jaot
from yadcc_tpu.jit import autotune as jautotune
from yadcc_tpu.jit import fanout as jfanout
from yadcc_tpu_torch import api as tapi
from yadcc_tpu_torch.common import compress as tcompress
from yadcc_tpu_torch.common import multi_chunk
from yadcc_tpu_torch.common.hashing import digest_bytes
from yadcc_tpu_torch.daemon import cache_format as tcache
from yadcc_tpu_torch.jit import aot as taot
from yadcc_tpu_torch.jit import autotune as tautotune
from yadcc_tpu_torch.jit import fanout as tfanout

from .conftest import post_local
from .test_torch_jit_offload import (JENV, TENV, cache_entry, rigs,  # noqa: F401
                                     servant_runs, submit,
                                     until_from_cache)

SRC = b'extern "C" int ytpu_fanout_probe(void) { return YTPU_DEVICE_COUNT; }\n'
KERNEL = b"// {BLOCK} {ITEMS}\n" + SRC
PKGS = (("jax", jfanout), ("port", tfanout))


def topo(mod, *shape, options=b""):
    count = 1
    for d in shape:
        count *= d
    return mod.TopologySpec(mesh_shape=tuple(shape), device_count=count,
                            compile_options=options).validate()


# -- the machinery alone ------------------------------------------------------


@pytest.mark.parametrize("raw", ["", "8", "lots", "-3", "0", "200"])
def test_width_bound_equal(raw, monkeypatch):
    if raw:
        monkeypatch.setenv("YTPU_FANOUT_MAX_WIDTH", raw)
    else:
        monkeypatch.delenv("YTPU_FANOUT_MAX_WIDTH", raising=False)
    for n in (0, 1, 8, 9, 64, 65, 200, 201):
        got = {}
        for name, mod in PKGS:
            try:
                got[name] = mod.checked_fanout_width(n)
            except ValueError as e:
                got[name] = str(e)
        assert got["port"] == got["jax"], n


@pytest.mark.parametrize("seed", range(3))
def test_topologies_slices_and_digests_equal(seed):
    rng = np.random.default_rng(seed)
    for _ in range(12):
        shape = tuple(int(d) for d in rng.integers(
            1, 9, int(rng.integers(1, 3))))
        opts = rng.integers(0, 256, int(rng.integers(0, 24)),
                            dtype=np.uint8).tobytes()
        j, t = (topo(mod, *shape, options=opts) for _, mod in PKGS)
        assert (t.digest(), t.tag()) == (j.digest(), j.tag())
        configs = [tfanout.canonical_config(
            {"BLOCK": int(b), "ITEMS": int(i)})
            for b, i in rng.integers(1, 512, (int(rng.integers(1, 20)), 2))]
        assert configs == [jfanout.canonical_config(json.loads(c))
                           for c in configs]
        width = int(rng.integers(1, 9))
        assert tfanout.slice_configs(configs, width) == \
            jfanout.slice_configs(configs, width)
        assert tfanout.slice_digest(configs) == \
            jfanout.slice_digest(configs)
        assert tfanout.search_space_digest(configs) == \
            jfanout.search_space_digest(configs)
    for bad in ((), (2, 2, 2)):
        for _, mod in PKGS:
            with pytest.raises(ValueError):
                mod.TopologySpec(mesh_shape=bad, device_count=8).validate()
    for _, mod in PKGS:
        with pytest.raises(ValueError):
            mod.TopologySpec(mesh_shape=(2, 4), device_count=6).validate()


def test_search_space_and_mesh_family_equal():
    axes = dict(BLOCK=[32, 64, 128, 256], ITEMS=[1, 2, 4, 8])
    assert tautotune.SearchSpace.of(**axes).expand() == \
        jautotune.SearchSpace.of(**axes).expand()
    t = taot.topologies_for_mesh_family([1, 2, 4, 8], b'{"arch":"sm_80"}')
    j = jaot.topologies_for_mesh_family([1, 2, 4, 8], b'{"arch":"sm_80"}')
    assert [(x.mesh_shape, x.digest()) for x in t] == \
        [(x.mesh_shape, x.digest()) for x in j]


def sweep_parent(pkg: str, kernel=KERNEL, configs=None, width=2,
                 cache_control=1):
    configs = list(configs or tautotune.SearchSpace.of(
        BLOCK=[64, 128], ITEMS=[1, 2]).expand())
    common = dict(requestor_pid=1, kernel_digest=digest_bytes(kernel),
                  backend=TENV.backend, cache_control=cache_control,
                  configs=configs, fanout_width=width,
                  compressed_kernel=tcompress.compress(kernel))
    if pkg == "jax":
        from yadcc_tpu.daemon.local.autotune_task import AutotuneSweepTask

        return AutotuneSweepTask(jaxlib_version=JENV.jaxlib_version,
                                 **common)
    from yadcc_tpu_torch.daemon.local.autotune_task import \
        AutotuneSweepTask

    return AutotuneSweepTask(toolchain_version=TENV.toolchain_version,
                             **common)


def aot_parent(pkg: str, topologies, src=SRC, cache_control=1):
    mod = jfanout if pkg == "jax" else tfanout
    common = dict(requestor_pid=1, computation_digest=digest_bytes(src),
                  backend=TENV.backend, cache_control=cache_control,
                  topologies=[topo(mod, *t.mesh_shape,
                                   options=t.compile_options)
                              for t in topologies],
                  compressed_computation=tcompress.compress(src))
    if pkg == "jax":
        from yadcc_tpu.daemon.local.aot_task import AotBuildTask

        return AotBuildTask(jaxlib_version=JENV.jaxlib_version, **common)
    from yadcc_tpu_torch.daemon.local.aot_task import AotBuildTask

    return AotBuildTask(toolchain_version=TENV.toolchain_version, **common)


def test_children_and_fairness_split_equal():
    topos = [topo(tfanout, n) for n in (1, 2, 4, 8)]
    for make, arg in ((aot_parent, topos), (sweep_parent, None)):
        got = {}
        for pkg, _ in PKGS:
            parent = make(pkg, arg) if arg else make(pkg)
            parent.fairness_weight = 0.5
            parent.tenant_id, parent.tenant_fanout_cap = "acme", 4
            children = parent.expand_children()
            got[pkg] = [(key, c.get_digest(), c.get_cache_key(),
                         c.fairness_weight, c.fairness_key(), c.tenant_id,
                         c.tenant_fanout_cap) for key, c in children]
        assert got["port"] == got["jax"]
        assert all(w == 0.5 / len(got["port"])
                   for _, _, _, w, *_ in got["port"])


def _fake_result(exit_code=0, **kw):
    base = dict(exit_code=exit_code, standard_error=b"", files={},
                from_cache=False, reused_existing=False)
    base.update(kw)
    return SimpleNamespace(**base)


SCRIPTS = {
    "retry-then-ok": ({"a": [-1, 0], "b": [0]}, {}),
    "deterministic": ({"a": [2], "b": [0]}, {}),
    "straggler": ({"a": [None, None, None], "b": [0]},
                  {"policy": "3"}),
    "abort": ({"a": [-1], "b": [-1]}, {"aborted": True}),
    "cached-joined": ({"a": ["cache"], "b": ["join"]}, {}),
    "infra-stderr": ({"a": [-1, -1, -1]}, {"policy": "3"}),
}


def _script(spec):
    out = {}
    for key, codes in spec.items():
        out[key] = [None if c is None else
                    _fake_result(0, from_cache=True) if c == "cache" else
                    _fake_result(0, reused_existing=True) if c == "join"
                    else _fake_result(c, standard_error=b"err %d" % c)
                    for c in codes]
    return out


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_run_fanout_verdicts_equal(name):
    spec, kw = SCRIPTS[name]
    got = {}
    for pkg, mod in PKGS:
        script = _script(spec)
        state = {"next": 0, "by_id": {}, "freed": [], "sleeps": 0}

        def queue(task, state=state):
            state["next"] += 1
            state["by_id"][state["next"]] = task
            return state["next"]

        def wait(task_id, timeout_s, state=state, script=script):
            return script[state["by_id"][task_id].key].pop(0)

        def sleep(s, state=state):
            state["sleeps"] += 1

        extra = {}
        if "policy" in kw:
            extra["policy"] = mod.FanoutPolicy(max_attempts=int(
                kw["policy"]))
        if kw.get("aborted"):
            extra["aborted"] = lambda: True
        outcomes = mod.run_fanout(
            [(k, SimpleNamespace(key=k)) for k in spec], queue=queue,
            wait=wait, free=state["freed"].append, sleep=sleep, **extra)
        got[pkg] = ([vars(o.verdict) for o in outcomes.values()],
                    mod.aggregate_exit_code(outcomes),
                    mod.verdict_summary(outcomes), state["freed"],
                    state["sleeps"])
    assert got["port"] == got["jax"]


def _aot_msg(api, n=2, version=None, shapes=None):
    msg = api.fanout.SubmitAotTaskRequest(
        requestor_process_id=1, computation_digest=digest_bytes(SRC),
        backend="cpu", jaxlib_version=JENV.jaxlib_version
        if version is None else version, cache_control=1)
    for shape, count in shapes or [((k,), k) for k in range(1, n + 1)]:
        t = msg.topologies.add(device_count=count)
        t.mesh_shape.extend(shape)
    return msg


def _tune_msg(api, configs=('{"BLOCK":64}', '{"BLOCK":128}'), width=0,
              backend="cpu"):
    msg = api.fanout.SubmitAutotuneTaskRequest(
        requestor_process_id=1, kernel_digest=digest_bytes(KERNEL),
        backend=backend, jaxlib_version=JENV.jaxlib_version,
        cache_control=1, fanout_width=width)
    msg.configs.extend(configs)
    return msg


FACTORY_CASES = {
    "aot-ok": ("aot", lambda a: _aot_msg(a)),
    "aot-no-env": ("aot", lambda a: _aot_msg(a, version="")),
    "aot-empty": ("aot", lambda a: _aot_msg(a, n=0)),
    "aot-oversized": ("aot", lambda a: _aot_msg(a, n=65)),
    "aot-duplicate": ("aot", lambda a: _aot_msg(
        a, shapes=[((1,), 1), ((1,), 1)])),
    "aot-inconsistent": ("aot", lambda a: _aot_msg(
        a, shapes=[((2, 2), 3)])),
    "tune-ok": ("tune", lambda a: _tune_msg(a)),
    "tune-no-env": ("tune", lambda a: _tune_msg(a, backend="")),
    "tune-empty": ("tune", lambda a: _tune_msg(a, configs=())),
    "tune-bad-config": ("tune", lambda a: _tune_msg(a, configs=("[1]",))),
    "tune-width": ("tune", lambda a: _tune_msg(
        a, configs=[f'{{"B":{i}}}' for i in range(10)], width=3)),
    "tune-default-width": ("tune", lambda a: _tune_msg(
        a, configs=[f'{{"B":{i}}}' for i in range(10)])),
    "tune-oversized": ("tune", lambda a: _tune_msg(
        a, configs=[f'{{"B":{i}}}' for i in range(70)], width=65)),
}


@pytest.mark.parametrize("case", sorted(FACTORY_CASES))
def test_factories_accept_and_refuse_alike(case):
    from yadcc_tpu.daemon.local.aot_task import make_aot_task as jaot_task
    from yadcc_tpu.daemon.local.autotune_task import \
        make_autotune_task as jtune_task
    from yadcc_tpu_torch.daemon.local.aot_task import \
        make_aot_task as taot_task
    from yadcc_tpu_torch.daemon.local.autotune_task import \
        make_autotune_task as ttune_task

    kind, build = FACTORY_CASES[case]
    makers = {"aot": (jaot_task, taot_task),
              "tune": (jtune_task, ttune_task)}[kind]
    got = {}
    for (pkg, api), make in zip((("jax", japi), ("port", tapi)), makers):
        try:
            task = make(build(api), b"att")
            got[pkg] = ("ok", task.get_digest(), task.get_cache_key(),
                        getattr(task, "fanout_width", None))
        except Exception as e:
            got[pkg] = (type(e).__name__, str(e))
    assert got["port"] == got["jax"]


# -- both rigs, end to end ----------------------------------------------------


def kind_stats(delegate, kind):
    return delegate.inspect()["stats_by_kind"].get(
        kind, {"hit_cache": 0, "reused": 0, "actually_run": 0,
               "failed": 0, "shed_to_local": 0})


def test_aot_partial_hit_equal_in_both_rigs(rigs):
    """One topology pre-cached, then four: three builds, one cached, in
    both rigs, with equal verdicts, artifacts and cache entries; the
    resubmission is all cached with no servant run."""
    src = b"// aot partial\n" + SRC
    topos = [topo(tfanout, 1), topo(tfanout, 1, options=b'{"arch":"sm_90"}'),
             topo(tfanout, 2, 2), topo(tfanout, 8,
                                       options=b'{"arch":"sm_80"}')]
    got = {}
    for pkg in ("jax", "port"):
        rig = rigs[pkg]
        r = submit(rig.delegate, aot_parent(pkg, topos[:1], src))
        assert [v.status for v in r.verdicts] == ["ok"]
        for _ in range(40):
            rig.cache_reader.sync_once()
            r = submit(rig.delegate, aot_parent(pkg, topos[:1], src))
            if r.verdicts[0].status == "cached":
                break
            time.sleep(0.25)
        assert r.verdicts[0].status == "cached", pkg
        runs0, stats0 = servant_runs(rig), kind_stats(rig.delegate, "aot")
        r = submit(rig.delegate, aot_parent(pkg, topos, src))
        assert r.exit_code == 0
        assert [v.status for v in r.verdicts] == ["cached", "ok", "ok",
                                                  "ok"]
        assert servant_runs(rig) == runs0 + 3
        stats1 = kind_stats(rig.delegate, "aot")
        assert stats1["actually_run"] - stats0["actually_run"] == 3
        entries = [cache_entry(rig, tcache.get_aot_cache_key(
            TENV.digest, t.digest(), digest_bytes(src))) for t in topos]
        got[pkg] = ([vars(v) for v in r.verdicts], r.exit_code,
                    bytes(r.standard_output),
                    {k: bytes(v) for k, v in r.files.items()}, entries)
    assert got["port"] == got["jax"]
    assert sorted(got["port"][3]) == sorted(f".{t.tag()}.xla"
                                            for t in topos)
    rig = rigs["port"]
    runs1 = servant_runs(rig)
    for _ in range(40):
        rig.cache_reader.sync_once()
        r2 = submit(rig.delegate, aot_parent("port", topos, src))
        if all(v.status == "cached" for v in r2.verdicts):
            break
        time.sleep(0.25)
    assert all(v.status == "cached" for v in r2.verdicts)
    assert servant_runs(rig) == runs1
    assert {k: bytes(v) for k, v in r2.files.items()} == got["port"][3]


def test_autotune_same_winner_and_the_sweep_cache(rigs):
    """The same sweep in both rigs: the same winner record (the fake
    worker's best score over the space); then the port's sweep cache
    serves it to a second delegate with no fan-out and no servant run."""
    from yadcc_tpu_torch.daemon.local.autotune_task import (
        WINNER_RECORD_KEY, parse_winner_record)
    from yadcc_tpu_torch.jit.compile_worker import _config_score_fake

    kernel = b"// sweep {BLOCK} {ITEMS}\n" + SRC
    configs = tautotune.SearchSpace.of(BLOCK=[32, 64, 128, 256],
                                       ITEMS=[1, 2, 4, 8]).expand()
    got = {}
    for pkg in ("jax", "port"):
        r = submit(rigs[pkg].delegate, sweep_parent(pkg, kernel, configs,
                                                    width=4))
        assert r.exit_code == 0, pkg
        got[pkg] = (parse_winner_record(r.files[WINNER_RECORD_KEY]),
                    [vars(v) for v in r.verdicts])
    assert got["port"] == got["jax"]
    winner = got["port"][0]
    assert winner["evaluated"] == 16
    assert winner["config"] == max(
        (json.loads(c) for c in configs),
        key=lambda c: _config_score_fake(c, kernel))

    rig = rigs["port"]
    runs0 = servant_runs(rig)
    d2 = rig.make_extra_delegate()
    r2 = until_from_cache(rig.cache_reader, d2,
                          lambda: sweep_parent("port", kernel, configs, 4))
    assert r2 is not None, "the sweep was never served from its cache"
    assert r2.verdicts == []
    assert parse_winner_record(r2.files[WINNER_RECORD_KEY]) == winner
    assert servant_runs(rig) == runs0
    assert kind_stats(d2, "autotune")["hit_cache"] >= 1


def _fanout_http(rig, api) -> list:
    port = rig.http.port
    out = []
    big = _aot_msg(api, n=65)
    out.append(post_local(port, "/local/submit_aot_task",
                          multi_chunk.make_multi_chunk([
                              json_format.MessageToJson(big).encode(),
                              tcompress.compress(SRC)])))
    msg = _tune_msg(api, backend="cpu")
    msg.jaxlib_version = ""
    for version in ("", JENV.jaxlib_version):
        msg.jaxlib_version = version
        msg.cache_control = 0
        status, data = post_local(
            port, "/local/submit_autotune_task",
            multi_chunk.make_multi_chunk([
                json_format.MessageToJson(msg).encode(),
                tcompress.compress(KERNEL)]))
        out.append((status, data if status != 200 else
                    sorted(json.loads(data))))
    tid = int(json.loads(data)["task_id"])
    deadline = time.monotonic() + 60
    while True:
        wreq = api.fanout.WaitForAutotuneTaskRequest(
            task_id=tid, milliseconds_to_wait=1000)
        status, data = post_local(port, "/local/wait_for_autotune_task",
                                  json_format.MessageToJson(wreq).encode())
        if status != 503 or time.monotonic() > deadline:
            break
    chunks = multi_chunk.try_parse_multi_chunk(data)
    out.append((status, bytes(chunks[0]), [bytes(c) for c in chunks[1:]]))
    return out


def test_http_routes_answer_alike(rigs):
    got = {pkg: _fanout_http(rigs[pkg], api)
           for pkg, api in (("jax", japi), ("port", tapi))}
    assert got["port"] == got["jax"]
    assert [r[0] for r in got["port"]] == [400, 400, 200, 200]
    assert b"invalid fan-out submission" in got["port"][0][1]


def test_aot_and_autotune_clients_round_trip(rigs, monkeypatch):
    from yadcc_tpu_torch.client import daemon_call

    daemon_call.set_daemon_call_handler(None)
    monkeypatch.setenv("YTPU_DAEMON_PORT", str(rigs["port"].http.port))
    monkeypatch.setenv("YTPU_JIT_OFFLOAD", "1")
    env = dict(backend=TENV.backend,
               toolchain_version=TENV.toolchain_version)
    topos = [topo(tfanout, 1), topo(tfanout, 2, 2,
                                    options=b'{"arch":"sm_80"}')]
    out = taot.submit_aot_build(b"// client\n" + SRC, topos, **env)
    assert out.ok and out.exit_code == 0 and len(out.verdicts) == 2
    for t in topos:
        assert out.artifact_for(t).startswith(b"FAKEXLA1")
    res = tautotune.sweep(b"// client {BLOCK}\n" + SRC,
                          tautotune.SearchSpace.of(BLOCK=[64, 128]),
                          fanout_width=2, **env)
    assert res.ok and res.exit_code == 0
    assert res.winning_config in ({"BLOCK": 64}, {"BLOCK": 128})
    monkeypatch.setenv("YTPU_JIT_OFFLOAD", "0")
    assert not taot.submit_aot_build(SRC, topos, **env).ok
    assert not tautotune.sweep(KERNEL, tautotune.SearchSpace.of(
        BLOCK=[1]), **env).ok
