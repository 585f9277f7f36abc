"""The port's trace prefetcher (yadcc_tpu_torch/cache/prefetcher.py) against
the JAX package's: tests/test_prefetch.py's scenarios, each run on both
packages' CacheService (L1, disk L2, objstore L3) with their own
prefetcher, every stat, planted key and Bloom bit held equal between
them; and ``load_and_warm`` as the cache server runs it, without torch."""

from __future__ import annotations

import importlib
import json
import pathlib
import subprocess
import sys
import textwrap

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent


class _FakeClock:
    """monotonic/sleep pair where sleep advances time instantly."""

    def __init__(self):
        self.t = 0.0
        self.slept = []

    def monotonic(self):
        return self.t

    def sleep(self, s):
        self.t += s
        self.slept.append(s)


class _Pkg:
    def __init__(self, root: str):
        m = lambda name: importlib.import_module(f"{root}.{name}")  # noqa
        self.disk = m("cache.disk_engine")
        self.mem = m("cache.in_memory_cache")
        self.obj = m("cache.object_store_engine")
        self.pf = m("cache.prefetcher")
        self.svc = m("cache.service")
        self.dc = m("common.disk_cache")
        self.adm = m("scheduler.admission")
        self.tr = m("tools.trace_replay")


PKGS = {"jax": _Pkg("yadcc_tpu"), "port": _Pkg("yadcc_tpu_torch")}


def _service(p, tmp_path, tag, l3=True):
    root = tmp_path / tag
    root.mkdir()
    l3_engine = None
    if l3:
        (root / "bucket").mkdir()
        l3_engine = p.obj.ObjectStoreEngine(
            p.obj.FsObjectStoreBackend(str(root / "bucket")),
            resync_interval_s=0.0)
    return p.svc.CacheService(
        p.mem.InMemoryCache(1 << 20),
        p.disk.DiskCacheEngine([p.dc.ShardSpec(str(root / "l2"), 1 << 20)]),
        l3=l3_engine)


def _both(tmp_path, scenario):
    """``scenario(pkg, tmp_path, tag)`` on each package; both records
    must be equal.  Returns the record."""
    recs = {name: scenario(p, tmp_path, name) for name, p in PKGS.items()}
    assert recs["port"] == recs["jax"]
    return recs["port"]


@pytest.mark.parametrize("key", [
    "ytpu-cxx2-entry-ab", "../../etc/passwd", "other-prefix", 42, None,
    "ytpu-" + "x" * 600, "ytpu-" + "x" * 100, "ytpu-" + "x" * 507,
    "ytpu-" + "x" * 508, "ytpu-", "YTPU-sim", b"ytpu-bytes"])
def test_sanitizer_verdicts(key):
    got = PKGS["port"].pf.sanitize_prefetch_key(key)
    assert got == PKGS["jax"].pf.sanitize_prefetch_key(key)
    assert got in (None, key)


def _warm_plants(p, tmp_path, tag):
    svc = _service(p, tmp_path, tag)
    try:
        keys = [f"ytpu-sim-entry-{i}" for i in range(5)]
        for k in keys:
            svc.l3.put(k, b"V" * 100)
        clk = _FakeClock()
        stats = p.pf.TracePrefetcher(svc, clock=clk).warm(keys)
        return [stats, clk.slept,
                [(svc.l1.try_get(k), svc.l2.try_get(k),
                  svc.bloom.may_contain(k)) for k in keys],
                svc.bloom.may_contain("ytpu-sim-entry-absent"),
                sorted(svc.l2.keys())]
    finally:
        svc.stop()


def test_warm_plants_l1_l2_and_bloom(tmp_path):
    rec = _both(tmp_path, _warm_plants)
    assert rec[0]["fetched"] == 5
    assert all(row == (b"V" * 100, b"V" * 100, True) for row in rec[2])


def _skips(p, tmp_path, tag):
    svc = _service(p, tmp_path, tag)
    try:
        svc.l3.put("ytpu-sim-entry-cold", b"C")
        svc.l1.put("ytpu-sim-entry-warm", b"W")
        return p.pf.TracePrefetcher(svc, clock=_FakeClock()).warm([
            "ytpu-sim-entry-cold",
            "ytpu-sim-entry-cold",       # trace repeat: deduped
            "ytpu-sim-entry-warm",       # already resident
            "ytpu-sim-entry-gone",       # aged out of L3
            "evil://not-a-key",          # sanitizer reject
        ])
    finally:
        svc.stop()


def test_skips_present_missing_and_invalid(tmp_path):
    stats = _both(tmp_path, _skips)
    assert (stats["fetched"], stats["skipped_present"], stats["missing"],
            stats["skipped_invalid"]) == (1, 1, 1, 1)


def _caps(p, tmp_path, tag):
    svc = _service(p, tmp_path, tag)
    try:
        keys = [f"ytpu-sim-entry-{i}" for i in range(10)]
        for i, k in enumerate(keys):
            svc.l3.put(k, b"x" * (100 + i))
        by_entries = p.pf.TracePrefetcher(
            svc, max_entries=3, clock=_FakeClock()).warm(keys)
        planted = sorted(svc.l2.keys())
        by_bytes = p.pf.TracePrefetcher(
            svc, max_bytes=250, clock=_FakeClock()).warm(keys)
        return [by_entries, planted, by_bytes, sorted(svc.l2.keys())]
    finally:
        svc.stop()


def test_entry_and_byte_caps_stop_the_sweep(tmp_path):
    rec = _both(tmp_path, _caps)
    assert rec[0]["fetched"] == 3
    assert rec[2]["fetched"] == 3 and rec[2]["skipped_present"] == 3


def _throttle(p, tmp_path, tag):
    svc = _service(p, tmp_path, tag)
    try:
        keys = [f"ytpu-sim-entry-{i}" for i in range(4)]
        for k in keys:
            svc.l3.put(k, b"B" * 1000)
        clk = _FakeClock()
        stats = p.pf.TracePrefetcher(svc, bytes_per_s=1000,
                                     clock=clk).warm(keys)
        return [stats, clk.slept]
    finally:
        svc.stop()


def test_bytes_per_s_throttle_sleeps(tmp_path):
    stats, slept = _both(tmp_path, _throttle)
    # 4000 bytes at 1000 B/s: each fetch's debt slept off on the fake
    # clock (a sleep is capped at 1 s).
    assert stats["fetched"] == 4 and slept == [1.0, 1.0, 1.0, 1.0]


def _shed(p, tmp_path, tag):
    svc = _service(p, tmp_path, tag)
    try:
        keys = [f"ytpu-sim-entry-{i}" for i in range(6)]
        for k in keys:
            svc.l3.put(k, b"x")
        a = p.adm
        rungs = iter([a.RUNG_NORMAL, a.RUNG_SHED_OPTIONAL,
                      a.RUNG_SHED_OPTIONAL + 1, a.RUNG_NORMAL,
                      a.RUNG_NORMAL, a.RUNG_SHED_OPTIONAL - 1])
        stats = p.pf.TracePrefetcher(
            svc, rung_probe=lambda: next(rungs),
            clock=_FakeClock()).warm(keys)
        return [stats, [svc.l1.try_get(k) is not None for k in keys]]
    finally:
        svc.stop()


def test_sheds_at_shed_optional(tmp_path):
    assert PKGS["port"].adm.RUNG_SHED_OPTIONAL == \
        PKGS["jax"].adm.RUNG_SHED_OPTIONAL
    stats, planted = _both(tmp_path, _shed)
    assert stats["skipped_shed"] == 2 and stats["fetched"] == 4
    assert planted == [True, False, False, True, True, True]


def _no_l3(p, tmp_path, tag):
    svc = _service(p, tmp_path, tag, l3=False)
    try:
        return p.pf.TracePrefetcher(svc, clock=_FakeClock()).warm(
            ["ytpu-sim-entry-0"])
    finally:
        svc.stop()


def test_no_l3_is_a_noop(tmp_path):
    assert _both(tmp_path, _no_l3)["fetched"] == 0


def _key_trace(p, tmp_path, tag):
    path = tmp_path / f"keys-{tag}.jsonl"
    universe = p.tr.generate_key_trace(str(path), keys=20, draws=200, seed=3)
    dirty = tmp_path / f"dirty-{tag}.jsonl"
    dirty.write_text("\n".join([
        json.dumps({"kind": "key", "key": "ytpu-sim-entry-ok"}),
        json.dumps({"kind": "key", "key": "../escape"}),
        json.dumps({"kind": "key", "key": 7}),
        json.dumps({"kind": "pool", "servants": []}),
        "not json at all",
        json.dumps({"kind": "key", "key": "ytpu-sim-entry-ok2"}),
    ]) + "\n")
    return [universe, path.read_bytes(), p.tr.load_key_trace(str(path)),
            p.tr.load_key_trace(str(dirty)),
            p.tr.load_key_trace(str(dirty), max_keys=1)]


def test_key_trace_round_trip(tmp_path):
    universe, raw, stream, dirty, capped = _both(tmp_path, _key_trace)
    assert len(stream) == 200 and set(stream) <= set(universe)
    top = max(set(stream), key=stream.count)
    assert stream.count(top) > 200 / 20
    assert dirty == ["ytpu-sim-entry-ok", "ytpu-sim-entry-ok2"]
    assert capped == ["ytpu-sim-entry-ok"]


def _front_door(p, tmp_path, tag):
    svc = _service(p, tmp_path, tag)
    try:
        path = str(tmp_path / f"t-{tag}.jsonl")
        p.tr.generate_key_trace(path, keys=8, draws=50, seed=1)
        for i in range(8):
            svc.l3.put(f"ytpu-sim-entry-{i:08d}", b"warmed")
        stats = p.pf.load_and_warm(svc, path, clock=_FakeClock())
        return [stats, sorted(svc.l2.keys())]
    finally:
        svc.stop()


def test_load_and_warm_front_door(tmp_path):
    stats, planted = _both(tmp_path, _front_door)
    assert stats["fetched"] == len(planted) > 0


def test_load_and_warm_loads_no_torch(tmp_path):
    """The cache server's process warms from a trace without torch: the
    port's service and ``load_and_warm`` (through the trace loader) with
    torch, jax and the JAX package blocked."""
    script = textwrap.dedent(r"""
        import sys
        for name in ("torch", "jax", "jaxlib", "yadcc_tpu"):
            sys.modules[name] = None
        from yadcc_tpu_torch.cache.disk_engine import DiskCacheEngine
        from yadcc_tpu_torch.cache.in_memory_cache import InMemoryCache
        from yadcc_tpu_torch.cache.object_store_engine import (
            FsObjectStoreBackend, ObjectStoreEngine)
        from yadcc_tpu_torch.cache.prefetcher import load_and_warm
        from yadcc_tpu_torch.cache.service import CacheService
        from yadcc_tpu_torch.common.disk_cache import ShardSpec
        from yadcc_tpu_torch.tools.trace_replay import generate_key_trace
        root = sys.argv[1]
        svc = CacheService(
            InMemoryCache(1 << 20),
            DiskCacheEngine([ShardSpec(root + "/l2", 1 << 20)]),
            l3=ObjectStoreEngine(FsObjectStoreBackend(root + "/bucket")))
        generate_key_trace(root + "/t.jsonl", keys=4, draws=40, seed=2)
        for i in range(4):
            svc.l3.put(f"ytpu-sim-entry-{i:08d}", b"v")
        stats = load_and_warm(svc, root + "/t.jsonl")
        svc.stop()
        assert stats["fetched"] > 0, stats
        assert not any(n.split(".")[0] in ("torch", "jax", "yadcc_tpu")
                       for n in sys.modules if sys.modules[n])
        print("ok")
    """)
    (tmp_path / "bucket").mkdir()
    out = subprocess.run([sys.executable, "-c", script, str(tmp_path)],
                         cwd=REPO, capture_output=True, text=True,
                         timeout=60)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "ok"
