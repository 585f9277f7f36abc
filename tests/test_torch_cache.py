"""The port's cache server against the JAX package's (CPU only).

Each script runs the same calls through both packages' CacheService, on a
virtual clock, with the Bloom generators' salts drawn from one seed in
both (``secrets.randbits`` patched), and records every reply, attachment,
decompressed filter, incremental key list and ``inspect()`` counter; the
two records must be equal.  The fetch script also runs over both real
front ends (threaded gRPC and aio) on loopback, where the server keys a
client's sync state by the peer address each front end reports.

Beside the scripts: directories the JAX engines filled read back whole
through the port's (and the other way round), the zlib stand-in against
the JAX package's with ``zstandard`` blocked, and TestArc's cases on both
ARCs.
"""

from __future__ import annotations

import hashlib
import json
import random
import secrets
import subprocess
import sys
import textwrap
import types
from pathlib import Path

import pytest

import yadcc_tpu.cache.cache_engine as jeng
import yadcc_tpu.cache.disk_engine as jdisk
import yadcc_tpu.cache.in_memory_cache as jarc
import yadcc_tpu.cache.object_store_engine as jobj
import yadcc_tpu.cache.service as jsvc
import yadcc_tpu.common.compress as jcomp
import yadcc_tpu.common.disk_cache as jdc
import yadcc_tpu.rpc as jrpc
import yadcc_tpu.tenancy.budgets as jbud
import yadcc_tpu.tenancy.keys as jkeys
from yadcc_tpu import api as japi
from yadcc_tpu.common import bloom as jbloom
from yadcc_tpu.common.token_verifier import TokenVerifier as JTokens
from yadcc_tpu.utils.clock import VirtualClock as JClock
import yadcc_tpu_torch.cache.cache_engine as teng
import yadcc_tpu_torch.cache.disk_engine as tdisk
import yadcc_tpu_torch.cache.in_memory_cache as tarc
import yadcc_tpu_torch.cache.object_store_engine as tobj
import yadcc_tpu_torch.cache.service as tsvc
import yadcc_tpu_torch.common.compress as tcomp
import yadcc_tpu_torch.common.disk_cache as tdc
import yadcc_tpu_torch.rpc as trpc
import yadcc_tpu_torch.tenancy.budgets as tbud
import yadcc_tpu_torch.tenancy.keys as tkeys
from yadcc_tpu_torch import api as tapi
from yadcc_tpu_torch.common import bloom as tbloom
from yadcc_tpu_torch.common.token_verifier import TokenVerifier as TTokens
from yadcc_tpu_torch.utils.clock import VirtualClock as TClock

REPO = Path(__file__).resolve().parent.parent
SVC = "ytpu.CacheService"
SEED = 1234

PKGS = {
    "jax": types.SimpleNamespace(
        api=japi, svc=jsvc, arc=jarc, disk=jdisk, obj=jobj, eng=jeng,
        comp=jcomp, dc=jdc, rpc=jrpc, bud=jbud, keys=jkeys, bloom=jbloom,
        Tokens=JTokens, Clock=JClock),
    "port": types.SimpleNamespace(
        api=tapi, svc=tsvc, arc=tarc, disk=tdisk, obj=tobj, eng=teng,
        comp=tcomp, dc=tdc, rpc=trpc, bud=tbud, keys=tkeys, bloom=tbloom,
        Tokens=TTokens, Clock=TClock),
}


def _sha(data) -> str:
    return hashlib.sha256(bytes(data)).hexdigest()[:16]


class Rig:
    """One package's CacheService (L1 1 MiB, a disk L2, optionally a
    shared objstore L3) on a virtual clock, reached through the package's
    mock transport or a real front end."""

    def __init__(self, name: str, root: Path, *, l3: bool = False,
                 tag: str = "a", mock: str = "", clock=None,
                 l3_engine=None, **kw):
        p = self.p = PKGS[name]
        self.name = name
        self.root = root
        self.clock = clock if clock is not None else p.Clock(1000.0)
        if l3 and l3_engine is None:
            l3_engine = p.obj.ObjectStoreEngine(
                p.obj.FsObjectStoreBackend(str(root / "bucket")),
                resync_interval_s=0.0)
        self.svc = p.svc.CacheService(
            p.arc.InMemoryCache(1 << 20),
            p.disk.DiskCacheEngine(
                [p.dc.ShardSpec(str(root / f"l2-{tag}"), 1 << 20)]),
            l3=l3_engine,
            user_tokens=p.Tokens(["user"]),
            servant_tokens=p.Tokens(["servant"]),
            clock=self.clock, **kw)
        self.mock = mock or f"cache-{tag}"
        p.rpc.register_mock_server(self.mock, self.svc.spec())
        self.server = None
        self.uri = f"mock://{self.mock}"

    def serve(self, frontend: str) -> None:
        """Mount the service on a real front end on loopback; calls then
        go through the port's client (its aio client closes its socket,
        so either package's aio server stops promptly)."""
        self.server = self.p.rpc.make_rpc_server(frontend, "127.0.0.1:0",
                                                 max_workers=4)
        self.server.add_service(self.svc.spec())
        self.server.start()
        scheme = "aio" if frontend == "aio" else "grpc"
        self.uri = f"{scheme}://127.0.0.1:{self.server.port}"

    def close(self) -> None:
        if self.server is not None:
            self.server.stop()
        self.svc.stop()
        self.p.rpc.unregister_mock_server(self.mock)

    def call(self, method: str, token: str = "user", attachment=b"",
             peer: str = "", **fields) -> tuple:
        """(status, reply bytes, attachment digest, filter record)."""
        api = self.p.api.cache
        req_cls, resp_cls = {
            "PutEntry": (api.PutEntryRequest, api.PutEntryResponse),
            "TryGetEntry": (api.TryGetEntryRequest, api.TryGetEntryResponse),
            "FetchBloomFilter": (api.FetchBloomFilterRequest,
                                 api.FetchBloomFilterResponse),
            "FetchFleetBloomFilter": (api.FetchBloomFilterRequest,
                                      api.FetchBloomFilterResponse),
        }[method]
        if self.uri.startswith("mock://"):
            chan = self.p.rpc.Channel(
                self.uri + (f"@{peer}" if peer else ""))
        else:
            chan = trpc.Channel(self.uri)
        try:
            resp, att = chan.call(SVC, method, req_cls(token=token, **fields),
                                  resp_cls, attachment=attachment,
                                  timeout=10.0)
        except (jrpc.RpcError, trpc.RpcError) as e:
            return ("err", e.status)
        finally:
            chan.close()
        out = ["ok", resp.SerializeToString(), _sha(att)]
        if method.startswith("Fetch"):
            out.append(list(resp.newly_populated_keys))
            if not resp.incremental:
                data = self.p.comp.decompress(bytes(att))
                out.append((int.from_bytes(data[:4], "little"),
                            _sha(data[4:])))
        return tuple(out)

    def put(self, key: str, value: bytes = b"OBJ", token: str = "servant"):
        return self.call("PutEntry", token=token, attachment=value, key=key)

    def get(self, key: str):
        return self.call("TryGetEntry", key=key)

    def fetch(self, last_full, last_any, peer: str = "",
              method: str = "FetchBloomFilter"):
        return self.call(method, peer=peer,
                         seconds_since_last_full_fetch=last_full,
                         seconds_since_last_fetch=last_any)

    def inspect(self) -> dict:
        ins = self.svc.inspect()
        ins.pop("tryget_reply_ms_max")          # a wall-clock time
        return json.loads(json.dumps(ins).replace(str(self.root), "<root>"))


def _run_both(monkeypatch, tmp_path, script, **kw):
    """Run ``script(rig)`` in each package from the same salt seed; return
    the two records."""
    out = {}
    for name in PKGS:
        monkeypatch.setattr(secrets, "randbits",
                            random.Random(SEED).getrandbits)
        root = tmp_path / name
        root.mkdir()
        rig = Rig(name, root, **kw)
        try:
            out[name] = script(rig)
        finally:
            rig.close()
    return out["jax"], out["port"]


def _assert_same(monkeypatch, tmp_path, script, **kw):
    want, got = _run_both(monkeypatch, tmp_path, script, **kw)
    assert got == want
    return got


# -- scripts ----------------------------------------------------------------


def _roundtrip(rig):
    rec = [rig.put("K", b"OBJ"), rig.get("K"), rig.get("nope"),
           rig.put("K", b"EVIL", token="user"),       # a user may not fill
           rig.put("", b"X"), rig.put("K3", b""),
           rig.put("K2", b"two")]
    rig.svc.l1.remove("K2")                           # L2 hit promotes
    rec += [rig.get("K2"), bytes(rig.svc.l1.try_get("K2")), rig.inspect()]
    return rec


def test_put_get_refusal_and_l2_promotion(monkeypatch, tmp_path):
    rec = _assert_same(monkeypatch, tmp_path, _roundtrip)
    api = tapi.cache
    assert rec[2] == ("err", api.CACHE_STATUS_NOT_FOUND)
    assert rec[3] == ("err", api.CACHE_STATUS_ACCESS_DENIED)
    assert rec[4] == rec[5] == ("err", api.CACHE_STATUS_INVALID_ARGUMENT)
    assert rec[8] == b"two" and rec[9]["l2_hits"] == 1


def _full_then_incremental(frontend):
    def script(rig):
        if frontend != "mock":
            rig.serve(frontend)
        rec = [rig.put("K1", b"1"), rig.fetch(0, 0)]
        rig.put("K2", b"2")
        rig.clock.advance(30)
        rec.append(rig.fetch(30, 30))
        rig.put("K3", b"3")
        rig.clock.advance(30)
        rec.append(rig.fetch(60, 30))
        rec.append(rig.inspect())
        return rec
    return script


@pytest.mark.parametrize("frontend", ["mock", "threaded", "aio"])
def test_full_then_incremental_fetch(monkeypatch, tmp_path, frontend):
    rec = _assert_same(monkeypatch, tmp_path,
                       _full_then_incremental(frontend))
    full, inc1, inc2 = rec[1], rec[2], rec[3]
    assert len(full) == 5 and full[3] == []            # a full filter
    # The server kept this client's sync state under the peer address
    # the front end reported: both later fetches are incremental.
    assert "K2" in inc1[3] and len(inc1) == 4
    assert "K3" in inc2[3] and len(inc2) == 4


def _restart(rig):
    """A sync that predates the server's start is forced full; so is an
    incremental ask of a client that synced before a restart, and the
    restarted server's filter holds both generations of keys."""
    peer = "10.3.0.1:1"
    rig.clock.advance(20)
    rec = [rig.fetch(300, 60, peer="10.9.0.1:1"),     # 60 s > 20 s of life
           rig.put("pre-restart", b"1"), rig.fetch(0, 0, peer=peer)]
    rig2 = Rig(rig.name, rig.root, tag="a", mock="cache-a2",
               clock=rig.p.Clock(rig.clock.now() + 45))
    try:
        rig2.clock.advance(5)
        rec.append(rig2.put("post-restart", b"2"))
        rec.append(rig2.fetch(50, 50, peer=peer))
        rec.append(bool(rig2.svc.bloom.may_contain("pre-restart")))
        rec.append(rig2.inspect())
    finally:
        rig2.close()
    return rec


def test_sync_predating_a_restart_is_forced_full(monkeypatch, tmp_path):
    rec = _assert_same(monkeypatch, tmp_path, _restart)
    assert len(rec[0]) == 5 and len(rec[2]) == 5 and len(rec[4]) == 5
    assert rec[5] is True


def _inflated_ages(rig):
    peer = "10.1.1.1:999"
    rec = [rig.fetch(0, 0, peer=peer)]
    for i in range(4):
        rig.clock.advance(30)
        rig.put(f"k{i}", b"v")
        rec.append(rig.fetch(7200, 7200, peer=peer))
    rec.append(rig.fetch(0, 0, peer=peer))          # no base filter: full
    rec.append(rig.fetch(0, 0, peer="10.1.1.2:1"))  # another client: full
    return rec


def test_inflated_age_claims_get_the_server_tracked_span(monkeypatch,
                                                         tmp_path):
    rec = _assert_same(monkeypatch, tmp_path, _inflated_ages)
    assert all(len(r) == 4 and f"k{i}" in r[3]
               for i, r in enumerate(rec[1:5]))
    assert len(rec[5]) == 5 and len(rec[6]) == 5


def _l3_tier(rig):
    svc = rig.svc
    rec = [rig.put("ytpu-cxx2-entry-k1")]
    rec.append(svc.drain_l3_for_testing())
    rec.append(bytes(svc.l3.try_get("ytpu-cxx2-entry-k1")))
    svc.l3.put("ytpu-cxx2-entry-k2", b"FOREIGN")      # only in L3
    rec.append(rig.get("ytpu-cxx2-entry-k2"))         # NOT_FOUND, promote
    rec.append(svc.drain_l3_for_testing())
    rec.append(rig.get("ytpu-cxx2-entry-k2"))         # the promoted hit
    rec.append(bool(svc.bloom.may_contain("ytpu-cxx2-entry-k2")))
    svc.l3.put("ytpu-cxx2-entry-k3", b"PEER")         # a peer's upload
    rec.append(rig.put("ytpu-cxx2-entry-k3", b"PEER"))  # deduplicated
    rec.append(svc.drain_l3_for_testing())
    rec.append(bool(svc.bloom_l3.may_contain("ytpu-cxx2-entry-k3")))
    rec.append(rig.fetch(0, 0, method="FetchFleetBloomFilter"))
    rec.append(rig.inspect())
    return rec


def test_l3_promotion_and_writeback_dedup(monkeypatch, tmp_path):
    rec = _assert_same(monkeypatch, tmp_path, _l3_tier, l3=True)
    assert rec[3] == ("err", tapi.cache.CACHE_STATUS_NOT_FOUND)
    assert rec[5][0] == "ok" and rec[5][2] == _sha(b"FOREIGN")
    l3 = rec[-1]["l3"]
    assert (l3["hits"], l3["writebacks"], l3["writeback_dedup"]) == (1, 1, 1)


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_reply_path_never_blocks_on_a_slow_l3(tmp_path, pkg):
    """The contract of tests/test_cache.py's test of the same name, on
    both packages: with an L3 whose every backend call takes ~200 ms,
    misses answer NOT_FOUND at once, the worst reply stays far below one
    backend call, and the promotion still lands."""
    import time as _time

    p = PKGS[pkg]

    class SlowBackend(p.obj.FsObjectStoreBackend):
        def get(self, name):
            _time.sleep(0.2)
            return super().get(name)

        def put(self, name, data):
            _time.sleep(0.2)
            super().put(name, data)

    slow = p.obj.ObjectStoreEngine(SlowBackend(str(tmp_path / "bucket")),
                                   resync_interval_s=1e9)
    slow.put("ytpu-cxx2-entry-slow", b"DEEP")
    rig = Rig(pkg, tmp_path, l3_engine=slow, tag="slow")
    try:
        for _ in range(3):
            assert rig.get("ytpu-cxx2-entry-slow") == (
                "err", p.api.cache.CACHE_STATUS_NOT_FOUND)
        assert rig.svc.drain_l3_for_testing(timeout_s=30.0)
        assert rig.svc.inspect()["tryget_reply_ms_max"] < 100.0
        assert rig.get("ytpu-cxx2-entry-slow")[2] == _sha(b"DEEP")
    finally:
        rig.close()


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_reply_beside_a_held_bucket_get(tmp_path, pkg):
    """chip_smoke.py phase 14's check that the reply path never waits on
    the bucket, on both packages' services behind a real front end: the
    key's object is a FIFO, so its promotion's GET blocks until the
    check writes the object into it."""
    from chip_smoke import reply_beside_a_held_get

    rig = Rig(pkg, tmp_path, l3=True, tag="held")
    rig.serve("threaded")
    key = "ytpu-cxx2-entry-" + "ab" * 32
    value = random.Random(SEED).randbytes(9000)
    rig.svc.l3.put(key, value)

    def read(k):
        chan = trpc.Channel(rig.uri)
        try:
            return chan.call(SVC, "TryGetEntry",
                             tapi.cache.TryGetEntryRequest(token="user",
                                                           key=k),
                             tapi.cache.TryGetEntryResponse,
                             timeout=10.0)[1]
        except trpc.RpcError:
            return None
        finally:
            chan.close()

    try:
        out = reply_beside_a_held_get(rig.uri, tmp_path / "bucket", key,
                                      value, read, token="user")
        assert len(out["reply_ms"]) == 2
        assert (tmp_path / "bucket").joinpath(key).is_file()
        assert rig.svc.l3.try_get(key) == value
    finally:
        rig.close()


def _shed(rig):
    rec = [rig.put("ytpu-cxx2-entry-shed"), rig.svc.drain_l3_for_testing(),
           rig.get("ytpu-cxx2-entry-shed"), rig.inspect()]
    return rec


def test_pending_cap_sheds(monkeypatch, tmp_path):
    rec = _assert_same(monkeypatch, tmp_path, _shed, l3=True,
                       l3_pending_cap=0)
    assert rec[-1]["l3"]["shed"] == 1 and rec[-1]["l3"]["writebacks"] == 0
    assert rec[2][0] == "ok"


def test_fleet_rpc_is_not_found_without_l3(monkeypatch, tmp_path):
    rec = _assert_same(monkeypatch, tmp_path, lambda rig: [
        rig.fetch(0, 0, method="FetchFleetBloomFilter"),
        rig.call("FetchFleetBloomFilter", token="bad")])
    assert rec[0] == ("err", tapi.cache.CACHE_STATUS_NOT_FOUND)


def _tenant_budget(rig):
    key_a = rig.p.keys.tenant_scoped_key("secret-a", "ytpu-cxx2-entry-1")
    key_b = rig.p.keys.tenant_scoped_key("secret-a", "ytpu-cxx2-entry-2")
    rec = [key_a, rig.put(key_a, b"12345678"), rig.put(key_a, b"1234"),
           rig.put(key_b, b"12345678"), rig.get(key_a), rig.inspect()]
    return rec


def test_tenant_over_its_bytes_budget_is_refused(monkeypatch, tmp_path):
    ns = tkeys.key_namespace(
        tkeys.tenant_scoped_key("secret-a", "ytpu-cxx2-entry-1"))
    assert ns and ns == jkeys.key_namespace(
        jkeys.tenant_scoped_key("secret-a", "ytpu-cxx2-entry-1"))
    want, got = [], []
    for name, out in (("jax", want), ("port", got)):
        monkeypatch.setattr(secrets, "randbits",
                            random.Random(SEED).getrandbits)
        root = tmp_path / name
        root.mkdir()
        rig = Rig(name, root,
                  tenant_bytes=PKGS[name].bud.CacheBytesLedger({ns: 10}))
        try:
            out.extend(_tenant_budget(rig))
        finally:
            rig.close()
    assert got == want
    assert got[3] == ("err", tapi.cache.CACHE_STATUS_NO_QUOTA)
    assert got[5]["stats_by_tenant"][ns]["rejected_fills"] == 1
    assert got[5]["tenant_bytes"]["usage_bytes"][ns] == 4


# -- engines: a directory either package filled ------------------------------


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_disk_dirs_read_back_whole(tmp_path, writer, reader):
    """Three weighted shards filled by one package read back through the
    other's engine with the misplaced-entry policy "delete": an entry
    the reader's ring placed elsewhere would be deleted at startup."""
    def shards(p):
        return [p.dc.ShardSpec(str(tmp_path / f"s{i}"), 1 << 24, weight=w)
                for i, w in enumerate((1, 2, 3))]
    rng = random.Random(7)
    items = {f"ytpu-cxx2-entry-{rng.getrandbits(256):064x}":
             rng.randbytes(rng.randint(1, 300)) for _ in range(120)}
    w = PKGS[writer].disk.DiskCacheEngine(shards(PKGS[writer]))
    for k, v in items.items():
        w.put(k, v)
    r = PKGS[reader].disk.DiskCacheEngine(shards(PKGS[reader]),
                                          on_misplaced="delete")
    assert sorted(r.keys()) == sorted(items)
    assert all(r.try_get(k) == v for k, v in items.items())
    assert r.stats() == w.stats()


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_objstore_dirs_read_back_whole(tmp_path, writer, reader):
    items = {f"ytpu-t-{i:016x}-{i * 7:064x}": bytes([i]) * (i + 1)
             for i in range(40)}
    items["odd key/with%chars"] = b"odd"
    w = PKGS[writer].obj.ObjectStoreEngine(
        PKGS[writer].obj.FsObjectStoreBackend(str(tmp_path)))
    for k, v in items.items():
        w.put(k, v)
    r = PKGS[reader].obj.ObjectStoreEngine(
        PKGS[reader].obj.FsObjectStoreBackend(str(tmp_path)))
    assert sorted(r.keys()) == sorted(items)
    assert all(r.try_get(k) == v and r.contains(k) for k, v in items.items())
    assert r.stats() == w.stats()


def test_engine_registries_agree():
    assert set(teng._REGISTRY) == set(jeng._REGISTRY)
    assert teng.make_engine("null").keys() == []
    with pytest.raises(ValueError):
        teng.make_engine("s3")   # no endpoint and no bucket


# -- compression -------------------------------------------------------------


def test_zstd_frames_equal_the_jax_package():
    payload = (5).to_bytes(4, "little") + bytes(100_000) + b"\x01" * 999
    assert tcomp.compress(payload) == jcomp.compress(payload)
    assert tcomp.decompress(jcomp.compress(payload)) == payload
    assert tcomp.try_decompress(b"garbage") is None


def test_zlib_fallback_equals_the_jax_fallback():
    """With `zstandard` blocked both packages fall back to the zlib
    frames; their frames are byte-equal and decode across packages."""
    script = textwrap.dedent(r"""
        import random, sys
        sys.modules["zstandard"] = None
        import yadcc_tpu.common.compress as j
        import yadcc_tpu_torch.common.compress as t
        assert j.zstandard is None and t.zstandard is None
        rng = random.Random(3)
        payloads = [b"", b"x", (77).to_bytes(4, "little") + bytes(1 << 20),
                    rng.randbytes(5000)]
        for p in payloads:
            assert t.compress(p) == j.compress(p), len(p)
            assert t.decompress(j.compress(p)) == p
            assert j.decompress(t.compress(p)) == p
        assert t.try_decompress(b"YZF1" + bytes(20)) is None
        assert t.try_decompress(j.compress(b"abc")[:-2]) is None
        big = j.compress(bytes(1000))
        try:
            t.decompress(big, max_output_size=10)
        except t.CompressionError:
            pass
        else:
            raise AssertionError("cap not enforced")
        print("ok")
    """)
    out = subprocess.run([sys.executable, "-c", script], cwd=REPO,
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "ok"


# -- the L1: TestArc's cases on both ARCs ----------------------------------


def _arc_basic(C):
    c = C(1000)
    c.put("a", b"x" * 100)
    assert c.try_get("a") == b"x" * 100
    assert c.try_get("b") is None
    assert c.total_bytes() == 100


def _arc_eviction_bounded(C):
    c = C(1000)
    for i in range(50):
        c.put(f"k{i}", b"y" * 100)
    assert c.total_bytes() <= 1000


def _arc_frequent_survive_scan(C):
    c = C(1000)
    for i in range(5):
        c.put(f"hot{i}", b"h" * 100)
    for _ in range(3):
        for i in range(5):
            assert c.try_get(f"hot{i}") is not None
    for i in range(100):
        c.put(f"cold{i}", b"c" * 100)
    assert sum(c.try_get(f"hot{i}") is not None for i in range(5)) >= 3


def _arc_update_in_place(C):
    c = C(1000)
    c.put("k", b"a" * 100)
    c.put("k", b"b" * 300)
    assert c.try_get("k") == b"b" * 300
    assert c.total_bytes() == 300


def _arc_oversized(C):
    c = C(100)
    c.put("big", b"z" * 1000)
    assert c.try_get("big") is None


def _arc_ghost_hit(C):
    c = C(300)
    for k, v in (("a", b"1"), ("b", b"2"), ("c", b"3"), ("d", b"4")):
        c.put(k, v * 100)
    c.put("a", b"1" * 100)
    stats = c.stats()
    assert stats["t1_bytes"] + stats["t2_bytes"] <= 300


def _arc_remove(C):
    c = C(1000)
    c.put("k", b"v")
    assert c.remove("k")
    assert c.try_get("k") is None
    assert not c.remove("k")


@pytest.mark.parametrize("pkg", ["jax", "port"])
@pytest.mark.parametrize("case", [
    _arc_basic, _arc_eviction_bounded, _arc_frequent_survive_scan,
    _arc_update_in_place, _arc_oversized, _arc_ghost_hit, _arc_remove],
    ids=lambda f: f.__name__.removeprefix("_arc_"))
def test_arc_cases(pkg, case):
    case(PKGS[pkg].arc.InMemoryCache)


def test_arc_state_equals_the_jax_arc():
    """A seeded run of puts, gets, removes and idle purges leaves both
    ARCs with the same stats and keys after every step."""
    rng = random.Random(11)
    clocks = [PKGS[n].Clock(0.0) for n in PKGS]
    caches = [PKGS[n].arc.InMemoryCache(4000, clock=clk)
              for n, clk in zip(PKGS, clocks)]
    for step in range(1500):
        op, key = rng.random(), f"k{rng.randint(0, 60)}"
        size = rng.randint(1, 700)
        dt = rng.random()
        got = []
        for c, clk in zip(caches, clocks):
            clk.advance(dt)
            if op < 0.5:
                got.append(c.put(key, bytes(size)))
            elif op < 0.9:
                got.append(c.try_get(key))
            elif op < 0.98:
                got.append(c.remove(key))
            else:
                got.append(c.purge(20.0))
            got.append((c.stats(), c.keys()))
        assert got[:2] == got[2:], step
