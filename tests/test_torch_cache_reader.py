"""The daemon's cache client across the wire: each package's reader and
writer against the other package's cache server on loopback, on both
front ends; the port reader's batch verdicts (device="cpu": the kernels'
plain versions) against the JAX reader's and the host filters; the port's
cache entry as a program.

The readers run on a virtual clock (their module's ``time`` replaced), so
an incremental sync needs no wall-clock wait.  The JAX reader's batch
path runs under ``jax.disable_jit()`` with ``use_device_cascade=False``
(its sharded cascade does not run op by op in reasonable time; the
port's cascade is held against it in tests/test_torch_bloom_cascade.py).
"""

from __future__ import annotations

import json
import random
import signal
import socket
import subprocess
import sys
import textwrap
import threading
import time
import types
import urllib.request
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import yadcc_tpu.cache.service as jsvc
import yadcc_tpu.daemon.cloud.distributed_cache_writer as jwriter
import yadcc_tpu.daemon.local.distributed_cache_reader as jreader
import yadcc_tpu.rpc as jrpc
from yadcc_tpu.cache.disk_engine import DiskCacheEngine as JDisk
from yadcc_tpu.cache.in_memory_cache import InMemoryCache as JArc
from yadcc_tpu.cache.object_store_engine import (
    FsObjectStoreBackend as JFs, ObjectStoreEngine as JObj)
from yadcc_tpu.common.disk_cache import ShardSpec as JShard
from yadcc_tpu.common.token_verifier import TokenVerifier as JTokens
from yadcc_tpu.utils.clock import VirtualClock as JClock
import yadcc_tpu_torch.cache.bloom_filter_generator as tgen
import yadcc_tpu_torch.cache.service as tsvc
import yadcc_tpu_torch.daemon.cloud.distributed_cache_writer as twriter
import yadcc_tpu_torch.daemon.local.distributed_cache_reader as treader
import yadcc_tpu_torch.ops.bloom_pipeline as tpipe
import yadcc_tpu_torch.rpc as trpc
from yadcc_tpu_torch.cache import entry as tentry
from yadcc_tpu_torch.cache.disk_engine import DiskCacheEngine as TDisk
from yadcc_tpu_torch.cache.in_memory_cache import InMemoryCache as TArc
from yadcc_tpu_torch.cache.object_store_engine import (
    FsObjectStoreBackend as TFs, ObjectStoreEngine as TObj)
from yadcc_tpu_torch.common import bloom as tbloom
from yadcc_tpu_torch.common.disk_cache import ShardSpec as TShard
from yadcc_tpu_torch.common.token_verifier import TokenVerifier as TTokens
from yadcc_tpu_torch.tenancy.keys import tenant_scoped_key
from yadcc_tpu_torch.utils.clock import VirtualClock as TClock

REPO = Path(__file__).resolve().parent.parent

SERVERS = {
    "jax": (jsvc.CacheService, JArc, JDisk, JShard, JObj, JFs, JTokens,
            JClock, jrpc),
    "port": (tsvc.CacheService, TArc, TDisk, TShard, TObj, TFs, TTokens,
             TClock, trpc),
}
CLIENTS = {"jax": (jreader, jwriter), "port": (treader, twriter)}


def daemon_keys(n: int, seed: int) -> list:
    """The daemon's key shapes: ``ytpu-cxx2-entry-`` + 64 hex (80 bytes)
    and the tenant-scoped ``ytpu-t-<16>-<64>`` (88 bytes) of two
    tenants, a third each."""
    rng = random.Random(seed)
    out = []
    for i in range(n):
        plain = f"ytpu-cxx2-entry-{rng.getrandbits(256):064x}"
        out.append(plain if i % 3 == 0 else
                   tenant_scoped_key(f"tenant-{i % 3}", plain))
    assert {len(k) for k in out} == {80, 88}
    return out


class Server:
    """One package's cache service (disk L2, objstore L3) on a real front
    end on loopback, on a virtual clock."""

    def __init__(self, pkg, frontend, root: Path):
        Svc, Arc, Disk, Shard, Obj, Fs, Tokens, Clock, rpc = SERVERS[pkg]
        self.clock = Clock(5000.0)
        self.svc = Svc(Arc(1 << 22), Disk([Shard(str(root / "l2"), 1 << 26)]),
                       l3=Obj(Fs(str(root / "l3")), resync_interval_s=0.0),
                       user_tokens=Tokens(["user"]),
                       servant_tokens=Tokens(["servant"]), clock=self.clock)
        self.server = rpc.make_rpc_server(frontend, "127.0.0.1:0",
                                          max_workers=4)
        self.server.add_service(self.svc.spec())
        self.server.start()
        scheme = "aio" if frontend == "aio" else "grpc"
        self.uri = f"{scheme}://127.0.0.1:{self.server.port}"

    def close(self):
        self.server.stop()
        self.svc.stop()


@pytest.fixture
def reader_clock(monkeypatch):
    """Both reader modules read a virtual monotonic clock."""
    clock = TClock(1000.0)
    fake = types.SimpleNamespace(monotonic=clock.now)
    monkeypatch.setattr(treader, "time", fake)
    monkeypatch.setattr(jreader, "time", fake)
    return clock


def _make_reader(client, uri, **kw):
    mod = CLIENTS[client][0]
    if client == "port":
        kw.setdefault("device", "cpu")
    return mod.DistributedCacheReader(uri, "user", **kw)


def _fill(client, uri, keys, value=lambda k: k.encode()[::-1]):
    w = CLIENTS[client][1].DistributedCacheWriter(uri, lambda: "servant")
    for k in keys:
        w._write(k, value(k))       # the synchronous body of async_write
    w._chan().close()


# Each package's client against the other's server; the port's client
# against the port's server too, on both front ends.
@pytest.mark.parametrize("server,client", [("jax", "port"), ("port", "jax"),
                                           ("port", "port")])
@pytest.mark.parametrize("frontend", ["threaded", "aio"])
def test_reader_syncs_full_then_incremental(tmp_path, reader_clock, server,
                                            client, frontend):
    srv = Server(server, frontend, tmp_path)
    try:
        keys = daemon_keys(60, seed=1)
        _fill(client, srv.uri, keys[:40])
        assert srv.svc.drain_l3_for_testing()
        reader = _make_reader(client, srv.uri)
        reader.sync_once()
        flt, fleet = reader._filter, reader._fleet_filter
        gen, fgen = srv.svc.bloom, srv.svc.bloom_l3
        assert flt.to_bytes() == gen.filter_bytes()
        assert fleet.to_bytes() == fgen.filter_bytes()
        assert (reader._salt, reader._fleet_salt) == (gen.salt, fgen.salt)
        assert flt.may_contain_batch(keys[:40]).all()
        # More fills, 30 s later on both clocks: the next sync is
        # incremental (the same replica objects, ORed in place).
        _fill(client, srv.uri, keys[40:])
        assert srv.svc.drain_l3_for_testing()
        reader_clock.advance(30)
        srv.clock.advance(30)
        reader.sync_once()
        assert reader._filter is flt and reader._fleet_filter is fleet
        assert flt.to_bytes() == gen.filter_bytes()
        assert fleet.to_bytes() == fgen.filter_bytes()
        got = reader.try_read(keys[45])
        assert bytes(got) == keys[45].encode()[::-1]
        if client == "port":
            assert reader.batch_may_contain(keys).all()
        reader.stop()
        if reader._channel is not None:
            reader._channel.close()
    finally:
        srv.close()


@pytest.fixture(scope="module")
def synced(tmp_path_factory):
    """A port server on loopback (threaded) with 150 keys in its region and
    fleet filters and 70 only in L3 (a peer region's uploads), and one
    reader of each package synced from it."""
    root = tmp_path_factory.mktemp("synced")
    srv = Server("port", "threaded", root)
    keys = daemon_keys(512, seed=2)
    _fill("port", srv.uri, keys[:150])
    assert srv.svc.drain_l3_for_testing()
    for k in keys[150:220]:
        srv.svc.l3.put(k, b"peer")
    srv.svc.rebuild_bloom_filter()          # the 60 s timer's body
    readers = {c: _make_reader(c, srv.uri, use_device_cascade=False)
               for c in CLIENTS}
    readers["cascade"] = _make_reader("port", srv.uri)
    for r in readers.values():
        r.sync_once()
    yield srv, keys, readers
    srv.close()


def test_batch_verdicts_equal_the_jax_reader_and_the_host(synced):
    srv, keys, readers = synced
    want = (readers["port"]._filter.may_contain_batch(keys)
            | readers["port"]._fleet_filter.may_contain_batch(keys))
    assert want[:220].all() and not want[220:].all()
    np.testing.assert_array_equal(readers["cascade"].batch_may_contain(keys),
                                  want)
    np.testing.assert_array_equal(readers["port"].batch_may_contain(keys),
                                  want)
    with jax.disable_jit():
        got = readers["jax"].batch_may_contain(keys)
    np.testing.assert_array_equal(np.asarray(got), want)
    # The region filter alone rejects the L3-only keys the fleet holds.
    assert not readers["port"]._filter.may_contain_batch(keys[150:220]).any()


def test_incrementally_synced_key_reads_true(synced, monkeypatch):
    srv, keys, readers = synced
    clock = TClock(1000.0)
    monkeypatch.setattr(treader, "time",
                        types.SimpleNamespace(monotonic=clock.now))
    reader = _make_reader("port", srv.uri)
    reader.sync_once()
    new = daemon_keys(6, seed=3)
    assert not reader.batch_may_contain(new).any()
    flt = reader._filter
    _fill("port", srv.uri, new)
    clock.advance(30)
    srv.clock.advance(30)
    reader.sync_once()
    assert reader._filter is flt                  # incremental, in place
    assert reader.batch_may_contain(new).all()
    assert reader.batch_may_contain(new[:1] + keys[220:]).tolist()[0]


def test_membership_path_taken_on_geometry_mismatch_or_cascade_off(
        synced, monkeypatch):
    srv, keys, readers = synced
    calls = {"cascade": 0, "membership": 0}
    # The reader imports the card classes at its first batch, so they
    # are patched where they live.
    real_cascade = tgen.DeviceBloomCascade.may_contain_batch
    real_member = tpipe.bloom_membership_batch

    def cascade(self, *a, **kw):
        calls["cascade"] += 1
        return real_cascade(self, *a, **kw)

    def member(*a, **kw):
        calls["membership"] += 1
        return real_member(*a, **kw)

    monkeypatch.setattr(tgen.DeviceBloomCascade, "may_contain_batch",
                        cascade)
    monkeypatch.setattr(tpipe, "bloom_membership_batch", member)
    batch = keys[100:300]
    region = readers["cascade"]._filter
    fleet = readers["cascade"]._fleet_filter
    want = region.may_contain_batch(batch) | fleet.may_contain_batch(batch)
    np.testing.assert_array_equal(
        readers["cascade"].batch_may_contain(batch), want)
    assert calls == {"cascade": 1, "membership": 0}
    np.testing.assert_array_equal(readers["port"].batch_may_contain(batch),
                                  want)
    assert calls == {"cascade": 1, "membership": 2}
    # A fleet filter of another geometry: two membership calls, host OR.
    odd = tbloom.SaltedBloomFilter(num_bits=999_983, num_hashes=7, salt=9)
    odd.add_many(batch[::2])
    mixed = _make_reader("port", srv.uri)
    mixed._filter, mixed._salt = region, region.salt
    mixed._fleet_filter, mixed._fleet_salt = odd, odd.salt
    np.testing.assert_array_equal(
        mixed.batch_may_contain(batch),
        region.may_contain_batch(batch) | odd.may_contain_batch(batch))
    assert calls == {"cascade": 1, "membership": 4}


def test_before_the_first_sync_every_key_may_be_held():
    reader = _make_reader("port", "grpc://127.0.0.1:1")
    assert reader.batch_may_contain(daemon_keys(5, seed=4)).all()
    assert reader.batch_may_contain([]).shape == (0,)


def test_reader_defaults_to_the_card_and_raises_without_one():
    """The batch runs on the card by default: without one the first
    batch_may_contain raises (construction does not: try_read and the
    syncs need no card)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    reader = treader.DistributedCacheReader("grpc://127.0.0.1:1", "user")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        reader.batch_may_contain(["k"])


def test_reader_constructs_syncs_and_reads_without_torch(tmp_path):
    """A daemon that checks the cache one key at a time needs no torch:
    with torch blocked, the port's reader constructs, full-syncs from a
    port cache server, try_reads a hit and a Bloom-rejected miss, and
    only its first batch raises."""
    script = textwrap.dedent(r"""
        import sys
        sys.modules["torch"] = None
        from yadcc_tpu_torch import rpc
        from yadcc_tpu_torch.cache.disk_engine import DiskCacheEngine
        from yadcc_tpu_torch.cache.in_memory_cache import InMemoryCache
        from yadcc_tpu_torch.cache.service import CacheService
        from yadcc_tpu_torch.common.disk_cache import ShardSpec
        from yadcc_tpu_torch.common.token_verifier import TokenVerifier
        from yadcc_tpu_torch.daemon.cloud.distributed_cache_writer import             DistributedCacheWriter
        from yadcc_tpu_torch.daemon.local.distributed_cache_reader import             DistributedCacheReader

        svc = CacheService(InMemoryCache(1 << 20),
                           DiskCacheEngine([ShardSpec(TMP, 1 << 24)]),
                           user_tokens=TokenVerifier({"user"}),
                           servant_tokens=TokenVerifier({"servant"}))
        rpc.register_mock_server("cache", svc.spec())
        writer = DistributedCacheWriter("mock://cache", lambda: "servant")
        writer._write("ytpu-cxx2-entry-" + "a" * 64, b"value")
        reader = DistributedCacheReader("mock://cache", "user")
        reader.sync_once()
        assert reader.inspect()["synced"]
        assert reader.try_read("ytpu-cxx2-entry-" + "a" * 64) == b"value"
        assert reader.try_read("ytpu-cxx2-entry-" + "b" * 64) is None
        assert reader.inspect()["bloom_rejects"] == 1
        try:
            reader.batch_may_contain(["k"])
        except ImportError:
            pass
        else:
            raise AssertionError("a batch ran without torch")
        svc.stop()
        print("ok")
    """)
    out = subprocess.run(
        [sys.executable, "-c",
         f"TMP = {str(tmp_path)!r}\n" + script],
        cwd=REPO, capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("ok")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _entry_args(tmp_path, frontend):
    return ["--port", str(_free_port()), "--inspect-port",
            str(_free_port()), "--cache-engine", "disk", "--cache-dirs",
            f"{tmp_path}/l2a,{tmp_path}/l2b", "--l3-engine", "objstore",
            "--l3-root", str(tmp_path / "l3"),
            "--acceptable-user-tokens", "user",
            "--acceptable-servant-tokens", "servant",
            "--rpc-frontend", frontend]


def _drive_entry(uri, inspect_port, alive):
    """Wait for the entry, fill it through a writer, read it through a
    reader; returns the entry's /inspect/vars cache counters."""
    reader = treader.DistributedCacheReader(uri, "user", device="cpu")
    deadline = time.monotonic() + 60
    while True:
        assert alive(), "cache entry exited at boot"
        reader.sync_once()
        if reader._filter is not None:
            break
        assert time.monotonic() < deadline, "cache entry boot timed out"
        time.sleep(0.1)
    keys = daemon_keys(9, seed=5)
    _fill("port", uri, keys)
    reader._last_full_fetch = 0.0        # the next sync fetches in full
    reader.sync_once()
    assert reader.batch_may_contain(keys).all()
    assert bytes(reader.try_read(keys[0])) == keys[0].encode()[::-1]
    reader._channel.close()
    with urllib.request.urlopen(
            f"http://127.0.0.1:{inspect_port}/inspect/vars", timeout=10) as f:
        return json.load(f)["yadcc"]["cache"]


def test_entry_serves_and_stops_on_sigterm(tmp_path):
    args = _entry_args(tmp_path, "threaded")
    proc = subprocess.Popen(
        [sys.executable, "-m", "yadcc_tpu_torch.cache.entry", *args],
        cwd=REPO, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
    try:
        ins = _drive_entry(f"grpc://127.0.0.1:{args[1]}", args[3],
                           lambda: proc.poll() is None)
        assert ins["fills"] == 9 and ins["l2"]["engine"] == "disk"
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
        proc.stderr.close()


def test_entry_on_aio_with_two_accept_loops(tmp_path):
    args = tentry.build_arg_parser().parse_args(
        _entry_args(tmp_path, "aio") + ["--accept-loops", "2"])
    stop = threading.Event()
    t = threading.Thread(target=tentry.cache_server_start, args=(args, stop))
    t.start()
    try:
        ins = _drive_entry(f"aio://127.0.0.1:{args.port}", args.inspect_port,
                           t.is_alive)
        assert ins["fills"] == 9
    finally:
        stop.set()
        t.join(timeout=30)
    assert not t.is_alive()
