"""The port's S3 backend (yadcc_tpu_torch/cache/s3_backend.py) against the
JAX package's: the SigV4 signer byte for byte, the backend against the
in-process fake (tests/fake_s3.py verifies every request's signature
with the JAX signer, so each call is a parity check too), and the port's
cache entry serving on S3 engines as a program that loads no torch."""

from __future__ import annotations

import datetime
import os
import pathlib
import signal
import socket
import subprocess
import sys
import time

import pytest

from yadcc_tpu.cache import s3_backend as jax_s3
from yadcc_tpu_torch.cache import s3_backend as port_s3
from yadcc_tpu_torch.cache.cache_engine import make_engine
from yadcc_tpu_torch.cache.object_store_engine import ObjectStoreEngine

from .fake_s3 import FakeS3Server

REPO = pathlib.Path(__file__).resolve().parent.parent
BUCKET = "ytpu-test"
AK, SK = "AKIDEXAMPLE", "wJalrXUtnFEMI/K7MDENG+bPxRfiCYEXAMPLEKEY"
NOW = datetime.datetime(2026, 3, 14, 1, 59, 26,
                        tzinfo=datetime.timezone.utc)

# (endpoint, region, method, uri, query, body) for the signer's parity.
SIGNER_CASES = [
    ("127.0.0.1:9000", "us-east-1", "GET", "/ytpu-test/cache/k1", [], b""),
    ("s3.example.com", "eu-west-3", "PUT",
     "/ytpu-test/cache/yadcc-cxx2-entry-abc/def%20with%20space%2Bplus",
     [], b"\x00\x01binary\xff"),
    ("minio:9000", "us-east-1", "GET", "/ytpu-test",
     [("list-type", "2"), ("prefix", "cache/"),
      ("continuation-token", "3")], b""),
    ("127.0.0.1:1", "ap-south-1", "DELETE", "/b/p/%C3%A9t%C3%A9",
     [("x", "a b&c=d")], b""),
]


@pytest.mark.parametrize("case", range(len(SIGNER_CASES)))
def test_sigv4_headers_equal_the_jax_signer(case):
    endpoint, region, method, uri, query, body = SIGNER_CASES[case]
    sha = port_s3.hashlib.sha256(body).hexdigest()
    got = port_s3.sigv4_headers(
        port_s3.S3Config(endpoint=endpoint, bucket=BUCKET, access_key=AK,
                         secret_key=SK, region=region),
        method, uri, query, sha, now=NOW)
    want = jax_s3.sigv4_headers(
        jax_s3.S3Config(endpoint=endpoint, bucket=BUCKET, access_key=AK,
                        secret_key=SK, region=region),
        method, uri, query, sha, now=NOW)
    assert got == want
    assert got["Authorization"].startswith(
        f"AWS4-HMAC-SHA256 Credential={AK}/20260314/{region}/s3/")


@pytest.fixture(scope="module")
def _fake():
    s = FakeS3Server(BUCKET, AK, SK).start()
    yield s
    s.stop()   # half a second: the HTTP server's shutdown poll


@pytest.fixture
def server(_fake):
    """The module's fake, emptied for each test."""
    with _fake.lock:
        _fake.objects.clear()
        _fake.fail_remaining = 0
        _fake.requests_seen = 0
        _fake.max_keys = 1000
    return _fake


def backend(server, prefix="cache/", retries=3, secret=SK):
    return port_s3.S3ObjectStoreBackend(port_s3.S3Config(
        endpoint=f"127.0.0.1:{server.port}", bucket=BUCKET,
        access_key=AK, secret_key=secret, prefix=prefix, retries=retries))


def test_put_get_delete_and_unusual_keys(server):
    b = backend(server)
    assert b.get("k1") is None
    b.put("k1", b"\x00\x01binary\xff")
    assert b.get("k1") == b"\x00\x01binary\xff"
    assert server.stored() == [("cache/k1", 9)]
    b.delete("k1")
    assert b.get("k1") is None
    b.delete("k1")  # idempotent
    key = "yadcc-cxx2-entry-abc/def with space+plus%percent"
    b.put(key, b"payload")
    assert b.get(key) == b"payload"
    assert (key, 7) in b.list_objects()


def test_list_pagination_and_foreign_prefixes(server):
    server.max_keys = 3  # force continuation tokens
    b = backend(server)
    names = [f"obj{i:02d}" for i in range(10)]
    for n in names:
        b.put(n, b"x" * len(n))
    assert sorted(b.list_objects()) == [(n, len(n)) for n in names]
    backend(server, prefix="elsewhere/").put("foreign", b"f")
    assert sorted(n for n, _ in b.list_objects()) == names


def test_5xx_is_retried_and_4xx_raised_at_once(server, monkeypatch):
    monkeypatch.setattr(port_s3.time, "sleep", lambda s: None)
    b = backend(server)
    server.fail_next(2)
    b.put("k", b"v")          # 2 failures + 1 success
    assert server.requests_seen == 3
    server.fail_next(1)
    assert b.get("k") == b"v"
    server.fail_next(10)
    with pytest.raises(port_s3.S3Error) as ei:
        backend(server, retries=1).get("k")
    assert ei.value.status == 500
    server.fail_next(0)   # the faults left over
    before = server.requests_seen
    with pytest.raises(port_s3.S3Error) as ei:
        backend(server, secret="wrong").put("k", b"v")
    assert ei.value.status == 403
    # 4xx must not burn the retry budget (one wire request only).
    assert server.requests_seen - before == 1


def test_engine_over_s3_and_its_registration(server):
    eng = make_engine("s3", endpoint=f"127.0.0.1:{server.port}",
                      bucket=BUCKET, access_key=AK, secret_key=SK,
                      prefix="p/", capacity=1 << 20)
    assert eng.name == "s3" and isinstance(eng, ObjectStoreEngine)
    eng.put("key-a", b"value-a")
    eng.put("key-b", b"value-b")
    assert eng.try_get("key-a") == b"value-a"
    eng.remove("key-a")
    assert eng.keys() == ["key-b"]
    # A restart recovers the keys from one listing.
    assert make_engine("s3", endpoint=f"127.0.0.1:{server.port}",
                       bucket=BUCKET, access_key=AK, secret_key=SK,
                       prefix="p/").keys() == ["key-b"]
    with pytest.raises(ValueError):
        make_engine("s3", endpoint="", bucket="")


def _free_ports(n):
    socks = [socket.socket() for _ in range(n)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


def test_cache_entry_serves_on_s3_and_loads_no_torch(server, tmp_path):
    """`python -m yadcc_tpu_torch.cache.entry --cache-engine s3
    --l3-engine s3` against the fake: a servant's put lands in the L2
    prefix and is written back under the L3 prefix, a user's get reads it
    back, and the process maps no libtorch."""
    import yadcc_tpu_torch.api as tapi
    import yadcc_tpu_torch.rpc as trpc

    port, iport = _free_ports(2)
    env = dict(os.environ, YTPU_S3_ACCESS_KEY=AK, YTPU_S3_SECRET_KEY=SK,
               PYTHONPATH=str(REPO))
    proc = subprocess.Popen(
        [sys.executable, "-m", "yadcc_tpu_torch.cache.entry",
         "--port", str(port), "--inspect-port", str(iport),
         "--cache-engine", "s3", "--l3-engine", "s3",
         "--s3-endpoint", f"127.0.0.1:{server.port}",
         "--s3-bucket", BUCKET, "--acceptable-user-tokens", "user",
         "--acceptable-servant-tokens", "servant"],
        cwd=tmp_path, env=env, stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE)
    chan = None
    key = "ytpu-cxx2-entry-" + "cd" * 32
    value = bytes(range(256)) * 40
    try:
        # Dial once the port listens: a channel that dials too early
        # backs off for seconds before it retries.
        deadline = time.monotonic() + 30
        while True:
            assert proc.poll() is None, proc.stderr.read().decode()[-2000:]
            assert time.monotonic() < deadline, "the entry never came up"
            try:
                socket.create_connection(("127.0.0.1", port), 1).close()
                break
            except OSError:
                time.sleep(0.05)
        chan = trpc.Channel(f"grpc://127.0.0.1:{port}")
        chan.call("ytpu.CacheService", "PutEntry",
                  tapi.cache.PutEntryRequest(token="servant", key=key),
                  tapi.cache.PutEntryResponse, attachment=value,
                  timeout=10.0)
        _, got = chan.call("ytpu.CacheService", "TryGetEntry",
                           tapi.cache.TryGetEntryRequest(token="user",
                                                         key=key),
                           tapi.cache.TryGetEntryResponse, timeout=5.0)
        assert bytes(got) == value
        deadline = time.monotonic() + 20
        while time.monotonic() < deadline:
            stored = dict(server.stored())
            if any(k.startswith("ytpu-l3/") for k in stored):
                break
            time.sleep(0.05)
        prefixes = sorted(k.split("/")[0] for k in stored)
        assert prefixes == ["ytpu-cache", "ytpu-l3"], stored
        assert all(size > len(value) for size in stored.values())
        with open(f"/proc/{proc.pid}/maps") as f:
            assert "libtorch" not in f.read()
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
    finally:
        if chan is not None:
            chan.close()
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        proc.stderr.close()
