"""The servant's helpers held against the JAX package's: the same inputs,
made from a numpy seed, through both packages' task digest, cache key,
cache-entry format, keyed packing, multi-chunk framing, cacheability
scan, capacity policy, patch-location scan, attachment cap, wait clamp,
compiler registry and C++ task intake; bytes and verdicts must be equal.
The port's fused decompress-and-digest is held against a one-shot
decompress plus ``digest_bytes`` on zstd and, in a subprocess without
the zstd wheel, on the zlib frames."""

from __future__ import annotations

import os
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from yadcc_tpu.common import limits as jlimits
from yadcc_tpu.common import multi_chunk as jchunk
from yadcc_tpu.common.cacheability import \
    scan_source_cacheability as jscan
from yadcc_tpu.daemon import cache_format as jformat
from yadcc_tpu.daemon import packing as jpacking
from yadcc_tpu.daemon import task_digest as jdigest
from yadcc_tpu.daemon.cloud import cxx_task as jcxx
from yadcc_tpu.daemon.cloud.compiler_registry import \
    CompilerRegistry as JRegistry
from yadcc_tpu.daemon.cloud.execution_engine import \
    decide_capacity as jcapacity
from yadcc_tpu_torch.common import compress as tcompress
from yadcc_tpu_torch.common import limits as tlimits
from yadcc_tpu_torch.common import multi_chunk as tchunk
from yadcc_tpu_torch.common.cacheability import \
    scan_source_cacheability as tscan
from yadcc_tpu_torch.common.hashing import digest_bytes
from yadcc_tpu_torch.daemon import cache_format as tformat
from yadcc_tpu_torch.daemon import packing as tpacking
from yadcc_tpu_torch.daemon import task_digest as tdigest
from yadcc_tpu_torch.daemon.cloud import cxx_task as tcxx
from yadcc_tpu_torch.daemon.cloud.compiler_registry import \
    CompilerRegistry as TRegistry
from yadcc_tpu_torch.daemon.cloud.execution_engine import \
    decide_capacity as tcapacity

REPO = pathlib.Path(__file__).resolve().parent.parent
TESTDATA = REPO / "tests" / "testdata"
SEEDS = (0, 1, 2, 3)


def _blob(rng, lo=0, hi=64) -> bytes:
    return rng.integers(0, 256, int(rng.integers(lo, hi)),
                        dtype=np.uint8).tobytes()


def _hex(rng) -> str:
    return _blob(rng, 32, 33).hex()


def _args(rng) -> str:
    flags = ["-O2", "-O0 -g", "-O2 -g", "-DX=1", "-D__TIME__=0", "-Wall",
             "-fPIC", "-std=c++17"]
    return " ".join(rng.choice(flags, int(rng.integers(0, 4))))


def _entry(mod, rng):
    files = {ext: _blob(rng, 0, 200) for ext in
             rng.choice([".o", ".gcno", ".su", ".dwo"],
                        int(rng.integers(0, 4)), replace=False)}
    patches = {ext: [(int(rng.integers(0, 1000)), 224, _blob(rng, 0, 12))
                     for _ in range(int(rng.integers(0, 3)))]
               for ext in files}
    return mod.CacheEntry(
        exit_code=int(rng.integers(-2, 3)), standard_output=_blob(rng),
        standard_error=_blob(rng), files=files,
        patches={k: v for k, v in patches.items() if v})


@pytest.mark.parametrize("seed", SEEDS)
def test_digests_and_cache_keys_equal(seed):
    rng = np.random.default_rng(seed)
    for _ in range(20):
        cd, args, sd = _hex(rng), _args(rng), _hex(rng)
        tenant = "" if rng.random() < 0.5 else f"tenant-{rng.integers(9)}"
        assert tdigest.get_cxx_task_digest(cd, args, sd) == \
            jdigest.get_cxx_task_digest(cd, args, sd)
        assert tformat.get_cache_key(cd, args, sd, tenant) == \
            jformat.get_cache_key(cd, args, sd, tenant)


@pytest.mark.parametrize("seed", SEEDS)
def test_cache_entries_equal_and_cross_parse(seed):
    rng = np.random.default_rng(seed)
    for _ in range(10):
        state = rng.bit_generator.state
        te = _entry(tformat, rng)
        rng.bit_generator.state = state
        je = _entry(jformat, rng)
        tdata = tformat.write_cache_entry(te)
        assert tdata == jformat.write_cache_entry(je)
        for parse in (tformat.try_parse_cache_entry,
                      jformat.try_parse_cache_entry):
            got = parse(tdata)
            assert got is not None
            assert (got.exit_code, got.standard_output, got.standard_error,
                    got.patches) == (te.exit_code, te.standard_output,
                                     te.standard_error, te.patches)
            assert {k: bytes(v) for k, v in got.files.items()} == te.files
        # Any flipped byte is a miss in both packages.
        bad = bytearray(tdata)
        bad[int(rng.integers(len(bad)))] ^= 0x5A
        assert tformat.try_parse_cache_entry(bytes(bad)) is \
            jformat.try_parse_cache_entry(bytes(bad)) is None
    assert tformat.try_parse_cache_entry(b"") is None


@pytest.mark.parametrize("seed", SEEDS)
def test_keyed_packing_and_multi_chunk_equal(seed):
    rng = np.random.default_rng(seed)
    for _ in range(10):
        bufs = {f"k{i}{_blob(rng, 0, 4).hex()}": _blob(rng, 0, 100)
                for i in range(int(rng.integers(0, 5)))}
        packed = tpacking.pack_keyed_buffers(bufs)
        assert packed == jpacking.pack_keyed_buffers(bufs)
        assert tpacking.try_unpack_keyed_buffers(packed) == \
            jpacking.try_unpack_keyed_buffers(packed) == bufs
        chunks = [_blob(rng, 0, 50) for _ in range(int(rng.integers(0, 6)))]
        framed = tchunk.make_multi_chunk(chunks)
        assert framed == jchunk.make_multi_chunk(chunks)
        assert tchunk.try_parse_multi_chunk(framed) == chunks
        for junk in (framed[:-1] if framed[:-1] else b"x", b"junk",
                     b"1,-1\r\nx", b"3\r\nab", _blob(rng, 1, 30)):
            assert tchunk.try_parse_multi_chunk(junk) == \
                jchunk.try_parse_multi_chunk(junk)
            assert tpacking.try_unpack_keyed_buffers(junk) == \
                jpacking.try_unpack_keyed_buffers(junk)


@pytest.mark.parametrize("seed", SEEDS)
def test_cacheability_and_patch_scan_equal(seed):
    rng = np.random.default_rng(seed)
    macros = [b"__TIME__", b"__DATE__", b"__TIMESTAMP__", b"int x;"]
    for _ in range(20):
        src = b" ".join(rng.choice(macros, int(rng.integers(0, 4))))
        args = _args(rng) + " " + " ".join(
            f"-D{m.decode()}=0" for m in macros[:3] if rng.random() < 0.3)
        assert tscan(src, args) == jscan(src, args)
        ws = b"/dev/shm/ytpu_cxx_" + _blob(rng, 4, 5).hex().encode() + \
            b"p" * int(rng.integers(0, 40))
        parts = []
        for _ in range(int(rng.integers(0, 5))):
            parts += [_blob(rng, 0, 20).replace(b"\x00", b""), ws,
                      rng.choice([b"/src.ii", b"", b"/output.o"])]
            if rng.random() < 0.8:
                parts.append(b"\x00")
        data = b"".join(parts)
        assert tcxx.find_patch_locations(data, ws) == \
            jcxx.find_patch_locations(data, ws)


@pytest.mark.parametrize("seed", SEEDS)
def test_capacity_attachment_cap_and_wait_clamp_equal(seed):
    rng = np.random.default_rng(seed)
    for _ in range(30):
        nprocs = int(rng.integers(1, 200))
        kw = dict(allow_poor_machine=bool(rng.random() < 0.5),
                  cgroup_present=bool(rng.random() < 0.3))
        dedicated = bool(rng.random() < 0.5)
        assert tcapacity(nprocs, dedicated, **kw) == \
            jcapacity(nprocs, dedicated, **kw)
        ms = rng.choice([-5, 0, 1, 999, 10_000, 61_000, 1e12, float("nan"),
                         "x", None, int(rng.integers(0, 100_000))])
        cap = float(rng.choice([10.0, 60.0]))
        assert tlimits.clamp_wait_s(ms, cap) == jlimits.clamp_wait_s(ms, cap)
        n, limit = int(rng.integers(0, 64)), int(rng.integers(0, 64))
        data = b"x" * n
        if n > limit:
            for mod in (tlimits, jlimits):
                with pytest.raises(ValueError):
                    mod.checked_attachment(data, limit)
        else:
            assert tlimits.checked_attachment(data, limit) is data
            assert jlimits.checked_attachment(data, limit) is data


def test_compiler_registries_find_the_same_compilers(tmp_path, monkeypatch):
    """PATH, extra dirs and toolchain bundles; wrappers and broken
    symlinks skipped; digests of the binaries' bytes."""
    bundle = tmp_path / "bundles" / "gcc-99" / "bin"
    bundle.mkdir(parents=True)
    (bundle / "g++").write_bytes(b"#!/bin/sh\necho bundled\n")
    (bundle / "g++").chmod(0o755)
    extra = tmp_path / "extra"
    extra.mkdir()
    (extra / "clang++").write_bytes(b"#!/bin/sh\necho clang\n")
    (extra / "clang++").chmod(0o755)
    (extra / "ccache").symlink_to(TESTDATA / "toolchains" / "bin" / "g++")
    monkeypatch.setenv("PATH", str(TESTDATA / "toolchains" / "bin"))
    kw = dict(bundle_dirs=[str(tmp_path / "bundles")])
    t, j = TRegistry([str(extra)], **kw), JRegistry([str(extra)], **kw)
    assert t.environments() == j.environments()
    assert len(t.environments()) == 3
    for d in t.environments():
        assert t.try_get_compiler_path(d) == j.try_get_compiler_path(d)
    assert t.try_get_compiler_path("0" * 64) is None


@pytest.mark.parametrize("args,path", [("-O2", "/home/u/p/a.cc"),
                                       ("-g -DX", "/home/u/p/b.c"),
                                       ("-D__DATE__=1", "/x/Foo.C")])
def test_cxx_task_intake_equal(tmp_path, args, path):
    """prepare: the same digest, cacheability verdict, key, language and
    command line (up to the workspace), and a padded workspace."""
    rng = np.random.default_rng(len(args))
    src = _blob(rng, 100, 400) + b" __DATE__"
    tasks = []
    for mod in (tcxx, jcxx):
        task = mod.CloudCxxCompilationTask(
            compiler_path=str(TESTDATA / "fake-g++"), compiler_digest="cd",
            invocation_arguments=args, source_path=path,
            temp_root=str(tmp_path))
        task.prepare(mod.compress.compress(src))
        tasks.append(task)
    try:
        t, j = tasks
        assert len(t.workspace.path) == len(j.workspace.path) == \
            tcxx._PADDED_WORKSPACE_LEN
        assert (t.source, t.source_digest, t.cacheable, t.task_digest,
                t.cache_key) == (j.source, j.source_digest, j.cacheable,
                                 j.task_digest, j.cache_key)
        assert t.cmdline.replace(t.workspace.path, "WS") == \
            j.cmdline.replace(j.workspace.path, "WS")
        assert t.source_digest == digest_bytes(src)
    finally:
        for task in tasks:
            task.workspace.remove()
    bad = tcxx.CloudCxxCompilationTask(
        compiler_path="g++", compiler_digest="cd", invocation_arguments="",
        source_path="a.cc", temp_root=str(tmp_path))
    with pytest.raises(ValueError):
        bad.prepare(b"not a frame")
    assert not os.listdir(tmp_path)


@pytest.mark.parametrize("size", [0, 1, 1000, 3 << 20])
def test_decompress_and_digest_equals_one_shot_on_zstd(size):
    assert tcompress.zstandard is not None
    data = np.random.default_rng(size).integers(
        0, 8, size, dtype=np.uint8).tobytes()
    frame = tcompress.compress(data)
    out, digest = tcompress.decompress_and_digest(frame, chunk_size=4096)
    assert out == tcompress.decompress(frame) == data
    assert digest == digest_bytes(data)
    with pytest.raises(tcompress.CompressionError):
        tcompress.decompress_and_digest(frame[:-3] if size else b"xx")
    with pytest.raises(tcompress.CompressionError):
        tcompress.decompress_and_digest(frame, max_output_size=size - 1
                                        if size else -1)


def test_decompress_and_digest_on_zlib_frames_without_the_zstd_wheel():
    """The card's host has no zstd wheel: the fused intake runs on the
    zlib frames there, one-shot (YZF1) frames fed in pieces, and refuses
    a truncated frame and an over-cap declared size."""
    script = textwrap.dedent(r"""
        import sys, zlib
        sys.modules["zstandard"] = None
        from yadcc_tpu_torch.common import compress, _zlib_frames
        from yadcc_tpu_torch.common.hashing import digest_bytes
        assert compress.zstandard is None
        for size in (0, 1, 1000, 3 << 20):
            data = bytes(i * 7 % 251 for i in range(size))
            frame = compress.compress(data)
            assert frame[:4] == b"YZF1"
            for chunk in (1, 7, 4096, 1 << 20):
                out, d = compress.decompress_and_digest(frame,
                                                        chunk_size=chunk)
                assert out == compress.decompress(frame) == data
                assert d == digest_bytes(data)
            for cut in (len(frame) - 1, 12, 5, 2):
                try:
                    compress.decompress_and_digest(frame[:cut])
                except compress.CompressionError:
                    pass
                else:
                    raise AssertionError(f"truncated at {cut} accepted")
        hostile = b"YZF1" + (1 << 40).to_bytes(8, "little") + \
            zlib.compress(b"tiny")
        try:
            compress.decompress_and_digest(hostile)
        except compress.CompressionError as e:
            assert "exceeds cap" in str(e)
        else:
            raise AssertionError("over-cap declared size accepted")
        lying = b"YZF1" + (5).to_bytes(8, "little") + zlib.compress(b"four")
        try:
            compress.decompress_and_digest(lying)
        except compress.CompressionError:
            pass
        else:
            raise AssertionError("declared size mismatch accepted")
        stream = b"YZFS" + zlib.compress(b"streamed" * 100)
        assert compress.decompress_and_digest(stream)[0] == b"streamed" * 100
        print("ok")
    """)
    out = subprocess.run([sys.executable, "-c", script], cwd=REPO,
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip() == "ok"


def test_pack_pool_threads_end_with_the_servants_stop(tmp_path):
    """The non-daemon threads that tests/test_zz_hygiene.py's sentinel
    finds in a pytest worker after tests/test_daemon_cloud.py are the JAX
    package's pack pool's (``output-pack_0/1``): its collect_outputs
    starts them and no stop of that package joins them.  The port's
    servant stop does (``shutdown_pack_executor``, daemon/entry.py): after
    a collect that packs two outputs on the port's pool, it leaves no
    thread of the pool alive, while the JAX twin's threads stay until
    this test joins them."""
    from yadcc_tpu.daemon.cloud.execution_engine import \
        TaskOutput as JOutput
    from yadcc_tpu_torch.daemon.cloud.execution_engine import \
        TaskOutput as TOutput

    def join_jax_pool():
        pool, jcxx._PACK_EXECUTOR._pool = jcxx._PACK_EXECUTOR._pool, None
        if pool is not None:
            pool.shutdown(wait=True)

    # Fresh pools, started from this (non-daemon) thread as the JAX test
    # starts its: a pool thread inherits its starter's daemon flag.
    tcxx.shutdown_pack_executor()
    join_jax_pool()
    pools = {}
    try:
        for mod, output in ((jcxx, JOutput), (tcxx, TOutput)):
            task = mod.CloudCxxCompilationTask(
                compiler_path=str(TESTDATA / "fake-g++"),
                compiler_digest="cd", invocation_arguments="-O2",
                source_path="/home/user/proj/a.cc", temp_root=str(tmp_path))
            task.prepare(mod.compress.compress(b"int main() { return 0; }"))
            run = subprocess.run(["sh", "-c", task.cmdline],
                                 capture_output=True)
            assert run.returncode == 0, run.stderr
            files, _, _ = task.collect_outputs(
                output(0, run.stdout, run.stderr))
            assert set(files) == {".o", ".gcno"}
            pools[mod] = mod._PACK_EXECUTOR._pool
            threads = set(pools[mod]._threads)
            assert threads and all(
                t.name.startswith("output-pack") and not t.daemon
                for t in threads)
        tcxx.shutdown_pack_executor()
        assert not any(t.is_alive() for t in pools[tcxx]._threads)
        assert any(t.is_alive() for t in pools[jcxx]._threads)
    finally:
        tcxx.shutdown_pack_executor()
        join_jax_pool()
