"""The port's compiler-masquerading client held against the JAX package's.

Exact, since these are byte and decision outcomes: ``CompilerArgs``
parsing and rewriting, ``is_distributable``, ``remote_invocation`` (it
feeds the task digest and the cache key; the JAX one is held to the
native client by tests/test_native_client.py) and the quota class on
seeded argument lists; ``find_real_compiler`` on a PATH with a wrapper
farm and accelerator directories; ``rewrite_file`` with the host's g++
on seeded sources (digest, size, timestamp macros, the compressed and
decompressed bytes) and the client's streaming writers on both
compression backends.  Then end to end with a fake compiler that
preprocesses: the port's client through the port's rig on the threaded
and on the aio loopback HTTP, the JAX client through the port's daemon,
and the port's client through the JAX rig give the same objects, exit
codes and output, and the delegates count the same; a rebuild hits the
cache.  The port's client prints a failed preprocess's diagnostics once
(the JAX client three times).  Last, the host's g++ through a symlink
named ``g++`` to ``yadcc_cxx.py``, as a build runs it."""

from __future__ import annotations

import os
import random
import shutil
import subprocess
import time

import pytest

from yadcc_tpu.client import compiler_args as jargs
from yadcc_tpu.client import daemon_call as jcall
from yadcc_tpu.client import rewrite_file as jrewrite
from yadcc_tpu.client import task_quota as jquota
from yadcc_tpu.client import universal_wrapper as jwrapper
from yadcc_tpu.client import yadcc_cxx as jcxx
from yadcc_tpu.common import _zlib_frames as jzlib
from yadcc_tpu.common import compress as jcompress
from yadcc_tpu.common import hashing as jhashing
import yadcc_tpu.daemon.cloud.cxx_task as jcloud
from yadcc_tpu.testing import LocalCluster as JCluster
from yadcc_tpu_torch.client import compiler_args as targs
from yadcc_tpu_torch.client import daemon_call as tcall
from yadcc_tpu_torch.client import rewrite_file as trewrite
from yadcc_tpu_torch.client import task_quota as tquota
from yadcc_tpu_torch.client import universal_wrapper as twrapper
from yadcc_tpu_torch.client import yadcc_cxx as tcxx
from yadcc_tpu_torch.common import _zlib_frames as tzlib
from yadcc_tpu_torch.common import compress as tcompress
from yadcc_tpu_torch.common import hashing as thashing
import yadcc_tpu_torch.daemon.cloud.cxx_task as tcloud
from yadcc_tpu_torch.testing import LocalCluster as TCluster

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GXX = shutil.which("g++")

# A fake g++ that also preprocesses (-E: the source as it is); -DFAIL
# fails like a compile error, in the preprocessor too.
FAKE_GXX = """#!/bin/sh
out=""; src=""; prev=""; pre=0
for a in "$@"; do
  if [ "$prev" = "-o" ]; then out="$a"; fi
  if [ "$a" = "-DFAIL" ]; then echo "fake: error" >&2; exit 1; fi
  if [ "$a" = "-E" ]; then pre=1; fi
  case "$a" in -*) ;; *) if [ "$prev" != "-x" ] && [ "$prev" != "-o" ]; then src="$a"; fi;; esac
  prev="$a"
done
if [ $pre = 1 ]; then cat "$src"; exit 0; fi
{ echo "FAKEOBJ"; cat "$src"; } > "$out"
echo "fake: compiled"
"""

# ---------------------------------------------------------------------------
# Arguments.
# ---------------------------------------------------------------------------

_VALUE_OPTS = ["-o", "-x", "-include", "-imacros", "-isystem", "-iquote",
               "-I", "-D", "-U", "-MF", "-MT", "-MQ", "-Xlinker", "-l",
               "--param"]
_FLAGS = ["-c", "-E", "-S", "-O2", "-O0", "-g", "-Wall", "-MD", "-MMD",
          "-fPIC", "-march=native", "-mtune=native", "-fplugin=x.so",
          "-specs=y", "-std=c++17", "-Wp,-MD,dep.d", "-dumpversion",
          "-fdirectives-only", "-", "-Iinc", "-isystem/usr/x",
          "-o/tmp/j.o", "-DMSG='a b'", "-DX=\"$(y)\""]
_SOURCES = ["a.cc", "b.c", "dir/c.cpp", "d.C", "e.s", "f.S", "g.i", "h.ii",
            "i.cxx", "j.txt", "k.c++", "l.o", "m.h"]


def _argv(rng: random.Random) -> list:
    out = [rng.choice(["g++", "gcc", "/usr/bin/clang++"])]
    for _ in range(rng.randrange(0, 9)):
        kind = rng.random()
        if kind < 0.3:
            out += [rng.choice(_VALUE_OPTS),
                    rng.choice(["v", "out.o", "inc", "c++", "-", "x y"])]
        elif kind < 0.75:
            out.append(rng.choice(_FLAGS))
        else:
            out.append(rng.choice(_SOURCES))
    if rng.random() < 0.6:
        out += ["-c", rng.choice(_SOURCES[:4])]
    return out


def _args_view(mod, cxx, argv: list) -> tuple:
    a = mod.CompilerArgs.parse(argv)
    return (a.compiler, a.args, a.sources, a._parsed, a.output_file(),
            [a.try_get(o) for o in ("-o", "-x", "-I", "-MF")],
            [a.has(o) for o in ("-c", "-E", "-", "-g")],
            a.has_prefix("-W"),
            a.rewrite(remove=["-c"], remove_prefix=["-o"]),
            a.rewrite(remove=["-I", "-D"], remove_prefix=["-M"],
                      add=["-x", "c++"], keep_sources=False),
            mod.is_distributable(a),
            cxx.remote_invocation(a, True), cxx.remote_invocation(a, False),
            cxx._is_lightweight_task(a))


@pytest.mark.parametrize("seed", range(3))
def test_arguments_alike(seed):
    rng = random.Random(seed)
    n_dist = 0
    for _ in range(120):
        argv = _argv(rng)
        want = _args_view(jargs, jcxx, argv)
        assert _args_view(targs, tcxx, argv) == want, argv
        n_dist += want[10][0]
    assert n_dist > 5   # some of each kind
    assert n_dist < 115


def test_find_real_compiler_alike(tmp_path, monkeypatch):
    """The farm directory and any accelerator's directory are skipped in
    both packages; a PATH with nothing else resolves to nothing."""
    dirs = {}
    for name in ("farm", "ccache", "mytools", "later"):
        d = tmp_path / name
        d.mkdir()
        (d / "g++").write_text("#!/bin/sh\n")
        (d / "g++").chmod(0o755)
        dirs[name] = str(d)
    (tmp_path / "mytools" / "g++").chmod(0o644)   # not executable
    cases = [
        ({"PATH": os.pathsep.join(dirs[n] for n in
                                  ("farm", "ccache", "mytools", "later")),
          "YTPU_WRAPPER_DIR": dirs["farm"]}, "later"),
        ({"PATH": os.pathsep.join(dirs[n] for n in ("farm", "ccache")),
          "YTPU_WRAPPER_DIR": dirs["farm"]}, None),
        ({"PATH": dirs["farm"], "YTPU_WRAPPER_DIR": ""}, "farm"),
    ]
    for env, want in cases:
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        got = {name: mod.find_real_compiler("g++")
               for name, mod in (("jax", jcxx), ("port", tcxx))}
        assert got["port"] == got["jax"] == (
            None if want is None else os.path.join(dirs[want], "g++"))


def test_quota_without_a_daemon_and_the_wrapper_alike():
    """No daemon: no quota (acquire returns False at once).  The
    universal wrapper takes heavy quota around the real program and
    passes its exit code through."""
    got = {}
    for name, call, quota, wrapper in (("jax", jcall, jquota, jwrapper),
                                       ("port", tcall, tquota, twrapper)):
        seen = []

        def down(method, path, body):
            seen.append(path)
            return call.DaemonResponse(-1, b"")

        def up(method, path, body):
            seen.append((path, body.count(b'"lightweight_task": false')))
            return call.DaemonResponse(200, b"{}")

        call.set_daemon_call_handler(down)
        try:
            no_daemon = quota.acquire_task_quota(True)
            call.set_daemon_call_handler(up)
            rc = wrapper.entry(["sh", "-c", "exit 3"])
        finally:
            call.set_daemon_call_handler(None)
        got[name] = (no_daemon, rc, seen)
    assert got["port"] == got["jax"]
    assert got["jax"] == (False, 3, ["/local/acquire_quota",
                                     ("/local/acquire_quota", 1),
                                     ("/local/release_quota", 0)])


# ---------------------------------------------------------------------------
# Preprocessing and the writers.
# ---------------------------------------------------------------------------


def _source(rng: random.Random, i: int) -> str:
    lines = [f"int f{i}_{k}(int x) {{ return x * {rng.randrange(99)}; }}"
             for k in range(rng.randrange(5, 400))]
    if rng.random() < 0.5:
        lines.insert(0, "#include <stddef.h>")
    if rng.random() < 0.5:
        lines.append(f'const char *t{i} = {rng.choice(["__TIME__", "__DATE__", "__TIMESTAMP__"])};')
    if rng.random() < 0.3:
        lines.append("#define M(a) a + 1\nint m = M(2);")
    return "\n".join(lines) + "\n"


def _rewrite_file_alike(seed, tmp_path, monkeypatch, shim):
    """Both packages' rewrite_file on the same TUs with the same fakeroot
    shim (or none): each package looks for its own shim (the JAX
    package's in native/, the port's in _build/native/), so the test
    hands both the same one."""
    for rw in (jrewrite, trewrite):
        monkeypatch.setattr(rw, "_fakeroot_path", lambda: shim)
    monkeypatch.chdir(tmp_path)
    rng = random.Random(seed)
    for i in range(3):
        (tmp_path / f"s{i}.c").write_text(_source(rng, i))
        argv = ["gcc", "-O2", rng.choice(["-DQ=1", "-g", "-Wall"]), "-c",
                f"s{i}.c", "-o", f"s{i}.o"]
        got = {}
        for name, args_mod, rw in (("jax", jargs, jrewrite),
                                   ("port", targs, trewrite)):
            r = rw.rewrite_file(args_mod.CompilerArgs.parse(argv), GXX)
            raw = r.compressed_source.join()
            got[name] = (r.source_digest, r.uncompressed_size,
                         r.directives_only, r.timestamp_macros_found, raw,
                         tcompress.decompress(raw))
        assert got["port"] == got["jax"]
        assert thashing.digest_bytes(got["jax"][5]) == got["jax"][0]
        assert len(got["jax"][5]) == got["jax"][1]
    (tmp_path / "bad.c").write_text("int x;\n#error stop\n")
    argv = ["gcc", "-c", "bad.c", "-o", "bad.o"]
    assert trewrite.rewrite_file(targs.CompilerArgs.parse(argv), GXX) is None
    assert jrewrite.rewrite_file(jargs.CompilerArgs.parse(argv), GXX) is None


@pytest.mark.skipif(GXX is None, reason="no g++ on PATH")
@pytest.mark.parametrize("seed", range(3))
def test_rewrite_file_alike(seed, tmp_path, monkeypatch):
    _rewrite_file_alike(seed, tmp_path, monkeypatch, None)


@pytest.mark.skipif(GXX is None, reason="no g++ on PATH")
def test_rewrite_file_alike_with_the_shim(tmp_path, monkeypatch):
    """With the port's fakeroot shim preloaded in both packages (the
    installer builds it beside the native client): the headers under the
    compiler's root read /ytpu/compiler, the bytes still alike."""
    from yadcc_tpu_torch.tools import install_client

    try:
        out = install_client.build_native(("fakeroot",))
    except RuntimeError as e:
        pytest.skip(f"native toolchain unavailable: {str(e)[-400:]}")
    shim = str(out / "libytpufakeroot.so")
    assert trewrite._fakeroot_path() == shim
    _rewrite_file_alike(0, tmp_path, monkeypatch, shim)
    (tmp_path / "h.c").write_text("#include <stddef.h>\nint x;\n")
    argv = ["gcc", "-c", "h.c", "-o", "h.o"]
    r = trewrite.rewrite_file(targs.CompilerArgs.parse(argv), GXX)
    text = tcompress.decompress(r.compressed_source.join())
    assert b"/ytpu/compiler" in text


def _through_writers(compress_mod, hashing_mod, chunks) -> tuple:
    class Sink:
        def __init__(self):
            self.parts = []

        def write(self, data):
            self.parts.append(bytes(data))
            return len(data)

    sink, digester = Sink(), hashing_mod.DigestingWriter()
    zw = compress_mod.CompressingWriter(sink)
    tee = compress_mod.TeeWriter(digester, zw)
    for c in chunks:
        assert tee.write(c) == len(c)
    zw.close()
    zw.close()
    return b"".join(sink.parts), digester.hexdigest(), digester.bytes_written


@pytest.mark.parametrize("backend", ["zstd", "zlib"])
def test_writers_alike(backend, monkeypatch):
    """The same bytes from both packages' writers, on the zstd wheel and
    on the zlib stand-in the card's host runs (no zstandard there); the
    port decodes either with its fused decompress-and-digest."""
    if backend == "zlib":
        for mod, frames in ((tcompress, tzlib), (jcompress, jzlib)):
            monkeypatch.setattr(mod, "zstandard", None)
            monkeypatch.setattr(mod, "_fallback", frames, raising=False)
    rng = random.Random(7)
    chunks = [bytes(rng.randrange(256) for _ in range(rng.choice(
        [0, 1, 100, 70_000]))) + b"int x;\n" * rng.randrange(50)
        for _ in range(12)]
    got = {name: _through_writers(c, h, chunks)
           for name, c, h in (("jax", jcompress, jhashing),
                              ("port", tcompress, thashing))}
    assert got["port"] == got["jax"]
    data, digest = tcompress.decompress_and_digest(got["port"][0])
    assert data == b"".join(chunks) and digest == got["port"][1]


# ---------------------------------------------------------------------------
# End to end.
# ---------------------------------------------------------------------------


def _tus() -> list:
    """(file, flags); the last one fails in the preprocessor too."""
    return [(f"tu{i}.cc", flags) for i, flags in
            enumerate((["-O2"], ["-O0", "-g"], ["-O2", "-DFAIL"]))]


@pytest.fixture(scope="module")
def rigs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("client")
    # Not under a `bin/`: the hygiene sentinel looks for `/bin/g++ ...
    # output.o` processes, host-wide.
    fake = tmp / "fake" / "tc"
    fake.mkdir(parents=True)
    (fake / "g++").write_text(FAKE_GXX)
    (fake / "g++").chmod(0o755)
    out = {"fake": str(fake), "tmp": tmp}
    try:
        for name, make in (
                ("threaded", lambda p: TCluster(p, device="cpu",
                                                compiler_dirs=[str(fake)])),
                ("aio", lambda p: TCluster(p, device="cpu",
                                           compiler_dirs=[str(fake)],
                                           http_frontend="aio")),
                ("jax", lambda p: JCluster(p, compiler_dirs=[str(fake)]))):
            (tmp / name).mkdir()
            out[name] = make(tmp / name)
        yield out
    finally:
        for name in ("threaded", "aio", "jax"):
            if name in out:
                out[name].stop()
        tcloud.shutdown_pack_executor()
        pool = jcloud._PACK_EXECUTOR._pool
        jcloud._PACK_EXECUTOR._pool = None
        if pool is not None:
            pool.shutdown(wait=True)


def _build(rigs, rig: str, cxx, call, capfd, monkeypatch, tag: str,
           cache_control: int) -> list:
    """Each TU through ``cxx.entry`` as a wrapper named g++ runs it, in
    a directory of its own; (exit code, stdout, stderr, object) a TU."""
    work = rigs["tmp"] / f"w-{tag}"
    work.mkdir()
    monkeypatch.chdir(work)
    monkeypatch.setenv("PATH", rigs["fake"] + os.pathsep
                       + os.environ["PATH"])
    monkeypatch.setenv("YTPU_DAEMON_PORT", str(rigs[rig].http.port))
    monkeypatch.setenv("YTPU_COMPILE_ON_CLOUD_SIZE_THRESHOLD", "1")
    monkeypatch.setenv("YTPU_CACHE_CONTROL", str(cache_control))
    call._drop_conn()
    out = []
    for src, flags in _tus():
        (work / src).write_text(f"int {src[:-3]}(int x) "
                                f"{{ return x + {len(flags)}; }}\n")
        capfd.readouterr()
        rc = cxx.entry(["g++", *flags, "-c", src, "-o", src[:-3] + ".o"])
        o, e = capfd.readouterr()
        obj = work / (src[:-3] + ".o")
        out.append((rc, o, e, obj.read_bytes() if obj.exists() else None))
    call._drop_conn()
    return out


def _stats(dispatcher) -> dict:
    return dict(dispatcher.inspect()["stats"])


def _delta(after: dict, before: dict) -> dict:
    return {k: after[k] - before[k] for k in after}


def test_builds_alike_through_both_front_ends_and_both_packages(
        rigs, capfd, monkeypatch):
    runs = {}
    counted = {}
    for tag, rig, cxx, call in (("port-threaded", "threaded", tcxx, tcall),
                                ("port-aio", "aio", tcxx, tcall),
                                ("jax-on-port", "aio", jcxx, jcall),
                                ("port-on-jax", "jax", tcxx, tcall),
                                ("jax-on-jax", "jax", jcxx, jcall)):
        before = _stats(rigs[rig].delegate)
        runs[tag] = _build(rigs, rig, cxx, call, capfd, monkeypatch, tag, 2)
        counted[tag] = _delta(_stats(rigs[rig].delegate), before)
    want = runs["port-threaded"]
    assert [r[0] for r in want] == [0, 0, 1]
    assert want[0][3] == b"FAKEOBJ\nint tu0(int x) { return x + 1; }\n"
    assert want[2] == (1, "", "fake: error\n", None)
    for tag in ("port-aio", "port-on-jax"):
        assert runs[tag] == want, tag
    # The JAX client passes each failed preprocess's stderr through.
    for tag in ("jax-on-port", "jax-on-jax"):
        assert runs[tag][:2] == want[:2], tag
        assert runs[tag][2] == (1, "", "fake: error\n" * 3, None), tag
    # The failing TU never reached a delegate: two compiles a build.
    assert len({str(c) for c in counted.values()}) == 1, counted
    assert counted["port-aio"] == {"hit_cache": 0, "reused": 0,
                                   "actually_run": 2, "failed": 0,
                                   "shed_to_local": 0}
    assert rigs["aio"].http.inspect()["double_replies"] == 0

    # The rebuild, once the fills landed and each reader synced.
    for rig in ("threaded", "aio"):
        deadline = time.monotonic() + 20
        while rigs[rig].cache_service.inspect()["fills"] < 2:
            assert time.monotonic() < deadline, "the cache never filled"
            time.sleep(0.05)
        rigs[rig].cache_reader.sync_once()
        before = _stats(rigs[rig].delegate)
        again = _build(rigs, rig, tcxx, tcall, capfd, monkeypatch,
                       f"again-{rig}", 1)
        assert again == want
        assert _delta(_stats(rigs[rig].delegate), before)["hit_cache"] == 2


@pytest.mark.skipif(GXX is None, reason="no g++ on PATH")
def test_real_gxx_through_a_symlink_named_gxx(rigs, tmp_path):
    """The host's g++ through the aio delegate, the client run as a
    build runs it: a symlink named g++ to yadcc_cxx.py, first on PATH.
    The object equals a local compile of the preprocessed source; the
    process prints nothing, like the compiler."""
    farm = tmp_path / "farm"
    farm.mkdir()
    (farm / "g++").symlink_to(os.path.join(
        REPO, "yadcc_tpu_torch", "client", "yadcc_cxx.py"))
    (tmp_path / "hello.cc").write_text(
        "#include <cstdio>\nint main() { std::puts(\"hello from the port "
        "client\"); return 0; }\n")
    rig = rigs["aio"]
    before = _stats(rig.delegate)
    env = dict(os.environ, PATH=str(farm) + os.pathsep + os.environ["PATH"],
               YTPU_DAEMON_PORT=str(rig.http.port),
               YTPU_COMPILE_ON_CLOUD_SIZE_THRESHOLD="1")
    env.pop("PYTHONPATH", None)
    r = subprocess.run(["g++", "-O2", "-c", "hello.cc", "-o", "hello.o"],
                       cwd=tmp_path, env=env, capture_output=True,
                       timeout=120)
    assert (r.returncode, r.stdout, r.stderr) == (0, b"", b"")
    assert _delta(_stats(rig.delegate), before)["actually_run"] == 1
    subprocess.run([GXX, "-E", "-o", "hello.ii", "hello.cc"], check=True,
                   cwd=tmp_path)
    subprocess.run([GXX, "-x", "c++-cpp-output", "-O2", "-c", "-o",
                    "local.o", "hello.ii"], check=True, cwd=tmp_path)
    assert (tmp_path / "hello.o").read_bytes() == \
        (tmp_path / "local.o").read_bytes()
    subprocess.run([GXX, "hello.o", "-o", "hello"], check=True,
                   cwd=tmp_path)
    out = subprocess.run(["./hello"], cwd=tmp_path, capture_output=True,
                         text=True)
    assert out.stdout.strip() == "hello from the port client"
