"""The port's client installer (yadcc_tpu_torch/tools/install_client.py)
and its native client (yadcc_tpu_torch/native/, built into
yadcc_tpu_torch/_build/native/<frames>/).

The Python farm runs the port's clients; the native farm links every
compiler name to the port's own build of the native client, never to the
JAX package's native/.  The port's ytpu-testtool agrees with the port's
Python client on tests/test_native_client.py's cases (shell quoting, the
remote invocation, BLAKE2b, the lightweight-quota class), and a TU
compiled through the native farm against the port's in-process cluster
is byte-equal to a local compile, on the zstd frames and on the zlib
frames a host without the zstandard wheel speaks (the card's host)."""

from __future__ import annotations

import os
import shlex
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from tests.test_native_client import (INVOCATION_CASES, QUOTA_CLASS_CASES,
                                      QUOTE_BATTERY, run_tool)
from yadcc_tpu_torch.client.compiler_args import CompilerArgs
from yadcc_tpu_torch.client.yadcc_cxx import (_is_lightweight_task,
                                              remote_invocation)
from yadcc_tpu_torch.common.hashing import digest_file
from yadcc_tpu_torch.tools import install_client

REPO = Path(__file__).resolve().parent.parent
BUILD = REPO / "yadcc_tpu_torch" / "_build" / "native"


def _build(frames: str, targets=("client", "fakeroot", "testtool")) -> Path:
    try:
        return install_client.build_native(targets, frames=frames)
    except RuntimeError as e:
        pytest.skip(f"native toolchain unavailable: {str(e)[-400:]}")


@pytest.fixture(scope="module")
def testtool():
    return _build(install_client.native_frames()) / "ytpu-testtool"


def test_python_farm_runs_the_ports_clients(tmp_path):
    farm = tmp_path / "farm"
    install_client.install(str(farm), use_python_client=True)
    for name in ("gcc", "g++", "cc", "c++", "clang", "clang++"):
        body = (farm / name).read_text()
        assert not (farm / name).is_symlink()
        assert "-m yadcc_tpu_torch.client.yadcc_cxx " + name in body
        assert f'YTPU_WRAPPER_DIR="{farm}"' in body
        assert "yadcc_tpu.client" not in body
        assert os.access(farm / name, os.X_OK)
    for name in ("javac", "jar"):
        body = (farm / name).read_text()
        assert "-m yadcc_tpu_torch.client.universal_wrapper " + name in body
        assert f'YTPU_WRAPPER_DIR="{farm}"' in body


def test_native_farm_links_into_the_ports_build(tmp_path):
    _build(install_client.native_frames(), ("client", "fakeroot"))
    farm = tmp_path / "farm"
    install_client.install(str(farm))
    want = BUILD / install_client.native_frames() / "ytpu-cxx"
    for name in ("ytpu-cxx", "gcc", "g++", "cc", "c++", "clang", "clang++"):
        link = farm / name
        assert link.is_symlink() and link.resolve() == want.resolve()
    assert BUILD.resolve() in (farm / "g++").resolve().parents
    assert (REPO / "native").resolve() not in \
        (farm / "g++").resolve().parents
    # The fakeroot shim beside the binary the links resolve to.
    assert (want.parent / "libytpufakeroot.so").exists()
    # Reinstalling the Python client never writes through a link: the
    # binary stays an ELF, the farm's names become scripts.
    install_client.install(str(farm), use_python_client=True)
    assert not (farm / "g++").is_symlink()
    assert want.read_bytes()[:4] == b"\x7fELF"
    install_client.install(str(farm))
    assert (farm / "g++").resolve() == want.resolve()


def test_native_build_refuses_unknown_frames():
    with pytest.raises(RuntimeError, match="FRAMES"):
        install_client.build_native(("client",), frames="lz4")


def test_shell_quote_matches_shlex(testtool):
    assert run_tool(testtool, "quote", *QUOTE_BATTERY) == \
        [shlex.quote(a) for a in QUOTE_BATTERY]


@pytest.mark.parametrize("argv", INVOCATION_CASES,
                         ids=[str(i) for i in range(len(INVOCATION_CASES))])
@pytest.mark.parametrize("directives_only", [False, True])
def test_remote_invocation_equals_the_ports_python_client(
        testtool, argv, directives_only):
    py = remote_invocation(CompilerArgs.parse(argv), directives_only)
    flags = ["-d"] if directives_only else []
    (native,) = run_tool(testtool, "invocation", *flags, *argv)
    assert native == py


def test_blake2b_matches_the_ports_digest(testtool, tmp_path):
    for name, payload in [("empty", b""), ("small", b"hello world\n"),
                          ("odd", bytes(range(256)) * 3 + b"x"),
                          ("big", b"\xab" * (1 << 16) + b"tail")]:
        p = tmp_path / name
        p.write_bytes(payload)
        (got,) = run_tool(testtool, "blake2b", str(p))
        assert got == digest_file(p), name


@pytest.mark.parametrize("argv,want", QUOTA_CLASS_CASES)
def test_lightweight_quota_class_equals_the_ports(testtool, argv, want,
                                                  monkeypatch):
    monkeypatch.delenv("YTPU_TREAT_SOURCE_FROM_STDIN_AS_LIGHTWEIGHT",
                       raising=False)
    assert _is_lightweight_task(CompilerArgs.parse(argv)) is want
    assert run_tool(testtool, "lightweight", *argv) == \
        ["1" if want else "0"]


SOURCE = (b"#include <vector>\n"
          b"int sum(int n) { std::vector<int> v(n, 2); int s = 0;\n"
          b"  for (int x : v) s += x; return s; }\n")


@pytest.mark.parametrize("frames", ["zstd", "zlib"])
def test_native_client_compiles_through_the_ports_cluster(
        tmp_path, monkeypatch, frames):
    """One TU through the native farm's g++, the port's in-process rig
    (its daemon on ``frames``, the scheduler's policy on the CPU)
    compiling it on a servant: the object byte-equal to a local
    compile."""
    from yadcc_tpu_torch.common import _zlib_frames
    from yadcc_tpu_torch.common import compress
    from yadcc_tpu_torch.daemon.cloud.cxx_task import shutdown_pack_executor
    from yadcc_tpu_torch.testing import LocalCluster

    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no host g++")
    if frames == "zlib":
        monkeypatch.setattr(compress, "zstandard", None)
        monkeypatch.setattr(compress, "_fallback", _zlib_frames,
                            raising=False)
        monkeypatch.setattr(compress, "CompressionError", _zlib_frames.Error)
    out = _build(frames, ("client", "fakeroot"))
    tc = tmp_path / "tc"
    tc.mkdir()
    (tc / "g++").symlink_to(os.path.realpath(gxx))
    farm = tmp_path / "farm"
    farm.mkdir()
    (farm / "g++").symlink_to(out / "ytpu-cxx")
    work = tmp_path / "w"
    work.mkdir()
    (work / "a.cc").write_bytes(SOURCE)
    (tmp_path / "rig").mkdir()
    rig = LocalCluster(tmp_path / "rig", device="cpu",
                       compiler_dirs=[str(tc)])
    try:
        env = dict(os.environ, PATH=f"{farm}:{tc}:{os.environ['PATH']}",
                   YTPU_DAEMON_PORT=str(rig.http.port),
                   YTPU_COMPILE_ON_CLOUD_SIZE_THRESHOLD="1")
        r = subprocess.run(["g++", "-O2", "-c", "a.cc", "-o", "a.o"],
                           cwd=work, env=env, capture_output=True,
                           timeout=120)
        assert r.returncode == 0, r.stderr[-2000:]
        stats = rig.delegate.inspect()["stats"]
    finally:
        rig.stop()
        shutdown_pack_executor()
    subprocess.run([gxx, "-O2", "-c", "a.cc", "-o", "ref.o"], cwd=work,
                   check=True, timeout=120)
    assert (work / "a.o").read_bytes() == (work / "ref.o").read_bytes()
    assert stats["actually_run"] == 1 and stats["failed"] == 0


def test_native_and_python_clients_share_cache_entries(tmp_path):
    """A TU that includes a header under the compiler's root, compiled
    through the native farm, is then a cache hit for the Python client:
    both preload the port's fakeroot shim, so their preprocessed bytes
    and cache keys agree."""
    import time

    from yadcc_tpu_torch.client import rewrite_file
    from yadcc_tpu_torch.daemon.cloud.cxx_task import shutdown_pack_executor
    from yadcc_tpu_torch.testing import LocalCluster

    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no host g++")
    out = _build(install_client.native_frames(), ("client", "fakeroot"))
    assert rewrite_file._fakeroot_path() is not None
    assert BUILD.resolve() in Path(rewrite_file._fakeroot_path()).parents
    tc = tmp_path / "tc"
    tc.mkdir()
    (tc / "g++").symlink_to(os.path.realpath(gxx))
    farm, pyfarm = tmp_path / "farm", tmp_path / "pyfarm"
    farm.mkdir()
    (farm / "g++").symlink_to(out / "ytpu-cxx")
    install_client.install(str(pyfarm), use_python_client=True)
    work = tmp_path / "w"
    work.mkdir()
    (work / "a.cc").write_bytes(SOURCE)
    (tmp_path / "rig").mkdir()
    rig = LocalCluster(tmp_path / "rig", device="cpu",
                       compiler_dirs=[str(tc)])
    try:
        def compile_with(f, obj):
            env = dict(os.environ, PATH=f"{f}:{tc}:{os.environ['PATH']}",
                       YTPU_DAEMON_PORT=str(rig.http.port),
                       YTPU_COMPILE_ON_CLOUD_SIZE_THRESHOLD="1")
            r = subprocess.run(["g++", "-O2", "-c", "a.cc", "-o", obj],
                               cwd=work, env=env, capture_output=True,
                               timeout=120)
            assert r.returncode == 0, r.stderr[-2000:]
            return dict(rig.delegate.inspect()["stats"])

        first = compile_with(farm, "native.o")
        deadline = time.monotonic() + 30
        while rig.cache_service.inspect()["fills"] < 1:
            assert time.monotonic() < deadline, "the fill never landed"
            time.sleep(0.05)
        rig.cache_reader.sync_once()
        second = compile_with(pyfarm, "python.o")
    finally:
        rig.stop()
        shutdown_pack_executor()
    assert first["actually_run"] == 1
    assert second["hit_cache"] == 1 and second["actually_run"] == 1
    assert (work / "native.o").read_bytes() == \
        (work / "python.o").read_bytes()


def test_installer_as_a_program(tmp_path):
    farm = tmp_path / "farm"
    r = subprocess.run([sys.executable, "-m",
                        "yadcc_tpu_torch.tools.install_client",
                        "--python-client", str(farm)], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert "python client wrappers" in r.stdout
    assert (farm / "g++").exists()
