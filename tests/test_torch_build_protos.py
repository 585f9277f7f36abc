"""The port's proto builder (yadcc_tpu_torch/api/build_protos.py) and its
wire sources against the JAX package's: the wire is byte-identical by
design, so the port's protos, generated modules and golden descriptor
equal the JAX package's byte for byte, ``--check`` is clean, and a
protoc build reproduces the committed ``api/gen/``.
"""

from __future__ import annotations

import filecmp
import pathlib
import shutil
import subprocess
import sys

import pytest

from yadcc_tpu_torch.api import build_protos

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT_API = REPO / "yadcc_tpu_torch" / "api"
JAX_API = REPO / "yadcc_tpu" / "api"


def _same_tree(a: pathlib.Path, b: pathlib.Path, pattern: str) -> None:
    names = sorted(p.name for p in a.glob(pattern))
    assert names == sorted(p.name for p in b.glob(pattern))
    assert names
    for n in names:
        assert (a / n).read_bytes() == (b / n).read_bytes(), n


def test_protos_gen_and_golden_equal_the_jax_packages():
    _same_tree(PORT_API / "protos", JAX_API / "protos", "*.proto")
    _same_tree(PORT_API / "gen", JAX_API / "gen", "*.py")
    port_golden = REPO / "yadcc_tpu_torch" / "analysis" / "wire_golden.json"
    jax_golden = REPO / "yadcc_tpu" / "analysis" / "wire_golden.json"
    assert port_golden.read_bytes() == jax_golden.read_bytes()
    assert {p.name for p in (PORT_API / "protos").glob("*.proto")} == \
        set(build_protos.PROTOS)


def test_check_is_clean():
    out = subprocess.run(
        [sys.executable, "-m", "yadcc_tpu_torch.api.build_protos",
         "--check"], cwd=REPO, capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    assert out.stdout.count("byte-identical to the pure build") == \
        len(build_protos.PURE_BUILDERS)


def test_check_finds_drift(tmp_path):
    gen = tmp_path / "gen"
    shutil.copytree(PORT_API / "gen", gen)
    (gen / "jit_pb2.py").write_text(
        (gen / "jit_pb2.py").read_text() + "# edited\n")
    assert build_protos.check_pure(gen_dir=gen) == 1
    assert build_protos.check_pure(["env_desc.proto"], gen_dir=gen) == 0


def test_pure_build_reproduces_the_pure_modules(tmp_path):
    build_protos.build_pure(gen_dir=tmp_path)
    for name in build_protos.PURE_BUILDERS:
        stem = name[:-len(".proto")]
        assert filecmp.cmp(tmp_path / f"{stem}_pb2.py",
                           PORT_API / "gen" / f"{stem}_pb2.py",
                           shallow=False), name


@pytest.mark.skipif(shutil.which("protoc") is None,
                    reason="protoc is not installed")
def test_protoc_build_reproduces_gen_byte_for_byte(tmp_path):
    gen = tmp_path / "gen"
    build_protos.build(gen_dir=gen)
    _same_tree(gen, PORT_API / "gen", "*.py")
    # protoc's absolute imports were rewritten to package-relative ones.
    assert "from . import env_desc_pb2 as" in \
        (gen / "scheduler_pb2.py").read_text()
