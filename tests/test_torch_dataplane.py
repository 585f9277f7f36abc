"""The port's data-plane A/B (yadcc_tpu_torch/tools/_dataplane_legacy.py and
tools/dataplane_bench.py) against the JAX package's: every legacy codec
byte-equal to the JAX package's and to the port's zero-copy counterpart
on seeded inputs; the copy meter's model equal in both packages; the
legacy patches put the legacy path in place on attributes that exist
(a missing one raises) and take it out again; the cluster A/B's report
has the JAX package's keys."""

from __future__ import annotations

import ast
import inspect
import types

import numpy as np
import pytest

from yadcc_tpu.common import compress as jcompress
from yadcc_tpu.daemon import cache_format as jcf
from yadcc_tpu.tools import _dataplane_legacy as JL
from yadcc_tpu.tools import dataplane_bench as jbench
from yadcc_tpu_torch.common import compress as tcompress
from yadcc_tpu_torch.common import multi_chunk as tmc
from yadcc_tpu_torch.daemon import cache_format as tcf
from yadcc_tpu_torch.daemon import packing as tpacking
from yadcc_tpu_torch.tools import _dataplane_legacy as TL
from yadcc_tpu_torch.tools import dataplane_bench as tbench

SIZES = (0, 1, 64 << 10, 1 << 20)


def blob(size: int, seed: int) -> bytes:
    return np.random.default_rng(seed).bytes(size)


def as_bytes(chunks):
    return None if chunks is None else [bytes(c) for c in chunks]


@pytest.mark.parametrize("size", SIZES)
def test_multi_chunk_codecs_equal(size):
    chunks = [b'{"task":1}', blob(size, 1), b"", blob(size // 3, 2)]
    frame = TL.legacy_make_multi_chunk(chunks)
    assert frame == JL.legacy_make_multi_chunk(chunks)
    assert frame == tmc.make_multi_chunk_payload(chunks).join()
    assert TL.legacy_make_multi_chunk_payload(chunks).join() == frame
    assert JL.legacy_make_multi_chunk_payload(chunks).join() == frame
    for data in (frame, frame[:-1], b"x\r\n", b"1,-1\r\nx", b"", b"\r\n",
                 b"2,1\r\nabc"):
        got = TL.legacy_try_parse_multi_chunk(data)
        assert got == JL.legacy_try_parse_multi_chunk(data)
        assert got == as_bytes(tmc.try_parse_multi_chunk_views(data))
        assert TL.legacy_try_parse_multi_chunk_views(data) == got
    assert TL.legacy_try_parse_multi_chunk(frame) == chunks


@pytest.mark.parametrize("size", SIZES)
def test_keyed_buffers_equal(size):
    buffers = {".o": blob(size, 3), ".gcno": b"", "k": blob(size // 7, 4)}
    att = TL.legacy_pack_keyed_buffers(buffers)
    assert att == JL.legacy_pack_keyed_buffers(buffers)
    assert att == tpacking.pack_keyed_buffers_payload(buffers).join()
    assert TL.legacy_pack_keyed_buffers_payload(buffers).join() == att
    for data in (att, att[:-1], b"1\r\nx", b"\xff\xfe"):
        got = TL.legacy_try_unpack_keyed_buffers(data)
        assert got == JL.legacy_try_unpack_keyed_buffers(data)
        views = tpacking.try_unpack_keyed_buffers_views(data)
        assert got == (None if views is None
                       else {k: bytes(v) for k, v in views.items()})
    assert TL.legacy_try_unpack_keyed_buffers(att) == buffers


def _entries(size):
    kw = dict(exit_code=1, standard_output=b"out", standard_error=b"err",
              files={".o": blob(size, 5), ".su": blob(size // 2, 6)},
              patches={".o": [(0, 8, b"/x.o"), (16, 4, b"")]})
    return tcf.CacheEntry(**kw), jcf.CacheEntry(**kw)


def _fields(entry):
    return (entry.exit_code, bytes(entry.standard_output),
            bytes(entry.standard_error),
            {k: bytes(v) for k, v in entry.files.items()},
            {k: [(p, t, bytes(s)) for p, t, s in v]
             for k, v in entry.patches.items()})


@pytest.mark.parametrize("size", SIZES)
def test_cache_entry_codecs_equal(size):
    t_entry, j_entry = _entries(size)
    data = TL.legacy_write_cache_entry(t_entry)
    assert data == JL.legacy_write_cache_entry(j_entry)
    assert data == tcf.write_cache_entry_payload(t_entry).join()
    assert TL.legacy_write_cache_entry_payload(t_entry).join() == data
    got = TL.legacy_try_parse_cache_entry(data)
    assert _fields(got) == _fields(JL.legacy_try_parse_cache_entry(data))
    assert _fields(got) == _fields(tcf.try_parse_cache_entry(data))
    assert _fields(got) == _fields(t_entry)
    bad = bytearray(data)
    bad[-1] ^= 1
    assert TL.legacy_try_parse_cache_entry(bytes(bad)) is None
    assert JL.legacy_try_parse_cache_entry(bytes(bad)) is None


@pytest.mark.parametrize("size", SIZES)
def test_source_intake_equal(size):
    src = blob(size, 7)
    frame = tcompress.compress(src)
    assert frame == jcompress.compress(src)
    got = TL.legacy_two_pass_decompress_digest(frame)
    assert got == JL.legacy_two_pass_decompress_digest(frame)
    assert got == tcompress.decompress_and_digest(frame)
    assert got[0] == src


def test_inline_executor_shims_equal():
    for mod in (TL, JL):
        shim = mod.InlineExecutorShim()
        assert shim.get() is shim
        assert shim.submit(lambda a, b=0: a + b, 2, b=3).result() == 5


@pytest.mark.parametrize("size", [1 << 10, 64 << 10, 1 << 20])
@pytest.mark.parametrize("legacy", [True, False])
def test_model_task_copies_equal(size, legacy):
    assert tbench.model_task_copies(size, legacy) == \
        jbench.model_task_copies(size, legacy)


def test_check_parity_passes():
    tbench.check_parity()
    assert tbench._COPY_PATH_STAGES == jbench._COPY_PATH_STAGES
    assert set(tbench._stage_pairs(4096)) == set(jbench._stage_pairs(4096))


def test_patched_raises_on_a_missing_attribute():
    mod = types.ModuleType("m")
    mod.present = 1
    with pytest.raises(AttributeError, match="m.absent"):
        with TL._patched((mod, "present", 2), (mod, "absent", 3)):
            pass
    assert mod.present == 1 and not hasattr(mod, "absent")
    with TL._patched((mod, "present", 2)):
        assert mod.present == 2
    assert mod.present == 1


PATCH_SETS = {
    "servant": (TL.servant_legacy_patches, (
        ("yadcc_tpu_torch.daemon.cloud.cxx_task", "_decompress_and_digest",
         TL.legacy_two_pass_decompress_digest),
        ("yadcc_tpu_torch.daemon.cloud.cxx_task", "_PACK_EXECUTOR", None),
        ("yadcc_tpu_torch.daemon.cache_format", "write_cache_entry_payload",
         TL.legacy_write_cache_entry_payload),
        ("yadcc_tpu_torch.daemon.packing", "pack_keyed_buffers_payload",
         TL.legacy_pack_keyed_buffers_payload))),
    "delegate": (TL.delegate_legacy_patches, (
        ("yadcc_tpu_torch.daemon.packing", "try_unpack_keyed_buffers_views",
         TL.legacy_try_unpack_keyed_buffers),
        ("yadcc_tpu_torch.daemon.cache_format", "try_parse_cache_entry",
         TL.legacy_try_parse_cache_entry),
        ("yadcc_tpu_torch.common.multi_chunk", "try_parse_multi_chunk_views",
         TL.legacy_try_parse_multi_chunk_views),
        ("yadcc_tpu_torch.common.multi_chunk", "make_multi_chunk_payload",
         TL.legacy_make_multi_chunk_payload))),
}


@pytest.mark.parametrize("which", sorted(PATCH_SETS) + ["full"])
def test_every_patch_target_exists_and_is_restored(which):
    import importlib

    targets = (PATCH_SETS["servant"][1] + PATCH_SETS["delegate"][1]
               if which == "full" else PATCH_SETS[which][1])
    ctx = (TL.full_legacy_patches() if which == "full"
           else PATCH_SETS[which][0]())
    before = {}
    for mod, name, _ in targets:
        m = importlib.import_module(mod)
        assert hasattr(m, name), f"{mod}.{name}"
        before[mod, name] = getattr(m, name)
    with ctx:
        for mod, name, repl in targets:
            got = getattr(importlib.import_module(mod), name)
            if repl is None:
                assert isinstance(got, TL.InlineExecutorShim)
            else:
                assert got is repl
    for mod, name, _ in targets:
        assert getattr(importlib.import_module(mod), name) is \
            before[mod, name]


def test_servant_intake_runs_through_the_patched_seam(tmp_path):
    """The servant's source intake calls the module's seam, so the
    legacy patch replaces code that runs."""
    from yadcc_tpu_torch.daemon.cloud import cxx_task

    calls = []

    def legacy(data):
        calls.append(len(data))
        return TL.legacy_two_pass_decompress_digest(data)

    src = b"int f() { return 1; }\n"
    task = cxx_task.CloudCxxCompilationTask(
        compiler_path="/bin/true", compiler_digest="c" * 64,
        invocation_arguments="-O2", source_path="x.cc",
        temp_root=str(tmp_path))
    with TL._patched((cxx_task, "_decompress_and_digest", legacy)):
        task.prepare(tcompress.compress(src))
    assert calls and task.source == src


def test_cluster_ab_has_the_jax_packages_keys():
    out = tbench.run_cluster_ab(8, 2, 2, "", 0.0, device="cpu")
    tree = ast.parse(inspect.getsource(jbench.run_cluster_ab))
    rets = [n.value for n in ast.walk(tree) if isinstance(n, ast.Return)
            and isinstance(n.value, ast.Dict)]
    want = {k.value for k in rets[-1].keys}
    assert set(out) == want
    assert set(out["flags"]) == {"tasks", "servants", "concurrency",
                                 "dup_rate", "policy", "tu_size_dist",
                                 "compile_s"}
    for side in ("legacy", "zero_copy"):
        assert out[side]["failures"] == 0
        assert out[side]["tasks"] == 8
    assert set(out["legacy"]) == set(out["zero_copy"])
