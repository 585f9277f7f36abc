"""The port stands alone: yadcc_tpu_torch imports no jax, nothing of the
JAX package and no `xxhash` wheel, and its entry points refuse to run
without a card unless the caller asks for the CPU."""

from __future__ import annotations

import pathlib
import re
import subprocess
import sys
import textwrap

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
PKG = REPO / "yadcc_tpu_torch"

_FORBIDDEN = re.compile(
    r"^\s*(?:import|from)\s+(?:jax|jaxlib|yadcc_tpu|xxhash)(?:\.|\s|$)",
    re.M)
# The Bloom slice's modules, each imported by name below.
_BLOOM_MODULES = (
    "common.bloom", "common.xxh64_np", "ops.xxh64_torch", "ops.bloom_probe",
    "ops.bloom_pipeline", "ops.cuda_bloom", "cache.bloom_filter_generator",
    "tools.bloom_bench")
# The sharded, multi-tenant scheduler's modules, each imported by name.
_SHARD_MODULES = (
    "common.hashing", "common.backoff", "common.consistent_hash",
    "tenancy", "tenancy.identity", "tenancy.tiers", "tenancy.budgets",
    "parallel.mesh", "scheduler.shard_router")
# Replication, standby, federation and scored placement, each by name.
_REPLICATION_MODULES = (
    "rpc.transport", "scheduler.replication", "scheduler.placement",
    "scheduler.federation", "scheduler.entry")
# The aio front end and the parked wait, each by name.
_AIO_MODULES = ("rpc.aio_server", "utils.looplag", "rpc.grpc_transport",
                "scheduler.service", "scheduler.task_dispatcher")


def _port_sources():
    return sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py",
                                        REPO / "chip_k1_ab.py",
                                        REPO / "chip_k2_probe.py",
                                        REPO / "chip_bloom_probe.py"]


def test_sources_import_no_jax_and_no_jax_package():
    offenders = []
    for path in _port_sources():
        for m in _FORBIDDEN.finditer(path.read_text()):
            offenders.append(f"{path.relative_to(REPO)}: {m.group(0).strip()}")
    assert not offenders, offenders


def test_every_module_imports_with_jax_and_jax_package_blocked():
    script = textwrap.dedent(r"""
        import importlib, importlib.abc, pkgutil, sys

        class Refuse(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path=None, target=None):
                if name in ("jax", "jaxlib", "xxhash") \
                        or name == "yadcc_tpu" \
                        or name.startswith(("jax.", "jaxlib.",
                                            "yadcc_tpu.", "xxhash.")):
                    raise ImportError(f"blocked import of {name}")
                return None

        sys.modules["jax"] = None
        sys.modules["xxhash"] = None
        sys.meta_path.insert(0, Refuse())
        import yadcc_tpu_torch
        names = ["yadcc_tpu_torch"]
        for info in pkgutil.walk_packages(yadcc_tpu_torch.__path__,
                                          "yadcc_tpu_torch."):
            names.append(info.name)
        for name in names:
            importlib.import_module(name)
        for name in ("yadcc_tpu_torch.ops.cuda_assign",
                     "yadcc_tpu_torch.scheduler.device_pool") + tuple(
                "yadcc_tpu_torch." + m for m in BLOOM + SHARD + REPL + AIO):
            assert name in names, name
            importlib.import_module(name)
        import chip_bloom_probe, chip_k1_ab, chip_k2_probe  # noqa: F401
        import chip_smoke  # noqa: F401
        leaked = sorted(n for n in sys.modules
                        if n == "yadcc_tpu" or n.startswith("yadcc_tpu.")
                        or (n.startswith(("jax", "xxhash"))
                            and sys.modules[n]))
        assert not leaked, leaked
        from yadcc_tpu_torch.rpc import Channel, make_rpc_server
        from yadcc_tpu_torch.rpc.aio_server import AioChannel
        assert type(Channel("aio://127.0.0.1:1")) is AioChannel
        assert callable(make_rpc_server)
        print(len(names))
    """)
    script = (f"BLOOM = {_BLOOM_MODULES!r}\n"
              f"SHARD = {_SHARD_MODULES!r}\n"
              f"REPL = {_REPLICATION_MODULES!r}\n"
              f"AIO = {_AIO_MODULES!r}\n" + script)
    out = subprocess.run([sys.executable, "-c", script], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert int(out.stdout.strip().splitlines()[-1]) >= 50


def test_resolve_device_refuses_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from yadcc_tpu_torch.device import resolve_device

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("mps")


def test_entry_defaults_to_the_card_and_refuses_without_one():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from yadcc_tpu_torch.scheduler import entry

    args = entry.build_arg_parser().parse_args([])
    assert args.device == "cuda"
    assert args.dispatch_policy == "auto"
    assert args.max_servants == 8192
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        entry.build_dispatcher(args)


def test_wrapper_routes_cpu_tensors_to_the_plain_version():
    """A CPU pool takes the plain version; the launch counter counts
    kernel launches only."""
    import numpy as np

    from yadcc_tpu_torch.ops import assignment as asn
    from yadcc_tpu_torch.ops import assignment_grouped as asg
    from yadcc_tpu_torch.ops import cuda_grouped as kg

    s = 64
    pool = asn.pool_from_numpy(
        np.ones(s, bool), np.full(s, 4, np.int32), np.zeros(s, np.int32),
        np.zeros(s, bool), np.ones(s, np.int32),
        np.full((s, 8), 0xFFFFFFFF, np.uint32), "cpu")
    batch = asg.make_grouped_batch([(3, 1, -1, 10)], pad_to=4)
    before = kg.launches
    counts, running = kg.cuda_assign_grouped(pool, batch)
    want_c, want_r = asg.assign_grouped(pool, batch)
    assert kg.launches == before
    assert torch.equal(counts, want_c) and torch.equal(running, want_r)
    assert int(counts.sum()) == 10
