"""The port's static analyzer (yadcc_tpu_torch/analysis/) against the JAX
package's (yadcc_tpu/analysis/).

1. Parity: every snippet the JAX analyzer tests feed their analyzer
   (tests/test_analysis.py, test_asyncproto.py, test_replproto.py: the
   ``run_snippet``/``run_repl`` calls, read out of those files with
   ``ast``) goes through both analyzers under the same scope and config;
   the (rule, line, suppressed) findings of every rule the port keeps
   unchanged are equal.  The restated rules (``device-sync``, ``jit-*``
   and block-under-lock's device dispatch and sync) are compared by
   their torch fixtures below instead.
2. The restated rules: each torch fixture has a case that must be found
   and one that must not.
3. The self-check over ``yadcc_tpu_torch/`` is clean, strict
   suppressions included, and has teeth: a guarded-by violation and an
   ``.item()`` under the dispatcher lock planted in a copy of the
   dispatcher are found.
4. The CLI: exit codes, the JSON report, ``--baseline``, the result
   cache (its own file, apart from the JAX analyzer's).
"""

from __future__ import annotations

import ast
import json
import os
import pathlib
import subprocess
import sys
import textwrap

import pytest

from yadcc_tpu import analysis as janalysis
from yadcc_tpu_torch import analysis as tanalysis
from yadcc_tpu_torch.analysis import core as tcore
from yadcc_tpu_torch.analysis import minitoml

REPO = pathlib.Path(__file__).resolve().parent.parent
PKG = REPO / "yadcc_tpu_torch"
ANALYSIS = PKG / "analysis"

# Rules restated for torch: compared by their own fixtures (section 2).
RESTATED = {"device-sync", "jit-nondet", "jit-tracer-if",
            "jit-static-unhashable"}


# ---------------------------------------------------------------------------
# 1. Parity on the JAX analyzer's own fixtures.
# ---------------------------------------------------------------------------


def _jax_fixture_cases():
    """(id, code, relative file path, config kwargs) for every
    run_snippet / run_repl call with a literal snippet in the JAX
    analyzer's test files."""
    cases = []
    for fname in ("test_analysis.py", "test_asyncproto.py",
                  "test_replproto.py"):
        tree = ast.parse((REPO / "tests" / fname).read_text())
        consts = {}
        for node in tree.body:
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name) \
                    and isinstance(node.value, ast.Constant) \
                    and isinstance(node.value.value, str):
                consts[node.targets[0].id] = node.value.value
        for node in ast.walk(tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Name)
                    and node.func.id in ("run_snippet", "run_repl")
                    and len(node.args) >= 2):
                continue
            code = node.args[1]
            if isinstance(code, ast.Constant) and \
                    isinstance(code.value, str):
                text = code.value
            elif isinstance(code, ast.Name) and code.id in consts:
                text = consts[code.id]
            else:
                continue
            kw = {}
            try:
                for k in node.keywords:
                    kw[k.arg] = ast.literal_eval(k.value)
            except ValueError:
                continue
            if node.func.id == "run_repl":
                rel = f"scheduler/{kw.pop('filename', 'replication.py')}"
            else:
                rel = f"{kw.pop('subdir', 'scheduler')}/mod.py"
            cases.append((f"{fname[5:-3]}:{node.lineno}", text, rel, kw))
    return cases


CASES = _jax_fixture_cases()


def _comparable(findings):
    out = set()
    for f in findings:
        if f.rule in RESTATED:
            continue
        # block-under-lock / aio-blocking's device terms are restated:
        # jnp/jax dispatch there, torch and the kernel wrappers here.
        if f.rule in ("block-under-lock", "aio-blocking") and \
                "device " in f.message:
            continue
        out.add((f.rule, f.path.split("/", 1)[-1], f.line, f.suppressed))
    return out


def _run_both(tmp_path, code, rel, ranks=None, **cfg):
    results = []
    for pkg in (janalysis, tanalysis):
        root = tmp_path / pkg.__name__.split(".")[0]
        path = root / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(textwrap.dedent(code))
        config = pkg.AnalyzerConfig(lock_ranks=dict(ranks or {}), **cfg)
        findings, _ = pkg.analyze_paths([str(root)], config)
        results.append(findings)
    return results


def test_fixtures_were_found():
    # Every file contributes, and the suite's snippet count holds.
    files = {c[0].split(":")[0] for c in CASES}
    assert files == {"analysis", "asyncproto", "replproto"}
    assert len(CASES) >= 40


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_jax_fixture_gives_the_same_findings(tmp_path, case):
    _, code, rel, kw = case
    jax_f, port_f = _run_both(tmp_path, code, rel, **kw)
    assert _comparable(port_f) == _comparable(jax_f)


def test_rule_catalog_and_directive_syntax_are_the_jax_packages():
    from yadcc_tpu.analysis import core as jcore

    assert set(tcore.RULES) == set(jcore.RULES)
    for name in ("_SUPPRESS_RE", "_GUARD_RE", "_SANITIZES_RE",
                 "_ACQUIRES_RE", "_UNTRUSTED_RE", "_RESPONDER_RE",
                 "_LOOP_ONLY_RE", "_REPLICATED_RE", "_PROTOCOL_RE"):
        assert getattr(tcore, name).pattern == getattr(jcore, name).pattern


# ---------------------------------------------------------------------------
# 2. The restated rules, on torch fixtures.
# ---------------------------------------------------------------------------


def _port(tmp_path, code, rel, root=None):
    root = root or tmp_path / rel.replace("/", "_")
    path = root / rel
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(textwrap.dedent(code))
    findings, _ = tanalysis.analyze_paths(
        [str(root)], tanalysis.AnalyzerConfig(lock_ranks={}))
    return findings


def _live(findings, rule):
    return sorted(f.line for f in findings
                  if f.rule == rule and not f.suppressed)


DEVICE_SYNC = """
import numpy as np
import torch

def cycle(picks, stream, ev, t):
    a = picks.item()                        # 6: found
    b = picks.tolist()                      # 7: found
    c = picks.cpu()                         # 8: found
    d = picks.numpy()                       # 9: found
    torch.cuda.synchronize()                # 10: found
    stream.synchronize()                    # 11: found
    torch.cuda.current_stream().synchronize()  # 12: found
    e = t.to("cpu")                         # 13: found
    f = t.to(device="cpu")                  # 14: found
    g = t.to(torch.device("cpu"))           # 15: found
    h = np.asarray(picks)                   # 16: found
    i = t.to("cuda")                        # 17: not found
    j = t.to(device="cuda", non_blocking=True)  # 18: not found
    k = picks.view(-1)                      # 19: not found
    m = picks.tolist()  # ytpu: allow(device-sync)  # the cycle's one readback
"""


def test_device_sync_finds_the_torch_syncs(tmp_path):
    f = _port(tmp_path, DEVICE_SYNC, "scheduler/policy.py")
    assert _live(f, "device-sync") == [6, 7, 8, 9, 10, 11, 12, 13, 14,
                                       15, 16]
    assert [x.line for x in f if x.rule == "device-sync"
            and x.suppressed] == [20]


def test_device_sync_keeps_its_scope(tmp_path):
    # The same code outside the dispatcher-cycle modules is no finding.
    f = _port(tmp_path, DEVICE_SYNC, "scheduler/service.py")
    assert _live(f, "device-sync") == []


DISPATCH_UNDER_LOCK = """
import threading
import numpy as np
import torch
from ..ops import cuda_grouped as kgrouped
from ..ops.cuda_assign import cuda_assign_batch

class D:
    def __init__(self):
        self._lock = threading.Lock()

    def cycle(self, pool, t):
        with self._lock:
            a = torch.zeros(4)                  # 14: found (dispatch)
            b = kgrouped.cuda_assign_grouped(pool)  # 15: found (alias)
            c = cuda_assign_batch(pool)         # 16: found (from-import)
            d = t.item()                        # 17: found (sync)
            e = np.zeros(4)                     # 18: not found
        f = torch.zeros(4)                      # 19: not found (no lock)
"""


def test_block_under_lock_device_dispatch_is_torch_and_the_wrappers(
        tmp_path):
    f = _port(tmp_path, DISPATCH_UNDER_LOCK, "scheduler/mod.py")
    assert _live(f, "block-under-lock") == [14, 15, 16, 17]
    # jnp / jax are no device dispatch of the port.
    f = _port(tmp_path, """
        import threading
        import jax.numpy as jnp

        class D:
            def __init__(self):
                self._lock = threading.Lock()

            def cycle(self):
                with self._lock:
                    return jnp.zeros(4)
        """, "scheduler/jaxish.py", root=tmp_path / "jaxish")
    assert _live(f, "block-under-lock") == []


JIT_TORCH = """
import random
import time
import numpy as np
import torch

def tp_nondet(x: torch.Tensor, n: int):
    t = time.time()                           # 8: found
    r = random.random()                       # 9: found
    u = np.random.rand(3)                     # 10: found
    v = torch.rand(3)                         # 11: found
    w = torch.randint(0, 4, (3,))             # 12: found
    if x.sum() > 0:                           # 13: found
        return x
    while x.max() > n:                        # 15: found
        x = x - 1
    return x if x.any() else x                # 17: found

def tn_seeded(x: torch.Tensor, gen: torch.Generator, seed: int):
    rng = np.random.default_rng(seed)
    v = torch.rand(3, generator=gen)
    if x.numel() == 0 or x.shape[0] > 2 or x.dtype == torch.int32:
        return x
    if x.is_cuda and x.device.type == "cuda" and x.dim() == 1:
        return x
    if x is None or len(x) > 3 or x.size(0) > 1:
        return x
    return rng.integers(0, 4, 3), v

def host_helper(x, n):
    # Not a device function: no tensor parameter.
    if x > n:
        return time.time()
    return random.random()
"""


def test_jit_rules_restated_for_device_functions(tmp_path):
    f = _port(tmp_path, JIT_TORCH, "ops/mod.py")
    assert _live(f, "jit-nondet") == [8, 9, 10, 11, 12]
    assert _live(f, "jit-tracer-if") == [13, 15, 17]
    assert _live(f, "jit-static-unhashable") == []


def test_jit_rules_keep_their_scope(tmp_path):
    f = _port(tmp_path, JIT_TORCH, "scheduler/mod.py")
    assert _live(f, "jit-nondet") == _live(f, "jit-tracer-if") == []
    f = _port(tmp_path, JIT_TORCH, "scheduler/placement.py")
    assert _live(f, "jit-tracer-if") == [13, 15, 17]


# ---------------------------------------------------------------------------
# 3. The self-check over the port.
# ---------------------------------------------------------------------------


def _package_config(**kw):
    ranks = minitoml.load_path(str(ANALYSIS / "lock_hierarchy.toml"))["rank"]
    return tanalysis.AnalyzerConfig(
        lock_ranks={k: int(v) for k, v in ranks.items()},
        wire_golden=str(ANALYSIS / "wire_golden.json"), **kw)


@pytest.fixture(scope="module")
def self_check():
    return tanalysis.analyze_paths(
        [str(PKG)], _package_config(strict_suppressions=True))


def test_self_check_is_clean(self_check):
    findings, stats = self_check
    bad = [f.render() for f in findings if not f.suppressed]
    assert bad == [], "\n".join(bad)
    assert stats["files_analyzed"] > 150
    # Every suppression carries a reason and matched a finding
    # (strict_suppressions), so the inventory is the audit trail.
    assert stats["suppressed"] >= 40


def test_self_check_covers_the_wire(self_check):
    # The port's api/protos tree is analyzed against its gen modules
    # and its golden: no wire finding, suppressed or not.
    findings, stats = self_check
    assert not [f for f in findings if f.rule.startswith("wire-")]
    assert stats["timings"]["wire-compat"] > 0


def test_self_check_has_teeth(tmp_path):
    src = (PKG / "scheduler" / "task_dispatcher.py").read_text()
    anchor = "    def inspect(self) -> dict:\n"
    assert src.count(anchor) == 1
    planted = src.replace(anchor, textwrap.indent(textwrap.dedent("""
        def planted_unguarded(self):
            return len(self._grants)

        def planted_sync(self, t):
            with self._lock:
                return t.item()

        """), "    ") + anchor)
    root = tmp_path / "yadcc_tpu_torch"
    (root / "scheduler").mkdir(parents=True)
    (root / "scheduler" / "task_dispatcher.py").write_text(planted)
    findings, _ = tanalysis.analyze_paths([str(root)], _package_config())
    live = [f for f in findings if not f.suppressed]
    lines = planted.splitlines()

    def hit(rule, needle):
        return any(f.rule == rule and needle in lines[f.line - 1]
                   for f in live)

    assert hit("guarded-by", "return len(self._grants)")
    assert hit("device-sync", "return t.item()")
    assert hit("block-under-lock", "return t.item()")
    assert len(live) == 3, [f.render() for f in live]


def test_port_directives_cover_the_jax_packages():
    """Each kind of `# ytpu:` directive the JAX package carries outside
    its analyzer, the port carries at least as often."""
    import re

    kind = re.compile(r"#\s*ytpu:\s*([a-z\-]+)")

    def count(root):
        out = {}
        for p in root.rglob("*.py"):
            if "analysis" in p.parts:
                continue
            for m in kind.finditer(p.read_text()):
                out[m.group(1)] = out.get(m.group(1), 0) + 1
        return out

    port, ref = count(PKG), count(REPO / "yadcc_tpu")
    for k, n in ref.items():
        assert port.get(k, 0) >= n, (k, port.get(k, 0), n)


# ---------------------------------------------------------------------------
# 4. The CLI.
# ---------------------------------------------------------------------------


BAD_TREE = """
import threading, time

class T:
    def __init__(self):
        self._lock = threading.Lock()

    def f(self):
        with self._lock:
            time.sleep(1)
"""


def _cli(*args, env=None):
    return subprocess.run(
        [sys.executable, "-m", "yadcc_tpu_torch.analysis", *args],
        cwd=REPO, env=env or dict(os.environ), capture_output=True,
        text=True, timeout=120)


def _bad_tree(tmp_path):
    tree = tmp_path / "tree"
    (tree / "scheduler").mkdir(parents=True)
    (tree / "scheduler" / "m.py").write_text(textwrap.dedent(BAD_TREE))
    return tree


def test_cli_exit_codes_and_json(tmp_path):
    tree = _bad_tree(tmp_path)
    report = tmp_path / "report.json"
    proc = _cli(str(tree), "--no-cache", "--json", str(report))
    assert proc.returncode == 1, proc.stdout + proc.stderr
    data = json.loads(report.read_text())
    assert data["version"] == 2
    assert data["stats"]["findings"] == 1
    assert data["findings"][0]["rule"] == "block-under-lock"
    assert _cli(str(tmp_path / "does-not-exist")).returncode == 2
    (tree / "scheduler" / "m.py").write_text("x = 1\n")
    assert _cli(str(tree), "--no-cache").returncode == 0


def test_cli_baseline_and_result_cache(tmp_path):
    tree = _bad_tree(tmp_path)
    bl = tmp_path / "baseline.txt"
    assert _cli(str(tree), "--no-cache", "--write-baseline",
                str(bl)).returncode == 0
    proc = _cli(str(tree), "--no-cache", "--baseline", str(bl))
    assert proc.returncode == 0 and "1 baselined" in proc.stdout
    # The default cache is the port's own file, apart from the JAX
    # analyzer's.
    home = tmp_path / "home"
    env = dict(os.environ, XDG_CACHE_HOME=str(home))
    for hits in ("0/1", "1/1"):
        proc = _cli(str(tree), "--stats", env=env)
        assert proc.returncode == 1
        assert f"cache: {hits} file hits" in proc.stdout
    assert (home / "ytpu-torch-analyze" / "cache.json").exists()
    assert not (home / "ytpu-analyze").exists()
