"""The port's trace replay (yadcc_tpu_torch/tools/trace_replay.py) against
the JAX package's: byte-equal traces from one seed, equal pool snapshots,
and the replay panel's outcomes pair by pair (greedy_cpu, torch_batched
= jax_batched, torch_grouped = jax_grouped, auto), with the port's
device policies on the CPU (their plain versions); then the pipelined
stream's equivalence to the serialized run in both packages."""

from __future__ import annotations

import numpy as np
import pytest

from yadcc_tpu.scheduler import policy as jpol
from yadcc_tpu.tools import trace_replay as jtr
from yadcc_tpu_torch.tools import trace_replay as ttr

PAIRS = (("greedy_cpu", "greedy_cpu"), ("torch_batched", "jax_batched"),
         ("torch_grouped", "jax_grouped"), ("auto", "auto"))


@pytest.mark.parametrize("kw", [
    dict(tasks=6000, servants=128, seed=0),
    dict(tasks=600, servants=32, batch=50, envs=8, seed=3),
    dict(tasks=61, servants=5000, batch=64, envs=40, seed=11)])
def test_generated_traces_are_byte_equal(tmp_path, kw):
    jtr.generate_trace(str(tmp_path / "j.jsonl"), **kw)
    ttr.generate_trace(str(tmp_path / "t.jsonl"), **kw)
    raw = (tmp_path / "t.jsonl").read_bytes()
    assert raw == (tmp_path / "j.jsonl").read_bytes()
    events = jtr._load(str(tmp_path / "j.jsonl"))
    js, ts = (m._snapshot_from_pool(events[0]) for m in (jtr, ttr))
    for f in ("alive", "capacity", "running", "dedicated", "version",
              "env_bitmap"):
        a, b = getattr(ts, f), getattr(js, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f


@pytest.mark.parametrize("kw", [dict(keys=1000, draws=10000, seed=0),
                                dict(keys=7, draws=300, zipf_a=2.0, seed=5,
                                     prefix="ytpu-cxx2-entry-")])
def test_generated_key_traces_are_byte_equal(tmp_path, kw):
    uj = jtr.generate_key_trace(str(tmp_path / "j.jsonl"), **kw)
    ut = ttr.generate_key_trace(str(tmp_path / "t.jsonl"), **kw)
    assert ut == uj
    assert (tmp_path / "t.jsonl").read_bytes() == \
        (tmp_path / "j.jsonl").read_bytes()


class _Recorder:
    """A policy wrapper that keeps each assign call's requests and picks,
    so two packages' replays can be held batch by batch."""

    def __init__(self, inner):
        self.inner = inner
        self.calls = []

    def warmup(self, *a, **kw):
        self.inner.warmup(*a, **kw)

    def assign(self, snap, requests):
        picks = self.inner.assign(snap, requests)
        self.calls.append((list(requests), [int(p) for p in picks]))
        return picks


def _batches(rec, runs_module):
    # The first five calls are the replay's untimed warmup probes.
    return [runs_module._run_multisets(reqs, picks)
            for reqs, picks in rec.calls[5:]]


@pytest.fixture(scope="module")
def trace(tmp_path_factory):
    path = tmp_path_factory.mktemp("replay") / "trace.jsonl"
    ttr.generate_trace(str(path), tasks=600, servants=32, batch=50,
                       envs=8, seed=3)
    return str(path)


def test_replay_panel_equals_the_jax_panel(trace, monkeypatch):
    # The port's replay builds its default panel (policy_panel on the
    # resolved device); each policy is wrapped on the way out.
    port = {}
    panel = ttr.policy_panel

    def recorded_panel(device):
        port.update({k: _Recorder(v) for k, v in panel(device).items()})
        return port

    monkeypatch.setattr(ttr, "policy_panel", recorded_panel)
    jax = {k: _Recorder(v) for k, v in {
        "greedy_cpu": jpol.GreedyCpuPolicy(),
        "jax_batched": jpol.JaxBatchedPolicy(max_servants=32),
        "jax_grouped": jpol.JaxGroupedPolicy(),
        "auto": jpol.AutoPolicy(),
    }.items()}
    got = ttr.replay(trace, device="cpu")
    want = jtr.replay(trace, jax)
    assert list(got) == [p for p, _ in PAIRS]
    reference = _batches(port["greedy_cpu"], ttr)
    assert len(reference) == 12 and reference == _batches(
        jax["greedy_cpu"], jtr)
    for p, j in PAIRS:
        assert got[p]["matches_reference"] and want[j]["matches_reference"]
        assert got[p]["granted"] == want[j]["granted"] > 0, p
        assert got[p]["final_running"] == want[j]["final_running"], p
        assert _batches(port[p], ttr) == _batches(jax[j], jtr) \
            == reference, p


def test_replay_default_panel_on_the_cpu(trace):
    # The replay through the default panel on the CPU is held in
    # test_replay_panel_equals_the_jax_panel; here, the panel itself.
    import torch

    panel = ttr.policy_panel("cpu")
    assert list(panel) == [p for p, _ in PAIRS]
    cpu = torch.device("cpu")
    assert panel["torch_batched"]._device == cpu
    assert panel["torch_grouped"]._device == cpu
    assert panel["auto"]._grouped._device == cpu

    if not torch.cuda.is_available():
        # The panel defaults to the card: without one it raises.
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ttr.replay(trace)


def test_stream_matches_serialized_in_both_packages(trace, monkeypatch):
    # stream_warmup runs (the port) or compiles (JAX) every pad shape of
    # the ladder once and keeps nothing of it; each replay_stream depth
    # warms a fresh policy, which costs seconds on the CPU and does not
    # change an outcome, so both are skipped here.
    from yadcc_tpu_torch.scheduler import policy as tpol

    monkeypatch.setattr(tpol.TorchGroupedPolicy, "stream_warmup",
                        lambda self, *a, **kw: None)
    monkeypatch.setattr(jpol.JaxGroupedPolicy, "stream_warmup",
                        lambda self, *a, **kw: None)
    got = ttr.replay_stream(trace, depths=(0, 4), horizon=16, device="cpu")
    want = jtr.replay_stream(trace, depths=(0, 4), horizon=16)
    assert list(got) == list(want) == ["stream_serialized",
                                       "stream_depth_4"]
    for key in got:
        assert got[key]["matches_serialized"], key
        assert got[key]["picks_equal_serialized"], key
        assert want[key]["matches_serialized"], key
        assert got[key]["granted"] == want[key]["granted"] > 0, key
        assert got[key]["final_running"] == want[key]["final_running"], key
