"""Scheduler trace replay: the greedy-versus-device A/B harness (a copy of
the JAX package's yadcc_tpu/tools/trace_replay.py).

BASELINE.json configs[1]: "recorded scheduler trace replay: 6k tasks x
128 workers, greedy-vs-JAX A/B".  A trace is a JSONL file of dispatch
micro-batches:

    {"kind": "pool", "servants": [{"capacity": 16, "dedicated": false,
        "version": 1, "envs": [0, 3]}, ...]}
    {"kind": "batch", "requests": [[env_id, min_version, requestor], ...]}
    {"kind": "free", "fraction": 0.5}   # each servant frees floor(r*f)

Replaying runs every batch through each policy of the panel against the
*same* evolving pool state, checks outcome equivalence (same per-batch
grant multiset per consecutive-descriptor run, same running vector — the
CLI exits non-zero on divergence), and reports throughput per policy
(warmup untimed).  The panel is ``greedy_cpu``, ``torch_batched`` (K2,
ops/cuda_assign.py), ``torch_grouped`` (K1, ops/cuda_grouped.py) and
``auto``, each on ``--device`` (the card unless the caller asks for the
CPU, where the device policies run their plain versions).

The trace generators and the key-trace loader use numpy only: the cache
server's prefetcher (cache/prefetcher.py) calls ``load_key_trace``, so
this module imports the policies, and with them torch, only inside the
replay functions.

CLI:
    python -m yadcc_tpu_torch.tools.trace_replay --generate trace.jsonl \\
        --tasks 6000 --servants 128
    python -m yadcc_tpu_torch.tools.trace_replay trace.jsonl [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import time
from collections import Counter
from typing import Dict, List

import numpy as np


def generate_trace(path: str, *, tasks: int = 6000, servants: int = 128,
                   batch: int = 64, envs: int = 16, seed: int = 0) -> None:
    rng = np.random.default_rng(seed)
    with open(path, "w") as fp:
        fp.write(json.dumps({
            "kind": "pool",
            "servants": [
                {
                    "capacity": int(rng.integers(4, 32)),
                    "dedicated": bool(rng.random() < 0.3),
                    "version": 1,
                    "envs": sorted(set(
                        int(e) for e in rng.integers(0, envs, 3))),
                }
                for _ in range(servants)
            ],
        }) + "\n")
        emitted = 0
        while emitted < tasks:
            n = min(batch, tasks - emitted)
            # Bursty env distribution: a few long runs per batch.
            reqs = []
            while len(reqs) < n:
                env = int(rng.integers(0, envs))
                run = int(rng.integers(1, max(2, n - len(reqs) + 1)))
                reqs.extend([[env, 1, -1]] * min(run, n - len(reqs)))
            fp.write(json.dumps({"kind": "batch", "requests": reqs}) + "\n")
            emitted += n
            # FreeTask stream: roughly half of each servant's running
            # grants complete between batches.
            fp.write(json.dumps({"kind": "free", "fraction": 0.5}) + "\n")


def _load(path: str) -> List[dict]:
    with open(path) as fp:
        return [json.loads(line) for line in fp if line.strip()]


# -- cache key histories (the prefetch trace; cache/prefetcher.py) ---------
#
# A key trace is the same JSONL discipline as the dispatch trace, one
# event kind: {"kind": "key", "key": "ytpu-..."}.  Production daemons
# would append one line per cache lookup; here generate_key_trace
# synthesizes "yesterday" with the Zipf-ish popularity skew real build
# key streams show (a small hot set dominates).

_MAX_TRACE_KEYS = 1_000_000


def generate_key_trace(path: str, *, keys: int = 1000, draws: int = 10000,
                       zipf_a: float = 1.3, seed: int = 0,
                       prefix: str = "ytpu-sim-entry-") -> List[str]:
    """Write a synthetic key-stream trace; returns the key universe.
    Popularity is Zipf(zipf_a) over the universe so the replayed stream
    has the hot-set structure prefetch exploits."""
    rng = np.random.default_rng(seed)
    universe = [f"{prefix}{i:08d}" for i in range(keys)]
    ranks = rng.zipf(zipf_a, size=draws)
    with open(path, "w") as fp:
        for r in ranks:
            key = universe[int(r - 1) % keys]
            fp.write(json.dumps({"kind": "key", "key": key}) + "\n")
    return universe


def load_key_trace(path: str, max_keys: int = _MAX_TRACE_KEYS) -> List[str]:
    """Key stream from a trace file, in recorded order.  Replayed input:
    every key passes the prefetcher's key-domain sanitizer and the count
    is capped — a corrupt or hostile trace degrades to fewer keys, never
    to arbitrary object names or an unbounded list."""
    from ..cache.prefetcher import sanitize_prefetch_key

    out: List[str] = []
    with open(path) as fp:
        for line in fp:
            if not line.strip():
                continue
            try:
                ev = json.loads(line)
            except json.JSONDecodeError:
                continue
            if ev.get("kind") != "key":
                continue
            key = sanitize_prefetch_key(ev.get("key"))
            if key is not None:
                out.append(key)
            if len(out) >= max_keys:
                break
    return out


def _snapshot_from_pool(pool_ev: dict):
    from ..scheduler.policy import PoolSnapshot

    servants = pool_ev["servants"]
    s = len(servants)
    max_env = max((e for x in servants for e in x["envs"]), default=0)
    env_words = max(8, (max_env >> 5) + 1)
    snap = PoolSnapshot(
        alive=np.ones(s, bool),
        capacity=np.array([x["capacity"] for x in servants], np.int32),
        running=np.zeros(s, np.int32),
        dedicated=np.array([x["dedicated"] for x in servants], bool),
        version=np.array([x["version"] for x in servants], np.int32),
        env_bitmap=np.zeros((s, env_words), np.uint32),
    )
    for i, x in enumerate(servants):
        for e in x["envs"]:
            snap.env_bitmap[i, e >> 5] |= np.uint32(1 << (e & 31))
    return snap


def _run_multisets(requests, picks: List[int]) -> List[Counter]:
    """Grant multisets per consecutive-descriptor run (the equivalence
    granularity: identical requests are interchangeable)."""
    out: List[Counter] = []
    prev_key = None
    for r, p in zip(requests, picks):
        key = (r.env_id, r.min_version, r.requestor_slot)
        if key != prev_key:
            out.append(Counter())
            prev_key = key
        if p >= 0:
            out[-1][p] += 1
    return out


def policy_panel(device="cuda") -> Dict[str, object]:
    """The replay's policies, each once, on ``device``: the greedy CPU
    oracle, the exact scan (K2), the grouped search (K1), and ``auto``
    (greedy for tiny backlogs, the grouped kernel for deep ones; its A/B
    contract is `auto >= max(greedy, device)` within noise).  On one card
    the JAX package's sharded and Pallas variants are these same kernels
    (README's name table), so they do not join the panel."""
    from ..scheduler.policy import (AutoPolicy, GreedyCpuPolicy,
                                    TorchBatchedPolicy, TorchGroupedPolicy)

    return {
        "greedy_cpu": GreedyCpuPolicy(),
        "torch_batched": TorchBatchedPolicy(device),
        "torch_grouped": TorchGroupedPolicy(device),
        "auto": AutoPolicy(device),
    }


def replay(path: str, policies: Dict[str, object] | None = None,
           device="cuda") -> dict:
    from ..scheduler.policy import AssignRequest

    events = _load(path)
    assert events and events[0]["kind"] == "pool", "trace must open with pool"
    if policies is None:
        from ..device import resolve_device

        policies = policy_panel(resolve_device(str(device)))

    results = {}
    reference_outcomes = None
    for name, policy in policies.items():
        snap = _snapshot_from_pool(events[0])
        # Untimed warmup: the device policies build their kernels and size
        # the allocator on their first calls, which must not skew the A/B
        # throughput.  warmup() covers every padded group-count shape for
        # the pool size (the production path the scheduler entry uses);
        # the assign probes additionally warm batch-shape-dependent paths
        # — counts chosen so their run counts pad to 4/8/16/32/64.
        # Policies only mutate their own running copy, so a fresh
        # snapshot for the real run is all the isolation needed.
        policy.warmup(len(snap.alive),
                      env_words=snap.env_bitmap.shape[1])
        for n in (1, 6, 12, 24, 48):
            policy.assign(snap, [AssignRequest(e, 1, -1)
                                 for e in range(n)])
        snap = _snapshot_from_pool(events[0])
        outcomes = []
        granted = 0
        t0 = time.perf_counter()
        for ev in events[1:]:
            if ev["kind"] == "free":
                # Deterministic and identical across policies (running
                # vectors agree while policies stay equivalent).
                snap.running -= (
                    snap.running * ev["fraction"]).astype(np.int32)
            elif ev["kind"] == "batch":
                reqs = [AssignRequest(*r) for r in ev["requests"]]
                picks = policy.assign(snap, reqs)
                for p in picks:
                    if p >= 0:
                        snap.running[p] += 1
                        granted += 1
                outcomes.append(_run_multisets(reqs, picks))
        elapsed = time.perf_counter() - t0
        results[name] = {
            "granted": granted,
            "seconds": round(elapsed, 4),
            "assignments_per_sec": round(granted / elapsed, 1),
            "final_running": int(snap.running.sum()),
        }
        if reference_outcomes is None:
            reference_outcomes = outcomes
            results[name]["matches_reference"] = True
        else:
            results[name]["matches_reference"] = (
                outcomes == reference_outcomes)
    return results


def replay_stream(path: str, depths=(0, 16), horizon: int = 16,
                  device="cuda") -> dict:
    """Replay the trace through the PIPELINED policy stream and prove
    outcome equivalence against the serialized run.

    Free events are interpreted architecture-faithfully: the host
    frees grants it has already collected (a task cannot complete
    before its grant was even delivered), restricted to grants from
    batches at least `horizon` launches old.  With horizon >= depth the
    free schedule is identical for EVERY pipeline depth, so the
    serialized (depth 0) and deep-pipeline runs must produce
    bit-identical pick streams — the invariant that makes pipelining
    safe to enable: it changes throughput, never outcomes.  Each depth's
    result holds that twice: ``matches_serialized`` (per-run grant
    multisets and the final running vector, as the JAX package checks)
    and ``picks_equal_serialized`` (every pick, in order).  Every launch
    is one call of K1's stream wrapper (cuda_assign_grouped_picks_stream)
    on the card."""
    import collections

    from ..device import resolve_device
    from ..scheduler.policy import (AssignRequest, PoolSnapshot,
                                    TorchGroupedPolicy, compress_runs)

    dev = resolve_device(str(device))
    events = _load(path)
    assert events and events[0]["kind"] == "pool"
    snap0 = _snapshot_from_pool(events[0])
    s = len(snap0.alive)

    def run(depth: int):
        policy = TorchGroupedPolicy(dev)
        policy.stream_warmup(s, env_words=snap0.env_bitmap.shape[1])
        host_running = np.zeros(s, np.int32)
        snap = PoolSnapshot(
            alive=snap0.alive, capacity=snap0.capacity,
            running=host_running, dedicated=snap0.dedicated,
            version=snap0.version, env_bitmap=snap0.env_bitmap)
        policy.stream_begin(snap)
        adj = np.zeros(s, np.int64)
        tickets = collections.deque()
        # Grants by age: batch index -> [slots]; freeable once the
        # batch is `horizon` behind.
        live_by_batch: "collections.OrderedDict" = collections.OrderedDict()
        outcomes = []
        pick_stream: List[int] = []
        granted = 0
        batch_idx = 0

        def drain_one():
            nonlocal granted
            bi, reqs, ticket = tickets.popleft()
            picks = [int(p) for p in
                     policy.stream_collect(ticket)[:len(reqs)]]
            pick_stream.extend(picks)
            grants = live_by_batch.setdefault(bi, [])
            for p in picks:
                if p >= 0:
                    host_running[p] += 1
                    grants.append(p)
                    granted += 1
            outcomes.append(_run_multisets(reqs, picks))

        t0 = time.perf_counter()
        for ev in events[1:]:
            if ev["kind"] == "batch":
                reqs = [AssignRequest(*r) for r in ev["requests"]]
                ticket = policy.stream_launch(
                    snap, compress_runs(reqs), adj, {})
                adj[:] = 0
                tickets.append((batch_idx, reqs, ticket))
                batch_idx += 1
                while len(tickets) > depth:
                    drain_one()
            elif ev["kind"] == "free":
                # Everything freeable must be drained first — enforced
                # structurally when depth <= horizon.
                while tickets and tickets[0][0] <= batch_idx - horizon:
                    drain_one()
                freeable = []
                for bi in list(live_by_batch):
                    if bi <= batch_idx - horizon:
                        freeable.extend(
                            (bi, p) for p in live_by_batch[bi])
                k = int(len(freeable) * ev["fraction"])
                for bi, slot in freeable[:k]:
                    live_by_batch[bi].remove(slot)
                    host_running[slot] -= 1
                    adj[slot] -= 1
        while tickets:
            drain_one()
        elapsed = time.perf_counter() - t0
        return outcomes, granted, elapsed, host_running.copy(), pick_stream

    results = {}
    ref = None
    for depth in depths:
        outcomes, granted, elapsed, final_running, picks = run(depth)
        key = f"stream_depth_{depth}" if depth else "stream_serialized"
        results[key] = {
            "granted": granted,
            "seconds": round(elapsed, 4),
            "assignments_per_sec": round(granted / elapsed, 1),
            "final_running": int(final_running.sum()),
        }
        if ref is None:
            ref = (outcomes, final_running.tolist(), picks)
            results[key]["matches_serialized"] = True
            results[key]["picks_equal_serialized"] = True
        else:
            results[key]["matches_serialized"] = (
                outcomes == ref[0]
                and final_running.tolist() == ref[1])
            results[key]["picks_equal_serialized"] = picks == ref[2]
    return results


def main(argv=None) -> None:
    ap = argparse.ArgumentParser("ytpu-torch-trace-replay")
    ap.add_argument("trace")
    ap.add_argument("--generate", action="store_true")
    ap.add_argument("--tasks", type=int, default=6000)
    ap.add_argument("--servants", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--no-stream", action="store_true",
                    help="skip the pipelined-stream equivalence section")
    ap.add_argument("--device", default="cuda",
                    help="where the device policies run: cuda (the "
                         "default; raises without a card) or cpu (their "
                         "plain versions)")
    args = ap.parse_args(argv)
    if args.generate:
        generate_trace(args.trace, tasks=args.tasks,
                       servants=args.servants, seed=args.seed)
        print(f"wrote {args.trace}")
        return
    import torch

    from ..device import resolve_device

    dev = resolve_device(args.device)
    results = replay(args.trace, device=dev)
    if not args.no_stream:
        results["pipelined"] = replay_stream(args.trace, device=dev)
    results["_meta"] = {
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
    }
    print(json.dumps(results, indent=2))
    if not all(r["matches_reference"] for r in results.values()
               if isinstance(r, dict) and "matches_reference" in r):
        raise SystemExit("POLICY DIVERGENCE: outcomes differ from reference")
    if not all(r.get("matches_serialized", True)
               and r.get("picks_equal_serialized", True)
               for r in results.get("pipelined", {}).values()
               if isinstance(r, dict)):
        raise SystemExit(
            "STREAM DIVERGENCE: pipelined outcomes differ from serialized")


if __name__ == "__main__":
    main()
