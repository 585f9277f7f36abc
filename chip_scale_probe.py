#!/usr/bin/env python3
"""Where phase 16's host time goes, on the card: for the trace replay, how
`auto` routes the trace's batches (its calibrated crossover against the
batches' sizes and runs) and what one batch costs on the greedy route and
on the grouped device route (K1); for the pod simulation (16c), the
slowest policy and snapshot cycles and where in the run they fall.

Run from the root of a checkout on a machine with one NVIDIA card:

    python3 chip_scale_probe.py [REPEATS]

It prints one JSON line a trace width and one a pod run (REPEATS runs,
default 2), at chip_smoke.py's phase-16 sizes.
"""

from __future__ import annotations

import json
import logging
import sys
import time

import numpy as np
import torch

import chip_smoke as c

BATCHES_TIMED = 40   # the trace's first batches, each on a fresh pool


def replay_routes(dev, servants: int) -> dict:
    from yadcc_tpu_torch.scheduler import policy as pol
    from yadcc_tpu_torch.tools import trace_replay as tr

    path = c.LOG_DIR / f"probe_trace_{servants}.jsonl"
    tr.generate_trace(str(path), servants=servants, **c.SCALE_TRACE)
    auto = pol.AutoPolicy(dev)
    seen = {"greedy": [], "device": []}
    assign = auto.assign

    def routed(snap, requests):
        route = ("greedy" if auto._use_greedy(snap, len(requests))
                 else "device")
        seen[route].append((len(requests),
                            len(pol.compress_runs(requests))))
        return assign(snap, requests)

    auto.assign = routed
    panel = tr.policy_panel(dev)
    panel["auto"] = auto
    out = tr.replay(str(path), panel)
    events = tr._load(str(path))
    batches = [[pol.AssignRequest(*r) for r in ev["requests"]]
               for ev in events[1:] if ev["kind"] == "batch"]
    per_batch = {}
    for name, p in (("greedy", pol.GreedyCpuPolicy()),
                    ("grouped", pol.TorchGroupedPolicy(dev))):
        p.warmup(servants)
        ts = []
        for reqs in batches[:BATCHES_TIMED]:
            snap = tr._snapshot_from_pool(events[0])
            t0 = time.perf_counter()
            p.assign(snap, reqs)
            ts.append(time.perf_counter() - t0)
        per_batch[name] = {"p50_ms": float(np.percentile(ts, 50)) * 1e3,
                           "p90_ms": float(np.percentile(ts, 90)) * 1e3}
    return {
        "servants": servants,
        "auto_threshold_requests": auto._measured_threshold,
        "auto_routes": {k: len(v) for k, v in seen.items()},
        "mean_requests_runs": {
            k: [float(np.mean([x[i] for x in v])) for i in (0, 1)]
            if v else None for k, v in seen.items()},
        "assignments_per_sec": {k: v["assignments_per_sec"]
                                for k, v in out.items()},
        "per_batch": per_batch,
    }


def pod_cycles(dev, rep: int) -> dict:
    from yadcc_tpu_torch.tools import pod_sim

    sim = pod_sim.PodSim(c.SCALE_POD_SERVANTS, device=dev, **c.SCALE_POD)
    out = sim.run(c.SCALE_POD_TASKS, c.SCALE_POD_DUP, c.SCALE_POD_SUBMITTERS)
    samples = sim.dispatcher.stage_timer.samples()
    policy_s, cycles = samples["policy"]
    snapshot_s, _ = samples["snapshot"]
    slowest = np.argsort(policy_s)[-6:][::-1]
    return {
        "rep": rep,
        "tasks_per_sec": out["tasks_per_sec"],
        "grant_call_p50_ms": out["grant_call_p50_ms"],
        "grant_call_p99_ms": out["grant_call_p99_ms"],
        "cycles": int(cycles),
        "auto_threshold_requests": sim.dispatcher._policy._measured_threshold,
        # (cycle index in the run, ms): cycles are numbered from the start.
        "slowest_policy_cycles": [(int(i), round(float(policy_s[i]) * 1e3, 2))
                                  for i in slowest],
        "policy_p50_ms_after_cycle_20": round(
            float(np.percentile(policy_s[20:], 50)) * 1e3, 3),
        "slowest_snapshot_ms": sorted(
            (round(float(x) * 1e3, 2) for x in snapshot_s), reverse=True)[:6],
    }


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_scale_probe: no CUDA device", file=sys.stderr)
        return 2
    repeats = int(sys.argv[1]) if len(sys.argv) > 1 else 2
    print(c.card_line(), flush=True)
    c.build_kernels()
    c.LOG_DIR.mkdir(exist_ok=True)
    dev = torch.device("cuda")
    for _, servants in c.SCALE_TRACE_SERVANTS:
        print(json.dumps(replay_routes(dev, servants)), flush=True)
    logging.getLogger().setLevel(logging.WARNING)
    for rep in range(repeats):
        print(json.dumps(pod_cycles(dev, rep)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
