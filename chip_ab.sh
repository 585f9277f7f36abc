#!/bin/bash
# Phases 3-4 of chip_smoke.py (auto policy, pipelined and synchronous)
# from other checkouts and from this one, in turns on one card.  With no
# arguments the turns are parent, change, change, parent; arguments name
# the turns instead: "change" is this checkout, any other name NAME the
# checkout in .verify_scratch/NAME.  A first argument --batched adds phase
# 5 (torch_batched, every grant through K2) to every turn, with its
# policy stage split into K2's share (K2 launches a cycle x K2's time on
# two runs of 128 on the serving-like pool, timed in the same turn) and
# the rest.  --resident adds phase 6 (torch_resident_grouped, pipeline
# depth 16, K1 on the device-resident pool) the same way; --batched and
# --resident together give phases 3-6.  A first argument --burst runs
# phase 12's burst of 2,000
# parked waits instead, with this checkout's rig (chip_smoke.py) in every
# turn and only the scheduler entry taken from the turn's checkout, and
# prints one "AB {json}" line a turn with the park time, the burst's time
# and the entry's threads (a burst the rig sees end early prints its
# error).  Prepare the other checkouts first, inside a directory
# .gitignore lists (so a chip call copies it):
#
#     mkdir -p .verify_scratch/parent
#     git archive <parent commit> | tar -x -C .verify_scratch/parent
#     bash chip_ab.sh                      # or: bash chip_ab.sh parent change ...
#     bash chip_ab.sh --batched            # phases 3-5
#     bash chip_ab.sh --batched --resident # phases 3-6
#     bash chip_ab.sh --burst              # phase 12's burst
#
# Each run prints the phases' report lines and one "AB {json}" line
# (each phase's grants/s, p50/p99, policy stage and wall seconds),
# prefixed with the turn's name.
set -e
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
ROOT=$(pwd)
BATCHED=0
RESIDENT=0
BURST=0
while [ "${1:-}" = --batched ] || [ "${1:-}" = --resident ] || [ "${1:-}" = --burst ]; do
  case "$1" in
    --batched) BATCHED=1 ;;
    --resident) RESIDENT=1 ;;
    --burst) BURST=1 ;;
  esac
  shift
done
TURNS=("$@")
[ ${#TURNS[@]} -gt 0 ] || TURNS=(parent change change parent)
for which in "${TURNS[@]}"; do
  if [ "$which" = change ]; then dir=$ROOT; else dir=$ROOT/.verify_scratch/$which; fi
  if [ $BURST = 1 ]; then
  AB_DIR=$dir python3 - <<'PY' | sed "s/^/[$which] /"
import json, os, pathlib
import chip_smoke as c
r = []
try:
    res = c.run_parked_burst(r, repo=pathlib.Path(os.environ["AB_DIR"]))
    out = {k: res[k] for k in ("park_s", "burst_s", "threads_before",
                               "threads_parked", "rss_kb_per_wait")}
except c.SmokeFailure as e:
    out = {"failed": str(e)}
print("\n".join(r), flush=True)
print("AB", json.dumps(out), flush=True)
PY
  continue
  fi
  (cd $dir && AB_BATCHED=$BATCHED AB_RESIDENT=$RESIDENT python3 - <<'PY'
import json, os, sys, time
sys.path.insert(0, ".")
import chip_smoke as c
phases = [("pipelined", [], 1, {}), ("synchronous", ["--dispatch-pipeline-depth", "0"], 2, {})]
if os.environ["AB_BATCHED"] == "1":
    phases.append(("batched", ["--dispatch-policy", "torch_batched"], 3, {"kernel": "assign_batch"}))
if os.environ["AB_RESIDENT"] == "1":
    phases.append(("resident", ["--dispatch-policy", "torch_resident_grouped", "--dispatch-pipeline-depth", "16"], 4, {"min_grants": c.RESIDENT_MIN_GRANTS}))
out = {}
for name, args, seed, kw in phases:
    r = []
    t0 = time.perf_counter()
    res = c.run_main_path(name, args, c.Fleet(seed=seed), r, **kw)
    out[name] = {k: res[k] for k in ("grants_per_s", "p50_ms", "p99_ms", "register_s", "launches")}
    out[name]["wall_s"] = time.perf_counter() - t0
    head = f"  {name} dispatcher stages: "
    stages = json.loads(next(x for x in r if x.startswith(head))[len(head):])
    out[name]["policy"] = stages["policy"]
    print("\n".join(x for x in r if "stages" not in x), flush=True)
if "batched" in out:
    # K2 on the serving path's chunk: two runs of 128 identical requests.
    import numpy as np
    import torch
    from yadcc_tpu_torch.ops import assignment as asn
    from yadcc_tpu_torch.ops import cuda_assign as ka
    sp = c.serving_pool(np.random.default_rng(8))
    pool = asn.pool_from_numpy(*(sp[k] for k in asn.PoolArrays._fields), "cuda")
    srng = np.random.default_rng(10)
    runs = [(int(srng.integers(0, c.N_ENVS)), 0, int(srng.integers(0, c.N_SERVANTS))) for _ in range(2)]
    tasks = [runs[0]] * 128 + [runs[1]] * 128
    batch = asn.make_batch(*([x[i] for x in tasks] for i in range(3)), len(tasks), "cuda")
    k2_ms = c.timed(lambda: ka.cuda_assign_batch(pool, batch), 50)
    b = out["batched"]
    per_cycle = b["launches"]["assign_batch"] / b["policy"]["count"]
    b.update(k2_ms=k2_ms, k2_launches_per_cycle=per_cycle,
             policy_p50_k2_ms=per_cycle * k2_ms,
             policy_p50_rest_ms=b["policy"]["p50_ms"] - per_cycle * k2_ms)
print("AB", json.dumps(out), flush=True)
PY
  ) | sed "s/^/[$which] /"
done
