#!/bin/bash
# Phases 3-4 of chip_smoke.py (auto policy, pipelined and synchronous)
# from a second checkout and from this one, in turns on one card:
# parent, change, change, parent.  Prepare the second checkout first,
# inside a directory .gitignore lists (so a chip call copies it):
#
#     mkdir -p .verify_scratch/parent
#     git archive <parent commit> | tar -x -C .verify_scratch/parent
#     bash chip_ab.sh
#
# Each run prints the phases' report lines and one "AB {json}" line,
# prefixed with [parent] or [change].
set -e
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
ROOT=$(pwd)
for which in parent change change parent; do
  if [ $which = parent ]; then dir=$ROOT/.verify_scratch/parent; else dir=$ROOT; fi
  (cd $dir && python3 - <<'PY'
import json, sys
sys.path.insert(0, ".")
import chip_smoke as c
out = {}
for name, args, seed in (("pipelined", [], 1), ("synchronous", ["--dispatch-pipeline-depth", "0"], 2)):
    r = []
    res = c.run_main_path(name, args, c.Fleet(seed=seed), r)
    out[name] = {k: res[k] for k in ("grants_per_s", "p50_ms", "p99_ms", "register_s", "launches")}
    print("\n".join(x for x in r if "stages" not in x), flush=True)
print("AB", json.dumps(out), flush=True)
PY
  ) | sed "s/^/[$which] /"
done
