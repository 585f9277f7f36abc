#!/bin/bash
# Phases 3-4 of chip_smoke.py (auto policy, pipelined and synchronous)
# from other checkouts and from this one, in turns on one card.  With no
# arguments the turns are parent, change, change, parent; arguments name
# the turns instead: "change" is this checkout, any other name NAME the
# checkout in .verify_scratch/NAME.  Prepare the other checkouts first,
# inside a directory .gitignore lists (so a chip call copies it):
#
#     mkdir -p .verify_scratch/parent
#     git archive <parent commit> | tar -x -C .verify_scratch/parent
#     bash chip_ab.sh                      # or: bash chip_ab.sh parent change ...
#
# Each run prints the phases' report lines and one "AB {json}" line,
# prefixed with the turn's name.
set -e
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
ROOT=$(pwd)
TURNS=("$@")
[ ${#TURNS[@]} -gt 0 ] || TURNS=(parent change change parent)
for which in "${TURNS[@]}"; do
  if [ "$which" = change ]; then dir=$ROOT; else dir=$ROOT/.verify_scratch/$which; fi
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
