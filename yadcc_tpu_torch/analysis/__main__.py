"""CLI: ``python -m yadcc_tpu_torch.analysis [paths...]``.

Exit status: 0 = clean (no unsuppressed findings), 1 = findings,
2 = usage error.  The default path is ``yadcc_tpu_torch``.

Incremental-rollout / performance surface:

    --baseline FILE         ignore findings recorded in FILE
    --write-baseline FILE   record current findings and exit 0
    --stats                 per-rule-family timing + cache hit rate
    --sarif FILE            SARIF 2.1.0 report (CI code annotations)
    --no-cache / --cache P  content-hash result cache control
    --wire-golden FILE      golden wire descriptor (default: packaged)
    --update-wire-golden    re-pin the golden from api/gen and exit
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from . import minitoml, wirecompat
from .core import RULES, AnalyzerConfig, analyze_paths, baseline_key

_DEFAULT_HIERARCHY = os.path.join(os.path.dirname(__file__),
                                  "lock_hierarchy.toml")
_DEFAULT_GOLDEN = os.path.join(os.path.dirname(__file__),
                               "wire_golden.json")


def _load_ranks(path: str) -> dict:
    doc = minitoml.load_path(path)
    ranks = doc.get("rank", {})
    bad = {k: v for k, v in ranks.items() if not isinstance(v, int)}
    if bad:
        raise minitoml.MiniTomlError(
            f"[rank] values must be integers: {sorted(bad)}")
    return dict(ranks)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m yadcc_tpu_torch.analysis",
        description="AST-based concurrency, jit-discipline, taint, "
                    "resource-lifecycle and wire-compat analyzer "
                    "of the PyTorch port")
    ap.add_argument("paths", nargs="*", default=["yadcc_tpu_torch"],
                    help="files or directories to analyze "
                         "(default: yadcc_tpu_torch)")
    ap.add_argument("--hierarchy", default=_DEFAULT_HIERARCHY,
                    help="lock hierarchy TOML (default: the package's "
                         "lock_hierarchy.toml)")
    ap.add_argument("--json", dest="json_out", default=None,
                    help="write the findings report to this path")
    ap.add_argument("--sarif", dest="sarif_out", default=None,
                    help="write a SARIF 2.1.0 report to this path "
                         "(CI annotations)")
    ap.add_argument("--show-suppressed", action="store_true",
                    help="also print suppressed findings")
    ap.add_argument("--strict-suppressions", action="store_true",
                    help="fail on suppressions that matched nothing")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule catalog and exit")
    ap.add_argument("--baseline", default=None,
                    help="ignore findings recorded in this file "
                         "(incremental rollout)")
    ap.add_argument("--write-baseline", default=None,
                    help="record current unsuppressed findings to this "
                         "file and exit 0")
    ap.add_argument("--stats", action="store_true",
                    help="print per-rule-family timings and cache "
                         "hit rate")
    ap.add_argument("--no-cache", action="store_true",
                    help="disable the content-hash result cache")
    ap.add_argument("--cache", dest="cache_path", default=None,
                    help="result cache location (default: "
                         "~/.cache/ytpu-torch-analyze/cache.json)")
    ap.add_argument("--wire-golden", default=None,
                    help="golden wire descriptor JSON (default: the "
                         "package's analysis/wire_golden.json when it "
                         "exists)")
    ap.add_argument("--update-wire-golden", action="store_true",
                    help="re-pin the golden descriptor from the "
                         "analyzed tree's api/gen modules and exit")
    args = ap.parse_args(argv)

    if args.list_rules:
        for rule, desc in sorted(RULES.items()):
            print(f"{rule:24s} {desc}")
        return 0

    try:
        ranks = _load_ranks(args.hierarchy)
    except (OSError, minitoml.MiniTomlError) as e:
        print(f"cannot load lock hierarchy {args.hierarchy}: {e}",
              file=sys.stderr)
        return 2
    for p in args.paths:
        if not os.path.exists(p):
            print(f"no such path: {p}", file=sys.stderr)
            return 2

    if args.update_wire_golden:
        api_dirs = wirecompat.find_api_dirs(args.paths)
        if not api_dirs:
            print("no api/protos tree under the analyzed paths",
                  file=sys.stderr)
            return 2
        golden = wirecompat.build_golden(api_dirs)
        out = args.wire_golden or _DEFAULT_GOLDEN
        with open(out, "w", encoding="utf-8") as fp:
            json.dump(golden, fp, indent=1, sort_keys=True)
            fp.write("\n")
        print(f"pinned {sum(len(v['messages']) for v in golden.values())}"
              f" messages across {len(golden)} protos into {out}")
        return 0

    wire_golden = args.wire_golden
    if wire_golden is None and os.path.exists(_DEFAULT_GOLDEN):
        wire_golden = _DEFAULT_GOLDEN

    config = AnalyzerConfig(
        lock_ranks=ranks,
        strict_suppressions=args.strict_suppressions,
        wire_golden=wire_golden)

    cache = None
    if not args.no_cache:
        from .cache import ResultCache

        cache = ResultCache(args.cache_path)
    findings, stats = analyze_paths(args.paths, config, cache=cache)
    if cache is not None:
        cache.save()

    if args.write_baseline:
        keys = sorted({baseline_key(f) for f in findings
                       if not f.suppressed})
        with open(args.write_baseline, "w", encoding="utf-8") as fp:
            fp.write("\n".join(keys) + ("\n" if keys else ""))
        print(f"wrote {len(keys)} baseline entr"
              f"{'y' if len(keys) == 1 else 'ies'} to "
              f"{args.write_baseline}")
        return 0

    baselined = 0
    if args.baseline:
        try:
            with open(args.baseline, "r", encoding="utf-8") as fp:
                allow = {line.strip() for line in fp if line.strip()}
        except OSError as e:
            print(f"cannot load baseline {args.baseline}: {e}",
                  file=sys.stderr)
            return 2
        for f in findings:
            if not f.suppressed and baseline_key(f) in allow:
                f.suppressed = True
                baselined += 1
        stats["findings"] -= baselined
        stats["suppressed"] += baselined
    stats["baselined"] = baselined

    for f in findings:
        if f.suppressed and not args.show_suppressed:
            continue
        tag = " (suppressed)" if f.suppressed else ""
        print(f.render() + tag)
    line = (f"ytpu-analyze: {stats['files_analyzed']} files, "
            f"{stats['findings']} finding(s), "
            f"{stats['suppressed']} suppressed")
    if baselined:
        line += f" ({baselined} baselined)"
    print(line)

    if args.stats:
        print(f"cache: {stats['cache_hits']}/{stats['files_analyzed']} "
              f"file hits")
        for name, secs in sorted(stats["timings"].items(),
                                 key=lambda kv: -kv[1]):
            print(f"  {name:16s} {secs * 1000:8.1f} ms")

    if args.json_out:
        report = {
            "version": 2,
            "stats": stats,
            "findings": [f.as_dict() for f in findings],
        }
        with open(args.json_out, "w", encoding="utf-8") as fp:
            json.dump(report, fp, indent=2, sort_keys=True)
            fp.write("\n")

    if args.sarif_out:
        from . import sarif

        with open(args.sarif_out, "w", encoding="utf-8") as fp:
            json.dump(sarif.to_sarif(findings), fp, indent=2,
                      sort_keys=True)
            fp.write("\n")

    return 1 if stats["findings"] else 0


if __name__ == "__main__":
    sys.exit(main())
