#!/usr/bin/env python3
"""Where phase 8's overlap probe (chip_smoke.measure_shard_overlap) spends
its time, on the card.

1. In fresh processes, one after the other: `import torch`, `import
   torch._inductor`, and torch.profiler's first start and stop with the
   CUDA activity after a CUDA init (each process's wall and the start's
   own seconds).
2. In this process, after the kernels are built: the probe with nothing
   imported ahead, so its window stage carries the profiler's first
   start while the probe's 24 delegate threads run; then the probe with
   the device events read through `prof.events()` (the function-event
   tree) and through the raw kineto results (`chip_smoke.device_spans`,
   what the smoke reads), each with its stages.

Run from the repository root on a machine with one card:

    python3 chip_overlap_probe.py        # about 2 minutes

It prints the card's name and power limit first and one line a
measurement.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

FIRST_START = r"""
import time
t0 = time.perf_counter()
import torch
from torch.profiler import ProfilerActivity, profile
torch.zeros(1, device="cuda")
torch.cuda.synchronize()
t1 = time.perf_counter()
p = profile(activities=[ProfilerActivity.CUDA])
p.start()
t2 = time.perf_counter()
p.stop()
print(f"{t1 - t0:.2f} {t2 - t1:.2f}")
"""


def fresh(code: str) -> tuple:
    """(wall seconds, stdout) of ``python -c code`` in a new process."""
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, check=True)
    return time.perf_counter() - t0, out.stdout.strip()


def function_event_spans(prof) -> list:
    """The device intervals read the way the probe read them until PR 21:
    through the profile's function-event tree."""
    from torch.autograd import DeviceType

    return [(e.name, e.time_range.start, e.time_range.end)
            for e in prof.events() if e.device_type == DeviceType.CUDA]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_overlap_probe: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as c

    print(c.card_line(), flush=True)
    for name, code in (("import torch", "import torch"),
                       ("import torch._inductor",
                        "import torch, torch._inductor")):
        wall, _ = fresh(code)
        print(f"fresh process, {name}: {wall:.2f} s", flush=True)
    wall, out = fresh(FIRST_START)
    init_s, start_s = out.split()
    print(f"fresh process, torch.profiler's first start: {start_s} s after "
          f"{init_s} s of import and CUDA init ({wall:.2f} s in all)",
          flush=True)

    c.build_kernels()
    readers = (("prof.events(), nothing imported ahead",
                function_event_spans),
               ("prof.events()", function_event_spans),
               ("raw kineto results", c.device_spans))
    smoke_reader = c.device_spans
    try:
        for tag, reader in readers:
            c.device_spans = reader
            report: list = []
            t0 = time.perf_counter()
            res = c.measure_shard_overlap(report)
            print(f"probe, {tag}: {time.perf_counter() - t0:.2f} s; stages "
                  f"(s) {json.dumps(res['stages'])}; {res['grants']} grants, "
                  f"{res['k1_launches']} K1 launches", flush=True)
    finally:
        c.device_spans = smoke_reader
    return 0


if __name__ == "__main__":
    sys.exit(main())
