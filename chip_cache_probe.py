#!/usr/bin/env python3
"""Where a cache fill's time goes on the host of the card: the port's
CacheService in process (no RPC) on a disk L2 of two shards and an
objstore L3, all under smoke_cache/probe in the checkout.

    python3 chip_cache_probe.py [PUTS]

It prints the time of the file operations one fill's L2 write makes
(mkdir of the fan-out dir, write of a temporary, rename), the time of a
PutEntry of one 6,000-byte value through the mock transport, a profile
of further puts by internal time, and the time to build the service
again over the entries (the startup scan, the manifest, the bucket's
listing and both filters).  The card is not used.
"""

from __future__ import annotations

import cProfile
import io
import logging
import pathlib
import pstats
import random
import shutil
import sys
import time

REPO = pathlib.Path(__file__).resolve().parent
ROOT = REPO / "smoke_cache" / "probe"


def main() -> int:
    from yadcc_tpu_torch import api
    from yadcc_tpu_torch.cache import entry
    from yadcc_tpu_torch.rpc import Channel, register_mock_server

    puts = int(sys.argv[1]) if len(sys.argv) > 1 else 2000
    logging.getLogger().setLevel(logging.WARNING)
    rng = random.Random(1)
    value = rng.randbytes(6000)
    shutil.rmtree(ROOT, ignore_errors=True)
    try:
        raw = ROOT / "raw"
        t0 = time.perf_counter()
        for i in range(puts):
            d = raw / f"{i % 16:x}" / f"{i // 16 % 16:x}"
            d.mkdir(parents=True, exist_ok=True)
            (d / f"f{i}.tmp").write_bytes(value)
            (d / f"f{i}.tmp").replace(d / f"f{i}")
        raw_ms = (time.perf_counter() - t0) / puts * 1e3

        args = entry.build_arg_parser().parse_args([
            "--cache-engine", "disk", "--cache-dirs",
            f"{ROOT}/a,{ROOT}/b", "--l3-engine", "objstore", "--l3-root",
            f"{ROOT}/l3", "--acceptable-servant-tokens", "s"])
        svc = entry.build_service(args)
        register_mock_server("probe", svc.spec())
        chan = Channel("mock://probe")
        keys = [f"ytpu-cxx2-entry-{rng.getrandbits(256):064x}"
                for _ in range(puts)]

        def fill(ks):
            for k in ks:
                chan.call("ytpu.CacheService", "PutEntry",
                          api.cache.PutEntryRequest(token="s", key=k),
                          api.cache.PutEntryResponse, attachment=value)

        cut = puts * 3 // 4
        t0 = time.perf_counter()
        fill(keys[:cut])
        put_ms = (time.perf_counter() - t0) / cut * 1e3
        svc.drain_l3_for_testing(60)
        prof = cProfile.Profile()
        prof.enable()
        fill(keys[cut:])
        prof.disable()
        svc.drain_l3_for_testing(60)
        svc.stop()
        t0 = time.perf_counter()
        entry.build_service(args).stop()
        boot_s = time.perf_counter() - t0
        print(f"mkdir+write+rename {raw_ms:.3f} ms; PutEntry in process "
              f"{put_ms:.3f} ms; the service built again over {puts:,} "
              f"entries in {boot_s:.2f} s", flush=True)
        out = io.StringIO()
        pstats.Stats(prof, stream=out).sort_stats("tottime").print_stats(14)
        print(out.getvalue())
    finally:
        shutil.rmtree(ROOT, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
