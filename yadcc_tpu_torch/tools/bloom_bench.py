"""BASELINE configs[3]: a 1M-key Bloom batch lookup on the card.

The counterpart of yadcc_tpu/tools/bloom_bench.py:run.  At the production
filter geometry (27,584,639 bits / 10 hashes, the reference's sizing,
yadcc/cache/bloom_filter_generator.h:64-68) and with production-format
keys (`ytpu-cxx2-entry-` + 64 hex characters, 80 bytes, so XXH64's
32-byte stripe loop runs), it sweeps 1%, 10% and 50% hit rates and times
two complete paths:

  * host-vectorized — pack, then the lane-parallel numpy XXH64 and split
                      (common/xxh64_np.py), the [N, 2] fingerprints
                      copied up, and the probe kernel (bloom_may_contain);
  * device-fused    — pack (pack_key_buckets), the host-to-device copy
                      of the packed key matrix, and ONE digest->split->
                      probe kernel (bloom_membership_from_keys); each
                      part timed on its own, and the whole front door
                      (bloom_membership_batch, bool[N] back) end to end.

Beside them, on the same batches: the two-filter cascade
(DeviceBloomCascade: region OR a fleet filter with its own salt and 7
hashes; a tenth of each batch's non-member keys are fleet keys), and
once, the filter built on the card by the scatter-OR kernel
(bloom_scatter_add) from the members' fingerprints.

Every path is checked before it is timed: members test positive, absent
keys are not all positive, and every verdict equals the host filter's
(SaltedBloomFilter.may_contain_batch; for the cascade the host OR; the
card-built words equal add_many's, bit for bit).  The JAX tool's
host-loop arm is left out: it timed the `xxhash` wheel's per-key call,
and the port does not import the wheel.

    python -m yadcc_tpu_torch.tools.bloom_bench [--keys N] [--populated N]
        [--device cuda]

Runs on the card, or raises without one; `--device cpu` runs the plain
versions on the CPU (times then come from the host clock and say so).
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Callable, List

import numpy as np
import torch

KEY_PREFIX = b"ytpu-cxx2-entry-"      # daemon/cache_format.py's C++ prefix
KEY_BYTES = len(KEY_PREFIX) + 64      # + a 256-bit digest in hex
HIT_RATES = (0.01, 0.10, 0.50)
SALT = 17
FLEET_SALT = (1 << 63) + 5            # puts seed_pair's hi word in play
FLEET_HASHES = 7
_HEX = np.frombuffer(b"0123456789abcdef", np.uint8)


def production_keys(n: int, seed: int) -> List[str]:
    """n production-format cache keys (prefix + 64 hex characters of
    seeded random bytes), made in bulk with numpy."""
    rng = np.random.default_rng(seed)
    raw = np.frombuffer(rng.bytes(32 * n), np.uint8).reshape(n, 32)
    mat = np.empty((n, KEY_BYTES), np.uint8)
    mat[:, :len(KEY_PREFIX)] = np.frombuffer(KEY_PREFIX, np.uint8)
    mat[:, len(KEY_PREFIX)::2] = _HEX[raw >> 4]
    mat[:, len(KEY_PREFIX) + 1::2] = _HEX[raw & 15]
    return [k.decode() for k in mat.view(f"S{KEY_BYTES}").ravel().tolist()]


class BenchCheckFailed(AssertionError):
    """A path's verdicts or words differ from the host filter's."""


def require(cond, msg: str) -> None:
    """Raise BenchCheckFailed unless ``cond`` (kept under python -O)."""
    if not cond:
        raise BenchCheckFailed(msg)


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def device_seconds(fn: Callable, dev: torch.device, reps: int) -> float:
    """Mean seconds of ``fn`` after one warm call: CUDA events on the
    card, the host clock on the CPU."""
    fn()
    sync(dev)
    if dev.type == "cuda":
        a, b = torch.cuda.Event(True), torch.cuda.Event(True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / 1e3 / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps


def host_seconds(fn: Callable, dev: torch.device, passes: int = 3):
    """(best seconds over ``passes`` calls, the last result) on the host
    clock, each call ended by a synchronize: for work that includes host
    code or copies."""
    best, out = float("inf"), None
    for _ in range(passes):
        t0 = time.perf_counter()
        out = fn()
        sync(dev)
        best = min(best, time.perf_counter() - t0)
    return best, out


def run(n_keys: int, populated: int, device: str = "cuda",
        reps: int = 20) -> dict:
    from ..cache.bloom_filter_generator import DeviceBloomCascade
    from ..common import bloom
    from ..common.xxh64_np import pack_key_matrix, xxh64_grouped
    from ..device import resolve_device
    from ..ops.bloom_pipeline import (as_device_words,
                                      bloom_cascade_from_keys,
                                      bloom_membership_batch,
                                      bloom_membership_from_keys,
                                      pack_key_buckets, seed_pair)
    from ..ops.bloom_probe import bloom_may_contain, bloom_scatter_add

    dev = resolve_device(device)
    f = bloom.SaltedBloomFilter(salt=SALT)  # production geometry
    member_keys = production_keys(populated, seed=1)
    f.add_many(member_keys)
    fleet_only = production_keys(max(1, populated // 2), seed=2)
    fleet = bloom.SaltedBloomFilter(num_hashes=FLEET_HASHES,
                                    salt=FLEET_SALT)
    fleet.add_many(fleet_only + member_keys[:populated // 10])
    words = as_device_words(f.words, dev)
    seed = seed_pair(SALT)
    nb, nh = f.num_bits, f.num_hashes

    # The filter built on the card from the members' fingerprints.
    member_fps = as_device_words(bloom.key_fingerprints(member_keys, SALT),
                                 dev)
    empty = torch.zeros_like(words)

    def build():
        return bloom_scatter_add(empty, member_fps, num_bits=nb,
                                 num_hashes=nh)

    built = build().cpu().numpy().view(np.uint32)
    require(np.array_equal(built, f.words),
            "card-built filter words differ from add_many's")
    t_build = device_seconds(build, dev, reps)
    del member_fps

    results = {
        "filter_bits": nb,
        "num_hashes": nh,
        "populated_keys": populated,
        "batch_keys": n_keys,
        "key_bytes": KEY_BYTES,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "timer": "cuda_events" if dev.type == "cuda" else "host_clock",
        "device_build": {"kernel_seconds": t_build,
                         "keys": populated},
        "sweep": [],
    }
    rng = np.random.default_rng(5)
    cascade = DeviceBloomCascade(device=str(dev))
    for ri, hit_rate in enumerate(HIT_RATES):
        n_hits = int(n_keys * hit_rate)
        n_rest = n_keys - n_hits
        n_fleet = n_rest // 10
        keys = [member_keys[i] for i in rng.integers(0, populated, n_hits)]
        keys += [fleet_only[i] for i in
                 rng.integers(0, len(fleet_only), n_fleet)]
        keys += production_keys(n_rest - n_fleet, seed=100 + ri)

        # -- checks, before anything is timed.
        want = f.may_contain_batch(keys)
        require(want[:n_hits].all(), "members must test positive")
        require(n_rest == 0 or not want[n_hits:].all(),
                "absent keys all positive")
        fused = bloom_membership_batch(words, keys, SALT, num_bits=nb,
                                       num_hashes=nh)
        require(np.array_equal(fused, want),
                "fused verdicts differ from the host filter's")
        fps_host = bloom.key_fingerprints(keys, SALT)
        fps = as_device_words(fps_host, dev)
        got = bloom_may_contain(words, fps, num_bits=nb,
                                num_hashes=nh).cpu().numpy()
        require(np.array_equal(got, want),
                "probe verdicts differ from the host filter's")
        want_cascade = want | fleet.may_contain_batch(keys)
        got_cascade = cascade.may_contain_batch(f, fleet, keys)
        require(np.array_equal(got_cascade, want_cascade),
                "cascade verdicts differ from the host OR")

        # -- host-vectorized: pack, digest + split, copy up, probe.
        t_hpack, (mat, lens) = host_seconds(lambda: pack_key_matrix(keys),
                                            dev)
        t_fp, fps_vec = host_seconds(
            lambda: bloom._split_digests(xxh64_grouped(mat, lens, SALT)),
            dev)
        require(np.array_equal(fps_vec, fps_host),
                "timed fingerprints differ from key_fingerprints'")
        t_fp_up, _ = host_seconds(lambda: as_device_words(fps_vec, dev), dev)
        t_probe = device_seconds(
            lambda: bloom_may_contain(words, fps, num_bits=nb,
                                      num_hashes=nh), dev, reps)

        # -- device-fused: pack, copy up, kernel, and the front door.
        t_pack, buckets = host_seconds(lambda: pack_key_buckets(keys), dev)
        t_up, packed = host_seconds(
            lambda: [(length, as_device_words(m, dev))
                     for length, _, m in buckets], dev)

        def fused_pass():
            return [bloom_membership_from_keys(words, p, length, seed,
                                               num_bits=nb, num_hashes=nh)
                    for length, p in packed]

        t_kernel = device_seconds(fused_pass, dev, reps)
        t_e2e, _ = host_seconds(lambda: bloom_membership_batch(
            words, keys, SALT, num_bits=nb, num_hashes=nh), dev)

        # -- cascade: the kernel alone and the class's whole call.
        fw = as_device_words(fleet.words, dev)
        fseed = seed_pair(FLEET_SALT)
        t_cas = device_seconds(lambda: [bloom_cascade_from_keys(
            words, fw, p, length, seed, fseed, num_bits=nb,
            num_hashes_region=nh, num_hashes_fleet=FLEET_HASHES)
            for length, p in packed], dev, reps)
        t_cas_e2e, _ = host_seconds(
            lambda: cascade.may_contain_batch(f, fleet, keys), dev)
        del packed, fps, fw

        results["sweep"].append({
            "hit_rate": hit_rate,
            "observed_positive_rate": float(want.mean()),
            "cascade_positive_rate": float(want_cascade.mean()),
            "host_vectorized": {
                "pack_seconds": t_hpack,
                "fingerprint_seconds": t_fp,
                "upload_seconds": t_fp_up,
                "probe_seconds": t_probe,
                "keys_per_sec": n_keys / (t_hpack + t_fp + t_fp_up
                                          + t_probe),
            },
            "device_fused": {
                "pack_seconds": t_pack,
                "upload_seconds": t_up,
                "kernel_seconds": t_kernel,
                "end_to_end_seconds": t_e2e,
                "keys_per_sec": n_keys / t_e2e,
                "length_classes": len(buckets),
            },
            "cascade": {
                "kernel_seconds": t_cas,
                "end_to_end_seconds": t_cas_e2e,
            },
        })
    return results


def main() -> None:
    ap = argparse.ArgumentParser("ytpu-torch-bloom-bench")
    ap.add_argument("--keys", type=int, default=1_000_000)
    ap.add_argument("--populated", type=int, default=1_000_000)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args()
    print(json.dumps(run(args.keys, args.populated, args.device), indent=2))


if __name__ == "__main__":
    main()
