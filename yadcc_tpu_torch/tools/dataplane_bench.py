"""Data-plane A/B bench: the byte path, measured stage by stage (a copy of
the JAX package's yadcc_tpu/tools/dataplane_bench.py over the port's
codecs; host work only, no torch).

Sweeps payload sizes through the codec stages a task's bytes traverse on
the client→delegate→servant→cache round trip, timing each stage under
BOTH implementations — the pre-PR full-copy/two-pass path (preserved in
``_dataplane_legacy``) and the zero-copy Payload path — and counting
full-buffer copies per task on the payload layer's meter.

Stage map:

    chunk_parse   submit-body multi-chunk parse   (copy-per-chunk vs views)
    frame_encode  submit framing + RPC frame      (3 materializations vs 1)
    reply_pack    servant reply attachment + frame (2 joins vs 1)
    reply_unpack  delegate reply parse            (copy vs views)
    entry_pack    cache-entry serialize + digest  (concat-digest vs fused)
    entry_parse   cache-entry parse + verify      (3 copies vs 0)
    digest_decompress  servant source intake      (two-pass vs fused)
    servant_pack  per-file output compression     (serial vs shared pool)

``copy_path`` is the headline composite: the four pure framing stages
(chunk_parse + frame_encode + reply_pack + reply_unpack) — the work
that is byte *plumbing*, no compressor and no digest in the loop.  The
digest-bearing stages carry the same integrity scan on both sides, so
they are reported individually instead of being allowed to dilute the
copy headline.

    python -m yadcc_tpu_torch.tools.dataplane_bench           # sweep
    python -m yadcc_tpu_torch.tools.dataplane_bench --smoke   # parity
    python -m yadcc_tpu_torch.tools.dataplane_bench --e2e ... # cluster A/B

``--smoke`` asserts wire parity (legacy and zero-copy produce
byte-identical frames/entries and agree on every parse/digest) and
exits 2 on any mismatch — the gate is correctness, never speed.
``--e2e`` runs the in-process loopback cluster (cluster_sim) twice with
a byte-heavy TU distribution — once patched to the legacy path, once
as-built — so the report holds the before/after under identical flags
in the same process.  The cluster's scheduler runs ``greedy_cpu`` on
``--device`` (the rig's reader is built there too).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Callable, Dict, Tuple

import numpy as np

from ..common import compress
from ..common.multi_chunk import (make_multi_chunk_payload,
                                  try_parse_multi_chunk_views)
from ..common.payload import copy_counting
from ..daemon import packing
from ..daemon.cache_format import (CacheEntry, try_parse_cache_entry,
                                   write_cache_entry_payload)
from ..rpc import transport as tp
from . import _dataplane_legacy as L

HARNESS_VERSION = 1
DEFAULT_SIZES = (64 << 10, 1 << 20, 16 << 20)
_COPY_PATH_STAGES = ("chunk_parse", "frame_encode", "reply_pack",
                     "reply_unpack")


def _make_source(size: int, seed: int = 7) -> bytes:
    """Hex-text filler: compresses like preprocessed C++ (somewhat),
    not like zeros (trivially)."""
    rng = np.random.default_rng(seed)
    pool = rng.bytes(max(1, size // 2 + 1)).hex().encode()
    return pool[:size]


def _best_of(fn: Callable[[], object], repeats: int) -> float:
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


# ---------------------------------------------------------------------------
# the modeled task byte path
# ---------------------------------------------------------------------------


def model_task_copies(size: int, legacy: bool) -> int:
    """Copies-per-task: run one task's bytes through every codec stage
    of the round trip (submit framing → daemon parse → servant RPC →
    source intake → output pack → reply → delegate parse → cache-entry
    pack → cache-entry parse) and return the payload-layer copy count.

    Single-threaded and deterministic — the number a test can assert.
    """
    src = _make_source(size)
    blob = compress.compress(src)
    meta = b'{"task":"model"}'
    with copy_counting() as counted:
        if legacy:
            body = L.legacy_make_multi_chunk([meta, blob])
            chunks = L.legacy_try_parse_multi_chunk(body)
            frame = tp.encode_frame(0, meta, chunks[1])
            _, _, att = tp.decode_frame(frame)
            L.count_copy(len(att))          # pre-PR slice-copied here
            src2, _ = L.legacy_two_pass_decompress_digest(att)
            out = {".o": compress.compress(src2)}
            reply = tp.encode_frame(0, meta, L.legacy_pack_keyed_buffers(out))
            _, _, ratt = tp.decode_frame(reply)
            L.count_copy(len(ratt))
            files = L.legacy_try_unpack_keyed_buffers(ratt)
            entry = L.legacy_write_cache_entry(CacheEntry(
                0, b"", b"", files=files))
            parsed = L.legacy_try_parse_cache_entry(entry)
        else:
            body = make_multi_chunk_payload([meta, blob]).join()
            chunks = try_parse_multi_chunk_views(body)
            frame = tp.encode_frame_payload(0, meta, chunks[1]).join()
            _, _, att = tp.decode_frame_views(frame)
            src2, _ = compress.decompress_and_digest(att)
            out = {".o": compress.compress(src2)}
            reply = tp.encode_frame_payload(
                0, meta, packing.pack_keyed_buffers_payload(out)).join()
            _, _, ratt = tp.decode_frame_views(reply)
            files = packing.try_unpack_keyed_buffers_views(ratt)
            entry = write_cache_entry_payload(CacheEntry(
                0, b"", b"", files=dict(files)))
            parsed = try_parse_cache_entry(entry)
        assert parsed is not None and parsed.exit_code == 0
    return counted.copies


# ---------------------------------------------------------------------------
# stage timings
# ---------------------------------------------------------------------------


def _stage_pairs(size: int) -> Dict[str, Tuple[Callable, Callable, int]]:
    """name -> (legacy_fn, zero_copy_fn, bytes_moved) for one size."""
    meta = b'{"task":"bench"}'
    blob = _make_source(size)       # stands in for the compressed source
    submit_frame = L.legacy_make_multi_chunk([meta, blob])
    out_files = {".o": _make_source((size * 3) // 4, seed=11),
                 ".gcno": _make_source(size // 4, seed=12)}
    reply_att = L.legacy_pack_keyed_buffers(out_files)
    reply_frame = tp.encode_frame(0, meta, reply_att)
    entry = CacheEntry(0, b"out", b"err", files=dict(out_files),
                       patches={".o": [(4, 32, b"/output.o")]})
    entry_bytes = L.legacy_write_cache_entry(entry)
    zblob = compress.compress(blob)
    raw_outputs = list(out_files.values())

    def serial_pack():
        for c in raw_outputs:
            compress.compress(c)

    def pooled_pack():
        from ..daemon.cloud.cxx_task import _PACK_EXECUTOR

        pool = _PACK_EXECUTOR.get()
        futs = [pool.submit(compress.compress, c) for c in raw_outputs]
        for f in futs:
            f.result()

    return {
        "chunk_parse": (
            lambda: L.legacy_try_parse_multi_chunk(submit_frame),
            lambda: try_parse_multi_chunk_views(submit_frame),
            len(submit_frame)),
        "frame_encode": (
            lambda: tp.encode_frame(
                0, meta, L.legacy_make_multi_chunk([meta, blob])),
            lambda: tp.encode_frame_payload(
                0, meta, make_multi_chunk_payload([meta, blob])).join(),
            len(submit_frame)),
        "reply_pack": (
            lambda: tp.encode_frame(
                0, meta, L.legacy_pack_keyed_buffers(out_files)),
            lambda: tp.encode_frame_payload(
                0, meta,
                packing.pack_keyed_buffers_payload(out_files)).join(),
            len(reply_frame)),
        "reply_unpack": (
            lambda: L.legacy_try_unpack_keyed_buffers(reply_att),
            lambda: packing.try_unpack_keyed_buffers_views(reply_att),
            len(reply_att)),
        "entry_pack": (
            lambda: L.legacy_write_cache_entry(entry),
            lambda: write_cache_entry_payload(entry).join(),
            len(entry_bytes)),
        "entry_parse": (
            lambda: L.legacy_try_parse_cache_entry(entry_bytes),
            lambda: try_parse_cache_entry(entry_bytes),
            len(entry_bytes)),
        "digest_decompress": (
            lambda: L.legacy_two_pass_decompress_digest(zblob),
            lambda: compress.decompress_and_digest(zblob),
            len(blob)),
        "servant_pack": (serial_pack, pooled_pack, size),
    }


def run_sweep(size: int, repeats: int) -> dict:
    stages = {}
    copy_old = copy_new = 0.0
    copy_bytes = 0
    for name, (old_fn, new_fn, nbytes) in _stage_pairs(size).items():
        t_old = _best_of(old_fn, repeats)
        t_new = _best_of(new_fn, repeats)
        stages[name] = {
            "bytes": nbytes,
            "legacy_mb_per_sec": round(nbytes / 1e6 / t_old, 1),
            "zero_copy_mb_per_sec": round(nbytes / 1e6 / t_new, 1),
            "speedup": round(t_old / t_new, 2),
        }
        if name in _COPY_PATH_STAGES:
            copy_old += t_old
            copy_new += t_new
            copy_bytes += nbytes
    return {
        "stages": stages,
        "copy_path": {
            "stages": list(_COPY_PATH_STAGES),
            "bytes": copy_bytes,
            "legacy_mb_per_sec": round(copy_bytes / 1e6 / copy_old, 1),
            "zero_copy_mb_per_sec": round(copy_bytes / 1e6 / copy_new, 1),
            "speedup": round(copy_old / copy_new, 2),
        },
        "copies_per_task": {
            "legacy": model_task_copies(size, legacy=True),
            "zero_copy": model_task_copies(size, legacy=False),
        },
    }


# ---------------------------------------------------------------------------
# parity smoke (the CI gate: correctness, never speed)
# ---------------------------------------------------------------------------


def check_parity(size: int = 64 << 10) -> None:
    """Byte-identity + agreement between legacy and zero-copy paths;
    AssertionError on any divergence."""
    meta = b'{"parity":1}'
    blob = _make_source(size)
    chunks = [meta, blob, b"", b"x"]
    legacy_frame = L.legacy_make_multi_chunk(chunks)
    assert make_multi_chunk_payload(chunks).join() == legacy_frame
    assert (try_parse_multi_chunk_views(legacy_frame)
            == L.legacy_try_parse_multi_chunk(legacy_frame))

    att = {".o": blob, ".gcno": b"", "k": b"\x00\xff"}
    legacy_att = L.legacy_pack_keyed_buffers(att)
    assert packing.pack_keyed_buffers_payload(att).join() == legacy_att
    assert (packing.try_unpack_keyed_buffers_views(legacy_att)
            == L.legacy_try_unpack_keyed_buffers(legacy_att))

    legacy_rpc = tp.encode_frame(3, meta, blob)
    assert tp.encode_frame_payload(3, meta, blob).join() == legacy_rpc
    s, m, a = tp.decode_frame_views(legacy_rpc)
    assert (s, m, a) == tp.decode_frame(legacy_rpc)

    entry = CacheEntry(1, b"o", b"e", files={".o": blob, ".su": b"s"},
                       patches={".o": [(0, 8, b"/x.o")]})
    legacy_entry = L.legacy_write_cache_entry(entry)
    assert write_cache_entry_payload(entry).join() == legacy_entry
    new_parsed = try_parse_cache_entry(legacy_entry)
    old_parsed = L.legacy_try_parse_cache_entry(legacy_entry)
    assert new_parsed is not None and old_parsed is not None
    assert new_parsed.files == old_parsed.files
    assert new_parsed.patches == old_parsed.patches

    zblob = compress.compress(blob)
    old_src, old_digest = L.legacy_two_pass_decompress_digest(zblob)
    new_src, new_digest = compress.decompress_and_digest(zblob)
    assert old_src == new_src and old_digest == new_digest

    old_c = model_task_copies(size, legacy=True)
    new_c = model_task_copies(size, legacy=False)
    assert new_c <= old_c - 3, (old_c, new_c)


# ---------------------------------------------------------------------------
# e2e cluster A/B
# ---------------------------------------------------------------------------


def run_cluster_ab(tasks: int, servants: int, concurrency: int,
                   tu_size_dist: str, compile_s: float,
                   device: str = "cuda") -> dict:
    from .cluster_sim import run as cluster_run

    flags = {
        "tasks": tasks, "servants": servants, "concurrency": concurrency,
        "dup_rate": 0.0, "policy": "greedy_cpu",
        "tu_size_dist": tu_size_dist, "compile_s": compile_s,
    }

    def one(legacy: bool) -> dict:
        if legacy:
            with L.full_legacy_patches():
                return cluster_run(tasks, servants, concurrency, 0.0,
                                   "greedy_cpu", compile_s=compile_s,
                                   tu_size_dist=tu_size_dist,
                                   device=device)
        return cluster_run(tasks, servants, concurrency, 0.0,
                           "greedy_cpu", compile_s=compile_s,
                           tu_size_dist=tu_size_dist, device=device)

    # Best-of-2 per side (this repo's bench convention): one whole-rig
    # run is seconds long and single-run numbers carry boot/GC noise.
    legacy = max((one(legacy=True) for _ in range(2)),
                 key=lambda r: r["tasks_per_sec"])
    zero_copy = max((one(legacy=False) for _ in range(2)),
                    key=lambda r: r["tasks_per_sec"])
    return {
        "flags": flags,
        "legacy": legacy,
        "zero_copy": zero_copy,
        "tasks_per_sec_speedup": round(
            zero_copy["tasks_per_sec"] / max(1e-9, legacy["tasks_per_sec"]),
            3),
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        "python -m yadcc_tpu_torch.tools.dataplane_bench")
    ap.add_argument("--sizes", default=",".join(str(s)
                                                for s in DEFAULT_SIZES))
    ap.add_argument("--repeats", type=int, default=7)
    ap.add_argument("--smoke", action="store_true",
                    help="parity checks only; exit 2 on divergence")
    ap.add_argument("--e2e", action="store_true",
                    help="include the loopback-cluster legacy/zero-copy A/B")
    ap.add_argument("--e2e-tasks", type=int, default=200)
    ap.add_argument("--e2e-servants", type=int, default=4)
    ap.add_argument("--e2e-concurrency", type=int, default=4)
    ap.add_argument("--e2e-tu-size-dist", default="byte-heavy")
    ap.add_argument("--e2e-compile-s", type=float, default=0.0)
    ap.add_argument("--device", default="cuda",
                    help="--e2e: where the cluster's scheduler and cache "
                         "reader run (cuda, the default, or cpu)")
    ap.add_argument("--out", default="", help="also write JSON here")
    args = ap.parse_args(argv)

    if args.smoke:
        try:
            check_parity()
        except AssertionError as e:
            print(f"dataplane parity FAILED: {e!r}", file=sys.stderr)
            sys.exit(2)
        print("dataplane parity OK")
        return

    result = {
        "harness_version": HARNESS_VERSION,
        "metric": "dataplane copy-path MB/s, legacy vs zero-copy",
        "copy_path_definition": (
            "framing stages only (chunk_parse+frame_encode+reply_pack+"
            "reply_unpack): byte plumbing with no compressor or digest "
            "in the loop; digest-bearing stages reported individually"),
        "backend": "zstd" if compress.zstandard is not None else
                   "zlib-fallback",
        "sweeps": {},
    }
    for size in (int(s) for s in args.sizes.split(",")):
        result["sweeps"][str(size)] = run_sweep(size, args.repeats)
    if args.e2e:
        result["cluster_ab"] = run_cluster_ab(
            args.e2e_tasks, args.e2e_servants, args.e2e_concurrency,
            args.e2e_tu_size_dist, args.e2e_compile_s, device=args.device)
    text = json.dumps(result, indent=2)
    print(text)
    if args.out:
        with open(args.out, "w") as fp:
            fp.write(text + "\n")


if __name__ == "__main__":
    main()
