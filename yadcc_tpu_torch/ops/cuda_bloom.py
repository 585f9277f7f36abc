"""Wrappers of the Bloom kernels (csrc/bloom.cu).

The counterparts of the JAX package's Bloom device functions:

  bloom_membership  <- ops/bloom_pipeline.py:bloom_membership_from_keys
  bloom_cascade     <- parallel/mesh.py:sharded_bloom_cascade_fn, one card
  bloom_probe       <- ops/bloom_probe.py:bloom_may_contain
  bloom_scatter_or  <- ops/bloom_probe.py:bloom_scatter_add
  placement_score   <- parallel/mesh.py:placement_score_fn, one card

Routing follows the tensors: CPU tensors go to the plain versions
(ops/bloom_pipeline.py, ops/bloom_probe.py); CUDA tensors launch the
kernel, and anything the kernel does not take raises, on either route.
Filter words, packed keys and fingerprints are int32 tensors holding the
bit pattern of the host's uint32 arrays; seeds are (hi, lo) uint32 pairs
(bloom_pipeline.seed_pair).  Packed keys may be any contiguous view (its
base only 4-byte aligned, e.g. one word into a buffer) and of any key
length: the kernels stage rows of 32 to 128 bytes whose width is a multiple
of 16 bytes and read the others from device memory.

The placement score takes its small per-decision inputs (seeds, the
cells' terms, counts, the task of each key, the packed keys) as host
arrays and sends them up in one copy; its cells' filter words are
tensors already resident on the card.

`launches` counts, by kernel name, the calls on the card that launched
the kernel (one a call with a non-empty batch; a scatter-OR call is two
launches, its bin and own passes, or two a pass when the batch outgrows
the scratch; a placement call is two, the score and its argmin), so a
run can show that its main path went through the kernels.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, NamedTuple

import torch

from . import bloom_pipeline as bpl
from . import bloom_probe as bpr

SOURCE = "bloom.cu"
KERNELS = ("membership", "cascade", "probe", "scatter_or",
           "placement_score")
# Bound on the hash count: far above any filter's (the reference uses
# 10), low enough that one pass of the scatter holds every probe of a key.
MAX_HASHES = 1 << 16
# The binned scatter-OR's geometry (csrc/bloom.cu: kBinThreads,
# kBinProbes; _kernels checks that the library agrees).  A bin block sorts
# up to BIN_PROBES (key, probe) pairs, at most 32 a thread; a pass has at
# most MAX_SEGMENTS bin blocks (a scratch of 128 MB at most); slices are
# 2^8 to 2^15 words, as large as leaves at least MIN_SLICES (two blocks an
# SM of the H100's 132) when the filter is large enough.
BIN_THREADS = 512
BIN_PROBES = 16384
MAX_SEGMENTS = 2048
MIN_SLICES = 264
SLICE_SHIFTS = (8, 15)
# The placement score's shared hit counts (csrc/bloom.cu: kPlaceMaxTasks;
# _kernels checks that the library agrees), and the largest task count it
# takes: above it, (counts - hits) * 1024 could wrap in int32.
PLACE_MAX_TASKS = 4096
PLACE_MAX_COUNT = 1 << 21

launches: Dict[str, int] = dict.fromkeys(KERNELS, 0)
_count_lock = threading.Lock()
_fns = None


def _kernels():
    global _fns
    if _fns is None:
        from ._build import load

        lib = load(SOURCE)
        p, i, u, ull = (ctypes.c_void_p, ctypes.c_int, ctypes.c_uint,
                        ctypes.c_ulonglong)
        sigs = {
            "membership": (lib.yadcc_bloom_membership,
                           [p, u, i, ull, p, i, i, i, p, p]),
            "cascade": (lib.yadcc_bloom_cascade,
                        [p, i, ull, p, i, ull, u, p, i, i, i, p, p]),
            "probe": (lib.yadcc_bloom_probe, [p, u, i, p, i, p, p]),
            "scatter_or": (lib.yadcc_bloom_scatter_or,
                           [p, p, u, i, p, i, p, p, i, i, i, i, p]),
            "placement_score": (lib.yadcc_placement_score,
                                [p, i, u, i, p, p, i, p, p, i, i, i, i, i,
                                 i, i, p, p, p, p]),
        }
        fns = {}
        for name, (fn, argtypes) in sigs.items():
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            fns[name] = fn
        for name in ("bloom_tile_keys", "bloom_scatter_bin_threads",
                     "bloom_scatter_bin_probes", "placement_max_tasks"):
            fn = getattr(lib, f"yadcc_{name}")
            fn.argtypes = []
            fn.restype = ctypes.c_int
            fns[name.removeprefix("bloom_")] = fn
        got = (fns["scatter_bin_threads"](), fns["scatter_bin_probes"]())
        if got != (BIN_THREADS, BIN_PROBES):
            raise RuntimeError(f"{SOURCE} bins {got} (threads, probes), the "
                               f"plan assumes {(BIN_THREADS, BIN_PROBES)}")
        if fns["placement_max_tasks"]() != PLACE_MAX_TASKS:
            raise RuntimeError(f"{SOURCE} places up to "
                               f"{fns['placement_max_tasks']()} tasks, the "
                               f"wrapper assumes {PLACE_MAX_TASKS}")
        _fns = fns
    return _fns


def tile_keys() -> int:
    """Keys a block of the membership and cascade kernels stages at a time
    (builds the kernels on first use)."""
    return int(_kernels()["tile_keys"]())


class ScatterPlan(NamedTuple):
    """The binned scatter-OR's geometry for one call (csrc/bloom.cu)."""
    slice_shift: int      # a slice is 2^slice_shift filter words
    slices: int           # own blocks
    keys_per_thread: int  # keys a bin thread takes
    hash_chunk: int       # probes of each key a bin block takes
    hash_blocks: int      # bin blocks along the probes
    key_blocks: int       # bin blocks along the keys, a pass
    passes: int

    @property
    def segments(self) -> int:
        """Bin blocks a pass: the scratch's segments, the table's columns."""
        return self.key_blocks * self.hash_blocks

    @property
    def block_keys(self) -> int:
        return BIN_THREADS * self.keys_per_thread


def scatter_plan(num_bits: int, num_hashes: int, n: int) -> ScatterPlan:
    """The geometry of bloom_scatter_or for n >= 1 keys and num_hashes >=
    1.  A bin thread takes min(K, 32) probes of each of its 32 // min(K,
    32) keys (3 keys of 10 probes at K = 10); a key's probes past 32 go to
    further bin blocks.  A slice is the largest power of two words in
    [2^8, 2^15] that leaves MIN_SLICES slices or more (2^8 words for a
    smaller filter, 2^15 for a larger one)."""
    nw = -(-num_bits // 32)
    per_thread = BIN_PROBES // BIN_THREADS
    hash_chunk = min(num_hashes, per_thread)
    keys_per_thread = per_thread // hash_chunk
    hash_blocks = -(-num_hashes // hash_chunk)
    lo, hi = SLICE_SHIFTS
    shift = max(lo, min(hi, (max(1, nw // MIN_SLICES)).bit_length() - 1))
    block_keys = BIN_THREADS * keys_per_thread
    key_blocks_all = -(-n // block_keys)
    key_blocks = min(key_blocks_all, MAX_SEGMENTS // hash_blocks)
    return ScatterPlan(shift, -(-nw // (1 << shift)), keys_per_thread,
                       hash_chunk, hash_blocks, key_blocks,
                       -(-key_blocks_all // key_blocks))


def _seed64(seed) -> int:
    """(hi, lo) uint32 pair -> the 64-bit seed the kernel takes."""
    return ((int(seed[0]) & bpl.M32) << 32) | (int(seed[1]) & bpl.M32)


def _check(name: str, t: torch.Tensor, shape, dev: torch.device) -> None:
    if t.dtype != torch.int32:
        raise TypeError(f"{name}: dtype {t.dtype}, kernel takes int32")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if t.device != dev:
        raise ValueError(f"{name}: on {t.device}, filter words on {dev}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def _check_geometry(num_bits: int, num_hashes: int) -> None:
    if not 1 <= num_bits <= bpl.M32:
        raise ValueError(f"num_bits {num_bits}: the probes take it mod "
                         f"in uint32, so it must lie in [1, 2^32)")
    if not 0 <= num_hashes <= MAX_HASHES:
        raise ValueError(f"num_hashes {num_hashes} outside [0, "
                         f"{MAX_HASHES}]")


def _check_words(name: str, words: torch.Tensor, num_bits: int,
                 dev: torch.device) -> None:
    _check(name, words, (words.shape[0] if words.dim() == 1 else -1,), dev)
    if words.shape[0] * 32 < num_bits:
        raise ValueError(f"{name}: {words.shape[0]} words hold fewer than "
                         f"num_bits={num_bits} bits")


def _check_packed(packed: torch.Tensor, length: int,
                  dev: torch.device) -> int:
    if length < 0:
        raise ValueError(f"key length {length} < 0")
    n = packed.shape[0] if packed.dim() == 2 else -1
    _check("packed_keys", packed, (n, -(-length // 8) * 2), dev)
    if n >= 2 ** 31:
        raise ValueError(f"{n} keys: the kernel counts keys in int32")
    return n


def _check_fingerprints(fps: torch.Tensor, dev: torch.device) -> int:
    n = fps.shape[0] if fps.dim() == 2 else -1
    _check("fingerprints", fps, (n, 2), dev)
    if n >= 2 ** 31:
        raise ValueError(f"{n} keys: the kernel counts keys in int32")
    return n


def _device(words: torch.Tensor, what: str) -> torch.device:
    dev = words.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no {what} kernel for device {dev}")
    return dev


def _launched(name: str, err: int) -> None:
    """Raise on a launch error, else count the call once (a scatter-OR
    call is two launches a pass; its entry point returns the first error
    of either)."""
    if err != 0:
        raise RuntimeError(f"bloom {name} kernel launch failed: CUDA "
                           f"error {err}")
    with _count_lock:
        launches[name] += 1


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def bloom_membership(words: torch.Tensor, packed_keys: torch.Tensor,
                     length: int, seed, *, num_bits: int,
                     num_hashes: int) -> torch.Tensor:
    """bool[N]; the drop-in counterpart of
    bloom_pipeline.membership_plain (one kernel launch on the card)."""
    dev = _device(words, "membership")
    _check_geometry(num_bits, num_hashes)
    _check_words("words", words, num_bits, dev)
    n = _check_packed(packed_keys, length, dev)
    if dev.type == "cpu":
        return bpl.membership_plain(words, packed_keys, length, seed,
                                    num_bits, num_hashes)
    out = torch.empty(n, dtype=torch.bool, device=dev)
    if n == 0:
        return out
    fn = _kernels()["membership"]
    with torch.cuda.device(dev):
        err = fn(words.data_ptr(), num_bits, num_hashes, _seed64(seed),
                 packed_keys.data_ptr(), packed_keys.shape[1], length, n,
                 out.data_ptr(), _stream(dev))
    _launched("membership", err)
    return out


def bloom_cascade(region_words: torch.Tensor, fleet_words: torch.Tensor,
                  packed_keys: torch.Tensor, length: int, region_seed,
                  fleet_seed, *, num_bits: int, num_hashes_region: int,
                  num_hashes_fleet: int) -> torch.Tensor:
    """bool[N] = region member OR fleet member; the drop-in counterpart
    of bloom_pipeline.cascade_plain (one kernel launch on the card)."""
    dev = _device(region_words, "cascade")
    _check_geometry(num_bits, num_hashes_region)
    _check_geometry(num_bits, num_hashes_fleet)
    _check_words("region_words", region_words, num_bits, dev)
    _check_words("fleet_words", fleet_words, num_bits, dev)
    n = _check_packed(packed_keys, length, dev)
    if dev.type == "cpu":
        return bpl.cascade_plain(region_words, fleet_words, packed_keys,
                                 length, region_seed, fleet_seed, num_bits,
                                 num_hashes_region, num_hashes_fleet)
    out = torch.empty(n, dtype=torch.bool, device=dev)
    if n == 0:
        return out
    fn = _kernels()["cascade"]
    with torch.cuda.device(dev):
        err = fn(region_words.data_ptr(), num_hashes_region,
                 _seed64(region_seed), fleet_words.data_ptr(),
                 num_hashes_fleet, _seed64(fleet_seed), num_bits,
                 packed_keys.data_ptr(), packed_keys.shape[1], length, n,
                 out.data_ptr(), _stream(dev))
    _launched("cascade", err)
    return out


def bloom_probe(words: torch.Tensor, fingerprints: torch.Tensor, *,
                num_bits: int, num_hashes: int) -> torch.Tensor:
    """bool[N] from [N, 2] (h1, h2) fingerprints; the drop-in
    counterpart of bloom_probe.probe_body."""
    dev = _device(words, "probe")
    _check_geometry(num_bits, num_hashes)
    _check_words("words", words, num_bits, dev)
    n = _check_fingerprints(fingerprints, dev)
    if dev.type == "cpu":
        return bpr.probe_body(words, fingerprints, num_bits, num_hashes)
    out = torch.empty(n, dtype=torch.bool, device=dev)
    if n == 0:
        return out
    fn = _kernels()["probe"]
    with torch.cuda.device(dev):
        err = fn(words.data_ptr(), num_bits, num_hashes,
                 fingerprints.data_ptr(), n, out.data_ptr(), _stream(dev))
    _launched("probe", err)
    return out


def bloom_scatter_or(words: torch.Tensor, fingerprints: torch.Tensor, *,
                     num_bits: int, num_hashes: int) -> torch.Tensor:
    """The new int32 word array with every probe bit of every key set
    (``words`` is not changed); the drop-in counterpart of
    bloom_probe.scatter_add_plain (on the card, the binned build of
    csrc/bloom.cu: two launches a pass over a scratch this call
    allocates)."""
    dev = _device(words, "scatter-or")
    _check_geometry(num_bits, num_hashes)
    _check_words("words", words, num_bits, dev)
    n = _check_fingerprints(fingerprints, dev)
    if dev.type == "cpu":
        return bpr.scatter_add_plain(words, fingerprints, num_bits,
                                     num_hashes)
    if n == 0 or num_hashes == 0:
        return words.clone()
    fn = _kernels()["scatter_or"]
    plan = scatter_plan(num_bits, num_hashes, n)
    nw = -(-num_bits // 32)
    out = torch.empty_like(words)
    # Words past the filter's come back as they were.
    out[nw:].copy_(words[nw:])
    # 4 bytes an entry; the kernel's uint16 entries use half of it.
    scratch = torch.empty(plan.segments * BIN_PROBES, dtype=torch.int32,
                          device=dev)
    table = torch.empty((plan.slices + 1) * plan.segments,
                        dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = fn(words.data_ptr(), out.data_ptr(), num_bits, num_hashes,
                 fingerprints.data_ptr(), n, scratch.data_ptr(),
                 table.data_ptr(), plan.slice_shift, plan.keys_per_thread,
                 plan.hash_chunk, plan.segments, _stream(dev))
    _launched("scatter_or", err)
    return out


def _placement_inputs(words, seeds, terms, packed, task_of_key, counts,
                      length: int, num_bits: int, num_hashes: int):
    """Check placement_score's inputs; returns (device, seeds, terms,
    packed, task_of_key, counts) with the host arrays as numpy."""
    import numpy as np

    c_n = len(words)
    if c_n < 1:
        raise ValueError("placement needs at least one cell")
    def norm(d) -> torch.device:
        d = torch.device(d)
        if d.type == "cuda" and d.index is None:
            d = torch.device("cuda", torch.cuda.current_device())
        return d

    devs = {norm(w.device) for w in words if w is not None}
    if len(devs) != 1:
        raise ValueError(f"placement cells' words on {sorted(map(str, devs))}"
                         f": the cells' filters must lie on one device")
    dev = next(iter(devs))
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no placement kernel for device {dev}")
    _check_geometry(num_bits, num_hashes)
    nw = -(-num_bits // 32)
    for c, w in enumerate(words):
        if w is not None:
            _check(f"words[{c}]", w, (nw,), dev)
    seeds = np.ascontiguousarray(seeds, np.uint32)
    terms = np.ascontiguousarray(terms, np.int32)
    counts = np.ascontiguousarray(counts, np.int32)
    task_of_key = np.ascontiguousarray(task_of_key, np.int32)
    packed = np.ascontiguousarray(packed, np.uint32)
    if seeds.shape != (c_n, 2) or terms.shape != (4, c_n):
        raise ValueError(f"seeds {seeds.shape} and terms {terms.shape} for "
                         f"{c_n} cells: expected ({c_n}, 2) and (4, {c_n})")
    t_n = counts.shape[0] if counts.ndim == 1 else -1
    if not 1 <= t_n <= PLACE_MAX_TASKS:
        raise ValueError(f"{t_n} tasks outside [1, {PLACE_MAX_TASKS}]")
    if int(counts.max()) > PLACE_MAX_COUNT:
        raise ValueError(f"a task counts {int(counts.max())} keys, above "
                         f"{PLACE_MAX_COUNT}: (counts - hits) * warm_scale "
                         f"could wrap in int32")
    if length < 0:
        raise ValueError(f"key length {length} < 0")
    n = task_of_key.shape[0] if task_of_key.ndim == 1 else -1
    if packed.shape != (n, -(-length // 8) * 2):
        raise ValueError(f"packed {packed.shape} for {n} keys of {length} "
                         f"bytes")
    if n >= 2 ** 31:
        raise ValueError(f"{n} keys: the kernel counts keys in int32")
    return dev, seeds, terms, packed, task_of_key, counts


def placement_score(words, seeds, terms, packed, task_of_key, counts, *,
                    length: int, num_bits: int, num_hashes: int,
                    warm_scale: int, w_warm: int, w_load: int, w_topo: int,
                    out: "torch.Tensor | None" = None, timer=None):
    """(scores int32 [C, T], best cell int32 [T], best score int32 [T]) on
    the cells' device; the drop-in counterpart of
    bloom_pipeline.placement_score_plain, whose docstring gives the
    arguments and the arithmetic.  Every filter shares (num_bits,
    num_hashes): a word tensor of another length is refused, as the JAX
    scorer refuses filters of differing geometry, and so is a call in
    which no cell has a filter (it has no device).  On the card the host
    arrays go up
    in one copy and the score and argmin are two launches.  Given ``out``
    (int32 [C*T + 2*T] on the device), the three results are views of it,
    so one copy brings them back.  Given ``timer`` (a StageTimer), a call
    on the card records the host time of its ``stage`` (the one upload)
    and its ``launch`` (the two launches)."""
    dev, seeds, terms, packed, task_of_key, counts = _placement_inputs(
        words, seeds, terms, packed, task_of_key, counts, length, num_bits,
        num_hashes)
    kw = dict(length=length, num_bits=num_bits, num_hashes=num_hashes,
              warm_scale=warm_scale, w_warm=w_warm, w_load=w_load,
              w_topo=w_topo)
    c_n, t_n, n = len(words), counts.shape[0], task_of_key.shape[0]
    if out is not None:
        _check("out", out, (c_n * t_n + 2 * t_n,), dev)
    if dev.type == "cpu":
        res = bpl.placement_score_plain(words, seeds, terms, packed,
                                        task_of_key, counts, device=dev,
                                        **kw)
        if out is None:
            return res
        out.copy_(torch.cat([r.reshape(-1) for r in res]))
    else:
        out = _placement_launch(dev, words, seeds, terms, packed,
                                task_of_key, counts, out, timer, **kw)
    return (out[:c_n * t_n].view(c_n, t_n),
            out[c_n * t_n:c_n * t_n + t_n], out[c_n * t_n + t_n:])


def placement_stage(dev, words, seeds, terms, packed, task_of_key,
                    counts) -> "tuple[torch.Tensor, list]":
    """The placement call's host arrays in one device buffer: (the buffer,
    the byte offsets of its table, terms, counts, task_of_key and packed
    rows).  The int64 table (word pointers, then seeds) comes first, so
    it is 8-byte aligned."""
    import numpy as np

    c_n = len(words)
    table = np.zeros((2, c_n), np.uint64)
    for c, w in enumerate(words):
        if w is not None:
            table[0, c] = w.data_ptr()
        table[1, c] = _seed64(seeds[c])
    parts = [table.view(np.int32).ravel(), terms.ravel(), counts,
             task_of_key, packed.view(np.int32).ravel()]
    offsets = [int(o) * 4 for o in np.cumsum([0] + [p.size for p in parts])]
    return torch.from_numpy(np.concatenate(parts)).to(dev), offsets[:5]


def placement_run(staged: torch.Tensor, offsets, c_n: int, t_n: int,
                  n: int, row_words: int, out: torch.Tensor, *,
                  length, num_bits, num_hashes, warm_scale, w_warm, w_load,
                  w_topo) -> None:
    """Launch the score and argmin kernels on a staged buffer into
    ``out`` (int32 [C*T + 2*T]); raises on a launch error, counts the
    call."""
    base, obase = staged.data_ptr(), out.data_ptr()
    fn = _kernels()["placement_score"]
    dev = staged.device
    with torch.cuda.device(dev):
        err = fn(base + offsets[0], c_n, num_bits, num_hashes,
                 base + offsets[1], base + offsets[2], t_n,
                 base + offsets[3], base + offsets[4], row_words, length, n,
                 warm_scale, w_warm, w_load, w_topo, obase,
                 obase + 4 * c_n * t_n, obase + 4 * (c_n * t_n + t_n),
                 _stream(dev))
    _launched("placement_score", err)


def _placement_launch(dev, words, seeds, terms, packed, task_of_key, counts,
                      out, timer, **kw) -> torch.Tensor:
    import time

    c_n, t_n = len(words), counts.shape[0]
    t0 = time.perf_counter()
    staged, offsets = placement_stage(dev, words, seeds, terms, packed,
                                      task_of_key, counts)
    if out is None:
        out = torch.empty(c_n * t_n + 2 * t_n, dtype=torch.int32, device=dev)
    t1 = time.perf_counter()
    placement_run(staged, offsets, c_n, t_n, task_of_key.shape[0],
                  packed.shape[1], out, **kw)
    if timer is not None:
        timer.record("stage", t1 - t0)
        timer.record("launch", time.perf_counter() - t1)
    return out
