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
arrays, written into a slot's pinned staging buffer (placement_pack);
its cells' filter words are tensors already resident on the card, which
the staged table points at.  One native call (placement_call) copies
the input up, launches the kernel once, copies the results back and
waits, with the GIL released.

`launches` counts, by kernel name, the calls on the card that launched
the kernel (one a call with a non-empty batch; a scatter-OR call is two
launches, its bin and own passes, or two a pass when the batch outgrows
the scratch; a placement call is one), so a run can show that its main
path went through the kernels.
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
# The most tasks a placement call takes (csrc/bloom.cu: kPlaceMaxTasks;
# _kernels checks that the library agrees), and the largest count of keys
# a task may have: above it, (counts - hits) * 1024 could wrap in int32.
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
            "placement_call": (lib.yadcc_placement_call,
                               [p, p, p, p, p, p, i, p]),
            "placement_launch": (lib.yadcc_placement_launch,
                                 [p, p, p, p, p, i, p]),
            "empty_launch": (lib.yadcc_empty_launch, [p]),
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




# The placement call's staged input (csrc/bloom.cu: PlaceHeader): 16 int32
# of header; at byte PLACE_TABLE the table, C word pointers (0 for a cell
# without a filter) then C 64-bit seeds; then terms [4, C], counts [T],
# task_of_key [N] and the packed rows [N, row_words], all int32.
PLACE_HEADER = ("cells", "tasks", "n", "row_words", "length", "num_bits",
                "num_hashes", "warm_scale", "w_warm", "w_load", "w_topo",
                "in_bytes", "off_terms", "off_counts", "off_task",
                "off_packed")
PLACE_TABLE = 64
# Scores and picks of fewer than 2^29 int32, staged inputs below 2^31
# bytes: both sizes are C ints in the entry point.
PLACE_MAX_OUT = 1 << 29
PLACE_MAX_IN = 1 << 31


class PlacementLayout(NamedTuple):
    """Where a placement call's parts lie in its staged input (bytes)."""
    cells: int
    tasks: int
    n: int
    row_words: int
    off_terms: int
    off_counts: int
    off_task: int
    off_packed: int
    in_bytes: int

    @property
    def out_ints(self) -> int:
        """Scores [C, T], best cell [T], best score [T]."""
        return self.cells * self.tasks + 2 * self.tasks


def placement_layout(c_n: int, t_n: int, n: int,
                     row_words: int) -> PlacementLayout:
    off_terms = PLACE_TABLE + 16 * c_n
    off_counts = off_terms + 16 * c_n
    off_task = off_counts + 4 * t_n
    off_packed = off_task + 4 * n
    return PlacementLayout(c_n, t_n, n, row_words, off_terms, off_counts,
                           off_task, off_packed,
                           off_packed + 4 * n * row_words)


def _grown(need: int) -> int:
    return 1 << max(6, (need - 1).bit_length())


class PlacementSlot:
    """One placement call's buffers on ``device``: the staged input and
    the results in host memory (pinned for the card), their twins on the
    card, the kernel's [C, T] hit scratch and its ticket (zero between
    calls: the kernel leaves them so).  ``fit`` grows a buffer, to the
    next power of two, only when a call's C, N or T outgrow it.  A
    slot serves one call at a time (PlacementSlots hands it out)."""

    def __init__(self, device):
        dev = _indexed(device)
        if dev.type not in ("cpu", "cuda"):
            raise ValueError(f"no placement kernel for device {dev}")
        self.device = dev
        self.in_bytes = self.out_ints = self.scratch_ints = 0
        self.host_in = self.host_out = None
        self.dev_in = self.dev_out = self.scratch = self.ticket = None
        if dev.type == "cuda":
            self.ticket = torch.zeros(1, dtype=torch.int32, device=dev)
        self._ptrs = ()

    def fit(self, layout: PlacementLayout) -> None:
        cuda = self.device.type == "cuda"
        grew = False
        if layout.in_bytes > self.in_bytes:
            self.in_bytes = _grown(layout.in_bytes)
            self.host_in = torch.empty(self.in_bytes, dtype=torch.uint8,
                                       pin_memory=cuda)
            if cuda:
                self.dev_in = torch.empty(self.in_bytes, dtype=torch.uint8,
                                          device=self.device)
            grew = True
        if layout.out_ints > self.out_ints:
            self.out_ints = _grown(layout.out_ints)
            self.host_out = torch.empty(self.out_ints, dtype=torch.int32,
                                        pin_memory=cuda)
            if cuda:
                self.dev_out = torch.empty(self.out_ints, dtype=torch.int32,
                                           device=self.device)
            grew = True
        if cuda and layout.cells * layout.tasks > self.scratch_ints:
            self.scratch_ints = _grown(layout.cells * layout.tasks)
            self.scratch = torch.zeros(self.scratch_ints, dtype=torch.int32,
                                       device=self.device)
            grew = True
        if grew:
            self.in_np = self.host_in.numpy()
            self.out_np = self.host_out.numpy()
            if cuda:
                # The scratch's zeros land before any stream's kernel.
                torch.cuda.current_stream(self.device).synchronize()
                self._ptrs = tuple(t.data_ptr() for t in (
                    self.host_in, self.dev_in, self.host_out, self.dev_out,
                    self.scratch, self.ticket))


class PlacementSlots:
    """A pool of PlacementSlots on one device.  ``take`` hands each slot
    to one caller at a time (a new slot when none is free), ``give``
    returns it; a slot whose call raised is not given back, so a call
    that failed part-way never shares its scratch or ticket."""

    def __init__(self, device):
        self.device = torch.device(device)
        self._lock = threading.Lock()
        self._free: list = []  # guarded by: self._lock
        self.created = 0  # guarded by: self._lock

    def take(self) -> PlacementSlot:
        with self._lock:
            if self._free:
                return self._free.pop()
            self.created += 1
        return PlacementSlot(self.device)

    def give(self, slot: PlacementSlot) -> None:
        with self._lock:
            self._free.append(slot)


def _placement_host(seeds, terms, packed, task_of_key, counts, length: int,
                    num_bits: int, num_hashes: int):
    """The checks every placement call makes (shapes and bounds, no
    tensor); returns (seeds, terms, packed, task_of_key, counts) as
    numpy."""
    import numpy as np

    _check_geometry(num_bits, num_hashes)
    seeds = np.ascontiguousarray(seeds, np.uint32)
    terms = np.ascontiguousarray(terms, np.int32)
    counts = np.ascontiguousarray(counts, np.int32)
    task_of_key = np.ascontiguousarray(task_of_key, np.int32)
    packed = np.ascontiguousarray(packed, np.uint32)
    c_n = seeds.shape[0] if seeds.ndim == 2 else -1
    if c_n < 1:
        raise ValueError("placement needs at least one cell")
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
    if c_n * n >= 2 ** 31:
        raise ValueError(f"{c_n} cells x {n} keys: the kernel counts "
                         f"(cell, key) pairs in int32")
    return seeds, terms, packed, task_of_key, counts


def placement_pack(slot: PlacementSlot, ptrs, seeds, terms, packed,
                   task_of_key, counts, *, length: int, num_bits: int,
                   num_hashes: int, warm_scale: int, w_warm: int,
                   w_load: int, w_topo: int) -> PlacementLayout:
    """Check one decision's host arrays (placement_score's, see there)
    and write them, with ``ptrs`` (each cell's word pointer, 0 for a cell
    without a filter), into ``slot``'s staged input, growing it if they
    outgrow it.  The cells' word tensors are checked by the caller, once:
    placement_score checks them every call, DevicePlacementScorer when it
    installs a snapshot."""
    import numpy as np

    seeds, terms, packed, task_of_key, counts = _placement_host(
        seeds, terms, packed, task_of_key, counts, length, num_bits,
        num_hashes)
    c_n, t_n, n = seeds.shape[0], counts.shape[0], task_of_key.shape[0]
    if len(ptrs) != c_n:
        raise ValueError(f"{len(ptrs)} word pointers for {c_n} cells")
    lay = placement_layout(c_n, t_n, n, packed.shape[1])
    if lay.in_bytes >= PLACE_MAX_IN or lay.out_ints >= PLACE_MAX_OUT:
        raise ValueError(f"a placement call of {lay.in_bytes} bytes in, "
                         f"{lay.out_ints} ints out: the entry point takes "
                         f"< {PLACE_MAX_IN} and < {PLACE_MAX_OUT}")
    slot.fit(lay)
    buf = slot.in_np
    buf[:PLACE_TABLE].view(np.uint32)[:] = np.array(
        [c_n, t_n, n, lay.row_words, length, num_bits, num_hashes,
         warm_scale, w_warm, w_load, w_topo, lay.in_bytes, lay.off_terms,
         lay.off_counts, lay.off_task, lay.off_packed],
        np.int64).astype(np.uint32)
    table = buf[PLACE_TABLE:lay.off_terms].view(np.uint64)
    table[:c_n] = ptrs
    s64 = seeds.astype(np.uint64)
    table[c_n:] = (s64[:, 0] << np.uint64(32)) | s64[:, 1]
    buf[lay.off_terms:lay.off_counts].view(np.int32)[:] = terms.ravel()
    buf[lay.off_counts:lay.off_task].view(np.int32)[:] = counts
    buf[lay.off_task:lay.off_packed].view(np.int32)[:] = task_of_key
    buf[lay.off_packed:lay.in_bytes].view(np.uint32)[:] = packed.ravel()
    return lay


def placement_unpack(slot: PlacementSlot, lay: PlacementLayout) -> dict:
    """The parts of ``slot``'s staged input, read back at ``lay``'s
    offsets as the kernel reads them: the header's fields by name, and
    ``ptrs``, ``seeds`` ((hi, lo) uint32 [C, 2]), ``terms``, ``counts``,
    ``task_of_key`` and ``packed``."""
    import numpy as np

    buf = slot.in_np
    got = {k: int(v) for k, v in
           zip(PLACE_HEADER, buf[:PLACE_TABLE].view(np.int32))}
    got["num_bits"] = int(buf[:PLACE_TABLE].view(np.uint32)[5])
    c_n, t_n = lay.cells, lay.tasks
    table = buf[PLACE_TABLE:lay.off_terms].view(np.uint64)
    got["ptrs"] = table[:c_n].copy()
    got["seeds"] = np.stack([(table[c_n:] >> np.uint64(32)),
                             table[c_n:] & np.uint64(bpl.M32)],
                            1).astype(np.uint32)
    got["terms"] = buf[lay.off_terms:lay.off_counts].view(
        np.int32).reshape(4, c_n).copy()
    got["counts"] = buf[lay.off_counts:lay.off_task].view(np.int32).copy()
    got["task_of_key"] = buf[lay.off_task:lay.off_packed].view(
        np.int32).copy()
    got["packed"] = buf[lay.off_packed:lay.in_bytes].view(np.uint32).reshape(
        lay.n, lay.row_words).copy()
    return got


def placement_call(slot: PlacementSlot, lay: PlacementLayout, words):
    """One placement decision on the input placement_pack staged in
    ``slot``: int32 [C*T + 2*T] (scores, best cell, best score), a view of
    the slot's output, valid until its next call.  On the card, one
    native call (csrc/bloom.cu: yadcc_placement_call) copies the input up,
    launches the kernel once, copies the results back and waits, with the
    GIL released; it raises on a CUDA error and counts one launch.  On
    the CPU, the plain version on the parts read back from the slot.
    ``words`` are the tensors the table points at: held here until the
    call returns, so no snapshot installed meanwhile frees memory the
    kernel reads."""
    if slot.device.type == "cpu":
        return _placement_plain(slot, lay, words)
    err = _kernels()["placement_call"](*slot._ptrs, slot.device.index,
                                       _stream(slot.device))
    _launched("placement_score", err)
    return slot.out_np[:lay.out_ints]


def _placement_plain(slot: PlacementSlot, lay: PlacementLayout, words):
    import numpy as np

    got = placement_unpack(slot, lay)
    want = [0 if w is None else w.data_ptr() for w in words]
    if got["ptrs"].tolist() != want:
        raise ValueError("the staged table points at other word tensors "
                         "than the call's")
    res = bpl.placement_score_plain(
        words, got["seeds"], got["terms"], got["packed"],
        got["task_of_key"], got["counts"], length=got["length"],
        num_bits=got["num_bits"], num_hashes=got["num_hashes"],
        warm_scale=got["warm_scale"], w_warm=got["w_warm"],
        w_load=got["w_load"], w_topo=got["w_topo"], device=slot.device)
    out = slot.out_np[:lay.out_ints]
    out[:] = np.concatenate([r.reshape(-1).numpy() for r in res])
    return out


def placement_launch(slot: PlacementSlot) -> None:
    """The kernel alone on the input ``slot``'s last call staged on the
    card (one launch, no copy, no wait): for timing it.  Counts the
    launch."""
    host_in, dev_in, _, dev_out, scratch, ticket = slot._ptrs
    err = _kernels()["placement_launch"](host_in, dev_in, dev_out, scratch,
                                         ticket, slot.device.index,
                                         _stream(slot.device))
    _launched("placement_score", err)


def empty_launch(dev: torch.device) -> None:
    """One launch of an empty one-block kernel on the current stream: the
    floor under a one-launch call."""
    err = _kernels()["empty_launch"](_stream(dev))
    if err != 0:
        raise RuntimeError(f"empty kernel launch failed: CUDA error {err}")


def _indexed(dev) -> torch.device:
    """``dev`` with its index (the current card for a bare "cuda")."""
    dev = torch.device(dev)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _placement_device(words) -> torch.device:
    """The one device of the cells' word tensors."""
    if len(words) < 1:
        raise ValueError("placement needs at least one cell")
    devs = {_indexed(w.device) for w in words if w is not None}
    if len(devs) != 1:
        raise ValueError(f"placement cells' words on {sorted(map(str, devs))}"
                         f": the cells' filters must lie on one device")
    dev = next(iter(devs))
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no placement kernel for device {dev}")
    return dev


def check_placement_words(words: torch.Tensor, num_bits: int,
                          num_hashes: int, dev: torch.device) -> None:
    """A cell's filter words as the placement kernel reads them: int32,
    contiguous, ceil(num_bits / 32) of them, on ``dev``; the geometry in
    range."""
    _check_geometry(num_bits, num_hashes)
    _check("words", words, (-(-num_bits // 32),), _indexed(dev))


def placement_score(words, seeds, terms, packed, task_of_key, counts, *,
                    length: int, num_bits: int, num_hashes: int,
                    warm_scale: int, w_warm: int, w_load: int, w_topo: int,
                    out: "torch.Tensor | None" = None):
    """(scores int32 [C, T], best cell int32 [T], best score int32 [T]) on
    the cells' device; the drop-in counterpart of
    bloom_pipeline.placement_score_plain, whose docstring gives the
    arguments and the arithmetic.  Every filter shares (num_bits,
    num_hashes): a word tensor of another length is refused, as the JAX
    scorer refuses filters of differing geometry, and so is a call in
    which no cell has a filter (it has no device).  The call goes through
    a slot of its own (placement_pack, then placement_call: on the card
    one native call and one launch).  Given ``out`` (int32 [C*T + 2*T] on
    the device), the three results are views of it."""
    dev = _placement_device(words)
    for w in words:
        if w is not None:
            check_placement_words(w, num_bits, num_hashes, dev)
    slot = PlacementSlot(dev)
    lay = placement_pack(
        slot, [0 if w is None else w.data_ptr() for w in words], seeds,
        terms, packed, task_of_key, counts, length=length,
        num_bits=num_bits, num_hashes=num_hashes, warm_scale=warm_scale,
        w_warm=w_warm, w_load=w_load, w_topo=w_topo)
    c_n, t_n = lay.cells, lay.tasks
    if out is not None:
        _check("out", out, (lay.out_ints,), dev)
    else:
        out = torch.empty(lay.out_ints, dtype=torch.int32, device=dev)
    out.copy_(torch.from_numpy(placement_call(slot, lay, words)))
    return (out[:c_n * t_n].view(c_n, t_n),
            out[c_n * t_n:c_n * t_n + t_n], out[c_n * t_n + t_n:])
