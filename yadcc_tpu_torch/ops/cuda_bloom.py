"""Wrappers of the Bloom kernels (csrc/bloom.cu).

The counterparts of the JAX package's Bloom device functions:

  bloom_membership  <- ops/bloom_pipeline.py:bloom_membership_from_keys
  bloom_cascade     <- parallel/mesh.py:sharded_bloom_cascade_fn, one card
  bloom_probe       <- ops/bloom_probe.py:bloom_may_contain
  bloom_scatter_or  <- ops/bloom_probe.py:bloom_scatter_add

Routing follows the tensors: CPU tensors go to the plain versions
(ops/bloom_pipeline.py, ops/bloom_probe.py); CUDA tensors launch the
kernel, and anything the kernel does not take raises, on either route.
Filter words, packed keys and fingerprints are int32 tensors holding the
bit pattern of the host's uint32 arrays; seeds are (hi, lo) uint32 pairs
(bloom_pipeline.seed_pair).  Packed keys may be any contiguous view (its
base only 4-byte aligned, e.g. one word into a buffer) and of any key
length: the kernels stage rows of 32 to 128 bytes whose width is a multiple
of 16 bytes and read the others from device memory.

`launches` counts, by kernel name, the calls on the card that launched
the kernel (one a call with a non-empty batch; a scatter-OR call is two
launches, its bin and own passes, or two a pass when the batch outgrows
the scratch), so a run can show that its main path went through the
kernels.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, NamedTuple

import torch

from . import bloom_pipeline as bpl
from . import bloom_probe as bpr

SOURCE = "bloom.cu"
KERNELS = ("membership", "cascade", "probe", "scatter_or")
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
        }
        fns = {}
        for name, (fn, argtypes) in sigs.items():
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            fns[name] = fn
        for name in ("tile_keys", "scatter_bin_threads",
                     "scatter_bin_probes"):
            fn = getattr(lib, f"yadcc_bloom_{name}")
            fn.argtypes = []
            fn.restype = ctypes.c_int
            fns[name] = fn
        got = (fns["scatter_bin_threads"](), fns["scatter_bin_probes"]())
        if got != (BIN_THREADS, BIN_PROBES):
            raise RuntimeError(f"{SOURCE} bins {got} (threads, probes), the "
                               f"plan assumes {(BIN_THREADS, BIN_PROBES)}")
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
