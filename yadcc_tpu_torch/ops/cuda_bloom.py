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

`launches` counts kernel launches by kernel name (one per call on the
card with a non-empty batch), so a run can show that its main path went
through the kernels.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict

import torch

from . import bloom_pipeline as bpl
from . import bloom_probe as bpr

SOURCE = "bloom.cu"
KERNELS = ("membership", "cascade", "probe", "scatter_or")
# Bound on the hash count: far above any filter's (the reference uses
# 10), low enough that N*K threads of the scatter stay countable.
MAX_HASHES = 1 << 16

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
            "scatter_or": (lib.yadcc_bloom_scatter_or, [p, u, i, p, i, p]),
        }
        fns = {}
        for name, (fn, argtypes) in sigs.items():
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            fns[name] = fn
        lib.yadcc_bloom_tile_keys.argtypes = []
        lib.yadcc_bloom_tile_keys.restype = ctypes.c_int
        fns["tile_keys"] = lib.yadcc_bloom_tile_keys
        _fns = fns
    return _fns


def tile_keys() -> int:
    """Keys a block of the membership and cascade kernels stages at a time
    (builds the kernels on first use)."""
    return int(_kernels()["tile_keys"]())


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
    bloom_probe.scatter_add_plain."""
    dev = _device(words, "scatter-or")
    _check_geometry(num_bits, num_hashes)
    _check_words("words", words, num_bits, dev)
    n = _check_fingerprints(fingerprints, dev)
    if dev.type == "cpu":
        return bpr.scatter_add_plain(words, fingerprints, num_bits,
                                     num_hashes)
    out = words.clone()
    if n == 0 or num_hashes == 0:
        return out
    fn = _kernels()["scatter_or"]
    with torch.cuda.device(dev):
        err = fn(out.data_ptr(), num_bits, num_hashes,
                 fingerprints.data_ptr(), n, _stream(dev))
    _launched("scatter_or", err)
    return out
