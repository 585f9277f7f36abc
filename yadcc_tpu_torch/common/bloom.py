"""Salted Bloom filter over a numpy bit-array.

A copy of the JAX package's host filter (yadcc_tpu/common/bloom.py),
kept in the port so that it stands alone, with one difference: every
XXH64 digest comes from the port's own vectorized numpy XXH64
(common/xxh64_np.py), not from the `xxhash` wheel, which the port does
not import.  The digests are the same (tests/test_torch_bloom.py holds
them against the wheel).

Host-side twin of the device probe in ops/bloom_probe.py and the CUDA
kernels in csrc/bloom.cu: both sides derive probe indices identically
(uint32 double hashing from a salted XXH64 fingerprint), so a filter
built here can be shipped to the card (or to a remote daemon,
zstd-compressed) and probed there bit-for-bit compatibly.

Parity: reference flare SaltedBloomFilter as used by
yadcc/cache/bloom_filter_generator.h:64-68 (27,584,639 bits / 10 hashes,
sized for 1M keys at 1e-5 false-positive rate) and the client-side
replica in yadcc/daemon/local/distributed_cache_reader.h:32-56.
"""

from __future__ import annotations

import sys
from typing import Iterable, List, Tuple

import numpy as np

from . import xxh64_np

# Same constants as the reference's generator.
DEFAULT_NUM_BITS = 27_584_639
DEFAULT_NUM_HASHES = 10


def key_fingerprint(key: str, salt: int) -> Tuple[int, int]:
    """(h1, h2) uint32 pair for double hashing; h2 forced odd so the
    probe sequence cycles through the whole ring.  One key takes the
    scalar digest (xxh64_int, tens of microseconds; the batch digest
    costs ~0.3 ms for a batch of one): a cache fill adds its key to the
    filter this way, and the reader's try_read tests one."""
    fp = xxh64_np.xxh64_int(key.encode(), salt & 0xFFFFFFFFFFFFFFFF)
    h1 = fp & 0xFFFFFFFF
    h2 = ((fp >> 32) | 1) & 0xFFFFFFFF
    return h1, h2


def _digests_loop(keys: List[bytes], seed: int) -> np.ndarray:
    """One digest call per key (each a one-key vectorized batch): the
    per-key path key_fingerprints_loop keeps callable."""
    return np.fromiter(
        (xxh64_np.xxh64_keys([k], seed)[0] for k in keys),
        np.uint64, count=len(keys))


def _split_digests(dig: np.ndarray) -> np.ndarray:
    """uint64[N] digests -> [N, 2] uint32 (h1, h2), h2 forced odd —
    the ONE host-side statement of the fingerprint split (the device
    twin lives in ops/bloom_pipeline.py)."""
    if sys.byteorder == "little":
        # A little-endian u64 is already its (lo, hi) u32 pair in
        # memory: one reinterpreting copy + one in-place OR, instead
        # of two mask/shift/narrow passes over the whole batch.
        out = dig.view(np.uint32).reshape(len(dig), 2).copy()
        out[:, 1] |= 1
        return out
    out = np.empty((len(dig), 2), np.uint32)
    out[:, 0] = (dig & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    out[:, 1] = (((dig >> np.uint64(32)) | np.uint64(1))
                 & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    return out


def key_fingerprints_loop(keys: Iterable[str], salt: int) -> np.ndarray:
    """Per-key-loop twin of key_fingerprints (same result)."""
    if not isinstance(keys, (list, tuple)):
        keys = list(keys)
    seed = salt & 0xFFFFFFFFFFFFFFFF
    return _split_digests(_digests_loop([k.encode() for k in keys], seed))


def key_fingerprints(keys: Iterable[str], salt: int) -> np.ndarray:
    """[N, 2] uint32 fingerprint array for batched (device) probing.

    Keys are packed into one [N, L] uint8 matrix and digested
    lane-parallel per byte-length class by the vectorized XXH64
    (common/xxh64_np.py).  The JAX package sends batches under 64 keys
    to a per-key call of the `xxhash` wheel instead; without the wheel
    the vectorized digest serves every size."""
    if not isinstance(keys, (list, tuple)):
        keys = list(keys)
    seed = salt & 0xFFFFFFFFFFFFFFFF
    # str keys go straight to the packer — a per-key .encode() list
    # would cost a quarter of the whole vectorized budget.
    return _split_digests(xxh64_np.xxh64_keys(keys, seed))


def probe_indices_batch(fps: np.ndarray, num_hashes: int,
                        num_bits: int) -> np.ndarray:
    """[N, K] int64 probe indices for an [N, 2] fingerprint batch —
    the vectorized restatement of probe_indices (same uint32
    wrap-around then mod num_bits; keep all three in sync:
    probe_indices, this, and ops/bloom_probe.py:probe_body, with
    csrc/bloom.cu's probe loop)."""
    i = np.arange(num_hashes, dtype=np.uint32)[None, :]
    h1 = fps[:, 0][:, None]
    h2 = fps[:, 1][:, None]
    return ((h1 + i * h2) % np.uint32(num_bits)).astype(np.int64)


def probe_indices(h1: int, h2: int, num_hashes: int, num_bits: int) -> np.ndarray:
    i = np.arange(num_hashes, dtype=np.uint32)
    # uint32 wrap-around then mod num_bits — the device kernel does the
    # exact same arithmetic, keep in sync with ops/bloom_probe.py.
    return ((np.uint32(h1) + i * np.uint32(h2)) % np.uint32(num_bits)).astype(
        np.int64
    )


class SaltedBloomFilter:
    """Bit-array Bloom filter with a per-instance salt.

    The salt makes filters from different server generations mutually
    incompatible on purpose: a client syncing against a rebuilt filter
    must do a full re-fetch rather than silently mixing bit positions.
    """

    def __init__(
        self,
        num_bits: int = DEFAULT_NUM_BITS,
        num_hashes: int = DEFAULT_NUM_HASHES,
        salt: int = 0,
        words: np.ndarray | None = None,
    ):
        self.num_bits = num_bits
        self.num_hashes = num_hashes
        self.salt = salt
        nwords = (num_bits + 31) // 32
        if words is None:
            self._words = np.zeros(nwords, dtype=np.uint32)
        else:
            # Explicit validation, not an assert: word arrays arrive
            # from the network (filter replicas), and a truncated fetch
            # must be a clean error even under `python -O`.
            if words.shape != (nwords,):
                raise ValueError(
                    f"filter data holds {words.shape[0]} words, "
                    f"{num_bits} bits needs {nwords}")
            self._words = words.astype(np.uint32, copy=False)

    # -- mutation ---------------------------------------------------------

    def add(self, key: str) -> None:
        h1, h2 = key_fingerprint(key, self.salt)
        idx = probe_indices(h1, h2, self.num_hashes, self.num_bits)
        np.bitwise_or.at(
            self._words, idx >> 5, (np.uint32(1) << (idx & 31).astype(np.uint32))
        )

    def add_many(self, keys: Iterable[str]) -> None:
        """Batched insert: one vectorized fingerprint pass, one [N, K]
        index derivation, one scatter-OR — the filter-rebuild hot path
        (a 1M-key rebuild was 1M per-key digest calls before)."""
        if not isinstance(keys, (list, tuple)):
            keys = list(keys)
        if not keys:
            return
        fps = key_fingerprints(keys, self.salt)
        idx = probe_indices_batch(fps, self.num_hashes, self.num_bits)
        np.bitwise_or.at(
            self._words, idx >> 5,
            (np.uint32(1) << (idx & 31).astype(np.uint32)))

    # -- queries ----------------------------------------------------------

    def may_contain(self, key: str) -> bool:
        h1, h2 = key_fingerprint(key, self.salt)
        idx = probe_indices(h1, h2, self.num_hashes, self.num_bits)
        bits = (self._words[idx >> 5] >> (idx & 31).astype(np.uint32)) & 1
        return bool(bits.all())

    def may_contain_batch(self, keys: Iterable[str]) -> np.ndarray:
        """bool[N] membership, fully vectorized on the host: batched
        fingerprints feed one [N, K] gather.  Bit-identical to
        may_contain per key (asserted by tests/test_torch_bloom.py)."""
        if not isinstance(keys, (list, tuple)):
            keys = list(keys)
        if not keys:
            return np.zeros(0, bool)
        fps = key_fingerprints(keys, self.salt)
        idx = probe_indices_batch(fps, self.num_hashes, self.num_bits)
        bits = (self._words[idx >> 5] >> (idx & 31).astype(np.uint32)) & 1
        return bits.all(axis=1)

    def fill_ratio(self) -> float:
        ones = int(np.unpackbits(self._words.view(np.uint8)).sum())
        return ones / (len(self._words) * 32)

    # -- (de)serialization -------------------------------------------------

    @property
    def words(self) -> np.ndarray:
        return self._words

    def to_bytes(self) -> bytes:
        return self._words.tobytes()

    @classmethod
    def from_bytes(
        cls,
        data: bytes,
        num_hashes: int,
        salt: int,
        num_bits: int | None = None,
    ) -> "SaltedBloomFilter":
        if len(data) % 4:
            raise ValueError(f"filter data length {len(data)} is not "
                             "a whole number of u32 words")
        words = np.frombuffer(data, dtype=np.uint32).copy()
        if num_bits is None:
            # The wire protocol doesn't carry num_bits (parity with the
            # reference, where it's a shared constant).  Inferring
            # len(words)*32 for arbitrary sizes would silently disagree
            # with the modulus the filter was built with, so only the default
            # is inferable.
            if (DEFAULT_NUM_BITS + 31) // 32 != len(words):
                raise ValueError(
                    "num_bits must be given for non-default filter sizes"
                )
            num_bits = DEFAULT_NUM_BITS
        return cls(num_bits, num_hashes, salt, words)
