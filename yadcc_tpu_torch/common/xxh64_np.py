"""Vectorized XXH64 over key batches (numpy u64, lane-parallel).

A copy of the JAX package's host digest (yadcc_tpu/common/xxh64_np.py),
kept in the port so that it stands alone.  The Bloom control plane
fingerprints millions of cache keys (common/bloom.py); this module
computes the XXH64 digest lane-parallel over a [N, L] byte matrix (~30
u64 vector ops per 32-byte stripe amortized across the whole batch),
with the batch->matrix pack itself done in one C-level numpy conversion
and the vector math running in cache-sized chunks through preallocated
scratch buffers.

It is the port's only host XXH64: common/bloom.py takes every digest
from here and imports no `xxhash` wheel.  Bit-identical to the public
XXH64 spec; tests/test_torch_bloom.py holds it against the wheel and
the JAX package over every tail-length class.  numpy's u64 arithmetic
wraps modulo 2^64, which is exactly the semantics the algorithm needs.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

_P1 = np.uint64(0x9E3779B185EBCA87)
_P2 = np.uint64(0xC2B2AE3D27D4EB4F)
_P3 = np.uint64(0x165667B19E3779F9)
_P4 = np.uint64(0x85EBCA77C2B2AE63)
_P5 = np.uint64(0x27D4EB2F165667C5)
_M64 = np.uint64(0xFFFFFFFFFFFFFFFF)


# Rows per digest chunk: the lane math runs ~40-60 full-vector passes,
# so the working set (h/t/s/l u64 buffers + the byte rows) must stay
# cache-resident or every pass round-trips DRAM.  16k rows keeps it
# ~1MB — L2-sized (the JAX package's sweep chose it).
_CHUNK_ROWS = 16_384


def xxh64_batch(data: np.ndarray, seed: int,
                length: int | None = None) -> np.ndarray:
    """XXH64 of every row of a [N, W] uint8 matrix (one key per row,
    each key being the row's first `length` bytes — all of them when
    `length` is None), with the given seed.  Returns uint64[N].

    When W is exactly `length` rounded up to 8 and the bytes past
    `length` are zero (the pack_key_matrix layout), rows digest
    straight out of the caller's matrix — no pad copy.  Large batches
    run in cache-sized row chunks, and every vector op writes into one
    of three preallocated scratch buffers: a fresh 1MB numpy temporary
    per op is an mmap/page-fault round-trip at glibc's allocation
    threshold."""
    if data.ndim != 2 or data.dtype != np.uint8:
        raise ValueError("data must be a [N, L] uint8 matrix")
    n, width = data.shape
    if length is None:
        length = width
    elif length > width:
        raise ValueError(f"length {length} exceeds row width {width}")
    out = np.empty(n, np.uint64)
    c = min(n, _CHUNK_ROWS)
    scratch = tuple(np.empty(c, np.uint64) for _ in range(3))
    for i in range(0, n, _CHUNK_ROWS):
        _xxh64_batch_chunk(data[i:i + _CHUNK_ROWS], seed, length,
                           scratch, out[i:i + _CHUNK_ROWS])
    return out


_U64 = np.uint64


def _rotl_ip(x: np.ndarray, r: int, tmp: np.ndarray) -> None:
    """x <- rotl64(x, r), elementwise in place (tmp: same-shape u64)."""
    np.left_shift(x, _U64(r), out=tmp)
    np.right_shift(x, _U64(64 - r), out=x)
    np.bitwise_or(x, tmp, out=x)


def _rotl_into(x: np.ndarray, r: int, res: np.ndarray,
               tmp: np.ndarray) -> None:
    """res <- rotl64(x, r) without touching x (res, tmp distinct)."""
    np.left_shift(x, _U64(r), out=tmp)
    np.right_shift(x, _U64(64 - r), out=res)
    np.bitwise_or(res, tmp, out=res)


def _round_ip(acc: np.ndarray, lane: np.ndarray, t: np.ndarray) -> None:
    """acc <- rotl(acc + lane * P2, 31) * P1 (the XXH64 round)."""
    np.multiply(lane, _P2, out=t)
    np.add(acc, t, out=acc)
    _rotl_ip(acc, 31, t)
    np.multiply(acc, _P1, out=acc)


def _merge_round_ip(h: np.ndarray, acc: np.ndarray, t: np.ndarray,
                    s: np.ndarray) -> None:
    """h <- (h ^ round(0, acc)) * P1 + P4, preserving acc."""
    np.multiply(acc, _P2, out=t)
    _rotl_ip(t, 31, s)
    np.multiply(t, _P1, out=t)
    np.bitwise_xor(h, t, out=h)
    np.multiply(h, _P1, out=h)
    np.add(h, _P4, out=h)


def _xxh64_batch_chunk(data: np.ndarray, seed: int, length: int,
                       scratch: tuple, h: np.ndarray) -> None:
    """Digest one row chunk into `h` (uint64[n] output buffer)."""
    n = data.shape[0]
    t, s, l = (a[:n] for a in scratch)
    seed_i = int(seed) & int(_M64)

    # All u64 reads land on 8-byte offsets (stripes consume 32, the
    # tail loop 8 at a time) and the sole u32 read on a 4-byte offset,
    # so the matrix must be an 8-byte-multiple width to reinterpret:
    # each read is then one contiguous little-endian column view.
    # pack_key_matrix emits exactly that layout (zero tail bytes), so
    # the pad copy below only runs for hand-built matrices.
    aligned = length + (-length) % 8
    if data.shape[1] == aligned:
        padded = np.ascontiguousarray(data)
    else:
        padded = np.ascontiguousarray(
            np.pad(data[:, :length], ((0, 0), (0, aligned - length))))
    w64 = padded.view("<u8")
    w32 = padded.view("<u4")

    def lane64(off: int) -> np.ndarray:
        l[:] = w64[:, off // 8]
        return l

    pos = 0
    if length >= 32:
        # Seed-derived init constants wrap mod 2^64 by design; compute
        # in Python ints and mask, so numpy's scalar-overflow warning
        # machinery never fires on the intended wrap.
        acc1 = np.full(n, (seed_i + int(_P1) + int(_P2)) & int(_M64),
                       np.uint64)
        acc2 = np.full(n, (seed_i + int(_P2)) & int(_M64), np.uint64)
        acc3 = np.full(n, seed_i, np.uint64)
        acc4 = np.full(n, (seed_i - int(_P1)) & int(_M64), np.uint64)
        while pos + 32 <= length:
            _round_ip(acc1, lane64(pos), t)
            _round_ip(acc2, lane64(pos + 8), t)
            _round_ip(acc3, lane64(pos + 16), t)
            _round_ip(acc4, lane64(pos + 24), t)
            pos += 32
        _rotl_into(acc1, 1, h, t)
        for acc, r in ((acc2, 7), (acc3, 12), (acc4, 18)):
            _rotl_into(acc, r, s, t)
            np.add(h, s, out=h)
        for acc in (acc1, acc2, acc3, acc4):
            _merge_round_ip(h, acc, t, s)
    else:
        h.fill((seed_i + int(_P5)) & int(_M64))
    np.add(h, _U64(length), out=h)

    while pos + 8 <= length:
        # h <- rotl(h ^ round(0, lane), 27) * P1 + P4
        np.multiply(lane64(pos), _P2, out=t)
        _rotl_ip(t, 31, s)
        np.multiply(t, _P1, out=t)
        np.bitwise_xor(h, t, out=h)
        _rotl_ip(h, 27, s)
        np.multiply(h, _P1, out=h)
        np.add(h, _P4, out=h)
        pos += 8
    if pos + 4 <= length:
        l[:] = w32[:, pos // 4]          # u32 read, zero-extended
        np.multiply(l, _P1, out=t)
        np.bitwise_xor(h, t, out=h)
        _rotl_ip(h, 23, s)
        np.multiply(h, _P2, out=h)
        np.add(h, _P3, out=h)
        pos += 4
    while pos < length:
        l[:] = data[:, pos]              # single byte, zero-extended
        np.multiply(l, _P5, out=t)
        np.bitwise_xor(h, t, out=h)
        _rotl_ip(h, 11, s)
        np.multiply(h, _P1, out=h)
        pos += 1

    # Avalanche: h ^= h>>33; h*=P2; h^=h>>29; h*=P3; h^=h>>32.
    for shift, prime in ((33, _P2), (29, _P3), (32, None)):
        np.right_shift(h, _U64(shift), out=t)
        np.bitwise_xor(h, t, out=h)
        if prime is not None:
            np.multiply(h, prime, out=h)


def pack_key_matrix(keys: Sequence) -> tuple:
    """(matrix [N, W] uint8 zero-padded, lengths int64[N]) for a batch
    of str or bytes keys — the C-level pack feeding both the host
    vectorized digest and the device pipeline.

    numpy's fixed-width "S" conversion does the whole encode+pad in one
    C loop (no per-key Python), preserves embedded AND trailing NUL
    bytes, and refuses non-ASCII str (UnicodeEncodeError) — for the
    ASCII keys it accepts, len(str) == byte length, so `lengths` is
    exact even where the padding makes the matrix itself ambiguous."""
    n = len(keys)
    lengths = np.fromiter(map(len, keys), np.int64, count=n)
    width = int(lengths.max()) if n else 0
    if width == 0:
        return np.zeros((n, 0), np.uint8), lengths
    # Width rounded to 8 bytes: the digest reads u64 columns, and this
    # makes the pack itself the aligned zero-tailed layout xxh64_batch
    # consumes copy-free.
    width += (-width) % 8
    arr = np.array(keys, dtype=f"S{width}")
    return arr.view(np.uint8).reshape(n, width), lengths


def xxh64_keys(keys: Sequence, seed: int) -> np.ndarray:
    """XXH64 over variable-length str-or-bytes keys: one C-level pack
    into a padded byte matrix, then the grouped lane-parallel digest.
    No per-key Python work anywhere."""
    if len(keys) == 0:
        return np.empty(0, np.uint64)
    try:
        mat, lengths = pack_key_matrix(keys)
    except UnicodeEncodeError:
        # Non-ASCII str keys: per-key utf-8 encode, then re-pack.  Rare
        # (cache keys are hex digests); correctness over speed here.
        mat, lengths = pack_key_matrix(
            [k.encode() if isinstance(k, str) else k for k in keys])
    return xxh64_grouped(mat, lengths, seed)


def xxh64_grouped(mat: np.ndarray, lengths: np.ndarray,
                  seed: int) -> np.ndarray:
    """Digest phase over a pack_key_matrix layout: vectorized length
    grouping (stable argsort), one lane-parallel digest per length
    class, results scattered back in input order.  Split out from
    xxh64_keys so the benchmark can time packing and digesting
    separately — they are different budgets (data layout vs hashing)."""
    n = mat.shape[0]
    out = np.empty(n, np.uint64)
    if n == 0:
        return out
    lo = int(lengths.min())
    if lo == int(lengths.max()):
        # Single length class (THE steady-state shape: fixed-width
        # cache-entry digests) — skip the grouping sort entirely.
        return xxh64_batch(mat, seed, lo)
    order = np.argsort(lengths, kind="stable")
    sl = lengths[order]
    group_starts = np.flatnonzero(np.diff(sl, prepend=-1))
    for gi, gs in enumerate(group_starts):
        ge = group_starts[gi + 1] if gi + 1 < len(group_starts) else n
        length = int(sl[gs])
        idxs = order[gs:ge]
        if len(idxs) == n:
            # Single length class (THE steady-state shape: fixed-width
            # cache-entry digests) — no gather, no copy: the digest
            # reads straight out of the pack.
            return xxh64_batch(mat, seed, length)
        aligned = length + (-length) % 8
        sub = np.ascontiguousarray(mat[idxs, :aligned]) if length else \
            np.zeros((len(idxs), 0), np.uint8)
        out[idxs] = xxh64_batch(sub, seed, length)
    return out
