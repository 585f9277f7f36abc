"""XXH64 of packed key bytes as plain PyTorch: the plain version of the
digest that csrc/bloom.cu computes on the card.

The counterpart of yadcc_tpu/ops/xxh64_jax.py (xxh64_device, pack_keys).
PyTorch has no usable uint32 (`>>` is not implemented for it) and its
int64 `>>` is arithmetic, so the 64-bit arithmetic rides (hi, lo) pairs of
int64 tensors that hold values in [0, 2^32), as the JAX module's uint32
pairs do: every shift sees a non-negative number, every sum is masked back
to 32 bits, and multiplication decomposes into 16-bit limbs whose partial
products stay below 2^32, so no int64 operation ever overflows.

This version is the one the tests hold against the JAX package and the
one chip_smoke.py holds the CUDA kernels against; it costs about 36
64-bit multiplies of ~40 elementwise ops each for an 80-byte key, so the
main path on the card runs the kernel (ops/cuda_bloom.py) instead.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

M32 = 0xFFFFFFFF
_M16 = 0xFFFF

P1 = (0x9E3779B1, 0x85EBCA87)
P2 = (0xC2B2AE3D, 0x27D4EB4F)
P3 = (0x165667B1, 0x9E3779F9)
P4 = (0x85EBCA77, 0xC2B2AE63)
P5 = (0x27D4EB2F, 0x165667C5)

Pair = Tuple[torch.Tensor, torch.Tensor]


def _split(v: int) -> Tuple[int, int]:
    v &= 0xFFFFFFFFFFFFFFFF
    return v >> 32, v & M32


def add64(a, b) -> Pair:
    """a + b mod 2^64; either operand may be an (int, int) constant."""
    lo = a[1] + b[1]
    return (a[0] + b[0] + (lo >> 32)) & M32, lo & M32


def mul64(a, b) -> Pair:
    """Low 64 bits of a*b via 16-bit limbs (xxh64_jax.py:mul64 restated:
    partial products < 2^32, a handful summed per limb)."""
    ah, al = a
    bh, bl = b
    a0, a1 = al & _M16, al >> 16
    a2, a3 = ah & _M16, ah >> 16
    b0, b1 = bl & _M16, bl >> 16
    b2, b3 = bh & _M16, bh >> 16

    p = a0 * b0
    acc0, acc1 = p & _M16, p >> 16
    acc2 = 0
    for x, y in ((a0, b1), (a1, b0)):
        p = x * y
        acc1, acc2 = acc1 + (p & _M16), acc2 + (p >> 16)
    acc3 = 0
    for x, y in ((a0, b2), (a1, b1), (a2, b0)):
        p = x * y
        acc2, acc3 = acc2 + (p & _M16), acc3 + (p >> 16)
    # Position 3's high halves would land at 2^64: dropped, the spec's
    # mod-2^64 wrap.
    acc3 = acc3 + (a0 * b3 & _M16) + (a1 * b2 & _M16) \
        + (a2 * b1 & _M16) + (a3 * b0 & _M16)

    r0 = acc0 & _M16
    acc1 = acc1 + (acc0 >> 16)
    r1 = acc1 & _M16
    acc2 = acc2 + (acc1 >> 16)
    r2 = acc2 & _M16
    acc3 = acc3 + (acc2 >> 16)
    r3 = acc3 & _M16
    return (r3 << 16) | r2, (r1 << 16) | r0


def xor64(a, b) -> Pair:
    return a[0] ^ b[0], a[1] ^ b[1]


def rotl64(a, r: int) -> Pair:
    ah, al = a
    r %= 64
    if r == 0:
        return a
    if r == 32:
        return al, ah
    if r > 32:
        ah, al = al, ah
        r -= 32
    return (((ah << r) & M32) | (al >> (32 - r)),
            ((al << r) & M32) | (ah >> (32 - r)))


def shr64(a, r: int) -> Pair:
    ah, al = a
    if r >= 32:
        return torch.zeros_like(ah), ah >> (r - 32)
    return ah >> r, (al >> r) | ((ah << (32 - r)) & M32)


def _round(acc, lane) -> Pair:
    acc = add64(acc, mul64(lane, P2))
    return mul64(rotl64(acc, 31), P1)


def _merge_round(h, acc) -> Pair:
    zero = torch.zeros_like(acc[0])
    h = xor64(h, _round((zero, zero), acc))
    return add64(mul64(h, P1), P4)


def _avalanche(h) -> Pair:
    h = mul64(xor64(h, shr64(h, 33)), P2)
    h = mul64(xor64(h, shr64(h, 29)), P3)
    return xor64(h, shr64(h, 32))


def xxh64_device(words: torch.Tensor, length: int, seed) -> Pair:
    """XXH64 of N keys of ``length`` bytes each.

    words: [N, ceil(length/8)*2] int32 (the bit pattern of the uint32
    little-endian packed key bytes, see pack_keys) or int64 holding the
    uint32 values.  seed: (hi, lo) uint32 pair (ops/bloom_pipeline.py:
    seed_pair).  Returns (hi, lo) int64[N] digest halves in [0, 2^32),
    on the device of ``words``.
    """
    n = words.shape[0]
    w = words.to(torch.int64) & M32
    hi0, lo0 = int(seed[0]) & M32, int(seed[1]) & M32
    seed64 = (torch.full((n,), hi0, dtype=torch.int64, device=w.device),
              torch.full((n,), lo0, dtype=torch.int64, device=w.device))

    def u64_at(off):
        return w[:, off // 4 + 1], w[:, off // 4]

    pos = 0
    if length >= 32:
        acc1 = add64(add64(seed64, P1), P2)
        acc2 = add64(seed64, P2)
        acc3 = seed64
        acc4 = add64(seed64, _split(-((P1[0] << 32) | P1[1])))
        while pos + 32 <= length:
            acc1 = _round(acc1, u64_at(pos))
            acc2 = _round(acc2, u64_at(pos + 8))
            acc3 = _round(acc3, u64_at(pos + 16))
            acc4 = _round(acc4, u64_at(pos + 24))
            pos += 32
        h = add64(add64(rotl64(acc1, 1), rotl64(acc2, 7)),
                  add64(rotl64(acc3, 12), rotl64(acc4, 18)))
        for acc in (acc1, acc2, acc3, acc4):
            h = _merge_round(h, acc)
    else:
        h = add64(seed64, P5)
    h = add64(h, _split(length))

    zero = torch.zeros(n, dtype=torch.int64, device=w.device)
    while pos + 8 <= length:
        h = xor64(h, _round((zero, zero), u64_at(pos)))
        h = add64(mul64(rotl64(h, 27), P1), P4)
        pos += 8
    if pos + 4 <= length:
        h = xor64(h, mul64((zero, w[:, pos // 4]), P1))
        h = add64(mul64(rotl64(h, 23), P2), P3)
        pos += 4
    while pos < length:
        byte = (w[:, pos // 4] >> (8 * (pos % 4))) & 0xFF
        h = xor64(h, mul64((zero, byte), P5))
        h = mul64(rotl64(h, 11), P1)
        pos += 1
    return _avalanche(h)


def pack_keys(keys: Sequence[bytes], length: int) -> np.ndarray:
    """[N, ceil(length/8)*2] uint32 little-endian key-byte matrix for
    xxh64_device; every key must be exactly ``length`` bytes."""
    n = len(keys)
    w = -(-length // 8) * 2          # u32 words, 8-byte aligned
    mat = np.zeros((n, w * 4), np.uint8)
    buf = np.frombuffer(b"".join(keys), np.uint8).reshape(n, length)
    mat[:, :length] = buf
    return np.ascontiguousarray(mat).view("<u4")
