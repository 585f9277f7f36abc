"""Host packing for the Bloom and placement kernels, torch-free.

The key-byte layout the device digest reads, and the salt's seed pair,
built on the host with numpy only, so the scheduler's host placement
oracle (scheduler/placement_host.py) loads no torch.
``ops/bloom_pipeline.py`` re-exports both names.
"""

from __future__ import annotations

import numpy as np

M32 = 0xFFFFFFFF


def seed_pair(salt: int) -> np.ndarray:
    """uint32[2] (hi, lo) seed for the device digest from a filter salt
    — same masking as the host path (common/bloom.py)."""
    s = salt & 0xFFFFFFFFFFFFFFFF
    return np.asarray([s >> 32, s & M32], np.uint32)


def pack_key_buckets(keys) -> list:
    """[(length, row_indices, uint32 [M, ceil(length/8)*2] matrix)] per
    byte-length class — the xxh64_device input layout, built with the
    same C-level pack + vectorized grouping as the host digest
    (common/xxh64_np.py): no per-key Python anywhere.  The pack is the
    host's entire job on the fused path, so its cost IS the host-side
    cost."""
    from ..common.xxh64_np import pack_key_matrix

    n = len(keys)
    if n == 0:
        return []
    try:
        mat, lengths = pack_key_matrix(keys)
    except UnicodeEncodeError:  # non-ASCII str keys: utf-8, re-pack
        mat, lengths = pack_key_matrix(
            [k.encode() if isinstance(k, str) else k for k in keys])
    lo = int(lengths.min())
    if lo == int(lengths.max()):
        # Single length class (fixed-width production keys): the pack
        # IS the bucket — no sort, no gather.
        return [(lo, slice(None), mat.view("<u4"))]
    order = np.argsort(lengths, kind="stable")
    sl = lengths[order]
    group_starts = np.flatnonzero(np.diff(sl, prepend=-1))
    buckets = []
    for gi, gs in enumerate(group_starts):
        ge = group_starts[gi + 1] if gi + 1 < len(group_starts) else n
        length = int(sl[gs])
        idxs = order[gs:ge]
        aligned = length + (-length) % 8
        sub = (mat if len(idxs) == n and mat.shape[1] == aligned
               else np.ascontiguousarray(mat[idxs, :aligned]))
        buckets.append((length, idxs, sub.view("<u4")))
    return buckets
