"""Fused fingerprint->probe Bloom pipeline: raw key bytes up, bool back.

The counterpart of yadcc_tpu/ops/bloom_pipeline.py.  One call takes the
packed key-byte matrix, computes the XXH64 digest on the card, applies the
odd-forcing (h1, h2) split the host uses (common/bloom.py:_split_digests)
and probes the filter words: on the card that is ONE launch of the
hand-written kernel in csrc/bloom.cu (ops/cuda_bloom.py), so no
fingerprint makes a round trip through the host; the only host-to-device
traffic is the key bytes, the only device-to-host traffic a bool[N].  On
the CPU the same call runs the plain versions below (`membership_plain`,
`cascade_plain`), which chain ops/xxh64_torch.py and ops/bloom_probe.py.

Layouts on the card: filter words are an int32 tensor holding the uint32
bit pattern of the host's word array, packed keys an int32 [N,
ceil(length/8)*2] tensor holding pack_keys' uint32 words, seeds (hi, lo)
uint32 pairs from seed_pair.

Variable-length batches ride the same length bucketing the host
vectorized path uses: one call per byte-length class.  The kernel takes
the length at run time, so every class runs the same compiled code.
"""

from __future__ import annotations

import numpy as np
import torch

from .bloom_probe import probe_body
from .xxh64_torch import M32, xxh64_device


def seed_pair(salt: int) -> np.ndarray:
    """uint32[2] (hi, lo) seed for the device digest from a filter salt
    — same masking as the host path (common/bloom.py)."""
    s = salt & 0xFFFFFFFFFFFFFFFF
    return np.asarray([s >> 32, s & M32], np.uint32)


def as_device_words(arr: np.ndarray, device) -> torch.Tensor:
    """A uint32 numpy array as the int32 tensor (same bit pattern) the
    card's functions take, on ``device``."""
    a = np.ascontiguousarray(arr, dtype=np.uint32)
    return torch.from_numpy(a.view(np.int32)).to(device)


def split_fingerprints(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """[N, 2] (h1, h2) from digest halves: h1 = low word, h2 = high word
    forced odd (the device twin of common/bloom.py:_split_digests)."""
    return torch.stack([lo, hi | 1], dim=1)


def membership_plain(words, packed_keys, length, seed, num_bits,
                     num_hashes) -> torch.Tensor:
    """The plain version of bloom_membership_from_keys."""
    hi, lo = xxh64_device(packed_keys, length, seed)
    return probe_body(words, split_fingerprints(hi, lo), num_bits,
                      num_hashes)


def cascade_plain(region_words, fleet_words, packed_keys, length,
                  region_seed, fleet_seed, num_bits, num_hashes_region,
                  num_hashes_fleet) -> torch.Tensor:
    """The plain version of bloom_cascade_from_keys."""
    return (membership_plain(region_words, packed_keys, length, region_seed,
                             num_bits, num_hashes_region)
            | membership_plain(fleet_words, packed_keys, length, fleet_seed,
                               num_bits, num_hashes_fleet))


def bloom_membership_from_keys(
    words: torch.Tensor,        # int32[W] filter bit-array
    packed_keys: torch.Tensor,  # int32[N, ceil(length/8)*2] (pack_keys)
    length: int,                # key byte length
    seed,                       # uint32[2] (hi, lo), see seed_pair
    *,
    num_bits: int,
    num_hashes: int,
) -> torch.Tensor:
    """bool[N] membership: device XXH64 -> odd-h2 split -> probe, one
    kernel launch on the card.  Bit-identical to the host chain
    key_fingerprint -> probe_indices -> word test (asserted by
    tests/test_torch_bloom.py)."""
    from . import cuda_bloom

    return cuda_bloom.bloom_membership(words, packed_keys, length, seed,
                                       num_bits=num_bits,
                                       num_hashes=num_hashes)


def bloom_cascade_from_keys(
    region_words: torch.Tensor,
    fleet_words: torch.Tensor,
    packed: torch.Tensor,
    length: int,
    region_seed,
    fleet_seed,
    *,
    num_bits: int,
    num_hashes_region: int,
    num_hashes_fleet: int,
) -> torch.Tensor:
    """bool[N]: (every region probe bit set) OR (every fleet probe bit
    set), each filter with its own seed and hash count, in one launch on
    the card.  The one-card body of yadcc_tpu/parallel/mesh.py:
    sharded_bloom_cascade_fn: with no shard axis, the per-filter AND over
    the K probes completes before the OR across the two filters.  Both
    filters share num_bits."""
    from . import cuda_bloom

    return cuda_bloom.bloom_cascade(
        region_words, fleet_words, packed, length, region_seed, fleet_seed,
        num_bits=num_bits, num_hashes_region=num_hashes_region,
        num_hashes_fleet=num_hashes_fleet)


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


def bloom_membership_batch(
    words_dev: torch.Tensor,
    keys,
    salt: int,
    *,
    num_bits: int,
    num_hashes: int,
) -> np.ndarray:
    """Variable-length front door over the fused kernel: bucket keys by
    byte length, pack each bucket (the host's only job), run one fused
    call per length class on the device of ``words_dev``, scatter the
    bools back in input order.

    ``words_dev`` is the filter's word array (as_device_words), already
    resident on the device (upload once per filter sync, not per
    batch)."""
    out = np.empty(len(keys), bool)
    seed = seed_pair(salt)
    for length, idxs, packed in pack_key_buckets(keys):
        got = bloom_membership_from_keys(
            words_dev, as_device_words(packed, words_dev.device), length,
            seed, num_bits=num_bits, num_hashes=num_hashes)
        out[idxs] = got.cpu().numpy()
    return out
