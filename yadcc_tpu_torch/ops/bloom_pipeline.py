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
from .xxh64_torch import M32, xxh64_device  # noqa: F401
# The host packing (torch-free) lives in bloom_pack.py; its names stay
# importable from here.
from .bloom_pack import pack_key_buckets, seed_pair  # noqa: F401


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


def probe_range_plain(words_slice, fingerprints, num_bits, num_hashes,
                      word_lo: int) -> torch.Tensor:
    """bool[N]: probe_body over one slice of the filter, words
    [word_lo, word_lo + len(words_slice)); a probe outside the slice
    counts as set (yadcc_tpu/parallel/mesh.py:455-466), so the AND over
    the slices' verdicts is the filter's."""
    from .bloom_probe import probe_indices

    idx = probe_indices(fingerprints, num_bits, num_hashes)
    local = (idx >> 5) - word_lo
    nw = words_slice.shape[0]
    mine = (local >= 0) & (local < nw)
    word = words_slice[local.clamp(0, max(nw - 1, 0))].to(torch.int64)
    bit = (word >> (idx & 31)) & 1
    return torch.all((bit == 1) | ~mine, dim=1)


def membership_range_plain(words_slice, packed_keys, length, seed,
                           num_bits, num_hashes, word_lo) -> torch.Tensor:
    """The plain version of the filter-sharded membership of one slice
    (csrc/bloom.cu: membership_range_kernel)."""
    hi, lo = xxh64_device(packed_keys, length, seed)
    return probe_range_plain(words_slice, split_fingerprints(hi, lo),
                             num_bits, num_hashes, word_lo)


def cascade_pair_plain(region_slice, fleet_slice, packed_keys, length,
                       region_seed, fleet_seed, num_bits,
                       num_hashes_region, num_hashes_fleet,
                       word_lo) -> torch.Tensor:
    """uint8[N] codes of one slice, bit 0 the region's verdict and bit 1
    the fleet's (csrc/bloom.cu: cascade_pair_kernel)."""
    r = membership_range_plain(region_slice, packed_keys, length,
                               region_seed, num_bits, num_hashes_region,
                               word_lo)
    f = membership_range_plain(fleet_slice, packed_keys, length, fleet_seed,
                               num_bits, num_hashes_fleet, word_lo)
    return r.to(torch.uint8) | (f.to(torch.uint8) << 1)


def placement_score_plain(words, seeds, terms, packed, task_of_key, counts,
                          *, length, num_bits, num_hashes, warm_scale,
                          w_warm, w_load, w_topo, device):
    """The plain version of the cells x tasks placement score
    (yadcc_tpu/parallel/mesh.py:placement_score_fn; ops/cuda_bloom.py:
    placement_score takes the same arguments).  ``words`` holds one
    int32 filter word tensor per cell, or None for a cell without a
    filter; ``seeds`` uint32 [C, 2] (hi, lo); ``terms`` int32 [4, C] rows
    util_q, topo_q, eligible, has_filter; ``packed`` uint32 [N,
    ceil(length/8)*2]; ``task_of_key`` int32 [N] (-1 for padding keys);
    ``counts`` int32 [T].  Host arrays go to ``device`` first.  Returns
    (scores int32 [C, T], best cell int32 [T], best score int32 [T]):

        miss_q = (counts - hits) * warm_scale // max(counts, 1)
                 (warm_scale for a cell without a filter)
        score  = w_warm * miss_q + w_load * util_q + w_topo * topo_q
                 (2^30 for an ineligible cell)

    in int32, wrapping as jnp wraps; the best cell is the first minimum."""
    dev = torch.device(device)

    def up(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)

    packed_t = as_device_words(packed, dev)
    tok = up(task_of_key)
    counts_t = up(counts)
    terms_t = up(terms)
    t_n = counts_t.shape[0]
    onehot = tok[:, None] == torch.arange(t_n, dtype=torch.int32,
                                          device=dev)[None, :]
    hits = torch.zeros((len(words), t_n), dtype=torch.int32, device=dev)
    for c, w in enumerate(words):
        if w is None:
            continue
        ok = membership_plain(w, packed_t, length, seeds[c], num_bits,
                              num_hashes)
        hits[c] = (ok[:, None] & onehot).sum(0, dtype=torch.int32)
    miss = torch.div((counts_t[None, :] - hits) * warm_scale,
                     torch.clamp(counts_t, min=1)[None, :],
                     rounding_mode="floor")
    miss = torch.where(terms_t[3][:, None] > 0, miss,
                       torch.full_like(miss, warm_scale))
    score = (w_warm * miss
             + (w_load * terms_t[0] + w_topo * terms_t[1])[:, None])
    score = torch.where(terms_t[2][:, None] > 0, score,
                        torch.full_like(score, 2 ** 30))
    best_cell = torch.argmin(score, dim=0).to(torch.int32)
    best_score = torch.gather(score, 0, best_cell.long()[None, :])[0]
    return score, best_cell, best_score


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
