"""Bloom-filter probes on the card: membership test and scatter-OR build.

The counterpart of yadcc_tpu/ops/bloom_probe.py.  The host keeps the
filter as a uint32 word array (common/bloom.py); the card holds the same
words as an int32 tensor (the uint32 bit pattern), and derives probe
indices with the identical uint32 double-hashing arithmetic, so host and
card membership always agree bit for bit.

`bloom_may_contain` and `bloom_scatter_add` are the public functions; a
call with CUDA tensors launches the hand-written kernels of csrc/bloom.cu
(through ops/cuda_bloom.py), a call with CPU tensors runs the plain
versions below (`probe_body`, `scatter_add_plain`).  Fingerprints are
[N, 2] (h1, h2): int32 (the uint32 bit pattern) or int64 holding the
uint32 values.
"""

from __future__ import annotations

from typing import Tuple

import torch

M32 = 0xFFFFFFFF


def probe_indices(fingerprints: torch.Tensor, num_bits: int,
                  num_hashes: int) -> torch.Tensor:
    """[N, K] int64 probe indices: uint32 wrap-around of h1 + i*h2, then
    mod num_bits.  Must stay in lockstep with common/bloom.py:
    probe_indices and csrc/bloom.cu's probe loop; without the mask the
    wrap-around is silently lost."""
    fp = fingerprints.to(torch.int64) & M32
    h1 = fp[:, 0:1]                                             # [N, 1]
    h2 = fp[:, 1:2]                                             # [N, 1]
    i = torch.arange(num_hashes, dtype=torch.int64,
                     device=fp.device)[None, :]                 # [1, K]
    return ((h1 + i * h2) & M32) % num_bits                     # [N, K]


def probe_body(words: torch.Tensor, fingerprints: torch.Tensor,
               num_bits: int, num_hashes: int) -> torch.Tensor:
    """bool[N], the plain probe: the ONE PyTorch statement of the test,
    shared by the pipeline's plain versions (ops/bloom_pipeline.py).
    ``words`` int32[W] (uint32 bit pattern) or int64."""
    idx = probe_indices(fingerprints, num_bits, num_hashes)
    word = words[idx >> 5].to(torch.int64)                      # gather
    # (w >> b) & 1 reads the right bit of an int32 word too: the mask
    # drops the sign fill.
    bit = (word >> (idx & 31)) & 1
    return torch.all(bit == 1, dim=1)


def bloom_may_contain(words: torch.Tensor, fingerprints: torch.Tensor, *,
                      num_bits: int, num_hashes: int) -> torch.Tensor:
    """bool[N]: False = definitely absent, True = possibly present."""
    from . import cuda_bloom

    return cuda_bloom.bloom_probe(words, fingerprints, num_bits=num_bits,
                                  num_hashes=num_hashes)


def bloom_scatter_add(words: torch.Tensor, fingerprints: torch.Tensor, *,
                      num_bits: int, num_hashes: int) -> torch.Tensor:
    """Set all probe bits for a key batch, on the device of ``words``:
    returns the new int32 word array (``words`` itself is not changed),
    as the JAX function returns a new array.  Used when the cache server
    rebuilds its filter from a key dump."""
    from . import cuda_bloom

    return cuda_bloom.bloom_scatter_or(words, fingerprints,
                                       num_bits=num_bits,
                                       num_hashes=num_hashes)


def scatter_add_plain(words: torch.Tensor, fingerprints: torch.Tensor,
                      num_bits: int, num_hashes: int) -> torch.Tensor:
    """The plain version of bloom_scatter_add: probe indices, then
    _scatter_or into a copy of the words."""
    idx = probe_indices(fingerprints, num_bits, num_hashes).reshape(-1)
    return _scatter_or(words, idx >> 5, idx & 31)


def _scatter_or(words: torch.Tensor, word_idx: torch.Tensor,
                bit: torch.Tensor) -> torch.Tensor:
    # PyTorch's scatter has no OR combiner either.  Distinct bits of one
    # word OR together as they add, so: drop duplicate (word, bit) pairs,
    # add the single-bit masks per word in int64 (index_add_ is exact for
    # integers), and OR the sum into the words.
    pairs = torch.unique(word_idx * 32 + bit)
    acc = torch.zeros(words.shape[0], dtype=torch.int64, device=words.device)
    acc.index_add_(0, pairs >> 5, torch.ones_like(pairs) << (pairs & 31))
    out = (words.to(torch.int64) & M32) | acc
    if words.dtype == torch.int32:
        # Back to the int32 bit pattern the words came in.
        out = torch.where(out > 0x7FFFFFFF, out - (1 << 32), out)
    return out.to(words.dtype)


def partitioned_shard_bounds(num_bits: int,
                             num_shards: int) -> Tuple[int, ...]:
    """Word-aligned split points for sharding a filter across devices."""
    words = (num_bits + 31) // 32
    per = (words + num_shards - 1) // num_shards
    return tuple(min(i * per, words) for i in range(num_shards + 1))
