"""yadcc_tpu_torch — the scheduler's grant path on PyTorch and CUDA.

A port of the `yadcc_tpu` control plane to one NVIDIA H100: the host
modules (RPC front end, dispatcher, admission, bookkeeping) are kept as
copies of their own, and the grouped threshold-search assignment runs
as a hand-written CUDA kernel (csrc/grouped_assign.cu, bound through
ops/cuda_grouped.py).  The cache control plane's Bloom membership test
runs as hand-written kernels too (csrc/bloom.cu, bound through
ops/cuda_bloom.py).  The cache server (cache/entry.py) and the daemon's
two ends of its protocol (daemon/local/distributed_cache_reader.py,
whose batch verdicts run on those kernels, and
daemon/cloud/distributed_cache_writer.py) are ported too.  Entry points
run on the card unless the caller asks for the CPU
(device.resolve_device).
"""
