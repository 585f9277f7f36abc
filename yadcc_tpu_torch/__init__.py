"""yadcc_tpu_torch — the scheduler's grant path on PyTorch and CUDA.

A port of the `yadcc_tpu` control plane to one NVIDIA H100: the host
modules (RPC front end, dispatcher, admission, bookkeeping) are kept as
copies of their own, and the grouped threshold-search assignment runs
as a hand-written CUDA kernel (csrc/grouped_assign.cu, bound through
ops/cuda_grouped.py).  Entry points run on the card unless the caller
asks for the CPU (device.resolve_device).
"""
