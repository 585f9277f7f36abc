"""Wrapper of the sequential-scan CUDA kernel (csrc/assign_batch.cu).

The counterpart of yadcc_tpu/ops/pallas_assign.py:pallas_assign_batch
(kernel K2).  Routing follows the tensors: CPU tensors go to the plain
version, assignment.assign_batch; CUDA tensors launch the kernel, and
anything the kernel does not take raises.

`launches` counts kernel launches (one per cuda_assign_batch call on the
card), so a run can show that its main path went through the kernel.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional, Tuple

import torch

from ..models.cost import DEFAULT_COST_MODEL, UTIL_SCALE, DispatchCostModel
from . import assignment as asn
from .cuda_grouped import _check

SOURCE = "assign_batch.cu"
# Compiled into the kernel; a cost model that moved it must not silently
# disagree with it.
_KERNEL_UTIL_SCALE = 65536
# What the kernel counts into `work`, in this order.
WORK_FIELDS = ("descriptor_changes", "owner_rescans", "reductions")

launches = 0
_count_lock = threading.Lock()
_fn = None


def _kernel():
    global _fn
    if _fn is None:
        from ._build import load

        lib = load(SOURCE)
        fn = lib.yadcc_assign_batch
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p, p, p, p, p, p, i, p, p, p, p, i, i, ll, ll, ll, i,
                       p, p, p, p, p]
        fn.restype = ctypes.c_int
        lib.yadcc_assign_batch_scratch_bytes.argtypes = [i, i]
        lib.yadcc_assign_batch_scratch_bytes.restype = ll
        _fn = (fn, lib.yadcc_assign_batch_scratch_bytes)
    return _fn


def cuda_assign_batch(
    pool: asn.PoolArrays,
    batch: asn.TaskBatch,
    cost_model: DispatchCostModel = DEFAULT_COST_MODEL,
    work: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(picks int32[T], running int32[S]); the drop-in counterpart of
    assignment.assign_batch.  ``work`` (int64[3] on the card, optional)
    receives what the kernel did, in WORK_FIELDS order; the plain version
    has no such counts, so a CPU call refuses it."""
    dev = pool.alive.device
    if dev.type == "cpu":
        if work is not None:
            raise ValueError("work counts come from the kernel; the plain "
                             "version has none")
        return asn.assign_batch(pool, batch, cost_model)
    if dev.type != "cuda":
        raise ValueError(f"no assignment-scan kernel for device {dev}")
    if UTIL_SCALE != _KERNEL_UTIL_SCALE:
        raise ValueError("cost model constants differ from the kernel's")
    s = pool.alive.shape[0]
    t = batch.env_id.shape[0]
    if s == 0:
        raise ValueError("empty pool: the scan needs at least one slot")
    e = pool.env_bitmap.shape[1] if pool.env_bitmap.dim() == 2 else -1
    _check("alive", pool.alive, torch.bool, (s,), dev)
    _check("capacity", pool.capacity, torch.int32, (s,), dev)
    _check("running", pool.running, torch.int32, (s,), dev)
    _check("dedicated", pool.dedicated, torch.bool, (s,), dev)
    _check("version", pool.version, torch.int32, (s,), dev)
    _check("env_bitmap", pool.env_bitmap, torch.int32, (s, e), dev)
    for name in ("env_id", "min_version", "requestor"):
        _check(name, getattr(batch, name), torch.int32, (t,), dev)
    _check("valid", batch.valid, torch.bool, (t,), dev)
    if work is not None:
        _check("work", work, torch.int64, (len(WORK_FIELDS),), dev)

    fn, scratch_bytes = _kernel()
    picks = torch.empty(t, dtype=torch.int32, device=dev)
    running = torch.empty(s, dtype=torch.int32, device=dev)
    scratch = torch.empty(max(1, scratch_bytes(s, e)), dtype=torch.uint8,
                          device=dev)
    cm = cost_model
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(pool.alive.data_ptr(), pool.capacity.data_ptr(),
                 pool.running.data_ptr(), pool.dedicated.data_ptr(),
                 pool.version.data_ptr(), pool.env_bitmap.data_ptr(), e,
                 batch.env_id.data_ptr(), batch.min_version.data_ptr(),
                 batch.requestor.data_ptr(), batch.valid.data_ptr(), s, t,
                 int(cm.dedicated_preference_utilization_q),
                 int(cm.preference_bonus_q), int(cm.infeasible_score_q),
                 int(bool(cm.avoid_self)), picks.data_ptr(),
                 running.data_ptr(), scratch.data_ptr(),
                 None if work is None else work.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"assign_batch kernel launch failed: CUDA "
                           f"error {err}")
    global launches
    with _count_lock:
        launches += 1
    return picks, running
