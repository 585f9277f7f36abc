"""Wrappers of the grouped-assignment CUDA kernel (csrc/grouped_assign.cu).

The counterparts of yadcc_tpu/ops/pallas_grouped.py's five entry points
(pallas_assign_grouped, _picks, _picks_packed, _picks_stream and
pallas_resident_grouped_step).  Routing follows the tensors: CPU tensors
go to the plain version in assignment_grouped.py; CUDA tensors launch the
kernel, and anything the kernel does not take raises.  The expansion, the
descriptor unpacking, the stream fold and the resident delta scatter stay
plain torch ops on the card around the launch.

`launches` counts kernel launches (one per cuda_assign_grouped call on
the card), so a run can show that its main path went through the kernel.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Tuple

import torch

from ..models.cost import DEFAULT_COST_MODEL, UTIL_SCALE, DispatchCostModel
from . import assignment_grouped as asg
from .assignment import PoolArrays

SOURCE = "grouped_assign.cu"
# Constants compiled into the kernel; a cost model that moved them must
# not silently disagree with it.
_KERNEL_UTIL_SCALE = 65536
_KERNEL_SEARCH_ITERS = 22
GROUP_FIELDS = asg.GroupedBatch._fields

launches = 0
_count_lock = threading.Lock()
_fn = None


def _kernel():
    global _fn
    if _fn is None:
        from ._build import load

        lib = load(SOURCE)
        fn = lib.yadcc_grouped_assign
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p, p, p, p, p, p, i, p, p, p, p, i, i, ll, ll, i,
                       p, p, p, p]
        fn.restype = ctypes.c_int
        lib.yadcc_grouped_assign_scratch_bytes.argtypes = [i]
        lib.yadcc_grouped_assign_scratch_bytes.restype = ll
        _fn = (fn, lib.yadcc_grouped_assign_scratch_bytes)
    return _fn


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape,
           device: torch.device) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, kernel takes {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, pool on {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def cuda_assign_grouped(
    pool: PoolArrays,
    batch: asg.GroupedBatch,
    cost_model: DispatchCostModel = DEFAULT_COST_MODEL,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(counts int32[G, S], running int32[S]); the drop-in counterpart of
    assignment_grouped.assign_grouped."""
    dev = pool.alive.device
    if dev.type == "cpu":
        return asg.assign_grouped(pool, batch, cost_model)
    if dev.type != "cuda":
        raise ValueError(f"no grouped-assignment kernel for device {dev}")
    if UTIL_SCALE != _KERNEL_UTIL_SCALE or \
            asg._SEARCH_ITERS != _KERNEL_SEARCH_ITERS:
        raise ValueError("cost model constants differ from the kernel's")
    s = pool.alive.shape[0]
    g = batch.env_id.shape[0]
    e = pool.env_bitmap.shape[1] if pool.env_bitmap.dim() == 2 else -1
    _check("alive", pool.alive, torch.bool, (s,), dev)
    _check("capacity", pool.capacity, torch.int32, (s,), dev)
    _check("running", pool.running, torch.int32, (s,), dev)
    _check("dedicated", pool.dedicated, torch.bool, (s,), dev)
    _check("version", pool.version, torch.int32, (s,), dev)
    _check("env_bitmap", pool.env_bitmap, torch.int32, (s, e), dev)
    for name in GROUP_FIELDS:
        _check(name, getattr(batch, name), torch.int32, (g,), dev)

    fn, scratch_bytes = _kernel()
    counts = torch.empty((g, s), dtype=torch.int32, device=dev)
    running = torch.empty(s, dtype=torch.int32, device=dev)
    scratch = torch.empty(max(1, scratch_bytes(s)), dtype=torch.uint8,
                          device=dev)
    cm = cost_model
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(pool.alive.data_ptr(), pool.capacity.data_ptr(),
                 pool.running.data_ptr(), pool.dedicated.data_ptr(),
                 pool.version.data_ptr(), pool.env_bitmap.data_ptr(), e,
                 batch.env_id.data_ptr(), batch.min_version.data_ptr(),
                 batch.requestor.data_ptr(), batch.count.data_ptr(), s, g,
                 int(cm.dedicated_preference_utilization_q),
                 int(cm.preference_bonus_q), int(bool(cm.avoid_self)),
                 counts.data_ptr(), running.data_ptr(), scratch.data_ptr(),
                 stream)
    if err != 0:
        raise RuntimeError(f"grouped_assign kernel launch failed: CUDA "
                           f"error {err}")
    global launches
    with _count_lock:
        launches += 1
    return counts, running


def cuda_assign_grouped_picks(
    pool: PoolArrays,
    batch: asg.GroupedBatch,
    t_max: int,
    cost_model: DispatchCostModel = DEFAULT_COST_MODEL,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel + expansion: int32[t_max] picks and running (the download a
    dispatcher needs is O(T), not the O(G*S) counts)."""
    counts, running = cuda_assign_grouped(pool, batch, cost_model)
    return asg.expand_counts(counts, batch.count, t_max), running


def cuda_assign_grouped_picks_packed(
    pool: PoolArrays,
    packed: torch.Tensor,
    t_max: int,
    cost_model: DispatchCostModel = DEFAULT_COST_MODEL,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Packed-descriptor variant: one [4, G] upload per launch."""
    return cuda_assign_grouped_picks(pool, asg.unpack_grouped(packed),
                                     t_max, cost_model)


def cuda_assign_grouped_picks_stream(
    pool: PoolArrays,
    packed: torch.Tensor,
    adj: torch.Tensor,
    reset_mask: torch.Tensor,
    reset_val: torch.Tensor,
    t_max: int,
    cost_model: DispatchCostModel = DEFAULT_COST_MODEL,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pipelined stream step through the kernel: the host delta fold,
    then the packed picks step (assignment_grouped.
    assign_grouped_picks_stream is the plain twin)."""
    running = asg.fold_stream_delta(pool.running, adj, reset_mask,
                                    reset_val)
    return cuda_assign_grouped_picks_packed(
        pool._replace(running=running), packed, t_max, cost_model)


def cuda_resident_grouped_step(
    pool: PoolArrays,
    delta: asg.PoolDelta,
    packed: torch.Tensor,
    adj: torch.Tensor,
    reset_mask: torch.Tensor,
    reset_val: torch.Tensor,
    t_max: int,
    cost_model: DispatchCostModel = DEFAULT_COST_MODEL,
) -> Tuple[torch.Tensor, PoolArrays]:
    """The device-resident step through the kernel, the counterpart of
    pallas_grouped.pallas_resident_grouped_step: the delta scatter, the
    running fold and the expansion are torch ops on the card around one
    K1 launch (assignment_grouped.resident_grouped_step is the plain
    twin).  The JAX step donates the pool; here the pool's own tensors are
    updated in place on the current stream, and the returned pool holds
    them.  CPU tensors take the plain (functional) step."""
    if pool.alive.device.type == "cpu":
        return asg.resident_grouped_step(pool, delta, packed, adj,
                                         reset_mask, reset_val, t_max,
                                         cost_model)
    new = asg.apply_pool_delta(pool, delta)
    running = asg.fold_stream_delta(pool.running, adj, reset_mask,
                                    reset_val)
    batch = asg.unpack_grouped(packed)
    counts, running = cuda_assign_grouped(new._replace(running=running),
                                          batch, cost_model)
    picks = asg.expand_counts(counts, batch.count, t_max)
    for name in PoolArrays._fields:
        getattr(pool, name).copy_(
            running if name == "running" else getattr(new, name))
    return picks, pool
