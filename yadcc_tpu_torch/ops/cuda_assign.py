"""Wrapper of the sequential-scan CUDA kernel (csrc/assign_batch.cu).

The counterpart of yadcc_tpu/ops/pallas_assign.py:pallas_assign_batch
(kernel K2).  Routing follows the tensors: CPU tensors go to the plain
version, assignment.assign_batch; CUDA tensors launch the kernel, and
anything the kernel does not take raises.

`launches` counts kernel launches (one per cuda_assign_batch call on the
card), so a run can show that its main path went through the kernel;
`team_launches` counts the team mode's (one a card a
cuda_assign_batch_team call).
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional, Tuple

import torch

from ..models.cost import DEFAULT_COST_MODEL, UTIL_SCALE, DispatchCostModel
from . import assignment as asn
from . import team_exchange as tx
from .cuda_grouped import _check, _ids

SOURCE = "assign_batch.cu"
# Compiled into the kernel; a cost model that moved it must not silently
# disagree with it.
_KERNEL_UTIL_SCALE = 65536
# What the kernel counts into `work`, in this order.
WORK_FIELDS = ("descriptor_changes", "owner_rescans", "reductions")

launches = 0
team_launches = 0
_count_lock = threading.Lock()
_fn = None
_team_fn = None


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


def _team_kernel():
    global _team_fn
    if _team_fn is None:
        from ._build import load

        lib = load(SOURCE)
        fn = lib.yadcc_assign_batch_team
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p, p, p, p, p, p, i, p, p, p, p, i, i, ll, ll, ll, i,
                       p, p, p, i, p, i, p, ll, ll, p]
        fn.restype = ctypes.c_int
        lib.yadcc_assign_batch_scratch_bytes.argtypes = [i, i]
        lib.yadcc_assign_batch_scratch_bytes.restype = ll
        _team_fn = (fn, lib.yadcc_assign_batch_scratch_bytes, lib)
    return _team_fn


def cuda_assign_batch_team(
    tpool,
    batch: asn.TaskBatch,
    cost_model: DispatchCostModel = DEFAULT_COST_MODEL,
    exchange: Optional[tx.TeamExchange] = None,
) -> Tuple[torch.Tensor, tuple]:
    """K2's team mode over a parallel/mesh.py TeamPool: (picks int32[T]
    on slice 0's device, the parts' running vectors); the counterpart of
    yadcc_tpu/parallel/mesh.py:sharded_assign_fn.  A CPU team takes the
    plain version, assignment.assign_batch_team; on the card, one
    cooperative launch a card through ``exchange`` (the caller's, which
    it reuses launch after launch)."""
    from ..parallel.mesh import team_parts

    parts = team_parts(tpool.team)
    if all(dev.type == "cpu" for dev, _ in parts):
        # One part: the slices in linear order.
        picks, running = asn.assign_batch_team(
            tpool.parts[0], len(tpool.team), batch, cost_model)
        return picks, (running,)
    if any(dev.type != "cuda" for dev, _ in parts):
        raise ValueError(f"no team kernel for the team {tpool.team}")
    if exchange is None:
        raise ValueError("a team launch on the card needs its exchange")
    if UTIL_SCALE != _KERNEL_UTIL_SCALE:
        raise ValueError("cost model constants differ from the kernel's")
    exchange.check(tpool.team)
    fn, scratch_bytes, lib = _team_kernel()
    buf = exchange.buffer(lib)
    epoch = exchange.next_epoch()
    per, n = tpool.per, len(tpool.team)
    t = batch.env_id.shape[0]
    cm = cost_model
    picks_out, runs = [], []
    for (dev, ids), pool in zip(parts, tpool.parts):
        s = len(ids) * per
        e = pool.env_bitmap.shape[1] if pool.env_bitmap.dim() == 2 else -1
        _check("alive", pool.alive, torch.bool, (s,), dev)
        _check("capacity", pool.capacity, torch.int32, (s,), dev)
        _check("running", pool.running, torch.int32, (s,), dev)
        _check("dedicated", pool.dedicated, torch.bool, (s,), dev)
        _check("version", pool.version, torch.int32, (s,), dev)
        _check("env_bitmap", pool.env_bitmap, torch.int32, (s, e), dev)
        b = asn.TaskBatch(*(x.to(dev) for x in batch))
        for name in ("env_id", "min_version", "requestor"):
            _check(name, getattr(b, name), torch.int32, (t,), dev)
        _check("valid", b.valid, torch.bool, (t,), dev)
        picks = torch.empty(t, dtype=torch.int32, device=dev)
        running = torch.empty(s, dtype=torch.int32, device=dev)
        scratch = torch.empty(max(1, len(ids) * scratch_bytes(per, e)),
                              dtype=torch.uint8, device=dev)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = fn(pool.alive.data_ptr(), pool.capacity.data_ptr(),
                     pool.running.data_ptr(), pool.dedicated.data_ptr(),
                     pool.version.data_ptr(), pool.env_bitmap.data_ptr(), e,
                     b.env_id.data_ptr(), b.min_version.data_ptr(),
                     b.requestor.data_ptr(), b.valid.data_ptr(), per, t,
                     int(cm.dedicated_preference_utilization_q),
                     int(cm.preference_bonus_q), int(cm.infeasible_score_q),
                     int(bool(cm.avoid_self)), picks.data_ptr(),
                     running.data_ptr(), scratch.data_ptr(), len(ids),
                     _ids(ids), n, buf, epoch, tx.SPIN_LIMIT_CYCLES, stream)
        if err != 0:
            raise RuntimeError(f"assign_batch team launch failed: CUDA "
                               f"error {err}")
        global team_launches
        with _count_lock:
            team_launches += 1
        picks_out.append(picks)
        runs.append(running)
    return picks_out[0], tuple(runs)


def cuda_team_rounds(team, rounds: int,
                     exchange: tx.TeamExchange) -> torch.Tensor:
    """The exchange alone, on the card: ``rounds`` exchanges of one word
    by the team's slices, one cooperative launch a card of the team
    kernels' shape (csrc/assign_batch.cu:team_rounds_kernel).  Slice k
    posts its word and keeps slice k+1's, so it ends on (k + rounds) %
    n: int64[n] on slice 0's device.  Timed, it gives the exchange's
    round trip at the team's size, the part of a team kernel's bound
    that is not its own work.  Not on any serving path; not counted."""
    from ..parallel.mesh import as_team, team_parts

    team = as_team(team)
    parts = team_parts(team)
    if any(dev.type != "cuda" for dev, _ in parts):
        raise ValueError(f"the exchange runs on the card, not {team}")
    exchange.check(team)
    lib = _team_kernel()[2]
    fn = lib.yadcc_team_rounds
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [i, p, i, p, i, p, ll, ll, p]
    fn.restype = ctypes.c_int
    buf = exchange.buffer(lib)
    epoch = exchange.next_epoch()
    outs = []
    for dev, ids in parts:
        out = torch.empty(len(ids), dtype=torch.int64, device=dev)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = fn(int(rounds), out.data_ptr(), len(ids), _ids(ids),
                     len(team), buf, epoch, tx.SPIN_LIMIT_CYCLES, stream)
        if err != 0:
            raise RuntimeError(f"team rounds launch failed: CUDA error "
                               f"{err}")
        outs.append((ids, out))
    words = [None] * len(team)
    for ids, out in outs:
        for j, k in enumerate(ids):
            words[k] = out[j:j + 1].to(team[0])
    return torch.cat(words)
