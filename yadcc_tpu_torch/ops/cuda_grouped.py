"""Wrappers of the grouped-assignment CUDA kernel (csrc/grouped_assign.cu).

The counterparts of yadcc_tpu/ops/pallas_grouped.py's five entry points
(pallas_assign_grouped, _picks, _picks_packed, _picks_stream and
pallas_resident_grouped_step), and of the sharded control plane's fused
step (yadcc_tpu/parallel/mesh.py:resident_control_plane_step_fn), which
launches the same kernel over a grid of shards, one block a shard.
Routing follows the tensors: CPU tensors go to the plain version in
assignment_grouped.py; CUDA tensors launch the kernel, and anything the
kernel does not take raises.  The expansion, the descriptor unpacking,
the stream fold and the resident delta scatter stay plain torch ops on
the card around the launch.

`launches` counts kernel launches (one per launch on the card, whatever
its grid), so a run can show that its main path went through the kernel;
`team_launches` counts the team mode's launches (one a card a team call:
yadcc_tpu/parallel/mesh.py's sharded grouped search and its stream, over
a parallel/mesh.py team).
``cuda_assign_grouped`` can launch through another loaded copy of the
library (``lib``: e.g. one the compile farm built from the same source,
jit/frontend.py:build_library); the checks on the tensors are the same.
"""

from __future__ import annotations

import ctypes
import threading
from typing import Tuple

import torch

from ..models.cost import DEFAULT_COST_MODEL, UTIL_SCALE, DispatchCostModel
from . import assignment_grouped as asg
from . import team_exchange as tx
from .assignment import PoolArrays

SOURCE = "grouped_assign.cu"
# Constants compiled into the kernel; a cost model that moved them must
# not silently disagree with it.
_KERNEL_UTIL_SCALE = 65536
_KERNEL_SEARCH_ITERS = 22
GROUP_FIELDS = asg.GroupedBatch._fields

launches = 0
team_launches = 0
_count_lock = threading.Lock()
_fn = None
_team_fn = None


def _bind(lib: ctypes.CDLL):
    """(kernel entry, scratch sizer) of one loaded library, typed."""
    fn = lib.yadcc_grouped_assign
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [p, p, p, p, p, p, i, p, p, p, p, i, i, i, ll, ll, i,
                   p, p, p, p]
    fn.restype = ctypes.c_int
    lib.yadcc_grouped_assign_scratch_bytes.argtypes = [i]
    lib.yadcc_grouped_assign_scratch_bytes.restype = ll
    return fn, lib.yadcc_grouped_assign_scratch_bytes


def _kernel(lib=None):
    """The kernel of ``lib``, or of the library built from the checkout's
    source (loaded once)."""
    global _fn
    if lib is not None:
        return _bind(lib)
    if _fn is None:
        from ._build import load

        _fn = _bind(load(SOURCE))
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


def _launch(pool: PoolArrays, groups, n: int, cm: DispatchCostModel,
            lib=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """One K1 launch over ``n`` shards of S = len(pool) / n slots each:
    ``pool`` holds the shards one after another ([n*S]), ``groups`` the
    four descriptor arrays as int32[n, G].  Returns (counts int32[n, G, S],
    running int32[n*S])."""
    dev = pool.alive.device
    if dev.type != "cuda":
        raise ValueError(f"no grouped-assignment kernel for device {dev}")
    if UTIL_SCALE != _KERNEL_UTIL_SCALE or \
            asg._SEARCH_ITERS != _KERNEL_SEARCH_ITERS:
        raise ValueError("cost model constants differ from the kernel's")
    total = pool.alive.shape[0]
    if n < 1 or total % n:
        raise ValueError(f"{total} slots do not split into {n} shards")
    s = total // n
    g = groups[0].shape[-1]
    e = pool.env_bitmap.shape[1] if pool.env_bitmap.dim() == 2 else -1
    _check("alive", pool.alive, torch.bool, (total,), dev)
    _check("capacity", pool.capacity, torch.int32, (total,), dev)
    _check("running", pool.running, torch.int32, (total,), dev)
    _check("dedicated", pool.dedicated, torch.bool, (total,), dev)
    _check("version", pool.version, torch.int32, (total,), dev)
    _check("env_bitmap", pool.env_bitmap, torch.int32, (total, e), dev)
    for name, a in zip(GROUP_FIELDS, groups):
        _check(name, a, torch.int32, (n, g), dev)

    fn, scratch_bytes = _kernel(lib)
    counts = torch.empty((n, g, s), dtype=torch.int32, device=dev)
    running = torch.empty(total, dtype=torch.int32, device=dev)
    scratch = torch.empty(max(1, n * scratch_bytes(s)), dtype=torch.uint8,
                          device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(pool.alive.data_ptr(), pool.capacity.data_ptr(),
                 pool.running.data_ptr(), pool.dedicated.data_ptr(),
                 pool.version.data_ptr(), pool.env_bitmap.data_ptr(), e,
                 *(a.data_ptr() for a in groups), s, g, n,
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


def cuda_assign_grouped(
    pool: PoolArrays,
    batch: asg.GroupedBatch,
    cost_model: DispatchCostModel = DEFAULT_COST_MODEL,
    lib=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(counts int32[G, S], running int32[S]); the drop-in counterpart of
    assignment_grouped.assign_grouped.  ``lib``: the loaded library to
    launch through (default: the one built from csrc/)."""
    if pool.alive.device.type == "cpu":
        return asg.assign_grouped(pool, batch, cost_model)
    counts, running = _launch(
        pool, [getattr(batch, f).unsqueeze(0) for f in GROUP_FIELDS], 1,
        cost_model, lib)
    return counts[0], running


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
    pallas_grouped.pallas_resident_grouped_step: the fused step below with
    one shard (assignment_grouped.resident_grouped_step is the plain
    twin).  The JAX step donates the pool; here the pool's own tensors are
    updated in place on the current stream, and the returned pool holds
    them.  CPU tensors take the plain (functional) step."""
    if pool.alive.device.type == "cpu":
        return asg.resident_grouped_step(pool, delta, packed, adj,
                                         reset_mask, reset_val, t_max,
                                         cost_model)
    picks, pool = cuda_resident_control_plane_step(
        pool, asg.PoolDelta(*(a.unsqueeze(0) for a in delta)),
        packed.unsqueeze(0), adj, reset_mask, reset_val, t_max, cost_model)
    return picks[0], pool


def cuda_resident_control_plane_step(
    pool: PoolArrays,
    delta: asg.PoolDelta,
    packed: torch.Tensor,
    adj: torch.Tensor,
    reset_mask: torch.Tensor,
    reset_val: torch.Tensor,
    t_max: int,
    cost_model: DispatchCostModel = DEFAULT_COST_MODEL,
    *,
    return_picks: bool = True,
) -> Tuple[torch.Tensor, PoolArrays]:
    """The sharded control plane's fused step on the card: N shard pools
    in ONE launch of K1 over a grid of N blocks (the counterpart of
    yadcc_tpu/parallel/mesh.py:resident_control_plane_step_fn; its plain
    twin is assignment_grouped.resident_control_plane_step, which CPU
    tensors take).

    Layout: the pool concatenated over [N*per]; ``delta`` stacked [N, D]
    (env_rows [N, D, E]) with shard-LOCAL slot numbers, idx == per
    marking padding; ``packed`` int32[N, 4, G]; adj/reset_mask/reset_val
    [N*per].  The delta scatter sends shard k's slot i to k*per + i and
    every padding entry to one sink past the whole pool (padding must
    never land on the next shard's slot 0); the running fold and the
    per-shard expansion are torch ops around the launch.  The pool's own
    tensors are updated in place.
    Returns (picks int32[N, t_max], or counts int32[N, G, per] when
    ``return_picks`` is False, and the pool)."""
    if pool.alive.device.type == "cpu":
        return asg.resident_control_plane_step(
            pool, delta, packed, adj, reset_mask, reset_val, t_max,
            cost_model, return_picks=return_picks)
    dev = pool.alive.device
    total = pool.alive.shape[0]
    if packed.dim() != 3 or packed.shape[1] != 4:
        raise ValueError(f"packed: shape {tuple(packed.shape)}, expected "
                         f"[N, 4, G]")
    n, _, g = packed.shape
    if n < 1 or total % n:
        raise ValueError(f"{total} slots do not split into {n} shards")
    per = total // n
    d = delta.idx.shape[-1]
    e = pool.env_bitmap.shape[1] if pool.env_bitmap.dim() == 2 else -1
    _check("packed", packed, torch.int32, (n, 4, g), dev)
    for name in asg.PoolDelta._fields[:-1]:
        _check(f"delta.{name}", getattr(delta, name), torch.int32, (n, d),
               dev)
    _check("delta.env_rows", delta.env_rows, torch.int32, (n, d, e), dev)
    _check("adj", adj, torch.int32, (total,), dev)
    _check("reset_mask", reset_mask, torch.bool, (total,), dev)
    _check("reset_val", reset_val, torch.int32, (total,), dev)

    base = torch.arange(n, dtype=torch.int64, device=dev)[:, None] * per
    local = delta.idx.long()
    gidx = torch.where(local < per, local + base,
                       torch.full_like(local, total)).reshape(-1)
    new = pool._replace(
        alive=asg._scatter_rows(pool.alive, gidx,
                                delta.alive.reshape(-1) != 0),
        capacity=asg._scatter_rows(pool.capacity, gidx,
                                   delta.capacity.reshape(-1)),
        dedicated=asg._scatter_rows(pool.dedicated, gidx,
                                    delta.dedicated.reshape(-1) != 0),
        version=asg._scatter_rows(pool.version, gidx,
                                  delta.version.reshape(-1)),
        env_bitmap=asg._scatter_rows(pool.env_bitmap, gidx,
                                     delta.env_rows.reshape(n * d, e)),
    )
    running = asg.fold_stream_delta(pool.running, adj, reset_mask,
                                    reset_val)
    counts, running = _launch(new._replace(running=running),
                              list(packed.permute(1, 0, 2).contiguous()),
                              n, cost_model)
    out = (torch.stack([asg.expand_counts(counts[k], packed[k, 3], t_max)
                        for k in range(n)])
           if return_picks else counts)
    for name in PoolArrays._fields:
        getattr(pool, name).copy_(
            running if name == "running" else getattr(new, name))
    return out, pool


# ----------------------------------------------------------------------
# The team mode (one launch a card, one block a slice; csrc/
# grouped_assign.cu and csrc/team_exchange.cuh).
# ----------------------------------------------------------------------


def _ids(ids) -> ctypes.Array:
    """A team launch's slice ids, as the int array its entry reads."""
    return (ctypes.c_int * len(ids))(*ids)


def _team_kernel():
    global _team_fn
    if _team_fn is None:
        from ._build import load

        lib = load(SOURCE)
        fn = lib.yadcc_grouped_assign_team
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p, p, p, p, p, p, i, p, p, p, p, i, i, ll, ll, i,
                       p, p, p, p, i, p, i, p, ll, ll, p]
        fn.restype = ctypes.c_int
        lib.yadcc_grouped_assign_scratch_bytes.argtypes = [i]
        lib.yadcc_grouped_assign_scratch_bytes.restype = ll
        _team_fn = (fn, lib.yadcc_grouped_assign_scratch_bytes, lib)
    return _team_fn


def _cpu_team(parts) -> bool:
    if all(dev.type == "cpu" for dev, _ in parts):
        return True
    if any(dev.type != "cuda" for dev, _ in parts):
        raise ValueError(f"no team kernel for the devices "
                         f"{[str(d) for d, _ in parts]}")
    return False


def _launch_team(tpool, groups, exchange: tx.TeamExchange,
                 cm: DispatchCostModel):
    """One K1 team call: a launch on each card of the TeamPool, every
    one issued before any result is read.  ``groups`` are the four
    descriptor vectors [G] (any device; copied to each card).  Returns
    per part (counts int32[n_b, G, per], running int32[n_b*per], info
    int32[n_b, G, 2])."""
    from ..parallel.mesh import team_parts

    if exchange is None:
        raise ValueError("a team launch on the card needs its exchange")
    if UTIL_SCALE != _KERNEL_UTIL_SCALE or \
            asg._SEARCH_ITERS != _KERNEL_SEARCH_ITERS:
        raise ValueError("cost model constants differ from the kernel's")
    exchange.check(tpool.team)
    fn, scratch_bytes, lib = _team_kernel()
    buf = exchange.buffer(lib)
    epoch = exchange.next_epoch()
    per = tpool.per
    n = len(tpool.team)
    g = groups[0].shape[0]
    out = []
    for (dev, ids), pool in zip(team_parts(tpool.team), tpool.parts):
        nb = len(ids)
        s = nb * per
        e = pool.env_bitmap.shape[1] if pool.env_bitmap.dim() == 2 else -1
        _check("alive", pool.alive, torch.bool, (s,), dev)
        _check("capacity", pool.capacity, torch.int32, (s,), dev)
        _check("running", pool.running, torch.int32, (s,), dev)
        _check("dedicated", pool.dedicated, torch.bool, (s,), dev)
        _check("version", pool.version, torch.int32, (s,), dev)
        _check("env_bitmap", pool.env_bitmap, torch.int32, (s, e), dev)
        gs = [a.to(dev).contiguous() for a in groups]
        for name, a in zip(GROUP_FIELDS, gs):
            _check(name, a, torch.int32, (g,), dev)
        counts = torch.empty((nb, g, per), dtype=torch.int32, device=dev)
        running = torch.empty(s, dtype=torch.int32, device=dev)
        info = torch.empty((nb, g, 2), dtype=torch.int32, device=dev)
        scratch = torch.empty(max(1, nb * scratch_bytes(per)),
                              dtype=torch.uint8, device=dev)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = fn(pool.alive.data_ptr(), pool.capacity.data_ptr(),
                     pool.running.data_ptr(), pool.dedicated.data_ptr(),
                     pool.version.data_ptr(), pool.env_bitmap.data_ptr(), e,
                     *(a.data_ptr() for a in gs), per, g,
                     int(cm.dedicated_preference_utilization_q),
                     int(cm.preference_bonus_q), int(bool(cm.avoid_self)),
                     counts.data_ptr(), running.data_ptr(),
                     scratch.data_ptr(), info.data_ptr(), nb, _ids(ids), n,
                     buf, epoch, tx.SPIN_LIMIT_CYCLES, stream)
        if err != 0:
            raise RuntimeError(f"grouped_assign team launch failed: CUDA "
                               f"error {err}")
        global team_launches
        with _count_lock:
            team_launches += 1
        out.append((counts, running, info))
    return out


def cuda_assign_grouped_team(
    tpool,
    batch: asg.GroupedBatch,
    cost_model: DispatchCostModel = DEFAULT_COST_MODEL,
    exchange: "tx.TeamExchange | None" = None,
) -> Tuple[tuple, tuple]:
    """K1's team mode over a parallel/mesh.py TeamPool, the counterpart
    of yadcc_tpu/parallel/mesh.py:sharded_assign_grouped_fn: per part of
    the team, (counts int32[n_b, G, per]) and (running int32[n_b*per]).
    A CPU team takes the plain version, assignment_grouped.
    assign_grouped_team."""
    from ..parallel.mesh import team_parts

    parts = team_parts(tpool.team)
    n = len(tpool.team)
    if _cpu_team(parts):
        # One part: the slices in linear order.
        counts, running = asg.assign_grouped_team(tpool.parts[0], n, batch,
                                                  cost_model)
        return ((counts.view(counts.shape[0], n, -1).transpose(0, 1)
                 .contiguous(),), (running,))
    got = _launch_team(tpool, [getattr(batch, f) for f in GROUP_FIELDS],
                       exchange, cost_model)
    return (tuple(c for c, _, _ in got), tuple(r for _, r, _ in got))


def cuda_assign_grouped_picks_stream_team(
    tpool,
    packed: torch.Tensor,
    adj,
    reset_mask,
    reset_val,
    t_max: int,
    cost_model: DispatchCostModel = DEFAULT_COST_MODEL,
    exchange: "tx.TeamExchange | None" = None,
) -> Tuple[torch.Tensor, tuple]:
    """One pipelined stream step over the team, the counterpart of
    yadcc_tpu/parallel/mesh.py:sharded_assign_grouped_picks_stream_fn:
    each part folds its share of the host delta (``adj``,
    ``reset_mask``, ``reset_val``: one tensor a part, as parallel/
    mesh.py:shard_vector lays them), K1's team mode runs the search,
    each slice expands its own grants from the counts and the `info`
    the kernel wrote, and a min over the slices merges the picks on
    slice 0's device.  Returns (picks int32[t_max], the parts' running
    vectors, which stay on their cards for the next launch).  A CPU
    team takes the plain version, assignment_grouped.
    assign_grouped_picks_stream_team."""
    from ..parallel.mesh import team_parts

    parts = team_parts(tpool.team)
    per = tpool.per
    if _cpu_team(parts):
        picks, running = asg.assign_grouped_picks_stream_team(
            tpool.parts[0], len(tpool.team), packed, adj[0], reset_mask[0],
            reset_val[0], t_max, cost_model)
        return picks, (running,)
    folded = tpool._replace(parts=tuple(
        pool._replace(running=asg.fold_stream_delta(pool.running, a, m, v))
        for pool, a, m, v in zip(tpool.parts, adj, reset_mask, reset_val)))
    batch = asg.unpack_grouped(packed)
    got = _launch_team(folded, list(batch), exchange, cost_model)
    cands = []
    for (dev, ids), (counts, _, info) in zip(parts, got):
        sizes = batch.count.to(dev)
        for j, k in enumerate(ids):
            cands.append(asg.expand_counts_slice(
                counts[j], info[j, :, 0], info[j, :, 1], sizes, t_max,
                k * per))
    picks = asg.merge_team_picks(cands, tpool.team[0])
    return picks, tuple(r for _, r, _ in got)
