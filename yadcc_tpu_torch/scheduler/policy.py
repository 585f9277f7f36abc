"""The device policies behind the DispatchPolicy SPI (host_policy.py),
which produce the greedy oracle's picks for identical inputs.

Device policies run where they are told (`device`): on "cuda" every
grouped assignment goes through the hand-written kernel K1
(ops/cuda_grouped.py) and every sequential scan through K2
(ops/cuda_assign.py); on "cpu" through their plain versions.  A device
failure raises to the caller — no policy here degrades to another.

On the card each device policy launches, uploads and records its events
on a CUDA stream of its own, so the N policies of a sharded scheduler
(one a shard, each driven by its shard's dispatch thread) neither queue
behind each other's kernels nor wait for them before an upload from
pageable memory.
"""

from __future__ import annotations

import contextlib
import functools
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..models.cost import DEFAULT_COST_MODEL, DispatchCostModel
from ..ops import assignment as asn
from ..ops import assignment_grouped as asg
from ..ops import cuda_assign as kassign
from ..ops import cuda_grouped as kgrouped
from ..utils.logging import get_logger
# The host half (torch-free) lives in host_policy.py; every name of it
# stays importable from here.
from .host_policy import (POLICY_NAMES, AssignRequest,  # noqa: F401
                          DispatchPolicy, EnvRegistry, GreedyCpuPolicy,
                          PoolSnapshot, compress_runs, make_policy)

logger = get_logger("scheduler.policy")


@dataclass
class StreamTicket:
    """Handle for one in-flight pipelined launch: the picks (a host
    buffer whose copy from the card is under way, `ready` marking its
    end) plus the launch sequence number (the dispatcher uses it to
    order reset barriers against rejected-grant corrections)."""

    launch_id: int
    picks: torch.Tensor
    ready: Optional[torch.cuda.Event] = None  # None: already on the host
    # A team policy's launch epoch on its exchange (ops/team_exchange.py).
    team_epoch: Optional[int] = None


class _DevicePoolCache:
    """Device copies of the heartbeat-static pool arrays, valid while the
    snapshot epoch is unchanged.  The env bitmap is the bulk of the
    upload (S x E/32 words); at a 1s heartbeat cadence it is identical
    across the many dispatch cycles in between.  (epoch, statics) is one
    tuple so concurrent cycles never read a torn pair."""

    __slots__ = ("entry",)

    def __init__(self):
        self.entry = None


def _upload(a: np.ndarray, dtype, device: torch.device) -> torch.Tensor:
    """A copy on ``device`` (also on the CPU: snapshot buffers are
    republished in place once released, and cached statics must not
    alias them)."""
    return torch.tensor(np.asarray(a, dtype), device=device)  # ytpu: allow(device-sync)  # host snapshot array: np.asarray of a host buffer before its upload


def _upload_pool(snap: PoolSnapshot, running, device: torch.device,
                 cache: "_DevicePoolCache | None" = None) -> asn.PoolArrays:
    """Host snapshot -> PoolArrays on ``device``.  ``running`` is a numpy
    array or an already-resident tensor (the stream chain)."""
    entry = cache.entry if cache is not None else None
    if entry is not None and snap.epoch >= 0 and entry[0] == snap.epoch:
        alive, dedicated, version, env_bitmap = entry[1]
    else:
        alive = _upload(snap.alive, np.bool_, device)
        dedicated = _upload(snap.dedicated, np.bool_, device)
        version = _upload(snap.version, np.int32, device)
        env_bitmap = _upload(
            np.ascontiguousarray(snap.env_bitmap, np.uint32).view(np.int32),
            np.int32, device)
        if cache is not None and snap.epoch >= 0:
            cache.entry = (snap.epoch,
                           (alive, dedicated, version, env_bitmap))
    if not isinstance(running, torch.Tensor):
        running = _upload(running, np.int32, device)
    return asn.PoolArrays(
        alive=alive,
        capacity=_upload(snap.capacity, np.int32, device),
        running=running,
        dedicated=dedicated,
        version=version,
        env_bitmap=env_bitmap,
    )


def _own_stream(device: torch.device) -> "torch.cuda.Stream | None":
    """A CUDA stream for one policy's device work (None on the CPU)."""
    return torch.cuda.Stream(device) if device.type == "cuda" else None


def _on_own_stream(method):
    """Run a policy method with the policy's own stream current, so every
    launch, upload and event inside it goes there (a team policy: its
    stream on each of the team's cards)."""
    @functools.wraps(method)
    def run(self, *args, **kwargs):
        streams = getattr(self, "_team_streams", ())
        with contextlib.ExitStack() as ctx:
            for stream in streams + (self._cuda_stream,):
                if stream is not None:
                    ctx.enter_context(torch.cuda.stream(stream))
            return method(self, *args, **kwargs)
    return run


def _team_streams(team, device: torch.device) -> tuple:
    """A stream of the policy's own on each card of ``team`` but
    ``device`` (whose stream is the policy's ``_cuda_stream``), so no
    slice's launch waits behind other work on a card's current
    stream."""
    cards = {torch.device(d) for d in team}
    return tuple(torch.cuda.Stream(d) for d in sorted(cards, key=str)
                 if d.type == "cuda" and d != device)


def _zero_snapshot(pool_size: int, env_words: int) -> PoolSnapshot:
    """An empty pool of the serving width for warmups (epoch -1: never
    cached as a real pool)."""
    return PoolSnapshot(
        alive=np.zeros(pool_size, bool),
        capacity=np.zeros(pool_size, np.int32),
        running=np.zeros(pool_size, np.int32),
        dedicated=np.zeros(pool_size, bool),
        version=np.zeros(pool_size, np.int32),
        env_bitmap=np.zeros((pool_size, env_words), np.uint32))


class TorchBatchedPolicy(DispatchPolicy):
    """The exact sequential scan: every request is its own argmin over the
    pool, in request order, through kernel K2 (ops/cuda_assign.py) on
    "cuda" and its plain version on "cpu".  The counterpart of the JAX
    package's jax_batched (XLA scan) and jax_pallas (Pallas K2) policies.

    The cycle's requests go up as one batch, cut into launches of at most
    max_batch tasks (1-D slices, so each stays contiguous), with `running`
    carried from launch to launch on the device; every launch's picks come
    back in one collect at the end of the cycle.  Nothing is padded: the
    kernel has no per-shape compile to amortize, and padding rows would
    each cost an argmin."""

    name = "torch_batched"

    def __init__(self, device="cuda", max_batch: int = 256,
                 cost_model: DispatchCostModel = DEFAULT_COST_MODEL):
        self._device = torch.device(device)
        self._cuda_stream = _own_stream(self._device)
        self._cm = cost_model
        self._max_batch = max_batch
        self._pool_cache = _DevicePoolCache()

    def warmup(self, pool_size: int, env_words: int = 8) -> None:
        """Build the kernel and run it once at the serving width."""
        self.assign(_zero_snapshot(pool_size, env_words),
                    [AssignRequest(0, 0, -1)])

    @_on_own_stream
    def assign(self, snap, requests):
        n = len(requests)
        if n == 0:
            return []
        pool = _upload_pool(snap, snap.running, self._device,
                            self._pool_cache)
        batch = asn.make_batch(
            [r.env_id for r in requests],
            [r.min_version for r in requests],
            [r.requestor_slot for r in requests],
            pad_to=n, device=self._device)
        chunks = []
        for start in range(0, n, self._max_batch):
            cut = slice(start, start + self._max_batch)
            got, running = kassign.cuda_assign_batch(
                pool, asn.TaskBatch(*(x[cut] for x in batch)), self._cm)
            pool = pool._replace(running=running)
            chunks.append(got)
        # The cycle's one blocking device-to-host point.
        return torch.cat(chunks).tolist()  # ytpu: allow(device-sync)  # pick readback: the cycle's one .tolist()


class TorchGroupedPolicy(DispatchPolicy):
    """Grouped device policy: RUNS of consecutive identical descriptors
    are each resolved by one parallel threshold search
    (ops/assignment_grouped.py) instead of per-request sequential
    argmins.  Splitting on runs (not global dedup) preserves request
    order exactly, so outcomes equal the greedy oracle up to permutation
    *within* a run of identical requests — which request of an identical
    consecutive set receives which grant is unobservable."""

    name = "torch_grouped"

    # Chunks are also capped by task count so the picks-length pad ladder
    # {task_pad floor .. _TASK_CAP} is a small closed set.
    _TASK_CAP = 2048

    def __init__(self, device="cuda", max_groups: int = 64,
                 cost_model: DispatchCostModel = DEFAULT_COST_MODEL):
        self._device = torch.device(device)
        self._cuda_stream = _own_stream(self._device)
        self._cm = cost_model
        self._max_groups = max_groups
        self._pool_cache = _DevicePoolCache()
        self._warmed_pool_shapes: set = set()

    def _decide_expand(self) -> bool:
        """Expand grants on the device where the download is the cost
        (the card: O(T) picks instead of the O(G*S) counts), on the host
        where the transfer is free and numpy repeat beats a dense T x S
        compare (the CPU)."""
        return self._device.type != "cpu"

    def _prepare_grouped_pool(self, snap, running):
        return _upload_pool(snap, running, self._device, self._pool_cache)

    def _packed(self, descr, pad: int) -> torch.Tensor:
        return asg.make_grouped_packed(descr, pad_to=pad,
                                       device=self._device)

    # ------------------------------------------------------------------
    # Pipelined dispatch stream (device-resident running chain).
    #
    # The sync assign() path blocks on the device round-trip every
    # cycle.  The stream API instead keeps `running` ON DEVICE between
    # launches: the host folds its authoritative mutations (frees,
    # rejected grants, slot resets) into per-launch delta uploads, and
    # collects each launch's picks whenever their copy to the host lands.
    # Invariant: device running = host running + grants of in-flight
    # launches.
    # ------------------------------------------------------------------

    supports_stream = True

    @_on_own_stream
    def stream_begin(self, snap) -> None:
        """Absolute sync point: seed the device running chain from the
        host-authoritative snapshot.  Call with no launches in flight."""
        self._stream_running = _upload(snap.running, np.int32, self._device)
        self._stream_next_id = 0
        self._stream_epoch = snap.epoch

    # -- stale-stream guard ------------------------------------------------
    #
    # An unseeded or wrong-width chain auto-resyncs (counted — inspect()
    # surfaces it), and a snapshot whose epoch moved BACKWARD relative to
    # the chain is a caller bug (snapshots are produced under the
    # dispatcher lock and epochs only ever advance) — that raises.  Epoch
    # ADVANCE without a reseed is legitimate: joins/leaves/version bumps
    # ride the adj/reset delta protocol by design.

    def _stream_seeded(self, snap) -> bool:
        running = getattr(self, "_stream_running", None)
        return (running is not None
                and running.shape[0] == snap.running.shape[0])

    def _stream_guard(self, snap) -> None:
        if not self._stream_seeded(snap):
            self.stream_begin(snap)
            self._stream_resyncs = getattr(self, "_stream_resyncs", 0) + 1
            return
        last = getattr(self, "_stream_epoch", -1)
        if snap.epoch >= 0 and last >= 0 and snap.epoch < last:
            raise ValueError(
                f"pool epoch moved backward under a live stream "
                f"({last} -> {snap.epoch}): snapshots are produced "
                f"under the dispatcher lock and epochs are monotonic, "
                f"so this stream chain belongs to a different pool — "
                f"call stream_begin() with a fresh snapshot")
        self._stream_epoch = snap.epoch

    def stream_stats(self) -> dict:
        """Stream-health counters for inspect(): auto-resyncs taken by
        the stale-stream guard and the epoch the chain last saw."""
        return {
            "resyncs": getattr(self, "_stream_resyncs", 0),
            "epoch": getattr(self, "_stream_epoch", -1),
        }

    def _zero_pool(self, pool_size: int, env_words: int) -> asn.PoolArrays:
        zeros = torch.zeros(pool_size, dtype=torch.int32,
                            device=self._device)
        falses = torch.zeros(pool_size, dtype=torch.bool,
                             device=self._device)
        return asn.PoolArrays(
            alive=falses, capacity=zeros, running=zeros, dedicated=falses,
            version=zeros,
            env_bitmap=torch.zeros((pool_size, env_words),
                                   dtype=torch.int32, device=self._device))

    def _ladder(self):
        """Every (group pad, task pad) a launch can take — the chunk caps
        keep it a small closed set — in the order the warmups run them."""
        pad = asg.group_pad(0)
        while True:
            t_pad = asg.task_pad(0)
            while True:
                yield pad, t_pad
                if t_pad >= self._TASK_CAP:
                    break
                t_pad *= 2
            if pad >= self._max_groups:
                break
            pad *= 2

    @_on_own_stream
    def stream_warmup(self, pool_size: int, env_words: int = 8) -> None:
        """Run the stream step once per (group pad, task pad) of the
        ladder — the pipelined twin of warmup(): builds the kernel and
        sizes the allocator before the first live launch."""
        pool = self._zero_pool(pool_size, env_words)
        falses = pool.alive
        for pad, t_pad in self._ladder():
            self._run_stream_kernel(
                pool, self._packed([], pad), pool.running, falses,
                pool.running, t_pad)
        self._sync()

    def _sync(self) -> None:
        if self._device.type == "cuda":
            torch.cuda.synchronize(self._device)  # ytpu: allow(device-sync)  # warmup fence: runs before the first cycle, not in it

    def _run_stream_kernel(self, pool, packed, adj, rmask, rval,
                           t_max: int):
        return kgrouped.cuda_assign_grouped_picks_stream(
            pool, packed, adj, rmask, rval, t_max, self._cm)

    def _run_picks_kernel(self, pool, packed, t_max: int):
        return kgrouped.cuda_assign_grouped_picks_packed(
            pool, packed, t_max, self._cm)

    def _run_grouped_kernel(self, pool, batch):
        return kgrouped.cuda_assign_grouped(pool, batch, self._cm)

    @_on_own_stream
    def stream_launch(self, snap, descr, adj, reset_slots,
                      dirty=None) -> StreamTicket:
        """Launch one chunk without waiting for the result.

        snap: PoolSnapshot for statics + per-launch capacity (its
        `running` is IGNORED — the device chain is authoritative).
        descr: [(env_id, min_version, requestor_slot, count)] runs, in
        work order; the flat picks positions map 1:1 to that order.
        adj: int[S] signed host corrections since the last launch.
        reset_slots: {slot: absolute_running} overrides.
        dirty: slots whose statics changed since the last launch — only
        the device-RESIDENT subclass consumes it; this epoch-cached
        upload path re-reads the snapshot."""
        self._stream_guard(snap)
        pool = self._prepare_grouped_pool(snap, self._stream_running)
        packed = self._packed(descr, asg.group_pad(len(descr)))
        s = snap.alive.shape[0]
        rmask = np.zeros(s, bool)
        rval = np.zeros(s, np.int32)
        for slot, val in reset_slots.items():
            rmask[slot] = True
            rval[slot] = val
        t_pad = asg.task_pad(sum(d[3] for d in descr))
        dev = self._device
        picks, self._stream_running = self._run_stream_kernel(
            pool, packed, _upload(adj, np.int32, dev),
            _upload(rmask, np.bool_, dev), _upload(rval, np.int32, dev),
            t_pad)
        return self._ticket(picks)

    def _ticket(self, picks: torch.Tensor) -> StreamTicket:
        """The next ticket for ``picks``; on the card the copy to the
        host starts now, and the dispatcher collects it once `ready` has
        passed, without blocking the launch loop."""
        ready = None
        if picks.device.type == "cuda":
            host = torch.empty(picks.shape, dtype=picks.dtype,
                               pin_memory=True)
            host.copy_(picks, non_blocking=True)
            ready = torch.cuda.Event()
            ready.record()
            picks = host
        ticket = StreamTicket(self._stream_next_id, picks, ready)
        self._stream_next_id += 1
        return ticket

    def stream_ready(self, ticket: StreamTicket) -> bool:
        return ticket.ready is None or ticket.ready.query()

    def stream_collect(self, ticket: StreamTicket) -> np.ndarray:
        # The sanctioned device-to-host point of the stream: the apply
        # boundary, reached after stream_ready (or accepting the wait).
        if ticket.ready is not None:
            ticket.ready.synchronize()  # ytpu: allow(device-sync)  # apply boundary: the stream's one wait, after stream_ready
        return ticket.picks.numpy()  # ytpu: allow(device-sync)  # apply boundary

    def _chunk_runs(self, runs):
        """Split the run list into kernel-sized chunks: at most
        _max_groups runs AND at most _TASK_CAP member requests per chunk.
        A single run longer than the cap is split across chunks —
        correct because consecutive chunks carry `running` through,
        exactly like consecutive groups do."""
        chunks, cur, cur_tasks = [], [], 0
        for key, members in runs:
            start = 0
            while start < len(members):
                if cur and (len(cur) >= self._max_groups
                            or cur_tasks >= self._TASK_CAP):
                    chunks.append(cur)
                    cur, cur_tasks = [], 0
                take = members[start:start + self._TASK_CAP - cur_tasks]
                cur.append((key, take))
                cur_tasks += len(take)
                start += len(take)
        if cur:
            chunks.append(cur)
        return chunks

    @_on_own_stream
    def warmup(self, pool_size: int, env_words: int = 8) -> None:
        """Run every pad shape for this pool size once before serving:
        builds the kernel (the first call compiles it) and sizes the
        allocator, so no live grant cycle pays either.  All-zero-count
        warm batches grant nothing."""
        if (pool_size, env_words) in self._warmed_pool_shapes:
            return
        pool = self._zero_pool(pool_size, env_words)
        if self._decide_expand():
            for pad, t_pad in self._ladder():
                self._run_picks_kernel(pool, self._packed([], pad), t_pad)
        else:
            for pad in sorted({pad for pad, _ in self._ladder()}):
                self._run_grouped_kernel(
                    pool, asg.unpack_grouped(self._packed([], pad)))
        self._sync()
        self._warmed_pool_shapes.add((pool_size, env_words))

    @_on_own_stream
    def assign(self, snap, requests):
        # Runs of consecutive identical descriptors, in request order.
        runs: List[Tuple[tuple, List[int]]] = []
        for i, r in enumerate(requests):
            key = (r.env_id, r.min_version, r.requestor_slot)
            if runs and runs[-1][0] == key:
                runs[-1][1].append(i)
            else:
                runs.append((key, [i]))
        picks = [asn.NO_PICK] * len(requests)
        running = snap.running.copy()
        expand_on_device = self._decide_expand()
        for chunk in self._chunk_runs(runs):
            pad = asg.group_pad(len(chunk))
            descr = [(k[0], k[1], k[2], len(m)) for k, m in chunk]
            pool = self._prepare_grouped_pool(snap, running)
            packed = self._packed(descr, pad)
            if expand_on_device:
                # The device hands back per-request slot picks directly —
                # O(T) bytes down instead of the O(G*S) counts matrix.
                sizes = [len(m) for _, m in chunk]
                t_pad = asg.task_pad(sum(sizes))
                flat, new_running = self._run_picks_kernel(
                    pool, packed, t_pad)
                flat = flat.cpu().numpy()  # ytpu: allow(device-sync)  # pick readback: the cycle's one device-to-host copy
                running = new_running.cpu().numpy()  # ytpu: allow(device-sync)  # sync collect: the running vector rides the pick readback
                off = 0
                for (_, member_idx), size in zip(chunk, sizes):
                    for req_idx, s in zip(member_idx, flat[off:off + size]):
                        picks[req_idx] = int(s)
                    off += size
                continue
            counts, new_running = self._run_grouped_kernel(
                pool, asg.unpack_grouped(packed))
            counts = counts.cpu().numpy()  # ytpu: allow(device-sync)  # sync collect: counts readback of the cycle
            running = new_running.cpu().numpy()  # ytpu: allow(device-sync)  # sync collect
            # Expand (group, slot)->count into per-request picks with
            # one pass over the counts matrix for the whole chunk
            # (np.nonzero yields row-major order, i.e. grouped by
            # group) — not a fresh S-sized arange per group.
            grp, slot = np.nonzero(counts)
            expanded = np.repeat(slot, counts[grp, slot])
            offsets = np.concatenate(
                ([0], np.cumsum(counts.sum(axis=1))))
            for ci, (_, member_idx) in enumerate(chunk):
                for req_idx, s in zip(
                        member_idx, expanded[offsets[ci]:offsets[ci + 1]]):
                    picks[req_idx] = int(s)
        return picks


class TorchResidentGroupedPolicy(TorchGroupedPolicy):
    """The device-resident stream policy: the FULL PoolArrays lives on the
    device across cycles (scheduler/device_pool.py) and every stream
    launch is one resident step — delta scatter, running fold, K1,
    expansion — with the pool updated in place.  The host streams
    dirty-slot deltas (the dispatcher's `dirty=` export); only picks come
    back.  The counterpart of the JAX package's jax_resident_grouped and
    jax_resident_pallas_grouped.  Synchronous assign() stays the inherited
    upload path: residency is a property of the stream."""

    name = "torch_resident_grouped"
    # The dispatcher checks this to pass its dirty-slot export through
    # stream_launch(dirty=...).
    supports_resident = True

    def __init__(self, device="cuda", max_groups: int = 64,
                 cost_model: DispatchCostModel = DEFAULT_COST_MODEL,
                 oracle_interval: int = 64):
        super().__init__(device, max_groups, cost_model)
        from .device_pool import DeviceResidentPool

        self.resident_pool = DeviceResidentPool(
            device, cost_model, oracle_interval=oracle_interval)

    @_on_own_stream
    def stream_begin(self, snap) -> None:
        self.resident_pool.seed(snap)
        self._stream_next_id = 0
        self._stream_epoch = snap.epoch

    def _stream_seeded(self, snap) -> bool:
        rp = self.resident_pool
        return (rp.seeded
                and rp.running.shape[0] == snap.running.shape[0])

    @_on_own_stream
    def stream_warmup(self, pool_size: int, env_words: int = 8) -> None:
        """Run the resident step over the (group pad, task pad) ladder at
        the floor delta pad (bigger dirty sets escalate to a full re-sync,
        which adds no step shape).  The zero pool seeded here is replaced
        by the real stream_begin."""
        snap = _zero_snapshot(pool_size, env_words)
        self.resident_pool.seed(snap)
        adj = np.zeros(pool_size, np.int32)
        for pad, t_pad in self._ladder():
            self.resident_pool.step(snap, (), [(0, 0, -1, 0)] * pad, adj,
                                    {}, t_pad)
        self._sync()

    @_on_own_stream
    def stream_launch(self, snap, descr, adj, reset_slots,
                      dirty=None) -> StreamTicket:
        self._stream_guard(snap)
        t_pad = asg.task_pad(sum(d[3] for d in descr))
        return self._ticket(self.resident_pool.step(
            snap, dirty, descr, adj, reset_slots, t_pad))

    def stream_stats(self) -> dict:
        stats = super().stream_stats()
        stats.update(self.resident_pool.inspect())
        return stats


def _team_of(team, device) -> tuple:
    """The policy's team: the one given, or every card (the JAX
    policies' make_mesh()), or one CPU slice for device="cpu"."""
    from ..parallel import mesh

    return (mesh.make_team(device=device) if team is None
            else mesh.as_team(team))


def _upload_team_pool(snap: PoolSnapshot, running, team,
                      cache: _DevicePoolCache):
    """Host snapshot -> a TeamPool over ``team`` (parallel/mesh.py), the
    statics cached for the snapshot's epoch, each part on its card (the
    JAX sharded policy's epoch cache: no re-upload of the bitmap to every
    card between heartbeats).  ``running`` is a numpy array or the
    stream's resident parts."""
    from ..parallel import mesh

    per = mesh.slice_size(snap.alive.shape[0], team)
    home = team[0]

    def shard(a, dtype):
        return mesh.shard_vector(_upload(a, dtype, home), team, per)

    entry = cache.entry
    if entry is not None and snap.epoch >= 0 and entry[0] == snap.epoch:
        statics = entry[1]
    else:
        statics = (
            shard(snap.alive, np.bool_), shard(snap.dedicated, np.bool_),
            shard(snap.version, np.int32),
            shard(np.ascontiguousarray(snap.env_bitmap,
                                       np.uint32).view(np.int32),
                  np.int32))
        if snap.epoch >= 0:
            cache.entry = (snap.epoch, statics)
    alive, dedicated, version, env_bitmap = statics
    capacity = shard(snap.capacity, np.int32)
    if not isinstance(running, tuple):
        running = shard(running, np.int32)
    return mesh.TeamPool(team, per, tuple(
        asn.PoolArrays(alive=a, capacity=c, running=r, dedicated=d,
                       version=v, env_bitmap=e)
        for a, c, r, d, v, e in zip(alive, capacity, running, dedicated,
                                    version, env_bitmap)))


class TorchShardedPolicy(TorchBatchedPolicy):
    """The sequential scan with the servant axis split over a team
    (parallel/mesh.py): K2's team mode, each task's least key agreed
    through the team's exchange (the counterpart of the JAX package's
    jax_sharded, JaxShardedPolicy).  ``team`` defaults to every card
    (on device="cpu", one CPU slice).  The outcomes are the scan's,
    slot for slot."""

    name = "torch_sharded"

    def __init__(self, max_servants: "int | None" = None, team=None,
                 max_batch: int = 256,
                 cost_model: DispatchCostModel = DEFAULT_COST_MODEL,
                 device="cuda"):
        from ..ops.team_exchange import TeamExchange

        self._team = _team_of(team, device)
        super().__init__(self._team[0], max_batch, cost_model)
        self._team_streams = _team_streams(self._team, self._device)
        self._exchange = TeamExchange()
        n = len(self._team)
        if max_servants is not None and max_servants % n:
            raise ValueError(
                f"max_servants ({max_servants}) must divide evenly over "
                f"{n} devices")

    @_on_own_stream
    def assign(self, snap, requests):
        from ..parallel import mesh

        n = len(requests)
        if n == 0:
            return []
        tpool = _upload_team_pool(snap, snap.running, self._team,
                                  self._pool_cache)
        batch = asn.make_batch(
            [r.env_id for r in requests],
            [r.min_version for r in requests],
            [r.requestor_slot for r in requests],
            pad_to=n, device=self._device)
        chunks = []
        for start in range(0, n, self._max_batch):
            cut = slice(start, start + self._max_batch)
            got, running = mesh.sharded_assign(
                tpool, asn.TaskBatch(*(x[cut] for x in batch)), self._cm,
                self._exchange)
            tpool = tpool._replace(parts=tuple(
                p._replace(running=r) for p, r in zip(tpool.parts,
                                                      running)))
            chunks.append(got)
        picks = torch.cat(chunks).tolist()  # ytpu: allow(device-sync)  # pick readback: the cycle's one .tolist()
        self._exchange.check(self._team)
        return picks


class TorchShardedGroupedPolicy(TorchGroupedPolicy):
    """The grouped threshold search with the servant axis split over a
    team (parallel/mesh.py): K1's team mode, each bisect step's total
    and each group's tie split agreed through the team's exchange (the
    counterpart of jax_sharded_grouped, JaxShardedGroupedPolicy).  The
    sync path expands the counts on the host, as the JAX policy does;
    the stream path runs the team's search with the sharded expansion,
    `running` resident on each slice's card.  ``team`` defaults to every
    card (on device="cpu", one CPU slice)."""

    name = "torch_sharded_grouped"

    def __init__(self, team=None, max_groups: int = 64,
                 cost_model: DispatchCostModel = DEFAULT_COST_MODEL,
                 device="cuda"):
        from ..ops.team_exchange import TeamExchange

        self._team = _team_of(team, device)
        super().__init__(self._team[0], max_groups, cost_model)
        self._team_streams = _team_streams(self._team, self._device)
        self._ndev = len(self._team)
        self._exchange = TeamExchange()

    def _decide_expand(self) -> bool:
        # The team's counts live over its cards: the sync path expands
        # on the host (the stream path has its own sharded expansion).
        return False

    def _prepare_grouped_pool(self, snap, running):
        return _upload_team_pool(snap, running, self._team,
                                 self._pool_cache)

    def _zero_pool(self, pool_size: int, env_words: int):
        from ..parallel import mesh

        return mesh.shard_pool(super()._zero_pool(pool_size, env_words),
                               self._team)

    def _run_grouped_kernel(self, tpool, batch):
        from ..parallel import mesh

        counts, running = mesh.sharded_assign_grouped(
            tpool, batch, self._cm, self._exchange)
        # Read back here, and check the exchange before anyone expands
        # the counts: a faulted launch leaves them unwritten.
        counts = mesh.unshard_counts(counts, tpool)
        running = mesh.unshard_vector(running, tpool.team, tpool.per)
        counts = counts.cpu()  # ytpu: allow(device-sync)  # sync collect: counts readback of the cycle, moved before the expansion
        running = running.cpu()  # ytpu: allow(device-sync)  # sync collect
        self._exchange.check(self._team)
        return counts, running

    def _run_stream_kernel(self, tpool, packed, adj, rmask, rval,
                           t_max: int):
        from ..parallel import mesh

        def shard(v):
            return mesh.shard_vector(v, tpool.team, tpool.per)

        return mesh.sharded_assign_grouped_picks_stream(
            tpool, packed, shard(adj), shard(rmask), shard(rval), t_max,
            self._cm, self._exchange)

    @_on_own_stream
    def assign(self, snap, requests):
        picks = super().assign(snap, requests)
        self._exchange.check(self._team)
        return picks

    @_on_own_stream
    def stream_begin(self, snap) -> None:
        from ..parallel import mesh

        self._stream_running = mesh.shard_vector(
            _upload(snap.running, np.int32, self._device), self._team)
        self._stream_next_id = 0
        self._stream_epoch = snap.epoch

    def _ticket(self, picks: torch.Tensor) -> StreamTicket:
        ticket = super()._ticket(picks)
        ticket.team_epoch = self._exchange.epoch
        return ticket

    def _stream_seeded(self, snap) -> bool:
        running = getattr(self, "_stream_running", None)
        return (running is not None
                and sum(r.shape[0] for r in running)
                == snap.running.shape[0])

    @_on_own_stream
    def stream_warmup(self, pool_size: int, env_words: int = 8) -> None:
        tpool = self._zero_pool(pool_size, env_words)
        zeros = torch.zeros(pool_size, dtype=torch.int32,
                            device=self._device)
        falses = torch.zeros(pool_size, dtype=torch.bool,
                             device=self._device)
        for pad, t_pad in self._ladder():
            self._run_stream_kernel(tpool, self._packed([], pad), zeros,
                                    falses, zeros, t_pad)
        self._sync()
        self._exchange.check(self._team)

    def stream_collect(self, ticket: StreamTicket) -> np.ndarray:
        picks = super().stream_collect(ticket)
        try:
            self._exchange.check(self._team, ticket.team_epoch)
        except RuntimeError:
            # The chain's running vectors are void too: the next launch
            # reseeds from the snapshot (a resync).
            self._stream_running = None
            raise
        return picks

    def _sync(self) -> None:
        from ..parallel import mesh

        for dev, _ in mesh.team_parts(self._team):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)  # ytpu: allow(device-sync)  # warmup fence: runs before the first cycle, not in it


class AutoPolicy(DispatchPolicy):
    """Backlog-adaptive hybrid: small micro-batches take the host greedy
    path (no device round-trip — a lone request resolves in
    microseconds), deeper backlogs take the grouped device policy.

    The crossover is MEASURED at warmup, not assumed: warmup() times
    both routes at two batch sizes on a synthetic pool of the serving
    size and sets the crossover where the measured affine cost curves
    intersect.  Before calibration an analytic fallback applies:
    n* = 800/S + 1.2.  Outcome equivalence between the two routes is
    enforced by the tests, so switching is purely a latency/throughput
    trade — a routing decision, not a fallback: a device failure on the
    device route raises."""

    name = "auto"

    def __init__(self, device="cuda",
                 cost_model: DispatchCostModel = DEFAULT_COST_MODEL,
                 device_threshold: "int | None" = None):
        self._greedy = GreedyCpuPolicy(cost_model)
        self._grouped = TorchGroupedPolicy(device, cost_model=cost_model)
        self._threshold = device_threshold  # None = pool-size adaptive
        self._measured_threshold: "float | None" = None

    def warmup(self, pool_size: int, env_words: int = 8) -> None:
        self._grouped.warmup(pool_size, env_words)
        self._calibrate(pool_size, env_words)

    def _calibrate(self, pool_size: int, env_words: int) -> None:
        """Time both routes on a synthetic pool of the serving size and
        place the crossover where they intersect.  The device call is
        timed end to end (upload + kernel + download).  Both routes are
        measured at TWO batch sizes and modeled affine (cost = a + b*n):
        the greedy host path is flat O(S) mask work plus a small
        per-request heap term for runs of identical descriptors.

        That per-request term is about a microsecond, so the two probes
        lie far apart (8 and 1024 requests, where the JAX package used 8
        and 128) and each is the best of five runs: with one run 120
        requests apart, host timing noise decided the slope's sign and
        flipped the crossover between ~440 requests and "never"."""
        import time as _time

        def mksnap():
            s = pool_size
            return PoolSnapshot(
                alive=np.ones(s, bool),
                capacity=np.full(s, 4, np.int32),
                running=np.zeros(s, np.int32),
                dedicated=np.zeros(s, bool),
                version=np.ones(s, np.int32),
                env_bitmap=np.full((s, env_words), 0xFFFFFFFF, np.uint32),
            )

        n_lo, n_hi = 8, 1024

        def timed(policy, n):
            reqs = [AssignRequest(1, 1, -1)] * n
            policy.assign(mksnap(), reqs)   # warm this shape
            best = float("inf")
            for _ in range(5):
                t0 = _time.perf_counter()
                policy.assign(mksnap(), reqs)
                best = min(best, _time.perf_counter() - t0)
            return best

        g_lo, g_hi = timed(self._greedy, n_lo), timed(self._greedy, n_hi)
        d_lo, d_hi = timed(self._grouped, n_lo), timed(self._grouped, n_hi)
        b_g = (g_hi - g_lo) / (n_hi - n_lo)
        b_d = (d_hi - d_lo) / (n_hi - n_lo)
        if b_g <= b_d:
            # Greedy's slope is no worse than the device's: whoever is
            # cheaper at the large probe stays cheaper forever.
            threshold = float("inf") if g_hi <= d_hi else 1.0
        else:
            # a_g + b_g*n = a_d + b_d*n at the crossover.
            a_g, a_d = g_lo - b_g * n_lo, d_lo - b_d * n_lo
            threshold = max(1.0, (a_d - a_g) / (b_g - b_d))
        self._measured_threshold = threshold
        logger.info(
            "auto crossover calibrated: greedy %.3f/%.3fms, device "
            "%.3f/%.3fms at n=%d/%d, threshold n*=%.1f (pool %d)",
            g_lo * 1e3, g_hi * 1e3, d_lo * 1e3, d_hi * 1e3,
            n_lo, n_hi, threshold, pool_size)

    # In pipelined mode every launch goes through the grouped device
    # policy — the greedy host shortcut only exists to dodge the device
    # round-trip, and the stream never blocks on one.
    supports_stream = True

    def stream_begin(self, snap):
        return self._grouped.stream_begin(snap)

    def stream_warmup(self, pool_size: int, env_words: int = 8) -> None:
        self._grouped.stream_warmup(pool_size, env_words)

    def stream_launch(self, snap, descr, adj, reset_slots, dirty=None):
        return self._grouped.stream_launch(snap, descr, adj, reset_slots,
                                           dirty=dirty)

    def stream_ready(self, ticket) -> bool:
        return self._grouped.stream_ready(ticket)

    def stream_collect(self, ticket):
        return self._grouped.stream_collect(ticket)

    def stream_stats(self) -> dict:
        return self._grouped.stream_stats()

    def _use_greedy(self, snap, n: int) -> bool:
        if self._threshold is not None:
            return n < self._threshold
        if self._measured_threshold is not None:
            return n < self._measured_threshold
        s = max(1, int(snap.alive.shape[0]))
        return n < 800 / s + 1.2

    def assign(self, snap, requests):
        if self._use_greedy(snap, len(requests)):
            return self._greedy.assign(snap, requests)
        return self._grouped.assign(snap, requests)
