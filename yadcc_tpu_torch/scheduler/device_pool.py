"""DeviceResidentPool: the servant pool lives on the device.

The stream policy re-uploads capacity and the epoch-cached statics every
launch.  This module inverts the data flow: the full PoolArrays stays on
the device across dispatch cycles and the host streams only what changed,
riding the dispatcher's dirty-slot tracking
(task_dispatcher._mark_slot_dirty_locked):

* statics + capacity deltas scatter in as small int32 batches
  (ops/assignment_grouped.PoolDelta — dirty-slot indices + replacement
  rows, idx == S sentinel padding);
* running corrections ride the adj/reset fold (fold_stream_delta);
* the scatter, fold, grouped assignment and expansion are one resident
  step (ops/cuda_grouped.cuda_resident_grouped_step: K1 on the card, the
  plain version on the CPU), in which the device updates its own
  `running` from its own picks;
* only the picked slot indices come back.

The host keeps applying the same changes to its authoritative arrays, and
a periodic equivalence ORACLE downloads the resident statics every
`oracle_interval` launches, compares them with the host snapshot
bit-for-bit, and re-syncs (with a counter) instead of serving from drifted
state.  `running` is outside the oracle: mid-stream it includes grants of
in-flight launches by design.

Failure modes:
* delta overflow (more dirty slots than S/8) or lost dirty tracking ->
  full statics re-upload, counted, correctness unaffected;
* oracle mismatch (a lost or misapplied scatter) -> log + resync +
  counter; the next launch serves from re-seeded statics;
* a device error raises to the dispatcher, which stops.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..models.cost import DEFAULT_COST_MODEL, DispatchCostModel
from ..ops import assignment as asn
from ..ops import assignment_grouped as asg
from ..ops import cuda_grouped as kgrouped
from ..utils.logging import get_logger

logger = get_logger("scheduler.device_pool")

# Dirty sets past this fraction of the pool re-upload the statics
# wholesale instead of scattering.
_DELTA_FULL_SYNC_FRAC = 8  # 1/8 of slots

_STATICS = ("alive", "capacity", "dedicated", "version", "env_bitmap")


class DeviceResidentPool:
    """Owns one dispatcher's device-resident PoolArrays and its delta
    protocol.  NOT thread-safe: exactly one stream owner (the pipelined
    dispatch thread) may touch an instance, the same single-writer
    discipline the stream_* policy API imposes.  The step runs where
    ``device`` says: the kernel on "cuda", the plain version on "cpu"."""

    def __init__(self, device="cuda",
                 cost_model: DispatchCostModel = DEFAULT_COST_MODEL,
                 oracle_interval: int = 64):
        self._device = torch.device(device)
        self._cm = cost_model
        self._oracle_interval = max(1, oracle_interval)
        self._pool: Optional[asn.PoolArrays] = None
        self._size = 0
        self._launches = 0
        self.stats: Dict[str, int] = {
            "seeds": 0,            # full uploads (begin/reseed)
            "delta_launches": 0,   # resident steps
            "delta_slots": 0,      # dirty slots streamed, total
            "full_syncs": 0,       # statics re-uploads (overflow/None)
            "oracle_checks": 0,
            "oracle_mismatches": 0,
        }

    def _up(self, a: np.ndarray, dtype) -> torch.Tensor:
        return torch.tensor(np.ascontiguousarray(a, dtype),
                            device=self._device)

    def _statics(self, snap) -> dict:
        return dict(
            alive=self._up(snap.alive, np.bool_),
            capacity=self._up(snap.capacity, np.int32),
            dedicated=self._up(snap.dedicated, np.bool_),
            version=self._up(snap.version, np.int32),
            env_bitmap=self._up(np.ascontiguousarray(
                snap.env_bitmap, np.uint32).view(np.int32), np.int32),
        )

    # -- residency ----------------------------------------------------------

    def seed(self, snap) -> None:
        """Absolute sync point: upload the full snapshot, replacing any
        resident state (startup, stream reseed)."""
        self._pool = asn.PoolArrays(
            running=self._up(snap.running, np.int32), **self._statics(snap))
        self._size = int(snap.alive.shape[0])
        self._launches = 0
        self.stats["seeds"] += 1

    @property
    def seeded(self) -> bool:
        return self._pool is not None

    def _resync_statics(self, snap) -> None:
        """Re-upload statics wholesale, keeping the chained running
        (which carries in-flight grants the snapshot cannot know)."""
        self._pool = self._pool._replace(**self._statics(snap))
        self.stats["full_syncs"] += 1

    # -- the resident step --------------------------------------------------

    def step(self, snap, dirty: Optional[Sequence[int]], descr,
             adj: np.ndarray, reset_slots: Dict[int, int],
             t_max: int) -> torch.Tensor:
        """One resident dispatch step; returns the device picks
        (int32[t_max], flat over `descr` run order).  The resident pool
        advances in place.

        dirty: slots whose statics/capacity changed since the last step
        (the dispatcher's dirty-slot export); None means the caller lost
        track — resolved as a counted full statics re-sync."""
        if self._pool is None:
            raise RuntimeError("DeviceResidentPool.step before seed()")
        s = self._size
        if dirty is None or len(dirty) * _DELTA_FULL_SYNC_FRAC > s:
            self._resync_statics(snap)
            dirty = ()
        delta = asg.make_pool_delta(
            np.fromiter(dirty, np.int64, len(dirty)),
            {f: getattr(snap, f) for f in _STATICS},
            pad_to=asg.delta_pad(len(dirty)), pool_size=s,
            device=self._device)
        self.stats["delta_slots"] += len(dirty)

        packed = asg.make_grouped_packed(
            descr, pad_to=asg.group_pad(len(descr)), device=self._device)
        rmask = np.zeros(s, bool)
        rval = np.zeros(s, np.int32)
        for slot, val in reset_slots.items():
            rmask[slot] = True
            rval[slot] = val
        picks, self._pool = kgrouped.cuda_resident_grouped_step(
            self._pool, delta, packed, self._up(adj, np.int32),
            self._up(rmask, np.bool_), self._up(rval, np.int32), t_max,
            self._cm)
        self.stats["delta_launches"] += 1
        self._launches += 1
        if self._launches % self._oracle_interval == 0:
            self.oracle_check(snap)
        return picks

    # -- equivalence oracle -------------------------------------------------

    def oracle_check(self, snap) -> bool:
        """Download the resident statics and compare them bit-for-bit with
        the host snapshot (the bitmap as uint32 words).  On mismatch: log,
        count, re-sync — the stream keeps serving from repaired state
        rather than drifting.  Returns True when parity held."""
        self.stats["oracle_checks"] += 1
        dev = {f: getattr(self._pool, f).cpu().numpy() for f in _STATICS}  # ytpu: allow(device-sync)  # oracle sync: the periodic statics check is the explicit sync point
        dev["env_bitmap"] = dev["env_bitmap"].view(np.uint32)
        ok = all(np.array_equal(dev[f], np.asarray(getattr(snap, f)))  # ytpu: allow(device-sync)  # host snapshot: the oracle's other side is a numpy array
                 for f in _STATICS)
        if not ok:
            self.stats["oracle_mismatches"] += 1
            logger.error(
                "device-resident statics diverged from the host snapshot "
                "after %d launches; re-syncing", self._launches)
            self._resync_statics(snap)
        return ok

    @property
    def running(self) -> Optional[torch.Tensor]:
        """The chained device running array (mid-stream it includes
        in-flight grants)."""
        return self._pool.running if self._pool is not None else None

    def inspect(self) -> dict:
        return dict(self.stats)
