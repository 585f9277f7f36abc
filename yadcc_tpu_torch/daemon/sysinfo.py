"""System load and memory sampling (a copy of the JAX package's
yadcc_tpu/daemon/sysinfo.py).

Parity with reference yadcc/daemon/sysinfo.{h,cc}: a /proc/stat idle-time
ring sampler (61 one-second samples) yielding an N-second processor
loadavg — the kernel's own 1/5/15min loadavg is far too sluggish for
second-granularity scheduling — plus a /proc/meminfo reader.
"""

from __future__ import annotations

import os
import threading
from collections import deque
from typing import Deque, Optional, Tuple

_MAX_SAMPLES = 61


def _read_proc_stat() -> Optional[Tuple[float, float]]:
    """(total_jiffies, idle_jiffies) from the aggregate cpu line."""
    try:
        with open("/proc/stat") as fp:
            line = fp.readline()
    except OSError:
        return None
    parts = line.split()
    if not parts or parts[0] != "cpu":
        return None
    vals = [float(x) for x in parts[1:]]
    total = sum(vals)
    idle = vals[3] + (vals[4] if len(vals) > 4 else 0.0)  # idle + iowait
    return total, idle


def read_memory_available() -> int:
    """Bytes, from /proc/meminfo MemAvailable."""
    try:
        with open("/proc/meminfo") as fp:
            for line in fp:
                if line.startswith("MemAvailable:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    return 0


def read_memory_total() -> int:
    try:
        with open("/proc/meminfo") as fp:
            for line in fp:
                if line.startswith("MemTotal:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    return 0


def read_cgroup_present() -> bool:
    """True when the daemon runs under a constraining cgroup: the host's
    nproc overstates what we may use, so the servant must refuse work
    (reference execution_engine.cc:75-106: v1 parsed, v2 refused; we
    refuse for both — correct and simpler)."""
    try:
        with open("/proc/self/cgroup") as fp:
            for line in fp:
                # Anything other than the root cgroup means containment.
                name = line.strip().rsplit(":", 1)[-1]
                if name not in ("/", "/init.scope", ""):
                    return True
    except OSError:
        return False
    return False


class LoadAverageSampler:
    """Ring of /proc/stat samples; loadavg(n) = busy cores over the last
    n seconds, in whole processors."""

    def __init__(self, nprocs: Optional[int] = None):
        self._nprocs = nprocs or os.cpu_count() or 1
        self._samples: Deque[Tuple[float, float]] = \
            deque(maxlen=_MAX_SAMPLES)  # guarded by: self._lock
        self._lock = threading.Lock()
        self.sample()

    def sample(self) -> None:
        """Call once per second (the daemon's 1s timer)."""
        s = _read_proc_stat()
        if s is not None:
            with self._lock:
                self._samples.append(s)

    def loadavg(self, seconds: int = 15) -> int:
        with self._lock:
            if len(self._samples) < 2:
                return 0
            n = min(seconds + 1, len(self._samples))
            new_total, new_idle = self._samples[-1]
            old_total, old_idle = self._samples[-n]
        dt = new_total - old_total
        if dt <= 0:
            return 0
        busy_frac = 1.0 - (new_idle - old_idle) / dt
        return max(0, round(busy_frac * self._nprocs))

    @property
    def nprocs(self) -> int:
        return self._nprocs
