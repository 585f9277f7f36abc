"""Local run-quota acquisition (a copy of the JAX package's
yadcc_tpu/client/task_quota.py).

Parity with reference yadcc/client/common/task_quota.cc:34-94: every
local subprocess the wrapper runs (preprocess, local fallback compile)
first takes quota from the daemon so parallel `make -j500` doesn't melt
the machine; released explicitly or reclaimed when our PID dies.  With
no daemon there is no quota: the caller decides what to do."""

from __future__ import annotations

import contextlib
import json
import os
import time

from ..common.backoff import Backoff
from . import logging as log
from .daemon_call import call_daemon
from .env_options import warn_on_wait, warn_on_wait_longer_than_s


def acquire_task_quota(lightweight: bool, timeout_s: float = 3600.0,
                       _sleep=time.sleep) -> bool:
    start = time.monotonic()
    body = json.dumps({
        "milliseconds_to_wait": int(min(timeout_s, 10.0) * 1000),
        "lightweight_task": lightweight,
        "requestor_pid": os.getpid(),
    }).encode()
    warned = False
    # 503 is the daemon's paced backpressure (it already held our wait
    # window server-side); any other unexpected status is paced through
    # the shared backoff too, honoring the daemon's Retry-After, so an
    # odd answer never becomes a hot spin against the loopback socket.
    # Each lap rides call_daemon's keep-alive connection.
    backoff = Backoff(initial_s=0.05, max_s=5.0, sleep=_sleep)
    while True:
        resp = call_daemon("POST", "/local/acquire_quota", body)
        if resp.status == 200:
            return True
        if resp.status == -1:
            return False  # no daemon: caller decides what to do
        if time.monotonic() - start > timeout_s:
            return False
        if warn_on_wait() and not warned and \
                time.monotonic() - start > warn_on_wait_longer_than_s():
            log.warning("waiting for local task quota "
                        "(machine busy; this is backpressure, not a hang)")
            warned = True
        backoff.wait(resp.retry_after_s)


def release_task_quota() -> None:
    call_daemon("POST", "/local/release_quota",
                json.dumps({"requestor_pid": os.getpid()}).encode())


@contextlib.contextmanager
def task_quota(lightweight: bool):
    ok = acquire_task_quota(lightweight)
    try:
        yield ok
    finally:
        if ok:
            release_task_quota()
