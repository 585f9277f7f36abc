"""The port's latency GC guard (yadcc_tpu_torch/utils/gctune.py).

The guard owns process-wide collector state, so every check runs in a
child process: the collector of the pytest process stays as it is."""

from __future__ import annotations

import json
import os
import pathlib
import signal
import socket
import subprocess
import sys
import textwrap
import time
import urllib.request

REPO = pathlib.Path(__file__).resolve().parents[1]
ENV = dict(os.environ, PYTHONPATH=str(REPO))


def test_guard_lifecycle_in_a_subprocess():
    script = textwrap.dedent("""
        import gc
        from yadcc_tpu_torch.utils.clock import VirtualClock
        from yadcc_tpu_torch.utils.gctune import LatencyGcGuard

        clk = VirtualClock(0)
        g = LatencyGcGuard(clock=clk)
        assert gc.isenabled()
        frozen_before = gc.get_freeze_count()
        g.start()
        assert not gc.isenabled()
        assert gc.get_freeze_count() > frozen_before
        assert g.inspect()["active"]
        g.maintain()
        assert g.inspect()["young_passes"] == 1
        assert g.inspect()["full_passes"] == 0
        clk.advance(61)
        g.maintain()
        assert g.inspect()["full_passes"] == 1
        g.stop()
        assert gc.isenabled() and not g.inspect()["active"]
        g.maintain()          # inactive: collects nothing
        assert g.inspect()["young_passes"] == 1
        print("ok")
    """)
    out = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=ENV,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_entry_serves_with_the_guard_active():
    """The port's entry (--device cpu) starts the guard after warmup and
    shows it under yadcc/gc_guard in /inspect/vars; SIGTERM stops it
    cleanly."""
    port, iport = _free_port(), _free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "yadcc_tpu_torch.scheduler.entry",
         "--device", "cpu", "--dispatch-policy", "greedy_cpu",
         "--max-servants", "64", "--port", str(port),
         "--inspect-port", str(iport)],
        cwd=REPO, env=ENV, stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE, text=True)
    try:
        guard = None
        deadline = time.monotonic() + 90
        while guard is None:
            assert proc.poll() is None, proc.stderr.read()
            assert time.monotonic() < deadline, "entry did not come up"
            try:
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{iport}/inspect/vars",
                        timeout=5) as r:
                    guard = json.loads(r.read())["yadcc"].get("gc_guard")
            except OSError:
                time.sleep(0.2)
        assert guard["active"] is True
        assert guard["auto_collector_enabled"] is False
        assert guard["frozen_objects"] > 0
    finally:
        proc.send_signal(signal.SIGTERM)
        try:
            rc = proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=30)
            raise
    assert rc == 0
