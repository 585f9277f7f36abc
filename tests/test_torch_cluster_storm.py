"""The port's connection storm (yadcc_tpu_torch/tools/cluster_sim.py:
run_storm) on the aio front end, as tests/test_aio_frontend.py runs the
JAX package's, and the parked-memory server subprocess, which prices
only the delegate's front end and so must map no torch.
"""

from __future__ import annotations

import pathlib
import subprocess
import sys

from yadcc_tpu.tools import cluster_sim as jcs
from yadcc_tpu_torch.tools import cluster_sim as tcs

from .test_torch_cluster_sim import _keys

REPO = pathlib.Path(__file__).resolve().parent.parent


def test_small_connection_storm_aio_no_losses():
    """tests/test_aio_frontend.py's miniature storm on the port's rig:
    idle long-poll clients park on the aio front end, every one is
    answered, probes stay responsive, compiles still run."""
    out = tcs.run_storm(60, "aio", ramp_per_s=120.0, hold_s=2.0,
                        compile_tasks=5, compile_s=0.0)
    assert set(out) == _keys(jcs.run_storm)
    assert out["lost_or_hung"] == 0
    assert out["error_rate"] == 0.0
    assert out["concurrent_connections"] == 60
    assert out["compile"]["failures"] == 0
    assert out["compile"]["completed"] == 5


def test_storm_server_subprocess_loads_no_torch():
    """The parked-memory server prices only the delegate's front end:
    the port's _storm_server_main, started as measure_parked_memory
    starts it, serves with no libtorch mapped in its process."""
    import urllib.request

    proc = subprocess.Popen(
        [sys.executable, "-c",
         "from yadcc_tpu_torch.tools.cluster_sim import "
         "_storm_server_main; _storm_server_main('aio')"],
        cwd=REPO, stdout=subprocess.PIPE, text=True)
    try:
        word, port = proc.stdout.readline().split()
        assert word == "PORT"
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/local/get_version",
                timeout=10) as r:
            assert r.status == 200
        with open(f"/proc/{proc.pid}/maps") as f:
            maps = f.read()
        assert "libtorch" not in maps
        assert "python" in maps
    finally:
        proc.kill()
        proc.wait(timeout=10)
        proc.stdout.close()
