"""Temporary workspace management (a copy of the JAX package's
yadcc_tpu/daemon/temp_dir.py).

Parity with reference yadcc/daemon/temp_dir.cc:23 (--temporary_dir
defaults to /dev/shm — compile workspaces are RAM-disk-backed so object
files never touch real disk) and daemon/entry.cc:134-160 (stale
``ytpu_*`` directories from crashed prior runs are removed at startup).
"""

from __future__ import annotations

import os
import shutil
import tempfile
from pathlib import Path

_PREFIX = "ytpu_"


def default_temp_root() -> str:
    return "/dev/shm" if os.path.isdir("/dev/shm") else tempfile.gettempdir()


def clean_stale_temp_dirs(root: str) -> int:
    """Remove leftovers from previous daemon incarnations; returns count."""
    removed = 0
    try:
        for p in Path(root).iterdir():
            if p.name.startswith(_PREFIX):
                shutil.rmtree(p, ignore_errors=True)
                removed += 1
    except OSError:
        pass
    return removed


def make_temp_dir(root: str, tag: str = "") -> str:
    return tempfile.mkdtemp(prefix=f"{_PREFIX}{tag}", dir=root)
