"""RAII temporary workspaces under the daemon temp root (RAM-disk by
default; a copy of the JAX package's yadcc_tpu/daemon/cloud/temporary.py).
Parity with reference yadcc/daemon/cloud/temporary_dir.{h,cc}."""

from __future__ import annotations

import shutil
from pathlib import Path
from typing import Dict

from ..temp_dir import make_temp_dir


class TemporaryDir:
    def __init__(self, root: str, tag: str = ""):
        self.path = make_temp_dir(root, tag)

    def read_all_files(self) -> Dict[str, bytes]:
        """relative path -> bytes of everything produced inside."""
        rootp = Path(self.path)
        return {
            str(p.relative_to(rootp)): p.read_bytes()
            for p in rootp.rglob("*") if p.is_file()
        }

    def remove(self) -> None:
        shutil.rmtree(self.path, ignore_errors=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.remove()
