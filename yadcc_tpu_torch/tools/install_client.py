"""Client symlink-farm installer (a copy of the JAX package's
yadcc_tpu/tools/install_client.py over the port's clients).

Parity with the reference's deployment workflow (yadcc/README.md:21-27,
yadcc/doc/client.md): the client masquerades as the compiler via
symlinks placed in a directory that goes FIRST on PATH:

    python -m yadcc_tpu_torch.tools.install_client ~/.ytpu/bin
    export PATH=~/.ytpu/bin:$PATH
    make -j256        # unchanged build system, distributed compiles

Prefers the port's native `ytpu-cxx` (yadcc_tpu_torch/native/), built at
first use into yadcc_tpu_torch/_build/native/<frames>/; falls back to a
wrapper script invoking the port's Python client when it cannot be
built.  Also installs quota-only wrappers for non-distributable tools
(javac/jar).  The native client speaks the frames of the daemon on this
host: zstd when the `zstandard` wheel is installed, else the zlib frames
of common/_zlib_frames.py.  Loads no torch.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path
from typing import Optional

_CXX_NAMES = ("gcc", "g++", "cc", "c++", "clang", "clang++")
_WRAPPER_NAMES = ("javac", "jar")


def _repo_root() -> Path:
    return Path(__file__).resolve().parents[2]


def native_frames() -> str:
    """The frames this host's daemon speaks (common/compress.py)."""
    from ..common import compress

    return "zstd" if compress.zstandard is not None else "zlib"


def build_native(targets=("client", "fakeroot"),
                 frames: Optional[str] = None) -> Path:
    """Build ``targets`` of yadcc_tpu_torch/native/Makefile into the
    frames' build directory and return it; RuntimeError (with make's
    output) if the build fails or there is no `make`.  The binaries are
    never committed: they are built on the machine they run on, so they
    cannot drift from the sources."""
    import fcntl

    frames = frames or native_frames()
    pkg = Path(__file__).resolve().parents[1]
    out = pkg / "_build" / "native" / frames
    out.mkdir(parents=True, exist_ok=True)
    # One build at a time into ``out``: two processes linking the same
    # binary at once can leave it broken.
    with open(out / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            r = subprocess.run(["make", "-C", str(pkg / "native"),
                                f"OUT={out}", f"FRAMES={frames}", *targets],
                               capture_output=True, text=True)
        except FileNotFoundError as e:  # no `make` on this host
            raise RuntimeError(f"native build needs make: {e}") from None
    if r.returncode != 0:
        raise RuntimeError(f"native build failed:\n{r.stderr[-2000:]}")
    return out


def _native_client() -> Optional[Path]:
    """Build (or reuse) the native client and its fakeroot shim; None if
    this host cannot build them."""
    try:
        out = build_native()
    except RuntimeError as e:
        sys.stderr.write(f"{e}\nusing the Python client\n")
        return None
    p = out / "ytpu-cxx"
    return p if p.exists() else None


def _write_script(path: Path, body: str) -> None:
    # Never write through a stale symlink (a previous native install
    # would get its real binary clobbered with script text).
    if path.is_symlink() or path.exists():
        path.unlink()
    path.write_text(body)
    path.chmod(0o755)


def install(bin_dir: str, use_python_client: bool = False) -> None:
    out = Path(bin_dir).expanduser()
    out.mkdir(parents=True, exist_ok=True)
    native = None if use_python_client else _native_client()
    repo = _repo_root()

    if native is not None:
        # Symlinks straight onto the native binary: it dispatches on
        # the invoked name (argv[0]) like the reference's yadcc-cxx, and
        # finds the fakeroot shim beside the binary it resolves to.
        for name in ("ytpu-cxx",) + _CXX_NAMES:
            link = out / name
            if link.is_symlink() or link.exists():
                link.unlink()
            link.symlink_to(native)
        print(f"installed native client links in {out}")
    else:
        for name in _CXX_NAMES:
            _write_script(out / name, (
                "#!/bin/sh\n"
                f'export PYTHONPATH="{repo}:$PYTHONPATH"\n'
                # Marks this farm dir so find_real_compiler never
                # resolves back to these wrappers (fork-loop guard).
                f'export YTPU_WRAPPER_DIR="{out}"\n'
                f'exec "{sys.executable}" -m yadcc_tpu_torch.client.yadcc_cxx '
                f'{name} "$@"\n'))
        print(f"installed python client wrappers in {out}")

    for name in _WRAPPER_NAMES:
        _write_script(out / name, (
            "#!/bin/sh\n"
            f'export PYTHONPATH="{repo}:$PYTHONPATH"\n'
            f'export YTPU_WRAPPER_DIR="{out}"\n'
            f'exec "{sys.executable}" -m '
            f'yadcc_tpu_torch.client.universal_wrapper {name} "$@"\n'))
    print(f"quota wrappers: {', '.join(_WRAPPER_NAMES)}")
    print(f"activate with:  export PATH={out}:$PATH")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        "python -m yadcc_tpu_torch.tools.install_client")
    ap.add_argument("bin_dir", help="directory to fill (goes first on PATH)")
    ap.add_argument("--python-client", action="store_true",
                    help="force the Python client even if the native "
                         "binary builds")
    args = ap.parse_args(argv)
    install(args.bin_dir, use_python_client=args.python_client)


if __name__ == "__main__":
    main()
