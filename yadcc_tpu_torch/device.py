"""Device selection for the port's entry points.

Every entry point runs on the card unless its caller asks for the CPU:
there is no "else CPU" branch, so a missing card is an error the caller
sees, never a silent slowdown."""

from __future__ import annotations


def resolve_device(name: str = "cuda") -> "torch.device":  # noqa: F821
    """``torch.device`` for ``name``: "cuda" (the default) requires a
    visible CUDA device and raises without one; "cpu" is returned only
    when asked for.  torch is imported here, not with the module, so a
    host-only program that imports this module loads no torch."""
    import torch

    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {name!r} requested but CUDA is not available; "
                f"pass device='cpu' to run the plain versions on the CPU")
        return dev
    if dev.type == "cpu":
        return dev
    raise ValueError(f"unsupported device {name!r} (use 'cuda' or 'cpu')")
