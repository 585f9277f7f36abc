"""Human-readable byte-size parsing ("10G", "512M"), parity with
reference yadcc/common/parse_size.cc."""

from __future__ import annotations

import re
from typing import Optional

_UNITS = {
    "": 1,
    "b": 1,
    "k": 1 << 10,
    "kb": 1 << 10,
    "m": 1 << 20,
    "mb": 1 << 20,
    "g": 1 << 30,
    "gb": 1 << 30,
    "t": 1 << 40,
    "tb": 1 << 40,
}

_RE = re.compile(r"^\s*(\d+(?:\.\d+)?)\s*([a-zA-Z]*)\s*$")


def try_parse_size(text: str) -> Optional[int]:
    m = _RE.match(text)
    if not m:
        return None
    mult = _UNITS.get(m.group(2).lower())
    if mult is None:
        return None
    return int(float(m.group(1)) * mult)


def parse_size(text: str) -> int:
    v = try_parse_size(text)
    if v is None:
        raise ValueError(f"unrecognized size: {text!r}")
    return v
