"""Minimal TOML-subset reader for lock_hierarchy.toml.

The container's Python is 3.10 (no stdlib tomllib) and the repo policy
is zero new dependencies, so this reads exactly the subset the
hierarchy file uses: ``[section]`` headers, ``key = value`` pairs with
bare or quoted keys, integer / quoted-string values, ``#`` comments.
Anything fancier (arrays, tables-in-tables, multiline strings) is a
deliberate parse error — the hierarchy file should stay boring.
"""

from __future__ import annotations

import re
from typing import Dict

_SECTION_RE = re.compile(r"^\[\s*([A-Za-z0-9_.\-]+)\s*\]$")
_PAIR_RE = re.compile(
    r"""^(?:"([^"]+)"|'([^']+)'|([A-Za-z0-9_.\-]+))\s*=\s*(.+)$""")


class MiniTomlError(ValueError):
    pass


def _strip_comment(line: str) -> str:
    out = []
    in_str: str = ""
    for ch in line:
        if in_str:
            out.append(ch)
            if ch == in_str:
                in_str = ""
            continue
        if ch in "\"'":
            in_str = ch
            out.append(ch)
            continue
        if ch == "#":
            break
        out.append(ch)
    return "".join(out).strip()


def loads(text: str) -> Dict[str, Dict[str, object]]:
    doc: Dict[str, Dict[str, object]] = {}
    section = doc.setdefault("", {})
    for lineno, raw in enumerate(text.splitlines(), start=1):
        line = _strip_comment(raw)
        if not line:
            continue
        m = _SECTION_RE.match(line)
        if m:
            section = doc.setdefault(m.group(1), {})
            continue
        m = _PAIR_RE.match(line)
        if not m:
            raise MiniTomlError(f"line {lineno}: cannot parse {raw!r}")
        key = m.group(1) or m.group(2) or m.group(3)
        val = m.group(4).strip()
        if re.fullmatch(r"-?\d+", val):
            section[key] = int(val)
        elif len(val) >= 2 and val[0] == val[-1] and val[0] in "\"'":
            section[key] = val[1:-1]
        elif val in ("true", "false"):
            section[key] = val == "true"
        else:
            raise MiniTomlError(
                f"line {lineno}: unsupported value {val!r}")
    return doc


def load_path(path: str) -> Dict[str, Dict[str, object]]:
    with open(path, "r", encoding="utf-8") as fp:
        return loads(fp.read())
