"""Rule family 7: wire-format compatibility.

The dataplane parity gates (tools/ci.sh ``--smoke``) prove the bytes
on the wire and in the cache are identical across refactors — but only
for the code paths the smoke drives.  This family checks the *schema*
itself, statically, in three layers:

* ``wire-drift`` — ``api/protos/*.proto`` (the human-readable source
  of truth) is cross-checked field-for-field against the committed
  ``api/gen/*_pb2.py`` descriptors (parsed out of the
  ``AddSerializedFile`` blob — the gen module is never imported, so
  the check cannot collide with an already-loaded descriptor pool).
  A field added to the text but not regenerated, or a gen module
  hand-edited out from under its proto, fails lint.
* ``wire-golden`` — the committed golden descriptor
  (``analysis/wire_golden.json``) pins every message/field/enum
  number.  Removing or renumbering a field breaks every peer and every
  existing cache entry (keys and entry bodies embed serialized
  messages), so it must fail lint *before* it fails in production.
  Additions are flagged too: extending the wire format is legal but
  must be an explicit act — ``python -m yadcc_tpu_torch.analysis
  --update-wire-golden`` refreshes the pin after review.
* ``wire-unknown-field`` — constructor keyword arguments on message
  classes (``api.daemon.HeartbeatRequest(tokn=...)``) and repeated-
  field ``.add(...)`` calls are checked against the descriptor's field
  names, catching the typo'd-field class of bug that proto3's
  permissive ``ignore_unknown_fields`` JSON path would silently drop.
"""

from __future__ import annotations

import ast
import json
import os
import re
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .core import AnalyzerConfig, Finding

# descriptor_pb2 FieldDescriptorProto.Type -> canonical name.
_TYPE_NAMES = {
    1: "double", 2: "float", 3: "int64", 4: "uint64", 5: "int32",
    8: "bool", 9: "string", 12: "bytes", 13: "uint32",
    11: "message", 14: "enum",
}

_FIELD_RE = re.compile(
    r"^\s*(repeated\s+)?([\w.]+)\s+(\w+)\s*=\s*(\d+)\s*;")
_ENUM_VALUE_RE = re.compile(r"^\s*(\w+)\s*=\s*(\d+)\s*;")
_BLOCK_RE = re.compile(r"^\s*(message|enum|service)\s+(\w+)\s*\{?")

_SCALARS = {"double", "float", "int32", "int64", "uint32", "uint64",
            "sint32", "sint64", "fixed32", "fixed64", "sfixed32",
            "sfixed64", "bool", "string", "bytes"}


# ---------------------------------------------------------------------------
# Parsers.
# ---------------------------------------------------------------------------


def parse_proto_text(path: str) -> dict:
    """{"messages": {name: {field: [number, type, label]}},
    "enums": {name: {value: number}}, "lines": {...}} from .proto text.
    Covers the subset this repo uses: flat proto3 messages/enums, no
    nesting, no oneof/map."""
    messages: Dict[str, Dict[str, list]] = {}
    enums: Dict[str, Dict[str, int]] = {}
    lines_idx: Dict[str, int] = {}
    stack: List[Tuple[str, str]] = []
    with open(path, "r", encoding="utf-8") as fp:
        for lineno, raw in enumerate(fp, start=1):
            line = raw.split("//", 1)[0].rstrip()
            if not line.strip():
                continue
            m = _BLOCK_RE.match(line)
            if m:
                kind, name = m.group(1), m.group(2)
                stack.append((kind, name))
                if kind == "message":
                    messages.setdefault(name, {})
                elif kind == "enum":
                    enums.setdefault(name, {})
                # One-liner `message Foo {}`:
                if "{" in line and "}" in line:
                    stack.pop()
                continue
            if "}" in line and stack:
                stack.pop()
                continue
            if not stack:
                continue
            kind, name = stack[-1]
            if kind == "message":
                fm = _FIELD_RE.match(line)
                if fm:
                    label = "repeated" if fm.group(1) else ""
                    ftype = fm.group(2).split(".")[-1]
                    if ftype not in _SCALARS:
                        # Message vs enum reference resolved at compare
                        # time; record the bare type name.
                        pass
                    messages[name][fm.group(3)] = [int(fm.group(4)),
                                                   ftype, label]
                    lines_idx[f"{name}.{fm.group(3)}"] = lineno
            elif kind == "enum":
                em = _ENUM_VALUE_RE.match(line)
                if em:
                    enums[name][em.group(1)] = int(em.group(2))
    return {"messages": messages, "enums": enums, "lines": lines_idx}


def extract_serialized_descriptor(gen_path: str) -> Optional[bytes]:
    """The AddSerializedFile(b'...') blob from a *_pb2.py, via AST —
    the module is never imported (importing would register into the
    process-global descriptor pool and conflict with the package's own
    already-loaded copy)."""
    try:
        with open(gen_path, "r", encoding="utf-8") as fp:
            tree = ast.parse(fp.read())
    except (OSError, SyntaxError):
        return None
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and \
                isinstance(node.func, ast.Attribute) and \
                node.func.attr == "AddSerializedFile" and node.args and \
                isinstance(node.args[0], ast.Constant) and \
                isinstance(node.args[0].value, bytes):
            return node.args[0].value
    return None


def parse_gen_descriptor(gen_path: str) -> Optional[dict]:
    """Same shape as parse_proto_text, from the committed descriptor."""
    blob = extract_serialized_descriptor(gen_path)
    if blob is None:
        return None
    try:
        from google.protobuf import descriptor_pb2
    except ImportError:
        return None
    fd = descriptor_pb2.FileDescriptorProto()
    try:
        fd.ParseFromString(blob)
    except Exception:
        return None
    messages: Dict[str, Dict[str, list]] = {}
    enums: Dict[str, Dict[str, int]] = {}
    for msg in fd.message_type:
        fields: Dict[str, list] = {}
        for f in msg.field:
            tname = _TYPE_NAMES.get(f.type, str(f.type))
            if tname in ("message", "enum"):
                tname = f.type_name.split(".")[-1]
            fields[f.name] = [f.number, tname,
                              "repeated" if f.label == 3 else ""]
        messages[msg.name] = fields
    for en in fd.enum_type:
        enums[en.name] = {v.name: v.number for v in en.value}
    return {"name": fd.name, "messages": messages, "enums": enums}


# ---------------------------------------------------------------------------
# API-tree discovery.
# ---------------------------------------------------------------------------


def find_api_dirs(paths: Sequence[str], max_depth: int = 3) -> List[str]:
    """Directories named api/ holding protos/ under any analyzed root."""
    out: List[str] = []
    seen: Set[str] = set()
    for p in paths:
        if os.path.isfile(p):
            p = os.path.dirname(p)
        base_depth = os.path.abspath(p).count(os.sep)
        for dirpath, dirnames, _ in os.walk(p):
            if os.path.abspath(dirpath).count(os.sep) - base_depth \
                    > max_depth:
                dirnames[:] = []
                continue
            dirnames[:] = [d for d in dirnames if d != "__pycache__"]
            if os.path.basename(dirpath) == "api" and \
                    os.path.isdir(os.path.join(dirpath, "protos")):
                ap = os.path.abspath(dirpath)
                if ap not in seen:
                    seen.add(ap)
                    out.append(dirpath)
    return out


# ---------------------------------------------------------------------------
# Checks.
# ---------------------------------------------------------------------------


def _rel(api_dir: str, *parts: str) -> str:
    return os.path.join(os.path.basename(os.path.dirname(api_dir))
                        or "api", "api", *parts).replace(os.sep, "/")


def _compare_schema(proto_rel: str, text: dict, gen: dict,
                    findings: List[Finding]) -> None:
    lines = text.get("lines", {})

    def line_of(msg: str, fld: str = "") -> int:
        return lines.get(f"{msg}.{fld}", 1)

    for mname, tfields in text["messages"].items():
        gfields = gen["messages"].get(mname)
        if gfields is None:
            findings.append(Finding(
                "wire-drift", proto_rel, 1,
                f"message {mname} missing from committed gen module "
                f"(regenerate: python -m yadcc_tpu_torch.api.build_protos)"))
            continue
        for fname, (num, ftype, label) in tfields.items():
            g = gfields.get(fname)
            if g is None:
                findings.append(Finding(
                    "wire-drift", proto_rel, line_of(mname, fname),
                    f"{mname}.{fname} missing from committed gen "
                    f"module (regenerate)"))
            elif g[0] != num:
                findings.append(Finding(
                    "wire-drift", proto_rel, line_of(mname, fname),
                    f"{mname}.{fname}: proto says field number {num}, "
                    f"gen module says {g[0]}"))
            elif g[1] != ftype or g[2] != label:
                findings.append(Finding(
                    "wire-drift", proto_rel, line_of(mname, fname),
                    f"{mname}.{fname}: proto says "
                    f"{label + ' ' if label else ''}{ftype}, gen "
                    f"module says "
                    f"{g[2] + ' ' if g[2] else ''}{g[1]}"))
        for fname in gfields:
            if fname not in tfields:
                findings.append(Finding(
                    "wire-drift", proto_rel, 1,
                    f"{mname}.{fname} exists in the gen module but "
                    f"not in the proto source"))
    for mname in gen["messages"]:
        if mname not in text["messages"]:
            findings.append(Finding(
                "wire-drift", proto_rel, 1,
                f"message {mname} exists in the gen module but not "
                f"in the proto source"))
    for ename, tvals in text["enums"].items():
        gvals = gen["enums"].get(ename)
        if gvals is None:
            findings.append(Finding(
                "wire-drift", proto_rel, 1,
                f"enum {ename} missing from committed gen module"))
            continue
        for vname, num in tvals.items():
            if vname not in gvals:
                findings.append(Finding(
                    "wire-drift", proto_rel, 1,
                    f"{ename}.{vname} missing from gen module"))
            elif gvals[vname] != num:
                findings.append(Finding(
                    "wire-drift", proto_rel, 1,
                    f"{ename}.{vname}: proto says {num}, gen module "
                    f"says {gvals[vname]}"))


def _compare_golden(proto_name: str, proto_rel: str, gen: dict,
                    golden: dict, findings: List[Finding]) -> None:
    pinned = golden.get(proto_name)
    remedy = ("an addition must be pinned: review, then run "
              "python -m yadcc_tpu_torch.analysis --update-wire-golden")
    if pinned is None:
        findings.append(Finding(
            "wire-golden", proto_rel, 1,
            f"{proto_name} is not pinned in the golden descriptor; "
            f"{remedy}"))
        return
    for mname, pfields in pinned.get("messages", {}).items():
        gfields = gen["messages"].get(mname)
        if gfields is None:
            findings.append(Finding(
                "wire-golden", proto_rel, 1,
                f"message {mname} was REMOVED (golden pins it); "
                f"removing a message breaks wire/cache compatibility"))
            continue
        for fname, pin in pfields.items():
            g = gfields.get(fname)
            if g is None:
                findings.append(Finding(
                    "wire-golden", proto_rel, 1,
                    f"{mname}.{fname} was REMOVED (golden pins "
                    f"number {pin[0]}); peers and cached entries "
                    f"still carry it"))
            elif list(g) != list(pin):
                findings.append(Finding(
                    "wire-golden", proto_rel, 1,
                    f"{mname}.{fname} changed "
                    f"{pin} -> {list(g)}: renumbering/retyping "
                    f"breaks the byte-identical wire invariant"))
        for fname in gfields:
            if fname not in pfields:
                findings.append(Finding(
                    "wire-golden", proto_rel, 1,
                    f"new field {mname}.{fname} not in golden; "
                    f"{remedy}"))
    for mname in gen["messages"]:
        if mname not in pinned.get("messages", {}):
            findings.append(Finding(
                "wire-golden", proto_rel, 1,
                f"new message {mname} not in golden; {remedy}"))
    for ename, pvals in pinned.get("enums", {}).items():
        gvals = gen["enums"].get(ename)
        if gvals is None:
            findings.append(Finding(
                "wire-golden", proto_rel, 1,
                f"enum {ename} was REMOVED (golden pins it)"))
            continue
        for vname, num in pvals.items():
            if gvals.get(vname) != num:
                findings.append(Finding(
                    "wire-golden", proto_rel, 1,
                    f"{ename}.{vname} changed/removed (golden pins "
                    f"{num}, gen has {gvals.get(vname)})"))


def build_golden(api_dirs: Sequence[str]) -> dict:
    """Golden pin from the committed gen descriptors (the authoritative
    wire shape — protoc output and pure build agree on it)."""
    golden: Dict[str, dict] = {}
    for api_dir in api_dirs:
        gen_dir = os.path.join(api_dir, "gen")
        if not os.path.isdir(gen_dir):
            continue
        for fname in sorted(os.listdir(gen_dir)):
            if not fname.endswith("_pb2.py"):
                continue
            gen = parse_gen_descriptor(os.path.join(gen_dir, fname))
            if gen is None:
                continue
            golden[gen.get("name") or fname] = {
                "messages": gen["messages"], "enums": gen["enums"]}
    return golden


def check_paths(paths: Sequence[str], records, config: AnalyzerConfig
                ) -> List[Finding]:
    findings: List[Finding] = []
    api_dirs = find_api_dirs(paths)
    golden = None
    if config.wire_golden:
        try:
            with open(config.wire_golden, "r", encoding="utf-8") as fp:
                golden = json.load(fp)
        except (OSError, ValueError) as e:
            findings.append(Finding(
                "wire-golden", config.wire_golden, 1,
                f"cannot load golden descriptor: {e} "
                f"(run --update-wire-golden)"))

    all_messages: Dict[str, Dict[str, list]] = {}
    for api_dir in api_dirs:
        proto_dir = os.path.join(api_dir, "protos")
        gen_dir = os.path.join(api_dir, "gen")
        for fname in sorted(os.listdir(proto_dir)):
            if not fname.endswith(".proto"):
                continue
            proto_rel = _rel(api_dir, "protos", fname)
            stem = fname[:-len(".proto")]
            gen_path = os.path.join(gen_dir, f"{stem}_pb2.py")
            if not os.path.exists(gen_path):
                findings.append(Finding(
                    "wire-drift", proto_rel, 1,
                    f"no committed gen module for {fname} "
                    f"(python -m yadcc_tpu_torch.api.build_protos)"))
                continue
            text = parse_proto_text(os.path.join(proto_dir, fname))
            gen = parse_gen_descriptor(gen_path)
            if gen is None:
                findings.append(Finding(
                    "wire-drift", proto_rel, 1,
                    f"cannot extract descriptor from {stem}_pb2.py"))
                continue
            _compare_schema(proto_rel, text, gen, findings)
            if golden is not None:
                _compare_golden(fname, proto_rel, gen, golden, findings)
            for mname, fields in gen["messages"].items():
                all_messages.setdefault(mname, {}).update(fields)

    if all_messages:
        findings.extend(_check_field_access(records, all_messages))
    return findings


def _check_field_access(records, all_messages: Dict[str, Dict[str, list]]
                        ) -> List[Finding]:
    findings: List[Finding] = []
    # repeated message field name -> union of target-message field names.
    repeated_msg_fields: Dict[str, Set[str]] = {}
    for fields in all_messages.values():
        for fname, (num, ftype, label) in fields.items():
            if label == "repeated" and ftype in all_messages:
                repeated_msg_fields.setdefault(fname, set()).update(
                    all_messages[ftype])
    for rec in records:
        for site in rec.callsites:
            if site.get("tasktype"):
                continue
            last = site["last"]
            kwargs = site["kwargs"]
            if last in all_messages:
                allowed = set(all_messages[last])
                for kw in kwargs:
                    if kw not in allowed:
                        findings.append(Finding(
                            "wire-unknown-field", rec.relpath,
                            site["line"],
                            f"{last}({kw}=...): descriptor defines no "
                            f"field {kw!r}"))
            elif last == "add" and len(site.get("chain", ())) >= 2:
                parent = site["chain"][-2]
                allowed2 = repeated_msg_fields.get(parent)
                if allowed2:
                    for kw in kwargs:
                        if kw not in allowed2:
                            findings.append(Finding(
                                "wire-unknown-field", rec.relpath,
                                site["line"],
                                f"{parent}.add({kw}=...): no such "
                                f"field on the repeated message type"))
    return findings
