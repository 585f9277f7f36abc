"""Content-hash result cache for the analyzer.

The analyzer runs before every test cycle and on the card's host; the
analyzer's cost is dominated by ``ast.parse`` + the per-file rule
walks, and almost no file changes between runs.  Entries key on:

* the file's content hash (sha256 of its source),
* the run's *global key* — the directive fingerprint (which names
  carry sanitizes/acquires/untrusted annotations anywhere in the tree;
  cross-file taint/lifecycle results depend on it) hashed together
  with the config digest,
* the analyzer fingerprint — a hash of the ``analysis/*.py`` sources
  themselves, so editing a rule invalidates everything without a
  version constant anyone could forget to bump.

The store is one JSON file (default
``~/.cache/ytpu-torch-analyze/cache.json``, apart from the JAX
analyzer's file), bounded to ``max_entries`` by
dropping oldest-inserted first.  Corruption of any kind degrades to a
cold run, never to an error."""

from __future__ import annotations

import hashlib
import json
import os
from typing import Dict, Optional


def default_cache_path() -> str:
    base = os.environ.get("XDG_CACHE_HOME") or \
        os.path.join(os.path.expanduser("~"), ".cache")
    return os.path.join(base, "ytpu-torch-analyze", "cache.json")


def analyzer_fingerprint() -> str:
    """Hash of the analyzer's own sources: any rule edit is a new
    cache universe."""
    pkg = os.path.dirname(os.path.abspath(__file__))
    h = hashlib.sha256()
    for fname in sorted(os.listdir(pkg)):
        if fname.endswith((".py", ".toml")):
            try:
                with open(os.path.join(pkg, fname), "rb") as fp:
                    h.update(fname.encode())
                    h.update(fp.read())
            except OSError:
                pass
    return h.hexdigest()


class ResultCache:
    def __init__(self, path: Optional[str] = None,
                 max_entries: int = 4096):
        self.path = path or default_cache_path()
        self.max_entries = max_entries
        self._fp = analyzer_fingerprint()
        self._entries: Dict[str, dict] = {}
        self._dirty = False
        self._load()

    def _load(self) -> None:
        try:
            with open(self.path, "r", encoding="utf-8") as fp:
                doc = json.load(fp)
            if doc.get("analyzer") == self._fp and \
                    isinstance(doc.get("entries"), dict):
                self._entries = doc["entries"]
        except (OSError, ValueError):
            self._entries = {}

    def _key(self, content_hash: str, global_key: str) -> str:
        return f"{content_hash}:{global_key}"

    def get(self, content_hash: str, global_key: str) -> Optional[dict]:
        entry = self._entries.get(self._key(content_hash, global_key))
        return entry if isinstance(entry, dict) else None

    def put(self, content_hash: str, global_key: str,
            record: dict) -> None:
        key = self._key(content_hash, global_key)
        self._entries.pop(key, None)
        self._entries[key] = record
        while len(self._entries) > self.max_entries:
            self._entries.pop(next(iter(self._entries)))
        self._dirty = True

    def save(self) -> None:
        if not self._dirty:
            return
        try:
            os.makedirs(os.path.dirname(self.path), exist_ok=True)
            tmp = self.path + ".tmp"
            with open(tmp, "w", encoding="utf-8") as fp:
                json.dump({"analyzer": self._fp,
                           "entries": self._entries}, fp)
            os.replace(tmp, self.path)
            self._dirty = False
        except OSError:
            pass
