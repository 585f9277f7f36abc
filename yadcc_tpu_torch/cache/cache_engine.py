"""L2 cache-engine SPI + registry (a copy of the JAX package's
yadcc_tpu/cache/cache_engine.py).

Parity with reference yadcc/cache/cache_engine.h:31-53: the cache server
selects its durable tier with --cache-engine={disk,null,objstore}; each
engine implements the same tiny surface.  Keys must be enumerable so the
Bloom filter can be rebuilt from L2 after a restart.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional


class CacheEngine:
    name = "abstract"

    def try_get(self, key: str) -> Optional[bytes]:
        raise NotImplementedError

    def put(self, key: str, value: bytes) -> None:
        raise NotImplementedError

    def remove(self, key: str) -> None:
        raise NotImplementedError

    def keys(self) -> List[str]:
        """All stored keys (drives Bloom rebuild at startup/periodically)."""
        raise NotImplementedError

    def stats(self) -> Dict:
        return {}

    def purge(self) -> None:
        """Periodic maintenance pass (reference runs `cache_->Purge()`
        on a 1-min timer, cache_service_impl.cc:172-180).  Engines with
        no expiry/size maintenance keep the default no-op."""

    def stop(self) -> None:
        pass


class NullCacheEngine(CacheEngine):
    """L2 disabled: the server runs L1-only (parity with reference
    yadcc/cache/null_cache_engine.h:32-41)."""

    name = "null"

    def try_get(self, key: str) -> Optional[bytes]:
        return None

    def put(self, key: str, value: bytes) -> None:
        pass

    def remove(self, key: str) -> None:
        pass

    def keys(self) -> List[str]:
        return []


_REGISTRY: Dict[str, Callable[..., CacheEngine]] = {}


def register_engine(name: str, factory: Callable[..., CacheEngine]) -> None:
    _REGISTRY[name] = factory


def make_engine(name: str, **kwargs) -> CacheEngine:
    if name not in _REGISTRY:
        raise ValueError(
            f"unknown cache engine {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name](**kwargs)


register_engine("null", lambda **kw: NullCacheEngine())
