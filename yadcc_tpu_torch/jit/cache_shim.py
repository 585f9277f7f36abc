"""Get/put over the cluster cache (the port's counterpart of the JAX
package's yadcc_tpu/jit/cache_shim.py, without ``install_into_jax``).

Two ways to consume the jit subsystem: full offload (frontend.py — the
build runs remotely) and this shim — the build still runs locally, but
its result is shared cluster-wide through the same distributed cache
the compile farm uses: a get/put key-value store under the program's
own keys.  The JAX package also points jax's persistent compilation
cache at it (``install_into_jax``); torch's matching seam is private
and needs Triton, so the port has no such hook.

Keys are opaque client-namespace strings; the daemon domain-hashes them
into a versioned ``ytpu-jitext1-`` namespace (http_service.py
``shim_cache_key``, the JAX package's), so shim entries can never
collide with task-derived cache entries.

Wire shape (multi-chunk [json, value] both directions, like every other
attachment-bearing local route):

    POST /local/jit_cache_get   200 [json, value] | 404 miss
    POST /local/jit_cache_put   200 | 404 shim disabled on this daemon
"""

from __future__ import annotations

from typing import Optional

from google.protobuf import json_format

from .. import api
from ..client.daemon_call import call_daemon
from ..common import multi_chunk
from ..utils.logging import get_logger

logger = get_logger("jit.cache_shim")


class ClusterCompileCache:
    """get/put facade (get returns None on a miss)."""

    def get(self, key: str) -> Optional[bytes]:
        req = api.jit.JitCacheGetRequest(key=key)
        resp = call_daemon("POST", "/local/jit_cache_get",
                           json_format.MessageToJson(req).encode())
        if resp.status != 200:
            return None
        chunks = multi_chunk.try_parse_multi_chunk(resp.body)
        if not chunks or len(chunks) != 2:
            logger.warning("malformed jit_cache_get reply for %r", key)
            return None
        return bytes(chunks[1])

    def put(self, key: str, value: bytes) -> None:
        req = api.jit.JitCachePutRequest(key=key)
        body = multi_chunk.make_multi_chunk_payload([
            json_format.MessageToJson(req).encode(), value])
        resp = call_daemon("POST", "/local/jit_cache_put", body)
        if resp.status != 200:
            # Fire-and-forget, like the servant's own cache fills: a
            # missing daemon must not fail the caller's compile.
            logger.debug("jit_cache_put %r -> HTTP %d", key, resp.status)

