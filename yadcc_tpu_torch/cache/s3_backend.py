"""S3-compatible HTTP object-store backend (a copy of the JAX package's
yadcc_tpu/cache/s3_backend.py; stdlib only, so the cache server that
uses it loads no torch).

Parity with reference yadcc/cache/cos_cache_engine.cc:38-51,100-220: the
reference persists its L2 in a vendor object store (Tencent COS) through
an HTTP client with credentials, bucket config, and capacity accounting.
This backend speaks the S3 wire protocol (AWS Signature V4, ListObjectsV2
pagination) over plain ``http.client`` — stdlib only, works against AWS,
GCS interop mode, MinIO, Ceph RGW, or the in-process fake used by
tests/test_s3_backend.py and tests/test_torch_s3_backend.py.

Transient faults (connection errors, 5xx) retry with exponential
backoff; 4xx errors are surfaced immediately (a signature bug must not
look like an outage).
"""

from __future__ import annotations

import datetime
import hashlib
import hmac
import http.client
import time
import urllib.parse
import xml.etree.ElementTree as ET
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from ..utils.logging import get_logger
from .object_store_engine import ObjectStoreBackend

logger = get_logger("cache.s3")

_EMPTY_SHA256 = hashlib.sha256(b"").hexdigest()


@dataclass
class S3Config:
    endpoint: str             # "host:port" (path-style addressing)
    bucket: str
    access_key: str
    secret_key: str
    region: str = "us-east-1"
    prefix: str = ""          # object key prefix ("dir" in the reference)
    use_tls: bool = False
    retries: int = 3
    timeout_s: float = 10.0


def _sign(key: bytes, msg: str) -> bytes:
    return hmac.new(key, msg.encode(), hashlib.sha256).digest()


def _signing_key(secret: str, date: str, region: str, service: str) -> bytes:
    k = _sign(("AWS4" + secret).encode(), date)
    k = _sign(k, region)
    k = _sign(k, service)
    return _sign(k, "aws4_request")


def sigv4_headers(
    cfg: S3Config,
    method: str,
    canonical_uri: str,
    query: List[Tuple[str, str]],
    payload_sha256: str,
    now: Optional[datetime.datetime] = None,
) -> Dict[str, str]:
    """AWS Signature Version 4 headers for one request.

    Split out (and deterministic given `now`) so the fake server in the
    test suite can verify signatures with the same code path reversed.
    """
    now = now or datetime.datetime.now(datetime.timezone.utc)
    amz_date = now.strftime("%Y%m%dT%H%M%SZ")
    datestamp = now.strftime("%Y%m%d")

    canonical_query = "&".join(
        f"{urllib.parse.quote(k, safe='')}={urllib.parse.quote(v, safe='')}"
        for k, v in sorted(query)
    )
    headers = {
        "host": cfg.endpoint,
        "x-amz-content-sha256": payload_sha256,
        "x-amz-date": amz_date,
    }
    signed_headers = ";".join(sorted(headers))
    canonical_headers = "".join(
        f"{k}:{headers[k]}\n" for k in sorted(headers))
    canonical_request = "\n".join([
        method, canonical_uri, canonical_query, canonical_headers,
        signed_headers, payload_sha256,
    ])
    scope = f"{datestamp}/{cfg.region}/s3/aws4_request"
    string_to_sign = "\n".join([
        "AWS4-HMAC-SHA256", amz_date, scope,
        hashlib.sha256(canonical_request.encode()).hexdigest(),
    ])
    signature = hmac.new(
        _signing_key(cfg.secret_key, datestamp, cfg.region, "s3"),
        string_to_sign.encode(), hashlib.sha256).hexdigest()
    return {
        "Host": cfg.endpoint,
        "x-amz-content-sha256": payload_sha256,
        "x-amz-date": amz_date,
        "Authorization": (
            f"AWS4-HMAC-SHA256 Credential={cfg.access_key}/{scope}, "
            f"SignedHeaders={signed_headers}, Signature={signature}"),
    }


class S3Error(Exception):
    def __init__(self, status: int, body: bytes):
        super().__init__(f"s3 request failed: HTTP {status}: {body[:200]!r}")
        self.status = status


class S3ObjectStoreBackend(ObjectStoreBackend):
    """list/get/put/delete under `prefix`, path-style addressing."""

    def __init__(self, cfg: S3Config):
        self._cfg = cfg

    # -- one signed HTTP round trip with retry ---------------------------

    def _request(
        self,
        method: str,
        object_name: str = "",
        query: Optional[List[Tuple[str, str]]] = None,
        body: bytes = b"",
        ok_status: Tuple[int, ...] = (200,),
    ) -> Tuple[int, bytes]:
        cfg = self._cfg
        query = query or []
        path = "/" + cfg.bucket
        if object_name:
            path += "/" + urllib.parse.quote(
                (cfg.prefix + object_name).encode(), safe="/")
        payload_sha = (hashlib.sha256(body).hexdigest() if body
                       else _EMPTY_SHA256)
        qs = urllib.parse.urlencode(sorted(query))
        url = path + ("?" + qs if qs else "")

        last_exc: Optional[Exception] = None
        for attempt in range(cfg.retries + 1):
            if attempt:
                # 0.2s, 0.4s, 0.8s... — transient 5xx/connect faults only.
                time.sleep(0.2 * (2 ** (attempt - 1)))
            try:
                conn_cls = (http.client.HTTPSConnection if cfg.use_tls
                            else http.client.HTTPConnection)
                conn = conn_cls(cfg.endpoint, timeout=cfg.timeout_s)
                headers = sigv4_headers(cfg, method, path, query, payload_sha)
                conn.request(method, url, body=body or None, headers=headers)
                resp = conn.getresponse()
                data = resp.read()
                conn.close()
            except (OSError, http.client.HTTPException) as e:
                last_exc = e
                logger.warning("s3 %s %s: %s (attempt %d)", method,
                               object_name or path, e, attempt + 1)
                continue
            if resp.status >= 500:
                last_exc = S3Error(resp.status, data)
                logger.warning("s3 %s %s: HTTP %d (attempt %d)", method,
                               object_name or path, resp.status, attempt + 1)
                continue
            if resp.status in ok_status:
                return resp.status, data
            raise S3Error(resp.status, data)
        raise last_exc if last_exc else S3Error(599, b"unreachable")

    # -- ObjectStoreBackend surface --------------------------------------

    def get(self, name: str) -> Optional[bytes]:
        status, data = self._request("GET", name, ok_status=(200, 404))
        return None if status == 404 else data

    def put(self, name: str, data: bytes) -> None:
        self._request("PUT", name, body=data)

    def delete(self, name: str) -> None:
        # S3 DeleteObject returns 204 whether or not the key existed.
        self._request("DELETE", name, ok_status=(200, 204, 404))

    def list_objects(self) -> List[Tuple[str, int]]:
        """All (name, size) under the prefix, following ListObjectsV2
        continuation tokens."""
        out: List[Tuple[str, int]] = []
        token = ""
        while True:
            query: List[Tuple[str, str]] = [("list-type", "2")]
            if self._cfg.prefix:
                query.append(("prefix", self._cfg.prefix))
            if token:
                query.append(("continuation-token", token))
            _, data = self._request("GET", "", query=query)
            root = ET.fromstring(data)
            ns = ""
            if root.tag.startswith("{"):
                ns = root.tag[: root.tag.index("}") + 1]
            for contents in root.findall(f"{ns}Contents"):
                key = contents.findtext(f"{ns}Key", "")
                size = int(contents.findtext(f"{ns}Size", "0"))
                if key.startswith(self._cfg.prefix):
                    out.append((key[len(self._cfg.prefix):], size))
            if root.findtext(f"{ns}IsTruncated", "false") != "true":
                return out
            token = root.findtext(f"{ns}NextContinuationToken", "")
            if not token:
                return out
