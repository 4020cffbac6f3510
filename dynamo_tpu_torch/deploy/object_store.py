"""Artifact object storage backends for the api-store.

The reference api-store uploads artifact bundles to S3 or a PVC
(ai_dynamo_store/api/dynamo.py:48,550-565); here the same seam is an async
key/value object interface with two backends:

- :class:`LocalFsStore` — keys are paths under a root directory (the PVC
  analogue, and the default).
- :class:`S3Store` — a minimal S3 REST subset (PUT/GET/DELETE object +
  ListObjectsV2) against any S3-compatible endpoint; unsigned requests, so
  it pairs with in-cluster minio-style gateways or :class:`MinioStub`.

:class:`MinioStub` is an in-process server speaking that same subset, used
by tests (and usable as a dev fixture).

Pick a backend with a storage URL: ``file:///var/artifacts`` or
``s3://bucket?endpoint=http://minio:9000``.

The JAX package's ``dynamo_tpu/deploy/object_store.py`` without aiohttp,
which the card's machine lacks: :class:`S3Store` sends its requests with
``urllib`` on a worker thread, and :class:`MinioStub` runs on the port's
own HTTP/1.1 server (``llm/http_service.py``). Paths, statuses and bodies
are the JAX classes'.
"""

from __future__ import annotations

import asyncio
import os
import re
import urllib.error
import urllib.request
from typing import Dict, List, Optional, Tuple
from urllib.parse import parse_qs, quote, urlsplit
from xml.sax.saxutils import escape

from ..llm.http_service import HttpServer, Response

_TEXT = "text/plain; charset=utf-8"


class ObjectStore:
    async def put(self, key: str, data: bytes) -> None:
        raise NotImplementedError

    async def get(self, key: str) -> Optional[bytes]:
        raise NotImplementedError

    async def delete(self, key: str) -> bool:
        raise NotImplementedError

    async def list(self, prefix: str = "") -> List[str]:
        raise NotImplementedError

    async def close(self) -> None:
        pass


def open_object_store(url: str) -> ObjectStore:
    """``file:///path`` (or a bare path) | ``s3://bucket?endpoint=...``."""
    if url.startswith("s3://"):
        parts = urlsplit(url)
        q = parse_qs(parts.query)
        endpoint = (q.get("endpoint") or [None])[0]
        if not endpoint:
            raise ValueError("s3:// storage needs ?endpoint=http://host:port")
        return S3Store(endpoint, parts.netloc)
    if url.startswith("file://"):
        url = urlsplit(url).path
    return LocalFsStore(url)


class LocalFsStore(ObjectStore):
    def __init__(self, root: str):
        self.root = root
        os.makedirs(root, exist_ok=True)

    def _path(self, key: str) -> str:
        root = os.path.abspath(self.root)
        p = os.path.abspath(os.path.normpath(os.path.join(self.root, key)))
        # commonpath, not startswith: a sibling dir whose name has the
        # root as a prefix (root=/data/artifacts, key=../artifacts-x/f)
        # must not pass the escape guard
        if p != root and os.path.commonpath([root, p]) != root:
            raise ValueError(f"key escapes root: {key!r}")
        return p

    async def put(self, key: str, data: bytes) -> None:
        p = self._path(key)
        os.makedirs(os.path.dirname(p), exist_ok=True)
        with open(p, "wb") as f:
            f.write(data)

    async def get(self, key: str) -> Optional[bytes]:
        try:
            with open(self._path(key), "rb") as f:
                return f.read()
        except (OSError, ValueError):
            return None

    async def delete(self, key: str) -> bool:
        try:
            os.unlink(self._path(key))
            return True
        except OSError:
            return False

    async def list(self, prefix: str = "") -> List[str]:
        out = []
        for dirpath, _dirs, files in os.walk(self.root):
            for f in files:
                rel = os.path.relpath(os.path.join(dirpath, f), self.root)
                rel = rel.replace(os.sep, "/")
                if rel.startswith(prefix):
                    out.append(rel)
        return sorted(out)


def http_request(method: str, url: str, data: Optional[bytes] = None,
                 timeout: float = 60.0) -> Tuple[int, bytes]:
    """One blocking HTTP request: (status, body), an error status
    included. Run it on a worker thread from a coroutine."""
    req = urllib.request.Request(url, data=data, method=method)
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


class S3Store(ObjectStore):
    """Minimal S3 REST client (path-style, unsigned)."""

    def __init__(self, endpoint: str, bucket: str):
        self.endpoint = endpoint.rstrip("/")
        self.bucket = bucket

    def _url(self, key: str) -> str:
        return f"{self.endpoint}/{self.bucket}/{quote(key)}"

    @staticmethod
    async def _call(method: str, url: str,
                    data: Optional[bytes] = None) -> Tuple[int, bytes]:
        return await asyncio.to_thread(http_request, method, url, data)

    async def put(self, key: str, data: bytes) -> None:
        status, _ = await self._call("PUT", self._url(key), data)
        if status >= 300:
            raise IOError(f"s3 put {key}: {status}")

    async def get(self, key: str) -> Optional[bytes]:
        status, body = await self._call("GET", self._url(key))
        if status == 404:
            return None
        if status >= 300:
            raise IOError(f"s3 get {key}: {status}")
        return body

    async def delete(self, key: str) -> bool:
        # S3 DELETE is 204 whether or not the key existed; the ObjectStore
        # contract (and the api-store's 404 path) needs the truth
        if await self.get(key) is None:
            return False
        status, _ = await self._call("DELETE", self._url(key))
        return status < 300

    async def list(self, prefix: str = "") -> List[str]:
        keys: List[str] = []
        token: Optional[str] = None
        while True:     # ListObjectsV2 pages at 1000 keys
            url = (f"{self.endpoint}/{self.bucket}"
                   f"?list-type=2&prefix={quote(prefix)}")
            if token:
                url += f"&continuation-token={quote(token)}"
            status, raw = await self._call("GET", url)
            if status >= 300:
                raise IOError(f"s3 list {prefix}: {status}")
            text = raw.decode()
            keys.extend(re.findall(r"<Key>([^<]*)</Key>", text))
            m = re.search(r"<NextContinuationToken>([^<]*)"
                          r"</NextContinuationToken>", text)
            truncated = re.search(r"<IsTruncated>true</IsTruncated>", text)
            if not (truncated and m):
                return sorted(keys)
            token = m.group(1)


class MinioStub:
    """In-process S3-compatible object server (the subset S3Store speaks):
    PUT/GET/DELETE ``/{bucket}/{key}`` and ListObjectsV2."""

    def __init__(self):
        self.buckets: Dict[str, Dict[str, bytes]] = {}
        self._server = None
        self.port = 0

    async def start(self, port: int = 0) -> int:
        self._server = HttpServer("127.0.0.1", port, {
            ("GET", "/{bucket}"): self._list,
            ("PUT", "/{bucket}/{key:.+}"): self._put,
            ("GET", "/{bucket}/{key:.+}"): self._get,
            ("DELETE", "/{bucket}/{key:.+}"): self._delete,
        }, max_body=1 << 30)
        self.port = await self._server.start()
        return self.port

    async def stop(self) -> None:
        if self._server is not None:
            await self._server.stop()

    # ------------------------------------------------------------------
    async def _put(self, req):
        b = self.buckets.setdefault(req.match_info["bucket"], {})
        b[req.match_info["key"]] = req.body
        return Response(200, b"", _TEXT)

    async def _get(self, req):
        b = self.buckets.get(req.match_info["bucket"], {})
        data = b.get(req.match_info["key"])
        if data is None:
            return Response(404, b"404: Not Found", _TEXT)
        return Response(200, data, "application/octet-stream")

    async def _delete(self, req):
        b = self.buckets.get(req.match_info["bucket"], {})
        b.pop(req.match_info["key"], None)
        return Response(204, b"", "application/octet-stream")

    async def _list(self, req):
        prefix = req.query.get("prefix", "")
        b = self.buckets.get(req.match_info["bucket"], {})
        keys = sorted(k for k in b if k.startswith(prefix))
        body = ("<?xml version=\"1.0\"?><ListBucketResult>"
                + "".join(f"<Contents><Key>{escape(k)}</Key></Contents>"
                          for k in keys)
                + "</ListBucketResult>")
        return Response(200, body.encode(), "application/xml; charset=utf-8")
