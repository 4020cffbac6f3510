"""API/artifact store: HTTP CRUD for graph artifacts and deployments.

Artifacts (packaged service graphs — a tarball or any bytes) are versioned
under a content directory; deployments are Deployment resources written into
dynstore, where the operator watches them. This is the control-plane front
door the reference runs as its FastAPI api-store.

    POST   /api/v1/artifacts/{name}/versions          (body = bytes)
    GET    /api/v1/artifacts                          list
    GET    /api/v1/artifacts/{name}/versions/{v}      download
    DELETE /api/v1/artifacts/{name}/versions/{v}
    POST   /api/v1/deployments                        (body = resource JSON)
    GET    /api/v1/deployments[/{ns}/{name}]          list / get + status
    DELETE /api/v1/deployments/{ns}/{name}

The JAX package's ``dynamo_tpu/deploy/api_store.py`` on the port's own
HTTP/1.1 server (``llm/http_service.py``; the card's machine has no
aiohttp): the same routes, statuses and JSON bodies, errors as the same
plain-text bodies, uploads up to 1 GiB. One difference: a deployment body
that is JSON but not an object is a 400 here (JAX: a 500).

    python -m dynamo_tpu_torch.deploy.api_store --store host:port \
        --root file:///var/artifacts --port 8082

Reference capability: deploy/dynamo/api-store/ai_dynamo_store/api/
dynamo.py:62-390 (upload/download, versioning, deployment records).
"""

from __future__ import annotations

import asyncio
import hashlib
import json
import re
import time
from typing import Optional

from ..llm.http_service import HttpServer, Request, Response, json_response
from ..runtime.scale.shards import make_store_client
from ..runtime.store_client import StoreClient
from .crd import DEPLOY_PREFIX, Deployment, SpecError, deploy_key, status_key

_NAME_RE = re.compile(r"^[A-Za-z0-9][A-Za-z0-9._-]*$")


class _HttpError(Exception):
    """An error answer: ``status`` with a plain-text body (aiohttp's
    ``web.HTTPException(text=...)`` shape)."""

    def __init__(self, status: int, text: str):
        super().__init__(text)
        self.status = status
        self.text = text


def _answering(handler):
    async def route(req: Request) -> Response:
        try:
            return await handler(req)
        except _HttpError as e:
            return Response(e.status, e.text.encode(),
                            "text/plain; charset=utf-8")
    return route


class ApiStore:
    def __init__(self, root: str, store_host: str = "127.0.0.1",
                 store_port: int = 4222, http_port: int = 0,
                 advertise_host: str = "127.0.0.1"):
        """``root``: a storage URL — a local directory / ``file://`` path
        (PVC analogue) or ``s3://bucket?endpoint=...`` (S3-compatible
        object storage, ref dynamo.py:550-565)."""
        from .object_store import open_object_store

        self.objects = open_object_store(root)
        self.store_host = store_host
        self.store_port = store_port
        self.http_port = http_port
        # host operators/workers use to fetch artifacts — must be reachable
        # from THEIR machines, not just ours
        self.advertise_host = advertise_host
        self.client: Optional[StoreClient] = None
        self._server: Optional[HttpServer] = None
        # version allocation is a read-modify-write on .next_version; two
        # concurrent uploads of the same artifact must not alias one version
        # (one lock for all uploads: bounded, and uploads are rare)
        self._upload_lock = asyncio.Lock()

    # ------------------------------------------------------------------
    def _routes(self):
        v1 = "/api/v1"
        return {(m, v1 + p): _answering(h) for m, p, h in (
            ("POST", "/artifacts/{name}/versions", self._upload),
            ("GET", "/artifacts", self._list_artifacts),
            ("GET", "/artifacts/{name}/versions/{v}", self._download),
            ("DELETE", "/artifacts/{name}/versions/{v}", self._del_art),
            ("POST", "/deployments", self._apply_deployment),
            ("GET", "/deployments", self._list_deployments),
            ("GET", "/deployments/{ns}/{name}", self._get_deployment),
            ("DELETE", "/deployments/{ns}/{name}", self._del_deployment))}

    async def start(self) -> int:
        self.client = await make_store_client(self.store_host,
                                              self.store_port).connect()
        self._server = HttpServer("127.0.0.1", self.http_port,
                                  self._routes(), max_body=1 << 30)
        self.http_port = await self._server.start()
        return self.http_port

    async def stop(self) -> None:
        if self._server is not None:
            await self._server.stop()
        if self.client is not None:
            await self.client.close()
        await self.objects.close()

    # ------------------------------------------------------------------
    @staticmethod
    def _safe(name: str) -> str:
        # strict charset: artifact names become object-store keys and URL
        # path segments on every backend — '?', '#', '%', spaces etc. would
        # change meaning downstream
        if not name or name.startswith(".") or not _NAME_RE.match(name):
            raise _HttpError(400, "invalid name")
        return name

    async def _upload(self, req: Request) -> Response:
        name = self._safe(req.match_info["name"])
        data = req.body
        digest = hashlib.sha256(data).hexdigest()
        async with self._upload_lock:
            return await self._upload_locked(name, data, digest)

    async def _upload_locked(self, name: str, data: bytes,
                             digest: str) -> Response:
        # versions are monotonic even across deletes (a counter object, not
        # max(existing)+1): reusing a deleted version's number would alias
        # different content under one artifact://name/version
        counter_key = f"{name}/.next_version"
        existing = [int(k.rsplit("/", 1)[1])
                    for k in await self.objects.list(f"{name}/")
                    if k.rsplit("/", 1)[1].isdigit()]
        floor = max(existing, default=0)
        raw = await self.objects.get(counter_key)
        if raw is not None:
            try:
                floor = max(floor, int(raw.decode().strip()) - 1)
            except ValueError:
                pass
        version = floor + 1
        # The asyncio lock serializes allocation within ONE api-store
        # process; a shared backend (S3) with multiple replicas has no CAS
        # in the ObjectStore interface, so cross-replica races are detected
        # opportunistically instead: write, re-read, and if another replica
        # overwrote our version slot (digest mismatch) move to the next
        # number. Both racers converge — the overwritten one retries, the
        # surviving one verifies its own digest. Deploy one api-store per
        # bucket to avoid even this window.
        for _ in range(8):
            await self.objects.put(counter_key, str(version + 1).encode())
            await self.objects.put(f"{name}/{version}", data)
            echo = await self.objects.get(f"{name}/{version}")
            if echo is not None \
                    and hashlib.sha256(echo).hexdigest() == digest:
                break
            version += 1
        else:
            raise _HttpError(409, "version allocation kept racing")
        meta = {"version": version, "sha256": digest, "size": len(data),
                "uploaded": time.time()}
        await self.objects.put(f"{name}/{version}.json",
                               json.dumps(meta).encode())
        # register in the store so artifact:// graph refs resolve
        from .artifacts import register

        url = (f"http://{self.advertise_host}:{self.http_port}"
               f"/api/v1/artifacts/{name}/versions/{version}")
        await register(self.client, name, version, url, digest, len(data))
        return json_response({"name": name, **meta}, status=201)

    async def _list_artifacts(self, _req: Request) -> Response:
        pairs = []
        for key in await self.objects.list():
            parts = key.split("/")
            if len(parts) == 2 and parts[1].isdigit():
                pairs.append((parts[0], int(parts[1])))
        # metadata fetches go out concurrently: on the S3 backend each is a
        # network round-trip and a serial loop would be N+1
        raws = await asyncio.gather(
            *(self.objects.get(f"{n}/{v}.json") for n, v in pairs))
        out: dict = {}
        for (name, v), raw in zip(pairs, raws):
            out.setdefault(name, []).append(
                json.loads(raw.decode()) if raw else {"version": v})
        for versions in out.values():
            versions.sort(key=lambda m: m["version"])
        return json_response(
            {"artifacts": {k: out[k] for k in sorted(out)}})

    async def _download(self, req: Request) -> Response:
        name = self._safe(req.match_info["name"])
        v = self._safe(req.match_info["v"])
        data = await self.objects.get(f"{name}/{v}")
        if data is None:
            raise _HttpError(404, "no such artifact version")
        return Response(200, data, "application/octet-stream")

    async def _del_art(self, req: Request) -> Response:
        name = self._safe(req.match_info["name"])
        v = self._safe(req.match_info["v"])
        if not v.isdigit():
            raise _HttpError(404, "no such artifact version")
        if not await self.objects.delete(f"{name}/{v}"):
            raise _HttpError(404, "no such artifact version")
        await self.objects.delete(f"{name}/{v}.json")
        # unregister, or artifact://name (latest) would resolve to a
        # version whose content is gone
        from .artifacts import descriptor_key

        await self.client.delete(descriptor_key(name, int(v)))
        return json_response({"deleted": f"{name}/{v}"})

    # ------------------------------------------------------------------
    async def _apply_deployment(self, req: Request) -> Response:
        try:
            body = req.json()
            if not isinstance(body, dict):
                raise SpecError("a deployment resource is a JSON object")
            dep = Deployment.from_dict(body)
        except (SpecError, ValueError) as e:
            raise _HttpError(400, str(e))
        from .operator import apply

        await apply(self.client, dep)
        return json_response({"applied": dep.key(),
                              "generation": dep.generation}, status=201)

    async def _list_deployments(self, _req: Request) -> Response:
        items = []
        for key, raw in await self.client.get_prefix(DEPLOY_PREFIX):
            try:
                items.append(Deployment.from_bytes(raw).to_dict())
            except (SpecError, ValueError):
                continue
        return json_response({"deployments": items})

    async def _get_deployment(self, req: Request) -> Response:
        ns, name = req.match_info["ns"], req.match_info["name"]
        raw = await self.client.get(deploy_key(ns, name))
        if raw is None:
            raise _HttpError(404, "no such deployment")
        out = Deployment.from_bytes(raw).to_dict()
        sraw = await self.client.get(status_key(ns, name))
        if sraw is not None:
            out["status"] = json.loads(sraw.decode())
        return json_response(out)

    async def _del_deployment(self, req: Request) -> Response:
        ns, name = req.match_info["ns"], req.match_info["name"]
        if not await self.client.delete(deploy_key(ns, name)):
            raise _HttpError(404, "no such deployment")
        return json_response({"deleted": f"{ns}/{name}"})


def main(argv=None) -> None:
    import argparse

    ap = argparse.ArgumentParser("dynamo-api-store")
    ap.add_argument("--root", default="./artifacts",
                    help="artifact storage: a directory / file:// path, or "
                         "s3://bucket?endpoint=http://host:port")
    ap.add_argument("--store", default="127.0.0.1:4222")
    ap.add_argument("--port", type=int, default=8082)
    ap.add_argument("--advertise-host", default="127.0.0.1")
    args = ap.parse_args(argv)
    host, port = args.store.split(":")

    async def run():
        store = ApiStore(args.root, host, int(port), args.port,
                         advertise_host=args.advertise_host)
        p = await store.start()
        print(f"api-store on 127.0.0.1:{p}", flush=True)
        while True:
            await asyncio.sleep(3600)

    asyncio.run(run())


if __name__ == "__main__":
    main()
