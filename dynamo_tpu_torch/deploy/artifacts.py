"""Artifact-based graph resolution: ``artifact://name/version#module:Class``.

The api-store registers every uploaded artifact version in the dynstore
(descriptor with content URL + sha256). A deployment may then name its
graph by artifact instead of an import path; the operator (and worker
children via ``DYNAMO_ARTIFACT_PATH``) download the bundle, verify its
digest, extract it into a content-addressed cache dir and import the entry
class from there.

The JAX package's ``dynamo_tpu/deploy/artifacts.py``: the same refs,
descriptor keys and JSON, so one store serves both packages. The bundle is
fetched with ``urllib`` on a worker thread (the card's machine has no
aiohttp), and the cache is ``~/.cache/dynamo_tpu_torch/artifacts`` unless
``DYNAMO_ARTIFACT_CACHE`` names another directory.

Reference capability: the api-store → operator artifact flow
(deploy/dynamo/api-store upload/download + dynamonimrequest_controller
image/artifact resolution), re-based on our store + HTTP planes.
"""

from __future__ import annotations

import asyncio
import hashlib
import io
import json
import os
import tarfile
from typing import Optional, Tuple

ARTIFACT_SCHEME = "artifact://"
ARTIFACT_PREFIX = "deploy/artifacts/"          # store key prefix
CACHE_DIR = os.environ.get("DYNAMO_ARTIFACT_CACHE") or os.path.expanduser(
    "~/.cache/dynamo_tpu_torch/artifacts")


class ArtifactError(RuntimeError):
    pass


def is_artifact_ref(graph: str) -> bool:
    return graph.startswith(ARTIFACT_SCHEME)


def parse_ref(ref: str) -> Tuple[str, Optional[int], str]:
    """``artifact://name/version#module:Class`` -> (name, version|None,
    class_spec). Version omitted or 'latest' means newest."""
    if not is_artifact_ref(ref):
        raise ArtifactError(f"not an artifact ref: {ref!r}")
    rest = ref[len(ARTIFACT_SCHEME):]
    if "#" not in rest:
        raise ArtifactError(
            "artifact ref needs '#module:Class' entry point")
    locator, class_spec = rest.split("#", 1)
    if ":" not in class_spec:
        raise ArtifactError("entry point must be 'module:Class'")
    parts = locator.split("/")
    name = parts[0]
    if not name:
        raise ArtifactError("artifact name is empty")
    version: Optional[int] = None
    if len(parts) > 1 and parts[1] not in ("", "latest"):
        try:
            version = int(parts[1])
        except ValueError:
            raise ArtifactError(f"bad artifact version {parts[1]!r}")
    return name, version, class_spec


def descriptor_key(name: str, version: int) -> str:
    return f"{ARTIFACT_PREFIX}{name}/{version:08d}"


async def register(client, name: str, version: int, url: str,
                   sha256: str, size: int) -> None:
    """Called by the api-store after an upload: make the version
    discoverable through the store."""
    await client.put(descriptor_key(name, version), json.dumps(
        {"name": name, "version": version, "url": url,
         "sha256": sha256, "size": size}).encode())


async def resolve(client, ref: str) -> Tuple[str, str]:
    """Materialize an artifact ref. Returns (extract_dir, class_spec).

    The bundle may be a tarball (extracted as-is) or a single .py file
    (written as module.py per the entry module name)."""
    name, version, class_spec = parse_ref(ref)
    if version is None:
        items = await client.get_prefix(f"{ARTIFACT_PREFIX}{name}/")
        if not items:
            raise ArtifactError(f"artifact {name!r} not registered")
        raw = sorted(items)[-1][1]
    else:
        raw = await client.get(descriptor_key(name, version))
        if raw is None:
            raise ArtifactError(f"artifact {name!r} v{version} not registered")
    desc = json.loads(raw.decode())
    target = os.path.join(CACHE_DIR, name, str(desc["version"]))
    stamp = os.path.join(target, ".sha256")
    if os.path.exists(stamp):
        with open(stamp) as f:
            if f.read().strip() == desc["sha256"]:
                return target, class_spec      # cache hit

    data = await _fetch(desc["url"])
    digest = hashlib.sha256(data).hexdigest()[:len(desc["sha256"])]
    if digest != desc["sha256"]:
        raise ArtifactError(
            f"artifact {name!r} digest mismatch: {digest} != {desc['sha256']}")
    # clear any stale extraction (a differing bundle once lived here):
    # leftovers would stay importable next to the new content
    if os.path.isdir(target):
        import shutil

        shutil.rmtree(target)
    os.makedirs(target, exist_ok=True)
    _extract(data, target, class_spec)
    with open(stamp, "w") as f:
        f.write(desc["sha256"])
    return target, class_spec


async def _fetch(url: str) -> bytes:
    from .object_store import http_request

    try:
        status, body = await asyncio.to_thread(http_request, "GET", url)
    except OSError as e:
        raise ArtifactError(f"artifact fetch {url}: {e}") from e
    if status != 200:
        raise ArtifactError(f"artifact fetch {url}: HTTP {status}")
    return body


def _extract(data: bytes, target: str, class_spec: str) -> None:
    buf = io.BytesIO(data)
    try:
        with tarfile.open(fileobj=buf) as tf:
            for m in tf.getmembers():
                # no absolute paths / parent escapes out of the bundle
                if m.name.startswith(("/", "..")) or ".." in m.name.split("/"):
                    raise ArtifactError(f"unsafe path in bundle: {m.name}")
            # 'data' filter additionally blocks symlink/device escapes the
            # name check above cannot see
            tf.extractall(target, filter="data")
        return
    except tarfile.ReadError:
        pass
    # single-file bundle: write as the entry module
    mod = class_spec.split(":", 1)[0]
    if "." in mod:
        raise ArtifactError(
            "single-file bundles need a top-level entry module")
    with open(os.path.join(target, f"{mod}.py"), "wb") as f:
        f.write(data)


def load_entry(extract_dir: str, class_spec: str):
    """Import the entry class from an extracted artifact dir.

    sys.modules is version-aware: if the entry's top-level package is
    already imported from a DIFFERENT directory (an older artifact version,
    or another deployment's bundle reusing the name), those modules are
    purged first so this bundle's code actually loads. The extract dir is
    appended (not prepended) to sys.path so bundles cannot shadow framework
    imports."""
    import importlib
    import sys

    top = class_spec.split(":", 1)[0].split(".", 1)[0]
    existing = sys.modules.get(top)
    if existing is not None:
        mod_file = getattr(existing, "__file__", "") or ""
        if not mod_file.startswith(extract_dir + os.sep):
            for k in [k for k in sys.modules
                      if k == top or k.startswith(top + ".")]:
                del sys.modules[k]
    # older versions of the SAME artifact must leave sys.path, or the purged
    # module would simply re-import from them
    family = os.path.dirname(extract_dir) + os.sep
    sys.path[:] = [p for p in sys.path
                   if not (p.startswith(family) and p != extract_dir)]
    if extract_dir not in sys.path:
        sys.path.append(extract_dir)
    importlib.invalidate_caches()
    from ..sdk.serve_child import load_class

    return load_class(class_spec)
