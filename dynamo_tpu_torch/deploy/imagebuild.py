"""Image-build orchestration for graph deployments.

Packages a service-graph module (or package directory) into an OCI build
context — a tar holding a rendered Dockerfile plus the graph sources under
``app/`` — and optionally drives an external builder command over it.
The runtime image itself ships the framework; the graph image layers the
user's code on top, exactly the split the reference operator's image-build
pipeline produces for its deployments.

Reference capability: the operator-driven image build of
deploy/dynamo/operator (builds artifact bundles into runnable images);
scoped here to deterministic context rendering + builder dispatch, since
this stack assumes a docker/buildkit binary rather than an in-cluster
builder.

The JAX package's ``dynamo_tpu/deploy/imagebuild.py`` on the port's base
image, ``dynamo-tpu-torch:latest`` (PyTorch for CUDA and this package).
"""

from __future__ import annotations

import io
import os
import shlex
import subprocess
import tarfile
import time
from typing import Optional

BASE_IMAGE = "dynamo-tpu-torch:latest"
DOCKERFILE_TEMPLATE = """\
FROM {base}
# graph sources layered over the framework runtime image
COPY app/ /app/
ENV PYTHONPATH=/app
# the orchestrator/operator overrides the entry per service; this default
# just proves the image is runnable
CMD ["python", "-c", "import sys; sys.path.insert(0, '/app'); \
print('dynamo-tpu-torch graph image ready')"]
"""


def render_dockerfile(base_image: str) -> str:
    return DOCKERFILE_TEMPLATE.format(base=base_image)


def build_context(path: str, base_image: str = BASE_IMAGE,
                  out_path: Optional[str] = None) -> str:
    """Write an OCI build context tar for the graph at ``path`` (a single
    module file or a package directory). Returns the tar path."""
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    name = os.path.splitext(os.path.basename(path.rstrip("/")))[0]
    out = out_path or f"{name}-context.tar"
    with tarfile.open(out, "w") as tar:
        df = render_dockerfile(base_image).encode()
        info = tarfile.TarInfo("Dockerfile")
        info.size = len(df)
        info.mtime = int(time.time())
        tar.addfile(info, io.BytesIO(df))
        if os.path.isdir(path):
            tar.add(path, arcname=f"app/{os.path.basename(path.rstrip('/'))}",
                    filter=_clean)
        else:
            tar.add(path, arcname=f"app/{os.path.basename(path)}",
                    filter=_clean)
    return out


def _clean(info: tarfile.TarInfo) -> Optional[tarfile.TarInfo]:
    base = os.path.basename(info.name)
    if base == "__pycache__" or base.endswith(".pyc"):
        return None
    info.uid = info.gid = 0
    info.uname = info.gname = ""
    return info


def run_builder(builder: str, context_tar: str, tag: str) -> int:
    """Run an external image builder over the context: the builder command
    gets ``-t <tag> -`` appended and the context streamed on stdin (the
    `docker build` contract; buildkit frontends accept the same shape)."""
    cmd = shlex.split(builder) + ["-t", tag, "-"]
    with open(context_tar, "rb") as f:
        proc = subprocess.run(cmd, stdin=f)
    return proc.returncode
