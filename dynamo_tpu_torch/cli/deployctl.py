"""deployctl — kubectl-style CLI for Deployment resources.

    python -m dynamo_tpu_torch.cli.deployctl apply -f dep.yaml [--store h:p]
    python -m dynamo_tpu_torch.cli.deployctl list
    python -m dynamo_tpu_torch.cli.deployctl status <namespace>/<name>
    python -m dynamo_tpu_torch.cli.deployctl delete <namespace>/<name>
    python -m dynamo_tpu_torch.cli.deployctl render -f dep.yaml [--image IMG]
    python -m dynamo_tpu_torch.cli.deployctl push <name> <bundle> [--api URL]
    python -m dynamo_tpu_torch.cli.deployctl build <path> [--builder CMD]
    python -m dynamo_tpu_torch.cli.deployctl operator \
        [--platform cuda|cpu] [--total-chips N] [--resync S]

``-f`` reads a resource as JSON (a ``.json`` file, or one whose text starts
with ``{``) or in the YAML subset ``utils/yamlsubset.py`` reads. ``render``
emits Kubernetes manifests for the resource (an ``artifact://`` graph is
resolved through the store); ``operator`` runs the local reconciling
operator in the foreground, granting cards through ``CUDA_VISIBLE_DEVICES``
(``--platform cuda``, the default: it fails when NVML sees no card) or
running every worker on the CPU (``--platform cpu``). SIGTERM or Ctrl-C
stops the operator: every worker drains and exits, then the operator exits
0.

The JAX package's ``dynamo_tpu/cli/deployctl.py`` without PyYAML or aiohttp
(``push`` is a ``urllib`` request), with the operator's ``--platform``
choices and ``--total-chips``, and SIGTERM handling (the JAX operator dies
on SIGTERM and leaves its workers running).

Reference capability: the dynamo deploy/deployment CLI group
(deploy/dynamo/sdk/cli/deployment.py) + kubectl against the operator CRDs.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import signal
import sys

from ..deploy.crd import DEPLOY_PREFIX, Deployment
from ..runtime.scale.shards import make_store_client


def _load_resource(path: str) -> Deployment:
    from ..utils import yamlsubset

    with open(path, encoding="utf-8") as f:
        text = f.read()
    if path.endswith(".json") or text.lstrip().startswith("{"):
        return Deployment.from_dict(json.loads(text))
    try:
        return Deployment.from_dict(yamlsubset.loads(text))
    except yamlsubset.YamlSubsetError as e:
        raise SystemExit(f"{path}: {e}")


async def _with_client(store: str, fn):
    host, port = store.split(":")
    client = await make_store_client(host, int(port)).connect()
    try:
        return await fn(client)
    finally:
        await client.close()


# NVML's device count, run in a child process: NVML maps libcuda into the
# process that calls it, and the operator maps nothing of the card's
_NVML_COUNT = """
import ctypes
try:
    nvml = ctypes.CDLL("libnvidia-ml.so.1")
except OSError:
    raise SystemExit(print(0))
count = ctypes.c_uint(0)
if nvml.nvmlInit_v2() != 0:
    raise SystemExit(print(0))
ok = nvml.nvmlDeviceGetCount_v2(ctypes.byref(count)) == 0
nvml.nvmlShutdown()
print(count.value if ok else 0)
"""


def visible_cards() -> int:
    """The CUDA cards NVML sees (0 without NVML), counted in a child
    process, so the operator's own process never loads NVIDIA's
    libraries."""
    import subprocess

    r = subprocess.run([sys.executable, "-c", _NVML_COUNT],
                       capture_output=True, text=True, timeout=60)
    return int(r.stdout.strip() or 0)


async def _services(store: str, dep: Deployment):
    """The graph's services as the operator resolves them (an artifact ref
    through the store)."""
    from ..deploy.artifacts import is_artifact_ref, load_entry, resolve
    from ..deploy.operator import Operator

    if not is_artifact_ref(dep.spec.graph):
        return Operator._resolve_graph(dep)

    async def do(client):
        return Operator._collect_services(
            load_entry(*await resolve(client, dep.spec.graph)))

    return await _with_client(store, do)


def _operator_runner(args):
    from ..deploy.operator import LocalRunner

    total = args.total_chips
    if args.platform == "cuda":
        cards = visible_cards()
        if cards == 0:
            raise SystemExit("operator --platform cuda: no CUDA card is "
                             "visible (NVML); --platform cpu runs every "
                             "worker on the CPU")
        if total is None:
            total = cards
        elif total > cards:
            raise SystemExit(f"operator --total-chips {total}: NVML sees "
                             f"{cards} card(s)")
    return LocalRunner(args.store, args.platform,
                       total_chips=total if total is not None else 0)


async def _run_operator(args, runner) -> None:
    from ..deploy.operator import Operator

    host, port = args.store.split(":")
    # SIGTERM leaves through the same path as Ctrl-C: close() drains every
    # worker before the process exits
    asyncio.get_running_loop().add_signal_handler(
        signal.SIGTERM, asyncio.current_task().cancel)
    op = Operator(host, int(port), runner=runner,
                  resync_interval=args.resync)
    await op.start()
    print(f"operator watching {DEPLOY_PREFIX} on {args.store} "
          f"(platform {runner.platform}, {runner.allocator.total} cards)",
          flush=True)
    try:
        await asyncio.Event().wait()
    finally:
        await op.close()
        print("operator stopped", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser("deployctl")
    ap.add_argument("--store", default="127.0.0.1:4222")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("apply")
    p.add_argument("-f", "--file", required=True)
    sub.add_parser("list")
    p = sub.add_parser("status")
    p.add_argument("target")
    p = sub.add_parser("delete")
    p.add_argument("target")
    p = sub.add_parser("render")
    p.add_argument("-f", "--file", required=True)
    p.add_argument("--image", default="dynamo-tpu-torch:latest")
    p.add_argument("--no-store", action="store_true")
    p = sub.add_parser("push")
    p.add_argument("name")
    p.add_argument("bundle", help="tarball or single-module .py file")
    p.add_argument("--api", default="http://127.0.0.1:8082",
                   help="api-store base URL")
    p = sub.add_parser("build")
    p.add_argument("path", help="graph module .py or package directory")
    p.add_argument("--tag", default="dynamo-tpu-torch-graph:latest")
    p.add_argument("--base", default="dynamo-tpu-torch:latest")
    p.add_argument("--out", default=None,
                   help="write the OCI build context tar here "
                        "(default <name>-context.tar)")
    p.add_argument("--builder", default=None,
                   help="image builder command to run on the context, "
                        "e.g. 'docker build' or 'buildctl ...'")
    p = sub.add_parser("operator")
    p.add_argument("--resync", type=float, default=5.0)
    p.add_argument("--platform", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--total-chips", type=int, default=None,
                   help="cards the operator may grant (default: every "
                        "card NVML sees; none on --platform cpu)")
    args = ap.parse_args(argv)

    if args.cmd == "apply":
        dep = _load_resource(args.file)

        async def do(client):
            from ..deploy.operator import apply

            await apply(client, dep)
            print(f"applied {dep.key()} (generation {dep.generation})")

        asyncio.run(_with_client(args.store, do))
        return 0

    if args.cmd == "list":
        async def do(client):
            for key, raw in await client.get_prefix(DEPLOY_PREFIX):
                try:
                    d = Deployment.from_bytes(raw)
                except ValueError:
                    continue
                print(f"{d.key()}  graph={d.spec.graph} "
                      f"generation={d.generation}")

        asyncio.run(_with_client(args.store, do))
        return 0

    if args.cmd in ("status", "delete"):
        ns, _, name = args.target.partition("/")
        if not name:
            ns, name = "default", ns

        async def do(client):
            from ..deploy.operator import delete, get_status

            if args.cmd == "delete":
                ok = await delete(client, ns, name)
                print("deleted" if ok else "not found")
                return 0 if ok else 1
            st = await get_status(client, ns, name)
            if st is None:
                print("no status recorded")
                return 1
            print(json.dumps(st.to_dict(), indent=2))
            return 0

        return asyncio.run(_with_client(args.store, do)) or 0

    if args.cmd == "push":
        from ..deploy.object_store import http_request

        with open(args.bundle, "rb") as f:
            data = f.read()
        status, raw = http_request(
            "POST", f"{args.api}/api/v1/artifacts/{args.name}/versions",
            data)
        if status != 201:
            # error bodies may be plain text (a 400's "invalid name")
            print(f"push failed ({status}): {raw.decode(errors='replace')}")
            return 1
        body = json.loads(raw)
        print(f"pushed {args.name} v{body['version']} "
              f"({body['size']} bytes, sha256 {body['sha256'][:12]}) "
              f"-> deploy with graph: "
              f"\"artifact://{args.name}#<module>:<Class>\"")
        return 0

    if args.cmd == "render":
        dep = _load_resource(args.file)
        from ..deploy.manifests import render_manifests, to_yaml

        services = asyncio.run(_services(args.store, dep))
        print(to_yaml(render_manifests(
            dep, services, image=args.image,
            include_store=not args.no_store)))
        return 0

    if args.cmd == "build":
        from ..deploy.imagebuild import build_context, run_builder

        ctx = build_context(args.path, base_image=args.base,
                            out_path=args.out)
        print(f"build context: {ctx} (Dockerfile + graph bundle)")
        if args.builder:
            rc = run_builder(args.builder, ctx, args.tag)
            print(f"builder exited {rc}")
            return rc
        print(f"no --builder given; build with e.g.\n"
              f"  docker build -t {args.tag} - < {ctx}")
        return 0

    if args.cmd == "operator":
        from ..utils.logging_ext import init_logging

        init_logging()
        runner = _operator_runner(args)
        try:
            asyncio.run(_run_operator(args, runner))
        except (KeyboardInterrupt, asyncio.CancelledError):
            pass
        return 0
    return 2


if __name__ == "__main__":
    sys.exit(main())
