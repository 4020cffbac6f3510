"""`serve`: run a @service graph as local processes.

    python -m dynamo_tpu_torch.cli.serve \
        dynamo_tpu_torch.examples.llm_graphs:AggRouterGraph \
        [--config examples/configs/agg_router.yaml] [--store host:port] \
        [--platform cuda|cpu] [--total-chips 4]

``--config`` is a YAML file in the block-mapping subset
``utils/yamlsubset.py`` reads (the repo's ``examples/configs`` are), or
JSON (a ``.json`` file, or one whose text starts with ``{``): one section
per service class. ``--platform cuda`` (the default) grants a service that
asks for cards its cards through ``CUDA_VISIBLE_DEVICES`` and fails when
the graph asks for more than ``--total-chips``; there is no fallback to the
CPU, which ``--platform cpu`` asks for. SIGTERM or Ctrl-C stops the graph:
every child drains and exits, then the store.

Reference capability: `dynamo serve` (deploy/dynamo/sdk/cli/serve.py +
serving.py local orchestration).
"""

from __future__ import annotations

import json
import signal
import threading

from ..sdk.allocator import AllocationError
from ..sdk.serve import LocalServe
from ..utils import yamlsubset
from ..utils.dynconfig import EnvDefaultsParser


def load_config(path: str) -> dict:
    with open(path, encoding="utf-8") as f:
        text = f.read()
    if path.endswith(".json") or text.lstrip().startswith("{"):
        return json.loads(text)
    return yamlsubset.loads(text)


def main(argv=None) -> None:
    p = EnvDefaultsParser(prog="dynamo-serve")
    p.add_argument("entry", help="pkg.module:ServiceClass (graph entry)")
    p.add_argument("--config", default=None,
                   help="per-service config (YAML subset or JSON)")
    p.add_argument("--store", default=None,
                   help="existing dynstore host:port (default: spawn one)")
    p.add_argument("--platform", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--total-chips", type=int, default=4,
                   help="cards the graph may be granted")
    args = p.parse_args(argv)

    from ..utils.logging_ext import init_logging
    init_logging()
    try:
        cfg = load_config(args.config) if args.config else {}
    except yamlsubset.YamlSubsetError as e:
        raise SystemExit(f"{args.config}: {e}")
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *a: stop.set())
    serve = LocalServe(args.entry, config=cfg, store=args.store,
                       platform=args.platform, total_chips=args.total_chips)
    try:
        serve.start()
    except AllocationError as e:
        raise SystemExit(f"serve {args.entry}: {e}")
    print(f"serving {args.entry} (store {serve.store}); ctrl-c to stop",
          flush=True)
    try:
        while not stop.wait(0.5):
            pass
    except KeyboardInterrupt:
        pass
    finally:
        serve.stop()
    print("serve stopped", flush=True)


if __name__ == "__main__":
    main()
