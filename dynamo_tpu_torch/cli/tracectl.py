"""tracectl: fetch a request's span timeline from the HTTP frontend and
pretty-print it as an ASCII waterfall (or save Chrome trace-event JSON).

    python -m dynamo_tpu_torch.cli.tracectl <request_id> \
        [--url http://127.0.0.1:8080] [--chrome out.json] [--json]
    python -m dynamo_tpu_torch.cli.tracectl --list [--url ...]
    python -m dynamo_tpu_torch.cli.tracectl decisions [--limit N] [--json]
    python -m dynamo_tpu_torch.cli.tracectl --bundle incident.json \
        [--chrome out.json] [--json]

The request id is the ``x-request-id`` response header every frontend
response carries. ``--chrome`` writes Perfetto-loadable trace-event JSON
(open at https://ui.perfetto.dev or chrome://tracing).

``decisions`` prints the KV router's decision audit
(``GET /v1/router/decisions``): one line per routed request with the
chosen worker and each candidate's overlap/cache_usage/load score terms.

``--bundle FILE`` consumes an exported incident bundle
(``ctl incident export``) entirely OFFLINE — no frontend needed: the
retro-assembled trace renders as the usual waterfall, ``--chrome`` emits
Perfetto JSON from it, and the per-process ring/stall summary prints
alongside.

The JAX package's ``tracectl``: the same waterfall, decision lines and
Chrome export from either package's frontend or bundle.
"""

from __future__ import annotations

import argparse
import json
import sys
import urllib.error
import urllib.request
from typing import Any, Dict, List

from ..utils.dynconfig import EnvDefaultsParser

BAR_WIDTH = 40


def _fetch_json(url: str) -> Any:
    with urllib.request.urlopen(url, timeout=10) as resp:
        return json.loads(resp.read().decode())


def _fmt_dur(seconds: float) -> str:
    if seconds >= 1.0:
        return f"{seconds:8.3f}s "
    if seconds >= 1e-3:
        return f"{seconds * 1e3:8.2f}ms"
    return f"{seconds * 1e6:8.1f}us"


def render_timeline(spans: List[Dict[str, Any]], width: int = BAR_WIDTH
                    ) -> str:
    """ASCII waterfall of one trace's spans (pure function; unit-tested).

    Spans are drawn in start order, indented by parent depth, with a
    proportional ``[###]`` bar positioned on the trace's wall-clock extent
    and per-span component/duration/status columns."""
    if not spans:
        return "(no spans)"
    spans = sorted(spans, key=lambda s: (s.get("start") or 0.0,
                                         s.get("end") or 0.0))
    t0 = min(s.get("start") or 0.0 for s in spans)
    t1 = max(s.get("end") or 0.0 for s in spans)
    total = max(t1 - t0, 1e-9)
    by_id = {s.get("span_id"): s for s in spans}

    def depth(s, guard=0) -> int:
        p = s.get("parent_id")
        if p is None or p not in by_id or guard > 16:
            return 0
        return 1 + depth(by_id[p], guard + 1)

    name_w = max(len("  " * depth(s) + s.get("name", "?")) for s in spans)
    name_w = min(max(name_w, 12), 48)
    comp_w = max((len(f"{s.get('component', '?')}:{s.get('pid', 0)}")
                  for s in spans), default=8)
    lines = [f"trace {spans[0].get('trace_id', '?')} — {len(spans)} spans, "
             f"{_fmt_dur(total).strip()} total"]
    for s in spans:
        start = (s.get("start") or 0.0) - t0
        dur = max(0.0, (s.get("end") or 0.0) - (s.get("start") or 0.0))
        lo = int(round(start / total * width))
        hi = int(round((start + dur) / total * width))
        hi = min(max(hi, lo + 1), width)
        bar = " " * lo + "#" * (hi - lo) + " " * (width - hi)
        label = ("  " * depth(s) + s.get("name", "?"))[:name_w]
        comp = f"{s.get('component', '?')}:{s.get('pid', 0)}"
        err = "  !ERROR" if s.get("status") not in (None, "ok") else ""
        lines.append(f"{label:<{name_w}} |{bar}| {_fmt_dur(dur)} "
                     f"{comp:<{comp_w}}{err}")
    return "\n".join(lines)


def render_decisions(decisions: List[Dict[str, Any]]) -> str:
    """One line per audited routing decision (pure function; unit-tested):
    chosen worker + the per-candidate ``logit=2*ovl-usage-load`` terms."""
    if not decisions:
        return "(no routing decisions recorded)"
    lines = [f"{len(decisions)} routing decisions (oldest first)"]
    for d in decisions:
        wid = d.get("worker_id")
        chosen = f"{wid:x}" if wid is not None else "WAITED"
        retries = f" retries={d['retries']}" if d.get("retries") else ""
        salt = f" salt={d['salt']:x}" if d.get("salt") else ""
        lines.append(
            f"#{d.get('seq', '?')} isl={d.get('isl_tokens', '?')}tok/"
            f"{d.get('isl_blocks', '?')}blk{salt} -> {chosen} "
            f"(ovl={d.get('overlap_blocks', 0)}blk){retries}")
        for c in d.get("candidates", []):
            mark = "*" if c.get("worker_id") == wid else " "
            sat = "  SATURATED" if c.get("saturated") else ""
            lines.append(
                f"   {mark} {c['worker_id']:x}: logit={c['logit']:+.4f} "
                f"(ovl={c['overlap_norm']:.2f} usage={c['cache_usage']:.2f}"
                f" load={c['load']:.2f}){sat}")
    return "\n".join(lines)


def parse_args(argv=None) -> argparse.Namespace:
    p = EnvDefaultsParser(prog="dynamo-tracectl")
    p.add_argument("request_id", nargs="?", default=None,
                   help="trace/request id (x-request-id response header), "
                        "or the literal 'decisions' for the router audit")
    p.add_argument("--limit", type=int, default=0,
                   help="decisions: max entries to fetch (0 = ring size)")
    p.add_argument("--url", default="http://127.0.0.1:8080",
                   help="frontend base URL")
    p.add_argument("--list", action="store_true",
                   help="list recent trace ids instead")
    p.add_argument("--json", action="store_true",
                   help="dump the raw span JSON instead of the waterfall")
    p.add_argument("--chrome", default=None, metavar="FILE",
                   help="write Chrome trace-event JSON to FILE")
    p.add_argument("--bundle", default=None, metavar="FILE",
                   help="read an exported incident bundle instead of a "
                        "frontend (offline; see `ctl incident export`)")
    return p.parse_args(argv)


def run_bundle(args) -> int:
    """Offline incident-bundle mode: summary + trace waterfall (or
    --chrome / --json) from the exported file alone."""
    from ..obs.incidents import bundle_summary
    from ..utils.tracing import Span, merge_spans, to_chrome_trace

    with open(args.bundle) as f:
        bundle = json.load(f)
    if args.json:
        print(json.dumps(bundle["trace"], indent=2))
        return 0
    if args.chrome:
        # the trigger's retro-assembled trace plus EVERY process's ring
        # spans: a manual/SIGUSR2 capture has no trigger trace, but its
        # rings still hold the last window of activity per process
        groups = [[Span.from_dict(d) for d in bundle.get("trace", [])]]
        for snap in bundle.get("processes", {}).values():
            ring = snap.get("rings", {}).get("spans", {}).get("items", [])
            groups.append([Span.from_dict(d) for d in ring])
        chrome = to_chrome_trace(merge_spans(*groups))
        with open(args.chrome, "w") as f:
            json.dump(chrome, f)
        print(f"wrote {len(chrome.get('traceEvents', []))} events to "
              f"{args.chrome} (load in https://ui.perfetto.dev)")
        return 0
    for line in bundle_summary(bundle):
        print(line)
    if bundle.get("trace"):
        print()
        print(render_timeline(bundle["trace"]))
    return 0


def run(args) -> int:
    base = args.url.rstrip("/")
    try:
        if args.bundle:
            return run_bundle(args)
        if args.list:
            data = _fetch_json(f"{base}/v1/traces")
            for tid in data.get("traces", []):
                print(tid)
            return 0
        if not args.request_id:
            print("error: request_id required (or --list)", file=sys.stderr)
            return 2
        if args.request_id == "decisions":
            data = _fetch_json(
                f"{base}/v1/router/decisions?limit={args.limit}")
            if args.json:
                print(json.dumps(data, indent=2))
            else:
                print(render_decisions(data.get("decisions", [])))
            return 0
        if args.chrome:
            chrome = _fetch_json(
                f"{base}/v1/traces/{args.request_id}?format=chrome")
            with open(args.chrome, "w") as f:
                json.dump(chrome, f)
            print(f"wrote {len(chrome.get('traceEvents', []))} events to "
                  f"{args.chrome} (load in https://ui.perfetto.dev)")
            return 0
        data = _fetch_json(f"{base}/v1/traces/{args.request_id}")
        if args.json:
            print(json.dumps(data, indent=2))
        else:
            print(render_timeline(data.get("spans", [])))
        return 0
    except urllib.error.HTTPError as e:
        print(f"error: {e.code} {e.reason} for {e.url}", file=sys.stderr)
        return 1
    except (OSError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1


def main() -> None:
    raise SystemExit(run(parse_args()))


if __name__ == "__main__":
    main()
