"""The port's HTTP service against the JAX package's aiohttp service.

One request script goes to the JAX ``HttpService`` and to the port's, each
serving its own package's echo engine (``echo_core``), and is driven by a
standard-library client (``http.client`` and raw sockets: the card's
machine has no ``aiohttp``). Compared, with ids and clocks masked:

- statuses, bodies and the ``Retry-After`` / ``x-request-id`` headers of
  every route (all 11), errors included;
- the ``/metrics`` sample lines after the script, timing values masked;
- the ``/v1/traces`` span names and parents, and ``?format=chrome``;
- ``/v1/flows``, and the 404s of the incidents and router routes without
  a store or router;
- admission 429s, priority-header 400s and brownout sheds and caps, as in
  ``tests/test_overload.py``;
- HTTP/1.1 behaviour: kept-alive connections, pipelined requests, chunked
  request bodies, ``Connection: close``, query strings, and a client that
  hangs up mid-stream (499).
"""

from __future__ import annotations

import asyncio
import http.client
import importlib
import json
import re
import socket
import threading
import time
from typing import Any, Dict, List, Optional

import pytest

PKGS = ("jax", "torch")
_ROOT = {"jax": "dynamo_tpu", "torch": "dynamo_tpu_torch"}


def _mod(pkg: str, name: str):
    return importlib.import_module(f"{_ROOT[pkg]}.{name}")


class Served:
    """One package's HttpService with echo_core, on a loop thread."""

    def __init__(self, pkg: str, **svc_kw):
        hs = _mod(pkg, "llm.http_service")
        card = _mod(pkg, "llm.model_card").ModelDeploymentCard.synthetic(
            "echo")
        pipe = _mod(pkg, "llm.pipeline")
        manager = hs.ModelManager()
        manager.add(hs.ServedModel(
            card, pipe.build_chat_engine(card, "echo_core"),
            pipe.build_completion_engine(card, "echo_core")))
        self.loop = asyncio.new_event_loop()
        self.svc = hs.HttpService(manager, host="127.0.0.1", port=0,
                                  **svc_kw)
        self.port = self.loop.run_until_complete(self.svc.start())
        self.thread = threading.Thread(target=self.loop.run_forever,
                                       daemon=True)
        self.thread.start()

    def close(self) -> None:
        asyncio.run_coroutine_threadsafe(self.svc.stop(),
                                         self.loop).result(30)
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(timeout=30)
        assert not self.thread.is_alive()
        self.loop.close()


def _fresh_planes(mp: pytest.MonkeyPatch) -> None:
    """Fresh process stage metrics and tracers in both packages."""
    for pkg in PKGS:
        prom = _mod(pkg, "utils.prometheus")
        mp.setattr(prom, "_stage", prom.StageMetrics())
        mp.setattr(_mod(pkg, "utils.tracing"), "_tracer", None)
    mp.setenv("DYN_TOKEN_ECHO_DELAY_MS", "0")


@pytest.fixture
def pair(monkeypatch):
    _fresh_planes(monkeypatch)
    served = {}
    try:
        for pkg in PKGS:
            served[pkg] = Served(pkg)
        yield served
    finally:
        for s in served.values():
            s.close()


def _request(port: int, method: str, path: str, body: Any = None,
             headers: Optional[Dict[str, str]] = None, raw: bytes = None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        data = raw if raw is not None else (
            None if body is None else json.dumps(body).encode())
        hdrs = {"Content-Type": "application/json", **(headers or {})}
        conn.request(method, path, data, hdrs)
        r = conn.getresponse()
        return r.status, {k.lower(): v for k, v in r.getheaders()}, r.read()
    finally:
        conn.close()


# ---------------------------------------------------------------------------
# masking
# ---------------------------------------------------------------------------
def _mask(obj):
    if isinstance(obj, dict):
        out = {}
        for k, v in obj.items():
            if k in ("id", "created") or k == "owned_by":
                out[k] = f"<{k}>"
            else:
                out[k] = _mask(v)
        return out
    if isinstance(obj, list):
        return [_mask(v) for v in obj]
    if isinstance(obj, str):
        return re.sub(r"[0-9a-f]{32}", "<rid>", obj)
    return obj


def _body(headers: Dict[str, str], data: bytes):
    ctype = headers.get("content-type", "")
    if ctype.startswith("text/event-stream"):
        events = []
        for block in data.decode().split("\n\n"):
            if not block.strip():
                continue
            lines = dict(ln.split(": ", 1) for ln in block.splitlines())
            d = lines.get("data", "")
            events.append((lines.get("event"),
                           d if d == "[DONE]" else _mask(json.loads(d))))
        return ("sse", events)
    if ctype.startswith("application/json"):
        return ("json", _mask(json.loads(data)))
    return ("text", data.decode())


def _view(resp):
    st, headers, data = resp
    rid = headers.get("x-request-id")
    kind, body = _body(headers, data)
    if rid is not None and kind == "json" and "id" in json.loads(data):
        # the completion id is derived from the request id
        assert rid[:24] in json.loads(data)["id"]
    return dict(status=st, body=(kind, body), has_rid=rid is not None,
                retry_after=headers.get("retry-after"))


# ---------------------------------------------------------------------------
# one script, both services
# ---------------------------------------------------------------------------
COMPLETION = {"model": "echo", "prompt": "hello world", "max_tokens": 5}
CHAT = {"model": "echo", "max_tokens": 6,
        "messages": [{"role": "user", "content": "hi there"}]}
SCRIPT = [
    ("completion", "POST", "/v1/completions", COMPLETION, None, None),
    ("completion_stream", "POST", "/v1/completions",
     dict(COMPLETION, stream=True), None, None),
    ("chat", "POST", "/v1/chat/completions", CHAT, None, None),
    ("chat_stream", "POST", "/v1/chat/completions", dict(CHAT, stream=True),
     None, None),
    ("completion_unbounded", "POST", "/v1/completions",
     {"model": "echo", "prompt": "abc"}, None, None),
    ("tenant_header", "POST", "/v1/completions", COMPLETION,
     {"x-tenant": "acme", "x-priority": "batch"}, None),
    ("bad_json", "POST", "/v1/completions", None, None, b"{nope"),
    ("not_object", "POST", "/v1/completions", None, None, b"[1, 2]"),
    ("missing_prompt", "POST", "/v1/completions", {"model": "echo"}, None,
     None),
    ("unknown_model", "POST", "/v1/completions",
     {"model": "nope", "prompt": "x"}, None, None),
    ("bad_priority", "POST", "/v1/completions", COMPLETION,
     {"x-priority": "express"}, None),
    ("bad_tenant", "POST", "/v1/completions", COMPLETION,
     {"x-tenant": "bad tenant!"}, None),
    ("bad_timeout", "POST", "/v1/completions", COMPLETION,
     {"x-request-timeout": "-1"}, None),
    ("health", "GET", "/health", None, None, None),
    ("models", "GET", "/v1/models", None, None, None),
    ("traces_bad_limit", "GET", "/v1/traces?limit=abc", None, None, None),
    ("trace_missing", "GET", "/v1/traces/nosuchid", None, None, None),
    ("flows", "GET", "/v1/flows", None, None, None),
    ("flows_bad_limit", "GET", "/v1/flows?limit=x", None, None, None),
    ("incidents", "GET", "/v1/incidents", None, None, None),
    ("incident", "GET", "/v1/incidents/abc", None, None, None),
    ("router_decisions", "GET", "/v1/router/decisions", None, None, None),
    ("unknown_route", "GET", "/v1/nothing", None, None, None),
]
STEPS = [s[0] for s in SCRIPT]


@pytest.fixture(scope="module")
def script_run():
    """Run the whole script on both services once; keep each response, then
    scrape /metrics and every recorded trace."""
    with pytest.MonkeyPatch.context() as mp:
        _fresh_planes(mp)
        out: Dict[str, Any] = {}
        for pkg in PKGS:
            s = Served(pkg)
            try:
                resp = {}
                for name, method, path, body, hdrs, raw in SCRIPT:
                    resp[name] = _request(s.port, method, path, body, hdrs,
                                          raw)
                metrics = _request(s.port, "GET", "/metrics")
                traces = {}
                for name, (_, h, _) in resp.items():
                    rid = h.get("x-request-id")
                    if rid and resp[name][0] == 200:
                        traces[name] = (
                            _request(s.port, "GET", f"/v1/traces/{rid}"),
                            _request(s.port, "GET",
                                     f"/v1/traces/{rid}?format=chrome"))
                listed = _request(s.port, "GET", "/v1/traces?limit=3")
                out[pkg] = dict(resp=resp, metrics=metrics, traces=traces,
                                listed=listed)
            finally:
                s.close()
        yield out


@pytest.mark.parametrize("step", STEPS)
def test_script_step_matches_jax_service(script_run, step):
    j = _view(script_run["jax"]["resp"][step])
    t = _view(script_run["torch"]["resp"][step])
    if step == "unknown_route":
        # aiohttp's own plain-text 404 for a path no route matches
        assert (t["status"], t["body"]) == (j["status"], j["body"]) == (
            404, ("text", "404: Not Found"))
        return
    assert t == j


def _metric_lines(resp) -> List[str]:
    """Sample lines with timing values masked: buckets and sums of every
    ``*_seconds`` histogram, the MFU-style gauges, and the durations."""
    out = []
    for ln in resp[2].decode().splitlines():
        if not ln or ln.startswith("#"):
            out.append(ln)
            continue
        name = ln.split("{", 1)[0].split(" ", 1)[0]
        if re.search(r"_seconds_(bucket|sum)$", name):
            ln = ln.rsplit(" ", 1)[0] + " <t>"
        out.append(ln)
    return out


def test_metrics_after_script_match_jax_service(script_run):
    j = _metric_lines(script_run["jax"]["metrics"])
    t = _metric_lines(script_run["torch"]["metrics"])
    assert t == j
    text = "\n".join(t)
    assert 'dyn_http_requests_total{model="echo",endpoint="completions",' \
           'status="200",tenant="default"} 3.0' in text
    assert 'llm_ttft_seconds_count{component="http",model="echo"} 6' in text
    assert 'dyn_http_time_to_first_token_seconds_count{model="echo"} 2' \
        in text


def _span_view(resp):
    spans = json.loads(resp[2])["spans"]
    by_id = {s["span_id"]: s["name"] for s in spans}
    return [(s["name"], by_id.get(s["parent_id"]), s["status"],
             s["component"], sorted(k for k in s["attrs"]))
            for s in spans]


def test_traces_match_jax_service(script_run):
    j, t = script_run["jax"], script_run["torch"]
    assert set(t["traces"]) == set(j["traces"]) == {
        "completion", "completion_stream", "chat", "chat_stream",
        "completion_unbounded", "tenant_header"}
    for name in t["traces"]:
        assert _span_view(t["traces"][name][0]) == \
            _span_view(j["traces"][name][0]), name
        jc = json.loads(j["traces"][name][1][2])
        tc = json.loads(t["traces"][name][1][2])
        assert [e["name"] for e in tc["traceEvents"]] == \
            [e["name"] for e in jc["traceEvents"]]
    endpoint = {"completion_stream": "http:completions",
                "chat_stream": "http:chat"}
    for name, root in endpoint.items():
        assert _span_view(t["traces"][name][0]) == [
            (root, None, "ok", "proc", ["model"]),
            ("preprocess", root, "ok", "proc", ["prompt_tokens"]),
            ("sse.egress", root, "ok", "proc", ["chunks", "model"])]
    listed = json.loads(t["listed"][2])["traces"]
    assert len(listed) == 3 and listed == [
        t["resp"][n][1]["x-request-id"] for n in
        ("tenant_header", "completion_unbounded", "chat_stream")]


# ---------------------------------------------------------------------------
# overload: admission, priority header, brownout (tests/test_overload.py)
# ---------------------------------------------------------------------------
def _admission_run(pkg):
    ov = _mod(pkg, "utils.overload")
    ctrl = ov.AdmissionController(ov.AdmissionConfig(concurrency=1,
                                                     queue=0))
    s = Served(pkg, admission=ctrl)
    try:
        ctrl.inflight = 1                    # saturate the controller
        shed = _view(_request(s.port, "POST", "/v1/completions",
                              {"model": "echo", "prompt": "ab"}))
        ctrl.inflight = 0
        ok = [_view(_request(s.port, "POST", "/v1/completions",
                             {"model": "echo", "prompt": "ab"}))["status"]
              for _ in range(3)]
        return shed, ok, ctrl.inflight
    finally:
        s.close()


def test_admission_429_shape_and_release_match(monkeypatch):
    _fresh_planes(monkeypatch)
    j, t = (_admission_run(pkg) for pkg in PKGS)
    assert t == j
    shed, ok, inflight = t
    err = shed["body"][1]["error"]
    assert shed["status"] == 429 and shed["retry_after"] == "1"
    assert (err["type"], err["stage"], err["reason"]) == (
        "overloaded_error", "admission", "concurrency")
    assert err["retry_after"] > 0
    assert ok == [200, 200, 200] and inflight == 0


def _brownout_run(pkg):
    s = Served(pkg)
    body = {"model": "echo", "prompt": "abcdefgh", "max_tokens": 8}
    out = []
    try:
        for level, hdrs in ((1, {"x-priority": "batch"}), (1, None),
                            (2, None), (3, None), (4, None), (0, None)):
            s.svc.brownout.level = level
            out.append(_view(_request(s.port, "POST", "/v1/completions",
                                      body, hdrs)))
        return out
    finally:
        s.close()


def test_brownout_sheds_and_caps_match(monkeypatch):
    _fresh_planes(monkeypatch)
    monkeypatch.setenv("DYN_BROWNOUT_MAX_TOKENS", "2")
    j, t = (_brownout_run(pkg) for pkg in PKGS)
    assert t == j
    assert [r["status"] for r in t] == [429, 200, 200, 200, 429, 200]
    assert t[0]["body"][1]["error"]["reason"] == "brownout_batch"
    assert t[4]["body"][1]["error"]["reason"] == "brownout_shed_all"
    assert [len(t[i]["body"][1]["choices"][0]["text"]) for i in (1, 2, 5)] \
        == [8, 2, 8]


def test_priority_header_400_matches(pair):
    got = [_view(_request(pair[pkg].port, "POST", "/v1/completions",
                          COMPLETION, {"x-priority": "express"}))
           for pkg in PKGS]
    assert got[1] == got[0]
    assert got[1]["status"] == 400
    assert "x-priority" in got[1]["body"][1]["error"]["message"]


# ---------------------------------------------------------------------------
# HTTP/1.1 behaviour: keep-alive, pipelining, chunked bodies, close
# ---------------------------------------------------------------------------
def _raw_exchange(port: int, payload: bytes, timeout: float = 30) -> bytes:
    """Send ``payload`` on one connection and read until the server closes
    it (the last request carries ``Connection: close``)."""
    s = socket.create_connection(("127.0.0.1", port), timeout=timeout)
    try:
        s.sendall(payload)
        buf = b""
        while True:
            d = s.recv(65536)
            if not d:
                return buf
            buf += d
    finally:
        s.close()


def _post(path: str, body: dict, close: bool = False) -> bytes:
    b = json.dumps(body).encode()
    return (f"POST {path} HTTP/1.1\r\nHost: x\r\nContent-Type: "
            f"application/json\r\nContent-Length: {len(b)}\r\n"
            + ("Connection: close\r\n" if close else "")
            + "\r\n").encode() + b


def _completion_texts(raw: bytes) -> List[str]:
    return re.findall(rb'"text": "([^"]*)", "logprobs"', raw)


@pytest.mark.parametrize("pkg", PKGS)
def test_keep_alive_three_requests_one_streamed(pair, pkg):
    conn = http.client.HTTPConnection("127.0.0.1", pair[pkg].port,
                                      timeout=30)
    try:
        got = []
        for body in (COMPLETION, dict(COMPLETION, stream=True), CHAT):
            path = "/v1/chat/completions" if "messages" in body \
                else "/v1/completions"
            conn.request("POST", path, json.dumps(body),
                         {"Content-Type": "application/json"})
            r = conn.getresponse()
            data = r.read()
            got.append((r.status, r.getheader("Transfer-Encoding"),
                        r.will_close, data))
            sock = conn.sock
            assert sock is not None            # the same socket, still open
        assert [g[0] for g in got] == [200, 200, 200]
        assert [g[2] for g in got] == [False, False, False]
        assert got[1][1] == "chunked" and got[1][3].endswith(
            b"data: [DONE]\n\n")
        assert json.loads(got[0][3])["usage"]["completion_tokens"] == 5
        assert json.loads(got[2][3])["usage"]["completion_tokens"] == 6
    finally:
        conn.close()


@pytest.mark.parametrize("pkg", PKGS)
def test_pipelined_requests_answered_in_order(pair, pkg):
    payload = (_post("/v1/completions", dict(COMPLETION, prompt="first"))
               + _post("/v1/completions", dict(COMPLETION, prompt="second"))
               + b"GET /health HTTP/1.1\r\nHost: x\r\n"
                 b"Connection: close\r\n\r\n")
    raw = _raw_exchange(pair[pkg].port, payload)
    assert raw.count(b"HTTP/1.1 200 OK") == 3
    assert _completion_texts(raw) == [b"first", b"secon"]
    assert raw.rstrip().endswith(b'"models": ["echo"]}')


@pytest.mark.parametrize("pkg", PKGS)
def test_chunked_request_body(pair, pkg):
    body = json.dumps(dict(COMPLETION, prompt="chunked!")).encode()
    parts = [body[:7], body[7:20], body[20:]]
    payload = (b"POST /v1/completions HTTP/1.1\r\nHost: x\r\n"
               b"Content-Type: application/json\r\n"
               b"Transfer-Encoding: chunked\r\nConnection: close\r\n\r\n"
               + b"".join(b"%x;ext=1\r\n%s\r\n" % (len(p), p) for p in parts)
               + b"0\r\n\r\n")
    raw = _raw_exchange(pair[pkg].port, payload)
    assert raw.startswith(b"HTTP/1.1 200 OK")
    assert _completion_texts(raw) == [b"chunk"]


@pytest.mark.parametrize("pkg", PKGS)
def test_query_strings_reach_the_routes(pair, pkg):
    port = pair[pkg].port
    rids = [_request(port, "POST", "/v1/completions", COMPLETION)[1][
        "x-request-id"] for _ in range(3)]
    listed = json.loads(_request(port, "GET", "/v1/traces?limit=2")[2])
    assert listed["traces"] == rids[::-1][:2]
    chrome = _request(port, "GET", f"/v1/traces/{rids[0]}?format=chrome")
    events = json.loads(chrome[2])["traceEvents"]
    assert {e["name"] for e in events} >= {"http:completions",
                                           "preprocess"}


def _hang_up_mid_stream(port: int) -> bytes:
    s = socket.create_connection(("127.0.0.1", port), timeout=30)
    try:
        s.sendall(_post("/v1/completions", {
            "model": "echo", "prompt": "x" * 400, "stream": True}))
        return s.recv(4096)
    finally:
        s.close()


def test_client_hang_up_mid_stream_counts_499(monkeypatch):
    _fresh_planes(monkeypatch)
    monkeypatch.setenv("DYN_TOKEN_ECHO_DELAY_MS", "5")
    statuses = []
    for pkg in PKGS:
        s = Served(pkg)
        try:
            first = _hang_up_mid_stream(s.port)
            assert first.startswith(b"HTTP/1.1 200")
            line = None
            for _ in range(200):
                text = _request(s.port, "GET", "/metrics")[2].decode()
                line = [ln for ln in text.splitlines()
                        if ln.startswith("dyn_http_requests_total")]
                if line:
                    break
                time.sleep(0.02)
            statuses.append(line)
        finally:
            s.close()
    assert statuses[1] == statuses[0] == [
        'dyn_http_requests_total{model="echo",endpoint="completions",'
        'status="499",tenant="default"} 1.0']
