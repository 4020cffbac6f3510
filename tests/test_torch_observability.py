"""The port's observability and overload plane against the JAX package's.

The same calls go to each package's module of the same path (prometheus,
tracing, roofline, slo, overload, flightrec, watchdog, flows, deadline,
knobs, logging_ext, aiotasks) and must give equal outputs: render text and
state dumps byte for byte, span trees and Chrome traces under an injected
clock and injected span ids, cost-model figures within 1e-12 relative,
burn rates, admission and brownout decisions, ring and heartbeat dumps,
and ledger folds. Clocks are injected; nothing sleeps on a real window.
"""

from __future__ import annotations

import asyncio
import importlib
import io
import itertools
import json
import logging

import pytest

def _mods(name):
    return (importlib.import_module(f"dynamo_tpu.{name}"),
            importlib.import_module(f"dynamo_tpu_torch.{name}"))


class FakeTime:
    """Stand-in for a module's ``time`` (and a clock callable): one
    injected clock for ``time``/``monotonic``/``perf_counter``."""

    def __init__(self, t: float = 1000.0):
        self.t = t

    def time(self) -> float:
        return self.t

    monotonic = perf_counter = __call__ = time

    def advance(self, dt: float) -> None:
        self.t += dt


@pytest.fixture
def fresh_stage(monkeypatch):
    """A fresh process StageMetrics in both packages (restored after)."""
    out = []
    for p in _mods("utils.prometheus"):
        st = p.StageMetrics()
        monkeypatch.setattr(p, "_stage", st)
        out.append(st)
    return out


def _same(fn, *names):
    """fn(*modules of one package) for the JAX package, then the port."""
    mods = [_mods(n) for n in names]
    return [fn(*(m[i] for m in mods)) for i in (0, 1)]


# ---------------------------------------------------------------------------
# prometheus: render text and state dumps, byte for byte
# ---------------------------------------------------------------------------
def _prom_script(p):
    r = p.Registry()
    c = r.counter("req_total", "Requests", ("model", "status"))
    g = r.gauge("inflight", "In flight \\ with \"quotes\"", ("worker",))
    h = r.histogram("lat_seconds", "Latency", ("model",),
                    buckets=p.LATENCY_BUCKETS_FAST)
    hw = r.histogram("wide_seconds", "Wide", (), buckets=p.LATENCY_BUCKETS_WIDE)
    c.inc("m\"1", "200")
    c.inc("m\"1", "200", amount=2.5)
    c.inc("m\n2", "429")
    g.set("7", value=3.0)
    g.inc("7")
    g.dec("8", amount=2)
    for v in (0.0001, 0.0007, 0.003, 0.2, 0.9, 1.5, 70.0):
        h.observe("a", value=v)
        hw.observe(value=v * 3)
    h.observe("b", value=0.05)
    return r


def test_prometheus_render_and_state_dump_equal():
    j, t = _same(_prom_script, "utils.prometheus")
    assert t.render() == j.render()
    assert t.state_dump() == j.state_dump()


def test_prometheus_state_helpers_equal():
    def run(p):
        r = _prom_script(p)
        base = r.state_dump()
        r._metrics[0].inc("m\"1", "500")
        r._metrics[3].observe(value=0.3)
        cur = r.state_dump()
        other = _prom_script(p).state_dump()
        hist = cur["lat_seconds"]
        series = hist["series"]["a"]
        return (p.diff_states(base, cur),
                p.diff_states(base, cur, ignore=("req_total",)),
                p.merge_state_dumps([cur, other]),
                p.render_states([("http", cur), ("backend", other)]),
                [p.hist_quantile(hist["buckets"], series["counts"],
                                 series["total"], q)
                 for q in (0.0, 0.5, 0.9, 0.99, 1.0)])

    j, t = _same(run, "utils.prometheus")
    assert t == j


def test_stage_metrics_catalog_equal():
    """Every stage metric: name, help, kind, labels and buckets."""
    def run(p):
        st = p.StageMetrics()
        st.decode_step.observe(value=0.02)
        st.batch_occupancy.set("1", value=3)
        st.mfu.set("1", value=0.1)
        st.kv_tier_blocks.set("host", "1", value=5)
        st.kv_tier_blocks.set("host", "2", value=6)
        before = st.registry.render()
        st.clear_worker("1")
        return before, st.registry.render(), st.registry.state_dump()

    j, t = _same(run, "utils.prometheus")
    assert t == j


# ---------------------------------------------------------------------------
# tracing: the same span tree under an injected clock and span ids
# ---------------------------------------------------------------------------
def _span_tree(tr, clock, monkeypatch):
    monkeypatch.setattr(tr, "time", clock)
    ids = itertools.count(1)
    monkeypatch.setattr(tr, "_new_span_id", lambda: f"span{next(ids):04d}")
    t = tr.Tracer(component="http", capacity=64, enabled=True)
    root = t.start_span("http:completions", trace_id="req-1", model="m")
    token = tr.current_span_var.set(root.context())
    try:
        clock.advance(0.002)
        with t.span("preprocess", trace_id="req-1") as psp:
            psp.attrs["prompt_tokens"] = 12
            clock.advance(0.001)
        with pytest.raises(RuntimeError):
            with t.span("engine"):
                clock.advance(0.5)
                raise RuntimeError("boom")
        sse = t.start_span("sse.egress", model="m")
        clock.advance(0.25)
        sse.attrs["chunks"] = 3
        t.finish(sse)
        wire = tr.wire_context()
    finally:
        tr.current_span_var.reset(token)
    t.finish(root, status="error")
    t.record("queue.wait", 999.0, 999.5, trace_id="req-2", stage="q")
    remote = tr.Span.from_dict(dict(root.to_dict(), span_id="remote1",
                                    name="worker", component="backend",
                                    pid=1))
    spans = tr.merge_spans(t.spans_for("req-1"), [remote])
    return ([s.to_dict() for s in spans], tr.to_chrome_trace(spans),
            t.recent_trace_ids(5), wire,
            tr.extract_wire(wire).to_wire(),
            tr.extract_wire(None, "req-9").to_wire(),
            [tr.trace_sampled(f"t{i}", 0.3) for i in range(20)])


def test_tracing_span_tree_and_chrome_trace_equal(monkeypatch):
    jt, tt = _mods("utils.tracing")
    j = _span_tree(jt, FakeTime(), monkeypatch)
    t = _span_tree(tt, FakeTime(), monkeypatch)
    assert t == j
    names = [s["name"] for s in t[0]]
    assert names == ["http:completions", "worker", "preprocess", "engine",
                     "sse.egress"]


def test_tracing_sample_rate_and_force_keep(monkeypatch):
    for raw in ("", "0.25", "7", "-1", "junk"):
        monkeypatch.setenv("DYN_TRACE_SAMPLE", raw)
        j, t = _same(lambda tr: tr.sample_rate(), "utils.tracing")
        assert t == j

    def keep(tr):
        s = tr.Span("fault:x", "t", "s", None, "c", 1, 0.0)
        return [tr.force_keep(s), tr.force_keep(
            tr.Span("a", "t", "s", None, "c", 1, 0.0, status="error")),
            tr.force_keep(tr.Span("a", "t", "s", None, "c", 1, 0.0))]

    j, t = _same(keep, "utils.tracing")
    assert t == j == [True, True, False]


# ---------------------------------------------------------------------------
# roofline: cost model within 1e-12 relative, meter windows, peaks
# ---------------------------------------------------------------------------
def _rel_equal(a, b, rel=1e-12):
    if isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _rel_equal(x, y, rel)
    elif isinstance(a, float) or isinstance(b, float):
        assert b == pytest.approx(a, rel=rel, abs=0.0)
    else:
        assert a == b


@pytest.mark.parametrize("preset", ["tiny-byte", "tiny-gemma2", "tiny-moe",
                                    "llama-3-8b", "gemma2-9b"])
def test_roofline_costs_equal(preset):
    def run(rf, llama):
        m = llama.preset(preset)
        c = rf.model_costs(m)
        cw = rf.model_costs(m, weight_bytes=16.06e9)
        return (tuple(c.__dict__.values()), tuple(cw.__dict__.values()),
                rf.decode_cost(c, [1, 17, 300, 4096], 8),
                rf.prefill_cost(c, [(0, 37), (64, 512), (1472, 24)]),
                rf.verify_cost(c, [10, 99], 5))

    j, t = _same(run, "utils.roofline", "models.llama")
    _rel_equal(j, t)


def test_goodput_meter_windows_equal(monkeypatch):
    def run(rf, llama):
        clock = FakeTime()
        monkeypatch.setattr(rf, "time", clock)
        c = rf.model_costs(llama.preset("tiny-byte"))
        m = rf.GoodputMeter(c, rf.Peaks(1e12, 2e11, "test"), window_s=10.0)
        out = []
        for i, (fl, by, el, tk) in enumerate([
                (5e10, 1e9, 0.1, 8), (2e11, 3e9, 0.4, 16), (1e9, 1e8, 0.0, 1),
                (7e10, 2e9, 0.2, 8), (3e10, 5e8, 0.05, 4)]):
            m.account(fl, by, el, tk)
            out.append(m.snapshot())
            clock.advance(4.0 + i)
        out.append(m.snapshot())
        clock.advance(100.0)
        out.append(m.snapshot())
        out.append(m.lifetime())
        return out

    j, t = _same(run, "utils.roofline", "models.llama")
    _rel_equal([sorted(d.items()) for d in j], [sorted(d.items()) for d in t])


def test_peaks_table_override_and_cpu(monkeypatch):
    from dynamo_tpu.utils import roofline as jr
    from dynamo_tpu_torch.utils import roofline as tr

    p = tr.detect_peaks("NVIDIA H100 80GB HBM3", "cuda")
    assert (p.flops, p.hbm_bytes, p.source) == (989e12, 3.35e12,
                                                "datasheet:h100")
    monkeypatch.setenv("DYN_PEAK_FLOPS", "1e12")
    monkeypatch.setenv("DYN_PEAK_GBPS", "100")
    assert tr.detect_peaks("NVIDIA H100 80GB HBM3", "cuda").__dict__ == \
        jr.detect_peaks("TPU v5e", "tpu").__dict__
    monkeypatch.delenv("DYN_PEAK_FLOPS")
    monkeypatch.setattr(tr, "_CAL_CACHE", {"cpu": "cached"})
    assert tr.detect_peaks("cpu", "cpu") == "cached"


def test_record_compile_counts_equal(fresh_stage):
    def run(rf):
        rf.record_compile("decode", 1.5)
        rf.record_compile("decode", 0.5)
        return None

    _same(run, "utils.roofline")
    j, t = fresh_stage
    assert t.compile_seconds.get("decode") == j.compile_seconds.get(
        "decode") == 2.0
    assert t.compiled_programs.get("decode") == 2.0


# ---------------------------------------------------------------------------
# slo burn rates
# ---------------------------------------------------------------------------
def _hist_state(total, bad):
    return {"llm_ttft_seconds": {
        "kind": "histogram", "labels": ["model"],
        "buckets": [0.1, 0.5, 1.0],
        "series": {"m": {"counts": [total - bad, 0, bad],
                         "sum": 1.0, "total": total}}},
        "dyn_http_requests_total": {
        "kind": "counter", "labels": ["model", "endpoint", "status",
                                      "tenant"],
        "series": {"m\x1fchat\x1f200\x1fdefault": float(total),
                   "m\x1fchat\x1f503\x1fdefault": float(bad)}}}


def test_slo_burn_rates_equal(monkeypatch, fresh_stage):
    env = {"DYN_SLO_TTFT_P90": "0.5", "DYN_SLO_AVAILABILITY": "0.99",
           "DYN_SLO_ITL_P90": "x", "DYN_SLO_WINDOWS": "30,120"}

    def run(slo):
        monkeypatch.setattr(slo, "time", FakeTime(5.0))
        mon = slo.SloMonitor(slo.objectives_from_env(env),
                             windows=slo.windows_from_env(env))
        out = []
        for now, tot, bad in ((1000.0, 0, 0), (1030.0, 100, 5),
                              (1060.0, 200, 45), (1200.0, 210, 45)):
            out.append(mon.observe([("http", _hist_state(tot, bad))],
                                   now=now))
        return (out, mon.max_burn(), mon.recent_breaches(),
                slo.windows_from_env({"DYN_SLO_WINDOWS": "bad"}))

    j, t = _same(run, "utils.slo")
    assert t == j
    assert fresh_stage[1].slo_burn.state() == fresh_stage[0].slo_burn.state()


# ---------------------------------------------------------------------------
# overload: bucket, admission, tenants, gates, brownout
# ---------------------------------------------------------------------------
def _err_fields(e):
    return None if e is None else (type(e).__name__, str(e), e.code, e.stage,
                                   e.reason, e.retry_after)


def test_token_bucket_and_admission_matrix(fresh_stage):
    def run(ov):
        clk = FakeTime()
        out = []
        b = ov.TokenBucket(rate=10.0, burst=5.0, clock=clk)
        out += [b.take() for _ in range(6)]
        clk.advance(0.1)
        out += [b.take(), b.take(), round(b.retry_after(), 9)]
        clk.advance(0.2)
        out += [b.take(floor=2.0), b.take(floor=1.0)]
        for cfg in (ov.AdmissionConfig(concurrency=2, queue=2),
                    ov.AdmissionConfig(rps=10.0, burst=4.0,
                                       batch_reserve=0.5),
                    ov.AdmissionConfig(concurrency=2, queue=0),
                    ov.AdmissionConfig(kv_bytes=1e6, kv_token_bytes=1e3),
                    ov.AdmissionConfig()):
            ctrl = ov.AdmissionController(cfg, clock=clk)
            row = [ctrl.enabled, ctrl.kv_enabled]
            for pri in ("interactive", "batch", "batch", "interactive",
                        "interactive", "interactive"):
                row.append(_err_fields(ctrl.try_admit(pri)))
            ctrl.release()
            row.append(_err_fields(ctrl.try_admit("interactive")))
            for kv in (4e5, 5e5, 2e5, 2e6):
                row.append(_err_fields(ctrl.try_reserve_kv(kv, "batch")))
            ctrl.release_kv(4e5)
            row += [ctrl.inflight, ctrl.kv_inflight_bytes, ctrl.price_kv(7)]
            out.append(row)
        out.append(ov.AdmissionConfig.from_env({
            "DYN_ADMIT_RPS": "5", "DYN_ADMIT_CONCURRENCY": "3",
            "DYN_ADMIT_QUEUE": "x", "DYN_ADMIT_BATCH_RESERVE": "2"}).__dict__)
        return out

    j, t = _same(run, "utils.overload")
    assert t == j
    js, ts = fresh_stage
    for name in ("admission_rejects", "admission_depth",
                 "admission_kv_bytes"):
        assert getattr(ts, name).state() == getattr(js, name).state()


def test_tenant_admission_and_burn_equal(fresh_stage):
    def run(ov):
        clk = FakeTime()
        quotas = ov.tenant_quotas_from_env({"DYN_TENANT_QUOTAS": json.dumps(
            {"acme": {"rps": 2, "concurrency": 2}, "solo": {
                "concurrency": 1}})})
        ta = ov.TenantAdmission(quotas, clock=clk)
        out = [ta.enabled, ta.label("acme"), ta.label("zz"),
               ta.label("default")]
        for tenant in ("acme", "acme", "acme", "solo", "solo", "free"):
            out.append(_err_fields(ta.try_admit(tenant, "batch")))
        ta.release("acme")
        clk.advance(1.0)
        out.append(_err_fields(ta.try_admit("acme")))
        ta.set_quotas({"acme": ov.TenantQuota(rps=1.0)})
        out.append(_err_fields(ta.try_admit("acme")))
        out.append(ov.tenant_quotas_from_env({"DYN_TENANT_QUOTAS": "[1"}))
        burn = ov.TenantBurnTracker(0.99, windows=(30.0, 120.0), clock=clk)
        for now, ok, bad in ((0.0, 0, 0), (20.0, 100, 1), (40.0, 200, 9)):
            out.append(burn.observe([("http", {
                "dyn_tenant_requests_total": {
                    "kind": "counter", "labels": ["tenant", "status"],
                    "series": {"acme\x1f200": float(ok),
                               "acme\x1f503": float(bad),
                               "b\x1f429": 3.0}}})], now=now))
        out += [burn.worst(), ov.tenant_availability_objective(
            {"DYN_TENANT_AVAILABILITY": "0.995"})]
        return out

    j, t = _same(run, "utils.overload")
    assert t == j
    js, ts = fresh_stage
    for name in ("tenant_rejects", "tenant_inflight", "tenant_burn"):
        assert getattr(ts, name).state() == getattr(js, name).state()


def test_brownout_controller_and_effects_equal(fresh_stage):
    def run(ov):
        clk = FakeTime()
        c = ov.BrownoutController(up_burn=2.0, down_burn=0.5, dwell_up=5.0,
                                  dwell_down=30.0, clock=clk)
        levels = []
        for dt, burn in ((0, 0.3), (0, 2.5), (0, 9.9), (5, 9.9), (100, 1.0),
                         (0, 0.2), (29, 0.2), (1, 0.2), (30, 0.2), (0, 3.0),
                         (5, 3.0), (5, 3.0), (5, 3.0), (1, 0.1)):
            clk.advance(dt)
            levels.append(c.update(burn))
        effects = [(lvl, ov.sheds_batch(lvl), ov.max_tokens_cap(
            lvl, {"DYN_BROWNOUT_MAX_TOKENS": "64"}), ov.max_tokens_cap(lvl),
            ov.disables_spec(lvl), ov.sheds_all(lvl),
            _err_fields(ov.brownout_reject("interactive", lvl)),
            _err_fields(ov.brownout_reject("batch", lvl)))
            for lvl in range(5)]
        st = ov.BrownoutState()
        return levels, effects, st.level

    j, t = _same(run, "utils.overload")
    assert t == j
    assert fresh_stage[1].brownout_level.state() == \
        fresh_stage[0].brownout_level.state()


def test_priority_parsing_estimates_and_shed_math():
    def run(ov, oai):
        out = []
        for raw in (None, "", "Interactive", " batch ", "realtime"):
            try:
                out.append(ov.parse_priority(raw))
            except ValueError as e:
                out.append(str(e))
        for raw in (None, "acme.1", "bad tenant", "x" * 65):
            try:
                out.append(ov.parse_tenant(raw))
            except ValueError as e:
                out.append(str(e))
        for d in ({"model": "m", "prompt": "abcdef", "max_tokens": 9},
                  {"model": "m", "prompt": ["ab", "cde"]},
                  {"model": "m", "messages": [
                      {"role": "user", "content": "hello"}]}):
            req = (oai.ChatCompletionRequest.from_dict(d) if "messages" in d
                   else oai.CompletionRequest.from_dict(d))
            out.append(ov.estimate_request_tokens(req))
        out += [ov.predicted_wait(6, 0.5, servers=2),
                ov.should_shed(6, 0.5, remaining_s=1.0, servers=2),
                ov.should_shed(6, None, remaining_s=0.1),
                ov.PRIORITY_HEADER, ov.TENANT_HEADER, ov.DEFAULT_TENANT]
        est = ov.ServiceTimeEstimator(alpha=0.5)
        for v in (1.0, 3.0, 2.0):
            est.observe(v)
        out.append(est.mean())
        e = ov.OverloadError("shed", stage="worker_queue",
                             reason="queue_full", retry_after=0.25)
        # the fields the wire's error control frame carries
        out.append(_err_fields(e))
        return out

    j, t = _same(run, "utils.overload", "llm.protocols.openai")
    assert t == j


def test_priority_gate_and_slot_gated_engine_equal():
    async def scenario(ov, engines, common):
        out = []
        gate = ov.PriorityGate(slots=1, max_queue=3, max_queue_batch=1)
        await gate.acquire("interactive", None)
        order = []

        async def waiter(pri, tag):
            await gate.acquire(pri, None)
            order.append(tag)

        t1 = asyncio.ensure_future(waiter("interactive", "i1"))
        await asyncio.sleep(0)
        try:
            await gate.acquire("batch", None)
        except ov.OverloadError as e:
            out.append(_err_fields(e))
        t2 = asyncio.ensure_future(waiter("interactive", "i2"))
        await asyncio.sleep(0)
        out.append(gate.waiting)
        for _ in range(3):
            gate.release(0.1)
            await asyncio.sleep(0)
        await asyncio.gather(t1, t2)
        out += [order, gate.free]
        eng = ov.SlotGatedEngine(engines.EchoCoreEngine(delay_s=0), gate)
        from importlib import import_module

        Context = import_module(
            engines.__name__.rsplit(".", 2)[0] + ".runtime.engine").Context
        for _ in range(2):
            outs = [o.token_ids async for o in eng.generate(
                common.BackendInput(token_ids=[1, 2, 3]), Context())]
            out.append(outs)
        out.append(gate.free)
        g2 = ov.gate_from_env({"DYN_WORKER_SLOTS": "2",
                               "DYN_WORKER_QUEUE_DEPTH": "4"})
        out.append(None if g2 is None else (g2.free, g2.max_queue))
        return out

    def run(ov, engines, common):
        return asyncio.run(scenario(ov, engines, common))

    j, t = _same(run, "utils.overload", "llm.engines",
                 "llm.protocols.common")
    assert t == j


def test_overload_state_signal_helpers_equal():
    states = [("http", {
        "dyn_admission_rejects_total": {
            "kind": "counter", "labels": ["reason", "priority"],
            "series": {"concurrency\x1fbatch": 3.0}},
        "dyn_queue_shed_total": {
            "kind": "counter", "labels": ["stage", "reason", "priority"],
            "series": {"worker_queue\x1fqueue_full\x1fbatch": 2.0}},
        "dyn_admission_depth": {"kind": "gauge", "labels": [],
                                "series": {"": 4.0}},
        "dyn_brownout_level": {"kind": "gauge", "labels": [],
                               "series": {"": 2.0}}})]
    j, t = _same(lambda ov: (ov.shed_totals(states),
                             ov.admission_depth_total(states),
                             ov.brownout_level_from_states(states),
                             ov.brownout_key("ns")), "utils.overload")
    assert t == j


# ---------------------------------------------------------------------------
# flight recorder, watchdog, flows
# ---------------------------------------------------------------------------
def _recorder_run(fr, wd, tr, clock, monkeypatch):
    for mod in (fr, wd):
        monkeypatch.setattr(mod, "time", clock)
    rec = fr.FlightRecorder("engine", enabled=True)
    rec.events = fr.Ring("events", 4)
    for i in range(6):
        rec.note("engine.dispatch", depth=i, batch=2, steps=8)
        clock.advance(0.01)
    rec.hb_begin("engine.decode", stall="decode")
    clock.advance(0.02)
    rec.hb_done("engine.decode", 0.02)
    rec.hb_begin("engine.decode")
    rec.hb_begin("engine.decode")
    rec.hb_progress("engine.decode", 3)
    rec.hb_done("engine.decode", 0.03)
    rec.hb_begin("kv.stream", budget=1.0, trace_id="tr")
    w = wd.Watchdog(recorder=rec, tracer=tr.Tracer("wd", enabled=True),
                    interval=99.0, loop_stall=99.0, enabled=False,
                    mult=8.0, floor=0.05)
    clock.advance(2.0)
    fired = w.check(clock.monotonic())
    again = w.check(clock.monotonic() + 1.0)
    snap = rec.snapshot(window=(clock.time() - 1.0, clock.time()))
    rec.hb_end("kv.stream")
    return fired, again, snap, rec.snapshot()


def test_flightrec_rings_heartbeats_and_watchdog_equal(monkeypatch,
                                                      fresh_stage):
    jf, tf = _mods("obs.flightrec")
    jw, tw = _mods("obs.watchdog")
    jt, tt = _mods("utils.tracing")
    j = _recorder_run(jf, jw, jt, FakeTime(), monkeypatch)
    t = _recorder_run(tf, tw, tt, FakeTime(), monkeypatch)
    assert t == j
    # the decode heartbeat stalled past 8 x its EWMA, kv.stream past its
    # budget; a second check in the same wedged period fires nothing
    assert [f["kind"] for f in t[0]] == ["decode", "kv.stream"]
    assert t[1] == []
    assert fresh_stage[1].registry.state_dump() == \
        fresh_stage[0].registry.state_dump()


def test_flightrec_module_hooks_balance(monkeypatch):
    """The engine's hook functions on the process recorder: every
    hb_begin is paired by an hb_done."""
    def run(fr):
        monkeypatch.setattr(fr, "_recorder", fr.FlightRecorder("x", True))
        for _ in range(3):
            fr.hb_begin("engine.decode", stall="decode")
            fr.note_event("engine.dispatch", depth=1, batch=1, steps=8)
        for _ in range(3):
            fr.hb_done("engine.decode", 0.01)
            fr.note_event("engine.step", s=0.08, n=8, compiled=False)
        rec = fr.flight_recorder()
        return (rec.heartbeats["engine.decode"].depth,
                [e["kind"] for e in rec.events.snapshot()])

    j, t = _same(run, "obs.flightrec")
    assert t == j and t[0] == 0


def _flows_run(fl, clock, monkeypatch):
    monkeypatch.setattr(fl, "time", clock)
    led = fl.FlowLedger(local="w1", now=clock.monotonic)
    for kind, n, s, src, dst in (
            ("kv_h2d", 1 << 20, 0.001, None, None),
            ("kv_d2h", 3 << 20, 0.002, None, None),
            ("disk_read", 1 << 18, 0.0, None, None),
            ("kv_push", 5 << 20, 0.01, "a1", "b2"),
            ("kv_h2d", 2 << 20, 0.001, None, None)):
        led.record(kind, n, s, src=src, dst=dst)
        clock.advance(0.5)
    led.set_local(0xabc)
    led.record("kv_h2d", 1000, 0.0)
    return (led.snapshot(), led.total_bytes(), led.total_bytes("kv_h2d"),
            fl.link_name("a", "b"), fl.split_link(fl.link_name("a", "b")),
            fl.fmt_bytes(123456789.0))


def test_flows_ledger_and_fold_equal(monkeypatch, fresh_stage):
    monkeypatch.setenv("DYN_LINK_CAPACITY_H2D", "1e9")
    jf, tf = _mods("obs.flows")
    j = _flows_run(jf, FakeTime(), monkeypatch)
    t = _flows_run(tf, FakeTime(), monkeypatch)
    assert t == j
    states_j = [("backend", fresh_stage[0].registry.state_dump())]
    states_t = [("backend", fresh_stage[1].registry.state_dump())]
    assert tf.flows_from_states(states_t) == jf.flows_from_states(states_j)
    assert tf.flows_from_states(states_t)
    assert set(tf.KIND_CLASS.items()) == set(jf.KIND_CLASS.items())


# ---------------------------------------------------------------------------
# deadline, knobs, logging, background tasks, incidents without a store
# ---------------------------------------------------------------------------
def test_deadline_semantics_equal(monkeypatch, fresh_stage):
    async def scenario(dl):
        out = [dl.DEADLINE_KEY, dl.expired(None), dl.remaining(None)]
        clock = FakeTime(50.0)
        monkeypatch.setattr(dl, "time", clock)
        out += [dl.expired(49.0), dl.remaining(60.0), dl.from_timeout(2.5)]
        e = dl.expire("http_stream", 49.0)
        out.append(_err_fields(e))
        try:
            dl.check(10.0, "router")
        except dl.DeadlineExceeded as x:
            out.append(_err_fields(x))

        async def gen():
            for i in range(3):
                yield i

        out.append([i async for i in dl.guard_stream(gen(), None, "s")])
        return out

    j, t = _same(lambda dl: asyncio.run(scenario(dl)), "runtime.deadline")
    assert t == j
    assert fresh_stage[1].deadline_expiries.state() == \
        fresh_stage[0].deadline_expiries.state()


def test_knobs_parse_and_registry_subset():
    jk, tk = _mods("utils.knobs")
    env = {"A": "1.5", "B": "x", "C": "-3", "D": ""}
    for name, default, minimum in (("A", 0.0, None), ("B", 2.0, None),
                                   ("C", 1.0, 0.0), ("D", 4.0, None),
                                   ("E", 5.0, None)):
        assert tk.env_float(name, default, env, minimum) == \
            jk.env_float(name, default, env, minimum)
    # every knob the port reads is registered, each entry as in JAX (the
    # profile knob captures a torch.profiler trace, not an XLA one)
    assert tk.KNOBS and set(tk.KNOBS) <= set(jk.KNOBS)
    for name, k in tk.KNOBS.items():
        want = dict(jk.KNOBS[name].__dict__)
        if name == "DYN_PROFILE_DIR":
            want["description"] = want["description"].replace(
                "an XLA profile", "a torch.profiler Chrome trace")
        assert k.__dict__ == want, name
    import pathlib
    import re

    root = pathlib.Path(__file__).resolve().parents[1] / "dynamo_tpu_torch"
    read = set()
    for f in root.rglob("*.py"):
        if f.name not in ("knobs.py", "prometheus.py"):
            read |= set(re.findall(r"[\"'](DYN_[A-Z0-9_]*[A-Z0-9])[\"']",
                                   f.read_text()))
    read |= {f"DYN_LINK_CAPACITY_{c}" for c in ("NET", "H2D", "D2H",
                                                 "DISK")}
    # derived knobs (DYN_<PROG>_<FLAG>, materialized by the dynconfig
    # layering) are never literals, as in the JAX registry's gate
    assert read == {n for n, k in tk.KNOBS.items() if not k.derived}
    derived = {n for n, k in tk.KNOBS.items() if k.derived}
    assert derived == {f"DYN_AGGREGATOR_{f}" for f in ("STORE", "NAMESPACE",
                                                       "INTERVAL")}


def test_logging_jsonl_and_request_id_equal(monkeypatch):
    monkeypatch.setenv("DYN_LOGGING_JSONL", "1")
    monkeypatch.setenv("DYN_LOG", "warning,dynamo_x=debug")
    root = logging.getLogger()
    saved = (list(root.handlers), root.level)
    outs = []
    try:
        for le in _mods("utils.logging_ext"):
            buf = io.StringIO()
            le.init_logging(stream=buf)
            token = le.request_id_var.set("req-42")
            try:
                logging.getLogger("dynamo_x.t").debug("hello %s", "x")
            finally:
                le.request_id_var.reset(token)
            rec = json.loads(buf.getvalue().strip().splitlines()[-1])
            rec.pop("ts", None)
            outs.append((rec, logging.getLogger("dynamo_x").level,
                         root.level))
    finally:
        for h in list(root.handlers):
            root.removeHandler(h)
        for h in saved[0]:
            root.addHandler(h)
        root.setLevel(saved[1])
        logging.getLogger("dynamo_x").setLevel(logging.NOTSET)
    assert outs[1] == outs[0]
    assert outs[1][0]["request_id"] == "req-42"


def test_aiotasks_spawn_and_cancel_all():
    from dynamo_tpu_torch.utils import aiotasks

    async def go():
        store = set()
        hit = []

        async def quick():
            hit.append(1)

        async def forever():
            await asyncio.Event().wait()

        t = aiotasks.spawn(quick(), name="q", store=store)
        aiotasks.spawn(forever(), name="f", store=store)
        await t
        await aiotasks.cancel_all(store)
        blocking = await aiotasks.spawn_blocking(sum, [1, 2, 3])
        return hit, len(store), blocking

    assert asyncio.run(go()) == ([1], 0, 6)


def test_incident_trigger_without_manager_is_inert(fresh_stage):
    j, t = _same(lambda inc: (inc.manager(), inc.trigger("slo_burn", x=1),
                              inc.incident_beacon_key("ns", "i1"),
                              inc.incident_dump_prefix("ns", "i1")),
                 "obs.incidents")
    assert t == j


def test_obs_start_process_arms_recorder_and_watchdog():
    from dynamo_tpu_torch import obs

    async def go():
        h = await obs.start_process("http")
        try:
            return (h.recorder is obs.flight_recorder(), h.manager,
                    h.recorder.component)
        finally:
            await h.stop()

    assert asyncio.run(go()) == (True, None, "http")
