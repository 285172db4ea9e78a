"""The port's per-request lifecycle tracing
(deepspeed_tpu_torch/telemetry/reqtrace.py): trace IDs, timelines,
per-tenant attribution, exemplars, SLO-breach auto-capture — a copy of
tests/test_reqtrace.py run against the port, on the CPU.

Host logic + localhost HTTP round trips, and the port's engine end to end
on a tiny fp32 model: a forced TTFT breach must produce a flight-recorder
dump holding the offending request's complete, monotonically-timestamped
timeline, with the matching histogram bucket carrying that request's trace
ID as an exemplar. Also here: the port-side drift guard (every lifecycle
kind the port emits is declared, and every declared kind is emitted
somewhere in deepspeed_tpu_torch/) and the breach capture's
torch.profiler trace.
"""
import json
import os
import re
import time
import urllib.request

import pytest
import torch

from deepspeed_tpu_torch import telemetry as T
from deepspeed_tpu_torch.telemetry import (
    LIFECYCLE_EVENTS,
    TENANT_CARDINALITY_CAP,
    TENANT_OVERFLOW_LABEL,
    ReqTracer,
    Telemetry,
    sanitize_label_value,
)

# --------------------------------------------------------------------------
# strict exposition parsers (the test_telemetry._PROM_LINE rule, plus the
# OpenMetrics exemplar suffix and # EOF for ?exemplars=1)
# --------------------------------------------------------------------------

_SAMPLE = (r"[a-zA-Z_:][a-zA-Z0-9_:]*"
           r"(?:\{[a-zA-Z_][a-zA-Z0-9_]*=\"[^\"]*\""
           r"(?:,[a-zA-Z_][a-zA-Z0-9_]*=\"[^\"]*\")*\})?"
           r" -?(?:[0-9]+(?:\.[0-9]+)?(?:[eE][-+]?[0-9]+)?|\+Inf|-Inf|NaN)")

_PROM_LINE = re.compile(
    r"^(?:# (?:HELP|TYPE) [a-zA-Z_:][a-zA-Z0-9_:]* .+|" + _SAMPLE + r")$")

#: exemplar suffix: `` # {trace_id="..."} value timestamp``
_OPENMETRICS_LINE = re.compile(
    r"^(?:# (?:HELP|TYPE) [a-zA-Z_:][a-zA-Z0-9_:]* .+"
    r"|# EOF"
    r"|" + _SAMPLE +
    r"(?: # \{trace_id=\"[^\"]+\"\} [0-9.eE+-]+ [0-9.]+)?)$")


def _assert_wellformed(text: str, pattern=_PROM_LINE) -> list[str]:
    lines = text.strip("\n").split("\n")
    for line in lines:
        assert pattern.match(line), f"malformed exposition line: {line!r}"
    return lines


def _tracer(**kw) -> tuple[Telemetry, ReqTracer]:
    t = Telemetry(enabled=True)
    rt = t.reqtrace
    rt.enabled = True
    for k, v in kw.items():
        setattr(rt, k, v)
    return t, rt


# --------------------------------------------------------------------------
# trace identity / timelines
# --------------------------------------------------------------------------

def test_trace_ids_unique_and_timeline_records_lifecycle():
    t, rt = _tracer()
    ids = {rt.begin(uid, tenant="acme", prompt=8) for uid in range(20)}
    assert len(ids) == 20 and None not in ids
    rt.event(3, "admit", prompt=8, blocks=2, prefix_hit=0, shared_blocks=0,
             evicted=0, slot=0)
    rt.event(3, "prefill_chunk", tokens=8, T=8, rows=1)
    rt.event(3, "commit", tokens=1)
    rt.event(3, "release", pages=2)
    assert 3 not in rt._live                    # release closed the trace
    done = rt.timelines()
    tl = next(x for x in done if x["uid"] == 3)
    kinds = [e["kind"] for e in tl["events"]]
    assert kinds == ["enqueue", "admit", "prefill_chunk", "commit",
                     "release"]
    ts = [e["t"] for e in tl["events"]]
    assert ts == sorted(ts)                     # monotone timestamps
    assert set(kinds) <= set(LIFECYCLE_EVENTS)
    assert rt.find(tl["trace_id"])["uid"] == 3
    assert rt.find("nope") is None


def test_unknown_uid_and_pool_events_land_in_global_ring():
    t, rt = _tracer()
    rt.event(-1, "evict", pages=3)
    rt.event(999, "commit", tokens=1)           # never began: unattributed
    kinds = [e["kind"] for e in rt.global_events()]
    assert kinds == ["evict", "commit"]


def test_rings_are_bounded_head_retained_and_live_capped():
    t = Telemetry(enabled=True)
    rt = ReqTracer(registry=t.registry, recorder=t.recorder, enabled=True,
                   max_events=4, timeline_ring=3, max_live=5)
    rt.begin(1, prompt=1)
    for i in range(10):
        rt.event(1, "commit", tokens=1)
    rt.event(1, "release", pages=0)
    tl = rt.timelines()[-1]
    # head retention: enqueue + first 3 commits survive; the 7 surplus
    # commits AND the release event count as dropped
    assert len(tl["events"]) == 4
    assert tl["events"][0]["kind"] == "enqueue"
    assert tl["events_dropped"] == 8
    # completed ring keeps the newest 3
    for uid in range(10, 16):
        rt.begin(uid)
        rt.event(uid, "release", pages=0)
    assert len(rt.timelines()) == 3
    # live cap: oldest unreleased traces fall off
    for uid in range(20, 28):
        rt.begin(uid)
    assert len(rt._live) == 5


def test_sampling_is_deterministic_and_counters_survive_unsampled():
    t, rt = _tracer(sample=0.0)
    rt.begin(1, tenant="acme", prompt=4)
    rt.event(1, "prefill_chunk", tokens=4, T=4, rows=1)
    rt.event(1, "release", pages=1)
    assert rt.timelines() == []                 # no timeline retained
    assert rt.exemplar(1) is None
    snap = t.registry.snapshot()
    # attribution still counts — sampling only gates timelines/exemplars
    assert snap["serving_tenant_prefill_tokens_total"]["series"][0][
        "value"] == 4
    assert rt.traces_started == 1


# --------------------------------------------------------------------------
# per-tenant attribution
# --------------------------------------------------------------------------

def test_tenant_labels_sanitize_and_cap_folds_overflow_into_other():
    _, rt0 = _tracer()
    assert rt0.tenant_label(None) == "default"
    assert rt0.tenant_label("acme co!") == "acme_co_"
    assert rt0.tenant_label("x" * 200) == "x" * 64
    # cap: a fresh tracer admitting more tenants than the cap folds the
    # overflow into 'other' and the exposition still parses strictly
    t, rt = _tracer()
    for i in range(TENANT_CARDINALITY_CAP + 5):
        rt.begin(100 + i, tenant=f"tenant-{i:03d}")
        rt.event(100 + i, "admit", blocks=1)    # series appear at admit
    fam = t.registry.snapshot()["serving_tenant_requests_total"]
    labels = {s["labels"]["tenant"] for s in fam["series"]}
    assert len(labels) == TENANT_CARDINALITY_CAP + 1   # cap + 'other'
    assert TENANT_OVERFLOW_LABEL in labels
    other = next(s for s in fam["series"]
                 if s["labels"]["tenant"] == TENANT_OVERFLOW_LABEL)
    assert other["value"] == 5
    _assert_wellformed(t.registry.render_prometheus())


def test_tenant_label_sanitizer_matches_lint_mirror():
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "check_metric_names",
        os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "bin", "check_metric_names.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    for v in ("acme", "a b", "ten/ant:7", "x" * 100, "", "Ωmega", None, 3):
        assert mod.sanitize_label_value(v) == sanitize_label_value(v), v


def test_kv_page_seconds_and_spec_attribution():
    t, rt = _tracer()
    rt.begin(1, tenant="acme")
    rt.event(1, "admit", blocks=4)
    rt.event(1, "spec_round", proposed=6, accepted=3, committed=4)
    time.sleep(0.01)
    rt.event(1, "release", pages=4)
    snap = t.registry.snapshot()
    pgs = snap["serving_tenant_kv_page_seconds_total"]["series"][0]["value"]
    assert pgs >= 4 * 0.01
    assert snap["serving_tenant_spec_verify_tokens_total"]["series"][0][
        "value"] == 7                           # proposed + root
    assert snap["serving_tenant_decode_tokens_total"]["series"][0][
        "value"] == 4


# --------------------------------------------------------------------------
# exemplars + exposition
# --------------------------------------------------------------------------

def test_exemplars_render_only_in_openmetrics_mode():
    t, rt = _tracer()
    tid = rt.begin(1, tenant="acme")
    rt.event(1, "admit", blocks=1)
    rt.observe_ttft(1, 0.04)
    plain = t.registry.render_prometheus()
    _assert_wellformed(plain)                   # base format: no exemplars
    assert "trace_id" not in plain
    om = t.registry.render_prometheus(exemplars=True)
    lines = _assert_wellformed(om, _OPENMETRICS_LINE)
    assert lines[-1] == "# EOF"
    ex_lines = [ln for ln in lines if f'trace_id="{tid}"' in ln]
    assert ex_lines and "serving_tenant_ttft_s_bucket" in ex_lines[0]
    # counter families must declare under the BASE name (OpenMetrics
    # reserves _total for samples): a strict OM consumer — the only kind
    # that can use these exemplars — must accept the whole body
    prom_parser = pytest.importorskip("prometheus_client.openmetrics.parser")
    names = {f.name for f in prom_parser.text_string_to_metric_families(om)}
    assert "serving_tenant_requests" in names


def test_snapshot_carries_exemplars_and_merge_ignores_them():
    from deepspeed_tpu_torch.telemetry import MetricsRegistry

    r = MetricsRegistry()
    h = r.histogram("ttft_s", buckets=(0.1, 1.0))
    h.observe(0.05, exemplar="abc-1")
    h.observe(5.0, exemplar="abc-2")
    snap = r.snapshot()
    ex = snap["ttft_s"]["series"][0]["exemplars"]
    assert ex["0"][0] == "abc-1" and ex["2"][0] == "abc-2"
    json.dumps(snap)                            # JSON round-trippable
    merged = MetricsRegistry()
    merged.merge(snap)
    merged.merge(snap)
    assert merged.histogram("ttft_s", buckets=(0.1, 1.0)).count == 4


def test_live_scrape_serves_tenant_series_and_exemplar_buckets():
    """The satellite contract: a live localhost scrape shows per-tenant
    series parsing strictly, and ?exemplars=1 serves exemplar-bearing
    buckets under the OpenMetrics content type — also strictly parsed."""
    t, rt = _tracer()
    tid = rt.begin(7, tenant="acme", prompt=16)
    rt.event(7, "admit", blocks=2)
    rt.event(7, "prefill_chunk", tokens=16, T=16, rows=1)
    rt.observe_ttft(7, 0.08)
    port = t.start_http(0)
    try:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/metrics", timeout=10) as resp:
            body = resp.read().decode()
            assert resp.headers["Content-Type"].startswith("text/plain")
        lines = _assert_wellformed(body)
        assert any(ln == 'serving_tenant_requests_total{tenant="acme"} 1.0'
                   for ln in lines)
        assert any(ln.startswith(
            'serving_tenant_prefill_tokens_total{tenant="acme"} 16')
            for ln in lines)
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/metrics?exemplars=1",
                timeout=10) as resp:
            om = resp.read().decode()
            assert resp.headers["Content-Type"].startswith(
                "application/openmetrics-text")
        om_lines = _assert_wellformed(om, _OPENMETRICS_LINE)
        assert om_lines[-1] == "# EOF"
        assert any(f'trace_id="{tid}"' in ln for ln in om_lines)
    finally:
        t.stop_http()


def test_aggregate_scrape_skips_stale_peers_with_age_gauges(tmp_path):
    """The exposition satellite: ?aggregate=1 exposes a per-peer
    snapshot-age gauge and SKIPS (with a counter) peers older than the
    staleness cutoff instead of silently merging dead data."""
    fresh, stale = Telemetry(enabled=True), Telemetry(enabled=True)
    fresh.registry.counter("fleet_tokens_total").inc(10)
    stale.registry.counter("fleet_tokens_total").inc(90)
    fresh.write_snapshot(str(tmp_path / "peer_fresh.json"))
    stale.write_snapshot(str(tmp_path / "peer_stale.json"))
    old = time.time() - 3600
    os.utime(tmp_path / "peer_stale.json", (old, old))

    t = Telemetry(enabled=True,
                  peer_snapshot_glob=str(tmp_path / "peer_*.json"))
    t.registry.counter("fleet_tokens_total").inc(1)
    port = t.start_http(0)
    assert t.server.peer_staleness_s == 300.0      # the default cutoff
    try:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/metrics?aggregate=1",
                timeout=10) as resp:
            body = resp.read().decode()
        lines = _assert_wellformed(body)
        # stale peer's 90 never merged: 1 + 10 only
        assert any(ln == "fleet_tokens_total 11.0" for ln in lines)
        assert any(ln == "telemetry_aggregated_peers 1.0" for ln in lines)
        assert any(ln == "telemetry_stale_peers_skipped 1.0"
                   for ln in lines)
        # peers are labeled by path TAIL (not basename: per-host trees
        # like peers/<host>/snap.json would collide on the basename)
        ages = {m.group(1): float(m.group(2)) for m in (
            re.match(r'telemetry_peer_snapshot_age_s\{peer="([^"]+)"\} '
                     r'([0-9.]+)', ln) for ln in lines) if m}
        by_name = {k.rsplit("/", 1)[-1]: v for k, v in ages.items()}
        assert set(by_name) == {"peer_fresh.json", "peer_stale.json"}
        assert by_name["peer_stale.json"] > 3000 > by_name["peer_fresh.json"]
        # cutoff disabled -> the stale peer merges again
        t.server.peer_staleness_s = None
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/metrics?aggregate=1",
                timeout=10) as resp:
            body2 = resp.read().decode()
        assert "fleet_tokens_total 101.0" in body2.splitlines()
    finally:
        t.stop_http()


# --------------------------------------------------------------------------
# SLO-breach auto-capture
# --------------------------------------------------------------------------

def test_breach_dumps_timeline_plus_state_and_rate_limits(tmp_path):
    t, rt = _tracer(slo_ttft_s=0.1, breach_interval_s=0.0)
    t.recorder.path = str(tmp_path / "breach.json")
    rt.state_probe = lambda: {"queue_depth": 3, "free_blocks": 7}
    tid = rt.begin(1, tenant="acme", prompt=4)
    rt.event(1, "admit", blocks=2, prefix_hit=0)
    rt.event(1, "prefill_chunk", tokens=4, T=4, rows=1)
    rt.observe_ttft(1, 0.05)                    # under threshold: nothing
    assert rt.breaches == 0 and rt.breach_dumps == 0
    rt.observe_ttft(1, 0.25)                    # breach
    assert rt.breaches == 1 and rt.breach_dumps == 1
    with open(tmp_path / "breach.json") as f:
        rec = json.load(f)
    assert rec["reason"] == "slo_breach"
    assert rec["breach"]["slo"] == "ttft" and rec["breach"]["trace_id"] == tid
    assert rec["engine_state"] == {"queue_depth": 3, "free_blocks": 7}
    kinds = [e["kind"] for e in rec["request_timeline"]["events"]]
    assert kinds == ["enqueue", "admit", "prefill_chunk"]
    ts = [e["t"] for e in rec["request_timeline"]["events"]]
    assert ts == sorted(ts)
    # the breach counter rides the registry; breadcrumb rides the recorder
    snap = t.registry.snapshot()
    assert snap["serving_slo_breach_total"]["series"][0]["value"] == 1
    assert any(e["kind"] == "slo_breach" for e in t.recorder.events())
    # rate limiting: with a long interval, breaches count but don't dump
    rt.breach_interval_s = 3600.0
    rt.slo_tbt_s = 0.01
    rt.observe_tbt(1, 0.5, n=2)
    assert rt.breaches == 2 and rt.breach_dumps == 1
    # a broken state probe must not kill the serving loop
    rt.breach_interval_s = 0.0
    rt.state_probe = lambda: 1 / 0
    rt.observe_ttft(1, 9.9)
    assert rt.breach_dumps == 2


# --------------------------------------------------------------------------
# chrome-trace export round trip
# --------------------------------------------------------------------------

def test_chrome_export_interleaves_request_timeline_with_spans(tmp_path):
    t, rt = _tracer()
    with t.span("dispatch", kind="prefill"):
        tid = rt.begin(5, tenant="acme", prompt=4)
        rt.event(5, "admit", blocks=1)
        rt.event(5, "prefill_chunk", tokens=4, T=4, rows=1)
    rt.event(5, "commit", tokens=1)
    rt.event(5, "release", pages=1)
    path = t.export_chrome_trace(str(tmp_path / "trace.json"))
    with open(path) as f:
        data = json.load(f)
    evs = data["traceEvents"]
    spans = [e for e in evs if e.get("pid", 0) == 0]
    reqs = [e for e in evs if e.get("pid") == 1]
    assert any(e["name"] == "dispatch" for e in spans)
    req_x = next(e for e in reqs if e["ph"] == "X")
    assert req_x["args"]["trace_id"] == tid
    instants = [e for e in reqs if e["ph"] == "i"]
    assert [e["name"] for e in instants] == \
        ["enqueue", "admit", "prefill_chunk", "commit", "release"]
    # same clock: the request's lifecycle interleaves the dispatch span
    disp = next(e for e in spans if e["name"] == "dispatch")
    admit = next(e for e in instants if e["name"] == "admit")
    assert disp["ts"] <= admit["ts"] <= disp["ts"] + disp["dur"] + 1
    assert any(e["ph"] == "M" and e["name"] == "thread_name" for e in reqs)


# --------------------------------------------------------------------------
# disabled = zero overhead
# --------------------------------------------------------------------------

def test_disabled_reqtrace_is_zero_overhead():
    t = Telemetry(enabled=True)                 # telemetry on, reqtrace off
    rt = t.reqtrace
    assert rt.enabled is False
    assert rt.begin(1, tenant="acme", prompt=4) is None
    for _ in range(200):
        rt.event(1, "commit", tokens=1)
        rt.observe_ttft(1, 0.5)
    assert rt.exemplar(1) is None
    assert len(rt._live) == 0 and len(rt._done) == 0    # no buffer growth
    assert len(rt._global) == 0
    assert rt.traces_started == 0 and rt.breaches == 0
    assert t.registry.snapshot() == {}          # no tenant series appeared
    assert rt.chrome_events(0.0) == []


def test_config_driven_configure_does_not_stomp_live_tracer():
    """TelemetryConfig's reqtrace knobs are tri-state (None = leave
    alone): a training job calling configure(config.telemetry) with
    defaults must not disable an env-/engine-enabled tracer or reset its
    sampling/thresholds (the knobs only apply when explicitly set)."""
    from deepspeed_tpu_torch.config import TelemetryConfig

    t = Telemetry(enabled=True)
    rt = t.reqtrace
    rt.enabled, rt.sample, rt.slo_ttft_s = True, 0.25, 1.5
    rt.breach_interval_s = 5.0
    cfg = TelemetryConfig(enabled=True)          # all reqtrace knobs unset
    kw = {}
    for k in ("reqtrace", "reqtrace_sample", "breach_interval_s",
              "slo_ttft_s", "peer_staleness_s", "breach_profile_s"):
        v = getattr(cfg, k, None)
        if v is not None:
            kw[k] = v
    t.reconfigure(**kw)                          # what configure() applies
    assert rt.enabled is True and rt.sample == 0.25
    assert rt.slo_ttft_s == 1.5 and rt.breach_interval_s == 5.0
    # explicit pin-off still works
    cfg2 = TelemetryConfig(enabled=True, reqtrace=False)
    assert cfg2.reqtrace is False
    t.reconfigure(reqtrace=cfg2.reqtrace)
    assert rt.enabled is False
    # RaggedInferenceConfig mirrors the tri-state: no implicit 1.0 resample
    from deepspeed_tpu_torch.inference.engine_v2 import RaggedInferenceConfig
    assert RaggedInferenceConfig().reqtrace_sample is None


def test_failed_admit_drop_leaves_no_tenant_series():
    """engine_v2.put() begins the trace BEFORE admit; when admit raises it
    drop()s the trace — no tenant series may remain (requests_total counts
    ADMITTED requests, so it increments on the admit event, not begin)."""
    t, rt = _tracer()
    rt.begin(1, tenant="acme", prompt=4)
    rt.drop(1)                                  # admit raised
    assert t.registry.snapshot() == {}
    rt.begin(2, tenant="acme", prompt=4)
    rt.event(2, "admit", blocks=1)
    fam = t.registry.snapshot()["serving_tenant_requests_total"]
    assert fam["series"][0]["value"] == 1


def test_timeline_ring_resize_and_reconfigure_knobs():
    """timeline_ring is a property that rebuilds the ring (a plain deque
    maxlen would make post-construction writes silent no-ops); both memory
    knobs flow through Telemetry.reconfigure()."""
    t, rt = _tracer()
    for uid in range(6):
        rt.begin(uid)
        rt.event(uid, "release", pages=0)
    assert len(rt.timelines()) == 6
    rt.timeline_ring = 2                        # shrink keeps the newest
    assert [x["uid"] for x in rt.timelines()] == [4, 5]
    t.reconfigure(reqtrace_timeline_ring=8, reqtrace_max_events=3)
    assert rt.timeline_ring == 8 and rt.max_events == 3
    rt.begin(10)
    for _ in range(5):
        rt.event(10, "commit", tokens=1)
    rt.event(10, "release", pages=0)
    tl = rt.timelines()[-1]
    assert len(tl["events"]) == 3 and tl["events_dropped"] == 4


def test_reqtrace_sample_validation_and_clear():
    t = Telemetry(enabled=True)
    with pytest.raises(ValueError):
        t.reconfigure(reqtrace_sample=1.5)
    t.reconfigure(reqtrace=True, reqtrace_sample=0.5, slo_ttft_s=2.0,
                  breach_interval_s=1.0)
    rt = t.reqtrace
    assert rt.enabled and rt.sample == 0.5 and rt.slo_ttft_s == 2.0
    rt.begin(1, tenant="a")
    rt.event(1, "release", pages=0)
    rt.clear()
    assert len(rt) == 0 and rt.traces_started == 0
    assert rt._labels == set()


# --------------------------------------------------------------------------
# engine integration (tiny fp32 models on the CPU)
# --------------------------------------------------------------------------

@pytest.fixture
def global_telem(tmp_path):
    t = T.get_telemetry()
    rt = t.reqtrace
    prev = (t.enabled, t.recorder.path, t.recorder.dumps, rt.enabled,
            rt.sample, rt.slo_ttft_s, rt.slo_tbt_s, rt.breach_interval_s,
            rt.state_probe)
    yield t
    t.reconfigure(enabled=prev[0])
    t.recorder.path, t.recorder.dumps = prev[1], prev[2]
    rt.enabled, rt.sample, rt.slo_ttft_s, rt.slo_tbt_s = prev[3:7]
    rt.breach_interval_s, rt.state_probe = prev[7], prev[8]
    rt.clear()


def _tiny_engine(tmp_path, **cfg_kw):
    from deepspeed_tpu_torch.inference.engine_v2 import (InferenceEngineV2,
                                                         RaggedInferenceConfig)
    from deepspeed_tpu_torch.models.transformer import (ModelConfig,
                                                        TransformerLM)

    mc = ModelConfig(vocab_size=128, hidden_size=64, num_layers=2,
                     num_heads=4, max_seq_len=256, dtype=torch.float32)
    kw = dict(block_size=8, num_blocks=64, max_seqs=2, chunk=8,
              max_seq_len=128, decode_window=4, max_inflight=2,
              telemetry=True, dtype=torch.float32, device="cpu")
    kw.update(cfg_kw)
    cfg = RaggedInferenceConfig(**kw)
    return InferenceEngineV2(TransformerLM(mc, device="cpu"), config=cfg)


def test_engine_breach_capture_end_to_end(tmp_path, global_telem):
    """The acceptance path: a forced TTFT breach produces a flight dump
    holding the offending request's complete monotonic timeline (admit →
    prefix hit → prefill chunks → decode/spec rounds → commit), and the
    matching TTFT bucket carries that request's trace ID as an exemplar."""
    t = global_telem
    t.reconfigure(enabled=True, breach_interval_s=0.0,
                  flight_recorder_path=str(tmp_path / "breach.json"))
    t.recorder.dumps = 0
    # ngram spec: a prompt covering the FULL vocab guarantees the 1-gram
    # prompt-lookup probe hits on whatever token the untrained model
    # samples -> spec_round events on the timeline, deterministically;
    # prefix cache (auto-on) gives the warm request a hit
    eng = _tiny_engine(tmp_path, reqtrace=True, slo_ttft_s=1e-9,
                       max_seq_len=192, spec_decode="ngram", spec_depth=2,
                       spec_max_nodes=4)
    rt = eng._rt
    t.registry.reset()
    rt.clear()
    prompt = list(range(128))                   # every vocab id appears
    eng.generate([prompt], max_new_tokens=6)
    eng.generate([prompt], max_new_tokens=4)    # warm: prefix-cache hit
    assert rt.breaches >= 2 and rt.breach_dumps >= 2

    dumps = []
    for i in range(1, rt.breach_dumps + 1):
        p = tmp_path / ("breach.json" if i == 1 else f"breach.json.{i}")
        with open(p) as f:
            dumps.append(json.load(f))
    assert all(d["reason"] == "slo_breach" for d in dumps)

    for d in dumps:
        tl = d["request_timeline"]
        kinds = [e["kind"] for e in tl["events"]]
        ts = [e["t"] for e in tl["events"]]
        assert ts == sorted(ts)                 # monotone end to end
        assert kinds[0] == "enqueue" and kinds[1] == "admit"
        assert "prefill_chunk" in kinds and "commit" in kinds
        # the breach fired on the first commit: the timeline is complete
        # up to it (decode/spec rounds follow in the live trace)
        st = d["engine_state"]
        assert st["num_blocks"] == 64 and "seqs" in st

    # the warm request's dump shows the prefix-cache hit extent at admit
    warm = dumps[-1]["request_timeline"]
    admit = next(e for e in warm["events"] if e["kind"] == "admit")
    assert admit["prefix_hit"] > 0 and admit["shared_blocks"] > 0

    # full lifecycle on the completed timeline, spec rounds included
    full = rt.timelines()[-1]
    kinds = [e["kind"] for e in full["events"]]
    assert kinds[0] == "enqueue" and kinds[-1] == "release"
    assert "spec_round" in kinds

    # exemplar linkage: a TTFT bucket carries a dumped request's trace ID
    # (each bucket keeps its MOST RECENT exemplar — when both requests
    # land in the same bucket only the later trace survives)
    ttft = global_telem.registry.snapshot()["serving_ttft_s"]["series"][0]
    ex_ids = {e[0] for e in ttft["exemplars"].values()}
    assert ex_ids & {d["breach"]["trace_id"] for d in dumps}
    _assert_wellformed(global_telem.registry.render_prometheus())
    _assert_wellformed(
        global_telem.registry.render_prometheus(exemplars=True),
        _OPENMETRICS_LINE)

    # chrome export from the live engine: request track + host spans
    path = global_telem.export_chrome_trace(str(tmp_path / "tr.json"))
    with open(path) as f:
        evs = json.load(f)["traceEvents"]
    assert any(e.get("pid") == 1 and e.get("ph") == "i"
               and e["name"] == "spec_round" for e in evs)
    assert any(e.get("pid", 0) == 0 and e["name"] == "dispatch"
               for e in evs)


def test_engine_tenant_attribution_and_summary(tmp_path, global_telem):
    t = global_telem
    t.reconfigure(enabled=True)
    # prefix cache pinned off: warm same-prompt admits would skip cached
    # tokens and skew the per-tenant prefill split under test
    eng = _tiny_engine(tmp_path, reqtrace=True, prefix_cache=False)
    rt = eng._rt
    t.registry.reset()
    rt.clear()
    uid = 0
    for tenant, n in (("acme", 2), ("globex", 1)):
        for _ in range(n):
            eng.put(uid, list(range(1, 12)), max_new_tokens=4,
                    tenant=tenant)
            while not eng.state.seqs[uid].done:
                eng.step()
            eng.flush(uid)
            uid += 1
    summary = t.tenant_summary()
    assert set(summary) == {"acme", "globex"}
    assert summary["acme"]["requests_total"] == 2
    assert summary["globex"]["requests_total"] == 1
    assert summary["acme"]["prefill_tokens_total"] == \
        2 * summary["globex"]["prefill_tokens_total"]
    assert summary["acme"]["kv_page_seconds_total"] > 0
    assert summary["acme"]["ttft_s"]["count"] == 2
    # timelines drained: every trace closed by release
    assert len(rt._live) == 0


def test_engine_reqtrace_disabled_is_zero_overhead(tmp_path, global_telem):
    """The zero-overhead gate: telemetry on, reqtrace pinned off — the
    serving loop must leave the tracer untouched (no buffer growth, no
    tenant series, no trace begun)."""
    t = global_telem
    t.reconfigure(enabled=True)
    eng = _tiny_engine(tmp_path, reqtrace=False)
    t.registry.reset()
    rt = eng._rt
    assert rt is not t.reqtrace                 # private pinned-off tracer
    assert rt.enabled is False
    eng.generate([list(range(1, 12))], max_new_tokens=4)
    assert len(rt._live) == 0 and len(rt._done) == 0
    assert rt.traces_started == 0
    snap = t.registry.snapshot()
    assert not any(n.startswith("serving_tenant_") for n in snap)
    assert "serving_slo_breach_total" not in snap
    # base SLO instruments still run (telemetry itself is on) but carry
    # no exemplars — those need a sampled trace
    assert "exemplars" not in snap["serving_ttft_s"]["series"][0]


# --------------------------------------------------------------------------
# the port's drift guard (the counterpart of bin/check_reqtrace_events.py,
# which scans the JAX package) and the breach capture's profiler trace
# --------------------------------------------------------------------------

def _emitted_kinds(root: str) -> dict[str, list[str]]:
    """Every literal lifecycle kind passed to ``<x>.event(uid, "<kind>",
    ...)`` under ``root``, by kind → sites; a non-literal kind is recorded
    as ``<dynamic>``."""
    import ast

    out: dict[str, list[str]] = {}
    for dirpath, _, files in os.walk(root):
        for fn in files:
            if not fn.endswith(".py"):
                continue
            path = os.path.join(dirpath, fn)
            with open(path) as f:
                tree = ast.parse(f.read(), path)
            for node in ast.walk(tree):
                if not (isinstance(node, ast.Call)
                        and isinstance(node.func, ast.Attribute)
                        and node.func.attr == "event"
                        and len(node.args) >= 2):
                    continue
                kind = node.args[1]
                key = kind.value if isinstance(kind, ast.Constant) \
                    else "<dynamic>"
                out.setdefault(key, []).append(f"{path}:{node.lineno}")
    return out


def test_port_reqtrace_drift_guard():
    """Every ``event()`` kind the port emits is declared in
    LIFECYCLE_EVENTS, and every declared kind is emitted somewhere in
    deepspeed_tpu_torch/ — both directions, as bin/check_reqtrace_events.py
    checks the JAX package; the tuple is the JAX package's."""
    import deepspeed_tpu_torch
    from deepspeed_tpu.telemetry import LIFECYCLE_EVENTS as JAX_EVENTS

    assert LIFECYCLE_EVENTS == JAX_EVENTS
    root = os.path.dirname(os.path.abspath(deepspeed_tpu_torch.__file__))
    emitted = _emitted_kinds(root)
    assert "<dynamic>" not in emitted, emitted.get("<dynamic>")
    undeclared = sorted(set(emitted) - set(LIFECYCLE_EVENTS))
    assert not undeclared, {k: emitted[k] for k in undeclared}
    never = sorted(set(LIFECYCLE_EVENTS) - set(emitted))
    assert not never, f"declared but never emitted by the port: {never}"


def test_breach_profile_capture_writes_a_chrome_trace(tmp_path,
                                                      global_telem):
    """``breach_profile_dir`` set: the first breach starts a bounded
    torch.profiler capture on the serving thread; it ends at the first
    lifecycle event past ``breach_profile_s`` and writes a Chrome trace
    that names the engine's ``dispatch`` ranges."""
    t = global_telem
    rt = t.reqtrace
    prev = (rt.breach_profile_dir, rt.breach_profile_s)
    try:
        prof_dir = tmp_path / "prof"
        t.reconfigure(enabled=True, breach_interval_s=0.0,
                      breach_profile_dir=str(prof_dir),
                      breach_profile_s=0.0,
                      flight_recorder_path=str(tmp_path / "b.json"))
        eng = _tiny_engine(tmp_path, reqtrace=True, slo_ttft_s=1e-9)
        eng.generate([list(range(1, 12))], max_new_tokens=6)
        assert rt.breaches >= 1
        assert rt.finish_profile() is None       # already ended and written
        traces = sorted(prof_dir.glob("breach_*.json"))
        assert traces, "the breach capture wrote no trace"
        with open(traces[0]) as f:
            names = {e.get("name") for e in json.load(f)["traceEvents"]}
        assert "dispatch" in names
    finally:
        rt.finish_profile()
        rt.breach_profile_dir, rt.breach_profile_s = prev
