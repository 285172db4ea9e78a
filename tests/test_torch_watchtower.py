"""Fleet watchtower: time-series store, alert rules, ops console.

Four layers under test:

- store units: disk roundtrip through the crc-framed segment format,
  rotation + retention (oldest whole segments out, active survives),
  torn tails counted-and-skipped (never fatal), counter-restart
  re-basing, and the rate()'s 0.0-vs-None contract (a stalled counter
  IS a signal; a never-seen series is not);
- numerics: rate() and window percentiles against numpy references and
  against the live registry's own estimator, robust z-score against a
  hand-computed median/MAD baseline;
- rule lifecycle units, driven on a memory-only store with synthetic
  sample ticks: pending -> firing -> resolved, dedup by fingerprint,
  per-rule notification rate limits, guard suppression, vanished
  per-source auto-resolve;
- the multiprocess acceptance path: an injected replica hang in a real
  fleet takes replica_stalled from pending to firing within two sample
  ticks, cuts exactly ONE black-box dump carrying the alert
  fingerprint, resolves after recovery, and the port's ``ds_top --once``
  renders the fleet table with the firing alert — plus the
  zero-overhead gate: watchtower off (the default) constructs no
  store, no alert manager, no sampler thread, no new metric families.

The port's copy of ``tests/test_watchtower.py``, over
``deepspeed_tpu_torch``: its router, its replicas (spawned as ``python -m
deepspeed_tpu_torch.serving.replica``) and its telemetry. Engine legs run
the port's engine in fp32 on the CPU (``"device": "cpu"``, one torch thread
a replica) and are tier-1 here; waits poll for their condition under
generous deadlines.
"""
import glob
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from deepspeed_tpu_torch.telemetry.alerts import (ZSCORE_MIN_SAMPLES,
                                                  AlertManager, AlertRule,
                                                  default_fleet_rules)
from deepspeed_tpu_torch.telemetry.metrics import MetricsRegistry
from deepspeed_tpu_torch.telemetry.recorder import prune_dump_dir
from deepspeed_tpu_torch.telemetry.timeseries import (TimeSeriesStore,
                                                      series_key)
from tests.test_torch_serving import restore_telemetry  # noqa: F401

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _reg_snapshot(counter=None, gauge=None, hist_obs=None):
    """Build a real registry snapshot carrying the given values."""
    r = MetricsRegistry()
    for name, v in (counter or {}).items():
        r.counter(name).inc(v)
    for name, v in (gauge or {}).items():
        r.gauge(name).set(v)
    for name, obs in (hist_obs or {}).items():
        h = r.histogram(name)
        for v in obs:
            h.observe(v)
    return r.snapshot()


# ---------------------------------------------------------------------------
# store units: roundtrip / rotation / retention / torn tail / deltas
# ---------------------------------------------------------------------------

def test_store_disk_roundtrip_replays_identically(tmp_path):
    d = str(tmp_path / "ts")
    s = TimeSeriesStore(d)
    t0 = 1000.0
    for i in range(6):
        s.sample("router",
                 _reg_snapshot(counter={"serving_x_total": 3 * (i + 1)},
                               gauge={"serving_live": float(i)}),
                 now=t0 + i)
    pts = s.range("serving_x_total")
    gpts = s.range("serving_live")
    r = s.rate("serving_x_total", 5.0, now=t0 + 5)
    s.close()

    s2 = TimeSeriesStore(d)                     # replay from disk
    assert s2.bad_records == 0
    assert s2.range("serving_x_total") == pts
    assert s2.range("serving_live") == gpts
    assert s2.rate("serving_x_total", 5.0, now=t0 + 5) == r
    assert s2.sources() == ["router"]
    # counters re-accumulate within the window: 6 samples x delta 3
    assert pts[-1][1] == pytest.approx(18.0)
    # gauges are raw last-write points
    assert gpts == [(t0 + i, float(i)) for i in range(6)]
    s2.close()


def test_store_rotation_and_retention_never_eats_active_segment(tmp_path):
    d = str(tmp_path / "ts")
    s = TimeSeriesStore(d, segment_bytes=512, retention_bytes=1536)
    for i in range(200):
        s.sample("router", _reg_snapshot(counter={"serving_x_total": i + 1}),
                 now=1000.0 + i)
    assert s.segments_pruned > 0
    segs = s.segments()
    assert len(segs) >= 2
    # retention holds: caps are checked after each rotation, so at most
    # one freshly-opened segment of slack beyond the cap
    assert s.disk_bytes() <= s.retention_bytes + s.segment_bytes
    # the active (newest) segment is the highest index present
    idx = [int(os.path.basename(p)[3:11]) for p in segs]
    assert idx == sorted(idx)
    # replay after retention still never raises and serves queries
    s.close()
    s2 = TimeSeriesStore(d)
    assert s2.rate("serving_x_total", 10.0, now=1000.0 + 199) is not None
    s2.close()


def test_store_torn_tail_and_corruption_skipped_not_fatal(tmp_path):
    d = str(tmp_path / "ts")
    s = TimeSeriesStore(d)
    for i in range(4):
        s.sample("router", _reg_snapshot(gauge={"serving_live": float(i)}),
                 now=1000.0 + i)
    s.close()
    seg = s.segments()[-1]
    with open(seg, "ab") as f:
        f.write(b'{"t": 2000.0, "src": "router"')       # torn tail (no crc)
        f.write(b"\n")
        f.write(b'{"bad": "json"|deadbeef\n')           # crc mismatch
        f.write(b"garbage-without-frame\n")
    s2 = TimeSeriesStore(d)
    assert s2.bad_records == 3
    assert s2.range("serving_live") == [(1000.0 + i, float(i))
                                        for i in range(4)]
    s2.close()


def test_counter_restart_rebases_instead_of_negative_spike():
    s = TimeSeriesStore()                # memory-only: no disk I/O at all
    s.sample("r0", _reg_snapshot(counter={"serving_x_total": 100}), now=1.0)
    s.sample("r0", _reg_snapshot(counter={"serving_x_total": 104}), now=2.0)
    # restart: the counter comes back smaller; delta re-bases to the new
    # absolute value rather than recording -99
    s.sample("r0", _reg_snapshot(counter={"serving_x_total": 5}), now=3.0)
    pts = s.range("serving_x_total", src="r0")
    deltas = [pts[0][1]] + [b - a for (_t, a), (_u, b) in zip(pts, pts[1:])]
    assert deltas == [100.0, 4.0, 5.0]
    assert s.segments() == [] and s.disk_bytes() == 0


def test_rate_zero_for_quiet_series_none_for_unknown():
    s = TimeSeriesStore()
    s.sample("r0", _reg_snapshot(counter={"serving_x_total": 10}), now=1.0)
    # counter stops moving: later samples carry no delta, but the series
    # was SEEN -> 0.0 (a stalled counter is the replica_stalled signal)
    s.sample("r0", _reg_snapshot(counter={"serving_x_total": 10}), now=50.0)
    assert s.rate("serving_x_total", 5.0, now=50.0) == 0.0
    assert s.rate("serving_never_total", 5.0, now=50.0) is None
    assert s.seen("serving_x_total") and not s.seen("serving_never_total")


def test_series_key_and_label_matching():
    k = series_key("serving_x_total", {"b": "2", "a": "1"})
    assert k == 'serving_x_total{a="1",b="2"}'     # sorted, stable
    s = TimeSeriesStore()
    r = MetricsRegistry()
    r.counter("serving_x_total", labels={"phase": "decode"}).inc(4)
    r.counter("serving_x_total", labels={"phase": "prefill"}).inc(6)
    s.sample("r0", r.snapshot(), now=1.0)
    assert s.range("serving_x_total")[-1][1] == pytest.approx(10.0)
    assert s.range("serving_x_total",
                   labels={"phase": "decode"})[-1][1] == pytest.approx(4.0)


# ---------------------------------------------------------------------------
# numerics: rate / percentile / z-score vs references
# ---------------------------------------------------------------------------

def test_rate_matches_numpy_reference():
    rng = np.random.default_rng(7)
    incs = rng.integers(0, 50, size=40)
    s = TimeSeriesStore()
    total = 0
    t0 = 1000.0
    for i, inc in enumerate(incs):
        total += int(inc)
        s.sample("r0", _reg_snapshot(counter={"serving_x_total": total}),
                 now=t0 + i)
    for w in (5.0, 11.0, 39.0):
        now = t0 + 39
        # the store's window scan is inclusive both ends
        ts = t0 + np.arange(40)
        mask = (ts >= now - w) & (ts <= now)
        expect = float(incs[mask].sum()) / w
        assert s.rate("serving_x_total", w, now=now) == pytest.approx(expect)


def test_window_percentile_matches_live_histogram_estimator():
    """Over a window covering everything, the store's bucket-delta
    percentile equals the registry's own lifetime estimator — the two
    code paths must agree or ds_top and /metrics would contradict."""
    rng = np.random.default_rng(3)
    obs = rng.gamma(2.0, 0.05, size=500).tolist()
    reg = MetricsRegistry()
    h = reg.histogram("serving_router_ttft_s")
    for v in obs:
        h.observe(v)
    s = TimeSeriesStore()
    s.sample("router", reg.snapshot(), now=10.0)
    for q in (0.5, 0.9, 0.95, 0.99):
        # the live estimator takes q in [0, 100]; the store in [0, 1]
        assert s.percentile("serving_router_ttft_s", q, 60.0, now=10.0) \
            == pytest.approx(h.percentile(q * 100.0))


def test_percentile_series_is_windowed_not_lifetime():
    """The sparkline feed reflects the trailing window: after latency
    steps up, the windowed p95 leaves the old regime behind while the
    lifetime estimator still averages both."""
    reg = MetricsRegistry()
    h = reg.histogram("serving_router_ttft_s")
    s = TimeSeriesStore()
    for i in range(10):
        h.observe(0.01)
        s.sample("router", reg.snapshot(), now=100.0 + i)
    for i in range(10):
        h.observe(1.5)
        s.sample("router", reg.snapshot(), now=110.0 + i)
    series = s.percentile_series("serving_router_ttft_s", 0.95,
                                 window_s=3.0)
    assert series[0][1] < 0.1          # early window: all-fast regime
    assert series[-1][1] > 1.0         # late window: all-slow regime
    assert h.percentile(95.0) > 1.0    # lifetime blends; window separates


def test_zscore_rule_matches_numpy_median_mad():
    """The zscore kind reproduces (v - median) / (1.4826 * MAD + eps)
    over the rolling baseline, and only trips on a genuine outlier."""
    rule = AlertRule(name="z", metric="serving_g", query="latest",
                     kind="zscore", z=3.5, baseline_s=1e6, for_s=0.0,
                     src="r0")
    mgr = AlertManager([rule])
    s = TimeSeriesStore()
    rng = np.random.default_rng(11)
    vals = (10.0 + rng.normal(0.0, 0.05, size=32)).tolist()
    t = 1000.0
    for v in vals:
        s.sample("r0", _reg_snapshot(gauge={"serving_g": v}), now=t)
        mgr.evaluate(s, now=t)
        t += 1.0
    assert not mgr.active()            # steady signal: nothing fires
    spike = 25.0
    s.sample("r0", _reg_snapshot(gauge={"serving_g": spike}), now=t)
    fired = mgr.evaluate(s, now=t)
    assert len(fired) == 1
    base = np.asarray(vals)            # baseline excludes the spike itself
    med = float(np.median(base))
    mad = float(np.median(np.abs(base - med)))
    expect = (spike - med) / (1.4826 * mad + 1e-9)
    assert fired[0].zscore == pytest.approx(expect, rel=1e-9)
    assert fired[0].zscore > 3.5


def test_zscore_needs_minimum_baseline():
    rule = AlertRule(name="z", metric="serving_g", query="latest",
                     kind="zscore", z=1.0, src="r0")
    mgr = AlertManager([rule])
    s = TimeSeriesStore()
    for i in range(ZSCORE_MIN_SAMPLES):
        s.sample("r0", _reg_snapshot(gauge={"serving_g": 1e9 * i}),
                 now=100.0 + i)
        assert mgr.evaluate(s, now=100.0 + i) == []
    assert not mgr.active()            # wild values, but baseline too thin


# ---------------------------------------------------------------------------
# rule lifecycle: pending -> firing -> resolved, dedup, rate limit, guard
# ---------------------------------------------------------------------------

def _gauge_tick(store, mgr, value, now, src="router"):
    store.sample(src, _reg_snapshot(gauge={"serving_g": value}), now=now)
    return mgr.evaluate(store, now=now)


def test_lifecycle_pending_firing_resolved_and_dedup():
    reg = MetricsRegistry()
    rule = AlertRule(name="hot", metric="serving_g", query="latest",
                     op=">", value=5.0, for_s=2.0, severity="critical",
                     src="router", rate_limit_s=0.0)
    mgr = AlertManager([rule], registry=reg)
    s = TimeSeriesStore()
    assert _gauge_tick(s, mgr, 9.0, now=100.0) == []     # true -> pending
    a = mgr.active()[0]
    # a src-pinned rule fingerprints as rule/source, like per_source ones
    assert a.state == "pending" and a.fingerprint == "hot/router"
    assert _gauge_tick(s, mgr, 9.0, now=101.0) == []     # still holding
    fired = _gauge_tick(s, mgr, 9.0, now=102.0)          # for_s met
    assert [x.fingerprint for x in fired] == ["hot/router"]
    assert fired[0].state == "firing" and fired[0].notified
    # dedup: staying true keeps ONE alert object, no re-fire per tick
    assert _gauge_tick(s, mgr, 9.0, now=103.0) == []
    assert len(mgr.active()) == 1 and mgr.firing()[0] is fired[0]
    # condition clears -> resolved, removed from active, kept for display
    assert _gauge_tick(s, mgr, 1.0, now=104.0) == []
    assert mgr.active() == []
    d = mgr.to_dict()
    assert d["resolved"][-1]["rule"] == "hot"
    assert d["resolved"][-1]["state"] == "resolved"
    assert d["firing"] == 0
    # metrics: one fire transition counted, firing gauge back to 0
    snap = reg.snapshot()
    tot = {tuple(sorted(x["labels"].items())): x["value"]
           for x in snap["serving_alerts_total"]["series"]}
    assert tot[(("rule", "hot"), ("severity", "critical"))] == 1
    fir = {x["value"] for x in snap["serving_alerts_firing"]["series"]}
    assert fir == {0.0}


def test_notification_rate_limit_throttles_flapping():
    rule = AlertRule(name="flap", metric="serving_g", query="latest",
                     op=">", value=5.0, for_s=0.0, src="router",
                     rate_limit_s=100.0)
    mgr = AlertManager([rule])
    s = TimeSeriesStore()
    assert len(_gauge_tick(s, mgr, 9.0, now=10.0)) == 1   # first: notified
    _gauge_tick(s, mgr, 1.0, now=11.0)                    # resolve
    fired = _gauge_tick(s, mgr, 9.0, now=12.0)            # re-fire < limit
    assert fired == []                                    # throttled...
    a = mgr.firing()[0]
    assert a.state == "firing" and not a.notified         # ...but tracked
    _gauge_tick(s, mgr, 1.0, now=13.0)
    assert len(_gauge_tick(s, mgr, 9.0, now=200.0)) == 1  # limit elapsed


def test_per_source_guard_and_vanished_source_resolution():
    """The replica_stalled shape: per-source rate rule whose guard reads
    a router gauge labelled by the source's trailing digits."""
    rule = AlertRule(
        name="stalled", metric="serving_replica_tokens_total",
        query="rate", op="<=", value=0.0, window_s=4.0, for_s=0.0,
        per_source="replica", rate_limit_s=0.0,
        guard={"metric": "serving_router_replica_live", "src": "router",
               "op": ">", "value": 0.0, "labels_from_source": "replica"})
    mgr = AlertManager([rule])
    s = TimeSeriesStore()

    def tick(now, tok0, live0):
        r = MetricsRegistry()
        r.counter("serving_replica_tokens_total").inc(tok0)
        s.sample("replica0", r.snapshot(), now=now)
        g = MetricsRegistry()
        g.gauge("serving_router_replica_live",
                labels={"replica": "0"}).set(live0)
        s.sample("router", g.snapshot(), now=now)
        return mgr.evaluate(s, now=now)

    tick(10.0, tok0=5, live0=1.0)       # warm-up: tokens flowing
    assert mgr.active() == []
    # stall with live sequences: rate over the window decays to 0
    fired = tick(20.0, tok0=5, live0=1.0)
    assert [a.fingerprint for a in fired] == ["stalled/replica0"]
    assert fired[0].source == "replica0"
    # same stall with the guard failing (live=0, replica is just idle):
    # fresh manager so the fingerprint isn't already active
    mgr2 = AlertManager([rule])
    s2 = TimeSeriesStore()
    r = MetricsRegistry()
    r.counter("serving_replica_tokens_total").inc(5)
    s2.sample("replica0", r.snapshot(), now=10.0)
    g = MetricsRegistry()
    g.gauge("serving_router_replica_live", labels={"replica": "0"}).set(0.0)
    s2.sample("router", g.snapshot(), now=10.0)
    s2.sample("replica0", r.snapshot(), now=20.0)
    assert mgr2.evaluate(s2, now=20.0) == []
    assert mgr2.active() == []          # idle, not stalled: suppressed
    # vanished source: a fresh store that never saw replica0 -> the
    # per-source alert auto-resolves instead of firing forever
    assert any(a.fingerprint == "stalled/replica0" for a in mgr.active())
    mgr.evaluate(TimeSeriesStore(), now=30.0)
    assert mgr.active() == []


def test_elastic_hints_only_while_firing():
    rule = AlertRule(name="ttft_hot", metric="serving_g", query="latest",
                     op=">", value=5.0, for_s=0.0, src="router",
                     rate_limit_s=0.0, hint_role="prefill",
                     hint_direction="up")
    mgr = AlertManager([rule])
    s = TimeSeriesStore()
    assert mgr.elastic_hints() == []
    _gauge_tick(s, mgr, 9.0, now=10.0)
    hints = mgr.elastic_hints()
    assert len(hints) == 1 and hints[0][:2] == ("prefill", "up")
    _gauge_tick(s, mgr, 1.0, now=11.0)
    assert mgr.elastic_hints() == []


def test_default_rule_pack_scales_with_tick_and_validates():
    rules = default_fleet_rules(sample_interval_s=0.2)
    names = [r.name for r in rules]
    assert names == ["replica_stalled", "breaker_open",
                     "tier_fallback_spike", "journal_bytes_growth",
                     "clock_offset_blowup"]
    stall = rules[0]
    assert stall.window_s == pytest.approx(0.8)       # 4 * dt
    assert stall.severity == "critical" and stall.guard is not None
    with_slo = default_fleet_rules(slo_ttft_s=0.5)
    assert with_slo[1].name == "ttft_slo_trend"
    assert with_slo[1].hint_role == "prefill"
    with pytest.raises(ValueError):
        AlertRule(name="bad rule name!", metric="m")
    with pytest.raises(ValueError):
        AlertRule(name="x", metric="m", severity="page")


# ---------------------------------------------------------------------------
# dump-dir retention (recorder satellite)
# ---------------------------------------------------------------------------

def test_prune_dump_dir_caps_count_and_bytes_scoped_by_prefix(tmp_path):
    d = str(tmp_path)
    for i in range(8):
        p = os.path.join(d, f"fleet_blackbox_{i}.json")
        with open(p, "w") as f:
            f.write("x" * 100)
        os.utime(p, (1000.0 + i, 1000.0 + i))
    keeper = os.path.join(d, "journal-000001.log")      # different family
    with open(keeper, "w") as f:
        f.write("y" * 100)
    reg = MetricsRegistry()
    removed = prune_dump_dir(d, max_files=3, max_bytes=10 ** 9,
                             prefix="fleet_blackbox_", registry=reg)
    assert removed == 5
    left = sorted(os.path.basename(p)
                  for p in glob.glob(os.path.join(d, "fleet_blackbox_*")))
    assert left == [f"fleet_blackbox_{i}.json" for i in (5, 6, 7)]
    assert os.path.exists(keeper)                       # out of scope
    snap = reg.snapshot()
    assert snap["telemetry_dumps_pruned_total"]["series"][0]["value"] == 5
    # byte cap alone: 3 files x 100 B, cap 150 -> oldest out, newest kept
    removed = prune_dump_dir(d, max_files=100, max_bytes=150,
                             prefix="fleet_blackbox_")
    assert removed == 2
    assert glob.glob(os.path.join(d, "fleet_blackbox_*")) \
        == [os.path.join(d, "fleet_blackbox_7.json")]
    # missing directory: best-effort no-op
    assert prune_dump_dir(os.path.join(d, "nope")) == 0


# ---------------------------------------------------------------------------
# multiprocess acceptance: injected stall -> alert -> dump -> ds_top
# ---------------------------------------------------------------------------

@pytest.mark.multiprocess
def test_injected_stall_fires_once_dumps_once_resolves_renders(tmp_path):
    """THE acceptance path. A replica hangs mid-stream (injected fault)
    while the router still believes it holds live sequences:
    replica_stalled goes pending -> firing within two sample ticks of
    the stall being observable, exactly ONE black-box dump lands with
    the alert fingerprint as its trigger, the alert resolves once the
    replica recovers, and the port's ``ds_top --once`` renders the fleet table
    with the store + rules visible."""
    from deepspeed_tpu_torch.serving import FleetConfig, Router, RouterConfig
    from deepspeed_tpu_torch.telemetry import get_telemetry

    get_telemetry().reset_metrics()
    bb_dir = str(tmp_path / "bb")
    snap_dir = str(tmp_path / "snap")
    router = Router(RouterConfig(
        fleet=FleetConfig(
            n_replicas=1,
            replica={"backend": "toy", "block_size": 16, "max_live": 8,
                     "vocab": 64, "hb_interval_s": 0.02,
                     "tokens_per_step": 2},
            # warm-up first (40 chunks) so the token counter and live
            # gauge are in the store BEFORE the 2 s full hang
            per_slot={"0": {"faults": {"replica_hang_after_chunks": 40,
                                       "replica_hang_s": 2.0}}},
            # liveness must NOT reap the hung replica before the
            # watchtower sees the stall — that is the liveness layer's
            # test, not this one
            hb_timeout_s=10.0, backoff_base_s=0.05,
            log_dir=str(tmp_path / "logs"),
            snapshot_dir=snap_dir),
        telemetry=True, watchtower=True, watchtower_interval_s=0.1,
        fleet_trace_dir=bb_dir, request_timeout_s=20.0))
    try:
        router.start(min_ready=1)
        tids = [router.submit(list(range(8)), max_new_tokens=120)
                for _ in range(2)]
        transitions = []        # (t, state) edges of the stall alert
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            router.poll()
            for a in router._alerts.active():
                if a.rule == "replica_stalled":
                    if not transitions or transitions[-1][1] != a.state:
                        transitions.append((time.monotonic(), a.state))
            done = all(router.result(t)["status"] not in
                       ("queued", "assigned", "recovering", "gang")
                       for t in tids)
            resolved = any(a.fingerprint == "replica_stalled/replica0"
                           for a in list(router._alerts._resolved))
            if done and resolved:
                break
        res = router.results()
        assert all(res[t]["status"] == "done" for t in tids), res

        # lifecycle: pending observed, then firing, then resolved
        states = [st for (_t, st) in transitions]
        assert "pending" in states and "firing" in states, transitions
        t_pending = next(t for (t, st) in transitions if st == "pending")
        t_firing = next(t for (t, st) in transitions if st == "firing")
        # pending -> firing within two sample ticks (for_s = 1 tick)
        assert t_firing - t_pending <= 2 * 0.1 + 0.25
        assert any(a.fingerprint == "replica_stalled/replica0"
                   for a in router._alerts._resolved)

        # exactly ONE dump, and it carries the fingerprint as trigger
        dumps = glob.glob(os.path.join(bb_dir, "fleet_blackbox_*"))
        assert len(dumps) == 1, dumps
        with open(dumps[0], encoding="utf-8") as f:
            rec = json.load(f)
        trig = rec["fleet"]["trigger"]
        assert trig["kind"] == "alert"
        assert trig["rule"] == "replica_stalled"
        assert trig["fingerprint"] == "replica_stalled/replica0"
        assert trig["severity"] == "critical"

        # alert metrics made it to the registry
        snap = router._telem.snapshot()
        tot = {s["labels"]["rule"]: s["value"]
               for s in snap["serving_alerts_total"]["series"]}
        assert tot.get("replica_stalled", 0) >= 1
        assert snap["serving_watch_samples_total"]["series"][0]["value"] > 0

        # fleet health advertises the watchtower; store holds both srcs
        health = router.fleet_health()
        assert health["watchtower"] is True
        assert set(router._watch.sources()) >= {"router", "replica0"}

        # the port's ds_top (python -m deepspeed_tpu_torch.telemetry.console
        # --once) against the live endpoint renders the frame
        port = router._telem.start_http(0)
        out = subprocess.run(
            [sys.executable, "-m", "deepspeed_tpu_torch.telemetry.console",
             "--once", "--url", f"http://127.0.0.1:{port}"],
            capture_output=True, text=True, timeout=60, cwd=ROOT)
        assert out.returncode == 0, out.stderr
        assert "fleet watchtower" in out.stdout
        assert "slot" in out.stdout and "mixed" in out.stdout
        assert "rules loaded" in out.stdout or "alerts" in out.stdout
        assert "store:" in out.stdout

        # /alerts payload is JSON-serving and carries store stats
        payload = router._alerts_payload()
        json.dumps(payload)
        assert payload["store"]["records"] > 0
        assert any(r["name"] == "replica_stalled"
                   for r in payload["rules"])
    finally:
        router.close()
    # store closed with the router: fd released, queries still work
    assert router._watch._fd < 0


@pytest.mark.multiprocess
def test_watchtower_off_is_zero_overhead(tmp_path):
    """The disabled gate: default config constructs no store, no alert
    manager, no sampler thread, and a full request lifecycle mints no
    watchtower metric families."""
    from deepspeed_tpu_torch.serving import FleetConfig, Router, RouterConfig
    from deepspeed_tpu_torch.telemetry import get_telemetry

    get_telemetry().reset_metrics()
    router = Router(RouterConfig(
        fleet=FleetConfig(
            n_replicas=1,
            replica={"backend": "toy", "block_size": 16, "max_live": 8,
                     "vocab": 64, "hb_interval_s": 0.02,
                     "tokens_per_step": 2},
            hb_timeout_s=2.0, backoff_base_s=0.05,
            log_dir=str(tmp_path / "logs")),
        telemetry=True, request_timeout_s=20.0))
    try:
        router.start(min_ready=1)
        tid = router.submit(list(range(8)), max_new_tokens=8)
        res = router.run(deadline_s=60)
        assert res[tid]["status"] == "done"
        assert router._watch is None and router._alerts is None
        assert router.fleet_health()["watchtower"] is False
        snap = router._telem.snapshot()
        assert not any(f.startswith(("serving_alerts_",
                                     "serving_watch_")) for f in snap)
        assert "serving_router_replica_live" not in snap
        assert not any("watchtower" in (t.name or "")
                       for t in threading.enumerate())
    finally:
        router.close()
