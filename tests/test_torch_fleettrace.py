"""Fleet-wide distributed tracing: cross-replica trace assembly,
clock-aligned black-box postmortems, straggler detection.

Three layers under test:

- host-only units: ClockSync recovers injected offsets from RTT-midpoint
  samples, StragglerScorer flags the outlier replica and nothing else,
  FleetTraceAssembler merges router events + skewed replica segments
  into causal order with bounded memory, the postmortem renderer
  tolerates whole missing sections, and the reqtrace/recorder satellites
  (wall clocks on every event, canonical trace-ID adoption);
- the multiprocess acceptance path: a role-split prefill->decode fleet
  under INJECTED clock skew (whole seconds — unaligned merges would be
  garbage) produces one merged clock-aligned timeline per request, a
  forced TTFT breach produces exactly ONE rate-limited black-box dump
  containing both replicas' segments and the router relay phase in
  causal order, the port's ``postmortem_cli`` renders it, and the fleet Chrome
  export carries one track per process;
- chaos: a replica SIGKILLed mid-request still yields a dump assembled
  from router-side events plus the surviving replica, and requests
  replay bit-identically (the failover story, now observable);
- the zero-overhead gate: fleet_trace=False (the default) constructs
  nothing, ships nothing, pings nothing — matching the telemetry gates.

The port's copy of ``tests/test_fleettrace.py``, over
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
import tempfile
import time

import pytest

from deepspeed_tpu_torch.serving import (FleetConfig, Router, RouterConfig,
                                         TraceConfig, synth_trace)
from deepspeed_tpu_torch.serving.replica import _mix
from deepspeed_tpu_torch.telemetry.fleettrace import (ClockSync,
                                                      FleetTraceAssembler,
                                                      StragglerScorer,
                                                      postmortem_report)
from tests.test_torch_serving import restore_telemetry  # noqa: F401

#: replica logs of these tests, under the run's own temporary directory
TMP_ROOT = tempfile.gettempdir()

VOCAB = 1024
HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
#: the port's ``ds_postmortem``: its fleettrace's CLI over argv
POSTMORTEM_CLI = ("import sys; from deepspeed_tpu_torch.telemetry.fleettrace "
                  "import postmortem_cli; sys.exit(postmortem_cli())")


def toy_stream(prompt, n, vocab=VOCAB):
    seed = 0
    for t in prompt:
        seed = _mix(seed, int(t))
    out = []
    for i in range(n):
        seed = _mix(seed, i)
        out.append((seed >> 33) % vocab)
    return out


# ---------------------------------------------------------------------------
# units: clock sync / straggler scoring / assembly / postmortem
# ---------------------------------------------------------------------------

def test_clock_sync_recovers_offset_and_prefers_low_rtt():
    cs = ClockSync(window=8)
    # a noisy exchange inflates both rtt and the midpoint error; the
    # low-rtt sample must win
    cs.note(0, rtt_s=0.080, offset_s=5.03)
    cs.note(0, rtt_s=0.002, offset_s=5.001)
    cs.note(0, rtt_s=0.050, offset_s=4.98)
    off, err = cs.offset(0)
    assert abs(off - 5.001) < 1e-9
    assert err == pytest.approx(0.001)
    assert cs.rtt(0) == pytest.approx(0.002)
    # unknown slot: identity alignment, explicit "no estimate"
    assert cs.offset(7) == (0.0, None)
    # samples key by INCARNATION: a successor epoch on a different
    # clock base serves its own estimate, the dead epoch keeps its own
    # (its buffered segments still need alignment), and an epoch that
    # never ping-round-tripped merges UNALIGNED rather than wrongly
    cs.note(0, 0.002, -2.0, epoch=1)
    assert cs.offset(0, 0)[0] == pytest.approx(5.001)
    assert cs.offset(0, 1)[0] == pytest.approx(-2.0)
    assert cs.offset(0)[0] == pytest.approx(-2.0)     # newest epoch
    assert cs.offset(0, 2) == (0.0, None)
    # retention is bounded per slot: only the newest keep_epochs stay
    for e in range(10):
        cs.note(3, 0.001, float(e), epoch=e)
    assert sorted(k[1] for k in cs._samples if k[0] == 3) == \
        [6, 7, 8, 9]
    # explicit forget drops every epoch
    cs.forget(0)
    assert cs.offset(0) == (0.0, None)
    # bounded window: 100 samples keep only the newest 8
    for i in range(100):
        cs.note(1, 0.01 + i * 1e-4, 1.0)
    assert len(cs._samples[(1, 0)]) == 8
    d = cs.to_dict()
    assert "1.e0" in d and d["1.e0"]["samples"] == 8


def test_straggler_scorer_flags_only_the_outlier():
    sc = StragglerScorer(min_samples=8, z_threshold=3.0)
    for i in range(16):
        sc.note(0, "ttft", 0.010 + (i % 3) * 0.001)
        sc.note(1, "ttft", 0.011 + (i % 3) * 0.001)
        sc.note(2, "ttft", 0.250 + (i % 3) * 0.001)   # the straggler
    deg = sc.degraded()
    assert deg.get(2) is True
    assert not deg.get(0) and not deg.get(1)
    z = sc.scores()
    assert z[2]["ttft"] > 3.0
    # under min_samples nothing scores (no single-sample panics)
    sc2 = StragglerScorer(min_samples=8)
    sc2.note(0, "tbt", 9.0)
    sc2.note(1, "tbt", 0.1)
    assert sc2.scores() == {}
    # a dead slot's stale distribution leaves the comparison
    sc.forget_slot(2)
    assert not any(sc.degraded().values())


def test_assembler_aligns_skewed_segments_into_causal_order():
    asm = FleetTraceAssembler(max_requests=4, max_events=8)
    t0 = time.monotonic()
    asm.router_event("r-1", "enqueue", tenant="acme")
    asm.router_event("r-1", "placed", slot=0)
    # replica 0 runs +100s skewed; its admit/chunk happened between the
    # router's placed and done events in REAL time — unaligned they
    # would sort ~100s after everything
    skew = 100.0
    asm.clock.note(0, rtt_s=0.002, offset_s=skew)
    asm.add_segment("r-1", 0, 0, 4242, [
        [t0 + skew + 0.010, 1e9, "admit", None],
        [t0 + skew + 0.020, 1e9, "chunk", {"n": 4}]], dropped=2)
    while time.monotonic() < t0 + 0.03:    # done AFTER the aligned chunk
        time.sleep(0.005)
    asm.router_event("r-1", "done")
    m = asm.assemble("r-1")
    kinds = [(e["src"], e["kind"]) for e in m["events"]]
    assert kinds == [("router", "enqueue"), ("router", "placed"),
                     ("replica0", "admit"), ("replica0", "chunk"),
                     ("router", "done")]
    assert m["events_dropped"] == 2
    assert m["clock"]["0"]["offset_s"] == pytest.approx(skew)
    # aligned replica events carry the uncertainty
    admit = m["events"][2]
    assert admit["err_s"] == pytest.approx(0.001)
    assert all(a["t"] <= b["t"] for a, b in zip(m["events"],
                                                m["events"][1:]))
    # dt is relative to the first event
    assert m["events"][0]["dt"] == 0.0
    # chrome fleet export: one track per process, metadata names both
    evs = asm.chrome_events()
    pids = {e["pid"] for e in evs}
    assert pids == {10, 11}
    names = {e["args"]["name"] for e in evs
             if e.get("name") == "process_name"}
    assert names == {"router", "replica0"}
    # unknown request: explicit None, not a crash
    assert asm.assemble("nope") is None


def test_assembler_memory_is_bounded():
    asm = FleetTraceAssembler(max_requests=4, max_events=4,
                              max_segments=2)
    for i in range(10):
        asm.router_event(f"r-{i}", "enqueue")
    assert len(asm) == 4 and not asm.has("r-0") and asm.has("r-9")
    for i in range(10):                   # head retention + drop count
        asm.router_event("r-9", f"k{i}")
    m = asm.assemble("r-9")
    assert len(m["events"]) == 4 and m["events_dropped"] == 7
    # per-request segment cap: a 3rd incarnation's segment is dropped
    for epoch in range(3):
        asm.add_segment("r-8", 0, epoch, 1, [[0.0, 0.0, "x", None]])
    assert len(asm._reqs["r-8"].segments) == 2
    assert asm.segments_dropped == 1
    # no clock samples for those incarnations: merged UNALIGNED and
    # flagged (err_s None), never aligned with someone else's offset
    m8 = asm.assemble("r-8")
    assert all(e["err_s"] is None for e in m8["events"]
               if e["src"] != "router")


def test_postmortem_report_renders_and_tolerates_missing_sections():
    rec = {"reason": "fleet_blackbox", "time": time.time(), "pid": 1,
           "detail": "ttft_breach (trace r-1)",
           "fleet": {
               "trigger": {"kind": "ttft_breach", "slo": "ttft",
                           "trace_id": "r-1", "value": 1.5,
                           "threshold": 0.5},
               "clock": {"0": {"offset_s": 5.0, "err_s": 0.001,
                               "rtt_s": 0.002}},
               "timeline": {"trace_id": "r-1", "events_dropped": 0,
                            "events": [
                                {"t": 1.0, "dt": 0.0, "wall": 2.0,
                                 "src": "router", "kind": "enqueue"},
                                {"t": 2.1, "dt": 1.1, "wall": 3.1,
                                 "src": "replica0", "kind": "admit",
                                 "err_s": 0.001, "slot": 0}]},
               "fleet_state": {"replicas": {"0": {"state": "ready",
                                                  "role": "prefill",
                                                  "epoch": 0}}},
               "health": {"degraded": [], "blackbox_dumps": 1,
                          "trace_segments": 3}}}
    out = postmortem_report(rec)
    assert "fleet postmortem" in out and "ttft_breach" in out
    assert "replica0" in out and "where the time went" in out
    assert "offset +5.000000s" in out
    # a dump with NO timeline (death trigger mid-crash) still renders
    out2 = postmortem_report({"reason": "fleet_blackbox",
                              "fleet": {"trigger": {"kind":
                                                    "replica_death"}}})
    assert "no request timeline" in out2
    # an empty record renders too — the renderer must never die on its input
    assert postmortem_report({})


def test_reqtrace_wall_clocks_and_trace_id_adoption():
    """Satellites: reqtrace/recorder events carry both clocks, and
    begin() adopts an externally minted canonical trace ID."""
    from deepspeed_tpu_torch.telemetry.recorder import FlightRecorder
    from deepspeed_tpu_torch.telemetry.reqtrace import ReqTracer
    from deepspeed_tpu_torch.telemetry.spans import SpanTracer

    rt = ReqTracer(enabled=True)
    tid = rt.begin(1, tenant="acme", prompt=8, trace_id="router-7")
    assert tid == "router-7"
    rt.event(1, "admit", blocks=2)
    rt.event(-5, "evict", pages=1)        # unattributed global ring
    tl = rt.live_timelines()[0]
    assert tl["trace_id"] == "router-7"
    assert tl["t_start_wall"] == pytest.approx(time.time(), abs=5.0)
    for e in tl["events"]:
        assert e["wall"] == pytest.approx(time.time(), abs=5.0)
    assert rt.global_events()[0]["wall"] == pytest.approx(time.time(),
                                                          abs=5.0)
    # minting still works when no canonical ID is supplied
    assert rt.begin(2) != "router-7"
    rec = FlightRecorder()
    rec.note("rewind", step=3)
    ev = rec.events()[0]
    assert ev["mono"] == pytest.approx(time.monotonic(), abs=5.0)
    assert ev["t"] == pytest.approx(time.time(), abs=5.0)
    assert "time_mono" in rec.record("x")
    # a dump carries the span clock's wall anchor so span t0s (mono-only
    # per span) correlate with external logs: wall ≈ epoch_wall + (t0 -
    # span_epoch)
    tr = SpanTracer(capacity=4)
    assert tr.epoch_wall == pytest.approx(time.time(), abs=5.0)
    d = FlightRecorder(tracer=tr).record("x")
    assert d["span_epoch"] == tr._epoch
    assert d["span_epoch_wall"] == tr.epoch_wall


def test_trace_endpoint_serves_live_timeline():
    """/trace on the telemetry endpoint returns the live process
    timeline (host spans + request lifecycles) as Chrome trace JSON —
    a postmortem can pull any process's view over HTTP."""
    import urllib.request

    from deepspeed_tpu_torch.telemetry import Telemetry

    t = Telemetry(enabled=True)
    t.reqtrace.enabled = True
    t.reqtrace.begin(1, tenant="acme", trace_id="r-9")
    with t.span("dispatch"):
        pass
    port = t.start_http(0)
    try:
        body = urllib.request.urlopen(
            f"http://127.0.0.1:{port}/trace", timeout=5).read()
    finally:
        t.stop_http()
    data = json.loads(body)
    names = {e.get("name") for e in data["traceEvents"]}
    assert "dispatch" in names
    assert any("r-9" in str(e.get("args", {})) for e in
               data["traceEvents"])


def test_fleet_trace_disabled_constructs_nothing(tmp_path):
    """The zero-overhead gate, structural half: the default config
    builds no assembler, no scorer, and does not flip the replica
    template knob — replicas then record and ship nothing."""
    r = Router(RouterConfig())
    assert r._ftrace is None and r._straggler is None
    assert "fleet_trace" not in r.cfg.fleet.replica
    assert r.fleet_health()["fleet_trace"] is False
    with pytest.raises(RuntimeError, match="disabled"):
        r.export_fleet_chrome(str(tmp_path / "nope.json"))


# ---------------------------------------------------------------------------
# multiprocess: end-to-end assembly, breach dump, chaos, zero overhead
# ---------------------------------------------------------------------------

def _fleet_router(roles, per_slot=None, replica=None, log_tag="ft",
                  **rkw):
    replica_cfg = {"backend": "toy", "block_size": 16, "max_live": 8,
                   "vocab": VOCAB, "hb_interval_s": 0.02,
                   "tokens_per_step": 2}
    replica_cfg.update(replica or {})
    fcfg = FleetConfig(
        n_replicas=len(roles), replica=replica_cfg, roles=list(roles),
        per_slot=per_slot or {},
        hb_timeout_s=rkw.pop("hb_timeout_s", 1.0), backoff_base_s=0.05,
        log_dir=os.path.join(TMP_ROOT, "ds_torch_fleettrace_tests", log_tag))
    return Router(RouterConfig(
        fleet=fcfg, request_timeout_s=rkw.pop("request_timeout_s", 10.0),
        max_retries=rkw.pop("max_retries", 3), **rkw))


def _idx(events, src, kind):
    for i, e in enumerate(events):
        if e["src"] == src and e["kind"] == kind:
            return i
    raise AssertionError(f"no event {src}:{kind} in "
                         f"{[(e['src'], e['kind']) for e in events]}")


@pytest.mark.multiprocess
def test_role_split_breach_one_dump_causal_order_under_skew(tmp_path):
    """THE acceptance path: 1 prefill + 1 decode replica with whole-
    second injected clock skews, a forced TTFT breach. One request
    crossing router + both replicas yields a single merged clock-aligned
    timeline, exactly ONE rate-limited black-box dump lands containing
    both replicas' segments and the router relay phase in causal order,
    ds_postmortem renders it, and the Chrome export has one track per
    process."""
    bb_dir = str(tmp_path / "bb")
    skews = {"0": {"clock_skew_s": 7.5}, "1": {"clock_skew_s": -4.25}}
    router = _fleet_router(
        ["prefill", "decode"], per_slot=skews,
        # real (simulated) compute so cross-process event gaps dwarf the
        # clock-alignment uncertainty (loopback rtt, single-digit ms)
        replica={"decode_delay_s": 0.02, "prefill_chunk": 64,
                 "prefill_delay_s": 0.08},
        log_tag="breach", telemetry=True,
        fleet_trace=True, fleet_trace_slo_ttft_s=1e-4,
        fleet_trace_dir=bb_dir, clock_sync_interval_s=0.05)
    trace = synth_trace(TraceConfig(n_requests=3, n_tenants=1,
                                    prefix_len=64, max_new_tokens=8,
                                    vocab=VOCAB, seed=2))
    try:
        router.start(min_ready=2)
        # let a few clock-sync rounds land before any request flies
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline and (
                router._ftrace.clock.rtt(0) is None
                or router._ftrace.clock.rtt(1) is None):
            router.poll()
        tids = [router.submit(r.prompt, tenant=r.tenant,
                              max_new_tokens=r.max_new_tokens,
                              trace_id=r.trace_id) for r in trace]
        res = router.run(deadline_s=90)
        for rec, tid in zip(trace, tids):
            assert res[tid]["status"] == "done", res[tid]
            assert res[tid]["tokens"] == toy_stream(rec.prompt,
                                                    rec.max_new_tokens)
        assert router.migrations > 0
        assert router.trace_segments > 0

        # ---- clock recovery: the estimated offsets ARE the skews
        off0, err0 = router._ftrace.clock.offset(0)
        off1, err1 = router._ftrace.clock.offset(1)
        assert off0 == pytest.approx(7.5, abs=0.2)
        assert off1 == pytest.approx(-4.25, abs=0.2)
        assert err0 is not None and err0 < 0.1

        # ---- exactly ONE rate-limited dump
        dumps = sorted(glob.glob(os.path.join(bb_dir, "fleet_blackbox*")))
        assert len(dumps) == 1, dumps
        assert router.blackbox_dumps == 1
        with open(dumps[0], encoding="utf-8") as f:
            rec = json.load(f)
        fleet = rec["fleet"]
        assert fleet["trigger"]["kind"] == "ttft_breach"
        tl = fleet["timeline"]
        assert tl is not None and tl["trace_id"] == fleet["trigger"][
            "trace_id"]
        evs = tl["events"]
        srcs = {e["src"] for e in evs}
        assert {"router", "replica0", "replica1"} <= srcs, srcs

        # ---- causal order ACROSS skewed clocks: prefill admits before
        # it exports, the router relays after that, the decode import
        # commits after the relay, the router sees done last
        assert _idx(evs, "router", "enqueue") \
            < _idx(evs, "replica0", "admit") \
            < _idx(evs, "replica0", "handoff_export")
        assert _idx(evs, "replica0", "handoff_export") \
            < _idx(evs, "router", "relay_begin") \
            < _idx(evs, "replica1", "import_ok") \
            < _idx(evs, "router", "done")
        assert all(a["t"] <= b["t"] for a, b in zip(evs, evs[1:]))
        # aligned replica events carry their uncertainty
        assert all(e.get("err_s") is not None for e in evs
                   if e["src"] != "router")
        # fleet state + health ride the dump
        assert fleet["fleet_state"]["replicas"]["0"]["role"] == "prefill"
        assert fleet["health"]["blackbox_dumps"] == 0  # pre-increment

        # ---- the port's postmortem CLI renders it
        out = subprocess.run(
            [sys.executable, "-c", POSTMORTEM_CLI,
             dumps[0]], capture_output=True, text=True, timeout=60, cwd=ROOT)
        assert out.returncode == 0, out.stderr
        assert "fleet postmortem" in out.stdout
        assert "ttft_breach" in out.stdout
        assert "replica1" in out.stdout
        assert "where the time went" in out.stdout

        # ---- Chrome fleet export: one track per process
        chrome = str(tmp_path / "fleet.json")
        router.export_fleet_chrome(chrome)
        with open(chrome, encoding="utf-8") as f:
            data = json.load(f)
        pids = {e["pid"] for e in data["traceEvents"]}
        assert {10, 11, 12} <= pids
        names = {e["args"]["name"] for e in data["traceEvents"]
                 if e.get("name") == "process_name"}
        assert names == {"router", "replica0", "replica1"}
        # the unified telemetry export accepts the fleet assembler too
        combined = str(tmp_path / "combined.json")
        router._telem.export_chrome_trace(combined, fleet=router._ftrace)
        with open(combined, encoding="utf-8") as f:
            assert json.load(f)["traceEvents"]

        # ---- rtt/offset gauges (satellite): offset drift is observable
        snap = router._telem.snapshot()
        for fam in ("serving_router_replica_rtt_s",
                    "serving_router_replica_clock_offset_s"):
            got = {s["labels"]["replica"]: s["value"]
                   for s in snap[fam]["series"]}
            assert set(got) == {"0", "1"}, fam
        offs = {s["labels"]["replica"]: s["value"]
                for s in snap["serving_router_replica_clock_offset_s"][
                    "series"]}
        assert offs["0"] == pytest.approx(7.5, abs=0.2)
        assert "serving_router_slo_breach_total" in snap

        # ---- fleet_health rollup shape (bench attaches this verbatim)
        health = router.fleet_health()
        assert health["fleet_trace"] is True
        assert set(health["replicas"]) == {"0", "1"}
        assert health["replicas"]["0"]["rtt_s"] is not None
        json.dumps(health)                 # artifact-serializable
    finally:
        router.close()


@pytest.mark.multiprocess
def test_sigkill_mid_request_dump_assembles_from_survivors(tmp_path):
    """Chaos: a replica SIGKILLed mid-request triggers a replica_death
    black-box dump that still assembles — router-side events plus
    whatever the fleet already shipped — while the requests replay
    bit-identically on the survivor."""
    bb_dir = str(tmp_path / "bb")
    router = _fleet_router(
        ["mixed", "mixed"], replica={"decode_delay_s": 0.02},
        log_tag="chaos", telemetry=True, hb_timeout_s=0.4,
        fleet_trace=True, fleet_trace_dir=bb_dir)
    trace = synth_trace(TraceConfig(n_requests=6, n_tenants=2,
                                    prefix_len=32, max_new_tokens=12,
                                    vocab=VOCAB, seed=4))
    try:
        router.start(min_ready=2)
        tids = [router.submit(r.prompt, tenant=r.tenant,
                              max_new_tokens=r.max_new_tokens,
                              trace_id=r.trace_id) for r in trace]
        for _ in range(4):
            router.poll()                  # streams start on both slots
        router.fleet.kill_replica(0)
        res = router.run(deadline_s=90)
        for rec, tid in zip(trace, tids):
            assert res[tid]["status"] == "done", res[tid]
            assert res[tid]["tokens"] == toy_stream(rec.prompt,
                                                    rec.max_new_tokens)
        assert router.double_commits == 0
        dumps = sorted(glob.glob(os.path.join(bb_dir, "fleet_blackbox*")))
        assert len(dumps) == 1, dumps      # rate limit holds
        with open(dumps[0], encoding="utf-8") as f:
            rec = json.load(f)
        trig = rec["fleet"]["trigger"]
        assert trig["kind"] == "replica_death" and trig["slot"] == 0
        # the dump names an orphan and assembles its router-side view
        assert trig["trace_id"] is not None
        tl = rec["fleet"]["timeline"]
        assert tl is not None
        assert any(e["src"] == "router" and e["kind"] == "enqueue"
                   for e in tl["events"])
        # the renderer takes it without error (bin + function)
        assert "fleet postmortem" in postmortem_report(rec)
        out = subprocess.run(
            [sys.executable, "-c", POSTMORTEM_CLI,
             dumps[0]], capture_output=True, text=True, timeout=60, cwd=ROOT)
        assert out.returncode == 0, out.stderr
    finally:
        router.close()


@pytest.mark.multiprocess
def test_fleet_trace_off_ships_nothing(tmp_path):
    """The zero-overhead gate, behavioral half: with fleet_trace off
    (default) a full request lifecycle produces zero trace segments,
    zero dumps, zero clock-sync series — nothing in the fleet beyond
    behavior without fleet tracing."""
    from deepspeed_tpu_torch.telemetry import get_telemetry

    get_telemetry().reset_metrics()        # the registry is process-wide
    router = _fleet_router(["mixed", "mixed"], log_tag="off",
                           telemetry=True)
    trace = synth_trace(TraceConfig(n_requests=4, n_tenants=2,
                                    prefix_len=32, max_new_tokens=8,
                                    vocab=VOCAB, seed=6))
    try:
        router.start(min_ready=2)
        tids = [router.submit(r.prompt, max_new_tokens=8,
                              trace_id=r.trace_id) for r in trace]
        res = router.run(deadline_s=60)
        assert all(res[t]["status"] == "done" for t in tids)
        assert router._ftrace is None
        assert router.trace_segments == 0
        assert router.blackbox_dumps == 0
        snap = router._telem.snapshot()
        assert "serving_router_replica_rtt_s" not in snap
        assert "serving_router_replica_clock_offset_s" not in snap
        assert "serving_router_trace_segments_total" not in snap
        assert "serving_router_blackbox_dumps_total" not in snap
    finally:
        router.close()


def test_straggler_gauges_and_health_rollup_without_a_fleet():
    """The degraded gauge + rollup shape, driven in-process (placement
    spread makes organic per-slot sample counts flaky to force in
    tier-1 time)."""
    router = Router(RouterConfig(fleet=FleetConfig(n_replicas=3),
                                 fleet_trace=True, telemetry=True))
    for i in range(16):
        router._straggler.note(0, "ttft", 0.01)
        router._straggler.note(1, "ttft", 0.011)
        router._straggler.note(2, "ttft", 0.5)
    router._update_straggler_gauges()
    snap = router._telem.snapshot()
    got = {s["labels"]["replica"]: s["value"]
           for s in snap["serving_router_replica_degraded"]["series"]}
    assert got == {"0": 0, "1": 0, "2": 1}
    health = router.fleet_health()
    assert health["degraded"] == [2]
    assert health["replicas"]["2"]["degraded"] is True
    assert health["replicas"]["2"]["z"]["ttft"] > 3.0
    json.dumps(health)
