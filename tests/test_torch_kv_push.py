"""Anticipatory KV movement (serving/push.py + the replica overlap
machinery): proactive tier-to-peer pushes, promote-ahead pipelining, and
transfer/compute overlap.

Four legs under test:

- **idle-aware budget**: pushes are strictly lower priority than demand
  movement — the planner never launches while a pull is in flight, a
  request is queued, the queue-wait estimator is breaching, or the
  watchtower's recent queue-depth history shows pressure. The gate is
  unit-tested directly (the acceptance bar: pushes never engage while
  any replica's queue-wait estimator is breaching).
- **overlap promises**: a put carrying ``promised_tokens`` prefills only
  the suffix beyond the promised boundary and HOLDS decode there until
  the transfer settles; commit pins the landed pages, short/recompute
  roll the shortfall back into prefill — and the seed-derived toy stream
  is bit-identical either way.
- **promote-ahead**: the two-phase tier promote (begin at admission,
  finish concurrently) adopts ahead of the put's match — no double
  work, abandon-before-finish leaves the tier untouched.
- **multiprocess chaos**: push-then-request prefix-hits without a pull;
  the push SOURCE crashing mid-export degrades to recompute; a busy
  target DECLINES the offer; a receiver whose eviction races the push
  throws the pages away — every stream stays bit-identical to the LCG
  oracle with 0 double-commits in all four.

The port's copy of ``tests/test_kv_push.py``, over ``deepspeed_tpu_torch``:
its router, its replicas (spawned as ``python -m
deepspeed_tpu_torch.serving.replica``) and its telemetry. Engine legs run
the port's engine in fp32 on the CPU (``"device": "cpu"``, one torch thread
a replica) and are tier-1 here; waits poll for their condition under
generous deadlines.
"""
import os
import tempfile
import time
from collections import deque
from types import SimpleNamespace

import pytest

from deepspeed_tpu_torch.serving import FleetConfig, Router, RouterConfig
from deepspeed_tpu_torch.serving.protocol import RequestRecord
from deepspeed_tpu_torch.serving.replica import ToyBackend
from deepspeed_tpu_torch.serving.router import QUEUED
from tests.test_torch_disagg import toy_stream
from tests.test_torch_serving import restore_telemetry  # noqa: F401

#: replica logs of these tests, under the run's own temporary directory
TMP_ROOT = tempfile.gettempdir()

VOCAB = 1024
BS = 16


class _NoInj:
    def countdown(self, p):
        return False

    def value(self, p):
        return None


# ---------------------------------------------------------------------------
# idle-aware budget + join index (host-only, tier 1)
# ---------------------------------------------------------------------------

def test_push_idle_gate_blocks_pressure_pulls_queues_and_history():
    """The acceptance bar for proactive movement: pushes NEVER engage
    while demand work is pending — a pull in flight, a queued request,
    a breaching queue-wait estimate, or recent queue-depth history all
    veto the launch round (counted, not raced)."""
    router = Router(RouterConfig(kv_push=True))
    try:
        pp = router._push
        now = time.monotonic()
        assert pp.idle(now)                    # cold fleet = idle
        # a demand pull in flight: never compete with it
        router._pulls["t1"] = object()
        assert not pp.idle(now)
        router._pulls.clear()
        # queued (undispatched) work: never push
        router._queues[0] = deque(["t1"])
        assert not pp.idle(now)
        router._queues.clear()
        # queue-wait estimator breaching kv_push_idle_wait_s: tick()
        # counts the skip and launches nothing
        router._commits.extend((now, 8) for _ in range(4))
        router._reqs["q"] = SimpleNamespace(
            status=QUEUED, chain=[],
            rec=SimpleNamespace(max_new_tokens=4000, prompt=[0] * 800))
        assert router._est_queue_wait_s() > router.cfg.kv_push_idle_wait_s
        assert not pp.idle(time.monotonic())
        pp.tick(time.monotonic())
        assert pp.idle_skips >= 1 and pp.offers == 0
        # backlog drained: idle again (the estimator alone clears)
        del router._reqs["q"]
        assert pp.idle(time.monotonic())
        # watchtower lookback: pressure half a second ago still marks
        # the fleet busy; an all-quiet history does not
        router._watch = SimpleNamespace(
            last_t=lambda: 100.0,
            range=lambda metric, t0=0.0, src=None: [(99.5, 3.0)])
        assert not pp.idle(time.monotonic())
        router._watch = SimpleNamespace(
            last_t=lambda: 100.0,
            range=lambda metric, t0=0.0, src=None: [(99.5, 0.0)])
        assert pp.idle(time.monotonic())
    finally:
        router._watch = None
        router.close()


def test_push_inflight_join_index_deepest_prefix_same_slot_only():
    """Demand placement prices a push already in flight toward the
    chosen replica (plan_kv_source's ``push_pages``): the index returns
    the DEEPEST in-flight chain prefixing the request's, and never one
    aimed at a different slot."""
    router = Router(RouterConfig(kv_push=True))
    try:
        pp = router._push
        pp._pushes["p:0-1"] = {"ms": SimpleNamespace(tgt_slot=1),
                               "chain": [10, 11]}
        pp._pushes["p:0-2"] = {"ms": SimpleNamespace(tgt_slot=1),
                               "chain": [10, 11, 12]}
        pp._pushes["p:0-3"] = {"ms": SimpleNamespace(tgt_slot=2),
                               "chain": [10, 11, 12, 13]}
        assert pp.inflight([10, 11, 12, 13], 1) == ("p:0-2", 3)
        assert pp.inflight([10, 11, 12, 13], 2) == ("p:0-3", 4)
        # a diverging chain is not a prefix; another slot never joins
        assert pp.inflight([99, 11], 1) == (None, 0)
        assert pp.inflight([10, 11], 3) == (None, 0)
    finally:
        router.close()


# ---------------------------------------------------------------------------
# transfer/compute overlap promises (host-only, tier 1)
# ---------------------------------------------------------------------------

def _seeded_bundle(tokens, wv):
    from deepspeed_tpu_torch.inference.migration import toy_prefix_bundle

    return toy_prefix_bundle("", list(tokens), BS, weight_version=wv)


def test_overlap_put_prefills_suffix_holds_then_commits_bit_identical():
    tb = ToyBackend({"vocab": VOCAB, "block_size": BS})
    shared = list(range(4 * BS))
    prompt = shared + [7, 8, 9]
    assert tb.put(RequestRecord(trace_id="r1", prompt=prompt,
                                max_new_tokens=8),
                  promised_tokens=4 * BS) is None
    seq = tb.seqs["r1"]
    # only the suffix beyond the promised boundary prefills
    assert seq["provisional_skip"] == 4 * BS
    assert seq["prefill_left"] == len(prompt) - 4 * BS
    for _ in range(20):
        tb.step(_NoInj())
    # suffix computed, decode HELD at the boundary until the promise
    # settles — a provisional start must never emit a token
    assert seq["prefill_left"] == 0 and seq["generated"] == []
    # the transfer lands (as the kv relay would adopt it), then commit
    assert tb.adopt_prefix(
        _seeded_bundle(shared, dict(tb.weight_version))) == 4
    assert tb.settle_promise("r1", ok=True) == "commit"
    assert tb.overlap_commits == 1 and tb.overlap_rollbacks == 0
    assert seq["prefill_left"] == 0        # nothing rolled back
    out = None
    for _ in range(100):
        for rid, kind, toks, _off in tb.step(_NoInj()):
            if kind == "done":
                out = toks
        if "r1" not in tb.seqs:
            break
    assert out == toy_stream(prompt, 8)


@pytest.mark.parametrize("landed_pages,ok,verdict", [
    (0, False, "recompute"),       # transfer failed: full rollback
    (2, True, "short"),            # landed but under-delivered
])
def test_overlap_rollback_converts_shortfall_to_prefill_bit_identical(
        landed_pages, ok, verdict):
    tb = ToyBackend({"vocab": VOCAB, "block_size": BS})
    shared = list(range(4 * BS))
    prompt = shared + [7]
    tb.put(RequestRecord(trace_id="r1", prompt=prompt, max_new_tokens=8),
           promised_tokens=4 * BS)
    for _ in range(20):
        tb.step(_NoInj())
    if landed_pages:
        assert tb.adopt_prefix(_seeded_bundle(
            shared[:landed_pages * BS],
            dict(tb.weight_version))) == landed_pages
    assert tb.settle_promise("r1", ok=ok) == verdict
    assert tb.overlap_rollbacks == 1
    # exactly the uncovered remainder of the promise recomputes
    assert tb.seqs["r1"]["prefill_left"] == (4 - landed_pages) * BS
    out = None
    for _ in range(100):
        for rid, kind, toks, _off in tb.step(_NoInj()):
            if kind == "done":
                out = toks
        if "r1" not in tb.seqs:
            break
    # seed-derived stream: bit-identical despite the broken promise
    assert out == toy_stream(prompt, 8)


def test_settle_promise_without_promise_is_none_and_load_counts_skip():
    tb = ToyBackend({"vocab": VOCAB, "block_size": BS})
    assert tb.settle_promise("ghost", ok=True) is None
    prompt = list(range(2 * BS + 3))
    tb.put(RequestRecord(trace_id="r1", prompt=prompt, max_new_tokens=4),
           promised_tokens=2 * BS)
    # promised work is still pending work: the load report (queue-wait
    # estimators, placement) must count the provisional skip
    assert tb.load()["pending_tokens"] >= len(prompt) - 1
    assert tb.settle_promise("r1", ok=False) == "recompute"
    assert tb.settle_promise("r1", ok=False) is None    # one-shot


def test_overlap_promise_clamped_to_page_boundary():
    """A promise can never exceed the full pages of the prompt (the
    last partial page always computes locally)."""
    tb = ToyBackend({"vocab": VOCAB, "block_size": BS})
    prompt = list(range(2 * BS + 5))
    tb.put(RequestRecord(trace_id="r1", prompt=prompt, max_new_tokens=4),
           promised_tokens=10 * BS)
    seq = tb.seqs["r1"]
    assert seq["provisional_skip"] == 2 * BS
    assert seq["prefill_left"] == len(prompt) - 2 * BS


# ---------------------------------------------------------------------------
# promote-ahead two-phase (host-only, tier 1)
# ---------------------------------------------------------------------------

def test_toy_promote_ahead_two_phase_pure_begin_and_no_double_work(
        tmp_path):
    tb = ToyBackend({"block_size": BS, "vocab": VOCAB, "cache_pages": 0,
                     "kv_tier": {"ram_bytes": 1 << 16,
                                 "nvme_dir": str(tmp_path)}})
    tokens = list(range(3 * BS))
    tb._demote_evicted([(tokens, [1, 2, 3])])
    prompt = tokens + [5, 6]
    h = tb.tier_promote_begin(prompt)
    assert h is not None
    # phase one is a pure plan: the radix is still cold
    assert len(tb.radix) == 0
    assert tb.tier_promote_finish(h, ahead=True) == 3
    assert tb.promote_ahead == 1 and tb.tier_promotes == 1
    # the put that follows hits the promoted pages through the normal
    # match path — its own admission promote finds nothing deeper
    assert tb.put(RequestRecord(trace_id="r", prompt=prompt,
                                max_new_tokens=4)) is None
    assert tb.tier_promotes == 1           # no double promote
    assert tb.seqs["r"]["prefill_left"] == len(prompt) - 3 * BS
    # an abandoned begin (owner crashed before finish) owes nothing:
    # the tier still serves the chain to a later one-shot promote
    tb2 = ToyBackend({"block_size": BS, "vocab": VOCAB, "cache_pages": 0,
                      "kv_tier": {"ram_bytes": 1 << 16,
                                  "nvme_dir": str(tmp_path / "b")}})
    tb2._demote_evicted([(tokens, [1, 2, 3])])
    assert tb2.tier_promote_begin(prompt) is not None     # dropped
    assert tb2._tier_promote(prompt) == 3
    assert tb2.promote_ahead == 0


# ---------------------------------------------------------------------------
# multiprocess chaos: the four push races (tier 1)
# ---------------------------------------------------------------------------

def _push_router(per_slot=None, replica=None, log_tag="p", **rkw):
    replica_cfg = {"backend": "toy", "block_size": BS, "max_live": 8,
                   "vocab": VOCAB, "hb_interval_s": 0.03,
                   "tokens_per_step": 4}
    replica_cfg.update(replica or {})
    fcfg = FleetConfig(
        n_replicas=2, replica=replica_cfg, per_slot=per_slot or {},
        hb_timeout_s=rkw.pop("hb_timeout_s", 1.0), backoff_base_s=0.05,
        log_dir=os.path.join(TMP_ROOT, "ds_torch_kvpush_tests", log_tag))
    rkw.setdefault("rebalance", False)
    rkw.setdefault("kv_pull", True)
    rkw.setdefault("kv_pull_min_pages", 1)
    rkw.setdefault("kv_push", True)
    rkw.setdefault("kv_overlap", True)
    rkw.setdefault("kv_push_min_interval_s", 0.05)
    return Router(RouterConfig(
        fleet=fcfg, request_timeout_s=rkw.pop("request_timeout_s", 15.0),
        max_retries=rkw.pop("max_retries", 3), **rkw))


def _seed_heat(router, warm_prompt, n=3):
    """Identical warm requests, run SEQUENTIALLY: every one digest-
    matches slot 0 (no spillover, so no demand pull a chaos fault could
    fire on early), the shared chain accrues sticky heat past
    kv_push_min_heat, and the fleet ends idle."""
    router.start(min_ready=2)
    for i in range(n):
        t = router.submit(list(warm_prompt), max_new_tokens=4,
                          trace_id=f"warm-{i}")
        res = router.run(deadline_s=30)
        assert res[t]["status"] == "done", res[t]
    for _ in range(10):
        router.poll()                     # let the digests heartbeat in


def _wait_push_settled(router, deadline_s=30.0):
    """Poll the idle fleet until the planner's push settles (landed,
    declined, or failed), then let the target's digest land."""
    end = time.monotonic() + deadline_s
    while time.monotonic() < end:
        router.poll()
        st = router._push.stats()
        if st["acks"] + st["declines"] + st["misses"] > 0 \
                and st["in_flight"] == 0:
            break
        time.sleep(0.005)
    for _ in range(15):
        router.poll()
    return router._push.stats()


@pytest.mark.multiprocess
def test_push_then_request_prefix_hits_without_pull():
    """The payoff path: the idle-window push lands the hot chain on the
    cold replica, so the spillover request placed there prefix-hits —
    no demand pull, no recompute, stream bit-identical."""
    shared = list(range(4 * BS))
    router = _push_router(per_slot={"0": {"max_live": 1,
                                          "decode_delay_s": 0.01}},
                          log_tag="hit", telemetry=True)
    try:
        _seed_heat(router, shared + [7, 8, 9])
        st = _wait_push_settled(router)
        assert st["acks"] >= 1 and st["pages"] >= 4, st
        # occupy slot 0's single live slot...
        t2 = router.submit([900 + i for i in range(24)],
                           max_new_tokens=48, trace_id="occupy")
        for _ in range(5):
            router.poll()
        # ...so the sharer spills onto slot 1 — which the push warmed
        t3 = router.submit(shared + [3, 4, 5], max_new_tokens=8,
                           trace_id="sharer")
        res = router.run(deadline_s=60)
        assert res[t3]["status"] == "done"
        assert res[t3]["tokens"] == toy_stream(shared + [3, 4, 5], 8)
        assert res[t2]["tokens"] == toy_stream(
            [900 + i for i in range(24)], 48)
        assert res[t3]["placed"] == [1]
        # anticipation means NO demand movement was needed
        assert res[t3]["pulled_pages"] == 0
        assert router.kv_pulls == 0
        assert router.double_commits == 0
        snap = router._telem.snapshot()
        pages = sum(s["value"] for s in snap[
            "serving_router_kv_push_pages_total"]["series"])
        assert pages >= 4
        assert "serving_router_kv_push_offers_total" in snap
    finally:
        router.close()


@pytest.mark.multiprocess
def test_push_source_crash_mid_export_degrades_to_recompute():
    """The sender dies HARD while exporting the pushed chain: the push
    fails (counted), the fleet restarts the replica, and the demand
    requests that follow recompute — streams stay oracle-identical
    with 0 double-commits (pushes are pure opportunism)."""
    shared = list(range(4 * BS))
    router = _push_router(
        per_slot={"0": {"faults":
                        {"replica_crash_during_kv_export": 1}}},
        log_tag="src_crash")
    try:
        _seed_heat(router, shared + [7, 8, 9])
        st = _wait_push_settled(router, deadline_s=30.0)
        assert st["offers"] >= 1, st
        assert st["acks"] == 0 and st["misses"] >= 1, st
        t3 = router.submit(shared + [3, 4, 5], max_new_tokens=8,
                           trace_id="after")
        res = router.run(deadline_s=60)
        assert res[t3]["status"] == "done"
        assert res[t3]["tokens"] == toy_stream(shared + [3, 4, 5], 8)
        assert router.double_commits == 0
        assert router.replay_mismatches == 0
        assert router.fleet.restarts_total >= 1
    finally:
        router.close()


@pytest.mark.multiprocess
def test_push_declined_by_busy_target_and_demand_unharmed():
    """A push lands on a replica with its own live work, so the offer
    is DECLINABLE: a busy target answers kv_push_no (counted, cooled
    down), no pages move, and the decode it was busy with streams
    bit-identically."""
    shared = list(range(4 * BS))
    # seed with pushes DISARMED so the launch can't win the race
    # against the occupying decodes below
    router = _push_router(per_slot={"0": {"max_live": 1}},
                          log_tag="decline", telemetry=True,
                          kv_push=False)
    try:
        _seed_heat(router, shared + [7, 8, 9])
        # occupy BOTH replicas with live decodes (assigned, not queued:
        # the idle gate sees no backlog, so the planner still launches
        # — and the busy target declines)
        t_a = router.submit([800 + i for i in range(24)],
                            max_new_tokens=64, trace_id="occupy0")
        for _ in range(5):
            router.poll()
        t_b = router.submit([700 + i for i in range(24)],
                            max_new_tokens=64, trace_id="occupy1")
        for _ in range(5):
            router.poll()
        router.cfg.kv_push = True              # arm: targets are busy now
        st = _wait_push_settled(router, deadline_s=30.0)
        assert st["declines"] >= 1 and st["acks"] == 0, st
        res = router.run(deadline_s=60)
        assert res[t_a]["tokens"] == toy_stream(
            [800 + i for i in range(24)], 64)
        assert res[t_b]["tokens"] == toy_stream(
            [700 + i for i in range(24)], 64)
        assert router.double_commits == 0
        snap = router._telem.snapshot()
        fam = snap.get("serving_router_kv_push_declined_total")
        assert fam is not None
        reasons = {s["labels"]["reason"]: s["value"]
                   for s in fam["series"]}
        assert reasons.get("busy", 0) >= 1, reasons
    finally:
        router.close()


@pytest.mark.multiprocess
def test_push_racing_receiver_eviction_stays_bit_identical():
    """The receiver's cache trims to zero the moment the pushed pages
    adopt (cache_pages=0 — adoption raced eviction and lost): the push
    books its landing, the pages evaporate, and the request that
    arrives later simply recomputes (or pulls) — stream bit-identical,
    0 double-commits, nothing double-owned."""
    shared = list(range(4 * BS))
    router = _push_router(per_slot={"0": {"max_live": 1,
                                          "decode_delay_s": 0.01},
                                    "1": {"cache_pages": 0}},
                          log_tag="evict_race")
    try:
        _seed_heat(router, shared + [7, 8, 9])
        st = _wait_push_settled(router)
        assert st["acks"] >= 1, st              # the push DID land...
        t2 = router.submit([900 + i for i in range(24)],
                           max_new_tokens=48, trace_id="occupy")
        for _ in range(5):
            router.poll()
        t3 = router.submit(shared + [3, 4, 5], max_new_tokens=8,
                           trace_id="sharer")
        res = router.run(deadline_s=60)
        # ...but eviction already reclaimed the pages: correctness is
        # untouched either way the router recovered (pull or recompute)
        assert res[t3]["status"] == "done"
        assert res[t3]["tokens"] == toy_stream(shared + [3, 4, 5], 8)
        assert res[t2]["tokens"] == toy_stream(
            [900 + i for i in range(24)], 48)
        assert router.double_commits == 0
        assert router.replay_mismatches == 0
    finally:
        router.close()
