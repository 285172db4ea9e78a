"""Fleet-wide KV reuse: placement-time radix pulls, the shared-memory
page transport, and hot-replica rebalancing.

Three legs under test:

- **pulls**: a request placed on a replica WITHOUT its prefix pulls the
  page chain from the peer whose residency digest holds it (kind="prefix"
  bundles over the same chunk/crc protocol as migration), with recompute
  as the always-safe fallback — peer death mid-pull, chain evictions and
  timeouts all degrade silently and the greedy stream stays bit-identical
  to the closed-form oracle.
- **shm transport**: intra-host transfers ship payload through the
  exporter's shared-memory ring (descriptors still ride the router);
  attach/map failures and lapped extents fall back to the base64 relay
  per chunk, silently, crc-gated end to end.
- **rebalancing**: the router migrates the youngest mid-decode sequence
  off a sustained-hot replica onto an idle peer through the handoff
  migration primitive; a target death mid-import resumes the victim on
  its source with zero lost work and zero leaked/double-owned blocks.

The port's copy of ``tests/test_kv_pull.py``, over ``deepspeed_tpu_torch``:
its router, its replicas (spawned as ``python -m
deepspeed_tpu_torch.serving.replica``) and its telemetry. Engine legs run
the port's engine in fp32 on the CPU (``"device": "cpu"``, one torch thread
a replica) and are tier-1 here; waits poll for their condition under
generous deadlines.
"""
import collections
import os
import tempfile
import zlib

import pytest

from deepspeed_tpu_torch.inference.migration import (
    BundleAssembler, MigrationError, PageBundle, iter_chunks,
    toy_prefix_bundle, toy_verify)
from deepspeed_tpu_torch.serving import (FleetConfig, RebalancePolicy, Router,
                                         RouterConfig, ShmRing, TraceConfig,
                                         attach_ring, best_digest_peer,
                                         pull_beats_recompute, synth_trace)
from tests.test_torch_disagg import toy_stream
from tests.test_torch_serving import restore_telemetry  # noqa: F401

#: replica logs of these tests, under the run's own temporary directory
TMP_ROOT = tempfile.gettempdir()

VOCAB = 1024
BS = 16


# ---------------------------------------------------------------------------
# units (host-only, tier 1)
# ---------------------------------------------------------------------------

def test_prefix_bundle_shape_and_roundtrip():
    b = toy_prefix_bundle("t-1", list(range(2 * BS)), BS)
    assert b.kind == "prefix" and b.n_full == 2 and b.tail is None
    toy_verify(b)
    chunks = iter_chunks(b, max_bytes=20)
    asm = BundleAssembler(b.meta())
    for c in reversed(chunks):
        asm.add(c)
    asm.eof(len(chunks))
    b2 = asm.assemble()
    assert b2.kind == "prefix"
    toy_verify(b2)
    assert b2.tokens == b.tokens and b2.pages == b.pages
    # sub-page extents never become prefix bundles
    assert toy_prefix_bundle("t-2", list(range(BS - 1)), BS) is None


def test_prefix_bundle_validate_rejects_partial_state():
    b = toy_prefix_bundle("t-1", list(range(2 * BS)), BS)
    b.n_generated = 1
    with pytest.raises(MigrationError, match="prefix bundle"):
        b.validate()
    b = toy_prefix_bundle("t-1", list(range(2 * BS)), BS)
    b.n_computed -= 1
    with pytest.raises(MigrationError, match="prefix bundle"):
        b.validate()
    with pytest.raises(MigrationError, match="geometry"):
        PageBundle.prefix("t", list(range(BS)), BS, "toy", 48, [b"x", b"y"])


def test_shm_ring_write_read_wrap_and_lap_detection():
    ring = ShmRing(4096)
    try:
        blob = bytes(range(256)) * 4          # 1 KiB
        offs = [ring.write(blob) for _ in range(3)]
        rd = attach_ring(ring.name)
        crc = zlib.crc32(blob)
        for off in offs:
            assert rd.read(off, len(blob), crc) == blob
        # 4th write wraps to offset 0, lapping the first extent
        assert ring.write(b"Z" * 2048) == 0
        assert rd.read(offs[0], len(blob), crc) is None   # lap detected
        # oversized blob refused (caller sends it inline)
        assert ring.write(b"x" * 8192) is None
        # garbage offsets are refused, never a crash
        assert rd.read(10**6, 16, 0) is None
        rd.close()
    finally:
        ring.close()
    assert attach_ring("dstpu_no_such_ring") is None


def test_pull_cost_model_prefers_recompute_when_transfer_loses():
    # tiny pages over a fast transport: pull wins
    assert pull_beats_recompute(64, 48, 16, prefill_tok_s=2000.0,
                                xfer_bytes_s=1e9, overhead_s=0.0)
    # huge pages over a slow relay lose to a fast prefill
    assert not pull_beats_recompute(64, 4 << 20, 16, prefill_tok_s=1e5,
                                    xfer_bytes_s=1e6)
    assert not pull_beats_recompute(0, 48, 16, 2000.0, 1e9)


class _H:
    def __init__(self, slot, digest=None, load=None, max_live=8,
                 shm=None, address=None):
        self.slot = slot
        self.digest = digest
        self.load = load
        self.max_live = max_live
        self.shm = shm
        self.address = address


def test_best_digest_peer_excludes_placed_slot_and_breaks_ties_low():
    from deepspeed_tpu_torch.serving import chain_hashes
    chain = chain_hashes(list(range(4 * BS)), BS)
    hs = [_H(0, set(chain)), _H(1, set(chain)), _H(2, set(chain[:1]))]
    peer, pages = best_digest_peer(chain, hs, exclude_slot=0)
    assert peer.slot == 1 and pages == 4
    peer, pages = best_digest_peer(chain, hs, exclude_slot=1)
    assert peer.slot == 0 and pages == 4
    assert best_digest_peer(chain, [_H(5)], exclude_slot=1) == (None, 0)


def test_rebalance_policy_sustain_hysteresis_and_rate_limit():
    pol = RebalancePolicy(hot_util=0.8, idle_util=0.4, sustain_s=1.0,
                          min_interval_s=0.5)
    hot = _H(0, load={"live": 8})
    idle = _H(1, load={"live": 1})
    # a spike never triggers: the sustain clock gates
    assert pol.pick(10.0, [hot, idle]) is None
    assert pol.pick(10.5, [hot, idle]) is None
    got = pol.pick(11.1, [hot, idle])
    assert got is not None and got[0].slot == 0 and got[1].slot == 1
    # rate limit: no second victim inside min_interval_s
    assert pol.pick(11.2, [hot, idle]) is None
    # hysteresis band: a mid-band peer (util between idle and hot) is
    # NOT a destination — migrating there could flap straight back
    mid = _H(1, load={"live": 5})
    assert pol.pick(12.0, [hot, mid]) is None
    # cooling below hot_util resets the sustain clock
    cool = _H(0, load={"live": 1})
    assert pol.pick(13.0, [cool, idle]) is None
    assert pol._hot_since == {}


# ---------------------------------------------------------------------------
# multi-process: pulls, shm, rebalancing (tier 1)
# ---------------------------------------------------------------------------

def _pull_router(per_slot=None, replica=None, log_tag="p", **rkw):
    replica_cfg = {"backend": "toy", "block_size": BS, "max_live": 8,
                   "vocab": VOCAB, "hb_interval_s": 0.03,
                   "tokens_per_step": 4}
    replica_cfg.update(replica or {})
    fcfg = FleetConfig(
        n_replicas=2, replica=replica_cfg, per_slot=per_slot or {},
        hb_timeout_s=rkw.pop("hb_timeout_s", 1.0), backoff_base_s=0.05,
        log_dir=os.path.join(TMP_ROOT, "ds_torch_kvpull_tests", log_tag))
    rkw.setdefault("rebalance", False)
    return Router(RouterConfig(
        fleet=fcfg, request_timeout_s=rkw.pop("request_timeout_s", 10.0),
        max_retries=rkw.pop("max_retries", 3), **rkw))


def _run_pull_scenario(router, shared_prefix):
    """Seed slot 0 with the prefix, occupy it, then force a same-prefix
    request onto slot 1 — the placement-time pull. Returns (res, tids)."""
    router.start(min_ready=2)
    # r1 publishes the prefix into slot 0's radix at release
    t1 = router.submit(shared_prefix + [7, 8, 9], max_new_tokens=8,
                       trace_id="seed")
    router.run(deadline_s=60)
    assert router.result(t1)["status"] == "done"
    for _ in range(10):                    # let the digest heartbeat land
        router.poll()
    # r2 (unrelated, slow) occupies slot 0's single live slot
    t2 = router.submit([900 + i for i in range(24)], max_new_tokens=48,
                       trace_id="occupy")
    for _ in range(5):
        router.poll()
    assert router.result(t2)["status"] in ("assigned", "done")
    # r3 shares the prefix but slot 0 is full: placed on slot 1, which
    # pulls the chain from slot 0 instead of recomputing it
    t3 = router.submit(shared_prefix + [3, 4, 5], max_new_tokens=8,
                       trace_id="puller")
    res = router.run(deadline_s=90)
    return res, (t1, t2, t3)


@pytest.mark.multiprocess
def test_placement_pull_ships_chain_and_stream_stays_bit_identical():
    shared = list(range(4 * BS))
    router = _pull_router(per_slot={"0": {"max_live": 1,
                                          "decode_delay_s": 0.01}},
                          log_tag="happy", telemetry=True)
    try:
        res, (t1, t2, t3) = _run_pull_scenario(router, shared)
        for tid, prompt, n in ((t1, shared + [7, 8, 9], 8),
                               (t2, [900 + i for i in range(24)], 48),
                               (t3, shared + [3, 4, 5], 8)):
            assert res[tid]["status"] == "done", res[tid]
            assert res[tid]["tokens"] == toy_stream(prompt, n)
        assert res[t3]["placed"] == [1]
        assert res[t3]["pulled_pages"] >= 2, res[t3]
        assert router.kv_pulls >= 1
        assert router.kv_pull_fallbacks == 0
        assert router.double_commits == 0
        snap = router._telem.snapshot()
        toks = sum(s["value"] for s in
                   snap["serving_router_kv_pull_tokens_total"]["series"])
        assert toks >= 2 * BS
        assert "serving_router_kv_pull_bytes_total" in snap
    finally:
        router.close()


@pytest.mark.multiprocess
def test_peer_death_mid_pull_recomputes_bit_identical():
    """The peer crashes HARD while exporting the chain: the puller's
    held-back request recomputes locally and the stream matches the
    oracle exactly; the fallback is counted."""
    shared = list(range(4 * BS))
    router = _pull_router(
        per_slot={"0": {"max_live": 1, "decode_delay_s": 0.01,
                        "faults": {"replica_crash_during_kv_export": 1}}},
        log_tag="peer_death", kv_pull_timeout_s=3.0)
    try:
        res, (t1, t2, t3) = _run_pull_scenario(router, shared)
        for tid, prompt, n in ((t1, shared + [7, 8, 9], 8),
                               (t2, [900 + i for i in range(24)], 48),
                               (t3, shared + [3, 4, 5], 8)):
            assert res[tid]["status"] == "done", res[tid]
            assert res[tid]["tokens"] == toy_stream(prompt, n)
        assert res[t3]["pulled_pages"] == 0       # fell back
        assert router.kv_pulls >= 1
        assert router.kv_pull_fallbacks >= 1
        assert router.double_commits == 0
        assert router.replay_mismatches == 0
    finally:
        router.close()


@pytest.mark.multiprocess
@pytest.mark.parametrize("attach_fails", [False, True])
def test_pull_over_shm_and_silent_relay_fallback(attach_fails):
    """With rings enabled the pulled payload rides shared memory; an
    injected attach/map failure on the puller silently falls back to the
    base64 relay — same pages adopted, same bit-identical stream."""
    shared = list(range(4 * BS))
    slot1 = {}
    if attach_fails:
        slot1["faults"] = {"replica_shm_attach_fail": 1}
    router = _pull_router(
        replica={"shm_bytes": 1 << 20},
        per_slot={"0": {"max_live": 1, "decode_delay_s": 0.01},
                  "1": slot1},
        log_tag=f"shm_{attach_fails}", telemetry=True)
    try:
        res, (t1, t2, t3) = _run_pull_scenario(router, shared)
        assert res[t3]["status"] == "done"
        assert res[t3]["tokens"] == toy_stream(shared + [3, 4, 5], 8)
        assert res[t3]["pulled_pages"] >= 2, res[t3]
        assert router.kv_pull_fallbacks == 0
        snap = router._telem.snapshot()
        fam = snap["serving_router_kv_pull_bytes_total"]
        transports = {s["labels"]["transport"]: s["value"]
                      for s in fam["series"]}
        want = "relay" if attach_fails else "shm"
        assert transports.get(want, 0) > 0, transports
    finally:
        router.close()


@pytest.mark.multiprocess
def test_handoff_migration_rides_shm_transport():
    """Role-split handoffs use the ring too: same chaos-proof chunk/crc
    machinery, payload off the pipe. Streams stay oracle-identical and
    the byte counter lands under transport="shm"."""
    trace = synth_trace(TraceConfig(n_requests=6, n_tenants=2,
                                    prefix_len=32, max_new_tokens=10,
                                    vocab=VOCAB, seed=5))
    replica_cfg = {"backend": "toy", "block_size": BS, "max_live": 8,
                   "vocab": VOCAB, "hb_interval_s": 0.03,
                   "tokens_per_step": 4, "shm_bytes": 1 << 20}
    router = Router(RouterConfig(
        fleet=FleetConfig(n_replicas=3, replica=replica_cfg,
                          roles=["prefill", "decode", "decode"],
                          hb_timeout_s=1.0, backoff_base_s=0.05,
                          log_dir=os.path.join(TMP_ROOT,
                                               "ds_torch_kvpull_tests",
                                               "mig_shm")),
        request_timeout_s=10.0, max_retries=3, rebalance=False,
        telemetry=True))
    try:
        router.start(min_ready=3)
        tids = [router.submit(r.prompt, tenant=r.tenant,
                              max_new_tokens=r.max_new_tokens,
                              trace_id=r.trace_id) for r in trace]
        res = router.run(deadline_s=90)
        for rec, tid in zip(trace, tids):
            assert res[tid]["status"] == "done", res[tid]
            assert res[tid]["tokens"] == toy_stream(rec.prompt,
                                                    rec.max_new_tokens)
        assert router.migrations > 0
        assert router.double_commits == 0
        snap = router._telem.snapshot()
        fam = snap["serving_router_migration_bytes_total"]
        transports = {s["labels"]["transport"]: s["value"]
                      for s in fam["series"]}
        assert transports.get("shm", 0) > 0, transports
    finally:
        router.close()


def _rebalance_router(per_slot=None, log_tag="r", **rkw):
    replica_cfg = {"backend": "toy", "block_size": BS, "max_live": 8,
                   "vocab": VOCAB, "hb_interval_s": 0.03,
                   "tokens_per_step": 2, "decode_delay_s": 0.02}
    fcfg = FleetConfig(
        n_replicas=2, replica=replica_cfg, per_slot=per_slot or {},
        hb_timeout_s=2.0, backoff_base_s=0.05,
        log_dir=os.path.join(TMP_ROOT, "ds_torch_kvpull_tests", log_tag))
    rkw.setdefault("rebalance", True)
    rkw.setdefault("rebalance_hot_util", 0.4)
    rkw.setdefault("rebalance_idle_util", 0.2)
    rkw.setdefault("rebalance_sustain_s", 0.15)
    rkw.setdefault("rebalance_min_interval_s", 0.05)
    rkw.setdefault("kv_pull", False)
    return Router(RouterConfig(
        fleet=fcfg, request_timeout_s=rkw.pop("request_timeout_s", 15.0),
        max_retries=3, **rkw))


def _submit_colocated_burst(router, n=4, gen=40):
    """Same-prefix requests co-locate on one replica (digest/sticky
    placement) and decode slowly — the sustained-hot shape."""
    prefix = list(range(64))
    tids = []
    for i in range(n):
        tids.append(router.submit(prefix + [600 + i], max_new_tokens=gen,
                                  trace_id=f"b{i}"))
        for _ in range(3):
            router.poll()
    return prefix, tids


@pytest.mark.multiprocess
def test_rebalance_moves_youngest_off_hot_replica_bit_identical():
    router = _rebalance_router(log_tag="rebal", telemetry=True)
    try:
        router.start(min_ready=2)
        prefix, tids = _submit_colocated_burst(router)
        res = router.run(deadline_s=120)
        moved = 0
        placements = collections.Counter()
        for i, tid in enumerate(tids):
            assert res[tid]["status"] == "done", res[tid]
            assert res[tid]["tokens"] == toy_stream(prefix + [600 + i],
                                                    40)
            moved += bool(res[tid]["rebalanced"])
            placements[res[tid]["placed"][0]] += 1
        # the burst co-located (that's what makes the slot hot) ...
        assert placements.most_common(1)[0][1] >= 3, placements
        # ... and the policy moved at least one victim off it, exactly
        # once each (anti-ping-pong)
        assert moved >= 1
        assert router.rebalances >= 1
        assert router.double_commits == 0
        assert router.replay_mismatches == 0
        snap = router._telem.snapshot()
        assert "serving_router_rebalances_total" in snap
    finally:
        router.close()


def test_engine_prefix_pull_bit_identical_on_real_pool():
    """Acceptance on the port's pool (fp32 on the CPU, tier-1 here): a
    chain exported from engine A's trie and adopted into engine B (full
    wire roundtrip, out-of-order chunks) serves B's same-prompt request
    from cache with the exact greedy stream of the A-only baseline; a
    duplicate import surrenders every copy; audits clean throughout."""
    import numpy as np
    import torch

    from deepspeed_tpu_torch.inference import InferenceEngineV2
    from deepspeed_tpu_torch.models import build_model

    def eng():
        # the same seed: both engines hold the same weights
        m = build_model("tiny-gpt2", device="cpu", dtype=torch.float32,
                        seed=5, hidden_size=256, num_heads=4)
        return InferenceEngineV2(
            m, config={"block_size": 8, "num_blocks": 64, "max_seqs": 4,
                       "chunk": 8, "max_seq_len": 128,
                       "prefix_cache": True, "dtype": torch.float32,
                       "device": "cpu"})

    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        _pull_roundtrip(eng(), eng(), np.random.default_rng(7))
    finally:
        torch.set_num_threads(prev)


def _pull_roundtrip(A, B, rng):
    prompt = list(map(int, rng.integers(0, 256, (21,))))
    A.put(1, prompt, max_new_tokens=6)
    while not A.query(1).get("done", False):
        A.step()
    base = A.flush(1)
    A.state.audit()

    bundle = A.export_prefix(prompt)
    A.state.audit()                      # gather pin released
    assert bundle.kind == "prefix" and bundle.n_full == 2
    chunks = iter_chunks(bundle, max_bytes=8192)
    asm = BundleAssembler(bundle.meta())
    for c in reversed(chunks):
        asm.add(c)
    asm.eof(len(chunks))
    b2 = asm.assemble()

    assert B.import_prefix(b2) == 2
    B.state.audit()
    B.put(1, prompt, max_new_tokens=6)
    assert B.state.seqs[1].prefix_hit_tokens >= 16
    while not B.query(1).get("done", False):
        B.step()
    assert B.flush(1) == base, "pulled-prefix stream diverged"
    B.state.audit()
    # dedup: a re-import surrenders every freshly-allocated copy
    free0 = B.state.allocator.free_blocks
    assert B.import_prefix(A.export_prefix(prompt)) == 2
    assert B.state.allocator.free_blocks == free0
    B.state.audit()
    # a miss is a structured refusal, not a bad bundle
    with pytest.raises(MigrationError):
        A.export_prefix([999] * 16)


@pytest.mark.multiprocess
def test_rebalance_target_death_resumes_victim_on_source():
    """The rebalance target dies HARD mid-import: the victim resumes on
    its source via mig_resume — no retry burned, stream bit-identical,
    exactly-once preserved."""
    router = _rebalance_router(
        per_slot={"1": {"faults": {"replica_crash_during_import": 1},
                        "decode_delay_s": 0.0}},
        log_tag="rebal_death")
    try:
        router.start(min_ready=2)
        prefix, tids = _submit_colocated_burst(router)
        res = router.run(deadline_s=120)
        for i, tid in enumerate(tids):
            assert res[tid]["status"] == "done", res[tid]
            assert res[tid]["tokens"] == toy_stream(prefix + [600 + i],
                                                    40)
        assert router.rebalances >= 1, "rebalance never triggered"
        # at least one victim went through the abort-resume path: it is
        # marked rebalanced (hysteresis) yet never completed elsewhere
        assert router.double_commits == 0
        assert router.replay_mismatches == 0
    finally:
        router.close()
