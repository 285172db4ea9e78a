"""Gang prefill: ONE long prompt's prefill sharded across a gang of
prefill-capable replicas, the merged KV chain staged member-to-member
over the kv_* PageBundle machinery, first token sampled on the final
member.

Four legs under test:

- **segment math**: a member's segment through the port's attention (its
  queries at their absolute positions over the adopted prefix KV and its
  own) and through the port's own ``gang_segment_attention``
  (``parallel/sequence.py``) equals the matching rows of the port's full
  causal attention over the concatenated sequence, and the JAX
  reference's ``gang_segment_attention`` — the algebraic fact that lets
  each member prefill its own segment over adopted prefix KV.
- **planning**: page-aligned segment cover and the gang-vs-single cost
  model (a mostly-cached prompt or a slow transport must never gang).
- **happy path**: a gang-of-2 engages on a long prompt, the merged
  chain lands on the final member, the pinned put samples there, and
  the stream is bit-identical to the closed-form oracle.
- **chaos**: a member SIGKILLed mid-segment, a version-skew refusal
  mid-gang, and every other collapse degrade to the ordinary
  single-replica prefill — same oracle stream, zero double commits,
  no retry burned.

The port's copy of ``tests/test_gang.py``, over ``deepspeed_tpu_torch``: its
router, its replicas (spawned as ``python -m
deepspeed_tpu_torch.serving.replica``) and its telemetry. Engine legs run
the port's engine in fp32 on the CPU (``"device": "cpu"``, one torch thread
a replica) and are tier-1 here; waits poll for their condition under
generous deadlines.
"""
import os
import tempfile

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.ops.attention import plain_attention
from deepspeed_tpu_torch.serving import FleetConfig, Router, RouterConfig
from deepspeed_tpu_torch.serving.placement import (gang_segments,
                                                   plan_gang_prefill)
from tests.test_torch_disagg import toy_stream
from tests.test_torch_serving import restore_telemetry  # noqa: F401

#: replica logs of these tests, under the run's own temporary directory
TMP_ROOT = tempfile.gettempdir()

VOCAB = 1024
BS = 16


# ---------------------------------------------------------------------------
# segment attention math (host-only, tier 1)
# ---------------------------------------------------------------------------

def _full_qkv(B=1, S=96, H=4, KV=4, D=16):
    rng = np.random.default_rng(2)
    return [rng.standard_normal((B, S, n, D)).astype(np.float32)
            for n in (H, KV, KV)]


def _port_segment(q, k, v, start, end):
    """The port's attention of one member's segment: queries
    ``start..end-1`` at their absolute positions over every key before
    ``end`` (the adopted prefix and the segment itself)."""
    pos = torch.arange(start, end)[None].expand(q.shape[0], -1)
    return plain_attention(torch.from_numpy(q[:, start:end]),
                           torch.from_numpy(k[:, :end]),
                           torch.from_numpy(v[:, :end]), causal=True,
                           positions=pos)


@pytest.mark.parametrize("gqa", [1, 2])
@pytest.mark.parametrize("ends", [[32, 64, 96], [40, 96], [96]])
def test_gang_segment_attention_matches_full_rows(gqa, ends):
    """Each member's segment output — the port's attention at absolute
    positions, and the port's segment fold — equals the matching rows of
    full causal attention over the whole sequence, including a lone-member
    'gang' (ends=[S]) and uneven splits, and the JAX reference's segment
    fold on the same inputs."""
    import jax.numpy as jnp

    from deepspeed_tpu.parallel.sequence import gang_segment_attention
    from deepspeed_tpu_torch.parallel import sequence as port_sequence

    q, k, v = _full_qkv(KV=4 // gqa)
    ref = plain_attention(*map(torch.from_numpy, (q, k, v)),
                          causal=True).numpy()
    start = 0
    for end in ends:
        out = _port_segment(q, k, v, start, end).numpy()
        np.testing.assert_allclose(out, ref[:, start:end],
                                   atol=1e-5, rtol=1e-5)
        jq, jk, jv = map(jnp.asarray, (q, k, v))
        want = gang_segment_attention(
            jq[:, start:end],
            jk[:, :start] if start else None,
            jv[:, :start] if start else None,
            jk[:, start:end], jv[:, start:end], block=32)
        np.testing.assert_allclose(out, np.asarray(want),
                                   atol=1e-5, rtol=1e-5)
        tq, tk, tv = map(torch.from_numpy, (q, k, v))
        fold = port_sequence.gang_segment_attention(
            tq[:, start:end], tk[:, :start] if start else None,
            tv[:, :start] if start else None, tk[:, start:end],
            tv[:, start:end], block=32).numpy()
        np.testing.assert_allclose(fold, ref[:, start:end],
                                   atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(fold, np.asarray(want),
                                   atol=1e-5, rtol=1e-5)
        start = end


def test_gang_segment_attention_rejects_bad_gqa():
    """A KV head count that does not divide the query heads is refused by
    the reference's segment fold, the port's and the port's attention."""
    from deepspeed_tpu.parallel.sequence import gang_segment_attention
    from deepspeed_tpu_torch.parallel import sequence as port_sequence

    q, k, v = _full_qkv(H=4, KV=3)
    with pytest.raises(ValueError, match="divisible"):
        gang_segment_attention(q, None, None, k, v)
    with pytest.raises(ValueError, match="divisible"):
        port_sequence.gang_segment_attention(
            torch.from_numpy(q), None, None, torch.from_numpy(k),
            torch.from_numpy(v))
    with pytest.raises(RuntimeError):
        _port_segment(q, k, v, 0, q.shape[1])


# ---------------------------------------------------------------------------
# segment cover + cost model (host-only, tier 1)
# ---------------------------------------------------------------------------

def test_gang_segments_page_aligned_cover():
    assert gang_segments(8, 2) == [4, 8]
    assert gang_segments(9, 2) == [5, 9]
    assert gang_segments(9, 4) == [3, 6, 9]       # short chain: fewer ends
    assert gang_segments(2, 4) == [1, 2]
    assert gang_segments(0, 3) == []
    # cover is exact and monotone for a spread of shapes
    for pages in (1, 5, 16, 39):
        for k in (2, 3, 4):
            ends = gang_segments(pages, k)
            assert ends[-1] == pages
            assert ends == sorted(set(ends))
            assert len(ends) <= k


def test_plan_gang_prefill_cost_model():
    # cheap transport, slow prefill: gang wins
    assert plan_gang_prefill(40, 0, 4, 0, BS, prefill_tok_s=1000.0,
                             xfer_bytes_s=1e9) >= 2
    # huge pages over a slow relay: transfer hops lose to one prefill
    assert plan_gang_prefill(40, 0, 4, 4 << 20, BS, prefill_tok_s=1e5,
                             xfer_bytes_s=1e6) == 1
    # a mostly-cached prompt must never gang (hit only helps single)
    assert plan_gang_prefill(40, 38, 4, 0, BS, prefill_tok_s=1000.0,
                             xfer_bytes_s=1e9) == 1
    # degenerate shapes
    assert plan_gang_prefill(0, 0, 4, 0, BS, 1000.0, 1e9) == 1
    assert plan_gang_prefill(40, 0, 1, 0, BS, 1000.0, 1e9) == 1
    # per-hop overhead taxes every staged hop
    assert plan_gang_prefill(4, 0, 4, 48, BS, prefill_tok_s=1e5,
                             xfer_bytes_s=1e9, overhead_s=10.0) == 1


# ---------------------------------------------------------------------------
# fleet: happy path + chaos (multiprocess, tier 1)
# ---------------------------------------------------------------------------

LONG = [(7 * i + 3) % VOCAB for i in range(640)]


def _gang_router(per_slot=None, log_tag="g", **rkw):
    replica_cfg = {"backend": "toy", "block_size": BS, "max_live": 8,
                   "vocab": VOCAB, "hb_interval_s": 0.03,
                   "tokens_per_step": 4, "prefill_chunk": 32,
                   "prefill_delay_s": 0.01}
    replica_cfg.update(rkw.pop("replica", {}))
    fcfg = FleetConfig(
        n_replicas=3, replica=replica_cfg, per_slot=per_slot or {},
        roles=["prefill", "prefill", "decode"],
        hb_timeout_s=rkw.pop("hb_timeout_s", 1.0), backoff_base_s=0.05,
        log_dir=os.path.join(TMP_ROOT, "ds_torch_gang_tests", log_tag))
    rkw.setdefault("rebalance", False)
    rkw.setdefault("gang_min_tokens", 256)
    return Router(RouterConfig(
        fleet=fcfg, request_timeout_s=rkw.pop("request_timeout_s", 15.0),
        max_retries=rkw.pop("max_retries", 3), **rkw))


@pytest.mark.multiprocess
def test_gang_prefill_merges_and_stream_stays_bit_identical():
    router = _gang_router(log_tag="happy", telemetry=True)
    try:
        router.start(min_ready=3)       # a partial fleet never gangs
        tid = router.submit(LONG, max_new_tokens=8, trace_id="gang")
        res = router.run(deadline_s=90)
        assert res[tid]["status"] == "done", res[tid]
        assert res[tid]["tokens"] == toy_stream(LONG, 8)
        assert res[tid]["gang_k"] >= 2, res[tid]
        assert res[tid]["gang_merged"] is True
        assert router.gang_plans >= 1 and router.gang_merges == 1
        assert router.gang_fallbacks == 0
        assert router.double_commits == 0
        snap = router._telem.snapshot()
        assert "serving_router_gang_merged_total" in snap
        assert "serving_router_gang_segments_total" in snap
        bytes_fam = snap["serving_router_gang_bytes_total"]["series"]
        assert sum(s["value"] for s in bytes_fam) > 0
    finally:
        router.close()


@pytest.mark.multiprocess
def test_short_prompt_never_gangs():
    router = _gang_router(log_tag="short")
    try:
        router.start(min_ready=3)
        prompt = LONG[:64]              # under gang_min_tokens
        tid = router.submit(prompt, max_new_tokens=8)
        res = router.run(deadline_s=60)
        assert res[tid]["status"] == "done"
        assert res[tid]["tokens"] == toy_stream(prompt, 8)
        assert res[tid]["gang_k"] == 0
        assert router.gang_merges == 0 and router.gang_fallbacks == 0
    finally:
        router.close()


@pytest.mark.multiprocess
def test_member_crash_mid_segment_falls_back_bit_identical():
    """A gang member is SIGKILLed while prefilling its OWN segment: the
    reaper collapses the gang, the request re-queues as an ordinary
    single-replica prefill, and the stream matches the oracle exactly —
    no retry burned, no double commit."""
    router = _gang_router(
        per_slot={"1": {"faults": {"replica_crash_during_gang_seg": 1}}},
        log_tag="crash")
    try:
        router.start(min_ready=3)
        tid = router.submit(LONG, max_new_tokens=8, trace_id="crash")
        res = router.run(deadline_s=90)
        assert res[tid]["status"] == "done", res[tid]
        assert res[tid]["tokens"] == toy_stream(LONG, 8)
        assert res[tid]["gang_k"] >= 2          # engaged, then collapsed
        assert res[tid]["gang_merged"] is False
        assert router.gang_fallbacks >= 1
        assert router.double_commits == 0
        assert router.replay_mismatches == 0
    finally:
        router.close()


@pytest.mark.multiprocess
def test_version_skew_refusal_mid_gang_falls_back_bit_identical():
    """A member refuses its segment with version_skew (rolling deploy
    swapped it mid-gang): the gang collapses instead of merging KV
    computed under different weights, and the single-replica fallback
    stays oracle-identical."""
    router = _gang_router(
        per_slot={"1": {"faults": {"gang_refuse_version_skew": 1}}},
        log_tag="skew")
    try:
        router.start(min_ready=3)
        tid = router.submit(LONG, max_new_tokens=8, trace_id="skew")
        res = router.run(deadline_s=90)
        assert res[tid]["status"] == "done", res[tid]
        assert res[tid]["tokens"] == toy_stream(LONG, 8)
        assert res[tid]["gang_merged"] is False
        assert router.gang_fallbacks >= 1
        assert router.gang_merges == 0
        assert router.double_commits == 0
    finally:
        router.close()


@pytest.mark.multiprocess
def test_gang_disabled_is_plain_single_replica():
    router = _gang_router(log_tag="off", gang_prefill=False)
    try:
        router.start(min_ready=3)
        tid = router.submit(LONG, max_new_tokens=8)
        res = router.run(deadline_s=90)
        assert res[tid]["status"] == "done"
        assert res[tid]["tokens"] == toy_stream(LONG, 8)
        assert res[tid]["gang_k"] == 0 and router.gang_plans == 0
    finally:
        router.close()


# ---------------------------------------------------------------------------
# the port's pool: adopt-then-extend equals single-engine prefill (tier-1
# here: the port's engine compiles nothing; fp32 on the CPU)
# ---------------------------------------------------------------------------

def test_engine_gang_segment_bit_identical_on_real_pool():
    """The engine-level gang member leg: engine A prefills segment 0 and
    exports the chain; engine B adopts it through gang_prefill_segment
    and admits the FULL prompt — the radix hit skips the adopted pages,
    B computes only its own segment, and B's greedy stream equals a
    single engine prefilling the whole prompt."""
    from deepspeed_tpu_torch.inference import InferenceEngineV2
    from deepspeed_tpu_torch.models import build_model

    def eng():
        # the same seed: every engine holds the same weights
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
        _gang_member_leg(eng(), eng(), eng())
    finally:
        torch.set_num_threads(prev)


def _gang_member_leg(A, B, C):
    rng = np.random.default_rng(11)
    prompt = list(map(int, rng.integers(0, 256, (37,))))
    seg0 = prompt[:16]                   # member 0's page-aligned segment

    # baseline: one engine prefills the whole prompt
    C.put(1, prompt, max_new_tokens=6)
    while not C.query(1).get("done", False):
        C.step()
    base = C.flush(1)

    # member 0 prefills its segment, publishes, exports the chain
    assert A.gang_prefill_segment(1, seg0, max_new_tokens=1) == 0
    while not A.query(1).get("done", False):
        A.step()
    A.flush(1)
    bundle = A.export_prefix(seg0)
    assert bundle.n_full == 2

    # the final member adopts the hop and extends over the full prompt
    assert B.gang_prefill_segment(1, prompt, prefix_bundle=bundle,
                                  max_new_tokens=6) == 2
    assert B.state.seqs[1].prefix_hit_tokens >= 16
    while not B.query(1).get("done", False):
        B.step()
    assert B.flush(1) == base, "gang-merged stream diverged"
    B.state.audit()
