"""The port's host-side serving state (``deepspeed_tpu_torch.inference``:
allocator, StateManager, SplitFuse scheduler, prefix cache): port copies of
the fast units of tests/test_inference_v2.py and tests/test_prefix_cache.py,
plus a differential property test that drives the port's and the JAX
package's StateManager + scheduler through the same random op traces and
requires the same state after every op."""
import numpy as np
import pytest

from deepspeed_tpu.inference import PrefixCache as JaxPrefixCache
from deepspeed_tpu.inference import StateManager as JaxStateManager
from deepspeed_tpu.inference.scheduler import \
    SplitFuseScheduler as JaxScheduler
from deepspeed_tpu_torch.inference import (BlockedAllocator, PrefixCache,
                                           SplitFuseScheduler, StateManager)


# ---------------------------------------------------------------------------
# allocator, StateManager, scheduler (tests/test_inference_v2.py)
# ---------------------------------------------------------------------------

def test_allocator_roundtrip():
    a = BlockedAllocator(10)
    assert a.free_blocks == 9          # block 0 reserved
    got = a.allocate(4)
    assert len(set(got)) == 4 and 0 not in got
    assert a.free_blocks == 5
    a.free(got)
    assert a.free_blocks == 9
    with pytest.raises(RuntimeError):
        a.allocate(100)
    with pytest.raises(ValueError):
        a.free([0])


def test_state_manager_slots_and_blocks():
    st = StateManager(num_blocks=16, block_size=4, max_seqs=2,
                      max_blocks_per_seq=8)
    assert st.can_admit(10, 4)
    s1 = st.admit(1, list(range(10)), max_new_tokens=4)
    assert len(s1.blocks) == 4          # ceil((10+4)/4) reserved up front
    st.admit(2, [1, 2], 4)
    assert not st.can_admit(2, 0)       # out of slots
    st.release(1)
    assert st.can_admit(2, 0)
    st.release(2)
    assert st.allocator.free_blocks == 15
    with pytest.raises(ValueError):
        st.admit(3, [], 4)              # empty prompt rejected


def test_scheduler_chunked_prefill_then_decode():
    st = StateManager(num_blocks=64, block_size=4, max_seqs=2,
                      max_blocks_per_seq=16)
    sched = SplitFuseScheduler(st, chunk=8)
    st.admit(7, list(range(20)), max_new_tokens=2)

    p1 = sched.next_step()
    assert p1.kind == "prefill" and p1.active[0].sum() == 8
    assert not p1.do_sample[0]          # chunk does not finish the prompt
    sched.commit(p1, {})
    p2 = sched.next_step()
    sched.commit(p2, {})
    p3 = sched.next_step()
    assert p3.kind == "prefill" and p3.active[0].sum() == 4
    assert p3.do_sample[0]              # finishes the prompt → sample
    sched.commit(p3, {7: 42})
    assert st.seqs[7].tokens[-1] == 42

    p4 = sched.next_step()
    assert p4.kind == "decode" and p4.token_ids[0, 0] == 42
    assert p4.positions[0, 0] == 20
    sched.commit(p4, {7: 43})
    assert st.seqs[7].done              # max_new_tokens reached
    assert sched.next_step() is None


def test_scheduler_token_budget_packing():
    st = StateManager(num_blocks=64, block_size=4, max_seqs=4,
                      max_blocks_per_seq=16)
    sched = SplitFuseScheduler(st, chunk=8, pack=True)
    # one long prompt alone: 1 row, budget 4x8=32 → the whole prompt in ONE
    # step
    st.admit(1, list(range(30)), max_new_tokens=2)
    p1 = sched.next_step()
    assert p1.kind == "prefill" and p1.token_ids.shape == (1, 32)
    assert int(p1.active.sum()) == 30
    assert p1.do_sample[0] and p1.uids[0] == 1
    assert p1.row_slots[0] == st.seqs[1].slot
    sched.commit(p1, {1: 42})
    # mixed load: prefill plans stay pure; decode comes out on request
    st.admit(2, list(range(9)), max_new_tokens=2)
    p2 = sched.next_step()
    assert p2.kind == "prefill" and p2.token_ids.shape == (1, 16)
    p2d = sched.next_step(prefer="decode")
    assert p2d.kind == "decode" and p2d.token_ids.shape == (4, 1)
    assert p2d.uids[st.seqs[1].slot] == 1
    # two prompts pending: exact-k rows with the budget split across them
    st.admit(3, list(range(20)), max_new_tokens=1)
    st.admit(4, list(range(20)), max_new_tokens=1)
    sched.commit(p2, {2: 7})
    p3 = sched.next_step()
    assert p3.kind == "prefill" and p3.token_ids.shape == (2, 16)
    assert sorted(u for u in p3.uids if u > 0) == [3, 4]


def test_program_shape_menu_covers_scheduler_emissions():
    rng = np.random.default_rng(0)
    st = StateManager(num_blocks=256, block_size=4, max_seqs=5,
                      max_blocks_per_seq=16)
    sched = SplitFuseScheduler(st, chunk=8, pack=True)
    menu = set(sched.program_shape_menu())
    uid = 0
    for _ in range(300):
        while st.can_admit(30, 4) and rng.random() < 0.6:
            uid += 1
            st.admit(uid, list(map(int, rng.integers(
                0, 50, int(rng.integers(1, 30))))), int(rng.integers(1, 4)))
        plan = sched.next_step(
            prefer="decode" if rng.random() < 0.5 else None)
        if plan is None:
            for u in list(st.seqs):
                st.release(u)
            continue
        if plan.kind == "prefill":
            T, S = plan.token_ids.shape[1], plan.token_ids.shape[0]
            assert (T, S) in menu, ((T, S), sorted(menu))
        sampled = {u: 7 for s_i, u in enumerate(plan.uids)
                   if u >= 0 and plan.do_sample[s_i]}
        sched.commit(plan, sampled)
        for u in [u for u, s in st.seqs.items() if s.done]:
            st.release(u)


def test_scheduler_module_loads_no_telemetry():
    import subprocess
    import sys

    code = ("import sys, deepspeed_tpu_torch.inference.scheduler; "
            "bad = [m for m in sys.modules if 'telemetry' in m or "
            "m.split('.')[0] in ('jax', 'deepspeed_tpu')]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)


# ---------------------------------------------------------------------------
# prefix cache (tests/test_prefix_cache.py)
# ---------------------------------------------------------------------------

def test_match_returns_longest_page_aligned_chain():
    pc = PrefixCache(4)
    toks = list(range(12))
    assert pc.publish(toks, [1, 2, 3], n_shared=0, n_tokens=12) == []
    assert [n.block for n in pc.match(toks)] == [1, 2, 3]
    assert [n.block for n in pc.match(toks[:11])] == [1, 2]
    assert [n.block for n in pc.match(toks, max_tokens=9)] == [1, 2]
    assert pc.match([9, 9, 9, 9]) == []
    assert [n.block for n in pc.match(toks[:4] + [99] * 8)] == [1]


def test_publish_dedups_and_returns_partial_tail():
    pc = PrefixCache(4)
    toks = list(range(10))
    assert pc.publish(toks, [1, 2, 3], n_shared=0, n_tokens=10) == [3]
    assert pc.publish(toks, [4, 5, 6], n_shared=0, n_tokens=10) == [4, 5, 6]
    assert len(pc) == 2 and pc.stats()["deduped_pages"] == 2
    assert pc.publish(toks[:4] + [77, 77, 77, 77], [7, 8], 0, 8) == [7]
    assert len(pc) == 3


def test_refcounts_pin_and_evict_is_lru_leaf_first():
    pc = PrefixCache(2)
    pc.publish([1, 2, 3, 4], [1, 2], 0, 4)
    pc.publish([1, 2, 9, 9], [3, 4], 0, 4)
    chain = pc.match([1, 2, 3, 4])
    pc.acquire(chain)
    assert pc.evictable_blocks == 1
    assert pc.evict(10) == [4]
    assert pc.evict(10) == []
    pc.release(chain)
    assert pc.evict(1) == [2]
    assert pc.evict(1) == [1]
    assert len(pc) == 0
    with pytest.raises(RuntimeError):
        pc.release(chain)


def _state(num_blocks=32, bs=4, max_seqs=4, mb=8):
    st = StateManager(num_blocks=num_blocks, block_size=bs,
                      max_seqs=max_seqs, max_blocks_per_seq=mb)
    st.attach_prefix_cache(PrefixCache(bs))
    return st


def _finish(st, sched, uid):
    while not st.seqs[uid].done:
        p = sched.next_step()
        sched.commit(p, {u: 7 for s, u in enumerate(p.uids)
                         if u >= 0 and p.do_sample[s]})


def test_admit_adopts_cached_chain_and_release_publishes():
    st = _state()
    sched = SplitFuseScheduler(st, chunk=8)
    st.admit(1, list(range(13)), max_new_tokens=2)
    _finish(st, sched, 1)
    st.release(1)
    st.audit()
    assert len(st.prefix_cache) == 3
    s2 = st.admit(2, list(range(13)), max_new_tokens=2)
    assert s2.n_shared_blocks == 3 and s2.prefix_hit_tokens == 12
    assert s2.pending_tokens == 1
    st.audit()
    _finish(st, sched, 2)
    st.release(2)
    st.audit()


def test_last_prompt_token_is_never_served_from_cache():
    st = _state()
    sched = SplitFuseScheduler(st, chunk=8)
    st.admit(1, list(range(16)), max_new_tokens=1)
    _finish(st, sched, 1)
    st.release(1)
    s2 = st.admit(2, list(range(16)), max_new_tokens=1)
    assert s2.n_shared_blocks == 3 and s2.pending_tokens == 4


def test_alloc_pressure_evicts_only_unreferenced_pages():
    st = _state(num_blocks=9, bs=4, max_seqs=3, mb=8)
    sched = SplitFuseScheduler(st, chunk=8)
    st.admit(1, list(range(8)), max_new_tokens=1)
    _finish(st, sched, 1)
    st.release(1)
    st.admit(2, list(range(8)), max_new_tokens=1)
    assert st.prefix_cache.evictable_blocks == 1
    assert st.can_admit(20, 0) and not st.can_admit(24, 0)
    st.admit(3, list(range(100, 120)), 0)
    st.audit()
    assert st.prefix_cache.cached_blocks == 1
    st.release(3), st.release(2)
    st.audit()


def test_admit_rollback_on_pool_exhaustion_releases_pins():
    st = _state(num_blocks=7, bs=4, max_seqs=3, mb=6)
    sched = SplitFuseScheduler(st, chunk=8)
    st.admit(1, list(range(8)), max_new_tokens=1)
    _finish(st, sched, 1)
    st.release(1)
    st.admit(2, list(range(50, 66)), max_new_tokens=4)
    with pytest.raises(RuntimeError):
        st.admit(3, list(range(12)), max_new_tokens=8)
    st.audit()
    assert st.prefix_cache.referenced_blocks == 0
    assert 3 not in st.seqs and st.can_admit(4, 0)


def test_audit_detects_seeded_corruption():
    st = _state()
    sched = SplitFuseScheduler(st, chunk=8)
    st.admit(1, list(range(13)), max_new_tokens=1)
    _finish(st, sched, 1)
    st.release(1)
    st.admit(2, list(range(13)), max_new_tokens=1)
    st.audit()
    node = st._shared_nodes[2][0]
    node.refs += 1
    with pytest.raises(AssertionError, match="refcount drift"):
        st.audit()
    node.refs -= 1
    st.allocator._free.pop()
    with pytest.raises(AssertionError, match="leaked"):
        st.audit()


# ---------------------------------------------------------------------------
# differential property test: port vs JAX package, same traces
# ---------------------------------------------------------------------------

_TEMPLATES = [tuple(range(0, 40)), tuple(range(100, 140)),
              tuple(range(0, 20)) + tuple(range(200, 220))]


def _gen_ops(rng, n_ops):
    ops = []
    for _ in range(n_ops):
        r = rng.random()
        if r < 0.30:
            base = _TEMPLATES[int(rng.integers(len(_TEMPLATES)))]
            cut = int(rng.integers(1, len(base) + 1))
            extra = [int(t) for t in
                     rng.integers(300, 310, int(rng.integers(0, 6)))]
            ops.append(("admit", list(base[:cut]) + extra,
                        int(rng.integers(0, 4))))
        elif r < 0.55:
            ops.append(("dispatch", "decode" if rng.random() < 0.4 else None))
        elif r < 0.72:
            ops.append(("commit", int(rng.integers(0, 50))))
        elif r < 0.84:
            ops.append(("flush", int(rng.integers(0, 8))))
        elif r < 0.92:
            ops.append(("spec", int(rng.integers(0, 4)),
                        int(rng.integers(1, 4)), int(rng.integers(0, 5))))
        elif r < 0.96:
            ops.append(("evict", int(rng.integers(1, 5))))
        else:
            ops.append(("pull", int(rng.integers(len(_TEMPLATES))),
                        int(rng.integers(1, 11))))
    return ops


def _pool(state_cls, cache_cls, sched_cls):
    st = state_cls(num_blocks=24, block_size=4, max_seqs=4,
                   max_blocks_per_seq=8)
    st.attach_prefix_cache(cache_cls(4))
    return {"st": st, "sched": sched_cls(st, chunk=8, pack=True),
            "inflight": [], "uid": 1}


def _apply(P, op):
    st, sched, inflight = P["st"], P["sched"], P["inflight"]

    def commit_oldest(tok):
        plan = inflight.pop(0)
        sched.commit(plan, {u: tok for s, u in enumerate(plan.uids)
                            if u >= 0 and plan.do_sample[s]
                            and u in st.seqs})

    kind = op[0]
    if kind == "admit":
        if st.can_admit(len(op[1]), op[2]):
            st.admit(P["uid"], op[1], op[2])
            P["uid"] += 1
    elif kind == "dispatch":
        plan = sched.next_step(prefer=op[1])
        if plan is not None:
            sched.mark_dispatched(plan)
            inflight.append(plan)
    elif kind == "commit":
        if inflight:
            commit_oldest(op[1])
    elif kind == "flush":
        live = sorted(st.seqs)
        if live:
            uid = live[op[1] % len(live)]
            while any(uid in p.uids for p in inflight):
                commit_oldest(0)
            st.release(uid)
    elif kind == "spec":
        _, pick, n, accept = op
        cands = [u for u, s in sorted(st.seqs.items())
                 if not s.done and s.pending_tokens == 1
                 and s.max_new_tokens - s.n_generated > 1
                 and not any(u in p.uids for p in inflight)]
        if cands:
            uid = cands[pick % len(cands)]
            seq = st.seqs[uid]
            k = min(n, seq.max_new_tokens - seq.n_generated - 1)
            if k >= 1:
                st.provision(uid, k)
                if accept == 0:
                    st.rollback_provisional(uid)
                else:
                    st.commit_speculative(
                        uid, [700 + i for i in range(1 + (accept - 1)
                                                    % (k + 1))])
    elif kind == "evict":
        n = min(op[1], st.allocator.free_blocks
                + st.prefix_cache.evictable_blocks)
        if n > 0:
            st.allocator.free(st._alloc(n))
    elif kind == "pull":
        # a radix pull into this pool of a template's pages (the adopt half)
        tokens = list(_TEMPLATES[op[1]][:op[2] * 4])
        snap = st.snapshot_prefix(tokens)
        if snap is not None:
            st.release_prefix(snap["handle"])
        try:
            st.adopt_prefix(tokens, len(tokens))
        except RuntimeError:
            pass                      # pool full: the recompute fallback


def _observe(P):
    st = P["st"]
    seqs = {u: (s.slot, tuple(s.tokens), tuple(s.blocks), s.n_computed,
                s.n_sched, s.n_inflight, s.n_generated, s.done,
                s.n_shared_blocks, s.n_provisional)
            for u, s in st.seqs.items()}
    plans = [(p.kind, p.token_ids.tolist(), p.slot_map.tolist(),
              p.block_tables.tolist(), list(p.uids)) for p in P["inflight"]]
    # the JAX package's cache also counts KV-tier demotions, a later slice
    stats = st.prefix_cache.stats()
    stats = {k: stats[k] for k in PrefixCache(4).stats()}
    return (seqs, sorted(st.allocator._free), sorted(st.prefix_cache.blocks()),
            stats, plans)


@pytest.mark.parametrize("seed0", [0, 40])
def test_port_state_machine_matches_the_jax_package(seed0):
    """40 seeded traces x 60 ops per case of admit/dispatch/commit/flush/
    spec/evict/pull: after every op the port's sequences, free list, trie
    and in-flight plans equal the JAX package's, and the port's full-pool
    audit is clean."""
    for seed in range(seed0, seed0 + 40):
        ops = _gen_ops(np.random.default_rng(seed), 60)
        ours = _pool(StateManager, PrefixCache, SplitFuseScheduler)
        ref = _pool(JaxStateManager, JaxPrefixCache, JaxScheduler)
        for i, op in enumerate(ops):
            _apply(ours, op)
            _apply(ref, op)
            ours["st"].audit()
            assert _observe(ours) == _observe(ref), (seed, i, op)


# ---------------------------------------------------------------------------
# sampling (inference/sampling.py)
# ---------------------------------------------------------------------------

def test_greedy_sampling_is_argmax_with_the_first_index_on_ties():
    import jax.numpy as jnp
    import torch

    from deepspeed_tpu.inference.sampling import sample_logits as jax_sample
    from deepspeed_tpu_torch.inference.sampling import sample_logits

    logits = np.array([[0.5, 2.0, 2.0, -1.0], [3.0, 3.0, 3.0, 3.0],
                       [-2.0, -1.0, -3.0, -1.5]], np.float32)
    got = sample_logits(torch.from_numpy(logits), None, greedy=True)
    ref = jax_sample(jnp.asarray(logits), None, greedy=True)
    assert got.tolist() == np.asarray(ref).tolist() == [1, 0, 1]


def test_stochastic_sampling_draws_from_the_filtered_softmax():
    """A torch.Generator's stream differs from JAX's threefry, so sampling
    is checked by distribution: the top-k / top-p support and the softmax
    frequencies within it."""
    import torch

    from deepspeed_tpu_torch.inference.sampling import sample_logits

    logits = torch.tensor([[0.0, 1.0, 2.0, -4.0]]).repeat(4000, 1)
    g = torch.Generator().manual_seed(0)
    draw = lambda **kw: sample_logits(logits, g, **kw)
    freq = torch.bincount(draw(), minlength=4).float() / 4000
    want = torch.softmax(logits[0], 0)
    assert (freq - want).abs().max() < 0.03
    top2 = draw(top_k=2)
    assert set(top2.tolist()) == {1, 2}
    top2_freq = (top2 == 2).float().mean()
    assert abs(top2_freq - torch.sigmoid(torch.tensor(1.0))) < 0.03
    # nucleus 0.5: the top token alone already carries 0.66
    assert set(draw(top_p=0.5).tolist()) == {2}
    assert set(draw(top_k=3, top_p=0.9).tolist()) == {1, 2}
    assert set(draw(temperature=0.0).tolist()) == {2}
