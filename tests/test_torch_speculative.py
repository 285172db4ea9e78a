"""The port's speculative-decoding host pieces
(``deepspeed_tpu_torch.inference.speculative``, ``SpecAcceptTracker``, the
provisional API and ``rewind`` of ``StateManager``, ``sample_tree_logits``):
port copies of the host units of tests/test_speculative.py, plus
differential traces that drive the port's and the JAX package's pieces with
the same seeded inputs and require the same results after every step."""
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference import PrefixCache as JaxPrefixCache
from deepspeed_tpu.inference import StateManager as JaxStateManager
from deepspeed_tpu.inference import speculative as jax_spec
from deepspeed_tpu.inference.scheduler import \
    SpecAcceptTracker as JaxTracker
from deepspeed_tpu.inference.scheduler import \
    SplitFuseScheduler as JaxScheduler
from deepspeed_tpu_torch.inference import (PrefixCache, SplitFuseScheduler,
                                           StateManager)
from deepspeed_tpu_torch.inference.scheduler import SpecAcceptTracker
from deepspeed_tpu_torch.inference.speculative import (NGramProposer,
                                                       accept_walk,
                                                       build_tree)

# ---------------------------------------------------------------------------
# candidate trees + exact acceptance
# ---------------------------------------------------------------------------


def test_build_tree_merges_shared_prefixes():
    t = build_tree(10, [[5, 6, 7], [5, 8], [9]])
    assert t.tokens == [10, 5, 6, 7, 8, 9]
    assert t.parents == [-1, 0, 1, 2, 1, 0]
    assert t.n_nodes == 6 and t.n_candidates == 5
    assert t.depths() == [0, 1, 2, 3, 2, 1]
    assert t.children() == [[1, 5], [2, 4], [3], [], [], []]
    assert build_tree(10, [[5, 6, 7], [5, 8], [9]],
                      max_nodes=3).tokens == [10, 5, 6]
    t3 = build_tree(10, [])
    assert t3.n_nodes == 1 and t3.n_candidates == 0


def test_ancestor_mask_is_ancestors_only():
    t = build_tree(10, [[5, 6], [7]])          # 10 → {5 → 6, 7}
    m = t.ancestor_mask(6)
    exp = np.zeros((6, 6), np.uint8)
    exp[0, 0] = 1
    exp[1, [0, 1]] = 1
    exp[2, [0, 1, 2]] = 1
    exp[3, [0, 3]] = 1                         # 7 sees root + self, not 5
    np.testing.assert_array_equal(m, exp)
    with pytest.raises(ValueError):
        t.ancestor_mask(2)


def test_accept_walk_full_mid_and_root_rejection():
    t = build_tree(10, [[5, 6], [7]])
    assert accept_walk(t, [5, 6, 42, 0]) == ([5, 6, 42], [0, 1, 2])
    assert accept_walk(t, [5, 9, 0, 0]) == ([5, 9], [0, 1])
    assert accept_walk(t, [8, 0, 0, 0]) == ([8], [0])
    assert accept_walk(t, [7, 0, 0, 11]) == ([7, 11], [0, 3])


def test_ngram_proposer_prompt_lookup_and_probe():
    p = NGramProposer(depth=3, ngram_max=2, ngram_min=1, branches=2)
    hist = [1, 2, 3, 4, 1, 2, 3, 4, 1, 2]
    t = p.propose({7: (hist, 3)})[7]
    assert t.tokens[0] == 2 and t.tokens[1:4] == [3, 4, 1]
    assert p.propose({8: ([5, 6, 7, 8], 3)})[8].n_candidates == 0
    assert p.propose({9: (hist, 0)})[9].n_candidates == 0
    assert p.probe({1: (hist, 3)})
    assert not p.probe({1: ([5, 6, 7, 8], 3)})
    assert not p.probe({1: (hist, 0)}) and not p.probe({})
    with pytest.raises(ValueError):
        NGramProposer(depth=2, ngram_max=1, ngram_min=2)


def test_accept_tracker_adapts_depth():
    tr = SpecAcceptTracker(base_depth=4, shrink_below=0.35, grow_above=0.75)
    assert tr.depth(1) == 4
    assert tr.observe(1, 4, 0) == (4, 3)
    assert tr.observe(1, 4, 0) == (3, 2)
    for _ in range(3):
        tr.observe(1, 4, 0)
    assert tr.depth(1) == 1                    # the floor holds
    for _ in range(8):
        tr.observe(1, 4, 4)
    assert tr.depth(1) == 4                    # back to (never past) base
    assert tr.depth(1, prefill_pending=True, mixed_cap=2) == 2
    assert tr.observe(1, 0, 0) is None         # root-only: no signal
    assert tr.rate(2) == 1.0
    tr.forget(1)
    assert tr.depth(1) == 4


def test_sample_tree_logits_is_per_node_argmax_when_greedy():
    from deepspeed_tpu_torch.inference.sampling import sample_tree_logits

    logits = torch.from_numpy(
        np.random.default_rng(0).standard_normal((3, 5, 17)).astype(
            np.float32))
    got = sample_tree_logits(logits, None, greedy=True)
    assert got.shape == (3, 5)
    assert torch.equal(got, logits.argmax(-1))
    g = torch.Generator().manual_seed(0)
    drawn = sample_tree_logits(logits, g, temperature=0.7, top_k=3)
    top3 = logits.topk(3, dim=-1).indices
    assert (drawn[..., None] == top3).any(-1).all()


# ---------------------------------------------------------------------------
# StateManager's provisional API and rewind
# ---------------------------------------------------------------------------


def _ready(uid, tokens, max_new, **kw):
    st = StateManager(num_blocks=32, block_size=4, max_seqs=2,
                      max_blocks_per_seq=8)
    sched = SplitFuseScheduler(st, chunk=kw.pop("chunk", 8))
    st.admit(uid, tokens, max_new_tokens=max_new, **kw)
    _decode_ready(st, sched, uid)
    return st, sched


def test_provision_bounds_and_commit_speculative():
    st = StateManager(num_blocks=32, block_size=4, max_seqs=2,
                      max_blocks_per_seq=8)
    sched = SplitFuseScheduler(st, chunk=8)
    st.admit(1, [1, 2, 3, 4, 5], max_new_tokens=8)
    with pytest.raises(RuntimeError):
        st.provision(1, 2)                     # still prefilling
    _decode_ready(st, sched, 1)
    seq = st.seqs[1]
    with pytest.raises(ValueError):
        st.provision(1, -1)
    with pytest.raises(RuntimeError):
        st.provision(1, 7)                     # depth + bonus > budget
    st.provision(1, 3)
    st.audit()
    with pytest.raises(ValueError):
        st.commit_speculative(1, [])
    with pytest.raises(RuntimeError):
        st.commit_speculative(1, [9] * 5)
    n0 = seq.n_computed
    assert st.commit_speculative(1, [11, 12, 13]) == [11, 12, 13]
    assert seq.n_provisional == 0 and seq.n_computed == n0 + 3
    assert seq.n_sched == seq.n_computed and seq.n_inflight == 0
    st.provision(1, 2)
    st.rollback_provisional(1)
    st.rollback_provisional(99)                # unknown uid: no-op
    assert seq.n_provisional == 0
    st.release(1)
    st.audit()
    assert st.allocator.free_blocks == 31


def test_commit_speculative_truncates_at_eos():
    st, _ = _ready(1, [1, 2, 3], 8, eos_id=42)
    st.provision(1, 3)
    assert st.commit_speculative(1, [11, 42, 13]) == [11, 42]
    assert st.seqs[1].done
    st.release(1)
    st.audit()


def test_rewind_floors_to_page_boundary_and_guards():
    st, _ = _ready(1, list(range(10)), 8, chunk=16)
    seq = st.seqs[1]
    assert seq.n_computed == 10 and len(seq.tokens) == 11
    st.rewind(1, list(range(10)) + [99])       # lcp 10 → floored to 8
    assert seq.n_computed == seq.n_sched == 8
    assert seq.n_generated == 0 and not seq.done and seq.tokens[-1] == 99
    st.audit()
    with pytest.raises(ValueError):
        st.rewind(1, [])
    with pytest.raises(RuntimeError):
        st.rewind(1, list(range(25)))          # past the 5-block reservation


def test_rewind_longer_history_caps_budget_to_reservation():
    st, sched = _ready(1, [1, 2, 3, 4], 6, chunk=16)
    seq = st.seqs[1]
    cap = len(seq.blocks) * 4
    st.rewind(1, list(range(9)))
    assert seq.max_new_tokens - seq.n_generated == cap - 9
    while not seq.done:
        p = sched.next_step()
        sched.commit(p, {u: 7 for s, u in enumerate(p.uids)
                         if u >= 0 and p.do_sample[s]})
    assert len(seq.tokens) <= cap              # never past its pages
    st.release(1)
    st.audit()


def test_rewind_never_rewrites_shared_prefix_pages():
    st = StateManager(num_blocks=32, block_size=4, max_seqs=2,
                      max_blocks_per_seq=8)
    st.attach_prefix_cache(PrefixCache(4))
    sched = SplitFuseScheduler(st, chunk=16)
    st.admit(1, list(range(8)), max_new_tokens=2)
    while not st.seqs[1].done:
        p = sched.next_step()
        sched.commit(p, {u: 7 for s, u in enumerate(p.uids)
                         if u >= 0 and p.do_sample[s]})
    st.release(1)                              # publishes pages [0:8]
    st.admit(2, list(range(8)) + [100, 101], max_new_tokens=4)
    assert st.seqs[2].n_shared_blocks == 2
    with pytest.raises(RuntimeError):
        st.rewind(2, [0, 1, 2, 99, 4, 5, 6, 7, 100])
    with pytest.raises(RuntimeError):
        st.rewind(2, list(range(8)))
    st.rewind(2, list(range(8)) + [100])       # a suffix-only cut
    st.audit()
    st.release(2)
    st.audit()


def test_audit_flags_provisional_overrun():
    st, _ = _ready(1, [1, 2, 3], 4)
    st.provision(1, 2)
    st.seqs[1].blocks = st.seqs[1].blocks[:1]  # simulated corruption
    with pytest.raises(AssertionError):
        st.audit()


# ---------------------------------------------------------------------------
# differential traces against the JAX package
# ---------------------------------------------------------------------------


def _rand_chains(rng, vocab=6):
    return [[int(t) for t in rng.integers(0, vocab, rng.integers(0, 5))]
            for _ in range(rng.integers(0, 4))]


def test_trees_and_walks_match_the_jax_package():
    """300 seeded trees (small vocab, so chains share prefixes; node
    budgets that cut them): same tokens, parents, depths, children and
    ancestor masks, and the same acceptance walk for random samples."""
    rng = np.random.default_rng(0)
    for _ in range(300):
        root, chains = int(rng.integers(0, 6)), _rand_chains(rng)
        cap = int(rng.integers(0, 9))
        ours = build_tree(root, chains, cap)
        ref = jax_spec.build_tree(root, chains, cap)
        assert (ours.tokens, ours.parents, ours.depths(), ours.children()) \
            == (ref.tokens, ref.parents, ref.depths(), ref.children())
        w = ours.n_nodes + int(rng.integers(0, 3))
        np.testing.assert_array_equal(ours.ancestor_mask(w),
                                      ref.ancestor_mask(w))
        samples = rng.integers(0, 6, ours.n_nodes)
        assert accept_walk(ours, samples) == \
            jax_spec.accept_walk(ref, samples)


def test_ngram_proposals_match_the_jax_package():
    """200 seeded histories over a 5-token vocab (so n-grams repeat) and
    proposer settings: the same trees and the same probe answers."""
    rng = np.random.default_rng(1)
    for _ in range(200):
        kw = dict(depth=int(rng.integers(1, 5)),
                  ngram_max=int(rng.integers(1, 4)), ngram_min=1,
                  branches=int(rng.integers(1, 4)),
                  max_nodes=int(rng.integers(0, 9)))
        reqs = {u: ([int(t) for t in rng.integers(0, 5, rng.integers(1, 30))],
                    int(rng.integers(0, 5))) for u in range(3)}
        ours = NGramProposer(**kw).propose(reqs)
        ref = jax_spec.NGramProposer(**kw).propose(reqs)
        assert {u: (t.tokens, t.parents) for u, t in ours.items()} == \
            {u: (t.tokens, t.parents) for u, t in ref.items()}
        assert NGramProposer(**kw).probe(reqs) == \
            jax_spec.NGramProposer(**kw).probe(reqs)


def test_accept_tracker_matches_the_jax_package():
    rng = np.random.default_rng(2)
    ours, ref = SpecAcceptTracker(4), JaxTracker(4)
    for _ in range(500):
        uid = int(rng.integers(0, 3))
        op = rng.integers(0, 10)
        if op == 0:
            ours.forget(uid)
            ref.forget(uid)
            continue
        proposed = int(rng.integers(0, 5))
        accepted = int(rng.integers(0, proposed + 1))
        assert ours.observe(uid, proposed, accepted) == \
            ref.observe(uid, proposed, accepted)
        pend, cap = bool(rng.integers(0, 2)), int(rng.integers(0, 3))
        assert ours.depth(uid, pend, cap) == ref.depth(uid, pend, cap)
        assert ours.rate(uid) == ref.rate(uid)


def _decode_ready(st, sched, uid, first_tok=7):
    while st.seqs[uid].pending_tokens > 1 or not st.seqs[uid].n_generated:
        p = sched.next_step()
        sched.commit(p, {u: first_tok for s, u in enumerate(p.uids)
                         if u >= 0 and p.do_sample[s]})


def _state(st):
    return ({u: (tuple(s.tokens), tuple(s.blocks), s.n_computed, s.n_sched,
                 s.n_inflight, s.n_generated, s.done, s.n_provisional)
             for u, s in st.seqs.items()}, sorted(st.allocator._free))


@pytest.mark.parametrize("seed0", [0, 25])
def test_provision_commit_rewind_traces_match_the_jax_package(seed0):
    """25 seeded traces x 40 ops per case of admit / step / provision +
    commit_speculative or rollback / rewind (to a prefix, a divergent or a
    longer history — the draft mirror's resync) / release, with a prefix
    cache on half the traces: after every op both managers hold the same
    sequences and free list, raise on the same ops, and the port's
    full-pool audit is clean."""
    for seed in range(seed0, seed0 + 25):
        rng = np.random.default_rng(seed)
        pools = []
        for SM, PC, SC in ((StateManager, PrefixCache, SplitFuseScheduler),
                           (JaxStateManager, JaxPrefixCache, JaxScheduler)):
            st = SM(num_blocks=40, block_size=4, max_seqs=3,
                    max_blocks_per_seq=10)
            if seed % 2:
                st.attach_prefix_cache(PC(4))
            pools.append((st, SC(st, chunk=8)))
        uid = 0
        for i in range(40):
            op = int(rng.integers(0, 6))
            args = [int(x) for x in rng.integers(0, 1000, 4)]
            outs = []
            for st, sched in pools:
                try:
                    outs.append(_spec_op(st, sched, op, args, uid))
                except (RuntimeError, ValueError) as e:
                    outs.append(type(e).__name__)
            uid += op == 0
            assert outs[0] == outs[1], (seed, i, op, outs)
            pools[0][0].audit()
            assert _state(pools[0][0]) == _state(pools[1][0]), (seed, i, op)


def _spec_op(st, sched, op, args, uid):
    live = sorted(st.seqs)
    pick = live[args[0] % len(live)] if live else None
    if op == 0:
        toks = [args[1] % 7 for _ in range(1 + args[2] % 14)]
        if st.can_admit(len(toks), 1 + args[3] % 8):
            st.admit(uid, toks, 1 + args[3] % 8)
        return None
    if pick is None:
        return None
    seq = st.seqs[pick]
    if op == 1:
        p = sched.next_step()
        if p is not None:
            sched.commit(p, {u: args[1] % 7 for s, u in enumerate(p.uids)
                             if u >= 0 and p.do_sample[s]})
        return None
    if op == 2:
        k = args[1] % 4
        st.provision(pick, k)
        if args[2] % 3 == 0:
            st.rollback_provisional(pick)
            return None
        return st.commit_speculative(
            pick, [args[3] % 7 + j for j in range(1 + args[2] % (k + 1))])
    if op == 3:
        # rewind to a prefix, a divergent or a longer history
        cut = 1 + args[1] % len(seq.tokens)
        extra = [args[3] % 7] * (args[2] % 6)
        st.rewind(pick, seq.tokens[:cut] + extra)
        return None
    if op == 4:
        st.release(pick)
        return None
    return (seq.pending_tokens, seq.kv_next)
