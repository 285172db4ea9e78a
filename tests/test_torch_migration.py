"""KV-page movement, ported: the wire form (``inference/migration.py``), the
refcounted migration API of ``StateManager`` and the engine's
``export_*`` / ``import_*``, radix pulls and gang-prefill segments — each
held against the JAX package's.

- Wire form: bundles built alike in both packages have the same meta bytes,
  chunks and crc32, and chunks of either reassemble in the other.
- ``StateManager``: seeded op traces with the six migration mutators (plus
  admits, decode steps, releases, pulls and cache flushes) leave the port's
  state equal to the JAX package's after every op, with ``audit()`` clean.
- Engines (tiny-gpt2, hidden 256 — head dim 64, the paged-attention
  kernel's geometry — fp32, the same flax-initialised weights): a sequence
  exported by either package's engine and imported by the other continues
  with the JAX single-engine baseline's greedy stream, for an fp32 and an
  e4m3 pool, the imported pages bit for bit the exported bytes; the same for
  a pulled prefix and a gang-prefill segment. With the e4m3 pool both
  engines read the pool through the gather formulation (the JAX engine's
  ``use_pallas_decode=False``): the kernel's e4m3 form rounds p, which the
  gather path does not, so streams compare within one formulation.
- Refusals (ring, block size, dtype, page geometry, version skew) raise the
  JAX engine's ``MigrationError`` messages."""
import dataclasses
import json
from types import SimpleNamespace

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference import InferenceEngineV2 as JaxEngine
from deepspeed_tpu.inference import PrefixCache as JaxPrefixCache
from deepspeed_tpu.inference import StateManager as JaxStateManager
from deepspeed_tpu.inference import migration as jmig
from deepspeed_tpu.inference import prefix_cache as jpc
from deepspeed_tpu.inference.scheduler import \
    SplitFuseScheduler as JaxScheduler
from deepspeed_tpu.models import build_model as jax_build_model
from deepspeed_tpu.parallel.topology import MeshTopology
from deepspeed_tpu_torch.inference import (InferenceEngineV2, PrefixCache,
                                           SplitFuseScheduler, StateManager,
                                           params_from_jax)
from deepspeed_tpu_torch.inference import migration as tmig
from deepspeed_tpu_torch.inference import prefix_cache as tpc
from deepspeed_tpu_torch.models import build_model
from deepspeed_tpu_torch.ops import paged_attention as pa
from tests.test_torch_host import _TEMPLATES, _apply, _gen_ops

PACKAGES = {"jax": jmig, "port": tmig}
CFG = {"block_size": 8, "num_blocks": 64, "max_seqs": 4, "chunk": 8,
       "max_seq_len": 128, "prefix_cache": True, "decode_window": 2}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# ---------------------------------------------------------------------------
# the wire form
# ---------------------------------------------------------------------------

def test_chain_hashes_are_the_jax_packages():
    rng = np.random.default_rng(3)
    toks = [int(t) for t in rng.integers(0, 50000, 203)]
    for bs in (1, 8, 64):
        assert tpc.chain_hashes(toks, bs) == jpc.chain_hashes(toks, bs)
    assert tpc.page_hash(12345, toks[:8]) == jpc.page_hash(12345, toks[:8])


def _toy(mod, kind):
    wv = {"id": 3, "digest": "ab12"}
    if kind == "seq":
        return mod.toy_bundle("t-7", list(range(40)), [900, 901, 902], 16,
                              7, "acme", 8, weight_version=wv)
    return mod.toy_prefix_bundle("t-8", list(range(45)), 8,
                                 weight_version=wv)


@pytest.mark.parametrize("kind", ["seq", "prefix"])
@pytest.mark.parametrize("src,dst", [("jax", "port"), ("port", "jax")])
def test_bundles_cross_between_the_packages(kind, src, dst):
    a, b = _toy(PACKAGES[src], kind), _toy(PACKAGES[dst], kind)
    # the same meta bytes, chunks (framing, crc32, base64) and raw payloads
    assert json.dumps(a.meta()) == json.dumps(b.meta())
    for max_bytes in (7, 20, 1 << 18):
        assert PACKAGES[src].iter_chunks(a, max_bytes) == \
            PACKAGES[dst].iter_chunks(b, max_bytes)
        assert PACKAGES[src].iter_chunks(a, max_bytes, encode=False) == \
            PACKAGES[dst].iter_chunks(b, max_bytes, encode=False)
    # src's chunks, out of order and one duplicated, assemble in dst
    chunks = PACKAGES[src].iter_chunks(a, max_bytes=20)
    asm = PACKAGES[dst].BundleAssembler(json.loads(json.dumps(a.meta())))
    for c in reversed(chunks):
        asm.add(c)
    asm.add(chunks[0])
    asm.eof(len(chunks))
    got = asm.assemble()
    assert got.pages == a.pages and got.tail == a.tail
    PACKAGES[dst].toy_verify(got)
    # a torn chunk is refused by the receiver's crc gate
    bad = dict(chunks[1], crc=chunks[1]["crc"] ^ 1)
    with pytest.raises(PACKAGES[dst].MigrationError, match="crc"):
        PACKAGES[dst].BundleAssembler(a.meta()).add(bad)


def test_version_skew_and_validation_match():
    for x, y in [(None, None), (None, {"id": 1}), ({"id": 1}, {"id": 1}),
                 ({"id": 1, "digest": "a"}, {"id": 1, "digest": "b"})]:
        assert tmig.version_skew(x, y) == jmig.version_skew(x, y)
    a, b = _toy(jmig, "seq"), _toy(tmig, "seq")
    for mutate in (lambda z: setattr(z, "chain", z.chain[:-1]),
                   lambda z: setattr(z, "n_generated", 1),
                   lambda z: setattr(z, "pages", z.pages[:-1])):
        mutate(a)
        mutate(b)
        with pytest.raises(jmig.MigrationError) as ja:
            a.validate()
        with pytest.raises(tmig.MigrationError) as ta:
            b.validate()
        assert str(ja.value) == str(ta.value)
        a, b = _toy(jmig, "seq"), _toy(tmig, "seq")


# ---------------------------------------------------------------------------
# StateManager's migration API against the JAX package's
# ---------------------------------------------------------------------------

def _pool():
    out = []
    for st_cls, pc_cls, sched_cls in (
            (StateManager, PrefixCache, SplitFuseScheduler),
            (JaxStateManager, JaxPrefixCache, JaxScheduler)):
        st = st_cls(num_blocks=28, block_size=4, max_seqs=4,
                    max_blocks_per_seq=8)
        st.attach_prefix_cache(pc_cls(4))
        out.append({"st": st, "sched": sched_cls(st, chunk=8, pack=True),
                    "inflight": [], "uid": 1, "imports": 0})
    return out


def _mig_op(P, op):
    """One migration op on pool ``P``; returns what it returned or raised
    (type and message), so both packages can be compared."""
    st, inflight = P["st"], P["inflight"]
    kind, pick = op[0], op[1]
    live = sorted(st.seqs)
    try:
        if kind == "out":
            cands = [u for u in live
                     if not any(u in p.uids for p in inflight)]
            if cands:
                return st.migrate_out(cands[pick % len(cands)])
        elif kind in ("ack", "abort_out"):
            outs = [u for u in live if st.seqs[u].migrating == "out"]
            if outs:
                uid = outs[pick % len(outs)]
                if kind == "ack":
                    st.export_ack(uid)
                    st.release(uid)
                else:
                    st.export_abort(uid)
        elif kind == "in":
            base = _TEMPLATES[pick % len(_TEMPLATES)]
            n = 5 + pick % 20
            P["imports"] += 1
            seq = st.migrate_in_begin(1000 + P["imports"], list(base[:n]),
                                      n - 1 - pick % 3, pick % 2, 3)
            return (seq.slot, list(seq.blocks))
        elif kind in ("commit_in", "abort_in"):
            ins = [u for u in live if st.seqs[u].migrating == "in"]
            if ins:
                uid = ins[pick % len(ins)]
                (st.import_commit if kind == "commit_in"
                 else st.abort_import)(uid)
        elif kind == "flush_cache":
            return st.flush_prefix_cache()
        elif kind == "release":
            if live:
                uid = live[pick % len(live)]
                if not any(uid in p.uids for p in inflight):
                    st.release(uid)
        elif kind == "misuse":
            # every refusal: release of a pinned sequence, double
            # migrate_out, commit / ack without a transfer in flight
            uid = live[pick % len(live)] if live else 1
            [st.release, st.migrate_out, st.import_commit,
             st.export_ack][pick % 4](uid)
    except (RuntimeError, ValueError, KeyError) as e:
        return (type(e).__name__, str(e))
    return None


def _mig_ops(rng, n):
    kinds = ["out", "ack", "abort_out", "in", "commit_in", "abort_in",
             "flush_cache", "release", "misuse"]
    ops = []
    for base in _gen_ops(rng, n):
        ops.append(base)
        if rng.random() < 0.6:
            ops.append((kinds[int(rng.integers(len(kinds)))],
                        int(rng.integers(0, 50))))
    return ops


def _observe(P):
    st = P["st"]
    seqs = {u: (s.slot, tuple(s.tokens), tuple(s.blocks), s.n_computed,
                s.n_sched, s.n_inflight, s.n_generated, s.done,
                s.n_shared_blocks, s.migrating, s.admit_wv, s.frozen,
                s.sched_done)
            for u, s in st.seqs.items()}
    return (seqs, sorted(st.allocator._free), sorted(st.prefix_cache.blocks()),
            st.prefix_cache.stats(), st.prefix_cache.residency_digest())


@pytest.mark.parametrize("seed0", [0, 25])
def test_migration_mutators_match_the_jax_state_manager(seed0):
    """25 seeded traces per case mixing the six migration mutators, cache
    flushes and misuse with admits, plans, commits, releases, evictions and
    pulls: after every op the port's sequences, free list, trie, cache stats
    and digest equal the JAX package's, every migration op returns or raises
    the same, and both audits are clean."""
    for seed in range(seed0, seed0 + 25):
        ours, ref = _pool()
        for i, op in enumerate(_mig_ops(np.random.default_rng(seed), 50)):
            if op[0] in ("admit", "dispatch", "commit", "flush", "spec",
                         "evict", "pull"):
                if op[0] in ("flush", "spec"):
                    continue     # frozen sequences: covered by "release"
                _apply(ours, op)
                _apply(ref, op)
            else:
                assert _mig_op(ours, op) == _mig_op(ref, op), (seed, i, op)
            ours["st"].audit()
            ref["st"].audit()
            assert _observe(ours) == _observe(ref), (seed, i, op)


def test_frozen_sequences_schedule_nothing():
    st = StateManager(num_blocks=32, block_size=4, max_seqs=2,
                      max_blocks_per_seq=8)
    st.attach_prefix_cache(PrefixCache(4))
    sched = SplitFuseScheduler(st, chunk=8)
    st.migrate_in_begin(1, list(range(10)), 9, 0, 4)
    assert sched.next_step() is None
    summary = sched.load_summary()
    assert summary["migrating"] == 1 and summary["queued"] == 0
    assert sched.queue_depth() == 0
    st.import_commit(1)
    assert st.seqs[1].n_shared_blocks == 2 and sched.queue_depth() == 1
    plan = sched.next_step()
    assert plan.kind == "decode" and plan.uids[0] == 1
    st.audit()


# ---------------------------------------------------------------------------
# engines across the packages
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def weights():
    """(JAX model, host params, port model, port params): tiny-gpt2 at
    hidden 256, fp32, flax-initialised."""
    jm = jax_build_model("tiny-gpt2", dtype=jnp.float32, hidden_size=256,
                         num_heads=4)
    params = jm.init(jax.random.PRNGKey(5),
                     jnp.zeros((1, 8), jnp.int32))["params"]
    host = jax.device_get(flax.core.meta.unbox(params))
    tm = build_model("tiny-gpt2", device="cpu", dtype=torch.float32,
                     hidden_size=256, num_heads=4)
    return jm, host, tm, params_from_jax(host, tm.config,
                                         dtype=torch.float32, device="cpu")


def engine(weights, pkg: str, kv=None, **over):
    jm, host, tm, tree = weights
    cfg = dict(CFG, **over)
    if kv:
        cfg["kv_cache_dtype"] = kv
    if pkg == "jax":
        return JaxEngine(jm, params=jax.tree.map(jnp.asarray, host),
                         config=dict(cfg, dtype=jnp.float32,
                                     use_pallas_decode=False),
                         topology=MeshTopology({"tensor": 1, "data": 1}))
    if kv == "fp8":
        cfg["use_pallas_decode"] = False      # the JAX engine's formulation
    return InferenceEngineV2(tm, params=tree, config=dict(
        cfg, dtype=torch.float32, device="cpu"))


def serve(eng, uid, prompt, new):
    eng.put(uid, prompt, max_new_tokens=new)
    while not eng.query(uid).get("done", False):
        eng.step()
    return eng.flush(uid)


def pool_page(eng, block) -> bytes:
    """One pool page's bytes, [L, 2, KV, block_size, D] in C order."""
    if isinstance(eng, JaxEngine):
        return np.asarray(eng.kv_pool[:, :, :, block]).tobytes()
    return eng.kv_pool.view(torch.uint8)[:, :, :, block].contiguous(
    ).numpy().tobytes()


def wire(bundle, dst: str):
    """The bundle's chunks, out of order, reassembled by ``dst``'s
    package."""
    mod = PACKAGES[dst]
    chunks = mod.iter_chunks(bundle, max_bytes=16384)
    asm = mod.BundleAssembler(json.loads(json.dumps(bundle.meta())))
    for c in reversed(chunks):
        asm.add(c)
    asm.eof(len(chunks))
    return asm.assemble()


PROMPT = [int(t) for t in np.random.default_rng(7).integers(0, 256, 21)]


@pytest.mark.parametrize("kv", [None, "fp8"])
@pytest.mark.parametrize("src,dst", [("jax", "port"), ("port", "jax")])
def test_engine_handoff_across_the_packages(weights, kv, src, dst):
    """test_disagg's real-pool handoff across the packages: prefill and the
    first token on ``src``, export, the wire, import and decode on ``dst``:
    the JAX single-engine baseline's greedy stream; imported pages bit for
    bit the exported bytes; both tries serve the prefix afterwards."""
    base = serve(engine(weights, "jax", kv), 1, PROMPT, 10)
    A, B = engine(weights, src, kv), engine(weights, dst, kv)
    A.put(1, PROMPT, max_new_tokens=10)
    while not A.state.seqs[1].done and A.state.seqs[1].n_generated < 1:
        A.step()
    bundle = A.export_migration(1, trace_id="t-1", tenant="acme")
    A.state.audit()
    assert A.state.seqs[1].frozen and A.state.seqs[1].n_inflight == 0
    prefix = list(A._results[1])
    assert bundle.n_generated == len(prefix) >= 1
    assert bundle.kv_dtype == ("float8_e4m3fn" if kv else "float32")
    got = wire(bundle, dst)
    assert B.can_import(len(got.tokens), got.max_new_tokens - got.n_generated)
    B.import_reserve(9, got.meta())
    B.state.audit()
    assert B.state.seqs[9].frozen
    B.import_complete(9, got)
    B.state.audit()
    seq = B.state.seqs[9]
    assert seq.pending_tokens == 1 and not seq.frozen
    for j, page in enumerate(bundle.pages):
        assert pool_page(B, seq.blocks[j]) == page
    plain0 = pa.counts.plain
    while not B.query(9).get("done", False):
        B.step()
    if dst == "port" and not kv:
        assert pa.counts.plain > plain0       # K1 served the imported slot
    assert B.flush(9) == base, "handoff stream diverged from the baseline"
    B.state.audit()
    assert A.export_commit(1) == prefix
    A.state.audit()
    for eng in (A, B):
        eng.put(2, PROMPT + [3], max_new_tokens=1)
        assert eng.state.seqs[2].prefix_hit_tokens >= 16
        eng.flush(2)
        eng.state.audit()
    assert A.stats["migrations_out"] == 1 and B.stats["migrations_in"] == 1
    assert B.stats["migration_bytes_in"] == bundle.payload_bytes


def test_export_abort_resumes_locally_and_flush_aborts(weights):
    base = serve(engine(weights, "jax"), 1, PROMPT, 10)
    A = engine(weights, "port")
    A.put(1, PROMPT, max_new_tokens=10)
    while A.state.seqs[1].n_generated < 2:
        A.step()
    A.export_migration(1)
    with pytest.raises(RuntimeError, match="pinned"):
        A.state.release(1)
    assert A.load_summary()["migrating"] == 1
    A.export_abort(1)
    while not A.query(1)["done"]:
        A.step()
    assert A.flush(1) == base
    # a reserved import flushed before completion hands its blocks back
    free0 = A.state.allocator.free_blocks
    A.import_reserve(5, A.export_prefix(PROMPT).meta() | {
        "kind": "seq", "nc": 16, "tok": PROMPT, "plen": 21, "max_new": 4})
    A.flush(5)
    assert A.state.allocator.free_blocks == free0
    A.state.audit()
    assert A.drain() is True


@pytest.mark.parametrize("case", ["ring", "block_size", "dtype",
                                  "geometry", "version_skew"])
def test_import_refusals_match_the_jax_engine(weights, case):
    A = engine(weights, "jax")
    A.put(1, PROMPT, max_new_tokens=10)
    while A.state.seqs[1].n_generated < 1:
        A.step()
    bundle = A.export_migration(1)
    meta = bundle.meta()
    if case == "ring":
        jm, host, tm, tree = weights
        windowed = SimpleNamespace(config=dataclasses.replace(
            tm.config, sliding_window=16))
        eng = InferenceEngineV2(windowed, params=tree, config=dict(
            CFG, prefix_cache=False, dtype=torch.float32, device="cpu"))
        assert not eng.can_import(21, 4)
        with pytest.raises(tmig.MigrationError,
                           match="rolling-ring pools cannot import"):
            eng.import_reserve(9, meta)
        return
    jax_eng = engine(weights, "jax")
    port = engine(weights, "port")
    if case == "block_size":
        meta["bs"] = 16
    elif case == "dtype":
        meta["dtype"] = "bfloat16"
    elif case == "geometry":
        meta["page_bytes"] //= 2
    errs = []
    for eng, mod in ((jax_eng, jmig), (port, tmig)):
        with pytest.raises(mod.MigrationError) as e:
            if case == "version_skew":
                eng.import_reserve(9, meta)
                b = mod.BundleAssembler(meta)
                for c in mod.iter_chunks(bundle):
                    b.add(c)
                b.eof(len(mod.iter_chunks(bundle)))
                got = b.assemble()
                got.weight_version = {"id": 4, "digest": "other"}
                try:
                    eng.import_complete(9, got)
                finally:
                    eng.import_abort(9)
            else:
                eng.import_reserve(9, meta)
        errs.append(str(e.value))
        eng.state.audit()
        assert 9 not in eng.state.seqs
    assert errs[0] == errs[1]


@pytest.mark.parametrize("src,dst", [("jax", "port"), ("port", "jax")])
def test_prefix_pull_across_the_packages(weights, src, dst):
    """test_kv_pull's real-pool pull across the packages: a chain exported
    from ``src``'s trie and adopted by ``dst`` serves ``dst``'s request
    from cache with the baseline's stream; a re-import surrenders every
    copy; a miss is a MigrationError."""
    A, B = engine(weights, src), engine(weights, dst)
    base = serve(A, 1, PROMPT, 6)
    A.state.audit()
    bundle = A.export_prefix(PROMPT)
    A.state.audit()
    assert bundle.kind == "prefix" and bundle.n_full == 2
    got = wire(bundle, dst)
    assert B.import_prefix(got) == 2
    B.state.audit()
    B.put(1, PROMPT, max_new_tokens=6)
    seq = B.state.seqs[1]
    assert seq.prefix_hit_tokens >= 16
    for j in range(2):
        assert pool_page(B, seq.blocks[j]) == bundle.pages[j]
    while not B.query(1).get("done", False):
        B.step()
    assert B.flush(1) == base, "pulled-prefix stream diverged"
    B.state.audit()
    free0 = B.state.allocator.free_blocks
    assert B.import_prefix(wire(A.export_prefix(PROMPT), dst)) == 2
    assert B.state.allocator.free_blocks == free0
    B.state.audit()
    with pytest.raises(PACKAGES[src].MigrationError):
        A.export_prefix([999] * 16)


@pytest.mark.parametrize("src,dst", [("jax", "port"), ("port", "jax")])
def test_gang_segment_across_the_packages(weights, src, dst):
    """test_gang's engine leg across the packages: ``src`` prefills a
    page-aligned segment and exports it; ``dst`` adopts it through
    gang_prefill_segment, computes only the rest of the prompt and samples
    the stream of one JAX engine prefilling the whole prompt."""
    prompt = [int(t) for t in np.random.default_rng(11).integers(0, 256, 37)]
    seg0 = prompt[:16]
    base = serve(engine(weights, "jax"), 1, prompt, 6)
    A, B = engine(weights, src), engine(weights, dst)
    assert A.gang_prefill_segment(1, seg0, max_new_tokens=1) == 0
    while not A.query(1).get("done", False):
        A.step()
    A.flush(1)
    bundle = A.export_prefix(seg0)
    assert bundle.n_full == 2
    assert B.gang_prefill_segment(1, prompt, prefix_bundle=wire(bundle, dst),
                                  max_new_tokens=6) == 2
    seq = B.state.seqs[1]
    assert seq.prefix_hit_tokens >= 16
    assert [pool_page(B, b) for b in seq.blocks[:2]] == bundle.pages
    prefill0 = B.stats["prefill_tokens"]
    while not B.query(1).get("done", False):
        B.step()
    assert B.stats["prefill_tokens"] - prefill0 == len(prompt) - 16
    assert B.flush(1) == base, "gang-merged stream diverged"
    B.state.audit()
    # a skewed hop is refused before anything is admitted
    bad = A.export_prefix(seg0)
    bad.weight_version = {"id": 2, "digest": "x"}
    with pytest.raises(PACKAGES[dst].MigrationError, match="version_skew"):
        B.gang_prefill_segment(2, prompt, prefix_bundle=wire(bad, dst))
    assert 2 not in B.state.seqs


def test_heartbeat_surface_matches_the_jax_engine(weights):
    J, T = engine(weights, "jax"), engine(weights, "port")
    for eng in (J, T):
        serve(eng, 1, PROMPT, 6)
        eng.put(2, PROMPT[:12], max_new_tokens=4)
    assert sorted(T.residency_digest()) == sorted(J.residency_digest())
    assert T.prefix_cache_version() == J.prefix_cache_version()
    assert T.prefix_cache_stats() == J.prefix_cache_stats()
    keys = ("live", "queued", "pending_tokens", "migrating",
            "pending_prefill", "pending_decode", "free_blocks", "max_seqs")
    ls_t, ls_j = T.load_summary(), J.load_summary()
    assert {k: ls_t[k] for k in keys} == {k: ls_j[k] for k in keys}
    assert T.weight_version() == J.weight_version() == {"id": 0,
                                                        "digest": "init"}
    assert T.drain() and J.drain()


def test_import_admits_the_speculative_mirror(weights):
    """``import_complete`` on a ``spec_decode="draft"`` engine admits the
    draft mirror with the imported history (the JAX engine's contract);
    the imported sequence then decodes through verify rounds to the JAX
    baseline's stream (fp32, the draft is the model itself)."""
    jm, host, tm, tree = weights
    base = serve(engine(weights, "jax"), 1, PROMPT, 10)
    A = engine(weights, "jax")
    A.put(1, PROMPT, max_new_tokens=10)
    while A.state.seqs[1].n_generated < 1:
        A.step()
    bundle = wire(A.export_migration(1), "port")
    B = InferenceEngineV2(tm, params=tree, draft_model=tm, config=dict(
        CFG, dtype=torch.float32, device="cpu", spec_decode="draft"))
    B.import_reserve(9, bundle.meta())
    assert 9 not in B._spec._mirrors
    B.import_complete(9, bundle)
    assert 9 in B._spec._mirrors
    while not B.query(9)["done"]:
        B.step()
    assert B.stats["spec_rounds"] > 0
    assert B.flush(9) == base
    B.state.audit()
