"""Sliding-window serving through the port: the port's ``InferenceEngineV2``
(CPU, fp32) on a windowed tiny llama serves from a rolling KV ring, against
the JAX package's ring engine on the same flax-initialised weights.

- Greedy streams are identical to the JAX engine's (its gather route, fp32)
  and to a greedy loop over the port's dense ``TransformerLM.forward``,
  which masks the window, across several wraps of the ring, with decode
  windows of 8 and 1 and on the kernel's route and the gather route.
- The ring is the JAX engine's: same ``_ring_tokens``, packing and the
  prefix cache off, no sequence ever owns more than ``nwin`` pages, and
  every attention call carries the window and the ring.
- An e4m3 pool: a prefill chunk's logits past a wrap agree with the JAX
  engine's e4m3 ring (its Pallas kernel in interpret mode) to fp32 order
  (2e-5), and stay within the JAX package's fp8 bound (max 0.5, mean 0.05;
  tests/test_inference_v2.py) of the fp32 pool's.

Models take head_dim 64 (hidden 256, 4 heads), the kernel's geometry."""
import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference import InferenceEngineV2 as JaxEngine
from deepspeed_tpu.models import build_model as jax_build_model
from deepspeed_tpu.parallel.topology import MeshTopology
from deepspeed_tpu_torch.inference import InferenceEngineV2, params_from_jax
from deepspeed_tpu_torch.inference import engine_v2 as ev2
from deepspeed_tpu_torch.inference.weights import flatten_tree
from deepspeed_tpu_torch.models import build_model
from deepspeed_tpu_torch.ops import paged_attention as pa

WINDOW = 16
OVERRIDES = dict(hidden_size=256, sliding_window=WINDOW, max_seq_len=256)
BASE = dict(block_size=8, num_blocks=96, max_seqs=4, chunk=16,
            max_seq_len=256)
NEW_TOKENS = 30
#: ceil((window + chunk) / block_size) + 1 pages: the JAX engine's sizing
NWIN = -(-(WINDOW + 16) // 8) + 1


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _prompts():
    """Prompts up to 70 tokens plus 30 new: up to 2.5 wraps of the 40-token
    ring, one prompt shorter than the window."""
    rng = np.random.default_rng(0)
    return [[int(t) for t in rng.integers(0, 256, n)] for n in (45, 9, 70,
                                                              23)]


@pytest.fixture(scope="module")
def served():
    """(JAX model, host params, port model, exported tree, JAX ring engine's
    streams)."""
    jm = jax_build_model("tiny-llama", dtype=jnp.float32, **OVERRIDES)
    params = jm.init(jax.random.PRNGKey(0),
                     jnp.zeros((1, 8), jnp.int32))["params"]
    host = jax.device_get(flax.core.meta.unbox(params))
    je = JaxEngine(jm, params=jax.tree.map(jnp.asarray, host),
                   config=dict(BASE, dtype=jnp.float32,
                               use_pallas_decode=False),
                   topology=MeshTopology({"tensor": 1, "data": 1}))
    assert je._ring_tokens == NWIN * 8
    ref = je.generate(_prompts(), max_new_tokens=NEW_TOKENS)
    tm = build_model("tiny-llama", device="cpu", dtype=torch.float32,
                     **OVERRIDES)
    tree = params_from_jax(host, tm.config, dtype=torch.float32,
                           device="cpu")
    tm.load_state_dict(flatten_tree(tree), strict=True)   # the dense oracle
    return jm, host, tm, tree, ref


def _serve_watching_the_ring(eng, prompts):
    """generate(), checking after every step that no live sequence owns more
    than the ring's pages; returns (streams, highest position served)."""
    out, top = {}, 0
    for uid, p in enumerate(prompts):
        eng.put(uid, p, max_new_tokens=NEW_TOKENS)
    while eng.state.seqs:
        eng.step()
        for uid, seq in list(eng.state.seqs.items()):
            assert len(seq.blocks) <= eng.state.max_blocks_per_seq == NWIN
            top = max(top, len(seq.tokens))
            if seq.done:
                out[uid] = eng.flush(uid)
                eng.state.audit()
    return [out[u] for u in range(len(prompts))], top


@pytest.mark.parametrize("decode_window,attention", [
    (8, "plain"), (1, "plain"), (8, "gather")])
def test_ring_streams_match_the_jax_engine(served, decode_window,
                                           attention, monkeypatch):
    _, _, tm, tree, ref = served
    eng = InferenceEngineV2(tm, params=tree, config=dict(
        BASE, dtype=torch.float32, device="cpu",
        decode_window=decode_window,
        use_pallas_decode=False if attention == "gather" else None))
    assert eng._ring_tokens == NWIN * 8
    assert not eng.scheduler.pack and eng._prefix_cache is None
    assert eng._attn_decode_sel.path == attention
    calls = []
    real = pa.paged_ragged_attention_reference

    def spy(*a, **kw):
        calls.append((kw.get("window"), kw.get("ring_tokens")))
        return real(*a, **kw)

    # the kernel's route calls the plain version through the module, the
    # gather route through the engine's import
    monkeypatch.setattr(pa, "paged_ragged_attention_reference", spy)
    monkeypatch.setattr(ev2, "paged_ragged_attention_reference", spy)
    got, top = _serve_watching_the_ring(eng, _prompts())
    assert got == ref
    assert top > 2 * eng._ring_tokens          # wrapped more than twice
    assert calls and set(calls) == {(WINDOW, NWIN * 8)}
    assert (eng.stats["windows"] > 0) == (decode_window > 1)


def test_ring_streams_match_the_dense_windowed_model(served):
    """The same streams from a greedy loop over the full-context forward,
    whose attention masks the window (ops/attention.py)."""
    _, _, tm, tree, ref = served
    with torch.no_grad():
        for prompt, want in zip(_prompts()[:2], ref[:2]):
            seq = list(prompt)
            for _ in range(NEW_TOKENS):
                logits = tm(torch.tensor([seq]))[0, -1]
                seq.append(int(logits.argmax()))
            assert seq[len(prompt):] == want


def _ring_chunk_logits(served, jax_over, over):
    """Logits of the 6th prefill chunk of a 90-token prompt, which attends
    the ring after it wrapped, from the JAX engine and the port's."""
    jm, host, tm, tree, _ = served
    prompt = [int(t) for t in np.random.default_rng(9).integers(0, 256, 90)]
    je = JaxEngine(jm, params=jax.tree.map(jnp.asarray, host),
                   config=dict(BASE, dtype=jnp.float32, **jax_over),
                   topology=MeshTopology({"tensor": 1, "data": 1}))
    eng = InferenceEngineV2(tm, params=tree, config=dict(
        BASE, dtype=torch.float32, device="cpu", **over))
    je.put(1, list(prompt), max_new_tokens=4)
    eng.put(1, list(prompt), max_new_tokens=4)
    for _ in range(5):
        je._dispatch_next()
        je._drain(drain_all=True)
        eng.step()
    jp, tp = je.scheduler.next_step(), eng.scheduler.next_step()
    assert jp.kind == tp.kind == "prefill"
    assert (jp.slot_map == tp.slot_map).all()
    assert int(jp.positions[0, 0]) == 80 > eng._ring_tokens
    args = [jp.token_ids, jp.positions, jp.slot_map, jp.block_tables,
            jp.seq_lens, jp.sample_idx]
    _, lj = jax.jit(je._ragged_forward)(je.params, je.kv_pool,
                                        *map(jnp.asarray, args))
    dt = [torch.long, torch.long, torch.long, torch.int32, torch.int32,
          torch.long]
    lt = eng._ragged_forward(*(torch.from_numpy(np.asarray(a)).to(d)
                               for a, d in zip(args, dt)))
    return np.asarray(lj, np.float32)[0], lt[0].numpy(), eng


#: the port's e4m3 ring against the JAX engine's: both round q and p to e4m3
#: at the same points of the same page walk, so they differ by fp32
#: summation order (as tests/test_torch_engine_quant.py's FP8_POOL_TOL)
FP8_RING_TOL = 2e-5


def test_e4m3_ring_logits_match_the_jax_engine(served):
    a, b, eng = _ring_chunk_logits(served, {"kv_cache_dtype": "fp8"},
                                   {"kv_cache_dtype": "fp8"})
    assert eng.kv_pool.dtype == torch.float8_e4m3fn and eng._ring_tokens
    assert np.abs(a - b).max() <= FP8_RING_TOL
    # the JAX package's fp8 bound against the fp32-pool ring
    _, c, _ = _ring_chunk_logits(served, {}, {})
    d = np.abs(b - c)
    assert d.max() < 0.5 and d.mean() < 0.05
    assert d.max() > 100 * FP8_RING_TOL        # the e4m3 pool is in play


def test_e4m3_ring_serves_through_the_wrap(served):
    _, _, tm, tree, _ = served
    eng = InferenceEngineV2(tm, params=tree, config=dict(
        BASE, dtype=torch.float32, device="cpu", kv_cache_dtype="fp8"))
    got, top = _serve_watching_the_ring(eng, _prompts())
    assert top > 2 * eng._ring_tokens
    assert [len(g) for g in got] == [NEW_TOKENS] * 4
    assert torch.isfinite(eng.kv_pool.float()).all()


def test_ring_refuses_the_prefix_cache_and_spec(served):
    _, _, tm, tree, _ = served
    with pytest.raises(ValueError, match="prefix_cache"):
        InferenceEngineV2(tm, params=tree, config=dict(
            BASE, device="cpu", prefix_cache=True))
    with pytest.raises(ValueError, match="spec_decode"):
        InferenceEngineV2(tm, params=tree, config=dict(
            BASE, device="cpu", spec_decode="ngram"))
    # a window wider than max_seq_len serves linear: no ring, the window
    # still masks, and spec is allowed there
    eng = InferenceEngineV2(tm, params=tree, config=dict(
        BASE, device="cpu", max_seq_len=16, spec_decode="ngram"))
    assert eng._ring_tokens == 0 and eng._spec is not None
