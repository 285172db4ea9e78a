"""Speculative decoding through the port: the port's ``InferenceEngineV2``
(CPU, fp32) with ``spec_decode`` "ngram" (depths 2 and 4) and "draft" (a
same-weights draft and a differently seeded one) against the port's spec-off
engine and the JAX package's spec-off engine, all on the same
flax-initialised weights. Greedy streams must be identical: every emitted
token is a target sample, whatever the proposer. (The JAX package's spec
engine is slow-marked in its own tests, so its spec-off baseline stands in.)

Also: every verify goes through the registry's tree selection (the kernel's
route, or the gather route when ``spec_verify_pallas=False`` pins it), a
mid-stream flush leaves the pool audit-clean, and the configuration gates
raise. Models take head_dim 64 (hidden 256, 4 heads), the kernel's
geometry; tiny-llama is GQA (4 query heads over 2 KV heads)."""
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
from deepspeed_tpu_torch.models import build_model
from deepspeed_tpu_torch.ops import paged_attention as pa

OVERRIDES = {"hidden_size": 256, "num_heads": 4}
SIZES = dict(block_size=8, num_blocks=96, max_seqs=4, chunk=16,
             max_seq_len=192)
BASE = dict(SIZES, dtype=torch.float32, device="cpu")
NEW_TOKENS = 16


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _prompts():
    """A motif repeated (prompt-lookup hits) and two random prompts
    (rejections), as tests/test_speculative.py serves."""
    r = np.random.default_rng(0)
    motif = [int(t) for t in r.integers(0, 256, 8)]
    return [(motif * 6)[:40], [int(t) for t in r.integers(0, 256, 12)],
            [int(t) for t in r.integers(0, 256, 23)]]


_SERVED: dict = {}


def _served(name):
    """(port model, exported tree, JAX spec-off streams), per model."""
    if name not in _SERVED:
        jm = jax_build_model(name, dtype=jnp.float32, **OVERRIDES)
        params = jm.init(jax.random.PRNGKey(0),
                         jnp.zeros((1, 8), jnp.int32))["params"]
        host = jax.device_get(flax.core.meta.unbox(params))
        je = JaxEngine(jm, params=params, config=dict(
            SIZES, dtype=jnp.float32, use_pallas_decode=False),
            topology=MeshTopology({"tensor": 1, "data": 1}))
        ref = je.generate(_prompts(), max_new_tokens=NEW_TOKENS)
        tm = build_model(name, device="cpu", dtype=torch.float32,
                         **OVERRIDES)
        tree = params_from_jax(host, tm.config, dtype=torch.float32,
                               device="cpu")
        _SERVED[name] = (tm, tree, ref)
    return _SERVED[name]


def _draft(kind, tm, tree):
    if kind == "strong":                 # the draft IS the target
        return dict(draft_model=tm, draft_params=tree)
    return dict(draft_model=build_model("tiny-gpt2", device="cpu",
                                        dtype=torch.float32, seed=123,
                                        **OVERRIDES))


@pytest.mark.parametrize("name,spec,depth,draft", [
    ("tiny-gpt2", "ngram", 2, None), ("tiny-gpt2", "ngram", 4, None),
    ("tiny-llama", "ngram", 4, None), ("tiny-gpt2", "draft", 3, "strong"),
    ("tiny-gpt2", "draft", 3, "weak")])
def test_spec_streams_match_spec_off(name, spec, depth, draft):
    tm, tree, ref = _served(name)
    base = InferenceEngineV2(tm, params=tree, config=dict(BASE))
    assert base.generate(_prompts(), max_new_tokens=NEW_TOKENS) == ref
    eng = InferenceEngineV2(
        tm, params=tree, config=dict(BASE, spec_decode=spec,
                                     spec_depth=depth),
        **(_draft(draft, tm, tree) if draft else {}))
    plain0 = pa.counts.plain
    got = eng.generate(_prompts(), max_new_tokens=NEW_TOKENS)
    eng.state.audit()
    assert got == ref
    st = eng.stats
    assert st["spec_rounds"] > 0 and st["spec_proposed"] > 0
    assert 0.0 <= st["spec_accept_rate"] <= 1.0
    # every verify went through the kernel's route, once per layer
    assert st["attn_plain_tree"] == st["spec_rounds"]
    forwards = st["prefill_steps"] + st["decode_steps"] + \
        st["window_iters_max"]
    draft_forwards = 0
    if eng._draft_engine is not None:
        ds = eng._draft_engine.stats
        draft_forwards = ds["prefill_steps"] + ds["decode_steps"]
        # the mirrors were released with their targets
        assert eng._draft_engine.state.allocator.free_blocks == \
            BASE["num_blocks"] - 1
    L = tm.config.num_layers
    assert pa.counts.plain - plain0 == L * (forwards + draft_forwards)
    if spec == "ngram" or draft == "strong":
        # the motif (or a perfect draft) commits > 1 token per verify
        assert st["spec_steps_saved"] > 0
        assert (st["spec_accepted"] + st["spec_verifies"]) \
            / st["spec_verifies"] > 1.0
    if draft == "strong":
        assert st["spec_accept_rate"] > 0.9
    if draft == "weak":
        assert st["spec_accept_rate"] < 0.5


def test_gather_pin_serves_the_verify_outside_the_kernel():
    tm, tree, ref = _served("tiny-gpt2")
    eng = InferenceEngineV2(tm, params=tree, config=dict(
        BASE, spec_decode="ngram", spec_verify_pallas=False))
    assert eng._attn_tree_sel.path == "gather"
    assert eng._attn_decode_sel.path == "plain"
    assert eng.generate(_prompts(), max_new_tokens=NEW_TOKENS) == ref
    assert eng.stats["attn_gather_tree"] == eng.stats["spec_rounds"] > 0


def test_mid_stream_flush_rolls_back_clean():
    tm, tree, _ = _served("tiny-gpt2")
    eng = InferenceEngineV2(tm, params=tree, config=dict(
        BASE, spec_decode="ngram", spec_depth=4))
    eng.put(1, _prompts()[0], max_new_tokens=24)
    eng.put(2, [int(t) for t in np.random.default_rng(7).integers(0, 256,
                                                                   15)],
            max_new_tokens=24)
    for _ in range(64):
        eng.step()
        if eng.stats["spec_rounds"] >= 2 and \
                not eng.query(1).get("done", True):
            break
    assert eng.stats["spec_rounds"] >= 1 and eng.query(1)["live"]
    eng.flush(1)                               # mid-stream
    eng.state.audit()
    eng.flush(2)
    eng.state.audit()
    assert not eng.state.seqs
    # everything is free or published to the prefix trie: committed pages
    # only (rejected candidates never reach the pool)
    assert eng.state.allocator.free_blocks \
        + eng.state.prefix_cache.cached_blocks == BASE["num_blocks"] - 1


def test_spec_config_gates():
    tm, tree, _ = _served("tiny-gpt2")
    for bad in ({"spec_decode": "medusa"}, {"spec_decode": "draft"},
                {"spec_decode": "ngram", "spec_depth": 0},
                {"spec_decode": "ngram", "spec_max_nodes": 1}):
        with pytest.raises(ValueError):
            InferenceEngineV2(tm, params=tree, config=dict(BASE, **bad))
    win = build_model("tiny-gpt2", device="cpu", dtype=torch.float32,
                      sliding_window=8, max_seq_len=256, **OVERRIDES)
    with pytest.raises(ValueError, match="ring"):
        InferenceEngineV2(win, config=dict(BASE, max_seq_len=256,
                                           spec_decode="ngram"))
    # the verify pin demands a kernel that ALiBi's gather route cannot give
    bloom = build_model("tiny-bloom", device="cpu", dtype=torch.float32,
                        **OVERRIDES)
    with pytest.raises(ValueError, match="spec_verify_pallas"):
        InferenceEngineV2(bloom, config=dict(BASE, spec_decode="ngram",
                                             spec_verify_pallas=True))
    # tensor parallelism stays refused; telemetry and request tracing
    # serve beside speculative decoding (the process-wide instance is put
    # back as it was)
    with pytest.raises(NotImplementedError, match="tensor"):
        InferenceEngineV2(tm, params=tree, config=dict(
            BASE, spec_decode="ngram", tensor_parallel=2))
    from deepspeed_tpu_torch import telemetry

    t = telemetry.get_telemetry()
    prev = (t.enabled, t.reqtrace.enabled)
    try:
        eng = InferenceEngineV2(tm, params=tree, config=dict(
            BASE, spec_decode="ngram", telemetry=True, reqtrace=True))
        assert eng._spec.reqtrace is eng._rt and eng._rt.enabled
    finally:
        t.reconfigure(enabled=prev[0])
        t.reqtrace.enabled = prev[1]
