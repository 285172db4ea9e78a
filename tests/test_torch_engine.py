"""The slice end to end: the port's ``InferenceEngineV2`` (on the CPU, fp32)
against the JAX package's engine (``use_pallas_decode=False``, fp32), both
serving the same flax-initialised weights (exported through
``params_from_jax``). Greedy streams must be identical, with the prefix
cache on and off and decode windows of 8 and 1, and the pool audit clean
after every flush.

The models take head_dim 64 (hidden 256, 4 heads), the geometry the
paged-attention kernel serves, so the port's path runs the kernel's plain
version; one configuration pins the gather formulation instead. Prompts
span several prefill chunks and pages, and a second batch shares prefixes
with the first, so the prefix cache serves hits."""
import dataclasses
from types import SimpleNamespace

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
from deepspeed_tpu_torch.models.transformer import MoEConfig
from deepspeed_tpu_torch.ops import paged_attention as pa
from deepspeed_tpu_torch.ops import quant_matmul as qm

MODELS = ["tiny-llama", "tiny-gpt2"]
OVERRIDES = {"hidden_size": 256}           # 4 heads of 64
BASE = dict(block_size=8, num_blocks=96, max_seqs=4, chunk=16,
            max_seq_len=128)
NEW_TOKENS = 10


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _batches():
    rng = np.random.default_rng(0)
    A = [int(t) for t in rng.integers(0, 256, 40)]
    first = [A] + [[int(t) for t in rng.integers(0, 256, n)]
                   for n in (5, 21, 37)]
    # served after the first batch published its pages: page-aligned and
    # partial shared prefixes of A, and A itself
    second = [A[:32] + [7, 9, 11], A[:17], list(A)]
    return [first, second]


@pytest.fixture(scope="module", params=MODELS)
def served(request):
    """(model name, port model, exported params, JAX engine's streams)."""
    name = request.param
    jm = jax_build_model(name, dtype=jnp.float32, **OVERRIDES)
    params = jm.init(jax.random.PRNGKey(0),
                     jnp.zeros((1, 8), jnp.int32))["params"]
    # host copy first: the JAX engine donates the buffers it stacks
    host = jax.device_get(flax.core.meta.unbox(params))
    je = JaxEngine(jm, params=params,
                   config=dict(BASE, dtype=jnp.float32,
                               use_pallas_decode=False),
                   topology=MeshTopology({"tensor": 1, "data": 1}))
    ref = [je.generate(b, max_new_tokens=NEW_TOKENS) for b in _batches()]
    assert je.stats["prefix_hit_tokens"] > 0
    tm = build_model(name, device="cpu", dtype=torch.float32, **OVERRIDES)
    tree = params_from_jax(host, tm.config, dtype=torch.float32,
                           device="cpu")
    return name, tm, tree, ref


@pytest.mark.parametrize("prefix_cache,decode_window,attention", [
    (None, 8, "plain"), (None, 1, "plain"), (False, 8, "plain"),
    (False, 1, "plain"), (None, 8, "gather")])
def test_greedy_streams_match_the_jax_engine(served, prefix_cache,
                                             decode_window, attention):
    name, tm, tree, ref = served
    eng = InferenceEngineV2(tm, params=tree, config=dict(
        BASE, dtype=torch.float32, device="cpu", prefix_cache=prefix_cache,
        decode_window=decode_window,
        use_pallas_decode=False if attention == "gather" else None))
    assert eng._attn_decode_sel.path == attention
    plain0 = pa.counts.plain
    got = []
    for batch in _batches():
        got.append(eng.generate(batch, max_new_tokens=NEW_TOKENS))
        eng.state.audit()
    assert got == ref, name
    st = eng.stats
    assert st["prefix_hit_tokens"] > 0 if prefix_cache is None \
        else st["prefix_hit_tokens"] == 0
    assert (st["windows"] > 0) == (decode_window > 1)
    assert st[f"attn_{attention}_decode"] > 0
    # the kernel's route runs once per layer per forward, nowhere else
    forwards = st["prefill_steps"] + st["decode_steps"] + \
        st["window_iters_max"]
    expect = tm.config.num_layers * forwards if attention == "plain" else 0
    assert pa.counts.plain - plain0 == expect


def test_put_step_query_flush_and_eos(served):
    name, tm, tree, ref = served
    # decode_early_exit: the window stops once the eos ended every slot
    eng = InferenceEngineV2(tm, params=tree, config=dict(
        BASE, dtype=torch.float32, device="cpu", decode_early_exit=True))
    prompt = _batches()[0][2]
    want = ref[0][2]
    plain0 = pa.counts.plain
    eng.put(5, prompt, max_new_tokens=NEW_TOKENS, eos_token_id=want[3])
    assert eng.query(5)["live"] and not eng.query(5)["done"]
    seen = []
    while not eng.query(5)["done"]:
        seen.extend(eng.step().get(5, []))
    # the stream stops at (and includes) the first eos
    assert seen == want[:want.index(want[3]) + 1]
    assert eng.flush(5) == seen
    assert not eng.query(5)["live"]
    # the window broke off after the eos: fewer forwards than scheduled
    st = eng.stats
    scheduled = st["prefill_steps"] + st["decode_steps"] + \
        st["window_iters_max"]
    assert pa.counts.plain - plain0 < tm.config.num_layers * scheduled
    eng.state.audit()
    assert eng.step() == {}                  # idle


def test_later_slices_and_the_default_device_raise(served):
    _, tm, tree, _ = served
    for over, exc, match in [
            # tensor parallelism serves (the TP slice) over as many
            # processes as ranks: one process cannot hold a mesh of two
            ({"quant_bits": 8, "tensor_parallel": 2}, ValueError,
             "mesh product 2 > device count 1"),
            ({"tensor_parallel": 2}, ValueError,
             "mesh product 2 > device count 1"),
            # KV tiering serves (the KV-movement slice); like the JAX
            # engine, it refuses to run without the prefix cache
            ({"kv_tier": True, "prefix_cache": False}, ValueError,
             "kv_tier requires the shared-prefix cache"),
            # reqtrace rides telemetry, as in the JAX engine
            ({"reqtrace": True, "telemetry": False}, ValueError,
             "reqtrace=True cannot combine with telemetry=False")]:
        with pytest.raises(exc, match=match):
            InferenceEngineV2(tm, params=tree,
                              config=dict(BASE, device="cpu", **over))
    # telemetry and request tracing serve (the telemetry slice); the
    # process-wide instance is put back as it was
    from deepspeed_tpu_torch import telemetry

    t = telemetry.get_telemetry()
    prev = (t.enabled, t.reqtrace.enabled)
    try:
        for over in ({"telemetry": True}, {"reqtrace": True}):
            eng = InferenceEngineV2(tm, params=tree,
                                    config=dict(BASE, device="cpu", **over))
            assert eng._telem.enabled
            assert eng._rt.enabled == ("reqtrace" in over)
    finally:
        t.reconfigure(enabled=prev[0])
        t.reqtrace.enabled = prev[1]
    # speculative decoding serves (the window/spec slice), with either
    # proposer
    for over in ({"spec_decode": "ngram"}, {"spec_decode": "draft"}):
        eng = InferenceEngineV2(tm, params=tree, draft_model=tm,
                                config=dict(BASE, device="cpu", **over))
        assert eng._spec is not None
        assert eng._attn_tree_sel.path == "plain"
    # sliding-window models serve from a rolling ring; a stand-in carries
    # the config, and spec on a ring raises
    windowed = SimpleNamespace(config=dataclasses.replace(
        tm.config, sliding_window=16))
    eng = InferenceEngineV2(windowed, params=tree,
                            config=dict(BASE, device="cpu"))
    assert eng._ring_tokens == 5 * BASE["block_size"]
    with pytest.raises(ValueError, match="spec_decode"):
        InferenceEngineV2(windowed, params=tree, config=dict(
            BASE, device="cpu", spec_decode="ngram"))
    # MoE models serve (the MoE slice), with and without quantized weights
    moe = build_model("tiny-mixtral", device="cpu", dtype=torch.float32,
                      moe=MoEConfig(num_experts=4, top_k=2))
    for over in ({}, {"quant_bits": 8}):
        eng = InferenceEngineV2(moe, config=dict(BASE, device="cpu",
                                                 dtype=torch.float32, **over))
        experts = eng.params["layer_0"]["moe"]["moe_layer"]["experts"]
        assert isinstance(experts["w_up"], qm.QuantGrouped) == bool(over)
    with pytest.raises(ValueError, match="quant_bits"):
        InferenceEngineV2(tm, params=tree,
                          config=dict(BASE, device="cpu", quant_bits=3))
    if not torch.cuda.is_available():
        # the default device is the card; without one the engine refuses
        with pytest.raises(RuntimeError, match="CUDA"):
            InferenceEngineV2(tm, params=tree, config=dict(BASE))
