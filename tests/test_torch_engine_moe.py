"""MoE serving end to end: the port's ``InferenceEngineV2`` (CPU, fp32)
against the JAX package's engine serving the same flax-initialised
tiny-mixtral and tiny-qwen2-moe weights (hidden 256, 4 heads of 64: the
paged-attention kernel's geometry).

Each model in each of the engine's MoE routes:
- ``capacity``: the default route, no-drop capacity gating (einsums);
- ``dropless``: ``moe.dropless=True``, grouped products (K5's route; the
  JAX engine runs its Pallas kernel in interpret mode);
- ``int8`` / ``int4``: ``quant_bits``, routed experts as ``QuantGrouped``
  codes through the quantized grouped product (K3's route) in tiles of 32
  rows; the JAX engine runs its Pallas kernels in interpret mode.

Greedy streams must be identical, every MoE product must go through its
kernel's route (launch counts), and the quantized engines must hold
bit-identical expert codes with the router and shared expert left exact."""
import dataclasses

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
from deepspeed_tpu_torch.models import build_model, get_model_config
from deepspeed_tpu_torch.ops import grouped_matmul as gm
from deepspeed_tpu_torch.ops import quant_matmul as qm

OVERRIDES = {"hidden_size": 256}
BASE = dict(block_size=8, num_blocks=96, max_seqs=4, chunk=16,
            max_seq_len=128)
NEW_TOKENS = 6
ROUTES = {"capacity": ({}, {}), "dropless": ({}, {"dropless": True}),
          "int8": ({"quant_bits": 8}, {}), "int4": ({"quant_bits": 4}, {})}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _prompts():
    rng = np.random.default_rng(0)
    return [[int(t) for t in rng.integers(0, 256, n)] for n in (40, 13, 27)]


def _models(name, moe_over):
    """(JAX model, host params, port model, exported tree) with the MoE
    options ``moe_over``."""
    jm0 = jax_build_model(name)
    jm = jax_build_model(name, dtype=jnp.float32, **OVERRIDES,
                         moe=dataclasses.replace(jm0.config.moe, **moe_over))
    params = jm.init(jax.random.PRNGKey(0),
                     jnp.zeros((1, 8), jnp.int32))["params"]
    host = jax.device_get(flax.core.meta.unbox(params))
    tm = build_model(name, device="cpu", dtype=torch.float32, **OVERRIDES,
                     moe=dataclasses.replace(get_model_config(name).moe,
                                             **moe_over))
    tree = params_from_jax(host, tm.config, dtype=torch.float32,
                           device="cpu")
    return jm, host, tm, tree


def _forwards(eng):
    st = eng.stats
    return st["prefill_steps"] + st["decode_steps"] + st["window_iters_max"]


@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("name", ["tiny-mixtral", "tiny-qwen2-moe"])
def test_moe_streams_match_the_jax_engine(name, route):
    over, moe_over = ROUTES[route]
    jm, host, tm, tree = _models(name, moe_over)
    je = JaxEngine(jm, params=jax.tree.map(jnp.asarray, host),
                   config=dict(BASE, dtype=jnp.float32,
                               use_pallas_decode=False, **over),
                   topology=MeshTopology({"tensor": 1, "data": 1}))
    ref = je.generate(_prompts(), max_new_tokens=NEW_TOKENS)
    eng = InferenceEngineV2(tm, params=tree, config=dict(
        BASE, dtype=torch.float32, device="cpu", **over))
    k2, k3, k5 = qm.counts.plain, qm.grouped_counts.plain, gm.counts.plain
    got = eng.generate(_prompts(), max_new_tokens=NEW_TOKENS)
    eng.state.audit()
    assert got == ref, (name, route)

    L = tm.config.num_layers
    moe_products = 3 * L * _forwards(eng)         # w_gate, w_up, w_down
    quant = "quant_bits" in over
    assert gm.counts.plain - k5 == (moe_products if route == "dropless"
                                    else 0)
    assert qm.grouped_counts.plain - k3 == (moe_products if quant else 0)
    # K2: q, k, v, o of every layer and the unembedding
    assert qm.counts.plain - k2 == ((4 * L + 1) * _forwards(eng) if quant
                                    else 0)
    if not quant:
        return
    # the same expert codes as the JAX engine's (its layers are stacked)
    jl = je.params.get("layers_stacked")
    for i in range(L):
        j_ex = (jl["moe"]["moe_layer"]["experts"] if jl is not None
                else je.params[f"layer_{i}"]["moe"]["moe_layer"]["experts"])
        ex = eng.params[f"layer_{i}"]["moe"]["moe_layer"]["experts"]
        for k in ("w_gate", "w_up", "w_down"):
            assert isinstance(ex[k], qm.QuantGrouped)
            jd, js = j_ex[k].data, j_ex[k].scale
            if jl is not None:
                jd, js = jd[i], js[i]
            np.testing.assert_array_equal(ex[k].data.numpy(), np.asarray(jd))
            np.testing.assert_array_equal(ex[k].scale.numpy(),
                                          np.asarray(js))
    # the router and the shared expert stay in the compute dtype
    moe = eng.params["layer_0"]["moe"]
    assert moe["moe_layer"]["gate"]["wg"].dtype == torch.float32
    if tm.config.moe.shared_expert_intermediate:
        assert moe["shared_expert"]["w_up"].dtype == torch.float32
        assert moe["shared_gate"].dtype == torch.float32


def test_mixed_stack_quantizes_dense_and_moe_layers():
    """A mixed stack (layer 0 dense, layer 1 MoE) under quant_bits: the
    dense FFN's products go through K2's route, the experts' through
    K3's, and the stream is the JAX engine's."""
    cfg = get_model_config("tiny-mixtral")
    # dense layers keep the experts' width: the JAX engine quantizes a
    # dense w_down with K = ffn_size, so a dense_ffn_intermediate of its
    # own does not serve there under quant_bits
    moe_over = dict(moe_layer_pattern=(False, True))
    jm, host, tm, tree = _models("tiny-mixtral", moe_over)
    je = JaxEngine(jm, params=jax.tree.map(jnp.asarray, host),
                   config=dict(BASE, dtype=jnp.float32,
                               use_pallas_decode=False, quant_bits=8),
                   topology=MeshTopology({"tensor": 1, "data": 1}))
    ref = je.generate(_prompts()[:2], max_new_tokens=NEW_TOKENS)
    eng = InferenceEngineV2(tm, params=tree, config=dict(
        BASE, dtype=torch.float32, device="cpu", quant_bits=8))
    assert isinstance(eng.params["layer_0"]["ffn"]["w_up"], qm.QuantLinear)
    assert "moe" not in eng.params["layer_0"]
    k2, k3 = qm.counts.plain, qm.grouped_counts.plain
    got = eng.generate(_prompts()[:2], max_new_tokens=NEW_TOKENS)
    assert got == ref
    f = _forwards(eng)
    assert qm.counts.plain - k2 == (4 * 2 + 3 + 1) * f
    assert qm.grouped_counts.plain - k3 == 3 * f
    assert cfg.moe.moe_layer_pattern is None      # the preset is untouched
