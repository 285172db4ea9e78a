"""The port's dense model (``deepspeed_tpu_torch.models``) against the JAX
package's flax ``TransformerLM``: the same seeded parameters (flax init,
unboxed, through ``params_from_jax``) and the same token ids give the same
fp32 logits."""
import dataclasses

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models import build_model as jax_build_model
from deepspeed_tpu_torch.inference.weights import (flatten_tree,
                                                   module_param_tree,
                                                   params_from_jax)
from deepspeed_tpu_torch.models import (PRESETS, TransformerLM,
                                        build_model, get_model_config)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    # the suite runs under several xdist workers: one intra-op thread each
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


CASES = {
    "tiny-llama": {},
    "tiny-gpt2": {},
    "tiny-falcon": {},
    "tiny-phi": {},
    # head_dim 64: the geometry the paged-attention kernel takes
    "tiny-llama/hd64": {"hidden_size": 256},
}


def _flax_params(name, overrides, seed=0):
    jm = jax_build_model(name.split("/")[0], dtype=jnp.float32, **overrides)
    params = jm.init(jax.random.PRNGKey(seed),
                     jnp.zeros((1, 8), jnp.int32))["params"]
    return jm, params


@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_matches_flax_apply(case):
    name, over = case.split("/")[0], CASES[case]
    jm, params = _flax_params(name, over)
    rng = np.random.default_rng(1)
    ids = rng.integers(0, 256, (2, 24)).astype(np.int32)
    ref = np.asarray(jm.apply({"params": params}, jnp.asarray(ids)),
                     np.float32)

    tm = build_model(name, device="cpu", dtype=torch.float32, **over)
    tree = params_from_jax(jax.device_get(flax.core.meta.unbox(params)),
                           tm.config, dtype=torch.float32, device="cpu")
    tm.load_state_dict(flatten_tree(tree), strict=True)
    with torch.no_grad():
        got = tm(torch.from_numpy(ids).long()).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_param_tree_names_and_layouts_are_the_flax_trees():
    _, params = _flax_params("tiny-llama", {})
    flax_tree = jax.device_get(flax.core.meta.unbox(params))
    tm = build_model("tiny-llama", device="cpu", dtype=torch.float32)
    ours = module_param_tree(tm)

    def shapes(t):
        return {k: shapes(v) if isinstance(v, dict) else tuple(v.shape)
                for k, v in t.items()}

    assert shapes(ours) == shapes(flax_tree)
    # wq keeps [E, H, D] and wo [H, D, E]
    assert tuple(ours["layer_0"]["attn"]["wq"].shape) == (64, 4, 16)
    assert tuple(ours["layer_0"]["attn"]["wo"].shape) == (4, 16, 64)


def test_presets_match_the_jax_packages():
    from deepspeed_tpu.models import PRESETS as JAX_PRESETS

    assert sorted(PRESETS) == sorted(JAX_PRESETS)
    for name, jcfg in JAX_PRESETS.items():
        ours = dataclasses.asdict(PRESETS[name])
        theirs = dataclasses.asdict(jcfg)
        for key in ("dtype",):
            ours.pop(key), theirs.pop(key)
        assert ours == theirs, name


def test_seeded_init_is_reproducible_and_on_the_asked_device():
    a = build_model("tiny-llama", device="cpu", seed=3)
    b = build_model("tiny-llama", device="cpu", seed=3)
    c = build_model("tiny-llama", device="cpu", seed=4)
    pa, pb, pc = (dict(m.named_parameters()) for m in (a, b, c))
    assert all(torch.equal(pa[k], pb[k]) for k in pa)
    assert not torch.equal(pa["layer_0.attn.wq"], pc["layer_0.attn.wq"])
    assert pa["embed"].device.type == "cpu"
    assert pa["embed"].dtype == get_model_config("tiny-llama").dtype


def test_model_families_outside_the_slice_raise():
    # MoE models build (the MoE slice), under the flax tree's names
    names = {n for n, _ in build_model("tiny-mixtral",
                                       device="cpu").named_parameters()}
    assert {"layer_0.moe.moe_layer.gate.wg",
            "layer_0.moe.moe_layer.experts.w_gate",
            "layer_0.moe.moe_layer.experts.w_up",
            "layer_0.moe.moe_layer.experts.w_down"} <= names
    assert not any(".ffn." in n for n in names)
    with pytest.raises(NotImplementedError, match="bert"):
        TransformerLM(get_model_config("tiny-bert"), device="cpu")


def test_gelu_variants_stay_apart():
    from deepspeed_tpu_torch.models.transformer import _ACTS

    x = torch.linspace(-3, 3, 13)
    tanh = np.asarray(jax.nn.gelu(jnp.asarray(x.numpy())))
    exact = np.asarray(jax.nn.gelu(jnp.asarray(x.numpy()), approximate=False))
    np.testing.assert_allclose(_ACTS["gelu"](x).numpy(), tanh, atol=1e-6)
    np.testing.assert_allclose(_ACTS["gelu_exact"](x).numpy(), exact,
                               atol=1e-6)
    assert not np.allclose(tanh, exact)
