"""The port's MoE (``deepspeed_tpu_torch.moe`` and the MoE model family)
against the JAX package's ``deepspeed_tpu/moe`` and flax ``TransformerLM``.

Same seeded inputs (numpy) on both sides, fp32:
- ``topkgating`` / ``topk_dropless_gating``: expert choices and capacity
  masks identical, including exact ties (``jax.lax.top_k`` puts the lower
  index first), gates and losses within 1e-6;
- ``sort_tokens_by_expert``: ``dst``, ``tile_expert`` and ``Tp`` identical,
  with an expert that gets no token and with every token on one expert;
  ``tile_rows`` counts each tile's routed rows;
- the ``MoE`` layer in the capacity route (dropping and not dropping) and
  the dropless route against ``MoE.apply``, within 1e-5 of max |JAX|
  (dispatch and combine sum the same terms in other orders);
- tiny-mixtral, tiny-qwen2-moe and a mixed ``moe_layer_pattern`` stack:
  ``TransformerLM.forward`` logits against the flax model's, 1e-5."""
import dataclasses

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models import build_model as jax_build_model
from deepspeed_tpu.moe import layer as jlayer
from deepspeed_tpu.moe import sharded_moe as jsm
from deepspeed_tpu.ops.pallas import grouped_matmul as jg
from deepspeed_tpu_torch.inference.weights import (flatten_tree,
                                                   module_param_tree,
                                                   params_from_jax)
from deepspeed_tpu_torch.models import build_model, get_model_config
from deepspeed_tpu_torch.moe import MoE, sharded_moe as tsm
from deepspeed_tpu_torch.ops import grouped_matmul as tg


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _logits(G, S, n, seed, ties=False):
    """Router logits; with ``ties`` expert 3 copies expert 1 and both lead,
    so every token's top choices tie exactly."""
    x = np.random.default_rng(seed).standard_normal((G, S, n)) * 2
    if ties:
        x[..., 1] = x.max(axis=-1) + 1.0
        x[..., 3] = x[..., 1]
    return x.astype(np.float32)


def _np(t):
    return np.asarray(t)


#: (G, S, n, k, capacity factor, min capacity, drop tokens, normalize)
GATING = [(2, 16, 4, 2, 1.0, 4, True, True),      # capacity binds
          (2, 16, 4, 2, 1.0, 4, False, True),     # no drop
          (1, 24, 8, 1, 0.5, 2, True, False),     # top-1, raw gates
          (3, 10, 6, 4, 2.0, 4, True, False),     # qwen2-moe-style top-4
          (1, 12, 5, 3, 1.25, 4, True, True)]


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("case", GATING)
def test_topkgating_matches_jax(case, ties):
    G, S, n, k, cf, mc, drop, norm = case
    x = _logits(G, S, n, seed=len(GATING) + S, ties=ties)
    ref = jsm.topkgating(jnp.asarray(x), k, cf, mc, drop_tokens=drop,
                         normalize_gates=norm)
    got = tsm.topkgating(torch.from_numpy(x), k, cf, mc, drop_tokens=drop,
                         normalize_gates=norm)
    np.testing.assert_array_equal(got.dispatch.numpy(), _np(ref.dispatch))
    np.testing.assert_allclose(got.combine.numpy(), _np(ref.combine),
                               atol=1e-6)
    np.testing.assert_array_equal(got.exp_counts.numpy(),
                                  _np(ref.exp_counts))
    np.testing.assert_allclose(got.aux_loss.item(), float(ref.aux_loss),
                               rtol=1e-6)
    np.testing.assert_allclose(got.z_loss.item(), float(ref.z_loss),
                               rtol=1e-6)
    if drop and case[4] <= 1.0:
        # the capacity bound really drops some (token, choice) pairs
        assert got.dispatch.sum() < G * S * k


def test_top1_and_top2_gating_match_jax():
    x = _logits(2, 12, 4, seed=7)
    for jf, tf in ((jsm.top1gating, tsm.top1gating),
                   (jsm.top2gating, tsm.top2gating)):
        ref, got = jf(jnp.asarray(x), 1.0, 4), tf(torch.from_numpy(x), 1.0, 4)
        np.testing.assert_array_equal(got.dispatch.numpy(),
                                      _np(ref.dispatch))
        np.testing.assert_allclose(got.combine.numpy(), _np(ref.combine),
                                   atol=1e-6)


@pytest.mark.parametrize("norm", [True, False])
@pytest.mark.parametrize("ties", [False, True])
def test_dropless_gating_matches_jax(ties, norm):
    x = _logits(1, 20, 6, seed=3, ties=ties)
    ref = jsm.topk_dropless_gating(jnp.asarray(x), 3, normalize_gates=norm)
    got = tsm.topk_dropless_gating(torch.from_numpy(x), 3,
                                   normalize_gates=norm)
    np.testing.assert_array_equal(got.experts.numpy(), _np(ref.experts))
    assert got.experts.dtype == torch.int32
    np.testing.assert_allclose(got.gates.numpy(), _np(ref.gates), atol=1e-6)
    np.testing.assert_array_equal(got.exp_counts.numpy(),
                                  _np(ref.exp_counts))
    if ties:
        # the tied pair comes lower index first, as jax.lax.top_k has it
        assert (got.experts[..., 0] == 1).all()
        assert (got.experts[..., 1] == 3).all()


def _routing(kind, T, k, n, seed):
    rng = np.random.default_rng(seed)
    if kind == "one-expert":
        return np.full((T, k), 2, np.int32)
    if kind == "empty-experts":         # experts 1 and 3 get nothing
        return rng.choice([0, 2, 4], (T, k)).astype(np.int32)
    return rng.integers(0, n, (T, k)).astype(np.int32)


@pytest.mark.parametrize("bm", [8, 32, 128])
@pytest.mark.parametrize("kind,T,k,n", [("spread", 37, 2, 4),
                                        ("spread", 8, 4, 60),
                                        ("empty-experts", 25, 2, 5),
                                        ("one-expert", 30, 1, 4)])
def test_sort_tokens_by_expert_matches_jax(kind, T, k, n, bm):
    eidx = _routing(kind, T, k, n, seed=T + bm)
    ref = jg.sort_tokens_by_expert(jnp.asarray(eidx), n, bm)
    got = tg.sort_tokens_by_expert(torch.from_numpy(eidx), n, bm)
    assert got.Tp == ref.Tp
    np.testing.assert_array_equal(got.dst.numpy(), _np(ref.dst))
    np.testing.assert_array_equal(got.tile_expert.numpy(),
                                  _np(ref.tile_expert))
    assert got.dst.dtype == got.tile_expert.dtype == torch.int32
    # tile_rows: the destinations that land in each tile, a prefix of it
    dst = got.dst.numpy()
    want = np.bincount(dst // bm, minlength=got.Tp // bm)
    np.testing.assert_array_equal(got.tile_rows.numpy(), want)
    for t, r in enumerate(want):
        in_tile = np.sort(dst[(dst >= t * bm) & (dst < (t + 1) * bm)])
        np.testing.assert_array_equal(in_tile, t * bm + np.arange(r))


def _moe_pair(kw, E=32, seed=0):
    """(flax MoE, its params, the port's MoE with the same weights)."""
    jmod = jlayer.MoE(hidden_size=E, **kw)
    x0 = jnp.zeros((1, 4, E), jnp.float32)
    params = jmod.init(jax.random.PRNGKey(seed), x0)["params"]
    host = jax.device_get(flax.core.meta.unbox(params))
    tmod = MoE(hidden_size=E, device="cpu", **kw)
    tmod.load_state_dict(flatten_tree(params_from_jax(host, device="cpu")),
                         strict=True)
    return jmod, params, tmod


MOE_CASES = {
    "capacity-drop": dict(num_experts=4, ffn_size=48, k=2,
                          eval_capacity_factor=0.5, min_capacity=2),
    "capacity-nodrop": dict(num_experts=4, ffn_size=48, k=2,
                            drop_tokens=False),
    "capacity-top4-raw-gates": dict(num_experts=6, ffn_size=40, k=4,
                                    eval_capacity_factor=2.0,
                                    normalize_gates=False),
    "capacity-gelu": dict(num_experts=4, ffn_size=48, k=2,
                          activation="gelu", drop_tokens=False),
    "dropless-bm8": dict(num_experts=4, ffn_size=48, k=2, dropless=True,
                         dropless_block_m=8),
    "dropless-bm32-top4": dict(num_experts=6, ffn_size=40, k=4,
                               dropless=True, dropless_block_m=32,
                               normalize_gates=False),
}


@pytest.mark.parametrize("name", sorted(MOE_CASES))
def test_moe_layer_matches_flax_apply(name):
    kw = MOE_CASES[name]
    jmod, params, tmod = _moe_pair(kw)
    x = np.random.default_rng(5).standard_normal((3, 12, 32)).astype(
        np.float32)
    ref, _ = jmod.apply({"params": params}, jnp.asarray(x), True,
                        mutable=["losses"])
    ref = np.asarray(ref)
    with torch.no_grad():
        got = tmod(torch.from_numpy(x))[0].numpy()
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()
    if name == "capacity-drop":
        # some tokens were dropped (zero FFN output) and the port agrees
        dropped = np.all(ref == 0.0, axis=-1)
        assert dropped.any() and np.all(got[dropped] == 0.0)


@pytest.mark.parametrize("activation", ["silu_glu", "gelu"])
@pytest.mark.parametrize("dropless", [False, True])
def test_experts_match_flax_apply(dropless, activation):
    """``Experts`` alone: capacity mode over [n, g, c, E], and dropless
    mode over an expert-sorted buffer (the JAX side runs its Pallas
    grouped GEMM in interpret mode), within 1e-5 of max |JAX|."""
    from deepspeed_tpu_torch.moe import Experts

    n, E, F, bm = 4, 32, 48, 8
    jmod = jlayer.Experts(hidden_size=E, ffn_size=F, num_experts=n,
                          activation=activation)
    rng = np.random.default_rng(6)
    if dropless:
        idx = rng.integers(0, n, (10, 2)).astype(np.int32)
        jsort = jg.sort_tokens_by_expert(jnp.asarray(idx), n, bm)
        tsort = tg.sort_tokens_by_expert(torch.from_numpy(idx), n, bm)
        x = np.zeros((jsort.Tp, E), np.float32)
        x[np.asarray(jsort.dst)] = rng.standard_normal((20, E))
        jargs, targs = (jsort, bm), (tsort, bm)
    else:
        x = rng.standard_normal((n, 2, 5, E)).astype(np.float32)
        jargs = targs = ()
    params = jmod.init(jax.random.PRNGKey(1), jnp.asarray(x),
                       *jargs)["params"]
    ref = np.asarray(jmod.apply({"params": params}, jnp.asarray(x), *jargs))
    tmod = Experts(E, F, n, activation, _factory())
    tmod.load_state_dict(flatten_tree(params_from_jax(
        jax.device_get(flax.core.meta.unbox(params)), device="cpu")),
        strict=True)
    with torch.no_grad():
        got = tmod(torch.from_numpy(x), *targs).numpy()
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


def _factory():
    from deepspeed_tpu_torch.models.transformer import _ParamFactory

    return _ParamFactory(torch.device("cpu"), torch.float32, 0)


def _mixed(cfg):
    return dict(moe=dataclasses.replace(cfg.moe,
                                        moe_layer_pattern=(False, True),
                                        dense_ffn_intermediate=96))


MODELS = {
    "tiny-mixtral": {},
    "tiny-qwen2-moe": {},
    "tiny-mixtral/dropless": {"dropless": True, "dropless_block_m": 16},
    "tiny-qwen2-moe/mixed-pattern": "mixed",
}


@pytest.mark.parametrize("case", sorted(MODELS))
def test_model_forward_matches_flax_apply(case):
    name = case.split("/")[0]
    over = MODELS[case]
    jcfg = jax_build_model(name).config
    if over == "mixed":
        j_over = t_over = _mixed(jcfg)
        t_over = _mixed(get_model_config(name))
    else:
        j_over = dict(moe=dataclasses.replace(jcfg.moe, **over))
        t_over = dict(moe=dataclasses.replace(get_model_config(name).moe,
                                              **over))
    jm = jax_build_model(name, dtype=jnp.float32, **j_over)
    params = jm.init(jax.random.PRNGKey(2),
                     jnp.zeros((1, 8), jnp.int32))["params"]
    ids = np.random.default_rng(4).integers(0, 256, (2, 20)).astype(np.int32)
    ref = np.asarray(jm.apply({"params": params}, jnp.asarray(ids)),
                     np.float32)
    tm = build_model(name, device="cpu", dtype=torch.float32, **t_over)
    tree = params_from_jax(jax.device_get(flax.core.meta.unbox(params)),
                           tm.config, dtype=torch.float32, device="cpu")
    tm.load_state_dict(flatten_tree(tree), strict=True)
    with torch.no_grad():
        got = tm(torch.from_numpy(ids).long()).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", ["tiny-mixtral", "tiny-qwen2-moe"])
def test_moe_param_tree_is_the_flax_tree(name):
    jm = jax_build_model(name, dtype=jnp.float32)
    params = jm.init(jax.random.PRNGKey(0),
                     jnp.zeros((1, 8), jnp.int32))["params"]
    flax_tree = jax.device_get(flax.core.meta.unbox(params))
    ours = module_param_tree(build_model(name, device="cpu"))

    def shapes(t):
        return {k: shapes(v) if isinstance(v, dict) else tuple(v.shape)
                for k, v in t.items()}

    assert shapes(ours) == shapes(flax_tree)
    moe = ours["layer_0"]["moe"]
    n = get_model_config(name).moe.num_experts
    assert tuple(moe["moe_layer"]["gate"]["wg"].shape) == (64, n)
    assert moe["moe_layer"]["experts"]["w_down"].shape[0] == n
