"""Block-sparse attention's configs, layouts, dispatcher and module
(``deepspeed_tpu_torch.ops.sparse_attention``) against the JAX package's
``deepspeed_tpu.ops.sparse_attention``: layouts bit-identical for all five
configs (random draws, per-head layouts, unidirectional), the same
ValueErrors, the same token mask, the masked dense route (blocks under 128:
the gate refuses them in both packages) with causal masking and a custom
scale, and ``SparseSelfAttention``'s outputs, gradients and sparsity.
Inputs are made from a seed with numpy and handed to both."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu.ops.sparse_attention as jsa
from deepspeed_tpu_torch.ops import block_sparse_attention as bsa
from deepspeed_tpu_torch.ops import sparse_attention as tsa


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    # the suite runs under several xdist workers: one intra-op thread each
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


#: (config name, kwargs) pairs: every config, its options and seeds
CONFIGS = [
    ("dense", {}),
    ("fixed", {}),
    ("fixed", {"num_local_blocks": 2, "num_global_blocks": 1,
               "attention": "unidirectional"}),
    ("fixed", {"num_local_blocks": 3, "num_global_blocks": 2,
               "horizontal_global_attention": True}),
    ("fixed", {"num_local_blocks": 4, "attention": "unidirectional",
               "horizontal_global_attention": True}),
    ("bigbird", {}),
    ("bigbird", {"different_layout_per_head": True, "seed": 3}),
    ("bigbird", {"num_random_blocks": 2, "num_sliding_window_blocks": 5,
                 "num_global_blocks": 2, "attention": "unidirectional",
                 "different_layout_per_head": True, "seed": 7}),
    ("bslongformer", {}),
    ("bslongformer", {"global_block_indices": [0, 5],
                      "global_block_end_indices": [2, 7],
                      "attention": "unidirectional"}),
    ("variable", {}),
    ("variable", {"num_random_blocks": 1, "local_window_blocks": [1, 3],
                  "global_block_indices": [0, 4],
                  "different_layout_per_head": True, "seed": 5}),
    ("variable", {"local_window_blocks": [2], "global_block_indices": [1],
                  "global_block_end_indices": [3],
                  "attention": "unidirectional"}),
]


@pytest.mark.parametrize("name,kw", CONFIGS,
                         ids=[f"{n}-{i}" for i, (n, _) in enumerate(CONFIGS)])
@pytest.mark.parametrize("S,block,heads", [(128, 16, 4), (256, 32, 3),
                                           (1024, 128, 2)])
def test_layouts_are_bit_identical(name, kw, S, block, heads):
    j = jsa.SPARSITY_CONFIGS[name](num_heads=heads, block=block, **kw)
    t = tsa.SPARSITY_CONFIGS[name](num_heads=heads, block=block, **kw)
    lj, lt = j.make_layout(S), t.make_layout(S)
    assert lt.dtype == lj.dtype and lt.shape == lj.shape == (
        heads, S // block, S // block)
    np.testing.assert_array_equal(lt, lj)


def test_config_table_names_the_same_classes():
    assert list(tsa.SPARSITY_CONFIGS) == list(jsa.SPARSITY_CONFIGS)
    for name, cls in tsa.SPARSITY_CONFIGS.items():
        assert cls.__name__ == jsa.SPARSITY_CONFIGS[name].__name__
        assert cls.SUPPORTS_PER_HEAD == jsa.SPARSITY_CONFIGS[name] \
            .SUPPORTS_PER_HEAD


@pytest.mark.parametrize("name,kw,S", [
    ("dense", {}, 100),                                  # not whole blocks
    ("fixed", {"different_layout_per_head": True}, 64),  # deterministic
    ("bslongformer", {"different_layout_per_head": True}, 64),
    ("dense", {"different_layout_per_head": True}, 64),
])
def test_same_value_errors(name, kw, S):
    with pytest.raises(ValueError) as jerr:
        jsa.SPARSITY_CONFIGS[name](num_heads=2, block=16, **kw).make_layout(S)
    with pytest.raises(ValueError) as terr:
        tsa.SPARSITY_CONFIGS[name](num_heads=2, block=16, **kw).make_layout(S)
    assert str(terr.value) == str(jerr.value)


def test_base_config_make_layout_is_abstract():
    with pytest.raises(NotImplementedError):
        tsa.SparsityConfig(num_heads=1).make_layout(16)


@pytest.mark.parametrize("seed", [0, 1])
def test_layout_to_mask_matches(seed):
    layout = np.random.default_rng(seed).random((3, 4, 4)) < 0.5
    want = np.asarray(jsa.layout_to_mask(layout, 8))
    got = tsa.layout_to_mask(layout, 8)
    assert got.dtype == torch.bool and got.shape == (3, 32, 32)
    np.testing.assert_array_equal(got.numpy(), want)


def _qkv(B, S, H, D, KV=None, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda h: rng.standard_normal((B, S, h, D)).astype(np.float32)
    return f(H), f(KV or H), f(KV or H)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("scale", [None, 0.3])
@pytest.mark.parametrize("KV", [4, 2])
def test_masked_route_matches(causal, scale, KV):
    """Blocks of 16 (and GQA): both gates refuse the kernel, so both take
    the masked dense route; a layout with an empty query row and a row
    visible only above the diagonal gives zeros there."""
    B, S, H, D, block = 2, 64, 4, 16, 16
    q, k, v = _qkv(B, S, H, D, KV)
    layout = np.random.default_rng(3).random((H, 4, 4)) < 0.5
    layout[:, 0] = False                       # an empty query row
    layout[:, 1] = False
    layout[:, 1, 3] = True                     # only above the diagonal
    layout[:, 2, 2] = True
    assert not bsa.block_sparse_usable(layout, block, S, D, H, KV)
    want = np.asarray(jsa.block_sparse_attention(
        *(jnp.asarray(a) for a in (q, k, v)), layout, block, scale=scale,
        causal=causal))
    got = tsa.block_sparse_attention(*(torch.tensor(a) for a in (q, k, v)),
                                     layout, block, scale=scale,
                                     causal=causal)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-6)
    assert not got[:, :block].any()            # the empty row
    if causal:
        assert not got[:, block:2 * block].any()


def test_masked_route_grads_match():
    B, S, H, D, block = 1, 64, 2, 16, 16
    q, k, v = _qkv(B, S, H, D, seed=4)
    cfg = dict(num_heads=H, block=block, different_layout_per_head=True,
               seed=2, attention="unidirectional")
    layout = jsa.BigBirdSparsityConfig(**cfg).make_layout(S)
    w = np.random.default_rng(5).standard_normal((B, S, H, D)) \
        .astype(np.float32)

    def loss(q_, k_, v_):
        return jnp.sum(jsa.block_sparse_attention(q_, k_, v_, layout, block,
                                                  causal=True) * w)

    want = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(a)
                                               for a in (q, k, v)))
    ts = [torch.tensor(a).requires_grad_() for a in (q, k, v)]
    (tsa.block_sparse_attention(*ts, layout, block, causal=True)
     * torch.tensor(w)).sum().backward()
    for t, g in zip(ts, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), atol=1e-5)


@pytest.mark.parametrize("name,kw,S,block,H,D", [
    ("bigbird", {"different_layout_per_head": True}, 128, 16, 4, 16),
    ("fixed", {"attention": "unidirectional", "num_local_blocks": 2}, 128,
     16, 2, 32),
    ("bslongformer", {}, 512, 128, 2, 64),     # the kernel route in both
    ("variable", {"attention": "unidirectional", "local_window_blocks": [2]},
     512, 128, 2, 64),
])
def test_sparse_self_attention_matches(name, kw, S, block, H, D):
    jcfg = jsa.SPARSITY_CONFIGS[name](num_heads=H, block=block, **kw)
    tcfg = tsa.SPARSITY_CONFIGS[name](num_heads=H, block=block, **kw)
    jm, tm = jsa.SparseSelfAttention(jcfg), tsa.SparseSelfAttention(tcfg)
    q, k, v = _qkv(2, S, H, D, seed=6)
    want = np.asarray(jm(*(jnp.asarray(a) for a in (q, k, v))))
    bsa.counts.reset()
    got = tm(*(torch.tensor(a) for a in (q, k, v)))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)
    assert tm.sparsity(S) == jm.sparsity(S)
    assert 0.0 < tm.sparsity(S) < 1.0
    assert S in tm._layouts and tm.get_layout(S) is tm.get_layout(S)
    # the kernel route (plain on the CPU) where the gate claims it
    assert bsa.counts.plain == int(block >= bsa.MIN_BLOCK)


def test_sparse_self_attention_custom_scale_and_grads():
    H, S, D, block = 2, 256, 64, 128
    cfg = dict(num_heads=H, block=block, different_layout_per_head=True,
               seed=1)
    jm = jsa.SparseSelfAttention(jsa.BigBirdSparsityConfig(**cfg), scale=0.2)
    tm = tsa.SparseSelfAttention(tsa.BigBirdSparsityConfig(**cfg), scale=0.2)
    q, k, v = _qkv(1, S, H, D, seed=7)
    want = jax.grad(lambda *a: jnp.sum(jm(*a) ** 2), argnums=(0, 1, 2))(
        *(jnp.asarray(a) for a in (q, k, v)))
    ts = [torch.tensor(a).requires_grad_() for a in (q, k, v)]
    tm(*ts).square().sum().backward()
    for t, g in zip(ts, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), atol=2e-3)
