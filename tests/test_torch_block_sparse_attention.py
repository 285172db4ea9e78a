"""K6, the block-sparse flash kernel's plain versions (``deepspeed_tpu_torch.
ops.block_sparse_attention``), against the JAX package's Pallas
``block_sparse_flash_attention`` in interpret mode (the way
``tests/test_sparse_attention.py`` runs it on the CPU): the tables and the
gate entry for entry, the forward on a random layout with an empty query
row (causal and not), a row visible only above the diagonal, BigBird at
S 1024 / block 128 and a block of 192; q/k/v gradients through the autograd
function against ``jax.grad`` of the Pallas route. Inputs are made from a
seed with numpy and handed to both."""
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu.ops.pallas.block_sparse_attention as jbs
import deepspeed_tpu.ops.sparse_attention as jsa
from deepspeed_tpu_torch.ops import block_sparse_attention as bsa


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    # the suite runs under several xdist workers: one intra-op thread each
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _qkv(B, S, H, D, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, S, H, D)).astype(np.float32)
            for _ in range(4)]


def _random_layout(H, n, seed):
    """A random layout with an empty query row (0) and a row whose only
    visible block (above the diagonal) is wholly masked under causal."""
    layout = np.random.default_rng(seed).random((H, n, n)) < 0.5
    layout[:, 0] = False
    layout[:, 1] = False
    layout[:, 1, n - 1] = True
    layout[:, 2, 2] = True
    return layout


@pytest.mark.parametrize("seed", [0, 1])
def test_layout_tables_are_identical(seed):
    layout = _random_layout(3, 6, seed)
    for got, want in zip(bsa.layout_tables(layout),
                         jbs.layout_tables(layout)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    bigbird = jsa.BigBirdSparsityConfig(num_heads=4, block=128,
                                        different_layout_per_head=True)
    lay = bigbird.make_layout(2048)
    for got, want in zip(bsa.layout_tables(lay), jbs.layout_tables(lay)):
        np.testing.assert_array_equal(got, want)


def test_gate_matches_the_jax_gate():
    assert jbs.pltpu is not None              # the JAX gate's import probe
    layout = np.ones((2, 2, 2), bool)
    grid = itertools.product((16, 64, 120, 128, 132, 136, 192, 256),
                             (256, 384, 512, 1000, 3072),
                             (32, 64, 80, 128, 256), (2, 4), (1, 2, 4))
    n = 0
    for block, S, D, H, KV in grid:
        want = jbs.block_sparse_usable(layout, block, S, D, H, KV)
        assert bsa.block_sparse_usable(layout, block, S, D, H, KV) == want, \
            (block, S, D, H, KV)
        n += want
    assert n > 0


def _jax_route(q, k, v, layout, block, causal):
    return jbs.block_sparse_flash_attention(
        *(jnp.asarray(a) for a in (q, k, v)), layout, block, causal=causal)


@pytest.mark.parametrize("causal", [False, True])
def test_plain_forward_matches_the_pallas_kernel(causal):
    B, S, H, D, block = 2, 512, 2, 64, 128
    q, k, v, _ = _qkv(B, S, H, D, seed=0)
    layout = _random_layout(H, S // block, seed=0)
    if causal:
        layout &= np.tril(np.ones((4, 4), bool))[None] | (
            np.arange(4)[:, None] == 1)       # keep row 1 above the diagonal
    want = np.asarray(_jax_route(q, k, v, layout, block, causal))
    got = bsa.block_sparse_flash_attention(
        *(torch.tensor(a) for a in (q, k, v)), layout, block, causal=causal)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)
    assert not got[:, :block].any()               # the empty query row
    if causal:
        assert not got[:, block:2 * block].any()  # only above the diagonal


def test_plain_lse_matches_the_pallas_kernel():
    """lse (and NEG_INF on rows that see no key) of the forward."""
    B, S, H, D, block = 1, 384, 2, 64, 128
    q, k, v, _ = _qkv(B, S, H, D, seed=2)
    layout = _random_layout(H, S // block, seed=2)
    tq, cq, _, _ = jbs.layout_tables(layout)
    t = lambda a: jnp.swapaxes(jnp.asarray(a), 1, 2)
    _, want = jbs._fwd(t(q), t(k), t(v), jnp.asarray(tq), jnp.asarray(cq),
                       scale=D ** -0.5, causal=True, block=block,
                       interpret=True)
    tables = bsa.device_tables(layout, "cpu")
    _, got = bsa.block_sparse_fwd_plain(
        *(torch.tensor(a).transpose(1, 2) for a in (q, k, v)), tables, block,
        True, D ** -0.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want)[..., 0],
                               atol=2e-5)
    assert (got[:, :, :block] == bsa.NEG_INF).all()


@pytest.mark.parametrize("S,block,H,D,seed", [(1024, 128, 2, 64, 3),
                                              (768, 192, 2, 128, 4)])
def test_plain_forward_bigbird_layout(S, block, H, D, seed):
    cfg = jsa.BigBirdSparsityConfig(num_heads=H, block=block,
                                    different_layout_per_head=True, seed=seed)
    layout = cfg.make_layout(S)
    q, k, v, _ = _qkv(1, S, H, D, seed)
    want = np.asarray(_jax_route(q, k, v, layout, block, False))
    got = bsa.block_sparse_flash_attention(
        *(torch.tensor(a) for a in (q, k, v)), layout, block)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)


@pytest.mark.parametrize("causal,layout_kind", [(True, "tril"),
                                                (True, "random"),
                                                (False, "random")])
def test_grads_match_jax_grad_of_the_pallas_route(causal, layout_kind):
    B, S, H, D, block = 1, 384, 2, 64, 128
    n = S // block
    q, k, v, w = _qkv(B, S, H, D, seed=5)
    if layout_kind == "tril":
        layout = np.tril(np.ones((n, n), bool))[None].repeat(H, 0)
        layout[0, 2, 0] = False              # ragged visibility across heads
    else:
        layout = _random_layout(H, n, seed=5)

    def loss(q_, k_, v_):
        return jnp.sum(jbs.block_sparse_flash_attention(
            q_, k_, v_, layout, block, causal=causal) * jnp.asarray(w))

    want = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(a)
                                               for a in (q, k, v)))
    ts = [torch.tensor(a).requires_grad_() for a in (q, k, v)]
    (bsa.block_sparse_flash_attention(*ts, layout, block, causal=causal)
     * torch.tensor(w)).sum().backward()
    for name, t, g in zip("qkv", ts, want):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), atol=2e-3,
                                   err_msg=f"d{name}")
        assert np.isfinite(t.grad.numpy()).all()
    if layout_kind == "random":
        assert not ts[0].grad[:, :block].any()   # the empty row: no grad


def test_cpu_route_counts_only_the_plain_versions():
    B, S, H, D, block = 1, 256, 2, 64, 128
    q, k, v, _ = _qkv(B, S, H, D, seed=6)
    layout = np.ones((H, 2, 2), bool)
    ts = [torch.tensor(a).requires_grad_() for a in (q, k, v)]
    bsa.counts.reset()
    bsa.block_sparse_flash_attention(*ts, layout, block).sum().backward()
    assert vars(bsa.counts) == {"fwd": 0, "bwd": 0, "plain": 1,
                                "plain_bwd": 1}


def test_device_tables_are_cached_and_ordered_busiest_first():
    layout = _random_layout(3, 5, seed=7)
    a = bsa.device_tables(layout, "cpu")
    assert bsa.device_tables(layout.copy(), "cpu") is a
    cnt = a.cnt_q.reshape(-1)[a.order_q.long()]
    assert (cnt[:-1] >= cnt[1:]).all()
    cnt = a.cnt_k.reshape(-1)[a.order_k.long()]
    assert (cnt[:-1] >= cnt[1:]).all()
    other = layout.copy()
    other[0, 0, 0] = True
    assert bsa.device_tables(other, "cpu") is not a


def test_mismatched_layout_or_blocks_raise():
    q = torch.zeros(1, 256, 2, 64)
    with pytest.raises(ValueError, match="do not match"):
        bsa.block_sparse_flash_attention(q, q, q, np.ones((2, 4, 4), bool),
                                         128)
    with pytest.raises(ValueError, match="not divisible"):
        bsa.block_sparse_flash_attention(q, q, q, np.ones((2, 2, 2), bool),
                                         96)
    with pytest.raises(ValueError, match=r"\[H, n, n\]"):
        bsa.device_tables(np.ones((2, 4, 2), bool), "cpu")
