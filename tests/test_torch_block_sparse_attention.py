"""K6, the block-sparse flash kernel's plain versions (``deepspeed_tpu_torch.
ops.block_sparse_attention``), against the JAX package's Pallas
``block_sparse_flash_attention`` in interpret mode (the way
``tests/test_sparse_attention.py`` runs it on the CPU): the tables and the
gate entry for entry, the forward on a random layout with an empty query
row (causal and not), a row visible only above the diagonal, BigBird at
S 1024 / block 128 and a block of 192; q/k/v gradients through the autograd
function against ``jax.grad`` of the Pallas route. Inputs are made from a
seed with numpy and handed to both. Then the card's routing, which runs
nowhere here: the route for every (dtype, block, head dim) the gate admits,
and the wgmma kernels' tile walk (``tile_walk``, the CUDA ``TableWalk`` in
Python) against the dense token mask of ``layout_to_mask``."""
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
    assert vars(bsa.counts) == {"fwd": 0, "bwd": 0, "fwd_tc": 0,
                                "bwd_tc": 0, "plain": 1, "plain_bwd": 1}


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


def test_kernel_route_for_every_shape_the_gate_admits():
    """bf16 at blocks that are a multiple of 128 takes the wgmma kernels,
    fp32 and every other bf16 block the FMA kernels, at every head dim."""
    layout = np.ones((2, 4, 4), bool)
    n = 0
    for block in range(8, 1032, 8):
        for D in (32, 64, 80, 128, 256):
            if not bsa.block_sparse_usable(layout, block, 4 * block, D, 2, 2):
                continue
            n += 1
            assert bsa.kernel_route(torch.float32, block) == "fma"
            want = "wgmma" if block % 128 == 0 else "fma"
            assert bsa.kernel_route(torch.bfloat16, block) == want, (block, D)
    assert n == 3 * len(range(128, 1032, 8))


def _walk_layout(kind: str, H: int, n: int, block: int):
    from deepspeed_tpu_torch.ops import sparse_attention as sa

    S = n * block
    if kind == "fixed":
        return sa.FixedSparsityConfig(num_heads=H, block=block).make_layout(S)
    if kind == "fixed-causal":
        return sa.FixedSparsityConfig(num_heads=H, block=block,
                                      attention="unidirectional"
                                      ).make_layout(S)
    if kind == "bigbird":
        return sa.BigBirdSparsityConfig(
            num_heads=H, block=block, different_layout_per_head=True,
            seed=3).make_layout(S)
    layout = _random_layout(H, n, seed=9)
    layout[1, 3] = True                    # a full row beside sparse ones
    return layout


@pytest.mark.parametrize("D", [64, 256])
@pytest.mark.parametrize("block", [128, 256])
@pytest.mark.parametrize("kind,causal", [("fixed", False),
                                         ("fixed-causal", True),
                                         ("bigbird", False),
                                         ("bigbird", True),
                                         ("holes", False),
                                         ("holes", True)])
def test_tile_walk_covers_the_token_mask(kind, causal, block, D):
    """Each block of the wgmma forward, dq and dk/dv kernels owns its own
    rows once, takes the table rows busiest first, and its tiles cover every
    visible token pair of ``layout_to_mask`` (causal: at or below the
    diagonal) exactly once, never a pair outside the layout's blocks, and
    under causal no tile wholly above the diagonal."""
    from deepspeed_tpu_torch.ops.sparse_attention import layout_to_mask

    H, n = 2, 8
    S = n * block
    layout = _walk_layout(kind, H, n, block)
    tables = bsa.device_tables(layout, "cpu")
    blocks = layout_to_mask(layout, block).numpy()            # [H, S, S]
    mask = blocks & np.tril(np.ones((S, S), bool)) if causal else blocks
    for which in ("fwd", "dq", "dkv"):
        own, other = bsa.tc_tile_rows(D)[which]
        walk = bsa.tile_walk(tables, block, causal, D, which)
        assert sorted((h, r) for h, r, _ in walk) == [
            (h, r) for h in range(H) for r in range(0, S, own)], which
        # busiest first: the visible blocks of each block's table row
        seen_blocks = blocks[:, ::block, ::block]
        busy = [int((seen_blocks[h, r // block] if which != "dkv"
                     else seen_blocks[h, :, r // block]).sum())
                for h, r, _ in walk]
        assert busy == sorted(busy, reverse=True), which
        seen = np.zeros((H, S, S), np.int8)
        for h, r, starts in walk:
            assert starts == sorted(starts)
            for t in starts:
                rows, cols = ((slice(r, r + own), slice(t, t + other))
                              if which != "dkv" else
                              (slice(t, t + other), slice(r, r + own)))
                seen[h, rows, cols] += 1
                if causal:
                    assert mask[h, rows, cols].any(), (which, h, r, t)
        assert seen.max() <= 1, which
        assert (seen[mask] == 1).all(), which
        assert not seen[~blocks].any(), which
