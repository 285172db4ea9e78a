"""K7, the per-layer-slice paged attention (``paged_prefill_attention`` /
``paged_decode_attention`` of ``deepspeed_tpu_torch.ops.paged_attention``),
against the JAX package's Pallas entries of the same names in interpret
mode: GQA, an empty slot, prefill chunks of T > 1, the sliding window (with
rows that see no key on the pages the kernel runs), a wrapped rolling ring,
decode, and the same ValueErrors. Inputs are made from a seed with numpy and
handed to both."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu.ops.pallas.paged_attention as jpa
from deepspeed_tpu_torch.ops import paged_attention as pa


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    # the suite runs under several xdist workers: one intra-op thread each
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _case(*, S, T, H, KV, D, bs, nb, max_pages, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((S, T, H, D)).astype(np.float32) * 3
    kp = rng.standard_normal((KV, nb * bs, D)).astype(np.float32)
    vp = rng.standard_normal((KV, nb * bs, D)).astype(np.float32)
    # trash-padded: entries past a slot's pages point at page 0
    tables = np.zeros((S, max_pages), np.int32)
    perm = rng.permutation(nb - 1) + 1
    per = max_pages
    for s in range(S):
        tables[s] = perm[s * per:(s + 1) * per] if (s + 1) * per < nb \
            else rng.integers(1, nb, max_pages)
    return q, kp, vp, tables


def _both(q, kp, vp, tables, lens, starts, **kw):
    lens = np.asarray(lens, np.int32)
    starts = np.asarray(starts, np.int32)
    want = np.asarray(jpa.paged_prefill_attention(
        *(jnp.asarray(a) for a in (q, kp, vp, tables, lens, starts)), **kw))
    got = pa.paged_prefill_attention(
        *(torch.tensor(a) for a in (q, kp, vp, tables, lens, starts)), **kw)
    return got.numpy(), want


@pytest.mark.parametrize("G", [1, 4])
def test_prefill_chunks_with_an_empty_slot(G):
    KV, bs = 2, 8
    q, kp, vp, tables = _case(S=4, T=6, H=KV * G, KV=KV, D=64, bs=bs, nb=40,
                              max_pages=6, seed=G)
    lens, starts = [13, 0, 40, 6], [7, 0, 34, 0]
    got, want = _both(q, kp, vp, tables, lens, starts, block_size=bs)
    np.testing.assert_allclose(got, want, atol=2e-5)
    assert not got[1].any()                      # the empty slot


@pytest.mark.parametrize("window", [4, 8, 20])
def test_window_matches_and_keeps_the_unguarded_softmax(window):
    """With a window, rows at or past seq_len can see no key on a page the
    kernel runs: the Pallas kernel, with no guard, averages those pages'
    values (p = exp(NEG_INF - NEG_INF) = 1), and the plain version does
    too (slot 2, rows 16.. under window 4)."""
    bs = 8
    q, kp, vp, tables = _case(S=3, T=6, H=4, KV=2, D=64, bs=bs, nb=40,
                              max_pages=6, seed=window)
    lens, starts = [30, 40, 12], [25, 36, 14]
    got, want = _both(q, kp, vp, tables, lens, starts, block_size=bs,
                      window=window)
    np.testing.assert_allclose(got, want, atol=2e-5)
    if window == 4:
        page = vp[:, tables[2, 1] * bs:(tables[2, 1] + 1) * bs]   # [KV,bs,D]
        np.testing.assert_allclose(got[2, 2:, 0], np.broadcast_to(
            page[0].mean(0), (4, 64)), atol=2e-5)


@pytest.mark.parametrize("G", [1, 2])
def test_wrapped_ring_matches(G):
    """A 4-page ring of 8-token pages (ring_tokens 32) holding 50 and 70
    tokens (wrapped), 9 tokens (not yet), and an empty slot."""
    KV, bs = 2, 8
    q, kp, vp, tables = _case(S=4, T=4, H=KV * G, KV=KV, D=64, bs=bs, nb=40,
                              max_pages=4, seed=10 + G)
    lens, starts = [50, 9, 70, 0], [46, 5, 66, 0]
    got, want = _both(q, kp, vp, tables, lens, starts, block_size=bs,
                      window=20, ring_tokens=32)
    np.testing.assert_allclose(got, want, atol=2e-5)
    assert not got[3].any()


@pytest.mark.parametrize("window,ring", [(None, None), (16, None),
                                         (20, 32)])
def test_decode_matches(window, ring):
    bs = 8
    q, kp, vp, tables = _case(S=4, T=1, H=8, KV=2, D=64, bs=bs, nb=40,
                              max_pages=4 if ring else 8, seed=20)
    lens = np.asarray([50 if ring else 33, 1, 0, 27], np.int32)
    q = q[:, 0]
    want = np.asarray(jpa.paged_decode_attention(
        *(jnp.asarray(a) for a in (q, kp, vp, tables, lens)), block_size=bs,
        window=window, ring_tokens=ring))
    pa.prefill_counts.reset()
    got = pa.paged_decode_attention(
        *(torch.tensor(a) for a in (q, kp, vp, tables, lens)), block_size=bs,
        window=window, ring_tokens=ring)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)
    assert not got[2].any()
    # the CPU route is the plain version, counted apart from K1's
    assert vars(pa.prefill_counts) == {"kernel": 0, "kernel_window": 0,
                                       "kernel_ring": 0, "kernel_chunk": 0,
                                       "kernel_split": 0, "plain": 1}


def test_bf16_plain_rounds_p_to_v_dtype():
    q, kp, vp, tables = _case(S=2, T=3, H=4, KV=2, D=64, bs=8, nb=20,
                              max_pages=4, seed=30)
    args = [torch.tensor(a) for a in (q, kp, vp, tables)]
    lens, starts = torch.tensor([20, 9]), torch.tensor([17, 6])
    f32 = pa.paged_prefill_attention(*args, lens, starts, block_size=8)
    bf = pa.paged_prefill_attention(*(a.bfloat16() if a.is_floating_point()
                                       else a for a in args), lens, starts,
                                     block_size=8)
    assert bf.dtype == torch.bfloat16
    err = (bf.float() - f32).abs().max() / f32.abs().max()
    assert 0 < err < 2e-2


@pytest.mark.parametrize("kw,P,H,KV", [
    (dict(block_size=7), 64, 4, 2),
    (dict(block_size=8), 64, 6, 4),
    (dict(block_size=8, ring_tokens=32), 64, 4, 2),
    (dict(block_size=8, window=16, ring_tokens=36), 64, 4, 2),
])
def test_same_value_errors(kw, P, H, KV):
    q = np.zeros((1, 2, H, 64), np.float32)
    pool = np.zeros((KV, P, 64), np.float32)
    tables = np.zeros((1, 2), np.int32)
    lens = starts = np.zeros((1,), np.int32)
    with pytest.raises(ValueError) as jerr:
        jpa.paged_prefill_attention(
            *(jnp.asarray(a) for a in (q, pool, pool, tables, lens, starts)),
            **kw)
    with pytest.raises(ValueError) as terr:
        pa.paged_prefill_attention(
            *(torch.tensor(a) for a in (q, pool, pool, tables, lens, starts)),
            **kw)
    assert str(terr.value) == str(jerr.value)
