"""The grouped product of the port (``deepspeed_tpu_torch.ops.
grouped_matmul``, K5's plain version) against the JAX package's Pallas
``grouped_matmul`` (``deepspeed_tpu/ops/pallas/grouped_matmul.py``), which
runs in interpret mode on the CPU as ``tests/test_moe.py`` runs it.

Both get the same expert-sorted buffer (numpy, seeded) and the JAX sort's
tile→expert map. Tolerances, over max |JAX|: fp32 1e-5 (both sum exact
fp32 products, in different orders); bf16 1e-2 (one bf16 rounding of the
output, up to 2^-8 relative, may land apart)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.pallas import grouped_matmul as jg
from deepspeed_tpu_torch.ops import grouped_matmul as tg

TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
#: (tokens T, top-k, experts n, K, N, block_m)
CASES = [(37, 2, 4, 64, 96, 8), (50, 4, 6, 32, 40, 16),
         (16, 2, 8, 48, 64, 32), (100, 1, 3, 24, 16, 128)]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _inputs(T, k, n, K, N, bm, seed=0):
    """(buf [Tp, K], w [n, K, N], tile_expert, the port's sort) from one
    seeded routing: the buffer holds each token's row at its sorted
    destination and zeros elsewhere."""
    rng = np.random.default_rng(seed)
    eidx = rng.integers(0, n, (T, k)).astype(np.int32)
    x = rng.standard_normal((T, K)).astype(np.float32)
    w = rng.standard_normal((n, K, N)).astype(np.float32)
    srt = jg.sort_tokens_by_expert(jnp.asarray(eidx), n, bm)
    buf = np.zeros((srt.Tp, K), np.float32)
    buf[np.asarray(srt.dst)] = np.repeat(x, k, axis=0)
    port_srt = tg.sort_tokens_by_expert(torch.from_numpy(eidx), n, bm)
    return buf, w, np.array(srt.tile_expert), port_srt


def _max_err(got, ref):
    ref = np.asarray(ref, np.float32)
    return np.abs(got.float().numpy() - ref).max() / np.abs(ref).max()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", CASES)
def test_plain_version_matches_the_pallas_kernel(case, dtype):
    T, k, n, K, N, bm = case
    buf, w, te, _ = _inputs(*case)
    ref = jg.grouped_matmul(jnp.asarray(buf, JDT[dtype]),
                            jnp.asarray(w, JDT[dtype]), jnp.asarray(te), bm)
    before = tg.counts.plain
    got = tg.grouped_matmul(torch.from_numpy(buf).to(dtype),
                            torch.from_numpy(w).to(dtype),
                            torch.from_numpy(te), bm)
    assert tg.counts.plain == before + 1
    assert got.dtype == dtype and tuple(got.shape) == (buf.shape[0], N)
    assert _max_err(got, ref) <= TOL[dtype]


@pytest.mark.parametrize("case", CASES)
def test_tile_rows_skip_only_padding(case):
    """With the sort's routed-row counts the result is the whole product
    (padding rows of x are zero), and rows past the counts are zero even
    where x is not."""
    T, k, n, K, N, bm = case
    buf, w, te, srt = _inputs(*case, seed=1)
    x, wt, tet = (torch.from_numpy(a) for a in (buf, w, te))
    full = tg.grouped_matmul(x, wt, tet, bm)
    got = tg.grouped_matmul(x, wt, tet, bm, srt.tile_rows)
    assert torch.equal(got, full)
    routed = tg.row_mask(x.shape[0], bm, srt.tile_rows)
    assert int(routed.sum()) == T * k
    noisy = x + (~routed)[:, None] * 7.0
    got = tg.grouped_matmul(noisy, wt, tet, bm, srt.tile_rows)
    assert torch.equal(got, full)


def test_the_backward_waits_for_the_training_slice():
    """The training slice brought the backward: on the CPU route gradients
    flow through ``grouped_matmul`` to x and w (the plain dx and dw, each
    counted once), and equal autograd through the plain forward written
    out row by row (fp32, 1e-5 of the largest gradient)."""
    buf, w, te, srt = _inputs(37, 2, 4, 64, 96, 8, seed=2)
    x = torch.from_numpy(buf).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    before = (tg.counts.plain_dx, tg.counts.plain_dw)
    out = tg.grouped_matmul(x, wt, torch.from_numpy(te), 8, srt.tile_rows)
    dy = torch.randn(out.shape, generator=torch.Generator().manual_seed(0))
    out.backward(dy)
    assert (tg.counts.plain_dx, tg.counts.plain_dw) == (before[0] + 1,
                                                        before[1] + 1)
    x2 = x.detach().clone().requires_grad_()
    w2 = wt.detach().clone().requires_grad_()
    rows = torch.from_numpy(te).long().repeat_interleave(8)
    keep = tg.row_mask(x2.shape[0], 8, srt.tile_rows)[:, None]
    (torch.einsum("tk,tkn->tn", x2, w2[rows]) * keep).backward(dy)
    for got, want in ((x.grad, x2.grad), (wt.grad, w2.grad)):
        assert (got - want).abs().max() <= 1e-5 * want.abs().max()


def test_shapes_are_checked():
    x, w = torch.zeros(16, 8), torch.zeros(2, 8, 4)
    te = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="multiple of block_m"):
        tg.grouped_matmul(x[:12], w, te, 8)
    with pytest.raises(ValueError, match="contracting"):
        tg.grouped_matmul(x, torch.zeros(2, 6, 4), te, 8)
    with pytest.raises(ValueError, match="tile_expert"):
        tg.grouped_matmul(x, w, te[:1], 8)
