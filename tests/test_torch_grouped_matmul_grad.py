"""K5's backward in the port: the plain dx and dw
(``grouped_matmul_dx_reference``, ``grouped_matmul_dw_reference``, the
CPU route of ``grouped_matmul_dx`` / ``grouped_matmul_dw``) against
``jax.vjp`` of the JAX package's Pallas ``grouped_matmul``
(``deepspeed_tpu/ops/pallas/grouped_matmul.py``: the ``transpose_rhs`` form
of ``_gmm_kernel`` and ``_dw_kernel``, in interpret mode on the CPU as
``tests/test_moe.py`` runs them), and the port's autograd Function against
autograd through its plain forward.

Routings: uniform random; skewed (every token on the same two experts);
idle experts (tokens on the first three of eight, so most experts own no
tile and dw must be zero for them, and the clipped tiles past the end name
an idle last expert); every token on the last expert (the clipped tiles
past the end name a busy one and must add nothing). With ``tile_rows`` the
port leaves the padding rows out, so the JAX side gets a cotangent that is
zero on them; without it every row counts on both sides.

Tolerances: fp32 2e-4 absolute (``tests/test_moe.py``'s bound for the
Pallas gradients against a dense reference; both sum exact fp32 products
in other orders); bf16 1e-2 of the largest |JAX| value (each output is
one bf16 rounding, up to 2^-8 relative, of an fp32 sum)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.pallas import grouped_matmul as jg
from deepspeed_tpu_torch.ops import grouped_matmul as tg

JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
#: routing → (tokens T, top-k, experts n, K, N, block_m)
CASES = {"random": (37, 2, 4, 64, 96, 8),
         "skewed": (40, 2, 6, 32, 40, 16),
         "idle": (24, 2, 8, 48, 64, 8),
         "last": (30, 1, 3, 24, 16, 8)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _routing(kind, T, k, n, rng):
    if kind == "skewed":
        return np.tile(np.array([1, 2][:k], np.int32), (T, 1))
    if kind == "last":
        return np.full((T, k), n - 1, np.int32)
    m = n if kind == "random" else 3
    return np.argsort(rng.random((T, m)), axis=1)[:, :k].astype(np.int32)


def _inputs(kind, seed=0):
    """(buf [Tp, K], w [n, K, N], dy [Tp, N], JAX tile_expert, the port's
    sort, block_m, n) from one seeded routing."""
    T, k, n, K, N, bm = CASES[kind]
    rng = np.random.default_rng(seed)
    eidx = _routing(kind, T, k, n, rng)
    srt = jg.sort_tokens_by_expert(jnp.asarray(eidx), n, bm)
    buf = np.zeros((srt.Tp, K), np.float32)
    buf[np.asarray(srt.dst)] = np.repeat(
        rng.standard_normal((T, K)).astype(np.float32), k, axis=0)
    w = (rng.standard_normal((n, K, N)) / np.sqrt(K)).astype(np.float32)
    dy = rng.standard_normal((srt.Tp, N)).astype(np.float32)
    port = tg.sort_tokens_by_expert(torch.from_numpy(eidx), n, bm)
    np.testing.assert_array_equal(port.tile_expert.numpy(),
                                  np.asarray(srt.tile_expert))
    return buf, w, dy, np.array(srt.tile_expert), port, bm, n


def _jax_grads(buf, w, dy, te, bm, dtype):
    """(dx, dw) of the Pallas grouped_matmul by jax.vjp, as fp32 numpy."""
    jd = JDT[dtype]
    _, vjp = jax.vjp(lambda x, ww: jg.grouped_matmul(x, ww, jnp.asarray(te),
                                                      bm),
                     jnp.asarray(buf, jd), jnp.asarray(w, jd))
    dx, dw = vjp(jnp.asarray(dy, jd))
    assert dx.dtype == dw.dtype == jd
    return np.asarray(dx, np.float32), np.asarray(dw, np.float32)


def _close(got, ref, dtype):
    got = got.float().numpy()
    if dtype == torch.float32:
        np.testing.assert_allclose(got, ref, atol=2e-4, rtol=0)
    else:
        assert np.abs(got - ref).max() <= 1e-2 * np.abs(ref).max()


@pytest.mark.parametrize("with_rows", [False, True],
                         ids=["every-row", "tile-rows"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", sorted(CASES))
def test_plain_dx_dw_match_the_pallas_vjp(kind, dtype, with_rows):
    buf, w, dy, te, srt, bm, n = _inputs(kind)
    rows = srt.tile_rows if with_rows else None
    if with_rows:
        dy = dy * tg.row_mask(dy.shape[0], bm, rows).numpy()[:, None]
    ref_dx, ref_dw = _jax_grads(buf, w, dy, te, bm, dtype)
    x_t, w_t, dy_t, te_t = (torch.from_numpy(a) for a in (buf, w, dy, te))
    x_t, w_t, dy_t = x_t.to(dtype), w_t.to(dtype), dy_t.to(dtype)
    before = (tg.counts.plain_dx, tg.counts.plain_dw)
    dx = tg.grouped_matmul_dx(dy_t, w_t, te_t, bm, rows)
    dw = tg.grouped_matmul_dw(x_t, dy_t, te_t, n, bm, rows, w_t.dtype)
    assert (tg.counts.plain_dx, tg.counts.plain_dw) == (before[0] + 1,
                                                        before[1] + 1)
    assert dx.dtype == dw.dtype == dtype
    assert tuple(dx.shape) == buf.shape and tuple(dw.shape) == w.shape
    _close(dx, ref_dx, dtype)
    _close(dw, ref_dw, dtype)
    # experts that own no tile get exact zeros; so do the padding rows of
    # dx when tile_rows leaves them out
    owned = set(te[np.asarray(srt.tile_rows) > 0].tolist())
    for e in set(range(n)) - owned:
        assert not dw[e].any()
    if with_rows:
        pad = ~tg.row_mask(dy.shape[0], bm, rows)
        assert not dx[pad].any()
    if kind == "idle":
        assert len(owned) <= 3


@pytest.mark.parametrize("kind", sorted(CASES))
def test_autograd_function_matches_autograd_through_the_plain_forward(kind):
    """``grouped_matmul``'s backward (the plain dx and dw on the CPU) gives
    what autograd computes through the forward written out row by row:
    fp32, 1e-5 of the largest gradient."""
    buf, w, dy, te, srt, bm, n = _inputs(kind, seed=1)
    x = torch.from_numpy(buf).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    out = tg.grouped_matmul(x, wt, torch.from_numpy(te), bm, srt.tile_rows)
    out.backward(torch.from_numpy(dy))
    x2 = x.detach().clone().requires_grad_()
    w2 = wt.detach().clone().requires_grad_()
    row_e = torch.from_numpy(te).long().repeat_interleave(bm)
    keep = tg.row_mask(buf.shape[0], bm, srt.tile_rows)[:, None]
    (torch.einsum("tk,tkn->tn", x2, w2[row_e]) * keep).backward(
        torch.from_numpy(dy))
    for got, want in ((x.grad, x2.grad), (wt.grad, w2.grad)):
        assert (got - want).abs().max() <= 1e-5 * want.abs().max()


def test_only_the_needed_gradient_is_computed():
    """A weight that needs no gradient costs no dw, and the reverse."""
    buf, w, dy, te, srt, bm, n = _inputs("random", seed=2)
    te_t = torch.from_numpy(te)
    for x_grad in (True, False):
        x = torch.from_numpy(buf).requires_grad_(x_grad)
        wt = torch.from_numpy(w).requires_grad_(not x_grad)
        before = (tg.counts.plain_dx, tg.counts.plain_dw)
        tg.grouped_matmul(x, wt, te_t, bm).backward(torch.from_numpy(dy))
        assert (tg.counts.plain_dx - before[0],
                tg.counts.plain_dw - before[1]) == (int(x_grad),
                                                    int(not x_grad))


def test_backward_shapes_are_checked():
    te = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="dy must be"):
        tg.grouped_matmul_dx(torch.zeros(16, 5), torch.zeros(2, 8, 4), te, 8)
    with pytest.raises(ValueError, match="x must be"):
        tg.grouped_matmul_dw(torch.zeros(16, 8), torch.zeros(8, 4), te, 2, 8)
    with pytest.raises(ValueError, match="multiple of block_m"):
        tg.grouped_matmul_dw(torch.zeros(12, 8), torch.zeros(12, 4), te, 2, 8)
