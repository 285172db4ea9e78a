"""K4, the flash-attention kernel's plain versions (``deepspeed_tpu_torch.
ops.flash_attention``), against the JAX package: the Pallas
``flash_attention`` custom VJP in interpret mode (its merged single-block
backward at S = 128, its split dq / dk-dv backward at S = 256 with
128-row blocks), ``jax.grad`` of the XLA attention on a grid of shapes, and
the dispatcher's gate against the JAX gate. Inputs are made from a seed with
numpy and handed to both."""
import importlib
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.attention import _xla_attention
from deepspeed_tpu_torch.ops import flash_attention as fa
from deepspeed_tpu_torch.ops.attention import dot_product_attention

# the module (``deepspeed_tpu.ops.pallas`` re-exports a function of its name)
jfa = importlib.import_module("deepspeed_tpu.ops.pallas.flash_attention")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    # the suite runs under several xdist workers: one intra-op thread each
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _inputs(B, S, H, KV, D, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return f(B, S, H, D), f(B, S, KV, D), f(B, S, KV, D), f(B, S, H, D)


def _torch_grads(q, k, v, do, causal, dtype=torch.float32):
    """(out, dq, dk, dv) of the port's autograd function (the plain
    versions on the CPU), as fp32 numpy, inputs [B, S, H, D]."""
    ts = [torch.tensor(a).to(dtype).requires_grad_() for a in (q, k, v)]
    out = fa.flash_attention(*ts, causal=causal)
    out.backward(torch.tensor(do).to(dtype))
    return [t.detach().float().numpy() for t in (out, *(x.grad for x in ts))]


def _rel(got, want):
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("S,blocks", [(128, None), (256, 128)])
def test_plain_versions_match_the_pallas_kernel(S, blocks):
    """Forward (out and lse) and dq/dk/dv against the Pallas custom VJP in
    interpret mode: S = 128 takes its merged ``_dqkv_kernel``, S = 256 with
    128-row blocks its split ``_dq_kernel`` / ``_dkv_kernel``. Causal, GQA
    2, D 64, fp32."""
    B, H, KV, D = 1, 4, 2, 64
    q, k, v, do = _inputs(B, S, H, KV, D)
    scale = 1.0 / (D ** 0.5)
    bq, bk = jfa._pick_blocks(S, S, D, 4, blocks, blocks)
    assert (bk == S) == (blocks is None)       # merged vs split schedule
    t = lambda a: jnp.swapaxes(jnp.asarray(a), 1, 2)
    j_out, j_lse = jfa._fwd(t(q), t(k), t(v), causal=True, scale=scale,
                            block_q=bq, block_k=bk)
    p_out, p_lse = fa.flash_fwd_plain(*(torch.tensor(a).transpose(1, 2)
                                        for a in (q, k, v)), True, scale)
    np.testing.assert_allclose(p_out.numpy(), np.asarray(j_out), atol=2e-6)
    np.testing.assert_allclose(p_lse.numpy(), np.asarray(j_lse)[..., 0],
                               atol=2e-6)

    def f(q_, k_, v_):
        return jfa.flash_attention(q_, k_, v_, causal=True, block_q=blocks,
                                   block_k=blocks)

    j_o, vjp = jax.vjp(f, *(jnp.asarray(a) for a in (q, k, v)))
    j_grads = vjp(jnp.asarray(do))
    got = _torch_grads(q, k, v, do, causal=True)
    np.testing.assert_allclose(got[0], np.asarray(j_o), atol=2e-6)
    for name, g, w in zip(("dq", "dk", "dv"), got[1:], j_grads):
        assert _rel(g, np.asarray(w)) <= 2e-5, name


GRID = [(causal, G, S) for causal, G, S in
        itertools.product((True, False), (1, 2, 4), (128, 160))]


@pytest.mark.parametrize("causal,G,S", GRID)
@pytest.mark.parametrize("dtype,tol", [("float32", 2e-5), ("bfloat16", 2e-2)])
def test_autograd_matches_xla_attention_grad(causal, G, S, dtype, tol):
    """The port's flash route (its plain versions on the CPU) against
    ``jax.grad`` of the JAX package's XLA attention, in fp32 and bf16."""
    B, KV, D = 2, 2, 64
    H = KV * G
    q, k, v, do = _inputs(B, S, H, KV, D, seed=G + 7 * causal)
    jdt = jnp.dtype(dtype)

    def f(q_, k_, v_):
        return _xla_attention(q_, k_, v_, causal=causal, positions=None,
                              kv_len=None, mask=None)

    j_o, vjp = jax.vjp(f, *(jnp.asarray(a, jdt) for a in (q, k, v)))
    j_grads = vjp(jnp.asarray(do, jdt))
    got = _torch_grads(q, k, v, do, causal, getattr(torch, dtype))
    want = [np.asarray(x, np.float32) for x in (j_o, *j_grads)]
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        assert _rel(g, w) <= tol, (name, _rel(g, w))


def _gate_cases():
    shapes = []
    for S, D, (H, KV), dt in itertools.product(
            (64, 127, 128, 200, 1024, 1100, 1536, 2048, 3000, 4096, 8192),
            (32, 64, 80, 128, 256), ((8, 8), (8, 2), (6, 4)),
            ("float32", "bfloat16")):
        shapes.append((1, S, S, H, KV, D, dt, False, False))
    shapes += [(2, 256, 512, 8, 8, 64, "float32", False, False),
               (2, 256, 256, 8, 8, 64, "float32", True, False),
               (2, 256, 256, 8, 8, 64, "float32", False, True)]
    return shapes


def test_gate_agrees_with_the_jax_gate():
    """The port claims K4 for exactly the calls the JAX gate claims its
    Pallas kernel (called with ``allow_multi_device=True``: the test session
    has 8 virtual devices)."""
    disagree = []
    for B, Sq, Skv, H, KV, D, dt, pos, msk in _gate_cases():
        jq = jax.ShapeDtypeStruct((B, Sq, H, D), jnp.dtype(dt))
        jk = jax.ShapeDtypeStruct((B, Skv, KV, D), jnp.dtype(dt))
        positions = np.zeros((B, Sq), np.int32) if pos else None
        mask = np.ones((B, Skv), np.int32) if msk else None
        want = jfa.flash_attention_usable(
            jq, jk, jk, causal=True, positions=positions, mask=mask,
            allow_multi_device=True)
        tq = torch.empty((B, Sq, H, D), dtype=getattr(torch, dt),
                         device="meta")
        tk = torch.empty((B, Skv, KV, D), dtype=getattr(torch, dt),
                         device="meta")
        got = fa.flash_attention_usable(
            tq, tk, tk, causal=True,
            positions=None if positions is None else torch.tensor(positions),
            mask=None if mask is None else torch.tensor(mask))
        if got != want:
            disagree.append((B, Sq, Skv, H, KV, D, dt, pos, msk, want))
    assert not disagree, disagree


def test_dispatcher_routes_and_counts():
    """"auto" takes K4 where the gate holds (the plain version on CPU
    tensors, counted as ``plain``), the plain dense route elsewhere;
    "pallas" raises where the gate refuses, and with a window or a bias."""
    q, k, v, _ = _inputs(1, 128, 4, 2, 64)
    q, k, v = (torch.tensor(a) for a in (q, k, v))
    fa.counts.reset()
    a = dot_product_attention(q, k, v, causal=True)
    assert (fa.counts.plain, fa.counts.fwd) == (1, 0)
    b = dot_product_attention(q, k, v, causal=True, impl="xla")
    assert fa.counts.plain == 1
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-6)
    dot_product_attention(q, k, v, causal=True, window=64)
    assert fa.counts.plain == 1
    with pytest.raises(ValueError, match="not usable"):
        dot_product_attention(q[:, :64], k[:, :64], v[:, :64], impl="pallas")
    with pytest.raises(ValueError, match="sliding-window"):
        dot_product_attention(q, k, v, impl="pallas", window=64)
    with pytest.raises(ValueError, match="unknown attention impl"):
        dot_product_attention(q, k, v, impl="flash")
