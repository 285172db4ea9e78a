"""The fused vocab-chunked head loss (``models/loss.fused_lm_head_loss``,
behind ``DS_TPU_FUSED_HEAD_CHUNK``) against the JAX package's
``fused_lm_head_loss`` and against the port's unfused loss, within 1e-5:
a tail chunk (V not a multiple of the chunk), masked labels, tied
``[V, E]`` and untied ``[E, V]`` heads, a bias and z-loss, values and
gradients; a 3-step engine run with the switch set against the JAX
engine's; and the activation-offload remat policy's gradients equal to
"full"'s in a model."""
import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.models.loss import (IGNORE_INDEX, cross_entropy_lm,
                                             fused_lm_head_loss)

B, S, E, V = 2, 24, 32, 100


def inputs(seed, w_is_ve, bias):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, E)).astype(np.float32)
    w = (rng.standard_normal((V, E) if w_is_ve else (E, V)) * 0.3
         ).astype(np.float32)
    b = (rng.standard_normal(V) * 0.1).astype(np.float32) if bias else None
    labels = rng.integers(0, V, (B, S)).astype(np.int64)
    labels[0, :5] = IGNORE_INDEX
    labels[1, -3:] = IGNORE_INDEX
    labels[1, 0] = V - 1                       # in the tail chunk
    return x, w, b, labels


def port(x, w, b, labels, w_is_ve, z, vchunk, fused=True):
    xt = torch.tensor(x, requires_grad=True)
    wt = torch.tensor(w, requires_grad=True)
    bt = None if b is None else torch.tensor(b, requires_grad=True)
    lab = torch.tensor(labels)
    if fused:
        loss = fused_lm_head_loss(xt, wt, lab, bias=bt, w_is_ve=w_is_ve,
                                  z_loss_weight=z, vchunk=vchunk)
    else:
        logits = xt @ (wt.t() if w_is_ve else wt)
        if bt is not None:
            logits = logits + bt
        loss = cross_entropy_lm(logits, lab, z_loss_weight=z)
    loss.backward()
    grads = [xt.grad.numpy(), wt.grad.numpy()] + \
        ([] if bt is None else [bt.grad.numpy()])
    return float(loss.detach()), grads


def jax_fused(x, w, b, labels, w_is_ve, z, vchunk):
    import jax
    import jax.numpy as jnp

    from deepspeed_tpu.models.loss import fused_lm_head_loss as jf

    def f(x, w, b):
        return jf(x, w, jnp.asarray(labels), bias=b, w_is_ve=w_is_ve,
                  z_loss_weight=z, vchunk=vchunk)

    args = (jnp.asarray(x), jnp.asarray(w),
            None if b is None else jnp.asarray(b))
    argnums = (0, 1) if b is None else (0, 1, 2)
    loss, grads = jax.value_and_grad(f, argnums=argnums)(*args)
    return float(loss), [np.asarray(g) for g in grads]


CASES = [(True, False, 0.0, 32), (False, False, 0.0, 32),
         (True, True, 1e-3, 32), (False, True, 1e-2, 64),
         (True, False, 0.0, 100), (False, True, 0.0, 7)]


@pytest.mark.parametrize("w_is_ve,bias,z,vchunk", CASES,
                         ids=[f"{'tied' if t else 'untied'}-"
                              f"{'bias' if b else 'nobias'}-z{z}-c{c}"
                              for t, b, z, c in CASES])
def test_fused_head_loss_matches_jax_and_the_unfused_loss(w_is_ve, bias, z,
                                                          vchunk):
    x, w, b, labels = inputs(3, w_is_ve, bias)
    got, g_got = port(x, w, b, labels, w_is_ve, z, vchunk)
    want, g_want = jax_fused(x, w, b, labels, w_is_ve, z, vchunk)
    ref, g_ref = port(x, w, b, labels, w_is_ve, z, vchunk, fused=False)
    assert got == pytest.approx(want, rel=1e-5)
    assert got == pytest.approx(ref, rel=1e-5)
    for a, bj, r in zip(g_got, g_want, g_ref):
        scale = float(np.abs(r).max())
        assert float(np.abs(a - bj).max()) <= 1e-5 * scale
        assert float(np.abs(a - r).max()) <= 1e-5 * scale


def test_fused_head_in_bf16_follows_the_unfused_loss():
    x, w, b, labels = inputs(5, True, False)
    xt = torch.tensor(x).bfloat16().requires_grad_(True)
    wt = torch.tensor(w).bfloat16().requires_grad_(True)
    loss = fused_lm_head_loss(xt, wt, torch.tensor(labels), vchunk=32)
    loss.backward()
    assert xt.grad.dtype == torch.bfloat16 and wt.grad.dtype == torch.bfloat16
    ref, _ = port(x, w, None, labels, True, 0.0, 32, fused=False)
    assert float(loss.detach()) == pytest.approx(ref, rel=1e-2)


@pytest.mark.parametrize("name", ["tiny-llama", "tiny-gpt2"])
def test_engine_with_the_fused_head_matches_the_jax_engine(name,
                                                           monkeypatch):
    """3 AdamW steps (fp32, ``eps=1e-5``) with ``DS_TPU_FUSED_HEAD_CHUNK``
    set in both engines: 96 vocab columns a chunk over 256, a tail."""
    import flax
    import jax
    import jax.numpy as jnp

    import deepspeed_tpu as ds
    import deepspeed_tpu_torch as dst
    from deepspeed_tpu.models import build_model as jax_build_model
    from deepspeed_tpu.parallel.topology import single_device_topology
    from deepspeed_tpu_torch.models import build_model

    monkeypatch.setenv("DS_TPU_FUSED_HEAD_CHUNK", "96")
    cfg = {"train_micro_batch_size_per_gpu": 2,
           "gradient_accumulation_steps": 2,
           "optimizer": {"type": "AdamW",
                         "params": {"lr": 1e-3, "eps": 1e-5,
                                    "weight_decay": 0.01}},
           "bf16": {"enabled": False}, "steps_per_print": 10_000}
    rng = np.random.default_rng(11)
    bs = [{"input_ids": rng.integers(0, 256, (4, 32)).astype(np.int32)}
          for _ in range(3)]
    je, *_ = ds.initialize(model=jax_build_model(name, dtype=jnp.float32),
                           config=dict(cfg),
                           topology=single_device_topology())
    unbox = lambda t: jax.tree.map(lambda a: np.asarray(a, np.float32),
                                   jax.device_get(flax.core.meta.unbox(t)))
    init = unbox(je.state.params)
    want = [float(je.train_batch(b)) for b in bs]
    pe, *_ = dst.initialize(model=build_model(name, device="cpu",
                                              dtype=torch.float32),
                            config=dict(cfg), params=init, device="cpu")
    got = [float(pe.train_batch(b)) for b in bs]
    np.testing.assert_allclose(got, want, rtol=1e-5)
    params = unbox(je.state.params)
    master = pe.master

    def walk(a, b):
        if isinstance(a, dict):
            return max(walk(a[k], b[k]) for k in a)
        return float(np.abs(a - b.numpy()).max())

    assert walk(params, master) <= 1e-5


def test_offload_policy_gives_full_remat_gradients():
    """A model under remat "offload": the forward keeps only the unbatched
    products' outputs (in host memory), the backward's recompute takes
    them back and runs the rest again; the gradients are "full"'s."""
    import dataclasses

    from deepspeed_tpu_torch.models import build_model
    from deepspeed_tpu_torch.models.loss import lm_loss_fn
    from deepspeed_tpu_torch.ops import remat

    ids = torch.tensor(np.random.default_rng(2).integers(0, 256, (2, 32)))
    grads = {}
    for policy in ("full", "offload"):
        m = build_model("tiny-llama", device="cpu", dtype=torch.float32)
        m.config = dataclasses.replace(m.config, remat=True,
                                       remat_policy=policy)
        for p in m.parameters():
            p.requires_grad_(True)
        before = dict(remat.offload_counts)
        lm_loss_fn(m, {"input_ids": ids}).backward()
        grads[policy] = {n: p.grad.clone() for n, p in m.named_parameters()}
        saved = remat.offload_counts["saved"] - before["saved"]
        restored = remat.offload_counts["restored"] - before["restored"]
        if policy == "offload":
            # 7 products a block (q, k, v, o, gate, up, down) x 2 blocks
            assert saved == 14 and restored >= 12
        else:
            assert saved == restored == 0
    for n, g in grads["full"].items():
        assert torch.equal(grads["offload"][n], g), n
