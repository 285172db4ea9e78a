"""MoE training through the port's engine (``deepspeed_tpu_torch.initialize``
→ ``train_batch``) on the CPU against the JAX engine on one device, from
the JAX engine's initial parameters and the same seeded batches: the
capacity route (einsums, tokens dropped past ``capacity_factor``) and the
dropless route (grouped products: K5's plain versions here, its CUDA
kernels on the card; the JAX engine runs the Pallas kernels in interpret
mode), with the gating aux and z losses in the loss.

fp32, 3 steps, gas 2: losses within 1e-6 relative (both sum the same fp32
terms in other orders); parameters within 1e-5 after the last step, with
AdamW at ``eps=1e-5`` as ``tests/test_torch_train_engine.py`` explains.
bf16 compares losses within 2e-2 (bf16 rounds in other places in the two
packages)."""
import dataclasses

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu as ds
import deepspeed_tpu_torch as dst
from deepspeed_tpu.models import build_model as jax_build_model
from deepspeed_tpu.models import get_model_config as jax_model_config
from deepspeed_tpu.parallel.topology import single_device_topology
from deepspeed_tpu_torch.inference.weights import to_jax_tree
from deepspeed_tpu_torch.models import build_model, get_model_config
from deepspeed_tpu_torch.models.loss import lm_loss_fn
from deepspeed_tpu_torch.moe.layer import MoE
from deepspeed_tpu_torch.ops import grouped_matmul as gm


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    # the suite runs under several xdist workers: one intra-op thread each
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def config(**over):
    cfg = {"train_micro_batch_size_per_gpu": 2,
           "gradient_accumulation_steps": 2,
           "optimizer": {"type": "AdamW",
                         "params": {"lr": 1e-3, "eps": 1e-5,
                                    "weight_decay": 0.01}},
           "bf16": {"enabled": False}, "steps_per_print": 10_000}
    cfg.update(over)
    return cfg


def batch(B=4, S=32, seed=0):
    rng = np.random.default_rng(seed)
    return {"input_ids": rng.integers(0, 256, (B, S)).astype(np.int32)}


#: (preset, MoEConfig overrides, model overrides)
CASES = {
    "tiny-mixtral-capacity": ("tiny-mixtral", {}, {}),
    "tiny-mixtral-dropless": ("tiny-mixtral", {"dropless": True}, {}),
    "tiny-qwen2-moe-dropless": ("tiny-qwen2-moe", {"dropless": True}, {}),
    "mixed-stack-freq2": ("tiny-mixtral", {"moe_layer_freq": 2},
                          {"num_layers": 3}),
}


def overrides(name, moe_over, model_over, config_of):
    moe = dataclasses.replace(config_of(name).moe, **moe_over)
    return dict(model_over, moe=moe)


def jax_engine(name, moe_over, model_over, cfg, dtype=jnp.float32):
    over = overrides(name, moe_over, model_over, jax_model_config)
    engine, *_ = ds.initialize(
        model=jax_build_model(name, dtype=dtype, **over), config=cfg,
        topology=single_device_topology())
    init = jax.device_get(flax.core.meta.unbox(engine.state.params))
    return engine, jax.tree.map(lambda a: np.asarray(a, np.float32), init)


def port_engine(name, moe_over, model_over, cfg, init, dtype=torch.float32):
    over = overrides(name, moe_over, model_over, get_model_config)
    engine, *_ = dst.initialize(
        model=build_model(name, device="cpu", dtype=dtype, **over),
        config=cfg, params=init, device="cpu")
    return engine


def max_diff(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b), (sorted(a), sorted(b))
        return max(max_diff(a[k], b[k]) for k in a)
    return float(np.abs(np.asarray(a, np.float32) - b).max())


def run(engine, b, steps):
    return [float(engine.train_batch(b)) for _ in range(steps)]


@pytest.mark.parametrize("case", sorted(CASES))
def test_fp32_moe_training_matches_the_jax_engine(case):
    name, moe_over, model_over = CASES[case]
    cfg = config()
    je, init = jax_engine(name, moe_over, model_over, dict(cfg))
    te = port_engine(name, moe_over, model_over, dict(cfg), init)
    b = batch()
    before = dataclasses.asdict(gm.counts)
    jl, tl = run(je, b, 3), run(te, b, 3)
    np.testing.assert_allclose(tl, jl, rtol=1e-6)
    assert tl[-1] < tl[0]
    assert max_diff(jax.device_get(je.state.params),
                    to_jax_tree(te.master)) <= 1e-5
    # the dropless route ran the grouped products and their backward (the
    # plain versions on the CPU): 3 products x MoE layers x micro-batches
    # x steps, forward and both halves of the backward alike
    moe_layers = sum(1 for m in te.module.modules() if isinstance(m, MoE))
    want = 3 * moe_layers * 2 * 3 if moe_over.get("dropless") else 0
    after = dataclasses.asdict(gm.counts)
    assert [after[k] - before[k] for k in ("plain", "plain_dx",
                                           "plain_dw")] == [want] * 3
    assert after["kernel"] == after["kernel_dx"] == after["kernel_dw"] == 0


def test_eval_batch_matches_the_jax_engine():
    """eval_batch routes at the eval capacity factor (the JAX engine's
    deterministic step) and adds the layers' losses, before and after
    training; train_batch's capacity factor drops other tokens."""
    name, moe_over, model_over = CASES["tiny-mixtral-capacity"]
    cfg = config()
    je, init = jax_engine(name, moe_over, model_over, dict(cfg))
    te = port_engine(name, moe_over, model_over, dict(cfg), init)
    b = batch(seed=1)
    np.testing.assert_allclose(float(te.eval_batch(b)),
                               float(je.eval_batch(b)), rtol=1e-6)
    assert not te.module.training
    np.testing.assert_allclose(run(te, b, 2), run(je, b, 2), rtol=1e-6)
    assert te.module.training
    np.testing.assert_allclose(float(te.eval_batch(b)),
                               float(je.eval_batch(b)), rtol=1e-6)
    assert not te.module.training


def test_bf16_moe_training_matches_the_jax_engine():
    """bf16 parameters and compute with an fp32 master on the dropless
    route (qwen2-moe's shared expert included): losses within 2e-2."""
    name, moe_over, model_over = CASES["tiny-qwen2-moe-dropless"]
    cfg = config(bf16={"enabled": True})
    je, init = jax_engine(name, moe_over, model_over, dict(cfg),
                          dtype=jnp.bfloat16)
    te = port_engine(name, moe_over, model_over, dict(cfg), init,
                     dtype=torch.bfloat16)
    assert all(p.dtype == torch.bfloat16 for p in te.module.parameters())
    b = batch(seed=2)
    np.testing.assert_allclose(run(te, b, 3), run(je, b, 3), rtol=2e-2)


def test_gating_losses_reach_the_router():
    """The router's weight gets gradient from the gating losses alone: with
    every label ignored the cross entropy is 0 and the loss is the layers'
    weighted aux and z losses; ``gate/wg`` gets a gradient, the last
    layer's experts (whose output only the cross entropy reads) get
    none."""
    moe = dataclasses.replace(get_model_config("tiny-mixtral").moe,
                              dropless=True)
    model = build_model("tiny-mixtral", device="cpu", dtype=torch.float32,
                        moe=moe)
    for p in model.parameters():
        p.requires_grad_(True)
    model.train()
    ids = torch.as_tensor(batch(seed=3)["input_ids"]).long()
    loss = lm_loss_fn(model, {"input_ids": ids,
                              "labels": torch.full_like(ids, -100)})
    _, layer_losses = model(ids, return_losses=True)
    assert len(layer_losses) == 2
    assert float(loss.detach()) == pytest.approx(
        float(sum(layer_losses).detach()), rel=1e-6)
    loss.backward()
    for i in range(2):
        layer = getattr(model, f"layer_{i}").moe.moe_layer
        assert float(layer.gate.wg.grad.abs().sum()) > 0
    assert float(layer.experts.w_up.grad.abs().sum()) == 0


def _rsample_losses(seed, policy, steps=2):
    """Losses of tiny-mixtral (dropless) trained with RSample jitter on
    every MoE layer, under the engine ``seed`` and remat ``policy``."""
    moe = dataclasses.replace(get_model_config("tiny-mixtral").moe,
                              dropless=True, dropless_block_m=16)
    model = build_model("tiny-mixtral", device="cpu", dtype=torch.float32,
                        moe=moe)
    for m in model.modules():
        if isinstance(m, MoE):
            m.noisy_gate_policy = "RSample"
    e, *_ = dst.initialize(
        model=model, device="cpu",
        config=config(seed=seed,
                      activation_checkpointing={"policy": policy}))
    return run(e, batch(seed=4), steps)


def test_rsample_jitter_follows_the_engine_seed_and_survives_remat():
    """The engine draws one gating seed a step from its seed and the step
    and hands it to the model, which seeds each MoE layer's jitter outside
    the checkpointed blocks: the same engine seed gives the same losses,
    with remat "full" or a dots policy as without remat (the recompute
    draws the same jitter); another engine seed gives other losses."""
    want = _rsample_losses(0, "none")
    assert _rsample_losses(0, "full") == want
    assert _rsample_losses(0, "dots_saveable") == want
    assert _rsample_losses(1, "none") != want
