"""The port's one-process training engine (``deepspeed_tpu_torch.initialize``
→ ``DeepSpeedEngine``) on the CPU against the JAX engine on one device
(``topology=single_device_topology()``): the same config, the JAX engine's
initial parameters carried across, the same seeded batches; losses and
parameters after several steps agree. Then the port's own contracts: the
forward/backward/step triplet, remat policies, the flash route's launch
counts, and the refusal of every feature a later part ports.

The parity runs use AdamW with ``eps=1e-5``: an element whose gradient is
within summation noise of zero (~1e-9 here, where the two packages' sums
differ in their last bits) takes an Adam step of ``lr * g / (|g| + eps)``,
so with ``eps=1e-8`` one such element among the 10^5 moves ~1e-4 apart in
the two packages while every gradient agrees to 1e-7 of its scale.
"""
import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu as ds
import deepspeed_tpu_torch as dst
from deepspeed_tpu.models import build_model as jax_build_model
from deepspeed_tpu.parallel.topology import single_device_topology
from deepspeed_tpu.models.loss import cross_entropy_lm as jax_cross_entropy
from deepspeed_tpu_torch.inference.weights import to_jax_tree
from deepspeed_tpu_torch.models import build_model
from deepspeed_tpu_torch.models.loss import IGNORE_INDEX, cross_entropy_lm
from deepspeed_tpu_torch.ops import flash_attention as fa
from deepspeed_tpu_torch.runtime import activation_checkpointing as ac


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


def jax_engine(name, cfg, dtype=jnp.float32, **over):
    engine, *_ = ds.initialize(model=jax_build_model(name, dtype=dtype, **over),
                               config=cfg,
                               topology=single_device_topology())
    init = jax.device_get(flax.core.meta.unbox(engine.state.params))
    return engine, jax.tree.map(lambda a: np.asarray(a, np.float32), init)


def port_engine(name, cfg, init, dtype=torch.float32, **over):
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


@pytest.mark.parametrize("name", ["tiny-gpt2", "tiny-llama"])
def test_fp32_matches_the_jax_engine(name):
    """fp32, 4 steps with gas 2: losses within 1e-5 relative, parameters
    within 1e-5 after the last step."""
    cfg = config()
    je, init = jax_engine(name, dict(cfg))
    te = port_engine(name, dict(cfg), init)
    b = batch()
    jl, tl = run(je, b, 4), run(te, b, 4)
    np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert tl[-1] < tl[0]
    assert max_diff(jax.device_get(je.state.params),
                    to_jax_tree(te.master)) <= 1e-5
    assert te.num_parameters() == je.num_parameters()


def test_bf16_matches_the_jax_engine():
    """bf16 parameters and compute with an fp32 master, as the JAX engine
    keeps them: losses within 2e-2."""
    cfg = config(bf16={"enabled": True})
    je, init = jax_engine("tiny-llama", dict(cfg), dtype=jnp.bfloat16)
    te = port_engine("tiny-llama", dict(cfg), init, dtype=torch.bfloat16)
    assert all(p.dtype == torch.bfloat16 for p in te.module.parameters())
    assert all(m.dtype == torch.float32
               for m in jax.tree.leaves(te.master))
    b = batch()
    np.testing.assert_allclose(run(te, b, 3), run(je, b, 3), rtol=2e-2)


def test_clipping_and_schedule_match_the_jax_engine():
    cfg = config(gradient_clipping=0.05,
                 scheduler={"type": "WarmupLR",
                            "params": {"warmup_max_lr": 1e-3,
                                       "warmup_num_steps": 3}})
    je, init = jax_engine("tiny-gpt2", dict(cfg))
    te = port_engine("tiny-gpt2", dict(cfg), init)
    b = batch(seed=1)
    for _ in range(3):
        assert te.get_lr() == pytest.approx(je.get_lr(), rel=1e-6)
        np.testing.assert_allclose(float(te.train_batch(b)),
                                   float(je.train_batch(b)), rtol=1e-5)
    assert max_diff(jax.device_get(je.state.params),
                    to_jax_tree(te.master)) <= 1e-5


def test_fp16_scaler_skips_steps_like_the_jax_engine():
    """fp16 parameters under a loss scale of 2^20: the fp16 gradients
    overflow, the step is skipped and the scale halves after the
    hysteresis, in both engines; the first clean step updates alike."""
    cfg = config(bf16={"enabled": False},
                 fp16={"enabled": True, "initial_scale_power": 20,
                       "hysteresis": 2})
    je, init = jax_engine("tiny-gpt2", dict(cfg))
    te = port_engine("tiny-gpt2", dict(cfg), init)
    assert all(p.dtype == torch.float16 for p in te.module.parameters())
    b = batch(seed=2)
    history = []
    for _ in range(24):
        jl, tl = float(je.train_batch(b)), float(te.train_batch(b))
        history.append((je.skipped_steps, te.skipped_steps,
                        je.get_loss_scale(), te.get_loss_scale()))
        np.testing.assert_allclose(tl, jl, rtol=1e-2)
    for js, ts, jsc, tsc in history:
        assert (js, jsc) == (ts, tsc)
    assert 0 < te.skipped_steps < 24
    assert max_diff(jax.device_get(je.state.master),
                    to_jax_tree(te.master)) <= 1e-3


def test_triplet_equals_train_batch():
    """forward/backward/step over the micro-batches gives train_batch's
    losses and parameters."""
    init = to_jax_tree(build_model("tiny-llama", device="cpu",
                                   dtype=torch.float32))
    a = port_engine("tiny-llama", config(), init)
    t = port_engine("tiny-llama", config(), init)
    b = batch(seed=3)
    for _ in range(2):
        want = float(a.train_batch(b))
        losses = []
        for g in range(2):
            mb = {k: v[2 * g:2 * g + 2] for k, v in b.items()}
            loss = t.forward(mb)
            t.backward(loss)
            losses.append(float(loss.detach()))
            assert t.is_gradient_accumulation_boundary() == (g == 1)
        t.step()
        assert np.mean(losses) == pytest.approx(want, rel=1e-6)
    assert max_diff(to_jax_tree(a.master), to_jax_tree(t.master)) <= 1e-7
    assert t.global_steps == a.global_steps == 2
    # backward(batch) recomputes the forward; zero_grad drops it
    t.backward({k: v[:2] for k, v in b.items()})
    t.zero_grad()
    assert not t.is_gradient_accumulation_boundary()
    t.step()                          # nothing accumulated: a no-op
    assert t.global_steps == 2
    assert float(t.eval_batch(b)) == pytest.approx(
        float(a.eval_batch(b)), rel=1e-6)


@pytest.mark.parametrize("policy", ["full", "dots_saveable"])
def test_remat_keeps_losses_and_reruns_k4(policy):
    """At S = 128 with head dim 64 every attention takes the flash route
    (its plain version on the CPU): counted once per layer and micro-batch,
    twice under remat, where the checkpointed forward runs again. Remat
    changes no loss."""
    over = dict(hidden_size=256)
    init = to_jax_tree(build_model("tiny-llama", device="cpu",
                                   dtype=torch.float32, **over))
    b = batch(S=128, seed=4)
    losses, counts = {}, {}
    for pol in ("none", policy):
        cfg = config(activation_checkpointing={"policy": pol})
        e = port_engine("tiny-llama", cfg, init, **over)
        fa.counts.reset()
        losses[pol] = run(e, b, 2)
        counts[pol] = (fa.counts.plain, fa.counts.plain_bwd, fa.counts.fwd)
        assert e.module.config.remat == (pol != "none")
    layers, micro = 2, 2
    assert counts["none"] == (2 * layers * micro, 2 * layers * micro, 0)
    assert counts[policy] == (2 * 2 * layers * micro, 2 * layers * micro, 0)
    np.testing.assert_allclose(losses[policy], losses["none"], rtol=1e-6)


def test_remat_leaves_the_callers_config():
    """``activation_checkpointing`` turns remat on for the engine's clone of
    the model (the reference clones its module): the caller's model keeps
    its config, shares its parameters with the engine, and its no-grad
    forward gives the engine's eval loss."""
    model = build_model("tiny-llama", device="cpu", dtype=torch.float32)
    cfg = config(activation_checkpointing={"policy": "dots_saveable"})
    engine, *_ = dst.initialize(model=model, config=cfg, device="cpu")
    assert (model.config.remat, model.config.remat_policy) == (
        False, "nothing_saveable")
    assert (engine.module.config.remat,
            engine.module.config.remat_policy) == (True, "dots_saveable")
    assert engine.module is not model
    assert all(a is b for a, b in zip(engine.module.parameters(),
                                      model.parameters()))
    b = batch()
    engine.train_batch(b)
    ids = torch.as_tensor(b["input_ids"][:2]).long()
    with torch.no_grad():
        want = engine.module(ids)
        got = model(ids)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_flash_route_matches_the_jax_engine():
    """S = 128, head dim 64: the port's attention takes the flash route
    while the JAX engine (8 virtual devices) takes its XLA route; losses
    and parameters agree."""
    over = dict(hidden_size=256)
    cfg = config()
    je, init = jax_engine("tiny-llama", dict(cfg), **over)
    te = port_engine("tiny-llama", dict(cfg), init, **over)
    b = batch(S=128, seed=5)
    fa.counts.reset()
    np.testing.assert_allclose(run(te, b, 2), run(je, b, 2), rtol=1e-5)
    assert fa.counts.plain == 2 * 2 * 2
    assert max_diff(jax.device_get(je.state.params),
                    to_jax_tree(te.master)) <= 1e-5


def test_dataloader_matches_the_jax_loader():
    data = np.random.default_rng(6).integers(0, 256, (20, 16))
    cfg = config()
    te = port_engine("tiny-gpt2", dict(cfg), to_jax_tree(
        build_model("tiny-gpt2", device="cpu", dtype=torch.float32)))
    _, _, loader, _ = ds.initialize(
        model=jax_build_model("tiny-gpt2", dtype=jnp.float32),
        config=dict(cfg), topology=single_device_topology(),
        training_data=data)
    mine = te.deepspeed_io(data)
    assert len(mine) == len(loader) == 5
    for x, y in zip(mine, loader):
        np.testing.assert_array_equal(x["input_ids"], y["input_ids"])
    np.testing.assert_array_equal(mine.batch_for_step(7)["input_ids"],
                                  loader.batch_for_step(7)["input_ids"])


DEFERRED = [
    ({"zero_optimization": {"stage": 2}}, "ZeRO stage 2"),
    ({"zero_optimization": {"offload_optimizer": {"device": "cpu"}}},
     "offload"),
    ({"zero_optimization": {"zero_quantized_weights": True}}, "ZeRO\\+\\+"),
    ({"optimizer": {"type": "OneBitAdam", "params": {}}}, "1-bit"),
    ({"data_efficiency": {"enabled": True}}, "curriculum"),
    ({"hybrid_engine": {"enabled": True}}, "hybrid engine"),
    ({"telemetry": {"enabled": True}}, "telemetry"),
    ({"flops_profiler": {"enabled": True}}, "flops profiler"),
    ({"comms_logger": {"enabled": True}}, "comms logger"),
    ({"tensorboard": {"enabled": True}}, "tensorboard"),
    ({"resilience": {"loss_spike_factor": 3.0}}, "resilience"),
    ({"resilience": {"rewind_dir": "/nonexistent"}}, "resilience"),
    ({"mesh": {"fsdp": 2}}, "part B"),
    ({"activation_checkpointing": {"policy": "offload"}}, "item 6"),
    ({"activation_checkpointing": {"cpu_checkpointing": True}}, "item 6"),
]


@pytest.mark.parametrize("over,match", DEFERRED,
                         ids=[m for _, m in DEFERRED])
def test_deferred_features_raise(over, match):
    with pytest.raises(NotImplementedError, match=match):
        dst.initialize(model=build_model("tiny-gpt2", device="cpu"),
                       config=config(**over), device="cpu")


def test_checkpoints_raise_and_moe_trains():
    e, *_ = dst.initialize(model=build_model("tiny-gpt2", device="cpu"),
                           config=config(), device="cpu")
    with pytest.raises(NotImplementedError, match="checkpoints"):
        e.save_checkpoint("/nonexistent")
    with pytest.raises(NotImplementedError, match="checkpoints"):
        e.load_checkpoint("/nonexistent")
    moe, *_ = dst.initialize(model=build_model("tiny-mixtral", device="cpu"),
                             config=config(), device="cpu")
    assert np.isfinite(float(moe.train_batch(batch())))


def test_engine_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this check is for machines without a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA"):
        dst.initialize(model=build_model("tiny-gpt2", device="cpu"),
                       config=config())


@pytest.mark.parametrize("chunk", [0, 7])
@pytest.mark.parametrize("z", [0.0, 1e-3])
def test_cross_entropy_matches_jax(chunk, z, monkeypatch):
    """The LM loss against the JAX package's, with ignored labels and the
    z-loss; the streamed form (``DS_TPU_CE_CHUNK``, 7-row pieces and a
    ragged tail) gives the dense form's value and gradient."""
    rng = np.random.default_rng(8)
    logits = rng.standard_normal((2, 9, 50)).astype(np.float32) * 3
    labels = rng.integers(0, 50, (2, 9))
    labels[0, :3] = IGNORE_INDEX
    monkeypatch.setenv("DS_TPU_CE_CHUNK", str(chunk))
    want = float(jax_cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                   z_loss_weight=z))
    lg = torch.tensor(logits, requires_grad=True)
    got = cross_entropy_lm(lg, torch.tensor(labels), z_loss_weight=z)
    assert float(got.detach()) == pytest.approx(want, rel=1e-6)
    got.backward()
    monkeypatch.setenv("DS_TPU_CE_CHUNK", "0")
    ref = torch.tensor(logits, requires_grad=True)
    cross_entropy_lm(ref, torch.tensor(labels), z_loss_weight=z).backward()
    np.testing.assert_allclose(lg.grad.numpy(), ref.grad.numpy(), atol=1e-7)


def test_megatron_style_checkpoint_surface():
    """``configure`` + ``checkpoint(fn, *args)`` recompute ``fn`` in the
    backward with the same gradients; the offload policy raises."""
    w = torch.randn(8, 8, dtype=torch.float64, requires_grad=True)
    x = torch.randn(4, 8, dtype=torch.float64)
    fn = lambda t: torch.tanh(t @ w) @ w
    grads = []
    for policy in ("none", "dots_saveable"):
        ac.configure({"policy": policy})
        ac.checkpoint(fn, x).square().sum().backward()
        grads.append(w.grad.clone())
        w.grad = None
    torch.testing.assert_close(grads[0], grads[1])
    ac.configure(policy="offload")
    with pytest.raises(NotImplementedError, match="item 6"):
        ac.checkpoint(fn, x)
    ac.configure({"policy": "none"})
