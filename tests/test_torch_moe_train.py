"""The port's MoE layer in training (``deepspeed_tpu_torch.moe.layer``:
``moe_forward`` and the ``MoE`` module) against the JAX
package's flax ``MoE`` applied with ``deterministic=False`` (training) and
``True`` (eval), from the same parameters and input (numpy, seeded):

- training routes the capacity route at ``capacity_factor``, eval at
  ``eval_capacity_factor``; tokens past the capacity are dropped alike;
- the layer's loss, ``aux_loss * aux_loss_weight + z_loss *
  z_loss_weight``, is what the flax layer sows;
- the gradients of ``gate/wg``, the experts and x, of ``sum(y * g) +
  loss`` (g a fixed seeded cotangent), agree; the dropless route's
  grouped products run their plain backward here, Pallas in interpret mode
  on the JAX side;
- RSample's noise: both packages get the same standard-normal numbers (the
  JAX draw is replaced by them for the call);
- under remat ("full" and both dots policies) the module's losses and
  gradients are those without remat, with the RSample jitter drawn in the
  forward and drawn again, identically, in the recompute.

Tolerances: outputs and losses 1e-5 of the largest |JAX| value, gradients
1e-5 of the largest |JAX| gradient of each leaf (fp32 both sides, sums in
other orders); remat against no remat exactly (the same ops on the same
values)."""
import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.moe import layer as jlayer
from deepspeed_tpu_torch.inference.weights import flatten_tree, params_from_jax
from deepspeed_tpu_torch.moe.layer import MoE, gating_noise, moe_forward
from deepspeed_tpu_torch.ops.remat import checkpoint_fn

E = 32
#: layer options; capacity_factor / eval_capacity_factor differ so the two
#: modes route differently
LAYERS = {
    "capacity": dict(num_experts=4, ffn_size=48, k=2, capacity_factor=0.5,
                     eval_capacity_factor=2.0, min_capacity=2),
    "capacity-rsample": dict(num_experts=4, ffn_size=48, k=2,
                             capacity_factor=0.75, eval_capacity_factor=1.5,
                             min_capacity=2, noisy_gate_policy="RSample"),
    "capacity-top1-gelu": dict(num_experts=6, ffn_size=40, k=1,
                               capacity_factor=1.0, activation="gelu",
                               normalize_gates=False),
    "dropless-rsample": dict(num_experts=6, ffn_size=40, k=2, dropless=True,
                             dropless_block_m=8,
                             noisy_gate_policy="RSample"),
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _pair(kw, seed=0):
    """(flax MoE, its params, the port's MoE with the same weights)."""
    jmod = jlayer.MoE(hidden_size=E, **kw)
    params = jmod.init(jax.random.PRNGKey(seed),
                       jnp.zeros((1, 4, E), jnp.float32))["params"]
    host = jax.device_get(flax.core.meta.unbox(params))
    tmod = MoE(hidden_size=E, device="cpu", **kw)
    tmod.load_state_dict(flatten_tree(params_from_jax(host, device="cpu")),
                         strict=True)
    return jmod, flax.core.meta.unbox(params), tmod


def _data(kw, seed=5):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((3, 12, E)).astype(np.float32)
    g = rng.standard_normal((3, 12, E)).astype(np.float32)
    noise = rng.standard_normal((3, 12, kw["num_experts"])).astype(
        np.float32)
    return x, g, noise


def _jax_run(jmod, params, x, g, noise, deterministic, monkeypatch):
    """(y, loss, grads of params, grad of x) of the flax layer; its RSample
    draw replaced by ``noise``."""
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape, *a, **k: jnp.asarray(noise))

    def f(p, xx):
        y, st = jmod.apply({"params": p}, xx, deterministic,
                           mutable=["losses"],
                           rngs={"gating": jax.random.PRNGKey(7)})
        loss = sum(jnp.sum(v) for v in jax.tree.leaves(st["losses"]))
        return jnp.sum(y * g) + loss, (y, loss)

    (_, (y, loss)), (gp, gx) = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(params, jnp.asarray(x))
    monkeypatch.undo()
    return (np.asarray(y), float(loss), jax.tree.map(np.asarray, gp),
            np.asarray(gx))


def _port_params(tmod):
    for p in tmod.parameters():
        p.requires_grad_(True)
        p.grad = None
    return {"gate": {"wg": tmod.gate.wg},
            "experts": dict(tmod.experts.named_parameters())}


def _close(got, ref):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    assert np.abs(got - ref).max() <= 1e-5 * max(np.abs(ref).max(), 1e-30)


@pytest.mark.parametrize("training", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("name", sorted(LAYERS))
def test_layer_matches_flax_in_both_modes(name, training, monkeypatch):
    kw = LAYERS[name]
    jmod, params, tmod = _pair(kw)
    x, g, noise = _data(kw)
    ref_y, ref_loss, ref_gp, ref_gx = _jax_run(jmod, params, x, g, noise,
                                               not training, monkeypatch)
    p = _port_params(tmod)
    xt = torch.from_numpy(x).requires_grad_()
    jitter = (torch.from_numpy(noise)
              if training and kw.get("noisy_gate_policy") else None)
    y, loss = moe_forward(xt, p, training=training, noise=jitter,
                                    **tmod.options())
    _close(y, ref_y)
    assert float(loss.detach()) == pytest.approx(ref_loss, rel=1e-5)
    ((y * torch.from_numpy(g)).sum() + loss).backward()
    _close(xt.grad, ref_gx)
    _close(tmod.gate.wg.grad, ref_gp["gate"]["wg"])
    for leaf, ref in ref_gp["experts"].items():
        _close(getattr(tmod.experts, leaf).grad, ref)
    assert float(tmod.gate.wg.grad.abs().sum()) > 0
    if name == "capacity":
        # train mode drops tokens past capacity_factor 0.5 (zero rows) that
        # eval mode's 2.0 keeps
        dropped = np.all(ref_y == 0.0, axis=-1)
        assert dropped.any() == training
        assert np.all(y.detach().numpy()[dropped] == 0.0)


def test_module_routes_by_its_training_flag():
    """``MoE`` is built in eval mode (flax's default ``deterministic=True``);
    ``train()`` switches it to the training routing and the RSample
    jitter, drawn by :func:`gating_noise` from the given seed."""
    kw = LAYERS["capacity-rsample"]
    _, _, tmod = _pair(kw)
    x = torch.from_numpy(_data(kw)[0])
    assert not tmod.training
    p = _port_params(tmod)
    with torch.no_grad():
        y_eval, _ = tmod(x, noise_seed=3)
        want, _ = moe_forward(x, p, training=False,
                                        **tmod.options())
        assert torch.equal(y_eval, want)
        tmod.train()
        y_train, loss = tmod(x, noise_seed=3)
        noise = gating_noise((3, 12, 4), x.device, 3)
        want, want_loss = moe_forward(x, p, training=True,
                                                noise=noise,
                                                **tmod.options())
    assert torch.equal(y_train, want) and torch.equal(loss, want_loss)
    assert not torch.equal(y_train, y_eval)
    with pytest.raises(ValueError, match="noisy_gate_policy"):
        MoE(hidden_size=E, device="cpu", noisy_gate_policy="Jitter")


def _module_run(tmod, x, g, policy, seed, noise_seed):
    """(loss, y, grads) of the module in train mode, under ``policy``
    (None: no remat); the default generator seeded first."""
    _port_params(tmod)
    xt = x.clone().requires_grad_()
    torch.manual_seed(seed)
    fn = tmod if policy is None else checkpoint_fn(tmod, policy)
    y, loss = fn(xt, noise_seed)
    ((y * g).sum() + loss).backward()
    grads = [xt.grad] + [p.grad for p in tmod.parameters()]
    return loss.detach(), y.detach(), grads


@pytest.mark.parametrize("noise_seed", [11, None], ids=["seeded", "default"])
@pytest.mark.parametrize("policy", ["full", "dots_saveable",
                                    "dots_with_no_batch_dims_saveable"])
@pytest.mark.parametrize("name", ["capacity-rsample", "dropless-rsample"])
def test_remat_keeps_losses_grads_and_the_noise(name, policy, noise_seed):
    """The rematerialized forward draws the same RSample jitter as the
    first one (a generator seeded from the given seed, or from the default
    generator, whose state the checkpoint restores), so losses and
    gradients are those of the run without remat."""
    kw = LAYERS[name]
    _, _, tmod = _pair(kw)
    tmod.train()
    x, g, _ = (torch.from_numpy(a) for a in _data(kw))
    want = _module_run(tmod, x, g, None, 0, noise_seed)
    got = _module_run(tmod, x, g, policy, 0, noise_seed)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    for a, b in zip(got[2], want[2]):
        assert torch.equal(a, b)
    # the jitter matters: another draw gives another loss
    other = _module_run(tmod, x, g, None, 1,
                        None if noise_seed is None else noise_seed + 1)
    assert not torch.equal(other[0], want[0])
