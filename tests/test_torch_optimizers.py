"""The port's optimizers (``deepspeed_tpu_torch.ops.optimizers``) against
the JAX package's: the same seeded parameters and gradients (numpy), several
updates, the same fp32 parameters and moments. Each update is the JAX
update's arithmetic in the same order, so the tolerance is a few fp32 ulps
(pow, sqrt and norms may round apart)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops import optimizers as jopt
from deepspeed_tpu_torch.ops import optimizers as topt

SHAPES = ((7, 5), (33,), (4, 3, 2))

CASES = [
    ("AdamW", {"lr": 1e-2, "weight_decay": 0.1}),
    ("AdamW", {"lr": 1e-2}),
    ("Adam", {"lr": 1e-2, "weight_decay": 0.1}),
    ("Adam", {"lr": 1e-3, "betas": [0.8, 0.99], "eps": 1e-6}),
    ("FusedAdam", {"lr": 1e-2, "adam_w_mode": False, "weight_decay": 0.05,
                   "bias_correction": False}),
    ("Lion", {"lr": 1e-3, "weight_decay": 0.1}),
    ("Lion", {"lr": 1e-3}),
    ("Lamb", {"lr": 1e-2, "weight_decay": 0.01}),
    ("Lamb", {"lr": 1e-2, "max_trust_ratio": 0.5}),
    ("Adagrad", {"lr": 1e-1, "weight_decay": 0.1}),
    ("Adagrad", {"lr": 1e-1}),
    ("SGD", {"lr": 1e-1}),
    ("SGD", {"lr": 1e-1, "momentum": 0.9, "weight_decay": 0.01}),
    ("SGD", {"lr": 1e-1, "momentum": 0.9, "nesterov": True}),
]


def _arrays(seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in SHAPES]


@pytest.mark.parametrize("name,params", CASES,
                         ids=[f"{n}-{i}" for i, (n, _) in enumerate(CASES)])
def test_updates_match_the_jax_optimizer(name, params):
    jo = jopt.build_optimizer(name, dict(params))
    to = topt.build_optimizer(name, dict(params))
    assert type(jo).__name__ == type(to).__name__
    assert dataclasses.asdict(jo) == dataclasses.asdict(to)

    p0 = _arrays(0)
    jp = {str(i): jnp.asarray(a) for i, a in enumerate(p0)}
    tp = [torch.tensor(a) for a in p0]
    js, ts = jo.init(jp), to.init(tp)
    for step in range(4):
        g = _arrays(step + 1)
        if step == 2:
            g = [a * 1e-3 for a in g]         # small grads: eps matters
        lr = params["lr"] * (0.5 if step == 3 else 1.0)
        jp, js = jo.update({str(i): jnp.asarray(a) for i, a in enumerate(g)},
                           js, jp, lr=jnp.float32(lr))
        ts = to.update([torch.tensor(a) for a in g], ts, tp, lr=lr)
    assert ts.step == int(js.step)
    for i, t in enumerate(tp):
        np.testing.assert_allclose(t.numpy(), np.asarray(jp[str(i)]),
                                   rtol=2e-6, atol=2e-7)
    for jm, tm in ((js.mu, ts.mu), (js.nu, ts.nu)):
        assert (jm is None) == (tm is None)
        if tm is not None:
            for i, t in enumerate(tm):
                np.testing.assert_allclose(t.numpy(), np.asarray(jm[str(i)]),
                                           rtol=2e-6, atol=1e-9)


def test_build_optimizer_refuses_what_it_does_not_port():
    with pytest.raises(NotImplementedError, match="1-bit"):
        topt.build_optimizer("OneBitAdam", {"lr": 1e-3})
    with pytest.raises(ValueError, match="unknown optimizer"):
        topt.build_optimizer("RMSprop", {})
    # 1-bit communication knobs left in a dense optimizer's section drop out
    o = topt.build_optimizer("Adam", {"lr": 1e-3, "freeze_step": 10,
                                      "torch_adam": True})
    assert isinstance(o, topt.FusedAdam) and not o.adamw_mode
