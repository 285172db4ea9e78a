"""Optimizers over fp32 state.

Counterpart of ``deepspeed_tpu/ops/optimizers.py``: FusedAdam (Adam and
AdamW, with the JAX package's L2-mode approximation), Lion, FusedLamb,
Adagrad and SGD, and ``build_optimizer`` resolving the DeepSpeed optimizer
section by name. Each update is the JAX update written as plain tensor
arithmetic, in the same order of operations over fp32 moments (not
``torch.optim``), so both packages give the same parameters to the last
rounding.

``init(params) -> OptState`` takes a list of fp32 master tensors.
``update(grads, state, params, lr)`` takes lists of the same length and,
where the JAX update returns new trees, updates the master tensors and the
moments in place (one fp32 copy of each instead of two) and returns the
state with its step advanced.

The lists may also be ZeRO partitions (``runtime/zero``). An optimizer
whose update is ``elementwise`` (Adam / AdamW, Lion, Adagrad, SGD) takes a
rank's flat partition as one view per segment: each element sees the same
operations in the same order as in its own tensor, so the bits do not
change. LAMB's trust ratio is per tensor: it takes the partition as one
view per piece of a tensor, and ``sq_norm_reduce`` sums each piece's
squared weight and update norms over the pieces of its tensor on every
rank before ``w_norm / u_norm``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, NamedTuple

import torch

Tensors = list[torch.Tensor]


class OptState(NamedTuple):
    step: int                 # applied updates
    mu: Tensors | None        # first moment / momentum
    nu: Tensors | None        # second moment


def _zeros_like(params: Tensors) -> Tensors:
    return [torch.zeros_like(p, dtype=torch.float32) for p in params]


def _f32(x: float) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


@dataclass(frozen=True)
class Optimizer:
    lr: float = 1e-3
    weight_decay: float = 0.0
    #: True when each element's update reads only that element's state
    elementwise = True

    def init(self, params: Tensors) -> OptState:
        raise NotImplementedError

    def update(self, grads: Tensors, state: OptState, params: Tensors,
               lr: float | None = None) -> OptState:
        raise NotImplementedError


@dataclass(frozen=True)
class FusedAdam(Optimizer):
    """Adam/AdamW (reference csrc/adam/multi_tensor_adam.cu:129).

    ``adamw_mode=True`` decouples weight decay (AdamW). With
    ``adamw_mode=False`` the decay is folded into the first moment at the
    update only (``m + wd * p * (1 - b1)``), the JAX package's
    approximation of L2 mode, not into the moment recurrences."""
    betas: tuple[float, float] = (0.9, 0.999)
    eps: float = 1e-8
    adamw_mode: bool = True
    bias_correction: bool = True

    def init(self, params):
        return OptState(step=0, mu=_zeros_like(params), nu=_zeros_like(params))

    @torch.no_grad()
    def update(self, grads, state, params, lr=None):
        lr = self.lr if lr is None else lr
        b1, b2 = self.betas
        step = state.step + 1
        stepf = _f32(step)
        bc1 = 1.0 - _f32(b1) ** stepf if self.bias_correction else 1.0
        bc2 = 1.0 - _f32(b2) ** stepf if self.bias_correction else 1.0
        for p, g, m, v in zip(params, grads, state.mu, state.nu):
            g = g.float()
            bc1_, bc2_ = (bc1.to(p.device), bc2.to(p.device)) \
                if self.bias_correction else (bc1, bc2)
            m.copy_(b1 * m + (1.0 - b1) * g)
            v.copy_(b2 * v + (1.0 - b2) * g * g)
            m_upd = m
            if not self.adamw_mode and self.weight_decay:
                m_upd = m + self.weight_decay * p * (1.0 - b1)
            upd = (m_upd / bc1_) / (torch.sqrt(v / bc2_) + self.eps)
            if self.adamw_mode and self.weight_decay:
                upd = upd + self.weight_decay * p
            p.copy_(p - lr * upd)
        return OptState(step=step, mu=state.mu, nu=state.nu)


@dataclass(frozen=True)
class Lion(Optimizer):
    """Lion (reference csrc/lion/): sign of interpolated momentum."""
    betas: tuple[float, float] = (0.9, 0.99)

    def init(self, params):
        return OptState(step=0, mu=_zeros_like(params), nu=None)

    @torch.no_grad()
    def update(self, grads, state, params, lr=None):
        lr = self.lr if lr is None else lr
        b1, b2 = self.betas
        for p, g, m in zip(params, grads, state.mu):
            g = g.float()
            upd = torch.sign(b1 * m + (1.0 - b1) * g)
            if self.weight_decay:
                upd = upd + self.weight_decay * p
            p.copy_(p - lr * upd)
            m.copy_(b2 * m + (1.0 - b2) * g)
        return OptState(step=state.step + 1, mu=state.mu, nu=None)


@dataclass(frozen=True)
class FusedLamb(Optimizer):
    """LAMB (reference csrc/lamb/fused_lamb_cuda_kernel.cu): Adam direction
    scaled by a per-tensor trust ratio."""
    betas: tuple[float, float] = (0.9, 0.999)
    eps: float = 1e-6
    max_trust_ratio: float = 10.0

    def init(self, params):
        return OptState(step=0, mu=_zeros_like(params), nu=_zeros_like(params))

    elementwise = False

    @torch.no_grad()
    def update(self, grads, state, params, lr=None, sq_norm_reduce=None):
        """``sq_norm_reduce(w_sq, u_sq)``, when given, maps the local
        squared norms of every tensor in ``params`` (pieces of ZeRO
        partitions) to those of the whole tensors they belong to."""
        lr = self.lr if lr is None else lr
        b1, b2 = self.betas
        step = state.step + 1
        stepf = _f32(step)
        bc1, bc2 = 1.0 - _f32(b1) ** stepf, 1.0 - _f32(b2) ** stepf
        upds = []
        for p, g, m, v in zip(params, grads, state.mu, state.nu):
            g = g.float()
            m.copy_(b1 * m + (1.0 - b1) * g)
            v.copy_(b2 * v + (1.0 - b2) * torch.square(g))
            upd = (m / bc1.to(p.device)) / (torch.sqrt(v / bc2.to(p.device))
                                            + self.eps)
            if self.weight_decay:
                upd = upd + self.weight_decay * p
            upds.append(upd)
        if sq_norm_reduce is None:
            w_norms = [torch.linalg.norm(p.reshape(-1)) for p in params]
            u_norms = [torch.linalg.norm(u.reshape(-1)) for u in upds]
        elif params:
            w_sq, u_sq = sq_norm_reduce(
                torch.stack([torch.sum(torch.square(p)) for p in params]),
                torch.stack([torch.sum(torch.square(u)) for u in upds]))
            w_norms, u_norms = torch.sqrt(w_sq), torch.sqrt(u_sq)
        for p, upd, w_norm, u_norm in zip(params, upds, w_norms, u_norms):
            trust = torch.where((w_norm > 0) & (u_norm > 0),
                                torch.clamp(w_norm / u_norm, 0.0,
                                            self.max_trust_ratio),
                                torch.ones_like(w_norm))
            p.copy_(p - lr * trust * upd)
        return OptState(step=step, mu=state.mu, nu=state.nu)


@dataclass(frozen=True)
class Adagrad(Optimizer):
    """Adagrad (reference csrc/adagrad/cpu_adagrad.cpp)."""
    eps: float = 1e-10

    def init(self, params):
        return OptState(step=0, mu=None, nu=_zeros_like(params))

    def _g_eff(self, p, g):
        g = g.float()
        return g + self.weight_decay * p if self.weight_decay else g

    @torch.no_grad()
    def update(self, grads, state, params, lr=None):
        lr = self.lr if lr is None else lr
        for p, g, v in zip(params, grads, state.nu):
            ge = self._g_eff(p, g)
            v.copy_(v + torch.square(ge))
            p.copy_(p - lr * ge / (torch.sqrt(v) + self.eps))
        return OptState(step=state.step + 1, mu=None, nu=state.nu)


@dataclass(frozen=True)
class SGD(Optimizer):
    momentum: float = 0.0
    nesterov: bool = False

    def init(self, params):
        mu = _zeros_like(params) if self.momentum else None
        return OptState(step=0, mu=mu, nu=None)

    @torch.no_grad()
    def update(self, grads, state, params, lr=None):
        lr = self.lr if lr is None else lr
        mus = state.mu if state.mu is not None else [None] * len(params)
        for p, g, m in zip(params, grads, mus):
            g = g.float()
            ge = g + self.weight_decay * p if self.weight_decay else g
            if m is not None:
                m.copy_(self.momentum * m + ge)
                direction = ge + self.momentum * m if self.nesterov else m
            else:
                direction = ge
            p.copy_(p - lr * direction)
        return OptState(step=state.step + 1, mu=state.mu, nu=None)


# --------------------------------------------------------------------------
# Registry resolving DeepSpeed optimizer-section names
# (reference runtime/engine.py:1322 _configure_basic_optimizer)
# --------------------------------------------------------------------------

def build_optimizer(type_name: str, params: dict[str, Any]) -> Optimizer:
    name = type_name.lower()
    p = dict(params)
    p.pop("torch_adam", None)
    adam_w_mode = p.pop("adam_w_mode", None)
    betas = tuple(p.pop("betas")) if "betas" in p else None
    lr = p.pop("lr", 1e-3)
    wd = p.pop("weight_decay", 0.0)
    eps = p.pop("eps", None)
    if name.replace("_", "") in ("onebitadam", "onebitlamb", "zerooneadam"):
        raise NotImplementedError(
            f"optimizer '{type_name}': the 1-bit family (compressed momentum "
            f"across data-parallel processes) is ported with ROADMAP queue "
            f"1, item 6 (runtime/onebit.py)")

    # 1-bit comm-only knobs may linger in a config whose type was switched
    # to a dense optimizer; they don't change dense behavior — drop them
    for k in ("freeze_step", "cuda_aware", "comm_backend_name", "var_freeze_step",
              "var_update_scaler", "local_step_scaler", "local_step_clipper"):
        p.pop(k, None)

    if name in ("adam", "adamw", "fusedadam"):
        mode = adam_w_mode if adam_w_mode is not None else (name != "adam")
        kw: dict[str, Any] = dict(lr=lr, weight_decay=wd, adamw_mode=bool(mode))
        if betas:
            kw["betas"] = betas
        if eps is not None:
            kw["eps"] = eps
        kw.update(p)
        return FusedAdam(**kw)
    if name == "lion":
        kw = dict(lr=lr, weight_decay=wd)
        if betas:
            kw["betas"] = betas
        kw.update(p)
        return Lion(**kw)
    if name in ("lamb", "fusedlamb"):
        kw = dict(lr=lr, weight_decay=wd)
        if betas:
            kw["betas"] = betas
        if eps is not None:
            kw["eps"] = eps
        kw.update(p)
        return FusedLamb(**kw)
    if name == "adagrad":
        kw = dict(lr=lr, weight_decay=wd)
        if eps is not None:
            kw["eps"] = eps
        kw.update(p)
        return Adagrad(**kw)
    if name == "sgd":
        return SGD(lr=lr, weight_decay=wd, **p)
    raise ValueError(f"unknown optimizer type: {type_name}")
