"""Dynamic loss scaling for fp16 training.

Counterpart of ``deepspeed_tpu/runtime/fp16.py`` (the reference's
``DynamicLossScaler``): the same state (scale, clean-step count, remaining
hysteresis) and the same decisions — skip the step on overflow, shrink by
half after ``hysteresis`` overflows, grow by two every
``loss_scale_window`` clean steps. The JAX package keeps them on the device
inside its compiled step; the eager engine reads the overflow flag back once
a step anyway (to skip the update), so the scaler is host state.

bf16 and fp32 training need none of this; the engine wires it only when
``fp16.enabled`` is set.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import FP16Config


class ScalerState(NamedTuple):
    scale: float        # fp32 value
    good_steps: int     # consecutive non-overflow steps
    hysteresis: int     # remaining tolerated overflows before a shrink


def _f32(x: float) -> float:
    return float(torch.tensor(x, dtype=torch.float32))


def init_scaler(cfg: FP16Config) -> ScalerState:
    scale = cfg.loss_scale if cfg.loss_scale else float(2 ** cfg.initial_scale_power)
    return ScalerState(scale=_f32(scale), good_steps=0,
                       hysteresis=int(cfg.hysteresis))


def grads_finite(grads) -> torch.Tensor:
    """A 0-d bool tensor: every element of every gradient is finite."""
    finite = None
    for g in grads:
        ok = torch.isfinite(g).all()
        finite = ok if finite is None else finite & ok
    return torch.tensor(True) if finite is None else finite


def update_scaler(state: ScalerState, finite: bool,
                  cfg: FP16Config) -> ScalerState:
    """Reference loss_scaler.py ``update_scale``: shrink x0.5 on overflow
    (after hysteresis), grow x2 every ``loss_scale_window`` clean steps."""
    if cfg.loss_scale:  # static loss scale
        return state
    if not finite:
        hyst = state.hysteresis - 1
        if hyst <= 0:
            return ScalerState(scale=_f32(max(state.scale / 2.0,
                                              cfg.min_loss_scale)),
                               good_steps=0, hysteresis=int(cfg.hysteresis))
        return ScalerState(scale=state.scale, good_steps=0, hysteresis=hyst)
    grow = (state.good_steps + 1) >= cfg.loss_scale_window
    return ScalerState(scale=_f32(state.scale * 2.0) if grow else state.scale,
                       good_steps=0 if grow else state.good_steps + 1,
                       hysteresis=int(cfg.hysteresis))
