"""Learning-rate schedules.

Counterpart of ``deepspeed_tpu/runtime/lr_schedules.py`` (the reference's
WarmupLR, WarmupDecayLR, WarmupCosineLR, OneCycle, LRRangeTest, and a
constant rate). A schedule is a function of the optimizer step (an int or a
0-d tensor) returning the rate as a Python float. The arithmetic runs on
fp32 scalars, as the JAX schedules run on traced fp32 arrays, so both
packages give the same rate to the last rounding; ``build_scheduler``
resolves the DeepSpeed ``scheduler`` config section by name.
"""
from __future__ import annotations

import math
from typing import Any, Callable

import torch

Schedule = Callable[[Any], float]  # step -> lr
_F32 = torch.float32


def _step(step) -> torch.Tensor:
    return torch.as_tensor(step).to(_F32)


def constant_lr(lr: float) -> Schedule:
    return lambda step: float(torch.tensor(lr, dtype=_F32))


def warmup_lr(warmup_min_lr: float = 0.0, warmup_max_lr: float = 1e-3,
              warmup_num_steps: int = 1000, warmup_type: str = "log") -> Schedule:
    """Reference ``WarmupLR`` (lr_schedules.py:736): warm up then hold."""
    warmup_num_steps = max(warmup_num_steps, 1)

    def frac_of(step) -> torch.Tensor:
        s = torch.clamp(_step(step) + 1.0, max=float(warmup_num_steps))
        if warmup_type == "log":
            if warmup_num_steps > 1:
                return torch.log(s) / math.log(warmup_num_steps)
            return torch.tensor(1.0, dtype=_F32)
        return s / warmup_num_steps

    def fn(step):
        frac = torch.clamp(frac_of(step), max=1.0)
        return float(warmup_min_lr + (warmup_max_lr - warmup_min_lr) * frac)

    return fn


def warmup_decay_lr(total_num_steps: int, warmup_min_lr: float = 0.0,
                    warmup_max_lr: float = 1e-3, warmup_num_steps: int = 1000,
                    warmup_type: str = "log") -> Schedule:
    """Reference ``WarmupDecayLR`` (lr_schedules.py:816): warmup then linear
    decay, flooring at ``warmup_min_lr`` at ``total_num_steps``."""
    warm = warmup_lr(warmup_min_lr, warmup_max_lr, warmup_num_steps, warmup_type)

    def fn(step):
        stepf = _step(step)
        if stepf < warmup_num_steps:
            return warm(step)
        decay = torch.clamp((total_num_steps - stepf) /
                            max(total_num_steps - warmup_num_steps, 1), 0.0, 1.0)
        return float(warmup_min_lr + (warmup_max_lr - warmup_min_lr) * decay)

    return fn


def warmup_cosine_lr(total_num_steps: int, warmup_min_ratio: float = 0.0,
                     warmup_num_steps: int = 1000, cos_min_ratio: float = 0.0001,
                     warmup_type: str = "linear", lr: float = 1e-3) -> Schedule:
    """Reference ``WarmupCosineLR`` (lr_schedules.py:856)."""

    def fn(step):
        stepf = _step(step)
        if stepf < warmup_num_steps:
            warm_frac = torch.clamp(stepf / max(warmup_num_steps, 1), 0.0, 1.0)
            ratio = warmup_min_ratio + (1.0 - warmup_min_ratio) * warm_frac
        else:
            progress = torch.clamp((stepf - warmup_num_steps) /
                                   max(total_num_steps - warmup_num_steps, 1),
                                   0.0, 1.0)
            ratio = cos_min_ratio + (1.0 - cos_min_ratio) * 0.5 * (
                1.0 + torch.cos(math.pi * progress))
        return float(lr * ratio)

    return fn


def one_cycle(cycle_min_lr: float, cycle_max_lr: float, cycle_first_step_size: int = 2000,
              cycle_second_step_size: int | None = None, decay_step_size: int = 0,
              decay_lr_rate: float = 0.0, **_ignored) -> Schedule:
    """Reference ``OneCycle`` (lr_schedules.py:433), LR triangle + optional
    decay. Momentum cycling is not modeled (the JAX package's optimizer
    betas are static, and the port's follow them)."""
    second = cycle_second_step_size if cycle_second_step_size is not None else cycle_first_step_size
    cycle_len = cycle_first_step_size + second

    def fn(step):
        stepf = _step(step)
        if stepf < cycle_len:
            if stepf < cycle_first_step_size:
                frac = torch.clamp(stepf / cycle_first_step_size, 0.0, 1.0)
            else:
                frac = 1.0 - torch.clamp((stepf - cycle_first_step_size) /
                                         max(second, 1), 0.0, 1.0)
            return float(cycle_min_lr + (cycle_max_lr - cycle_min_lr) * frac)
        if not decay_step_size:
            return float(torch.tensor(cycle_min_lr, dtype=_F32))
        post = stepf - cycle_len
        return float(cycle_min_lr / (1.0 + decay_lr_rate * torch.clamp(post, min=0.0)
                                  / max(decay_step_size, 1)))

    return fn


def lr_range_test(lr_range_test_min_lr: float = 1e-3, lr_range_test_step_size: int = 2000,
                  lr_range_test_step_rate: float = 1.0,
                  lr_range_test_staircase: bool = False) -> Schedule:
    """Reference ``LRRangeTest`` (lr_schedules.py:335)."""

    def fn(step):
        stepf = _step(step)
        interval = (torch.floor(stepf / lr_range_test_step_size)
                    if lr_range_test_staircase
                    else stepf / lr_range_test_step_size)
        return float(lr_range_test_min_lr * (1.0 + interval * lr_range_test_step_rate))

    return fn


SCHEDULES = {
    "warmuplr": warmup_lr,
    "warmupdecaylr": warmup_decay_lr,
    "warmupcosinelr": warmup_cosine_lr,
    "onecycle": one_cycle,
    "lrrangetest": lr_range_test,
}


def build_scheduler(type_name: str, params: dict[str, Any],
                    base_lr: float | None = None) -> Schedule:
    """Resolve the DeepSpeed ``scheduler`` section (reference
    runtime/engine.py:954 _configure_lr_scheduler)."""
    name = type_name.lower()
    if name not in SCHEDULES:
        raise ValueError(f"unknown scheduler type: {type_name}; known: {sorted(SCHEDULES)}")
    params = dict(params)
    if name == "warmupcosinelr" and base_lr is not None and "lr" not in params:
        params["lr"] = base_lr
    return SCHEDULES[name](**params)
