"""MFU and goodput accounting.

MFU (model FLOPs utilization, PaLM appendix B): model FLOPs per step — the
training engine counts them from the model's configuration
(``runtime/engine.model_step_flops``) — divided by (step wall time ×
hardware peak FLOPs). Goodput (MegaScale §3)
further discounts steps whose work was THROWN AWAY: optimizer updates the
divergence sentinel skipped and steps rewound to a checkpoint — the
difference between "the chips were busy" and "training advanced".

Pure-host arithmetic; the peak-FLOPs lookup probes the device at call time
only, never at import.
"""
from __future__ import annotations

from ..utils.logging import logger

#: dense bf16 tensor-core peak TFLOP/s per card, by a substring of
#: ``torch.cuda.get_device_name()`` (NVIDIA data sheets; most specific
#: first). A card set below its board's power limit runs slower under load,
#: so MFU against these figures is a lower bound there.
PEAK_TFLOPS_BY_NAME = (
    # H100 SXM5 80GB, 700 W (data sheet: 989.4 dense bf16)
    ("h100 80gb hbm3", 989.0),
    ("h100 sxm", 989.0),
    # H100 NVL, 400 W (data sheet: 835 dense bf16)
    ("h100 nvl", 835.0),
    # H100 PCIe 80GB, 350 W (data sheet: 756 dense bf16)
    ("h100 pcie", 756.0),
    # H200 SXM 141GB, 700 W (data sheet: 989 dense bf16)
    ("h200", 989.0),
    # A100 SXM4 / PCIe 80GB, 400 / 300 W (data sheet: 312 dense bf16)
    ("a100", 312.0),
)


def device_peak_flops() -> float | None:
    """Peak bf16 FLOPs/s of CUDA device 0, or None when unknown (no CUDA:
    MFU is not meaningful on the CPU; a card not in the table)."""
    try:
        import torch

        if not torch.cuda.is_available():
            return None
        name = torch.cuda.get_device_name(0).lower()
    except Exception as e:
        logger.debug(f"peak-flops probe failed ({e!r})")
        return None
    for frag, tflops in PEAK_TFLOPS_BY_NAME:
        if frag in name:
            return tflops * 1e12
    return None


def mfu(flops_per_step: float, step_time_s: float,
        peak_flops: float) -> float:
    """Single-step MFU in [0, ~1]."""
    if step_time_s <= 0 or peak_flops <= 0:
        return 0.0
    return flops_per_step / (step_time_s * peak_flops)


def goodput(flops_per_step: float, useful_steps: int, wall_time_s: float,
            peak_flops: float) -> float:
    """Utilization counting only steps whose work survived."""
    if wall_time_s <= 0 or peak_flops <= 0:
        return 0.0
    return flops_per_step * useful_steps / (wall_time_s * peak_flops)


class MFUTracker:
    """Running MFU/goodput over a training run.

    ``on_step(dt)`` records every executed step; ``useful=False`` marks a
    step whose update was skipped (sentinel non-finite). ``discard_steps(n)``
    retroactively un-counts n previously-useful steps — the rewind case:
    work up to the divergence is recomputed from the checkpoint, so it
    contributed wall time but no progress. By construction
    ``goodput() <= mfu()`` with equality iff nothing was wasted.
    """

    def __init__(self, peak_flops: float | None = None,
                 flops_per_step: float | None = None):
        self.peak_flops = peak_flops
        self.flops_per_step = flops_per_step
        self.total_steps = 0
        self.useful_steps = 0
        self.total_time_s = 0.0
        self.last_step_s = 0.0

    @property
    def configured(self) -> bool:
        return bool(self.peak_flops) and bool(self.flops_per_step)

    def on_step(self, step_time_s: float, useful: bool = True) -> None:
        self.total_steps += 1
        self.useful_steps += 1 if useful else 0
        self.total_time_s += max(float(step_time_s), 0.0)
        self.last_step_s = float(step_time_s)

    def discard_steps(self, n: int) -> None:
        self.useful_steps = max(0, self.useful_steps - max(int(n), 0))

    def mfu(self) -> float | None:
        if not self.configured or not self.total_steps:
            return None
        return goodput(self.flops_per_step, self.total_steps,
                       self.total_time_s, self.peak_flops)

    def goodput(self) -> float | None:
        if not self.configured or not self.total_steps:
            return None
        return goodput(self.flops_per_step, self.useful_steps,
                       self.total_time_s, self.peak_flops)
