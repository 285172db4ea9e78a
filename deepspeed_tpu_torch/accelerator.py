"""Device selection and facts about the card.

Counterpart of ``deepspeed_tpu/accelerator.py``. The port runs on one CUDA
device unless the caller asks for the CPU: :func:`get_device` with no
argument returns the current CUDA device and raises where there is none,
so nothing quietly lands on the host. ``device="cpu"`` is the explicit
request the CPU tests make.
"""
from __future__ import annotations

import os
import subprocess

import torch

#: the compute capability the hand-written kernels are compiled for
#: (``sm_90a``: H100 / H200)
KERNEL_CAPABILITY = (9, 0)


def get_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: ``device`` when given, else
    ``cuda:LOCAL_RANK`` under a process group (one device per process, as
    torchrun starts them), else the current CUDA device. Raises
    RuntimeError when CUDA is asked for (or defaulted to) and absent."""
    if device is not None:
        dev = torch.device(device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"device {device!r} requested but CUDA is not "
                               f"available")
        if dev.type not in ("cuda", "cpu"):
            raise ValueError(f"unsupported device {device!r}")
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the GPU by default; pass "
            "device='cpu' to run the plain versions on the host")
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized() \
            and os.environ.get("LOCAL_RANK"):
        return torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    return torch.device("cuda", torch.cuda.current_device())


def is_sm90(device: torch.device | None = None) -> bool:
    """True on a Hopper card (compute capability 9.0), the only target the
    CUDA kernels are built for."""
    return (torch.cuda.is_available()
            and torch.cuda.get_device_capability(device) == KERNEL_CAPABILITY)


def card_name_and_power_limit() -> str:
    """``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` for
    the first card, as nvidia-smi prints it. A card set below its maximum
    power runs slower under load, so every measurement is reported beside
    this line."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def memory_stats(device: torch.device | None = None) -> dict:
    """Allocator counters of a CUDA device, in bytes."""
    return {
        "allocated": torch.cuda.memory_allocated(device),
        "reserved": torch.cuda.memory_reserved(device),
        "max_allocated": torch.cuda.max_memory_allocated(device),
        "total": torch.cuda.get_device_properties(device).total_memory,
    }
