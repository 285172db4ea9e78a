"""deepspeed_tpu_torch — the PyTorch/CUDA port of ``deepspeed_tpu``.

The package mirrors the JAX package's module layout one for one, so every
module here has its counterpart at the same relative path under
``deepspeed_tpu/``. The JAX package stays the reference; this one imports
``torch`` and never ``jax``, ``flax`` or anything of ``deepspeed_tpu``.

Importing the package is cheap: it imports no submodule, no CUDA build
runs and no device is touched. Entry points run on the CUDA device unless
the caller asks for the CPU (``device="cpu"``), and raise when the default
is taken on a machine without one.

Ported so far: FastGen serving (``inference.InferenceEngineV2``) over the
dense and MoE transformer families, with its kernels written in CUDA for
Hopper (``ops/csrc/``), and training:
``deepspeed_tpu_torch.initialize(model=..., config=...)`` returns the
training engine (``runtime/engine.py``), ZeRO stages 0-3 over
``torch.distributed`` (``init_distributed``, ``comm``, ``zero``), with
checkpoints that reshard on load (``runtime/checkpointing.py``,
``checkpoint``), the resilience rewind, and ZeRO-Offload / ZeRO-Infinity
(the optimizer state, and the parameters, on the host or NVMe; the host
library built with g++ from ``csrc/``); its attention runs the flash
kernel K4 (``ops/csrc/flash_attention.cu``). The names below are imported
on first use.
"""
from .version import __version__  # noqa: F401

_LAZY = {"initialize": ("runtime.engine", "initialize"),
         "DeepSpeedEngine": ("runtime.engine", "DeepSpeedEngine"),
         "Config": ("config", "Config"),
         "DeepSpeedConfig": ("config", "DeepSpeedConfig"),
         "init_distributed": ("comm.comm", "init_distributed"),
         "comm": ("comm", None),
         "zero": ("zero", None),
         "checkpoint": ("checkpoint", None),
         "get_fp32_state_dict_from_zero_checkpoint": (
             "checkpoint.universal", "get_fp32_state_dict_from_zero_checkpoint"),
         "zero_to_fp32": ("checkpoint.universal", "zero_to_fp32"),
         "ds_to_universal": ("checkpoint.universal", "ds_to_universal"),
         "state_tree": ("runtime.checkpointing", "state_tree"),
         "load_state_tree": ("runtime.checkpointing", "load_state_tree")}


def __getattr__(name: str):
    if name in _LAZY:
        import importlib

        module, attr = _LAZY[name]
        mod = importlib.import_module(f".{module}", __name__)
        return mod if attr is None else getattr(mod, attr)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
