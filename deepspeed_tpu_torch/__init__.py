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
dense transformer family, with the ragged paged-attention kernel written in
CUDA for Hopper (``ops/csrc/paged_attention.cu``).
"""
from .version import __version__  # noqa: F401
