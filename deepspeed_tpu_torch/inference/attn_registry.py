"""Attention-formulation registry: the ONE place that picks how the serving
engine computes paged attention.

Counterpart of ``deepspeed_tpu/inference/attn_registry.py``, with its
``AttnSelection`` and reason vocabulary. The paths:

- ``"cuda"``: the hand-written Hopper kernel (``ops/paged_attention.py``,
  K1) on the engine's CUDA device;
- ``"plain"``: the same call on CPU tensors, which runs the kernel's plain
  PyTorch version — the CPU engine's path by design, not a fallback;
- ``"gather"``: the plain version called directly, outside the kernel's
  route: for ALiBi's positional bias (which the kernel does not compute),
  a ``use_pallas_decode=False`` pin, or — on the CPU only — a geometry
  outside the kernel's gate. The reason names which.

On a CUDA device nothing falls back: a geometry outside the gate or a card
that is not sm_90 raises, unless ALiBi or the pin already chose "gather".

The engine makes one selection per dispatch mode at construction — "decode"
(prefill chunks, decode steps and windows) and "tree" (the speculative
verify forward) — and counts every dispatch against it
(``stats["attn_<path>_<mode>"]``). The JAX registry's tree gates are the
Pallas kernel's VMEM budgets (``QUERY_TILE_ROWS``, ``TREE_MASK_VMEM_BYTES``);
the CUDA kernel tiles query rows by 16 and reads the mask from device
memory, so it takes any tree the engine stages, and its tree gates are its
decode gates.
"""
from __future__ import annotations

from dataclasses import dataclass

from ..ops.paged_attention import paged_attention_usable


@dataclass(frozen=True)
class AttnSelection:
    """Which attention formulation serves a dispatch mode, and why not the
    kernel when it doesn't."""
    path: str      # "cuda" | "plain" | "gather"
    mode: str      # "decode" | "tree"
    reason: str    # why the kernel does not serve; "" when it does

    @property
    def is_kernel(self) -> bool:
        """True when the dispatch goes through ``paged_ragged_attention``
        (the kernel on CUDA, its plain version on the CPU)."""
        return self.path in ("cuda", "plain")


def select_attention(*, mode: str, device_type: str, num_heads: int,
                     kv_heads: int, head_dim: int, block_size: int,
                     use_kernel: bool | None, alibi: bool, sm90: bool,
                     verify_pin: bool | None = None) -> AttnSelection:
    """Pick the formulation for ``mode``: "decode" (prefill chunks, decode
    steps and decode windows) or "tree" (the speculative verify forward).

    ``use_kernel`` is the engine's ``use_pallas_decode`` pin (None = auto,
    False = gather, True = the kernel or refuse); in tree mode
    ``verify_pin`` (``spec_verify_pallas``) adds its own, as in the JAX
    engine: False pins the gather route, True requires the kernel. Raises
    ValueError when a pin demands a kernel that cannot serve, and
    NotImplementedError when a CUDA engine would need the kernel but it
    cannot serve there."""
    if mode not in ("decode", "tree"):
        raise ValueError(f"unknown attention mode {mode!r}")
    if mode == "tree" and verify_pin is False:
        return AttnSelection("gather", mode,
                             "spec_verify_pallas=False (config pin)")
    if use_kernel is False:
        reason = "use_pallas_decode=False (config pin)"
    elif alibi:
        reason = "alibi positional bias runs in the gather path only"
    elif not paged_attention_usable(num_heads, kv_heads, head_dim,
                                    block_size):
        reason = ("kernel-unusable geometry (needs head_dim in {64,128,256}, "
                  "block_size % 8 == 0 and whole GQA groups)")
    elif device_type == "cuda" and not sm90:
        reason = "the CUDA kernels are built for sm_90a (H100/H200) only"
    else:
        return AttnSelection("cuda" if device_type == "cuda" else "plain",
                             mode, "")
    pins = [name for name, on in (("use_pallas_decode", use_kernel),
                                  ("spec_verify_pallas",
                                   mode == "tree" and verify_pin)) if on]
    if pins:
        raise ValueError(f"{pins[-1]}=True but the paged-attention kernel "
                         f"cannot serve this engine's {mode} mode: {reason}")
    if device_type == "cuda" and use_kernel is None and not alibi:
        raise NotImplementedError(
            f"the paged-attention kernel cannot serve this CUDA engine "
            f"({mode} mode): {reason}; pin use_pallas_decode=False to run "
            f"the plain version on the card")
    return AttnSelection("gather", mode, reason)
