"""Parameter trees for the serving engine.

Counterpart of ``deepspeed_tpu/inference/weights.py``. The engine reads a
nested dict of tensors with the flax tree's structure and names
(``embed``, ``layer_{i}/attn/wq``, ...):

- :func:`params_from_jax` turns the JAX package's unboxed parameter tree
  (numpy arrays) into that dict on the port's device and dtype — the path
  every parity test takes, so both packages serve identical weights.
- :func:`module_param_tree` views a port ``TransformerLM``'s own
  parameters as that dict (no copy when dtype and device already match).

Layers stay per-layer (``layer_{i}``). The JAX engine stacks them to
``lax.scan`` over depth, which bounds its compile time; eager PyTorch loops
over layers at no such cost, and stacking would copy every weight.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

Tree = dict[str, Any]


def _cast(t: torch.Tensor, dtype, device) -> torch.Tensor:
    if t.is_floating_point():
        return t.to(device=device, dtype=dtype)
    return t.to(device=device)


def params_from_jax(tree, cfg=None, *, dtype=torch.float32,
                    device=None) -> Tree:
    """The JAX package's unboxed parameter tree (nested dicts of numpy or
    array-likes; ``flax.core.meta.unbox`` first) → the same nested dict of
    torch tensors on ``device`` (the CUDA device by default), floating
    leaves cast to ``dtype``. ``cfg`` (a port ``ModelConfig``), when
    given, checks that the tree holds every layer of the config."""
    from ..accelerator import get_device

    dev = get_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        return _cast(torch.from_numpy(np.array(node)), dtype, dev)

    out = conv(dict(tree))
    if cfg is not None:
        missing = [i for i in range(cfg.num_layers) if f"layer_{i}" not in out]
        if missing:
            raise ValueError(f"parameter tree lacks layers {missing}")
    return out


def cast_tree(tree: Tree, *, dtype, device) -> Tree:
    """A parameter tree with floating leaves cast to ``dtype`` on ``device``
    (leaves already there are kept, not copied)."""
    return {k: cast_tree(v, dtype=dtype, device=device)
            if isinstance(v, dict) else _cast(v, dtype, device)
            for k, v in tree.items()}


def module_param_tree(module: torch.nn.Module, *, dtype=None,
                      device=None) -> Tree:
    """A module's parameters as the nested name dict (``layer_0.attn.wq``
    → ``tree["layer_0"]["attn"]["wq"]``), cast to ``dtype``/``device``
    where given (``Tensor.to`` returns the tensor itself when nothing
    changes, so serving the module's own weights costs no copy)."""
    out: Tree = {}
    for name, p in module.named_parameters():
        node = out
        *path, leaf = name.split(".")
        for part in path:
            node = node.setdefault(part, {})
        t = p.detach()
        node[leaf] = _cast(t, dtype or t.dtype, device or t.device)
    return out


def flatten_tree(tree: Tree, prefix: str = "") -> dict[str, torch.Tensor]:
    """Nested dict → ``{"layer_0.attn.wq": tensor}`` (a state dict for
    ``TransformerLM.load_state_dict``)."""
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(flatten_tree(v, key + "."))
        else:
            out[key] = v
    return out
