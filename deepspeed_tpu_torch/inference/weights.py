"""Parameter trees for the serving engine.

Counterpart of ``deepspeed_tpu/inference/weights.py``. The engine reads a
nested dict of tensors with the flax tree's structure and names
(``embed``, ``layer_{i}/attn/wq``, ...):

- :func:`params_from_jax` turns the JAX package's unboxed parameter tree
  (numpy arrays) into that dict on the port's device and dtype — the path
  every parity test takes, so both packages serve identical weights.
- :func:`module_param_tree` views a port ``TransformerLM``'s own
  parameters as that dict (no copy when dtype and device already match).
- :func:`load_jax_params` loads a JAX tree into a training model's own
  parameters in their dtype (the fp32 master before the engine casts), and
  :func:`to_jax_tree` is the way back: a module's (or an engine's master)
  parameters as a nested dict of numpy arrays in the JAX layout, so two
  engines' parameters compare leaf by leaf.

A leaf may be a ``QuantLinear`` or, for an MoE layer's routed experts, a
``QuantGrouped`` (codes + scales, ``ops/quant_matmul.py``): it moves to the
device as it is, never cast.

Layers stay per-layer (``layer_{i}``). The JAX engine stacks them to
``lax.scan`` over depth, which bounds its compile time; eager PyTorch loops
over layers at no such cost, and stacking would copy every weight.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..ops.quant_matmul import QuantGrouped, QuantLinear

Tree = dict[str, Any]
#: the port's class for each quantized-weight class of the JAX package
_QUANT_TYPES = {"QuantLinear": QuantLinear, "QuantGrouped": QuantGrouped}

_QUANT_FIELDS = ("data", "scale", "bits", "group_size", "shape", "dtype")


def _cast(t: torch.Tensor, dtype, device) -> torch.Tensor:
    if t.is_floating_point():
        return t.to(device=device, dtype=dtype)
    return t.to(device=device)


def _tensor_from_array(a) -> torch.Tensor:
    """A numpy or array-like (ml_dtypes' float8_e4m3fn included) as a torch
    tensor with the same bits."""
    a = np.array(a)
    if a.dtype.name == "float8_e4m3fn":
        return torch.from_numpy(a.view(np.uint8)).view(torch.float8_e4m3fn)
    return torch.from_numpy(a)


def _jax_quant_type(node):
    """The port's class for a JAX ``QuantLinear`` / ``QuantGrouped`` leaf,
    else None."""
    cls = _QUANT_TYPES.get(type(node).__name__)
    if cls is not None and all(hasattr(node, f) for f in _QUANT_FIELDS):
        return cls
    return None


def params_from_jax(tree, cfg=None, *, dtype=torch.float32,
                    device=None) -> Tree:
    """The JAX package's unboxed parameter tree (nested dicts of numpy or
    array-likes; ``flax.core.meta.unbox`` first) → the same nested dict of
    torch tensors on ``device`` (the CUDA device by default), floating
    leaves cast to ``dtype``. A JAX ``QuantLinear`` or ``QuantGrouped``
    leaf becomes the port's class of the same name with its codes and
    scales bit for bit. ``cfg`` (a port
    ``ModelConfig``), when given, checks that the tree holds every layer of
    the config."""
    from ..accelerator import get_device

    dev = get_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        cls = _jax_quant_type(node)
        if cls is not None:
            return cls(
                _tensor_from_array(node.data).to(dev),
                _tensor_from_array(node.scale).to(dev), node.bits,
                int(node.group_size), tuple(int(d) for d in node.shape),
                getattr(torch, np.dtype(node.dtype).name))
        return _cast(_tensor_from_array(node), dtype, dev)

    out = conv(dict(tree))
    if cfg is not None:
        missing = [i for i in range(cfg.num_layers) if f"layer_{i}" not in out]
        if missing:
            raise ValueError(f"parameter tree lacks layers {missing}")
    return out


def cast_tree(tree: Tree, *, dtype, device) -> Tree:
    """A parameter tree with floating leaves cast to ``dtype`` on ``device``
    (leaves already there are kept, not copied); quantized leaves only move to
    ``device``."""
    def conv(v):
        if isinstance(v, dict):
            return cast_tree(v, dtype=dtype, device=device)
        if isinstance(v, (QuantLinear, QuantGrouped)):
            return v.to(device)
        return _cast(v, dtype, device)

    return {k: conv(v) for k, v in tree.items()}


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


def tree_nbytes(tree: Tree) -> int:
    """Bytes of every tensor in a parameter tree (codes + scales for a
    quantized leaf)."""
    total = 0
    for v in tree.values():
        if isinstance(v, dict):
            total += tree_nbytes(v)
        elif isinstance(v, (QuantLinear, QuantGrouped)):
            total += v.nbytes
        else:
            total += v.numel() * v.element_size()
    return total


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


def load_jax_params(module: torch.nn.Module, tree) -> None:
    """Copy a JAX-layout parameter tree (numpy arrays or tensors) into
    ``module``'s parameters, each cast to its parameter's dtype and device;
    every parameter must be in the tree and nothing else."""
    dev = next(module.parameters()).device
    flat = flatten_tree(params_from_jax(tree, dtype=torch.float32,
                                        device=dev))
    module.load_state_dict(flat, strict=True)


def to_jax_tree(params) -> dict:
    """A module's parameters (or a nested dict of tensors, e.g. an engine's
    ``master``) as a nested dict of numpy arrays in the JAX layout; bf16 and
    fp16 leaves become fp32 (numpy has no bf16)."""
    tree = module_param_tree(params) if isinstance(params, torch.nn.Module) \
        else params

    def conv(v):
        if isinstance(v, dict):
            return {k: conv(x) for k, x in v.items()}
        t = v.detach().cpu()
        if t.dtype in (torch.bfloat16, torch.float16):
            t = t.float()
        return t.numpy()

    return conv(tree)
