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
  parameters in their dtype (the fp32 master before the engine casts), an
  MoE training tree included (``moe/moe_layer/gate/wg``,
  ``moe/moe_layer/experts/{w_gate,w_up,w_down}``, ``moe/shared_expert``,
  ``moe/shared_gate``: the same names, one for one), and
  :func:`to_jax_tree` is the way back: a module's (or an engine's master)
  parameters as a nested dict of numpy arrays in the JAX layout, so two
  engines' parameters compare leaf by leaf.

A leaf may be a ``QuantLinear`` or, for an MoE layer's routed experts, a
``QuantGrouped`` (codes + scales, ``ops/quant_matmul.py``): it moves to the
device as it is, never cast.

:func:`save_param_tree` / :func:`load_param_tree` write and read an
engine's tree as one ``.npy`` file per leaf (bf16 as uint16 bits, e4m3 as
uint8 bits; a quantized leaf's codes and scales kept as they are) with an
``index.json``; :func:`copy_param_tree_` copies a staged tree into the live
one in place, after checking that structure, shapes and dtypes match (the
engine's weight swap: captured CUDA graphs keep reading the same
addresses).

:func:`load_tp_params` (the JAX package's ``load_tp_params``) gives a
tensor-parallel rank its slices of a whole tree, by the tensor specs of
``runtime/zero/planner.tensor_plan``.

Layers stay per-layer (``layer_{i}``). The JAX engine stacks them to
``lax.scan`` over depth, which bounds its compile time; eager PyTorch loops
over layers at no such cost, and stacking would copy every weight.
"""
from __future__ import annotations

import json
import os
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


def load_tp_params(model, params: Tree | None, topology, *, dtype,
                   device) -> tuple[Tree, dict]:
    """This tensor rank's parameter tree and the tree's tensor plan
    (``{path: (spec, kind)}``, ``planner.tensor_plan`` at the topology's
    axis sizes).

    ``params`` (a whole tree, e.g. ``params_from_jax`` on the host) is
    sliced leaf by leaf onto ``device``. Without it the weights are
    ``model``'s: a model on the meta device is drawn again a module at a
    time from its seed (``models.transformer.init_modules``), each module
    sliced and dropped before the next is drawn, so a rank never holds more
    than one whole block — and gets the slices of the very weights the
    model built with that seed holds; a materialized model is sliced as it
    is. Floating leaves are cast to ``dtype``; every slice is a copy of its
    own."""
    from ..models.transformer import init_modules
    from ..runtime.zero.planner import tensor_plan, tensor_shard

    sizes = dict(topology.axis_sizes)
    n, rank = topology.size("tensor"), topology.rank_in("tensor")

    def shard(tree: Tree, prefix: tuple) -> tuple[Tree, dict]:
        plan = tensor_plan(tree, sizes, prefix)
        out: Tree = {}
        for path, (spec, _) in plan.items():
            node, src = out, tree
            for k in path[len(prefix):-1]:
                node = node.setdefault(k, {})
                src = src[k]
            whole = src[path[-1]].detach()
            t = _cast(tensor_shard(whole, spec, rank, n), dtype, device)
            same = (t.untyped_storage().data_ptr()
                    == whole.untyped_storage().data_ptr())
            node[path[-1]] = (t.clone(memory_format=torch.contiguous_format)
                              if same else t.contiguous())
        return out, plan

    if params is not None:
        return shard(params, ())
    if next(model.parameters()).device.type != "meta":
        return shard(module_param_tree(model), ())
    out: Tree = {}
    plan: dict = {}
    for name, part in init_modules(model.config, torch.device(device),
                                   model.seed, model.param_dtype):
        whole = ({name: part.detach()} if isinstance(part, torch.Tensor)
                 else {name: module_param_tree(part)})
        got, p = shard(whole, ())
        out.update(got)
        plan.update(p)
        del whole, part
    return out, plan


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


# ---------------------------------------------------------------------------
# per-leaf files and in-place copies (the engine's save_weights /
# swap_weights)
# ---------------------------------------------------------------------------

def _leaf_meta(t: torch.Tensor) -> dict:
    return {"dtype": str(t.dtype).removeprefix("torch."),
            "shape": list(t.shape)}


def _host_array(t: torch.Tensor) -> np.ndarray:
    """A host copy numpy can hold: bf16 as uint16 bits, e4m3 as uint8."""
    from ..runtime.checkpointing import to_numpy
    if t.dtype == torch.float8_e4m3fn:
        return t.detach().cpu().view(torch.uint8).numpy()
    return to_numpy(t)


def _stored_tensor(a: np.ndarray, dtype_name: str) -> torch.Tensor:
    from ..runtime.checkpointing import from_stored
    if dtype_name == "float8_e4m3fn":
        return torch.from_numpy(np.array(a, copy=True)).view(
            torch.float8_e4m3fn)
    return from_stored(a, dtype_name)


def _tree_index(tree: Tree) -> dict:
    """name → what :func:`save_param_tree` records for the leaf."""
    out = {}
    for name, v in flatten_tree(tree).items():
        if isinstance(v, (QuantLinear, QuantGrouped)):
            out[name] = {"kind": type(v).__name__, "bits": v.bits,
                         "group_size": int(v.group_size),
                         "shape": [int(d) for d in v.shape],
                         "compute_dtype": str(v.dtype).removeprefix("torch."),
                         "data": _leaf_meta(v.data),
                         "scale": _leaf_meta(v.scale)}
        else:
            out[name] = {"kind": "tensor", **_leaf_meta(v)}
    return out


def save_param_tree(tree: Tree, state_dir: str) -> None:
    """Write ``tree`` under ``state_dir``: ``<name>.npy`` per tensor leaf,
    ``<name>.data.npy`` + ``<name>.scale.npy`` per quantized leaf, and
    ``index.json`` describing every leaf (read back by
    :func:`load_param_tree`)."""
    os.makedirs(state_dir, exist_ok=True)
    for name, v in flatten_tree(tree).items():
        if isinstance(v, (QuantLinear, QuantGrouped)):
            np.save(os.path.join(state_dir, f"{name}.data.npy"),
                    _host_array(v.data))
            np.save(os.path.join(state_dir, f"{name}.scale.npy"),
                    _host_array(v.scale))
        else:
            np.save(os.path.join(state_dir, f"{name}.npy"), _host_array(v))
    with open(os.path.join(state_dir, "index.json"), "w") as f:
        json.dump(_tree_index(tree), f, indent=1, sort_keys=True)


def tree_mismatch(index: dict, like: Tree) -> str:
    """Why a saved tree's index cannot replace ``like`` in place ("" when
    names, kinds, shapes and dtypes all match)."""
    want = _tree_index(like)
    if set(index) != set(want):
        extra = sorted(set(index) - set(want))[:4]
        missing = sorted(set(want) - set(index))[:4]
        return f"leaf names differ (extra {extra}, missing {missing})"
    for name, w in want.items():
        if index[name] != w:
            return f"leaf {name}: saved {index[name]}, live {w}"
    return ""


def load_param_tree(state_dir: str, like: Tree, device) -> Tree:
    """Read a tree written by :func:`save_param_tree` onto ``device``,
    refusing (ValueError, before any data is read) unless its structure,
    shapes and dtypes are ``like``'s."""
    with open(os.path.join(state_dir, "index.json")) as f:
        index = json.load(f)
    why = tree_mismatch(index, like)
    if why:
        raise ValueError(why)

    def read(name, meta):
        a = np.load(os.path.join(state_dir, name + ".npy"), mmap_mode="r")
        return _stored_tensor(a, meta["dtype"]).to(device)

    out: Tree = {}
    for name, v in flatten_tree(like).items():
        meta = index[name]
        if isinstance(v, (QuantLinear, QuantGrouped)):
            leaf = v._replace(data=read(f"{name}.data", meta["data"]),
                              scale=read(f"{name}.scale", meta["scale"]))
        else:
            leaf = read(name, meta)
        node = out
        *path, last = name.split(".")
        for part in path:
            node = node.setdefault(part, {})
        node[last] = leaf
    return out


def tree_tensors(tree: Tree) -> list[torch.Tensor]:
    """Every tensor of a tree, quantized leaves' codes and scales included,
    in a fixed order."""
    out = []
    for v in flatten_tree(tree).values():
        if isinstance(v, (QuantLinear, QuantGrouped)):
            out += [v.data, v.scale]
        else:
            out.append(v)
    return out


def copy_param_tree_(dst: Tree, src: Tree) -> None:
    """Copy ``src`` into ``dst``'s tensors in place (addresses kept), after
    checking that the two trees' names, kinds, shapes and dtypes match
    (ValueError otherwise, with ``dst`` untouched)."""
    why = tree_mismatch(_tree_index(src), dst)
    if why:
        raise ValueError(why)
    with torch.no_grad():
        for d, s in zip(tree_tensors(dst), tree_tensors(src)):
            d.copy_(s)
