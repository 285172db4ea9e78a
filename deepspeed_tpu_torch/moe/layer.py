"""The MoE layer: router, stacked experts, dispatch and combine.

Counterpart of ``deepspeed_tpu/moe/layer.py`` (``TopKGate``,
``dropless_dispatch_combine``, ``Experts``, ``MoE``). The experts are ONE
stacked parameter tree with a leading expert axis, under the flax tree's
names (``gate/wg`` ``[E, n]``; ``experts/{w_gate, w_up}`` ``[n, E, F]``,
``experts/w_down`` ``[n, F, E]``). Two routes, as in the JAX package:

- capacity (the default): top-k gating with per-group capacity, dispatch
  and combine as einsums over the gate's one-hot masks, experts as batched
  products over ``[n, G, capacity, E]``;
- dropless (``dropless=True``): every token reaches its k experts; tokens
  are sorted into an expert-aligned buffer and the experts run as grouped
  products (``ops/grouped_matmul.py``, K5 on the card).

The math lives in plain functions over parameter dicts (:func:`moe_forward`,
:func:`dropless_dispatch_combine`), shared by the modules here and the
serving engine (``inference/engine_v2.py``), whose quantized-expert route
swaps the grouped product for K3. This slice serves: the forward returns no
auxiliary losses (they are training state).

Router precision follows the JAX package: logits are computed in fp32 from
x and ``wg`` (both upcast), and the gates are cast to x's dtype before the
combine.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.grouped_matmul import ExpertSort, grouped_matmul, \
    sort_tokens_by_expert
from .sharded_moe import topk_dropless_gating, topkgating


def router_logits(x: torch.Tensor, wg: torch.Tensor) -> torch.Tensor:
    """``[..., E] @ [E, n]`` in fp32 (the einsum ``gse,en->gsn``)."""
    return x.float() @ wg.float()


def expert_ffn(x, p, activation: str, mm: Callable):
    """SwiGLU (``w_gate``/``w_up``/``w_down``) or two-matrix expert FFN over
    the product ``mm(h, weight)``."""
    if activation == "silu_glu":
        h = F.silu(mm(x, p["w_gate"])) * mm(x, p["w_up"])
    else:
        from ..models.transformer import _ACTS

        h = _ACTS[activation](mm(x, p["w_up"]))
    return mm(h, p["w_down"])


def experts_capacity(x: torch.Tensor, p, activation: str = "silu_glu"
                     ) -> torch.Tensor:
    """Capacity route: ``x`` [n, g, c, E] through each expert's FFN (the
    einsums ``ngce,nef->ngcf`` and ``ngcf,nfe->ngce``)."""
    n, g, c, _ = x.shape

    def mm(h, w):
        y = torch.bmm(h.reshape(n, g * c, -1), w.to(h.dtype))
        return y.reshape(n, g, c, -1)

    return expert_ffn(x, p, activation, mm)


def experts_grouped(buf: torch.Tensor, p, srt: ExpertSort, block_m: int,
                    activation: str = "silu_glu") -> torch.Tensor:
    """Dropless route: the expert-sorted buffer [Tp, E] through each tile's
    expert FFN as grouped products (K5 on the card), limited to the routed
    rows of each tile."""
    def mm(h, w):
        return grouped_matmul(h, w.to(h.dtype), srt.tile_expert, block_m,
                              srt.tile_rows)

    return expert_ffn(buf, p, activation, mm)


def dropless_dispatch_combine(x2d: torch.Tensor, gates: torch.Tensor,
                              experts: torch.Tensor, num_experts: int, k: int,
                              block_m: int, gemm: Callable) -> torch.Tensor:
    """Sort the [T, k] expert choices into a block-aligned buffer, run
    ``gemm(buf, sort) -> [Tp, F]`` (grouped products in bf16/fp32, or the
    quantized grouped product), gather each token's k rows back and combine
    them with its gates. No value is read back to the host."""
    T, E = x2d.shape
    srt = sort_tokens_by_expert(experts.reshape(T, k), num_experts, block_m)
    dst = srt.dst.long()
    rows = x2d.repeat_interleave(k, dim=0)                 # [T*k, E]
    buf = x2d.new_zeros((srt.Tp, E)).index_copy_(0, dst, rows)
    out_buf = gemm(buf, srt)
    rows_out = out_buf.index_select(0, dst).reshape(T, k, -1)
    return torch.einsum("tk,tke->te", gates.reshape(T, k).to(x2d.dtype),
                        rows_out)


def moe_forward(x: torch.Tensor, p, *, num_experts: int, k: int = 2,
                eval_capacity_factor: float = 1.0, min_capacity: int = 4,
                drop_tokens: bool = True, activation: str = "silu_glu",
                dropless: bool = False, dropless_block_m: int = 128,
                normalize_gates: bool = True, hidden_size: int | None = None,
                ffn_size: int | None = None, capacity_factor: float = 1.0,
                aux_loss_weight: float = 0.01,
                z_loss_weight: float = 0.001) -> torch.Tensor:
    """The MoE layer's inference forward over ``p`` (``gate/wg``,
    ``experts/...``): x [B, S, E] (B groups of S tokens) → [B, S, E] in x's
    dtype. Takes the keyword arguments of ``models.transformer.
    moe_layer_kwargs``; the sizes come from the weights, and the training
    options (``capacity_factor``, the loss weights) have no effect here."""
    B, S, E = x.shape
    dt = x.dtype
    logits = router_logits(x, p["gate"]["wg"])                 # [B, S, n]
    if dropless:
        gate = topk_dropless_gating(logits, k,
                                    normalize_gates=normalize_gates)
        y = dropless_dispatch_combine(
            x.reshape(B * S, E), gate.gates, gate.experts, num_experts, k,
            dropless_block_m,
            lambda buf, srt: experts_grouped(buf, p["experts"], srt,
                                             dropless_block_m, activation))
        return y.reshape(B, S, E)
    gate = topkgating(logits, k, eval_capacity_factor, min_capacity,
                      drop_tokens=drop_tokens,
                      normalize_gates=normalize_gates)
    expert_in = torch.einsum("gsnc,gse->ngce", gate.dispatch.to(dt), x)
    expert_out = experts_capacity(expert_in, p["experts"], activation)
    return torch.einsum("gsnc,ngce->gse", gate.combine.to(dt), expert_out)


class TopKGate(nn.Module):
    """The router's weight ``wg`` [E, n] (the fp32 linear of the JAX
    package's ``TopKGate``; its gating is :func:`moe_forward`'s)."""

    def __init__(self, hidden_size: int, num_experts: int, pf):
        super().__init__()
        self.wg = pf.dense((hidden_size, num_experts))


class Experts(nn.Module):
    """Stacked expert FFNs: ``w_gate``/``w_up`` [n, E, F] and ``w_down``
    [n, F, E] (SwiGLU), or ``w_up``/``w_down`` for a two-matrix
    activation."""

    def __init__(self, hidden_size: int, ffn_size: int, num_experts: int,
                 activation: str, pf):
        super().__init__()
        self.activation = activation
        E, Fs, n = hidden_size, ffn_size, num_experts
        if activation == "silu_glu":
            self.w_gate = pf.dense((n, E, Fs))
        self.w_up = pf.dense((n, E, Fs))
        self.w_down = pf.dense((n, Fs, E))

    def forward(self, x: torch.Tensor, sort: ExpertSort | None = None,
                block_m: int = 128) -> torch.Tensor:
        """Capacity mode (``sort`` None): x [n, g, c, E] → same shape.
        Dropless mode: x the expert-sorted buffer [Tp, E], ``sort`` its
        ``ExpertSort``."""
        p = dict(self.named_parameters())
        if sort is None:
            return experts_capacity(x, p, self.activation)
        return experts_grouped(x, p, sort, block_m, self.activation)


class MoE(nn.Module):
    """The MoE layer (the JAX package's ``MoE``): its options are the
    module's attributes, its parameters ``gate.wg`` and ``experts.*``.
    Parameters are made by ``pf`` (a ``models.transformer._ParamFactory``)
    or, without one, on ``device`` in ``dtype`` from ``seed``."""

    def __init__(self, hidden_size: int, num_experts: int = 8,
                 ffn_size: int | None = None, k: int = 2,
                 capacity_factor: float = 1.0,
                 eval_capacity_factor: float = 1.0, min_capacity: int = 4,
                 drop_tokens: bool = True, activation: str = "silu_glu",
                 aux_loss_weight: float = 0.01, z_loss_weight: float = 0.001,
                 dropless: bool = False, dropless_block_m: int = 128,
                 normalize_gates: bool = True, *, pf=None, device=None,
                 dtype=torch.float32, seed: int = 0):
        super().__init__()
        if pf is None:
            from ..accelerator import get_device
            from ..models.transformer import _ParamFactory

            pf = _ParamFactory(get_device(device), dtype, seed)
        self.hidden_size, self.num_experts = hidden_size, num_experts
        self.ffn_size = ffn_size or 4 * hidden_size
        self.k, self.capacity_factor = k, capacity_factor
        self.eval_capacity_factor = eval_capacity_factor
        self.min_capacity, self.drop_tokens = min_capacity, drop_tokens
        self.activation = activation
        self.aux_loss_weight, self.z_loss_weight = (aux_loss_weight,
                                                    z_loss_weight)
        self.dropless, self.dropless_block_m = dropless, dropless_block_m
        self.normalize_gates = normalize_gates
        self.gate = TopKGate(hidden_size, num_experts, pf)
        self.experts = Experts(hidden_size, self.ffn_size, num_experts,
                               activation, pf)

    def options(self) -> dict:
        """The keyword arguments of :func:`moe_forward`."""
        return dict(num_experts=self.num_experts, k=self.k,
                    eval_capacity_factor=self.eval_capacity_factor,
                    min_capacity=self.min_capacity,
                    drop_tokens=self.drop_tokens, activation=self.activation,
                    dropless=self.dropless,
                    dropless_block_m=self.dropless_block_m,
                    normalize_gates=self.normalize_gates)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x [B, S, E] → [B, S, E] (inference: eval capacity factor)."""
        p = {"gate": {"wg": self.gate.wg},
             "experts": dict(self.experts.named_parameters())}
        return moe_forward(x, p, **self.options())
