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
swaps the grouped product for K3. :func:`moe_forward` returns the layer's
output and its loss, ``aux_loss * aux_loss_weight + z_loss *
z_loss_weight`` (what the flax layer sows into ``losses``); in training
mode it routes at ``capacity_factor`` and takes RSample noise, in eval
mode at ``eval_capacity_factor`` with none (flax's ``deterministic``).
Gradients reach x, the experts and, through the gates and the losses,
``gate/wg``; the dropless route's grouped products differentiate through
K5's dx and dw kernels on the card.

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
                capacity_factor: float = 1.0,
                eval_capacity_factor: float = 1.0, min_capacity: int = 4,
                drop_tokens: bool = True, activation: str = "silu_glu",
                aux_loss_weight: float = 0.01, z_loss_weight: float = 0.001,
                dropless: bool = False, dropless_block_m: int = 128,
                normalize_gates: bool = True, hidden_size: int | None = None,
                ffn_size: int | None = None, training: bool = False,
                noise: torch.Tensor | None = None, losses: bool = True
                ) -> tuple[torch.Tensor, torch.Tensor | None]:
    """The MoE layer over ``p`` (``gate/wg``, ``experts/...``): x [B, S, E]
    (B groups of S tokens) → (y [B, S, E] in x's dtype, the layer's fp32
    loss ``aux_loss * aux_loss_weight + z_loss * z_loss_weight``). Takes the
    keyword arguments of ``models.transformer.moe_layer_kwargs``; the sizes
    come from the weights. ``training`` routes the capacity route at
    ``capacity_factor`` (else ``eval_capacity_factor``); ``noise`` (a
    standard-normal [B, S, n], the RSample jitter) is added to the router
    logits at 1e-2. ``losses=False`` (serving, which drops the loss) skips
    the gating losses and returns None in the loss's place."""
    B, S, E = x.shape
    dt = x.dtype
    logits = router_logits(x, p["gate"]["wg"])                 # [B, S, n]
    if dropless:
        gate = topk_dropless_gating(logits, k, noise=noise,
                                    normalize_gates=normalize_gates,
                                    losses=losses)
        y = dropless_dispatch_combine(
            x.reshape(B * S, E), gate.gates, gate.experts, num_experts, k,
            dropless_block_m,
            lambda buf, srt: experts_grouped(buf, p["experts"], srt,
                                             dropless_block_m, activation))
        y = y.reshape(B, S, E)
    else:
        gate = topkgating(logits, k,
                          capacity_factor if training
                          else eval_capacity_factor,
                          min_capacity, noise=noise, drop_tokens=drop_tokens,
                          normalize_gates=normalize_gates, losses=losses)
        expert_in = torch.einsum("gsnc,gse->ngce", gate.dispatch.to(dt), x)
        expert_out = experts_capacity(expert_in, p["experts"], activation)
        y = torch.einsum("gsnc,ngce->gse", gate.combine.to(dt), expert_out)
    if not losses:
        return y, None
    return y, gate.aux_loss * aux_loss_weight + gate.z_loss * z_loss_weight


def gating_noise(shape, device, seed: int | None) -> torch.Tensor:
    """RSample's standard-normal jitter of the router logits, drawn from a
    ``torch.Generator`` seeded with ``seed``. Without a seed one is drawn
    from the default CPU generator, whose state ``torch.utils.checkpoint``
    restores before it recomputes: either way a rematerialized forward
    draws the same noise."""
    if seed is None:
        seed = int(torch.randint(0, 2 ** 62, ()))
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return torch.randn(shape, generator=gen, device=device)


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
    or, without one, on ``device`` in ``dtype`` from ``seed``.

    PyTorch's ``self.training`` is flax's ``not deterministic``: the layer
    is built in eval mode (flax's default), ``train()`` switches it to the
    training routing and, with ``noisy_gate_policy="RSample"``, the jitter
    (:func:`gating_noise`)."""

    def __init__(self, hidden_size: int, num_experts: int = 8,
                 ffn_size: int | None = None, k: int = 2,
                 capacity_factor: float = 1.0,
                 eval_capacity_factor: float = 1.0, min_capacity: int = 4,
                 drop_tokens: bool = True, activation: str = "silu_glu",
                 aux_loss_weight: float = 0.01, z_loss_weight: float = 0.001,
                 dropless: bool = False, dropless_block_m: int = 128,
                 normalize_gates: bool = True,
                 noisy_gate_policy: str | None = None, *, pf=None,
                 device=None, dtype=torch.float32, seed: int = 0):
        super().__init__()
        if noisy_gate_policy not in (None, "RSample"):
            raise ValueError(f"noisy_gate_policy must be None or 'RSample', "
                             f"got {noisy_gate_policy!r}")
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
        self.noisy_gate_policy = noisy_gate_policy
        self.gate = TopKGate(hidden_size, num_experts, pf)
        self.experts = Experts(hidden_size, self.ffn_size, num_experts,
                               activation, pf)
        self.eval()

    def options(self) -> dict:
        """The keyword arguments of :func:`moe_forward` but ``training``
        and ``noise``."""
        return dict(num_experts=self.num_experts, k=self.k,
                    capacity_factor=self.capacity_factor,
                    eval_capacity_factor=self.eval_capacity_factor,
                    min_capacity=self.min_capacity,
                    drop_tokens=self.drop_tokens, activation=self.activation,
                    aux_loss_weight=self.aux_loss_weight,
                    z_loss_weight=self.z_loss_weight,
                    dropless=self.dropless,
                    dropless_block_m=self.dropless_block_m,
                    normalize_gates=self.normalize_gates)

    def forward(self, x: torch.Tensor, noise_seed: int | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
        """x [B, S, E] → (y [B, S, E], the layer's loss), routed for
        training or eval by ``self.training``; ``noise_seed`` seeds the
        RSample jitter (training mode only; see :func:`gating_noise`)."""
        p = {"gate": {"wg": self.gate.wg},
             "experts": dict(self.experts.named_parameters())}
        noise = None
        if self.training and self.noisy_gate_policy == "RSample":
            from ..comm.comm import current_data_parallel

            # under data parallelism: the global micro-batch's noise, this
            # rank's rows of it
            dp = current_data_parallel()
            B = x.shape[0]
            noise = gating_noise((B * (dp.size if dp else 1), x.shape[1],
                                  self.num_experts), x.device, noise_seed)
            if dp is not None:
                noise = noise[dp.rank * B:(dp.rank + 1) * B]
        return moe_forward(x, p, training=self.training, noise=noise,
                           **self.options())
