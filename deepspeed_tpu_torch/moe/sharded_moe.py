"""Gating algebra for Mixture-of-Experts.

Counterpart of ``deepspeed_tpu/moe/sharded_moe.py`` (``compute_capacity``,
``topkgating``, ``topk_dropless_gating``, ``top1gating``, ``top2gating``):
the same static-shaped formulation on tensors — softmax over the router
logits in fp32, top-k experts per token, capacity-bounded positions,
renormalised gates, and the GShard load-balance and router z-losses.

Top-k order: ``jax.lax.top_k`` puts the lower expert index first when two
probabilities tie, and ``torch.topk`` promises no order among ties, so
:func:`_top_k` takes the first k of a stable descending sort instead.

Nothing here reads a value back to the host: capacity is static, and the
positions come from cumulative sums over one-hot masks.

Under data parallelism (``comm.data_parallel_scope``) the load-balance
loss's means ``me`` and ``ce`` are over every token of the global
micro-batch, as the JAX engine's are under GSPMD: ``l_aux`` is not linear
in them, so a mean of per-rank losses would differ. ``me`` is averaged
over the group with its gradient passed through
(``comm.all_reduce_mean_autograd``), ``ce`` (no gradient) plainly. The
capacity is per group of S tokens (one sequence), which the split of rows
over ranks leaves alone, and the z-loss is a plain mean over equal token
counts.

The losses cost a softmax statistic, a logsumexp and the one-hot counts per
layer; only training reads them. ``losses=False`` (serving) leaves them out
and sets ``aux_loss``, ``z_loss`` and ``exp_counts`` to None, where XLA
removes them from the JAX engine's program as dead code.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F


class GateOutput(NamedTuple):
    """The JAX package's ``GateOutput``."""
    aux_loss: torch.Tensor | None   # scalar load-balance loss (unweighted)
    combine: torch.Tensor      # [G, S, n, cap] fp32: gate * position one-hot
    dispatch: torch.Tensor     # [G, S, n, cap] fp32 mask
    exp_counts: torch.Tensor | None  # [n] routed per expert (pre-capacity)
    z_loss: torch.Tensor | None      # router z-loss (unweighted)


class DroplessGateOutput(NamedTuple):
    """The JAX package's ``DroplessGateOutput``: raw top-k choices."""
    gates: torch.Tensor        # [G, S, k] normalised gate weights
    experts: torch.Tensor      # [G, S, k] int32 expert ids
    aux_loss: torch.Tensor | None
    z_loss: torch.Tensor | None
    exp_counts: torch.Tensor | None   # [n]


def compute_capacity(tokens_per_group: int, num_experts: int, k: int,
                     capacity_factor: float, min_capacity: int) -> int:
    """Static per-group expert capacity."""
    cap = int(k * tokens_per_group / num_experts * capacity_factor)
    return max(cap, min_capacity)


def _top_k(probs: torch.Tensor, k: int):
    """(values, indices) of the k largest entries of the last dim, ties
    broken toward the lower index as ``jax.lax.top_k`` breaks them."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _losses(logits, probs, onehot, n, wanted: bool = True):
    """(aux_loss, z_loss, exp_counts) of the GShard formulation; three
    Nones when not ``wanted``."""
    if not wanted:
        return None, None, None
    from ..comm.comm import all_reduce_mean_autograd, current_data_parallel

    me = probs.mean(dim=(0, 1))                                    # [n]
    ce = onehot.sum(dim=2).mean(dim=(0, 1))                        # [n]
    dp = current_data_parallel()
    if dp is not None:
        me = all_reduce_mean_autograd(me, dp.group)
        ce = all_reduce_mean_autograd(ce.detach(), dp.group)
    aux_loss = (me * ce).sum() * n
    z_loss = torch.logsumexp(logits, dim=-1).square().mean()
    return aux_loss, z_loss, onehot.sum(dim=(0, 1, 2))


def _noisy(logits, noise, noise_eps):
    """Logits plus jitter: ``noise`` is a standard-normal tensor of the
    logits' shape that the caller draws (the JAX package draws it from its
    gating RNG; a test hands both packages the same numbers)."""
    if noise is None:
        return logits
    return logits + noise.to(logits) * noise_eps


def topkgating(logits: torch.Tensor, k: int, capacity_factor: float = 1.0,
               min_capacity: int = 4, *, noise: torch.Tensor | None = None,
               noise_eps: float = 1e-2, drop_tokens: bool = True,
               normalize_gates: bool = True,
               losses: bool = True) -> GateOutput:
    """Generalised top-k capacity gating over ``logits`` [G, S, n] (G
    groups of S tokens; capacity is bounded per group). With
    ``drop_tokens=False`` the capacity is S*k and nothing overflows;
    ``losses=False`` leaves the losses out."""
    G, S, n = logits.shape
    logits = _noisy(logits.float(), noise, noise_eps)
    probs = torch.softmax(logits, dim=-1)
    capacity = (compute_capacity(S, n, k, capacity_factor, min_capacity)
                if drop_tokens else S * k)

    gate_vals, expert_idx = _top_k(probs, k)                       # [G,S,k]
    onehot = F.one_hot(expert_idx, n).float()                      # [G,S,k,n]

    # position of each (token, choice) in its expert's queue: earlier tokens
    # first, within a token the higher-ranked choice first
    flat = onehot.reshape(G, S * k, n)
    pos_in_expert = (flat.cumsum(dim=1) * flat - 1.0).reshape(G, S, k, n)
    keep = (pos_in_expert < capacity) & (onehot > 0)
    pos = (pos_in_expert * onehot).sum(dim=-1).clamp(0, capacity - 1)
    kept_gate = gate_vals * keep.sum(dim=-1)                       # drop → 0
    if normalize_gates:
        denom = kept_gate.sum(dim=-1, keepdim=True)
        kept_gate = kept_gate / denom.clamp_min(1e-9)

    aux_loss, z_loss, exp_counts = _losses(logits, probs, onehot, n, losses)
    pos_oh = F.one_hot(pos.long(), capacity).float()               # [G,S,k,c]
    keepf = keep.float() * onehot                                  # [G,S,k,n]
    dispatch = torch.einsum("gskn,gskc->gsnc", keepf, pos_oh)
    combine = torch.einsum("gsk,gskn,gskc->gsnc", kept_gate, keepf, pos_oh)
    return GateOutput(aux_loss=aux_loss, combine=combine, dispatch=dispatch,
                      exp_counts=exp_counts, z_loss=z_loss)


def topk_dropless_gating(logits: torch.Tensor, k: int, *,
                         noise: torch.Tensor | None = None,
                         noise_eps: float = 1e-2,
                         normalize_gates: bool = True,
                         losses: bool = True) -> DroplessGateOutput:
    """Top-k routing with no capacity and no drops: every token reaches all
    k chosen experts (the expert-sorted buffer of
    ``ops.grouped_matmul.sort_tokens_by_expert`` takes the place of
    capacity); ``losses=False`` leaves the losses out."""
    G, S, n = logits.shape
    logits = _noisy(logits.float(), noise, noise_eps)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = _top_k(probs, k)                       # [G,S,k]
    if normalize_gates:
        gate_vals = gate_vals / gate_vals.sum(
            dim=-1, keepdim=True).clamp_min(1e-9)
    aux_loss, z_loss, exp_counts = _losses(
        logits, probs, F.one_hot(expert_idx, n).float() if losses else None,
        n, losses)
    return DroplessGateOutput(gates=gate_vals,
                              experts=expert_idx.to(torch.int32),
                              aux_loss=aux_loss, z_loss=z_loss,
                              exp_counts=exp_counts)


def top1gating(logits: torch.Tensor, capacity_factor: float = 1.0,
               min_capacity: int = 4, **kw) -> GateOutput:
    """Switch-style top-1 gating (raw, unnormalised gates)."""
    return topkgating(logits, 1, capacity_factor, min_capacity,
                      normalize_gates=False, **kw)


def top2gating(logits: torch.Tensor, capacity_factor: float = 1.0,
               min_capacity: int = 4, **kw) -> GateOutput:
    """GShard top-2 gating."""
    return topkgating(logits, 2, capacity_factor, min_capacity, **kw)
