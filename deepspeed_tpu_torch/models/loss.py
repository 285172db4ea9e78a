"""Loss functions for the model zoo.

Counterpart of ``deepspeed_tpu/models/loss.py``: the LM cross-entropy
(:func:`cross_entropy_lm`, fp32 log-sum-exp, ``IGNORE_INDEX`` labels masked
out, optional z-loss) and the engine's default loss :func:`lm_loss_fn`
(next-token shift when the batch has no labels; plus the losses the MoE
layers return, as the JAX loss adds what they sow).

``DS_TPU_CE_CHUNK=<rows>``, read at each call, streams the cross-entropy
over ``[rows, V]`` pieces, each checkpointed so its fp32 logits are rebuilt
in the backward rather than kept: the same function, in less memory.

Under data parallelism (``comm.data_parallel_scope``, which the engine
opens around a step) the mean is over the whole global micro-batch, as the
JAX engine's is under GSPMD: the count of labelled tokens is summed over
the group, and the rank's loss is its nll sum over that count times the
group size, so the group's mean of losses and of gradients is the global
loss and its gradient. A per-rank mean would miss whenever the ranks hold
different numbers of ``IGNORE_INDEX`` labels.

The fused vocab-chunked head loss (``fused_lm_head_loss``,
behind ``DS_TPU_FUSED_HEAD_CHUNK``) and the masked-LM loss of the bert
family are ported with later slices; setting the env switch raises.
"""
from __future__ import annotations

import math
import os

import torch
from torch.utils.checkpoint import checkpoint

IGNORE_INDEX = -100


def _nll_logz_piece(lg: torch.Tensor, lb: torch.Tensor):
    """Per-token (nll, logz) in fp32 of [n, V] logits; rows whose label is
    negative get 0."""
    l32 = lg.float()
    mask = lb >= 0
    lz = torch.logsumexp(l32, dim=-1)
    true = l32.gather(-1, torch.where(mask, lb, 0)[:, None])[:, 0]
    return (lz - true) * mask, lz * mask


def _masked_mean_loss(nll, logz, denom, z_loss_weight, ranks=1):
    loss = nll.sum() / denom
    if z_loss_weight:
        loss = loss + z_loss_weight * logz.square().sum() / denom
    return loss * ranks if ranks > 1 else loss


def _denominator(mask: torch.Tensor) -> tuple[torch.Tensor, int]:
    """(labelled tokens, at least 1; the group size): over the
    data-parallel group when a scope is open."""
    from ..comm.comm import current_data_parallel

    count = mask.sum()
    dp = current_data_parallel()
    if dp is None:
        return torch.clamp(count, min=1), 1
    import torch.distributed as dist

    count = count.clone()
    dist.all_reduce(count, group=dp.group)
    return torch.clamp(count, min=1), dp.size


def cross_entropy_lm(logits: torch.Tensor, labels: torch.Tensor,
                     ignore_index: int = IGNORE_INDEX,
                     z_loss_weight: float = 0.0) -> torch.Tensor:
    """Mean next-token cross entropy. ``logits`` [B,S,V], ``labels`` [B,S]
    already shifted by the caller (labels[t] is the target for logits[t])."""
    V = logits.shape[-1]
    N = math.prod(logits.shape[:-1])
    mask = labels != ignore_index
    denom, ranks = _denominator(mask)
    ce_chunk = int(os.environ.get("DS_TPU_CE_CHUNK", "0"))
    if ce_chunk:
        chunk = min(ce_chunk, N)
        lab = torch.where(mask, labels, -1).reshape(N)
        lg = logits.reshape(N, V)
        pieces = [checkpoint(_nll_logz_piece, lg[s:s + chunk], lab[s:s + chunk],
                             use_reentrant=False)
                  for s in range(0, N, chunk)]
        nll = torch.cat([p[0] for p in pieces])
        logz = torch.cat([p[1] for p in pieces])
        return _masked_mean_loss(nll, logz, denom, z_loss_weight, ranks)
    logits = logits.float()
    safe_labels = torch.where(mask, labels, 0)
    logz = torch.logsumexp(logits, dim=-1)
    true_logit = logits.gather(-1, safe_labels[..., None])[..., 0]
    nll = (logz - true_logit) * mask
    loss = nll.sum() / denom
    if z_loss_weight:
        loss = loss + z_loss_weight * (logz.square() * mask).sum() / denom
    return loss * ranks if ranks > 1 else loss


def shift_labels(input_ids: torch.Tensor) -> torch.Tensor:
    """Next-token labels: ``labels[:, t] = input_ids[:, t + 1]``, the last
    column ``IGNORE_INDEX``."""
    S = input_ids.shape[1]
    keep = torch.arange(S, device=input_ids.device)[None, :] < S - 1
    return torch.where(keep, torch.roll(input_ids, -1, dims=1),
                       torch.full_like(input_ids, IGNORE_INDEX))


def lm_loss_fn(model, batch: dict) -> torch.Tensor:
    """Default engine loss: causal LM on {'input_ids', 'labels'} batches
    (labels by next-token shift when absent). For a ``TransformerLM`` the
    sum of its MoE layers' losses (weighted aux + z) is added, in layer
    order, as the JAX loss adds the leaves of its ``losses`` collection;
    ``batch["_gating_seed"]``, which the engine sets for a training step,
    seeds their RSample jitter. Any other module maps input_ids to
    logits."""
    from .transformer import TransformerLM

    if os.environ.get("DS_TPU_FUSED_HEAD_CHUNK"):
        raise NotImplementedError(
            "the fused vocab-chunked head loss (DS_TPU_FUSED_HEAD_CHUNK) is "
            "ported with a later slice")
    input_ids = batch["input_ids"]
    labels = batch.get("labels")
    if labels is None:
        labels = shift_labels(input_ids)
    if not isinstance(model, TransformerLM):
        return cross_entropy_lm(model(input_ids), labels)
    logits, layer_losses = model(input_ids, return_losses=True,
                                 noise_seed=batch.get("_gating_seed"))
    loss = cross_entropy_lm(logits, labels)
    for aux in layer_losses:
        loss = loss + aux
    return loss
