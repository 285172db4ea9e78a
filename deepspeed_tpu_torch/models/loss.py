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
different numbers of ``IGNORE_INDEX`` labels. Under sequence parallelism
(``comm.sequence_parallel_scope``) the count and the factor span the seq
axis too, so the loss is one masked mean over every token of the global
batch; a rank's labels then come with its slice, shifted on whole rows
before the split (the JAX loss's ``roll`` across the sharded dim).

Under tensor parallelism (``comm.tensor_parallel_scope``) a
``TransformerLM``'s logits are this rank's vocab shard: the loss runs
through ``parallel/sequence.vocab_parallel_nll_logz`` over the axis (the
log-partition summed over the shards, the z-loss term kept), and its
count of labelled tokens stays over data x seq: the tensor ranks hold the
same rows.

``DS_TPU_FUSED_HEAD_CHUNK=<vocab columns>`` routes :func:`lm_loss_fn`
through :func:`fused_lm_head_loss`: the unembedding product and the
softmax cross-entropy run together over vocab chunks with an online
log-sum-exp, and the backward computes each chunk's logits again, so the
``[B·S, V]`` logits never exist in any precision (the JAX package's
``_fused_nll_logz`` custom VJP, ``loss.py:150-297``); at tensor > 1 it
raises NotImplementedError (ROADMAP queue 1, item 6b part 3). The chunk products
are plain ``torch.matmul``, as the JAX package computes them in XLA. The
masked-LM loss of the bert family is ported with a later slice.
"""
from __future__ import annotations

import math
import os

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

IGNORE_INDEX = -100
NEG_INF_F32 = float(torch.finfo(torch.float32).min)


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
    """(labelled tokens, at least 1; the ranks that split the batch): over
    the data-parallel group and the seq axis when their scopes are open."""
    from ..comm.comm import (all_reduce, current_data_parallel,
                             current_sequence_parallel)

    count, ranks = mask.sum(), 1
    dp = current_data_parallel()
    if dp is not None:
        import torch.distributed as dist

        count = count.clone()
        dist.all_reduce(count, group=dp.group)
        ranks = dp.size
    sp = current_sequence_parallel()
    if sp is not None:
        count = all_reduce(count, sp.axis)
        ranks *= sp.size
    return torch.clamp(count, min=1), ranks


def cross_entropy_lm(logits: torch.Tensor, labels: torch.Tensor,
                     ignore_index: int = IGNORE_INDEX,
                     z_loss_weight: float = 0.0,
                     vocab_axis: str | None = None) -> torch.Tensor:
    """Mean next-token cross entropy. ``logits`` [B,S,V], ``labels`` [B,S]
    already shifted by the caller (labels[t] is the target for logits[t]).
    ``vocab_axis``: the logits are this rank's vocab shard [B,S,V/n] over
    that mesh axis (``parallel/sequence.vocab_parallel_nll_logz``); the
    loss, the same on every member, is the whole vocab's."""
    V = logits.shape[-1]
    N = math.prod(logits.shape[:-1])
    mask = labels != ignore_index
    denom, ranks = _denominator(mask)
    ce_chunk = int(os.environ.get("DS_TPU_CE_CHUNK", "0"))
    if vocab_axis is not None:
        from ..parallel.sequence import vocab_parallel_nll_logz

        piece = lambda lg, lb: vocab_parallel_nll_logz(lg, lb, vocab_axis)
        if not ce_chunk:
            nll, logz = piece(logits, torch.where(mask, labels, -1))
            return _masked_mean_loss(nll, logz, denom, z_loss_weight, ranks)
    else:
        piece = _nll_logz_piece
    if ce_chunk:
        chunk = min(ce_chunk, N)
        lab = torch.where(mask, labels, -1).reshape(N)
        lg = logits.reshape(N, V)
        pieces = [checkpoint(piece, lg[s:s + chunk], lab[s:s + chunk],
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


def _head_chunk(x2d, w, bias, c0: int, vchunk: int, w_is_ve: bool, V: int):
    """One vocab chunk's fp32 logits and its effective start: the tail
    chunk reads ``[V - vchunk, V)``, and the columns outside the logical
    range ``[c0, min(c0 + vchunk, V))``, which earlier chunks covered, are
    set to the most negative float."""
    c0_eff = min(c0, V - vchunk)
    if w_is_ve:
        wc = w[c0_eff:c0_eff + vchunk]
        lg = x2d @ wc.t()
    else:
        wc = w[:, c0_eff:c0_eff + vchunk]
        lg = x2d @ wc
    lg = lg.float()
    if bias is not None:
        lg = lg + bias[c0_eff:c0_eff + vchunk].float()[None, :]
    pos = c0_eff + torch.arange(vchunk, device=x2d.device)
    valid = (pos >= c0) & (pos < V)
    return torch.where(valid[None, :], lg, NEG_INF_F32), c0_eff, wc


class _FusedNllLogz(torch.autograd.Function):
    """Per-token (nll, logz) in fp32 from hidden states ``x2d`` [N, E] and
    the head weight ``w`` ([V, E] tied, or [E, V]), ``bias`` [V] or None,
    ``labels`` [N] (negative: masked)."""

    @staticmethod
    def forward(ctx, x2d, w, bias, labels, vchunk: int, w_is_ve: bool):
        N = x2d.shape[0]
        V = w.shape[0] if w_is_ve else w.shape[1]
        mask = labels >= 0
        safe = torch.where(mask, labels, 0)
        m = torch.full((N,), NEG_INF_F32, device=x2d.device)
        l = torch.zeros(N, device=x2d.device)
        true = torch.zeros(N, device=x2d.device)
        for c0 in range(0, V, vchunk):
            lg, c0_eff, _ = _head_chunk(x2d, w, bias, c0, vchunk, w_is_ve, V)
            m_new = torch.maximum(m, lg.max(dim=-1).values)
            l = l * torch.exp(m - m_new) + torch.exp(
                lg - m_new[:, None]).sum(dim=-1)
            in_chunk = (safe >= c0) & (safe < c0 + vchunk)
            idx = torch.clamp(safe - c0_eff, 0, vchunk - 1)
            true = true + torch.where(
                in_chunk, lg.gather(1, idx[:, None])[:, 0], 0.0)
            m = m_new
        logz = m + torch.log(l)
        ctx.save_for_backward(x2d, w, bias, labels, logz)
        ctx.vchunk, ctx.w_is_ve = vchunk, w_is_ve
        return (logz - true) * mask, logz * mask

    @staticmethod
    def backward(ctx, dnll, dlogz):
        x2d, w, bias, labels, logz = ctx.saved_tensors
        vchunk, w_is_ve = ctx.vchunk, ctx.w_is_ve
        N, E = x2d.shape
        V = w.shape[0] if w_is_ve else w.shape[1]
        mask = labels >= 0
        safe = torch.where(mask, labels, 0)
        coeff = (dnll + dlogz) * mask
        gn = dnll * mask
        dx = torch.zeros(N, E, device=x2d.device)
        dw = torch.zeros(w.shape, device=w.device)
        db = None if bias is None else torch.zeros(V, device=w.device)
        for c0 in range(0, V, vchunk):
            lg, c0_eff, wc = _head_chunk(x2d, w, bias, c0, vchunk, w_is_ve, V)
            d = torch.exp(lg - logz[:, None]) * coeff[:, None]
            in_chunk = (safe >= c0) & (safe < c0 + vchunk)
            hot = torch.where(in_chunk, safe - c0_eff, vchunk)
            onehot = F.one_hot(hot, vchunk + 1)[:, :vchunk].float()
            d = d - onehot * gn[:, None]
            d16 = d.to(x2d.dtype)
            if w_is_ve:
                dx += (d16 @ wc).float()
                dw[c0_eff:c0_eff + vchunk] += (d16.t() @ x2d).float()
            else:
                dx += (d16 @ wc.t()).float()
                dw[:, c0_eff:c0_eff + vchunk] += (x2d.t() @ d16).float()
            if db is not None:
                db[c0_eff:c0_eff + vchunk] += d.sum(dim=0)
        return (dx.to(x2d.dtype), dw.to(w.dtype),
                None if db is None else db.to(bias.dtype), None, None, None)


def fused_lm_head_loss(hidden: torch.Tensor, w: torch.Tensor,
                       labels: torch.Tensor, *,
                       bias: torch.Tensor | None = None,
                       ignore_index: int = IGNORE_INDEX,
                       z_loss_weight: float = 0.0, w_is_ve: bool = True,
                       vchunk: int | None = None) -> torch.Tensor:
    """Mean next-token cross entropy straight from hidden states [B, S, E]
    and the head weight, with no logits tensor: ``w_is_ve``: ``w`` is the
    tied embedding [V, E]; else the unembedding [E, V]. ``vchunk`` vocab
    columns a chunk (default ``DS_TPU_FUSED_HEAD_CHUNK``, else 8192)."""
    if vchunk is None:
        vchunk = int(os.environ.get("DS_TPU_FUSED_HEAD_CHUNK", "8192"))
    E = hidden.shape[-1]
    N = math.prod(hidden.shape[:-1])
    V = w.shape[0] if w_is_ve else w.shape[1]
    vchunk = min(int(vchunk), V)
    mask = labels != ignore_index
    denom, ranks = _denominator(mask)
    lab = torch.where(mask, labels, -1).reshape(N)
    nll, logz = _FusedNllLogz.apply(hidden.reshape(N, E), w, bias, lab,
                                    vchunk, w_is_ve)
    return _masked_mean_loss(nll, logz, denom, z_loss_weight, ranks)


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
    logits. ``DS_TPU_FUSED_HEAD_CHUNK=<vocab columns>`` takes a
    ``TransformerLM``'s loss through :func:`fused_lm_head_loss`."""
    from .transformer import TransformerLM

    input_ids = batch["input_ids"]
    labels = batch.get("labels")
    if labels is None:
        from ..comm.comm import current_sequence_parallel

        if current_sequence_parallel() is not None:
            raise ValueError("a sequence-parallel rank's labels come with "
                             "its slice: shift whole rows first")
        labels = shift_labels(input_ids)
    if not isinstance(model, TransformerLM):
        return cross_entropy_lm(model(input_ids), labels)
    from ..comm.comm import current_tensor_parallel

    tp = current_tensor_parallel()
    vchunk = int(os.environ.get("DS_TPU_FUSED_HEAD_CHUNK") or 0)
    if vchunk > 0 and tp is not None:
        raise NotImplementedError(
            f"the fused vocab-chunked head (DS_TPU_FUSED_HEAD_CHUNK) at "
            f"tensor {tp.size} is ported with ROADMAP queue 1, item 6b "
            f"part 3")
    out, layer_losses = model(input_ids, return_losses=True,
                              noise_seed=batch.get("_gating_seed"),
                              return_hidden=vchunk > 0)
    if vchunk > 0:
        cfg, dt = model.config, model.config.dtype
        w, w_is_ve = (model.embed, True) if cfg.tie_embeddings \
            else (model.unembed, False)
        bias = model.unembed_b.to(dt) if cfg.unembed_bias else None
        loss = fused_lm_head_loss(out, w.to(dt), labels, bias=bias,
                                  w_is_ve=w_is_ve, vchunk=vchunk)
    else:
        sharded = tp is not None and out.shape[-1] != model.config.vocab_size
        loss = cross_entropy_lm(out, labels,
                                vocab_axis=tp.axis if sharded else None)
    for aux in layer_losses:
        loss = loss + aux
    return loss


#: it reads the sequence- and tensor-parallel scopes (the engine accepts it
#: at seq > 1 and at tensor > 1)
lm_loss_fn.sequence_parallel = True
lm_loss_fn.tensor_parallel = True
