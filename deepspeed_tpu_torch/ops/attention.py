"""Dense attention in plain PyTorch ops.

Counterpart of ``_xla_attention`` (``deepspeed_tpu/ops/attention.py:16``):
fp32 softmax, GQA by repeating K/V heads, causal / decode-position /
sliding-window / padding masks and an additive bias (ALiBi). It is the
numerics oracle of the dense model forward. The JAX dispatcher's flash
route (the Pallas flash kernel, K4) is ported with the training slice; until
then every call runs this plain version.
"""
from __future__ import annotations

import torch


def dot_product_attention(q, k, v, *, causal: bool = True, positions=None,
                          kv_len=None, mask=None, bias=None,
                          window: int | None = None):
    """q: [B, Sq, H, D]; k/v: [B, Skv, KV, D] (KV divides H for GQA).

    ``positions`` [B, Sq] places each query at an absolute position (the
    cached/decode form); ``kv_len`` bounds the valid keys; ``window`` is
    the mistral sliding window (query p attends keys in (p - window, p]);
    ``mask`` [B, Skv] (1 = attend) or broadcastable; ``bias`` is added to
    the fp32 logits, broadcastable to [B, H, Sq, Skv]."""
    if window and positions is None and not causal:
        raise ValueError("sliding_window requires causal attention")
    B, Sq, H, D = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    scale = 1.0 / (D ** 0.5)
    if KV != H:
        k = k.repeat_interleave(H // KV, dim=2)
        v = v.repeat_interleave(H // KV, dim=2)
    logits = torch.einsum("bqhd,bkhd->bhqk", q, k).float() * scale

    kv_pos = torch.arange(Skv, device=q.device)[None, None, None, :]
    neg = torch.finfo(torch.float32).min
    allow = None
    if positions is not None:
        q_pos = positions[:, None, :, None]
        allow = kv_pos <= q_pos
        if kv_len is not None:
            kl = torch.as_tensor(kv_len, device=q.device)
            allow = allow & (kv_pos < (kl if kl.ndim == 0
                                       else kl[:, None, None, None]))
        if window:
            allow = allow & (kv_pos > q_pos - window)
    elif causal:
        q_pos = torch.arange(Sq, device=q.device)[None, None, :, None]
        allow = kv_pos <= q_pos
        if window:
            allow = allow & (kv_pos > q_pos - window)
    if allow is not None:
        logits = logits.masked_fill(~allow, neg)
    if mask is not None:
        m = mask[:, None, None, :] if mask.ndim == 2 else mask
        logits = logits.masked_fill(~m.bool(), neg)
    if bias is not None:
        logits = logits + bias.float()
    weights = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", weights.to(v.dtype), v)
