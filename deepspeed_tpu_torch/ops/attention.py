"""Attention op dispatcher.

Counterpart of ``deepspeed_tpu/ops/attention.py``: one entry point,
:func:`dot_product_attention`, that routes a call to
- the flash-attention kernel K4 (``ops/flash_attention.py``) when its gate
  holds and ``impl`` is "auto" or "pallas" ("pallas" names K4 in both
  packages, so a config means the same in each), or
- :func:`plain_attention`, the counterpart of ``_xla_attention``: fp32
  softmax, GQA by repeating K/V heads, causal / decode-position /
  sliding-window / padding masks and an additive bias (ALiBi). It is the
  reference's own XLA route (``impl="xla"``, a window, a bias, or a call
  the gate refuses) and the numerics oracle of the dense model forward.
"""
from __future__ import annotations

import torch


def dot_product_attention(q, k, v, *, causal: bool = True, positions=None,
                          kv_len=None, mask=None, bias=None,
                          impl: str = "auto", window: int | None = None,
                          allow_multi_device: bool = False):
    """q: [B, Sq, H, D]; k/v: [B, Skv, KV, D] (KV divides H for GQA).

    ``positions`` [B, Sq] places each query at an absolute position (the
    cached/decode form); ``kv_len`` bounds the valid keys; ``window`` is
    the mistral sliding window (query p attends keys in (p - window, p]);
    ``mask`` [B, Skv] (1 = attend) or broadcastable; ``bias`` is added to
    the fp32 logits, broadcastable to [B, H, Sq, Skv]. ``impl``: "auto" |
    "pallas" (K4, or ValueError where its gate refuses) | "xla" (plain).
    ``allow_multi_device`` must only be set by a caller that runs on its
    own rank's whole heads (``parallel/sequence.py``'s Ulysses): the gate
    otherwise refuses K4 in a world of more than one process, as the JAX
    gate does; ``impl="pallas"`` alone does not opt in."""
    if window and positions is None and not causal:
        raise ValueError("sliding_window requires causal attention")
    if impl not in ("auto", "pallas", "xla"):
        raise ValueError(f"unknown attention impl '{impl}'")
    if impl in ("auto", "pallas") and bias is None and not window:
        from .flash_attention import flash_attention, flash_attention_usable

        if flash_attention_usable(q, k, v, causal=causal, positions=positions,
                                  mask=mask,
                                  allow_multi_device=allow_multi_device):
            return flash_attention(q, k, v, causal=causal)
        if impl == "pallas":
            raise ValueError("pallas flash attention not usable for these "
                             "inputs")
    elif impl == "pallas":
        raise ValueError("pallas flash attention has no additive-bias or "
                         "sliding-window path yet (these run XLA attention)")
    return plain_attention(q, k, v, causal=causal, positions=positions,
                           kv_len=kv_len, mask=mask, bias=bias, window=window)


def plain_attention(q, k, v, *, causal: bool = True, positions=None,
                    kv_len=None, mask=None, bias=None,
                    window: int | None = None):
    """The dense plain-torch route (``_xla_attention``), same arguments as
    :func:`dot_product_attention` less ``impl``."""
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
