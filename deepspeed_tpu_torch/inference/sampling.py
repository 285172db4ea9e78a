"""Token sampling for generation.

Counterpart of ``deepspeed_tpu/inference/sampling.py``. Greedy is
``argmax``, whose first-index tie-break is ``jnp.argmax``'s, so greedy
streams are comparable across the two packages. Stochastic sampling draws
from an explicit ``torch.Generator``; its numbers differ from JAX's
threefry stream, so only distributions compare.

Every step is capturable in a CUDA graph (``inference/programs.py``): no
tensor is made from host values, and ``torch.multinomial`` captures. A
graph that registers the generator advances it on every replay, so each
replay draws new numbers.
"""
from __future__ import annotations

import torch


def sample_logits(logits: torch.Tensor, generator: torch.Generator | None,
                  *, temperature: float = 1.0, top_k: int = 0,
                  top_p: float = 1.0, greedy: bool = False) -> torch.Tensor:
    """logits [B, V] → token ids [B] (int64)."""
    if greedy or temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    logits = logits.float() / max(temperature, 1e-6)
    neg_inf = float("-inf")
    use_k = bool(top_k and top_k > 0)
    use_p = top_p < 1.0
    if use_k and not use_p:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, neg_inf, logits)
    elif use_p:
        # one descending sort serves both filters
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        if use_k:
            kth = sorted_logits[..., top_k - 1:top_k]
            logits = torch.where(logits < kth, neg_inf, logits)
            keep = torch.arange(sorted_logits.shape[-1],
                                device=logits.device) < top_k
            sorted_logits = torch.where(keep, sorted_logits, neg_inf)
        cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
        # smallest set whose cumulative prob >= top_p; keep at least 1
        cutoff_idx = (cum < top_p).sum(dim=-1, keepdim=True)
        cutoff = torch.gather(sorted_logits, -1, cutoff_idx)
        logits = torch.where(logits < cutoff, neg_inf, logits)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def sample_tree_logits(logits: torch.Tensor,
                       generator: torch.Generator | None, *,
                       temperature: float = 1.0, top_k: int = 0,
                       top_p: float = 1.0, greedy: bool = False
                       ) -> torch.Tensor:
    """Verify-step sampling: ``[S, T, V]`` per-tree-node logits → ``[S, T]``
    target samples, every node drawn independently with the same filters as
    :func:`sample_logits`. The acceptance walk keeps a node's sample only
    when its parent's sample matched, so each kept token is conditioned as
    the serial chain would be; greedy is per-node argmax, identical to
    plain greedy decode."""
    S, T, V = logits.shape
    flat = sample_logits(logits.reshape(S * T, V), generator,
                         temperature=temperature, top_k=top_k, top_p=top_p,
                         greedy=greedy)
    return flat.reshape(S, T)
