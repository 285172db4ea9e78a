"""Sequence parallelism: Ulysses all-to-all attention, ring attention,
gang-segment attention and vocab-parallel cross entropy.

Counterpart of ``deepspeed_tpu/parallel/sequence.py``. The JAX module's
functions take global arrays and a ``mesh`` and run their bodies per shard
under ``shard_map``; here each process is one shard already, so the same
functions take this rank's shards and the mesh axis's name (``axis``,
resolved to its process group through the topology the engine registered,
``comm.set_topology``). Each rank passes its own slice of the sequence and
gets its own slice back:

- :func:`ulysses_attention` / :class:`DistributedAttention`: an all-to-all
  turns ``[B, S/n, H, D]`` (sequence-sharded) into ``[B, S, H/n, D]``
  (head-sharded), any local attention runs over the whole sequence, and the
  inverse all-to-all turns the output back. The default local attention is
  ``ops/attention.dot_product_attention`` with ``allow_multi_device``: the
  flash kernel K4 on each rank at its own ``H/n`` heads wherever its gate
  holds;
- :func:`ring_attention`: blockwise attention with an fp32 online softmax,
  the K/V blocks rotating round the axis (``comm.send_recv_next``); the
  causal mask is on global positions. The JAX body is einsums, and so is
  this one;
- :func:`gang_segment_attention`: the same blockwise algebra for one
  contiguous segment of a prompt over the KV of every earlier segment
  (serving's gang prefill);
- :func:`vocab_parallel_cross_entropy`: cross entropy over vocab-sharded
  logits without the full softmax on any rank; :func:`vocab_parallel_nll_logz`
  gives its per-token terms and log-partition, the training loss's route
  at ``tensor`` > 1 (``models/loss.py``).

Every exchange is differentiable (``comm``'s all-to-all, all-gather and
ring shifts carry their transposes), so each function's gradient on a rank
is the gradient of the global result with respect to that rank's shards.

The training model's route is :func:`ulysses_model_attention`: the JAX
model shards heads over ``seq`` inside attention (``models/transformer.py``
of the JAX package, ``:334-337``), where K/V are head-sharded only when
KV == H and stay whole otherwise; here K/V go through the all-to-all
whenever their heads divide the axis, and are gathered over the sequence
(each local query head paired with its own KV head) when they do not, with
the same result.
"""
from __future__ import annotations

import functools
from typing import Callable

import torch

from .. import comm

NEG_INF = float(torch.finfo(torch.float32).min)


# ---------------------------------------------------------------------------
# Ulysses
# ---------------------------------------------------------------------------

def _ulysses_body(q, k, v, *, axis: str, attn_fn: Callable,
                  gather_kv: bool = False):
    """q/k/v: this rank's [B, S/n, H|KV, D] → its [B, S/n, H, D]. With
    ``gather_kv`` K/V are gathered over the sequence and each of this
    rank's query heads gets its own KV head, for KV heads that do not
    divide the axis."""
    # seq-shard → head-shard (reference _SeqAllToAll scatter_idx=2 :90)
    q = comm.all_to_all(q, axis, split_axis=2, concat_axis=1)
    if gather_kv:
        n, r = comm.axis_size(axis), comm.axis_index(axis)
        H, KV = q.shape[2] * n, k.shape[2]
        heads = torch.arange(r * q.shape[2], (r + 1) * q.shape[2],
                             device=k.device) // (H // KV)
        k = comm.all_gather(k, axis, axis=1).index_select(2, heads)
        v = comm.all_gather(v, axis, axis=1).index_select(2, heads)
    else:
        k = comm.all_to_all(k, axis, split_axis=2, concat_axis=1)
        v = comm.all_to_all(v, axis, split_axis=2, concat_axis=1)
    out = attn_fn(q, k, v)
    # head-shard → seq-shard (gather_idx=1)
    return comm.all_to_all(out, axis, split_axis=1, concat_axis=2)


def _default_attn(causal: bool) -> Callable:
    from ..ops.attention import dot_product_attention

    # per rank over its own heads: K4 may serve in a world of many
    return functools.partial(dot_product_attention, causal=causal,
                             allow_multi_device=True)


def ulysses_attention(q, k, v, axis: str = "seq", *,
                      attn_fn: Callable | None = None, causal: bool = True):
    """Ulysses attention over the mesh axis ``axis``.

    q: this rank's [B, S/n, H, D]; k/v: [B, S/n, KV, D], rank i holding
    positions [i*S/n, (i+1)*S/n). H and KV must be divisible by the axis
    size. Returns this rank's [B, S/n, H, D]."""
    if attn_fn is None:
        attn_fn = _default_attn(causal)
    n = comm.axis_size(axis)
    if q.shape[2] % n or k.shape[2] % n:
        raise ValueError(
            f"num heads {q.shape[2]}/{k.shape[2]} not divisible by "
            f"seq-parallel degree {n}; pad or repeat KV heads first")
    return _ulysses_body(q, k, v, axis=axis, attn_fn=attn_fn)


def ulysses_model_attention(q, k, v, axis: str, attn_fn: Callable):
    """The training model's Ulysses route (see the module docstring):
    query heads must divide the axis; KV heads that do not are gathered."""
    n = comm.axis_size(axis)
    if q.shape[2] % n:
        raise ValueError(
            f"num heads {q.shape[2]} not divisible by seq-parallel degree "
            f"{n}")
    return _ulysses_body(q, k, v, axis=axis, attn_fn=attn_fn,
                         gather_kv=k.shape[2] % n != 0)


class DistributedAttention:
    """API-parity shim for reference sequence/layer.py:145.

    Wraps any local attention callable; __call__ takes this rank's
    sequence-sharded q/k/v and returns its sequence-sharded output.
    """

    def __init__(self, local_attention: Callable, axis: str = "seq"):
        self.local_attn = local_attention
        self.axis = axis

    def __call__(self, query, key, value, *args, **kwargs):
        if args or kwargs:
            # extra args go AFTER q/k/v, matching the reference signature
            def attn(q, k, v):
                return self.local_attn(q, k, v, *args, **kwargs)
        else:
            attn = self.local_attn
        return ulysses_attention(query, key, value, self.axis, attn_fn=attn)


# ---------------------------------------------------------------------------
# blockwise online softmax (ring and gang segments)
# ---------------------------------------------------------------------------

def _fold(carry, qg, k_blk, v_blk, allow, scale: float):
    """One block of the fp32 online softmax: ``qg`` [B, S, KV, G, D],
    ``k_blk`` / ``v_blk`` [B, Sk, KV, D], ``allow`` [Sq, Sk] or None."""
    m, l, acc = carry
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k_blk.float()) * scale
    if allow is not None:
        s = torch.where(allow[None, None, None], s, NEG_INF)
    m_cur = s.amax(dim=-1, keepdim=True)
    m_new = torch.maximum(m, m_cur)
    # guard fully-masked blocks (exp(NEG_INF - NEG_INF) would be 1)
    p = torch.where(s == NEG_INF, 0.0, torch.exp(s - m_new))
    alpha = torch.where(m == NEG_INF, 0.0, torch.exp(m - m_new))
    l = alpha * l + p.sum(dim=-1, keepdim=True)
    acc = acc * alpha + torch.einsum("bhgqk,bkhd->bhgqd", p, v_blk.float())
    return m_new, l, acc


def _online_start(q, KV: int):
    B, S, H, D = q.shape
    G = H // KV
    qg = q.float().reshape(B, S, KV, G, D)
    m = torch.full((B, KV, G, S, 1), NEG_INF, device=q.device)
    l = torch.zeros((B, KV, G, S, 1), device=q.device)
    acc = torch.zeros((B, KV, G, S, D), device=q.device)
    return qg, (m, l, acc)


def _online_finish(q, l, acc):
    B, S, H, D = q.shape
    l_safe = torch.where(l == 0.0, 1.0, l)
    out = (acc / l_safe).to(q.dtype)                     # [B,KV,G,S,D]
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, H, D)


# ---------------------------------------------------------------------------
# Ring attention (context parallelism)
# ---------------------------------------------------------------------------

def ring_attention(q, k, v, axis: str = "seq", *, causal: bool = True,
                   scale: float | None = None):
    """Ring (context-parallel) attention over the mesh axis ``axis``.

    q: this rank's [B, S_loc, H, D]; k/v: [B, S_loc, KV, D]; rank i owns
    global positions [i*S_loc, (i+1)*S_loc). K/V blocks rotate rightward
    round the ring, un-repeated (GQA folds H into KV groups), so a rank
    holds one block pair at a time. Returns this rank's [B, S_loc, H, D].
    """
    n, idx = comm.axis_size(axis), comm.axis_index(axis)
    B, S, H, D = q.shape
    KV = k.shape[2]
    scale = 1.0 / (D ** 0.5) if scale is None else float(scale)
    qg, carry = _online_start(q, KV)
    q_pos = idx * S + torch.arange(S, device=q.device)
    for step in range(n):
        src = (idx - step) % n                           # owner of this k/v
        allow = None
        if causal:
            kv_pos = src * S + torch.arange(S, device=q.device)
            allow = kv_pos[None, :] <= q_pos[:, None]    # [S_q, S_k]
        carry = _fold(carry, qg, k, v, allow, scale)
        if step != n - 1:
            k = comm.send_recv_next(k, axis)             # rotate rightward
            v = comm.send_recv_next(v, axis)
    return _online_finish(q, carry[1], carry[2])


# ---------------------------------------------------------------------------
# Gang-prefill segment attention (context parallelism across a FLEET)
# ---------------------------------------------------------------------------

def gang_segment_attention(q, k_prefix, v_prefix, k_own, v_own, *,
                           scale: float | None = None, block: int = 512):
    """Causal attention for ONE gang-prefill segment: context parallelism
    where the "devices" are serving replicas and the "rotation" is the
    staged KV hop between them (``serving/router.py`` gang prefill).

    ``q``: [B, S_seg, H, D], the segment's queries. ``k_prefix`` /
    ``v_prefix``: [B, S_pre, KV, D], KV for every EARLIER segment (None for
    gang member 0). ``k_own`` / ``v_own``: [B, S_seg, KV, D], this
    segment's KV. Every prefix key precedes every query, so the prefix
    blocks fold in unmasked and only the own block carries a causal mask:
    the result equals rows [S_pre, S_pre + S_seg) of full causal attention
    over the concatenated sequence. GQA folds H into KV groups as the ring
    does."""
    B, S, H, D = q.shape
    KV = k_own.shape[2]
    if H % KV:
        raise ValueError(f"heads {H} not divisible by kv heads {KV}")
    scale = 1.0 / (D ** 0.5) if scale is None else float(scale)
    qg, carry = _online_start(q, KV)
    S_pre = 0 if k_prefix is None else k_prefix.shape[1]
    for lo in range(0, S_pre, block):
        hi = min(lo + block, S_pre)
        carry = _fold(carry, qg, k_prefix[:, lo:hi], v_prefix[:, lo:hi],
                      None, scale)
    pos = torch.arange(S, device=q.device)
    allow = pos[None, :] <= pos[:, None]                 # [S_q, S_k]
    carry = _fold(carry, qg, k_own, v_own, allow, scale)
    return _online_finish(q, carry[1], carry[2])


# ---------------------------------------------------------------------------
# Vocab-parallel cross entropy (reference sequence/cross_entropy.py)
# ---------------------------------------------------------------------------

class _ReplicatedSum(torch.autograd.Function):
    """The sum over an axis of values whose consumer is the same on every
    member (the loss is replicated): each member's gradient is the
    upstream gradient itself."""

    @staticmethod
    def forward(ctx, x, axis):
        return comm.all_reduce(x, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None


def vocab_parallel_nll_logz(logits, labels, axis: str = "tensor"):
    """Per-token fp32 ``(nll, logz)`` of vocab-sharded logits, masked where
    ``labels`` is negative (0 there), the same on every member of
    ``axis``: ``logits`` is this rank's [..., V/n] (rank i holding vocab
    ids [i*V/n, (i+1)*V/n)), ``labels`` the matching global ids. The
    gradient on a rank is its vocab shard of plain cross entropy's (and of
    the log-partition's: the max shift is a constant for both)."""
    idx = comm.axis_index(axis)
    V_loc = logits.shape[-1]
    lo = idx * V_loc

    logits = logits.float()
    gmax = comm.all_reduce(logits.detach().amax(dim=-1), axis, op="max")
    sumexp = torch.exp(logits - gmax[..., None]).sum(dim=-1)
    gsum = _ReplicatedSum.apply(sumexp, axis)

    in_shard = (labels >= lo) & (labels < lo + V_loc)
    local_label = torch.clamp(labels - lo, 0, V_loc - 1)
    picked = logits.gather(-1, local_label[..., None])[..., 0]
    target = _ReplicatedSum.apply(torch.where(in_shard, picked, 0.0), axis)

    mask = labels >= 0
    logz = torch.log(gsum) + gmax
    return (logz - target) * mask, logz * mask


def vocab_parallel_cross_entropy(logits, labels, axis: str = "tensor", *,
                                 ignore_index: int = -100,
                                 seq_axis: str | None = None):
    """Mean cross entropy over vocab-sharded logits without the full
    softmax on any rank. ``logits``: this rank's [B, S_loc, V/n] (rank i
    holding vocab ids [i*V/n, (i+1)*V/n)); ``labels``: the matching
    [B, S_loc] global ids. ``seq_axis`` also shards the sequence dim: the
    masked mean then spans every seq shard (ignored labels may fall
    unevenly). Returns the global loss on every rank; its gradient on a
    rank is that rank's vocab shard of plain cross entropy's (the max shift
    is a constant for it)."""
    mask = labels != ignore_index
    nll, _ = vocab_parallel_nll_logz(logits, torch.where(mask, labels, -1),
                                     axis)
    num, den = nll.sum(), mask.float().sum()
    if seq_axis is not None:
        num = _ReplicatedSum.apply(num, seq_axis)
        den = comm.all_reduce(den, seq_axis)
    return num / torch.clamp(den, min=1.0)


__all__ = ["DistributedAttention", "gang_segment_attention",
           "ring_attention", "ulysses_attention", "ulysses_model_attention",
           "vocab_parallel_cross_entropy", "vocab_parallel_nll_logz"]
