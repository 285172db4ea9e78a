"""Flash attention, forward and backward, for training (K4).

Counterpart of ``deepspeed_tpu/ops/pallas/flash_attention.py``: the gate
:func:`flash_attention_usable` (the JAX gate condition for condition, so the
port claims exactly the calls the reference claims) and
:func:`flash_attention`, an autograd function over q ``[B, Sq, H, D]`` and
k/v ``[B, Skv, KV, D]`` (KV divides H) in the public layout of
``ops/attention.py``.

- On CUDA tensors the forward launches the hand-written Hopper kernel
  ``ds_flash_attention_fwd`` and the backward ``ds_flash_attention_bwd``
  (``csrc/flash_attention.cu``: a dq kernel and a dk/dv kernel that sums
  each GQA group in place), or raise; they never switch to the plain
  version. bf16 runs on the tensor cores (wgmma on tiles TMA loads; S at
  least 128), fp32 on the CUDA cores in full fp32.
- On CPU tensors they run :func:`flash_fwd_plain` and
  :func:`flash_bwd_plain`, the plain versions: dense fp32 scores, the lse
  of the forward, and a backward from ``delta = rowsum(dO * O)`` and the
  saved lse, as the Pallas ``_bwd`` computes it (the forward is not redone
  through autograd).

The autograd function saves (q, k, v, out, lse), never the probabilities.
Under ``torch.utils.checkpoint`` the forward runs again in the backward, so
a checkpointed layer launches the forward twice per micro-batch.

``counts`` holds the calls of each route: ``fwd`` and ``bwd`` count
launches of the CUDA forward and backward (the backward's two kernels count
once), ``plain`` and ``plain_bwd`` the CPU route's calls.
"""
from __future__ import annotations

from dataclasses import dataclass, fields

import torch

#: the Pallas block policy, kept so the gate refuses what the JAX gate
#: refuses (``flash_attention.py:45-62``); the CUDA kernel's own tiles do not
#: depend on it
DEFAULT_BLOCK_Q = 1024
#: below this the JAX dispatcher takes its XLA route, and so does the port;
#: it is also the bf16 kernels' shortest sequence (the rows of one tile)
MIN_SEQ = 128
_FAST_BLOCKS = (1024, 512, 256)
VMEM_BUDGET_BYTES = 24 * 1024 * 1024
#: head dims the kernel is instantiated for (the JAX gate's set)
HEAD_DIMS = (64, 128, 256)
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@dataclass
class LaunchCounts:
    """Calls of K4 by route (see the module docstring)."""
    fwd: int = 0
    bwd: int = 0
    plain: int = 0
    plain_bwd: int = 0

    def reset(self) -> None:
        for f in fields(self):
            setattr(self, f.name, 0)


counts = LaunchCounts()


# ---------------------------------------------------------------------------
# the gate (the JAX package's, condition for condition)
# ---------------------------------------------------------------------------

def _vmem_estimate(bq: int, bk: int, d: int, dtype_bytes: int) -> int:
    inter = 4 * bq * bk * 4
    blocks = 2 * (2 * bq * d + 2 * bk * d) * dtype_bytes
    scratch = (bq + bk) * d * 4
    return inter + blocks + scratch


def _pick_block(seq: int) -> int | None:
    if seq <= DEFAULT_BLOCK_Q:
        return seq
    for cand in _FAST_BLOCKS:
        if seq % cand == 0:
            return cand
    return None


def _pick_blocks(Sq: int, Skv: int, d: int, dtype_bytes: int
                 ) -> tuple[int, int] | None:
    """The Pallas launcher's default (block_q, block_k), or None where it
    has none: the gate's divisibility and VMEM-budget condition."""
    bq = _pick_block(Sq)
    bk = _pick_block(Skv)
    if bq is None or bk is None:
        return None

    def next_down(cur, seq):
        for cand in _FAST_BLOCKS:
            if cand < cur and seq % cand == 0:
                return cand
        return None

    while _vmem_estimate(bq, bk, d, dtype_bytes) > VMEM_BUDGET_BYTES:
        # shrink the larger block first, as the Pallas launcher does
        order = ("q", "k") if bq >= bk else ("k", "q")
        for axis in order:
            if axis == "q":
                nxt = next_down(bq, Sq)
                if nxt is not None:
                    bq = nxt
                    break
            else:
                nxt = next_down(bk, Skv)
                if nxt is not None:
                    bk = nxt
                    break
        else:
            return None
    return bq, bk


def _world_size() -> int:
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def flash_attention_usable(q, k, v, *, causal: bool, positions=None,
                           mask=None, allow_multi_device: bool = False
                           ) -> bool:
    """Whether the dispatcher claims K4: full-sequence self-attention
    (Sq == Skv >= 128, no positions or mask), a Pallas block choice, whole
    GQA groups, D in (64, 128, 256), and one process. ``allow_multi_device``
    lifts the last condition; only a caller that runs attention on its own
    rank's whole heads sets it (Ulysses, ``parallel/sequence.py``), as in
    the JAX gate."""
    if _world_size() > 1 and not allow_multi_device:
        return False
    if positions is not None or mask is not None:
        return False
    B, Sq, H, D = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    if Sq != Skv or Sq < MIN_SEQ:
        return False
    if _pick_blocks(Sq, Skv, D, q.dtype.itemsize) is None:
        return False
    if H % KV != 0:
        return False
    return D in HEAD_DIMS


# ---------------------------------------------------------------------------
# plain versions ([B, H, S, D] layout, as the kernel's)
# ---------------------------------------------------------------------------

def _scores(qb, kb, causal: bool, scale: float) -> torch.Tensor:
    """fp32 scores [H, S, S] of one batch row, -inf above the diagonal."""
    s = (qb @ kb.transpose(-1, -2)) * scale
    if causal:
        S = s.shape[-1]
        above = torch.ones(S, S, dtype=torch.bool, device=s.device).triu_(1)
        s = s.masked_fill(above, float("-inf"))
    return s


def flash_fwd_plain(q, k, v, causal: bool = True, scale: float | None = None):
    """(out [B, H, S, D] in q's dtype, lse [B, H, S] fp32) from q
    [B, H, S, D] and k/v [B, KV, S, D]: fp32 scores and softmax, one batch
    row at a time (K/V repeated per q head: a plain version may)."""
    B, H, S, D = q.shape
    G = H // k.shape[1]
    scale = 1.0 / (D ** 0.5) if scale is None else scale
    outs, lses = [], []
    for b in range(B):
        kb = k[b].float().repeat_interleave(G, dim=0)
        vb = v[b].float().repeat_interleave(G, dim=0)
        s = _scores(q[b].float(), kb, causal, scale)
        lse = torch.logsumexp(s, dim=-1)
        p = torch.exp(s - lse[..., None])
        outs.append((p @ vb).to(q.dtype))
        lses.append(lse)
    return torch.stack(outs), torch.stack(lses)


def attention_delta(out, dout) -> torch.Tensor:
    """``delta = rowsum(dO * O)`` in fp32, [B, H, S] (the JAX package makes
    it in XLA before its backward kernels, as the port does before its).
    ``out`` is upcast inside the product, which saves one fp32 copy; the
    products of bf16 values are exact in fp32 either way."""
    return (dout.float() * out).sum(dim=-1)


def flash_bwd_plain(q, k, v, out, lse, dout, causal: bool = True,
                    scale: float | None = None):
    """(dq, dk, dv) from the forward's inputs, out and lse: p = exp(s -
    lse), ds = p * (dp - delta) * scale with delta = rowsum(dO * O); dk/dv
    summed over each GQA group. Grads in their inputs' dtypes."""
    B, H, S, D = q.shape
    KV = k.shape[1]
    G = H // KV
    scale = 1.0 / (D ** 0.5) if scale is None else scale
    delta = attention_delta(out, dout)
    dqs, dks, dvs = [], [], []
    for b in range(B):
        qb, dob = q[b].float(), dout[b].float()
        kb = k[b].float().repeat_interleave(G, dim=0)
        vb = v[b].float().repeat_interleave(G, dim=0)
        p = torch.exp(_scores(qb, kb, causal, scale) - lse[b].float()[..., None])
        dv_h = p.transpose(-1, -2) @ dob
        dp = dob @ vb.transpose(-1, -2)
        ds = p * (dp - delta[b][..., None]) * scale
        dqs.append((ds @ kb).to(q.dtype))
        dk_h = ds.transpose(-1, -2) @ qb
        dks.append(dk_h.reshape(KV, G, S, D).sum(dim=1).to(k.dtype))
        dvs.append(dv_h.reshape(KV, G, S, D).sum(dim=1).to(v.dtype))
    return torch.stack(dqs), torch.stack(dks), torch.stack(dvs)


# ---------------------------------------------------------------------------
# the wrappers: the kernel on CUDA tensors, the plain version on CPU ones
# ---------------------------------------------------------------------------

def _check(q, k, v) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"q [B, H, S, D] and k/v [B, KV, S, D] expected, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, H, S, D = q.shape
    if k.shape[0] != B or k.shape[2] != S or k.shape[3] != D:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)} (self-attention: Sq == Skv)")
    if H % k.shape[1]:
        raise ValueError(f"GQA requires num q heads ({H}) divisible by kv "
                         f"heads ({k.shape[1]})")


def _kernel_operands(dtype, *tensors) -> None:
    if dtype not in _KERNEL_DTYPES:
        raise ValueError(f"kernel dtype must be float32 or bfloat16, got "
                         f"{dtype}")
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"operands on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError("operands must be contiguous")


def _kernel_shape(q) -> None:
    D, S = q.shape[3], q.shape[2]
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} not in {HEAD_DIMS}")
    if q.dtype == torch.bfloat16 and S < MIN_SEQ:
        raise ValueError(f"the bf16 kernel takes S >= {MIN_SEQ}, got {S}")


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def flash_fwd(q, k, v, causal: bool, scale: float):
    """(out, lse) of the forward: the kernel on CUDA tensors, the plain
    version on CPU tensors."""
    _check(q, k, v)
    if q.device.type == "cpu":
        counts.plain += 1
        return flash_fwd_plain(q, k, v, causal, scale)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    B, H, S, D = q.shape
    _kernel_shape(q)
    _kernel_operands(q.dtype, q, k, v)
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("q, k and v must share one dtype on the card")
    from . import kernels

    out = torch.empty_like(q)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    err = kernels.load("flash_attention").ds_flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), B, H, k.shape[1], S, D, float(scale), int(causal),
        _KERNEL_DTYPES[q.dtype], _stream(q.device))
    if err != 0:
        raise RuntimeError(f"flash-attention forward launch failed: CUDA "
                           f"error {err}")
    counts.fwd += 1
    return out, lse


def flash_bwd(q, k, v, out, lse, dout, causal: bool, scale: float):
    """(dq, dk, dv) of the backward: the kernels on CUDA tensors (counted
    once), the plain version on CPU tensors."""
    _check(q, k, v)
    if q.device.type == "cpu":
        counts.plain_bwd += 1
        return flash_bwd_plain(q, k, v, out, lse, dout, causal, scale)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    B, H, S, D = q.shape
    _kernel_shape(q)
    dout = dout.to(q.dtype).contiguous()
    _kernel_operands(q.dtype, q, k, v, out, dout)
    lse = lse.float().contiguous()
    delta = attention_delta(out, dout).contiguous()
    from . import kernels

    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    err = kernels.load("flash_attention").ds_flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), B, H, k.shape[1], S, D, float(scale), int(causal),
        _KERNEL_DTYPES[q.dtype], _stream(q.device))
    if err != 0:
        raise RuntimeError(f"flash-attention backward launch failed: CUDA "
                           f"error {err}")
    counts.bwd += 1
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """K4 over [B, H, S, D] q and [B, KV, S, D] k/v (contiguous); saves
    (q, k, v, out, lse) for the backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: float):
        out, lse = flash_fwd(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_bwd(q, k, v, out, lse, dout, ctx.causal,
                               ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, *, causal: bool = True,
                    scale: float | None = None) -> torch.Tensor:
    """q [B, S, H, D]; k/v [B, S, KV, D] → [B, S, H, D] in q's dtype."""
    D = q.shape[-1]
    scale = 1.0 / (D ** 0.5) if scale is None else float(scale)
    qt = q.transpose(1, 2).contiguous()
    kt = k.transpose(1, 2).contiguous()
    vt = v.transpose(1, 2).contiguous()
    return FlashAttention.apply(qt, kt, vt, causal, scale).transpose(1, 2)
