"""Ragged paged attention over a read-only KV pool plus a staged tail (K1).

Counterpart of ``paged_ragged_attention`` in
``deepspeed_tpu/ops/pallas/paged_attention.py``, with the same signature and
layouts: q ``[S, T, H, D]``, pool ``[L, 2, KV, nb, bs, D]``, stage
``[S, KV, Ts, D]``, output ``[S, T, H, D]``.

- On CUDA tensors, :func:`paged_ragged_attention` launches the hand-written
  Hopper kernel (``csrc/paged_attention.cu``) or raises; it never switches to
  the plain version.
- On CPU tensors it runs :func:`paged_ragged_attention_reference`, the plain
  PyTorch version: the gather formulation of the JAX engine
  (``engine_v2._ragged_forward``), which also defines the options the kernel
  does not take yet (sliding window, rolling ring, tree-verify mask, an e4m3
  pool).

``counts`` holds the launches of each route, so a run can show that its
main path went through the kernel.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass
class LaunchCounts:
    """Calls of :func:`paged_ragged_attention` by route: ``kernel`` counts
    launches of the CUDA kernel, ``plain`` the CPU route through the plain
    version."""
    kernel: int = 0
    plain: int = 0

    def reset(self) -> None:
        self.kernel = 0
        self.plain = 0


counts = LaunchCounts()

#: head dims the kernel is instantiated for
KERNEL_HEAD_DIMS = (64, 128, 256)
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def paged_attention_usable(num_heads: int, kv_heads: int, head_dim: int,
                           block_size: int) -> bool:
    """Geometry gate of the kernel: whole GQA groups, page-aligned blocks of
    8 tokens, a head dim it is instantiated for (the JAX package's gate,
    less its Pallas import probe)."""
    return (num_heads % kv_heads == 0 and block_size % 8 == 0
            and head_dim in KERNEL_HEAD_DIMS)


def _i32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, device=device).to(torch.int32).contiguous()


def paged_ragged_attention_reference(q, pool, k_stage, v_stage, block_tables,
                                     seq_lens, q_starts, stage_starts, *,
                                     block_size: int, layer_index,
                                     scale: float | None = None,
                                     window: int | None = None,
                                     ring_tokens: int | None = None,
                                     tree_positions=None, tree_mask=None,
                                     alibi_slopes=None):
    """The plain version: gather each slot's pool pages, append the stage,
    one masked fp32 softmax. Rows that see no key (empty slots) are zeros,
    as in the kernel. p is rounded to V's dtype before the PV product and
    the denominator sums the unrounded p, the kernel's numerics.

    Pool keys sit at positions ``j`` for table column ``j // bs`` (or, with
    ``ring_tokens``, at positions recovered from the rolling table) and are
    valid below ``stage_starts``; stage row ``i`` sits at
    ``stage_starts + i`` and is valid below ``seq_lens`` — or, in tree mode,
    where ``tree_mask`` allows it. An e4m3 pool is read as q's dtype.

    ``alibi_slopes`` ``[H]`` adds ALiBi's bias ``slope * (key_pos -
    query_pos)`` to the scaled scores, as the JAX engine's gather path does
    for ALiBi models (the kernel takes no positional bias)."""
    S, T, H, D = q.shape
    L, _, KV, nb, bs, _ = pool.shape
    if bs != block_size:
        raise ValueError(f"pool block dim {bs} != block_size {block_size}")
    if H % KV:
        raise ValueError(f"GQA needs H ({H}) divisible by KV ({KV})")
    if (tree_positions is None) != (tree_mask is None):
        raise ValueError("tree_positions and tree_mask come together")
    if ring_tokens and not window:
        raise ValueError("ring buffer requires a sliding window")
    G = H // KV
    Ts = k_stage.shape[2]
    dev = q.device
    scale = 1.0 / (D ** 0.5) if scale is None else scale
    li = int(layer_index)
    tables = block_tables.to(device=dev, dtype=torch.long)
    ctx = tables.shape[1] * bs
    sstart = stage_starts.to(device=dev, dtype=torch.long)[:, None]   # [S,1]
    lens = seq_lens.to(device=dev, dtype=torch.long)[:, None]

    blocks = tables.repeat_interleave(bs, dim=1)                  # [S, ctx]
    offs = torch.arange(ctx, device=dev) % bs
    k_pool = pool[li, 0][:, blocks, offs[None, :]]               # [KV,S,ctx,D]
    v_pool = pool[li, 1][:, blocks, offs[None, :]]
    v_dtype = v_stage.dtype
    K = torch.cat([k_pool.permute(1, 0, 2, 3).to(q.dtype), k_stage], dim=2)
    V = torch.cat([v_pool.permute(1, 0, 2, 3).to(v_dtype), v_stage], dim=2)

    jidx = torch.arange(ctx, device=dev)[None, :]
    if ring_tokens:
        # rolling table: slot j holds the newest block b with b % nwin == j
        nwin = ring_tokens // bs
        b_latest = torch.clamp(sstart - 1, min=0) // bs
        b_j = b_latest - torch.remainder(b_latest - jidx // bs, nwin)
        raw = b_j * bs + jidx % bs
        cpos_pool = torch.where(raw < sstart, raw, raw - ring_tokens)
        valid_pool = cpos_pool >= 0
    else:
        cpos_pool = jidx.expand(S, ctx)
        valid_pool = cpos_pool < sstart
    cpos_st = sstart + torch.arange(Ts, device=dev)[None, :]       # [S, Ts]
    cpos = torch.cat([cpos_pool, cpos_st], dim=1)                  # [S, C]
    if tree_positions is not None:
        qpos = tree_positions.to(device=dev, dtype=torch.long)     # [S, T]
    else:
        qpos = (q_starts.to(device=dev, dtype=torch.long)[:, None]
                + torch.arange(T, device=dev)[None, :])
    mask = valid_pool[:, None, :] & (cpos_pool[:, None, :] <= qpos[:, :, None])
    if window:
        mask &= cpos_pool[:, None, :] > qpos[:, :, None] - window
    if tree_positions is not None:
        tm = tree_mask.to(device=dev).bool()                       # [S, T, T]
        st_mask = torch.zeros(S, T, Ts, dtype=torch.bool, device=dev)
        st_mask[:, :, :T] = tm
    else:
        st_mask = ((cpos_st < lens)[:, None, :]
                   & (cpos_st[:, None, :] <= qpos[:, :, None]))
        if window:
            st_mask &= cpos_st[:, None, :] > qpos[:, :, None] - window
    mask = torch.cat([mask, st_mask], dim=2)                       # [S, T, C]

    qg = q.reshape(S, T, KV, G, D).float()
    scores = torch.einsum("stkgd,skcd->sktgc", qg, K.float()) * scale
    if alibi_slopes is not None:                       # head h = k * G + g
        slopes = alibi_slopes.to(device=dev, dtype=torch.float32)
        rel = (cpos[:, None, None, None, :]
               - qpos[:, None, :, None, None]).float()             # [S,1,T,1,C]
        scores = scores + slopes.reshape(1, KV, 1, G, 1) * rel
    mask = mask[:, None, :, None, :]                               # [S,1,T,1,C]
    scores = scores.masked_fill(~mask, float("-inf"))
    m = scores.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(scores - m)                                      # 0 if masked
    l = p.sum(dim=-1, keepdim=True)
    pv = torch.einsum("sktgc,skcd->sktgd", p.to(v_dtype).float(), V.float())
    o = torch.where(l > 0, pv / torch.where(l > 0, l, torch.ones_like(l)),
                    torch.zeros_like(pv))
    return o.permute(0, 2, 1, 3, 4).reshape(S, T, H, D).to(q.dtype)


def paged_ragged_attention(q, pool, k_stage, v_stage, block_tables, seq_lens,
                           q_starts, stage_starts, *, block_size: int,
                           layer_index, scale: float | None = None,
                           window: int | None = None,
                           ring_tokens: int | None = None,
                           page_group: int | None = None,
                           tree_positions=None, tree_mask=None):
    """Ragged attention of q rows at positions ``q_starts[s] + t`` over the
    pool (positions below ``stage_starts``) and the stage (positions
    ``stage_starts + i`` below ``seq_lens``). Returns ``[S, T, H, D]``.

    CPU tensors take the plain version (all options). CUDA tensors launch
    the kernel, which takes the default form only: ``window``,
    ``ring_tokens``, ``page_group > 1``, tree inputs and an e4m3 pool raise
    NotImplementedError there until a later slice ports them."""
    if q.device.type == "cpu":
        counts.plain += 1
        return paged_ragged_attention_reference(
            q, pool, k_stage, v_stage, block_tables, seq_lens, q_starts,
            stage_starts, block_size=block_size, layer_index=layer_index,
            scale=scale, window=window, ring_tokens=ring_tokens,
            tree_positions=tree_positions, tree_mask=tree_mask)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    later = [name for name, on in (
        ("window", window), ("ring_tokens", ring_tokens),
        ("page_group > 1", page_group and page_group > 1),
        ("tree_positions/tree_mask", tree_positions is not None
         or tree_mask is not None),
        ("an e4m3 pool", pool.dtype == torch.float8_e4m3fn)) if on]
    if later:
        raise NotImplementedError(
            f"the CUDA paged-attention kernel takes the default form only; "
            f"{', '.join(later)} arrive(s) with a later slice of the port")
    return _launch_kernel(q, pool, k_stage, v_stage, block_tables, seq_lens,
                          q_starts, stage_starts, block_size=block_size,
                          layer_index=layer_index, scale=scale)


def _launch_kernel(q, pool, k_stage, v_stage, block_tables, seq_lens,
                   q_starts, stage_starts, *, block_size, layer_index, scale):
    from . import kernels

    S, T, H, D = q.shape
    if pool.dim() != 6:
        raise ValueError(f"pool must be [L, 2, KV, nb, bs, D], got "
                         f"{tuple(pool.shape)}")
    L, two, KV, nb, bs, Dp = pool.shape
    if two != 2 or Dp != D or bs != block_size:
        raise ValueError(f"pool {tuple(pool.shape)} does not match q "
                         f"{tuple(q.shape)} / block_size {block_size}")
    if H % KV:
        raise ValueError(f"GQA needs H ({H}) divisible by KV ({KV})")
    if D not in KERNEL_HEAD_DIMS:
        raise ValueError(f"head_dim {D} not in {KERNEL_HEAD_DIMS}")
    Ts = k_stage.shape[2]
    for name, t in (("k_stage", k_stage), ("v_stage", v_stage)):
        if tuple(t.shape) != (S, KV, Ts, D):
            raise ValueError(f"{name} {tuple(t.shape)} != {(S, KV, Ts, D)}")
    dt = q.dtype
    if dt not in _KERNEL_DTYPES:
        raise ValueError(f"kernel dtype must be float32 or bfloat16, got {dt}")
    dev = q.device
    for name, t in (("q", q), ("pool", pool), ("k_stage", k_stage),
                    ("v_stage", v_stage)):
        if t.dtype != dt or t.device != dev:
            raise ValueError(f"{name} is {t.dtype} on {t.device}; the kernel "
                             f"needs {dt} on {dev}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    li = int(layer_index)
    if not 0 <= li < L:
        raise ValueError(f"layer_index {li} outside [0, {L})")
    tables = _i32(block_tables, dev)
    if tables.dim() != 2 or tables.shape[0] != S:
        raise ValueError(f"block_tables {tuple(tables.shape)} needs {S} rows")
    lens, qst, sst = (_i32(x, dev) for x in (seq_lens, q_starts,
                                              stage_starts))
    for name, t in (("seq_lens", lens), ("q_starts", qst),
                    ("stage_starts", sst)):
        if tuple(t.shape) != (S,):
            raise ValueError(f"{name} {tuple(t.shape)} != ({S},)")
    scale = 1.0 / (D ** 0.5) if scale is None else float(scale)
    out = torch.empty_like(q)
    lib = kernels.load("paged_attention")
    err = lib.ds_ragged_paged_attention(
        q.data_ptr(), pool.data_ptr(), k_stage.data_ptr(),
        v_stage.data_ptr(), tables.data_ptr(), lens.data_ptr(),
        qst.data_ptr(), sst.data_ptr(), out.data_ptr(),
        S, T, H, KV, D, nb, bs, Ts, tables.shape[1], li, scale,
        _KERNEL_DTYPES[dt], torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"paged-attention kernel launch failed: CUDA error "
                           f"{err}")
    counts.kernel += 1
    return out
