"""Ragged paged attention over a read-only KV pool plus a staged tail (K1).

Counterpart of ``paged_ragged_attention`` in
``deepspeed_tpu/ops/pallas/paged_attention.py``, with the same signature and
layouts: q ``[S, T, H, D]``, pool ``[L, 2, KV, nb, bs, D]``, stage
``[S, KV, Ts, D]``, output ``[S, T, H, D]``.

- On CUDA tensors, :func:`paged_ragged_attention` launches a hand-written
  Hopper kernel (``csrc/paged_attention.cu``) with every option — sliding
  window, rolling ring table, tree-verify mask — or raises; it never
  switches to the plain version. Which kernel is :func:`kernel_route`'s
  choice, by shape alone: fp32 takes the CUDA-core kernel (the parity
  route); bf16 takes the split kernel (flash-decoding over
  :func:`split_columns`-wide splits of the table, then a merge) when a
  (slot, KV head) has at most :data:`SPLIT_MAX_ROWS` query rows (T x G:
  decode steps and windows, small trees), else the chunk kernel (wgmma
  tensor cores fed by TMA: prefill chunks, wide trees).
- On CPU tensors it runs :func:`paged_ragged_attention_reference`, the plain
  PyTorch version: the gather formulation of the JAX engine
  (``engine_v2._ragged_forward``).

An e4m3 pool (``kv_cache_dtype="fp8"``) is served by the kernel and the
plain version alike with the Pallas kernel's algebra for it: q rounded to
e4m3 against pool keys, p scaled by 448 and rounded to e4m3 against pool
values (see :func:`paged_ragged_attention_reference`).

``counts`` holds the launches of each route and form, so a run can show
that its main path went through the kernel, in the form it needed.

The per-layer-slice entry points :func:`paged_prefill_attention` and
:func:`paged_decode_attention` (K7, counterparts of the JAX functions of the
same names) attend over separate K and V pools ``[KV, P, D]`` into which
the chunk's K/V are already scattered: no stage, e4m3 or tree form. On CUDA
tensors they launch ``ds_paged_attention`` (same source: an fp32 kernel of
its own; in bf16 the chunk and split kernels under K7's page rule and
unguarded softmax, routed as K1's), on CPU tensors
:func:`paged_prefill_attention_reference`. Their launches are counted apart,
in ``prefill_counts``.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass, fields

import torch

from .quant_matmul import E4M3_MAX, to_e4m3


@dataclass
class LaunchCounts:
    """Calls of :func:`paged_ragged_attention` by route and form.

    ``kernel`` counts launches of the CUDA kernel over a pool of q's dtype
    and ``kernel_e4m3`` its launches over an e4m3 pool — every launch is in
    one of the two. ``kernel_window``, ``kernel_ring`` and ``kernel_tree``
    count the launches (of either pool) that took the sliding window, the
    rolling ring table (always with a window) and the tree-verify mask.
    ``kernel_chunk`` and ``kernel_split`` count the bf16 launches (of either
    pool) by kernel: the chunk kernel, the split kernel (with its merge);
    an fp32 launch is in neither. ``plain`` counts the CPU route through
    the plain version."""
    kernel: int = 0
    kernel_e4m3: int = 0
    kernel_window: int = 0
    kernel_ring: int = 0
    kernel_tree: int = 0
    kernel_chunk: int = 0
    kernel_split: int = 0
    plain: int = 0

    def reset(self) -> None:
        for f in fields(self):
            setattr(self, f.name, 0)


counts = LaunchCounts()

#: head dims the kernel is instantiated for
KERNEL_HEAD_DIMS = (64, 128, 256)
#: key positions per step of the CUDA kernels' walk (``kKeys`` in the source)
KERNEL_KEY_TILE = 64
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: query rows per (slot, KV head) — T x G — up to which a bf16 call takes
#: the split kernel (``kSplitRows``: mma.sync's M); above it the chunk kernel
SPLIT_MAX_ROWS = 16
#: the split kernel's grid holds at least this many blocks per SM
SPLIT_FILL = 2


def kernel_route(dtype, rows: int) -> str:
    """The CUDA kernel a call takes, by shape alone: "fma" for fp32 (the
    CUDA-core kernel, the parity route); for bf16 "split" when the ``rows``
    per (slot, KV head) (T x G) are at most :data:`SPLIT_MAX_ROWS`, else
    "chunk"."""
    if dtype == torch.float32:
        return "fma"
    return "split" if rows <= SPLIT_MAX_ROWS else "chunk"


def split_columns(n_seqs: int, kv_heads: int, max_pages: int,
                  block_size: int, sms: int) -> int:
    """Table columns per split of the split kernel: the table's width
    (``max_pages x block_size``) in whole 64-column tiles, cut into splits
    of ``tiles // want`` tiles, ``want`` the splits that give ``sms`` SMs
    :data:`SPLIT_FILL` blocks each (a block per split, KV head and slot),
    so there are at least ``want`` splits (fewer than twice as many), at
    most one per tile. It reads shapes only — no value comes back from the
    card — so the call stays capturable in a CUDA graph."""
    tiles = max(1, -(-max_pages * block_size // KERNEL_KEY_TILE))
    want = min(max(1, -(-SPLIT_FILL * sms // max(1, n_seqs * kv_heads))),
               tiles)
    return tiles // want * KERNEL_KEY_TILE


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def kernel_plan(q, kv_heads: int, max_pages: int, block_size: int,
                sms: int | None = None) -> tuple[str, int]:
    """``(route, split_cols)`` of a call on q ``[S, T, H, D]``:
    :func:`kernel_route`'s choice and, for the split kernel,
    :func:`split_columns` over ``sms`` SMs (by default q's device's), else
    0. The split kernel's e4m3 form rounds p against each split's running
    max: ``p_round_splits=split_cols`` makes the plain version do the
    same."""
    S, T, H, _ = q.shape
    route = kernel_route(q.dtype, T * (H // kv_heads))
    if route != "split":
        return route, 0
    if sms is None:
        sms = _sm_count(q.device.index if q.device.index is not None
                        else torch.cuda.current_device())
    return route, split_columns(S, kv_heads, max_pages, block_size, sms)


def paged_attention_usable(num_heads: int, kv_heads: int, head_dim: int,
                           block_size: int) -> bool:
    """Geometry gate of the kernel: whole GQA groups, page-aligned blocks of
    8 tokens, a head dim it is instantiated for (the JAX package's gate,
    less its Pallas import probe)."""
    return (num_heads % kv_heads == 0 and block_size % 8 == 0
            and head_dim in KERNEL_HEAD_DIMS)


def _i32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, device=device).to(torch.int32).contiguous()


def key_visibility(block_tables, seq_lens, q_starts, stage_starts, *,
                   T: int, Ts: int, block_size: int,
                   window: int | None = None, ring_tokens: int | None = None,
                   tree_positions=None, tree_mask=None):
    """Where each key sits and which query sees it, over the C = max_pages *
    block_size pool columns (table order) followed by the Ts stage rows.
    Returns ``(cpos [S, C], qpos [S, T], mask [S, T, C])`` on the tables'
    device: key positions, query positions and visibility.

    Pool column j holds position j, valid below ``stage_starts``; with
    ``ring_tokens`` the table is a ring of ``ring_tokens // block_size``
    pages and column j holds the newest block b with b % nwin == j //
    block_size, its offsets at or past ``stage_starts`` being the previous
    wrap. Stage row i sits at ``stage_starts + i``, valid below
    ``seq_lens`` — in tree mode it is node i at ``tree_positions[:, i]``,
    and ``tree_mask`` alone decides who sees it. Keys are visible at
    position <= the query's (and > the query's - ``window``)."""
    dev = block_tables.device
    bs = block_size
    S = block_tables.shape[0]
    ctx = block_tables.shape[1] * bs
    sstart = stage_starts.to(device=dev, dtype=torch.long)[:, None]   # [S,1]
    lens = seq_lens.to(device=dev, dtype=torch.long)[:, None]
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
    if tree_positions is not None:
        qpos = tree_positions.to(device=dev, dtype=torch.long)     # [S, T]
        # stage rows are the nodes: their positions are the nodes' own
        cpos_st = torch.nn.functional.pad(qpos, (0, Ts - T))
    else:
        qpos = (q_starts.to(device=dev, dtype=torch.long)[:, None]
                + torch.arange(T, device=dev)[None, :])
        cpos_st = sstart + torch.arange(Ts, device=dev)[None, :]   # [S, Ts]
    cpos = torch.cat([cpos_pool, cpos_st], dim=1)                  # [S, C]
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
    return cpos, qpos, torch.cat([mask, st_mask], dim=2)


def paged_ragged_attention_reference(q, pool, k_stage, v_stage, block_tables,
                                     seq_lens, q_starts, stage_starts, *,
                                     block_size: int, layer_index,
                                     scale: float | None = None,
                                     window: int | None = None,
                                     ring_tokens: int | None = None,
                                     tree_positions=None, tree_mask=None,
                                     alibi_slopes=None,
                                     upcast_pool: bool = False,
                                     p_round_blocks: tuple[int, int] | None
                                     = None,
                                     p_round_splits: int | None = None):
    """The plain version: gather each slot's pool pages, append the stage,
    one masked fp32 softmax. Rows that see no key (empty slots) are zeros,
    as in the kernel. p is rounded to V's dtype before the PV product and
    the denominator sums the unrounded p, the kernel's numerics.

    An e4m3 pool takes the Pallas kernel's algebra for it
    (``_ragged_attn_kernel``'s q cast and ``p_scale``): pool keys score
    against q rounded to e4m3; p is scaled by 448 for every key and l sums
    that scaled p; p is rounded to e4m3 for the pool values and to the
    stage's dtype for the stage values. With 3 mantissa bits, where p is
    rounded matters: a kernel rounds it against the running max of its key
    walk, so this version does too. ``p_round_blocks`` = (pool columns,
    stage rows) per step of that walk: by default the Pallas kernel's (one
    page; one stage page), ``(64, 64)`` for the CUDA kernel's key tiles
    (:data:`KERNEL_KEY_TILE`). ``p_round_splits`` (pool columns per split,
    a multiple of the pool block) restarts that running max at every split
    boundary and at the stage, as the split kernel's splits do
    (:func:`kernel_plan`); only the e4m3 form rounds against the walk, so
    it changes nothing else. ``upcast_pool`` instead reads an e4m3 pool
    as q's dtype with no scale, the JAX engine's gather formulation (its
    ALiBi and ``use_pallas_decode=False`` path).

    Which query sees which key — the positions of the pool's columns in a
    linear or rolling table, the stage's rows or tree nodes, the window —
    is :func:`key_visibility`'s.

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

    blocks = tables.repeat_interleave(bs, dim=1)                  # [S, ctx]
    offs = torch.arange(ctx, device=dev) % bs
    # an e4m3 pool is gathered as bytes (index kernels need not take fp8)
    pool_b = pool.view(torch.uint8) if pool.dtype == torch.float8_e4m3fn \
        else pool
    k_pool = pool_b[li, 0][:, blocks, offs[None, :]].view(pool.dtype)
    v_pool = pool_b[li, 1][:, blocks, offs[None, :]].view(pool.dtype)
    v_dtype = v_stage.dtype
    e4m3 = pool.dtype == torch.float8_e4m3fn and not upcast_pool
    # an e4m3 pool's values are exact in fp32
    k_dt, v_dt = (torch.float32,) * 2 if e4m3 else (q.dtype, v_dtype)
    K = torch.cat([k_pool.permute(1, 0, 2, 3).to(k_dt), k_stage.to(k_dt)],
                  dim=2)
    V = torch.cat([v_pool.permute(1, 0, 2, 3).to(v_dt), v_stage.to(v_dt)],
                  dim=2)

    cpos, qpos, mask = key_visibility(
        tables, seq_lens, q_starts, stage_starts, T=T, Ts=Ts, block_size=bs,
        window=window, ring_tokens=ring_tokens,
        tree_positions=tree_positions, tree_mask=tree_mask)

    qg = q.reshape(S, T, KV, G, D).float()
    if e4m3:
        # pool keys score against q rounded to e4m3, stage keys against q
        q8 = to_e4m3(q).float().reshape(S, T, KV, G, D)
        scores = torch.cat([
            torch.einsum("stkgd,skcd->sktgc", q8, K[:, :, :ctx].float()),
            torch.einsum("stkgd,skcd->sktgc", qg, K[:, :, ctx:].float())],
            dim=-1) * scale
    else:
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
    if e4m3:
        # p against the running max of the kernel's key walk, scaled into
        # e4m3's range for every key (l carries the scale); w brings each
        # block's terms to the final max, as the kernel's alpha does
        pb, sb = p_round_blocks or (bs, Ts if Ts <= bs else bs)
        m_run = _running_max(scores, ctx, pb, sb, p_round_splits)
        seen = torch.isfinite(m_run)
        m_run = torch.where(seen, m_run, m)
        p = torch.exp(scores - m_run) * E4M3_MAX                   # 0 if masked
        w = torch.where(seen, torch.exp(m_run - m), torch.zeros_like(m_run))
        p_r = torch.cat([to_e4m3(p[..., :ctx]).float(),
                         p[..., ctx:].to(v_dtype).float()], dim=-1) * w
        p = p * w
    else:
        p = torch.exp(scores - m)                                  # 0 if masked
        p_r = p.to(v_dtype).float()
    l = p.sum(dim=-1, keepdim=True)
    pv = torch.einsum("sktgc,skcd->sktgd", p_r, V.float())
    o = torch.where(l > 0, pv / torch.where(l > 0, l, torch.ones_like(l)),
                    torch.zeros_like(pv))
    return o.permute(0, 2, 1, 3, 4).reshape(S, T, H, D).to(q.dtype)


def _running_max(scores, ctx: int, pb: int, sb: int,
                 split: int | None = None) -> torch.Tensor:
    """For each key column, the softmax max a kernel holds when it reaches
    that column's block: the running max over blocks of ``pb`` pool columns,
    then blocks of ``sb`` stage columns (-inf before the first valid key).
    With ``split`` (pool columns per split, a multiple of ``pb``) the walk
    restarts at every ``split`` pool columns and at the stage: each split
    keeps its own running max."""
    def block_max(x, size):
        pad = (-x.shape[-1]) % size
        if pad:
            x = torch.nn.functional.pad(x, (0, pad), value=float("-inf"))
        return x.reshape(*x.shape[:-1], -1, size).amax(dim=-1)

    def cummax(x):
        return torch.cummax(x, dim=-1).values if x.shape[-1] else x

    bm_pool = block_max(scores[..., :ctx], pb)
    bm_stage = block_max(scores[..., ctx:], sb)
    nbp = bm_pool.shape[-1]
    if split is None:
        run = cummax(torch.cat([bm_pool, bm_stage], dim=-1))
        run_pool, run_stage = run[..., :nbp], run[..., nbp:]
    else:
        if split % pb:
            raise ValueError(f"split {split} is not a multiple of the pool "
                             f"block {pb}")
        per = split // pb
        pad = (-nbp) % per
        x = torch.nn.functional.pad(bm_pool, (0, pad), value=float("-inf"))
        run_pool = cummax(x.reshape(*x.shape[:-1], -1, per)).reshape(
            x.shape)[..., :nbp]
        run_stage = cummax(bm_stage)
    return torch.cat([
        run_pool.repeat_interleave(pb, dim=-1)[..., :ctx],
        run_stage.repeat_interleave(sb, dim=-1)[
            ..., :scores.shape[-1] - ctx]], dim=-1)


def paged_ragged_attention(q, pool, k_stage, v_stage, block_tables, seq_lens,
                           q_starts, stage_starts, *, block_size: int,
                           layer_index, scale: float | None = None,
                           window: int | None = None,
                           ring_tokens: int | None = None,
                           page_group: int | None = None,
                           tree_positions=None, tree_mask=None):
    """Ragged attention of q rows at positions ``q_starts[s] + t`` (tree
    mode: ``tree_positions[s, t]``) over the pool (positions below
    ``stage_starts``) and the stage (positions ``stage_starts + i`` below
    ``seq_lens``; tree mode: nodes under ``tree_mask``). Returns
    ``[S, T, H, D]``.

    CPU tensors take the plain version, CUDA tensors a kernel
    (:func:`kernel_plan` says which), with every option on a pool of q's
    dtype or of e4m3 codes. ``page_group`` (pool
    pages per TPU grid step) changes no arithmetic of either walk and is
    accepted for the JAX signature's sake; it only moves where the e4m3
    form rounds p in the Pallas kernel (``p_round_blocks`` of the plain
    version reproduces that)."""
    if page_group is not None and page_group < 1:
        raise ValueError(f"page_group must be >= 1, got {page_group}")
    if q.device.type == "cpu":
        counts.plain += 1
        return paged_ragged_attention_reference(
            q, pool, k_stage, v_stage, block_tables, seq_lens, q_starts,
            stage_starts, block_size=block_size, layer_index=layer_index,
            scale=scale, window=window, ring_tokens=ring_tokens,
            tree_positions=tree_positions, tree_mask=tree_mask)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    return _launch_kernel(q, pool, k_stage, v_stage, block_tables, seq_lens,
                          q_starts, stage_starts, block_size=block_size,
                          layer_index=layer_index, scale=scale,
                          window=window, ring_tokens=ring_tokens,
                          tree_positions=tree_positions, tree_mask=tree_mask)


def _launch_kernel(q, pool, k_stage, v_stage, block_tables, seq_lens,
                   q_starts, stage_starts, *, block_size, layer_index, scale,
                   window, ring_tokens, tree_positions, tree_mask):
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
    e4m3 = pool.dtype == torch.float8_e4m3fn
    for name, t in (("q", q), ("pool", pool), ("k_stage", k_stage),
                    ("v_stage", v_stage)):
        if (t.dtype != dt and not (t is pool and e4m3)) or t.device != dev:
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
    window, ring_tokens = int(window or 0), int(ring_tokens or 0)
    if window < 0 or ring_tokens < 0:
        raise ValueError(f"window {window} / ring_tokens {ring_tokens} < 0")
    if ring_tokens and (not window or ring_tokens % bs):
        raise ValueError(f"ring_tokens {ring_tokens} needs a sliding window "
                         f"and whole pages of {bs}")
    tree = tree_positions is not None
    if tree != (tree_mask is not None):
        raise ValueError("tree_positions and tree_mask come together")
    tpos = tmask = None
    if tree:
        tpos = _i32(tree_positions, dev)
        tmask = torch.as_tensor(tree_mask, device=dev).to(
            torch.uint8).contiguous()
        if tuple(tpos.shape) != (S, T) or tuple(tmask.shape) != (S, T, T):
            raise ValueError(f"tree_positions {tuple(tpos.shape)} / tree_mask "
                             f"{tuple(tmask.shape)} != {(S, T)} / {(S, T, T)}")
        if Ts < T:
            raise ValueError(f"stage rows {Ts} must cover the {T} tree nodes")
    scale = 1.0 / (D ** 0.5) if scale is None else float(scale)
    max_pages = tables.shape[1]
    route, split_cols = kernel_plan(q, KV, max_pages, bs)
    n_splits, scratch = _split_scratch(q, KV, max_pages, bs, split_cols,
                                       stage=True)
    out = torch.empty_like(q)
    lib = kernels.load("paged_attention")
    err = lib.ds_ragged_paged_attention(
        q.data_ptr(), pool.data_ptr(), k_stage.data_ptr(),
        v_stage.data_ptr(), tables.data_ptr(), lens.data_ptr(),
        qst.data_ptr(), sst.data_ptr(),
        tpos.data_ptr() if tree else None, tmask.data_ptr() if tree else None,
        out.data_ptr(), S, T, H, KV, D, nb, bs, Ts, max_pages, li,
        scale, window, ring_tokens, _KERNEL_DTYPES[dt], int(e4m3), L,
        split_cols, n_splits,
        scratch.data_ptr() if scratch is not None else None,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"paged-attention kernel launch failed: CUDA error "
                           f"{err}")
    if e4m3:
        counts.kernel_e4m3 += 1
    else:
        counts.kernel += 1
    counts.kernel_window += bool(window)
    counts.kernel_ring += bool(ring_tokens)
    counts.kernel_tree += tree
    counts.kernel_chunk += route == "chunk"
    counts.kernel_split += route == "split"
    return out


def _split_scratch(q, kv_heads: int, max_pages: int, block_size: int,
                   split_cols: int, *, stage: bool):
    """``(n_splits, scratch)`` of a split-kernel call (``split_cols`` > 0):
    the table's splits (and K1's stage, one more) and the fp32 scratch of
    their (acc, m, l) per row, ``[S, KV, n_splits, T x G]`` x (D + 2);
    ``(0, None)`` otherwise."""
    if not split_cols:
        return 0, None
    S, T, H, D = q.shape
    n = -(-max_pages * block_size // split_cols) + int(stage)
    rows = S * kv_heads * n * T * (H // kv_heads)
    return n, torch.empty(rows * (D + 2), dtype=torch.float32,
                          device=q.device)


# ---------------------------------------------------------------------------
# K7: paged attention over separate K / V pools (per-layer-slice entries)
# ---------------------------------------------------------------------------

#: the Pallas kernel's mask value (float32's finfo.min, a finite value)
NEG_INF = float(torch.finfo(torch.float32).min)


@dataclass
class PrefillLaunchCounts:
    """Calls of :func:`paged_prefill_attention` (and of
    :func:`paged_decode_attention` through it) by route: ``kernel`` counts
    launches of the CUDA kernels, ``kernel_window`` and ``kernel_ring`` the
    ones that took the sliding window and the rolling ring (always with a
    window), ``kernel_chunk`` and ``kernel_split`` the bf16 ones by kernel
    (:func:`kernel_route`), ``plain`` the CPU route."""
    kernel: int = 0
    kernel_window: int = 0
    kernel_ring: int = 0
    kernel_chunk: int = 0
    kernel_split: int = 0
    plain: int = 0

    def reset(self) -> None:
        for f in fields(self):
            setattr(self, f.name, 0)


prefill_counts = PrefillLaunchCounts()


def _check_prefill(q, k_pool, block_size: int, window, ring_tokens) -> None:
    """The JAX entry's ValueErrors, in its order."""
    S, T, H, D = q.shape
    KV, P, _ = k_pool.shape
    if P % block_size:
        raise ValueError(f"pool tokens {P} not divisible by block_size "
                         f"{block_size}")
    if H % KV:
        raise ValueError(f"GQA needs H ({H}) divisible by KV ({KV})")
    if ring_tokens and not window:
        raise ValueError("a rolling KV buffer only retains the last "
                         "ring_tokens positions — it requires a sliding "
                         "window that masks everything older")
    if ring_tokens and ring_tokens % block_size:
        raise ValueError(f"ring_tokens {ring_tokens} must be a multiple of "
                         f"block_size {block_size}")


def prefill_key_visibility(block_tables, seq_lens, chunk_starts, *, T: int,
                           block_size: int, window: int | None = None,
                           ring_tokens: int | None = None):
    """Which table column the Pallas K7 grid walks and which query row sees
    it, over the C = max_pages * block_size columns of each slot's table.
    Returns ``(ctx [S, C], run [S, C], mask [S, T, C])`` on the tables'
    device: each column's key position, whether its page runs, and whether
    row t (at ``chunk_starts + t``) sees it.

    A page runs when it starts below ``seq_lens`` and, with a window, ends
    after the chunk's earliest visible position (``chunk_starts - window +
    1``); in a ring (``ring_tokens``) every slot j holding a block b_j =
    b_latest - (b_latest - j) mod nwin >= 0 runs (b_latest = (seq_lens - 1)
    // block_size), its offsets at or past ``seq_lens`` moved back by
    ``ring_tokens``. A row sees key positions <= its own, valid (below
    ``seq_lens``; >= 0 in a ring) and inside the window."""
    bs, dev = block_size, block_tables.device
    S, C = block_tables.shape[0], block_tables.shape[1] * bs
    col = torch.arange(C, device=dev)
    page, off = col // bs, col % bs
    lens = seq_lens.to(device=dev, dtype=torch.long)[:, None]      # [S, 1]
    starts = chunk_starts.to(device=dev, dtype=torch.long)[:, None]
    if ring_tokens:
        nwin = ring_tokens // bs
        b_latest = torch.clamp(lens - 1, min=0) // bs
        b_j = b_latest - torch.remainder(b_latest - page[None], nwin)
        run = (lens > 0) & (b_j >= 0)
        ctx = b_j * bs + off[None]
        ctx = torch.where(ctx < lens, ctx, ctx - ring_tokens)
        valid = ctx >= 0
    else:
        ctx = col[None].expand(S, C)
        run = page[None] * bs < lens
        if window:
            run = run & (page[None] * bs + bs > starts - window + 1)
        valid = ctx < lens
    qpos = starts + torch.arange(T, device=dev)[None]              # [S, T]
    mask = valid[:, None] & (ctx[:, None] <= qpos[:, :, None])     # [S,T,C]
    if window:
        mask &= ctx[:, None] > qpos[:, :, None] - window
    return ctx, run, mask


def paged_prefill_attention_reference(q, k_pool, v_pool, block_tables,
                                      seq_lens, chunk_starts, *,
                                      block_size: int,
                                      scale: float | None = None,
                                      window: int | None = None,
                                      ring_tokens: int | None = None):
    """The plain K7: gather every column of each slot's table, one fp32
    softmax over the columns of the pages the Pallas grid runs (which, and
    who sees what: :func:`prefill_key_visibility`). Masked scores take the
    Pallas kernel's finite NEG_INF, so a row that sees no key on any run
    page averages those pages' values (p = exp(0) = 1), as the kernel does;
    a slot with no run page gives zeros. p is rounded to V's dtype for the
    PV product, the denominator sums the unrounded p. K7 has no e4m3 form,
    so where the kernels' walk (tiles, splits) rounds p changes nothing
    this version models: it takes no ``p_round_splits``."""
    _check_prefill(q, k_pool, block_size, window, ring_tokens)
    S, T, H, D = q.shape
    KV = k_pool.shape[0]
    G, bs, dev = H // KV, block_size, q.device
    scale = 1.0 / (D ** 0.5) if scale is None else scale
    tables = block_tables.to(device=dev, dtype=torch.long)
    col = torch.arange(tables.shape[1] * bs, device=dev)
    rows = tables[:, col // bs] * bs + col % bs                    # [S, C]
    K = k_pool[:, rows].permute(1, 0, 2, 3).float()               # [S,KV,C,D]
    V = v_pool[:, rows].permute(1, 0, 2, 3)
    _, run, mask = prefill_key_visibility(
        tables, seq_lens, chunk_starts, T=T, block_size=bs, window=window,
        ring_tokens=ring_tokens)
    qg = q.reshape(S, T, KV, G, D).float()
    scores = torch.einsum("stkgd,skcd->sktgc", qg, K) * scale
    scores = scores.masked_fill(~mask[:, None, :, None], NEG_INF)
    scores = scores.masked_fill(~run[:, None, None, None], float("-inf"))
    m = scores.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))   # no run page
    p = torch.exp(scores - m)
    l = p.sum(dim=-1, keepdim=True)
    pv = torch.einsum("sktgc,skcd->sktgd", p.to(v_pool.dtype).float(),
                      V.float())
    o = torch.where(l > 0, pv / torch.where(l > 0, l, torch.ones_like(l)),
                    torch.zeros_like(pv))
    return o.permute(0, 2, 1, 3, 4).reshape(S, T, H, D).to(q.dtype)


def paged_prefill_attention(q, k_pool, v_pool, block_tables, seq_lens,
                            chunk_starts, *, block_size: int,
                            scale: float | None = None,
                            window: int | None = None,
                            ring_tokens: int | None = None):
    """Chunked-prefill attention against a paged KV pool.

    q:             [S, T, H, D] — each slot's T-token chunk, whose K/V were
                   already scattered into the pools; positions
                   chunk_starts[s] .. chunk_starts[s] + T - 1
    k_pool/v_pool: [KV, P, D], pages of ``block_size`` rows
    block_tables:  [S, max_pages] int32 (pad with the trash block)
    seq_lens:      [S] int32 — valid keys incl. this chunk's tokens
    chunk_starts:  [S] int32
    Returns [S, T, H, D]: the kernel on CUDA tensors, the plain version on
    CPU tensors."""
    _check_prefill(q, k_pool, block_size, window, ring_tokens)
    if q.device.type == "cpu":
        prefill_counts.plain += 1
        return paged_prefill_attention_reference(
            q, k_pool, v_pool, block_tables, seq_lens, chunk_starts,
            block_size=block_size, scale=scale, window=window,
            ring_tokens=ring_tokens)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    from . import kernels

    S, T, H, D = q.shape
    KV, P, _ = k_pool.shape
    if D not in KERNEL_HEAD_DIMS:
        raise ValueError(f"head_dim {D} not in {KERNEL_HEAD_DIMS}")
    dt, dev = q.dtype, q.device
    if dt not in _KERNEL_DTYPES:
        raise ValueError(f"kernel dtype must be float32 or bfloat16, got {dt}")
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool)):
        if t.dtype != dt or t.device != dev:
            raise ValueError(f"{name} is {t.dtype} on {t.device}; the kernel "
                             f"needs {dt} on {dev}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    if tuple(v_pool.shape) != (KV, P, D):
        raise ValueError(f"v_pool {tuple(v_pool.shape)} != {(KV, P, D)}")
    tables = _i32(block_tables, dev)
    if tables.dim() != 2 or tables.shape[0] != S or tables.shape[1] < 1:
        raise ValueError(f"block_tables {tuple(tables.shape)} needs {S} rows")
    lens, starts = _i32(seq_lens, dev), _i32(chunk_starts, dev)
    for name, t in (("seq_lens", lens), ("chunk_starts", starts)):
        if tuple(t.shape) != (S,):
            raise ValueError(f"{name} {tuple(t.shape)} != ({S},)")
    window, ring_tokens = int(window or 0), int(ring_tokens or 0)
    scale = 1.0 / (D ** 0.5) if scale is None else float(scale)
    max_pages = tables.shape[1]
    route, split_cols = kernel_plan(q, KV, max_pages, block_size)
    n_splits, scratch = _split_scratch(q, KV, max_pages, block_size,
                                       split_cols, stage=False)
    out = torch.empty_like(q)
    err = kernels.load("paged_attention").ds_paged_attention(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), tables.data_ptr(),
        lens.data_ptr(), starts.data_ptr(), out.data_ptr(), S, T, H, KV, D,
        P, block_size, max_pages, scale, window, ring_tokens,
        _KERNEL_DTYPES[dt], split_cols, n_splits,
        scratch.data_ptr() if scratch is not None else None,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"paged-attention (K7) launch failed: CUDA error "
                           f"{err}")
    prefill_counts.kernel += 1
    prefill_counts.kernel_window += bool(window)
    prefill_counts.kernel_ring += bool(ring_tokens)
    prefill_counts.kernel_chunk += route == "chunk"
    prefill_counts.kernel_split += route == "split"
    return out


def paged_decode_attention(q, k_pool, v_pool, block_tables, seq_lens, *,
                           block_size: int, scale: float | None = None,
                           window: int | None = None,
                           ring_tokens: int | None = None):
    """One token per slot: :func:`paged_prefill_attention` with T = 1 at
    position seq_len - 1. q [S, H, D]; seq_lens counts the new token (0 =
    an empty slot). Returns [S, H, D]."""
    starts = torch.clamp(torch.as_tensor(seq_lens).to(torch.int32) - 1, min=0)
    return paged_prefill_attention(
        q[:, None], k_pool, v_pool, block_tables, seq_lens, starts,
        block_size=block_size, scale=scale, window=window,
        ring_tokens=ring_tokens)[:, 0]
