"""Block-sparse flash attention, forward and backward (K6).

Counterpart of ``deepspeed_tpu/ops/pallas/block_sparse_attention.py``: per
(head, query block) a table lists the visible key blocks, so masked blocks
cost nothing, and the attention is the flash online-softmax recurrence.

- :func:`layout_tables` builds the tables from a ``[H, nq, nk]`` layout
  (the JAX package's, entry for entry) and :func:`block_sparse_usable` is
  the JAX gate, condition for condition.
- :func:`block_sparse_flash_attention` is the entry, over q/k/v
  ``[B, S, H, D]``, through :class:`BlockSparseFlash`, an autograd function
  that saves (q, k, v, out, lse) and the tables, never the probabilities.
- On CUDA tensors the forward launches ``ds_block_sparse_attention_fwd``
  and the backward ``ds_block_sparse_attention_dq`` and ``_dkv``
  (``csrc/block_sparse_attention.cu``; dk/dv walk the transposed table, so
  no atomics), or raise; they never switch to the plain version. The route
  is chosen by :func:`kernel_route` from the dtype and the block alone:
  bf16 at blocks that are a multiple of 128 takes the ``_tc`` entries, K4's
  wgmma + TMA kernels walking the layout's table (:func:`tile_walk` says,
  in Python, which tiles each of their blocks visits); fp32, and bf16 at
  other blocks, the CUDA-core FMA kernels.
- On CPU tensors they run :func:`block_sparse_fwd_plain` and
  :func:`block_sparse_bwd_plain`: the same tables walked one query (or key)
  block at a time in fp32, never an ``[H, S, S]`` mask.

Under ``causal`` the token mask ``k_pos <= q_pos`` applies on every visible
block, as the Pallas ``_apply_masks`` does: a visible block above the
diagonal is wholly masked. Rows that see no key give zeros and an lse of
:data:`NEG_INF`.

``counts`` holds the calls of each route: ``fwd`` and ``bwd`` count the
CUDA forward and backward (the backward's two kernels count once), of which
``fwd_tc`` and ``bwd_tc`` took the wgmma route; ``plain`` and ``plain_bwd``
the CPU route's calls.
"""
from __future__ import annotations

import hashlib
from collections import OrderedDict
from dataclasses import dataclass, fields

import numpy as np
import torch

from .flash_attention import (_KERNEL_DTYPES, _kernel_operands, _stream,
                              _world_size, attention_delta)

#: the lse of a row that sees no key (float32's finfo.min, a finite value)
NEG_INF = float(torch.finfo(torch.float32).min)
#: the smallest layout block the JAX gate hands to its kernel
MIN_BLOCK = 128
#: head dims the kernel is instantiated for (the JAX gate's set)
HEAD_DIMS = (64, 128, 256)
#: q rows of a wgmma-route forward or dq block: a layout block must hold
#: whole tiles of it for that route
TC_ROWS = 128
#: layouts whose device tables are kept (per device)
_TABLE_CACHE_SIZE = 32


@dataclass
class LaunchCounts:
    """Calls of K6 by route (see the module docstring)."""
    fwd: int = 0
    bwd: int = 0
    fwd_tc: int = 0
    bwd_tc: int = 0
    plain: int = 0
    plain_bwd: int = 0

    def reset(self) -> None:
        for f in fields(self):
            setattr(self, f.name, 0)


counts = LaunchCounts()


def layout_tables(layout: np.ndarray) -> tuple[np.ndarray, np.ndarray,
                                               np.ndarray, np.ndarray]:
    """Per-head visibility tables of a [H, nq, nk] block layout:
    (tbl_q [H,nq,mk], cnt_q [H,nq], tbl_k [H,nk,mq], cnt_k [H,nk]) where
    ``tbl_q[h,i,:cnt_q[h,i]]`` are the key blocks query block i attends and
    ``tbl_k`` is the transpose (the query blocks seeing each key block).
    Pad entries are 0 and never read."""
    layout = np.asarray(layout, bool)
    H, nq, nk = layout.shape
    cnt_q = layout.sum(2).astype(np.int32)
    cnt_k = layout.sum(1).astype(np.int32)
    mk = max(int(cnt_q.max()), 1)
    mq = max(int(cnt_k.max()), 1)
    tbl_q = np.zeros((H, nq, mk), np.int32)
    tbl_k = np.zeros((H, nk, mq), np.int32)
    for h in range(H):
        for i in range(nq):
            idx = np.nonzero(layout[h, i])[0]
            tbl_q[h, i, :idx.size] = idx
        for j in range(nk):
            idx = np.nonzero(layout[h, :, j])[0]
            tbl_k[h, j, :idx.size] = idx
    return tbl_q, cnt_q, tbl_k, cnt_k


def block_sparse_usable(layout: np.ndarray, block: int, S: int, D: int,
                        H: int, KV: int) -> bool:
    """Whether the dispatcher claims K6: blocks of at least 128 rows and a
    multiple of 8, whole blocks, one KV head per q head, D in (64, 128,
    256), and one process."""
    if block < MIN_BLOCK or block % 8 or S % block:
        return False
    if H != KV:                      # GQA head mapping not wired
        return False
    if _world_size() > 1:
        return False
    return D in HEAD_DIMS


@dataclass(frozen=True)
class Tables:
    """A layout's tables on one device (int32), and for each table the
    order in which the kernels take its rows, busiest first (``order_q``
    lists h * nq + i by descending ``cnt_q``, ``order_k`` likewise)."""
    tbl_q: torch.Tensor
    cnt_q: torch.Tensor
    order_q: torch.Tensor
    tbl_k: torch.Tensor
    cnt_k: torch.Tensor
    order_k: torch.Tensor

    @property
    def shape(self) -> tuple[int, int]:
        """(heads, blocks per side)."""
        return tuple(self.cnt_q.shape)


_tables: OrderedDict = OrderedDict()


def device_tables(layout: np.ndarray, device) -> Tables:
    """The layout's :class:`Tables` on ``device``, built once per (layout,
    device) and cached (``layout_tables`` is an O(H n^2) Python loop)."""
    lay = np.ascontiguousarray(np.asarray(layout, bool))
    if lay.ndim != 3 or lay.shape[1] != lay.shape[2]:
        raise ValueError(f"layout must be [H, n, n], got {lay.shape}")
    dev = torch.device(device)
    key = (hashlib.sha1(np.packbits(lay).tobytes()).hexdigest(), lay.shape,
           str(dev))
    hit = _tables.get(key)
    if hit is not None:
        _tables.move_to_end(key)
        return hit
    tbl_q, cnt_q, tbl_k, cnt_k = layout_tables(lay)

    def order(cnt):
        # stable: ties keep (head, block) order
        return np.argsort(-cnt.reshape(-1), kind="stable").astype(np.int32)

    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    out = Tables(t(tbl_q), t(cnt_q), t(order(cnt_q)), t(tbl_k), t(cnt_k),
                 t(order(cnt_k)))
    _tables[key] = out
    while len(_tables) > _TABLE_CACHE_SIZE:
        _tables.popitem(last=False)
    return out


def kernel_route(dtype: torch.dtype, block: int) -> str:
    """The kernels that serve a CUDA call, from the dtype and the block
    alone: "wgmma" for bf16 at blocks that are a multiple of
    :data:`TC_ROWS` (K4's tensor-core kernels walking the table), "fma" for
    fp32 and for bf16 at other blocks (136, 192, ...: a 128-row tile would
    straddle two layout blocks)."""
    if dtype == torch.bfloat16 and block % TC_ROWS == 0:
        return "wgmma"
    return "fma"


def tc_tile_rows(D: int) -> dict[str, tuple[int, int]]:
    """(rows a block owns, rows of each tile it walks) of the wgmma-route
    kernels at head dim ``D``: the forward and dq own 128 q rows and walk
    key tiles, dk/dv own keys and walk 64-row q tiles (``FwdTc``, ``DqTc``,
    ``DkvTc`` in ``csrc/flash_tc.cuh``)."""
    return {"fwd": (TC_ROWS, 64 if D == 256 else 128),
            "dq": (TC_ROWS, 32 if D == 256 else 64),
            "dkv": (64 if D == 256 else 128, 64)}


def tile_walk(tables: Tables, block: int, causal: bool, D: int,
              which: str) -> list[tuple[int, int, list[int]]]:
    """The tiles each block of a wgmma-route kernel (``which``: "fwd", "dq"
    or "dkv") visits, in its order: the arithmetic of ``TableWalk`` in
    ``csrc/block_sparse_attention.cu``, in Python. One entry per block of
    the grid's x dimension (the batch row is y): (head, first own row, the
    first rows of the other side's tiles). A block takes table row
    ``order[x // (block / own)]`` and expands each block of its entry into
    tiles, ascending; under causal the forward and dq count only the tiles
    that start at or before their last row (a prefix), dk/dv skip the tiles
    that end before their first key (a head)."""
    own, other = tc_tile_rows(D)[which]
    rows_side = which != "dkv"
    tbl, cnt, order = (t.cpu().numpy() for t in (
        (tables.tbl_q, tables.cnt_q, tables.order_q) if rows_side
        else (tables.tbl_k, tables.cnt_k, tables.order_k)))
    H, n = cnt.shape
    per, tpb = block // own, block // other
    walk = []
    for x in range(H * n * per):
        row = int(order[x // per])
        h, i = divmod(row, n)
        own0 = i * block + (x % per) * own
        starts = [int(b) * block for b in tbl[h, i, :cnt[h, i]]]
        first, count = 0, len(starts) * tpb
        if causal and rows_side:
            last, count = own0 + own - 1, 0
            for kb in starts:
                if kb > last:
                    break
                count += min(tpb, (last - kb) // other + 1)
        elif causal:
            for qb in starts:
                if qb >= own0:
                    break
                first += min(tpb, (own0 - qb) // other)
            count -= first
        walk.append((h, own0, [starts[t // tpb] + (t % tpb) * other
                               for t in range(first, first + count)]))
    return walk


# ---------------------------------------------------------------------------
# plain versions ([B, H, S, D] layout, as the kernels')
# ---------------------------------------------------------------------------

def _gather_blocks(x, blocks, block: int):
    """Rows of the given blocks of each head: x [B, H, S, ...], blocks
    [H, m] → [B, H, m * block, ...]."""
    H, m = blocks.shape
    rows = (blocks.long()[:, :, None] * block
            + torch.arange(block, device=x.device)).reshape(H, m * block)
    heads = torch.arange(H, device=x.device)[:, None]
    return x[:, heads, rows], rows


def _visible(tbl, cnt, i: int, block: int, rows_other, rows_own, causal,
             own_is_query: bool):
    """[H, own rows, other rows] visibility inside block i's table entries:
    an entry past the count is never visible; under ``causal`` key position
    <= query position."""
    m = tbl.shape[2]
    valid = (torch.arange(m, device=tbl.device)[None] < cnt[:, i, None])
    valid = valid.repeat_interleave(block, dim=1)[:, None, :]     # [H,1,R]
    if not causal:
        return valid
    own = rows_own[None, :, None]
    other = rows_other[:, None, :]
    tri = other <= own if own_is_query else own <= other
    return valid & tri


def block_sparse_fwd_plain(q, k, v, tables: Tables, block: int,
                           causal: bool, scale: float):
    """(out [B, H, S, D] in q's dtype, lse [B, H, S] fp32): each query
    block against the key blocks of its table entry, fp32 scores and
    softmax; p is rounded to V's dtype for the PV product, the denominator
    sums the unrounded p. A row that sees no key gives 0 and lse NEG_INF."""
    B, H, S, D = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    for i in range(S // block):
        own = torch.arange(i * block, (i + 1) * block, device=q.device)
        kg, rows = _gather_blocks(k, tables.tbl_q[:, i], block)
        vg, _ = _gather_blocks(v, tables.tbl_q[:, i], block)
        s = (q[:, :, own].float() @ kg.float().transpose(-1, -2)) * scale
        vis = _visible(tables.tbl_q, tables.cnt_q, i, block, rows, own,
                       causal, True)
        s = s.masked_fill(~vis, float("-inf"))
        m = s.amax(dim=-1, keepdim=True)
        m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
        p = torch.exp(s - m)                                      # 0 if masked
        l = p.sum(dim=-1, keepdim=True)
        pv = p.to(v.dtype).float() @ vg.float()
        seen = l > 0
        out[:, :, own] = torch.where(
            seen, pv / torch.where(seen, l, torch.ones_like(l)),
            torch.zeros_like(pv)).to(q.dtype)
        lse[:, :, own] = torch.where(seen, m + torch.log(l),
                                     torch.full_like(l, NEG_INF))[..., 0]
    return out, lse


def block_sparse_bwd_plain(q, k, v, out, lse, dout, tables: Tables,
                           block: int, causal: bool, scale: float):
    """(dq, dk, dv) from the forward's inputs, out and lse, as the Pallas
    ``_bwd``: p = exp(s - lse) (lse taken as 0 where it is NEG_INF), dp =
    dO V^T, ds = p (dp - delta) scale with delta = rowsum(dO O); dq += ds
    (in K's dtype) K per query block over its table entry, dk += ds^T (in
    Q's dtype) Q and dv += p^T (in dO's dtype) dO per key block over the
    transposed table. Grads in their inputs' dtypes."""
    B, H, S, D = q.shape
    delta = attention_delta(out, dout)                            # [B,H,S]
    lse = lse.float()
    lse = torch.where(lse == NEG_INF, torch.zeros_like(lse), lse)
    dout = dout.to(q.dtype)
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    n = S // block
    for i in range(n):                       # dq: query block i
        own = torch.arange(i * block, (i + 1) * block, device=q.device)
        kg, rows = _gather_blocks(k, tables.tbl_q[:, i], block)
        vg, _ = _gather_blocks(v, tables.tbl_q[:, i], block)
        s = (q[:, :, own].float() @ kg.float().transpose(-1, -2)) * scale
        vis = _visible(tables.tbl_q, tables.cnt_q, i, block, rows, own,
                       causal, True)
        p = torch.exp((s - lse[:, :, own, None]).masked_fill(
            ~vis, float("-inf")))
        dp = dout[:, :, own].float() @ vg.float().transpose(-1, -2)
        ds = p * (dp - delta[:, :, own, None]) * scale
        dq[:, :, own] = (ds.to(k.dtype).float() @ kg.float()).to(q.dtype)
    for j in range(n):                       # dk, dv: key block j
        own = torch.arange(j * block, (j + 1) * block, device=q.device)
        qg, rows = _gather_blocks(q, tables.tbl_k[:, j], block)
        dog, _ = _gather_blocks(dout, tables.tbl_k[:, j], block)
        lg, _ = _gather_blocks(lse, tables.tbl_k[:, j], block)
        dlg, _ = _gather_blocks(delta, tables.tbl_k[:, j], block)
        # [B, H, key rows, query rows]
        s = (k[:, :, own].float() @ qg.float().transpose(-1, -2)) * scale
        vis = _visible(tables.tbl_k, tables.cnt_k, j, block, rows, own,
                       causal, False)
        p = torch.exp((s - lg[:, :, None, :]).masked_fill(
            ~vis, float("-inf")))
        dv[:, :, own] = (p.to(dout.dtype).float() @ dog.float()).to(v.dtype)
        dp = v[:, :, own].float() @ dog.float().transpose(-1, -2)
        ds = p * (dp - dlg[:, :, None, :]) * scale
        dk[:, :, own] = (ds.to(q.dtype).float() @ qg.float()).to(k.dtype)
    return dq, dk, dv


# ---------------------------------------------------------------------------
# the wrappers: the kernels on CUDA tensors, the plain versions on CPU ones
# ---------------------------------------------------------------------------

def _check(q, k, v, tables: Tables, block: int) -> None:
    if q.dim() != 4 or q.shape != k.shape or k.shape != v.shape:
        raise ValueError(f"q/k/v must be one [B, H, S, D] shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, H, S, D = q.shape
    if block <= 0 or S % block:
        raise ValueError(f"seq_len {S} not divisible by block {block}")
    if tables.shape != (H, S // block):
        raise ValueError(f"layout tables of {tables.shape} (heads, blocks) "
                         f"do not match {H} heads of {S // block} blocks")


def _kernel_checks(q, k, v, tables: Tables, block: int) -> None:
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    D = q.shape[-1]
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} not in {HEAD_DIMS}")
    if block % 8:
        raise ValueError(f"block {block} is not a multiple of 8")
    _kernel_operands(q.dtype, q, k, v)
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("q, k and v must share one dtype on the card")
    if tables.tbl_q.device != q.device:
        raise ValueError(f"tables on {tables.tbl_q.device}, operands on "
                         f"{q.device}")


def _entry(name: str, dtype: torch.dtype, block: int):
    """(the C entry ``name`` of the route :func:`kernel_route` picks, the
    arguments it takes between ``causal`` and the stream: the FMA entries
    take the dtype)."""
    from . import kernels

    lib = kernels.load("block_sparse_attention")
    if kernel_route(dtype, block) == "wgmma":
        return getattr(lib, name + "_tc"), ()
    return getattr(lib, name), (_KERNEL_DTYPES[dtype],)


def block_sparse_fwd(q, k, v, tables: Tables, block: int, causal: bool,
                     scale: float):
    """(out, lse) of the forward: the kernel of :func:`kernel_route`'s route
    on CUDA tensors, the plain version on CPU tensors."""
    _check(q, k, v, tables, block)
    if q.device.type == "cpu":
        counts.plain += 1
        return block_sparse_fwd_plain(q, k, v, tables, block, causal, scale)
    _kernel_checks(q, k, v, tables, block)
    B, H, S, D = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    fn, tail = _entry("ds_block_sparse_attention_fwd", q.dtype, block)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             lse.data_ptr(), tables.tbl_q.data_ptr(), tables.cnt_q.data_ptr(),
             tables.order_q.data_ptr(), B, H, S, D, block,
             tables.tbl_q.shape[2], float(scale), int(causal), *tail,
             _stream(q.device))
    if err != 0:
        raise RuntimeError(f"block-sparse attention forward launch failed: "
                           f"CUDA error {err}")
    counts.fwd += 1
    counts.fwd_tc += kernel_route(q.dtype, block) == "wgmma"
    return out, lse


def bwd_operands(q, k, v, out, lse, dout):
    """(dout in q's dtype, lse fp32, delta = rowsum(dO * O) fp32), each
    contiguous: what the dq and dk/dv kernels read besides q, k and v."""
    dout = dout.to(q.dtype).contiguous()
    _kernel_operands(q.dtype, q, k, v, out, dout)
    return dout, lse.float().contiguous(), attention_delta(out, dout) \
        .contiguous()


def launch_dq(q, k, v, dout, lse, delta, tables: Tables, block: int,
              causal: bool, scale: float) -> torch.Tensor:
    """dq by the dq kernel of :func:`kernel_route`'s route alone (CUDA
    tensors; not counted: the backward counts its two kernels once)."""
    B, H, S, D = q.shape
    dq = torch.empty_like(q)
    fn, tail = _entry("ds_block_sparse_attention_dq", q.dtype, block)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
             lse.data_ptr(), delta.data_ptr(), tables.tbl_q.data_ptr(),
             tables.cnt_q.data_ptr(), tables.order_q.data_ptr(),
             dq.data_ptr(), B, H, S, D, block, tables.tbl_q.shape[2],
             float(scale), int(causal), *tail, _stream(q.device))
    if err != 0:
        raise RuntimeError(f"block-sparse attention dq launch failed: CUDA "
                           f"error {err}")
    return dq


def launch_dkv(q, k, v, dout, lse, delta, tables: Tables, block: int,
               causal: bool, scale: float):
    """(dk, dv) by the dk/dv kernel of :func:`kernel_route`'s route alone
    (CUDA tensors; not counted)."""
    B, H, S, D = q.shape
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    fn, tail = _entry("ds_block_sparse_attention_dkv", q.dtype, block)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
             lse.data_ptr(), delta.data_ptr(), tables.tbl_k.data_ptr(),
             tables.cnt_k.data_ptr(), tables.order_k.data_ptr(),
             dk.data_ptr(), dv.data_ptr(), B, H, S, D, block,
             tables.tbl_k.shape[2], float(scale), int(causal), *tail,
             _stream(q.device))
    if err != 0:
        raise RuntimeError(f"block-sparse attention dk/dv launch failed: "
                           f"CUDA error {err}")
    return dk, dv


def block_sparse_bwd(q, k, v, out, lse, dout, tables: Tables, block: int,
                     causal: bool, scale: float):
    """(dq, dk, dv) of the backward: the dq and dk/dv kernels of
    :func:`kernel_route`'s route on CUDA tensors (counted once), the plain
    version on CPU tensors."""
    _check(q, k, v, tables, block)
    if q.device.type == "cpu":
        counts.plain_bwd += 1
        return block_sparse_bwd_plain(q, k, v, out, lse, dout, tables, block,
                                      causal, scale)
    _kernel_checks(q, k, v, tables, block)
    dout, lse, delta = bwd_operands(q, k, v, out, lse, dout)
    dq = launch_dq(q, k, v, dout, lse, delta, tables, block, causal, scale)
    dk, dv = launch_dkv(q, k, v, dout, lse, delta, tables, block, causal,
                        scale)
    counts.bwd += 1
    counts.bwd_tc += kernel_route(q.dtype, block) == "wgmma"
    return dq, dk, dv


class BlockSparseFlash(torch.autograd.Function):
    """K6 over [B, H, S, D] q/k/v (contiguous); saves (q, k, v, out, lse)
    and keeps the tables for the backward."""

    @staticmethod
    def forward(ctx, q, k, v, tables: Tables, block: int, causal: bool,
                scale: float):
        out, lse = block_sparse_fwd(q, k, v, tables, block, causal, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.tables, ctx.block, ctx.causal, ctx.scale = (tables, block, causal,
                                                        scale)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = block_sparse_bwd(q, k, v, out, lse, dout, ctx.tables,
                                      ctx.block, ctx.causal, ctx.scale)
        return dq, dk, dv, None, None, None, None


def block_sparse_flash_attention(q, k, v, layout: np.ndarray, block: int, *,
                                 causal: bool = False,
                                 scale: float | None = None) -> torch.Tensor:
    """q/k/v [B, S, H, D]; ``layout`` [H, S // block, S // block] bool.
    Returns [B, S, H, D] in q's dtype; rows with no visible key give
    zeros."""
    D = q.shape[-1]
    scale = 1.0 / (D ** 0.5) if scale is None else float(scale)
    tables = device_tables(layout, q.device)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    return BlockSparseFlash.apply(qt, kt, vt, tables, block, causal,
                                  scale).transpose(1, 2)
