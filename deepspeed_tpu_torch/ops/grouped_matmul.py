"""Grouped (per-expert) matrix product over expert-sorted tokens (K5).

Counterpart of ``deepspeed_tpu/ops/pallas/grouped_matmul.py``
(``ExpertSort``, ``sort_tokens_by_expert``, ``grouped_matmul``): tokens are
sorted by expert and each expert's segment is padded up to a multiple of
``block_m``, so every ``block_m``-row tile belongs to exactly one expert
(``tile_expert``). ``grouped_matmul`` computes ``x_tile @ w[tile_expert[t]]``
for every tile, in x's dtype with fp32 accumulation.

- On CUDA tensors :func:`grouped_matmul` launches the hand-written Hopper
  kernel (``csrc/grouped_matmul.cu``) or raises; on CPU tensors it runs
  :func:`grouped_matmul_reference`, the plain version. ``counts`` holds the
  launches of each route.
- :func:`sort_tokens_by_expert` also returns ``tile_rows``, the number of
  routed rows of each tile (a device tensor, computed without reading
  anything back to the host). The kernel skips the rest: rows past the
  count are padding, zero in x, and written as zeros; a tile with no routed
  row (an expert's alignment tail, or the clipped tiles past the last
  expert) is not computed at all.
- This slice serves: the backward (the JAX package's ``transpose_rhs`` form
  and ``_dw_kernel``) is ported with the training slice, and a call on a
  tensor that requires grad raises NotImplementedError.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .quant_matmul import LaunchCounts

#: calls of :func:`grouped_matmul` by route
counts = LaunchCounts()

#: rows of the CUDA kernels' output tiles (K5 and K3): block_m must be a
#: multiple of it on the card
KERNEL_ROWS = 32


class ExpertSort(NamedTuple):
    """The dispatch layout of :func:`sort_tokens_by_expert` (static
    shapes; every tensor on the routing's device)."""
    dst: torch.Tensor          # [T*k] destination row per (token, choice)
    tile_expert: torch.Tensor  # [Tp // block_m] int32 expert of each tile
    Tp: int                    # padded buffer length
    tile_rows: torch.Tensor    # [Tp // block_m] int32 routed rows per tile


def sort_tokens_by_expert(expert_idx: torch.Tensor, num_experts: int,
                          block_m: int = 128) -> ExpertSort:
    """The expert-sorted, block-aligned destination of every (token, choice)
    pair of ``expert_idx`` [T, k]: expert e's rows start at the sum of the
    earlier experts' counts rounded up to ``block_m``, in token order.
    ``Tp = roundup(T*k, block_m) + num_experts * block_m`` bounds the
    buffer statically. Counts are one-hot sums (``torch.bincount`` would
    read its length back to the host on CUDA)."""
    T, k = expert_idx.shape
    Tk = T * k
    dev = expert_idx.device
    e_flat = expert_idx.reshape(-1).long()
    counts_e = torch.zeros(num_experts, dtype=torch.long, device=dev
                           ).scatter_add_(0, e_flat, torch.ones_like(e_flat))
    aligned = (counts_e + block_m - 1) // block_m * block_m
    zero = torch.zeros(1, dtype=torch.long, device=dev)
    starts = torch.cat([zero, aligned.cumsum(0)[:-1]])
    cum_counts = torch.cat([zero, counts_e.cumsum(0)[:-1]])

    order = torch.argsort(e_flat, stable=True)                     # [Tk]
    sorted_e = e_flat[order]
    rank = torch.arange(Tk, device=dev) - cum_counts[sorted_e]
    dst = torch.empty_like(e_flat).scatter_(0, order,
                                            starts[sorted_e] + rank)

    Tp = -(-Tk // block_m) * block_m + num_experts * block_m
    tile_starts = torch.arange(Tp // block_m, device=dev) * block_m
    # the last expert whose segment starts at or before the tile (empty
    # experts share their successor's start); tiles past the end clip
    tile_expert = (torch.searchsorted(starts, tile_starts, right=True) - 1
                   ).clamp(0, num_experts - 1)
    tile_rows = (starts[tile_expert] + counts_e[tile_expert] - tile_starts
                 ).clamp(0, block_m)
    return ExpertSort(dst=dst.to(torch.int32),
                      tile_expert=tile_expert.to(torch.int32), Tp=Tp,
                      tile_rows=tile_rows.to(torch.int32))


def check_tiles(Tp, block_m, tile_expert, tile_rows) -> None:
    """``Tp`` rows in whole tiles of ``block_m``, one ``tile_expert`` (and
    ``tile_rows``, when given) entry per tile."""
    if Tp % block_m:
        raise ValueError(f"tokens {Tp} not a multiple of block_m {block_m}")
    for name, t in (("tile_expert", tile_expert), ("tile_rows", tile_rows)):
        if t is not None and tuple(t.shape) != (Tp // block_m,):
            raise ValueError(f"{name} {tuple(t.shape)} does not fit {Tp} "
                             f"rows in tiles of {block_m}")


def _check(x, w, tile_expert, block_m, tile_rows):
    if x.dim() != 2 or w.dim() != 3:
        raise ValueError(f"x must be [Tp, K] and w [n, K, N], got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if x.shape[1] != w.shape[1]:
        raise ValueError(f"contracting dims mismatch: x {tuple(x.shape)} w "
                         f"{tuple(w.shape)}")
    check_tiles(x.shape[0], block_m, tile_expert, tile_rows)
    if x.requires_grad or w.requires_grad:
        raise NotImplementedError(
            "grouped_matmul's backward (the transposed product and the "
            "per-expert weight gradient) is ported with the training slice")


def row_mask(Tp: int, block_m: int, tile_rows: torch.Tensor) -> torch.Tensor:
    """[Tp] bool: the rows below each tile's routed-row count."""
    within = torch.arange(Tp, device=tile_rows.device) % block_m
    return within < tile_rows.repeat_interleave(block_m)


def grouped_matmul_reference(x: torch.Tensor, w: torch.Tensor,
                             tile_expert: torch.Tensor, block_m: int = 128,
                             tile_rows: torch.Tensor | None = None
                             ) -> torch.Tensor:
    """The plain version: each row times its tile's expert weight (cast to
    x's dtype), in fp32; rows past ``tile_rows`` are zero. ``[Tp, N]`` in
    x's dtype."""
    _check(x, w, tile_expert, block_m, tile_rows)
    return tiled_reference(x, tile_expert, block_m, tile_rows,
                           lambda e: w[e].to(x.dtype).float())


def tiled_reference(x, tile_expert, block_m, tile_rows, weight_of):
    """``x`` tile by tile (tile t in fp32 times ``weight_of(expert)``, an
    fp32 ``[K, N]``; each expert's weight made once), rows past
    ``tile_rows`` zeroed, in x's dtype. Reads ``tile_expert`` back to the
    host: a plain version for the CPU and for checks, never a serving path
    on the card."""
    Tp, K = x.shape
    xt = x.float().reshape(Tp // block_m, block_m, K)
    weights: dict[int, torch.Tensor] = {}
    tiles = []
    for t, e in enumerate(tile_expert.tolist()):
        if e not in weights:
            weights[e] = weight_of(e)
        tiles.append(xt[t] @ weights[e])
    out = torch.cat(tiles) if tiles else x.new_zeros((0, 0)).float()
    if tile_rows is not None:
        out = out * row_mask(Tp, block_m, tile_rows)[:, None]
    return out.to(x.dtype)


def grouped_matmul(x: torch.Tensor, w: torch.Tensor,
                   tile_expert: torch.Tensor, block_m: int = 128,
                   tile_rows: torch.Tensor | None = None) -> torch.Tensor:
    """``x`` [Tp, K] expert-sorted and aligned (``Tp % block_m == 0``, each
    tile owned by expert ``tile_expert[t]``) times ``w`` [n, K, N] → [Tp, N]
    in x's dtype (fp32 or bf16; ``w`` in the same dtype on the card).
    ``tile_rows`` (optional) limits each tile to its routed rows; without
    it every row is computed."""
    _check(x, w, tile_expert, block_m, tile_rows)
    if x.device.type == "cpu":
        counts.plain += 1
        return grouped_matmul_reference(x, w, tile_expert, block_m,
                                        tile_rows)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    return _launch_kernel(x, w, tile_expert, block_m, tile_rows)


# ---------------------------------------------------------------------------
# the CUDA kernel's launch
# ---------------------------------------------------------------------------

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def check_kernel_operands(x, block_m, tile_expert, tile_rows, weights):
    """Device, dtype, contiguity and alignment checks shared by the K5 and
    K3 launches; returns (tile_expert, tile_rows) as contiguous int32 (a
    tile_rows of ``block_m`` everywhere when None)."""
    dev = x.device
    if x.dtype not in _DTYPES:
        raise ValueError(f"kernel dtype must be float32 or bfloat16, got "
                         f"{x.dtype}")
    if block_m % KERNEL_ROWS:
        raise ValueError(f"block_m {block_m} must be a multiple of "
                         f"{KERNEL_ROWS} on the card")
    if tile_rows is None:
        tile_rows = torch.full_like(tile_expert, block_m, dtype=torch.int32)
    tile_expert = tile_expert.to(torch.int32).contiguous()
    tile_rows = tile_rows.to(torch.int32).contiguous()
    for name, t in (("x", x), ("tile_expert", tile_expert),
                    ("tile_rows", tile_rows), *weights):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, x on {dev}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte "
                             f"aligned")
    return tile_expert, tile_rows


def _launch_kernel(x, w, tile_expert, block_m, tile_rows):
    from . import kernels

    if w.dtype != x.dtype:
        raise ValueError(f"w is {w.dtype}, x {x.dtype}: the kernel takes one "
                         f"dtype")
    Tp, K = x.shape
    n, _, N = w.shape
    if K % 8 or N % 8:
        raise ValueError(f"K={K} and N={N} must be multiples of 8 (16-byte "
                         f"rows)")
    te, rows = check_kernel_operands(x, block_m, tile_expert, tile_rows,
                                     [("w", w)])
    out = torch.empty((Tp, N), dtype=x.dtype, device=x.device)
    lib = kernels.load("grouped_matmul")
    err = lib.ds_grouped_matmul(
        x.data_ptr(), w.data_ptr(), te.data_ptr(), rows.data_ptr(),
        out.data_ptr(), Tp, K, N, n, block_m, _DTYPES[x.dtype],
        torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"grouped-matmul kernel launch failed: CUDA error "
                           f"{err}")
    counts.kernel += 1
    return out
