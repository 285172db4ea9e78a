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
- :func:`grouped_matmul` is differentiable (a ``torch.autograd.Function``,
  the JAX package's ``custom_vjp``): dx is :func:`grouped_matmul_dx`, the
  product with each tile's expert weight transposed (the Pallas kernel's
  ``transpose_rhs`` form), cast to x's dtype; dw is
  :func:`grouped_matmul_dw`, each expert's sum of ``x_tile^T @ dy_tile``
  over its tiles (``_dw_kernel``), accumulated in fp32 and cast to w's
  dtype, zero for an expert that owns no tile. Both route as the forward
  does: their CUDA kernels on the card, their plain versions
  (:func:`grouped_matmul_dx_reference`, :func:`grouped_matmul_dw_reference`)
  on the CPU.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch

from .quant_matmul import LaunchCounts


@dataclass
class GroupedCounts(LaunchCounts):
    """K5's calls by route: ``kernel`` / ``plain`` the forward, ``kernel_dx``
    / ``plain_dx`` and ``kernel_dw`` / ``plain_dw`` the backward's two
    products."""
    kernel_dx: int = 0
    kernel_dw: int = 0
    plain_dx: int = 0
    plain_dw: int = 0


#: calls of :func:`grouped_matmul`, :func:`grouped_matmul_dx` and
#: :func:`grouped_matmul_dw` by route
counts = GroupedCounts()

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


def grouped_matmul_dx_reference(dy: torch.Tensor, w: torch.Tensor,
                                tile_expert: torch.Tensor, block_m: int = 128,
                                tile_rows: torch.Tensor | None = None
                                ) -> torch.Tensor:
    """The plain dx: each row of ``dy`` [Tp, N] times its tile's expert
    weight ``w`` [n, K, N] transposed, in fp32; rows past ``tile_rows`` are
    zero. ``[Tp, K]`` in dy's dtype."""
    _check_dx(dy, w, tile_expert, block_m, tile_rows)
    return tiled_reference(dy, tile_expert, block_m, tile_rows,
                           lambda e: w[e].to(dy.dtype).float().T)


def grouped_matmul_dw_reference(x: torch.Tensor, dy: torch.Tensor,
                                tile_expert: torch.Tensor, num_experts: int,
                                block_m: int = 128,
                                tile_rows: torch.Tensor | None = None,
                                dtype: torch.dtype | None = None
                                ) -> torch.Tensor:
    """The plain dw: for each expert the fp32 sum of ``x_tile^T @ dy_tile``
    over the tiles it owns (rows past ``tile_rows`` left out), zero for an
    expert that owns none; ``[num_experts, K, N]`` in ``dtype`` (x's by
    default). Reads ``tile_expert`` back to the host, as
    :func:`tiled_reference` does."""
    _check_dw(x, dy, tile_expert, num_experts, block_m, tile_rows)
    Tp, K = x.shape
    xf, dyf = x.float(), dy.float()
    if tile_rows is not None:
        routed = row_mask(Tp, block_m, tile_rows)[:, None]
        xf = torch.where(routed, xf, 0.0)
        dyf = torch.where(routed, dyf, 0.0)
    dw = torch.zeros((num_experts, K, dy.shape[1]), dtype=torch.float32,
                     device=x.device)
    row_expert = tile_expert.long().repeat_interleave(block_m)
    for e in sorted(set(tile_expert.tolist())):
        rows = row_expert == e
        dw[e] = xf[rows].T @ dyf[rows]
    return dw.to(dtype or x.dtype)


def _check_dx(dy, w, tile_expert, block_m, tile_rows):
    if dy.dim() != 2 or w.dim() != 3 or dy.shape[1] != w.shape[2]:
        raise ValueError(f"dy must be [Tp, N] and w [n, K, N], got "
                         f"{tuple(dy.shape)} and {tuple(w.shape)}")
    check_tiles(dy.shape[0], block_m, tile_expert, tile_rows)


def _check_dw(x, dy, tile_expert, num_experts, block_m, tile_rows):
    if x.dim() != 2 or dy.dim() != 2 or x.shape[0] != dy.shape[0]:
        raise ValueError(f"x must be [Tp, K] and dy [Tp, N], got "
                         f"{tuple(x.shape)} and {tuple(dy.shape)}")
    if num_experts < 1:
        raise ValueError(f"num_experts must be positive, got {num_experts}")
    check_tiles(x.shape[0], block_m, tile_expert, tile_rows)


def _device_route(t: torch.Tensor) -> bool:
    """True for the CPU's plain route, False for the card's kernel; raises
    for any other device."""
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(f"unsupported device {t.device}")
    return False


class _GroupedMatmul(torch.autograd.Function):
    """:func:`grouped_matmul` with its VJP (the JAX package's ``_gmm_fwd`` /
    ``_gmm_bwd``): saves ``(x, w, tile_expert, tile_rows)``."""

    @staticmethod
    def forward(ctx, x, w, tile_expert, tile_rows, block_m):
        ctx.save_for_backward(x, w, tile_expert, tile_rows)
        ctx.block_m = block_m
        if _device_route(x):
            counts.plain += 1
            return grouped_matmul_reference(x, w, tile_expert, block_m,
                                            tile_rows)
        return _launch_kernel(x, w, tile_expert, block_m, tile_rows)

    @staticmethod
    def backward(ctx, dy):
        x, w, tile_expert, tile_rows = ctx.saved_tensors
        dy = dy.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = grouped_matmul_dx(dy, w, tile_expert, ctx.block_m,
                                   tile_rows).to(x.dtype)
        if ctx.needs_input_grad[1]:
            dw = grouped_matmul_dw(x, dy, tile_expert, w.shape[0],
                                   ctx.block_m, tile_rows, w.dtype)
        return dx, dw, None, None, None


def grouped_matmul(x: torch.Tensor, w: torch.Tensor,
                   tile_expert: torch.Tensor, block_m: int = 128,
                   tile_rows: torch.Tensor | None = None) -> torch.Tensor:
    """``x`` [Tp, K] expert-sorted and aligned (``Tp % block_m == 0``, each
    tile owned by expert ``tile_expert[t]``, which does not decrease) times
    ``w`` [n, K, N] → [Tp, N] in x's dtype (fp32 or bf16; ``w`` in the same
    dtype on the card). ``tile_rows`` (optional) limits each tile to its
    routed rows; without it every row is computed. Differentiable in ``x``
    and ``w``."""
    _check(x, w, tile_expert, block_m, tile_rows)
    return _GroupedMatmul.apply(x, w, tile_expert, tile_rows, block_m)


def grouped_matmul_dx(dy: torch.Tensor, w: torch.Tensor,
                      tile_expert: torch.Tensor, block_m: int = 128,
                      tile_rows: torch.Tensor | None = None) -> torch.Tensor:
    """dx of :func:`grouped_matmul`: ``dy`` [Tp, N] times each tile's expert
    weight ``w`` [n, K, N] transposed → [Tp, K] in dy's dtype; rows past
    ``tile_rows`` are zero. The plain version on the CPU, the kernel on the
    card."""
    _check_dx(dy, w, tile_expert, block_m, tile_rows)
    if _device_route(dy):
        counts.plain_dx += 1
        return grouped_matmul_dx_reference(dy, w, tile_expert, block_m,
                                           tile_rows)
    return _launch_dx(dy, w, tile_expert, block_m, tile_rows)


def grouped_matmul_dw(x: torch.Tensor, dy: torch.Tensor,
                      tile_expert: torch.Tensor, num_experts: int,
                      block_m: int = 128,
                      tile_rows: torch.Tensor | None = None,
                      dtype: torch.dtype | None = None) -> torch.Tensor:
    """dw of :func:`grouped_matmul`: ``[num_experts, K, N]``, each expert's
    fp32 sum of ``x_tile^T @ dy_tile`` over its tiles' routed rows, zero
    for an expert with no tile, in ``dtype`` (x's by default). The plain
    version on the CPU, the kernel on the card."""
    _check_dw(x, dy, tile_expert, num_experts, block_m, tile_rows)
    if _device_route(x):
        counts.plain_dw += 1
        return grouped_matmul_dw_reference(x, dy, tile_expert, num_experts,
                                           block_m, tile_rows, dtype)
    return _launch_dw(x, dy, tile_expert, num_experts, block_m, tile_rows,
                      dtype)


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


def _launch(entry: str, a, b, tile_expert, block_m, tile_rows, out, K, N,
            n) -> None:
    """One launch of ``entry`` (``ds_grouped_matmul``, ``..._dx`` or
    ``..._dw``; they share one C signature) over ``a`` and ``b``, both in
    one dtype, raising on a refused launch."""
    from . import kernels

    if a.dtype != b.dtype:
        raise ValueError(f"the kernel takes one dtype, got {a.dtype} and "
                         f"{b.dtype}")
    if K % 8 or N % 8:
        raise ValueError(f"K={K} and N={N} must be multiples of 8 (16-byte "
                         f"rows)")
    te, rows = check_kernel_operands(a, block_m, tile_expert, tile_rows,
                                     [("second operand", b), ("out", out)])
    lib = kernels.load("grouped_matmul")
    err = getattr(lib, entry)(
        a.data_ptr(), b.data_ptr(), te.data_ptr(), rows.data_ptr(),
        out.data_ptr(), a.shape[0], K, N, n, block_m, _DTYPES[a.dtype],
        torch.cuda.current_stream(a.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"grouped-matmul kernel {entry} launch failed: "
                           f"CUDA error {err}")


def _launch_kernel(x, w, tile_expert, block_m, tile_rows):
    n, K, N = w.shape
    out = torch.empty((x.shape[0], N), dtype=x.dtype, device=x.device)
    _launch("ds_grouped_matmul", x, w, tile_expert, block_m, tile_rows, out,
            K, N, n)
    counts.kernel += 1
    return out


def _launch_dx(dy, w, tile_expert, block_m, tile_rows):
    n, K, N = w.shape
    dx = torch.empty((dy.shape[0], K), dtype=dy.dtype, device=dy.device)
    _launch("ds_grouped_matmul_dx", dy, w, tile_expert, block_m, tile_rows,
            dx, K, N, n)
    counts.kernel_dx += 1
    return dx


def _launch_dw(x, dy, tile_expert, num_experts, block_m, tile_rows, dtype):
    K, N = x.shape[1], dy.shape[1]
    dw = torch.empty((num_experts, K, N), dtype=x.dtype, device=x.device)
    _launch("ds_grouped_matmul_dw", x, dy, tile_expert, block_m, tile_rows,
            dw, K, N, num_experts)
    counts.kernel_dw += 1
    return dw.to(dtype or x.dtype)
