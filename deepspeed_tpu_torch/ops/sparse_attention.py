"""Block-sparse attention: the sparsity configs, their block layouts and the
module that applies them.

Counterpart of ``deepspeed_tpu/ops/sparse_attention.py`` (DeepSpeed's
``deepspeed.ops.sparse_attention``: ``SparsityConfig`` and its variants,
``SparseSelfAttention``). Each config emits a per-head block layout
``[heads, nq_blocks, nk_blocks]`` of which key blocks each query block
attends; the layouts are bit-identical to the JAX package's, down to the
order of the ``random.Random(seed)`` draws.

:func:`block_sparse_attention` routes a call the way the JAX dispatcher does:
- to K6, the block-sparse flash kernel (``ops/block_sparse_attention.py``),
  when its gate holds (blocks of at least 128, whole blocks, one KV head per
  q head, D in 64/128/256, one process);
- otherwise to the masked dense route: :func:`ops.attention.plain_attention`
  with the layout expanded to a token mask, rows that see no key giving
  zeros. That is the reference's own route for the calls the gate refuses,
  never a stand-in for a kernel that failed.
"""
from __future__ import annotations

import random
from dataclasses import dataclass, field

import numpy as np
import torch


# ---------------------------------------------------------------------------
# Sparsity configs
# ---------------------------------------------------------------------------
@dataclass
class SparsityConfig:
    """Block size and head layout sharing."""
    num_heads: int
    block: int = 16
    different_layout_per_head: bool = False

    #: configs whose pattern actually varies per head (random components);
    #: the deterministic ones would produce H identical copies
    SUPPORTS_PER_HEAD = False

    def setup_layout(self, seq_len: int) -> np.ndarray:
        if seq_len % self.block:
            raise ValueError(f"seq_len {seq_len} not divisible by block "
                             f"{self.block}")
        if self.different_layout_per_head and not self.SUPPORTS_PER_HEAD:
            raise ValueError(
                f"{type(self).__name__} is deterministic — "
                f"different_layout_per_head would just replicate one layout "
                f"{self.num_heads}x (use BigBird/Variable for per-head "
                f"randomness)")
        n = seq_len // self.block
        heads = self.num_heads if self.different_layout_per_head else 1
        return np.zeros((heads, n, n), dtype=np.int64)

    def expand(self, layout: np.ndarray) -> np.ndarray:
        if layout.shape[0] == 1 and self.num_heads > 1:
            layout = np.broadcast_to(
                layout, (self.num_heads, *layout.shape[1:]))
        return layout

    def make_layout(self, seq_len: int) -> np.ndarray:
        raise NotImplementedError


@dataclass
class DenseSparsityConfig(SparsityConfig):
    """All-ones layout: full attention."""

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        layout[:] = 1
        return self.expand(layout)


@dataclass
class FixedSparsityConfig(SparsityConfig):
    """Fixed local + global pattern (the Sparse Transformers pattern): local
    windows of ``num_local_blocks``; the last ``num_global_blocks`` of each
    window attend / are attended globally."""
    num_local_blocks: int = 4
    num_global_blocks: int = 1
    attention: str = "bidirectional"  # or "unidirectional"
    horizontal_global_attention: bool = False

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        h, n, _ = layout.shape
        L, G = self.num_local_blocks, self.num_global_blocks
        for i in range(n):
            w = i // L
            # local window
            lo, hi = w * L, min(n, (w + 1) * L)
            if self.attention == "unidirectional":
                hi = min(hi, i + 1)
            layout[:, i, lo:hi] = 1
            # global columns: last G blocks of every preceding window
            for ww in range(0, n // L + 1):
                g_lo = min(n, (ww + 1) * L - G)
                g_hi = min(n, (ww + 1) * L)
                if self.attention == "unidirectional" and g_lo > i:
                    continue
                layout[:, i, g_lo:min(g_hi, i + 1 if self.attention ==
                                      "unidirectional" else g_hi)] = 1
        if self.horizontal_global_attention:
            for ww in range(0, n // L + 1):
                g_lo = min(n, (ww + 1) * L - G)
                g_hi = min(n, (ww + 1) * L)
                layout[:, g_lo:g_hi, :] = 1
                if self.attention == "unidirectional":
                    for r in range(g_lo, g_hi):
                        layout[:, r, r + 1:] = 0
        return self.expand(layout)


@dataclass
class BigBirdSparsityConfig(SparsityConfig):
    """Random + sliding-window + global blocks."""

    SUPPORTS_PER_HEAD = True
    num_random_blocks: int = 1
    num_sliding_window_blocks: int = 3
    num_global_blocks: int = 1
    attention: str = "bidirectional"
    seed: int = 0

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        h, n, _ = layout.shape
        rng = random.Random(self.seed)
        half = self.num_sliding_window_blocks // 2
        for head in range(h):
            for i in range(n):
                # sliding window
                layout[head, i, max(0, i - half):min(n, i + half + 1)] = 1
                # random blocks
                limit = i + 1 if self.attention == "unidirectional" else n
                if limit > 0:
                    for _ in range(self.num_random_blocks):
                        layout[head, i, rng.randrange(limit)] = 1
        # global: first blocks row + column
        g = self.num_global_blocks
        layout[:, :g, :] = 1
        layout[:, :, :g] = 1
        if self.attention == "unidirectional":
            layout &= np.tril(np.ones((n, n), dtype=np.int64))[None]
        return self.expand(layout)


@dataclass
class BSLongformerSparsityConfig(SparsityConfig):
    """Sliding window + selected global rows / columns."""
    num_sliding_window_blocks: int = 3
    global_block_indices: list[int] = field(default_factory=lambda: [0])
    global_block_end_indices: list[int] | None = None
    attention: str = "bidirectional"

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        h, n, _ = layout.shape
        half = self.num_sliding_window_blocks // 2
        for i in range(n):
            layout[:, i, max(0, i - half):min(n, i + half + 1)] = 1
        if self.global_block_end_indices is None:
            spans = [(i, i + 1) for i in self.global_block_indices]
        else:
            spans = list(zip(self.global_block_indices,
                             self.global_block_end_indices))
        for lo, hi in spans:
            lo, hi = min(lo, n), min(hi, n)
            layout[:, lo:hi, :] = 1
            layout[:, :, lo:hi] = 1
        if self.attention == "unidirectional":
            layout &= np.tril(np.ones((n, n), dtype=np.int64))[None]
        return self.expand(layout)


@dataclass
class VariableSparsityConfig(SparsityConfig):
    """Variable local windows + custom global indices."""

    SUPPORTS_PER_HEAD = True
    num_random_blocks: int = 0
    local_window_blocks: list[int] = field(default_factory=lambda: [4])
    global_block_indices: list[int] = field(default_factory=lambda: [0])
    global_block_end_indices: list[int] | None = None
    attention: str = "bidirectional"
    seed: int = 0

    def make_layout(self, seq_len: int) -> np.ndarray:
        layout = self.setup_layout(seq_len)
        h, n, _ = layout.shape
        # variable-size local windows, cycling the last size
        i = 0
        sizes = list(self.local_window_blocks)
        while i < n:
            size = sizes.pop(0) if sizes else self.local_window_blocks[-1]
            lo, hi = i, min(n, i + size)
            layout[:, lo:hi, lo:hi] = 1
            i = hi
        rng = random.Random(self.seed)
        for head in range(h):
            for r in range(n):
                for _ in range(self.num_random_blocks):
                    layout[head, r, rng.randrange(n)] = 1
        if self.global_block_end_indices is None:
            spans = [(g, g + 1) for g in self.global_block_indices]
        else:
            spans = list(zip(self.global_block_indices,
                             self.global_block_end_indices))
        for lo, hi in spans:
            lo, hi = min(lo, n), min(hi, n)
            layout[:, lo:hi, :] = 1
            layout[:, :, lo:hi] = 1
        if self.attention == "unidirectional":
            layout &= np.tril(np.ones((n, n), dtype=np.int64))[None]
        return self.expand(layout)


SPARSITY_CONFIGS = {
    "dense": DenseSparsityConfig,
    "fixed": FixedSparsityConfig,
    "bigbird": BigBirdSparsityConfig,
    "bslongformer": BSLongformerSparsityConfig,
    "variable": VariableSparsityConfig,
}


# ---------------------------------------------------------------------------
# Attention over a block layout
# ---------------------------------------------------------------------------
def layout_to_mask(layout: np.ndarray, block: int,
                   device: torch.device | str | None = None) -> torch.Tensor:
    """[H, nq, nk] block layout → [H, S, S] boolean attend-mask."""
    m = torch.as_tensor(np.asarray(layout, bool), device=device)
    return m.repeat_interleave(block, dim=1).repeat_interleave(block, dim=2)


def block_sparse_attention(q, k, v, layout: np.ndarray, block: int,
                           scale: float | None = None,
                           causal: bool = False) -> torch.Tensor:
    """Attention restricted to the layout's visible blocks.

    q/k/v: [B, S, H, D] (k/v may have fewer heads: GQA takes the masked
    route). The layout handles block-level visibility; ``causal=True`` also
    applies the token-level triangular mask inside visible blocks. Rows that
    see no key give zeros."""
    from .attention import plain_attention
    from .block_sparse_attention import (block_sparse_flash_attention,
                                         block_sparse_usable)

    B, S, H, D = q.shape
    if scale is not None and abs(scale - D ** -0.5) > 1e-12:
        q = q * (scale * D ** 0.5)  # fold a custom scale into q

    if block_sparse_usable(layout, block, S, D, H, k.shape[2]):
        return block_sparse_flash_attention(q, k, v, np.asarray(layout),
                                            block, causal=causal)

    mask = layout_to_mask(layout, block, q.device)          # [H, S, S]
    if causal:
        mask = mask & torch.ones(S, S, dtype=torch.bool,
                                 device=q.device).tril()[None]
    # the dense route masks with finfo.min, so all-masked rows stay NaN-free
    # forward and backward; their outputs are zeroed afterwards
    out = plain_attention(q, k, v, causal=False, mask=mask[None])
    row_any = mask.any(dim=-1)                              # [H, S]
    return torch.where(row_any.T[None, :, :, None], out, 0.0)


class SparseSelfAttention(torch.nn.Module):
    """Holds a sparsity config, builds and caches its layout per sequence
    length, and applies block-sparse attention to [B, S, H, D] q/k/v;
    ``attention="unidirectional"`` configs are causal."""

    def __init__(self, sparsity_config: SparsityConfig,
                 scale: float | None = None):
        super().__init__()
        self.config = sparsity_config
        self.scale = scale
        self._layouts: dict[int, np.ndarray] = {}

    def get_layout(self, seq_len: int) -> np.ndarray:
        if seq_len not in self._layouts:
            self._layouts[seq_len] = self.config.make_layout(seq_len)
        return self._layouts[seq_len]

    def forward(self, q, k, v) -> torch.Tensor:
        layout = self.get_layout(q.shape[1])
        causal = getattr(self.config, "attention", "") == "unidirectional"
        return block_sparse_attention(q, k, v, layout, self.config.block,
                                      scale=self.scale, causal=causal)

    def sparsity(self, seq_len: int) -> float:
        layout = self.get_layout(seq_len)
        return 1.0 - float(layout.mean())
