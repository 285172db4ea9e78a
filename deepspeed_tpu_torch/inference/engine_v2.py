"""Inference engine v2: continuous batching over a paged KV pool (FastGen).

Counterpart of ``deepspeed_tpu/inference/engine_v2.py``, with its public
surface (``put`` / ``step`` / ``query`` / ``flush`` / ``generate`` /
``can_schedule``) and its structure:

- KV lives in ONE block-granular pool per model, ``[L, 2, KV, num_blocks,
  block_size, D]``. Sequences own block lists (host-side allocator,
  ``inference/ragged.py``); the shared-prefix cache points new sequences at
  cached pages.
- Inside a dispatch the pool is read-only: each layer's fresh K/V rides a
  staged buffer that the paged-attention kernel (``ops/paged_attention.py``,
  K1) reads beside the pool pages in one online softmax, and ONE in-place
  index write per dispatch merges the stage into the pool.
- Steps follow the SplitFuse scheduler's plans (prefill chunks, decode
  steps); when every live sequence decodes, a decode WINDOW runs up to
  ``decode_window`` iterations in one dispatch, its fresh K/V accumulating
  in a stage buffer that merges once after the loop.

What differs from the JAX engine: PyTorch runs eagerly, so there are no
compiled programs to cache, stack layers for or warm (``weight_prefetch`` and
``decode_early_exit`` keep their meaning as far as eager execution has one),
and commits are synchronous — the ``max_inflight=0`` behaviour, with the
same streams. Features of later slices (tensor parallelism, KV tiering,
telemetry, request tracing) raise NotImplementedError at construction.

Sliding-window models (mistral) serve from a rolling KV ring: the block
table shrinks to ``nwin`` pages, enough for the window plus one step, and
position p lives in page slot ``(p // block_size) % nwin``; K1 recovers each
pool column's position from the ring. Packing and the prefix cache are off
in ring mode (a ring reuses its pages in place).

Speculative decoding (``spec_decode`` "ngram" or "draft",
``inference/speculative.py``): a round proposes a candidate tree per
decode-ready sequence, runs ONE verify forward through K1's tree form
(per-node positions, ancestors-only mask over the staged node K/V), walks
exact acceptance on the host, merges only the accepted path's K/V into the
pool and commits, all inside one step. It cannot combine with a ring.

Quantized serving: ``quant_bits`` (8, 4 or "fp8") turns every matmul weight
into codes + scales (``ops/quant_matmul.py``) whose products run the
in-tile-dequant kernel K2; ``kv_cache_dtype="fp8"`` stores the pool as e4m3,
read by K1's e4m3 form and written through the JAX package's e4m3 cast.

MoE models (the JAX engine's ``ffn`` MoE branch): every token is routed —
the capacity route with ``drop_tokens=False`` by default, the dropless
route (grouped products, K5) when ``moe.dropless`` is set, and under
``quant_bits`` the routed experts become ``QuantGrouped`` codes served by
the quantized grouped product K3 over a dropless sort in tiles of
``_MOE_GEMM_BLOCK_M`` rows. The router and qwen2-moe's shared expert stay
in the compute dtype.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from ..accelerator import get_device, is_sm90
from ..models.transformer import (TransformerLM, add_shared_expert,
                                  alibi_slopes, apply_rope,
                                  check_served_family, dense_ffn,
                                  moe_layer_kwargs, norm, proj_heads,
                                  proj_out)
from ..moe.layer import (dropless_dispatch_combine, expert_ffn, moe_forward,
                         router_logits)
from ..moe.sharded_moe import topk_dropless_gating
from ..ops.paged_attention import (paged_ragged_attention,
                                   paged_ragged_attention_reference)
from ..ops.quant_matmul import (QuantGrouped, QuantLinear,
                                quant_grouped_matmul, quant_matmul,
                                quantize_grouped, quantize_weight, to_e4m3)
from ..utils.logging import logger
from .attn_registry import select_attention
from .ragged import StateManager, StepPlan
from .sampling import sample_logits, sample_tree_logits
from .scheduler import SpecAcceptTracker, SplitFuseScheduler
from .weights import cast_tree, module_param_tree, tree_nbytes


@dataclass
class RaggedInferenceConfig:
    """The JAX engine's ``RaggedInferenceConfig``: same fields and defaults
    (see ``deepspeed_tpu/inference/engine_v2.py`` for each one's meaning),
    ``dtype`` a torch dtype, plus the ``device`` to serve on (None = the
    CUDA device; ``"cpu"`` runs the kernels' plain versions)."""
    block_size: int = 64
    num_blocks: int = 64
    max_seqs: int = 8
    chunk: int = 64
    max_seq_len: int = 2048
    dtype: Any = torch.bfloat16
    tensor_parallel: int = 1
    greedy: bool = True
    temperature: float = 1.0
    top_k: int = 0
    top_p: float = 1.0
    #: paged-attention kernel pin: None = auto (the kernel; on a CUDA
    #: device a geometry it cannot take raises), False = the plain version
    #: called directly, True = require the kernel
    use_pallas_decode: bool | None = None
    decode_window: int = 8
    decode_window_mixed_cap: int = 4
    #: stop a decode window as soon as every slot is done (one host sync
    #: per iteration); False runs all W iterations, as the JAX scan does
    decode_early_exit: bool = False
    #: an XLA scheduling hint in the JAX engine; eager PyTorch has no
    #: counterpart, so it is accepted and has no effect
    weight_prefetch: bool = True
    #: accepted; commits are synchronous in this slice (max_inflight=0)
    max_inflight: int = 8
    quant_bits: int | str | None = None
    prefill_pack: bool = True
    prefix_cache: bool | None = None
    kv_tier: bool = False
    kv_tier_ram_bytes: int = 64 << 20
    kv_tier_nvme_dir: str | None = None
    kv_tier_nvme_bytes: int = 256 << 20
    kv_tier_min_pages: int | None = None
    kv_cache_dtype: str | None = None
    tp_overlap: bool | None = None
    tp_overlap_min_rows: int = 64
    #: the JAX engine's switch for its small-M XLA route; K2 takes its
    #: decode form for M <= 16 rows by itself, so it has no effect here
    #: (``quant_matmul(small_m_xla=...)`` forces a form)
    quant_small_m_xla: bool | None = None
    spec_decode: str | None = None
    spec_depth: int = 4
    spec_max_nodes: int = 8
    spec_branches: int = 2
    spec_ngram_max: int = 3
    spec_ngram_min: int = 1
    spec_depth_mixed_cap: int = 2
    spec_adapt: bool = True
    spec_verify_pallas: bool | None = None
    telemetry: bool | None = None
    reqtrace: bool | None = None
    reqtrace_sample: float | None = None
    slo_ttft_s: float | None = None
    slo_tbt_s: float | None = None
    device: Any = None


def _refuse_later_slices(cfg: RaggedInferenceConfig) -> None:
    """NotImplementedError for every configuration a later slice ports."""
    later = [
        (cfg.quant_bits and cfg.tensor_parallel != 1,
         "quant_bits with tensor_parallel>1",
         "tensor parallelism (per-shard quantization)"),
        (cfg.tensor_parallel != 1 or cfg.tp_overlap, "tensor_parallel>1",
         "tensor parallelism"),
        (cfg.kv_tier, "kv_tier", "KV tiering"),
        (cfg.telemetry, "telemetry=True", "serving telemetry"),
        (cfg.reqtrace, "reqtrace=True", "request tracing"),
    ]
    for on, what, slice_ in later:
        if on:
            raise NotImplementedError(
                f"{what}: not ported yet — arrives with the port's slice for "
                f"{slice_}")
    if cfg.kv_cache_dtype not in (None, "fp8"):
        raise ValueError(f"kv_cache_dtype must be None or 'fp8', got "
                         f"{cfg.kv_cache_dtype!r}")
    if cfg.quant_bits not in (None, 4, 8, "fp8"):
        raise ValueError(f"quant_bits must be 4, 8 or 'fp8', got "
                         f"{cfg.quant_bits!r}")


class InferenceEngineV2:
    #: token-tile size shared by the quantized-MoE sort alignment and the
    #: grouped quantized product K3 (the JAX engine's value: a serving step
    #: carries few tokens, so small tiles waste less padding)
    _MOE_GEMM_BLOCK_M = 32

    def __init__(self, model: TransformerLM, params: dict | None = None,
                 config: RaggedInferenceConfig | dict | None = None,
                 draft_model: TransformerLM | None = None,
                 draft_params: dict | None = None):
        """``model`` supplies the configuration and, when ``params`` is
        None, the weights (served without a copy when its dtype and device
        match). ``params`` is a parameter tree with the flax tree's names
        (e.g. ``weights.params_from_jax``). Under ``quant_bits`` the
        engine's tree drops the dense weights it quantizes; the model keeps
        its own, so a caller that wants their memory back drops the model
        once the engine is up. ``draft_model`` / ``draft_params`` are the
        draft of ``spec_decode="draft"``, served by a second engine."""
        if isinstance(config, dict):
            config = RaggedInferenceConfig(**config)
        self.config = cfg = config or RaggedInferenceConfig()
        self.mcfg = m = model.config
        check_served_family(m)
        _refuse_later_slices(cfg)
        self.device = dev = get_device(cfg.device)

        max_blocks_per_seq = -(-cfg.max_seq_len // cfg.block_size)
        # a sliding-window model only needs the last window (plus the step
        # being written) resident: the block table shrinks to a ring of
        # nwin pages (the JAX engine's rolling cache)
        self._ring_tokens = 0
        W = m.sliding_window
        if W and W < cfg.max_seq_len:
            step_max = max(cfg.chunk, max(cfg.decode_window, 1))
            nwin = -(-(W + step_max) // cfg.block_size) + 1
            if nwin < max_blocks_per_seq:
                max_blocks_per_seq = nwin
                self._ring_tokens = nwin * cfg.block_size
        self.state = StateManager(cfg.num_blocks, cfg.block_size,
                                  cfg.max_seqs, max_blocks_per_seq)
        # packing is off in ring mode: the ring is sized for chunk-at-most
        # steps, and a grown chunk would overrun it
        self.scheduler = SplitFuseScheduler(
            self.state, cfg.chunk,
            pack=cfg.prefill_pack and not self._ring_tokens)
        # shared-prefix KV cache: auto = on for pack-mode linear serving
        use_pc = cfg.prefix_cache
        if use_pc is None:
            use_pc = self.scheduler.pack and not self._ring_tokens
        if use_pc and self._ring_tokens:
            raise ValueError(
                "prefix_cache=True cannot combine with a sliding-window "
                "rolling KV ring: ring tables reuse page slots in place, so a "
                "published page's content would change under a reader "
                "(serve linear or set prefix_cache=False)")
        self._prefix_cache = None
        if use_pc:
            from .prefix_cache import PrefixCache
            self._prefix_cache = PrefixCache(cfg.block_size)
            self.state.attach_prefix_cache(self._prefix_cache)

        self.params = (module_param_tree(model, dtype=cfg.dtype, device=dev)
                       if params is None
                       else cast_tree(params, dtype=cfg.dtype, device=dev))
        missing = [i for i in range(m.num_layers)
                   if f"layer_{i}" not in self.params]
        if missing:
            raise ValueError(f"parameter tree lacks layers {missing}")
        if cfg.quant_bits:
            self._quantize_weights(cfg.quant_bits)

        # the paged KV pool, [L, 2, KV, num_blocks, block_size, D], in the
        # compute dtype or e4m3; block 0 is the trash block padded tokens
        # write to
        kv_dtype = (torch.float8_e4m3fn if cfg.kv_cache_dtype == "fp8"
                    else cfg.dtype)
        self.kv_pool = torch.zeros(
            (m.num_layers, 2, m.kv_heads, cfg.num_blocks, cfg.block_size,
             m.head_dim), dtype=kv_dtype, device=dev)

        # one attention selection per mode; every decode and verify
        # dispatch counts against its mode's (attn_registry.py)
        sel_kw = dict(device_type=dev.type, num_heads=m.num_heads,
                      kv_heads=m.kv_heads, head_dim=m.head_dim,
                      block_size=cfg.block_size,
                      use_kernel=cfg.use_pallas_decode,
                      alibi=m.position_embedding == "alibi",
                      sm90=dev.type == "cuda" and is_sm90(dev))
        self._attn_decode_sel = select_attention(mode="decode", **sel_kw)
        self._attn_tree_sel = select_attention(
            mode="tree", verify_pin=cfg.spec_verify_pallas, **sel_kw)
        if dev.type == "cuda":
            from ..ops import kernels
            # build now; raises on failure
            if "cuda" in (self._attn_decode_sel.path,
                          self._attn_tree_sel.path):
                kernels.load("paged_attention")
            if cfg.quant_bits:
                kernels.load("quant_matmul")
            elif m.moe is not None and m.moe.dropless:
                kernels.load("grouped_matmul")
        self._alibi_slopes = (alibi_slopes(m.num_heads, device=dev)
                              if m.position_embedding == "alibi" else None)

        self._gen = torch.Generator(device=dev)
        self._gen.manual_seed(17)
        self._results: dict[int, list[int]] = {}
        # dispatched steps awaiting their commit (drained every step)
        self._inflight: deque = deque()
        # mixed-load alternation: True → the next dispatch prefers decode
        self._serve_toggle = False
        sel = self._attn_decode_sel.path
        self.stats = {"plan_s": 0.0, "dispatch_s": 0.0, "commit_s": 0.0,
                      "dispatches": 0, "prefill_steps": 0,
                      "decode_steps": 0, "windows": 0, "window_iters": 0,
                      "window_iters_max": 0, "prefill_budget_tokens": 0,
                      "prefill_tokens": 0, "decode_tokens": 0,
                      "prefix_hit_tokens": 0, "prefix_lookup_tokens": 0,
                      "prefix_hit_rate": 0.0,
                      # speculative decoding: rounds = verify dispatches,
                      # verifies = per-sequence verify commits,
                      # proposed/accepted = candidate (non-root) tree
                      # tokens, steps_saved = committed tokens beyond the
                      # one a plain decode step would have produced
                      "spec_rounds": 0, "spec_verifies": 0,
                      "spec_proposed": 0, "spec_accepted": 0,
                      "spec_steps_saved": 0, "spec_accept_rate": 0.0,
                      f"attn_{sel}_decode": 0,
                      f"attn_{self._attn_tree_sel.path}_tree": 0}

        self._spec = None
        self._spec_tracker = None
        self._draft_engine = None
        # tokens committed by spec rounds inside _dispatch_next, folded
        # into step()'s emitted dict before it returns
        self._spec_emit: dict[int, list[int]] = {}
        if cfg.spec_decode:
            self._init_speculative(draft_model, draft_params)
        logger.info(
            f"engine_v2 up on {dev}: blocks={cfg.num_blocks}x"
            f"{cfg.block_size} pool="
            f"{self.kv_pool.numel() * self.kv_pool.element_size() / 1e6:.0f}"
            f"MB max_seqs={cfg.max_seqs} chunk={cfg.chunk} attention={sel}"
            + (f" ({self._attn_decode_sel.reason})"
               if self._attn_decode_sel.reason else "")
            + (f" ring={self._ring_tokens} tokens" if self._ring_tokens
               else "")
            + (f" spec={cfg.spec_decode}" if cfg.spec_decode else ""))

    def _init_speculative(self, draft_model, draft_params) -> None:
        """The configured proposer and the per-request accept-rate tracker.
        ``spec_decode="draft"`` builds a SECOND engine for the draft model
        — its own pool, allocator and scheduler, plain decode steps (a
        decode window would run past the ``depth`` tokens a round asks
        for)."""
        cfg = self.config
        from .speculative import DraftModelProposer, NGramProposer

        if cfg.spec_decode not in ("ngram", "draft"):
            raise ValueError(f"spec_decode must be None, 'ngram' or "
                             f"'draft', got {cfg.spec_decode!r}")
        if self._ring_tokens:
            raise ValueError(
                "spec_decode cannot combine with a sliding-window rolling "
                "KV ring: provisional verify slots past the committed tail "
                "would alias live ring pages (serve linear or disable "
                "spec_decode)")
        if cfg.spec_depth < 1:
            raise ValueError(f"spec_depth must be >= 1, got {cfg.spec_depth}")
        if cfg.spec_max_nodes < 2:
            raise ValueError(f"spec_max_nodes must be >= 2 (root + one "
                             f"candidate), got {cfg.spec_max_nodes}")
        # a chain of depth d is d+1 nodes: depth never exceeds the budget
        base_depth = min(cfg.spec_depth, cfg.spec_max_nodes - 1)
        self._spec_tracker = SpecAcceptTracker(base_depth)
        if cfg.spec_decode == "ngram":
            self._spec = NGramProposer(
                base_depth, ngram_max=cfg.spec_ngram_max,
                ngram_min=cfg.spec_ngram_min, branches=cfg.spec_branches,
                max_nodes=cfg.spec_max_nodes)
            return
        if draft_model is None:
            raise ValueError("spec_decode='draft' needs a draft_model= "
                             "(and usually draft_params=) at engine "
                             "construction")
        self._draft_engine = InferenceEngineV2(
            draft_model, params=draft_params, config={
                "block_size": cfg.block_size,
                "num_blocks": cfg.num_blocks,
                "max_seqs": cfg.max_seqs,
                "chunk": cfg.chunk,
                # a mirror may run past its depth while a slower mirror
                # catches up (up to 2*depth+4 draft steps a round); the
                # next rewind discards the surplus
                "max_seq_len": cfg.max_seq_len + 2 * base_depth + 4,
                "dtype": cfg.dtype,
                "greedy": True,          # proposals are the draft argmax
                "decode_window": 1,
                "prefix_cache": False,
                "use_pallas_decode": cfg.use_pallas_decode,
                "device": self.device,
            })
        self._spec = DraftModelProposer(self._draft_engine)

    def _quantize_weights(self, bits) -> None:
        """Weight-only quantization for serving (the JAX engine's
        ``_quantize_weights`` on one device): every layer's ``wq``, ``wk``,
        ``wv``, ``wo``, ``w_gate``, ``w_up`` and ``w_down`` become
        ``QuantLinear`` codes + scales from the compute-dtype weights, and
        so does the untied ``unembed``; a tied model keeps its embedding
        exact for the gather and projects logits through ``logits_q``, a
        quantized copy of ``embed.T``. An MoE layer's routed experts become
        ``QuantGrouped`` slabs; its router and shared expert stay exact.
        The tree drops each dense weight as it is replaced."""
        m, P = self.mcfg, self.params
        E = m.hidden_size

        def q2d(w, K):
            return quantize_weight(w.float().reshape(K, -1), bits=bits)

        before = tree_nbytes(P)
        for i in range(m.num_layers):
            layer = P[f"layer_{i}"]
            a = layer["attn"]
            for k in ("wq", "wk", "wv"):
                a[k] = q2d(a[k], E)                       # [E, (H|KV)*D]
            a["wo"] = q2d(a["wo"], m.num_heads * m.head_dim)
            if "ffn" in layer:
                f = layer["ffn"]
                for k in ("w_gate", "w_up"):
                    if k in f:
                        f[k] = q2d(f[k], E)
                f["w_down"] = q2d(f["w_down"], f["w_down"].shape[0])
            if "moe" in layer:
                ex = layer["moe"]["moe_layer"]["experts"]
                for k in ("w_gate", "w_up", "w_down"):
                    if k in ex:
                        ex[k] = quantize_grouped(ex[k].float(), bits=bits)
        if not m.tie_embeddings:
            P["unembed"] = q2d(P["unembed"], E)
        else:
            P["logits_q"] = q2d(P["embed"].t(), E)
        logger.info(f"engine_v2 quant_bits={bits} weights: "
                    f"{before / 1e6:.0f}MB -> {tree_nbytes(P) / 1e6:.0f}MB")

    # ------------------------------------------------------------------
    # ragged forward
    # ------------------------------------------------------------------
    def _stage_rows(self, T: int) -> int:
        """The JAX engine's stage width for T fresh tokens: at least 8 rows,
        page-divisible past one page."""
        bs = self.config.block_size
        Ts = max(8, T)
        return -(-Ts // bs) * bs if Ts > bs else Ts

    def _ragged_forward(self, token_ids, positions, slot_map, block_tables,
                        seq_lens, sample_idx, kv_stage=None, stage_fill=0,
                        stage_starts=None, tree_mask=None):
        """One ragged forward over a read-only pool; returns the logits of
        each row's ``sample_idx`` token, ``[S, V]`` (every row's, ``[S, T,
        V]``, when ``sample_idx`` is None).

        Default mode (``kv_stage`` None): the stage is this step's tokens,
        and the pool merge happens HERE, once, after every layer.
        Caller-staged mode (``kv_stage`` = (k_buf, v_buf) ``[L, S, KV, Ws,
        D]``): writes this step's tokens at stage rows ``stage_fill..``,
        attends over the rows below ``seq_lens``, and leaves the merge to
        the caller — a decode window's iterations, or the verify forward.
        Tree mode (``tree_mask`` ``[S, T, T]``): the speculative verify
        forward; row t is a candidate-tree node at ``positions[:, t]``
        (root + depth) that sees the staged nodes its mask allows, through
        the registry's tree selection.

        ``block_tables``/``seq_lens``/``stage_starts`` are int32 device
        tensors; ``token_ids``/``positions``/``slot_map`` int64."""
        m, cfg, P = self.mcfg, self.config, self.params
        S, T = token_ids.shape
        KV, D, L = m.kv_heads, m.head_dim, m.num_layers
        staged = kv_stage is not None
        q_starts = positions[:, 0].to(torch.int32)
        if stage_starts is None:
            stage_starts = q_starts
        tree = None
        if tree_mask is not None:
            tree = (positions.to(torch.int32), tree_mask)
        if staged:
            k_all, v_all = kv_stage
        else:
            # the kernel reads only rows below seq_lens
            Ts = self._stage_rows(T)
            k_all = torch.empty((L, S, KV, Ts, D), dtype=cfg.dtype,
                                device=self.device)
            v_all = torch.empty_like(k_all)
            k_all[:, :, :, T:] = 0
            v_all[:, :, :, T:] = 0

        x = P["embed"][token_ids]                                  # [S,T,E]
        if m.position_embedding == "learned":
            x = x + P["pos_embed"][positions]
        if "ln_embed" in P:                                        # bloom
            x = norm(x, P["ln_embed"], m)
        for li in range(L):
            p = P[f"layer_{li}"]
            a = p["attn"]
            h = norm(x, p["ln_attn"], m)
            q = proj_heads(h, a["wq"], m.num_heads)    # [S, T, H, D]
            k = proj_heads(h, a["wk"], KV)
            v = proj_heads(h, a["wv"], KV)
            if m.qkv_bias:
                q, k, v = q + a["bq"], k + a["bk"], v + a["bv"]
            if m.position_embedding == "rope":
                q, k = apply_rope(q, k, positions, m.rope_theta,
                                  m.rotary_pct)
            k_st, v_st = k_all[li], v_all[li]           # [S, KV, Ts|Ws, D]
            k_st[:, :, stage_fill:stage_fill + T] = k.transpose(1, 2)
            v_st[:, :, stage_fill:stage_fill + T] = v.transpose(1, 2)
            o = self._attention(q, k_st, v_st, li, block_tables, seq_lens,
                                q_starts, stage_starts, tree)
            o = proj_out(o, a["wo"])
            if m.attn_out_bias:
                o = o + a["bo"]
            if m.parallel_block:
                h_ffn = h if m.parallel_block_norms == 1 else \
                    norm(x, p["ln_ffn"], m)
                x = x + o + self._ffn(h_ffn, p)
            else:
                x = x + o
                x = x + self._ffn(norm(x, p["ln_ffn"], m), p)
        # norm is row-wise: taking each row's sampled token first is exact
        if sample_idx is None:
            last = x.reshape(S * T, -1)                            # [S*T, E]
        else:
            last = x[torch.arange(S, device=x.device), sample_idx]  # [S, E]
        last = norm(last, P["ln_final"], m)
        if "logits_q" in P:             # tied, quantized: an exact gather
            logits = quant_matmul(last, P["logits_q"])
        elif m.tie_embeddings:
            logits = last @ P["embed"].t()
        elif isinstance(P["unembed"], QuantLinear):
            logits = quant_matmul(last, P["unembed"])
        else:
            logits = last @ P["unembed"]
        if m.unembed_bias:
            logits = logits + P["unembed_b"]
        if sample_idx is None:
            logits = logits.reshape(S, T, -1)
        if not staged:
            # ---- the ONE pool write of this dispatch ---------------------
            ks = k_all[:, :, :, :T].permute(0, 1, 3, 2, 4).reshape(
                L, S * T, KV, D)
            vs = v_all[:, :, :, :T].permute(0, 1, 3, 2, 4).reshape(
                L, S * T, KV, D)
            self._merge_stage(slot_map.reshape(-1), ks, vs)
        return logits

    def _ffn(self, h, p):
        """The FFN of a layer over ``h`` [S, T, E]: the dense FFN, or the
        MoE layer. Generation drops no routed token: the capacity route
        runs with ``drop_tokens=False`` (where the dense model's forward
        drops past ``eval_capacity_factor``), the dropless route when
        ``moe.dropless`` is set, the quantized route for ``QuantGrouped``
        experts; then qwen2-moe's shared expert."""
        m = self.mcfg
        if "moe" not in p:
            return dense_ffn(h, p["ffn"], m)
        ml = p["moe"]["moe_layer"]
        if isinstance(ml["experts"]["w_up"], QuantGrouped):
            out = self._quant_moe(ml, h)
        else:
            out, _ = moe_forward(h, ml,
                                 **moe_layer_kwargs(m, drop_tokens=False))
        return add_shared_expert(out, h, p["moe"], m)

    def _quant_moe(self, ml, h):
        """Routed experts over ``QuantGrouped`` slabs: dropless routing and
        the quantized grouped product (K3) in tiles of
        ``_MOE_GEMM_BLOCK_M`` rows — the same routes every token takes
        through the no-drop capacity route, with the same gates."""
        m = self.mcfg
        mo = m.moe
        S, T, E = h.shape
        flat = h.reshape(S * T, E)
        gate = topk_dropless_gating(
            router_logits(flat, ml["gate"]["wg"])[None], mo.top_k,
            normalize_gates=mo.normalize_gates)
        bm = self._MOE_GEMM_BLOCK_M

        def gemm(buf, srt):
            def mm(z, w):
                return quant_grouped_matmul(z, w, srt.tile_expert,
                                            block_m=bm,
                                            tile_rows=srt.tile_rows)

            return expert_ffn(buf, ml["experts"], m.activation, mm)

        out = dropless_dispatch_combine(flat, gate.gates[0], gate.experts[0],
                                        mo.num_experts, mo.top_k, bm, gemm)
        return out.reshape(S, T, E)

    def _attention(self, q, k_st, v_st, li, block_tables, seq_lens,
                   q_starts, stage_starts, tree=None):
        """Paged attention of layer ``li`` through the registry's selection
        for the mode (``tree`` = (node positions, ancestors mask) selects
        the verify form): the kernel (its plain version on the CPU), or —
        for ALiBi, a config pin, or a CPU geometry the kernel does not take
        — the plain version called directly, outside the kernel's route and
        its launch count. A sliding-window model passes its window, and its
        rolling ring when it serves from one, on every path."""
        args = (q, self.kv_pool, k_st, v_st, block_tables, seq_lens,
                q_starts, stage_starts)
        kw = dict(block_size=self.config.block_size, layer_index=li,
                  window=self.mcfg.sliding_window or None,
                  ring_tokens=self._ring_tokens or None)
        if tree is not None:
            kw.update(tree_positions=tree[0], tree_mask=tree[1])
        sel = self._attn_decode_sel if tree is None else self._attn_tree_sel
        if sel.is_kernel:
            return paged_ragged_attention(*args, **kw)
        return paged_ragged_attention_reference(
            *args, **kw, alibi_slopes=self._alibi_slopes, upcast_pool=True)

    def _merge_stage(self, flat_slots, ks, vs):
        """THE pool write: staged K/V rows ``[L, N, KV, D]`` land at flat
        pool slots ``flat_slots[n]`` (block * block_size + offset), padded
        tokens at the trash block. The JAX engine splits this into
        ``_merge_rows`` / ``_merge_pages`` / ``_merge_stage`` to steer XLA's
        layouts; in PyTorch all three are this one in-place index write on
        the pool. An e4m3 pool takes the rows through :func:`to_e4m3`, the
        JAX engine's ``astype`` (NaN past the range, where torch's own cast
        saturates), written as bytes."""
        bs = self.config.block_size
        blk, off = flat_slots // bs, flat_slots % bs
        pool = self.kv_pool
        if pool.dtype == torch.float8_e4m3fn:
            pool = pool.view(torch.uint8)
            ks = to_e4m3(ks).view(torch.uint8)
            vs = to_e4m3(vs).view(torch.uint8)
        pool.select(1, 0)[:, :, blk, off] = ks.permute(0, 2, 1, 3)
        pool.select(1, 1)[:, :, blk, off] = vs.permute(0, 2, 1, 3)

    def _sample(self, logits):
        cfg = self.config
        return sample_logits(logits.float(), self._gen,
                             temperature=cfg.temperature, top_k=cfg.top_k,
                             top_p=cfg.top_p, greedy=cfg.greedy)

    # ------------------------------------------------------------------
    # dispatches
    # ------------------------------------------------------------------
    def _program(self, plan: StepPlan):
        """Run one scheduler plan (a prefill chunk step or a decode step)
        and return its sampled tokens, one per plan row, on the device."""
        if plan.use_last.any():
            raise RuntimeError("plan reads an in-flight token, but commits "
                               "are synchronous in this engine")
        dev = self.device

        def up(a, dtype):
            return torch.from_numpy(a).to(device=dev, dtype=dtype)

        logits = self._ragged_forward(
            up(plan.token_ids, torch.long), up(plan.positions, torch.long),
            up(plan.slot_map, torch.long), up(plan.block_tables, torch.int32),
            up(plan.seq_lens, torch.int32), up(plan.sample_idx, torch.long))
        return self._sample(logits)

    def _window_program(self, W: int, tok0, pos0, lens0, tables, rem, eos):
        """Up to W chained decode iterations in one dispatch. Slots run
        independently: a slot goes inactive at its eos or when its budget
        ``rem`` is spent; inactive slots emit -1 and their staged rows merge
        into the trash block. Fresh K/V of every iteration accumulates in a
        stage buffer whose base position is fixed at the window's start, and
        merges into the pool once, after the loop. Returns (tokens [W, S],
        iterations that emitted anything), both on the device."""
        cfg, m = self.config, self.mcfg
        bs, dev = cfg.block_size, self.device
        L, KV, D = m.num_layers, m.kv_heads, m.head_dim
        Ws = self._stage_rows(W)
        up = lambda a: torch.from_numpy(a).to(dev)
        tok, pos = up(tok0).long(), up(pos0).long()
        lens, rem, eos = up(lens0), up(rem), up(eos).long()
        tables = up(tables)
        S = tok.shape[0]
        active = rem > 0
        base = pos.to(torch.int32)           # stage base, fixed per window
        kbuf = torch.zeros((L, S, KV, Ws, D), dtype=cfg.dtype, device=dev)
        vbuf = torch.zeros_like(kbuf)
        buf = torch.full((W, S), -1, dtype=torch.long, device=dev)
        slots = torch.zeros((W, S), dtype=torch.long, device=dev)
        zero = torch.zeros(S, dtype=torch.long, device=dev)
        mb = self.state.max_blocks_per_seq
        for i in range(W):
            if cfg.decode_early_exit and not bool(active.any()):
                break
            blk = tables.gather(1, ((pos // bs) % mb)[:, None])[:, 0].long()
            slot = torch.where(active, blk * bs + pos % bs, zero)
            logits = self._ragged_forward(
                tok[:, None], pos[:, None], slot[:, None], tables, lens, zero,
                kv_stage=(kbuf, vbuf), stage_fill=i, stage_starts=base)
            nxt = self._sample(logits)
            buf[i] = torch.where(active, nxt, -1)
            slots[i] = slot
            # slots stop at their eos or when their budget is spent
            nxt_active = active & (nxt != eos) & (i + 1 < rem)
            tok = torch.where(active, nxt, tok)
            pos = torch.where(active, pos + 1, pos)
            lens = torch.where(active, lens + 1, lens)
            active = nxt_active
        # merge the WHOLE window's staged KV into the pool: the one pool
        # write of this dispatch
        ks = kbuf[:, :, :, :W].permute(0, 3, 1, 2, 4).reshape(L, W * S, KV, D)
        vs = vbuf[:, :, :, :W].permute(0, 3, 1, 2, 4).reshape(L, W * S, KV, D)
        self._merge_stage(slots.reshape(-1), ks, vs)
        return buf, (buf >= 0).any(dim=1).sum()

    def _try_dispatch_window(self, prefill_pending: bool = False) -> bool:
        """Decode fast path: up to ``decode_window`` decode iterations in
        one dispatch over the decode-ready slots (others ride along
        inactive). While prefill chunks are pending the window is capped at
        ``decode_window_mixed_cap`` so a waiting chunk is never stuck behind
        a full window."""
        cfg = self.config
        W_max = cfg.decode_window
        if prefill_pending and cfg.decode_window_mixed_cap:
            W_max = min(W_max, cfg.decode_window_mixed_cap)
        if W_max <= 1:
            return False
        live = [s for s in self.state.seqs.values()
                if not s.sched_done and s.slot >= 0 and s.pending_sched == 1]
        if not live:
            return False
        W = min(max(s.gen_remaining_sched for s in live), W_max)
        if W <= 1:
            return False
        W = 1 << (W.bit_length() - 1)        # pow2, like the JAX engine

        t0 = time.perf_counter()
        S, mb = self.state.max_seqs, self.state.max_blocks_per_seq
        tok0 = np.zeros((S,), np.int32)
        pos0 = np.zeros((S,), np.int32)
        lens0 = np.zeros((S,), np.int32)
        tables = np.zeros((S, mb), np.int32)
        rem = np.zeros((S,), np.int32)
        eos = np.full((S,), -1, np.int32)
        sched: dict[int, tuple[int, int]] = {}   # uid -> (slot, n scheduled)
        for s in live:
            sl = s.slot
            tok0[sl] = s.tokens[-1]
            pos0[sl] = s.len_sched - 1
            lens0[sl] = s.len_sched
            tables[sl, :len(s.blocks)] = s.blocks
            n = min(s.gen_remaining_sched, W)
            rem[sl] = n
            if s.eos_id is not None:
                eos[sl] = s.eos_id
            sched[s.uid] = (sl, n)
        self.stats["plan_s"] += time.perf_counter() - t0

        t0 = time.perf_counter()
        self._emit_attn_kernel("decode")
        toks, iters = self._window_program(W, tok0, pos0, lens0, tables, rem,
                                           eos)
        for s in live:
            _, n = sched[s.uid]
            s.n_sched = s.len_sched - 1 + n
            s.n_inflight += n
        self._inflight.append({"kind": "window", "sched": sched,
                               "toks": toks, "iters": iters})
        self.stats["dispatch_s"] += time.perf_counter() - t0
        self.stats["dispatches"] += 1
        self.stats["windows"] += 1
        return True

    def _spec_program(self, tok, pos, tables, lens, mask):
        """The speculative VERIFY forward: one batched tree-masked step over
        the read-only pool (``[S, T]`` candidate-tree nodes per row) that
        samples the target at EVERY node. Returns the staged node K/V
        ``(k_all, v_all)`` ``[L, S, KV, Ts, D]`` and the samples ``[S, T]``
        on the device; the pool is not written here
        (:meth:`_try_dispatch_spec` merges only the accepted path)."""
        cfg, m, dev = self.config, self.mcfg, self.device
        S, T = tok.shape
        up = lambda a: torch.from_numpy(a).to(dev)
        k_all = torch.zeros((m.num_layers, S, m.kv_heads, self._stage_rows(T),
                             m.head_dim), dtype=cfg.dtype, device=dev)
        v_all = torch.zeros_like(k_all)
        logits = self._ragged_forward(
            up(tok).long(), up(pos).long(), None, up(tables), up(lens), None,
            kv_stage=(k_all, v_all), tree_mask=up(mask))
        toks = sample_tree_logits(logits.float(), self._gen,
                                  temperature=cfg.temperature,
                                  top_k=cfg.top_k, top_p=cfg.top_p,
                                  greedy=cfg.greedy)
        return k_all, v_all, toks

    def _try_dispatch_spec(self, prefill_pending: bool = False) -> bool:
        """One speculative round over every decode-ready sequence: propose
        candidate trees (n-gram lookup or draft-model mirrors), run ONE
        batched tree-masked verify forward, walk exact acceptance on the
        host, merge only the accepted path's KV and commit — several tokens
        per target forward when candidates hit, a plain decode's worth when
        they don't. Returns False (nothing dispatched) when no sequence is
        decode-ready or no proposer produced a candidate; the window/plain
        decode path then serves as before.

        The round runs verify → accept → merge → commit inside this call,
        from committed state (commits are synchronous in this engine, so
        nothing is in flight), and no provisional marker outlives it."""
        cfg = self.config
        live = [s for s in self.state.seqs.values()
                if not s.done and s.slot >= 0 and s.pending_tokens == 1
                and s.n_generated < s.max_new_tokens]
        if not live:
            return False

        t0 = time.perf_counter()
        T = cfg.spec_max_nodes
        requests: dict[int, tuple[list[int], int]] = {}
        for s in live:
            d = self._spec_tracker.depth(
                s.uid, prefill_pending=prefill_pending,
                mixed_cap=cfg.spec_depth_mixed_cap)
            # the commit may emit depth+1 tokens (accepted chain + bonus):
            # cap one short of the remaining budget
            d = min(d, s.max_new_tokens - s.n_generated - 1)
            requests[s.uid] = (list(s.tokens), max(d, 0))
        trees = self._spec.propose(requests)
        if all(t.n_candidates == 0 for t in trees.values()):
            self.stats["plan_s"] += time.perf_counter() - t0
            return False     # nothing to verify: plain decode is cheaper

        from .speculative import accept_walk

        S = self.state.max_seqs
        mb = self.state.max_blocks_per_seq
        bs = cfg.block_size
        L, KV, D = self.mcfg.num_layers, self.mcfg.kv_heads, self.mcfg.head_dim
        tok = np.zeros((S, T), np.int32)
        pos = np.zeros((S, T), np.int32)
        tables = np.zeros((S, mb), np.int32)
        lens = np.zeros(S, np.int32)
        mask = np.zeros((S, T, T), np.uint8)
        # every row starts as self-bits only: empty slots and padding nodes
        # must never see an all-masked softmax row
        mask[:, np.arange(T), np.arange(T)] = 1
        meta: dict[int, tuple[int, Any]] = {}    # uid -> (slot, tree)
        try:
            for s in live:
                tree = trees[s.uid]
                depths = tree.depths()
                self.state.provision(s.uid, max(depths))
                sl = s.slot
                n = tree.n_nodes
                tok[sl, :n] = tree.tokens
                root = len(s.tokens) - 1
                pos[sl, :n] = [root + d for d in depths]
                tables[sl, :len(s.blocks)] = s.blocks
                lens[sl] = root + 1 + max(depths)
                mask[sl] = tree.ancestor_mask(T)
                mask[sl, np.arange(n, T), np.arange(n, T)] = 1
                meta[s.uid] = (sl, tree)
            self.stats["plan_s"] += time.perf_counter() - t0

            t0 = time.perf_counter()
            # every verify dispatch counts against the tree selection
            self._emit_attn_kernel("tree")
            k_all, v_all, toks = self._spec_program(tok, pos, tables, lens,
                                                    mask)
            toks_h = toks.cpu().numpy()

            # exact acceptance on the host, then ONE merge of exactly the
            # accepted path's staged rows (everything else → trash block)
            flat = np.zeros(S * T, np.int64)
            accepts: dict[int, list[int]] = {}
            for uid, (sl, tree) in meta.items():
                seq = self.state.seqs[uid]
                accepted, visited = accept_walk(tree,
                                                toks_h[sl, :tree.n_nodes])
                root = len(seq.tokens) - 1
                for i, node in enumerate(visited):
                    p = root + i
                    flat[sl * T + node] = \
                        seq.blocks[(p // bs) % mb] * bs + p % bs
                accepts[uid] = accepted
            ks = k_all[:, :, :, :T].permute(0, 1, 3, 2, 4).reshape(
                L, S * T, KV, D)
            vs = v_all[:, :, :, :T].permute(0, 1, 3, 2, 4).reshape(
                L, S * T, KV, D)
            self._merge_stage(torch.from_numpy(flat).to(self.device), ks, vs)
        except Exception:
            # a failed round leaves no provisional marker behind
            for uid in meta:
                self.state.rollback_provisional(uid)
            raise

        st = self.stats
        for uid, accepted in accepts.items():
            tree = meta[uid][1]
            out = self.state.commit_speculative(uid, accepted)
            n_acc = len(accepted) - 1        # matched candidates
            st["spec_verifies"] += 1
            st["spec_proposed"] += tree.n_candidates
            st["spec_accepted"] += n_acc
            st["spec_steps_saved"] += max(len(out) - 1, 0)
            st["decode_tokens"] += len(out)
            if out:
                self._results[uid].extend(out)
                self._spec_emit.setdefault(uid, []).extend(out)
            if cfg.spec_adapt and tree.n_candidates:
                self._spec_tracker.observe(uid, tree.n_candidates, n_acc)
        st["spec_rounds"] += 1
        st["spec_accept_rate"] = round(
            st["spec_accepted"] / max(st["spec_proposed"], 1), 4)
        st["dispatches"] += 1
        st["decode_steps"] += 1
        st["dispatch_s"] += time.perf_counter() - t0
        return True

    def _dispatch_next(self) -> bool:
        """Dispatch the next scheduled step. Mixed prefill/decode load
        alternates pure prefill steps with decode windows (or [S, 1] decode
        plans when windowing is off). With ``spec_decode``, the decode side
        first offers the step to a speculative round; when no proposer finds
        candidates the window/plain path runs as before. Returns True if
        something ran."""
        has_prefill, has_decode = self.scheduler.pending_kinds()
        want_decode = has_decode and (not has_prefill or self._serve_toggle)
        if self._spec is not None and want_decode and \
                self._try_dispatch_spec(prefill_pending=has_prefill):
            self._serve_toggle = False
            return True
        if want_decode and self._try_dispatch_window(
                prefill_pending=has_prefill):
            self._serve_toggle = False
            return True
        t0 = time.perf_counter()
        plan = self.scheduler.next_step(
            prefer="decode" if want_decode else None)
        self.stats["plan_s"] += time.perf_counter() - t0
        if plan is None:
            return False
        self._serve_toggle = plan.kind == "prefill"
        t0 = time.perf_counter()
        toks = self._program(plan)
        self.scheduler.mark_dispatched(plan)
        self._inflight.append({"kind": "plan", "plan": plan, "toks": toks})
        self.stats["dispatch_s"] += time.perf_counter() - t0
        self.stats["dispatches"] += 1
        n_tok = int(plan.active.sum())
        if plan.kind == "prefill":
            self.stats["prefill_steps"] += 1
            self.stats["prefill_tokens"] += n_tok
            self.stats["prefill_budget_tokens"] += int(
                np.prod(plan.token_ids.shape))
        else:
            self.stats["decode_steps"] += 1
            self.stats["decode_tokens"] += n_tok
            self._emit_attn_kernel("decode")
        return True

    def _drain(self) -> dict:
        """Commit every dispatched step (reading its tokens back blocks on
        the device). Returns {uid: accepted tokens}."""
        emitted: dict[int, list[int]] = {}
        while self._inflight:
            entry = self._inflight.popleft()
            toks_h = entry["toks"].cpu().numpy()
            t0 = time.perf_counter()
            self._commit_entry(entry, toks_h, emitted)
            self.stats["commit_s"] += time.perf_counter() - t0
        return emitted

    def _commit_entry(self, entry: dict, toks_h: np.ndarray,
                      emitted: dict) -> None:
        if entry["kind"] == "window":
            self.stats["window_iters"] += int(entry["iters"])
            self.stats["window_iters_max"] += toks_h.shape[0]
            for uid, (sl, n) in entry["sched"].items():
                seq = self.state.seqs.get(uid)
                if seq is None:
                    continue
                seq.n_inflight -= n
                col = toks_h[:, sl]
                vals = [int(t) for t in col[col >= 0]]   # active prefix
                new = seq.commit_generated(vals, len(vals))
                if new:
                    self._results[uid].extend(new)
                    emitted.setdefault(uid, []).extend(new)
            return
        plan = entry["plan"]
        sampled = {uid: int(toks_h[s]) for s, uid in enumerate(plan.uids)
                   if uid >= 0 and plan.do_sample[s]}
        accepted = self.scheduler.commit(plan, sampled)
        for uid, new in accepted.items():   # stop criteria may drop tokens
            if new:
                self._results[uid].extend(new)
                emitted.setdefault(uid, []).extend(new)

    def _emit_attn_kernel(self, mode: str) -> None:
        """Count one decode or verify dispatch against the attention
        formulation the registry selected for ``mode``: a nonzero gather
        count is the visible sign that the kernel did not serve."""
        sel = self._attn_tree_sel if mode == "tree" else self._attn_decode_sel
        self.stats[f"attn_{sel.path}_{mode}"] += 1

    # ------------------------------------------------------------------
    # public API (reference engine_v2.py put/query/flush)
    # ------------------------------------------------------------------
    def can_schedule(self, prompt_len: int, max_new_tokens: int = 32) -> bool:
        """Admission check against the worst-case block budget (blocks are
        reserved at admit)."""
        return self.state.can_admit(prompt_len, max_new_tokens)

    def put(self, uid: int, prompt_tokens, max_new_tokens: int = 32,
            eos_token_id: int | None = None) -> None:
        """Admit a request. Raises if the pool or slot budget is exhausted —
        callers gate on ``can_schedule``. ``eos_token_id`` stops the
        sequence early (truncated at the eos)."""
        toks = [int(t) for t in prompt_tokens]
        if not toks:
            raise ValueError("empty prompt")
        if len(toks) + max_new_tokens > self.config.max_seq_len:
            raise ValueError("prompt + max_new_tokens exceeds max_seq_len")
        if not self.state.can_admit(len(toks), max_new_tokens):
            raise RuntimeError("cannot schedule: pool/slots exhausted")
        seq = self.state.admit(uid, toks, max_new_tokens,
                               eos_id=eos_token_id)
        self._results[uid] = []
        if self._spec is not None:
            # draft mirrors reserve once, at admit, for the full budget plus
            # the deepest proposal overhang (rewind never reallocates); a
            # refused mirror admit means root-only trees: plain decode
            self._spec.admit(uid, toks,
                             max_new_tokens + self._spec_tracker.base_depth
                             + 1)
        if self._prefix_cache is not None:
            st = self.stats
            st["prefix_hit_tokens"] += seq.prefix_hit_tokens
            st["prefix_lookup_tokens"] += len(toks)
            st["prefix_hit_rate"] = round(
                st["prefix_hit_tokens"] / max(st["prefix_lookup_tokens"], 1),
                4)

    def query(self, uid: int) -> dict:
        """Request status."""
        seq = self.state.seqs.get(uid)
        if seq is None:
            return {"live": False, "generated": self._results.get(uid, [])}
        return {"live": True, "done": seq.done,
                "generated": list(self._results[uid]),
                "n_computed": seq.n_computed}

    def flush(self, uid: int) -> list[int]:
        """Release a request's KV and slot, returning its generated tokens
        (its full pages are published into the prefix cache)."""
        if self._inflight:
            self._drain()
        if self._spec is not None:
            # rounds complete inside a step, but a failed one may be caught
            # by a driver that then flushes: no marker survives the release
            self.state.rollback_provisional(uid)
            self._spec.release(uid)
            self._spec_tracker.forget(uid)
            self._spec_emit.pop(uid, None)
        if uid in self.state.seqs:
            self.state.release(uid)
        return self._results.pop(uid, [])

    def step(self) -> dict[int, list[int]]:
        """Dispatch the next scheduled step and commit it. Returns {uid:
        accepted tokens}; an empty dict with nothing dispatched means the
        engine is idle."""
        self._dispatch_next()
        emitted = self._drain()
        # tokens a spec round committed inside the dispatch
        for uid, new in self._spec_emit.items():
            emitted.setdefault(uid, []).extend(new)
        self._spec_emit = {}
        return emitted

    def generate(self, prompts: list[list[int]], max_new_tokens: int = 32,
                 eos_token_id: int | None = None) -> list[list[int]]:
        """Continuous-batch a set of prompts to completion."""
        pending = list(enumerate(prompts))
        out: dict[int, list[int]] = {}
        live: set[int] = set()
        while pending or live:
            while pending and self.can_schedule(len(pending[0][1]),
                                                max_new_tokens):
                uid, toks = pending.pop(0)
                self.put(uid, toks, max_new_tokens, eos_token_id=eos_token_id)
                live.add(uid)
            if not live:
                raise RuntimeError(
                    f"prompt of {len(pending[0][1])} tokens can never be "
                    f"scheduled with num_blocks={self.config.num_blocks}")
            self.step()
            for uid in list(live):
                seq = self.state.seqs.get(uid)
                if seq is not None and seq.done:
                    out[uid] = self.flush(uid)
                    live.remove(uid)
        return [out[i] for i in range(len(prompts))]

