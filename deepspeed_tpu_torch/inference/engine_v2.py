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
same streams. Features of later slices (speculative decoding, tensor
parallelism, KV tiering, telemetry, request tracing, sliding windows, MoE)
raise NotImplementedError at construction.

Quantized serving: ``quant_bits`` (8, 4 or "fp8") turns every matmul weight
into codes + scales (``ops/quant_matmul.py``) whose products run the
in-tile-dequant kernel K2; ``kv_cache_dtype="fp8"`` stores the pool as e4m3,
read by K1's e4m3 form and written through the JAX package's e4m3 cast.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from ..accelerator import get_device, is_sm90
from ..models.transformer import (TransformerLM, alibi_slopes, apply_rope,
                                  check_served_family, dense_ffn, norm,
                                  proj_heads, proj_out)
from ..ops.paged_attention import (paged_ragged_attention,
                                   paged_ragged_attention_reference)
from ..ops.quant_matmul import QuantLinear, quant_matmul, quantize_weight, \
    to_e4m3
from ..utils.logging import logger
from .attn_registry import select_attention
from .ragged import StateManager, StepPlan
from .sampling import sample_logits
from .scheduler import SplitFuseScheduler
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


def _refuse_later_slices(cfg: RaggedInferenceConfig, m) -> None:
    """NotImplementedError for every configuration a later slice ports."""
    later = [
        (cfg.spec_decode, "spec_decode",
         "speculative decoding (K1's tree-verify form)"),
        (cfg.quant_bits and cfg.tensor_parallel != 1,
         "quant_bits with tensor_parallel>1",
         "tensor parallelism (per-shard quantization)"),
        (cfg.tensor_parallel != 1 or cfg.tp_overlap, "tensor_parallel>1",
         "tensor parallelism"),
        (cfg.kv_tier, "kv_tier", "KV tiering"),
        (cfg.telemetry, "telemetry=True", "serving telemetry"),
        (cfg.reqtrace, "reqtrace=True", "request tracing"),
        (m.moe is not None, "MoE models",
         "MoE (moe/ and the grouped GEMM kernels K3/K5)"),
        (m.sliding_window, "sliding-window models",
         "K1's window and rolling-ring options"),
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
    def __init__(self, model: TransformerLM, params: dict | None = None,
                 config: RaggedInferenceConfig | dict | None = None):
        """``model`` supplies the configuration and, when ``params`` is
        None, the weights (served without a copy when its dtype and device
        match). ``params`` is a parameter tree with the flax tree's names
        (e.g. ``weights.params_from_jax``). Under ``quant_bits`` the
        engine's tree drops the dense weights it quantizes; the model keeps
        its own, so a caller that wants their memory back drops the model
        once the engine is up."""
        if isinstance(config, dict):
            config = RaggedInferenceConfig(**config)
        self.config = cfg = config or RaggedInferenceConfig()
        self.mcfg = m = model.config
        check_served_family(m)
        _refuse_later_slices(cfg, m)
        self.device = dev = get_device(cfg.device)

        max_blocks_per_seq = -(-cfg.max_seq_len // cfg.block_size)
        self.state = StateManager(cfg.num_blocks, cfg.block_size,
                                  cfg.max_seqs, max_blocks_per_seq)
        self.scheduler = SplitFuseScheduler(self.state, cfg.chunk,
                                            pack=cfg.prefill_pack)
        # shared-prefix KV cache: auto = on for pack-mode serving
        use_pc = cfg.prefix_cache
        if use_pc is None:
            use_pc = self.scheduler.pack
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

        # one attention selection per mode; every decode dispatch counts
        # against it (attn_registry.py)
        self._attn_decode_sel = select_attention(
            mode="decode", device_type=dev.type, num_heads=m.num_heads,
            kv_heads=m.kv_heads, head_dim=m.head_dim,
            block_size=cfg.block_size, use_kernel=cfg.use_pallas_decode,
            alibi=m.position_embedding == "alibi",
            sm90=dev.type == "cuda" and is_sm90(dev))
        if dev.type == "cuda":
            from ..ops import kernels
            # build now; raises on failure
            if self._attn_decode_sel.path == "cuda":
                kernels.load("paged_attention")
            if cfg.quant_bits:
                kernels.load("quant_matmul")
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
                      "prefix_hit_rate": 0.0, f"attn_{sel}_decode": 0}
        logger.info(
            f"engine_v2 up on {dev}: blocks={cfg.num_blocks}x"
            f"{cfg.block_size} pool="
            f"{self.kv_pool.numel() * self.kv_pool.element_size() / 1e6:.0f}"
            f"MB max_seqs={cfg.max_seqs} chunk={cfg.chunk} attention={sel}"
            + (f" ({self._attn_decode_sel.reason})"
               if self._attn_decode_sel.reason else ""))

    def _quantize_weights(self, bits) -> None:
        """Weight-only quantization for serving (the JAX engine's
        ``_quantize_weights`` on one device): every layer's ``wq``, ``wk``,
        ``wv``, ``wo``, ``w_gate``, ``w_up`` and ``w_down`` become
        ``QuantLinear`` codes + scales from the compute-dtype weights, and
        so does the untied ``unembed``; a tied model keeps its embedding
        exact for the gather and projects logits through ``logits_q``, a
        quantized copy of ``embed.T``. The tree drops each dense weight as
        it is replaced."""
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
            f = layer["ffn"]
            for k in ("w_gate", "w_up"):
                if k in f:
                    f[k] = q2d(f[k], E)
            f["w_down"] = q2d(f["w_down"], f["w_down"].shape[0])
        if not m.tie_embeddings:
            P["unembed"] = q2d(P["unembed"], E)
        else:
            P["logits_q"] = q2d(P["embed"].t(), E)
        logger.info(f"engine_v2 quant_bits={bits} weights: "
                    f"{before / 1e6:.0f}MB -> {tree_nbytes(P) / 1e6:.0f}MB")

    # ------------------------------------------------------------------
    # ragged forward
    # ------------------------------------------------------------------
    def _ragged_forward(self, token_ids, positions, slot_map, block_tables,
                        seq_lens, sample_idx, kv_stage=None, stage_fill=None,
                        stage_starts=None):
        """One ragged forward over a read-only pool; returns the logits of
        each row's ``sample_idx`` token, ``[S, V]``.

        Default mode (``kv_stage`` None): the stage is this step's tokens,
        and the pool merge happens HERE, once, after every layer.
        Window mode (``kv_stage`` = (k_buf, v_buf) ``[L, S, KV, Ws, D]``):
        writes stage row ``stage_fill`` of every layer, attends over the
        rows below ``seq_lens``, and leaves the merge to the caller.

        ``block_tables``/``seq_lens``/``stage_starts`` are int32 device
        tensors; ``token_ids``/``positions``/``slot_map`` int64."""
        m, cfg, P = self.mcfg, self.config, self.params
        S, T = token_ids.shape
        bs = cfg.block_size
        KV, D, L = m.kv_heads, m.head_dim, m.num_layers
        window_mode = kv_stage is not None
        q_starts = positions[:, 0].to(torch.int32)
        if stage_starts is None:
            stage_starts = q_starts
        if window_mode:
            k_all, v_all = kv_stage
        else:
            # the JAX engine's stage width: at least 8 rows, page-divisible
            # past one page (the kernel reads only rows below seq_lens)
            Ts = max(8, T)
            if Ts > bs and Ts % bs:
                Ts = -(-Ts // bs) * bs
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
            if window_mode:
                k_st[:, :, stage_fill] = k[:, 0]
                v_st[:, :, stage_fill] = v[:, 0]
            else:
                k_st[:, :, :T] = k.transpose(1, 2)
                v_st[:, :, :T] = v.transpose(1, 2)
            o = self._attention(q, k_st, v_st, li, block_tables, seq_lens,
                                q_starts, stage_starts)
            o = proj_out(o, a["wo"])
            if m.attn_out_bias:
                o = o + a["bo"]
            if m.parallel_block:
                h_ffn = h if m.parallel_block_norms == 1 else \
                    norm(x, p["ln_ffn"], m)
                x = x + o + dense_ffn(h_ffn, p["ffn"], m)
            else:
                x = x + o
                x = x + dense_ffn(norm(x, p["ln_ffn"], m), p["ffn"], m)
        # norm is row-wise: taking each row's sampled token first is exact
        last = x[torch.arange(S, device=x.device), sample_idx]     # [S, E]
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
        if not window_mode:
            # ---- the ONE pool write of this dispatch ---------------------
            ks = k_all[:, :, :, :T].permute(0, 1, 3, 2, 4).reshape(
                L, S * T, KV, D)
            vs = v_all[:, :, :, :T].permute(0, 1, 3, 2, 4).reshape(
                L, S * T, KV, D)
            self._merge_stage(slot_map.reshape(-1), ks, vs)
        return logits

    def _attention(self, q, k_st, v_st, li, block_tables, seq_lens,
                   q_starts, stage_starts):
        """Paged attention of layer ``li`` through the registry's selection:
        the kernel (its plain version on the CPU), or — for ALiBi, a config
        pin, or a CPU geometry the kernel does not take — the plain version
        called directly, outside the kernel's route and its launch count."""
        args = (q, self.kv_pool, k_st, v_st, block_tables, seq_lens,
                q_starts, stage_starts)
        if self._attn_decode_sel.is_kernel:
            return paged_ragged_attention(
                *args, block_size=self.config.block_size, layer_index=li)
        return paged_ragged_attention_reference(
            *args, block_size=self.config.block_size, layer_index=li,
            alibi_slopes=self._alibi_slopes, upcast_pool=True)

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
        Ws = max(8, W)                       # stage rows
        if Ws > bs and Ws % bs:
            Ws = -(-Ws // bs) * bs           # page-divisible past one page
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

    def _dispatch_next(self) -> bool:
        """Dispatch the next scheduled step. Mixed prefill/decode load
        alternates pure prefill steps with decode windows (or [S, 1] decode
        plans when windowing is off). Returns True if something ran."""
        has_prefill, has_decode = self.scheduler.pending_kinds()
        want_decode = has_decode and (not has_prefill or self._serve_toggle)
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
        """Count one decode dispatch against the attention formulation the
        registry selected: a nonzero gather count is the visible sign that
        the kernel did not serve."""
        sel = self._attn_decode_sel
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
        if uid in self.state.seqs:
            self.state.release(uid)
        return self._results.pop(uid, [])

    def step(self) -> dict[int, list[int]]:
        """Dispatch the next scheduled step and commit it. Returns {uid:
        accepted tokens}; an empty dict with nothing dispatched means the
        engine is idle."""
        self._dispatch_next()
        return self._drain()

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

