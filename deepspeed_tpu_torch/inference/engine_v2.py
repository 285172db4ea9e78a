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

Dispatch never waits (the JAX engine's async pipeline): the last sampled
token of every slot stays on the device (``_last_tok``), and a plan whose
previous token is still in flight reads it there (``use_last``); each
dispatch's sampled tokens ride a device-to-host copy into a pinned buffer
of its own, and host commits lag up to ``max_inflight`` dispatches behind
(``_drain``). ``max_inflight=0`` commits every dispatch within its
``step()``, the synchronous contract.

Compiled programs: on the card every decode window (``("win", W)``, each
pow2 W up to ``decode_window``) and every decode step plan (``(1,
max_seqs)``) replays a CUDA graph of its eager function, captured once per
key (``inference/programs.py``; ``warm_decode_windows`` and
``warm_decode_step`` capture them ahead of serving). Prefill plans, the speculative verify forward and the
``decode_early_exit`` window (whose host test each iteration is the JAX
``while_loop`` form's exit, which a graph cannot take) run eagerly, equally
asynchronous; on the CPU every program runs eagerly through the kernels'
plain versions. ``weight_prefetch`` (an XLA scheduling hint) has no
counterpart.

Tensor parallelism (``tensor_parallel`` > 1, or a ``topology`` whose
``tensor`` axis is): SPMD, one process per tensor rank (``torchrun``, or
``comm.spawn.RankPool``), each building the engine with the same arguments.
Every rank makes the same host calls and runs the same scheduler, prefix
cache and plans; only the forward is sharded, as the JAX engine's
``tensor`` mesh axis shards it. Each rank holds its slices of the weights
(``weights.load_tp_params``: vocab, heads, kv heads, mlp and the expert FFN
width on ``tensor``) and a pool of its KV heads, ``[L, 2, KV/n, blocks,
block_size, D]``; K1 runs on its query heads, column products on its
columns, row products (``wo``, ``w_down``, the experts' ``w_down``) are
summed over the tensor group; the embedding is a masked lookup of this
rank's vocabulary rows summed over the group, and the logits' vocabulary
columns are gathered in rank order before sampling, so every rank samples
the same tokens from the same seeded generator. ``quant_bits`` quantizes
each rank's slices (group boundaries inside shards, the JAX engine's
``shard_map(quantize_weight)``). ``tp_overlap`` (None: programs of at least
``tp_overlap_min_rows`` rows a chunk; True: every program whose rows divide
the axis) runs the residual stream token-sharded and the projections as
ring collective matmuls (``parallel/tensor.py``): QKV and the GLU pair each
one all-gather ring, ``wo`` and ``w_down`` reduce-scatter rings, the
quantized experts' ``w_down`` the grouped ring over whole token tiles;
``stats`` carries the ring counters (``tp_ring_matmuls``,
``tp_ring_steps``, ``tp_bytes_permuted``, ``tp_fallbacks``). A dispatch is
committed only when the pipeline is full or drained (never on a readiness
poll, which could differ between ranks). At ``tensor_parallel`` > 1 the
programs run eagerly whatever the backend, every kernel as on a graph, and
``stats["graphs_off_reason"]`` says why: graphs of NCCL collectives are
not verified on several cards, and gloo's (ranks sharing one card, where
NCCL refuses two ranks on one device) cannot be captured. Speculative decoding, the KV movement
surface, the KV tier and the weight swap refuse tensor parallelism
(ROADMAP queue 1, item 6a).

Telemetry (``telemetry=True``, ``reqtrace=True``; ``telemetry/``), at the
JAX engine's sites with its metric, span and event names: ``admit``,
``dispatch`` (by plan kind, ``window``, ``spec_verify``) and
``drain_block`` spans, and the KV-movement spans; the serving histograms
(TTFT, time between tokens, queue wait, occupancy), the KV-page gauges and
the token counters; per-request lifecycle timelines with tenants
(``put(..., tenant=)``), exemplars and SLO-breach dumps. Every hook reads
host state only — no hook synchronizes with the card or reads a device
tensor: dispatch-side instruments run after the enqueue, commit-side ones
after the drain's copy. TTFT and the time between tokens are therefore
COMMIT times, as in the JAX engine: under ``max_inflight`` > 0 commits
trail the device by design, and a span around a graph replay times the
host's enqueue, not the kernels.

KV movement (the JAX engine's surface, with its contracts, stats keys and
refusals): page migration (``export_migration`` / ``export_commit`` /
``export_abort``, ``import_reserve`` / ``import_complete`` /
``import_abort``), radix pulls (``export_prefix`` / ``import_prefix``),
gang-prefill segments (``gang_prefill_segment``) and the HBM → host RAM →
NVMe tier (``kv_tier``; eviction demotes through ``_demote_evicted``,
admission promotes through ``tier_promote_begin`` / ``_finish``). Pages
travel as ``inference/migration.PageBundle`` bytes, the JAX package's wire
form. The pool is never rebound (the captured graphs hold its address):
exports and demotes gather whole pages in one ``index_select`` over a byte
view of the pool into pinned host memory, read after the copy's event;
imports, pulls and promotes write them back with one ``index_copy_``, from
a pinned buffer kept until its copy has run. Both are issued on the
engine's stream, behind the dispatches in flight.

Weight swap (``save_weights`` / ``swap_weights``): the parameter tree is
saved as one ``.npy`` per leaf under ``<tag>/state`` with ``meta.json``, the
size + crc32 ``manifest.json`` and an atomic ``latest`` — the port's own
format (the JAX engine's tag is orbax; neither package reads the other's).
A swap quiesces the pipeline, verifies the manifest, loads the tag into a
staged tree on the device, checks it matches the live tree leaf for leaf
and holds only finite values, and only then copies it into the live
tensors in place: the captured graphs replay the new weights with no
recapture, and any refusal leaves the old weights serving.

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

import json
import os
import time
from collections import deque
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from .. import comm
from ..accelerator import get_device, is_sm90
from ..models.transformer import (_ACTS, TransformerLM, add_shared_expert,
                                  alibi_slopes, apply_rope,
                                  check_served_family, dense_ffn,
                                  moe_layer_kwargs, norm, proj_heads,
                                  proj_out)
from ..moe.layer import (dropless_dispatch_combine, expert_ffn, moe_forward,
                         router_logits)
from ..moe.sharded_moe import topk_dropless_gating
from ..parallel.tensor import (_ring_rs_core, allgather_matmul,
                               matmul_reduce_scatter, overlap_counters)
from ..parallel.topology import MeshConfig, MeshTopology
from ..ops.paged_attention import (paged_ragged_attention,
                                   paged_ragged_attention_reference)
from ..ops.quant_matmul import (QuantGrouped, QuantLinear,
                                quant_grouped_matmul, quant_matmul,
                                quantize_grouped, quantize_weight, to_e4m3)
from ..utils.logging import logger
from .attn_registry import select_attention
from .programs import HostStaging, ProgramCache, pack, unpack
from .ragged import StateManager, StepPlan
from .sampling import sample_logits, sample_tree_logits
from .scheduler import SpecAcceptTracker, SplitFuseScheduler
from .weights import (cast_tree, copy_param_tree_, load_param_tree,
                      load_tp_params, module_param_tree, save_param_tree,
                      tree_nbytes, tree_tensors)

#: the pool dtype's name on the wire (``PageBundle.kv_dtype``): numpy's
#: names, as the JAX engine writes them
KV_DTYPE_NAMES = {torch.float32: "float32", torch.bfloat16: "bfloat16",
                  torch.float16: "float16",
                  torch.float8_e4m3fn: "float8_e4m3fn"}


class WeightSwapError(RuntimeError):
    """A live weight swap was refused or failed verification. ``reason`` is
    machine-readable (``integrity`` | ``shape_mismatch`` | ``probe_failed``
    | ``no_checkpoint``); raising never leaves the engine on partial
    weights."""

    def __init__(self, reason: str, detail: str = ""):
        super().__init__(f"weight swap refused: {reason}"
                         + (f" ({detail})" if detail else ""))
        self.reason = reason


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
    #: dispatches whose commits may lag behind (0 = commit within the
    #: step() that dispatched)
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


#: the ROADMAP item that holds what tensor-parallel serving left
TP_LATER = "ROADMAP queue 1, item 6a (what tensor-parallel serving left)"


def tp_refusal(what: str, tp: int) -> NotImplementedError:
    return NotImplementedError(f"{what} at tensor_parallel={tp} is not "
                               f"ported: {TP_LATER}")


def _check_config(cfg: RaggedInferenceConfig) -> None:
    """The config's value checks."""
    if cfg.kv_cache_dtype not in (None, "fp8"):
        raise ValueError(f"kv_cache_dtype must be None or 'fp8', got "
                         f"{cfg.kv_cache_dtype!r}")
    if cfg.quant_bits not in (None, 4, 8, "fp8"):
        raise ValueError(f"quant_bits must be 4, 8 or 'fp8', got "
                         f"{cfg.quant_bits!r}")


class InferenceEngineV2:
    #: programs also return their sampled rows' fp32 logits (``out[1]`` of
    #: an in-flight entry), for checks against a dense oracle; set before
    #: the first dispatch, since a captured program keeps its outputs
    _keep_logits = False
    #: token-tile size shared by the quantized-MoE sort alignment and the
    #: grouped quantized product K3 (the JAX engine's value: a serving step
    #: carries few tokens, so small tiles waste less padding)
    _MOE_GEMM_BLOCK_M = 32

    def __init__(self, model: TransformerLM, params: dict | None = None,
                 config: RaggedInferenceConfig | dict | None = None,
                 draft_model: TransformerLM | None = None,
                 draft_params: dict | None = None, topology=None):
        """``model`` supplies the configuration and, when ``params`` is
        None, the weights (served without a copy when its dtype and device
        match). ``params`` is a parameter tree with the flax tree's names
        (e.g. ``weights.params_from_jax``). Under ``quant_bits`` the
        engine's tree drops the dense weights it quantizes; the model keeps
        its own, so a caller that wants their memory back drops the model
        once the engine is up. ``draft_model`` / ``draft_params`` are the
        draft of ``spec_decode="draft"``, served by a second engine.

        ``topology`` (a ``parallel.topology.MeshTopology``; by default one
        of ``tensor=tensor_parallel`` when that exceeds 1) shards the
        forward over its ``tensor`` axis: every rank builds the engine with
        the same arguments. ``params`` is then the WHOLE tree, or None with
        ``model`` built on the meta device (``device="meta"``): each rank
        draws its slices of the seeded weights a block at a time."""
        if isinstance(config, dict):
            config = RaggedInferenceConfig(**config)
        self.config = cfg = config or RaggedInferenceConfig()
        self.mcfg = m = model.config
        check_served_family(m)
        _check_config(cfg)
        self.device = dev = get_device(cfg.device)
        self._init_tensor_parallel(topology)

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
        self._init_ring()
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
        kv_dtype = (torch.float8_e4m3fn if cfg.kv_cache_dtype == "fp8"
                    else cfg.dtype)
        self._kv_name = KV_DTYPE_NAMES[kv_dtype]
        # one page's bytes: its full cross-layer K/V slab [L, 2, KV, bs, D]
        self._page_bytes = (m.num_layers * 2 * self._KV * cfg.block_size
                            * m.head_dim
                            * torch.empty((), dtype=kv_dtype).element_size())

        # KV tiering: HBM → host RAM → NVMe (inference/kvtier.py)
        self._kv_tier = None
        if cfg.kv_tier:
            if self._prefix_cache is None:
                raise ValueError(
                    "kv_tier requires the shared-prefix cache: the tier "
                    "is an eviction sink under the radix trie (enable "
                    "prefix_cache, or serve pack-mode linear where auto "
                    "turns it on)")
            from .kvtier import (KVTier, KVTierConfig, auto_min_pages,
                                 measure_tier_rates)
            min_pages = cfg.kv_tier_min_pages
            if min_pages is None:
                # the promote threshold from MEASURED tier rates
                min_pages = auto_min_pages(
                    measure_tier_rates(nvme_dir=cfg.kv_tier_nvme_dir),
                    page_bytes=self._page_bytes, block_size=cfg.block_size,
                    nvme=cfg.kv_tier_nvme_dir is not None)
            self._kv_tier = KVTier(KVTierConfig(
                ram_bytes=cfg.kv_tier_ram_bytes,
                nvme_dir=cfg.kv_tier_nvme_dir,
                nvme_bytes=cfg.kv_tier_nvme_bytes,
                min_pages=min_pages))
            # eviction becomes demotion
            self._prefix_cache.evict_sink = self._demote_evicted

        # the weights' version: {"id": monotonic int, "digest": manifest
        # digest} ("init" = the constructor's weights); stamped on every
        # exported bundle, written only here and by swap_weights
        self._weight_version: dict = {"id": 0, "digest": "init"}

        if self._tp > 1:
            self.params, self._tp_plan = load_tp_params(
                model, params, self.topology, dtype=cfg.dtype, device=dev)
        else:
            self.params = (
                module_param_tree(model, dtype=cfg.dtype, device=dev)
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
        self.kv_pool = torch.zeros(
            (m.num_layers, 2, self._KV, cfg.num_blocks, cfg.block_size,
             m.head_dim), dtype=kv_dtype, device=dev)

        # one attention selection per mode; every decode and verify
        # dispatch counts against its mode's (attn_registry.py)
        sel_kw = dict(device_type=dev.type, num_heads=self._H,
                      kv_heads=self._KV, head_dim=m.head_dim,
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
        self._alibi_slopes = None
        if m.position_embedding == "alibi":         # this rank's heads
            r = self._tp_rank * self._H
            self._alibi_slopes = alibi_slopes(m.num_heads,
                                              device=dev)[r:r + self._H]

        self._gen = torch.Generator(device=dev)
        self._gen.manual_seed(17)
        self._results: dict[int, list[int]] = {}
        # device-resident last sampled token per slot: a plan whose previous
        # token is still in flight reads it here (use_last), so a dispatch
        # never waits for the previous one's readback
        self._last_tok = torch.zeros(cfg.max_seqs, dtype=torch.long,
                                     device=dev)
        # async pipeline: dispatched steps whose sampled tokens are still on
        # their way to the host; committed lazily (see _drain)
        self._inflight: deque = deque()
        # the card's captured programs and the pinned staging of plan
        # arrays; on the CPU every program runs eagerly
        cuda = dev.type == "cuda"
        self.graphs_off_reason = ""
        if cuda and self._tp > 1:
            self.graphs_off_reason = (
                f"tensor_parallel={self._tp}: CUDA graphs of the tensor "
                f"group's collectives are not verified (gloo's cannot be "
                f"captured at all), so every program runs eagerly")
            logger.warning(f"engine_v2: {self.graphs_off_reason}")
        self._programs = (ProgramCache(dev, self._gen)
                          if cuda and not self.graphs_off_reason else None)
        self._staging = (HostStaging(max(cfg.max_inflight, 1) + 2) if cuda
                         else None)
        # serving SLO instruments (telemetry/) — all no-ops when disabled
        from .. import telemetry as _telemetry
        if cfg.reqtrace and cfg.telemetry is False:
            raise ValueError(
                "reqtrace=True cannot combine with telemetry=False: "
                "request timelines ride the telemetry bundle (drop the "
                "telemetry=False pin or disable reqtrace)")
        if cfg.telemetry or cfg.reqtrace:
            rt_kw: dict[str, Any] = {}
            if cfg.reqtrace:
                # reqtrace implies the base substrate: timelines without
                # the registry/recorder would answer nothing
                rt_kw = {"reqtrace": True}
                if cfg.reqtrace_sample is not None:
                    rt_kw["reqtrace_sample"] = cfg.reqtrace_sample
                if cfg.slo_ttft_s is not None:
                    rt_kw["slo_ttft_s"] = cfg.slo_ttft_s
                if cfg.slo_tbt_s is not None:
                    rt_kw["slo_tbt_s"] = cfg.slo_tbt_s
            _telemetry.configure(enabled=True, **rt_kw)
        self._telem = _telemetry.get_telemetry() \
            if cfg.telemetry is not False \
            else _telemetry.Telemetry(enabled=False)
        self.scheduler._telem = self._telem   # cfg.telemetry=False pins both
        # per-request lifecycle tracing: cfg.reqtrace=False pins THIS
        # engine's emissions to a private disabled tracer even when the
        # process-wide one is on; the StateManager / scheduler / prefix
        # cache emit through the same handle, so one pin silences the
        # whole serving stack
        self._rt = self._telem.reqtrace if cfg.reqtrace is not False \
            else _telemetry.ReqTracer(enabled=False)
        self.scheduler._reqtrace = self._rt
        self.state.reqtrace = self._rt
        if self._prefix_cache is not None:
            self._prefix_cache.reqtrace = self._rt
        if self._rt.enabled:
            # breach dumps attach an engine/pool state snapshot; weakref
            # so the process-wide tracer never keeps a dead engine (and
            # its device pool) alive. Two engines in one process: last
            # one wins, like the shared registry.
            import weakref
            ref = weakref.ref(self)
            self._rt.state_probe = lambda: (
                lambda e: None if e is None
                else e._reqtrace_state_snapshot())(ref())
        self._admit_t: dict[int, float] = {}      # uid → put() time
        self._first_sched: set[int] = set()       # uids past their 1st chunk
        self._last_commit_t: dict[int, float] = {}
        if self._telem.enabled:
            self._telem.set_health(serving=True, max_seqs=cfg.max_seqs,
                                   num_blocks=cfg.num_blocks)
        # mixed-load alternation: True → the next dispatch prefers decode
        self._serve_toggle = False
        sel = self._attn_decode_sel.path
        self.stats = {"plan_s": 0.0, "dispatch_s": 0.0, "commit_s": 0.0,
                      "drain_block_s": 0.0, "window_dispatch_s": 0.0,
                      "dispatches": 0, "prefill_steps": 0,
                      "decode_steps": 0, "windows": 0, "window_iters": 0,
                      "window_iters_max": 0, "window_iters_dispatched": 0,
                      "forced_drains": 0, "d2h_latency_s": 0.0,
                      "opportunistic_drains": 0, "prefill_budget_tokens": 0,
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
                      f"attn_{self._attn_tree_sel.path}_tree": 0,
                      # KV tiering: pages demoted on eviction, chains
                      # promoted at admission, prompt tokens the tier saved
                      # from recompute, refused promotes
                      "kv_tier_demoted_pages": 0, "kv_tier_promotes": 0,
                      "kv_tier_promoted_tokens": 0,
                      "kv_tier_fallbacks": 0,
                      # KV-page migration through this engine's pool
                      "migrations_out": 0, "migrations_in": 0,
                      "migration_bytes_out": 0, "migration_bytes_in": 0,
                      # ring collective matmuls (parallel/tensor.py), as
                      # deltas of its process-wide counters
                      "tp_ring_matmuls": 0, "tp_ring_steps": 0,
                      "tp_bytes_permuted": 0, "tp_fallbacks": 0}
        if self.graphs_off_reason:
            self.stats["graphs_off_reason"] = self.graphs_off_reason
        self._tp_counter_base = overlap_counters.snapshot()
        # pinned host buffers of page imports, kept until the event behind
        # their copy has passed
        self._h2d_keep: deque = deque()
        # the first dispatch's readback, timed by events on the stream
        # (``d2h_latency_s`` once it commits)
        self._d2h_timing: tuple | None = None

        self._spec = None
        self._spec_tracker = None
        self._draft_engine = None
        # tokens committed outside step()'s own drains (a spec round, its
        # pipeline drain, a flush's drain of other uids), folded into the
        # next step()'s emitted dict
        self._spec_emit: dict[int, list[int]] = {}
        if cfg.spec_decode:
            self._init_speculative(draft_model, draft_params)
            if self._spec is not None:
                # draft-mirror rewinds show up on the TARGET request's
                # timeline (the mirror engine runs with telemetry off)
                self._spec.reqtrace = self._rt
        logger.info(
            f"engine_v2 up on {dev}: blocks={cfg.num_blocks}x"
            f"{cfg.block_size} pool="
            f"{self.kv_pool.numel() * self.kv_pool.element_size() / 1e6:.0f}"
            f"MB max_seqs={cfg.max_seqs} chunk={cfg.chunk} attention={sel}"
            + (f" ({self._attn_decode_sel.reason})"
               if self._attn_decode_sel.reason else "")
            + (f" ring={self._ring_tokens} tokens" if self._ring_tokens
               else "")
            + (f" spec={cfg.spec_decode}" if cfg.spec_decode else "")
            + (f" tp={self._tp} (rank {self._tp_rank}, ring "
               f"{self._tp_ring_n})" if self._tp > 1 else ""))

    def _init_tensor_parallel(self, topology) -> None:
        """The tensor axis: its size and this process's rank on it, the
        heads this rank serves, and the refusals of what the slice leaves
        out (heads that do not divide the axis, speculative decoding, the
        KV tier)."""
        cfg, m = self.config, self.mcfg
        tp = (topology.size("tensor") if topology is not None
              else cfg.tensor_parallel)
        if tp > 1:
            if m.num_heads % tp or m.kv_heads % tp:
                raise tp_refusal(
                    f"head counts ({m.num_heads}q/{m.kv_heads}kv) that do "
                    f"not divide the tensor axis ({tp})", tp)
            if cfg.spec_decode and cfg.tp_overlap is True:
                raise ValueError(
                    "spec_decode cannot combine with tp_overlap=True: the "
                    "verify forward samples all-position logits, which the "
                    "forced token-sharded ring stream does not carry (auto "
                    "mode is fine — verify programs fall back per-program)")
            for on, what in ((cfg.spec_decode, "spec_decode"),
                             (cfg.kv_tier, "kv_tier")):
                if on:
                    raise tp_refusal(what, tp)
        if topology is None and tp != 1:
            topology = MeshTopology(MeshConfig(tensor=tp, data=1))
        self.topology = topology
        self._tp = tp
        self._tp_rank = topology.rank_in("tensor") if tp > 1 else 0
        self._tp_plan: dict = {}
        if tp > 1:
            comm.set_topology(topology)
        #: the query and KV heads this rank serves
        self._H, self._KV = m.num_heads // tp, m.kv_heads // tp

    def _init_ring(self) -> None:
        """The JAX engine's static ring gate: ``tp_overlap`` None or True
        rings when the heads and the FFN width divide the axis (True
        requires it); programs whose rows do not divide fall back per
        program (:meth:`_ring_gate`). Packed prefill plans pad their rows
        to the ring degree."""
        cfg, m, tp = self.config, self.mcfg, self._tp
        ring_geom = (tp > 1 and m.num_heads % tp == 0
                     and m.kv_heads % tp == 0 and m.ffn_size % tp == 0)
        if cfg.tp_overlap and not ring_geom:
            raise ValueError(
                f"tp_overlap=True but the geometry can't ring: heads "
                f"{m.num_heads}, kv_heads {m.kv_heads}, ffn {m.ffn_size} "
                f"must all divide by the tensor axis size {tp}")
        self._tp_ring_n = tp if (ring_geom and cfg.tp_overlap is not False) \
            else 0
        self._tp_ring_force = cfg.tp_overlap is True
        if self._tp_ring_n:
            self.scheduler.row_multiple = self._tp_ring_n

    def _tp_kind(self, *path: str) -> str:
        """The TP kind (``col`` / ``row`` / ``rep``) of the weight at
        ``path``; ``rep`` without tensor parallelism."""
        got = self._tp_plan.get(tuple(path))
        return got[1] if got is not None else "rep"

    def _no_tp(self, what: str) -> None:
        if self._tp > 1:
            raise tp_refusal(what, self._tp)

    def _reduce(self, y: torch.Tensor) -> torch.Tensor:
        """The sum of a row-sharded product's partial outputs over the
        tensor ranks."""
        return comm.all_reduce(y, "tensor") if self._tp > 1 else y

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
                "max_inflight": 0,       # synchronous mirror stepping
                "prefix_cache": False,
                "telemetry": False,
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
        The tree drops each dense weight as it is replaced.

        Under tensor parallelism each weight is this rank's slice, and each
        slice is quantized alone: group boundaries fall inside shards, and
        codes and scales are bit for bit the shards of the JAX engine's
        ``shard_map(quantize_weight)`` / ``quantize_grouped``."""
        m, P = self.mcfg, self.params
        E = m.hidden_size

        shard = self._tp > 1

        def q2d(w, K):
            return quantize_weight(w.float().reshape(K, -1), bits=bits,
                                   shard=shard)

        before = tree_nbytes(P)
        for i in range(m.num_layers):
            layer = P[f"layer_{i}"]
            a = layer["attn"]
            for k in ("wq", "wk", "wv"):
                a[k] = q2d(a[k], E)                       # [E, (H|KV)*D]
            a["wo"] = q2d(a["wo"], a["wo"].shape[0] * a["wo"].shape[1])
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
                        ex[k] = quantize_grouped(ex[k].float(), bits=bits,
                                                 shard=shard)
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
        H, KV, D, L = self._H, self._KV, m.head_dim, m.num_layers
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

        rn = self._ring_gate(S, T, tree is not None)
        x = self._embed(token_ids, positions)                      # [S,T,E]
        if rn:
            # token-sharded residual stream: norms and residual adds run on
            # this rank's rows; the ring projections gather and scatter
            x = self._own_rows(x, rn)
        for li in range(L):
            p = P[f"layer_{li}"]
            a = p["attn"]
            h = norm(x, p["ln_attn"], m)
            if rn:
                q, k, v = self._ring_qkv(h, a, S, T)
            else:
                q = proj_heads(h, a["wq"], H)          # [S, T, H, D]
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
            if rn:
                o = self._ring_out(o, a["wo"], S, T)
            else:
                o = self._reduce(proj_out(o, a["wo"]))
            if m.attn_out_bias:
                o = o + a["bo"]
            if m.parallel_block:
                h_ffn = h if m.parallel_block_norms == 1 else \
                    norm(x, p["ln_ffn"], m)
                x = x + o + self._ffn(h_ffn, p, li, rn)
            else:
                x = x + o
                x = x + self._ffn(norm(x, p["ln_ffn"], m), p, li, rn)
        # norm is row-wise: taking each row's sampled token first is exact
        if sample_idx is None:
            last = x.reshape(S * T, -1)                            # [S*T, E]
        elif rn:
            c, r = S // rn, self._tp_rank
            last = comm.all_gather(
                x[torch.arange(c, device=x.device),
                  sample_idx[r * c:(r + 1) * c]], "tensor", axis=0)
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
        if self._vocab_cols:
            # this rank's vocabulary columns: gathered in rank order, so
            # every rank samples from the same logits
            logits = comm.all_gather(logits, "tensor", axis=-1)
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

    # ------------------------------------------------------------------
    # tensor-parallel pieces of the forward
    # ------------------------------------------------------------------
    @property
    def _vocab_cols(self) -> bool:
        """Whether the logits projection holds this rank's vocabulary
        columns (the vocabulary divides the tensor axis)."""
        if self._tp == 1:
            return False
        if self.mcfg.tie_embeddings:
            return self._tp_kind("embed") == "row"
        return self._tp_kind("unembed") == "col"

    def _embed(self, token_ids, positions):
        """The token (and learned position) embedding ``[S, T, E]``. A
        vocabulary-sharded table is looked up where a token is this rank's
        (zeros elsewhere) and summed over the tensor ranks."""
        m, P = self.mcfg, self.params
        emb = P["embed"]
        if self._tp > 1 and self._tp_kind("embed") == "row":
            Vl = emb.shape[0]
            loc = token_ids - self._tp_rank * Vl
            hit = (loc >= 0) & (loc < Vl)
            x = self._reduce(torch.where(hit[..., None],
                                         emb[loc.clamp(0, Vl - 1)], 0))
        else:
            x = emb[token_ids]
        if m.position_embedding == "learned":
            x = x + P["pos_embed"][positions]
        if "ln_embed" in P:                                        # bloom
            x = norm(x, P["ln_embed"], m)
        return x

    def _ring_gate(self, S: int, T: int, tree: bool) -> int:
        """The ring degree of one program (the JAX engine's per-program
        gate), 0 when it takes the blocking path: a verify forward, rows
        that do not divide the axis, or — in the auto mode — fewer than
        ``tp_overlap_min_rows`` token rows a chunk. A ring engine's
        blocking program counts a fallback."""
        rn = self._tp_ring_n
        if rn and (tree or S % rn or not (
                self._tp_ring_force
                or (S * T) // rn >= self.config.tp_overlap_min_rows)):
            overlap_counters.fallback()
            rn = 0
        return rn

    def _own_rows(self, x: torch.Tensor, rn: int) -> torch.Tensor:
        """This rank's chunk of the leading (sequence) dim."""
        c = x.shape[0] // rn
        return x[self._tp_rank * c:(self._tp_rank + 1) * c]

    def _ring_qkv(self, h, a, S: int, T: int):
        """Q, K and V of every row from this rank's rows ``h`` through ONE
        bidirectional all-gather ring feeding the three projections."""
        def w2(w):
            return w if isinstance(w, QuantLinear) else \
                w.reshape(w.shape[0], -1)

        q2, k2, v2 = allgather_matmul(h.reshape(-1, h.shape[-1]),
                                      (w2(a["wq"]), w2(a["wk"]),
                                       w2(a["wv"])))
        return (q2.reshape(S, T, self._H, -1), k2.reshape(S, T, self._KV, -1),
                v2.reshape(S, T, self._KV, -1))

    def _ring_out(self, o, wo, S: int, T: int):
        """The out-projection of every row's heads as a reduce-scatter ring
        into this rank's rows ``[S/n, T, E]``."""
        w = wo if isinstance(wo, QuantLinear) else wo.reshape(-1, wo.shape[-1])
        y = matmul_reduce_scatter(o.reshape(S * T, -1), w)
        return y.reshape(S // self._tp_ring_n, T, -1)

    def _ring_ffn(self, h, f):
        """The dense FFN of this rank's rows: gate and up share one
        all-gather ring, down is a reduce-scatter ring back into the
        token-sharded stream."""
        m = self.mcfg
        h2 = h.reshape(-1, h.shape[-1])
        if m.activation == "silu_glu":
            g2, u2 = allgather_matmul(h2, (f["w_gate"], f["w_up"]))
            z = F.silu(g2) * u2
        else:
            z = _ACTS[m.activation](allgather_matmul(h2, f["w_up"])
                                    + f["b_up"])
        out = matmul_reduce_scatter(z, f["w_down"]).reshape(h.shape)
        return out if m.activation == "silu_glu" else out + f["b_down"]

    def _ffn(self, h, p, li: int, rn: int = 0):
        """The FFN of layer ``li`` over ``h`` [S, T, E] (this rank's rows
        when ``rn``): the dense FFN, or the MoE layer. Generation drops no
        routed token: the capacity route runs with ``drop_tokens=False``
        (where the dense model's forward drops past
        ``eval_capacity_factor``), the dropless route when ``moe.dropless``
        is set, the quantized route for ``QuantGrouped`` experts; then
        qwen2-moe's shared expert. The gating losses are left out
        (``losses=False``): only training reads them.

        Under tensor parallelism row-sharded down products are summed over
        the ranks; in a ring program the dense FFN rings, and an MoE layer
        gathers the rows (routing needs every token, a counted fallback),
        runs as in a blocking program and keeps its rows."""
        m, layer = self.mcfg, f"layer_{li}"
        if "moe" not in p:
            f = p["ffn"]
            if rn and self._tp_kind(layer, "ffn", "w_up") == "col":
                return self._ring_ffn(h, f)
            if rn:
                overlap_counters.fallback()
            return dense_ffn(h, f, m, self._row_reduce(layer, "ffn"))
        ml = p["moe"]["moe_layer"]
        if rn:
            overlap_counters.fallback()
            h = comm.all_gather(h, "tensor", axis=0)
        red = self._row_reduce(layer, "moe", "moe_layer", "experts")
        if isinstance(ml["experts"]["w_up"], QuantGrouped):
            out = self._quant_moe(ml, h, red)
        else:
            # the gating losses serve training only: left out
            out, _ = moe_forward(h, ml, losses=False,
                                 **moe_layer_kwargs(m, drop_tokens=False))
            if red is not None:
                out = red(out)
        out = add_shared_expert(
            out, h, p["moe"], m,
            self._row_reduce(layer, "moe", "shared_expert"))
        return self._own_rows(out, rn) if rn else out

    def _row_reduce(self, *path: str):
        """:meth:`_reduce` when the ``w_down`` under ``path`` is
        row-sharded, else None."""
        return self._reduce if self._tp_kind(*path, "w_down") == "row" \
            else None

    def _quant_moe(self, ml, h, reduce=None):
        """Routed experts over ``QuantGrouped`` slabs: dropless routing and
        the quantized grouped product (K3) in tiles of
        ``_MOE_GEMM_BLOCK_M`` rows — the same routes every token takes
        through the no-drop capacity route, with the same gates. ``reduce``
        (row-sharded expert ``w_down``) sums the down product over the
        tensor ranks, or in a ring engine runs it as the grouped ring
        (:meth:`_qgmm_row`)."""
        m = self.mcfg
        mo = m.moe
        S, T, E = h.shape
        flat = h.reshape(S * T, E)
        gate = topk_dropless_gating(
            router_logits(flat, ml["gate"]["wg"])[None], mo.top_k,
            normalize_gates=mo.normalize_gates, losses=False)
        bm = self._MOE_GEMM_BLOCK_M
        down = ml["experts"]["w_down"]

        def gemm(buf, srt):
            def mm(z, w):
                if w is down and reduce is not None:
                    return self._qgmm_row(z, w, srt)
                return quant_grouped_matmul(z, w, srt.tile_expert,
                                            block_m=bm,
                                            tile_rows=srt.tile_rows)

            return expert_ffn(buf, ml["experts"], m.activation, mm)

        out = dropless_dispatch_combine(flat, gate.gates[0], gate.experts[0],
                                        mo.num_experts, mo.top_k, bm, gemm)
        return out.reshape(S, T, E)

    def _qgmm_row(self, z, w, srt):
        """A row-sharded quantized expert product summed over the tensor
        ranks (the JAX engine's ``_qgmm`` row kind): with the ring on and
        the sorted rows in whole tiles per rank, the grouped ring — each
        step one rank's chunk of whole token tiles with its slice of the
        tile→expert map (one direction: a half chunk need not hold whole
        tiles) — then an all-gather; otherwise the product and a sum."""
        bm, n = self._MOE_GEMM_BLOCK_M, self._tp
        te, tr = srt.tile_expert, srt.tile_rows
        Tp = z.shape[0]
        ring = bool(self._tp_ring_n) and Tp % (n * bm) == 0
        if self._tp_ring_n and not ring:
            overlap_counters.fallback()
        if not ring:
            return self._reduce(quant_grouped_matmul(
                z, w, te, block_m=bm, tile_rows=tr))

        def dot(rows, start):
            # the kernel takes 16-byte-aligned tables: slices are copied
            t0, nt = start // bm, rows.shape[0] // bm
            return quant_grouped_matmul(
                rows, w, te[t0:t0 + nt].clone(), block_m=bm,
                tile_rows=None if tr is None else tr[t0:t0 + nt].clone())

        overlap_counters.ring(steps=n - 1,
                              bytes_permuted=(n - 1) * Tp * w.shape[2] * 4)
        y_c = _ring_rs_core(z, dot, n, "tensor", z.dtype, bidir=False,
                            kernel="k3")
        return comm.all_gather(y_c, "tensor", axis=0)

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
    # programs: device functions of one packed int64 input, launched
    # eagerly or as a replay of their captured graph
    # ------------------------------------------------------------------
    def _upload(self, flat: np.ndarray) -> torch.Tensor:
        """A packed int64 array on the device; on the card it is copied
        from a pinned staging buffer, so the host does not wait."""
        if self._staging is None:
            return torch.from_numpy(flat).to(self.device)
        x = self._staging.stage(flat).to(self.device, non_blocking=True)
        self._staging.copied(torch.cuda.current_stream(self.device))
        return x

    def _launch(self, key: tuple, fn, arrays, graph: bool) -> tuple:
        """Run ``fn`` over ``arrays`` packed: as a replay of the program
        ``key`` when ``graph`` (captured on first use; a capture or replay
        failure raises), else eagerly. Returns fn's outputs on the
        device."""
        flat = pack(arrays)
        if not graph:
            return fn(self._upload(flat))
        prog = self._programs.get(key, fn, flat.size)
        prog.inputs.copy_(self._staging.stage(flat), non_blocking=True)
        self._staging.copied(torch.cuda.current_stream(self.device))
        return prog.replay()

    def _to_host(self, outs: tuple) -> tuple[tuple, Any]:
        """A dispatch's outputs on their way to pinned host buffers of their
        own, the copies enqueued right behind the dispatch (a graph's next
        replay rewrites its outputs), and the event recorded behind the
        copies. The engine's first readback is also timed by events: its
        copies' time on the stream becomes ``stats["d2h_latency_s"]`` when it
        commits. On the CPU the outputs are host tensors already (no
        event)."""
        if self._staging is None:
            return tuple(outs), None
        stream = torch.cuda.current_stream(self.device)
        first = self._d2h_timing is None
        if first:
            start = torch.cuda.Event(enable_timing=True)
            start.record(stream)
        host = []
        for t in outs:
            h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            h.copy_(t, non_blocking=True)
            host.append(h)
        ev = torch.cuda.Event(enable_timing=first)
        ev.record(stream)
        if first:
            self._d2h_timing = (start, ev)
        return tuple(host), ev

    def _program(self, plan: StepPlan) -> tuple:
        """Launch one scheduler plan (a prefill chunk step or a decode
        step): on the card a plan of shape ``[max_seqs, 1]`` replays the
        step program ``(1, max_seqs)``, any other runs eagerly. Returns its
        outputs on the device: the sampled token of each plan row (and the
        rows' fp32 logits under ``_keep_logits``)."""
        S, T = plan.token_ids.shape
        graph = (self._programs is not None and T == 1
                 and S == self.state.max_seqs)
        arrays = [plan.token_ids, plan.positions, plan.slot_map,
                  plan.block_tables, plan.seq_lens, plan.sample_idx,
                  plan.do_sample, plan.use_last, plan.row_slots]
        return self._launch((T, S), lambda x: self._step_body(S, T, x),
                            arrays, graph)

    def _step_body(self, S: int, T: int, x: torch.Tensor) -> tuple:
        """The step program over a packed ``[S, T]`` plan (the JAX engine's
        ``_program``): a row whose previous token is still in flight
        (``use_last``) reads it from ``_last_tok`` in column 0 (only 1-token
        decode rows can), and every sampled row writes its token back there,
        masked by ``do_sample``."""
        mb = self.state.max_blocks_per_seq
        (tok, pos, slot_map, tables, lens, sample_idx, do_sample, use_last,
         row_slots) = unpack(x, [(S, T)] * 3 + [(S, mb)] + [(S,)] * 5)
        row_last = self._last_tok[row_slots]
        tok = torch.cat([torch.where(use_last != 0, row_last,
                                     tok[:, 0])[:, None], tok[:, 1:]], dim=1)
        logits = self._ragged_forward(tok, pos, slot_map, tables.int(),
                                      lens.int(), sample_idx)
        toks = self._sample(logits)
        self._last_tok[row_slots] = torch.where(do_sample != 0, toks,
                                                row_last)
        return (toks, logits.float()) if self._keep_logits else (toks,)

    def _window_program(self, W: int, arrays) -> tuple:
        """Launch a decode window of W iterations over the arrays of
        :meth:`_window_plan`: on the card a replay of ``("win", W)``; eagerly
        on the CPU and under ``decode_early_exit``. Returns its outputs on
        the device: the tokens ``[W, S]`` (and their fp32 logits ``[W, S,
        V]`` under ``_keep_logits``)."""
        graph = self._programs is not None and \
            not self.config.decode_early_exit
        return self._launch(("win", W), lambda x: self._window_body(W, x),
                            arrays, graph)

    def _window_body(self, W: int, x: torch.Tensor) -> tuple:
        """Up to W chained decode iterations over a packed window input.
        Slots run independently: a slot goes inactive at its eos or when its
        budget ``rem`` is spent; inactive slots emit -1 and their staged rows
        merge into the trash block. The first token of a slot comes from
        ``_last_tok`` where ``use_last`` says it is still in flight. Fresh
        K/V of every iteration accumulates in a stage buffer whose base
        position is fixed at the window's start, and merges into the pool
        once, after the loop; ``_last_tok`` takes the last token of each of
        the window's participants only."""
        cfg, m = self.config, self.mcfg
        bs, dev = cfg.block_size, self.device
        L, KV, D = m.num_layers, self._KV, m.head_dim
        S, mb = self.state.max_seqs, self.state.max_blocks_per_seq
        tok_host, use_last, pos, lens, rem, eos, tables = unpack(
            x, [(S,)] * 6 + [(S, mb)])
        tok = torch.where(use_last != 0, self._last_tok, tok_host)
        lens, tables = lens.int(), tables.int()
        Ws = self._stage_rows(W)
        active0 = active = rem > 0
        base = pos.to(torch.int32)           # stage base, fixed per window
        kbuf = torch.zeros((L, S, KV, Ws, D), dtype=cfg.dtype, device=dev)
        vbuf = torch.zeros_like(kbuf)
        buf = torch.full((W, S), -1, dtype=torch.long, device=dev)
        slots = torch.zeros((W, S), dtype=torch.long, device=dev)
        zero = torch.zeros(S, dtype=torch.long, device=dev)
        kept = (torch.zeros((W, S, m.vocab_size), dtype=torch.float32,
                            device=dev) if self._keep_logits else None)
        for i in range(W):
            if cfg.decode_early_exit and not bool(active.any()):
                break
            blk = tables.gather(1, ((pos // bs) % mb)[:, None])[:, 0].long()
            slot = torch.where(active, blk * bs + pos % bs, zero)
            logits = self._ragged_forward(
                tok[:, None], pos[:, None], slot[:, None], tables, lens, zero,
                kv_stage=(kbuf, vbuf), stage_fill=i, stage_starts=base)
            nxt = self._sample(logits)
            if kept is not None:
                kept[i] = logits.float()
            buf[i] = torch.where(active, nxt, -1)
            slots[i] = slot
            # slots stop at their eos or when their budget is spent
            nxt_active = active & (nxt != eos) & (i + 1 < rem)
            tok = torch.where(active, nxt, tok)
            pos = torch.where(active, pos + 1, pos)
            lens = torch.where(active, lens + 1, lens)
            active = nxt_active
        # only the window's participants update the last token: a slot
        # outside it carries tok0 = 0
        self._last_tok.copy_(torch.where(active0, tok, self._last_tok))
        # merge the WHOLE window's staged KV into the pool: the one pool
        # write of this dispatch
        ks = kbuf[:, :, :, :W].permute(0, 3, 1, 2, 4).reshape(L, W * S, KV, D)
        vs = vbuf[:, :, :, :W].permute(0, 3, 1, 2, 4).reshape(L, W * S, KV, D)
        self._merge_stage(slots.reshape(-1), ks, vs)
        return (buf, kept) if kept is not None else (buf,)

    def warm_decode_windows(self, sizes: list[int] | None = None,
                            skip_existing: bool = True) -> None:
        """Capture and run the decode-window programs ahead of serving, for
        every pow2 window size the dispatcher can emit (full windows,
        budget-shrunk tails, the mixed-load cap): a capture inside a timed
        serve costs its eager warm-up and the capture. Harmless by
        construction: ``rem`` = 0 keeps every slot inactive, the staged KV
        lands in the trash block, and the masked last-token update leaves
        ``_last_tok`` as it was. ``sizes`` defaults to every pow2 in [2,
        decode_window]; ``skip_existing`` skips sizes already captured.
        Eager windows (the CPU, ``decode_early_exit``) just run."""
        if sizes is None:
            W = self.config.decode_window
            W = 1 << (W.bit_length() - 1) if W > 1 else 0
            sizes = []
            while W > 1:
                sizes.append(W)
                W //= 2
        S, mb = self.state.max_seqs, self.state.max_blocks_per_seq
        z = np.zeros(S, np.int64)
        for W in sizes:
            if W <= 1 or (skip_existing and self._programs is not None
                          and ("win", W) in self._programs):
                continue
            self._window_program(W, [z, z, z, z, z, np.full(S, -1),
                                     np.zeros((S, mb), np.int64)])
        if self._programs is not None:
            torch.cuda.synchronize(self.device)

    def warm_decode_step(self) -> None:
        """Capture and run the decode step program ``(1, max_seqs)`` ahead
        of serving: a serve whose budget leaves a last single iteration
        (63 = 7 x 8 + 4 + 2 + 1) dispatches it as a step plan. Harmless by
        construction, like :meth:`warm_decode_windows`: every row is
        padding (the scheduler's own padding: position 0, no keys, writing
        the trash block) and samples nothing, so ``_last_tok`` keeps its
        values. Runs eagerly on the CPU."""
        S, mb = self.state.max_seqs, self.state.max_blocks_per_seq
        z = np.zeros((S, 1), np.int64)
        arrays = [z, z, z, np.zeros((S, mb), np.int64)] + \
            [np.zeros(S, np.int64)] * 4 + [np.arange(S)]
        self._launch((1, S), lambda x: self._step_body(S, 1, x), arrays,
                     self._programs is not None)
        if self._programs is not None:
            torch.cuda.synchronize(self.device)

    def _window_plan(self, prefill_pending: bool = False):
        """The next decode window over the decode-ready slots (others ride
        along inactive): ``(W, arrays, live sequences, {uid: (slot, n
        scheduled)})``, or None. While prefill chunks are pending the window
        is capped at ``decode_window_mixed_cap`` so a waiting chunk is never
        stuck behind a full window. A slot with tokens in flight reads its
        first token on the device (``use_last``)."""
        cfg = self.config
        W_max = cfg.decode_window
        if prefill_pending and cfg.decode_window_mixed_cap:
            W_max = min(W_max, cfg.decode_window_mixed_cap)
        if W_max <= 1:
            return None
        live = [s for s in self.state.seqs.values()
                if not s.sched_done and s.slot >= 0 and s.pending_sched == 1]
        if not live:
            return None
        W = min(max(s.gen_remaining_sched for s in live), W_max)
        if W <= 1:
            return None
        W = 1 << (W.bit_length() - 1)        # pow2, like the JAX engine

        S, mb = self.state.max_seqs, self.state.max_blocks_per_seq
        tok0 = np.zeros((S,), np.int64)
        use_last = np.zeros((S,), np.int64)
        pos0 = np.zeros((S,), np.int64)
        lens0 = np.zeros((S,), np.int64)
        rem = np.zeros((S,), np.int64)
        eos = np.full((S,), -1, np.int64)
        tables = np.zeros((S, mb), np.int64)
        sched: dict[int, tuple[int, int]] = {}   # uid -> (slot, n scheduled)
        for s in live:
            sl = s.slot
            if s.n_inflight:
                use_last[sl] = 1                 # value only on device
            else:
                tok0[sl] = s.tokens[-1]
            pos0[sl] = s.len_sched - 1
            lens0[sl] = s.len_sched
            tables[sl, :len(s.blocks)] = s.blocks
            n = min(s.gen_remaining_sched, W)
            rem[sl] = n
            if s.eos_id is not None:
                eos[sl] = s.eos_id
            sched[s.uid] = (sl, n)
        return W, [tok0, use_last, pos0, lens0, rem, eos, tables], live, sched

    def _try_dispatch_window(self, prefill_pending: bool = False) -> bool:
        """Decode fast path: up to ``decode_window`` decode iterations in
        one dispatch (:meth:`_window_plan`), without waiting for any
        readback."""
        t0 = time.perf_counter()
        planned = self._window_plan(prefill_pending)
        if planned is None:
            return False
        W, arrays, live, sched = planned
        t1 = time.perf_counter()
        self.stats["plan_s"] += t1 - t0
        self._emit_attn_kernel("decode")
        with self._telem.span("dispatch", kind="window", W=W):
            out, event = self._to_host(self._window_program(W, arrays))
        # dispatch-time advance: KV up to len_sched - 1 + n - 1 is now
        # scheduled, n new samples are in flight
        for s in live:
            _, n = sched[s.uid]
            s.n_sched = s.len_sched - 1 + n
            s.n_inflight += n
        t2 = time.perf_counter()
        self._inflight.append({"kind": "window", "sched": sched, "out": out,
                               "event": event, "t": t2})
        self.stats["dispatch_s"] += t2 - t1
        self.stats["window_dispatch_s"] += t2 - t0
        self.stats["dispatches"] += 1
        self.stats["windows"] += 1
        self.stats["window_iters_dispatched"] += W
        if self._rt.enabled:
            for s in live:
                self._rt.event(s.uid, "decode_window", W=W,
                               tokens=sched[s.uid][1])
        if self._telem.enabled:
            # window occupancy is row-based: live decoders / max slots
            self._record_dispatch_telemetry("decode_window", len(live),
                                            self.state.max_seqs, ())
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
        tok, pos, tables, lens, mask = unpack(
            self._upload(pack([tok, pos, tables, lens, mask])),
            [(S, T), (S, T), tables.shape, (S,), (S, T, T)])
        k_all = torch.zeros((m.num_layers, S, self._KV, self._stage_rows(T),
                             m.head_dim), dtype=cfg.dtype, device=dev)
        v_all = torch.zeros_like(k_all)
        logits = self._ragged_forward(
            tok, pos, None, tables.int(), lens.int(), None,
            kv_stage=(k_all, v_all), tree_mask=mask.to(torch.uint8))
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
        from committed state: a pipeline holding dispatches is drained
        first, but only when the proposer's ``probe`` says candidates
        plausibly exist (a lookup miss stays a pipelined decode). No
        provisional marker outlives the call."""
        cfg = self.config
        if not any(not s.sched_done and s.slot >= 0 and s.pending_sched == 1
                   for s in self.state.seqs.values()):
            return False
        if self._inflight:
            # probe the committed token view before the blocking drain,
            # over the sequences a round could use, with the request loop's
            # depth caps; advisory only (a false positive costs one drain)
            probe: dict[int, tuple[list[int], int]] = {}
            for s in self.state.seqs.values():
                if s.sched_done or s.slot < 0 or s.pending_sched != 1:
                    continue
                d = self._spec_tracker.depth(
                    s.uid, prefill_pending=prefill_pending,
                    mixed_cap=cfg.spec_depth_mixed_cap)
                d = min(d, s.gen_remaining_sched - 1)
                if d >= 1:
                    probe[s.uid] = (s.tokens, d)
            if not probe or not self._spec.probe(probe):
                return False
            for uid, new in self._drain(drain_all=True).items():
                self._spec_emit.setdefault(uid, []).extend(new)
        live = [s for s in self.state.seqs.values()
                if not s.done and not s.frozen and s.slot >= 0
                and s.pending_tokens == 1
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
        L, KV, D = self.mcfg.num_layers, self._KV, self.mcfg.head_dim
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
            with self._telem.span("dispatch", kind="spec_verify", T=T):
                k_all, v_all, toks = self._spec_program(tok, pos, tables,
                                                        lens, mask)
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
            self._merge_stage(self._upload(flat), ks, vs)
        except Exception:
            # a failed round leaves no provisional marker behind
            for uid in meta:
                self.state.rollback_provisional(uid)
            raise

        st = self.stats
        emitted: dict[int, list[int]] = {}
        for uid, accepted in accepts.items():
            tree = meta[uid][1]
            out = self.state.commit_speculative(uid, accepted)
            n_acc = len(accepted) - 1        # matched candidates
            if self._rt.enabled:
                self._rt.event(uid, "spec_round",
                               proposed=tree.n_candidates, accepted=n_acc,
                               committed=len(out))
            st["spec_verifies"] += 1
            st["spec_proposed"] += tree.n_candidates
            st["spec_accepted"] += n_acc
            st["spec_steps_saved"] += max(len(out) - 1, 0)
            st["decode_tokens"] += len(out)
            if out:
                self._results[uid].extend(out)
                self._spec_emit.setdefault(uid, []).extend(out)
                emitted[uid] = out
            if cfg.spec_adapt and tree.n_candidates:
                ev = self._spec_tracker.observe(uid, tree.n_candidates,
                                                n_acc)
                if ev is not None:
                    # draft-depth adaptation is a postmortem-grade event:
                    # the flight recorder notes it even when metrics are
                    # off (note() is cheap and only read on dumps)
                    self._telem.note(
                        "spec_depth_adapt", uid=uid, old=ev[0], new=ev[1],
                        rate=round(self._spec_tracker.rate(uid), 4))
                    if self._rt.enabled:
                        self._rt.event(uid, "spec_depth_adapt",
                                       old=ev[0], new=ev[1])
        st["spec_rounds"] += 1
        st["spec_accept_rate"] = round(
            st["spec_accepted"] / max(st["spec_proposed"], 1), 4)
        st["dispatches"] += 1
        st["decode_steps"] += 1
        st["dispatch_s"] += time.perf_counter() - t0
        if self._telem.enabled:
            reg = self._telem.registry
            reg.counter("serving_spec_proposed_total",
                        help="candidate tree tokens proposed for "
                             "verification").inc(
                sum(meta[u][1].n_candidates for u in meta))
            reg.counter("serving_spec_accepted_total",
                        help="proposed candidates accepted by the exact "
                             "verify walk").inc(
                sum(len(a) - 1 for a in accepts.values()))
            for accepted in accepts.values():
                reg.histogram(
                    "serving_spec_tokens_per_verify",
                    buckets=tuple(float(b) for b in range(1, T + 2)),
                    help="tokens committed per sequence per verify "
                         "forward (1 = no candidate survived)"
                ).observe(float(len(accepted)))
            self._record_dispatch_telemetry("spec_verify", len(live),
                                            self.state.max_seqs, ())
            if emitted:
                self._record_commit_telemetry(emitted)
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
        with self._telem.span("dispatch", kind=plan.kind):
            out, event = self._to_host(self._program(plan))
        self.scheduler.mark_dispatched(plan)
        self._inflight.append({"kind": "plan", "plan": plan, "out": out,
                               "event": event, "t": time.perf_counter()})
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
        if self._telem.enabled:
            self._record_dispatch_telemetry(
                plan.kind, n_tok, int(np.prod(plan.token_ids.shape)),
                plan.uids)
        return True

    def _entry_ready(self, entry: dict) -> bool:
        """Whether a dispatch's outputs are on the host: its event, recorded
        behind the device-to-host copy, covers the compute and the copy
        together. CPU dispatches are ready as they return. Under tensor
        parallelism a card dispatch is never polled ready: a poll may
        answer differently on two ranks, whose host state must not part, so
        dispatches commit when the pipeline is full or drained."""
        if entry["event"] is None:
            return True
        return self._tp == 1 and entry["event"].query()

    def _drain(self, force: bool = False, drain_all: bool = False) -> dict:
        """Commit in-flight dispatches, oldest first. Without ``force`` or
        ``drain_all`` only ready entries commit, and the oldest one also
        when the pipeline holds ``max(max_inflight, 1)`` entries (waiting
        for it: a forced drain); ``force`` takes at least the oldest;
        ``drain_all`` empties the pipeline. Returns {uid: accepted tokens}
        across the drained entries."""
        emitted: dict[int, list[int]] = {}
        st = self.stats
        while self._h2d_keep and self._h2d_keep[0][0].query():
            self._h2d_keep.popleft()
        while self._inflight:
            entry = self._inflight[0]
            # >=: the pipeline holds AT MOST max_inflight awaiting entries
            over = len(self._inflight) >= max(self.config.max_inflight, 1)
            ready = self._entry_ready(entry)
            if not (ready or force or drain_all or over):
                break
            if ready:
                st["opportunistic_drains"] += 1
            else:
                st["forced_drains"] += 1
                t0 = time.perf_counter()
                with self._telem.span("drain_block", kind=entry["kind"]):
                    if entry["event"] is not None:
                        entry["event"].synchronize()
                st["drain_block_s"] += time.perf_counter() - t0
            self._inflight.popleft()
            force = False
            if self._d2h_timing and entry["event"] is self._d2h_timing[1]:
                start, end = self._d2h_timing
                st["d2h_latency_s"] = start.elapsed_time(end) / 1e3
                self._d2h_timing = ()
            t0 = time.perf_counter()
            self._commit_entry(entry, entry["out"][0].numpy(), emitted)
            st["commit_s"] += time.perf_counter() - t0
        if emitted and self._telem.enabled:
            self._record_commit_telemetry(emitted)
        return emitted

    def _commit_entry(self, entry: dict, toks_h: np.ndarray,
                      emitted: dict) -> None:
        if entry["kind"] == "window":
            # iterations that emitted anything, from the host copy
            self.stats["window_iters"] += int((toks_h >= 0).any(axis=1).sum())
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
                    if self._rt.enabled:
                        self._rt.event(uid, "commit", tokens=len(new),
                                       window=True)
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
        if self._telem.enabled:
            self._telem.registry.counter(
                "serving_attn_kernel_total",
                labels={"path": sel.path, "mode": mode},
                help="decode/tree-verify dispatches by the attention "
                     "formulation the registry selected (the kernel vs "
                     "the plain gather)").inc()

    def _record_dispatch_telemetry(self, kind: str, useful: int,
                                   budget: int, uids) -> None:
        """Dispatch-side SLO instruments: queue wait (admission → first
        scheduled prefill chunk), per-step occupancy (useful/budget — the
        honest prefill-MFU accounting as a live histogram), KV-page
        utilization. Runs after the enqueue, on host state only. Caller
        gates on ``self._telem.enabled``."""
        from ..telemetry import RATIO_BUCKETS

        now = time.perf_counter()
        reg = self._telem.registry
        rt = self._rt
        for uid in uids:
            if uid >= 0 and uid not in self._first_sched:
                self._first_sched.add(uid)
                t_admit = self._admit_t.get(uid)
                if t_admit is not None:
                    reg.histogram(
                        "serving_queue_wait_s",
                        help="admission (put) → first scheduled prefill "
                             "chunk").observe(now - t_admit,
                                              exemplar=rt.exemplar(uid))
                    if rt.enabled:
                        rt.observe_queue_wait(uid, now - t_admit)
        if budget > 0:
            reg.histogram(
                f"serving_{kind}_occupancy", buckets=RATIO_BUCKETS,
                help="useful fraction of the step's paid token/row budget"
            ).observe(useful / budget)
        if kind in ("prefill", "decode"):
            # the prefill-vs-decode token split (window tokens land on the
            # commit side as serving_tokens_total)
            reg.counter(f"serving_{kind}_tokens_total",
                        help="useful tokens dispatched in pure "
                             f"{kind} plans").inc(useful)
        alloc = self.state.allocator
        cap = max(alloc.num_blocks - 1, 1)      # block 0 is the trash slot
        reg.gauge("serving_kv_page_utilization",
                  help="allocated fraction of the paged KV pool").set(
            1.0 - alloc.free_blocks / cap)
        if self._prefix_cache is not None:
            # ownership split behind the utilization number: cached pages
            # (trie LRU, reclaimable) vs referenced (shared with live
            # sequences) vs plainly owned tails vs free
            pc = self._prefix_cache
            cached, referenced = pc.cached_blocks, pc.referenced_blocks
            for kind, val in (("free", alloc.free_blocks),
                              ("prefix_cached", cached - referenced),
                              ("prefix_referenced", referenced),
                              ("seq_owned",
                               cap - alloc.free_blocks - cached)):
                reg.gauge("serving_kv_pages", labels={"kind": kind},
                          help="paged-pool block ownership split"
                          ).set(val)

    def _record_commit_telemetry(self, emitted: dict) -> None:
        """Commit-side SLOs: TTFT (admission → first committed token) and
        observed per-token time-between-tokens — a window committing n
        tokens dt after the previous commit contributes n samples of dt/n.
        Runs after the drain's copy, on host tokens only: these are COMMIT
        times, which trail the device by up to ``max_inflight``
        dispatches."""
        now = time.perf_counter()
        reg = self._telem.registry
        rt = self._rt
        total = 0
        for uid, toks in emitted.items():
            n = len(toks)
            if not n:
                continue
            total += n
            last = self._last_commit_t.get(uid)
            if last is None:
                t_admit = self._admit_t.get(uid)
                if t_admit is not None:
                    reg.histogram(
                        "serving_ttft_s",
                        help="admission (put) → first committed token"
                    ).observe(now - t_admit, exemplar=rt.exemplar(uid))
                    if rt.enabled:
                        # per-tenant TTFT + the SLO-breach auto-capture
                        # threshold check live behind this call
                        rt.observe_ttft(uid, now - t_admit)
            else:
                reg.histogram(
                    "serving_tbt_s",
                    help="observed per-token time between committed tokens"
                ).observe((now - last) / n, n=n, exemplar=rt.exemplar(uid))
                if rt.enabled:
                    rt.observe_tbt(uid, (now - last) / n, n)
            self._last_commit_t[uid] = now
        if total:
            reg.counter("serving_tokens_total",
                        help="committed (accepted) generated tokens"
                        ).inc(total)

    def _reqtrace_state_snapshot(self) -> dict:
        """Engine/pool state attached to SLO-breach flight dumps: the
        scheduler backlog, pool occupancy, pipeline depth, and a
        per-sequence summary — "what else was the engine juggling when
        this request blew its SLO"."""
        alloc = self.state.allocator
        has_prefill, has_decode = self.scheduler.pending_kinds()
        out = {
            "queue_depth": self.scheduler.queue_depth(),
            "pending_prefill": has_prefill,
            "pending_decode": has_decode,
            "inflight_steps": len(self._inflight),
            "free_blocks": alloc.free_blocks,
            "num_blocks": alloc.num_blocks,
            "seqs": {
                uid: {"slot": s.slot, "len": len(s.tokens),
                      "n_computed": s.n_computed,
                      "pending_sched": s.pending_sched,
                      "blocks": len(s.blocks),
                      "shared_blocks": s.n_shared_blocks,
                      "done": s.done}
                for uid, s in self.state.seqs.items()},
        }
        if self._prefix_cache is not None:
            out["prefix_cache"] = self._prefix_cache.stats()
        return out

    # ------------------------------------------------------------------
    # public API (reference engine_v2.py put/query/flush)
    # ------------------------------------------------------------------
    def can_schedule(self, prompt_len: int, max_new_tokens: int = 32) -> bool:
        """Admission check against the worst-case block budget (blocks are
        reserved at admit)."""
        return self.state.can_admit(prompt_len, max_new_tokens)

    def put(self, uid: int, prompt_tokens, max_new_tokens: int = 32,
            eos_token_id: int | None = None, tenant: str | None = None,
            trace_id: str | None = None) -> None:
        """Admit a request. Raises if the pool or slot budget is exhausted —
        callers gate on ``can_schedule``. ``eos_token_id`` stops the
        sequence early (truncated at the eos). ``tenant`` attributes the
        request's tokens / KV residency / SLO observations to a
        bounded-cardinality tenant label (reqtrace; ignored when tracing is
        off). ``trace_id`` adopts an externally minted trace ID for the
        request's timeline (a serving replica passes the router's) instead
        of minting a process-local one. With ``kv_tier``, a chain the tier
        holds deeper than the HBM trie is promoted first, so the admit hits
        it."""
        toks = [int(t) for t in prompt_tokens]
        if not toks:
            raise ValueError("empty prompt")
        if len(toks) + max_new_tokens > self.config.max_seq_len:
            raise ValueError("prompt + max_new_tokens exceeds max_seq_len")
        if self._kv_tier is not None:
            self._tier_promote(toks)
        if not self.state.can_admit(len(toks), max_new_tokens):
            raise RuntimeError("cannot schedule: pool/slots exhausted")
        if self._rt.enabled:
            # trace opens BEFORE admit so the admit event (prefix-hit
            # extent, pages pinned — emitted inside StateManager.admit)
            # lands on an existing timeline
            self._rt.begin(uid, tenant=tenant, prompt=len(toks),
                           trace_id=trace_id)
        try:
            with self._telem.span("admit", prompt=len(toks)):
                seq = self.state.admit(uid, toks, max_new_tokens,
                                       eos_id=eos_token_id)
        except Exception:
            self._rt.drop(uid)     # the request never existed
            raise
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
        if self._telem.enabled:
            self._admit_t[uid] = time.perf_counter()
            self._telem.registry.counter(
                "serving_requests_total",
                help="requests admitted (put)").inc()
            if self._prefix_cache is not None:
                self._telem.registry.counter(
                    "serving_prefix_hit_tokens_total",
                    help="prompt tokens served from the shared-prefix KV "
                         "cache").inc(seq.prefix_hit_tokens)
                self._telem.registry.counter(
                    "serving_prefix_lookup_tokens_total",
                    help="prompt tokens looked up against the shared-"
                         "prefix KV cache").inc(len(toks))

    def query(self, uid: int) -> dict:
        """Request status."""
        seq = self.state.seqs.get(uid)
        if seq is None:
            return {"live": False, "generated": self._results.get(uid, [])}
        return {"live": True, "done": seq.done,
                "generated": list(self._results[uid]),
                "n_computed": seq.n_computed, "inflight": seq.n_inflight}

    def _uid_inflight(self, uid: int) -> bool:
        for entry in self._inflight:
            uids = entry["sched"] if entry["kind"] == "window" \
                else entry["plan"].uids
            if uid in uids:
                return True
        return False

    def flush(self, uid: int) -> list[int]:
        """Release a request's KV and slot, returning its generated tokens
        (its full pages are published into the prefix cache). Drains the
        pipeline only up to the last in-flight dispatch naming ``uid`` (a
        dispatch still running could otherwise write into blocks about to
        be reused); dispatches of other uids keep riding, and the tokens of
        other uids that the drain commits surface in the next step()."""
        while self._inflight and self._uid_inflight(uid):
            for u, new in self._drain(force=True).items():
                if u != uid:
                    self._spec_emit.setdefault(u, []).extend(new)
        self._spec_emit.pop(uid, None)
        seq = self.state.seqs.get(uid)
        if seq is not None and seq.migrating == "out":
            # flushing a pinned export is its abort: unfreeze, then release
            self.state.export_abort(uid)
        elif seq is not None and seq.migrating == "in":
            # a half-imported sequence has no committed content
            self.state.abort_import(uid)
        if self._spec is not None:
            # rounds complete inside a step, but a failed one may be caught
            # by a driver that then flushes: no marker survives the release
            self.state.rollback_provisional(uid)
            self._spec.release(uid)
            self._spec_tracker.forget(uid)
        if uid in self.state.seqs:
            self.state.release(uid)
        self._admit_t.pop(uid, None)
        self._first_sched.discard(uid)
        self._last_commit_t.pop(uid, None)
        # release normally finalized the timeline (StateManager.release
        # emits it); this is the safety net for uids that never admitted
        self._rt.forget(uid)
        return self._results.pop(uid, [])

    def _refresh_tp_stats(self) -> None:
        """Add the ring counters' growth since the last refresh
        (``parallel/tensor.overlap_counters``, process-wide) to ``stats``;
        a snapshot below the base (someone reset the counters) counts from
        zero. Two ring engines in one process share the counters."""
        snap = overlap_counters.snapshot()
        for k, v in snap.items():
            base = self._tp_counter_base.get(k, 0)
            self.stats[k] += v - (base if v >= base else 0)
        self._tp_counter_base = snap

    def step(self) -> dict[int, list[int]]:
        """Commit the earlier dispatches whose tokens have arrived, then
        dispatch the next scheduled step WITHOUT waiting for it (the JAX
        engine's order). Returns {uid: accepted tokens} committed in this
        call, possibly from dispatches several calls back: the pipeline runs
        up to ``max_inflight`` dispatches ahead, decode chaining through the
        device-resident last token. With ``max_inflight=0`` the step
        dispatched in this call commits before it returns. An empty dict
        means nothing committed; the engine is idle when nothing is in
        flight either."""
        emitted = self._drain()
        dispatched = self._dispatch_next()
        if self._tp_ring_n:
            self._refresh_tp_stats()
        if dispatched and self.config.max_inflight <= 0:
            for uid, new in self._drain(drain_all=True).items():
                emitted.setdefault(uid, []).extend(new)
        elif not dispatched and self._inflight:
            # nothing left to dispatch (all budget in flight): make progress
            # by waiting for the oldest
            for uid, new in self._drain(force=True).items():
                emitted.setdefault(uid, []).extend(new)
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


    # ------------------------------------------------------------------
    # introspection for a serving replica's heartbeat
    # ------------------------------------------------------------------
    def prefix_cache_stats(self) -> dict | None:
        """Lifetime shared-prefix cache counters (None when the cache is
        off); the per-run view is ``stats["prefix_hit_tokens"]``."""
        return None if self._prefix_cache is None \
            else self._prefix_cache.stats()

    def residency_digest(self, max_entries: int = 4096) -> list[int] | None:
        """Chain hashes of every current-version page the prefix cache
        holds (``prefix_cache.chain_hashes`` scheme); None without a
        cache."""
        return None if self._prefix_cache is None \
            else self._prefix_cache.residency_digest(max_entries)

    def prefix_cache_version(self) -> int:
        """Digest version: moves on every trie insert and evict."""
        return 0 if self._prefix_cache is None \
            else self._prefix_cache.version

    def load_summary(self) -> dict:
        """Scheduler backlog + pool headroom (a router's placement and
        shed signal)."""
        out = self.scheduler.load_summary()
        out["free_blocks"] = self.state.allocator.free_blocks
        out["max_seqs"] = self.config.max_seqs
        out["inflight"] = len(self._inflight)
        return out

    def drain(self, deadline_s: float | None = None) -> bool:
        """Step until every admitted sequence is done and the pipeline is
        empty (callers stop admitting first). Frozen (mid-migration)
        sequences are left to their migration. Returns False if
        ``deadline_s`` elapses with work pending; the engine stays usable."""
        t0 = time.perf_counter()
        while any(not s.done and not s.frozen
                  for s in self.state.seqs.values()) or self._inflight:
            if deadline_s is not None \
                    and time.perf_counter() - t0 > deadline_s:
                return False
            self.step()
        return True

    # ------------------------------------------------------------------
    # page movement: whole pool pages to and from host bytes
    # ------------------------------------------------------------------
    def _pool_bytes(self) -> torch.Tensor:
        """The pool as bytes, ``[L, 2, KV, num_blocks, block_size, D x
        itemsize]`` uint8 (a view: writes land in the pool)."""
        return self.kv_pool.view(torch.uint8)

    def _block_index(self, blocks) -> torch.Tensor:
        return torch.as_tensor(np.asarray(blocks, np.int64),
                               device=self.device)

    def _host_bytes(self, t: torch.Tensor) -> np.ndarray:
        """``t``'s bytes on the host, read after the event behind their copy
        into pinned memory (the copy is issued on the engine's stream,
        behind the dispatches in flight)."""
        if self.device.type != "cuda":
            return t.contiguous().numpy()
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        h.copy_(t, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(self.device))
        ev.synchronize()
        return h.numpy()

    def _gather_pages(self, blocks) -> list[bytes]:
        """The bytes of whole pool pages, each ``[L, 2, KV, block_size, D]``
        in C order (the JAX engine's page layout): one ``index_select`` and
        one device-to-host copy for all of them."""
        if not blocks:
            return []
        pages = self._pool_bytes().permute(3, 0, 1, 2, 4, 5).index_select(
            0, self._block_index(blocks))
        flat = self._host_bytes(pages).reshape(len(blocks), -1)
        return [flat[j].tobytes() for j in range(len(blocks))]

    def _scatter_pages(self, blocks, pages) -> None:
        """Write whole pages (bytes as :meth:`_gather_pages` gives them)
        into pool ``blocks``: one host-to-device copy from a pinned buffer
        and one ``index_copy_`` into the pool, in place."""
        if not blocks:
            return
        pool = self._pool_bytes()
        shape = (len(blocks), *pool.shape[:3], *pool.shape[4:])
        cuda = self.device.type == "cuda"
        buf = torch.empty(shape, dtype=torch.uint8, pin_memory=cuda)
        flat = buf.numpy().reshape(len(blocks), -1)
        for j, blob in enumerate(pages):
            flat[j] = np.frombuffer(blob, np.uint8)
        src = buf.to(self.device, non_blocking=True)
        pool.index_copy_(3, self._block_index(blocks),
                         src.permute(1, 2, 3, 0, 4, 5))
        if cuda:
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(self.device))
            self._h2d_keep.append((ev, buf))

    def _tail_page(self, tail: bytes, rows: int) -> bytes:
        """A whole page holding a bundle's partial tail extent in its first
        ``rows`` rows, zeros past them (as the JAX engine writes it)."""
        pool = self._pool_bytes()
        L, two, KV, _, bs, Db = pool.shape
        page = np.zeros((L, two, KV, bs, Db), np.uint8)
        page[:, :, :, :rows] = np.frombuffer(tail, np.uint8).reshape(
            L, two, KV, rows, Db)
        return page.tobytes()

    def _check_geometry(self, block_size: int, kv_dtype: str,
                        page_bytes: int) -> None:
        from .migration import MigrationError
        if block_size != self.config.block_size:
            raise MigrationError(
                f"block_size mismatch: bundle {block_size}, "
                f"pool {self.config.block_size}")
        if kv_dtype != self._kv_name:
            raise MigrationError(
                f"kv dtype mismatch: bundle {kv_dtype}, pool "
                f"{self._kv_name}")
        if page_bytes != self._page_bytes:
            raise MigrationError(
                f"page geometry mismatch: bundle pages are "
                f"{page_bytes}B, this pool's are {self._page_bytes}B")

    # ------------------------------------------------------------------
    # KV-page migration (inference/migration.py): a sequence's computed KV
    # moves between engine pools as a PageBundle; ownership and rollback
    # ride StateManager's migration API
    # ------------------------------------------------------------------
    def can_import(self, n_tokens: int, remaining_gen: int) -> bool:
        """Would ``import_reserve`` succeed right now?"""
        if self._ring_tokens:
            return False
        return self.state.can_admit(n_tokens, remaining_gen)

    def export_migration(self, uid: int, trace_id: str = "",
                         tenant: str = "default"):
        """Snapshot a live sequence into a :class:`PageBundle`: drain the
        pipeline up to the last dispatch naming ``uid`` (the committed view
        then IS the pool content; tokens the drain commits surface in the
        next ``step()``), pin it (``StateManager.migrate_out``) and read its
        page extents to the host. The sequence stays frozen until
        ``export_commit`` or ``export_abort``."""
        self._no_tp("export_migration")
        from .migration import PageBundle
        from .prefix_cache import chain_hashes

        if self._ring_tokens:
            raise RuntimeError(
                "page migration requires linear block tables "
                "(rolling-ring mode reuses page slots in place)")
        while self._inflight and self._uid_inflight(uid):
            for u, new in self._drain(force=True).items():
                self._spec_emit.setdefault(u, []).extend(new)
        snap = self.state.migrate_out(uid, trace=trace_id or None)
        bs = self.config.block_size
        n_full = len(snap["page_blocks"])
        with self._telem.span("migrate_out", pages=n_full):
            page_blobs = self._gather_pages(snap["page_blocks"])
            tail = None
            if snap["tail_rows"]:
                tail = self._host_bytes(self._pool_bytes()[
                    :, :, :, snap["tail_block"],
                    :snap["tail_rows"]]).tobytes()
        bundle = PageBundle(
            trace_id=trace_id,
            tokens=snap["tokens"],
            prompt_len=len(snap["tokens"]) - snap["n_generated"],
            n_computed=snap["n_computed"],
            n_generated=snap["n_generated"],
            max_new_tokens=snap["max_new_tokens"],
            eos_id=snap["eos_id"], tenant=tenant,
            block_size=bs, kv_dtype=self._kv_name,
            page_bytes=self._page_bytes,
            tail_rows=snap["tail_rows"],
            tail_bytes=len(tail or b""),
            # the e4m3 pool is scale-free: no side-car scales
            weight_version=dict(self._weight_version),
            chain=chain_hashes(snap["tokens"][:n_full * bs], bs),
            scales=None, pages=page_blobs, tail=tail)
        bundle.validate()
        self.stats["migrations_out"] += 1
        self.stats["migration_bytes_out"] += bundle.payload_bytes
        return bundle

    def export_commit(self, uid: int) -> list[int]:
        """The importer acked: unpin, mark done and flush — release
        publishes the computed pages into the LOCAL trie. Returns the
        tokens generated here (the committed stream prefix)."""
        self._no_tp("export_commit")
        self.state.export_ack(uid)
        return self.flush(uid)

    def export_abort(self, uid: int) -> None:
        """Transfer failed or was refused: unpin; the sequence resumes
        locally exactly where it stopped."""
        self._no_tp("export_abort")
        self.state.export_abort(uid)

    def import_reserve(self, uid: int, meta: dict) -> None:
        """Claim a slot and the full remaining block budget for an arriving
        bundle (its wire header) BEFORE its first payload byte; the sequence
        stays frozen until ``import_complete``. Raises MigrationError on a
        geometry or dtype mismatch."""
        self._no_tp("import_reserve")
        from .migration import MigrationError, PageBundle

        shell = PageBundle.from_meta(meta)
        if self._ring_tokens:
            raise MigrationError("rolling-ring pools cannot import "
                                 "page chains")
        self._check_geometry(shell.block_size, shell.kv_dtype,
                             shell.page_bytes)
        if self._rt.enabled:
            # adopt the exporter's canonical (router-minted) trace ID so
            # both halves of the migrated request share one timeline key
            self._rt.begin(uid, tenant=shell.tenant,
                           prompt=shell.prompt_len,
                           trace_id=shell.trace_id or None)
        try:
            self.state.migrate_in_begin(
                uid, shell.tokens, shell.n_computed, shell.n_generated,
                shell.max_new_tokens, eos_id=shell.eos_id,
                trace=shell.trace_id or None)
        except Exception:
            self._rt.drop(uid)
            raise
        # the stream prefix generated on the exporter: flush() returns it
        # followed by what this engine generates
        self._results[uid] = list(shell.tokens[shell.prompt_len:])

    def import_complete(self, uid: int, bundle) -> None:
        """Payload landed: write the page extents into the reserved blocks
        and commit — the full pages seed the local prefix trie and the
        sequence unfreezes decode-ready. Its first plan decodes the last
        token from the host (``use_last`` stays off: nothing of it is in
        flight), so a greedy stream continues bit for bit."""
        self._no_tp("import_complete")
        from .migration import MigrationError, version_skew

        bundle.validate()
        if version_skew(bundle.weight_version, self._weight_version):
            raise MigrationError(
                f"version_skew: bundle weights "
                f"{bundle.weight_version} vs pool {self._weight_version}")
        seq = self.state.seqs[uid]
        blocks = list(seq.blocks[:bundle.n_full])
        pages = list(bundle.pages)
        if bundle.tail_rows:
            blocks.append(seq.blocks[bundle.n_full])
            pages.append(self._tail_page(bundle.tail, bundle.tail_rows))
        with self._telem.span("migrate_in", pages=bundle.n_full):
            self._scatter_pages(blocks, pages)
        self.state.import_commit(uid)
        if self._spec is not None:
            # the proposer sees the imported history as its prompt
            self._spec.admit(uid, list(seq.tokens),
                             seq.max_new_tokens - seq.n_generated
                             + self._spec_tracker.base_depth + 1)
        self.stats["migrations_in"] += 1
        self.stats["migration_bytes_in"] += bundle.payload_bytes
        if self._telem.enabled:
            self._admit_t[uid] = time.perf_counter()

    def import_abort(self, uid: int) -> None:
        """Transfer died before commit: free the reservation."""
        self._no_tp("import_abort")
        self.state.abort_import(uid)
        self._results.pop(uid, None)
        self._rt.drop(uid)

    # ------------------------------------------------------------------
    # radix pulls and gang prefill: a cached page chain moves as a
    # kind="prefix" PageBundle, no sequence involved
    # ------------------------------------------------------------------
    def export_prefix(self, tokens, trace_id: str = ""):
        """Bundle the longest cached chain prefixing ``tokens``, or raise
        MigrationError if nothing is cached."""
        self._no_tp("export_prefix")
        from .migration import MigrationError, PageBundle

        if self._prefix_cache is None or self._ring_tokens:
            raise MigrationError("no shareable prefix cache on this pool")
        snap = self.state.snapshot_prefix(tokens, trace=trace_id or None)
        if snap is None:
            raise MigrationError("prefix chain not cached")
        try:
            with self._telem.span("kv_pull_export",
                                  pages=len(snap["blocks"])):
                blobs = self._gather_pages(snap["blocks"])
        finally:
            self.state.release_prefix(snap["handle"])
        bundle = PageBundle.prefix(
            trace_id, [int(t) for t in tokens[:snap["n_tokens"]]],
            self.config.block_size, self._kv_name, self._page_bytes, blobs,
            weight_version=dict(self._weight_version))
        bundle.validate()
        self.stats["kv_pull_bytes_out"] = self.stats.get(
            "kv_pull_bytes_out", 0) + bundle.payload_bytes
        return bundle

    def import_prefix(self, bundle, source: str = "pull") -> int:
        """Adopt a pulled chain into the local trie (allocate-and-adopt
        through the refcounted API), then write the payload into exactly the
        freshly inserted blocks (deduplicated pages keep the cached copy).
        Returns the pages now cache-resident. Raises MigrationError, having
        adopted nothing, on version skew, a geometry or dtype mismatch, a
        pool too full for the chain, or a chain a pre-swap sequence still
        pins a stale page of. ``source`` labels the byte counter:
        "pull" (a radix pull) or "tier" (a KV-tier promote)."""
        self._no_tp("import_prefix")
        from .migration import MigrationError, version_skew

        bundle.validate()
        if bundle.kind != "prefix":
            raise MigrationError(f"not a prefix bundle ({bundle.kind})")
        if version_skew(bundle.weight_version, self._weight_version):
            raise MigrationError(
                f"version_skew: chain computed under "
                f"{bundle.weight_version}, pool serves "
                f"{self._weight_version}")
        if self._prefix_cache is None or self._ring_tokens:
            raise MigrationError("no shareable prefix cache on this pool")
        self._check_geometry(bundle.block_size, bundle.kv_dtype,
                             bundle.page_bytes)
        avail = self.state.allocator.free_blocks \
            + self._prefix_cache.evictable_blocks
        if bundle.n_full > avail:
            raise MigrationError(
                f"capacity: a chain of {bundle.n_full} pages, "
                f"{avail} blocks free or evictable")
        stale = self._prefix_cache.stale_pin_depth(bundle.tokens,
                                                   bundle.n_computed)
        if stale is not None:
            raise MigrationError(
                f"stale pin: a pre-swap sequence pins page {stale} of the "
                f"chain (weight swap in flight)")
        fresh = self.state.adopt_prefix(bundle.tokens, bundle.n_computed,
                                        trace=bundle.trace_id or None)
        with self._telem.span("kv_pull_import", pages=len(fresh)):
            self._scatter_pages([b for _, b in fresh],
                                [bundle.pages[j] for j, _ in fresh])
        key = f"kv_{source}_bytes_in"
        self.stats[key] = self.stats.get(key, 0) + bundle.payload_bytes
        return bundle.n_full

    def gang_prefill_segment(self, uid: int, tokens, prefix_bundle=None,
                             max_new_tokens: int = 1,
                             trace_id: str | None = None) -> int:
        """One gang-prefill member's leg: adopt the upstream hop's merged
        chain first (``import_prefix``), then admit ``tokens``; the radix
        match skips every adopted page, so this engine computes exactly its
        own segment. The final member passes the full prompt. Returns pages
        adopted from upstream; raises MigrationError without admitting on
        skew or a geometry mismatch."""
        self._no_tp("gang_prefill_segment")
        pages = 0
        if prefix_bundle is not None:
            pages = self.import_prefix(prefix_bundle, source="pull")
        self.put(uid, list(tokens), max_new_tokens=max_new_tokens,
                 trace_id=trace_id)
        return pages

    # ------------------------------------------------------------------
    # KV tiering (inference/kvtier.py): _demote_evicted is the prefix
    # cache's eviction sink; admission promotes through the two-phase
    # tier_promote_begin / tier_promote_finish and the same adopt + scatter
    # path radix pulls use
    # ------------------------------------------------------------------
    def _demote_evicted(self, chains) -> None:
        """Serialize each reclaimed chain as a kind="prefix" PageBundle into
        the tier; one gather per chain whose deepest page the tier lacks
        (residency is contiguous-from-root). The tier's own failures
        (refusal, crc, version, file I/O) raise DemoteError, which the cache
        counts and evicts past; a failed gather reaches the caller."""
        from .kvtier import KVTierError
        from .migration import MigrationError, PageBundle
        from .prefix_cache import DemoteError, chain_hashes

        tier = self._kv_tier
        if tier is None:
            return
        bs = self.config.block_size
        demoted = 0
        try:
            for tokens, blocks in chains:
                chain = chain_hashes(tokens, bs)
                if not chain or tier.has(chain[-1]):
                    continue
                with self._telem.span("kv_tier_demote", pages=len(blocks)):
                    blobs = self._gather_pages(blocks)
                try:
                    bundle = PageBundle.prefix(
                        "", [int(t) for t in tokens], bs, self._kv_name,
                        self._page_bytes, blobs,
                        weight_version=dict(self._weight_version))
                    demoted += tier.absorb(bundle)
                except (KVTierError, MigrationError, OSError) as e:
                    raise DemoteError(str(e)) from e
        finally:
            self.stats["kv_tier_demoted_pages"] += demoted
        if demoted and self._rt.enabled:
            self._rt.event(-1, "kv_tier", dir="demote", pages=demoted)

    def tier_promote_begin(self, tokens):
        """Promote-ahead, phase one: plan the admission-path tier extract
        without touching tier state. Returns an opaque handle, or None when
        the tier holds nothing deeper than the HBM trie."""
        self._no_tp("tier_promote_begin")
        from .prefix_cache import chain_hashes

        tier = self._kv_tier
        bs = self.config.block_size
        cap = min(len(tokens) - 1, self.state.max_blocks_per_seq * bs)
        n_full = cap // bs
        if tier is None or n_full < 1:
            return None
        aligned = [int(t) for t in tokens[:n_full * bs]]
        have = self._prefix_cache.cached_depth(aligned)
        deep = tier.probe(chain_hashes(aligned, bs))
        if deep <= have:
            return None              # HBM already covers the tier's chain
        h = tier.extract_begin(aligned[:deep * bs], bs)
        if h is not None:
            h["have"] = have
        return h

    def tier_promote_finish(self, handle) -> int:
        """Promote-ahead, phase two: the payload reads + crc checks the plan
        named, then ``import_prefix`` so the admit that follows hits the
        chain. Returns pages promoted; 0 (recompute covers the prompt) on a
        miss, corruption, version skew or a capacity refusal, the last
        three counted in ``kv_tier_fallbacks``."""
        self._no_tp("tier_promote_finish")
        from .migration import MigrationError

        tier = self._kv_tier
        if tier is None or handle is None:
            return 0
        bs = self.config.block_size
        t0 = time.perf_counter()
        bundle = tier.extract_finish(handle)
        if bundle is None:
            return 0
        try:
            pages = self.import_prefix(bundle, source="tier")
        except MigrationError as e:
            tier._fallback("adopt")
            self.stats["kv_tier_fallbacks"] += 1
            logger.warning(f"engine_v2: tier promote refused ({e}); "
                           f"recomputing")
            return 0
        tier.note_promote_latency(time.perf_counter() - t0, pages=pages)
        if self.config.kv_tier_min_pages is None:
            tier.refine_min_pages(block_size=bs)
        gained = max((len(handle["tok"]) // bs
                      - int(handle.get("have", 0))) * bs, 0)
        self.stats["kv_tier_promotes"] += 1
        self.stats["kv_tier_promoted_tokens"] += gained
        if self._rt.enabled:
            self._rt.event(-1, "kv_tier", dir="promote", pages=pages,
                           tokens=gained)
        return pages

    def _tier_promote(self, tokens) -> int:
        """Admission-path promote: the two phases back to back."""
        return self.tier_promote_finish(self.tier_promote_begin(tokens))

    def kv_tier_stats(self) -> dict | None:
        """Lifetime tier counters; None when tiering is off."""
        return None if self._kv_tier is None else self._kv_tier.stats()

    def kv_tier_digest(self, max_entries: int = 4096) -> list[int] | None:
        """Chain hashes of tier-resident pages (RAM first)."""
        return None if self._kv_tier is None \
            else self._kv_tier.residency_digest(max_entries)

    def kv_tier_version(self) -> int:
        """Tier membership version."""
        return 0 if self._kv_tier is None else self._kv_tier.version

    # ------------------------------------------------------------------
    # versioned weights: save, and swap in place
    # ------------------------------------------------------------------
    def weight_version(self) -> dict:
        """``{"id": monotonic int, "digest": manifest digest}`` of the
        weights being served ("init" digest = the constructor's)."""
        return dict(self._weight_version)

    def save_weights(self, save_dir: str, tag: str | None = None,
                     wid: int | None = None) -> str:
        """Publish the live parameter tree as a verified swap tag:
        ``<save_dir>/<tag>/state`` (one ``.npy`` per leaf + ``index.json``;
        quantized codes and scales as they are), ``meta.json``,
        ``manifest.json`` (size + crc32 of every file), then the atomic
        ``latest``. The port's own format: the JAX engine's tag is orbax,
        and neither package reads the other's. Returns the tag path."""
        self._no_tp("save_weights")
        from ..checkpoint.manifest import (manifest_digest,
                                           write_file_atomic,
                                           write_manifest)

        wid = int(wid if wid is not None
                  else self._weight_version["id"] + 1)
        tag = tag or f"weights_v{wid}"
        root = os.path.abspath(save_dir)
        path = os.path.join(root, tag)
        os.makedirs(path, exist_ok=True)
        save_param_tree(self.params, os.path.join(path, "state"))
        m = self.mcfg
        meta = {"tag": tag, "global_steps": wid, "format": "engine_weights",
                "model_dims": {"num_layers": m.num_layers,
                               "hidden": m.hidden_size,
                               "heads": m.num_heads,
                               "vocab": m.vocab_size},
                "quant_bits": self.config.quant_bits,
                "dtype": str(self.config.dtype)}
        with open(os.path.join(path, "meta.json"), "w") as f:
            json.dump(meta, f, indent=2)
        write_manifest(path, tag, wid)
        write_file_atomic(os.path.join(root, "latest"), tag)
        logger.info(f"engine_v2: published weights {path} "
                    f"(digest {manifest_digest(path)})")
        return path

    def _all_finite(self, tree) -> bool:
        """One device sync over every floating tensor of ``tree`` (e4m3
        codes by their NaN bit pattern, as torch has no isfinite for
        them)."""
        flags = []
        for t in tree_tensors(tree):
            if t.dtype == torch.float8_e4m3fn:
                flags.append(((t.view(torch.uint8) & 0x7F) != 0x7F).all())
            elif t.is_floating_point():
                flags.append(torch.isfinite(t).all())
        return not flags or bool(torch.stack(flags).all())

    def swap_weights(self, ckpt_dir: str, tag: str | None = None,
                     wid: int | None = None) -> dict:
        """In-place live weight swap from a verified tag of
        :meth:`save_weights`.

        (1) quiesce: every in-flight dispatch commits (its tokens surface in
        the next ``step()``); live sequences pause with their KV. (2)
        verify the tag's size + crc32 manifest (``integrity``;
        ``no_checkpoint`` when missing). (3) load it into a staged tree on
        the device, refusing any difference of leaf names, shapes or dtypes
        (``shape_mismatch``). (4) probe: every floating leaf finite
        (``probe_failed``). (5) commit: copy the staged tree into the live
        tensors in place — the captured graphs replay the new weights, no
        recapture — stamp the new ``weight_version``, flush the prefix
        cache's unpinned pages and invalidate the tier's records. Any
        refusal leaves the old weights serving untouched. The live tensors
        may be a model's own parameters (``module_param_tree`` serves them
        without a copy): they take the new weights too."""
        self._no_tp("swap_weights")
        from ..checkpoint.manifest import (manifest_digest, resolve_tag,
                                           tag_status)

        t0 = time.perf_counter()
        for u, new in self._drain(drain_all=True).items():
            self._spec_emit.setdefault(u, []).extend(new)
        quiesce_s = time.perf_counter() - t0
        if tag is not None:
            status, reason = tag_status(os.path.join(ckpt_dir, tag))
            if status == "missing":
                raise WeightSwapError("no_checkpoint",
                                      f"tag '{tag}' missing")
            if status != "verified":
                raise WeightSwapError(
                    "integrity", f"tag '{tag}' {status}: {reason}")
        else:
            tag, why = resolve_tag(ckpt_dir, None)
            if not tag:
                raise WeightSwapError("no_checkpoint", why)
        path = os.path.join(ckpt_dir, tag)
        try:
            digest = manifest_digest(path)
        except OSError as e:
            raise WeightSwapError("integrity", f"manifest unreadable: {e}")
        wid = int(wid if wid is not None
                  else self._weight_version["id"] + 1)
        t1 = time.perf_counter()
        try:
            staged = load_param_tree(os.path.join(path, "state"),
                                     self.params, self.device)
        except (ValueError, OSError, KeyError) as e:
            raise WeightSwapError("shape_mismatch", str(e))
        if not self._all_finite(staged):
            raise WeightSwapError(
                "probe_failed", "restored weights hold non-finite values")
        copy_param_tree_(self.params, staged)
        del staged
        self._weight_version = {"id": wid, "digest": digest}
        flushed = self.state.flush_prefix_cache()
        if self._prefix_cache is not None:
            self._prefix_cache.set_weight_version(wid)
        if self._kv_tier is not None:
            self._kv_tier.set_weight_version(self._weight_version)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        swap_s = time.perf_counter() - t1
        if self._rt.enabled:
            self._rt.event(-1, "weight_swap", wid=wid, flushed=flushed,
                           quiesce_s=round(quiesce_s, 6),
                           swap_s=round(swap_s, 6))
        self._telem.note("weight_swap", wid=wid, digest=digest,
                         quiesce_s=round(quiesce_s, 4),
                         swap_s=round(swap_s, 4))
        logger.info(f"engine_v2: weight swap to v{wid} (digest {digest}) "
                    f"quiesce {quiesce_s * 1e3:.1f}ms "
                    f"swap {swap_s * 1e3:.1f}ms, {flushed} cached pages "
                    f"flushed")
        return {"wv": self.weight_version(),
                "quiesce_s": quiesce_s, "swap_s": swap_s}
