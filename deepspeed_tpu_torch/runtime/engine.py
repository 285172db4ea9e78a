"""The training engine: ZeRO stages 0-3 over ``torch.distributed``.

Counterpart of ``deepspeed_tpu/runtime/engine.py`` (``DeepSpeedEngine``,
``initialize``). The JAX engine compiles its whole step — the micro-batch
scan of forward and backward, gradient accumulation, the update — into one
program over a device mesh; this one runs the same steps eagerly, one
process per device, in the same order and precision:

- state: the model's parameters in the compute dtype (bf16 / fp16, or fp32
  when neither is enabled) and, in mixed precision, an fp32 master copy
  with the optimizer's fp32 moments; an fp16 run adds the dynamic loss
  scaler (``runtime/fp16.py``);
- ZeRO (``zero_optimization.stage``) over the mesh's ``data`` x ``fsdp``
  group (``runtime/zero``): stage 0 keeps everything on every rank and
  all-reduces the gradients; stage 1 partitions the fp32 master and the
  moments (full fp32 gradients, reduce-scattered once a step); stage 2
  reduce-scatters each micro-batch's gradients as its backward accumulates
  them; stage 3 partitions the compute parameters too, gathered per unit
  around its use;
- ``train_batch(batch)``: every rank is given the same global batch, as
  the JAX ``train_batch`` is; it is split into
  ``gradient_accumulation_steps`` micro-batches of ``micro x dp`` rows, of
  which rank r keeps ``micro`` rows at ``g·micro·dp + r·micro``. Each
  micro-batch's gradients (of the scaled loss under fp16) are cast to
  fp32, unscaled and summed; loss and gradients are divided by the
  accumulation count and averaged over the ranks; clipping by global norm;
  a non-finite step skipped (the fp16 scaler, and the resilience
  sentinel, on by default), every rank deciding together; the optimizer on
  the master; the parameters cast back. The statistics the JAX engine
  takes over the whole global micro-batch — the loss's count of labelled
  tokens, the MoE gating means — are taken over the group
  (``comm.data_parallel_scope``);
- sequence parallelism (``mesh.seq`` > 1): each row's tokens split over
  the seq group, rank i keeping positions ``[i·S/n, (i+1)·S/n)`` of every
  leaf of two or more dims (the JAX engine's seq sharding of the batch),
  after ``labels`` are made by the next-token shift on whole rows. The
  model runs attention through Ulysses (``models/transformer.py``,
  ``parallel/sequence.py``) under ``comm.sequence_parallel_scope``; the
  loss's labelled-token count spans data x seq, so the loss is one masked
  mean over the global batch; the gradients of the parameters, replicated
  over seq as GSPMD keeps them, are summed over the seq ranks (at stages
  1-3 after ZeRO's reduce-scatter over the data-parallel group: the seq
  ranks of one partition hold the same partition) and averaged with the
  data-parallel ones. Only seq index 0 writes a partition to a
  checkpoint. A CUDA engine runs over NCCL, or over gloo when every rank is
  on one card (ranks time-slicing it: no measure of speed);
- tensor parallelism (``mesh.tensor`` > 1), Megatron-style where the JAX
  engine leaves it to GSPMD: each rank holds its slices of the model
  (``planner.tensor_spec``: heads, FFN columns and vocab rows; a dim that
  does not divide stays whole), drawn a block at a time from the seed of a
  model given on the meta device, sliced from ``params`` or from a whole
  model; the model runs its Megatron layers under
  ``comm.tensor_parallel_scope`` (``models/transformer.py``), and under
  ``tensor_parallel.overlap`` its row-parallel ``wo`` / ``w_down`` through
  ``ring_row_matmul`` (``tp_overlap_scope``, the JAX ``_loss_with_rules``).
  The tensor ranks of a data-parallel rank take the same rows. A sharded
  parameter's gradient stays on its rank (never reduced over ``tensor``);
  K/V projections kept whole beside sharded query heads have theirs summed
  over ``tensor`` first (each rank's covers its own heads). The clipping
  norm sums sharded squares over ``tensor`` and counts replicated ones
  once, the finite flag spans the tensor group, ZeRO partitions each rank's
  slices over the data-parallel group. ``master``, ``num_parameters`` and
  the MFU's FLOPs read the whole model; checkpoints hold logical tensors.
  MoE models, ZeRO-Offload (Infinity keeps the JAX engine's ValueError)
  and a custom ``loss_fn`` not marked as taking the axis's scope
  (``tensor_parallel`` / ``sequence_parallel = True``) are refused at
  tensor > 1 and at seq > 1, and the fused head at tensor > 1 (item 6b
  part 3);
- the ``forward`` / ``backward`` / ``step`` triplet with
  ``is_gradient_accumulation_boundary``; ``eval_batch``; ``zero_grad``;
  ``skipped_steps``, ``get_lr``, ``get_loss_scale``, ``num_parameters``;
- checkpoints (``runtime/checkpointing.py``): ``save_checkpoint`` /
  ``load_checkpoint`` / ``wait_for_checkpoint``, written as global logical
  tensors, loaded under any stage and world size;
- resilience (``runtime/resilience.py``): the divergence sentinel's skip →
  rewind to the last verified checkpoint → abort, loss-spike detection,
  the hang watchdog, fault injection and preemption saves;
  ``last_step_rewound`` and ``resilience_counters``;
- the ``activation_checkpointing`` section turns the model's ``remat`` on
  with the section's policy, as the JAX engine does;
- MoE models train on both routes (capacity einsums, or the dropless
  grouped products, K5 forward and backward on the card) with their
  layers' aux and z losses in the loss. ``train_batch``, ``forward`` and
  ``backward`` put the model in train mode (the JAX engine's
  ``_train_rng``: ``deterministic=False``), ``eval_batch`` in eval mode; a
  training step's micro-batches carry one ``_gating_seed`` for stochastic
  layers (RSample jitter), drawn from a generator seeded with the engine's
  seed and the step.

- ZeRO-Offload (``offload_optimizer``: "cpu" or "nvme", Twin-Flow's
  ``ratio``): the fp32 master and the moments of the rank's partition live
  on the host and the host library's SIMD step updates them
  (``runtime/zero/offload.py``); stage 0 offloads through stage 1's
  layout. fp16 is refused, as the JAX engine refuses it;
- ZeRO-Infinity (``offload_param``, with ``offload_optimizer``): the
  parameters stay on the host (or NVMe) and stream to the card a layer at
  a time (``runtime/zero/infinity.py``); ``train_batch`` and
  ``eval_batch`` only, a pure data-parallel mesh, no custom loss, the JAX
  engine's messages.

- telemetry (the ``telemetry`` section, ``telemetry/``): each
  ``train_batch`` runs under a step span (a ``record_function`` + NVTX
  range named ``train_batch#<step>``) and feeds the step-time histogram,
  the token counters and, under ``wall_clock_breakdown`` (where the step
  time is device-synced), tokens/s, MFU and goodput: the model's FLOPs
  (:func:`model_step_flops`) over the step time and the card's peak
  (``telemetry.mfu.device_peak_flops`` or ``peak_tflops``);
- the monitor backends (``tensorboard``, ``csv_monitor``, ``wandb``,
  ``comet``, ``prometheus``; ``monitor/``): the timer means every
  ``steps_per_print`` steps under ``wall_clock_breakdown``, the
  resilience and checkpoint counters when they change.

It runs on the CUDA device unless ``device="cpu"`` is given; ZeRO stages
1-3 and offload bring a process group up (a world of one) when none is,
NCCL on the card. Every feature that a later part of the port brings
raises NotImplementedError when it is configured (:func:`check_ported`),
naming its ROADMAP queue 1 item: the flops profiler, data efficiency and
the hybrid engine (item 7), the 1-bit optimizers, MoE / offload / custom
losses at tensor or seq > 1 and pipeline and expert parallelism in
training (item 6: 6b part 3, 6c, 6d), ZeRO++ and MiCS (after item 6).
Model compression runs outside the config (a compression manager the JAX
engine reads when set) and is not ported either.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import math
from functools import partial
from typing import Any, Callable

import numpy as np
import torch

from .. import comm
from ..accelerator import get_device
from ..config import Config
from ..models.loss import lm_loss_fn, shift_labels
from ..ops.optimizers import OptState, Optimizer, build_optimizer
from ..parallel.topology import BATCH_AXES, MeshTopology
from ..utils.logging import log_dist, logger
from ..utils.timer import (
    BACKWARD_GLOBAL_TIMER,
    BACKWARD_MICRO_TIMER,
    FORWARD_GLOBAL_TIMER,
    FORWARD_MICRO_TIMER,
    STEP_GLOBAL_TIMER,
    STEP_MICRO_TIMER,
    TRAIN_BATCH_TIMER,
    SynchronizedWallClockTimer,
    ThroughputTimer,
)
from . import fp16 as fp16_mod
from .lr_schedules import Schedule, build_scheduler, constant_lr
from .resilience import ResilienceManager


def model_step_flops(module: torch.nn.Module, rows: int, seq: int,
                     shapes: dict | None = None) -> float:
    """Model FLOPs of one training step over ``rows`` sequences of ``seq``
    tokens (PaLM appendix B): forward plus a backward of twice its cost,
    without remat's recomputation. The forward counts 2 per weight of
    every product a token goes through (the parameters of two or more
    dimensions but the embedding tables, whose rows are looked up; a tied
    head counts the table once; an expert stack counts ``top_k`` of its
    ``num_experts``) and 4 x head_dim per query head and causally visible
    (query, key) pair (scores and the weighted sum; a sliding window
    bounds the pairs). 0.0 when the module has no ``TransformerLM``
    config. ``shapes`` (name -> logical shape) stands in for the
    parameters' own where a tensor rank holds slices."""
    cfg = getattr(module, "config", None)
    if cfg is None or not hasattr(cfg, "num_heads"):
        return 0.0
    weights = 0
    if shapes is None:
        shapes = {n: tuple(p.shape) for n, p in module.named_parameters()}
    for n, shape in shapes.items():
        numel = math.prod(shape)
        if len(shape) < 2 or n in ("pos_embed", "type_embed"):
            continue
        if n == "embed":
            weights += numel if "unembed" not in shapes else 0
        elif ".experts." in n:
            weights += numel * cfg.moe.top_k // cfg.moe.num_experts
        else:
            weights += numel
    w = cfg.sliding_window
    if not cfg.causal:
        pairs = seq * seq
    elif w is None or w >= seq:
        pairs = seq * (seq + 1) // 2
    else:
        pairs = w * (w + 1) // 2 + (seq - w) * w
    head_dim = cfg.hidden_size // cfg.num_heads if getattr(
        cfg, "head_dim", None) is None else cfg.head_dim
    fwd = 2.0 * weights * rows * seq \
        + 4.0 * head_dim * cfg.num_heads * cfg.num_layers * pairs * rows
    return 3.0 * fwd


def _later(feature: str, item: str) -> NotImplementedError:
    return NotImplementedError(f"{feature} is ported with ROADMAP queue 1, "
                               f"{item}")


def check_ported(config: Config) -> None:
    """Raise NotImplementedError for every configured feature that a later
    part of the port brings (see the module docstring)."""
    z = config.zero_optimization
    if (z.zero_quantized_weights or z.zero_quantized_gradients
            or z.zero_hpz_partition_size > 1 or z.mics_shard_size > 0):
        raise _later("ZeRO++ (qwZ, qgZ, hpZ) and MiCS",
                     "the ZeRO++ / MiCS line after item 6")
    if config.data_efficiency.enabled:
        raise _later("data efficiency (curriculum learning, random-LTD)",
                     "item 7")
    if config.hybrid_engine.enabled:
        raise _later("the hybrid engine", "item 7")
    if config.flops_profiler.enabled:
        raise _later("the flops profiler", "item 7 (profiling/)")
    z = config.zero_optimization
    for axis, size in _split_axes(config).items():
        # offload_param with a tensor or seq axis keeps the JAX engine's
        # ValueError (_check_offload); ZeRO-Offload alone comes later
        if z.offload_optimizer.device != "none" \
                and z.offload_param.device == "none":
            raise _axis_later(axis, size, "ZeRO-Offload")


def _split_axes(config: Config) -> dict[str, int]:
    """The fixed sizes above 1 of the mesh's ``tensor`` and ``seq`` axes."""
    out = {}
    for axis in ("tensor", "seq"):
        v = getattr(config.mesh, axis)
        if v not in ("auto", -1, None) and int(v) > 1:
            out[axis] = int(v)
    return out


def _axis_later(axis: str, size: int, feature: str) -> NotImplementedError:
    return _later(f"mesh axes {{'{axis}': {size}}}: {feature} at {axis} > 1",
                  "item 6b part 3")


class DeepSpeedEngine:
    """See the module docstring. ``model`` is a ``TransformerLM`` (or any
    module whose call maps ``input_ids`` to logits, with a ``loss_fn``);
    ``loss_fn(model, batch) -> loss`` replaces the default LM loss;
    ``params`` (a JAX-layout tree of numpy arrays or tensors, e.g. the JAX
    package's initial parameters) replaces the model's initial values."""

    def __init__(self, config: Config, model: torch.nn.Module | None = None,
                 loss_fn: Callable | None = None, params: dict | None = None,
                 topology: MeshTopology | None = None, device=None):
        if model is None:
            raise ValueError("need a model (a torch.nn.Module)")
        check_ported(config)
        for axis, size in _split_axes(config).items():
            self._check_split(axis, size, model, loss_fn)
        self.config = config
        self.device = get_device(device)
        self.zero_stage = config.zero_optimization.stage
        if self.zero_stage not in (0, 1, 2, 3):
            raise ValueError(f"zero_optimization.stage must be 0-3, got "
                             f"{self.zero_stage}")
        offload = self._check_offload(config, loss_fn)
        if offload == "optimizer" and self.zero_stage == 0:
            # the host walks a flat partition: stage 0 offloads through
            # stage 1's layout, whose update gives the same bits
            log_dist("offload_optimizer at ZeRO stage 0 runs stage 1's "
                     "partitioned layout")
            self.zero_stage = 1
        if self.zero_stage > 0 or comm.is_initialized():
            comm.init_distributed(device=self.device)
            self._check_backend()
        self.topology = topology if topology is not None \
            else MeshTopology(config.mesh)
        comm.set_topology(self.topology)
        self.dp_world_size = self.topology.dp_world_size
        self.dp_rank = self.topology.dp_rank
        self.dp_group = self.topology.dp_group
        # sequence parallelism: each row's tokens split over the seq group;
        # the step's statistics and gradients span data x seq (the batch)
        self.sp_size = self.topology.size("seq")
        self.sp_rank = self.topology.rank_in("seq")
        self.batch_world_size = self.dp_world_size * self.sp_size
        self.batch_group = self.topology.group(BATCH_AXES) \
            if self.sp_size > 1 else self.dp_group
        # tensor parallelism: the model's Megatron layers over the tensor
        # group; its ranks take the same rows and positions
        self.tp_size = self.topology.size("tensor")
        self.tp_rank = self.topology.rank_in("tensor")
        for axis, size in (("seq", self.sp_size), ("tensor", self.tp_size)):
            if size > 1:
                self._check_split(axis, size, model, loss_fn)
                if offload is not None:
                    raise _axis_later(axis, size, "ZeRO-Offload")
        # ring collective matmuls in the row-parallel projections (the JAX
        # engine's _tp_overlap: tensor > 1 and no pipeline)
        self._tp_overlap = bool(config.tensor_parallel.overlap
                                and self.tp_size > 1
                                and self.topology.size("pipe") == 1)
        config.resolve_batch_terms(self.dp_world_size)
        if config.comms_logger.enabled:
            c = config.comms_logger
            comm.configure_comms_logger(enabled=True, verbose=c.verbose,
                                        debug=c.debug)

        # activation checkpointing: flip the model's remat switch from the
        # DeepSpeed-style section (reference checkpointing.py:893)
        ac = config.activation_checkpointing
        if ac.policy != "none" and hasattr(model, "config") \
                and hasattr(model.config, "remat"):
            if loss_fn is not None:
                logger.warning(
                    "activation_checkpointing is configured but a custom "
                    "loss_fn was supplied — the engine does not rewire a "
                    "loss closure; set the model's remat yourself")
            else:
                from ..ops.remat import make_policy

                make_policy(ac.policy)
                # a shallow clone (reference model.clone(config=...)): it
                # shares the caller's parameters and submodules, but the
                # caller's own config keeps its remat switch
                model = copy.copy(model)
                model.config = dataclasses.replace(
                    model.config, remat=True, remat_policy=ac.policy)
        if ac.partition_activations and self.topology.size("seq") <= 1:
            logger.warning("partition_activations=True but the mesh has no "
                           "'seq' axis — activations stay unpartitioned")
        from . import activation_checkpointing as _ac_mod

        _ac_mod.configure(ac)

        self.module = model
        self._loss_fn = partial(loss_fn or lm_loss_fn, model)

        # precision regime (reference engine dtype checks :1101)
        self.fp16_enabled = config.fp16.enabled
        self.bf16_enabled = config.bf16.enabled and not self.fp16_enabled
        self.compute_dtype = config.compute_dtype
        self.mixed_precision = self.fp16_enabled or self.bf16_enabled

        self.optimizer: Optimizer = build_optimizer(config.optimizer.type,
                                                    config.optimizer.params)
        self._host_opt = self._param_stream = None
        if offload is not None:
            from .zero.offload import HostOffloadOptimizer

            self._host_opt = HostOffloadOptimizer(
                config.optimizer.type, config.optimizer.params,
                config.zero_optimization.offload_optimizer,
                self.compute_dtype if self.mixed_precision else torch.float32,
                self.device)
        if offload == "param":
            from .zero.infinity import LayerStreamTrainer

            self._param_stream = LayerStreamTrainer(
                model, config, self._host_opt,
                self.compute_dtype if self.mixed_precision else torch.float32,
                self.device, self.dp_group, self.dp_world_size)
        base_lr = config.optimizer.params.get("lr", getattr(self.optimizer, "lr", 1e-3))
        if config.scheduler is not None:
            self.lr_schedule: Schedule = build_scheduler(
                config.scheduler.type, config.scheduler.params, base_lr=base_lr)
        else:
            self.lr_schedule = constant_lr(base_lr)

        self.timers = SynchronizedWallClockTimer()
        self.tput_timer = ThroughputTimer(
            batch_size=config.train_batch_size,
            steps_per_output=config.steps_per_print)

        self._zero = None
        self._init_state(params)
        self._gating = torch.Generator()
        self._accum_grads: list[torch.Tensor] | None = None
        self._accum_count = 0
        self._last_loss: torch.Tensor | None = None
        self._pending: torch.Tensor | None = None
        self.global_steps = 0
        self._resume_tag: str | None = None
        # fault tolerance (runtime/resilience.py): divergence sentinel,
        # preemption, watchdog, fault injection
        self.resilience = ResilienceManager(self, config.resilience)
        self._monitor_master = None   # lazy MonitorMaster (monitor/)

        # telemetry (telemetry/): spans + SLO/health metrics + MFU/goodput
        # + flight recorder. The process-wide instance is shared with
        # engine_v2 / checkpointing / resilience so /metrics is one pane;
        # configure() mutates it in place when this engine enables it.
        from .. import telemetry as _telemetry

        if config.telemetry.enabled:
            _telemetry.configure(config.telemetry)
        self._telem = _telemetry.get_telemetry()
        self._mfu_tracker: _telemetry.MFUTracker | None = None
        self._step_flops: float | None = None   # counted at the first step
        if self._telem.enabled:
            peak = (config.telemetry.peak_tflops * 1e12
                    if config.telemetry.peak_tflops
                    else _telemetry.device_peak_flops())
            self._mfu_tracker = _telemetry.MFUTracker(peak_flops=peak)
            self._telem.set_health(job="train",
                                   zero_stage=config.zero_optimization.stage)
        logger.info(
            f"engine up: zero_stage={self.zero_stage} dp={self.dp_world_size} "
            f"device={self.device} "
            f"dtype={'fp16' if self.fp16_enabled else 'bf16' if self.bf16_enabled else 'fp32'} "
            f"micro_bs={config.train_micro_batch_size_per_gpu} "
            f"gas={config.gradient_accumulation_steps} "
            f"global_bs={config.train_batch_size}")

    # ------------------------------------------------------------------
    def _check_backend(self) -> None:
        """A CUDA engine runs over NCCL; over gloo only when every rank is
        on one physical card (ranks time-slicing it, NCCL refusing two
        ranks on one device), its collectives staged through pinned host
        memory (``comm``). Such a run measures nothing about speed."""
        dist = torch.distributed
        backend = dist.get_backend()
        if self.device.type != "cuda" or backend == "nccl":
            return
        if backend == "gloo":
            uuids = [None] * dist.get_world_size()
            dist.all_gather_object(uuids, str(
                torch.cuda.get_device_properties(self.device).uuid))
            if len(set(uuids)) == 1:
                log_dist(f"a CUDA engine over gloo: {len(uuids)} ranks on "
                         f"one card, collectives staged through host "
                         f"memory; this run measures nothing about speed")
                return
        raise RuntimeError(
            f"a CUDA engine needs the NCCL backend (or gloo with every rank "
            f"on one card); the process group is {backend}")

    @staticmethod
    def _check_split(axis: str, size: int, model, loss_fn) -> None:
        """What a tensor or seq axis above 1 does not take yet (ROADMAP
        item 6b part 3): a MoE model, and a custom loss_fn not marked as
        taking the axis's scope."""
        if getattr(getattr(model, "config", None), "moe", None) is not None:
            raise _axis_later(axis, size, "a MoE model")
        mark = {"seq": "sequence_parallel", "tensor": "tensor_parallel"}[axis]
        if loss_fn is not None and not getattr(loss_fn, mark, False):
            raise _axis_later(axis, size,
                              f"a custom loss_fn that does not take the "
                              f"{mark.replace('_', '-')} scope (mark it "
                              f"`{mark} = True`)")

    def _check_offload(self, config: Config, loss_fn) -> str | None:
        """Validate ``offload_optimizer`` / ``offload_param`` with the JAX
        engine's rules and messages: None, "optimizer" (ZeRO-Offload) or
        "param" (ZeRO-Infinity's layer streaming)."""
        z = config.zero_optimization
        off, poff = z.offload_optimizer, z.offload_param
        if off.device in ("cpu", "nvme"):
            if config.fp16.enabled:
                raise ValueError("offload_optimizer requires bf16/fp32 "
                                 "(dynamic loss scaling is device-side)")
        elif off.device != "none":
            raise ValueError(f"offload_optimizer.device '{off.device}' "
                             f"unsupported (none|cpu|nvme)")
        if poff.device in ("cpu", "nvme"):
            if off.device not in ("cpu", "nvme"):
                raise ValueError(
                    "offload_param requires offload_optimizer (cpu|nvme): "
                    "streamed params update on the host master")
            if off.ratio != 1.0:
                raise ValueError(
                    "offload_param requires offload_optimizer.ratio == 1.0 "
                    "(a Twin-Flow device share would keep streamed params "
                    "resident)")
            if poff.device == "nvme" and off.device != "nvme":
                raise ValueError("offload_param.device='nvme' requires "
                                 "offload_optimizer.device='nvme' (shared "
                                 "async-I/O engine)")
            if loss_fn is not None:
                raise ValueError(
                    "offload_param drives the model layer-by-layer — pass "
                    "model= (a TransformerLM) without a custom loss_fn")
            bad = [a for a in ("tensor", "seq", "pipe", "expert")
                   if getattr(config.mesh, a) not in (1, "auto", -1)]
            if bad:
                raise ValueError(f"offload_param streaming needs a pure DP "
                                 f"mesh (fsdp x data); axes {bad} have "
                                 f"size > 1")
            return "param"
        if poff.device != "none":
            raise ValueError(f"offload_param.device '{poff.device}' "
                             f"unsupported (none|cpu|nvme)")
        return "optimizer" if off.device in ("cpu", "nvme") else None

    def _init_state(self, params: dict | None) -> None:
        """Master, parameters and optimizer state. At stage 0 the model's
        own fp32 values become the master (no copy) and its parameters are
        recast to the compute dtype in place; at stages 1-3 the values move
        into the ZeRO buffers (``runtime/zero/partition.py``), their master
        and moments onto the host under ZeRO-Offload. Under ZeRO-Infinity
        nothing moves to the card: the host optimizer takes the master and
        the layer streamer a compute-dtype cache."""
        if self._param_stream is not None:
            self._init_stream_state(params)
            return
        if self.tp_size > 1:
            self._shard_model(params)
            params = None
        model = self.module.to(self.device)
        self._names = [n for n, _ in model.named_parameters()]
        self._params = [p for _, p in model.named_parameters()]
        self._init_tp_layout()
        for p in self._params:
            p.data = p.data.float()
        if params is not None:
            from ..inference.weights import load_jax_params

            load_jax_params(model, params)
        for p in self._params:
            p.requires_grad_(True)
        for i in self._tp_sum:
            # registered before ZeRO's hooks, so it runs first
            self._params[i].register_post_accumulate_grad_hook(
                self._sum_over_tensor)
        self.scaler = fp16_mod.init_scaler(self.config.fp16) \
            if self.fp16_enabled else None
        self.global_step = 0        # steps taken, applied or skipped
        if self.zero_stage > 0:
            from .zero.partition import ZeroRuntime
            from .zero.planner import build_plan

            plan = build_plan(
                self.zero_stage, self._names,
                [tuple(p.shape) for p in self._params],
                world=self.dp_world_size, rank=self.dp_rank,
                persistence_threshold=self.config.zero_optimization
                .stage3_param_persistence_threshold)
            modules = {u: getattr(model, f"layer_{k}")
                       for u, k in enumerate(plan.unit_keys)
                       if k is not None and hasattr(model, f"layer_{k}")}
            self._zero = ZeroRuntime(
                plan, self._params,
                self.compute_dtype if self.mixed_precision else torch.float32,
                self.optimizer, self.dp_group, self.device, modules,
                host_opt=self._host_opt,
                tensor=None if self.tp_size == 1 else (
                    self.topology.group("tensor"),
                    [s is not None and "tensor" in s
                     for s in self._tp_specs]))
            self._master = None
            self.opt_state = None
            log_dist(plan.describe())
            return
        if self.mixed_precision:
            self._master = []
            for p in self._params:
                self._master.append(p.data)
                p.data = p.data.to(self.compute_dtype)
        else:
            self._master = self._params
        with torch.no_grad():
            self.opt_state: OptState = self.optimizer.init(
                [m.detach() for m in self._master])

    def _shard_model(self, params: dict | None) -> None:
        """Replace the model's parameters by this tensor rank's slices
        (``planner.tensor_spec``: heads, FFN columns and vocab rows over
        ``tensor``; a dim that does not divide stays whole), in fp32 on
        the device: ``params`` (a JAX-layout tree) sliced leaf by leaf, a
        model on the meta device drawn again a block at a time from its
        seed, a materialized model sliced once
        (``inference.weights.load_tp_params``). A rank never holds the
        whole model unless it was given one."""
        from ..inference.weights import (flatten_tree, load_tp_params,
                                         params_from_jax)

        tree = None if params is None else params_from_jax(
            params, dtype=torch.float32, device="cpu")
        local, self._tp_plan = load_tp_params(
            self.module, tree, self.topology, dtype=torch.float32,
            device=self.device)
        del tree
        names = {n for n, _ in self.module.named_parameters()}
        flat = flatten_tree(local)
        if set(flat) != names:
            raise ValueError(f"tensor-parallel slices {sorted(flat)} do "
                             f"not match the model's {sorted(names)}")
        for name, t in flat.items():
            *path, leaf = name.split(".")
            mod = self.module.get_submodule(".".join(path))
            mod._parameters[leaf] = torch.nn.Parameter(t, requires_grad=False)

    def _init_tp_layout(self) -> None:
        """Each parameter's tensor spec (None without a tensor axis), its
        logical (whole) shape, and the replicated parameters whose
        gradients are summed over ``tensor``: the K/V projections kept
        whole beside sharded query heads, which each rank uses only for
        its own heads."""
        self._global_shapes = [tuple(p.shape) for p in self._params]
        self._tp_specs: list = [None] * len(self._params)
        self._tp_sum: list[int] = []
        if self.tp_size == 1:
            return
        specs = {".".join(path): spec
                 for path, (spec, _) in self._tp_plan.items()}
        for i, (name, p) in enumerate(zip(self._names, self._params)):
            spec = self._tp_specs[i] = specs[name]
            if "tensor" in spec:
                shape = list(p.shape)
                shape[spec.index("tensor")] *= self.tp_size
                self._global_shapes[i] = tuple(shape)
            *path, leaf = name.split(".")
            if path and path[-1] == "attn" and leaf in ("wk", "wv", "bk",
                                                        "bv") \
                    and "tensor" not in spec \
                    and "tensor" in specs[".".join(path + ["wq"])]:
                self._tp_sum.append(i)

    def _sum_over_tensor(self, p: torch.Tensor) -> None:
        torch.distributed.all_reduce(p.grad,
                                     group=self.topology.group("tensor"))

    def _init_stream_state(self, params: dict | None) -> None:
        model = self.module
        self._names = [n for n, _ in model.named_parameters()]
        self._params = [p for _, p in model.named_parameters()]
        self._init_tp_layout()
        with torch.no_grad():
            for p in self._params:
                p.data = p.data.float().cpu()
            if params is not None:
                from ..inference.weights import load_jax_params

                load_jax_params(model, params)
        self.scaler = None
        self.global_step = 0
        self._master = None
        self.opt_state = None
        masters = {n: p.data.reshape(-1) for n, p in zip(self._names,
                                                          self._params)}
        self._host_opt.init_leaves(masters)
        self._param_stream.init_from_master(masters)

    @contextlib.contextmanager
    def _host_state(self, changed: bool = False):
        """The host-resident state as whole tensors for the block (a
        checkpoint, ``master``): see ``HostOffloadOptimizer.materialized``
        and ``LayerStreamTrainer.materialized``; a no-op without offload."""
        if self._param_stream is not None:
            with self._param_stream.materialized(self, changed):
                yield
        elif self._host_opt is not None:
            with self._host_opt.materialized(self._zero, changed):
                yield
        else:
            yield

    @property
    def opt_step(self) -> int:
        """Applied optimizer updates."""
        if self._host_opt is not None:
            return self._host_opt.step_count
        return self._zero.step if self._zero is not None \
            else self.opt_state.step

    # ------------------------------------------------------------------
    def _to_device(self, x) -> torch.Tensor:
        t = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
        if not t.is_floating_point():
            t = t.long()
        return t.to(self.device)

    def _device_batch(self, batch: dict) -> dict:
        return {k: self._to_device(v) for k, v in batch.items()}

    def _rows(self, batch: dict) -> dict:
        """This rank's rows of a micro-batch of ``micro x dp`` rows (the
        whole batch on one rank, or when the rows do not split)."""
        n = self.dp_world_size
        rows = next(iter(batch.values())).shape[0]
        if n == 1 or rows % n:
            return batch
        m = rows // n
        return {k: v[self.dp_rank * m:(self.dp_rank + 1) * m]
                for k, v in batch.items()}

    def _columns(self, batch: dict) -> dict:
        """At seq > 1, this rank's ``[S/n]`` slice of dim 1 of every leaf of
        two or more dims (the JAX engine's seq sharding of the batch),
        after ``labels`` are made by the next-token shift on whole rows (a
        shard's last label is its neighbour's first token)."""
        n = self.sp_size
        if n == 1:
            return batch
        if "labels" not in batch:
            batch = {**batch, "labels": shift_labels(batch["input_ids"])}
        out = {}
        for k, v in batch.items():
            if v.dim() >= 2:
                S = v.shape[1]
                if S % n:
                    raise ValueError(f"'{k}' has {S} positions, which do "
                                     f"not split over seq {n}")
                v = v[:, self.sp_rank * (S // n):(self.sp_rank + 1) * (S // n)]
            out[k] = v
        return out

    def _mine(self, batch: dict) -> dict:
        """This rank's rows and columns of a micro-batch."""
        return self._columns(self._rows(batch))

    def _split_for_gas(self, batch: dict) -> list[dict]:
        gas = self.config.gradient_accumulation_steps
        B = self.config.train_batch_size
        for k, v in batch.items():
            if v.shape[0] != B:
                raise ValueError(f"train_batch expects global batch dim {B}, "
                                 f"got {v.shape[0]} for '{k}'")
        micro = B // gas
        return [self._mine({k: v[g * micro:(g + 1) * micro]
                            for k, v in batch.items()}) for g in range(gas)]

    @contextlib.contextmanager
    def _dp_scope(self, rows: bool = True):
        """The step's scopes: the data-parallel one when the rows split
        over the ranks, the sequence-parallel one at seq > 1, the
        tensor-parallel one at tensor > 1, and ``tp_overlap_scope`` under
        ``tensor_parallel.overlap`` (the JAX ``_loss_with_rules``)."""
        from ..parallel.tensor import tp_overlap_scope

        with comm.data_parallel_scope(
                *((self.dp_group, self.dp_world_size, self.dp_rank) if rows
                  else (None, 1, 0))), \
                comm.sequence_parallel_scope("seq", self.sp_size,
                                             self.sp_rank), \
                comm.tensor_parallel_scope("tensor", self.tp_size,
                                           self.tp_rank), \
                (tp_overlap_scope(self.topology) if self._tp_overlap
                 else contextlib.nullcontext()):
            yield

    def _train_loss(self, batch: dict) -> torch.Tensor:
        """The loss of a device micro-batch in train mode, with the step's
        ``_gating_seed``: one seed a step, shared by its micro-batches (the
        JAX engine folds one key per step), from a generator seeded with
        the engine's seed and the step. A ``_fault_scale`` column (fault
        injection's NaN rail) multiplies the loss by its mean."""
        self.module.train()
        self._gating.manual_seed(self.config.seed * 1_000_003
                                 + self.global_step)
        seed = int(torch.randint(0, 2 ** 62, (), generator=self._gating))
        batch = dict(batch)
        fault = batch.pop("_fault_scale", None)
        if self._zero is not None:
            self._zero.begin_forward()
        loss = self._loss_fn({**batch, "_gating_seed": seed})
        if fault is not None:
            loss = loss * fault.float().mean()
        return loss

    def _backward(self, loss: torch.Tensor) -> None:
        """Add the gradients of ``loss`` (of the scaled loss under fp16,
        then unscaled), as fp32, to the running sums: at stages 0-1 one
        parameter at a time, so no second set of fp32 gradients is ever
        held; at stages 2-3 reduce-scattered into the rank's partition as
        the backward produces them. The parameters' ``.grad`` are
        cleared."""
        for p in self._params:
            p.grad = None
        scaled = loss * self.scaler.scale if self.scaler is not None else loss
        if self.zero_stage >= 2:
            if self._accum_count == 0:
                self._zero.begin_accumulation()
            with self._zero.backward(
                    self.scaler.scale if self.scaler is not None else None):
                scaled.backward()
            self._accum_grads = self._zero.grad
            self._accum_count += 1
            return
        scaled.backward()
        first = self._accum_grads is None
        if first:
            self._accum_grads = []
        for i, p in enumerate(self._params):
            g = p.grad
            p.grad = None
            g = torch.zeros_like(p, dtype=torch.float32) if g is None \
                else g.float()
            if self.scaler is not None:
                g = g / self.scaler.scale
            if first:
                self._accum_grads.append(g)
            else:
                self._accum_grads[i].add_(g)
        self._accum_count += 1

    def _finish_grads(self, scale) -> list[torch.Tensor] | torch.Tensor:
        """The accumulated gradients times ``scale`` (``("div", gas)`` or
        ``("mul", 1/count)``) and averaged over the data-parallel ranks:
        per-parameter tensors at stage 0, the rank's fp32 partition at
        stages 1-3."""
        op, v = scale
        n = self.batch_world_size
        if self._zero is not None:
            if self.zero_stage == 1:
                self._zero.begin_accumulation()
                self._zero.reduce_full(self._accum_grads)
            g = self._zero.grad
            g.div_(v) if op == "div" else g.mul_(v)
            if self.sp_size > 1:
                # the seq ranks of a partition hold its partial sums
                torch.distributed.all_reduce(
                    g, group=self.topology.group("seq"))
            if n > 1:
                g.div_(n)
            return g
        grads = self._accum_grads
        for g in grads:
            g.div_(v) if op == "div" else g.mul_(v)
        if n > 1:
            for g in grads:
                torch.distributed.all_reduce(g, group=self.batch_group)
                g.div_(n)
        return grads

    def _global_norm(self, grads) -> torch.Tensor:
        """The norm of the whole model's gradient: at tensor > 1 a sharded
        parameter's squares are summed over the tensor ranks and a
        replicated one's counted once."""
        if self._zero is not None:
            return torch.sqrt(self._zero.grad_sq_norm())
        sq = [torch.sum(torch.square(g.float())) for g in grads]
        if self.tp_size == 1:
            return torch.sqrt(torch.stack(sq).sum())
        sharded = torch.stack([q for q, spec in zip(sq, self._tp_specs)
                               if "tensor" in spec] or [sq[0] * 0]).sum()
        rep = torch.stack([q for q, spec in zip(sq, self._tp_specs)
                           if "tensor" not in spec] or [sq[0] * 0]).sum()
        torch.distributed.all_reduce(sharded,
                                     group=self.topology.group("tensor"))
        return torch.sqrt(sharded + rep)

    def _tp_lamb_reduce(self, w_sq: torch.Tensor, u_sq: torch.Tensor):
        """LAMB's per-tensor squared norms at stage 0 and tensor > 1: a
        sharded parameter's summed over the tensor ranks."""
        sharded = torch.tensor(["tensor" in s for s in self._tp_specs],
                               device=w_sq.device)
        both = torch.stack([w_sq, u_sq], dim=1) * sharded[:, None]
        torch.distributed.all_reduce(both,
                                     group=self.topology.group("tensor"))
        return (torch.where(sharded, both[:, 0], w_sq),
                torch.where(sharded, both[:, 1], u_sq))

    def _apply_grads(self, grads, loss_finite: torch.Tensor | None = None
                     ) -> bool:
        """Clip, check, update the master and recast the parameters; the
        step counter advances whether or not the update ran. Every rank
        takes the same decision: the norm and the finite flag are reduced
        over the group."""
        cfg = self.config
        lr = self.lr_schedule(self.opt_step)
        if cfg.gradient_clipping:
            norm = self._global_norm(grads)
            clip = torch.clamp(cfg.gradient_clipping / (norm + 1e-6), max=1.0)
            for g in (grads if self._zero is None else [grads]):
                g.mul_(clip)
        finite = True
        if self.scaler is not None or cfg.resilience.sentinel:
            flag = self._zero.grads_finite() if self._zero is not None \
                else fp16_mod.grads_finite(grads)
            if loss_finite is not None:
                flag = flag & loss_finite.to(flag.device)
            if self.tp_size > 1:
                # one decision across the tensor ranks' slices
                ok = flag.to(torch.int32)
                torch.distributed.all_reduce(
                    ok, op=torch.distributed.ReduceOp.MIN,
                    group=self.topology.group("tensor"))
                flag = ok.bool()
            finite = bool(flag)
        if finite:
            if self._zero is not None:
                self._zero.update(lr)
            else:
                extra = {} if self.optimizer.elementwise \
                    or self.tp_size == 1 else {
                        "sq_norm_reduce": self._tp_lamb_reduce}
                self.opt_state = self.optimizer.update(
                    grads, self.opt_state, self._master, lr=lr, **extra)
                if self.mixed_precision:
                    with torch.no_grad():
                        for p, m in zip(self._params, self._master):
                            p.copy_(m)
        if self.scaler is not None:
            self.scaler = fp16_mod.update_scaler(self.scaler, finite,
                                                 cfg.fp16)
        self.global_step += 1
        return finite

    def _dp_mean(self, x: torch.Tensor, rows: bool = True) -> torch.Tensor:
        """The mean of ``x`` over the ranks that split the batch: data x
        seq, or seq alone where the rows did not split."""
        group, n = (self.batch_group, self.batch_world_size) if rows \
            else (self.topology.group("seq"), self.sp_size)
        if n == 1:
            return x
        out = x.clone()
        torch.distributed.all_reduce(out, group=group)
        return out / n

    # ------------------------------------------------------------------
    # public API
    def train_batch(self, batch: dict) -> torch.Tensor:
        """One full training step over a global batch (each leaf
        ``[train_batch_size, ...]``), the same on every rank. Returns the
        mean micro-batch loss over the global batch, a 0-d fp32 tensor on
        the engine's device.

        Resilience (runtime/resilience.py): a pending preemption saves and
        raises ``Preempted`` before the step; the sentinel observes the
        step after it and may rewind (``last_step_rewound``: re-derive the
        data position from the restored ``global_steps``) or raise
        ``DivergenceError``.

        Telemetry (telemetry/): when enabled, the step runs under a step
        span mirrored as a ``record_function`` + NVTX range (a
        ``torch.profiler`` trace groups the step's kernels under it) and
        feeds the training-health instruments — step-time histogram,
        tokens/s, MFU, and goodput that discounts sentinel-skipped and
        rewound steps."""
        telem = self._telem
        if not telem.enabled:
            return self._train_batch_inner(batch)
        step_before = self.global_steps
        skipped_before = self.skipped_steps
        with telem.step_span("train_batch", self.global_steps):
            loss = self._train_batch_inner(batch)
        self._record_train_telemetry(batch, step_before, skipped_before)
        return loss

    def _train_batch_inner(self, batch: dict) -> torch.Tensor:
        res = self.resilience
        res.check_preemption()
        self.tput_timer.start()
        self.timers(TRAIN_BATCH_TIMER).start()
        if self._param_stream is not None:
            return self._train_batch_streamed(batch)
        batch = res.arm_batch(batch, self.config.train_batch_size)
        gas = self.config.gradient_accumulation_steps
        with res.guard("train_step"), self._dp_scope():
            res.injector.maybe_stall("stall_train_step_s")
            self._accum_grads, self._accum_count = None, 0
            loss_sum = torch.zeros((), dtype=torch.float32,
                                   device=self.device)
            for mb in self._split_for_gas(self._device_batch(batch)):
                loss = self._train_loss(mb)
                self._backward(loss)
                loss_sum = loss_sum + loss.detach().float()
            grads = self._finish_grads(("div", gas))
            self._accum_grads, self._accum_count = None, 0
            loss = self._dp_mean(loss_sum / gas)
            finite = self._apply_grads(grads, torch.isfinite(loss))
        self.global_steps += 1
        sync = loss if self.config.wall_clock_breakdown else None
        self.timers(TRAIN_BATCH_TIMER).stop(sync_val=sync)
        self.tput_timer.stop(sync_val=sync)
        if self.global_steps % self.config.steps_per_print == 0:
            log_dist(f"step={self.global_steps} loss={float(loss):.4f} "
                     f"lr={self.get_lr():.3e}")
            if self.config.wall_clock_breakdown:
                self._emit_timer_means()
        self._last_loss = loss
        res.observe_step(loss, finite)
        return loss

    def _train_batch_streamed(self, batch: dict) -> torch.Tensor:
        """ZeRO-Infinity's step: each micro-batch streamed forward and
        backward through the layer walk, then the host step (the JAX
        engine's ``_train_batch_streamed``). The sentinel observes the
        loss only: the update has already run."""
        res = self.resilience
        gas = self.config.gradient_accumulation_steps
        ps = self._param_stream
        with res.guard("train_step"), self._dp_scope():
            losses = [ps.micro_fwd_bwd(mb)
                      for mb in self._split_for_gas(
                          self._device_batch(batch))]
            ps.apply_grads(gas, self.lr_schedule(self.opt_step),
                           self.config.gradient_clipping or None)
            loss = self._dp_mean(torch.stack(losses).mean())
        self.global_step += 1
        self.global_steps += 1
        self.timers(TRAIN_BATCH_TIMER).stop(sync_val=loss)
        self.tput_timer.stop(sync_val=loss)
        if self.global_steps % self.config.steps_per_print == 0:
            log_dist(f"step={self.global_steps} loss={float(loss):.4f}")
            if self.config.wall_clock_breakdown:
                self._emit_timer_means()
        self._last_loss = loss
        res.observe_step(loss, None)
        return loss

    def _no_stream(self) -> None:
        if self._param_stream is not None:
            raise NotImplementedError(
                "offload_param streaming exposes train_batch/eval_batch "
                "only; the imperative forward/backward/step triplet needs "
                "device-resident params")

    @torch.no_grad()
    def eval_batch(self, batch: dict) -> torch.Tensor:
        """The loss of ``batch`` in eval mode (MoE layers route at
        ``eval_capacity_factor``, with no jitter), without gradients; the
        rows split over the data-parallel ranks when they divide."""
        self.module.eval()
        b = self._device_batch(batch)
        rows = self._rows(b)
        split = rows is not b
        mine = self._columns(rows)
        with self._dp_scope(split):
            if self._param_stream is not None:
                loss = self._param_stream.micro_forward(mine)[0].float()
                return self._dp_mean(loss, split)
            if self._zero is not None:
                self._zero.begin_forward()
            loss = self._loss_fn(mine).detach().float()
            if self._zero is not None:
                self._zero.end_forward_no_grad()
        return self._dp_mean(loss, split)

    # --- imperative triplet (reference forward/backward/step) ----------
    def forward(self, batch: dict) -> torch.Tensor:
        """The loss of a micro-batch (``micro x dp`` rows, of which this
        rank keeps its own), with its autograd graph kept for the next
        :meth:`backward` (which may also be given a function of this
        loss)."""
        self._no_stream()
        self.timers(FORWARD_GLOBAL_TIMER).start()
        with self._dp_scope():
            loss = self._train_loss(self._mine(self._device_batch(batch)))
        self.timers(FORWARD_GLOBAL_TIMER).stop()
        self._pending = loss
        return loss

    def backward(self, batch: dict | torch.Tensor | None = None,
                 loss: torch.Tensor | None = None) -> torch.Tensor:
        """Accumulate the gradients of a micro-batch: of ``loss`` (the
        reference's ``backward(loss)``; by default the last forward's), or
        of a fresh forward over ``batch`` when one is given."""
        self._no_stream()
        self.timers(BACKWARD_GLOBAL_TIMER).start()
        if isinstance(batch, torch.Tensor):
            loss, batch = batch, None
        with self._dp_scope():
            if batch is not None:
                loss = self._train_loss(
                    self._mine(self._device_batch(batch)))
            elif loss is None:
                loss = self._pending
                if loss is None:
                    raise ValueError("backward() needs a batch, a loss or a "
                                     "prior forward()")
            self._pending = None
            self._backward(loss)
        self.timers(BACKWARD_GLOBAL_TIMER).stop()
        self._last_loss = self._dp_mean(loss.detach().float())
        return self._last_loss

    def is_gradient_accumulation_boundary(self) -> bool:
        return self._accum_count >= self.config.gradient_accumulation_steps

    def step(self) -> None:
        """Apply the accumulated gradients, scaled by one over their count
        (reference engine.step :2176); a no-op, with a warning, when
        backward has not run. The sentinel observes this path too."""
        self._no_stream()
        if self._accum_grads is None:
            logger.warning("step() called with no accumulated gradients")
            return
        self.timers(STEP_GLOBAL_TIMER).start()
        grads = self._finish_grads(("mul", 1.0 / max(self._accum_count, 1)))
        self._accum_grads, self._accum_count = None, 0
        finite = self._apply_grads(grads)
        self._last_step_finite = finite
        self.global_steps += 1
        self.timers(STEP_GLOBAL_TIMER).stop()
        if self._last_loss is not None:
            self.resilience.observe_step(self._last_loss, finite)

    def zero_grad(self) -> None:
        self._accum_grads = None
        self._accum_count = 0
        self._pending = None

    # ------------------------------------------------------------------
    def _full_master(self) -> list[torch.Tensor]:
        """Every parameter's fp32 master (the parameters themselves in fp32
        training at stage 0), whole: at stages 1-3 gathered, a collective
        every rank joins."""
        if self._zero is None:
            return [m.detach() for m in self._master]
        z = self._zero
        segs = z.full_segments(z.master)
        out = []
        for i, shape in enumerate(z.plan.shapes):
            s, k = z.plan.where[i]
            seg = z.plan.segments[s]
            off, n = seg.offsets[k], seg.numels[k]
            out.append(segs[s][off:off + n].view(shape))
        return out

    def _whole(self, i: int, t: torch.Tensor) -> torch.Tensor:
        """Parameter ``i``'s logical tensor from this rank's slice ``t``:
        gathered over ``tensor`` where the parameter is sharded (a
        collective the tensor ranks join)."""
        spec = self._tp_specs[i]
        if spec is None or "tensor" not in spec:
            return t
        return comm.all_gather(t.contiguous(), "tensor",
                               axis=spec.index("tensor"))

    @property
    def master(self) -> dict:
        """The fp32 master as the JAX-layout nested dict of logical
        tensors (the parameters themselves in fp32 training); at stages
        1-3 gathered from every rank, at tensor > 1 the slices joined."""
        out: dict = {}
        with self._host_state():
            full = self._full_master()
            if self._param_stream is not None:
                full = [m.clone() for m in full]
        full = [self._whole(i, m.detach()) for i, m in enumerate(full)]
        for name, m in zip(self._names, full):
            node = out
            *path, leaf = name.split(".")
            for part in path:
                node = node.setdefault(part, {})
            node[leaf] = m.detach()
        return out

    @property
    def skipped_steps(self) -> int:
        """Steps whose update was skipped (fp16 overflow or the sentinel):
        the optimizer's step only advances on applied updates."""
        return self.global_step - self.opt_step

    def get_lr(self) -> float:
        return self.lr_schedule(self.opt_step)

    def get_loss_scale(self) -> float:
        return self.scaler.scale if self.scaler is not None else 1.0

    def num_parameters(self) -> int:
        """The whole model's count (a tensor rank holds slices of it)."""
        return sum(math.prod(s) for s in self._global_shapes)

    def close(self) -> None:
        """Drop the engine's state so its device memory can be freed."""
        if self._zero is not None:
            self._zero.close()
        elif self._host_opt is not None:
            self._host_opt.close()
        self._master = self._params = []
        self.opt_state = None
        self._accum_grads = self._pending = self._last_loss = None

    def deepspeed_io(self, dataset, batch_size: int | None = None, *,
                     shuffle: bool = True, drop_last: bool = True,
                     collate_fn=None):
        """A global-batch DataLoader for this engine (reference
        ``deepspeed_io``, engine.py:1743): every rank iterates the same
        global batches, as ``train_batch`` takes them."""
        from .data import DataLoader

        return DataLoader(dataset,
                          batch_size if batch_size is not None
                          else self.config.train_batch_size,
                          shuffle=shuffle, seed=self.config.seed,
                          drop_last=drop_last, collate_fn=collate_fn)

    # --- resilience surface (runtime/resilience.py) ---------------------
    @property
    def last_step_rewound(self) -> bool:
        """True when the preceding step ended in a sentinel rewind: the
        training loop re-derives its data position from the restored
        ``global_steps`` (``loader.batch_for_step``)."""
        return self.resilience.last_step_rewound

    @property
    def resilience_counters(self) -> dict:
        """Host-side resilience counters (bad/skipped steps, rewinds,
        preemptions, aborts)."""
        return dict(self.resilience.counters)

    def _emit_counters(self, counters: dict, prefix: str) -> None:
        """Fan resilience/checkpoint counters out to the configured
        monitor/ backends (lazy MonitorMaster; no-op when none enabled)."""
        if self._monitor_master is None:
            from ..monitor import MonitorMaster

            self._monitor_master = MonitorMaster(self.config)
        self._monitor_master.write_counters(counters, self.global_steps,
                                            prefix=prefix)

    #: wall_clock_breakdown timers exported to dashboards (means, ms)
    _BREAKDOWN_TIMERS = (TRAIN_BATCH_TIMER, FORWARD_GLOBAL_TIMER,
                         BACKWARD_GLOBAL_TIMER, STEP_GLOBAL_TIMER,
                         FORWARD_MICRO_TIMER, BACKWARD_MICRO_TIMER,
                         STEP_MICRO_TIMER)

    def _emit_timer_means(self) -> None:
        """Fan the wall_clock_breakdown timer MEANS out through
        ``MonitorMaster.write_counters`` (and telemetry gauges) every
        ``steps_per_print``. Emitted timers reset, so each point is the
        mean over the last print window."""
        means: dict[str, float] = {}
        for name in self._BREAKDOWN_TIMERS:
            if self.timers.has(name):
                t = self.timers.timers[name]
                if t.count:
                    means[f"{name}_ms"] = t.mean() * 1000.0
                    t.reset()
        if not means:
            return
        self._emit_counters(means, "Train/")
        if self._telem.enabled:
            for k, v in means.items():
                self._telem.registry.gauge(f"train_{k}").set(v)

    def _record_train_telemetry(self, batch: dict, step_before: int,
                                skipped_before: int) -> None:
        """Post-step training-health instruments (train_batch wrapper).
        Reads host values only: the step time, the batch's shape and the
        host counters; no device tensor."""
        reg = self._telem.registry
        dt = self.tput_timer.last_step_s
        # without wall_clock_breakdown the timer stops unsynced and dt is
        # the host's enqueue time — rate/MFU gauges computed from it would
        # be confident nonsense; the raw histogram stays
        synced = self.config.wall_clock_breakdown
        if dt:
            reg.histogram(
                "train_step_time_s",
                help="train_batch wall time per step (device-synced only "
                     "under wall_clock_breakdown)").observe(dt)
        tokens, rows, seq = 0, 0, 0
        for leaf in batch.values():
            shape = getattr(leaf, "shape", ())
            if len(shape) >= 2:
                rows, seq = int(shape[0]), int(shape[1])
                tokens = rows * seq
                break
        reg.counter("train_steps_total").inc()
        if tokens:
            reg.counter("train_tokens_total").inc(tokens)
            if dt and synced:
                reg.gauge("train_tokens_per_s").set(tokens / dt)
        tracker = self._mfu_tracker
        if tracker is not None and self._step_flops is None and tokens:
            self._step_flops = model_step_flops(
                self.module, rows, seq,
                dict(zip(self._names, self._global_shapes)))
            if self._step_flops:
                tracker.flops_per_step = self._step_flops
        if tracker is not None and dt and synced:
            rewound = self.resilience.last_step_rewound
            skipped = self.skipped_steps > skipped_before
            tracker.on_step(dt, useful=not (rewound or skipped))
            if rewound:
                # the rewind rolled global_steps back: everything between
                # the restored step and the divergence was wasted work
                tracker.discard_steps(max(0, step_before - self.global_steps))
            m, g = tracker.mfu(), tracker.goodput()
            if m is not None:
                reg.gauge("train_mfu", help="model FLOPs utilization "
                          "(model FLOPs / peak)").set(m)
                reg.gauge("train_goodput", help="MFU counting only steps "
                          "whose update survived (skips/rewinds discounted)"
                          ).set(g)
        self._telem.set_health(global_step=self.global_steps)

    # --- checkpointing (reference engine.py:3109/:2763) -----------------
    def save_checkpoint(self, save_dir: str, tag: str | None = None,
                        client_state: dict | None = None) -> str:
        from .checkpointing import save_checkpoint as _save

        return _save(self, save_dir, tag=tag, client_state=client_state)

    def load_checkpoint(self, load_dir: str, tag: str | None = None) -> dict:
        from .checkpointing import load_checkpoint as _load

        with self.resilience.guard("checkpoint_restore"):
            return _load(self, load_dir, tag=tag)

    def wait_for_checkpoint(self, timeout_s: float | None = None) -> None:
        """Block until an async save has committed; bounded by
        ``timeout_s`` (default ``checkpoint.wait_timeout_s``)."""
        from .checkpointing import wait_for_checkpoint as _wait

        _wait(self, timeout_s=timeout_s)



def initialize(model: torch.nn.Module | None = None,
               config: Config | dict | str | None = None,
               loss_fn: Callable | None = None,
               params: dict | None = None,
               topology: MeshTopology | None = None,
               training_data=None, device=None, **kwargs: Any):
    """Training bring-up (reference deepspeed/__init__.py:69). Returns
    ``(engine, optimizer, dataloader, lr_schedule)``; the dataloader is
    built from ``training_data`` or None. The engine runs on the CUDA device
    unless ``device="cpu"``."""
    cfg = Config.load(config)
    if cfg.hybrid_engine.enabled:
        raise _later("the hybrid engine", "item 7")
    engine = DeepSpeedEngine(config=cfg, model=model, loss_fn=loss_fn,
                             params=params, topology=topology, device=device,
                             **kwargs)
    loader = engine.deepspeed_io(training_data) if training_data is not None \
        else None
    return engine, engine.optimizer, loader, engine.lr_schedule
