"""The training engine of one process (ZeRO stage 0).

Counterpart of ``deepspeed_tpu/runtime/engine.py`` (``DeepSpeedEngine``,
``initialize``) for one process on one device. The JAX engine compiles its
whole step — the micro-batch scan of forward and backward, gradient
accumulation, the update — into one program; this one runs the same steps
eagerly, in the same order and precision:

- state: the model's parameters in the compute dtype (bf16 / fp16, or fp32
  when neither is enabled) and, in mixed precision, an fp32 master copy
  with the optimizer's fp32 moments; an fp16 run adds the dynamic loss
  scaler (``runtime/fp16.py``);
- ``train_batch(batch)``: the global batch split into
  ``gradient_accumulation_steps`` micro-batches; each one's gradients (of
  the scaled loss under fp16) cast to fp32, unscaled and summed; loss and
  gradients divided by the accumulation count; clipping by global norm; a
  non-finite step skipped (the fp16 scaler, and the resilience sentinel,
  on by default); the optimizer on the master; the parameters cast back;
- the ``forward`` / ``backward`` / ``step`` triplet with
  ``is_gradient_accumulation_boundary``; ``eval_batch``; ``zero_grad``;
  ``skipped_steps``, ``get_lr``, ``get_loss_scale``, ``num_parameters``;
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

It runs on the CUDA device unless ``device="cpu"`` is given. Every feature
that a later part of the port brings raises NotImplementedError when it is
configured (:func:`check_ported`): ZeRO stages 1-3, optimizer and parameter
offload, ZeRO++ (quantized weights / gradients, hpZ, MiCS), the 1-bit
optimizers, curriculum learning and the other data-efficiency routes, the
hybrid engine, the comms logger, monitor backends, telemetry, the flops
profiler, checkpoints (with their resharding), and the resilience features
that need checkpoints or watch the step from outside (rewind directory,
loss-spike detection, the hang watchdog, fault injection, preemption
signals other than the default SIGTERM, on which the process simply ends
since there is nothing to save).
Model compression runs outside the config (a compression manager the JAX
engine reads when set) and is not ported either.
"""
from __future__ import annotations

import copy
import dataclasses
from functools import partial
from typing import Any, Callable

import numpy as np
import torch

from ..accelerator import get_device
from ..config import Config
from ..models.loss import lm_loss_fn
from ..ops.optimizers import OptState, Optimizer, build_optimizer
from ..parallel.topology import MeshTopology
from ..utils.logging import log_dist, logger
from ..utils.timer import (
    BACKWARD_GLOBAL_TIMER,
    FORWARD_GLOBAL_TIMER,
    STEP_GLOBAL_TIMER,
    TRAIN_BATCH_TIMER,
    SynchronizedWallClockTimer,
    ThroughputTimer,
)
from . import fp16 as fp16_mod
from .lr_schedules import Schedule, build_scheduler, constant_lr

PART_B = "training part B (ZeRO over torch.distributed, checkpoints with " \
         "resharding, the resilience rewind; ROADMAP queue 1, item 2)"


class DivergenceError(RuntimeError):
    """The resilience sentinel saw ``max_consecutive_bad`` bad steps in a
    row and there is no checkpoint to rewind to."""


def _later(feature: str, part: str = PART_B) -> NotImplementedError:
    return NotImplementedError(f"{feature} is ported with {part}")


def check_ported(config: Config) -> None:
    """Raise NotImplementedError for every configured feature that a later
    part of the port brings (see the module docstring)."""
    z = config.zero_optimization
    if z.stage != 0:
        raise _later(f"ZeRO stage {z.stage}")
    if z.offload_optimizer.device != "none" or z.offload_param.device != "none":
        raise _later("optimizer / parameter offload",
                     "ZeRO-Offload (ROADMAP queue 1, item 6)")
    if (z.zero_quantized_weights or z.zero_quantized_gradients
            or z.zero_hpz_partition_size > 1 or z.mics_shard_size > 0):
        raise _later("ZeRO++ (qwZ, qgZ, hpZ) and MiCS")
    if config.data_efficiency.enabled:
        raise _later("data efficiency (curriculum learning, random-LTD)",
                     "a later slice")
    if config.hybrid_engine.enabled:
        raise _later("the hybrid engine", "a later slice")
    if config.comms_logger.enabled:
        raise _later("the comms logger")
    for name in ("tensorboard", "csv_monitor", "wandb", "comet", "prometheus"):
        if getattr(config, name).enabled:
            raise _later(f"the {name} monitor backend", "a later slice")
    if config.telemetry.enabled:
        raise _later("telemetry", "a later slice")
    if config.flops_profiler.enabled:
        raise _later("the flops profiler", "a later slice")
    r = config.resilience
    if (r.rewind_dir or r.loss_spike_factor > 0 or r.watchdog_timeout_s > 0
            or r.fault_injection
            or list(r.preemption_signals) not in ([], ["SIGTERM"])):
        raise _later("resilience's rewind, spike detection, watchdog, fault "
                     "injection and preemption saves (they need checkpoints)")


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
        self.config = config
        self.device = get_device(device)
        self.topology = topology if topology is not None \
            else MeshTopology(config.mesh)
        config.resolve_batch_terms(self.topology.dp_world_size)

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

        self._init_state(params)
        self._gating = torch.Generator()
        self._accum_grads: list[torch.Tensor] | None = None
        self._accum_count = 0
        self._last_loss: torch.Tensor | None = None
        self._pending: torch.Tensor | None = None
        self._bad_streak = 0
        self.global_steps = 0
        logger.info(
            f"engine up: zero_stage=0 device={self.device} "
            f"dtype={'fp16' if self.fp16_enabled else 'bf16' if self.bf16_enabled else 'fp32'} "
            f"micro_bs={config.train_micro_batch_size_per_gpu} "
            f"gas={config.gradient_accumulation_steps} "
            f"global_bs={config.train_batch_size}")

    # ------------------------------------------------------------------
    def _init_state(self, params: dict | None) -> None:
        """Master, parameters and optimizer state. The model's own fp32
        values become the master (no copy); its parameters are recast to
        the compute dtype in place and their gradients turned on."""
        model = self.module.to(self.device)
        self._names = [n for n, _ in model.named_parameters()]
        self._params = [p for _, p in model.named_parameters()]
        for p in self._params:
            p.data = p.data.float()
        if params is not None:
            from ..inference.weights import load_jax_params

            load_jax_params(model, params)
        if self.mixed_precision:
            self._master = []
            for p in self._params:
                self._master.append(p.data)
                p.data = p.data.to(self.compute_dtype)
        else:
            self._master = self._params
        for p in self._params:
            p.requires_grad_(True)
        with torch.no_grad():
            self.opt_state: OptState = self.optimizer.init(
                [m.detach() for m in self._master])
        self.scaler = fp16_mod.init_scaler(self.config.fp16) \
            if self.fp16_enabled else None
        self.global_step = 0        # steps taken, applied or skipped

    # ------------------------------------------------------------------
    def _to_device(self, x) -> torch.Tensor:
        t = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
        if not t.is_floating_point():
            t = t.long()
        return t.to(self.device)

    def _device_batch(self, batch: dict) -> dict:
        return {k: self._to_device(v) for k, v in batch.items()}

    def _split_for_gas(self, batch: dict) -> list[dict]:
        gas = self.config.gradient_accumulation_steps
        B = self.config.train_batch_size
        for k, v in batch.items():
            if v.shape[0] != B:
                raise ValueError(f"train_batch expects global batch dim {B}, "
                                 f"got {v.shape[0]} for '{k}'")
        micro = B // gas
        return [{k: v[g * micro:(g + 1) * micro] for k, v in batch.items()}
                for g in range(gas)]

    def _train_loss(self, batch: dict) -> torch.Tensor:
        """The loss of a device micro-batch in train mode, with the step's
        ``_gating_seed``: one seed a step, shared by its micro-batches (the
        JAX engine folds one key per step), from a generator seeded with
        the engine's seed and the step."""
        self.module.train()
        self._gating.manual_seed(self.config.seed * 1_000_003
                                 + self.global_step)
        seed = int(torch.randint(0, 2 ** 62, (), generator=self._gating))
        return self._loss_fn({**batch, "_gating_seed": seed})

    def _backward(self, loss: torch.Tensor) -> None:
        """Add the gradients of ``loss`` (of the scaled loss under fp16,
        then unscaled), as fp32, to the running sums, one parameter at a
        time, so no second set of fp32 gradients is ever held; the
        parameters' ``.grad`` are cleared."""
        for p in self._params:
            p.grad = None
        scaled = loss * self.scaler.scale if self.scaler is not None else loss
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

    def _global_norm(self, grads) -> torch.Tensor:
        return torch.sqrt(torch.stack(
            [torch.sum(torch.square(g.float())) for g in grads]).sum())

    def _apply_grads(self, grads: list[torch.Tensor],
                     loss_finite: torch.Tensor | None = None) -> bool:
        """Clip, check, update the master and recast the parameters; the
        step counter advances whether or not the update ran."""
        cfg = self.config
        lr = self.lr_schedule(self.opt_state.step)
        if cfg.gradient_clipping:
            norm = self._global_norm(grads)
            clip = torch.clamp(cfg.gradient_clipping / (norm + 1e-6), max=1.0)
            for g in grads:
                g.mul_(clip)
        finite = True
        if self.scaler is not None or cfg.resilience.sentinel:
            flag = fp16_mod.grads_finite(grads)
            if loss_finite is not None:
                flag = flag & loss_finite.to(flag.device)
            finite = bool(flag)
        if finite:
            self.opt_state = self.optimizer.update(grads, self.opt_state,
                                                   self._master, lr=lr)
            if self.mixed_precision:
                with torch.no_grad():
                    for p, m in zip(self._params, self._master):
                        p.copy_(m)
        if self.scaler is not None:
            self.scaler = fp16_mod.update_scaler(self.scaler, finite,
                                                 cfg.fp16)
        self.global_step += 1
        return finite

    def _observe(self, loss: torch.Tensor, finite: bool) -> None:
        """The divergence sentinel's host half: a streak of
        ``max_consecutive_bad`` non-finite steps (not counted under the fp16
        scaler, which owns overflow recovery) would rewind to a checkpoint;
        without checkpoints it raises, as the JAX engine does when it has
        none."""
        r = self.config.resilience
        if not r.sentinel:
            return
        if finite and bool(torch.isfinite(loss)):
            self._bad_streak = 0
            return
        if self.scaler is not None:
            return
        self._bad_streak += 1
        logger.warning(f"sentinel: bad step at {self.global_steps} "
                       f"(loss={float(loss)}); streak {self._bad_streak}/"
                       f"{r.max_consecutive_bad}")
        if self._bad_streak >= r.max_consecutive_bad:
            raise DivergenceError(
                f"training diverged at step {self.global_steps}: "
                f"{self._bad_streak} consecutive bad steps and no checkpoint "
                f"to rewind to (checkpoints are ported with {PART_B})")

    # ------------------------------------------------------------------
    # public API
    def train_batch(self, batch: dict) -> torch.Tensor:
        """One full training step over a global batch (each leaf
        ``[train_batch_size, ...]``). Returns the mean micro-batch loss, a
        0-d fp32 tensor on the engine's device."""
        self.tput_timer.start()
        self.timers(TRAIN_BATCH_TIMER).start()
        gas = self.config.gradient_accumulation_steps
        self._accum_grads, self._accum_count = None, 0
        loss_sum = torch.zeros((), dtype=torch.float32, device=self.device)
        for mb in self._split_for_gas(self._device_batch(batch)):
            loss = self._train_loss(mb)
            self._backward(loss)
            loss_sum = loss_sum + loss.detach().float()
        grads, self._accum_grads, self._accum_count = \
            self._accum_grads, None, 0
        for g in grads:
            g.div_(gas)
        loss = loss_sum / gas
        finite = self._apply_grads(grads, torch.isfinite(loss))
        self.global_steps += 1
        sync = loss if self.config.wall_clock_breakdown else None
        self.timers(TRAIN_BATCH_TIMER).stop(sync_val=sync)
        self.tput_timer.stop(sync_val=sync)
        if self.global_steps % self.config.steps_per_print == 0:
            log_dist(f"step={self.global_steps} loss={float(loss):.4f} "
                     f"lr={self.get_lr():.3e}")
        self._last_loss = loss
        self._observe(loss, finite)
        return loss

    @torch.no_grad()
    def eval_batch(self, batch: dict) -> torch.Tensor:
        """The loss of ``batch`` in eval mode (MoE layers route at
        ``eval_capacity_factor``, with no jitter), without gradients."""
        self.module.eval()
        return self._loss_fn(self._device_batch(batch)).detach().float()

    # --- imperative triplet (reference forward/backward/step) ----------
    def forward(self, batch: dict) -> torch.Tensor:
        """The loss of a micro-batch, with its autograd graph kept for the
        next :meth:`backward` (which may also be given a function of this
        loss)."""
        self.timers(FORWARD_GLOBAL_TIMER).start()
        loss = self._train_loss(self._device_batch(batch))
        self.timers(FORWARD_GLOBAL_TIMER).stop()
        self._pending = loss
        return loss

    def backward(self, batch: dict | torch.Tensor | None = None,
                 loss: torch.Tensor | None = None) -> torch.Tensor:
        """Accumulate the gradients of a micro-batch: of ``loss`` (the
        reference's ``backward(loss)``; by default the last forward's), or
        of a fresh forward over ``batch`` when one is given."""
        self.timers(BACKWARD_GLOBAL_TIMER).start()
        if isinstance(batch, torch.Tensor):
            loss, batch = batch, None
        if batch is not None:
            loss = self._train_loss(self._device_batch(batch))
        elif loss is None:
            loss = self._pending
            if loss is None:
                raise ValueError("backward() needs a batch, a loss or a "
                                 "prior forward()")
        self._pending = None
        self._backward(loss)
        self.timers(BACKWARD_GLOBAL_TIMER).stop()
        self._last_loss = loss.detach().float()
        return self._last_loss

    def is_gradient_accumulation_boundary(self) -> bool:
        return self._accum_count >= self.config.gradient_accumulation_steps

    def step(self) -> None:
        """Apply the accumulated gradients, scaled by one over their count
        (reference engine.step :2176); a no-op, with a warning, when
        backward has not run."""
        if self._accum_grads is None:
            logger.warning("step() called with no accumulated gradients")
            return
        self.timers(STEP_GLOBAL_TIMER).start()
        scale = 1.0 / max(self._accum_count, 1)
        grads = self._accum_grads
        for g in grads:
            g.mul_(scale)
        self._accum_grads, self._accum_count = None, 0
        finite = self._apply_grads(grads)
        self._last_step_finite = finite
        self.global_steps += 1
        self.timers(STEP_GLOBAL_TIMER).stop()
        if self._last_loss is not None:
            self._observe(self._last_loss, finite)

    def zero_grad(self) -> None:
        self._accum_grads = None
        self._accum_count = 0
        self._pending = None

    # ------------------------------------------------------------------
    @property
    def master(self) -> dict:
        """The fp32 master as the JAX-layout nested dict (the parameters
        themselves in fp32 training)."""
        out: dict = {}
        for name, m in zip(self._names, self._master):
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
        return self.global_step - self.opt_state.step

    def get_lr(self) -> float:
        return self.lr_schedule(self.opt_state.step)

    def get_loss_scale(self) -> float:
        return self.scaler.scale if self.scaler is not None else 1.0

    def num_parameters(self) -> int:
        return sum(p.numel() for p in self._params)

    def close(self) -> None:
        """Drop the engine's state so its device memory can be freed."""
        self._master = self._params = []
        self.opt_state = None
        self._accum_grads = self._pending = self._last_loss = None

    def deepspeed_io(self, dataset, batch_size: int | None = None, *,
                     shuffle: bool = True, drop_last: bool = True,
                     collate_fn=None):
        """A global-batch DataLoader for this engine (reference
        ``deepspeed_io``, engine.py:1743)."""
        from .data import DataLoader

        return DataLoader(dataset,
                          batch_size if batch_size is not None
                          else self.config.train_batch_size,
                          shuffle=shuffle, seed=self.config.seed,
                          drop_last=drop_last, collate_fn=collate_fn)

    def save_checkpoint(self, *args, **kwargs):
        raise _later("checkpoints")

    def load_checkpoint(self, *args, **kwargs):
        raise _later("checkpoints")


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
        raise _later("the hybrid engine", "a later slice")
    engine = DeepSpeedEngine(config=cfg, model=model, loss_fn=loss_fn,
                             params=params, topology=topology, device=device,
                             **kwargs)
    loader = engine.deepspeed_io(training_data) if training_data is not None \
        else None
    return engine, engine.optimizer, loader, engine.lr_schedule
