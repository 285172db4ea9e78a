"""Host optimizers over flat fp32 CPU tensors, for offloaded optimizer state.

Counterpart of ``deepspeed_tpu/ops/cpu_optimizer.py`` (reference
``deepspeed/ops/adam/cpu_adam.py:13`` ``DeepSpeedCPUAdam``, ops/adagrad,
ops/lion). The fp32 master and the moments stay in host memory (or on
NVMe); each step runs the host library's SIMD update
(``csrc/cpu_adam.cpp``, built by :mod:`.native`).

Beside each native step stands a plain torch version with the C++ order
of operations (not ``FusedAdam``'s): ``denom = sqrt(v) * (1/sqrt(bc2)) +
eps``, ``p -= (lr/bc1) * m/denom``, and the decoupled decay not bias
corrected (``cpu_adam.cpp:40-65``). It runs only where the caller asks
for it (``native=False``); the engine always runs the native step.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .native import load_library


@dataclass
class HostOptState:
    """One flat piece of host state: the fp32 master and the moments its
    optimizer keeps. The buffers are None while they are spilled to NVMe;
    ``numel`` always describes the piece."""
    master: torch.Tensor | None
    mu: torch.Tensor | None = None
    nu: torch.Tensor | None = None
    numel: int = 0

    def buffers(self) -> dict[str, torch.Tensor]:
        return {k: v for k, v in (("master", self.master), ("mu", self.mu),
                                  ("nu", self.nu)) if v is not None}

    def drop_buffers(self) -> None:
        self.master = self.mu = self.nu = None


def _flat(t) -> torch.Tensor:
    if isinstance(t, np.ndarray):
        t = torch.from_numpy(np.ascontiguousarray(t))
    t = t.reshape(-1)
    if t.dtype != torch.float32 or t.device.type != "cpu" \
            or not t.is_contiguous():
        raise ValueError("host optimizer buffers are contiguous fp32 CPU "
                         "tensors")
    return t


class CPUOptimizer:
    """A host optimizer; subclasses name their moment slots and the step."""

    SLOTS: tuple[str, ...] = ()

    def __init__(self, lr: float = 1e-3, weight_decay: float = 0.0,
                 native: bool = True, **kw):
        self.lr = float(lr)
        self.weight_decay = float(weight_decay)
        self.native = bool(native)
        self._lib = load_library() if self.native else None

    def init_state(self, master: torch.Tensor) -> HostOptState:
        """State over ``master`` (a flat fp32 CPU tensor, taken as is) with
        zero moments."""
        m = _flat(master)
        st = HostOptState(master=m, numel=m.numel())
        for slot in self.SLOTS:
            setattr(st, slot, torch.zeros_like(m))
        return st

    def step(self, st: HostOptState, grad, step: int,
             lr: float | None = None) -> None:
        """Update ``st`` in place from a flat fp32 gradient."""
        lr = self.lr if lr is None else float(lr)
        g = _flat(grad)
        if g.numel() != st.numel:
            raise ValueError(f"gradient of {g.numel()} elements for state "
                             f"of {st.numel}")
        (self._native if self.native else self._plain)(st, g, int(step), lr)

    def _native(self, st, g, step, lr):
        raise NotImplementedError

    def _plain(self, st, g, step, lr):
        raise NotImplementedError


def _f32(x) -> float:
    return float(np.float32(x))


class CPUAdam(CPUOptimizer):
    """reference ops/adam/cpu_adam.py:13 (``adamw_mode=True`` default)."""

    SLOTS = ("mu", "nu")

    def __init__(self, lr: float = 1e-3, betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0, adamw_mode: bool = True,
                 bias_correction: bool = True, native: bool = True, **kw):
        super().__init__(lr=lr, weight_decay=weight_decay, native=native)
        self.beta1, self.beta2 = float(betas[0]), float(betas[1])
        self.eps = float(eps)
        self.adamw_mode = bool(adamw_mode)
        self.bias_correction = bool(bias_correction)

    def _native(self, st, g, step, lr):
        self._lib.dstpu_adam_step(
            st.master.data_ptr(), st.mu.data_ptr(), st.nu.data_ptr(),
            g.data_ptr(), st.numel, lr, self.beta1, self.beta2, self.eps,
            self.weight_decay, step, int(self.adamw_mode),
            int(self.bias_correction))

    def _plain(self, st, g, step, lr):
        b1, b2 = np.float32(self.beta1), np.float32(self.beta2)
        bc1 = bc2 = np.float32(1.0)
        if self.bias_correction:
            bc1 = np.float32(1.0) - b1 ** np.float32(step)
            bc2 = np.float32(1.0) - b2 ** np.float32(step)
        lr32, wd = np.float32(lr), np.float32(self.weight_decay)
        step_size = float(lr32 / bc1)
        inv_sqrt_bc2 = float(np.float32(1.0) / np.sqrt(bc2))
        p, m, v = st.master, st.mu, st.nu
        if not self.adamw_mode and wd != 0:
            g = g + float(wd) * p
        m.mul_(float(b1)).add_(_f32(1.0 - b1) * g)
        v.mul_(float(b2)).add_(_f32(1.0 - b2) * g * g)
        denom = torch.sqrt(v) * inv_sqrt_bc2 + _f32(self.eps)
        if self.adamw_mode and wd != 0:
            p.sub_(float(lr32 * wd) * p)
        p.sub_(step_size * (m / denom))


class CPUAdagrad(CPUOptimizer):
    """reference ops/adagrad/cpu_adagrad.py."""

    SLOTS = ("nu",)

    def __init__(self, lr: float = 1e-2, eps: float = 1e-10,
                 weight_decay: float = 0.0, native: bool = True, **kw):
        super().__init__(lr=lr, weight_decay=weight_decay, native=native)
        self.eps = float(eps)

    def _native(self, st, g, step, lr):
        self._lib.dstpu_adagrad_step(
            st.master.data_ptr(), st.nu.data_ptr(), g.data_ptr(), st.numel,
            lr, self.eps, self.weight_decay)

    def _plain(self, st, g, step, lr):
        p, h = st.master, st.nu
        if self.weight_decay != 0:
            g = g + _f32(self.weight_decay) * p
        h.add_(g * g)
        p.sub_(_f32(lr) * g / (torch.sqrt(h) + _f32(self.eps)))


class CPULion(CPUOptimizer):
    """reference ops/lion (csrc/lion): sign update, decoupled decay."""

    SLOTS = ("mu",)

    def __init__(self, lr: float = 1e-4, betas=(0.9, 0.99),
                 weight_decay: float = 0.0, native: bool = True, **kw):
        super().__init__(lr=lr, weight_decay=weight_decay, native=native)
        self.beta1, self.beta2 = float(betas[0]), float(betas[1])

    def _native(self, st, g, step, lr):
        self._lib.dstpu_lion_step(
            st.master.data_ptr(), st.mu.data_ptr(), g.data_ptr(), st.numel,
            lr, self.beta1, self.beta2, self.weight_decay)

    def _plain(self, st, g, step, lr):
        p, m = st.master, st.mu
        c = _f32(self.beta1) * m + _f32(1.0 - np.float32(self.beta1)) * g
        update = torch.sign(c)
        if self.weight_decay != 0:
            update = update + _f32(self.weight_decay) * p
        p.sub_(_f32(lr) * update)
        m.mul_(_f32(self.beta2)).add_(_f32(1.0 - np.float32(self.beta2)) * g)


CPU_OPTIMIZERS = {
    "adam": CPUAdam,
    "adamw": CPUAdam,
    "adagrad": CPUAdagrad,
    "lion": CPULion,
}


def build_cpu_optimizer(name: str, params: dict,
                        native: bool = True) -> CPUOptimizer:
    """The host optimizer for a DeepSpeed optimizer section: ``adam_w_mode``
    maps to ``adamw_mode``, and "adam" defaults to L2 mode, as the JAX
    package maps them."""
    key = name.lower()
    if key not in CPU_OPTIMIZERS:
        raise ValueError(
            f"offloaded optimizer '{name}' unsupported; one of "
            f"{sorted(set(CPU_OPTIMIZERS))}")
    kw = dict(params)
    kw.pop("torch_adam", None)
    if "adam_w_mode" in kw:
        kw["adamw_mode"] = bool(kw.pop("adam_w_mode"))
    if key == "adam":
        kw.setdefault("adamw_mode", False)
    return CPU_OPTIMIZERS[key](native=native, **kw)


def f32_to_bf16(src: torch.Tensor, dst: torch.Tensor) -> None:
    """``dst`` (bf16, CPU, contiguous) = ``src`` (fp32) rounded to nearest
    even by the host library, on its OpenMP threads."""
    if src.numel() != dst.numel() or dst.dtype != torch.bfloat16 \
            or dst.device.type != "cpu" or not dst.is_contiguous():
        raise ValueError("f32_to_bf16 needs a contiguous bf16 CPU "
                         "destination of the source's size")
    load_library().dstpu_f32_to_bf16(_flat(src).data_ptr(), dst.data_ptr(),
                                     src.numel())
