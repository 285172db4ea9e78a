"""Weight-only-quantized matrix product with in-tile dequantization (K2).

Counterpart of ``deepspeed_tpu/ops/pallas/quant_matmul.py`` (``QuantLinear``,
``quantize_weight``, ``dequantize_weight``, ``local_matmul``,
``quant_matmul``), with the same codes, scales and numerics:

- codes are int8 or e4m3 ``[K, Np]``, or int4 K-pairs packed into uint8
  ``[K/2, Np]`` (row 2r in the low nibble, row 2r+1 in the high nibble,
  offset 8); N is padded to a multiple of 128 at quantize time and the
  logical N is sliced back off after the product;
- scales are fp32 ``[K/G, Np]``, symmetric per (K-group, column);
- each weight element is dequantized as ``float(code) * scale`` in fp32 and
  rounded to the compute dtype (``x.dtype``) before the product, which
  accumulates in fp32; the output has ``x.dtype``.

On CUDA tensors :func:`quant_matmul` launches the hand-written Hopper
kernel (``csrc/quant_matmul.cu``) or raises; it never dequantizes the
weight with torch ops. On CPU tensors it runs
:func:`quant_matmul_reference`, the plain version. ``counts`` holds the
launches of each route.

:func:`to_e4m3` is the e4m3 cast of the JAX package (round to nearest even,
NaN past the format's range), which ``Tensor.to(torch.float8_e4m3fn)``
alone is not: torch saturates out-of-range values to ±448.
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Any, NamedTuple

import torch

E4M3_MAX = 448.0
#: |x| above this rounds past e4m3's largest finite value (448 + half an
#: ulp): the JAX cast gives NaN there
_E4M3_NAN_ABOVE = 464.0

#: rows up to which the kernel takes its decode form (the JAX package's
#: threshold for its small-M route, ``SMALL_M_XLA``)
SMALL_M_XLA = 16
#: column padding of the codes (the TPU lane width, kept so codes and
#: scales are bit-identical to the JAX package's)
LANE = 128


def to_e4m3(x: torch.Tensor) -> torch.Tensor:
    """``x`` cast to ``torch.float8_e4m3fn`` as JAX casts it: round to
    nearest even inside the range, NaN for NaN, ±inf and any value whose
    magnitude rounds past 448 (above 464)."""
    xf = x.float()
    xf = torch.where(xf.abs() > _E4M3_NAN_ABOVE,
                     torch.full_like(xf, float("nan")), xf)
    return xf.to(torch.float8_e4m3fn)


class QuantLinear(NamedTuple):
    """A weight-only-quantized ``[K, N]`` matrix (the JAX package's
    ``QuantLinear``): ``data`` int8 / e4m3 ``[K, Np]`` or uint8 ``[K/2,
    Np]`` (int4 pairs), ``scale`` fp32 ``[K/G, Np]``; both may carry a
    leading layer dim ``[L, ...]``. ``shape`` is the logical ``(K, N)``,
    ``dtype`` the compute dtype the weight had."""
    data: torch.Tensor
    scale: torch.Tensor
    bits: int | str
    group_size: int
    shape: tuple[int, int]
    dtype: Any

    @property
    def nbytes(self) -> int:
        return (self.data.numel() * self.data.element_size()
                + self.scale.numel() * self.scale.element_size())

    def to(self, device) -> "QuantLinear":
        return self._replace(data=self.data.to(device),
                             scale=self.scale.to(device))


@dataclass
class LaunchCounts:
    """Calls of :func:`quant_matmul` by route: ``kernel`` counts launches
    of the CUDA kernel, ``plain`` the CPU route through the plain
    version."""
    kernel: int = 0
    plain: int = 0

    def reset(self) -> None:
        self.kernel = 0
        self.plain = 0


counts = LaunchCounts()


def _resolve_group(K: int, bits, group_size: int | None) -> int:
    """Group size along K: 512 for int8/fp8 and 128 for int4 by default,
    else ``gcd(K, default)`` when K is not a multiple."""
    if group_size is None:
        group_size = 128 if bits == 4 else 512
        if K % group_size:
            group_size = math.gcd(K, group_size) or K
    if K % group_size:
        raise ValueError(f"K={K} not divisible by group_size={group_size}")
    if bits == 4 and group_size % 2:
        raise ValueError("int4 needs an even group_size (K-pairs pack)")
    return group_size


def _quantize_slabs(w3: torch.Tensor, bits, G: int):
    """Symmetric per-(slab, K-group, column) quantization of ``[n, K, Np]``
    slabs → (codes, scale ``[n, K/G, Np]`` fp32)."""
    n, K, Np = w3.shape
    w32 = w3.float().reshape(n, K // G, G, Np)
    amax = w32.abs().amax(dim=2, keepdim=True)
    one = torch.ones_like(amax)
    if bits == "fp8":
        scale = torch.where(amax > 0, amax / E4M3_MAX, one)
        q = to_e4m3((w32 / scale).reshape(n, K, Np))
        return q, scale[:, :, 0, :]
    qmax = float(2 ** (bits - 1) - 1)
    scale = torch.where(amax > 0, amax / qmax, one)
    q = torch.clamp(torch.round(w32 / scale), -qmax - 1, qmax)
    q = q.reshape(n, K, Np).to(torch.int8)
    if bits == 4:
        lo = (q[:, 0::2] + 8).to(torch.uint8)              # [n, K/2, Np]
        hi = (q[:, 1::2] + 8).to(torch.uint8)
        q = lo | (hi << 4)
    return q, scale[:, :, 0, :]


def _dequantize_slabs(codes: torch.Tensor, scale: torch.Tensor, bits,
                      K: int, G: int) -> torch.Tensor:
    """Inverse of :func:`_quantize_slabs` → fp32 ``[n, K, Np]``."""
    n, Np = codes.shape[0], codes.shape[-1]
    if bits in (8, "fp8"):
        c = codes.float()
    else:
        u = codes.to(torch.int32)
        lo = (u & 15) - 8
        hi = (u >> 4) - 8
        c = torch.stack([lo, hi], dim=2).reshape(n, K, Np).float()
    return (c.reshape(n, K // G, G, Np) * scale[:, :, None, :]
            ).reshape(n, K, Np)


def quantize_weight(w: torch.Tensor, bits: int | str = 8,
                    group_size: int | None = None) -> QuantLinear:
    """Symmetric per-(K-group, column) quantization of a ``[K, N]`` weight
    (8, 4 or "fp8"), N padded to a multiple of 128; codes and scales are
    bit-identical to the JAX package's ``quantize_weight``."""
    if bits not in (4, 8, "fp8"):
        raise ValueError(f"bits must be 4, 8 or 'fp8', got {bits!r}")
    K, N = w.shape
    n_pad = (-N) % LANE
    if n_pad:
        w = torch.nn.functional.pad(w, (0, n_pad))
    G = _resolve_group(K, bits, group_size)
    q, scale = _quantize_slabs(w[None], bits, G)
    return QuantLinear(q[0], scale[0], bits, G, (K, N), w.dtype)


def dequantize_weight(qw: QuantLinear) -> torch.Tensor:
    """The plain inverse: the logical ``[K, N]`` weight in ``qw.dtype``."""
    K, N = qw.shape
    w = _dequantize_slabs(qw.data[None], qw.scale[None], qw.bits, K,
                          qw.group_size)[0]
    return w[:, :N].to(qw.dtype)


def _layer(qw: QuantLinear, layer_index):
    if layer_index is None:
        if qw.data.dim() != 2:
            raise ValueError(f"stacked codes {tuple(qw.data.shape)} need a "
                             f"layer_index")
        return qw.data, qw.scale
    if qw.data.dim() != 3:
        raise ValueError(f"layer_index given but codes are not stacked "
                         f"(data {tuple(qw.data.shape)})")
    li = int(layer_index)
    if not 0 <= li < qw.data.shape[0]:
        raise ValueError(f"layer_index {li} outside [0, "
                         f"{qw.data.shape[0]})")
    return qw.data[li], qw.scale[li]


def quant_matmul_reference(x: torch.Tensor, qw: QuantLinear, *,
                           layer_index=None) -> torch.Tensor:
    """The plain version: f32 codes x f32 group scales, rounded to
    ``x.dtype``, then the product in fp32; ``[M, N]`` in ``x.dtype``."""
    data, scale = _layer(qw, layer_index)
    K, N = qw.shape
    w = _dequantize_slabs(data[None], scale[None], qw.bits, K,
                          qw.group_size)[0].to(x.dtype)
    return (x.float() @ w.float())[:, :N].to(x.dtype)


def quant_matmul(x: torch.Tensor, qw: QuantLinear, *, layer_index=None,
                 small_m_xla: bool | None = None) -> torch.Tensor:
    """``x [M, K] @ dequant(qw) [K, N] -> [M, N]`` in ``x.dtype``.

    ``layer_index`` selects a layer of stacked ``[L, ...]`` codes inside the
    kernel (no per-layer copy). ``small_m_xla`` keeps the JAX package's
    meaning as far as the kernel has one: None picks the kernel's decode
    form for ``M <= SMALL_M_XLA`` rows and its tile form above, False
    forces the tile form, True the decode form where M allows it. Both are
    the same kernel source; no value selects a torch route on the card."""
    if x.dim() != 2:
        raise ValueError(f"x must be [M, K], got {tuple(x.shape)}")
    if x.shape[1] != qw.shape[0]:
        raise ValueError(f"contract mismatch: x {tuple(x.shape)} w "
                         f"{qw.shape}")
    if x.device.type == "cpu":
        counts.plain += 1
        return quant_matmul_reference(x, qw, layer_index=layer_index)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    return _launch_kernel(x, qw, layer_index, small_m_xla)


def local_matmul(x: torch.Tensor, w, *, layer_index=None,
                 small_m_xla: bool | None = None) -> torch.Tensor:
    """2-D product dispatch by weight type: a ``QuantLinear`` goes through
    :func:`quant_matmul`, a plain weight through one fp32-accumulating
    matrix product in ``x.dtype``."""
    if isinstance(w, QuantLinear):
        return quant_matmul(x, w, layer_index=layer_index,
                            small_m_xla=small_m_xla)
    if layer_index is not None and w.dim() == 3:
        w = w[int(layer_index)]
    return x @ w.to(x.dtype)


# ---------------------------------------------------------------------------
# the CUDA kernel's launch
# ---------------------------------------------------------------------------

_FMT = {8: 0, 4: 1, "fp8": 2}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_CODE_DTYPES = {8: torch.int8, 4: torch.uint8, "fp8": torch.float8_e4m3fn}
#: floats of the decode form's x chunk in shared memory (32 KB)
_X_CHUNK_FLOATS = 8192
#: decode-form blocks per SM the K split aims for: enough code loads in
#: flight to cover the memory latency
DECODE_BLOCKS_PER_SM = 6


def decode_form_split(M: int, K: int, Np: int, sms: int):
    """Launch geometry of the kernel's decode form: (row capacity MR, K rows
    per block KB, blocks along K). A block owns 128 columns and KB rows of
    K; blocks along K are added until ``DECODE_BLOCKS_PER_SM`` blocks can
    sit on each SM, and the x chunk ``[MR, KB]`` fits 32 KB of shared
    memory."""
    mr = 1
    while mr < M:
        mr *= 2
    kb_cap = _X_CHUNK_FLOATS // mr
    strips = Np // LANE
    splits = max(-(-DECODE_BLOCKS_PER_SM * sms // strips), -(-K // kb_cap),
                 1)
    kb = -(-K // splits)
    kb += (-kb) % 8
    return mr, kb, -(-K // kb)


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def _launch_kernel(x, qw: QuantLinear, layer_index, small_m_xla):
    from . import kernels

    M, K = x.shape
    if x.dtype not in _DTYPES:
        raise ValueError(f"kernel dtype must be float32 or bfloat16, got "
                         f"{x.dtype}")
    if qw.bits not in _FMT:
        raise ValueError(f"bits must be 4, 8 or 'fp8', got {qw.bits!r}")
    dev = x.device
    data, scale = qw.data, qw.scale
    stacked = layer_index is not None
    if stacked != (data.dim() == 3):
        raise ValueError(f"codes {tuple(data.shape)} and layer_index "
                         f"{layer_index} disagree")
    Np = data.shape[-1]
    G = qw.group_size
    rows = K // 2 if qw.bits == 4 else K
    if (data.shape[-2] != rows or Np % LANE or K % G
            or tuple(scale.shape[-2:]) != (K // G, Np)):
        raise ValueError(f"codes {tuple(data.shape)} / scales "
                         f"{tuple(scale.shape)} do not fit K={K}, G={G}")
    if data.dtype != _CODE_DTYPES[qw.bits] or scale.dtype != torch.float32:
        raise ValueError(f"codes {data.dtype} / scales {scale.dtype} do not "
                         f"fit bits={qw.bits!r}")
    for name, t in (("x", x), ("codes", data), ("scale", scale)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, x on {dev}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte "
                             f"aligned")
    li, cstride, sstride = 0, 0, 0
    if stacked:
        li = int(layer_index)
        if not 0 <= li < data.shape[0]:
            raise ValueError(f"layer_index {li} outside [0, "
                             f"{data.shape[0]})")
        cstride, sstride = data[0].numel(), scale[0].numel()
    out = torch.empty((M, Np), dtype=x.dtype, device=dev)
    small = M <= SMALL_M_XLA and small_m_xla is not False
    mr = kb = splits = 0
    ws = out
    if small and M > 0:
        mr, kb, splits = decode_form_split(
            M, K, Np, _sm_count(dev.index if dev.index is not None
                                else torch.cuda.current_device()))
        if splits > 1:
            ws = torch.empty((splits, M, Np), dtype=torch.float32,
                             device=dev)
    lib = kernels.load("quant_matmul")
    err = lib.ds_quant_matmul(
        x.data_ptr(), data.data_ptr(), scale.data_ptr(), out.data_ptr(),
        ws.data_ptr(), M, K, Np, G, _FMT[qw.bits], _DTYPES[x.dtype], li,
        cstride, sstride, int(small), mr, kb, splits,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"quant-matmul kernel launch failed: CUDA error "
                           f"{err}")
    counts.kernel += 1
    N = qw.shape[1]
    return out if N == Np else out[:, :N]
