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
launches of each route. :func:`kernel_route` names the card's kernels from
x's dtype: bf16 takes the wgmma route (``out^T = W^T x^T``: the weight's
columns on wgmma's 64-row M, the tokens on its N; codes widened into bf16
tiles in shared memory), planned by :func:`tc_split` (K2: a block's token
columns and the K split) and :func:`grouped_run_tiles` /
:func:`grouped_runs` (K3: windows of 32-row sub-tiles, each run of one
expert's sub-tiles one product); fp32 keeps the CUDA-core FMA kernels (the
parity route).

:func:`to_e4m3` is the e4m3 cast of the JAX package (round to nearest even,
NaN past the format's range), which ``Tensor.to(torch.float8_e4m3fn)``
alone is not: torch saturates out-of-range values to ±448.
"""
from __future__ import annotations

import dataclasses
import functools
import math
import weakref
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
    """Calls of a kernel wrapper (:func:`quant_matmul`,
    :func:`quant_grouped_matmul`, ``grouped_matmul.grouped_matmul``) by
    route: ``kernel`` counts launches of the CUDA kernel, ``plain`` the CPU
    route through the plain version."""
    kernel: int = 0
    plain: int = 0

    def reset(self) -> None:
        for f in dataclasses.fields(self):
            setattr(self, f.name, 0)


@dataclass
class QuantCounts(LaunchCounts):
    """K2's or K3's calls by route; ``kernel_tc`` counts the kernel launches
    (already in ``kernel``) that took the wgmma route."""
    kernel_tc: int = 0


#: launches of :func:`quant_matmul` by route (K2)
counts = QuantCounts()


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


def _quantize_slabs(w3: torch.Tensor, bits, G: int, shard: bool = False):
    """Symmetric per-(slab, K-group, column) quantization of ``[n, K, Np]``
    slabs → (codes, scale ``[n, K/G, Np]`` fp32). ``shard``: the scale as
    the JAX engine's per-shard quantization computes it, inside a jitted
    ``shard_map``, where XLA turns the division by the constant qmax into
    a product with its fp32 reciprocal (one ulp apart from the division
    for some values)."""
    n, K, Np = w3.shape
    w32 = w3.float().reshape(n, K // G, G, Np)
    amax = w32.abs().amax(dim=2, keepdim=True)
    one = torch.ones_like(amax)

    def over(qmax: float):
        if shard:
            return amax * torch.tensor(1.0 / qmax, dtype=torch.float32)
        return amax / qmax

    if bits == "fp8":
        scale = torch.where(amax > 0, over(E4M3_MAX), one)
        q = to_e4m3((w32 / scale).reshape(n, K, Np))
        return q, scale[:, :, 0, :]
    qmax = float(2 ** (bits - 1) - 1)
    scale = torch.where(amax > 0, over(qmax), one)
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
                    group_size: int | None = None, *,
                    shard: bool = False) -> QuantLinear:
    """Symmetric per-(K-group, column) quantization of a ``[K, N]`` weight
    (8, 4 or "fp8"), N padded to a multiple of 128; codes and scales are
    bit-identical to the JAX package's ``quantize_weight``. ``shard=True``
    quantizes one tensor-parallel shard (the groups resolved on its own K,
    its own padding) bit for bit as the JAX engine's jitted
    ``shard_map(quantize_weight)`` does (see :func:`_quantize_slabs`)."""
    if bits not in (4, 8, "fp8"):
        raise ValueError(f"bits must be 4, 8 or 'fp8', got {bits!r}")
    K, N = w.shape
    n_pad = (-N) % LANE
    if n_pad:
        w = torch.nn.functional.pad(w, (0, n_pad))
    G = _resolve_group(K, bits, group_size)
    q, scale = _quantize_slabs(w[None], bits, G, shard)
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
    meaning as far as the fp32 kernels have one: None picks their decode
    form for ``M <= SMALL_M_XLA`` rows and their tile form above, False
    forces the tile form, True the decode form where M allows it. bf16
    takes one kernel whatever its value (the wgmma route sizes its blocks
    from M, :func:`tc_split`); no value selects a torch route on the
    card."""
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


def kernel_route(dtype: torch.dtype, bits) -> str:
    """The card's K2 / K3 kernels for x of ``dtype`` and codes of ``bits``:
    ``"wgmma"`` (bf16: the tensor-core route, every code format) or
    ``"fma"`` (fp32: the CUDA-core kernels, the parity route)."""
    if bits not in _FMT:
        raise ValueError(f"bits must be 4, 8 or 'fp8', got {bits!r}")
    if dtype == torch.bfloat16:
        return "wgmma"
    if dtype == torch.float32:
        return "fma"
    raise ValueError(f"kernel dtype must be float32 or bfloat16, got "
                     f"{dtype}")


#: a wgmma-route block's token columns (wgmma's N): the smallest that holds
#: M, up to 256 (larger M takes several windows of 256)
TC_TOKENS = (8, 16, 32, 64, 128, 256)
#: weight columns and k rows of a wgmma-route block and stage
TC_COLS, TC_DEPTH = 128, 64
def tc_blocks_per_sm(bn: int) -> int:
    """wgmma-route blocks an SM holds (the kernel's launch bounds): two at
    BN <= 64, one above."""
    return 2 if bn <= 64 else 1


#: k stages a split of K keeps at least
TC_MIN_SPLIT_STAGES = 4


def tc_tokens(M: int) -> int:
    """A wgmma-route block's token columns for M rows."""
    return next(bn for bn in TC_TOKENS if bn >= min(M, TC_TOKENS[-1]))


@functools.lru_cache(maxsize=4096)
def tc_split(M: int, K: int, Np: int, sms: int) -> tuple[int, int]:
    """(token columns BN, blocks along K) of a K2 launch on the wgmma
    route. K is split only when one window holds the M rows (M <= BN) and
    the column blocks leave room on the card (:func:`tc_blocks_per_sm`
    blocks an SM): into as many splits as fill it, each at least
    ``TC_MIN_SPLIT_STAGES`` stages of 64 k, and no empty split. The
    kernel's last block of a column range sums the splits in order."""
    bn = tc_tokens(M)
    blocks = Np // TC_COLS
    slots = tc_blocks_per_sm(bn) * sms
    if M > bn or blocks >= slots:
        return bn, 1
    nk = -(-K // TC_DEPTH)
    splits = min(slots // blocks, nk // TC_MIN_SPLIT_STAGES)
    if splits <= 1:
        return bn, 1
    ks = -(-nk // splits)
    return bn, -(-nk // ks)


#: rows of K3's run unit on the wgmma route
TC_SUB_ROWS = 32


def grouped_run_tiles(Tp: int, n: int, block_m: int) -> int:
    """32-row sub-tiles of a K3 window on the wgmma route (1, 2, 4 or 8),
    the most a run takes: the fewest that hold 1.5x the mean routed rows an
    expert, so most experts' rows are one run (a second run of an expert
    reads its codes again). ``Tp - n * block_m`` bounds the routed rows of
    a ``sort_tokens_by_expert`` buffer, so this reads shapes only: decode
    steps take 1, a prefill chunk 8."""
    per = 1.5 * max(Tp - n * block_m, 0) / n
    for r in (1, 2, 4):
        if per <= TC_SUB_ROWS * r:
            return r
    return 8


class Run(NamedTuple):
    """One product of a K3 window: token rows ``row0 .. row0 + ntok`` of
    ``expert``, of which ``vload`` are loaded; its first sub-tile is entry
    ``u0`` of the window's table."""
    row0: int
    ntok: int
    vload: int
    expert: int
    u0: int


def grouped_runs(tile_expert, tile_rows, Tp: int, block_m: int, n: int,
                 run_tiles: int) -> list[tuple[list[int], list[Run]]]:
    """The kernel's plan of K3 on the wgmma route, per window of
    ``run_tiles`` 32-row sub-tiles: (the routed rows of its sub-tiles and
    of as many after it, -1 past Tp; the runs that start in it). An
    expert's segment (consecutive sub-tiles of the expert that hold routed
    rows) is cut into runs of ``run_tiles`` sub-tiles from its first, so a
    run may reach into the next window; a sub-tile without a routed row
    (or whose expert is out of range) is written as zeros by its window.
    Host lists in, host lists out: the kernel builds the same table on the
    card."""
    te = [int(v) for v in tile_expert]
    tr = [int(v) for v in tile_rows]
    subs = Tp // TC_SUB_ROWS

    def sub(u):
        if u >= subs:
            return -1, -1
        t = u * TC_SUB_ROWS // block_m
        v = min(max(tr[t] - (u * TC_SUB_ROWS - t * block_m), 0),
                TC_SUB_ROWS)
        return (v if 0 <= te[t] < n else 0), te[t]

    out = []
    for base in range(0, subs, run_tiles):
        rows, ex = zip(*(sub(base + i) for i in range(2 * run_tiles)))
        seg = base
        if rows[0] > 0:
            while seg > 0 and sub(seg - 1)[0] > 0 and \
                    sub(seg - 1)[1] == ex[0]:
                seg -= 1
        runs = []
        for i in range(run_tiles):
            if rows[i] <= 0:
                continue
            if i > 0 and not (rows[i - 1] > 0 and ex[i - 1] == ex[i]):
                seg = base + i
            if (base + i - seg) % run_tiles:
                continue
            j = i
            while j + 1 < i + run_tiles and rows[j + 1] > 0 and \
                    ex[j + 1] == ex[i]:
                j += 1
            vload = -(-((j - i) * TC_SUB_ROWS + rows[j]) // 8) * 8
            runs.append(Run((base + i) * TC_SUB_ROWS,
                            (j - i + 1) * TC_SUB_ROWS, vload, ex[i], i))
        out.append((list(rows), runs))
    return out


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


#: the current stream's raw handle without a Stream object (a few µs of
#: host time a call at decode); CUDA builds of torch have it
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def _stream(dev) -> int:
    """The raw handle of the current CUDA stream on ``dev``."""
    if _raw_stream is not None:
        return _raw_stream(dev.index)
    return torch.cuda.current_stream(dev).cuda_stream


@functools.lru_cache(maxsize=None)
def _tc_scratch(device_index: int) -> tuple[torch.Tensor, torch.Tensor]:
    """K2's K split workspace and arrival counters on a device, made once
    and kept: a launch leaves the counters at zero, and a CUDA graph that
    captured a launch keeps pointing at the same memory. Sized for the
    largest split :func:`tc_split` plans: every block the card holds at
    once, each 256 threads' fp32 fragments of BN / 2 (BN 64 two blocks an
    SM, 256 one). Launches on two streams at once would share them."""
    sms = _sm_count(device_index)
    dev = torch.device("cuda", device_index)
    floats = max(tc_blocks_per_sm(bn) * sms * 256 * bn // 2
                 for bn in TC_TOKENS)
    ws = torch.empty(floats, dtype=torch.float32, device=dev)
    return ws, torch.zeros(2 * sms, dtype=torch.int32, device=dev)


def _error_text(lib, err: int) -> str:
    if err >= 1000:
        return f"tensor map CUresult {err - 1000}"
    name = lib.ds_quant_error_name(err)
    return f"CUDA error {err}" + (f" ({name.decode()})"
                                  if isinstance(name, bytes) else "")


#: the checked operands of each weight the kernels have launched on, keyed
#: by id of its codes tensor: (codes and scales as weak references, device,
#: codes pointer, scales pointer, codes / scales layer strides, layers)
_CHECKED: dict[int, tuple] = {}
_CHECKED_MAX = 4096


def _check_weight(qw: QuantLinear, K: int, dev) -> None:
    data, scale = qw.data, qw.scale
    Np = data.shape[-1]
    G = qw.group_size
    rows = K // 2 if qw.bits == 4 else K
    if (data.shape[-2] != rows or Np % LANE or K % G
            or tuple(scale.shape[-2:]) != (K // G, Np)
            or data.dim() != scale.dim()):
        raise ValueError(f"codes {tuple(data.shape)} / scales "
                         f"{tuple(scale.shape)} do not fit K={K}, G={G}")
    if data.dtype != _CODE_DTYPES[qw.bits] or scale.dtype != torch.float32:
        raise ValueError(f"codes {data.dtype} / scales {scale.dtype} do not "
                         f"fit bits={qw.bits!r}")
    for name, t in (("codes", data), ("scale", scale)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, x on {dev}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte "
                             f"aligned")


def _weight_args(qw: QuantLinear, K: int, dev, layer_index):
    """(codes pointer, scales pointer, layer, codes / scales layer strides)
    of a checked weight; a weight's checks run on its first launch only."""
    data = qw.data
    hit = _CHECKED.get(id(data))
    if (hit is None or hit[0]() is not data or hit[1]() is not qw.scale
            or hit[2] != dev):
        _check_weight(qw, K, dev)
        stacked = data.dim() == 3
        hit = (weakref.ref(data), weakref.ref(qw.scale), dev,
               data.data_ptr(), qw.scale.data_ptr(),
               data[0].numel() if stacked else 0,
               qw.scale[0].numel() if stacked else 0,
               data.shape[0] if stacked else 0)
        if len(_CHECKED) >= _CHECKED_MAX:
            _CHECKED.clear()
        _CHECKED[id(data)] = hit
    layers = hit[7]
    if (layer_index is not None) != (layers > 0):
        raise ValueError(f"codes {tuple(data.shape)} and layer_index "
                         f"{layer_index} disagree")
    li = 0
    if layers:
        li = int(layer_index)
        if not 0 <= li < layers:
            raise ValueError(f"layer_index {li} outside [0, {layers})")
    return hit[3], hit[4], li, hit[5], hit[6]


def _launch_kernel(x, qw: QuantLinear, layer_index, small_m_xla):
    from . import kernels

    M, K = x.shape
    dev = x.device
    route = kernel_route(x.dtype, qw.bits)
    cp, sp, li, cstride, sstride = _weight_args(qw, K, dev, layer_index)
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("x must be contiguous and 16-byte aligned")
    Np = qw.data.shape[-1]
    G = qw.group_size
    out = torch.empty((M, Np), dtype=x.dtype, device=dev)
    lib = kernels.load("quant_matmul")
    if route == "wgmma":
        if K % 8:
            raise ValueError(f"K={K} must be a multiple of 8 on the wgmma "
                             f"route (16-byte x rows)")
        bn, splits = tc_split(M, K, Np, _sm_count(dev.index))
        ws = ctr = 0
        if splits > 1:
            w, c = _tc_scratch(dev.index)
            ws, ctr = w.data_ptr(), c.data_ptr()
        err = lib.ds_quant_matmul_tc(
            x.data_ptr(), cp, sp, out.data_ptr(), ws, ctr, M, K, Np, G,
            _FMT[qw.bits], li, cstride, sstride, bn, splits, _stream(dev))
    else:
        small = M <= SMALL_M_XLA and small_m_xla is not False
        mr = kb = splits = 0
        ws = out
        if small and M > 0:
            mr, kb, splits = decode_form_split(M, K, Np,
                                               _sm_count(dev.index))
            if splits > 1:
                ws = torch.empty((splits, M, Np), dtype=torch.float32,
                                 device=dev)
        err = lib.ds_quant_matmul(
            x.data_ptr(), cp, sp, out.data_ptr(), ws.data_ptr(), M, K, Np,
            G, _FMT[qw.bits], li, cstride, sstride, int(small), mr, kb,
            splits, _stream(dev))
    if err != 0:
        raise RuntimeError(f"quant-matmul kernel launch failed: "
                           f"{_error_text(lib, err)}")
    counts.kernel += 1
    counts.kernel_tc += route == "wgmma"
    N = qw.shape[1]
    return out if N == Np else out[:, :N]


# ---------------------------------------------------------------------------
# grouped (per-expert) form: K3
# ---------------------------------------------------------------------------

class QuantGrouped(NamedTuple):
    """Weight-only-quantized stacked expert weights ``[n, K, N]`` (the JAX
    package's ``QuantGrouped``): ``data`` int8 / e4m3 ``[n, K, Np]`` or
    uint8 ``[n, K/2, Np]`` (int4 pairs), ``scale`` fp32 ``[n, K/G, Np]``;
    both may carry a leading layer dim ``[L, n, ...]``. ``shape`` is the
    logical ``(n, K, N)``."""
    data: torch.Tensor
    scale: torch.Tensor
    bits: int | str
    group_size: int
    shape: tuple[int, int, int]
    dtype: Any

    @property
    def nbytes(self) -> int:
        return (self.data.numel() * self.data.element_size()
                + self.scale.numel() * self.scale.element_size())

    def to(self, device) -> "QuantGrouped":
        return self._replace(data=self.data.to(device),
                             scale=self.scale.to(device))


#: launches of :func:`quant_grouped_matmul` by route (K3)
grouped_counts = QuantCounts()


def quantize_grouped(w: torch.Tensor, bits: int | str = 8,
                     group_size: int | None = None, *,
                     shard: bool = False) -> QuantGrouped:
    """Symmetric per-(expert, K-group, column) quantization of stacked
    expert weights ``[n, K, N]`` — :func:`quantize_weight`'s grid applied
    per expert; codes and scales bit-identical to the JAX package's
    ``quantize_grouped`` (``shard``: as :func:`quantize_weight`'s)."""
    if bits not in (4, 8, "fp8"):
        raise ValueError(f"bits must be 4, 8 or 'fp8', got {bits!r}")
    n, K, N = w.shape
    n_pad = (-N) % LANE
    if n_pad:
        w = torch.nn.functional.pad(w, (0, n_pad))
    G = _resolve_group(K, bits, group_size)
    q, scale = _quantize_slabs(w, bits, G, shard)
    return QuantGrouped(q, scale, bits, G, (n, K, N), w.dtype)


def dequantize_grouped(qw: QuantGrouped) -> torch.Tensor:
    """The plain inverse: the logical ``[n, K, N]`` weights in
    ``qw.dtype``."""
    n, K, N = qw.shape
    w = _dequantize_slabs(qw.data, qw.scale, qw.bits, K, qw.group_size)
    return w[:, :, :N].to(qw.dtype)


def _grouped_layer(qw: QuantGrouped, layer_index):
    """(codes, scales) of the selected layer: ``[n, ...]``."""
    stacked = qw.data.dim() == 4
    if (layer_index is not None) != stacked:
        raise ValueError(f"codes {tuple(qw.data.shape)} and layer_index "
                         f"{layer_index} disagree")
    if layer_index is None:
        return qw.data, qw.scale
    li = int(layer_index)
    if not 0 <= li < qw.data.shape[0]:
        raise ValueError(f"layer_index {li} outside [0, "
                         f"{qw.data.shape[0]})")
    return qw.data[li], qw.scale[li]


def _check_grouped(x, qw: QuantGrouped, tile_expert, block_m, tile_rows):
    if x.dim() != 2:
        raise ValueError(f"x must be [Tp, K], got {tuple(x.shape)}")
    if x.shape[1] != qw.shape[1]:
        raise ValueError(f"contract mismatch: x {tuple(x.shape)} w "
                         f"{qw.shape}")
    from .grouped_matmul import check_tiles

    check_tiles(x.shape[0], block_m, tile_expert, tile_rows)


def quant_grouped_matmul_reference(x: torch.Tensor, qw: QuantGrouped,
                                   tile_expert: torch.Tensor, *,
                                   layer_index=None, block_m: int = 128,
                                   tile_rows: torch.Tensor | None = None
                                   ) -> torch.Tensor:
    """The plain version: each tile times its expert's codes dequantized in
    fp32 and rounded to x's dtype, the product in fp32; rows past
    ``tile_rows`` are zero. ``[Tp, N]`` in x's dtype."""
    from .grouped_matmul import tiled_reference

    _check_grouped(x, qw, tile_expert, block_m, tile_rows)
    data, scale = _grouped_layer(qw, layer_index)
    K, N = qw.shape[1], qw.shape[2]

    def weight_of(e):
        w = _dequantize_slabs(data[e][None], scale[e][None], qw.bits, K,
                              qw.group_size)[0]
        return w[:, :N].to(x.dtype).float()

    return tiled_reference(x, tile_expert, block_m, tile_rows, weight_of)


def quant_grouped_matmul(x: torch.Tensor, qw: QuantGrouped,
                         tile_expert: torch.Tensor, *, layer_index=None,
                         block_m: int = 128,
                         tile_rows: torch.Tensor | None = None
                         ) -> torch.Tensor:
    """``x`` [Tp, K] expert-sorted and aligned (``Tp % block_m == 0``, each
    tile owned by expert ``tile_expert[t]``, see
    ``ops.grouped_matmul.sort_tokens_by_expert``) times ``dequant(qw[e])``
    → [Tp, N] in x's dtype. ``layer_index`` selects a layer of stacked
    ``[L, n, ...]`` codes inside the kernel; ``tile_rows`` (optional) limits
    each tile to its routed rows."""
    _check_grouped(x, qw, tile_expert, block_m, tile_rows)
    if x.device.type == "cpu":
        grouped_counts.plain += 1
        return quant_grouped_matmul_reference(
            x, qw, tile_expert, layer_index=layer_index, block_m=block_m,
            tile_rows=tile_rows)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    return _launch_grouped_kernel(x, qw, tile_expert, layer_index, block_m,
                                  tile_rows)


def _launch_grouped_kernel(x, qw: QuantGrouped, tile_expert, layer_index,
                           block_m, tile_rows):
    from . import kernels
    from .grouped_matmul import check_kernel_operands

    Tp, K = x.shape
    n = qw.shape[0]
    route = kernel_route(x.dtype, qw.bits)
    if K % 8:
        raise ValueError(f"K={K} must be a multiple of 8 (16-byte rows)")
    data, scale = qw.data, qw.scale
    _grouped_layer(qw, layer_index)              # validates the index
    Np = data.shape[-1]
    G = qw.group_size
    rows = K // 2 if qw.bits == 4 else K
    if (tuple(data.shape[-3:]) != (n, rows, Np) or Np % LANE or K % G
            or tuple(scale.shape[-3:]) != (n, K // G, Np)):
        raise ValueError(f"codes {tuple(data.shape)} / scales "
                         f"{tuple(scale.shape)} do not fit n={n}, K={K}, "
                         f"G={G}")
    if data.dtype != _CODE_DTYPES[qw.bits] or scale.dtype != torch.float32:
        raise ValueError(f"codes {data.dtype} / scales {scale.dtype} do not "
                         f"fit bits={qw.bits!r}")
    te, tr = check_kernel_operands(x, block_m, tile_expert, tile_rows,
                                   [("codes", data), ("scale", scale)])
    li, cstride, sstride = 0, 0, 0
    if layer_index is not None:
        li = int(layer_index)
        cstride, sstride = data[0].numel(), scale[0].numel()
    out = torch.empty((Tp, Np), dtype=x.dtype, device=x.device)
    lib = kernels.load("quant_matmul")
    ptrs = (x.data_ptr(), data.data_ptr(), scale.data_ptr(), te.data_ptr(),
            tr.data_ptr(), out.data_ptr())
    ints = (Tp, K, Np, G, n, block_m, _FMT[qw.bits], li, cstride, sstride)
    if route == "wgmma":
        err = lib.ds_quant_grouped_matmul_tc(
            *ptrs, *ints, grouped_run_tiles(Tp, n, block_m),
            _stream(x.device))
    else:
        err = lib.ds_quant_grouped_matmul(*ptrs, *ints, _stream(x.device))
    if err != 0:
        raise RuntimeError(f"quant-grouped-matmul kernel launch failed: "
                           f"{_error_text(lib, err)}")
    grouped_counts.kernel += 1
    grouped_counts.kernel_tc += route == "wgmma"
    N = qw.shape[2]
    return out if N == Np else out[:, :N]
