"""What limits K2's / K3's wgmma route on the card: the kernel source built
in variants that leave out one part of a stage, timed side by side.

    python bin/qmm_widen_variants.py        # on a machine with an H100

Each variant is ``deepspeed_tpu_torch/ops/csrc/quant_matmul.cu`` with one
textual change, compiled with the port's nvcc flags into
``deepspeed_tpu_torch/ops/build/variants/`` and called through the port's
own wrappers (the kernel library swapped underneath):

- ``base``: the source as it is;
- ``nowiden``: no widening (the W tiles keep whatever they hold): the
  stage's TMA loads, barriers and tensor-core products alone;
- ``nocvt``: the fp32 -> bf16x2 rounding replaced by a byte-permute (wrong
  values; the conversion pipe's share);
- ``nomul``: int8 / e4m3 codes not multiplied by their scales (wrong
  values; the multiply and the scale lookup it needs).

Cases: K2 at a decode step (M 8) of llama2-7b's w_gate in int8 and int4
and wq in int8, K3 at a qwen2-moe decode step and prefill chunk and a
Mixtral prefill chunk (int8), each variant timed twice in alternating
order (``chip_smoke.cuda_time_ms``: 20 calls replayed from a CUDA graph);
the lower time is printed beside the case's bound. Prints the card's name
and power limit first.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from deepspeed_tpu_torch.accelerator import card_name_and_power_limit  # noqa: E402
from deepspeed_tpu_torch.ops import kernels  # noqa: E402
from deepspeed_tpu_torch.ops import quant_matmul as qm  # noqa: E402

CSRC = ROOT / "deepspeed_tpu_torch" / "ops" / "csrc"
OUT = ROOT / "deepspeed_tpu_torch" / "ops" / "build" / "variants"

WIDEN = ("            widen_stage<FMT>(st, st + a.code_bytes + BN * kLine, "
         "wt, k0, gb,")
PACK = ("    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);\n"
        "    return *reinterpret_cast<const uint32_t*>(&v);")
MUL = ("                o[2 * q + h] = pack_bf16(a * sc[4 * q + 2 * h],\n"
       "                                         b * sc[4 * q + 2 * h + 1]);")
E4M3_MUL = ("                o[2 * q + h] = pack_bf16(f.x * sc[4 * q + 2 * h],\n"
            "                                         f.y * sc[4 * q + 2 * h "
            "+ 1]);")


def variant_sources(name: str) -> tuple[str, str]:
    """(quant_matmul.cu, hopper.cuh) of a variant."""
    src = (CSRC / "quant_matmul.cu").read_text()
    hop = (CSRC / "hopper.cuh").read_text()
    for text, where in ((WIDEN, src), (PACK, hop), (MUL, src),
                        (E4M3_MUL, src)):
        if where.count(text) != 1:
            raise RuntimeError(f"the source no longer holds {text!r}")
    if name == "nowiden":
        src = src.replace(WIDEN, "            if (0) " + WIDEN.lstrip())
    elif name == "nocvt":
        hop = hop.replace(PACK, "    return __byte_perm(__float_as_uint(lo), "
                                "__float_as_uint(hi), 0x7632);")
    elif name == "nomul":
        src = src.replace(MUL, "                o[2 * q + h] = pack_bf16(a, b);")
        src = src.replace(E4M3_MUL,
                          "                o[2 * q + h] = pack_bf16(f.x, f.y);")
    return src, hop


def build(names) -> dict:
    """The variants' libraries, compiled together (one nvcc each)."""
    procs = {}
    for name in names:
        d = OUT / name
        d.mkdir(parents=True, exist_ok=True)
        src, hop = variant_sources(name)
        (d / "quant_matmul.cu").write_text(src)
        (d / "hopper.cuh").write_text(hop)
        procs[name] = subprocess.Popen(
            [kernels.nvcc(), *kernels.NVCC_FLAGS, "-I", str(d), "-o",
             str(d / "lib.so"), str(d / "quant_matmul.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"variant {name} failed to build:\n{log}")
        lib = ctypes.CDLL(str(OUT / name / "lib.so"))
        kernels._declare("quant_matmul", lib)
        libs[name] = lib
    return libs


def k2_case(dev, bits, K, N, M):
    qw = qm.quantize_weight(cs.k2_weight(K, N, dev, 5), bits=bits)
    x = torch.randn(M, K, device=dev).to(torch.bfloat16)
    return (lambda: qm.quant_matmul(x, qw)), cs.k2_bound(
        M, K, N, qw, torch.bfloat16)[0]


def k3_case(dev, bits, T, k, n, K, N):
    g = torch.Generator(device=dev).manual_seed(3)
    qw = qm.quantize_grouped(torch.randn(n, K, N, generator=g, device=dev)
                             / K ** 0.5, bits=bits)
    buf, srt, cnt = cs.grouped_case(T, k, n, K, cs.K3_BLOCK_M,
                                    torch.bfloat16, dev, 7)
    wbytes = qw.data[0].numel() + qw.scale[0].numel() * 4
    kw = dict(block_m=cs.K3_BLOCK_M, tile_rows=srt.tile_rows)
    return (lambda: qm.quant_grouped_matmul(buf, qw, srt.tile_expert, **kw)), \
        cs.grouped_bound(cnt, K, N, torch.bfloat16, wbytes)[0]


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device: this script needs an H100")
        return 2
    dev = torch.device("cuda")
    print(card_name_and_power_limit(), flush=True)
    names = ["base", "nowiden", "nocvt", "nomul"]
    libs = build(names)
    cases = (("K2 int8 w_gate M=8", lambda: k2_case(dev, 8, 4096, 11008, 8)),
             ("K2 int4 w_gate M=8", lambda: k2_case(dev, 4, 4096, 11008, 8)),
             ("K2 int8 wq M=8", lambda: k2_case(dev, 8, 4096, 4096, 8)),
             ("K3 int8 qwen2-moe decode",
              lambda: k3_case(dev, 8, 8, 4, 60, 2048, 1408)),
             ("K3 int8 qwen2-moe prefill",
              lambda: k3_case(dev, 8, 2048, 4, 60, 2048, 1408)),
             ("K3 int8 Mixtral prefill",
              lambda: k3_case(dev, 8, 512, 2, 8, 4096, 14336)))
    real = kernels.load
    try:
        for label, make in cases:
            fn, bound = make()
            times: dict[str, list[float]] = {}
            for order in (names, names[::-1]):
                for name in order:
                    kernels.load = lambda _n, _lib=libs[name]: _lib
                    times.setdefault(name, []).append(cs.cuda_time_ms(fn))
            kernels.load = real
            for name in names:
                ms = min(times[name])
                print(f"{label:<26} {name:<8} {ms:.4f} ms ({bound / ms:.0%} "
                      f"of the bound {bound:.4f} ms)", flush=True)
            del fn
            cs.free_cuda()
    finally:
        kernels.load = real
    return 0


if __name__ == "__main__":
    sys.exit(main())
