"""Build and load the port's CUDA kernels.

Every kernel source in ``ops/csrc/`` is compiled on first use by ``nvcc``
for Hopper (``sm_90a``) into a shared library with a plain C interface,
which :func:`load` opens with ``ctypes``. PyTorch's headers are kept out of
the sources, so a build takes seconds rather than minutes. Libraries land in
``ops/build/`` (listed in ``.gitignore``) under a name that carries a hash of
the source, every header in ``csrc/`` and the flags, so an edited source or
header is rebuilt and a stale library is never loaded.

Nothing here falls back: a missing ``nvcc``, a failed compile or a failed
load raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD = Path(__file__).resolve().parent / "build"

#: kernel library name -> its source in ``csrc/``
SOURCES = {"paged_attention": "paged_attention.cu",
           "quant_matmul": "quant_matmul.cu",
           "grouped_matmul": "grouped_matmul.cu",
           "flash_attention": "flash_attention.cu",
           "block_sparse_attention": "block_sparse_attention.cu"}

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of the CUDA compiler (``PATH``, else ``CUDA_HOME``, else
    ``/usr/local/cuda``). Raises RuntimeError when there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels are compiled on the "
                       "machine with the card (set CUDA_HOME or PATH)")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / SOURCES[name]).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD / f"lib{name}_{h.hexdigest()[:16]}.so"


def build_all(names=None) -> dict[str, dict]:
    """Compile the named kernel libraries (all by default) that are not
    built yet, one ``nvcc`` process per source, all started together.
    Returns ``{name: {"path", "seconds", "ptxas"}}``; ``ptxas`` is the
    compiler's register/shared-memory report, kept beside the library so a
    library that was already built reports it too. Raises RuntimeError
    naming every source that failed."""
    names = list(SOURCES) if names is None else list(names)
    BUILD.mkdir(parents=True, exist_ok=True)
    procs = {}
    out: dict[str, dict] = {}
    for name in names:
        path = _lib_path(name)
        if path.is_file():
            log = path.with_suffix(".ptxas")
            out[name] = {"path": str(path), "seconds": 0.0,
                         "ptxas": log.read_text() if log.is_file() else ""}
            continue
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       time.perf_counter(), tmp, path)
    failed = []
    for name, (proc, t0, tmp, path) in procs.items():
        log, _ = proc.communicate()
        secs = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{SOURCES[name]} (exit {proc.returncode}):\n{log}")
            continue
        path.with_suffix(".ptxas").write_text(log)
        os.replace(tmp, path)          # atomic: no reader sees half a file
        out[name] = {"path": str(path), "seconds": secs, "ptxas": log}
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name``, built first if needed, with the
    argument types of its C entry points declared."""
    lib = _loaded.get(name)
    if lib is None:
        path = build_all([name])[name]["path"]
        lib = ctypes.CDLL(path)
        _declare(name, lib)
        _loaded[name] = lib
    return lib


def _declare(name: str, lib: ctypes.CDLL) -> None:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    if name == "paged_attention":
        fn = lib.ds_ragged_paged_attention
        # q, pool, k_stage, v_stage, block_tables, seq_lens, q_starts,
        # stage_starts, tree_pos, tree_mask, out; S, T, H, KV, D, nb, bs,
        # Ts, max_pages, layer; scale; window, ring_tokens, dtype,
        # pool_e4m3; stream
        fn.argtypes = [p] * 11 + [i] * 10 + [ctypes.c_float] + [i] * 4 + [p]
        fn.restype = i
        fn = lib.ds_paged_attention
        # q, k_pool, v_pool, block_tables, seq_lens, starts, out; S, T, H,
        # KV, D, P, bs, max_pages; scale; window, ring_tokens, dtype; stream
        fn.argtypes = [p] * 7 + [i] * 8 + [ctypes.c_float] + [i] * 3 + [p]
        fn.restype = i
    elif name == "quant_matmul":
        fn = lib.ds_quant_matmul
        # x, codes, scale, out, workspace; M, K, Np, G, fmt, dtype, layer;
        # codes / scale layer strides; decode, MR, KB, splits; stream
        fn.argtypes = [p] * 5 + [i] * 7 + [ll, ll] + [i] * 4 + [p]
        fn.restype = i
        fn = lib.ds_quant_grouped_matmul
        # x, codes, scale, tile_expert, tile_rows, out; Tp, K, Np, G, n,
        # block_m, fmt, dtype, layer; codes / scale layer strides; stream
        fn.argtypes = [p] * 6 + [i] * 9 + [ll, ll, p]
        fn.restype = i
    elif name == "grouped_matmul":
        # the forward and dx: x (dy), w, tile_expert, tile_rows, out (dx);
        # dw: x, dy, tile_expert, tile_rows, dw; then Tp, K, N, n,
        # block_m, dtype; stream
        for fn in (lib.ds_grouped_matmul, lib.ds_grouped_matmul_dx,
                   lib.ds_grouped_matmul_dw):
            fn.argtypes = [p] * 5 + [i] * 6 + [p]
            fn.restype = i
    elif name == "flash_attention":
        fn = lib.ds_flash_attention_fwd
        # q, k, v, out, lse; B, H, KV, S, D; scale; causal, dtype; stream
        fn.argtypes = [p] * 5 + [i] * 5 + [ctypes.c_float] + [i] * 2 + [p]
        fn.restype = i
        fn = lib.ds_flash_attention_bwd
        # q, k, v, dout, lse, delta, dq, dk, dv; B, H, KV, S, D; scale;
        # causal, dtype; stream
        fn.argtypes = [p] * 9 + [i] * 5 + [ctypes.c_float] + [i] * 2 + [p]
        fn.restype = i
        fn = lib.ds_flash_attention_map_us
        fn.argtypes = []
        fn.restype = ctypes.c_double
        fn = lib.ds_flash_attention_tc_smem
        # which (0 forward, 1 dq, 2 dk/dv), D
        fn.argtypes = [i, i]
        fn.restype = i
    elif name == "block_sparse_attention":
        fn = lib.ds_block_sparse_attention_fwd
        # q, k, v, out, lse, tbl_q, cnt_q, order_q; B, H, S, D, block, mk;
        # scale; causal, dtype; stream
        fn.argtypes = [p] * 8 + [i] * 6 + [ctypes.c_float] + [i] * 2 + [p]
        fn.restype = i
        # q, k, v, dout, lse, delta, tbl, cnt, order, dq (dq) or dk, dv
        # (dkv); B, H, S, D, block, m; scale; causal, dtype; stream
        for fn, n_ptr in ((lib.ds_block_sparse_attention_dq, 10),
                          (lib.ds_block_sparse_attention_dkv, 11)):
            fn.argtypes = [p] * n_ptr + [i] * 6 + [ctypes.c_float] + \
                [i] * 2 + [p]
            fn.restype = i
