"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py [--phases build,kernel,parity,serve] [--out DIR]

Phases (every one raises on failure; nothing is caught and passed over):

1. build  — compile every CUDA kernel of the port from ``ops/csrc`` with
   nvcc for sm_90a, all sources at once, and print the build times.
2. kernel — hold each kernel against its plain PyTorch version on the card
   at the serving path's shapes, and time the kernel, the plain version, a
   PyTorch yardstick and the kernel's bound:
   - K1, the paged-attention kernel (llama2-7b geometry and a GQA geometry;
     decode, a 256-token prefill chunk over several pool pages, a
     window-shaped stage; an empty slot and trash-padded block tables), in
     fp32 (max absolute error 1e-4) and bf16 (max absolute error over max
     |plain| 1e-2: p is rounded to bf16 before the PV product, in a
     different order than the plain version's). q is drawn at 3x the keys'
     spread so the softmax is peaked and a wrong score shows in the output.
     Yardstick: one ``scaled_dot_product_attention`` call over the same K/V
     gathered dense.
   - K1's e4m3-pool form at the same llama2-7b shapes over an e4m3 pool,
     against the plain version rounding p against the kernel's 64-key
     walk; judged by max |error| over max |plain| and mean |error| over
     mean |plain| (``K1_E4M3_TOL``: a p that lands within fp32 noise of an
     e4m3 rounding boundary may round the other way, one e4m3 step).
     Yardstick: the same SDPA call over the pages upcast.
   - K2, the quantized-weight product, for int8, int4 and e4m3 codes at
     decode M=8 and prefill M=256, on llama2-7b's wq, w_gate, w_down and
     unembed shapes plus a stacked [L, K, N] case at a non-zero layer;
     unit-normal x, weights whose scales differ by K-group and by column;
     judged by max |error| over max |plain| (``K2_TOL``). No single
     PyTorch call computes K2's function; the yardstick is ``torch.matmul``
     with a dense bf16 weight of the same shape, the product K2 replaces.
     K1 and K2 also run at qwen2-moe-a2.7b's geometry (H = KV = 16) and
     shapes (its 2048 x 151936 unembedding).
   - K5, the grouped expert product, in bf16 and fp32, and K3, its
     quantized form, for int8, int4 and e4m3 codes (plus stacked codes at
     a non-zero layer), on qwen2-moe's expert w_gate [60,2048,1408] and
     w_down [60,1408,2048] and Mixtral's w_gate [8,4096,14336], at decode
     routing (8 tokens x top-k) and prefill routing (2048 x 4, 512 x 2),
     plus a skewed (all tokens on one expert's set) and an idle-expert
     routing; judged by ``K2_TOL``. Bound: the x rows that hold routed
     tokens, each active expert's weights once and the routed output
     rows, or 2 x routed rows x K x N operations. Yardstick: one
     ``torch._grouped_mm`` call in bf16 over the same expert-aligned
     buffer (for K3 the bf16 product it replaces).
3. parity — llama2-7b at full width with 4 layers in fp32: the engine's
   greedy streams against a greedy loop over the dense
   ``TransformerLM.forward``. TF32 is off for matmuls and cuDNN. Streams
   must be identical and every sampled step's logits agree within 1e-3
   relative; the one allowed exception is a step where the oracle's top-2
   logit gap is below 1e-4 (a near-tie in random weights), printed as such.
   Then the same with ``quant_bits`` 8, 4 and "fp8", the oracle's weights
   being ``dequantize_weight`` of the engine's codes; and an e4m3-pool
   engine whose logits must stay within 0.5 (max) and 0.05 (mean) of the
   fp32-pool engine's while their streams agree (the JAX package's bound
   for its fp8 pool). Then Mixtral-8x7B (the capacity route, ``dropless``,
   ``quant_bits`` 8, 4 and "fp8") and qwen2-moe-a2.7b (``dropless``,
   ``quant_bits=8``) at full width with 4 layers, each against the model
   with no token dropped (eval capacity factor = number of experts), over
   the dequantized codes for the quantized routes. Each run asserts its
   K1 / K2 / K3 / K5 launches and 0 plain launches.
4. serve  — llama2-7b at full width and depth in bf16 from seeded random
   weights: 8 requests of 256-1024 prompt tokens (a shared 128-token system
   prefix) and 64 new tokens each, through put/step/query/flush. Prints
   output tok/s, p50 TTFT, decode ms/token, peak memory, the parameter
   bytes on the card and the kernels' launches: K1 equals layers x forward
   dispatches, the plain versions' counts are 0. Run three times: bf16
   weights and pool; ``quant_bits=8`` with ``kv_cache_dtype="fp8"`` (K1's
   e4m3 form); ``quant_bits=4``. The quantized runs launch K2 225 times per
   forward (7 products x 32 layers + the unembedding) and hold at most 0.55x
   (int8) and 0.30x (int4) of the bf16 run's parameter bytes. Then
   qwen2-moe-a2.7b at full width and depth, the same three runs: bf16 with
   ``moe.dropless`` (K5 72 launches per forward: 3 expert products x 24
   layers), and the quantized runs (K3 72, K2 97 per forward), within
   0.56x and 0.34x of the bf16 parameter bytes.

The last lines are the kernels' JSON record, the card's name and power
limit, and ``{"ok": true, "device": {...}}``. Without a CUDA device the
script exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import statistics
import sys
import time

import torch

#: H100 SXM peaks (NVIDIA data sheet; dense, at the full 700 W limit)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12,
            torch.float8_e4m3fn: 1979e12}

ALL_PHASES = ("build", "kernel", "parity", "serve")

#: spread of the K1 cases' q against unit-normal K/V (see k1_case)
Q_SD = 3.0
#: K1 against its plain version: fp32 by absolute error; bf16 by the max
#: absolute error over max |plain|, since p and the output round to bf16
K1_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
#: K1's e4m3 form against its plain version: (max |error| / max |plain|,
#: mean |error| / mean |plain|). Both round p to e4m3 against the same
#: running max, but a p within fp32 noise of a rounding boundary (the two
#: order their sums and exps differently) may round one e4m3 step (12.5%)
#: apart, so the max allows one bf16 ulp of the largest output or such a
#: step, and the mean bounds how often it happens. Measured on the H100:
#: max 6.6e-7 (fp32) and 2.0e-3 (bf16), mean at most 5.7e-7
K1_E4M3_TOL = {torch.float32: (1e-2, 1e-5), torch.bfloat16: (1e-2, 1e-4)}
#: K2 against its plain version, max |error| over max |plain|: fp32 sums
#: over K in another order; bf16 outputs may round one ulp (<= 2^-7 of the
#: largest) apart
K2_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
#: weight shapes (K, N) on K2's path: llama2-7b's, and qwen2-moe-a2.7b's
#: attention projection and unembedding (N = 1187 x 128)
K2_SHAPES = {"wq": (4096, 4096), "w_gate": (4096, 11008),
             "w_down": (11008, 4096), "unembed": (4096, 32000),
             "qwen2-moe/wq": (2048, 2048),
             "qwen2-moe/unembed": (2048, 151936)}
#: K2's stacked case: (layers, K, N, the layer selected)
K2_STACKED = (4, 4096, 4096, 2)


def k1_error(got, ref, dtype) -> tuple[float, float]:
    """(max |got - ref|, the error the tolerance judges: the same for fp32,
    over max |ref| for bf16)."""
    err = (got.float() - ref.float()).abs().max().item()
    if dtype == torch.float32:
        return err, err
    return err, err / ref.float().abs().max().item()


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_time_ms(fn, iters: int = 20, warmup: int = 3,
                 graph: bool = True) -> float:
    """Mean device time of ``fn()`` in ms: ``warmup`` calls, then ``iters``
    calls captured in one CUDA graph and replayed between two CUDA events.
    A replay issues the launches without the host's per-call cost, so a
    kernel shorter than its wrapper's host time (a decode-shaped K2 call)
    is timed by the device, not by how fast the host can issue it.
    ``graph=False`` times ``iters`` calls between two events without a
    graph, for a function that reads values back to the host (the grouped
    products' plain versions)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    if not graph:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / iters
    del graph
    return ms


def free_cuda() -> None:
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 1: build
# ---------------------------------------------------------------------------

def phase_build() -> dict:
    from deepspeed_tpu_torch.ops import kernels

    t0 = time.perf_counter()
    built = kernels.build_all()
    wall = time.perf_counter() - t0
    for name, rec in built.items():
        log(f"[build] {name}: {rec['seconds']:.1f}s -> {rec['path']}")
        for line in rec["ptxas"].splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build]   {line.strip()}")
    log(f"[build] all kernels in {wall:.1f}s")
    return built


# ---------------------------------------------------------------------------
# phase 2: each kernel against its plain version
# ---------------------------------------------------------------------------

def k1_case(name, *, H, KV, D, bs, T, Ts, ctx, dtype, dev, seed,
            window=False, nb=256, L=2, e4m3=False):
    """Inputs for one K1 case: ``ctx`` lists each slot's pool context
    (positions below stage_starts), -1 for an empty slot. Each live slot's
    stage holds its fresh rows: a ragged prefill chunk, the one decode
    token, or (``window``) 1-8 rows of a decode window whose query is the
    last of them. ``e4m3`` casts the pool to e4m3 codes."""
    from deepspeed_tpu_torch.ops.quant_matmul import to_e4m3

    g = torch.Generator(device=dev).manual_seed(seed)
    S = len(ctx)

    def rnd(*shape, sd=1.0):
        return (torch.randn(shape, generator=g, device=dev) * sd).to(dtype)

    pool = rnd(L, 2, KV, nb, bs, D)
    if e4m3:
        pool = to_e4m3(pool)
    # q at 3x the keys' spread: the scaled scores spread by about 3 units,
    # so the softmax is peaked and a wrong score moves the output
    q = rnd(S, T, H, D, sd=Q_SD)
    ks, vs = rnd(S, KV, Ts, D), rnd(S, KV, Ts, D)
    max_pages = max(-(-(c + Ts) // bs) for c in ctx) + 2
    tables = torch.zeros(S, max_pages, dtype=torch.int32)   # trash-padded
    lens, qst, sst = [], [], []
    perm = torch.randperm(nb - 1, generator=torch.Generator().manual_seed(
        seed)) + 1
    used = 0
    for s, c in enumerate(ctx):
        if c < 0:                                  # empty slot
            lens.append(0), qst.append(0), sst.append(0)
            continue
        n_pages = -(-(c + Ts) // bs)
        tables[s, :n_pages] = perm[used:used + n_pages].to(torch.int32)
        used += n_pages
        if window:
            # window stage: rows 0..w-1 filled, the query is the last one
            w = 1 + (s % Ts)
            lens.append(c + w), qst.append(c + w - 1), sst.append(c)
        else:
            n = T - (s % 3) * (T // 4) if T > 1 else 1   # ragged chunks
            lens.append(c + n), qst.append(c), sst.append(c)
    i32 = lambda v: torch.tensor(v, dtype=torch.int32, device=dev)
    return dict(name=name, q=q, pool=pool, k_stage=ks, v_stage=vs,
                block_tables=tables.to(dev), seq_lens=i32(lens),
                q_starts=i32(qst), stage_starts=i32(sst), block_size=bs,
                layer_index=L - 1)


def k1_work(case) -> tuple[float, float, float]:
    """(bytes, operations, seconds the operations need at the card's peak)
    on this case's data: q, the valid K/V rows (pool and stage) once per KV
    head and the output; two multiply-adds per visible (query, key) pair and
    head dim element, the pool's at the e4m3 rate for an e4m3 pool."""
    q, pool = case["q"], case["pool"]
    S, T, H, D = q.shape
    KV = pool.shape[2]
    G = H // KV
    el, pel = q.element_size(), pool.element_size()
    lens = case["seq_lens"].tolist()
    qst = case["q_starts"].tolist()
    sst = case["stage_starts"].tolist()
    nbytes = 2 * q.numel() * el
    pairs_pool = pairs_stage = 0
    for s in range(S):
        if lens[s] <= 0:
            continue
        keys = min(lens[s], qst[s] + T)
        pool_keys = min(sst[s], keys)
        nbytes += 2 * KV * D * (pool_keys * pel + (keys - pool_keys) * el)
        for t in range(T):
            vis = min(lens[s], qst[s] + t + 1)
            vis_pool = min(sst[s], vis)
            pairs_pool += vis_pool * G * KV
            pairs_stage += (vis - vis_pool) * G * KV
    ops = 4.0 * D * (pairs_pool + pairs_stage)
    secs = 4.0 * D * (pairs_pool / PEAK_OPS[pool.dtype]
                      + pairs_stage / PEAK_OPS[q.dtype])
    return float(nbytes), ops, secs


def k1_library_call(case):
    """One scaled_dot_product_attention call over the case's K/V gathered
    dense (masked; an e4m3 pool upcast to q's dtype), timed as a yardstick
    beside the kernel."""
    import torch.nn.functional as F

    q, pool = case["q"], case["pool"].to(case["q"].dtype)
    S, T, H, D = q.shape
    KV, bs = pool.shape[2], case["block_size"]
    G = H // KV
    tables = case["block_tables"].long()
    ctx = tables.shape[1] * bs
    li = case["layer_index"]
    blocks = tables.repeat_interleave(bs, dim=1)
    offs = torch.arange(ctx, device=q.device) % bs
    k = torch.cat([pool[li, 0][:, blocks, offs[None]].permute(1, 0, 2, 3),
                   case["k_stage"]], dim=2).repeat_interleave(G, dim=1)
    v = torch.cat([pool[li, 1][:, blocks, offs[None]].permute(1, 0, 2, 3),
                   case["v_stage"]], dim=2).repeat_interleave(G, dim=1)
    sst = case["stage_starts"].long()[:, None]
    Ts = case["k_stage"].shape[2]
    cpos = torch.cat([torch.arange(ctx, device=q.device)[None].expand(S, -1),
                      sst + torch.arange(Ts, device=q.device)[None]], dim=1)
    valid = torch.cat([torch.arange(ctx, device=q.device)[None] < sst,
                       cpos[:, ctx:] < case["seq_lens"].long()[:, None]], 1)
    qpos = case["q_starts"].long()[:, None] + torch.arange(
        T, device=q.device)[None]
    mask = (valid[:, None, :] & (cpos[:, None, :] <= qpos[:, :, None]))
    mask = mask[:, None]                                  # [S, 1, T, C]
    qh = q.permute(0, 2, 1, 3)
    return lambda: F.scaled_dot_product_attention(qh, k, v, attn_mask=mask)


def bound_of(nbytes: float, ops_seconds: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops_seconds * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def phase_k1(dev) -> tuple[dict, dict, list]:
    """K1 in its default form and its e4m3-pool form against the plain
    version. Returns (default-form summary, e4m3-form summary, cases)."""
    from deepspeed_tpu_torch.ops.paged_attention import (
        KERNEL_KEY_TILE, counts, paged_ragged_attention,
        paged_ragged_attention_reference)

    # the serving path's shapes (phase 4): 8 slots of ~256-1100 context,
    # one empty; prefill chunks of 256 over several 64-token pages
    decode_ctx = [256, 397, 512, 611, 700, 833, 1022, -1]
    chunk_ctx = [0, 192, 320, 768]
    geoms = {"llama2-7b": dict(H=32, KV=32, D=128),
             "gqa-32q/8kv": dict(H=32, KV=8, D=128),
             "qwen2-moe": dict(H=16, KV=16, D=128)}
    shapes = {"decode": dict(T=1, Ts=8, ctx=decode_ctx),
              "window": dict(T=1, Ts=8, window=True,
                             ctx=[c + 3 if c >= 0 else c
                                  for c in decode_ctx]),
              "prefill256": dict(T=256, Ts=256, ctx=chunk_ctx)}
    plan = [(dt, g, s, False) for dt in (torch.float32, torch.bfloat16)
            for g in geoms for s in shapes]
    plan += [(dt, "llama2-7b", s, True) for dt in (torch.float32,
                                                    torch.bfloat16)
             for s in shapes]
    results = []
    for seed, (dtype, gname, sname, e4m3) in enumerate(plan, start=1):
        label = f"{gname}/{sname}" + ("/e4m3-pool" if e4m3 else "")
        case = k1_case(label, bs=64, dtype=dtype, dev=dev, seed=seed,
                       e4m3=e4m3, **geoms[gname], **shapes[sname])
        args = [case[k] for k in ("q", "pool", "k_stage", "v_stage",
                                  "block_tables", "seq_lens", "q_starts",
                                  "stage_starts")]
        kw = dict(block_size=64, layer_index=case["layer_index"])
        ref_kw = dict(kw, p_round_blocks=(KERNEL_KEY_TILE, KERNEL_KEY_TILE))
        got = paged_ragged_attention(*args, **kw)
        torch.cuda.synchronize()
        ref = paged_ragged_attention_reference(*args, **ref_kw)
        empty = case["seq_lens"] == 0
        if empty.any() and got[empty].abs().max().item() != 0.0:
            raise AssertionError(f"{label}: empty slot not 0")
        if not torch.isfinite(got).all():
            raise AssertionError(f"{label}: non-finite output")
        diff = (got.float() - ref.float()).abs()
        err = diff.max().item()
        if e4m3:
            judged = err / ref.float().abs().max().item()
            judged_mean = (diff.mean() / ref.float().abs().mean()).item()
            tol, tol_mean = K1_E4M3_TOL[dtype]
            ok = judged <= tol and judged_mean <= tol_mean
        else:
            _, judged = k1_error(got, ref, dtype)
            judged_mean, tol, tol_mean = None, K1_TOL[dtype], None
            ok = judged <= tol
        if not ok:
            raise AssertionError(
                f"K1 {label} {dtype}: kernel against plain error {judged:.3e}"
                f" (tol {tol:.0e}), mean {judged_mean} (tol {tol_mean}); max "
                f"abs {err:.3e}")
        ms = cuda_time_ms(lambda: paged_ragged_attention(*args, **kw))
        plain_ms = cuda_time_ms(
            lambda: paged_ragged_attention_reference(*args, **ref_kw),
            iters=3, warmup=1)
        lib_ms = cuda_time_ms(k1_library_call(case), iters=5, warmup=1)
        nbytes, ops, ops_s = k1_work(case)
        bound, by = bound_of(nbytes, ops_s)
        rec = dict(case=label, form="e4m3" if e4m3 else "default",
                   dtype=str(dtype).replace("torch.", ""),
                   max_abs_err=err, judged_err=judged,
                   judged_mean_err=judged_mean,
                   max_abs_ref=ref.float().abs().max().item(), tol=tol,
                   tol_mean=tol_mean, ms=ms, plain_ms=plain_ms,
                   library_ms=lib_ms, bound_ms=bound, bound_by=by,
                   bytes=nbytes, ops=ops)
        results.append(rec)
        mean_txt = (f", mean {judged_mean:.2e} (tol {tol_mean:.0e})"
                    if e4m3 else "")
        log(f"[kernel] K1 {label:<37} {rec['dtype']:<8} err {judged:.2e} "
            f"(tol {tol:.0e}{mean_txt}; max abs {err:.2e} of max |plain| "
            f"{rec['max_abs_ref']:.2f})  kernel {ms:.4f} ms  plain "
            f"{plain_ms:.3f} ms  sdpa {lib_ms:.3f} ms  bound {bound:.4f} ms "
            f"({by})")
        del case, args, got, ref, diff
    counts.reset()

    def summary(form):
        rs = [r for r in results if r["form"] == form]
        # the record line reports each form at the serving path's most
        # frequent shape: a bf16 decode-window step of llama2-7b geometry
        main = next(r for r in rs if r["case"].startswith("llama2-7b/window")
                    and r["dtype"] == "bfloat16")
        return dict(max_abs_err=max(r["max_abs_err"] for r in rs
                                    if r["dtype"] == "bfloat16"),
                    max_err_over_max_ref=max(r["judged_err"] for r in rs
                                             if r["dtype"] == "bfloat16"),
                    max_abs_err_fp32=max(r["max_abs_err"] for r in rs
                                         if r["dtype"] == "float32"),
                    **{k: main[k] for k in ("ms", "plain_ms", "library_ms",
                                            "bound_ms", "bound_by")})

    return summary("default"), summary("e4m3"), results


def k2_weight(K, N, dev, seed) -> torch.Tensor:
    """A [K, N] fp32 weight whose quantization is not trivial: unit-normal
    entries scaled by e^U(-2,2) per row and e^U(-1,1) per column, so every
    K-group and column takes its own scale."""
    g = torch.Generator(device=dev).manual_seed(seed)
    w = torch.randn(K, N, generator=g, device=dev)
    w *= torch.empty(K, 1, device=dev).uniform_(-2, 2, generator=g).exp_()
    w *= torch.empty(1, N, device=dev).uniform_(-1, 1, generator=g).exp_()
    return w


def k2_bound(M, K, N, qw, dtype) -> tuple[float, str, float]:
    """(bound ms, what bounds it, bytes): codes K*N*bits/8, scales, x and
    the output moved once; 2*M*K*N operations at the compute dtype's
    peak."""
    Np = qw.data.shape[-1]
    bits = {8: 8, 4: 4, "fp8": 8}[qw.bits]
    el = torch.empty((), dtype=dtype).element_size()
    nbytes = (K * Np * bits / 8 + (K // qw.group_size) * Np * 4
              + M * K * el + M * N * el)
    bound, by = bound_of(nbytes, 2.0 * M * K * N / PEAK_OPS[dtype])
    return bound, by, nbytes


def phase_k2(dev) -> tuple[dict, list]:
    """K2 against its plain version. Returns (summary, cases)."""
    from deepspeed_tpu_torch.ops.quant_matmul import (
        QuantLinear, counts, quant_matmul, quant_matmul_reference,
        quantize_weight)

    results = []

    def run(label, x, qw, layer_index=None):
        M, K = x.shape
        N = qw.shape[1]
        dtype = x.dtype
        got = quant_matmul(x, qw, layer_index=layer_index)
        torch.cuda.synchronize()
        ref = quant_matmul_reference(x, qw, layer_index=layer_index)
        if got.shape != (M, N) or not torch.isfinite(got).all():
            raise AssertionError(f"K2 {label}: shape {tuple(got.shape)} or "
                                 f"non-finite output")
        err = (got.float() - ref.float()).abs().max().item()
        judged = err / ref.float().abs().max().item()
        if judged > K2_TOL[dtype]:
            raise AssertionError(f"K2 {label} {dtype}: kernel against plain "
                                 f"error {judged:.3e} > {K2_TOL[dtype]:.0e} "
                                 f"(max abs {err:.3e})")
        ms = cuda_time_ms(lambda: quant_matmul(x, qw,
                                               layer_index=layer_index))
        plain_ms = cuda_time_ms(
            lambda: quant_matmul_reference(x, qw, layer_index=layer_index),
            iters=3, warmup=1)
        dense = torch.randn(K, N, device=dev, dtype=torch.bfloat16)
        xb = x.to(torch.bfloat16)
        dense_ms = cuda_time_ms(lambda: torch.matmul(xb, dense))
        bound, by, nbytes = k2_bound(M, K, N, qw, dtype)
        rec = dict(case=label, bits=str(qw.bits), M=M, K=K, N=N,
                   dtype=str(dtype).replace("torch.", ""), max_abs_err=err,
                   judged_err=judged, tol=K2_TOL[dtype],
                   max_abs_ref=ref.float().abs().max().item(), ms=ms,
                   plain_ms=plain_ms, dense_bf16_matmul_ms=dense_ms,
                   bound_ms=bound, bound_by=by, bytes=nbytes)
        results.append(rec)
        log(f"[kernel] K2 {label:<30} {rec['dtype']:<8} err {judged:.2e} "
            f"(tol {K2_TOL[dtype]:.0e}; max abs {err:.2e})  kernel "
            f"{ms:.4f} ms  plain {plain_ms:.3f} ms  dense bf16 matmul "
            f"{dense_ms:.4f} ms  bound {bound:.4f} ms ({by})")
        del got, ref, dense

    seed = 100
    for bits in (8, 4, "fp8"):
        for wname, (K, N) in K2_SHAPES.items():
            seed += 1
            qw = quantize_weight(k2_weight(K, N, dev, seed), bits=bits)
            for M in (8, 256):
                g = torch.Generator(device=dev).manual_seed(seed + M)
                x = torch.randn(M, K, generator=g, device=dev)
                dtypes = (torch.bfloat16,) + (
                    (torch.float32,) if wname == "wq" else ())
                for dtype in dtypes:
                    run(f"{bits}/{wname}/M={M}", x.to(dtype), qw)
            del qw
            free_cuda()
        # stacked [L, K, N] codes: one layer selected inside the kernel
        L, K, N, li = K2_STACKED
        layers = [quantize_weight(k2_weight(K, N, dev, seed + 50 + i),
                                  bits=bits) for i in range(L)]
        st = QuantLinear(torch.stack([q.data for q in layers]),
                         torch.stack([q.scale for q in layers]), bits,
                         layers[0].group_size, layers[0].shape,
                         layers[0].dtype)
        for M in (8, 256):
            x = torch.randn(M, K, device=dev,
                            generator=torch.Generator(device=dev).manual_seed(
                                seed + 7 * M)).to(torch.bfloat16)
            run(f"{bits}/stacked-L{L}-layer{li}/M={M}", x, st,
                layer_index=li)
            # the selected layer is the one read
            if not torch.equal(quant_matmul(x, st, layer_index=li),
                               quant_matmul(x, layers[li])):
                raise AssertionError(f"K2 {bits}: stacked layer {li} "
                                     f"differs from the unstacked weight")
        del layers, st
        free_cuda()
    host = k2_host_overhead(dev)
    counts.reset()
    bf = [r for r in results if r["dtype"] == "bfloat16"]
    # the record line reports K2 at a decode call of w_gate in int8
    main = next(r for r in results if r["case"] == "8/w_gate/M=8")
    summary = dict(max_abs_err=max(r["max_abs_err"] for r in bf),
                   max_err_over_max_ref=max(r["judged_err"] for r in bf),
                   max_err_over_max_ref_fp32=max(
                       r["judged_err"] for r in results
                       if r["dtype"] == "float32"),
                   **{k: main[k] for k in ("ms", "plain_ms",
                                           "dense_bf16_matmul_ms",
                                           "bound_ms", "bound_by")})
    return summary, results + [host]


def host_us_per_call(fn, n: int = 300) -> float:
    """Host time to issue one ``fn()``, in µs: ``n`` back-to-back calls on
    the host clock, synchronised only after the clock stops. With a call
    whose device time is a few µs this is the enqueue cost, the part of a
    decode step that the host pays for every product."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    us = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    return us


def k2_host_overhead(dev) -> dict:
    """The host's cost per product at a decode shape too small to keep the
    card busy: K2's wrapper and launch against ``torch.matmul`` with a dense
    bf16 weight, beside the stream lookup and ctypes call it includes."""
    from deepspeed_tpu_torch.ops import kernels
    from deepspeed_tpu_torch.ops.quant_matmul import (quant_matmul,
                                                      quantize_weight)

    qw = quantize_weight(k2_weight(256, 128, dev, 9), bits=8)
    x = torch.randn(8, 256, device=dev).to(torch.bfloat16)
    dense = torch.randn(256, 128, device=dev, dtype=torch.bfloat16)
    lib = kernels.load("quant_matmul")
    rec = {"case": "host overhead (M=8, K=256, N=128, bf16)",
           "k2_wrapper_us": host_us_per_call(lambda: quant_matmul(x, qw)),
           "torch_matmul_us": host_us_per_call(lambda: torch.matmul(x,
                                                                    dense)),
           "current_stream_us": host_us_per_call(
               lambda: torch.cuda.current_stream(dev).cuda_stream),
           "ctypes_noop_launch_us": host_us_per_call(
               lambda: lib.ds_quant_matmul(0, 0, 0, 0, 0, 0, 1, 128, 1, 0, 0,
                                           0, 0, 0, 0, 0, 0, 0, 0))}
    log(f"[kernel] host cost per call: K2 wrapper "
        f"{rec['k2_wrapper_us']:.1f} us, torch.matmul "
        f"{rec['torch_matmul_us']:.1f} us (of which stream lookup "
        f"{rec['current_stream_us']:.1f} us, a ctypes call that launches "
        f"nothing {rec['ctypes_noop_launch_us']:.1f} us)")
    return rec


#: MoE weight shapes on K5's and K3's path: (label, experts n, K, N, top-k,
#: prefill tokens) — qwen2-moe-a2.7b's expert w_gate and w_down, and
#: Mixtral-8x7B's expert w_gate
GROUPED_SHAPES = (("qwen2-moe/w_gate", 60, 2048, 1408, 4, 2048),
                  ("qwen2-moe/w_down", 60, 1408, 2048, 4, 2048),
                  ("mixtral/w_gate", 8, 4096, 14336, 2, 512))
#: tokens of a decode step (8 slots, one token each)
DECODE_TOKENS = 8
#: sort alignment of the grouped products on the serving path: K5 under
#: ``moe.dropless`` (``dropless_block_m``), K3 under ``quant_bits``
K5_BLOCK_M, K3_BLOCK_M = 128, 32


def routing(kind: str, T: int, n: int, k: int, dev, seed: int):
    """[T, k] expert choices, k distinct experts per token: ``spread``
    draws them uniformly; ``skewed`` sends every token to the same k
    experts (expert 3 owns all T tokens); ``idle`` draws them from the
    first quarter of the experts, so the rest own no row."""
    g = torch.Generator(device=dev).manual_seed(seed)
    if kind == "skewed":
        row = (3 + torch.arange(k, device=dev)) % n
        return row.expand(T, k).to(torch.int32).contiguous()
    m = n if kind == "spread" else max(n // 4, k)
    scores = torch.rand(T, m, generator=g, device=dev)
    return scores.argsort(dim=1)[:, :k].to(torch.int32)


def grouped_case(T, k, n, K, block_m, dtype, dev, seed, kind="spread"):
    """(buf, sort, per-expert counts): T unit-normal token rows routed by
    ``routing(kind)`` into the expert-sorted buffer (zero padding rows)."""
    from deepspeed_tpu_torch.ops.grouped_matmul import sort_tokens_by_expert

    idx = routing(kind, T, n, k, dev, seed)
    srt = sort_tokens_by_expert(idx, n, block_m)
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    x = torch.randn(T, K, generator=g, device=dev).to(dtype)
    buf = x.new_zeros((srt.Tp, K)).index_copy_(
        0, srt.dst.long(), x.repeat_interleave(k, dim=0))
    e = idx.reshape(-1).long()
    counts = torch.zeros(n, dtype=torch.long, device=dev).scatter_add_(
        0, e, torch.ones_like(e))
    return buf, srt, counts


def grouped_bound(counts, K, N, dtype, weight_bytes_per_expert):
    """(bound ms, what bounds it, bytes, operations): the x rows that hold
    routed tokens, the weights of each expert that owns a routed row once,
    and the routed output rows; 2 * routed rows * K * N operations at the
    peak for x's dtype."""
    routed = int(counts.sum())
    active = int((counts > 0).sum())
    el = torch.empty((), dtype=dtype).element_size()
    nbytes = (routed * K * el + active * weight_bytes_per_expert
              + routed * N * el)
    ops = 2.0 * routed * K * N
    bound, by = bound_of(nbytes, ops / PEAK_OPS[dtype])
    return bound, by, float(nbytes), ops


def library_grouped_mm(buf, w_bf16, counts, block_m):
    """One ``torch._grouped_mm`` call over the same expert-aligned buffer
    in bf16 (group ends from the aligned counts), or None where this torch
    has no such call."""
    if not hasattr(torch, "_grouped_mm"):
        return None
    aligned = (counts + block_m - 1) // block_m * block_m
    offs = aligned.cumsum(0).to(torch.int32)
    xb = buf.to(torch.bfloat16)
    return lambda: torch._grouped_mm(xb, w_bf16, offs=offs)


def check_grouped(tag, got, ref, tp, N, dtype) -> tuple[float, float]:
    """(max |error|, max |error| / max |plain|), raising past ``K2_TOL``."""
    if got.shape != (tp, N) or not torch.isfinite(got).all():
        raise AssertionError(f"{tag}: shape {tuple(got.shape)} or "
                             f"non-finite output")
    err = (got.float() - ref.float()).abs().max().item()
    judged = err / ref.float().abs().max().item()
    if judged > K2_TOL[dtype]:
        raise AssertionError(f"{tag} {dtype}: kernel against plain error "
                             f"{judged:.3e} > {K2_TOL[dtype]:.0e} (max abs "
                             f"{err:.3e})")
    return err, judged


def phase_k5(dev) -> tuple[dict, list]:
    """K5's forward against its plain version at the MoE shapes, decode and
    prefill routings (and a skewed and an idle-expert routing), bf16 and
    fp32. Returns (summary, cases)."""
    from deepspeed_tpu_torch.ops.grouped_matmul import (
        counts, grouped_matmul, grouped_matmul_reference)

    results = []
    seed = 300
    for label, n, K, N, k, T_pre in GROUPED_SHAPES:
        seed += 10
        g = torch.Generator(device=dev).manual_seed(seed)
        w32 = torch.randn(n, K, N, generator=g, device=dev) / K ** 0.5
        w_bf16 = w32.to(torch.bfloat16)
        plan = [("decode", DECODE_TOKENS, "spread", torch.bfloat16),
                ("decode", DECODE_TOKENS, "spread", torch.float32),
                ("prefill", T_pre, "spread", torch.bfloat16),
                ("prefill", T_pre, "spread", torch.float32)]
        if label == "qwen2-moe/w_gate":
            plan += [("prefill", T_pre, "skewed", torch.bfloat16),
                     ("prefill", T_pre, "idle", torch.bfloat16)]
        for i, (phase, T, kind, dtype) in enumerate(plan):
            buf, srt, cnt = grouped_case(T, k, n, K, K5_BLOCK_M, dtype, dev,
                                         seed + i, kind)
            w = w_bf16 if dtype == torch.bfloat16 else w32
            args = (buf, w, srt.tile_expert, K5_BLOCK_M, srt.tile_rows)
            tag = f"K5 {label}/{phase}-{kind}/T={T}x{k}"
            got = grouped_matmul(*args)
            torch.cuda.synchronize()
            ref = grouped_matmul_reference(*args)
            err, judged = check_grouped(tag, got, ref, srt.Tp, N, dtype)
            ms = cuda_time_ms(lambda: grouped_matmul(*args))
            plain_ms = cuda_time_ms(lambda: grouped_matmul_reference(*args),
                                    iters=3, warmup=1, graph=False)
            lib = (library_grouped_mm(buf, w_bf16, cnt, K5_BLOCK_M)
                   if dtype == torch.bfloat16 else None)
            lib_ms = cuda_time_ms(lib) if lib is not None else None
            el = w.element_size()
            bound, by, nbytes, ops = grouped_bound(cnt, K, N, dtype,
                                                   K * N * el)
            rec = dict(case=f"{label}/{phase}-{kind}/T={T}x{k}",
                       dtype=str(dtype).replace("torch.", ""), Tp=srt.Tp,
                       routed_rows=T * k,
                       active_experts=int((cnt > 0).sum()),
                       max_abs_err=err, judged_err=judged,
                       tol=K2_TOL[dtype], ms=ms, plain_ms=plain_ms,
                       library_ms=lib_ms, bound_ms=bound, bound_by=by,
                       bytes=nbytes, ops=ops)
            results.append(rec)
            lib_txt = f"{lib_ms:.4f}" if lib_ms is not None else "none"
            log(f"[kernel] {tag:<44} {rec['dtype']:<8} err {judged:.2e} "
                f"(tol {K2_TOL[dtype]:.0e}; max abs {err:.2e})  kernel "
                f"{ms:.4f} ms  plain {plain_ms:.3f} ms  _grouped_mm "
                f"{lib_txt} ms  bound {bound:.4f} ms ({by})")
            del buf, srt, got, ref, args
        del w32, w_bf16
        free_cuda()
    counts.reset()
    return grouped_summary(results, "qwen2-moe/w_gate/decode-spread/T=8x4",
                           "bfloat16"), results


def grouped_summary(results, main_case, main_dtype) -> dict:
    """The record line's fields: the worst errors, and the times of the
    serving path's most frequent call (a decode step's w_gate product)."""
    bf = [r for r in results if r["dtype"] == "bfloat16"]
    fp = [r for r in results if r["dtype"] == "float32"]
    main = next(r for r in results if r["case"] == main_case
                and r["dtype"] == main_dtype)
    return dict(max_abs_err=max(r["max_abs_err"] for r in bf),
                max_err_over_max_ref=max(r["judged_err"] for r in bf),
                max_err_over_max_ref_fp32=max(r["judged_err"] for r in fp),
                **{k: main[k] for k in ("ms", "plain_ms", "library_ms",
                                        "bound_ms", "bound_by")})


def phase_k3(dev) -> tuple[dict, list]:
    """K3 against its plain version: int8, int4 and e4m3 codes at the MoE
    shapes, decode and prefill routings in bf16, skewed and idle-expert
    routings and fp32 x for int8, and stacked [L, n, ...] codes at a
    non-zero layer. Returns (summary, cases)."""
    from deepspeed_tpu_torch.ops.quant_matmul import (
        QuantGrouped, grouped_counts, quant_grouped_matmul,
        quant_grouped_matmul_reference, quantize_grouped)

    results = []

    def run(tag, buf, srt, cnt, qw, w_bf16, layer_index=None):
        n, K, N = qw.shape
        dtype = buf.dtype
        kw = dict(layer_index=layer_index, block_m=K3_BLOCK_M,
                  tile_rows=srt.tile_rows)
        got = quant_grouped_matmul(buf, qw, srt.tile_expert, **kw)
        torch.cuda.synchronize()
        ref = quant_grouped_matmul_reference(buf, qw, srt.tile_expert, **kw)
        err, judged = check_grouped(f"K3 {tag}", got, ref, srt.Tp, N, dtype)
        ms = cuda_time_ms(lambda: quant_grouped_matmul(
            buf, qw, srt.tile_expert, **kw))
        plain_ms = cuda_time_ms(lambda: quant_grouped_matmul_reference(
            buf, qw, srt.tile_expert, **kw), iters=3, warmup=1, graph=False)
        lib = library_grouped_mm(buf, w_bf16, cnt, K3_BLOCK_M)
        lib_ms = cuda_time_ms(lib) if lib is not None else None
        # one expert's codes and scales
        data, scale = qw.data, qw.scale
        if layer_index is not None:
            data, scale = data[layer_index], scale[layer_index]
        wbytes = data[0].numel() * data.element_size() + scale[0].numel() * 4
        bound, by, nbytes, ops = grouped_bound(cnt, K, N, dtype, wbytes)
        rec = dict(case=tag, bits=str(qw.bits),
                   dtype=str(dtype).replace("torch.", ""), Tp=srt.Tp,
                   active_experts=int((cnt > 0).sum()), max_abs_err=err,
                   judged_err=judged, tol=K2_TOL[dtype], ms=ms,
                   plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound,
                   bound_by=by, bytes=nbytes, ops=ops)
        results.append(rec)
        lib_txt = f"{lib_ms:.4f}" if lib_ms is not None else "none"
        log(f"[kernel] K3 {tag:<46} {rec['dtype']:<8} err {judged:.2e} "
            f"(tol {K2_TOL[dtype]:.0e}; max abs {err:.2e})  kernel "
            f"{ms:.4f} ms  plain {plain_ms:.3f} ms  bf16 _grouped_mm "
            f"{lib_txt} ms  bound {bound:.4f} ms ({by})")
        del got, ref
        return rec

    seed = 500
    for label, n, K, N, k, T_pre in GROUPED_SHAPES:
        seed += 10
        g = torch.Generator(device=dev).manual_seed(seed)
        w32 = torch.randn(n, K, N, generator=g, device=dev) / K ** 0.5
        w32 *= torch.empty(n, K, 1, device=dev).uniform_(
            -2, 2, generator=g).exp_()
        w_bf16 = w32.to(torch.bfloat16)
        for bits in (8, 4, "fp8"):
            qw = quantize_grouped(w32, bits=bits)
            plan = [("decode", DECODE_TOKENS, "spread", torch.bfloat16),
                    ("prefill", T_pre, "spread", torch.bfloat16)]
            if label == "qwen2-moe/w_gate" and bits == 8:
                plan += [("decode", DECODE_TOKENS, "spread", torch.float32),
                         ("prefill", T_pre, "skewed", torch.bfloat16),
                         ("prefill", T_pre, "idle", torch.bfloat16)]
            for i, (phase, T, kind, dtype) in enumerate(plan):
                buf, srt, cnt = grouped_case(T, k, n, K, K3_BLOCK_M, dtype,
                                             dev, seed + i, kind)
                run(f"{bits}/{label}/{phase}-{kind}/T={T}x{k}", buf, srt,
                    cnt, qw, w_bf16)
                del buf, srt
            del qw
            free_cuda()
        del w32, w_bf16
        free_cuda()
    # stacked [L, n, K, N] codes: one layer selected inside the kernel
    label, n, K, N, k, _ = GROUPED_SHAPES[0]
    L, li = 4, 2
    g = torch.Generator(device=dev).manual_seed(seed + 99)
    for bits in (8, 4):
        layers = [quantize_grouped(torch.randn(n, K, N, generator=g,
                                               device=dev), bits=bits)
                  for _ in range(L)]
        st = QuantGrouped(torch.stack([q.data for q in layers]),
                          torch.stack([q.scale for q in layers]), bits,
                          layers[0].group_size, layers[0].shape,
                          layers[0].dtype)
        buf, srt, cnt = grouped_case(DECODE_TOKENS, k, n, K, K3_BLOCK_M,
                                     torch.bfloat16, dev, seed + 7)
        w_bf16 = torch.randn(n, K, N, generator=g, device=dev,
                             dtype=torch.bfloat16)
        run(f"{bits}/{label}/stacked-L{L}-layer{li}/decode", buf, srt, cnt,
            st, w_bf16, layer_index=li)
        kw = dict(block_m=K3_BLOCK_M, tile_rows=srt.tile_rows)
        if not torch.equal(
                quant_grouped_matmul(buf, st, srt.tile_expert,
                                     layer_index=li, **kw),
                quant_grouped_matmul(buf, layers[li], srt.tile_expert,
                                     **kw)):
            raise AssertionError(f"K3 {bits}: stacked layer {li} differs "
                                 f"from the unstacked codes")
        del layers, st, buf, srt, w_bf16
        free_cuda()
    grouped_counts.reset()
    return grouped_summary(results,
                           "8/qwen2-moe/w_gate/decode-spread/T=8x4",
                           "bfloat16"), results


# ---------------------------------------------------------------------------
# phases 3 and 4: the engine
# ---------------------------------------------------------------------------

def tap_engine_class():
    """InferenceEngineV2 that keeps the logits of every sampled token, per
    request, in stream order (for the parity phase only)."""
    from deepspeed_tpu_torch.inference import InferenceEngineV2

    class TapEngine(InferenceEngineV2):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.taps: dict[int, list[torch.Tensor]] = {}
            self._rows = None

        def _program(self, plan):
            self._rows = lambda: [(r, u) for r, u in enumerate(plan.uids)
                                  if u >= 0 and plan.do_sample[r]]
            return super()._program(plan)

        def _window_program(self, W, tok0, pos0, lens0, tables, rem, eos):
            slot_uid = {sq.slot: u for u, sq in self.state.seqs.items()}
            it = iter(range(W))
            self._rows = lambda: (lambda i: [(sl, u) for sl, u in
                                             slot_uid.items()
                                             if rem[sl] > i])(next(it))
            return super()._window_program(W, tok0, pos0, lens0, tables,
                                           rem, eos)

        def _sample(self, logits):
            for r, u in self._rows():
                self.taps.setdefault(u, []).append(logits[r].float().cpu())
            return super()._sample(logits)

    return TapEngine


def all_counts() -> dict:
    """Every kernel wrapper's launch counts."""
    from deepspeed_tpu_torch.ops import grouped_matmul as gm
    from deepspeed_tpu_torch.ops import paged_attention as pa
    from deepspeed_tpu_torch.ops import quant_matmul as qm

    return {"k1": pa.counts.kernel, "k1_e4m3": pa.counts.kernel_e4m3,
            "k1_plain": pa.counts.plain, "k2": qm.counts.kernel,
            "k2_plain": qm.counts.plain, "k3": qm.grouped_counts.kernel,
            "k3_plain": qm.grouped_counts.plain, "k5": gm.counts.kernel,
            "k5_plain": gm.counts.plain}


def reset_counts() -> None:
    from deepspeed_tpu_torch.ops import grouped_matmul as gm
    from deepspeed_tpu_torch.ops import paged_attention as pa
    from deepspeed_tpu_torch.ops import quant_matmul as qm

    pa.counts.reset()
    qm.counts.reset()
    qm.grouped_counts.reset()
    gm.counts.reset()


def forwards_of(eng) -> int:
    st = eng.stats
    return st["prefill_steps"] + st["decode_steps"] + st["window_iters_max"]


def check_launches(tag, got: dict, cfg, *, forwards, e4m3_pool, quant):
    """Per forward: K1 (its default or e4m3 form) once per layer; when the
    weights are quantized, K2 once per dense weight product (q, k, v, o of
    every layer, a dense FFN's products, the unembedding) and K3 once per
    expert product of every MoE layer; K5 once per expert product under
    ``moe.dropless`` without quantization; no plain version at all."""
    from deepspeed_tpu_torch.models.transformer import is_moe_layer

    L = cfg.num_layers
    moe_layers = sum(is_moe_layer(cfg, i) for i in range(L))
    ffn = 3 if cfg.activation == "silu_glu" else 2
    dense = 4 * L + ffn * (L - moe_layers) + 1
    experts = ffn * moe_layers
    dropless = cfg.moe is not None and cfg.moe.dropless
    f = forwards
    want = {"k1": 0 if e4m3_pool else L * f,
            "k1_e4m3": L * f if e4m3_pool else 0, "k1_plain": 0,
            "k2": dense * f if quant else 0, "k2_plain": 0,
            "k3": experts * f if quant else 0, "k3_plain": 0,
            "k5": experts * f if dropless and not quant else 0,
            "k5_plain": 0}
    if forwards <= 0 or got != want:
        raise AssertionError(f"[{tag}] launches {got} != {want} "
                             f"({L} layers x {forwards} forwards)")


def oracle_check(tag, eng, oracle, prompts, streams, new, dev):
    """Each stream against a greedy loop over the dense ``oracle``: logits
    within 1e-3 relative, tokens equal except at near-ties (top-2 gap below
    1e-4). Returns (worst relative logits error, near-ties)."""
    worst, near_ties = 0.0, []
    with torch.no_grad():
        for uid, (prompt, got) in enumerate(zip(prompts, streams)):
            if len(got) != new:
                raise AssertionError(f"[{tag}] uid {uid}: {len(got)} tokens")
            seq = list(prompt)
            for k, tok in enumerate(got):
                ids = torch.tensor([seq], device=dev)
                ref = oracle(ids)[0, -1].float().cpu()
                top2 = torch.topk(ref, 2).values
                ours = eng.taps[uid][k]
                rel = ((ours - ref).abs().max() / ref.abs().max()).item()
                worst = max(worst, rel)
                if rel > 1e-3:
                    raise AssertionError(
                        f"[{tag}] uid {uid} step {k}: logits differ by "
                        f"{rel:.2e} relative (> 1e-3)")
                if int(ref.argmax()) != tok:
                    gap = (top2[0] - top2[1]).item()
                    if gap >= 1e-4:
                        raise AssertionError(
                            f"[{tag}] uid {uid} step {k}: engine token "
                            f"{tok} != oracle {int(ref.argmax())} (top-2 gap "
                            f"{gap:.3e})")
                    near_ties.append((uid, k, gap))
                    log(f"[{tag}] NEAR-TIE uid {uid} step {k}: oracle top-2 "
                        f"gap {gap:.2e} < 1e-4; streams part here by design")
                seq.append(tok)
    return worst, near_ties


def load_dequantized(model, params) -> None:
    """Overwrite ``model``'s matmul weights with ``dequantize_weight`` /
    ``dequantize_grouped`` of the engine's codes: the dense oracle of a
    quantized engine."""
    from deepspeed_tpu_torch.ops.quant_matmul import (
        QuantGrouped, QuantLinear, dequantize_grouped, dequantize_weight)

    with torch.no_grad():
        for name, p in model.named_parameters():
            node = params
            for part in name.split("."):
                node = node[part]
            if isinstance(node, QuantLinear):
                p.copy_(dequantize_weight(node).reshape(p.shape))
            elif isinstance(node, QuantGrouped):
                p.copy_(dequantize_grouped(node))


def no_drop_oracle(model) -> None:
    """Route ``model``'s MoE layers through the capacity route with an eval
    capacity factor of ``num_experts`` (capacity = tokens x k, so nothing
    drops) and not the dropless route: the oracle of an engine, which
    routes every token, independent of the grouped kernels."""
    from deepspeed_tpu_torch.moe import MoE

    for mod in model.modules():
        if isinstance(mod, MoE):
            mod.dropless, mod.drop_tokens = False, True
            mod.eval_capacity_factor = float(mod.num_experts)


#: the parity phase's models (full width, 4 layers) and the engine routes
#: each is held in: (label, engine options, MoE options)
PARITY = {
    "llama2-7b": (("dense", {}, {}), ("int8", {"quant_bits": 8}, {}),
                  ("int4", {"quant_bits": 4}, {}),
                  ("fp8-weights", {"quant_bits": "fp8"}, {}),
                  ("fp8-pool", {"kv_cache_dtype": "fp8"}, {})),
    "mixtral-8x7b": (("capacity", {}, {}),
                     ("dropless", {}, {"dropless": True}),
                     ("int8", {"quant_bits": 8}, {}),
                     ("int4", {"quant_bits": 4}, {}),
                     ("fp8-weights", {"quant_bits": "fp8"}, {})),
    "qwen2-moe-a2.7b": (("dropless", {}, {"dropless": True}),
                        ("int8", {"quant_bits": 8}, {})),
}


def phase_parity(dev) -> dict:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return {name: parity_model(dev, name, routes)
            for name, routes in PARITY.items()}


def parity_model(dev, name: str, routes) -> dict:
    from deepspeed_tpu_torch.models import build_model, get_model_config

    log(f"[parity] {name} full width, 4 layers, fp32; TF32 off for "
        f"matmuls and cuDNN")
    cfg = dict(block_size=64, num_blocks=64, max_seqs=4, chunk=128,
               max_seq_len=1024, decode_window=8, dtype=torch.float32,
               device=dev)
    vocab = get_model_config(name).vocab_size
    g = torch.Generator().manual_seed(0)
    lens = [300, 77, 150, 129, 200]            # chunks span pages
    prompts = [torch.randint(0, vocab, (n,), generator=g).tolist()
               for n in lens]
    new = 16
    out = {"prompts": lens, "new_tokens": new}
    dense_taps, dense_streams = None, None
    for label, over, moe_over in routes:
        tag = f"parity {name} {label}"
        mcfg = get_model_config(name)
        extra = ({"moe": dataclasses.replace(mcfg.moe, **moe_over)}
                 if moe_over else {})
        model = build_model(name, num_layers=4, dtype=torch.float32,
                            device=dev, seed=0, **extra)
        eng = tap_engine_class()(model, config=dict(cfg, **over))
        if eng._attn_decode_sel.path != "cuda":
            raise AssertionError(f"[{tag}] attention path "
                                 f"{eng._attn_decode_sel.path}, not the "
                                 f"kernel")
        reset_counts()
        streams = eng.generate(prompts, max_new_tokens=new)
        launches = all_counts()
        eng.state.audit()
        forwards = forwards_of(eng)
        L = model.config.num_layers
        check_launches(tag, launches, model.config, forwards=forwards,
                       e4m3_pool="kv_cache_dtype" in over,
                       quant="quant_bits" in over)
        rec = {"launches": launches, "forwards": forwards}
        if label == "fp8-pool":
            # against the fp32-pool engine, while the two streams agree
            diffs = []
            for uid in range(len(prompts)):
                for k in range(new):
                    diffs.append((eng.taps[uid][k]
                                  - dense_taps[uid][k]).abs())
                    if streams[uid][k] != dense_streams[uid][k]:
                        break
            d = torch.stack(diffs)
            rec.update(max_abs_logits_diff=d.max().item(),
                       mean_abs_logits_diff=d.mean().item(),
                       steps_compared=len(diffs),
                       streams_equal=streams == dense_streams)
            if rec["max_abs_logits_diff"] > 0.5 or \
                    rec["mean_abs_logits_diff"] > 0.05:
                raise AssertionError(f"[{tag}] logits off the fp32 pool's: "
                                     f"{rec}")
            log(f"[{tag}] e4m3 pool vs fp32 pool over {len(diffs)} sampled "
                f"steps: max |logits diff| {rec['max_abs_logits_diff']:.3e} "
                f"(tol 0.5), mean {rec['mean_abs_logits_diff']:.3e} (tol "
                f"0.05); streams equal: {rec['streams_equal']}; launches "
                f"{launches}")
        else:
            if "quant_bits" in over:
                load_dequantized(model, eng.params)
            no_drop_oracle(model)
            worst, near = oracle_check(tag, eng, model, prompts, streams,
                                       new, dev)
            rec.update(max_rel_logits_err=worst, near_ties=near)
            log(f"[{tag}] {len(prompts)} greedy streams x {new} tokens "
                f"identical to the dense oracle ({len(near)} near-ties); max "
                f"logits error {worst:.2e} relative; launches {launches} "
                f"({L} layers x {forwards} forwards)")
        if label == "dense":
            dense_taps, dense_streams = eng.taps, streams

        out[label] = rec
        del eng, model
        free_cuda()
    return out


def device_breakdown(run) -> dict:
    """Profile ``run()`` with torch.profiler and split the device's kernel
    time into K1, K2, matrix products and the rest, beside the host wall
    time (single stream, so busy time is the kernel time sum). Returns the
    numbers, or {"device": "not measured"} when the profiler saw no kernel
    time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name: dict[str, float] = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        by_name[e.key] = by_name.get(e.key, 0.0) + us / 1e3
    busy = sum(by_name.values())
    if busy <= 0:
        return {"device": "not measured", "wall_ms": wall_ms}

    def kind(name):
        low = name.lower()
        if "ragged_paged_attn" in low:
            return "k1_ms"
        if "qgmm_" in low:
            return "k3_ms"
        if "::gmm_" in low or low.startswith("gmm_"):
            return "k5_ms"
        if "qmm_" in low:
            return "k2_ms"
        if any(t in low for t in ("gemm", "xmma", "cutlass", "matmul",
                                  "nvjet")):
            return "gemm_ms"
        return "other_ms"

    out = {"wall_ms": wall_ms, "busy_ms": busy, "k1_ms": 0.0, "k2_ms": 0.0,
           "k3_ms": 0.0, "k5_ms": 0.0, "gemm_ms": 0.0, "other_ms": 0.0,
           "idle_share": max(0.0, 1 - busy / wall_ms)}
    for name, ms in by_name.items():
        out[kind(name)] += ms
    out["top"] = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return out


def serve_run(dev, name: str, label: str, layers: int | None = None,
              **over) -> dict:
    """Model ``name`` at full width (and ``layers`` deep, all of them by
    default) in bf16 from seeded random weights, serving the 8 requests of
    phase 4 under the engine options ``over``. An MoE model takes its
    dropless route (K5) unless ``quant_bits`` sends its experts through
    K3."""
    from deepspeed_tpu_torch.inference import InferenceEngineV2
    from deepspeed_tpu_torch.inference.weights import tree_nbytes
    from deepspeed_tpu_torch.models import build_model, get_model_config

    tag = f"serve {name} {label}"
    t0 = time.perf_counter()
    mcfg = get_model_config(name)
    extra = {} if layers is None else {"num_layers": layers}
    if mcfg.moe is not None:
        extra["moe"] = dataclasses.replace(mcfg.moe, dropless=True)
    model = build_model(name, dtype=torch.bfloat16, device=dev, seed=1,
                        **extra)
    cfg = model.config
    L, vocab = cfg.num_layers, cfg.vocab_size
    eng = InferenceEngineV2(model, config=dict(
        block_size=64, num_blocks=256, max_seqs=8, chunk=256,
        max_seq_len=2048, decode_window=8, dtype=torch.bfloat16,
        device=dev, **over))
    # the engine holds what it serves; the model's own weights that the
    # engine quantized go with it
    del model
    free_cuda()
    torch.cuda.synchronize()
    pool_bytes = eng.kv_pool.numel() * eng.kv_pool.element_size()
    param_bytes = tree_nbytes(eng.params)
    resident = torch.cuda.memory_allocated(dev) - pool_bytes
    log(f"[{tag}] {name} ({L} layers, bf16 compute, seeded random "
        f"weights, {over or 'no quantization'}) and a "
        f"{pool_bytes / 1e9:.1f} GB {eng.kv_pool.dtype} pool up in "
        f"{time.perf_counter() - t0:.1f}s; parameters "
        f"{param_bytes / 1e9:.2f} GB ({resident / 1e9:.2f} GB on the card "
        f"besides the pool); attention path {eng._attn_decode_sel.path}")
    if resident > 1.02 * param_bytes + (256 << 20):
        raise AssertionError(f"[{tag}] {resident / 1e9:.2f} GB stays on the "
                             f"card for {param_bytes / 1e9:.2f} GB of "
                             f"parameters")
    g = torch.Generator().manual_seed(1)
    system = torch.randint(0, vocab, (128,), generator=g).tolist()
    # a first request publishes the shared system prefix (and warms the
    # allocator and cuBLAS); the measured batch then hits it
    eng.generate([system + torch.randint(0, vocab, (64,),
                                         generator=g).tolist()],
                 max_new_tokens=8)
    lens = [256, 384, 512, 640, 768, 896, 1024, 300]
    prompts = [system + torch.randint(0, vocab, (n - 128,),
                                      generator=g).tolist() for n in lens]
    new = 64
    for k in list(eng.stats):
        eng.stats[k] = 0 if not isinstance(eng.stats[k], float) else 0.0
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for uid, p in enumerate(prompts):
        eng.put(uid, p, max_new_tokens=new)
    first: dict[int, float] = {}
    out: dict[int, list[int]] = {u: [] for u in range(len(prompts))}
    window_s = 0.0
    while any(not eng.query(u).get("done", True) for u in out):
        w0, ts = eng.stats["windows"], time.perf_counter()
        emitted = eng.step()
        dt = time.perf_counter() - ts
        if eng.stats["windows"] > w0:
            window_s += dt
        now = time.perf_counter() - t0
        for u, toks in emitted.items():
            if toks and u not in first:
                first[u] = now
            out[u].extend(toks)
    wall = time.perf_counter() - t0
    launches = all_counts()
    st = dict(eng.stats)
    window_iters = st["window_iters_max"]
    for u in out:
        if eng.flush(u) != out[u] or len(out[u]) != new:
            raise AssertionError(f"[{tag}] uid {u}: stream of {len(out[u])}")
        if not all(0 <= t < vocab for t in out[u]):
            raise AssertionError(f"[{tag}] uid {u}: token out of range")
    eng.state.audit()
    forwards = forwards_of(eng)
    check_launches(tag, launches, cfg, forwards=forwards,
                   e4m3_pool=over.get("kv_cache_dtype") == "fp8",
                   quant=bool(over.get("quant_bits")))
    if st["prefix_hit_tokens"] < 128 * len(prompts):
        raise AssertionError(f"[{tag}] prefix cache served "
                             f"{st['prefix_hit_tokens']} tokens")
    # where the device time goes: one profiled decode window (8 requests
    # of 16 new tokens past a shared-prefix prompt), separate from the
    # timed run above
    short = [system + torch.randint(0, vocab, (64,), generator=g).tolist()
             for _ in range(8)]
    for uid, p in enumerate(short):
        eng.put(100 + uid, p, max_new_tokens=16)
    while any(eng.state.seqs[100 + u].pending_sched > 1 for u in range(8)):
        eng.step()                  # prefill; the next dispatch is a window
    iters0 = eng.stats["window_iters_max"]
    prof = device_breakdown(eng.step)
    prof["window_iters"] = eng.stats["window_iters_max"] - iters0
    while any(not eng.query(100 + u).get("done", True) for u in range(8)):
        eng.step()
    for uid in range(8):
        eng.flush(100 + uid)
    if "busy_ms" in prof:
        log(f"[{tag}] one profiled decode window ({prof['window_iters']} "
            f"iterations x 8 slots): wall "
            f"{prof['wall_ms']:.2f} ms, device busy {prof['busy_ms']:.2f} "
            f"ms (idle share {prof['idle_share']:.2f}): K1 "
            f"{prof['k1_ms']:.2f} ms, K2 {prof['k2_ms']:.2f} ms, K3 "
            f"{prof['k3_ms']:.2f} ms, K5 {prof['k5_ms']:.2f} ms, matrix "
            f"products {prof['gemm_ms']:.2f} ms, other kernels "
            f"{prof['other_ms']:.2f} ms")
        for name, ms in prof["top"]:
            log(f"[{tag}]   {ms:8.3f} ms  {name[:100]}")
    else:
        log(f"[{tag}] profiled decode window: device time not measured "
            f"(wall {prof['wall_ms']:.2f} ms)")
    res = {"options": over, "requests": len(prompts),
           "prompt_tokens": sum(lens), "new_tokens": new, "wall_s": wall,
           "output_tok_s": len(prompts) * new / wall,
           "ttft_p50_s": statistics.median(first.values()),
           "ttft_max_s": max(first.values()),
           "decode_ms_per_token": 1e3 * window_s / max(window_iters, 1),
           "window_iters": window_iters,
           "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
           "param_bytes": param_bytes, "resident_param_bytes": resident,
           "pool_bytes": pool_bytes, "launches": launches,
           "forwards": forwards, "stats": st, "profiled_window": prof}
    log(f"[{tag}] {len(prompts)} requests ({sum(lens)} prompt tokens, "
        f"{st['prefix_hit_tokens']} from the prefix cache) x {new} new "
        f"tokens in {wall:.2f}s: {res['output_tok_s']:.1f} output tok/s, "
        f"p50 TTFT {res['ttft_p50_s']:.3f}s, decode "
        f"{res['decode_ms_per_token']:.2f} ms/token-step over "
        f"{window_iters} window iterations, peak memory "
        f"{res['peak_mem_gb']:.1f} GB")
    log(f"[{tag}] launches {launches} for {L} layers x {forwards} forwards "
        f"({st['prefill_steps']} prefill steps, {st['decode_steps']} decode "
        f"steps, {st['window_iters_max']} window iterations)")
    del eng
    free_cuda()
    return res


#: the serve phase's models: (preset, depth — None serves every layer —,
#: the most parameter bytes the int8 and the int4 run may hold against the
#: bf16 run's). qwen2-moe keeps its shared expert and embedding in bf16,
#: so its quantized runs hold more than llama2-7b's (by arithmetic 0.545x
#: and 0.323x)
SERVE = (("llama2-7b", None, 0.55, 0.30),
         ("qwen2-moe-a2.7b", None, 0.56, 0.34))


def phase_serve(dev) -> dict:
    out = {}
    for name, layers, lim8, lim4 in SERVE:
        runs = {"bf16": serve_run(dev, name, "bf16", layers),
                "int8+fp8-pool": serve_run(dev, name, "int8+fp8-pool",
                                           layers, quant_bits=8,
                                           kv_cache_dtype="fp8"),
                "int4": serve_run(dev, name, "int4", layers, quant_bits=4)}
        base = runs["bf16"]["param_bytes"]
        for label, limit in (("int8+fp8-pool", lim8), ("int4", lim4)):
            ratio = runs[label]["param_bytes"] / base
            runs[label]["param_bytes_over_bf16"] = ratio
            log(f"[serve] {name} {label}: parameter bytes {ratio:.3f}x the "
                f"bf16 run's (limit {limit})")
            if ratio > limit:
                raise AssertionError(f"[serve] {name} {label} keeps "
                                     f"{ratio:.3f}x the bf16 parameter "
                                     f"bytes (> {limit})")
        out[name] = runs
    return out


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------

def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default=",".join(ALL_PHASES),
                    help="comma-separated subset of " + ",".join(ALL_PHASES))
    ap.add_argument("--out", default="chiprun_out",
                    help="directory for the full JSON record")
    args = ap.parse_args()
    phases = [p for p in args.phases.split(",") if p]
    bad = set(phases) - set(ALL_PHASES)
    if bad:
        ap.error(f"unknown phases {sorted(bad)}")
    if not torch.cuda.is_available():
        log("no CUDA device: this smoke run needs one NVIDIA GPU")
        return 2
    from deepspeed_tpu_torch.accelerator import (card_name_and_power_limit,
                                                 get_device)

    dev = get_device()
    card = card_name_and_power_limit()
    log(f"[device] {torch.cuda.get_device_name(0)} | {card} | torch "
        f"{torch.__version__} cuda {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    record: dict = {"card": card, "phases": {}}
    k1 = {"name": "paged_ragged_attention", "route": "cuda",
          "source": "deepspeed_tpu_torch/ops/csrc/paged_attention.cu",
          "replaces": "deepspeed_tpu/ops/pallas/paged_attention.py:137",
          "launches": None}
    k1_e4m3 = {"name": "paged_ragged_attention (e4m3 pool)", "route": "cuda",
               "source": "deepspeed_tpu_torch/ops/csrc/paged_attention.cu",
               "replaces": "deepspeed_tpu/ops/pallas/paged_attention.py:517",
               "launches": None}
    k2 = {"name": "quant_matmul", "route": "cuda",
          "source": "deepspeed_tpu_torch/ops/csrc/quant_matmul.cu",
          "replaces": "deepspeed_tpu/ops/pallas/quant_matmul.py:136",
          "launches": None, "library_ms": None}
    k3 = {"name": "quant_grouped_matmul", "route": "cuda",
          "source": "deepspeed_tpu_torch/ops/csrc/quant_matmul.cu",
          "replaces": "deepspeed_tpu/ops/pallas/quant_matmul.py:455",
          "launches": None}
    k5 = {"name": "grouped_matmul", "route": "cuda",
          "source": "deepspeed_tpu_torch/ops/csrc/grouped_matmul.cu",
          "replaces": "deepspeed_tpu/ops/pallas/grouped_matmul.py:51",
          "launches": None}
    built = phase_build()          # every later phase runs the kernels
    record["phases"]["build"] = {n: r["seconds"] for n, r in built.items()}
    if "kernel" in phases:
        default, e4m3, cases = phase_k1(dev)
        k1.update(default)
        k1_e4m3.update(e4m3)
        k2_summary, k2_cases = phase_k2(dev)
        k2.update(k2_summary)
        k5_summary, k5_cases = phase_k5(dev)
        k5.update(k5_summary)
        k3_summary, k3_cases = phase_k3(dev)
        k3.update(k3_summary)
        record["phases"]["kernel"] = {"k1": cases, "k2": k2_cases,
                                      "k3": k3_cases, "k5": k5_cases}
    if "parity" in phases:
        record["phases"]["parity"] = phase_parity(dev)
    if "serve" in phases:
        serve = phase_serve(dev)
        record["phases"]["serve"] = serve
        # each kernel's launches summed over the serve runs (each run's
        # counts start at 0)
        runs = [run for model in serve.values() for run in model.values()]
        for rec, key in ((k1, "k1"), (k1_e4m3, "k1_e4m3"), (k2, "k2"),
                         (k3, "k3"), (k5, "k5")):
            rec["launches"] = sum(run["launches"][key] for run in runs)
    record["seconds"] = time.perf_counter() - t_start
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "chip_smoke.json"), "w") as f:
        json.dump(record, f, indent=1, default=str)
    log(f"[done] {record['seconds']:.1f}s")
    log(json.dumps({"kernels": [k1, k1_e4m3, k2, k3, k5]}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
