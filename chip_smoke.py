"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py [--phases build,kernel,parity,serve,train-parity,
                           train,moe-train-parity,moe-train,sparse]
                          [--out DIR]

Phases (every one raises on failure; nothing is caught and passed over):

1. build  — compile every CUDA kernel of the port from ``ops/csrc`` with
   nvcc for sm_90a, all sources at once, and print the build times.
2. kernel — hold each kernel against its plain PyTorch version on the card
   at the serving and training paths' shapes, and time the kernel, the
   plain version, a PyTorch yardstick and the kernel's bound:
   - K1, the paged-attention kernel (llama2-7b geometry and a GQA geometry;
     decode, a 256-token prefill chunk over several pool pages, a
     window-shaped stage; an empty slot and trash-padded block tables), in
     fp32 (max absolute error 1e-4) and bf16 (max absolute error over max
     |plain| 1e-2: p is rounded to bf16 before the PV product, in a
     different order than the plain version's). q is drawn at 3x the keys'
     spread so the softmax is peaked and a wrong score shows in the output.
     Yardstick: one ``scaled_dot_product_attention`` call over the same K/V
     gathered dense.
   - K1's sliding-window, rolling-ring and tree-verify forms, in fp32, bf16
     and over an e4m3 pool with the same tolerances, judged on live slots:
     a decode-window step (8 slots, one empty) and a 256-token prefill
     chunk at mistral-7b geometry (H 32, KV 8, D 128) over ~6000-token
     contexts with the 4096-key window, on a linear table and on a wrapped
     69-page ring; tree verify of an 8-node branchy tree at llama2-7b (G 1)
     and mistral (G 4) geometry. Each is counted as its form. The bound
     counts only the keys some query row sees (inside the window or ring);
     the SDPA yardstick gets an explicit boolean mask of who sees what.
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
   - K5's backward, dx and dw, in bf16 and fp32, on qwen2-moe's expert
     w_gate and w_down at one micro-batch of the moe-train phase (2 x 2048
     tokens x top-4: 16384 routed rows, Tp 24064) and Mixtral's w_gate at
     512 x 2, under uniform, skewed (every token on 4 experts) and
     idle-expert routings; judged by ``K2_TOL``. Bound: dx reads the
     routed dy rows and each active expert's weights and writes the routed
     dx rows; dw reads the routed x and dy rows and writes every expert's
     [K, N]; 2 x routed rows x K x N operations. Yardsticks:
     ``torch._grouped_mm`` in bf16 (dx a 2d x 3d call with w transposed,
     dw the 2d x 2d call ragged over rows), and its forward + backward
     through autograd beside K5's forward + dx + dw.
   - K4, flash attention, forward (out and lse) and backward (dq, dk, dv
     from the plain forward's out and lse), in fp32 and bf16, at llama2-7b
     geometry (H = KV = 32, D = 128) at S = 1024 (where the Pallas
     backward is one block), 2048 (the train phase's shape) and 4096,
     mistral-7b's GQA (KV 8) at 2048, gpt2-1.3b's D = 64 at 1024, and a
     non-causal call; B = 1-4. Tolerances ``K4_TOL``: fp32 output by max
     |error| 1e-4, fp32 grads by max |error| over max |plain| 1e-3, bf16
     everything by max |error| over max |plain| 2e-2. Bound: the
     causally visible pairs' operations (4 x pairs x D forward, 10 x
     pairs x D backward) over 989 TFLOP/s (bf16) or 67 (fp32), against
     the bytes over 3.35 TB/s. Yardstick: one
     ``scaled_dot_product_attention(is_causal=...)`` call over K/V
     repeated per q head, forward and forward + backward. Each case
     prints the kernel's ms, TFLOP/s (the counted operations over its
     time) and share of the bound beside SDPA, and the host µs the bf16
     wrapper spent encoding its TMA tensor maps; the phase first prints
     the bf16 tensor-core kernels' registers, stack, spills (from the
     build's ``-Xptxas -v``) and dynamic shared memory.
   - K6, block-sparse flash attention, forward (out and lse), dq and dk/dv
     (each timed alone and together), in bf16 and fp32, q at 3x the keys'
     spread: at bert-large-uncased width (H 16, D 64, B 2, S 4096, block
     128) under the Fixed, per-head BigBird, BSLongformer and Variable
     configs; at llama2-7b width (H 32, D 128, B 1, S 8192) under Fixed
     unidirectional with causal masking; a dense causal layout at K4's
     train shape (B 2, S 2048), also timed through K4; a random layout
     with an empty query row and a row that sees only a block above the
     diagonal (their outputs and dq must be 0); blocks of 256 (S 4096)
     and 192 (S 3072). Tolerances ``K4_TOL``. Bound: K4's, over the
     visible token pairs of the layout. Yardstick: one
     ``scaled_dot_product_attention`` call with the boolean token mask
     ``[1, H, S, S]``, forward and forward + backward (bf16).
   - K7, the per-layer-slice paged attention over separate K/V pools, in
     fp32 and bf16 by ``K1_TOL`` with an empty slot and trash-padded
     tables: llama2-7b geometry (block 64) decode of 8 slots at 256-4000
     context and a 4 x 256 prefill chunk over 0-768 context; mistral-7b
     geometry with its 4096 window on a linear table and on a wrapped
     69-page ring, decode and a 4 x 256 chunk. Bound: q, the output and
     the K/V rows some query row sees. Yardstick: SDPA over the gathered
     K/V with the boolean mask of who sees what.
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
   the dequantized codes for the quantized routes. Then mistral-7b (4
   layers) served from its 69-page rolling ring: prompts of 4600 and 4700
   tokens (past the 4416-token ring) and 300, 32 new tokens, against the
   dense forward (which masks the window) under the same rule, and an
   e4m3-pool ring within the fp8 bound. Then llama2-7b (4 layers) with
   ``spec_decode``: "ngram" over motif prompts, "draft" with a same-weights
   draft (acceptance must exceed 0.9) and a differently seeded one, each
   stream identical to the spec-off engine's (a parting is allowed only at
   a near-tie of the dense model, as above); spec on a windowed model must
   raise ValueError. Each run asserts its K1 / K2 / K3 / K5 launches — K1's
   window and ring forms on every ring-served call, its tree form once per
   layer of every verify — and 0 plain launches.
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
   0.56x and 0.34x of the bf16 parameter bytes. Then mistral-7b at full
   width and depth from its rolling ring (block 64, max_seq_len 8192,
   chunk 256, prefix cache off): 8 requests of 64 new tokens, 4 with
   4608-6144-token prompts and 4 with 256-1024, in bf16 and with
   ``kv_cache_dtype="fp8"``; each asserts that the ring wrapped and that
   no sequence owned more than its 69 pages. Then llama2-7b at full depth
   on motif prompts: spec-off, ``spec_decode="ngram"`` and "draft" with the
   model itself as the draft (at least one verify), printing verify
   rounds, acceptance, tokens per verify and K1's tree launches beside the
   spec-off run's tok/s and TTFT. Prompt lookup proposes only where a
   stream repeats its history; the random 32-layer model's greedy streams
   need not, so the "ngram" run's rounds are reported, not required (the
   4-layer parity model's are). Acceptance is held to 0.9 in the fp32
   parity phase only: in bf16 the draft's one-token decode and the
   target's 8-node verify round near-ties of the random model's flat
   logits differently.

5. train-parity — llama2-7b's width at 4 layers in fp32 (TF32 off), S =
   1024, 1 x 2 sequences, 3 AdamW steps from one seeded init and batch,
   trained through ``deepspeed_tpu_torch.initialize`` once with
   ``attn_impl="pallas"`` (K4) and once with ``"xla"`` (the plain route):
   losses within 1e-5 relative, parameters within 1e-4 of max |param|.
6. train — llama2-7b's width (E 4096, H 32, D 128, F 11008, vocab 32000)
   at 8 layers (~1.9 B parameters; the full depth with Adam needs ~112 GB
   and waits for offload) from seeded random fp32 weights: bf16 with an
   fp32 master, AdamW, micro-batch 2 x gas 2 of 2048 tokens, remat
   "full", 5 steps on a repeated batch. Every loss finite and the last
   below the first; K4's forward launched layers x micro-batches x 2 per
   step (remat runs each layer's forward again), its backward layers x
   micro-batches, no plain version and no other kernel. Prints tokens/s,
   ms per step, peak memory and K4's share of a profiled step.
7. moe-train-parity — qwen2-moe-a2.7b's width at 2 layers in fp32 (TF32
   off), ``moe.dropless``, 1 x 2 x 1024 tokens, 3 AdamW steps from one
   seeded init and batch, trained once through K5's kernels (forward, dx,
   dw) and once through its plain versions on the card: losses within
   1e-6 relative, parameters within 1e-4 of max |param|, the runs'
   parameter changes within 1e-2 of the largest change.
8. moe-train — qwen2-moe-a2.7b's width (E 2048, 60 experts top-4 of 1408,
   shared expert 5632, vocab 151936) at 4 layers (~2.9 B parameters; its
   24 layers with Adam need ~230 GB), ``moe.dropless``, bf16 with an fp32
   master, AdamW, micro 2 x gas 2 x 2048 tokens, remat "full", 5 steps on
   a repeated batch: losses finite and falling; K5's forward launched 240
   times (3 products x 4 layers x 2 micro-batches x 2 under remat x 5
   steps), dx and dw 120 each, K4 80 / 40, nothing else. Prints ms per
   step, tokens/s, peak memory and a profiled step's split into K4, K5
   forward / dx / dw, cuBLAS, other and idle share.

9. sparse — ``SparseSelfAttention`` end to end: the Fixed, per-head
   BigBird, BSLongformer, Variable and Fixed-unidirectional (causal)
   configs at block 128, each at bert-large width (B 2, S 4096) and
   llama2-7b width (B 1, S 8192), bf16, forward and ``.backward()`` of a
   sum-of-squares loss, one warm-up and 5 timed iterations: K6's forward
   and backward launched 6 times each, nothing plain and no other kernel.
   Prints ms per forward + backward, tokens/s, peak memory and
   ``sparsity()``. Then fp32 parity at S 2048 (BigBird at bert width,
   Fixed unidirectional at llama width): output and q/k/v gradients
   through K6 against the plain route on the card, by the fp32
   ``K4_TOL``. K6's launches in the record line are this phase's; K7 has
   no caller on any path, so its launches are the kernel phase's checked
   calls.

The serving parity phase's dense oracles pass ``attn_impl="xla"``, so they
stay independent of the kernels under test.

The last lines are the kernels' JSON record, the card's name and power
limit, and ``{"ok": true, "device": {...}}``. Without a CUDA device the
script exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import math
import os
import statistics
import sys
import time

import torch

#: H100 SXM peaks (NVIDIA data sheet; dense, at the full 700 W limit)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12,
            torch.float8_e4m3fn: 1979e12}

ALL_PHASES = ("build", "kernel", "parity", "serve", "train-parity", "train",
              "moe-train-parity", "moe-train", "sparse")

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

def ptxas_entries(text: str) -> dict:
    """``{mangled entry: {"regs", "stack", "spill_stores", "spill_loads",
    "wgmma_serialized"}}`` from ``nvcc -Xptxas -v`` output (the last is
    True where ptxas says it serialized the entry's wgmma instructions)."""
    import re

    out, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"wgmma\.mma_async instructions are serialized.*"
                      r"function '(\S+?)'", line)
        if m:
            out.setdefault(m.group(1), {})["wgmma_serialized"] = True
            continue
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = out.setdefault(m.group(1), {})
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["regs"] = int(m.group(1))
    return out


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
            window=False, nb=256, L=2, e4m3=False, sliding=None,
            ring_pages=None):
    """Inputs for one K1 case: ``ctx`` lists each slot's pool context
    (positions below stage_starts), -1 for an empty slot. Each live slot's
    stage holds its fresh rows: a ragged prefill chunk, the one decode
    token, or (``window``) 1-8 rows of a decode window whose query is the
    last of them. ``e4m3`` casts the pool to e4m3 codes. ``sliding`` adds a
    sliding window of that many keys; ``ring_pages`` makes each table a
    rolling ring of that many pages (``ring_tokens`` = pages x bs)."""
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
    max_pages = ring_pages or max(-(-(c + Ts) // bs) for c in ctx) + 2
    tables = torch.zeros(S, max_pages, dtype=torch.int32)   # trash-padded
    lens, qst, sst = [], [], []
    perm = torch.randperm(nb - 1, generator=torch.Generator().manual_seed(
        seed)) + 1
    used = 0
    for s, c in enumerate(ctx):
        if c < 0:                                  # empty slot
            lens.append(0), qst.append(0), sst.append(0)
            continue
        n_pages = ring_pages or -(-(c + Ts) // bs)
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
                layer_index=L - 1, window=sliding,
                ring_tokens=ring_pages * bs if ring_pages else None)


#: the verify trees of the K1 tree cases: a root with two children, each
#: with two, then a chain — 8 nodes, depth 3 (the engine's spec_max_nodes)
TREE_PARENTS = (-1, 0, 0, 1, 1, 2, 3, 6)


def k1_tree_case(name, *, ctx, dtype, dev, seed, e4m3, **geom):
    """Tree verify over ``ctx`` committed tokens per slot (-1: empty): the
    8 nodes of ``TREE_PARENTS`` at positions root + depth, the ancestors
    mask, seq_lens = root + 1 + max depth (the engine's)."""
    T = len(TREE_PARENTS)
    case = k1_case(name, bs=64, T=T, Ts=T, ctx=ctx, dtype=dtype, dev=dev,
                   seed=seed, e4m3=e4m3, **geom)
    depth = [0] * T
    for i, p in enumerate(TREE_PARENTS):
        if p >= 0:
            depth[i] = depth[p] + 1
    S = len(ctx)
    pos = torch.zeros(S, T, dtype=torch.int32)
    mask = torch.zeros(S, T, T, dtype=torch.uint8)
    lens = torch.zeros(S, dtype=torch.int32)
    for s, c in enumerate(ctx):
        mask[s] = torch.eye(T, dtype=torch.uint8)
        if c < 0:
            continue
        pos[s] = torch.tensor([c + d for d in depth])
        for i in range(T):
            j = i
            while j >= 0:
                mask[s, i, j] = 1
                j = TREE_PARENTS[j]
        lens[s] = c + 1 + max(depth)
    case.update(seq_lens=lens.to(dev), q_starts=pos[:, 0].contiguous().to(
        dev), tree_positions=pos.to(dev), tree_mask=mask.to(dev))
    return case


def k1_options(case) -> dict:
    """The K1 options a case carries (window, ring, tree inputs)."""
    return {k: case[k] for k in ("window", "ring_tokens", "tree_positions",
                                 "tree_mask") if case.get(k) is not None}


def k1_visibility(case):
    """(key positions [S, C], visibility [S, T, C]) of the case's pool
    columns then stage rows: the plain version's own rule."""
    from deepspeed_tpu_torch.ops.paged_attention import key_visibility

    q = case["q"]
    cpos, _, mask = key_visibility(
        case["block_tables"], case["seq_lens"], case["q_starts"],
        case["stage_starts"], T=q.shape[1], Ts=case["k_stage"].shape[2],
        block_size=case["block_size"], **k1_options(case))
    # a slot with seq_lens 0 is empty: the kernel reads nothing for it
    return cpos, mask & (case["seq_lens"] > 0)[:, None, None]


def k1_work(case) -> tuple[float, float, float]:
    """(bytes, operations, seconds the operations need at the card's peak)
    on this case's data: q and the output once, and each K/V row that some
    query row of its slot sees (pool and stage; inside the window or ring)
    once per KV head; two multiply-adds per visible (query, key) pair and
    head dim element, the pool's at the e4m3 rate for an e4m3 pool."""
    q, pool = case["q"], case["pool"]
    S, T, H, D = q.shape
    KV = pool.shape[2]
    G = H // KV
    ctx = case["block_tables"].shape[1] * case["block_size"]
    el, pel = q.element_size(), pool.element_size()
    _, mask = k1_visibility(case)
    seen = mask.any(dim=1)                                   # [S, C]
    pool_keys = int(seen[:, :ctx].sum())
    stage_keys = int(seen[:, ctx:].sum())
    nbytes = 2 * q.numel() * el + 2 * KV * D * (pool_keys * pel
                                                + stage_keys * el)
    pairs_pool = int(mask[:, :, :ctx].sum()) * G * KV
    pairs_stage = int(mask[:, :, ctx:].sum()) * G * KV
    ops = 4.0 * D * (pairs_pool + pairs_stage)
    secs = 4.0 * D * (pairs_pool / PEAK_OPS[pool.dtype]
                      + pairs_stage / PEAK_OPS[q.dtype])
    return float(nbytes), ops, secs


def k1_library_call(case):
    """One scaled_dot_product_attention call over the case's K/V gathered
    dense (every pool column in table order, then the stage; an e4m3 pool
    upcast to q's dtype) with an explicit boolean mask of who sees what,
    timed as a yardstick beside the kernel."""
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
    _, mask = k1_visibility(case)
    mask = mask[:, None]                                  # [S, 1, T, C]
    qh = q.permute(0, 2, 1, 3)
    return lambda: F.scaled_dot_product_attention(qh, k, v, attn_mask=mask)


def bound_of(nbytes: float, ops_seconds: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops_seconds * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def k1_run_case(case, form: str, plain_graph: bool = True) -> dict:
    """Hold one K1 case against the plain version and time it: the kernel
    must be counted once, for its pool and ``form`` ("default", or the
    option it takes: "window", "ring", "tree"), with no plain launch; empty
    slots must be zeros; live slots are judged by the tolerances above (fp32
    by max |error|, bf16 over max |plain|, an e4m3 pool also by mean |error|
    over mean |plain|, p rounded against the kernel's 64-key walk). Then
    the kernel, the plain version (without a CUDA graph where its
    temporaries are large) and the SDPA yardstick are timed. Returns the
    record; raises past the tolerance."""
    from deepspeed_tpu_torch.ops.paged_attention import (
        KERNEL_KEY_TILE, counts, paged_ragged_attention,
        paged_ragged_attention_reference)

    label, dtype = case["name"], case["q"].dtype
    e4m3 = case["pool"].dtype == torch.float8_e4m3fn
    args = [case[k] for k in ("q", "pool", "k_stage", "v_stage",
                              "block_tables", "seq_lens", "q_starts",
                              "stage_starts")]
    kw = dict(block_size=case["block_size"], layer_index=case["layer_index"],
              **k1_options(case))
    ref_kw = dict(kw, p_round_blocks=(KERNEL_KEY_TILE, KERNEL_KEY_TILE))
    before = dict(vars(counts))
    got = paged_ragged_attention(*args, **kw)
    torch.cuda.synchronize()
    bumped = {k for k, v in vars(counts).items() if v != before[k]}
    want = {"kernel_e4m3" if e4m3 else "kernel"} | (
        {f"kernel_{form}"} if form != "default" else set())
    if form == "ring":
        want.add("kernel_window")            # a ring runs with its window
    if bumped != want:
        raise AssertionError(f"K1 {label}: counted {sorted(bumped)}, not "
                             f"{sorted(want)}")
    ref = paged_ragged_attention_reference(*args, **ref_kw)
    live = case["seq_lens"] > 0
    if (~live).any() and got[~live].abs().max().item() != 0.0:
        raise AssertionError(f"{label}: empty slot not 0")
    if not torch.isfinite(got).all():
        raise AssertionError(f"{label}: non-finite output")
    diff = (got[live].float() - ref[live].float()).abs()
    err = diff.max().item()
    max_ref = ref[live].float().abs().max().item()
    judged_mean, tol_mean = None, None
    if e4m3:
        judged = err / max_ref
        judged_mean = (diff.mean() / ref[live].float().abs().mean()).item()
        tol, tol_mean = K1_E4M3_TOL[dtype]
        ok = judged <= tol and judged_mean <= tol_mean
    else:
        judged = err if dtype == torch.float32 else err / max_ref
        tol = K1_TOL[dtype]
        ok = judged <= tol
    if not ok:
        raise AssertionError(
            f"K1 {label} {dtype}: kernel against plain error {judged:.3e} "
            f"(tol {tol:.0e}), mean {judged_mean} (tol {tol_mean}); max abs "
            f"{err:.3e}")
    ms = cuda_time_ms(lambda: paged_ragged_attention(*args, **kw))
    plain_ms = cuda_time_ms(
        lambda: paged_ragged_attention_reference(*args, **ref_kw),
        iters=3 if plain_graph else 2, warmup=1, graph=plain_graph)
    lib_ms = cuda_time_ms(k1_library_call(case), iters=5, warmup=1)
    nbytes, ops, ops_s = k1_work(case)
    bound, by = bound_of(nbytes, ops_s)
    pool = "e4m3" if e4m3 else ("fp32" if dtype == torch.float32 else "bf16")
    rec = dict(case=label, form=form, pool=pool,
               dtype=str(dtype).replace("torch.", ""), max_abs_err=err,
               judged_err=judged, judged_mean_err=judged_mean,
               max_abs_ref=max_ref, tol=tol, tol_mean=tol_mean, ms=ms,
               plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound,
               bound_by=by, bytes=nbytes, ops=ops)
    mean_txt = (f", mean {judged_mean:.2e} (tol {tol_mean:.0e})"
                if e4m3 else "")
    log(f"[kernel] K1 {label:<42} {rec['dtype']:<8} err {judged:.2e} (tol "
        f"{tol:.0e}{mean_txt}; max abs {err:.2e} of max |plain| "
        f"{max_ref:.2f})  kernel {ms:.4f} ms  plain {plain_ms:.3f} ms  sdpa "
        f"{lib_ms:.3f} ms  bound {bound:.4f} ms ({by})")
    return rec


def k1_summary(results, main_case: str) -> dict:
    """The record line's fields for a group of K1 cases: the worst errors
    in bf16 and fp32, and the times of ``main_case`` in bf16."""
    bf = [r for r in results if r["dtype"] == "bfloat16"]
    main = next(r for r in bf if r["case"] == main_case)
    return dict(max_abs_err=max(r["max_abs_err"] for r in bf),
                max_err_over_max_ref=max(r["judged_err"] for r in bf),
                max_abs_err_fp32=max(r["max_abs_err"] for r in results
                                     if r["dtype"] == "float32"),
                **{k: main[k] for k in ("ms", "plain_ms", "library_ms",
                                        "bound_ms", "bound_by")})


def phase_k1(dev) -> tuple[dict, dict, list]:
    """K1 in its default form and its e4m3-pool form against the plain
    version. Returns (default-form summary, e4m3-form summary, cases)."""
    from deepspeed_tpu_torch.ops.paged_attention import counts

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
        results.append(k1_run_case(case, "default"))
        del case
    counts.reset()
    # each pool at the serving path's most frequent shape: a bf16
    # decode-window step of llama2-7b geometry
    main = "llama2-7b/window"
    return (k1_summary([r for r in results if r["pool"] != "e4m3"], main),
            k1_summary([r for r in results if r["pool"] == "e4m3"],
                       main + "/e4m3-pool"), results)


#: mistral-7b's attention geometry and its window; the serve phase's ring
#: (block 64, chunk 256, decode window 8): ceil((4096 + 256) / 64) + 1
MISTRAL = dict(H=32, KV=8, D=128)
MISTRAL_WINDOW, MISTRAL_RING_PAGES = 4096, 69


def phase_k1_forms(dev) -> tuple[dict, list]:
    """K1's sliding-window, rolling-ring and tree-verify forms against the
    plain version, in fp32, bf16 and over an e4m3 pool (the tolerances of
    phase_k1, judged on live slots). Returns ({form: summary}, cases)."""
    from deepspeed_tpu_torch.ops.paged_attention import counts

    # ~6000-token contexts: past the 4096-key window and past the 4416-token
    # ring (wrapped), as the mistral serve's long prompts reach them
    decode_ctx = [5800, 5905, 6000, 6100, 5999, 6050, 5877, -1]
    chunk_ctx = [5632, 5760, 5888, 6016]
    tree_ctx = [256, 397, 512, 611, 700, 833, 1022, -1]
    shapes = {"decode": dict(T=1, Ts=8, window=True, ctx=decode_ctx),
              "prefill256": dict(T=256, Ts=256, ctx=chunk_ctx)}
    plan = []
    for pool in ("fp32", "bf16", "e4m3"):
        for sname in shapes:
            plan.append(("window", "mistral-7b", sname, pool))
            plan.append(("ring", "mistral-7b", sname, pool))
        for gname in ("llama2-7b", "mistral-7b"):
            plan.append(("tree", gname, "verify-T8", pool))
    geoms = {"llama2-7b": dict(H=32, KV=32, D=128), "mistral-7b": MISTRAL}
    results = []
    for seed, (form, gname, sname, pool) in enumerate(plan, start=900):
        dtype = torch.float32 if pool == "fp32" else torch.bfloat16
        e4m3 = pool == "e4m3"
        label = f"{gname}/{form}-{sname}" + ("/e4m3-pool" if e4m3 else "")
        if form == "tree":
            case = k1_tree_case(label, ctx=tree_ctx, dtype=dtype, dev=dev,
                                seed=seed, e4m3=e4m3, **geoms[gname])
        else:
            ring = MISTRAL_RING_PAGES if form == "ring" else None
            sh = shapes[sname]
            nb = len(sh["ctx"]) * (ring or -(-(max(sh["ctx"]) + sh["Ts"])
                                              // 64) + 2) + 1
            case = k1_case(label, bs=64, dtype=dtype, dev=dev, seed=seed,
                           e4m3=e4m3, nb=nb, sliding=MISTRAL_WINDOW,
                           ring_pages=ring, **geoms[gname], **sh)
        # the plain version's temporaries over ~6500 keys are large: timed
        # without a graph
        results.append(k1_run_case(case, form, plain_graph=False))
        del case
        free_cuda()
    counts.reset()

    def summary(form, main_case):
        rs = [r for r in results if r["form"] == form]
        return dict(k1_summary([r for r in rs if r["pool"] != "e4m3"],
                               main_case),
                    max_err_over_max_ref_e4m3=max(
                        r["judged_err"] for r in rs if r["pool"] == "e4m3"))

    # each form at the serving path's most frequent shape: a bf16 decode
    # step of mistral-7b, a bf16 verify of llama2-7b
    return {"window": summary("window", "mistral-7b/window-decode"),
            "ring": summary("ring", "mistral-7b/ring-decode"),
            "tree": summary("tree", "llama2-7b/tree-verify-T8")}, results


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


#: K5's backward on the MoE train path: (label, experts n, K, N, top-k,
#: tokens) — qwen2-moe's expert w_gate and w_down at one micro-batch of
#: the moe-train phase (2 x 2048 tokens x top-4: 16384 routed rows, Tp
#: 24064 at block_m 128), and Mixtral's w_gate at 512 x 2
GROUPED_BWD_SHAPES = (("qwen2-moe/w_gate", 60, 2048, 1408, 4, 4096),
                      ("qwen2-moe/w_down", 60, 1408, 2048, 4, 4096),
                      ("mixtral/w_gate", 8, 4096, 14336, 2, 512))


def grouped_bwd_bound(counts, n, K, N, dtype, which):
    """(bound ms, what bounds it, bytes, operations) of dx or dw: the routed
    rows of the two row operands read once (dy and x for dw; dy for dx) and
    dx's routed rows written (dx), or every expert's [K, N] written (dw,
    zeros included); the weights of each expert that owns a routed row read
    once (dx); 2 * routed rows * K * N operations either way."""
    routed = int(counts.sum())
    active = int((counts > 0).sum())
    el = torch.empty((), dtype=dtype).element_size()
    if which == "dx":
        nbytes = routed * N * el + active * K * N * el + routed * K * el
    else:
        nbytes = routed * K * el + routed * N * el + n * K * N * el
    ops = 2.0 * routed * K * N
    bound, by = bound_of(nbytes, ops / PEAK_OPS[dtype])
    return bound, by, float(nbytes), ops


def library_grouped_bwd(buf, dy, w_bf16, counts, block_m):
    """``torch._grouped_mm`` yardsticks in bf16 over the same expert-aligned
    buffer (group ends from the aligned counts): dx as a 2d x 3d call with
    w transposed (a view), dw as the 2d x 2d call ragged over rows, and the
    forward + backward through autograd. None where this torch has no such
    call."""
    if not hasattr(torch, "_grouped_mm"):
        return None
    aligned = (counts + block_m - 1) // block_m * block_m
    offs = aligned.cumsum(0).to(torch.int32)
    xb, dyb = buf.to(torch.bfloat16), dy.to(torch.bfloat16)
    wt = w_bf16.transpose(1, 2)
    xg = xb.detach().clone().requires_grad_()
    wg = w_bf16.detach().clone().requires_grad_()

    def fwd_bwd():
        torch._grouped_mm(xg, wg, offs=offs).backward(dyb)
        xg.grad = wg.grad = None

    return dict(dx=lambda: torch._grouped_mm(dyb, wt, offs=offs),
                dw=lambda: torch._grouped_mm(xb.t(), dyb, offs=offs),
                fwd_bwd=fwd_bwd)


def phase_k5_bwd(dev) -> tuple[dict, dict, list]:
    """K5's dx and dw kernels against their plain versions at the train
    path's shapes (``GROUPED_BWD_SHAPES``), under uniform, skewed (every
    token on 4 experts) and idle-expert routings, bf16 and fp32, judged by
    ``K2_TOL``; times of each kernel, its plain version, its bound and the
    ``torch._grouped_mm`` yardstick, and K5's forward + dx + dw beside
    ``_grouped_mm``'s forward + backward through autograd. Returns the dx
    and dw records' fields and the cases."""
    from deepspeed_tpu_torch.ops import grouped_matmul as gm

    results = []
    seed = 700
    for label, n, K, N, k, T in GROUPED_BWD_SHAPES:
        seed += 10
        g = torch.Generator(device=dev).manual_seed(seed)
        w32 = torch.randn(n, K, N, generator=g, device=dev) / K ** 0.5
        w_bf16 = w32.to(torch.bfloat16)
        for i, (kind, dtype) in enumerate(
                (kd, dt) for kd in ("spread", "skewed", "idle")
                for dt in (torch.bfloat16, torch.float32)):
            buf, srt, cnt = grouped_case(T, k, n, K, K5_BLOCK_M, dtype, dev,
                                         seed + i, kind)
            w = w_bf16 if dtype == torch.bfloat16 else w32
            gd = torch.Generator(device=dev).manual_seed(seed + 50 + i)
            dy = torch.randn(srt.Tp, N, generator=gd, device=dev).to(dtype)
            dx_args = (dy, w, srt.tile_expert, K5_BLOCK_M, srt.tile_rows)
            dw_args = (buf, dy, srt.tile_expert, n, K5_BLOCK_M,
                       srt.tile_rows)
            tag = f"K5 bwd {label}/train-{kind}/T={T}x{k}"
            before = (gm.counts.kernel_dx, gm.counts.kernel_dw)
            dx = gm.grouped_matmul_dx(*dx_args)
            dw = gm.grouped_matmul_dw(*dw_args)
            torch.cuda.synchronize()
            if (gm.counts.kernel_dx, gm.counts.kernel_dw) != (
                    before[0] + 1, before[1] + 1):
                raise AssertionError(f"{tag}: the kernels were not counted")
            errs = {}
            for name, got, ref, shape in (
                    ("dx", dx, gm.grouped_matmul_dx_reference(*dx_args),
                     (srt.Tp, K)),
                    ("dw", dw, gm.grouped_matmul_dw_reference(*dw_args),
                     (n, K, N))):
                if tuple(got.shape) != shape or not torch.isfinite(got).all():
                    raise AssertionError(f"{tag} {name}: shape "
                                         f"{tuple(got.shape)} or non-finite")
                err = (got.float() - ref.float()).abs().max().item()
                judged = err / ref.float().abs().max().item()
                if judged > K2_TOL[dtype]:
                    raise AssertionError(
                        f"{tag} {name} {dtype}: kernel against plain error "
                        f"{judged:.3e} > {K2_TOL[dtype]:.0e} (max abs "
                        f"{err:.3e})")
                errs[name] = (err, judged)
                del ref
            rec = dict(case=f"{label}/train-{kind}/T={T}x{k}",
                       dtype=str(dtype).replace("torch.", ""), Tp=srt.Tp,
                       routed_rows=T * k,
                       active_experts=int((cnt > 0).sum()),
                       tol=K2_TOL[dtype])
            lib = (library_grouped_bwd(buf, dy, w_bf16, cnt, K5_BLOCK_M)
                   if dtype == torch.bfloat16 else None)
            for name, fn, plain, args in (
                    ("dx", gm.grouped_matmul_dx,
                     gm.grouped_matmul_dx_reference, dx_args),
                    ("dw", gm.grouped_matmul_dw,
                     gm.grouped_matmul_dw_reference, dw_args)):
                bound, by, nbytes, ops = grouped_bwd_bound(cnt, n, K, N,
                                                           dtype, name)
                rec[name] = dict(
                    max_abs_err=errs[name][0], judged_err=errs[name][1],
                    ms=cuda_time_ms(lambda: fn(*args)),
                    plain_ms=cuda_time_ms(lambda: plain(*args), iters=2,
                                          warmup=1, graph=False),
                    library_ms=(cuda_time_ms(lib[name]) if lib is not None
                                else None),
                    bound_ms=bound, bound_by=by, bytes=nbytes, ops=ops)
            if lib is not None and kind == "spread":
                # K5's forward + dx + dw through autograd, and _grouped_mm's
                xg = buf.detach().clone().requires_grad_()
                wg = w.detach().clone().requires_grad_()

                def k5_fwd_bwd():
                    gm.grouped_matmul(xg, wg, srt.tile_expert, K5_BLOCK_M,
                                      srt.tile_rows).backward(dy)
                    xg.grad = wg.grad = None

                rec["fwd_bwd_ms"] = cuda_time_ms(k5_fwd_bwd, iters=5,
                                                 warmup=2, graph=False)
                rec["library_fwd_bwd_ms"] = cuda_time_ms(
                    lib["fwd_bwd"], iters=5, warmup=2, graph=False)
                del xg, wg
            results.append(rec)
            lib_txt = {nm: (f"{rec[nm]['library_ms']:.4f}"
                            if rec[nm]["library_ms"] is not None else "none")
                       for nm in ("dx", "dw")}
            log(f"[kernel] {tag:<44} {rec['dtype']:<8} "
                + "  ".join(
                    f"{nm} err {rec[nm]['judged_err']:.2e} kernel "
                    f"{rec[nm]['ms']:.4f} ms plain {rec[nm]['plain_ms']:.3f}"
                    f" _grouped_mm {lib_txt[nm]} bound "
                    f"{rec[nm]['bound_ms']:.4f} ({rec[nm]['bound_by']})"
                    for nm in ("dx", "dw"))
                + (f"  fwd+bwd K5 {rec['fwd_bwd_ms']:.3f} ms, _grouped_mm "
                   f"{rec['library_fwd_bwd_ms']:.3f} ms"
                   if "fwd_bwd_ms" in rec else ""))
            del buf, srt, dy, dx, dw, dx_args, dw_args, lib
        del w32, w_bf16
        free_cuda()
    gm.counts.reset()
    label, _, _, _, k, T = GROUPED_BWD_SHAPES[0]
    main = next(r for r in results if r["dtype"] == "bfloat16"
                and r["case"] == f"{label}/train-spread/T={T}x{k}")

    def summary(name):
        bf = [r[name] for r in results if r["dtype"] == "bfloat16"]
        fp = [r[name] for r in results if r["dtype"] == "float32"]
        out = dict(max_abs_err=max(r["max_abs_err"] for r in bf),
                   max_err_over_max_ref=max(r["judged_err"] for r in bf),
                   max_err_over_max_ref_fp32=max(r["judged_err"] for r in fp),
                   **{k: main[name][k] for k in ("ms", "plain_ms",
                                                 "library_ms", "bound_ms",
                                                 "bound_by")})
        return out

    dx_rec, dw_rec = summary("dx"), summary("dw")
    dw_rec.update(fwd_dx_dw_ms=main["fwd_bwd_ms"],
                  library_fwd_bwd_ms=main["library_fwd_bwd_ms"])
    return dx_rec, dw_rec, results


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
    from deepspeed_tpu_torch.ops import block_sparse_attention as bsa
    from deepspeed_tpu_torch.ops import flash_attention as fa
    from deepspeed_tpu_torch.ops import grouped_matmul as gm
    from deepspeed_tpu_torch.ops import paged_attention as pa
    from deepspeed_tpu_torch.ops import quant_matmul as qm

    return {"k1": pa.counts.kernel, "k1_e4m3": pa.counts.kernel_e4m3,
            "k1_window": pa.counts.kernel_window,
            "k1_ring": pa.counts.kernel_ring,
            "k1_tree": pa.counts.kernel_tree,
            "k1_plain": pa.counts.plain, "k2": qm.counts.kernel,
            "k2_plain": qm.counts.plain, "k3": qm.grouped_counts.kernel,
            "k3_plain": qm.grouped_counts.plain, "k5": gm.counts.kernel,
            "k5_plain": gm.counts.plain, "k5_dx": gm.counts.kernel_dx,
            "k5_dw": gm.counts.kernel_dw,
            "k5_plain_dx": gm.counts.plain_dx,
            "k5_plain_dw": gm.counts.plain_dw, "k4_fwd": fa.counts.fwd,
            "k4_bwd": fa.counts.bwd, "k4_plain": fa.counts.plain,
            "k4_plain_bwd": fa.counts.plain_bwd, "k6_fwd": bsa.counts.fwd,
            "k6_bwd": bsa.counts.bwd, "k6_plain": bsa.counts.plain,
            "k6_plain_bwd": bsa.counts.plain_bwd,
            "k7": pa.prefill_counts.kernel,
            "k7_plain": pa.prefill_counts.plain}


def reset_counts() -> None:
    from deepspeed_tpu_torch.ops import block_sparse_attention as bsa
    from deepspeed_tpu_torch.ops import flash_attention as fa
    from deepspeed_tpu_torch.ops import grouped_matmul as gm
    from deepspeed_tpu_torch.ops import paged_attention as pa
    from deepspeed_tpu_torch.ops import quant_matmul as qm

    bsa.counts.reset()
    pa.prefill_counts.reset()
    pa.counts.reset()
    qm.counts.reset()
    qm.grouped_counts.reset()
    gm.counts.reset()
    fa.counts.reset()


def forwards_of(eng) -> int:
    st = eng.stats
    return st["prefill_steps"] + st["decode_steps"] + st["window_iters_max"]


def check_launches(tag, got: dict, cfg, *, forwards, e4m3_pool, quant,
                   ring=False, verifies=0, draft_k1=0):
    """Per forward: K1 (over a pool of q's dtype or of e4m3 codes) once per
    layer, with the window and the ring on every one of a ring-served
    model's, and its tree form once per layer of each of the ``verifies``
    speculative verify forwards (which count among ``forwards``);
    ``draft_k1`` more launches of K1 by a draft engine (bf16 pool); when
    the weights are quantized, K2 once per dense weight product (q, k, v, o
    of every layer, a dense FFN's products, the unembedding) and K3 once per
    expert product of every MoE layer; K5 once per expert product under
    ``moe.dropless`` without quantization; never K4 (serving has no
    full-sequence attention), K6 or K7; no plain version at all."""
    from deepspeed_tpu_torch.models.transformer import is_moe_layer

    L = cfg.num_layers
    moe_layers = sum(is_moe_layer(cfg, i) for i in range(L))
    ffn = 3 if cfg.activation == "silu_glu" else 2
    dense = 4 * L + ffn * (L - moe_layers) + 1
    experts = ffn * moe_layers
    dropless = cfg.moe is not None and cfg.moe.dropless
    f = forwards
    want = {"k1": (0 if e4m3_pool else L * f) + draft_k1,
            "k1_e4m3": L * f if e4m3_pool else 0,
            "k1_window": L * f if ring else 0,
            "k1_ring": L * f if ring else 0, "k1_tree": L * verifies,
            "k1_plain": 0,
            "k2": dense * f if quant else 0, "k2_plain": 0,
            "k3": experts * f if quant else 0, "k3_plain": 0,
            "k5": experts * f if dropless and not quant else 0,
            "k5_plain": 0, "k5_dx": 0, "k5_dw": 0, "k5_plain_dx": 0,
            "k5_plain_dw": 0, "k4_fwd": 0, "k4_bwd": 0, "k4_plain": 0,
            "k4_plain_bwd": 0, "k6_fwd": 0, "k6_bwd": 0, "k6_plain": 0,
            "k6_plain_bwd": 0, "k7": 0, "k7_plain": 0}
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
    out = {name: parity_model(dev, name, routes)
           for name, routes in PARITY.items()}
    out["mistral-7b ring"] = parity_ring(dev)
    out["llama2-7b spec"] = parity_spec(dev)
    return out


def parity_ring(dev) -> dict:
    """mistral-7b at full width x 4 layers in fp32 served from its rolling
    ring (69 pages of 64): two prompts past the 4416-token ring and a short
    one, 32 new tokens each, against a greedy loop over the dense forward
    (which masks the 4096-key window) under oracle_check's rule; then an
    e4m3-pool ring against the fp32 one within the JAX package's fp8 bound
    (max 0.5, mean 0.05 on the logits while the streams agree)."""
    from deepspeed_tpu_torch.models import build_model

    log("[parity] mistral-7b full width, 4 layers, fp32, rolling ring")
    model = build_model("mistral-7b", num_layers=4, dtype=torch.float32,
                        device=dev, seed=0, attn_impl="xla")
    vocab = model.config.vocab_size
    g = torch.Generator().manual_seed(2)
    lens = [4600, 4700, 300]
    prompts = [torch.randint(0, vocab, (n,), generator=g).tolist()
               for n in lens]
    new = 32
    cfg = dict(block_size=64, num_blocks=256, max_seqs=4, chunk=256,
               max_seq_len=8192, decode_window=8, dtype=torch.float32,
               device=dev)
    out = {"prompts": lens, "new_tokens": new}
    taps = streams = None
    for label, over in (("fp32-pool", {}),
                        ("e4m3-pool", {"kv_cache_dtype": "fp8"})):
        tag = f"parity mistral-7b ring {label}"
        eng = tap_engine_class()(model, config=dict(cfg, **over))
        ring = eng._ring_tokens
        if ring != MISTRAL_RING_PAGES * 64 or \
                eng._attn_decode_sel.path != "cuda" or eng._prefix_cache:
            raise AssertionError(f"[{tag}] ring {ring}, path "
                                 f"{eng._attn_decode_sel.path}, prefix "
                                 f"cache {eng._prefix_cache}")
        reset_counts()
        got = eng.generate(prompts, max_new_tokens=new)
        launches = all_counts()
        eng.state.audit()
        forwards = forwards_of(eng)
        check_launches(tag, launches, model.config, forwards=forwards,
                       e4m3_pool=bool(over), quant=False, ring=True)
        rec = {"launches": launches, "forwards": forwards,
               "ring_tokens": ring}
        if label == "fp32-pool":
            worst, near = oracle_check(tag, eng, model, prompts, got, new,
                                       dev)
            rec.update(max_rel_logits_err=worst, near_ties=near)
            log(f"[{tag}] {len(prompts)} greedy streams x {new} tokens past "
                f"the {ring}-token ring identical to the dense windowed "
                f"oracle ({len(near)} near-ties); max logits error "
                f"{worst:.2e} relative; launches {launches}")
            taps, streams = eng.taps, got
        else:
            rec.update(fp8_bound(tag, eng.taps, taps, got, streams, new))
        out[label] = rec
        del eng
        free_cuda()
    del model
    free_cuda()
    return out


def fp8_bound(tag, taps8, taps, streams8, streams, new) -> dict:
    """The e4m3-pool engine's logits against the fp32-pool engine's, while
    the two streams agree: max 0.5 and mean 0.05 (the JAX package's bound
    for its fp8 pool, tests/test_inference_v2.py)."""
    diffs = []
    for uid in range(len(streams)):
        for k in range(new):
            diffs.append((taps8[uid][k] - taps[uid][k]).abs())
            if streams8[uid][k] != streams[uid][k]:
                break
    d = torch.stack(diffs)
    rec = dict(max_abs_logits_diff=d.max().item(),
               mean_abs_logits_diff=d.mean().item(),
               steps_compared=len(diffs), streams_equal=streams8 == streams)
    if rec["max_abs_logits_diff"] > 0.5 or rec["mean_abs_logits_diff"] > 0.05:
        raise AssertionError(f"[{tag}] logits off the fp32 pool's: {rec}")
    log(f"[{tag}] e4m3 pool vs fp32 pool over {len(diffs)} sampled steps: "
        f"max |logits diff| {rec['max_abs_logits_diff']:.3e} (tol 0.5), mean "
        f"{rec['mean_abs_logits_diff']:.3e} (tol 0.05); streams equal: "
        f"{rec['streams_equal']}")
    return rec


def motif_prompts(vocab, g, lens=(300, 300, 300, 100)):
    """Prompts of a repeated random 12-token motif (prompt lookup proposes
    its continuation wherever the model's stream repeats its history), the
    last one random."""
    out = []
    for i, n in enumerate(lens):
        if i == len(lens) - 1:
            out.append(torch.randint(0, vocab, (n,), generator=g).tolist())
            continue
        motif = torch.randint(0, vocab, (12,), generator=g).tolist()
        out.append((motif * (n // len(motif) + 1))[:n])
    return out


def spec_stream_check(tag, got, want, oracle, prompts, dev) -> list:
    """Each spec stream against the spec-off stream; where they part, the
    dense oracle's top-2 gap there must be a near-tie (< 1e-4), as in
    oracle_check. Returns the near-ties."""
    near = []
    with torch.no_grad():
        for uid, (a, b) in enumerate(zip(got, want)):
            if a == b:
                continue
            k = next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)
            ids = torch.tensor([prompts[uid] + b[:k]], device=dev)
            top2 = torch.topk(oracle(ids)[0, -1].float(), 2).values
            gap = (top2[0] - top2[1]).item()
            if gap >= 1e-4:
                raise AssertionError(f"[{tag}] uid {uid} step {k}: spec "
                                     f"token {a[k]} != spec-off {b[k]} "
                                     f"(top-2 gap {gap:.3e})")
            near.append((uid, k, gap))
            log(f"[{tag}] NEAR-TIE uid {uid} step {k}: top-2 gap {gap:.2e}")
    return near


def spec_stats(eng) -> dict:
    st = eng.stats
    return {k: st[k] for k in ("spec_rounds", "spec_verifies",
                               "spec_proposed", "spec_accepted",
                               "spec_steps_saved", "spec_accept_rate")} | {
        "tokens_per_verify": (st["spec_accepted"] + st["spec_verifies"])
        / max(st["spec_verifies"], 1)}


def draft_forwards(eng) -> int:
    return 0 if eng._draft_engine is None else forwards_of(eng._draft_engine)


def parity_spec(dev) -> dict:
    """llama2-7b at full width x 4 layers in fp32: speculative decoding
    ("ngram" over motif prompts; "draft" with a same-weights draft and a
    differently seeded one) against the spec-off engine in the same run.
    Every verify goes through K1's tree form; the strong draft's acceptance
    must exceed 0.9; spec with a windowed model raises ValueError."""
    from types import SimpleNamespace

    from deepspeed_tpu_torch.inference import InferenceEngineV2
    from deepspeed_tpu_torch.inference.weights import module_param_tree
    from deepspeed_tpu_torch.models import build_model

    log("[parity] llama2-7b full width, 4 layers, fp32, spec_decode")
    model = build_model("llama2-7b", num_layers=4, dtype=torch.float32,
                        device=dev, seed=0, attn_impl="xla")
    L, vocab = model.config.num_layers, model.config.vocab_size
    prompts = motif_prompts(vocab, torch.Generator().manual_seed(3))
    new = 24
    cfg = dict(block_size=64, num_blocks=64, max_seqs=4, chunk=128,
               max_seq_len=1024, decode_window=8, dtype=torch.float32,
               device=dev)
    base = InferenceEngineV2(model, config=cfg).generate(prompts, new)
    out = {"prompts": [len(p) for p in prompts], "new_tokens": new}
    weak = build_model("llama2-7b", num_layers=4, dtype=torch.float32,
                       device=dev, seed=7, attn_impl="xla")
    for label, over, draft in (("ngram", {"spec_decode": "ngram"}, None),
                               ("draft-strong", {"spec_decode": "draft"},
                                model),
                               ("draft-weak", {"spec_decode": "draft"},
                                weak)):
        tag = f"parity llama2-7b spec {label}"
        eng = InferenceEngineV2(model, config=dict(cfg, **over),
                                draft_model=draft)
        if eng._attn_tree_sel.path != "cuda":
            raise AssertionError(f"[{tag}] tree path "
                                 f"{eng._attn_tree_sel.path}")
        reset_counts()
        got = eng.generate(prompts, new)
        launches = all_counts()
        eng.state.audit()
        st = spec_stats(eng)
        check_launches(tag, launches, model.config,
                       forwards=forwards_of(eng), e4m3_pool=False,
                       quant=False, verifies=st["spec_rounds"],
                       draft_k1=L * draft_forwards(eng))
        near = spec_stream_check(tag, got, base, model, prompts, dev)
        if st["spec_rounds"] == 0 or \
                eng.stats["attn_cuda_tree"] != st["spec_rounds"]:
            raise AssertionError(f"[{tag}] verifies {st} / "
                                 f"{eng.stats['attn_cuda_tree']}")
        if label == "draft-strong" and st["spec_accept_rate"] <= 0.9:
            raise AssertionError(f"[{tag}] acceptance {st}")
        out[label] = dict(st, launches=launches, near_ties=near)
        log(f"[{tag}] {len(prompts)} streams x {new} tokens identical to "
            f"spec-off ({len(near)} near-ties): {st['spec_rounds']} verify "
            f"rounds, acceptance {st['spec_accept_rate']:.3f}, "
            f"{st['tokens_per_verify']:.2f} tokens per verify; launches "
            f"{launches}")
        del eng
        free_cuda()
    # spec on a windowed model (its rolling ring) is refused
    windowed = SimpleNamespace(config=dataclasses.replace(
        model.config, sliding_window=MISTRAL_WINDOW))
    try:
        InferenceEngineV2(windowed, params=module_param_tree(model),
                          config=dict(cfg, max_seq_len=8192,
                                      spec_decode="ngram"))
    except ValueError as e:
        log(f"[parity] spec + sliding window refused: {e}")
    else:
        raise AssertionError("spec_decode on a windowed model did not raise")
    del model, weak
    free_cuda()
    return out


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
                            device=dev, seed=0, attn_impl="xla", **extra)
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
            rec.update(fp8_bound(tag, eng.taps, dense_taps, streams,
                                 dense_streams, new))
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
    time into K1, K2, K3, K4, K5 (forward, dx, dw), matrix products and the
    rest, beside the host wall time (single stream, so busy time is the
    kernel time sum). Returns the numbers, or {"device": "not measured"}
    when the profiler saw no kernel time."""
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
        if "flash_" in low and "_kernel" in low:
            return "k4_ms"
        if "ragged_paged_attn" in low:
            return "k1_ms"
        if "qgmm_" in low:
            return "k3_ms"
        if "gmm_dw_" in low:
            return "k5_dw_ms"
        if "::gmm_" in low or low.startswith("gmm_"):
            # the forward and dx share a template: <false> / <true>
            return "k5_dx_ms" if "kernel<true>" in low else "k5_ms"
        if "qmm_" in low:
            return "k2_ms"
        if any(t in low for t in ("gemm", "xmma", "cutlass", "matmul",
                                  "nvjet")):
            return "gemm_ms"
        return "other_ms"

    out = {"wall_ms": wall_ms, "busy_ms": busy, "k1_ms": 0.0, "k2_ms": 0.0,
           "k3_ms": 0.0, "k4_ms": 0.0, "k5_ms": 0.0, "k5_dx_ms": 0.0,
           "k5_dw_ms": 0.0, "gemm_ms": 0.0, "other_ms": 0.0,
           "idle_share": max(0.0, 1 - busy / wall_ms)}
    for name, ms in by_name.items():
        out[kind(name)] += ms
    out["top"] = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return out


#: the serve phase's traffic: (prompt lengths, shared system prefix, new
#: tokens per request, the engine's max_seq_len and num_blocks)
TRAFFIC = {
    # 8 requests of 256-1024 tokens behind a 128-token system prefix
    "shared-prefix": ((256, 384, 512, 640, 768, 896, 1024, 300), 128, 64,
                      2048, 256),
    # mistral past its window: 4 prompts of 4608-6144 tokens wrap the
    # 69-page ring, 4 of 256-1024 do not (8 x 69 pages fit 600 blocks)
    "long-window": ((4608, 5120, 5632, 6144, 256, 512, 768, 1024), 0, 64,
                    8192, 600),
    # prompts of a repeated motif (prompt lookup proposes where the model's
    # stream repeats its history)
    "motif": ((512, 384, 640, 256, 768, 320, 448, 576), 0, 64, 2048, 256),
}


def serve_run(dev, name: str, label: str, layers: int | None = None,
              traffic: str = "shared-prefix", draft: bool = False,
              **over) -> dict:
    """Model ``name`` at full width (and ``layers`` deep, all of them by
    default) in bf16 from seeded random weights, serving 8 requests of
    ``TRAFFIC[traffic]`` under the engine options ``over``. An MoE model
    takes its dropless route (K5) unless ``quant_bits`` sends its experts
    through K3. ``draft`` serves ``spec_decode="draft"`` with the model
    itself as its draft (a second engine over the same weights)."""
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
    lens, sys_len, new, max_seq_len, num_blocks = TRAFFIC[traffic]
    eng = InferenceEngineV2(model, config=dict(
        block_size=64, num_blocks=num_blocks, max_seqs=8, chunk=256,
        max_seq_len=max_seq_len, decode_window=8, dtype=torch.bfloat16,
        device=dev, **over), draft_model=model if draft else None)
    # the engine holds what it serves; the model's own weights that the
    # engine quantized go with it
    del model
    free_cuda()
    torch.cuda.synchronize()
    # a draft engine serves the same weights from a pool of its own
    engines = [eng] + ([eng._draft_engine] if eng._draft_engine else [])
    pool_bytes = sum(e.kv_pool.numel() * e.kv_pool.element_size()
                     for e in engines)
    param_bytes = tree_nbytes(eng.params)
    resident = torch.cuda.memory_allocated(dev) - pool_bytes
    log(f"[{tag}] {name} ({L} layers, bf16 compute, seeded random "
        f"weights, {over or 'no quantization'}) and "
        f"{pool_bytes / 1e9:.1f} GB {eng.kv_pool.dtype} "
        f"pool{'s' if len(engines) > 1 else ''} up in "
        f"{time.perf_counter() - t0:.1f}s; parameters "
        f"{param_bytes / 1e9:.2f} GB ({resident / 1e9:.2f} GB on the card "
        f"besides the pool); attention path {eng._attn_decode_sel.path}")
    if resident > 1.02 * param_bytes + (256 << 20):
        raise AssertionError(f"[{tag}] {resident / 1e9:.2f} GB stays on the "
                             f"card for {param_bytes / 1e9:.2f} GB of "
                             f"parameters")
    g = torch.Generator().manual_seed(1)
    system = torch.randint(0, vocab, (sys_len,), generator=g).tolist()
    # a first request publishes the shared system prefix (and warms the
    # allocator and cuBLAS); the measured batch then hits it
    eng.generate([system + torch.randint(0, vocab, (64,),
                                         generator=g).tolist()],
                 max_new_tokens=8)
    if traffic == "motif":
        prompts = motif_prompts(vocab, g, lens)
    else:
        prompts = [system + torch.randint(0, vocab, (n - sys_len,),
                                          generator=g).tolist()
                   for n in lens]
    for e in engines:
        for k in list(e.stats):
            e.stats[k] = 0 if not isinstance(e.stats[k], float) else 0.0
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for uid, p in enumerate(prompts):
        eng.put(uid, p, max_new_tokens=new)
    first: dict[int, float] = {}
    out: dict[int, list[int]] = {u: [] for u in range(len(prompts))}
    window_s = verify_s = 0.0
    top_pos = most_blocks = 0        # the ring's reach, for a ring run
    while any(not eng.query(u).get("done", True) for u in out):
        w0, v0 = eng.stats["windows"], eng.stats["spec_rounds"]
        ts = time.perf_counter()
        emitted = eng.step()
        dt = time.perf_counter() - ts
        if eng.stats["windows"] > w0:
            window_s += dt
        if eng.stats["spec_rounds"] > v0:
            verify_s += dt
        for seq in eng.state.seqs.values():
            top_pos = max(top_pos, len(seq.tokens))
            most_blocks = max(most_blocks, len(seq.blocks))
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
    ring = eng._ring_tokens
    check_launches(tag, launches, cfg, forwards=forwards,
                   e4m3_pool=over.get("kv_cache_dtype") == "fp8",
                   quant=bool(over.get("quant_bits")), ring=bool(ring),
                   verifies=st["spec_rounds"],
                   draft_k1=L * draft_forwards(eng))
    if st["prefix_hit_tokens"] < sys_len * len(prompts):
        raise AssertionError(f"[{tag}] prefix cache served "
                             f"{st['prefix_hit_tokens']} tokens")
    if ring:
        nwin = eng.state.max_blocks_per_seq
        if top_pos <= ring or most_blocks > nwin or \
                eng._prefix_cache is not None:
            raise AssertionError(f"[{tag}] ring of {ring} tokens: reached "
                                 f"position {top_pos}, {most_blocks} blocks "
                                 f"> {nwin}, or a prefix cache")
        log(f"[{tag}] ring of {nwin} pages ({ring} tokens): positions up to "
            f"{top_pos} served, at most {most_blocks} pages per sequence")
    spec = spec_stats(eng) if eng._spec is not None else None
    if spec is not None:
        # a draft always proposes; prompt lookup only where the stream
        # repeats its history, which random weights at full depth need not
        if st["attn_cuda_tree"] != spec["spec_rounds"] or \
                (draft and spec["spec_rounds"] == 0):
            raise AssertionError(f"[{tag}] verifies {spec}")
        log(f"[{tag}] {spec['spec_rounds']} verify rounds, acceptance "
            f"{spec['spec_accept_rate']:.3f}, {spec['tokens_per_verify']:.2f}"
            f" tokens per verify, K1 tree launches {launches['k1_tree']}, "
            f"draft forwards {draft_forwards(eng)}")
    # where the device time goes: one profiled decode step (8 requests of
    # 16 new tokens past a shared-prefix prompt: a window, or a verify
    # round under spec_decode), separate from the timed run above
    short = [system + torch.randint(0, vocab, (64,), generator=g).tolist()
             for _ in range(8)]
    if traffic == "motif":
        short = [p[:64] for p in prompts]
    for uid, p in enumerate(short):
        eng.put(100 + uid, p, max_new_tokens=16)
    while any(eng.state.seqs[100 + u].pending_sched > 1 for u in range(8)):
        eng.step()                  # prefill; the next dispatch decodes
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
           "forwards": forwards, "stats": st, "profiled_window": prof,
           "ring_tokens": ring, "top_position": top_pos,
           "most_blocks": most_blocks, "spec": spec,
           "ms_per_verify_round": (1e3 * verify_s / st["spec_rounds"]
                                   if st["spec_rounds"] else None)}
    log(f"[{tag}] {len(prompts)} requests ({sum(lens)} prompt tokens, "
        f"{st['prefix_hit_tokens']} from the prefix cache) x {new} new "
        f"tokens in {wall:.2f}s: {res['output_tok_s']:.1f} output tok/s, "
        f"p50 TTFT {res['ttft_p50_s']:.3f}s, decode "
        f"{res['decode_ms_per_token']:.2f} ms/token-step over "
        f"{window_iters} window iterations"
        + (f", {res['ms_per_verify_round']:.2f} ms per verify round"
           if res["ms_per_verify_round"] else "")
        + f", peak memory {res['peak_mem_gb']:.1f} GB")
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
    # mistral-7b past its window, from the rolling ring (bf16 and e4m3
    # pools); llama2-7b's speculative decoding beside spec-off on the same
    # motif traffic
    out["mistral-7b ring"] = {
        "bf16": serve_run(dev, "mistral-7b", "bf16 ring",
                          traffic="long-window"),
        "fp8-pool": serve_run(dev, "mistral-7b", "fp8-pool ring",
                              traffic="long-window", kv_cache_dtype="fp8")}
    spec = {"spec-off": serve_run(dev, "llama2-7b", "motif spec-off",
                                  traffic="motif"),
            "ngram": serve_run(dev, "llama2-7b", "motif ngram",
                               traffic="motif", spec_decode="ngram"),
            "draft": serve_run(dev, "llama2-7b", "motif draft",
                               traffic="motif", draft=True,
                               spec_decode="draft")}
    for label in ("ngram", "draft"):
        r, off = spec[label], spec["spec-off"]
        log(f"[serve] llama2-7b {label} vs spec-off: "
            f"{r['output_tok_s']:.1f} vs {off['output_tok_s']:.1f} output "
            f"tok/s, p50 TTFT {r['ttft_p50_s']:.3f} vs "
            f"{off['ttft_p50_s']:.3f} s, {r['spec']['tokens_per_verify']:.2f}"
            f" tokens per verify at acceptance "
            f"{r['spec']['spec_accept_rate']:.3f}")
    out["llama2-7b spec"] = spec
    return out


# ---------------------------------------------------------------------------
# K4: flash attention, forward and backward (kernel phase)
# ---------------------------------------------------------------------------

#: K4 against its plain version: fp32 output by max |error| (1e-4), fp32
#: gradients by max |error| over max |plain| (1e-3: dq/dk/dv sum over S keys
#: in another order); bf16 output and gradients by max |error| over max
#: |plain| (2e-2: both round to bf16, the kernel's p never does)
K4_TOL = {torch.float32: (1e-4, 1e-3), torch.bfloat16: (2e-2, 2e-2)}
#: (label, B, H, KV, S, D, causal): llama2-7b geometry where the Pallas
#: backward is one block (S = 1024, ``_dqkv_kernel``) and split (2048 — the
#: train phase's shape — and 4096), mistral-7b's GQA, gpt2-1.3b's head dim
#: 64, and one non-causal call
K4_CASES = (("llama2-7b S=1024", 2, 32, 32, 1024, 128, True),
            ("llama2-7b S=2048", 2, 32, 32, 2048, 128, True),
            ("llama2-7b S=4096", 1, 32, 32, 4096, 128, True),
            ("mistral-7b GQA S=2048", 2, 32, 8, 2048, 128, True),
            ("gpt2-1.3b S=1024", 4, 32, 32, 1024, 64, True),
            ("llama2-7b S=1024 non-causal", 1, 32, 32, 1024, 128, False))
K4_MAIN = "llama2-7b S=2048"


def k4_work(B, H, KV, S, D, causal, dtype) -> dict:
    """Bytes and operations of one forward and one backward: each input read
    once and each output written once; 2 x 2 products over the (causally)
    visible query-key pairs forward, 2 x 5 backward (the scores again,
    dP, dV, dQ, dK)."""
    pairs = B * H * (S * (S + 1) // 2 if causal else S * S)
    e = torch.tensor([], dtype=dtype).element_size()
    q_el, kv_el, rows = B * H * S * D, B * KV * S * D, B * H * S
    fwd_bytes = e * (2 * q_el + 2 * kv_el) + 4 * rows
    bwd_bytes = e * (4 * q_el + 4 * kv_el) + 4 * rows
    ops_fwd, ops_bwd = 4.0 * pairs * D, 10.0 * pairs * D
    peak = PEAK_OPS[dtype]
    fwd = bound_of(fwd_bytes, ops_fwd / peak)
    bwd = bound_of(bwd_bytes, ops_bwd / peak)
    return dict(fwd_bytes=fwd_bytes, bwd_bytes=bwd_bytes, fwd_ops=ops_fwd,
                bwd_ops=ops_bwd, fwd_bound_ms=fwd[0], fwd_bound_by=fwd[1],
                bwd_bound_ms=bwd[0], bwd_bound_by=bwd[1])


def k4_run_case(label, B, H, KV, S, D, causal, dtype, dev, seed) -> dict:
    """One K4 case: the forward and backward kernels each counted once and
    no plain launch; out, lse and dq/dk/dv against the plain versions by
    ``K4_TOL``; then the kernel, the plain versions and the SDPA yardstick
    timed. Raises past the tolerance."""
    import torch.nn.functional as F

    from deepspeed_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device=dev).manual_seed(seed)
    rnd = lambda *s: torch.randn(s, generator=g, device=dev).to(dtype)
    q, k, v, do = rnd(B, H, S, D), rnd(B, KV, S, D), rnd(B, KV, S, D), \
        rnd(B, H, S, D)
    scale = 1.0 / (D ** 0.5)
    before = dict(vars(fa.counts))
    out, lse = fa.flash_fwd(q, k, v, causal, scale)
    dq, dk, dv = fa.flash_bwd(q, k, v, out, lse, do, causal, scale)
    torch.cuda.synchronize()
    bumped = {n: c - before[n] for n, c in vars(fa.counts).items()}
    if bumped != {"fwd": 1, "bwd": 1, "plain": 0, "plain_bwd": 0}:
        raise AssertionError(f"K4 {label}: counted {bumped}")
    ref_out, ref_lse = fa.flash_fwd_plain(q, k, v, causal, scale)
    refs = fa.flash_bwd_plain(q, k, v, ref_out, ref_lse, do, causal, scale)
    out_tol, grad_tol = K4_TOL[dtype]
    errs = {}
    for name, got, ref in (("out", out, ref_out), ("dq", dq, refs[0]),
                           ("dk", dk, refs[1]), ("dv", dv, refs[2])):
        if not torch.isfinite(got.float()).all():
            raise AssertionError(f"K4 {label} {dtype}: non-finite {name}")
        err = (got.float() - ref.float()).abs().max().item()
        mref = ref.float().abs().max().item()
        judged = err if (name == "out" and dtype == torch.float32) \
            else err / mref
        tol = out_tol if name == "out" else grad_tol
        errs[name] = dict(max_abs_err=err, max_abs_ref=mref, judged=judged,
                          tol=tol)
        if judged > tol:
            raise AssertionError(f"K4 {label} {dtype}: {name} error "
                                 f"{judged:.3e} > {tol:.0e} (max abs {err:.3e}"
                                 f" of max |plain| {mref:.3e})")
    lse_err = (lse - ref_lse).abs().max().item()
    if lse_err > 1e-3:
        raise AssertionError(f"K4 {label} {dtype}: lse error {lse_err:.3e}")
    del ref_out, ref_lse, refs
    map_us = {}
    if dtype == torch.bfloat16:
        from deepspeed_tpu_torch.ops import kernels

        lib = kernels.load("flash_attention")
        fa.flash_fwd(q, k, v, causal, scale)
        map_us["fwd"] = lib.ds_flash_attention_map_us()
        fa.flash_bwd(q, k, v, out, lse, do, causal, scale)
        map_us["bwd"] = lib.ds_flash_attention_map_us()
    ms = cuda_time_ms(lambda: fa.flash_fwd(q, k, v, causal, scale), iters=10)
    bwd_ms = cuda_time_ms(
        lambda: fa.flash_bwd(q, k, v, out, lse, do, causal, scale), iters=10)
    plain_ms = cuda_time_ms(lambda: fa.flash_fwd_plain(q, k, v, causal, scale),
                            iters=2, warmup=1, graph=False)
    plain_bwd_ms = cuda_time_ms(
        lambda: fa.flash_bwd_plain(q, k, v, out, lse, do, causal, scale),
        iters=2, warmup=1, graph=False)
    # yardstick: one SDPA call over K/V repeated per q head, forward and
    # forward + backward
    kr = k.repeat_interleave(H // KV, dim=1).requires_grad_()
    vr = v.repeat_interleave(H // KV, dim=1).requires_grad_()
    qr = q.detach().clone().requires_grad_()
    sdpa = lambda: F.scaled_dot_product_attention(q, kr.detach(), vr.detach(),
                                                  is_causal=causal)
    lib_ms = cuda_time_ms(sdpa, iters=10)

    def sdpa_fwd_bwd():
        F.scaled_dot_product_attention(qr, kr, vr, is_causal=causal) \
            .backward(do)

    lib_fwd_bwd_ms = cuda_time_ms(sdpa_fwd_bwd, iters=5, warmup=2,
                                  graph=False)
    work = k4_work(B, H, KV, S, D, causal, dtype)
    rates = dict(fwd_tflops=work["fwd_ops"] / (ms * 1e9),
                 bwd_tflops=work["bwd_ops"] / (bwd_ms * 1e9),
                 fwd_bound_share=work["fwd_bound_ms"] / ms,
                 bwd_bound_share=work["bwd_bound_ms"] / bwd_ms)
    rec = dict(case=label, dtype=str(dtype).replace("torch.", ""), B=B, H=H,
               KV=KV, S=S, D=D, causal=causal, errors=errs, lse_err=lse_err,
               ms=ms, bwd_ms=bwd_ms, plain_ms=plain_ms,
               plain_bwd_ms=plain_bwd_ms, library_ms=lib_ms,
               library_fwd_bwd_ms=lib_fwd_bwd_ms, map_us=map_us, **rates,
               **work)
    maps = (f"; maps {map_us['fwd']:.1f} / {map_us['bwd']:.1f} us"
            if map_us else "")
    log(f"[kernel] K4 {label:<28} {rec['dtype']:<8} err out "
        f"{errs['out']['judged']:.2e} dq {errs['dq']['judged']:.2e} dk "
        f"{errs['dk']['judged']:.2e} dv {errs['dv']['judged']:.2e}  fwd "
        f"{ms:.3f} ms {rates['fwd_tflops']:.0f} TFLOP/s, "
        f"{rates['fwd_bound_share']:.1%} of bound {work['fwd_bound_ms']:.3f} "
        f"{work['fwd_bound_by']} (plain {plain_ms:.2f}, sdpa {lib_ms:.3f})  "
        f"bwd {bwd_ms:.3f} ms {rates['bwd_tflops']:.0f} TFLOP/s, "
        f"{rates['bwd_bound_share']:.1%} of bound {work['bwd_bound_ms']:.3f} "
        f"(plain {plain_bwd_ms:.2f}, sdpa fwd+bwd {lib_fwd_bwd_ms:.3f})"
        f"{maps}")
    return rec


def k4_resources(built: dict) -> list:
    """The bf16 tensor-core kernels' registers, stack and spills from the
    build's ``-Xptxas -v`` output (empty when the library was already
    built) and their dynamic shared memory. The register count is the
    launch's; the consumer warpgroups raise theirs to 240 (setmaxnreg)."""
    from deepspeed_tpu_torch.ops import kernels

    lib = kernels.load("flash_attention")
    entries = ptxas_entries(built.get("flash_attention", {}).get("ptxas", ""))
    rows = []
    for which, kern in enumerate(("flash_fwd_tc_kernel", "flash_dq_tc_kernel",
                                  "flash_dkv_tc_kernel")):
        for D in (64, 128, 256):
            found = [v for name, v in entries.items()
                     if kern in name and f"ILi{D}E" in name]
            row = dict(kernel=f"{kern}<{D}>",
                       smem_bytes=lib.ds_flash_attention_tc_smem(which, D),
                       **(found[0] if found else {}))
            rows.append(row)
            row.setdefault("wgmma_serialized", False)
            log(f"[kernel] K4 {row['kernel']:<26} registers "
                f"{row.get('regs', 'not reported')}, stack "
                f"{row.get('stack', '-')} B, spills "
                f"{row.get('spill_stores', '-')} / "
                f"{row.get('spill_loads', '-')} B, shared memory "
                f"{row['smem_bytes']} B, wgmma serialized "
                f"{row['wgmma_serialized']}")
    return rows


def phase_k4(dev, built: dict) -> tuple[dict, dict, list]:
    """K4's tensor-core kernels' resources (``k4_resources``), then K4 at
    every case of ``K4_CASES`` in fp32 and bf16. Returns the forward and
    backward records' fields (errors over every bf16 case and the worst
    fp32 one; times, bound and yardstick of ``K4_MAIN`` in bf16) and the
    cases, the resources first."""
    cases = [{"resources": k4_resources(built)}]
    for i, (label, B, H, KV, S, D, causal) in enumerate(K4_CASES):
        for dtype in (torch.bfloat16, torch.float32):
            cases.append(k4_run_case(label, B, H, KV, S, D, causal, dtype,
                                     dev, seed=100 + i))
            free_cuda()
    bf = [c for c in cases if c.get("dtype") == "bfloat16"]
    f32 = [c for c in cases if c.get("dtype") == "float32"]
    main = next(c for c in bf if c["case"] == K4_MAIN)

    def errs(names):
        return dict(
            max_abs_err=max(c["errors"][n]["max_abs_err"] for c in bf
                            for n in names),
            max_err_over_max_ref=max(c["errors"][n]["judged"] for c in bf
                                     for n in names),
            max_abs_err_fp32=max(c["errors"][n]["max_abs_err"] for c in f32
                                 for n in names))

    fwd = dict(errs(("out",)), ms=main["ms"], plain_ms=main["plain_ms"],
               bound_ms=main["fwd_bound_ms"], bound_by=main["fwd_bound_by"],
               library_ms=main["library_ms"], tflops=main["fwd_tflops"])
    bwd = dict(errs(("dq", "dk", "dv")), ms=main["bwd_ms"],
               plain_ms=main["plain_bwd_ms"], bound_ms=main["bwd_bound_ms"],
               bound_by=main["bwd_bound_by"],
               library_ms=main["library_fwd_bwd_ms"],
               fwd_bwd_ms=main["ms"] + main["bwd_ms"],
               tflops=main["bwd_tflops"])
    return fwd, bwd, cases


# ---------------------------------------------------------------------------
# K6: block-sparse flash attention; K7: per-layer-slice paged attention
# ---------------------------------------------------------------------------

#: attention widths of the sparse cases: bert-large-uncased's (16 heads of
#: 64) and llama2-7b's (32 heads of 128), with the batch and length each
#: runs at
SPARSE_WIDTHS = {"bert-large": dict(H=16, D=64, B=2, S=4096),
                 "llama2-7b": dict(H=32, D=128, B=1, S=8192)}
#: the sparsity configurations DeepSpeed's sparse attention users pick, each
#: at block 128 with the config's defaults: (label, config, options); the
#: unidirectional one is causal
SPARSE_CONFIGS = (("fixed", "fixed", {}),
                  ("bigbird-per-head", "bigbird",
                   {"different_layout_per_head": True}),
                  ("bslongformer", "bslongformer", {}),
                  ("variable", "variable", {}),
                  ("fixed-causal", "fixed", {"attention": "unidirectional"}))
#: the sparse phase's fp32 parity runs: (width, config label) at S 2048
SPARSE_PARITY = (("bert-large", "bigbird-per-head"),
                 ("llama2-7b", "fixed-causal"))
SPARSE_BLOCK = 128
#: K6's record line reads this case (bf16)
K6_MAIN = "llama2-7b/fixed-causal S=8192"


def sparse_config(label: str, H: int, block: int = SPARSE_BLOCK):
    from deepspeed_tpu_torch.ops.sparse_attention import SPARSITY_CONFIGS

    name, kw = next((c, k) for lab, c, k in SPARSE_CONFIGS if lab == label)
    return SPARSITY_CONFIGS[name](num_heads=H, block=block, **kw)


def k6_holes_layout(H: int, n: int, seed: int):
    """A random layout (density ~0.3, not lower-triangular) with an empty
    query row (0) and a row (1) that sees only the last block, above the
    diagonal: under causal both must give zeros and no gradient."""
    import numpy as np

    layout = np.random.default_rng(seed).random((H, n, n)) < 0.3
    layout[:, 0] = False
    layout[:, 1] = False
    layout[:, 1, n - 1] = True
    return layout


def k6_cases() -> list[dict]:
    """K6's kernel-phase cases: each config of ``SPARSE_CONFIGS`` at
    bert-large width (the bidirectional four) and the causal one at
    llama2-7b width; a dense causal layout at K4's train shape; the holes
    layout; blocks of 256 and of 192."""
    import numpy as np

    cases = []
    bert, llama = SPARSE_WIDTHS["bert-large"], SPARSE_WIDTHS["llama2-7b"]
    for label, _, _ in SPARSE_CONFIGS[:4]:
        cases.append(dict(label=f"bert-large/{label} S={bert['S']}", **bert,
                          block=128, causal=False,
                          layout=sparse_config(label, bert["H"]).make_layout(
                              bert["S"])))
    cases.append(dict(label=K6_MAIN, **llama, block=128, causal=True,
                      layout=sparse_config("fixed-causal", llama["H"])
                      .make_layout(llama["S"])))
    n = 2048 // 128
    cases.append(dict(label="llama2-7b/dense-causal S=2048 (K4's shape)",
                      H=32, D=128, B=2, S=2048, block=128, causal=True,
                      layout=np.ones((32, n, n), bool)))
    cases.append(dict(label="llama2-7b/empty-and-above-diagonal S=2048",
                      H=32, D=128, B=1, S=2048, block=128, causal=True,
                      layout=k6_holes_layout(32, n, seed=11)))
    cases.append(dict(label="bert-large/bigbird-per-head block=256 S=4096",
                      **bert, block=256, causal=False,
                      layout=sparse_config("bigbird-per-head", bert["H"], 256)
                      .make_layout(bert["S"])))
    cases.append(dict(label="bert-large/fixed block=192 S=3072", H=16, D=64,
                      B=2, S=3072, block=192, causal=False,
                      layout=sparse_config("fixed", 16, 192).make_layout(
                          3072)))
    return cases


def k6_work(layout, block, B, H, S, D, causal, dtype) -> dict:
    """K4's convention over the visible token pairs of this layout: 4 x
    pairs x D operations forward, 10 x backward; each input read once and
    each output written once."""
    import numpy as np

    lay = np.asarray(layout, bool)
    n = lay.shape[1]
    if causal:
        qi, kb = np.arange(n)[:, None], np.arange(n)[None]
        per = np.where(kb < qi, block * block,
                       np.where(kb == qi, block * (block + 1) // 2, 0))
        pairs = B * int((lay * per[None]).sum())
    else:
        pairs = B * int(lay.sum()) * block * block
    e = torch.tensor([], dtype=dtype).element_size()
    el, rows = B * H * S * D, B * H * S
    fwd = bound_of(e * 4 * el + 4 * rows, 4.0 * pairs * D / PEAK_OPS[dtype])
    bwd = bound_of(e * 8 * el + 4 * rows, 10.0 * pairs * D / PEAK_OPS[dtype])
    return dict(pairs=pairs, fwd_ops=4.0 * pairs * D,
                bwd_ops=10.0 * pairs * D, fwd_bound_ms=fwd[0],
                fwd_bound_by=fwd[1], bwd_bound_ms=bwd[0], bwd_bound_by=bwd[1])


def k6_run_case(case, dtype, dev, seed) -> dict:
    """One K6 case: the forward and the backward (dq + dk/dv kernels) each
    counted once, no plain launch; out, lse and dq/dk/dv against the plain
    versions by ``K4_TOL``; rows that see no key (under causal: none
    below the diagonal) zeros in out and dq. Then the kernels (forward, dq,
    dk/dv apart and together), the plain versions and, in bf16, the SDPA
    yardstick with the boolean token mask timed. Raises past the
    tolerance."""
    import numpy as np
    import torch.nn.functional as F

    from deepspeed_tpu_torch.ops import block_sparse_attention as bsa
    from deepspeed_tpu_torch.ops import flash_attention as fa
    from deepspeed_tpu_torch.ops.sparse_attention import layout_to_mask

    label, layout, block, causal = (case["label"], case["layout"],
                                    case["block"], case["causal"])
    B, H, S, D = case["B"], case["H"], case["S"], case["D"]
    tables = bsa.device_tables(layout, dev)
    g = torch.Generator(device=dev).manual_seed(seed)
    rnd = lambda sd=1.0: (torch.randn(B, H, S, D, generator=g, device=dev)
                          * sd).to(dtype)
    # q at Q_SD x the keys' spread: a peaked softmax, so a wrong score shows
    q, k, v, do = rnd(Q_SD), rnd(), rnd(), rnd()
    scale = D ** -0.5
    before = dict(vars(bsa.counts))
    out, lse = bsa.block_sparse_fwd(q, k, v, tables, block, causal, scale)
    dq, dk, dv = bsa.block_sparse_bwd(q, k, v, out, lse, do, tables, block,
                                      causal, scale)
    torch.cuda.synchronize()
    bumped = {n: c - before[n] for n, c in vars(bsa.counts).items()}
    if bumped != {"fwd": 1, "bwd": 1, "plain": 0, "plain_bwd": 0}:
        raise AssertionError(f"K6 {label}: counted {bumped}")
    ref_out, ref_lse = bsa.block_sparse_fwd_plain(q, k, v, tables, block,
                                                  causal, scale)
    refs = bsa.block_sparse_bwd_plain(q, k, v, ref_out, ref_lse, do, tables,
                                      block, causal, scale)
    out_tol, grad_tol = K4_TOL[dtype]
    errs = {}
    for name, got, ref in (("out", out, ref_out), ("dq", dq, refs[0]),
                           ("dk", dk, refs[1]), ("dv", dv, refs[2])):
        if not torch.isfinite(got.float()).all():
            raise AssertionError(f"K6 {label} {dtype}: non-finite {name}")
        err = (got.float() - ref.float()).abs().max().item()
        mref = ref.float().abs().max().item()
        judged = err if (name == "out" and dtype == torch.float32) \
            else err / mref
        tol = out_tol if name == "out" else grad_tol
        errs[name] = dict(max_abs_err=err, max_abs_ref=mref, judged=judged,
                          tol=tol)
        if judged > tol:
            raise AssertionError(f"K6 {label} {dtype}: {name} error "
                                 f"{judged:.3e} > {tol:.0e} (max abs {err:.3e}"
                                 f" of max |plain| {mref:.3e})")
    lse_err = (lse - ref_lse).abs().max().item()
    if lse_err > 1e-3:
        raise AssertionError(f"K6 {label} {dtype}: lse error {lse_err:.3e}")
    # rows that see no key: no visible block (or, under causal, none at or
    # below the diagonal)
    lay = np.asarray(layout, bool)
    if causal:
        lay = lay & np.tril(np.ones(lay.shape[1:], bool))[None]
    dead = torch.as_tensor(~lay.any(-1), device=dev).repeat_interleave(
        block, dim=1)                                          # [H, S]
    n_dead = int(dead.sum())
    if n_dead and (out.abs().amax(dim=(0, 3))[dead].max().item() != 0.0
                   or dq.abs().amax(dim=(0, 3))[dead].max().item() != 0.0):
        raise AssertionError(f"K6 {label}: rows that see no key are not 0")
    del ref_out, ref_lse, refs
    dout_c, lse_c, delta = bsa.bwd_operands(q, k, v, out, lse, do)
    args = (tables, block, causal, scale)
    ms = cuda_time_ms(lambda: bsa.block_sparse_fwd(q, k, v, *args), iters=5)
    dq_ms = cuda_time_ms(lambda: bsa.launch_dq(q, k, v, dout_c, lse_c, delta,
                                               *args), iters=5)
    dkv_ms = cuda_time_ms(lambda: bsa.launch_dkv(q, k, v, dout_c, lse_c,
                                                 delta, *args), iters=5)
    bwd_ms = cuda_time_ms(lambda: bsa.block_sparse_bwd(q, k, v, out, lse, do,
                                                       *args), iters=5)
    plain_ms = cuda_time_ms(lambda: bsa.block_sparse_fwd_plain(q, k, v,
                                                               *args),
                            iters=2, warmup=1, graph=False)
    plain_bwd_ms = cuda_time_ms(
        lambda: bsa.block_sparse_bwd_plain(q, k, v, out, lse, do, *args),
        iters=2, warmup=1, graph=False)
    lib_ms = lib_fwd_bwd_ms = k4_ms = k4_bwd_ms = None
    if dtype == torch.bfloat16:
        # yardstick: one SDPA call with the boolean token mask [1, H, S, S]
        mask = layout_to_mask(layout, block, dev)
        if causal:
            mask &= torch.ones(S, S, dtype=torch.bool, device=dev).tril()
        mask = mask[None]
        lib_ms = cuda_time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask), iters=5)
        qr, kr, vr = (t.detach().clone().requires_grad_() for t in (q, k, v))

        def sdpa_fwd_bwd():
            F.scaled_dot_product_attention(qr, kr, vr, attn_mask=mask) \
                .backward(do)

        lib_fwd_bwd_ms = cuda_time_ms(sdpa_fwd_bwd, iters=3, warmup=1,
                                      graph=False)
        del mask, qr, kr, vr
        if np.asarray(layout, bool).all():
            # a dense layout is K4's work: K4 on the same inputs
            k4_ms = cuda_time_ms(lambda: fa.flash_fwd(q, k, v, causal, scale),
                                 iters=5)
            k4_bwd_ms = cuda_time_ms(lambda: fa.flash_bwd(
                q, k, v, out, lse, do, causal, scale), iters=5)
    work = k6_work(layout, block, B, H, S, D, causal, dtype)
    rec = dict(case=label, dtype=str(dtype).replace("torch.", ""), B=B, H=H,
               S=S, D=D, block=block, causal=causal,
               density=float(np.asarray(layout, bool).mean()),
               max_blocks_per_row=int(np.asarray(layout, bool).sum(-1).max()),
               dead_rows=n_dead, errors=errs, lse_err=lse_err, ms=ms,
               dq_ms=dq_ms, dkv_ms=dkv_ms, bwd_ms=bwd_ms, plain_ms=plain_ms,
               plain_bwd_ms=plain_bwd_ms, library_ms=lib_ms,
               library_fwd_bwd_ms=lib_fwd_bwd_ms, k4_ms=k4_ms,
               k4_bwd_ms=k4_bwd_ms, **work)
    sdpa = (f", sdpa {lib_ms:.3f} / fwd+bwd {lib_fwd_bwd_ms:.3f}"
            if lib_ms is not None else "")
    k4 = (f", K4 {k4_ms:.3f} / bwd {k4_bwd_ms:.3f}" if k4_ms is not None
          else "")
    log(f"[kernel] K6 {label:<44} {rec['dtype']:<8} density "
        f"{rec['density']:.3f} err out {errs['out']['judged']:.2e} dq "
        f"{errs['dq']['judged']:.2e} dk {errs['dk']['judged']:.2e} dv "
        f"{errs['dv']['judged']:.2e}  fwd {ms:.3f} ms (bound "
        f"{work['fwd_bound_ms']:.4f} {work['fwd_bound_by']}, plain "
        f"{plain_ms:.2f})  bwd {bwd_ms:.3f} ms (dq {dq_ms:.3f} + dkv "
        f"{dkv_ms:.3f}; bound {work['bwd_bound_ms']:.4f}, plain "
        f"{plain_bwd_ms:.2f}){sdpa}{k4}")
    return rec


def phase_k6(dev) -> tuple[dict, dict, list]:
    """K6 at every case of :func:`k6_cases` in bf16 and fp32. Returns the
    forward and backward records' fields (errors over every case; times,
    bound and yardstick of ``K6_MAIN`` in bf16) and the cases."""
    results = []
    for i, case in enumerate(k6_cases()):
        for dtype in (torch.bfloat16, torch.float32):
            results.append(k6_run_case(case, dtype, dev, seed=300 + i))
            free_cuda()
    bf = [r for r in results if r["dtype"] == "bfloat16"]
    f32 = [r for r in results if r["dtype"] == "float32"]
    main = next(r for r in bf if r["case"] == K6_MAIN)

    def errs(names):
        return dict(
            max_abs_err=max(r["errors"][n]["max_abs_err"] for r in bf
                            for n in names),
            max_err_over_max_ref=max(r["errors"][n]["judged"] for r in bf
                                     for n in names),
            max_abs_err_fp32=max(r["errors"][n]["max_abs_err"] for r in f32
                                 for n in names))

    fwd = dict(errs(("out",)), ms=main["ms"], plain_ms=main["plain_ms"],
               bound_ms=main["fwd_bound_ms"], bound_by=main["fwd_bound_by"],
               library_ms=main["library_ms"])
    bwd = dict(errs(("dq", "dk", "dv")), ms=main["bwd_ms"],
               dq_ms=main["dq_ms"], dkv_ms=main["dkv_ms"],
               plain_ms=main["plain_bwd_ms"], bound_ms=main["bwd_bound_ms"],
               bound_by=main["bwd_bound_by"],
               library_ms=main["library_fwd_bwd_ms"],
               fwd_bwd_ms=main["ms"] + main["bwd_ms"])
    return fwd, bwd, results


@contextlib.contextmanager
def k6_plain_route():
    """K6's wrappers swapped for its plain versions (on any device, counted
    as plain), for the sparse phase's parity reference."""
    from deepspeed_tpu_torch.ops import block_sparse_attention as bsa

    saved = bsa.block_sparse_fwd, bsa.block_sparse_bwd

    def fwd(*a):
        bsa.counts.plain += 1
        return bsa.block_sparse_fwd_plain(*a)

    def bwd(*a):
        bsa.counts.plain_bwd += 1
        return bsa.block_sparse_bwd_plain(*a)

    bsa.block_sparse_fwd, bsa.block_sparse_bwd = fwd, bwd
    try:
        yield
    finally:
        bsa.block_sparse_fwd, bsa.block_sparse_bwd = saved


def sparse_inputs(B, S, H, D, dtype, dev, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    return [(torch.randn(B, S, H, D, generator=g, device=dev) * sd).to(dtype)
            .requires_grad_() for sd in (Q_SD, 1.0, 1.0)]


def phase_sparse(dev) -> dict:
    """``SparseSelfAttention`` end to end on the card: each config of
    ``SPARSE_CONFIGS`` at each width of ``SPARSE_WIDTHS``, bf16, forward and
    ``.backward()`` of a sum-of-squares loss, one warm-up then 5 timed
    iterations; K6 must be launched once forward and once backward per
    call (6 + 6), no plain version and no other kernel. Prints ms per
    forward + backward, tokens/s, peak memory and ``sparsity()``. Then the
    fp32 parity runs of ``SPARSE_PARITY`` at S 2048: the module's output
    and q/k/v grads through K6 against the plain route on the card, by the
    fp32 ``K4_TOL``."""
    from deepspeed_tpu_torch.ops.sparse_attention import SparseSelfAttention

    iters = 5
    runs = {}
    for wname, w in SPARSE_WIDTHS.items():
        B, S, H, D = w["B"], w["S"], w["H"], w["D"]
        for label, _, _ in SPARSE_CONFIGS:
            tag = f"sparse {wname}/{label} S={S}"
            module = SparseSelfAttention(sparse_config(label, H))
            q, k, v = sparse_inputs(B, S, H, D, torch.bfloat16, dev,
                                    seed=len(runs))
            free_cuda()
            torch.cuda.reset_peak_memory_stats()
            reset_counts()

            def step():
                for t in (q, k, v):
                    t.grad = None
                module(q, k, v).float().square().sum().backward()

            step()                                    # warm-up
            times = []
            for _ in range(iters):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                step()
                end.record()
                torch.cuda.synchronize()
                times.append(start.elapsed_time(end))
            launches = all_counts()
            want = {n: 0 for n in launches}
            want.update(k6_fwd=iters + 1, k6_bwd=iters + 1)
            if launches != want:
                raise AssertionError(f"[{tag}] launches {launches} != {want}")
            if not all(torch.isfinite(t.grad.float()).all()
                       for t in (q, k, v)):
                raise AssertionError(f"[{tag}] non-finite gradients")
            ms = statistics.mean(times)
            rec = dict(B=B, S=S, H=H, D=D, ms=ms, times_ms=times,
                       tokens_per_s=B * S / (ms / 1e3),
                       peak_mem_bytes=torch.cuda.max_memory_allocated(),
                       sparsity=module.sparsity(S), launches=launches)
            runs[f"{wname}/{label}"] = rec
            log(f"[{tag}] sparsity {rec['sparsity']:.3f}: {ms:.2f} ms per "
                f"forward + backward (B {B}), {rec['tokens_per_s']:.0f} "
                f"tokens/s, peak memory {rec['peak_mem_bytes'] / 1e9:.2f} "
                f"GB; K6 forward {launches['k6_fwd']}, backward "
                f"{launches['k6_bwd']}, plain {launches['k6_plain']} / "
                f"{launches['k6_plain_bwd']}")
            del q, k, v, module
    parity = {}
    out_tol, grad_tol = K4_TOL[torch.float32]
    for wname, label in SPARSE_PARITY:
        w = SPARSE_WIDTHS[wname]
        H, D, S = w["H"], w["D"], 2048
        tag = f"sparse-parity {wname}/{label} S={S} fp32"
        module = SparseSelfAttention(sparse_config(label, H))
        got = {}
        for route in ("kernel", "plain"):
            q, k, v = sparse_inputs(1, S, H, D, torch.float32, dev, seed=77)
            reset_counts()
            ctx = k6_plain_route() if route == "plain" else \
                contextlib.nullcontext()
            with ctx:
                out = module(q, k, v)
                out.square().sum().backward()
            torch.cuda.synchronize()
            c = all_counts()
            want = (1, 1, 0, 0) if route == "kernel" else (0, 0, 1, 1)
            if (c["k6_fwd"], c["k6_bwd"], c["k6_plain"],
                    c["k6_plain_bwd"]) != want:
                raise AssertionError(f"[{tag}] {route} route counted {c}")
            got[route] = [out.detach(), q.grad, k.grad, v.grad]
        errs = {}
        for name, a, b in zip(("out", "dq", "dk", "dv"), got["kernel"],
                              got["plain"]):
            err = (a - b).abs().max().item()
            judged = err if name == "out" else err / b.abs().max().item()
            tol = out_tol if name == "out" else grad_tol
            errs[name] = judged
            if not judged <= tol:
                raise AssertionError(f"[{tag}] {name} {judged:.3e} > "
                                     f"{tol:.0e}")
        parity[f"{wname}/{label}"] = errs
        log(f"[{tag}] K6 against the plain route on the card: out "
            f"{errs['out']:.2e} (max abs; tol {out_tol:.0e}), dq "
            f"{errs['dq']:.2e} dk {errs['dk']:.2e} dv {errs['dv']:.2e} (of "
            f"max |plain|; tol {grad_tol:.0e})")
        del got, module
        free_cuda()
    return {"runs": runs, "parity": parity,
            "k6_fwd": sum(r["launches"]["k6_fwd"] for r in runs.values()),
            "k6_bwd": sum(r["launches"]["k6_bwd"] for r in runs.values())}


#: K7's record line reads this case (bf16)
K7_MAIN = "llama2-7b/prefill256"


def k7_case(name, *, H, KV, D, bs, T, ctx, dtype, dev, seed, window=None,
            ring_pages=None):
    """Inputs for one K7 case: ``ctx`` lists each slot's context before its
    chunk (-1: an empty slot); the chunk's T tokens are already in the
    pools, so seq_lens = ctx + T and chunk_starts = ctx. Tables are padded
    with the trash page 0; ``ring_pages`` makes each a rolling ring of that
    many pages (``ring_tokens`` = pages x bs)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    S = len(ctx)
    max_pages = ring_pages or max(-(-(c + T) // bs) for c in ctx) + 2
    nb = S * max_pages + 1
    rnd = lambda *shape, sd=1.0: (torch.randn(shape, generator=g, device=dev)
                                  * sd).to(dtype)
    q = rnd(S, T, H, D, sd=Q_SD)
    kp, vp = rnd(KV, nb * bs, D), rnd(KV, nb * bs, D)
    tables = torch.zeros(S, max_pages, dtype=torch.int32)
    perm = torch.randperm(nb - 1, generator=torch.Generator().manual_seed(
        seed)) + 1
    lens, starts, used = [], [], 0
    for s, c in enumerate(ctx):
        if c < 0:
            lens.append(0), starts.append(0)
            continue
        n = ring_pages or -(-(c + T) // bs)
        tables[s, :n] = perm[used:used + n].to(torch.int32)
        used += n
        lens.append(c + T), starts.append(c)
    i32 = lambda x: torch.tensor(x, dtype=torch.int32, device=dev)
    return dict(name=name, q=q, k_pool=kp, v_pool=vp,
                block_tables=tables.to(dev), seq_lens=i32(lens),
                chunk_starts=i32(starts), block_size=bs, window=window,
                ring_tokens=ring_pages * bs if ring_pages else None)


def k7_run_case(case) -> dict:
    """Hold one K7 case against its plain version (counted once as a
    kernel launch of its form, no plain launch; empty slots zeros; live
    slots by ``K1_TOL``), then time the kernel, the plain version and SDPA
    over the gathered K/V with the boolean mask of who sees what. The bound
    counts q, the output and each K/V row some query row of its slot
    sees."""
    import torch.nn.functional as F

    from deepspeed_tpu_torch.ops import paged_attention as pa

    label, q = case["name"], case["q"]
    dtype, (S, T, H, D) = q.dtype, q.shape
    KV, bs = case["k_pool"].shape[0], case["block_size"]
    G = H // KV
    args = [case[k] for k in ("q", "k_pool", "v_pool", "block_tables",
                              "seq_lens", "chunk_starts")]
    kw = dict(block_size=bs, window=case["window"],
              ring_tokens=case["ring_tokens"])
    decode = T == 1
    before = dict(vars(pa.prefill_counts))
    if decode:        # through the decode entry: starts = seq_lens - 1
        got = pa.paged_decode_attention(q[:, 0], *args[1:5], **kw)[:, None]
    else:
        got = pa.paged_prefill_attention(*args, **kw)
    torch.cuda.synchronize()
    bumped = {n: c - before[n] for n, c in vars(pa.prefill_counts).items()}
    want = {"kernel": 1, "kernel_window": int(bool(kw["window"])),
            "kernel_ring": int(bool(kw["ring_tokens"])), "plain": 0}
    if bumped != want:
        raise AssertionError(f"K7 {label}: counted {bumped}, not {want}")
    ref = pa.paged_prefill_attention_reference(*args, **kw)
    live = case["seq_lens"] > 0
    if (~live).any() and got[~live].abs().max().item() != 0.0:
        raise AssertionError(f"K7 {label}: empty slot not 0")
    if not torch.isfinite(got).all():
        raise AssertionError(f"K7 {label}: non-finite output")
    err = (got[live].float() - ref[live].float()).abs().max().item()
    max_ref = ref[live].float().abs().max().item()
    judged = err if dtype == torch.float32 else err / max_ref
    tol = K1_TOL[dtype]
    if judged > tol:
        raise AssertionError(f"K7 {label} {dtype}: kernel against plain "
                             f"error {judged:.3e} (tol {tol:.0e}); max abs "
                             f"{err:.3e}")
    del ref
    ms = cuda_time_ms(lambda: pa.paged_prefill_attention(*args, **kw))
    plain_ms = cuda_time_ms(
        lambda: pa.paged_prefill_attention_reference(*args, **kw), iters=2,
        warmup=1, graph=False)
    # SDPA over every table column gathered dense, under the mask of which
    # (run) column each row sees
    _, run, mask = pa.prefill_key_visibility(
        case["block_tables"], case["seq_lens"], case["chunk_starts"], T=T,
        block_size=bs, window=kw["window"], ring_tokens=kw["ring_tokens"])
    mask = mask & run[:, None]
    col = torch.arange(mask.shape[-1], device=q.device)
    rows = case["block_tables"].long()[:, col // bs] * bs + col % bs
    kd = case["k_pool"][:, rows].permute(1, 0, 2, 3).repeat_interleave(
        G, dim=1)
    vd = case["v_pool"][:, rows].permute(1, 0, 2, 3).repeat_interleave(
        G, dim=1)
    qh, m4 = q.permute(0, 2, 1, 3), mask[:, None]
    lib_ms = cuda_time_ms(lambda: F.scaled_dot_product_attention(
        qh, kd, vd, attn_mask=m4), iters=5, warmup=1)
    seen = int((mask & live[:, None, None]).any(dim=1).sum())
    el = q.element_size()
    nbytes = 2 * q.numel() * el + 2 * KV * D * seen * el
    ops_s = 4.0 * D * int(mask.sum()) * G * KV / PEAK_OPS[dtype]
    bound, by = bound_of(nbytes, ops_s)
    rec = dict(case=label, dtype=str(dtype).replace("torch.", ""),
               max_abs_err=err, judged_err=judged, max_abs_ref=max_ref,
               tol=tol, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
               bound_ms=bound, bound_by=by, bytes=nbytes, keys_seen=seen)
    log(f"[kernel] K7 {label:<34} {rec['dtype']:<8} err {judged:.2e} (tol "
        f"{tol:.0e}; max abs {err:.2e} of max |plain| {max_ref:.2f})  "
        f"kernel {ms:.4f} ms  plain {plain_ms:.3f} ms  sdpa {lib_ms:.3f} ms"
        f"  bound {bound:.4f} ms ({by})")
    return rec


def phase_k7(dev) -> tuple[dict, list]:
    """K7 against its plain version at llama2-7b geometry (decode of 8 slots
    at 256-4000 context, a 4 x 256 prefill chunk over 0-768) and mistral-7b
    geometry with its 4096 window, on a linear table and on a wrapped
    69-page ring (decode, a 4 x 256 chunk), in fp32 and bf16. Returns (the
    record's fields, cases); ``launches`` counts the checked calls."""
    llama = dict(H=32, KV=32, D=128)
    shapes = [
        ("llama2-7b/decode", llama, dict(
            T=1, ctx=[255, 700, 1023, 1500, 2047, 3000, 3999, -1])),
        ("llama2-7b/prefill256", llama, dict(T=256, ctx=[0, 256, 512, 768])),
        ("mistral-7b/window-decode", MISTRAL, dict(
            T=1, ctx=[5800, 5905, 6000, 6100, 5999, 6050, 5877, -1],
            window=MISTRAL_WINDOW)),
        ("mistral-7b/window-prefill256", MISTRAL, dict(
            T=256, ctx=[5632, 5760, 5888, 6016], window=MISTRAL_WINDOW)),
        ("mistral-7b/ring-decode", MISTRAL, dict(
            T=1, ctx=[5800, 5905, 6000, 6100, 5999, 6050, 5877, -1],
            window=MISTRAL_WINDOW, ring_pages=MISTRAL_RING_PAGES)),
        ("mistral-7b/ring-prefill256", MISTRAL, dict(
            T=256, ctx=[5632, 5760, 5888, 6016], window=MISTRAL_WINDOW,
            ring_pages=MISTRAL_RING_PAGES)),
    ]
    results = []
    for seed, (dtype, (label, geom, shape)) in enumerate(
            ((dt, s) for dt in (torch.float32, torch.bfloat16)
             for s in shapes), start=500):
        case = k7_case(label, bs=64, dtype=dtype, dev=dev, seed=seed,
                       **geom, **shape)
        results.append(k7_run_case(case))
        del case
        free_cuda()
    bf = [r for r in results if r["dtype"] == "bfloat16"]
    main = next(r for r in bf if r["case"] == K7_MAIN)
    summary = dict(max_abs_err=max(r["max_abs_err"] for r in bf),
                   max_err_over_max_ref=max(r["judged_err"] for r in bf),
                   max_abs_err_fp32=max(r["max_abs_err"] for r in results
                                        if r["dtype"] == "float32"),
                   launches=len(results),
                   **{k: main[k] for k in ("ms", "plain_ms", "library_ms",
                                           "bound_ms", "bound_by")})
    return summary, results


# ---------------------------------------------------------------------------
# train: one-process dense training through the port's engine
# ---------------------------------------------------------------------------

#: the train phase: llama2-7b's width (E 4096, H 32, D 128, F 11008, vocab
#: 32000) at 8 layers (~1.9 B parameters: the full depth with Adam needs
#: ~112 GB of fp32 master, moments and grads, and waits for offload), bf16
#: with an fp32 master, AdamW, micro-batch 2 x gas 2 of 2048 tokens, remat
#: "full", 5 steps on one repeated batch
TRAIN = dict(name="llama2-7b", layers=8, micro=2, gas=2, seq=2048, steps=5)
#: the train parity phase: the same width at 4 layers in fp32 (TF32 off),
#: 1 x 2 sequences of 1024 tokens, 3 steps, K4 against the plain route
TRAIN_PARITY = dict(name="llama2-7b", layers=4, micro=1, gas=2, seq=1024,
                    steps=3)


def train_config(spec: dict, **over) -> dict:
    cfg = {"train_micro_batch_size_per_gpu": spec["micro"],
           "gradient_accumulation_steps": spec["gas"],
           "optimizer": {"type": "AdamW",
                         "params": {"lr": 1e-4, "weight_decay": 0.01}},
           "steps_per_print": 10 ** 9}
    cfg.update(over)
    return cfg


def train_batch_of(spec: dict, vocab: int, seed: int) -> dict:
    g = torch.Generator().manual_seed(seed)
    B = spec["micro"] * spec["gas"]
    return {"input_ids": torch.randint(0, vocab, (B, spec["seq"]),
                                       generator=g)}


def phase_train(dev) -> dict:
    """``initialize`` the train model on the card and take ``TRAIN["steps"]``
    steps; every loss finite and the last below the first; K4's forward
    launched layers x micro-batches x 2 (remat runs each layer's forward
    again) per step, its backward layers x micro-batches, its plain
    versions and every other kernel never. Prints tokens/s and ms per step
    (steps after the first), peak memory, and K4's share of a profiled
    step."""
    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.models import build_model

    spec = TRAIN
    tag = f"train {spec['name']} x{spec['layers']}"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    free_cuda()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build_model(spec["name"], num_layers=spec["layers"],
                        dtype=torch.bfloat16, param_dtype=torch.float32,
                        device=dev, seed=0)
    engine, *_ = dst.initialize(model=model, config=train_config(
        spec, activation_checkpointing={"policy": "full"}))
    if engine.device != dev or not engine.bf16_enabled:
        raise AssertionError(f"[{tag}] engine on {engine.device}, bf16 "
                             f"{engine.bf16_enabled}")
    batch = train_batch_of(spec, model.config.vocab_size, seed=3)
    tokens = batch["input_ids"].numel()
    setup_s = time.perf_counter() - t0
    L, gas, steps = spec["layers"], spec["gas"], spec["steps"]
    reset_counts()
    losses, step_s = [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        ts = time.perf_counter()
        losses.append(float(engine.train_batch(batch)))
        step_s.append(time.perf_counter() - ts)
    launches = all_counts()
    want = {k: 0 for k in launches}
    want.update(k4_fwd=L * gas * 2 * steps, k4_bwd=L * gas * steps)
    if launches != want:
        raise AssertionError(f"[{tag}] launches {launches} != {want}")
    if not all(math.isfinite(x) for x in losses) or \
            not losses[-1] < losses[0]:
        raise AssertionError(f"[{tag}] losses {losses}: not finite and "
                             f"falling on a repeated batch")
    peak = torch.cuda.max_memory_allocated()
    ms_step = statistics.mean(step_s[1:]) * 1e3
    prof = device_breakdown(lambda: engine.train_batch(batch))
    k4_share = (prof["k4_ms"] / prof["wall_ms"]
                if prof.get("device") != "not measured" else "not measured")
    rec = dict(params=engine.num_parameters(), tokens_per_step=tokens,
               losses=losses, step_s=step_s, ms_per_step=ms_step,
               tokens_per_s=tokens / (ms_step / 1e3), peak_mem_bytes=peak,
               setup_s=setup_s, launches=launches, profile=prof,
               k4_share_of_step=k4_share)
    log(f"[{tag}] {rec['params'] / 1e9:.2f} B parameters, {tokens} tokens a "
        f"step (micro {spec['micro']} x gas {gas} x {spec['seq']}): losses "
        f"{', '.join(f'{x:.4f}' for x in losses)}; {ms_step:.1f} ms/step, "
        f"{rec['tokens_per_s']:.0f} tokens/s, peak memory {peak / 1e9:.1f} "
        f"GB; K4 {prof.get('k4_ms', 0.0):.1f} of {prof['wall_ms']:.1f} ms in "
        f"a profiled step (share {k4_share}); launches {launches}")
    engine.close()
    del engine, model
    free_cuda()
    return rec


def phase_train_parity(dev) -> dict:
    """The same width at 4 layers in fp32 with TF32 off, from one seeded
    init and one batch, trained ``TRAIN_PARITY["steps"]`` steps twice: with
    ``attn_impl="pallas"`` (K4, every attention counted) and ``"xla"`` (the
    plain route, K4 never launched). Losses within 1e-5 relative; every
    parameter after the last step within 1e-4 of the largest |parameter|,
    and the two runs' parameter changes within 1e-2 of the largest change
    that training made (three steps move an element by about 3e-4, so the
    first limit alone would pass a wrong update direction). AdamW with eps
    1e-5, so an element whose gradient sits within summation noise of zero
    (the two routes sum in other orders) cannot take a full-size step of
    opposite sign in the two runs."""
    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.models import build_model

    spec = TRAIN_PARITY
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    L, gas, steps = spec["layers"], spec["gas"], spec["steps"]
    flat = lambda t: [x for v in t.values() for x in
                      (flat(v) if isinstance(v, dict) else [v])]
    runs, masters = {}, {}
    for impl in ("pallas", "xla"):
        tag = f"train parity {spec['name']} x{L} fp32 {impl}"
        model = build_model(spec["name"], num_layers=L, dtype=torch.float32,
                            device=dev, seed=0, attn_impl=impl)
        engine, *_ = dst.initialize(model=model, config=train_config(
            spec, bf16={"enabled": False},
            optimizer={"type": "AdamW",
                       "params": {"lr": 1e-4, "eps": 1e-5,
                                  "weight_decay": 0.01}}))
        batch = train_batch_of(spec, model.config.vocab_size, seed=4)
        if impl == "xla":
            p0 = [x.clone() for x in flat(engine.master)]
        reset_counts()
        losses = [float(engine.train_batch(batch)) for _ in range(steps)]
        launches = all_counts()
        want = {k: 0 for k in launches}
        if impl == "pallas":
            want.update(k4_fwd=L * gas * steps, k4_bwd=L * gas * steps)
        if launches != want:
            raise AssertionError(f"[{tag}] launches {launches} != {want}")
        runs[impl] = dict(losses=losses, launches=launches)
        masters[impl] = engine.master
        log(f"[{tag}] losses {', '.join(f'{x:.6f}' for x in losses)}; "
            f"launches {launches}")
        engine.close()
        del engine, model
    rel = max(abs(a - b) / abs(b) for a, b in
              zip(runs["pallas"]["losses"], runs["xla"]["losses"]))
    pk, px = flat(masters["pallas"]), flat(masters["xla"])
    diff = max((a - b).abs().max().item() for a, b in zip(pk, px))
    scale = max(b.abs().max().item() for b in px)
    moved = max((b - a).abs().max().item() for a, b in zip(p0, px))
    out = dict(runs=runs, max_rel_loss_diff=rel, max_param_diff=diff,
               max_abs_param=scale, max_param_change=moved,
               param_diff_over_change=diff / moved)
    log(f"[train parity] K4 against the plain route: losses within "
        f"{rel:.2e} relative (limit 1e-5), parameters within {diff:.2e} of "
        f"max |param| {scale:.3f} (limit 1e-4 of it); the largest change "
        f"training made is {moved:.3e}, the runs' changes differ by "
        f"{diff / moved:.2e} of it (limit 1e-2)")
    del masters, pk, px, p0
    free_cuda()
    if rel > 1e-5 or diff > 1e-4 * scale or diff > 1e-2 * moved:
        raise AssertionError(f"[train parity] losses {rel:.2e} relative, "
                             f"params {diff:.2e} apart, "
                             f"{diff / moved:.2e} of the largest change")
    return out


# ---------------------------------------------------------------------------
# moe-train: MoE training through the port's engine, K5 forward and backward
# ---------------------------------------------------------------------------

#: the moe-train phase: qwen2-moe-a2.7b's width (E 2048, H 16, 60 experts
#: top-4 of F 1408, a sigmoid-gated shared expert of 5632, vocab 151936, qkv
#: bias) at 4 layers (~2.9 B parameters: its 24 layers with Adam need ~230
#: GB), ``moe.dropless``, bf16 with an fp32 master, AdamW, micro-batch 2 x
#: gas 2 of 2048 tokens, remat "full", 5 steps on one repeated batch
MOE_TRAIN = dict(name="qwen2-moe-a2.7b", layers=4, micro=2, gas=2, seq=2048,
                 steps=5)
#: the moe-train parity phase: the same width at 2 layers in fp32 (TF32
#: off), 1 x 2 sequences of 1024 tokens, 3 steps, K5 against its plain route
MOE_TRAIN_PARITY = dict(name="qwen2-moe-a2.7b", layers=2, micro=1, gas=2,
                        seq=1024, steps=3)


def dropless_model(spec: dict, dev, **over):
    """``spec``'s preset at its depth with ``moe.dropless`` on, seeded."""
    from deepspeed_tpu_torch.models import build_model, get_model_config

    moe = dataclasses.replace(get_model_config(spec["name"]).moe,
                              dropless=True)
    return build_model(spec["name"], num_layers=spec["layers"], moe=moe,
                       device=dev, seed=0, **over)


@contextlib.contextmanager
def k5_plain_route():
    """K5's plain versions on the card, for the parity phase's reference
    run only: the wrappers' kernel launches (forward, dx, dw) swapped for
    the plain versions, counted as plain."""
    from deepspeed_tpu_torch.ops import grouped_matmul as gm

    def fwd(x, w, te, bm, tr):
        gm.counts.plain += 1
        return gm.grouped_matmul_reference(x, w, te, bm, tr)

    def dx(dy, w, te, bm, tr):
        gm.counts.plain_dx += 1
        return gm.grouped_matmul_dx_reference(dy, w, te, bm, tr)

    def dw(x, dy, te, n, bm, tr, dtype):
        gm.counts.plain_dw += 1
        return gm.grouped_matmul_dw_reference(x, dy, te, n, bm, tr, dtype)

    saved = gm._launch_kernel, gm._launch_dx, gm._launch_dw
    gm._launch_kernel, gm._launch_dx, gm._launch_dw = fwd, dx, dw
    try:
        yield
    finally:
        gm._launch_kernel, gm._launch_dx, gm._launch_dw = saved


def phase_moe_train_parity(dev) -> dict:
    """qwen2-moe's width at ``MOE_TRAIN_PARITY["layers"]`` layers in fp32
    (TF32 off) on the dropless route, from one seeded init and one batch,
    trained ``steps`` steps twice: through K5's kernels (forward, dx and dw
    each counted 3 x layers x micro-batches a step) and through K5's plain
    versions on the card (``k5_plain_route``; no K5 kernel launched). K4
    runs every attention in both. Losses within 1e-6 relative; every
    parameter within 1e-4 of the largest |parameter|, and the two runs'
    parameter changes within 1e-2 of the largest change training made.
    AdamW with eps 1e-5 (see ``phase_train_parity``)."""
    import deepspeed_tpu_torch as dst

    spec = MOE_TRAIN_PARITY
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    L, gas, steps = spec["layers"], spec["gas"], spec["steps"]
    flat = lambda t: [x for v in t.values() for x in
                      (flat(v) if isinstance(v, dict) else [v])]
    runs, masters = {}, {}
    for route in ("kernel", "plain"):
        tag = f"moe train parity {spec['name']} x{L} fp32 {route}"
        model = dropless_model(spec, dev, dtype=torch.float32)
        engine, *_ = dst.initialize(model=model, config=train_config(
            spec, bf16={"enabled": False},
            optimizer={"type": "AdamW",
                       "params": {"lr": 1e-4, "eps": 1e-5,
                                  "weight_decay": 0.01}}))
        batch = train_batch_of(spec, model.config.vocab_size, seed=5)
        if route == "plain":
            p0 = [x.clone() for x in flat(engine.master)]
        reset_counts()
        with (k5_plain_route() if route == "plain"
              else contextlib.nullcontext()):
            losses = [float(engine.train_batch(batch)) for _ in range(steps)]
        launches = all_counts()
        per = 3 * L * gas * steps
        want = {k: 0 for k in launches}
        want.update(k4_fwd=L * gas * steps, k4_bwd=L * gas * steps)
        if route == "kernel":
            want.update(k5=per, k5_dx=per, k5_dw=per)
        else:
            want.update(k5_plain=per, k5_plain_dx=per, k5_plain_dw=per)
        if launches != want:
            raise AssertionError(f"[{tag}] launches {launches} != {want}")
        runs[route] = dict(losses=losses, launches=launches)
        masters[route] = engine.master
        log(f"[{tag}] losses {', '.join(f'{x:.6f}' for x in losses)}; "
            f"launches {launches}")
        engine.close()
        del engine, model
        free_cuda()
    rel = max(abs(a - b) / abs(b) for a, b in
              zip(runs["kernel"]["losses"], runs["plain"]["losses"]))
    pk, pp = flat(masters["kernel"]), flat(masters["plain"])
    diff = max((a - b).abs().max().item() for a, b in zip(pk, pp))
    scale = max(b.abs().max().item() for b in pp)
    moved = max((b - a).abs().max().item() for a, b in zip(p0, pp))
    out = dict(runs=runs, max_rel_loss_diff=rel, max_param_diff=diff,
               max_abs_param=scale, max_param_change=moved,
               param_diff_over_change=diff / moved)
    log(f"[moe train parity] K5 against its plain route: losses within "
        f"{rel:.2e} relative (limit 1e-6), parameters within {diff:.2e} of "
        f"max |param| {scale:.3f} (limit 1e-4 of it); the largest change "
        f"training made is {moved:.3e}, the runs' changes differ by "
        f"{diff / moved:.2e} of it (limit 1e-2)")
    del masters, pk, pp, p0
    free_cuda()
    if rel > 1e-6 or diff > 1e-4 * scale or diff > 1e-2 * moved:
        raise AssertionError(f"[moe train parity] losses {rel:.2e} relative, "
                             f"params {diff:.2e} apart, "
                             f"{diff / moved:.2e} of the largest change")
    return out


def phase_moe_train(dev) -> dict:
    """``initialize`` the ``MOE_TRAIN`` model on the card and take its steps;
    every loss finite and the last below the first. Launches per run: K5's
    forward 3 products x layers x micro-batches x 2 (remat runs each
    layer's forward again) x steps, its dx and dw 3 x layers x
    micro-batches x steps; K4's forward layers x micro-batches x 2 x steps,
    its backward layers x micro-batches x steps; no plain version and no
    other kernel. Prints ms per step, tokens/s, peak memory, the loss curve
    and one profiled step's split (K4, K5 forward / dx / dw, cuBLAS, other,
    idle share)."""
    import deepspeed_tpu_torch as dst

    spec = MOE_TRAIN
    tag = f"moe train {spec['name']} x{spec['layers']}"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    free_cuda()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = dropless_model(spec, dev, dtype=torch.bfloat16,
                           param_dtype=torch.float32)
    engine, *_ = dst.initialize(model=model, config=train_config(
        spec, activation_checkpointing={"policy": "full"}))
    if engine.device != dev or not engine.bf16_enabled:
        raise AssertionError(f"[{tag}] engine on {engine.device}, bf16 "
                             f"{engine.bf16_enabled}")
    batch = train_batch_of(spec, model.config.vocab_size, seed=6)
    tokens = batch["input_ids"].numel()
    setup_s = time.perf_counter() - t0
    L, gas, steps = spec["layers"], spec["gas"], spec["steps"]
    reset_counts()
    losses, step_s = [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        ts = time.perf_counter()
        losses.append(float(engine.train_batch(batch)))
        step_s.append(time.perf_counter() - ts)
    launches = all_counts()
    passes = L * gas * steps
    want = {k: 0 for k in launches}
    want.update(k5=3 * passes * 2, k5_dx=3 * passes, k5_dw=3 * passes,
                k4_fwd=passes * 2, k4_bwd=passes)
    if launches != want:
        raise AssertionError(f"[{tag}] launches {launches} != {want}")
    if not all(math.isfinite(x) for x in losses) or \
            not losses[-1] < losses[0]:
        raise AssertionError(f"[{tag}] losses {losses}: not finite and "
                             f"falling on a repeated batch")
    peak = torch.cuda.max_memory_allocated()
    ms_step = statistics.mean(step_s[1:]) * 1e3
    prof = device_breakdown(lambda: engine.train_batch(batch))
    rec = dict(params=engine.num_parameters(), tokens_per_step=tokens,
               losses=losses, step_s=step_s, ms_per_step=ms_step,
               tokens_per_s=tokens / (ms_step / 1e3), peak_mem_bytes=peak,
               setup_s=setup_s, launches=launches, profile=prof)
    split = ("not measured" if prof.get("device") == "not measured" else
             ", ".join(f"{k[:-3]} {prof[k]:.1f}" for k in (
                 "k4_ms", "k5_ms", "k5_dx_ms", "k5_dw_ms", "gemm_ms",
                 "other_ms")) + f" of {prof['wall_ms']:.1f} ms wall, idle "
             f"{prof['idle_share']:.3f}")
    log(f"[{tag}] {rec['params'] / 1e9:.2f} B parameters, {tokens} tokens a "
        f"step (micro {spec['micro']} x gas {gas} x {spec['seq']}): losses "
        f"{', '.join(f'{x:.4f}' for x in losses)}; {ms_step:.1f} ms/step, "
        f"{rec['tokens_per_s']:.0f} tokens/s, peak memory {peak / 1e9:.1f} "
        f"GB; profiled step (ms): {split}; launches {launches}")
    engine.close()
    del engine, model
    free_cuda()
    return rec


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
    # K1's forms, each counted apart (a ring launch is a window launch too)
    k1_forms = {form: {"name": f"paged_ragged_attention ({what})",
                       "route": "cuda",
                       "source": "deepspeed_tpu_torch/ops/csrc/"
                                 "paged_attention.cu",
                       "replaces": f"deepspeed_tpu/ops/pallas/"
                                   f"paged_attention.py:{line}",
                       "launches": None}
                for form, what, line in (
                    ("window", "sliding window", 242),
                    ("ring", "rolling ring", 264),
                    ("tree", "tree verify", 233))}
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
    # K5's backward: dx is `_gmm_kernel` with transpose_rhs=True (called
    # from `_gmm_bwd` :188), dw `_dw_kernel` :130 (call :173)
    k5_dx = {"name": "grouped_matmul (backward dx)", "route": "cuda",
             "source": "deepspeed_tpu_torch/ops/csrc/grouped_matmul.cu",
             "replaces": "deepspeed_tpu/ops/pallas/grouped_matmul.py:51 "
                         "(transpose_rhs=True, :188)",
             "launches": None}
    k5_dw = {"name": "grouped_matmul (backward dw)", "route": "cuda",
             "source": "deepspeed_tpu_torch/ops/csrc/grouped_matmul.cu",
             "replaces": "deepspeed_tpu/ops/pallas/grouped_matmul.py:130",
             "launches": None}
    # K4's forward, and its backward (dq kernel + dk/dv kernel, counted once
    # a call). The backward's numbers come from the train shape, S = 2048,
    # where the Pallas package runs the split `_dq_kernel` / `_dkv_kernel`
    # (:275, :312); the same CUDA entry stands in for the merged
    # `_dqkv_kernel` (:356) at S <= 1024
    k4_fwd = {"name": "flash_attention (forward)", "route": "cuda",
              "source": "deepspeed_tpu_torch/ops/csrc/flash_attention.cu",
              "replaces": "deepspeed_tpu/ops/pallas/flash_attention.py:183",
              "launches": None}
    k4_bwd = {"name": "flash_attention (backward)", "route": "cuda",
              "source": "deepspeed_tpu_torch/ops/csrc/flash_attention.cu",
              "replaces": "deepspeed_tpu/ops/pallas/flash_attention.py:275 "
                          "and :312",
              "launches": None}
    # K6's forward, and its backward (dq kernel + dk/dv kernel, counted once
    # a call); their launches come from the sparse phase. K7 has no caller
    # on any path of either package: its launches are the kernel phase's
    k6_fwd = {"name": "block_sparse_flash_attention (forward)",
              "route": "cuda",
              "source": "deepspeed_tpu_torch/ops/csrc/"
                        "block_sparse_attention.cu",
              "replaces": "deepspeed_tpu/ops/pallas/"
                          "block_sparse_attention.py:95",
              "launches": None}
    k6_bwd = {"name": "block_sparse_flash_attention (backward)",
              "route": "cuda",
              "source": "deepspeed_tpu_torch/ops/csrc/"
                        "block_sparse_attention.cu",
              "replaces": "deepspeed_tpu/ops/pallas/"
                          "block_sparse_attention.py:180 and :215",
              "launches": None}
    k7 = {"name": "paged_prefill_attention", "route": "cuda",
          "source": "deepspeed_tpu_torch/ops/csrc/paged_attention.cu",
          "replaces": "deepspeed_tpu/ops/pallas/paged_attention.py:56",
          "launches": None}
    built = phase_build()          # every later phase runs the kernels
    record["phases"]["build"] = {n: r["seconds"] for n, r in built.items()}
    if "kernel" in phases:
        default, e4m3, cases = phase_k1(dev)
        k1.update(default)
        k1_e4m3.update(e4m3)
        forms, form_cases = phase_k1_forms(dev)
        for form, summary in forms.items():
            k1_forms[form].update(summary)
        cases += form_cases
        k2_summary, k2_cases = phase_k2(dev)
        k2.update(k2_summary)
        k5_summary, k5_cases = phase_k5(dev)
        k5.update(k5_summary)
        k5_dx_summary, k5_dw_summary, k5_bwd_cases = phase_k5_bwd(dev)
        k5_dx.update(k5_dx_summary)
        k5_dw.update(k5_dw_summary)
        k5_cases += k5_bwd_cases
        k3_summary, k3_cases = phase_k3(dev)
        k3.update(k3_summary)
        k4f_summary, k4b_summary, k4_cases = phase_k4(dev, built)
        k4_fwd.update(k4f_summary)
        k4_bwd.update(k4b_summary)
        k6f_summary, k6b_summary, k6_cases = phase_k6(dev)
        k6_fwd.update(k6f_summary)
        k6_bwd.update(k6b_summary)
        k7_summary, k7_cases = phase_k7(dev)
        k7.update(k7_summary)
        record["phases"]["kernel"] = {"k1": cases, "k2": k2_cases,
                                      "k3": k3_cases, "k4": k4_cases,
                                      "k5": k5_cases, "k6": k6_cases,
                                      "k7": k7_cases}
    if "parity" in phases:
        record["phases"]["parity"] = phase_parity(dev)
    if "serve" in phases:
        serve = phase_serve(dev)
        record["phases"]["serve"] = serve
        # each kernel's launches summed over the serve runs (each run's
        # counts start at 0)
        runs = [run for model in serve.values() for run in model.values()]
        for rec, key in ((k1, "k1"), (k1_e4m3, "k1_e4m3"),
                         (k1_forms["window"], "k1_window"),
                         (k1_forms["ring"], "k1_ring"),
                         (k1_forms["tree"], "k1_tree"), (k2, "k2"),
                         (k3, "k3"), (k5, "k5")):
            rec["launches"] = sum(run["launches"][key] for run in runs)
    if "train-parity" in phases:
        record["phases"]["train-parity"] = phase_train_parity(dev)
    if "train" in phases:
        train = phase_train(dev)
        record["phases"]["train"] = train
        k4_fwd["launches"] = train["launches"]["k4_fwd"]
        k4_bwd["launches"] = train["launches"]["k4_bwd"]
    if "moe-train-parity" in phases:
        record["phases"]["moe-train-parity"] = phase_moe_train_parity(dev)
    if "moe-train" in phases:
        moe_train = phase_moe_train(dev)
        record["phases"]["moe-train"] = moe_train
        got = moe_train["launches"]
        # K5's forward runs on the serving and the MoE training paths; K4
        # on both training paths
        k5["launches"] = (k5["launches"] or 0) + got["k5"]
        k5_dx["launches"] = got["k5_dx"]
        k5_dw["launches"] = got["k5_dw"]
        k4_fwd["launches"] = (k4_fwd["launches"] or 0) + got["k4_fwd"]
        k4_bwd["launches"] = (k4_bwd["launches"] or 0) + got["k4_bwd"]
    if "sparse" in phases:
        sparse = phase_sparse(dev)
        record["phases"]["sparse"] = sparse
        k6_fwd["launches"] = sparse["k6_fwd"]
        k6_bwd["launches"] = sparse["k6_bwd"]
    record["seconds"] = time.perf_counter() - t_start
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "chip_smoke.json"), "w") as f:
        json.dump(record, f, indent=1, default=str)
    log(f"[done] {record['seconds']:.1f}s")
    log(json.dumps({"kernels": [k1, k1_e4m3, *k1_forms.values(), k2, k3,
                                k4_fwd, k4_bwd, k5, k5_dx, k5_dw, k6_fwd,
                                k6_bwd, k7]}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
