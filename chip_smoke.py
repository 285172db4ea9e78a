"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py [--phases build,kernel,parity,serve] [--out DIR]

Phases (every one raises on failure; nothing is caught and passed over):

1. build  — compile every CUDA kernel of the port from ``ops/csrc`` with
   nvcc for sm_90a, all sources at once, and print the build times.
2. kernel — hold the paged-attention kernel (K1) against its plain PyTorch
   version on the card at the serving path's shapes (llama2-7b geometry and
   a GQA geometry; decode, a 256-token prefill chunk over several pool pages,
   a window-shaped stage; an empty slot and trash-padded block tables), in
   fp32 (max absolute error 1e-4) and bf16 (max absolute error over max
   |plain| 1e-2: p is rounded to bf16 before the PV product, in a different
   order than the plain version's). q is drawn at 3x the keys' spread so the
   softmax is peaked and a wrong score shows in the output.
   Prints per case the error and the times of the kernel, the plain version
   and one ``scaled_dot_product_attention`` call over the same K/V gathered
   dense (a yardstick only: the port never calls it), and the kernel's
   bound.
3. parity — llama2-7b at full width with 4 layers in fp32: the engine's
   greedy streams against a greedy loop over the dense
   ``TransformerLM.forward``. TF32 is off for matmuls and cuDNN. Streams
   must be identical and every sampled step's logits agree within 1e-3
   relative; the one allowed exception is a step where the oracle's top-2
   logit gap is below 1e-4 (a near-tie in random weights), printed as such.
4. serve  — llama2-7b at full width and depth in bf16 from seeded random
   weights: 8 requests of 256-1024 prompt tokens (a shared 128-token system
   prefix) and 64 new tokens each, through put/step/query/flush. Prints
   output tok/s, p50 TTFT, decode ms/token, peak memory and K1's launches,
   which must equal layers x forward dispatches, with the plain version's
   count 0.

The last lines are the kernels' JSON record, the card's name and power
limit, and ``{"ok": true, "device": {...}}``. Without a CUDA device the
script exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

import torch

#: H100 SXM peaks (NVIDIA data sheet; dense, at the full 700 W limit)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

ALL_PHASES = ("build", "kernel", "parity", "serve")

#: spread of the K1 cases' q against unit-normal K/V (see k1_case)
Q_SD = 3.0
#: K1 against its plain version: fp32 by absolute error; bf16 by the max
#: absolute error over max |plain|, since p and the output round to bf16
K1_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}


def k1_error(got, ref, dtype) -> tuple[float, float]:
    """(max |got - ref|, the error the tolerance judges: the same for fp32,
    over max |ref| for bf16)."""
    err = (got.float() - ref.float()).abs().max().item()
    if dtype == torch.float32:
        return err, err
    return err, err / ref.float().abs().max().item()


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn()`` in ms, from CUDA events around
    ``iters`` back-to-back calls after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


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
# phase 2: K1 against its plain version
# ---------------------------------------------------------------------------

def k1_case(name, *, H, KV, D, bs, T, Ts, ctx, dtype, dev, seed,
            window=False, nb=256, L=2):
    """Inputs for one K1 case: ``ctx`` lists each slot's pool context
    (positions below stage_starts), -1 for an empty slot. Each live slot's
    stage holds its fresh rows: a ragged prefill chunk, the one decode
    token, or (``window``) 1-8 rows of a decode window whose query is the
    last of them."""
    g = torch.Generator(device=dev).manual_seed(seed)
    S = len(ctx)

    def rnd(*shape, sd=1.0):
        return (torch.randn(shape, generator=g, device=dev) * sd).to(dtype)

    pool = rnd(L, 2, KV, nb, bs, D)
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


def k1_work(case) -> tuple[float, float]:
    """(bytes, operations) the function needs on this case's data: q, the
    valid K/V rows (pool and stage) once per KV head and the output; two
    multiply-adds per visible (query, key) pair and head dim element."""
    q = case["q"]
    S, T, H, D = q.shape
    KV = case["pool"].shape[2]
    G = H // KV
    el = q.element_size()
    lens = case["seq_lens"].tolist()
    qst = case["q_starts"].tolist()
    nbytes = 2 * q.numel() * el
    pairs = 0
    for s in range(S):
        if lens[s] <= 0:
            continue
        last_q = qst[s] + T - 1
        keys = min(lens[s], last_q + 1)
        nbytes += 2 * KV * keys * D * el
        for t in range(T):
            pairs += min(lens[s], qst[s] + t + 1) * G * KV
    return float(nbytes), float(4 * pairs * D)


def k1_library_call(case):
    """One scaled_dot_product_attention call over the case's K/V gathered
    dense (masked), timed as a yardstick beside the kernel."""
    import torch.nn.functional as F

    q, pool = case["q"], case["pool"]
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


def phase_kernel(dev) -> tuple[dict, list]:
    from deepspeed_tpu_torch.ops.paged_attention import (
        counts, paged_ragged_attention, paged_ragged_attention_reference)

    tol = K1_TOL
    # the serving path's shapes (phase 4): 8 slots of ~256-1100 context,
    # one empty; prefill chunks of 256 over several 64-token pages
    decode_ctx = [256, 397, 512, 611, 700, 833, 1022, -1]
    chunk_ctx = [0, 192, 320, 768]
    geoms = {"llama2-7b": dict(H=32, KV=32, D=128),
             "gqa-32q/8kv": dict(H=32, KV=8, D=128)}
    shapes = {"decode": dict(T=1, Ts=8, ctx=decode_ctx),
              "window": dict(T=1, Ts=8, window=True,
                             ctx=[c + 3 if c >= 0 else c
                                  for c in decode_ctx]),
              "prefill256": dict(T=256, Ts=256, ctx=chunk_ctx)}
    results = []
    seed = 0
    for dtype in (torch.float32, torch.bfloat16):
        for gname, geo in geoms.items():
            for sname, shp in shapes.items():
                seed += 1
                case = k1_case(f"{gname}/{sname}", bs=64, dtype=dtype,
                               dev=dev, seed=seed, **geo, **shp)
                args = [case[k] for k in ("q", "pool", "k_stage", "v_stage",
                                          "block_tables", "seq_lens",
                                          "q_starts", "stage_starts")]
                kw = dict(block_size=64, layer_index=case["layer_index"])
                got = paged_ragged_attention(*args, **kw)
                torch.cuda.synchronize()
                ref = paged_ragged_attention_reference(*args, **kw)
                err, judged = k1_error(got, ref, dtype)
                empty = case["seq_lens"] == 0
                if empty.any() and got[empty].abs().max().item() != 0.0:
                    raise AssertionError(f"{case['name']}: empty slot not 0")
                if not torch.isfinite(got).all():
                    raise AssertionError(f"{case['name']}: non-finite output")
                if judged > tol[dtype]:
                    raise AssertionError(
                        f"K1 {case['name']} {dtype}: kernel against plain "
                        f"error {judged:.3e} > {tol[dtype]:.0e} (max abs "
                        f"{err:.3e})")
                ms = cuda_time_ms(lambda: paged_ragged_attention(*args, **kw))
                plain_ms = cuda_time_ms(
                    lambda: paged_ragged_attention_reference(*args, **kw),
                    iters=3, warmup=1)
                lib_ms = cuda_time_ms(k1_library_call(case), iters=5,
                                      warmup=1)
                nbytes, ops = k1_work(case)
                t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
                t_ops = ops / PEAK_OPS[dtype] * 1e3
                rec = dict(case=case["name"],
                           dtype=str(dtype).replace("torch.", ""),
                           max_abs_err=err, judged_err=judged,
                           max_abs_ref=ref.float().abs().max().item(),
                           tol=tol[dtype], ms=ms,
                           plain_ms=plain_ms, library_ms=lib_ms,
                           bound_ms=max(t_bytes, t_ops),
                           bound_by="bytes" if t_bytes >= t_ops
                           else "operations", bytes=nbytes, ops=ops)
                results.append(rec)
                log(f"[kernel] {rec['case']:<26} {rec['dtype']:<8} "
                    f"err {judged:.2e} (tol {tol[dtype]:.0e}; max abs "
                    f"{err:.2e} of max |plain| {rec['max_abs_ref']:.2f})  "
                    f"kernel "
                    f"{ms:.4f} ms  plain {plain_ms:.3f} ms  sdpa "
                    f"{lib_ms:.3f} ms  bound {rec['bound_ms']:.4f} ms "
                    f"({rec['bound_by']})")
                del case, args, got, ref
    # the record line reports K1 at the serving path's most frequent shape:
    # a bf16 decode-window step of llama2-7b geometry
    main = next(r for r in results if r["case"] == "llama2-7b/window"
                and r["dtype"] == "bfloat16")
    summary = dict(max_abs_err=max(r["max_abs_err"] for r in results
                                   if r["dtype"] == "bfloat16"),
                   max_err_over_max_ref=max(r["judged_err"] for r in results
                                            if r["dtype"] == "bfloat16"),
                   max_abs_err_fp32=max(r["max_abs_err"] for r in results
                                        if r["dtype"] == "float32"),
                   **{k: main[k] for k in ("ms", "plain_ms", "library_ms",
                                           "bound_ms", "bound_by")})
    counts.reset()
    return summary, results


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


def phase_parity(dev) -> dict:
    from deepspeed_tpu_torch.models import build_model
    from deepspeed_tpu_torch.ops.paged_attention import counts

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("[parity] llama2-7b full width, 4 layers, fp32; TF32 off for "
        "matmuls and cuDNN")
    model = build_model("llama2-7b", num_layers=4, dtype=torch.float32,
                        device=dev, seed=0)
    eng = tap_engine_class()(model, config=dict(
        block_size=64, num_blocks=64, max_seqs=4, chunk=128,
        max_seq_len=1024, decode_window=8, dtype=torch.float32, device=dev))
    g = torch.Generator().manual_seed(0)
    lens = [300, 77, 150, 129, 200]            # chunks span pages
    prompts = [torch.randint(0, 32000, (n,), generator=g).tolist()
               for n in lens]
    new = 16
    if eng._attn_decode_sel.path != "cuda":
        raise AssertionError(f"[parity] attention path "
                             f"{eng._attn_decode_sel.path}, not the kernel")
    counts.reset()
    streams = eng.generate(prompts, max_new_tokens=new)
    kernel_launches, plain_launches = counts.kernel, counts.plain
    eng.state.audit()
    st = eng.stats
    L = model.config.num_layers
    forwards = st["prefill_steps"] + st["decode_steps"] + \
        st["window_iters_max"]
    if kernel_launches <= 0 or kernel_launches != L * forwards:
        raise AssertionError(
            f"[parity] K1 launched {kernel_launches} times; expected layers "
            f"x forwards = {L} x {forwards}")
    if plain_launches != 0:
        raise AssertionError(f"[parity] the plain version ran "
                             f"{plain_launches} times")
    worst, near_ties = 0.0, []
    with torch.no_grad():
        for uid, (prompt, got) in enumerate(zip(prompts, streams)):
            if len(got) != new:
                raise AssertionError(f"[parity] uid {uid}: {len(got)} tokens")
            seq = list(prompt)
            for k, tok in enumerate(got):
                ids = torch.tensor([seq], device=dev)
                ref = model(ids)[0, -1].float().cpu()
                top2 = torch.topk(ref, 2).values
                ours = eng.taps[uid][k]
                rel = ((ours - ref).abs().max() / ref.abs().max()).item()
                worst = max(worst, rel)
                if rel > 1e-3:
                    raise AssertionError(
                        f"[parity] uid {uid} step {k}: logits differ by "
                        f"{rel:.2e} relative (> 1e-3)")
                if int(ref.argmax()) != tok:
                    gap = (top2[0] - top2[1]).item()
                    if gap >= 1e-4:
                        raise AssertionError(
                            f"[parity] uid {uid} step {k}: engine token "
                            f"{tok} != oracle {int(ref.argmax())} (top-2 gap "
                            f"{gap:.3e})")
                    near_ties.append((uid, k, gap))
                    log(f"[parity] NEAR-TIE uid {uid} step {k}: oracle top-2 "
                        f"gap {gap:.2e} < 1e-4; streams part here by design")
                seq.append(tok)
    log(f"[parity] {len(prompts)} greedy streams x {new} tokens identical to "
        f"the dense oracle ({len(near_ties)} near-ties); max logits error "
        f"{worst:.2e} relative; K1 launches {kernel_launches} = {L} layers x "
        f"{forwards} forwards, plain-version launches {plain_launches}")
    del eng, model
    torch.cuda.empty_cache()
    return {"max_rel_logits_err": worst, "near_ties": near_ties,
            "prompts": lens, "new_tokens": new,
            "k1_launches": kernel_launches, "forwards": forwards}


def device_breakdown(run) -> dict:
    """Profile ``run()`` with torch.profiler and split the device's kernel
    time into K1, matrix products and the rest, beside the host wall time
    (single stream, so busy time is the kernel time sum). Returns the
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
        if any(t in low for t in ("gemm", "xmma", "cutlass", "matmul",
                                  "nvjet")):
            return "gemm_ms"
        return "other_ms"

    out = {"wall_ms": wall_ms, "busy_ms": busy, "k1_ms": 0.0, "gemm_ms": 0.0,
           "other_ms": 0.0, "idle_share": max(0.0, 1 - busy / wall_ms)}
    for name, ms in by_name.items():
        out[kind(name)] += ms
    out["top"] = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return out


def phase_serve(dev) -> dict:
    from deepspeed_tpu_torch.accelerator import memory_stats
    from deepspeed_tpu_torch.inference import InferenceEngineV2
    from deepspeed_tpu_torch.models import build_model
    from deepspeed_tpu_torch.ops.paged_attention import counts

    t0 = time.perf_counter()
    model = build_model("llama2-7b", dtype=torch.bfloat16, device=dev,
                        seed=1)
    L = model.config.num_layers
    eng = InferenceEngineV2(model, config=dict(
        block_size=64, num_blocks=256, max_seqs=8, chunk=256,
        max_seq_len=2048, decode_window=8, dtype=torch.bfloat16,
        device=dev))
    torch.cuda.synchronize()
    log(f"[serve] llama2-7b ({L} layers, bf16, seeded random weights) and a "
        f"{eng.kv_pool.numel() * 2 / 1e9:.1f} GB pool up in "
        f"{time.perf_counter() - t0:.1f}s; attention path "
        f"{eng._attn_decode_sel.path}")
    g = torch.Generator().manual_seed(1)
    system = torch.randint(0, 32000, (128,), generator=g).tolist()
    # a first request publishes the shared system prefix (and warms the
    # allocator and cuBLAS); the measured batch then hits it
    eng.generate([system + torch.randint(0, 32000, (64,),
                                         generator=g).tolist()],
                 max_new_tokens=8)
    lens = [256, 384, 512, 640, 768, 896, 1024, 300]
    prompts = [system + torch.randint(0, 32000, (n - 128,),
                                      generator=g).tolist() for n in lens]
    new = 64
    for k in list(eng.stats):
        eng.stats[k] = 0 if not isinstance(eng.stats[k], float) else 0.0
    torch.cuda.reset_peak_memory_stats(dev)
    counts.reset()
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
    kernel_launches, plain_launches = counts.kernel, counts.plain
    st = dict(eng.stats)
    window_iters = st["window_iters_max"]
    for u in out:
        if eng.flush(u) != out[u] or len(out[u]) != new:
            raise AssertionError(f"[serve] uid {u}: stream of {len(out[u])}")
        if not all(0 <= t < 32000 for t in out[u]):
            raise AssertionError(f"[serve] uid {u}: token out of range")
    eng.state.audit()
    forwards = st["prefill_steps"] + st["decode_steps"] + \
        st["window_iters_max"]
    if kernel_launches <= 0 or kernel_launches != L * forwards:
        raise AssertionError(
            f"[serve] K1 launched {kernel_launches} times; expected layers x "
            f"forwards = {L} x {forwards}")
    if plain_launches != 0:
        raise AssertionError(f"[serve] the plain version ran "
                             f"{plain_launches} times on the main path")
    if st["prefix_hit_tokens"] < 128 * len(prompts):
        raise AssertionError(f"[serve] prefix cache served "
                             f"{st['prefix_hit_tokens']} tokens")
    # where the device time goes: one profiled decode window (8 requests
    # of 16 new tokens past a shared-prefix prompt), separate from the
    # timed run above
    short = [system + torch.randint(0, 32000, (64,), generator=g).tolist()
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
        log(f"[serve] one profiled decode window ({prof['window_iters']} "
            f"iterations x 8 slots): wall "
            f"{prof['wall_ms']:.2f} ms, device busy {prof['busy_ms']:.2f} "
            f"ms (idle share {prof['idle_share']:.2f}): K1 "
            f"{prof['k1_ms']:.2f} ms, matrix products {prof['gemm_ms']:.2f} "
            f"ms, other kernels {prof['other_ms']:.2f} ms")
        for name, ms in prof["top"]:
            log(f"[serve]   {ms:8.3f} ms  {name[:100]}")
    else:
        log(f"[serve] profiled decode window: device time not measured "
            f"(wall {prof['wall_ms']:.2f} ms)")
    res = {"requests": len(prompts), "prompt_tokens": sum(lens),
           "new_tokens": new, "wall_s": wall,
           "output_tok_s": len(prompts) * new / wall,
           "ttft_p50_s": statistics.median(first.values()),
           "ttft_max_s": max(first.values()),
           "decode_ms_per_token": 1e3 * window_s / max(window_iters, 1),
           "window_iters": window_iters,
           "peak_mem_gb": memory_stats(dev)["max_allocated"] / 1e9,
           "k1_launches": kernel_launches, "plain_launches": plain_launches,
           "forwards": forwards, "stats": st, "profiled_window": prof}
    log(f"[serve] {len(prompts)} requests ({sum(lens)} prompt tokens, "
        f"{st['prefix_hit_tokens']} from the prefix cache) x {new} new "
        f"tokens in {wall:.2f}s: {res['output_tok_s']:.1f} output tok/s, "
        f"p50 TTFT {res['ttft_p50_s']:.3f}s, decode "
        f"{res['decode_ms_per_token']:.2f} ms/token-step over "
        f"{window_iters} window iterations, peak memory "
        f"{res['peak_mem_gb']:.1f} GB")
    log(f"[serve] K1 launches {kernel_launches} = {L} layers x {forwards} "
        f"forwards ({st['prefill_steps']} prefill steps, "
        f"{st['decode_steps']} decode steps, {st['window_iters_max']} window "
        f"iterations); plain-version launches {plain_launches}")
    del eng, model
    torch.cuda.empty_cache()
    return res


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
    t_start = time.perf_counter()
    record: dict = {"card": card, "phases": {}}
    k1 = {"name": "paged_ragged_attention", "route": "cuda",
          "source": "deepspeed_tpu_torch/ops/csrc/paged_attention.cu",
          "replaces": "deepspeed_tpu/ops/pallas/paged_attention.py:137",
          "launches": None}
    built = phase_build()          # every later phase runs the kernels
    record["phases"]["build"] = {n: r["seconds"] for n, r in built.items()}
    if "kernel" in phases:
        summary, cases = phase_kernel(dev)
        k1.update(summary)
        record["phases"]["kernel"] = cases
    if "parity" in phases:
        record["phases"]["parity"] = phase_parity(dev)
    if "serve" in phases:
        serve = phase_serve(dev)
        record["phases"]["serve"] = serve
        k1["launches"] = serve["k1_launches"]
    record["seconds"] = time.perf_counter() - t_start
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "chip_smoke.json"), "w") as f:
        json.dump(record, f, indent=1, default=str)
    log(json.dumps({"kernels": [k1]}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
