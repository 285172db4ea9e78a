// The bf16 flash-attention kernels on wgmma tensor cores fed by TMA, forward,
// dq and dk/dv, with the tile walk a template parameter. K4
// (flash_attention.cu) instantiates them with its dense walk, K6
// (block_sparse_attention.cu) with a walk of the layout's table: one body,
// the same tiles, the same order of sums.
//
// What they compute, over [slabs, S, D] bf16 tensors (slab = batch row x
// heads + head): s = (q . k) * scale in fp32, masked where k_pos > q_pos
// under `causal`; online softmax over the walk's key tiles; out = sum(exp(s
// - m) v) / l in bf16 (l = 0 taken as 1, so a row that sees no key gives
// 0), lse = m + log(l) in fp32 (the walk's `empty_lse()` where l = 0); p is
// rounded to bf16 for the PV product while l sums the unrounded p. The
// backward, with delta = rowsum(dout * out) made by the caller: p = exp(s -
// lse), dp = dout . v, ds = p * (dp - delta) * scale; dq = ds . k, dk = ds^T
// . q, dv = p^T . dout, with p and ds rounded to bf16 before their second
// products and every sum in fp32.
//
// The design (what bounds these kernels on an H100 is the operations: over
// a thousand per byte of q, k, v at S 2048, far above the card's ridge): a
// block is two consumer warpgroups (64 rows each, wgmma's M) and a producer
// warpgroup, one of whose warps keeps TMA loads in flight through a
// two-stage ring guarded by full / empty mbarriers; it hands its registers
// to the consumers (setmaxnreg: 240 a consumer thread, so the dk and dv
// accumulators and the score fragments fit without spilling). The
// warpgroup index comes from a warp shuffle so the compiler sees it
// uniform; wgmma under a condition it cannot prove uniform is serialized.
// The tensor maps are encoded on the host at each call and passed by value
// (`__grid_constant__`), so a CUDA graph captures them. Tiles are stored
// with 128-byte swizzle (hopper.cuh): K-major for operands whose contraction
// runs along a row (Q, K, V, dO in the score products), MN-major through
// the descriptor's transpose bit for those whose contraction runs down the
// rows (V in p . v, K in ds . k, Q in ds^T . q, dO in p^T . dO), so nothing
// is copied transposed. The probabilities and ds stay in registers: the
// fp32 accumulator fragment of a 64 x N product is, pair by pair, the bf16
// A fragment of the next product (`acc_to_a`). The softmax runs on the
// fragment: row max and sum over the four lanes that share a row, exp2 with
// scale * log2(e) folded in, the mask applied only on tiles that cross the
// diagonal or the end of the sequence. Rows past S arrive from TMA as zeros
// and never come from the next slab.
// - forward: 128 q rows a block, key tiles of 128 (64 at D 256);
// - dq: 128 q rows a block, key tiles of 64 (32 at D 256, so the dq
//   accumulator of 128 registers fits): s = q k^T, dp = dO v^T (both from
//   shared memory), ds in registers, dq += ds . k;
// - dk/dv: 128 keys a block (64 at D 256, where each warpgroup owns half of
//   dk's and dv's columns and both compute the scores), walking 64-row q
//   tiles with each tile's lse and delta staged beside it by the producer
//   warp: s^T = k q^T, dp^T = v dO^T, then dv += p^T . dO and dk += ds^T .
//   q. dk and dv are written once (no atomics: the same bits every run).
//
// A walk is a struct passed by value. It has members `S` (rows of a slab)
// and `causal`, and gives:
// - `Walk::empty_lse()`, the lse of a row that sees no key, and
//   `Walk::lse_in(l)`, the backward's reading of a saved lse;
// - in the forward and dq, `typename Walk::template Rows<BQ, BK> w(walk)`:
//   the block's q rows [w.q0, w.q0 + BQ) of q slab w.qslab and its w.n key
//   tiles of kv slab w.kslab, tile j starting at key w.key(j);
// - in dk/dv, `typename Walk::template Cols<KEYS, BQ> w(walk)`: the block's
//   keys [w.k0, w.k0 + KEYS) of kv slab w.kslab and its w.n q tiles, tile j
//   starting at row w.query(j) of q slab w.qslab(j).
// Under causal a walk leaves out the tiles wholly above the diagonal of the
// block's rows; the kernels skip a warpgroup's share of a tile wholly above
// its own rows and mask the rest token by token.
//
// Compiled for sm_90a only.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace flash_tc {

using bf16 = __nv_bfloat16;
using namespace hopper;

// two consumer warpgroups and a producer warpgroup, of which one warp works;
// the producer keeps 24 registers a thread so the consumers get 240
constexpr int kTcThreads = 384;
constexpr int kProducer = 256;        // the producer warp's first thread
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr int kStages = 2;            // the ring of streamed tiles
constexpr int kConsumerWarps = 8;     // arrivals that free a stage
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ float ex2(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
    return y;
}

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
    return reinterpret_cast<uint8_t*>(
        (reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

__device__ __forceinline__ void store_bf16x2(bf16* p, float lo, float hi) {
    *reinterpret_cast<uint32_t*>(p) = pack_bf16(lo, hi);
}

// the element of a 64 x N accumulator fragment held in register 4 n + 2 i + e
// sits at row 16 warp + lane / 4 + 8 i and column 8 n + 2 (lane % 4) + e of
// the warpgroup's tile

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

template <int D>
struct FwdTc {
    static constexpr int BQ = 128;
    static constexpr int BK = D == 256 ? 64 : 128;
    static constexpr int Q_BYTES = BQ * D * 2;
    static constexpr int KV_BYTES = BK * D * 2;
    static constexpr size_t smem() {
        return 1024 + Q_BYTES + 2 * kStages * KV_BYTES + 8 * (1 + 3 * kStages);
    }
};

template <int D, class Walk>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_fwd_tc_kernel(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    bf16* __restrict__ out, float* __restrict__ lse,
                    const Walk walk, float scale_log2) {
    using C = FwdTc<D>;
    constexpr int BQ = C::BQ, BK = C::BK;
    extern __shared__ uint8_t smem_raw[];
    uint8_t* Qs = align1024(smem_raw);
    uint8_t* Ks = Qs + C::Q_BYTES;
    uint8_t* Vs = Ks + kStages * C::KV_BYTES;
    uint64_t* q_full = reinterpret_cast<uint64_t*>(Vs + kStages * C::KV_BYTES);
    uint64_t* k_full = q_full + 1;
    uint64_t* v_full = k_full + kStages;
    uint64_t* empty = v_full + kStages;

    const int tid = threadIdx.x;
    const int S = walk.S, causal = walk.causal;
    const typename Walk::template Rows<BQ, BK> w(walk);
    // the tile count and each tile's key are shuffled from lane 0, so the
    // compiler sees the loop and the branch around wgmma warp-uniform
    const int q0 = w.q0, nk = __shfl_sync(0xffffffff, w.n, 0);

    if (tid == 0) {
        bar_init(q_full, 1);
        for (int s = 0; s < kStages; ++s) {
            bar_init(&k_full[s], 1);
            bar_init(&v_full[s], 1);
            bar_init(&empty[s], kConsumerWarps);
        }
        bar_init_fence();
    }
    __syncthreads();

    // the warpgroup index, warp-uniform as the compiler sees it: wgmma
    // under a condition it cannot prove uniform would be serialized
    const int wg = __shfl_sync(0xffffffff, tid / 128, 0);
    if (wg == kProducer / 128) {
        reg_dealloc<kProducerRegs>();
        if (tid == kProducer) {
            bar_arrive_tx(q_full, C::Q_BYTES);
            tma_tile<D>(Qs, &tq, q_full, BQ, q0, w.qslab);
            for (int j = 0; j < nk; ++j) {
                const int s = j % kStages;
                const int k0 = w.key(j);
                bar_wait(&empty[s], ((j / kStages) & 1) ^ 1);
                bar_arrive_tx(&k_full[s], C::KV_BYTES);
                tma_tile<D>(Ks + s * C::KV_BYTES, &tk, &k_full[s], BK, k0,
                            w.kslab);
                bar_arrive_tx(&v_full[s], C::KV_BYTES);
                tma_tile<D>(Vs + s * C::KV_BYTES, &tv, &v_full[s], BK, k0,
                            w.kslab);
            }
        }
        return;
    }
    reg_alloc<kConsumerRegs>();

    const int warp = (tid % 128) / 32, lane = tid % 32;
    const int row_base = q0 + wg * 64;
    const int r0 = row_base + warp * 16 + lane / 4, r1 = r0 + 8;
    const int c_lane = 2 * (lane % 4);

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
    const uint32_t qs = smem_u32(Qs);

    bar_wait(q_full, 0);
    for (int j = 0; j < nk; ++j) {
        const int s = j % kStages;
        const uint32_t ph = (j / kStages) & 1;
        const int k0 = __shfl_sync(0xffffffff, w.key(j), 0);
        bar_wait(&k_full[s], ph);
        // under causal masking the first warpgroup may see none of a tile
        // the second one sees
        if (!causal || k0 <= row_base + 63) {
            const uint32_t ks = smem_u32(Ks + s * C::KV_BYTES);
            const uint32_t vs = smem_u32(Vs + s * C::KV_BYTES);
            float sc[BK / 2];
            wgmma_fence();
#pragma unroll
            for (int k = 0; k < D / 16; ++k)
                wgmma_ss<BK>(sc, desc_k(qs, BQ, wg * 64, k),
                             desc_k(ks, BK, 0, k), k > 0);
            wgmma_commit();
            wgmma_wait<0>();
            reg_fence(sc);

            const bool edge = k0 + BK > S || (causal && k0 + BK - 1 > row_base);
            float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
            for (int n = 0; n < BK / 8; ++n)
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    float x0 = sc[4 * n + e] * scale_log2;
                    float x1 = sc[4 * n + 2 + e] * scale_log2;
                    if (edge) {
                        const int c = k0 + 8 * n + c_lane + e;
                        if (c >= S || (causal && c > r0)) x0 = -INFINITY;
                        if (c >= S || (causal && c > r1)) x1 = -INFINITY;
                    }
                    sc[4 * n + e] = x0;
                    sc[4 * n + 2 + e] = x1;
                    mx0 = fmaxf(mx0, x0);
                    mx1 = fmaxf(mx1, x1);
                }
            mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffff, mx0, 1));
            mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffff, mx0, 2));
            mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffff, mx1, 1));
            mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffff, mx1, 2));
            const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
            // a row that has seen no key yet keeps m = -inf and p = 0
            const float mu0 = mn0 == -INFINITY ? 0.f : mn0;
            const float mu1 = mn1 == -INFINITY ? 0.f : mn1;
            const float a0 = ex2(m0 - mu0), a1 = ex2(m1 - mu1);
            m0 = mn0;
            m1 = mn1;
            float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
            for (int n = 0; n < BK / 8; ++n)
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    const float p0 = ex2(sc[4 * n + e] - mu0);
                    const float p1 = ex2(sc[4 * n + 2 + e] - mu1);
                    sc[4 * n + e] = p0;
                    sc[4 * n + 2 + e] = p1;
                    sum0 += p0;
                    sum1 += p1;
                }
            l0 = l0 * a0 + sum0;          // this thread's share of the row sum
            l1 = l1 * a1 + sum1;
            uint32_t pa[BK / 16][4];
#pragma unroll
            for (int k = 0; k < BK / 16; ++k) acc_to_a(sc, k, pa[k]);
#pragma unroll
            for (int n = 0; n < D / 8; ++n) {
                o[4 * n] *= a0;
                o[4 * n + 1] *= a0;
                o[4 * n + 2] *= a1;
                o[4 * n + 3] *= a1;
            }
            bar_wait(&v_full[s], ph);
            wgmma_fence();
#pragma unroll
            for (int k = 0; k < BK / 16; ++k)
                wgmma_rs<D>(o, pa[k], desc_mn(vs, BK, 0, k), 1);
            wgmma_commit();
            wgmma_wait<0>();
            reg_fence(o);
        }
        if (lane == 0) bar_arrive(&empty[s]);
    }

    l0 += __shfl_xor_sync(0xffffffff, l0, 1);
    l0 += __shfl_xor_sync(0xffffffff, l0, 2);
    l1 += __shfl_xor_sync(0xffffffff, l1, 1);
    l1 += __shfl_xor_sync(0xffffffff, l1, 2);
    const float i0 = 1.f / (l0 == 0.f ? 1.f : l0);
    const float i1 = 1.f / (l1 == 0.f ? 1.f : l1);
    const size_t row0 = size_t(w.qslab) * size_t(S);
    bf16* o0 = out + (row0 + r0) * D + c_lane;
    bf16* o1 = out + (row0 + r1) * D + c_lane;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
        if (r0 < S) store_bf16x2(o0 + 8 * n, o[4 * n] * i0, o[4 * n + 1] * i0);
        if (r1 < S)
            store_bf16x2(o1 + 8 * n, o[4 * n + 2] * i1, o[4 * n + 3] * i1);
    }
    if (lane % 4 == 0) {
        if (r0 < S)
            lse[row0 + r0] =
                l0 == 0.f ? Walk::empty_lse() : (m0 + log2f(l0)) * kLn2;
        if (r1 < S)
            lse[row0 + r1] =
                l1 == 0.f ? Walk::empty_lse() : (m1 + log2f(l1)) * kLn2;
    }
}

// ---------------------------------------------------------------------------
// backward, dq: 128 q rows of one slab a block, keys innermost
// ---------------------------------------------------------------------------

template <int D>
struct DqTc {
    static constexpr int BQ = 128;
    static constexpr int BK = D == 256 ? 32 : 64;
    static constexpr int Q_BYTES = BQ * D * 2;
    static constexpr int KV_BYTES = BK * D * 2;
    static constexpr size_t smem() {
        return 1024 + 2 * Q_BYTES + 2 * kStages * KV_BYTES + 8 * (1 + 3 * kStages);
    }
};

template <int D, class Walk>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_dq_tc_kernel(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   const __grid_constant__ CUtensorMap tdo,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, bf16* __restrict__ dq,
                   const Walk walk, float scale, float scale_log2) {
    using C = DqTc<D>;
    constexpr int BQ = C::BQ, BK = C::BK;
    extern __shared__ uint8_t smem_raw[];
    uint8_t* Qs = align1024(smem_raw);
    uint8_t* Os = Qs + C::Q_BYTES;              // dout
    uint8_t* Ks = Os + C::Q_BYTES;
    uint8_t* Vs = Ks + kStages * C::KV_BYTES;
    uint64_t* qo_full = reinterpret_cast<uint64_t*>(Vs + kStages * C::KV_BYTES);
    uint64_t* k_full = qo_full + 1;
    uint64_t* v_full = k_full + kStages;
    uint64_t* empty = v_full + kStages;

    const int tid = threadIdx.x;
    const int S = walk.S, causal = walk.causal;
    const typename Walk::template Rows<BQ, BK> w(walk);
    // the tile count and each tile's key are shuffled from lane 0, so the
    // compiler sees the loop and the branch around wgmma warp-uniform
    const int q0 = w.q0, nk = __shfl_sync(0xffffffff, w.n, 0);

    if (tid == 0) {
        bar_init(qo_full, 1);
        for (int s = 0; s < kStages; ++s) {
            bar_init(&k_full[s], 1);
            bar_init(&v_full[s], 1);
            bar_init(&empty[s], kConsumerWarps);
        }
        bar_init_fence();
    }
    __syncthreads();

    // the warpgroup index, warp-uniform as the compiler sees it: wgmma
    // under a condition it cannot prove uniform would be serialized
    const int wg = __shfl_sync(0xffffffff, tid / 128, 0);
    if (wg == kProducer / 128) {
        reg_dealloc<kProducerRegs>();
        if (tid == kProducer) {
            bar_arrive_tx(qo_full, 2 * C::Q_BYTES);
            tma_tile<D>(Qs, &tq, qo_full, BQ, q0, w.qslab);
            tma_tile<D>(Os, &tdo, qo_full, BQ, q0, w.qslab);
            for (int j = 0; j < nk; ++j) {
                const int s = j % kStages;
                const int k0 = w.key(j);
                bar_wait(&empty[s], ((j / kStages) & 1) ^ 1);
                bar_arrive_tx(&k_full[s], C::KV_BYTES);
                tma_tile<D>(Ks + s * C::KV_BYTES, &tk, &k_full[s], BK, k0,
                            w.kslab);
                bar_arrive_tx(&v_full[s], C::KV_BYTES);
                tma_tile<D>(Vs + s * C::KV_BYTES, &tv, &v_full[s], BK, k0,
                            w.kslab);
            }
        }
        return;
    }
    reg_alloc<kConsumerRegs>();

    const int warp = (tid % 128) / 32, lane = tid % 32;
    const int row_base = q0 + wg * 64;
    const int r0 = row_base + warp * 16 + lane / 4, r1 = r0 + 8;
    const int c_lane = 2 * (lane % 4);
    const size_t row0 = size_t(w.qslab) * size_t(S);
    const float lse0 = r0 < S ? Walk::lse_in(lse[row0 + r0]) * kLog2e : 0.f;
    const float lse1 = r1 < S ? Walk::lse_in(lse[row0 + r1]) * kLog2e : 0.f;
    const float dl0 = r0 < S ? delta[row0 + r0] : 0.f;
    const float dl1 = r1 < S ? delta[row0 + r1] : 0.f;

    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    const uint32_t qs = smem_u32(Qs), os = smem_u32(Os);

    bar_wait(qo_full, 0);
    for (int j = 0; j < nk; ++j) {
        const int s = j % kStages;
        const uint32_t ph = (j / kStages) & 1;
        const int k0 = __shfl_sync(0xffffffff, w.key(j), 0);
        bar_wait(&k_full[s], ph);
        if (!causal || k0 <= row_base + 63) {
            const uint32_t ks = smem_u32(Ks + s * C::KV_BYTES);
            const uint32_t vs = smem_u32(Vs + s * C::KV_BYTES);
            float sc[BK / 2], dp[BK / 2];
            wgmma_fence();
#pragma unroll
            for (int k = 0; k < D / 16; ++k)
                wgmma_ss<BK>(sc, desc_k(qs, BQ, wg * 64, k),
                             desc_k(ks, BK, 0, k), k > 0);
            bar_wait(&v_full[s], ph);
#pragma unroll
            for (int k = 0; k < D / 16; ++k)
                wgmma_ss<BK>(dp, desc_k(os, BQ, wg * 64, k),
                             desc_k(vs, BK, 0, k), k > 0);
            wgmma_commit();
            wgmma_wait<0>();
            reg_fence(sc);
            reg_fence(dp);

            const bool edge = k0 + BK > S || (causal && k0 + BK - 1 > row_base);
#pragma unroll
            for (int n = 0; n < BK / 8; ++n)
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    float x0 = sc[4 * n + e] * scale_log2 - lse0;
                    float x1 = sc[4 * n + 2 + e] * scale_log2 - lse1;
                    if (edge) {
                        const int c = k0 + 8 * n + c_lane + e;
                        if (c >= S || (causal && c > r0)) x0 = -INFINITY;
                        if (c >= S || (causal && c > r1)) x1 = -INFINITY;
                    }
                    sc[4 * n + e] = ex2(x0) * (dp[4 * n + e] - dl0) * scale;
                    sc[4 * n + 2 + e] =
                        ex2(x1) * (dp[4 * n + 2 + e] - dl1) * scale;
                }
            uint32_t da[BK / 16][4];
#pragma unroll
            for (int k = 0; k < BK / 16; ++k) acc_to_a(sc, k, da[k]);
            wgmma_fence();
#pragma unroll
            for (int k = 0; k < BK / 16; ++k)
                wgmma_rs<D>(acc, da[k], desc_mn(ks, BK, 0, k), 1);
            wgmma_commit();
            wgmma_wait<0>();
            reg_fence(acc);
        }
        if (lane == 0) bar_arrive(&empty[s]);
    }

    bf16* d0 = dq + (row0 + r0) * D + c_lane;
    bf16* d1 = dq + (row0 + r1) * D + c_lane;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
        if (r0 < S) store_bf16x2(d0 + 8 * n, acc[4 * n], acc[4 * n + 1]);
        if (r1 < S) store_bf16x2(d1 + 8 * n, acc[4 * n + 2], acc[4 * n + 3]);
    }
}

// ---------------------------------------------------------------------------
// backward, dk/dv: 128 keys (64 at D 256) of one kv slab a block, walking
// 64-row q tiles; dk/dv are written once
// ---------------------------------------------------------------------------

template <int D>
struct DkvTc {
    static constexpr int KEYS = D == 256 ? 64 : 128;
    static constexpr int BQ = 64;
    static constexpr int DC = D == 256 ? 128 : D;   // dk/dv columns a warpgroup
    static constexpr int KV_BYTES = KEYS * D * 2;
    static constexpr int Q_BYTES = BQ * D * 2;
    static constexpr size_t smem() {
        return 1024 + 2 * KV_BYTES + 2 * kStages * Q_BYTES +
               2 * kStages * BQ * 4 + 8 * (1 + 2 * kStages);
    }
};

template <int D, class Walk>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_dkv_tc_kernel(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    const __grid_constant__ CUtensorMap tdo,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, bf16* __restrict__ dk,
                    bf16* __restrict__ dv, const Walk walk, float scale,
                    float scale_log2) {
    using C = DkvTc<D>;
    constexpr int KEYS = C::KEYS, BQ = C::BQ, DC = C::DC;
    extern __shared__ uint8_t smem_raw[];
    uint8_t* Ks = align1024(smem_raw);
    uint8_t* Vs = Ks + C::KV_BYTES;
    uint8_t* Qs = Vs + C::KV_BYTES;                 // [kStages] q tiles
    uint8_t* Os = Qs + kStages * C::Q_BYTES;        // [kStages] dout tiles
    float* lse_s = reinterpret_cast<float*>(Os + kStages * C::Q_BYTES);
    float* dl_s = lse_s + kStages * BQ;
    uint64_t* kv_full = reinterpret_cast<uint64_t*>(dl_s + kStages * BQ);
    uint64_t* full = kv_full + 1;
    uint64_t* empty = full + kStages;

    const int tid = threadIdx.x;
    const int S = walk.S, causal = walk.causal;
    const typename Walk::template Cols<KEYS, BQ> w(walk);
    // shuffled from lane 0 as in the forward
    const int k0 = w.k0, n_it = __shfl_sync(0xffffffff, w.n, 0);

    if (tid == 0) {
        bar_init(kv_full, 1);
        for (int s = 0; s < kStages; ++s) {
            bar_init(&full[s], 32);      // every producer lane stages lse / delta
            bar_init(&empty[s], kConsumerWarps);
        }
        bar_init_fence();
    }
    __syncthreads();

    // the warpgroup index, warp-uniform as the compiler sees it: wgmma
    // under a condition it cannot prove uniform would be serialized
    const int wg = __shfl_sync(0xffffffff, tid / 128, 0);
    if (wg == kProducer / 128) {
        reg_dealloc<kProducerRegs>();
        const int lane = tid - kProducer;
        if (lane >= 32) return;
        if (lane == 0) {
            bar_arrive_tx(kv_full, 2 * C::KV_BYTES);
            tma_tile<D>(Ks, &tk, kv_full, KEYS, k0, w.kslab);
            tma_tile<D>(Vs, &tv, kv_full, KEYS, k0, w.kslab);
        }
        for (int it = 0; it < n_it; ++it) {
            const int s = it % kStages;
            const int q0 = w.query(it), qslab = w.qslab(it);
            const size_t row0 = size_t(qslab) * size_t(S);
            bar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
            for (int r = lane; r < BQ; r += 32) {
                const int g = q0 + r;
                lse_s[s * BQ + r] =
                    g < S ? Walk::lse_in(lse[row0 + g]) * kLog2e : 0.f;
                dl_s[s * BQ + r] = g < S ? delta[row0 + g] : 0.f;
            }
            if (lane == 0) {
                bar_arrive_tx(&full[s], 2 * C::Q_BYTES);
                tma_tile<D>(Qs + s * C::Q_BYTES, &tq, &full[s], BQ, q0, qslab);
                tma_tile<D>(Os + s * C::Q_BYTES, &tdo, &full[s], BQ, q0,
                            qslab);
            } else {
                bar_arrive(&full[s]);
            }
        }
        return;
    }
    reg_alloc<kConsumerRegs>();

    const int warp = (tid % 128) / 32, lane = tid % 32;
    // D 256: both warpgroups hold the block's 64 keys, each half of the
    // columns of dk / dv; otherwise each holds 64 keys and every column
    const int krow = D == 256 ? 0 : wg * 64;
    const int cb = D == 256 ? wg * 2 : 0;          // first column block
    const int kw0 = k0 + krow;
    const int kr0 = kw0 + warp * 16 + lane / 4, kr1 = kr0 + 8;
    const int c_lane = 2 * (lane % 4);

    float dka[DC / 2], dva[DC / 2];
#pragma unroll
    for (int i = 0; i < DC / 2; ++i) dka[i] = dva[i] = 0.f;
    const uint32_t ks = smem_u32(Ks), vs = smem_u32(Vs);

    bar_wait(kv_full, 0);
    for (int it = 0; it < n_it; ++it) {
        const int s = it % kStages;
        const int q0 = __shfl_sync(0xffffffff, w.query(it), 0);
        bar_wait(&full[s], (it / kStages) & 1);
        if (!causal || q0 + BQ - 1 >= kw0) {       // some pair is visible
            const uint32_t qs = smem_u32(Qs + s * C::Q_BYTES);
            const uint32_t os = smem_u32(Os + s * C::Q_BYTES);
            const float* ls = lse_s + s * BQ;
            const float* dls = dl_s + s * BQ;
            float sc[BQ / 2], dp[BQ / 2];
            wgmma_fence();
#pragma unroll
            for (int k = 0; k < D / 16; ++k)
                wgmma_ss<BQ>(sc, desc_k(ks, KEYS, krow, k),
                             desc_k(qs, BQ, 0, k), k > 0);
#pragma unroll
            for (int k = 0; k < D / 16; ++k)
                wgmma_ss<BQ>(dp, desc_k(vs, KEYS, krow, k),
                             desc_k(os, BQ, 0, k), k > 0);
            wgmma_commit();
            wgmma_wait<0>();
            reg_fence(sc);
            reg_fence(dp);

            const bool edge = q0 + BQ > S || kw0 + 64 > S ||
                              (causal && q0 < kw0 + 63);
#pragma unroll
            for (int n = 0; n < BQ / 8; ++n)
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    const int qc = 8 * n + c_lane + e;
                    const float l2 = ls[qc], dl = dls[qc];
                    float x0 = sc[4 * n + e] * scale_log2 - l2;
                    float x1 = sc[4 * n + 2 + e] * scale_log2 - l2;
                    if (edge) {
                        const int qq = q0 + qc;
                        if (qq >= S || kr0 >= S || (causal && kr0 > qq))
                            x0 = -INFINITY;
                        if (qq >= S || kr1 >= S || (causal && kr1 > qq))
                            x1 = -INFINITY;
                    }
                    const float p0 = ex2(x0), p1 = ex2(x1);
                    sc[4 * n + e] = p0;
                    sc[4 * n + 2 + e] = p1;
                    dp[4 * n + e] = p0 * (dp[4 * n + e] - dl) * scale;
                    dp[4 * n + 2 + e] = p1 * (dp[4 * n + 2 + e] - dl) * scale;
                }
            uint32_t pa[BQ / 16][4], da[BQ / 16][4];
#pragma unroll
            for (int k = 0; k < BQ / 16; ++k) {
                acc_to_a(sc, k, pa[k]);
                acc_to_a(dp, k, da[k]);
            }
            wgmma_fence();
#pragma unroll
            for (int k = 0; k < BQ / 16; ++k)
                wgmma_rs<DC>(dva, pa[k], desc_mn(os, BQ, cb, k), 1);
#pragma unroll
            for (int k = 0; k < BQ / 16; ++k)
                wgmma_rs<DC>(dka, da[k], desc_mn(qs, BQ, cb, k), 1);
            wgmma_commit();
            wgmma_wait<0>();
            reg_fence(dva);
            reg_fence(dka);
        }
        if (lane == 0) bar_arrive(&empty[s]);
    }

    const size_t kvrow = size_t(w.kslab) * size_t(S);
    const int c0 = cb * 64 + c_lane;
#pragma unroll
    for (int n = 0; n < DC / 8; ++n) {
        if (kr0 < S) {
            const size_t o = (kvrow + kr0) * D + c0 + 8 * n;
            store_bf16x2(dk + o, dka[4 * n], dka[4 * n + 1]);
            store_bf16x2(dv + o, dva[4 * n], dva[4 * n + 1]);
        }
        if (kr1 < S) {
            const size_t o = (kvrow + kr1) * D + c0 + 8 * n;
            store_bf16x2(dk + o, dka[4 * n + 2], dka[4 * n + 3]);
            store_bf16x2(dv + o, dva[4 * n + 2], dva[4 * n + 3]);
        }
    }
}

}  // namespace flash_tc
