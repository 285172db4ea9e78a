// Flash attention, forward and backward, for training (K4).
//
// Replaces the TPU kernels of deepspeed_tpu/ops/pallas/flash_attention.py:
// `_fwd_kernel` (forward), and the backward's two Pallas schedules, the
// merged `_dqkv_kernel` (taken when the keys fit one Pallas block) and the
// split pair `_dq_kernel` / `_dkv_kernel`. One CUDA design computes the
// backward for every sequence length: a dq kernel gives dq (the function of
// `_dq_kernel`, and the dq of `_dqkv_kernel`) and a dk/dv kernel gives dk
// and dv already summed over each GQA group (the function of `_dkv_kernel`
// and the dk/dv of `_dqkv_kernel`, with the group-sum the JAX package does
// outside its kernels).
//
// What it computes, in the layout [B, H, S, D] (q, out, dout, dq) and
// [B, KV, S, D] (k, v, dk, dv), q head h reading kv head h / (H / KV):
// - forward: s = (q . k) * scale in fp32, masked above the diagonal when
//   causal; online softmax over key tiles; out = sum(exp(s - m) v) / l in
//   q's dtype (l = 0 taken as 1), lse = m + log(l) in fp32 [B, H, S];
// - backward, with delta = rowsum(dout * out) made by the caller (the JAX
//   package makes it in XLA too): p = exp(s - lse), dp = dout . v,
//   ds = p * (dp - delta) * scale; dq = ds . k, dk = ds^T . q,
//   dv = p^T . dout, all accumulated in fp32.
// D is 64, 128 or 256; S is any length (bf16: at least 128, the rows of a
// tile); the ragged last tile is masked.
//
// What bounds it on an H100: the operations. A causal call does
// 2 * 2 * B * H * S^2 * D / 2 multiply-adds forward and 2.5 times that
// backward, against a few bytes per element of q, k, v: at S = 2048 that is
// over a thousand operations per byte, far above the card's ridge. So every
// bf16 product runs on the tensor cores.
//
// bf16: warpgroup matrix products (wgmma) on tiles that TMA loads into
// shared memory (hopper.cuh). A block is two consumer warpgroups (64 rows
// each, wgmma's M) and a producer warpgroup: one of its warps keeps TMA
// loads in flight through a two-stage ring guarded by full / empty
// mbarriers, and it hands its registers to the consumers (setmaxnreg: 240
// a consumer thread, so the dk and dv accumulators and the score fragments
// fit without spilling). The warpgroup index comes from a warp shuffle so
// the compiler sees it uniform; wgmma under a condition it cannot prove
// uniform is serialized. The tensor maps are encoded on the host at each
// call and passed by value (`__grid_constant__`), so a CUDA graph captures
// them. Tiles are stored with 128-byte swizzle, the layout the wgmma
// descriptors read:
// K-major for operands whose contraction runs along a row (Q, K, V, dO in
// the score products), MN-major through the descriptor's transpose bit for
// those whose contraction runs down the rows (V in p . v, K in ds . k, Q in
// ds^T . q, dO in p^T . dO), so nothing is copied transposed. The
// probabilities and ds stay in registers: the fp32 accumulator fragment of
// a 64 x N product is, pair by pair, the bf16 A fragment of the next
// product (`acc_to_a`), rounded to bf16 as the Pallas kernels round p and ds
// to the operands' dtype before their second products. The softmax runs on
// the fragment: row max and sum over the four lanes that share a row, exp2
// with scale * log2(e) folded in, the mask applied only on tiles that cross
// the diagonal or the end of the sequence. Tensors are described to TMA as
// [B * heads, S, D], so rows past S arrive as zeros and never come from the
// next head.
// - forward: 128 q rows of one (batch, head) a block, key tiles of 128 (64
//   at D 256) from the first to the diagonal; tiles wholly above it are
//   never loaded; the longest rows of a causal call are launched first.
// - dq: 128 q rows a block, key tiles of 64 (32 at D 256, so the dq
//   accumulator of 128 registers fits): s = q k^T, dp = dO v^T (both from
//   shared memory), ds in registers, dq += ds . k.
// - dk/dv: 128 keys of one (batch, kv head) a block (64 at D 256, where
//   each warpgroup owns half of dk's and dv's columns and both compute the
//   scores), walking 64-row q tiles of every q head of the group from the
//   diagonal down, with each tile's lse and delta staged beside it by the
//   producer warp: s^T = k q^T, dp^T = v dO^T, then dv += p^T . dO and
//   dk += ds^T . q. dk and dv are written once, summed over the group.
// The two backward kernels recompute the scores (no atomics, so the result
// is the same from run to run); one pass with atomics on dq is later work.
//
// fp32 keeps full fp32 products on the CUDA cores (FMA): a block of 128
// threads owns one tile of rows and walks the other operand's tiles in a
// loop; tiles are staged in shared memory with rows padded by one word;
// tiles wholly above the diagonal are never visited. TF32 would not hold
// the fp32 tolerances the training parity checks use.
// All offsets are 64-bit.
//
// Built with `nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC` into a plain C library (deepspeed_tpu_torch/ops/kernels.py)
// and called through ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <chrono>

#include "hopper.cuh"

namespace {

// ===========================================================================
// fp32: CUDA-core FMA kernels
// ===========================================================================

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

// tile shapes per head dim: q rows and keys per forward / dq block, keys
// and q rows per dk/dv block. The register tiles stay at 64 fp32 sums a
// thread; shared memory stays under ~110 KB for D <= 128 (two or three
// blocks an SM).
template <int D>
struct Tiles {
    static constexpr int kFwdQ = 8192 / D;      // 128, 64, 32
    static constexpr int kDqQ = D == 256 ? 32 : 64;
    static constexpr int kKeys = 32;            // forward and dq key tile
    static constexpr int kDkvK = 4096 / D;      // 64, 32, 16
    static constexpr int kDkvQ = 32;
    static constexpr int LD = D + 1;            // padded row of a staged tile

    static constexpr size_t fwd_bytes() {
        return sizeof(float) * (size_t(kFwdQ) * LD + size_t(kKeys) * LD +
                                size_t(kKeys) * D +
                                size_t(kFwdQ) * (kKeys + 1) + 3 * kFwdQ);
    }
    static constexpr size_t dq_bytes() {
        return sizeof(float) * (2 * size_t(kDqQ) * LD + 2 * size_t(kKeys) * LD +
                                size_t(kDqQ) * (kKeys + 1) + 2 * kDqQ);
    }
    static constexpr size_t dkv_bytes() {
        return sizeof(float) * (2 * size_t(kDkvK) * LD + 2 * size_t(kDkvQ) * LD +
                                2 * size_t(kDkvQ) * (kDkvK + 1) + 2 * kDkvQ);
    }
};

// rows [row0, row0 + rows) of a [S, D] slab into shared memory [rows][ld];
// rows at or past S are zeros
template <int D>
__device__ __forceinline__ void stage(float* __restrict__ dst, int ld,
                                      const float* __restrict__ src, int row0,
                                      int rows, int S, int tid) {
    for (int i = tid; i < rows * D; i += kThreads) {
        const int r = i / D, d = i % D;
        const int g = row0 + r;
        dst[r * ld + d] = g < S ? src[size_t(g) * D + d] : 0.f;
    }
}
// lse and delta of rows [row0, row0 + rows); rows at or past S read 0
__device__ __forceinline__ void stage_rows(float* __restrict__ lse_s,
                                           float* __restrict__ dl_s,
                                           const float* __restrict__ lse,
                                           const float* __restrict__ delta,
                                           int row0, int rows, int S, int tid) {
    for (int r = tid; r < rows; r += kThreads) {
        const int g = row0 + r;
        lse_s[r] = g < S ? lse[g] : 0.f;
        dl_s[r] = g < S ? delta[g] : 0.f;
    }
}

__device__ __forceinline__ bool visible(int qp, int kp, int S, int causal) {
    return qp < S && kp < S && (!causal || kp <= qp);
}

// ---------------------------------------------------------------------------
// forward: one block per (q tile, q head, batch row)
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out,
                 float* __restrict__ lse, int H, int KV, int S, float scale,
                 int causal) {
    using C = Tiles<D>;
    constexpr int BQ = C::kFwdQ, BK = C::kKeys, LD = C::LD, LS = BK + 1;
    constexpr int RI = BQ / kWarps;   // rows of a warp: warp + kWarps * i
    constexpr int CJ = BK / 32;       // keys of a lane: lane + 32 * j
    constexpr int DJ = D / 32;        // head-dim columns of a lane
    extern __shared__ float smem[];
    float* Qs = smem;                 // [BQ][LD]
    float* Ks = Qs + BQ * LD;         // [BK][LD]
    float* Vs = Ks + BK * LD;         // [BK][D]
    float* Ss = Vs + BK * D;          // [BQ][LS] scores, then p
    float* row_m = Ss + BQ * LS;      // running max
    float* row_l = row_m + BQ;        // running sum
    float* row_a = row_l + BQ;        // this tile's rescale

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int nq = (S + BQ - 1) / BQ;
    const int q0 = (nq - 1 - int(blockIdx.x)) * BQ;   // longest rows first
    const int h = blockIdx.y, b = blockIdx.z;
    const int hk = h / (H / KV);
    const size_t qoff = (size_t(b) * H + h) * size_t(S) * D;
    const size_t kvoff = (size_t(b) * KV + hk) * size_t(S) * D;

    stage<D>(Qs, LD, q + qoff, q0, BQ, S, tid);
    for (int r = tid; r < BQ; r += kThreads) {
        row_m[r] = -INFINITY;
        row_l[r] = 0.f;
    }
    float acc[RI][DJ];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;

    const int last_q = min(q0 + BQ, S) - 1;
    const int nk = causal ? last_q / BK + 1 : (S + BK - 1) / BK;
    for (int kt = 0; kt < nk; ++kt) {
        const int k0 = kt * BK;
        __syncthreads();              // the last tile's readers are done
        stage<D>(Ks, LD, k + kvoff, k0, BK, S, tid);
        stage<D>(Vs, D, v + kvoff, k0, BK, S, tid);
        __syncthreads();
        {
            float s[RI][CJ];
#pragma unroll
            for (int i = 0; i < RI; ++i)
#pragma unroll
                for (int j = 0; j < CJ; ++j) s[i][j] = 0.f;
#pragma unroll 4
            for (int d = 0; d < D; ++d) {
                float kk[CJ];
#pragma unroll
                for (int j = 0; j < CJ; ++j) kk[j] = Ks[(lane + 32 * j) * LD + d];
#pragma unroll
                for (int i = 0; i < RI; ++i) {
                    const float qv = Qs[(warp + kWarps * i) * LD + d];
#pragma unroll
                    for (int j = 0; j < CJ; ++j) s[i][j] = fmaf(qv, kk[j], s[i][j]);
                }
            }
#pragma unroll
            for (int i = 0; i < RI; ++i)
#pragma unroll
                for (int j = 0; j < CJ; ++j) {
                    const int r = warp + kWarps * i, c = lane + 32 * j;
                    Ss[r * LS + c] = visible(q0 + r, k0 + c, S, causal)
                                         ? s[i][j] * scale : -INFINITY;
                }
        }
        __syncthreads();
        // online softmax, one thread a row; a row that sees no key of this
        // tile keeps its state (p = 0), one that has seen none yet stays at
        // m = -inf, l = 0
        for (int r = tid; r < BQ; r += kThreads) {
            const float m_prev = row_m[r];
            float m_cur = -INFINITY;
            for (int c = 0; c < BK; ++c) m_cur = fmaxf(m_cur, Ss[r * LS + c]);
            const float m_new = fmaxf(m_prev, m_cur);
            float alpha = 1.f, sum = 0.f;
            if (m_new == -INFINITY) {
                for (int c = 0; c < BK; ++c) Ss[r * LS + c] = 0.f;
            } else {
                alpha = m_prev == -INFINITY ? 0.f : expf(m_prev - m_new);
                for (int c = 0; c < BK; ++c) {
                    const float sv = Ss[r * LS + c];
                    const float p = sv == -INFINITY ? 0.f : expf(sv - m_new);
                    Ss[r * LS + c] = p;
                    sum += p;
                }
            }
            row_m[r] = m_new;
            row_l[r] = alpha * row_l[r] + sum;
            row_a[r] = alpha;
        }
        __syncthreads();
#pragma unroll
        for (int i = 0; i < RI; ++i) {
            const float a = row_a[warp + kWarps * i];
#pragma unroll
            for (int j = 0; j < DJ; ++j) acc[i][j] *= a;
        }
        for (int c = 0; c < BK; ++c) {
            float vv[DJ];
#pragma unroll
            for (int j = 0; j < DJ; ++j) vv[j] = Vs[c * D + lane + 32 * j];
#pragma unroll
            for (int i = 0; i < RI; ++i) {
                const float p = Ss[(warp + kWarps * i) * LS + c];
#pragma unroll
                for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(p, vv[j], acc[i][j]);
            }
        }
    }
    // row_l / row_m were last written before the loop's final barrier
#pragma unroll
    for (int i = 0; i < RI; ++i) {
        const int r = warp + kWarps * i, g = q0 + r;
        if (g >= S) continue;
        const float l = row_l[r];
        const float l_safe = l == 0.f ? 1.f : l;
#pragma unroll
        for (int j = 0; j < DJ; ++j)
            out[qoff + size_t(g) * D + lane + 32 * j] = acc[i][j] / l_safe;
        if (lane == 0)
            lse[(size_t(b) * H + h) * S + g] =
                l == 0.f ? -INFINITY : row_m[r] + logf(l);
    }
}

// ---------------------------------------------------------------------------
// backward, dq: one block per (q tile, q head, batch row), keys innermost
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                float* __restrict__ dq, int H, int KV, int S, float scale,
                int causal) {
    using C = Tiles<D>;
    constexpr int BQ = C::kDqQ, BK = C::kKeys, LD = C::LD, LS = BK + 1;
    constexpr int RI = BQ / kWarps, CJ = BK / 32, DJ = D / 32;
    extern __shared__ float smem[];
    float* Qs = smem;                 // [BQ][LD]
    float* Os = Qs + BQ * LD;         // [BQ][LD] dout
    float* Ks = Os + BQ * LD;         // [BK][LD]
    float* Vs = Ks + BK * LD;         // [BK][LD]
    float* Ss = Vs + BK * LD;         // [BQ][LS] ds
    float* lse_s = Ss + BQ * LS;
    float* dl_s = lse_s + BQ;

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int nq = (S + BQ - 1) / BQ;
    const int q0 = (nq - 1 - int(blockIdx.x)) * BQ;
    const int h = blockIdx.y, b = blockIdx.z;
    const int hk = h / (H / KV);
    const size_t qoff = (size_t(b) * H + h) * size_t(S) * D;
    const size_t kvoff = (size_t(b) * KV + hk) * size_t(S) * D;
    const size_t roff = (size_t(b) * H + h) * size_t(S);

    stage<D>(Qs, LD, q + qoff, q0, BQ, S, tid);
    stage<D>(Os, LD, dout + qoff, q0, BQ, S, tid);
    stage_rows(lse_s, dl_s, lse + roff, delta + roff, q0, BQ, S, tid);
    float acc[RI][DJ];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;

    const int last_q = min(q0 + BQ, S) - 1;
    const int nk = causal ? last_q / BK + 1 : (S + BK - 1) / BK;
    for (int kt = 0; kt < nk; ++kt) {
        const int k0 = kt * BK;
        __syncthreads();
        stage<D>(Ks, LD, k + kvoff, k0, BK, S, tid);
        stage<D>(Vs, LD, v + kvoff, k0, BK, S, tid);
        __syncthreads();
        {
            float s[RI][CJ], dp[RI][CJ];
#pragma unroll
            for (int i = 0; i < RI; ++i)
#pragma unroll
                for (int j = 0; j < CJ; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
            for (int d = 0; d < D; ++d) {
                float kk[CJ], vv[CJ];
#pragma unroll
                for (int j = 0; j < CJ; ++j) {
                    kk[j] = Ks[(lane + 32 * j) * LD + d];
                    vv[j] = Vs[(lane + 32 * j) * LD + d];
                }
#pragma unroll
                for (int i = 0; i < RI; ++i) {
                    const int r = warp + kWarps * i;
                    const float qv = Qs[r * LD + d], ov = Os[r * LD + d];
#pragma unroll
                    for (int j = 0; j < CJ; ++j) {
                        s[i][j] = fmaf(qv, kk[j], s[i][j]);
                        dp[i][j] = fmaf(ov, vv[j], dp[i][j]);
                    }
                }
            }
#pragma unroll
            for (int i = 0; i < RI; ++i)
#pragma unroll
                for (int j = 0; j < CJ; ++j) {
                    const int r = warp + kWarps * i, c = lane + 32 * j;
                    const float p = visible(q0 + r, k0 + c, S, causal)
                                        ? expf(s[i][j] * scale - lse_s[r]) : 0.f;
                    Ss[r * LS + c] = p * (dp[i][j] - dl_s[r]) * scale;
                }
        }
        __syncthreads();
        for (int c = 0; c < BK; ++c) {
            float kk[DJ];
#pragma unroll
            for (int j = 0; j < DJ; ++j) kk[j] = Ks[c * LD + lane + 32 * j];
#pragma unroll
            for (int i = 0; i < RI; ++i) {
                const float ds = Ss[(warp + kWarps * i) * LS + c];
#pragma unroll
                for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(ds, kk[j], acc[i][j]);
            }
        }
    }
#pragma unroll
    for (int i = 0; i < RI; ++i) {
        const int g = q0 + warp + kWarps * i;
        if (g >= S) continue;
#pragma unroll
        for (int j = 0; j < DJ; ++j)
            dq[qoff + size_t(g) * D + lane + 32 * j] = acc[i][j];
    }
}

// ---------------------------------------------------------------------------
// backward, dk/dv: one block per (key tile, kv head, batch row); it walks
// the q heads of its GQA group and, for each, the q tiles from the diagonal
// on, so dk/dv come out summed over the group
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_dkv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 float* __restrict__ dk, float* __restrict__ dv, int H, int KV, int S,
                 float scale, int causal) {
    using C = Tiles<D>;
    constexpr int BK = C::kDkvK, BQ = C::kDkvQ, LD = C::LD, LS = BK + 1;
    // score step: thread (tr, tc) owns rows tr + TR * i and keys tc + TC * j
    constexpr int TC = 16, TR = kThreads / TC;
    constexpr int SI = BQ / TR, SJ = BK / TC;
    // accumulation: warp rows (keys) warp + kWarps * i, lane columns
    constexpr int KI = BK / kWarps, DJ = D / 32;
    extern __shared__ float smem[];
    float* Ks = smem;                 // [BK][LD]
    float* Vs = Ks + BK * LD;         // [BK][LD]
    float* Qs = Vs + BK * LD;         // [BQ][LD]
    float* Os = Qs + BQ * LD;         // [BQ][LD] dout
    float* Ps = Os + BQ * LD;         // [BQ][LS] p
    float* Ds = Ps + BQ * LS;         // [BQ][LS] ds
    float* lse_s = Ds + BQ * LS;
    float* dl_s = lse_s + BQ;

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int tc = tid % TC, tr = tid / TC;
    const int k0 = blockIdx.x * BK;   // the causal-heaviest tiles come first
    const int hk = blockIdx.y, b = blockIdx.z;
    const int G = H / KV;
    const size_t kvoff = (size_t(b) * KV + hk) * size_t(S) * D;

    stage<D>(Ks, LD, k + kvoff, k0, BK, S, tid);
    stage<D>(Vs, LD, v + kvoff, k0, BK, S, tid);
    float acc_k[KI][DJ], acc_v[KI][DJ];
#pragma unroll
    for (int i = 0; i < KI; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc_k[i][j] = acc_v[i][j] = 0.f;

    const int nq = (S + BQ - 1) / BQ;
    const int first = causal ? k0 / BQ : 0;
    for (int g = 0; g < G; ++g) {
        const int h = hk * G + g;
        const size_t qoff = (size_t(b) * H + h) * size_t(S) * D;
        const size_t roff = (size_t(b) * H + h) * size_t(S);
        for (int qt = first; qt < nq; ++qt) {
            const int q0 = qt * BQ;
            __syncthreads();          // the last tile's readers are done
            stage<D>(Qs, LD, q + qoff, q0, BQ, S, tid);
            stage<D>(Os, LD, dout + qoff, q0, BQ, S, tid);
            stage_rows(lse_s, dl_s, lse + roff, delta + roff, q0, BQ, S, tid);
            __syncthreads();
            {
                float s[SI][SJ], dp[SI][SJ];
#pragma unroll
                for (int i = 0; i < SI; ++i)
#pragma unroll
                    for (int j = 0; j < SJ; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
                for (int d = 0; d < D; ++d) {
                    float kk[SJ], vv[SJ];
#pragma unroll
                    for (int j = 0; j < SJ; ++j) {
                        kk[j] = Ks[(tc + TC * j) * LD + d];
                        vv[j] = Vs[(tc + TC * j) * LD + d];
                    }
#pragma unroll
                    for (int i = 0; i < SI; ++i) {
                        const int r = tr + TR * i;
                        const float qv = Qs[r * LD + d], ov = Os[r * LD + d];
#pragma unroll
                        for (int j = 0; j < SJ; ++j) {
                            s[i][j] = fmaf(qv, kk[j], s[i][j]);
                            dp[i][j] = fmaf(ov, vv[j], dp[i][j]);
                        }
                    }
                }
#pragma unroll
                for (int i = 0; i < SI; ++i)
#pragma unroll
                    for (int j = 0; j < SJ; ++j) {
                        const int r = tr + TR * i, c = tc + TC * j;
                        const float p = visible(q0 + r, k0 + c, S, causal)
                                            ? expf(s[i][j] * scale - lse_s[r]) : 0.f;
                        Ps[r * LS + c] = p;
                        Ds[r * LS + c] = p * (dp[i][j] - dl_s[r]) * scale;
                    }
            }
            __syncthreads();
            for (int r = 0; r < BQ; ++r) {
                float oo[DJ], qq[DJ];
#pragma unroll
                for (int j = 0; j < DJ; ++j) {
                    oo[j] = Os[r * LD + lane + 32 * j];
                    qq[j] = Qs[r * LD + lane + 32 * j];
                }
#pragma unroll
                for (int i = 0; i < KI; ++i) {
                    const int c = warp + kWarps * i;
                    const float p = Ps[r * LS + c], ds = Ds[r * LS + c];
#pragma unroll
                    for (int j = 0; j < DJ; ++j) {
                        acc_v[i][j] = fmaf(p, oo[j], acc_v[i][j]);
                        acc_k[i][j] = fmaf(ds, qq[j], acc_k[i][j]);
                    }
                }
            }
        }
    }
#pragma unroll
    for (int i = 0; i < KI; ++i) {
        const int g = k0 + warp + kWarps * i;
        if (g >= S) continue;
#pragma unroll
        for (int j = 0; j < DJ; ++j) {
            const size_t o = kvoff + size_t(g) * D + lane + 32 * j;
            dk[o] = acc_k[i][j];
            dv[o] = acc_v[i][j];
        }
    }
}

// raise a kernel's dynamic shared-memory limit once per process (not on
// every launch: a launch may be captured into a CUDA graph)
template <typename Kernel>
cudaError_t allow_smem(Kernel kern, size_t bytes, bool& done) {
    if (done) return cudaSuccess;
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
    done = e == cudaSuccess;
    return e;
}

// ===========================================================================
// bf16: tensor-core (wgmma) kernels fed by TMA
// ===========================================================================

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

template <int D>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_fwd_tc_kernel(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    bf16* __restrict__ out, float* __restrict__ lse, int H,
                    int KV, int S, float scale_log2, int causal) {
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
    const int nq = (S + BQ - 1) / BQ;
    const int q0 = (nq - 1 - int(blockIdx.x)) * BQ;   // longest rows first
    const int h = blockIdx.y, b = blockIdx.z;
    const int hk = h / (H / KV);
    const int last_q = min(q0 + BQ, S) - 1;
    const int nk = causal ? last_q / BK + 1 : (S + BK - 1) / BK;

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
            tma_tile<D>(Qs, &tq, q_full, BQ, q0, b * H + h);
            for (int j = 0; j < nk; ++j) {
                const int s = j % kStages;
                bar_wait(&empty[s], ((j / kStages) & 1) ^ 1);
                bar_arrive_tx(&k_full[s], C::KV_BYTES);
                tma_tile<D>(Ks + s * C::KV_BYTES, &tk, &k_full[s], BK, j * BK,
                            b * KV + hk);
                bar_arrive_tx(&v_full[s], C::KV_BYTES);
                tma_tile<D>(Vs + s * C::KV_BYTES, &tv, &v_full[s], BK, j * BK,
                            b * KV + hk);
            }
        }
        return;
    }
    reg_alloc<kConsumerRegs>();

    const int warp = (tid % 128) / 32, lane = tid % 32;
    const int row_base = q0 + wg * 64;
    const int r0 = row_base + warp * 16 + lane / 4, r1 = r0 + 8;
    const int c_lane = 2 * (lane % 4);
    // this warpgroup's key tiles; under causal masking the first warpgroup
    // may see none of the block's last tile
    const int nk_wg = causal ? (min(row_base + 64, S) - 1) / BK + 1 : nk;

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
    const uint32_t qs = smem_u32(Qs);

    bar_wait(q_full, 0);
    for (int j = 0; j < nk; ++j) {
        const int s = j % kStages;
        const uint32_t ph = (j / kStages) & 1;
        bar_wait(&k_full[s], ph);
        if (j < nk_wg) {
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

            const int k0 = j * BK;
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
    const size_t row0 = (size_t(b) * H + h) * size_t(S);
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
            lse[row0 + r0] = l0 == 0.f ? -INFINITY : (m0 + log2f(l0)) * kLn2;
        if (r1 < S)
            lse[row0 + r1] = l1 == 0.f ? -INFINITY : (m1 + log2f(l1)) * kLn2;
    }
}

// ---------------------------------------------------------------------------
// backward, dq: 128 q rows of one (batch, q head) a block, keys innermost
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

template <int D>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_dq_tc_kernel(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   const __grid_constant__ CUtensorMap tdo,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, bf16* __restrict__ dq,
                   int H, int KV, int S, float scale, float scale_log2,
                   int causal) {
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
    const int nq = (S + BQ - 1) / BQ;
    const int q0 = (nq - 1 - int(blockIdx.x)) * BQ;
    const int h = blockIdx.y, b = blockIdx.z;
    const int hk = h / (H / KV);
    const int last_q = min(q0 + BQ, S) - 1;
    const int nk = causal ? last_q / BK + 1 : (S + BK - 1) / BK;

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
            tma_tile<D>(Qs, &tq, qo_full, BQ, q0, b * H + h);
            tma_tile<D>(Os, &tdo, qo_full, BQ, q0, b * H + h);
            for (int j = 0; j < nk; ++j) {
                const int s = j % kStages;
                bar_wait(&empty[s], ((j / kStages) & 1) ^ 1);
                bar_arrive_tx(&k_full[s], C::KV_BYTES);
                tma_tile<D>(Ks + s * C::KV_BYTES, &tk, &k_full[s], BK, j * BK,
                            b * KV + hk);
                bar_arrive_tx(&v_full[s], C::KV_BYTES);
                tma_tile<D>(Vs + s * C::KV_BYTES, &tv, &v_full[s], BK, j * BK,
                            b * KV + hk);
            }
        }
        return;
    }
    reg_alloc<kConsumerRegs>();

    const int warp = (tid % 128) / 32, lane = tid % 32;
    const int row_base = q0 + wg * 64;
    const int r0 = row_base + warp * 16 + lane / 4, r1 = r0 + 8;
    const int c_lane = 2 * (lane % 4);
    const int nk_wg = causal ? (min(row_base + 64, S) - 1) / BK + 1 : nk;
    const size_t row0 = (size_t(b) * H + h) * size_t(S);
    const float lse0 = r0 < S ? lse[row0 + r0] * kLog2e : 0.f;
    const float lse1 = r1 < S ? lse[row0 + r1] * kLog2e : 0.f;
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
        bar_wait(&k_full[s], ph);
        if (j < nk_wg) {
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

            const int k0 = j * BK;
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
// backward, dk/dv: 128 keys (64 at D 256) of one (batch, kv head) a block;
// it walks the q heads of its GQA group and, for each, the 64-row q tiles
// from the diagonal on, so dk/dv come out summed over the group
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

template <int D>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_dkv_tc_kernel(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    const __grid_constant__ CUtensorMap tdo,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, bf16* __restrict__ dk,
                    bf16* __restrict__ dv, int H, int KV, int S, float scale,
                    float scale_log2, int causal) {
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
    const int k0 = blockIdx.x * KEYS;   // the causal-heaviest tiles come first
    const int hk = blockIdx.y, b = blockIdx.z;
    const int G = H / KV;
    const int nq = (S + BQ - 1) / BQ;
    const int first = causal ? k0 / BQ : 0;
    const int per_head = nq - first;
    const int n_it = G * per_head;

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
            tma_tile<D>(Ks, &tk, kv_full, KEYS, k0, b * KV + hk);
            tma_tile<D>(Vs, &tv, kv_full, KEYS, k0, b * KV + hk);
        }
        for (int it = 0; it < n_it; ++it) {
            const int s = it % kStages;
            const int h = hk * G + it / per_head;
            const int q0 = (first + it % per_head) * BQ;
            const size_t row0 = (size_t(b) * H + h) * size_t(S);
            bar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
            for (int r = lane; r < BQ; r += 32) {
                const int g = q0 + r;
                lse_s[s * BQ + r] = g < S ? lse[row0 + g] * kLog2e : 0.f;
                dl_s[s * BQ + r] = g < S ? delta[row0 + g] : 0.f;
            }
            if (lane == 0) {
                bar_arrive_tx(&full[s], 2 * C::Q_BYTES);
                tma_tile<D>(Qs + s * C::Q_BYTES, &tq, &full[s], BQ, q0,
                            b * H + h);
                tma_tile<D>(Os + s * C::Q_BYTES, &tdo, &full[s], BQ, q0,
                            b * H + h);
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
        const int q0 = (first + it % per_head) * BQ;
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

    const size_t kvrow = (size_t(b) * KV + hk) * size_t(S);
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

// ===========================================================================
// host
// ===========================================================================

template <int D>
int fwd_f32(const void* q, const void* k, const void* v, void* out, void* lse,
            int B, int H, int KV, int S, float scale, int causal,
            cudaStream_t st) {
    using C = Tiles<D>;
    auto kern = flash_fwd_f32_kernel<D>;
    static bool smem_set = false;
    cudaError_t e = allow_smem(kern, C::fwd_bytes(), smem_set);
    if (e != cudaSuccess) return int(e);
    dim3 grid((S + C::kFwdQ - 1) / C::kFwdQ, H, B);
    kern<<<grid, kThreads, C::fwd_bytes(), st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(out),
        static_cast<float*>(lse), H, KV, S, scale, causal);
    return int(cudaGetLastError());
}

template <int D>
int bwd_f32(const void* q, const void* k, const void* v, const void* dout,
            const void* lse, const void* delta, void* dq, void* dk, void* dv,
            int B, int H, int KV, int S, float scale, int causal,
            cudaStream_t st) {
    using C = Tiles<D>;
    auto kq = flash_dq_f32_kernel<D>;
    auto kkv = flash_dkv_f32_kernel<D>;
    static bool dq_set = false, dkv_set = false;
    cudaError_t e = allow_smem(kq, C::dq_bytes(), dq_set);
    if (e == cudaSuccess) e = allow_smem(kkv, C::dkv_bytes(), dkv_set);
    if (e != cudaSuccess) return int(e);
    const float* qp = static_cast<const float*>(q);
    const float* kp = static_cast<const float*>(k);
    const float* vp = static_cast<const float*>(v);
    const float* op = static_cast<const float*>(dout);
    const float* lp = static_cast<const float*>(lse);
    const float* dp = static_cast<const float*>(delta);
    dim3 gq((S + C::kDqQ - 1) / C::kDqQ, H, B);
    kq<<<gq, kThreads, C::dq_bytes(), st>>>(qp, kp, vp, op, lp, dp,
                                            static_cast<float*>(dq), H, KV, S,
                                            scale, causal);
    e = cudaGetLastError();
    if (e != cudaSuccess) return int(e);
    dim3 gkv((S + C::kDkvK - 1) / C::kDkvK, KV, B);
    kkv<<<gkv, kThreads, C::dkv_bytes(), st>>>(qp, kp, vp, op, lp, dp,
                                               static_cast<float*>(dk),
                                               static_cast<float*>(dv), H, KV,
                                               S, scale, causal);
    return int(cudaGetLastError());
}

// host microseconds the last bf16 call spent encoding its tensor maps
double g_map_us = 0.0;

using Clock = std::chrono::steady_clock;

double us_since(Clock::time_point t0) {
    return std::chrono::duration<double, std::micro>(Clock::now() - t0).count();
}

template <int D>
int fwd_bf16(const void* q, const void* k, const void* v, void* out,
             void* lse, int B, int H, int KV, int S, float scale, int causal,
             cudaStream_t st) {
    using C = FwdTc<D>;
    const auto t0 = Clock::now();
    CUtensorMap mq, mk, mv;
    int r = tile_map(&mq, q, B * H, S, D, C::BQ);
    if (!r) r = tile_map(&mk, k, B * KV, S, D, C::BK);
    if (!r) r = tile_map(&mv, v, B * KV, S, D, C::BK);
    g_map_us = us_since(t0);
    if (r) return r;
    auto kern = flash_fwd_tc_kernel<D>;
    static bool smem_set = false;
    cudaError_t e = allow_smem(kern, C::smem(), smem_set);
    if (e != cudaSuccess) return int(e);
    dim3 grid((S + C::BQ - 1) / C::BQ, H, B);
    kern<<<grid, kTcThreads, C::smem(), st>>>(
        mq, mk, mv, static_cast<bf16*>(out), static_cast<float*>(lse), H, KV,
        S, scale * kLog2e, causal);
    return int(cudaGetLastError());
}

template <int D>
int bwd_bf16(const void* q, const void* k, const void* v, const void* dout,
             const void* lse, const void* delta, void* dq, void* dk, void* dv,
             int B, int H, int KV, int S, float scale, int causal,
             cudaStream_t st) {
    using CQ = DqTc<D>;
    using CK = DkvTc<D>;
    const auto t0 = Clock::now();
    CUtensorMap mq, mk, mv, mdo, nq, nk, nv, ndo;   // m: dq kernel, n: dk/dv
    int r = tile_map(&mq, q, B * H, S, D, CQ::BQ);
    if (!r) r = tile_map(&mdo, dout, B * H, S, D, CQ::BQ);
    if (!r) r = tile_map(&mk, k, B * KV, S, D, CQ::BK);
    if (!r) r = tile_map(&mv, v, B * KV, S, D, CQ::BK);
    if (!r) r = tile_map(&nq, q, B * H, S, D, CK::BQ);
    if (!r) r = tile_map(&ndo, dout, B * H, S, D, CK::BQ);
    if (!r) r = tile_map(&nk, k, B * KV, S, D, CK::KEYS);
    if (!r) r = tile_map(&nv, v, B * KV, S, D, CK::KEYS);
    g_map_us = us_since(t0);
    if (r) return r;
    auto kq = flash_dq_tc_kernel<D>;
    auto kkv = flash_dkv_tc_kernel<D>;
    static bool dq_set = false, dkv_set = false;
    cudaError_t e = allow_smem(kq, CQ::smem(), dq_set);
    if (e == cudaSuccess) e = allow_smem(kkv, CK::smem(), dkv_set);
    if (e != cudaSuccess) return int(e);
    const float* lp = static_cast<const float*>(lse);
    const float* dp = static_cast<const float*>(delta);
    const float sl2 = scale * kLog2e;
    dim3 gq((S + CQ::BQ - 1) / CQ::BQ, H, B);
    kq<<<gq, kTcThreads, CQ::smem(), st>>>(mq, mk, mv, mdo, lp, dp,
                                           static_cast<bf16*>(dq), H, KV, S,
                                           scale, sl2, causal);
    e = cudaGetLastError();
    if (e != cudaSuccess) return int(e);
    dim3 gkv((S + CK::KEYS - 1) / CK::KEYS, KV, B);
    kkv<<<gkv, kTcThreads, CK::smem(), st>>>(nq, nk, nv, ndo, lp, dp,
                                             static_cast<bf16*>(dk),
                                             static_cast<bf16*>(dv), H, KV, S,
                                             scale, sl2, causal);
    return int(cudaGetLastError());
}

bool bad_shape(int B, int H, int KV, int S, int D, int dtype) {
    return B <= 0 || H <= 0 || KV <= 0 || H % KV || S <= 0 ||
           (D != 64 && D != 128 && D != 256) || (dtype != 0 && dtype != 1) ||
           (dtype == 1 && S < 128) || H > 65535 || B > 65535;
}

}  // namespace

// q [B, H, S, D], k/v [B, KV, S, D] (dtype 0: fp32, 1: bf16), contiguous;
// writes out [B, H, S, D] (q's dtype) and lse [B, H, S] fp32. Returns 0, a
// CUDA error code, or (bf16) 1000 + the CUresult of a tensor map that
// cannot be made.
extern "C" int ds_flash_attention_fwd(const void* q, const void* k,
                                      const void* v, void* out, void* lse,
                                      int B, int H, int KV, int S, int D,
                                      float scale, int causal, int dtype,
                                      void* stream) {
    if (bad_shape(B, H, KV, S, D, dtype)) return int(cudaErrorInvalidValue);
    auto st = static_cast<cudaStream_t>(stream);
#define DS_FWD(F, DD) F<DD>(q, k, v, out, lse, B, H, KV, S, scale, causal, st)
    if (dtype == 0) {
        if (D == 64) return DS_FWD(fwd_f32, 64);
        if (D == 128) return DS_FWD(fwd_f32, 128);
        return DS_FWD(fwd_f32, 256);
    }
    if (D == 64) return DS_FWD(fwd_bf16, 64);
    if (D == 128) return DS_FWD(fwd_bf16, 128);
    return DS_FWD(fwd_bf16, 256);
#undef DS_FWD
}

// the forward's inputs plus dout [B, H, S, D], lse and delta [B, H, S] fp32;
// writes dq [B, H, S, D] and dk/dv [B, KV, S, D] (summed over each group).
extern "C" int ds_flash_attention_bwd(const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const void* lse, const void* delta,
                                      void* dq, void* dk, void* dv, int B,
                                      int H, int KV, int S, int D, float scale,
                                      int causal, int dtype, void* stream) {
    if (bad_shape(B, H, KV, S, D, dtype)) return int(cudaErrorInvalidValue);
    auto st = static_cast<cudaStream_t>(stream);
#define DS_BWD(F, DD) F<DD>(q, k, v, dout, lse, delta, dq, dk, dv, B, H, KV, \
                            S, scale, causal, st)
    if (dtype == 0) {
        if (D == 64) return DS_BWD(bwd_f32, 64);
        if (D == 128) return DS_BWD(bwd_f32, 128);
        return DS_BWD(bwd_f32, 256);
    }
    if (D == 64) return DS_BWD(bwd_bf16, 64);
    if (D == 128) return DS_BWD(bwd_bf16, 128);
    return DS_BWD(bwd_bf16, 256);
#undef DS_BWD
}

// host microseconds the last bf16 call (forward or backward) spent encoding
// its TMA tensor maps
extern "C" double ds_flash_attention_map_us() { return g_map_us; }

// dynamic shared memory of a bf16 kernel (which: 0 forward, 1 dq, 2 dk/dv)
// at head dim D, or -1
extern "C" int ds_flash_attention_tc_smem(int which, int D) {
    if (D != 64 && D != 128 && D != 256) return -1;
#define DS_SMEM(T) (D == 64 ? T<64>::smem() : D == 128 ? T<128>::smem() \
                                                   : T<256>::smem())
    if (which == 0) return int(DS_SMEM(FwdTc));
    if (which == 1) return int(DS_SMEM(DqTc));
    if (which == 2) return int(DS_SMEM(DkvTc));
    return -1;
#undef DS_SMEM
}
