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
// shared memory, warp-specialised (two consumer warpgroups and a producer
// warp): the kernels of flash_tc.cuh, which K6 shares, instantiated with
// K4's dense walk (`DenseWalk` below). Tensors are described to TMA as
// [B * heads, S, D].
// - forward: 128 q rows of one (batch, head) a block, key tiles of 128 (64
//   at D 256) from the first to the diagonal; tiles wholly above it are
//   never loaded; the longest rows of a causal call are launched first.
// - dq: 128 q rows a block, key tiles of 64 (32 at D 256).
// - dk/dv: 128 keys of one (batch, kv head) a block (64 at D 256), walking
//   64-row q tiles of every q head of the group from the diagonal down; dk
//   and dv are written once, summed over the group.
// The two backward kernels recompute the scores (no atomics, so the result
// is the same from run to run); one pass with atomics on dq is later work.
// Each host entry binds the device's context before it encodes the maps
// (hopper.cuh `bind_context`).
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

#include "flash_tc.cuh"
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
// bf16: the tensor-core kernels of flash_tc.cuh over K4's dense walk
// ===========================================================================

using namespace flash_tc;

// K4's walk: every key tile of a (batch row, head) from the first to the
// diagonal (all of them without causal); q head h reads kv head h / (H / KV)
struct DenseWalk {
    int H, KV, S, causal;
    __device__ static float empty_lse() { return -INFINITY; }
    __device__ static float lse_in(float l) { return l; }

    // forward / dq: one block per (q tile, q head, batch row), the longest
    // rows of a causal call launched first; tiles wholly above the diagonal
    // are never loaded
    template <int BQ, int BK>
    struct Rows {
        int q0, qslab, kslab, n;
        __device__ explicit Rows(const DenseWalk& w) {
            const int nq = (w.S + BQ - 1) / BQ;
            q0 = (nq - 1 - int(blockIdx.x)) * BQ;
            const int h = blockIdx.y, b = blockIdx.z;
            qslab = b * w.H + h;
            kslab = b * w.KV + h / (w.H / w.KV);
            const int last_q = min(q0 + BQ, w.S) - 1;
            n = w.causal ? last_q / BK + 1 : (w.S + BK - 1) / BK;
        }
        __device__ int key(int j) const { return j * BK; }
    };

    // dk/dv: one block per (key tile, kv head, batch row), the
    // causal-heaviest tiles first; it walks the q heads of its GQA group
    // and, for each, the q tiles from the diagonal on, so dk/dv come out
    // summed over the group
    template <int KEYS, int BQ>
    struct Cols {
        int k0, kslab, n, first, per_head, qslab0;
        __device__ explicit Cols(const DenseWalk& w) {
            k0 = blockIdx.x * KEYS;
            const int hk = blockIdx.y, b = blockIdx.z;
            const int G = w.H / w.KV;
            kslab = b * w.KV + hk;
            qslab0 = b * w.H + hk * G;
            first = w.causal ? k0 / BQ : 0;
            per_head = (w.S + BQ - 1) / BQ - first;
            n = G * per_head;
        }
        __device__ int query(int j) const {
            return (first + j % per_head) * BQ;
        }
        __device__ int qslab(int j) const { return qslab0 + j / per_head; }
    };
};

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
    const cudaError_t bound = bind_context();
    if (bound != cudaSuccess) return int(bound);
    const auto t0 = Clock::now();
    CUtensorMap mq, mk, mv;
    int r = tile_map(&mq, q, B * H, S, D, C::BQ);
    if (!r) r = tile_map(&mk, k, B * KV, S, D, C::BK);
    if (!r) r = tile_map(&mv, v, B * KV, S, D, C::BK);
    g_map_us = us_since(t0);
    if (r) return r;
    auto kern = flash_fwd_tc_kernel<D, DenseWalk>;
    static bool smem_set = false;
    cudaError_t e = allow_smem(kern, C::smem(), smem_set);
    if (e != cudaSuccess) return int(e);
    dim3 grid((S + C::BQ - 1) / C::BQ, H, B);
    kern<<<grid, kTcThreads, C::smem(), st>>>(
        mq, mk, mv, static_cast<bf16*>(out), static_cast<float*>(lse),
        DenseWalk{H, KV, S, causal}, scale * kLog2e);
    return int(cudaGetLastError());
}

template <int D>
int bwd_bf16(const void* q, const void* k, const void* v, const void* dout,
             const void* lse, const void* delta, void* dq, void* dk, void* dv,
             int B, int H, int KV, int S, float scale, int causal,
             cudaStream_t st) {
    using CQ = DqTc<D>;
    using CK = DkvTc<D>;
    const cudaError_t bound = bind_context();
    if (bound != cudaSuccess) return int(bound);
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
    auto kq = flash_dq_tc_kernel<D, DenseWalk>;
    auto kkv = flash_dkv_tc_kernel<D, DenseWalk>;
    static bool dq_set = false, dkv_set = false;
    cudaError_t e = allow_smem(kq, CQ::smem(), dq_set);
    if (e == cudaSuccess) e = allow_smem(kkv, CK::smem(), dkv_set);
    if (e != cudaSuccess) return int(e);
    const float* lp = static_cast<const float*>(lse);
    const float* dp = static_cast<const float*>(delta);
    const float sl2 = scale * kLog2e;
    const DenseWalk walk{H, KV, S, causal};
    dim3 gq((S + CQ::BQ - 1) / CQ::BQ, H, B);
    kq<<<gq, kTcThreads, CQ::smem(), st>>>(mq, mk, mv, mdo, lp, dp,
                                           static_cast<bf16*>(dq), walk,
                                           scale, sl2);
    e = cudaGetLastError();
    if (e != cudaSuccess) return int(e);
    dim3 gkv((S + CK::KEYS - 1) / CK::KEYS, KV, B);
    kkv<<<gkv, kTcThreads, CK::smem(), st>>>(nq, nk, nv, ndo, lp, dp,
                                             static_cast<bf16*>(dk),
                                             static_cast<bf16*>(dv), walk,
                                             scale, sl2);
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
