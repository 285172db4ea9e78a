// Block-sparse flash attention, forward and backward (K6).
//
// Replaces the TPU kernels of deepspeed_tpu/ops/pallas/block_sparse_attention.py:
// `_fwd_kernel` (forward), `_dq_kernel` (dq) and `_dkv_kernel` (dk and dv),
// behind the entry `block_sparse_flash_attention`.
//
// What it computes, in the layout [B, H, S, D] for q, k, v, out and the
// grads (one KV head per q head), over a block layout of `block`-row blocks
// given as tables (deepspeed_tpu_torch/ops/block_sparse_attention.py
// `layout_tables`): tbl_q[h, i, :cnt_q[h, i]] are the key blocks query block
// i of head h sees, tbl_k[h, j, :cnt_k[h, j]] the query blocks that see key
// block j.
// - forward: s = (q . k) * scale in fp32 over the visible blocks, masked
//   where k_pos > q_pos under `causal` (on every visible block, as the Pallas
//   `_apply_masks`: a visible block above the diagonal is wholly masked);
//   online softmax with the Pallas guards (a row still all-masked keeps
//   m = -inf, p = 0 and rescale 0); p rounded to V's dtype for the PV product
//   while l sums the unrounded p; out = acc / l, or 0 where l = 0; lse =
//   m + log(l), or NEG_INF (float's lowest finite value) where l = 0;
// - backward, with delta = rowsum(dout * out) made by the caller (the Pallas
//   `_bwd` makes it in XLA): p = exp(s - lse), lse taken as 0 where it is
//   NEG_INF; dp = dout . v; ds = p * (dp - delta) * scale; dq = sum of ds
//   (rounded to K's dtype) . k over the query block's table entry; dk = sum
//   of ds^T (rounded to Q's dtype) . q and dv = sum of p^T (rounded to dout's
//   dtype) . dout over the key block's transposed table entry. All sums fp32.
// Inputs are fp32 or bf16; D is 64, 128 or 256; `block` is any multiple of 8
// (the JAX gate takes blocks of at least 128).
//
// What bounds it on an H100: the operations. A visible (query, key) pair
// costs 4 * D operations forward and 10 * D backward against a few bytes
// per row of q, k, v: at block 128 that is hundreds of operations per byte,
// above the card's ridge.
//
// What the design does about it, by route (`ops/block_sparse_attention.py`
// `kernel_route`):
// - bf16 at blocks that are a multiple of 128 (the "wgmma" route): K4's
//   tensor-core kernels (flash_tc.cuh: two consumer warpgroups on wgmma, a
//   TMA producer warp, a two-stage mbarrier ring, P and dS kept in
//   registers) instantiated with `TableWalk`, which walks the layout's
//   table instead of every key tile. A forward or dq block owns one 128-row
//   q tile of a table row and expands each key block of its entry into the
//   kernel's key tiles (forward 128 keys, 64 at D 256; dq 64, 32 at D 256);
//   a dk/dv block owns 128 keys (64 at D 256) of a transposed-table row and
//   expands each q block of its entry into 64-row q tiles. The tables are
//   ascending, so under causal the tiles wholly above the diagonal (which
//   are never loaded nor multiplied) are the tail of a q tile's expansion
//   and the head of a key tile's: a count, and for dk/dv a skip, computed
//   once a block, says which. The diagonal tiles get K4's token mask. On
//   an all-ones causal layout at block 128 the walk is K4's, tile for tile,
//   so the results are K4's bits. Each entry binds the device's context
//   before it encodes its tensor maps ([B * H, S, D], as K4's).
// - fp32, and bf16 at other blocks (136, 192, ..., which a 128-row tile
//   would straddle): the CUDA-core kernels below. A block owns one query
//   tile (key tile for dk/dv) of one (head, batch row) and walks its table
//   entry in a loop; a layout block is cut into tiles of the kernel's own
//   height, the last one masked where the block is not a multiple of it;
//   within a visible block, key tiles past the query tile's last row (and,
//   for dk/dv, query tiles before the key tile's first row) are skipped
//   under `causal`, being wholly masked. Tiles are staged in shared memory
//   as fp32 with rows padded by one word; every thread keeps a register
//   tile of its sums and multiplies on the CUDA cores in fp32.
// On both routes CUDA blocks cannot carry the softmax state across grid
// steps as the Pallas grid did, so a block walks its table entry in a loop;
// since dk/dv walk the transposed table no block writes another's rows (no
// atomics: the same bits every run). Rows of a layout differ widely in how
// many blocks they see (a global row of BigBird sees every block), so
// blocks take the table rows busiest first, by the order the caller passes
// (`order_q`, `order_k`). A split of the busiest rows is later work. All
// offsets are 64-bit.
//
// Built with `nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC` into a plain C library (deepspeed_tpu_torch/ops/kernels.py)
// and called through ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

#include "flash_tc.cuh"
#include "hopper.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr float kNegInf = -FLT_MAX;   // the Pallas NEG_INF

// tile shapes per head dim, as K4's: q rows and keys per forward / dq block,
// keys and q rows per dk/dv block
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

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
    return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
    return __float2bfloat16(x);
}

// x rounded to T and read back
template <typename T>
__device__ __forceinline__ float round_to(float x) {
    return to_f(from_f<T>(x));
}

// rows [row0, row0 + rows) of a [S, D] slab into shared memory [rows][ld]
// as fp32; rows at or past `end` are zeros
template <typename T, int D>
__device__ __forceinline__ void stage(float* __restrict__ dst, int ld,
                                      const T* __restrict__ src, int row0,
                                      int rows, int end, int tid) {
    for (int i = tid; i < rows * D; i += kThreads) {
        const int r = i / D, d = i % D;
        const int g = row0 + r;
        dst[r * ld + d] = g < end ? to_f(src[size_t(g) * D + d]) : 0.f;
    }
}

// lse (NEG_INF read as 0) and delta of rows [row0, row0 + rows); rows at or
// past `end` read 0
__device__ __forceinline__ void stage_rows(float* __restrict__ lse_s,
                                           float* __restrict__ dl_s,
                                           const float* __restrict__ lse,
                                           const float* __restrict__ delta,
                                           int row0, int rows, int end,
                                           int tid) {
    for (int r = tid; r < rows; r += kThreads) {
        const int g = row0 + r;
        const float l = g < end ? lse[g] : 0.f;
        lse_s[r] = l == kNegInf ? 0.f : l;
        dl_s[r] = g < end ? delta[g] : 0.f;
    }
}

// query row qp of a tile ending at q_end sees key kp of a tile ending at
// k_end
__device__ __forceinline__ bool visible(int qp, int q_end, int kp, int k_end,
                                        int causal) {
    return qp < q_end && kp < k_end && (!causal || kp <= qp);
}

// ---------------------------------------------------------------------------
// forward: one block per (q tile of a table row, batch row)
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
bsa_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, T* __restrict__ out,
               float* __restrict__ lse, const int* __restrict__ tbl_q,
               const int* __restrict__ cnt_q, const int* __restrict__ order_q,
               int H, int S, int block, int mk, float scale, int causal) {
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
    const int nq = S / block, qt = (block + BQ - 1) / BQ;
    const int row = order_q[blockIdx.x / qt];        // h * nq + qi
    const int h = row / nq, qi = row % nq, b = blockIdx.y;
    const int q0 = qi * block + (blockIdx.x % qt) * BQ;
    const int q_end = min(q0 + BQ, (qi + 1) * block);
    const size_t off = (size_t(b) * H + h) * size_t(S) * D;

    stage<T, D>(Qs, LD, q + off, q0, BQ, q_end, tid);
    for (int r = tid; r < BQ; r += kThreads) {
        row_m[r] = -INFINITY;
        row_l[r] = 0.f;
    }
    float acc[RI][DJ];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;

    const int cnt = cnt_q[row];
    const int* tbl = tbl_q + size_t(row) * mk;
    for (int e = 0; e < cnt; ++e) {
        const int kb0 = tbl[e] * block, k_end = kb0 + block;
        for (int k0 = kb0; k0 < k_end; k0 += BK) {
            if (causal && k0 > q_end - 1) break;     // the rest is masked
            __syncthreads();          // the last tile's readers are done
            stage<T, D>(Ks, LD, k + off, k0, BK, k_end, tid);
            stage<T, D>(Vs, D, v + off, k0, BK, k_end, tid);
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
                        Ss[r * LS + c] = visible(q0 + r, q_end, k0 + c, k_end, causal)
                                             ? s[i][j] * scale : -INFINITY;
                    }
            }
            __syncthreads();
            // online softmax, one thread a row: a row that sees no key of
            // this tile keeps its state (p = 0); one that has seen none yet
            // stays at m = -inf, l = 0 (the Pallas m_safe / alpha guards)
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
                        Ss[r * LS + c] = round_to<T>(p);   // PV takes V's dtype
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
    }
    __syncthreads();                  // row_l / row_m of a row with no tile
#pragma unroll
    for (int i = 0; i < RI; ++i) {
        const int r = warp + kWarps * i, g = q0 + r;
        if (g >= q_end) continue;
        const float l = row_l[r];
        const float l_safe = l == 0.f ? 1.f : l;
#pragma unroll
        for (int j = 0; j < DJ; ++j)
            out[off + size_t(g) * D + lane + 32 * j] = from_f<T>(acc[i][j] / l_safe);
        if (lane == 0)
            lse[(size_t(b) * H + h) * S + g] =
                l == 0.f ? kNegInf : row_m[r] + logf(l);
    }
}

// ---------------------------------------------------------------------------
// backward, dq: one block per (q tile of a table row, batch row)
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
bsa_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              const int* __restrict__ tbl_q, const int* __restrict__ cnt_q,
              const int* __restrict__ order_q, T* __restrict__ dq, int H,
              int S, int block, int mk, float scale, int causal) {
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
    const int nq = S / block, qt = (block + BQ - 1) / BQ;
    const int row = order_q[blockIdx.x / qt];
    const int h = row / nq, qi = row % nq, b = blockIdx.y;
    const int q0 = qi * block + (blockIdx.x % qt) * BQ;
    const int q_end = min(q0 + BQ, (qi + 1) * block);
    const size_t off = (size_t(b) * H + h) * size_t(S) * D;
    const size_t roff = (size_t(b) * H + h) * size_t(S);

    stage<T, D>(Qs, LD, q + off, q0, BQ, q_end, tid);
    stage<T, D>(Os, LD, dout + off, q0, BQ, q_end, tid);
    stage_rows(lse_s, dl_s, lse + roff, delta + roff, q0, BQ, q_end, tid);
    float acc[RI][DJ];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;

    const int cnt = cnt_q[row];
    const int* tbl = tbl_q + size_t(row) * mk;
    for (int e = 0; e < cnt; ++e) {
        const int kb0 = tbl[e] * block, k_end = kb0 + block;
        for (int k0 = kb0; k0 < k_end; k0 += BK) {
            if (causal && k0 > q_end - 1) break;
            __syncthreads();
            stage<T, D>(Ks, LD, k + off, k0, BK, k_end, tid);
            stage<T, D>(Vs, LD, v + off, k0, BK, k_end, tid);
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
                        const float p =
                            visible(q0 + r, q_end, k0 + c, k_end, causal)
                                ? expf(s[i][j] * scale - lse_s[r]) : 0.f;
                        // dq's product takes ds in K's dtype
                        Ss[r * LS + c] =
                            round_to<T>(p * (dp[i][j] - dl_s[r]) * scale);
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
    }
#pragma unroll
    for (int i = 0; i < RI; ++i) {
        const int g = q0 + warp + kWarps * i;
        if (g >= q_end) continue;
#pragma unroll
        for (int j = 0; j < DJ; ++j)
            dq[off + size_t(g) * D + lane + 32 * j] = from_f<T>(acc[i][j]);
    }
}

// ---------------------------------------------------------------------------
// backward, dk/dv: one block per (key tile of a transposed-table row, batch
// row); it walks the query blocks that see its key block
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
bsa_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const T* __restrict__ dout,
               const float* __restrict__ lse, const float* __restrict__ delta,
               const int* __restrict__ tbl_k, const int* __restrict__ cnt_k,
               const int* __restrict__ order_k, T* __restrict__ dk,
               T* __restrict__ dv, int H, int S, int block, int mq,
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
    float* Ps = Os + BQ * LD;         // [BQ][LS] p (in dout's dtype)
    float* Ds = Ps + BQ * LS;         // [BQ][LS] ds (in q's dtype)
    float* lse_s = Ds + BQ * LS;
    float* dl_s = lse_s + BQ;

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int tc = tid % TC, tr = tid / TC;
    const int nk = S / block, kt = (block + BK - 1) / BK;
    const int row = order_k[blockIdx.x / kt];        // h * nk + ki
    const int h = row / nk, ki = row % nk, b = blockIdx.y;
    const int k0 = ki * block + (blockIdx.x % kt) * BK;
    const int k_end = min(k0 + BK, (ki + 1) * block);
    const size_t off = (size_t(b) * H + h) * size_t(S) * D;
    const size_t roff = (size_t(b) * H + h) * size_t(S);

    stage<T, D>(Ks, LD, k + off, k0, BK, k_end, tid);
    stage<T, D>(Vs, LD, v + off, k0, BK, k_end, tid);
    float acc_k[KI][DJ], acc_v[KI][DJ];
#pragma unroll
    for (int i = 0; i < KI; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc_k[i][j] = acc_v[i][j] = 0.f;

    const int cnt = cnt_k[row];
    const int* tbl = tbl_k + size_t(row) * mq;
    for (int e = 0; e < cnt; ++e) {
        const int qb0 = tbl[e] * block, qb_end = qb0 + block;
        for (int q0 = qb0; q0 < qb_end; q0 += BQ) {
            const int q_end = min(q0 + BQ, qb_end);
            if (causal && q_end - 1 < k0) continue;  // wholly masked
            __syncthreads();          // the last tile's readers are done
            stage<T, D>(Qs, LD, q + off, q0, BQ, q_end, tid);
            stage<T, D>(Os, LD, dout + off, q0, BQ, q_end, tid);
            stage_rows(lse_s, dl_s, lse + roff, delta + roff, q0, BQ, q_end,
                       tid);
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
                        const float p =
                            visible(q0 + r, q_end, k0 + c, k_end, causal)
                                ? expf(s[i][j] * scale - lse_s[r]) : 0.f;
                        Ps[r * LS + c] = round_to<T>(p);
                        Ds[r * LS + c] =
                            round_to<T>(p * (dp[i][j] - dl_s[r]) * scale);
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
        if (g >= k_end) continue;
#pragma unroll
        for (int j = 0; j < DJ; ++j) {
            const size_t o = off + size_t(g) * D + lane + 32 * j;
            dk[o] = from_f<T>(acc_k[i][j]);
            dv[o] = from_f<T>(acc_v[i][j]);
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

// the launch's arguments past the element type and head dim
struct Args {
    const void *q, *k, *v, *dout, *lse, *delta;
    const int *tbl, *cnt, *order;
    void *out, *out_lse, *dk, *dv;
    int B, H, S, block, m;
    float scale;
    int causal;
};

// blocks of the grid: a tile of `rows` rows for each table row of each head
dim3 grid_of(const Args& a, int rows) {
    const int n = a.S / a.block;
    return dim3(unsigned(a.H) * n * ((a.block + rows - 1) / rows), a.B);
}

template <typename T, int D>
cudaError_t fwd(const Args& a, cudaStream_t st) {
    using C = Tiles<D>;
    auto kern = bsa_fwd_kernel<T, D>;
    static bool smem_set = false;
    cudaError_t e = allow_smem(kern, C::fwd_bytes(), smem_set);
    if (e != cudaSuccess) return e;
    kern<<<grid_of(a, C::kFwdQ), kThreads, C::fwd_bytes(), st>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k),
        static_cast<const T*>(a.v), static_cast<T*>(a.out),
        static_cast<float*>(a.out_lse), a.tbl, a.cnt, a.order, a.H, a.S,
        a.block, a.m, a.scale, a.causal);
    return cudaGetLastError();
}

template <typename T, int D>
cudaError_t dq(const Args& a, cudaStream_t st) {
    using C = Tiles<D>;
    auto kern = bsa_dq_kernel<T, D>;
    static bool smem_set = false;
    cudaError_t e = allow_smem(kern, C::dq_bytes(), smem_set);
    if (e != cudaSuccess) return e;
    kern<<<grid_of(a, C::kDqQ), kThreads, C::dq_bytes(), st>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k),
        static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
        static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
        a.tbl, a.cnt, a.order, static_cast<T*>(a.out), a.H, a.S, a.block, a.m,
        a.scale, a.causal);
    return cudaGetLastError();
}

template <typename T, int D>
cudaError_t dkv(const Args& a, cudaStream_t st) {
    using C = Tiles<D>;
    auto kern = bsa_dkv_kernel<T, D>;
    static bool smem_set = false;
    cudaError_t e = allow_smem(kern, C::dkv_bytes(), smem_set);
    if (e != cudaSuccess) return e;
    kern<<<grid_of(a, C::kDkvK), kThreads, C::dkv_bytes(), st>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k),
        static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
        static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
        a.tbl, a.cnt, a.order, static_cast<T*>(a.dk), static_cast<T*>(a.dv),
        a.H, a.S, a.block, a.m, a.scale, a.causal);
    return cudaGetLastError();
}

enum class Which { kFwd, kDq, kDkv };

template <typename T, int D>
cudaError_t run(Which w, const Args& a, cudaStream_t st) {
    switch (w) {
        case Which::kFwd:
            return fwd<T, D>(a, st);
        case Which::kDq:
            return dq<T, D>(a, st);
        default:
            return dkv<T, D>(a, st);
    }
}

int dispatch(Which w, const Args& a, int D, int dtype, void* stream) {
    const long long grid_x =
        (long long)a.H * (a.block > 0 ? a.S / a.block : 0) * a.block;
    if (a.B <= 0 || a.B > 65535 || a.H <= 0 || a.S <= 0 || a.block < 8 ||
        a.block % 8 || a.S % a.block || a.m <= 0 || grid_x > INT32_MAX ||
        (D != 64 && D != 128 && D != 256) || (dtype != 0 && dtype != 1))
        return int(cudaErrorInvalidValue);
    auto st = static_cast<cudaStream_t>(stream);
    if (dtype == 0) {
        if (D == 64) return int(run<float, 64>(w, a, st));
        if (D == 128) return int(run<float, 128>(w, a, st));
        return int(run<float, 256>(w, a, st));
    }
    if (D == 64) return int(run<__nv_bfloat16, 64>(w, a, st));
    if (D == 128) return int(run<__nv_bfloat16, 128>(w, a, st));
    return int(run<__nv_bfloat16, 256>(w, a, st));
}

// ===========================================================================
// bf16 at blocks that are a multiple of 128: K4's tensor-core kernels
// (flash_tc.cuh) over a walk of the layout's table
// ===========================================================================

using flash_tc::kTcThreads;

// K6's walk (see the file's head): blocks take the table rows in `order`;
// a row h * n + i is query block i of head h (key block i for dk/dv)
struct TableWalk {
    const int* tbl;
    const int* cnt;
    const int* order;
    int H, S, block, m, causal;
    __device__ static float empty_lse() { return kNegInf; }
    __device__ static float lse_in(float l) { return l == kNegInf ? 0.f : l; }

    // forward / dq: q rows [q0, q0 + BQ) of a table row, and the key tiles
    // of BK keys its entry's blocks hold, ascending; under causal only those
    // that start at or before the tile's last row
    template <int BQ, int BK>
    struct Rows {
        int q0, qslab, kslab, n, block, tpb;
        const int* keys;
        __device__ explicit Rows(const TableWalk& w)
            : block(w.block), tpb(w.block / BK) {
            const int nq = w.S / w.block, qt = w.block / BQ;
            const int row = w.order[blockIdx.x / qt];
            const int h = row / nq, qi = row % nq;
            q0 = qi * w.block + (blockIdx.x % qt) * BQ;
            qslab = kslab = blockIdx.y * w.H + h;
            keys = w.tbl + size_t(row) * w.m;
            const int c = w.cnt[row], last_q = q0 + BQ - 1;
            n = 0;
            for (int e = 0; e < c; ++e) {
                const int kb = keys[e] * block;
                if (!w.causal) {
                    n += tpb;
                } else {
                    if (kb > last_q) break;
                    n += min(tpb, (last_q - kb) / BK + 1);
                }
            }
        }
        __device__ int key(int j) const {
            return keys[j / tpb] * block + (j % tpb) * BK;
        }
    };

    // dk/dv: keys [k0, k0 + KEYS) of a transposed-table row, and the q tiles
    // of BQ rows its entry's blocks hold, ascending; under causal the first
    // `skip` (those that end before k0) are left out
    template <int KEYS, int BQ>
    struct Cols {
        int k0, kslab, n, skip, block, tpb;
        const int* queries;
        __device__ explicit Cols(const TableWalk& w)
            : block(w.block), tpb(w.block / BQ) {
            const int nk = w.S / w.block, kt = w.block / KEYS;
            const int row = w.order[blockIdx.x / kt];
            const int h = row / nk, ki = row % nk;
            k0 = ki * w.block + (blockIdx.x % kt) * KEYS;
            kslab = blockIdx.y * w.H + h;
            queries = w.tbl + size_t(row) * w.m;
            const int c = w.cnt[row];
            skip = 0;
            for (int e = 0; w.causal && e < c; ++e) {
                const int qb = queries[e] * block;
                if (qb >= k0) break;
                skip += min(tpb, (k0 - qb) / BQ);
            }
            n = c * tpb - skip;
        }
        __device__ int query(int j) const {
            const int i = skip + j;
            return queries[i / tpb] * block + (i % tpb) * BQ;
        }
        __device__ int qslab(int) const { return kslab; }
    };
};

TableWalk walk_of(const Args& a) {
    return TableWalk{a.tbl, a.cnt, a.order, a.H, a.S, a.block, a.m, a.causal};
}

// one block per `rows`-row tile of each table row of each head, batch rows
// in y
dim3 tc_grid(const Args& a, int rows) {
    return dim3(unsigned(a.H) * (a.S / rows), a.B);
}

template <int D>
int fwd_tc(const Args& a, cudaStream_t st) {
    using C = flash_tc::FwdTc<D>;
    const int slabs = a.B * a.H;
    CUtensorMap mq, mk, mv;
    int r = hopper::tile_map(&mq, a.q, slabs, a.S, D, C::BQ);
    if (!r) r = hopper::tile_map(&mk, a.k, slabs, a.S, D, C::BK);
    if (!r) r = hopper::tile_map(&mv, a.v, slabs, a.S, D, C::BK);
    if (r) return r;
    auto kern = flash_tc::flash_fwd_tc_kernel<D, TableWalk>;
    static bool smem_set = false;
    const cudaError_t e = allow_smem(kern, C::smem(), smem_set);
    if (e != cudaSuccess) return int(e);
    kern<<<tc_grid(a, C::BQ), kTcThreads, C::smem(), st>>>(
        mq, mk, mv, static_cast<__nv_bfloat16*>(a.out),
        static_cast<float*>(a.out_lse), walk_of(a), a.scale * flash_tc::kLog2e);
    return int(cudaGetLastError());
}

template <int D>
int dq_tc(const Args& a, cudaStream_t st) {
    using C = flash_tc::DqTc<D>;
    const int slabs = a.B * a.H;
    CUtensorMap mq, mdo, mk, mv;
    int r = hopper::tile_map(&mq, a.q, slabs, a.S, D, C::BQ);
    if (!r) r = hopper::tile_map(&mdo, a.dout, slabs, a.S, D, C::BQ);
    if (!r) r = hopper::tile_map(&mk, a.k, slabs, a.S, D, C::BK);
    if (!r) r = hopper::tile_map(&mv, a.v, slabs, a.S, D, C::BK);
    if (r) return r;
    auto kern = flash_tc::flash_dq_tc_kernel<D, TableWalk>;
    static bool smem_set = false;
    const cudaError_t e = allow_smem(kern, C::smem(), smem_set);
    if (e != cudaSuccess) return int(e);
    kern<<<tc_grid(a, C::BQ), kTcThreads, C::smem(), st>>>(
        mq, mk, mv, mdo, static_cast<const float*>(a.lse),
        static_cast<const float*>(a.delta), static_cast<__nv_bfloat16*>(a.out),
        walk_of(a), a.scale, a.scale * flash_tc::kLog2e);
    return int(cudaGetLastError());
}

template <int D>
int dkv_tc(const Args& a, cudaStream_t st) {
    using C = flash_tc::DkvTc<D>;
    const int slabs = a.B * a.H;
    CUtensorMap mq, mdo, mk, mv;
    int r = hopper::tile_map(&mq, a.q, slabs, a.S, D, C::BQ);
    if (!r) r = hopper::tile_map(&mdo, a.dout, slabs, a.S, D, C::BQ);
    if (!r) r = hopper::tile_map(&mk, a.k, slabs, a.S, D, C::KEYS);
    if (!r) r = hopper::tile_map(&mv, a.v, slabs, a.S, D, C::KEYS);
    if (r) return r;
    auto kern = flash_tc::flash_dkv_tc_kernel<D, TableWalk>;
    static bool smem_set = false;
    const cudaError_t e = allow_smem(kern, C::smem(), smem_set);
    if (e != cudaSuccess) return int(e);
    kern<<<tc_grid(a, C::KEYS), kTcThreads, C::smem(), st>>>(
        mq, mk, mv, mdo, static_cast<const float*>(a.lse),
        static_cast<const float*>(a.delta), static_cast<__nv_bfloat16*>(a.dk),
        static_cast<__nv_bfloat16*>(a.dv), walk_of(a), a.scale,
        a.scale * flash_tc::kLog2e);
    return int(cudaGetLastError());
}

template <int D>
int run_tc(Which w, const Args& a, cudaStream_t st) {
    switch (w) {
        case Which::kFwd:
            return fwd_tc<D>(a, st);
        case Which::kDq:
            return dq_tc<D>(a, st);
        default:
            return dkv_tc<D>(a, st);
    }
}

// the wgmma route: bf16, blocks a multiple of 128. Returns 0, a CUDA error
// code, or 1000 + the CUresult of a tensor map that cannot be made.
int dispatch_tc(Which w, const Args& a, int D, void* stream) {
    if (a.B <= 0 || a.B > 65535 || a.H <= 0 || a.S <= 0 || a.block < 128 ||
        a.block % 128 || a.S % a.block || a.m <= 0 ||
        (long long)a.H * (a.S / 64) > INT32_MAX ||
        (long long)a.B * a.H > INT32_MAX ||
        (D != 64 && D != 128 && D != 256))
        return int(cudaErrorInvalidValue);
    const cudaError_t bound = hopper::bind_context();
    if (bound != cudaSuccess) return int(bound);
    auto st = static_cast<cudaStream_t>(stream);
    if (D == 64) return run_tc<64>(w, a, st);
    if (D == 128) return run_tc<128>(w, a, st);
    return run_tc<256>(w, a, st);
}

}  // namespace

// q, k, v [B, H, S, D] (dtype 0: fp32, 1: bf16), contiguous; tbl_q
// [H, S/block, mk], cnt_q [H, S/block] and order_q [H * S/block] int32 on the
// device. Writes out [B, H, S, D] (q's dtype) and lse [B, H, S] fp32.
// Returns the cudaError_t of the launch (0 = success); the launch is
// asynchronous on `stream`.
extern "C" int ds_block_sparse_attention_fwd(
        const void* q, const void* k, const void* v, void* out, void* lse,
        const void* tbl_q, const void* cnt_q, const void* order_q, int B,
        int H, int S, int D, int block, int mk, float scale, int causal,
        int dtype, void* stream) {
    Args a{q, k, v, nullptr, nullptr, nullptr,
           static_cast<const int*>(tbl_q), static_cast<const int*>(cnt_q),
           static_cast<const int*>(order_q), out, lse, nullptr, nullptr,
           B, H, S, block, mk, scale, causal};
    return dispatch(Which::kFwd, a, D, dtype, stream);
}

// the forward's inputs plus dout [B, H, S, D], lse and delta [B, H, S] fp32;
// writes dq [B, H, S, D].
extern "C" int ds_block_sparse_attention_dq(
        const void* q, const void* k, const void* v, const void* dout,
        const void* lse, const void* delta, const void* tbl_q,
        const void* cnt_q, const void* order_q, void* dq, int B, int H,
        int S, int D, int block, int mk, float scale, int causal, int dtype,
        void* stream) {
    Args a{q, k, v, dout, lse, delta,
           static_cast<const int*>(tbl_q), static_cast<const int*>(cnt_q),
           static_cast<const int*>(order_q), dq, nullptr, nullptr, nullptr,
           B, H, S, block, mk, scale, causal};
    return dispatch(Which::kDq, a, D, dtype, stream);
}

// as the dq entry, over the transposed table tbl_k [H, S/block, mq], cnt_k
// and order_k; writes dk and dv [B, H, S, D].
extern "C" int ds_block_sparse_attention_dkv(
        const void* q, const void* k, const void* v, const void* dout,
        const void* lse, const void* delta, const void* tbl_k,
        const void* cnt_k, const void* order_k, void* dk, void* dv, int B,
        int H, int S, int D, int block, int mq, float scale, int causal,
        int dtype, void* stream) {
    Args a{q, k, v, dout, lse, delta,
           static_cast<const int*>(tbl_k), static_cast<const int*>(cnt_k),
           static_cast<const int*>(order_k), nullptr, nullptr, dk, dv,
           B, H, S, block, mq, scale, causal};
    return dispatch(Which::kDkv, a, D, dtype, stream);
}

// The wgmma route (bf16; block a multiple of 128): the same arguments as the
// entries above without the dtype. Each returns 0, a CUDA error code, or
// 1000 + the CUresult of a tensor map that cannot be made.
extern "C" int ds_block_sparse_attention_fwd_tc(
        const void* q, const void* k, const void* v, void* out, void* lse,
        const void* tbl_q, const void* cnt_q, const void* order_q, int B,
        int H, int S, int D, int block, int mk, float scale, int causal,
        void* stream) {
    Args a{q, k, v, nullptr, nullptr, nullptr,
           static_cast<const int*>(tbl_q), static_cast<const int*>(cnt_q),
           static_cast<const int*>(order_q), out, lse, nullptr, nullptr,
           B, H, S, block, mk, scale, causal};
    return dispatch_tc(Which::kFwd, a, D, stream);
}

extern "C" int ds_block_sparse_attention_dq_tc(
        const void* q, const void* k, const void* v, const void* dout,
        const void* lse, const void* delta, const void* tbl_q,
        const void* cnt_q, const void* order_q, void* dq, int B, int H,
        int S, int D, int block, int mk, float scale, int causal,
        void* stream) {
    Args a{q, k, v, dout, lse, delta,
           static_cast<const int*>(tbl_q), static_cast<const int*>(cnt_q),
           static_cast<const int*>(order_q), dq, nullptr, nullptr, nullptr,
           B, H, S, block, mk, scale, causal};
    return dispatch_tc(Which::kDq, a, D, stream);
}

extern "C" int ds_block_sparse_attention_dkv_tc(
        const void* q, const void* k, const void* v, const void* dout,
        const void* lse, const void* delta, const void* tbl_k,
        const void* cnt_k, const void* order_k, void* dk, void* dv, int B,
        int H, int S, int D, int block, int mq, float scale, int causal,
        void* stream) {
    Args a{q, k, v, dout, lse, delta,
           static_cast<const int*>(tbl_k), static_cast<const int*>(cnt_k),
           static_cast<const int*>(order_k), nullptr, nullptr, dk, dv,
           B, H, S, block, mq, scale, causal};
    return dispatch_tc(Which::kDkv, a, D, stream);
}
