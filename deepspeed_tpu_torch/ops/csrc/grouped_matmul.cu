// Grouped (per-expert) matrix product over expert-sorted tokens (K5):
// the forward, and the backward's two products.
//
// Replaces the TPU kernels of deepspeed_tpu/ops/pallas/grouped_matmul.py:
// `_gmm_kernel` with `transpose_rhs=False` (the forward of
// `grouped_matmul`, the dropless MoE route's expert products) and with
// `transpose_rhs=True` (dx in `_gmm_bwd`), and `_dw_kernel` (dw, the
// per-expert weight gradient).
//
// What they compute. x [Tp, K] holds the routed tokens sorted by expert,
// each expert's segment padded to a multiple of block_m, so row tile t
// (block_m rows) belongs to expert e = tile_expert[t]; tile_rows[t] counts
// the routed rows at the start of tile t, the rest is padding. fp32
// accumulation everywhere; outputs in the inputs' dtype (fp32 or bf16).
//   forward: out[Tp, N] = x_tile @ W[e] (W [n, K, N]);
//   dx:      dx[Tp, K] = dy_tile @ W[e]^T (W [n, K, N] read transposed, no
//            copy);
//   dw:      dw[e][K, N] = sum over the tiles of e of x_tile^T @ dy_tile,
//            zero for an expert that owns no tile.
// Rows past tile_rows are padding: the forward and dx write them as zeros
// whatever they hold; dw never adds them in.
//
// What bounds them on an H100: at decode (a few routed rows per expert)
// the bytes of the weight slabs of the experts that own a routed row, 2
// bytes a weight in bf16. At training and prefill (hundreds of rows per
// expert) the bytes still lead at qwen2-moe's widths (each expert's 5.8 MB
// weight slab against ~270 routed rows: about 0.14 ms of bytes against
// 0.10 ms of bf16 operations for a train micro-batch), then the operations:
// 2 * routed rows * K * N over the tensor cores' bf16 rate (989 TFLOP/s),
// or the CUDA cores' fp32 rate (67). dw also writes every expert's [K, N].
//
// Three routes, chosen by the caller from dtype and block_m
// (`gmm_route` in grouped_matmul.py):
// - bf16, block_m a multiple of 64 (the engine's and the train path's 128):
//   warpgroup matrix products (wgmma) on tiles that TMA brings into shared
//   memory with 128-byte swizzle (hopper.cuh).
//   * Forward and dx (`gmm_tc_kernel<TRANS, WGS>`): a block owns 64 x WGS
//     rows of one tile and 128 output columns. WGS = 2 when block_m is a
//     multiple of 128 and the experts average more than 64 routed rows,
//     else 1 (at decode a second warpgroup would idle, and the smaller
//     block lets three share an SM, so the active blocks fit one wave). A
//     producer warp keeps a 3-stage ring of TMA loads in flight behind
//     full / empty mbarriers; each consumer warpgroup runs m64n128k16 on
//     its 64 rows with the sums in registers. x (dy) is the K-major A
//     operand; W[e] is the MN-major B operand in the forward (lines of k,
//     the transpose bit set) and the K-major B operand in dx (W[e]'s own
//     rows are dx's output columns), so one tensor map over W [n, K, N]
//     serves both without a copy. The block reads its tile's expert and
//     routed rows itself: a tile with none writes zeros and stops; a
//     warpgroup whose 64 rows hold none skips its products; the producer
//     loads only the routed rows of x, in 8-row boxes for a partial
//     warpgroup (at decode one routed row costs 1 KB a stage beside the
//     weight's 16 KB). Blocks run in groups of 8 row blocks, each group
//     sweeping its column blocks one by one over its row blocks, so an
//     expert's row tiles read each column block of its weight slab one
//     after another: from HBM about once, whatever N is. The epilogue
//     zeroes rows past tile_rows (a select: garbage or NaN in padding rows
//     never reaches a result), writes bf16 into the warpgroup's own lines
//     of two drained stages and stores them with TMA (which clips the
//     columns past N). 99 KB of shared memory and a producer warp (not a
//     warpgroup: no register hand-over, 112 registers a thread) let two
//     blocks share an SM, so one block's prologue and epilogue hide under
//     the other's products.
//   * dw (`gmm_dw_tc_kernel`): a persistent grid of one block an SM walks
//     work items, an item being a 128 (K) x 256 (N) tile of one expert's
//     dw, expert-major, so the ~132 items in flight share one or two
//     experts' x and dy rows in L2. Per item the block contracts over the
//     expert's routed rows in 64-row stages (two binary searches over
//     tile_expert, which does not decrease, find its tiles): A = x^T is
//     the MN-major A operand (wgmma's transpose-A bit), B = dy the MN-major
//     B operand, m64n256k16 per consumer warpgroup. A stage that holds
//     padding rows (an expert's last, partial tile) has those whole lines
//     zeroed in both staged tiles before its products (the swizzle only
//     permutes chunks within a line), so NaN there adds nothing. Each
//     warpgroup's item ends in its own epilogue buffer and a TMA store that
//     overlaps the next item's loads and products. No atomics: every dw
//     element is one block's fixed-order sum, identical launch to launch;
//     an expert with no routed row gets zeros (the `has` mask).
// - bf16 with block_m 32 or 96 (a 64-row warpgroup would straddle two
//   experts): tensor cores through WMMA 16x16x16. The forward and dx block
//   owns 32 rows x 64 columns, four warps of 16x32, with the next 64-deep
//   step's 16-byte loads in flight; the dw block one 32x64 tile of one
//   expert's [K, N], walking that expert's tiles itself.
// - fp32, the parity route: the same blocks on the CUDA cores (each thread
//   a 4x4 sub-tile; TF32 would round x and W).
// All offsets are 64-bit.
//
// Built with `nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC` into a plain C library (deepspeed_tpu_torch/ops/kernels.py)
// and called through ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr int kRows = 32;                 // output rows per block
constexpr int kCols = 64;                 // output columns per block
constexpr int kThreads = 128;             // 4 warps

// the block's expert and how many of its kRows rows hold routed tokens
// (0 when it has none, or when its tile's expert is out of range)
struct RowTile {
    int expert;
    int rows;
};

__device__ __forceinline__ RowTile row_tile(const int* __restrict__ te,
                                            const int* __restrict__ tr,
                                            int row0, int block_m, int n) {
    const int t = row0 / block_m;
    const int e = te[t];
    int v = tr[t] - (row0 - t * block_m);
    v = v < 0 ? 0 : (v > kRows ? kRows : v);
    if (e < 0 || e >= n) v = 0;
    return {e, v};
}

template <typename T>
__device__ __forceinline__ void zero_tile(T* __restrict__ out, int row0,
                                          int v, int n0, int N, int tid) {
    for (int i = tid; i < kRows * kCols; i += kThreads) {
        const int r = i / kCols, c = n0 + i % kCols;
        if (r >= v && c < N) out[size_t(row0 + r) * N + c] = T(0.f);
    }
}

// routed rows of tile t (tile_rows clamped to [0, block_m])
__device__ __forceinline__ int routed_rows(const int* __restrict__ tr, int t,
                                           int block_m) {
    const int v = tr[t];
    return v < 0 ? 0 : (v > block_m ? block_m : v);
}

// the first tile whose expert is >= e (tile_expert does not decrease)
__device__ __forceinline__ int first_tile(const int* __restrict__ te,
                                          int tiles, int e) {
    int lo = 0, hi = tiles;
    while (lo < hi) {
        const int mid = (lo + hi) / 2;
        if (te[mid] < e) lo = mid + 1; else hi = mid;
    }
    return lo;
}

// dw's walk over one expert's token tiles [t, t_end) in chunks of `step`
// rows, skipping tiles with no routed row
struct RowWalk {
    int t, r0, t_end, block_m, step;
    const int* tr;

    __device__ __forceinline__ void skip_empty() {
        while (t < t_end && routed_rows(tr, t, block_m) == 0) ++t;
    }
    __device__ __forceinline__ bool done() const { return t >= t_end; }
    // first row of the chunk in x / dy, and how many of its rows are routed
    __device__ __forceinline__ size_t row() const {
        return size_t(t) * block_m + r0;
    }
    __device__ __forceinline__ int valid() const {
        const int v = routed_rows(tr, t, block_m) - r0;
        return v < step ? v : step;
    }
    __device__ __forceinline__ void next() {
        r0 += step;
        if (r0 >= routed_rows(tr, t, block_m)) {
            ++t;
            r0 = 0;
            skip_empty();
        }
    }
};

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------
constexpr int kBK = 64;                   // contraction per step
constexpr int kALd = kBK + 8;             // bf16 strides: multiples of 8
constexpr int kBLd = kCols + 8;           // (= kBK + 8: either staging)
constexpr int kCLd = kCols + 4;           // fp32 epilogue stride
constexpr int kXLd = kRows + 8;           // dw: x chunk [64 rows][32 k]

// one step's raw inputs of one thread: 2 x 8 bf16 of the left operand, 4 x
// 8 bf16 of the right one
struct Regs {
    uint4 a[2];
    uint4 b[4];
};

// x rows [row0, row0 + v) x k in [k0, k0 + 64), and a 64 x 64 tile of W[e]
// for output columns n0..: staged [k][column] from W [K, N] (TRANS false)
// or [column][k] from W [N, K] (TRANS true)
template <bool TRANS>
__device__ __forceinline__ void load_step(
        Regs& r, const __nv_bfloat16* __restrict__ x,
        const __nv_bfloat16* __restrict__ w, int K, int N, int row0, int v,
        int n0, int k0, int tid) {
    const uint4 z = make_uint4(0, 0, 0, 0);
#pragma unroll
    for (int i = 0; i < 2; ++i) {                 // x: 32 rows x 64 k
        const int q = tid + i * kThreads;
        const int m = q / 8, k = k0 + (q % 8) * 8;
        r.a[i] = (m < v && k < K)
            ? *reinterpret_cast<const uint4*>(x + size_t(row0 + m) * K + k)
            : z;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {                 // W: 64 k x 64 columns
        const int q = tid + i * kThreads;
        if (TRANS) {
            const int c = n0 + q / 8, k = k0 + (q % 8) * 8;
            r.b[i] = (k < K && c < N)
                ? *reinterpret_cast<const uint4*>(w + size_t(c) * K + k)
                : z;
        } else {
            const int k = k0 + q / 8, c = n0 + (q % 8) * 8;
            r.b[i] = (k < K && c < N)
                ? *reinterpret_cast<const uint4*>(w + size_t(k) * N + c)
                : z;
        }
    }
}

// both stagings use the same [64][72] layout: (q / 8, (q % 8) * 8)
__device__ __forceinline__ void store_step(const Regs& r, __nv_bfloat16* as,
                                           __nv_bfloat16* bs, int tid) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const int q = tid + i * kThreads;
        *reinterpret_cast<uint4*>(as + (q / 8) * kALd + (q % 8) * 8) = r.a[i];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int q = tid + i * kThreads;
        *reinterpret_cast<uint4*>(bs + (q / 8) * kBLd + (q % 8) * 8) = r.b[i];
    }
}

// out[Tp, N] = x[Tp, K] @ B[e], B = W[e] [K, N] (TRANS false: the forward)
// or W[e]^T with W[e] [N, K] (TRANS true: dx). grid (ceil(N / 64), Tp /
// 32); warp (wm, wn) = (warp / 2, warp % 2) owns rows wm*16.. and columns
// wn*32.. of the block's 32x64 tile
template <bool TRANS>
__global__ void __launch_bounds__(kThreads)
gmm_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                const __nv_bfloat16* __restrict__ w,
                const int* __restrict__ te, const int* __restrict__ tr,
                __nv_bfloat16* __restrict__ out, int K, int N, int n,
                int block_m) {
    using namespace nvcuda;
    using BLayout = typename std::conditional<TRANS, wmma::col_major,
                                              wmma::row_major>::type;
    __shared__ __align__(32) __nv_bfloat16 as[kRows * kALd];
    __shared__ __align__(32) __nv_bfloat16 bs[kBK * kBLd];
    __shared__ __align__(32) float cs[kRows * kCLd];
    const int tid = threadIdx.x, warp = tid / 32;
    const int wm = warp / 2, wn = warp % 2;
    const int row0 = blockIdx.y * kRows, n0 = blockIdx.x * kCols;
    const RowTile rt = row_tile(te, tr, row0, block_m, n);
    if (rt.rows == 0) {
        zero_tile(out, row0, 0, n0, N, tid);
        return;
    }
    const __nv_bfloat16* we = w + size_t(rt.expert) * K * N;

    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[j], 0.f);

    Regs r;
    load_step<TRANS>(r, x, we, K, N, row0, rt.rows, n0, 0, tid);
    for (int k0 = 0; k0 < K; k0 += kBK) {
        store_step(r, as, bs, tid);
        __syncthreads();
        if (k0 + kBK < K)                 // in flight during the products
            load_step<TRANS>(r, x, we, K, N, row0, rt.rows, n0, k0 + kBK,
                             tid);
#pragma unroll
        for (int kk = 0; kk < kBK; kk += 16) {
            wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                           wmma::row_major> a;
            wmma::load_matrix_sync(a, as + (wm * 16) * kALd + kk, kALd);
#pragma unroll
            for (int j = 0; j < 2; ++j) {
                const int c = wn * 32 + j * 16;
                wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                               BLayout> b;
                // [k][column] row_major, or [column][k] read col_major
                wmma::load_matrix_sync(
                    b, TRANS ? bs + c * kBLd + kk : bs + kk * kBLd + c, kBLd);
                wmma::mma_sync(acc[j], a, b, acc[j]);
            }
        }
        __syncthreads();
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
        wmma::store_matrix_sync(cs + (wm * 16) * kCLd + wn * 32 + j * 16,
                                acc[j], kCLd, wmma::mem_row_major);
    __syncthreads();
    for (int i = tid; i < kRows * kCols; i += kThreads) {
        const int m = i / kCols, c = n0 + i % kCols;
        if (c < N)
            out[size_t(row0 + m) * N + c] = __float2bfloat16(
                m < rt.rows ? cs[m * kCLd + i % kCols] : 0.f);
    }
}

// dw's step: x rows [row, row + v) x k in [k0, k0 + 32) and dy rows
// [row, row + v) x columns [n0, n0 + 64); rows past v are zero
__device__ __forceinline__ void load_dw_step(
        Regs& r, const __nv_bfloat16* __restrict__ x,
        const __nv_bfloat16* __restrict__ dy, int K, int N, size_t row, int v,
        int k0, int n0, int tid) {
    const uint4 z = make_uint4(0, 0, 0, 0);
#pragma unroll
    for (int i = 0; i < 2; ++i) {                 // x: 64 rows x 32 k
        const int q = tid + i * kThreads;
        const int m = q / 4, k = k0 + (q % 4) * 8;
        r.a[i] = (m < v && k < K)
            ? *reinterpret_cast<const uint4*>(x + (row + m) * K + k)
            : z;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {                 // dy: 64 rows x 64 columns
        const int q = tid + i * kThreads;
        const int m = q / 8, c = n0 + (q % 8) * 8;
        r.b[i] = (m < v && c < N)
            ? *reinterpret_cast<const uint4*>(dy + (row + m) * N + c)
            : z;
    }
}

__device__ __forceinline__ void store_dw_step(const Regs& r,
                                              __nv_bfloat16* xs,
                                              __nv_bfloat16* ys, int tid) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const int q = tid + i * kThreads;
        *reinterpret_cast<uint4*>(xs + (q / 4) * kXLd + (q % 4) * 8) = r.a[i];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int q = tid + i * kThreads;
        *reinterpret_cast<uint4*>(ys + (q / 8) * kBLd + (q % 8) * 8) = r.b[i];
    }
}

// dw[e][k0.., n0..] over expert e = blockIdx.z's tiles. grid (ceil(N / 64),
// ceil(K / 32), n); warp (wm, wn) owns k rows wm*16.. and columns wn*32..
__global__ void __launch_bounds__(kThreads)
gmm_dw_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                   const __nv_bfloat16* __restrict__ dy,
                   const int* __restrict__ te, const int* __restrict__ tr,
                   __nv_bfloat16* __restrict__ dw, int K, int N, int tiles,
                   int block_m) {
    using namespace nvcuda;
    __shared__ __align__(32) __nv_bfloat16 xs[kBK * kXLd];
    __shared__ __align__(32) __nv_bfloat16 ys[kBK * kBLd];
    __shared__ __align__(32) float cs[kRows * kCLd];
    const int tid = threadIdx.x, warp = tid / 32;
    const int wm = warp / 2, wn = warp % 2;
    const int e = blockIdx.z;
    const int k0 = blockIdx.y * kRows, n0 = blockIdx.x * kCols;

    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[j], 0.f);

    RowWalk walk{first_tile(te, tiles, e), 0, first_tile(te, tiles, e + 1),
                 block_m, kBK, tr};
    walk.skip_empty();
    Regs r;
    if (!walk.done())
        load_dw_step(r, x, dy, K, N, walk.row(), walk.valid(), k0, n0, tid);
    while (!walk.done()) {
        store_dw_step(r, xs, ys, tid);
        __syncthreads();
        walk.next();
        if (!walk.done())                 // in flight during the products
            load_dw_step(r, x, dy, K, N, walk.row(), walk.valid(), k0, n0,
                         tid);
#pragma unroll
        for (int kk = 0; kk < kBK; kk += 16) {
            // x_chunk^T: element (k, row) at xs[row][k], a col_major read
            wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                           wmma::col_major> a;
            wmma::load_matrix_sync(a, xs + kk * kXLd + wm * 16, kXLd);
#pragma unroll
            for (int j = 0; j < 2; ++j) {
                wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                               wmma::row_major> b;
                wmma::load_matrix_sync(b, ys + kk * kBLd + wn * 32 + j * 16,
                                       kBLd);
                wmma::mma_sync(acc[j], a, b, acc[j]);
            }
        }
        __syncthreads();
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
        wmma::store_matrix_sync(cs + (wm * 16) * kCLd + wn * 32 + j * 16,
                                acc[j], kCLd, wmma::mem_row_major);
    __syncthreads();
    __nv_bfloat16* de = dw + size_t(e) * K * N;
    for (int i = tid; i < kRows * kCols; i += kThreads) {
        const int m = k0 + i / kCols, c = n0 + i % kCols;
        if (m < K && c < N)
            de[size_t(m) * N + c] = __float2bfloat16(
                cs[(i / kCols) * kCLd + i % kCols]);
    }
}

// ---------------------------------------------------------------------------
// fp32: CUDA cores
// ---------------------------------------------------------------------------
constexpr int kFK = 32;                   // contraction per step
constexpr int kPad = 4;                   // keeps float4 rows 16-byte aligned

// forward (TRANS false) and dx (TRANS true), as the bf16 kernel; grid
// (ceil(N / 64), Tp / 32); thread (tx, ty) = (tid % 16, tid / 16)
// accumulates rows ty*4.. and columns tx*4.. of the block's tile
template <bool TRANS>
__global__ void __launch_bounds__(kThreads)
gmm_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
               const int* __restrict__ te, const int* __restrict__ tr,
               float* __restrict__ out, int K, int N, int n, int block_m) {
    __shared__ __align__(16) float xs[kFK][kRows + kPad];   // K-major
    __shared__ __align__(16) float ws[kFK][kCols + kPad];
    const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
    const int row0 = blockIdx.y * kRows, n0 = blockIdx.x * kCols;
    const RowTile rt = row_tile(te, tr, row0, block_m, n);
    if (rt.rows == 0) {
        zero_tile(out, row0, 0, n0, N, tid);
        return;
    }
    const float* we = w + size_t(rt.expert) * K * N;
    const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);

    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

    float4 ra[2], rb[4];
    auto load = [&](int k0) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {             // x: 32 rows x 32 k
            const int q = tid + i * kThreads;
            const int m = q / 8, k = k0 + (q % 8) * 4;
            ra[i] = (m < rt.rows && k < K)
                ? *reinterpret_cast<const float4*>(x + size_t(row0 + m) * K +
                                                   k)
                : z;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {             // W: 32 k x 64 columns
            const int q = tid + i * kThreads;
            if (TRANS) {                          // 4 k of one column
                const int c = n0 + q / 8, k = k0 + (q % 8) * 4;
                rb[i] = (k < K && c < N)
                    ? *reinterpret_cast<const float4*>(we + size_t(c) * K + k)
                    : z;
            } else {                              // 4 columns of one k
                const int k = k0 + q / 16, c = n0 + (q % 16) * 4;
                rb[i] = (k < K && c < N)
                    ? *reinterpret_cast<const float4*>(we + size_t(k) * N + c)
                    : z;
            }
        }
    };
    load(0);
    for (int k0 = 0; k0 < K; k0 += kFK) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            const int q = tid + i * kThreads;
            const int m = q / 8, kk = (q % 8) * 4;
            xs[kk][m] = ra[i].x;
            xs[kk + 1][m] = ra[i].y;
            xs[kk + 2][m] = ra[i].z;
            xs[kk + 3][m] = ra[i].w;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int q = tid + i * kThreads;
            if (TRANS) {
                const int c = q / 8, kk = (q % 8) * 4;
                ws[kk][c] = rb[i].x;
                ws[kk + 1][c] = rb[i].y;
                ws[kk + 2][c] = rb[i].z;
                ws[kk + 3][c] = rb[i].w;
            } else {
                *reinterpret_cast<float4*>(&ws[q / 16][(q % 16) * 4]) = rb[i];
            }
        }
        __syncthreads();
        if (k0 + kFK < K) load(k0 + kFK);
#pragma unroll 8
        for (int kk = 0; kk < kFK; ++kk) {
            const float4 a = *reinterpret_cast<const float4*>(&xs[kk][ty * 4]);
            const float4 b = *reinterpret_cast<const float4*>(&ws[kk][tx * 4]);
            const float av[4] = {a.x, a.y, a.z, a.w};
            const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j)
                    acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
        }
        __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int m = ty * 4 + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int c = n0 + tx * 4 + j;
            if (c < N)
                out[size_t(row0 + m) * N + c] = m < rt.rows ? acc[i][j] : 0.f;
        }
    }
}

// dw in fp32: grid (ceil(N / 64), ceil(K / 32), n); thread (tx, ty)
// accumulates k rows ty*4.. and columns tx*4.. of the block's 32x64 tile of
// expert blockIdx.z, 32 routed rows a step
__global__ void __launch_bounds__(kThreads)
gmm_dw_f32_kernel(const float* __restrict__ x, const float* __restrict__ dy,
                  const int* __restrict__ te, const int* __restrict__ tr,
                  float* __restrict__ dw, int K, int N, int tiles,
                  int block_m) {
    __shared__ __align__(16) float xs[kFK][kRows + kPad];   // [row][k]
    __shared__ __align__(16) float ys[kFK][kCols + kPad];   // [row][column]
    const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
    const int e = blockIdx.z;
    const int k0 = blockIdx.y * kRows, n0 = blockIdx.x * kCols;
    const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);

    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

    float4 ra[2], rb[4];
    auto load = [&](size_t row, int v) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {             // x: 32 rows x 32 k
            const int q = tid + i * kThreads;
            const int m = q / 8, k = k0 + (q % 8) * 4;
            ra[i] = (m < v && k < K)
                ? *reinterpret_cast<const float4*>(x + (row + m) * K + k)
                : z;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {             // dy: 32 rows x 64 columns
            const int q = tid + i * kThreads;
            const int m = q / 16, c = n0 + (q % 16) * 4;
            rb[i] = (m < v && c < N)
                ? *reinterpret_cast<const float4*>(dy + (row + m) * N + c)
                : z;
        }
    };
    RowWalk walk{first_tile(te, tiles, e), 0, first_tile(te, tiles, e + 1),
                 block_m, kFK, tr};
    walk.skip_empty();
    if (!walk.done()) load(walk.row(), walk.valid());
    while (!walk.done()) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            const int q = tid + i * kThreads;
            *reinterpret_cast<float4*>(&xs[q / 8][(q % 8) * 4]) = ra[i];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int q = tid + i * kThreads;
            *reinterpret_cast<float4*>(&ys[q / 16][(q % 16) * 4]) = rb[i];
        }
        __syncthreads();
        walk.next();
        if (!walk.done()) load(walk.row(), walk.valid());
#pragma unroll 8
        for (int rr = 0; rr < kFK; ++rr) {
            const float4 a = *reinterpret_cast<const float4*>(&xs[rr][ty * 4]);
            const float4 b = *reinterpret_cast<const float4*>(&ys[rr][tx * 4]);
            const float av[4] = {a.x, a.y, a.z, a.w};
            const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j)
                    acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
        }
        __syncthreads();
    }
    float* de = dw + size_t(e) * K * N;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int m = k0 + ty * 4 + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int c = n0 + tx * 4 + j;
            if (m < K && c < N) de[size_t(m) * N + c] = acc[i][j];
        }
    }
}

// ---------------------------------------------------------------------------
// bf16 with block_m a multiple of 64: wgmma fed by TMA
// ---------------------------------------------------------------------------
using bf16 = __nv_bfloat16;
using namespace hopper;

constexpr int kTcCols = 128;          // forward / dx: output columns a block
constexpr int kTcDepth = 64;          // contraction a stage: one 128-B line
constexpr int kTcStages = 3;
constexpr int kRasterTiles = 8;       // row blocks a column sweep covers
constexpr int kBoxRows = 8;           // rows of a partial warpgroup's x box
constexpr int kLine = 128;            // bytes of a swizzled line
constexpr int kColBlock = 64 * kLine; // 64 lines of one 64-column block
constexpr int kProducerRegs = 24;     // dw: the producer warpgroup's
constexpr int kDwConsumerRegs = 240;  // and the consumers' (setmaxnreg)

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
    return reinterpret_cast<uint8_t*>(
        (reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

// the forward's and dx's block: WGS consumer warpgroups of 64 rows and a
// producer warp. Without a producer warpgroup there is no register
// hand-over: two blocks of 288 threads (three of 160) an SM leave 112
// (136) registers a thread, room for the 64 accumulators.
template <int WGS>
struct GmmTc {
    static constexpr int BM = 64 * WGS;
    static constexpr int THREADS = 128 * WGS + 32;
    static constexpr int MIN_BLOCKS = WGS == 2 ? 2 : 3;
    static constexpr int A_BYTES = BM * kLine;            // x: BM lines
    static constexpr int B_BYTES = kTcDepth * kTcCols * 2;
    static constexpr int STAGE = A_BYTES + B_BYTES;
    static constexpr size_t smem() {
        return 1024 + kTcStages * STAGE + 8 * 2 * kTcStages;
    }
};

// the byte offset of the 16-byte chunk holding columns 8 c .. 8 c + 7 of
// line r in a 128-byte-swizzled column block
__device__ __forceinline__ int swz(int r, int c) {
    return r * kLine + ((c ^ r) & 7) * 16;
}

// zeros over rows [row0, row0 + rows) x columns [n0, n0 + kTcCols) of
// out [*, N]
__device__ __forceinline__ void zero_block(bf16* __restrict__ out,
                                           size_t row0, int rows, int n0,
                                           int N, int tid, int threads) {
    constexpr int kPerRow = kTcCols / 8;
    for (int i = tid; i < rows * kPerRow; i += threads) {
        const int c = n0 + (i % kPerRow) * 8;
        if (c < N)
            *reinterpret_cast<uint4*>(out + (row0 + i / kPerRow) * N + c) =
                make_uint4(0, 0, 0, 0);
    }
}

// out[Tp, Nout] = x[Tp, Kc] @ B[e]: the forward (TRANS false: B = W[e]
// [K, N], MN-major tiles of 64 k-lines x 128 columns) or dx (TRANS true:
// x = dy, B = W[e]^T, K-major tiles of 128 W rows x 64 contraction
// columns). A 1-D grid of ceil(Nout / 128) x Tp / BM blocks in groups of
// kRasterTiles row blocks: a group sweeps its column blocks one by one,
// each over the group's row blocks, so the row tiles of one expert read a
// column block of W[e] one after another (from L2 after the first) and the
// group's x rows stay in L2 through the sweep. Maps: tx / tx8 over x as
// [1, Tp, Kc] in boxes of 64 / 8 rows, tw over W [n, K, N] (boxes of 64
// lines forward, 128 rows dx), tout over out [1, Tp, Nout] in 64-row boxes.
template <bool TRANS, int WGS>
__global__ void __launch_bounds__(GmmTc<WGS>::THREADS, GmmTc<WGS>::MIN_BLOCKS)
gmm_tc_kernel(const __grid_constant__ CUtensorMap tx,
              const __grid_constant__ CUtensorMap tx8,
              const __grid_constant__ CUtensorMap tw,
              const __grid_constant__ CUtensorMap tout,
              const int* __restrict__ te, const int* __restrict__ tr,
              bf16* __restrict__ out, int Kc, int Nout, int n, int block_m,
              int row_blocks) {
    using C = GmmTc<WGS>;
    extern __shared__ uint8_t smem_raw[];
    uint8_t* ring = align1024(smem_raw);
    uint64_t* full = reinterpret_cast<uint64_t*>(ring + kTcStages * C::STAGE);
    uint64_t* empty = full + kTcStages;

    const int tid = threadIdx.x;
    const int ncb = (Nout + kTcCols - 1) / kTcCols;
    const int per_group = kRasterTiles * ncb;
    const int group = blockIdx.x / per_group, within = blockIdx.x % per_group;
    const int rows_in = min(kRasterTiles, row_blocks - group * kRasterTiles);
    const int n0 = within / rows_in * kTcCols;
    const int row0 = (group * kRasterTiles + within % rows_in) * C::BM;
    const int t = row0 / block_m;
    const int e = te[t];
    int v = tr[t] - (row0 - t * block_m);
    v = v < 0 ? 0 : (v > C::BM ? C::BM : v);
    if (e < 0 || e >= n) v = 0;
    // the warpgroups whose rows hold a routed row, warp-uniform as the
    // compiler sees it: wgmma under a condition it cannot prove uniform is
    // serialized
    const int active = __shfl_sync(0xffffffffu, (v + 63) / 64, 0);
    if (active == 0) {
        zero_block(out, row0, C::BM, n0, Nout, tid, C::THREADS);
        return;
    }
    if (tid == 0) {
        for (int s = 0; s < kTcStages; ++s) {
            bar_init(&full[s], 1);
            bar_init(&empty[s], 4 * active);
        }
        bar_init_fence();
    }
    __syncthreads();

    const int nk = (Kc + kTcDepth - 1) / kTcDepth;
    const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
    if (wg == WGS) {                       // the producer warp
        if (tid == WGS * 128) {
            // only the routed rows of x: a whole box for a full warpgroup,
            // 8-row boxes for a partial one
            uint32_t bytes = C::B_BYTES;
            for (int g = 0; g < WGS; ++g) {
                const int rows = min(max(v - 64 * g, 0), 64);
                bytes += rows == 64 ? kColBlock
                                    : (rows + kBoxRows - 1) / kBoxRows *
                                          kBoxRows * kLine;
            }
            for (int j = 0; j < nk; ++j) {
                const int s = j % kTcStages;
                bar_wait(&empty[s], ((j / kTcStages) & 1) ^ 1);
                bar_arrive_tx(&full[s], bytes);
                uint8_t* a = ring + s * C::STAGE;
                uint8_t* b = a + C::A_BYTES;
                const int k0 = j * kTcDepth;
                for (int g = 0; g < WGS; ++g) {
                    const int rows = min(max(v - 64 * g, 0), 64);
                    if (rows == 64)
                        tma_load_3d(a + g * kColBlock, &tx, &full[s], k0,
                                    row0 + 64 * g, 0);
                    else
                        for (int r = 0; r < rows; r += kBoxRows)
                            tma_load_3d(a + g * kColBlock + r * kLine, &tx8,
                                        &full[s], k0, row0 + 64 * g + r, 0);
                }
                if (TRANS) {
                    tma_load_3d(b, &tw, &full[s], k0, n0, e);
                } else {
                    tma_load_3d(b, &tw, &full[s], n0, k0, e);
                    tma_load_3d(b + kColBlock, &tw, &full[s], n0 + 64, k0, e);
                }
            }
        }
        return;
    }

    const int warp = (tid % 128) / 32, lane = tid % 32;
    float acc[kTcCols / 2];
#pragma unroll
    for (int i = 0; i < kTcCols / 2; ++i) acc[i] = 0.f;
    if (wg < active) {
        for (int j = 0; j < nk; ++j) {
            const int s = j % kTcStages;
            bar_wait(&full[s], (j / kTcStages) & 1);
            const uint32_t a = smem_u32(ring + s * C::STAGE);
            const uint32_t b = a + C::A_BYTES;
            wgmma_fence();
#pragma unroll
            for (int k = 0; k < kTcDepth / 16; ++k) {
                if (TRANS)
                    wgmma_ss_t<kTcCols, 0, 0>(acc, desc_k(a, C::BM, 64 * wg, k),
                                              desc_k(b, kTcCols, 0, k), 1);
                else
                    wgmma_ss_t<kTcCols, 0, 1>(acc, desc_k(a, C::BM, 64 * wg, k),
                                              desc_mn(b, kTcDepth, 0, k), 1);
            }
            wgmma_commit();
            wgmma_wait<1>();               // the previous stage's products
            if (j > 0 && lane == 0) bar_arrive(&empty[(j - 1) % kTcStages]);
        }
        wgmma_wait<0>();
        reg_fence(acc);
    }

    // epilogue: every load of the block has landed and been read, so this
    // warpgroup's lines of stages 0 and 1 hold its two 64-column blocks
    const int r = 16 * warp + lane / 4;            // and r + 8
    const bool ok0 = 64 * wg + r < v, ok1 = 64 * wg + r + 8 < v;
#pragma unroll
    for (int c = 0; c < kTcCols / 8; ++c) {
        uint8_t* buf = ring + (c / 8) * C::STAGE + wg * kColBlock;
        const int off = swz(r, c) + (lane % 4) * 4;
        *reinterpret_cast<uint32_t*>(buf + off) =
            pack_bf16(ok0 ? acc[4 * c] : 0.f, ok0 ? acc[4 * c + 1] : 0.f);
        *reinterpret_cast<uint32_t*>(buf + off + 8 * kLine) =
            pack_bf16(ok1 ? acc[4 * c + 2] : 0.f, ok1 ? acc[4 * c + 3] : 0.f);
    }
    fence_proxy_async();
    named_bar_sync(1 + wg, 128);
    if (tid % 128 == 0) {
        for (int c = 0; c < kTcCols / 64; ++c)
            if (n0 + 64 * c < Nout)
                tma_store_3d(&tout, ring + c * C::STAGE + wg * kColBlock,
                             n0 + 64 * c, row0 + 64 * wg, 0);
        tma_store_commit();
        tma_store_wait_read<0>();
    }
}

// dw's persistent block: two consumer warpgroups (64 dw rows each) and a
// producer warpgroup
struct DwTc {
    static constexpr int BK = 128;                // dw rows (of K) an item
    static constexpr int BN = 256;                // dw columns (of N) an item
    static constexpr int ROWS = 64;               // routed rows a stage
    static constexpr int X_BYTES = ROWS * BK * 2; // 2 column blocks
    static constexpr int Y_BYTES = ROWS * BN * 2; // 4 column blocks
    static constexpr int STAGE = X_BYTES + Y_BYTES;
    static constexpr int EPI = 64 * BN * 2;       // a warpgroup's output
    static constexpr size_t smem() {
        return 1024 + kTcStages * STAGE + 2 * EPI + 8 * 2 * kTcStages;
    }
    static constexpr int REGS = 128 * kProducerRegs + 256 * kDwConsumerRegs;
};

// dw[e] = sum over e's routed rows of x^T dy, items i = blockIdx.x,
// blockIdx.x + gridDim.x, ..., item i = (expert, 128-row block of K,
// 256-column block of N) expert-major. Maps: tx over x [1, Tp, K], ty over
// dy [1, Tp, N], tdw over dw [n, K, N], all in 64-row boxes.
__global__ void __launch_bounds__(384, 1)
gmm_dw_tc_kernel(const __grid_constant__ CUtensorMap tx,
                 const __grid_constant__ CUtensorMap ty,
                 const __grid_constant__ CUtensorMap tdw,
                 const int* __restrict__ te, const int* __restrict__ tr,
                 int K, int N, int n, int tiles, int block_m) {
    using C = DwTc;
    extern __shared__ uint8_t smem_raw[];
    uint8_t* ring = align1024(smem_raw);
    uint8_t* epi = ring + kTcStages * C::STAGE;
    uint64_t* full = reinterpret_cast<uint64_t*>(epi + 2 * C::EPI);
    uint64_t* empty = full + kTcStages;

    const int tid = threadIdx.x;
    const int kb = (K + C::BK - 1) / C::BK, nb = (N + C::BN - 1) / C::BN;
    const int per_e = kb * nb, items = n * per_e;
    if (tid == 0) {
        for (int s = 0; s < kTcStages; ++s) {
            bar_init(&full[s], 1);
            bar_init(&empty[s], 8);               // the consumer warps
        }
        bar_init_fence();
    }
    __syncthreads();

    const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
    if (wg == 2) {
        reg_dealloc<kProducerRegs>();
        if (tid == 256) {
            int it = 0;
            for (int item = blockIdx.x; item < items; item += gridDim.x) {
                const int e = item / per_e, rest = item % per_e;
                const int k0 = rest / nb * C::BK, n0 = rest % nb * C::BN;
                RowWalk walk{first_tile(te, tiles, e), 0,
                             first_tile(te, tiles, e + 1), block_m, C::ROWS,
                             tr};
                for (walk.skip_empty(); !walk.done(); walk.next(), ++it) {
                    const int s = it % kTcStages;
                    bar_wait(&empty[s], ((it / kTcStages) & 1) ^ 1);
                    bar_arrive_tx(&full[s], C::STAGE);
                    uint8_t* xs = ring + s * C::STAGE;
                    const int row = int(walk.row());
                    for (int c = 0; c < C::BK / 64; ++c)
                        tma_load_3d(xs + c * kColBlock, &tx, &full[s],
                                    k0 + 64 * c, row, 0);
                    for (int c = 0; c < C::BN / 64; ++c)
                        tma_load_3d(xs + C::X_BYTES + c * kColBlock, &ty,
                                    &full[s], n0 + 64 * c, row, 0);
                }
            }
        }
        return;
    }
    reg_alloc<kDwConsumerRegs>();

    const int warp = (tid % 128) / 32, lane = tid % 32;
    const int r = 16 * warp + lane / 4;            // and r + 8
    uint8_t* mine = epi + wg * C::EPI;
    int it = 0;
    for (int item = blockIdx.x; item < items; item += gridDim.x) {
        const int e = item / per_e, rest = item % per_e;
        const int k0 = rest / nb * C::BK, n0 = rest % nb * C::BN;
        float acc[C::BN / 2];
#pragma unroll
        for (int i = 0; i < C::BN / 2; ++i) acc[i] = 0.f;
        RowWalk walk{first_tile(te, tiles, e), 0, first_tile(te, tiles, e + 1),
                     block_m, C::ROWS, tr};
        walk.skip_empty();
        int prev = -1;                             // the stage in flight
        while (!__shfl_sync(0xffffffffu, int(walk.done()), 0)) {
            const int valid = __shfl_sync(0xffffffffu, walk.valid(), 0);
            const int s = it % kTcStages;
            bar_wait(&full[s], (it / kTcStages) & 1);
            uint8_t* xs = ring + s * C::STAGE;
            if (valid < C::ROWS) {
                // padding rows: zero their whole lines in all six column
                // blocks (x's two, dy's four) so NaN there adds nothing
                const int chunks = (C::ROWS - valid) * 8;
                for (int i = tid; i < 6 * chunks; i += 256) {
                    const int cb = i / chunks, q = i % chunks;
                    *reinterpret_cast<uint4*>(
                        xs + cb * kColBlock + (valid + q / 8) * kLine +
                        (q % 8) * 16) = make_uint4(0, 0, 0, 0);
                }
                fence_proxy_async();
                named_bar_sync(1, 256);
            }
            const uint32_t xa = smem_u32(xs), ya = xa + C::X_BYTES;
            wgmma_fence();
#pragma unroll
            for (int k = 0; k < C::ROWS / 16; ++k)
                wgmma_ss_t<C::BN, 1, 1>(acc, desc_mn(xa, C::ROWS, wg, k),
                                        desc_mn(ya, C::ROWS, 0, k), 1);
            wgmma_commit();
            wgmma_wait<1>();
            if (prev >= 0 && lane == 0) bar_arrive(&empty[prev]);
            prev = s;
            walk.next();
            ++it;
        }
        wgmma_wait<0>();
        reg_fence(acc);
        if (prev >= 0 && lane == 0) bar_arrive(&empty[prev]);

        // epilogue: the previous item's store must have read the buffer
        if (tid % 128 == 0) tma_store_wait_read<0>();
        named_bar_sync(2 + wg, 128);
#pragma unroll
        for (int c = 0; c < C::BN / 8; ++c) {
            uint8_t* buf = mine + (c / 8) * kColBlock;
            const int off = swz(r, c) + (lane % 4) * 4;
            *reinterpret_cast<uint32_t*>(buf + off) =
                pack_bf16(acc[4 * c], acc[4 * c + 1]);
            *reinterpret_cast<uint32_t*>(buf + off + 8 * kLine) =
                pack_bf16(acc[4 * c + 2], acc[4 * c + 3]);
        }
        fence_proxy_async();
        named_bar_sync(2 + wg, 128);
        if (tid % 128 == 0) {
            if (k0 + 64 * wg < K)
                for (int c = 0; c < C::BN / 64; ++c)
                    if (n0 + 64 * c < N)
                        tma_store_3d(&tdw, mine + c * kColBlock, n0 + 64 * c,
                                     k0 + 64 * wg, e);
            tma_store_commit();
        }
    }
    if (tid % 128 == 0) tma_store_wait<0>();
}

bool bad_geometry(int Tp, int K, int N, int n, int block_m) {
    return Tp < 0 || K <= 0 || N <= 0 || n <= 0 || block_m <= 0 ||
           block_m % kRows || Tp % block_m || K % 8 || N % 8;
}

// the forward (TRANS false) or dx (TRANS true) launch
template <bool TRANS>
int launch_gmm(const void* x, const void* w, const int* te, const int* tr,
               void* out, int Tp, int K, int N, int n, int block_m,
               int dtype, cudaStream_t st) {
    dim3 grid((N + kCols - 1) / kCols, Tp / kRows);
    if (dtype == 0)
        gmm_f32_kernel<TRANS><<<grid, kThreads, 0, st>>>(
            static_cast<const float*>(x), static_cast<const float*>(w), te, tr,
            static_cast<float*>(out), K, N, n, block_m);
    else if (dtype == 1)
        gmm_bf16_kernel<TRANS><<<grid, kThreads, 0, st>>>(
            static_cast<const __nv_bfloat16*>(x),
            static_cast<const __nv_bfloat16*>(w), te, tr,
            static_cast<__nv_bfloat16*>(out), K, N, n, block_m);
    else
        return int(cudaErrorInvalidValue);
    return int(cudaGetLastError());
}

// once per kernel: its dynamic shared memory, and a check that its launch
// allocation holds the `regs` its warpgroups ask for after a hand-over
// (setmaxnreg.inc waits for registers the block does not hold: a build that
// allocated fewer is refused here rather than left to hang)
template <typename Kernel>
cudaError_t prepare(Kernel kern, size_t smem, int threads, int regs,
                    bool& done) {
    if (done) return cudaSuccess;
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (e != cudaSuccess) return e;
    cudaFuncAttributes attr;
    e = cudaFuncGetAttributes(&attr, kern);
    if (e != cudaSuccess) return e;
    if ((attr.numRegs + 7) / 8 * 8 * threads < regs)
        return cudaErrorInvalidConfiguration;
    done = true;
    return cudaSuccess;
}

int num_sms() {
    static const int sms = [] {
        int dev = 0, v = 0;
        if (cudaGetDevice(&dev) != cudaSuccess ||
            cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev) !=
                cudaSuccess)
            return 0;
        return v;
    }();
    return sms;
}

template <bool TRANS, int WGS>
int run_gmm_tc(const CUtensorMap& mx, const CUtensorMap& mx8,
               const CUtensorMap& mw, const CUtensorMap& mo, const int* te,
               const int* tr, void* out, int Tp, int Kc, int Nout, int n,
               int block_m, cudaStream_t st) {
    using C = GmmTc<WGS>;
    auto kern = gmm_tc_kernel<TRANS, WGS>;
    static bool ready = false;
    const cudaError_t e = prepare(kern, C::smem(), C::THREADS, 0, ready);
    if (e != cudaSuccess) return int(e);
    const int row_blocks = Tp / C::BM;
    const long long blocks =
        (long long)((Nout + kTcCols - 1) / kTcCols) * row_blocks;
    if (blocks > INT32_MAX) return int(cudaErrorInvalidValue);
    kern<<<int(blocks), C::THREADS, C::smem(), st>>>(
        mx, mx8, mw, mo, te, tr, static_cast<bf16*>(out), Kc, Nout, n,
        block_m, row_blocks);
    return int(cudaGetLastError());
}

// the forward (TRANS false: a = x [Tp, K], out [Tp, N]) or dx (TRANS true:
// a = dy [Tp, N], out = dx [Tp, K]) on the wgmma route; w [n, K, N].
// Returns 0, a CUDA error, or 1000 + the CUresult of a tensor map that
// cannot be made.
template <bool TRANS>
int launch_gmm_tc(const void* a, const void* w, const int* te, const int* tr,
                  void* out, int Tp, int K, int N, int n, int block_m,
                  int block_rows, cudaStream_t st) {
    const int Kc = TRANS ? N : K, Nout = TRANS ? K : N;
    const cudaError_t bound = bind_context();
    if (bound != cudaSuccess) return int(bound);
    CUtensorMap mx, mx8, mw, mo;
    int r = tile_map(&mx, a, 1, Tp, Kc, 64);
    if (!r) r = tile_map(&mx8, a, 1, Tp, Kc, kBoxRows);
    if (!r) r = tile_map(&mw, w, n, K, N, TRANS ? kTcCols : kTcDepth);
    if (!r) r = tile_map(&mo, out, 1, Tp, Nout, 64);
    if (r) return r;
    if (block_rows == 128)
        return run_gmm_tc<TRANS, 2>(mx, mx8, mw, mo, te, tr, out, Tp, Kc,
                                    Nout, n, block_m, st);
    return run_gmm_tc<TRANS, 1>(mx, mx8, mw, mo, te, tr, out, Tp, Kc, Nout,
                                n, block_m, st);
}

int launch_dw_tc(const void* x, const void* dy, const int* te, const int* tr,
                 void* dw, int Tp, int K, int N, int n, int block_m,
                 cudaStream_t st) {
    if (Tp == 0)   // no tile: every expert's dw is zero
        return int(cudaMemsetAsync(dw, 0, size_t(n) * K * N * 2, st));
    const cudaError_t bound = bind_context();
    if (bound != cudaSuccess) return int(bound);
    CUtensorMap mx, my, md;
    int r = tile_map(&mx, x, 1, Tp, K, 64);
    if (!r) r = tile_map(&my, dy, 1, Tp, N, 64);
    if (!r) r = tile_map(&md, dw, n, K, N, 64);
    if (r) return r;
    static bool ready = false;
    const cudaError_t e = prepare(gmm_dw_tc_kernel, DwTc::smem(), 384,
                                  DwTc::REGS, ready);
    if (e != cudaSuccess) return int(e);
    const long long items = (long long)n * ((K + DwTc::BK - 1) / DwTc::BK) *
                            ((N + DwTc::BN - 1) / DwTc::BN);
    const int sms = num_sms();
    if (sms <= 0 || items > INT32_MAX) return int(cudaErrorInvalidValue);
    const int grid = int(items < sms ? items : sms);
    gmm_dw_tc_kernel<<<grid, 384, DwTc::smem(), st>>>(
        mx, my, md, te, tr, K, N, n, Tp / block_m, block_m);
    return int(cudaGetLastError());
}

bool bad_tc_geometry(int Tp, int K, int N, int n, int block_m, int dtype) {
    return bad_geometry(Tp, K, N, n, block_m) || block_m % 64 || dtype != 1;
}

bool bad_block_rows(int block_m, int block_rows) {
    return (block_rows != 64 && block_rows != 128) || block_m % block_rows;
}

}  // namespace

// The forward: x [Tp, K], w [n, K, N], out [Tp, N], all fp32 (dtype 0) or
// bf16 (dtype 1); tile_expert and tile_rows int32 [Tp / block_m]. Tp and
// block_m are multiples of 32, K and N of 8 (16-byte rows). Returns the
// cudaError_t of the launch (0 = success); it is asynchronous on `stream`.
extern "C" int ds_grouped_matmul(const void* x, const void* w,
                                 const void* tile_expert,
                                 const void* tile_rows, void* out, int Tp,
                                 int K, int N, int n, int block_m, int dtype,
                                 void* stream) {
    if (Tp == 0) return 0;
    if (bad_geometry(Tp, K, N, n, block_m)) return int(cudaErrorInvalidValue);
    return launch_gmm<false>(x, w, static_cast<const int*>(tile_expert),
                             static_cast<const int*>(tile_rows), out, Tp, K,
                             N, n, block_m, dtype,
                             static_cast<cudaStream_t>(stream));
}

// dx = dy @ w[e]^T: dy [Tp, N], w [n, K, N] (the forward's weight, read
// transposed), dx [Tp, K]; the rest as ds_grouped_matmul.
extern "C" int ds_grouped_matmul_dx(const void* dy, const void* w,
                                    const void* tile_expert,
                                    const void* tile_rows, void* dx, int Tp,
                                    int K, int N, int n, int block_m,
                                    int dtype, void* stream) {
    if (Tp == 0) return 0;
    if (bad_geometry(Tp, K, N, n, block_m)) return int(cudaErrorInvalidValue);
    // the kernel's contraction is the forward's N and its output the K
    return launch_gmm<true>(dy, w, static_cast<const int*>(tile_expert),
                            static_cast<const int*>(tile_rows), dx, Tp, N, K,
                            n, block_m, dtype,
                            static_cast<cudaStream_t>(stream));
}

// dw[e] = sum over e's tiles of x_tile^T @ dy_tile: x [Tp, K], dy [Tp, N],
// dw [n, K, N] (every expert written, zeros where it owns no tile);
// tile_expert must not decrease. The rest as ds_grouped_matmul.
extern "C" int ds_grouped_matmul_dw(const void* x, const void* dy,
                                    const void* tile_expert,
                                    const void* tile_rows, void* dw, int Tp,
                                    int K, int N, int n, int block_m,
                                    int dtype, void* stream) {
    if (bad_geometry(Tp, K, N, n, block_m) || n > 65535)
        return int(cudaErrorInvalidValue);
    auto st = static_cast<cudaStream_t>(stream);
    const int* te = static_cast<const int*>(tile_expert);
    const int* tr = static_cast<const int*>(tile_rows);
    const int tiles = Tp / block_m;
    dim3 grid((N + kCols - 1) / kCols, (K + kRows - 1) / kRows, n);
    if (dtype == 0)
        gmm_dw_f32_kernel<<<grid, kThreads, 0, st>>>(
            static_cast<const float*>(x), static_cast<const float*>(dy), te,
            tr, static_cast<float*>(dw), K, N, tiles, block_m);
    else if (dtype == 1)
        gmm_dw_bf16_kernel<<<grid, kThreads, 0, st>>>(
            static_cast<const __nv_bfloat16*>(x),
            static_cast<const __nv_bfloat16*>(dy), te, tr,
            static_cast<__nv_bfloat16*>(dw), K, N, tiles, block_m);
    else
        return int(cudaErrorInvalidValue);
    return int(cudaGetLastError());
}

// The wgmma route (bf16, block_m a multiple of 64; dtype must be 1): the
// same arguments and results as ds_grouped_matmul / _dx / _dw, plus
// 1000 + the CUresult of a tensor map that cannot be made. The forward and
// dx also take the rows a block owns, 128 or 64 dividing block_m
// (`gmm_block_rows` in grouped_matmul.py).
extern "C" int ds_grouped_matmul_tc(const void* x, const void* w,
                                    const void* tile_expert,
                                    const void* tile_rows, void* out, int Tp,
                                    int K, int N, int n, int block_m,
                                    int block_rows, int dtype, void* stream) {
    if (Tp == 0) return 0;
    if (bad_tc_geometry(Tp, K, N, n, block_m, dtype) ||
        bad_block_rows(block_m, block_rows))
        return int(cudaErrorInvalidValue);
    return launch_gmm_tc<false>(x, w, static_cast<const int*>(tile_expert),
                                static_cast<const int*>(tile_rows), out, Tp,
                                K, N, n, block_m, block_rows,
                                static_cast<cudaStream_t>(stream));
}

extern "C" int ds_grouped_matmul_dx_tc(const void* dy, const void* w,
                                       const void* tile_expert,
                                       const void* tile_rows, void* dx,
                                       int Tp, int K, int N, int n,
                                       int block_m, int block_rows, int dtype,
                                       void* stream) {
    if (Tp == 0) return 0;
    if (bad_tc_geometry(Tp, K, N, n, block_m, dtype) ||
        bad_block_rows(block_m, block_rows))
        return int(cudaErrorInvalidValue);
    return launch_gmm_tc<true>(dy, w, static_cast<const int*>(tile_expert),
                               static_cast<const int*>(tile_rows), dx, Tp, K,
                               N, n, block_m, block_rows,
                               static_cast<cudaStream_t>(stream));
}

extern "C" int ds_grouped_matmul_dw_tc(const void* x, const void* dy,
                                       const void* tile_expert,
                                       const void* tile_rows, void* dw,
                                       int Tp, int K, int N, int n,
                                       int block_m, int dtype, void* stream) {
    if (bad_tc_geometry(Tp, K, N, n, block_m, dtype))
        return int(cudaErrorInvalidValue);
    return launch_dw_tc(x, dy, static_cast<const int*>(tile_expert),
                        static_cast<const int*>(tile_rows), dw, Tp, K, N, n,
                        block_m, static_cast<cudaStream_t>(stream));
}

// dynamic shared memory of a wgmma-route kernel: 0 the forward / dx block
// of 128 rows, 1 of 64 rows, 2 dw; -1 otherwise
extern "C" int ds_grouped_matmul_tc_smem(int which) {
    if (which == 0) return int(GmmTc<2>::smem());
    if (which == 1) return int(GmmTc<1>::smem());
    if (which == 2) return int(DwTc::smem());
    return -1;
}
