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
//            copy: the same kernel with the right-hand tile staged as
//            [columns][contraction] and read as a col_major fragment);
//   dw:      dw[e][K, N] = sum over the tiles of e of x_tile^T @ dy_tile,
//            zero for an expert that owns no tile.
// Rows past tile_rows are padding: the forward and dx write them as zeros
// without reading them; dw never reads them.
//
// What bounds them on an H100: at decode (a few routed rows per expert)
// the bytes of the weight slabs of the experts that own a routed row, 2
// bytes a weight in bf16. At training and prefill (hundreds of rows per
// expert) the operations: 2 * routed rows * K * N over the tensor cores'
// bf16 rate (989 TFLOP/s), or the CUDA cores' fp32 rate (67).
//
// What the design does about it.
// - Forward and dx: a block owns 32 rows and 64 columns; it reads its
//   tile's expert and routed-row count itself (there is no scalar prefetch
//   on Hopper), writes zeros and stops when its rows hold no routed token
//   (most tiles of a decode step: 61 tiles of 128 rows for 32 routed rows
//   at 60 experts), and otherwise walks the contraction in steps of 64
//   (bf16) or 32 (fp32) with the next step's 16-byte loads in flight while
//   the current one multiplies: bf16 on the tensor cores (WMMA 16x16x16,
//   fp32 accumulators, four warps of 16x32 each), fp32 on the CUDA cores
//   (each thread a 4x4 sub-tile; TF32 would round x and W).
// - dw: nothing carries across CUDA blocks (the Pallas grid keeps one
//   accumulator across an expert's consecutive tiles), so a block owns one
//   32x64 tile of one expert's [K, N] output and walks that expert's run
//   of token tiles itself: tile_expert does not decrease, so the run is
//   contiguous and two binary searches over tile_expert find it on the
//   device. It contracts over the routed rows only, 64 (bf16) or 32 (fp32)
//   rows a step with the next step's loads in flight; x_tile^T is read as
//   a col_major matrix_a fragment. No atomics: the sum is the same from
//   run to run. An expert with no tile writes zeros (the `has` mask of the
//   Pallas caller); the tiles clipped onto the last expert hold no routed
//   row and add nothing.
// wgmma, TMA and a persistent schedule over the routed tiles only are
// later work. All offsets are 64-bit.
//
// Built with `nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC` into a plain C library (deepspeed_tpu_torch/ops/kernels.py)
// and called through ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

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
