// Grouped (per-expert) matrix product over expert-sorted tokens (K5's
// forward).
//
// Replaces the TPU kernel `_gmm_kernel` of
// deepspeed_tpu/ops/pallas/grouped_matmul.py with `transpose_rhs=False`
// (entry `grouped_matmul`, the dropless MoE route's expert products). Its
// backward (`transpose_rhs=True` and `_dw_kernel`) is ported with the
// training slice.
//
// What it computes: out[Tp, N] = x[Tp, K] @ W[e][K, N] row by row, where x
// holds the routed tokens sorted by expert, each expert's segment padded to
// a multiple of block_m, and e = tile_expert[row / block_m]. fp32
// accumulation; out has x's dtype (fp32 or bf16, W the same). tile_rows[t]
// counts the routed rows at the start of tile t: the rows past it are
// padding (zero in x) and are written as zeros without being read.
//
// What bounds it on an H100: at decode (a few routed rows per expert) the
// bytes of the weight slabs of the experts that own a routed row, each read
// once per 32-row sub-tile that holds routed rows: 2 bytes a weight in
// bf16. At prefill (hundreds of rows per expert) the operations:
// 2 * routed rows * K * N over the tensor cores' bf16 rate, or the CUDA
// cores' fp32 rate.
//
// What the design does about it: the sort pads every expert's segment to
// block_m rows, and the tiles past the last expert are clipped to expert
// n-1, so most tiles of a decode step hold no routed row (61 tiles of 128
// rows for 32 routed rows at 60 experts). A block owns 32 rows and 64
// columns; it reads its tile's expert and routed-row count itself (there is
// no scalar prefetch on Hopper), writes zeros and stops when its rows hold
// no routed token, and otherwise walks K in steps of 64 (bf16) or 32
// (fp32) with the next step's 16-byte loads in flight while the current one
// multiplies: bf16 on the tensor cores (WMMA 16x16x16, fp32 accumulators,
// four warps of 16x32 each), fp32 on the CUDA cores (each thread a 4x4
// sub-tile; TF32 would round x and W). Rows past the routed count are
// neither loaded nor computed into the output. wgmma, TMA and a persistent
// schedule over the routed tiles only are later work.
// All offsets are 64-bit.
//
// Built with `nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC` into a plain C library (deepspeed_tpu_torch/ops/kernels.py)
// and called through ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

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

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------
constexpr int kBK = 64;                   // K rows per step
constexpr int kALd = kBK + 8;             // bf16 strides: multiples of 8
constexpr int kBLd = kCols + 8;
constexpr int kCLd = kCols + 4;           // fp32 epilogue stride

// one step's raw inputs of one thread: 2 x 8 bf16 of x, 4 x 8 bf16 of W
struct Regs {
    uint4 a[2];
    uint4 b[4];
};

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
        const int k = k0 + q / 8, c = n0 + (q % 8) * 8;
        r.b[i] = (k < K && c < N)
            ? *reinterpret_cast<const uint4*>(w + size_t(k) * N + c)
            : z;
    }
}

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

// grid (ceil(N / 64), Tp / 32); warp (wm, wn) = (warp / 2, warp % 2) owns
// rows wm*16.. and columns wn*32.. of the block's 32x64 tile
__global__ void __launch_bounds__(kThreads)
gmm_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                const __nv_bfloat16* __restrict__ w,
                const int* __restrict__ te, const int* __restrict__ tr,
                __nv_bfloat16* __restrict__ out, int K, int N, int n,
                int block_m) {
    using namespace nvcuda;
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
    load_step(r, x, we, K, N, row0, rt.rows, n0, 0, tid);
    for (int k0 = 0; k0 < K; k0 += kBK) {
        store_step(r, as, bs, tid);
        __syncthreads();
        if (k0 + kBK < K)                 // in flight during the products
            load_step(r, x, we, K, N, row0, rt.rows, n0, k0 + kBK, tid);
#pragma unroll
        for (int kk = 0; kk < kBK; kk += 16) {
            wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                           wmma::row_major> a;
            wmma::load_matrix_sync(a, as + (wm * 16) * kALd + kk, kALd);
#pragma unroll
            for (int j = 0; j < 2; ++j) {
                wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                               wmma::row_major> b;
                wmma::load_matrix_sync(b, bs + kk * kBLd + wn * 32 + j * 16,
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
    for (int i = tid; i < kRows * kCols; i += kThreads) {
        const int m = i / kCols, c = n0 + i % kCols;
        if (c < N)
            out[size_t(row0 + m) * N + c] = __float2bfloat16(
                m < rt.rows ? cs[m * kCLd + i % kCols] : 0.f);
    }
}

// ---------------------------------------------------------------------------
// fp32: CUDA cores
// ---------------------------------------------------------------------------
constexpr int kFK = 32;                   // K rows per step
constexpr int kPad = 4;                   // keeps float4 rows 16-byte aligned

// grid (ceil(N / 64), Tp / 32); thread (tx, ty) = (tid % 16, tid / 16)
// accumulates rows ty*4.. and columns tx*4.. of the block's tile
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
            const int k = k0 + q / 16, c = n0 + (q % 16) * 4;
            rb[i] = (k < K && c < N)
                ? *reinterpret_cast<const float4*>(we + size_t(k) * N + c)
                : z;
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
            *reinterpret_cast<float4*>(&ws[q / 16][(q % 16) * 4]) = rb[i];
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

}  // namespace

// x [Tp, K], w [n, K, N], out [Tp, N], all fp32 (dtype 0) or bf16 (dtype
// 1); tile_expert and tile_rows int32 [Tp / block_m]. Tp and block_m are
// multiples of 32, K and N of 8 (16-byte rows). Returns the cudaError_t of
// the launch (0 = success); it is asynchronous on `stream`.
extern "C" int ds_grouped_matmul(const void* x, const void* w,
                                 const void* tile_expert,
                                 const void* tile_rows, void* out, int Tp,
                                 int K, int N, int n, int block_m, int dtype,
                                 void* stream) {
    if (Tp == 0) return 0;
    if (Tp < 0 || K <= 0 || N <= 0 || n <= 0 || block_m <= 0 ||
        block_m % kRows || Tp % block_m || K % 8 || N % 8)
        return int(cudaErrorInvalidValue);
    auto st = static_cast<cudaStream_t>(stream);
    const int* te = static_cast<const int*>(tile_expert);
    const int* tr = static_cast<const int*>(tile_rows);
    dim3 grid((N + kCols - 1) / kCols, Tp / kRows);
    if (dtype == 0)
        gmm_f32_kernel<<<grid, kThreads, 0, st>>>(
            static_cast<const float*>(x), static_cast<const float*>(w), te, tr,
            static_cast<float*>(out), K, N, n, block_m);
    else if (dtype == 1)
        gmm_bf16_kernel<<<grid, kThreads, 0, st>>>(
            static_cast<const __nv_bfloat16*>(x),
            static_cast<const __nv_bfloat16*>(w), te, tr,
            static_cast<__nv_bfloat16*>(out), K, N, n, block_m);
    else
        return int(cudaErrorInvalidValue);
    return int(cudaGetLastError());
}
