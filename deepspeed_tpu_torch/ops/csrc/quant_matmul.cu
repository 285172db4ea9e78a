// Weight-only-quantized matrix product with in-tile dequantization (K2).
//
// Replaces the TPU kernels `_qmm8_kernel`, `_qmm4_kernel` and their
// stacked-layer forms `_qmm8_kernel_l`, `_qmm4_kernel_l` of
// deepspeed_tpu/ops/pallas/quant_matmul.py (entry `quant_matmul`), and the
// small-M route that entry sends through XLA's fused dequant-dot
// (`_xla_dequant_dot`).
//
// What it computes: out[M, Np] = x[M, K] @ W[K, Np] in x's dtype (fp32 or
// bf16), where W is never stored: each element is dequantized from its code
// as float(code) * scale[k / G][n] in fp32, rounded to x's dtype, and the
// product accumulates in fp32 (the TPU kernels' and the XLA route's
// algebra). Codes are int8 or e4m3 [K, Np], or int4 K-pairs packed into
// uint8 [K/2, Np] (row 2r in the low nibble, 2r+1 in the high, offset 8);
// scales are fp32 [K/G, Np]. A layer index times a layer stride (in
// elements; 0 when unstacked) selects one slab of stacked [L, ...] codes and
// scales, as the `_l` kernels do with their scalar-prefetched layer index.
//
// What bounds it on an H100: at decode (M <= 16 rows) the bytes of the
// codes, read once: 1 byte per weight for int8/e4m3, half a byte for int4,
// against 2 for a bf16 weight. At prefill (hundreds of rows) the operations:
// 2*M*K*N over the card's peak rate.
//
// What the design does about it — two forms of one kernel source:
// - Decode form (M <= 16): a block owns 128 columns and a range of K; each
//   thread reads 4 neighbouring columns of a K row as one 4-byte word (a
//   warp reads 128 contiguous bytes per row), dequantizes them with the
//   group's scales held in registers, and multiply-adds them into up to 16
//   rows of x staged in shared memory. Each code byte is read once. The 4
//   warps of a block split its K range and reduce through shared memory;
//   blocks along K (added until about six blocks sit on each SM, so enough
//   loads are in flight to cover the memory latency) write fp32 partials
//   that a second small kernel sums into the output.
// - Tile form (larger M): a block owns a 64x64 output tile, stages the x
//   tile and the dequantized weight tile in shared memory and walks K. In
//   bf16 the weight tile is stored rounded to bf16 and eight warps multiply
//   it on the tensor cores (WMMA 16x16x16, fp32 accumulators): bf16
//   products are exact in fp32, so this is the same algebra. Its loads are
//   16 bytes wide, and the next K step's loads are in flight while the
//   current step multiplies. In fp32 each thread accumulates a 4x4
//   sub-tile on the CUDA cores (TF32 would round x and the weight). wgmma,
//   TMA and a deeper pipeline are later work.
// All offsets are 64-bit.
//
// Built with `nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC` into a plain C library (deepspeed_tpu_torch/ops/kernels.py)
// and called through ctypes.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace {

enum Fmt { kInt8 = 0, kInt4 = 1, kE4M3 = 2 };

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
    return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
    return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
        float x) {
    return __float2bfloat16(x);
}
// x rounded to T and read back as fp32 (the dequantized weight's rounding
// to the compute dtype)
template <typename T> __device__ __forceinline__ float round_to(float x) {
    return to_f(from_f<T>(x));
}

__device__ __forceinline__ float e4m3_to_f(uint32_t b) {
    const __half_raw h = __nv_cvt_fp8_to_halfraw(
        static_cast<__nv_fp8_storage_t>(b), __NV_E4M3);
    return __half2float(__half(h));
}

// the code of byte `b` (int8 or e4m3) as a float
template <int FMT> __device__ __forceinline__ float code_f(uint32_t b) {
    if (FMT == kE4M3) return e4m3_to_f(b);
    return float(static_cast<int8_t>(b));
}

// ---------------------------------------------------------------------------
// decode form
// ---------------------------------------------------------------------------
constexpr int kDecThreads = 128;          // 4 warps
constexpr int kDecWarps = kDecThreads / 32;
constexpr int kDecCols = 128;             // columns per block (4 per lane)

// grid (Np / 128, splits); dynamic shared memory: max(MR * KB, 4 * MR * 128)
// floats. Block (bx, by) covers columns bx*128.. and K rows [by*KB,
// min(K, (by+1)*KB)).
template <typename T, int FMT, int MR>
__global__ void __launch_bounds__(kDecThreads)
qmm_decode_kernel(const T* __restrict__ x, const uint8_t* __restrict__ codes,
                  const float* __restrict__ scale, T* __restrict__ out,
                  float* __restrict__ partial, int M, int K, int Np, int G,
                  int KB) {
    extern __shared__ __align__(16) float dsm[];
    float* x_s = dsm;                         // [MR][KB]
    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    const int n0 = blockIdx.x * kDecCols + lane * 4;
    const int k0 = blockIdx.y * KB;
    const int k1 = min(K, k0 + KB);

    // ---- x rows [0, MR) x K range -> shared fp32, zeros past M and K -----
    for (int idx = tid; idx < MR * KB; idx += kDecThreads) {
        const int m = idx / KB, kk = idx % KB, k = k0 + kk;
        x_s[idx] = (m < M && k < k1) ? to_f(x[size_t(m) * K + k]) : 0.f;
    }
    __syncthreads();

    float acc[MR][4];
#pragma unroll
    for (int m = 0; m < MR; ++m)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[m][c] = 0.f;

    // the warp's K rows: a contiguous, even-sized share of the block's
    const int kw = ((KB + kDecWarps - 1) / kDecWarps + 1) & ~1;
    const int kb = min(k1, k0 + warp * kw), ke = min(k1, kb + kw);
    // walk group segments, so scales load once per group
    for (int gs = kb; gs < ke;) {
        const int g = gs / G;
        const int ge = min(ke, (g + 1) * G);
        const float4 s4 = *reinterpret_cast<const float4*>(
            scale + size_t(g) * Np + n0);
        const float sc[4] = {s4.x, s4.y, s4.z, s4.w};
        if (FMT == kInt4) {
            // packed rows gs/2 .. ge/2 (G and the warp's share are even)
#pragma unroll 8
            for (int k = gs; k < ge; k += 2) {
                const uint32_t word = *reinterpret_cast<const uint32_t*>(
                    codes + size_t(k / 2) * Np + n0);
                float wl[4], wh[4];
#pragma unroll
                for (int c = 0; c < 4; ++c) {
                    const uint32_t b = (word >> (8 * c)) & 0xffu;
                    wl[c] = round_to<T>(float(int(b & 15u) - 8) * sc[c]);
                    wh[c] = round_to<T>(float(int(b >> 4) - 8) * sc[c]);
                }
                const int kk = k - k0;
#pragma unroll
                for (int m = 0; m < MR; ++m) {
                    const float xl = x_s[m * KB + kk];
                    const float xh = x_s[m * KB + kk + 1];
#pragma unroll
                    for (int c = 0; c < 4; ++c) {
                        acc[m][c] = fmaf(xl, wl[c], acc[m][c]);
                        acc[m][c] = fmaf(xh, wh[c], acc[m][c]);
                    }
                }
            }
        } else {
#pragma unroll 8
            for (int k = gs; k < ge; ++k) {
                const uint32_t word = *reinterpret_cast<const uint32_t*>(
                    codes + size_t(k) * Np + n0);
                float w[4];
#pragma unroll
                for (int c = 0; c < 4; ++c)
                    w[c] = round_to<T>(code_f<FMT>((word >> (8 * c)) & 0xffu) *
                                       sc[c]);
                const int kk = k - k0;
#pragma unroll
                for (int m = 0; m < MR; ++m) {
                    const float xv = x_s[m * KB + kk];
#pragma unroll
                    for (int c = 0; c < 4; ++c)
                        acc[m][c] = fmaf(xv, w[c], acc[m][c]);
                }
            }
        }
        gs = ge;
    }

    // ---- reduce the 4 warps' sums through shared memory -------------------
    __syncthreads();                          // x_s is reused below
    float* red = dsm;                         // [4][MR][128]
#pragma unroll
    for (int m = 0; m < MR; ++m)
        *reinterpret_cast<float4*>(red + (size_t(warp) * MR + m) * kDecCols +
                                   lane * 4) =
            make_float4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
    __syncthreads();
    const int n = blockIdx.x * kDecCols + tid;
    for (int m = 0; m < M; ++m) {
        float sum = 0.f;
#pragma unroll
        for (int w = 0; w < kDecWarps; ++w)
            sum += red[(size_t(w) * MR + m) * kDecCols + tid];
        if (partial)
            partial[(size_t(blockIdx.y) * M + m) * Np + n] = sum;
        else
            out[size_t(m) * Np + n] = from_f<T>(sum);
    }
}

// out[m, n] = sum over the splits of partial[split, m, n]
template <typename T>
__global__ void qmm_reduce_kernel(const float* __restrict__ partial,
                                  T* __restrict__ out, int splits,
                                  size_t elems) {
    const size_t i = size_t(blockIdx.x) * blockDim.x + threadIdx.x;
    if (i >= elems) return;
    float sum = 0.f;
    for (int s = 0; s < splits; ++s) sum += partial[size_t(s) * elems + i];
    out[i] = from_f<T>(sum);
}

// ---------------------------------------------------------------------------
// tile form
// ---------------------------------------------------------------------------
constexpr int kTileThreads = 256;
constexpr int kBM = 64, kBN = 64, kBK = 32;
constexpr int kPad = 4;                   // keeps float4 rows 16-byte aligned

// grid (Np / 64, ceil(M / 64)); thread (tx, ty) = (tid % 16, tid / 16)
// accumulates rows ty*4.. and columns tx*4.. of the block's tile
template <typename T, int FMT>
__global__ void __launch_bounds__(kTileThreads)
qmm_tile_kernel(const T* __restrict__ x, const uint8_t* __restrict__ codes,
                const float* __restrict__ scale, T* __restrict__ out, int M,
                int K, int Np, int G) {
    __shared__ __align__(16) float xs[kBK][kBM + kPad];   // x tile, K-major
    __shared__ __align__(16) float ws[kBK][kBN + kPad];   // dequantized W
    const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
    const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;

    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

    for (int k0 = 0; k0 < K; k0 += kBK) {
        // x tile: element e = tid + i*256 -> row e / 32, column e % 32 (a
        // warp reads 32 neighbouring elements of one row)
#pragma unroll
        for (int i = 0; i < kBM * kBK / kTileThreads; ++i) {
            const int e = tid + i * kTileThreads;
            const int r = e / kBK, c = e % kBK;
            const int m = m0 + r, k = k0 + c;
            xs[c][r] = (m < M && k < K) ? to_f(x[size_t(m) * K + k]) : 0.f;
        }
        if (FMT == kInt4) {
            // 16 packed rows x 64 columns: element e -> packed row e / 64
#pragma unroll
            for (int i = 0; i < (kBK / 2) * kBN / kTileThreads; ++i) {
                const int e = tid + i * kTileThreads;
                const int pr = e / kBN, c = e % kBN;
                const int k = k0 + 2 * pr, n = n0 + c;
                float lo = 0.f, hi = 0.f;
                if (k < K) {
                    const uint32_t b = codes[size_t(k / 2) * Np + n];
                    const float s = scale[size_t(k / G) * Np + n];
                    lo = round_to<T>(float(int(b & 15u) - 8) * s);
                    hi = round_to<T>(float(int(b >> 4) - 8) * s);
                }
                ws[2 * pr][c] = lo;
                ws[2 * pr + 1][c] = hi;
            }
        } else {
#pragma unroll
            for (int i = 0; i < kBK * kBN / kTileThreads; ++i) {
                const int e = tid + i * kTileThreads;
                const int r = e / kBN, c = e % kBN;
                const int k = k0 + r, n = n0 + c;
                float w = 0.f;
                if (k < K)
                    w = round_to<T>(code_f<FMT>(codes[size_t(k) * Np + n]) *
                                    scale[size_t(k / G) * Np + n]);
                ws[r][c] = w;
            }
        }
        __syncthreads();
#pragma unroll 8
        for (int kk = 0; kk < kBK; ++kk) {
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
        const int m = m0 + ty * 4 + i;
        if (m >= M) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j)
            out[size_t(m) * Np + n0 + tx * 4 + j] = from_f<T>(acc[i][j]);
    }
}

// bf16: the same tile on the tensor cores, walking K in steps of 64 with
// 16-byte loads; the next step's raw x, codes and scales are loaded into
// registers while the current step multiplies. Eight warps: warp (wm, wn) =
// (warp / 2, warp % 2) owns rows wm*16.. and columns wn*32.. of the 64x64
// tile as 1x2 WMMA fragments.
constexpr int kWThreads = 256;
constexpr int kWBK = 64;                  // K rows per step
constexpr int kALd = kWBK + 8;            // bf16 row strides: multiples of 8
constexpr int kBLd = kBN + 8;
constexpr int kCLd = kBN + 4;             // fp32 epilogue stride

// one K step's raw inputs of one thread: 2 x 8 bf16 of x; 16 codes (int8,
// e4m3) or 8 packed int4 bytes (in c.x, c.y); their 16 (or 8) scales
struct WRegs {
    uint4 x[2];
    uint4 c;
    float4 s[4];
};

template <int FMT>
__device__ __forceinline__ void wload(WRegs& r,
                                      const __nv_bfloat16* __restrict__ x,
                                      const uint8_t* __restrict__ codes,
                                      const float* __restrict__ scale, int M,
                                      int K, int Np, int G, int m0, int n0,
                                      int k0, int tid) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const int v = tid + i * kWThreads;
        const int m = m0 + v / 8, k = k0 + (v % 8) * 8;
        if (m < M && (K & 7) == 0 && k + 8 <= K) {
            r.x[i] = *reinterpret_cast<const uint4*>(x + size_t(m) * K + k);
        } else {                          // the ragged edge, element-wise
            __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&r.x[i]);
#pragma unroll
            for (int j = 0; j < 8; ++j)
                e[j] = (m < M && k + j < K) ? x[size_t(m) * K + k + j]
                                            : __float2bfloat16(0.f);
        }
    }
    const float4 z4 = make_float4(0.f, 0.f, 0.f, 0.f);
    if (FMT == kInt4) {
        const int k = k0 + 2 * (tid / 8), n = n0 + (tid % 8) * 8;
        r.c = make_uint4(0, 0, 0, 0);
        r.s[0] = r.s[1] = r.s[2] = r.s[3] = z4;
        if (k < K) {
            const uint2 w = *reinterpret_cast<const uint2*>(
                codes + size_t(k / 2) * Np + n);
            r.c.x = w.x;
            r.c.y = w.y;
            const float* sp = scale + size_t(k / G) * Np + n;
            r.s[0] = *reinterpret_cast<const float4*>(sp);
            r.s[1] = *reinterpret_cast<const float4*>(sp + 4);
        }
    } else {
        const int k = k0 + tid / 4, n = n0 + (tid % 4) * 16;
        r.c = make_uint4(0, 0, 0, 0);
        r.s[0] = r.s[1] = r.s[2] = r.s[3] = z4;
        if (k < K) {
            r.c = *reinterpret_cast<const uint4*>(codes + size_t(k) * Np + n);
            const float* sp = scale + size_t(k / G) * Np + n;
#pragma unroll
            for (int j = 0; j < 4; ++j)
                r.s[j] = *reinterpret_cast<const float4*>(sp + 4 * j);
        }
    }
}

// the step's x tile and its weight tile, dequantized and rounded to bf16,
// into shared memory
template <int FMT>
__device__ __forceinline__ void wstore(const WRegs& r, __nv_bfloat16* as,
                                       __nv_bfloat16* bs, int tid) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const int v = tid + i * kWThreads;
        *reinterpret_cast<uint4*>(as + (v / 8) * kALd + (v % 8) * 8) = r.x[i];
    }
    const float* sc = reinterpret_cast<const float*>(r.s);
    const uint32_t words[4] = {r.c.x, r.c.y, r.c.z, r.c.w};
    if (FMT == kInt4) {
        const int pr = tid / 8, col = (tid % 8) * 8;
        uint4 lo, hi;
        __nv_bfloat16* el = reinterpret_cast<__nv_bfloat16*>(&lo);
        __nv_bfloat16* eh = reinterpret_cast<__nv_bfloat16*>(&hi);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            const uint32_t b = (words[j / 4] >> (8 * (j % 4))) & 0xffu;
            el[j] = __float2bfloat16(float(int(b & 15u) - 8) * sc[j]);
            eh[j] = __float2bfloat16(float(int(b >> 4) - 8) * sc[j]);
        }
        *reinterpret_cast<uint4*>(bs + (2 * pr) * kBLd + col) = lo;
        *reinterpret_cast<uint4*>(bs + (2 * pr + 1) * kBLd + col) = hi;
    } else {
        const int row = tid / 4, col = (tid % 4) * 16;
        uint4 w[2];
        __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(w);
#pragma unroll
        for (int j = 0; j < 16; ++j)
            e[j] = __float2bfloat16(
                code_f<FMT>((words[j / 4] >> (8 * (j % 4))) & 0xffu) * sc[j]);
        *reinterpret_cast<uint4*>(bs + row * kBLd + col) = w[0];
        *reinterpret_cast<uint4*>(bs + row * kBLd + col + 8) = w[1];
    }
}

template <int FMT>
__global__ void __launch_bounds__(kWThreads)
qmm_tile_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                     const uint8_t* __restrict__ codes,
                     const float* __restrict__ scale,
                     __nv_bfloat16* __restrict__ out, int M, int K, int Np,
                     int G) {
    using namespace nvcuda;
    __shared__ __align__(32) __nv_bfloat16 as[kBM * kALd];    // x tile
    __shared__ __align__(32) __nv_bfloat16 bs[kWBK * kBLd];   // W tile, bf16
    __shared__ __align__(32) float cs[kBM * kCLd];            // epilogue
    const int tid = threadIdx.x, warp = tid / 32;
    const int wm = warp / 2, wn = warp % 2;
    const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;

    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[j], 0.f);

    WRegs r;
    wload<FMT>(r, x, codes, scale, M, K, Np, G, m0, n0, 0, tid);
    for (int k0 = 0; k0 < K; k0 += kWBK) {
        wstore<FMT>(r, as, bs, tid);
        __syncthreads();
        if (k0 + kWBK < K)                // in flight during the products
            wload<FMT>(r, x, codes, scale, M, K, Np, G, m0, n0, k0 + kWBK,
                       tid);
#pragma unroll
        for (int kk = 0; kk < kWBK; kk += 16) {
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
    for (int e = tid; e < kBM * kBN; e += kWThreads) {
        const int r2 = e / kBN, c = e % kBN, m = m0 + r2;
        if (m < M)
            out[size_t(m) * Np + n0 + c] = __float2bfloat16(cs[r2 * kCLd + c]);
    }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------
constexpr int kMaxDecodeSmem = 32 * 1024;

template <typename T, int FMT, int MR>
cudaError_t launch_decode(const T* x, const uint8_t* codes, const float* sc,
                          T* out, float* ws, int M, int K, int Np, int G,
                          int KB, int splits, cudaStream_t st) {
    const size_t xf = size_t(MR) * KB, rf = size_t(kDecWarps) * MR * kDecCols;
    const size_t smem = (xf > rf ? xf : rf) * sizeof(float);
    if (smem > size_t(kMaxDecodeSmem) || KB % 2) return cudaErrorInvalidValue;
    dim3 grid(Np / kDecCols, splits);
    qmm_decode_kernel<T, FMT, MR><<<grid, kDecThreads, smem, st>>>(
        x, codes, sc, out, splits > 1 ? ws : nullptr, M, K, Np, G, KB);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess || splits <= 1) return err;
    const size_t elems = size_t(M) * Np;
    qmm_reduce_kernel<T><<<unsigned((elems + 255) / 256), 256, 0, st>>>(
        ws, out, splits, elems);
    return cudaGetLastError();
}

template <typename T, int FMT>
cudaError_t dispatch(const void* x_, const uint8_t* codes, const float* sc,
                     void* out_, float* ws, int M, int K, int Np, int G,
                     int decode, int MR, int KB, int splits,
                     cudaStream_t st) {
    const T* x = static_cast<const T*>(x_);
    T* out = static_cast<T*>(out_);
    if (!decode) {
        dim3 grid(Np / kBN, (M + kBM - 1) / kBM);
        if constexpr (std::is_same_v<T, __nv_bfloat16>)
            qmm_tile_bf16_kernel<FMT><<<grid, kWThreads, 0, st>>>(
                x, codes, sc, out, M, K, Np, G);
        else
            qmm_tile_kernel<T, FMT><<<grid, kTileThreads, 0, st>>>(
                x, codes, sc, out, M, K, Np, G);
        return cudaGetLastError();
    }
    if (M > MR || splits < 1 || KB < 2) return cudaErrorInvalidValue;
    switch (MR) {
        case 1: return launch_decode<T, FMT, 1>(x, codes, sc, out, ws, M, K,
                                                Np, G, KB, splits, st);
        case 2: return launch_decode<T, FMT, 2>(x, codes, sc, out, ws, M, K,
                                                Np, G, KB, splits, st);
        case 4: return launch_decode<T, FMT, 4>(x, codes, sc, out, ws, M, K,
                                                Np, G, KB, splits, st);
        case 8: return launch_decode<T, FMT, 8>(x, codes, sc, out, ws, M, K,
                                                Np, G, KB, splits, st);
        case 16: return launch_decode<T, FMT, 16>(x, codes, sc, out, ws, M,
                                                  K, Np, G, KB, splits, st);
        default: return cudaErrorInvalidValue;
    }
}

template <typename T>
cudaError_t dispatch_fmt(int fmt, const void* x, const uint8_t* codes,
                         const float* sc, void* out, float* ws, int M, int K,
                         int Np, int G, int decode, int MR, int KB,
                         int splits, cudaStream_t st) {
    switch (fmt) {
        case kInt8: return dispatch<T, kInt8>(x, codes, sc, out, ws, M, K, Np,
                                              G, decode, MR, KB, splits, st);
        case kInt4: return dispatch<T, kInt4>(x, codes, sc, out, ws, M, K, Np,
                                              G, decode, MR, KB, splits, st);
        case kE4M3: return dispatch<T, kE4M3>(x, codes, sc, out, ws, M, K, Np,
                                              G, decode, MR, KB, splits, st);
        default: return cudaErrorInvalidValue;
    }
}

}  // namespace

// fmt: 0 = int8, 1 = int4 (packed K-pairs), 2 = e4m3. dtype: 0 = float32,
// 1 = bfloat16 (of x and out). `layer` times the strides (in elements of
// codes / scales) selects a stacked slab. decode != 0 takes the decode form
// with row capacity MR (a power of two, 1..16), KB rows of K per block and
// `splits` blocks along K; with splits > 1, `workspace` holds fp32
// [splits, M, Np] partials. Returns the cudaError_t of the launches (0 =
// success); they are asynchronous on `stream`.
extern "C" int ds_quant_matmul(const void* x, const void* codes,
                               const void* scale, void* out, void* workspace,
                               int M, int K, int Np, int G, int fmt, int dtype,
                               int layer, long long codes_layer_stride,
                               long long scale_layer_stride, int decode,
                               int MR, int KB, int splits, void* stream) {
    if (M == 0) return 0;
    if (M < 0 || K <= 0 || Np <= 0 || Np % 128 || G <= 0 || K % G ||
        (fmt == kInt4 && (G % 2 || K % 2)) || layer < 0)
        return int(cudaErrorInvalidValue);
    auto st = static_cast<cudaStream_t>(stream);
    const uint8_t* c = static_cast<const uint8_t*>(codes) +
                       size_t(layer) * size_t(codes_layer_stride);
    const float* s = static_cast<const float*>(scale) +
                     size_t(layer) * size_t(scale_layer_stride);
    float* ws = static_cast<float*>(workspace);
    cudaError_t err;
    if (dtype == 0)
        err = dispatch_fmt<float>(fmt, x, c, s, out, ws, M, K, Np, G, decode,
                                  MR, KB, splits, st);
    else if (dtype == 1)
        err = dispatch_fmt<__nv_bfloat16>(fmt, x, c, s, out, ws, M, K, Np, G,
                                          decode, MR, KB, splits, st);
    else
        err = cudaErrorInvalidValue;
    return int(err);
}

// ---------------------------------------------------------------------------
// grouped form (K3)
// ---------------------------------------------------------------------------
//
// Replaces the TPU kernels `_qgmm8_kernel`, `_qgmm4_kernel` and their
// stacked-layer forms `_qgmm8_kernel_l`, `_qgmm4_kernel_l` of
// deepspeed_tpu/ops/pallas/quant_matmul.py (entry `quant_grouped_matmul`,
// the quantized MoE route's expert products).
//
// What it computes: out[Tp, Np] = x[Tp, K] @ W[e] row by row, where x holds
// the routed tokens sorted by expert (each expert's segment padded to a
// multiple of block_m rows), e = tile_expert[row / block_m], and W[e] is
// expert e's slab of codes dequantized as above (float(code) * scale in
// fp32, rounded to x's dtype), with fp32 accumulation. Codes are [n, K, Np]
// (int8, e4m3) or [n, K/2, Np] (int4 pairs, decoded in place: no even/odd
// split of x), scales [n, K/G, Np]; a layer index times the layer strides
// selects one [n, ...] block of stacked codes. tile_rows[t] counts the
// routed rows at the start of tile t: the rows past it are padding (zero in
// x) and are written as zeros without being read.
//
// What bounds it on an H100: at decode (a few routed rows per expert) the
// codes and scales of the experts that own a routed row, each read once per
// 32-row sub-tile that holds routed rows. At prefill the operations,
// 2 * routed rows * K * N, over the bf16 tensor cores' rate.
//
// What the design does about it: the tile form above with 32-row tiles,
// one expert each. A block reads its tile's expert and routed-row count,
// writes zeros and stops when its rows hold no routed token (most tiles of
// a decode step: 61 tiles for 32 routed rows at 60 experts), and otherwise
// walks K in steps of 64 with 16-byte loads of x, codes and scales for the
// next step in flight while the tensor cores (WMMA, fp32 accumulators,
// four warps of 16x32) multiply the current one; fp32 x takes the CUDA
// cores, each thread a 4x4 sub-tile.

namespace {

constexpr int kGRows = 32;
constexpr int kGCols = 64;
constexpr int kGThreads = 128;            // 4 warps
constexpr int kGK = 64;                   // K rows per bf16 step
constexpr int kGALd = kGK + 8;
constexpr int kGBLd = kGCols + 8;
constexpr int kGCLd = kGCols + 4;
constexpr int kGFK = 32;                  // K rows per fp32 step

// the block's expert and how many of its 32 rows hold routed tokens (0 when
// none do, or when the tile's expert is out of range)
__device__ __forceinline__ int2 grouped_rows(const int* __restrict__ te,
                                             const int* __restrict__ tr,
                                             int row0, int block_m, int n) {
    const int t = row0 / block_m;
    const int e = te[t];
    int v = tr[t] - (row0 - t * block_m);
    v = v < 0 ? 0 : (v > kGRows ? kGRows : v);
    if (e < 0 || e >= n) v = 0;
    return make_int2(e, v);
}

template <typename T>
__device__ __forceinline__ void grouped_zero(T* __restrict__ out, int row0,
                                             int v, int n0, int Np, int tid) {
    for (int i = tid; i < kGRows * kGCols; i += kGThreads) {
        const int r = i / kGCols;
        if (r >= v)
            out[size_t(row0 + r) * Np + n0 + i % kGCols] = from_f<T>(0.f);
    }
}

// one bf16 step's raw inputs of one thread: 2 x 8 bf16 of x; two rows of 16
// codes (int8, e4m3) or one packed int4 row of 16 bytes (c[0]); their scales
struct GRegs {
    uint4 x[2];
    uint4 c[2];
    float4 s[8];
};

template <int FMT>
__device__ __forceinline__ void gload(GRegs& r,
                                      const __nv_bfloat16* __restrict__ x,
                                      const uint8_t* __restrict__ codes,
                                      const float* __restrict__ scale, int K,
                                      int Np, int G, int row0, int v, int n0,
                                      int k0, int tid) {
    const uint4 z = make_uint4(0, 0, 0, 0);
    const float4 z4 = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int i = 0; i < 2; ++i) {                 // x: 32 rows x 64 k
        const int q = tid + i * kGThreads;
        const int m = q / 8, k = k0 + (q % 8) * 8;
        r.x[i] = (m < v && k < K)
            ? *reinterpret_cast<const uint4*>(x + size_t(row0 + m) * K + k)
            : z;
    }
    if (FMT == kInt4) {                           // 32 packed rows x 64
        const int k = k0 + 2 * (tid / 4), n = n0 + (tid % 4) * 16;
        r.c[0] = r.c[1] = z;
#pragma unroll
        for (int j = 0; j < 8; ++j) r.s[j] = z4;
        if (k < K) {
            r.c[0] = *reinterpret_cast<const uint4*>(
                codes + size_t(k / 2) * Np + n);
            const float* sp = scale + size_t(k / G) * Np + n;
#pragma unroll
            for (int j = 0; j < 4; ++j)
                r.s[j] = *reinterpret_cast<const float4*>(sp + 4 * j);
        }
    } else {                                      // 64 rows x 64
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            const int q = tid + i * kGThreads;
            const int k = k0 + q / 4, n = n0 + (q % 4) * 16;
            r.c[i] = z;
#pragma unroll
            for (int j = 0; j < 4; ++j) r.s[4 * i + j] = z4;
            if (k < K) {
                r.c[i] = *reinterpret_cast<const uint4*>(
                    codes + size_t(k) * Np + n);
                const float* sp = scale + size_t(k / G) * Np + n;
#pragma unroll
                for (int j = 0; j < 4; ++j)
                    r.s[4 * i + j] = *reinterpret_cast<const float4*>(
                        sp + 4 * j);
            }
        }
    }
}

// 16 codes of `words` times their 16 scales, rounded to bf16, into the
// shared-memory row `dst` (int4: `hi` picks the high nibbles)
template <int FMT>
__device__ __forceinline__ void gdequant16(const uint4 c, const float* sc,
                                           __nv_bfloat16* dst, bool hi) {
    const uint32_t words[4] = {c.x, c.y, c.z, c.w};
    uint4 w[2];
    __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(w);
#pragma unroll
    for (int j = 0; j < 16; ++j) {
        const uint32_t b = (words[j / 4] >> (8 * (j % 4))) & 0xffu;
        float f;
        if (FMT == kInt4)
            f = float(int(hi ? (b >> 4) : (b & 15u)) - 8);
        else
            f = code_f<FMT>(b);
        e[j] = __float2bfloat16(f * sc[j]);
    }
    *reinterpret_cast<uint4*>(dst) = w[0];
    *reinterpret_cast<uint4*>(dst + 8) = w[1];
}

template <int FMT>
__device__ __forceinline__ void gstore(const GRegs& r, __nv_bfloat16* as,
                                       __nv_bfloat16* bs, int tid) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const int q = tid + i * kGThreads;
        *reinterpret_cast<uint4*>(as + (q / 8) * kGALd + (q % 8) * 8) =
            r.x[i];
    }
    const float* sc = reinterpret_cast<const float*>(r.s);
    if (FMT == kInt4) {
        const int pr = tid / 4, col = (tid % 4) * 16;
        gdequant16<FMT>(r.c[0], sc, bs + (2 * pr) * kGBLd + col, false);
        gdequant16<FMT>(r.c[0], sc, bs + (2 * pr + 1) * kGBLd + col, true);
    } else {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            const int q = tid + i * kGThreads;
            gdequant16<FMT>(r.c[i], sc + 16 * i,
                            bs + (q / 4) * kGBLd + (q % 4) * 16, false);
        }
    }
}

// grid (Np / 64, Tp / 32); codes / scale point at the layer's [n, ...] slabs
template <int FMT>
__global__ void __launch_bounds__(kGThreads)
qgmm_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                 const uint8_t* __restrict__ codes,
                 const float* __restrict__ scale,
                 const int* __restrict__ te, const int* __restrict__ tr,
                 __nv_bfloat16* __restrict__ out, int K, int Np, int G, int n,
                 int block_m) {
    using namespace nvcuda;
    __shared__ __align__(32) __nv_bfloat16 as[kGRows * kGALd];
    __shared__ __align__(32) __nv_bfloat16 bs[kGK * kGBLd];
    __shared__ __align__(32) float cs[kGRows * kGCLd];
    const int tid = threadIdx.x, warp = tid / 32;
    const int wm = warp / 2, wn = warp % 2;
    const int row0 = blockIdx.y * kGRows, n0 = blockIdx.x * kGCols;
    const int2 ev = grouped_rows(te, tr, row0, block_m, n);
    if (ev.y == 0) {
        grouped_zero(out, row0, 0, n0, Np, tid);
        return;
    }
    const size_t code_rows = FMT == kInt4 ? K / 2 : K;
    const uint8_t* ce = codes + size_t(ev.x) * code_rows * Np;
    const float* se = scale + size_t(ev.x) * (K / G) * Np;

    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[j], 0.f);

    GRegs r;
    gload<FMT>(r, x, ce, se, K, Np, G, row0, ev.y, n0, 0, tid);
    for (int k0 = 0; k0 < K; k0 += kGK) {
        gstore<FMT>(r, as, bs, tid);
        __syncthreads();
        if (k0 + kGK < K)                 // in flight during the products
            gload<FMT>(r, x, ce, se, K, Np, G, row0, ev.y, n0, k0 + kGK,
                       tid);
#pragma unroll
        for (int kk = 0; kk < kGK; kk += 16) {
            wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                           wmma::row_major> a;
            wmma::load_matrix_sync(a, as + (wm * 16) * kGALd + kk, kGALd);
#pragma unroll
            for (int j = 0; j < 2; ++j) {
                wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                               wmma::row_major> b;
                wmma::load_matrix_sync(b, bs + kk * kGBLd + wn * 32 + j * 16,
                                       kGBLd);
                wmma::mma_sync(acc[j], a, b, acc[j]);
            }
        }
        __syncthreads();
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
        wmma::store_matrix_sync(cs + (wm * 16) * kGCLd + wn * 32 + j * 16,
                                acc[j], kGCLd, wmma::mem_row_major);
    __syncthreads();
    for (int i = tid; i < kGRows * kGCols; i += kGThreads) {
        const int m = i / kGCols, c = i % kGCols;
        out[size_t(row0 + m) * Np + n0 + c] = __float2bfloat16(
            m < ev.y ? cs[m * kGCLd + c] : 0.f);
    }
}

// fp32: the x tile and the dequantized weight tile in shared memory, thread
// (tx, ty) = (tid % 16, tid / 16) accumulating rows ty*4.. and columns
// tx*4.. on the CUDA cores
template <int FMT>
__global__ void __launch_bounds__(kGThreads)
qgmm_f32_kernel(const float* __restrict__ x,
                const uint8_t* __restrict__ codes,
                const float* __restrict__ scale, const int* __restrict__ te,
                const int* __restrict__ tr, float* __restrict__ out, int K,
                int Np, int G, int n, int block_m) {
    __shared__ __align__(16) float xs[kGFK][kGRows + kPad];  // K-major
    __shared__ __align__(16) float ws[kGFK][kGCols + kPad];
    const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
    const int row0 = blockIdx.y * kGRows, n0 = blockIdx.x * kGCols;
    const int2 ev = grouped_rows(te, tr, row0, block_m, n);
    if (ev.y == 0) {
        grouped_zero(out, row0, 0, n0, Np, tid);
        return;
    }
    const size_t code_rows = FMT == kInt4 ? K / 2 : K;
    const uint8_t* ce = codes + size_t(ev.x) * code_rows * Np;
    const float* se = scale + size_t(ev.x) * (K / G) * Np;

    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

    for (int k0 = 0; k0 < K; k0 += kGFK) {
        // x tile: element e -> row e / 32, column e % 32
#pragma unroll
        for (int i = 0; i < kGRows * kGFK / kGThreads; ++i) {
            const int e = tid + i * kGThreads;
            const int m = e / kGFK, c = e % kGFK, k = k0 + c;
            xs[c][m] = (m < ev.y && k < K) ? x[size_t(row0 + m) * K + k]
                                           : 0.f;
        }
        if (FMT == kInt4) {
#pragma unroll
            for (int i = 0; i < (kGFK / 2) * kGCols / kGThreads; ++i) {
                const int e = tid + i * kGThreads;
                const int pr = e / kGCols, c = e % kGCols;
                const int k = k0 + 2 * pr, nn = n0 + c;
                float lo = 0.f, hi = 0.f;
                if (k < K) {
                    const uint32_t b = ce[size_t(k / 2) * Np + nn];
                    const float s = se[size_t(k / G) * Np + nn];
                    lo = float(int(b & 15u) - 8) * s;
                    hi = float(int(b >> 4) - 8) * s;
                }
                ws[2 * pr][c] = lo;
                ws[2 * pr + 1][c] = hi;
            }
        } else {
#pragma unroll
            for (int i = 0; i < kGFK * kGCols / kGThreads; ++i) {
                const int e = tid + i * kGThreads;
                const int rr = e / kGCols, c = e % kGCols;
                const int k = k0 + rr, nn = n0 + c;
                ws[rr][c] = k < K ? code_f<FMT>(ce[size_t(k) * Np + nn]) *
                                        se[size_t(k / G) * Np + nn]
                                  : 0.f;
            }
        }
        __syncthreads();
#pragma unroll 8
        for (int kk = 0; kk < kGFK; ++kk) {
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
        for (int j = 0; j < 4; ++j)
            out[size_t(row0 + m) * Np + n0 + tx * 4 + j] =
                m < ev.y ? acc[i][j] : 0.f;
    }
}

template <int FMT>
cudaError_t grouped_dispatch(int dtype, const void* x, const uint8_t* codes,
                             const float* sc, const int* te, const int* tr,
                             void* out, int Tp, int K, int Np, int G, int n,
                             int block_m, cudaStream_t st) {
    dim3 grid(Np / kGCols, Tp / kGRows);
    if (dtype == 0)
        qgmm_f32_kernel<FMT><<<grid, kGThreads, 0, st>>>(
            static_cast<const float*>(x), codes, sc, te, tr,
            static_cast<float*>(out), K, Np, G, n, block_m);
    else if (dtype == 1)
        qgmm_bf16_kernel<FMT><<<grid, kGThreads, 0, st>>>(
            static_cast<const __nv_bfloat16*>(x), codes, sc, te, tr,
            static_cast<__nv_bfloat16*>(out), K, Np, G, n, block_m);
    else
        return cudaErrorInvalidValue;
    return cudaGetLastError();
}

}  // namespace

// The grouped form: x [Tp, K] (dtype 0 = float32, 1 = bfloat16, as out
// [Tp, Np]); codes [n, K, Np] or [n, K/2, Np] (fmt as above) and scales
// [n, K/G, Np], offset by `layer` times the layer strides (in elements);
// tile_expert and tile_rows int32 [Tp / block_m]. Tp and block_m are
// multiples of 32, K of 8. Returns the cudaError_t of the launch (0 =
// success); it is asynchronous on `stream`.
extern "C" int ds_quant_grouped_matmul(
        const void* x, const void* codes, const void* scale,
        const void* tile_expert, const void* tile_rows, void* out, int Tp,
        int K, int Np, int G, int n, int block_m, int fmt, int dtype,
        int layer, long long codes_layer_stride, long long scale_layer_stride,
        void* stream) {
    if (Tp == 0) return 0;
    if (Tp < 0 || K <= 0 || K % 8 || Np <= 0 || Np % 128 || G <= 0 ||
        K % G || (fmt == kInt4 && G % 2) || n <= 0 || block_m <= 0 ||
        block_m % kGRows || Tp % block_m || layer < 0)
        return int(cudaErrorInvalidValue);
    auto st = static_cast<cudaStream_t>(stream);
    const uint8_t* c = static_cast<const uint8_t*>(codes) +
                       size_t(layer) * size_t(codes_layer_stride);
    const float* s = static_cast<const float*>(scale) +
                     size_t(layer) * size_t(scale_layer_stride);
    const int* te = static_cast<const int*>(tile_expert);
    const int* tr = static_cast<const int*>(tile_rows);
    cudaError_t err;
    switch (fmt) {
        case kInt8: err = grouped_dispatch<kInt8>(dtype, x, c, s, te, tr, out,
                                                  Tp, K, Np, G, n, block_m,
                                                  st); break;
        case kInt4: err = grouped_dispatch<kInt4>(dtype, x, c, s, te, tr, out,
                                                  Tp, K, Np, G, n, block_m,
                                                  st); break;
        case kE4M3: err = grouped_dispatch<kE4M3>(dtype, x, c, s, te, tr, out,
                                                  Tp, K, Np, G, n, block_m,
                                                  st); break;
        default: err = cudaErrorInvalidValue;
    }
    return int(err);
}
