// Weight-only-quantized matrix products with in-tile dequantization: the
// dense product (K2) and the grouped per-expert product (K3).
//
// Replaces the TPU kernels of deepspeed_tpu/ops/pallas/quant_matmul.py:
// K2 `_qmm8_kernel`, `_qmm4_kernel` and their stacked-layer forms
// `_qmm8_kernel_l`, `_qmm4_kernel_l` (entry `quant_matmul`, and the small-M
// route that entry sends through XLA's fused dequant-dot,
// `_xla_dequant_dot`); K3 `_qgmm8_kernel`, `_qgmm4_kernel` and their `_l`
// forms (entry `quant_grouped_matmul`, the quantized MoE route's expert
// products).
//
// What they compute. K2: out[M, Np] = x[M, K] @ W[K, Np]. K3: out[Tp, Np]
// = x[Tp, K] @ W[e] row by row, where x holds the routed tokens sorted by
// expert (each expert's segment padded to a multiple of block_m rows), e =
// tile_expert[row / block_m], and tile_rows[t] counts the routed rows at the
// start of tile t: the rows past it are padding and are written as zeros.
// W is never stored: each element is dequantized from its code as
// float(code) * scale[k / G][n] in fp32 and rounded to x's dtype, and the
// product accumulates in fp32 (the TPU kernels' and the XLA route's
// algebra). Codes are int8 or e4m3 [.., K, Np], or int4 K-pairs packed into
// uint8 [.., K/2, Np] (row 2r in the low nibble, 2r+1 in the high, offset
// 8); scales are fp32 [.., K/G, Np]. A layer index times a layer stride (in
// elements; 0 when unstacked) selects one slab of stacked [L, ...] codes and
// scales, as the `_l` kernels do with their scalar-prefetched layer index.
//
// What bounds them on an H100: at decode (a few token rows) the bytes of
// the codes, read once: 1 byte per weight for int8/e4m3, half a byte for
// int4, against 2 for a bf16 weight (K3: the codes of the experts that own a
// routed row). At prefill (hundreds of rows) the operations: 2 * rows * K *
// N over the bf16 tensor cores' rate.
//
// bf16 x: the wgmma route (`qmm_tc_kernel<FMT, BN>` for K2 and
// `qgmm_tc_kernel<FMT, BN>` for K3, one body). What its design does about
// the bounds:
// - Operands swapped so the tensor cores fit the shapes: out^T = W^T x^T.
//   The weight's columns fill wgmma's 64-row M dimension and the tokens
//   its N (8 or 16 at decode, up to 256 at prefill), so a decode step is
//   not padded to 64 rows. A block owns 128 weight columns, one 64-column
//   half per consumer warpgroup, and BN token columns. From BN 128 the
//   producer is a warpgroup that hands its registers to the consumers
//   (setmaxnreg), as the 128 accumulators of BN 256 otherwise spill.
// - Bytes in flight: a producer warp keeps a ring of up to 16 stages of TMA
//   loads in flight (the stage count fills the shared memory left at the
//   block's occupancy): 64 k rows of codes (128-byte swizzle), the stage's
//   x rows (only the rows that hold tokens, in 64- and 8-row boxes) and the
//   scale rows its k range touches. Each code byte is read from HBM once
//   per block column range.
// - Codes widened once per tile with few conversions: each consumer thread
//   reads 16 codes (16 B) of a line, builds each float exactly without the
//   conversion pipe (int8: the byte put into a float's mantissa with one
//   byte-permute, minus the bias; int4: one lop3 per nibble into the
//   mantissa of 2^23 or 2^19; e4m3: the paired e4m3x2 -> f16x2 convert),
//   multiplies by the group's scale in fp32 (the 16 scales of its columns
//   are held in registers and reloaded only when the group changes) and
//   rounds two at a time (cvt.rn.bf16x2.f32). That is bit for bit
//   __float2bfloat16(float(code) * scale). It writes the bf16 values into
//   its warpgroup's 128-byte-swizzled tile, which wgmma reads as the
//   MN-major A operand (the transpose-A bit: the tile is the weight's own
//   [k][n] order); x is the K-major B operand. A register-A form
//   (wgmma_rs) would need each thread's A fragment (two consecutive k of
//   one column) gathered byte by byte from the [k][n] codes: shared memory
//   does not limit this kernel (under 90 B a clock an SM at decode), so the
//   shared-memory A operand is kept. Two W tile buffers per warpgroup let
//   one stage be widened while the tensor cores multiply the previous one.
//   What limits the decode form on the card is the widening's instruction
//   count (about 4 a code), not the conversion pipe: taking the
//   cvt.rn.bf16x2 out changed nothing, taking the scale multiply out
//   (and with it the scale lookup) took a third of the widening's time
//   (bin/qmm_widen_variants.py).
// - K2's decode, one launch, deterministic: when the column blocks are
//   too few to fill the SMs (M <= BN), blocks split K (`splits`). Each
//   writes its fp32 accumulator fragment to a workspace that the caller
//   keeps across calls; the last block of a column range to arrive (a
//   counter the kernel resets) sums the splits in split order and writes
//   the output.
// - K3: an expert's segment (its consecutive 32-row sub-tiles that hold
//   routed rows) is cut into runs of up to run_tiles (1-8) sub-tiles from
//   its first, and each run is one product of up to 256 token columns, so
//   each weight element is widened once per run, not once per 32-row tile
//   (a run never splits at a window's edge). A block takes the runs that
//   start in its window of run_tiles sub-tiles. wgmma's N is the run's
//   rows rounded up to 64 (a warp-uniform choice of shape). Blocks sweep a
//   window's column blocks one after another, so an expert's slab streams
//   from HBM in order. Rows past tile_rows are zeroed by select (NaN in
//   padding rows never reaches a result); sub-tiles without routed rows
//   are written as zeros by their window.
// fp32 x: the CUDA-core FMA kernels (the parity route), as before: a decode
// form (M <= 16: 4-byte code words, K split into blocks whose fp32 partials
// a second kernel sums) and a tile form (64 x 64 tiles, 4 x 4 per thread);
// K3 32 x 64 tiles of one expert each.
// All offsets are 64-bit.
//
// Built with `nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC` into a plain C library (deepspeed_tpu_torch/ops/kernels.py)
// and called through ctypes.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>
#include <unordered_map>

#include "hopper.cuh"

namespace {

enum Fmt { kInt8 = 0, kInt4 = 1, kE4M3 = 2 };

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
// fp32 decode form
// ---------------------------------------------------------------------------
constexpr int kDecThreads = 128;          // 4 warps
constexpr int kDecWarps = kDecThreads / 32;
constexpr int kDecCols = 128;             // columns per block (4 per lane)

// grid (Np / 128, splits); dynamic shared memory: max(MR * KB, 4 * MR * 128)
// floats. Block (bx, by) covers columns bx*128.. and K rows [by*KB,
// min(K, (by+1)*KB)).
template <int FMT, int MR>
__global__ void __launch_bounds__(kDecThreads)
qmm_decode_kernel(const float* __restrict__ x,
                  const uint8_t* __restrict__ codes,
                  const float* __restrict__ scale, float* __restrict__ out,
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
        x_s[idx] = (m < M && k < k1) ? x[size_t(m) * K + k] : 0.f;
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
                    wl[c] = float(int(b & 15u) - 8) * sc[c];
                    wh[c] = float(int(b >> 4) - 8) * sc[c];
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
                    w[c] = code_f<FMT>((word >> (8 * c)) & 0xffu) * sc[c];
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
            out[size_t(m) * Np + n] = sum;
    }
}

// out[m, n] = sum over the splits of partial[split, m, n]
__global__ void qmm_reduce_kernel(const float* __restrict__ partial,
                                  float* __restrict__ out, int splits,
                                  size_t elems) {
    const size_t i = size_t(blockIdx.x) * blockDim.x + threadIdx.x;
    if (i >= elems) return;
    float sum = 0.f;
    for (int s = 0; s < splits; ++s) sum += partial[size_t(s) * elems + i];
    out[i] = sum;
}

// ---------------------------------------------------------------------------
// fp32 tile form
// ---------------------------------------------------------------------------
constexpr int kTileThreads = 256;
constexpr int kBM = 64, kBN = 64, kBK = 32;
constexpr int kPad = 4;                   // keeps float4 rows 16-byte aligned

// grid (Np / 64, ceil(M / 64)); thread (tx, ty) = (tid % 16, tid / 16)
// accumulates rows ty*4.. and columns tx*4.. of the block's tile
template <int FMT>
__global__ void __launch_bounds__(kTileThreads)
qmm_tile_kernel(const float* __restrict__ x, const uint8_t* __restrict__ codes,
                const float* __restrict__ scale, float* __restrict__ out,
                int M, int K, int Np, int G) {
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
            xs[c][r] = (m < M && k < K) ? x[size_t(m) * K + k] : 0.f;
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
                    lo = float(int(b & 15u) - 8) * s;
                    hi = float(int(b >> 4) - 8) * s;
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
                    w = code_f<FMT>(codes[size_t(k) * Np + n]) *
                        scale[size_t(k / G) * Np + n];
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
            out[size_t(m) * Np + n0 + tx * 4 + j] = acc[i][j];
    }
}

// ---------------------------------------------------------------------------
// fp32 grouped form (K3): 32 x 64 tiles of one expert each
// ---------------------------------------------------------------------------
constexpr int kGRows = 32;
constexpr int kGCols = 64;
constexpr int kGThreads = 128;            // 4 warps
constexpr int kGFK = 32;                  // K rows per step

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

// grid (Np / 64, Tp / 32); thread (tx, ty) = (tid % 16, tid / 16)
// accumulating rows ty*4.. and columns tx*4.. on the CUDA cores; codes /
// scale point at the layer's [n, ...] slabs
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
        for (int i = tid; i < kGRows * kGCols; i += kGThreads)
            out[size_t(row0 + i / kGCols) * Np + n0 + i % kGCols] = 0.f;
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

// ---------------------------------------------------------------------------
// bf16: the wgmma route (K2 and K3)
// ---------------------------------------------------------------------------
using bf16 = __nv_bfloat16;
using namespace hopper;

constexpr int kTcCols = 128;              // weight columns a block
constexpr int kTcDepth = 64;              // k rows a stage
constexpr int kTcConsumers = 256;         // two consumer warpgroups
constexpr int kLine = 128;                // bytes of a swizzled line
constexpr int kWTile = 64 * kLine;        // a warpgroup's bf16 W tile
constexpr int kSub = 32;                  // K3's run unit: a 32-row sub-tile
constexpr int kMaxRun = 8;                // sub-tiles a window at most
constexpr int kMaxStages = 16;
constexpr int kScaleRow = kTcCols * 4;    // bytes of a stage's scale row
// the fixed part of the dynamic shared memory: alignment slack, the four W
// tiles (two buffers per warpgroup) and the run table
constexpr int kTcFixed = 1024 + 4 * kWTile + 1024;
// shared memory a block may take: two blocks an SM for BN <= 64, else one
constexpr int kTcBudget2 = 113 * 1024, kTcBudget1 = 227 * 1024;

// a block of BN token columns: up to 64, a producer warp and two blocks an
// SM (accumulators of at most 32 registers); from 128, one block an SM and
// a producer warpgroup that hands its registers to the consumers
// (setmaxnreg 24 / 240: with a producer warp ptxas gave BN 256 168
// registers, and its 128-register accumulator spilled 1.2 KB)
template <int BN>
struct TcShape {
    static constexpr bool kHandOver = BN >= 128;
    static constexpr int kThreads = kTcConsumers + (kHandOver ? 128 : 32);
    static constexpr int kMinBlocks = kHandOver ? 1 : 2;
};
constexpr int kProducerRegs = 24, kConsumerRegs = 240;

// one product of a block: token columns [0, ntok) of x / out rows row0..,
// of which the first vload (a multiple of 8) are loaded; slab `expert`;
// wgmma's N; first sub-tile u0 in the window (K3)
struct Run {
    int row0, ntok, vload, expert, nsel, u0;
};

// K3: the window's sub-tiles and as many after it (a run that starts in
// the window may reach into them): routed rows (-1 past Tp) and experts
struct RunTable {
    int nruns;
    int last;                     // a split block's flag: it sums the splits
    int srows[2 * kMaxRun];
    int sexp[2 * kMaxRun];
    Run runs[kMaxRun];
};

// arguments of one launch of the wgmma route
struct TcArgs {
    bf16* out;
    float* ws;                    // split partials (K2, splits > 1)
    int* counters;                // one per column block (K2, splits > 1)
    const int* te;                // K3: tile_expert, tile_rows
    const int* tr;
    int rows;                     // x's rows: M (K2) or Tp (K3)
    int K, Np, G, n, block_m;
    int splits, ks;               // K split: blocks, stages each
    int run_tiles;                // K3: sub-tiles a window
    int stages, stage_bytes, code_bytes, scale_rows;
};

// shared-memory accesses by shared-window address (the compiler emits
// generic loads and stores for pointers into dynamic shared memory)
__device__ __forceinline__ uint4 lds128(uint32_t a) {
    uint4 v;
    asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
                 : "r"(a));
    return v;
}
__device__ __forceinline__ void sts128(uint32_t a, uint32_t x, uint32_t y,
                                       uint32_t z, uint32_t w) {
    asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(a),
                 "r"(x), "r"(y), "r"(z), "r"(w)
                 : "memory");
}

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
    return reinterpret_cast<uint8_t*>(
        (reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

// wgmma's N for a run of `v` loaded token columns in a block of BN
template <int BN>
__device__ __forceinline__ int n_select(int v) {
    if (BN <= 64) return BN;
    const int r = (v + 63) / 64 * 64;
    return r < 64 ? 64 : (r > BN ? BN : r);
}

// the 16 scales of columns [col, col + 16) for line k, reloaded only when
// its group changes: the stage's scale rows start at group gb, whose end is
// nextb
__device__ __forceinline__ void scales_for(int k, int gb, int nextb, int G,
                                           uint32_t slot, int col, int& cg,
                                           float (&sc)[16]) {
    int g = gb;
    for (int nb = nextb; k >= nb; nb += G) ++g;
    if (g == cg) return;
    const uint32_t p = slot + ((g - gb) * kTcCols + col) * 4;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const uint4 v = lds128(p + 16 * i);
        sc[4 * i] = __uint_as_float(v.x);
        sc[4 * i + 1] = __uint_as_float(v.y);
        sc[4 * i + 2] = __uint_as_float(v.z);
        sc[4 * i + 3] = __uint_as_float(v.w);
    }
    cg = g;
}

// 16 int8 / e4m3 codes (one 16-byte chunk, columns in order) times their
// scales, as 8 bf16 pairs: bit for bit __float2bfloat16(float(code) * s)
template <int FMT>
__device__ __forceinline__ void widen16(uint4 c, const float (&sc)[16],
                                        uint32_t (&o)[8]) {
    const uint32_t w[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
        if (FMT == kE4M3) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const __half2_raw r = __nv_cvt_fp8x2_to_halfraw2(
                    static_cast<__nv_fp8x2_storage_t>(w[q] >> (16 * h)),
                    __NV_E4M3);
                const float2 f = __half22float2(__half2(r));
                o[2 * q + h] = pack_bf16(f.x * sc[4 * q + 2 * h],
                                         f.y * sc[4 * q + 2 * h + 1]);
            }
        } else {
            // c + 128 in the mantissa of 2^23: 2^23 + 128 + c, exactly
            const uint32_t u = w[q] ^ 0x80808080u;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const float a = __int_as_float(__byte_perm(
                                    u, 0x4B000000u, 0x7650u + 2 * h)) -
                                8388736.f;
                const float b = __int_as_float(__byte_perm(
                                    u, 0x4B000000u, 0x7651u + 2 * h)) -
                                8388736.f;
                o[2 * q + h] = pack_bf16(a * sc[4 * q + 2 * h],
                                         b * sc[4 * q + 2 * h + 1]);
            }
        }
    }
}

// 16 packed int4 bytes (columns in order): the low nibbles (row 2p) and the
// high nibbles (row 2p + 1) times their columns' scales, as bf16 pairs
__device__ __forceinline__ void widen16_int4(uint4 c, const float (&sc)[16],
                                             uint32_t (&lo)[8],
                                             uint32_t (&hi)[8]) {
    const uint32_t w[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
        float l[4], h[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const uint32_t b = w[q] >> (8 * i);
            // nibble in the mantissa of 2^23 (low) or 2^19 (high, bits 4-7
            // weigh 1 there), minus the bias and the offset 8
            l[i] = __int_as_float((b & 0x0Fu) | 0x4B000000u) - 8388616.f;
            h[i] = __int_as_float((b & 0xF0u) | 0x49000000u) - 524296.f;
        }
        lo[2 * q] = pack_bf16(l[0] * sc[4 * q], l[1] * sc[4 * q + 1]);
        lo[2 * q + 1] = pack_bf16(l[2] * sc[4 * q + 2], l[3] * sc[4 * q + 3]);
        hi[2 * q] = pack_bf16(h[0] * sc[4 * q], h[1] * sc[4 * q + 1]);
        hi[2 * q + 1] = pack_bf16(h[2] * sc[4 * q + 2], h[3] * sc[4 * q + 3]);
    }
}

// 8 bf16 pairs into 16-byte chunks cw, cw + 1 of line l of a swizzled tile
__device__ __forceinline__ void put_line(uint32_t tile, int l, int cw,
                                         const uint32_t (&o)[8]) {
    const uint32_t line = tile + l * kLine;
    sts128(line + ((cw ^ (l & 7)) << 4), o[0], o[1], o[2], o[3]);
    sts128(line + (((cw + 1) ^ (l & 7)) << 4), o[4], o[5], o[6], o[7]);
}

// a consumer thread's share of one stage: its warpgroup's 64 columns of
// the stage's codes widened into the warpgroup's W tile (64 k lines x 64
// columns, 128-byte swizzle). Thread lt reads 16-column chunk lt % 4 of
// the warpgroup's half: lines lt / 4 and lt / 4 + 32 (int8, e4m3) or packed
// line lt / 4 (int4: k lines 2p and 2p + 1). When G is a multiple of 64
// (every default group) the stage lies in one group: its scales are looked
// up once, before the loads, and the stage is straight-line code.
template <int FMT>
__device__ __forceinline__ void widen_stage(uint32_t codes, uint32_t slot,
                                            uint32_t wt, int k0, int gb,
                                            int nextb, int G, int wg, int lt,
                                            int& cg, float (&sc)[16]) {
    const int q = lt & 3, ci = 4 * wg + q, col = 64 * wg + 16 * q;
    const bool one_group = G % kTcDepth == 0;
    if (one_group) scales_for(k0, gb, nextb, G, slot, col, cg, sc);
    if (FMT == kInt4) {
        const int p = lt >> 2;
        const uint4 c = lds128(codes + p * kLine + ((ci ^ (p & 7)) << 4));
        if (!one_group) scales_for(k0 + 2 * p, gb, nextb, G, slot, col, cg,
                                   sc);
        uint32_t lo[8], hi[8];
        widen16_int4(c, sc, lo, hi);
        put_line(wt, 2 * p, 2 * q, lo);
        put_line(wt, 2 * p + 1, 2 * q, hi);
    } else if (one_group) {
        const int l = lt >> 2;
        const uint4 c0 = lds128(codes + l * kLine + ((ci ^ (l & 7)) << 4));
        const uint4 c1 =
            lds128(codes + (l + 32) * kLine + ((ci ^ (l & 7)) << 4));
        uint32_t o[8];
        widen16<FMT>(c0, sc, o);
        put_line(wt, l, 2 * q, o);
        widen16<FMT>(c1, sc, o);
        put_line(wt, l + 32, 2 * q, o);
    } else {
#pragma unroll
        for (int pass = 0; pass < 2; ++pass) {
            const int l = (lt >> 2) + 32 * pass;
            const uint4 c = lds128(codes + l * kLine + ((ci ^ (l & 7)) << 4));
            scales_for(k0 + l, gb, nextb, G, slot, col, cg, sc);
            uint32_t o[8];
            widen16<FMT>(c, sc, o);
            put_line(wt, l, 2 * q, o);
        }
    }
}

// acc (64 weight columns x N token columns) += W^T . x^T over one stage's
// 64 k: A the W tile (MN-major), B the stage's x rows (K-major); the
// narrower shapes accumulate into a prefix of acc (the same fragment
// layout, chunk by chunk of 8 token columns)
template <int N, int BN>
__device__ __forceinline__ void mma_n(float (&acc)[BN / 2], uint32_t wt,
                                      uint32_t xs) {
    float(&d)[N / 2] = *reinterpret_cast<float(*)[N / 2]>(&acc[0]);
#pragma unroll
    for (int k = 0; k < kTcDepth / 16; ++k)
        wgmma_ss_t<N, 1, 0>(d, desc_mn(wt, 64, 0, k), desc_k(xs, BN, 0, k),
                            1);
}

// the same with N = nsel, a warp-uniform value (wgmma under a condition
// ptxas cannot prove uniform is serialized)
template <int BN>
__device__ __forceinline__ void mma_stage(float (&acc)[BN / 2], uint32_t wt,
                                          uint32_t xs, int nsel) {
    if constexpr (BN <= 64) {
        mma_n<BN, BN>(acc, wt, xs);
    } else if constexpr (BN == 128) {
        if (nsel == 64) mma_n<64, BN>(acc, wt, xs);
        else mma_n<128, BN>(acc, wt, xs);
    } else {
        if (nsel == 64) mma_n<64, BN>(acc, wt, xs);
        else if (nsel == 128) mma_n<128, BN>(acc, wt, xs);
        else if (nsel == 192) mma_n<192, BN>(acc, wt, xs);
        else mma_n<256, BN>(acc, wt, xs);
    }
}

// K3: routed rows (0..32) and expert of sub-tile u
__device__ __forceinline__ int2 sub_tile(const TcArgs& a, int u) {
    const int tile = u * kSub / a.block_m;
    const int e = a.te[tile];
    int v = a.tr[tile] - (u * kSub - tile * a.block_m);
    v = v < 0 ? 0 : (v > kSub ? kSub : v);
    if (e < 0 || e >= a.n) v = 0;
    return make_int2(v, e);
}

// the block's products (warp 0 builds the table). K2: one run, the
// window's tokens. K3: the runs that start in the window. An expert's
// stretch of consecutive sub-tiles with routed rows (its segment) is cut
// into runs of run_tiles sub-tiles from the segment's first, so a run
// never splits at a window's edge; the window's first segment may have
// started in an earlier window, which a backward scan (32 sub-tiles a
// step) finds.
template <int BN, bool GROUPED>
__device__ void build_runs(const TcArgs& a, RunTable& t, int lane) {
    if (!GROUPED) {
        if (lane == 0) {
            const int row0 = blockIdx.y * BN;
            const int v = min(BN, a.rows - row0);
            const int vl = (v + 7) / 8 * 8;
            t.runs[0] = Run{row0, v, vl, 0, n_select<BN>(vl), 0};
            t.nruns = 1;
            t.last = 0;
        }
        return;
    }
    const int R = a.run_tiles, ubase = blockIdx.y * R;
    const int subs = a.rows / kSub;
    if (lane < 2 * R) {
        const int u = ubase + lane;
        const int2 ve = u < subs ? sub_tile(a, u) : make_int2(-1, -1);
        t.srows[lane] = ve.x;
        t.sexp[lane] = ve.y;
    }
    __syncwarp();
    int s0 = ubase;                  // the segment of the window's first
    if (t.srows[0] > 0) {
        for (int base = ubase - 1; base >= 0; base -= 32) {
            const int u = base - lane;
            bool stop = true;
            if (u >= 0) {
                const int2 ve = sub_tile(a, u);
                stop = !(ve.x > 0 && ve.y == t.sexp[0]);
            }
            const unsigned m = __ballot_sync(0xffffffffu, stop);
            if (m) {
                s0 = base - (__ffs(m) - 1) + 1;
                break;
            }
            s0 = base - 31;
        }
    }
    if (lane != 0) return;
    t.nruns = 0;
    t.last = 0;
    int seg = s0;
    for (int i = 0; i < R; ++i) {
        if (t.srows[i] <= 0) continue;
        if (i > 0 && !(t.srows[i - 1] > 0 && t.sexp[i - 1] == t.sexp[i]))
            seg = ubase + i;
        if ((ubase + i - seg) % R) continue;
        int j = i;
        while (j + 1 < i + R && t.srows[j + 1] > 0 &&
               t.sexp[j + 1] == t.sexp[i])
            ++j;
        const int vl = ((j - i) * kSub + t.srows[j] + 7) / 8 * 8;
        t.runs[t.nruns++] = Run{(ubase + i) * kSub, (j - i + 1) * kSub, vl,
                                t.sexp[i], n_select<BN>(vl), i};
    }
}

// out^T = W^T x^T on a block of 128 weight columns (n0 = its column block
// x 128) and BN token columns. grid: K2 (column blocks x splits, windows of
// BN tokens); K3 (column blocks, windows of run_tiles sub-tiles). Maps:
// tcodes over the codes [slabs, rows, Np] uint8 (boxes of 64 or 32 lines x
// 128 columns, 128-byte swizzle), tscale over the scales [slabs, K/G, Np]
// fp32 (boxes of scale_rows x 128), tx64 / tx8 over x [1, rows, K] bf16
// (boxes of 64 / 8 rows x 64 k, 128-byte swizzle).
template <int FMT, int BN, bool GROUPED>
__device__ __forceinline__ void tc_body(const CUtensorMap* tcodes,
                                        const CUtensorMap* tscale,
                                        const CUtensorMap* tx64,
                                        const CUtensorMap* tx8,
                                        const TcArgs& a) {
    extern __shared__ uint8_t smem_raw[];
    uint8_t* wtiles = align1024(smem_raw);
    RunTable& table = *reinterpret_cast<RunTable*>(wtiles + 4 * kWTile);
    uint8_t* ring = wtiles + 4 * kWTile + 1024;
    uint64_t* full =
        reinterpret_cast<uint64_t*>(ring + a.stages * a.stage_bytes);
    uint64_t* empty = full + a.stages;

    const int tid = threadIdx.x;
    const int cb = blockIdx.x / a.splits, split = blockIdx.x % a.splits;
    const int n0 = cb * kTcCols;
    const int nk = (a.K + kTcDepth - 1) / kTcDepth;
    const int js = split * a.ks, je = min(nk, js + a.ks);
    if (tid == 0) {
        for (int s = 0; s < a.stages; ++s) {
            bar_init(&full[s], 1);
            bar_init(&empty[s], 8);           // the consumer warps
        }
        bar_init_fence();
    }
    if (tid < 32) build_runs<BN, GROUPED>(a, table, tid);
    __syncthreads();
    // warp-uniform as ptxas sees them (the runs loop holds the wgmma)
    const int nruns = __shfl_sync(0xffffffffu, table.nruns, 0);
    const int warp_id = __shfl_sync(0xffffffffu, tid / 32, 0);

    if (warp_id >= kTcConsumers / 32) {       // the producer
        if (TcShape<BN>::kHandOver) reg_dealloc<kProducerRegs>();
        if (tid == kTcConsumers) {
            const int xbytes = BN * kLine;
            int it = 0;
            for (int r = 0; r < nruns; ++r) {
                const Run run = table.runs[r];
                const int x64 = run.vload / 64, x8 = run.vload % 64 / 8;
                const uint32_t bytes = a.code_bytes + x64 * 64 * kLine +
                                       x8 * 8 * kLine +
                                       a.scale_rows * kScaleRow;
                for (int j = js; j < je; ++j, ++it) {
                    const int s = it % a.stages;
                    bar_wait(&empty[s], ((it / a.stages) & 1) ^ 1);
                    bar_arrive_tx(&full[s], bytes);
                    uint8_t* st = ring + s * a.stage_bytes;
                    const int k0 = j * kTcDepth;
                    tma_load_3d(st, tcodes, &full[s], n0,
                                FMT == kInt4 ? k0 / 2 : k0, run.expert);
                    uint8_t* xs = st + a.code_bytes;
                    for (int b = 0; b < x64; ++b)
                        tma_load_3d(xs + b * 64 * kLine, tx64, &full[s], k0,
                                    run.row0 + 64 * b, 0);
                    for (int b = 0; b < x8; ++b)
                        tma_load_3d(xs + (64 * x64 + 8 * b) * kLine, tx8,
                                    &full[s], k0, run.row0 + 64 * x64 + 8 * b,
                                    0);
                    tma_load_3d(xs + xbytes, tscale, &full[s], n0,
                                k0 / a.G, run.expert);
                }
            }
        }
        return;
    }

    if (TcShape<BN>::kHandOver) reg_alloc<kConsumerRegs>();
    const int wg = warp_id / 4;
    const int lt = tid % 128, warp = warp_id % 4, lane = tid % 32;
    // K3: sub-tiles of the window without routed rows are zeros
    if (GROUPED) {
        for (int i = 0; i < a.run_tiles; ++i) {
            if (table.srows[i] != 0) continue;
            const size_t row = size_t(blockIdx.y * a.run_tiles + i) * kSub;
            for (int e = tid; e < kSub * kTcCols / 8; e += kTcConsumers)
                *reinterpret_cast<uint4*>(a.out + (row + e / 16) * a.Np +
                                          n0 + (e % 16) * 8) =
                    make_uint4(0, 0, 0, 0);
        }
    }

    float acc[BN / 2];
    int it = 0;
    for (int r = 0; r < nruns; ++r) {
        const Run run = table.runs[r];
        const int nsel = __shfl_sync(0xffffffffu, run.nsel, 0);
#pragma unroll
        for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
        int gb = js * kTcDepth / a.G, nextb = (gb + 1) * a.G, cg = -1;
        float sc[16];
        for (int j = js; j < je; ++j, ++it) {
            const int k0 = j * kTcDepth;
            while (k0 >= nextb) {
                ++gb;
                nextb += a.G;
            }
            const int s = it % a.stages;
            bar_wait(&full[s], (it / a.stages) & 1);
            const uint32_t st = smem_u32(ring + s * a.stage_bytes);
            const uint32_t wt =
                smem_u32(wtiles + ((it & 1) * 2 + wg) * kWTile);
            widen_stage<FMT>(st, st + a.code_bytes + BN * kLine, wt, k0, gb,
                             nextb, a.G, wg, lt, cg, sc);
            fence_proxy_async();
            named_bar_sync(1 + wg, 128);
            wgmma_fence();
            mma_stage<BN>(acc, wt, st + a.code_bytes, nsel);
            wgmma_commit();
            wgmma_wait<1>();                  // the previous stage's products
            if (j > js && lane == 0)
                bar_arrive(&empty[(it - 1) % a.stages]);
        }
        wgmma_wait<0>();
        reg_fence(acc);
        if (je > js && lane == 0) bar_arrive(&empty[(it - 1) % a.stages]);

        if (!GROUPED && a.splits > 1) {
            // this split's fragment, then the last block of the column
            // range sums every split's in split order
            float4* mine = reinterpret_cast<float4*>(
                a.ws + (size_t(blockIdx.x) * kTcConsumers + tid) * (BN / 2));
#pragma unroll
            for (int i = 0; i < BN / 8; ++i)
                mine[i] = make_float4(acc[4 * i], acc[4 * i + 1],
                                      acc[4 * i + 2], acc[4 * i + 3]);
            __threadfence();
            named_bar_sync(3, kTcConsumers);
            if (tid == 0)
                table.last =
                    atomicAdd(&a.counters[cb], 1) == a.splits - 1 ? 1 : 0;
            named_bar_sync(3, kTcConsumers);
            if (!table.last) return;
            __threadfence();
#pragma unroll
            for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
            for (int sp = 0; sp < a.splits; ++sp) {
                const float4* part = reinterpret_cast<const float4*>(
                    a.ws + (size_t(cb * a.splits + sp) * kTcConsumers + tid) *
                               (BN / 2));
#pragma unroll
                for (int i = 0; i < BN / 8; ++i) {
                    const float4 v = __ldcg(part + i);
                    acc[4 * i] += v.x;
                    acc[4 * i + 1] += v.y;
                    acc[4 * i + 2] += v.z;
                    acc[4 * i + 3] += v.w;
                }
            }
            if (tid == 0) a.counters[cb] = 0;   // ready for the next launch
        }

        // epilogue: thread holds weight columns c0 and c0 + 8, token
        // columns 8 c + 2 (lane % 4) and the next, of each chunk c
        const int c0 = n0 + 64 * wg + 16 * warp + lane / 4;
#pragma unroll
        for (int c = 0; c < BN / 8; ++c) {
#pragma unroll
            for (int tt = 0; tt < 2; ++tt) {
                const int j = 8 * c + 2 * (lane % 4) + tt;
                if (j >= run.ntok) continue;
                bool ok = 8 * c < nsel;
                if (GROUPED)
                    ok = ok && j % kSub < table.srows[run.u0 + j / kSub];
                bf16* o = a.out + size_t(run.row0 + j) * a.Np + c0;
                o[0] = __float2bfloat16(ok ? acc[4 * c + tt] : 0.f);
                o[8] = __float2bfloat16(ok ? acc[4 * c + 2 + tt] : 0.f);
            }
        }
    }
}

// K2 (qmm_tc_kernel) and K3 (qgmm_tc_kernel): one body, two names, so a
// profile tells the two apart
template <int FMT, int BN>
__global__ void __launch_bounds__(TcShape<BN>::kThreads,
                                  TcShape<BN>::kMinBlocks)
qmm_tc_kernel(const __grid_constant__ CUtensorMap tcodes,
              const __grid_constant__ CUtensorMap tscale,
              const __grid_constant__ CUtensorMap tx64,
              const __grid_constant__ CUtensorMap tx8, const TcArgs a) {
    tc_body<FMT, BN, false>(&tcodes, &tscale, &tx64, &tx8, a);
}

template <int FMT, int BN>
__global__ void __launch_bounds__(TcShape<BN>::kThreads,
                                  TcShape<BN>::kMinBlocks)
qgmm_tc_kernel(const __grid_constant__ CUtensorMap tcodes,
               const __grid_constant__ CUtensorMap tscale,
               const __grid_constant__ CUtensorMap tx64,
               const __grid_constant__ CUtensorMap tx8, const TcArgs a) {
    tc_body<FMT, BN, true>(&tcodes, &tscale, &tx64, &tx8, a);
}

// ---------------------------------------------------------------------------
// host: tensor maps (cached), launches
// ---------------------------------------------------------------------------

// every map of the wgmma route, kept across calls: the codes and scales of
// a weight are static, and the caching allocator hands x the same address
// from step to step. A map holds the address and the shape only, so a hit
// is exact.
struct MapKey {
    const void* base;
    int dtype, d0, d1, d2, b0, b1, swizzle;
    bool operator==(const MapKey& o) const {
        return base == o.base && dtype == o.dtype && d0 == o.d0 &&
               d1 == o.d1 && d2 == o.d2 && b0 == o.b0 && b1 == o.b1 &&
               swizzle == o.swizzle;
    }
};
struct MapKeyHash {
    size_t operator()(const MapKey& k) const {
        size_t h = reinterpret_cast<size_t>(k.base);
        for (int v : {k.dtype, k.d0, k.d1, k.d2, k.b0, k.b1, k.swizzle})
            h = h * 1000003u ^ size_t(unsigned(v));
        return h;
    }
};
constexpr size_t kMapCacheMax = 8192;
std::unordered_map<MapKey, CUtensorMap, MapKeyHash> g_maps;
std::mutex g_map_mu;

// the map of a contiguous [d2, d1, d0] tensor of `dtype` read in boxes of
// {b0, b1, 1}; what lies past the tensor reads as zeros. Returns 0, or
// 1000 + the CUresult of the encoding.
int cached_map(CUtensorMap* out, CUtensorMapDataType dtype, int elem,
               const void* base, int d0, int d1, int d2, int b0, int b1,
               CUtensorMapSwizzle swizzle) {
    const MapKey key{base, int(dtype), d0, d1, d2, b0, b1, int(swizzle)};
    std::lock_guard<std::mutex> lock(g_map_mu);
    auto hit = g_maps.find(key);
    if (hit != g_maps.end()) {
        *out = hit->second;
        return 0;
    }
    const EncodeTiledFn fn = encode_fn();
    if (fn == nullptr) return 1000 + int(CUDA_ERROR_NOT_FOUND);
    const cuuint64_t dims[3] = {cuuint64_t(d0), cuuint64_t(d1),
                                cuuint64_t(d2)};
    const cuuint64_t strides[2] = {cuuint64_t(d0) * elem,
                                   cuuint64_t(d0) * d1 * elem};
    const cuuint32_t box[3] = {cuuint32_t(b0), cuuint32_t(b1), 1};
    const cuuint32_t step[3] = {1, 1, 1};
    CUtensorMap map;
    const CUresult r = fn(&map, dtype, 3, const_cast<void*>(base), dims,
                          strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                          swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (r != CUDA_SUCCESS) return 1000 + int(r);
    if (g_maps.size() >= kMapCacheMax) g_maps.clear();
    g_maps.emplace(key, map);
    *out = map;
    return 0;
}

// scale rows a stage of 64 k lines (starting at a multiple of 64) touches
int scale_rows_of(int G) { return G % kTcDepth == 0 ? 1 : 63 / G + 2; }

int code_bytes_of(int fmt) {
    return fmt == kInt4 ? kTcDepth / 2 * kLine : kTcDepth * kLine;
}

int stage_bytes_of(int fmt, int bn, int G) {
    const int b = code_bytes_of(fmt) + bn * kLine + scale_rows_of(G) * kScaleRow;
    return (b + 1023) / 1024 * 1024;
}

// the ring's stages: as many as the block's share of shared memory holds,
// at most kMaxStages; 0 when not even two fit
int stages_of(int fmt, int bn, int G) {
    const int budget = bn <= 64 ? kTcBudget2 : kTcBudget1;
    const int s = (budget - kTcFixed - 16 * kMaxStages) /
                  stage_bytes_of(fmt, bn, G);
    return s < 2 ? 0 : (s > kMaxStages ? kMaxStages : s);
}

size_t smem_of(int stages, int stage_bytes) {
    return size_t(kTcFixed) + size_t(stages) * stage_bytes + 16 * stages;
}

template <int FMT, int BN, bool GROUPED>
int run_tc(const CUtensorMap (&m)[4], const TcArgs& a, dim3 grid,
           cudaStream_t st) {
    auto kern = GROUPED ? qgmm_tc_kernel<FMT, BN> : qmm_tc_kernel<FMT, BN>;
    static bool ready = false;
    if (!ready) {
        const cudaError_t e = cudaFuncSetAttribute(
            kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kTcBudget1);
        if (e != cudaSuccess) return int(e);
        ready = true;
    }
    kern<<<grid, TcShape<BN>::kThreads, smem_of(a.stages, a.stage_bytes),
           st>>>(m[0], m[1], m[2], m[3], a);
    return int(cudaGetLastError());
}

// K2 takes every BN; K3 32 x run_tiles
template <int FMT, bool GROUPED>
int run_tc_bn(int bn, const CUtensorMap (&m)[4], const TcArgs& a, dim3 grid,
              cudaStream_t st) {
    switch (bn) {
        case 8: if (!GROUPED) return run_tc<FMT, 8, false>(m, a, grid, st);
            break;
        case 16: if (!GROUPED) return run_tc<FMT, 16, false>(m, a, grid, st);
            break;
        case 32: return run_tc<FMT, 32, GROUPED>(m, a, grid, st);
        case 64: return run_tc<FMT, 64, GROUPED>(m, a, grid, st);
        case 128: return run_tc<FMT, 128, GROUPED>(m, a, grid, st);
        case 256: return run_tc<FMT, 256, GROUPED>(m, a, grid, st);
        default: break;
    }
    return int(cudaErrorInvalidValue);
}

template <bool GROUPED>
int run_tc_fmt(int fmt, int bn, const CUtensorMap (&m)[4], const TcArgs& a,
               dim3 grid, cudaStream_t st) {
    switch (fmt) {
        case kInt8: return run_tc_bn<kInt8, GROUPED>(bn, m, a, grid, st);
        case kInt4: return run_tc_bn<kInt4, GROUPED>(bn, m, a, grid, st);
        case kE4M3: return run_tc_bn<kE4M3, GROUPED>(bn, m, a, grid, st);
        default: return int(cudaErrorInvalidValue);
    }
}

// the maps and the launch of either product on the wgmma route; codes and
// scale already point at the selected layer's slab(s)
int launch_tc(const void* x, const uint8_t* codes, const float* scale,
              TcArgs a, int fmt, int bn, int slabs, bool grouped, dim3 grid,
              cudaStream_t st) {
    a.code_bytes = code_bytes_of(fmt);
    a.scale_rows = scale_rows_of(a.G);
    a.stage_bytes = stage_bytes_of(fmt, bn, a.G);
    a.stages = stages_of(fmt, bn, a.G);
    if (a.stages == 0) return int(cudaErrorInvalidValue);
    const cudaError_t bound = bind_context();
    if (bound != cudaSuccess) return int(bound);
    const int crows = fmt == kInt4 ? a.K / 2 : a.K;
    CUtensorMap m[4];
    int r = cached_map(&m[0], CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, codes, a.Np,
                       crows, slabs, kTcCols,
                       fmt == kInt4 ? kTcDepth / 2 : kTcDepth,
                       CU_TENSOR_MAP_SWIZZLE_128B);
    if (!r)
        r = cached_map(&m[1], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, scale,
                       a.Np, a.K / a.G, slabs, kTcCols, a.scale_rows,
                       CU_TENSOR_MAP_SWIZZLE_NONE);
    if (!r)
        r = cached_map(&m[2], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, a.K,
                       a.rows, 1, 64, 64, CU_TENSOR_MAP_SWIZZLE_128B);
    if (!r)
        r = cached_map(&m[3], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, a.K,
                       a.rows, 1, 64, 8, CU_TENSOR_MAP_SWIZZLE_128B);
    if (r) return r;
    return grouped ? run_tc_fmt<true>(fmt, bn, m, a, grid, st)
                   : run_tc_fmt<false>(fmt, bn, m, a, grid, st);
}

bool bad_bn(int bn) {
    return bn != 8 && bn != 16 && bn != 32 && bn != 64 && bn != 128 &&
           bn != 256;
}

// the fp32 decode form's launch
template <int FMT, int MR>
cudaError_t launch_decode(const float* x, const uint8_t* codes,
                          const float* sc, float* out, float* ws, int M,
                          int K, int Np, int G, int KB, int splits,
                          cudaStream_t st) {
    constexpr int kMaxDecodeSmem = 32 * 1024;
    const size_t xf = size_t(MR) * KB, rf = size_t(kDecWarps) * MR * kDecCols;
    const size_t smem = (xf > rf ? xf : rf) * sizeof(float);
    if (smem > size_t(kMaxDecodeSmem) || KB % 2) return cudaErrorInvalidValue;
    dim3 grid(Np / kDecCols, splits);
    qmm_decode_kernel<FMT, MR><<<grid, kDecThreads, smem, st>>>(
        x, codes, sc, out, splits > 1 ? ws : nullptr, M, K, Np, G, KB);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess || splits <= 1) return err;
    const size_t elems = size_t(M) * Np;
    qmm_reduce_kernel<<<unsigned((elems + 255) / 256), 256, 0, st>>>(
        ws, out, splits, elems);
    return cudaGetLastError();
}

template <int FMT>
cudaError_t dispatch_f32(const float* x, const uint8_t* codes,
                         const float* sc, float* out, float* ws, int M,
                         int K, int Np, int G, int decode, int MR, int KB,
                         int splits, cudaStream_t st) {
    if (!decode) {
        dim3 grid(Np / kBN, (M + kBM - 1) / kBM);
        qmm_tile_kernel<FMT><<<grid, kTileThreads, 0, st>>>(x, codes, sc, out,
                                                            M, K, Np, G);
        return cudaGetLastError();
    }
    if (M > MR || splits < 1 || KB < 2) return cudaErrorInvalidValue;
    switch (MR) {
        case 1: return launch_decode<FMT, 1>(x, codes, sc, out, ws, M, K, Np,
                                             G, KB, splits, st);
        case 2: return launch_decode<FMT, 2>(x, codes, sc, out, ws, M, K, Np,
                                             G, KB, splits, st);
        case 4: return launch_decode<FMT, 4>(x, codes, sc, out, ws, M, K, Np,
                                             G, KB, splits, st);
        case 8: return launch_decode<FMT, 8>(x, codes, sc, out, ws, M, K, Np,
                                             G, KB, splits, st);
        case 16: return launch_decode<FMT, 16>(x, codes, sc, out, ws, M, K,
                                               Np, G, KB, splits, st);
        default: return cudaErrorInvalidValue;
    }
}

}  // namespace

// fp32 x and out (bf16 takes ds_quant_matmul_tc). fmt: 0 = int8, 1 = int4
// (packed K-pairs), 2 = e4m3. `layer` times the strides (in elements of
// codes / scales) selects a stacked slab. decode != 0 takes the decode form
// with row capacity MR (a power of two, 1..16), KB rows of K per block and
// `splits` blocks along K; with splits > 1, `workspace` holds fp32
// [splits, M, Np] partials. Returns the cudaError_t of the launches (0 =
// success); they are asynchronous on `stream`.
extern "C" int ds_quant_matmul(const void* x, const void* codes,
                               const void* scale, void* out, void* workspace,
                               int M, int K, int Np, int G, int fmt,
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
    const float* xf = static_cast<const float*>(x);
    float* of = static_cast<float*>(out);
    float* ws = static_cast<float*>(workspace);
    cudaError_t err;
    switch (fmt) {
        case kInt8: err = dispatch_f32<kInt8>(xf, c, s, of, ws, M, K, Np, G,
                                              decode, MR, KB, splits, st);
            break;
        case kInt4: err = dispatch_f32<kInt4>(xf, c, s, of, ws, M, K, Np, G,
                                              decode, MR, KB, splits, st);
            break;
        case kE4M3: err = dispatch_f32<kE4M3>(xf, c, s, of, ws, M, K, Np, G,
                                              decode, MR, KB, splits, st);
            break;
        default: err = cudaErrorInvalidValue;
    }
    return int(err);
}

// The wgmma route of K2: x [M, K] and out [M, Np] bf16, codes and scales
// as ds_quant_matmul's. bn (8, 16, 32, 64, 128, 256) is a block's token
// columns; `splits` > 1 (only with M <= bn) splits K across that many
// blocks a column range, whose fp32 fragments go to `workspace` (splits x
// Np / 128 x 256 x bn / 2 floats) and whose arrivals `counters` (Np / 128
// ints, zero between launches) count. K is a multiple of 8 (16-byte x
// rows). Returns 0, a cudaError_t, or 1000 + the CUresult of a tensor map
// that cannot be made; the launch is asynchronous on `stream`.
extern "C" int ds_quant_matmul_tc(const void* x, const void* codes,
                                  const void* scale, void* out,
                                  void* workspace, void* counters, int M,
                                  int K, int Np, int G, int fmt, int layer,
                                  long long codes_layer_stride,
                                  long long scale_layer_stride, int bn,
                                  int splits, void* stream) {
    if (M == 0) return 0;
    const int nk = (K + kTcDepth - 1) / kTcDepth;
    if (M < 0 || K <= 0 || K % 8 || Np <= 0 || Np % kTcCols || G <= 0 ||
        K % G || (fmt == kInt4 && G % 2) || layer < 0 || bad_bn(bn) ||
        splits < 1 || splits > nk ||
        (splits > 1 && (M > bn || !workspace || !counters)))
        return int(cudaErrorInvalidValue);
    TcArgs a{};
    a.out = static_cast<bf16*>(out);
    a.ws = static_cast<float*>(workspace);
    a.counters = static_cast<int*>(counters);
    a.rows = M;
    a.K = K;
    a.Np = Np;
    a.G = G;
    a.n = 1;
    a.splits = splits;
    a.ks = (nk + splits - 1) / splits;
    if ((splits - 1) * a.ks >= nk) return int(cudaErrorInvalidValue);
    a.run_tiles = 1;
    const dim3 grid(unsigned(Np / kTcCols * splits), unsigned((M + bn - 1) / bn));
    return launch_tc(x,
                     static_cast<const uint8_t*>(codes) +
                         size_t(layer) * size_t(codes_layer_stride),
                     static_cast<const float*>(scale) +
                         size_t(layer) * size_t(scale_layer_stride),
                     a, fmt, bn, 1, false, grid,
                     static_cast<cudaStream_t>(stream));
}

// dynamic shared memory of a wgmma-route launch (fmt, bn, G), and its ring's
// stages through *stages; -1 when it cannot launch
extern "C" int ds_quant_matmul_tc_smem(int fmt, int bn, int G, int* stages) {
    if (bad_bn(bn) || G <= 0 || fmt < 0 || fmt > 2) return -1;
    const int s = stages_of(fmt, bn, G);
    if (stages) *stages = s;
    return s ? int(smem_of(s, stage_bytes_of(fmt, bn, G))) : -1;
}

// The grouped form, fp32: x [Tp, K] and out [Tp, Np]; codes
// [n, K, Np] or [n, K/2, Np] (fmt as above) and scales [n, K/G, Np],
// offset by `layer` times the layer strides (in elements); tile_expert and
// tile_rows int32 [Tp / block_m]. Tp and block_m are multiples of 32, K of
// 8. Returns the cudaError_t of the launch (0 = success); it is
// asynchronous on `stream`.
extern "C" int ds_quant_grouped_matmul(
        const void* x, const void* codes, const void* scale,
        const void* tile_expert, const void* tile_rows, void* out, int Tp,
        int K, int Np, int G, int n, int block_m, int fmt, int layer,
        long long codes_layer_stride, long long scale_layer_stride,
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
    const float* xf = static_cast<const float*>(x);
    const int* te = static_cast<const int*>(tile_expert);
    const int* tr = static_cast<const int*>(tile_rows);
    float* of = static_cast<float*>(out);
    dim3 grid(Np / kGCols, Tp / kGRows);
    switch (fmt) {
        case kInt8: qgmm_f32_kernel<kInt8><<<grid, kGThreads, 0, st>>>(
            xf, c, s, te, tr, of, K, Np, G, n, block_m); break;
        case kInt4: qgmm_f32_kernel<kInt4><<<grid, kGThreads, 0, st>>>(
            xf, c, s, te, tr, of, K, Np, G, n, block_m); break;
        case kE4M3: qgmm_f32_kernel<kE4M3><<<grid, kGThreads, 0, st>>>(
            xf, c, s, te, tr, of, K, Np, G, n, block_m); break;
        default: return int(cudaErrorInvalidValue);
    }
    return int(cudaGetLastError());
}

// The wgmma route of K3: x [Tp, K] and out [Tp, Np] bf16, the rest as
// ds_quant_grouped_matmul's; run_tiles (1, 2, 4, 8) 32-row sub-tiles a
// window, a block's token columns at most 32 x run_tiles. Returns 0, a
// cudaError_t, or 1000 + the CUresult of a tensor map that cannot be made;
// the launch is asynchronous on `stream`.
extern "C" int ds_quant_grouped_matmul_tc(
        const void* x, const void* codes, const void* scale,
        const void* tile_expert, const void* tile_rows, void* out, int Tp,
        int K, int Np, int G, int n, int block_m, int fmt, int layer,
        long long codes_layer_stride, long long scale_layer_stride,
        int run_tiles, void* stream) {
    if (Tp == 0) return 0;
    if (Tp < 0 || K <= 0 || K % 8 || Np <= 0 || Np % kTcCols || G <= 0 ||
        K % G || (fmt == kInt4 && G % 2) || n <= 0 || block_m <= 0 ||
        block_m % kSub || Tp % block_m || layer < 0 ||
        (run_tiles != 1 && run_tiles != 2 && run_tiles != 4 &&
         run_tiles != 8))
        return int(cudaErrorInvalidValue);
    TcArgs a{};
    a.out = static_cast<bf16*>(out);
    a.te = static_cast<const int*>(tile_expert);
    a.tr = static_cast<const int*>(tile_rows);
    a.rows = Tp;
    a.K = K;
    a.Np = Np;
    a.G = G;
    a.n = n;
    a.block_m = block_m;
    a.splits = 1;
    a.ks = (K + kTcDepth - 1) / kTcDepth;
    a.run_tiles = run_tiles;
    const int windows = (Tp / kSub + run_tiles - 1) / run_tiles;
    const dim3 grid(unsigned(Np / kTcCols), unsigned(windows));
    return launch_tc(x,
                     static_cast<const uint8_t*>(codes) +
                         size_t(layer) * size_t(codes_layer_stride),
                     static_cast<const float*>(scale) +
                         size_t(layer) * size_t(scale_layer_stride),
                     a, fmt, kSub * run_tiles, n, true, grid,
                     static_cast<cudaStream_t>(stream));
}

// the name of a cudaError_t the entries return (a code of 1000 and up is
// 1000 + a CUresult of the tensor-map encoder)
extern "C" const char* ds_quant_error_name(int code) {
    if (code >= 1000) return "CUresult of cuTensorMapEncodeTiled";
    return cudaGetErrorName(static_cast<cudaError_t>(code));
}
