// Ragged paged attention over a read-only KV pool plus a staged tail (K1).
//
// Replaces the TPU kernel `_ragged_attn_kernel` of
// deepspeed_tpu/ops/pallas/paged_attention.py (entry `paged_ragged_attention`)
// with all its options: the sliding window, the rolling ring table and the
// tree-verify mask, over a pool of q's dtype (bf16 or fp32) or of e4m3 codes
// (`page_group` is a TPU grid-step knob: no arithmetic of this walk
// depends on it).
//
// What it computes, for each slot s, KV head h and query row r = t*G + g
// (query head h*G + g of chunk token t, at position qpos = q_starts[s] + t,
// or tree_pos[s, t] in tree mode): one online softmax over two key sources,
//   1. the pool, table column j: page block_tables[s, j/bs] of layer
//      `layer_index`, half 0 (K) / 1 (V), offset j % bs. Column j holds key
//      position j, valid below stage_starts[s]; under a rolling ring
//      (`ring_tokens`) it holds the newest block b_j = b_latest -
//      (b_latest - j/bs) mod nwin, b_latest = max(stage_starts-1, 0)/bs, at
//      raw position b_j*bs + j%bs, minus ring_tokens where that is at or past
//      stage_starts, invalid where < 0;
//   2. the stage, stage row i at key position stage_starts[s] + i, valid
//      while < seq_lens[s]; in tree mode stage row i is tree node i, visible
//      to node t where tree_mask[s, t, i] != 0 (rows past T never).
// Keys are masked by position c <= qpos and, with a `window`, c > qpos -
// window (tree-mode stage columns take the tree mask alone, as the TPU
// kernel does: siblings share a position). Running max m, sum l and
// accumulator acc are fp32;
// scores are the fp32 dot times `scale`; p is rounded to V's dtype before the
// PV product while l sums the unrounded p (the TPU kernel's numerics). The
// output is acc / l, or zeros for a row that saw no key (an empty slot).
//
// The e4m3-pool form (`kv_cache_dtype="fp8"`) keeps the TPU kernel's algebra
// for it (`p_scale` and the q cast of `_ragged_attn_kernel`): pool keys score
// against q rounded to e4m3; p is multiplied by 448 (e4m3's largest value,
// so long-context weights stay out of its subnormal range) for every key,
// pool and stage alike, l sums that scaled p, and p is rounded to e4m3 for
// the pool keys' PV product and to q's dtype for the stage keys'. Pool pages
// are read as one byte per element and widened to q's dtype in shared
// memory, which is exact. Casts to e4m3 follow `__NV_NOSAT` (NaN past the
// range, as JAX's cast), though q and p never exceed 448.
//
// What bounds it on an H100: the bytes of K/V it reads. A decode step reads
// every live page of every slot once per KV head and does ~2 operations per
// byte, far below the card's ~295 bf16 operations per byte. Prefill chunks
// reuse each page across up to 16 query rows per block, which moves them
// towards the operation bound of this scalar (CUDA-core) form.
//
// What the design does about it:
// - One thread block per (slot, KV head, tile of 16 query rows) walks all of
//   its keys in a loop inside the block; blocks are independent, so no
//   softmax state crosses blocks (the TPU grid carried it across steps).
// - All G query heads of a KV head sit in the block's row tile, so each K/V
//   tile is read from device memory once per KV head, not once per query
//   head (the TPU kernel's GQA layout).
// - Keys are walked in tiles of 64 key positions gathered through the block
//   table, whatever the page size, with 16-byte loads; the q tile, the K/V
//   tile and the score tile sit in shared memory (K rows padded so a warp
//   reading 32 rows at one column hits 32 banks).
// - Keys past a tile's last query position and past seq_lens are never
//   loaded, so a chunk reads only the causal triangle it needs; with a
//   window, pool and stage tiles wholly before the block's lowest visible
//   position are skipped (the walk starts at a multiple of 64 columns, so
//   the e4m3 form's rounding max per tile stays the plain version's), and a
//   ring tile whose keys no row sees is skipped whole. Every key's position
//   is computed once per tile into shared memory; keys no row of the block
//   sees are not loaded.
// - The ring is walked in table order (column 0 up), never in position
//   order: the e4m3 form rounds p against the running max of the walk.
// - Tree mode walks every stage row below T whenever seq_lens[s] > 0 (a
//   branchy tree has more nodes than its depth, so seq_lens undercounts
//   them); the mask is read from device memory, a byte per (node, node).
// A split-K (flash-decoding) grid, cp.async/TMA double buffering and wgmma
// are later work; this form is the simple, correct one.
//
// The same source holds K7 (`paged_attn_kernel`, entry `ds_paged_attention`),
// which replaces `_paged_attn_kernel` of the same Pallas file (entries
// `paged_prefill_attention` and `paged_decode_attention`): query rows at
// starts[s] + t against separate K and V pools [KV, P, D] into which the
// chunk's K/V are already scattered; no stage, e4m3 or tree form. It walks
// the pages the Pallas grid runs (linear: below seq_lens and, with a window,
// not wholly before the chunk's first window; ring: every slot holding a
// block >= 0) on K1's tiles, and keeps the Pallas kernel's online softmax
// as it is: no guard, masked scores at float's lowest finite value, so a row
// that sees no key on a walked page averages that page's values until its
// first visible key wipes them (alpha = 0), and keeps them if none comes.
//
// Built with `nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
// -Xcompiler -fPIC` into a plain C library (deepspeed_tpu_torch/ops/kernels.py)
// and called through ctypes.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <float.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 128;   // 4 warps
constexpr int kRows = 16;       // query rows per block
constexpr int kKeys = 64;       // key positions per tile
constexpr int kInvalid = INT_MIN;   // a key no row of the block sees

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

__device__ __forceinline__ float e4m3_to_f(__nv_fp8_storage_t b) {
    const __half_raw h = __nv_cvt_fp8_to_halfraw(b, __NV_E4M3);
    return __half2float(__half(h));
}
// x rounded to e4m3 (nearest even; NaN past the range) and read back
__device__ __forceinline__ float e4m3_round(float x) {
    return e4m3_to_f(__nv_cvt_float_to_fp8(x, __NV_NOSAT, __NV_E4M3));
}
// 16 / sizeof(T) e4m3 codes at p, widened to T and packed into 16 bytes
template <typename T>
__device__ __forceinline__ uint4 widen_e4m3(const uint8_t* p) {
    constexpr int N = 16 / sizeof(T);
    uint32_t w[2] = {0u, 0u};
    if constexpr (N == 8) {
        const uint2 v = *reinterpret_cast<const uint2*>(p);
        w[0] = v.x;
        w[1] = v.y;
    } else {
        w[0] = *reinterpret_cast<const uint32_t*>(p);
    }
    uint4 r;
    T* e = reinterpret_cast<T*>(&r);
#pragma unroll
    for (int i = 0; i < N; ++i)
        e[i] = from_f<T>(e4m3_to_f(
            static_cast<__nv_fp8_storage_t>(w[i / 4] >> (8 * (i % 4)))));
    return r;
}

// K rows in shared memory carry 4 bytes of padding: an odd row stride in
// 4-byte words spreads 32 rows read at one column over the 32 banks
template <typename T> struct Pad { static constexpr int value = 4 / sizeof(T); };

template <typename T, bool FP8, int D>
struct Smem {
    static constexpr int kStride = D + Pad<T>::value;   // K row stride (elems)
    // q, and for an e4m3 pool a second copy rounded to e4m3 (fp32 both)
    static constexpr size_t q_bytes =
        size_t(FP8 ? 2 : 1) * kRows * D * sizeof(float);
    static constexpr size_t sc_bytes = size_t(kRows) * kKeys * sizeof(float);
    static constexpr size_t stat_bytes = 3 * kRows * sizeof(float);
    // each query row's position and each key of the tile's (16-byte sum)
    static constexpr size_t pos_bytes = size_t(kRows + kKeys) * sizeof(int);
    static constexpr size_t v_bytes = size_t(kKeys) * D * sizeof(T);
    static constexpr size_t k_bytes = size_t(kKeys) * kStride * sizeof(T);
    static constexpr size_t head =
        q_bytes + sc_bytes + stat_bytes + pos_bytes;   // v_s starts here
    static constexpr size_t total = head + v_bytes + k_bytes;
};

// two neighbouring elements of a shared-memory row as floats, one 4-byte
// read for bf16
__device__ __forceinline__ float2 load_pair(const float* p) {
    return make_float2(p[0], p[1]);
}
__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* p) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// q . k of one tile: thread owns key j = tid % kKeys and rows
// sr + i*SSTEP (sr = tid / kKeys) for i < NR
template <typename T, int D, int NR>
__device__ __forceinline__ void tile_dots(const float* q_s, const T* k_s,
                                          float (&dot)[NR]) {
    constexpr int SSTEP = kThreads / kKeys;
    constexpr int KS = D + Pad<T>::value;
    const int tid = threadIdx.x;
    const int j = tid % kKeys, sr = tid / kKeys;
#pragma unroll
    for (int i = 0; i < NR; ++i) dot[i] = 0.f;
    const T* krow = k_s + j * KS;
#pragma unroll 4
    for (int d = 0; d < D; d += 2) {
        const float2 kk = load_pair(krow + d);
#pragma unroll
        for (int i = 0; i < NR; ++i) {
            const float2 qq = *reinterpret_cast<const float2*>(
                q_s + (sr + i * SSTEP) * D + d);
            dot[i] = fmaf(qq.x, kk.x, dot[i]);
            dot[i] = fmaf(qq.y, kk.y, dot[i]);
        }
    }
}

// scores of one tile: thread owns key j = tid % kKeys and rows
// sr + i*SSTEP (sr = tid / kKeys) for i < NR; masked entries are -inf.
// Row ri sees key j where kpos_s[j] <= qpos_s[ri] (and > qpos_s[ri] -
// window with a window), or — for a tree-mode stage tile, `tmask` the
// slot's [T, T] mask and `col0` the tile's first stage row — where
// tmask[t, col0 + j] is set for the row's node t.
template <typename T, int D, int NR>
__device__ __forceinline__ void tile_scores(const float* q_s, const T* k_s,
                                            float* sc, int nrows,
                                            const int* qpos_s,
                                            const int* kpos_s, int window,
                                            const uint8_t* tmask, int T_,
                                            int col0, int row0, int G,
                                            float scale) {
    constexpr int SSTEP = kThreads / kKeys;
    const int tid = threadIdx.x;
    const int j = tid % kKeys, sr = tid / kKeys;
    float dot[NR];
    tile_dots<T, D, NR>(q_s, k_s, dot);
    const int kp = kpos_s[j];
#pragma unroll
    for (int i = 0; i < kRows / SSTEP; ++i) {
        const int ri = sr + i * SSTEP;
        bool ok = i < NR && ri < nrows && kp != kInvalid;
        if (ok && tmask != nullptr) {
            const int col = col0 + j;
            ok = col < T_ && tmask[((row0 + ri) / G) * T_ + col] != 0;
        } else if (ok) {
            const int qp = qpos_s[ri];
            ok = kp <= qp && (window <= 0 || kp > qp - window);
        }
        sc[ri * kKeys + j] = ok ? dot[i < NR ? i : 0] * scale : -INFINITY;
    }
}

// acc[i] = acc[i] * alpha + p @ V for the thread's first NR row slots
// (rows rg + i*RSTEP); columns c0 + cc*COLS
template <typename T, int D, int NR, int RPT>
__device__ __forceinline__ void tile_pv(
        float (&acc)[RPT][D < kThreads ? 1 : D / kThreads], const T* v_s,
        const float* sc, const float* a_s, int len) {
    constexpr int COLS = D < kThreads ? D : kThreads;
    constexpr int RSTEP = kThreads / COLS;
    constexpr int CPT = D / COLS;
    const int tid = threadIdx.x;
    const int c0 = tid % COLS, rg = tid / COLS;
#pragma unroll
    for (int i = 0; i < NR; ++i) {
        const float alpha = a_s[rg + i * RSTEP];
#pragma unroll
        for (int cc = 0; cc < CPT; ++cc) acc[i][cc] *= alpha;
    }
    for (int j = 0; j < len; ++j) {
        float v[CPT];
#pragma unroll
        for (int cc = 0; cc < CPT; ++cc)
            v[cc] = to_f(v_s[j * D + c0 + cc * COLS]);
#pragma unroll
        for (int i = 0; i < NR; ++i) {
            const float p = sc[(rg + i * RSTEP) * kKeys + j];
#pragma unroll
            for (int cc = 0; cc < CPT; ++cc)
                acc[i][cc] = fmaf(p, v[cc], acc[i][cc]);
        }
    }
}

// P: the pool's element type, T itself or the e4m3 byte
template <typename T, bool FP8, int D>
__global__ void __launch_bounds__(kThreads)
ragged_paged_attn_kernel(const T* __restrict__ q,
                         const std::conditional_t<FP8, uint8_t, T>* __restrict__
                             pool,
                         const T* __restrict__ k_stage,
                         const T* __restrict__ v_stage,
                         const int* __restrict__ block_tables,
                         const int* __restrict__ seq_lens,
                         const int* __restrict__ q_starts,
                         const int* __restrict__ stage_starts,
                         const int* __restrict__ tree_pos,
                         const uint8_t* __restrict__ tree_mask,
                         T* __restrict__ out, int T_, int H, int KV, int nb,
                         int bs, int Ts, int max_pages, int layer, float scale,
                         int window, int ring_tokens) {
    using S = Smem<T, FP8, D>;
    using P = std::conditional_t<FP8, uint8_t, T>;
    constexpr int VEC = 16 / sizeof(T);          // elements per 16-byte load
    constexpr int VPR = D / VEC;                 // 16-byte vectors per row
    constexpr int COLS = D < kThreads ? D : kThreads;
    constexpr int RSTEP = kThreads / COLS;       // row groups in the PV loop
    constexpr int CPT = D / COLS;                // columns per thread
    constexpr int RPT = kRows / RSTEP;           // rows per thread (PV)
    constexpr int SSTEP = kThreads / kKeys;      // row groups in the score loop
    constexpr int SRPT = kRows / SSTEP;          // rows per thread (scores)

    extern __shared__ __align__(16) unsigned char smem[];
    float* q_s = reinterpret_cast<float*>(smem);
    float* q8_s = q_s + kRows * D;      // e4m3-rounded q (FP8 only)
    float* sc = reinterpret_cast<float*>(smem + S::q_bytes);
    float* m_s = reinterpret_cast<float*>(smem + S::q_bytes + S::sc_bytes);
    float* l_s = m_s + kRows;
    float* a_s = l_s + kRows;
    int* qpos_s = reinterpret_cast<int*>(a_s + kRows);
    int* kpos_s = qpos_s + kRows;
    T* v_s = reinterpret_cast<T*>(smem + S::head);
    T* k_s = reinterpret_cast<T*>(smem + S::head + S::v_bytes);

    const int tid = threadIdx.x;
    const int h = blockIdx.y;
    const int s = blockIdx.z;
    const int G = H / KV;
    const int TG = T_ * G;
    const int row0 = blockIdx.x * kRows;
    const int nrows = min(kRows, TG - row0);
    const bool tree = tree_pos != nullptr;

    const int seq_len = seq_lens[s];
    const int qstart = q_starts[s];
    const int sstart = stage_starts[s];

    // ---- q tile -> shared (fp32), rows t*G + g of head h*G + g ----------
    for (int idx = tid; idx < kRows * VPR; idx += kThreads) {
        const int i = idx / VPR, dv = (idx % VPR) * VEC;
        float* dst = q_s + i * D + dv;
        if (i < nrows) {
            const int r = row0 + i, t = r / G, g = r % G;
            const T* src = q + ((size_t(s) * T_ + t) * H + size_t(h) * G + g) *
                                   D + dv;
            uint4 raw = *reinterpret_cast<const uint4*>(src);
            const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
            for (int k = 0; k < VEC; ++k) dst[k] = to_f(e[k]);
            if constexpr (FP8) {
#pragma unroll
                for (int k = 0; k < VEC; ++k)
                    dst[kRows * D + k] = e4m3_round(dst[k]);
            }
        } else {
#pragma unroll
            for (int k = 0; k < VEC; ++k) dst[k] = 0.f;
            if constexpr (FP8) {
#pragma unroll
                for (int k = 0; k < VEC; ++k) dst[kRows * D + k] = 0.f;
            }
        }
    }
    if (tid < kRows) {
        m_s[tid] = -INFINITY;
        l_s[tid] = 0.f;
        a_s[tid] = 1.f;
        int qp = 0;
        if (tid < nrows) {
            const int t = (row0 + tid) / G;
            qp = tree ? tree_pos[size_t(s) * T_ + t] : qstart + t;
        }
        qpos_s[tid] = qp;
    }

    // PV accumulators: thread owns columns c0 + j*COLS, rows rg + i*RSTEP
    const int c0 = tid % COLS, rg = tid / COLS;
    float acc[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) acc[i][j] = 0.f;

    __syncthreads();
    // the block's lowest and highest query positions bound every key it
    // can see: keys in [qmin - window + 1, qmax] (no lower bound without a
    // window)
    int qmin = INT_MAX, qmax = INT_MIN;
    for (int i = 0; i < nrows; ++i) {
        qmin = min(qmin, qpos_s[i]);
        qmax = max(qmax, qpos_s[i]);
    }
    const int kmin = window > 0 ? qmin - window + 1 : INT_MIN;

    // two key sources, walked in order: pool table columns [pool_lo,
    // pool_hi), stage rows [st_lo, st_hi). A linear table is clipped to
    // the block's last query position (and the table's width: positions
    // past it have no page) and, with a window, starts at the 64-column
    // tile holding its first visible position; a ring is walked whole, in
    // table order. A tree stage is every node row; otherwise the stage is
    // clipped like the pool.
    const bool ring = ring_tokens > 0;
    int pool_lo = 0, pool_hi = 0, st_lo = 0, st_hi = 0;
    if (seq_len > 0) {
        if (ring) {
            pool_hi = sstart > 0 ? max_pages * bs : 0;
        } else {
            pool_hi = min(min(sstart, qmax + 1), max_pages * bs);
            if (window > 0) pool_lo = max(0, kmin) / kKeys * kKeys;
        }
        if (tree) {
            st_hi = min(T_, Ts);
        } else {
            st_hi = min(min(seq_len, sstart + Ts), qmax + 1) - sstart;
            if (window > 0) st_lo = max(0, kmin - sstart) / kKeys * kKeys;
        }
    }
    const int nwin = ring ? ring_tokens / bs : 1;
    const int b_latest = max(sstart - 1, 0) / bs;
    const size_t page_elems = size_t(bs) * D;
    const size_t half_elems = size_t(KV) * nb * page_elems;
    const P* k_pool = pool + (size_t(layer) * 2 * KV + h) * nb * page_elems;
    const P* v_pool = k_pool + half_elems;
    const T* k_st = k_stage + (size_t(s) * KV + h) * Ts * D;
    const T* v_st = v_stage + (size_t(s) * KV + h) * Ts * D;
    const int* table = block_tables + size_t(s) * max_pages;
    const uint8_t* tmask =
        tree ? tree_mask + size_t(s) * T_ * T_ : nullptr;

    const int n_pool_tiles =
        pool_hi > pool_lo ? (pool_hi - pool_lo + kKeys - 1) / kKeys : 0;
    const int n_stage_tiles =
        st_hi > st_lo ? (st_hi - st_lo + kKeys - 1) / kKeys : 0;

    for (int tile = 0; tile < n_pool_tiles + n_stage_tiles; ++tile) {
        const bool in_pool = tile < n_pool_tiles;
        // the tile's first table column (pool) or stage row (stage)
        const int c_begin = in_pool ? pool_lo + tile * kKeys
                                    : st_lo + (tile - n_pool_tiles) * kKeys;
        const int len = min(kKeys, (in_pool ? pool_hi : st_hi) - c_begin);

        // ---- each key's position; kInvalid where no row of the block sees
        // it (those keys are never loaded) -----------------------------------
        int seen = 0;
        if (tid < kKeys) {
            const int c = c_begin + tid;
            int kp = kInvalid;
            if (tid < len) {
                if (!in_pool) {
                    kp = sstart + c;
                } else if (!ring) {
                    kp = c;                        // c < sstart by pool_hi
                } else {
                    int back = (b_latest - c / bs) % nwin;
                    if (back < 0) back += nwin;    // floor mod
                    const int b_j = b_latest - back;
                    const int raw = b_j * bs + c % bs;
                    const int p = raw < sstart ? raw : raw - ring_tokens;
                    if (b_j >= 0 && p >= 0) kp = p;
                }
                // a tree stage row's visibility is its mask column's
                if (kp != kInvalid && !(tree && !in_pool) &&
                    (kp > qmax || kp < kmin))
                    kp = kInvalid;
            }
            kpos_s[tid] = kp;
            seen = kp != kInvalid;
        }
        if (!__syncthreads_or(seen)) continue;   // uniform: the whole block

        // ---- K/V tile -> shared; keys no row sees are zero-filled ---------
        for (int idx = tid; idx < kKeys * VPR; idx += kThreads) {
            const int j = idx / VPR, dv = (idx % VPR) * VEC;
            uint4 kr = make_uint4(0, 0, 0, 0), vr = make_uint4(0, 0, 0, 0);
            if (kpos_s[j] != kInvalid) {
                const int c = c_begin + j;
                if (in_pool) {
                    const size_t off = size_t(table[c / bs]) * page_elems +
                                       size_t(c % bs) * D + dv;
                    if constexpr (FP8) {
                        kr = widen_e4m3<T>(k_pool + off);
                        vr = widen_e4m3<T>(v_pool + off);
                    } else {
                        kr = *reinterpret_cast<const uint4*>(k_pool + off);
                        vr = *reinterpret_cast<const uint4*>(v_pool + off);
                    }
                } else {
                    const size_t off = size_t(c) * D + dv;
                    kr = *reinterpret_cast<const uint4*>(k_st + off);
                    vr = *reinterpret_cast<const uint4*>(v_st + off);
                }
            }
            *reinterpret_cast<uint4*>(v_s + j * D + dv) = vr;
            uint32_t* kd = reinterpret_cast<uint32_t*>(
                k_s + j * S::kStride + dv);
            kd[0] = kr.x;
            kd[1] = kr.y;
            kd[2] = kr.z;
            kd[3] = kr.w;
        }
        __syncthreads();

        // ---- scores: thread owns key j, rows sr + i*SSTEP ----------------
        // (instantiated for the rows this tile really has: a decode tile of
        // one row must not pay for sixteen); e4m3 pool keys score against
        // the e4m3-rounded q
        {
            const float* qt = (FP8 && in_pool) ? q8_s : q_s;
            const uint8_t* tm = in_pool ? nullptr : tmask;
            const int nr = (nrows + SSTEP - 1) / SSTEP;
#define DS_K1_SCORES(NR)                                                   \
    tile_scores<T, D, NR>(qt, k_s, sc, nrows, qpos_s, kpos_s, window, tm, \
                          T_, c_begin, row0, G, scale)
            if (nr <= 1)
                DS_K1_SCORES(1);
            else if (nr <= 2)
                DS_K1_SCORES(2);
            else if (nr <= 4)
                DS_K1_SCORES(4);
            else
                DS_K1_SCORES(SRPT);
#undef DS_K1_SCORES
        }
        __syncthreads();

        // ---- online softmax: one warp per row ------------------------------
        {
            const int warp = tid / 32, lane = tid % 32;
            for (int ri = warp; ri < nrows; ri += kThreads / 32) {
                float* row = sc + ri * kKeys;
                float x0 = row[lane], x1 = row[lane + 32];
                float mx = fmaxf(x0, x1);
#pragma unroll
                for (int o = 16; o > 0; o >>= 1)
                    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
                const float m_old = m_s[ri];
                const float m_new = fmaxf(m_old, mx);
                // an e4m3 pool scales p by 448 for every key (constant
                // across tiles, so alpha's rescaling is unchanged)
                constexpr float p_scale = FP8 ? 448.f : 1.f;
                float p0 = 0.f, p1 = 0.f, alpha = 1.f;
                if (m_new != -INFINITY) {
                    alpha = expf(m_old - m_new);     // exp(-inf) = 0
                    p0 = expf(x0 - m_new) * p_scale;
                    p1 = expf(x1 - m_new) * p_scale;
                }
                float sum = p0 + p1;
#pragma unroll
                for (int o = 16; o > 0; o >>= 1)
                    sum += __shfl_xor_sync(0xffffffffu, sum, o);
                // the PV product takes p rounded to V's dtype (e4m3 for
                // pool keys of an e4m3 pool); l sums the unrounded p
                if (FP8 && in_pool) {
                    row[lane] = e4m3_round(p0);
                    row[lane + 32] = e4m3_round(p1);
                } else {
                    row[lane] = to_f(from_f<T>(p0));
                    row[lane + 32] = to_f(from_f<T>(p1));
                }
                if (lane == 0) {
                    l_s[ri] = alpha * l_s[ri] + sum;
                    m_s[ri] = m_new;
                    a_s[ri] = alpha;
                }
            }
        }
        __syncthreads();

        // ---- acc = acc * alpha + p @ V -------------------------------------
        {
            const int nr = (nrows + RSTEP - 1) / RSTEP;
            if (nr <= 1)
                tile_pv<T, D, 1, RPT>(acc, v_s, sc, a_s, len);
            else if (nr <= 2)
                tile_pv<T, D, 2, RPT>(acc, v_s, sc, a_s, len);
            else if (nr <= 4)
                tile_pv<T, D, 4, RPT>(acc, v_s, sc, a_s, len);
            else if (nr <= 8)
                tile_pv<T, D, (RPT < 8 ? RPT : 8), RPT>(acc, v_s, sc, a_s, len);
            else
                tile_pv<T, D, RPT, RPT>(acc, v_s, sc, a_s, len);
        }
        __syncthreads();
    }

    // ---- out = acc / l (zeros where no key was seen) -----------------------
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
        const int ri = rg + i * RSTEP;
        if (ri >= nrows) continue;
        const float l = l_s[ri];
        const int r = row0 + ri, t = r / G, g = r % G;
        T* dst = out + ((size_t(s) * T_ + t) * H + size_t(h) * G + g) * D;
#pragma unroll
        for (int cc = 0; cc < CPT; ++cc) {
            const int c = c0 + cc * COLS;
            dst[c] = from_f<T>(l == 0.f ? 0.f : acc[i][cc] / l);
        }
    }
}

// the launch's arguments past the pool's element type and head dim
struct Args {
    const void *q, *pool, *k_stage, *v_stage;
    const int *block_tables, *seq_lens, *q_starts, *stage_starts, *tree_pos;
    const uint8_t* tree_mask;
    void* out;
    int n_seqs, n_rows, H, KV, nb, bs, Ts, max_pages, layer;
    float scale;
    int window, ring_tokens;
};

template <typename T, bool FP8, int D>
cudaError_t launch(const Args& a, cudaStream_t stream) {
    using P = std::conditional_t<FP8, uint8_t, T>;
    auto kernel = ragged_paged_attn_kernel<T, FP8, D>;
    constexpr size_t smem = Smem<T, FP8, D>::total;
    static bool configured = false;
    if (!configured) {
        cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
        if (err != cudaSuccess) return err;
        configured = true;
    }
    const int TG = a.n_rows * (a.H / a.KV);
    dim3 grid((TG + kRows - 1) / kRows, a.KV, a.n_seqs);
    kernel<<<grid, kThreads, smem, stream>>>(
        static_cast<const T*>(a.q), static_cast<const P*>(a.pool),
        static_cast<const T*>(a.k_stage), static_cast<const T*>(a.v_stage),
        a.block_tables, a.seq_lens, a.q_starts, a.stage_starts, a.tree_pos,
        a.tree_mask, static_cast<T*>(a.out), a.n_rows, a.H, a.KV, a.nb, a.bs,
        a.Ts, a.max_pages, a.layer, a.scale, a.window, a.ring_tokens);
    return cudaGetLastError();
}

template <typename T, bool FP8>
cudaError_t dispatch_d(int D, const Args& a, cudaStream_t stream) {
    switch (D) {
        case 64:
            return launch<T, FP8, 64>(a, stream);
        case 128:
            return launch<T, FP8, 128>(a, stream);
        case 256:
            return launch<T, FP8, 256>(a, stream);
        default:
            return cudaErrorInvalidValue;
    }
}

// ---------------------------------------------------------------------------
// K7: the per-layer-slice form over separate K and V pools
// ---------------------------------------------------------------------------

constexpr int kNotRun = INT_MIN + 1;    // a key on a page the walk skips
constexpr float kNegInf = -FLT_MAX;     // the Pallas NEG_INF (finite)

// K7's scores of one tile (thread layout of tile_dots): a key on a skipped
// page is -inf (p = 0 whatever the running max); a key masked for a row is
// kNegInf, as the Pallas kernel masks, so a row that has seen no key yet
// takes p = exp(kNegInf - kNegInf) = 1 for it, which the first key it sees
// wipes (alpha = exp(kNegInf - m) = 0)
template <typename T, int D, int NR>
__device__ __forceinline__ void k7_tile_scores(const float* q_s, const T* k_s,
                                               float* sc, int nrows,
                                               const int* qpos_s,
                                               const int* kpos_s, int window,
                                               float scale) {
    constexpr int SSTEP = kThreads / kKeys;
    const int tid = threadIdx.x;
    const int j = tid % kKeys, sr = tid / kKeys;
    float dot[NR];
    tile_dots<T, D, NR>(q_s, k_s, dot);
    const int kp = kpos_s[j];
#pragma unroll
    for (int i = 0; i < kRows / SSTEP; ++i) {
        const int ri = sr + i * SSTEP;
        float x = -INFINITY;
        if (i < NR && ri < nrows && kp != kNotRun) {
            const int qp = qpos_s[ri];
            const bool ok = kp != kInvalid && kp <= qp &&
                            (window <= 0 || kp > qp - window);
            x = ok ? dot[i < NR ? i : 0] * scale : kNegInf;
        }
        sc[ri * kKeys + j] = x;
    }
}

// one block per (slot, KV head, tile of kRows query rows r = t*G + g): the
// pages the Pallas grid runs (`run`: below seq_len and, with a window, not
// wholly before the chunk's first window; in a ring every slot of a block
// b_j >= 0), walked in table order in tiles of kKeys columns
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
paged_attn_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                  const T* __restrict__ v_pool,
                  const int* __restrict__ block_tables,
                  const int* __restrict__ seq_lens,
                  const int* __restrict__ starts, T* __restrict__ out, int T_,
                  int H, int KV, int P, int bs, int max_pages, float scale,
                  int window, int ring_tokens) {
    using S = Smem<T, false, D>;
    constexpr int VEC = 16 / sizeof(T);
    constexpr int VPR = D / VEC;
    constexpr int COLS = D < kThreads ? D : kThreads;
    constexpr int RSTEP = kThreads / COLS;
    constexpr int CPT = D / COLS;
    constexpr int RPT = kRows / RSTEP;
    constexpr int SSTEP = kThreads / kKeys;
    constexpr int SRPT = kRows / SSTEP;

    extern __shared__ __align__(16) unsigned char smem[];
    float* q_s = reinterpret_cast<float*>(smem);
    float* sc = reinterpret_cast<float*>(smem + S::q_bytes);
    float* m_s = reinterpret_cast<float*>(smem + S::q_bytes + S::sc_bytes);
    float* l_s = m_s + kRows;
    float* a_s = l_s + kRows;
    int* qpos_s = reinterpret_cast<int*>(a_s + kRows);
    int* kpos_s = qpos_s + kRows;
    T* v_s = reinterpret_cast<T*>(smem + S::head);
    T* k_s = reinterpret_cast<T*>(smem + S::head + S::v_bytes);

    const int tid = threadIdx.x;
    const int h = blockIdx.y, s = blockIdx.z;
    const int G = H / KV, TG = T_ * G;
    const int row0 = blockIdx.x * kRows;
    const int nrows = min(kRows, TG - row0);
    const int seq_len = seq_lens[s];
    const int start = starts[s];

    // ---- q tile -> shared (fp32), rows t*G + g of head h*G + g ----------
    for (int idx = tid; idx < kRows * VPR; idx += kThreads) {
        const int i = idx / VPR, dv = (idx % VPR) * VEC;
        float* dst = q_s + i * D + dv;
        if (i < nrows) {
            const int r = row0 + i, t = r / G, g = r % G;
            const T* src = q + ((size_t(s) * T_ + t) * H + size_t(h) * G + g) *
                                   D + dv;
            uint4 raw = *reinterpret_cast<const uint4*>(src);
            const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
            for (int k = 0; k < VEC; ++k) dst[k] = to_f(e[k]);
        } else {
#pragma unroll
            for (int k = 0; k < VEC; ++k) dst[k] = 0.f;
        }
    }
    if (tid < kRows) {
        m_s[tid] = kNegInf;
        l_s[tid] = 0.f;
        a_s[tid] = 1.f;
        qpos_s[tid] = tid < nrows ? start + (row0 + tid) / G : 0;
    }
    const int c0 = tid % COLS, rg = tid / COLS;
    float acc[RPT][CPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < CPT; ++j) acc[i][j] = 0.f;
    __syncthreads();
    int qmin = INT_MAX, qmax = INT_MIN;
    for (int i = 0; i < nrows; ++i) {
        qmin = min(qmin, qpos_s[i]);
        qmax = max(qmax, qpos_s[i]);
    }

    // the walked columns [c_lo, c_hi): a linear table's run pages are one
    // range; a ring's run pages are found per column (b_j >= 0)
    const bool ring = ring_tokens > 0;
    int c_lo = 0, c_hi = 0;
    if (ring) {
        c_hi = seq_len > 0 ? max_pages * bs : 0;
    } else {
        const int j_hi = min(max_pages, (max(seq_len, 0) + bs - 1) / bs);
        const int first = start - window + 1;   // earliest key of the chunk
        const int j_lo = window > 0 && first > 0 ? first / bs : 0;
        if (j_hi > j_lo) {
            c_lo = j_lo * bs;
            c_hi = j_hi * bs;
        }
    }
    const int nwin = ring ? ring_tokens / bs : 1;
    const int b_latest = max(seq_len - 1, 0) / bs;
    const T* k_base = k_pool + size_t(h) * P * D;
    const T* v_base = v_pool + size_t(h) * P * D;
    const int* table = block_tables + size_t(s) * max_pages;
    const int n_tiles = c_hi > c_lo ? (c_hi - c_lo + kKeys - 1) / kKeys : 0;

    for (int tile = 0; tile < n_tiles; ++tile) {
        const int c_begin = c_lo + tile * kKeys;
        const int len = min(kKeys, c_hi - c_begin);
        // ---- each key's position: kNotRun off the walked pages, kInvalid
        // where every row masks it ------------------------------------------
        int busy = 0;
        if (tid < kKeys) {
            const int c = c_begin + tid;
            int kp = kNotRun;
            if (tid < len) {
                if (!ring) {
                    kp = c < seq_len ? c : kInvalid;
                } else {
                    int back = (b_latest - c / bs) % nwin;
                    if (back < 0) back += nwin;    // floor mod (jnp %)
                    const int b_j = b_latest - back;
                    if (b_j >= 0) {
                        const int raw = b_j * bs + c % bs;
                        const int p = raw < seq_len ? raw : raw - ring_tokens;
                        kp = p >= 0 ? p : kInvalid;
                    }
                }
            }
            kpos_s[tid] = kp;
            busy = kp != kNotRun && kp != kInvalid && kp <= qmax &&
                   (window <= 0 || kp > qmin - window);
        }
        // a row that has seen no key yet takes even a masked tile (see
        // k7_tile_scores); otherwise a tile no row sees changes nothing
        if (tid < nrows && m_s[tid] == kNegInf) busy = 1;
        if (!__syncthreads_or(busy)) continue;   // uniform: the whole block

        // ---- K/V tile -> shared; keys off the walked pages are zeros -------
        for (int idx = tid; idx < kKeys * VPR; idx += kThreads) {
            const int j = idx / VPR, dv = (idx % VPR) * VEC;
            uint4 kr = make_uint4(0, 0, 0, 0), vr = make_uint4(0, 0, 0, 0);
            if (kpos_s[j] != kNotRun) {
                const int c = c_begin + j;
                const size_t o = (size_t(table[c / bs]) * bs + c % bs) * D + dv;
                kr = *reinterpret_cast<const uint4*>(k_base + o);
                vr = *reinterpret_cast<const uint4*>(v_base + o);
            }
            *reinterpret_cast<uint4*>(v_s + j * D + dv) = vr;
            uint32_t* kd = reinterpret_cast<uint32_t*>(k_s + j * S::kStride + dv);
            kd[0] = kr.x;
            kd[1] = kr.y;
            kd[2] = kr.z;
            kd[3] = kr.w;
        }
        __syncthreads();

        {
            const int nr = (nrows + SSTEP - 1) / SSTEP;
#define DS_K7_SCORES(NR)                                                  \
    k7_tile_scores<T, D, NR>(q_s, k_s, sc, nrows, qpos_s, kpos_s, window, \
                             scale)
            if (nr <= 1)
                DS_K7_SCORES(1);
            else if (nr <= 2)
                DS_K7_SCORES(2);
            else if (nr <= 4)
                DS_K7_SCORES(4);
            else
                DS_K7_SCORES(SRPT);
#undef DS_K7_SCORES
        }
        __syncthreads();

        // ---- online softmax, one warp per row, no guard (the Pallas
        // kernel's: m starts at kNegInf, never -inf) ------------------------
        {
            const int warp = tid / 32, lane = tid % 32;
            for (int ri = warp; ri < nrows; ri += kThreads / 32) {
                float* row = sc + ri * kKeys;
                const float x0 = row[lane], x1 = row[lane + 32];
                float mx = fmaxf(x0, x1);
#pragma unroll
                for (int o = 16; o > 0; o >>= 1)
                    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
                const float m_old = m_s[ri];
                const float m_new = fmaxf(m_old, mx);
                const float alpha = expf(m_old - m_new);
                const float p0 = expf(x0 - m_new), p1 = expf(x1 - m_new);
                float sum = p0 + p1;
#pragma unroll
                for (int o = 16; o > 0; o >>= 1)
                    sum += __shfl_xor_sync(0xffffffffu, sum, o);
                // PV takes p in V's dtype; l sums the unrounded p
                row[lane] = to_f(from_f<T>(p0));
                row[lane + 32] = to_f(from_f<T>(p1));
                if (lane == 0) {
                    l_s[ri] = alpha * l_s[ri] + sum;
                    m_s[ri] = m_new;
                    a_s[ri] = alpha;
                }
            }
        }
        __syncthreads();

        {
            const int nr = (nrows + RSTEP - 1) / RSTEP;
            if (nr <= 1)
                tile_pv<T, D, 1, RPT>(acc, v_s, sc, a_s, len);
            else if (nr <= 2)
                tile_pv<T, D, 2, RPT>(acc, v_s, sc, a_s, len);
            else if (nr <= 4)
                tile_pv<T, D, 4, RPT>(acc, v_s, sc, a_s, len);
            else if (nr <= 8)
                tile_pv<T, D, (RPT < 8 ? RPT : 8), RPT>(acc, v_s, sc, a_s, len);
            else
                tile_pv<T, D, RPT, RPT>(acc, v_s, sc, a_s, len);
        }
        __syncthreads();
    }

    // ---- out = acc / l (zeros where no page was walked) --------------------
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
        const int ri = rg + i * RSTEP;
        if (ri >= nrows) continue;
        const float l = l_s[ri];
        const int r = row0 + ri, t = r / G, g = r % G;
        T* dst = out + ((size_t(s) * T_ + t) * H + size_t(h) * G + g) * D;
#pragma unroll
        for (int cc = 0; cc < CPT; ++cc) {
            const int c = c0 + cc * COLS;
            dst[c] = from_f<T>(l == 0.f ? 0.f : acc[i][cc] / l);
        }
    }
}

template <typename T, int D>
cudaError_t launch_k7(const void* q, const void* k_pool, const void* v_pool,
                      const int* tables, const int* lens, const int* starts,
                      void* out, int S_, int T_, int H, int KV, int P, int bs,
                      int max_pages, float scale, int window, int ring_tokens,
                      cudaStream_t stream) {
    auto kernel = paged_attn_kernel<T, D>;
    constexpr size_t smem = Smem<T, false, D>::total;
    static bool configured = false;
    if (!configured) {
        cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
        if (err != cudaSuccess) return err;
        configured = true;
    }
    dim3 grid((T_ * (H / KV) + kRows - 1) / kRows, KV, S_);
    kernel<<<grid, kThreads, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k_pool),
        static_cast<const T*>(v_pool), tables, lens, starts,
        static_cast<T*>(out), T_, H, KV, P, bs, max_pages, scale, window,
        ring_tokens);
    return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (of q, the stage and out); pool_e4m3: 0
// = the pool has q's dtype, 1 = the pool holds e4m3 codes. window: 0 = no
// sliding window; ring_tokens: 0 = a linear block table, else the ring's
// tokens (a multiple of bs; needs a window). tree_pos [S, T] int32 and
// tree_mask [S, T, T] uint8 are null outside tree mode (T <= Ts there).
// Returns the cudaError_t of the launch (0 = success); the launch is
// asynchronous on `stream`.
extern "C" int ds_ragged_paged_attention(
        const void* q, const void* pool, const void* k_stage,
        const void* v_stage, const void* block_tables, const void* seq_lens,
        const void* q_starts, const void* stage_starts, const void* tree_pos,
        const void* tree_mask, void* out, int S_, int T_, int H, int KV,
        int D, int nb, int bs, int Ts, int max_pages, int layer, float scale,
        int window, int ring_tokens, int dtype, int pool_e4m3, void* stream) {
    if (S_ == 0 || T_ == 0) return 0;
    if (KV <= 0 || H % KV != 0 || bs <= 0) return int(cudaErrorInvalidValue);
    if (ring_tokens && (window <= 0 || ring_tokens % bs != 0))
        return int(cudaErrorInvalidValue);
    if ((tree_pos == nullptr) != (tree_mask == nullptr) ||
        (tree_pos != nullptr && T_ > Ts))
        return int(cudaErrorInvalidValue);
    const Args a{q, pool, k_stage, v_stage,
                 static_cast<const int*>(block_tables),
                 static_cast<const int*>(seq_lens),
                 static_cast<const int*>(q_starts),
                 static_cast<const int*>(stage_starts),
                 static_cast<const int*>(tree_pos),
                 static_cast<const uint8_t*>(tree_mask), out, S_, T_, H, KV,
                 nb, bs, Ts, max_pages, layer, scale, window, ring_tokens};
    auto st = static_cast<cudaStream_t>(stream);
    if (dtype == 0 && !pool_e4m3)
        return int(dispatch_d<float, false>(D, a, st));
    if (dtype == 0) return int(dispatch_d<float, true>(D, a, st));
    if (dtype == 1 && !pool_e4m3)
        return int(dispatch_d<__nv_bfloat16, false>(D, a, st));
    if (dtype == 1) return int(dispatch_d<__nv_bfloat16, true>(D, a, st));
    return int(cudaErrorInvalidValue);
}

// K7: q [S, T, H, D] (dtype 0 = float32, 1 = bfloat16), k_pool / v_pool
// [KV, P, D] of q's dtype with pages of bs rows, block_tables [S, max_pages],
// seq_lens and starts [S] int32 (query row t of slot s sits at starts[s] + t;
// keys below seq_lens[s] are valid); writes out [S, T, H, D]. window: 0 = no
// sliding window; ring_tokens: 0 = a linear table, else the ring's tokens (a
// multiple of bs; needs a window). Returns the cudaError_t of the launch.
extern "C" int ds_paged_attention(
        const void* q, const void* k_pool, const void* v_pool,
        const void* block_tables, const void* seq_lens, const void* starts,
        void* out, int S_, int T_, int H, int KV, int D, int P, int bs,
        int max_pages, float scale, int window, int ring_tokens, int dtype,
        void* stream) {
    if (S_ == 0 || T_ == 0) return 0;
    if (KV <= 0 || H % KV != 0 || bs <= 0 || P % bs != 0 || max_pages <= 0)
        return int(cudaErrorInvalidValue);
    if (ring_tokens && (window <= 0 || ring_tokens % bs != 0))
        return int(cudaErrorInvalidValue);
    auto st = static_cast<cudaStream_t>(stream);
    const int* tb = static_cast<const int*>(block_tables);
    const int* ln = static_cast<const int*>(seq_lens);
    const int* sr = static_cast<const int*>(starts);
#define DS_K7(T, DD)                                                          \
    return int(launch_k7<T, DD>(q, k_pool, v_pool, tb, ln, sr, out, S_, T_, H, \
                                KV, P, bs, max_pages, scale, window,         \
                                ring_tokens, st))
    if (dtype == 0) {
        if (D == 64) DS_K7(float, 64);
        if (D == 128) DS_K7(float, 128);
        if (D == 256) DS_K7(float, 256);
    } else if (dtype == 1) {
        if (D == 64) DS_K7(__nv_bfloat16, 64);
        if (D == 128) DS_K7(__nv_bfloat16, 128);
        if (D == 256) DS_K7(__nv_bfloat16, 256);
    }
#undef DS_K7
    return int(cudaErrorInvalidValue);
}
