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
// memory, which is exact (every e4m3 value, and q and p rounded to e4m3, are
// exact in bf16). Casts to e4m3 follow `__NV_NOSAT` (NaN past the range, as
// JAX's cast), though q and p never exceed 448.
//
// The same source holds K7 (`paged_attn_kernel*`, entry `ds_paged_attention`),
// which replaces `_paged_attn_kernel` of the same Pallas file (entries
// `paged_prefill_attention` and `paged_decode_attention`): query rows at
// starts[s] + t against separate K and V pools [KV, P, D] into which the
// chunk's K/V are already scattered; no stage, e4m3 or tree form. It walks
// the pages the Pallas grid runs (linear: below seq_lens and, with a window,
// not wholly before the chunk's first window; ring: every slot holding a
// block >= 0) and keeps the Pallas kernel's online softmax as it is: no
// guard, masked scores at float's lowest finite value, so a row that sees no
// key on a walked page averages that page's values until its first visible
// key wipes them (alpha = 0), and keeps them if none comes.
//
// Three designs, chosen by the caller (ops/paged_attention.py) from the
// shape alone: rows per (slot, KV head) = T * G.
//
// - bf16, more than 16 rows (prefill chunks, wide trees): the chunk kernels
//   (`ragged_paged_attn_chunk_kernel`, K7's `paged_attn_kernel_chunk`). A
//   prefill chunk at long context is bound by operations (2 x 2 x D per
//   visible (query, key) pair against 2 x D bytes per key, reused by every
//   row), so both products run on the tensor cores: a block of 128 query
//   rows of one (slot, KV head) — all G query heads of the KV head, so each
//   K/V tile is read once per 128 rows — as two consumer warpgroups (64
//   rows, wgmma's M) and a producer warpgroup. S = Q.K^T is wgmma m64n64k16
//   from shared memory (both operands K-major); the softmax runs on the
//   accumulator fragment (row max and sum over the 4 lanes of a row); p
//   stays in registers as the A operand of O += P.V (V MN-major through the
//   descriptor's transpose bit). Keys are walked in tiles of 64 table
//   columns; one warp of the producer brings each tile in through TMA, a box
//   per run of rows inside one page (64, 32, 16 or 8 rows: the largest that
//   divides the page size), into a two-stage ring of full / empty
//   mbarriers. An e4m3 pool's pages arrive as codes through cp.async (two
//   tiles ahead; one at D 256) and the whole producer warpgroup widens them
//   to bf16 into the same swizzled tiles (Hopper's fp8 wgmma takes both
//   operands K-major, and V in the pool is not). The
//   tensor maps are encoded on the host and kept in a small cache (K1 is
//   called once a layer on the same pool), and passed `__grid_constant__`
//   so a CUDA graph keeps them. Blocks with the latest rows start first.
// - bf16, at most 16 rows (decode steps, decode windows, small trees): the
//   split kernels (`ragged_paged_attn_split_kernel`, `paged_attn_kernel_split`)
//   — flash-decoding. A decode step is bound by the bytes of K/V (~2 x G
//   operations per byte, far below the card's ~295), and one block per
//   (slot, KV head) leaves most SMs idle, so the table's columns are cut into
//   splits of `split_cols` columns (a multiple of 64, chosen by the caller
//   from the table's width so the grid fills the card at least twice; K1's
//   stage is one more split): grid (split, KV head, slot). Each split walks
//   its 64-key tiles with cp.async two stages deep, products
//   on mma.sync m16n8k16 (the 16 rows are its M; each warp takes 16 keys of
//   a tile, the tile's row max is shared through shared memory so every warp
//   rounds p against the same running max) and writes its (m, l, acc) in
//   fp32 to a scratch the caller allocates. A merge kernel
//   (`ragged_paged_attn_merge_kernel`, `paged_attn_kernel_merge`) combines
//   the splits in a fixed order: out = sum_i w_i acc_i / sum_i w_i l_i, w_i
//   = exp(m_i - M) over the splits with l_i > 0, M their largest m (no
//   atomics: the same bits on every run). A split that saw no key (past a
//   slot's keys, off the run pages, or masked for every row in K1) has l =
//   0 and counts for nothing, so a row with no key anywhere stays zeros. K7's
//   unguarded softmax survives the merge exactly: a split whose rows saw
//   only masked keys has m = -FLT_MAX and l = its key count, so under any
//   real M its weight exp(-FLT_MAX - M) is 0 — what the sequential walk's
//   alpha does — and if every split is at -FLT_MAX each weighs 1 and the
//   merge averages all walked keys, as the sequential walk does. In the
//   e4m3 form p rounds against the split's running max, so the split
//   boundaries are part of the numerics: the plain version models them
//   (`p_round_splits`).
// - fp32 (the parity route, q in fp32 over an fp32 or an e4m3 pool): the
//   CUDA-core kernels (`ragged_paged_attn_kernel`, `paged_attn_kernel`), one
//   block of 128 threads per (slot, KV head, 16 query rows) walking all of
//   its keys; q, the K/V tile and the scores in shared memory (K rows padded
//   so a warp reading 32 rows at one column hits 32 banks).
//
// Every kernel walks the same tiles: 64-column tiles from the first visible
// one (with a window, its walk starts at a multiple of 64 columns, so the
// e4m3 form's rounding max per tile stays the plain version's); keys past
// the block's last query position and past seq_lens are not walked; a tile
// no row of the block sees is skipped (K7: a tile off the run pages); a ring
// is walked in table order, never in position order (the e4m3 form rounds p
// against the running max of the walk); tree mode walks every stage row
// below T whenever seq_lens[s] > 0 (a branchy tree has more nodes than its
// depth, so seq_lens undercounts them), its mask read a byte per (node,
// node). Which key sits where and who sees it — key positions, the window,
// ring recovery, the tree mask, K7's run pages — are the device functions
// of "the walk" below, shared by all of them. Keys no row sees inside a
// loaded box are read (pages and stage rows hold finite values: the engine
// zero-fills both).
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

#include <mutex>
#include <type_traits>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace hopper;

constexpr int kKeys = 64;              // key positions per tile
constexpr int kInvalid = INT_MIN;      // a key no row of the block sees
constexpr int kNotRun = INT_MIN + 1;   // K7: a key on a page the walk skips
constexpr float kNegInf = -FLT_MAX;    // the Pallas NEG_INF (finite)

__device__ __forceinline__ float e4m3_to_f(__nv_fp8_storage_t b) {
    const __half_raw h = __nv_cvt_fp8_to_halfraw(b, __NV_E4M3);
    return __half2float(__half(h));
}
// x rounded to e4m3 (nearest even; NaN past the range) and read back
__device__ __forceinline__ float e4m3_round(float x) {
    return e4m3_to_f(__nv_cvt_float_to_fp8(x, __NV_NOSAT, __NV_E4M3));
}
// p in [0, 448] rounded to e4m3 and read back: the same bits as
// e4m3_round there, on the hardware's saturating conversion
__device__ __forceinline__ float e4m3_round_p(float x) {
    return e4m3_to_f(__nv_cvt_float_to_fp8(x, __NV_SATFINITE, __NV_E4M3));
}

// ===========================================================================
// The walk of one (slot, KV head): which columns a block visits, which key
// each holds and who sees it. Shared by every kernel of this file.
// ===========================================================================

struct Walk {
    int lo, hi;         // pool table columns [lo, hi) (K7: the run columns)
    int st_lo, st_hi;   // K1's stage rows [st_lo, st_hi)
    int kmin, qmax;     // K1: keys outside [kmin, qmax] no row of the block sees
    int seq_len, sstart, nwin, b_latest, bs, ring_tokens;
    bool tree;
};

// K1's walk for a block whose query positions lie in [qmin, qmax]: a linear
// table is clipped to qmax (and the table's width: positions past it have no
// page) and, with a window, starts at the 64-column tile holding its first
// visible position; a ring is walked whole, in table order. A tree stage is
// every node row; otherwise the stage is clipped like the pool.
__device__ __forceinline__ Walk k1_walk(int seq_len, int sstart, int qmin,
                                        int qmax, int window, int ring_tokens,
                                        int max_pages, int bs, bool tree,
                                        int T_, int Ts) {
    Walk w{};
    w.kmin = window > 0 ? qmin - window + 1 : INT_MIN;
    w.qmax = qmax;
    w.seq_len = seq_len;
    w.sstart = sstart;
    w.bs = bs;
    w.ring_tokens = ring_tokens;
    w.tree = tree;
    w.nwin = ring_tokens > 0 ? ring_tokens / bs : 1;
    w.b_latest = max(sstart - 1, 0) / bs;
    if (seq_len > 0) {
        if (ring_tokens > 0) {
            w.hi = sstart > 0 ? max_pages * bs : 0;
        } else {
            w.hi = min(min(sstart, qmax + 1), max_pages * bs);
            if (window > 0) w.lo = max(0, w.kmin) / kKeys * kKeys;
        }
        if (tree) {
            w.st_hi = min(T_, Ts);
        } else {
            w.st_hi = min(min(seq_len, sstart + Ts), qmax + 1) - sstart;
            if (window > 0) w.st_lo = max(0, w.kmin - sstart) / kKeys * kKeys;
        }
    }
    return w;
}

// K7's run pages (the pages the Pallas grid runs): linear, the pages below
// seq_len not wholly before the chunk's first window (`start` its first
// row's position); a ring, every column (those of blocks < 0 are not run)
__device__ __forceinline__ Walk k7_walk(int seq_len, int start, int window,
                                        int ring_tokens, int max_pages,
                                        int bs) {
    Walk w{};
    w.seq_len = seq_len;
    w.bs = bs;
    w.ring_tokens = ring_tokens;
    w.nwin = ring_tokens > 0 ? ring_tokens / bs : 1;
    w.b_latest = max(seq_len - 1, 0) / bs;
    if (ring_tokens > 0) {
        w.hi = seq_len > 0 ? max_pages * bs : 0;
    } else {
        const int j_hi = min(max_pages, (max(seq_len, 0) + bs - 1) / bs);
        const int first = start - window + 1;   // earliest key of the chunk
        const int j_lo = window > 0 && first > 0 ? first / bs : 0;
        if (j_hi > j_lo) {
            w.lo = j_lo * bs;
            w.hi = j_hi * bs;
        }
    }
    return w;
}

// the block a rolling ring's table column c holds: b_latest - (b_latest -
// c / bs) mod nwin (floor mod, as jnp's %)
__device__ __forceinline__ int ring_block(const Walk& w, int c) {
    int back = (w.b_latest - c / w.bs) % w.nwin;
    if (back < 0) back += w.nwin;
    return w.b_latest - back;
}

// K1: the position of pool column c (in_pool) or stage row c, or kInvalid
// where no row of the block sees it
__device__ __forceinline__ int k1_key_pos(const Walk& w, bool in_pool, int c) {
    int kp;
    if (!in_pool) {
        if (c < w.st_lo || c >= w.st_hi) return kInvalid;
        kp = w.sstart + c;
        if (w.tree) return kp;   // a tree stage row's visibility is its mask's
    } else {
        if (c < w.lo || c >= w.hi) return kInvalid;
        kp = c;                  // c < sstart by hi
        if (w.ring_tokens > 0) {
            const int b_j = ring_block(w, c);
            const int raw = b_j * w.bs + c % w.bs;
            kp = raw < w.sstart ? raw : raw - w.ring_tokens;
            if (b_j < 0 || kp < 0) return kInvalid;
        }
    }
    return kp > w.qmax || kp < w.kmin ? kInvalid : kp;
}

// K7: the position of table column c; kNotRun off the run pages, kInvalid
// where it holds no valid key (past seq_len; before position 0 in a ring)
__device__ __forceinline__ int k7_key_pos(const Walk& w, int c) {
    if (c < w.lo || c >= w.hi) return kNotRun;
    if (w.ring_tokens <= 0) return c < w.seq_len ? c : kInvalid;
    const int b_j = ring_block(w, c);
    if (b_j < 0) return kNotRun;
    const int raw = b_j * w.bs + c % w.bs;
    const int p = raw < w.seq_len ? raw : raw - w.ring_tokens;
    return p >= 0 ? p : kInvalid;
}

// a valid key at kp is visible to a query at qp (with the window)
__device__ __forceinline__ bool sees(int kp, int qp, int window) {
    return kp >= 0 && kp <= qp && (window <= 0 || kp > qp - window);
}

// whether a tile holding key kp has anything to walk
template <bool K7>
__device__ __forceinline__ bool walked(int kp) {
    return K7 ? kp != kNotRun : kp != kInvalid;
}

// which mask a tile's scores take, chosen once a tile (a per-element test
// would put a branch around every score)
enum Mask { kByPosition, kTree, kK7 };

// the scaled score of one (row, key) pair under the mask: K1 -inf where the
// row does not see the key (kTree: a tree stage tile, `tm` the row's
// tree-mask row, `col` the stage row); K7 -inf off the run pages, NEG_INF
// where masked
template <int MODE>
__device__ __forceinline__ float masked_score(float dot, float scale, int kp,
                                              int qp, bool row_ok, int window,
                                              const uint8_t* tm, int col,
                                              int T_) {
    if (MODE == kK7) {
        if (kp == kNotRun) return -INFINITY;
        return row_ok && sees(kp, qp, window) ? dot * scale : kNegInf;
    }
    bool ok = row_ok && kp != kInvalid;
    if (MODE == kTree)
        ok = ok && col < T_ && tm[col] != 0;
    else
        ok = ok && sees(kp, qp, window);
    return ok ? dot * scale : -INFINITY;
}

// exp(d) on the special-function unit, as 2^(d log2 e) (ex2.approx: within
// 2 ulp, subnormal results flushed to 0): three instructions against
// expf's eight, for the bf16 kernels' softmax. d is formed first (x - m),
// so K7's -FLT_MAX - -FLT_MAX stays exactly 0 and -inf stays -inf.
__device__ __forceinline__ float exp_sfu(float d) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(d * 1.4426950408889634f));
    return y;
}

// the max that p and alpha are taken against: the running max, or 0 for a
// K1 row that has seen no key (m = -inf), whose scores are all -inf so
// that p = exp(-inf) = 0 and alpha = 0 leave its l and acc at 0 with no
// branch around the exps; K7 has no guard (m starts at NEG_INF, never -inf)
template <bool K7>
__device__ __forceinline__ float guarded_max(float m) {
    return K7 || m != -INFINITY ? m : 0.f;
}

// f(mode) with the tile's mask as a compile-time value
template <bool K7, typename F>
__device__ __forceinline__ void with_mask(bool tree_tile, F&& f) {
    if constexpr (K7)
        f(std::integral_constant<int, kK7>{});
    else if (tree_tile)
        f(std::integral_constant<int, kTree>{});
    else
        f(std::integral_constant<int, kByPosition>{});
}

// 8 bf16 values rounded to e4m3 (exact in bf16)
__device__ __forceinline__ uint4 round_e4m3_x8(uint4 v) {
    bf16* e = reinterpret_cast<bf16*>(&v);
#pragma unroll
    for (int i = 0; i < 8; ++i)
        e[i] = __float2bfloat16(e4m3_round(__bfloat162float(e[i])));
    return v;
}

// two e4m3 codes widened to a bf16 pair (exact)
__device__ __forceinline__ uint32_t e4m3x2_to_bf16x2(uint16_t two) {
    const __half2 h(__nv_cvt_fp8x2_to_halfraw2(two, __NV_E4M3));
    const float2 f = __half22float2(h);
    return pack_bf16(f.x, f.y);
}

// 16 e4m3 codes widened to bf16 (exact), as two 16-byte pieces
__device__ __forceinline__ void widen16(uint4 raw, uint4& lo, uint4& hi) {
    const uint16_t* b = reinterpret_cast<const uint16_t*>(&raw);
    uint32_t* l = reinterpret_cast<uint32_t*>(&lo);
    uint32_t* h = reinterpret_cast<uint32_t*>(&hi);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        l[i] = e4m3x2_to_bf16x2(b[i]);
        h[i] = e4m3x2_to_bf16x2(b[4 + i]);
    }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src)
                 : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// the launch's arguments, for every kernel of this file
struct Params {
    const bf16* q;
    const void *k_pool, *v_pool;   // K1: both the pool; K7: the two pools
    const bf16 *k_stage, *v_stage;
    const int *tables, *seq_lens, *q_starts, *stage_starts, *tree_pos;
    const uint8_t* tree_mask;
    bf16* out;
    float* part;                   // the split kernels' (acc, m, l)
    // the pools as [slabs, bs, D]: page p of KV head h is slab
    // slab0 + h * nb + p (K1: slab0 selects the layer and the half)
    long long kslab0, vslab0;
    int T, H, KV, nb, bs, Ts, max_pages, window, ring_tokens;
    int box_rows;                  // rows of a pool TMA box (divides bs)
    int split_cols, n_splits;      // the split kernels' walk
    float scale;
};

// the block's query positions [qmin, qmax] for rows [row0, row0 + nrows)
__device__ __forceinline__ void row_positions(const Params& p, int s, int G,
                                              int row0, int nrows, int& qmin,
                                              int& qmax) {
    const int t_lo = row0 / G, t_hi = (row0 + nrows - 1) / G;
    if (p.tree_pos == nullptr) {
        qmin = p.q_starts[s] + t_lo;
        qmax = p.q_starts[s] + t_hi;
        return;
    }
    qmin = INT_MAX;
    qmax = INT_MIN;
    for (int t = t_lo; t <= t_hi; ++t) {
        const int x = p.tree_pos[size_t(s) * p.T + t];
        qmin = min(qmin, x);
        qmax = max(qmax, x);
    }
}

template <bool K7>
__device__ __forceinline__ Walk walk_of(const Params& p, int s, int qmin,
                                        int qmax) {
    const int seq_len = p.seq_lens[s];
    return K7 ? k7_walk(seq_len, p.q_starts[s], p.window, p.ring_tokens,
                        p.max_pages, p.bs)
              : k1_walk(seq_len, p.stage_starts[s], qmin, qmax, p.window,
                        p.ring_tokens, p.max_pages, p.bs,
                        p.tree_pos != nullptr, p.T, p.Ts);
}

// byte offset of element 0 of table column c of slot s in a [slabs, bs, D]
// pool whose head-h pages start at slab0 + h * nb (elements of `esize`)
__device__ __forceinline__ size_t pool_offset(const Params& p, long long slab0,
                                              int s, int h, int c, int D,
                                              int esize) {
    const int page = p.tables[size_t(s) * p.max_pages + c / p.bs];
    const size_t slab = size_t(slab0) + size_t(h) * p.nb + page;
    return ((slab * p.bs) + c % p.bs) * size_t(D) * esize;
}

// ===========================================================================
// bf16, more than 16 rows: the chunk kernels (wgmma, TMA)
// ===========================================================================

constexpr int kTcThreads = 384;       // 2 consumer warpgroups + a producer
constexpr int kTcRows = 128;          // query rows of a block
constexpr int kTcStages = 2;          // the ring of K/V tiles
constexpr int kProducerRegs = 56;     // setmaxnreg: the producer warpgroup
constexpr int kConsumerRegs = 224;    // and the consumers (multiples of 8)
constexpr int kConsumerWarps = 8;     // arrivals that free a stage

template <int D>
struct TcSmem {
    static constexpr int Q_BYTES = kTcRows * D * 2;
    static constexpr int KV_BYTES = kKeys * D * 2;   // one K or V tile
    // an e4m3 pool's codes of a tile (K then V), kRaw tiles ahead
    static constexpr int RAW_BYTES = 2 * kKeys * D;
    static constexpr int kRaw = D == 256 ? 1 : 2;
    static constexpr size_t bytes(bool fp8) {
        return 1024 + Q_BYTES + 2 * kTcStages * KV_BYTES +
               (fp8 ? kRaw * RAW_BYTES : 0) + kTcStages * kKeys * 4 + 32 +
               16 * kTcStages;
    }
};

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
    return reinterpret_cast<uint8_t*>(
        (reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

// byte offset of 16-byte chunk `ch` (8 bf16) of line r in a swizzled tile
// of `lines` lines (hopper.cuh's layout)
__device__ __forceinline__ int swz(int lines, int r, int ch) {
    return (ch / 8) * lines * 128 + r * 128 + (((ch % 8) ^ (r % 8)) << 4);
}

// `rows` rows [row0, row0 + rows) of slab `slab` into lines [0, rows) of a
// swizzled tile of kKeys lines starting at dst (a box per column block)
template <int D>
__device__ __forceinline__ void tma_rows(uint8_t* dst, const CUtensorMap* map,
                                         uint64_t* bar, int row0, int slab) {
#pragma unroll
    for (int c = 0; c < D / 64; ++c)
        tma_load_3d(dst + c * kKeys * 128, map, bar, c * 64, row0, slab);
}

__device__ __forceinline__ void store_bf16x2(bf16* p, float lo, float hi) {
    *reinterpret_cast<uint32_t*>(p) = pack_bf16(lo, hi);
}

// The chunk walk of one block: 128 rows r = t*G + g of (slot, KV head).
// mk / mv map the pool's K and V as [slabs, bs, D] in boxes of {64,
// box_rows, 1}; msk / msv the stage as [S*KV, Ts, D] in boxes of {64, 64,
// 1} (K1 with a bf16 pool; an e4m3 pool is read by hand; K7 has no stage).
template <int D, bool FP8, bool K7>
__device__ __forceinline__ void chunk_attention(const CUtensorMap* mk,
                                                const CUtensorMap* mv,
                                                const CUtensorMap* msk,
                                                const CUtensorMap* msv,
                                                const Params& p) {
    using C = TcSmem<D>;
    extern __shared__ uint8_t smem_raw[];
    uint8_t* Qs = align1024(smem_raw);
    uint8_t* Ks = Qs + C::Q_BYTES;
    uint8_t* Vs = Ks + kTcStages * C::KV_BYTES;
    uint8_t* Raw = Vs + kTcStages * C::KV_BYTES;    // e4m3 codes (FP8)
    int* kpos_s = reinterpret_cast<int*>(Raw + (FP8 ? C::kRaw * C::RAW_BYTES
                                                    : 0));
    int* flag_s = kpos_s + kTcStages * kKeys;
    uint64_t* full = reinterpret_cast<uint64_t*>(flag_s + 8);
    uint64_t* empty = full + kTcStages;

    const int tid = threadIdx.x;
    const int h = blockIdx.y, s = blockIdx.z;
    const int G = p.H / p.KV, TG = p.T * G;
    const int nblk = (TG + kTcRows - 1) / kTcRows;
    const int row0 = (nblk - 1 - int(blockIdx.x)) * kTcRows;   // latest first
    const int nrows = min(kTcRows, TG - row0);
    const bool tree = !K7 && p.tree_pos != nullptr;
    int qmin, qmax;
    row_positions(p, s, G, row0, nrows, qmin, qmax);
    const Walk w = walk_of<K7>(p, s, qmin, qmax);
    const int pool_al = w.lo / kKeys * kKeys;
    // tile counts, warp-uniform as the compiler sees them (wgmma runs
    // inside the tile loop)
    const int n_pool = __shfl_sync(
        0xffffffffu, w.hi > w.lo ? (w.hi - pool_al + kKeys - 1) / kKeys : 0, 0);
    const int n_tiles = __shfl_sync(
        0xffffffffu,
        n_pool + (w.st_hi > w.st_lo ? (w.st_hi - w.st_lo + kKeys - 1) / kKeys
                                    : 0),
        0);

    // tiles start as zeros (a box never loaded holds zeros, or an earlier
    // tile's finite values: p = 0 meets no NaN in the PV product)
    for (int i = tid; i < 2 * kTcStages * C::KV_BYTES / 16; i += kTcThreads)
        reinterpret_cast<uint4*>(Ks)[i] = make_uint4(0, 0, 0, 0);
    fence_proxy_async();
    if (tid == 0) {
        for (int i = 0; i < kTcStages; ++i) {
            bar_init(&full[i], 1);
            bar_init(&empty[i], kConsumerWarps);
        }
        bar_init_fence();
    }
    __syncthreads();

    // the warpgroup index, warp-uniform as the compiler sees it: wgmma
    // under a condition it cannot prove uniform would be serialized
    const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
    if (wg == 2) {
        // ---- producer: each tile's key positions, then its K/V ------------
        reg_dealloc<kProducerRegs>();
        const int pt = tid - 256, lane = tid % 32;
        // the codes of pool tile j -> raw slot j % kRaw (columns of the
        // walk only), one cp.async group
        auto load_raw = [&](int j) {
            constexpr int CH = D / 16;
            uint8_t* rk = Raw + (j % C::kRaw) * C::RAW_BYTES;
            uint8_t* rv = rk + kKeys * D;
            const uint8_t* pool8 = static_cast<const uint8_t*>(p.k_pool);
            const int c0 = pool_al + j * kKeys;
            for (int idx = pt; idx < kKeys * CH; idx += 128) {
                const int jk = idx / CH, g = idx % CH;
                const int c = c0 + jk;
                if (c >= w.lo && c < w.hi) {
                    cp_async16(rk + jk * D + g * 16,
                               pool8 + pool_offset(p, p.kslab0, s, h, c, D, 1) +
                                   g * 16);
                    cp_async16(rv + jk * D + g * 16,
                               pool8 + pool_offset(p, p.vslab0, s, h, c, D, 1) +
                                   g * 16);
                }
            }
            cp_async_commit();
        };
        for (int j = 0; j < n_tiles; ++j) {
            const int st = j % kTcStages;
            const bool in_pool = j < n_pool;
            const int c0 = in_pool ? pool_al + j * kKeys
                                   : w.st_lo + (j - n_pool) * kKeys;
            int* kp_t = kpos_s + st * kKeys;
            bar_wait(&empty[st], ((j / kTcStages) & 1) ^ 1);
            if (pt < kKeys)
                kp_t[pt] = K7 ? k7_key_pos(w, c0 + pt)
                              : k1_key_pos(w, in_pool, c0 + pt);
            named_bar_sync(1, 128);
            if (FP8 && in_pool) {
                // e4m3 codes: every walked column's row arrives through
                // cp.async, kRaw tiles ahead, and the whole warpgroup widens
                // it to bf16 into the swizzled tile; keys no row sees are
                // zeros
                if (C::kRaw == 2) {
                    if (j == 0) load_raw(0);
                    if (j + 1 < n_pool)
                        load_raw(j + 1);
                    else
                        cp_async_commit();
                    cp_async_wait<1>();
                } else {
                    load_raw(j);
                    cp_async_wait<0>();
                }
                named_bar_sync(1, 128);
                constexpr int CH = D / 16;        // 16 codes a piece
                const uint8_t* rk = Raw + (j % C::kRaw) * C::RAW_BYTES;
                const uint8_t* rv = rk + kKeys * D;
                uint8_t* kd = Ks + st * C::KV_BYTES;
                uint8_t* vd = Vs + st * C::KV_BYTES;
                for (int idx = pt; idx < kKeys * CH; idx += 128) {
                    const int jk = idx / CH, g = idx % CH;
                    uint4 k0 = make_uint4(0, 0, 0, 0), k1 = k0, v0 = k0, v1 = k0;
                    if (kp_t[jk] != kInvalid) {
                        widen16(*reinterpret_cast<const uint4*>(
                                    rk + jk * D + g * 16), k0, k1);
                        widen16(*reinterpret_cast<const uint4*>(
                                    rv + jk * D + g * 16), v0, v1);
                    }
                    *reinterpret_cast<uint4*>(kd + swz(kKeys, jk, 2 * g)) = k0;
                    *reinterpret_cast<uint4*>(kd + swz(kKeys, jk, 2 * g + 1)) = k1;
                    *reinterpret_cast<uint4*>(vd + swz(kKeys, jk, 2 * g)) = v0;
                    *reinterpret_cast<uint4*>(vd + swz(kKeys, jk, 2 * g + 1)) = v1;
                }
                fence_proxy_async();
                named_bar_sync(1, 128);
                if (pt < 32) {
                    const bool any = __any_sync(
                        0xffffffffu, walked<K7>(kp_t[lane]) ||
                                         walked<K7>(kp_t[lane + 32]));
                    if (lane == 0) {
                        flag_s[st] = any;
                        bar_arrive(&full[st]);
                    }
                }
            } else if (pt < 32) {
                // TMA: one box per run of `rows` rows holding a walked key
                const unsigned lo_m = __ballot_sync(0xffffffffu,
                                                    walked<K7>(kp_t[lane]));
                const unsigned hi_m = __ballot_sync(
                    0xffffffffu, walked<K7>(kp_t[lane + 32]));
                const uint64_t keys = (uint64_t(hi_m) << 32) | lo_m;
                const int rows = in_pool ? p.box_rows : kKeys;
                const uint64_t bmask =
                    rows == kKeys ? ~0ull : (1ull << rows) - 1;
                const bool want = lane < kKeys / rows &&
                                  ((keys >> (lane * rows)) & bmask) != 0;
                const unsigned boxes = __ballot_sync(0xffffffffu, want);
                const uint32_t bytes = __popc(boxes) * rows * D * 2 * 2;
                if (lane == 0) {
                    flag_s[st] = keys != 0;
                    if (bytes)
                        bar_arrive_tx(&full[st], bytes);
                    else
                        bar_arrive(&full[st]);
                }
                __syncwarp();
                if (want) {
                    const int c = c0 + lane * rows;
                    uint8_t* kd = Ks + st * C::KV_BYTES + lane * rows * 128;
                    uint8_t* vd = Vs + st * C::KV_BYTES + lane * rows * 128;
                    if (in_pool) {
                        const int page =
                            p.tables[size_t(s) * p.max_pages + c / p.bs];
                        const long long sl = (long long)h * p.nb + page;
                        tma_rows<D>(kd, mk, &full[st], c % p.bs,
                                    int(p.kslab0 + sl));
                        tma_rows<D>(vd, mv, &full[st], c % p.bs,
                                    int(p.vslab0 + sl));
                    } else {
                        tma_rows<D>(kd, msk, &full[st], c, s * p.KV + h);
                        tma_rows<D>(vd, msv, &full[st], c, s * p.KV + h);
                    }
                }
            }
        }
        return;
    }
    reg_alloc<kConsumerRegs>();

    // ---- consumers: 64 rows a warpgroup ------------------------------------
    const int warp = (tid % 128) / 32, lane = tid % 32;
    const int c_lane = 2 * (lane % 4);
    const int rl0 = wg * 64 + warp * 16 + lane / 4;   // rows rl0, rl0 + 8
    int qp[2], tt[2];
    bool rv[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        const int r = row0 + rl0 + 8 * i;
        rv[i] = r < TG;
        tt[i] = rv[i] ? r / G : 0;
        qp[i] = !rv[i] ? 0
                : tree ? p.tree_pos[size_t(s) * p.T + tt[i]]
                       : p.q_starts[s] + tt[i];
    }
    // this warpgroup's 64 q rows -> the swizzled Q tile; an e4m3 pool's
    // keys score against q rounded to e4m3, the stage's against q, so the
    // tile is rewritten once where the walk leaves the pool
    auto load_q = [&](bool rounded) {
        // (a rewrite waits for the warpgroup's last product on the tile)
        if (rounded == false && FP8) named_bar_sync(2 + wg, 128);
        for (int idx = tid % 128; idx < 64 * (D / 8); idx += 128) {
            const int line = wg * 64 + idx / (D / 8), ch = idx % (D / 8);
            const int r = row0 + line;
            uint4 v = make_uint4(0, 0, 0, 0);
            if (r < TG) {
                const int t = r / G, g = r % G;
                v = *reinterpret_cast<const uint4*>(
                    p.q + ((size_t(s) * p.T + t) * p.H + size_t(h) * G + g) * D +
                    ch * 8);
                if (rounded) v = round_e4m3_x8(v);
            }
            *reinterpret_cast<uint4*>(Qs + swz(kTcRows, line, ch)) = v;
        }
        fence_proxy_async();
        named_bar_sync(2 + wg, 128);
    };
    load_q(FP8 && n_pool > 0);

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m[2] = {K7 ? kNegInf : -INFINITY, K7 ? kNegInf : -INFINITY};
    float l[2] = {0.f, 0.f};
    const uint32_t qs = smem_u32(Qs);
    // an e4m3 pool scales p by 448 for every key (constant across tiles, so
    // alpha's rescaling is unchanged)
    constexpr float p_scale = FP8 ? 448.f : 1.f;

    for (int j = 0; j < n_tiles; ++j) {
        const int st = j % kTcStages;
        if (FP8 && j == n_pool && n_pool > 0) load_q(false);
        bar_wait(&full[st], (j / kTcStages) & 1);
        const int flag = __shfl_sync(0xffffffffu, flag_s[st], 0);
        if (flag) {
            const uint32_t ks = smem_u32(Ks + st * C::KV_BYTES);
            const uint32_t vs = smem_u32(Vs + st * C::KV_BYTES);
            float sc[kKeys / 2];
            wgmma_fence();
#pragma unroll
            for (int k = 0; k < D / 16; ++k)
                wgmma_ss<kKeys>(sc, desc_k(qs, kTcRows, wg * 64, k),
                                desc_k(ks, kKeys, 0, k), k > 0);
            wgmma_commit();
            wgmma_wait<0>();
            reg_fence(sc);

            const bool in_pool = j < n_pool;
            const int c0 = in_pool ? pool_al + j * kKeys
                                   : w.st_lo + (j - n_pool) * kKeys;
            const int* kp_t = kpos_s + st * kKeys;
            const uint8_t* tm[2] = {nullptr, nullptr};
            if (tree && !in_pool) {
#pragma unroll
                for (int i = 0; i < 2; ++i)
                    tm[i] = p.tree_mask + (size_t(s) * p.T + tt[i]) * p.T;
            }
            float mx[2] = {-INFINITY, -INFINITY};
            with_mask<K7>(tree && !in_pool, [&](auto mode) {
#pragma unroll
                for (int n = 0; n < kKeys / 8; ++n)
#pragma unroll
                    for (int e = 0; e < 2; ++e) {
                        const int col = 8 * n + c_lane + e;
                        const int kp = kp_t[col];
#pragma unroll
                        for (int i = 0; i < 2; ++i) {
                            float& x = sc[4 * n + 2 * i + e];
                            x = masked_score<decltype(mode)::value>(
                                x, p.scale, kp, qp[i], rv[i], p.window, tm[i],
                                c0 + col, p.T);
                            mx[i] = fmaxf(mx[i], x);
                        }
                    }
            });
            float alpha[2], mu[2];
#pragma unroll
            for (int i = 0; i < 2; ++i) {
                mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
                mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
                const float m_new = fmaxf(m[i], mx[i]);
                mu[i] = guarded_max<K7>(m_new);
                alpha[i] = exp_sfu(m[i] - mu[i]);
                m[i] = m_new;
            }
            float sum[2] = {0.f, 0.f};
            const bool round8 = FP8 && in_pool;
#pragma unroll
            for (int n = 0; n < kKeys / 8; ++n)
#pragma unroll
                for (int i = 0; i < 2; ++i)
#pragma unroll
                    for (int e = 0; e < 2; ++e) {
                        float& x = sc[4 * n + 2 * i + e];
                        const float pv = exp_sfu(x - mu[i]) * p_scale;
                        sum[i] += pv;
                        // the PV product takes p rounded to V's dtype (e4m3
                        // for an e4m3 pool's keys; bf16 in acc_to_a)
                        x = round8 ? e4m3_round_p(pv) : pv;
                    }
#pragma unroll
            for (int i = 0; i < 2; ++i) l[i] = alpha[i] * l[i] + sum[i];
            uint32_t pa[kKeys / 16][4];
#pragma unroll
            for (int k = 0; k < kKeys / 16; ++k) acc_to_a(sc, k, pa[k]);
#pragma unroll
            for (int n = 0; n < D / 8; ++n) {
                o[4 * n] *= alpha[0];
                o[4 * n + 1] *= alpha[0];
                o[4 * n + 2] *= alpha[1];
                o[4 * n + 3] *= alpha[1];
            }
            wgmma_fence();
#pragma unroll
            for (int k = 0; k < kKeys / 16; ++k)
                wgmma_rs<D>(o, pa[k], desc_mn(vs, kKeys, 0, k), 1);
            wgmma_commit();
            wgmma_wait<0>();
            reg_fence(o);
        }
        __syncwarp();
        if (lane == 0) bar_arrive(&empty[st]);
    }

    // ---- out = acc / l (zeros where no key was seen) -----------------------
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
        l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
        if (!rv[i]) continue;
        const float inv = l[i] == 0.f ? 0.f : 1.f / l[i];
        const int r = row0 + rl0 + 8 * i, g = r % G;
        bf16* dst = p.out +
                    ((size_t(s) * p.T + tt[i]) * p.H + size_t(h) * G + g) * D +
                    c_lane;
#pragma unroll
        for (int n = 0; n < D / 8; ++n)
            store_bf16x2(dst + 8 * n, o[4 * n + 2 * i] * inv,
                         o[4 * n + 2 * i + 1] * inv);
    }
}

template <int D, bool FP8>
__global__ void __launch_bounds__(kTcThreads, 1)
ragged_paged_attn_chunk_kernel(const __grid_constant__ CUtensorMap mk,
                               const __grid_constant__ CUtensorMap msk,
                               const __grid_constant__ CUtensorMap msv,
                               const Params p) {
    // K1's pool is one tensor: K and V are slabs of the same map
    chunk_attention<D, FP8, false>(&mk, &mk, &msk, &msv, p);
}

template <int D>
__global__ void __launch_bounds__(kTcThreads, 1)
paged_attn_kernel_chunk(const __grid_constant__ CUtensorMap mk,
                        const __grid_constant__ CUtensorMap mv,
                        const Params p) {
    chunk_attention<D, false, true>(&mk, &mv, nullptr, nullptr, p);
}

// ===========================================================================
// bf16, at most 16 rows: the split kernels (flash-decoding, mma.sync)
// ===========================================================================

constexpr int kSplitThreads = 128;   // 4 warps, 16 keys of a tile each
constexpr int kSplitRows = 16;       // mma.sync's M: every row of the block

template <int D>
struct SplitSmem {
    static constexpr int kStages = 2;
    static constexpr int LD = D + 8;   // row stride (elements): ldmatrix's
                                       // 8 rows of 16 bytes hit 32 banks
    static constexpr int TILE = kKeys * LD * 2;        // one K or V tile
    static constexpr int Q_BYTES = kSplitRows * LD * 2;
    // q | q rounded to e4m3 (e4m3 pool) | stages x (K, V) | widened (K, V)
    // (e4m3 pool) | key positions | row maxima | row sums | query positions
    static constexpr size_t bytes(bool fp8) {
        return size_t(fp8 ? 2 : 1) * Q_BYTES +
               size_t(kStages + (fp8 ? 1 : 0)) * 2 * TILE +
               kStages * kKeys * 4 + 2 * 4 * kSplitRows * 4 + kSplitRows * 4;
    }
};

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* ptr) {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(smem_u32(ptr))
        : "memory");
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* ptr) {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
        "[%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(smem_u32(ptr))
        : "memory");
}
// d (16 x 8, fp32) += a (16 x 16 bf16, row) . b (16 x 8 bf16, col)
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, "
        "%3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One split of one (slot, KV head): pool columns [sp * split_cols, (sp + 1)
// * split_cols), or (K1, the last split) the stage; every query row of the
// (slot, KV head), T * G <= 16. Writes the split's m, l and acc (fp32).
// Fragments: an mma.sync accumulator's element e of n-tile nt sits at row
// lane / 4 (+ 8 for e >= 2) and column 8 nt + 2 (lane % 4) + e % 2.
template <int D, bool FP8, bool K7>
__device__ __forceinline__ void split_attention(const Params& p) {
    using C = SplitSmem<D>;
    constexpr int STAGES = C::kStages, LD = C::LD;
    extern __shared__ __align__(16) uint8_t smem[];
    bf16* Qs = reinterpret_cast<bf16*>(smem);
    bf16* Q8s = Qs + kSplitRows * LD;                   // FP8 only
    uint8_t* KV = smem + (FP8 ? 2 : 1) * C::Q_BYTES;
    uint8_t* Wd = KV + STAGES * 2 * C::TILE;   // widened e4m3 tile
    int* kpos_s = reinterpret_cast<int*>(Wd + (FP8 ? 2 * C::TILE : 0));
    float* red = reinterpret_cast<float*>(kpos_s + STAGES * kKeys);
    float* lred = red + 4 * kSplitRows;
    int* qpos_s = reinterpret_cast<int*>(lred + 4 * kSplitRows);

    const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
    const int sp = blockIdx.x, h = blockIdx.y, s = blockIdx.z;
    const int G = p.H / p.KV, R = p.T * G;
    const bool tree = !K7 && p.tree_pos != nullptr;
    int qmin, qmax;
    row_positions(p, s, G, 0, R, qmin, qmax);
    const Walk w = walk_of<K7>(p, s, qmin, qmax);
    const bool stage_split = !K7 && sp == p.n_splits - 1;
    int lo, hi;
    if (stage_split) {
        lo = w.st_lo;
        hi = w.st_hi;
    } else {
        lo = max(sp * p.split_cols, w.lo) / kKeys * kKeys;
        hi = min((sp + 1) * p.split_cols, w.hi);
    }
    const int n_tiles = hi > lo ? (hi - lo + kKeys - 1) / kKeys : 0;
    const size_t rows_all = size_t(gridDim.z) * p.KV * p.n_splits * R;
    const size_t prow = ((size_t(s) * p.KV + h) * p.n_splits + sp) * R;
    float* part_m = p.part + rows_all * D;
    float* part_l = part_m + rows_all;
    const float m_init = K7 ? kNegInf : -INFINITY;
    if (n_tiles == 0) {          // a split past the slot's keys: l = 0
        if (tid < R) {
            part_m[prow + tid] = m_init;
            part_l[prow + tid] = 0.f;
        }
        return;
    }

    // q rows (and q rounded to e4m3) -> shared; rows past R are zeros
    for (int idx = tid; idx < kSplitRows * (D / 8); idx += kSplitThreads) {
        const int r = idx / (D / 8), ch = idx % (D / 8);
        uint4 v = make_uint4(0, 0, 0, 0);
        if (r < R) {
            const int t = r / G, g = r % G;
            v = *reinterpret_cast<const uint4*>(
                p.q + ((size_t(s) * p.T + t) * p.H + size_t(h) * G + g) * D +
                ch * 8);
        }
        *reinterpret_cast<uint4*>(Qs + r * LD + ch * 8) = v;
        if (FP8)
            *reinterpret_cast<uint4*>(Q8s + r * LD + ch * 8) = round_e4m3_x8(v);
    }
    if (tid < kSplitRows) {
        const int t = tid / G;
        qpos_s[tid] = tid >= R ? 0
                      : tree   ? p.tree_pos[size_t(s) * p.T + t]
                               : p.q_starts[s] + t;
    }

    // tile i's keys -> stage i % STAGES: each thread copies one 16-byte
    // piece of 64 / (128 / CH) keys; keys not walked are zeros. An e4m3
    // pool's tiles arrive as codes (widened before use); stage tiles are bf16
    const bool raw = FP8 && !stage_split;
    const int CH = raw ? D / 16 : D / 8;        // 16-byte pieces of a row
    const int esize = raw ? 1 : 2;
    auto load_tile = [&](int i) {
        const int st = i % STAGES;
        const int c0 = lo + i * kKeys;
        uint8_t* kd = KV + st * 2 * C::TILE;
        uint8_t* vd = kd + C::TILE;
        const int ch = tid % CH;
        for (int jk = tid / CH; jk < kKeys; jk += kSplitThreads / CH) {
            const int c = c0 + jk;
            const int kp = K7 ? k7_key_pos(w, c) : k1_key_pos(w, !stage_split, c);
            if (ch == 0) kpos_s[st * kKeys + jk] = kp;
            const int doff = (raw ? jk * D : jk * LD * 2) + ch * 16;
            if (walked<K7>(kp)) {
                const uint8_t *ksrc, *vsrc;
                if (stage_split) {
                    const size_t off = ((size_t(s) * p.KV + h) * p.Ts + c) * D * 2;
                    ksrc = reinterpret_cast<const uint8_t*>(p.k_stage) + off;
                    vsrc = reinterpret_cast<const uint8_t*>(p.v_stage) + off;
                } else {
                    ksrc = static_cast<const uint8_t*>(p.k_pool) +
                           pool_offset(p, p.kslab0, s, h, c, D, esize);
                    vsrc = static_cast<const uint8_t*>(p.v_pool) +
                           pool_offset(p, p.vslab0, s, h, c, D, esize);
                }
                cp_async16(kd + doff, ksrc + ch * 16);
                cp_async16(vd + doff, vsrc + ch * 16);
            } else {
                *reinterpret_cast<uint4*>(kd + doff) = make_uint4(0, 0, 0, 0);
                *reinterpret_cast<uint4*>(vd + doff) = make_uint4(0, 0, 0, 0);
            }
        }
        cp_async_commit();
    };
#pragma unroll
    for (int i = 0; i < STAGES - 1; ++i) {
        if (i < n_tiles)
            load_tile(i);
        else
            cp_async_commit();
    }

    const int rr[2] = {lane / 4, lane / 4 + 8};   // this thread's rows
    float o[D / 8][4];
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[i][e] = 0.f;
    float m[2] = {m_init, m_init}, l[2] = {0.f, 0.f};
    constexpr float p_scale = FP8 ? 448.f : 1.f;
    const bf16* qsrc = raw ? Q8s : Qs;

    for (int i = 0; i < n_tiles; ++i) {
        if (i + STAGES - 1 < n_tiles)
            load_tile(i + STAGES - 1);
        else
            cp_async_commit();
        cp_async_wait<STAGES - 1>();
        const int st = i % STAGES;
        const int* kp_t = kpos_s + st * kKeys;
        // the barrier that makes tile i visible; a tile nobody walks is
        // skipped whole
        if (!__syncthreads_or(tid < kKeys && walked<K7>(kp_t[tid]))) continue;
        const bf16* kt = reinterpret_cast<const bf16*>(KV + st * 2 * C::TILE);
        const bf16* vt = kt + kKeys * LD;
        if (raw) {
            const uint8_t* kr = KV + st * 2 * C::TILE;
            const uint8_t* vr = kr + C::TILE;
            bf16* kw = reinterpret_cast<bf16*>(Wd);
            bf16* vw = kw + kKeys * LD;
            for (int idx = tid; idx < kKeys * (D / 16); idx += kSplitThreads) {
                const int jk = idx / (D / 16), g = idx % (D / 16);
                uint4 a, b;
                widen16(*reinterpret_cast<const uint4*>(kr + jk * D + g * 16),
                        a, b);
                *reinterpret_cast<uint4*>(kw + jk * LD + g * 16) = a;
                *reinterpret_cast<uint4*>(kw + jk * LD + g * 16 + 8) = b;
                widen16(*reinterpret_cast<const uint4*>(vr + jk * D + g * 16),
                        a, b);
                *reinterpret_cast<uint4*>(vw + jk * LD + g * 16) = a;
                *reinterpret_cast<uint4*>(vw + jk * LD + g * 16 + 8) = b;
            }
            __syncthreads();
            kt = kw;
            vt = vw;
        }

        // ---- S = q . K^T: this warp's 16 keys, every row --------------------
        float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
        const int key0 = 16 * warp;
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
            uint32_t a[4], b[4];
            ldsm_x4(a, qsrc + (lane % 16) * LD + kk * 16 + 8 * (lane / 16));
            ldsm_x4(b, kt + (key0 + lane % 8 + 8 * (lane / 16)) * LD + kk * 16 +
                           8 * ((lane / 8) % 2));
            mma16816(sc[0], a, b[0], b[1]);
            mma16816(sc[1], a, b[2], b[3]);
        }
        const int c0 = lo + i * kKeys;
        float mx[2] = {-INFINITY, -INFINITY};
        with_mask<K7>(tree && stage_split, [&](auto mode) {
#pragma unroll
            for (int ii = 0; ii < 2; ++ii) {
                const int r = rr[ii];
                const bool rv = r < R;
                const uint8_t* tm =
                    tree ? p.tree_mask + (size_t(s) * p.T + (rv ? r / G : 0)) *
                                             p.T
                         : nullptr;
                const int qp = qpos_s[r];
#pragma unroll
                for (int nt = 0; nt < 2; ++nt)
#pragma unroll
                    for (int e = 0; e < 2; ++e) {
                        const int col = key0 + 8 * nt + 2 * (lane % 4) + e;
                        float& x = sc[nt][2 * ii + e];
                        x = masked_score<decltype(mode)::value>(
                            x, p.scale, kp_t[col], qp, rv, p.window, tm,
                            c0 + col, p.T);
                        mx[ii] = fmaxf(mx[ii], x);
                    }
            }
        });
#pragma unroll
        for (int ii = 0; ii < 2; ++ii) {
            mx[ii] = fmaxf(mx[ii], __shfl_xor_sync(0xffffffffu, mx[ii], 1));
            mx[ii] = fmaxf(mx[ii], __shfl_xor_sync(0xffffffffu, mx[ii], 2));
            if (lane % 4 == 0) red[warp * kSplitRows + rr[ii]] = mx[ii];
        }
        __syncthreads();
        // the tile's row max over the 4 warps: every warp rounds p against
        // the same running max, the walk's
        float alpha[2], mu[2];
#pragma unroll
        for (int ii = 0; ii < 2; ++ii) {
            float t = red[rr[ii]];
#pragma unroll
            for (int w2 = 1; w2 < 4; ++w2)
                t = fmaxf(t, red[w2 * kSplitRows + rr[ii]]);
            const float m_new = fmaxf(m[ii], t);
            mu[ii] = guarded_max<K7>(m_new);
            alpha[ii] = exp_sfu(m[ii] - mu[ii]);
            m[ii] = m_new;
        }
        float pr[2][4], sum[2] = {0.f, 0.f};
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int ii = 0; ii < 2; ++ii)
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    const float pv =
                        exp_sfu(sc[nt][2 * ii + e] - mu[ii]) * p_scale;
                    sum[ii] += pv;
                    pr[nt][2 * ii + e] = raw ? e4m3_round_p(pv) : pv;
                }
#pragma unroll
        for (int ii = 0; ii < 2; ++ii) l[ii] = alpha[ii] * l[ii] + sum[ii];
        const uint32_t pa[4] = {pack_bf16(pr[0][0], pr[0][1]),
                                pack_bf16(pr[0][2], pr[0][3]),
                                pack_bf16(pr[1][0], pr[1][1]),
                                pack_bf16(pr[1][2], pr[1][3])};
        // ---- acc = acc * alpha + p . V ------------------------------------
#pragma unroll
        for (int dt = 0; dt < D / 8; ++dt) {
            o[dt][0] *= alpha[0];
            o[dt][1] *= alpha[0];
            o[dt][2] *= alpha[1];
            o[dt][3] *= alpha[1];
        }
#pragma unroll
        for (int dn = 0; dn < D / 16; ++dn) {
            uint32_t b[4];
            ldsm_x4_t(b, vt + (key0 + lane % 8 + 8 * ((lane / 8) % 2)) * LD +
                             dn * 16 + 8 * (lane / 16));
            mma16816(o[2 * dn], pa, b[0], b[1]);
            mma16816(o[2 * dn + 1], pa, b[2], b[3]);
        }
        __syncthreads();   // stage st and red are free again
    }

    // ---- the split's partials: the 4 warps' sums in a fixed order ----------
    cp_async_wait<0>();
    __syncthreads();
    float* ob = reinterpret_cast<float*>(KV);   // [4][16][D], the stages
#pragma unroll
    for (int ii = 0; ii < 2; ++ii) {
        l[ii] += __shfl_xor_sync(0xffffffffu, l[ii], 1);
        l[ii] += __shfl_xor_sync(0xffffffffu, l[ii], 2);
        if (lane % 4 == 0) {
            lred[warp * kSplitRows + rr[ii]] = l[ii];
            if (warp == 0) red[rr[ii]] = m[ii];
        }
#pragma unroll
        for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
            for (int e = 0; e < 2; ++e)
                ob[(warp * kSplitRows + rr[ii]) * D + 8 * dt + 2 * (lane % 4) +
                   e] = o[dt][2 * ii + e];
    }
    __syncthreads();
    for (int idx = tid; idx < R * D; idx += kSplitThreads) {
        const int r = idx / D, c = idx % D;
        float acc = ob[r * D + c];
#pragma unroll
        for (int w2 = 1; w2 < 4; ++w2) acc += ob[(w2 * kSplitRows + r) * D + c];
        p.part[(prow + r) * D + c] = acc;
    }
    if (tid < R) {
        float lt = lred[tid];
#pragma unroll
        for (int w2 = 1; w2 < 4; ++w2) lt += lred[w2 * kSplitRows + tid];
        part_m[prow + tid] = red[tid];
        part_l[prow + tid] = lt;
    }
}

// the splits of each row combined in split order: out = sum_i w_i acc_i /
// sum_i w_i l_i over the splits with l_i > 0, w_i = exp(m_i - M), M their
// largest m; zeros where no split saw a key. Grid (KV, S).
__device__ __forceinline__ void merge_splits(const Params& p, int D) {
    const int h = blockIdx.x, s = blockIdx.y;
    const int G = p.H / p.KV, R = p.T * G;
    const size_t rows_all = size_t(gridDim.y) * p.KV * p.n_splits * R;
    const float* pm = p.part + rows_all * D;
    const float* pl = pm + rows_all;
    for (int r = 0; r < R; ++r) {
        const size_t r0 = (size_t(s) * p.KV + h) * p.n_splits * R + r;
        float M = -INFINITY;
        for (int i = 0; i < p.n_splits; ++i)
            if (pl[r0 + size_t(i) * R] > 0.f) M = fmaxf(M, pm[r0 + size_t(i) * R]);
        const int t = r / G, g = r % G;
        bf16* dst = p.out + ((size_t(s) * p.T + t) * p.H + size_t(h) * G + g) * D;
        for (int c = threadIdx.x; c < D; c += blockDim.x) {
            float L = 0.f, acc = 0.f;
            for (int i = 0; i < p.n_splits; ++i) {
                const size_t k = r0 + size_t(i) * R;
                const float li = pl[k];
                if (li > 0.f) {
                    const float wi = expf(pm[k] - M);
                    L += wi * li;
                    acc += wi * p.part[k * D + c];
                }
            }
            dst[c] = __float2bfloat16(L > 0.f ? acc / L : 0.f);
        }
    }
}

template <int D, bool FP8>
__global__ void __launch_bounds__(kSplitThreads)
ragged_paged_attn_split_kernel(const Params p) {
    split_attention<D, FP8, false>(p);
}

template <int D>
__global__ void __launch_bounds__(kSplitThreads)
paged_attn_kernel_split(const Params p) {
    split_attention<D, false, true>(p);
}

__global__ void __launch_bounds__(128)
ragged_paged_attn_merge_kernel(const Params p, int D) {
    merge_splits(p, D);
}

__global__ void __launch_bounds__(128)
paged_attn_kernel_merge(const Params p, int D) {
    merge_splits(p, D);
}

// ===========================================================================
// host: tensor maps (cached), launches
// ===========================================================================

// the bf16 tensor maps of the chunk kernels, kept across calls: K1 is called
// once a layer on the same pool, and the caching allocator hands the stage
// the same address from step to step. A map holds the address and the
// shape only, so a hit is exact.
struct MapEntry {
    const void* base;
    int slabs, S, C, rows;
    CUtensorMap map;
};
constexpr int kMapCache = 16;
MapEntry g_maps[kMapCache];
int g_next_map = 0;
std::mutex g_map_mu;

int cached_map(CUtensorMap* out, const void* base, int slabs, int S, int C,
               int rows) {
    std::lock_guard<std::mutex> lock(g_map_mu);
    for (const MapEntry& e : g_maps) {
        if (e.base == base && e.slabs == slabs && e.S == S && e.C == C &&
            e.rows == rows) {
            *out = e.map;
            return 0;
        }
    }
    MapEntry& e = g_maps[g_next_map];
    g_next_map = (g_next_map + 1) % kMapCache;
    e.base = nullptr;
    const int r = tile_map(&e.map, base, slabs, S, C, rows);
    if (r) return r;
    e.base = base;
    e.slabs = slabs;
    e.S = S;
    e.C = C;
    e.rows = rows;
    *out = e.map;
    return 0;
}

// the rows of a pool TMA box: the largest of 64, 32, 16, 8 dividing bs, so
// a box never crosses a page
int box_rows_of(int bs) {
    for (int r = 64; r >= 8; r /= 2)
        if (bs % r == 0) return r;
    return 0;
}

template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
    return cudaFuncSetAttribute(kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                int(bytes));
}

template <int D, bool FP8>
int launch_k1_chunk(const Params& p, int S_, int L, cudaStream_t stream) {
    const cudaError_t bound = bind_context();
    if (bound != cudaSuccess) return int(bound);
    CUtensorMap mk{}, msk{}, msv{};
    int r = 0;
    if (!FP8)
        r = cached_map(&mk, p.k_pool, L * 2 * p.KV * p.nb, p.bs, D,
                       p.box_rows);
    if (!r) r = cached_map(&msk, p.k_stage, S_ * p.KV, p.Ts, D, kKeys);
    if (!r) r = cached_map(&msv, p.v_stage, S_ * p.KV, p.Ts, D, kKeys);
    if (r) return r;
    auto kernel = ragged_paged_attn_chunk_kernel<D, FP8>;
    static bool configured = false;
    if (!configured) {
        const cudaError_t e = set_smem(kernel, TcSmem<D>::bytes(FP8));
        if (e != cudaSuccess) return int(e);
        configured = true;
    }
    const int TG = p.T * (p.H / p.KV);
    dim3 grid((TG + kTcRows - 1) / kTcRows, p.KV, S_);
    kernel<<<grid, kTcThreads, TcSmem<D>::bytes(FP8), stream>>>(mk, msk, msv,
                                                                p);
    return int(cudaGetLastError());
}

template <int D>
int launch_k7_chunk(const Params& p, int S_, cudaStream_t stream) {
    const cudaError_t bound = bind_context();
    if (bound != cudaSuccess) return int(bound);
    CUtensorMap mk{}, mv{};
    int r = cached_map(&mk, p.k_pool, p.KV * p.nb, p.bs, D, p.box_rows);
    if (!r) r = cached_map(&mv, p.v_pool, p.KV * p.nb, p.bs, D, p.box_rows);
    if (r) return r;
    auto kernel = paged_attn_kernel_chunk<D>;
    static bool configured = false;
    if (!configured) {
        const cudaError_t e = set_smem(kernel, TcSmem<D>::bytes(false));
        if (e != cudaSuccess) return int(e);
        configured = true;
    }
    const int TG = p.T * (p.H / p.KV);
    dim3 grid((TG + kTcRows - 1) / kTcRows, p.KV, S_);
    kernel<<<grid, kTcThreads, TcSmem<D>::bytes(false), stream>>>(mk, mv, p);
    return int(cudaGetLastError());
}

template <int D, bool FP8, bool K7>
int launch_split(const Params& p, int S_, cudaStream_t stream) {
    void (*kernel)(const Params) = ragged_paged_attn_split_kernel<D, FP8>;
    if constexpr (K7) kernel = paged_attn_kernel_split<D>;
    const size_t smem = SplitSmem<D>::bytes(FP8);
    static bool configured = false;
    if (!configured) {
        const cudaError_t e = set_smem(kernel, smem);
        if (e != cudaSuccess) return int(e);
        configured = true;
    }
    kernel<<<dim3(p.n_splits, p.KV, S_), kSplitThreads, smem, stream>>>(p);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return int(e);
    void (*merge)(const Params, int) = ragged_paged_attn_merge_kernel;
    if constexpr (K7) merge = paged_attn_kernel_merge;
    merge<<<dim3(p.KV, S_), 128, 0, stream>>>(p, D);
    return int(cudaGetLastError());
}

// a bf16 call: the split kernels where split_cols > 0, else the chunk
// kernels
template <bool FP8, bool K7>
int dispatch_bf16(int D, const Params& p, int S_, int L, cudaStream_t st) {
#define DS_BF16(DD)                                                         \
    if (D == DD) {                                                          \
        if (p.split_cols > 0) return launch_split<DD, FP8, K7>(p, S_, st);  \
        if constexpr (K7)                                                   \
            return launch_k7_chunk<DD>(p, S_, st);                          \
        else                                                                \
            return launch_k1_chunk<DD, FP8>(p, S_, L, st);                  \
    }
    DS_BF16(64)
    DS_BF16(128)
    DS_BF16(256)
#undef DS_BF16
    return int(cudaErrorInvalidValue);
}

// ===========================================================================
// fp32: the CUDA-core kernels (the parity route)
// ===========================================================================

constexpr int kThreads = 128;   // 4 warps
constexpr int kRows = 16;       // query rows per block

// 16 / sizeof(float) = 4 e4m3 codes at p, widened to fp32 (16 bytes)
__device__ __forceinline__ uint4 widen_e4m3_f32(const uint8_t* p) {
    const uint32_t w = *reinterpret_cast<const uint32_t*>(p);
    uint4 r;
    float* e = reinterpret_cast<float*>(&r);
#pragma unroll
    for (int i = 0; i < 4; ++i)
        e[i] = e4m3_to_f(static_cast<__nv_fp8_storage_t>(w >> (8 * i)));
    return r;
}

template <bool FP8, int D>
struct Smem {
    static constexpr int kStride = D + 1;   // K row stride (elements):
                                            // 32 rows at one column hit 32
                                            // banks
    // q, and for an e4m3 pool a second copy rounded to e4m3
    static constexpr size_t q_bytes =
        size_t(FP8 ? 2 : 1) * kRows * D * sizeof(float);
    static constexpr size_t sc_bytes = size_t(kRows) * kKeys * sizeof(float);
    static constexpr size_t stat_bytes = 3 * kRows * sizeof(float);
    // each query row's position and each key of the tile's (16-byte sum)
    static constexpr size_t pos_bytes = size_t(kRows + kKeys) * sizeof(int);
    static constexpr size_t v_bytes = size_t(kKeys) * D * sizeof(float);
    static constexpr size_t k_bytes = size_t(kKeys) * kStride * sizeof(float);
    static constexpr size_t head =
        q_bytes + sc_bytes + stat_bytes + pos_bytes;   // v_s starts here
    static constexpr size_t total = head + v_bytes + k_bytes;
};

// q . k of one tile: thread owns key j = tid % kKeys and rows
// sr + i*SSTEP (sr = tid / kKeys) for i < NR
template <int D, int NR>
__device__ __forceinline__ void tile_dots(const float* q_s, const float* k_s,
                                          float (&dot)[NR]) {
    constexpr int SSTEP = kThreads / kKeys;
    constexpr int KS = D + 1;
    const int tid = threadIdx.x;
    const int j = tid % kKeys, sr = tid / kKeys;
#pragma unroll
    for (int i = 0; i < NR; ++i) dot[i] = 0.f;
    const float* krow = k_s + j * KS;
#pragma unroll 4
    for (int d = 0; d < D; d += 2) {
        const float k0 = krow[d], k1 = krow[d + 1];
#pragma unroll
        for (int i = 0; i < NR; ++i) {
            const float2 qq = *reinterpret_cast<const float2*>(
                q_s + (sr + i * SSTEP) * D + d);
            dot[i] = fmaf(qq.x, k0, dot[i]);
            dot[i] = fmaf(qq.y, k1, dot[i]);
        }
    }
}

// scores of one tile: thread owns key j = tid % kKeys and rows
// sr + i*SSTEP (sr = tid / kKeys) for i < NR (masked_score's rule; `tmask`
// the slot's [T, T] tree mask for a tree-mode stage tile, `col0` the
// tile's first stage row)
template <int D, int NR, int MODE>
__device__ __forceinline__ void tile_scores(const float* q_s, const float* k_s,
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
    tile_dots<D, NR>(q_s, k_s, dot);
    const int kp = kpos_s[j];
#pragma unroll
    for (int i = 0; i < kRows / SSTEP; ++i) {
        const int ri = sr + i * SSTEP;
        const bool row_ok = i < NR && ri < nrows;
        const uint8_t* tm =
            MODE == kTree ? tmask + ((row0 + (row_ok ? ri : 0)) / G) * T_
                          : nullptr;
        sc[ri * kKeys + j] =
            i < NR ? masked_score<MODE>(dot[i < NR ? i : 0], scale, kp,
                                        qpos_s[ri], row_ok, window, tm,
                                        col0 + j, T_)
                   : -INFINITY;
    }
}

// acc[i] = acc[i] * alpha + p @ V for the thread's first NR row slots
// (rows rg + i*RSTEP); columns c0 + cc*COLS
template <int D, int NR, int RPT>
__device__ __forceinline__ void tile_pv(
        float (&acc)[RPT][D < kThreads ? 1 : D / kThreads], const float* v_s,
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
        for (int cc = 0; cc < CPT; ++cc) v[cc] = v_s[j * D + c0 + cc * COLS];
#pragma unroll
        for (int i = 0; i < NR; ++i) {
            const float p = sc[(rg + i * RSTEP) * kKeys + j];
#pragma unroll
            for (int cc = 0; cc < CPT; ++cc)
                acc[i][cc] = fmaf(p, v[cc], acc[i][cc]);
        }
    }
}

// One block per (slot, KV head, tile of 16 query rows) walks all of its keys
// (the walk above) in a loop: K1 over a pool of fp32 or of e4m3 codes (FP8,
// widened to fp32 in shared memory), or K7 (separate pools, its run pages
// and unguarded softmax). P: the pool's element type.
template <bool FP8, int D, bool K7>
__device__ __forceinline__ void fma_attention(const float* __restrict__ q,
                                              const void* k_pool,
                                              const void* v_pool,
                                              const float* __restrict__ k_stage,
                                              const float* __restrict__ v_stage,
                                              const Params& p,
                                              float* __restrict__ out) {
    using S = Smem<FP8, D>;
    using P = std::conditional_t<FP8, uint8_t, float>;
    constexpr int VPR = D / 4;                   // 16-byte vectors per row
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
    float* v_s = reinterpret_cast<float*>(smem + S::head);
    float* k_s = reinterpret_cast<float*>(smem + S::head + S::v_bytes);

    const int tid = threadIdx.x;
    const int h = blockIdx.y;
    const int s = blockIdx.z;
    const int G = p.H / p.KV;
    const int TG = p.T * G;
    const int row0 = blockIdx.x * kRows;
    const int nrows = min(kRows, TG - row0);
    const bool tree = !K7 && p.tree_pos != nullptr;
    const float m_init = K7 ? kNegInf : -INFINITY;

    // ---- q tile -> shared, rows t*G + g of head h*G + g -------------------
    for (int idx = tid; idx < kRows * VPR; idx += kThreads) {
        const int i = idx / VPR, dv = (idx % VPR) * 4;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (i < nrows) {
            const int r = row0 + i, t = r / G, g = r % G;
            v = *reinterpret_cast<const float4*>(
                q + ((size_t(s) * p.T + t) * p.H + size_t(h) * G + g) * D + dv);
        }
        *reinterpret_cast<float4*>(q_s + i * D + dv) = v;
        if constexpr (FP8) {
            q8_s[i * D + dv] = e4m3_round(v.x);
            q8_s[i * D + dv + 1] = e4m3_round(v.y);
            q8_s[i * D + dv + 2] = e4m3_round(v.z);
            q8_s[i * D + dv + 3] = e4m3_round(v.w);
        }
    }
    if (tid < kRows) {
        m_s[tid] = m_init;
        l_s[tid] = 0.f;
        a_s[tid] = 1.f;
        int qp = 0;
        if (tid < nrows) {
            const int t = (row0 + tid) / G;
            qp = tree ? p.tree_pos[size_t(s) * p.T + t] : p.q_starts[s] + t;
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
    int qmin, qmax;
    row_positions(p, s, G, row0, nrows, qmin, qmax);
    const Walk w = walk_of<K7>(p, s, qmin, qmax);
    const int pool_al = w.lo / kKeys * kKeys;
    const int n_pool_tiles =
        w.hi > w.lo ? (w.hi - pool_al + kKeys - 1) / kKeys : 0;
    const int n_stage_tiles =
        w.st_hi > w.st_lo ? (w.st_hi - w.st_lo + kKeys - 1) / kKeys : 0;
    const P* k_base = static_cast<const P*>(k_pool);
    const P* v_base = static_cast<const P*>(v_pool);
    const float* k_st = k_stage + (size_t(s) * p.KV + h) * p.Ts * D;
    const float* v_st = v_stage + (size_t(s) * p.KV + h) * p.Ts * D;
    const uint8_t* tmask =
        tree ? p.tree_mask + size_t(s) * p.T * p.T : nullptr;

    for (int tile = 0; tile < n_pool_tiles + n_stage_tiles; ++tile) {
        const bool in_pool = tile < n_pool_tiles;
        // the tile's first table column (pool) or stage row (stage)
        const int c_begin = in_pool ? pool_al + tile * kKeys
                                    : w.st_lo + (tile - n_pool_tiles) * kKeys;

        // ---- each key's position (kInvalid where no row sees it; K7:
        // kNotRun off the run pages) -----------------------------------------
        int busy = 0;
        if (tid < kKeys) {
            const int c = c_begin + tid;
            const int kp = K7 ? k7_key_pos(w, c) : k1_key_pos(w, in_pool, c);
            kpos_s[tid] = kp;
            busy = K7 ? kp >= 0 && kp <= qmax &&
                            (p.window <= 0 || kp > qmin - p.window)
                      : kp != kInvalid;
        }
        // K7: a row that has seen no key yet takes even a masked tile (p =
        // exp(NEG_INF - NEG_INF) = 1, wiped by its first visible key);
        // otherwise a tile no row sees changes nothing
        if (K7 && tid < nrows && m_s[tid] == kNegInf) busy = 1;
        if (!__syncthreads_or(busy)) continue;   // uniform: the whole block

        // ---- K/V tile -> shared; keys not walked are zero-filled ----------
        for (int idx = tid; idx < kKeys * VPR; idx += kThreads) {
            const int j = idx / VPR, dv = (idx % VPR) * 4;
            uint4 kr = make_uint4(0, 0, 0, 0), vr = make_uint4(0, 0, 0, 0);
            const int kp = kpos_s[j];
            if (walked<K7>(kp)) {
                const int c = c_begin + j;
                if (in_pool) {
                    const size_t ko =
                        pool_offset(p, p.kslab0, s, h, c, D, 1) + dv;
                    const size_t vo =
                        pool_offset(p, p.vslab0, s, h, c, D, 1) + dv;
                    if constexpr (FP8) {
                        kr = widen_e4m3_f32(k_base + ko);
                        vr = widen_e4m3_f32(v_base + vo);
                    } else {
                        kr = *reinterpret_cast<const uint4*>(k_base + ko);
                        vr = *reinterpret_cast<const uint4*>(v_base + vo);
                    }
                } else {
                    const size_t off = size_t(c) * D + dv;
                    kr = *reinterpret_cast<const uint4*>(k_st + off);
                    vr = *reinterpret_cast<const uint4*>(v_st + off);
                }
            }
            *reinterpret_cast<uint4*>(v_s + j * D + dv) = vr;
            const float* kf = reinterpret_cast<const float*>(&kr);
            float* kd = k_s + j * S::kStride + dv;
            kd[0] = kf[0];
            kd[1] = kf[1];
            kd[2] = kf[2];
            kd[3] = kf[3];
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
            with_mask<K7>(tm != nullptr, [&](auto mode) {
                constexpr int M = decltype(mode)::value;
#define DS_FMA_SCORES(NR)                                                    \
    tile_scores<D, NR, M>(qt, k_s, sc, nrows, qpos_s, kpos_s, p.window, tm, \
                          p.T, c_begin, row0, G, p.scale)
                if (nr <= 1)
                    DS_FMA_SCORES(1);
                else if (nr <= 2)
                    DS_FMA_SCORES(2);
                else if (nr <= 4)
                    DS_FMA_SCORES(4);
                else
                    DS_FMA_SCORES(SRPT);
#undef DS_FMA_SCORES
            });
        }
        __syncthreads();

        // ---- online softmax: one warp per row ------------------------------
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
                // an e4m3 pool scales p by 448 for every key (constant
                // across tiles, so alpha's rescaling is unchanged); K1
                // guards a row that has seen no key, K7 does not
                constexpr float p_scale = FP8 ? 448.f : 1.f;
                float p0 = 0.f, p1 = 0.f, alpha = 1.f;
                if (K7 || m_new != -INFINITY) {
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
                    row[lane] = e4m3_round_p(p0);
                    row[lane + 32] = e4m3_round_p(p1);
                } else {
                    row[lane] = p0;
                    row[lane + 32] = p1;
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
            const int len = kKeys;
            const int nr = (nrows + RSTEP - 1) / RSTEP;
            if (nr <= 1)
                tile_pv<D, 1, RPT>(acc, v_s, sc, a_s, len);
            else if (nr <= 2)
                tile_pv<D, 2, RPT>(acc, v_s, sc, a_s, len);
            else if (nr <= 4)
                tile_pv<D, 4, RPT>(acc, v_s, sc, a_s, len);
            else if (nr <= 8)
                tile_pv<D, (RPT < 8 ? RPT : 8), RPT>(acc, v_s, sc, a_s, len);
            else
                tile_pv<D, RPT, RPT>(acc, v_s, sc, a_s, len);
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
        float* dst = out + ((size_t(s) * p.T + t) * p.H + size_t(h) * G + g) * D;
#pragma unroll
        for (int cc = 0; cc < CPT; ++cc) {
            const int c = c0 + cc * COLS;
            dst[c] = l == 0.f ? 0.f : acc[i][cc] / l;
        }
    }
}

template <bool FP8, int D>
__global__ void __launch_bounds__(kThreads)
ragged_paged_attn_kernel(const float* q, const float* k_stage,
                         const float* v_stage, float* out, const Params p) {
    fma_attention<FP8, D, false>(q, p.k_pool, p.v_pool, k_stage, v_stage, p,
                                 out);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
paged_attn_kernel(const float* q, float* out, const Params p) {
    fma_attention<false, D, true>(q, p.k_pool, p.v_pool, nullptr, nullptr, p,
                                  out);
}

template <bool FP8, bool K7, int D>
int launch_f32(const Params& p, const void* q, const void* ks, const void* vs,
               void* out, int S_, cudaStream_t stream) {
    constexpr size_t smem = Smem<FP8, D>::total;
    dim3 grid((p.T * (p.H / p.KV) + kRows - 1) / kRows, p.KV, S_);
    static bool configured = false;
    if constexpr (K7) {
        if (!configured) {
            const cudaError_t e = set_smem(paged_attn_kernel<D>, smem);
            if (e != cudaSuccess) return int(e);
            configured = true;
        }
        paged_attn_kernel<D><<<grid, kThreads, smem, stream>>>(
            static_cast<const float*>(q), static_cast<float*>(out), p);
    } else {
        if (!configured) {
            const cudaError_t e =
                set_smem(ragged_paged_attn_kernel<FP8, D>, smem);
            if (e != cudaSuccess) return int(e);
            configured = true;
        }
        ragged_paged_attn_kernel<FP8, D><<<grid, kThreads, smem, stream>>>(
            static_cast<const float*>(q), static_cast<const float*>(ks),
            static_cast<const float*>(vs), static_cast<float*>(out), p);
    }
    return int(cudaGetLastError());
}

template <bool FP8, bool K7>
int dispatch_f32(int D, const Params& p, const void* q, const void* ks,
                 const void* vs, void* out, int S_, cudaStream_t stream) {
    switch (D) {
        case 64:
            return launch_f32<FP8, K7, 64>(p, q, ks, vs, out, S_, stream);
        case 128:
            return launch_f32<FP8, K7, 128>(p, q, ks, vs, out, S_, stream);
        case 256:
            return launch_f32<FP8, K7, 256>(p, q, ks, vs, out, S_, stream);
        default:
            return int(cudaErrorInvalidValue);
    }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (of q, the stage and out); pool_e4m3: 0
// = the pool has q's dtype, 1 = the pool holds e4m3 codes. window: 0 = no
// sliding window; ring_tokens: 0 = a linear block table, else the ring's
// tokens (a multiple of bs; needs a window). tree_pos [S, T] int32 and
// tree_mask [S, T, T] uint8 are null outside tree mode (T <= Ts there). L:
// the pool's layers. bf16 only: split_cols > 0 takes the split kernels
// (n_splits splits: ceil(max_pages * bs / split_cols) over the pool, plus
// the stage) with `scratch` of S * KV * n_splits * T * (H / KV) * (D + 2)
// floats; split_cols = 0 takes the chunk kernels. Returns the cudaError_t
// of the launch (0 = success), or 1000 + a CUresult where a tensor map
// could not be encoded; the launch is asynchronous on `stream`.
extern "C" int ds_ragged_paged_attention(
        const void* q, const void* pool, const void* k_stage,
        const void* v_stage, const void* block_tables, const void* seq_lens,
        const void* q_starts, const void* stage_starts, const void* tree_pos,
        const void* tree_mask, void* out, int S_, int T_, int H, int KV,
        int D, int nb, int bs, int Ts, int max_pages, int layer, float scale,
        int window, int ring_tokens, int dtype, int pool_e4m3, int L,
        int split_cols, int n_splits, void* scratch, void* stream) {
    if (S_ == 0 || T_ == 0) return 0;
    if (KV <= 0 || H % KV != 0 || bs <= 0 || layer < 0 || layer >= L)
        return int(cudaErrorInvalidValue);
    if (ring_tokens && (window <= 0 || ring_tokens % bs != 0))
        return int(cudaErrorInvalidValue);
    if ((tree_pos == nullptr) != (tree_mask == nullptr) ||
        (tree_pos != nullptr && T_ > Ts))
        return int(cudaErrorInvalidValue);
    Params p{};
    p.q = static_cast<const bf16*>(q);
    p.k_pool = pool;
    p.v_pool = pool;
    p.k_stage = static_cast<const bf16*>(k_stage);
    p.v_stage = static_cast<const bf16*>(v_stage);
    p.tables = static_cast<const int*>(block_tables);
    p.seq_lens = static_cast<const int*>(seq_lens);
    p.q_starts = static_cast<const int*>(q_starts);
    p.stage_starts = static_cast<const int*>(stage_starts);
    p.tree_pos = static_cast<const int*>(tree_pos);
    p.tree_mask = static_cast<const uint8_t*>(tree_mask);
    p.out = static_cast<bf16*>(out);
    p.part = static_cast<float*>(scratch);
    p.kslab0 = (long long)layer * 2 * KV * nb;
    p.vslab0 = p.kslab0 + (long long)KV * nb;
    p.T = T_;
    p.H = H;
    p.KV = KV;
    p.nb = nb;
    p.bs = bs;
    p.Ts = Ts;
    p.max_pages = max_pages;
    p.window = window;
    p.ring_tokens = ring_tokens;
    p.box_rows = box_rows_of(bs);
    p.split_cols = split_cols;
    p.n_splits = n_splits;
    p.scale = scale;
    auto st = static_cast<cudaStream_t>(stream);
    if (dtype == 0) {
        return pool_e4m3 ? dispatch_f32<true, false>(D, p, q, k_stage, v_stage,
                                                     out, S_, st)
                         : dispatch_f32<false, false>(D, p, q, k_stage,
                                                      v_stage, out, S_, st);
    }
    if (dtype != 1 || p.box_rows == 0) return int(cudaErrorInvalidValue);
    if (split_cols > 0 &&
        (scratch == nullptr || split_cols % kKeys != 0 ||
         T_ * (H / KV) > kSplitRows ||
         n_splits != (max_pages * bs + split_cols - 1) / split_cols + 1))
        return int(cudaErrorInvalidValue);
    return pool_e4m3 ? dispatch_bf16<true, false>(D, p, S_, L, st)
                     : dispatch_bf16<false, false>(D, p, S_, L, st);
}

// K7: q [S, T, H, D] (dtype 0 = float32, 1 = bfloat16), k_pool / v_pool
// [KV, P, D] of q's dtype with pages of bs rows, block_tables [S, max_pages],
// seq_lens and starts [S] int32 (query row t of slot s sits at starts[s] + t;
// keys below seq_lens[s] are valid); writes out [S, T, H, D]. window: 0 = no
// sliding window; ring_tokens: 0 = a linear table, else the ring's tokens (a
// multiple of bs; needs a window). split_cols, n_splits (ceil(max_pages *
// bs / split_cols), no stage) and scratch as for K1. Returns the
// cudaError_t of the launch.
extern "C" int ds_paged_attention(
        const void* q, const void* k_pool, const void* v_pool,
        const void* block_tables, const void* seq_lens, const void* starts,
        void* out, int S_, int T_, int H, int KV, int D, int P, int bs,
        int max_pages, float scale, int window, int ring_tokens, int dtype,
        int split_cols, int n_splits, void* scratch, void* stream) {
    if (S_ == 0 || T_ == 0) return 0;
    if (KV <= 0 || H % KV != 0 || bs <= 0 || P % bs != 0 || max_pages <= 0)
        return int(cudaErrorInvalidValue);
    if (ring_tokens && (window <= 0 || ring_tokens % bs != 0))
        return int(cudaErrorInvalidValue);
    Params p{};
    p.q = static_cast<const bf16*>(q);
    p.k_pool = k_pool;
    p.v_pool = v_pool;
    p.tables = static_cast<const int*>(block_tables);
    p.seq_lens = static_cast<const int*>(seq_lens);
    p.q_starts = static_cast<const int*>(starts);
    p.out = static_cast<bf16*>(out);
    p.part = static_cast<float*>(scratch);
    p.T = T_;
    p.H = H;
    p.KV = KV;
    p.nb = P / bs;
    p.bs = bs;
    p.max_pages = max_pages;
    p.window = window;
    p.ring_tokens = ring_tokens;
    p.box_rows = box_rows_of(bs);
    p.split_cols = split_cols;
    p.n_splits = n_splits;
    p.scale = scale;
    auto st = static_cast<cudaStream_t>(stream);
    if (dtype == 0)
        return dispatch_f32<false, true>(D, p, q, nullptr, nullptr, out, S_, st);
    if (dtype != 1 || p.box_rows == 0) return int(cudaErrorInvalidValue);
    if (split_cols > 0 &&
        (scratch == nullptr || split_cols % kKeys != 0 ||
         T_ * (H / KV) > kSplitRows ||
         n_splits != (max_pages * bs + split_cols - 1) / split_cols))
        return int(cudaErrorInvalidValue);
    return dispatch_bf16<false, true>(D, p, S_, 0, st);
}

// the dynamic shared memory of a bf16 kernel (which: 0 = chunk, 1 = split;
// fp8: the e4m3-pool form), or 0 for a head dim it is not built for
extern "C" int ds_paged_attention_smem(int which, int D, int fp8) {
#define DS_SMEM(DD)                                                   \
    if (D == DD)                                                      \
        return which ? int(SplitSmem<DD>::bytes(fp8 != 0))            \
                     : int(TcSmem<DD>::bytes(fp8 != 0));
    DS_SMEM(64)
    DS_SMEM(128)
    DS_SMEM(256)
#undef DS_SMEM
    return 0;
}
