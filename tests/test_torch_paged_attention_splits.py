"""The split walk of K1's split kernel, as its plain version models it.

The bf16 split kernel (``csrc/paged_attention.cu``, flash-decoding) cuts each
slot's table into splits of ``split_cols`` columns, the stage one more
split, and merges their (m, l, acc). Only the e4m3 form's arithmetic
depends on where the walk restarts: p is rounded to e4m3 against each
split's running max. The plain version models that with
``p_round_splits``; these tests hold it to the unsplit walk, to the Pallas
kernel's page walk (interpret mode, as the JAX package's own tests run it
on the CPU) and to a hand-made case, and pin the shape-only choice of
route and split width."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.pallas.paged_attention import \
    paged_ragged_attention as jax_paged_ragged_attention
from deepspeed_tpu_torch.ops import paged_attention as pa
from deepspeed_tpu_torch.ops.quant_matmul import to_e4m3


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


TILE = pa.KERNEL_KEY_TILE


def _case(form, pool, seed=0):
    """K1 inputs over a 40-page table of 8-token pages (5 tiles of 64
    columns), KV 2, G 2, q at 3x the keys' spread, in one form: "linear"
    (a decode step and a 3-row chunk, one slot mid-page), "window" (20
    keys), "ring" (a 6-page ring after several wraps, window 24) or "tree"
    (a branchy 6-node tree). ``pool`` "fp32", "bf16" (q, pool and stage in
    that dtype) or "e4m3" (fp32 q and stage over e4m3 codes)."""
    rng = np.random.default_rng(seed)
    S, KV, G, D, bs, nb, Ts = 2, 2, 2, 64, 8, 96, 8
    H = KV * G
    T = {"linear": 3, "window": 3, "ring": 2, "tree": 6}[form]
    mp = 6 if form == "ring" else 40
    q = rng.standard_normal((S, T, H, D)).astype(np.float32) * 3
    kv = rng.standard_normal((2, 2, KV, nb, bs, D)).astype(np.float32)
    ks = rng.standard_normal((S, KV, Ts, D)).astype(np.float32)
    vs = rng.standard_normal((S, KV, Ts, D)).astype(np.float32)
    tables = np.zeros((S, mp), np.int32)
    for s in range(S):
        tables[s] = rng.permutation(np.arange(1, nb))[:mp]
    kw = {}
    if form == "ring":
        sst = [211, 333]
        kw.update(window=24, ring_tokens=6 * bs)
    else:
        sst = [301, 157]
        if form == "window":
            kw.update(window=20)
    lens = [c + T for c in sst]
    qst = list(sst)
    if form == "tree":
        parents, depth = [-1, 0, 0, 1, 2, 3], [0, 1, 1, 2, 2, 3]
        pos = np.zeros((S, T), np.int32)
        mask = np.zeros((S, T, T), np.uint8)
        for s in range(S):
            pos[s] = [sst[s] + d for d in depth]
            for i in range(T):
                j = i
                while j != -1:
                    mask[s, i, j] = 1
                    j = parents[j]
        lens = [c + 4 for c in sst]
        kw.update(tree_positions=torch.from_numpy(pos),
                  tree_mask=torch.from_numpy(mask))
    dt = {"fp32": torch.float32, "bf16": torch.bfloat16,
          "e4m3": torch.float32}[pool]
    t_pool = torch.from_numpy(kv).to(dt)
    if pool == "e4m3":
        t_pool = to_e4m3(t_pool)
    i32 = lambda v: torch.tensor(v, dtype=torch.int32)
    args = [torch.from_numpy(q).to(dt), t_pool, torch.from_numpy(ks).to(dt),
            torch.from_numpy(vs).to(dt), torch.from_numpy(tables), i32(lens),
            i32(qst), i32(sst)]
    return args, dict(block_size=bs, layer_index=1, **kw)


def _plain(args, kw, splits):
    return pa.paged_ragged_attention_reference(
        *args, p_round_blocks=(TILE, TILE), p_round_splits=splits, **kw)


@pytest.mark.parametrize("pool", ["fp32", "bf16", "e4m3"])
def test_a_split_as_wide_as_the_table_is_the_unsplit_walk(pool):
    """One split over the whole table walks the pool as the chunk kernel
    does: the result is today's, bit for bit. (The e4m3 case keeps its
    queries before the stage — q_starts one below stage_starts, seq_lens
    at stage_starts — since the split kernel's stage is a split of its
    own.)"""
    args, kw = _case("linear", pool)
    if pool == "e4m3":
        args[5] = args[7].clone()
        args[6] = args[7] - 1
    width = args[4].shape[1] * kw["block_size"]
    got = _plain(args, kw, -(-width // TILE) * TILE)
    want = _plain(args, kw, None)
    assert torch.equal(got, want)


@pytest.mark.parametrize("pool", ["fp32", "bf16"])
@pytest.mark.parametrize("form", ["linear", "window", "ring", "tree"])
@pytest.mark.parametrize("splits", [TILE, 2 * TILE, 3 * TILE])
def test_splits_keep_bf16_and_fp32_pools_to_fp32_noise(pool, form, splits):
    """Over a pool of q's dtype p rounds against the softmax's own max, so
    cutting the walk into splits leaves the result within fp32 noise of the
    unsplit one (here: exactly)."""
    args, kw = _case(form, pool, seed=1)
    got = _plain(args, kw, splits).float()
    want = _plain(args, kw, None).float()
    assert ((got - want).abs().max() / want.abs().max()).item() <= 1e-6


@pytest.mark.parametrize("form", ["linear", "window", "ring", "tree"])
def test_e4m3_splits_move_where_p_rounds(form):
    """Over an e4m3 pool the splits are part of the numerics: p rounds
    against each split's running max. The result moves (by about an e4m3
    rounding step of some p) and stays within the kernel phase's e4m3
    tolerance of the unsplit walk (1e-2 of max |plain|)."""
    args, kw = _case(form, "e4m3", seed=2)
    got = _plain(args, kw, TILE)
    want = _plain(args, kw, None)
    err = ((got - want).abs().max() / want.abs().max()).item()
    assert 0 < err <= 1e-2


def test_running_max_restarts_at_splits_and_the_stage():
    """Pool columns in blocks of ``pb``, ``split`` columns a split: the
    running max starts again at each split and at the stage."""
    s = torch.tensor([[1., 5., 2., 0., 9., 3., -1., 4., 2., 6.]])
    # pool [1 5 | 2 0 || 9 3 | -1 4], stage [2 | 6]: splits of 4 columns
    got = pa._running_max(s, ctx=8, pb=2, sb=1, split=4)
    assert got.tolist() == [[5, 5, 5, 5, 9, 9, 9, 9, 2, 6]]
    # without splits the pool's max carries into the stage
    got = pa._running_max(s, ctx=8, pb=2, sb=1)
    assert got.tolist() == [[5, 5, 5, 5, 9, 9, 9, 9, 9, 9]]
    # a split ahead of its first valid key holds -inf until it comes; a
    # ragged last split is cut at the pool's end
    inf = float("-inf")
    s = torch.tensor([[3., 1., inf, inf, inf, 2., 7.]])
    got = pa._running_max(s, ctx=6, pb=1, sb=1, split=2)
    assert got.tolist() == [[3, 3, inf, inf, inf, 2, 7]]
    with pytest.raises(ValueError, match="multiple"):
        pa._running_max(s, ctx=6, pb=4, sb=1, split=6)


def _e4m3_long_case(seed, T):
    """The long-context e4m3 case of tests/test_torch_paged_attention.py
    (``_e4m3_case``): ~217 tokens over 28 pages of 8 and the stage, K/V
    unit-normal and q at 3x; and the Pallas kernel's output on it."""
    rng = np.random.default_rng(seed)
    S, KV, G, D, bs, nb, mp, Ts = 2, 2, 2, 64, 8, 64, 28, 8
    pool = rng.standard_normal((2, 2, KV, nb, bs, D)).astype(np.float32) * .3
    q = rng.standard_normal((S, T, KV * G, D)).astype(np.float32) * .3
    ks = rng.standard_normal((S, KV, Ts, D)).astype(np.float32) * .3
    vs = rng.standard_normal((S, KV, Ts, D)).astype(np.float32) * .3
    tables = np.zeros((S, mp), np.int32)
    for s in range(S):
        tables[s] = rng.permutation(np.arange(1, nb))[:mp]
    pool, ks, vs, q = pool / .3, ks / .3, vs / .3, q / .3 * 3
    pool8 = jnp.asarray(pool).astype(jnp.float8_e4m3fn)
    sst = [27 * 8, 25 * 8 + 3]
    ints = [np.asarray(x, np.int32) for x in ([s + T for s in sst], sst,
                                              sst)]
    pallas = np.asarray(jax_paged_ragged_attention(
        jnp.asarray(q), pool8, jnp.asarray(ks), jnp.asarray(vs),
        jnp.asarray(tables), *map(jnp.asarray, ints), block_size=8,
        layer_index=jnp.int32(1), interpret=True))
    t_pool = torch.from_numpy(np.asarray(pool8).view(np.uint8).copy()).view(
        torch.float8_e4m3fn)
    args = [torch.from_numpy(q), t_pool, torch.from_numpy(ks),
            torch.from_numpy(vs), torch.from_numpy(tables),
            *map(torch.from_numpy, ints)]
    return args, pallas


def _unrounded(args, block_size=8, layer_index=1):
    """The e4m3 form's attention with p never rounded: pool keys score
    against q rounded to e4m3, stage keys against q, one fp32 softmax over
    the keys each query sees."""
    q, pool, ks, vs, tables, lens, qst, sst = args
    S, T, H, D = q.shape
    KV, Ts = pool.shape[2], ks.shape[2]
    G, bs = H // KV, block_size
    ctx = tables.shape[1] * bs
    blocks = tables.long().repeat_interleave(bs, dim=1)
    offs = torch.arange(ctx) % bs
    gather = lambda half: pool.view(torch.uint8)[layer_index, half][
        :, blocks, offs[None]].view(pool.dtype).float().permute(1, 0, 2, 3)
    K = torch.cat([gather(0), ks.float()], dim=2)
    V = torch.cat([gather(1), vs.float()], dim=2)
    _, _, mask = pa.key_visibility(tables, lens, qst, sst, T=T, Ts=Ts,
                                   block_size=bs)
    q8 = to_e4m3(q).float().reshape(S, T, KV, G, D)
    qg = q.float().reshape(S, T, KV, G, D)
    scores = torch.cat([
        torch.einsum("stkgd,skcd->sktgc", q8, K[:, :, :ctx]),
        torch.einsum("stkgd,skcd->sktgc", qg, K[:, :, ctx:])], dim=-1)
    scores = (scores / D ** 0.5).masked_fill(~mask[:, None, :, None],
                                             float("-inf"))
    p = torch.softmax(scores, dim=-1)
    o = torch.einsum("sktgc,skcd->sktgd", p, V)
    return o.permute(0, 2, 1, 3, 4).reshape(S, T, H, D).numpy()


#: how much further from the unrounded softmax the split-rounded plain
#: version may be than the Pallas page walk, by (max |error|, mean |error|)
#: over (max, mean) |exact|. Splitting moves where p rounds (each split's
#: running max is at most the walk's, so p sits no closer to e4m3's
#: subnormals) and must not make the result worse; the 64-key tiles
#: themselves round coarser than the Pallas walk's 8-key pages (the unsplit
#: 64-key walk's mean error is 1.1-1.3x the Pallas walk's over seeds 11-16),
#: and the max of a few hundred outputs is one rounding step's luck.
#: Measured over seeds 11-16: max ratio up to 1.68, mean ratio 0.80-1.21.
SPLIT_SLACK = (2.0, 1.25)


@pytest.mark.parametrize("seed", [11, 12])
@pytest.mark.parametrize("T", [1, 4])
@pytest.mark.parametrize("splits", [TILE, 2 * TILE])
def test_e4m3_split_rounding_is_no_worse_than_the_pallas_walk(seed, T,
                                                              splits):
    """On the long-context e4m3 shapes, the plain version rounding p where
    the split kernel does (64-key tiles, a restart every ``splits``
    columns and at the stage) is no further from the unrounded fp32
    softmax than the Pallas kernel's page walk is, within SPLIT_SLACK, and
    on average no further than the unsplit 64-key walk (today's chunk
    kernel)."""
    args, pallas = _e4m3_long_case(seed, T)
    exact = _unrounded(args)

    def errs(out):
        d = np.abs(out - exact)
        return d.max() / np.abs(exact).max(), d.mean() / np.abs(exact).mean()

    walk = lambda splits: pa.paged_ragged_attention_reference(
        *args, block_size=8, layer_index=1, p_round_blocks=(TILE, TILE),
        p_round_splits=splits).numpy()
    split_max, split_mean = errs(walk(splits))
    pallas_max, pallas_mean = errs(pallas)
    assert 0 < split_max <= SPLIT_SLACK[0] * pallas_max
    assert 0 < split_mean <= SPLIT_SLACK[1] * pallas_mean
    assert split_mean <= errs(walk(None))[1]


def test_kernel_route_is_by_rows_and_dtype():
    """fp32 takes the CUDA-core kernel; bf16 the split kernel up to 16 rows
    per (slot, KV head), the chunk kernel above."""
    assert pa.kernel_route(torch.float32, 1) == "fma"
    assert pa.kernel_route(torch.float32, 4096) == "fma"
    assert pa.kernel_route(torch.bfloat16, 1) == "split"
    assert pa.kernel_route(torch.bfloat16, pa.SPLIT_MAX_ROWS) == "split"
    assert pa.kernel_route(torch.bfloat16, pa.SPLIT_MAX_ROWS + 1) == "chunk"
    # the serving shapes: a decode-window step of mistral (G 4), llama2-7b's
    # 8-node tree (G 1), mistral's (32 rows), a 256-token prefill chunk
    q = lambda T, H: torch.zeros(8, T, H, 128, dtype=torch.bfloat16)
    assert pa.kernel_plan(q(1, 32), 8, 69, 64, sms=132)[0] == "split"
    assert pa.kernel_plan(q(8, 32), 32, 20, 64, sms=132)[0] == "split"
    assert pa.kernel_plan(q(8, 32), 8, 20, 64, sms=132) == ("chunk", 0)
    assert pa.kernel_plan(q(256, 32), 8, 69, 64, sms=132) == ("chunk", 0)
    assert pa.kernel_plan(q(1, 32).float(), 8, 69, 64, sms=132) == ("fma", 0)


@pytest.mark.parametrize("S,KV,max_pages,bs", [
    (8, 8, 69, 64),      # mistral's ring decode: 64 (slot, head) pairs
    (8, 32, 20, 64),     # llama2-7b decode
    (8, 16, 20, 64),     # qwen2-moe decode
    (1, 1, 3, 8),        # a table narrower than a tile
    (4, 2, 300, 16),     # many tiles, few pairs
    (64, 32, 128, 64),   # more pairs than the card has SMs
])
def test_split_columns_fill_the_card_twice(S, KV, max_pages, bs):
    """Whole 64-column tiles per split; the fewest splits that give each of
    132 SMs two blocks, never more splits than tiles; the splits cover the
    table."""
    width = max_pages * bs
    tiles = -(-width // TILE)
    cols = pa.split_columns(S, KV, max_pages, bs, 132)
    n = -(-width // cols)
    assert cols % TILE == 0 and n * cols >= width
    assert n * S * KV >= pa.SPLIT_FILL * 132 or n == tiles
    # and not many more: under twice the splits that fill the card
    want = -(-pa.SPLIT_FILL * 132 // (S * KV))
    assert n <= max(2 * want - 1, 1) or n == tiles
