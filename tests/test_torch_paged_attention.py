"""The paged-attention kernel's plain PyTorch version
(``deepspeed_tpu_torch.ops.paged_attention``) against the JAX package's
Pallas kernel ``paged_ragged_attention`` run in interpret mode, as the JAX
package's own tests run it on the CPU (tests/test_paged_attention_groups.py).

Same seeded inputs, fp32, tolerance 2e-5 (the two sum in different orders).
Live slots compare element by element; an empty slot is zeros in both."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.pallas.paged_attention import \
    paged_ragged_attention as jax_paged_ragged_attention
from deepspeed_tpu_torch.ops import paged_attention as pa


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _inputs(rng, *, S=2, T=1, KV=2, G=2, D=64, bs=8, nb=16, max_pages=4,
            Ts=8):
    H = KV * G
    pool = rng.standard_normal((2, 2, KV, nb, bs, D)).astype(np.float32) * .3
    q = rng.standard_normal((S, T, H, D)).astype(np.float32) * .3
    ks = rng.standard_normal((S, KV, Ts, D)).astype(np.float32) * .3
    vs = rng.standard_normal((S, KV, Ts, D)).astype(np.float32) * .3
    tables = np.zeros((S, max_pages), np.int32)       # trash-padded
    for s in range(S):
        tables[s] = rng.permutation(np.arange(1, nb))[:max_pages]
    return pool, q, ks, vs, tables


def _both(pool, q, ks, vs, tables, seq_lens, q_starts, stage_starts, **kw):
    ints = [np.asarray(x, np.int32) for x in (seq_lens, q_starts,
                                              stage_starts)]
    ref = jax_paged_ragged_attention(
        jnp.asarray(q), jnp.asarray(pool), jnp.asarray(ks), jnp.asarray(vs),
        jnp.asarray(tables), *map(jnp.asarray, ints), layer_index=jnp.int32(1),
        interpret=True, **kw)
    got = pa.paged_ragged_attention(
        torch.from_numpy(q), torch.from_numpy(pool), torch.from_numpy(ks),
        torch.from_numpy(vs), torch.from_numpy(tables),
        *map(torch.from_numpy, ints), layer_index=1, **kw)
    return np.asarray(ref), got.numpy()


CONFIGS = {
    # pool context spans several pages; decode query at the end
    "plain": dict(window=None, ring_tokens=None, stage_starts=[20, 9],
                  seq_lens=[21, 10], q_starts=[20, 9]),
    # sliding window binds inside the pool span
    "window": dict(window=12, ring_tokens=None, stage_starts=[26, 15],
                   seq_lens=[27, 16], q_starts=[26, 15]),
    # rolling ring: the table is a 4-slot ring, positions wrapped past it
    "ring": dict(window=24, ring_tokens=32, stage_starts=[45, 37],
                 seq_lens=[46, 38], q_starts=[45, 37]),
    # the same ring after three and five wraps, one slot mid-page
    "ring_wrapped": dict(window=24, ring_tokens=32, stage_starts=[109, 163],
                         seq_lens=[110, 164], q_starts=[109, 163]),
}


@pytest.mark.parametrize("cfg", sorted(CONFIGS))
@pytest.mark.parametrize("G", [1, 2, 4])
def test_plain_matches_pallas_decode(cfg, G):
    c = CONFIGS[cfg]
    pool, q, ks, vs, tables = _inputs(np.random.default_rng(3), G=G)
    ref, got = _both(pool, q, ks, vs, tables, c["seq_lens"], c["q_starts"],
                     c["stage_starts"], block_size=8, window=c["window"],
                     ring_tokens=c["ring_tokens"])
    np.testing.assert_allclose(got, ref, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("window", [None, 9])
def test_plain_matches_pallas_window_stage(window):
    """A decode window's stage: T=1 queries over a multi-row stage whose
    base stays at the window start (Ts > T), past one page (Ts = 2 pages)."""
    pool, q, ks, vs, tables = _inputs(np.random.default_rng(5), S=3, G=2,
                                      Ts=16, max_pages=6, nb=24)
    # stage rows 0..k-1 valid, the query sits on the last one
    sst, n = [16, 9, 0], [11, 3, 1]
    lens = [s + k for s, k in zip(sst, n)]
    ref, got = _both(pool, q, ks, vs, tables, lens,
                     [x - 1 for x in lens], sst, block_size=8, window=window)
    np.testing.assert_allclose(got, ref, rtol=2e-5, atol=2e-5)


def test_plain_matches_pallas_prefill_chunk_with_empty_slot():
    """A prefill chunk (T=20, stage of 24 rows = 3 pages) over several pool
    pages, a ragged chunk and an empty slot."""
    pool, q, ks, vs, tables = _inputs(np.random.default_rng(7), S=3, T=20,
                                      Ts=24, G=2, max_pages=8, nb=32)
    lens, starts = [36, 30, 0], [16, 10, 0]
    ref, got = _both(pool, q, ks, vs, tables, lens, starts, starts,
                     block_size=8)
    np.testing.assert_allclose(got[:2], ref[:2], rtol=2e-5, atol=2e-5)
    assert np.all(got[2] == 0) and np.all(ref[2] == 0)


def test_plain_matches_pallas_tree_verify():
    """Tree verify (speculative decoding): per-node positions and an
    ancestors-only mask over the stage columns."""
    rng = np.random.default_rng(13)
    T = 6
    pool, q, ks, vs, tables = _inputs(rng, T=T, Ts=8)
    parents, depth = [-1, 0, 0, 1, 2, 3], [0, 1, 1, 2, 2, 3]
    S = q.shape[0]
    pos = np.zeros((S, T), np.int32)
    mask = np.zeros((S, T, T), np.uint8)
    lens, sst = np.zeros(S, np.int32), np.zeros(S, np.int32)
    for s in range(S):
        root = 18 - s * 7
        pos[s] = [root + d for d in depth]
        for i in range(T):
            j = i
            while j != -1:
                mask[s, i, j] = 1
                j = parents[j]
        lens[s], sst[s] = root + 1 + max(depth), root
    ref = jax_paged_ragged_attention(
        jnp.asarray(q), jnp.asarray(pool), jnp.asarray(ks), jnp.asarray(vs),
        jnp.asarray(tables), jnp.asarray(lens), jnp.asarray(pos[:, 0].copy()),
        jnp.asarray(sst), block_size=8, layer_index=jnp.int32(1),
        tree_positions=jnp.asarray(pos), tree_mask=jnp.asarray(mask),
        interpret=True)
    got = pa.paged_ragged_attention(
        *map(torch.from_numpy, (q, pool, ks, vs, tables, lens,
                                pos[:, 0].copy(), sst)), block_size=8,
        layer_index=1, tree_positions=torch.from_numpy(pos),
        tree_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-5,
                               atol=2e-5)


def test_cpu_tensors_take_the_plain_route_and_count_it():
    pool, q, ks, vs, tables = _inputs(np.random.default_rng(0))
    args = [torch.from_numpy(a) for a in (q, pool, ks, vs, tables)] + [
        torch.tensor(x, dtype=torch.int32) for x in ([21, 10], [20, 9],
                                                     [20, 9])]
    before = (pa.counts.kernel, pa.counts.plain)
    got = pa.paged_ragged_attention(*args, block_size=8, layer_index=1)
    assert (pa.counts.kernel, pa.counts.plain) == (before[0], before[1] + 1)
    ref = pa.paged_ragged_attention_reference(*args, block_size=8,
                                              layer_index=1)
    assert pa.counts.plain == before[1] + 1     # direct calls don't count
    assert torch.equal(got, ref)


def test_p_is_rounded_to_v_dtype_and_l_is_not():
    """bf16 inputs: the plain version rounds p to bf16 before the PV
    product (the kernel's numerics) — its output differs from an all-fp32
    softmax by about bf16's rounding, not more."""
    pool, q, ks, vs, tables = _inputs(np.random.default_rng(2))
    ints = [torch.tensor(x, dtype=torch.int32) for x in ([21, 10], [20, 9],
                                                         [20, 9])]
    t = [torch.from_numpy(a) for a in (q, pool, ks, vs)]
    f32 = pa.paged_ragged_attention_reference(
        *t, torch.from_numpy(tables), *ints, block_size=8, layer_index=1)
    bf = pa.paged_ragged_attention_reference(
        *[x.bfloat16() for x in t], torch.from_numpy(tables), *ints,
        block_size=8, layer_index=1)
    assert bf.dtype == torch.bfloat16
    err = (bf.float() - f32).abs().max().item()
    assert 0 < err < 2e-2


LLAMA = dict(num_heads=32, kv_heads=32, head_dim=128, block_size=64)
TINY = dict(num_heads=4, kv_heads=2, head_dim=16, block_size=8)


@pytest.mark.parametrize("device_type,geo,pin,alibi,sm90,want", [
    ("cuda", LLAMA, None, False, True, "cuda"),
    ("cpu", LLAMA, None, False, False, "plain"),
    ("cpu", TINY, None, False, False, "gather"),   # CPU: by design
    ("cuda", LLAMA, None, True, True, "gather"),   # ALiBi: no kernel bias
    ("cuda", LLAMA, False, False, True, "gather"),  # explicit pin
    ("cuda", LLAMA, None, False, False, NotImplementedError),  # not sm_90
    ("cuda", TINY, None, False, True, NotImplementedError),    # geometry
    ("cuda", TINY, True, False, True, ValueError),  # pin demands the kernel
])
def test_registry_never_falls_back_on_cuda(device_type, geo, pin, alibi,
                                           sm90, want):
    from deepspeed_tpu_torch.inference.attn_registry import select_attention

    kw = dict(mode="decode", device_type=device_type, use_kernel=pin,
              alibi=alibi, sm90=sm90, **geo)
    if isinstance(want, type):
        with pytest.raises(want):
            select_attention(**kw)
    else:
        sel = select_attention(**kw)
        assert sel.path == want
        assert (sel.reason == "") == sel.is_kernel


@pytest.mark.parametrize("device_type,pin,verify,alibi,want", [
    ("cuda", None, None, False, "cuda"),          # the decode selection
    ("cpu", None, None, False, "plain"),
    ("cuda", None, False, False, "gather"),       # spec_verify_pallas pin
    ("cuda", False, None, False, "gather"),       # use_pallas_decode pin
    ("cuda", False, True, False, ValueError),     # gather-pinned engine
    ("cuda", None, None, True, "gather"),         # ALiBi
    ("cuda", None, True, True, ValueError),       # pin demands the kernel
])
def test_registry_tree_mode_takes_the_verify_pin(device_type, pin, verify,
                                                 alibi, want):
    from deepspeed_tpu_torch.inference.attn_registry import select_attention

    kw = dict(mode="tree", device_type=device_type, use_kernel=pin,
              verify_pin=verify, alibi=alibi, sm90=True, **LLAMA)
    if isinstance(want, type):
        with pytest.raises(want, match="spec_verify_pallas"):
            select_attention(**kw)
    else:
        sel = select_attention(**kw)
        assert (sel.path, sel.mode) == (want, "tree")
        assert ("spec_verify_pallas" in sel.reason) == (verify is False)


def test_plain_version_alibi_bias_matches_a_dense_softmax():
    """``alibi_slopes`` adds slope * (key_pos - query_pos) to the scaled
    scores: a decode step over pool + stage equals a dense masked softmax
    over the same keys."""
    pool, q, ks, vs, tables = _inputs(np.random.default_rng(11), S=1, G=2)
    t = [torch.from_numpy(a) for a in (q, pool, ks, vs, tables)]
    sst, lens = 13, 16                               # 3 stage rows
    slopes = torch.tensor([0.5, 0.25, 0.125, 0.0625])
    ints = [torch.tensor([x], dtype=torch.int32) for x in (lens, lens - 1,
                                                           sst)]
    got = pa.paged_ragged_attention_reference(
        *t, *ints, block_size=8, layer_index=1, alibi_slopes=slopes)[0, 0]
    blocks = [int(tables[0, j // 8]) for j in range(sst)]
    K = torch.cat([torch.stack([t[1][1, 0, :, b, j % 8]
                                for j, b in enumerate(blocks)], 1),
                   t[2][0, :, :lens - sst]], 1)              # [KV, lens, D]
    V = torch.cat([torch.stack([t[1][1, 1, :, b, j % 8]
                                for j, b in enumerate(blocks)], 1),
                   t[3][0, :, :lens - sst]], 1)
    K, V = K.repeat_interleave(2, 0), V.repeat_interleave(2, 0)
    s = torch.einsum("hd,hcd->hc", t[0][0, 0], K) / 8.0
    s = s + slopes[:, None] * (torch.arange(lens) - (lens - 1))[None]
    want = torch.einsum("hc,hcd->hd", torch.softmax(s, -1), V)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)


def test_usable_gate():
    assert pa.paged_attention_usable(32, 32, 128, 64)
    assert pa.paged_attention_usable(32, 8, 64, 8)
    assert not pa.paged_attention_usable(4, 2, 16, 8)     # tiny head dim
    assert not pa.paged_attention_usable(6, 4, 128, 64)   # ragged GQA
    assert not pa.paged_attention_usable(32, 32, 128, 12)  # unaligned page


def _e4m3_case(seed, T, **kw):
    """A ~217-token context on an e4m3 pool (27 pages of 8, plus the stage),
    K/V unit-normal and q at 3x: a peaked softmax, so a wrong score or a
    wrong p rounding moves the output. ``kw`` goes to the Pallas kernel."""
    rng = np.random.default_rng(seed)
    pool, q, ks, vs, tables = _inputs(rng, T=T, max_pages=28, nb=64)
    pool, ks, vs, q = pool / .3, ks / .3, vs / .3, q / .3 * 3
    pool8 = jnp.asarray(pool).astype(jnp.float8_e4m3fn)
    sst = [27 * 8, 25 * 8 + 3]
    ints = [np.asarray(x, np.int32) for x in ([s + T for s in sst], sst,
                                              sst)]
    ref = np.asarray(jax_paged_ragged_attention(
        jnp.asarray(q), pool8, jnp.asarray(ks), jnp.asarray(vs),
        jnp.asarray(tables), *map(jnp.asarray, ints), block_size=8,
        layer_index=jnp.int32(1), interpret=True, **kw))
    t_pool = torch.from_numpy(np.asarray(pool8).view(np.uint8).copy()).view(
        torch.float8_e4m3fn)
    args = (torch.from_numpy(q), t_pool, torch.from_numpy(ks),
            torch.from_numpy(vs), torch.from_numpy(tables),
            *map(torch.from_numpy, ints))
    return ref, args


#: the e4m3 plain version against the Pallas kernel, max |error| over
#: max |Pallas|: both round q and p to e4m3 at the same points, so they
#: differ by fp32 summation order (measured at most 1.2e-6 over 12 seeds)
E4M3_TOL = 2e-5


def _e4m3_err(got, ref):
    return np.abs(got - ref).max() / np.abs(ref).max()


@pytest.mark.parametrize("seed", [11, 12])
@pytest.mark.parametrize("T", [1, 4])
def test_e4m3_pool_plain_matches_pallas_long_context(seed, T):
    """The plain version's e4m3-pool form (q rounded to e4m3 for pool keys,
    p scaled by 448 and rounded to e4m3 for pool values against the running
    max of the Pallas page walk) against the Pallas kernel in interpret
    mode, as tests/test_paged_attention_groups.py runs it. Negative
    controls fail the same tolerance by orders of magnitude: the old
    reading (the pool upcast to q's dtype, no scale; measured >= 2.6e-2)
    and p rounded against one max per source instead of the page walk's."""
    ref, args = _e4m3_case(seed, T)
    got = pa.paged_ragged_attention(*args, block_size=8, layer_index=1)
    assert _e4m3_err(got.numpy(), ref) <= E4M3_TOL
    old = pa.paged_ragged_attention_reference(*args, block_size=8,
                                              layer_index=1, upcast_pool=True)
    assert _e4m3_err(old.numpy(), ref) > 100 * E4M3_TOL
    flat = pa.paged_ragged_attention_reference(
        *args, block_size=8, layer_index=1, p_round_blocks=(4096, 4096))
    assert _e4m3_err(flat.numpy(), ref) > 10 * E4M3_TOL


def test_e4m3_upcast_reading_is_the_gather_formulation():
    """``upcast_pool`` (the engine's gather route) reads an e4m3 pool as
    q's dtype with no scale: exactly the plain version over the pool's
    values in fp32."""
    _, args = _e4m3_case(13, 2)
    got = pa.paged_ragged_attention_reference(*args, block_size=8,
                                              layer_index=1, upcast_pool=True)
    want = pa.paged_ragged_attention_reference(
        args[0], args[1].float(), *args[2:], block_size=8, layer_index=1)
    assert torch.equal(got, want)


def test_running_max_follows_the_key_walk():
    """p's rounding max per column: pool columns in blocks of ``pb``, then
    stage rows in blocks of ``sb``, each the max of every block so far."""
    s = torch.tensor([[1., 5., 2., 0., 9., 3., -1., 4.]])
    got = pa._running_max(s, ctx=5, pb=2, sb=2)
    assert got.tolist() == [[5, 5, 5, 5, 9, 9, 9, 9]]
    got = pa._running_max(s, ctx=6, pb=4, sb=1)
    assert got.tolist() == [[5, 5, 5, 5, 9, 9, 9, 9]]
    got = pa._running_max(torch.tensor([[float("-inf"), 2., 1., 7.]]),
                          ctx=2, pb=1, sb=1)
    assert got.tolist() == [[float("-inf"), 2, 2, 7]]


@pytest.mark.parametrize("page_group", [2, 4])
@pytest.mark.parametrize("cfg", ["plain", "window", "ring_wrapped"])
def test_plain_matches_pallas_page_groups(cfg, page_group):
    """``page_group`` pool pages per Pallas grid step change no arithmetic
    of the fp32 form: the plain version (which walks no grid) matches the
    grouped kernel to summation order."""
    c = CONFIGS[cfg]
    pool, q, ks, vs, tables = _inputs(np.random.default_rng(17), G=2)
    ref, got = _both(pool, q, ks, vs, tables, c["seq_lens"], c["q_starts"],
                     c["stage_starts"], block_size=8, window=c["window"],
                     ring_tokens=c["ring_tokens"], page_group=page_group)
    np.testing.assert_allclose(got, ref, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("page_group", [2, 4])
def test_e4m3_plain_matches_grouped_pallas_with_its_rounding_blocks(
        page_group):
    """Over an e4m3 pool the grouped Pallas kernel rounds p against the
    running max of ``page_group`` pages at a time: the plain version with
    ``p_round_blocks = (page_group * block_size, stage rows)`` matches it,
    and the one-page default does not."""
    T = 4
    ref, args = _e4m3_case(21, T, page_group=page_group)
    got = pa.paged_ragged_attention_reference(
        *args, block_size=8, layer_index=1, p_round_blocks=(page_group * 8, 8))
    assert _e4m3_err(got.numpy(), ref) <= E4M3_TOL
    one_page = pa.paged_ragged_attention(*args, block_size=8, layer_index=1,
                                         page_group=page_group)
    assert _e4m3_err(one_page.numpy(), ref) > 10 * E4M3_TOL


def test_plain_matches_pallas_ring_chunk_after_wraps():
    """A prefill chunk (T=8, a ragged second row) over a 5-page ring after
    two and four wraps, with the window binding inside the ring."""
    pool, q, ks, vs, tables = _inputs(np.random.default_rng(19), T=8, Ts=8,
                                      G=2, max_pages=5, nb=24)
    sst = [100, 161]
    ref, got = _both(pool, q, ks, vs, tables, [108, 166], sst, sst,
                     block_size=8, window=24, ring_tokens=40)
    np.testing.assert_allclose(got, ref, rtol=2e-5, atol=2e-5)


def _tree_case(rng, T=6, G=2, **kw):
    """A branchy tree (root with two children, chains below) per slot, its
    positions root + depth, the ancestors mask, and the Pallas inputs."""
    pool, q, ks, vs, tables = _inputs(rng, T=T, Ts=8, G=G, **kw)
    parents, depth = [-1, 0, 0, 1, 2, 3], [0, 1, 1, 2, 2, 3]
    S = q.shape[0]
    pos = np.zeros((S, T), np.int32)
    mask = np.zeros((S, T, T), np.uint8)
    lens, sst = np.zeros(S, np.int32), np.zeros(S, np.int32)
    for s in range(S):
        root = 18 - s * 7
        pos[s] = [root + d for d in depth]
        for i in range(T):
            j = i
            while j != -1:
                mask[s, i, j] = 1
                j = parents[j]
        lens[s], sst[s] = root + 1 + max(depth), root
    return pool, q, ks, vs, tables, lens, sst, pos, mask


@pytest.mark.parametrize("window", [None, 9])
def test_e4m3_tree_verify_plain_matches_pallas(window):
    """Tree verify over an e4m3 pool: q rounded to e4m3 for pool keys, p
    scaled by 448 for every key (the stage's nodes too), against the
    Pallas kernel in interpret mode, with and without a window."""
    pool, q, ks, vs, tables, lens, sst, pos, mask = _tree_case(
        np.random.default_rng(23))
    pool, ks, vs, q = pool / .3, ks / .3, vs / .3, q / .3 * 3
    pool8 = jnp.asarray(pool).astype(jnp.float8_e4m3fn)
    kw = dict(block_size=8, window=window)
    ref = np.asarray(jax_paged_ragged_attention(
        jnp.asarray(q), pool8, jnp.asarray(ks), jnp.asarray(vs),
        jnp.asarray(tables), jnp.asarray(lens), jnp.asarray(pos[:, 0].copy()),
        jnp.asarray(sst), layer_index=jnp.int32(1),
        tree_positions=jnp.asarray(pos), tree_mask=jnp.asarray(mask),
        interpret=True, **kw))
    t_pool = torch.from_numpy(np.asarray(pool8).view(np.uint8).copy()).view(
        torch.float8_e4m3fn)
    got = pa.paged_ragged_attention(
        torch.from_numpy(q), t_pool, *map(torch.from_numpy, (
            ks, vs, tables, lens, pos[:, 0].copy(), sst)), layer_index=1,
        tree_positions=torch.from_numpy(pos),
        tree_mask=torch.from_numpy(mask), **kw)
    assert _e4m3_err(got.numpy(), ref) <= E4M3_TOL
    # negative control: the pool read upcast with no scale
    old = pa.paged_ragged_attention_reference(
        torch.from_numpy(q), t_pool, *map(torch.from_numpy, (
            ks, vs, tables, lens, pos[:, 0].copy(), sst)), layer_index=1,
        tree_positions=torch.from_numpy(pos),
        tree_mask=torch.from_numpy(mask), upcast_pool=True, **kw)
    assert _e4m3_err(old.numpy(), ref) > 100 * E4M3_TOL


def test_key_visibility_of_a_ring_follows_table_order():
    """Pool column j of a 3-page ring (bs 4) holds the newest block b with
    b % 3 == j // 4; offsets at or past stage_starts are the previous wrap,
    and never-written ones are invalid."""
    tables = torch.zeros(1, 3, dtype=torch.int32)
    one = lambda v: torch.tensor([v], dtype=torch.int32)
    cpos, qpos, mask = pa.key_visibility(
        tables, one(30), one(29), one(29), T=1, Ts=1, block_size=4,
        window=10, ring_tokens=12)
    # positions 24..28 in blocks 6 (column 0) and 7 (column 4); block 5's
    # offsets 20..23 at columns 8..11; the stage row at 29
    assert cpos[0].tolist() == [24, 25, 26, 27, 28, 17, 18, 19, 20, 21, 22,
                                23, 29]
    vis = [c for c, m in zip(cpos[0].tolist(), mask[0, 0].tolist()) if m]
    assert sorted(vis) == list(range(20, 30))      # (29 - 10, 29]
    cpos, _, mask = pa.key_visibility(
        tables, one(6), one(5), one(5), T=1, Ts=1, block_size=4, window=10,
        ring_tokens=12)
    assert cpos[0, :5].tolist() == [0, 1, 2, 3, 4]
    assert not mask[0, 0, 8:12].any()           # column 2: never written
