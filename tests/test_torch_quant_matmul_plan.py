"""K2's and K3's plan on the card in the port (``deepspeed_tpu_torch.ops.
quant_matmul``): which kernels a call takes, from x's dtype and the codes'
bits (``kernel_route``), the wgmma route's token columns and K split
(``tc_tokens``, ``tc_split``), K3's windows and runs of same-expert 32-row
sub-tiles (``grouped_run_tiles``, ``grouped_runs``), the integer arguments
each C entry receives, and the operands it refuses.

The plain versions composed as the kernel composes them (K2 window by
window and split by split, the fp32 partials summed in split order; K3 run
by run, each expert's weight dequantized once per run) are held against the
JAX package's Pallas ``quant_matmul`` and ``quant_grouped_matmul``
(``deepspeed_tpu/ops/pallas/quant_matmul.py``, interpret mode on the CPU as
``tests/test_quant_matmul.py`` runs it) on the same seeded numpy inputs, in
fp32, within 1e-5 of max |JAX| (the same exact products summed in other
orders). The launch tests replace the kernel library with a recorder: no
CUDA kernel runs on the CPU."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.pallas import grouped_matmul as jg
from deepspeed_tpu.ops.pallas import quant_matmul as jq
from deepspeed_tpu_torch.inference.weights import params_from_jax
from deepspeed_tpu_torch.ops import grouped_matmul as tg
from deepspeed_tpu_torch.ops import kernels
from deepspeed_tpu_torch.ops import quant_matmul as tq

BITS = [8, 4, "fp8"]
TOL = 1e-5
SMS = 132


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _weight(K, N, seed=0, n=None):
    """Weights whose quantization is not trivial: the scale differs by
    group and by column (and by expert)."""
    rng = np.random.default_rng(seed)
    lead = () if n is None else (n,)
    w = rng.standard_normal(lead + (K, N)).astype(np.float32)
    w *= np.exp(rng.uniform(-2, 2, lead + (K, 1))).astype(np.float32)
    w *= np.exp(rng.uniform(-1, 1, lead + (1, N))).astype(np.float32)
    return w


def _port(jqw):
    return params_from_jax({"w": jqw}, device="cpu")["w"]


def _judged(got, ref):
    ref = np.asarray(ref, np.float32)
    return np.abs(np.asarray(got, np.float32) - ref).max() / np.abs(ref).max()


# ---------------------------------------------------------------------------
# routes and plans
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,route", [(torch.bfloat16, "wgmma"),
                                         (torch.float32, "fma")])
@pytest.mark.parametrize("bits", BITS)
def test_route_follows_dtype_for_every_code_format(dtype, bits, route):
    assert tq.kernel_route(dtype, bits) == route


def test_route_refuses_other_dtypes_and_bits():
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tq.kernel_route(torch.float16, 8)
    with pytest.raises(ValueError, match="bits"):
        tq.kernel_route(torch.bfloat16, 2)


@pytest.mark.parametrize("M,bn", [(1, 8), (8, 8), (9, 16), (16, 16),
                                  (17, 32), (40, 64), (64, 64), (65, 128),
                                  (256, 256), (300, 256), (2048, 256)])
def test_token_columns_hold_m(M, bn):
    assert tq.tc_tokens(M) == bn


@pytest.mark.parametrize("M,K,Np,want", [
    (8, 4096, 11008, (8, 3)),       # llama2-7b w_gate at decode: 86 blocks
    (8, 4096, 4096, (8, 8)),        # wq: 32 blocks
    (8, 11008, 4096, (8, 8)),       # w_down
    (8, 4096, 32000, (8, 1)),       # unembed: 250 blocks fill the card
    (8, 2048, 151936, (8, 1)),      # qwen2-moe unembed
    (16, 2048, 2048, (16, 8)),      # qwen2-moe wq: 16 blocks, 32 stages
    (40, 4096, 4096, (64, 8)),
    (256, 4096, 11008, (256, 1)),   # prefill: 86 blocks, one an SM
    (256, 11008, 4096, (256, 4)),   # prefill w_down: 32 blocks
    (300, 4096, 4096, (256, 1)),    # two windows: no split
    (8, 256, 128, (8, 1)),          # 4 stages: too few to split
    (8, 768, 128, (8, 3))])         # 12 stages, 4 a split
def test_decode_split(M, K, Np, want):
    """K splits only when one window holds the rows and the column blocks
    leave SMs empty; every split keeps at least 4 of the 64-k stages, none
    is empty, and the blocks fit the card (2 an SM up to BN 64, else 1)."""
    bn, splits = tq.tc_split(M, K, Np, SMS)
    assert (bn, splits) == want
    nk = -(-K // 64)
    ks = -(-nk // splits)
    assert (splits - 1) * ks < nk <= splits * ks
    if splits > 1:
        assert M <= bn and ks >= tq.TC_MIN_SPLIT_STAGES
        assert splits * (Np // 128) <= tq.tc_blocks_per_sm(bn) * SMS


@pytest.mark.parametrize("T,k,n,bm,want", [
    (8, 4, 60, 32, 1),       # qwen2-moe decode: about one row an expert
    (2048, 4, 60, 32, 8),    # qwen2-moe prefill chunk: ~137 rows
    (512, 2, 8, 32, 8),      # Mixtral prefill: 128 rows an expert
    (8, 2, 8, 32, 1),        # Mixtral decode
    (100, 4, 8, 32, 4),      # 50 rows an expert
    (60, 4, 8, 32, 2),       # 30 rows an expert
    (4096, 4, 60, 128, 8)])
def test_run_tiles_follow_rows_per_expert(T, k, n, bm, want):
    idx = torch.arange(T * k).reshape(T, k) % n
    Tp = tg.sort_tokens_by_expert(idx, n, bm).Tp
    assert tq.grouped_run_tiles(Tp, n, bm) == want


def _sorted(T, k, n, bm, seed, kind="spread"):
    rng = np.random.default_rng(seed)
    if kind == "skewed":
        eidx = np.tile(np.arange(k, dtype=np.int32), (T, 1))
    elif kind == "idle":
        eidx = np.argsort(rng.random((T, max(n // 4, k))),
                          axis=1)[:, :k].astype(np.int32)
    else:
        eidx = np.argsort(rng.random((T, n)), axis=1)[:, :k].astype(np.int32)
    return eidx, tg.sort_tokens_by_expert(torch.from_numpy(eidx), n, bm)


@pytest.mark.parametrize("T,k,n,bm,kind", [
    (8, 4, 60, 32, "spread"), (300, 4, 12, 32, "spread"),
    (300, 2, 6, 32, "skewed"), (200, 4, 16, 32, "idle"),
    (150, 2, 5, 64, "spread"), (90, 3, 4, 128, "skewed")])
@pytest.mark.parametrize("run_tiles", [1, 2, 4, 8])
def test_runs_cover_every_row_once(T, k, n, bm, kind, run_tiles):
    """Each row lies in one run of its tile's expert, or in a sub-tile its
    window writes as zeros; a run starts in its window and takes at most
    run_tiles consecutive sub-tiles of one expert that hold routed rows;
    loaded rows cover the routed ones; an expert's rows take as few runs
    as run_tiles allows."""
    _, srt = _sorted(T, k, n, bm, seed=T + run_tiles, kind=kind)
    te, tr = srt.tile_expert.tolist(), srt.tile_rows.tolist()
    plan = tq.grouped_runs(te, tr, srt.Tp, bm, n, run_tiles)
    assert len(plan) == -(-srt.Tp // 32 // run_tiles)
    seen = np.zeros(srt.Tp, int)
    runs_of = {}
    for w, (rows, runs) in enumerate(plan):
        base = w * run_tiles * 32
        assert len(rows) == 2 * run_tiles
        for i, v in enumerate(rows):
            u = w * run_tiles + i
            if u >= srt.Tp // 32:
                assert v == -1
                continue
            t = u * 32 // bm
            assert v == min(max(tr[t] - (u * 32 - t * bm), 0), 32)
            if v == 0 and i < run_tiles:
                seen[u * 32:u * 32 + 32] += 1
        for run in runs:
            assert run.u0 < run_tiles and run.row0 == base + 32 * run.u0
            assert run.ntok <= 32 * run_tiles
            assert run.ntok % 32 == 0 and run.vload % 8 == 0
            assert run.vload <= run.ntok
            subs = range(run.u0, run.u0 + run.ntok // 32)
            assert all(rows[i] > 0 for i in subs)
            assert {te[(w * run_tiles + i) * 32 // bm] for i in subs} == \
                {run.expert}
            last = (run.ntok // 32 - 1) * 32 + rows[subs[-1]]
            assert run.vload >= last
            seen[run.row0:run.row0 + run.ntok] += 1
            runs_of[run.expert] = runs_of.get(run.expert, 0) + 1
        # runs are maximal: neighbours differ in expert or hold no rows
        for a, b in zip(runs, runs[1:]):
            assert a.u0 + a.ntok // 32 <= b.u0
    assert (seen == 1).all()
    routed = tg.row_mask(srt.Tp, bm, srt.tile_rows).numpy()
    assert routed.sum() == T * k
    # the sort keeps each expert's rows in one segment of full sub-tiles
    for e, nruns in runs_of.items():
        subs = -(-int((torch.from_numpy(np.asarray(te)).repeat_interleave(
            bm) == e)[torch.from_numpy(routed)].sum()) // 32)
        assert nruns == -(-subs // run_tiles)


def test_runs_of_a_decode_step_are_one_sub_tile_each():
    """qwen2-moe decode (8 tokens x top-4 over 60 experts, the engine's
    32-row tiles): one window a sub-tile, one run per active expert, one
    8-row load each."""
    eidx, srt = _sorted(8, 4, 60, 32, seed=5)
    plan = tq.grouped_runs(srt.tile_expert.tolist(), srt.tile_rows.tolist(),
                           srt.Tp, 32, 60, 1)
    runs = [r for _, rs in plan for r in rs]
    assert len(runs) == len(set(eidx.reshape(-1).tolist()))
    assert all(r.ntok == 32 and r.vload == 8 for r in runs)


# ---------------------------------------------------------------------------
# the plain versions composed as the kernel composes them, against Pallas
# ---------------------------------------------------------------------------

def _k2_composed(x, qw, bn, splits, layer_index=None):
    """K2's plain version window by window (BN rows) and split by split
    (64-k stages), the fp32 partials summed in split order."""
    data, scale = tq._layer(qw, layer_index)
    K, N = qw.shape
    w = tq._dequantize_slabs(data[None], scale[None], qw.bits, K,
                             qw.group_size)[0][:, :N].to(x.dtype).float()
    nk = -(-K // 64)
    ks = -(-nk // splits)
    out = torch.zeros(x.shape[0], N)
    for r0 in range(0, x.shape[0], bn):
        xs = x[r0:r0 + bn].float()
        acc = torch.zeros(xs.shape[0], N)
        for s in range(splits):
            k0, k1 = s * ks * 64, min(K, (s + 1) * ks * 64)
            acc = acc + xs[:, k0:k1] @ w[k0:k1]
        out[r0:r0 + bn] = acc
    return out.to(x.dtype)


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("M,K,N", [(8, 768, 200), (16, 1024, 256),
                                   (40, 512, 384), (300, 256, 130)])
def test_k2_windows_and_splits_compose_the_pallas_product(bits, M, K, N):
    w = _weight(K, N, seed=M)
    x = np.random.default_rng(M + 1).standard_normal((M, K)).astype(
        np.float32)
    jqw = jq.quantize_weight(jnp.asarray(w), bits=bits)
    ref = np.asarray(jq.quant_matmul(jnp.asarray(x), jqw, interpret=True))
    qw = _port(jqw)
    bn, splits = tq.tc_split(M, K, qw.data.shape[-1], sms=2)
    got = _k2_composed(torch.from_numpy(x), qw, bn, splits)
    assert got.shape == (M, N)
    assert _judged(got, ref) <= TOL


def test_k2_composition_splits_a_decode_call():
    """The composed cases above split K where a card of 2 SMs leaves room
    (4 slots for 2 column blocks of 768 k: 2 splits)."""
    assert tq.tc_split(8, 768, 256, sms=2) == (8, 2)
    assert tq.tc_split(8, 1024, 128, sms=4) == (8, 4)


def _k3_composed(x, qw, tile_expert, tile_rows, block_m, run_tiles,
                 layer_index=None):
    """K3's plain version run by run: each run's rows times its expert's
    weight, dequantized once per run; rows past tile_rows and sub-tiles
    without routed rows are zeros (a select: NaN there never shows)."""
    data, scale = tq._grouped_layer(qw, layer_index)
    K, N = qw.shape[1], qw.shape[2]
    Tp = x.shape[0]
    out = torch.full((Tp, N), float("nan"))
    plan = tq.grouped_runs(tile_expert.tolist(), tile_rows.tolist(), Tp,
                           block_m, qw.shape[0], run_tiles)
    for w, (rows, runs) in enumerate(plan):
        for i, v in enumerate(rows[:run_tiles]):
            if v == 0:
                u = w * run_tiles + i
                out[u * 32:u * 32 + 32] = 0
        for run in runs:
            we = tq._dequantize_slabs(data[run.expert][None],
                                      scale[run.expert][None], qw.bits, K,
                                      qw.group_size)[0][:, :N]
            we = we.to(x.dtype).float()
            y = x[run.row0:run.row0 + run.ntok].float() @ we
            j = torch.arange(run.ntok)
            sub = torch.tensor(rows)[run.u0 + j // 32]
            ok = (j % 32 < sub)[:, None]
            out[run.row0:run.row0 + run.ntok] = torch.where(
                ok, y, torch.zeros_like(y))
    return out.to(x.dtype)


def _k3_case(n, K, N, T, k, bm, bits, seed, kind="spread"):
    w = _weight(K, N, seed=seed, n=n)
    eidx, srt = _sorted(T, k, n, bm, seed=seed + 1, kind=kind)
    jsrt = jg.sort_tokens_by_expert(jnp.asarray(eidx), n, bm)
    x = np.random.default_rng(seed + 2).standard_normal((T, K)).astype(
        np.float32)
    buf = np.zeros((srt.Tp, K), np.float32)
    buf[np.asarray(jsrt.dst)] = np.repeat(x, k, axis=0)
    jqw = jq.quantize_grouped(jnp.asarray(w), bits=bits)
    ref = np.asarray(jq.quant_grouped_matmul(
        jnp.asarray(buf), jqw, jnp.asarray(np.array(jsrt.tile_expert)),
        block_m=bm))
    return buf, srt, _port(jqw), ref


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("n,K,N,T,k,bm,kind", [
    (12, 256, 200, 40, 2, 32, "spread"),
    (4, 384, 128, 150, 2, 32, "skewed"),
    (16, 128, 256, 60, 2, 32, "idle"),
    (5, 256, 130, 70, 2, 64, "spread")])
@pytest.mark.parametrize("run_tiles", [1, 8])
def test_k3_runs_compose_the_pallas_product(bits, n, K, N, T, k, bm, kind,
                                            run_tiles):
    """Run by run, with NaN in every padding row of x, the product is the
    Pallas kernel's on the zero-padded buffer: padding rows give zeros."""
    buf, srt, qw, ref = _k3_case(n, K, N, T, k, bm, bits, seed=T, kind=kind)
    pad = ~tg.row_mask(srt.Tp, bm, srt.tile_rows).numpy()
    nan_buf = buf.copy()
    nan_buf[pad] = np.nan
    got = _k3_composed(torch.from_numpy(nan_buf), qw, srt.tile_expert,
                       srt.tile_rows, bm, run_tiles)
    assert torch.isfinite(got).all()
    assert (got[torch.from_numpy(pad)] == 0).all()
    assert _judged(got, ref) <= TOL


@pytest.mark.parametrize("bits", [8, 4])
def test_k3_stacked_runs_select_the_layer(bits):
    n, K, N, L, li, bm = 3, 256, 128, 3, 2, 32
    per = [jq.quantize_grouped(jnp.asarray(_weight(K, N, seed=10 + i, n=n)),
                               bits=bits) for i in range(L)]
    jst = jq.QuantGrouped(jnp.stack([q.data for q in per]),
                          jnp.stack([q.scale for q in per]), per[0].bits,
                          per[0].group_size, per[0].shape, per[0].dtype)
    eidx, srt = _sorted(13, 2, n, bm, seed=3)
    jsrt = jg.sort_tokens_by_expert(jnp.asarray(eidx), n, bm)
    buf = np.zeros((srt.Tp, K), np.float32)
    buf[np.asarray(jsrt.dst)] = np.repeat(
        np.random.default_rng(4).standard_normal((13, K)).astype(
            np.float32), 2, axis=0)
    ref = jq.quant_grouped_matmul(jnp.asarray(buf), jst,
                                  jnp.asarray(np.array(jsrt.tile_expert)),
                                  layer_index=jnp.int32(li), block_m=bm)
    got = _k3_composed(torch.from_numpy(buf), _port(jst), srt.tile_expert,
                       srt.tile_rows, bm, 2, layer_index=li)
    assert _judged(got, ref) <= TOL


# ---------------------------------------------------------------------------
# launches through a recorder
# ---------------------------------------------------------------------------

class _Recorder:
    """Stands in for the kernel library: records each entry's name and its
    arguments, and returns ``err``."""

    def __init__(self, err=0):
        self.calls, self.args, self.err = [], [], err

    def ds_quant_error_name(self, code):
        return b"cudaErrorInvalidValue" if code == 1 else b"other"

    def __getattr__(self, name):
        if not name.startswith("ds_"):
            raise AttributeError(name)

        def entry(*args):
            self.calls.append(name)
            self.args.append(args)
            return self.err
        return entry


@pytest.fixture
def recorder(monkeypatch):
    rec = _Recorder()
    monkeypatch.setattr(kernels, "load", lambda name: rec)
    monkeypatch.setattr(tq, "_stream", lambda dev: 0)
    monkeypatch.setattr(tq, "_sm_count", lambda index: SMS)
    monkeypatch.setattr(tq, "_tc_scratch", lambda index: (
        torch.zeros(16), torch.zeros(4, dtype=torch.int32)))
    tq.counts.reset()
    tq.grouped_counts.reset()
    return rec


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("M,K,N", [(8, 4096, 11008), (256, 512, 200),
                                   (1, 768, 128)])
def test_k2_launch_names_the_wgmma_entry_and_its_geometry(recorder, bits, M,
                                                          K, N):
    qw = tq.quantize_weight(torch.zeros(K, N), bits=bits)
    x = torch.zeros(M, K, dtype=torch.bfloat16)
    out = tq._launch_kernel(x, qw, None, None)
    assert out.shape == (M, N) and out.dtype == torch.bfloat16
    Np = qw.data.shape[-1]
    bn, splits = tq.tc_split(M, K, Np, SMS)
    assert recorder.calls == ["ds_quant_matmul_tc"]
    args = recorder.args[0]
    # M, K, Np, G, fmt, layer, codes / scale strides, bn, splits
    assert args[6:-1] == (M, K, Np, qw.group_size, tq._FMT[bits], 0, 0, 0,
                          bn, splits)
    assert (args[4] != 0) == (args[5] != 0) == (splits > 1)
    assert (tq.counts.kernel, tq.counts.kernel_tc, tq.counts.plain) == \
        (1, 1, 0)


def test_k2_stacked_launch_names_its_layer(recorder):
    L, K, N = 3, 256, 128
    qs = [tq.quantize_weight(torch.zeros(K, N), bits=4) for _ in range(L)]
    st = tq.QuantLinear(torch.stack([q.data for q in qs]),
                        torch.stack([q.scale for q in qs]), 4,
                        qs[0].group_size, (K, N), torch.float32)
    tq._launch_kernel(torch.zeros(8, K, dtype=torch.bfloat16), st, 2, None)
    args = recorder.args[0]
    assert args[11:14] == (2, K // 2 * N, K // 128 * N)
    with pytest.raises(ValueError, match="outside"):
        tq._launch_kernel(torch.zeros(8, K, dtype=torch.bfloat16), st, 3,
                          None)
    with pytest.raises(ValueError, match="disagree"):
        tq._launch_kernel(torch.zeros(8, K, dtype=torch.bfloat16), st, None,
                          None)


def test_fp32_keeps_the_fma_entry(recorder):
    qw = tq.quantize_weight(torch.zeros(1024, 256), bits=8)
    tq._launch_kernel(torch.zeros(8, 1024), qw, None, None)
    assert recorder.calls == ["ds_quant_matmul"]
    mr, kb, splits = tq.decode_form_split(8, 1024, 256, SMS)
    # M, K, Np, G, fmt, layer, strides, decode, MR, KB, splits
    assert recorder.args[0][5:-1] == (8, 1024, 256, 512, 0, 0, 0, 0, 1,
                                      mr, kb, splits)
    assert (tq.counts.kernel, tq.counts.kernel_tc) == (1, 0)


@pytest.mark.parametrize("dtype,entry", [
    (torch.bfloat16, "ds_quant_grouped_matmul_tc"),
    (torch.float32, "ds_quant_grouped_matmul")])
@pytest.mark.parametrize("T,k,n", [(8, 4, 60), (2048, 4, 60)])
def test_k3_launch_names_its_entry_and_run_tiles(recorder, dtype, entry, T,
                                                 k, n):
    K, N, bm = 512, 192, 32
    qw = tq.quantize_grouped(torch.zeros(n, K, N), bits=8)
    srt = tg.sort_tokens_by_expert(
        torch.arange(T * k).reshape(T, k) % n, n, bm)
    x = torch.zeros(srt.Tp, K, dtype=dtype)
    out = tq._launch_grouped_kernel(x, qw, srt.tile_expert, None, bm,
                                    srt.tile_rows)
    assert out.shape == (srt.Tp, N)
    assert recorder.calls == [entry]
    args = recorder.args[0]
    head = (srt.Tp, K, 256, 512, n, bm, 0)
    if dtype == torch.bfloat16:
        runs = tq.grouped_run_tiles(srt.Tp, n, bm)
        assert runs == (1 if T == 8 else 8)
        assert args[6:-1] == head + (0, 0, 0, runs)
    else:
        assert args[6:-1] == head + (0, 0, 0)
    tc = int(dtype == torch.bfloat16)
    assert (tq.grouped_counts.kernel, tq.grouped_counts.kernel_tc) == (1, tc)


@pytest.mark.parametrize("err,match", [
    (1, r"CUDA error 1 \(cudaErrorInvalidValue\)"),
    (1001, "tensor map CUresult 1")])
def test_a_refused_launch_raises_and_is_not_counted(recorder, err, match):
    recorder.err = err
    qw = tq.quantize_weight(torch.zeros(256, 128), bits=8)
    with pytest.raises(RuntimeError, match=match):
        tq._launch_kernel(torch.zeros(8, 256, dtype=torch.bfloat16), qw,
                          None, None)
    qg = tq.quantize_grouped(torch.zeros(2, 256, 128), bits=8)
    te = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(RuntimeError, match=match):
        tq._launch_grouped_kernel(torch.zeros(64, 256, dtype=torch.bfloat16),
                                  qg, te, None, 32, None)
    assert tq.counts.kernel == tq.counts.kernel_tc == 0
    assert tq.grouped_counts.kernel == tq.grouped_counts.kernel_tc == 0


def test_bad_operands_are_refused(recorder):
    qw = tq.quantize_weight(torch.zeros(100, 128), bits=8)     # G 4
    with pytest.raises(ValueError, match="multiple of 8"):
        tq._launch_kernel(torch.zeros(8, 100, dtype=torch.bfloat16), qw,
                          None, None)
    qw = tq.quantize_weight(torch.zeros(256, 128), bits=8)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tq._launch_kernel(torch.zeros(8, 256, dtype=torch.float16), qw,
                          None, None)
    with pytest.raises(ValueError, match="contiguous"):
        tq._launch_kernel(torch.zeros(256, 8, dtype=torch.bfloat16).t(), qw,
                          None, None)
    bad = qw._replace(scale=qw.scale[:, :64].contiguous())
    with pytest.raises(ValueError, match="do not fit"):
        tq._launch_kernel(torch.zeros(8, 256, dtype=torch.bfloat16), bad,
                          None, None)
    bad = qw._replace(data=qw.data.view(torch.uint8))
    with pytest.raises(ValueError, match="do not fit bits"):
        tq._launch_kernel(torch.zeros(8, 256, dtype=torch.bfloat16), bad,
                          None, None)
    qg = tq.quantize_grouped(torch.zeros(2, 256, 128), bits=4)
    with pytest.raises(ValueError, match="multiple of 32"):
        tq._launch_grouped_kernel(torch.zeros(32, 256, dtype=torch.bfloat16),
                                  qg, torch.zeros(2, dtype=torch.int32),
                                  None, 16, None)
    assert recorder.calls == []


def test_a_weight_is_checked_once(recorder, monkeypatch):
    """The wrapper's per-weight checks run on the first launch; later
    launches on the same codes reuse them (K2's host cost at decode)."""
    qw = tq.quantize_weight(torch.zeros(256, 128), bits=8)
    checks = []
    real = tq._check_weight
    monkeypatch.setattr(tq, "_check_weight",
                        lambda *a: checks.append(1) or real(*a))
    x = torch.zeros(8, 256, dtype=torch.bfloat16)
    for _ in range(3):
        tq._launch_kernel(x, qw, None, None)
    assert len(checks) == 1 and len(recorder.calls) == 3
    # new scales are checked again
    tq._launch_kernel(x, qw._replace(scale=qw.scale.clone()), None, None)
    assert len(checks) == 2
