"""The port on the card: the paged-attention CUDA kernel (default,
e4m3-pool, sliding-window, rolling-ring and tree-verify forms), the
quantized-weight kernels (K2 and K3: bf16 on the wgmma route, its
widening bit for bit on one-hot rows, NaN padding rows never reaching a
result), the grouped MoE kernels (K5's forward, dx and dw on each route:
wgmma, WMMA, FMA), the flash-attention kernel (K4,
forward and backward; its bf16 kernels also at the tensor-core tiles'
edges, and their backward bit for bit from call to call), the block-sparse
flash kernels (K6: forward, dq, dk/dv, on the wgmma route K4's bits on a
dense layout), TMA launches from a fresh thread, and the per-layer-slice paged
attention (K7: linear, window and ring tables) against their plain
versions, the CUDA serving engine against the CPU engine, page imports,
the KV tier and the live weight swap into engines whose decode graphs are
captured, training
steps on the card through K4 and through K5's forward and backward,
ZeRO-3 over NCCL (bit for bit stage 0, a checkpoint round trip, a backward
from a fresh thread), and sequence parallelism on two gloo ranks sharing
the card (Ulysses against one rank's K4, seq-2 training at ZeRO 0 and 3
against one rank). These
need an sm_90 GPU and nvcc, so they skip elsewhere; on a machine with the
card run

    python -m pytest tests/test_torch_cuda.py -m cuda
"""
import pytest
import torch

from deepspeed_tpu_torch.ops import grouped_matmul as gm
from deepspeed_tpu_torch.ops import paged_attention as pa
from deepspeed_tpu_torch.ops import quant_matmul as qm

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    from deepspeed_tpu_torch.accelerator import is_sm90

    if not torch.cuda.is_available() or not is_sm90():
        pytest.skip("needs an sm_90 CUDA device (the kernels are built for "
                    "sm_90a)")
    return torch.device("cuda")


def _case(dev, dtype, *, H, KV, D, T, Ts, ctx, bs=16, nb=64, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    S = len(ctx)
    rnd = lambda *s: torch.randn(s, generator=g, device=dev).to(dtype)
    max_pages = max(-(-(max(c, 0) + Ts) // bs) for c in ctx) + 1
    tables = torch.zeros(S, max_pages, dtype=torch.int32)
    perm = torch.randperm(nb - 1, generator=torch.Generator().manual_seed(
        seed)) + 1
    lens, starts, used = [], [], 0
    for s, c in enumerate(ctx):
        if c < 0:
            lens.append(0), starts.append(0)
            continue
        n = -(-(c + Ts) // bs)
        tables[s, :n] = perm[used:used + n].to(torch.int32)
        used += n
        lens.append(c + T), starts.append(c)
    i32 = lambda v: torch.tensor(v, dtype=torch.int32, device=dev)
    # q at 3x the keys' spread: a peaked softmax, so a wrong score shows
    return [rnd(S, T, H, D) * 3, rnd(2, 2, KV, nb, bs, D), rnd(S, KV, Ts, D),
            rnd(S, KV, Ts, D), tables.to(dev), i32(lens), i32(starts),
            i32(starts)]


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("D", [64, 128, 256])
@pytest.mark.parametrize("G", [1, 4])
@pytest.mark.parametrize("T,Ts", [(1, 8), (40, 48)])
def test_kernel_matches_plain_version(dev, dtype, tol, D, G, T, Ts):
    args = _case(dev, dtype, H=2 * G, KV=2, D=D, T=T, Ts=Ts,
                 ctx=[0, 37, 100, -1])
    before = pa.counts.kernel
    got = pa.paged_ragged_attention(*args, block_size=16, layer_index=1)
    torch.cuda.synchronize()
    assert pa.counts.kernel == before + 1
    ref = pa.paged_ragged_attention_reference(*args, block_size=16,
                                              layer_index=1)
    assert (got[3] == 0).all()                       # the empty slot
    err = (got.float() - ref.float()).abs().max().item()
    if dtype == torch.bfloat16:        # p and the output round to bf16
        err /= ref.float().abs().max().item()
    assert err <= tol


def _form_case(dev, dtype, form, *, G, D, bs=16, nb=96, seed=0):
    """K1 inputs and options for one form: "window" (a 64-key window over
    up to 300 pool tokens, decode and a 40-row chunk), "ring" (a 6-page
    ring after several wraps, a 24-key window), "tree" (two slots of a
    branchy 6-node tree, one empty slot)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    rnd = lambda *sh: torch.randn(sh, generator=g, device=dev).to(dtype)
    i32 = lambda v: torch.tensor(v, dtype=torch.int32, device=dev)
    KV = 2
    H = KV * G
    if form == "window":
        T, Ts = 40, 48
        args = _case(dev, dtype, H=H, KV=KV, D=D, T=T, Ts=Ts,
                     ctx=[0, 37, 300, -1], bs=bs, nb=nb, seed=seed)
        return args, dict(window=64)
    if form == "ring":
        T, Ts, nwin = 8, 8, 6
        S = 3
        tables = torch.stack([torch.randperm(nb - 1, generator=torch.Generator(
        ).manual_seed(seed + s))[:nwin] + 1 for s in range(S)])
        sst = [200, 333, 91]
        lens = [c + n for c, n in zip(sst, (8, 5, 1))]
        return [rnd(S, T, H, D) * 3, rnd(2, 2, KV, nb, bs, D),
                rnd(S, KV, Ts, D), rnd(S, KV, Ts, D),
                tables.to(dev, torch.int32), i32(lens), i32(sst),
                i32(sst)], dict(window=24, ring_tokens=nwin * bs)
    T, Ts = 6, 8
    args = _case(dev, dtype, H=H, KV=KV, D=D, T=T, Ts=Ts, ctx=[40, 113, -1],
                 bs=bs, nb=nb, seed=seed)
    parents, depth = [-1, 0, 0, 1, 2, 3], [0, 1, 1, 2, 2, 3]
    pos = torch.zeros(3, T, dtype=torch.int32)
    mask = torch.zeros(3, T, T, dtype=torch.uint8)
    lens = torch.zeros(3, dtype=torch.int32)
    for s, root in enumerate((40, 113)):
        pos[s] = torch.tensor([root + d for d in depth])
        for i in range(T):
            j = i
            while j != -1:
                mask[s, i, j] = 1
                j = parents[j]
        lens[s] = root + 1 + max(depth)
    mask[2] = torch.eye(T, dtype=torch.uint8)
    args[5], args[6] = lens.to(dev), pos[:, 0].contiguous().to(dev)
    return args, dict(tree_positions=pos.to(dev), tree_mask=mask.to(dev))


@pytest.mark.parametrize("pool", ["bf16", "fp32", "e4m3"])
@pytest.mark.parametrize("form", ["window", "ring", "tree"])
@pytest.mark.parametrize("G", [1, 4])
def test_window_ring_and_tree_forms_match_plain_version(dev, pool, form, G):
    """K1's sliding-window, rolling-ring and tree-verify forms against the
    plain version, over a pool of q's dtype (fp32: 1e-4 absolute; bf16: 1e-2
    of max |plain|) or of e4m3 codes (max 1e-2 and mean 1e-4 of |plain|,
    p rounded against the kernel's walk: 64-key tiles and, for the split
    kernel, its splits); each form is counted."""
    dtype = torch.float32 if pool == "fp32" else torch.bfloat16
    args, kw = _form_case(dev, dtype, form, G=G, D=128)
    if pool == "e4m3":
        args[1] = qm.to_e4m3(args[1])
    before = dict(vars(pa.counts))
    got = pa.paged_ragged_attention(*args, block_size=16, layer_index=1,
                                    page_group=2, **kw)
    torch.cuda.synchronize()
    after = vars(pa.counts)
    total = "kernel_e4m3" if pool == "e4m3" else "kernel"
    assert after[total] == before[total] + 1
    assert after[f"kernel_{form}"] == before[f"kernel_{form}"] + 1
    assert after["plain"] == before["plain"]
    _, split_cols = pa.kernel_plan(args[0], 2, args[4].shape[1], 16)
    ref = pa.paged_ragged_attention_reference(
        *args, block_size=16, layer_index=1,
        p_round_blocks=(pa.KERNEL_KEY_TILE, pa.KERNEL_KEY_TILE),
        p_round_splits=split_cols or None, **kw)
    live = args[5] > 0
    assert (got[~live] == 0).all()
    d = (got[live].float() - ref[live].float()).abs()
    scale = ref[live].float().abs()
    if pool == "fp32":
        assert d.max().item() <= 1e-4
    elif pool == "bf16":
        assert d.max().item() / scale.max().item() <= 1e-2
    else:
        assert d.max().item() / scale.max().item() <= 1e-2
        assert (d.mean() / scale.mean()).item() <= 1e-4


def test_cuda_engine_matches_cpu_engine(dev):
    from deepspeed_tpu_torch.inference import InferenceEngineV2
    from deepspeed_tpu_torch.inference.weights import module_param_tree
    from deepspeed_tpu_torch.models import build_model

    torch.backends.cuda.matmul.allow_tf32 = False
    model = build_model("tiny-llama", hidden_size=256, device="cpu",
                        dtype=torch.float32)
    cfg = dict(block_size=8, num_blocks=96, max_seqs=4, chunk=16,
               max_seq_len=128, dtype=torch.float32)
    prompts = [list(range(i, i + n)) for i, n in ((0, 37), (50, 5), (9, 21))]
    cpu = InferenceEngineV2(model, config=dict(cfg, device="cpu"))
    tree = module_param_tree(model, device=dev)
    gpu = InferenceEngineV2(model, params=tree, config=dict(cfg, device=dev))
    assert gpu._attn_decode_sel.path == "cuda"
    assert gpu.generate(prompts, 8) == cpu.generate(prompts, 8)


@pytest.mark.parametrize("dtype,tol,tol_mean", [
    (torch.float32, 1e-2, 1e-5), (torch.bfloat16, 1e-2, 1e-4)])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("T,Ts", [(1, 8), (40, 48)])
def test_e4m3_pool_kernel_matches_plain_version(dev, dtype, tol, tol_mean,
                                                D, T, Ts):
    """K1's e4m3-pool form against the plain version rounding p against the
    kernel's walk (64-key tiles; the split kernel's splits); judged as
    chip_smoke.py judges it (max over max
    |plain|, mean over mean |plain|: a p within fp32 noise of an e4m3
    rounding boundary may round one step apart)."""
    args = _case(dev, dtype, H=8, KV=2, D=D, T=T, Ts=Ts,
                 ctx=[0, 37, 300, -1])
    args[1] = qm.to_e4m3(args[1])
    before = (pa.counts.kernel, pa.counts.kernel_e4m3)
    got = pa.paged_ragged_attention(*args, block_size=16, layer_index=1)
    torch.cuda.synchronize()
    assert (pa.counts.kernel, pa.counts.kernel_e4m3) == \
        (before[0], before[1] + 1)
    _, split_cols = pa.kernel_plan(args[0], 2, args[4].shape[1], 16)
    ref = pa.paged_ragged_attention_reference(
        *args, block_size=16, layer_index=1,
        p_round_blocks=(pa.KERNEL_KEY_TILE, pa.KERNEL_KEY_TILE),
        p_round_splits=split_cols or None)
    assert (got[3] == 0).all()
    d = (got.float() - ref.float()).abs()
    assert d.max().item() / ref.float().abs().max().item() <= tol
    assert (d.mean() / ref.float().abs().mean()).item() <= tol_mean


def _qweight(dev, K, N, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    w = torch.randn(K, N, generator=g, device=dev)
    w *= torch.empty(K, 1, device=dev).uniform_(-2, 2, generator=g).exp_()
    w *= torch.empty(1, N, device=dev).uniform_(-1, 1, generator=g).exp_()
    return w


@pytest.mark.parametrize("bits", [8, 4, "fp8"])
@pytest.mark.parametrize("M", [1, 8, 16, 40, 256])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("K,N", [(1024, 640), (768, 200)])
def test_quant_matmul_kernel_matches_plain_version(dev, bits, M, dtype, tol,
                                                   K, N):
    """K2 in its decode form (M <= 16) and its tile form against the plain
    version: max |error| over max |plain| (fp32 sums in another order; bf16
    outputs may round one ulp apart); N = 200 is padded to 256."""
    torch.backends.cuda.matmul.allow_tf32 = False
    qw = qm.quantize_weight(_qweight(dev, K, N, seed=M), bits=bits)
    x = torch.randn(M, K, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(1)
                    ).to(dtype)
    before = qm.counts.kernel
    got = qm.quant_matmul(x, qw)
    torch.cuda.synchronize()
    assert qm.counts.kernel == before + 1
    ref = qm.quant_matmul_reference(x, qw)
    assert got.shape == ref.shape == (M, N) and got.dtype == dtype
    err = (got.float() - ref.float()).abs().max().item()
    assert err / ref.float().abs().max().item() <= tol
    # the forced tile form agrees as well
    tile = qm.quant_matmul(x, qw, small_m_xla=False)
    err = (tile.float() - ref.float()).abs().max().item()
    assert err / ref.float().abs().max().item() <= tol


@pytest.mark.parametrize("bits", [8, 4, "fp8"])
@pytest.mark.parametrize("M", [8, 64])
def test_quant_matmul_kernel_stacked_layer(dev, bits, M):
    layers = [qm.quantize_weight(_qweight(dev, 512, 384, seed=i), bits=bits)
              for i in range(3)]
    st = qm.QuantLinear(torch.stack([q.data for q in layers]),
                        torch.stack([q.scale for q in layers]), bits,
                        layers[0].group_size, layers[0].shape,
                        layers[0].dtype)
    x = torch.randn(M, 512, device=dev, dtype=torch.bfloat16)
    for li in range(3):
        got = qm.quant_matmul(x, st, layer_index=li)
        assert torch.equal(got, qm.quant_matmul(x, layers[li]))
        ref = qm.quant_matmul_reference(x, st, layer_index=li)
        err = (got.float() - ref.float()).abs().max().item()
        assert err / ref.float().abs().max().item() <= 1e-2


@pytest.mark.parametrize("bits", [8, 4, "fp8"])
@pytest.mark.parametrize("M", [1, 8, 16, 17, 256])
@pytest.mark.parametrize("K,N", [(1000, 200), (768, 640), (4096, 384)])
def test_quant_matmul_wgmma_route_matches_plain_version(dev, bits, M, K, N):
    """bf16 K2 on the wgmma route: every code format, token columns from 8
    to 256 (M 17 in a 32-column block), K off the 64-k stage (1000, group
    8: a stage touches nine scale rows) and N padded to 256, the K split
    at decode (4096 x 384: three column blocks); max |error| over max
    |plain| within K2_TOL, the same bits on a second launch."""
    qw = qm.quantize_weight(_qweight(dev, K, N, seed=M), bits=bits)
    x = torch.randn(M, K, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(2)
                    ).to(torch.bfloat16)
    before = (qm.counts.kernel, qm.counts.kernel_tc)
    got = qm.quant_matmul(x, qw)
    torch.cuda.synchronize()
    assert (qm.counts.kernel, qm.counts.kernel_tc) == (before[0] + 1,
                                                       before[1] + 1)
    ref = qm.quant_matmul_reference(x, qw)
    assert got.shape == ref.shape == (M, N) and got.dtype == torch.bfloat16
    assert _judged(got, ref) <= 1e-2
    again = qm.quant_matmul(x, qw)
    torch.cuda.synchronize()
    assert torch.equal(got, again)


@pytest.mark.parametrize("bits", [8, 4, "fp8"])
@pytest.mark.parametrize("M,K,N", [(8, 4096, 384), (16, 1000, 200),
                                   (256, 768, 640)])
def test_quant_matmul_one_hot_rows_are_the_dequantized_weight(dev, bits, M,
                                                              K, N):
    """One-hot rows of x pick rows of the weight: each output row is the
    dequantized weight's row bit for bit (the kernel widens every code to
    bf16(float(code) * scale) exactly, and the K split adds exact zeros)."""
    qw = qm.quantize_weight(_qweight(dev, K, N, seed=5).to(torch.bfloat16),
                            bits=bits)
    ks = torch.randperm(K, generator=torch.Generator(device=dev)
                        .manual_seed(M), device=dev)[:M]
    x = torch.zeros(M, K, device=dev, dtype=torch.bfloat16)
    x[torch.arange(M, device=dev), ks] = 1
    got = qm.quant_matmul(x, qw)
    assert torch.equal(got, qm.dequantize_weight(qw)[ks])


def _tile_rows_partial(srt, seed):
    """tile_rows cut short at random inside each tile that holds routed
    rows (the cut rows become padding)."""
    g = torch.Generator().manual_seed(seed)
    tr = srt.tile_rows.cpu()
    cut = (torch.rand(tr.shape, generator=g) * (tr + 1).float()).long()
    return torch.minimum(tr, cut.clamp(min=1)).to(torch.int32).to(
        srt.tile_rows.device)


@pytest.mark.parametrize("bits", [8, 4, "fp8"])
@pytest.mark.parametrize("T,k,n,K,N,bm,kind", [
    (8, 4, 60, 512, 192, 32, "spread"),       # decode: runs of one tile
    (300, 4, 12, 1024, 200, 32, "spread"),    # prefill: runs of 8 tiles
    (600, 2, 6, 256, 256, 32, "skewed"),      # an expert past 8 tiles
    (400, 4, 16, 384, 128, 32, "idle"),
    (200, 2, 6, 1000, 136, 64, "spread"),     # K off the stage, block_m 64
    (200, 2, 6, 256, 128, 32, "partial")])    # tile_rows cut inside tiles
def test_quant_grouped_wgmma_route_matches_plain_version(dev, bits, T, k, n,
                                                         K, N, bm, kind):
    """bf16 K3 on the wgmma route under skewed, idle-expert and partial-tile
    routings, with NaN in every padding row of x: within K2_TOL of the
    plain version on the zero-padded buffer, zeros (never NaN) in padding
    rows, the same bits on a second launch."""
    idle = kind == "idle"       # routed to a quarter of the experts
    buf, srt = _routed(dev, torch.bfloat16, T=T, k=k, n=n // 4 if idle
                       else n, K=K, bm=bm, seed=T + n,
                       kind="skewed" if kind == "skewed" else "spread")
    tile_rows = (_tile_rows_partial(srt, T) if kind == "partial"
                 else srt.tile_rows)
    w = torch.stack([_qweight(dev, K, N, seed=e) for e in range(n)])
    qw = qm.quantize_grouped(w, bits=bits)
    kw = dict(block_m=bm, tile_rows=tile_rows)
    pad = ~gm.row_mask(srt.Tp, bm, tile_rows)
    clean = buf.clone()
    clean[pad] = 0
    nan_buf = buf.clone()
    nan_buf[pad] = float("nan")
    before = (qm.grouped_counts.kernel, qm.grouped_counts.kernel_tc)
    got = qm.quant_grouped_matmul(nan_buf, qw, srt.tile_expert, **kw)
    torch.cuda.synchronize()
    assert (qm.grouped_counts.kernel, qm.grouped_counts.kernel_tc) == (
        before[0] + 1, before[1] + 1)
    ref = qm.quant_grouped_matmul_reference(clean, qw, srt.tile_expert, **kw)
    assert got.shape == ref.shape == (srt.Tp, N)
    assert torch.isfinite(got).all() and (got[pad] == 0).all()
    assert _judged(got, ref) <= 1e-2
    again = qm.quant_grouped_matmul(nan_buf, qw, srt.tile_expert, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, again)


def test_quant_wgmma_route_runs_from_a_fresh_thread(dev):
    """K2 and K3 on the wgmma route encode their weights' TMA maps on the
    first call: made from a fresh thread (no current context yet), they
    give the main thread's bits."""
    import threading

    qw = qm.quantize_weight(_qweight(dev, 1024, 384, seed=11), bits=4)
    x = torch.randn(8, 1024, device=dev).to(torch.bfloat16)
    buf, srt = _routed(dev, torch.bfloat16, T=40, k=2, n=6, K=512, bm=32,
                       seed=12)
    qg = qm.quantize_grouped(torch.stack(
        [_qweight(dev, 512, 256, seed=20 + e) for e in range(6)]), bits=8)

    def run():
        return (qm.quant_matmul(x, qw), qm.quant_grouped_matmul(
            buf, qg, srt.tile_expert, block_m=32, tile_rows=srt.tile_rows))

    got = {}

    def work():
        try:
            got["out"] = run()
            torch.cuda.synchronize()
        except Exception as err:          # raised again in the test thread
            got["err"] = err

    t = threading.Thread(target=work)
    t.start()
    t.join(timeout=120)
    assert not t.is_alive()
    if "err" in got:
        raise got["err"]
    main = run()
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got["out"], main))


def test_quant_matmul_never_dequantizes_on_the_card(dev, monkeypatch):
    """On a CUDA tensor the wrapper launches the kernel; the plain version
    (a torch dequantize and matmul) is never called."""
    qw = qm.quantize_weight(_qweight(dev, 256, 128, seed=3), bits=8)
    monkeypatch.setattr(qm, "quant_matmul_reference", None)
    monkeypatch.setattr(qm, "_dequantize_slabs", None)
    y = qm.quant_matmul(torch.randn(4, 256, device=dev), qw)
    torch.cuda.synchronize()
    assert y.shape == (4, 128)


def test_cuda_quantized_engine_matches_cpu_engine(dev):
    from deepspeed_tpu_torch.inference import InferenceEngineV2
    from deepspeed_tpu_torch.inference.weights import module_param_tree
    from deepspeed_tpu_torch.models import build_model

    torch.backends.cuda.matmul.allow_tf32 = False
    model = build_model("tiny-llama", hidden_size=256, device="cpu",
                        dtype=torch.float32)
    cfg = dict(block_size=8, num_blocks=96, max_seqs=4, chunk=16,
               max_seq_len=128, dtype=torch.float32, quant_bits=8)
    prompts = [list(range(i, i + n)) for i, n in ((0, 37), (50, 5), (9, 21))]
    cpu = InferenceEngineV2(model, config=dict(cfg, device="cpu"))
    tree = module_param_tree(model, device=dev)
    gpu = InferenceEngineV2(model, params=tree, config=dict(cfg, device=dev))
    k2 = qm.counts.kernel
    assert gpu.generate(prompts, 8) == cpu.generate(prompts, 8)
    assert qm.counts.kernel > k2


def _routed(dev, dtype, *, T, k, n, K, bm, seed, kind="spread"):
    """(expert-sorted buffer, its sort): T unit-normal tokens, k distinct
    experts each (``skewed``: every token on experts 0..k-1)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    if kind == "skewed":
        idx = torch.arange(k, device=dev).expand(T, k)
    else:
        idx = torch.rand(T, n, generator=g, device=dev).argsort(1)[:, :k]
    srt = gm.sort_tokens_by_expert(idx.to(torch.int32), n, bm)
    x = torch.randn(T, K, generator=g, device=dev).to(dtype)
    buf = x.new_zeros((srt.Tp, K)).index_copy_(
        0, srt.dst.long(), x.repeat_interleave(k, dim=0))
    return buf, srt


def _judged(got, ref):
    return ((got.float() - ref.float()).abs().max()
            / ref.float().abs().max()).item()


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("T,k,n,K,N,bm,kind", [
    (8, 4, 60, 256, 192, 128, "spread"),      # decode: mostly empty tiles
    (300, 4, 12, 512, 320, 128, "spread"),
    (300, 2, 6, 200, 136, 32, "skewed"),      # K and N off the tile
    (64, 2, 8, 128, 64, 64, "spread")])
def test_grouped_matmul_kernel_matches_plain_version(dev, dtype, tol, T, k,
                                                     n, K, N, bm, kind):
    """K5's forward against its plain version: max |error| over max
    |plain| (fp32 sums in another order; bf16 outputs may round one ulp
    apart); rows past each tile's routed count are exactly zero."""
    torch.backends.cuda.matmul.allow_tf32 = False
    buf, srt = _routed(dev, dtype, T=T, k=k, n=n, K=K, bm=bm, seed=T + n,
                       kind=kind)
    w = (torch.randn(n, K, N, device=dev) / K ** 0.5).to(dtype)
    before = gm.counts.kernel
    got = gm.grouped_matmul(buf, w, srt.tile_expert, bm, srt.tile_rows)
    torch.cuda.synchronize()
    assert gm.counts.kernel == before + 1
    ref = gm.grouped_matmul_reference(buf, w, srt.tile_expert, bm,
                                      srt.tile_rows)
    assert got.shape == ref.shape == (srt.Tp, N) and got.dtype == dtype
    assert _judged(got, ref) <= tol
    pad = ~gm.row_mask(srt.Tp, bm, srt.tile_rows)
    assert (got[pad] == 0).all()
    # without the counts every row is computed: the same result here
    full = gm.grouped_matmul(buf, w, srt.tile_expert, bm)
    assert _judged(full, ref) <= tol


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("T,k,n,K,N,bm,kind", [
    (300, 4, 12, 512, 320, 128, "spread"),
    (300, 2, 6, 200, 136, 32, "skewed"),      # K and N off the tile
    (40, 2, 16, 128, 64, 64, "spread"),       # experts with no tile
    (64, 1, 3, 96, 72, 96, "skewed")])        # block_m not a power of 2
def test_grouped_matmul_backward_kernels_match_plain_versions(
        dev, dtype, tol, T, k, n, K, N, bm, kind):
    """K5's dx and dw kernels against their plain versions, each counted
    once: max |error| over max |plain|; dx's padding rows and the dw of an
    expert with no tile are exactly zero; autograd through
    ``grouped_matmul`` launches both and gives the same gradients."""
    torch.backends.cuda.matmul.allow_tf32 = False
    buf, srt = _routed(dev, dtype, T=T, k=k, n=n, K=K, bm=bm, seed=T + K,
                       kind=kind)
    g = torch.Generator(device=dev).manual_seed(n)
    w = (torch.randn(n, K, N, generator=g, device=dev) / K ** 0.5).to(dtype)
    dy = torch.randn(srt.Tp, N, generator=g, device=dev).to(dtype)
    args = (srt.tile_expert, bm, srt.tile_rows)
    before = (gm.counts.kernel_dx, gm.counts.kernel_dw)
    dx = gm.grouped_matmul_dx(dy, w, *args)
    dw = gm.grouped_matmul_dw(buf, dy, srt.tile_expert, n, bm, srt.tile_rows)
    torch.cuda.synchronize()
    assert (gm.counts.kernel_dx, gm.counts.kernel_dw) == (before[0] + 1,
                                                          before[1] + 1)
    ref_dx = gm.grouped_matmul_dx_reference(dy, w, *args)
    ref_dw = gm.grouped_matmul_dw_reference(buf, dy, srt.tile_expert, n, bm,
                                            srt.tile_rows)
    assert dx.shape == (srt.Tp, K) and dw.shape == (n, K, N)
    assert dx.dtype == dw.dtype == dtype
    assert _judged(dx, ref_dx) <= tol and _judged(dw, ref_dw) <= tol
    assert (dx[~gm.row_mask(srt.Tp, bm, srt.tile_rows)] == 0).all()
    owned = set(srt.tile_expert[srt.tile_rows > 0].tolist())
    for e in set(range(n)) - owned:
        assert (dw[e] == 0).all()
    x = buf.clone().requires_grad_()
    wt = w.clone().requires_grad_()
    gm.grouped_matmul(x, wt, *args).backward(dy)
    assert torch.equal(x.grad, dx) and torch.equal(wt.grad, dw)


@pytest.mark.parametrize("bm", [128, 64])
@pytest.mark.parametrize("T,k,n,K,N,kind", [
    (8, 4, 60, 256, 192, "spread"),          # decode: mostly empty tiles
    (300, 2, 6, 200, 136, "spread"),         # K and N off the tile
    (300, 4, 12, 512, 320, "spread"),        # partial last tiles
    (1000, 2, 6, 256, 128, "skewed"),        # one expert owns many tiles
    (40, 2, 16, 128, 64, "spread"),          # experts with no tile
    (200, 2, 16, 192, 256, "last")])         # clipped tiles name a busy one
def test_grouped_wgmma_route_matches_plain_versions(dev, bm, T, k, n, K, N,
                                                    kind):
    """K5's wgmma route (bf16, block_m a multiple of 64): the forward, dx
    and dw kernels against their plain versions, each launch counted on
    the route; padding rows of x and dy filled with NaN change nothing (the
    plain versions see zeros there): every result finite, within 1e-2 of
    max |plain| (one bf16 rounding of an fp32 sum), dx's and the forward's
    padding rows exactly zero, an idle expert's dw zero; a second launch
    gives the same bits."""
    dtype = torch.bfloat16
    assert gm.gmm_route(dtype, bm) == "wgmma"
    if kind == "last":
        g = torch.Generator(device=dev).manual_seed(T)
        idx = (n - 1 - torch.arange(k, device=dev)).expand(T, k)
        srt = gm.sort_tokens_by_expert(idx.to(torch.int32), n, bm)
        x = torch.randn(T, K, generator=g, device=dev).to(dtype)
        buf = x.new_zeros((srt.Tp, K)).index_copy_(
            0, srt.dst.long(), x.repeat_interleave(k, dim=0))
    else:
        buf, srt = _routed(dev, dtype, T=T, k=k, n=n, K=K, bm=bm,
                           seed=T + K, kind=kind)
    g = torch.Generator(device=dev).manual_seed(n + K)
    w = (torch.randn(n, K, N, generator=g, device=dev) / K ** 0.5).to(dtype)
    pad = ~gm.row_mask(srt.Tp, bm, srt.tile_rows)
    dy = torch.randn(srt.Tp, N, generator=g, device=dev).to(dtype)
    dy[pad] = 0
    args = (srt.tile_expert, bm, srt.tile_rows)
    ref = gm.grouped_matmul_reference(buf, w, *args)
    ref_dx = gm.grouped_matmul_dx_reference(dy, w, *args)
    ref_dw = gm.grouped_matmul_dw_reference(buf, dy, srt.tile_expert, n, bm,
                                            srt.tile_rows)
    nan_x, nan_dy = buf.clone(), dy.clone()
    nan_x[pad] = float("nan")
    nan_dy[pad] = float("nan")

    def run():
        return (gm.grouped_matmul(nan_x, w, *args),
                gm.grouped_matmul_dx(nan_dy, w, *args),
                gm.grouped_matmul_dw(nan_x, nan_dy, srt.tile_expert, n, bm,
                                     srt.tile_rows))

    c = gm.counts
    before = (c.kernel_tc, c.kernel_dx_tc, c.kernel_dw_tc)
    got = run()
    torch.cuda.synchronize()
    assert (c.kernel_tc, c.kernel_dx_tc, c.kernel_dw_tc) == tuple(
        b + 1 for b in before)
    for out, want in zip(got, (ref, ref_dx, ref_dw)):
        assert out.shape == want.shape and out.dtype == dtype
        assert torch.isfinite(out).all()
        assert _judged(out, want) <= 1e-2
    assert (got[0][pad] == 0).all() and (got[1][pad] == 0).all()
    owned = set(srt.tile_expert[srt.tile_rows > 0].tolist())
    for e in set(range(n)) - owned:
        assert (got[2][e] == 0).all()
    again = run()
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_grouped_wgmma_route_runs_from_a_fresh_thread(dev):
    """The wgmma route encodes its TMA tensor maps through libcuda, which
    needs a context current in the calling thread. A thread whose
    first CUDA work is such a launch (autograd's device thread, when a
    backward starts with dx) gets the main thread's bits, and autograd
    through ``grouped_matmul`` launches on the wgmma route."""
    import threading

    bm, n = 128, 12
    buf, srt = _routed(dev, torch.bfloat16, T=300, k=4, n=n, K=256, bm=bm,
                       seed=7)
    g = torch.Generator(device=dev).manual_seed(3)
    w = (torch.randn(n, 256, 192, generator=g, device=dev) / 16).to(
        torch.bfloat16)
    dy = torch.randn(srt.Tp, 192, generator=g, device=dev).to(torch.bfloat16)
    args = (srt.tile_expert, bm, srt.tile_rows)

    def run():
        return (gm.grouped_matmul(buf, w, *args),
                gm.grouped_matmul_dx(dy, w, *args),
                gm.grouped_matmul_dw(buf, dy, srt.tile_expert, n, bm,
                                     srt.tile_rows))

    got = {}

    def work():
        try:
            got["out"] = run()
            torch.cuda.synchronize()
        except Exception as err:          # raised again in the test thread
            got["err"] = err

    t = threading.Thread(target=work)
    t.start()
    t.join(timeout=120)
    assert not t.is_alive()
    if "err" in got:
        raise got["err"]
    main = run()
    assert all(torch.equal(a, b) for a, b in zip(got["out"], main))
    before = (gm.counts.kernel_dx_tc, gm.counts.kernel_dw_tc)
    x = buf.clone().requires_grad_()
    wt = w.clone().requires_grad_()
    gm.grouped_matmul(x, wt, *args).backward(dy)
    assert (gm.counts.kernel_dx_tc, gm.counts.kernel_dw_tc) == (
        before[0] + 1, before[1] + 1)
    assert torch.equal(x.grad, main[1]) and torch.equal(wt.grad, main[2])


def test_grouped_kernels_refuse_what_they_do_not_take(dev):
    buf, srt = _routed(dev, torch.bfloat16, T=8, k=2, n=4, K=64, bm=16,
                       seed=1)
    w = torch.randn(4, 64, 64, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiple of 32"):
        gm.grouped_matmul(buf, w, srt.tile_expert, 16, srt.tile_rows)
    buf, srt = _routed(dev, torch.bfloat16, T=8, k=2, n=4, K=64, bm=32,
                       seed=1)
    with pytest.raises(ValueError, match="dtype"):
        gm.grouped_matmul(buf, w.float(), srt.tile_expert, 32)


@pytest.mark.parametrize("bits", [8, 4, "fp8"])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("T,k,n,K,N,kind", [
    (8, 4, 60, 512, 192, "spread"),           # decode: mostly empty tiles
    (200, 4, 12, 1024, 200, "spread"),        # N padded to 256
    (120, 2, 6, 384, 128, "skewed")])
def test_quant_grouped_matmul_kernel_matches_plain_version(dev, bits, dtype,
                                                           tol, T, k, n, K,
                                                           N, kind):
    """K3 against its plain version (the engine's 32-row tiles)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    buf, srt = _routed(dev, dtype, T=T, k=k, n=n, K=K, bm=32, seed=T + n,
                       kind=kind)
    w = torch.stack([_qweight(dev, K, N, seed=e) for e in range(n)])
    qw = qm.quantize_grouped(w, bits=bits)
    before = qm.grouped_counts.kernel
    kw = dict(block_m=32, tile_rows=srt.tile_rows)
    got = qm.quant_grouped_matmul(buf, qw, srt.tile_expert, **kw)
    torch.cuda.synchronize()
    assert qm.grouped_counts.kernel == before + 1
    ref = qm.quant_grouped_matmul_reference(buf, qw, srt.tile_expert, **kw)
    assert got.shape == ref.shape == (srt.Tp, N) and got.dtype == dtype
    assert _judged(got, ref) <= tol


@pytest.mark.parametrize("bits", [8, 4])
def test_quant_grouped_matmul_kernel_stacked_layer(dev, bits):
    n, K, N = 6, 256, 128
    layers = [qm.quantize_grouped(torch.stack(
        [_qweight(dev, K, N, seed=10 * i + e) for e in range(n)]), bits=bits)
        for i in range(3)]
    st = qm.QuantGrouped(torch.stack([q.data for q in layers]),
                         torch.stack([q.scale for q in layers]), bits,
                         layers[0].group_size, layers[0].shape,
                         layers[0].dtype)
    buf, srt = _routed(dev, torch.bfloat16, T=40, k=2, n=n, K=K, bm=32,
                       seed=2)
    kw = dict(block_m=32, tile_rows=srt.tile_rows)
    for li in range(3):
        got = qm.quant_grouped_matmul(buf, st, srt.tile_expert,
                                      layer_index=li, **kw)
        assert torch.equal(got, qm.quant_grouped_matmul(
            buf, layers[li], srt.tile_expert, **kw))


def test_grouped_products_never_run_plain_on_the_card(dev, monkeypatch):
    """On CUDA tensors both wrappers launch their kernels; the plain
    versions are never called."""
    monkeypatch.setattr(gm, "grouped_matmul_reference", None)
    monkeypatch.setattr(gm, "grouped_matmul_dx_reference", None)
    monkeypatch.setattr(gm, "grouped_matmul_dw_reference", None)
    monkeypatch.setattr(gm, "tiled_reference", None)
    monkeypatch.setattr(qm, "quant_grouped_matmul_reference", None)
    buf, srt = _routed(dev, torch.bfloat16, T=8, k=2, n=4, K=128, bm=32,
                       seed=3)
    w = torch.randn(4, 128, 64, device=dev, dtype=torch.bfloat16)
    x = buf.requires_grad_()
    out = gm.grouped_matmul(x, w.requires_grad_(), srt.tile_expert, 32)
    assert out.shape == (srt.Tp, 64)
    out.sum().backward()
    assert x.grad.shape == buf.shape and w.grad.shape == w.shape
    qw = qm.quantize_grouped(w.float(), bits=8)
    assert qm.quant_grouped_matmul(buf, qw, srt.tile_expert,
                                   block_m=32).shape == (srt.Tp, 64)
    torch.cuda.synchronize()


@pytest.mark.parametrize("over", [{"dropless": True}, {"quant_bits": 8}])
def test_cuda_moe_engine_matches_cpu_engine(dev, over):
    import dataclasses

    from deepspeed_tpu_torch.inference import InferenceEngineV2
    from deepspeed_tpu_torch.inference.weights import module_param_tree
    from deepspeed_tpu_torch.models import build_model, get_model_config

    torch.backends.cuda.matmul.allow_tf32 = False
    moe = dataclasses.replace(get_model_config("tiny-qwen2-moe").moe,
                              dropless=bool(over.get("dropless")))
    model = build_model("tiny-qwen2-moe", hidden_size=256, device="cpu",
                        dtype=torch.float32, moe=moe)
    cfg = dict(block_size=8, num_blocks=96, max_seqs=4, chunk=16,
               max_seq_len=128, dtype=torch.float32,
               quant_bits=over.get("quant_bits"))
    prompts = [list(range(i, i + n)) for i, n in ((0, 37), (50, 5), (9, 21))]
    cpu = InferenceEngineV2(model, config=dict(cfg, device="cpu"))
    tree = module_param_tree(model, device=dev)
    gpu = InferenceEngineV2(model, params=tree, config=dict(cfg, device=dev))
    k3, k5 = qm.grouped_counts.kernel, gm.counts.kernel
    assert gpu.generate(prompts, 8) == cpu.generate(prompts, 8)
    assert (qm.grouped_counts.kernel > k3) == ("quant_bits" in over)
    assert (gm.counts.kernel > k5) == ("dropless" in over)


# ---------------------------------------------------------------------------
# K4: flash attention, forward and backward
# ---------------------------------------------------------------------------

#: K4 against its plain version: fp32 output by max |error|, fp32 grads by
#: max |error| over max |plain| (sums over S keys in another order), bf16
#: everything by max |error| over max |plain| (outputs round to bf16)
K4_TOL = {torch.float32: (1e-4, 1e-3), torch.bfloat16: (2e-2, 2e-2)}


def _flash_inputs(dev, dtype, B, H, KV, S, D, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    rnd = lambda *s: torch.randn(s, generator=g, device=dev).to(dtype)
    return rnd(B, H, S, D), rnd(B, KV, S, D), rnd(B, KV, S, D), \
        rnd(B, H, S, D)


#: (dtype, B, S, causal): short and ragged sequences in both dtypes, then
#: bf16 at the tensor-core tiles' edges: the train shape (2048), a length
#: ragged against the 128-row tile (1000), 4096, and 8192 at B 1
K4_CARD_CASES = (
    [(dtype, 2, S, causal) for dtype in (torch.float32, torch.bfloat16)
     for S, causal in ((128, True), (200, True), (384, True), (200, False))]
    + [(torch.bfloat16, B, S, causal)
       for B, S in ((2, 2048), (2, 1000), (2, 4096), (1, 8192))
       for causal in (True, False)])


@pytest.mark.parametrize("dtype,B,S,causal", K4_CARD_CASES, ids=[
    f"{str(dt)[6:]}-B{B}-S{S}-{'causal' if c else 'full'}"
    for dt, B, S, c in K4_CARD_CASES])
@pytest.mark.parametrize("D", [64, 128, 256])
@pytest.mark.parametrize("G", [1, 4])
def test_flash_kernel_matches_plain_version(dev, dtype, B, S, causal, D, G):
    from deepspeed_tpu_torch.ops import flash_attention as fa

    q, k, v, do = _flash_inputs(dev, dtype, B, 2 * G, 2, S, D)
    scale = D ** -0.5
    fa.counts.reset()
    out, lse = fa.flash_fwd(q, k, v, causal, scale)
    dq, dk, dv = fa.flash_bwd(q, k, v, out, lse, do, causal, scale)
    torch.cuda.synchronize()
    assert (fa.counts.fwd, fa.counts.bwd, fa.counts.plain) == (1, 1, 0)
    ref_out, ref_lse = fa.flash_fwd_plain(q, k, v, causal, scale)
    refs = fa.flash_bwd_plain(q, k, v, ref_out, ref_lse, do, causal, scale)
    out_tol, grad_tol = K4_TOL[dtype]
    err = (out.float() - ref_out.float()).abs().max().item()
    if dtype == torch.bfloat16:
        err /= ref_out.float().abs().max().item()
    assert err <= out_tol, ("out", err)
    assert (lse - ref_lse).abs().max().item() <= 1e-3 * max(
        1.0, ref_lse.abs().max().item())
    for name, got, ref in zip(("dq", "dk", "dv"), (dq, dk, dv), refs):
        assert got.dtype == ref.dtype and got.shape == ref.shape
        assert torch.isfinite(got).all(), name
        rel = (got.float() - ref.float()).abs().max().item() / \
            ref.float().abs().max().item()
        assert rel <= grad_tol, (name, rel)


def test_flash_bf16_backward_is_deterministic(dev):
    """The bf16 backward kernels sum in a fixed order (no atomics): two
    calls on the same inputs give the same bits."""
    from deepspeed_tpu_torch.ops import flash_attention as fa

    q, k, v, do = _flash_inputs(dev, torch.bfloat16, 2, 8, 2, 2048, 128)
    out, lse = fa.flash_fwd(q, k, v, True, 128 ** -0.5)
    first = fa.flash_bwd(q, k, v, out, lse, do, True, 128 ** -0.5)
    second = fa.flash_bwd(q, k, v, out, lse, do, True, 128 ** -0.5)
    torch.cuda.synchronize()
    for name, a, b in zip(("dq", "dk", "dv"), first, second):
        assert torch.equal(a, b), name


def test_flash_autograd_launches_the_kernels(dev):
    from deepspeed_tpu_torch.ops import flash_attention as fa
    from deepspeed_tpu_torch.ops.attention import dot_product_attention

    q, k, v, _ = _flash_inputs(dev, torch.bfloat16, 1, 4, 2, 256, 64)
    q, k, v = (t.transpose(1, 2).contiguous().requires_grad_() for t in
               (q, k, v))
    fa.counts.reset()
    out = dot_product_attention(q, k, v, causal=True)
    out.float().square().sum().backward()
    torch.cuda.synchronize()
    assert (fa.counts.fwd, fa.counts.bwd, fa.counts.plain,
            fa.counts.plain_bwd) == (1, 1, 0, 0)
    assert k.grad.shape == k.shape and torch.isfinite(q.grad.float()).all()
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_fwd(*(torch.zeros(1, 2, 128, 80, device=dev)
                       for _ in range(3)), True, 0.1)
    with pytest.raises(ValueError, match="S >= 128"):
        fa.flash_fwd(*(torch.zeros(1, 2, 64, 64, device=dev,
                                   dtype=torch.bfloat16)
                       for _ in range(3)), True, 0.1)


def test_cuda_train_step_runs_attention_through_k4(dev):
    """One fp32 engine step on the card against the CPU engine from the same
    weights; every attention of the card's step goes through K4."""
    import numpy as np

    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.inference.weights import to_jax_tree
    from deepspeed_tpu_torch.models import build_model
    from deepspeed_tpu_torch.ops import flash_attention as fa

    cfg = {"train_micro_batch_size_per_gpu": 2,
           "gradient_accumulation_steps": 2, "bf16": {"enabled": False},
           "optimizer": {"type": "AdamW", "params": {"lr": 1e-3, "eps": 1e-5}},
           "activation_checkpointing": {"policy": "full"}}
    over = dict(hidden_size=256, dtype=torch.float32)
    cpu = build_model("tiny-llama", device="cpu", **over)
    init = to_jax_tree(cpu)
    batch = {"input_ids": np.random.default_rng(0).integers(
        0, 256, (4, 128)).astype(np.int32)}
    losses = {}
    for where in ("cpu", "cuda"):
        model = build_model("tiny-llama", device=where, **over)
        engine, *_ = dst.initialize(model=model, config=dict(cfg),
                                    params=init, device=where)
        fa.counts.reset()
        losses[where] = [float(engine.train_batch(batch)) for _ in range(2)]
        if where == "cuda":
            layers = model.config.num_layers
            # remat "full": each layer's forward runs again in its backward
            assert fa.counts.fwd == 2 * layers * 2 * 2
            assert fa.counts.bwd == 2 * layers * 2
            assert fa.counts.plain == fa.counts.plain_bwd == 0
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-4)


def test_cuda_moe_train_step_runs_experts_through_k5(dev):
    """Two fp32 engine steps of tiny-mixtral on the dropless route on the
    card against the CPU engine from the same weights: every expert product
    goes through K5's forward kernel and its backward through the dx and dw
    kernels (3 products x 2 layers x 2 micro-batches x 2 steps each, the
    forward twice under remat "full"); no plain version runs."""
    import dataclasses

    import numpy as np

    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.inference.weights import to_jax_tree
    from deepspeed_tpu_torch.models import build_model, get_model_config

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = {"train_micro_batch_size_per_gpu": 2,
           "gradient_accumulation_steps": 2, "bf16": {"enabled": False},
           "optimizer": {"type": "AdamW", "params": {"lr": 1e-3, "eps": 1e-5}},
           "activation_checkpointing": {"policy": "full"}}
    moe = dataclasses.replace(get_model_config("tiny-mixtral").moe,
                              dropless=True, dropless_block_m=32)
    over = dict(moe=moe, dtype=torch.float32)
    init = to_jax_tree(build_model("tiny-mixtral", device="cpu", **over))
    batch = {"input_ids": np.random.default_rng(0).integers(
        0, 256, (4, 64)).astype(np.int32)}
    losses = {}
    for where in ("cpu", "cuda"):
        model = build_model("tiny-mixtral", device=where, **over)
        engine, *_ = dst.initialize(model=model, config=dict(cfg),
                                    params=init, device=where)
        gm.counts.reset()
        losses[where] = [float(engine.train_batch(batch)) for _ in range(2)]
        if where == "cuda":
            passes = 3 * 2 * 2 * 2
            assert (gm.counts.kernel, gm.counts.kernel_dx,
                    gm.counts.kernel_dw) == (2 * passes, passes, passes)
            assert gm.counts.plain == gm.counts.plain_dx == \
                gm.counts.plain_dw == 0
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-4)


def _k6_case(dev, dtype, B, H, S, D, block, seed=0):
    """Inputs and tables of one K6 case: a random layout with an empty query
    row (0) and a row (1) that sees only the last block (above the diagonal:
    wholly masked under causal)."""
    import numpy as np

    from deepspeed_tpu_torch.ops import block_sparse_attention as bsa

    n = S // block
    layout = np.random.default_rng(seed).random((H, n, n)) < 0.4
    layout[:, 0] = False
    layout[:, 1] = False
    layout[:, 1, n - 1] = True
    g = torch.Generator(device=dev).manual_seed(seed)
    rnd = lambda sd=1.0: (torch.randn(B, H, S, D, generator=g, device=dev)
                          * sd).to(dtype)
    return (rnd(2.0), rnd(), rnd(), rnd()), bsa.device_tables(layout, dev)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [64, 128, 256])
@pytest.mark.parametrize("S,block,causal", [(512, 128, False),
                                            (512, 128, True),
                                            (1024, 128, True),
                                            (408, 136, True),
                                            (576, 192, False),
                                            (768, 256, True),
                                            (768, 256, False)])
def test_block_sparse_kernels_match_plain_versions(dev, dtype, D, S, block,
                                                   causal):
    """K6's forward (out, lse), dq and dk/dv kernels, each against its plain
    version by ``K4_TOL``, on the route ``kernel_route`` names (bf16 at
    blocks 128 and 256: the wgmma kernels; fp32 and blocks 136 / 192: the
    FMA kernels), counted as such; the empty row and the row visible only
    above the diagonal (causal) give zeros and no gradient; a second launch
    gives the same bits."""
    from deepspeed_tpu_torch.ops import block_sparse_attention as bsa

    (q, k, v, do), tables = _k6_case(dev, dtype, 2, 2, S, D, block)
    scale = D ** -0.5
    tc = int(dtype == torch.bfloat16 and block % 128 == 0)
    assert bsa.kernel_route(dtype, block) == ("wgmma" if tc else "fma")
    bsa.counts.reset()
    out, lse = bsa.block_sparse_fwd(q, k, v, tables, block, causal, scale)
    torch.cuda.synchronize()
    assert (bsa.counts.fwd, bsa.counts.fwd_tc, bsa.counts.plain) == (1, tc,
                                                                     0)
    ref_out, ref_lse = bsa.block_sparse_fwd_plain(q, k, v, tables, block,
                                                  causal, scale)
    out_tol, grad_tol = K4_TOL[dtype]
    err = (out.float() - ref_out.float()).abs().max().item()
    if dtype == torch.bfloat16:
        err /= ref_out.float().abs().max().item()
    assert err <= out_tol, ("out", err)
    assert (lse - ref_lse).abs().max().item() <= 1e-3
    assert not out[:, :, :block].any()
    dout, lse_c, delta = bsa.bwd_operands(q, k, v, out, ref_lse, do)
    dq = bsa.launch_dq(q, k, v, dout, lse_c, delta, tables, block, causal,
                       scale)
    dk, dv = bsa.launch_dkv(q, k, v, dout, lse_c, delta, tables, block,
                            causal, scale)
    refs = bsa.block_sparse_bwd_plain(q, k, v, out, ref_lse, do, tables,
                                      block, causal, scale)
    for name, got, ref in zip(("dq", "dk", "dv"), (dq, dk, dv), refs):
        assert got.dtype == ref.dtype and torch.isfinite(got.float()).all()
        rel = (got.float() - ref.float()).abs().max().item() / \
            ref.float().abs().max().item()
        assert rel <= grad_tol, (name, rel)
    assert not dq[:, :, :block].any()
    if causal:
        assert not out[:, :, block:2 * block].any()
        assert not dq[:, :, block:2 * block].any()
    again = bsa.block_sparse_fwd(q, k, v, tables, block, causal, scale)
    again += bsa.block_sparse_bwd(q, k, v, out, ref_lse, do, tables, block,
                                  causal, scale)
    torch.cuda.synchronize()
    assert (bsa.counts.fwd, bsa.counts.fwd_tc, bsa.counts.bwd,
            bsa.counts.bwd_tc) == (2, 2 * tc, 1, tc)
    for name, a, b in zip(("out", "lse", "dq", "dk", "dv"), again,
                          (out, lse, dq, dk, dv)):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("D", [64, 128, 256])
@pytest.mark.parametrize("causal", [True, False])
def test_block_sparse_wgmma_route_is_k4_on_a_dense_layout(dev, D, causal):
    """On an all-ones layout at block 128 K6's wgmma kernels walk K4's
    tiles in K4's order through the same body: out, lse, dq, dk and dv equal
    K4's on the same inputs bit for bit."""
    import numpy as np

    from deepspeed_tpu_torch.ops import block_sparse_attention as bsa
    from deepspeed_tpu_torch.ops import flash_attention as fa

    B, H, S = 2, 4, 1024
    q, k, v, do = _flash_inputs(dev, torch.bfloat16, B, H, H, S, D, seed=5)
    scale = D ** -0.5
    tables = bsa.device_tables(np.ones((H, S // 128, S // 128), bool), dev)
    bsa.counts.reset()
    got = bsa.block_sparse_fwd(q, k, v, tables, 128, causal, scale)
    got += bsa.block_sparse_bwd(q, k, v, *got, do, tables, 128, causal,
                                scale)
    want = fa.flash_fwd(q, k, v, causal, scale)
    want += fa.flash_bwd(q, k, v, *want, do, causal, scale)
    torch.cuda.synchronize()
    assert (bsa.counts.fwd_tc, bsa.counts.bwd_tc) == (1, 1)
    for name, a, b in zip(("out", "lse", "dq", "dk", "dv"), got, want):
        assert torch.equal(a, b), name


def test_tma_launches_run_from_a_fresh_thread(dev):
    """Every host entry that encodes a TMA tensor map binds the device's
    context first: K4's bf16 backward, K6's bf16 backward and a K1 chunk
    call, each a new thread's first CUDA work, give the main thread's
    bits."""
    import threading

    import numpy as np

    from deepspeed_tpu_torch.ops import block_sparse_attention as bsa
    from deepspeed_tpu_torch.ops import flash_attention as fa

    q, k, v, do = _flash_inputs(dev, torch.bfloat16, 1, 4, 4, 512, 128,
                                seed=9)
    scale = 128 ** -0.5
    tables = bsa.device_tables(np.tril(np.ones((4, 4, 4), bool)), dev)
    out, lse = fa.flash_fwd(q, k, v, True, scale)
    s_out, s_lse = bsa.block_sparse_fwd(q, k, v, tables, 128, True, scale)
    args, kw = _bf16_case(dev, "chunk", "linear", bs=64, D=128, pool="bf16",
                          seed=4)
    torch.cuda.synchronize()
    calls = {
        "k4": lambda: fa.flash_bwd(q, k, v, out, lse, do, True, scale),
        "k6": lambda: bsa.block_sparse_bwd(q, k, v, s_out, s_lse, do,
                                           tables, 128, True, scale),
        "k1": lambda: (pa.paged_ragged_attention(*args, block_size=64,
                                                 layer_index=1, **kw),)}
    for name, run in calls.items():
        got = {}

        def work():
            try:
                got["out"] = run()
                torch.cuda.synchronize()
            except Exception as err:      # raised again in the test thread
                got["err"] = err

        t = threading.Thread(target=work)
        t.start()
        t.join(timeout=120)
        assert not t.is_alive(), name
        if "err" in got:
            raise got["err"]
        main = run()
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(got["out"], main)), \
            name


def test_sparse_self_attention_launches_the_kernels(dev):
    """Autograd through ``SparseSelfAttention`` on the card: one forward and
    one backward launch of K6, never a plain version; the masked route (a
    block under 128) launches nothing of K6."""
    import numpy as np

    from deepspeed_tpu_torch.ops import block_sparse_attention as bsa
    from deepspeed_tpu_torch.ops.sparse_attention import (
        BigBirdSparsityConfig, FixedSparsityConfig, SparseSelfAttention)

    g = torch.Generator(device=dev).manual_seed(0)
    mk = lambda: torch.randn(1, 1024, 4, 64, generator=g, device=dev,
                             dtype=torch.bfloat16).requires_grad_()
    for cfg in (BigBirdSparsityConfig(num_heads=4, block=128,
                                      different_layout_per_head=True),
                FixedSparsityConfig(num_heads=4, block=128,
                                    attention="unidirectional")):
        q, k, v = mk(), mk(), mk()
        bsa.counts.reset()
        SparseSelfAttention(cfg)(q, k, v).float().square().sum().backward()
        torch.cuda.synchronize()
        assert vars(bsa.counts) == {"fwd": 1, "bwd": 1, "fwd_tc": 1,
                                    "bwd_tc": 1, "plain": 0, "plain_bwd": 0}
        assert all(torch.isfinite(t.grad.float()).all() for t in (q, k, v))
    bsa.counts.reset()
    SparseSelfAttention(BigBirdSparsityConfig(num_heads=4, block=64))(
        mk(), mk(), mk())
    assert vars(bsa.counts) == {"fwd": 0, "bwd": 0, "fwd_tc": 0,
                                "bwd_tc": 0, "plain": 0, "plain_bwd": 0}
    tables = bsa.device_tables(np.ones((2, 2, 2), bool), dev)
    with pytest.raises(ValueError, match="head dim"):
        bsa.block_sparse_fwd(*(torch.zeros(1, 2, 256, 80, device=dev)
                               for _ in range(3)), tables, 128, False, 0.1)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("D", [64, 128, 256])
@pytest.mark.parametrize("G", [1, 4])
@pytest.mark.parametrize("form", ["linear", "window", "ring", "decode"])
def test_paged_prefill_kernel_matches_plain_version(dev, dtype, tol, D, G,
                                                    form):
    """K7 against its plain version: prefill chunks over a linear table
    (one empty slot), with a window (slot 1's rows past seq_len see no key
    on the page the kernel runs, and average it, as the Pallas kernel
    does), from a wrapped ring, and decode; fp32 by max |error|, bf16 over
    max |plain|."""
    KV, bs, nb = 2, 16, 64
    S, T = 3, (1 if form == "decode" else 24)
    g = torch.Generator(device=dev).manual_seed(G + D)
    q = (torch.randn(S, T, KV * G, D, generator=g, device=dev) * 3).to(dtype)
    kp = torch.randn(KV, nb * bs, D, generator=g, device=dev).to(dtype)
    vp = torch.randn(KV, nb * bs, D, generator=g, device=dev).to(dtype)
    kw = dict(block_size=bs)
    if form == "ring":
        kw.update(window=40, ring_tokens=64)
        lens, starts, mp = [150, 20, 300], [126, 8, 276], 4
    elif form == "window":
        kw.update(window=8)
        lens, starts, mp = [90, 30, 300], [66, 32, 276], 24
    else:
        lens, starts, mp = [90, 0, 300], [66, 0, 276], 24
        if form == "decode":
            starts = [max(n - 1, 0) for n in lens]
    tables = torch.randint(1, nb, (S, mp), generator=g, device=dev,
                           dtype=torch.int32)
    lens = torch.tensor(lens, dtype=torch.int32, device=dev)
    starts = torch.tensor(starts, dtype=torch.int32, device=dev)
    pa.prefill_counts.reset()
    if form == "decode":
        got = pa.paged_decode_attention(q[:, 0], kp, vp, tables, lens, **kw)
        got = got[:, None]
    else:
        got = pa.paged_prefill_attention(q, kp, vp, tables, lens, starts,
                                         **kw)
    torch.cuda.synchronize()
    assert vars(pa.prefill_counts) == {
        "kernel": 1, "kernel_window": int("window" in kw),
        "kernel_ring": int("ring_tokens" in kw),
        "kernel_chunk": int(dtype == torch.bfloat16 and T * G > 16),
        "kernel_split": int(dtype == torch.bfloat16 and T * G <= 16),
        "plain": 0}
    ref = pa.paged_prefill_attention_reference(q, kp, vp, tables, lens,
                                               starts, **kw)
    err = (got.float() - ref.float()).abs().max().item()
    if dtype == torch.bfloat16:
        err /= ref.float().abs().max().item()
    assert torch.isfinite(got.float()).all() and err <= tol, err
    if form == "linear":
        assert not got[1].any()


def _bf16_case(dev, route, form, *, bs, D, pool, seed=0):
    """K1 inputs for one of the bf16 kernels (``route`` "split": at most
    16 rows per (slot, KV head); "chunk": more) in one form: "linear",
    "window" (100 keys), "ring" (the engine's ring for a 100-key window:
    ceil((window + stage) / bs) + 1 pages; two slots wrapped, one not) or
    "tree" (a branchy tree). KV 2, G 4; one empty slot; tables padded with
    the trash page 0; ``pool`` "bf16" or "e4m3"."""
    g = torch.Generator(device=dev).manual_seed(seed)
    rnd = lambda *sh: torch.randn(sh, generator=g, device=dev).to(
        torch.bfloat16)
    i32 = lambda v: torch.tensor(v, dtype=torch.int32, device=dev)
    KV, G = 2, 4
    tree = form == "tree"
    if tree:
        T = 4 if route == "split" else 6
        Ts = 8
    else:
        T = 1 if route == "split" else 40
        Ts = 8 if route == "split" else 48
    kw = {}
    window = 100 if form in ("window", "ring") else None
    if window:
        kw["window"] = window
    nwin = -(-(100 + Ts) // bs) + 1
    ctx = {"ring": [3 * nwin * bs + 17, nwin * bs + 5, -1, bs // 2]}.get(
        form, [0, 150, 700, -1] if not tree else [40, 300, -1, 113])
    S = len(ctx)
    max_pages = nwin if form == "ring" else max(
        -(-(max(c, 0) + Ts) // bs) for c in ctx) + 2
    nb = S * max_pages + 1
    perm = torch.randperm(nb - 1, generator=torch.Generator().manual_seed(
        seed)) + 1
    tables = torch.zeros(S, max_pages, dtype=torch.int32)
    lens, sst, used = [], [], 0
    for s, c in enumerate(ctx):
        if c < 0:
            lens.append(0), sst.append(0)
            continue
        n = nwin if form == "ring" else -(-(c + Ts) // bs)
        tables[s, :n] = perm[used:used + n].to(torch.int32)
        used += n
        sst.append(c)
        lens.append(c + (T - s % 2 if not tree else 3))
    q = rnd(S, T, KV * G, D) * 3
    kv = rnd(2, 2, KV, nb, bs, D)
    if pool == "e4m3":
        kv = qm.to_e4m3(kv)
    args = [q, kv, rnd(S, KV, Ts, D), rnd(S, KV, Ts, D), tables.to(dev),
            i32(lens), i32(sst), i32(sst)]
    if form == "ring":
        kw["ring_tokens"] = nwin * bs
    if tree:
        parents = [-1, 0, 0, 1, 2, 3][:T]
        pos = torch.zeros(S, T, dtype=torch.int32)
        mask = torch.zeros(S, T, T, dtype=torch.uint8)
        for s, c in enumerate(ctx):
            mask[s] = torch.eye(T, dtype=torch.uint8)
            if c < 0:
                continue
            depth = [0] * T
            for i, p in enumerate(parents):
                depth[i] = depth[p] + 1 if p >= 0 else 0
                j = i
                while j != -1:
                    mask[s, i, j] = 1
                    j = parents[j]
            pos[s] = torch.tensor([c + d for d in depth])
        args[6] = pos[:, 0].contiguous().to(dev)
        kw.update(tree_positions=pos.to(dev), tree_mask=mask.to(dev))
    return args, kw


@pytest.mark.parametrize("route", ["split", "chunk"])
@pytest.mark.parametrize("form", ["linear", "window", "ring", "tree"])
@pytest.mark.parametrize("bs", [8, 64, 128])
@pytest.mark.parametrize("D", [64, 128, 256])
@pytest.mark.parametrize("pool", ["bf16", "e4m3"])
def test_bf16_split_and_chunk_kernels_match_plain_version(dev, route, form,
                                                          bs, D, pool):
    """K1's bf16 kernels in every form, page size and head dim, over a bf16
    or an e4m3 pool, against the plain version (p rounded against the
    kernel's walk: its 64-key tiles and, for the split kernel, its splits);
    the route is counted, the empty slot is zeros, the split kernel runs
    more than one split, and a second launch gives the same bits."""
    args, kw = _bf16_case(dev, route, form, bs=bs, D=D, pool=pool)
    S, T, H, _ = args[0].shape
    got_route, split_cols = pa.kernel_plan(args[0], 2, args[4].shape[1], bs)
    assert got_route == route
    if route == "split":
        assert -(-args[4].shape[1] * bs // split_cols) > 1
    before = dict(vars(pa.counts))
    got = pa.paged_ragged_attention(*args, block_size=bs, layer_index=1,
                                    **kw)
    again = pa.paged_ragged_attention(*args, block_size=bs, layer_index=1,
                                      **kw)
    torch.cuda.synchronize()
    after = vars(pa.counts)
    assert after[f"kernel_{route}"] == before[f"kernel_{route}"] + 2
    assert torch.equal(got, again)
    ref = pa.paged_ragged_attention_reference(
        *args, block_size=bs, layer_index=1,
        p_round_blocks=(pa.KERNEL_KEY_TILE, pa.KERNEL_KEY_TILE),
        p_round_splits=split_cols or None, **kw)
    live = args[5] > 0
    assert (got[~live] == 0).all()
    assert torch.isfinite(got.float()).all()
    d = (got[live].float() - ref[live].float()).abs()
    scale = ref[live].float().abs()
    assert d.max().item() / scale.max().item() <= 1e-2
    if pool == "e4m3":
        assert (d.mean() / scale.mean()).item() <= 1e-4


@pytest.mark.parametrize("T", [1, 4, 40])
@pytest.mark.parametrize("bs", [8, 128])
@pytest.mark.parametrize("form", ["linear", "window", "ring"])
def test_k7_bf16_kernels_match_plain_version(dev, T, bs, form):
    """K7's split (T x G <= 16) and chunk kernels at other page sizes, one
    empty slot and rows past seq_len (which average their run pages, the
    Pallas kernel's unguarded softmax), against the plain version; a second
    launch gives the same bits."""
    KV, G, D, S = 2, 4, 128, 4
    nb = 64
    g = torch.Generator(device=dev).manual_seed(T + bs)
    q = (torch.randn(S, T, KV * G, D, generator=g, device=dev) * 3).to(
        torch.bfloat16)
    kp = torch.randn(KV, nb * bs, D, generator=g, device=dev).to(
        torch.bfloat16)
    vp = torch.randn(KV, nb * bs, D, generator=g, device=dev).to(
        torch.bfloat16)
    kw = dict(block_size=bs)
    mp = 24 if bs == 8 else 6
    if form == "ring":
        # the engine's ring for the window and the chunk, wrapped twice
        mp = -(-(40 + T) // bs) + 1
        kw.update(window=40, ring_tokens=mp * bs)
        lens = [2 * mp * bs + 30, 20, 0, mp * bs + 1]
    else:
        if form == "window":
            kw.update(window=70)
        lens = [min(mp * bs, 150), T // 2, 0, mp * bs - 3]
    starts = [max(n - T, 0) for n in lens]
    tables = torch.randint(1, nb, (S, mp), generator=g, device=dev,
                           dtype=torch.int32)
    lens = torch.tensor(lens, dtype=torch.int32, device=dev)
    starts = torch.tensor(starts, dtype=torch.int32, device=dev)
    route = pa.kernel_route(torch.bfloat16, T * G)
    pa.prefill_counts.reset()
    got = pa.paged_prefill_attention(q, kp, vp, tables, lens, starts, **kw)
    again = pa.paged_prefill_attention(q, kp, vp, tables, lens, starts, **kw)
    torch.cuda.synchronize()
    assert pa.prefill_counts.kernel == 2
    assert getattr(pa.prefill_counts, f"kernel_{route}") == 2
    assert torch.equal(got, again)
    ref = pa.paged_prefill_attention_reference(q, kp, vp, tables, lens,
                                               starts, **kw)
    assert not got[2].any()
    err = (got.float() - ref.float()).abs().max().item()
    assert err / ref.float().abs().max().item() <= 1e-2, err


# ---------------------------------------------------------------------------
# the serving pipeline: decode programs as CUDA graphs
# ---------------------------------------------------------------------------

def _graph_engine(dev, name="tiny-llama", model_over=None, **over):
    """A bf16 engine on the card over seeded random weights (hidden 256,
    head dim 64), and its prompts."""
    from deepspeed_tpu_torch.inference import InferenceEngineV2
    from deepspeed_tpu_torch.models import build_model

    model = build_model(name, hidden_size=256, device=dev,
                        dtype=torch.bfloat16, seed=3, **(model_over or {}))
    cfg = dict(block_size=8, num_blocks=96, max_seqs=4, chunk=16,
               max_seq_len=128, dtype=torch.bfloat16, device=dev)
    prompts = [list(range(i, i + n)) for i, n in ((0, 37), (50, 5), (9, 21),
                                                  (3, 30))]
    return InferenceEngineV2(model, config=dict(cfg, **over)), prompts


def _decoding(eng, prompts, new=24):
    """Put the prompts and step until every one decodes, the pipeline
    drained."""
    for uid, p in enumerate(prompts):
        eng.put(uid, p, max_new_tokens=new)
    while eng.scheduler.pending_kinds()[0]:
        eng.step()
    eng._drain(drain_all=True)
    torch.cuda.synchronize()


def _moe_over():
    import dataclasses

    from deepspeed_tpu_torch.models import get_model_config

    return {"moe": dataclasses.replace(get_model_config("tiny-qwen2-moe").moe,
                                       dropless=True)}


@pytest.mark.parametrize("label", ["bf16", "int8+e4m3-pool", "moe-dropless"])
def test_window_graph_replay_equals_the_eager_window(dev, label):
    """A decode window's graph replay against the same window run eagerly
    from the same state: identical tokens, pool and last tokens, bit for
    bit, and the same kernel launches."""
    from deepspeed_tpu_torch.inference.programs import count_snapshot, pack

    name, model_over, over = {
        "bf16": ("tiny-llama", None, {}),
        "int8+e4m3-pool": ("tiny-llama", None,
                           {"quant_bits": 8, "kv_cache_dtype": "fp8"}),
        "moe-dropless": ("tiny-qwen2-moe", _moe_over(), {}),
    }[label]
    eng, prompts = _graph_engine(dev, name, model_over, **over)
    _decoding(eng, prompts)
    W, arrays, _, _ = eng._window_plan()
    assert W == 8
    pool, last = eng.kv_pool.clone(), eng._last_tok.clone()
    flat = torch.from_numpy(pack(arrays)).to(dev)

    def delta(before):
        return [{k: v - b[k] for k, v in a.items() if v != b[k]}
                for b, a in zip(before, count_snapshot())]

    c0 = count_snapshot()
    eager = eng._window_body(W, flat.clone())[0].clone()
    torch.cuda.synchronize()
    eager_counts = delta(c0)
    eager_pool, eager_last = eng.kv_pool.clone(), eng._last_tok.clone()
    eng.kv_pool.copy_(pool)
    eng._last_tok.copy_(last)
    prog = eng._programs.get(("win", W), lambda x: eng._window_body(W, x),
                             flat.numel())
    prog.inputs.copy_(flat)
    c0 = count_snapshot()
    replayed = prog.replay()[0]
    torch.cuda.synchronize()
    assert delta(c0) == eager_counts
    assert any(eager_counts[0].values())          # K1 launched
    assert torch.equal(replayed, eager) and bool((eager >= 0).any())
    assert torch.equal(eng._last_tok, eager_last)
    bits = lambda t: t.view(torch.uint8)[:, :, :, 1:]  # past the trash block
    assert torch.equal(bits(eng.kv_pool), bits(eager_pool))


@pytest.mark.parametrize("decode_window", [1, 8])
def test_pipelined_streams_equal_the_synchronous_stream(dev, decode_window):
    """Inputs that change at every dispatch, eight dispatches in flight:
    every dispatch stages its plan through the pinned ring while earlier
    copies may still be pending, and replays the same graphs. The streams
    are the synchronous engine's, and every decode step or window replayed
    a graph."""
    streams = {}
    for max_inflight in (0, 8):
        eng, prompts = _graph_engine(dev, max_inflight=max_inflight,
                                     decode_window=decode_window)
        prompts = prompts + [list(range(7, 7 + n)) for n in (3, 11, 17, 2)]
        streams[max_inflight] = eng.generate(prompts, max_new_tokens=20)
        st = eng.stats
        replays = eng._programs.stats()["replays"]
        windows = sum(n for k, n in replays.items() if "win" in k)
        assert windows == st["windows"]
        assert replays.get("(1, 4)", 0) >= st["decode_steps"]
        assert st["windows" if decode_window > 1 else "decode_steps"] > 0
        if max_inflight:
            assert st["forced_drains"] + st["opportunistic_drains"] \
                == st["dispatches"]
    assert streams[8] == streams[0]


@pytest.mark.parametrize("filters", [{}, {"top_k": 20, "top_p": 0.9}])
def test_sampling_replays_draw_new_numbers(dev, filters):
    """At temperature 1 (with and without top-k / top-p), two replays of a
    window from equal inputs draw different tokens (the engine's generator
    is registered with the graph), and two engines with the same seed draw
    the same streams."""
    from deepspeed_tpu_torch.inference.programs import pack

    over = dict(greedy=False, temperature=1.0, **filters)
    eng, prompts = _graph_engine(dev, **over)
    _decoding(eng, prompts)
    W, arrays, _, _ = eng._window_plan()
    flat = torch.from_numpy(pack(arrays)).to(dev)
    prog = eng._programs.get(("win", W), lambda x: eng._window_body(W, x),
                             flat.numel())
    pool, last = eng.kv_pool.clone(), eng._last_tok.clone()
    draws = []
    for _ in range(2):
        eng.kv_pool.copy_(pool)
        eng._last_tok.copy_(last)
        prog.inputs.copy_(flat)
        draws.append(prog.replay()[0].clone())
    assert not torch.equal(draws[0], draws[1])
    a, prompts = _graph_engine(dev, **over)
    b, _ = _graph_engine(dev, **over)
    assert a.generate(prompts, 16) == b.generate(prompts, 16)


def test_warm_ups_capture_every_decode_program(dev):
    """``warm_decode_windows`` and ``warm_decode_step`` capture every decode
    program a serve dispatches (23 tokens after the prefill's: windows of
    8, 8, 4 and 2, then one decode step) and leave the pool past the trash
    block and the last tokens as they were; the serve then captures nothing
    and gives an unwarmed engine's streams."""
    cold, prompts = _graph_engine(dev)
    ref = cold.generate(prompts, 24)
    del cold
    eng, _ = _graph_engine(dev)
    for uid, p in enumerate(prompts):
        eng.put(uid, p, max_new_tokens=24)
    while eng.scheduler.pending_kinds()[0]:
        eng.step()
    pool, last = eng.kv_pool.clone(), eng._last_tok.clone()
    eng.warm_decode_windows()
    eng.warm_decode_step()
    bits = lambda t: t.view(torch.uint8)[:, :, :, 1:]  # past the trash block
    assert torch.equal(bits(eng.kv_pool), bits(pool))
    assert torch.equal(eng._last_tok, last)
    keys = set(eng._programs.programs)
    assert {("win", 8), ("win", 4), ("win", 2), (1, 4)} <= keys
    while any(not eng.query(u)["done"] for u in range(len(prompts))):
        eng.step()
    assert set(eng._programs.programs) == keys
    assert [eng.flush(u) for u in range(len(prompts))] == ref
    assert eng._programs.stats()["replays"]["(1, 4)"] > 0


def test_a_second_engine_captures_after_the_first_is_freed(dev):
    import gc

    eng, prompts = _graph_engine(dev)
    eng.warm_decode_windows()
    first = eng.generate(prompts, 16)
    assert eng._programs.stats()["graphs"] >= 3
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    eng, _ = _graph_engine(dev)
    assert eng.generate(prompts, 16) == first
    assert eng._programs.stats()["replays"]["('win', 8)"] > 0


# ---------------------------------------------------------------------------
# KV movement and the weight swap into engines whose graphs are captured
# ---------------------------------------------------------------------------

def _to_first_tokens(eng, prompts, new):
    """Put the prompts and step until each has its first token scheduled
    (the scheduled view: two engines driven alike dispatch alike)."""
    for uid, p in enumerate(prompts):
        eng.put(uid, p, max_new_tokens=new)
    while any(s.n_generated + s.n_inflight < 1
              for s in eng.state.seqs.values()):
        eng.step()


def _finish(eng, uids):
    while any(not eng.query(u)["done"] for u in uids):
        eng.step()
    return [eng.flush(u) for u in uids]


@pytest.mark.parametrize("kv", [None, "fp8"])
def test_import_into_a_captured_engine_keeps_streams_and_graphs(dev, kv):
    """Sequences exported after their first tokens and imported into an
    engine whose decode programs are captured: the imported pages are the
    exported bytes, the streams equal an engine's that served them without
    migrating (driven alike), and the importer replays its graphs with no
    recapture. Exports gather through pinned memory, imports scatter from
    it, on the engine's stream behind the dispatches in flight."""
    over = {"kv_cache_dtype": kv} if kv else {}
    ref, prompts = _graph_engine(dev, **over)
    uids = list(range(len(prompts)))
    _to_first_tokens(ref, prompts, 24)
    ref._drain(drain_all=True)
    want = _finish(ref, uids)
    a, _ = _graph_engine(dev, **over)
    b, _ = _graph_engine(dev, **over)
    b.warm_decode_windows()
    b.warm_decode_step()
    keys = set(b._programs.programs)
    windows = lambda: sum(n for k, n in b._programs.stats()[
        "replays"].items() if "win" in k)
    warm = windows()
    _to_first_tokens(a, prompts, 24)
    bundles = [a.export_migration(u) for u in uids]
    for u, bundle in zip(uids, bundles):
        b.import_reserve(u, bundle.meta())
        b.import_complete(u, bundle)
    for u, bundle in zip(uids, bundles):
        n = bundle.n_full
        got = b._gather_pages(b.state.seqs[u].blocks[:n])
        assert got == bundle.pages
    assert _finish(b, uids) == want
    assert set(b._programs.programs) == keys
    assert windows() - warm == b.stats["windows"] > 0
    assert [a.export_commit(u) for u in uids] == \
        [w[:len(bd.tokens) - bd.prompt_len] for w, bd in zip(want, bundles)]
    a.state.audit()
    b.state.audit()


@pytest.mark.parametrize("quant", [None, 8])
def test_swap_with_captured_graphs_keeps_streams_and_recaptures_nothing(
        dev, tmp_path, quant):
    """A swap to the engine's own tag while its sequences are mid-decode,
    graphs live and dispatches in flight: every stream equals an unswapped
    engine's, the tensors (codes and scales too) keep their addresses, no
    program is captured again and replays continue; then a swap to other
    weights makes the same graphs serve them, as a fresh engine on those
    weights does."""
    from deepspeed_tpu_torch.inference import InferenceEngineV2
    from deepspeed_tpu_torch.inference.weights import tree_tensors
    from deepspeed_tpu_torch.models import build_model

    over = {"quant_bits": quant} if quant else {}
    ref, prompts = _graph_engine(dev, **over)
    uids = list(range(len(prompts)))
    _to_first_tokens(ref, prompts, 24)
    while any(s.n_generated + s.n_inflight < 8
              for s in ref.state.seqs.values()):
        ref.step()
    ref._drain(drain_all=True)
    want = _finish(ref, uids)
    eng, _ = _graph_engine(dev, **over)
    eng.warm_decode_windows()
    eng.warm_decode_step()
    eng.save_weights(str(tmp_path), tag="own")
    keys = set(eng._programs.programs)
    ptrs = [t.data_ptr() for t in tree_tensors(eng.params)]
    _to_first_tokens(eng, prompts, 24)
    while any(s.n_generated + s.n_inflight < 8
              for s in eng.state.seqs.values()):
        eng.step()
    assert eng._inflight
    replays = dict(eng._programs.stats()["replays"])
    eng.swap_weights(str(tmp_path), "own")
    assert _finish(eng, uids) == want
    assert set(eng._programs.programs) == keys
    assert [t.data_ptr() for t in tree_tensors(eng.params)] == ptrs
    after = eng._programs.stats()["replays"]
    assert sum(after.values()) > sum(replays.values())
    model = build_model("tiny-llama", hidden_size=256, device=dev,
                        dtype=torch.bfloat16, seed=4)
    other = InferenceEngineV2(model, config=dict(eng.config.__dict__))
    fresh = other.generate(prompts, 16)
    other.save_weights(str(tmp_path), tag="other")
    eng.state.flush_prefix_cache()
    mine = eng.generate(prompts, 16)
    eng.swap_weights(str(tmp_path), "other")
    assert eng.generate(prompts, 16) == fresh != mine
    assert set(eng._programs.programs) == keys


def test_tier_demote_and_promote_on_the_card(dev, tmp_path):
    """Eviction demotes through the pinned gather, admission promotes
    through the pinned scatter: the promoted pages are the demoted bytes and
    the stream is the one before the demotion."""
    eng, prompts = _graph_engine(dev, kv_tier=True, kv_tier_min_pages=1,
                                 kv_tier_ram_bytes=1 << 20,
                                 kv_tier_nvme_dir=str(tmp_path))
    prompt = prompts[0]
    base = eng.generate([prompt], 12)
    snap = eng.state.snapshot_prefix(prompt[:-1])
    before = eng._gather_pages(snap["blocks"])
    eng.state.release_prefix(snap["handle"])
    eng.state.allocator.free(eng._prefix_cache.evict(len(eng._prefix_cache)))
    assert eng.stats["kv_tier_demoted_pages"] >= len(before)
    eng.put(7, prompt, max_new_tokens=12)
    assert eng.stats["kv_tier_promotes"] == 1
    seq = eng.state.seqs[7]
    assert eng._gather_pages(seq.blocks[:len(before)]) == before
    assert _finish(eng, [7]) == base
    assert eng.stats["kv_tier_fallbacks"] == 0
    eng.state.audit()


def _zero_cuda_engine(stage, init, **over):
    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.models import build_model

    cfg = {"train_micro_batch_size_per_gpu": 2,
           "gradient_accumulation_steps": 2, "bf16": {"enabled": True},
           "optimizer": {"type": "AdamW", "params": {"lr": 1e-3,
                                                     "weight_decay": 0.01}},
           "activation_checkpointing": {"policy": "full"},
           "zero_optimization": {"stage": stage,
                                 "stage3_param_persistence_threshold": 1000}}
    cfg.update(over)
    model = build_model("tiny-llama", device="cuda", hidden_size=256,
                        dtype=torch.bfloat16, param_dtype=torch.float32)
    return dst.initialize(model=model, config=cfg, params=init)[0]


def _zero_case():
    import numpy as np

    from deepspeed_tpu_torch.inference.weights import to_jax_tree
    from deepspeed_tpu_torch.models import build_model

    init = to_jax_tree(build_model("tiny-llama", device="cpu",
                                   hidden_size=256, dtype=torch.float32))
    batch = {"input_ids": np.random.default_rng(0).integers(
        0, 256, (4, 128)).astype(np.int32)}
    return init, batch


def test_cuda_zero3_is_bit_identical_to_stage0(dev):
    """ZeRO-3 at world 1 over NCCL: bf16 with an fp32 master, remat full,
    K4 on every attention; losses and master bit for bit stage 0's."""
    import torch.distributed as dist

    from deepspeed_tpu_torch.ops import flash_attention as fa

    init, batch = _zero_case()
    runs = {}
    for stage in (0, 3):
        e = _zero_cuda_engine(stage, init)
        fa.counts.reset()
        runs[stage] = ([float(e.train_batch(batch)) for _ in range(3)],
                       e._full_master())
        assert fa.counts.plain == fa.counts.plain_bwd == 0
        assert fa.counts.bwd == 2 * 2 * 3
    assert dist.get_backend() == "nccl"
    assert runs[0][0] == runs[3][0]
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[3][1]))


def test_cuda_checkpoint_roundtrip(dev, tmp_path):
    """Saved at stage 3 on the card, loaded at stage 1: the next step is
    bit for bit the uninterrupted one."""
    init, batch = _zero_case()
    a = _zero_cuda_engine(3, init)
    for _ in range(2):
        a.train_batch(batch)
    a.save_checkpoint(str(tmp_path))
    b = _zero_cuda_engine(1, None)
    b.load_checkpoint(str(tmp_path))
    assert float(b.train_batch(batch)) == float(a.train_batch(batch))
    assert all(torch.equal(x, y) for x, y in zip(a._full_master(),
                                                  b._full_master()))


def test_cuda_zero3_backward_from_a_fresh_thread(dev):
    """Stage 3's gathers and K4's TMA launches from a thread whose first
    CUDA work this is (autograd's device thread is one such): the main
    thread's loss."""
    import threading

    init, batch = _zero_case()
    want = float(_zero_cuda_engine(3, init).train_batch(batch))
    got = {}

    def work():
        got["loss"] = float(_zero_cuda_engine(3, init).train_batch(batch))

    t = threading.Thread(target=work)
    t.start()
    t.join()
    assert got["loss"] == want


def _offload_cuda_engine(init, tile=None, delay=0, **zero):
    e = _zero_cuda_engine(2, init, zero_optimization={
        "stage": 2, "offload_optimizer": {"device": "cpu", **zero}})
    ho = e._host_opt
    if tile is not None:
        ho.tile = tile
    ho.delay_copies = delay
    return e


def test_cuda_offload_host_step_is_the_cpu_step(dev):
    """ZeRO-Offload on the card (stage 2 over NCCL, bf16 with an fp32
    master, TF32 off): the host step over the gradients the card copied
    back gives the master the host library gives for the same gradients
    from plain CPU tensors, bit for bit; the parameters on the card are the
    new master cast to bf16; K4 ran forward and backward, nothing plain."""
    from deepspeed_tpu_torch.ops import flash_attention as fa
    from deepspeed_tpu_torch.ops.cpu_optimizer import (HostOptState,
                                                       build_cpu_optimizer)

    torch.backends.cuda.matmul.allow_tf32 = False
    init, batch = _zero_case()
    e = _offload_cuda_engine(init, tile=1 << 14)
    ho, z = e._host_opt, e._zero
    seen = {}
    step = ho.step

    def spy(zero, lr):
        seen.update(grad=zero.grad.cpu(), lr=lr,
                    **{k: v.clone() for k, v in ho._flats.items()})
        step(zero, lr)

    ho.step = spy
    fa.counts.reset()
    for _ in range(2):
        assert torch.isfinite(e.train_batch(batch))
    assert fa.counts.plain == fa.counts.plain_bwd == 0
    assert fa.counts.fwd == 2 * 2 * 2 * 2 and fa.counts.bwd == 2 * 2 * 2
    ref = build_cpu_optimizer("AdamW", {"lr": 1e-3, "weight_decay": 0.01})
    st = HostOptState(master=seen["master"], mu=seen["mu"], nu=seen["nu"],
                      numel=seen["master"].numel())
    ref.step(st, seen["grad"], 2, lr=seen["lr"])
    for k in ("master", "mu", "nu"):
        assert torch.equal(ho._flats[k], getattr(st, k)), k
    assert z.master.device.type == "cpu" and z.grad.is_cuda
    for s, seg in enumerate(z.plan.segments):
        want = z.master[seg.part_offset:seg.part_offset + seg.chunk]
        assert torch.equal(z.local[s].cpu(), want.to(torch.bfloat16))
    assert ho.last_step["tiles"] > len(z.plan.segments)


def test_cuda_offload_copies_are_ordered_against_the_host_walk(dev):
    """Both copy streams deliberately late (each sleeps ~1 ms of GPU
    cycles before every copy, 16 K-element tiles, so the ring of pinned
    buffers wraps many times): the host must wait for each copy's event
    before it reads or refills a buffer. Losses and master bit for bit the
    undelayed run's, and Twin-Flow's device share too."""
    init, batch = _zero_case()
    for extra in ({}, {"ratio": 0.5}):
        runs = []
        for delay in (0, 2_000_000):
            e = _offload_cuda_engine(init, tile=1 << 14, delay=delay,
                                     **extra)
            losses = [float(e.train_batch(batch)) for _ in range(3)]
            flat = {}
            _flatten(e.master, "", flat)
            runs.append((losses, flat))
        assert runs[0][0] == runs[1][0]
        assert all(torch.equal(runs[0][1][k], runs[1][1][k])
                   for k in runs[0][1])


def _flatten(tree, prefix, out):
    for k, v in tree.items():
        if isinstance(v, dict):
            _flatten(v, f"{prefix}{k}.", out)
        else:
            out[prefix + k] = v


# --- tensor-parallel serving: the per-rank shapes and ranks on one card ----

@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 1e-2)])
@pytest.mark.parametrize("H,KV", [(16, 16), (8, 8), (8, 2)])
@pytest.mark.parametrize("T,Ts", [(1, 8), (40, 48)])
def test_kernel_at_tp_rank_heads_matches_plain_version(dev, dtype, tol, H,
                                                       KV, T, Ts):
    """K1 with one rank's heads: llama2-7b's 32 / 32 at TP 2, qwen2-moe's
    16 / 16 at TP 2, mistral-7b's 32 / 8 at TP 4 (G 4 over 2 KV heads)."""
    args = _case(dev, dtype, H=H, KV=KV, D=128, T=T, Ts=Ts,
                 ctx=[0, 37, 100, -1])
    before = pa.counts.kernel
    got = pa.paged_ragged_attention(*args, block_size=16, layer_index=1)
    torch.cuda.synchronize()
    assert pa.counts.kernel == before + 1
    ref = pa.paged_ragged_attention_reference(*args, block_size=16,
                                              layer_index=1)
    err = (got.float() - ref.float()).abs().max().item()
    if dtype == torch.bfloat16:
        err /= ref.float().abs().max().item()
    assert err <= tol


@pytest.mark.parametrize("bits", [8, 4, "fp8"])
@pytest.mark.parametrize("M", [8, 256])
@pytest.mark.parametrize("K,N", [(4096, 5504), (5504, 4096), (4096, 2752),
                                 (2752, 4096), (4096, 8000)])
def test_quant_matmul_at_per_shard_shapes(dev, bits, M, K, N):
    """K2 on per-shard codes (quantized shard by shard: N padded on the
    shard, int8's group resolved on the shard's K — 128 at 5504, 64 at
    2752): bf16 on the wgmma route within K2_TOL of the plain version, fp32
    within 1e-5, the same bits on a second launch."""
    qw = qm.quantize_weight(_qweight(dev, K, N, seed=M + K), bits=bits,
                            shard=True)
    x = torch.randn(M, K, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(3))
    for dtype, tol in ((torch.bfloat16, 1e-2), (torch.float32, 1e-5)):
        if dtype == torch.float32 and M != 8:
            continue
        xd = x.to(dtype)
        got = qm.quant_matmul(xd, qw)
        ref = qm.quant_matmul_reference(xd, qw)
        assert got.shape == ref.shape == (M, N)
        assert _judged(got, ref) <= tol
        assert torch.equal(got, qm.quant_matmul(xd, qw))


@pytest.mark.parametrize("bits", [8, 4, "fp8"])
@pytest.mark.parametrize("T", [8, 2048])
@pytest.mark.parametrize("K,N", [(2048, 704), (704, 2048)])
def test_quant_grouped_matmul_at_per_shard_shapes(dev, bits, T, K, N):
    """K3 on qwen2-moe's 60 experts with the expert FFN width split in two
    (704 = 5.5 x 128 columns; 704 rows, int8 groups of 64), at decode and
    prefill routings, bf16: within K2_TOL of the plain version."""
    buf, srt = _routed(dev, torch.bfloat16, T=T, k=4, n=60, K=K, bm=32,
                       seed=T + K)
    w = torch.randn(60, K, N, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(K))
    qw = qm.quantize_grouped(w / K ** 0.5, bits=bits, shard=True)
    kw = dict(block_m=32, tile_rows=srt.tile_rows)
    got = qm.quant_grouped_matmul(buf, qw, srt.tile_expert, **kw)
    ref = qm.quant_grouped_matmul_reference(buf, qw, srt.tile_expert, **kw)
    assert got.shape == ref.shape == (srt.Tp, N)
    assert _judged(got, ref) <= 1e-2


def _tp_rank_streams(n, cfg, prompts):
    """A rank of a CUDA TP engine (fp32, gloo): its streams and what it
    staged through host memory."""
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.inference import InferenceEngineV2
    from deepspeed_tpu_torch.models import build_model
    from deepspeed_tpu_torch.parallel.topology import MeshTopology

    torch.backends.cuda.matmul.allow_tf32 = False
    model = build_model("tiny-llama", hidden_size=256, num_kv_heads=4,
                        device="meta", dtype=torch.float32, seed=3)
    eng = InferenceEngineV2(model, config=dict(cfg, device="cuda"),
                            topology=MeshTopology({"tensor": n}))
    assert eng._programs is None and eng.graphs_off_reason
    return (eng.generate(prompts, 8), {k: v[0] for k, v in
                                       comm.staged.items()},
            pa.counts.kernel, pa.counts.plain)


@pytest.mark.parametrize("overlap", [False, True])
def test_cuda_tp_engine_on_gloo_ranks_matches_tp1_engine(dev, overlap,
                                                         tmp_path):
    """Two gloo ranks sharing the card (NCCL refuses two ranks on one
    device): their fp32 streams equal the CUDA TP-1 engine's, the ring
    exchanges are staged through pinned host memory, and every attention
    ran K1 on the card."""
    from deepspeed_tpu_torch.comm.spawn import RankPool
    from deepspeed_tpu_torch.inference import InferenceEngineV2
    from deepspeed_tpu_torch.models import build_model

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dict(block_size=16, num_blocks=64, max_seqs=4, chunk=16,
               max_seq_len=128, dtype=torch.float32, tp_overlap=overlap)
    prompts = [list(range(i, i + n)) for i, n in ((0, 37), (50, 5), (9, 21))]
    one = InferenceEngineV2(
        build_model("tiny-llama", hidden_size=256, num_kv_heads=4,
                    device=dev, dtype=torch.float32, seed=3),
        config=dict(cfg, device=dev, tp_overlap=False))
    want = one.generate(prompts, 8)
    with RankPool(2, str(tmp_path)) as pool:
        outs = pool.run(_tp_rank_streams, 2, cfg, prompts)
    for streams, staged, kernel, plain in outs:
        assert streams == want
        assert kernel > 0 and plain == 0
        assert ("ppermute" in staged) == overlap
        assert "all_gather" in staged


def _seq_rank_ulysses(dtype_name, S, H, D):
    """A seq rank's Ulysses attention over two gloo ranks on the card: its
    output rows and its q/k/v gradient rows of sum(out * do), K4's
    launches and what was staged through host memory."""
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.ops import flash_attention as fa
    from deepspeed_tpu_torch.parallel import sequence as seqp
    from deepspeed_tpu_torch.parallel.topology import MeshTopology

    topo = MeshTopology({"seq": 2})
    comm.set_topology(topo)
    r = topo.rank_in("seq")
    q, k, v, do = _seq_inputs(getattr(torch, dtype_name), S, H, D)
    rows = slice(r * S // 2, (r + 1) * S // 2)
    xs = [x[:, rows].clone().requires_grad_() for x in (q, k, v)]
    fa.counts.reset()
    out = seqp.ulysses_attention(*xs)
    out.backward(do[:, rows])
    return ([out.detach()] + [x.grad for x in xs],
            (fa.counts.fwd, fa.counts.bwd, fa.counts.plain),
            sorted(comm.staged))


def _seq_inputs(dtype, S, H, D):
    g = torch.Generator(device="cuda").manual_seed(S + H)
    return [torch.randn((1, S, H, D), generator=g, device="cuda").to(dtype)
            for _ in range(4)]


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
def test_ulysses_on_gloo_ranks_matches_one_rank_k4(dev, dtype, tol,
                                                   tmp_path):
    """Two gloo ranks sharing the card, each running K4 over the whole
    sequence at half the heads after the all-to-all: their output and
    gradient rows equal one rank's K4 over the whole sequence at every
    head (within K4's own tolerance against its plain version: fp32
    absolute, bf16 over max |reference|); the exchanges are staged
    through pinned host memory."""
    from deepspeed_tpu_torch.comm.spawn import RankPool
    from deepspeed_tpu_torch.ops import flash_attention as fa

    S, H, D = 1024, 4, 128
    q, k, v, do = _seq_inputs(dtype, S, H, D)
    xs = [x.clone().requires_grad_() for x in (q, k, v)]
    out = fa.flash_attention(*xs, causal=True)
    out.backward(do)
    want = [out.detach()] + [x.grad for x in xs]
    with RankPool(2, str(tmp_path)) as pool:
        got = pool.run(_seq_rank_ulysses, str(dtype).split(".")[1], S, H, D)
    for r, (parts, launches, staged) in enumerate(got):
        assert launches == (1, 1, 0), launches
        assert "all_to_all" in staged
        for part, ref in zip(parts, want):
            ref = ref[:, r * S // 2:(r + 1) * S // 2].float().cpu()
            err = (torch.from_numpy(part).float() - ref).abs().max()
            judged = err if dtype == torch.float32 else err / ref.abs().max()
            assert judged <= tol, (r, judged)


def _seq_rank_train(stage, steps):
    """A seq-2 rank's fp32 tiny-llama (head dim 64) training on the card
    over gloo at ZeRO ``stage``: its losses, master and K4 launches."""
    return _seq_train({"seq": 2}, stage, steps)


def _seq_train(mesh, stage, steps, dtype_name="float32"):
    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.models import build_model
    from deepspeed_tpu_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    dtype = getattr(torch, dtype_name)
    model = build_model("tiny-llama", hidden_size=256, device="cuda",
                        dtype=dtype, param_dtype=torch.float32, seed=5)
    e, *_ = dst.initialize(model=model, device="cuda", config={
        "train_micro_batch_size_per_gpu": 2, "gradient_accumulation_steps": 1,
        "bf16": {"enabled": dtype == torch.bfloat16}, "mesh": mesh,
        "zero_optimization": {"stage": stage,
                              "stage3_param_persistence_threshold": 1000},
        "optimizer": {"type": "AdamW", "params": {"lr": 1e-3, "eps": 1e-5}}})
    g = torch.Generator().manual_seed(9)
    batch = {"input_ids": torch.randint(0, 256, (2, 256), generator=g)}
    fa.counts.reset()
    losses = [float(e.train_batch(batch)) for _ in range(steps)]

    def host(t):
        return {k: host(v) for k, v in t.items()} if isinstance(t, dict) \
            else t.cpu()

    return (losses, host(e.master),
            (fa.counts.fwd, fa.counts.bwd, fa.counts.plain))


@pytest.mark.parametrize("stage", [0, 3])
def test_seq_2_training_on_gloo_ranks_matches_one_rank(dev, stage, tmp_path):
    """Two gloo ranks sharing the card train at {"seq": 2} (ZeRO's flat
    buffers and Ulysses' exchanges staged through pinned host memory): fp32
    losses within 1e-5 relative and the master within 1e-5 of one rank at
    seq 1 on the card, K4 launched on each rank at its half of the
    heads."""
    import numpy as np

    from deepspeed_tpu_torch.comm.spawn import RankPool

    want, master, _ = _seq_train({"data": 1}, 0, 3)
    with RankPool(2, str(tmp_path)) as pool:
        got = pool.run(_seq_rank_train, stage, 3)

    def flat(t):
        return [x for v in t.values() for x in
                (flat(v) if isinstance(v, dict) else [np.asarray(v)])]

    for losses, m, (fwd, bwd, plain) in got:
        np.testing.assert_allclose(losses, want, rtol=1e-5)
        assert max(np.abs(a - b).max()
                   for a, b in zip(flat(m), flat(master))) <= 1e-5
        assert (fwd, bwd, plain) == (2 * 3, 2 * 3, 0)


def _tensor_rank_train(steps):
    """A tensor-2 rank's bf16 tiny-llama training on the card over gloo:
    its losses, master and K4 launches (at its 2 of the 4 heads)."""
    return _seq_train({"tensor": 2}, 0, steps, "bfloat16")


def test_tensor_2_training_on_gloo_ranks_matches_one_rank(dev, tmp_path):
    """Two gloo ranks sharing the card train at {"tensor": 2} in bf16 with
    an fp32 master (each rank its heads, FFN columns and vocab rows; the
    Megatron all-reduces over gloo): losses within 2e-3 relative of one
    rank at tensor 1 on the card (products over half the contraction may
    round a bf16 ulp apart), the ranks' losses equal, K4 launched on each
    rank at its own heads."""
    import numpy as np

    from deepspeed_tpu_torch.comm.spawn import RankPool

    want, _, _ = _seq_train({"data": 1}, 0, 3, "bfloat16")
    with RankPool(2, str(tmp_path)) as pool:
        got = pool.run(_tensor_rank_train, 3)
    for losses, _, (fwd, bwd, plain) in got:
        np.testing.assert_allclose(losses, want, rtol=2e-3)
        assert losses == got[0][0]
        assert (fwd, bwd, plain) == (2 * 3, 2 * 3, 0)
