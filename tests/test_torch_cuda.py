"""The port on the card: the paged-attention CUDA kernel (default,
e4m3-pool, sliding-window, rolling-ring and tree-verify forms), the
quantized-weight kernel, the grouped MoE kernels (K5's forward, dx and
dw; K3), the flash-attention kernel (K4, forward and backward; its bf16
kernels also at the tensor-core tiles' edges, and their backward bit for
bit from call to call), the block-sparse flash kernels (K6: forward, dq,
dk/dv) and the per-layer-slice paged attention (K7: linear, window and
ring tables) against their plain versions, the CUDA serving engine against
the CPU engine, and training steps on the card through K4 and through K5's
forward and backward. These need an sm_90
GPU and nvcc, so they skip elsewhere; on a machine with the card run

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
    p rounded against the kernel's 64-key walk); each form is counted."""
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
    ref = pa.paged_ragged_attention_reference(
        *args, block_size=16, layer_index=1,
        p_round_blocks=(pa.KERNEL_KEY_TILE, pa.KERNEL_KEY_TILE), **kw)
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
    kernel's 64-key walk; judged as chip_smoke.py judges it (max over max
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
    ref = pa.paged_ragged_attention_reference(
        *args, block_size=16, layer_index=1,
        p_round_blocks=(pa.KERNEL_KEY_TILE, pa.KERNEL_KEY_TILE))
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
                                            (408, 136, True),
                                            (576, 192, False),
                                            (768, 256, True)])
def test_block_sparse_kernels_match_plain_versions(dev, dtype, D, S, block,
                                                   causal):
    """K6's forward (out, lse), dq and dk/dv kernels, each against its plain
    version by ``K4_TOL``; the empty row and the row visible only above the
    diagonal (causal) give zeros and no gradient."""
    from deepspeed_tpu_torch.ops import block_sparse_attention as bsa

    (q, k, v, do), tables = _k6_case(dev, dtype, 2, 2, S, D, block)
    scale = D ** -0.5
    bsa.counts.reset()
    out, lse = bsa.block_sparse_fwd(q, k, v, tables, block, causal, scale)
    torch.cuda.synchronize()
    assert (bsa.counts.fwd, bsa.counts.plain) == (1, 0)
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
        assert vars(bsa.counts) == {"fwd": 1, "bwd": 1, "plain": 0,
                                    "plain_bwd": 0}
        assert all(torch.isfinite(t.grad.float()).all() for t in (q, k, v))
    bsa.counts.reset()
    SparseSelfAttention(BigBirdSparsityConfig(num_heads=4, block=64))(
        mk(), mk(), mk())
    assert vars(bsa.counts) == {"fwd": 0, "bwd": 0, "plain": 0,
                                "plain_bwd": 0}
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
        "kernel_ring": int("ring_tokens" in kw), "plain": 0}
    ref = pa.paged_prefill_attention_reference(q, kp, vp, tables, lens,
                                               starts, **kw)
    err = (got.float() - ref.float()).abs().max().item()
    if dtype == torch.bfloat16:
        err /= ref.float().abs().max().item()
    assert torch.isfinite(got.float()).all() and err <= tol, err
    if form == "linear":
        assert not got[1].any()
