"""The port on the card: the paged-attention CUDA kernel (default,
e4m3-pool, sliding-window, rolling-ring and tree-verify forms), the
quantized-weight kernel, the grouped MoE kernels
(K5's forward, K3) and the flash-attention kernel (K4, forward and
backward) against their plain versions, the CUDA serving engine against the
CPU engine, and a training step on the card through K4. These need an sm_90
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
    monkeypatch.setattr(gm, "tiled_reference", None)
    monkeypatch.setattr(qm, "quant_grouped_matmul_reference", None)
    buf, srt = _routed(dev, torch.bfloat16, T=8, k=2, n=4, K=128, bm=32,
                       seed=3)
    w = torch.randn(4, 128, 64, device=dev, dtype=torch.bfloat16)
    assert gm.grouped_matmul(buf, w, srt.tile_expert, 32).shape == \
        (srt.Tp, 64)
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [64, 128, 256])
@pytest.mark.parametrize("G", [1, 4])
@pytest.mark.parametrize("S,causal", [(128, True), (200, True), (384, True),
                                      (200, False)])
def test_flash_kernel_matches_plain_version(dev, dtype, D, G, S, causal):
    from deepspeed_tpu_torch.ops import flash_attention as fa

    q, k, v, do = _flash_inputs(dev, dtype, 2, 2 * G, 2, S, D)
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
