"""The port on the card: the paged-attention CUDA kernel (default and
e4m3-pool forms) and the quantized-weight kernel against their plain
versions, and the CUDA engine against the CPU engine. These need an sm_90
GPU and nvcc, so they skip elsewhere; on a machine with the card run

    python -m pytest tests/test_torch_cuda.py -m cuda
"""
import pytest
import torch

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


def test_kernel_refuses_options_of_later_slices(dev):
    args = _case(dev, torch.float32, H=4, KV=2, D=64, T=1, Ts=8, ctx=[20])
    with pytest.raises(NotImplementedError, match="window"):
        pa.paged_ragged_attention(*args, block_size=16, layer_index=0,
                                  window=8)


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
