"""The quantized-weight product of the port (``deepspeed_tpu_torch.ops.
quant_matmul``, K2's plain version and its quantizer) against the JAX
package's ``deepspeed_tpu/ops/pallas/quant_matmul.py``.

Same seeded inputs (numpy) on both sides:
- ``quantize_weight``: codes, scales, group size and logical shape
  bit-identical for 8, 4 and "fp8", K not a multiple of the default group
  and N padded to the lane width included;
- ``quant_matmul_reference`` against the Pallas ``quant_matmul`` in
  interpret mode (the tile kernels, ``small_m_xla=False``) and against its
  small-M route (``small_m_xla=True``, XLA's fused dequant-dot), fp32,
  within 1e-5 of max |JAX| (the two sum in different orders), unstacked and
  stacked with a layer index;
- ``params_from_jax`` carries a JAX ``QuantLinear`` across bit for bit;
- ``to_e4m3`` is JAX's e4m3 cast, NaNs included."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.pallas import quant_matmul as jq
from deepspeed_tpu_torch.inference.weights import params_from_jax
from deepspeed_tpu_torch.ops import quant_matmul as tq

BITS = [8, 4, "fp8"]
#: (K, N): default groups (512 / 128); K = 384 not a multiple of 512 (int8
#: and fp8 fall back to gcd 128); K = 96 (int4 group gcd 32) with N = 130
#: padded to 256
SHAPES = [(1024, 256), (384, 200), (96, 130)]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _weight(K, N, seed=0):
    """A weight whose quantization is not trivial: the scale differs by
    group and by column."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((K, N)).astype(np.float32)
    w *= np.exp(rng.uniform(-2, 2, (K, 1))).astype(np.float32)
    w *= np.exp(rng.uniform(-1, 1, (1, N))).astype(np.float32)
    return w


def _codes_np(data) -> np.ndarray:
    a = np.asarray(data)
    return a.view(np.uint8) if a.dtype.name == "float8_e4m3fn" else a


def _port_qw(jqw) -> tq.QuantLinear:
    return params_from_jax({"w": jqw}, device="cpu")["w"]


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("K,N", SHAPES)
def test_quantize_weight_is_bit_identical_to_jax(bits, K, N):
    w = _weight(K, N)
    ref = jq.quantize_weight(jnp.asarray(w), bits=bits)
    got = tq.quantize_weight(torch.from_numpy(w), bits=bits)
    assert got.group_size == ref.group_size
    assert got.shape == tuple(ref.shape) == (K, N)
    assert got.data.shape[-1] == -(-N // 128) * 128
    codes = got.data.view(torch.uint8) if bits == "fp8" else got.data
    np.testing.assert_array_equal(codes.numpy(), _codes_np(ref.data))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(ref.scale))
    # and the plain inverse agrees with the JAX one
    np.testing.assert_array_equal(tq.dequantize_weight(got).numpy(),
                                  np.asarray(jq.dequantize_weight(ref)))


def test_default_groups_follow_the_jax_rule():
    # llama2-7b's w_down (K = 11008): int8 takes gcd(11008, 512) = 256
    assert tq._resolve_group(11008, 8, None) == 256
    assert tq._resolve_group(11008, 4, None) == 128
    assert tq._resolve_group(4096, "fp8", None) == 512
    for K, bits in ((11008, 8), (96, 4), (384, "fp8"), (4096, 4)):
        assert tq._resolve_group(K, bits, None) == \
            jq._resolve_group(K, bits, None)
    with pytest.raises(ValueError):
        tq._resolve_group(100, 8, 64)


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("small_m_xla", [False, True])
@pytest.mark.parametrize("M", [8, 40])
def test_plain_version_matches_the_pallas_kernel(bits, small_m_xla, M):
    K, N = 384, 200
    w = _weight(K, N, seed=1)
    x = np.random.default_rng(2).standard_normal((M, K)).astype(np.float32)
    jqw = jq.quantize_weight(jnp.asarray(w), bits=bits)
    ref = np.asarray(jq.quant_matmul(jnp.asarray(x), jqw,
                                     small_m_xla=small_m_xla,
                                     interpret=True))
    got = tq.quant_matmul(torch.from_numpy(x), _port_qw(jqw)).numpy()
    assert got.shape == ref.shape == (M, N)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("small_m_xla", [False, True])
def test_stacked_layer_index_matches_the_pallas_kernel(bits, small_m_xla):
    K, N, L, li = 256, 256, 3, 2
    ws = [_weight(K, N, seed=10 + i) for i in range(L)]
    qs = [jq.quantize_weight(jnp.asarray(w), bits=bits) for w in ws]
    stacked = jq.QuantLinear(jnp.stack([q.data for q in qs]),
                             jnp.stack([q.scale for q in qs]), qs[0].bits,
                             qs[0].group_size, qs[0].shape, qs[0].dtype)
    x = np.random.default_rng(3).standard_normal((16, K)).astype(np.float32)
    ref = np.asarray(jq.quant_matmul(jnp.asarray(x), stacked,
                                     layer_index=jnp.int32(li),
                                     small_m_xla=small_m_xla,
                                     interpret=True))
    port = _port_qw(stacked)
    assert port.data.shape[0] == L
    got = tq.quant_matmul(torch.from_numpy(x), port, layer_index=li).numpy()
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())
    # the layer really selects: another layer's product differs
    other = tq.quant_matmul(torch.from_numpy(x), port, layer_index=0)
    assert np.abs(other.numpy() - ref).max() > 0.1 * np.abs(ref).max()
    with pytest.raises(ValueError, match="stacked"):
        tq.quant_matmul(torch.from_numpy(x), port)


def test_plain_version_rounds_the_weight_to_the_compute_dtype():
    """bf16 x: each dequantized element is rounded to bf16 before an fp32
    product, the algebra of the Pallas kernels and the XLA route."""
    K, N = 256, 128
    qw = tq.quantize_weight(torch.from_numpy(_weight(K, N, seed=4)), bits=8)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (4, K)).astype(np.float32)).to(torch.bfloat16)
    got = tq.quant_matmul_reference(x, qw)
    w = tq.dequantize_weight(qw).to(torch.bfloat16).float()
    want = (x.float() @ w).to(torch.bfloat16)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want)


@pytest.mark.parametrize("bits", BITS)
def test_params_from_jax_carries_quant_linear_bit_for_bit(bits):
    w = _weight(96, 130, seed=6)
    jqw = jq.quantize_weight(jnp.asarray(w), bits=bits)
    tree = {"layer_0": {"attn": {"wq": jqw}}, "embed": w[:4]}
    got = params_from_jax(tree, device="cpu", dtype=torch.bfloat16)
    qw = got["layer_0"]["attn"]["wq"]
    assert isinstance(qw, tq.QuantLinear)
    assert (qw.bits, qw.group_size, qw.shape) == (jqw.bits, jqw.group_size,
                                                 tuple(jqw.shape))
    assert qw.data.dtype == {8: torch.int8, 4: torch.uint8,
                             "fp8": torch.float8_e4m3fn}[bits]
    codes = qw.data.view(torch.uint8) if bits == "fp8" else qw.data
    np.testing.assert_array_equal(codes.numpy(), _codes_np(jqw.data))
    np.testing.assert_array_equal(qw.scale.numpy(), np.asarray(jqw.scale))
    assert qw.scale.dtype == torch.float32          # never cast
    assert got["embed"].dtype == torch.bfloat16     # dense leaves are


def test_to_e4m3_is_the_jax_cast():
    v = np.array([449, 470, 500, -600, 1e-4, 3e-3, 448, 464, 464.5, -465,
                  2.0 ** -10, 0.3, -17.5, np.inf, -np.inf, np.nan],
                 np.float32)
    v = np.concatenate([v, np.random.default_rng(7).standard_normal(
        4096).astype(np.float32) * 100])
    ref = np.asarray(jnp.asarray(v).astype(jnp.float8_e4m3fn)
                     .astype(jnp.float32))
    got = tq.to_e4m3(torch.from_numpy(v))
    assert got.dtype == torch.float8_e4m3fn
    np.testing.assert_array_equal(got.float().numpy(), ref)   # NaN == NaN
    assert np.isnan(ref[1]) and np.isnan(ref[3])              # past 464
    # torch's own cast saturates instead: the reason for the helper
    assert torch.from_numpy(v[1:2]).to(torch.float8_e4m3fn).float() == 448


@pytest.mark.parametrize("M,K,Np", [(1, 4096, 4096), (8, 11008, 4096),
                                    (16, 4096, 32000), (8, 256, 128),
                                    (5, 96, 256)])
def test_decode_form_geometry(M, K, Np):
    """The decode form's launch split: row capacity a power of two >= M,
    the x chunk within 32 KB, even K rows per block, the blocks covering K
    and the card (132 SMs) given its blocks per SM where K allows."""
    mr, kb, splits = tq.decode_form_split(M, K, Np, sms=132)
    assert mr >= M and mr & (mr - 1) == 0 and mr <= 16
    assert mr * kb * 4 <= 32 * 1024 and kb % 8 == 0
    assert (splits - 1) * kb < K <= splits * kb
    strips = Np // 128
    assert splits * strips >= min(tq.DECODE_BLOCKS_PER_SM * 132,
                                  -(-K // 8) * strips)


def test_wrapper_checks_and_counts_on_the_cpu():
    qw = tq.quantize_weight(torch.from_numpy(_weight(128, 128)), bits=4)
    x = torch.ones(3, 128)
    before = tq.counts.plain
    y = tq.quant_matmul(x, qw)
    assert y.shape == (3, 128) and tq.counts.plain == before + 1
    with pytest.raises(ValueError, match="contract"):
        tq.quant_matmul(torch.ones(3, 64), qw)
    with pytest.raises(ValueError, match="bits"):
        tq.quantize_weight(torch.ones(8, 8), bits=2)
    # local_matmul routes by weight type
    dense = torch.from_numpy(_weight(128, 16))
    assert torch.allclose(tq.local_matmul(x, dense), x @ dense)
    assert torch.equal(tq.local_matmul(x, qw), tq.quant_matmul(x, qw))
