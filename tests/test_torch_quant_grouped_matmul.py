"""The grouped half of the port's quantized product (``deepspeed_tpu_torch.
ops.quant_matmul``: ``QuantGrouped``, ``quantize_grouped``,
``dequantize_grouped`` and K3's plain version) against the JAX package's
``deepspeed_tpu/ops/pallas/quant_matmul.py``, whose Pallas
``quant_grouped_matmul`` runs in interpret mode on the CPU.

Same seeded inputs (numpy) on both sides:
- ``quantize_grouped``: codes, scales, group size and logical shape
  bit-identical for 8, 4 and "fp8", with N padded to the lane width and K
  off the default group;
- ``quant_grouped_matmul_reference`` against the Pallas kernel, fp32,
  unstacked and stacked at a non-zero layer, within 1e-5 of max |JAX|
  (both dequantize to the same fp32 weights and sum exact products in
  different orders; the Pallas int4 form splits x into even and odd
  columns);
- ``params_from_jax`` carries a JAX ``QuantGrouped`` across bit for bit."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.pallas import grouped_matmul as jg
from deepspeed_tpu.ops.pallas import quant_matmul as jq
from deepspeed_tpu_torch.inference.weights import params_from_jax
from deepspeed_tpu_torch.ops import quant_matmul as tq

BITS = [8, 4, "fp8"]
#: (experts n, K, N): default groups; K = 384 (int8/fp8 group gcd 128);
#: K = 96 (int4 group gcd 32) with N = 130 padded to 256
SHAPES = [(4, 1024, 256), (3, 384, 200), (5, 96, 130)]
TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _weights(n, K, N, seed=0):
    """Stacked expert weights whose quantization is not trivial: scales
    differ by expert, K-group and column."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((n, K, N)).astype(np.float32)
    w *= np.exp(rng.uniform(-2, 2, (n, K, 1))).astype(np.float32)
    w *= np.exp(rng.uniform(-1, 1, (n, 1, N))).astype(np.float32)
    return w


def _codes_np(data) -> np.ndarray:
    a = np.asarray(data)
    return a.view(np.uint8) if a.dtype.name == "float8_e4m3fn" else a


def _port(jqw) -> tq.QuantGrouped:
    return params_from_jax({"w": jqw}, device="cpu")["w"]


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("n,K,N", SHAPES)
def test_quantize_grouped_is_bit_identical_to_jax(bits, n, K, N):
    w = _weights(n, K, N)
    ref = jq.quantize_grouped(jnp.asarray(w), bits=bits)
    got = tq.quantize_grouped(torch.from_numpy(w), bits=bits)
    assert got.group_size == ref.group_size
    assert got.shape == tuple(ref.shape) == (n, K, N)
    assert got.data.shape[-1] == -(-N // 128) * 128
    codes = got.data.view(torch.uint8) if bits == "fp8" else got.data
    np.testing.assert_array_equal(codes.numpy(), _codes_np(ref.data))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(ref.scale))
    np.testing.assert_array_equal(tq.dequantize_grouped(got).numpy(),
                                  np.asarray(jq.dequantize_grouped(ref)))


@pytest.mark.parametrize("bits", BITS)
def test_params_from_jax_carries_quant_grouped_bit_for_bit(bits):
    ref = jq.quantize_grouped(jnp.asarray(_weights(3, 256, 64)), bits=bits)
    got = _port(ref)
    assert isinstance(got, tq.QuantGrouped)
    assert (got.bits, got.group_size, got.shape) == \
        (ref.bits, ref.group_size, tuple(ref.shape))
    assert got.dtype == torch.float32
    codes = got.data.view(torch.uint8) if bits == "fp8" else got.data
    np.testing.assert_array_equal(codes.numpy(), _codes_np(ref.data))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(ref.scale))
    assert got.nbytes == ref.nbytes


def _routed(n, K, T, k, bm, seed):
    """(expert-sorted buffer [Tp, K], JAX tile→expert map, the port's
    sort) from a seeded routing of T tokens to k experts each."""
    rng = np.random.default_rng(seed)
    eidx = rng.integers(0, n, (T, k)).astype(np.int32)
    x = rng.standard_normal((T, K)).astype(np.float32)
    srt = jg.sort_tokens_by_expert(jnp.asarray(eidx), n, bm)
    buf = np.zeros((srt.Tp, K), np.float32)
    buf[np.asarray(srt.dst)] = np.repeat(x, k, axis=0)
    from deepspeed_tpu_torch.ops.grouped_matmul import sort_tokens_by_expert
    return buf, np.array(srt.tile_expert), sort_tokens_by_expert(
        torch.from_numpy(eidx), n, bm)


def _max_err(got, ref):
    ref = np.asarray(ref, np.float32)
    return np.abs(got.numpy() - ref).max() / np.abs(ref).max()


@pytest.mark.parametrize("bm", [32, 8])
@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("n,K,N", SHAPES)
def test_plain_version_matches_the_pallas_kernel(bits, n, K, N, bm):
    w = _weights(n, K, N, seed=1)
    jqw = jq.quantize_grouped(jnp.asarray(w), bits=bits)
    buf, te, srt = _routed(n, K, 21, 2, bm, seed=2)
    ref = jq.quant_grouped_matmul(jnp.asarray(buf), jqw, jnp.asarray(te),
                                  block_m=bm)
    before = tq.grouped_counts.plain
    got = tq.quant_grouped_matmul(torch.from_numpy(buf), _port(jqw),
                                  torch.from_numpy(te), block_m=bm)
    assert tq.grouped_counts.plain == before + 1
    assert tuple(got.shape) == (buf.shape[0], N)
    assert _max_err(got, ref) <= TOL
    # the sort's routed-row counts leave the result as it is
    limited = tq.quant_grouped_matmul(torch.from_numpy(buf), _port(jqw),
                                      srt.tile_expert, block_m=bm,
                                      tile_rows=srt.tile_rows)
    assert torch.equal(limited, got)


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("layer", [1, 2])
def test_stacked_codes_select_the_layer(bits, layer):
    n, K, N, L, bm = 3, 256, 128, 3, 32
    per = [jq.quantize_grouped(jnp.asarray(_weights(n, K, N, seed=10 + i)),
                               bits=bits) for i in range(L)]
    jst = jq.QuantGrouped(jnp.stack([q.data for q in per]),
                          jnp.stack([q.scale for q in per]), per[0].bits,
                          per[0].group_size, per[0].shape, per[0].dtype)
    buf, te, _ = _routed(n, K, 13, 2, bm, seed=3)
    ref = jq.quant_grouped_matmul(jnp.asarray(buf), jst, jnp.asarray(te),
                                  layer_index=jnp.int32(layer), block_m=bm)
    st = _port(jst)
    assert st.data.dim() == 4
    got = tq.quant_grouped_matmul(torch.from_numpy(buf), st,
                                  torch.from_numpy(te), layer_index=layer,
                                  block_m=bm)
    assert _max_err(got, ref) <= TOL
    one = tq.quant_grouped_matmul(torch.from_numpy(buf), _port(per[layer]),
                                  torch.from_numpy(te), block_m=bm)
    assert torch.equal(got, one)
    with pytest.raises(ValueError, match="layer_index"):
        tq.quant_grouped_matmul(torch.from_numpy(buf), st,
                                torch.from_numpy(te), block_m=bm)
    with pytest.raises(ValueError, match="outside"):
        tq.quant_grouped_matmul(torch.from_numpy(buf), st,
                                torch.from_numpy(te), layer_index=L,
                                block_m=bm)
