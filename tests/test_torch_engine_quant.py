"""Quantized serving end to end: the port's ``InferenceEngineV2`` (CPU,
fp32) with ``quant_bits`` and ``kv_cache_dtype="fp8"`` against the JAX
package's engine serving the same flax-initialised weights.

- ``quant_bits`` 8 / 4 / "fp8": the engines quantize the same weights to
  bit-identical codes, and their greedy streams are identical (the JAX
  engine runs its Pallas kernels in interpret mode and its small-M XLA
  route; the port runs K2's plain version; both in fp32).
- ``kv_cache_dtype="fp8"``: a prefill chunk that attends three earlier
  chunks through the e4m3 pool gives logits within a stated tolerance of
  the JAX engine's (its Pallas kernel's e4m3 form in interpret mode); the
  fp32-pool engine, further off, is the negative control.

Models take head_dim 64 (hidden 256, 4 heads), the kernel's geometry."""
import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference import InferenceEngineV2 as JaxEngine
from deepspeed_tpu.models import build_model as jax_build_model
from deepspeed_tpu.parallel.topology import MeshTopology
from deepspeed_tpu_torch.inference import InferenceEngineV2, params_from_jax
from deepspeed_tpu_torch.models import build_model
from deepspeed_tpu_torch.ops import paged_attention as pa
from deepspeed_tpu_torch.ops import quant_matmul as qm

OVERRIDES = {"hidden_size": 256}           # 4 heads of 64
BASE = dict(block_size=8, num_blocks=96, max_seqs=4, chunk=16,
            max_seq_len=128)
NEW_TOKENS = 6


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


_MODELS: dict = {}


def _models(name):
    """(JAX model, its params, port model, the exported tree), per name."""
    if name not in _MODELS:
        jm = jax_build_model(name, dtype=jnp.float32, **OVERRIDES)
        params = jm.init(jax.random.PRNGKey(0),
                         jnp.zeros((1, 8), jnp.int32))["params"]
        host = jax.device_get(flax.core.meta.unbox(params))
        tm = build_model(name, device="cpu", dtype=torch.float32,
                         **OVERRIDES)
        tree = params_from_jax(host, tm.config, dtype=torch.float32,
                               device="cpu")
        _MODELS[name] = (jm, host, tm, tree)
    return _MODELS[name]


def _jax_engine(jm, host, **over):
    # a fresh device copy per engine: the JAX engine donates what it stacks
    return JaxEngine(jm, params=jax.tree.map(jnp.asarray, host),
                     config=dict(BASE, dtype=jnp.float32, **over),
                     topology=MeshTopology({"tensor": 1, "data": 1}))


def _prompts():
    rng = np.random.default_rng(0)
    return [[int(t) for t in rng.integers(0, 256, n)] for n in (40, 13)]


@pytest.mark.parametrize("name,bits", [("tiny-llama", 8), ("tiny-llama", 4),
                                       ("tiny-llama", "fp8"),
                                       ("tiny-gpt2", 8)])
def test_quantized_streams_match_the_jax_engine(name, bits):
    jm, host, tm, tree = _models(name)
    je = _jax_engine(jm, host, quant_bits=bits, use_pallas_decode=False)
    ref = je.generate(_prompts(), max_new_tokens=NEW_TOKENS)
    eng = InferenceEngineV2(tm, params=tree, config=dict(
        BASE, dtype=torch.float32, device="cpu", quant_bits=bits))
    # the same codes: layer 1's query projection, and the logits weight
    # (the untied unembedding, or a tied model's quantized embed.T)
    jq = je.params["layers_stacked"]["attn"]["wq"]
    got_q = eng.params["layer_1"]["attn"]["wq"]
    assert got_q.group_size == jq.group_size
    view = (lambda t: t.view(torch.uint8)) if bits == "fp8" else (lambda t: t)
    np.testing.assert_array_equal(
        view(got_q.data).numpy(),
        np.asarray(jq.data[1]).view(np.uint8) if bits == "fp8"
        else np.asarray(jq.data[1]))
    np.testing.assert_array_equal(got_q.scale.numpy(),
                                  np.asarray(jq.scale[1]))
    head = "unembed" if not tm.config.tie_embeddings else "logits_q"
    assert isinstance(eng.params[head], qm.QuantLinear)
    np.testing.assert_array_equal(eng.params[head].scale.numpy(),
                                  np.asarray(je.params[head].scale))
    plain0 = qm.counts.plain
    got = eng.generate(_prompts(), max_new_tokens=NEW_TOKENS)
    eng.state.audit()
    assert got == ref, (name, bits)
    # every product of every forward went through K2's route: per layer
    # q/k/v/o and the FFN's two or three, plus the logits
    st = eng.stats
    forwards = st["prefill_steps"] + st["decode_steps"] + \
        st["window_iters_max"]
    per_layer = 4 + (3 if tm.config.activation == "silu_glu" else 2)
    assert qm.counts.plain - plain0 == \
        (per_layer * tm.config.num_layers + 1) * forwards


def _chunk_logits(name, over, jax_over):
    """Logits of the 4th prefill chunk of a 60-token prompt (chunks of 16,
    no packing), which attends the first three through the pool, from the
    JAX engine and from the port's."""
    jm, host, tm, tree = _models(name)
    cfg = dict(BASE, prefill_pack=False)
    prompt = [int(t) for t in np.random.default_rng(9).integers(0, 256, 60)]
    je = JaxEngine(jm, params=jax.tree.map(jnp.asarray, host),
                   config=dict(cfg, dtype=jnp.float32, **jax_over),
                   topology=MeshTopology({"tensor": 1, "data": 1}))
    eng = InferenceEngineV2(tm, params=tree, config=dict(
        cfg, dtype=torch.float32, device="cpu", **over))
    je.put(1, list(prompt), max_new_tokens=4)
    eng.put(1, list(prompt), max_new_tokens=4)
    for _ in range(3):
        je._dispatch_next()
        je._drain(drain_all=True)
        eng.step()
    jp, tp = je.scheduler.next_step(), eng.scheduler.next_step()
    assert jp.kind == tp.kind == "prefill"
    assert (jp.token_ids == tp.token_ids).all() and int(jp.seq_lens[0]) == 60
    args = [jp.token_ids, jp.positions, jp.slot_map, jp.block_tables,
            jp.seq_lens, jp.sample_idx]
    _, lj = jax.jit(je._ragged_forward)(je.params, je.kv_pool,
                                        *map(jnp.asarray, args))
    dt = [torch.long, torch.long, torch.long, torch.int32, torch.int32,
          torch.long]
    lt = eng._ragged_forward(*(torch.from_numpy(np.asarray(a)).to(d)
                               for a, d in zip(args, dt)))
    return np.asarray(lj, np.float32)[0], lt[0].numpy(), eng


#: the port's fp8-pool logits against the JAX engine's: both round q and p
#: to e4m3 at the same points, so they differ by fp32 summation order
#: (measured 1.1e-6 and 1.8e-6); the fp32-pool port is 2.3e-2 to 3.1e-2 off
#: the same reference
FP8_POOL_TOL = 2e-5


@pytest.mark.parametrize("name", ["tiny-llama", "tiny-gpt2"])
def test_fp8_pool_logits_match_the_jax_engine(name):
    a, b, eng = _chunk_logits(name, {"kv_cache_dtype": "fp8"},
                              {"kv_cache_dtype": "fp8"})
    assert eng.kv_pool.dtype == torch.float8_e4m3fn
    assert eng._attn_decode_sel.path == "plain"     # K1's route
    assert np.abs(a - b).max() <= FP8_POOL_TOL
    # negative control: the fp32 pool is not what the JAX fp8 engine serves
    a, c, _ = _chunk_logits(name, {}, {"kv_cache_dtype": "fp8"})
    assert np.abs(a - c).max() > 100 * FP8_POOL_TOL


def test_int8_weights_and_fp8_pool_serve_together():
    jm, host, tm, tree = _models("tiny-llama")
    eng = InferenceEngineV2(tm, params=tree, config=dict(
        BASE, dtype=torch.float32, device="cpu", quant_bits=8,
        kv_cache_dtype="fp8"))
    assert eng.kv_pool.dtype == torch.float8_e4m3fn
    q0, p0 = qm.counts.plain, pa.counts.plain
    out = eng.generate(_prompts(), max_new_tokens=NEW_TOKENS)
    eng.state.audit()
    assert [len(o) for o in out] == [NEW_TOKENS] * 2
    assert all(0 <= t < 256 for o in out for t in o)
    st = eng.stats
    forwards = st["prefill_steps"] + st["decode_steps"] + \
        st["window_iters_max"]
    L = tm.config.num_layers
    assert qm.counts.plain - q0 == (7 * L + 1) * forwards
    assert pa.counts.plain - p0 == L * forwards
    # the pool holds what to_e4m3 wrote: finite e4m3 values
    assert torch.isfinite(eng.kv_pool.float()).all()


def test_fp8_pool_merge_is_the_jax_cast():
    """The pool merge writes through the JAX package's e4m3 cast: values
    past e4m3's range land as NaN (torch's own cast would store ±448)."""
    _, _, tm, tree = _models("tiny-llama")
    eng = InferenceEngineV2(tm, params=tree, config=dict(
        BASE, dtype=torch.float32, device="cpu", kv_cache_dtype="fp8"))
    L, KV, D = tm.config.num_layers, tm.config.kv_heads, tm.config.head_dim
    ks = torch.full((L, 2, KV, D), 0.3)
    ks[0, 0, 0, :3] = torch.tensor([470.0, -600.0, 449.0])
    eng._merge_stage(torch.tensor([8, 9]), ks, ks + 1)
    k = eng.kv_pool[0, 0, 0, 1, 0, :3].float()
    assert torch.isnan(k[:2]).all() and k[2].item() == 448.0
    assert eng.kv_pool[0, 1, 0, 1, 1, 0].float().item() == \
        torch.tensor(1.3).to(torch.float8_e4m3fn).float().item()
