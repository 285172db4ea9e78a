"""Tensor-parallel serving: the port's ``InferenceEngineV2`` at
``tensor_parallel`` 2 and 4 on gloo ranks (``comm.spawn.RankPool``), fp32
on the CPU.

Against the JAX engine on its CPU mesh at the same ``tensor_parallel``,
serving the same flax-initialised weights (each rank slices the whole tree
it is given), with identical greedy streams:

- a dense GQA model with ``tp_overlap=True`` over odd-row packed plans
  (3 and 1 pending prompts at tp 2: rows padded to the ring degree), where
  every program rings (``tp_fallbacks == 0``) — the JAX package's
  ``test_engine_v2_odd_row_packed_prefill_rings_tp2``;
- an int8 MoE model with a shared expert (per-shard K2 and K3),
  ``tp_overlap=False``;
- a GQA sliding-window model on its rolling ring at tp 4 (two query heads
  and one KV head a rank), ``tp_overlap=False``.

The other cases hold the port's TP engine to its own TP-1 engine on the
same seeded weights (earlier tests hold that one to the JAX engine): each
rank draws its slices from a meta model. They cover ``tp_overlap`` False /
auto / True at tp 2 and True at tp 4, int4 weights (fp8 weights: against
the TP-1 engine serving, unquantized, the weights the TP engine's
per-shard codes dequantize to), the int8 MoE with the ring on (the
experts' grouped ring), the e4m3 pool,
the dropless MoE route (the JAX engine at tp 2 runs its grouped product
per shard on the CPU too), tied embeddings with learned positions and
biases, and ALiBi. Every rank's streams and ring counters are equal, and
a quantized ring's K2 / K3 calls are the blocking path's plus the local
products its rings made beyond it.

Last, the refusals: what this slice leaves out raises NotImplementedError
naming ROADMAP item 6a (6b for the training engine)."""
import dataclasses

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.comm.spawn import RankPool
from deepspeed_tpu_torch.models import get_model_config

pytestmark = pytest.mark.multiprocess

BASE = dict(block_size=16, num_blocks=64, max_seqs=4, chunk=16,
            max_seq_len=128, decode_window=4)
NEW = 6
SEED = 5
#: head_dim 64, the paged-attention kernel's geometry
DENSE = ("tiny-llama", {"hidden_size": 256})
MOE = ("tiny-qwen2-moe", {"hidden_size": 256})
#: 8 query heads of 64 over 4 KV heads, a 24-token window
WINDOW = ("tiny-llama", {"hidden_size": 512, "num_heads": 8,
                         "num_kv_heads": 4, "sliding_window": 24})
RING_KEYS = ("tp_ring_matmuls", "tp_ring_steps", "tp_bytes_permuted",
             "tp_fallbacks")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def pools(tmp_path_factory):
    made = {n: RankPool(n, str(tmp_path_factory.mktemp(f"engine_tp{n}")))
            for n in (2, 4)}
    yield made
    for p in made.values():
        p.close()


def _prompts(vocab, lens, seed):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(1, vocab, n)] for n in lens]


#: 3 pending prompts, then 1: odd-row packed plans at tp 2
ODD = [_prompts(256, (40, 13, 29), 0), _prompts(256, (21,), 1)]


# --- run on every rank ----------------------------------------------------

def _shard_dequantized(model, bits, n):
    """Replace the weights ``quant_bits`` quantizes (attention and dense
    FFN products, routed experts, the unembedding) by their codes quantized
    shard by shard at n ranks, as the TP engine quantizes them, and
    dequantized: a dense model whose forward is the quantized TP
    engine's."""
    from deepspeed_tpu_torch.inference.weights import module_param_tree
    from deepspeed_tpu_torch.ops.quant_matmul import (
        dequantize_grouped, dequantize_weight, quantize_grouped,
        quantize_weight)
    from deepspeed_tpu_torch.runtime.zero.planner import (tensor_plan,
                                                          tensor_shard)

    tree = module_param_tree(model)
    products = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
    with torch.no_grad():
        for path, (spec, _) in tensor_plan(tree, {"tensor": n}).items():
            if not ((path[-1] in products and ({"attn", "ffn", "experts"}
                                               & set(path)))
                    or path == ("unembed",)):
                continue
            w = tree
            for k in path:
                w = w[k]
            parts = []
            for r in range(n):
                sh = tensor_shard(w, spec, r, n).float()
                if "experts" in path:
                    parts.append(dequantize_grouped(quantize_grouped(
                        sh, bits=bits, shard=True)))
                    continue
                K = sh.shape[0] * (sh.shape[1] if path[-1] == "wo" else 1)
                parts.append(dequantize_weight(quantize_weight(
                    sh.reshape(K, -1), bits=bits, shard=True)
                ).reshape(sh.shape))
            w.copy_(torch.cat(parts, dim=spec.index("tensor"))
                    if "tensor" in spec else parts[0])


def _serve(n, name, over, cfg, prompt_sets, params=None, dequant=None):
    """Greedy streams of an engine at ``tensor_parallel`` n (n = 1: this
    process), its ring counters, its scheduler's plan menu and ring
    degree, and its calls of K2 and K3 (their plain versions here) with
    its forwards and its rings' products. ``dequant`` = (bits, ranks):
    serve the model with its weights shard-dequantized
    (:func:`_shard_dequantized`)."""
    from deepspeed_tpu_torch.inference import (InferenceEngineV2,
                                               params_from_jax)
    from deepspeed_tpu_torch.models import build_model
    from deepspeed_tpu_torch.ops.quant_matmul import counts, grouped_counts
    from deepspeed_tpu_torch.parallel.tensor import overlap_counters
    from deepspeed_tpu_torch.parallel.topology import MeshTopology

    tree = None
    device = "meta" if n > 1 else "cpu"
    if params is not None:
        device = "meta"
        tree = params_from_jax(params, dtype=torch.float32, device="cpu")
    model = build_model(name, device=device, dtype=torch.float32, seed=SEED,
                        **over)
    if dequant is not None:
        _shard_dequantized(model, *dequant)
    eng = InferenceEngineV2(
        model, tree, config=dict(BASE, dtype=torch.float32, device="cpu",
                                 **cfg),
        topology=MeshTopology({"tensor": n}) if n > 1 else None)
    counts.reset()
    grouped_counts.reset()
    overlap_counters.reset()
    streams = [eng.generate(p, max_new_tokens=NEW) for p in prompt_sets]
    eng.state.audit()
    st = eng.stats
    calls = dict(k2=counts.plain, k3=grouped_counts.plain,
                 forwards=st["prefill_steps"] + st["decode_steps"]
                 + st["window_iters_max"],
                 products=overlap_counters.products_snapshot())
    return (streams, {k: st[k] for k in RING_KEYS},
            eng.scheduler.program_shape_menu(), eng.scheduler.row_multiple,
            calls)


def _ranks(pools, n, *args):
    outs = pools[n].run(_serve, n, *args)
    for o in outs[1:]:
        assert o[0] == outs[0][0] and o[1] == outs[0][1] \
            and o[4] == outs[0][4], "ranks disagree"
    return outs[0]


# --- against the JAX engine ------------------------------------------------

def _jax(n, name, over, cfg, prompt_sets):
    """(JAX engine streams at tensor_parallel n, its host params)."""
    import flax
    import jax
    import jax.numpy as jnp

    from deepspeed_tpu.inference import InferenceEngineV2 as JaxEngine
    from deepspeed_tpu.models import build_model as jax_build_model
    from deepspeed_tpu.parallel.topology import MeshConfig, MeshTopology

    jm = jax_build_model(name, dtype=jnp.float32, **over)
    params = jm.init(jax.random.PRNGKey(0),
                     jnp.zeros((1, 8), jnp.int32))["params"]
    host = jax.device_get(flax.core.meta.unbox(params))
    je = JaxEngine(jm, params=jax.tree.map(jnp.asarray, host),
                   config=dict(BASE, dtype=jnp.float32,
                               use_pallas_decode=False, **cfg),
                   topology=MeshTopology(MeshConfig(tensor=n, data=1)))
    streams = [je.generate(p, max_new_tokens=NEW) for p in prompt_sets]
    return streams, host, dict(je.stats)


def test_odd_row_packed_plans_ring_like_the_jax_engine(pools):
    cfg = dict(tp_overlap=True)
    want, host, jstats = _jax(2, *DENSE, cfg, ODD)
    got, ring, menu, row_multiple, _ = _ranks(pools, 2, *DENSE, cfg, ODD,
                                              host)
    assert got == want
    assert row_multiple == 2 and all(rows % 2 == 0 for _, rows in menu)
    assert ring["tp_ring_matmuls"] > 0 and ring["tp_ring_steps"] > 0
    assert ring["tp_bytes_permuted"] > 0
    assert ring["tp_fallbacks"] == 0 == jstats["tp_fallbacks"], ring


def test_int8_moe_with_shared_expert_matches_the_jax_engine(pools):
    """Per-shard int8 codes (bit for bit the JAX engine's, so the products
    agree) and K3 per shard, blocking: on this model the JAX engine's
    quantized ring raises (``matmul_reduce_scatter``: "contract mismatch:
    x K=256 vs w K=512"), so the port's quantized rings, the experts'
    grouped ring included, are held to its TP-1 engine below."""
    cfg = dict(quant_bits=8, tp_overlap=False)
    prompts = [_prompts(256, (40, 13, 29, 33), 2)]
    want, host, _ = _jax(2, *MOE, cfg, prompts)
    got, ring, *_ = _ranks(pools, 2, *MOE, cfg, prompts, host)
    assert got == want
    assert ring == {k: 0 for k in RING_KEYS}


def test_gqa_window_at_tp4_matches_the_jax_engine(pools):
    prompts = [_prompts(256, (60, 37, 9), 3)]
    cfg = dict(tp_overlap=False)
    want, host, _ = _jax(4, *WINDOW, cfg, prompts)
    got, ring, *_ = _ranks(pools, 4, *WINDOW, cfg, prompts, host)
    assert got == want
    assert ring == {k: 0 for k in RING_KEYS}


# --- against the port's own TP-1 engine -----------------------------------

SELF_CASES = {
    "dense-off": (2, DENSE, dict(tp_overlap=False)),
    "dense-auto": (2, DENSE, dict(tp_overlap_min_rows=16)),
    "dense-forced": (2, DENSE, dict(tp_overlap=True)),
    "dense-forced-tp4": (4, ("tiny-llama", WINDOW[1] | {
        "sliding_window": None}), dict(tp_overlap=True)),
    "int4-forced": (2, DENSE, dict(quant_bits=4, tp_overlap=True)),
    "int8-moe-auto": (2, MOE, dict(quant_bits=8, tp_overlap_min_rows=16)),
    "fp8-forced": (2, DENSE, dict(quant_bits="fp8", tp_overlap=True)),
    "e4m3-pool": (2, DENSE, dict(kv_cache_dtype="fp8")),
    "moe-dropless": (2, ("tiny-mixtral", {
        "hidden_size": 256, "moe": dataclasses.replace(
            get_model_config("tiny-mixtral").moe, dropless=True,
            dropless_block_m=32)}), dict(tp_overlap=True)),
    "tied-gelu-forced": (2, ("tiny-gpt2", {"hidden_size": 256}),
                         dict(tp_overlap=True)),
    "alibi": (2, ("tiny-bloom", {"hidden_size": 256}), {}),
}


@pytest.mark.parametrize("case", sorted(SELF_CASES))
def test_tp_streams_equal_the_tp1_engine(pools, case):
    n, (name, over), cfg = SELF_CASES[case]
    one = {k: v for k, v in cfg.items()
           if k not in ("tp_overlap", "tp_overlap_min_rows")}
    bits = cfg.get("quant_bits")
    if bits == "fp8":
        # e4m3 codes move with the last bit of their scale, which per-shard
        # quantization computes as the JAX engine's jitted shard_map does
        # (a product with the reciprocal, not the TP-1 division): the
        # reference serves unquantized the weights the shards' codes
        # dequantize to
        one.pop("quant_bits")
        want, *_, calls1 = _serve(1, name, over, one, ODD,
                                  dequant=(bits, n))
    else:
        want, *_, calls1 = _serve(1, name, over, one, ODD)
    got, ring, *_, calls = _ranks(pools, n, name, over, cfg, ODD)
    assert got == want
    if "quant_bits" in one:
        # K2 / K3 calls a forward as the TP-1 engine's, plus the ring's
        # local products beyond the blocking path's
        for k in ("k2", "k3"):
            made, blocking = calls["products"].get(k, (0, 0))
            assert (calls[k] - made + blocking) * calls1["forwards"] \
                == calls1[k] * calls["forwards"], (k, calls, calls1)
        assert calls["products"].get("k2", (0, 0))[0] > 0, calls
    # the auto gate's 64-row chunk minimum keeps these small programs on
    # the blocking path, each counted a fallback
    rings = cfg.get("tp_overlap") is True or "tp_overlap_min_rows" in cfg
    assert (ring["tp_ring_matmuls"] > 0) == rings, ring
    if cfg.get("tp_overlap") is None:
        assert ring["tp_fallbacks"] > 0
    elif cfg.get("tp_overlap") is True and "moe" not in over:
        assert ring["tp_fallbacks"] == 0, ring


# --- refusals -------------------------------------------------------------

def _refusals(n):
    """The message of each configuration the slice leaves out, on a rank."""
    from deepspeed_tpu_torch.inference import InferenceEngineV2
    from deepspeed_tpu_torch.models import build_model
    from deepspeed_tpu_torch.parallel.topology import MeshTopology

    topo = MeshTopology({"tensor": n})
    out = {}

    def engine(name="tiny-llama", **cfg):
        return InferenceEngineV2(
            build_model(name, device="meta", dtype=torch.float32),
            config=dict(BASE, dtype=torch.float32, device="cpu", **cfg),
            topology=topo)

    def why(fn):
        try:
            fn()
        except (NotImplementedError, ValueError) as e:
            return f"{type(e).__name__}: {e}"
        return ""

    out["spec"] = why(lambda: engine(spec_decode="ngram"))
    out["spec-forced"] = why(lambda: engine(spec_decode="ngram",
                                            tp_overlap=True))
    out["kv_tier"] = why(lambda: engine(kv_tier=True))
    out["heads"] = why(lambda: engine("tiny-falcon"))
    eng = engine()
    out["export"] = why(lambda: eng.export_migration(0))
    out["prefix"] = why(lambda: eng.export_prefix([1, 2, 3]))
    out["swap"] = why(lambda: eng.swap_weights("/nonexistent"))
    out["save"] = why(lambda: eng.save_weights("/nonexistent"))
    return out


def test_what_the_slice_leaves_out_refuses(pools):
    got = pools[2].run(_refusals, 2)[0]
    for key in ("spec", "kv_tier", "heads", "export", "prefix", "swap",
                "save"):
        assert got[key].startswith("NotImplementedError"), (key, got[key])
        assert "item 6a" in got[key], (key, got[key])
    assert got["spec-forced"].startswith("ValueError: spec_decode cannot "
                                         "combine with tp_overlap=True")


def test_refusals_without_ranks():
    """One process: tp_overlap=True needs a ring (the JAX engine's
    ValueError), a serving replica refuses tensor parallelism (item 6a),
    and the training engine still refuses a MoE model at tensor > 1 (item
    6b part 3; dense models train there)."""
    from deepspeed_tpu_torch import initialize
    from deepspeed_tpu_torch.inference import InferenceEngineV2
    from deepspeed_tpu_torch.models import build_model
    from deepspeed_tpu_torch.serving.replica import EngineBackend

    model = build_model("tiny-llama", device="cpu", dtype=torch.float32)
    with pytest.raises(ValueError, match="geometry can't ring"):
        InferenceEngineV2(model, config=dict(BASE, device="cpu",
                                             dtype=torch.float32,
                                             tp_overlap=True))
    with pytest.raises(NotImplementedError, match="item 6a"):
        EngineBackend({"model": "tiny-llama", "device": "cpu",
                       "engine": {"tensor_parallel": 2}})
    with pytest.raises(NotImplementedError, match="item 6b part 3"):
        initialize(model=build_model("tiny-mixtral", device="cpu",
                                     dtype=torch.float32),
                   config={"train_batch_size": 2, "mesh": {"tensor": 2}},
                   device="cpu")
