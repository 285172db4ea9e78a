"""The serving pipeline through the port: the port's ``InferenceEngineV2`` on
the CPU (fp32) with dispatches that stay in flight, against the JAX
package's engine (``use_pallas_decode=False``, fp32) on the same
flax-initialised weights.

``_entry_ready`` is replaced by one that always answers False, so no
dispatch is ever ready early and the pipeline fills to ``max_inflight``
entries: step and window plans then read their previous token on the
device, through ``use_last`` and ``_last_tok``. Greedy streams must still be
identical to the JAX engine's, for ``max_inflight`` 0, 1 and 8 and decode
windows of 1 and 8, on tiny-llama and tiny-gpt2 (``test_torch_engine.py``'s
sizes), a sliding-window tiny-llama on its rolling ring, tiny-gpt2 with
``spec_decode="ngram"`` and a dropless tiny-mixtral. Besides:

- the pipeline never holds more than ``max(max_inflight, 1)`` entries after
  a step, and ``max_inflight=0`` commits each dispatch in its own step;
- ``flush(uid)`` returns the whole stream while other uids stay in flight,
  and the pool audit stays clean;
- ``warm_decode_windows()`` and ``warm_decode_step()`` leave the pool
  outside the trash block, and ``_last_tok``, as they were;
- the kernels' launches per forward are unchanged (the plain versions' on
  the CPU);
- serving leaves the MoE gating losses out on every route, training
  keeps them, and they are the JAX package's.

Models take head_dim 64 (hidden 256, 4 heads), the kernel's geometry."""
import dataclasses

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference import InferenceEngineV2 as JaxEngine
from deepspeed_tpu.models import build_model as jax_build_model
from deepspeed_tpu.moe import sharded_moe as jsm
from deepspeed_tpu.parallel.topology import MeshTopology
from deepspeed_tpu_torch.inference import InferenceEngineV2, params_from_jax
from deepspeed_tpu_torch.models import build_model, get_model_config
from deepspeed_tpu_torch.models.transformer import moe_layer_kwargs
from deepspeed_tpu_torch.moe import sharded_moe as tsm
from deepspeed_tpu_torch.moe.layer import moe_forward
from deepspeed_tpu_torch.ops import grouped_matmul as gm
from deepspeed_tpu_torch.ops import paged_attention as pa

#: model label -> (preset, model overrides, engine options)
MODELS = {
    "tiny-llama": ("tiny-llama", {}, {}),
    "tiny-gpt2": ("tiny-gpt2", {}, {}),
    "ring": ("tiny-llama", {"sliding_window": 16, "max_seq_len": 256}, {}),
    "ngram": ("tiny-gpt2", {}, {"spec_decode": "ngram", "spec_depth": 3}),
    "moe": ("tiny-mixtral", {"moe": {"dropless": True}}, {}),
}
BASE = dict(block_size=8, num_blocks=96, max_seqs=4, chunk=16,
            max_seq_len=128)
NEW_TOKENS = 10


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _prompts(label):
    rng = np.random.default_rng(0)
    if label == "ngram":
        # a repeated motif (prompt lookup proposes) and two random prompts
        motif = [int(t) for t in rng.integers(0, 256, 8)]
        return [(motif * 6)[:40], [int(t) for t in rng.integers(0, 256, 12)],
                [int(t) for t in rng.integers(0, 256, 23)]]
    lens = (45, 9, 70, 23) if label == "ring" else (40, 5, 21, 37)
    return [[int(t) for t in rng.integers(0, 256, n)] for n in lens]


def _sizes(label):
    return dict(BASE, max_seq_len=256) if label == "ring" else dict(BASE)


_SERVED: dict = {}


def _served(label):
    """(port model, exported tree, the JAX engine's streams) per model;
    spec decoding is held to the JAX engine's spec-off streams (every
    emitted token is a target sample)."""
    if label not in _SERVED:
        name, over, _ = MODELS[label]
        over = dict(over, hidden_size=256)
        jover = dict(over)
        if "moe" in over:
            # each package's own MoE options, with the same changes
            jover["moe"] = dataclasses.replace(
                jax_build_model(name).config.moe, **over["moe"])
            over["moe"] = dataclasses.replace(get_model_config(name).moe,
                                              **over["moe"])
        jm = jax_build_model(name, dtype=jnp.float32, **jover)
        params = jm.init(jax.random.PRNGKey(0),
                         jnp.zeros((1, 8), jnp.int32))["params"]
        host = jax.device_get(flax.core.meta.unbox(params))
        je = JaxEngine(jm, params=jax.tree.map(jnp.asarray, host),
                       config=dict(_sizes(label), dtype=jnp.float32,
                                   use_pallas_decode=False),
                       topology=MeshTopology({"tensor": 1, "data": 1}))
        ref = je.generate(_prompts(label), max_new_tokens=NEW_TOKENS)
        tm = build_model(name, device="cpu", dtype=torch.float32, **over)
        tree = params_from_jax(host, tm.config, dtype=torch.float32,
                               device="cpu")
        _SERVED[label] = (tm, tree, ref)
    return _SERVED[label]


def _engine(label, stalled, **over):
    tm, tree, _ = _served(label)
    eng = InferenceEngineV2(tm, params=tree, config=dict(
        _sizes(label), dtype=torch.float32, device="cpu",
        **MODELS[label][2], **over))
    if stalled:
        # no dispatch is ever ready early: the pipeline fills
        eng._entry_ready = lambda entry: False
    return eng


def _reads_of_use_last(eng) -> dict:
    """Counts the step and window plans that read an in-flight token."""
    seen = {"plan": 0, "window": 0}
    program, window_plan = eng._program, eng._window_plan

    def counted_program(plan):
        seen["plan"] += bool(plan.use_last.any())
        return program(plan)

    def counted_window_plan(*a, **kw):
        planned = window_plan(*a, **kw)
        if planned is not None:
            seen["window"] += bool(planned[1][1].any())
        return planned

    eng._program, eng._window_plan = counted_program, counted_window_plan
    return seen


def _serve(eng, prompts, new, limit):
    """Put every prompt, step until each is done, flushing each as it
    finishes; after every step the pipeline holds at most ``limit``
    entries. Returns (streams, the emitted tokens per uid, the deepest the
    pipeline got)."""
    for uid, p in enumerate(prompts):
        eng.put(uid, p, max_new_tokens=new)
    emitted = {uid: [] for uid in range(len(prompts))}
    out, deepest = {}, 0
    while len(out) < len(prompts):
        for uid, toks in eng.step().items():
            emitted[uid].extend(toks)
        depth = len(eng._inflight)
        assert depth <= limit
        deepest = max(deepest, depth)
        for uid in range(len(prompts)):
            seq = eng.state.seqs.get(uid)
            if uid in out or seq is None or not seq.done:
                continue
            inflight = len(eng._inflight)
            named = eng._uid_inflight(uid)
            out[uid] = eng.flush(uid)
            # a flush drains only dispatches that name its uid
            if not named:
                assert len(eng._inflight) == inflight
            eng.state.audit()
    assert eng.step() == {} and not eng._inflight
    return [out[u] for u in range(len(prompts))], emitted, deepest


@pytest.mark.parametrize("decode_window", [1, 8])
@pytest.mark.parametrize("max_inflight", [0, 1, 8])
@pytest.mark.parametrize("label", sorted(MODELS))
def test_inflight_streams_match_the_jax_engine(label, max_inflight,
                                               decode_window):
    tm, _, ref = _served(label)
    eng = _engine(label, stalled=True, max_inflight=max_inflight,
                  decode_window=decode_window)
    reads = _reads_of_use_last(eng)
    plain0, k5_0 = pa.counts.plain, gm.counts.plain
    got, emitted, deepest = _serve(eng, _prompts(label), NEW_TOKENS,
                                   max(max_inflight, 1))
    assert got == ref, (label, max_inflight, decode_window)
    # every token surfaced through a step() or its flush
    assert all(emitted[u] == got[u][:len(emitted[u])]
               for u in range(len(got)))
    st = eng.stats
    if max_inflight == 0:
        assert deepest == 0 and st["opportunistic_drains"] == 0
    else:
        # a stalled pipeline fills to max_inflight, as far as there are
        # dispatches (a spec round drains it first), and drains by force
        assert deepest == min(max_inflight, st["dispatches"]) or \
            label == "ngram"
        assert st["forced_drains"] > 0 and st["opportunistic_drains"] == 0
    if max_inflight > 1 and label != "ngram":
        # dispatches read tokens still in flight: windows, or step plans
        # when windowing is off
        assert reads["window" if decode_window > 1 else "plan"] > 0
    # the kernels' plain versions once per layer per forward, as before
    forwards = st["prefill_steps"] + st["decode_steps"] + \
        st["window_iters_max"]
    L = tm.config.num_layers
    assert pa.counts.plain - plain0 == L * forwards
    if label == "moe":
        assert gm.counts.plain - k5_0 == 3 * L * forwards
    if label == "ngram":
        assert st["spec_rounds"] > 0
    if label == "ring":
        assert eng._ring_tokens > 0


@pytest.mark.parametrize("label", ["tiny-llama", "ring"])
def test_pipeline_drains_like_the_synchronous_engine(label):
    """With every dispatch ready at once (the CPU's own answer) the
    pipeline commits each dispatch in the next step (opportunistic drains
    only); ``max_inflight=0`` commits it in its own step. Both give the
    JAX engine's streams."""
    _, _, ref = _served(label)
    for max_inflight in (0, 8):
        eng = _engine(label, stalled=False, max_inflight=max_inflight)
        assert eng.stats["d2h_latency_s"] == 0.0
        got, _, deepest = _serve(eng, _prompts(label), NEW_TOKENS, 1)
        assert got == ref
        assert deepest == (0 if max_inflight == 0 else 1)
        assert eng.stats["forced_drains"] == 0


def test_max_inflight_zero_commits_each_dispatch_in_its_step():
    eng = _engine("tiny-llama", stalled=True, max_inflight=0)
    prompt = _prompts("tiny-llama")[0]
    eng.put(0, prompt, max_new_tokens=NEW_TOKENS)
    seen = []
    while not eng.query(0)["done"]:
        before = eng.stats["dispatches"]
        new = eng.step().get(0, [])
        assert not eng._inflight and eng.query(0)["inflight"] == 0
        if eng.stats["dispatches"] > before and \
                len(eng.state.seqs[0].tokens) > len(prompt):
            assert new                      # this step's own tokens
        seen.extend(new)
    assert seen == _served("tiny-llama")[2][0]
    assert eng.flush(0) == seen


def test_flush_drains_only_the_dispatches_of_its_uid():
    """A request stopped mid-stream by ``flush`` returns the tokens
    committed so far (a prefix of its stream); dispatches of other uids stay
    in flight and their tokens surface in the next steps; the pool audit
    stays clean."""
    _, _, ref = _served("tiny-llama")
    eng = _engine("tiny-llama", stalled=True, max_inflight=8)
    prompts = _prompts("tiny-llama")
    for uid, p in enumerate(prompts):
        eng.put(uid, p, max_new_tokens=NEW_TOKENS)
    emitted = {uid: [] for uid in range(len(prompts))}
    while not eng._uid_inflight(1) or len(eng._inflight) < 4:
        for uid, toks in eng.step().items():
            emitted[uid].extend(toks)
    assert eng.query(1)["inflight"] > 0
    part = eng.flush(1)
    assert part == ref[1][:len(part)] and len(part) < NEW_TOKENS
    eng.state.audit()
    assert not eng._uid_inflight(1)
    while any(not eng.query(u).get("done", True) for u in (0, 2, 3)) \
            or eng._inflight:
        for uid, toks in eng.step().items():
            assert uid != 1
            emitted[uid].extend(toks)
    for uid in (0, 2, 3):
        assert eng.flush(uid) == emitted[uid] == ref[uid]
    eng.state.audit()
    assert eng.state.allocator.free_blocks + sum(
        len(s.blocks) for s in eng.state.seqs.values()) <= BASE["num_blocks"]


def test_warm_decode_windows_leaves_pool_and_last_token():
    """Mid-serve, with tokens in flight: the warm-up runs every window size
    (rem = 0) and changes nothing outside the trash block, nor
    ``_last_tok``; the streams go on to the JAX engine's."""
    _, _, ref = _served("tiny-llama")
    eng = _engine("tiny-llama", stalled=True, max_inflight=8)
    prompts = _prompts("tiny-llama")
    for uid, p in enumerate(prompts):
        eng.put(uid, p, max_new_tokens=NEW_TOKENS)
    while eng.stats["windows"] < 2:
        eng.step()
    assert eng._inflight and bool((eng._last_tok != 0).any())
    pool = eng.kv_pool.clone()
    last = eng._last_tok.clone()
    plain0 = pa.counts.plain
    eng.warm_decode_windows()
    L = eng.mcfg.num_layers
    # windows of 8, 4 and 2 iterations, every layer through K1's route
    assert pa.counts.plain - plain0 == L * (8 + 4 + 2)
    assert torch.equal(eng._last_tok, last)
    assert torch.equal(eng.kv_pool[:, :, :, 1:], pool[:, :, :, 1:])
    while any(not eng.query(u)["done"] for u in range(len(prompts))):
        eng.step()
    assert [eng.flush(u) for u in range(len(prompts))] == ref


def test_warm_decode_step_leaves_pool_and_last_token():
    """Mid-serve, with tokens in flight: the decode step program's warm-up
    (every row padding, nothing sampled) runs each layer once and changes
    nothing outside the trash block, nor ``_last_tok``; the streams go on
    to the JAX engine's."""
    _, _, ref = _served("tiny-llama")
    eng = _engine("tiny-llama", stalled=True, max_inflight=8)
    prompts = _prompts("tiny-llama")
    for uid, p in enumerate(prompts):
        eng.put(uid, p, max_new_tokens=NEW_TOKENS)
    while eng.stats["windows"] < 2:
        eng.step()
    assert eng._inflight and bool((eng._last_tok != 0).any())
    pool = eng.kv_pool.clone()
    last = eng._last_tok.clone()
    plain0 = pa.counts.plain
    eng.warm_decode_step()
    assert pa.counts.plain - plain0 == eng.mcfg.num_layers
    assert torch.equal(eng._last_tok, last)
    assert torch.equal(eng.kv_pool[:, :, :, 1:], pool[:, :, :, 1:])
    while any(not eng.query(u)["done"] for u in range(len(prompts))):
        eng.step()
    assert [eng.flush(u) for u in range(len(prompts))] == ref


@pytest.mark.parametrize("dropless", [False, True])
def test_serving_gates_without_losses(dropless):
    """``losses=False`` routes exactly as the training gate does and leaves
    the losses out; with them, aux and z losses are the JAX package's."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 12, 6)).astype(np.float32)
    t = torch.from_numpy(x)
    if dropless:
        ref = jsm.topk_dropless_gating(jnp.asarray(x), 2)
        full = tsm.topk_dropless_gating(t, 2)
        lean = tsm.topk_dropless_gating(t, 2, losses=False)
        assert torch.equal(full.gates, lean.gates)
        assert torch.equal(full.experts, lean.experts)
    else:
        ref = jsm.topkgating(jnp.asarray(x), 2, 1.0, 4)
        full = tsm.topkgating(t, 2, 1.0, 4)
        lean = tsm.topkgating(t, 2, 1.0, 4, losses=False)
        assert torch.equal(full.combine, lean.combine)
        assert torch.equal(full.dispatch, lean.dispatch)
    assert lean.aux_loss is None and lean.z_loss is None
    assert lean.exp_counts is None
    np.testing.assert_allclose(full.aux_loss.numpy(), np.asarray(ref.aux_loss),
                               rtol=1e-6)
    np.testing.assert_allclose(full.z_loss.numpy(), np.asarray(ref.z_loss),
                               rtol=1e-6)
    np.testing.assert_array_equal(full.exp_counts.numpy(),
                                  np.asarray(ref.exp_counts))


@pytest.mark.parametrize("route", ["capacity", "dropless", "int8"])
def test_serving_computes_no_gating_losses(route, monkeypatch):
    """Every MoE layer of a serving forward gates without the losses, on
    the capacity, dropless and quantized-expert routes (the streams are
    held to the JAX engine's by ``test_torch_engine_moe.py``)."""
    wanted = []
    losses = tsm._losses

    def recorded(logits, probs, onehot, n, wanted_=True):
        wanted.append(wanted_)
        return losses(logits, probs, onehot, n, wanted_)

    monkeypatch.setattr(tsm, "_losses", recorded)
    moe = dataclasses.replace(get_model_config("tiny-mixtral").moe,
                              dropless=route == "dropless")
    tm = build_model("tiny-mixtral", device="cpu", dtype=torch.float32,
                     hidden_size=256, moe=moe)
    eng = InferenceEngineV2(tm, config=dict(
        BASE, dtype=torch.float32, device="cpu",
        quant_bits=8 if route == "int8" else None))
    out = eng.generate(_prompts("tiny-llama")[:2], max_new_tokens=3)
    assert [len(s) for s in out] == [3, 3]
    assert wanted and not any(wanted)
    # training still asks for them
    wanted.clear()
    x = torch.randn(1, 4, 256)
    ml = eng.params["layer_0"]["moe"]["moe_layer"]
    if route != "int8":
        _, loss = moe_forward(x, ml, training=True,
                              **moe_layer_kwargs(tm.config))
        assert wanted == [True] and loss is not None
