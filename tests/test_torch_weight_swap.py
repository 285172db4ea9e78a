"""Live weight swap, ported: the engine's ``save_weights`` /
``swap_weights`` (tiny-llama, fp32, on the CPU).

A swap copies a verified, staged tree into the live tensors in place, so
every tensor keeps its address (the card's captured graphs replay the new
weights); each refusal (``integrity``, ``shape_mismatch``,
``no_checkpoint``, ``probe_failed``) leaves the old tensors, values and
version serving. A swap flushes the prefix cache's unpinned pages and
invalidates the KV tier's records; bundles carry the weight version, and
an engine on other weights — the port's or the JAX package's — refuses
them."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference import InferenceEngineV2 as JaxEngine
from deepspeed_tpu.inference import migration as jmig
from deepspeed_tpu.models import build_model as jax_build_model
from deepspeed_tpu.parallel.topology import MeshTopology
from deepspeed_tpu_torch.checkpoint.manifest import manifest_digest
from deepspeed_tpu_torch.inference import InferenceEngineV2
from deepspeed_tpu_torch.inference.engine_v2 import WeightSwapError
from deepspeed_tpu_torch.inference.migration import MigrationError
from deepspeed_tpu_torch.inference.weights import (load_param_tree,
                                                   save_param_tree,
                                                   tree_tensors)
from deepspeed_tpu_torch.models import build_model
from deepspeed_tpu_torch.ops import quant_matmul as qm

BASE = dict(block_size=8, num_blocks=64, max_seqs=4, chunk=8,
            max_seq_len=128, decode_window=2, dtype=torch.float32,
            device="cpu")
PROMPTS = [[int(t) for t in np.random.default_rng(s).integers(0, 256, n)]
           for s, n in ((1, 21), (2, 30), (3, 9))]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def engine(seed=0, layers=None, **over):
    kw = {"hidden_size": 256} | ({"num_layers": layers} if layers else {})
    m = build_model("tiny-llama", device="cpu", dtype=torch.float32,
                    seed=seed, **kw)
    return InferenceEngineV2(m, config=dict(BASE, **over))


def serve(eng, prompts, new=8, uid0=0):
    return eng.generate(prompts, max_new_tokens=new) if uid0 == 0 else [
        _one(eng, uid0 + i, p, new) for i, p in enumerate(prompts)]


def _one(eng, uid, prompt, new):
    eng.put(uid, prompt, max_new_tokens=new)
    while not eng.query(uid)["done"]:
        eng.step()
    return eng.flush(uid)


def snapshot(eng):
    ts = tree_tensors(eng.params)
    return [t.data_ptr() for t in ts], [t.clone() for t in ts]


def same_tensors(eng, snap) -> bool:
    ptrs, vals = snap
    ts = tree_tensors(eng.params)
    return [t.data_ptr() for t in ts] == ptrs and all(
        torch.equal(t.view(torch.uint8) if t.dtype == torch.float8_e4m3fn
                    else t, v.view(torch.uint8)
                    if v.dtype == torch.float8_e4m3fn else v)
        for t, v in zip(ts, vals))


@pytest.mark.parametrize("quant", [None, 8, "fp8"])
def test_save_then_swap_round_trip(tmp_path, quant):
    eng = engine(quant_bits=quant)
    want = serve(eng, PROMPTS)
    path = eng.save_weights(str(tmp_path))
    assert os.path.basename(path) == "weights_v1"
    for f in ("state/index.json", "meta.json", "manifest.json"):
        assert os.path.exists(os.path.join(path, f)), f
    assert open(tmp_path / "latest").read() == "weights_v1"
    if quant:      # codes and scales kept as they are
        leaf = eng.params["layer_0"]["attn"]["wq"]
        assert isinstance(leaf, qm.QuantLinear)
        back = load_param_tree(os.path.join(path, "state"), eng.params,
                               "cpu")["layer_0"]["attn"]["wq"]
        assert back.bits == leaf.bits and back.data.dtype == leaf.data.dtype
        assert torch.equal(back.data.view(torch.uint8),
                           leaf.data.view(torch.uint8))
        assert torch.equal(back.scale, leaf.scale)
    snap = snapshot(eng)
    out = eng.swap_weights(str(tmp_path), "weights_v1")
    assert out["wv"] == eng.weight_version() == {
        "id": 1, "digest": manifest_digest(path)}
    assert out["quiesce_s"] >= 0 and out["swap_s"] >= 0
    assert same_tensors(eng, snap)           # same addresses and values
    assert serve(eng, PROMPTS) == want
    # no tag: 'latest' resolves, the id moves on
    assert eng.swap_weights(str(tmp_path))["wv"]["id"] == 2


@pytest.mark.parametrize("max_inflight", [0, 8])
def test_swap_mid_decode_keeps_every_stream(tmp_path, max_inflight):
    ref = engine(max_inflight=max_inflight)
    want = [_one(ref, 10 + i, p, 12) for i, p in enumerate(PROMPTS)]
    eng = engine(max_inflight=max_inflight)
    eng.save_weights(str(tmp_path), tag="same")
    for i, p in enumerate(PROMPTS):
        eng.put(10 + i, p, max_new_tokens=12)
    while min(s.n_generated for s in eng.state.seqs.values()) < 3:
        eng.step()
    inflight = len(eng._inflight)
    eng.swap_weights(str(tmp_path), "same")
    assert not eng._inflight and (inflight > 0) == (max_inflight > 0)
    while any(not s.done for s in eng.state.seqs.values()):
        eng.step()
    assert [eng.flush(10 + i) for i in range(3)] == want
    eng.state.audit()


def _torn(tmp_path, eng):
    eng.save_weights(str(tmp_path), tag="torn")
    f = os.path.join(tmp_path, "torn", "state", "embed.npy")
    with open(f, "r+b") as fh:
        fh.truncate(os.path.getsize(f) - 8)
    return "torn"


def _other_depth(tmp_path, eng):
    engine(layers=1).save_weights(str(tmp_path), tag="shallow")
    return "shallow"


def _nan(tmp_path, eng):
    other = engine()
    with torch.no_grad():
        other.params["ln_final"]["scale"][3] = float("nan")
    other.save_weights(str(tmp_path), tag="nan")
    return "nan"


@pytest.mark.parametrize("reason,make", [
    ("integrity", _torn), ("shape_mismatch", _other_depth),
    ("no_checkpoint", lambda tmp_path, eng: "absent"),
    ("probe_failed", _nan)])
def test_each_refusal_leaves_the_old_weights_serving(tmp_path, reason,
                                                     make):
    eng = engine()
    before = serve(eng, PROMPTS[:2], uid0=1)
    tag = make(tmp_path, eng)
    snap, wv = snapshot(eng), eng.weight_version()
    with pytest.raises(WeightSwapError) as e:
        eng.swap_weights(str(tmp_path), tag)
    assert e.value.reason == reason
    assert same_tensors(eng, snap) and eng.weight_version() == wv
    assert serve(eng, PROMPTS[:2], uid0=5) == before
    if reason == "no_checkpoint":
        with pytest.raises(WeightSwapError, match="no_checkpoint"):
            eng.swap_weights(str(tmp_path / "empty"))


def test_swap_flushes_the_prefix_cache_and_invalidates_the_tier(tmp_path):
    eng = engine(kv_tier=True, kv_tier_ram_bytes=1 << 20,
                 kv_tier_min_pages=1)
    serve(eng, PROMPTS, uid0=1)
    # demote part of the trie into the tier, keep the rest cached
    eng.state.allocator.free(eng.state._alloc(
        eng.state.allocator.free_blocks + 2))
    assert eng.kv_tier_stats()["ram_pages"] > 0
    assert eng.prefix_cache_stats()["cached_pages"] > 0
    eng.put(9, PROMPTS[0], max_new_tokens=8)     # lives across the swap
    eng.step()
    pinned = eng.state.seqs[9].n_shared_blocks
    eng.save_weights(str(tmp_path), tag="w")
    eng.swap_weights(str(tmp_path), "w")
    # only the live sequence's pins stay cached, and they are stale
    assert eng.prefix_cache_stats()["cached_pages"] == pinned
    assert eng.residency_digest() == []
    assert eng.kv_tier_stats()["ram_pages"] == 0
    assert eng.kv_tier_digest() == []
    while not eng.query(9)["done"]:
        eng.step()
    eng.flush(9)        # its pages are freed, not published; the stale
    # pins it dropped wait in the LRU, invisible to every match
    st = eng.prefix_cache_stats()
    assert st["cached_pages"] == pinned and st["referenced_pages"] == 0
    assert eng.residency_digest() == []
    promotes = eng.stats["kv_tier_promotes"]
    eng.put(10, PROMPTS[0], max_new_tokens=4)
    assert eng.state.seqs[10].prefix_hit_tokens == 0
    assert eng.stats["kv_tier_promotes"] == promotes
    eng.flush(10)
    eng.state.audit()


def test_swap_to_other_weights_matches_a_fresh_engine(tmp_path):
    other = engine(seed=1)
    want = serve(other, PROMPTS)
    other.save_weights(str(tmp_path), tag="seed1")
    eng = engine(seed=0)
    old = serve(eng, PROMPTS)
    assert old != want
    eng.swap_weights(str(tmp_path), "seed1")
    assert serve(eng, PROMPTS) == want
    eng.state.audit()


def test_bundles_carry_the_weight_version(tmp_path):
    eng = engine()
    eng.save_weights(str(tmp_path), tag="v")
    eng.swap_weights(str(tmp_path), "v")
    serve(eng, PROMPTS[:1], uid0=1)
    bundle = eng.export_prefix(PROMPTS[0])
    assert bundle.weight_version == eng.weight_version() == {
        "id": 1, "digest": manifest_digest(str(tmp_path / "v"))}
    assert bundle.meta()["wv"] == bundle.weight_version
    # an engine on the constructor's weights refuses it; one swapped to the
    # same tag takes it
    fresh = engine()
    with pytest.raises(MigrationError, match="version_skew"):
        fresh.import_prefix(bundle)
    fresh.swap_weights(str(tmp_path), "v")
    assert fresh.import_prefix(bundle) == bundle.n_full
    # so does the JAX engine (its version is "init")
    jm = jax_build_model("tiny-llama", dtype=jnp.float32, hidden_size=256)
    je = JaxEngine(jm, config=dict(block_size=8, num_blocks=64, max_seqs=4,
                                   chunk=8, max_seq_len=128,
                                   dtype=jnp.float32,
                                   use_pallas_decode=False),
                   topology=MeshTopology({"tensor": 1, "data": 1}))
    asm = jmig.BundleAssembler(bundle.meta())
    chunks = jmig.iter_chunks(bundle)
    for c in chunks:
        asm.add(c)
    asm.eof(len(chunks))
    with pytest.raises(jmig.MigrationError, match="version_skew"):
        je.import_prefix(asm.assemble())


def test_param_tree_files_round_trip_every_dtype(tmp_path):
    tree = {"a": torch.randn(3, 5).to(torch.bfloat16),
            "b": {"c": torch.randn(4), "d": torch.arange(6, dtype=torch.int8)},
            "q": qm.quantize_weight(torch.randn(64, 32), bits="fp8")}
    save_param_tree(tree, str(tmp_path))
    back = load_param_tree(str(tmp_path), tree, "cpu")
    for x, y in zip(tree_tensors(tree), tree_tensors(back)):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x.view(torch.uint8) if x.dtype ==
                           torch.float8_e4m3fn else x,
                           y.view(torch.uint8) if y.dtype ==
                           torch.float8_e4m3fn else y)
    with pytest.raises(ValueError, match="leaf"):
        load_param_tree(str(tmp_path), {"a": tree["a"].float()}, "cpu")


def test_a_pull_onto_a_stale_pinned_chain_is_refused_cleanly(tmp_path):
    """A pre-swap sequence still pins its (stale) prefix pages: a same-
    version pull of that chain is refused with a MigrationError before
    anything is adopted (no block leaves the free list), and succeeds once
    the sequence is gone."""
    eng, other = engine(), engine()
    eng.save_weights(str(tmp_path), tag="v")
    serve(eng, PROMPTS[:1], uid0=1)
    eng.put(9, PROMPTS[0] + [5], max_new_tokens=8)   # pins the chain
    eng.step()
    eng.swap_weights(str(tmp_path), "v")
    other.swap_weights(str(tmp_path), "v")
    serve(other, PROMPTS[:1], uid0=1)
    bundle = other.export_prefix(PROMPTS[0])
    free0 = eng.state.allocator.free_blocks
    with pytest.raises(MigrationError, match="stale pin"):
        eng.import_prefix(bundle)
    assert eng.state.allocator.free_blocks == free0
    eng.state.audit()
    while not eng.query(9)["done"]:
        eng.step()
    eng.flush(9)
    assert eng.import_prefix(bundle) == bundle.n_full
    eng.put(10, PROMPTS[0], max_new_tokens=4)
    assert eng.state.seqs[10].prefix_hit_tokens == bundle.n_full * 8
    eng.flush(10)
    eng.state.audit()
