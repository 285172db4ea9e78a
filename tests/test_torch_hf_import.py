"""HF checkpoint import in the port (deepspeed_tpu_torch/models/hf.py): for
every family of tests/test_hf_import.py the port's tree equals the JAX
package's ``from_hf_model`` tree leaf for leaf (fp32, exact), and the port
model's logits match the transformers forward. Also: configs given as a
``SimpleNamespace`` of ``config.json`` values (the defaults the
transformers classes fill in), bf16 checkpoints converted without numpy,
the coverage check's refusals and the bert-family refusal."""
import dataclasses
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from deepspeed_tpu_torch.inference.weights import flatten_tree  # noqa: E402
from deepspeed_tpu_torch.models import hf as port_hf  # noqa: E402

#: logits against the transformers forward (the JAX suite's bound)
TOL = 2e-4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _jax_tree(hf):
    """The JAX package's tree for ``hf``, flattened to numpy."""
    import flax

    from deepspeed_tpu.models.hf import from_hf_model

    _, params = from_hf_model(hf, dtype=jax.numpy.float32)
    return {".".join(k): np.asarray(v) for k, v in
            flax.traverse_util.flatten_dict(params).items()}


def _gpt2():
    return transformers.GPT2LMHeadModel(transformers.GPT2Config(
        vocab_size=128, n_positions=64, n_embd=64, n_layer=2, n_head=4))


def _llama(tied=False):
    return transformers.LlamaForCausalLM(transformers.LlamaConfig(
        vocab_size=128, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=64, rms_norm_eps=1e-5,
        tie_word_embeddings=tied))


def _mistral(window=None):
    return transformers.MistralForCausalLM(transformers.MistralConfig(
        vocab_size=128, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=64, rms_norm_eps=1e-5,
        tie_word_embeddings=False, sliding_window=window,
        attn_implementation="eager"))


def _qwen2():
    return transformers.Qwen2ForCausalLM(transformers.Qwen2Config(
        vocab_size=128, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=64, rms_norm_eps=1e-5,
        tie_word_embeddings=False, use_sliding_window=False))


def _mixtral():
    return transformers.MixtralForCausalLM(transformers.MixtralConfig(
        vocab_size=128, hidden_size=64, intermediate_size=96,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=64, rms_norm_eps=1e-5,
        tie_word_embeddings=False, num_local_experts=4,
        num_experts_per_tok=2, sliding_window=None))


def _falcon():
    return transformers.FalconForCausalLM(transformers.FalconConfig(
        vocab_size=128, hidden_size=64, num_hidden_layers=2,
        num_attention_heads=4, multi_query=True, parallel_attn=True,
        new_decoder_architecture=False, bias=False, alibi=False,
        max_position_embeddings=64, layer_norm_epsilon=1e-5))


def _bloom():
    return transformers.BloomForCausalLM(transformers.BloomConfig(
        vocab_size=128, hidden_size=64, n_layer=2, n_head=4,
        layer_norm_epsilon=1e-5))


def _opt():
    return transformers.OPTForCausalLM(transformers.OPTConfig(
        vocab_size=128, hidden_size=64, ffn_dim=128, num_hidden_layers=2,
        num_attention_heads=4, max_position_embeddings=64,
        word_embed_proj_dim=64, do_layer_norm_before=True))


def _phi():
    return transformers.PhiForCausalLM(transformers.PhiConfig(
        vocab_size=128, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4,
        max_position_embeddings=64, partial_rotary_factor=0.5,
        layer_norm_eps=1e-5, tie_word_embeddings=False))


def _phi3():
    return transformers.Phi3ForCausalLM(transformers.Phi3Config(
        vocab_size=128, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=64, rms_norm_eps=1e-5,
        tie_word_embeddings=False, sliding_window=None,
        pad_token_id=0))


def _qwen2_moe(mixed=False):
    kw = dict(decoder_sparse_step=2, mlp_only_layers=[3],
              num_hidden_layers=4, intermediate_size=168) if mixed else \
        dict(decoder_sparse_step=1, mlp_only_layers=[], num_hidden_layers=2,
             intermediate_size=128)
    return transformers.Qwen2MoeForCausalLM(transformers.Qwen2MoeConfig(
        vocab_size=128, hidden_size=64, moe_intermediate_size=96,
        shared_expert_intermediate_size=112, num_attention_heads=4,
        num_key_value_heads=2, max_position_embeddings=64,
        rms_norm_eps=1e-5, tie_word_embeddings=False, num_experts=4,
        num_experts_per_tok=2, norm_topk_prob=False,
        use_sliding_window=False, **kw))


def _neox():
    return transformers.GPTNeoXForCausalLM(transformers.GPTNeoXConfig(
        vocab_size=128, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4,
        max_position_embeddings=64, rotary_pct=0.25,
        use_parallel_residual=True, tie_word_embeddings=False))


def _stablelm():
    return transformers.StableLmForCausalLM(transformers.StableLmConfig(
        vocab_size=128, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=64, partial_rotary_factor=0.5,
        use_qkv_bias=False, tie_word_embeddings=False))


def _gptj():
    return transformers.GPTJForCausalLM(transformers.GPTJConfig(
        vocab_size=128, n_embd=64, n_layer=2, n_head=4, n_positions=64,
        rotary_dim=8, tie_word_embeddings=False))


def qwen_v1_shim():
    """qwen v1 is a remote-code arch (no transformers class): a torch
    qwen2 model whose weights are RENAMED into the qwen v1 state-dict
    layout (same math), returned as (shim, the qwen2 oracle)."""
    hf = transformers.Qwen2ForCausalLM(transformers.Qwen2Config(
        vocab_size=128, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=4,
        max_position_embeddings=64, rms_norm_eps=1e-5,
        tie_word_embeddings=False, use_sliding_window=False)).eval()
    sd = hf.state_dict()
    v1 = {"transformer.wte.weight": sd["model.embed_tokens.weight"],
          "transformer.ln_f.weight": sd["model.norm.weight"],
          "lm_head.weight": sd["lm_head.weight"]}
    for i in range(2):
        q = f"model.layers.{i}."
        p = f"transformer.h.{i}."
        v1[p + "ln_1.weight"] = sd[q + "input_layernorm.weight"]
        v1[p + "ln_2.weight"] = sd[q + "post_attention_layernorm.weight"]
        v1[p + "attn.c_attn.weight"] = torch.cat(
            [sd[q + "self_attn.q_proj.weight"],
             sd[q + "self_attn.k_proj.weight"],
             sd[q + "self_attn.v_proj.weight"]], dim=0)
        v1[p + "attn.c_attn.bias"] = torch.cat(
            [sd[q + "self_attn.q_proj.bias"],
             sd[q + "self_attn.k_proj.bias"],
             sd[q + "self_attn.v_proj.bias"]], dim=0)
        v1[p + "attn.c_proj.weight"] = sd[q + "self_attn.o_proj.weight"]
        v1[p + "mlp.w2.weight"] = sd[q + "mlp.gate_proj.weight"]  # silu br.
        v1[p + "mlp.w1.weight"] = sd[q + "mlp.up_proj.weight"]
        v1[p + "mlp.c_proj.weight"] = sd[q + "mlp.down_proj.weight"]
    shim = SimpleNamespace(
        config=SimpleNamespace(
            model_type="qwen", vocab_size=128, hidden_size=64,
            num_hidden_layers=2, num_attention_heads=4,
            intermediate_size=256,      # v1 counts both swiglu branches
            seq_length=64, layer_norm_epsilon=1e-5,
            rotary_emb_base=10000.0, tie_word_embeddings=False),
        state_dict=lambda: v1)
    return shim, hf


#: (case, builder, config checks) — the families of tests/test_hf_import.py
CASES = {
    "gpt2": (_gpt2, {}),
    "llama": (_llama, {}),
    "llama-tied": (lambda: _llama(tied=True), {"tie_embeddings": True}),
    "mistral-gqa": (_mistral, {"kv_heads": 2}),
    "mistral-window": (lambda: _mistral(window=8), {"sliding_window": 8}),
    "qwen2": (_qwen2, {"qkv_bias": True}),
    "mixtral": (_mixtral, {}),
    "falcon": (_falcon, {"kv_heads": 1, "parallel_block": True}),
    "bloom": (_bloom, {"position_embedding": "alibi"}),
    "opt": (_opt, {}),
    "phi": (_phi, {"rotary_pct": 0.5}),
    "phi3": (_phi3, {}),
    "qwen2-moe": (_qwen2_moe, {}),
    "qwen2-moe-mixed": (lambda: _qwen2_moe(mixed=True), {}),
    "neox (generic)": (_neox, {"parallel_block": True,
                               "parallel_block_norms": 2,
                               "activation": "gelu_exact"}),
    "stablelm (generic)": (_stablelm, {"norm": "layernorm",
                                       "activation": "silu_glu",
                                       "rotary_pct": 0.5}),
    "gptj (generic)": (_gptj, {"parallel_block": True,
                               "parallel_block_norms": 1,
                               "rotary_pct": 0.5, "unembed_bias": True}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_tree_equals_jax_and_logits_match_transformers(case):
    build, checks = CASES[case]
    torch.manual_seed(0)
    hf = build().eval()
    model, params = port_hf.from_hf_model(hf, dtype=torch.float32,
                                          device="cpu")
    for k, v in checks.items():
        assert getattr(model.config, k) == v, (k, getattr(model.config, k))
    ours = {k: v.numpy() for k, v in flatten_tree(params).items()}
    want = _jax_tree(hf)
    assert sorted(ours) == sorted(want)
    for k in want:
        assert ours[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(ours[k], want[k], err_msg=k)
    ids = torch.from_numpy(np.random.default_rng(1).integers(0, 128, (2, 16)))
    with torch.no_grad():
        ref = hf(ids).logits
        got = model(ids)
    assert (got - ref).abs().max().item() < TOL


def test_qwen_v1_shim_tree_and_logits():
    shim, oracle = qwen_v1_shim()
    model, params = port_hf.from_hf_model(shim, dtype=torch.float32,
                                          device="cpu")
    assert model.config.ffn_size == 128
    ours = {k: v.numpy() for k, v in flatten_tree(params).items()}
    want = _jax_tree(shim)
    assert sorted(ours) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(ours[k], want[k], err_msg=k)
    ids = torch.from_numpy(np.random.default_rng(10).integers(0, 128, (2, 16)))
    with torch.no_grad():
        ref = oracle(ids).logits
        got = model(ids)
    assert (got - ref).abs().max().item() < TOL


def test_sliding_window_binds():
    """S=16 past window=8: the imported window changes the logits."""
    torch.manual_seed(0)
    hf = _mistral(window=8).eval()
    model, params = port_hf.from_hf_model(hf, dtype=torch.float32,
                                          device="cpu")
    ids = torch.from_numpy(np.random.default_rng(4).integers(0, 128, (2, 24)))
    dense, _ = port_hf._model_of(
        dataclasses.replace(model.config, sliding_window=None), params,
        "cpu")
    with torch.no_grad():
        assert (dense(ids) - model(ids)).abs().max().item() > 1e-3


def test_model_parameters_are_the_returned_tensors():
    """No second copy: the model's parameters share storage with the
    params tree."""
    torch.manual_seed(0)
    model, params = port_hf.from_hf_model(_llama().eval(), device="cpu")
    flat = flatten_tree(params)
    for name, p in model.named_parameters():
        assert p.data_ptr() == flat[name].data_ptr(), name


def test_bf16_checkpoint_converts_bit_for_bit_without_numpy():
    """A bf16 state dict (numpy has no bfloat16): every leaf keeps bf16
    and equals its source under the documented map — transpose, and the
    half → interleaved head-dim permutation of q and k."""
    torch.manual_seed(0)
    hf = _llama().eval().to(torch.bfloat16)
    sd = hf.state_dict()
    model, params = port_hf.from_hf_model(hf, device="cpu")
    assert model.config.dtype == torch.bfloat16
    E, H, KV, D = 64, 4, 2, 16
    perm = torch.cat([torch.arange(D // 2)[:, None],
                      torch.arange(D // 2)[:, None] + D // 2], 1).reshape(-1)
    p = "model.layers.1."
    a = params["layer_1"]["attn"]
    for leaf in flatten_tree(params).values():
        assert leaf.dtype == torch.bfloat16
    assert torch.equal(a["wq"], sd[p + "self_attn.q_proj.weight"].T
                       .reshape(E, H, D)[:, :, perm])
    assert torch.equal(a["wk"], sd[p + "self_attn.k_proj.weight"].T
                       .reshape(E, KV, D)[:, :, perm])
    assert torch.equal(a["wv"], sd[p + "self_attn.v_proj.weight"].T
                       .reshape(E, KV, D))
    assert torch.equal(a["wo"], sd[p + "self_attn.o_proj.weight"].T
                       .reshape(H, D, E))
    assert torch.equal(params["layer_1"]["ffn"]["w_down"],
                       sd[p + "mlp.down_proj.weight"].T)
    assert torch.equal(params["unembed"], sd["lm_head.weight"].T)
    assert torch.equal(params["embed"], sd["model.embed_tokens.weight"])


#: the model types whose config classes ``HF_CONFIG_DEFAULTS`` mirrors
CONFIG_CLASSES = {
    "gpt2": "GPT2Config", "llama": "LlamaConfig", "mistral": "MistralConfig",
    "qwen2": "Qwen2Config", "mixtral": "MixtralConfig",
    "falcon": "FalconConfig", "bloom": "BloomConfig", "opt": "OPTConfig",
    "phi": "PhiConfig", "phi3": "Phi3Config", "qwen2_moe": "Qwen2MoeConfig",
}


@pytest.mark.parametrize("mt", sorted(CONFIG_CLASSES))
def test_config_defaults_match_transformers_classes(mt):
    cls = getattr(transformers, CONFIG_CLASSES[mt])
    real = cls()
    bare = port_hf._HFConfig(SimpleNamespace(model_type=mt))
    for name in port_hf.HF_CONFIG_DEFAULTS[mt]:
        got, want = getattr(bare, name), getattr(real, name)
        if isinstance(want, list):
            want = tuple(want)
        assert got == want, (mt, name, got, want)


@pytest.mark.parametrize("mt", sorted(CONFIG_CLASSES))
def test_config_from_namespace_equals_config_from_class(mt):
    """A config.json carrying only a few values converts as the
    transformers class would have filled it in."""
    cls = getattr(transformers, CONFIG_CLASSES[mt])
    vals = {"vocab_size": 256}
    if mt == "qwen2_moe":
        vals.update(num_hidden_layers=4, decoder_sparse_step=2)
    ns = SimpleNamespace(model_type=mt, **vals)
    assert port_hf.config_from_hf(ns) == port_hf.config_from_hf(cls(**vals))


def test_llama2_7b_config_json_namespace_equals_preset():
    """Llama-2-7B's published config.json values as a SimpleNamespace →
    the port's llama2-7b preset in every field but dtype."""
    from deepspeed_tpu_torch.models import PRESETS

    ns = SimpleNamespace(
        model_type="llama", hidden_size=4096, intermediate_size=11008,
        num_attention_heads=32, num_hidden_layers=32,
        num_key_value_heads=32, vocab_size=32000, rms_norm_eps=1e-5,
        max_position_embeddings=4096, rope_scaling=None,
        tie_word_embeddings=False, hidden_act="silu")
    got = port_hf.config_from_hf(ns)
    assert dataclasses.replace(got, dtype=PRESETS["llama2-7b"].dtype) == \
        PRESETS["llama2-7b"]


def test_unconsumed_tensor_fails_loudly():
    torch.manual_seed(0)
    hf = _llama().eval()
    sd = dict(hf.state_dict())
    sd["model.layers.0.self_attn.q_proj.bias"] = torch.zeros(64)
    shim = SimpleNamespace(config=hf.config, state_dict=lambda: sd)
    with pytest.raises(NotImplementedError, match="not consumed"):
        port_hf.from_hf_model(shim, device="cpu")


def test_alien_arch_and_rope_scaling_fail_loudly():
    hf = transformers.T5ForConditionalGeneration(transformers.T5Config(
        vocab_size=128, d_model=64, d_ff=128, num_layers=2, num_heads=4,
        d_kv=16)).eval()
    with pytest.raises(NotImplementedError, match="generic HF import"):
        port_hf.from_hf_model(hf, device="cpu")
    cfg = transformers.LlamaConfig(
        vocab_size=128, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        rope_scaling={"rope_type": "linear", "factor": 2.0})
    with pytest.raises(NotImplementedError, match="rope_scaling"):
        port_hf.config_from_hf(cfg)
    cfg = transformers.MistralConfig(
        vocab_size=128, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=4096, sliding_window=4096)
    assert port_hf.config_from_hf(cfg).sliding_window is None


def test_bert_family_refused_naming_its_item():
    hf = transformers.BertForMaskedLM(transformers.BertConfig(
        vocab_size=128, hidden_size=64, num_hidden_layers=2,
        num_attention_heads=4, intermediate_size=128)).eval()
    with pytest.raises(NotImplementedError, match="item 7"):
        port_hf.from_hf_model(hf, device="cpu")
