"""Model zoo: the JAX package's presets (``deepspeed_tpu/models/__init__.py``)
as configs of the port's ``TransformerLM``. The port serves the pre-norm
causal family, dense and MoE (``mixtral-8x7b``, ``qwen2-moe-a2.7b``,
``tiny-mixtral``, ``tiny-qwen2-moe``); the bert-family presets are listed
for parity and raise at model construction until their slice lands."""
from __future__ import annotations

import dataclasses

from .transformer import ModelConfig, MoEConfig, TransformerLM  # noqa: F401

PRESETS: dict[str, ModelConfig] = {
    # --- GPT-2 family (BASELINE.json config 1) ---------------------------
    "gpt2-125m": ModelConfig(vocab_size=50257, hidden_size=768, num_layers=12,
                             num_heads=12, max_seq_len=1024,
                             position_embedding="learned", norm="layernorm",
                             qkv_bias=True, attn_out_bias=True,
                             activation="gelu", tie_embeddings=True),
    "gpt2-350m": ModelConfig(vocab_size=50257, hidden_size=1024, num_layers=24,
                             num_heads=16, max_seq_len=1024,
                             position_embedding="learned", qkv_bias=True, attn_out_bias=True,
                             activation="gelu"),
    # gpt2-large geometry: the largest preset that stays HBM-resident on a
    # 16GB chip with fp32 master+opt state (16 B/param ~ 12.4GB + remat
    # activations) — the model-scale bench entry for hosts whose
    # host-device link is too slow for ZeRO-Offload at 1.3b (VERDICT r03
    # weak #2)
    "gpt2-774m": ModelConfig(vocab_size=50257, hidden_size=1280, num_layers=36,
                             num_heads=20, max_seq_len=1024,
                             position_embedding="learned", qkv_bias=True, attn_out_bias=True,
                             activation="gelu"),
    "gpt2-1.3b": ModelConfig(vocab_size=50257, hidden_size=2048, num_layers=24,
                             num_heads=32, max_seq_len=1024,
                             position_embedding="learned", qkv_bias=True, attn_out_bias=True,
                             activation="gelu"),
    # --- LLaMA-2 family (BASELINE.json configs 2/4) ----------------------
    "llama2-7b": ModelConfig(vocab_size=32000, hidden_size=4096, num_layers=32,
                             num_heads=32, num_kv_heads=32, intermediate_size=11008,
                             max_seq_len=4096, position_embedding="rope",
                             norm="rmsnorm", activation="silu_glu",
                             tie_embeddings=False),
    "llama2-13b": ModelConfig(vocab_size=32000, hidden_size=5120, num_layers=40,
                              num_heads=40, num_kv_heads=40, intermediate_size=13824,
                              max_seq_len=4096, position_embedding="rope",
                              norm="rmsnorm", activation="silu_glu",
                              tie_embeddings=False),
    "llama2-70b": ModelConfig(vocab_size=32000, hidden_size=8192, num_layers=80,
                              num_heads=64, num_kv_heads=8, intermediate_size=28672,
                              max_seq_len=4096, position_embedding="rope",
                              norm="rmsnorm", activation="silu_glu",
                              tie_embeddings=False),
    # --- Mistral / Mixtral (BASELINE.json config 3) ----------------------
    "mistral-7b": ModelConfig(vocab_size=32000, hidden_size=4096, num_layers=32,
                              num_heads=32, num_kv_heads=8, intermediate_size=14336,
                              max_seq_len=8192, position_embedding="rope",
                              norm="rmsnorm", activation="silu_glu",
                              sliding_window=4096, tie_embeddings=False),
    "mixtral-8x7b": ModelConfig(vocab_size=32000, hidden_size=4096, num_layers=32,
                                num_heads=32, num_kv_heads=8, intermediate_size=14336,
                                max_seq_len=8192, position_embedding="rope",
                                norm="rmsnorm", activation="silu_glu",
                                tie_embeddings=False,
                                moe=MoEConfig(num_experts=8, top_k=2)),
    # --- Falcon (reference inference/v2/model_implementations/falcon) ----
    "falcon-7b": ModelConfig(vocab_size=65024, hidden_size=4544, num_layers=32,
                             num_heads=71, num_kv_heads=1, max_seq_len=2048,
                             position_embedding="rope", norm="layernorm",
                             activation="gelu", parallel_block=True,
                             tie_embeddings=False),
    "falcon-40b": ModelConfig(vocab_size=65024, hidden_size=8192, num_layers=60,
                              num_heads=128, num_kv_heads=8, max_seq_len=2048,
                              position_embedding="rope", norm="layernorm",
                              activation="gelu", parallel_block=True,
                              parallel_block_norms=2,  # ln_attn + ln_mlp
                              tie_embeddings=False),
    # --- BLOOM (reference module_inject/containers/bloom.py; ALiBi) ------
    "bloom-7b1": ModelConfig(vocab_size=250880, hidden_size=4096, num_layers=30,
                             num_heads=32, max_seq_len=2048,
                             position_embedding="alibi", norm="layernorm",
                             activation="gelu", qkv_bias=True,
                             attn_out_bias=True, embed_norm=True,
                             tie_embeddings=True),
    # --- OPT (reference v2 model_implementations/opt; ReLU + learned) ----
    "opt-125m": ModelConfig(vocab_size=50272, hidden_size=768, num_layers=12,
                            num_heads=12, max_seq_len=2048,
                            position_embedding="learned", activation="relu",
                            qkv_bias=True, attn_out_bias=True),
    "opt-6.7b": ModelConfig(vocab_size=50272, hidden_size=4096, num_layers=32,
                            num_heads=32, max_seq_len=2048,
                            position_embedding="learned", activation="relu",
                            qkv_bias=True, attn_out_bias=True),
    # --- GPT-J / GPT-NeoX (reference containers gptj/gptneox) ------------
    "gptj-6b": ModelConfig(vocab_size=50400, hidden_size=4096, num_layers=28,
                           num_heads=16, max_seq_len=2048,
                           position_embedding="rope", rotary_pct=0.25,
                           activation="gelu", parallel_block=True,
                           tie_embeddings=False),
    "gpt-neox-20b": ModelConfig(vocab_size=50432, hidden_size=6144,
                                num_layers=44, num_heads=64, max_seq_len=2048,
                                position_embedding="rope", rotary_pct=0.25,
                                activation="gelu", parallel_block=True,
                                parallel_block_norms=2,  # input+post_attn ln
                                tie_embeddings=False),
    # --- Phi (reference v2 model_implementations/phi; partial rotary) ----
    "phi-2": ModelConfig(vocab_size=51200, hidden_size=2560, num_layers=32,
                         num_heads=32, max_seq_len=2048,
                         position_embedding="rope", rotary_pct=0.4,
                         activation="gelu", parallel_block=True,
                         qkv_bias=True, attn_out_bias=True,
                         unembed_bias=True, tie_embeddings=False),
    # --- Qwen (reference v2 model_implementations/qwen*; qkv bias) -------
    "qwen-7b": ModelConfig(vocab_size=151936, hidden_size=4096, num_layers=32,
                           num_heads=32, intermediate_size=11008,
                           max_seq_len=8192, position_embedding="rope",
                           norm="rmsnorm", activation="silu_glu",
                           qkv_bias=True, tie_embeddings=False),
    "qwen2-7b": ModelConfig(vocab_size=152064, hidden_size=3584, num_layers=28,
                            num_heads=28, num_kv_heads=4,
                            intermediate_size=18944, max_seq_len=32768,
                            position_embedding="rope", norm="rmsnorm",
                            activation="silu_glu", qkv_bias=True,
                            tie_embeddings=False),
    "phi-3-mini": ModelConfig(vocab_size=32064, hidden_size=3072,
                              num_layers=32, num_heads=32,
                              intermediate_size=8192, max_seq_len=4096,
                              position_embedding="rope", norm="rmsnorm",
                              activation="silu_glu", tie_embeddings=False),
    "internlm-7b": ModelConfig(vocab_size=103168, hidden_size=4096,
                               num_layers=32, num_heads=32,
                               intermediate_size=11008, max_seq_len=2048,
                               position_embedding="rope", norm="rmsnorm",
                               activation="silu_glu", qkv_bias=True,
                               tie_embeddings=False),
    # qwen2-moe (qwen1.5-moe-a2.7b): 60 fine-grained experts top-4 plus a
    # sigmoid-gated shared expert (reference inference/v2 qwen_v2_moe)
    "qwen2-moe-a2.7b": ModelConfig(vocab_size=151936, hidden_size=2048,
                                   num_layers=24, num_heads=16,
                                   intermediate_size=1408, max_seq_len=8192,
                                   position_embedding="rope", norm="rmsnorm",
                                   activation="silu_glu", qkv_bias=True,
                                   tie_embeddings=False,
                                   moe=MoEConfig(
                                       num_experts=60, top_k=4,
                                       shared_expert_intermediate=5632)),
    # --- bert family: bidirectional post-norm encoders (reference
    # module_inject/containers/{bert,distil_bert}.py policies and the
    # csrc/transformer training kernels, whose target workload is BERT) ----
    "bert-base-uncased": ModelConfig(vocab_size=30522, hidden_size=768,
                                     num_layers=12, num_heads=12,
                                     max_seq_len=512,
                                     position_embedding="learned",
                                     activation="gelu", qkv_bias=True, attn_out_bias=True,
                             causal=False,
                                     pre_norm=False, dropout=0.1,
                                     type_vocab_size=2, norm_eps=1e-12),
    "bert-large-uncased": ModelConfig(vocab_size=30522, hidden_size=1024,
                                      num_layers=24, num_heads=16,
                                      max_seq_len=512,
                                      position_embedding="learned",
                                      activation="gelu", qkv_bias=True, attn_out_bias=True,
                             causal=False,
                                      pre_norm=False, dropout=0.1,
                                      type_vocab_size=2, norm_eps=1e-12),
    "distilbert-base": ModelConfig(vocab_size=30522, hidden_size=768,
                                   num_layers=6, num_heads=12,
                                   max_seq_len=512,
                                   position_embedding="learned",
                                   activation="gelu", qkv_bias=True, attn_out_bias=True,
                             causal=False,
                                   pre_norm=False, dropout=0.1,
                                   norm_eps=1e-12),
    # --- tiny variants for tests/debug (reference tests/unit/simple_model.py) --
    "tiny-gpt2": ModelConfig(vocab_size=256, hidden_size=64, num_layers=2,
                             num_heads=4, max_seq_len=128,
                             position_embedding="learned", qkv_bias=True, attn_out_bias=True,
                             activation="gelu"),
    "tiny-llama": ModelConfig(vocab_size=256, hidden_size=64, num_layers=2,
                              num_heads=4, num_kv_heads=2, max_seq_len=128,
                              position_embedding="rope", norm="rmsnorm",
                              activation="silu_glu", tie_embeddings=False),
    "tiny-mixtral": ModelConfig(vocab_size=256, hidden_size=64, num_layers=2,
                                num_heads=4, num_kv_heads=2, max_seq_len=128,
                                position_embedding="rope", norm="rmsnorm",
                                activation="silu_glu", tie_embeddings=False,
                                moe=MoEConfig(num_experts=4, top_k=2,
                                              min_capacity=4)),
    "tiny-falcon": ModelConfig(vocab_size=256, hidden_size=64, num_layers=2,
                               num_heads=4, num_kv_heads=1, max_seq_len=128,
                               position_embedding="rope", activation="gelu",
                               parallel_block=True, tie_embeddings=False),
    "tiny-bloom": ModelConfig(vocab_size=256, hidden_size=64, num_layers=2,
                              num_heads=4, max_seq_len=128,
                              position_embedding="alibi", activation="gelu"),
    "tiny-opt": ModelConfig(vocab_size=256, hidden_size=64, num_layers=2,
                            num_heads=4, max_seq_len=128,
                            position_embedding="learned", activation="relu"),
    "tiny-phi": ModelConfig(vocab_size=256, hidden_size=64, num_layers=2,
                            num_heads=4, max_seq_len=128,
                            position_embedding="rope", rotary_pct=0.5,
                            activation="gelu", parallel_block=True,
                            tie_embeddings=False),
    "tiny-qwen": ModelConfig(vocab_size=256, hidden_size=64, num_layers=2,
                             num_heads=4, num_kv_heads=2, max_seq_len=128,
                             position_embedding="rope", norm="rmsnorm",
                             activation="silu_glu", qkv_bias=True,
                             tie_embeddings=False),
    "tiny-bert": ModelConfig(vocab_size=256, hidden_size=64, num_layers=2,
                             num_heads=4, max_seq_len=128,
                             position_embedding="learned", activation="gelu",
                             qkv_bias=True, attn_out_bias=True,
                             causal=False, pre_norm=False,
                             type_vocab_size=2),
    "tiny-qwen2-moe": ModelConfig(vocab_size=256, hidden_size=64,
                                  num_layers=2, num_heads=4, num_kv_heads=2,
                                  intermediate_size=96, max_seq_len=128,
                                  position_embedding="rope", norm="rmsnorm",
                                  activation="silu_glu", qkv_bias=True,
                                  tie_embeddings=False,
                                  moe=MoEConfig(
                                      num_experts=4, top_k=2, min_capacity=4,
                                      shared_expert_intermediate=128)),
}


def get_model_config(name: str, **overrides) -> ModelConfig:
    if name not in PRESETS:
        raise ValueError(f"unknown model preset '{name}'; known: {sorted(PRESETS)}")
    cfg = PRESETS[name]
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def build_model(name: str, *, device=None, seed: int = 0,
                **overrides) -> TransformerLM:
    """Preset ``name`` (with config ``overrides``) as a randomly initialised
    ``TransformerLM`` on ``device`` (the CUDA device by default)."""
    return TransformerLM(get_model_config(name, **overrides), device=device,
                         seed=seed)
