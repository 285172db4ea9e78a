"""Decoder-only transformer family (GPT-2 / LLaMA / Falcon / Phi / BLOOM).

Counterpart of ``deepspeed_tpu/models/transformer.py``. The configuration
dataclasses keep the JAX package's fields and defaults; the modules are
``nn.Module``s whose parameter names and layouts are the flax tree's
(``embed``, ``pos_embed``, ``layer_{i}/attn/{wq,wk,wv,wo,bq,bk,bv,bo}``,
``layer_{i}/ln_attn/scale``, ``layer_{i}/ffn/{w_gate,w_up,w_down,b_up,
b_down}``, ``layer_{i}/moe/{moe_layer/gate/wg, moe_layer/experts/...,
shared_expert/..., shared_gate}``, ``ln_final``, ``unembed``,
``unembed_b``), so a flax tree loads one for one
(``inference.weights.params_from_jax``). ``wq`` keeps
``[E, H, D]`` and ``wo`` ``[H, D, E]``: the projections compute the JAX
forward's einsums (:func:`proj_heads`, :func:`proj_out`).

The norm, FFN and rotary math live in plain functions over parameter
dicts (:func:`norm`, :func:`dense_ffn`, :func:`apply_rope`) shared by the
modules here and the serving engine's ragged forward
(``inference/engine_v2.py``), the way the JAX engine applies the flax
``Norm``/``DenseFFN`` modules to its own tree.

MoE layers (``moe_layer_freq`` / ``moe_layer_pattern``) carry
:class:`MoEFFN`: the routed experts of ``moe/layer.py`` plus qwen2-moe's
sigmoid-gated shared expert. :meth:`TransformerLM.forward` routes them as
the JAX model does: the capacity route with ``drop_tokens=True`` (the
serving engine routes every token instead) or, under ``moe.dropless``, the
grouped products (K5). The model is built in eval mode, flax's default
``deterministic=True``: routing at ``eval_capacity_factor``; ``train()``
switches to ``capacity_factor``. Each MoE layer's loss (aux + z, weighted)
is a value its block returns; ``forward(..., return_losses=True)`` hands
them back beside the logits, as flax's ``mutable=["losses"]`` does, and
they survive ``torch.utils.checkpoint`` as outputs of the block. For
serving the port keeps every parameter in ``config.dtype``, the router's
``wg`` too, where the flax model keeps fp32 parameters and casts the
others.

Parameters are created without gradients, in ``config.dtype`` or in
``param_dtype`` when given; the forward computes in ``config.dtype``. The
training engine (``runtime/engine.py``) builds the model with fp32
parameters (its master copy, as flax initialises fp32 parameters), casts
them to the compute dtype and turns their gradients on. ``remat`` runs each
block under the ``ops/remat.py`` policy ``remat_policy`` while gradients
are being recorded, and attention passes ``attn_impl`` to the dispatcher
(``ops/attention.py``: "auto" and "pallas" reach the flash kernel K4 where
its gate holds), as the JAX model does; a sliding window or ALiBi takes the
plain route. The bert-family encoder layout (post-norm, bidirectional,
segment embeddings) is ported with a later slice and raises here.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any

import torch
import torch.nn.functional as F
from torch import nn

from ..moe.layer import MoE
from ..ops.attention import dot_product_attention
from ..ops.quant_matmul import QuantLinear, quant_matmul
from ..ops.remat import checkpoint_fn, make_policy


@dataclass(frozen=True)
class MoEConfig:
    """Mixtral/GShard-style MoE (the JAX package's ``MoEConfig``)."""
    num_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25
    eval_capacity_factor: float = 2.0
    min_capacity: int = 4
    aux_loss_weight: float = 0.01
    router_z_loss_weight: float = 0.001
    moe_layer_freq: int = 1
    moe_layer_pattern: tuple[bool, ...] | None = None
    dense_ffn_intermediate: int | None = None
    dropless: bool = False
    dropless_block_m: int = 128
    shared_expert_intermediate: int | None = None
    normalize_gates: bool = True


@dataclass(frozen=True)
class ModelConfig:
    vocab_size: int = 50257
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    num_kv_heads: int | None = None          # GQA; None → num_heads
    intermediate_size: int | None = None     # None → 4*hidden (gpt) / 8/3*hidden (glu)
    max_seq_len: int = 1024
    position_embedding: str = "learned"      # learned | rope | alibi
    rope_theta: float = 10000.0
    rotary_pct: float = 1.0                  # partial rotary (gpt-neox/phi)
    norm: str = "layernorm"                  # layernorm | rmsnorm
    norm_eps: float = 1e-5
    activation: str = "gelu"                 # gelu (tanh approx) |
                                             # gelu_exact (erf) | relu |
                                             # silu_glu (SwiGLU)
    qkv_bias: bool = False
    attn_out_bias: bool = False
    parallel_block: bool = False             # falcon/gpt-j/phi: attn ∥ ffn
    parallel_block_norms: int = 1            # 2 = separate ln for ffn branch
    causal: bool = True
    sliding_window: int | None = None
    pre_norm: bool = True
    embed_norm: bool = False                 # bloom: ln right after embed
    unembed_bias: bool = False               # phi: lm_head bias
    dropout: float = 0.0
    type_vocab_size: int = 0
    tie_embeddings: bool = True
    moe: MoEConfig | None = None
    dtype: Any = torch.bfloat16              # compute dtype
    remat: bool = False
    remat_policy: str = "nothing_saveable"
    attn_impl: str = "auto"                  # auto | pallas | xla

    @property
    def kv_heads(self) -> int:
        return self.num_kv_heads or self.num_heads

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @property
    def ffn_size(self) -> int:
        if self.intermediate_size:
            return self.intermediate_size
        if self.activation == "silu_glu":
            return int(8 * self.hidden_size / 3 // 128 + 1) * 128
        return 4 * self.hidden_size


def dense_ffn_config(cfg: ModelConfig) -> ModelConfig:
    """Config for the dense FFN of a mixed MoE stack."""
    if cfg.moe is not None and cfg.moe.dense_ffn_intermediate:
        return dataclasses.replace(
            cfg, intermediate_size=cfg.moe.dense_ffn_intermediate)
    return cfg


def is_moe_layer(cfg: ModelConfig, i: int) -> bool:
    """Whether layer ``i`` carries the MoE FFN: the explicit per-layer
    pattern when set, else every ``moe_layer_freq``-th layer."""
    if cfg.moe is None:
        return False
    pat = cfg.moe.moe_layer_pattern
    if pat is not None:
        if len(pat) != cfg.num_layers:
            raise ValueError(f"moe_layer_pattern has {len(pat)} entries for "
                             f"{cfg.num_layers} layers")
        return bool(pat[i])
    return i % (cfg.moe.moe_layer_freq or 1) == 0


def moe_layer_kwargs(cfg: ModelConfig, **overrides) -> dict:
    """The one ``ModelConfig.moe`` → MoE-layer keyword mapping, shared by
    the model's :class:`MoEFFN` and the serving engine."""
    moe = cfg.moe
    kw = dict(
        hidden_size=cfg.hidden_size,
        num_experts=moe.num_experts,
        ffn_size=cfg.ffn_size,
        k=moe.top_k,
        capacity_factor=moe.capacity_factor,
        eval_capacity_factor=moe.eval_capacity_factor,
        min_capacity=moe.min_capacity,
        activation=cfg.activation,
        aux_loss_weight=moe.aux_loss_weight,
        z_loss_weight=moe.router_z_loss_weight,
        dropless=moe.dropless,
        dropless_block_m=moe.dropless_block_m,
        normalize_gates=moe.normalize_gates,
    )
    kw.update(overrides)
    return kw


def check_served_family(cfg: ModelConfig) -> None:
    """Raise NotImplementedError for model features a later slice ports."""
    if not (cfg.causal and cfg.pre_norm) or cfg.type_vocab_size \
            or cfg.dropout:
        raise NotImplementedError(
            "bert-family encoders (bidirectional, post-norm, segment "
            "embeddings, dropout) are ported with a later slice")
    if cfg.remat:
        make_policy(cfg.remat_policy)   # an unknown or offload policy raises


# ---------------------------------------------------------------------------
# plain functions over parameter dicts (shared with the serving engine)
# ---------------------------------------------------------------------------

def norm(x: torch.Tensor, p, cfg: ModelConfig) -> torch.Tensor:
    """LayerNorm / RMSNorm with the JAX package's numerics: statistics and
    the LayerNorm centering in fp32, one downcast, the affine in the input
    dtype. ``p`` holds ``scale`` (and ``bias`` for layernorm)."""
    dtype = x.dtype
    x32 = x.float()
    if cfg.norm == "rmsnorm":
        var = x32.square().mean(dim=-1, keepdim=True)
        inv = torch.rsqrt(var + cfg.norm_eps)
        return x * inv.to(dtype) * p["scale"].to(dtype)
    mean = x32.mean(dim=-1, keepdim=True)
    var = (x32 - mean).square().mean(dim=-1, keepdim=True)
    inv = torch.rsqrt(var + cfg.norm_eps)
    normed = ((x32 - mean) * inv).to(dtype)
    return normed * p["scale"].to(dtype) + p["bias"].to(dtype)


def alibi_slopes(num_heads: int, device=None) -> torch.Tensor:
    """ALiBi per-head slopes: geometric sequence from 2^(-8/n)."""
    def pow2_slopes(n):
        start = 2.0 ** (-(2.0 ** -(math.log2(n) - 3)))
        return [start * (start ** i) for i in range(n)]

    if math.log2(num_heads).is_integer():
        vals = pow2_slopes(num_heads)
    else:
        closest = 2 ** math.floor(math.log2(num_heads))
        vals = pow2_slopes(closest) + pow2_slopes(2 * closest)[0::2][
            :num_heads - closest]
    return torch.tensor(vals, dtype=torch.float32, device=device)


def rope(q: torch.Tensor, k: torch.Tensor, positions: torch.Tensor,
         theta: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Rotary position embedding on [B, S, H, D] q/k, interleaved pairs
    (x[..., ::2], x[..., 1::2]) as the JAX package rotates them, in fp32."""
    d = q.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                          device=q.device) / d))
    angles = positions[..., None].float() * freqs          # [B, S, D/2]
    cos, sin = torch.cos(angles)[:, :, None, :], torch.sin(angles)[:, :, None, :]

    def rot(x):
        x1, x2 = x[..., ::2], x[..., 1::2]
        return torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                           dim=-1).reshape(x.shape)

    return rot(q.float()).to(q.dtype), rot(k.float()).to(k.dtype)


def apply_rope(q, k, positions, theta: float, rotary_pct: float = 1.0):
    """Full or partial (gpt-neox / phi ``rotary_pct``) rotary embedding."""
    if rotary_pct >= 1.0:
        return rope(q, k, positions, theta)
    d_rot = (int(q.shape[-1] * rotary_pct) // 2) * 2
    qr, kr = rope(q[..., :d_rot], k[..., :d_rot], positions, theta)
    return (torch.cat([qr, q[..., d_rot:]], dim=-1),
            torch.cat([kr, k[..., d_rot:]], dim=-1))


def _qmm(x: torch.Tensor, w: QuantLinear) -> torch.Tensor:
    """``[..., K] @ dequant(w) -> [..., N]`` through the quantized-weight
    kernel (K2), in x's dtype."""
    y = quant_matmul(x.reshape(-1, x.shape[-1]).contiguous(), w)
    return y.reshape(*x.shape[:-1], y.shape[-1]).to(x.dtype)


def proj_heads(x: torch.Tensor, w, num_heads: int | None = None
               ) -> torch.Tensor:
    """``[..., E] @ [E, H, D] -> [..., H, D]`` (the einsum
    ``...e,ehd->...hd``) as one matrix product over views. A
    ``QuantLinear`` ``w`` holds ``[E, H*D]`` and takes ``num_heads``."""
    if isinstance(w, QuantLinear):
        y = _qmm(x, w)
        return y.reshape(*x.shape[:-1], num_heads, -1)
    E, H, D = w.shape
    return (x.reshape(-1, E) @ w.reshape(E, H * D)).reshape(
        *x.shape[:-1], H, D)


def proj_out(o: torch.Tensor, w) -> torch.Tensor:
    """``[..., H, D] @ [H, D, E] -> [..., E]`` (the einsum
    ``...hd,hde->...e``) as one matrix product over views; ``torch.einsum``
    copies the permuted weight on every call for this contraction. A
    ``QuantLinear`` ``w`` holds ``[H*D, E]``."""
    if isinstance(w, QuantLinear):
        return _qmm(o.reshape(*o.shape[:-2], -1), w)
    H, D, E = w.shape
    return (o.reshape(-1, H * D) @ w.reshape(H * D, E)).reshape(
        *o.shape[:-2], E)


#: two-matrix FFN activations: ``gelu`` is the tanh approximation
#: (jax.nn.gelu's default), ``gelu_exact`` the erf form (torch's default)
_ACTS = {
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "gelu_exact": F.gelu,
    "relu": F.relu,
}


def dense_ffn(x: torch.Tensor, p, cfg: ModelConfig) -> torch.Tensor:
    """SwiGLU or two-matrix FFN over ``p`` (``w_gate``/``w_up``/``w_down``,
    plus ``b_up``/``b_down`` for the two-matrix form). ``QuantLinear``
    weights run the quantized-weight kernel, as the JAX engine's quantized
    FFN branch does."""
    dt = x.dtype

    def mm(h, w):
        return _qmm(h, w) if isinstance(w, QuantLinear) else h @ w.to(dt)

    if cfg.activation == "silu_glu":
        h = F.silu(mm(x, p["w_gate"])) * mm(x, p["w_up"])
        return mm(h, p["w_down"])
    h = _ACTS[cfg.activation](mm(x, p["w_up"]) + p["b_up"].to(dt))
    return mm(h, p["w_down"]) + p["b_down"].to(dt)


def add_shared_expert(out: torch.Tensor, x: torch.Tensor, p,
                      cfg: ModelConfig) -> torch.Tensor:
    """``out`` plus qwen2-moe's shared expert over ``p`` (an MoE layer's
    ``shared_expert`` FFN and ``shared_gate`` [E, 1]) when the config has
    one: ``out + sigmoid(x @ shared_gate) * shared_expert(x)``, the gate in
    fp32 and cast to out's dtype."""
    if not cfg.moe.shared_expert_intermediate:
        return out
    shared = dense_ffn(x, p["shared_expert"], cfg)
    g = torch.sigmoid(x.float() @ p["shared_gate"].float())
    return out + g.to(out.dtype) * shared


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------

def _fan_in(shape) -> int:
    """Fan-in as flax's variance_scaling computes it (in_axis=-2, the
    leading axes folded into the receptive field)."""
    return shape[-2] * math.prod(shape[:-2])


class _ParamFactory:
    """Creates a module's parameters on ``device`` in ``dtype`` from one
    seeded ``torch.Generator`` on that device (never through the host)."""

    def __init__(self, device: torch.device, dtype, seed: int):
        self.device, self.dtype = device, dtype
        self.gen = torch.Generator(device=device)
        self.gen.manual_seed(seed)

    def _p(self, t: torch.Tensor) -> nn.Parameter:
        return nn.Parameter(t.to(self.dtype), requires_grad=False)

    def normal(self, shape, std: float) -> nn.Parameter:
        t = torch.randn(shape, generator=self.gen, device=self.device,
                        dtype=torch.float32)
        return self._p(t.mul_(std))

    def dense(self, shape) -> nn.Parameter:
        """Variance-scaling (fan_in, scale 1) normal init."""
        return self.normal(shape, 1.0 / math.sqrt(_fan_in(shape)))

    def ones(self, shape) -> nn.Parameter:
        return self._p(torch.ones(shape, device=self.device))

    def zeros(self, shape) -> nn.Parameter:
        return self._p(torch.zeros(shape, device=self.device))


class Norm(nn.Module):
    def __init__(self, cfg: ModelConfig, pf: _ParamFactory):
        super().__init__()
        self.config = cfg
        self.scale = pf.ones((cfg.hidden_size,))
        if cfg.norm != "rmsnorm":
            self.bias = pf.zeros((cfg.hidden_size,))

    def forward(self, x):
        return norm(x, dict(self.named_parameters()), self.config)


class Attention(nn.Module):
    """Causal self-attention with GQA, RoPE or ALiBi (dense, no cache)."""

    def __init__(self, cfg: ModelConfig, pf: _ParamFactory):
        super().__init__()
        self.config = cfg
        E, H, KV, D = cfg.hidden_size, cfg.num_heads, cfg.kv_heads, cfg.head_dim
        self.wq = pf.dense((E, H, D))
        self.wk = pf.dense((E, KV, D))
        self.wv = pf.dense((E, KV, D))
        self.wo = pf.dense((H, D, E))
        if cfg.qkv_bias:
            self.bq = pf.zeros((H, D))
            self.bk = pf.zeros((KV, D))
            self.bv = pf.zeros((KV, D))
        if cfg.attn_out_bias:
            self.bo = pf.zeros((E,))

    def forward(self, x, positions):
        cfg = self.config
        dt = x.dtype
        q = proj_heads(x, self.wq.to(dt))
        k = proj_heads(x, self.wk.to(dt))
        v = proj_heads(x, self.wv.to(dt))
        if cfg.qkv_bias:
            q = q + self.bq.to(dt)
            k = k + self.bk.to(dt)
            v = v + self.bv.to(dt)
        if cfg.position_embedding == "rope":
            q, k = apply_rope(q, k, positions, cfg.rope_theta, cfg.rotary_pct)
        bias = None
        if cfg.position_embedding == "alibi":
            slopes = alibi_slopes(cfg.num_heads, device=x.device)
            k_pos = torch.arange(k.shape[1], device=x.device,
                                 dtype=torch.float32)
            rel = k_pos[None, None, None, :] - positions.float()[:, None, :, None]
            bias = slopes[None, :, None, None] * rel
        out = dot_product_attention(
            q, k, v, causal=cfg.causal, bias=bias, window=cfg.sliding_window,
            impl="xla" if (bias is not None or cfg.sliding_window)
            else cfg.attn_impl)
        out = proj_out(out, self.wo.to(dt))
        if cfg.attn_out_bias:
            out = out + self.bo.to(dt)
        return out


class DenseFFN(nn.Module):
    def __init__(self, cfg: ModelConfig, pf: _ParamFactory):
        super().__init__()
        self.config = cfg
        E, Fs = cfg.hidden_size, cfg.ffn_size
        if cfg.activation == "silu_glu":
            self.w_gate = pf.dense((E, Fs))
            self.w_up = pf.dense((E, Fs))
            self.w_down = pf.dense((Fs, E))
        else:
            self.w_up = pf.dense((E, Fs))
            self.w_down = pf.dense((Fs, E))
            self.b_up = pf.zeros((Fs,))
            self.b_down = pf.zeros((E,))

    def forward(self, x):
        return dense_ffn(x, dict(self.named_parameters()), self.config)


class MoEFFN(nn.Module):
    """Routed expert FFN (``moe_layer``, an ``moe.layer.MoE``) plus, when
    the config has one, the sigmoid-gated shared expert
    (``shared_expert``, ``shared_gate``)."""

    def __init__(self, cfg: ModelConfig, pf: _ParamFactory):
        super().__init__()
        self.config = cfg
        self.moe_layer = MoE(**moe_layer_kwargs(cfg), pf=pf)
        se = cfg.moe.shared_expert_intermediate
        if se:
            self.shared_expert = DenseFFN(
                dataclasses.replace(cfg, intermediate_size=se), pf)
            self.shared_gate = pf.dense((cfg.hidden_size, 1))

    def forward(self, x, noise_seed: int | None = None):
        """(output, the routed layer's loss)."""
        out, loss = self.moe_layer(x, noise_seed)
        if not self.config.moe.shared_expert_intermediate:
            return out, loss
        p = {"shared_expert": dict(self.shared_expert.named_parameters()),
             "shared_gate": self.shared_gate}
        return add_shared_expert(out, x, p, self.config), loss


class Block(nn.Module):
    """Pre-norm block; ``parallel_block`` runs attention and FFN off one
    (or, with ``parallel_block_norms=2``, two) norms of the same input.
    ``use_moe`` swaps the dense FFN (``ffn``) for :class:`MoEFFN`
    (``moe``)."""

    def __init__(self, cfg: ModelConfig, pf: _ParamFactory,
                 use_moe: bool = False):
        super().__init__()
        self.config = cfg
        self.ln_attn = Norm(cfg, pf)
        self.attn = Attention(cfg, pf)
        if not (cfg.parallel_block and cfg.parallel_block_norms == 1):
            self.ln_ffn = Norm(cfg, pf)
        if use_moe:
            self.moe = MoEFFN(cfg, pf)
        else:
            self.ffn = DenseFFN(dense_ffn_config(cfg), pf)

    def _ffn(self, h, noise_seed):
        """(FFN output, the MoE layer's loss or None for a dense FFN)."""
        if hasattr(self, "moe"):
            return self.moe(h, noise_seed)
        return self.ffn(h), None

    def forward(self, x, positions, noise_seed: int | None = None):
        """(the block's output, its MoE layer's loss or None)."""
        cfg = self.config
        h = self.ln_attn(x)
        attn_out = self.attn(h, positions)
        if cfg.parallel_block:
            h_ffn = h if cfg.parallel_block_norms == 1 else self.ln_ffn(x)
            out, loss = self._ffn(h_ffn, noise_seed)
            return x + attn_out + out, loss
        x = x + attn_out
        out, loss = self._ffn(self.ln_ffn(x), noise_seed)
        return x + out, loss


class TransformerLM(nn.Module):
    """The flagship causal LM. Parameters are created on ``device`` (the
    CUDA device by default; ``device="cpu"`` for the host) in
    ``param_dtype`` (default ``config.dtype``) from a ``torch.Generator``
    seeded with ``seed``.

    :meth:`forward` is the dense, non-paged forward — the training forward,
    and the oracle the serving engine's streams are held against."""

    def __init__(self, config: ModelConfig, *, device=None, seed: int = 0,
                 param_dtype=None):
        super().__init__()
        from ..accelerator import get_device

        check_served_family(config)
        self.config = cfg = config
        pf = _ParamFactory(get_device(device), param_dtype or cfg.dtype, seed)
        E, V = cfg.hidden_size, cfg.vocab_size
        self.embed = pf.normal((V, E), 0.02)
        if cfg.position_embedding == "learned":
            self.pos_embed = pf.normal((cfg.max_seq_len, E), 0.02)
        if cfg.embed_norm:
            self.ln_embed = Norm(cfg, pf)
        for i in range(cfg.num_layers):
            self.add_module(f"layer_{i}",
                            Block(cfg, pf, use_moe=is_moe_layer(cfg, i)))
        self.ln_final = Norm(cfg, pf)
        if not cfg.tie_embeddings:
            self.unembed = pf.normal((E, V), 0.02)
        if cfg.unembed_bias:
            self.unembed_b = pf.zeros((V,))
        self.eval()

    def forward(self, input_ids: torch.Tensor,
                positions: torch.Tensor | None = None, *,
                return_losses: bool = False, noise_seed: int | None = None):
        """input_ids [B, S] → logits [B, S, V] in ``config.dtype``; with
        ``return_losses`` → (logits, the MoE layers' fp32 losses in layer
        order). ``noise_seed`` seeds the RSample jitter of MoE layers that
        draw it in training mode (one seed per layer, drawn here, outside
        any checkpointed block)."""
        cfg = self.config
        dt = cfg.dtype
        B, S = input_ids.shape
        if positions is None:
            positions = torch.arange(S, device=input_ids.device).expand(B, S)
        x = self.embed.to(dt)[input_ids]
        if cfg.position_embedding == "learned":
            x = x + self.pos_embed.to(dt)[positions]
        if cfg.embed_norm:
            x = self.ln_embed(x)
        remat = cfg.remat and torch.is_grad_enabled()
        # remat=True always checkpoints; 'none' would contradict it
        policy = cfg.remat_policy if cfg.remat_policy != "none" else "full"
        seeds = [None] * cfg.num_layers
        if noise_seed is not None and self.training:
            gen = torch.Generator()
            gen.manual_seed(noise_seed)
            seeds = torch.randint(0, 2 ** 62, (cfg.num_layers,),
                                  generator=gen).tolist()
        losses = []
        for i in range(cfg.num_layers):
            block = getattr(self, f"layer_{i}")
            x, loss = (checkpoint_fn(block, policy) if remat else block)(
                x, positions, seeds[i])
            if loss is not None:
                losses.append(loss)
        x = self.ln_final(x)
        if cfg.tie_embeddings:
            logits = torch.einsum("bse,ve->bsv", x, self.embed.to(dt))
        else:
            logits = x @ self.unembed.to(dt)
        if cfg.unembed_bias:
            logits = logits + self.unembed_b.to(dt)
        return (logits, losses) if return_losses else logits
