"""Mixture-of-Experts (counterpart of ``deepspeed_tpu/moe/``)."""
from .layer import Experts, MoE, TopKGate, moe_forward  # noqa: F401
from .sharded_moe import (  # noqa: F401
    DroplessGateOutput,
    GateOutput,
    compute_capacity,
    top1gating,
    top2gating,
    topk_dropless_gating,
    topkgating,
)
