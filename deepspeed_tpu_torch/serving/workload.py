"""Synthetic multi-tenant serving traces (seeded, fully deterministic).

The router bench and the chaos suite replay the SAME trace across
scenarios (baseline vs replica-killed vs shed-storm) so differences are
attributable to the fault, not the workload. Tenants model the
shared-prefix reality the placement policy exists for: each tenant owns
a system-prompt prefix (a page-aligned block of tokens all its requests
share), followed by a per-request unique suffix — exactly the shape that
makes prefix-cache-aware routing beat round-robin.
"""
from __future__ import annotations

import random
from dataclasses import dataclass, field

from .protocol import RequestRecord


@dataclass
class TraceConfig:
    n_requests: int = 48
    n_tenants: int = 4
    #: tokens of tenant-shared system prefix (page-align this to the
    #: replica block_size for full placement effect)
    prefix_len: int = 64
    suffix_min: int = 8
    suffix_max: int = 24
    max_new_tokens: int = 16
    vocab: int = 1024
    seed: int = 0
    #: fraction of requests at priority 1 (the rest are 0) — exercises
    #: the router's priority queues and overload victim selection
    high_priority_frac: float = 0.25
    tenants: list[str] = field(default_factory=list)


def synth_trace(cfg: TraceConfig | None = None) -> list[RequestRecord]:
    """Deterministic request list; round-robin tenant arrival order (the
    adversarial case for naive placement — consecutive requests never
    share a prefix, so only chain-hash routing co-locates them)."""
    cfg = cfg or TraceConfig()
    rng = random.Random(cfg.seed)
    tenants = cfg.tenants or [f"tenant{i}" for i in range(cfg.n_tenants)]
    prefixes = {t: [rng.randrange(cfg.vocab) for _ in range(cfg.prefix_len)]
                for t in tenants}
    out: list[RequestRecord] = []
    for i in range(cfg.n_requests):
        t = tenants[i % len(tenants)]
        suffix = [rng.randrange(cfg.vocab) for _ in range(
            rng.randint(cfg.suffix_min, cfg.suffix_max))]
        out.append(RequestRecord(
            trace_id=f"t{cfg.seed}-{i}",
            prompt=prefixes[t] + suffix,
            max_new_tokens=cfg.max_new_tokens,
            tenant=t,
            priority=1 if rng.random() < cfg.high_priority_frac else 0))
    return out
