"""Device mesh topology of one process.

Counterpart of ``deepspeed_tpu/parallel/topology.py``: the same named axes
(``pipe``, ``data``, ``expert``, ``fsdp``, ``seq``, ``tensor``), the same
:class:`MeshConfig` (sizes per axis, at most one ``"auto"``), ``size(axis)``
and the world sizes derived from them. The one-process training engine runs
on one device, so every axis resolves to 1: a configured axis larger than 1
raises NotImplementedError, since parallel axes over several processes
(``torch.distributed``, NCCL on the card and gloo on the CPU) are ported
with training part B (ROADMAP queue 1, item 2).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

AXIS_ORDER = ("pipe", "data", "expert", "fsdp", "seq", "tensor")


@dataclass
class MeshConfig:
    """Sizes per axis; ``-1``/``"auto"`` on at most one axis absorbs the
    remaining devices."""
    pipe: int = 1
    data: int | str = "auto"
    expert: int = 1
    fsdp: int = 1
    seq: int = 1
    tensor: int = 1

    @classmethod
    def from_dict(cls, d: dict[str, Any] | None) -> "MeshConfig":
        d = dict(d or {})
        known = {f for f in cls.__dataclass_fields__}
        unknown = set(d) - known
        if unknown:
            raise ValueError(f"unknown mesh axes: {sorted(unknown)} (known: {sorted(known)})")
        return cls(**d)

    def resolve(self, num_devices: int) -> dict[str, int]:
        sizes: dict[str, int] = {}
        auto_axes = []
        for name in AXIS_ORDER:
            v = getattr(self, name)
            if v in ("auto", -1, None):
                auto_axes.append(name)
            else:
                v = int(v)
                if v < 1:
                    raise ValueError(f"mesh axis {name} must be >= 1, got {v}")
                sizes[name] = v
        fixed = math.prod(sizes.values()) if sizes else 1
        if len(auto_axes) > 1:
            raise ValueError(f"only one mesh axis may be 'auto', got {auto_axes}")
        if auto_axes:
            if num_devices % fixed != 0:
                raise ValueError(
                    f"device count {num_devices} not divisible by fixed mesh product {fixed}")
            sizes[auto_axes[0]] = num_devices // fixed
        elif fixed > num_devices:
            raise ValueError(
                f"mesh product {fixed} > device count {num_devices}; "
                f"set one axis to 'auto' or fix the sizes")
        return {name: sizes[name] for name in AXIS_ORDER}


class MeshTopology:
    """The named axes of a one-process, one-device run. Raises
    NotImplementedError for an axis larger than 1 (training part B)."""

    def __init__(self, config: MeshConfig | dict | None = None):
        if isinstance(config, dict) or config is None:
            config = MeshConfig.from_dict(config)
        self.config = config
        big = {a: getattr(config, a) for a in AXIS_ORDER
               if getattr(config, a) not in ("auto", -1, None)
               and int(getattr(config, a)) > 1}
        if big:
            raise NotImplementedError(
                f"mesh axes {big}: parallel axes over several processes are "
                f"ported with training part B (ZeRO over torch.distributed; "
                f"ROADMAP queue 1, item 2)")
        self.axis_sizes = config.resolve(1)

    def size(self, axis: str) -> int:
        return self.axis_sizes[axis]

    @property
    def dp_world_size(self) -> int:
        """Reference data-parallel world (= ZeRO partition count)."""
        return self.size("data") * self.size("expert") * self.size("fsdp")

    def __repr__(self) -> str:
        return f"MeshTopology({self.axis_sizes})"


def single_device_topology() -> MeshTopology:
    return MeshTopology(MeshConfig(data=1))
