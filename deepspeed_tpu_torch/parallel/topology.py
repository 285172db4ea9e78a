"""Device mesh topology over processes.

Counterpart of ``deepspeed_tpu/parallel/topology.py``: the same named axes
(``pipe``, ``data``, ``expert``, ``fsdp``, ``seq``, ``tensor``), the same
:class:`MeshConfig` (sizes per axis, at most one ``"auto"``), ``size(axis)``
and the world sizes derived from them. The JAX mesh lays devices out
row-major in ``AXIS_ORDER``; here one process drives one device, and
process ``rank`` sits at the same coordinates (``coords``). Each axis, and
the data-parallel set ``("data", "expert", "fsdp")``, has its own
``torch.distributed`` group: the processes that share every other
coordinate (NCCL on the card, gloo on the CPU).

``data`` and ``fsdp`` may exceed 1: ZeRO partitions over their product.
``tensor`` may exceed 1 for serving (``inference/engine_v2.py`` shards its
forward over the tensor group, one rank per process) and for training
(the model's Megatron layers over the tensor group, ``runtime/engine.py``).
``seq`` may exceed 1 for training: each row's tokens split
over the seq group (``parallel/sequence.py``, ``runtime/engine.py``), whose
statistics span the batch group ``BATCH_AXES`` (the data-parallel axes and
``seq``), which has a group of its own too. ``pipe`` and ``expert`` larger
than 1 raise NotImplementedError: pipeline and expert parallelism are
ROADMAP queue 1, item 6c.

``parallel/axes.py`` (flax logical axis constraints) has no counterpart:
the port places no tensor by logical axis names.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Sequence

AXIS_ORDER = ("pipe", "data", "expert", "fsdp", "seq", "tensor")
#: the data-parallel axes: the ZeRO partition count is their product
DP_AXES = ("data", "expert", "fsdp")
#: the axes a training batch's tokens are split over: the data-parallel
#: axes (rows) and ``seq`` (each row's positions)
BATCH_AXES = DP_AXES + ("seq",)
#: axes whose parallelism comes with a later slice
LATER_AXES = ("pipe", "expert")


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


def _world() -> tuple[int, int]:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class MeshTopology:
    """The named axes over the processes of the default group (one process
    when none is up). The mesh must use every process: a run on fewer
    processes than the world is started with fewer processes."""

    def __init__(self, config: MeshConfig | dict | None = None):
        if isinstance(config, dict) or config is None:
            config = MeshConfig.from_dict(config)
        self.config = config
        self.rank, self.world_size = _world()
        # a later axis given a size refuses before the sizes must resolve;
        # one made "auto" refuses once it resolves above 1
        big = {a: v for a in LATER_AXES
               if (v := getattr(config, a)) not in ("auto", -1, None)
               and int(v) > 1}
        if not big:
            self.axis_sizes = config.resolve(self.world_size)
            big = {a: self.axis_sizes[a] for a in LATER_AXES
                   if self.axis_sizes[a] > 1}
        if big:
            raise NotImplementedError(
                f"mesh axes {big}: pipeline and expert parallelism are "
                f"ported with ROADMAP queue 1, item 6c; data, fsdp, seq "
                f"and tensor may exceed 1")
        used = math.prod(self.axis_sizes.values())
        if used != self.world_size:
            raise ValueError(f"mesh {self.axis_sizes} uses {used} devices "
                             f"but the world has {self.world_size} processes")
        self.coords = self._coords(self.rank)
        self._groups: dict[tuple[str, ...], Any] = {}
        if self.world_size > 1:
            for axes in [(a,) for a in AXIS_ORDER] + [DP_AXES, BATCH_AXES]:
                self._groups[axes] = self._make_group(axes)

    def _coords(self, rank: int) -> dict[str, int]:
        out, rest = {}, rank
        for a in reversed(AXIS_ORDER):
            rest, out[a] = divmod(rest, self.axis_sizes[a])
        return {a: out[a] for a in AXIS_ORDER}

    def _make_group(self, axes: tuple[str, ...]):
        """The group of the processes that share this one's coordinates on
        every axis outside ``axes`` (created on every process, in one
        order: ``new_subgroups_by_enumeration`` makes them all)."""
        import torch.distributed as dist

        slices: dict[tuple, list[int]] = {}
        for r in range(self.world_size):
            c = self._coords(r)
            key = tuple(c[a] for a in AXIS_ORDER if a not in axes)
            slices.setdefault(key, []).append(r)
        group, _ = dist.new_subgroups_by_enumeration(list(slices.values()))
        return group

    @staticmethod
    def _key(axis_name: str | Sequence[str]) -> tuple[str, ...]:
        names = (axis_name,) if isinstance(axis_name, str) else tuple(axis_name)
        bad = set(names) - set(AXIS_ORDER)
        if bad:
            raise ValueError(f"unknown mesh axes {sorted(bad)}")
        return tuple(a for a in AXIS_ORDER if a in names)

    def group(self, axis_name: str | Sequence[str]):
        """The process group of one axis, of ``DP_AXES`` or of
        ``BATCH_AXES``; None (the default group) in a world of one."""
        key = self._key(axis_name)
        if self.world_size == 1:
            return None
        if key in self._groups:
            return self._groups[key]
        # a subset of the data-parallel (or batch) axes whose other
        # members are all of size 1 spans the same processes
        for axes in (DP_AXES, BATCH_AXES):
            if set(key) <= set(axes) and all(
                    self.axis_sizes[a] == 1 for a in axes if a not in key):
                return self._groups[axes]
        raise ValueError(f"no process group for axes {key} (groups: each "
                         f"axis, {DP_AXES} and {BATCH_AXES})")

    def size(self, axis: str) -> int:
        return self.axis_sizes[axis]

    def rank_in(self, axis: str | Sequence[str]) -> int:
        """This process's index along ``axis`` (row-major over a tuple)."""
        idx = 0
        for a in self._key(axis):
            idx = idx * self.axis_sizes[a] + self.coords[a]
        return idx

    @property
    def dp_world_size(self) -> int:
        """Reference data-parallel world (= ZeRO partition count)."""
        return self.size("data") * self.size("expert") * self.size("fsdp")

    @property
    def dp_rank(self) -> int:
        return self.rank_in(DP_AXES)

    @property
    def dp_group(self):
        return self.group(DP_AXES)

    def __repr__(self) -> str:
        return f"MeshTopology({self.axis_sizes}, rank={self.rank})"


def single_device_topology() -> MeshTopology:
    return MeshTopology(MeshConfig(data=1))
