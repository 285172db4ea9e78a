"""The ZeRO plan: which state is partitioned, and where every element of
it lives.

Counterpart of ``deepspeed_tpu/runtime/zero/planner.py`` (``build_plan``,
:171-233). The JAX planner gives each tensor a sharding over the ``fsdp``
axis and lets XLA place the collectives. This one lays the state out
DeepSpeed's way, over the ``data`` x ``fsdp`` group of N processes:

- stage 0: nothing partitioned;
- stage 1: the fp32 master and the optimizer's moments;
- stage 2: + the fp32 gradients (reduce-scattered);
- stage 3: + the compute parameters, except tensors of fewer than
  ``stage3_param_persistence_threshold`` elements (the JAX planner's
  ``_add_fsdp(min_size=...)``, :136-158), which stay whole on every rank.

Parameters are grouped into units (one per transformer block, and a root
unit for everything else: embeddings, final norm, unembedding), and each
unit into segments: at stage 3 its persistent (small) and its partitioned
(large) tensors; below, one segment. A segment is one flat buffer, padded
at its end to a multiple of N, in which rank r owns the r-th of N equal
chunks; a tensor may straddle two ranks. A rank's partition is its chunks
of every segment, in segment order, back to back.

The geometry is not the JAX planner's (largest divisible dimension): only
the arithmetic and a checkpoint's logical content must agree, and they do.

The tensor half (:func:`tensor_spec`, :func:`tp_kind`, :func:`tensor_plan`)
is the JAX planner's logical-axis translation for the ``tensor`` axis: each
parameter of a ``TransformerLM`` tree carries the logical names the JAX
model zoo gives it (``nn.with_partitioning``), ``DEFAULT_LOGICAL_RULES``
put vocab, heads, kv_heads, mlp and expert_mlp on ``tensor``, and a dim
that does not divide the axis stays whole (the JAX planner's replicate
fallback). The serving engine reads each weight's kind from it: ``col``
(output columns sharded), ``row`` (contraction sharded, followed by a sum
over the axis) or ``rep``.
"""
from __future__ import annotations

import math
import re
from dataclasses import dataclass, field

_BLOCK = re.compile(r"^layer_(\d+)$")


@dataclass
class Segment:
    """One flat buffer: ``params`` (indices into the engine's parameter
    list) at ``offsets``, ``numel`` elements, ``chunk`` per rank (the
    padded size is ``chunk * world``), this rank's chunk at
    ``part_offset`` of its partition. ``persistent`` segments keep their
    compute parameters whole on every rank."""
    unit: int
    params: list[int]
    offsets: list[int]
    numels: list[int]
    numel: int
    chunk: int
    padded: int                     # chunk * world
    part_offset: int
    persistent: bool


@dataclass
class ZeroPlan:
    stage: int
    world: int
    rank: int
    names: list[str]
    shapes: list[tuple[int, ...]]
    units: list[list[int]]          # unit -> segment indices
    unit_keys: list[int | None]     # unit -> its block's index, None: root
    segments: list[Segment]
    partition_numel: int            # this rank's partition: sum of chunks
    threshold: int
    where: dict[int, tuple[int, int]] = field(default_factory=dict)
    # param index -> (segment index, position in the segment)

    def partitioned(self, kind: str, name: str) -> bool:
        """Whether ``kind`` ("param", "master" or "grad") state of parameter
        ``name`` is partitioned over the group."""
        if kind == "master":
            return self.stage >= 1
        if kind == "grad":
            return self.stage >= 2
        if kind == "param":
            i = self.names.index(name)
            return self.stage >= 3 and \
                math.prod(self.shapes[i]) >= self.threshold
        raise ValueError(f"unknown state kind {kind!r}")

    def segment_of(self, i: int) -> Segment:
        return self.segments[self.where[i][0]]

    def pieces(self, i: int, rank: int | None = None
               ) -> list[tuple[int, int, int]]:
        """The elements of parameter ``i`` that ``rank`` (this one by
        default) owns: ``(start in the flattened parameter, length, offset
        in the rank's partition)``, at most one piece."""
        rank = self.rank if rank is None else rank
        s, k = self.where[i]
        seg = self.segments[s]
        o, n, c = seg.offsets[k], seg.numels[k], seg.chunk
        lo, hi = max(o, rank * c), min(o + n, (rank + 1) * c)
        if lo >= hi:
            return []
        return [(lo - o, hi - lo, seg.part_offset + lo - rank * c)]

    def describe(self) -> str:
        big = sum(not s.persistent for s in self.segments)
        return (f"zero plan: stage={self.stage} world={self.world} "
                f"units={len(self.units)} segments={len(self.segments)} "
                f"(partitioned parameters in {big}) partition="
                f"{self.partition_numel} elements")


def unit_of(name: str) -> int | None:
    """The transformer block a parameter belongs to (its ``layer_<i>``
    prefix), or None for the root unit."""
    m = _BLOCK.match(name.split(".", 1)[0])
    return int(m.group(1)) if m else None


def build_plan(stage: int, names: list[str], shapes: list[tuple[int, ...]],
               world: int = 1, rank: int = 0,
               persistence_threshold: int = 100_000) -> ZeroPlan:
    """The plan for parameters ``names`` / ``shapes`` (the engine's order)
    at ``stage`` over ``world`` ranks (see the module docstring). Units are
    ordered by first appearance: for a ``TransformerLM`` the root unit
    (whose embedding comes first), then the blocks."""
    if stage not in (0, 1, 2, 3):
        raise ValueError(f"ZeRO stage must be 0-3, got {stage}")
    unit_keys: list = []
    members: dict = {}
    for i, n in enumerate(names):
        key = unit_of(n)
        if key not in members:
            unit_keys.append(key)
            members[key] = []
        members[key].append(i)
    segments: list[Segment] = []
    units: list[list[int]] = []
    where: dict[int, tuple[int, int]] = {}
    part = 0
    for u, key in enumerate(unit_keys):
        idx = members[key]
        if stage >= 3:
            small = [i for i in idx
                     if math.prod(shapes[i]) < persistence_threshold]
            big = [i for i in idx if i not in small]
            groups = [(small, True), (big, False)]
        else:
            groups = [(idx, True)]
        units.append([])
        for params, persistent in groups:
            if not params:
                continue
            numels = [math.prod(shapes[i]) for i in params]
            offsets = [sum(numels[:k]) for k in range(len(numels))]
            total = sum(numels)
            chunk = -(-total // world)
            seg = Segment(unit=u, params=params, offsets=offsets,
                          numels=numels, numel=total, chunk=chunk,
                          padded=chunk * world, part_offset=part,
                          persistent=persistent)
            for k, i in enumerate(params):
                where[i] = (len(segments), k)
            units[-1].append(len(segments))
            segments.append(seg)
            part += chunk
    return ZeroPlan(stage=stage, world=world, rank=rank, names=list(names),
                    shapes=[tuple(s) for s in shapes], units=units,
                    unit_keys=unit_keys, segments=segments, partition_numel=part,
                    threshold=persistence_threshold, where=where)


# ---------------------------------------------------------------------------
# the tensor half: TP specs of a TransformerLM tree
# ---------------------------------------------------------------------------

#: logical axis -> mesh axis (the JAX planner's ``DEFAULT_LOGICAL_RULES``)
LOGICAL_RULES = {"vocab": "tensor", "heads": "tensor", "kv_heads": "tensor",
                 "mlp": "tensor", "expert": "expert",
                 "expert_mlp": "tensor", "pipe_layers": "pipe"}

_ATTN_AXES = {"wq": ("embed", "heads", "head_dim"),
              "wk": ("embed", "kv_heads", "head_dim"),
              "wv": ("embed", "kv_heads", "head_dim"),
              "wo": ("heads", "head_dim", "embed"),
              "bq": ("heads", "head_dim"), "bk": ("kv_heads", "head_dim"),
              "bv": ("kv_heads", "head_dim"), "bo": ("embed",)}
_FFN_AXES = {"w_gate": ("embed", "mlp"), "w_up": ("embed", "mlp"),
             "w_down": ("mlp", "embed"), "b_up": ("mlp",),
             "b_down": ("embed",)}
_EXPERT_AXES = {"w_gate": ("expert", "embed", "expert_mlp"),
                "w_up": ("expert", "embed", "expert_mlp"),
                "w_down": ("expert", "expert_mlp", "embed")}
_ROOT_AXES = {"embed": ("vocab", "embed"), "pos_embed": (None, "embed"),
              "type_embed": (None, "embed"), "unembed": ("embed", "vocab"),
              "unembed_b": ("vocab",)}


def logical_axes(path: tuple[str, ...]) -> tuple:
    """The JAX model zoo's logical axis names of the parameter at ``path``
    (its keys in a ``TransformerLM`` tree)."""
    leaf = path[-1]
    parent = path[-2] if len(path) > 1 else ""
    if parent == "attn" and leaf in _ATTN_AXES:
        return _ATTN_AXES[leaf]
    if parent == "experts" and leaf in _EXPERT_AXES:
        return _EXPERT_AXES[leaf]
    if parent in ("ffn", "shared_expert") and leaf in _FFN_AXES:
        return _FFN_AXES[leaf]
    if parent == "gate" and leaf == "wg":
        return ("embed", "expert")
    if leaf == "shared_gate":
        return ("embed", None)
    if parent.startswith("ln_") and leaf in ("scale", "bias"):
        return ("embed",)
    if len(path) == 1 and leaf in _ROOT_AXES:
        return _ROOT_AXES[leaf]
    raise ValueError(f"no logical axes for parameter {'/'.join(path)}")


def tensor_spec(path: tuple[str, ...], shape: tuple[int, ...],
                axis_sizes: dict[str, int]) -> tuple:
    """The mesh axes of each dim of the parameter at ``path`` (the JAX
    planner's ``_translate_logical``): an axis of size 1, or one the dim
    does not divide, leaves the dim whole (None)."""
    out = []
    for name, d in zip(logical_axes(path), shape):
        axis = LOGICAL_RULES.get(name) if name else None
        size = axis_sizes.get(axis, 1) if axis else 1
        out.append(axis if size > 1 and d % size == 0 else None)
    return tuple(out)


def tp_kind(spec: tuple) -> str:
    """The JAX engine's ``_tp_kind`` of a spec: ``row`` when the first dim
    is on ``tensor``, ``col`` when a later one is, else ``rep``."""
    if spec and spec[0] == "tensor":
        return "row"
    return "col" if "tensor" in spec[1:] else "rep"


def weight_kind(path: tuple[str, ...], spec: tuple) -> str:
    """The TP kind the serving engine gives a weight: routed-expert slabs
    ``[n, K, N]`` by their ``[K, N]`` dims (the expert dim is never on
    ``tensor`` in serving), every other parameter by :func:`tp_kind`."""
    return tp_kind(spec[1:] if "experts" in path else spec)


def tensor_plan(tree: dict, axis_sizes: dict[str, int],
                prefix: tuple[str, ...] = ()) -> dict:
    """``{path: (spec, kind)}`` for every tensor of ``tree``."""
    out = {}
    for k, v in tree.items():
        path = prefix + (k,)
        if isinstance(v, dict):
            out.update(tensor_plan(v, axis_sizes, path))
        else:
            spec = tensor_spec(path, tuple(v.shape), axis_sizes)
            out[path] = (spec, weight_kind(path, spec))
    return out


def tensor_shard(t, spec: tuple, rank: int, n: int):
    """This rank's slice of the whole tensor ``t`` under ``spec`` (a view;
    the tensor itself when no dim is on ``tensor``)."""
    if "tensor" not in spec:
        return t
    d = spec.index("tensor")
    c = t.shape[d] // n
    return t.narrow(d, rank * c, c)
