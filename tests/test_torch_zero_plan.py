"""The port's ZeRO plan (``runtime/zero/planner.py``) against the JAX
package's (``tests/test_zero_plan.py``): which state each stage partitions
— nothing at stage 0, the master from stage 1, the gradients from stage 2,
the compute parameters from stage 3 except those below the persistence
threshold — and the flat layout: every element of every parameter owned by
exactly one rank for N = 1, 2, 3 and 8, the padding at each segment's
end."""
import math

import numpy as np
import pytest

from deepspeed_tpu_torch.runtime.zero.planner import build_plan, unit_of

SHAPES = {"big_kernel": (1024, 512), "small_bias": (512,),
          "head_kernel": (1024, 8, 64)}


def _plan(stage, world=8, **kw):
    return build_plan(stage, list(SHAPES), list(SHAPES.values()),
                      world=world, **kw)


def _jax_sharded(stage):
    """{kind: {name: sharded?}} of the JAX planner at fsdp 8."""
    import flax.linen as nn
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from deepspeed_tpu.config import ZeroConfig
    from deepspeed_tpu.parallel.topology import MeshTopology
    from deepspeed_tpu.runtime.zero.planner import build_plan as jax_plan

    names = {"big_kernel": ("embed", "mlp"), "small_bias": ("mlp",),
             "head_kernel": ("embed", "heads", "head_dim")}
    params = {k: nn.Partitioned(jax.ShapeDtypeStruct(s, jnp.float32),
                                names=names[k]) for k, s in SHAPES.items()}
    plan = jax_plan(MeshTopology({"fsdp": 8}), ZeroConfig(stage=stage),
                    params)
    on = lambda spec: any(e is not None for e in spec)
    return {kind: {k: on(v) for k, v in specs.items()}
            for kind, specs in (("param", plan.param_specs),
                                ("master", plan.master_specs),
                                ("grad", plan.grad_specs))}


def _port_sharded(plan):
    return {kind: {k: plan.partitioned(kind, k) for k in SHAPES}
            for kind in ("param", "master", "grad")}


def test_stage0_all_replicated():
    plan = _plan(0)
    assert not any(v for d in _port_sharded(plan).values() for v in d.values())
    assert _port_sharded(plan) == _jax_sharded(0)


def test_stage1_masters_partitioned_params_replicated():
    plan = _plan(1)
    got = _port_sharded(plan)
    assert got["master"]["big_kernel"] and not got["param"]["big_kernel"]
    assert not got["grad"]["big_kernel"]      # all-reduced at stage 1
    assert got == _jax_sharded(1)


def test_stage2_grads_partitioned():
    plan = _plan(2)
    got = _port_sharded(plan)
    assert got["grad"]["big_kernel"] and not got["param"]["big_kernel"]
    assert got == _jax_sharded(2)


def test_stage3_params_partitioned_small_replicated():
    plan = _plan(3)
    got = _port_sharded(plan)
    assert got["param"]["big_kernel"] and got["param"]["head_kernel"]
    assert not got["param"]["small_bias"]     # below the threshold
    assert got["master"]["small_bias"]        # its master still partitions
    assert got == _jax_sharded(3)
    # the small tensor lives in a persistent segment, the big ones not
    assert plan.segment_of(1).persistent
    assert not plan.segment_of(0).persistent


def test_persistence_threshold():
    # a threshold above every tensor keeps them all whole; at 0 none is
    assert not any(_plan(3, persistence_threshold=10 ** 7).partitioned(
        "param", k) for k in SHAPES)
    assert all(_plan(3, persistence_threshold=0).partitioned("param", k)
               for k in SHAPES)
    assert all(s.persistent for s in _plan(2).segments)


@pytest.mark.parametrize("world", [1, 2, 3, 8])
@pytest.mark.parametrize("stage", [1, 3])
def test_flat_ranges_cover_every_element_once(world, stage):
    """Odd sizes so tensors straddle ranks; every element of every tensor
    owned once; each rank's pieces tile its partition with the padding at
    each segment's end."""
    names = ["embed", "layer_0.attn.wq", "layer_0.ln.scale",
             "layer_1.attn.wq", "layer_1.ln.scale", "ln_final.scale"]
    shapes = [(37, 5), (13, 11), (7,), (13, 11), (7,), (3,)]
    plans = [build_plan(stage, names, shapes, world=world, rank=r,
                        persistence_threshold=50) for r in range(world)]
    for i, shape in enumerate(shapes):
        owned = np.zeros(math.prod(shape), np.int32)
        for r, plan in enumerate(plans):
            for start, ln, po in plan.pieces(i):
                owned[start:start + ln] += 1
                assert 0 <= po and po + ln <= plan.partition_numel
        assert (owned == 1).all(), (names[i], owned)
    for plan in plans:
        assert plan.partition_numel == sum(s.chunk for s in plan.segments)
        for seg in plan.segments:
            assert seg.padded == seg.chunk * world >= seg.numel
            assert seg.padded - seg.numel < world   # padding only at the end
            assert seg.offsets == sorted(seg.offsets)
            assert seg.offsets[-1] + seg.numels[-1] == seg.numel
    # units: the root (embed, ln_final) and one per block
    assert [unit_of(n) for n in names] == [None, 0, 0, 1, 1, None]
    assert plans[0].unit_keys == [None, 0, 1]
