"""The port's tensor-parallel pieces against the JAX package's, on the CPU.

- ``parallel/tensor.py``: ``allgather_matmul``, ``matmul_reduce_scatter``
  and ``ring_row_matmul`` (values and gradients) for n in {1, 2, 4} with
  bf16 / int8 / fp8 weights, each against the JAX primitive on a
  ``("tensor",)`` mesh of n CPU devices and the same numpy inputs (the
  cases of ``tests/test_tensor_parallel.py``): the fused multi-weight ring,
  the ``ValueError``\\ s and the fallback and ring counters. The port's
  ranks are gloo processes (``comm.spawn.RankPool``), each given its shards.
- ``runtime/zero/planner.py``'s tensor half: every parameter's TP kind
  equals the JAX engine's ``_tp_kind`` of the JAX ``build_plan`` spec.
- per-shard quantization: int8 / int4 / fp8 codes and scales of every
  shard, bit for bit the JAX engine's ``shard_map(quantize_weight)`` /
  ``shard_map(quantize_grouped)``.
- ``weights.load_tp_params``: a rank's slices of a meta model equal the
  slices of the seeded model's own weights.

Tolerances: fp32 products agree to 2e-5 (one rounding of the fp32 sums,
accumulated in another order), bf16 outputs to one bf16 step of the
largest (2e-2 relative), gradients to 1e-4 as the JAX test holds them."""
import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.comm.spawn import RankPool

pytestmark = pytest.mark.multiprocess

M, K, N = 32, 64, 256


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def pools(tmp_path_factory):
    made = {n: RankPool(n, str(tmp_path_factory.mktemp(f"tp{n}")))
            for n in (2, 4)}
    yield made
    for p in made.values():
        p.close()


def _run(pools, n, fn, *args):
    """fn(*args) on every rank of an n-rank tensor group (n = 1: here)."""
    if n == 1:
        return [fn(*args)]
    return pools[n].run(fn, *args)


def _inputs(seed=0, M=M, K=K, N=N):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((M, K)).astype(np.float32)
    w = (rng.standard_normal((K, N)) / K ** 0.5).astype(np.float32)
    return x, w


# --- run on every rank ----------------------------------------------------

def _setup(n):
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.ops.quant_matmul import counts
    from deepspeed_tpu_torch.parallel import tensor as ring
    from deepspeed_tpu_torch.parallel.topology import MeshTopology

    if n > 1:
        comm.set_topology(MeshTopology({"tensor": n}))
    ring.overlap_counters.reset()
    counts.reset()
    return (comm.axis_index("tensor") if n > 1 else 0), ring


def _counted(ring):
    """The ring counters, the ring's local products by kernel and K2's
    calls (its plain version on the CPU)."""
    from deepspeed_tpu_torch.ops.quant_matmul import counts

    return dict(ring.overlap_counters.snapshot(),
                products=ring.overlap_counters.products_snapshot(),
                k2_calls=counts.plain)


def _weight(w, wq, kind, r, n):
    """This rank's shard of w (cols for ``col``, rows for ``row``), plain
    or quantized on its own."""
    from deepspeed_tpu_torch.ops.quant_matmul import quantize_weight

    t = torch.as_tensor(w)
    t = t.chunk(n, dim=1 if kind == "col" else 0)[r].contiguous()
    if wq in ("bf16", "f32"):
        return t.bfloat16() if wq == "bf16" else t
    return quantize_weight(t, bits=8 if wq == "int8" else "fp8",
                           shard=n > 1)


def _agmm(n, x, w, wq):
    r, ring = _setup(n)
    xt = torch.as_tensor(x).chunk(n, dim=0)[r].contiguous()
    if wq == "bf16":
        xt = xt.bfloat16()
    y = ring.allgather_matmul(xt, _weight(w, wq, "col", r, n))
    return y.float(), _counted(ring)


def _mmrs(n, x, w, wq):
    r, ring = _setup(n)
    xt = torch.as_tensor(x).chunk(n, dim=1)[r].contiguous()
    if wq == "bf16":
        xt = xt.bfloat16()
    y = ring.matmul_reduce_scatter(xt, _weight(w, wq, "row", r, n))
    return y.float(), _counted(ring)


def _fused(n, x, w1, w2):
    r, ring = _setup(n)
    xt = torch.as_tensor(x).chunk(n, dim=0)[r].contiguous()
    ya, yb = ring.allgather_matmul(
        xt, (_weight(w1, "f32", "col", r, n), _weight(w2, "f32", "col", r,
                                                      n)))
    return ya, yb


def _row_grads(n, x, w):
    r, ring = _setup(n)
    xt = torch.as_tensor(x).chunk(n, dim=-1)[r].contiguous() \
        .requires_grad_(True)
    wt = torch.as_tensor(w).chunk(n, dim=0)[r].contiguous() \
        .requires_grad_(True)
    y = ring.ring_row_matmul(xt, wt, lead_specs=(None, None))
    (y ** 2).sum().backward()
    return (y.detach(), xt.grad, wt.grad,
            ring.overlap_counters.snapshot())


def _row_fallback(n):
    r, ring = _setup(n)
    # contraction slices that disagree, then rows that do not divide
    a = ring.ring_row_matmul(torch.ones(2, 4, 16), torch.ones(15, 8))
    b = ring.ring_row_matmul(torch.ones(1, 3, 16), torch.ones(16, 8))
    snap1 = ring.overlap_counters.snapshot()
    got = ring.ring_row_matmul(torch.ones(2, 4, 32 // n), torch.ones(
        32 // n, 8))
    return a is None, b is None, snap1, got, ring.overlap_counters.snapshot()


def _errors(n):
    r, ring = _setup(n)
    out = []
    for fn, args in (
            (ring.allgather_matmul, (torch.ones(2, 3, 4), torch.ones(4, 8))),
            (ring.allgather_matmul, (torch.ones(4, 64), torch.ones(32, 8))),
            (ring.allgather_matmul, (torch.ones(4, 64),
                                     torch.ones(64, 2, 4))),
            (ring.matmul_reduce_scatter, (torch.ones(33, 16),
                                          torch.ones(16, 8))),
            (ring.matmul_reduce_scatter, (torch.ones(32, 16),
                                          torch.ones(8, 8)))):
        try:
            fn(*args)
            out.append("")
        except ValueError as e:
            out.append(str(e))
    return out


# --- the JAX side -----------------------------------------------------------

def _jax_mesh(n):
    import jax
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()[:n]), ("tensor",))


def _jax_quantized(w, mesh, bits, kind):
    import jax
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from deepspeed_tpu.ops.pallas.quant_matmul import quantize_weight

    if mesh.shape["tensor"] == 1:
        return quantize_weight(w, bits=bits)
    ws = P(None, "tensor") if kind == "col" else P("tensor", None)
    return jax.jit(shard_map(lambda wl: quantize_weight(wl, bits=bits),
                             mesh=mesh, in_specs=(ws,), out_specs=ws,
                             check_vma=False))(w)


def _jax_product(fn, x, w, n, wq, kind):
    """The JAX primitive, jitted (its shard_map runs op by op otherwise,
    ten times slower here)."""
    import jax
    import jax.numpy as jnp

    mesh = _jax_mesh(n)
    if wq == "bf16":
        return np.asarray(jax.jit(lambda a, b: fn(a, b, mesh))(
            jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16)),
            np.float32)
    bits = 8 if wq == "int8" else "fp8"
    # the JAX package's XLA dequant-dot route (its Pallas kernel in
    # interpret mode computes the same products, ten times slower here)
    return np.asarray(jax.jit(lambda a, b: fn(a, b, mesh, small_m_xla=True))(
        jnp.asarray(x), _jax_quantized(jnp.asarray(w), mesh, bits, kind)))


def _close(got, ref, wq):
    if wq == "bf16":
        err = np.abs(got - ref).max() / np.abs(ref).max()
        assert err <= 2e-2, err
    else:
        np.testing.assert_allclose(got, ref, rtol=2e-5, atol=2e-5)


# --- ring primitives --------------------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("wq", ["bf16", "int8", "fp8"])
def test_allgather_matmul_matches_jax(pools, n, wq):
    from deepspeed_tpu.parallel import tensor as jring

    x, w = _inputs()
    ref = _jax_product(jring.allgather_matmul, x, w, n, wq, "col")
    outs = _run(pools, n, _agmm, n, x, w, wq)
    got = np.concatenate([o[0] for o in outs], axis=1)
    assert all(o[0].shape == (M, N // n) for o in outs)
    _close(got, ref, wq)
    for _, c in outs:
        assert c["tp_ring_matmuls"] == (n > 1)
        assert c["tp_ring_steps"] == n - 1
        # the global x travels n - 1 hops: the JAX count
        assert c["tp_bytes_permuted"] == (n - 1) * x.nbytes // (
            2 if wq == "bf16" else 1)
        # a quantized shard: one K2 call per chunk, n where blocking makes 1
        quant = wq != "bf16" and n > 1
        assert c["products"] == ({"k2": (n, 1)} if quant else {})
        assert c["k2_calls"] == (n if wq != "bf16" else 0)


@pytest.mark.parametrize("n", [1, 2, 4])
@pytest.mark.parametrize("wq", ["bf16", "int8", "fp8"])
def test_matmul_reduce_scatter_matches_jax(pools, n, wq):
    from deepspeed_tpu.parallel import tensor as jring

    x, w = _inputs(seed=1)
    ref = _jax_product(jring.matmul_reduce_scatter, x, w, n, wq, "row")
    outs = _run(pools, n, _mmrs, n, x, w, wq)
    got = np.concatenate([o[0] for o in outs], axis=0)
    assert all(o[0].shape == (M // n, N) for o in outs)
    _close(got, ref, wq)
    for _, c in outs:
        assert c["tp_ring_steps"] == n - 1
        assert c["tp_bytes_permuted"] == (n - 1) * M * N * 4
        # bidirectional (M / n rows even): two half-chunk products a step
        quant = wq != "bf16" and n > 1
        assert c["products"] == ({"k2": (2 * n, 1)} if quant else {})
        assert c["k2_calls"] == ((2 * n if n > 1 else 1) if wq != "bf16"
                                 else 0)


def test_fused_multi_weight_single_ring(pools):
    """One ring feeds two projections: tuple in, tuple out, each equal to
    its own product; one ring counted."""
    import jax.numpy as jnp

    from deepspeed_tpu.parallel import tensor as jring

    x, w1 = _inputs()
    _, w2 = _inputs(seed=3, N=128)
    import jax

    mesh = _jax_mesh(4)
    ya, yb = jax.jit(lambda a, b, c: jring.allgather_matmul(a, (b, c), mesh))(
        jnp.asarray(x), jnp.asarray(w1), jnp.asarray(w2))
    outs = pools[4].run(_fused, 4, x, w1, w2)
    for ref, got in ((ya, np.concatenate([o[0] for o in outs], axis=1)),
                     (yb, np.concatenate([o[1] for o in outs], axis=1))):
        np.testing.assert_allclose(got, np.asarray(ref), rtol=2e-5,
                                   atol=2e-5)


@pytest.mark.parametrize("n", [2, 4])
def test_ring_row_matmul_values_and_grads_match_jax(pools, n):
    """Replicated output on every rank; the input and weight gradients of
    sum(y**2) are the shards of JAX's."""
    import jax
    import jax.numpy as jnp

    from deepspeed_tpu.parallel import tensor as jring

    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 16, 64)).astype(np.float32)
    w = rng.standard_normal((64, 32)).astype(np.float32)
    mesh = _jax_mesh(n)

    def loss(a, b):
        return jnp.sum(jring.ring_row_matmul(a, b, mesh,
                                             lead_specs=(None, None)) ** 2)

    y_ref = jax.jit(lambda a, b: jring.ring_row_matmul(
        a, b, mesh, lead_specs=(None, None)))(jnp.asarray(x), jnp.asarray(w))
    gx, gw = jax.jit(jax.grad(loss, argnums=(0, 1)))(jnp.asarray(x),
                                                     jnp.asarray(w))
    outs = pools[n].run(_row_grads, n, x, w)
    for y, _, _, c in outs:
        np.testing.assert_allclose(y, np.asarray(y_ref), rtol=2e-5,
                                   atol=2e-4)
        assert c["tp_ring_matmuls"] == 1 and c["tp_ring_steps"] == n - 1
    np.testing.assert_allclose(np.concatenate([o[1] for o in outs], axis=-1),
                               np.asarray(gx), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(np.concatenate([o[2] for o in outs], axis=0),
                               np.asarray(gw), rtol=1e-4, atol=1e-4)


def test_ring_row_matmul_single_rank_declines():
    """No ring on an axis of one: None, as the JAX primitive returns."""
    from deepspeed_tpu_torch.parallel import tensor as ring

    assert ring.ring_row_matmul(torch.ones(2, 4, 8), torch.ones(8, 4)) is None


def test_ring_row_matmul_fallback_and_counters(pools):
    """Shapes that cannot ring return None and count a fallback (the JAX
    test's K-odd case, and rows that do not divide); a ring counts one ring
    product, its steps and bytes."""
    from deepspeed_tpu.parallel import tensor as jring

    jring.overlap_counters.reset()
    assert jring.ring_row_matmul(np.ones((2, 4, 31)), np.ones((31, 8)),
                                 _jax_mesh(2), lead_specs=(None, None)) \
        is None
    assert jring.overlap_counters.snapshot()["tp_fallbacks"] == 1
    for a, b, snap1, got, snap2 in pools[2].run(_row_fallback, 2):
        assert a and b
        assert snap1["tp_fallbacks"] == 2 and snap1["tp_ring_matmuls"] == 0
        np.testing.assert_allclose(got, 32.0, rtol=1e-6)
        assert snap2["tp_ring_matmuls"] == 1 and snap2["tp_ring_steps"] == 1
        assert snap2["tp_bytes_permuted"] > 0


def test_shape_errors_are_the_jax_value_errors(pools):
    """The JAX primitives' ValueErrors where a shard's shapes show them:
    a 3-D x, the contraction mismatch, a 3-D dense weight, output rows
    that do not divide the axis, and a reduce-scatter contraction
    mismatch."""
    import jax.numpy as jnp

    from deepspeed_tpu.parallel import tensor as jring

    mesh = _jax_mesh(2)
    want = []
    for fn, args in ((jring.allgather_matmul,
                      (jnp.ones((2, 3, 4)), jnp.ones((4, 8)))),
                     (jring.allgather_matmul,
                      (jnp.ones((4, 64)), jnp.ones((32, 8))))):
        with pytest.raises(ValueError) as e:
            fn(*args, mesh)
        want.append(str(e.value))
    with pytest.raises(ValueError, match="not divisible") as e:
        jring.matmul_reduce_scatter(jnp.ones((33, 32)), jnp.ones((32, 8)),
                                    mesh)
    for got in pools[2].run(_errors, 2):
        assert got[:2] == want
        assert "dense ring weights must be 2D" in got[2]
        assert got[3] == str(e.value)
        assert "contract mismatch" in got[4]


# --- TP kinds ---------------------------------------------------------------

KIND_MODELS = ("tiny-gpt2", "tiny-llama", "tiny-qwen", "tiny-qwen2-moe",
               "tiny-falcon")


@pytest.mark.parametrize("name", KIND_MODELS)
@pytest.mark.parametrize("n", [2, 4])
def test_tp_kinds_match_the_jax_plan(name, n):
    """Every parameter's kind (dense, GQA whose kv heads stop dividing at
    4, qkv bias, tied embeddings, MoE with a shared expert): the JAX
    engine's ``_tp_kind`` of its ``build_plan(...).param_specs`` (routed
    experts by their [K, N] dims, as its quantizer reads them)."""
    import jax
    import jax.numpy as jnp

    from deepspeed_tpu.config import ZeroConfig
    from deepspeed_tpu.inference.engine_v2 import InferenceEngineV2 as JE
    from deepspeed_tpu.models import build_model as jax_build
    from deepspeed_tpu.parallel.topology import MeshConfig, \
        MeshTopology as JTopo
    from deepspeed_tpu.runtime.zero.planner import build_plan
    from deepspeed_tpu_torch.inference.weights import module_param_tree
    from deepspeed_tpu_torch.models import build_model
    from deepspeed_tpu_torch.runtime.zero.planner import tensor_plan

    jm = jax_build(name, dtype=jnp.float32)
    abstract = jax.eval_shape(lambda r: jm.init(
        r, jnp.zeros((1, 8), jnp.int32)), jax.random.PRNGKey(0))["params"]
    specs = build_plan(JTopo(MeshConfig(tensor=n, data=1)),
                       ZeroConfig(stage=0), abstract).param_specs
    want = {}
    for path, spec in jax.tree_util.tree_flatten_with_path(
            specs, is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec)
    )[0]:
        keys = tuple(p.key for p in path)
        entries = tuple(spec)
        want[keys] = JE._tp_kind(entries[1:] if "experts" in keys
                                 else entries)
    tree = module_param_tree(build_model(name, device="meta"))
    got = {path: kind for path, (_, kind) in tensor_plan(
        tree, {"tensor": n}).items()}
    assert got == want
    assert "row" in got.values() and "col" in got.values()


# --- per-shard quantization -------------------------------------------------

@pytest.mark.parametrize("bits", [8, 4, "fp8"])
@pytest.mark.parametrize("kind,n,shape", [("col", 2, (256, 640)),
                                          ("row", 2, (704, 256)),
                                          ("row", 4, (1408, 128)),
                                          ("col", 4, (128, 2752))])
def test_per_shard_codes_are_the_jax_engines(bits, kind, n, shape):
    """Each shard quantized alone (groups resolved per shard: the 704- and
    1408-row weights split into shards whose default group shrinks): codes
    and scales bit for bit the JAX engine's shard_map(quantize_weight)
    shards, padding included."""
    import jax.numpy as jnp

    from deepspeed_tpu_torch.ops.quant_matmul import quantize_weight
    from deepspeed_tpu_torch.runtime.zero.planner import tensor_shard

    rng = np.random.default_rng(4)
    w = (rng.standard_normal(shape) * rng.uniform(0.1, 3, shape[1])
         ).astype(np.float32)
    ref = _jax_quantized(jnp.asarray(w), _jax_mesh(n), bits, kind)
    spec = (None, "tensor") if kind == "col" else ("tensor", None)
    dim = 1 if kind == "col" else 0
    data = np.asarray(ref.data.view(jnp.uint8) if bits == "fp8"
                      else ref.data)
    ref_d = np.split(data, n, axis=dim)
    ref_s = np.split(np.asarray(ref.scale), n, axis=dim)
    for r in range(n):
        q = quantize_weight(tensor_shard(torch.as_tensor(w), spec, r, n),
                            bits=bits, shard=True)
        codes = q.data.view(torch.uint8) if bits == "fp8" else q.data
        np.testing.assert_array_equal(codes.numpy(), ref_d[r])
        np.testing.assert_array_equal(q.scale.numpy(), ref_s[r])
        assert q.group_size == ref.group_size and q.shape == tuple(
            ref.shape)


@pytest.mark.parametrize("bits", [8, 4, "fp8"])
@pytest.mark.parametrize("kind", ["col", "row"])
def test_per_shard_grouped_codes_are_the_jax_engines(bits, kind):
    """Routed-expert slabs [n, K, N]: each shard of the expert FFN width
    quantized alone, bit for bit the JAX engine's
    shard_map(quantize_grouped) under KIND_SPEC_3D."""
    import jax
    import jax.numpy as jnp
    from jax import shard_map

    from deepspeed_tpu.inference.engine_v2 import KIND_SPEC_3D
    from deepspeed_tpu.ops.pallas.quant_matmul import \
        quantize_grouped as jq
    from deepspeed_tpu_torch.ops.quant_matmul import quantize_grouped
    from deepspeed_tpu_torch.runtime.zero.planner import tensor_shard

    n = 2
    shape = (4, 128, 1408) if kind == "col" else (4, 1408, 128)
    rng = np.random.default_rng(5)
    w = rng.standard_normal(shape).astype(np.float32)
    ws = KIND_SPEC_3D[kind]
    ref = jax.jit(shard_map(lambda wl: jq(wl, bits=bits), mesh=_jax_mesh(n),
                            in_specs=(ws,), out_specs=ws,
                            check_vma=False))(jnp.asarray(w))
    dim = 2 if kind == "col" else 1
    data = np.asarray(ref.data.view(jnp.uint8) if bits == "fp8"
                      else ref.data)
    spec = (None, None, "tensor") if kind == "col" else (None, "tensor",
                                                         None)
    for r in range(n):
        q = quantize_grouped(tensor_shard(torch.as_tensor(w), spec, r, n),
                             bits=bits, shard=True)
        codes = q.data.view(torch.uint8) if bits == "fp8" else q.data
        np.testing.assert_array_equal(codes.numpy(),
                                      np.split(data, n, axis=dim)[r])
        np.testing.assert_array_equal(
            q.scale.numpy(), np.split(np.asarray(ref.scale), n, axis=dim)[r])


# --- a rank's weights -------------------------------------------------------

def _rank_slices(name, n):
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.inference.weights import load_tp_params
    from deepspeed_tpu_torch.models import build_model
    from deepspeed_tpu_torch.parallel.topology import MeshTopology

    topo = MeshTopology({"tensor": n})
    comm.set_topology(topo)
    tree, _ = load_tp_params(
        build_model(name, device="meta", seed=9, dtype=torch.float32), None,
        topo, dtype=torch.float32, device="cpu")
    return tree


@pytest.mark.parametrize("name", ["tiny-qwen2-moe", "tiny-gpt2"])
def test_meta_model_ranks_hold_slices_of_the_seeded_weights(pools, name):
    """A rank draws the seeded weights a block at a time and keeps its
    slices: they are the slices of the weights the whole model built from
    the same seed holds, and together they rebuild it."""
    from deepspeed_tpu_torch.inference.weights import (flatten_tree,
                                                       module_param_tree)
    from deepspeed_tpu_torch.models import build_model
    from deepspeed_tpu_torch.runtime.zero.planner import tensor_plan

    model = build_model(name, device="cpu", seed=9, dtype=torch.float32)
    whole = module_param_tree(model)
    plan = tensor_plan(whole, {"tensor": 2})
    ranks = [flatten_tree(t) for t in pools[2].run(_rank_slices, name, 2)]
    for path, (spec, _) in plan.items():
        key = ".".join(path)
        w = whole
        for k in path:
            w = w[k]
        if "tensor" in spec:
            d = spec.index("tensor")
            got = np.concatenate([r[key] for r in ranks], axis=d)
        else:
            got = ranks[0][key]
            np.testing.assert_array_equal(ranks[1][key], got)
        np.testing.assert_array_equal(got, w.numpy())
