"""The port's ``parallel/sequence.py`` over four gloo ranks, against the JAX
package's on a 4-device CPU mesh (the cases of
``tests/test_sequence_parallel.py``, plus the gradients the port's training
relies on): Ulysses attention causal and not, the ``DistributedAttention``
API, ring attention at GQA 1 and 2 causal and not, ring gradients, the
training model's Ulysses route with K/V heads that do not divide the axis,
vocab-parallel cross entropy and its gradient, and its seq x tensor form
(``tests/test_tensor_parallel.py``'s ignored rows spread unevenly over the
seq shards).

Inputs come from a numpy seed; each rank takes its own slices and returns
its outputs and gradients as numpy; the test assembles them in rank order.
fp32 throughout, within the JAX tests' 1e-5 (forward) and 1e-4 (gradients,
summed in other orders). The ranks are one ``comm.spawn.RankPool`` of 4 for
the module; JAX is imported inside the tests."""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from deepspeed_tpu_torch.comm.spawn import RankPool

pytestmark = pytest.mark.multiprocess

N = 4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    p = RankPool(N, str(tmp_path_factory.mktemp("sp_store")))
    yield p
    p.close()


def qkv(B=2, S=64, H=4, KV=4, D=16, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, S, n, D)).astype(np.float32)
            for n in (H, KV, KV)]


# --- run on every rank ------------------------------------------------------

_TOPOLOGIES: dict = {}


def _topology(mesh: dict):
    """The rank's topology for ``mesh``, registered with ``comm`` (made
    once a process: its groups are collective to create)."""
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.parallel.topology import MeshTopology

    key = tuple(sorted(mesh.items()))
    if key not in _TOPOLOGIES:
        _TOPOLOGIES[key] = MeshTopology(mesh)
    comm.set_topology(_TOPOLOGIES[key])
    return _TOPOLOGIES[key]


def _shard(x, axis: int, i: int, n: int):
    size = x.shape[axis] // n
    return np.take(x, range(i * size, (i + 1) * size), axis=axis)


def _attention(kind, q, k, v, grads=False, **kw):
    """``kind`` over this rank's seq slices of the full q/k/v: its output
    slice, with ``grads`` the gradients of sum(out**2) (summed over the
    ranks) with respect to its q/k/v slices, and K4's plain calls."""
    from deepspeed_tpu_torch.ops import flash_attention as fa
    from deepspeed_tpu_torch.ops.attention import plain_attention
    from deepspeed_tpu_torch.parallel import sequence as sp

    topo = _topology({"seq": N})
    r = topo.rank_in("seq")
    xs = [torch.tensor(_shard(x, 1, r, N), requires_grad=grads)
          for x in (q, k, v)]
    fa.counts.reset()
    try:
        if kind == "ulysses":
            out = sp.ulysses_attention(*xs, **kw)
        elif kind == "api":
            local = lambda q, k, v, causal: plain_attention(q, k, v,
                                                            causal=causal)
            out = sp.DistributedAttention(local, "seq")(*xs, causal=True)
        elif kind == "ring":
            out = sp.ring_attention(*xs, **kw)
        else:
            out = sp.ulysses_model_attention(
                *xs, "seq", lambda q, k, v: plain_attention(q, k, v))
    except ValueError as e:
        return f"ValueError: {e}"
    res = {"out": out.detach(), "k4": (fa.counts.plain, fa.counts.plain_bwd)}
    if grads:
        (out ** 2).sum().backward()
        res["grads"] = [x.grad for x in xs]
        res["k4"] = (fa.counts.plain, fa.counts.plain_bwd)
    return res


def _vocab_ce(logits, labels, mesh, seq_axis):
    """This rank's loss and gradient of vocab-parallel cross entropy over
    its (seq, vocab) block of the full logits."""
    from deepspeed_tpu_torch.parallel.sequence import \
        vocab_parallel_cross_entropy

    topo = _topology(mesh)
    t, s = topo.rank_in("tensor"), topo.rank_in("seq")
    nt, ns = topo.size("tensor"), topo.size("seq")
    lg = torch.tensor(_shard(_shard(logits, 1, s, ns), 2, t, nt),
                      requires_grad=True)
    lb = torch.tensor(_shard(labels, 1, s, ns)).long()
    loss = vocab_parallel_cross_entropy(lg, lb, "tensor", seq_axis=seq_axis)
    loss.backward()
    return float(loss), lg.grad, (s, t)


# --- references -----------------------------------------------------------

def jax_mesh(shape=(N,), names=("seq",)):
    import jax
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()[:N]).reshape(shape), names)


def plain(q, k, v, causal=True):
    from deepspeed_tpu_torch.ops.attention import plain_attention

    return plain_attention(*map(torch.from_numpy, (q, k, v)),
                           causal=causal).numpy()


def plain_grads(q, k, v, causal=True):
    from deepspeed_tpu_torch.ops.attention import plain_attention

    xs = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    (plain_attention(*xs, causal=causal) ** 2).sum().backward()
    return [x.grad.numpy() for x in xs]


def joined(got, key="out", index=None):
    parts = [g[key] if index is None else g[key][index] for g in got]
    return np.concatenate(parts, axis=1)


# --- the tests --------------------------------------------------------------

@pytest.mark.parametrize("causal", [True, False])
def test_ulysses_matches_local(pool, causal):
    import jax
    import jax.numpy as jnp

    from deepspeed_tpu.parallel.sequence import ulysses_attention

    q, k, v = qkv()
    got = joined(pool.run(_attention, "ulysses", q, k, v, causal=causal))
    mesh = jax_mesh()
    want = jax.jit(lambda *a: ulysses_attention(*a, mesh, causal=causal))(
        *map(jnp.asarray, (q, k, v)))
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got, plain(q, k, v, causal), atol=1e-5,
                               rtol=1e-5)


def test_ulysses_runs_k4_on_each_rank_with_gradients(pool):
    """At S 256 and head dim 64 each rank's whole-sequence attention over
    its one head is K4's route (its plain version here, forward and
    backward); output and gradients equal plain attention's over the whole
    sequence."""
    q, k, v = qkv(B=1, S=256, D=64, seed=1)
    got = pool.run(_attention, "ulysses", q, k, v, grads=True)
    assert all(g["k4"] == (1, 1) for g in got), [g["k4"] for g in got]
    np.testing.assert_allclose(joined(got), plain(q, k, v), atol=1e-5,
                               rtol=1e-5)
    for i, want in enumerate(plain_grads(q, k, v)):
        np.testing.assert_allclose(joined(got, "grads", i), want,
                                   atol=1e-4, rtol=1e-4)


def test_distributed_attention_api(pool):
    q, k, v = qkv()
    got = joined(pool.run(_attention, "api", q, k, v))
    np.testing.assert_allclose(got, plain(q, k, v), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("gqa", [1, 2])
def test_ring_attention_matches_local(pool, causal, gqa):
    import jax
    import jax.numpy as jnp

    from deepspeed_tpu.parallel.sequence import ring_attention

    q, k, v = qkv(KV=4 // gqa)
    got = joined(pool.run(_attention, "ring", q, k, v, causal=causal))
    mesh = jax_mesh()
    want = jax.jit(lambda *a: ring_attention(*a, mesh, causal=causal))(
        *map(jnp.asarray, (q, k, v)))
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got, plain(q, k, v, causal), atol=1e-5,
                               rtol=1e-5)


def test_ring_attention_grads(pool):
    """The gradients run back through the differentiable ring shifts: the
    JAX ring's and plain attention's."""
    import jax
    import jax.numpy as jnp

    from deepspeed_tpu.parallel.sequence import ring_attention

    q, k, v = qkv(B=1, S=32, H=2, KV=2, D=8)
    got = pool.run(_attention, "ring", q, k, v, grads=True)
    mesh = jax_mesh()
    want = jax.jit(jax.grad(
        lambda *a: jnp.sum(ring_attention(*a, mesh) ** 2),
        argnums=(0, 1, 2)))(*map(jnp.asarray, (q, k, v)))
    for i, (w, p) in enumerate(zip(want, plain_grads(q, k, v))):
        np.testing.assert_allclose(joined(got, "grads", i), np.asarray(w),
                                   atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(joined(got, "grads", i), p, atol=1e-4,
                                   rtol=1e-4)


@pytest.mark.parametrize("kv", [2, 1])
def test_model_route_gathers_kv_heads_that_do_not_divide(pool, kv):
    """The training model's route at 4 query heads over seq 4: 2 or 1 KV
    heads do not divide the axis, so K/V are gathered over the sequence and
    each rank's query head reads its own KV head (the JAX model keeps such
    K/V whole); output and gradients equal plain attention's."""
    q, k, v = qkv(KV=kv, seed=2)
    got = pool.run(_attention, "model", q, k, v, grads=True)
    np.testing.assert_allclose(joined(got), plain(q, k, v), atol=1e-5,
                               rtol=1e-5)
    for i, want in enumerate(plain_grads(q, k, v)):
        np.testing.assert_allclose(joined(got, "grads", i), want,
                                   atol=1e-4, rtol=1e-4)


def test_heads_that_do_not_divide_raise(pool):
    q, k, v = qkv(H=6, KV=6)
    for msg in pool.run(_attention, "ulysses", q, k, v):
        assert msg.startswith("ValueError: num heads 6/6 not divisible"), msg
    q, k, v = qkv(KV=2)
    for msg in pool.run(_attention, "ulysses", q, k, v):
        assert msg.startswith("ValueError: num heads 4/2 not divisible"), msg


def ce_inputs(B, S, V, seed):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((B, S, V)).astype(np.float32)
    ids = rng.integers(0, V, (B, S))
    labels = np.where(np.arange(S)[None] < S - 1, np.roll(ids, -1, 1), -100)
    return logits, labels


def ce_grad(logits, labels):
    """Plain cross entropy's loss and gradient over the full logits."""
    lg = torch.tensor(logits, requires_grad=True)
    loss = F.cross_entropy(lg.reshape(-1, lg.shape[-1]),
                           torch.tensor(labels).reshape(-1).long(),
                           ignore_index=-100)
    loss.backward()
    return float(loss.detach()), lg.grad.numpy()


def check_ce(got, want, logits, labels, ns, nt):
    ref, grad = ce_grad(logits, labels)
    S, V = logits.shape[1:]
    for loss, g, (s, t) in got:
        np.testing.assert_allclose(loss, want, atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(loss, ref, atol=1e-5, rtol=1e-5)
        # the rank's gradient is its block of plain cross entropy's
        np.testing.assert_allclose(
            g, grad[:, s * S // ns:(s + 1) * S // ns,
                    t * V // nt:(t + 1) * V // nt], atol=1e-6, rtol=1e-5)


def test_vocab_parallel_cross_entropy(pool):
    import jax
    import jax.numpy as jnp

    from deepspeed_tpu.parallel.sequence import vocab_parallel_cross_entropy

    logits, labels = ce_inputs(2, 8, 64, 3)
    labels[0, :2] = -100
    mesh = jax_mesh(names=("tensor",))
    want = jax.jit(lambda a, b: vocab_parallel_cross_entropy(a, b, mesh))(
        jnp.asarray(logits), jnp.asarray(labels))
    got = pool.run(_vocab_ce, logits, labels, {"tensor": N}, None)
    check_ce(got, float(want), logits, labels, 1, N)


def test_vocab_parallel_ce_seq_tensor_with_ignore_rows(pool):
    """seq 2 x tensor 2, labels shifted on whole rows, extra ignored rows
    on the first seq shard only: the masked mean spans both seq shards."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    from deepspeed_tpu.parallel.sequence import vocab_parallel_cross_entropy

    logits, labels = ce_inputs(2, 16, 64, 4)
    labels[0, :3] = -100
    mesh = jax_mesh((2, 2), ("seq", "tensor"))
    lg = jax.device_put(jnp.asarray(logits),
                        NamedSharding(mesh, P(None, "seq", "tensor")))
    lb = jax.device_put(jnp.asarray(labels), NamedSharding(mesh, P(None,
                                                                   "seq")))
    want = jax.jit(lambda a, b: vocab_parallel_cross_entropy(
        a, b, mesh, axis="tensor", seq_axis="seq"))(lg, lb)
    got = pool.run(_vocab_ce, logits, labels, {"seq": 2, "tensor": 2},
                   "seq")
    check_ce(got, float(want), logits, labels, 2, 2)
