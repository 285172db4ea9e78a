"""The port's collectives facade (``deepspeed_tpu_torch.comm``) over two
gloo ranks, against the JAX package's ``comm`` on a 2-device CPU mesh with
the same numpy inputs: every case of ``tests/test_comm.py`` (all_reduce
sum / mean / max, the gather / scatter round trip, all_to_all, broadcast,
the ring shifts, the logger's records, the world-size helpers).

The ranks are spawned processes (``comm.spawn.RankPool``) on a file store
under the test's temporary directory; they import only torch and the port.
The JAX package is imported inside the tests."""
import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.comm.spawn import RankPool

pytestmark = pytest.mark.multiprocess


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# --- run on every rank --------------------------------------------------

def _setup():
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.parallel.topology import MeshTopology

    comm.set_topology(MeshTopology({"data": 2}))
    return comm.get_rank()


def _shard(x):
    from deepspeed_tpu_torch import comm

    return torch.as_tensor(np.split(np.asarray(x), 2)[comm.get_rank()])


def _all_reduce(x, op):
    from deepspeed_tpu_torch import comm

    return comm.all_reduce(_shard(x), "data", op=op)


def _gather_scatter(x):
    from deepspeed_tpu_torch import comm

    full = comm.all_gather(_shard(x), "data", axis=0)
    return full, comm.reduce_scatter(full, "data", axis=0)


def _all_to_all(x):
    from deepspeed_tpu_torch import comm

    return comm.all_to_all(_shard(x), "data", split_axis=1, concat_axis=0)


def _broadcast(x, src):
    from deepspeed_tpu_torch import comm

    return comm.broadcast(_shard(x), "data", src=src)


def _ring(x):
    from deepspeed_tpu_torch import comm

    return (comm.send_recv_next(_shard(x), "data"),
            comm.send_recv_prev(_shard(x), "data"))


def _logger(x):
    from deepspeed_tpu_torch import comm

    comm.comms_logger.reset()
    comm.configure_comms_logger(enabled=True)
    comm.all_reduce(_shard(x), "data")
    recs = [(r.op, r.axis, r.size_bytes)
            for r in comm.comms_logger._records.values()]
    summary = comm.log_summary()
    comm.configure_comms_logger(enabled=False)
    comm.comms_logger.reset()
    return recs, summary


def _world():
    from deepspeed_tpu_torch import comm

    return (comm.get_world_size(), comm.get_rank(), comm.axis_size("data"),
            comm.axis_index("data"), comm.is_initialized())


# --- the tests ----------------------------------------------------------

@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    p = RankPool(2, str(tmp_path_factory.mktemp("comm_store")))
    assert p.run(_setup) == [0, 1]
    yield p
    p.close()


@pytest.fixture(scope="module")
def jax_topo():
    from deepspeed_tpu.parallel.topology import MeshTopology

    import jax

    return MeshTopology({"data": 2}, devices=jax.devices()[:2])


def _jax(topo, fn, x, in_spec=None, out_spec=None):
    import jax
    from jax.sharding import PartitionSpec as P

    in_spec = P("data") if in_spec is None else in_spec
    out_spec = P("data") if out_spec is None else out_spec
    return np.asarray(jax.shard_map(fn, mesh=topo.mesh, in_specs=in_spec,
                                    out_specs=out_spec)(x))


def _cat(results):
    return np.concatenate([np.asarray(r) for r in results])


@pytest.mark.parametrize("op", ["sum", "avg", "max"])
def test_all_reduce_matches_jax(pool, jax_topo, op):
    from deepspeed_tpu import comm as jcomm

    x = np.random.default_rng(0).standard_normal(8).astype(np.float32)
    want = _jax(jax_topo, lambda xs: jcomm.all_reduce(xs, "data", op=op), x)
    np.testing.assert_allclose(_cat(pool.run(_all_reduce, x, op)), want,
                               rtol=1e-6)


def test_all_gather_reduce_scatter_roundtrip(pool, jax_topo):
    from deepspeed_tpu import comm as jcomm

    x = np.arange(16.0, dtype=np.float32).reshape(16, 1)

    def f(xs):
        return jcomm.reduce_scatter(jcomm.all_gather(xs, "data", axis=0),
                                    "data", axis=0)

    got = pool.run(_gather_scatter, x)
    np.testing.assert_array_equal(got[0][0], x)        # the gathered whole
    np.testing.assert_array_equal(_cat([g[1] for g in got]), _jax(
        jax_topo, f, x))
    np.testing.assert_array_equal(_cat([g[1] for g in got]), x * 2)


def test_all_to_all(pool, jax_topo):
    from jax.sharding import PartitionSpec as P

    from deepspeed_tpu import comm as jcomm

    x = np.arange(16.0, dtype=np.float32).reshape(2, 8)
    want = _jax(jax_topo, lambda xs: jcomm.all_to_all(
        xs, "data", split_axis=1, concat_axis=0), x, P("data", None),
        P("data", None))
    np.testing.assert_array_equal(_cat(pool.run(_all_to_all, x)), want)


def test_broadcast(pool, jax_topo):
    from deepspeed_tpu import comm as jcomm

    x = np.arange(8.0, dtype=np.float32)
    want = _jax(jax_topo, lambda xs: jcomm.broadcast(xs, "data", src=1), x)
    np.testing.assert_array_equal(_cat(pool.run(_broadcast, x, 1)), want)


def test_ring_shift(pool, jax_topo):
    from deepspeed_tpu import comm as jcomm

    x = np.arange(8.0, dtype=np.float32)
    got = pool.run(_ring, x)
    np.testing.assert_array_equal(
        _cat([g[0] for g in got]),
        _jax(jax_topo, lambda xs: jcomm.send_recv_next(xs, "data"), x))
    np.testing.assert_array_equal(
        _cat([g[1] for g in got]),
        _jax(jax_topo, lambda xs: jcomm.send_recv_prev(xs, "data"), x))


def test_comms_logger_records(pool):
    x = np.arange(8.0, dtype=np.float32)
    for recs, summary in pool.run(_logger, x):
        assert ("all_reduce", "data", 16) in recs     # 4 fp32 a rank
        assert "all_reduce" in summary


def test_world_size_helpers(pool):
    assert pool.run(_world) == [(2, 0, 2, 0, True), (2, 1, 2, 1, True)]
    from deepspeed_tpu_torch import comm

    # outside a process group: a world of one
    if not comm.is_initialized():
        assert comm.get_world_size() == 1 and comm.get_rank() == 0
