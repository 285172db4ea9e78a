"""Tensor-parallel training in the port's engine over four gloo ranks:
``{"data": 2, "tensor": 2}`` (ZeRO stage 1), ``{"fsdp": 2, "tensor": 2}``
(stage 3, each tensor rank partitioning its own slices over fsdp),
``{"seq": 2, "tensor": 2}`` (the JAX ``test_hybrid_tp_sp_fsdp``
composition: a tensor rank's heads split again over seq by Ulysses) and
``{"tensor": 4}`` at stage 2 (tiny-llama's 2 KV heads then stay whole beside
one query head a rank). Held against the JAX engine on a CPU mesh of the same axes;
and the tensor ranks of one data-parallel rank take the same rows. The
models, batches, bounds and rank functions are
``tests/test_torch_train_engine_tp.py``'s."""
import numpy as np
import pytest

from deepspeed_tpu_torch.comm.spawn import RankPool
from tests.test_torch_train_engine_tp import (  # noqa: F401
    GPT2, LLAMA, _one_thread, _train, batches, check, config, jax_ref)

pytestmark = pytest.mark.multiprocess


@pytest.fixture(scope="module")
def pool4(tmp_path_factory):
    p = RankPool(4, str(tmp_path_factory.mktemp("tp_store4")))
    yield p
    p.close()


CASES = [(GPT2, {"data": 2, "tensor": 2}, 1),
         (LLAMA, {"fsdp": 2, "tensor": 2}, 3),
         (LLAMA, {"seq": 2, "tensor": 2}, 0),
         (LLAMA, {"tensor": 4}, 2)]


@pytest.mark.parametrize("model,mesh,stage", CASES,
                         ids=["data2-tensor2-gpt2-stage1",
                              "fsdp2-tensor2-llama-stage3",
                              "seq2-tensor2-llama-stage0",
                              "tensor4-llama-stage2"])
def test_four_ranks_match_the_jax_engine(pool4, model, mesh, stage):
    init, want, params = jax_ref(model, mesh, 3 if "fsdp" in mesh else 0)
    got = pool4.run(_train, model, config(mesh, stage), init, batches())
    check(got, want, params, kernel=model is LLAMA)


def _rows(mesh):
    """(data-parallel rank, tensor rank, seq rank, this rank's micro-batch
    rows and columns) of a step's batch."""
    from tests.test_torch_train_engine_tp import _engine

    e = _engine(GPT2, config(mesh), None)
    mbs = e._split_for_gas(e._device_batch(batches(1)[0]))
    return (e.dp_rank, e.tp_rank, e.sp_rank,
            [mb["input_ids"].numpy() for mb in mbs])


@pytest.mark.parametrize("mesh", [{"data": 2, "tensor": 2},
                                  {"seq": 2, "tensor": 2}],
                         ids=["data2-tensor2", "seq2-tensor2"])
def test_tensor_ranks_take_the_same_rows(pool4, mesh):
    """The tensor ranks of one data-parallel (and seq) rank hold the same
    rows and positions; the data-parallel and seq ranks split them."""
    got = pool4.run(_rows, mesh)
    by = {}
    for dp, tp, sp, mbs in got:
        by.setdefault((dp, sp), []).append(mbs)
    assert len(by) == 2 and all(len(v) == 2 for v in by.values())
    for same in by.values():
        for a, b in zip(*same):
            np.testing.assert_array_equal(a, b)
    (x,), (y,) = ([v[0][0]] for v in by.values())
    assert x.shape == y.shape and not np.array_equal(x, y)
