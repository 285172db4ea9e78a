"""Sequence-parallel training in the port's engine at ``{"data": 2, "seq":
2}`` and ``{"fsdp": 2, "seq": 2}`` over four gloo ranks: rows split two
ways and each row's tokens two ways. Held against the JAX engine on a CPU
mesh of the same axes (ZeRO stages 0 and 3, and stage 3 over ``fsdp``), and
a batch whose ignored labels fall unevenly across the seq shards against
the port at world 1. The models, batches, bounds and rank functions are
``tests/test_torch_train_engine_seq.py``'s."""
import pytest

from deepspeed_tpu_torch.comm.spawn import RankPool
from tests.test_torch_train_engine_seq import (  # noqa: F401
    LLAMA, MODELS, _one_thread, _train, batches, check, config, jax_ref)

pytestmark = pytest.mark.multiprocess


@pytest.fixture(scope="module")
def pool4(tmp_path_factory):
    p = RankPool(4, str(tmp_path_factory.mktemp("seq_store4")))
    yield p
    p.close()


@pytest.mark.parametrize("mesh,stage", [({"data": 2, "seq": 2}, 0),
                                        ({"data": 2, "seq": 2}, 3),
                                        ({"fsdp": 2, "seq": 2}, 3)],
                         ids=["data2-seq2-stage0", "data2-seq2-stage3",
                              "fsdp2-seq2-stage3"])
@pytest.mark.parametrize("model", MODELS, ids=[m[0] for m in MODELS])
def test_data_and_seq_match_the_jax_engine(pool4, model, mesh, stage):
    init, want, params = jax_ref(model, mesh, 3 if "fsdp" in mesh else 0)
    got = pool4.run(_train, model, config(mesh, stage), init, batches())
    check(got, want, params, kernel=model is LLAMA)


def test_uneven_ignored_labels_across_seq_shards(pool4):
    """Rank (seq 0)'s shards of rows 0-1 hold 60 + 59 ignored labels, its
    seq neighbour's none: the loss is one masked mean over the global
    batch, as one rank's is (the port at world 1, which has no split)."""
    bs = batches(labels=True)
    init = jax_ref(LLAMA, {"data": 2, "seq": 2})[0]
    want, params, _ = _train(LLAMA, config(), init, bs)
    got = pool4.run(_train, LLAMA, config({"data": 2, "seq": 2}, 3), init,
                    bs)
    check(got, want, params, kernel=True)
