"""ZeRO stages 0-3 of the port's engine over two gloo ranks, against the
JAX engine on a 2-device CPU mesh (``{"data": 2}`` at stage 0,
``{"fsdp": 2}`` at stage 3) and against the port at world 1.

Every rank is given the same global batch (micro 2 x gas 2 x dp 2 rows of
32 tokens) from the JAX engine's initial parameters; fp32, AdamW at
``eps=1e-5`` (see ``tests/test_torch_train_engine.py``), 3 steps: losses
within 1e-5 relative and the master within 1e-5 of the JAX engine's. Then
the port's own contracts at world 2: uneven ``IGNORE_INDEX`` labels, MoE
(tiny-mixtral, dropless and capacity, aux loss on), fp16 overflow skipped
on both ranks together, clipping, the forward / backward / step triplet,
LAMB with a tensor across the partition boundary, ``GatheredParameters``
and stage 3's released storage.

The ranks are spawned processes (``comm.spawn.RankPool``) on a file store
under the test's temporary directory, one pool for the module; they import
only torch and the port. The JAX package is imported inside the tests."""
import dataclasses

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.comm.spawn import RankPool

pytestmark = pytest.mark.multiprocess

STEPS = 3


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def config(stage=0, mesh=None, micro=2, **over):
    cfg = {"train_micro_batch_size_per_gpu": micro,
           "gradient_accumulation_steps": 2,
           "optimizer": {"type": "AdamW",
                         "params": {"lr": 1e-3, "eps": 1e-5,
                                    "weight_decay": 0.01}},
           "bf16": {"enabled": False}, "steps_per_print": 10_000,
           "zero_optimization": {"stage": stage,
                                 "stage3_param_persistence_threshold": 1000},
           "mesh": mesh or {"data": 1}}
    cfg.update(over)
    return cfg


def batches(labels=False, n=STEPS, B=8, S=32):
    out = []
    for s in range(n):
        rng = np.random.default_rng(100 + s)
        b = {"input_ids": rng.integers(0, 256, (B, S)).astype(np.int32)}
        if labels:
            # rank 0's rows of the first micro-batch (rows 0-1) lose most of
            # their labels, rank 1's (rows 2-3) none
            lab = np.roll(b["input_ids"], -1, axis=1)
            lab[:, -1] = -100
            lab[0, :24] = -100
            lab[1, 5:30] = -100
            b["labels"] = lab
        out.append(b)
    return out


def moe_overrides(name, moe_over, config_of):
    if not moe_over:
        return {}
    return {"moe": dataclasses.replace(config_of(name).moe, **moe_over)}


# --- run on every rank (and, at world 1, in the test process) -----------

def _engine(name, cfg, init, moe_over=None, dtype=torch.float32):
    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.models import build_model, get_model_config

    over = moe_overrides(name, moe_over, get_model_config)
    model = build_model(name, device="cpu", dtype=dtype, **over)
    return dst.initialize(model=model, config=cfg, params=init,
                          device="cpu")[0]


def _train(name, cfg, init, bs, moe_over=None):
    e = _engine(name, cfg, init, moe_over)
    losses = [float(e.train_batch(b)) for b in bs]
    return losses, e.master, e.skipped_steps, e.get_loss_scale()


def _triplet(name, cfg, init, bs):
    """train_batch against forward/backward/step on the same batches."""
    a = _engine(name, cfg, init)
    b = _engine(name, cfg, init)
    gas = cfg["gradient_accumulation_steps"]
    la, lb = [], []
    for batch in bs:
        la.append(float(a.train_batch(batch)))
        rows = len(batch["input_ids"]) // gas
        tot = 0.0
        for g in range(gas):
            mb = {k: v[g * rows:(g + 1) * rows] for k, v in batch.items()}
            b.forward(mb)
            tot += float(b.backward())
            assert b.is_gradient_accumulation_boundary() == (g == gas - 1)
        b.step()
        lb.append(tot / gas)
    return la, lb, a.master, b.master


def _straddling(name, cfg, init):
    """Tensors whose elements live on both ranks."""
    from deepspeed_tpu_torch import comm

    e = _engine(name, cfg, init)
    plan = e._zero.plan
    return [e._names[i] for i in range(len(e._names))
            if all(plan.pieces(i, r) for r in range(comm.get_world_size()))]


def _gathered(name, cfg, init):
    from deepspeed_tpu_torch import comm, zero

    e = _engine(name, cfg, init)
    p = e.module.layer_0.attn.wq
    released = p.untyped_storage().size() == 0
    want = e.master["layer_0"]["attn"]["wq"].clone()
    with zero.GatheredParameters(p):
        seen = p.detach().clone()
    after_read = p.untyped_storage().size()
    with zero.GatheredParameters(p, modifier_rank=0):
        if comm.get_rank() == 0:
            p.data.fill_(0.5)
    edited = e.master["layer_0"]["attn"]["wq"]
    loss = float(e.train_batch(batches()[0]))
    return (released, bool(torch.equal(seen, want)), after_read,
            float(edited.min()), float(edited.max()),
            p.untyped_storage().size(), np.isfinite(loss))


def _storage(name, cfg, init):
    """Storage sizes of layer 0's and layer 1's partitioned segments, seen
    from layer 1's forward and after the step."""
    e = _engine(name, cfg, init)
    z = e._zero
    segs = {u: [s for s in z.plan.units[u]
                if not z.plan.segments[s].persistent]
            for u in range(len(z.plan.units))}
    unit = {k: u for u, k in enumerate(z.plan.unit_keys)}
    size = lambda u: [z.full[s].untyped_storage().size() for s in segs[u]]
    seen = []
    e.module.layer_1.register_forward_pre_hook(
        lambda m, a: seen.append((size(unit[0]), size(unit[1]))))
    e.train_batch(batches()[0])
    after = [size(u) for u in segs]
    return seen, after, dict(z.counts)


# --- fixtures -----------------------------------------------------------

@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    p = RankPool(2, str(tmp_path_factory.mktemp("zero_store")))
    yield p
    p.close()


def jax_run(name, stage, mesh, bs, moe_over=None, **cfg_over):
    """(initial parameters, losses, parameters after the steps) of the JAX
    engine on the first two CPU devices."""
    import flax
    import jax
    import jax.numpy as jnp

    import deepspeed_tpu as ds
    from deepspeed_tpu.models import build_model as jax_build_model
    from deepspeed_tpu.models import get_model_config as jax_model_config
    from deepspeed_tpu.parallel.topology import MeshTopology

    over = moe_overrides(name, moe_over, jax_model_config)
    engine, *_ = ds.initialize(
        model=jax_build_model(name, dtype=jnp.float32, **over),
        config=config(stage, mesh, **cfg_over),
        topology=MeshTopology(mesh, devices=jax.devices()[:2]))
    unbox = lambda t: jax.tree.map(lambda a: np.asarray(a, np.float32),
                                   jax.device_get(flax.core.meta.unbox(t)))
    init = unbox(engine.state.params)
    losses = [float(engine.train_batch(b)) for b in bs]
    return init, losses, unbox(engine.state.params)


@pytest.fixture(scope="module", params=["tiny-llama", "tiny-gpt2"])
def jax_ref(request):
    """The JAX engine's trajectories of one model: stage 0 at {"data": 2}
    and stage 3 at {"fsdp": 2}."""
    bs = batches()
    return request.param, {0: jax_run(request.param, 0, {"data": 2}, bs),
                           3: jax_run(request.param, 3, {"fsdp": 2}, bs)}


def max_diff(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b), (sorted(a), sorted(b))
        return max(max_diff(a[k], b[k]) for k in a)
    return float(np.abs(np.asarray(a, np.float32) - np.asarray(b)).max())


# --- the tests ----------------------------------------------------------

@pytest.mark.parametrize("stage", [0, 1, 2, 3])
def test_stages_match_the_jax_engine_at_world_2(pool, jax_ref, stage):
    name, ref = jax_ref
    init, want, params = ref[0 if stage < 2 else 3]
    mesh = {"data": 2} if stage < 2 else {"fsdp": 2}
    got = pool.run(_train, name, config(stage, mesh), init, batches())
    for losses, master, _, _ in got:
        np.testing.assert_allclose(losses, want, rtol=1e-5)
        assert max_diff(params, master) <= 1e-5
    assert got[0][0] == got[1][0]          # every rank reports the same loss
    assert max_diff(got[0][1], got[1][1]) == 0.0


@pytest.mark.parametrize("stage", [1, 3])
def test_world_2_matches_world_1(pool, stage):
    """The same global micro-batch (4 rows) on one rank and on two."""
    from deepspeed_tpu_torch.inference.weights import to_jax_tree
    from deepspeed_tpu_torch.models import build_model

    init = to_jax_tree(build_model("tiny-llama", device="cpu",
                                   dtype=torch.float32))
    init = {k: v for k, v in init.items()}
    one = _train("tiny-llama", config(0, micro=4), init, batches())
    two = pool.run(_train, "tiny-llama",
                   config(stage, {"data": 2} if stage == 1 else {"fsdp": 2}),
                   init, batches())[0]
    np.testing.assert_allclose(two[0], one[0], rtol=1e-6)
    assert max_diff(one[1], two[1]) <= 1e-6


def test_uneven_ignored_labels_match_the_jax_engine(pool):
    """Rank 0 holds 24 + 25 ignored labels in the first micro-batch, rank 1
    none. The JAX engine divides the nll sum by the global count; a
    per-rank mean averaged over the ranks weights rank 0's few tokens as
    much as rank 1's many, and misses the first micro-batch's loss at the
    initial parameters by 2.7e-3 relative (5.5604 against 5.5754)."""
    bs = batches(labels=True)
    init, want, params = jax_run("tiny-llama", 0, {"data": 2}, bs)
    got = pool.run(_train, "tiny-llama", config(2, {"data": 2}), init, bs)
    for losses, master, _, _ in got:
        np.testing.assert_allclose(losses, want, rtol=1e-5)
        assert max_diff(params, master) <= 1e-5


@pytest.mark.parametrize("route", ["dropless", "capacity"])
def test_moe_matches_the_jax_engine(pool, route):
    """tiny-mixtral with its aux and z losses: the gating means over the
    global micro-batch (all-reduced over the ranks)."""
    moe_over = {"dropless": True} if route == "dropless" else \
        {"aux_loss_weight": 0.01}
    bs = batches()
    init, want, params = jax_run("tiny-mixtral", 3, {"fsdp": 2}, bs,
                                 moe_over)
    for stage in (2, 3):
        got = pool.run(_train, "tiny-mixtral", config(stage, {"fsdp": 2}),
                       init, bs, moe_over)
        for losses, master, _, _ in got:
            np.testing.assert_allclose(losses, want, rtol=1e-5)
            assert max_diff(params, master) <= 1e-5


def test_fp16_overflow_skipped_on_both_ranks(pool):
    """An initial scale of 2^40 overflows: both ranks skip the same steps
    and halve the same scale, as one rank does."""
    from deepspeed_tpu_torch.inference.weights import to_jax_tree
    from deepspeed_tpu_torch.models import build_model

    init = to_jax_tree(build_model("tiny-llama", device="cpu",
                                   dtype=torch.float32))
    fp16 = {"enabled": True, "initial_scale_power": 40, "hysteresis": 1}
    bs = batches(n=4)
    one = _train("tiny-llama", config(0, micro=4, fp16=fp16), init, bs)
    got = pool.run(_train, "tiny-llama", config(2, {"data": 2}, fp16=fp16),
                   init, bs)
    assert one[2] > 0
    for losses, _, skipped, scale in got:
        assert (skipped, scale) == (one[2], one[3])
        np.testing.assert_allclose(losses, one[0], rtol=2e-3)


def test_clipping_matches_one_rank(pool):
    """A global norm clip that engages: the norm is summed over the
    partitions and reduced."""
    from deepspeed_tpu_torch.inference.weights import to_jax_tree
    from deepspeed_tpu_torch.models import build_model

    init = to_jax_tree(build_model("tiny-llama", device="cpu",
                                   dtype=torch.float32))
    one = _train("tiny-llama", config(0, micro=4, gradient_clipping=0.05),
                 init, batches())
    got = pool.run(_train, "tiny-llama",
                   config(3, {"fsdp": 2}, gradient_clipping=0.05), init,
                   batches())
    for losses, master, _, _ in got:
        np.testing.assert_allclose(losses, one[0], rtol=1e-6)
        assert max_diff(one[1], master) <= 1e-6


def test_triplet_equals_train_batch_at_stage_2(pool):
    from deepspeed_tpu_torch.inference.weights import to_jax_tree
    from deepspeed_tpu_torch.models import build_model

    init = to_jax_tree(build_model("tiny-gpt2", device="cpu",
                                   dtype=torch.float32))
    for la, lb, ma, mb in pool.run(_triplet, "tiny-gpt2",
                                   config(2, {"data": 2}), init, batches()):
        np.testing.assert_allclose(lb, la, rtol=1e-6)
        assert max_diff(ma, mb) == 0.0


def test_lamb_across_the_partition_boundary(pool):
    """LAMB's per-tensor trust ratio with tensors split over the two ranks
    (their squared norms summed over the pieces) against one process."""
    from deepspeed_tpu_torch.inference.weights import to_jax_tree
    from deepspeed_tpu_torch.models import build_model

    init = to_jax_tree(build_model("tiny-llama", device="cpu",
                                   dtype=torch.float32))
    lamb = {"type": "Lamb", "params": {"lr": 1e-3, "weight_decay": 0.01}}
    cfg2 = config(1, {"data": 2}, optimizer=lamb)
    assert pool.run(_straddling, "tiny-llama", cfg2, init)[0]
    one = _train("tiny-llama", config(0, micro=4, optimizer=lamb), init,
                 batches())
    for losses, master, _, _ in pool.run(_train, "tiny-llama", cfg2, init,
                                         batches()):
        np.testing.assert_allclose(losses, one[0], rtol=1e-6)
        assert max_diff(one[1], master) <= 1e-6


def test_gathered_parameters_read_and_write(pool):
    from deepspeed_tpu_torch.inference.weights import to_jax_tree
    from deepspeed_tpu_torch.models import build_model

    init = to_jax_tree(build_model("tiny-llama", device="cpu",
                                   dtype=torch.float32))
    for (released, read_ok, after_read, lo, hi, after_write,
         finite) in pool.run(_gathered, "tiny-llama",
                             config(3, {"fsdp": 2}), init):
        assert released and read_ok and after_read == 0
        assert lo == hi == 0.5               # rank 0's edit, on every rank
        assert after_write == 0 and finite


def test_stage3_storage_released_between_uses(pool):
    from deepspeed_tpu_torch.inference.weights import to_jax_tree
    from deepspeed_tpu_torch.models import build_model

    init = to_jax_tree(build_model("tiny-llama", device="cpu",
                                   dtype=torch.float32))
    for seen, after, counts in pool.run(_storage, "tiny-llama",
                                        config(3, {"fsdp": 2}), init):
        # 2 micro-batches: layer 0 released and layer 1 gathered when
        # layer 1 runs
        assert len(seen) == 2
        for l0, l1 in seen:
            assert all(s == 0 for s in l0) and all(s > 0 for s in l1)
        assert all(s == 0 for sizes in after for s in sizes)
        assert counts["gathers"] == counts["releases"] > 0
