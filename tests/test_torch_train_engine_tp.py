"""Tensor-parallel training in the port's engine at ``{"tensor": 2}`` over
two gloo ranks, against the JAX engine on a CPU mesh of the same axes and
against the port's own run at world 1 (``{"tensor": 4}``, ``{"data": 2,
"tensor": 2}``, ``{"fsdp": 2, "tensor": 2}`` and ``{"seq": 2, "tensor":
2}`` over four ranks are ``tests/test_torch_train_engine_tp4.py``, which
imports this module's helpers).

Each rank holds its slices of the model (``planner.tensor_spec``: heads,
FFN columns and vocab rows over ``tensor``) and runs Megatron's layers:
``copy_to_tensor`` before the column-parallel products, ``reduce_from_tensor``
after the row-parallel ones, the vocab-parallel embedding and loss. Two
models as in ``tests/test_torch_train_engine_seq.py``: tiny-llama at hidden
256 (RoPE, GQA 4:2, head dim 64: each rank's attention is K4's route, its
plain version here) and tiny-gpt2 (learned positions, a two-matrix FFN,
biases, tied embeddings). fp32, AdamW at ``eps=1e-5`` (the seq module says
why), 3 steps of 4 rows of 128 tokens: losses within 1e-5 relative and the
master within 1e-5 of the JAX engine's.

Also: KV heads kept whole (tiny-falcon, MQA: their gradients summed over
the tensor ranks), ALiBi (tiny-bloom: the global heads' slopes), a clip
that binds (the global norm), ``tensor_parallel.overlap`` (the ring
products in ``wo`` and ``w_down``, counted), checkpoints moved between
``{tensor: 2}`` and world 1 both ways, the replicated parameters
bit-identical on both ranks, LAMB's per-tensor norms, the whole model's
reads (``master``,
``num_parameters``, the MFU's FLOPs), the ring scope seen from another
thread, and each refusal.

The ranks are ``comm.spawn.RankPool`` processes (one pool for the module);
they import torch and the port alone. JAX is imported inside the tests."""
import contextlib
import os
import threading

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.comm.spawn import RankPool

pytestmark = pytest.mark.multiprocess

STEPS = 3
S = 128
#: tiny-llama at head dim 64: each rank's attention is K4's route
LLAMA = ("tiny-llama", {"hidden_size": 256})
GPT2 = ("tiny-gpt2", {})
FALCON = ("tiny-falcon", {})
BLOOM = ("tiny-bloom", {})
#: plain SGD, whose update scales with the gradient (Adam's would not
#: feel a clip), and a clip that binds at every step (the gradients' norms
#: are ~1)
SGD = {"optimizer": {"type": "SGD", "params": {"lr": 0.5}}}
CLIP = dict(SGD, gradient_clipping=0.05)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def config(mesh=None, stage=0, **over):
    mesh = mesh or {"data": 1}
    dp = mesh.get("data", 1) * mesh.get("fsdp", 1)
    cfg = {"train_micro_batch_size_per_gpu": 2 // dp,
           "gradient_accumulation_steps": 2,
           "optimizer": {"type": "AdamW",
                         "params": {"lr": 1e-3, "eps": 1e-5,
                                    "weight_decay": 0.01}},
           "bf16": {"enabled": False}, "steps_per_print": 10_000,
           "zero_optimization": {"stage": stage,
                                 "stage3_param_persistence_threshold": 1000},
           "mesh": mesh}
    cfg.update(over)
    return cfg


def batches(n=STEPS):
    return [{"input_ids": np.random.default_rng(300 + s).integers(
        0, 256, (4, S)).astype(np.int32)} for s in range(n)]


# --- run on every rank (and, at world 1, in the test process) -----------

def _engine(model, cfg, init, loss_fn=None):
    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.models import build_model

    name, over = model
    m = build_model(name, device="cpu", dtype=torch.float32, **over)
    return dst.initialize(model=m, config=cfg, params=init, loss_fn=loss_fn,
                          device="cpu")[0]


def _replicated(e) -> dict:
    """This rank's compute values of the parameters kept whole on every
    tensor rank (gathered at stage 3); ``check`` holds their master
    through ``master``, which joins only the sharded ones."""
    with contextlib.nullcontext() if e._zero is None else e._zero.gathered():
        return {name: p.detach().clone()
                for i, (name, p) in enumerate(zip(e._names, e._params))
                if "tensor" not in (e._tp_specs[i] or ())}


def _train(model, cfg, init, bs, save=None, load=None):
    """(losses, master, K4's plain forward calls, the replicated
    parameters, the ring counters, the master as loaded); ``save`` =
    (directory, step): a checkpoint after that many steps; ``load`` =
    directory: resume from its checkpoint first."""
    from deepspeed_tpu_torch.ops import flash_attention as fa
    from deepspeed_tpu_torch.parallel.tensor import overlap_counters

    e = _engine(model, cfg, None if load else init)
    loaded = None
    if load:
        e.load_checkpoint(load, tag="tp")
        # a copy: at stage 0 in fp32 the master is the parameters
        loaded = {k: v.clone() for k, v in _flat(e.master).items()}
    fa.counts.reset()
    overlap_counters.reset()
    losses = []
    for i, b in enumerate(bs):
        losses.append(float(e.train_batch(b)))
        if save is not None and i + 1 == save[1]:
            e.save_checkpoint(save[0], tag="tp")
    return (losses, e.master, fa.counts.plain, _replicated(e),
            overlap_counters.snapshot(), loaded)


def _refusal(model, cfg, custom_loss=False, env=None):
    """The error a tensor-parallel engine raises (at build, or at its
    first step), as text."""
    def loss_fn(module, batch):
        return module(batch["input_ids"]).float().mean()

    os.environ.update(env or {})
    try:
        e = _engine(model, cfg, None, loss_fn if custom_loss else None)
        e.train_batch(batches(1)[0])
    except (NotImplementedError, ValueError) as err:
        return f"{type(err).__name__}: {err}"
    finally:
        for k in env or {}:
            os.environ.pop(k)
    return None


def _whole_model_reads(model, cfg):
    """``num_parameters``, the MFU's FLOPs a step, the master's shapes and
    an eval loss of an engine at ``cfg``."""
    from deepspeed_tpu_torch.runtime.engine import model_step_flops

    e = _engine(model, cfg, None)
    shapes = dict(zip(e._names, e._global_shapes))
    flops = model_step_flops(e.module, 4, S, shapes)
    master = {k: tuple(v.shape) for k, v in _flat(e.master).items()}
    return (e.num_parameters(), flops, master,
            float(e.eval_batch(batches(1)[0])))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


# --- fixtures -----------------------------------------------------------

@pytest.fixture(scope="module")
def pool2(tmp_path_factory):
    p = RankPool(2, str(tmp_path_factory.mktemp("tp_store2")))
    yield p
    p.close()


def jax_run(model, mesh, bs, stage=0, **over):
    """(initial parameters, losses, parameters after the steps) of the JAX
    engine on as many CPU devices as the mesh has."""
    import flax
    import jax
    import jax.numpy as jnp

    import deepspeed_tpu as ds
    from deepspeed_tpu.models import build_model as jax_build_model
    from deepspeed_tpu.parallel.topology import MeshTopology

    name, mover = model
    n = int(np.prod(list(mesh.values())))
    engine, *_ = ds.initialize(
        model=jax_build_model(name, dtype=jnp.float32, **mover),
        config=config(mesh, stage, **over),
        topology=MeshTopology(mesh, devices=jax.devices()[:n]))
    unbox = lambda t: jax.tree.map(lambda a: np.asarray(a, np.float32),
                                   jax.device_get(flax.core.meta.unbox(t)))
    init = unbox(engine.state.params)
    losses = [float(engine.train_batch(b)) for b in bs]
    return init, losses, unbox(engine.state.params)


_JAX: dict = {}


def jax_ref(model, mesh, stage=0, **over):
    """The JAX engine's trajectory of ``model`` on ``mesh`` (computed once
    a module)."""
    key = (model[0], tuple(sorted(mesh.items())), stage,
           repr(sorted(over.items())))
    if key not in _JAX:
        _JAX[key] = jax_run(model, mesh, batches(), stage, **over)
    return _JAX[key]


def max_diff(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b), (sorted(a), sorted(b))
        return max(max_diff(a[k], b[k]) for k in a)
    return float(np.abs(np.asarray(a, np.float32) - np.asarray(b)).max())


def check(got, want, params, kernel=False):
    """Every rank's losses and master against the reference; the ranks
    agree with each other; the replicated parameters are bit-identical on
    every tensor rank; K4's plain version ran on each rank."""
    for losses, master, k4, *_ in got:
        np.testing.assert_allclose(losses, want, rtol=1e-5)
        assert max_diff(params, master) <= 1e-5
        assert (k4 > 0) == kernel, k4
    for losses, master, _, rep, *_ in got[1:]:
        assert losses == got[0][0]
        assert max_diff(got[0][1], master) == 0.0
        assert set(rep) == set(got[0][3]) and rep
        for name, v in rep.items():
            assert np.array_equal(v, got[0][3][name]), name


# --- the tests ----------------------------------------------------------

MODELS = [LLAMA, GPT2]


@pytest.mark.parametrize("stage", [0, 3])
@pytest.mark.parametrize("model", MODELS, ids=[m[0] for m in MODELS])
def test_tensor_2_matches_the_jax_engine(pool2, model, stage):
    init, want, params = jax_ref(model, {"tensor": 2})
    got = pool2.run(_train, model, config({"tensor": 2}, stage), init,
                    batches())
    check(got, want, params, kernel=model is LLAMA)


@pytest.mark.parametrize("model", [FALCON, BLOOM],
                         ids=["mqa-whole-kv", "alibi"])
def test_tensor_2_whole_kv_and_alibi_match_the_jax_engine(pool2, model):
    """tiny-falcon's one KV head does not divide the axis: wk / wv stay
    whole and their gradients, each rank's from its own query heads, are
    summed over the tensor ranks (without the sum the master moves apart
    at the first step). tiny-bloom's ALiBi slopes are the global heads'."""
    init, want, params = jax_ref(model, {"tensor": 2})
    got = pool2.run(_train, model, config({"tensor": 2}, 1), init,
                    batches())
    check(got, want, params)


def test_tensor_2_clipping_uses_the_whole_models_norm(pool2):
    """A clip of 0.05 binds at every SGD step: the norm sums the sharded
    gradients' squares over the tensor ranks and counts the replicated
    ones once, as the JAX engine's global norm does (either miscount
    scales every update)."""
    init, want, params = jax_ref(GPT2, {"tensor": 2}, **CLIP)
    unclipped = _train(GPT2, config(None, 0, **SGD), init, batches())[0]
    assert abs(want[2] - unclipped[2]) > 1e-3 * abs(unclipped[2])
    for stage in (0, 2):
        got = pool2.run(_train, GPT2, config({"tensor": 2}, stage, **CLIP),
                        init, batches())
        check(got, want, params)


def test_tensor_2_lamb_uses_whole_tensor_norms(pool2):
    """LAMB's trust ratio is per tensor: at tensor 2 a sharded parameter's
    weight and update norms are summed over the tensor ranks (stage 0
    through ``sq_norm_reduce``, stage 1 through ZeRO's), so the steps match
    the port's own at world 1 (held to the JAX engine's elsewhere)."""
    lamb = {"optimizer": {"type": "Lamb", "params": {"lr": 1e-2}}}
    init = jax_ref(GPT2, {"tensor": 2})[0]
    want, params, *_ = _train(GPT2, config(None, 0, **lamb), init, batches())
    for stage in (0, 1):
        got = pool2.run(_train, GPT2, config({"tensor": 2}, stage, **lamb),
                        init, batches())
        check(got, want, params)


def test_tensor_2_overlap_rings_wo_and_w_down(pool2):
    """``tensor_parallel.overlap``: the row-parallel ``wo`` and ``w_down``
    run through ``ring_row_matmul`` (2 rings a layer a forward: 2 layers x
    2 micro-batches x 3 steps), no fallback; held against the JAX engine
    (the same function) and the overlap-off run."""
    init, want, params = jax_ref(LLAMA, {"tensor": 2})
    over = {"tensor_parallel": {"overlap": True}}
    got = pool2.run(_train, LLAMA, config({"tensor": 2}, 0, **over), init,
                    batches())
    check(got, want, params, kernel=True)
    off = pool2.run(_train, LLAMA, config({"tensor": 2}), init, batches())
    for on, plain in zip(got, off):
        np.testing.assert_allclose(on[0], plain[0], rtol=1e-5)
        assert max_diff(plain[1], on[1]) <= 1e-5
        assert on[4]["tp_ring_matmuls"] == 2 * 2 * 2 * STEPS
        assert on[4]["tp_ring_steps"] == 2 * 2 * 2 * STEPS
        assert on[4]["tp_fallbacks"] == 0
        assert plain[4]["tp_ring_matmuls"] == 0


def test_tensor_2_checkpoint_resumes_at_world_1(pool2, tmp_path):
    """Saved after 2 steps at {tensor: 2} stage 3 (each rank writes its
    slices, tensor index 0 the replicated tensors): the files hold the
    logical tensors. World 1 at stage 0 loads the saved master bit for bit
    and takes the third step as the tensor-2 run did; tensor 2 at stage 0
    resumes it bit for bit."""
    init = jax_ref(LLAMA, {"tensor": 2})[0]
    bs = batches()
    saved = pool2.run(_train, LLAMA, config({"tensor": 2}, 3), init, bs[:2],
                      (str(tmp_path), 2))[0]
    ref = pool2.run(_train, LLAMA, config({"tensor": 2}, 3), init, bs)[0]
    one = _train(LLAMA, config(), None, bs[2:], load=str(tmp_path))
    assert max_diff(_flat(saved[1]), one[5]) == 0.0
    np.testing.assert_allclose(one[0][0], ref[0][2], rtol=1e-5)
    assert max_diff(ref[1], one[1]) <= 1e-5
    two = pool2.run(_train, LLAMA, config({"tensor": 2}, 0), None, bs[2:],
                    None, str(tmp_path))
    for losses, master, *_, loaded in two:
        assert max_diff(_flat(saved[1]), loaded) == 0.0
        assert losses[0] == ref[0][2]
        assert max_diff(ref[1], master) == 0.0


def test_world_1_checkpoint_resumes_at_tensor_2(pool2, tmp_path):
    """Saved after 2 steps at world 1 stage 1: each tensor rank loads its
    slices of the master bit for bit at stage 0, and its third step
    matches world 1's."""
    init = jax_ref(GPT2, {"tensor": 2})[0]
    bs = batches()
    saved = _train(GPT2, config(None, 1), init, bs[:2], (str(tmp_path), 2))
    one = _train(GPT2, config(None, 1), init, bs)
    got = pool2.run(_train, GPT2, config({"tensor": 2}, 0), None, bs[2:],
                    None, str(tmp_path))
    for losses, master, *_, loaded in got:
        assert max_diff(_flat(saved[1]), loaded) == 0.0
        np.testing.assert_allclose(losses[0], one[0][2], rtol=1e-5)
        assert max_diff(one[1], master) <= 1e-5


def test_whole_model_reads_at_tensor_2(pool2):
    """``num_parameters``, the MFU's model FLOPs and ``master`` give the
    whole model at tensor 2, as the JAX engine's do, not a rank's
    slices; ``eval_batch`` gives world 1's loss."""
    want = _whole_model_reads(LLAMA, config())
    for got in pool2.run(_whole_model_reads, LLAMA, config({"tensor": 2})):
        assert got[0] == want[0] and got[1] == want[1]
        assert got[2] == want[2]
        np.testing.assert_allclose(got[3], want[3], rtol=1e-6)


def test_ring_scope_reaches_another_thread():
    """On CUDA the backward, and remat's second forward inside it, run on
    autograd's device thread: ``tp_overlap_scope`` must be seen there, as
    the comm scopes are (a context variable was not)."""
    from deepspeed_tpu_torch.parallel import tensor as ring

    seen = []
    with ring.tp_overlap_scope(None):
        t = threading.Thread(
            target=lambda: seen.append(ring.current_tp_overlap()))
        t.start()
        t.join()
    assert seen[0] is not None and seen[0].axis == "tensor"
    assert ring.current_tp_overlap() is None


def test_megatron_operators_are_identities_at_tensor_1():
    """``copy_to_tensor`` / ``reduce_from_tensor`` on an axis of one
    return their input and leave its gradient alone."""
    from deepspeed_tpu_torch import comm

    x = torch.randn(3, 4, requires_grad=True)
    assert comm.copy_to_tensor(x) is x
    assert comm.reduce_from_tensor(x) is x


def test_tensor_refusals(pool2):
    """What tensor > 1 does not take yet raises NotImplementedError naming
    ROADMAP item 6b part 3: a MoE model, ZeRO-Offload, a custom loss_fn
    not marked as taking the scopes, the fused head; offload_param keeps
    the JAX engine's ValueError."""
    t2 = config({"tensor": 2})
    offload = {"zero_optimization": {"stage": 1, "offload_optimizer":
                                     {"device": "cpu"}}}
    infinity = {"zero_optimization": {
        "stage": 3, "offload_optimizer": {"device": "cpu"},
        "offload_param": {"device": "cpu"}}}
    cases = {
        "moe": pool2.run(_refusal, ("tiny-mixtral", {}), t2),
        "offload": pool2.run(_refusal, LLAMA, config({"tensor": 2},
                                                     **offload)),
        "custom": pool2.run(_refusal, LLAMA, t2, True),
        "fused": pool2.run(_refusal, LLAMA, t2, False,
                           {"DS_TPU_FUSED_HEAD_CHUNK": "96"}),
        "infinity": pool2.run(_refusal, LLAMA, config({"tensor": 2},
                                                      **infinity)),
    }
    for key in ("moe", "offload", "custom", "fused"):
        for msg in cases[key]:
            assert msg.startswith("NotImplementedError") and \
                "item 6b part 3" in msg and "tensor" in msg, (key, msg)
    assert "MoE" in cases["moe"][0] and "loss_fn" in cases["custom"][0]
    assert "tensor_parallel = True" in cases["custom"][0]
    assert "DS_TPU_FUSED_HEAD_CHUNK" in cases["fused"][0]
    assert "ZeRO-Offload" in cases["offload"][0]
    for msg in cases["infinity"]:
        assert msg.startswith("ValueError: offload_param streaming needs a "
                              "pure DP mesh"), msg
