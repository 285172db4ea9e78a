"""ZeRO-Offload in the port's engine (``offload_optimizer``, the host
optimizer of ``runtime/zero/offload.py`` over ZeRO's flat partition) on the
CPU, against the JAX engine with the same offload config.

tiny-llama and tiny-gpt2 in fp32, AdamW at ``eps=1e-5`` (see
``tests/test_torch_train_engine.py``), 3 steps from the JAX engine's
initial parameters: ``device`` "cpu", "nvme" and Twin-Flow's ``ratio`` 0.5
give losses within 1e-5 relative and a master within 1e-5 of the JAX
engine's on one device, and NVMe is bit for bit "cpu". Stage 2 over two
gloo ranks (``comm.spawn.RankPool``) against the JAX engine on a 2-device
mesh and against the port at world 1. Then the port's contracts: the
forward / backward / step triplet, fp16 refused, checkpoints (offload ↔
offload bit for bit; offload → device and fp32 device → offload within
2e-2, as the JAX package's tests hold them), swap files and dropped host
buffers between NVMe steps, and no fp32 state on the device."""
import glob

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


def config(offload="cpu", stage=2, mesh=None, micro=2, ratio=1.0,
           nvme_path=None, **over):
    zero = {"stage": stage}
    if offload != "none":
        zero["offload_optimizer"] = {"device": offload, "ratio": ratio,
                                     "nvme_path": nvme_path}
    cfg = {"train_micro_batch_size_per_gpu": micro,
           "gradient_accumulation_steps": 2,
           "optimizer": {"type": "AdamW",
                         "params": {"lr": 1e-3, "eps": 1e-5,
                                    "weight_decay": 0.01}},
           "bf16": {"enabled": False}, "steps_per_print": 10_000,
           "zero_optimization": zero, "mesh": mesh or {"data": 1}}
    cfg.update(over)
    return cfg


def batches(n=STEPS, B=4, S=32, seed=100):
    return [{"input_ids": np.random.default_rng(seed + s).integers(
        0, 256, (B, S)).astype(np.int32)} for s in range(n)]


# --- run on every rank (and, at world 1, in the test process) -----------

def _engine(name, cfg, init):
    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.models import build_model

    return dst.initialize(model=build_model(name, device="cpu",
                                            dtype=torch.float32),
                          config=cfg, params=init, device="cpu")[0]


def _train(name, cfg, init, bs):
    e = _engine(name, cfg, init)
    return [float(e.train_batch(b)) for b in bs], e.master


def jax_run(name, cfg, bs, devices=1):
    """(initial parameters, losses, parameters after the steps) of the JAX
    engine."""
    import flax
    import jax
    import jax.numpy as jnp

    import deepspeed_tpu as ds
    from deepspeed_tpu.models import build_model as jax_build_model
    from deepspeed_tpu.parallel.topology import (MeshTopology,
                                                 single_device_topology)

    topo = single_device_topology() if devices == 1 else \
        MeshTopology(cfg["mesh"], devices=jax.devices()[:devices])
    engine, *_ = ds.initialize(
        model=jax_build_model(name, dtype=jnp.float32), config=cfg,
        topology=topo)
    unbox = lambda t: jax.tree.map(lambda a: np.asarray(a, np.float32),
                                   jax.device_get(flax.core.meta.unbox(t)))
    init = unbox(engine.state.params)
    losses = [float(engine.train_batch(b)) for b in bs]
    return init, losses, unbox(engine.state.params)


def max_diff(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b), (sorted(a), sorted(b))
        return max(max_diff(a[k], b[k]) for k in a)
    return float(np.abs(np.asarray(a, np.float32) - np.asarray(b)).max())


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    p = RankPool(2, str(tmp_path_factory.mktemp("offload_store")))
    yield p
    p.close()


MODES = [("cpu", 1.0), ("nvme", 1.0), ("cpu", 0.5)]


@pytest.fixture(scope="module", params=["tiny-llama", "tiny-gpt2"])
def jax_ref(request, tmp_path_factory):
    """The JAX engine's runs of one model under each offload mode."""
    d = str(tmp_path_factory.mktemp("jax_nvme"))
    return request.param, {
        (dev, r): jax_run(request.param,
                          config(dev, stage=1, ratio=r, nvme_path=d),
                          batches())
        for dev, r in MODES}


@pytest.mark.parametrize("dev,ratio", MODES,
                         ids=["cpu", "nvme", "twin-flow-0.5"])
def test_offload_matches_the_jax_engine(jax_ref, dev, ratio, tmp_path):
    name, ref = jax_ref
    init, want, params = ref[(dev, ratio)]
    e = _engine(name, config(dev, ratio=ratio, nvme_path=str(tmp_path)),
                init)
    losses = [float(e.train_batch(b)) for b in batches()]
    np.testing.assert_allclose(losses, want, rtol=1e-5)
    assert max_diff(params, e.master) <= 1e-5
    ho = e._host_opt
    if ratio < 1.0:           # Twin-Flow: both shares hold state
        assert ho.device_elements() > 0 and ho.host_elements() > 0
    else:
        assert ho.device_elements() == 0
    # nothing fp32 of the optimizer lives on the engine's device
    # (the CPU here): the master and moments are the host optimizer's
    assert e._zero.master is None or e._zero.master.data_ptr() == \
        ho._flats["master"].data_ptr()


def test_nvme_bit_for_bit_cpu_and_swaps_between_steps(tmp_path):
    from deepspeed_tpu_torch.inference.weights import to_jax_tree
    from deepspeed_tpu_torch.models import build_model

    init = to_jax_tree(build_model("tiny-llama", device="cpu",
                                   dtype=torch.float32))
    lc, mc = _train("tiny-llama", config("cpu"), init, batches())
    e = _engine("tiny-llama", config("nvme", nvme_path=str(tmp_path)), init)
    ln = [float(e.train_batch(b)) for b in batches()]
    assert ln == lc
    assert max_diff(mc, e.master) == 0.0
    ho = e._host_opt
    files = glob.glob(str(tmp_path / "*" / "*.bin"))
    assert len(files) == 3 * len(ho.state) > 0          # master, mu, nu
    assert all(st.master is None and st.mu is None and st.nu is None
               for st in ho.state.values())
    assert e._zero.master is None
    per_step = ho.host_elements() * 4 * 3
    assert ho.io_read_bytes >= STEPS * per_step
    assert ho.io_written_bytes >= (STEPS + 1) * per_step


@pytest.mark.parametrize("name", ["tiny-llama", "tiny-gpt2"])
def test_world_2_matches_the_jax_engine_and_world_1(pool, name):
    """Stage 2 at world 2: each rank's host state is its own partition."""
    bs = batches(B=8)
    init, want, params = jax_run(name, config("cpu", stage=1,
                                              mesh={"data": 2}), bs,
                                 devices=2)
    got = pool.run(_train, name, config("cpu", mesh={"data": 2}), init, bs)
    one = _train(name, config("cpu", micro=4), init, bs)
    for losses, master in got:
        np.testing.assert_allclose(losses, want, rtol=1e-5)
        assert max_diff(params, master) <= 1e-5
        np.testing.assert_allclose(losses, one[0], rtol=1e-6)
        assert max_diff(one[1], master) <= 1e-6
    assert max_diff(got[0][1], got[1][1]) == 0.0


def test_triplet_equals_train_batch():
    from deepspeed_tpu_torch.inference.weights import to_jax_tree
    from deepspeed_tpu_torch.models import build_model

    init = to_jax_tree(build_model("tiny-gpt2", device="cpu",
                                   dtype=torch.float32))
    a = _engine("tiny-gpt2", config("cpu"), init)
    b = _engine("tiny-gpt2", config("cpu"), init)
    for bt in batches():
        la = float(a.train_batch(bt))
        tot = 0.0
        for g in range(2):
            b.forward({k: v[g * 2:(g + 1) * 2] for k, v in bt.items()})
            tot += float(b.backward())
        b.step()
        assert tot / 2 == pytest.approx(la, rel=1e-6)
    assert max_diff(a.master, b.master) == 0.0
    assert a.global_steps == b.global_steps == STEPS
    assert b._host_opt.step_count == STEPS


def test_fp16_offload_rejected():
    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.models import build_model

    with pytest.raises(ValueError, match="bf16/fp32"):
        dst.initialize(model=build_model("tiny-gpt2", device="cpu"),
                       config=config("cpu", fp16={"enabled": True},
                                     bf16={"enabled": False}), device="cpu")
    with pytest.raises(ValueError, match="unsupported"):
        dst.initialize(model=build_model("tiny-gpt2", device="cpu"),
                       config=config("disk"), device="cpu")


@pytest.mark.parametrize("dev", ["cpu", "nvme"])
def test_offload_checkpoint_resumes_bit_for_bit(tmp_path, dev):
    from deepspeed_tpu_torch.inference.weights import to_jax_tree
    from deepspeed_tpu_torch.models import build_model

    init = to_jax_tree(build_model("tiny-llama", device="cpu",
                                   dtype=torch.float32))
    cfg = config(dev, nvme_path=str(tmp_path / "swap"), ratio=0.5
                 if dev == "cpu" else 1.0)
    bs = batches(4)
    e = _engine("tiny-llama", cfg, init)
    for b in bs[:2]:
        e.train_batch(b)
    e.save_checkpoint(str(tmp_path / "ckpt"), tag="t")
    cont = [float(e.train_batch(b)) for b in bs[2:]]
    e2 = _engine("tiny-llama", cfg, None)
    e2.load_checkpoint(str(tmp_path / "ckpt"), tag="t")
    assert e2._host_opt.step_count == 2 and e2.global_steps == 2
    resumed = [float(e2.train_batch(b)) for b in bs[2:]]
    assert resumed == cont
    assert max_diff(e.master, e2.master) == 0.0


def test_offload_to_device_and_fp32_device_to_offload(tmp_path):
    from deepspeed_tpu_torch.inference.weights import to_jax_tree
    from deepspeed_tpu_torch.models import build_model

    init = to_jax_tree(build_model("tiny-gpt2", device="cpu",
                                   dtype=torch.float32))
    bs = batches(3)
    for src, dst_cfg in ((config("cpu"), config("none", stage=1)),
                         (config("none", stage=0), config("cpu"))):
        e = _engine("tiny-gpt2", src, init)
        for b in bs[:2]:
            e.train_batch(b)
        path = str(tmp_path / f"ckpt{id(src)}")
        e.save_checkpoint(path, tag="t")
        want = float(e.train_batch(bs[2]))
        e2 = _engine("tiny-gpt2", dst_cfg, None)
        e2.load_checkpoint(path, tag="t")
        assert float(e2.train_batch(bs[2])) == pytest.approx(want, rel=2e-2)


def test_stage_0_offloads_through_the_partitioned_layout():
    from deepspeed_tpu_torch.inference.weights import to_jax_tree
    from deepspeed_tpu_torch.models import build_model

    init = to_jax_tree(build_model("tiny-llama", device="cpu",
                                   dtype=torch.float32))
    l0, m0 = _train("tiny-llama", config("cpu", stage=0), init, batches())
    l3, m3 = _train("tiny-llama", config("cpu", stage=3), init, batches())
    ld, md = _train("tiny-llama", config("none", stage=0), init, batches())
    assert l0 == l3 and max_diff(m0, m3) == 0.0
    # the host step's order of operations is cpu_adam.cpp's, not
    # FusedAdam's: the same bound as against the JAX engine
    np.testing.assert_allclose(l0, ld, rtol=1e-5)
    assert max_diff(m0, md) <= 1e-5


def test_plain_host_step_is_within_1e6_of_the_native_one():
    """The engine runs the native step; the plain torch version stands
    beside it for a caller that asks."""
    from deepspeed_tpu_torch.inference.weights import to_jax_tree
    from deepspeed_tpu_torch.models import build_model
    from deepspeed_tpu_torch.ops.cpu_optimizer import build_cpu_optimizer

    init = to_jax_tree(build_model("tiny-llama", device="cpu",
                                   dtype=torch.float32))
    a = _engine("tiny-llama", config("cpu"), init)
    b = _engine("tiny-llama", config("cpu"), init)
    assert a._host_opt.cpu_opt.native
    b._host_opt.cpu_opt = build_cpu_optimizer(
        "AdamW", {"lr": 1e-3, "eps": 1e-5, "weight_decay": 0.01},
        native=False)
    for bt in batches():
        np.testing.assert_allclose(float(b.train_batch(bt)),
                                   float(a.train_batch(bt)), rtol=1e-6)
    assert max_diff(a.master, b.master) <= 1e-6


def test_small_tiles_give_the_same_bits():
    """The staging walk splits each run into tiles: the bits do not depend
    on where the tiles end."""
    from deepspeed_tpu_torch.inference.weights import to_jax_tree
    from deepspeed_tpu_torch.models import build_model

    init = to_jax_tree(build_model("tiny-llama", device="cpu",
                                   dtype=torch.float32))
    a = _engine("tiny-llama", config("cpu"), init)
    b = _engine("tiny-llama", config("cpu"), init)
    b._host_opt.tile = 1000
    for bt in batches():
        assert float(a.train_batch(bt)) == float(b.train_batch(bt))
    assert b._host_opt.last_step["tiles"] > a._host_opt.last_step["tiles"]
    assert max_diff(a.master, b.master) == 0.0
