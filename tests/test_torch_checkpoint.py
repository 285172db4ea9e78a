"""The port's checkpoints (``runtime/checkpointing.py``, ``checkpoint/``):
the round trip and ``latest``, the universal resume across ZeRO stages and
world sizes (``tests/test_checkpoint.py:64``'s case: stage 2 at world 2 →
stage 3 at world 1, and world 1 → world 2, the same eval loss), the async
round trip, ``zero_to_fp32`` and ``ds_to_universal`` (and the CLI), and the
two packages side by side: the port's
``get_fp32_state_dict_from_zero_checkpoint`` on its checkpoint against the
JAX package's on a JAX checkpoint of the same run, and a JAX engine's state
carried into the port by ``load_state_tree``.

Two-rank cases run in one pool of spawned gloo processes
(``comm.spawn.RankPool``); the JAX package is imported inside the
tests."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.comm.spawn import RankPool

pytestmark = pytest.mark.multiprocess

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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


def batch(B=8, seed=0):
    rng = np.random.default_rng(seed)
    return {"input_ids": rng.integers(0, 256, (B, 32)).astype(np.int32)}


def init_params():
    from deepspeed_tpu_torch.inference.weights import to_jax_tree
    from deepspeed_tpu_torch.models import build_model

    return to_jax_tree(build_model("tiny-llama", device="cpu",
                                   dtype=torch.float32))


def _engine(cfg, init=None, bf16=False):
    import deepspeed_tpu_torch as dst
    from deepspeed_tpu_torch.models import build_model

    model = build_model("tiny-llama", device="cpu",
                        dtype=torch.bfloat16 if bf16 else torch.float32,
                        param_dtype=torch.float32)
    return dst.initialize(model=model, config=cfg, params=init,
                          device="cpu")[0]


# --- run on every rank --------------------------------------------------

def _train_save(cfg, init, d, steps=2):
    e = _engine(cfg, init)
    for _ in range(steps):
        e.train_batch(batch())
    e.save_checkpoint(d)
    return float(e.eval_batch(batch(seed=5)))


def _load_eval(cfg, d):
    e = _engine(cfg)
    e.load_checkpoint(d)
    return e.global_steps, float(e.eval_batch(batch(seed=5)))


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    p = RankPool(2, str(tmp_path_factory.mktemp("ckpt_store")))
    yield p
    p.close()


# --- the tests ----------------------------------------------------------

@pytest.mark.parametrize("bf16", [False, True])
def test_save_load_roundtrip(tmp_path, bf16):
    cfg = config(3, micro=4, bf16={"enabled": bf16})
    e = _engine(cfg, bf16=bf16)
    for _ in range(2):
        e.train_batch(batch())
    e.save_checkpoint(str(tmp_path), tag="ckpt1", client_state={"epoch": 3})
    before = float(e.eval_batch(batch(seed=5)))
    e2 = _engine(config(1, micro=4, bf16={"enabled": bf16}), bf16=bf16)
    assert e2.load_checkpoint(str(tmp_path), tag="ckpt1") == {"epoch": 3}
    assert e2.global_steps == e.global_steps == 2
    assert float(e2.eval_batch(batch(seed=5))) == before
    # training continues identically
    assert float(e.train_batch(batch())) == float(e2.train_batch(batch()))
    meta = json.loads((tmp_path / "ckpt1" / "meta.json").read_text())
    assert {"tag", "global_steps", "skipped_steps", "config",
            "client_state", "framework_version"} <= set(meta)
    index = json.loads((tmp_path / "ckpt1" / "state" / "index.json")
                       .read_text())
    want = "bfloat16" if bf16 else "float32"
    assert index["params.layer_0.attn.wq"]["dtype"] == want
    assert ("master.layer_0.attn.wq" in index) == bf16


def test_latest_tag(tmp_path):
    e = _engine(config(2, micro=4))
    e.train_batch(batch())
    e.save_checkpoint(str(tmp_path))                  # auto tag
    assert (tmp_path / "latest").read_text() == "global_step1"
    e2 = _engine(config(0, micro=4))
    e2.load_checkpoint(str(tmp_path))                  # via 'latest'
    assert e2.global_steps == e.global_steps


def test_universal_resume_world_2_stage_2_to_world_1_stage_3(pool, tmp_path):
    d = str(tmp_path / "ck")
    init = init_params()
    evals = pool.run(_train_save, config(2, {"data": 2}), init, d)
    assert evals[0] == evals[1]
    steps, loss = _load_eval(config(3, micro=4), d)
    assert steps == 2
    assert loss == pytest.approx(evals[0], rel=1e-6)


def test_universal_resume_world_1_to_world_2(pool, tmp_path):
    d = str(tmp_path / "ck")
    want = _train_save(config(1, micro=4), init_params(), d)
    for steps, loss in pool.run(_load_eval, config(3, {"fsdp": 2}), d):
        assert steps == 2
        assert loss == pytest.approx(want, rel=1e-6)


def test_async_save_roundtrip(tmp_path):
    d = str(tmp_path)
    e = _engine(config(3, micro=4, checkpoint={"async_save": True}))
    e.train_batch(batch())
    e.save_checkpoint(d, tag="a1")
    e.wait_for_checkpoint()
    assert e._latest_thread is None and (tmp_path / "latest").exists()
    before = float(e.eval_batch(batch(seed=5)))
    e2 = _engine(config(2, micro=4))
    e2.load_checkpoint(d)
    assert float(e2.eval_batch(batch(seed=5))) == before
    from deepspeed_tpu_torch.checkpoint import tag_status

    assert tag_status(str(tmp_path / "a1"))[0] == "verified"


def test_zero_to_fp32_and_ds_to_universal(tmp_path):
    from deepspeed_tpu_torch.checkpoint import (
        UniversalCheckpoint, ds_to_universal,
        get_fp32_state_dict_from_zero_checkpoint, zero_to_fp32)

    d = str(tmp_path / "ck")
    e = _engine(config(3, micro=4, bf16={"enabled": True}), bf16=True)
    e.train_batch(batch())
    e.save_checkpoint(d)
    master = {n: m.numpy() for n, m in zip(e._names, e._full_master())}
    sd = get_fp32_state_dict_from_zero_checkpoint(d)
    assert set(sd) == set(master)
    for k in sd:
        np.testing.assert_array_equal(sd[k], master[k])
    out = zero_to_fp32(d, str(tmp_path / "w.npz"))
    with np.load(out) as z:
        np.testing.assert_array_equal(z["layer_0.attn.wq"],
                                      master["layer_0.attn.wq"])
    atoms = ds_to_universal(d, str(tmp_path / "atoms"))
    uc = UniversalCheckpoint(atoms)
    np.testing.assert_array_equal(
        uc.load_section("master")["layer_1"]["ffn"]["w_down"],
        master["layer_1.ffn.w_down"])
    assert "opt_mu.embed" in set(uc.keys())
    assert uc.meta["global_steps"] == 1
    # the CLI
    proc = subprocess.run(
        [sys.executable, "-m", "deepspeed_tpu_torch.checkpoint.universal",
         "zero_to_fp32", d, str(tmp_path / "cli.npz")], cwd=ROOT,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    with np.load(tmp_path / "cli.npz") as z:
        assert set(z.files) == set(master)


def _jax_engine(cfg):
    import jax
    import jax.numpy as jnp

    import deepspeed_tpu as ds
    from deepspeed_tpu.models import build_model as jax_build_model
    from deepspeed_tpu.parallel.topology import single_device_topology

    return ds.initialize(model=jax_build_model("tiny-llama",
                                               dtype=jnp.float32),
                         config=cfg, topology=single_device_topology())[0]


def _unbox(t):
    import flax
    import jax

    return jax.tree.map(lambda a: np.asarray(a, np.float32),
                        jax.device_get(flax.core.meta.unbox(t)))


def test_fp32_state_dicts_of_the_two_packages_agree(tmp_path):
    """The same run in both packages, each saved in its own format: the
    consolidated fp32 weights have the same keys and values, within 1e-5
    as the engines' parity tests hold them (an element whose gradient sits
    within summation noise of zero takes Adam steps that differ in the two
    packages: one of the 16384 of ``embed`` ends 1.2e-6 apart here)."""
    from deepspeed_tpu.checkpoint import (
        get_fp32_state_dict_from_zero_checkpoint as jax_fp32)
    from deepspeed_tpu_torch.checkpoint import \
        get_fp32_state_dict_from_zero_checkpoint

    cfg = config(0, micro=4)
    cfg.pop("mesh")
    je = _jax_engine(dict(cfg))
    te = _engine(config(3, micro=4), _unbox(je.state.params))
    for _ in range(2):
        je.train_batch(batch())
        te.train_batch(batch())
    je.save_checkpoint(str(tmp_path / "jax"))
    je.wait_for_checkpoint()
    te.save_checkpoint(str(tmp_path / "port"))
    want = jax_fp32(str(tmp_path / "jax"))
    got = get_fp32_state_dict_from_zero_checkpoint(str(tmp_path / "port"))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=1e-5)


def test_jax_state_continues_in_the_port_through_load_state_tree():
    """A JAX engine's TrainState (params, master, moments, step) loaded
    into a port engine at stage 2: the next step's loss is the JAX
    engine's."""
    from deepspeed_tpu_torch.runtime.checkpointing import (load_state_tree,
                                                           state_tree)

    cfg = config(0, micro=4)
    cfg.pop("mesh")
    je = _jax_engine(dict(cfg))
    for _ in range(2):
        je.train_batch(batch())
    st = je.state
    tree = {"params": _unbox(st.params),
            "master": None if st.master is None else _unbox(st.master),
            "opt_mu": _unbox(st.opt_state.mu),
            "opt_nu": _unbox(st.opt_state.nu),
            "opt_step": np.asarray(st.opt_state.step),
            "global_step": np.asarray(st.global_step)}
    te = _engine(config(2, micro=4))
    load_state_tree(te, tree)
    assert te.global_steps == 2 and te.opt_step == 2
    back = state_tree(te)
    np.testing.assert_array_equal(back["opt_mu"]["embed"],
                                  tree["opt_mu"]["embed"])
    want = float(je.train_batch(batch(seed=9)))
    assert float(te.train_batch(batch(seed=9))) == pytest.approx(want,
                                                                 rel=1e-5)
