"""The training engine's telemetry section and the five monitor backends
in the port (``runtime/engine.py``, ``monitor/``): each backend is taken
where it raised before (CSV and Prometheus always; TensorBoard, W&B and
Comet when their package imports, else disabled with a log line, as the
JAX backends do); steps under telemetry give the losses of steps without
it, bit for bit; the MFU gauge is the model's FLOPs over the synced step
time and the peak; checkpoints run under their spans and leave flight
notes; the features of later items still raise, naming them."""
import importlib.util
import json

import numpy as np
import pytest
import torch

import deepspeed_tpu_torch as dst
from deepspeed_tpu_torch import telemetry as T
from deepspeed_tpu_torch.models import build_model
from deepspeed_tpu_torch.runtime.engine import model_step_flops


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def global_telem():
    """The process-wide instance, off and empty at the start (tests that
    ran before in this process may have left it on or its span ring
    full), restored after."""
    t = T.get_telemetry()
    prev = (t.enabled, t.recorder.path, t.recorder.dumps)
    t.reconfigure(enabled=False)
    t.registry.reset()
    t.tracer.clear()
    yield t
    t.reconfigure(enabled=prev[0])
    t.recorder.path, t.recorder.dumps = prev[1], prev[2]
    t.registry.reset()


def config(**over):
    cfg = {"train_micro_batch_size_per_gpu": 2,
           "gradient_accumulation_steps": 2,
           "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}},
           "bf16": {"enabled": False}, "steps_per_print": 1,
           "wall_clock_breakdown": True}
    cfg.update(over)
    return cfg


def batch(seed=0):
    rng = np.random.default_rng(seed)
    return {"input_ids": torch.from_numpy(rng.integers(0, 256, (4, 32)))}


def engine(**over):
    torch.manual_seed(0)
    e, *_ = dst.initialize(
        model=build_model("tiny-gpt2", device="cpu", dtype=torch.float32),
        config=config(**over), device="cpu")
    return e


PACKAGES = {"tensorboard": ("tensorboard", "tensorboardX"),
            "wandb": ("wandb",), "comet": ("comet_ml",),
            "csv_monitor": (), "prometheus": ()}


@pytest.mark.parametrize("backend", sorted(PACKAGES))
def test_each_monitor_backend_is_taken(backend, tmp_path, global_telem):
    sub = {"enabled": True, "output_path": str(tmp_path), "job_name": "j"}
    if backend == "wandb":
        sub["mode"] = "offline"
    if backend == "comet":
        sub["online"] = False
    e = engine(**{backend: sub})
    for _ in range(2):
        e.train_batch(batch())
    master = e._monitor_master
    assert master is not None            # the timer means reached it
    need = PACKAGES[backend]
    present = not need or any(importlib.util.find_spec(m) for m in need)
    assert master.enabled == present
    if backend == "csv_monitor":
        rows = (tmp_path / "j" / "Train_train_batch_ms.csv").read_text()
        assert rows.strip().split("\n")[0] == "step,value"
        assert [r.split(",")[0] for r in rows.strip().split("\n")[1:]] \
            == ["1", "2"]                 # a row per step
    if backend == "prometheus":
        text = global_telem.registry.render_prometheus()
        assert "Train_train_batch_ms " in text
        assert "monitor_last_step 2.0" in text
    if backend == "tensorboard" and present:
        assert list((tmp_path / "j").glob("events.out.tfevents.*"))


def test_telemetry_steps_equal_plain_steps_and_mfu(global_telem):
    """Telemetry adds no work to the step: the losses are bit for bit
    those of an engine without it; the MFU gauge is the model's FLOPs x
    steps over the summed synced step times and the peak."""
    plain = engine()
    want = [float(plain.train_batch(batch(i))) for i in range(3)]
    e = engine(telemetry={"enabled": True, "peak_tflops": 1e-3})
    got = [float(e.train_batch(batch(i))) for i in range(3)]
    assert got == want
    snap = global_telem.registry.snapshot()
    flops = model_step_flops(e.module, 4, 32)
    assert e._step_flops == flops
    assert e._mfu_tracker.total_steps == 3
    mfu = snap["train_mfu"]["series"][0]["value"]
    assert mfu == pytest.approx(
        flops * 3 / (e._mfu_tracker.total_time_s * 1e9))
    assert snap["train_goodput"]["series"][0]["value"] == pytest.approx(mfu)
    names = [ev["name"] for ev in global_telem.tracer.events()]
    assert names.count("train_batch") == 3


def test_model_step_flops_counts_weights_and_visible_pairs():
    """Dense: 2 x weights x tokens (embedding rows looked up, not
    multiplied; a tied head counted once) + 4 x head_dim x heads x layers
    x causal pairs, the forward, times 3 with the backward."""
    m = build_model("tiny-llama", device="cpu", dtype=torch.float32)
    c = m.config
    E, H, KV, D, F, L, V = (c.hidden_size, c.num_heads, c.kv_heads,
                            c.head_dim, c.ffn_size, c.num_layers,
                            c.vocab_size)
    weights = L * (2 * E * H * D + 2 * E * KV * D + 3 * E * F) + V * E
    B, S = 3, 20
    fwd = 2 * weights * B * S + 4 * D * H * L * (S * (S + 1) // 2) * B
    assert model_step_flops(m, B, S) == 3 * fwd
    moe = build_model("tiny-mixtral", device="cpu", dtype=torch.float32)
    mc = moe.config
    per_layer_experts = 3 * mc.hidden_size * mc.ffn_size * mc.moe.top_k
    dense_like = build_model("tiny-mixtral", device="cpu",
                             dtype=torch.float32, moe=None)
    assert model_step_flops(moe, 1, 8) - model_step_flops(dense_like, 1, 8) \
        == 3 * 2 * 8 * mc.num_layers * (
            per_layer_experts + mc.hidden_size * mc.moe.num_experts
            - 3 * mc.hidden_size * dense_like.config.ffn_size)


def test_checkpoint_spans_and_resilience_notes(tmp_path, global_telem):
    global_telem.reconfigure(enabled=True)
    e = engine(telemetry={"enabled": True})
    e.train_batch(batch())
    e.save_checkpoint(str(tmp_path / "ck"))
    e.load_checkpoint(str(tmp_path / "ck"))
    names = {ev["name"] for ev in global_telem.tracer.events()}
    assert {"checkpoint_save", "checkpoint_load"} <= names
    snap = global_telem.registry.snapshot()
    assert snap["checkpoint_save_call_s"]["series"][0]["count"] == 1
    assert snap["checkpoint_load_s"]["series"][0]["count"] == 1
    kinds = [ev["kind"] for ev in global_telem.recorder.events()]
    assert "checkpoint_save" in kinds and "checkpoint_load" in kinds
    assert "checkpoint_commit" in kinds
    dump = tmp_path / "dump.json"
    global_telem.flight_dump("test", path=str(dump))
    assert json.loads(dump.read_text())["reason"] == "test"


@pytest.mark.parametrize("over,match", [
    ({"flops_profiler": {"enabled": True}}, "item 7"),
    # tensor > 1 trains dense models, but not yet with ZeRO-Offload
    ({"mesh": {"tensor": 2}, "zero_optimization": {
        "stage": 1, "offload_optimizer": {"device": "cpu"}}}, "item 6")])
def test_later_items_still_raise(over, match):
    with pytest.raises(NotImplementedError, match=match):
        engine(**over)
