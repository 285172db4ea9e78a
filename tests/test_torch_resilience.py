"""The port's fault tolerance (``runtime/resilience.py`` and the checkpoint
integrity contract of ``runtime/checkpointing.py``): the host-side cases of
``tests/test_resilience.py`` — fault-spec parsing, the sentinel's skip →
rewind → abort, the watchdog's stack dump and exit code, the bounded
checkpoint wait, ``batch_for_step``, a bf16 non-finite step skipped, the
NaN rewind reconverging to the clean trajectory, the imperative-step
sentinel, the abort without a checkpoint, the torn ``latest`` and the
truncated tag, a corrupt manifest entry, a crash between commit and
``latest``, retention, the in-process SIGTERM priority save and the
maintenance hook — on a tiny linear-regression engine at world 1, and
where a rank matters at world 2 (the rewind, and the fallback resume on a
different mesh). The elastic agent's restart legs wait for the launcher
(ROADMAP queue 1, item 7)."""
import os
import signal
import subprocess
import sys
import textwrap
import threading
import time
import types

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.comm.spawn import RankPool
from deepspeed_tpu_torch.config import ResilienceConfig
from deepspeed_tpu_torch.runtime.resilience import (
    PREEMPTED_EXIT_CODE,
    WATCHDOG_EXIT_CODE,
    DivergenceError,
    DivergenceSentinel,
    FaultInjector,
    HangWatchdog,
    InjectedFault,
    Preempted,
    PreemptionHandler,
    parse_fault_spec,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W_DIM = 8
W_TRUE = np.arange(W_DIM, dtype=np.float32)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


class Linear(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.zeros(W_DIM))


def _loss_fn(model, batch):
    return torch.mean((batch["x"] @ model.w.float() - batch["y"]) ** 2)


def tiny_engine(resilience=None, stage=0, mesh=None, **over):
    import deepspeed_tpu_torch as dst

    cfg = {"train_micro_batch_size_per_gpu": 2,
           "optimizer": {"type": "AdamW", "params": {"lr": 1e-1}},
           "zero_optimization": {"stage": stage},
           "mesh": mesh or {"data": 1},
           "steps_per_print": 10_000}
    cfg.update(over)
    if resilience is not None:
        cfg["resilience"] = resilience
    return dst.initialize(model=Linear(), loss_fn=_loss_fn, config=cfg,
                          device="cpu")[0]


def batch_for(step, B):
    """Deterministic data order keyed on the global step — the rewind
    contract: the training loop re-derives its position from global_steps."""
    rng = np.random.default_rng(1000 + step)
    x = rng.standard_normal((B, W_DIM)).astype(np.float32)
    return {"x": x, "y": x @ W_TRUE}


def drive(engine, target, save_dir=None, save_every=2):
    """Train to ``target`` steps, re-deriving data from global_steps (so a
    rewind replays the exact stream); returns {step: loss}."""
    B = engine.config.train_batch_size
    losses = {}
    while engine.global_steps < target:
        loss = float(engine.train_batch(batch_for(engine.global_steps, B)))
        if engine.last_step_rewound:
            continue
        losses[engine.global_steps] = loss
        if save_dir is not None and engine.global_steps % save_every == 0:
            engine.save_checkpoint(save_dir)
    return losses


def _state_file(d, tag, min_size=1):
    state_dir = os.path.join(d, tag, "state")
    return next(os.path.join(dp, fn) for dp, _, fns in os.walk(state_dir)
                for fn in sorted(fns)
                if os.path.getsize(os.path.join(dp, fn)) > min_size)


# --------------------------------------------------------------------------
# pure-host units
# --------------------------------------------------------------------------

def test_fault_spec_parsing():
    assert parse_fault_spec(None) == {}
    assert parse_fault_spec("nan_grads_step=4,crash_before_latest") == {
        "nan_grads_step": 4, "crash_before_latest": True}
    assert parse_fault_spec('{"stall_train_step_s": 0.5}') == {
        "stall_train_step_s": 0.5}
    inj = FaultInjector({"nan_grads_step": 3})
    assert inj.nan_scale(2) == 1.0
    assert np.isnan(inj.nan_scale(3))
    assert inj.nan_scale(3) == 1.0      # single-shot: replay is clean


def test_sentinel_escalation_skip_rewind_abort():
    cfg = ResilienceConfig(loss_spike_factor=2.0, max_consecutive_bad=2,
                           max_rewinds=1)
    s = DivergenceSentinel(cfg)
    assert s.observe(1.0, True) == "ok"
    assert s.observe(float("nan"), True) == "skip"      # streak 1
    assert s.observe(1.0, False) == "rewind"            # streak 2 → escalate
    s.note_rewind()
    assert s.observe(1.0, True) == "ok"
    assert s.observe(10.0, True) == "spike"             # 10 > 2 * EMA
    assert s.observe(10.0, True) == "abort"             # budget (1) spent


def test_watchdog_dumps_all_thread_stacks_on_stall():
    reports = []
    wd = HangWatchdog(0.15, on_stall=reports.append)
    with wd.guard("probe"):
        time.sleep(0.5)
    assert wd.stall_count == 1
    assert "'probe' stalled" in reports[0]
    assert "MainThread" in reports[0] and "time.sleep" in reports[0]
    assert "devices: cpu" in reports[0]
    with wd.guard("fast"):     # completing inside the budget: no dump
        pass
    assert wd.stall_count == 1


def test_watchdog_self_terminates_with_distinct_code(tmp_path):
    script = tmp_path / "wd.py"
    script.write_text(textwrap.dedent("""
        import time
        from deepspeed_tpu_torch.runtime.resilience import HangWatchdog
        wd = HangWatchdog(0.1, exit_on_stall=True)
        with wd.guard("hang"):
            time.sleep(30)
    """))
    env = {**os.environ,
           "PYTHONPATH": os.environ.get("PYTHONPATH", "") + os.pathsep + ROOT}
    proc = subprocess.run([sys.executable, str(script)], env=env, timeout=120)
    assert proc.returncode == WATCHDOG_EXIT_CODE


def test_wait_for_checkpoint_timeout_is_structured():
    from deepspeed_tpu_torch.runtime.checkpointing import wait_for_checkpoint
    from deepspeed_tpu_torch.runtime.resilience import CheckpointWaitTimeout

    wedged = threading.Thread(target=time.sleep, args=(5,), daemon=True)
    wedged.start()
    eng = types.SimpleNamespace(_latest_thread=wedged)
    t0 = time.monotonic()
    with pytest.raises(CheckpointWaitTimeout) as ei:
        wait_for_checkpoint(eng, timeout_s=0.2)
    assert time.monotonic() - t0 < 3
    assert ei.value.phase == "commit+latest"
    assert ei.value.waited_s == pytest.approx(0.2)


def test_dataloader_batch_for_step_matches_iteration():
    from deepspeed_tpu_torch.runtime.data import DataLoader

    data = {"input_ids": np.arange(40 * 3).reshape(40, 3)}
    loader = DataLoader(data, batch_size=8, shuffle=True, seed=7)
    per_epoch = len(loader)
    stream = []
    for epoch in range(2):
        loader.set_epoch(epoch)
        stream.extend(b["input_ids"] for b in loader)
    for step in (0, 3, per_epoch, 2 * per_epoch - 1):
        np.testing.assert_array_equal(
            loader.batch_for_step(step)["input_ids"], stream[step])


# --------------------------------------------------------------------------
# engine integration
# --------------------------------------------------------------------------

def test_bf16_nonfinite_step_skipped():
    """A NaN at step 2 in a bf16 run (no fp16 scaler) skips the update and
    training goes on."""
    eng = tiny_engine(resilience={"fault_injection": {"nan_grads_step": 2},
                                  "max_consecutive_bad": 3},
                      bf16={"enabled": True})
    losses = drive(eng, 5)
    assert eng.skipped_steps == 1            # opt step didn't advance
    assert eng.resilience_counters["skipped_steps"] == 1
    assert eng.resilience_counters["rewinds"] == 0
    assert np.isnan(losses[3])               # the poisoned step's loss
    assert np.isfinite(losses[4]) and np.isfinite(losses[5])
    assert torch.isfinite(eng.master["w"]).all()


@pytest.mark.parametrize("stage", [0, 3])
def test_nan_rewind_reconverges_to_clean_trajectory(tmp_path, stage):
    """NaN at step k → rewind to the last verified checkpoint, data order
    replayed from the restored step → the recovered run reproduces the
    uninjected trajectory exactly."""
    clean = drive(tiny_engine(stage=stage), 8,
                  save_dir=str(tmp_path / "clean"))
    eng = tiny_engine(resilience={"fault_injection": {"nan_grads_step": 4},
                                  "max_consecutive_bad": 1, "max_rewinds": 2},
                      stage=stage)
    injected = drive(eng, 8, save_dir=str(tmp_path / "inj"))
    assert eng.resilience_counters["rewinds"] == 1
    assert injected == clean


def _rewind_at_world_2(d):
    clean = drive(tiny_engine(stage=2, mesh={"data": 2}), 6,
                  save_dir=os.path.join(d, "clean"))
    eng = tiny_engine(resilience={"fault_injection": {"nan_grads_step": 3},
                                  "max_consecutive_bad": 1},
                      stage=2, mesh={"data": 2})
    injected = drive(eng, 6, save_dir=os.path.join(d, "inj"))
    return clean, injected, eng.resilience_counters["rewinds"]


def _save_two_tags(d):
    eng = tiny_engine(stage=2, mesh={"data": 2})
    drive(eng, 2, save_dir=d, save_every=1)
    return eng.global_steps


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    p = RankPool(2, str(tmp_path_factory.mktemp("res_store")))
    yield p
    p.close()


def test_nan_rewind_at_world_2(pool, tmp_path):
    """Both ranks see the same reduced loss and flag, rewind together and
    replay the clean trajectory."""
    for clean, injected, rewinds in pool.run(_rewind_at_world_2,
                                             str(tmp_path)):
        assert rewinds == 1
        assert injected == clean


def test_imperative_step_sentinel_observes():
    """The forward/backward/step triplet is guarded too: step() feeds the
    sentinel."""
    def bad_batch(eng):
        B = eng.config.train_batch_size
        return {"x": np.ones((B, W_DIM), np.float32),
                "y": np.full((B,), np.inf, np.float32)}  # inf loss

    eng = tiny_engine(resilience={"max_consecutive_bad": 3})
    eng.backward(bad_batch(eng))
    eng.step()
    assert eng.skipped_steps == 1
    assert eng.resilience_counters["skipped_steps"] == 1

    eng2 = tiny_engine(resilience={"max_consecutive_bad": 1})
    eng2.backward(bad_batch(eng2))
    with pytest.raises(DivergenceError):     # no checkpoint to rewind to
        eng2.step()


def test_divergence_abort_without_checkpoint():
    eng = tiny_engine(resilience={"fault_injection": {"nan_grads_step": 1},
                                  "max_consecutive_bad": 1})
    B = eng.config.train_batch_size
    float(eng.train_batch(batch_for(0, B)))
    with pytest.raises(DivergenceError, match="no checkpoint"):
        eng.train_batch(batch_for(1, B))


def test_torn_latest_and_truncated_tag_fall_back(tmp_path):
    d = str(tmp_path / "ck")
    eng = tiny_engine(stage=1)
    drive(eng, 4, save_dir=d, save_every=2)   # tags at steps 2 and 4
    # (a) torn latest (empty file) → newest verified tag wins
    latest = os.path.join(d, "latest")
    open(latest, "w").close()
    e2 = tiny_engine()
    e2.load_checkpoint(d)
    assert e2.global_steps == 4
    # (b) latest names a tag whose state file is truncated → previous tag
    with open(latest, "w") as f:
        f.write("global_step4")
    victim = _state_file(d, "global_step4")
    with open(victim, "r+b") as f:
        f.truncate(os.path.getsize(victim) // 2)
    e3 = tiny_engine()
    e3.load_checkpoint(d)
    assert e3.global_steps == 2
    # (c) explicit tag request on the damaged tag fails loudly
    from deepspeed_tpu_torch.runtime.checkpointing import \
        CheckpointIntegrityError

    with pytest.raises(CheckpointIntegrityError, match="truncated"):
        tiny_engine().load_checkpoint(d, tag="global_step4")


def test_corrupt_manifest_entry_falls_back(tmp_path):
    d = str(tmp_path / "ck")
    eng = tiny_engine()
    drive(eng, 4, save_dir=d, save_every=2)
    # flip bytes in a step-4 state file: size unchanged, checksum wrong
    victim = _state_file(d, "global_step4", min_size=8)
    with open(victim, "r+b") as f:
        first = f.read(8)
        f.seek(0)
        f.write(bytes(b ^ 0xFF for b in first))
    e2 = tiny_engine()
    e2.load_checkpoint(d)
    assert e2.global_steps == 2


def test_crash_between_commit_and_latest_resumes_previous(tmp_path):
    """The mid-save kill matrix, via injection: state committed but
    'latest' not advanced → resume lands on the previous verified tag."""
    d = str(tmp_path / "ck")
    eng = tiny_engine()
    drive(eng, 2, save_dir=d, save_every=2)            # step-2 tag committed
    B = eng.config.train_batch_size
    float(eng.train_batch(batch_for(2, B)))
    for point in ("crash_after_commit", "crash_before_latest"):
        eng.resilience.injector.spec[point] = True     # arm mid-save kill
        eng.resilience.injector._consumed.discard(point)
        with pytest.raises(InjectedFault):
            eng.save_checkpoint(d, tag=f"doomed_{point}")
        e2 = tiny_engine()
        e2.load_checkpoint(d)
        assert e2.global_steps == 2                    # previous tag wins
    with open(os.path.join(d, "latest")) as f:
        assert f.read().strip() == "global_step2"


def test_retention_never_gcs_resume_target(tmp_path):
    d = str(tmp_path / "ck")
    eng = tiny_engine(checkpoint={"keep_n": 2})
    drive(eng, 3, save_dir=d, save_every=1)            # tags 1,2,3 → 1 GC'd
    tags = sorted(t for t in os.listdir(d) if t != "latest")
    assert tags == ["global_step2", "global_step3"]
    e2 = tiny_engine(checkpoint={"keep_n": 2})
    e2.load_checkpoint(d, tag="global_step2")          # resume target
    drive(e2, 5, save_dir=d, save_every=1)             # saves 3(over), 4, 5
    tags = sorted(t for t in os.listdir(d) if t != "latest")
    assert "global_step2" in tags
    assert "global_step5" in tags and "global_step4" in tags


def test_preemption_sigterm_priority_save_in_process(tmp_path):
    d = str(tmp_path / "ck")
    old = signal.getsignal(signal.SIGTERM)
    try:
        eng = tiny_engine()
        drive(eng, 2, save_dir=d, save_every=2)
        B = eng.config.train_batch_size
        os.kill(os.getpid(), signal.SIGTERM)           # the eviction notice
        with pytest.raises(Preempted) as ei:
            eng.train_batch(batch_for(2, B))
        assert ei.value.code == PREEMPTED_EXIT_CODE
        assert ei.value.checkpoint_path is not None
        from deepspeed_tpu_torch.checkpoint import tag_status

        status, _ = tag_status(ei.value.checkpoint_path)
        assert status == "verified"
        e2 = tiny_engine()
        e2.load_checkpoint(d)
        assert e2.global_steps == 2                    # saved BEFORE step 3
        assert PreemptionHandler.instance().check() is None  # latch cleared
    finally:
        signal.signal(signal.SIGTERM, old)


def test_preemption_maintenance_hook(tmp_path):
    d = str(tmp_path / "ck")
    eng = tiny_engine(resilience={"preemption_signals": []})
    eng.resilience.preemption = PreemptionHandler.instance()
    drive(eng, 2, save_dir=d, save_every=2)
    fired = {"n": 0}

    def maintenance_event():
        fired["n"] += 1
        return fired["n"] >= 2          # second poll reports the event

    eng.resilience.preemption.register_hook(maintenance_event)
    try:
        B = eng.config.train_batch_size
        float(eng.train_batch(batch_for(2, B)))        # poll 1: healthy
        with pytest.raises(Preempted) as ei:
            eng.train_batch(batch_for(3, B))           # poll 2: evicted
        assert "maintenance" in ei.value.cause
    finally:
        eng.resilience.preemption._hooks.clear()
        PreemptionHandler.instance().clear()


def test_fallback_resume_on_a_different_mesh(pool, tmp_path):
    """A corrupted newest tag written by two ranks at stage 2, resumed by
    one rank at stage 3: the verified fallback composes with the
    resharding load."""
    d = str(tmp_path / "ck")
    assert pool.run(_save_two_tags, d) == [2, 2]
    victim = _state_file(d, "global_step2")
    with open(victim, "r+b") as f:
        f.truncate(os.path.getsize(victim) // 2)
    eng = tiny_engine(stage=3, train_micro_batch_size_per_gpu=4)
    eng.load_checkpoint(d)
    assert eng.global_steps == 1             # fell back past the torn tag
    B = eng.config.train_batch_size
    assert np.isfinite(float(eng.train_batch(batch_for(1, B))))
