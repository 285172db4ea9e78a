"""The port's native plan packer (``csrc/atoms.cpp``, ``dstpu_build_atoms``
in the host library) against the scheduler's Python packer and the JAX
package's native builder, over randomised plans on linear and rolling-ring
block tables; the serving path packs every plan natively and a failed
host-library build raises."""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.inference.ragged import StateManager, StepPlan
from deepspeed_tpu_torch.inference.scheduler import SplitFuseScheduler
from deepspeed_tpu_torch.ops import native

ARRAYS = ("token_ids", "positions", "slot_map", "active", "block_tables",
          "seq_lens", "sample_idx", "do_sample")


def _plan(cls, S, T, max_blocks):
    return cls(kind="prefill",
               token_ids=np.zeros((S, T), np.int32),
               positions=np.zeros((S, T), np.int32),
               slot_map=np.zeros((S, T), np.int32),
               active=np.zeros((S, T), np.uint8),
               block_tables=np.zeros((S, max_blocks), np.int32),
               seq_lens=np.zeros(S, np.int32),
               sample_idx=np.zeros(S, np.int32),
               do_sample=np.zeros(S, np.uint8),
               use_last=np.zeros(S, np.uint8),
               row_slots=np.zeros(S, np.int32), uids=[-1] * S)


def _random_entries(rng, S, T, bs, max_blocks, ring):
    """Random rows: each an entry (seq, tokens, start_pos, sample) on a
    distinct slot; ring plans start past the table's span so the slot
    formula wraps."""
    n_rows = int(rng.integers(1, S + 1))
    slots = rng.permutation(S)[:n_rows]
    entries = []
    for r, slot in enumerate(slots):
        n = int(rng.integers(1, T + 1))
        span = max_blocks * bs
        start = int(rng.integers(span, 4 * span)) if ring \
            else int(rng.integers(0, span - n + 1))
        blocks = [int(b) for b in rng.permutation(
            np.arange(1, 4 * max_blocks))[:max_blocks]]
        if not ring:
            blocks = blocks[:-(-(start + n) // bs)]
        seq = SimpleNamespace(uid=int(rng.integers(0, 10 ** 6)),
                              slot=int(slot), blocks=blocks)
        toks = [int(t) for t in rng.integers(0, 32000, n)]
        entries.append((seq, toks, start, bool(rng.integers(0, 2))))
    return entries


@pytest.mark.parametrize("ring", [False, True], ids=["linear", "ring"])
@pytest.mark.parametrize("packed", [False, True], ids=["full", "packed"])
def test_native_packer_matches_python_and_jax(ring, packed):
    from deepspeed_tpu.inference.ragged import StepPlan as JaxStepPlan
    from deepspeed_tpu.inference.scheduler import \
        SplitFuseScheduler as JaxScheduler
    from deepspeed_tpu.ops.native import load_library as jax_library

    rng = np.random.default_rng(7 + 2 * ring + packed)
    bs, max_blocks, S = 16, 8, 8
    st = StateManager(num_blocks=64, block_size=bs, max_seqs=S,
                      max_blocks_per_seq=max_blocks)
    sched = SplitFuseScheduler(st, chunk=32)
    jst = SimpleNamespace(block_size=bs, max_blocks_per_seq=max_blocks,
                          max_seqs=S)
    jsched = JaxScheduler.__new__(JaxScheduler)
    jsched.state = jst
    assert jax_library() is not None, "the JAX package's builder"
    for _ in range(40):
        T = int(rng.choice([1, 16, 32, 64]))
        entries = _random_entries(rng, S, T, bs, max_blocks, ring)
        rows = len(entries) if packed else S
        row_of = {seq.slot: (r if packed else seq.slot)
                  for r, (seq, *_) in enumerate(entries)}
        nat, ref = _plan(StepPlan, rows, T, max_blocks), \
            _plan(StepPlan, rows, T, max_blocks)
        before = sched.native_plans
        sched._native_build(nat, T, entries, row_of)
        assert sched.native_plans == before + 1
        sched._python_build(ref, T, entries, row_of)
        for a in ARRAYS:
            np.testing.assert_array_equal(getattr(nat, a), getattr(ref, a),
                                          err_msg=a)
        jp = _plan(JaxStepPlan, rows, T, max_blocks)
        assert jsched._native_build(jp, T, entries, row_of)
        for a in ARRAYS:
            np.testing.assert_array_equal(getattr(nat, a), getattr(jp, a),
                                          err_msg=a)


def test_native_packer_refuses_a_row_wider_than_the_plan():
    st = StateManager(num_blocks=16, block_size=4, max_seqs=2,
                      max_blocks_per_seq=4)
    sched = SplitFuseScheduler(st, chunk=4)
    seq = SimpleNamespace(uid=1, slot=0, blocks=[1, 2])
    plan = _plan(StepPlan, 2, 4, 4)
    with pytest.raises(ValueError, match="atom builder: entry 0"):
        sched._native_build(plan, 4, [(seq, list(range(5)), 0, True)],
                            {0: 0})


def test_serving_path_packs_every_plan_natively(monkeypatch):
    """A served workload: every scheduler plan went through the native
    builder, and the Python packer was never called."""
    from deepspeed_tpu_torch.inference import InferenceEngineV2
    from deepspeed_tpu_torch.models import build_model

    def refuse(*a, **k):
        raise AssertionError("the Python packer ran on the serving path")

    monkeypatch.setattr(SplitFuseScheduler, "_python_build", refuse)
    torch.manual_seed(0)
    eng = InferenceEngineV2(
        build_model("tiny-llama", device="cpu", dtype=torch.float32),
        config={"block_size": 8, "num_blocks": 64, "max_seqs": 4,
                "chunk": 16, "max_seq_len": 128, "dtype": torch.float32,
                "device": "cpu"})
    rng = np.random.default_rng(3)
    eng.generate([[int(t) for t in rng.integers(0, 256, n)]
                  for n in (40, 5, 21, 37)], max_new_tokens=9)
    st = eng.stats
    assert eng.scheduler.native_plans == st["prefill_steps"] + \
        st["decode_steps"] > 0


def test_failed_host_library_build_raises(monkeypatch, tmp_path):
    """No quiet fallback: a host library that cannot be built raises from
    the scheduler, with the compiler's complaint."""
    st = StateManager(num_blocks=16, block_size=4, max_seqs=2,
                      max_blocks_per_seq=4)
    sched = SplitFuseScheduler(st, chunk=4)
    st.admit(1, list(range(6)), max_new_tokens=2)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setenv("CXX", "false")
    with pytest.raises(RuntimeError, match="host library build failed"):
        sched.next_step()
