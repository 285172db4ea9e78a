"""The port's learning-rate schedules (``deepspeed_tpu_torch.runtime.
lr_schedules``) against the JAX package's, step by step over a range that
crosses every phase, through ``build_scheduler`` as the engines resolve
them."""
import jax.numpy as jnp
import numpy as np
import pytest

from deepspeed_tpu.runtime import lr_schedules as jls
from deepspeed_tpu_torch.runtime import lr_schedules as tls

CASES = [
    ("WarmupLR", {"warmup_min_lr": 1e-5, "warmup_max_lr": 1e-3,
                  "warmup_num_steps": 20}),
    ("WarmupLR", {"warmup_max_lr": 3e-4, "warmup_num_steps": 16,
                  "warmup_type": "linear"}),
    ("WarmupLR", {"warmup_num_steps": 1}),
    ("WarmupDecayLR", {"total_num_steps": 60, "warmup_min_lr": 1e-5,
                       "warmup_max_lr": 1e-3, "warmup_num_steps": 10}),
    ("WarmupCosineLR", {"total_num_steps": 60, "warmup_num_steps": 10,
                        "warmup_min_ratio": 0.1}),
    ("OneCycle", {"cycle_min_lr": 1e-4, "cycle_max_lr": 1e-2,
                  "cycle_first_step_size": 10, "cycle_second_step_size": 15,
                  "decay_step_size": 5, "decay_lr_rate": 0.1}),
    ("OneCycle", {"cycle_min_lr": 1e-4, "cycle_max_lr": 1e-2,
                  "cycle_first_step_size": 10}),
    ("LRRangeTest", {"lr_range_test_min_lr": 1e-4,
                     "lr_range_test_step_size": 7,
                     "lr_range_test_step_rate": 2.0}),
    ("LRRangeTest", {"lr_range_test_min_lr": 1e-4,
                     "lr_range_test_step_size": 7,
                     "lr_range_test_staircase": True}),
]


@pytest.mark.parametrize("name,params", CASES,
                         ids=[f"{n}-{i}" for i, (n, _) in enumerate(CASES)])
def test_schedule_matches_the_jax_schedule(name, params):
    js = jls.build_scheduler(name, dict(params), base_lr=2e-3)
    ts = tls.build_scheduler(name, dict(params), base_lr=2e-3)
    steps = range(0, 70)
    want = np.array([float(js(jnp.int32(s))) for s in steps], np.float32)
    got = np.array([ts(s) for s in steps], np.float32)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_constant_and_unknown():
    assert tls.constant_lr(3e-4)(5) == float(jls.constant_lr(3e-4)(5))
    with pytest.raises(ValueError, match="unknown scheduler"):
        tls.build_scheduler("Cyclic", {})
