"""The port's configuration (``deepspeed_tpu_torch.config``) against the JAX
package's: the same defaults, the same parsed sections from one
DeepSpeed-style dict or JSON file, the same batch terms from
``resolve_batch_terms`` and the same errors; and the port's one-process
mesh."""
import dataclasses
import json

import jax.numpy as jnp
import pytest
import torch

from deepspeed_tpu import config as jcfg
from deepspeed_tpu_torch import config as tcfg
from deepspeed_tpu_torch.parallel.topology import (MeshConfig, MeshTopology,
                                                   single_device_topology)

FULL = {
    "train_batch_size": 32,
    "gradient_accumulation_steps": 4,
    "steps_per_print": 5,
    "gradient_clipping": 1.0,
    "optimizer": {"type": "Lamb", "params": {"lr": 3e-4}, "legacy_fusion": 1},
    "scheduler": {"type": "WarmupLR", "params": {"warmup_num_steps": 10}},
    "fp16": {"enabled": True, "initial_scale_power": 8, "auto_cast": False},
    "zero_optimization": {"stage": 0, "allgather_partitions": True,
                          "offload_optimizer": {"device": "none"}},
    "activation_checkpointing": {"policy": "dots_saveable",
                                 "contiguous_memory_optimization": True},
    "resilience": {"max_consecutive_bad": 5},
    "amp": {"enabled": False},
    "bfloat16": {"enabled": False},
    "curriculum_learning": {"enabled": True, "curriculum_type": "seqlen"},
}


def _dicts(d):
    return (dataclasses.asdict(jcfg.Config.load(dict(d))),
            dataclasses.asdict(tcfg.Config.load(dict(d))))


def test_defaults_match():
    assert dataclasses.asdict(tcfg.Config()) == \
        dataclasses.asdict(jcfg.Config())
    assert tcfg.Config().bf16.enabled
    assert tcfg.DeepSpeedConfig is tcfg.Config


@pytest.mark.parametrize("d", [{}, FULL, {"train_micro_batch_size_per_gpu":
                                          "auto", "mesh": {"data": 1}}])
def test_load_matches(d, tmp_path):
    j, t = _dicts(d)
    assert j == t
    path = tmp_path / "ds.json"
    path.write_text(json.dumps(d))
    assert dataclasses.asdict(tcfg.Config.load(str(path))) == j


@pytest.mark.parametrize("fp16,bf16,want", [(True, True, torch.float16),
                                            (False, True, torch.bfloat16),
                                            (False, False, torch.float32)])
def test_compute_dtype(fp16, bf16, want):
    d = {"fp16": {"enabled": fp16}, "bf16": {"enabled": bf16}}
    assert tcfg.Config.load(d).compute_dtype == want
    assert jnp.dtype(jcfg.Config.load(d).compute_dtype).name == \
        str(want).replace("torch.", "")


TERMS = [
    ({"train_batch_size": 16, "train_micro_batch_size_per_gpu": 2}, 1),
    ({"train_batch_size": 16, "gradient_accumulation_steps": 4}, 2),
    ({"train_micro_batch_size_per_gpu": 3}, 4),
    ({"train_micro_batch_size_per_gpu": 3, "gradient_accumulation_steps": 2},
     1),
    ({"train_batch_size": 12}, 3),
    ({}, 1),
    ({"train_batch_size": "auto", "train_micro_batch_size_per_gpu": 2,
      "gradient_accumulation_steps": "auto"}, 2),
    ({"train_batch_size": 8, "train_micro_batch_size_per_gpu": 2,
      "gradient_accumulation_steps": 2}, 2),
    ({"train_batch_size": 10, "train_micro_batch_size_per_gpu": 4}, 1),
    ({"train_batch_size": 10, "gradient_accumulation_steps": 4}, 1),
    ({"train_batch_size": 9}, 2),
    ({"train_batch_size": 8, "train_micro_batch_size_per_gpu": 2,
      "gradient_accumulation_steps": 3}, 1),
]


@pytest.mark.parametrize("d,dp", TERMS)
def test_resolve_batch_terms_matches(d, dp):
    def run(mod):
        c = mod.Config.load(dict(d))
        try:
            c.resolve_batch_terms(dp)
        except ValueError as e:
            return "error", str(e)
        return (c.train_batch_size, c.train_micro_batch_size_per_gpu,
                c.gradient_accumulation_steps)

    assert run(tcfg) == run(jcfg)


@pytest.mark.parametrize("d", [{"bogus": 1}, {"optimizer": {"kind": "x"}},
                               {"zero_optimization": {"stage": 4}},
                               {"mesh": {"model": 2}},
                               {"checkpoint": {"integrity": "md5"}}])
def test_errors_match(d):
    with pytest.raises(ValueError) as je:
        jcfg.Config.load(dict(d))
    with pytest.raises(ValueError) as te:
        tcfg.Config.load(dict(d))
    assert str(te.value) == str(je.value)


def test_one_process_mesh():
    topo = MeshTopology(MeshConfig())
    assert topo.axis_sizes == {"pipe": 1, "data": 1, "expert": 1, "fsdp": 1,
                               "seq": 1, "tensor": 1}
    assert topo.dp_world_size == topo.size("tensor") == 1
    assert single_device_topology().dp_world_size == 1
    # data and fsdp may exceed 1 over that many processes: in a world of one
    # the mesh does not resolve (tensor serves and seq trains over that many
    # processes); a later parallel axis still waits for its item
    for axis in ("fsdp", "tensor", "seq"):
        with pytest.raises(ValueError, match="device count 1"):
            MeshTopology({axis: 2})
    for axis in ("pipe", "expert"):
        with pytest.raises(NotImplementedError, match="item 6"):
            MeshTopology({axis: 2})
    with pytest.raises(ValueError, match="unknown mesh axes"):
        MeshConfig.from_dict({"model": 2})
