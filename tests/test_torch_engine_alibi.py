"""ALiBi models in the port's engine: the kernel takes no positional bias,
so the registry serves them outside the kernel (path "gather", reason
"alibi"), as the JAX engine does, through the plain version with its
``alibi_slopes`` bias. Greedy streams of tiny-bloom (head_dim
64) against the JAX engine (``use_pallas_decode=False``, fp32), with the
prefix cache on and off."""
import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference import InferenceEngineV2 as JaxEngine
from deepspeed_tpu.models import build_model as jax_build_model
from deepspeed_tpu.parallel.topology import MeshTopology
from deepspeed_tpu_torch.inference import InferenceEngineV2, params_from_jax
from deepspeed_tpu_torch.models import build_model
from deepspeed_tpu_torch.ops import paged_attention as pa

BASE = dict(block_size=8, num_blocks=96, max_seqs=4, chunk=16,
            max_seq_len=128)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def bloom():
    jm = jax_build_model("tiny-bloom", dtype=jnp.float32, hidden_size=256)
    params = jm.init(jax.random.PRNGKey(1),
                     jnp.zeros((1, 8), jnp.int32))["params"]
    host = jax.device_get(flax.core.meta.unbox(params))
    rng = np.random.default_rng(2)
    prompts = [[int(t) for t in rng.integers(0, 256, n)] for n in (33, 6, 19)]
    prompts.append(prompts[0][:24] + [5, 6])
    je = JaxEngine(jm, params=params,
                   config=dict(BASE, dtype=jnp.float32,
                               use_pallas_decode=False),
                   topology=MeshTopology({"tensor": 1, "data": 1}))
    ref = je.generate(prompts, max_new_tokens=8)
    tm = build_model("tiny-bloom", device="cpu", dtype=torch.float32,
                     hidden_size=256)
    return tm, params_from_jax(host, tm.config, dtype=torch.float32,
                               device="cpu"), prompts, ref


@pytest.mark.parametrize("prefix_cache", [None, False])
def test_alibi_streams_match_the_jax_engine(bloom, prefix_cache):
    tm, tree, prompts, ref = bloom
    eng = InferenceEngineV2(tm, params=tree, config=dict(
        BASE, dtype=torch.float32, device="cpu", prefix_cache=prefix_cache))
    sel = eng._attn_decode_sel
    assert sel.path == "gather" and "alibi" in sel.reason
    plain0 = pa.counts.plain
    assert eng.generate(prompts, max_new_tokens=8) == ref
    eng.state.audit()
    assert pa.counts.plain == plain0          # the kernel's route never ran
    assert eng.stats["attn_gather_decode"] > 0
