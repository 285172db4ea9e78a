"""Imported HF checkpoints serve through the port's v2 engine, greedy-
matching transformers' own generate — a copy of tests/test_hf_serving.py
on tiny fp32 models (the port's engine has no compile step, so these run
in the default tier), plus phi and qwen v1: with falcon (MQA, parallel
block), opt, qwen2-moe, bloom (ALiBi) and gpt-neox (generic import) they
serve every family the JAX suite's engine parity did not."""
import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from test_torch_hf_import import (_bloom, _falcon, _neox, _opt,  # noqa: E402
                                  _phi, _qwen2_moe, qwen_v1_shim)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _serve(model, params, prompt, n_new, max_inflight):
    from deepspeed_tpu_torch.inference import InferenceEngineV2

    eng = InferenceEngineV2(
        model, params=params,
        config={"block_size": 8, "num_blocks": 32, "max_seqs": 2,
                "chunk": 8, "max_seq_len": 64, "dtype": torch.float32,
                "max_inflight": max_inflight, "device": "cpu"})
    return eng.generate([prompt], max_new_tokens=n_new)[0]


def _serve_and_compare(hf, oracle=None, n_prompt=10, n_new=8, vocab=128):
    # min_new_tokens stops HF's eos early-exit: the v2 engine is run
    # without an eos and always emits n_new tokens
    from deepspeed_tpu_torch.models.hf import from_hf_model

    model, params = from_hf_model(hf, dtype=torch.float32, device="cpu")
    prompt = list(map(int, np.random.default_rng(0).integers(
        0, vocab, (n_prompt,))))
    with torch.no_grad():
        ref = (oracle or hf).generate(
            torch.tensor([prompt]), max_new_tokens=n_new,
            min_new_tokens=n_new, do_sample=False)
    want = ref[0, len(prompt):].tolist()
    for inflight in (0, 8):
        assert _serve(model, params, prompt, n_new, inflight) == want, \
            inflight


@pytest.mark.parametrize("build", [_opt, _falcon, _bloom, _qwen2_moe,
                                   _neox, _phi],
                         ids=["opt", "falcon-mqa", "bloom-alibi",
                              "qwen2-moe", "generic-neox", "phi"])
def test_family_serves_matching_hf_generate(build):
    torch.manual_seed(0)
    _serve_and_compare(build().eval())


def test_qwen_v1_serves_matching_its_oracle():
    """qwen v1 (a renamed qwen2 state dict; no transformers class) serves
    the oracle's greedy stream."""
    torch.manual_seed(0)
    shim, oracle = qwen_v1_shim()
    _serve_and_compare(shim, oracle=oracle)
