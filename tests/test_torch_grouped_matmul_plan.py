"""K5's route plan in the port (``deepspeed_tpu_torch.ops.grouped_matmul``):
which of the card's kernels a call takes, from dtype and ``block_m`` alone
(``gmm_route``), the rows of a wgmma block (``gmm_block_rows``), how a
launch names its entry and counts its route, and that the CPU route still
runs the plain versions at the wgmma route's tile sizes.

The plain versions at ``block_m`` 64 and 128 are held against the JAX
package's Pallas ``grouped_matmul`` and its VJP
(``deepspeed_tpu/ops/pallas/grouped_matmul.py``, interpret mode on the CPU
as ``tests/test_moe.py`` runs it), on the same seeded numpy inputs. bf16
tolerance: 1e-2 of the largest |JAX| value (each output is one bf16
rounding, up to 2^-8 relative, of an fp32 sum). The launch tests replace
the kernel library with a recorder: no CUDA kernel runs on the CPU."""
import dataclasses
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.pallas import grouped_matmul as jg
from deepspeed_tpu_torch.models import get_model_config
from deepspeed_tpu_torch.models.transformer import MoEConfig
from deepspeed_tpu_torch.moe.layer import MoE
from deepspeed_tpu_torch.ops import grouped_matmul as tg
from deepspeed_tpu_torch.ops import kernels


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("dtype,block_m,route", [
    (torch.bfloat16, 64, "wgmma"), (torch.bfloat16, 128, "wgmma"),
    (torch.bfloat16, 256, "wgmma"), (torch.bfloat16, 32, "wmma"),
    (torch.bfloat16, 96, "wmma"), (torch.float32, 32, "fma"),
    (torch.float32, 64, "fma"), (torch.float32, 128, "fma")])
def test_route_follows_dtype_and_block_m(dtype, block_m, route):
    assert tg.gmm_route(dtype, block_m) == route


@pytest.mark.parametrize("tokens,k,n,block_m,rows", [
    (8, 4, 60, 128, 64),        # qwen2-moe decode: ~1 row an expert
    (4096, 4, 60, 128, 128),    # a train micro-batch: ~273 rows an expert
    (2048, 4, 60, 128, 128),    # a prefill chunk: ~137 rows an expert
    (8, 2, 8, 128, 64),         # Mixtral decode
    (512, 2, 8, 128, 128),      # Mixtral prefill: 128 rows an expert
    (4096, 4, 60, 64, 64),      # block_m 64: one warpgroup a tile
    (4096, 4, 60, 256, 128),
    (240, 1, 4, 128, 64),       # 60 rows an expert, on the line
    (264, 1, 4, 128, 128)])     # 66 rows an expert, past it
def test_block_rows_follow_rows_per_expert(tokens, k, n, block_m, rows):
    """The wgmma forward / dx block owns 128 rows only where block_m allows
    it and the sort's buffer leaves more than 64 routed rows an expert."""
    idx = torch.arange(tokens * k).reshape(tokens, k) % n
    Tp = tg.sort_tokens_by_expert(idx, n, block_m).Tp
    assert tg.gmm_block_rows(Tp, n, block_m) == rows


def test_route_refuses_other_dtypes():
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tg.gmm_route(torch.float16, 128)


@pytest.mark.parametrize("source", ["MoEConfig", "MoE", "qwen2-moe-a2.7b",
                                    "mixtral-8x7b"])
def test_default_block_m_takes_the_wgmma_route(source):
    """The serving engine and the train path sort at the model's
    ``moe.dropless_block_m``, the MoE layer at its own default: in bf16
    every one of them lands on the wgmma kernels."""
    if source == "MoEConfig":
        block_m = MoEConfig().dropless_block_m
    elif source == "MoE":
        block_m = inspect.signature(MoE).parameters[
            "dropless_block_m"].default
    else:
        block_m = get_model_config(source).moe.dropless_block_m
    assert tg.gmm_route(torch.bfloat16, block_m) == "wgmma"


def _inputs(block_m, seed):
    """(buf, w, dy, JAX tile_expert, the port's sort, n): 40 tokens x top-2
    over 4 experts, K 64, N 80, one seeded routing."""
    T, k, n, K, N = 40, 2, 4, 64, 80
    rng = np.random.default_rng(seed)
    eidx = np.argsort(rng.random((T, n)), axis=1)[:, :k].astype(np.int32)
    srt = jg.sort_tokens_by_expert(jnp.asarray(eidx), n, block_m)
    buf = np.zeros((srt.Tp, K), np.float32)
    buf[np.asarray(srt.dst)] = np.repeat(
        rng.standard_normal((T, K)).astype(np.float32), k, axis=0)
    w = (rng.standard_normal((n, K, N)) / np.sqrt(K)).astype(np.float32)
    dy = rng.standard_normal((srt.Tp, N)).astype(np.float32)
    port = tg.sort_tokens_by_expert(torch.from_numpy(eidx), n, block_m)
    return buf, w, dy, np.array(srt.tile_expert), port, n


def _judged(got, ref):
    ref = np.asarray(ref, np.float32)
    return np.abs(got.float().numpy() - ref).max() / np.abs(ref).max()


@pytest.mark.parametrize("block_m", [64, 128])
def test_cpu_route_runs_the_plain_versions_at_wgmma_tiles(block_m):
    """bf16 CPU tensors at a block_m the card would run on wgmma: the
    forward, dx and dw go through the plain versions (counted as such, no
    kernel counted) and agree with the Pallas forward and its VJP."""
    buf, w, dy, te, srt, n = _inputs(block_m, seed=block_m)
    jd = jnp.bfloat16
    ref, vjp = jax.vjp(lambda x, ww: jg.grouped_matmul(
        x, ww, jnp.asarray(te), block_m), jnp.asarray(buf, jd),
        jnp.asarray(w, jd))
    ref_dx, ref_dw = vjp(jnp.asarray(dy, jd))
    tg.counts.reset()
    x = torch.from_numpy(buf).to(torch.bfloat16).requires_grad_()
    wt = torch.from_numpy(w).to(torch.bfloat16).requires_grad_()
    out = tg.grouped_matmul(x, wt, srt.tile_expert, block_m)
    out.backward(torch.from_numpy(dy).to(torch.bfloat16))
    assert (tg.counts.plain, tg.counts.plain_dx, tg.counts.plain_dw) == \
        (1, 1, 1)
    assert tg.counts.kernel == tg.counts.kernel_tc == 0
    assert tg.counts.kernel_dx == tg.counts.kernel_dw == 0
    for got, want in ((out.detach(), ref), (x.grad, ref_dx),
                      (wt.grad, ref_dw)):
        assert got.dtype == torch.bfloat16
        assert _judged(got, want) <= 1e-2


class _Recorder:
    """Stands in for the kernel library: records each entry's name and its
    integer arguments, and returns ``err``."""

    def __init__(self, err=0):
        self.calls, self.ints, self.err = [], [], err

    def __getattr__(self, name):
        if not name.startswith("ds_"):
            raise AttributeError(name)

        def entry(*args):
            self.calls.append(name)
            self.ints.append(args[5:-1])
            return self.err
        return entry


@pytest.fixture
def recorder(monkeypatch):
    rec = _Recorder()
    monkeypatch.setattr(kernels, "load", lambda name: rec)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None:
                        type("S", (), {"cuda_stream": 0})())
    return rec


def _launch_all(dtype, block_m):
    """The three launches on CPU tensors through the kernel route's own
    functions (the recorder runs nothing)."""
    T, n, K, N = 2 * block_m, 2, 64, 32
    x = torch.zeros(T, K, dtype=dtype)
    w = torch.zeros(n, K, N, dtype=dtype)
    dy = torch.zeros(T, N, dtype=dtype)
    te = torch.tensor([0, 1], dtype=torch.int32)
    tg._launch_kernel(x, w, te, block_m, None)
    tg._launch_dx(dy, w, te, block_m, None)
    tg._launch_dw(x, dy, te, n, block_m, None, None)


@pytest.mark.parametrize("dtype,block_m,suffix", [
    (torch.bfloat16, 128, "_tc"), (torch.bfloat16, 64, "_tc"),
    (torch.bfloat16, 32, ""), (torch.bfloat16, 96, ""),
    (torch.float32, 128, ""), (torch.float32, 64, "")])
def test_launch_names_the_route_and_counts_it(recorder, dtype, block_m,
                                              suffix):
    tg.counts.reset()
    _launch_all(dtype, block_m)
    assert recorder.calls == [f"ds_grouped_matmul{s}{suffix}"
                              for s in ("", "_dx", "_dw")]
    # Tp, K, N, n, block_m, [block_rows,] dtype: the wgmma forward and dx
    # also name their block's rows (two experts of one tile each: 64)
    geometry = (2 * block_m, 64, 32, 2, block_m)
    code = 1 if dtype == torch.bfloat16 else 0
    fwd = geometry + ((64,) if suffix else ()) + (code,)
    assert recorder.ints == [fwd, fwd, geometry + (code,)]
    tc = int(suffix == "_tc")
    assert dataclasses.asdict(tg.counts) == dict(
        kernel=1, plain=0, kernel_dx=1, kernel_dw=1, plain_dx=0, plain_dw=0,
        kernel_tc=tc, kernel_dx_tc=tc, kernel_dw_tc=tc)


@pytest.mark.parametrize("err,match", [(1, "CUDA error 1"),
                                       (1001, "tensor map CUresult 1")])
def test_a_refused_launch_raises_and_is_not_counted(recorder, err, match):
    recorder.err = err
    tg.counts.reset()
    with pytest.raises(RuntimeError, match=match):
        _launch_all(torch.bfloat16, 128)
    assert tg.counts.kernel == tg.counts.kernel_tc == 0
