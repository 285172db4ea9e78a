"""The port's host library (``deepspeed_tpu_torch/csrc`` built by
``ops/native.py``): its Adam / AdamW / Adagrad / Lion steps bit for bit
the JAX package's native steps (the same source, the same flags) on the
same seeded inputs, odd lengths and bias correction off included; the
plain torch versions within 1e-6 relative of both; the fp32 → bf16 cast;
``build_cpu_optimizer``; a failed build raising with the compiler's
output; and ``AsyncIOHandle`` round trips, native and plain."""
import os

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.ops import native
from deepspeed_tpu_torch.ops.aio import AsyncIOHandle
from deepspeed_tpu_torch.ops.cpu_optimizer import (CPUAdagrad, CPUAdam,
                                                   CPULion,
                                                   build_cpu_optimizer,
                                                   f32_to_bf16)

STEPS = 3


def jax_opt(kind, **kw):
    from deepspeed_tpu.ops import cpu_optimizer as jco
    from deepspeed_tpu.ops.native import load_library

    assert load_library() is not None, "the JAX package's native build"
    return getattr(jco, kind)(**kw)


CASES = [
    ("CPUAdam", dict(lr=1e-3, weight_decay=0.01, adamw_mode=True), 4097),
    ("CPUAdam", dict(lr=1e-3, weight_decay=0.01, adamw_mode=False), 1001),
    ("CPUAdam", dict(lr=3e-4, betas=(0.8, 0.95), eps=1e-6,
                     weight_decay=0.0, bias_correction=False), 65537),
    ("CPUAdam", dict(lr=1e-2, weight_decay=0.1, adamw_mode=True,
                     bias_correction=False), 17),
    ("CPUAdagrad", dict(lr=1e-2, eps=1e-10, weight_decay=0.01), 4099),
    ("CPUAdagrad", dict(lr=5e-2), 3),
    ("CPULion", dict(lr=1e-4, betas=(0.9, 0.99), weight_decay=0.01), 8191),
    ("CPULion", dict(lr=1e-3), 129),
]
IDS = [f"{k}-{n}-{i}" for i, (k, _, n) in enumerate(CASES)]


def run_port(kind, kw, n, native_step=True):
    from deepspeed_tpu_torch.ops import cpu_optimizer as co

    rng = np.random.default_rng(n)
    opt = getattr(co, kind)(native=native_step, **kw)
    st = opt.init_state(torch.tensor(rng.standard_normal(n)
                                     .astype(np.float32)))
    for s in range(1, STEPS + 1):
        opt.step(st, torch.tensor(rng.standard_normal(n).astype(np.float32)),
                 s)
    return {k: v.numpy() for k, v in st.buffers().items()}


def run_jax(kind, kw, n):
    rng = np.random.default_rng(n)
    opt = jax_opt(kind, **kw)
    st = opt.init_state(rng.standard_normal(n).astype(np.float32))
    for s in range(1, STEPS + 1):
        opt.step(st, rng.standard_normal(n).astype(np.float32), s)
    return {k: np.asarray(v) for k, v in st.buffers().items()}


@pytest.mark.parametrize("kind,kw,n", CASES, ids=IDS)
def test_native_step_bit_for_bit_the_jax_native_step(kind, kw, n):
    got, want = run_port(kind, kw, n), run_jax(kind, kw, n)
    assert set(got) == set(want)
    for slot in want:
        np.testing.assert_array_equal(got[slot], want[slot], err_msg=slot)


@pytest.mark.parametrize("kind,kw,n", CASES, ids=IDS)
def test_plain_step_within_1e6_of_both(kind, kw, n):
    plain = run_port(kind, kw, n, native_step=False)
    for other in (run_port(kind, kw, n), run_jax(kind, kw, n)):
        for slot in other:
            scale = max(float(np.abs(other[slot]).max()), 1e-30)
            err = float(np.abs(plain[slot] - other[slot]).max()) / scale
            assert err <= 1e-6, (slot, err)


def test_f32_to_bf16_is_round_to_nearest_even():
    rng = np.random.default_rng(0)
    x = torch.tensor(rng.standard_normal(10007).astype(np.float32) * 1e3)
    x[:4] = torch.tensor([0.0, -0.0, 1.0 + 2 ** -8, 1.0 + 3 * 2 ** -8])
    out = torch.empty(x.shape, dtype=torch.bfloat16)
    f32_to_bf16(x, out)
    assert torch.equal(out.view(torch.int16), x.to(torch.bfloat16)
                       .view(torch.int16))


def test_library_threads_follow_the_environment(monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "3")
    assert native.num_threads() == 3
    monkeypatch.delenv("OMP_NUM_THREADS")
    assert native.num_threads() == len(os.sched_getaffinity(0))
    assert native.library_threads() >= 1


def test_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    src = tmp_path / "csrc"
    src.mkdir()
    for f in native.SOURCES + native.HEADERS:
        with open(os.path.join(native.CSRC, f)) as fh:
            (src / f).write_text(fh.read())
    (src / "cpu_adam.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(native, "CSRC", str(src))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="host library build failed"
                       "(.|\n)*error"):
        native.build_library()


def test_build_cpu_optimizer_names_and_rejection():
    a = build_cpu_optimizer("Adam", {"lr": 1e-3})
    assert isinstance(a, CPUAdam) and not a.adamw_mode
    assert build_cpu_optimizer("adamw", {"lr": 1e-3}).adamw_mode
    assert build_cpu_optimizer("adam", {"adam_w_mode": True}).adamw_mode
    assert not build_cpu_optimizer("AdamW", {"adam_w_mode": False}
                                   ).adamw_mode
    assert isinstance(build_cpu_optimizer("adagrad", {}), CPUAdagrad)
    assert isinstance(build_cpu_optimizer("lion", {"torch_adam": True}),
                      CPULion)
    assert not build_cpu_optimizer("adamw", {}, native=False).native
    with pytest.raises(ValueError, match="unsupported"):
        build_cpu_optimizer("sgd_fancy", {})


# -- async I/O -----------------------------------------------------------

@pytest.mark.parametrize("native_io", [True, False], ids=["native", "plain"])
@pytest.mark.parametrize("kind", ["tensor", "numpy"])
def test_aio_round_trip(tmp_path, native_io, kind):
    h = AsyncIOHandle(num_threads=2, block_size=1 << 12, native=native_io)
    rng = np.random.default_rng(0)
    a = rng.standard_normal(50001).astype(np.float32)
    src = torch.tensor(a) if kind == "tensor" else a
    path = str(tmp_path / "swap.bin")
    h.sync_pwrite(src, path)
    out = torch.empty(a.size) if kind == "tensor" else np.empty_like(a)
    h.wait(h.async_pread(out, path))
    np.testing.assert_array_equal(np.asarray(out), a)
    h.sync_pwrite(src[:100], path, file_offset=a.nbytes)
    tail = torch.empty(100) if kind == "tensor" else np.empty(100, np.float32)
    h.sync_pread(tail, path, file_offset=a.nbytes)
    np.testing.assert_array_equal(np.asarray(tail), a[:100])
    assert h.pending() == 0
    h.close()


@pytest.mark.parametrize("native_io", [True, False], ids=["native", "plain"])
def test_aio_missing_file_raises(tmp_path, native_io):
    h = AsyncIOHandle(num_threads=1, native=native_io)
    buf = torch.empty(16)
    with pytest.raises(OSError):
        h.wait(h.async_pread(buf, str(tmp_path / "nope.bin")))
    h.close()


@pytest.mark.parametrize("native_io", [True, False], ids=["native", "plain"])
def test_aio_out_of_order_waits(tmp_path, native_io):
    h = AsyncIOHandle(num_threads=4, block_size=1 << 10, native=native_io)
    bufs = [torch.full((3000 + k,), float(k)) for k in range(6)]
    paths = [str(tmp_path / f"f{k}.bin") for k in range(6)]
    writes = [h.async_pwrite(b, p) for b, p in zip(bufs, paths)]
    for r in reversed(writes):
        h.wait(r)
    outs = [torch.empty(b.numel()) for b in bufs]
    reads = [h.async_pread(o, p) for o, p in zip(outs, paths)]
    for k in (3, 0, 5, 1, 4, 2):
        h.wait(reads[k])
        assert torch.equal(outs[k], bufs[k])
    assert h.pending() == 0
    h.close()


def test_aio_rejects_non_contiguous_and_device_buffers():
    h = AsyncIOHandle(num_threads=1)
    with pytest.raises(ValueError, match="contiguous"):
        h.async_pwrite(torch.empty(8, 8).t(), "unused")
    h.close()
