"""ZeRO-Infinity in the port's engine (``offload_param``: the layer
streamer of ``runtime/zero/infinity.py`` over the host optimizer) on the
CPU, against the JAX engine's ``LayerStreamTrainer`` with the same config.

tiny-llama and tiny-gpt2 in fp32, AdamW at ``eps=1e-5`` (see
``tests/test_torch_train_engine.py``), 3 steps from the JAX engine's initial
parameters: parameter offload on "cpu" and on "nvme" gives losses within
1e-5 relative and a master within 1e-5 of the JAX engine's. Then the
port's contracts: the staged bytes stay below the parameter bytes,
gradient accumulation, a checkpoint resume, ``eval_batch``, NVMe
placeholders that raise on value access, the JAX package's messages for
invalid configs, the triplet refused, and NVMe reads that overlap the walk
when every read is slowed (as ``tests/test_infinity.py`` holds the JAX
walk)."""
import time

import numpy as np
import pytest
import torch

import deepspeed_tpu_torch as dst
from deepspeed_tpu_torch.inference.weights import to_jax_tree
from deepspeed_tpu_torch.models import build_model

STEPS = 3


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def zero(dev="cpu", path=None, buffer_count=4):
    opt = "nvme" if dev == "nvme" else "cpu"
    return {"stage": 3,
            "offload_optimizer": {"device": opt, "nvme_path": path},
            "offload_param": {"device": dev, "nvme_path": path,
                              "buffer_count": buffer_count}}


def config(z, micro=2, gas=2, **over):
    cfg = {"train_micro_batch_size_per_gpu": micro,
           "gradient_accumulation_steps": gas,
           "optimizer": {"type": "AdamW",
                         "params": {"lr": 1e-3, "eps": 1e-5,
                                    "weight_decay": 0.01}},
           "bf16": {"enabled": False}, "steps_per_print": 10_000,
           "zero_optimization": z}
    cfg.update(over)
    return cfg


def batches(n=STEPS, B=4, S=32, seed=7):
    return [{"input_ids": np.random.default_rng(seed + s).integers(
        0, 256, (B, S)).astype(np.int32)} for s in range(n)]


def engine(name, cfg, init=None, **over):
    return dst.initialize(model=build_model(name, device="cpu",
                                            dtype=torch.float32, **over),
                          config=cfg, params=init, device="cpu")[0]


def max_diff(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b), (sorted(a), sorted(b))
        return max(max_diff(a[k], b[k]) for k in a)
    return float(np.abs(np.asarray(a, np.float32) - np.asarray(b)).max())


def jax_run(name, cfg, bs):
    import flax
    import jax
    import jax.numpy as jnp

    import deepspeed_tpu as ds
    from deepspeed_tpu.models import build_model as jax_build_model
    from deepspeed_tpu.parallel.topology import single_device_topology
    from deepspeed_tpu.runtime.zero.infinity import LayerStreamTrainer

    # In fp32 the JAX streamer's first ``np.asarray(grad, np.float32)`` is a
    # read-only view of the JAX array, which its ``+=`` then refuses (in
    # bf16 the conversion copies). Hand it writable copies: the same values.
    acc = LayerStreamTrainer._acc_grads
    LayerStreamTrainer._acc_grads = lambda self, tree: acc(
        self, jax.tree.map(lambda a: np.array(a, np.float32), tree))
    try:
        return _jax_run(name, cfg, bs)
    finally:
        LayerStreamTrainer._acc_grads = acc


def _jax_run(name, cfg, bs):
    import flax
    import jax
    import jax.numpy as jnp

    import deepspeed_tpu as ds
    from deepspeed_tpu.models import build_model as jax_build_model
    from deepspeed_tpu.parallel.topology import single_device_topology

    e, *_ = ds.initialize(model=jax_build_model(name, dtype=jnp.float32),
                          config=cfg, topology=single_device_topology())
    assert e._param_stream is not None
    unbox = lambda t: jax.tree.map(lambda a: np.asarray(a, np.float32),
                                   jax.device_get(flax.core.meta.unbox(t)))
    # a snapshot: the streamer refreshes its cache in place
    tree = lambda: unbox(e._param_stream.host_params_tree(snapshot=True))
    init = tree()
    losses = [float(e.train_batch(b)) for b in bs]
    return init, losses, tree()


@pytest.fixture(scope="module", params=["tiny-llama", "tiny-gpt2"])
def jax_ref(request):
    return request.param, jax_run(request.param, config(zero()), batches())


@pytest.mark.parametrize("dev", ["cpu", "nvme"])
def test_streamed_engine_matches_the_jax_streamer(jax_ref, dev, tmp_path):
    name, (init, want, params) = jax_ref
    e = engine(name, config(zero(dev, str(tmp_path))), init)
    losses = [float(e.train_batch(b)) for b in batches()]
    np.testing.assert_allclose(losses, want, rtol=1e-5)
    assert max_diff(params, e.master) <= 1e-5
    ps = e._param_stream
    assert e._zero is None and ps.nvme == (dev == "nvme")
    if dev == "nvme":
        assert ps.nvme_prefetch_hits > 0
        assert all(st.master is None for st in e._host_opt.state.values())


def test_staged_bytes_stay_below_the_parameter_bytes():
    e = engine("tiny-gpt2", config(zero(buffer_count=1)), num_layers=8)
    losses = [float(e.train_batch(b)) for b in batches(2)]
    assert all(np.isfinite(losses))
    ps = e._param_stream
    assert ps.peak_staged_bytes < 0.6 * ps.total_param_bytes
    assert ps.peak_staged_bytes <= ps.peak_hbm_bytes \
        < 0.8 * ps.total_param_bytes
    assert ps._live_bytes == 0 and not ps._staged and not ps._grad_pending


def test_gradient_accumulation_matches_one_micro_batch():
    init = to_jax_tree(build_model("tiny-llama", device="cpu",
                                   dtype=torch.float32))
    g2 = engine("tiny-llama", config(zero(), micro=1, gas=2), init)
    g1 = engine("tiny-llama", config(zero(), micro=2, gas=1), init)
    for b in batches(2, B=2):
        np.testing.assert_allclose(float(g2.train_batch(b)),
                                   float(g1.train_batch(b)), rtol=1e-5)
    assert max_diff(g1.master, g2.master) <= 1e-5


def test_streamed_equals_the_device_engine():
    """Layer streaming is a memory layout: the device engine at ZeRO-3
    with the same host optimizer gives the same trajectory."""
    init = to_jax_tree(build_model("tiny-llama", device="cpu",
                                   dtype=torch.float32))
    s = engine("tiny-llama", config(zero()), init)
    d = engine("tiny-llama", config({"stage": 3, "offload_optimizer":
                                     {"device": "cpu"}}), init)
    for b in batches():
        np.testing.assert_allclose(float(s.train_batch(b)),
                                   float(d.train_batch(b)), rtol=1e-5)
    assert max_diff(s.master, d.master) <= 1e-5


@pytest.mark.parametrize("dev", ["cpu", "nvme"])
def test_checkpoint_resume(tmp_path, dev):
    init = to_jax_tree(build_model("tiny-gpt2", device="cpu",
                                   dtype=torch.float32))
    cfg = config(zero(dev, str(tmp_path / "swap")))
    bs = batches(4)
    e = engine("tiny-gpt2", cfg, init)
    for b in bs[:2]:
        e.train_batch(b)
    e.save_checkpoint(str(tmp_path / "ckpt"), tag="t")
    cont = [float(e.train_batch(b)) for b in bs[2:]]
    e2 = engine("tiny-gpt2", cfg)
    e2.load_checkpoint(str(tmp_path / "ckpt"), tag="t")
    assert e2.opt_step == 2 and e2.global_steps == 2
    resumed = [float(e2.train_batch(b)) for b in bs[2:]]
    assert resumed == cont
    assert max_diff(e.master, e2.master) == 0.0
    # the device engine (no offload) resumes the same tag
    e3 = engine("tiny-gpt2", config({"stage": 1}))
    e3.load_checkpoint(str(tmp_path / "ckpt"), tag="t")
    np.testing.assert_allclose(float(e3.train_batch(bs[2])), cont[0],
                               rtol=1e-5)


def test_eval_batch_and_the_triplet():
    init = to_jax_tree(build_model("tiny-llama", device="cpu",
                                   dtype=torch.float32))
    s = engine("tiny-llama", config(zero()), init)
    d = engine("tiny-llama", config({"stage": 0}), init)
    b = batches(1)[0]
    ev = float(s.eval_batch(b))
    assert np.isfinite(ev)
    assert ev == pytest.approx(float(d.eval_batch(b)), rel=1e-6)
    for call in (lambda: s.forward(b), lambda: s.backward(b), s.step):
        with pytest.raises(NotImplementedError, match="train_batch/eval"):
            call()


def test_nvme_params_view_raises(tmp_path):
    from deepspeed_tpu_torch.runtime.zero.infinity import NVMeParamPlaceholder

    e = engine("tiny-gpt2", config(zero("nvme", str(tmp_path))))
    view = e._param_stream.params_view()
    ph = view["layer_0"]["attn"]["wq"]
    assert isinstance(ph, NVMeParamPlaceholder)
    assert ph.shape == tuple(e.module.layer_0.attn.wq.shape)
    assert ph.dtype == torch.float32 and ph.nbytes > 0
    with pytest.raises(RuntimeError, match="host_params_tree"):
        np.asarray(ph)
    with pytest.raises(RuntimeError, match="NVMe-resident"):
        ph[0]
    with pytest.raises(RuntimeError):
        float(ph)
    # the module's parameters hold no bytes between uses
    assert e.module.layer_0.attn.wq.untyped_storage().size() == 0
    host = e._param_stream.host_params_tree()
    assert host["layer_0.attn.wq"].shape == ph.shape


@pytest.mark.parametrize("z,err", [
    ({"stage": 3, "offload_param": {"device": "cpu"}},
     "requires offload_optimizer"),
    ({"stage": 3, "offload_optimizer": {"device": "cpu"},
      "offload_param": {"device": "nvme"}},
     "offload_optimizer.device='nvme'"),
    ({"stage": 3, "offload_optimizer": {"device": "cpu", "ratio": 0.5},
      "offload_param": {"device": "cpu"}}, "ratio == 1.0"),
    ({"stage": 3, "offload_optimizer": {"device": "cpu"},
      "offload_param": {"device": "tape"}}, "unsupported"),
], ids=["needs-opt-offload", "nvme-needs-nvme-opt", "no-twin-flow",
        "unknown-device"])
def test_invalid_configs_raise_the_jax_messages(z, err):
    with pytest.raises(ValueError, match=err):
        engine("tiny-gpt2", config(z))


def test_custom_loss_is_refused():
    with pytest.raises(ValueError, match="without a custom loss_fn"):
        dst.initialize(model=build_model("tiny-gpt2", device="cpu"),
                       config=config(zero()), device="cpu",
                       loss_fn=lambda m, b: m(b["input_ids"]).sum())


class _SlowAIO:
    """The real handle with an injected latency on every read (a private
    pool serves the reads; ids negative so they never meet the handle's
    own); writes pass through. ``spans`` records each read's group, its
    issue time and its completion time."""

    def __init__(self, inner, delay=0.0):
        from concurrent.futures import ThreadPoolExecutor

        self.inner, self.delay = inner, delay
        self.reads = 0
        self.group = None                  # the group being fetched
        self.fetched = []
        self.spans = []                    # [group, issued, done]
        self._pool = ThreadPoolExecutor(max_workers=32)
        self._futs, self._n = {}, 0

    def async_pread(self, buf, path, file_offset=0):
        delay = self.delay
        span = [self.group, time.perf_counter(), None]
        self.spans.append(span)

        def work():
            if delay:
                time.sleep(delay)
            self.inner.sync_pread(buf, path, file_offset)
            span[2] = time.perf_counter()

        self._n += 1
        self.reads += 1
        self._futs[-self._n] = self._pool.submit(work)
        return -self._n

    def async_pwrite(self, buf, path, file_offset=0):
        return self.inner.async_pwrite(buf, path, file_offset)

    def wait(self, rid):
        if rid < 0:
            self._futs.pop(rid).result()
        else:
            self.inner.wait(rid)


def _record_walk(ps, slow):
    """Wrap the streamer so that every fetch tags its reads with its group
    and every group's compute (from ``_use`` returning to ``_release``) is
    recorded as ``[group, start, end]``; ``slow.fetched`` lists the groups
    fetched."""
    computes = []
    issue, use, release = ps._issue_fetch, ps._use, ps._release

    def issue_fetch(g):
        slow.fetched.append(g)
        slow.group = g
        try:
            return issue(g)
        finally:
            slow.group = None

    def use_(g):
        use(g)
        computes.append([g, time.perf_counter(), None])

    def release_(g):
        if computes and computes[-1][0] == g and computes[-1][2] is None:
            computes[-1][2] = time.perf_counter()
        release(g)

    ps._issue_fetch, ps._use, ps._release = issue_fetch, use_, release_
    return computes


def _overlapped(computes, spans):
    """How many computes past the first had a read of another group in
    flight (issued before the compute ended, done after it began)."""
    n = 0
    for g, c0, c1 in computes[1:]:
        n += any(rg != g and r0 < c1 and r1 > c0 for rg, r0, r1 in spans)
    return n


def test_nvme_reads_overlap_the_walk(tmp_path):
    """Overlap is read off what the stream did, not off two wall-clock
    timings: with every read slowed to 80 ms, most groups' computes run
    while a read of a group to come is in flight. A streamer whose fetch
    waits for its own reads before returning overlaps none."""
    e = engine("tiny-gpt2", config(zero("nvme", str(tmp_path),
                                        buffer_count=2)), num_layers=8)
    ps = e._param_stream
    slow = _SlowAIO(ps.aio)
    ps.aio = slow
    b = batches(1)[0]
    e.train_batch(b)
    computes = _record_walk(ps, slow)
    slow.delay = 0.08
    slow.spans.clear()
    slow.fetched.clear()
    e.train_batch(b)
    assert all(c[2] is not None for c in computes), computes
    assert all(s[2] is not None for s in slow.spans)
    assert len(slow.fetched) >= 15         # the forward and backward walks
    past_first = len(computes) - 1
    assert past_first >= 30, len(computes)
    n = _overlapped(computes, slow.spans)
    assert n >= 0.75 * past_first, (n, past_first, computes, slow.spans)
    assert ps.nvme_prefetch_hits > ps.nvme_prefetch_misses
