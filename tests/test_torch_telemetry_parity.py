"""Telemetry across the two packages: the port's engine and the JAX
package's, serving the same tiny fp32 llama (hidden 256, the same
flax-initialised weights) with ``telemetry=True`` and ``reqtrace=True``
under two tenants, at ``max_inflight`` 0 and 8, must produce the same
metric names, label sets and counts on ``/metrics`` (not the timings),
the same reqtrace event-kind sequence for every uid, and the same span
names in the Chrome trace. One config and one dashboard serve both.

Both pipelines are made deterministic: no dispatch is ever ready early
(the port's ``_entry_ready`` answers False, the JAX engine's drain age is
infinite), so both commit exactly when the pipeline is full or a drain is
forced. Each package's process-wide telemetry instance is reset before and
restored after."""
import collections
import json
import re
import urllib.request

import flax
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu import telemetry as JT
from deepspeed_tpu.inference import InferenceEngineV2 as JaxEngine
from deepspeed_tpu.models import build_model as jax_build_model
from deepspeed_tpu.parallel.topology import MeshTopology
from deepspeed_tpu_torch import telemetry as PT
from deepspeed_tpu_torch.inference import InferenceEngineV2, params_from_jax
from deepspeed_tpu_torch.models import build_model

BASE = dict(block_size=8, num_blocks=96, max_seqs=4, chunk=16,
            max_seq_len=128, use_pallas_decode=False, telemetry=True,
            reqtrace=True)
NEW_TOKENS = 10
TENANTS = ("acme", "globex")
#: time-valued series: their values (not their counts) differ by package
TIMED = re.compile(r"(_s$|_seconds_total$|_s_|_per_s$)")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def fresh_instances():
    """Both packages' process-wide instances, zeroed, restored after."""
    saved = []
    for mod in (JT, PT):
        t = mod.get_telemetry()
        rt = t.reqtrace
        saved.append((t, t.enabled, rt.enabled, rt.sample))
        t.registry.reset()
        t.tracer.clear()
        rt.clear()
    yield
    for t, en, rt_en, sample in saved:
        t.reconfigure(enabled=en)
        t.reqtrace.enabled, t.reqtrace.sample = rt_en, sample
        t.registry.reset()
        t.tracer.clear()
        t.reqtrace.clear()


_WEIGHTS: dict = {}


def _weights():
    if not _WEIGHTS:
        jm = jax_build_model("tiny-llama", dtype=jnp.float32, hidden_size=256)
        params = jm.init(jax.random.PRNGKey(0),
                         jnp.zeros((1, 8), jnp.int32))["params"]
        host = jax.device_get(flax.core.meta.unbox(params))
        tm = build_model("tiny-llama", device="cpu", dtype=torch.float32,
                         hidden_size=256)
        _WEIGHTS.update(jm=jm, host=host, tm=tm, tree=params_from_jax(
            host, tm.config, dtype=torch.float32, device="cpu"))
    return _WEIGHTS


def _prompts():
    rng = np.random.default_rng(0)
    return [[int(t) for t in rng.integers(0, 256, n)] for n in (40, 5, 21,
                                                                37)]


def _serve(eng) -> dict:
    """put under two tenants, step to completion, flush; the streams."""
    prompts = _prompts()
    for uid, p in enumerate(prompts):
        eng.put(uid, p, max_new_tokens=NEW_TOKENS,
                tenant=TENANTS[uid % 2])
    while any(not eng.state.seqs[u].done for u in eng.state.seqs) \
            or eng._inflight:
        eng.step()
    return {uid: eng.flush(uid) for uid in range(len(prompts))}


def _jax_run(max_inflight):
    w = _weights()
    eng = JaxEngine(w["jm"], params=jax.tree.map(jnp.asarray, w["host"]),
                    config=dict(BASE, dtype=jnp.float32,
                                max_inflight=max_inflight),
                    topology=MeshTopology({"tensor": 1, "data": 1}))
    eng._drain_age = float("inf")
    return _serve(eng)


def _port_run(max_inflight):
    w = _weights()
    eng = InferenceEngineV2(w["tm"], params=w["tree"], config=dict(
        BASE, dtype=torch.float32, device="cpu", max_inflight=max_inflight))
    eng._entry_ready = lambda entry: False
    return _serve(eng)


def _metric_view(t) -> dict:
    """{name: (type, {labels: count or value})}, timings left out."""
    out = {}
    for name, fam in t.registry.snapshot().items():
        series = {}
        for s in fam["series"]:
            key = tuple(sorted(s["labels"].items()))
            if fam["type"] == "histogram":
                series[key] = s["count"]
            elif TIMED.search(name):
                series[key] = "timed"
            else:
                series[key] = s["value"]
        out[name] = (fam["type"], series)
    return out


def _kinds(t) -> dict:
    return {tl["uid"]: [e["kind"] for e in tl["events"]]
            for tl in t.reqtrace.timelines()}


def _span_names(t) -> collections.Counter:
    return collections.Counter(
        e["name"] for e in t.tracer.chrome_trace()["traceEvents"])


@pytest.mark.parametrize("max_inflight", [0, 8])
def test_metrics_timelines_and_spans_match_the_jax_engine(max_inflight,
                                                          fresh_instances):
    want_streams = _jax_run(max_inflight)
    jt = JT.get_telemetry()
    want = (_metric_view(jt), _kinds(jt), _span_names(jt))
    got_streams = _port_run(max_inflight)
    pt = PT.get_telemetry()
    got = (_metric_view(pt), _kinds(pt), _span_names(pt))
    assert got_streams == want_streams
    assert sorted(got[0]) == sorted(want[0])
    assert {"serving_ttft_s", "serving_tbt_s", "serving_tokens_total",
            "serving_queue_wait_s", "serving_prefill_occupancy",
            "serving_kv_page_utilization", "serving_tenant_ttft_s",
            "serving_attn_kernel_total"} <= set(want[0])
    assert want[0]["serving_tokens_total"][1][()] == 4 * NEW_TOKENS
    for name in want[0]:
        assert got[0][name] == want[0][name], name
    assert got[1] == want[1]
    assert all(k[0] == "enqueue" and k[-1] == "release"
               for k in got[1].values())
    assert got[2] == want[2]
    assert {"admit", "dispatch", "drain_block", "sched_plan"} <= set(got[2])


def test_scrape_serves_tenant_series_over_localhost(fresh_instances):
    """The port's endpoint on port 0: /metrics carries both tenants'
    series and the serving counts, /healthz reports a serving engine."""
    _port_run(8)
    t = PT.get_telemetry()
    port = t.start_http(0)
    try:
        base = f"http://127.0.0.1:{port}"
        with urllib.request.urlopen(base + "/metrics", timeout=10) as r:
            text = r.read().decode()
        with urllib.request.urlopen(base + "/healthz", timeout=10) as r:
            health = json.loads(r.read().decode())
    finally:
        t.stop_http()
    for tenant in TENANTS:
        assert f'serving_tenant_requests_total{{tenant="{tenant}"}} 2' in text
    assert "serving_tokens_total 40" in text
    assert "serving_ttft_s_count 4" in text
    assert health["serving"] is True and health["telemetry_enabled"]
