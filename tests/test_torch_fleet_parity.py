"""The port's serving fleet against the JAX package's, on the CPU.

- **Chaos parity**: the same toy trace with the same faults armed on slot 0
  goes through the JAX fleet and through the port's fleet: per-request
  tokens and statuses are equal, both equal to the toy backend's LCG
  oracle, and both routers count 0 double commits and 0 replay mismatches.
- **Metric names**: the routers' ``/metrics`` families and label sets for
  the same trace are equal across the packages, and so are the families
  either package's fleet code emits by name.

The wire and journal legs are in ``tests/test_torch_fleet_wire.py``.
"""
import os
import sys
import tempfile

import pytest

import deepspeed_tpu.serving as jax_serving
import deepspeed_tpu_torch.serving as torch_serving
from deepspeed_tpu_torch.serving import TraceConfig, synth_trace
from tests.test_torch_disagg import toy_stream
from tests.test_torch_serving import restore_telemetry  # noqa: F401

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
TMP_ROOT = tempfile.gettempdir()
VOCAB = 1024
BS = 16
PACKAGES = {"jax": ("deepspeed_tpu", jax_serving),
            "torch": ("deepspeed_tpu_torch", torch_serving)}
TOY = {"backend": "toy", "block_size": BS, "max_live": 4, "vocab": VOCAB,
       "hb_interval_s": 0.03, "tokens_per_step": 2}
#: chaos cases of the serving chaos matrix, armed on slot 0
FAULTS = {
    "crash_during_prefill": ({"replica_crash_during_prefill": 2}, {}),
    "crash_on_admit": ({"replica_crash_on_put": 2}, {}),
    "dropped_completion_reply": ({"replica_drop_done": 1},
                                 {"request_timeout_s": 0.5}),
}


def _trace(n=6):
    return synth_trace(TraceConfig(n_requests=n, n_tenants=2, prefix_len=48,
                                   max_new_tokens=10, vocab=VOCAB, seed=3))


def _env():
    """Both packages importable from this checkout; JAX on the CPU."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = ROOT + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    return env


def _router(pkg, tag, replica=None, per_slot=None, n_replicas=2, **rkw):
    mod = PACKAGES[pkg][1]
    fcfg = mod.FleetConfig(
        n_replicas=n_replicas, replica=dict(TOY, **(replica or {})),
        per_slot=per_slot or {}, hb_timeout_s=rkw.pop("hb_timeout_s", 2.0),
        backoff_base_s=0.05, env={"JAX_PLATFORMS": "cpu"},
        log_dir=os.path.join(TMP_ROOT, "ds_torch_parity_tests",
                             f"{pkg}_{tag}"))
    return mod.Router(mod.RouterConfig(
        fleet=fcfg, request_timeout_s=rkw.pop("request_timeout_s", 15.0),
        max_retries=3, **rkw))


def _serve(router, trace, deadline_s=120):
    tids = [router.submit(r.prompt, tenant=r.tenant,
                          max_new_tokens=r.max_new_tokens,
                          trace_id=r.trace_id) for r in trace]
    res = router.run(deadline_s=deadline_s)
    return {t: (res[t]["status"], list(res[t]["tokens"] or []))
            for t in tids}


def _assert_oracle(out, trace):
    for r in trace:
        status, toks = out[r.trace_id]
        assert status == "done", (r.trace_id, status)
        assert toks == toy_stream(r.prompt, r.max_new_tokens), r.trace_id


@pytest.mark.multiprocess
@pytest.mark.parametrize("case", sorted(FAULTS))
def test_chaos_streams_statuses_and_counters_match_the_jax_fleet(case):
    faults, over = FAULTS[case]
    trace = _trace()
    got = {}
    for pkg in ("jax", "torch"):
        router = _router(pkg, case, per_slot={"0": {"faults": faults}},
                         **over)
        with router:
            out = _serve(router, trace)
            got[pkg] = (out, router.double_commits,
                        router.replay_mismatches)
    assert got["torch"] == got["jax"]
    out, double, mismatches = got["torch"]
    assert double == 0 and mismatches == 0
    _assert_oracle(out, trace)


#: emitted only once the scale advisor has seen a load sustained for its
#: window: present or not by timing, in either package
TIMED_FAMILIES = {"serving_router_scale_hint"}


def _families(telem, prefix="serving_"):
    """Family name -> (kind, the label-key sets of its series)."""
    out = {}
    for name, fam in telem.snapshot().items():
        if name.startswith(prefix) and name not in TIMED_FAMILIES:
            out[name] = (fam.get("type"), sorted(
                {tuple(sorted(s.get("labels", {}))) for s in fam["series"]}))
    return out


@pytest.mark.multiprocess
def test_router_metric_names_and_labels_match_the_jax_router():
    trace = _trace(4)
    fams = {}
    for pkg in ("jax", "torch"):
        telem_mod = sys.modules[f"{PACKAGES[pkg][0]}.telemetry"]
        telem = telem_mod.get_telemetry()
        was = (telem.enabled, telem.recorder.path, telem.recorder.dumps)
        telem.reset_metrics()
        try:
            router = _router(pkg, "metrics", telemetry=True)
            with router:
                _assert_oracle(_serve(router, trace), trace)
            fams[pkg] = _families(router._telem)
        finally:
            telem.reset_metrics()
            telem.reconfigure(enabled=was[0])
            telem.recorder.path, telem.recorder.dumps = was[1], was[2]
    assert len(fams["torch"]) > 10
    assert fams["torch"] == fams["jax"]


def _emitted(pkg, tmp_path):
    """The metric families the package's serving tier, telemetry and KV
    tier emit by literal name (``bin/check_metric_names.py``'s collector
    over a root holding them as ``deepspeed_tpu/``)."""
    import shutil

    from tests.test_repo_lint import metric_lint

    root = tmp_path / pkg
    for sub in ("serving", "telemetry"):
        shutil.copytree(os.path.join(ROOT, PACKAGES[pkg][0], sub),
                        root / "deepspeed_tpu" / sub,
                        ignore=shutil.ignore_patterns("__pycache__"))
    # the port's tier drains its promote latencies itself
    (root / "deepspeed_tpu" / "inference").mkdir()
    shutil.copy(os.path.join(ROOT, PACKAGES[pkg][0], "inference",
                             "kvtier.py"),
                root / "deepspeed_tpu" / "inference" / "kvtier.py")
    fams = metric_lint.collect_metric_families(str(root))
    return {name: f["type"] for name, f in fams.items()}


def test_emitted_metric_families_match_the_jax_packages(tmp_path):
    """Every family either package's fleet code can emit, timed ones
    included, with its kind."""
    port = _emitted("torch", tmp_path)
    assert "serving_router_scale_hint" in port and len(port) > 80
    assert port == _emitted("jax", tmp_path)
