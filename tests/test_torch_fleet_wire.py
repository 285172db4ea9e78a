"""The port's serving fleet against the JAX package's on the wire and in
the journal, on the CPU (the chaos and metric legs are in
``tests/test_torch_fleet_parity.py``).

- **Wire compatibility**: each package's ``Router``, given ``address``
  slots, dials two ``--listen`` toy daemons of the other package and serves
  a short trace exactly once with the oracle's streams.
- **Journal compatibility**: a router CLI of one package is killed after
  its third placement (``router_crash_after_place``); the other package's
  CLI recovers the journal and serves every request exactly once.
"""
import json
import os
import subprocess
import sys
import time

import pytest

from deepspeed_tpu_torch.runtime.resilience import INJECTED_CRASH_EXIT_CODE
from tests.test_torch_fleet_parity import (PACKAGES, ROOT, TOY,
                                           _assert_oracle, _env, _router,
                                           _serve, _trace, toy_stream)


def _daemons(pkg, tmp, n=2):
    procs, addrs = [], []
    for i in range(n):
        addr = f"unix:{tmp}/{pkg}{i}.sock"
        cfg = dict(TOY, replica_id=i, orphan_deadline_s=30.0)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", f"{PACKAGES[pkg][0]}.serving.replica",
             "--listen", addr, json.dumps(cfg)], env=_env(), cwd=ROOT,
            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL))
        addrs.append(addr)
    deadline = time.monotonic() + 60.0
    for i in range(n):
        while not os.path.exists(f"{tmp}/{pkg}{i}.sock"):
            assert time.monotonic() < deadline, "daemon never bound"
            time.sleep(0.02)
    return procs, addrs


def _stop(procs):
    for p in procs:
        if p.poll() is None:
            p.kill()
        p.wait(timeout=10)


@pytest.mark.multiprocess
@pytest.mark.parametrize("router_pkg,daemon_pkg",
                         [("jax", "torch"), ("torch", "jax")])
def test_each_router_serves_the_other_packages_daemons(router_pkg,
                                                       daemon_pkg,
                                                       tmp_path):
    procs, addrs = _daemons(daemon_pkg, str(tmp_path))
    try:
        router = _router(router_pkg, f"wire_{daemon_pkg}",
                         per_slot={str(i): {"address": a}
                                   for i, a in enumerate(addrs)})
        router.cfg.fleet.ready_timeout_s = 60.0
        trace = _trace(4)
        with router:
            router.start(min_ready=2)
            out = _serve(router, trace)
            assert router.double_commits == 0
            assert router.replay_mismatches == 0
            assert {h.state for h in router.fleet.replicas} == {"ready"}
        _assert_oracle(out, trace)
    finally:
        _stop(procs)


def _cli(pkg, cfg, journal, tmp):
    log = os.path.join(tmp, f"cli_{pkg}.log")
    with open(log, "ab") as f:
        return subprocess.run(
            [sys.executable, "-m", f"{PACKAGES[pkg][0]}.serving.router",
             "--journal", journal, json.dumps(cfg)],
            env=_env(), cwd=ROOT, timeout=240, stdout=f,
            stderr=subprocess.STDOUT).returncode


@pytest.mark.multiprocess
@pytest.mark.parametrize("writer,reader", [("torch", "jax"),
                                           ("jax", "torch")])
def test_a_journal_written_by_one_package_recovers_in_the_other(
        writer, reader, tmp_path):
    tmp = str(tmp_path)
    jd = f"{tmp}/journal"
    reqs = [{"prompt": list(range(40 + i)), "trace_id": f"r{i}",
             "max_new_tokens": 16} for i in range(4)]
    cfg = {"router": {"fleet": {"n_replicas": 2,
                                "replica": dict(TOY, decode_delay_s=0.005),
                                "hb_timeout_s": 2.0,
                                "env": {"JAX_PLATFORMS": "cpu"}},
                      "request_timeout_s": 15.0, "resync_hold_s": 1.0,
                      "faults": {"router_crash_after_place": 3}},
           "waves": [reqs], "poll_every": 2, "run_deadline_s": 90,
           "min_ready": 2, "results": f"{tmp}/res1.json"}
    assert _cli(writer, cfg, jd, tmp) == INJECTED_CRASH_EXIT_CODE
    cfg2 = {**cfg, "router": {**cfg["router"], "faults": {}},
            "results": f"{tmp}/res2.json"}
    assert _cli(reader, cfg2, jd, tmp) == 0
    with open(f"{tmp}/res2.json", encoding="utf-8") as f:
        res = json.load(f)
    assert res["double_commits"] == 0 and res["replay_mismatches"] == 0
    assert res["resync_orphans"] >= 1
    for r in reqs:
        info = res["results"][r["trace_id"]]
        assert info["status"] == "done", (r["trace_id"], info)
        assert info["tokens"] == toy_stream(r["prompt"],
                                            r["max_new_tokens"])
