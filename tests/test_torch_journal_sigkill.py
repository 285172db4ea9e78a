"""Control-plane survivability, its multiprocess legs past the chaos
matrix (the port's copy of the rest of ``tests/test_journal.py``; the
helpers and the matrix are in ``tests/test_torch_journal.py``, split so
that ``pytest -n N --dist loadfile`` balances the two): the router
SIGKILLed mid-handoff relay, mid-kv-pull and mid-deploy canary over
``--listen`` daemons, recovery of a pipe-spawned fleet by replay, and
real-engine daemons (the port's engine, fp32 on the CPU) through a router
SIGKILL with greedy streams bit-identical to the uninterrupted run.
"""
import json

import pytest

from deepspeed_tpu_torch.runtime.resilience import INJECTED_CRASH_EXIT_CODE
from tests.test_torch_journal import (BS, VOCAB, _assert_exactly_once_oracle,
                                      _reqs, _router_cfg, _run_cli,
                                      _start_daemons, _stop_daemons)


@pytest.mark.multiprocess
def test_router_sigkill_mid_handoff_relay(tmp_path):
    """Role-split fleet, router killed between the importer's mig_ack
    and the ack relay to the pinned source: recovery re-adopts exactly
    one copy of the sequence (the other side flushes), the stream
    completes bit-identically, and nothing double-commits."""
    tmp = str(tmp_path)
    jd = f"{tmp}/journal"
    # a daemon's role lives in the DAEMON's config (its ready message
    # wins over the fleet's roles list)
    procs, addrs = _start_daemons(tmp, 2,
                                  per_daemon={0: {"role": "prefill"},
                                              1: {"role": "decode"}})
    reqs = _reqs(3, gen=24)
    try:
        cfg = {"router": _router_cfg(
                   addrs, faults={"router_crash_before_relay_ack": 1},
                   roles=["prefill", "decode"]),
               "waves": [reqs], "poll_every": 2,
               "run_deadline_s": 60, "min_ready": 2,
               "results": f"{tmp}/res1.json"}
        rc = _run_cli(cfg, jd)
        assert rc == INJECTED_CRASH_EXIT_CODE, \
            f"phase 1 did not crash before the ack relay (rc {rc})"
        cfg2 = {**cfg,
                "router": _router_cfg(addrs,
                                      roles=["prefill", "decode"]),
                "results": f"{tmp}/res2.json"}
        assert _run_cli(cfg2, jd) == 0
        res = json.load(open(f"{tmp}/res2.json"))
        _assert_exactly_once_oracle(res, reqs)
        assert res["readopted"] >= 1
    finally:
        _stop_daemons(procs)


@pytest.mark.multiprocess
def test_router_sigkill_mid_kv_pull(tmp_path):
    """Router killed right after starting a placement-time radix pull:
    the puller's local deadline admits the held put and recomputes (the
    always-safe fallback), decode continues through the outage, and the
    restarted router re-adopts it — streams oracle-identical."""
    tmp = str(tmp_path)
    jd = f"{tmp}/journal"
    shared = list(range(4 * BS))
    procs, addrs = _start_daemons(
        tmp, 2, per_daemon={0: {"max_live": 1, "decode_delay_s": 0.01}})
    seed_req = {"prompt": shared + [7, 8, 9], "trace_id": "seed",
                "max_new_tokens": 8}
    occupy = {"prompt": [900 + i for i in range(24)], "trace_id": "occupy",
              "max_new_tokens": 48}
    puller = {"prompt": shared + [3, 4, 5], "trace_id": "puller",
              "max_new_tokens": 8}
    try:
        cfg = {"router": _router_cfg(
                   addrs, faults={"router_crash_mid_kv_pull": 1},
                   kv_pull_timeout_s=2.0),
               "waves": [[seed_req], [occupy, puller]],
               "poll_every": 3, "inter_wave_polls": 25,
               "run_deadline_s": 60, "min_ready": 2,
               "results": f"{tmp}/res1.json"}
        rc = _run_cli(cfg, jd)
        assert rc == INJECTED_CRASH_EXIT_CODE, \
            f"phase 1 never started a pull to crash in (rc {rc})"
        cfg2 = {**cfg, "router": _router_cfg(addrs,
                                             kv_pull_timeout_s=2.0),
                "results": f"{tmp}/res2.json"}
        assert _run_cli(cfg2, jd) == 0
        res = json.load(open(f"{tmp}/res2.json"))
        _assert_exactly_once_oracle(res, [seed_req, occupy, puller])
        assert res["readopted"] >= 1
    finally:
        _stop_daemons(procs)


@pytest.mark.multiprocess
def test_router_sigkill_mid_deploy_canary_rolls_back(tmp_path):
    """Router killed during the canary phase of a rolling deploy: the
    restarted router finds the journaled in-flight deploy and resolves
    it deterministically — every replica serving the half-deployed
    version rolls back to the journaled prior version, the outcome
    counts as rolled_back, and traffic is unharmed."""
    from deepspeed_tpu_torch.serving import write_toy_checkpoint

    tmp = str(tmp_path)
    jd = f"{tmp}/journal"
    ckpt = f"{tmp}/ckpt"
    write_toy_checkpoint(ckpt, "tag1", vocab=VOCAB, block_size=BS)
    procs, addrs = _start_daemons(tmp, 2)
    reqs = _reqs(3, gen=16)
    try:
        cfg = {"router": _router_cfg(
                   addrs,
                   faults={"router_crash_mid_deploy_canary": 1}),
               "waves": [reqs], "poll_every": 1,
               "deploy": {"ckpt": ckpt, "tag": "tag1"},
               "run_deadline_s": 60, "min_ready": 2,
               "results": f"{tmp}/res1.json"}
        rc = _run_cli(cfg, jd)
        assert rc == INJECTED_CRASH_EXIT_CODE, \
            f"phase 1 never reached the canary (rc {rc})"
        cfg2 = {**cfg, "router": _router_cfg(addrs), "deploy": None,
                "settle_polls": 60, "results": f"{tmp}/res2.json"}
        assert _run_cli(cfg2, jd) == 0
        res = json.load(open(f"{tmp}/res2.json"))
        _assert_exactly_once_oracle(res, reqs)
        assert res["deploys"].get("rolled_back", 0) >= 1, res["deploys"]
        for slot, wv in res["fleet_wv"].items():
            assert wv is None or int(wv.get("id", 0)) == 0, \
                f"slot {slot} still serves the half-deployed version"
    finally:
        _stop_daemons(procs)


@pytest.mark.multiprocess
def test_pipe_fleet_recovery_replays_from_scratch(tmp_path):
    """Without daemons (pipe-spawned replicas die with the router),
    recovery degrades to replay: the restarted router respawns a fresh
    fleet, resync claims nothing, and every journaled request replays
    from scratch — still exactly-once, still oracle-identical."""
    tmp = str(tmp_path)
    jd = f"{tmp}/journal"
    replica = {"backend": "toy", "block_size": BS, "max_live": 8,
               "vocab": VOCAB, "tokens_per_step": 2,
               "decode_delay_s": 0.005, "hb_interval_s": 0.03}
    reqs = _reqs(4)
    cfg = {"router": {"fleet": {"n_replicas": 2, "replica": replica,
                                "hb_timeout_s": 2.0},
                      "request_timeout_s": 15.0, "resync_hold_s": 1.0,
                      "faults": {"router_crash_after_place": 3}},
           "waves": [reqs], "poll_every": 2, "run_deadline_s": 60,
           "min_ready": 2, "results": f"{tmp}/res1.json"}
    rc = _run_cli(cfg, jd)
    assert rc == INJECTED_CRASH_EXIT_CODE
    cfg2 = {**cfg, "router": {**cfg["router"], "faults": {}},
            "results": f"{tmp}/res2.json"}
    assert _run_cli(cfg2, jd) == 0
    res = json.load(open(f"{tmp}/res2.json"))
    _assert_exactly_once_oracle(res, reqs)
    assert res["readopted"] == 0           # nothing survived to claim
    assert res["resync_orphans"] >= 1


# ---------------------------------------------------------------------------
# real-engine daemons through a router SIGKILL (tier-1 here: the port's
# engine compiles nothing; fp32 on the CPU)
# ---------------------------------------------------------------------------

@pytest.mark.multiprocess
def test_engine_daemon_router_crash_recovery_bit_identical(tmp_path):
    """Two engine_v2 daemon replicas (same model+seed => identical
    weights): a baseline run pins the greedy streams, then the router is
    hard-killed mid-stream and a restarted router re-adopts the fleet —
    final streams bit-identical to the uninterrupted oracle run."""
    import random

    tmp = str(tmp_path)
    engine_cfg = {"backend": "engine", "model": "tiny-gpt2", "seed": 7,
                  "device": "cpu", "dtype": "float32",
                  "engine": {"block_size": 4, "num_blocks": 64,
                             "max_seqs": 2, "chunk": 8,
                             "max_seq_len": 128, "decode_window": 2},
                  "hb_interval_s": 0.05, "orphan_deadline_s": 120.0}
    procs, addrs = _start_daemons(tmp, 2, base_cfg=engine_cfg)
    rng = random.Random(0)
    reqs = [{"prompt": [rng.randrange(256) for _ in range(12)],
             "trace_id": f"e{i}", "max_new_tokens": 8} for i in range(3)]
    rcfg = _router_cfg(addrs, request_timeout_s=300.0,
                       resync_hold_s=20.0)
    rcfg["fleet"]["ready_timeout_s"] = 300.0
    rcfg["fleet"]["hb_timeout_s"] = 60.0
    try:
        # leave_fleet: the baseline incarnation must not shut the
        # daemons down — the crash run reuses them
        base_cfg = {"router": rcfg, "waves": [reqs],
                    "run_deadline_s": 300, "min_ready": 2,
                    "leave_fleet": True, "results": f"{tmp}/base.json"}
        assert _run_cli(base_cfg, f"{tmp}/jbase", timeout=600) == 0
        base = json.load(open(f"{tmp}/base.json"))
        for r in reqs:
            assert base["results"][r["trace_id"]]["status"] == "done"
        # same prompts under new ids, router killed at the 3rd placement
        reqs2 = [{**r, "trace_id": f"k{i}"} for i, r in enumerate(reqs)]
        crash_r = dict(rcfg)
        crash_r["faults"] = {"router_crash_after_place": 3}
        rc = _run_cli({"router": crash_r, "waves": [reqs2],
                       "poll_every": 2, "run_deadline_s": 300,
                       "min_ready": 2, "results": f"{tmp}/c1.json"},
                      f"{tmp}/jcrash", timeout=600)
        assert rc == INJECTED_CRASH_EXIT_CODE
        assert _run_cli({"router": rcfg, "waves": [reqs2],
                         "run_deadline_s": 300, "min_ready": 2,
                         "results": f"{tmp}/c2.json"},
                        f"{tmp}/jcrash", timeout=600) == 0
        res = json.load(open(f"{tmp}/c2.json"))
        assert res["double_commits"] == 0
        assert res["replay_mismatches"] == 0
        for i, r in enumerate(reqs2):
            info = res["results"][r["trace_id"]]
            assert info["status"] == "done", info
            assert info["tokens"] == \
                base["results"][f"e{i}"]["tokens"], \
                "recovered stream diverged from the uninterrupted run"
    finally:
        _stop_daemons(procs)
