"""Control-plane survivability: the write-ahead request journal and
fleet re-adoption (serving/journal.py + the resync protocol exchange).

The acceptance gate is the router-SIGKILL chaos matrix: with
deterministic fault injection hard-killing the ROUTER at each journaled
phase (admitted-unplaced, mid-stream, mid-handoff relay, mid-kv-pull,
mid-deploy canary) over ``--listen`` daemon replicas, a restarted router
over the same journal directory must replay its journal, re-adopt the
fleet via resync, and complete every request exactly once with greedy
streams bit-identical to the closed-form LCG oracle — double commits
and replay mismatches pinned to zero. In-flight decode CONTINUES through
the outage (the daemons buffer and re-attach), so re-adopted work never
pays a replay.

The port's copy of ``tests/test_journal.py``, over ``deepspeed_tpu_torch``:
its router, its replicas (spawned as ``python -m
deepspeed_tpu_torch.serving.replica``) and its telemetry. Engine legs run
the port's engine in fp32 on the CPU (``"device": "cpu"``, one torch thread
a replica) and are tier-1 here; waits poll for their condition under
generous deadlines.
"""
import json
import os
import subprocess
import sys
import time

import pytest

from deepspeed_tpu_torch.runtime.resilience import INJECTED_CRASH_EXIT_CODE
from deepspeed_tpu_torch.serving import (Journal, JournalError, Router,
                                         RouterConfig, FleetConfig,
                                         reduce_router_records)
from deepspeed_tpu_torch.serving.journal import OPEN
from deepspeed_tpu_torch.serving.replica import (AcceptBackoff, DaemonState,
                                                 _mix)

VOCAB = 1024
BS = 16


def toy_stream(prompt, n, vocab=VOCAB):
    """Closed-form oracle for the toy backend's deterministic stream."""
    seed = 0
    for t in prompt:
        seed = _mix(seed, int(t))
    out = []
    for i in range(n):
        seed = _mix(seed, i)
        out.append((seed >> 33) % vocab)
    return out


# ---------------------------------------------------------------------------
# units: journal format, reducer, backoff, daemon state
# ---------------------------------------------------------------------------

def test_journal_roundtrip_and_stats(tmp_path):
    j = Journal(str(tmp_path / "wal"))
    j.append("boot", {"gen": 1}, critical=True)
    j.append("admit", {"id": "r1", "prompt": [1, 2], "max_new": 4,
                       "eos": None, "tenant": "acme", "prio": 0})
    j.append("prog", {"id": "r1", "off": 0, "toks": [5, 6]})
    j.close()
    j2 = Journal(str(tmp_path / "wal"))
    recs = j2.replay()
    assert [r["k"] for r in recs] == ["boot", "admit", "prog"]
    assert recs[1]["tenant"] == "acme"
    assert j2.bad_records == 0 and j2.records_replayed == 3
    st = j2.stats()
    assert st["segments"] == 1 and st["records_replayed"] == 3
    # appends continue on the same segment across incarnations
    j2.append("term", {"id": "r1", "status": "done", "toks": [5, 6]})
    assert [r["k"] for r in Journal(str(tmp_path / "wal")).replay()] == \
        ["boot", "admit", "prog", "term"]
    with pytest.raises(JournalError):
        Journal(str(tmp_path / "other"), fsync="sometimes")


def test_journal_crc_and_torn_tail_skip_bad_records(tmp_path):
    j = Journal(str(tmp_path / "wal"))
    for i in range(5):
        j.append("prog", {"id": "r", "off": i, "toks": [i]})
    j.close()
    seg = os.path.join(str(tmp_path / "wal"), j.segments()[0])
    data = open(seg, "rb").read()
    lines = data.split(b"\n")
    # corrupt a payload byte mid-file: that record fails its crc
    lines[2] = lines[2].replace(b'"off":2', b'"off":9')
    # tear the tail mid-record: the crash raced the final write
    torn = b"\n".join(lines[:4]) + b"\n" + lines[4][: len(lines[4]) // 2]
    open(seg, "wb").write(torn)
    j2 = Journal(str(tmp_path / "wal"))
    recs = j2.replay()
    assert [r["off"] for r in recs] == [0, 1, 3]
    assert j2.bad_records == 2


def test_journal_rotation_compacts_behind_a_snapshot(tmp_path):
    j = Journal(str(tmp_path / "wal"), segment_bytes=256)
    live = {"reqs": [{"id": "keep", "prompt": [1], "max_new": 2,
                      "committed": [9], "a": 3}], "deploy": None}
    j.snapshot_fn = lambda: live
    for i in range(50):
        j.append("prog", {"id": "keep", "off": i, "toks": [i]})
    assert len(j.segments()) == 1          # older segments were deleted
    recs = j.replay()
    assert recs[0]["k"] == "snap"          # the new head is the snapshot
    st = reduce_router_records(recs)
    assert "keep" in st.reqs and st.reqs["keep"].attempt == 3
    j.close()


def test_journal_fsync_modes_smoke(tmp_path):
    for mode in ("always", "interval", "none"):
        j = Journal(str(tmp_path / mode), fsync=mode)
        j.append("boot", {"gen": 1}, critical=True)
        j.append("prog", {"id": "r", "off": 0, "toks": [1]})
        j.close()
        assert len(Journal(str(tmp_path / mode)).replay()) == 2


def test_reducer_folds_request_lifecycle():
    recs = [
        {"k": "boot", "gen": 1},
        {"k": "admit", "id": "a", "prompt": [1, 2, 3], "max_new": 8,
         "eos": None, "tenant": "t0", "prio": 1},
        {"k": "place", "id": "a", "slot": 1, "epoch": 0, "a": 1,
         "via": "dispatch"},
        {"k": "prog", "id": "a", "off": 0, "toks": [7, 8]},
        # duplicate/overlapping progress dedups like the live router
        {"k": "prog", "id": "a", "off": 0, "toks": [7, 8, 9]},
        {"k": "admit", "id": "b", "prompt": [4], "max_new": 2,
         "eos": 5, "tenant": "t1", "prio": 0},
        {"k": "requeue", "id": "a", "a": 2, "reason": "replica_lost"},
        {"k": "term", "id": "b", "status": "done", "toks": [5]},
        {"k": "deploy", "wid": 3, "phase": "canary_probe",
         "outcome": None, "prev": {"wid": 0}},
        # a record for an unknown id (compacted admit) is dropped
        {"k": "prog", "id": "ghost", "off": 0, "toks": [1]},
    ]
    st = reduce_router_records(recs)
    assert st.boots == 1 and st.saw_deploy
    assert st.deploy is not None and st.deploy["wid"] == 3
    a, b = st.reqs["a"], st.reqs["b"]
    assert a.status == OPEN and a.committed == [7, 8, 9] and a.attempt == 2
    assert a.rec.priority == 1 and a.rec.tenant == "t0"
    assert b.status == "done" and b.result == [5] and b.rec.eos_token_id == 5
    assert list(st.open_reqs) == ["a"]
    # a terminal deploy record clears the in-flight deploy
    st2 = reduce_router_records(recs + [
        {"k": "deploy", "wid": 3, "phase": "rollback",
         "outcome": "rolled_back", "prev": {"wid": 0}}])
    assert st2.deploy is None and st2.saw_deploy
    # a compaction snapshot retains terminal history, the settled-deploy
    # marker and the incarnation count — post-rotation recovery must not
    # re-run a committed deploy or re-execute finished requests
    st3 = reduce_router_records([
        {"k": "snap", "boots": 2, "saw_deploy": True, "deploy": None,
         "reqs": [{"id": "o", "prompt": [1], "max_new": 4, "a": 1}],
         "terms": [{"id": "d", "status": "done", "toks": [7, 8],
                    "tenant": "t0"},
                   {"id": "f", "status": "failed",
                    "reason": "timeout"}]}])
    assert st3.boots == 2 and st3.saw_deploy and st3.deploy is None
    assert list(st3.open_reqs) == ["o"]
    assert st3.reqs["d"].status == "done" and st3.reqs["d"].result == [7, 8]
    assert st3.reqs["f"].status == "failed" \
        and st3.reqs["f"].reason == "timeout"


def test_accept_backoff_deterministic_growth_cap_jitter_reset():
    a = AcceptBackoff(base_s=0.05, max_s=2.0, jitter=0.5, seed=7)
    b = AcceptBackoff(base_s=0.05, max_s=2.0, jitter=0.5, seed=7)
    seq_a = [a.next() for _ in range(12)]
    seq_b = [b.next() for _ in range(12)]
    assert seq_a == seq_b                  # seeded: deterministic
    assert AcceptBackoff(seed=8).next() != seq_a[0]
    # jitter bounds: every delay in ((1-jitter)*nominal, nominal]
    for i, d in enumerate(seq_a):
        nominal = min(0.05 * 2 ** i, 2.0)
        assert 0.5 * nominal < d <= nominal, (i, d)
    # growth reaches (jittered) cap and stays there
    assert seq_a[-1] > 1.0
    a.reset()
    assert a.next() <= 0.05
    # the _sleep seam: pause() sleeps exactly what next() returns
    slept = []
    c = AcceptBackoff(base_s=0.1, max_s=1.0, jitter=0.5, seed=3)
    c._sleep = slept.append
    d0, d1 = c.pause(), c.pause()
    assert slept == [d0, d1] and d1 > d0


def _no_fault():
    class _NF:
        def countdown(self, p):
            return False
    return _NF()


def test_daemon_state_decodes_through_outage_and_bounds_orphans():
    """Offline, the daemon keeps decoding (events buffer bounded), the
    resync inventory reports both live and finished work, and the orphan
    deadline flushes anything no router ever re-adopts."""
    from deepspeed_tpu_torch.serving.protocol import RequestRecord

    st = DaemonState({"backend": "toy", "block_size": BS, "vocab": VOCAB,
                      "max_live": 4, "tokens_per_step": 4,
                      "orphan_deadline_s": 0.2})
    rec = RequestRecord(trace_id="r1", prompt=list(range(40)),
                        max_new_tokens=8)
    st.attempts["r1"] = 3
    assert st.backend.put(rec) is None
    st.on_disconnect()                     # router died
    assert "r1" in st.orphans
    for _ in range(40):                    # decode continues offline
        st.offline_tick()
        if "r1" in st.term_buf:
            break
    inv = {e["id"]: e for e in st.resync_inventory()}
    assert inv["r1"]["done"] is True
    assert inv["r1"]["committed"] == 8
    assert st.term_buf["r1"]["msg"]["toks"] == toy_stream(rec.prompt, 8)
    # nobody re-adopts: the orphan deadline flushes everything
    time.sleep(0.25)
    st.offline_tick()
    assert st.resync_inventory() == []
    assert not st.backend.seqs and not st.orphans


def test_daemon_state_offline_pull_settles_to_recompute():
    """A put held back for an in-flight pull admits locally the moment
    the router dies — the chain can never complete without its relay."""
    st = DaemonState({"backend": "toy", "block_size": BS, "vocab": VOCAB,
                      "max_live": 4, "tokens_per_step": 4})
    put = {"t": "put", "id": "rp", "prompt": [1, 2, 3], "max_new": 4,
           "eos": None, "tenant": "default",
           "pull": {"pages": 2, "deadline_s": 30.0}}
    st.pulls["rp"] = {"put": put, "asm": None, "shm": None,
                      "relay": False,
                      "deadline": time.monotonic() + 30.0}
    st.attempts["rp"] = 1
    st.on_disconnect()
    assert not st.pulls
    assert "rp" in st.backend.live_requests()


def test_router_journal_disabled_is_behavior_identical(tmp_path):
    """No journal_dir -> no journal, no files, no recovery state — the
    stateless router, byte for byte."""
    r = Router(RouterConfig(fleet=FleetConfig(n_replicas=0)))
    assert r._journal is None and r.recovered == 0
    r.submit([1, 2, 3], max_new_tokens=2, trace_id="x")
    assert r._reqs["x"].status == "queued"
    assert list(tmp_path.iterdir()) == []  # nothing wrote anywhere


def test_router_recovers_admits_and_results_in_process(tmp_path):
    """In-process recovery unit (no fleet): submits journal; a second
    Router over the same dir rebuilds them — open requests land in
    RECOVERING, journaled terminals keep their result tokens."""
    jd = str(tmp_path / "wal")
    r1 = Router(RouterConfig(fleet=FleetConfig(n_replicas=0),
                             journal_dir=jd))
    r1.submit(list(range(20)), max_new_tokens=4, trace_id="open1",
              tenant="acme", priority=2)
    r1.submit([9, 9], max_new_tokens=2, trace_id="fin1")
    # hand-journal a terminal the way the live router would
    r1._reqs["fin1"].result = [4, 5]
    r1._terminate("fin1", "done", None)
    # force a compaction: the snapshot must retain BOTH the open request
    # and the terminal's history (dedup + result fidelity survive it)
    r1._journal.rotate()
    assert len(r1._journal.segments()) == 1
    r1.abandon()                           # the crash: no close, no flush
    r2 = Router(RouterConfig(fleet=FleetConfig(n_replicas=0),
                             journal_dir=jd))
    assert r2.recovered == 1
    assert r2._reqs["open1"].status == "recovering"
    assert r2._reqs["open1"].rec.priority == 2
    assert r2._reqs["open1"].rec.tenant == "acme"
    assert r2.result("fin1") == {
        **r2.result("fin1"), "status": "done", "tokens": [4, 5]}
    with pytest.raises(ValueError):        # recovered ids stay owned
        r2.submit([1], trace_id="open1")
    # the hold expires with no fleet: the orphan requeues for replay
    r2._resync_until = 0.0
    r2._tick_recovery(time.monotonic())
    assert r2._reqs["open1"].status == "queued"
    assert r2.resync_orphans == 1
    r2.close()


# ---------------------------------------------------------------------------
# the chaos matrix: SIGKILL the router at every journaled phase
# ---------------------------------------------------------------------------

def _env():
    """The daemons' and the router CLI's environment: this checkout's port
    on the path, and one torch thread each (several share the cores)."""
    import deepspeed_tpu_torch

    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    pkg_root = os.path.dirname(os.path.dirname(os.path.abspath(
        deepspeed_tpu_torch.__file__)))
    env["PYTHONPATH"] = pkg_root + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    return env


def _start_daemons(tmp, n, base_cfg=None, per_daemon=None):
    """N toy --listen daemons on unix sockets; returns (procs, addrs)."""
    procs, addrs = [], []
    for i in range(n):
        addr = f"unix:{tmp}/rep{i}.sock"
        cfg = {"backend": "toy", "block_size": BS, "max_live": 8,
               "vocab": VOCAB, "tokens_per_step": 2,
               "decode_delay_s": 0.005, "hb_interval_s": 0.03,
               "orphan_deadline_s": 30.0, "replica_id": i}
        cfg.update(base_cfg or {})
        cfg.update((per_daemon or {}).get(i, {}))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "deepspeed_tpu_torch.serving.replica",
             "--listen", addr, json.dumps(cfg)], env=_env(),
            stdout=open(f"{tmp}/rep{i}.log", "wb"),
            stderr=subprocess.STDOUT))
        addrs.append(addr)
    deadline = time.monotonic() + 30
    for i in range(n):
        while not os.path.exists(f"{tmp}/rep{i}.sock"):
            assert time.monotonic() < deadline, "daemon never bound"
            time.sleep(0.02)
    return procs, addrs


def _stop_daemons(procs):
    for p in procs:
        if p.poll() is None:
            p.kill()
    for p in procs:
        p.wait(timeout=10)


def _run_cli(cfg, journal, timeout=180):
    log = os.path.join(os.path.dirname(journal),
                       f"cli.{int(time.monotonic() * 1e3)}.log")
    with open(log, "wb") as f:
        return subprocess.run(
            [sys.executable, "-m", "deepspeed_tpu_torch.serving.router",
             "--journal", journal, json.dumps(cfg)],
            env=_env(), timeout=timeout, stdout=f,
            stderr=subprocess.STDOUT).returncode


def _router_cfg(addrs, faults=None, roles=None, **rkw):
    per_slot = {str(i): {"address": a} for i, a in enumerate(addrs)}
    fleet = {"n_replicas": len(addrs), "per_slot": per_slot,
             "hb_timeout_s": 2.0, "ready_timeout_s": 60.0}
    if roles:
        fleet["roles"] = roles
    r = {"fleet": fleet, "request_timeout_s": 15.0, "max_retries": 3,
         "resync_hold_s": 2.0, "faults": faults or {}}
    r.update(rkw)
    return r


def _reqs(n, gen=24, base=0):
    return [{"prompt": list(range(base + 40 + i)), "trace_id": f"r{i}",
             "max_new_tokens": gen} for i in range(n)]


def _assert_exactly_once_oracle(res, reqs):
    for r in reqs:
        info = res["results"][r["trace_id"]]
        assert info["status"] == "done", (r["trace_id"], info)
        assert info["tokens"] == toy_stream(r["prompt"],
                                            r["max_new_tokens"]), \
            f"{r['trace_id']} diverged from the oracle"
    assert res["double_commits"] == 0
    assert res["replay_mismatches"] == 0


CRASH_CASES = {
    # every admit journaled, nothing placed yet: recovery replays all
    "admitted_unplaced": {"faults": {"router_crash_after_admit": 5},
                          "poll_every": 0},
    # earlier requests are mid-stream when the 5th placement crashes:
    # decode continues through the outage, streams re-attach via resync
    "mid_stream": {"faults": {"router_crash_after_place": 5},
                   "poll_every": 2},
}


@pytest.mark.multiprocess
@pytest.mark.parametrize("case", sorted(CRASH_CASES))
def test_router_sigkill_chaos_matrix(case, tmp_path):
    spec = CRASH_CASES[case]
    tmp = str(tmp_path)
    jd = f"{tmp}/journal"
    procs, addrs = _start_daemons(tmp, 2)
    reqs = _reqs(6)
    try:
        cfg = {"router": _router_cfg(addrs, faults=spec["faults"]),
               "waves": [reqs], "poll_every": spec["poll_every"],
               "run_deadline_s": 60, "min_ready": 2,
               "results": f"{tmp}/res1.json"}
        rc = _run_cli(cfg, jd)
        assert rc == INJECTED_CRASH_EXIT_CODE, \
            f"phase 1 did not crash at the fault point (rc {rc})"
        cfg2 = {**cfg, "router": _router_cfg(addrs),
                "results": f"{tmp}/res2.json"}
        assert _run_cli(cfg2, jd) == 0
        res = json.load(open(f"{tmp}/res2.json"))
        _assert_exactly_once_oracle(res, reqs)
        assert res["recovered"] >= 1
        if case == "mid_stream":
            # mid-stream work re-attached instead of replaying
            assert res["readopted"] >= 1, res
            assert res["recovery_first_chunk_s"] is not None
        assert res["journal"]["records_replayed"] > 0
    finally:
        _stop_daemons(procs)
