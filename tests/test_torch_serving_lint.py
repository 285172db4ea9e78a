"""The JAX repo's serving lints hold the port's serving tier, unedited:
``bin/check_deadlines.py`` (no unbounded wait), ``check_protocol_msgs.py``
(every message kind sent has a receiver and the reverse) and
``check_exception_swallows.py`` (no silent broad handler), plus the
state-invariant lint's per-file check over the port's serving modules.

Each lint governs ``<root>/deepspeed_tpu/...``; the tests give it a root
whose ``deepspeed_tpu/`` holds copies of the port's files (``serving/``
and the three files the deadline lint adds: ``inference/kvtier.py``,
``telemetry/timeseries.py``, ``telemetry/alerts.py``). A guard holds the
port's wire vocabulary, the message kinds sent and handled, equal to the
JAX package's, so one wire serves both."""
import os
import shutil

import pytest

from tests.test_repo_lint import (ROOT, deadline_lint, protocol_lint,
                                  state_lint, swallows)

PORT = os.path.join(ROOT, "deepspeed_tpu_torch")
EXTRA = ("inference/kvtier.py", "telemetry/timeseries.py",
         "telemetry/alerts.py")
LINTS = {"deadlines": deadline_lint, "protocol": protocol_lint,
         "swallows": swallows}
#: one violation of each lint, appended to the port's router copy
STRAY = {"deadlines": "\n\ndef stray(q):\n    return q.get()\n",
         "protocol": "\n\ndef stray(chan):\n    chan.send({\"t\": \"zz\"})\n",
         "swallows": "\n\ndef stray(f):\n    try:\n        f()\n"
                     "    except Exception:\n        pass\n"}


def _tree(tmp_path) -> str:
    pkg = tmp_path / "deepspeed_tpu"
    shutil.copytree(os.path.join(PORT, "serving"), pkg / "serving",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for rel in EXTRA:
        (pkg / os.path.dirname(rel)).mkdir(exist_ok=True)
        shutil.copy(os.path.join(PORT, rel), pkg / rel)
    return str(tmp_path)


@pytest.mark.parametrize("name", sorted(LINTS))
def test_port_serving_passes_the_lint(name, tmp_path, capsys):
    root = _tree(tmp_path)
    assert LINTS[name].check_repo(root) == []
    assert LINTS[name].main(["lint", root]) == 0, capsys.readouterr().out


@pytest.mark.parametrize("name", sorted(LINTS))
def test_the_lint_sees_a_stray_violation_in_the_port(name, tmp_path):
    root = _tree(tmp_path)
    router = os.path.join(root, "deepspeed_tpu", "serving", "router.py")
    with open(router, "a", encoding="utf-8") as f:
        f.write(STRAY[name])
    out = LINTS[name].check_repo(root)
    assert len(out) == 1 and "router.py" in out[0], out


@pytest.mark.parametrize("name", sorted(
    f[:-3] for f in os.listdir(os.path.join(PORT, "serving"))
    if f.endswith(".py")))
def test_port_serving_state_mutations_go_through_the_api(name):
    path = os.path.join(PORT, "serving", f"{name}.py")
    assert state_lint.check_file(path) == []


def _vocabulary(pkg: str) -> tuple[set, set]:
    sent, handled = set(), set()
    serving = os.path.join(ROOT, pkg, "serving")
    for f in sorted(os.listdir(serving)):
        if f.endswith(".py"):
            s, h, errs = protocol_lint.scan_file(os.path.join(serving, f))
            assert errs == [], errs
            sent |= set(s)
            handled |= set(h)
    return sent, handled


def test_port_protocol_kinds_equal_the_jax_packages():
    port_sent, port_handled = _vocabulary("deepspeed_tpu_torch")
    jax_sent, jax_handled = _vocabulary("deepspeed_tpu")
    assert len(port_sent) > 40
    assert port_sent == jax_sent
    assert port_handled == jax_handled
