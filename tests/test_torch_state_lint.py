"""The JAX repo lint's state-invariant AST checks
(``bin/check_state_invariants.py``, loaded as ``tests/test_repo_lint.py``
loads it) run over the port's serving state: every block-list, migration,
weight-version, eviction-sink and KV-tier mutation in
``deepspeed_tpu_torch/inference/{ragged,prefix_cache,kvtier,engine_v2}.py``
goes through the allowlisted methods. The lint is not edited: its
``STATE_FILE`` / ``KV_TIER_FILE`` point at the port's files for the test."""
import os

import pytest

from tests.test_repo_lint import ROOT, state_lint

PORT = "deepspeed_tpu_torch/inference"
FILES = ("ragged", "prefix_cache", "kvtier", "engine_v2")


@pytest.fixture
def lint(monkeypatch):
    monkeypatch.setattr(state_lint, "STATE_FILE", f"{PORT}/ragged.py")
    monkeypatch.setattr(state_lint, "KV_TIER_FILE", f"{PORT}/kvtier.py")
    return state_lint


@pytest.mark.parametrize("name", FILES)
def test_port_state_mutations_go_through_the_allowlisted_methods(lint,
                                                                 name):
    path = os.path.join(ROOT, PORT, f"{name}.py")
    assert lint.check_file(path) == []


def test_the_lint_sees_a_stray_mutation_in_the_port_engine(lint, tmp_path):
    src = open(os.path.join(ROOT, PORT, "engine_v2.py")).read()
    bad = tmp_path / "engine_v2.py"
    bad.write_text(src + (
        "\n\ndef stray(self, seq):\n"
        "    seq.migrating = None\n"
        "    self._weight_version = {}\n"
        "    self._kv_tier.absorb(None)\n"
        "    self._prefix_cache.evict_sink = None\n"
        "    self.state.allocator.free([1])\n"))
    out = lint.check_file(str(bad))
    assert len(out) == 5, out
