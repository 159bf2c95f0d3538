"""Tier-1 wiring for tools/check_fleet_parity_torch.py, the port's copy
of tools/check_fleet_parity.py: three replica processes of the port
(``--driver torch --torch-device cpu``) restore one sealed snapshot of a
TorchDriver client; identical requests must produce byte-identical
AdmissionReview bodies on every replica (and through both doors), with
verdicts AND rendered violation text matching the port's interpreter
oracle.  Skips cleanly where subprocess spawn is unavailable; the
comparison core is covered unconditionally, and the drill raises where
the card it was asked for is missing."""

import os
import sys

import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))

import check_fleet_parity_torch as chk  # noqa: E402

from .test_snapshot_concurrent import spawn_available


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setattr(chk, "DEVICE", "cpu")


@spawn_available
def test_repo_fleet_is_conformant():
    # edge="both" drives the corpus through the threaded door AND the
    # event-loop door against one spawned fleet: byte parity,
    # attribution, and oracle conformance must hold on both edges
    assert chk.run_checks() == []


def test_detector_flags_replica_divergence():
    """A replica whose restore drifted must be detected."""
    good = b'{"response": {"uid": "u", "allowed": true}}'
    drifted = b'{"response": {"uid": "u", "allowed": false, ' \
              b'"status": {"message": "[denied by x] nope", "code": 403}}}'
    problems = chk.diff_verdicts(
        {"solo": [good], "r0": [good], "r1": [drifted]},
        [(True, [])],
    )
    assert problems and "diverge" in problems[0]


def test_detector_flags_oracle_divergence():
    allow = b'{"response": {"uid": "u", "allowed": true}}'
    problems = chk.diff_verdicts(
        {"solo": [allow], "r0": [allow]},
        [(False, ["one", "two"])],  # the oracle denies with 2 violations
    )
    assert problems and "oracle" in problems[0]


def test_detector_flags_message_content_drift():
    """Right verdict, right count, WRONG rendered text: count-only
    parity would pass this; content parity must not."""
    deny = b'{"response": {"uid": "u", "allowed": false, ' \
           b'"status": {"message": "[denied by a] garbled", "code": 403}}}'
    problems = chk.diff_verdicts(
        {"solo": [deny], "r0": [deny]},
        [(False, ["one"])],
    )
    assert problems and "rendered" in problems[0]


def test_detector_accepts_prefix_stripped_match():
    deny = b'{"response": {"uid": "u", "allowed": false, ' \
           b'"status": {"message": "[denied by a] one\\n' \
           b'[denied by b] two", "code": 403}}}'
    assert chk.diff_verdicts(
        {"solo": [deny], "r0": [deny]},
        [(False, ["one", "two"])],
    ) == []


def test_oracle_verdicts_equal_the_jax_tools():
    """The port's oracle answers the drill's corpus as the JAX tool's
    interpreter does."""
    import check_fleet_parity as jax_chk

    reqs = chk._sample_requests()
    assert reqs == jax_chk._sample_requests()
    got = chk._oracle_verdicts(reqs)
    assert any(not allowed for allowed, _m in got)
    assert got == jax_chk._oracle_verdicts(jax_chk._sample_requests())


def test_no_card_raises():
    with pytest.raises(RuntimeError, match="CUDA card"):
        chk.main([])
