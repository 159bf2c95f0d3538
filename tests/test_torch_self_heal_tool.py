"""Tier-1 wiring for tools/check_self_heal_torch.py, the port's copy of
tools/check_self_heal.py: two supervised replicas of the port
(``--driver torch --torch-device cpu``) behind the front door survive a
mid-stream SIGKILL with zero failed admissions and zero verdict
divergence, and the victim auto-restarts warm from the shared snapshot.
Skips cleanly where subprocess spawn is unavailable (same contract as
test_torch_fleet_parity_tool); the verdict checker is covered
unconditionally, and the drill raises where the card it was asked for
is missing."""

import os
import sys

import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))

import check_self_heal_torch as chk  # noqa: E402

from .test_snapshot_concurrent import spawn_available


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setattr(chk, "DEVICE", "cpu")


@spawn_available
def test_fleet_self_heals_under_kill():
    assert chk.run_checks() == []


def test_verdict_checker_flags_divergence():
    problems = []
    chk._check_verdict(
        0,
        b'{"response": {"allowed": false, '
        b'"status": {"message": "[denied by a] wrong", "code": 403}}}',
        [(False, ["right"])],
        problems,
    )
    assert problems and "diverged" in problems[0]


def test_verdict_checker_accepts_match():
    problems = []
    chk._check_verdict(
        0,
        b'{"response": {"allowed": false, '
        b'"status": {"message": "[denied by a] right", "code": 403}}}',
        [(False, ["right"])],
        problems,
    )
    assert problems == []


def test_no_card_raises():
    with pytest.raises(RuntimeError, match="CUDA card"):
        chk.main([])
