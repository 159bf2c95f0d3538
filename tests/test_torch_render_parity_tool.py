"""Tier-1 wiring for tools/check_render_parity_torch.py, the port's copy
of tools/check_render_parity.py: plan-vs-interpreter byte parity over the
port's render corpus and the static/slots classification-coverage floor,
run with ``--torch-device cpu``; each detector flags its seeded
divergence, and the drill raises where the card it was asked for is
missing."""

import os
import sys

import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))

import check_render_parity_torch as chk  # noqa: E402


def test_repo_render_plans_are_conformant(capsys):
    assert chk.main(["--torch-device", "cpu"]) == 0
    assert "clean" in capsys.readouterr().out
    assert chk.run_checks() == []


def test_parity_detector_flags_divergence(monkeypatch):
    """A renderer that drops violations must be detected."""
    from gatekeeper_tpu_torch.ops import renderplan as rp

    orig = rp.BoundPlan.apply
    monkeypatch.setattr(
        rp.BoundPlan, "apply", lambda self, row: orig(self, row)[:-1]
    )
    problems = chk.check_byte_parity()
    assert problems and all("diverges" in p for p in problems)


def test_coverage_detector_flags_regression(monkeypatch):
    """If binding started failing wholesale, the coverage floor trips."""
    from gatekeeper_tpu_torch.ops import renderplan as rp

    monkeypatch.setattr(rp, "bind", lambda *a, **k: None)
    problems = chk.check_classification_coverage()
    assert problems and "classification" in problems[0]


def test_the_corpus_is_the_tests_corpus():
    """The port's corpus holds the same entries and resources as
    tests/render_corpus.py, the JAX tool's."""
    from tests import render_corpus as jax_corpus

    rc = chk._corpus_modules()
    assert [(n, t, c) for n, t, c, _tier in rc.corpus()] == \
        [(n, t, c) for n, t, c, _tier in jax_corpus.corpus()]
    assert rc.resources() == jax_corpus.resources()


def test_no_card_raises():
    with pytest.raises(RuntimeError, match="CUDA card"):
        chk.main([])
