"""Tier-1 wiring for tools/check_join_parity_torch.py, the port's copy
of tools/check_join_parity.py: the referential (cross-resource join)
conformance sweep — plan classification, width-1 vs width-4 vs the
port's interpreter-oracle byte parity, and key-group churn locality —
run with ``--torch-device cpu`` on GK_VIRTUAL_DEVICES=4 slots of the
CPU; each detector flags its seeded divergence; and the port's width-4
result signatures equal the JAX tool's from TpuDriver on the conftest's
virtual CPU mesh, on the same seed."""

import os
import sys

import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))

import check_join_parity_torch as chk  # noqa: E402

from gatekeeper_tpu_torch.parallel import mesh as pm  # noqa: E402


@pytest.fixture(autouse=True)
def _arm_join_assert(monkeypatch):
    """The tool's contract: divergences raise instead of being silently
    filtered by the render path; the drivers on WIDTH slots of the CPU."""
    monkeypatch.setenv("GK_JOIN_ASSERT", "1")
    monkeypatch.setattr(chk, "DEVICE", "cpu")
    monkeypatch.setenv(pm.VIRTUAL_DEVICES_ENV, str(chk.WIDTH))


def test_repo_join_kernels_are_conformant():
    assert chk.run_checks() == []


def test_main_runs_clean_on_the_cpu(capsys):
    assert chk.main(["--torch-device", "cpu"]) == 0
    assert "clean" in capsys.readouterr().out


def test_parity_detector_flags_aggregate_divergence(monkeypatch):
    """A broken per-key count (off by one) in the lookup K8's plain
    version runs must be detected as a result divergence, not silently
    absorbed."""
    from gatekeeper_tpu_torch.ops import joinkernel as jk
    from gatekeeper_tpu_torch.ops import joinlookup as jl

    orig = jl.lookup_counts

    def broken(uk, uc, q, xp):
        return orig(uk, uc, q, xp) + 1

    monkeypatch.setattr(jl, "lookup_counts", broken)
    # the render filter hides over-approximation, but GK_JOIN_ASSERT
    # turns the flagged-but-empty cells into a raised divergence
    with pytest.raises(jk.JoinDivergence):
        chk.check_width_parity()


def test_locality_detector_flags_full_resweeps(monkeypatch):
    """If the delta path stopped serving referential churn (every sweep
    a full dispatch again), the locality check trips."""
    from gatekeeper_tpu_torch.ops.driver import TorchDriver

    monkeypatch.setattr(TorchDriver, "_try_delta", lambda self, K: None)
    problems = chk.check_churn_locality()
    assert problems and "churn locality" in problems[0]


def test_locality_detector_flags_group_overreach(monkeypatch):
    """If churn started invalidating MORE than its key group (the
    O(churn) contract broken), the pinned dispatch count trips."""
    from gatekeeper_tpu_torch.ops.joinkernel import JoinState

    orig = JoinState.commit

    def overreach(self, ap, interner, dirty):
        out = orig(self, ap, interner, dirty)
        extra = {r for r in range(ap.n_rows)
                 if ap.reviews[r] is not None} - set(dirty)
        ap.bump_row_gen(extra - out)
        return extra

    monkeypatch.setattr(JoinState, "commit", overreach)
    problems = chk.check_churn_locality()
    assert problems and any("churn locality" in p for p in problems)


def _sweeps(tool):
    """The tool's width-4 driver: (signature, totals, join_plans) of its
    capped sweep, then of the sweep after the ingress-host churn."""
    client = tool._driver(tool.WIDTH)
    d = client.driver
    res, totals, _ = d.audit_capped(tool.CAP)
    out = [(tool._sig(res), totals, d.last_sweep_stats.get("join_plans"))]
    victim, _affected = tool._churn_victim()
    client.add_data(dict(victim))
    res, totals, _ = d.audit_capped(tool.CAP)
    out.append((tool._sig(res), totals, d.last_sweep_stats.get("delta_rows"),
                d.last_sweep_stats.get("join_affected_rows")))
    return out


def test_width4_signatures_equal_the_jax_tools():
    import check_join_parity as jax_chk

    got = _sweeps(chk)
    assert got[0][0] and got[0][2] == 3.0
    assert got == _sweeps(jax_chk)


def test_no_card_raises():
    with pytest.raises(RuntimeError, match="CUDA card"):
        chk.main([])
