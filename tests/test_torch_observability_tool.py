"""Tier-1 wiring for tools/check_observability_torch.py, the port's copy
of tools/check_observability.py: the static observability conformance
check over the port's catalog, obs/ and fleet/ modules (measures bound to
views, exported metrics documented, monotonic span timing in the port's
hot-path modules, and the rest of its twin's checks), plus the caches
only the port records documented in README.md's port section; unit
coverage for each detector, and the drill raises where the card it was
asked for is missing."""

import os
import sys

import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))

import check_observability_torch as chk  # noqa: E402


def test_repo_is_conformant(capsys):
    assert chk.run_checks() == []
    assert chk.main(["--torch-device", "cpu"]) == 0
    assert "ok" in capsys.readouterr().out


def test_hot_path_modules_are_the_ports():
    for rel in chk.HOT_PATH_MODULES:
        assert rel.startswith("gatekeeper_tpu_torch/"), rel
        assert os.path.exists(os.path.join(chk.REPO, rel)), rel
    assert "gatekeeper_tpu_torch/obs/devprof.py" in chk.HOT_PATH_MODULES


def test_time_time_detector_flags_unannotated_use(tmp_path, monkeypatch):
    mod = tmp_path / "hot.py"
    mod.write_text(
        "import time\n"
        "a = time.time()\n"
        "b = time.time()  # wall-clock: ok (epoch gauge)\n"
        "c = time.monotonic()\n"
    )
    monkeypatch.setattr(chk, "REPO", str(tmp_path))
    monkeypatch.setattr(chk, "HOT_PATH_MODULES", ("hot.py",))
    problems = chk.check_monotonic_span_timing()
    assert len(problems) == 1
    assert "hot.py:2" in problems[0]


def test_undocumented_metric_detected(monkeypatch, tmp_path):
    docs = tmp_path / "docs"
    docs.mkdir()
    (docs / "metrics.md").write_text("# Metrics\n\nnothing documented\n")
    monkeypatch.setattr(chk, "REPO", str(tmp_path))
    problems = chk.check_metrics_documented()
    # every catalog view is now undocumented
    from gatekeeper_tpu_torch.metrics.catalog import catalog_views

    assert len(problems) == len(catalog_views())


def test_unbound_measure_detected(monkeypatch):
    from gatekeeper_tpu_torch.metrics import catalog
    from gatekeeper_tpu_torch.metrics.views import Measure

    monkeypatch.setattr(
        catalog, "ORPHAN_M",
        Measure("orphan_metric", "bound to no view"),
        raising=False,
    )
    problems = chk.check_measures_bound()
    assert any("orphan_metric" in p for p in problems)


def test_port_only_cache_detected(monkeypatch, tmp_path):
    """The kernels' cache, recorded only by the port, must be documented
    in README.md's port section: a README without it is flagged."""
    pkg = tmp_path / "gatekeeper_tpu_torch"
    pkg.mkdir()
    (pkg / "device.py").write_text('record_cache("kernels", True)\n'
                                   'record_cache("request_memo", True)\n')
    docs = tmp_path / "docs"
    docs.mkdir()
    (docs / "metrics.md").write_text("`cache` (`request_memo`)\n")
    (tmp_path / "README.md").write_text(
        '# x\n\ncache="kernels" (before the port section)\n\n'
        "## PyTorch / CUDA port\n\nnothing\n")
    monkeypatch.setattr(chk, "REPO", str(tmp_path))
    problems = chk.check_port_series_documented()
    assert len(problems) == 1 and "'kernels'" in problems[0]
    with open(tmp_path / "README.md", "a") as f:
        f.write('`cache_requests_total{cache="kernels"}`\n')
    assert chk.check_port_series_documented() == []


def test_no_card_raises():
    with pytest.raises(RuntimeError, match="CUDA card"):
        chk.main([])
