"""Tier-1 wiring for tools/check_mesh_parity_torch.py, the port's copy
of tools/check_mesh_parity.py: the width-1-vs-width-4 mesh parity sweep
(rendered results, totals, the port's interpreter oracle) and the
O(churn) locality check, run with ``--torch-device cpu`` on
GK_VIRTUAL_DEVICES=4 slots of the CPU; each detector flags its seeded
divergence; and the port's width-4 result signatures equal the JAX
tool's from TpuDriver on the conftest's virtual CPU mesh, on the same
seed."""

import os
import sys

import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))

import check_mesh_parity_torch as chk  # noqa: E402

from gatekeeper_tpu_torch.parallel import mesh as pm  # noqa: E402


@pytest.fixture(autouse=True)
def _cpu_mesh(monkeypatch):
    monkeypatch.setattr(chk, "DEVICE", "cpu")
    monkeypatch.setenv(pm.VIRTUAL_DEVICES_ENV, str(chk.WIDTH))


def test_repo_mesh_sharding_is_conformant():
    assert chk.run_checks() == []


def test_main_runs_clean_on_the_cpu(capsys):
    assert chk.main(["--torch-device", "cpu"]) == 0
    assert "clean" in capsys.readouterr().out


def test_parity_detector_flags_divergence(monkeypatch):
    """A merge that drops one shard's candidates must be detected."""
    import numpy as np

    from gatekeeper_tpu_torch.ops import driver as drv

    orig = drv._merge_sharded_packed

    def broken(packed_all, K):
        out = orig(packed_all, K)
        out = np.array(out)
        out[:, 0] = np.maximum(out[:, 0] - 1, 0)  # lose one count
        return out

    monkeypatch.setattr(drv, "_merge_sharded_packed", broken)
    problems = chk.check_width_parity()
    assert problems and any("diverge" in p for p in problems)


def test_locality_detector_flags_full_resweeps(monkeypatch):
    """If the delta path stopped serving churn under the mesh (every
    sweep a full dispatch again), the locality check trips."""
    from gatekeeper_tpu_torch.ops.driver import TorchDriver

    monkeypatch.setattr(TorchDriver, "_try_delta", lambda self, K: None)
    problems = chk.check_churn_locality()
    assert problems and "churn locality" in problems[0]


def _sweeps(tool):
    """The tool's width-4 driver: (signature, totals) of its capped
    sweep, then of the sweep after the locality check's churn."""
    from gatekeeper_tpu_torch.util.synthetic import make_pods

    client, driver = tool._driver(tool.WIDTH)
    res, totals, _t = driver.audit_capped(tool.CAP)
    out = [(tool._result_sig(res), totals)]
    for p in make_pods(tool.N_RESOURCES)[7: 7 + tool.CHURN]:
        p["metadata"].setdefault("labels", {})["churned"] = "yes"
        client.add_data(p)
    res, totals, _t = driver.audit_capped(tool.CAP)
    out.append((tool._result_sig(res), totals))
    return out, driver.last_sweep_stats


def test_width4_signatures_equal_the_jax_tools():
    import check_mesh_parity as jax_chk

    got, stats = _sweeps(chk)
    want, jax_stats = _sweeps(jax_chk)
    assert got[0][0] and got == want
    assert stats["delta_rows"] == jax_stats["delta_rows"] == chk.CHURN


def test_reexecs_onto_four_slots_of_one_device(monkeypatch, capfd):
    """With one device visible, main re-runs the tool in a child with
    GK_VIRTUAL_DEVICES=4, which runs the checks clean."""
    monkeypatch.delenv(pm.VIRTUAL_DEVICES_ENV)
    assert chk.main(["--torch-device", "cpu"]) == 0
    assert "mesh-parity conformance: clean" in capfd.readouterr().out


def test_no_card_raises():
    with pytest.raises(RuntimeError, match="CUDA card"):
        chk.main([])
