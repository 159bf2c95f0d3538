#!/usr/bin/env python
"""Sharded-mesh conformance check of gatekeeper_tpu_torch (wired tier-1
via tests/test_torch_mesh_parity_tool.py; also runnable standalone):

1. Width parity: the capped audit sweep over a width-4 mesh must
   produce BYTE-identical results — violation messages, resource
   identities, per-constraint totals and exactness markers — to the
   width-1 (single-device) sweep AND to the interpreter oracle over a
   fast synthetic corpus.  A sharding regression (slab padding, the
   per-shard [C, 1+K] reduction merge, global row-index translation)
   fails fast here, before it could ship wrong audit results.
2. Churn locality: after a full sweep, a small churn batch must ride the
   O(churn) delta path under the mesh — the dispatch row count equals
   the churned row count, never the cluster size.

The drivers are TorchDriver on ``--torch-device`` (default cuda, where
each shard runs the kernels: K1, K9 and K4 in a sweep, K9's delta mode
and K5 in a churn sweep; without a card it raises, never falling back to
the CPU); the oracle is the port's InterpDriver.

Run: python tools/check_mesh_parity_torch.py [--torch-device cuda|cpu]
(exit 0 clean, 1 with findings; re-execs with GK_VIRTUAL_DEVICES=4, four
slots of the one device, when fewer than four devices are visible, as
chip_smoke.py's mesh phase runs on one card).
"""

from __future__ import annotations

import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

# fast corpus: large enough that capacity (16 buckets to 64) pads across
# 4 slabs and every policy family appears; small enough for tier-1.
# CAP exceeds any per-constraint violation count here, so every candidate
# renders and totals are exact on every tier — the oracle comparison is
# then a FULL byte comparison, not a cap-order artifact.
N_TEMPLATES = 12
N_RESOURCES = 60
CAP = 100
WIDTH = 4
CHURN = 5
# the drivers' device (main sets it from --torch-device)
DEVICE = "cuda"


def _result_sig(results):
    from gatekeeper_tpu_torch.util.synthetic import audit_result_sig

    return audit_result_sig(results)


def _driver(width):
    from gatekeeper_tpu_torch.util.synthetic import build_driver

    client = build_driver(N_TEMPLATES, N_RESOURCES, device=DEVICE)
    driver = client.driver
    driver.set_mesh(width > 1, width=width)
    return client, driver


def _oracle():
    """A separately-loaded InterpDriver with the identical corpus
    (util/synthetic.build_oracle — see its docstring for why the oracle
    must be its own instance)."""
    from gatekeeper_tpu_torch.util.synthetic import build_oracle

    return build_oracle(N_TEMPLATES, N_RESOURCES).driver


def check_width_parity() -> list:
    """Width-4 mesh sweep vs width-1 sweep vs interpreter oracle."""
    problems = []
    _c1, d1 = _driver(1)
    res1, totals1, _t = d1.audit_capped(CAP)
    _c4, d4 = _driver(WIDTH)
    res4, totals4, _t = d4.audit_capped(CAP)
    if d4.last_sweep_stats.get("shards") != float(WIDTH):
        problems.append(
            f"mesh parity: width-{WIDTH} sweep ran on "
            f"{d4.last_sweep_stats.get('shards')} shard(s) — the mesh "
            "path did not serve the audit (breaker fallback?)"
        )
    oracle, ototals, _t = _oracle().audit_capped(CAP)
    comparisons = (
        (f"width-{WIDTH} vs width-1", res4, totals4, res1, totals1),
        ("width-1 vs interp oracle", res1, totals1, oracle, ototals),
        (f"width-{WIDTH} vs interp oracle", res4, totals4, oracle,
         ototals),
    )
    for tag, got_r, got_t, ref_r, ref_t in comparisons:
        if _result_sig(got_r) != _result_sig(ref_r):
            problems.append(
                f"mesh parity: rendered results diverge ({tag})"
            )
        if got_t != ref_t:
            problems.append(
                f"mesh parity: per-constraint totals diverge ({tag}): "
                f"{got_t} != {ref_t}"
            )
    return problems


def check_churn_locality() -> list:
    """A churn batch after a full mesh sweep must dispatch O(churn) rows
    to the owning shards, not resweep the cluster."""
    from gatekeeper_tpu_torch.util.synthetic import make_pods

    problems = []
    client, driver = _driver(WIDTH)
    driver.audit_capped(CAP)  # full sweep rebases the delta state
    pods = make_pods(N_RESOURCES)[7: 7 + CHURN]
    for p in pods:
        p["metadata"].setdefault("labels", {})["churned"] = "yes"
        client.add_data(p)
    driver.audit_capped(CAP)
    stats = driver.last_sweep_stats
    if stats.get("delta_rows") != float(CHURN):
        problems.append(
            "mesh churn locality: expected an O(churn) delta dispatch of "
            f"{CHURN} rows under the width-{WIDTH} mesh, got stats {stats}"
        )
    return problems


def run_checks() -> list:
    return check_width_parity() + check_churn_locality()


def _reexec_on_virtual_mesh() -> int:
    """Standalone runs that see fewer than WIDTH devices re-exec with
    WIDTH slots of the one device (GK_VIRTUAL_DEVICES)."""
    import subprocess

    from gatekeeper_tpu_torch.parallel.mesh import VIRTUAL_DEVICES_ENV

    env = dict(os.environ)
    env[VIRTUAL_DEVICES_ENV] = str(WIDTH)
    env["GK_MESH_PARITY_REEXEC"] = "1"
    return subprocess.call([sys.executable, os.path.abspath(__file__),
                            "--torch-device", DEVICE], env=env)


def main(argv=None) -> int:
    import argparse

    from gatekeeper_tpu_torch.parallel.mesh import visible_devices

    global DEVICE
    ap = argparse.ArgumentParser(prog="check_mesh_parity_torch.py")
    ap.add_argument("--torch-device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    DEVICE = ap.parse_args(argv).torch_device
    if (len(visible_devices(DEVICE)) < WIDTH
            and not os.environ.get("GK_MESH_PARITY_REEXEC")):
        return _reexec_on_virtual_mesh()
    problems = run_checks()
    for p in problems:
        print(f"FINDING: {p}")
    if problems:
        print(f"{len(problems)} finding(s)")
        return 1
    print("mesh-parity conformance: clean")
    return 0


if __name__ == "__main__":
    sys.exit(main())
