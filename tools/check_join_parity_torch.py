#!/usr/bin/env python
"""Referential-policy conformance check of gatekeeper_tpu_torch (wired
tier-1 via tests/test_torch_join_parity_tool.py; also runnable
standalone):

1. Join-plan routing: every referential template family (unique-key /
   required-reference / count-quota) must classify into a vectorized join
   plan (ops/joinkernel.py) — never the interpreter-fallback all-true
   mask — and the audit sweep must record the ``join_plan`` route reason.
2. Width parity: the capped audit over a width-4 mesh must be
   BYTE-identical — rendered messages, resource identities, totals — to
   the width-1 sweep AND the interpreter oracle.  The per-shard key
   tables (K7) and their merge (K7's second launcher) fail fast here.
3. Key-group churn locality: one churned provider row dispatches exactly
   (dirty + its old/new key groups' reader rows) on the delta path — the
   dispatch row count is pinned to the group size computed independently
   from the raw objects, never the cluster size.  Checked at width 1 and
   under the mesh, including a churn row in the padded mesh tail.

Runs with GK_JOIN_ASSERT=1: any exact-plan cell the interpreter refuses
to render raises instead of being silently filtered.

The drivers are TorchDriver on ``--torch-device`` (default cuda, where a
full sweep builds each plan's key table with K7 and looks each cell's
count up with K8's dense mode, and a churn sweep runs K8's table mode;
without a card it raises, never falling back to the CPU); the oracle is
the port's InterpDriver.  The JAX tool waits up to 300 s for a delta
sweep's resident mask (TpuDriver.DELTA_MASK_WAIT_S); TorchDriver's mask
is resident when the sweep returns, so the port has no such wait.

Run: python tools/check_join_parity_torch.py [--torch-device cuda|cpu]
(exit 0 clean, 1 with findings; re-execs with GK_VIRTUAL_DEVICES=4 when
fewer than four devices are visible, like
tools/check_mesh_parity_torch.py).
"""

from __future__ import annotations

import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

N_TEMPLATES = 6
N_RESOURCES = 60
CAP = 4096  # above any per-constraint count: totals exact everywhere
WIDTH = 4
NEW_HOST = "app-0.corp.io"
# the drivers' device (main sets it from --torch-device)
DEVICE = "cuda"


def _sig(results):
    from gatekeeper_tpu_torch.util.synthetic import audit_result_sig

    return audit_result_sig(results)


def _driver(width):
    from gatekeeper_tpu_torch.util.synthetic import build_referential_driver

    client = build_referential_driver(N_TEMPLATES, N_RESOURCES,
                                      device=DEVICE)
    client.driver.set_mesh(width > 1, width=width)
    return client


def _oracle(mutate=None):
    from gatekeeper_tpu_torch.util.synthetic import build_referential_oracle

    client = build_referential_oracle(N_TEMPLATES, N_RESOURCES)
    if mutate is not None:
        mutate(client)
    return client.driver.audit_capped(CAP)


def _churn_victim():
    """(victim object, expected affected reader row names) for the
    ingress-host churn — computed independently from the raw corpus."""
    from gatekeeper_tpu_torch.util.synthetic import make_referential_objects

    objs = make_referential_objects(N_RESOURCES, 1)
    ingresses = [o for o in objs if o["kind"] == "Ingress"]
    victim = dict(ingresses[0])
    old_hosts = {r["host"] for r in victim["spec"]["rules"]}
    host_rows = {}
    for o in ingresses:
        for r in o["spec"]["rules"]:
            host_rows.setdefault(r["host"], set()).add(
                o["metadata"]["name"]
            )
    affected = set()
    for h in old_hosts | {NEW_HOST}:
        affected |= host_rows.get(h, set())
    affected.discard(victim["metadata"]["name"])
    victim = {
        **victim,
        "spec": {"rules": [{"host": NEW_HOST}]},
    }
    return victim, affected


def check_classification() -> list:
    """Every family must compile to a join plan (not interp fallback)."""
    from gatekeeper_tpu_torch.engine.interp import TemplatePolicy
    from gatekeeper_tpu_torch.ops.vectorizer import vectorize
    from gatekeeper_tpu_torch.util.synthetic import make_referential_templates

    problems = []
    templates, _ = make_referential_templates(3)
    for t in templates:
        kind = t["spec"]["crd"]["spec"]["names"]["kind"]
        rego = t["spec"]["targets"][0]["rego"]
        prog = vectorize(TemplatePolicy.compile(rego))
        if prog is None or not prog.join_plans:
            problems.append(
                f"join classification: {kind} did not compile to a join "
                "plan (interpreter fallback)"
            )
        elif not prog.exact:
            problems.append(
                f"join classification: {kind} compiled inexact (some "
                "statement fell out of the plan)"
            )
    return problems


def check_width_parity() -> list:
    """Width-4 mesh sweep vs width-1 sweep vs interpreter oracle, plus
    the join_plan route-ledger attribution."""
    problems = []
    oracle_r, oracle_t, _ = _oracle()
    oracle_sig = _sig(oracle_r)
    for w in (1, WIDTH):
        client = _driver(w)
        d = client.driver
        res, totals, _ = d.audit_capped(CAP)
        stats = d.last_sweep_stats
        if stats.get("join_plans") != 3.0:
            problems.append(
                f"width {w}: sweep stats carry join_plans="
                f"{stats.get('join_plans')} (expected 3 — join kernels "
                "did not serve the sweep)"
            )
        counts = d.route_ledger.snapshot().get("counts", {})
        if not any(k.endswith("|join_plan") for k in counts):
            problems.append(
                f"width {w}: no join_plan route-ledger entry recorded "
                f"(counts {counts})"
            )
        if _sig(res) != oracle_sig:
            problems.append(
                f"width {w}: rendered results diverge from the "
                "interpreter oracle"
            )
        if totals != oracle_t:
            problems.append(
                f"width {w}: per-constraint totals diverge: "
                f"{totals} != {oracle_t}"
            )
    return problems


def check_churn_locality() -> list:
    """Delta dispatch rows == dirty + affected key-group readers, with
    post-churn byte parity, at width 1 and under the mesh."""
    problems = []
    victim, affected = _churn_victim()
    oracle_r, oracle_t, _ = _oracle(
        mutate=lambda c: c.add_data(dict(victim))
    )
    oracle_sig = _sig(oracle_r)
    for w in (1, WIDTH):
        client = _driver(w)
        d = client.driver
        d.audit_capped(CAP)  # full sweep rebases basis + join index
        client.add_data(dict(victim))
        res, totals, _ = d.audit_capped(CAP)
        stats = d.last_sweep_stats
        if stats.get("delta_rows") != float(1 + len(affected)):
            problems.append(
                f"width {w} churn locality: expected a delta dispatch of "
                f"1 dirty + {len(affected)} key-group reader rows, got "
                f"stats {stats}"
            )
        if stats.get("join_affected_rows") != float(len(affected)):
            problems.append(
                f"width {w} churn locality: join_affected_rows="
                f"{stats.get('join_affected_rows')} != {len(affected)}"
            )
        if _sig(res) != oracle_sig or totals != oracle_t:
            problems.append(
                f"width {w}: post-churn results diverge from the oracle"
            )
    return problems


def check_padded_tail_churn() -> list:
    """Churn in the mesh's padded tail slab (the last live rows before
    the capacity padding) must stay on the delta path with parity."""
    problems = []
    from gatekeeper_tpu_torch.util.synthetic import make_referential_objects

    objs = make_referential_objects(N_RESOURCES, 1)
    pods = [o for o in objs if o["kind"] == "Pod"]
    victim = dict(pods[-1])  # among the last-packed rows -> tail slab
    victim = {
        **victim,
        "metadata": {**victim["metadata"],
                     "labels": {"team": "tailchurn"}},
    }
    oracle_r, oracle_t, _ = _oracle(
        mutate=lambda c: c.add_data(dict(victim))
    )
    client = _driver(WIDTH)
    d = client.driver
    d.audit_capped(CAP)
    client.add_data(dict(victim))
    res, totals, _ = d.audit_capped(CAP)
    stats = d.last_sweep_stats
    if "delta_rows" not in stats:
        problems.append(
            f"padded-tail churn fell off the delta path: {stats}"
        )
    if _sig(res) != _sig(oracle_r) or totals != oracle_t:
        problems.append("padded-tail churn diverges from the oracle")
    return problems


def run_checks() -> list:
    return (
        check_classification()
        + check_width_parity()
        + check_churn_locality()
        + check_padded_tail_churn()
    )


def _reexec_on_virtual_mesh() -> int:
    import subprocess

    from gatekeeper_tpu_torch.parallel.mesh import VIRTUAL_DEVICES_ENV

    env = dict(os.environ)
    env[VIRTUAL_DEVICES_ENV] = str(WIDTH)
    env["GK_JOIN_PARITY_REEXEC"] = "1"
    env["GK_JOIN_ASSERT"] = "1"
    return subprocess.call([sys.executable, os.path.abspath(__file__),
                            "--torch-device", DEVICE], env=env)


def main(argv=None) -> int:
    import argparse

    from gatekeeper_tpu_torch.parallel.mesh import visible_devices

    global DEVICE
    ap = argparse.ArgumentParser(prog="check_join_parity_torch.py")
    ap.add_argument("--torch-device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    DEVICE = ap.parse_args(argv).torch_device
    if (len(visible_devices(DEVICE)) < WIDTH
            and not os.environ.get("GK_JOIN_PARITY_REEXEC")):
        return _reexec_on_virtual_mesh()
    os.environ.setdefault("GK_JOIN_ASSERT", "1")
    problems = run_checks()
    for p in problems:
        print(f"FINDING: {p}")
    if problems:
        print(f"{len(problems)} finding(s)")
        return 1
    print("join-parity conformance: clean")
    return 0


if __name__ == "__main__":
    sys.exit(main())
