"""The sharded sweep on real cards: the mesh of tests/test_torch_mesh.py with
each slab on its own CUDA device, where a launch must enter its tensors'
device, the constraint side is placed once a card, and key tables, masks
and reductions cross between cards.

Marked ``card``: every test skips without at least two CUDA devices (here,
on the CPU, always).  On a machine with cards, from the repository root:

    python -m pytest --noconftest -m card tests/test_torch_mesh_cards.py

(``--noconftest``: tests/conftest.py imports JAX, which a machine with
cards may lack; this file imports only the port.)  Each sweep at width W equals
the same driver's sweep on one card bit for bit: counts, first
candidates, results and totals.  Tolerance 0: every compared value is a
bool, an int or a rendered string.
"""

import copy
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from gatekeeper_tpu_torch import device as gdev
from gatekeeper_tpu_torch.parallel import mesh as pm
from gatekeeper_tpu_torch.util import synthetic as syn

pytestmark = pytest.mark.card

CAP = 20
sig = syn.audit_result_sig


@pytest.fixture
def cards(monkeypatch):
    """The real cards a mesh may use (up to 4), decided at run time."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < 2:
        pytest.skip("needs at least two CUDA devices")
    monkeypatch.delenv(pm.VIRTUAL_DEVICES_ENV, raising=False)
    monkeypatch.setenv("GK_MESH", "0")
    return min(n, 4)


def _sweep(client):
    """A capped sweep -> (results, totals, the incremental state's counts,
    and for a full sweep its first candidates, else None)."""
    resp, totals = client.audit_capped(CAP)
    driver = client.driver
    topk = None
    if "delta_rows" not in driver.last_sweep_stats:
        topk = driver._audit_cache[1][4].copy()
    return (sig(resp.results()), totals, driver._delta_state.counts.copy(),
            topk)


def _same(a, b):
    assert a[0] == b[0] and a[1] == b[1]
    np.testing.assert_array_equal(a[2], b[2])
    if a[3] is not None and b[3] is not None:
        assert a[3].shape == b[3].shape
        np.testing.assert_array_equal(a[3], b[3])


def _width_1(client):
    client.driver.set_mesh(True, width=1)
    return _sweep(client)


def _on_cards(client, width, plans=0):
    """A full sweep at ``width`` cards: slabs and constraint sides on
    their own cards, each launcher run once a shard (K7 once a shard and
    plan, its merge once a plan)."""
    driver = client.driver
    driver.set_mesh(True, width=width)
    before = dict(gdev.launches)
    got = _sweep(client)
    ran = {k: gdev.launches[k] - before[k] for k in gdev.launches}
    assert ran["match"] == ran["program"] == ran["reduction"] == width
    assert ran["joinkeys"] == width * plans
    assert ran["joinkeys_merge"] == plans
    devices = list(driver._mesh().devices)
    assert len(set(devices)) == width  # one card a shard
    slabs = driver._audit_dev_mesh[2]
    assert [s[0]["valid"].device for s in slabs] == devices
    assert set(driver._cs_device_cache[1]) == set(devices)
    mask = driver._delta_state.mask_src.get()
    assert [s.device for s in mask.slabs] == devices
    return got


def test_synthetic_sweeps_and_churn_on_cards(cards):
    client = syn.build_driver(24, 3000, 0)
    ref = _width_1(client)
    _same(_on_cards(client, cards), ref)
    # churn: new pods take rows past the last one (the last slab), others
    # change in place anywhere; the delta path gathers each row's
    # before-column on its owning card
    pods = syn.make_pods(3030, seed=1)[2980:3030]
    for p in pods:
        p["metadata"].setdefault("labels", {})["churned"] = "yes"
        client.add_data(copy.deepcopy(p))
    before = gdev.launches["delta"]
    delta = _sweep(client)
    st = client.driver.last_sweep_stats
    assert st["delta_rows"] == 50.0
    assert gdev.launches["delta"] - before == st["delta_shards"] >= 1
    # a forced full sweep patches the owning cards' slabs (K6) and equals
    # the delta path
    client.driver._delta_state = None
    client.driver._audit_cache = None
    full = _sweep(client)
    assert client.driver.last_sweep_stats["scatter_rows"] == 50.0
    _same(full, delta)
    uncapped = sig(client.audit().results())
    _same(_width_1(client), full)
    assert sig(client.audit().results()) == uncapped


def test_referential_sweeps_and_churn_on_cards(cards):
    client = syn.build_referential_driver(6, 3000, 0)
    plans = len(client.driver._active_join_plans())
    ref = _width_1(client)
    _same(_on_cards(client, cards, plans), ref)
    objs = syn.make_referential_objects(3000, 1)
    ing = [o for o in objs if o["kind"] == "Ingress"][:3]
    for i, o in enumerate(ing):
        o = copy.deepcopy(o)
        o["spec"]["rules"][0]["host"] = f"moved-{i}.corp.io"
        client.add_data(o)
    delta = _sweep(client)
    assert client.driver.last_sweep_stats["delta_rows"] >= 3.0
    client.driver._delta_state = None
    client.driver._audit_cache = None
    _same(_sweep(client), delta)
    _same(_width_1(client), delta)


def test_sharded_masks_on_cards(cards):
    from gatekeeper_tpu_torch.engine.value import thaw

    client = syn.build_driver(24, 600, 0)
    driver = client.driver
    reviews = [driver.target.make_audit_review(thaw(o), api, k, n, ns)
               for o, api, k, n, ns in driver.store.iter_objects()]
    driver.set_mesh(False)  # the one-card reference
    _o, mask, rej = driver.compute_masks(reviews)
    mesh = pm.audit_mesh(cards, driver.device)
    _o2, smask, srej = pm.sharded_masks(driver, reviews, mesh)
    np.testing.assert_array_equal(mask, smask)
    np.testing.assert_array_equal(rej, srej)
    _o3, counts, rejects = pm.sharded_violation_counts(driver, reviews,
                                                       mesh)
    np.testing.assert_array_equal(counts, mask.sum(axis=1))
    np.testing.assert_array_equal(rejects, rej.sum(axis=1))


_WORKER = r"""
import os, sys
sys.path.insert(0, os.environ["GK_REPO"])
import numpy as np
import torch
import torch.distributed as dist
from gatekeeper_tpu_torch.parallel.multihost import (
    init_distributed, multihost_capped_sweep, multihost_layout,
)
from gatekeeper_tpu_torch.util import synthetic as syn

pid = int(os.environ["GK_PROC"])
init_distributed(os.environ["GK_COORD"], 2, pid)
try:
    driver = syn.build_driver(24, 3000, seed=0).driver
    mesh, first, width = multihost_layout(driver.device)
    assert (mesh.devices.size, first, width) == (2, 2 * pid, 4)
    assert [d.index for d in mesh.devices] == [0, 1]  # this process's two
    _ordered, counts, topk = multihost_capped_sweep(driver, K=64)
    driver.set_mesh(False)
    _r, _o, _m, ref_counts, ref_topk = driver._audit_sweep(64)
    assert (counts == ref_counts).all() and (topk == ref_topk).all()
    assert topk.shape == ref_topk.shape and counts.sum() > 0
    print(f"proc {pid}: parity ok", flush=True)
finally:
    dist.destroy_process_group()
"""


def test_two_processes_two_cards_each(cards):
    """The multi-process sweep over four real cards: two processes on
    gloo, each seeing two cards of its own (CUDA_VISIBLE_DEVICES)."""
    if cards < 4:
        pytest.skip("needs four CUDA devices")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    coord = f"127.0.0.1:{s.getsockname()[1]}"
    s.close()
    procs = []
    try:
        for pid, visible in enumerate(("0,1", "2,3")):
            env = dict(os.environ, GK_REPO=repo, GK_COORD=coord,
                       GK_PROC=str(pid), CUDA_VISIBLE_DEVICES=visible)
            procs.append(subprocess.Popen(
                [sys.executable, "-c", _WORKER], env=env, cwd=repo,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            ))
        outs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {pid}:\n{out[-3000:]}"
        assert "parity ok" in out, out[-2000:]
