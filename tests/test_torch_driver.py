"""TorchDriver (gatekeeper_tpu_torch, on the CPU) against the JAX TpuDriver
and the InterpDriver oracle on the synthetic corpus: 12 templates (the six
families twice) x 512 pods.

Audit results compare under audit_result_sig (constraint, message,
resource), totals exactly, review results per review in order, and the
candidate masks bit for bit."""

import numpy as np
import pytest

from gatekeeper_tpu.util import synthetic as jsyn
from gatekeeper_tpu_torch.client import Client as TorchClient
from gatekeeper_tpu_torch.ops.driver import TorchDriver
from gatekeeper_tpu_torch.util import synthetic as tsyn

N_TEMPLATES, N_PODS = 12, 512


@pytest.fixture(scope="module")
def clients():
    torch_client = tsyn.build_driver(N_TEMPLATES, N_PODS, device="cpu")
    tpu_client = jsyn.build_driver(N_TEMPLATES, N_PODS)
    oracle = jsyn.build_oracle(N_TEMPLATES, N_PODS)
    return torch_client, tpu_client, oracle


def _review_pods():
    pods = tsyn.make_pods(16, seed=7, violation_rate=0.5)
    for i, p in enumerate(pods):
        p["metadata"]["name"] = f"review-pod-{i}"
    return pods


def _review_sig(responses):
    out = []
    for resp in responses:
        out.append([
            (r.constraint["kind"], r.constraint["metadata"]["name"], r.msg,
             r.enforcement_action)
            for r in resp.results()
        ])
    return out


def test_build_driver_makes_a_cpu_torch_driver(clients):
    torch_client = clients[0]
    assert isinstance(torch_client.driver, TorchDriver)
    assert torch_client.driver.device.type == "cpu"


@pytest.mark.parametrize("cap", [1, 5])
def test_audit_capped_parity(clients, cap):
    torch_client, tpu_client, oracle = clients
    t_resp, t_tot = torch_client.audit_capped(cap)
    j_resp, j_tot = tpu_client.audit_capped(cap)
    o_resp, o_tot = oracle.audit_capped(cap)
    t_sig = jsyn.audit_result_sig(t_resp.results())
    assert t_sig == jsyn.audit_result_sig(j_resp.results())
    assert t_tot == j_tot
    assert t_sig, "the corpus must flag something"
    # against the oracle: every kept result is a real violation, and a
    # constraint's count is exact wherever the device path says so
    o_sig = set(jsyn.audit_result_sig(o_resp.results()))
    assert set(t_sig) <= o_sig
    for key, (n, how) in t_tot.items():
        if how == "exact":
            assert n == o_tot[key][0], key


def test_audit_parity(clients):
    torch_client, tpu_client, oracle = clients
    t_sig = jsyn.audit_result_sig(torch_client.audit().results())
    assert t_sig == jsyn.audit_result_sig(tpu_client.audit().results())
    assert t_sig == jsyn.audit_result_sig(oracle.audit().results())


def test_review_batch_parity(clients):
    torch_client, tpu_client, oracle = clients
    pods = _review_pods()
    t_sig = _review_sig(torch_client.review_batch(pods))
    assert t_sig == _review_sig(tpu_client.review_batch(pods))
    assert t_sig == _review_sig(oracle.review_batch(pods))
    assert any(t_sig), "the review batch must hold violations"


def test_single_review_parity(clients):
    torch_client, _tpu_client, oracle = clients
    pod = _review_pods()[0]
    assert _review_sig([torch_client.review(pod)]) == _review_sig(
        [oracle.review(pod)]
    )


def test_compute_masks_bit_equal(clients):
    torch_client, tpu_client, _oracle = clients
    reviews = [
        torch_client.target.handle_review(p)[1] for p in _review_pods()
    ]
    t_ord, t_mask, t_rej = torch_client.driver.compute_masks(reviews)
    j_ord, j_mask, j_rej = tpu_client.driver.compute_masks(reviews)
    assert [o[:2] for o in t_ord] == [o[:2] for o in j_ord]
    assert t_mask.dtype == np.bool_ and t_mask.shape == j_mask.shape
    np.testing.assert_array_equal(t_mask, j_mask)
    np.testing.assert_array_equal(t_rej, j_rej)
    assert t_mask.any()


def test_audit_after_churn_parity(clients):
    """Added pods and a deleted one: the resident pack re-syncs and the
    device copy is refreshed before the next sweep."""
    torch_client, _tpu_client, _oracle = clients
    pods = tsyn.make_pods(3, seed=11, violation_rate=1.0)
    oracle = jsyn.build_oracle(N_TEMPLATES, N_PODS)
    for p in pods:
        p["metadata"]["name"] = f"churn-{p['metadata']['name']}"
        torch_client.add_data(p)
        oracle.add_data(p)
    torch_client.remove_data(pods[0])
    oracle.remove_data(pods[0])
    t_resp, t_tot = torch_client.audit_capped(5)
    _o_resp, o_tot = oracle.audit_capped(5)
    o_all = jsyn.audit_result_sig(oracle.audit().results())
    # the cap keeps each constraint's first rows in pack-row order, which
    # churn makes differ from the store's walk: compare against the
    # uncapped oracle, and the exact totals
    assert set(jsyn.audit_result_sig(t_resp.results())) <= set(o_all)
    for key, (n, how) in t_tot.items():
        if how == "exact":
            assert n == o_tot[key][0], key
    assert jsyn.audit_result_sig(torch_client.audit().results()) == o_all
    for p in pods[1:]:
        torch_client.remove_data(p)


def test_cpu_client_takes_the_torch_driver_by_name():
    client = TorchClient(driver=TorchDriver(device="cpu"))
    resp, totals = client.audit_capped(3)
    assert resp.results() == [] and totals == {}


def test_side_stats_count_constraint_side_repacks():
    """A review whose strings are all interned reuses the packed
    constraint side; one that brings a new string re-packs and re-uploads
    it (the predicate tables are vocabulary-sized), and side_stats count
    both with their host time."""
    client = tsyn.build_driver(6, 32, device="cpu")
    client.driver.DEVICE_MIN_CELLS = 0  # reviews take the device path
    pod = tsyn.make_pods(1, seed=3)[0]
    client.review(pod)
    stats = client.driver.side_stats
    before = dict(stats)
    client.review(pod)
    assert stats == before
    pod["spec"]["containers"][0]["image"] = "never-seen.example/app:1"
    client.review(pod)
    assert stats["repacks"] == before["repacks"] + 1
    assert stats["uploads"] == before["uploads"] + 1
    assert stats["pack_ms"] > before["pack_ms"]
    assert stats["upload_ms"] > before["upload_ms"]
