"""TorchDriver's three-tier route pricing equal to TpuDriver's, decision
for decision: ``_route_decision`` (route, reason, load hint and the priced
tier table) over a grid of calibrations (none, all three tiers, no numpy
tier, BENCH_r05's recorded model), offered loads (none, sustainable by
some tiers, by the device alone, by none), the brownout pin,
DEVICE_MIN_CELLS 0 and the numpy tier off, each at batches of 1 to
50,000 cells and 1 to 256 reviews, and ``predicted_batch_ms`` with them;
the ledger entry of a batch the port served, whose tier and table are
TpuDriver's decision for its cells.  Then tests/test_routing_load.py's
r05 curve on the port: at every recorded N the route is the tier that
measured fastest."""

import time

import pytest

from gatekeeper_tpu.ops.driver import TpuDriver
from gatekeeper_tpu_torch.ops.driver import TorchDriver

from .test_routing_load import LOAD_CAL, R05_CAL, R05_MEASURED

CALS = {
    "none": None,
    "three_tiers": LOAD_CAL,
    "no_np": {k: v for k, v in LOAD_CAL.items() if not k.startswith("np_")},
    "r05": R05_CAL,
}
LOADS = {"none": None, "some": 100.0, "device": 2000.0, "saturated": 2e4,
         "overload": 1e7}
CELLS = (1, 10, 23, 24, 100, 500, 4095, 4096, 50_000)
REVIEWS = (1, 8, 64, 256)


@pytest.fixture(scope="module")
def drivers():
    tpu = TpuDriver()
    tpu.mesh_enabled = False
    return TorchDriver(device="cpu"), tpu


def _set(driver, cal, load, pin, forced, np_on, stamp):
    driver._route_cal = dict(cal) if cal else None
    driver._offered_load = (load, stamp) if load else None
    driver._brownout_pin = pin
    driver.DEVICE_MIN_CELLS = 0 if forced else 4096
    driver.np_serve_enabled = np_on


@pytest.mark.parametrize("np_on", [True, False], ids=["np", "no_np_tier"])
@pytest.mark.parametrize("forced", [False, True], ids=["priced", "forced"])
@pytest.mark.parametrize("pin", [False, True], ids=["free", "pinned"])
@pytest.mark.parametrize("load", sorted(LOADS))
@pytest.mark.parametrize("cal", sorted(CALS))
def test_route_decision_equals_tpu_drivers(drivers, cal, load, pin, forced,
                                           np_on):
    port, tpu = drivers
    stamp = time.monotonic()
    for d in drivers:
        _set(d, CALS[cal], LOADS[load], pin, forced, np_on, stamp)
    routes = set()
    for cells in CELLS:
        for n in REVIEWS:
            if n > cells:
                continue
            got = port._route_decision(cells, n)
            assert got == tpu._route_decision(cells, n), (cells, n)
            routes.add(got[0])
            assert port._route_decision(cells, n, want_priced=False)[:3] \
                == got[:3]
    for n in (1, 8, 64, 256):
        assert port.predicted_batch_ms(n) == tpu.predicted_batch_ms(n)
    if forced:
        assert routes == {"device"}
    elif cal == "none":
        assert routes == ({"interp", "np", "device"} if np_on
                          else {"interp", "device"})
    if not np_on:
        assert "np" not in routes


def _review(i):
    return {
        "uid": f"u{i}", "kind": {"group": "", "version": "v1", "kind": "Pod"},
        "name": f"route-{i}", "namespace": "default", "operation": "CREATE",
        "object": {"apiVersion": "v1", "kind": "Pod",
                   "metadata": {"name": f"route-{i}", "namespace": "default",
                                "labels": {"i": str(i)}},
                   "spec": {"containers": [{"name": "c",
                                            "image": f"img.io/x:{i}"}]}},
    }


@pytest.mark.parametrize("cal", sorted(CALS))
def test_a_served_batch_records_the_decision(drivers, cal):
    """Batches of 1, 8 and 64 reviews of 3 constraints served on the CPU:
    each one ledger entry, whose tier, reason and priced table are
    TpuDriver's _route_decision for its cells."""
    from gatekeeper_tpu_torch.client import Client
    from gatekeeper_tpu_torch.util import synthetic as syn

    _port, tpu = drivers
    client = Client(driver=TorchDriver(device="cpu"))
    for t, k in zip(*syn.make_templates(3)):
        client.add_template(t)
        client.add_constraint(k)
    port = client.driver
    stamp = time.monotonic()
    for d in (port, tpu):
        _set(d, CALS[cal], None, False, False, True, stamp)
    port.route_ledger.clear()
    i = 0
    for n in (1, 8, 64):
        client.review_batch([_review(i + j) for j in range(n)])
        i += n
        entry = port.route_ledger.snapshot()["decisions"][-1]
        route, reason, _lam, priced = tpu._route_decision(3 * n, n)
        assert (entry["tier"], entry["reason"], entry["cells"]) == (
            route, reason, 3 * n)
        assert entry.get("priced", []) == priced
    assert len(port.route_ledger.snapshot()["decisions"]) == 3


@pytest.mark.parametrize("n", sorted(R05_MEASURED))
def test_r05_route_matches_the_measured_winner(drivers, n):
    """BENCH_r05's curve: the tier the route picks at N is the one that
    measured fastest there (N = 50 was the interpreter before the
    interpreter's rate was priced at its warm median)."""
    port, _tpu = drivers
    _set(port, R05_CAL, None, False, False, True, time.monotonic())
    interp_ms, np_ms, device_ms = R05_MEASURED[n]
    want = min([(interp_ms, "interp"), (np_ms, "np"),
                (device_ms, "device")])[1]
    assert port._route_decision(n)[0] == want
