"""Tier-1 wiring for tools/check_overload_torch.py, the port's copy of
tools/check_overload.py: a 2-replica fleet of the port (``--driver torch
--torch-device cpu``) behind the overload-armed front door survives a
saturation burst with fast explicit sheds, preserved goodput, and zero
verdict divergence among accepted requests, on both edges, under the JAX
tool's bounds.  Skips cleanly where subprocess spawn is unavailable
(same contract as test_torch_self_heal_tool); the classification and
verdict helpers are covered unconditionally, and the drill raises where
the card it was asked for is missing."""

import os
import sys

import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))

import check_overload_torch as chk  # noqa: E402

from .test_snapshot_concurrent import spawn_available


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setattr(chk, "DEVICE", "cpu")


@spawn_available
def test_fleet_sheds_fast_and_keeps_verdicts_under_saturation():
    """Both serving edges hold the overload contract: the threaded door
    and the selectors-based door + batched wire listeners must
    shed/expire/serve under the identical saturation burst (one shared
    replica fleet — the taxonomy is a property of the doors)."""
    assert chk.run_checks(edge="both") == []


def test_the_doors_are_driven_with_the_prior_heap_frozen(monkeypatch):
    """What the drill's process held before the drill is out of the
    collector's generations while each door is driven, and back in them
    after: a full collection over a test worker's heap inside a burst
    stalls the door and its clients alike, and the door-shed p99 then
    charges the collector to the door."""
    import gc

    from gatekeeper_tpu_torch import fleet

    class Handle:
        wire_port = 1

        def __init__(self, i):
            self.replica_id = f"r{i}"

        def backend(self):
            return None

        wire_backend = backend

        def stop(self):
            pass

    class Door:
        def __init__(self, backends, **kw):
            pass

        def start(self):
            return self

    held = [[i] for i in range(1000)]
    seen = []

    def drive(door, edge, reqs, bodies, verdicts):
        seen.append((edge, any(o is held for o in gc.get_objects()),
                     gc.get_freeze_count() > len(held)))
        return []

    monkeypatch.setattr(fleet, "spawn_fleet",
                        lambda n, **kw: [Handle(i) for i in range(n)])
    monkeypatch.setattr(fleet, "FrontDoor", Door)
    monkeypatch.setattr(fleet, "EventFrontDoor", Door)
    monkeypatch.setattr(chk, "_drive_door", drive)
    assert chk.run_checks(edge="both") == []
    assert seen == [("threaded", False, True), ("evloop", False, True)]
    assert any(o is held for o in gc.get_objects())


def test_the_bounds_are_the_jax_tools():
    import check_overload as jax_chk

    for name in ("SHED_P99_BOUND_S", "BUDGET_S", "MAX_INFLIGHT",
                 "MAX_PENDING", "N_CLIENTS", "BURST_S", "N_CORPUS"):
        assert getattr(chk, name) == getattr(jax_chk, name), name


def test_classify_taxonomy():
    ok = b'{"response": {"allowed": true}}'
    assert chk.classify(200, ok)[0] == "accepted"
    shed_door = (b'{"response": {"allowed": false, '
                 b'"status": {"message": "shed", "code": 429}}}')
    assert chk.classify(429, shed_door)[0] == "shed"
    shed_replica = (b'{"response": {"allowed": false, '
                    b'"status": {"message": "shed", "code": 429}}}')
    assert chk.classify(200, shed_replica)[0] == "shed"
    expired = (b'{"response": {"allowed": false, '
               b'"status": {"message": "late", "code": 504}}}')
    assert chk.classify(200, expired)[0] == "expired"
    assert chk.classify(502, b"no backend")[0] == "problem"
    assert chk.classify(200, b"not-json")[0] == "problem"
    # a refusal WITHOUT an explicit verdict is a contract violation
    assert chk.classify(429, b'{"response": {}}')[0] == "problem"


def test_verdict_matcher():
    deny = {"allowed": False,
            "status": {"message": "[denied by a] broken pod",
                       "code": 403}}
    assert chk._verdict_matches(deny, (False, ["broken pod"]))
    assert not chk._verdict_matches(deny, (False, ["other"]))
    assert not chk._verdict_matches(deny, (True, []))
    assert chk._verdict_matches({"allowed": True}, (True, []))


def test_no_card_raises():
    with pytest.raises(RuntimeError, match="CUDA card"):
        chk.main([])
