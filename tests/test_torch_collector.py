"""The webhook's collector sweeper and what the serving state costs it.

A webhook process freezes its heap at start and turns the automatic
collector off; a sweeper thread collects every 5 s.  On an H100's host,
phase 12 of chip_smoke found each sweep's full collection scanning the
replica's request memo: 62-567 ms with the GIL held, every one a reactor
heartbeat past the edge objective's 50 ms, which held young replicas at
brownout level 3.  The sweep is now generational (``gc_sweep``), and the
memos keep their values as marshal's bytes, which the collector never
tracks.  These tests hold both, and hold the memos' answers to the
interpreter oracle's."""

import copy
import gc
import json
import threading
import weakref

import pytest

from gatekeeper_tpu_torch.client.client import Client
from gatekeeper_tpu_torch.client.drivers import InterpDriver
from gatekeeper_tpu_torch.ops.driver import TorchDriver
from gatekeeper_tpu_torch.util import synthetic as syn
from gatekeeper_tpu_torch.webhook.server import gc_sweep


@pytest.fixture()
def collections():
    """The collector off, as a webhook process runs it, and the
    generation of every collection this test's thread made meanwhile
    (another test's server may still sweep in this process)."""
    gens = []
    me = threading.get_ident()

    def seen(phase, info):
        if phase == "stop" and threading.get_ident() == me:
            gens.append(info["generation"])

    was = gc.isenabled()
    gc.disable()
    gc.collect()
    gc.callbacks.append(seen)
    try:
        yield gens
    finally:
        gc.callbacks.remove(seen)
        if was:
            gc.enable()


class Node:
    def __init__(self):
        self.other = None


def _old(n: int) -> list:
    """n tracked objects moved into the old generation."""
    held = [[i] for i in range(n)]
    gc.collect(1)
    return held


def test_a_sweep_leaves_a_settled_old_generation_alone(collections):
    held = _old(50_000)
    settled = len(gc.get_objects(generation=2))
    collections.clear()
    for _ in range(3):
        young = [[i] for i in range(100)]
        assert gc_sweep(settled) == settled
    assert collections == [1, 1, 1]
    assert any(o is held for o in gc.get_objects(generation=2))
    del young


def test_a_sweep_collects_the_old_generation_once_it_grew_a_quarter(
        collections):
    held = _old(40_000)
    settled = len(gc.get_objects(generation=2))
    # a cycle that died in the old generation: only a full collection
    # frees it
    a, b = Node(), Node()
    a.other, b.other = b, a
    gone = weakref.ref(a)
    more = _old(settled // 4 - settled // 20)
    del a, b
    collections.clear()
    assert gc_sweep(settled) == settled
    assert gone() is not None and collections == [1]
    more += _old(settled // 10)
    after = gc_sweep(settled)
    assert collections[-1] == 2 and gone() is None and after > settled
    del held, more


def _clients(n=6, seed=13):
    templates, constraints = syn.make_templates(n, seed=seed)
    port = Client(driver=TorchDriver(device="cpu"))
    port.driver.DEVICE_MIN_CELLS = 0
    oracle = Client(driver=InterpDriver())
    for c in (port, oracle):
        for t, k in zip(templates, constraints):
            c.add_template(copy.deepcopy(t))
            c.add_constraint(copy.deepcopy(k))
    return port, oracle


def _request(pod, uid):
    return {"uid": uid,
            "kind": {"group": "", "version": "v1", "kind": "Pod"},
            "name": pod["metadata"]["name"],
            "namespace": pod["metadata"].get("namespace", "default"),
            "operation": "CREATE", "object": pod}


def _bytes(results):
    return [json.dumps([r.constraint["kind"], r.constraint["metadata"]["name"],
                        r.msg, r.enforcement_action, r.metadata],
                       sort_keys=True, default=str) for r in results]


@pytest.mark.parametrize("batch", [False, True])
def test_the_memos_keep_nothing_the_collector_tracks(batch):
    """After one collection no memo value is tracked: a full memo costs
    a collection only its keys.  A repeat is served from the memos with
    the oracle's answers, details included."""
    port, oracle = _clients()
    driver = port.driver
    pods = syn.make_pods(12, seed=21, violation_rate=1.0)
    reqs = [_request(p, f"u{i}") for i, p in enumerate(pods)]
    want = [_bytes(r.results()) for r in oracle.review_batch(reqs)]
    assert any("details" in json.loads(b)[4] and json.loads(b)[4]["details"]
               for w in want for b in w)

    def review():
        if batch:
            return [_bytes(r.results()) for r in port.review_batch(reqs)]
        return [_bytes(port.review(r).results()) for r in reqs]

    assert review() == want
    assert driver._request_memo and driver._review_memo
    gc.collect()
    assert not any(gc.is_tracked(v) for v in driver._request_memo.values())
    assert not any(gc.is_tracked(v) for v in driver._review_memo.values())
    assert review() == want
    # every cell from the review memo once the request memo is gone
    driver._request_memo.clear()
    assert review() == want
