"""A fleet replica pays its first evaluation before its ready probe.

The replica's ready probe is one admission through its own webhook, and
the admission objective counts it.  Where the probe paid the first
evaluation (the first launches, the render's first plans), its sample
could be slower than the objective's 100 ms: then the objective's alerts
fired as soon as the young replica had served ten requests, and its
brownout ladder stepped up (chip_smoke's phase 12 found a respawn at
level 1).  The replica now reviews the probe's request through its
client first, so the probe is served warm."""

import json
import urllib.request

from gatekeeper_tpu_torch.fleet import spawn_fleet
from gatekeeper_tpu_torch.snapshot import Snapshotter
from gatekeeper_tpu_torch.util.synthetic import build_driver

from .test_snapshot_concurrent import spawn_available

# the first device dispatch, slowed by the fault plane past the
# admission objective's 100 ms threshold
FIRST_DISPATCH_S = 0.3


@spawn_available
def test_the_ready_probe_is_served_warm(tmp_path):
    client = build_driver(2, 64, device="cpu")
    client.audit_capped(50)
    snap = tmp_path / "snap"
    snap.mkdir()
    assert Snapshotter(client, str(snap),
                       interval_s=0.0).write_once() is not None
    chaos = {"seed": 0, "rules": [{
        "point": "tpu.dispatch", "mode": "latency",
        "latency_s": FIRST_DISPATCH_S, "count": 1}]}
    (h,) = spawn_fleet(
        1, snapshot_dir=str(snap), cache_dir=str(tmp_path / "cache"),
        extra_flags=["--driver", "torch", "--torch-device", "cpu"],
        env={"GK_CHAOS": json.dumps(chaos), "GK_DEVICE_MIN_CELLS": "0"})
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{h.port}/statusz",
                                    timeout=60) as r:
            status = json.loads(r.read())
    finally:
        h.stop()
    admission = status["slo"]["objectives"]["admission_latency"]
    # the probe's admission, the only one, under the threshold
    assert admission["events_6h"] == 1
    assert admission["budget_remaining"] == 1.0
    assert status["brownout"]["level"] == 0
