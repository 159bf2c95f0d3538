#!/usr/bin/env python
"""Self-healing conformance check of gatekeeper_tpu_torch (wired tier-1
via tests/test_torch_self_heal_tool.py, also runnable standalone):

Two supervised replicas restore one sealed snapshot behind the front
door.  A parity-checked request stream runs against the door; mid-stream
one replica is SIGKILLed.  The check asserts:

1. **zero failed admissions** — every request in the stream answers 200
   (the front door's immediate-ejection + bounded retry covers the kill
   window);
2. **zero verdict divergence** — every answer (before, during and after
   the kill) matches a freshly loaded interpreter oracle: allow/deny AND
   the rendered violation text (sans the "[denied by ...]" prefix);
3. **auto-restart, warm** — the supervisor detects the exit, respawns
   the replica from the shared snapshot + sealed kernel cache (restore_outcome
   "restored", never cold), re-points the front door at the new port,
   and the revived replica serves parity-checked traffic again.

The snapshot comes from a TorchDriver client on ``--torch-device``
(default cuda), and the supervised replicas are the port's with
``--driver torch --torch-device <device>``, so on the card every
admission runs K1 and K9 and a respawned replica loads its kernels from
the shared cache; without a card the drill raises before it spawns
anything.  ``--xla-cache-dir DIR`` gives the replicas a sealed kernel
cache (default: a fresh directory).  The oracle is the port's
InterpDriver.

Run: python tools/check_self_heal_torch.py [--torch-device cuda|cpu]
[--xla-cache-dir DIR] (exit 0 clean, 1 with findings).  Spawns replica
subprocesses; where spawn is unavailable the tier-1 wrapper skips
cleanly (same contract as check_fleet_parity_torch).
"""

from __future__ import annotations

import http.client
import json
import os
import re
import signal
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

N_TEMPLATES = 2
# the stream's pods reference namespaces ns-0..ns-{N_STREAM-1}; the
# corpus must cover them — a standalone replica only seeds Namespace
# objects for the restored pack's rows (fleet/replica.py)
N_RESOURCES = 64
N_STREAM = 60          # requests in the parity-checked stream
KILL_AT = 20           # stream index at which one replica is killed
RECOVERY_BUDGET_S = 30.0
# the client's and the replicas' device, and the replicas' kernel cache
# (main sets them from --torch-device and --xla-cache-dir; "" = a fresh
# directory)
DEVICE = "cuda"
CACHE_DIR = ""


def _requests():
    from gatekeeper_tpu_torch.util.synthetic import make_pods

    pods = make_pods(N_STREAM, seed=41, violation_rate=0.5)
    out = []
    for i, p in enumerate(pods):
        out.append({
            "uid": f"self-heal-{i}",
            "kind": {"group": "", "version": "v1", "kind": "Pod"},
            "name": p["metadata"]["name"],
            "namespace": p["metadata"]["namespace"],
            "operation": "CREATE",
            "userInfo": {"username": "self-heal"},
            "object": p,
        })
    return out


def _oracle_verdicts(reqs):
    from gatekeeper_tpu_torch.util.synthetic import build_oracle

    oracle = build_oracle(N_TEMPLATES, N_RESOURCES)
    out = []
    for req in reqs:
        results = oracle.review(
            {k: req[k] for k in
             ("kind", "name", "namespace", "operation", "object")}
        ).results()
        out.append((not results, sorted(r.msg for r in results)))
    return out


def _post(port: int, body: bytes):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request("POST", "/v1/admit", body=body,
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, dict(resp.getheaders()), resp.read()
    finally:
        conn.close()


def _check_verdict(i: int, data: bytes, oracle_verdicts, problems: list):
    try:
        out = json.loads(data)["response"]
    except Exception as e:
        problems.append(f"request {i}: unparseable body ({e})")
        return
    allowed = out["allowed"]
    msgs = sorted(
        re.sub(r"^\[denied by [^\]]+\] ", "", m)
        for m in (out.get("status") or {}).get("message", "").split("\n")
        if m
    ) if not allowed else []
    o_allowed, o_msgs = oracle_verdicts[i]
    if allowed != o_allowed or (not allowed and msgs != o_msgs):
        problems.append(
            f"request {i}: verdict diverged from the oracle "
            f"(fleet {allowed}/{msgs} oracle {o_allowed}/{o_msgs})"
        )


def run_checks() -> list:
    import shutil

    from gatekeeper_tpu_torch.fleet import FrontDoor, ReplicaSupervisor
    from gatekeeper_tpu_torch.snapshot import Snapshotter
    from gatekeeper_tpu_torch.util.synthetic import build_driver

    problems: list = []
    root = tempfile.mkdtemp(prefix="gk-self-heal-")
    snap_dir = os.path.join(root, "snap")
    cache_dir = CACHE_DIR or os.path.join(root, "cache")
    os.makedirs(snap_dir)
    os.makedirs(cache_dir, exist_ok=True)
    sup = None
    door = None
    try:
        client = build_driver(N_TEMPLATES, N_RESOURCES, device=DEVICE)
        client.audit_capped(50)
        if Snapshotter(client, snap_dir, interval_s=0.0).write_once() is None:
            return ["snapshot write failed; cannot stage the fleet"]
        reqs = _requests()
        oracle_verdicts = _oracle_verdicts(reqs)

        door_box: dict = {}

        def on_change(rid, backend):
            d = door_box.get("door")
            if d is None:
                return
            if backend is None:
                d.suspend(rid)
            else:
                d.set_backend(rid, backend["host"], backend["port"])

        sup = ReplicaSupervisor(
            snapshot_dir=snap_dir, cache_dir=cache_dir,
            extra_flags=["--driver", "torch", "--torch-device", DEVICE],
            heartbeat_s=0.25, miss_threshold=2, backoff_base_s=0.1,
            on_backend_change=on_change,
        )
        handles = sup.start(2)
        for h in handles:
            if h.ready.get("restore_outcome") != "restored":
                problems.append(
                    f"replica {h.replica_id} came up "
                    f"{h.ready.get('restore_outcome')!r}, not warm"
                )
        if problems:
            return problems
        door = FrontDoor(
            [h.backend() for h in handles], probe_interval_s=0.1
        ).start()
        door_box["door"] = door

        victim = handles[1]
        killed_at = None
        for i, req in enumerate(reqs):
            if i == KILL_AT:
                os.kill(victim.proc.pid, signal.SIGKILL)
                killed_at = time.monotonic()
            body = json.dumps({"request": req}).encode()
            st, _hd, data = _post(door.port, body)
            if st != 200:
                problems.append(
                    f"request {i}: front door answered {st} "
                    f"({'during' if i >= KILL_AT else 'before'} the kill "
                    f"window) — a FAILED admission"
                )
                continue
            _check_verdict(i, data, oracle_verdicts, problems)

        # the supervisor restarts the victim warm and re-points the door
        deadline = killed_at + RECOVERY_BUDGET_S
        rid = victim.replica_id
        while time.monotonic() < deadline:
            st = sup.status()[rid]
            if st["state"] == "running" and st["restarts"] >= 1:
                break
            time.sleep(0.1)
        st = sup.status()[rid]
        if st["state"] != "running" or st["restarts"] < 1:
            problems.append(
                f"replica {rid} was not auto-restarted within "
                f"{RECOVERY_BUDGET_S:.0f}s: {st}"
            )
            return problems
        recovery_s = time.monotonic() - killed_at
        new_handle = [h for h in sup.handles()
                      if h.replica_id == rid][0]
        if new_handle.ready.get("restore_outcome") != "restored":
            problems.append(
                f"restarted replica {rid} came up "
                f"{new_handle.ready.get('restore_outcome')!r} — the warm "
                f"path regressed"
            )

        # post-recovery: both replicas serve parity-checked traffic
        served: set = set()
        for i, req in enumerate(reqs[:16]):
            body = json.dumps({"request": req}).encode()
            st_code, hd, data = _post(door.port, body)
            if st_code != 200:
                problems.append(
                    f"post-recovery request {i}: front door answered "
                    f"{st_code}"
                )
                continue
            served.add(hd.get("X-GK-Replica", ""))
            _check_verdict(i, data, oracle_verdicts, problems)
        if rid not in served:
            problems.append(
                f"restarted replica {rid} took no post-recovery traffic "
                f"(served by {sorted(served)})"
            )
        print(f"self-heal: recovery in {recovery_s:.2f}s "
              f"(spawn-to-ready {st['last_restart_s']}s), "
              f"door stats {json.dumps(door.stats())}", file=sys.stderr)
        return problems
    finally:
        if door is not None:
            door.stop()
        if sup is not None:
            sup.stop()
        shutil.rmtree(root, ignore_errors=True)


def main(argv=None) -> int:
    import argparse

    global DEVICE, CACHE_DIR
    ap = argparse.ArgumentParser(prog="check_self_heal_torch.py")
    ap.add_argument("--torch-device", default="cuda",
                    help="the client's and the replicas' device: cuda (the "
                         "default; raises without a card) or cpu")
    ap.add_argument("--xla-cache-dir", default="",
                    help="the replicas' sealed kernel cache (default: a "
                         "fresh directory)")
    args = ap.parse_args(argv)
    DEVICE, CACHE_DIR = args.torch_device, args.xla_cache_dir
    problems = run_checks()
    if problems:
        print("self-heal check FAILED:")
        for p in problems:
            print(f"  - {p}")
        return 1
    print(
        f"self-heal ok: {N_STREAM}-request parity stream survived a "
        f"SIGKILL at request {KILL_AT} with zero failed admissions and "
        f"zero verdict divergence; the replica auto-restarted warm and "
        f"rejoined the front door"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
