#!/usr/bin/env python
"""Fleet serving conformance check of gatekeeper_tpu_torch (wired tier-1
via tests/test_torch_fleet_parity_tool.py; also runnable standalone):

1. Replica byte-parity: the same AdmissionReview POSTed to every fleet
   replica (each a separate PROCESS restoring the same sealed snapshot)
   must produce BYTE-identical response bodies, identical to a solo
   replica serving outside the fleet — the single-process path.  A
   divergence here means shared-warmth restore drifted between
   processes, the one bug class a fleet can ship that a single process
   cannot.
2. Front-door fidelity: the body returned through the front door must be
   byte-identical to what the chosen backend answered (the door must
   never rewrite a verdict), and the X-GK-Replica attribution must name
   a real backend.
3. Oracle parity: allow/deny and the rendered violation text (sans the
   webhook's "[denied by ...]" prefix) must match a freshly loaded
   interpreter oracle evaluating the same requests byte-for-byte.
4. Event-edge fidelity: the same corpus through the
   selectors-based front door — persistent connections, batched wire
   protocol to the replicas' wire listeners — must answer byte-identical
   bodies too.  The door is a byte splice on both edges or it is wrong.

The snapshot comes from a TorchDriver client on ``--torch-device``
(default cuda) and every replica is the port's (``python -m
gatekeeper_tpu_torch.fleet.replica --driver torch --torch-device
<device>``), so on the card each admission runs K1 and K9; without a
card the drill raises before it spawns anything, and a replica told
cuda never runs on the CPU.  ``--xla-cache-dir DIR`` gives the replicas
a sealed kernel cache (DIR/torch_kernels, as an image bakes it); the
default is a fresh directory, where the first replica builds them.  The
oracle is the port's InterpDriver.

Run: python tools/check_fleet_parity_torch.py [--edge threaded|evloop|both]
[--torch-device cuda|cpu] [--xla-cache-dir DIR] (exit 0 clean, 1 with
findings).  Spawns 3 replica subprocesses; where process spawn is
unavailable the tier-1 wrapper skips cleanly.
"""

from __future__ import annotations

import http.client
import json
import os
import re
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

N_TEMPLATES = 4
N_RESOURCES = 48
N_REQUESTS = 24
# the client's and the replicas' device, and the replicas' kernel cache
# (main sets them from --torch-device and --xla-cache-dir; "" = a fresh
# directory)
DEVICE = "cuda"
CACHE_DIR = ""


def _sample_requests():
    from gatekeeper_tpu_torch.util.synthetic import make_pods

    pods = make_pods(N_REQUESTS, seed=77, violation_rate=0.5)
    reqs = []
    for i, p in enumerate(pods):
        reqs.append({
            "uid": f"fleet-parity-{i}",
            "kind": {"group": "", "version": "v1", "kind": "Pod"},
            "name": p["metadata"]["name"],
            "namespace": p["metadata"]["namespace"],
            "operation": "CREATE",
            "userInfo": {"username": "fleet-parity"},
            "object": p,
        })
    return reqs


def _post(port: int, body: bytes, path: str = "/v1/admit"):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("POST", path, body=body,
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, dict(resp.getheaders()), resp.read()
    finally:
        conn.close()


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


def diff_verdicts(raw_bodies, oracle_verdicts) -> list:
    """Pure comparison core (unit-testable without processes):
    raw_bodies is {replica_id: [bytes per request]} including the
    'solo' single-process replica; oracle_verdicts is
    [(allowed, sorted violation messages)].  -> list of problem
    strings.  Violation text is compared byte-for-byte after stripping
    the webhook's "[denied by <constraint>] " prefix (reference
    log_denies format) — count-only parity would pass a renderer that
    produces the right number of wrong messages."""
    problems = []
    ids = sorted(raw_bodies)
    n = min(len(v) for v in raw_bodies.values())
    for i in range(n):
        bodies = {rid: raw_bodies[rid][i] for rid in ids}
        if len(set(bodies.values())) != 1:
            problems.append(
                f"request {i}: replica responses diverge "
                f"({', '.join(f'{r}={len(b)}B' for r, b in bodies.items())})"
            )
            continue
        out = json.loads(bodies[ids[0]])["response"]
        allowed = out["allowed"]
        msgs = sorted(
            re.sub(r"^\[denied by [^\]]+\] ", "", m)
            for m in (out.get("status") or {}).get(
                "message", "").split("\n") if m
        ) if not allowed else []
        o_allowed, o_msgs = oracle_verdicts[i]
        if allowed != o_allowed:
            problems.append(
                f"request {i}: fleet allowed={allowed} but the "
                f"interpreter oracle says {o_allowed}"
            )
        elif not allowed and msgs != o_msgs:
            problems.append(
                f"request {i}: fleet rendered {msgs}, "
                f"oracle {o_msgs}"
            )
    return problems


def run_checks(edge: str = "both") -> list:
    import shutil

    from gatekeeper_tpu_torch.fleet import (
        EventFrontDoor,
        FrontDoor,
        spawn_fleet,
        spawn_replica,
    )
    from gatekeeper_tpu_torch.snapshot import Snapshotter
    from gatekeeper_tpu_torch.util.synthetic import build_driver

    problems: list = []
    root = tempfile.mkdtemp(prefix="gk-fleet-parity-")
    snap_dir = os.path.join(root, "snap")
    cache_dir = CACHE_DIR or os.path.join(root, "cache")
    os.makedirs(snap_dir)
    os.makedirs(cache_dir, exist_ok=True)
    solo = None
    fleet = []
    door = None
    try:
        client = build_driver(N_TEMPLATES, N_RESOURCES, device=DEVICE)
        client.audit_capped(50)
        if Snapshotter(client, snap_dir, interval_s=0.0).write_once() is None:
            return ["snapshot write failed; cannot stage the fleet"]

        reqs = _sample_requests()
        oracle_verdicts = _oracle_verdicts(reqs)

        flags = ["--driver", "torch", "--torch-device", DEVICE]
        solo = spawn_replica("solo", snap_dir, cache_dir, extra_flags=flags)
        fleet = spawn_fleet(2, snapshot_dir=snap_dir, cache_dir=cache_dir,
                            extra_flags=flags)
        for h in [solo] + fleet:
            if h.ready.get("restore_outcome") != "restored":
                problems.append(
                    f"replica {h.replica_id} restored "
                    f"{h.ready.get('restore_outcome')!r}, not the shared "
                    f"snapshot — parity would compare cold processes"
                )
        if problems:
            return problems
        if edge in ("threaded", "both"):
            door = FrontDoor([h.backend() for h in fleet]).start()

        raw: dict = {h.replica_id: [] for h in [solo] + fleet}
        door_bodies = []
        for i, req in enumerate(reqs):
            body = json.dumps({"request": req}).encode()
            for h in [solo] + fleet:
                st, _hd, data = _post(h.port, body)
                if st != 200:
                    problems.append(
                        f"request {i}: replica {h.replica_id} "
                        f"answered {st}"
                    )
                raw[h.replica_id].append(data)
            if door is None:
                continue
            st, hd, data = _post(door.port, body)
            if st != 200:
                problems.append(f"request {i}: front door answered {st}")
            rid = hd.get("X-GK-Replica", "")
            if rid not in raw:
                problems.append(
                    f"request {i}: front door attributed to unknown "
                    f"replica {rid!r}"
                )
            door_bodies.append(data)

        problems += diff_verdicts(raw, oracle_verdicts)

        # front-door fidelity: the forwarded body is exactly what the
        # replicas answer (replica parity already verified above)
        for i, data in enumerate(door_bodies):
            if data != raw["solo"][i]:
                problems.append(
                    f"request {i}: front door body differs from the "
                    f"replica answer (door {len(data)}B, "
                    f"replica {len(raw['solo'][i])}B)"
                )

        # event-loop edge: the same corpus through the
        # selectors door + batched wire protocol.  The replica parses
        # the AdmissionReview once at its wire listener and the door
        # splices bytes both ways, so the body must STILL be identical
        # to what the HTTP listener answers for the same request.
        if edge in ("evloop", "both"):
            missing = [h.replica_id for h in fleet if not h.wire_port]
            if missing:
                return problems + [
                    f"replicas {missing} announced no wire_port — the "
                    "event edge cannot be driven"
                ]
            evdoor = EventFrontDoor(
                [h.wire_backend() for h in fleet]).start()
            try:
                for i, req in enumerate(reqs):
                    body = json.dumps({"request": req}).encode()
                    st, hd, data = _post(evdoor.port, body)
                    if st != 200:
                        problems.append(
                            f"request {i}: event-loop door answered {st}"
                        )
                        continue
                    rid = hd.get("X-GK-Replica", "")
                    if rid not in raw:
                        problems.append(
                            f"request {i}: event-loop door attributed "
                            f"to unknown replica {rid!r}"
                        )
                    if data != raw["solo"][i]:
                        problems.append(
                            f"request {i}: event-edge body differs from "
                            f"the replica answer (edge {len(data)}B, "
                            f"replica {len(raw['solo'][i])}B)"
                        )
            finally:
                evdoor.stop()
        return problems
    finally:
        if door is not None:
            door.stop()
        for h in fleet:
            h.stop()
        if solo is not None:
            solo.stop()
        shutil.rmtree(root, ignore_errors=True)


def main(argv=None) -> int:
    import argparse

    global DEVICE, CACHE_DIR
    ap = argparse.ArgumentParser(prog="check_fleet_parity_torch.py")
    ap.add_argument("--edge", choices=("threaded", "evloop", "both"),
                    default="evloop",
                    help="which serving edge(s) to drive the corpus "
                         "through (default: evloop — the threaded "
                         "FrontDoor is deprecated and must be asked for "
                         "explicitly, or use 'both' for back-to-back)")
    ap.add_argument("--torch-device", default="cuda",
                    help="the client's and the replicas' device: cuda (the "
                         "default; raises without a card) or cpu")
    ap.add_argument("--xla-cache-dir", default="",
                    help="the replicas' sealed kernel cache (default: a "
                         "fresh directory)")
    args = ap.parse_args(argv)
    DEVICE, CACHE_DIR = args.torch_device, args.xla_cache_dir
    problems = run_checks(edge=args.edge)
    if problems:
        print("fleet parity check FAILED:")
        for p in problems:
            print(f"  - {p}")
        return 1
    print(
        f"fleet parity ok: {N_REQUESTS} requests byte-identical across "
        f"solo + 2 fleet replicas, front-door fidelity verified on the "
        f"{args.edge} edge(s), verdicts match the interpreter oracle"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
