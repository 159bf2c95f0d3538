#!/usr/bin/env python
"""Overload-robustness conformance check of gatekeeper_tpu_torch (wired
tier-1 via tests/test_torch_overload_tool.py, also runnable standalone):

Two replicas restore one sealed snapshot behind the front door, with
the overload plane armed tight (replica ``--webhook-max-pending 8``,
door ``max_inflight=1`` + a 2s admission budget).  A short saturation
burst (closed-loop client threads well past capacity) drives the door;
the check asserts the overload contract of docs/failure-modes.md:

1. **sheds happen and are explicit** — past the bounds, requests answer
   429 at the door (or a 200-wrapped 429/504 verdict from the replica),
   every refusal a well-formed AdmissionReview carrying the explicit
   fail-open/closed decision — never a hang, never a bare error;
2. **sheds are fast** — door-level 429s answer in milliseconds (p99
   bounded loosely here for CI noise; bench.py overload records the
   tight single-digit-ms number);
3. **zero verdict divergence among accepted requests** — every request
   that WAS admitted through the storm answers byte-identically to a
   freshly loaded interpreter oracle (shedding drops requests, never
   accuracy);
4. **nothing unexplained** — no 502s, no connection errors, no
   responses outside the (accepted | shed | expired) taxonomy.

Run: python tools/check_overload.py [--edge threaded|evloop|both]
(exit 0 clean, 1 with findings).  ``--edge evloop`` drives the same
burst through the selectors-based front door and the replicas'
wire listeners — the overload contract is edge-independent and tier-1
proves it on both via ``--edge both`` (one fleet, both doors back to
back).  Spawns replica subprocesses; where spawn is unavailable the
tier-1 wrapper skips cleanly (same contract as check_self_heal).
"""

from __future__ import annotations

import http.client
import json
import os
import sys
import tempfile
import threading
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

from gatekeeper_tpu_torch.util.overloadcheck import (  # noqa: E402
    classify_response,
    verdict_matches,
)

N_TEMPLATES = 2
N_RESOURCES = 64
N_CORPUS = 48
N_CLIENTS = 10          # closed-loop threads, far past a 1-inflight door
BURST_S = 3.0
MAX_PENDING = 8         # replica-side batcher bound
MAX_INFLIGHT = 1        # door-side per-backend bound
BUDGET_S = 2.0          # door admission budget
SHED_P99_BOUND_S = 0.25  # loose CI bound; the bench records the tight one
# the client's and the replicas' device, and the replicas' kernel cache
# (main sets them from --torch-device and --xla-cache-dir; "" = a fresh
# directory)
DEVICE = "cuda"
CACHE_DIR = ""


def _requests():
    from gatekeeper_tpu_torch.util.synthetic import make_pods

    pods = make_pods(N_CORPUS, seed=47, violation_rate=0.4)
    out = []
    for i, p in enumerate(pods):
        out.append({
            "uid": f"overload-{i}",
            "kind": {"group": "", "version": "v1", "kind": "Pod"},
            "name": p["metadata"]["name"],
            "namespace": p["metadata"]["namespace"],
            "operation": "CREATE",
            "userInfo": {"username": "overload-check"},
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


# shared with bench.py overload so the tier-1 gate and the recorded
# artifact classify the SAME wire behavior the same way
classify = classify_response
_verdict_matches = verdict_matches


def _drive_door(door, edge: str, reqs, bodies, oracle_verdicts) -> list:
    problems: list = []
    try:
        results: list = []  # (kind, dur_s, status, out, corpus_idx)
        lock = threading.Lock()
        stop = time.monotonic() + BURST_S

        def slam(tid: int):
            i = tid
            while time.monotonic() < stop:
                idx = i % len(reqs)
                i += N_CLIENTS
                t0 = time.perf_counter()
                try:
                    conn = http.client.HTTPConnection(
                        "127.0.0.1", door.port, timeout=30)
                    conn.request(
                        "POST", "/v1/admit", body=bodies[idx],
                        headers={"Content-Type": "application/json"})
                    r = conn.getresponse()
                    data = r.read()
                    conn.close()
                    status = r.status
                except Exception:
                    status, data = 0, b""
                dur = time.perf_counter() - t0
                kind, out = classify(status, data)
                with lock:
                    results.append((kind, dur, status, out, idx))

        threads = [threading.Thread(target=slam, args=(t,))
                   for t in range(N_CLIENTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            if t.is_alive():
                problems.append("a burst client wedged past the join "
                                "budget — a refusal path is hanging")
                return problems

        by_kind: dict = {}
        for kind, *_rest in results:
            by_kind[kind] = by_kind.get(kind, 0) + 1
        if not results:
            return ["the burst produced no results at all"]
        if by_kind.get("problem"):
            bad = [(st, out) for k, _d, st, out, _i in results
                   if k == "problem"][:5]
            problems.append(
                f"{by_kind['problem']} responses outside the "
                f"accepted|shed|expired taxonomy (first: {bad})"
            )
        if not by_kind.get("shed"):
            problems.append(
                f"the saturation burst never shed "
                f"({by_kind}) — the bounds did not engage"
            )
        if not by_kind.get("accepted"):
            problems.append(
                f"everything was refused ({by_kind}) — no goodput "
                "under overload is collapse by another name"
            )
        if problems:
            return problems

        # sheds fast: door-level 429s (no proxy hop on that path)
        door_sheds = sorted(
            d for k, d, st, _o, _i in results
            if k == "shed" and st == 429
        )
        if door_sheds:
            p99 = door_sheds[min(int(0.99 * len(door_sheds)),
                                 len(door_sheds) - 1)]
            if p99 > SHED_P99_BOUND_S:
                problems.append(
                    f"door-shed p99 {p99 * 1e3:.1f}ms exceeds the "
                    f"{SHED_P99_BOUND_S * 1e3:.0f}ms bound — refusals "
                    "are queueing somewhere"
                )

        # zero verdict divergence among accepted
        divergences = 0
        for kind, _d, _st, out, idx in results:
            if kind != "accepted":
                continue
            if not _verdict_matches(out, oracle_verdicts[idx]):
                divergences += 1
        if divergences:
            problems.append(
                f"{divergences} accepted verdicts diverged from the "
                "oracle during the shedding burst"
            )

        print(
            f"overload [{edge}]: {len(results)} responses in "
            f"{BURST_S:.0f}s — {by_kind}; door sheds {len(door_sheds)} "
            f"(p99 {door_sheds[-1] * 1e3:.1f}ms max) ; door stats "
            f"{json.dumps(door.stats()['retry_budget'])}",
            file=sys.stderr,
        )
        return problems
    finally:
        door.stop()


def run_checks(edge: str = "evloop") -> list:
    """Drive the saturation burst through the requested serving edge(s).

    ``edge="both"`` stages ONE snapshot + replica fleet and drives the
    threaded door and the event-loop door against it back to back —
    the fleet spawn dominates the tool's runtime, and the contract
    being asserted is a property of the doors, not of the replicas.
    """
    import gc
    import shutil

    from gatekeeper_tpu_torch.fleet import EventFrontDoor, FrontDoor, spawn_fleet
    from gatekeeper_tpu_torch.snapshot import Snapshotter
    from gatekeeper_tpu_torch.util.synthetic import build_driver

    problems: list = []
    root = tempfile.mkdtemp(prefix="gk-overload-")
    snap_dir = os.path.join(root, "snap")
    cache_dir = CACHE_DIR or os.path.join(root, "cache")
    os.makedirs(snap_dir)
    os.makedirs(cache_dir, exist_ok=True)
    handles: list = []
    frozen = False
    try:
        client = build_driver(N_TEMPLATES, N_RESOURCES, device=DEVICE)
        client.audit_capped(50)
        if Snapshotter(client, snap_dir, interval_s=0.0).write_once() is None:
            return ["snapshot write failed; cannot stage the fleet"]
        reqs = _requests()
        oracle_verdicts = _oracle_verdicts(reqs)
        bodies = [json.dumps({"request": r}).encode() for r in reqs]

        handles = spawn_fleet(
            2, snapshot_dir=snap_dir, cache_dir=cache_dir,
            extra_flags=["--driver", "torch", "--torch-device", DEVICE,
                         "--webhook-max-pending", str(MAX_PENDING)],
        )
        edges = ("threaded", "evloop") if edge == "both" else (edge,)
        # the doors and the burst's clients share this process with
        # whatever it held before the drill (a test worker's earlier
        # files), and a full collection over that heap during a burst
        # stalls the door and its clients alike; frozen, it is out of
        # the collector's generations while the drill measures the door
        t0 = time.perf_counter()
        gc.collect()
        gc.freeze()
        frozen = True
        print(f"overload: the process held {gc.get_freeze_count()} "
              f"objects; one full collection over them took "
              f"{(time.perf_counter() - t0) * 1e3:.1f}ms; frozen while "
              "the doors are driven", file=sys.stderr)
        for e in edges:
            if e == "evloop":
                missing = [h.replica_id for h in handles if not h.wire_port]
                if missing:
                    problems.append(
                        f"replicas {missing} announced no wire_port — "
                        "the event edge cannot be driven")
                    continue
                door = EventFrontDoor(
                    [h.wire_backend() for h in handles],
                    probe_interval_s=0.1, max_inflight=MAX_INFLIGHT,
                    admission_budget_s=BUDGET_S,
                ).start()
            else:
                door = FrontDoor(
                    [h.backend() for h in handles], probe_interval_s=0.1,
                    max_inflight=MAX_INFLIGHT, admission_budget_s=BUDGET_S,
                ).start()
            problems.extend(
                f"[{e}] {p}"
                for p in _drive_door(door, e, reqs, bodies, oracle_verdicts))
        return problems
    finally:
        if frozen:
            gc.unfreeze()
        for h in handles:
            h.stop()
        shutil.rmtree(root, ignore_errors=True)


def main(argv=None) -> int:
    import argparse

    global DEVICE, CACHE_DIR
    ap = argparse.ArgumentParser(prog="check_overload_torch.py")
    ap.add_argument("--edge", choices=("threaded", "evloop", "both"),
                    default="evloop",
                    help="which serving edge to saturate (default: the "
                         "event-loop door + wire listeners; the threaded "
                         "FrontDoor is deprecated and must be asked for "
                         "explicitly; both = one fleet, both doors back "
                         "to back)")
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
        print("overload check FAILED:")
        for p in problems:
            print(f"  - {p}")
        return 1
    print(
        f"overload ok ({args.edge} edge): the saturation burst shed "
        "fast with explicit fail-open/closed verdicts, kept goodput, "
        "and accepted requests matched the interpreter oracle with "
        "zero divergence"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
