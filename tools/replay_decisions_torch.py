#!/usr/bin/env python
"""Differential replay of recorded admission decisions.

The decision log (gatekeeper_tpu_torch/obs/decisionlog.py) archives every
admission verdict with the AdmissionReview request embedded.  This tool
closes the loop: it re-evaluates each recorded request against the
CURRENT engine (the port's ``TorchDriver``, on the CUDA card unless
``--torch-device cpu`` asks for the CPU) and asserts verdict + message
BYTE parity (via the shared
sha256 message digest), reporting any drift with route attribution — the
recorded route tier/reason next to the tier the live router chose.  The
archive thereby becomes a continuous differential oracle seeded from
real traffic: an engine change that silently flips a verdict fails here
before it fails a cluster (the dynamic half of the cross-layer
verification discipline; gklint is the static half).  The records are
the JAX package's format: a log either package recorded replays through
either package's tool.  The report's ``routes`` counts the tier and
reason the live router chose for the replayed batches.

What replays:

- ``admission`` records of class ``allow``/``deny`` with an unmasked
  embedded request.  Sheds, deadline expiries and internal errors are
  load/time-dependent, not engine-determined — they are skipped and
  counted (``skipped_transient``), as are masked records
  (``skipped_masked``) and audit transitions.

Seal verification: segments whose records carry ``sig`` are chain-
verified before replay; ``--require-seal`` makes any unsealed or broken
record fatal (rc 2).

Usage:

  replay_decisions_torch.py --log-dir D --snapshot-dir S   restore the
        sealed snapshot (templates, constraints, inventory; written by
        the port's App) and replay D
  replay_decisions_torch.py --log-dir D --bug-compat       replay under
        GK_BUG_COMPAT=1 (expected to drift where docs/rego.md documents
        divergences — the seeded-oracle mode)
  replay_decisions_torch.py --selftest                     end-to-end
        proof on a synthetic corpus: records decisions, replays them at
        zero drift, then replays under GK_BUG_COMPAT=1 and REQUIRES the
        seeded divergence to be flagged.  Wired tier-1 via
        tests/test_torch_replay_tool.py (``--torch-device cpu``).
  --torch-device cpu|cuda                            the engine's device
        (default cuda: without a card the engine fails to build, rc 2)

Exit codes: 0 parity (selftest: parity AND seeded drift flagged),
1 drift, 2 usage/seal/engine error.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional, Tuple

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


# ---- archive loading --------------------------------------------------------


def load_records(log_dir: str,
                 require_seal: bool = False) -> Tuple[List[dict], List[str]]:
    """Records from every completed segment under ``log_dir`` (oldest
    first), plus seal problems.  Sealed segments are chain-verified;
    with ``require_seal`` an unsealed record is a problem too."""
    from gatekeeper_tpu_torch.obs import decisionlog as dlog

    records: List[dict] = []
    problems: List[str] = []
    for path in dlog.segment_paths(log_dir):
        # ONE read + parse per segment serves both the chain check and
        # record loading (verify_segment semantics, inlined: sealed
        # records are always chain-verified; a fully-unsealed segment
        # is a problem only under require_seal — but a MIXED segment is
        # flagged unconditionally: unsealed lines spliced between
        # sealed ones leave the chain intact, so without this check a
        # fabricated record would enter the replay corpus silently)
        prev = ""
        saw_sealed = saw_unsealed = False
        try:
            with open(path) as f:
                for lineno, line in enumerate(f, 1):
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        rec = json.loads(line)
                    except ValueError:
                        problems.append(
                            f"{path}:{lineno}: unparseable record"
                        )
                        prev = ""
                        continue
                    sig = rec.get("sig")
                    if sig is None:
                        saw_unsealed = True
                        if require_seal:
                            problems.append(
                                f"{path}:{lineno}: record is unsealed"
                            )
                    else:
                        saw_sealed = True
                        if dlog.chain_sig(prev, rec) != sig:
                            problems.append(
                                f"{path}:{lineno}: seal chain broken "
                                "(record edited, reordered, or chained "
                                "to a tampered predecessor)"
                            )
                        prev = sig
                    records.append(rec)
        except OSError as e:
            problems.append(f"{path}: unreadable: {e}")
        if saw_sealed and saw_unsealed and not require_seal:
            problems.append(
                f"{path}: mixed sealed and unsealed records — unsealed "
                "lines in a sealed segment bypass the chain (possible "
                "insertion)"
            )
    return records, problems


# ---- replay -----------------------------------------------------------------


def replay_records(handler, records: List[dict],
                   max_drift: int = 64) -> dict:
    """Re-evaluate recorded admissions against ``handler`` (a
    ValidationHandler) and diff verdict + message digest.  Recording is
    paused for the duration so replayed requests are never re-archived
    into the corpus they came from."""
    from gatekeeper_tpu_torch.obs import decisionlog as dlog
    from gatekeeper_tpu_torch.obs import routeledger

    log = dlog.get_log()
    was_recording = log.record_enabled
    log.record_enabled = False
    report = {
        "replayed": 0,
        "drift": [],
        "drift_count": 0,
        "skipped_masked": 0,
        "skipped_transient": 0,
        "skipped_other": 0,
        "routes": {},
    }
    ledger = routeledger.get_active()
    routes0 = ledger.snapshot(limit=0)["counts"] if ledger else {}
    try:
        for rec in records:
            if rec.get("kind") != dlog.KIND_ADMISSION:
                report["skipped_other"] += 1
                continue
            if rec.get("masked"):
                report["skipped_masked"] += 1
                continue
            if rec.get("class") not in (dlog.CLASS_ALLOW, dlog.CLASS_DENY):
                report["skipped_transient"] += 1
                continue
            req = rec.get("request")
            if not isinstance(req, dict):
                report["skipped_other"] += 1
                continue
            resp = handler.handle(req)
            digest = dlog.message_digest(resp.message)
            recorded = rec.get("verdict") or {}
            ok = (
                bool(resp.allowed) == bool(recorded.get("allowed"))
                and int(resp.code) == int(recorded.get("code", 0))
                and digest == rec.get("message_sha256")
            )
            report["replayed"] += 1
            if not ok:
                report["drift_count"] += 1
                if len(report["drift"]) < max_drift:
                    ledger = routeledger.get_active()
                    now_route = ledger.last() if ledger is not None \
                        else None
                    report["drift"].append({
                        "uid": rec.get("uid"),
                        "seq": rec.get("seq"),
                        "recorded": {
                            "class": rec.get("class"),
                            "verdict": recorded,
                            "message_sha256": rec.get("message_sha256"),
                            "route": rec.get("route"),
                        },
                        "replayed": {
                            "allowed": bool(resp.allowed),
                            "code": int(resp.code),
                            "message_sha256": digest,
                            "message": (resp.message or "")[:256],
                            "route": (
                                {"tier": now_route[0],
                                 "reason": now_route[1]}
                                if now_route else None
                            ),
                        },
                    })
    finally:
        log.record_enabled = was_recording
    if ledger is not None:
        # the live tier of every batch the replay evaluated (a memo hit
        # evaluates nothing and routes nothing)
        report["routes"] = {
            k: n - routes0.get(k, 0)
            for k, n in ledger.snapshot(limit=0)["counts"].items()
            if n != routes0.get(k, 0)
        }
    return report


def build_handler_from_snapshot(snapshot_dir: str, device: str = "cuda"):
    """The CLI's engine: a fresh TorchDriver client on ``device``
    restored from the sealed snapshot (templates, constraints, packed
    inventory), handed to a ValidationHandler over the restored
    in-memory store."""
    from gatekeeper_tpu_torch.client.client import Client
    from gatekeeper_tpu_torch.kube.inmem import InMemoryKube
    from gatekeeper_tpu_torch.ops.driver import TorchDriver
    from gatekeeper_tpu_torch.snapshot import SnapshotLoader
    from gatekeeper_tpu_torch.webhook.policy import ValidationHandler

    client = Client(driver=TorchDriver(device=device))
    kube = InMemoryKube()
    outcome = SnapshotLoader(snapshot_dir).restore(
        client, kube, resync=False
    )
    if outcome != "restored":
        raise RuntimeError(
            f"snapshot restore outcome {outcome!r}: the replay engine "
            "must be the archived policy set, not a cold guess"
        )
    # the namespace cache the recorded decisions read (autoreject,
    # namespaceSelector): the restored inventory's Namespace objects.
    # Without them every namespaced request would answer "namespace not
    # found" and drift; a snapshot that holds none (its Config synced no
    # Namespace) cannot replay namespaced requests
    import copy

    store = client.driver.store
    with store._lock:
        namespaces = [
            copy.deepcopy(obj) for obj in
            ((store.tree.get("cluster") or {}).get("v1") or {})
            .get("Namespace", {}).values()
        ]
    for obj in namespaces:
        kube.create(obj)
    if not namespaces:
        print("replay_decisions: the snapshot holds no Namespace (its "
              "Config syncs none): namespaced requests will drift",
              file=sys.stderr)
    return ValidationHandler(client, kube=kube)


# ---- selftest ---------------------------------------------------------------

# a template whose verdict flips under GK_BUG_COMPAT (docs/rego.md:
# regex.globs_match("", "") is false here, true in the reference) — the
# no-compat verdict is a DENY, so the record is always-kept under any
# sampling and the seeded divergence cannot hide in a sampled-out allow
_COMPAT_TEMPLATE = {
    "apiVersion": "templates.gatekeeper.sh/v1beta1",
    "kind": "ConstraintTemplate",
    "metadata": {"name": "replayglobs"},
    "spec": {
        "crd": {"spec": {"names": {"kind": "ReplayGlobs"}}},
        "targets": [{
            "target": "admission.k8s.gatekeeper.sh",
            "rego": """
package replayglobs

violation[{"msg": msg}] {
  g := input.review.object.metadata.labels.glob
  not regex.globs_match(g, "")
  msg := sprintf("glob label %v shares no string with the empty glob on %v", [g, input.review.object.metadata.name])
}
""",
        }],
    },
}
_COMPAT_CONSTRAINT = {
    "apiVersion": "constraints.gatekeeper.sh/v1beta1",
    "kind": "ReplayGlobs",
    "metadata": {"name": "replay-globs"},
    "spec": {
        "match": {"kinds": [{"apiGroups": [""], "kinds": ["Pod"]}]},
    },
}


def _selftest_handler(seed: int = 15, device: str = "cuda"):
    from gatekeeper_tpu_torch.client.client import Client
    from gatekeeper_tpu_torch.ops.driver import TorchDriver
    from gatekeeper_tpu_torch.util.synthetic import make_templates
    from gatekeeper_tpu_torch.webhook.policy import ValidationHandler

    templates, constraints = make_templates(4, seed=seed)
    client = Client(driver=TorchDriver(device=device))
    for t in templates + [_COMPAT_TEMPLATE]:
        client.add_template(t)
    for cons in constraints + [_COMPAT_CONSTRAINT]:
        client.add_constraint(cons)
    return ValidationHandler(client)


def selftest_requests(n: int = 40, divergent: int = 4,
                      violation_rate: float = 0.25) -> List[dict]:
    from gatekeeper_tpu_torch.util.synthetic import make_pods

    pods = make_pods(n, seed=15, violation_rate=violation_rate)
    for pod in pods[:divergent]:
        # the GK_BUG_COMPAT oracle rows: denied now, allowed under compat
        pod["metadata"]["labels"]["glob"] = ""
    return [{
        "uid": f"replay-{i}",
        "kind": {"group": "", "version": "v1", "kind": "Pod"},
        "name": p["metadata"]["name"],
        "namespace": p["metadata"]["namespace"],
        "operation": "CREATE",
        "object": p,
    } for i, p in enumerate(pods)]


def run_selftest(verbose: bool = True, device: str = "cuda") -> int:
    """Record a synthetic corpus, replay it at zero drift against the
    live engine, then replay under GK_BUG_COMPAT=1 against a FRESH
    engine (per-call env read; a fresh client defeats the content-keyed
    request memo) and require the seeded divergence to be flagged."""
    import tempfile

    from gatekeeper_tpu_torch.obs import decisionlog as dlog

    def say(msg):
        if verbose:
            print(f"replay_decisions selftest: {msg}")

    log_dir = tempfile.mkdtemp(prefix="gk-decisions-")
    log = dlog.get_log()
    log.configure(dir=log_dir, seal=True, sample_rate=1.0)
    log.record_enabled = True
    log.start()
    try:
        return _selftest_body(say, log, log_dir, device)
    finally:
        # the recorder is process-global: leave it detached and the
        # corpus removed on EVERY exit path, or later work in an
        # embedding process keeps archiving into this tmp dir
        import shutil

        log.stop()
        log.clear()
        log.configure(dir="", sample_rate=1.0, seal=False)
        log.record_enabled = True
        shutil.rmtree(log_dir, ignore_errors=True)


def _selftest_body(say, log, log_dir, device) -> int:
    from gatekeeper_tpu_torch.obs import decisionlog as dlog

    handler = _selftest_handler(device=device)
    reqs = selftest_requests()
    denied = 0
    for req in reqs:
        resp = handler.handle(req)
        denied += 0 if resp.allowed else 1
    log.flush()
    records, problems = load_records(log_dir, require_seal=True)
    if problems:
        for p in problems:
            say(f"seal problem: {p}")
        return 2
    admissions = [r for r in records
                  if r.get("kind") == dlog.KIND_ADMISSION]
    if len(admissions) != len(reqs):
        say(f"recorded {len(admissions)} admissions for {len(reqs)} "
            "requests")
        return 2
    say(f"recorded {len(admissions)} admissions ({denied} denied, "
        f"sealed, {len(dlog.segment_paths(log_dir))} segment(s))")

    baseline = replay_records(handler, records)
    say(f"baseline replay: {baseline['replayed']} replayed, "
        f"{baseline['drift_count']} drift, routes {baseline['routes']}")
    if baseline["drift_count"] != 0:
        for d in baseline["drift"]:
            say(f"unexpected drift: {json.dumps(d)}")
        return 1

    prev = os.environ.get("GK_BUG_COMPAT")
    os.environ["GK_BUG_COMPAT"] = "1"
    try:
        compat = replay_records(_selftest_handler(device=device), records)
    finally:
        if prev is None:
            os.environ.pop("GK_BUG_COMPAT", None)
        else:
            os.environ["GK_BUG_COMPAT"] = prev
    say(f"GK_BUG_COMPAT replay: {compat['replayed']} replayed, "
        f"{compat['drift_count']} drift, routes {compat['routes']}")
    if compat["drift_count"] == 0:
        say("seeded GK_BUG_COMPAT divergence was NOT flagged — the "
            "differential oracle is blind")
        return 1
    sample = compat["drift"][0]
    say(f"seeded drift flagged (e.g. uid={sample['uid']}: recorded "
        f"{sample['recorded']['verdict']} -> replayed "
        f"allowed={sample['replayed']['allowed']})")
    say("ok")
    return 0


# ---- CLI --------------------------------------------------------------------


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--log-dir", help="decision-log segment directory")
    ap.add_argument("--snapshot-dir",
                    help="sealed snapshot to restore the engine from")
    ap.add_argument("--require-seal", action="store_true",
                    help="fail (rc 2) on any unsealed or chain-broken "
                         "record")
    ap.add_argument("--bug-compat", action="store_true",
                    help="replay under GK_BUG_COMPAT=1 (seeded-oracle "
                         "mode: documented divergences SHOULD drift)")
    ap.add_argument("--max-drift", type=int, default=64,
                    help="drift entries detailed in the report")
    ap.add_argument("--json", action="store_true",
                    help="print the full report as JSON")
    ap.add_argument("--selftest", action="store_true",
                    help="synthetic end-to-end proof (record -> zero "
                         "drift -> seeded GK_BUG_COMPAT drift flagged)")
    ap.add_argument("--torch-device", default="cuda",
                    help="the engine's device: cuda (the default; fails "
                         "without a card) or cpu")
    args = ap.parse_args(argv)

    if args.selftest:
        try:
            return run_selftest(device=args.torch_device)
        except Exception as e:
            print(f"replay_decisions: selftest engine failed: {e}",
                  file=sys.stderr)
            return 2
    if not args.log_dir or not args.snapshot_dir:
        ap.error("--log-dir and --snapshot-dir are required "
                 "(or --selftest)")
    records, problems = load_records(args.log_dir,
                                     require_seal=args.require_seal)
    for p in problems:
        print(f"replay_decisions: {p}", file=sys.stderr)
    if problems and args.require_seal:
        return 2
    try:
        handler = build_handler_from_snapshot(args.snapshot_dir,
                                              args.torch_device)
    except Exception as e:
        print(f"replay_decisions: engine restore failed: {e}",
              file=sys.stderr)
        return 2
    prev = os.environ.get("GK_BUG_COMPAT")
    if args.bug_compat:
        os.environ["GK_BUG_COMPAT"] = "1"
    try:
        report = replay_records(handler, records,
                                max_drift=args.max_drift)
    finally:
        if args.bug_compat:
            if prev is None:
                os.environ.pop("GK_BUG_COMPAT", None)
            else:
                os.environ["GK_BUG_COMPAT"] = prev
    if args.json:
        print(json.dumps(report, indent=2, sort_keys=True))
    else:
        print(
            f"replay_decisions: {report['replayed']} replayed, "
            f"{report['drift_count']} drift, "
            f"{report['skipped_transient']} transient skipped, "
            f"{report['skipped_masked']} masked skipped, "
            f"routes {report['routes']}"
        )
        for d in report["drift"]:
            print(f"replay_decisions: DRIFT {json.dumps(d)}",
                  file=sys.stderr)
    return 1 if report["drift_count"] else 0


if __name__ == "__main__":
    sys.exit(main())
