"""Fleet serving: N single-role webhook replicas with shared warmth.

The million-user admission plane (ROADMAP item 2, docs/fleet.md) is
horizontal: one Python process tops out around the measured streamed
review rate, so scale comes from running N webhook-only replicas
(`--operation webhook`, main.py role wiring per the reference
pkg/operations/operations.go:13-29), each restoring the HMAC-sealed
snapshot and the AOT executable cache a single audit-role process
maintains — a scaled-up replica is device-ready in seconds instead of
paying the cold relist + trace + compile.

Pieces:

- :mod:`replica` — the replica worker runtime (subprocess entry point +
  parent-side spawn/ready/stop helpers used by ``bench.py fleet`` and
  ``tools/check_fleet_parity.py``);
- :mod:`frontdoor` — a stdlib HTTP front door (round-robin or
  least-inflight, with health-based ejection, probing readmission and
  a bounded single retry) for benching and parity checks; production
  fleets use a Service/LB, this one exists so the repo can DRIVE and
  PROVE the topology end to end;
- :mod:`evloop` / :mod:`wireproto` / :mod:`evdoor` /
  :mod:`wirelistener` — the event-loop admission data plane:
  a selectors-based reactor, the framed chunk protocol, the
  non-blocking front door (persistent pipelined client connections,
  byte-splice proxying) and the replica-side batch listener that feeds
  whole chunks into the micro-batcher via ``submit_many``;
- :mod:`supervisor` — replica supervision (exit/wedge detection, warm
  restarts with capped backoff, flap quarantine, graceful drain and
  zero-failed-admission rolling restarts;
  docs/failure-modes.md fleet failure matrix).  Its
  ``trace_targets()``/``metrics_targets()`` rosters feed the fleet
  observability plane (:mod:`gatekeeper_tpu_torch.obs.fleetobs`):
  the front door originates wire traces, federates every replica's
  /metrics, and serves cross-process joined traces at
  ``/debug/fleet-traces``.

Trust model: replicas share the snapshot + AOT directories read-mostly
(atomic-rename snapshots, flock-serialized writers, sealed entries
verified before any unpickle — util/seal.py, same key via GK_SEAL_KEY).
Per-replica identity (`--replica-id`) is stamped into metrics
(`replica_up`, `webhook_batch_*`), root spans, and the SLO /statusz
payload.
"""

from .evdoor import EventFrontDoor
from .frontdoor import FrontDoor
from .replica import ReplicaHandle, spawn_replica, spawn_fleet
from .supervisor import ReplicaSupervisor
from .wirelistener import WireListener

__all__ = [
    "EventFrontDoor",
    "FrontDoor",
    "ReplicaHandle",
    "ReplicaSupervisor",
    "WireListener",
    "spawn_replica",
    "spawn_fleet",
]
