"""Process-global fault-injection plane (see `faults.plane`).

Production hot paths guard injection with ONE branch:

    from .. import faults
    if faults.ENABLED:
        faults.fire(faults.TPU_DISPATCH)

`ENABLED` stays False (and `fire` a no-op) unless `install()` is called
explicitly — by a chaos test, or by the process entry point when the
operator sets an explicit fault spec.  Nothing here imports jax or any
other heavyweight dependency.
"""

from __future__ import annotations

from typing import Optional

from .plane import ERROR, HANG, LATENCY, FaultError, FaultPlane, FaultRule

# ---- named injection points -------------------------------------------------

KUBE_SEND = "kube.http.send"          # kube/http_client.py request send
KUBE_RECV = "kube.http.recv"          # kube/http_client.py response read
WATCH_DELIVER = "watch.deliver"       # watch/manager.py pump fan-out
TPU_COMPILE = "tpu.compile"           # ops/driver.py fused-fn (re)build
TPU_DISPATCH = "tpu.dispatch"         # ops/driver.py device dispatch
WEBHOOK_ENQUEUE = "webhook.enqueue"   # webhook/server.py batch queue
SNAPSHOT_WRITE = "snapshot.write"     # snapshot/writer.py persist path
SNAPSHOT_LOAD = "snapshot.load"       # snapshot/loader.py validate+restore
SNAPSHOT_RESYNC = "snapshot.resync"   # snapshot/loader.py kube delta resync
SNAPSHOT_CORRUPT = "snapshot.corrupt"  # snapshot/loader.py post-seal payload
#                                       validation (error -> quarantine)
# fleet self-healing seams (fleet/replica.py child runtime; the
# supervisor's chaos drives these through the GK_CHAOS child spec)
REPLICA_CRASH = "fleet.replica_crash"  # replica chaos pulse: error = the
#                                        child hard-exits (rc 23)
REPLICA_WEDGE = "fleet.replica_wedge"  # replica command loop: hang = the
#                                        child stops answering its pipe
MESH_DISPATCH_STALL = "mesh.dispatch_stall"  # ops/driver.py mesh-collective
#                                        enqueue (hang = stuck rendezvous)
# fleet observability plane
SCRAPE_FAIL = "fleet.scrape_fail"      # obs/fleetobs.py federated scrape of
#                                        one replica exporter (error = the
#                                        scrape fails -> stale-marked view)
PROFILER_STALL = "obs.profiler_stall"  # obs/profiler.py sampler tick (hang
#                                        = a wedged sampler; snapshots and
#                                        the hot path must keep serving)
# overload robustness plane
OVERLOAD_STORM = "fleet.overload_storm"  # fleet/frontdoor.py admission POST
#                                        before routing (latency = handler
#                                        threads held -> inflight climbs ->
#                                        the shed/brownout path exercises)
SLOW_CLIENT = "frontdoor.slow_client"   # fleet/frontdoor.py inbound body
#                                        read (latency = a client trickling
#                                        its body holds an accept thread —
#                                        bounded by the inbound socket
#                                        timeout)
# reactor observability plane
EVLOOP_SLOW_CALLBACK = "evloop.slow_callback"  # obs/reactorobs.py heartbeat
#                                        callback (latency = ONE reactor
#                                        callback runs long -> the slow-
#                                        callback attribution must name it)
EVLOOP_STALL = "evloop.stall"          # obs/reactorobs.py heartbeat
#                                        callback (latency past the
#                                        watchdog budget = the whole loop
#                                        stalls -> the cross-thread
#                                        watchdog must dump the reactor
#                                        stack)

ALL_POINTS = (
    KUBE_SEND, KUBE_RECV, WATCH_DELIVER, TPU_COMPILE, TPU_DISPATCH,
    WEBHOOK_ENQUEUE, SNAPSHOT_WRITE, SNAPSHOT_LOAD, SNAPSHOT_RESYNC,
    SNAPSHOT_CORRUPT, REPLICA_CRASH, REPLICA_WEDGE, MESH_DISPATCH_STALL,
    SCRAPE_FAIL, PROFILER_STALL, OVERLOAD_STORM, SLOW_CLIENT,
    EVLOOP_SLOW_CALLBACK, EVLOOP_STALL,
)

# ---- the process-global plane ----------------------------------------------

ENABLED = False
_plane: Optional[FaultPlane] = None


def install(seed: int = 0, plane: Optional[FaultPlane] = None) -> FaultPlane:
    """Enable fault injection process-wide.  Returns the active plane so
    callers can add rules.  Idempotent only in the sense that a second
    install replaces the first plane wholesale."""
    global _plane, ENABLED
    _plane = plane if plane is not None else FaultPlane(seed=seed)
    ENABLED = True
    return _plane


def uninstall():
    """Disable injection and drop the plane.  In-flight hangs are released
    first so no thread stays parked on a dead plane."""
    global _plane, ENABLED
    ENABLED = False
    p, _plane = _plane, None
    if p is not None:
        p.release_hangs()


def get_plane() -> Optional[FaultPlane]:
    return _plane


def fire(point: str, **ctx):
    """Hot-path entry: no-op unless a plane is installed.  Call sites gate
    on `faults.ENABLED` first so the disabled cost is a single branch."""
    p = _plane
    if p is not None:
        p.fire(point, **ctx)


def install_from_spec(spec: dict) -> FaultPlane:
    """Enable injection from a JSON-able spec — the cross-process chaos
    channel (a parent puts the spec in the GK_CHAOS env var; the fleet
    replica runtime installs it at entry)::

        {"seed": 7, "rules": [{"point": "fleet.replica_crash",
                               "mode": "error", "after": 20, "count": 1}]}

    Rule fields map 1:1 onto FaultRule; unknown fields are rejected by
    the dataclass so a typo'd spec fails loudly at install time."""
    plane = install(seed=int(spec.get("seed", 0)))
    for r in spec.get("rules", ()):
        r = dict(r)
        point = r.pop("point")
        plane.add(point, FaultRule(**r))
    return plane


__all__ = [
    "ALL_POINTS",
    "ENABLED",
    "ERROR",
    "EVLOOP_SLOW_CALLBACK",
    "EVLOOP_STALL",
    "FaultError",
    "FaultPlane",
    "FaultRule",
    "HANG",
    "KUBE_RECV",
    "KUBE_SEND",
    "LATENCY",
    "MESH_DISPATCH_STALL",
    "OVERLOAD_STORM",
    "PROFILER_STALL",
    "SLOW_CLIENT",
    "REPLICA_CRASH",
    "REPLICA_WEDGE",
    "SCRAPE_FAIL",
    "SNAPSHOT_CORRUPT",
    "SNAPSHOT_LOAD",
    "SNAPSHOT_RESYNC",
    "SNAPSHOT_WRITE",
    "TPU_COMPILE",
    "TPU_DISPATCH",
    "WATCH_DELIVER",
    "WEBHOOK_ENQUEUE",
    "fire",
    "get_plane",
    "install",
    "install_from_spec",
    "uninstall",
]
