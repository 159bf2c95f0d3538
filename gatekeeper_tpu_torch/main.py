"""Process entry point and wiring (reference main.go).

Flag surface mirrors the reference's ~25 process flags (main.go:82-93 plus
the per-package flags); `App` performs setupControllers' construction order
(main.go:198-294): cert bootstrap gate -> engine client -> watch manager +
readiness tracker -> controllers -> webhook / audit by operation role ->
metrics exporter -> health endpoints.

Run standalone:  python -m gatekeeper_tpu_torch [flags]
The API store is selected by --api-server: in-cluster service-account or
kubeconfig auth over HTTPS (kube/http_client.py HttpKube — the real-cluster
client), an explicit URL, or the in-memory store (kube/inmem.py) for
standalone/dev runs.  Any object implementing the same surface plugs into
`App(kube=...)`.
"""

from __future__ import annotations

import argparse
import os
import sys
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional

from . import logging as gklog
from . import operations as ops_mod
from .apis import status as status_api
from .audit import AuditManager

# cert rotation needs the `cryptography` package; a fleet replica running
# behind a TLS-terminating front door (or a dev/bench process) must still
# be able to come up without it.  The import is gated, and App degrades
# with an explicit warning when rotation is requested but unavailable —
# never silently.
try:
    from .certs import CertRotator
except ImportError:  # pragma: no cover - environment-dependent
    CertRotator = None  # type: ignore[assignment]
from .client.client import Client
from .client.drivers import InterpDriver
from .controllers import Dependencies, Manager
from .kube.inmem import InMemoryKube
from .metrics import MetricsExporter, Reporters
from .process.excluder import Excluder
from .readiness.tracker import Tracker
from .upgrade import UpgradeManager
from .util import (
    close_listener, get_id, get_namespace, replica_id, set_replica_id,
)
from .webhook import (
    MicroBatcher,
    NamespaceLabelHandler,
    ValidationHandler,
    WebhookServer,
)

log = gklog.get("main")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="gatekeeper-tpu-torch",
        description="policy controller (gatekeeper-class) on a CUDA card, "
                    "the PyTorch port",
    )
    # main.go:83-92
    p.add_argument("--log-level", default="INFO")
    p.add_argument("--health-addr", default=":9090",
                   help="address for the health endpoint")
    p.add_argument("--port", type=int, default=8443,
                   help="webhook server port")
    p.add_argument("--cert-dir", default="/tmp/gatekeeper-certs")
    p.add_argument("--disable-cert-rotation", action="store_true")
    p.add_argument("--enable-pprof", action="store_true")
    p.add_argument("--pprof-port", type=int, default=6060)
    # flags of the JAX package whose machinery the port does not have
    # yet: kept so a deployment's flag set still parses, refused at
    # construction when given (refuse_unported_flags)
    p.add_argument("--jax-profile-port", type=int, default=0,
                   help="not supported by the port: any value but 0 is "
                        "refused (ROADMAP A8; PyTorch has no counterpart "
                        "of jax.profiler.start_server)")
    p.add_argument("--xla-cache-dir", default="",
                   help="the kernels' build cache: the CUDA libraries are "
                        "built into and loaded from DIR/torch_kernels, "
                        "each sealed (util/seal.py), so a restarted pod "
                        "runs no nvcc; a library whose seal fails is "
                        "rebuilt, never loaded (empty = build/torch_kernels "
                        "beside the package).  $GK_XLA_CACHE, which the "
                        "JAX package reads, is not read")
    # operations.go:77
    p.add_argument("--operation", action="append", default=[],
                   choices=list(ops_mod.ALL_OPERATIONS),
                   help="operation roles for this process (repeatable; "
                        "default all)")
    # fleet serving (docs/fleet.md): per-replica identity for metrics,
    # spans, SLO payloads and logs
    p.add_argument("--replica-id",
                   default=os.environ.get("GK_REPLICA_ID", ""),
                   help="fleet replica id stamped into telemetry "
                        "(metrics label, root-span attr, /statusz); "
                        "empty = not part of a fleet")
    # metrics exporter.go:14-15
    p.add_argument("--metrics-backend", default="Prometheus")
    p.add_argument("--prometheus-port", type=int, default=8888)
    # main.go:84-87
    p.add_argument("--log-level-key", default="level",
                   help="JSON key for the log level field")
    p.add_argument("--log-level-encoder", default="lower",
                   choices=["lower", "capital", "color", "capitalcolor"])
    p.add_argument("--metrics-addr", default="0",
                   help="additional address to serve the metrics endpoint "
                        "on ('0' disables; main.go:87)")
    # controller.go:40
    p.add_argument("--debug-use-fake-pod", action="store_true",
                   help="use a fake pod identity so the process can run "
                        "outside of Kubernetes")
    # webhook policy.go:74-76, namespacelabel.go:25
    p.add_argument("--log-denies", action="store_true")
    p.add_argument("--emit-admission-events", action="store_true")
    p.add_argument("--disable-enforcementaction-validation",
                   action="store_true")
    p.add_argument("--exempt-namespace", action="append", default=[],
                   help="namespaces allowed to set the ignore label "
                        "(repeatable)")
    # audit manager.go:48-53
    p.add_argument("--audit-interval", type=float, default=60.0)
    p.add_argument("--constraint-violations-limit", type=int, default=20)
    p.add_argument("--audit-chunk-size", type=int, default=0)
    p.add_argument("--audit-from-cache", action="store_true")
    p.add_argument("--emit-audit-events", action="store_true")
    p.add_argument("--audit-match-kind-only", action="store_true")
    # which evaluation backend, and the device it runs on
    p.add_argument("--driver", choices=["interp", "torch"], default="torch",
                   help="evaluation backend (torch = TorchDriver, the "
                        "hand-written CUDA kernels)")
    p.add_argument("--torch-device", default="cuda",
                   help="device of the torch driver: 'cuda' (the default; "
                        "construction fails without a card) or 'cpu' (the "
                        "kernels' plain PyTorch versions, for tests)")
    p.add_argument("--sync-compile", action="store_true",
                   help="accepted for the JAX package's flag set: the port "
                        "always builds its kernels synchronously, when the "
                        "driver is constructed")
    p.add_argument("--webhook-batch-window-ms", type=float, default=2.0,
                   help="micro-batching window for admission reviews")
    p.add_argument("--webhook-batch-max-deadline-ms", type=float,
                   default=25.0,
                   help="ceiling on the load-adaptive batcher's flush "
                        "deadline under saturating load (docs/fleet.md)")
    p.add_argument("--webhook-batch-static", action="store_true",
                   help="disable the load-adaptive batch controller and "
                        "keep the fixed recent-concurrency window")
    # overload robustness (docs/failure-modes.md)
    p.add_argument("--webhook-max-pending", type=int, default=1024,
                   help="bound on the micro-batcher's pending queue; "
                        "past it, dry-run admissions shed first, then "
                        "new arrivals, each as an explicit fail-open/"
                        "closed decision (0 = unbounded)")
    p.add_argument("--brownout-disable", action="store_true",
                   help="disable the brownout ladder (sustained-overload "
                        "degradation: audit/snapshot deferral, reduced "
                        "telemetry, throughput-pinned routing)")
    # black-box flight recorder (docs/observability.md)
    p.add_argument("--flightrec-dir",
                   default=os.environ.get("GK_FLIGHTREC_DIR", ""),
                   help="directory for black-box flight-recorder dumps "
                        "(breaker-open, SLO page, process death, "
                        "/debug/flightrecz?dump=1); empty keeps the "
                        "in-memory ring only")
    def env_flightrec_size() -> int:
        # defensive parse (the $GK_PROFILER_HZ lesson): a typo'd env
        # value must not kill every process at parser build
        raw = os.environ.get("GK_FLIGHTREC_SIZE", "512")
        try:
            return int(raw)
        except ValueError:
            log.warning("GK_FLIGHTREC_SIZE=%r is not an integer; "
                        "using 512", raw)
            return 512

    p.add_argument("--flightrec-size", type=int,
                   default=env_flightrec_size(),
                   help="bounded flight-recorder event ring size")
    # decision log (docs/decision-logs.md): durable verdict
    # provenance — admission verdicts + audit violation transitions
    # flushed into NDJSON segments under a (fleet-shared) directory
    p.add_argument("--decision-log-dir",
                   default=os.environ.get("GK_DECISION_LOG_DIR", ""),
                   help="directory for decision-log segments (per-replica "
                        "files under a shared fleet dir); empty keeps the "
                        "in-memory /debug/decisionz ring only")
    p.add_argument("--decision-log-sample-rate", type=float, default=1.0,
                   help="head-sampling rate for ALLOW verdicts; denials, "
                        "sheds, expiries, errors, degraded-route and slow "
                        "decisions are always kept")
    p.add_argument("--decision-log-seal", action="store_true",
                   help="HMAC-chain every record under the shared seal "
                        "key (util/seal.py GK_SEAL_KEY) for tamper "
                        "evidence; verified by tools/replay_decisions.py")
    p.add_argument("--decision-log-retain", type=int, default=16,
                   help="completed decision segments kept per replica "
                        "(oldest pruned after each rotation)")
    p.add_argument("--decision-log-mask", action="append", default=[],
                   help="dot-path masked out of each record before "
                        "serialization (repeatable; e.g. "
                        "request.userInfo) — masked records are skipped "
                        "by differential replay")
    p.add_argument("--decision-log-disable", action="store_true",
                   help="disable decision recording entirely (the "
                        "/debug/decisionz ring included)")
    # graceful degradation (docs/failure-modes.md)
    p.add_argument("--admission-deadline-budget-ms", type=float, default=0.0,
                   help="per-request admission deadline budget in ms; work "
                        "past the budget yields an explicit fail-open/"
                        "closed decision instead of a socket timeout "
                        "(0 disables)")
    p.add_argument("--admission-fail-open", action="store_true",
                   help="on internal error or deadline exhaustion, ALLOW "
                        "the request with an audit annotation instead of "
                        "denying (default: fail closed)")
    p.add_argument("--breaker-failure-threshold", type=int, default=None,
                   help="not supported by the port (it has no circuit "
                        "breaker): refused when given (ROADMAP A6)")
    p.add_argument("--breaker-cooldown-s", type=float, default=None,
                   help="not supported by the port (it has no circuit "
                        "breaker): refused when given (ROADMAP A6)")
    p.add_argument("--mesh-watchdog-s", type=float,
                   default=float(os.environ.get("GK_MESH_WATCHDOG_S", "30")),
                   help="budget for one mesh-collective audit dispatch; a "
                        "dispatch exceeding it is abandoned, the breaker "
                        "trips, and the sweep re-shards one step narrower "
                        "(0 disables the watchdog; docs/failure-modes.md)")
    # observability (docs/tracing.md): always-on tracing knobs
    p.add_argument("--trace-buffer-size", type=int, default=256,
                   help="completed traces retained for /debug/traces")
    p.add_argument("--slow-trace-threshold-ms", type=float, default=250.0,
                   help="log any trace slower than this with its full "
                        "stage breakdown (0 disables the slow sampler)")
    p.add_argument("--trace-sample-rate", type=float, default=1.0,
                   help="fraction of completed traces retained in the "
                        "/debug/traces ring (slow traces always retained)")
    # always-on sampling profiler (docs/tracing.md); the env
    # default is parsed defensively — a typo'd GK_PROFILER_HZ must not
    # kill every process that builds this parser
    from .obs.profiler import env_hz

    p.add_argument("--profiler-hz", type=float, default=env_hz(),
                   help="sampling rate of the always-on stack profiler "
                        "serving /debug/profilez (0 disables; bounded, "
                        "span-stage-correlated, <5%% overhead budget)")
    # cost attribution + SLO engine (docs/slo.md)
    p.add_argument("--cost-top-k", type=int, default=20,
                   help="templates exported individually by the cost "
                        "ledger (gatekeeper_cost_* metrics and "
                        "/debug/costs); the rest roll up into 'other'")
    p.add_argument("--slo-admission-latency-ms", type=float, default=100.0,
                   help="admission latency SLO threshold: a request "
                        "answered slower than this consumes error budget")
    p.add_argument("--slo-admission-target", type=float, default=0.999,
                   help="admission latency SLO objective (fraction of "
                        "requests within the threshold)")
    p.add_argument("--slo-error-rate-target", type=float, default=0.999,
                   help="fail-closed error-rate SLO objective (fraction "
                        "of requests not answered by the error path)")
    p.add_argument("--slo-audit-max-age-s", type=float, default=0.0,
                   help="audit freshness SLO: maximum age of the last "
                        "successful sweep (0 = 5x --audit-interval)")
    p.add_argument("--slo-trip-breaker", action="store_true",
                   help="not supported by the port (it has no circuit "
                        "breaker): refused when given (ROADMAP A6)")
    # state snapshot & warm resume (docs/snapshots.md)
    p.add_argument("--snapshot-dir", default="",
                   help="directory for serving-state snapshots: a restart "
                        "restores the packed inventory and delta-resyncs "
                        "from the recorded resourceVersions instead of "
                        "paying the full relist+repack cold sweep, and its "
                        "delta basis goes back onto the card (empty = "
                        "disabled).  $GK_SNAPSHOT_DIR, which the JAX "
                        "package reads, is not read")
    p.add_argument("--snapshot-interval", type=float, default=300.0,
                   help="minimum seconds between background snapshots "
                        "(each completed audit sweep re-arms the writer)")
    p.add_argument("--snapshot-retain", type=int, default=3,
                   help="completed snapshots kept on disk (older ones "
                        "are pruned after each write)")
    p.add_argument("--snapshot-disable", action="store_true",
                   help="keep --snapshot-dir configured but skip both the "
                        "startup restore and the background writer")
    p.add_argument("--snapshot-no-resync", action="store_true",
                   help="restore the snapshot WITHOUT the resourceVersion "
                        "delta resync against the API store.  For fleet "
                        "webhook replicas adopting a shared warm snapshot "
                        "whose pack they do not own: the watch replay "
                        "still reconciles the store afterwards "
                        "(docs/fleet.md)")
    p.add_argument("--fault-plane-seed", type=int, default=None,
                   help="EXPLICITLY enable the fault-injection plane with "
                        "this seed (testing only; add schedules via "
                        "gatekeeper_tpu_torch.faults).  Leave unset in "
                        "production: the plane then costs one branch")
    # API-server selection (rest.InClusterConfig / kubeconfig in the
    # reference's manager construction, main.go:140-151)
    p.add_argument("--api-server", default="auto",
                   help="API store: 'auto' (in-cluster, else $KUBECONFIG, "
                        "else in-memory), 'inmem', 'in-cluster', "
                        "'kubeconfig', or an explicit https:// URL")
    return p


#: flags whose machinery the port does not have yet: (flag, whether the
#: parsed arguments give it, the ROADMAP item that brings it)
UNPORTED_FLAGS = (
    ("--jax-profile-port", lambda a: bool(getattr(a, "jax_profile_port", 0)),
     "A8 (a device profiler hook)"),
    ("--breaker-failure-threshold",
     lambda a: getattr(a, "breaker_failure_threshold", None) is not None,
     "A6 (the breaker)"),
    ("--breaker-cooldown-s",
     lambda a: getattr(a, "breaker_cooldown_s", None) is not None,
     "A6 (the breaker)"),
    ("--slo-trip-breaker", lambda a: bool(getattr(a, "slo_trip_breaker", 0)),
     "A6 (the breaker)"),
)


def refuse_unported_flags(args):
    """Raise for a flag whose machinery the port does not have yet: a
    process must never start while silently ignoring one."""
    for flag, given, item in UNPORTED_FLAGS:
        if given(args):
            raise ValueError(
                f"{flag} is not supported by gatekeeper_tpu_torch yet: "
                f"ROADMAP {item}"
            )


def make_kube(spec: str = "auto"):
    """Resolve the --api-server flag to a kube client."""
    from .kube.http_client import HttpKube

    if spec == "inmem":
        return InMemoryKube()
    if spec == "in-cluster":
        return HttpKube.in_cluster()
    if spec == "kubeconfig":
        return HttpKube.from_kubeconfig()
    if spec.startswith(("http://", "https://")):
        return HttpKube(spec)
    if spec != "auto":
        # a typo must not silently fall back to the in-memory store — the
        # process would report healthy while enforcing nothing
        raise ValueError(f"unrecognized --api-server value: {spec!r}")
    # auto: prefer in-cluster, then kubeconfig, then in-memory
    import os

    if os.environ.get("KUBERNETES_SERVICE_HOST"):
        return HttpKube.in_cluster()
    kc = os.environ.get("KUBECONFIG")
    if kc and os.path.exists(kc):
        return HttpKube.from_kubeconfig(kc)
    log.warning("no cluster detected; using the in-memory API store")
    return InMemoryKube()


def make_event_recorder(kube: InMemoryKube, component: str):
    """K8s Event emission (the reference's record.EventRecorder)."""

    def record(event: dict):
        obj = {
            "apiVersion": "v1",
            "kind": "Event",
            "metadata": {
                "name": f"gatekeeper-{uuid.uuid4().hex[:12]}",
                "namespace": event.get("namespace", get_namespace()),
                "annotations": event.get("annotations") or {},
            },
            "type": event.get("type", "Warning"),
            "reason": event.get("reason", ""),
            "message": event.get("message", ""),
            "source": {"component": component},
        }
        try:
            kube.create(obj)
        except Exception:
            log.exception("failed to record event")

    return record


class HealthServer:
    """Standalone /healthz + /readyz listener (main.go:193-196) for pods
    that don't run the webhook server."""

    def __init__(self, port: int, readiness_check=None):
        self.port = port
        self.readiness_check = readiness_check
        self._server: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    def start(self):
        # idempotent: a double start replaces the previous listener
        # instead of leaking its thread and socket (the
        # WebhookServer.start / MetricsExporter.start contract)
        close_listener(self._server, self._thread)
        self._server = None
        self._thread = None
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):
                pass

            def do_GET(self):
                if self.path == "/healthz":
                    code, body = 200, b"ok"
                elif self.path == "/readyz":
                    ready = (
                        outer.readiness_check()
                        if outer.readiness_check else True
                    )
                    code, body = (200, b"ok") if ready else (500, b"not ready")
                else:
                    code, body = 404, b"not found"
                self.send_response(code)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self._server = ThreadingHTTPServer(("0.0.0.0", self.port), Handler)
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="health", daemon=True
        )
        self._thread.start()

    def stop(self):
        close_listener(self._server, self._thread)
        self._server = None
        self._thread = None


class ProfileServer:
    """--enable-pprof analogue (main.go:91-92,113-119): a debug listener
    with thread stack dumps and GC stats in place of Go's net/http/pprof."""

    def __init__(self, port: int = 6060):
        self.port = port
        self._server: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    def start(self):
        # idempotent, like HealthServer.start (no leaked listener thread
        # or socket on a double start)
        close_listener(self._server, self._thread)
        self._server = None
        self._thread = None

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *args):
                pass

            def do_GET(self):
                import gc
                import traceback

                if self.path.startswith("/debug/pprof"):
                    frames = sys._current_frames()
                    lines = []
                    for t in threading.enumerate():
                        frame = frames.get(t.ident)
                        lines.append(f"--- thread {t.name} ({t.ident}) ---")
                        if frame:
                            lines.extend(
                                s.rstrip()
                                for s in traceback.format_stack(frame)
                            )
                    lines.append(f"--- gc ---\n{gc.get_stats()}")
                    body = "\n".join(lines).encode()
                    code = 200
                else:
                    body, code = b"not found", 404
                self.send_response(code)
                self.send_header("Content-Type", "text/plain")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self._server = ThreadingHTTPServer(("0.0.0.0", self.port), Handler)
        self.port = self._server.server_address[1]
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="pprof", daemon=True
        )
        self._thread.start()

    def stop(self):
        close_listener(self._server, self._thread)
        self._server = None
        self._thread = None


class App:
    """The composed process (main.go main + setupControllers)."""

    def __init__(self, args=None, kube: Optional[InMemoryKube] = None):
        if args is None or isinstance(args, list):
            args = build_parser().parse_args(args or [])
        self.args = args
        refuse_unported_flags(args)
        gklog.setup(
            args.log_level,
            level_key=getattr(args, "log_level_key", "level"),
            level_encoder=getattr(args, "log_level_encoder", "lower"),
        )
        if getattr(args, "xla_cache_dir", ""):
            from .device import use_cache_dir

            # the kernels' sealed build cache rides in a subdir, as the
            # JAX package's executables ride in <dir>/aot: the torch
            # driver below loads its libraries from there (nvcc only for
            # a missing library or one whose seal fails)
            use_cache_dir(os.path.join(args.xla_cache_dir, "torch_kernels"))
        if getattr(args, "debug_use_fake_pod", False):
            # run outside Kubernetes: fixed pod identity, no owner refs on
            # status CRs (controller.go:133-142)
            os.environ["POD_NAME"] = "no-pod"
            status_api.disable_pod_ownership()
        self.kube = kube if kube is not None else make_kube(
            getattr(args, "api_server", "inmem"))
        self.operations = ops_mod.Operations(args.operation or None)
        # fleet identity: stamped into root spans, the replica-labelled
        # metric series and the SLO /statusz payload (docs/fleet.md)
        set_replica_id(getattr(args, "replica_id", "") or "")
        self.reporters = Reporters()
        from .obs import trace as obstrace

        obstrace.configure(
            buffer_size=getattr(args, "trace_buffer_size", 256),
            slow_threshold_s=(
                getattr(args, "slow_trace_threshold_ms", 250.0) / 1000.0
            ),
            sample_rate=getattr(args, "trace_sample_rate", 1.0),
        )
        # cost attribution + SLO engine (docs/slo.md): configure the
        # process-global ledger/engine the driver and webhook feed
        from .obs import costs as obscosts
        from .obs import slo as obsslo

        obscosts.configure(top_k=getattr(args, "cost_top_k", 20))
        audit_max_age = getattr(args, "slo_audit_max_age_s", 0.0) or (
            5.0 * getattr(args, "audit_interval", 60.0)
        )
        obsslo.configure(
            admission_threshold_ms=getattr(
                args, "slo_admission_latency_ms", 100.0),
            admission_target=getattr(args, "slo_admission_target", 0.999),
            error_target=getattr(args, "slo_error_rate_target", 0.999),
            audit_max_age_s=audit_max_age,
            # a webhook-only pod never runs a sweep: its freshness probe
            # must not latch the degraded marker forever
            audit_expected=self.operations.is_assigned(ops_mod.AUDIT),
        )
        self._collect_hooks = [obscosts.collect_hook, obsslo.collect_hook]

        if getattr(args, "fault_plane_seed", None) is not None:
            from . import faults

            faults.install(seed=args.fault_plane_seed)
            log.warning(
                "fault-injection plane ENABLED (seed=%d) — testing only",
                args.fault_plane_seed,
            )

        # evaluation backend behind the Driver seam
        if args.driver == "torch":
            from .ops.driver import TorchDriver

            # the card unless --torch-device cpu: construction raises
            # without one, and loads the kernels (nvcc runs here, never
            # inside an admission request's deadline)
            driver = TorchDriver(
                device=getattr(args, "torch_device", "cuda"),
                mesh_watchdog_s=getattr(args, "mesh_watchdog_s", None),
            )
        else:
            driver = InterpDriver()
        self.client = Client(driver=driver)

        self.excluder = Excluder()
        self.tracker = Tracker()
        self.rotator = None
        if not args.disable_cert_rotation:
            if CertRotator is None:
                # the gated import above: never silent — a replica that
                # cannot rotate serves externally-provided certs from
                # --cert-dir or plain HTTP behind a TLS-terminating
                # front door (docs/fleet.md trust model)
                log.warning(
                    "cert rotation requested but the 'cryptography' "
                    "package is unavailable; continuing without rotation "
                    "(provide certs in --cert-dir or terminate TLS "
                    "upstream)"
                )
            else:
                self.rotator = CertRotator(self.kube)

        self.manager = Manager(
            Dependencies(
                kube=self.kube,
                client=self.client,
                excluder=self.excluder,
                tracker=self.tracker,
                operations=self.operations,
                pod_id=get_id(),
                namespace=get_namespace(),
                reporter=self.reporters,
            )
        )
        self.upgrade = UpgradeManager(self.kube)
        self.webhook_server: Optional[WebhookServer] = None
        self.health_server: Optional[HealthServer] = None
        self.audit_manager: Optional[AuditManager] = None
        self.metrics_exporter: Optional[MetricsExporter] = None
        self.metrics_addr_exporter: Optional[MetricsExporter] = None
        self.micro_batcher: Optional[MicroBatcher] = None
        self.profile_server: Optional[ProfileServer] = None
        self.snapshotter = None
        self.snapshot_restore_outcome = "none"
        self._stopping = False

    def start(self):
        args = self.args
        # nothing serves, and /readyz never reports ready, before the
        # backend's kernels are loaded; a failed build fails start
        wait_ready = getattr(self.client.driver, "wait_ready", None)
        if wait_ready is not None and not wait_ready(timeout=None):
            raise RuntimeError("the evaluation backend is not ready")
        self._stopping = False  # a stopped App may be restarted
        from .ops.deltasweep import BG_STOP

        BG_STOP.clear()  # re-arm background workers after a stop()
        # black-box flight recorder FIRST: the snapshot restore below and
        # every later subsystem may record incident events; with a dump
        # dir configured the process-death hook (atexit + chained
        # SIGTERM) makes a crash leave one ordered artifact behind
        from .obs import flightrec

        flightrec.get_recorder().configure(
            dump_dir=getattr(args, "flightrec_dir", "") or None,
            maxlen=getattr(args, "flightrec_size", None),
        )
        if getattr(args, "flightrec_dir", ""):
            flightrec.get_recorder().install_exit_hook()
        # decision log (obs/decisionlog.py, docs/decision-logs.md):
        # verdict provenance recording starts before the webhook serves
        # so the very first admission decision is archived
        from .obs import decisionlog as obsdlog

        # empty dir DETACHES (configure: dir="" -> None, dir=None ->
        # unchanged): the recorder is process-global, so an App started
        # without the flag must not inherit a prior run's archive dir
        dlog = obsdlog.get_log().configure(
            dir=getattr(args, "decision_log_dir", ""),
            sample_rate=getattr(args, "decision_log_sample_rate", 1.0),
            seal=getattr(args, "decision_log_seal", False),
            retain=getattr(args, "decision_log_retain", 16),
            mask_fields=getattr(args, "decision_log_mask", []) or [],
        )
        dlog.record_enabled = not getattr(
            args, "decision_log_disable", False)
        if dlog.record_enabled:
            dlog.start()
        # cert bootstrap gates everything (main.go:219-220); write_cert_files
        # runs ensure_certs synchronously, so readiness is set before start()
        # spins the refresh thread
        certfile = keyfile = None
        if self.rotator is None:
            # rotation disabled: serve externally-provided certs from
            # --cert-dir (the reference's --disable-cert-rotation contract)
            import os

            cf = os.path.join(args.cert_dir, "tls.crt")
            kf = os.path.join(args.cert_dir, "tls.key")
            if os.path.exists(cf) and os.path.exists(kf):
                certfile, keyfile = cf, kf
            else:
                log.warning(
                    "cert rotation disabled and no certs in %s: webhook "
                    "will serve PLAIN HTTP (apiserver admission requires "
                    "HTTPS)", args.cert_dir,
                )
        else:
            certfile, keyfile = self.rotator.write_cert_files(args.cert_dir)

            def _on_refresh(secret):
                cf, kf = self.rotator.write_cert_files(args.cert_dir, secret)
                if self.webhook_server is not None:
                    self.webhook_server.reload_certs(cf, kf)

            self.rotator.on_refresh = _on_refresh
            self.rotator.start()

        self.upgrade.upgrade()  # storage-version migration before controllers
        # warm resume BEFORE controllers start: the restored pack + interner
        # must be in place before watch replays repopulate the store (the
        # store's RV dedup then turns the replay into a delta resync), and
        # before the audit manager's first sweep consumes the restored pack
        snap_dir = getattr(args, "snapshot_dir", "")
        self.snapshot_restore_outcome = "none"
        if snap_dir and not getattr(args, "snapshot_disable", False):
            from .snapshot import SnapshotLoader, Snapshotter

            try:
                outcome = SnapshotLoader(snap_dir).restore(
                    self.client, self.kube, excluder=self.excluder,
                    resync=not getattr(args, "snapshot_no_resync", False),
                )
                self.snapshot_restore_outcome = outcome
                log.info("snapshot restore outcome: %s", outcome)
            except Exception:
                # restore guards internally; this is the belt over those
                # braces — a persistence defect must never block startup
                log.exception("snapshot restore failed; cold start")
            # only the audit role ARMS the background writer: snapshots
            # capture the packed audit state right after a sweep, which
            # only that role produces.  A webhook-only fleet replica is a
            # read-mostly consumer of the shared snapshot dir — it must
            # never write to (or prune) warmth other replicas restore
            # from (docs/fleet.md)
            if self.operations.is_assigned(ops_mod.AUDIT):
                self.snapshotter = Snapshotter(
                    self.client, snap_dir,
                    interval_s=getattr(args, "snapshot_interval", 300.0),
                    retain=getattr(args, "snapshot_retain", 3),
                )
                self.snapshotter.start()
        elif snap_dir:
            from .metrics.catalog import record_snapshot_outcome

            record_snapshot_outcome("disabled")
        self.tracker.run(self.kube)
        # warm resume keeps the restored engine state: the controllers'
        # boot reset would wipe the pack the loader just installed, and
        # the watch replay's RV/content dedup reconciles the store against
        # it as a delta resync instead (docs/snapshots.md, docs/fleet.md)
        self.manager.start(
            reset=self.snapshot_restore_outcome != "restored"
        )

        # degradation visibility: breaker state (TPU driver only) plus the
        # SLO engine's burn-rate status for /healthz + /statusz
        from .obs import slo as obsslo

        breaker_fn = getattr(self.client.driver, "breaker_status", None)
        slo_engine = obsslo.get_engine()
        from .obs import brownout as obsbrownout

        brownout_ctl = obsbrownout.get_controller()

        def health_status():
            st = {"slo": slo_engine.evaluate(),
                  "brownout": brownout_ctl.status()}
            if breaker_fn is not None:
                st["tpu_breaker"] = breaker_fn()
            return st

        if getattr(args, "slo_trip_breaker", False):
            breaker = getattr(self.client.driver, "breaker", None)
            if breaker is not None:
                def _slo_trip(name, pair, _breaker=breaker):
                    # the opt-in degradation signal: a fast burn on
                    # admission latency degrades evaluation to the
                    # interpreter tier via the existing breaker ladder
                    if name == obsslo.ADMISSION_LATENCY and pair == "fast":
                        _breaker.trip()

                slo_engine.on_alert(_slo_trip)

        if self.operations.is_assigned(ops_mod.WEBHOOK):
            self.micro_batcher = MicroBatcher(
                self.client, window_s=args.webhook_batch_window_ms / 1000.0,
                adaptive=not getattr(args, "webhook_batch_static", False),
                max_deadline_s=getattr(
                    args, "webhook_batch_max_deadline_ms", 25.0) / 1000.0,
                max_pending=getattr(args, "webhook_max_pending", None),
            )
            handler = ValidationHandler(
                self.micro_batcher,
                kube=self.kube,
                excluder=self.excluder,
                reporter=self.reporters,
                gk_namespace=get_namespace(),
                log_denies=args.log_denies,
                emit_admission_events=args.emit_admission_events,
                disable_enforcementaction_validation=(
                    args.disable_enforcementaction_validation
                ),
                event_recorder=make_event_recorder(
                    self.kube, "gatekeeper-webhook"
                ),
                fail_open=getattr(args, "admission_fail_open", False),
            )
            budget_ms = getattr(args, "admission_deadline_budget_ms", 0.0)
            self.webhook_server = WebhookServer(
                handler,
                NamespaceLabelHandler(args.exempt_namespace),
                port=args.port,
                certfile=certfile,
                keyfile=keyfile,
                readiness_check=self.tracker.satisfied,
                deadline_budget_s=(budget_ms / 1000.0) or None,
                health_status=health_status,
            )
            self.webhook_server.start()
        else:
            health_port = int(args.health_addr.rsplit(":", 1)[-1] or 0)
            self.health_server = HealthServer(
                health_port, readiness_check=self.tracker.satisfied
            )
            self.health_server.start()

        if self.operations.is_assigned(ops_mod.AUDIT):
            self.audit_manager = AuditManager(
                self.kube,
                self.client,
                excluder=self.excluder,
                reporter=self.reporters,
                interval_s=args.audit_interval,
                violations_limit=args.constraint_violations_limit,
                chunk_size=args.audit_chunk_size,
                from_cache=args.audit_from_cache,
                match_kind_only=args.audit_match_kind_only,
                emit_audit_events=args.emit_audit_events,
                event_recorder=make_event_recorder(
                    self.kube, "gatekeeper-audit"
                ),
                gk_namespace=get_namespace(),
                snapshotter=self.snapshotter,
            )
            self.audit_manager.start()

        self.metrics_exporter = MetricsExporter(
            port=args.prometheus_port, registry=self.reporters.registry,
            collect_hooks=self._collect_hooks,
        )
        self.metrics_exporter.start()
        # --metrics-addr (main.go:87): an additional bind for the same
        # registry, matching the reference's controller-runtime endpoint
        addr = getattr(args, "metrics_addr", "0")
        if addr and addr != "0":
            host, _, port_s = addr.rpartition(":")
            try:
                port = int(port_s)
            except ValueError:
                raise SystemExit(
                    f"--metrics-addr: invalid port in {addr!r} "
                    "(expected [host]:port)"
                )
            self.metrics_addr_exporter = MetricsExporter(
                port=port, registry=self.reporters.registry,
                host=host.strip("[]") or "0.0.0.0",  # bracketed IPv6
                collect_hooks=self._collect_hooks,
            )
            self.metrics_addr_exporter.start()
        # always-on sampling profiler (obs/profiler.py): collapsed-stack
        # CPU profiles at /debug/profilez on BOTH debug surfaces, stage-
        # correlated via the tracer's thread registry.  The flag value
        # is ALWAYS propagated to the singleton — --profiler-hz 0 must
        # zero the import-time default too, or a later runtime command
        # could "resume" a profiler the operator explicitly disabled
        from .obs.profiler import get_profiler

        hz = getattr(args, "profiler_hz", 0.0) or 0.0
        get_profiler().configure(hz=hz)
        if hz > 0:
            get_profiler().start()
        if args.enable_pprof:
            self.profile_server = ProfileServer(args.pprof_port)
            self.profile_server.start()
        # brownout ladder (obs/brownout.py, docs/failure-modes.md): the
        # sustained-overload controller samples queue depth (the micro-
        # batcher), the shed rate (fed by every shed site through
        # record_shed) and the SLO burn flag; its actions are wired here
        # because only the App knows the baselines to RESTORE on recovery
        brownout_ctl.clear_actions()
        if not getattr(args, "brownout_disable", False):
            mb = self.micro_batcher

            def _queue_frac() -> float:
                if mb is None or not mb.max_pending:
                    return 0.0
                # a bare len() read: no lock — the signal is a trend,
                # not an invariant, and the sampler must never contend
                # with the enqueue path
                return len(mb._pending) / mb.max_pending

            brownout_ctl.set_providers(
                queue_frac=_queue_frac,
                slo_degraded=slo_engine.degraded,
            )
            base_sample = getattr(args, "trace_sample_rate", 1.0)
            base_hz = hz
            driver_pin = getattr(
                self.client.driver, "set_brownout_pin", None
            )

            def _apply(old: int, new: int):
                from .obs import trace as _obstrace

                # idempotent per threshold crossing; each rung is
                # reversible — stepping down restores the baseline
                if (new >= 2) != (old >= 2):
                    reduce = new >= 2
                    # min(): an operator-configured rate BELOW the
                    # brownout rate must never be raised by degradation
                    _obstrace.configure(
                        sample_rate=(min(base_sample, 0.05) if reduce
                                     else base_sample)
                    )
                    prof = get_profiler()
                    prof.configure(
                        hz=min(base_hz, 1.0) if reduce else base_hz
                    )
                if driver_pin is not None and (new >= 3) != (old >= 3):
                    driver_pin(new >= 3)

            brownout_ctl.on_change(_apply)
            # stop() restores the process-global tracer/profiler/pin
            # baselines even mid-brownout: _apply from the level held
            # at stop time down to 0 unwinds every threshold crossing
            self._brownout_restore = _apply
            brownout_ctl.start()
        else:
            self._brownout_restore = None
        self._start_routing_calibration()
        from .metrics.catalog import record_replica_up

        record_replica_up()
        log.info(
            "gatekeeper-tpu started",
            extra={"kv": {
                "operations": self.operations.assigned_string_list(),
                "driver": args.driver,
                "replica_id": replica_id(),
            }},
        )

    def _start_routing_calibration(self):
        """Background startup calibration of the driver's interp-vs-device
        routing cost model (TpuDriver.calibrate_routing): waits for the
        first templates to sync + compile, then measures once.  Retries a
        few times because an empty cluster has nothing to calibrate
        against yet."""
        driver = self.client.driver
        if not hasattr(driver, "calibrate_routing"):
            return  # interp driver
        if getattr(driver, "DEVICE_MIN_CELLS", 0) == 0:
            return  # forced-device configuration

        from .ops.deltasweep import BG_STOP

        def run():
            def stopped() -> bool:
                return self._stopping or BG_STOP.is_set()

            for _ in range(30):
                if stopped():
                    return
                try:
                    # the 30s ready-wait in interruptible 2s slices, so
                    # interpreter exit never stalls behind it
                    for _ in range(15):
                        if stopped():
                            return
                        if driver.wait_ready(timeout=2.0):
                            break
                    if driver.calibrate_routing() is not None:
                        cal = driver._route_cal
                        log.info(
                            "routing calibrated",
                            extra={"kv": {
                                k: round(v, 3) for k, v in cal.items()
                            }},
                        )
                        return
                except Exception:
                    log.exception("routing calibration attempt failed")
                if BG_STOP.wait(10.0):
                    return

        from .ops.deltasweep import spawn_bg

        spawn_bg("gk-route-cal", run)

    def stop(self):
        self._stopping = True
        # unblock the calibration loop's Event.wait promptly; restarts
        # re-arm it (BG_STOP is also set at interpreter exit)
        from .ops.deltasweep import BG_STOP

        BG_STOP.set()
        for component in (
            self.audit_manager,
            self.snapshotter,
            self.webhook_server,
            self.health_server,
            self.metrics_exporter,
            self.metrics_addr_exporter,
            self.micro_batcher,
            self.rotator,
            self.profile_server,
        ):
            if component is not None:
                component.stop()
        # unconditional: the sampler may have been enabled at RUNTIME
        # (the replica 'profiler' pipe command) on a process started
        # with --profiler-hz 0; stop() is idempotent and bounded
        from .obs.profiler import get_profiler

        get_profiler().stop()
        # the brownout sampler likewise (idempotent, bounded join); the
        # ladder resets so a restarted App starts at level 0, and a
        # stop mid-brownout RESTORES the degraded process-global state
        # (tracer sample rate, profiler hz, routing pin) — those
        # outlive this App, and "level 0" must mean undegraded
        from .obs import brownout as obsbrownout

        ctl = obsbrownout.get_controller()
        level_at_stop = ctl.level
        ctl.stop()
        ctl.reset()
        restore = getattr(self, "_brownout_restore", None)
        if restore is not None and level_at_stop > 0:
            try:
                restore(level_at_stop, 0)
            except Exception:
                log.exception("brownout baseline restore failed on stop")
        unpin = getattr(self.client.driver, "set_brownout_pin", None)
        if unpin is not None:
            unpin(False)  # defensive: also covers --brownout-disable
        # decision log: flush queued records and rotate the open segment
        # so a stopped process leaves no invisible .open tail behind
        from .obs import decisionlog as obsdlog

        obsdlog.get_log().stop()
        self.manager.stop()

    def run_forever(self):
        self.start()
        try:
            while True:
                time.sleep(3600)
        except KeyboardInterrupt:
            pass
        finally:
            self.stop()


def main(argv: Optional[List[str]] = None):
    App(build_parser().parse_args(argv)).run_forever()


if __name__ == "__main__":
    main()
