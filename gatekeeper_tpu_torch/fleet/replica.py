"""Webhook replica runtime + parent-side spawn helpers (docs/fleet.md).

Child entry point (``python -m gatekeeper_tpu_torch.fleet.replica``): builds a
webhook-ONLY :class:`gatekeeper_tpu_torch.main.App` (no audit manager, no
snapshot writer arming, no status writer — asserted by
tests/test_fleet.py) against the in-memory API store, restores the
shared HMAC-sealed snapshot WITHOUT the RV resync (``--snapshot-no-
resync``: the local store starts empty; the pack is adopted read-mostly)
and the shared AOT executable cache, then announces readiness as one
JSON line on stdout::

    {"event": "ready", "replica_id": ..., "port": ..., "ready_s": ...,
     "restore_outcome": ..., "templates": N}

and serves until stdin closes (the parent dropping its pipe is the stop
signal — no PID files, no signal races) or SIGTERM.

Self-healing additions (docs/failure-modes.md fleet matrix):
the command loop answers ``{"cmd": "ping"}`` (the supervisor's
command-pipe liveness heartbeat) and ``{"cmd": "drain", "deadline_ms"}``
(graceful drain: stop accepting admissions, flush the micro-batcher
within the budget, report ``drained``).  Commands carrying an ``"id"``
get it echoed as ``"reply_to"`` so the parent can demux concurrent
waiters (a supervisor heartbeat must not steal a bench stream's reply).
A ``GK_CHAOS`` env var (JSON ``faults.install_from_spec`` spec) installs
a seeded fault plane at entry; the ``fleet.replica_crash`` point is
pulsed on a background thread (an error-mode rule hard-exits the child,
rc 23) and ``fleet.replica_wedge`` fires in the command loop (a
hang-mode rule stops the pipe answering — exactly what a wedged replica
looks like to the supervisor).

``ready_s`` is measured in-process from runtime entry to the first
admission answered end to end over HTTP — the "warm replica is
device-ready in seconds" number the fleet bench records; the parent
additionally measures spawn-to-ready wall time (interpreter + import
cost included).

Parent side: :func:`spawn_replica` / :func:`spawn_fleet` start children,
wait for the ready line, and return :class:`ReplicaHandle` objects whose
``stop()`` closes stdin and reaps the process.  Used by ``bench.py
fleet`` and ``tools/check_fleet_parity.py``.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import queue
import signal
import subprocess
import sys
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Sequence

import logging

log = logging.getLogger("gatekeeper.fleet.replica")

REPO_ROOT = os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__))))


# ---- child runtime ---------------------------------------------------------


def _child_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="gatekeeper-tpu-replica")
    p.add_argument("--replica-id", required=True)
    p.add_argument("--port", type=int, default=0,
                   help="webhook port (0 = ephemeral, announced on stdout)")
    p.add_argument("--snapshot-dir", default="",
                   help="shared warm snapshot dir (restored, never written)")
    p.add_argument("--xla-cache-dir", default="",
                   help="shared sealed kernel cache dir (the CUDA "
                        "libraries load from DIR/torch_kernels, no nvcc)")
    p.add_argument("--driver", choices=["interp", "torch"], default="torch",
                   help="evaluation backend (torch = TorchDriver, the "
                        "hand-written CUDA kernels)")
    p.add_argument("--torch-device", default="cuda",
                   help="device of the torch driver: 'cuda' (the default; "
                        "the replica fails to start without a card) or "
                        "'cpu' (the kernels' plain PyTorch versions, for "
                        "tests)")
    p.add_argument("--webhook-batch-static", action="store_true")
    p.add_argument("--webhook-max-pending", type=int, default=None,
                   help="micro-batcher pending bound passed through to "
                        "the App (overload harnesses set it small to "
                        "force sheds; default: the App's default)")
    p.add_argument("--admission-fail-open", action="store_true",
                   help="fail open on deadline/overload refusals "
                        "(passed through to the App)")
    p.add_argument("--brownout-disable", action="store_true",
                   help="disable the brownout ladder (passed through to "
                        "the App)")
    p.add_argument("--no-seed-namespaces", action="store_true",
                   help="do not create Namespace objects for restored "
                        "pack rows in the local in-memory store")
    p.add_argument("--decision-log-dir", default="",
                   help="shared fleet decision-log directory "
                        "(docs/decision-logs.md): each replica writes "
                        "its own decisions-<replica_id>-* segments; "
                        "also inherited via $GK_DECISION_LOG_DIR")
    return p


def _seed_namespaces(app) -> int:
    """Standalone (in-memory store) replicas: admission of a namespaced
    object requires its Namespace in the store (ValidationHandler's
    augmentation lookup).  A real cluster syncs them via the watch; here
    they are seeded from the restored pack's rows."""
    ap = getattr(app.client.driver, "_audit_pack", None)
    if ap is None:
        return 0
    names = set()
    for rv in getattr(ap, "reviews", ()) or ():
        if not isinstance(rv, dict):
            continue
        obj = rv.get("object")
        if isinstance(obj, dict):
            ns = (obj.get("metadata") or {}).get("namespace")
            if ns:
                names.add(ns)
    n = 0
    for ns in sorted(names):
        try:
            app.kube.create({
                "apiVersion": "v1", "kind": "Namespace",
                "metadata": {"name": ns},
            })
            n += 1
        except Exception:
            # already present (Conflict from the in-memory store, a 409
            # from an HTTP kube) — anything else is still non-fatal for
            # serving, but must not vanish silently
            log.debug("namespace seed skipped for %r", ns, exc_info=True)
    return n


def _probe_request() -> dict:
    """The ready probe's admission request."""
    return {
        "uid": "replica-ready-probe",
        "kind": {"group": "", "version": "v1", "kind": "Namespace"},
        "name": "gk-replica-probe", "namespace": "",
        "operation": "CREATE",
        "userInfo": {"username": "replica-probe"},
        "object": {"apiVersion": "v1", "kind": "Namespace",
                   "metadata": {"name": "gk-replica-probe", "labels": {}}},
    }


def _probe_ready(port: int, timeout_s: float = 120.0) -> None:
    """One end-to-end admission over HTTP against our own server: the
    replica is 'device-ready' when a review ANSWERS, not merely when the
    listener binds."""
    import http.client

    body = json.dumps({"request": _probe_request()}).encode()
    deadline = time.monotonic() + timeout_s
    last: Optional[Exception] = None
    while time.monotonic() < deadline:
        try:
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
            conn.request("POST", "/v1/admit", body=body,
                         headers={"Content-Type": "application/json"})
            resp = conn.getresponse()
            data = resp.read()
            conn.close()
            if resp.status == 200 and b"response" in data:
                return
            last = RuntimeError(f"probe status {resp.status}")
        except Exception as e:  # listener not up yet
            last = e
        time.sleep(0.05)
    raise TimeoutError(f"replica never became ready: {last!r}")


def _stream_requests(app, k: int = 4096) -> List[dict]:
    """k admission requests cycled from the restored pack's objects (the
    bench.py batch1m shape: a bounded unique set streamed in chunks)."""
    objs = []
    ap = getattr(app.client.driver, "_audit_pack", None)
    for rv in (getattr(ap, "reviews", ()) or ()):
        if isinstance(rv, dict) and isinstance(rv.get("object"), dict):
            objs.append(rv["object"])
        if len(objs) >= k:
            break
    if not objs:  # cold replica: synthesize something admissible
        objs = [{
            "apiVersion": "v1", "kind": "Namespace",
            "metadata": {"name": f"gk-stream-{i}", "labels": {}},
        } for i in range(min(k, 256))]
    reqs = []
    for i, obj in enumerate(objs):
        kind = obj.get("kind", "Namespace")
        md = obj.get("metadata") or {}
        reqs.append({
            "uid": f"stream-{i}",
            "kind": {"group": "", "version": "v1", "kind": kind},
            "name": md.get("name", f"o{i}"),
            "namespace": md.get("namespace", ""),
            "operation": "CREATE",
            "userInfo": {"username": "fleet-bench"},
            "object": obj,
        })
    return reqs


def _stream_bench(app, n: int, chunk: int, replica_id: str) -> Dict:
    """In-process chunked review_batch stream (the bench.py batch1m
    shape) against THIS replica's restored engine: per-replica saturated
    throughput without the HTTP framing cost, which the fleet bench's
    latency phase measures separately through the front door."""
    reqs = _stream_requests(app)
    driver = app.client.driver

    def batch_of(start: int, size: int) -> List[dict]:
        return [reqs[(start + j) % len(reqs)] for j in range(size)]

    # warm with the exact chunk shapes the timed loop dispatches
    driver.review_batch(batch_of(0, min(chunk, n)))
    tail = n % chunk
    if tail and n > chunk:
        driver.review_batch(batch_of(0, tail))
    # wall-clock stamps so the PARENT can compute the true overlapping
    # window across replicas (per-process monotonic clocks don't align;
    # same-host wall clock does)
    w0 = time.time()
    t0 = time.perf_counter()
    done = 0
    while done < n:
        size = min(chunk, n - done)
        driver.review_batch(batch_of(done, size))
        done += size
    dur = time.perf_counter() - t0
    return {
        "event": "stream_done",
        "replica_id": replica_id,
        "n": n,
        "chunk": chunk,
        "s": round(dur, 3),
        "t0_wall": w0,
        "t1_wall": time.time(),
        "reviews_per_s": round(n / dur, 1),
    }


CRASH_EXIT_CODE = 23  # a chaos-injected hard exit, distinguishable from 0/1
_CHAOS_PULSE_S = 0.05  # fleet.replica_crash evaluation cadence


def _install_chaos() -> None:
    """Install the seeded fault plane from the GK_CHAOS env spec (set by
    the supervisor / chaos bench) and start the crash pulse: the
    `fleet.replica_crash` point is evaluated every pulse, so an
    error-mode rule with `after=N` hard-exits the child ~N*pulse seconds
    in — mid-load, deterministically in arrival count."""
    spec = os.environ.get("GK_CHAOS", "")
    if not spec:
        return
    from .. import faults

    faults.install_from_spec(json.loads(spec))

    def pulse():
        from .. import faults as _f

        while True:
            time.sleep(_CHAOS_PULSE_S)
            try:
                if _f.ENABLED:
                    _f.fire(_f.REPLICA_CRASH)
            except Exception:
                sys.stderr.write("chaos: replica crash injected\n")
                sys.stderr.flush()
                os._exit(CRASH_EXIT_CODE)

    threading.Thread(target=pulse, name="gk-chaos-pulse",
                     daemon=True).start()


def _reply(cmd: dict, payload: dict) -> None:
    """One JSON reply line, correlated to its command when the parent
    tagged it (ReplicaHandle.command always does)."""
    if isinstance(cmd, dict) and "id" in cmd:
        payload = {**payload, "reply_to": cmd["id"]}
    print(json.dumps(payload), flush=True)


def _handle_drain(app, cmd: dict, replica_id: str) -> dict:
    """Graceful drain (docs/fleet.md): stop accepting NEW admissions
    (503 on POST, /readyz not-ready), then flush everything already in
    the micro-batcher within the deadline budget.  In-flight requests
    keep their own admission deadline budgets — the drain budget bounds
    the flush wait, never extends any request."""
    deadline_s = float(cmd.get("deadline_ms", 1000.0)) / 1e3
    app.webhook_server.drain()
    mb = app.micro_batcher
    if mb is not None and hasattr(mb, "drain"):
        stats = mb.drain(deadline_s)
    else:
        stats = {"pending_start": 0, "drained": True, "overran": False,
                 "drain_ms": 0.0}
    return {"event": "drained", "replica_id": replica_id,
            "deadline_ms": round(deadline_s * 1e3, 3), **stats}


def main(argv: Optional[Sequence[str]] = None) -> int:
    t0 = time.monotonic()
    args = _child_parser().parse_args(argv)
    _install_chaos()
    from ..kube.inmem import InMemoryKube
    from ..main import App, build_parser

    # the shared kernel cache needs no read-mostly switch: a library's
    # file name hashes its sources, and a broken seal is rebuilt under a
    # pid-suffixed temporary name and renamed into place
    flags = [
        "--driver", args.driver,
        "--torch-device", args.torch_device,
        "--operation", "webhook",
        "--replica-id", args.replica_id,
        "--port", str(args.port),
        "--prometheus-port", "0",
        "--health-addr", ":0",
        "--disable-cert-rotation",  # TLS terminates at the front door
        "--log-level", os.environ.get("GK_REPLICA_LOG_LEVEL", "WARNING"),
    ]
    if args.snapshot_dir:
        flags += ["--snapshot-dir", args.snapshot_dir,
                  "--snapshot-no-resync"]
    if args.xla_cache_dir:
        flags += ["--xla-cache-dir", args.xla_cache_dir]
    if args.webhook_batch_static:
        flags += ["--webhook-batch-static"]
    if args.webhook_max_pending is not None:
        flags += ["--webhook-max-pending", str(args.webhook_max_pending)]
    if args.admission_fail_open:
        flags += ["--admission-fail-open"]
    if args.brownout_disable:
        flags += ["--brownout-disable"]
    dlog_dir = (args.decision_log_dir
                or os.environ.get("GK_DECISION_LOG_DIR", ""))
    if dlog_dir:
        # per-replica segments under the shared fleet dir: the segment
        # names carry the replica id, and retention prunes own files
        # only (docs/decision-logs.md).  The env spelling gets the SAME
        # sealed posture as the flag — the child would otherwise pick
        # the dir up from its parser default with seal off
        flags += ["--decision-log-dir", dlog_dir, "--decision-log-seal"]
    app = App(build_parser().parse_args(flags), kube=InMemoryKube())
    app.start()
    wire = None
    try:
        seeded = 0
        if not args.no_seed_namespaces:
            seeded = _seed_namespaces(app)
        drv = app.client.driver
        if hasattr(drv, "wait_ready"):
            drv.wait_ready(timeout=300.0)
        # the first evaluation's one-time cost (the first launches, the
        # render's first plans) is paid here, through the client, before
        # the probe: the admission objective counts the probe's
        # admission, and a slow one fired its alerts as soon as a young
        # replica had served ten requests, stepping its brownout ladder
        # up
        app.client.review(_probe_request())
        _probe_ready(app.webhook_server.port)
        # the batched wire listener: the event-loop front
        # door speaks framed chunks to this port; the HTTP listener
        # stays up for the classic door, /readyz probing, and /metrics
        from .wirelistener import WireListener

        ws = app.webhook_server
        wire = WireListener(
            handler=ws.validation_handler,
            label_handler=ws.label_handler,
            server=ws,
        ).start()
        ready = {
            "event": "ready",
            "replica_id": args.replica_id,
            "port": app.webhook_server.port,
            "wire_port": wire.port,
            # the ephemeral exporter port, announced so the parent-side
            # metrics federator (obs/fleetobs.py) can scrape this
            # replica's /metrics into the fleet view
            "metrics_port": (app.metrics_exporter.port
                             if app.metrics_exporter is not None else 0),
            "ready_s": round(time.monotonic() - t0, 3),
            "restore_outcome": getattr(
                app, "snapshot_restore_outcome", "none"),
            "templates": len(app.client.templates()),
            "namespaces_seeded": seeded,
        }
        print(json.dumps(ready), flush=True)
        # serve until the parent closes our stdin (or EOF on a detached
        # run): the pipe IS the lifetime — a dead parent reaps the fleet.
        # Lines on stdin are JSON commands (bench.py fleet drives the
        # in-process throughput stream this way); unknown lines are
        # ignored so a plain `echo | replica` still just serves.
        from .. import faults as _faults

        try:
            for line in sys.stdin:
                if _faults.ENABLED:
                    try:
                        # hang-mode rules wedge the command loop HERE: the
                        # pipe stops answering while the HTTP side keeps
                        # serving — the supervisor's command-pipe liveness
                        # is what must catch it
                        _faults.fire(_faults.REPLICA_WEDGE)
                    # gklint: disable=swallowed-exception -- the injected
                    # error IS the simulated failure: dropping exactly one
                    # command is the chaos contract (docs/failure-modes.md)
                    except Exception:
                        pass  # error-mode rules: drop this command only
                line = line.strip()
                if not line:
                    continue
                try:
                    cmd = json.loads(line)
                except ValueError:
                    continue
                if not isinstance(cmd, dict):
                    continue
                op = cmd.get("cmd")
                if op == "stream":
                    _reply(cmd, _stream_bench(
                        app,
                        n=int(cmd.get("n", 100_000)),
                        chunk=int(cmd.get("chunk", 8192)),
                        replica_id=args.replica_id,
                    ))
                elif op == "ping":
                    from ..obs import brownout as _brownout

                    _reply(cmd, {"event": "pong",
                                 "replica_id": args.replica_id,
                                 "draining": app.webhook_server._draining,
                                 # overload-plane visibility for the
                                 # bench/chaos harnesses: batcher sheds
                                 # and the brownout ladder level without
                                 # an extra HTTP scrape
                                 "sheds": getattr(
                                     app.micro_batcher, "sheds", 0),
                                 "brownout_level": _brownout
                                 .get_controller().level})
                elif op == "drain":
                    _reply(cmd, _handle_drain(app, cmd, args.replica_id))
                elif op == "traces":
                    # the trace ring over the command pipe:
                    # the HTTP /debug/traces surface is primary; this
                    # lets a collector join traces even while the
                    # webhook listener is saturated or draining.
                    # Malformed params degrade to defaults — a bad
                    # command must not escape as ValueError and end
                    # the command loop (the outer catch treats that
                    # as shutdown)
                    from ..obs import trace as _obstrace

                    try:
                        min_ms = float(cmd.get("min_ms", 0.0))
                    except (TypeError, ValueError):
                        min_ms = 0.0
                    try:
                        limit = (int(cmd["limit"])
                                 if "limit" in cmd else None)
                    except (TypeError, ValueError):
                        limit = None
                    _reply(cmd, {
                        "event": "traces",
                        "replica_id": args.replica_id,
                        "traces": _obstrace.get_tracer().traces(
                            min_ms=min_ms, limit=limit,
                        ),
                    })
                elif op == "chaos":
                    # runtime (re)install of the seeded fault plane:
                    # lets a harness seed one deterministic fault (e.g.
                    # the OBS_r11 slow-request latency rule) into a
                    # WARM replica without a respawn; spec=None
                    # uninstalls.  Same spec schema as GK_CHAOS.
                    spec = cmd.get("spec")
                    err = ""
                    try:
                        if spec:
                            _faults.install_from_spec(spec)
                        else:
                            _faults.uninstall()
                    except Exception as e:
                        # a typo'd spec must fail THIS command loudly,
                        # not kill the command loop
                        err = f"{type(e).__name__}: {e}"
                    _reply(cmd, {"event": "chaos",
                                 "replica_id": args.replica_id,
                                 "enabled": _faults.ENABLED,
                                 "error": err})
                elif op == "profiler":
                    # runtime re-rate of the sampling profiler (bench.py
                    # measures profiler-on vs -off throughput on the
                    # SAME warm replica, no respawn)
                    from ..obs.profiler import get_profiler

                    prof = get_profiler()
                    if "hz" in cmd:
                        try:
                            hz = float(cmd["hz"])
                        except (TypeError, ValueError):
                            hz = None  # bad hz: report state, change
                            #            NOTHING (a failed parse must
                            #            not start a profiler the
                            #            operator disabled)
                        if hz is not None:
                            prof.configure(hz=hz)
                            if prof.hz > 0 and not prof.running:
                                prof.start()
                    _reply(cmd, {"event": "profiler",
                                 "replica_id": args.replica_id,
                                 "hz": prof.hz,
                                 "running": prof.running,
                                 "samples": prof.samples})
        except (KeyboardInterrupt, ValueError):
            pass
        return 0
    finally:
        if wire is not None:
            wire.stop()
        app.stop()


# ---- parent-side spawn helpers ---------------------------------------------


_EOF = object()  # reader-thread sentinel: child stdout closed


def _spawn_proc(replica_id: str, snapshot_dir: str, cache_dir: str,
                extra_flags: Sequence[str],
                env: Optional[Dict[str, str]]) -> subprocess.Popen:
    cmd = [sys.executable, "-m", "gatekeeper_tpu_torch.fleet.replica",
           "--replica-id", replica_id]
    if snapshot_dir:
        cmd += ["--snapshot-dir", snapshot_dir]
    if cache_dir:
        cmd += ["--xla-cache-dir", cache_dir]
    cmd += list(extra_flags)
    child_env = dict(os.environ)
    if env:
        child_env.update(env)
    return subprocess.Popen(
        cmd, cwd=REPO_ROOT, env=child_env,
        stdin=subprocess.PIPE, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True,
        # own process group (session): the supervisor's SIGTERM/atexit
        # cleanup kills the GROUP, so a replica's own children (jax
        # compile helpers, profilers) can never outlive a dead parent
        start_new_session=True,
    )


class _Pipes:
    """Shared state between a replica's pipe reader threads and every
    parent-side waiter: the general message queue (ready lines and other
    uncorrelated output), a per-command-id reply demux, and the bounded
    stderr tail."""

    def __init__(self):
        # gklint: disable=unbounded-queue -- bounded by protocol: the child
        # emits one ready line plus one reply per command; correlated
        # replies route to per-command waiter queues, not here
        self.msgs: queue.Queue = queue.Queue()
        self.stderr_tail: deque = deque(maxlen=400)
        self.waiters: Dict[str, queue.Queue] = {}
        self.waiters_lock = threading.Lock()

    def route(self, msg: dict):
        rt = msg.get("reply_to")
        if rt is not None:
            with self.waiters_lock:
                q = self.waiters.get(rt)
            if q is not None:
                q.put(msg)
                return
        self.msgs.put(msg)

    def eof(self):
        """Child stdout closed: every current AND future waiter must see
        it — command() re-checks liveness, so no waiter parks forever."""
        self.msgs.put(_EOF)
        with self.waiters_lock:
            for q in self.waiters.values():
                q.put(_EOF)


def _attach_pipes(proc: subprocess.Popen, replica_id: str) -> _Pipes:
    """Reader threads own BOTH child pipes from the moment of spawn:

    - stdout: parsed JSON dicts land on a queue the parent reads with a
      real timeout — a bare ``readline()`` would block past any deadline
      on a wedged child, and mixing ``select()`` with buffered readline
      misses replies already sitting in the text-wrapper buffer.
      Replies carrying ``reply_to`` route to that command's registered
      waiter, so concurrent command() calls (a supervisor heartbeat
      racing a bench stream) never steal each other's replies;
    - stderr: drained continuously into a bounded tail — a chatty child
      (WARNING logs under co-tenant load) would otherwise fill the 64KB
      pipe and deadlock mid-command; the tail feeds error messages.
    """
    pipes = _Pipes()

    def _read_stdout():
        try:
            for line in proc.stdout:
                try:
                    msg = json.loads(line)
                except ValueError:
                    continue  # stray log line on stdout
                if isinstance(msg, dict):
                    pipes.route(msg)
        except (OSError, ValueError):
            pass  # pipe torn down mid-read (child died / parent closing)
        pipes.eof()

    def _read_stderr():
        try:
            for line in proc.stderr:
                pipes.stderr_tail.append(line)
        except (OSError, ValueError):
            pass  # pipe torn down mid-read (child died / parent closing)

    for target, name in ((_read_stdout, "out"), (_read_stderr, "err")):
        threading.Thread(
            target=target, name=f"replica-{replica_id}-{name}", daemon=True,
        ).start()
    return pipes


def _stderr_str(stderr_tail: deque) -> str:
    return "".join(stderr_tail)[-2000:]


def _wait_ready(proc: subprocess.Popen, replica_id: str, pipes: _Pipes,
                t0: float, timeout_s: float) -> Dict:
    """Block until the child's ready line; on timeout KILL the child so
    a wedged spawn never leaks, on early exit report rc + stderr tail."""
    deadline = t0 + timeout_s
    while True:
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            proc.kill()
            proc.wait(timeout=10)
            raise TimeoutError(
                f"replica {replica_id} never announced ready; stderr "
                f"tail:\n{_stderr_str(pipes.stderr_tail)}"
            )
        try:
            msg = pipes.msgs.get(timeout=min(remaining, 1.0))
        except queue.Empty:
            continue
        if msg is _EOF:
            proc.wait(timeout=10)
            raise RuntimeError(
                f"replica {replica_id} exited rc={proc.returncode} before "
                f"ready; stderr tail:\n{_stderr_str(pipes.stderr_tail)}"
            )
        if msg.get("event") == "ready":
            return msg


class ReplicaHandle:
    def __init__(self, proc: subprocess.Popen, replica_id: str,
                 ready: Dict, spawn_s: float, pipes: _Pipes):
        self.proc = proc
        self.replica_id = replica_id
        self.ready = ready          # the child's announced ready line
        self.port: int = int(ready["port"])
        # exporter port for the metrics federator (0 on older replicas)
        self.metrics_port: int = int(ready.get("metrics_port", 0))
        # batched wire-protocol listener (0 on replicas without one)
        self.wire_port: int = int(ready.get("wire_port", 0))
        self.ready_s: float = float(ready["ready_s"])  # in-process
        self.spawn_s = spawn_s      # parent wall: Popen -> ready line
        self.host = "127.0.0.1"
        self._pipes = pipes
        self._stderr_tail = pipes.stderr_tail
        self._cmd_counter = itertools.count()
        # commands currently awaiting replies: the supervisor skips its
        # pipe-liveness ping while a long command (a bench stream) holds
        # the child's single-threaded command loop
        self.inflight_commands = 0

    def backend(self) -> Dict:
        return {"host": self.host, "port": self.port,
                "replica_id": self.replica_id}

    def wire_backend(self) -> Dict:
        """Backend dict for the event-loop door: admissions travel the
        framed wire port, while /readyz probing stays on the HTTP port
        (the wire listener does not speak HTTP)."""
        if not self.wire_port:
            return self.backend()
        return {"host": self.host, "port": self.wire_port,
                "probe_port": self.port, "replica_id": self.replica_id}

    def command(self, cmd: Dict, timeout_s: float = 600.0) -> Dict:
        """Send one JSON command line to the child and return its JSON
        reply.  Each command carries a unique id the child echoes as
        reply_to; the reader thread routes the reply to THIS call's
        queue, so concurrent commands (supervisor heartbeat + bench
        stream) cannot steal each other's replies, and the queue read
        enforces the timeout even when the child emits nothing."""
        cid = f"{self.replica_id}-{next(self._cmd_counter)}"
        cmd = {**cmd, "id": cid}
        # gklint: disable=unbounded-queue -- holds at most one reply (the
        # child echoes exactly one line per command id) plus the EOF sentinel
        replies: queue.Queue = queue.Queue()
        with self._pipes.waiters_lock:
            self._pipes.waiters[cid] = replies
        self.inflight_commands += 1
        try:
            try:
                self.proc.stdin.write(json.dumps(cmd) + "\n")
                self.proc.stdin.flush()
            except (OSError, ValueError) as e:
                raise RuntimeError(
                    f"replica {self.replica_id} pipe closed "
                    f"(rc={self.proc.poll()}): {e}; stderr tail:\n"
                    f"{_stderr_str(self._stderr_tail)}"
                )
            deadline = time.monotonic() + timeout_s
            while True:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    raise TimeoutError(
                        f"replica {self.replica_id} command timed out: "
                        f"{cmd}"
                    )
                try:
                    msg = replies.get(timeout=remaining)
                except queue.Empty:
                    continue
                if msg is _EOF:
                    raise RuntimeError(
                        f"replica {self.replica_id} died mid-command "
                        f"(rc={self.proc.poll()}); stderr tail:\n"
                        f"{_stderr_str(self._stderr_tail)}"
                    )
                return msg
        finally:
            self.inflight_commands -= 1
            with self._pipes.waiters_lock:
                self._pipes.waiters.pop(cid, None)

    def kill(self):
        """Hard-kill the replica's whole process group (it was spawned
        with start_new_session, so pgid == child pid)."""
        try:
            os.killpg(self.proc.pid, signal.SIGKILL)
        except (ProcessLookupError, PermissionError):
            try:
                self.proc.kill()
            except OSError:
                pass  # already gone
        try:
            self.proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            # SIGKILL that a process survives 10s is an operator problem
            # (unkillable D-state), never a silent one
            log.warning("replica %s did not exit within 10s of SIGKILL",
                        self.replica_id)

    def stop(self, timeout_s: float = 15.0):
        if self.proc.poll() is None:
            try:
                self.proc.stdin.close()  # the lifetime signal
            except (OSError, ValueError):
                pass  # pipe already closed by a dead child
            try:
                self.proc.wait(timeout=timeout_s)
            except subprocess.TimeoutExpired:
                self.kill()


def spawn_replica(replica_id: str, snapshot_dir: str = "",
                  cache_dir: str = "", extra_flags: Sequence[str] = (),
                  env: Optional[Dict[str, str]] = None,
                  timeout_s: float = 300.0) -> ReplicaHandle:
    """Start one replica child and block until its ready line (raising
    with the child's stderr tail on failure)."""
    t0 = time.monotonic()
    proc = _spawn_proc(replica_id, snapshot_dir, cache_dir, extra_flags, env)
    pipes = _attach_pipes(proc, replica_id)
    ready = _wait_ready(proc, replica_id, pipes, t0, timeout_s)
    return ReplicaHandle(proc, replica_id, ready,
                         round(time.monotonic() - t0, 3), pipes)


def spawn_fleet(n: int, snapshot_dir: str = "", cache_dir: str = "",
                extra_flags: Sequence[str] = (),
                env: Optional[Dict[str, str]] = None,
                timeout_s: float = 300.0,
                sequential: bool = True) -> List[ReplicaHandle]:
    """Start n replicas (r0..r{n-1}).  ``sequential`` (default) waits for
    each before starting the next — on a small host, concurrent cold
    spawns contend for cores and every ready time degrades; a k8s fleet
    scales up on fresh nodes, which sequential spawn approximates."""
    handles: List[ReplicaHandle] = []
    procs: List = []
    try:
        if sequential:
            for i in range(n):
                handles.append(spawn_replica(
                    f"r{i}", snapshot_dir, cache_dir, extra_flags, env,
                    timeout_s,
                ))
        else:
            for i in range(n):
                rid = f"r{i}"
                t0 = time.monotonic()
                proc = _spawn_proc(
                    rid, snapshot_dir, cache_dir, extra_flags, env
                )
                procs.append((rid, t0, proc, _attach_pipes(proc, rid)))
            for rid, t0, proc, pipes in procs:
                ready = _wait_ready(proc, rid, pipes, t0, timeout_s)
                handles.append(ReplicaHandle(
                    proc, rid, ready, round(time.monotonic() - t0, 3),
                    pipes,
                ))
    except BaseException:
        # kill EVERY spawned child, wrapped in a handle or not — a
        # partially-failed concurrent spawn must not leak live replicas
        for _rid, _t0, proc, *_rest in procs:
            if proc.poll() is None:
                proc.kill()
        for h in handles:
            h.stop()
        raise
    return handles


if __name__ == "__main__":
    sys.exit(main())
