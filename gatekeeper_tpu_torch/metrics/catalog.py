"""The metric catalog (reference docs/Metrics.md) and the reporter facade.

Every metric the reference documents, with the same names, tags, and bucket
boundaries, defined against this framework's view registry:

  constraints                                pkg/controller/constraint/stats_reporter.go:13-36
  constraint_templates                       pkg/controller/constrainttemplate/stats_reporter.go:15-33
  constraint_template_ingestion_count        .../stats_reporter.go:36-41
  constraint_template_ingestion_duration_seconds  .../stats_reporter.go:43-48
  request_count / request_duration_seconds   pkg/webhook/stats_reporter.go:13-25,71-88
  violations                                 pkg/audit/stats_reporter.go:15-41
  audit_duration_seconds / audit_last_run_time    pkg/audit/stats_reporter.go:42-53
  sync / sync_duration_seconds / sync_last_run_time  pkg/controller/sync/stats_reporter.go:14-46
  watch_manager_watched_gvk / watch_manager_intended_watch_gvk  pkg/watch/stats_reporter.go:13-33
"""

from __future__ import annotations

import time
from typing import Dict, Optional

from .views import (
    AGG_COUNT,
    AGG_DISTRIBUTION,
    AGG_LAST_VALUE,
    Measure,
    Registry,
    View,
    global_registry,
)

# ---- measures ---------------------------------------------------------------

CONSTRAINTS_M = Measure("constraints", "Current number of known constraints")
CT_M = Measure(
    "constraint_templates", "Number of observed constraint templates"
)
INGEST_DURATION_M = Measure(
    "constraint_template_ingestion_duration_seconds",
    "How long it took to ingest a constraint template in seconds",
    unit="s",
)
REQUEST_DURATION_M = Measure(
    "request_duration_seconds", "The response time in seconds", unit="s"
)
VIOLATIONS_M = Measure(
    "violations", "Total number of violations per constraint"
)
AUDIT_DURATION_M = Measure(
    "audit_duration_seconds", "Latency of audit operation in seconds", unit="s"
)
AUDIT_LAST_RUN_M = Measure(
    "audit_last_run_time", "Timestamp of last audit run time", unit="s"
)
SYNC_M = Measure(
    "sync", "Total number of resources of each kind being cached"
)
SYNC_DURATION_M = Measure(
    "sync_duration_seconds", "Latency of sync operation in seconds", unit="s"
)
SYNC_LAST_RUN_M = Measure(
    "sync_last_run_time", "Timestamp of last sync operation", unit="s"
)
WATCHED_GVK_M = Measure(
    "watch_manager_watched_gvk", "Total number of watched GroupVersionKinds"
)
INTENDED_GVK_M = Measure(
    "watch_manager_intended_watch_gvk",
    "Total number of GroupVersionKinds with a registered watch intent",
)
# ---- robustness additions (fault plane / breaker / audit health) -----------
AUDIT_STATUS_M = Measure(
    "audit_last_run_status",
    "Whether the most recent audit run succeeded (1) or failed (0)",
)
AUDIT_FAILS_M = Measure(
    "audit_consecutive_failures",
    "Consecutive audit runs that have failed since the last success",
)
BREAKER_STATE_M = Measure(
    "tpu_breaker_state",
    "TPU circuit breaker state (0 closed, 1 half-open, 2 open)",
)
BREAKER_TRIPS_M = Measure(
    "tpu_breaker_trips",
    "Cumulative TPU circuit breaker trips (closed -> open transitions)",
)
BREAKER_DEGRADED_M = Measure(
    "tpu_breaker_degraded_seconds",
    "Cumulative seconds spent with the TPU breaker not closed "
    "(evaluation served by the interpreter tier)",
    unit="s",
)
# ---- observability additions (per-stage hot-path telemetry) --------
WEBHOOK_QUEUE_M = Measure(
    "webhook_batch_queue_seconds",
    "Time an admission review waited in the micro-batch queue before its "
    "batch dispatched",
    unit="s",
)
BATCH_SIZE_M = Measure(
    "webhook_batch_size",
    "Admission reviews coalesced into one batched evaluation",
)
PACK_M = Measure(
    "tpu_pack_seconds",
    "Host-side tensor packing time per evaluation (reviews + columns)",
    unit="s",
)
COMPILE_M = Measure(
    "tpu_compile_seconds",
    "XLA trace+compile time per fused-executable build (cache misses only)",
    unit="s",
)
DISPATCH_M = Measure(
    "tpu_dispatch_seconds",
    "Device dispatch + result fetch time per evaluation",
    unit="s",
)
CACHE_M = Measure(
    "cache_requests",
    "Evaluation-cache lookups by cache (request_memo, aotcache, xlacache) "
    "and outcome (hit, miss)",
)
# ---- compiled violation rendering ---------------------------------
RENDER_CELLS_M = Measure(
    "render_cells",
    "Violation-candidate cells rendered, by plan tier: static (bind-time "
    "constant message), slots (compiled field-gather message), interp "
    "(interpreter fallback)",
)
# ---- snapshot / warm-resume subsystem -----------------------------
SNAPSHOT_WRITE_M = Measure(
    "snapshot_write_seconds",
    "Wall time to capture + persist one state snapshot (capture under the "
    "driver lock plus serialization and the atomic rename)",
    unit="s",
)
SNAPSHOT_LOAD_M = Measure(
    "snapshot_load_seconds",
    "Wall time of a startup snapshot restore: validation, array load and "
    "the kube delta resync",
    unit="s",
)
SNAPSHOT_BYTES_M = Measure(
    "snapshot_bytes",
    "On-disk size of the most recently written snapshot directory",
    unit="By",
)
SNAPSHOT_RESTORE_M = Measure(
    "snapshot_restore_outcome",
    "Startup snapshot restore attempts by outcome (restored, fallback, "
    "none, disabled), plus one 'quarantined' sample per snapshot a "
    "restore moved aside into .quarantine/ after failed validation",
)
# ---- cost attribution + SLO engine --------------------------------
# The cost_* gauges are refreshed from the cost ledger's decaying window
# by the exporter's pre-scrape hook (obs/costs.py collect); their
# `template` label is top-K-capped with an `other` rollup — the
# cardinality contract tools/check_observability.py lints.
COST_DEVICE_MS_M = Measure(
    "cost_device_ms",
    "Device (dispatch) milliseconds attributed to a template over the "
    "cost-ledger window, apportioned by evaluated cells",
    unit="ms",
)
COST_RENDER_MS_M = Measure(
    "cost_render_ms",
    "Host render milliseconds attributed to a template over the "
    "cost-ledger window, apportioned by rendered cells",
    unit="ms",
)
COST_CELLS_M = Measure(
    "cost_cells",
    "Cells evaluated for a template over the cost-ledger window",
)
COST_RENDER_CELLS_M = Measure(
    "cost_render_cells",
    "Violation-candidate cells rendered for a template over the "
    "cost-ledger window, by render-plan tier",
)
COST_VIOLATIONS_M = Measure(
    "cost_violations",
    "Violations rendered for a template over the cost-ledger window",
)
COST_MEMO_HIT_RATIO_M = Measure(
    "cost_memo_hit_ratio",
    "Review-memo hit ratio for a template's rendered cells over the "
    "cost-ledger window",
)
# ---- sharded mesh audit -------------------------------------------
# Per-shard stage telemetry for the double-buffered host-pack / device-
# commit pipeline (parallel/mesh.py pipelined_shard_commit): one sample
# per shard per full placement, labelled by path (review/audit).
AUDIT_SHARD_ROWS_M = Measure(
    "audit_shard_rows",
    "Rows committed to one mesh shard's contiguous slab per full "
    "placement (the per-device share of the sharded [C, R] sweep)",
)
AUDIT_SHARD_PACK_M = Measure(
    "audit_shard_pack_seconds",
    "Host-side slab slice/pad time per shard in the double-buffered "
    "placement pipeline (overlaps the previous shard's transfer)",
    unit="s",
)
AUDIT_SHARD_DISPATCH_M = Measure(
    "audit_shard_dispatch_seconds",
    "Per-shard device commit (async transfer issue) time in the "
    "double-buffered placement pipeline",
    unit="s",
)
# ---- fleet serving + load-adaptive micro-batcher ------------------
# All four series carry the replica_id label (util.replica_id(); empty on
# single-process deployments) so a scraped fleet's telemetry separates
# per replica without relying on scrape-time instance labels.
REPLICA_UP_M = Measure(
    "replica_up",
    "1 for a started gatekeeper process, labelled by its fleet "
    "replica_id (empty outside a fleet)",
)
BATCH_TARGET_M = Measure(
    "webhook_batch_target_size",
    "The micro-batcher's current load-adapted target batch size "
    "(1 = immediate dispatch at the latency floor)",
)
BATCH_DEADLINE_M = Measure(
    "webhook_batch_deadline_ms",
    "The micro-batcher's current load-adapted flush deadline: how long "
    "the accumulation window stays open under observed concurrency",
    unit="ms",
)
OFFERED_LOAD_M = Measure(
    "webhook_offered_load_rps",
    "Offered admission load the micro-batcher currently observes "
    "(decayed arrival rate, requests/second)",
)
SLO_BURN_M = Measure(
    "slo_burn_rate",
    "Error-budget burn rate per SLO objective and trailing window "
    "(1.0 = budget consumed exactly at the sustainable rate)",
)
SLO_BUDGET_M = Measure(
    "slo_error_budget_remaining",
    "Fraction of the 6h error budget remaining per SLO objective",
)
AUDIT_AGE_M = Measure(
    "audit_last_run_age_s",
    "Seconds since the last successful audit sweep finished (since "
    "process start when none has completed)",
    unit="s",
)
# ---- self-healing fleet -------------------------------------------
REPLICA_RESTARTS_M = Measure(
    "fleet_replica_restarts",
    "Supervisor-initiated replica restarts by replica_id and reason "
    "(crash, wedge, rolling)",
)
REPLICA_STATE_M = Measure(
    "fleet_replica_state",
    "Supervised replica state (0 running, 1 restarting, 2 quarantined, "
    "3 draining, 4 stopped), per replica_id",
)
MESH_STALL_M = Measure(
    "mesh_dispatch_stalls",
    "Mesh-collective dispatches abandoned by the dispatch watchdog "
    "(each trips the breaker and re-shards the sweep narrower)",
)
MESH_WIDTH_M = Measure(
    "mesh_sweep_width",
    "Row-sharding width currently serving device audit sweeps "
    "(1 = the single-device path; drops when a dispatch stall degrades "
    "the mesh)",
)
# ---- fleet observability plane -----------------------------------
# Wire-path stage telemetry recorded by the front door (the serving edge
# the FLEET_r06 176 reviews/s number traverses), scrape-health gauges
# recorded by the metrics federator, and the sampling profiler's own
# accounting.  Stage names are the frontdoor.WIRE_STAGES stable set
# (docs/tracing.md); tools/check_observability.py cross-checks them.
FRONTDOOR_STAGE_M = Measure(
    "frontdoor_stage_seconds",
    "Time one admission request spent in one front-door wire-path stage "
    "(accept, read_body, route_choose, proxy_connect, replica_wait, "
    "write_back) — the stages are disjoint and sum to the wire latency",
    unit="s",
)
FRONTDOOR_REQS_M = Measure(
    "frontdoor_requests",
    "Requests through the fleet front door by outcome (ok, "
    "backend_error, no_backend, bad_request) and serving backend "
    "replica id (empty when no backend answered)",
)
FLEET_SCRAPE_OK_M = Measure(
    "fleet_scrape_ok",
    "1 when the federator's most recent scrape of this replica's "
    "exporter succeeded, 0 when the federated view is serving its "
    "stale-marked last-known-good series",
)
FLEET_SCRAPE_AGE_M = Measure(
    "fleet_scrape_age_seconds",
    "Seconds since the federator last scraped this replica "
    "successfully (grows while the replica is wedged or down)",
    unit="s",
)
FLEET_SCRAPED_M = Measure(
    "fleet_replicas_scraped",
    "Replica exporters scraped successfully on the federator's most "
    "recent pass (the fleet rollup's freshness denominator)",
)
FLEET_ADMISSIONS_M = Measure(
    "fleet_admission_requests",
    "Fleet rollup: sum of request_count samples across every scraped "
    "replica exporter (stale-marked series included)",
)
# ---- overload robustness plane -----------------------------------
# Bounded-backpressure accounting: every request refused by a bound
# (micro-batcher max_pending, front-door inflight cap, expired deadline,
# spent retry budget) counts here by reason — the shed rate is also a
# brownout-ladder input (obs/brownout.py).
SHED_M = Measure(
    "shed",
    "Admission requests refused by the overload plane, by reason "
    "(queue_full, queue_full_dryrun, door_inflight, deadline_expired) "
    "— every shed is an explicit fail-open/closed decision, never a "
    "timeout (denied retries count separately in "
    "frontdoor_retries_denied_total)",
)
BROWNOUT_M = Measure(
    "brownout_level",
    "Current brownout-ladder level (0 normal; 1 audit/snapshot "
    "deferral; 2 + reduced trace sampling and profiler rate; 3 + router "
    "pinned to the cheapest sustainable tier)",
)
RETRY_TOKENS_M = Measure(
    "frontdoor_retry_tokens",
    "Tokens currently in the front door's retry budget bucket; retries "
    "are denied at zero so they cannot amplify a brownout into a storm",
)
RETRY_DENIED_M = Measure(
    "frontdoor_retries_denied",
    "Front-door retries denied because the retry budget bucket was "
    "empty (the request fails over to the explicit 502 path instead)",
)
# ---- engine observability plane ----------------------------------
# Route-explainability counter fed per BATCH decision by the driver's
# route ledger (obs/routeledger.py); compile/device telemetry gauges fed
# by obs/compilestats.py from the aot/async/xla compile paths and the
# driver's device-placement chokepoints.
ROUTE_DECISIONS_M = Measure(
    "route_decisions",
    "Evaluation routing decisions by chosen tier (device, np, interp) "
    "and deciding reason (latency, load_aware, saturated, brownout_pin, "
    "breaker_open, compile_pending, device_failed, forced_device, "
    "uncalibrated_prior) — one per evaluated batch, never per review",
)
JOIN_PLANS_M = Measure(
    "join_plans",
    "Active cross-resource join plans (referential policies classified "
    "into vectorized join/aggregate kernels, ops/joinkernel.py)",
)
JOIN_AFFECTED_M = Measure(
    "join_delta_affected_rows",
    "Reader rows co-dispatched by a delta sweep because a churned row "
    "changed their join key group's aggregate — the key-group locality "
    "cost beyond raw churn",
)
JOIN_DIVERGENCE_M = Measure(
    "join_plan_divergence",
    "Cells an exact join plan flagged whose interpreter-oracle render "
    "was empty (interned-key/aggregate divergence; raises under "
    "GK_JOIN_ASSERT=1)",
)
COMPILE_LAG_M = Measure(
    "compile_epoch_lag",
    "Constraint-side mutation epochs the async background compiler is "
    "behind the live epoch (0 = the compiled executable is current; the "
    "backlog the audit wait loop otherwise infers blind)",
)
DEVICE_BYTES_M = Measure(
    "device_bytes",
    "Device-resident bytes by component: the packed [C,R] audit arrays "
    "(audit_pack / audit_pack_mesh with per-shard slab share) and the "
    "replicated constraint side, recorded at each placement",
    unit="By",
)
XLA_COUNTERS_M = Measure(
    "xlacache_counters_available",
    "1 when jax's persistent-compilation-cache monitoring events exist "
    "on this build (cache_requests_total{cache=xlacache} is live), 0 "
    "when they are absent and that instrumentation is silently missing",
)
# ---- decision log ------------------------------------------------
# Durable verdict provenance (obs/decisionlog.py): record/drop accounting
# for the non-blocking decision recorder — a dropped record is an audit
# gap and must be visible, never silent (the telemetry-drop contract).
DECISION_RECORDS_M = Measure(
    "decision_log_records",
    "Decision records accepted by the recorder, by decision class "
    "(allow, deny, shed, expired, error) or 'audit_transition' — "
    "sampled-out records count in decision_log_dropped_total instead",
)
DECISION_DROPPED_M = Measure(
    "decision_log_dropped",
    "Decision records not written, by reason (sampled_out: head "
    "sampling; queue_full: bounded-queue shed; write_error: disk "
    "failure; transition_overflow: per-sweep transition cap) — every "
    "drop is counted, never silent",
)
DECISION_SEGMENTS_M = Measure(
    "decision_log_segments",
    "Completed decision-log segments made visible by the writer's "
    "atomic rename (rotation by size/time; bounded retention prunes "
    "this replica's own oldest segments)",
)
DECISION_BYTES_M = Measure(
    "decision_log_bytes",
    "Bytes of decision records committed into completed segments",
    unit="By",
)
PROFILER_SAMPLES_M = Measure(
    "profiler_samples",
    "Thread-stack samples collected by the always-on sampling profiler "
    "(obs/profiler.py; one sample = one thread's stack at one tick)",
)
PROFILER_OVERFLOW_M = Measure(
    "profiler_overflow",
    "Profiler samples dropped because the unique-stack table hit its "
    "memory bound (max_stacks); the profile is still valid, its tail "
    "is just truncated",
)
# ---- reactor observability plane ---------------------------------
# Runtime health of the serving-edge event loops (fleet/evloop.py via
# obs/reactorobs.py): every series carries the `loop` tag (evdoor,
# wirelistener) because the door and the replica listener each run their
# own reactor.  The per-tick series are tick-batched and flush-sampled —
# the reactor thread pays plain arithmetic per tick, never a registry
# lock per tick.
EVLOOP_LAG_M = Measure(
    "evloop_lag_seconds",
    "Scheduling skew of the reactor's self-scheduled heartbeat timer: "
    "how late the loop fired a timer it armed for a known instant — "
    "THE loop-health gauge (a slow callback anywhere delays every "
    "connection by at least this much)",
    unit="s",
)
EVLOOP_TICK_M = Measure(
    "evloop_tick_seconds",
    "Duration of one reactor tick (select wait + I/O callbacks + "
    "timers + posted callbacks + tick hooks), flush-sampled",
    unit="s",
)
EVLOOP_UTIL_M = Measure(
    "evloop_utilization",
    "Fraction of reactor wall time spent running callbacks rather than "
    "waiting in select() over the last telemetry flush window (1.0 = "
    "the loop thread is saturated and queueing work)",
)
EVLOOP_CBS_M = Measure(
    "evloop_callbacks_per_tick",
    "Callbacks (I/O + timer + posted) dispatched in one reactor tick, "
    "flush-sampled",
)
EVLOOP_DRIFT_M = Measure(
    "evloop_timer_drift_seconds",
    "Timer-wheel drift: how far past its due instant a timer actually "
    "fired (sweep, heartbeat, deadline-expiry timers all ride the same "
    "monotonic heap)",
    unit="s",
)
EVLOOP_SLOW_M = Measure(
    "evloop_slow_callbacks",
    "Reactor callbacks that ran past the slow-callback threshold and "
    "landed in the top-K culprit table (each also emits an "
    "evloop_stall flight-recorder event, rate-bounded per culprit)",
)
EVLOOP_STALLS_M = Measure(
    "evloop_stalls",
    "Reactor stalls past the watchdog budget caught by the cross-"
    "thread watchdog (each dumps a flight-recorder incident carrying "
    "the reactor thread's folded stack)",
)
# GKW1 wire telemetry, both ends: `end` is door (fleet/evdoor.py) or
# replica (fleet/wirelistener.py), `kind` the frame kind.  Chunk/byte
# counts are tick-batched on the reactor threads and flushed on the
# reactorobs cadence.
WIRE_CHUNKS_M = Measure(
    "wire_chunks",
    "GKW1 chunk frames moved on the door<->replica wire, by end (door, "
    "replica) and frame kind (request, response)",
)
WIRE_RECORDS_M = Measure(
    "wire_chunk_records",
    "Records batched into one GKW1 chunk frame (the tick-coalescing "
    "win the batched protocol exists for), by end and kind",
)
WIRE_BYTES_M = Measure(
    "wire_bytes",
    "Bytes moved on the door<->replica wire, by end and direction "
    "(in, out)",
    unit="By",
)
WIRE_DECODE_ERRORS_M = Measure(
    "wire_decode_errors",
    "GKW1 frame streams abandoned as undecodable (wireproto."
    "ProtocolError; the carrying connection closes — there is no "
    "resync point in a length-prefixed stream that lied)",
)
WIRE_RECONNECTS_M = Measure(
    "wire_reconnects",
    "Door-side wire-connection rebuilds to a backend whose previous "
    "persistent connection was lost, by backend replica id",
)
WIRE_BACKLOG_STALL_M = Measure(
    "wire_backlog_stall_seconds",
    "Duration of one door-side wire-connection backlog episode: the "
    "span from a chunk write leaving bytes buffered (the kernel socket "
    "buffer filled) until the backlog fully drained, by backend",
    unit="s",
)

# bucket boundaries copied from the reference's view.Distribution calls
_INGEST_BUCKETS = (
    0.01, 0.02, 0.03, 0.04, 0.05, 0.06, 0.07, 0.08, 0.09, 0.1,
    0.2, 0.3, 0.4, 0.5, 1, 2, 3, 4, 5,
)
_REQUEST_BUCKETS = (
    0.001, 0.002, 0.003, 0.004, 0.005, 0.006, 0.007, 0.008, 0.009, 0.01,
    0.02, 0.03, 0.04, 0.05,
)
_AUDIT_BUCKETS = (0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9, 1, 2, 3, 4, 5)
_SYNC_BUCKETS = (
    0.0001, 0.0002, 0.0003, 0.0004, 0.0005, 0.0006, 0.0007, 0.0008, 0.0009,
    0.001, 0.002, 0.003, 0.004, 0.005, 0.01, 0.02, 0.03, 0.04, 0.05,
)
# stage timings span ~50us (warm host pack) to seconds (cold XLA compile)
_STAGE_BUCKETS = (
    0.00005, 0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025,
    0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0,
)
_BATCH_SIZE_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256)
# rows per shard slab: admission batches (tens) to 1M-row clusters over
# an 8-chip mesh (125k rows/shard)
_SHARD_ROWS_BUCKETS = (
    8, 64, 512, 2048, 8192, 32768, 131072, 524288,
)
# snapshot write/load span ~10ms (small corpora) to tens of seconds (100k
# rows through json+npz on a loaded node)
_SNAPSHOT_BUCKETS = (
    0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
)


def catalog_views():
    return [
        View("constraints", CONSTRAINTS_M, AGG_LAST_VALUE,
             tag_keys=("enforcement_action", "status")),
        View("constraint_templates", CT_M, AGG_LAST_VALUE,
             tag_keys=("status",)),
        View("constraint_template_ingestion_count", INGEST_DURATION_M,
             AGG_COUNT,
             description="Total number of constraint template ingestion actions",
             tag_keys=("status",)),
        View("constraint_template_ingestion_duration_seconds",
             INGEST_DURATION_M, AGG_DISTRIBUTION,
             description="Distribution of how long it took to ingest a "
                         "constraint template in seconds",
             tag_keys=("status",), buckets=_INGEST_BUCKETS),
        View("request_count", REQUEST_DURATION_M, AGG_COUNT,
             description="The number of requests that are routed to webhook",
             tag_keys=("admission_status",)),
        View("request_duration_seconds", REQUEST_DURATION_M, AGG_DISTRIBUTION,
             tag_keys=("admission_status",), buckets=_REQUEST_BUCKETS),
        View("violations", VIOLATIONS_M, AGG_LAST_VALUE,
             tag_keys=("enforcement_action",)),
        View("audit_duration_seconds", AUDIT_DURATION_M, AGG_DISTRIBUTION,
             buckets=_AUDIT_BUCKETS),
        View("audit_last_run_time", AUDIT_LAST_RUN_M, AGG_LAST_VALUE),
        View("sync", SYNC_M, AGG_LAST_VALUE, tag_keys=("kind", "status")),
        View("sync_duration_seconds", SYNC_DURATION_M, AGG_DISTRIBUTION,
             buckets=_SYNC_BUCKETS),
        View("sync_last_run_time", SYNC_LAST_RUN_M, AGG_LAST_VALUE),
        View("watch_manager_watched_gvk", WATCHED_GVK_M, AGG_LAST_VALUE),
        View("watch_manager_intended_watch_gvk", INTENDED_GVK_M,
             AGG_LAST_VALUE),
        View("audit_last_run_status", AUDIT_STATUS_M, AGG_LAST_VALUE),
        View("audit_consecutive_failures", AUDIT_FAILS_M, AGG_LAST_VALUE),
        View("tpu_breaker_state", BREAKER_STATE_M, AGG_LAST_VALUE),
        View("tpu_breaker_trips", BREAKER_TRIPS_M, AGG_LAST_VALUE),
        View("tpu_breaker_degraded_seconds", BREAKER_DEGRADED_M,
             AGG_LAST_VALUE),
        View("webhook_batch_queue_seconds", WEBHOOK_QUEUE_M,
             AGG_DISTRIBUTION, buckets=_STAGE_BUCKETS),
        View("webhook_batch_size", BATCH_SIZE_M, AGG_DISTRIBUTION,
             buckets=_BATCH_SIZE_BUCKETS),
        View("tpu_pack_seconds", PACK_M, AGG_DISTRIBUTION,
             tag_keys=("path",), buckets=_STAGE_BUCKETS),
        View("tpu_compile_seconds", COMPILE_M, AGG_DISTRIBUTION,
             tag_keys=("path",), buckets=_STAGE_BUCKETS),
        View("tpu_dispatch_seconds", DISPATCH_M, AGG_DISTRIBUTION,
             tag_keys=("path", "tier"), buckets=_STAGE_BUCKETS),
        View("cache_requests_total", CACHE_M, AGG_COUNT,
             tag_keys=("cache", "outcome")),
        View("render_cells_total", RENDER_CELLS_M, AGG_COUNT,
             tag_keys=("plan",)),
        View("snapshot_write_seconds", SNAPSHOT_WRITE_M, AGG_DISTRIBUTION,
             buckets=_SNAPSHOT_BUCKETS),
        View("snapshot_load_seconds", SNAPSHOT_LOAD_M, AGG_DISTRIBUTION,
             buckets=_SNAPSHOT_BUCKETS),
        View("snapshot_bytes", SNAPSHOT_BYTES_M, AGG_LAST_VALUE),
        View("snapshot_restore_outcome_total", SNAPSHOT_RESTORE_M, AGG_COUNT,
             tag_keys=("outcome",)),
        View("cost_device_ms", COST_DEVICE_MS_M, AGG_LAST_VALUE,
             tag_keys=("template",)),
        View("cost_render_ms", COST_RENDER_MS_M, AGG_LAST_VALUE,
             tag_keys=("template",)),
        View("cost_cells", COST_CELLS_M, AGG_LAST_VALUE,
             tag_keys=("template",)),
        View("cost_render_cells", COST_RENDER_CELLS_M, AGG_LAST_VALUE,
             tag_keys=("template", "plan")),
        View("cost_violations", COST_VIOLATIONS_M, AGG_LAST_VALUE,
             tag_keys=("template",)),
        View("cost_memo_hit_ratio", COST_MEMO_HIT_RATIO_M, AGG_LAST_VALUE,
             tag_keys=("template",)),
        View("audit_shard_rows", AUDIT_SHARD_ROWS_M, AGG_DISTRIBUTION,
             tag_keys=("path",), buckets=_SHARD_ROWS_BUCKETS),
        View("audit_shard_pack_seconds", AUDIT_SHARD_PACK_M,
             AGG_DISTRIBUTION, tag_keys=("path",), buckets=_STAGE_BUCKETS),
        View("audit_shard_dispatch_seconds", AUDIT_SHARD_DISPATCH_M,
             AGG_DISTRIBUTION, tag_keys=("path",), buckets=_STAGE_BUCKETS),
        View("replica_up", REPLICA_UP_M, AGG_LAST_VALUE,
             tag_keys=("replica_id",)),
        View("webhook_batch_target_size", BATCH_TARGET_M, AGG_LAST_VALUE,
             tag_keys=("replica_id",)),
        View("webhook_batch_deadline_ms", BATCH_DEADLINE_M, AGG_LAST_VALUE,
             tag_keys=("replica_id",)),
        View("webhook_offered_load_rps", OFFERED_LOAD_M, AGG_LAST_VALUE,
             tag_keys=("replica_id",)),
        View("slo_burn_rate", SLO_BURN_M, AGG_LAST_VALUE,
             tag_keys=("objective", "window")),
        View("slo_error_budget_remaining", SLO_BUDGET_M, AGG_LAST_VALUE,
             tag_keys=("objective",)),
        View("audit_last_run_age_s", AUDIT_AGE_M, AGG_LAST_VALUE),
        View("fleet_replica_restarts_total", REPLICA_RESTARTS_M, AGG_COUNT,
             tag_keys=("replica_id", "reason")),
        View("fleet_replica_state", REPLICA_STATE_M, AGG_LAST_VALUE,
             tag_keys=("replica_id",)),
        View("mesh_dispatch_stalls_total", MESH_STALL_M, AGG_COUNT),
        View("mesh_sweep_width", MESH_WIDTH_M, AGG_LAST_VALUE),
        View("frontdoor_stage_seconds", FRONTDOOR_STAGE_M,
             AGG_DISTRIBUTION, tag_keys=("stage",), buckets=_STAGE_BUCKETS),
        View("frontdoor_requests_total", FRONTDOOR_REQS_M, AGG_COUNT,
             tag_keys=("outcome", "backend")),
        View("fleet_scrape_ok", FLEET_SCRAPE_OK_M, AGG_LAST_VALUE,
             tag_keys=("replica_id",)),
        View("fleet_scrape_age_seconds", FLEET_SCRAPE_AGE_M,
             AGG_LAST_VALUE, tag_keys=("replica_id",)),
        View("fleet_replicas_scraped", FLEET_SCRAPED_M, AGG_LAST_VALUE),
        View("fleet_admission_requests", FLEET_ADMISSIONS_M,
             AGG_LAST_VALUE),
        View("profiler_samples_total", PROFILER_SAMPLES_M, AGG_COUNT),
        View("profiler_overflow_total", PROFILER_OVERFLOW_M, AGG_COUNT),
        View("shed_total", SHED_M, AGG_COUNT, tag_keys=("reason",)),
        View("brownout_level", BROWNOUT_M, AGG_LAST_VALUE),
        View("frontdoor_retry_tokens", RETRY_TOKENS_M, AGG_LAST_VALUE),
        View("frontdoor_retries_denied_total", RETRY_DENIED_M, AGG_COUNT),
        View("route_decisions_total", ROUTE_DECISIONS_M, AGG_COUNT,
             tag_keys=("tier", "reason")),
        View("join_plans", JOIN_PLANS_M, AGG_LAST_VALUE),
        View("join_delta_affected_rows_total", JOIN_AFFECTED_M, AGG_COUNT),
        View("join_plan_divergence_total", JOIN_DIVERGENCE_M, AGG_COUNT),
        View("compile_epoch_lag", COMPILE_LAG_M, AGG_LAST_VALUE),
        View("device_bytes", DEVICE_BYTES_M, AGG_LAST_VALUE,
             tag_keys=("component",)),
        View("xlacache_counters_available", XLA_COUNTERS_M,
             AGG_LAST_VALUE),
        View("decision_log_records_total", DECISION_RECORDS_M, AGG_COUNT,
             tag_keys=("class",)),
        View("decision_log_dropped_total", DECISION_DROPPED_M, AGG_COUNT,
             tag_keys=("reason",)),
        View("decision_log_segments_total", DECISION_SEGMENTS_M,
             AGG_COUNT),
        View("decision_log_bytes_total", DECISION_BYTES_M, AGG_COUNT),
        View("evloop_lag_seconds", EVLOOP_LAG_M, AGG_LAST_VALUE,
             tag_keys=("loop",)),
        View("evloop_tick_seconds", EVLOOP_TICK_M, AGG_DISTRIBUTION,
             tag_keys=("loop",), buckets=_STAGE_BUCKETS),
        View("evloop_utilization", EVLOOP_UTIL_M, AGG_LAST_VALUE,
             tag_keys=("loop",)),
        View("evloop_callbacks_per_tick", EVLOOP_CBS_M, AGG_DISTRIBUTION,
             tag_keys=("loop",), buckets=_BATCH_SIZE_BUCKETS),
        View("evloop_timer_drift_seconds", EVLOOP_DRIFT_M,
             AGG_DISTRIBUTION, tag_keys=("loop",), buckets=_STAGE_BUCKETS),
        View("evloop_slow_callbacks_total", EVLOOP_SLOW_M, AGG_COUNT,
             tag_keys=("loop",)),
        View("evloop_stalls_total", EVLOOP_STALLS_M, AGG_COUNT,
             tag_keys=("loop",)),
        View("wire_chunks_total", WIRE_CHUNKS_M, AGG_COUNT,
             tag_keys=("end", "kind")),
        View("wire_chunk_records", WIRE_RECORDS_M, AGG_DISTRIBUTION,
             tag_keys=("end", "kind"), buckets=_BATCH_SIZE_BUCKETS),
        View("wire_bytes_total", WIRE_BYTES_M, AGG_COUNT,
             tag_keys=("end", "direction")),
        View("wire_decode_errors_total", WIRE_DECODE_ERRORS_M, AGG_COUNT,
             tag_keys=("end",)),
        View("wire_reconnects_total", WIRE_RECONNECTS_M, AGG_COUNT,
             tag_keys=("backend",)),
        View("wire_backlog_stall_seconds", WIRE_BACKLOG_STALL_M,
             AGG_DISTRIBUTION, tag_keys=("backend",),
             buckets=_STAGE_BUCKETS),
    ]


# views whose `template`/`constraint` labels are produced ONLY by the
# top-K-capped cost-ledger collector (obs/costs.py) — the label-
# cardinality lint (tools/check_observability.py) requires every view
# carrying such a tag key to be declared here
CAPPED_CARDINALITY_VIEWS = {
    "cost_device_ms",
    "cost_render_ms",
    "cost_cells",
    "cost_render_cells",
    "cost_violations",
    "cost_memo_hit_ratio",
}


def register_catalog(registry: Optional[Registry] = None) -> Registry:
    registry = registry or global_registry()
    registry.register(*catalog_views())
    return registry


class Reporters:
    """The facade the controllers/webhook/audit call.

    Collapses the reference's per-package StatsReporter types into one
    object with the per-consumer report methods the call sites use.
    """

    def __init__(self, registry: Optional[Registry] = None):
        self.registry = register_catalog(registry)
        self._sync_kinds: set = set()

    # -- constraint controller (report_constraints(totals)) ------------------
    def report_constraints(self, totals: Dict[tuple, int]):
        """totals: {(enforcement_action, status): count} — the reference
        reports every (action,status) cell each reconcile
        (constraint_controller.go:425-473)."""
        for (action, status), n in totals.items():
            self.registry.record(
                CONSTRAINTS_M, float(n),
                {"enforcement_action": action, "status": status},
            )

    # -- constrainttemplate controller ---------------------------------------
    def report_templates(self, status: str, count: int):
        self.registry.record(CT_M, float(count), {"status": status})

    def report_ingestion(self, status: str, duration_s: float):
        self.registry.record(
            INGEST_DURATION_M, duration_s, {"status": status}
        )

    # -- webhook --------------------------------------------------------------
    def report_request(self, admission_status: str, duration_s: float):
        self.registry.record(
            REQUEST_DURATION_M, duration_s,
            {"admission_status": admission_status},
            exemplar_trace_id=_current_trace_id(),
        )

    # -- audit ----------------------------------------------------------------
    def report_audit_status(self, ok: bool, consecutive_failures: int):
        """Last-run status + consecutive-failure gauge: a silently failing
        audit loop (bare except around audit_once) becomes observable."""
        self.registry.record(AUDIT_STATUS_M, 1.0 if ok else 0.0)
        self.registry.record(AUDIT_FAILS_M, float(consecutive_failures))

    def report_total_violations(self, enforcement_action: str, count: int):
        self.registry.record(
            VIOLATIONS_M, float(count),
            {"enforcement_action": enforcement_action},
        )

    def report_audit_duration(self, duration_s: float):
        self.registry.record(AUDIT_DURATION_M, duration_s)

    def report_audit_last_run(self, ts: Optional[float] = None):
        self.registry.record(AUDIT_LAST_RUN_M,
                             ts if ts is not None
                             else time.time())  # wall-clock: ok (epoch gauge)

    # -- sync controller ------------------------------------------------------
    def report_sync(self, counts: Dict[object, int],
                    duration_s: Optional[float] = None):
        """duration_s=None means a bookkeeping-only update (e.g. prune):
        gauge rows refresh but no latency sample is recorded."""
        kinds = set()
        for gvk, n in counts.items():
            kind = gvk[2] if isinstance(gvk, tuple) and len(gvk) == 3 else str(gvk)
            kinds.add(kind)
            self.registry.record(
                SYNC_M, float(n), {"kind": kind, "status": "active"}
            )
        # retract gauge rows for kinds that left the sync set — last_value
        # rows otherwise report stale counts forever
        for kind in self._sync_kinds - kinds:
            self.registry.record(
                SYNC_M, 0.0, {"kind": kind, "status": "active"}
            )
        self._sync_kinds = kinds
        if duration_s is not None:
            self.registry.record(SYNC_DURATION_M, duration_s)
        self.registry.record(SYNC_LAST_RUN_M, time.time())  # wall-clock: ok (epoch gauge)

    # -- watch manager --------------------------------------------------------
    def report_gvk_count(self, watched: int, intended: int):
        self.registry.record(WATCHED_GVK_M, float(watched))
        self.registry.record(INTENDED_GVK_M, float(intended))

    # -- TPU circuit breaker --------------------------------------------------
    def report_breaker(self, status: dict):
        """Record a CircuitBreaker.status() snapshot."""
        record_breaker(status, self.registry)


def record_breaker(status: dict, registry: Optional[Registry] = None):
    """Record a breaker status snapshot against a registry (the global one
    by default).  The driver calls this from its transition hook without
    holding a Reporters instance; views are (idempotently) registered
    first so the rows exist wherever the snapshot lands."""
    registry = registry or global_registry()
    register_catalog(registry)
    registry.record(BREAKER_STATE_M, float(status.get("state_code", 0)))
    registry.record(BREAKER_TRIPS_M, float(status.get("trips", 0)))
    registry.record(
        BREAKER_DEGRADED_M, float(status.get("degraded_seconds", 0.0))
    )


# ---- hot-path stage/cache recording -------------------------------
# The driver, micro-batcher, and AOT cache record without a Reporters
# handle.  The global registry's catalog registration is memoized behind
# one boolean so the steady-state cost is the registry's indexed record.

_GLOBAL_READY = False


_TRACE_ID_FN = None


def _current_trace_id():
    """Trace id of the active span, for histogram exemplars — one
    ContextVar read once the import is memoized; None (no exemplar)
    outside a trace."""
    global _TRACE_ID_FN
    fn = _TRACE_ID_FN
    if fn is None:
        try:
            from ..obs.trace import current_trace_id as fn
        except Exception:  # pragma: no cover - degraded obs layer
            # memoize the failure too: a broken obs import must cost one
            # attribute read per record, not a re-raised import per
            # hot-path sample
            fn = lambda: None  # noqa: E731
        _TRACE_ID_FN = fn
    try:
        return fn()
    except Exception:  # pragma: no cover - telemetry never blocks eval
        return None


def _global() -> Registry:
    global _GLOBAL_READY
    registry = global_registry()
    if not _GLOBAL_READY:
        register_catalog(registry)
        _GLOBAL_READY = True
    return registry


#: site -> count of telemetry recordings swallowed by the record_* guards.
#: Swallowing is the contract (a metrics-layer defect must never fail the
#: evaluation being measured) but the swallow itself must be observable:
#: the first drop per site logs with the traceback, the rest only count.
RECORD_DROPS: Dict[str, int] = {}


def record_dropped(site: str) -> None:
    """Account one swallowed telemetry recording (see RECORD_DROPS)."""
    try:
        n = RECORD_DROPS.get(site, 0) + 1
        RECORD_DROPS[site] = n
        if n == 1:
            import logging

            logging.getLogger("gatekeeper.metrics").warning(
                "telemetry recording failed at %s (guarded by contract; "
                "further drops only counted)", site, exc_info=True,
            )
    # the drop ACCOUNTING itself must never raise back into the hot path
    # gklint: disable=swallowed-exception -- last-ditch guard under a guard
    except Exception:
        pass


def record_stage(measure: Measure, seconds: float,
                 tags: Optional[Dict[str, str]] = None):
    """One stage-duration sample into the new per-stage histograms
    (tpu_pack_seconds / tpu_dispatch_seconds / tpu_compile_seconds /
    webhook_batch_queue_seconds), exemplar-linked to the active trace.
    Guarded: a metrics-layer defect must never fail the admission/audit
    evaluation that is being measured."""
    try:
        _global().record(
            measure, seconds, tags,
            exemplar_trace_id=_current_trace_id(),
        )
    except Exception:  # telemetry never blocks eval
        record_dropped("record_stage")


def record_batch_size(n: int):
    try:
        _global().record(BATCH_SIZE_M, float(n))
    except Exception:  # telemetry never blocks eval
        record_dropped("record_batch_size")


def record_snapshot_write(seconds: float, nbytes: int):
    """One completed snapshot write (the background snapshotter records
    without a Reporters handle).  Guarded like record_stage."""
    try:
        reg = _global()
        reg.record(SNAPSHOT_WRITE_M, seconds)
        reg.record(SNAPSHOT_BYTES_M, float(nbytes))
    except Exception:  # telemetry never blocks eval
        record_dropped("record_snapshot_write")


def record_snapshot_load(seconds: float):
    try:
        _global().record(SNAPSHOT_LOAD_M, seconds)
    except Exception:  # telemetry never blocks eval
        record_dropped("record_snapshot_load")


def record_snapshot_outcome(outcome: str):
    """One restore attempt: outcome in (restored, fallback, none,
    disabled)."""
    try:
        _global().record(SNAPSHOT_RESTORE_M, 1.0, {"outcome": outcome})
    except Exception:  # telemetry never blocks eval
        record_dropped("record_snapshot_outcome")
    try:
        from ..obs import flightrec

        flightrec.record(flightrec.SNAPSHOT_RESTORE, outcome=outcome)
    except Exception:  # the recorder must never fail a restore
        record_dropped("record_snapshot_outcome.flightrec")


def record_render_cells(counts: Dict[str, int]):
    """One render pass's cell counts by plan tier ({tier: n}); the driver
    accumulates per-cell increments locally and flushes once per pass so
    the render hot loop never pays a registry record per cell.  Guarded
    like record_stage."""
    try:
        reg = _global()
        for tier, n in counts.items():
            if n > 0:
                reg.record(
                    RENDER_CELLS_M, float(n), {"plan": tier}, count=n
                )
    except Exception:  # telemetry never blocks eval
        record_dropped("record_render_cells")


def record_audit_shard(rows: int, pack_s: float, dispatch_s: float,
                       path: str = "audit"):
    """One shard's slice through the double-buffered placement pipeline
    (parallel/mesh.py): its slab's row count, host pack time and device
    commit time.  Guarded like record_stage."""
    try:
        reg = _global()
        tags = {"path": path}
        tid = _current_trace_id()
        reg.record(AUDIT_SHARD_ROWS_M, float(rows), tags,
                   exemplar_trace_id=tid)
        reg.record(AUDIT_SHARD_PACK_M, pack_s, tags, exemplar_trace_id=tid)
        reg.record(AUDIT_SHARD_DISPATCH_M, dispatch_s, tags,
                   exemplar_trace_id=tid)
    except Exception:  # telemetry never blocks eval
        record_dropped("record_audit_shard")


def _replica_tags() -> Dict[str, str]:
    from ..util import replica_id

    return {"replica_id": replica_id()}


def record_replica_up():
    """Stamp this process's replica identity (App.start; also the fleet
    replica runtime).  Guarded like record_stage."""
    try:
        _global().record(REPLICA_UP_M, 1.0, _replica_tags())
    except Exception:  # telemetry never blocks startup
        record_dropped("record_replica_up")


def record_batcher_state(target_size: int, deadline_ms: float,
                         offered_load_rps: float):
    """The micro-batcher's current adaptation state (one record per
    dispatch, NOT per request — the batcher throttles).  Guarded like
    record_stage."""
    try:
        reg = _global()
        tags = _replica_tags()
        reg.record(BATCH_TARGET_M, float(target_size), tags)
        reg.record(BATCH_DEADLINE_M, float(deadline_ms), tags)
        reg.record(OFFERED_LOAD_M, float(offered_load_rps), tags)
    except Exception:  # telemetry never blocks eval
        record_dropped("record_batcher_state")


def record_replica_restart(replica_id: str, reason: str):
    """One supervisor-initiated replica restart (reason: crash, wedge,
    rolling).  Guarded like record_stage."""
    try:
        _global().record(
            REPLICA_RESTARTS_M, 1.0,
            {"replica_id": replica_id, "reason": reason},
        )
    except Exception:  # telemetry never blocks healing
        record_dropped("record_replica_restart")


def record_replica_state(replica_id: str, state_code: int):
    """The supervisor's current view of one replica (0 running,
    1 restarting, 2 quarantined, 3 draining, 4 stopped)."""
    try:
        _global().record(
            REPLICA_STATE_M, float(state_code), {"replica_id": replica_id}
        )
    except Exception:  # telemetry never blocks healing
        record_dropped("record_replica_state")


def record_mesh_stall():
    """One mesh-collective dispatch abandoned by the watchdog."""
    try:
        _global().record(MESH_STALL_M, 1.0)
    except Exception:  # telemetry never blocks eval
        record_dropped("record_mesh_stall")


def record_mesh_width(width: int):
    """The sweep sharding width now serving device audits (set_mesh /
    degradation)."""
    try:
        _global().record(MESH_WIDTH_M, float(width))
    except Exception:  # telemetry never blocks eval
        record_dropped("record_mesh_width")


def record_frontdoor_stage(stage: str, seconds: float):
    """One wire-path stage interval at the fleet front door (stage in
    frontdoor.WIRE_STAGES), exemplar-linked to the active wire trace.
    Guarded like record_stage."""
    try:
        _global().record(
            FRONTDOOR_STAGE_M, seconds, {"stage": stage},
            exemplar_trace_id=_current_trace_id(),
        )
    except Exception:  # telemetry never blocks the wire path
        record_dropped("record_frontdoor_stage")


_FRONTDOOR_STAGE_OBS = None


def record_frontdoor_stages(samples, exemplar_trace_id=None):
    """A batch of wire-stage intervals in ONE registry lock hold
    (samples: [(stage, seconds)] with stage in frontdoor.WIRE_STAGES) —
    the event-loop door flushes a whole reactor tick's stage observes
    through here instead of one record_frontdoor_stage round-trip per
    interval.  The prebound observer memoizes per-stage row keys.
    Guarded like record_stage."""
    global _FRONTDOOR_STAGE_OBS
    try:
        obs = _FRONTDOOR_STAGE_OBS
        if obs is None:
            obs = _FRONTDOOR_STAGE_OBS = _global().observer(
                FRONTDOOR_STAGE_M, "stage")
        obs(samples, exemplar_trace_id=exemplar_trace_id)
    except Exception:  # telemetry never blocks the wire path
        record_dropped("record_frontdoor_stages")


def record_frontdoor_requests(counts):
    """Tick-batched request outcomes from the event-loop door: counts
    maps (outcome, backend) -> n, flushed once per reactor tick so the
    hot path pays a dict increment instead of a registry lock per
    request.  Guarded like record_stage."""
    try:
        reg = _global()
        for (outcome, backend), n in counts.items():
            reg.record(
                FRONTDOOR_REQS_M, 1.0,
                {"outcome": outcome, "backend": backend}, count=n,
            )
    except Exception:  # telemetry never blocks the wire path
        record_dropped("record_frontdoor_requests")


def record_frontdoor_request(outcome: str, backend: str):
    """One request through the front door: outcome in (ok,
    backend_error, no_backend, bad_request); backend = the serving
    replica id ('' when none answered).  Guarded like record_stage."""
    try:
        _global().record(
            FRONTDOOR_REQS_M, 1.0,
            {"outcome": outcome, "backend": backend},
        )
    except Exception:  # telemetry never blocks the wire path
        record_dropped("record_frontdoor_request")


def record_scrape(replica_id: str, ok: bool, age_s: float):
    """One federated-scrape health sample for one replica exporter
    (obs/fleetobs.py): ok flag + staleness age.  Guarded like
    record_stage."""
    try:
        reg = _global()
        tags = {"replica_id": replica_id}
        reg.record(FLEET_SCRAPE_OK_M, 1.0 if ok else 0.0, tags)
        reg.record(FLEET_SCRAPE_AGE_M, float(age_s), tags)
    except Exception:  # telemetry never blocks the scrape
        record_dropped("record_scrape")


def record_fleet_rollup(replicas_scraped: int, admission_requests: float):
    """The federator's per-pass fleet rollups.  Guarded like
    record_stage."""
    try:
        reg = _global()
        reg.record(FLEET_SCRAPED_M, float(replicas_scraped))
        reg.record(FLEET_ADMISSIONS_M, float(admission_requests))
    except Exception:  # telemetry never blocks the scrape
        record_dropped("record_fleet_rollup")


def record_profiler(samples: int, overflow: int = 0):
    """One profiler tick's accounting: samples collected + samples
    dropped on the unique-stack bound.  Guarded like record_stage."""
    try:
        reg = _global()
        if samples > 0:
            reg.record(PROFILER_SAMPLES_M, float(samples), count=samples)
        if overflow > 0:
            reg.record(PROFILER_OVERFLOW_M, float(overflow),
                       count=overflow)
    except Exception:  # telemetry never blocks the sampler
        record_dropped("record_profiler")


def record_shed(reason: str, n: int = 1):
    """n requests refused by the overload plane for one reason
    (shed_total{reason}; docs/failure-modes.md shed order).  Also feeds
    the brownout controller's shed-rate signal.  Guarded like
    record_stage."""
    if n <= 0:
        return
    try:
        _global().record(SHED_M, float(n), {"reason": reason}, count=n)
    except Exception:  # telemetry never blocks the shed path
        record_dropped("record_shed")
    try:
        from ..obs.brownout import note_shed

        note_shed(n)
    except Exception:  # the ladder signal must never fail the refusal
        record_dropped("record_shed.brownout")
    try:
        from ..obs import flightrec

        flightrec.note_shed(reason, n)  # coalesced into burst events
    except Exception:  # the recorder must never fail the refusal
        record_dropped("record_shed.flightrec")


def record_brownout_level(level: int):
    """The brownout controller's current ladder level (recorded on every
    transition and on controller start)."""
    try:
        _global().record(BROWNOUT_M, float(level))
    except Exception:  # telemetry never blocks degradation
        record_dropped("record_brownout_level")


def record_retry_budget(tokens: float):
    """The front door's current retry-budget bucket level."""
    try:
        _global().record(RETRY_TOKENS_M, float(tokens))
    except Exception:  # telemetry never blocks the wire path
        record_dropped("record_retry_budget")


def record_retry_denied():
    """One front-door retry denied on an empty retry budget."""
    try:
        _global().record(RETRY_DENIED_M, 1.0)
    except Exception:  # telemetry never blocks the wire path
        record_dropped("record_retry_denied")


def record_route_decision(tier: str, reason: str):
    """One routing decision (route_decisions_total{tier,reason}; fed per
    batch by obs/routeledger.py).  Guarded like record_stage."""
    try:
        _global().record(
            ROUTE_DECISIONS_M, 1.0, {"tier": tier, "reason": reason}
        )
    except Exception:  # telemetry never blocks eval
        record_dropped("record_route_decision")


def set_join_plans(n: int):
    """Active referential join plans (join_plans gauge; set when the
    driver's join index syncs, ops/joinkernel.py)."""
    try:
        _global().record(JOIN_PLANS_M, float(n))
    except Exception:  # telemetry never blocks a sweep
        record_dropped("set_join_plans")


def record_join_affected(rows: int):
    """Key-group reader rows co-dispatched by one delta sweep
    (join_delta_affected_rows_total)."""
    try:
        _global().record(JOIN_AFFECTED_M, float(rows), count=int(rows))
    except Exception:  # telemetry never blocks a sweep
        record_dropped("record_join_affected")


def record_join_divergence(kind: str):
    """One exact-join-plan cell the oracle refused to render
    (join_plan_divergence_total); the template kind goes to the log, not
    a label (unbounded cardinality)."""
    try:
        _global().record(JOIN_DIVERGENCE_M, 1.0)
        import logging

        logging.getLogger("gatekeeper.joinkernel").warning(
            "join-plan divergence: %s flagged a cell the interpreter "
            "renders empty", kind,
        )
    except Exception:  # telemetry never blocks rendering
        record_dropped("record_join_divergence")


def record_compile_lag(lag: int):
    """The async compiler's epoch backlog (compile_epoch_lag gauge)."""
    try:
        _global().record(COMPILE_LAG_M, float(lag))
    except Exception:  # telemetry never blocks a mutation
        record_dropped("record_compile_lag")


def record_device_bytes(component: str, nbytes: int):
    """Device-resident bytes for one placement component
    (device_bytes{component} gauge, fed by obs/compilestats.py)."""
    try:
        _global().record(
            DEVICE_BYTES_M, float(nbytes), {"component": component}
        )
    except Exception:  # telemetry never blocks a placement
        record_dropped("record_device_bytes")


def record_xla_counters_available(ok: bool):
    """Whether jax's persistent-cache monitoring counters exist on this
    build (the xlacache silent-absence contract, ops/xlacache.py)."""
    try:
        _global().record(XLA_COUNTERS_M, 1.0 if ok else 0.0)
    except Exception:  # telemetry never blocks cache setup
        record_dropped("record_xla_counters_available")


def record_decision_record(dclass: str, n: int = 1):
    """n decision records accepted by the decision log in one batch
    (decision_log_records_total{class}; obs/decisionlog.py flushes its
    hot-path counts batched)."""
    if n <= 0:
        return
    try:
        _global().record(DECISION_RECORDS_M, float(n), {"class": dclass},
                         count=n)
    except Exception:  # telemetry never blocks the verdict
        record_dropped("record_decision_record")


def record_decision_dropped(reason: str, n: int = 1):
    """n decision records not written, by reason
    (decision_log_dropped_total{reason}) — sampling, queue sheds and
    write failures are all counted drops, never silent."""
    if n <= 0:
        return
    try:
        _global().record(DECISION_DROPPED_M, float(n), {"reason": reason},
                         count=n)
    except Exception:  # telemetry never blocks the verdict
        record_dropped("record_decision_dropped")


def record_decision_segment(nbytes: int):
    """One completed decision-log segment of nbytes committed."""
    try:
        _global().record(DECISION_SEGMENTS_M, 1.0)
        _global().record(DECISION_BYTES_M, float(nbytes),
                         count=max(int(nbytes), 0))
    except Exception:  # telemetry never blocks rotation
        record_dropped("record_decision_segment")


def record_cache(cache: str, hit: bool, n: int = 1):
    """n hit/miss outcomes for one named cache (request_memo, aotcache,
    xlacache) in one lock hold.  Guarded like record_stage."""
    if n <= 0:
        return
    try:
        _global().record(
            CACHE_M, float(n),
            {"cache": cache, "outcome": "hit" if hit else "miss"},
            count=n,
        )
    except Exception:  # telemetry never blocks eval
        record_dropped("record_cache")


# ---- reactor observability plane ---------------------------------

_EVLOOP_TICK_OBS = None
_EVLOOP_CBS_OBS = None
_EVLOOP_DRIFT_OBS = None


def record_evloop_flush(loop: str, utilization: float,
                        tick_samples, cb_samples, drift_samples):
    """One reactor telemetry flush window (obs/reactorobs.py, every
    FLUSH_S): the utilization gauge plus the window's sampled tick /
    callbacks-per-tick / timer-drift observes, each batch through a
    prebound single-tag observer so the reactor thread pays a handful
    of lock holds per window, never one per tick.  Guarded like
    record_stage."""
    global _EVLOOP_TICK_OBS, _EVLOOP_CBS_OBS, _EVLOOP_DRIFT_OBS
    try:
        reg = _global()
        reg.record(EVLOOP_UTIL_M, float(utilization), {"loop": loop})
        if tick_samples:
            obs = _EVLOOP_TICK_OBS
            if obs is None:
                obs = _EVLOOP_TICK_OBS = reg.observer(EVLOOP_TICK_M,
                                                      "loop")
            obs([(loop, s) for s in tick_samples])
        if cb_samples:
            obs = _EVLOOP_CBS_OBS
            if obs is None:
                obs = _EVLOOP_CBS_OBS = reg.observer(EVLOOP_CBS_M, "loop")
            obs([(loop, float(s)) for s in cb_samples])
        if drift_samples:
            obs = _EVLOOP_DRIFT_OBS
            if obs is None:
                obs = _EVLOOP_DRIFT_OBS = reg.observer(EVLOOP_DRIFT_M,
                                                       "loop")
            obs([(loop, s) for s in drift_samples])
    except Exception:  # telemetry never blocks the reactor
        record_dropped("record_evloop_flush")


def record_evloop_lag(loop: str, lag_s: float):
    """One heartbeat skew sample — THE loop-lag gauge (at most a few
    per second per loop, so it records directly).  Guarded like
    record_stage."""
    try:
        _global().record(EVLOOP_LAG_M, float(lag_s), {"loop": loop})
    except Exception:  # telemetry never blocks the reactor
        record_dropped("record_evloop_lag")


def record_evloop_slow_callback(loop: str, n: int = 1):
    """n reactor callbacks over the slow-callback threshold."""
    if n <= 0:
        return
    try:
        _global().record(EVLOOP_SLOW_M, float(n), {"loop": loop},
                         count=n)
    except Exception:  # telemetry never blocks the reactor
        record_dropped("record_evloop_slow_callback")


def record_evloop_stall(loop: str):
    """One watchdog-caught reactor stall (the incident counter; the
    watchdog thread also dumps the flight recorder)."""
    try:
        _global().record(EVLOOP_STALLS_M, 1.0, {"loop": loop})
    except Exception:  # telemetry never blocks the watchdog
        record_dropped("record_evloop_stall")


def record_wire_flush(end: str, counts: Dict[str, int],
                      record_samples=None):
    """One end's GKW1 wire-telemetry window (tick-batched on the
    reactor threads, flushed on the reactorobs cadence).  ``counts``
    keys: request_chunks, response_chunks, bytes_in, bytes_out,
    decode_errors (absent/zero keys skip); ``record_samples`` is
    [(kind, n_records)] feeding the chunk-batch-size histogram.
    Guarded like record_stage."""
    try:
        reg = _global()
        for key, kind in (("request_chunks", "request"),
                          ("response_chunks", "response")):
            n = int(counts.get(key, 0))
            if n > 0:
                reg.record(WIRE_CHUNKS_M, float(n),
                           {"end": end, "kind": kind}, count=n)
        for key, direction in (("bytes_in", "in"), ("bytes_out", "out")):
            n = int(counts.get(key, 0))
            if n > 0:
                reg.record(WIRE_BYTES_M, float(n),
                           {"end": end, "direction": direction}, count=n)
        n = int(counts.get("decode_errors", 0))
        if n > 0:
            reg.record(WIRE_DECODE_ERRORS_M, float(n), {"end": end},
                       count=n)
        if record_samples:
            for kind, nrec in record_samples:
                reg.record(WIRE_RECORDS_M, float(nrec),
                           {"end": end, "kind": kind})
    except Exception:  # telemetry never blocks the wire path
        record_dropped("record_wire_flush")


def record_wire_reconnect(backend: str):
    """One door-side wire-connection rebuild to a backend whose
    previous persistent connection was lost (rare; records directly)."""
    try:
        _global().record(WIRE_RECONNECTS_M, 1.0, {"backend": backend})
    except Exception:  # telemetry never blocks the wire path
        record_dropped("record_wire_reconnect")


def record_wire_backlog_stall(backend: str, seconds: float):
    """One completed door-side write-backlog episode: the span from a
    chunk write leaving bytes buffered until the backlog drained."""
    try:
        _global().record(WIRE_BACKLOG_STALL_M, float(seconds),
                         {"backend": backend})
    except Exception:  # telemetry never blocks the wire path
        record_dropped("record_wire_backlog_stall")
