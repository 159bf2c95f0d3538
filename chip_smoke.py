#!/usr/bin/env python3
"""Drive gatekeeper_tpu_torch's main path once on a CUDA card, and hold its
hand-written kernels against their plain PyTorch versions.

    python3 chip_smoke.py                 # 500 templates x 100k pods, cap 20
    python3 chip_smoke.py --profile       # plus a torch.profiler sweep
    python3 chip_smoke.py --templates 12 --pods 2000 \
        --parity-templates 6 --parity-pods 300 \
        --ref-templates 6 --ref-objects 3000      # a quick check

Phases (one line each; any failure exits non-zero, nothing is caught):
  1. the card: nvidia-smi's name and power limit, torch's device name
  2. the kernels' build (kernels/*.cu, one nvcc each, in parallel), and
     K7's grids (at least one block a SM)
  3. the main path through gatekeeper_tpu_torch.client.Client(TorchDriver()):
     its admissions forced onto the card (DEVICE_MIN_CELLS = 0; phase 15
     prices them), the synthetic corpus at 500 ConstraintTemplates x
     100,000 Pods, a cold
     audit_capped(20), warm sweeps (each one's stages and garbage-collector
     pauses, then as many again with the collector's old objects frozen),
     and admission reviews of unique pods (each one's constraint-side
     re-pack split out); K1, K9, K4 and K9's review mode must have
     launched on that run, K9 exactly once per evaluation (once a sweep,
     and once a review in its review mode, where it packs the review's
     masks in the same launch), K10 never on a review (its side has
     groups) and never in a sweep, and vexpr.eval_program never (NoIR).
     Then the same pods again, each a request-memo hit (no launch, the
     same results, its own p50 and p99), no batch diverted from the card
     and the breaker closed; then the same reviews with the memos emptied
     and one batch of 256 pods, K9's packing calls recorded
  4. each kernel against its plain version on the card, on the inputs the
     main path gave it, exactly (every output is bool or int32): K1 and K9
     on the cold sweep (every group) and on one one-pod review, K2 and K3
     on the cells K9 ran their device functions in (cell_calls); its time
     over CUDA events, the plain version's, one library call's where one
     computes the same function, and the least time the card could take,
     K1 and K9's review mode also at the review's call (admission is the
     latency path); K9's review mode on every recorded review call, timed
     at a review's call (R = 8) and at the batch's (R = 256), each beside
     K9 then K10 on the same inputs (the chain before the fold) and the
     fused launch with its row limit lifted; K10 on the same masks, with
     no group (K9 not launched), timed at both;
     then again on seeded edge cases the main path does not reach (K9:
     every node kind, groups with pad rows and rows of no group, R of 1, 8
     and 16 and off its tiles, rows of one thread or one warp that disagree,
     S = 0, P = 0, a key set of 12, unbound joins, a deep
     stack; K9's review mode: R of 1, 7, 8, 9, 256 and 4,099, C of 1
     and 3, a group of no rows and rows of no group, masks all true, all
     false and random, grids of one block and of many, an unaligned
     autoreject mask, and K10 alone where no group has rows; K9's delta
     mode: w of 8, 13, 16, 64, 256 and 512, C of 1 and 3, indices at 0,
     at the last column and padded, rows of no group, and K5 alone where
     no group has rows and after K9 past a row limit; K1: R off its
     8 reviews a thread; K10: R off a byte, C of 0, 1 and 3, masks all
     true, all false and random, unaligned row slices and buffers; K6:
     every leaf dtype and rank, units of every width, a leaf at an odd address,
     a unit table past 48 KB, 9,000 rows; K7 and its merge at vocabularies
     around their grid's chunks, with keys in a few chunks only, on every id
     and on none, the merge of 2, 3, 4 and 8 shard tables; K8 in both modes on
     the same queries, and its table mode's one launch over lookups of T = 0
     to 2^20, of different S and scope, and an empty one), and K1 once more
     at the main path's shape and at R =
     4099 on a corpus whose label and namespace selectors are live; B6's least
     time (the sweep as one function, its mask kept inside) is logged beside
     the sum of K1's, K9's and K4's times
  5. the sweep's [C, 1+K] reduction against the same state evaluated and
     reduced through the plain versions on the card
  6. the incremental audit, the second path, at the same size: churn
     sweeps that change d stored pods before each (adds, modifications and
     deletions) for d in 1, 16 and 256, each through the delta path (K1
     and K9 evaluate the dirty rows, and K9's delta mode writes their
     before | after columns in the same launch: each delta sweep launches
     it once and K5 never, up to its row limit, ops/program.py
     DELTA_IN_K9_MAX_ROWS; past it, at d = 256, K9 and then K5); after each
     d a forced full sweep whose totals, results and counts must equal the
     delta path's; one sweep at d = 257, which must take the full path, and
     one full sweep after 256 changes with the delta path off (K6 patches
     the resident inputs); every kernel's launch count over that run must
     be > 0 for K9's delta mode and K6 and for K1 and K9, K9's equal to
     K1's.  Every call of K9's delta mode and K6 of that run is recorded
     and held against its plain version, and each is timed at its largest
     call (K9's delta mode at its largest width under the limit, beside
     K9 then K5 on the same inputs; K5 at d = 256); then one
     recorded
     delta sweep for each d holds K1, K9 (and K2, K3 on its cells) at the
     delta path's widths.  Then the device-stage split: the same paths
     with the op-by-op IR (OpByOp: vexpr.eval_program with K2 and K3, the
     path before K9) and with K9, in turns, in this run: forced full
     sweeps, churn sweeps for each d, and unique one-pod reviews.  Then
     the admission review's time split (review_split): one-pod reviews
     and batches of 8, 64 and 256 pods, driven step by step with a
     synchronise after each (pack, side placement, upload, K1, binding,
     K9 with the pack, download, unpack, render), the bool download of the same
     masks beside it, and reviews that intern a fresh string
  7. parity at a small size: audit and review results on the card against
     the port's own InterpDriver oracle, and the uncapped audit after 16
     changed pods, through the delta path
  8. the referential audit, the third path: 6 referential templates
     (unique ingress hosts, required storage classes, per-team pod
     quotas; two of each, cut from REF_r14's 24 to keep the run inside
     its limit on a slow host: the join plans and K7 and K8's shapes are
     the same) x 100,000 objects.  A cold sweep (K7 builds each join plan's
     key table, K8 looks each cell's count up), checked on the spot: each
     device table against the host join index of the same sweep, and the
     [C, 1+K] reduction against the all-plain path; warm forced full
     sweeps before and after gc.freeze(); churn sweeps through the join
     delta path, key-neutral and key-moving, for d in 1 and 16, each d
     closed by a forced full sweep that must equal it; one churn of a Pod
     of the crowded team, whose readers exceed DELTA_MAX_ROWS at this size,
     which must take the full path.  Each sweep logs its stages, rendered cells,
     results, join-affected rows and the join index's host time; the
     join_plans gauge must read 3 after the cold sweep and
     join_delta_affected_rows_total move by each churn sweep's
     join-affected rows (one more churn, an Ingress onto another's host,
     must re-evaluate that other reader).  Each
     delta sweep launches K8's table mode once (its lookups in one launch)
     and K9's delta mode once, K5 never (up to the row limit).  K7, K8 in both modes,
     K1, K9 (and its delta mode), K4 and K6 must have launched on that run,
     K9 as often as K1, and vexpr.eval_program never.  Every K7, K8 and K9
     call of the cold sweep and K8's and K9's of one key-moving delta sweep
     for each d are held against the plain versions, K7 and K8 (its dense
     mode) timed at their largest call, K8's table mode at the delta
     sweeps' largest, beside the same lookups each in a launch of its own;
     seeded edge cases are in phase 4.  The device-stage
     split of forced full and key-moving churn sweeps, op-by-op against
     K9.  Then parity against the oracle at 6 x 240 under
     GK_JOIN_ASSERT=1, capped, uncapped, and uncapped after churn through
     the join delta path
  9. the sharded sweep (parallel/mesh.py): both corpora of phases 3 and 8,
     at widths 2 and 4 on the virtual mesh of the one card
     (GK_VIRTUAL_DEVICES), and at up to 4 cards where more are visible.
     At each width a cold and a warm forced full sweep, whose results,
     totals, counts and [C, 1+K] first candidates must equal width 1's
     bit for bit (the memos emptied before each review batch), K1, K9 and
     K4 launched once a shard, K7 once a shard
     and its merge once a join plan, mesh_sweep_width reading the width,
     audit_shard_rows one observation a shard on the cold sweep's slab
     commit and none on a warm sweep; churn of d = 1 and 16 through the
     delta path, delta_rows the dirty rows (with the readers of the key
     groups they touch), delta_shards and K5's launches their owning
     shards (K9's delta mode none: each slab of the resident mask is
     gathered on its own shard), the synthetic corpus's added pods in the padded tail of the
     last slab, each d closed by a forced full sweep (K6 on the owning
     shards) that must equal it.  Every K4 call (row_offset) and K7 merge
     call of that run is held against its plain version and timed at its
     largest call, and K5 too, whose only launches on the counted paths
     these are.  Then one injected stall (the fault plane's
     MESH_DISPATCH_STALL hangs a review batch's guarded dispatch past a
     0.5 s watchdog at width 4): the numpy host tier answers the batch as
     width 1 does, the mesh narrows to 2, mesh_dispatch_stalls_total
     moves by one, the flight recorder holds one mesh_degrade event from
     4 to 2, and once the probe closes the breaker a forced full sweep at
     width 2 equals width 1.  Then reviews under the mesh: compute_masks of 4,096
     stored pods bit-equal and review_batch of 64 unique pods byte-equal
     to width 1, K9 packing once a shard, sharded_violation_counts
     against the mask sums, and the
     multi-process sweep: two processes of this script on gloo over
     loopback, each with a 2-slot virtual mesh of the card, each equal to
     its one-process sweep bit for bit
 10. the process: gatekeeper_tpu_torch.main.App, the process users deploy
     (--driver torch on the card, --audit-from-cache), over an API store
     filled as a restart finds it: the 500 templates and constraints of
     phase 3's corpus, a Config that syncs Pods, and the ~100,000 pods
     phase 3's client holds by now.  Its time from construction to
     /readyz, split into the kernels' load, template ingest and the pods'
     sync; its background calibration awaited (the model of its three
     tiers, its launches counted apart: K1 and K9 on each of its seven
     compute_masks, K10 after K9 on the warm-up of all its objects and at
     128 reviews), then its admissions forced onto the card; a cold audit
     cycle and warm ones; phase
     3's 256 pods as admission requests one at a time over one keep-alive
     HTTPS connection, then the same pods again (each a request-memo hit,
     no evaluation, its own p50 and p99), its batch pods from 8 client
     threads of 32 requests (the adaptive batcher awake: its batch sizes
     and requests/s), and 64 pods it has not seen sent while a forced
     full audit cycle holds the driver (each answer equal to phase 3's
     client's results for its pod, none an error, K1 and K9's review mode
     launched once for each review_batch call with a memo miss, no batch
     diverted, the breaker closed).  The App runs with
     --jax-profile-port: /memory's allocated bytes at least the App's
     resident pack (65,273,856 at 500 x 100k); capture (a) over 64
     fresh one-pod admissions and capture (b) over one forced full audit
     cycle, each GET /capture on its own thread with its traffic sent
     once the window is open and done before it closes: each trace's K1
     count equal to the window's match launches and its K9 count to its
     three launchers' (64 each in (a); K1, K9 and K4 once in (b)), no
     launch of the run outside the window, (b)'s K1, K9 and K4 median
     device times within 0.5-2x of phase 4's CUDA-event medians; each
     capture's busy share, kernels and five longest gaps logged (the
     traces gzipped into build/captures/).  Then
     churn of d = 1 and 16 pods written through the store, each cycle on
     the delta path, then a full cycle (K6); every cycle's constraint
     totals equal to phase 3's client's sweep of the same inventory.  The
     App runs with --snapshot-dir, its background writer stopped at start:
     after the last cycle its snapshotter writes once (the seconds, the
     bytes, and the time the resident mask takes to reach the host).  Then
     App.stop(), after which the collector must be enabled again
 11. the restart (snapshot/, warm resume): 16 pods churn in phase 10's
     store, and a second App over the same store and directory restores
     phase 10's snapshot: outcome "restored" with its delta basis,
     construction to /readyz beside phase 10's cold start (the restore's
     and the start's split, the collector's pauses), and a first cycle on
     the delta path (K1 and K9's delta mode once each, no full sweep)
     whose totals equal phase 3's client's after the same churn and
     whose results equal the App's own forced full sweep; the restored
     mask, uploaded by that cycle, equal on the card bit for bit to the
     one phase 10's App held when it wrote.  Then through the
     Client at a smaller depth: a basis written at width 2 of the virtual
     mesh restored at width 2 (its slabs back on their shards, churn on
     the delta path with K5 on the owning shards) and dropped at width 1
     (a full sweep, K4); the referential parity corpus (6 x 240 under
     GK_JOIN_ASSERT=1) restored with its join index, its first churn
     sweep launching K8's table mode, equal to the oracle.  Last the
     kernels' sealed build cache behind --xla-cache-dir, in fresh
     processes: an empty directory builds and seals the ten libraries,
     the next process loads them with no nvcc (ten hits), and a library
     whose seal was broken is rebuilt, not loaded
 12. the fleet (fleet/, obs/fleetobs.py): three webhook replicas (python
     -m gatekeeper_tpu_torch.fleet.replica, --driver torch on the card,
     the default flags with the brownout ladder on, spawned together by
     spawn_fleet) restore phase 10's snapshot
     (--snapshot-no-resync) and load phase 11's sealed kernels (ten hits,
     no miss, in each replica's /metrics).  Each replica runs under
     replica_watch, which counts in its process every review_batch with
     the launches it made, and answers a watch command on its pipe: each
     replica's driver on cuda:0 with memory in its allocator, the card's
     memory taken at least every replica's reserve and a context each;
     the collector's pauses in each before its ready line; each
     replica's background calibration awaited (its admissions forced onto
     the card once it landed).  Phase 3's 256 pods to
     every replica (every body the same bytes, each equal to phase 3's
     results) and again to the first (each a request-memo hit, the same
     bytes); pods of their own through the threaded FrontDoor and through
     the EventFrontDoor (framed chunks to each WireListener), each equal
     to phase 3's client's results; p50 and p99 one at a time and a burst
     of 8 clients of pods no replica has seen through each door.  The
     stream command (8,192 reviews in chunks of 2,048) on one replica,
     then on the three at once; then every admission batch of every
     replica that evaluated a memo miss must have launched K1 and K9
     (packing) once, one whose reviews all hit nothing, every stream
     chunk (the warm-up's included) K1, K9 and K10 once, its one
     calibration the known launches, no launch outside them, and no
     batch diverted (route_decisions_total in its /metrics).  Under a ReplicaSupervisor one replica is SIGKILLed:
     it must come back restored and on the card, answer the 256 pods
     byte for byte, no other replica respawned, and read brownout level
     0 with no edge alert from its ready line to 20 s past it (/statusz);
     drain replies drained.  One request of a pod no replica has seen,
     with a traceparent, through a door (every live replica at brownout
     level 0 with no edge alert firing): /debug/fleet-traces
     joins the door's wire stages with the replica's pack and dispatch,
     the first miss failing.  Each replica's reactor heartbeats over 50
     ms from its ready line on, each with the collections that overlapped
     it and whether a calibration was in flight, are logged after the
     calibration, the stream, the respawn and at the trace
     (fleet_stalls), and each replica's count on a line of its own at
     the end (fleet_stall_count).  The live replicas' launches checked
     again; the kernels line counts the replicas' own.  Every replica stopped,
     the card's memory back; then phase 3's client reviews one chunk of
     2,048 stored pods, K1, K9 and K10 once each, held exactly against
     the plain versions
 13. the serving seam, on phase 3's client: calibrate_routing (its model,
     its wall, K1 and K9 on each of its seven calls and K10 after K9 on
     the warm-up and at 128 reviews) and predicted_batch_ms at 1, 8 and 64 reviews beside
     review_batch walls of fresh pods, flagged at the stored corpus's
     share (0.05) and at 0.5; 64 fresh pods one at a time (each
     a request-memo miss, K1 and K9 once) and again (each a hit: no
     launch, the same bytes), then a real change of a constraint that
     flagged them: each stale entry repaired on the host, equal to the
     card's answers once the memos are emptied.  Then the breaker:
     TPU_DISPATCH errors injected through the fault plane (before any
     launch): the three failed reviews answer byte-equal to their answers
     with the breaker closed, the breaker opens, each divert served by
     the numpy host tier and counted as np|device_failed or
     np|breaker_open, no launch while it is open; the
     schedule cleared, the probe closes it (K1 and K9 once), and a review
     launches K1 and K9 again
 14. the wire: a KubeApiServer (kube/apiserver.py) in a child process,
     its store seeded there with deploy/gatekeeper.yaml's CRDs, phase
     10's templates, their constraint CRDs and constraints, a Config that
     syncs Pods and WIRE_PODS of the same seed's pods; two Apps in turn
     against it, each through --api-server http://... (HttpKube), --driver
     torch on the card, ready with every pod synced over the wire and its
     calibration landed.  App A (--audit-from-cache, its admissions forced
     onto the card): phase 3's 256 pods
     over HTTPS, each answer byte-equal to phase 10's but for its uid;
     two full audit cycles whose statuses, read back from the API server,
     equal a Client's audit_capped on the same inventory (built on the
     card before the counted run); its /metrics' tpu_pack_seconds
     {path="audit"} moving once a cycle and render_cells_total by the
     cycle's rendered plan and interpreter cells, /debug/costs naming
     templates, and each cycle's trace on /debug/traces carrying
     audit.pack, audit.dispatch, audit.fetch and audit.render, their
     durations equal to last_sweep_stats' pack_ms, device_ms (dispatch
     and fetch) and render_ms.  App B (--audit-chunk-size 500): its
     streamed audit pages the pods with continue tokens into
     review_batch, every status's totalViolations equal to the Client's
     uncapped audit and every violation it lists one that audit reports,
     every batch served by the card (forced, as App A's).  K1, K9 in its
     sweep and review modes, K4 and K10 must have launched; no batch
     diverted.  App A also runs with --decision-log-dir (sealed) and
     --snapshot-dir (the store's Config syncs Namespaces too, so the
     snapshot holds the namespace cache its admissions read), writing
     its snapshot after its cycles; once it stops,
     tools/replay_decisions_torch.py replays its log against that
     snapshot on the card in a child process (exit 0, no drift, every
     allow and deny record replayed, every replayed batch the device's)
     while another runs its --selftest on the card (zero drift, the
     seeded GK_BUG_COMPAT drift flagged, the fresh engine's batches the
     device's).
     The children are stopped on every way out
 15. the tiers, on phase 3's client with its admissions priced again:
     calibrate_routing's five numbers (the device's floor and rate, the
     numpy tier's floor and rate, the interpreter's rate) and the share
     of its wall the two host tiers take; 256 unique one-pod reviews
     routed live (on the card every one served by the device, its
     pricing recorded), priced as TpuDriver serves them
     (price_host_tiers on) and pinned to each tier (the device forced,
     the numpy tier, the interpreter), in turns, the memos emptied before
     each: each tier's count, p50 and p99 per pass, beside its
     prediction, every review's bytes equal across the five passes and a
     seeded 32 equal to the InterpDriver oracle's, K1 and K9 once for
     each review the card served and nothing for the host tiers'; the
     numpy side's masks of all 256 equal to compute_masks' on the card
     bit for bit; batches of 8, 64 and 256 fresh pods routed live (the
     card) and priced, in turns, each with its tier, both walls and every
     tier's prediction, the answers equal; the breaker forced open: a
     batch served by np, and with the numpy tier off by interp, each
     equal to the card's answers

 16. the operator's drills, over kernels built as Dockerfile.torch builds
     them: KERNEL_BAKE (device.use_cache_dir, device.build_kernels(force=
     True)) in a child process into a fresh directory, without
     GK_SEAL_KEY: ten sealed libraries, the directory 0700, no library
     needing libcudart (readelf: nvcc linked it statically).  Then the
     port's drills on the card, each in a child process with no directory
     holding nvcc on PATH, no CUDA_HOME, and the baked directory as every
     process's kernel cache (nvcc refused in each): fleet parity (both
     edges), self-heal, mesh parity and join parity at once, then
     overload (both edges) alone.  Each must exit 0; every process of a
     drill (under drill_watch, its replicas under replica_drill_watch)
     must have loaded the ten libraries sealed from the baked directory
     (ten hits, no miss, no build), every replica on cuda:0; the replica
     drills' review batches must have launched K1 and K9 (packing), the
     mesh drill K1, K9 and K4 (GK_VIRTUAL_DEVICES=4 slots of the one
     card, or four cards), the join drill K7 and K8.  Each drill's
     seconds and launches are logged, with the card's name and power
     limit

The line before the last holds the card's name and power limit as
nvidia-smi gives them, and the line before that the kernels' JSON
(launches summed over phases 3 and 6-16); the last line is {"ok": true,
"device": {...}}.  Without a CUDA card, or run from a directory that
lacks the package, it prints no result and exits 1.
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time
import types

ROOT = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks at the 700 W power limit.  HBM3: 3.35 TB/s (NVIDIA data
# sheet).  The kernels' operations are 32-bit integer compares, one
# instruction each.  The data sheet's 67 TFLOP/s float32 counts a fused
# multiply-add as two operations on 128 float32 lanes per SM; a Hopper SM
# has 64 INT32 lanes (NVIDIA H100 Tensor Core GPU Architecture
# whitepaper, "H100 SM architecture"), so at the same clock the integer
# rate is 67e12 / 2 / 2 = 16.75e12 instructions/s.
PEAK_BYTES_S = 3.35e12
PEAK_INT32_OPS_S = 67e12 / 4
# the device type the main path must run on
DEVICE = "cuda"
# the main path's settings: the audit's per-constraint violation cap (the
# reference's --constraint-violations-limit default), the corpus seed, warm
# sweeps in each set, unique admission reviews, and timed kernel calls
CAP = 20
SEED = 0
WARM = 5
REVIEWS = 256
REPS = 20
# the incremental audit's churn: pods changed before each sweep, sweeps
# for each, and the first count the delta path refuses (DELTA_MAX_ROWS + 1)
CHURN_D = (1, 16, 256)
CHURN_SWEEPS = 5
CHURN_FULL_D = 257
# device memory the caching allocator takes before the counted churn run
# and keeps: the recorder's copies (about 2.7 GB: the 134 MB mask for each
# delta sweep, the 65 MB resident tree twice for each row scatter, each
# copy one buffer) are cut from it, so no cudaMalloc runs inside a timed
# sweep
RECORD_RESERVE = 4 << 30
# the spin that puts a timed call's launches in the queue ahead of the card:
# about 1 ms at the H100's 1.98 GHz boost clock
QUEUE_CYCLES = 2_000_000
# the admission and sweep limits PERF.md holds the run against
SWEEP_LIMIT_S = 1.0
# the kernels of the first path (full sweeps and reviews); K2's and K3's
# cell functions run inside K9 there, and are checked standalone
PATH1_KERNELS = ("match", "program", "reduction")
# the device-stage split: rounds of each path with the op-by-op IR
# (OpByOp) and with K9, in turns, and unique reviews in each
SPLIT_ROUNDS = 4
SPLIT_REVIEWS = 64
# the admission review's time split: (pods a batch, batches) for one-pod
# reviews and batches of 8, 64 and 256 pods; reviews that each intern a
# fresh string (the constraint side re-packs and re-uploads)
REVIEW_SPLIT = ((1, 64), (8, 16), (64, 16), (256, 16))
FRESH_REVIEWS = 5
# the referential audit's churn: objects changed before each delta sweep,
# sweeps of each churn kind for each, and the oracle parity's size
# (templates, objects)
REF_CHURN_D = (1, 16)
REF_CHURN_SWEEPS = 5
REF_PARITY = (6, 240)
# the sharded sweep: mesh widths on the virtual mesh of the one card, churn
# on its delta path, reviews of the sharded masks and unique admission
# pods under the mesh, and the time the two processes of the
# multi-process sweep get
MESH_WIDTHS = (2, 4)
MESH_CHURN_D = (1, 16)
MESH_REVIEWS = 4096
MESH_ADMISSIONS = 64
MULTIHOST_TIMEOUT_S = 420
# the watchdog's budget for phase 9's injected stall: far above a review
# batch's sharded dispatch (milliseconds), far below the 10 s hang
MESH_WATCHDOG_S = 0.5


def log(phase: str, **fields):
    print(f"[{phase}] " + json.dumps(fields, sort_keys=True, default=str),
          flush=True)


class GcPauses:
    """A gc.callbacks hook: the pause time and the full (generation 2)
    collections since the last reset (``total_ms``: since it was made).
    With ``keep``, ``stamps`` also holds every pause as (wall time at its
    end, ms, generation), which ``before`` reduces."""

    def __init__(self, keep: bool = False):
        self._t0 = None
        self.total_ms = 0.0
        self.stamps = [] if keep else None
        self.reset()

    def reset(self):
        self.ms, self.gen2, self.max_ms = 0.0, 0, 0.0

    def __call__(self, phase, info):
        if phase == "start":
            self._t0 = time.perf_counter()
        elif self._t0 is not None:
            ms = (time.perf_counter() - self._t0) * 1e3
            self.ms += ms
            self.total_ms += ms
            self.max_ms = max(self.max_ms, ms)
            self.gen2 += info["generation"] == 2
            self._t0 = None
            if self.stamps is not None:
                self.stamps.append((time.time(), ms, info["generation"]))

    def take(self) -> dict:
        """The pauses since the last reset, then reset."""
        out = {"gc_ms": self.ms, "gc_max_ms": self.max_ms,
               "gc_gen2": self.gen2}
        self.reset()
        return out

    @staticmethod
    def before(stamps, wall: float) -> dict:
        """The kept pauses that ended by wall time ``wall``."""
        got = [(ms, g) for t, ms, g in stamps if t <= wall]
        return {"gc_ms": sum(ms for ms, _g in got),
                "gc_max_ms": max((ms for ms, _g in got), default=0.0),
                "gc_n": len(got),
                "gc_gen2": sum(1 for _ms, g in got if g == 2)}


def percentile(xs, q: float) -> float:
    """The q-th percentile of xs, nearest rank."""
    xs = sorted(xs)
    return xs[min(len(xs) - 1, max(0, math.ceil(len(xs) * q / 100) - 1))]


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 2, setup=None) -> float:
    """Median device time of fn() over CUDA events, one event pair per
    call, after warm-up calls.  The stream first spins for QUEUE_CYCLES,
    so the host has enqueued the start event, fn's launches and the end
    event before the card reaches them, and the time between the events is
    the card's alone, not the host's launch pace.  ``setup()``, when
    given, runs before each call, outside the events (K9 ANDs into its
    input: each call starts from the recorded mask)."""
    import torch

    for _ in range(warmup):
        if setup is not None:
            setup()
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if setup is not None:
            setup()
        torch.cuda._sleep(QUEUE_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _clone(x):
    """A copy of every tensor and array in a dict / list / tuple tree.  The
    tensors of one device are copied into one buffer, so a tree of many
    leaves costs one allocation and no cudaMalloc per leaf."""
    import numpy as np
    import torch

    tensors = _tensors(x)
    copies = {}
    for dev in {t.device for t in tensors}:
        mine = [t for t in tensors if t.device == dev]
        offs, n = [], 0
        for t in mine:
            offs.append(n)
            n += -(-t.numel() * t.element_size() // 16) * 16
        buf = torch.empty(n, dtype=torch.uint8, device=dev)
        for t, off in zip(mine, offs):
            c = buf[off:off + t.numel() * t.element_size()].view(
                t.dtype).view(t.shape)
            c.copy_(t)
            copies[id(t)] = c

    def rebuild(v):
        if isinstance(v, torch.Tensor):
            return copies[id(v)]
        if isinstance(v, np.ndarray):
            return v.copy()
        if isinstance(v, dict):
            return {k: rebuild(u) for k, u in v.items()}
        if isinstance(v, (list, tuple)):
            return type(v)(rebuild(u) for u in v)
        return v

    return rebuild(x)


def _tensors(x):
    """The tensors of a dict / list / tuple tree, in order."""
    import torch

    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, dict):
        return [t for v in x.values() for t in _tensors(v)]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    return []


class Capture:
    """Record the arguments and result of every call of the kernel
    wrappers that the driver and the evaluator call, for one run: of all
    that the main path launches (K2 and K3 run inside K9 there), or of
    the kernels in ``names``.  A call of program_eval with ``pack`` (a
    review: K9 packs the masks in its launch) is recorded as
    "program_pack", its result the mask and the packed array.  K10 is
    recorded where it launches (packbits.pack_review_masks_cuda, which
    program_eval calls where K9 does not pack).  A call of program_eval
    with ``delta`` (a delta sweep on one card: K9 writes the before |
    after columns in its launch) is recorded as "program_delta", its
    result the mask and the int8 columns; K5 where it launches
    (delta_columns_cuda: after K9 where K9 writes no delta columns, and
    per owning shard under a mesh).
    K8's table mode is recorded at join_lookup_many, one call an
    evaluation, and its dense mode at join_lookup.  A site its checkout
    lacks (tools/kernel_turns.py runs earlier checkouts) is skipped.  The
    arguments are copied before the call and the result after it: the row
    scatter (K6) updates the resident inputs in place, which a later sweep
    would otherwise change under a recorded call."""

    SITES = (
        ("driver", "match_kernel", "match"),
        ("driver", "packed_reduction", "reduction"),
        ("driver", "program_eval", "program"),
        ("delta", "delta_columns_cuda", "delta"),
        ("driver", "scatter_rows", "scatter"),
        ("joinkeys", "join_keys", "joinkeys"),
        ("joinkeys", "merge_key_tables", "joinkeys_merge"),
        ("vexpr", "join_lookup", "joinlookup"),
        ("vexpr", "join_lookup_many", "joinlookup_table"),
        ("packbits", "pack_review_masks_cuda", "packbits"),
    )
    # a site's other names: the calls of program_eval that pack (keyword
    # pack) and that write a delta sweep's columns (keyword delta)
    MODES = {"program": {"pack": "program_pack", "delta": "program_delta"}}

    def __init__(self, names=None):
        from gatekeeper_tpu_torch.ops import delta, driver, joinkeys
        from gatekeeper_tpu_torch.ops import packbits, vexpr

        mods = {"driver": driver, "vexpr": vexpr, "joinkeys": joinkeys,
                "packbits": packbits, "delta": delta}
        self.sites = [(mods[m], f, name) for m, f, name in self.SITES
                      if hasattr(mods[m], f) and (
                          names is None or name in names
                          or set(self.MODES.get(name, {}).values())
                          & set(names))]
        self.calls = {}
        for _m, _f, name in self.sites:
            self.calls[name] = []
            for mode in self.MODES.get(name, {}).values():
                self.calls[mode] = []
        self._orig = {}

    def __enter__(self):
        for mod, fname, name in self.sites:
            orig = getattr(mod, fname)
            self._orig[(mod, fname)] = orig

            def wrapped(*a, _orig=orig, _name=name, **kw):
                args, kws = _clone(a), _clone(kw)
                out = _orig(*a, **kw)
                name, rec = _name, out
                for key, mode in self.MODES.get(_name, {}).items():
                    if kw.get(key) is not None:
                        # the mask, and the output the mode writes
                        name, rec = mode, (out, kw[key][-1])
                # a copy: the match mask is ANDed into in place (K9)
                self.calls[name].append((args, kws, _clone(rec)))
                return out

            setattr(mod, fname, wrapped)
        return self

    def __exit__(self, *exc):
        for (mod, fname), orig in self._orig.items():
            setattr(mod, fname, orig)


class PlainVersions:
    """Route the driver's and the evaluator's kernel calls to the plain
    PyTorch versions, on whatever device the tensors are."""

    def __enter__(self):
        from gatekeeper_tpu_torch.ops import delta as deltamod
        from gatekeeper_tpu_torch.ops import (
            driver, joinkeys, joinlookup, matchkernel, packbits, program,
            reduction, setcount, strpred, vexpr,
        )

        def match_plain(rv, cs, records=None):
            return matchkernel.match_kernel_plain(rv, cs)

        def program_plain(mask, groups, pack=None, delta=None):
            program.program_eval_plain(mask, groups)
            if pack is not None:
                pack[1].copy_(packbits.pack_review_masks_plain(mask, pack[0]))
            if delta is not None:
                delta[2].copy_(deltamod.delta_columns_plain(delta[0],
                                                            delta[1], mask))
            return mask

        self.patches = [
            (driver, "match_kernel", match_plain),
            (driver, "packed_reduction", reduction.packed_reduction_plain),
            (driver, "program_eval", program_plain),
            (vexpr, "strpred", strpred.strpred_plain),
            (vexpr, "setcount", setcount.setcount_plain),
            (joinkeys, "join_keys", joinkeys.join_keys_plain),
            (vexpr, "join_lookup", joinlookup.join_lookup_plain),
            (vexpr, "join_lookup_many", joinlookup.join_lookup_many_plain),
        ]
        self.saved = [(m, f, getattr(m, f)) for m, f, _ in self.patches]
        for m, f, fn in self.patches:
            setattr(m, f, fn)
        return self

    def __exit__(self, *exc):
        for m, f, fn in self.saved:
            setattr(m, f, fn)


class OpByOp:
    """Route TorchDriver._eval's program groups through
    vexpr.eval_program, the IR issued op by op with K2, K3 and K8 (a
    launch a join lookup), a review's pack through K10 and a delta
    sweep's columns through K5 (the path before K9), in place of the
    bytecode and K9: the 'before' of the device-stage split.  A switch of
    this script only, never of the driver."""

    def __enter__(self):
        from gatekeeper_tpu_torch.ops import delta as deltamod
        from gatekeeper_tpu_torch.ops import driver, packbits, vexpr

        def bind(prog, env, start):
            return {"prog": prog, "env": env, "start": start, "B": env.C}

        def run(mask, groups, pack=None, delta=None):
            for g in groups:
                mask[g["start"]:g["start"] + g["B"]] &= vexpr.eval_program(
                    g["prog"], g["env"])
            if pack is not None:  # the review's pack in K10's own launch
                packbits.pack_review_masks_cuda(mask, pack[0], out=pack[1])
            if delta is not None:  # the delta columns in K5's own launch
                deltamod.delta_columns_cuda(delta[0], delta[1], mask,
                                            out=delta[2])
            return mask

        self.saved = [(driver, n, getattr(driver, n))
                      for n in ("encode", "bind_group", "program_eval",
                                "lookup_joins")]
        driver.encode = lambda prog: prog
        driver.bind_group = bind
        driver.program_eval = run
        # each join lookup in its own launch, from eval_program
        driver.lookup_joins = lambda staged: None
        return self

    def __exit__(self, *exc):
        for m, f, fn in self.saved:
            setattr(m, f, fn)


class NoIR:
    """vexpr.eval_program raises while the counted runs drive the main
    path: every evaluation must go through the bytecode and K9."""

    def __enter__(self):
        from gatekeeper_tpu_torch.ops import vexpr

        def refuse(*_a, **_k):
            raise AssertionError("the main path ran vexpr.eval_program")

        self.saved = vexpr.eval_program
        vexpr.eval_program = refuse
        return self

    def __exit__(self, *exc):
        from gatekeeper_tpu_torch.ops import vexpr

        vexpr.eval_program = self.saved


def _nbytes(*tensors) -> int:
    total = 0
    for t in tensors:
        if isinstance(t, dict):
            total += _nbytes(*t.values())
        elif hasattr(t, "element_size"):
            total += t.numel() * t.element_size()
    return total


def bound(nbytes: int, ops: int) -> dict:
    """The least time the card could take: the larger of the bytes over
    the memory rate and the operations over the integer rate (both kept,
    in ms)."""
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = ops / PEAK_INT32_OPS_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "bytes_ms": t_bytes, "ops": ops,
            "ops_ms": t_ops}


class Kernel:
    """One kernel's entry in check_kernels: where it lives, what it
    replaces, and four functions of a recorded call.  ``prep(a, kw)`` puts
    the call's arguments on the card once; ``kernel(p)`` and ``plain(p)``
    run the kernel and its plain version on them (checked and timed
    alike); ``work(p)`` -> (bytes, operations, shapes, the library call or
    None[, {key: a call, or (a call, its setup), timed as a note under
    key}]); ``size(a)`` ranks the calls, and the largest (the first of
    equals) is timed; ``reset(p, which)``, where given, restores the
    kernel's ('kernel') or the plain version's ('plain') in-place output
    before each timed call."""

    def __init__(self, source, replaces, kernel, plain, work,
                 prep=lambda a, kw: (a, kw), size=lambda a: 0, reset=None):
        self.source, self.replaces = source, replaces
        self.kernel, self.plain, self.work = kernel, plain, work
        self.prep, self.size, self.reset = prep, size, reset


def _strpred_work(p):
    import torch

    (tableT, idx, _tcode, sid, *_rest), _kw = p
    C, N = idx.shape[0], sid.numel()
    U = tableT.shape[1]
    distinct = int(torch.unique(sid).numel())
    flat = sid.reshape(-1).clamp(0, tableT.shape[0] - 1).long()
    col = idx.long()[:, None]
    return (C * N + N * 5 + C * 4 + distinct * U, 3 * C * N,
            {"C": C, "N": N, "U": U, "vocab": tableT.shape[0],
             "distinct_ids": distinct},
            lambda: tableT[flat[None, :], col])


def _setcount_work(p):
    (cids, _cmask, kids, orient, *_rest), _kw = p
    C, P = cids.shape
    R, K = kids.shape
    return (C * R + C * P * 5 + R * K * 4, 2 * C * R * P * K,
            {"C": C, "R": R, "P": P, "K": K, "orient": orient}, None)


def _program_prep(a, kw):
    """The recorded mask (K1's, before K9) and two copies of it, one each
    for K9 and the plain version to AND into."""
    mask, groups = a
    return {"pre": mask, "kernel": mask.clone(), "plain": mask.clone(),
            "groups": groups}


def _program_reset(p, which):
    p[which].copy_(p["pre"])


def _program_work(p):
    """Bytes: the group rows of the mask read and written, and every
    operand tensor read once in full.  Operations: the bytecode
    instructions the kernel executes on this mask (a cell whose match bit
    is False runs none; jumps and early loop exits counted as taken), each
    one operation, a set count 1 + 2 P K."""
    from gatekeeper_tpu_torch.ops import program, progcode

    mask, groups = p["pre"], p["groups"]
    R = mask.shape[1]
    ops = []
    program.program_eval_plain(mask.clone(), groups, ops)
    seen = {}
    for g in groups:
        for t in _tensors(g["operands"]):
            seen[t.data_ptr()] = t.numel() * t.element_size()
    rows = sum(g["B"] for g in groups)
    live = sum(int(mask[g["start"]:g["start"] + g["B"]].sum().item())
               for g in groups)
    return (2 * rows * R + sum(seen.values()), sum(ops),
            {"groups": len(groups), "group_rows": rows, "R": R,
             "live_cells": live,
             "instructions": [len(g["code"]) // progcode.WIDTH
                              for g in groups],
             "operands": [len(g["operands"]) for g in groups],
             "executed": ops}, None)


def _program_pack_prep(a, kw):
    """_program_prep, with the recorded autoreject mask and an output
    array each for K9's pack and the plain one."""
    import torch

    p = _program_prep(a, kw)
    autoreject, out = kw["pack"]
    p.update(autoreject=autoreject, out_kernel=torch.empty_like(out),
             out_plain=torch.empty_like(out))
    return p


def _program_pack_kernel(p):
    from gatekeeper_tpu_torch.ops import program

    program.program_eval_cuda(p["kernel"], p["groups"],
                              pack=(p["autoreject"], p["out_kernel"]))
    return p["kernel"], p["out_kernel"]


def _program_pack_plain(p):
    from gatekeeper_tpu_torch.ops import packbits, program

    program.program_eval_plain(p["plain"], p["groups"])
    p["out_plain"].copy_(packbits.pack_review_masks_plain(p["plain"],
                                                          p["autoreject"]))
    return p["plain"], p["out_plain"]


def _k9_then_k10(p):
    """The review's device chain before the fold: K9 alone, then K10 on
    its mask, into the same output."""
    from gatekeeper_tpu_torch.ops import packbits, program

    program.program_eval_cuda(p["kernel"], p["groups"])
    packbits.pack_review_masks_cuda(p["kernel"], p["autoreject"],
                                    out=p["out_kernel"])


class FoldAtEveryR:
    """K9 packs a review (or, with ``limit`` DELTA_IN_K9_MAX_ROWS, writes a
    delta sweep's columns) in its launch whatever the row count: the row
    limit ``limit`` of ops/program.py lifted while inside."""

    def __init__(self, limit: str = "PACK_IN_K9_MAX_ROWS"):
        self.name = limit

    def __enter__(self):
        from gatekeeper_tpu_torch.ops import program

        self.limit = getattr(program, self.name)
        setattr(program, self.name, 1 << 30)
        return self

    def __exit__(self, *exc):
        from gatekeeper_tpu_torch.ops import program

        setattr(program, self.name, self.limit)


def _forced_fold(p):
    """The fused launch whatever the row count."""
    with FoldAtEveryR():
        _program_pack_kernel(p)


def _program_pack_work(p):
    """K9's bytes and operations (_program_work) and the pack's: both
    [C, R] masks read once and the packed array written once, one test a
    cell.  Timed beside it on the same inputs: K9 then K10 (the chain
    before the fold), and the fused launch with the row limit lifted."""
    nbytes, ops, shapes, _lib = _program_work(p)
    C, R = p["pre"].shape
    packed = p["out_kernel"].numel()
    shapes.update(C=C, packed=list(p["out_kernel"].shape))
    reset = (lambda: _program_reset(p, "kernel"))
    return (nbytes + 2 * C * R + packed, ops + 2 * C * R, shapes, None,
            {"k9_then_k10_ms": (lambda: _k9_then_k10(p), reset),
             "fused_forced_ms": (lambda: _forced_fold(p), reset)})


def _program_delta_prep(a, kw):
    """_program_prep, with the recorded resident mask and indices and an
    output array each for K9's delta mode and the plain one."""
    import torch

    p = _program_prep(a, kw)
    resident, idx, out = kw["delta"]
    p.update(resident=resident, idx=idx,
             out_kernel=torch.empty_like(out), out_plain=torch.empty_like(out))
    return p


def _program_delta_kernel(p):
    from gatekeeper_tpu_torch.ops import program

    program.program_eval_cuda(p["kernel"], p["groups"], delta=(
        p["resident"], p["idx"], p["out_kernel"]))
    return p["kernel"], p["out_kernel"]


def _program_delta_plain(p):
    from gatekeeper_tpu_torch.ops import delta, program

    program.program_eval_plain(p["plain"], p["groups"])
    p["out_plain"].copy_(delta.delta_columns_plain(p["resident"], p["idx"],
                                                   p["plain"]))
    return p["plain"], p["out_plain"]


def _k9_then_k5(p):
    """The delta sweep's device chain before the fold: K9 alone, then K5
    on its mask into a fresh output (tools/kernel_turns.py runs it on
    checkouts whose K5 takes no output argument) -> the columns."""
    from gatekeeper_tpu_torch.ops import delta, program

    program.program_eval_cuda(p["kernel"], p["groups"])
    return delta.delta_columns_cuda(p["resident"], p["idx"], p["kernel"])


def _program_delta_size(a):
    """The calls K9's delta mode runs in (w up to its row limit) rank
    above those past it, where program_eval runs K9 then K5: the timed
    call is the largest of the mode's own."""
    from gatekeeper_tpu_torch.ops import program

    return a[0].shape[1] <= program.DELTA_IN_K9_MAX_ROWS, a[0].numel()


def _program_delta_work(p):
    """K9's bytes and operations (_program_work) and the delta columns':
    w bytes gathered from the resident mask and the rows of no group's w
    mask bytes read a constraint row, the [C, 2w] output written once, the
    indices; one select a cell.  Timed beside it on the same inputs: K9
    then K5 (the chain before the fold), and the fused launch with the
    row limit lifted where the limit applies."""
    from gatekeeper_tpu_torch.ops import program

    nbytes, ops, shapes, _lib = _program_work(p)
    C, w = p["pre"].shape
    free = C - shapes["group_rows"]
    shapes.update(C=C, w=w, resident_columns=p["resident"].shape[1],
                  rows_of_no_group=free,
                  gather_blocks=program.gather_blocks(C, w))
    reset = (lambda: _program_reset(p, "kernel"))
    notes = {"k9_then_k5_ms": (lambda: _k9_then_k5(p), reset)}
    if w > program.DELTA_IN_K9_MAX_ROWS:
        def forced():
            with FoldAtEveryR("DELTA_IN_K9_MAX_ROWS"):
                _program_delta_kernel(p)

        notes["fused_forced_ms"] = (forced, reset)
    return (nbytes + C * w + free * w + 2 * C * w + 4 * w, ops + 2 * C * w,
            shapes, None, notes)


def k10_calls(cap: Capture) -> Capture:
    """K10 on the masks of K9's recorded packing calls: each call again
    with no group, so that K9 is not launched and K10 packs alone (the
    review of a side without groups) -> the Capture of those calls."""
    import torch

    from gatekeeper_tpu_torch.ops import program

    with Capture(names=("packbits",)) as k10:
        for _a, kw, (after, _packed) in cap.calls["program_pack"]:
            autoreject, out = kw["pack"]
            program.program_eval_cuda(after.clone(), [],
                                      pack=(autoreject, torch.empty_like(out)))
    if len(k10.calls["packbits"]) != len(cap.calls["program_pack"]):
        raise AssertionError("K10 is not one call per review without groups")
    return k10


def cell_calls(cap: Capture) -> dict:
    """K2's and K3's calls at the main path's shapes, from the recorded K9
    calls: each review-side string predicate and each set count of their
    groups, as K9 runs them cell by cell (strpred.cuh, setcount.cuh);
    a per-element predicate takes its tables' first element column.  Each
    call's output is its plain version's, on the card."""
    import numpy as np

    from gatekeeper_tpu_torch.ops import program, progcode, setcount
    from gatekeeper_tpu_torch.ops import strpred

    out = {"strpred": [], "setcount": []}
    k9 = [c for mode in ("program", "program_pack", "program_delta")
          for c in cap.calls.get(mode, [])]
    for (_mask, groups), _kw, _out in k9:
        for g in groups:
            ops = g["operands"]
            for ins in np.asarray(g["code"]).reshape(-1, progcode.WIDTH):
                if ins[0] == progcode.STRPRED:
                    v, t = ops[ins[1]], ops[ins[2]]
                    if v["kind"] not in (program.SCALAR, program.SLOT):
                        continue
                    idx = t["idx"][:, 0].contiguous() if t["width"] \
                        else t["idx"]
                    args = (t["table"], idx, v["tcode"][None],
                            v["sid"][None], bool(ins[3]))
                    out["strpred"].append(
                        (args, {}, strpred.strpred_plain(*args)))
                elif ins[0] == progcode.SETCOUNT:
                    o = ops[ins[1]]
                    args = (o["cids"], o["cmask"], o["kids"], o["orient"],
                            o["op"], o["n"], o["pad"])
                    out["setcount"].append(
                        (args, {}, setcount.setcount_plain(*args)))

    return types.SimpleNamespace(calls=out)


def _reduction_work(p):
    (mask, K, *offset), _kw = p
    C, R = mask.shape
    k = min(K, R)
    return (C * R + C * (1 + k) * 4, C * R,
            {"C": C, "R": R, "K": k, "row_offset": offset[0] if offset else 0},
            None)


def _match_work(p):
    from gatekeeper_tpu_torch.ops import matchkernel

    a, _kw = p
    rv, cs = a[0], a[1]
    records = a[2] if len(a) > 2 and a[2] is not None else \
        matchkernel.constraint_records(cs)
    return (*match_work(rv, cs, records[0]), None)


def _delta_prep(a, kw):
    """(mask, the indices on the mask's card, new); the output K5 was
    given, where it was, is not reused."""
    import numpy as np
    import torch

    idx = a[1] if torch.is_tensor(a[1]) else \
        torch.from_numpy(np.asarray(a[1], np.int32))
    return a[0], idx.to(a[0].device), a[2]


def _delta_work(p):
    import torch

    mask, idx, new = p
    C, w = new.shape
    idx_l = idx.long()
    # w gathered mask bytes and w fresh bytes a row read, 2w written, the
    # indices; one select a cell
    return (4 * C * w + 4 * w, 2 * C * w,
            {"C": C, "R": mask.shape[1], "w": w},
            lambda: torch.cat([mask.index_select(1, idx_l).to(torch.int8),
                               new.to(torch.int8)], dim=1))


def _scatter_prep(a, kw):
    """Two copies of the recorded resident tree, one staged for K6 and one
    with the rows and indices on the card for the plain version: both
    write the same rows every time, so repeated calls are idempotent."""
    import numpy as np
    import torch

    from gatekeeper_tpu_torch.ops import scatter

    k_tree, p_tree, idx, host_rows = _clone(a[0]), _clone(a[0]), a[1], a[2]
    pairs = list(scatter.leaf_pairs(p_tree, host_rows))
    dev = pairs[0][1].device
    return {
        "k_tree": k_tree, "p_tree": p_tree,
        "staged": scatter.stage_rows(k_tree, idx, host_rows),
        "plain": [(d, torch.as_tensor(r, device=dev)) for _p, d, r in pairs],
        "idx": torch.as_tensor(np.asarray(idx, np.int64), device=dev),
    }


def _scatter_kernel(p):
    from gatekeeper_tpu_torch.ops import scatter

    scatter.scatter_staged_cuda(p["staged"])
    return _tensors(p["k_tree"])


def _scatter_plain(p):
    for d, rows in p["plain"]:
        d.index_copy_(0, p["idx"], rows)
    return _tensors(p["p_tree"])


def _scatter_work(p):
    st = p["staged"]
    n, row_bytes = st.n_rows, sum(st.row_bytes)
    # a checkout before the row-major staging has no layout and no units
    # (tools/kernel_turns.py times one)
    lay = getattr(st, "lay", None)
    units = lay.n_units if lay is not None else 0
    # each staged row read once and written once, the leaf table, the
    # unit table and the indices
    return (2 * n * row_bytes + 32 * st.n_leaves + 8 * units + 8 * n, 0,
            {"rows": n, "leaves": st.n_leaves, "row_bytes": row_bytes,
             "units": units}, None)


def _joinkeys_work(p):
    import torch

    from gatekeeper_tpu_torch.ops import joinkernel

    (valid, kind, ns_empty, sid, mask, kind_id, namespaced, vocab), _kw = p
    R = valid.shape[0]
    S = 1 if mask is None else sid.shape[1]
    N = R * S
    part = joinkernel.participation(valid, kind, ns_empty, kind_id,
                                    namespaced)
    rows = int(part.sum().item())
    # the row-deduplicated provider keys, for the library call
    if mask is None:
        flat = sid[part & (sid >= 0)]
    else:
        flat = joinkernel.row_distinct_slot_keys(
            sid, mask & (sid >= 0) & part[:, None], torch)
        flat = flat[flat != int(joinkernel.KEY_INVALID)]
    # bytes: three review fields a row, each key id and mask byte, the two
    # [N] outputs and the [V] dense counts; operations: the participation
    # test of a row, three tests of a slot, an earlier-slot compare for
    # each pair of slots of a participating row, one atomic a distinct key,
    # one test a vocabulary id
    nbytes = (6 * R + 4 * N + (0 if mask is None else N) + 8 * N
              + 4 * max(vocab, 1))
    ops = 3 * R + 3 * N + rows * S * (S - 1) // 2 + int(flat.numel()) + vocab
    return (nbytes, ops,
            {"R": R, "S": S, "N": N, "vocab": vocab, "rows_taking_part": rows,
             "provider_keys": int(flat.numel())},
            lambda: torch.unique(flat, return_counts=True))


def _merge_work(p):
    import torch

    (uk, uc, vocab), _kw = p
    N = uk.numel()
    ok = (uk >= 0) & (uk < vocab) & (uc != 0)
    keys, weights = uk[ok].long(), uc[ok]
    counts = torch.zeros(max(vocab, 1), dtype=torch.int32, device=uk.device)
    # bytes: the [N] tables read, the [N] merged table and the [V] dense
    # counts written; operations: the test and the atomic of an entry, one
    # test a vocabulary id.  No single PyTorch call merges and compacts:
    # index_add_ of the weights, the scatter alone, is timed as a note
    return (16 * N + 4 * max(vocab, 1), 2 * N + vocab,
            {"N": N, "vocab": vocab, "valid_entries": int(keys.numel())},
            None, {"scatter_only_ms": lambda: counts.index_add_(0, keys,
                                                                weights)})


def _joinlookup_work(p):
    import torch

    (uk, uc, q, scope), kw = p
    dense = kw.get("dense")
    N, T, R = q.numel(), uk.numel(), q.shape[0]
    # bytes: each query read and its count written, three review fields a
    # row when the self-exclusion runs, and what the lookups must touch:
    # in table mode the keys of one binary search a query (the least a
    # search reads) and the count it finds, the whole (uk, uc) table at
    # most; in dense mode one count a query, the [V] dense counts at
    # most; operations: the compares of one binary search a query (table
    # mode) or its range test and read (dense mode), and the self test
    steps = max(1, math.ceil(math.log2(T + 1)))
    rows = 0 if scope is None else 6 * R
    self_ops = 0 if scope is None else 4 * N
    table = (8 * N + 4 * min(T, N * steps) + 4 * min(T, N) + rows,
             N * (steps + 2) + self_ops)
    shapes = {"N": N, "R": R, "T": T, "self_exclusion": scope is not None,
              "mode": "table" if dense is None else "dense"}
    if dense is None:
        nbytes, ops = table
    else:
        V = dense.numel()
        nbytes, ops = 8 * N + 4 * min(V, N) + rows, 2 * N + self_ops
        # the table-mode bound of the same queries, beside dense mode's
        shapes.update(V=V, table_mode_bound_ms=bound(*table)["bound_ms"])
    return (nbytes, ops, shapes,
            lambda: uc[torch.searchsorted(uk, q).clamp_(max=T - 1)])


def _lookup_table_work(p):
    """K8's table mode over one evaluation's lookups: each lookup's
    table-mode bytes and operations (_joinlookup_work), summed.  The
    library call: searchsorted + gather of each lookup in turn.  Timed
    beside it: the same lookups each in a table-mode launch of its own
    (join_lookup_cuda, the launches before the one launch), and the
    largest lookup alone."""
    from gatekeeper_tpu_torch.ops import joinlookup

    (lookups,), _kw = p
    nbytes = ops = 0
    shapes = {"lookups": []}
    for uk, uc, q, scope in lookups:
        b, o, sh, _lib = _joinlookup_work(((uk, uc, q, scope), {}))
        nbytes, ops = nbytes + b, ops + o
        shapes["lookups"].append({k: sh[k] for k in ("N", "T",
                                                     "self_exclusion")})
    lib = [_joinlookup_work(((uk, uc, q, scope), {}))[3]
           for uk, uc, q, scope in lookups]
    big = max(lookups, key=lambda lk: lk[2].numel())
    return (nbytes, ops, shapes, lambda: [f() for f in lib],
            {"separate_launches_ms": lambda: [
                joinlookup.join_lookup_cuda(*lk) for lk in lookups],
             "one_lookup_ms": lambda: joinlookup.join_lookup_cuda(*big)})


def _packbits_work(p):
    (mask, autoreject), _kw = p
    C, R = mask.shape
    # each mask byte read once, each packed byte written once; one test a
    # cell
    return (2 * C * R + 2 * C * -(-R // 8), 2 * C * R,
            {"C": C, "R": R, "packed": [2 * C, -(-R // 8)]}, None)


def kernel_specs() -> dict:
    from gatekeeper_tpu_torch.ops import delta, joinkeys, joinlookup
    from gatekeeper_tpu_torch.ops import matchkernel, packbits, program
    from gatekeeper_tpu_torch.ops import reduction, setcount, strpred

    def rows_of(a):
        return len(a[1])

    return {
        "match": Kernel(
            "gatekeeper_tpu_torch/kernels/match.cu",
            "gatekeeper_tpu/ops/matchkernel.py:115",
            lambda p: matchkernel.match_kernel_cuda(*p[0], **p[1]),
            lambda p: matchkernel.match_kernel_plain(p[0][0], p[0][1]),
            _match_work),
        "strpred": Kernel(
            "gatekeeper_tpu_torch/kernels/strpred.cu",
            "gatekeeper_tpu/ops/vexpr.py:418",
            lambda p: strpred.strpred_cuda(*p[0], **p[1]),
            lambda p: strpred.strpred_plain(*p[0], **p[1]),
            _strpred_work, size=lambda a: a[1].numel() * a[3].numel()),
        "setcount": Kernel(
            "gatekeeper_tpu_torch/kernels/setcount.cu",
            "gatekeeper_tpu/ops/vexpr.py:470",
            lambda p: setcount.setcount_cuda(*p[0], **p[1]),
            lambda p: setcount.setcount_plain(*p[0], **p[1]),
            _setcount_work, size=lambda a: a[0].shape[0] * a[2].shape[0]),
        "program": Kernel(
            "gatekeeper_tpu_torch/kernels/program.cu",
            "gatekeeper_tpu/ops/vexpr.py:565",
            lambda p: program.program_eval_cuda(p["kernel"], p["groups"]),
            lambda p: program.program_eval_plain(p["plain"], p["groups"]),
            _program_work, prep=_program_prep, size=lambda a: a[0].numel(),
            reset=_program_reset),
        # K9's review mode: the groups, then both masks packed in the same
        # launch (K10's body, packbits.cuh)
        "program_pack": Kernel(
            "gatekeeper_tpu_torch/kernels/program.cu",
            "gatekeeper_tpu/ops/driver.py:1451",
            _program_pack_kernel, _program_pack_plain, _program_pack_work,
            prep=_program_pack_prep, size=lambda a: a[0].numel(),
            reset=_program_reset),
        # K9's delta mode: the groups, then the delta sweep's before |
        # after columns in the same launch (K5's function)
        "program_delta": Kernel(
            "gatekeeper_tpu_torch/kernels/program.cu",
            "gatekeeper_tpu/ops/driver.py:3709",
            _program_delta_kernel, _program_delta_plain, _program_delta_work,
            prep=_program_delta_prep, size=_program_delta_size,
            reset=_program_reset),
        "reduction": Kernel(
            "gatekeeper_tpu_torch/kernels/reduction.cu",
            "gatekeeper_tpu/ops/driver.py:88",
            lambda p: reduction.packed_reduction_cuda(*p[0], **p[1]),
            lambda p: reduction.packed_reduction_plain(*p[0], **p[1]),
            # the largest mask, a shard's (a row offset) before the first
            _reduction_work,
            size=lambda a: (a[0].numel(), len(a) > 2 and a[2] > 0)),
        "delta": Kernel(
            "gatekeeper_tpu_torch/kernels/delta.cu",
            "gatekeeper_tpu/ops/driver.py:3709",
            lambda p: delta.delta_columns_cuda(*p),
            lambda p: delta.delta_columns_plain(*p),
            _delta_work, prep=_delta_prep, size=rows_of),
        "scatter": Kernel(
            "gatekeeper_tpu_torch/kernels/scatter.cu",
            "gatekeeper_tpu/ops/driver.py:152",
            _scatter_kernel, _scatter_plain, _scatter_work,
            prep=_scatter_prep, size=rows_of),
        "joinkeys": Kernel(
            "gatekeeper_tpu_torch/kernels/joinkeys.cu",
            "gatekeeper_tpu/ops/joinkernel.py:236",
            lambda p: joinkeys.join_keys_cuda(*p[0], **p[1]),
            lambda p: joinkeys.join_keys_plain(*p[0], **p[1]),
            _joinkeys_work, size=lambda a: a[3].numel()),
        "joinkeys_merge": Kernel(
            "gatekeeper_tpu_torch/kernels/joinkeys.cu",
            "gatekeeper_tpu/ops/joinkernel.py:262",
            lambda p: joinkeys.merge_key_tables_cuda(*p[0], **p[1]),
            lambda p: joinkeys.merge_key_tables_plain(*p[0], **p[1]),
            _merge_work, size=lambda a: a[0].numel()),
        "joinlookup": Kernel(
            "gatekeeper_tpu_torch/kernels/joinlookup.cu",
            "gatekeeper_tpu/ops/joinkernel.py:271",
            lambda p: joinlookup.join_lookup_cuda(*p[0], **p[1]),
            lambda p: joinlookup.join_lookup_plain(*p[0], **p[1]),
            _joinlookup_work, size=lambda a: a[2].numel()),
        # K8's table mode: one evaluation's lookups in one launch
        "joinlookup_table": Kernel(
            "gatekeeper_tpu_torch/kernels/joinlookup.cu",
            "gatekeeper_tpu/ops/joinkernel.py:271",
            lambda p: joinlookup.join_lookup_many_cuda(*p[0]),
            lambda p: joinlookup.join_lookup_many_plain(*p[0]),
            _lookup_table_work,
            size=lambda a: sum(lk[2].numel() for lk in a[0])),
        # no single PyTorch call packs bits: library none
        "packbits": Kernel(
            "gatekeeper_tpu_torch/kernels/packbits.cu",
            "gatekeeper_tpu/ops/driver.py:1451",
            lambda p: packbits.pack_review_masks_cuda(*p[0], **p[1]),
            lambda p: packbits.pack_review_masks_plain(*p[0]),
            _packbits_work, size=lambda a: a[0].numel()),
    }


def check_kernels(cap: Capture, reps: int, timed, phase: str = "kernel"):
    """Every recorded call of every kernel against its plain version on
    the same inputs, exactly, and against the main path's own output ->
    name -> row; the kernels in ``timed`` are also timed and bounded at
    their largest call, each logged under ``phase``."""
    import torch

    rows = {}
    for name, spec in kernel_specs().items():
        calls = cap.calls.get(name, [])
        if not calls:
            if name in timed:
                raise AssertionError(f"the main path never called {name}")
            continue
        max_err = 0
        for a, kw, main_out in calls:
            p = spec.prep(a, kw)
            got, want = _tensors(spec.kernel(p)), _tensors(spec.plain(p))
            torch.cuda.synchronize()
            mains = _tensors(main_out)
            if not (len(got) == len(want) == len(mains)):
                raise AssertionError(f"{name}: output counts differ")
            for g, w, m in zip(got, want, mains):
                if g.shape != w.shape or g.dtype != w.dtype:
                    raise AssertionError(
                        f"{name}: kernel {tuple(g.shape)} {g.dtype} vs "
                        f"plain {tuple(w.shape)} {w.dtype}"
                    )
                err = (g.double() - w.double()).abs().max().item() \
                    if g.numel() else 0
                max_err = max(max_err, err)
                if not torch.equal(g, w):
                    raise AssertionError(f"{name}: kernel != plain ({err})")
                if not torch.equal(m, g):
                    raise AssertionError(f"{name}: main path output differs")
            del p, got, want
        row = {"name": name, "route": "cuda", "source": spec.source,
               "replaces": spec.replaces, "max_abs_err": max_err,
               "calls_checked": len(calls)}
        rows[name] = row
        if name not in timed:
            log("kernel_checked", **row)
            continue
        a, kw, _out = max(calls, key=lambda c: spec.size(c[0]))
        p = spec.prep(a, kw)
        nbytes, ops, shapes, library, *notes = spec.work(p)
        sizes = sorted({spec.size(c[0]) for c in calls})
        if len(sizes) > 1:
            shapes["sizes_by_call"] = sizes
        reset = spec.reset or (lambda p, which: None)
        row.update({
            "ms": cuda_ms(lambda: spec.kernel(p), reps,
                          setup=lambda: reset(p, "kernel")),
            "plain_ms": cuda_ms(lambda: spec.plain(p), max(3, reps // 4),
                                warmup=1, setup=lambda: reset(p, "plain")),
            **bound(nbytes, ops),
            "library_ms": None if library is None else cuda_ms(library, reps),
            "shapes": shapes,
        })
        for key, fn in (notes[0] if notes else {}).items():
            # a note is a call, or (a call, the setup before each)
            fn, setup = fn if isinstance(fn, tuple) else (fn, None)
            row[key] = cuda_ms(fn, reps, setup=setup)
        log(phase, **row)
        del p
    return rows


def fused_audit_bound(rows: dict) -> dict:
    """B6, gatekeeper_tpu/ops/driver.py _fused_audit_fn: the capped sweep
    as one function, which keeps the [C, R] mask inside.  Its least time
    at the cold sweep's call: K1's and K9's inputs read once (their mask
    traffic left out), [C, 1+K] written, and the operations of K1, K9
    and K4; beside the sum of the three kernels' times."""
    m, g, r = rows["match"], rows["program"], rows["reduction"]
    masks = 2 * m["shapes"]["C"] * m["shapes"]["R"]  # K1's two outputs
    group_mask = 2 * g["shapes"]["group_rows"] * g["shapes"]["R"]
    out = r["shapes"]["C"] * (1 + r["shapes"]["K"]) * 4
    nbytes = m["bytes"] - masks + g["bytes"] - group_mask + out
    return {**bound(nbytes, m["ops"] + g["ops"] + r["ops"]),
            "kernels_ms": m["ms"] + g["ms"] + r["ms"],
            "mask_bytes_left_out": masks + group_mask + r["shapes"]["C"]
            * r["shapes"]["R"]}


def match_work(rv: dict, cs: dict, crec):
    """K1's bytes and operations at these inputs: the constraint records,
    the review's id and flag fields, the label arrays only where a live
    selector walks them, and both [C, R] outputs; per cell 4 compares a
    live kind pair, 2 a live namespace id of a constraint that has the
    list, 6 for the scalar fields, and 3 a label slot for each live
    matchLabels pair, expression and expression value."""
    C, R = cs["valid"].shape[0], rv["valid"].shape[0]
    pad = -2
    live_ls = int((cs["ls_ml"][..., 0] != pad).sum()) + \
        int((cs["ls_op"] != -1).sum())
    live_ns = int((cs["nssel_ml"][..., 0] != pad).sum()) + \
        int((cs["ns_op"] != -1).sum())
    live_vals = sum(
        int(((cs[op] != -1)[..., None].expand_as(cs[v])).sum())
        for op, v in (("ls_op", "ls_vals"), ("ns_op", "ns_vals"))
    )
    labels = ("obj_labels", "old_labels") if live_ls or live_ns else ()
    labels += ("ns_labels",) if live_ns else ()
    row_fields = ("group", "kind", "ns_name", "ns_mode", "always",
                  "ns_empty", "obj_empty", "old_empty", "autoreject", "valid")
    nbytes = (_nbytes(crec) + _nbytes(*(rv[k] for k in row_fields + labels))
              + 2 * C * R)
    L = sum(rv[k].shape[1] for k in labels)
    live = live_ls + live_ns + live_vals
    kp = int((cs["kind_pairs"][..., 0] != pad).sum())
    ns = int(((cs["ns_ids"] != pad) & cs["has_ns"][:, None]).sum())
    ex = int(((cs["ex_ids"] != pad) & cs["has_ex"][:, None]).sum())
    ops = R * (4 * kp + 2 * ns + 2 * ex + 6 * C + 3 * L * live)
    shapes = {"C": C, "R": R, "label_slots_walked": L,
              "live_selector_entries": live}
    return nbytes, ops, shapes


def check_match_at_size(C: int, R: int):
    """K1 against its plain version on the card at [C, R] (R rows exactly,
    not bucketed), on the seeded selector corpus (util/matchcorpus.py):
    every label and namespace selector kind is live there, where the
    synthetic corpus has none.  Exact.  Not counted: the counts are read
    before this."""
    import torch

    from gatekeeper_tpu_torch.convert import state_from_numpy
    from gatekeeper_tpu_torch.ops import matchkernel
    from gatekeeper_tpu_torch.ops.interning import Interner
    from gatekeeper_tpu_torch.ops.pack import pack_constraints, pack_reviews
    from gatekeeper_tpu_torch.util import matchcorpus

    dev = torch.device(DEVICE)
    # make_corpus appends two pad constraints
    constraints, reviews = matchcorpus.make_corpus(SEED, C - 2, R)
    interner = Interner()
    rv = pack_reviews(reviews, interner, matchcorpus.NAMESPACES.get,
                      bucket_rows=False).arrays
    cs = pack_constraints(constraints, interner).arrays
    rv_d, cs_d = state_from_numpy(rv, dev), state_from_numpy(cs, dev)
    got = matchkernel.match_kernel_cuda(rv_d, cs_d)
    want = matchkernel.match_kernel_plain(rv_d, cs_d)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        if g.shape != w.shape or not torch.equal(g, w):
            raise AssertionError("match: kernel != plain with live selectors")
    crec = matchkernel.constraint_records(cs_d)[0]
    nbytes, ops, shapes = match_work(rv_d, cs_d, crec)
    ms = cuda_ms(lambda: matchkernel.match_kernel_cuda(rv_d, cs_d), REPS)
    return {"equal": True, "ms": ms, **bound(nbytes, ops), "shapes": shapes,
            "matched": int(got[0].sum().item()),
            "autoreject": int(got[1].sum().item())}


def check_edges():
    """Each kernel against its plain version on the card on seeded inputs
    the main path does not reach: live label and namespace selectors of
    every kind (K1), ragged and unaligned rows and K past the count (K4),
    negative ids and both polarities (K2), every comparison in both
    orientations (K3), each of K1-K3 at the delta path's 8 rows, duplicate
    and last-row indices and all-true and all-false fresh columns with C off
    the block size (K5), duplicate and last-row indices, 1, 256 and 9,000
    rows, every leaf dtype and rank, units of every width, a leaf at an
    odd address and a row whose unit table passes 48 KB (K6), K9's pack
    (check_fold_edges), and for the join kernels
    (check_join_edges) no provider rows, every row on one key, duplicate
    keys within a row, S = 1 and S > 32, R off the block size, int/str
    twin keys (K7), queries at UNKNOWN_KEY, -1, the largest id and past
    it, host tables of width TABLE_MIN and the self-exclusion on rows of
    the wrong kind and scope (K8, dense mode too on every table K7
    built), and K7 and its merge at vocabulary sizes around their grid
    (check_join_vocab_edges).  Exact."""
    import numpy as np
    import torch

    from gatekeeper_tpu_torch.convert import state_from_numpy, take_rows
    from gatekeeper_tpu_torch.ops import delta, matchkernel, reduction
    from gatekeeper_tpu_torch.ops import scatter, setcount, strpred
    from gatekeeper_tpu_torch.ops.interning import Interner
    from gatekeeper_tpu_torch.ops.pack import pack_constraints, pack_reviews
    from gatekeeper_tpu_torch.util import matchcorpus

    dev = torch.device(DEVICE)
    checked = {"match": 0, "strpred": 0, "setcount": 0, "reduction": 0,
               "delta": 0, "scatter": 0, "joinkeys": 0, "joinkeys_merge": 0,
               "joinlookup": 0, "joinlookup_table": 0, "program": 0,
               "program_pack": 0, "program_delta": 0, "packbits": 0}

    def same(name, got, want):
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        for g, w in zip(got, want):
            if g.shape != w.shape or not torch.equal(g, w):
                raise AssertionError(f"{name}: kernel != plain on edge case")
        checked[name] += 1

    for s in range(4):
        for n_c, n_r in ((24, 40), (61, 3001), (24, 8), (70, 13),
                         (130, 1025)):
            constraints, reviews = matchcorpus.make_corpus(SEED + s, n_c, n_r)
            interner = Interner()
            cs = pack_constraints(constraints, interner).arrays
            cs_d = state_from_numpy(cs, dev)
            # rows bucketed as the driver packs them, and exactly n_r (off
            # the thread's 8 reviews)
            for bucket in (True, False):
                rv = pack_reviews(reviews, interner,
                                  matchcorpus.NAMESPACES.get,
                                  bucket_rows=bucket).arrays
                rv_d = state_from_numpy(rv, dev)
                same("match", matchkernel.match_kernel_cuda(rv_d, cs_d),
                     matchkernel.match_kernel_plain(rv_d, cs_d))
    rng = np.random.default_rng(SEED)
    for C, R, K, p in ((5, 1000, 3, 0.05), (3, 4096, 64, 0.02),
                       (7, 333, 500, 0.5), (2, 50, 80, 0.9),
                       (4, 64 * 16, 5, 1.0), (3, 17, 4, 0.0)):
        mask = torch.from_numpy(rng.random((C, R)) < p).to(dev)
        same("reduction", reduction.packed_reduction_cuda(mask, K),
             reduction.packed_reduction_plain(mask, K))
        # a row that starts off a 16-byte boundary takes the byte path
        sub = torch.zeros(C * R + 3, dtype=torch.bool, device=dev)
        sub[3:] = mask.reshape(-1)
        off = sub[3:].view(C, R)
        same("reduction", reduction.packed_reduction_cuda(off, K),
             reduction.packed_reduction_plain(off, K))
    for C, shape, V, U in ((6, (1, 300), 40, 8), (3, (1, 77, 3), 9, 2),
                           (128, (1, 8), 50, 8), (5, (1, 8, 4), 30, 4)):
        tableT = torch.from_numpy(
            (rng.random((V, U)) < 0.5).astype(np.uint8)).to(dev)
        idx = torch.from_numpy(rng.integers(0, U, C).astype(np.int32)).to(dev)
        tcode = torch.from_numpy(
            np.where(rng.random(shape) < 0.7, 5, rng.integers(0, 7, shape))
            .astype(np.int8)).to(dev)
        sid = torch.from_numpy(
            rng.integers(-2, V + 3, shape).astype(np.int32)).to(dev)
        for negate in (False, True):
            same("strpred",
                 strpred.strpred_cuda(tableT, idx, tcode, sid, negate),
                 strpred.strpred_plain(tableT, idx, tcode, sid, negate))
    cids = torch.from_numpy(rng.integers(0, 6, (9, 5)).astype(np.int32)).to(dev)
    cmask = torch.from_numpy(rng.random((9, 5)) < 0.7).to(dev)
    for R in (700, 8):
        kids = rng.integers(0, 6, (R, 4)).astype(np.int32)
        kids[rng.random((R, 4)) < 0.4] = Interner.PAD
        kids = torch.from_numpy(kids).to(dev)
        for orient in (0, 1):
            for op in range(6):
                for n in (0, 1, 2):
                    same("setcount",
                         setcount.setcount_cuda(cids, cmask, kids, orient, op,
                                                n, Interner.PAD),
                         setcount.setcount_plain(cids, cmask, kids, orient,
                                                 op, n, Interner.PAD))
    # K5: C off the 256-thread block, duplicate and last-column indices,
    # an all-true and an all-false fresh mask
    for C, R, w, p_new in ((37, 1000, 8, 0.5), (1024, 4099, 256, 1.0),
                           (3, 17, 16, 0.0), (129, 64, 8, 0.3)):
        mask = torch.from_numpy(rng.random((C, R)) < 0.3).to(dev)
        idx = rng.integers(0, R, w).astype(np.int32)
        idx[:3] = R - 1
        idx[3:5] = idx[5]
        new = torch.from_numpy(rng.random((C, w)) < p_new).to(dev)
        idx_t = torch.from_numpy(idx).to(dev)
        same("delta", delta.delta_columns_cuda(mask, idx_t, new),
             delta.delta_columns_plain(mask, idx_t, new))
    # K6: every leaf dtype the pack holds at ranks 1-3, unaligned row
    # lengths, 1 and 256 rows, duplicate and last-row indices; units of
    # 1, 2, 4, 8 and 16 bytes, a leaf at an odd address (byte units),
    # a row of more units than 48 KB of shared memory holds, and more rows
    # than the grid's warps (the grid-stride loop)
    def leaves(n, wide=False):
        def ints(dtype, shape):
            return rng.integers(-99, 99, (n,) + shape).astype(dtype)
        tree = (
            {"valid": rng.random(n) < 0.5, "mode": ints(np.int8, ()),
             "odd": ints(np.int8, (3,)), "kind": ints(np.int32, ()),
             "labels": ints(np.int32, (5, 2)), "wide": ints(np.int64, (3,)),
             "pair": ints(np.int8, (2,)), "quad": rng.random((n, 2)),
             "at_odd_address": ints(np.int8, (4,))},
            {("a", "b"): {"tcode": ints(np.int8, (7,)),
                          "sid": ints(np.int32, (7,)),
                          "num": rng.random((n, 7)),
                          "mask": rng.random((n, 7)) < 0.5},
             ("c",): {"cube": ints(np.int32, (2, 3, 2))}},
        )
        if wide:
            # 6,201 byte units: 49.6 KB of unit table
            tree[1][("d",)] = {"long": ints(np.int8, (6201,))}
        return tree

    def on_card(tree):
        """The tree on the card, its odd-address leaf one byte into a
        buffer of its own."""
        t = state_from_numpy(tree, dev)
        leaf = t[0]["at_odd_address"]
        buf = torch.zeros(leaf.numel() + 1, dtype=torch.int8, device=dev)
        t[0]["at_odd_address"] = buf[1:].view(leaf.shape)
        t[0]["at_odd_address"].copy_(leaf)
        assert t[0]["at_odd_address"].data_ptr() % 2 == 1
        return t

    for cap_rows, wide, idx in (
            (1000, False, np.array([999])), (1000, False, np.array([4])),
            (1000, False, rng.permutation(1000)[:256]),
            (1000, False, np.array([999, 7, 7, 999, 0])),
            (300, True, rng.permutation(300)[:40]),
            (20000, False, rng.permutation(20000)[:9000])):
        base = leaves(cap_rows, wide)
        fresh = leaves(len(idx), wide)
        # a duplicate index carries the same row, as the driver's do
        first = {}
        src = [first.setdefault(int(r), j) for j, r in enumerate(idx)]
        fresh = take_rows(fresh, np.asarray(src))
        a, b = on_card(base), on_card(base)
        st = scatter.stage_rows(a, idx, fresh)
        assert st.lay.shared_bytes > 48 * 1024 or not wide
        scatter.scatter_staged_cuda(st)
        scatter.scatter_rows_plain(b, idx, fresh)
        same("scatter", tuple(_tensors(a)), tuple(_tensors(b)))
    check_join_edges(rng, dev, same)
    check_program_edges(rng, dev, same)
    check_fold_edges(rng, dev, same)
    check_delta_fold_edges(rng, dev, same)
    check_packbits_edges(rng, dev, same)
    torch.cuda.synchronize()
    return checked


def check_fold_edges(rng, dev, same):
    """K9's review mode (the groups, and both masks packed in the same
    launch) against program_eval_plain and
    pack_review_masks_plain, exactly, with the row limit lifted so the
    fold runs at every R: R of 1, 7, 8, 9, 256 and 4,099 (pad bits, the
    byte path, both of K9's layouts); C of 1 (one group, one block) and 3
    (a group of two rows, a group that covers no rows, a row of no group),
    and the ten edge programs with rows of no group between them (20
    blocks at R = 4,099); masks all true, all false and random; and at R =
    8 an autoreject mask one byte into its buffer (the byte path).  Each
    call launches K9 once in its review mode and K10 never; then two calls
    whose groups have no rows, which launch K10 alone."""
    import torch

    from gatekeeper_tpu_torch import device as gdev
    from gatekeeper_tpu_torch.ops import packbits, program, progcode

    encs = [progcode.encode(pr) for pr in edge_programs()]
    names = ("program", "program_pack", "packbits")

    def check(mask, rej, groups, fold=True):
        out = packbits.packed_empty(*mask.shape, dev)
        before = {k: gdev.launches[k] for k in names}
        got = program.program_eval_cuda(mask.clone(), groups,
                                        pack=(rej, out))
        plain = program.program_eval_plain(mask.clone(), groups)
        want = packbits.pack_review_masks_plain(plain, rej)
        torch.cuda.synchronize()
        ran = {k: gdev.launches[k] - before[k] for k in names}
        if ran != {"program": 0, "program_pack": int(fold),
                   "packbits": int(not fold)}:
            raise AssertionError(f"K9's pack: launches {ran}")
        same("program_pack", (got, out), (plain, want))

    def layouts(R):
        env = lambda B: _edge_env(rng, dev, B, R, 3, 3)  # noqa: E731
        yield 1, [program.bind_group(encs[0], env(1), 0)]
        two = program.bind_group(encs[1], env(2), 0)
        yield 3, [two, dict(program.bind_group(encs[2], env(1), 2), B=0)]
        groups, start = [], 0
        for i, enc in enumerate(encs):
            groups.append(program.bind_group(enc, env(4), start))
            start += 4 + (1 if i % 3 == 0 else 0)  # a row of no group
        yield start + 2, groups

    with FoldAtEveryR():
        for R in (1, 7, 8, 9, 256, 4099):
            for C, groups in layouts(R):
                for fill in ("random", "all_true", "all_false"):
                    if fill == "random":
                        mask = torch.from_numpy(rng.random((C, R)) < 0.7)
                        rej = torch.from_numpy(rng.random((C, R)) < 0.3)
                    else:
                        mask = torch.full((C, R), fill == "all_true")
                        rej = ~mask
                    mask, rej = mask.to(dev), rej.to(dev)
                    check(mask, rej, groups)
                    if R == 8:
                        buf = torch.zeros(C * R + 1, dtype=torch.bool,
                                          device=dev)
                        buf[1:] = rej.reshape(-1)
                        check(mask, buf[1:].view(C, R), groups)
        _C, (g, _none) = list(layouts(8))[1]
        mask = torch.from_numpy(rng.random((3, 8)) < 0.5).to(dev)
        check(mask, ~mask, [], fold=False)
        check(mask, ~mask, [dict(g, B=0)], fold=False)


def check_delta_fold_edges(rng, dev, same):
    """K9's delta mode (the groups, and the delta sweep's before | after
    columns in the same launch) against program_eval_plain and
    delta_columns_plain, exactly, with the row limit lifted so the fold
    runs at every w: w of 8, 16, 64, 256 and 512 (a power of two >= 8, as
    the driver pads, in both of K9's layouts) and 13 (off the thread's V
    rows); C of 1 (one group, one block), 3 (a group of two rows, a group
    that covers no rows, a row of no group) and the ten edge programs with
    rows of no group between them and after them; resident masks of 13
    and 4,099 columns, one of them one byte into its buffer; indices at 0
    and at the last column, random, and the last quarter padding (the
    last index repeated); masks all true, all false and random.  Each call
    launches K9 once in its delta mode and K5 never; then calls whose
    groups have no rows, which launch K5 alone, and one past a row limit
    of 8, which launches K9 and then K5."""
    import numpy as np
    import torch

    from gatekeeper_tpu_torch import device as gdev
    from gatekeeper_tpu_torch.ops import delta, program, progcode

    encs = [progcode.encode(pr) for pr in edge_programs()]
    names = ("program", "program_delta", "delta")

    def check(mask, resident, idx, groups, want_ran):
        C, w = mask.shape
        out = torch.empty((C, 2 * w), dtype=torch.int8, device=dev)
        before = {k: gdev.launches[k] for k in names}
        got = program.program_eval_cuda(mask.clone(), groups,
                                        delta=(resident, idx, out))
        plain = program.program_eval_plain(mask.clone(), groups)
        want = delta.delta_columns_plain(resident, idx, plain)
        torch.cuda.synchronize()
        ran = {k: gdev.launches[k] - before[k] for k in names}
        if ran != want_ran:
            raise AssertionError(f"K9's delta mode: launches {ran}")
        same("program_delta", (got, out), (plain, want))

    fold = {"program": 0, "program_delta": 1, "delta": 0}

    def layouts(w):
        env = lambda B: _edge_env(rng, dev, B, w, 3, 3)  # noqa: E731
        yield 1, [program.bind_group(encs[0], env(1), 0)]
        two = program.bind_group(encs[1], env(2), 0)
        yield 3, [two, dict(program.bind_group(encs[2], env(1), 2), B=0)]
        groups, start = [], 0
        for i, enc in enumerate(encs):
            groups.append(program.bind_group(enc, env(4), start))
            start += 4 + (1 if i % 3 == 0 else 0)  # a row of no group
        yield start + 2, groups

    def indices(w, Rt):
        idx = rng.integers(0, Rt, w).astype(np.int32)
        idx[0], idx[1] = 0, Rt - 1
        pad = w - w // 4
        idx[pad:] = idx[pad - 1]
        return torch.from_numpy(idx).to(dev)

    with FoldAtEveryR("DELTA_IN_K9_MAX_ROWS"):
        for w in (8, 13, 16, 64, 256, 512):
            for C, groups in layouts(w):
                for Rt in (13, 4099):
                    idx = indices(w, Rt)
                    for fill in ("random", "all_true", "all_false"):
                        if fill == "random":
                            mask = torch.from_numpy(rng.random((C, w)) < 0.7)
                            res = torch.from_numpy(rng.random((C, Rt)) < 0.4)
                        else:
                            mask = torch.full((C, w), fill == "all_true")
                            res = ~torch.full((C, Rt), fill == "all_true")
                        mask, res = mask.to(dev), res.to(dev)
                        check(mask, res, idx, groups, fold)
                    if Rt == 13:
                        buf = torch.zeros(C * Rt + 1, dtype=torch.bool,
                                          device=dev)
                        buf[1:] = res.reshape(-1)
                        check(mask, buf[1:].view(C, Rt), idx, groups, fold)
        _C, (g, _none) = list(layouts(8))[1]
        mask = torch.from_numpy(rng.random((3, 8)) < 0.5).to(dev)
        res = torch.from_numpy(rng.random((3, 40)) < 0.5).to(dev)
        idx = indices(8, 40)
        alone = {"program": 0, "program_delta": 0, "delta": 1}
        check(mask, res, idx, [], alone)
        check(mask, res, idx, [dict(g, B=0)], alone)
    limit = program.DELTA_IN_K9_MAX_ROWS
    program.DELTA_IN_K9_MAX_ROWS = 8
    try:
        C, groups = list(layouts(16))[2]
        mask = torch.from_numpy(rng.random((C, 16)) < 0.7).to(dev)
        res = torch.from_numpy(rng.random((C, 99)) < 0.5).to(dev)
        check(mask, res, indices(16, 99), groups,
              {"program": 1, "program_delta": 0, "delta": 1})
    finally:
        program.DELTA_IN_K9_MAX_ROWS = limit


def check_packbits_edges(rng, dev, same):
    """K10 on inputs the main path does not reach (a review's call has R a
    multiple of 8 and aligned inputs): R of 1, 7, 9, 13 and 4,099, whose
    last byte has pad bits, with C of 0, 1 and 3, masks all true, all
    false and random, each once from the start of its tensor and once as
    a row slice one row into a larger one (a pointer R bytes in; no R
    here is a multiple of 8, so none is 8-byte aligned); then R of 8 and
    16 from a buffer one byte in, where the 64-bit word path must be
    refused.  Each
    also against numpy's packbits of the same masks on the host."""
    import numpy as np
    import torch

    from gatekeeper_tpu_torch.ops import packbits

    def check(mask, rej):
        got = packbits.pack_review_masks_cuda(mask, rej)
        same("packbits", got, packbits.pack_review_masks_plain(mask, rej))
        host = np.packbits(np.concatenate(
            [mask.cpu().numpy(), rej.cpu().numpy()]), axis=1)
        if not np.array_equal(got.cpu().numpy(), host):
            raise AssertionError("packbits: kernel != numpy packbits")

    for R in (1, 7, 9, 13, 4099):
        for C in (0, 1, 3):
            for fill in ("all_true", "all_false", "random"):
                if fill == "random":
                    m = rng.random((C + 1, R)) < 0.5
                    a = rng.random((C + 1, R)) < 0.3
                else:
                    m = np.full((C + 1, R), fill == "all_true")
                    a = ~m
                big_m = torch.from_numpy(m).to(dev)
                big_a = torch.from_numpy(a).to(dev)
                check(big_m[:C], big_a[:C])
                check(big_m[1:], big_a[1:])
    for R in (8, 16):
        for C in (1, 3):
            buf = torch.from_numpy(rng.random(2 * C * R + 1) < 0.5).to(dev)
            check(buf[1:1 + C * R].view(C, R),
                  buf[1 + C * R:].view(C, R))


def check_join_edges(rng, dev, same):
    """K7 (its table and dense counts) and K8 in both modes against their
    plain versions on seeded edge cases (see check_edges), then K7 and its
    merge at vocabulary sizes around their grid's chunks
    (check_join_vocab_edges)."""
    import numpy as np
    import torch

    from gatekeeper_tpu_torch.ops import joinkernel, joinkeys, joinlookup
    from gatekeeper_tpu_torch.ops.interning import Interner

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    it = Interner()
    for i in range(50):
        it.intern(f"k{i}")
    twins = [joinkernel.intern_join_key(v, it) for v in (5, "5", 5.0)]
    assert twins[0] == twins[2] != twins[1]
    V = len(it)
    cases = []  # (name, R, S or None for a scalar column, sid)
    for R, S in ((1000, 3), (257, 1), (300, 40), (8, 2)):
        shape = (R,) if S is None else (R, S)
        sid = rng.integers(-6, V, shape).astype(np.int32)
        cases.append(("random", R, S, sid))
    cases.append(("scalar", 777, None,
                  rng.integers(-2, V, 777).astype(np.int32)))
    cases.append(("one_key", 513, 2, np.full((513, 2), 7, np.int32)))
    dup = rng.integers(0, 4, (200, 6)).astype(np.int32)  # repeats in rows
    cases.append(("dup_in_row", 200, 6, dup))
    twin = rng.choice(np.array(twins[:2] + [V - 1], np.int32), (99, 3))
    cases.append(("twins_and_largest_id", 99, 3, twin))
    for name, R, S, sid in cases:
        shape = sid.shape
        mask = None if S is None else t(rng.random(shape) < 0.8)
        for scope in ("none", "mixed"):
            valid = rng.random(R) < (0.0 if scope == "none" else 0.9)
            kind = rng.integers(0, 3, R).astype(np.int32)
            ns_empty = rng.random(R) < 0.4
            rv = (t(valid), t(kind), t(ns_empty))
            for namespaced in (True, False):
                args = (*rv, t(sid), mask, 1, namespaced, V)
                uk, uc, dense = joinkeys.join_keys_cuda(*args)
                same("joinkeys", (uk, uc, dense),
                     joinkeys.join_keys_plain(*args))
                if scope == "none":
                    assert not bool((uk != int(joinkernel.KEY_INVALID)).any())
                q_np = rng.integers(-6, V + 3, shape).astype(np.int32)
                q_np.reshape(-1)[:4] = (joinkernel.UNKNOWN_KEY, -1, V - 1,
                                        twins[1])
                q = t(q_np)
                for sc in (None, (*rv, 1, namespaced), (*rv, 2, namespaced)):
                    lookup_both_modes(same, uk, uc, dense, q, sc)
    # the host index's power-of-two tables, TABLE_MIN wide and wider
    for n_keys in (0, 3, joinkernel.TABLE_MIN, 40):
        keys = np.sort(rng.choice(V, n_keys, replace=False)).astype(np.int32)
        width = max(joinkernel.TABLE_MIN, 1 << max(0, n_keys - 1).bit_length())
        uk = np.full(width, joinkernel.KEY_INVALID, np.int32)
        uc = np.zeros(width, np.int32)
        uk[:n_keys] = keys
        uc[:n_keys] = rng.integers(1, 9, n_keys)
        for R, S in ((37, None), (300, 2), (8, 33)):
            shape = (R,) if S is None else (R, S)
            q_np = rng.integers(-6, V + 3, shape).astype(np.int32)
            if n_keys:
                q_np.reshape(-1)[::3] = keys[0]
            q = t(q_np)
            rv = (t(rng.random(R) < 0.9),
                  t(rng.integers(0, 3, R).astype(np.int32)),
                  t(rng.random(R) < 0.5))
            for sc in (None, (*rv, 1, True), (*rv, 1, False)):
                same("joinlookup",
                     joinlookup.join_lookup_cuda(t(uk), t(uc), q, sc),
                     joinlookup.join_lookup_plain(t(uk), t(uc), q, sc))
    check_table_lookup_edges(rng, dev, same)
    check_join_vocab_edges(rng, dev, same)


def check_table_lookup_edges(rng, dev, same):
    """K8's table mode, one launch for several lookups (join_lookup_many),
    against the plain version lookup by lookup, exactly: tables of T = 0,
    1, 8, 31, 32, 33, 1,000, 65,536 and 2^20 entries (the last ones with
    K7's or the host index's KEY_INVALID tail), lookups of different T, S
    (a scalar column, 1, 2 and 33 slots) and scope (none, namespaced,
    cluster) in one launch, an empty lookup (R = 0) among them, and queries
    at UNKNOWN_KEY, -1, the first and the last key, between keys and past
    every key.  Each call launches K8's table mode once (none where no
    lookup has a query); each lookup also alone (join_lookup_cuda)."""
    import numpy as np
    import torch

    from gatekeeper_tpu_torch import device as gdev
    from gatekeeper_tpu_torch.ops import joinkernel, joinlookup

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def table(T, n_keys, vocab):
        keys = np.sort(rng.choice(vocab, n_keys, replace=False))
        uk = np.full(T, joinkernel.KEY_INVALID, np.int32)
        uc = np.zeros(T, np.int32)
        uk[:n_keys] = keys
        uc[:n_keys] = rng.integers(1, 50, n_keys)
        return uk, uc

    def lookup(T, n_keys, R, S, scope):
        vocab = max(2 * n_keys, 16)
        uk, uc = table(T, n_keys, vocab)
        shape = (R,) if S is None else (R, S)
        q = rng.integers(-6, vocab + 3, shape).astype(np.int32)
        flat = q.reshape(-1)
        special = [joinkernel.UNKNOWN_KEY, -1, vocab + 2]
        if n_keys:
            special += [uk[0], uk[n_keys - 1], uk[n_keys - 1] + 1]
        flat[:min(len(flat), len(special))] = special[:len(flat)]
        if n_keys and len(flat) > len(special):  # hits inside the table
            hit = rng.random(len(flat)) < 0.5
            flat[hit] = rng.choice(uk[:n_keys], int(hit.sum()))
        sc = None
        if scope is not None:
            sc = (t(rng.random(R) < 0.8),
                  t(rng.integers(0, 3, R).astype(np.int32)),
                  t(rng.random(R) < 0.5), 1, scope)
        return t(uk), t(uc), t(q), sc

    def check(lookups):
        before = gdev.launches["joinlookup_table"]
        got = joinlookup.join_lookup_many_cuda(lookups)
        want = joinlookup.join_lookup_many_plain(lookups)
        torch.cuda.synchronize()
        n = gdev.launches["joinlookup_table"] - before
        if n != int(any(lk[2].numel() for lk in lookups)):
            raise AssertionError(f"K8's table mode: {n} launches")
        same("joinlookup_table", tuple(got), tuple(want))
        for lk, w in zip(lookups, want):
            same("joinlookup_table", joinlookup.join_lookup_cuda(*lk), w)

    # (T, keys, R, S, scope): S None a scalar column; scope None, True
    # (namespaced) or False (cluster)
    shapes = [(0, 0, 5, None, None), (1, 1, 40, 2, True),
              (8, 8, 33, None, False), (8, 3, 16, 2, None),
              (31, 31, 70, 1, True), (32, 32, 64, 2, False),
              (33, 20, 9, 33, None), (1000, 999, 300, 2, True),
              (65536, 40000, 32, 2, None), (65536, 65536, 1, None, False),
              (1 << 20, 700000, 257, 2, True), (16, 5, 0, 2, True)]
    every = [lookup(*sh) for sh in shapes]
    for lk in every:
        check([lk])
    check(every)
    check(every[::-1])
    check([every[-1]])  # only an empty lookup: no launch
    check([every[2], every[-1], every[8]])  # an empty one between two


def lookup_both_modes(same, uk, uc, dense, q, scope):
    """K8 in table mode and in dense mode on the same queries, each
    against the plain version (and so against each other); the queries'
    second slot column too where q is [R, 2] (unaligned: the dense mode's
    one-query-a-thread path)."""
    from gatekeeper_tpu_torch.ops import joinlookup

    qs = [q]
    if q.dim() == 2 and q.shape[1] == 2 and q.shape[0] > 1:
        # rows 1.. of a [R, 2] tensor offset by one int: 4-byte aligned
        flat = q.reshape(-1)[1:1 + 2 * (q.shape[0] - 1)]
        qs.append(flat.view(q.shape[0] - 1, 2))
    for qq in qs:
        sc = scope
        if sc is not None and qq.shape[0] != q.shape[0]:
            sc = tuple(a[1:] for a in sc[:3]) + tuple(sc[3:])
        plain = joinlookup.join_lookup_plain(uk, uc, qq, sc)
        same("joinlookup", joinlookup.join_lookup_cuda(uk, uc, qq, sc),
             plain)
        same("joinlookup",
             joinlookup.join_lookup_cuda(uk, uc, qq, sc, dense=dense), plain)


def check_join_vocab_edges(rng, dev, same):
    """K7 at vocabulary sizes V around its grid (G blocks, block b taking
    the b-th chunk of ceil(V / G) ids in passes of P threads): V = 1, 2,
    one pass and one more or less, G and one more or less, G passes and
    one more or less, and past them; at each, rows whose keys are random,
    fall in a few chunks only (runs of chunks with no key between keyed
    ones), cover every id (u = V), or are absent; K8 in both modes on
    queries at -1, UNKNOWN_KEY, V - 1, V and V + 2.  Then the merge of W
    = 2, 3, 4 and 8 shard tables whose keys sit on chunk boundaries,
    against the plain merge and the whole row axis's table.  Exact."""
    import numpy as np
    import torch

    from gatekeeper_tpu_torch.ops import joinkernel, joinkeys

    invalid = int(joinkernel.KEY_INVALID)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    G = joinkeys.grid_size(dev)
    P = joinkeys.block_size()
    vocabs = sorted({1, 2, P - 1, P, P + 1, G - 1, G, G + 1, G * P - 1,
                     G * P, G * P + 1, 3 * G * P + 5})
    for V in vocabs:
        chunk = -(-V // G)
        keyed = sorted({0, G // 3, G - 1})  # chunks that hold keys
        for layout in ("random", "chunks", "every", "none"):
            if layout == "every":
                R = V
                sid = np.stack([rng.permutation(V),
                                rng.integers(0, V, V)], 1).astype(np.int32)
            else:
                R = min(4 * V + 7, 60_000)
                if layout == "random":
                    sid = rng.integers(-2, V, (R, 2))
                elif layout == "chunks":
                    b = rng.choice(keyed, (R, 2))
                    sid = np.minimum(b * chunk + rng.integers(0, chunk,
                                                              (R, 2)), V - 1)
                else:
                    sid = np.full((R, 2), -1)
                sid = sid.astype(np.int32)
            valid = t(np.ones(R, bool) if layout == "every"
                      else rng.random(R) < 0.9)
            kind = t(np.ones(R, np.int32))
            ns_empty = t(np.zeros(R, bool))
            mask = t(np.ones((R, 2), bool) if layout == "every"
                     else rng.random((R, 2)) < 0.9)
            args = (valid, kind, ns_empty, t(sid), mask, 1, True, V)
            uk, uc, dense = joinkeys.join_keys_cuda(*args)
            same("joinkeys", (uk, uc, dense), joinkeys.join_keys_plain(*args))
            u = int((uk != invalid).sum().item())
            if layout == "every" and u != V:
                raise AssertionError(f"joinkeys: {u} keys at V = {V}, not V")
            if layout == "none" and u:
                raise AssertionError(f"joinkeys: {u} keys with none held")
            q = rng.integers(-6, V + 3, (R, 2)).astype(np.int32)
            odd = np.array([-1, joinkernel.UNKNOWN_KEY, V - 1, V, V + 2])
            q.reshape(-1)[:min(5, q.size)] = odd[:q.size]
            lookup_both_modes(same, uk, uc, dense, t(q),
                              (valid, kind, ns_empty, 1, True))
    # the merge: keys on the merge grid's chunk boundaries, in W slabs
    GM = joinkeys.grid_size(dev, merge=True)
    for V in (GM * P + 1, 3 * GM * P + 5):
        chunk = -(-V // GM)
        edges = np.arange(1, GM) * chunk
        near = np.concatenate([edges - 1, edges, edges + 1])
        near = near[(near >= 0) & (near < V)].astype(np.int32)
        R = 20_000
        sid = rng.choice(near, (R, 2)).astype(np.int32)
        valid, kind = t(rng.random(R) < 0.9), t(np.ones(R, np.int32))
        ns_empty, mask = t(np.zeros(R, bool)), t(rng.random((R, 2)) < 0.9)
        whole = joinkeys.join_keys_plain(valid, kind, ns_empty, t(sid), mask,
                                         1, True, V)
        u = int((whole[0] != invalid).sum().item())
        for W in (2, 3, 4, 8):
            cuts = np.linspace(0, R, W + 1).astype(int)
            uks, ucs = [], []
            for a, b in zip(cuts, cuts[1:]):
                args = (valid[a:b], kind[a:b], ns_empty[a:b], t(sid[a:b]),
                        mask[a:b], 1, True, V)
                got = joinkeys.join_keys_cuda(*args)
                same("joinkeys", got, joinkeys.join_keys_plain(*args))
                uks.append(got[0])
                ucs.append(got[1])
            cat = (torch.cat(uks), torch.cat(ucs), V)
            merged = joinkeys.merge_key_tables_cuda(*cat)
            same("joinkeys_merge", merged,
                 joinkeys.merge_key_tables_plain(*cat))
            same("joinkeys_merge", (merged[0][:u], merged[1][:u], merged[2]),
                 (whole[0][:u], whole[1][:u], whole[2]))


def _edge_env(rng, dev, B, R, S, P, K=4):
    """A seeded EvalEnv on the card for check_program_edges: a scalar
    column, two slot columns of one iteration group and one of another,
    a key set of width K, two join key columns, two parameters, a
    parameter array of width P with a sub-field, predicate tables per
    constraint and per element, and a join binding in 'tables' mode; every
    type code, -0.0, NaN and infinities among the numbers."""
    import numpy as np
    import torch

    from gatekeeper_tpu_torch.convert import (
        group_params_from_numpy, state_from_numpy)
    from gatekeeper_tpu_torch.ops import joinkernel, vexpr

    V, U = 40, 4

    def typed(shape):
        t = rng.integers(0, 7, shape).astype(np.int8)
        odd = rng.random(shape)
        num = rng.integers(-4, 5, shape) / 2.0
        num = np.where(odd < 0.1, -0.0, num)
        num = np.where(odd > 0.95, np.nan, num)
        num = np.where((odd > 0.9) & (odd <= 0.95), np.inf, num)
        return {"tcode": t,
                "sid": np.where(t == 5, rng.integers(-1, V, shape),
                                -1).astype(np.int32),
                "num": np.where(t == 4, num, 0.0)}

    ks = edge_keys()
    slot = typed((R, S))
    slot["mask"] = rng.random((R, S)) < 0.7
    slot2 = typed((R, S))
    slot2["mask"] = slot["mask"]
    other = typed((R, 2))
    other["mask"] = rng.random((R, 2)) < 0.5
    keys = rng.integers(0, 6, (R, K)).astype(np.int32)
    keys[rng.random((R, K)) < 0.4] = -2
    jk = rng.integers(-1, 8, R).astype(np.int32)
    jk[rng.random(R) < 0.15] = joinkernel.UNKNOWN_KEY
    js = rng.integers(-1, 8, (R, 2)).astype(np.int32)
    js[rng.random((R, 2)) < 0.2] = joinkernel.UNKNOWN_KEY
    cols = {ks["scalar"]: typed((R,)), ks["slot"]: slot, ks["slot2"]: slot2,
            ks["other"]: other, ks["jkey"]: {"sid": jk},
            ks["jslot"]: {"sid": js, "mask": rng.random((R, 2)) < 0.9}}
    elem = typed((B, P))
    elem["mask"] = rng.random((B, P)) < 0.7
    elem["sid"] = np.where(elem["mask"], rng.integers(0, 6, (B, P)),
                           -1).astype(np.int32)
    sub = typed((B, P))
    sub["mask"] = elem["mask"]
    params = {("p",): typed((B,)), ("q",): typed((B,)),
              ("__lit__", "x"): {"tcode": np.array([5], np.int8),
                                 "sid": np.array([3], np.int32),
                                 "num": np.zeros(1)}}
    elems = {(("arr",), ()): elem, (("arr",), ("sub",)): sub}
    tables = {0: ((rng.random((U, V)) < 0.5).astype(np.uint8),
                  rng.integers(0, U, B).astype(np.int32)),
              1: ((rng.random((U, V)) < 0.5).astype(np.uint8),
                  rng.integers(0, U, (B, P)).astype(np.int32))}
    gp, ge, gt = group_params_from_numpy([(params, elems, tables)], dev)[0]
    tcols = state_from_numpy(cols, dev)
    env = vexpr.EvalEnv(tcols, gp, ge, gt,
                        {ks["keys"]: torch.from_numpy(keys).to(dev)}, B, R,
                        dev)
    uk = np.full(8, int(joinkernel.KEY_INVALID), np.int32)
    uk[:5] = [0, 2, 3, 5, 7]
    uc = np.zeros(8, np.int32)
    uc[:5] = rng.integers(1, 4, 5)
    rv = state_from_numpy({"valid": rng.random(R) < 0.9,
                           "kind": rng.integers(0, 3, R).astype(np.int32),
                           "ns_empty": rng.random(R) < 0.4}, dev)
    args = {"uk": torch.from_numpy(uk).to(dev),
            "uc": torch.from_numpy(uc).to(dev), "kind_id": 1}
    env.joins = joinkernel.JoinBinding("tables", edge_plans(), [args, args],
                                       rv=rv)
    return env


def edge_keys() -> dict:
    it, it2 = (("spec", "c", "[]"),), (("spec", "v", "[]"),)
    return {"scalar": ("scalar", (), ("a",), ()), "iter": it, "iter2": it2,
            "slot": ("slot", it, ("image",), ()),
            "slot2": ("slot", it, ("name",), ()),
            "other": ("slot", it2, ("name",), ()),
            "keys": ("keyset", (("metadata", "labels"),), (), ()),
            "jkey": ("joinkey", "host"), "jslot": ("joinkey", "hosts")}


def edge_plans() -> tuple:
    from gatekeeper_tpu_torch.ops.joinkernel import JoinPlan

    ks = edge_keys()
    return (
        JoinPlan(agg="dup", local_colkey=ks["jkey"], local_slot=False,
                 remote_scope="namespace", remote_kind="Kind",
                 remote_colkey=ks["jkey"], remote_slot=False),
        JoinPlan(agg="count", local_colkey=ks["jslot"], local_slot=True,
                 remote_scope="cluster", remote_kind="Kind",
                 remote_colkey=ks["jslot"], remote_slot=True),
    )


def edge_programs() -> list:
    """Programs over _edge_env covering every node kind and both
    polarities; the last one needs a deep stack, one has no clauses."""
    from gatekeeper_tpu_torch.ops import vexpr as v

    ks = edge_keys()
    sc, sl, sl2 = (v.ColRef(ks["scalar"], False), v.ColRef(ks["slot"], True),
                   v.ColRef(ks["slot2"], True))
    p, q, el = v.ParamRef(("p",)), v.ParamRef(("q",)), v.ParamElemRef(("arr",))
    sub = v.ParamElemRef(("arr",), ("sub",))
    ops = ["==", "!=", "<", "<=", ">", ">="]

    def prog(clauses):
        return v.VProgram(clauses, [], [], [], join_plans=edge_plans())

    deep = v.Truthy(sc)
    for _ in range(13):
        deep = v.BoolOp("and", (v.Truthy(p), v.BoolOp("or", (
            v.Const(False), deep))))
    return [
        prog([v.Clause((v.Cmp(op, sc, p, unknown_default=i % 2 == 0),))
              for i, op in enumerate(ops)]),
        prog([v.Clause((v.Cmp(op, sl, v.Lit(0.5), unknown_default=i % 2 == 1),
                        v.Cmp(op, v.Lit(True), sc)), slot_iter=ks["iter"])
              for i, op in enumerate(ops)]),
        prog([v.Clause((v.Truthy(sc, negate=True), v.BoolOp("not", (
            v.Truthy(q),)))), v.Clause((v.Cmp("==", v.Lit("x"), sc),
                                        v.Truthy(p)))]),
        prog([v.Clause((v.StrPred("startswith", sc, p, pred_id=0),)),
              v.Clause((v.StrPred("contains", p, v.Lit("x"), pred_id=0,
                                  negate=True), v.Truthy(sc))),
              v.Clause((v.StrPred("startswith", sl, v.Lit("x"), pred_id=0,
                                  negate=True),), slot_iter=ks["iter"])]),
        prog([v.Clause((v.AnyParam(("arr",), (
            v.StrPred("endswith", sl, el, pred_id=1),
            v.Cmp("!=", sub, sl2))),), slot_iter=ks["iter"]),
            v.Clause((v.AnyParam(("arr",), (v.StrPred(
                "endswith", sub, el, pred_id=1),)), v.Truthy(sc)))]),
        prog([v.Clause((v.SetCountCmp(("paramids", (("arr",), ())),
                                      ("keyset", ks["keys"]), op, 1),))
              for op in (">", "<=")] +
             [v.Clause((v.SetCountCmp(("keyset", ks["keys"]),
                                      ("paramids", (("arr",), ())), op, 0),
                        v.Truthy(sc)))
              for op in ("==", "!=")]),
        prog([v.Clause((v.Truthy(sc), v.ReduceSlots(
            (v.Cmp("==", sl, sl2), v.Truthy(q)), ks["iter"]))),
            v.Clause((), slot_iter=ks["iter2"]),
            v.Clause((v.BoolOp("not", (v.AnyParam(("arr",), (
                v.Truthy(sub),)),)), v.Truthy(sc)))]),
        prog([v.Clause((v.JoinCmp(0, op, v.Lit(1), exclude_self=i % 2 == 0,
                                  unknown_default=i % 3 == 0),
                        v.Truthy(sc)))
              for i, op in enumerate(ops)] +
             [v.Clause((v.JoinCmp(1, op, p, slot=True, exclude_self=True),),
                       slot_iter=ks["iter2"]) for op in ("<", ">=")]),
        prog([]),
        prog([v.Clause((deep,))]),
    ]


def check_program_edges(rng, dev, same):
    """K9 against the plain bytecode on seeded edge cases: every program
    of edge_programs at once, as groups of one launch with pad rows and
    rows of no group between them, for R of 1, a review's 8 and 16, off
    the thread's V rows and past a block, S = 0 and 3, P = 0, 1 and 3,
    masks all False, random and all True, and the random mask cut to every
    other row, every V-th row and the first V rows of every 32 V (rows of
    one thread and of one warp that disagree, in both of K9's layouts), so
    that clauses are decided and loops left for some of a warp's rows
    only; a key set of 12 keys; and the join comparisons
    without a binding.  Exact."""
    import torch

    from gatekeeper_tpu_torch.ops import program, progcode

    progs = edge_programs()
    encs = [progcode.encode(pr) for pr in progs]
    assert encs[-1].stack > 16, encs[-1].stack
    V = program.ROWS_PER_THREAD
    # (R, S, P, share of live cells, key-set width)
    for R, S, P, p_live, K in ((1, 3, 3, 1.0, 4), (8, 3, 3, 0.7, 4),
                               (16, 2, 1, 0.8, 4), (1000, 3, 1, 0.7, 12),
                               (1025, 0, 3, 0.7, 4), (4099, 3, 0, 0.5, 4),
                               (300, 3, 3, 0.0, 4)):
        B = 4
        groups, start = [], 0
        for i, enc in enumerate(encs):
            env = _edge_env(rng, dev, B, R, S, P, K)
            if i == 2:
                env.joins = None
            groups.append(program.bind_group(enc, env, start))
            start += B + (1 if i % 3 == 0 else 0)  # a row of no group
        base = torch.from_numpy(rng.random((start + 2, R)) < p_live).to(dev)
        r = torch.arange(R, device=dev)
        for lanes in (None, r % 2 == 0, r % V == V - 1, r % (32 * V) < V):
            mask = base.clone() if lanes is None else base & lanes[None, :]
            for g in groups[::2]:
                mask[g["start"] + B - 1] = False  # a pad row
            same("program",
                 program.program_eval_cuda(mask.clone(), groups),
                 program.program_eval_plain(mask.clone(), groups))
        mask = base.clone()
        for g in groups[::2]:
            mask[g["start"] + B - 1] = False  # the same pad rows
        unbound = []
        for g, enc in zip(groups, encs):
            env = _edge_env(rng, dev, B, R, S, P, K)
            env.joins = None
            unbound.append(program.bind_group(enc, env, g["start"]))
        same("program",
             program.program_eval_cuda(mask.clone(), unbound),
             program.program_eval_plain(mask.clone(), unbound))


class Churn:
    """Seeded store churn for the incremental audit: ``step(d)`` changes d
    stored pods on every client, a rotating mix of adds, modifications
    (labels dropped or changed, as tests/test_delta_sweep.py does) and
    deletions, each on its own pod, so d rows are dirtied.  Added pods
    draw from the corpus's generator at a 50% violation rate."""

    def __init__(self, clients, pods, seed: int):
        import random

        self.clients = clients
        self.live = {p["metadata"]["name"]: p for p in pods}
        self.pool = list(self.live)  # names a step may modify or delete
        self.rng = random.Random(seed)
        self.seed = seed
        self.n = 0

    def step(self, d: int) -> dict:
        import copy

        from gatekeeper_tpu_torch.util import synthetic as syn

        ops = [("add", "modify", "delete")[(self.n + j) % 3]
               for j in range(d)]
        n_add, n_mod = ops.count("add"), ops.count("modify")
        n_del = d - n_add - n_mod
        picks = self.rng.sample(range(len(self.pool)), n_mod + n_del)
        mods = [self.pool[i] for i in picks[:n_mod]]
        dels = [self.pool[i] for i in picks[n_mod:]]
        for j, pod in enumerate(syn.make_pods(n_add, seed=self.seed + self.n,
                                              violation_rate=0.5)):
            pod["metadata"]["name"] = f"churn-{self.n}-{j}"
            self.live[pod["metadata"]["name"]] = pod
            for c in self.clients:
                c.add_data(copy.deepcopy(pod))
        for name in mods:
            pod = copy.deepcopy(self.live[name])
            # always a change (an unchanged object dirties no row), and no
            # string the store has not seen
            pod["metadata"]["labels"] = next(
                lb for lb in ({}, {"owner": "core"}, {"owner": "plat"})
                if lb != pod["metadata"].get("labels"))
            self.live[name] = pod
            for c in self.clients:
                c.add_data(copy.deepcopy(pod))
        for name in dels:
            pod = self.live.pop(name)
            for c in self.clients:
                c.remove_data(pod)
        gone = set(dels)
        self.pool = [n for n in self.pool if n not in gone]
        self.pool.extend(f"churn-{self.n}-{j}" for j in range(n_add))
        self.n += d
        return {"add": n_add, "modify": n_mod, "delete": n_del}

    def add(self, n: int):
        """Add n new pods."""
        import copy

        from gatekeeper_tpu_torch.util import synthetic as syn

        for j, pod in enumerate(syn.make_pods(n, seed=self.seed + self.n,
                                              violation_rate=0.5)):
            pod["metadata"]["name"] = f"churn-{self.n}-{j}"
            self.live[pod["metadata"]["name"]] = pod
            for c in self.clients:
                c.add_data(copy.deepcopy(pod))
        self.pool.extend(f"churn-{self.n}-{j}" for j in range(n))
        self.n += n

    def grow(self, d: int) -> dict:
        """Change d stored pods without freeing a row: ceil(d / 2) added,
        the rest modified (as step does).  With no free row in the pack
        the added pods take rows past its last one, in the padded tail."""
        import copy

        n_add = (d + 1) // 2
        self.add(n_add)
        for name in self.rng.sample(self.pool[:-n_add], d - n_add):
            pod = copy.deepcopy(self.live[name])
            pod["metadata"]["labels"] = next(
                lb for lb in ({}, {"owner": "core"}, {"owner": "plat"})
                if lb != pod["metadata"].get("labels"))
            self.live[name] = pod
            for c in self.clients:
                c.add_data(copy.deepcopy(pod))
        return {"add": n_add, "modify": d - n_add, "delete": 0}


# the launches a churn sweep's record counts: K9 in its sweep and delta
# modes, K5, and K8's table mode
SWEEP_LAUNCHES = ("program", "program_delta", "delta", "joinlookup_table")


def delta_launches(w: int) -> dict:
    """What a delta sweep of w padded rows launches on one card: K9 in its
    delta mode up to ops/program.py DELTA_IN_K9_MAX_ROWS, else K9 and then
    K5."""
    from gatekeeper_tpu_torch.ops import program

    fold = w <= program.DELTA_IN_K9_MAX_ROWS
    return {"program": int(not fold), "program_delta": int(fold),
            "delta": int(not fold)}


def padded(d: int) -> int:
    """The delta path's width for d dirty rows: a power of two >= 8."""
    w = 8
    while w < d:
        w *= 2
    return w


def churn_sweep(client, driver, pauses, d: int, ops: dict):
    """One capped sweep after a churn step -> (its record, results,
    totals): wall, stages, path, rows, constraint-side re-packs, the
    garbage collector's pauses and the launches of SWEEP_LAUNCHES."""
    side0 = dict(driver.side_stats)
    before = {k: _dev().launches[k] for k in SWEEP_LAUNCHES}
    pauses.reset()
    t0 = time.perf_counter()
    resp, totals = client.audit_capped(CAP)
    wall_s = time.perf_counter() - t0
    st = driver.last_sweep_stats
    side = driver.side_stats
    rec = {
        "d": d, **ops, "s": wall_s,
        "path": "delta" if "delta_rows" in st else "full",
        **{k: st.get(k) for k in (
            "pack_ms", "device_ms", "render_ms", "delta_rows",
            "rendered_cells", "scatter_rows", "upload_bytes", "scatter_ms",
        )},
        "side_repacks": side["repacks"] - side0["repacks"],
        "side_ms": side["pack_ms"] + side["upload_ms"]
        - side0["pack_ms"] - side0["upload_ms"],
        "gc_ms": pauses.ms, "gc_gen2": pauses.gen2,
        "launches": {k: _dev().launches[k] - before[k]
                     for k in SWEEP_LAUNCHES},
    }
    return rec, resp, totals


def churn_path(client, driver, churn: Churn, pauses):
    """Phase 6's counted run: CHURN_SWEEPS delta sweeps for each d in
    CHURN_D, each launching K9's delta mode once and K5 never (up to the
    fold's row limit; past it K9 and then K5), each d closed by a forced
    full sweep that must agree with it; a sweep at CHURN_FULL_D (the full
    path); a full sweep after 256 changes with the delta path off (the row
    scatter).  -> the number of delta sweeps."""
    import numpy as np

    from gatekeeper_tpu_torch.convert import tree_nbytes
    from gatekeeper_tpu_torch.util import synthetic as syn

    stages = ("pack_ms", "device_ms", "render_ms")
    n_delta = 0
    for d in CHURN_D:
        sweeps = []
        want = dict(delta_launches(padded(d)), joinlookup_table=0)
        for _ in range(CHURN_SWEEPS):
            rec, resp, totals = churn_sweep(client, driver, pauses, d,
                                            churn.step(d))
            sweeps.append(rec)
            if rec["path"] != "delta" or rec["delta_rows"] != d or \
                    rec["launches"] != want:
                raise AssertionError(f"churn d={d}: {rec}, want {want}")
            n_delta += 1
        counts = driver._delta_state.counts.copy()
        sig = syn.audit_result_sig(resp.results())
        driver._delta_state = None
        driver._audit_cache = None
        full, f_resp, f_totals = churn_sweep(client, driver, pauses, d, {})
        equal = {
            "totals": f_totals == totals,
            "results": syn.audit_result_sig(f_resp.results()) == sig,
            "counts": bool(np.array_equal(driver._delta_state.counts, counts)),
        }
        if full["path"] != "full" or not all(equal.values()):
            raise AssertionError(f"churn d={d}: delta != full {equal}")
        walls = [r["s"] for r in sweeps]
        log("churn_sweeps", d=d, n=len(sweeps),
            median_s=statistics.median(walls), worst_s=max(walls),
            median_stage_ms={k: statistics.median(r[k] for r in sweeps)
                             for k in stages},
            equal_to_full=equal, results=len(sig), sweeps=sweeps,
            full_sweep=full)
    rec, _resp, _totals = churn_sweep(client, driver, pauses, CHURN_FULL_D,
                                      churn.step(CHURN_FULL_D))
    if rec["path"] != "full":
        raise AssertionError(f"d={CHURN_FULL_D} took the delta path")
    log("churn_full_path", **rec)
    driver.delta_enabled = False
    rec, _resp, _totals = churn_sweep(client, driver, pauses, 256,
                                      churn.step(256))
    driver.delta_enabled = True
    ap = driver._audit_pack
    full_bytes = tree_nbytes((ap.rp, ap.cols))
    if rec["scatter_rows"] != 256:
        raise AssertionError(f"full sweep after 256 changes: {rec}")
    log("full_after_churn", full_upload_bytes=full_bytes,
        upload_share=rec["upload_bytes"] / full_bytes, **rec)
    return n_delta


class JoinIndexTimer:
    """Host time of the join-group index, per sweep, each method wrapped
    for the run: ``ms`` the driver's _ensure_join_state on full sweeps,
    JoinState.affected and commit on delta sweeps; ``tables_ms``
    JoinState.delta_tables, which a delta sweep calls inside its device
    stage for the tables it uploads."""

    def __init__(self, driver):
        from gatekeeper_tpu_torch.ops import joinkernel

        self.driver, self.cls = driver, joinkernel.JoinState
        self.ms = self.tables_ms = 0.0

    def _timed(self, fn, attr="ms"):
        def wrapped(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                setattr(self, attr, getattr(self, attr)
                        + (time.perf_counter() - t0) * 1e3)
        return wrapped

    def __enter__(self):
        self.saved = [(self.cls, n, getattr(self.cls, n))
                      for n in ("affected", "commit", "delta_tables")]
        for cls, n, fn in self.saved:
            setattr(cls, n, self._timed(
                fn, "tables_ms" if n == "delta_tables" else "ms"))
        self.driver._ensure_join_state = self._timed(
            self.driver._ensure_join_state)
        return self

    def __exit__(self, *exc):
        for cls, n, fn in self.saved:
            setattr(cls, n, fn)
        del self.driver._ensure_join_state


class RefChurn:
    """Seeded churn of the referential corpus.  ``neutral(d)``: d Pods of
    one-pod teams each take another one-pod team (their key groups keep
    one reader); ``moving(d)``: Ingresses with a unique host take a fresh
    host and PVCs flip their class between present and dangling, half
    each; ``crowded()``: one Pod of the crowded team leaves it, so the
    crowded group's readers (past DELTA_MAX_ROWS) must re-evaluate."""

    def __init__(self, client, objs, seed: int):
        import random

        self.client = client
        self.rng = random.Random(seed)
        self.live = {o["metadata"]["name"]: o for o in objs}
        hosts = {}
        for o in objs:
            if o["kind"] == "Ingress":
                for r in o["spec"]["rules"]:
                    hosts[r["host"]] = hosts.get(r["host"], 0) + 1
        self.ingresses = [
            o["metadata"]["name"] for o in objs if o["kind"] == "Ingress"
            and all(hosts[r["host"]] == 1 for r in o["spec"]["rules"])]
        self.pvcs = [o["metadata"]["name"] for o in objs
                     if o["kind"] == "PersistentVolumeClaim"]
        teams = {}
        for o in objs:
            if o["kind"] == "Pod":
                t = o["metadata"]["labels"]["team"]
                teams[repr(t)] = teams.get(repr(t), 0) + 1
        self.solo_pods = [
            o["metadata"]["name"] for o in objs if o["kind"] == "Pod"
            and teams[repr(o["metadata"]["labels"]["team"])] == 1]
        self.crowd = [o["metadata"]["name"] for o in objs if o["kind"] == "Pod"
                      and o["metadata"]["labels"]["team"] == "crowded"]
        self.n = 0

    def _put(self, obj):
        import copy

        self.live[obj["metadata"]["name"]] = obj
        self.client.add_data(copy.deepcopy(obj))

    def neutral(self, d: int) -> dict:
        import copy

        for name in self.rng.sample(self.solo_pods, d):
            pod = copy.deepcopy(self.live[name])
            team = pod["metadata"]["labels"]["team"]
            pod["metadata"]["labels"]["team"] = (
                team[:-2] if team.endswith("-b") else team + "-b")
            self._put(pod)
        self.n += 1
        return {"kind": "neutral", "pods": d}

    def moving(self, d: int) -> dict:
        import copy

        n_ing = (d + self.n % 2) // 2
        for name in self.rng.sample(self.ingresses, n_ing):
            ing = copy.deepcopy(self.live[name])
            ing["spec"]["rules"][0]["host"] = f"fresh-{self.n}-{name}.corp.io"
            self._put(ing)
        for name in self.rng.sample(self.pvcs, d - n_ing):
            pvc = copy.deepcopy(self.live[name])
            cls = pvc["spec"]["storageClassName"]
            pvc["spec"]["storageClassName"] = (
                "standard" if cls.startswith("missing") else "missing-0")
            self._put(pvc)
        self.n += 1
        return {"kind": "moving", "ingresses": n_ing, "pvcs": d - n_ing}

    def joining(self) -> dict:
        """One Ingress of a unique host takes another's: the key group
        they now share holds a second reader, which the delta sweep must
        re-evaluate with it.  Neither is picked again by moving()."""
        import copy

        name, other = self.rng.sample(self.ingresses, 2)
        for n in (name, other):
            self.ingresses.remove(n)
        ing = copy.deepcopy(self.live[name])
        ing["spec"]["rules"][0]["host"] = \
            self.live[other]["spec"]["rules"][0]["host"]
        self._put(ing)
        self.n += 1
        return {"kind": "joining", "ingresses": 1}

    def crowded(self) -> dict:
        import copy

        name = self.crowd.pop(self.rng.randrange(len(self.crowd)))
        pod = copy.deepcopy(self.live[name])
        pod["metadata"]["labels"]["team"] = f"left-crowd-{self.n}"
        self._put(pod)
        self.n += 1
        return {"kind": "crowded", "pods": 1, "crowd_left": len(self.crowd)}


def ref_sweep(client, driver, pauses, timer, label: str, ops=None):
    """One capped sweep of the referential corpus -> (its record, results,
    totals): wall, path, stages, rendered cells, results, join-affected
    rows, the join index's host time, the collector's pauses, the
    launches of SWEEP_LAUNCHES."""
    pauses.reset()
    timer.ms = timer.tables_ms = 0.0
    before = {k: _dev().launches[k] for k in SWEEP_LAUNCHES}
    t0 = time.perf_counter()
    resp, totals = client.audit_capped(CAP)
    wall_s = time.perf_counter() - t0
    st = driver.last_sweep_stats
    rec = {
        "sweep": label, **(ops or {}), "s": wall_s,
        "path": "delta" if "delta_rows" in st else
        "cached" if st.get("cached") else "full",
        **{k: st.get(k) for k in (
            "pack_ms", "device_ms", "render_ms", "rendered_cells", "results",
            "delta_rows", "join_affected_rows", "scatter_rows", "join_plans",
        )},
        "join_index_ms": timer.ms, "join_tables_ms": timer.tables_ms,
        "gc_ms": pauses.ms, "gc_gen2": pauses.gen2,
        "launches": {k: _dev().launches[k] - before[k]
                     for k in SWEEP_LAUNCHES},
    }
    return rec, resp, totals


def force_full(driver):
    """Drop the sweep cache and the incremental state: the next capped
    sweep is a full one."""
    driver._delta_state = None
    driver._audit_cache = None


def check_ref_tables(driver, cap: Capture) -> list:
    """Each plan's device key table (K7's output in the captured sweep)
    against the host join index's delta_tables() from the same sweep,
    over the index's valid prefix; beyond it the device table must hold
    no key; K7's dense counts must be the index's table scattered."""
    import torch

    from gatekeeper_tpu_torch.ops import joinkernel

    invalid = int(joinkernel.KEY_INVALID)
    dev_tables = {}
    for a, _kw, out in cap.calls["joinkeys"]:
        key = (a[5], a[6])  # kind id, namespaced
        if key in dev_tables:
            raise AssertionError(f"two K7 calls for one plan {key}")
        dev_tables[key] = out
    js = driver._join_state
    plans = driver._active_join_plans()
    if len(dev_tables) != len(plans):
        raise AssertionError(f"{len(dev_tables)} K7 calls, {len(plans)} plans")
    rows = []
    for plan, host in zip(plans, js.delta_tables()):
        uk, uc, dense = dev_tables[(driver.interner.intern(plan.remote_kind),
                                    plan.remote_scope == "namespace")]
        n = int((host["uk"] != invalid).sum())
        want_dense = joinkernel.dense_counts(
            torch.from_numpy(host["uk"]), torch.from_numpy(host["uc"]),
            dense.numel())
        equal = (
            torch.equal(uk[:n].cpu(), torch.from_numpy(host["uk"][:n]))
            and torch.equal(uc[:n].cpu(), torch.from_numpy(host["uc"][:n]))
            and (uk.numel() == n or int(uk[n].item()) == invalid)
            and torch.equal(dense.cpu(), want_dense)
        )
        if not equal:
            raise AssertionError(f"{plan.agg} plan: device table != host index")
        rows.append({"agg": plan.agg, "kind": plan.remote_kind, "groups": n,
                     "provider_rows": int(uc[:n].sum().item()),
                     "table_entries": uk.numel()})
    return rows


def ref_plain_path(driver, cap: Capture) -> dict:
    """The captured sweep's [C, 1+K] reduction against the same resident
    state evaluated in join mode and reduced through the plain versions on
    the card (PlainVersions: no kernel launches)."""
    import torch

    from gatekeeper_tpu_torch.ops import driver as driver_mod

    (mask, K), _kw, packed = cap.calls["reduction"][0]
    with PlainVersions():
        side = driver._constraint_side()
        rv_d, cols_d = driver._audit_dev[1]
        plain_mask, _rej = driver._eval(
            side, rv_d, cols_d, driver._constraint_device(side),
            join_mode="trace", joins=driver._join_trace_args())
        plain_packed = driver_mod.packed_reduction(plain_mask, K)
    torch.cuda.synchronize()
    if not torch.equal(plain_packed, packed):
        raise AssertionError("referential sweep differs from the plain path")
    return {"equal": True, "shape": list(packed.shape),
            "candidates": int(packed[:, 0].sum().item())}


def referential_path(client, driver, churn: RefChurn, pauses, timer):
    """Phase 8's counted run: a cold sweep (K7, K8 and K4 recorded), WARM
    forced full sweeps before and after gc.freeze(), REF_CHURN_SWEEPS
    neutral and as many key-moving churn sweeps for each d in REF_CHURN_D
    (each launching K8's table mode once and K9's delta mode; the first
    key-moving one's K8 and K9 calls recorded), each d closed by a
    forced full sweep that must equal it, and one crowded churn, which
    must take the full path where the crowd's readers exceed
    DELTA_MAX_ROWS (at full size).  -> (the two captures, the records)."""
    import numpy as np

    from gatekeeper_tpu_torch.util import synthetic as syn

    records = []
    with Capture(names=("joinkeys", "joinlookup", "reduction",
                        "program")) as cold_cap:
        rec, resp, totals = ref_sweep(client, driver, pauses, timer, "cold")
    records.append(rec)
    results = resp.results()
    if rec["path"] != "full" or not results or rec["join_plans"] != 3 or \
            view("join_plans").get(()) != 3:
        raise AssertionError(f"cold referential sweep: {rec}, join_plans "
                             f"gauge {view('join_plans')}")
    log("ref_cold_sweep", **rec,
        flagged_constraints=sum(1 for n, _h in totals.values() if n))
    # while the join index is the cold sweep's: the device tables against
    # it, and the sweep against the all-plain path (no kernel launches)
    log("ref_tables", equal=True, plans=check_ref_tables(driver, cold_cap))
    log("ref_plain_path", **ref_plain_path(driver, cold_cap))
    for phase in ("ref_warm_sweeps", "ref_warm_sweeps_gc_frozen"):
        if phase.endswith("frozen"):
            gc.collect()
            gc.freeze()
        sweeps = []
        for i in range(WARM):
            force_full(driver)
            rec, resp2, totals2 = ref_sweep(client, driver, pauses, timer,
                                            f"warm{i}")
            if totals2 != totals or len(resp2.results()) != len(results):
                raise AssertionError(f"{phase}: a warm sweep differs")
            sweeps.append(rec)
        gc.unfreeze()
        records.extend(sweeps)
        log(phase, n=WARM,
            median_s=statistics.median(r["s"] for r in sweeps),
            worst_s=max(r["s"] for r in sweeps),
            median_join_index_ms=statistics.median(
                r["join_index_ms"] for r in sweeps),
            sweeps=sweeps)
    delta_cap = Capture(names=("joinlookup_table", "program"))
    affected_total = 0
    for d in REF_CHURN_D:
        sweeps = []
        for kind in ("neutral", "moving"):
            for i in range(REF_CHURN_SWEEPS):
                ops = getattr(churn, kind)(d)
                affected0 = view("join_delta_affected_rows_total").get(
                    (), 0)
                if kind == "moving" and i == 0:
                    with delta_cap:
                        rec, resp, totals = ref_sweep(
                            client, driver, pauses, timer, f"{kind}{i}", ops)
                else:
                    rec, resp, totals = ref_sweep(client, driver, pauses,
                                                  timer, f"{kind}{i}", ops)
                # one launch for the sweep's table-mode lookups, and K9
                # writing the columns (K5 past the fold's row limit)
                want = dict(delta_launches(padded(rec["delta_rows"] or 0)),
                            joinlookup_table=1)
                # the counter moves by the readers each sweep re-evaluated
                moved = view("join_delta_affected_rows_total").get(
                    (), 0) - affected0
                if rec["path"] != "delta" or rec["delta_rows"] < d or \
                        rec["launches"] != want or \
                        moved != (rec["join_affected_rows"] or 0):
                    raise AssertionError(f"ref churn d={d}: {rec}, "
                                         f"want {want}, the affected-rows "
                                         f"counter moved {moved}")
                affected_total += moved
                sweeps.append(rec)
        counts = driver._delta_state.counts.copy()
        sig = syn.audit_result_sig(resp.results())
        force_full(driver)
        full, f_resp, f_totals = ref_sweep(client, driver, pauses, timer,
                                           "forced_full")
        equal = {
            "totals": f_totals == totals,
            "results": syn.audit_result_sig(f_resp.results()) == sig,
            "counts": bool(np.array_equal(driver._delta_state.counts, counts)),
        }
        if full["path"] != "full" or not all(equal.values()):
            raise AssertionError(f"ref churn d={d}: delta != full {equal}")
        records.extend(sweeps + [full])
        log("ref_churn_sweeps", d=d, n=len(sweeps),
            median_s=statistics.median(r["s"] for r in sweeps),
            worst_s=max(r["s"] for r in sweeps),
            median_stage_ms={k: statistics.median(r[k] for r in sweeps)
                             for k in ("pack_ms", "device_ms", "render_ms",
                                       "join_index_ms", "join_tables_ms")},
            equal_to_full=equal, results=len(sig), sweeps=sweeps,
            full_sweep=full)
    # a key-moving churn into a shared key group: the counter moves by
    # the other reader the sweep re-evaluated
    affected0 = view("join_delta_affected_rows_total").get((), 0)
    rec, _resp, _totals = ref_sweep(client, driver, pauses, timer,
                                    "joining", churn.joining())
    moved = view("join_delta_affected_rows_total").get((), 0) - affected0
    if rec["path"] != "delta" or not rec["join_affected_rows"] or \
            moved != rec["join_affected_rows"]:
        raise AssertionError(f"the joining churn: {rec}, the "
                             f"affected-rows counter moved {moved}")
    affected_total += moved
    records.append(rec)
    log("ref_joining_churn", counter_moved=moved, **rec)
    # the churned row plus the rest of its group's readers: past the
    # budget at full size (about 500 crowded Pods in 100,000 objects)
    group = len(churn.crowd)
    want = "full" if group > driver.DELTA_MAX_ROWS else "delta"
    rec, _resp, _totals = ref_sweep(client, driver, pauses, timer, "crowded",
                                    churn.crowded())
    if rec["path"] != want:
        raise AssertionError(f"the crowded churn ({group} readers) took the "
                             f"{rec['path']} path: {rec}")
    records.append(rec)
    log("ref_crowded_churn", readers=group,
        delta_max_rows=driver.DELTA_MAX_ROWS, **rec)
    if not affected_total:
        raise AssertionError("no key-moving churn moved "
                             "join_delta_affected_rows_total")
    log("ref_join_metrics", join_plans=view("join_plans").get(()),
        join_delta_affected_rows_total=affected_total)
    return cold_cap, delta_cap, records


def ref_parity(n_templates: int, n_objects: int):
    """The referential audit on the card against the interpreter oracle at
    a small size, with GK_JOIN_ASSERT=1 (a flagged cell the oracle renders
    empty raises): audit_capped, the uncapped audit, and the uncapped
    audit after churn through the delta path (an Ingress joins another's
    host, a PVC's class dangles, a Pod changes team)."""
    import copy

    from gatekeeper_tpu_torch.util import synthetic as syn

    os.environ["GK_JOIN_ASSERT"] = "1"
    try:
        small = syn.build_referential_driver(n_templates, n_objects, SEED)
        oracle = syn.build_referential_oracle(n_templates, n_objects, SEED)
        s_resp, s_tot = small.audit_capped(CAP)
        o_resp, o_tot = oracle.audit_capped(CAP)
        s_sig = syn.audit_result_sig(s_resp.results())
        o_all = syn.audit_result_sig(oracle.audit().results())
        assert s_sig and set(s_sig) <= set(o_all), "capped results not exact"
        exact = [k for k, (_n, how) in s_tot.items() if how == "exact"]
        assert exact and all(s_tot[k][0] == o_tot[k][0] for k in exact)
        assert syn.audit_result_sig(small.audit().results()) == o_all
        objs = syn.make_referential_objects(n_objects, SEED + 1)
        ings = [o for o in objs if o["kind"] == "Ingress"
                and o["spec"]["rules"][0]["host"].startswith("svc-")]
        a = copy.deepcopy(ings[0])
        a["spec"]["rules"] = [dict(ings[1]["spec"]["rules"][0])]
        pvc = copy.deepcopy(
            [o for o in objs if o["kind"] == "PersistentVolumeClaim"][0])
        pvc["spec"]["storageClassName"] = "missing-0"
        pod = copy.deepcopy([o for o in objs if o["kind"] == "Pod"][0])
        pod["metadata"]["labels"]["team"] = "crowded"
        for c in (small, oracle):
            for o in (a, pvc, pod):
                c.add_data(copy.deepcopy(o))
        u_sig = syn.audit_result_sig(small.audit().results())
        u_stats = dict(small.driver.last_sweep_stats)
        assert u_stats.get("delta_rows", 0) >= 3, u_stats
        assert u_stats.get("join_affected_rows", 0) >= 1, u_stats
        assert u_sig == syn.audit_result_sig(oracle.audit().results())
    finally:
        del os.environ["GK_JOIN_ASSERT"]
    return {"templates": n_templates, "objects": n_objects,
            "results": len(s_sig), "oracle_results": len(o_all),
            "exact_totals": len(exact), "uncapped_after_churn": len(u_sig),
            "uncapped_stats": u_stats}


def mesh_reference(client, driver, label: str) -> tuple:
    """A full capped sweep at width 1, then WARM forced full ones whose
    device stage is logged -> (results signature, totals, counts [C],
    first candidates [C, K])."""
    from gatekeeper_tpu_torch.util import synthetic as syn

    driver.set_mesh(True, width=1)
    resp, totals = client.audit_capped(CAP)
    _r, _o, _m, counts, topk = driver._audit_cache[1]
    ref = (syn.audit_result_sig(resp.results()), totals, counts.copy(),
           topk.copy())
    stages = []
    for _ in range(WARM):
        force_full(driver)
        resp, totals = client.audit_capped(CAP)
        if not all(_equal_to(ref, resp, totals, driver).values()):
            raise AssertionError(f"{label}: width 1 sweeps differ")
        stages.append(driver.last_sweep_stats["device_ms"])
    log("mesh_width_1", config=label, n=WARM,
        median_device_ms=statistics.median(stages), device_ms=stages)
    return ref


def _equal_to(ref, resp, totals, driver) -> dict:
    import numpy as np

    from gatekeeper_tpu_torch.util import synthetic as syn

    _r, _o, _m, counts, topk = driver._audit_cache[1]
    return {
        "results": syn.audit_result_sig(resp.results()) == ref[0],
        "totals": totals == ref[1],
        "counts": bool(np.array_equal(counts, ref[2])),
        "first_k": topk.shape == ref[3].shape
        and bool(np.array_equal(topk, ref[3])),
    }


def mesh_sweeps(client, driver, ref, width: int, label: str,
                plans: int = 0) -> list:
    """A cold capped sweep at ``width`` (the slabs committed) and WARM
    warm forced full ones (on the resident slabs), each equal to width 1
    bit for bit: results, totals, counts and first candidates.  K1, K9
    and K4 launch ``width`` times a sweep; with join plans K7 ``width``
    times a plan and its merge once a plan."""
    driver.set_mesh(True, width=width)
    if view("mesh_sweep_width").get(()) != width:
        raise AssertionError(f"mesh_sweep_width reads "
                             f"{view('mesh_sweep_width')} at width {width}")
    want = {"match": width, "program": width, "reduction": width}
    if plans:
        want.update(joinkeys=width * plans, joinkeys_merge=plans)
    recs = []
    for which in ("cold",) + ("warm",) * WARM:
        if which == "warm":
            force_full(driver)
        before = dict(_dev().launches)
        shards0 = shard_observations("audit")
        t0 = time.perf_counter()
        resp, totals = client.audit_capped(CAP)
        wall = time.perf_counter() - t0
        st = dict(driver.last_sweep_stats)
        got = {k: _dev().launches[k] - before[k] for k in want}
        equal = _equal_to(ref, resp, totals, driver)
        # the cold sweep commits the slabs (one observation a shard); the
        # warm ones patch the resident slabs and commit none
        committed = shard_observations("audit") - shards0
        rec = {"config": label, "width": width, "sweep": which, "s": wall,
               "launches": got, "equal_to_width_1": equal,
               "shards_committed": committed,
               **{k: st.get(k) for k in (
                   "pack_ms", "device_ms", "render_ms", "shards",
                   "rows_per_shard", "padded_rows", "upload_bytes",
                   "join_plans")}}
        if not all(equal.values()) or got != want \
                or st.get("shards") != width or "delta_rows" in st or \
                committed != (width if which == "cold" else 0):
            raise AssertionError(f"mesh sweep: {rec}, want {want}")
        recs.append(rec)
        log("mesh_sweep", **rec)
    warm = [r for r in recs if r["sweep"] == "warm"]
    log("mesh_warm_sweeps", config=label, width=width, n=len(warm),
        median_s=statistics.median(r["s"] for r in warm),
        median_stage_ms={k: statistics.median(r[k] for r in warm)
                         for k in ("pack_ms", "device_ms", "render_ms")})
    return recs


def mesh_churn(client, driver, width: int, label: str, step,
               tail: bool = False) -> list:
    """For each d in MESH_CHURN_D, ``step(d)`` changes the store; the
    sweep after it must take the delta path with delta_rows the dirty rows
    (and, for join plans, the readers of the key groups they touch),
    delta_shards their owning shards, K5 launched once on each.  With
    ``tail`` the added objects must take rows in the padded tail of the
    last slab (no free row: Churn.grow after fill_free).  Each d is closed
    by a forced full sweep (K6 on the owning shards) that must equal
    it."""
    from gatekeeper_tpu_torch.parallel.mesh import owning_shards
    from gatekeeper_tpu_torch.util import synthetic as syn

    recs = []
    ap = driver._audit_pack
    for d in MESH_CHURN_D:
        n_before = ap.n_rows
        ops = step(d)
        # the pack synced ahead of the sweep: its dirty rows are the
        # dispatch's, with the readers a join plan adds to them
        driver._synced_side()
        rows = set(ap.delta_dirty)
        js = driver._join_state
        if js is not None:
            rows |= js.affected(ap, driver.interner, ap.delta_dirty)
        shards = owning_shards(rows, ap.capacity, width)
        new_rows = sorted(r for r in rows if r >= n_before)
        # where the rows held before lie past the last slab's start (at
        # full size), the new ones are in its padded tail
        slab = -(-ap.capacity // width)
        in_last_slab = n_before < slab * (width - 1) or \
            owning_shards(new_rows, ap.capacity, width) == {width - 1}
        before = dict(_dev().launches)
        t0 = time.perf_counter()
        resp, totals = client.audit_capped(CAP)
        wall = time.perf_counter() - t0
        st = dict(driver.last_sweep_stats)
        k5 = _dev().launches["delta"] - before["delta"]
        k9_delta = _dev().launches["program_delta"] - before["program_delta"]
        counts = driver._delta_state.counts.copy()
        sig = syn.audit_result_sig(resp.results())
        force_full(driver)
        f_resp, f_totals = client.audit_capped(CAP)
        f_st = dict(driver.last_sweep_stats)
        equal = {
            "totals": f_totals == totals,
            "results": syn.audit_result_sig(f_resp.results()) == sig,
            "counts": bool((driver._delta_state.counts == counts).all()),
        }
        rec = {"config": label, "width": width, "d": d, **ops, "s": wall,
               "delta_rows": st.get("delta_rows"),
               "delta_shards": st.get("delta_shards"),
               "owning_shards": sorted(shards), "tail_rows": new_rows,
               "delta_launches": k5, "k9_delta_launches": k9_delta,
               "device_ms": st.get("device_ms"),
               "full_scatter_rows": f_st.get("scatter_rows"),
               "full_scatter_shards": f_st.get("scatter_shards"),
               "equal_to_full": equal}
        if (st.get("delta_rows") != len(rows) or k5 != len(shards)
                or k9_delta != 0
                or st.get("delta_shards") != len(shards)
                or not all(equal.values()) or "delta_rows" in f_st
                or not f_st.get("scatter_rows")
                or (tail and (len(new_rows) != ops["add"]
                              or not in_last_slab))):
            raise AssertionError(f"mesh churn: {rec}")
        recs.append(rec)
        log("mesh_churn", **rec)
    return recs


def fill_free(driver, churn) -> int:
    """Add as many pods as the pack has free rows (rows of deleted
    objects, which the next added objects take first) -> that count."""
    driver._synced_side()
    n = len(driver._audit_pack.free)
    if n:
        churn.add(n)
        driver._synced_side()
    if driver._audit_pack.free:
        raise AssertionError("free rows left after filling them")
    return n


def _dev():
    from gatekeeper_tpu_torch import device

    return device


def _review_bytes(responses) -> list:
    """Every result of every review, in order, as bytes: constraint,
    message, enforcement action and metadata."""
    return [[json.dumps([r.constraint["kind"],
                         r.constraint["metadata"]["name"], r.msg,
                         r.enforcement_action, r.metadata],
                        sort_keys=True, default=str)
             for r in resp.results()]
            for resp in responses]


def mesh_stall(client, driver, ref) -> dict:
    """One mesh dispatch written off by the watchdog: at width
    max(MESH_WIDTHS), with mesh_watchdog_s set to MESH_WATCHDOG_S, the
    fault plane hangs one review batch's guarded dispatch.  The batch must
    be answered by the numpy host tier as width 1 answers it, the mesh narrow
    to half its width, mesh_dispatch_stalls_total move by one and the
    flight recorder hold one mesh_degrade event; once the probe closes
    the breaker, a forced full sweep at the new width must equal width 1
    bit for bit.  The batch's divert goes to INJECTED_DIVERTS."""
    import copy

    from gatekeeper_tpu_torch import faults
    from gatekeeper_tpu_torch.faults import FaultRule
    from gatekeeper_tpu_torch.obs import flightrec

    width = max(MESH_WIDTHS)
    driver.set_mesh(True, width=width)
    pods = fresh_pods(4, SEED + 89, "mesh-stall")
    want = results_of(client, pods)  # on the mesh, unstalled
    forget_reviews(driver)
    stalls0 = view("mesh_dispatch_stalls_total").get((), 0)
    degrades0 = sum(1 for e in flightrec.get_recorder().events()
                    if e["type"] == flightrec.MESH_DEGRADE)
    diverts0 = diverts()
    driver.mesh_watchdog_s = MESH_WATCHDOG_S
    plane = faults.install(seed=SEED)
    try:
        plane.add(faults.MESH_DISPATCH_STALL,
                  FaultRule(mode="hang", hang_s=10.0, count=1))
        t0 = time.perf_counter()
        got = [results_sig(r.results())
               for r in client.review_batch(copy.deepcopy(pods))]
        stall_s = time.perf_counter() - t0
        narrowed, state = driver.mesh_layout(), driver.breaker.state
        plane.release_hangs()
        # the abandoned dispatch finishes alone before new device work
        time.sleep(1.0)
        plane.clear(faults.MESH_DISPATCH_STALL)
    finally:
        faults.uninstall()
        driver.mesh_watchdog_s = None
    moved = diverts()
    for k, n in moved.items():
        INJECTED_DIVERTS[k] = INJECTED_DIVERTS.get(k, 0) + n - \
            diverts0.get(k, 0)
    events = [e for e in flightrec.get_recorder().events()
              if e["type"] == flightrec.MESH_DEGRADE]
    stalls = view("mesh_dispatch_stalls_total").get((), 0) - stalls0
    probed = driver.breaker.probe_now()
    force_full(driver)
    resp, totals = client.audit_capped(CAP)
    equal = _equal_to(ref, resp, totals, driver)
    st = dict(driver.last_sweep_stats)
    rec = {"width": width, "narrowed_to": narrowed, "breaker": state,
           "stalled_review_s": stall_s, "answers_equal": got == want,
           "mesh_dispatch_stalls": stalls,
           "mesh_degrade_events": len(events) - degrades0,
           "last_degrade": events[-1] if events else None,
           "mesh_sweep_width": view("mesh_sweep_width").get(()),
           "diverts": {k: n - diverts0.get(k, 0) for k, n in moved.items()},
           "probe_closed": probed, "sweep_shards": st.get("shards"),
           "sweep_equal_to_width_1": equal}
    if got != want or narrowed != width // 2 or state != "open" or \
            stalls != 1 or rec["mesh_degrade_events"] != 1 or \
            events[-1].get("from_width") != width or \
            events[-1].get("to_width") != width // 2 or \
            rec["mesh_sweep_width"] != width // 2 or not probed or \
            st.get("shards") != width // 2 or not all(equal.values()) or \
            rec["diverts"] != {"np|device_failed": 1}:
        raise AssertionError(f"the mesh stall: {rec}")
    check_no_divert("after the mesh stall", driver)
    return rec


def mesh_masks(client, driver, width: int) -> dict:
    """Reviews under the mesh (compute_masks' mesh branch: K1 and K9 on
    each shard's row slab, K9 packing the slab's masks in its launch,
    each shard's packed download unpacked to its own slab):
    compute_masks of MESH_REVIEWS stored objects bit-equal to width 1's,
    review_batch of MESH_ADMISSIONS unique pods byte-equal to width 1's,
    K9 packing once a shard for each (K9 and K10 once a shard where the
    slab is past PACK_IN_K9_MAX_ROWS); then sharded_violation_counts
    against the width-1 mask sums."""
    import copy
    import itertools

    import numpy as np

    from gatekeeper_tpu_torch.engine.value import thaw
    from gatekeeper_tpu_torch.ops import program
    from gatekeeper_tpu_torch.parallel import mesh as pm
    from gatekeeper_tpu_torch.util import synthetic as syn

    reviews = [
        driver.target.make_audit_review(thaw(o), api, k, n, ns)
        for o, api, k, n, ns in itertools.islice(
            driver.store.iter_objects(), MESH_REVIEWS)
    ]
    pods = syn.make_pods(MESH_ADMISSIONS, seed=SEED + 95,
                         violation_rate=0.5)
    for i, p in enumerate(pods):
        p["metadata"]["name"] = f"mesh-admission-{i}"
    driver.set_mesh(True, width=1)
    _o, mask, rej = driver.compute_masks(reviews)
    # the memos emptied before each review_batch: both evaluate
    forget_reviews(driver)
    want = _review_bytes(client.review_batch(copy.deepcopy(pods)))
    forget_reviews(driver)
    driver.set_mesh(True, width=width)
    names = ("program", "program_pack", "packbits")

    def counted(fn):
        before = {k: _dev().launches[k] for k in names}
        out = fn()
        return out, {k: _dev().launches[k] - before[k] for k in names}

    (_o2, smask, srej), masks_ran = counted(
        lambda: driver.compute_masks(reviews))
    t0 = time.perf_counter()
    got, batch_ran = counted(
        lambda: _review_bytes(client.review_batch(copy.deepcopy(pods))))
    batch_ms = (time.perf_counter() - t0) * 1e3
    _o3, counts, rejects = pm.sharded_violation_counts(
        driver, reviews, pm.audit_mesh(width, driver.device))
    driver.set_mesh(True, width=1)
    equal = {
        "mask": bool(np.array_equal(mask, smask)),
        "autoreject": bool(np.array_equal(rej, srej)),
        "reviews": got == want,
        "counts": bool(np.array_equal(counts, mask.sum(axis=1))),
        "autoreject_counts": bool(np.array_equal(rejects, rej.sum(axis=1))),
    }

    def expected(rows):
        fold = -(-rows // width) <= program.PACK_IN_K9_MAX_ROWS
        return {"program": 0 if fold else width,
                "program_pack": width if fold else 0,
                "packbits": 0 if fold else width}

    rec = {"width": width, "reviews": len(reviews),
           "admissions": len(pods), "equal_to_width_1": equal,
           "candidates": int(mask.sum()),
           "denied": sum(1 for r in got if r),
           "launches": {"compute_masks": masks_ran,
                        "review_batch": batch_ran},
           "review_batch_ms": batch_ms}
    if not all(equal.values()) or not mask.any() or not any(want) \
            or masks_ran != expected(mask.shape[1]) \
            or batch_ran != expected(MESH_ADMISSIONS):
        raise AssertionError(f"reviews under the mesh: {rec}")
    return rec


def multihost_worker(args) -> int:
    """One process of the multi-process sweep (--multihost-worker RANK):
    the synthetic store of the main path, built from its seed, swept by
    parallel/multihost.py over gloo (this process's shards on the virtual
    mesh of GK_VIRTUAL_DEVICES slots), then on one device; prints one
    JSON line."""
    import numpy as np
    import torch.distributed as dist

    sys.path.insert(0, ROOT)
    from gatekeeper_tpu_torch import device as gdev
    from gatekeeper_tpu_torch.parallel import multihost
    from gatekeeper_tpu_torch.util import synthetic as syn

    rank = args.multihost_worker
    multihost.init_distributed(args.coordinator, 2, rank)
    try:
        client = syn.build_driver(args.templates, args.pods, SEED)
        driver = client.driver
        K = driver._audit_topk(CAP)
        gdev.reset_launches()
        t0 = time.perf_counter()
        _ordered, counts, topk = multihost.multihost_capped_sweep(driver, K)
        sweep_s = time.perf_counter() - t0
        launches = dict(gdev.launches)
        _mesh, first, width = multihost.multihost_layout(driver.device)
        driver.set_mesh(False)
        _r, _o, _m, ref_counts, ref_topk = driver._audit_sweep(K)
        equal = {
            "counts": bool(np.array_equal(counts, ref_counts)),
            "first_k": topk.shape == ref_topk.shape
            and bool(np.array_equal(topk, ref_topk)),
        }
        print(json.dumps({
            "rank": rank, "first_shard": first, "width": width,
            "equal_to_one_process": equal, "sweep_s": sweep_s,
            "candidates": int(counts.sum()), "launches": launches,
            "digest": int(np.asarray(topk, np.int64).sum()),
        }), flush=True)
    finally:
        dist.destroy_process_group()
    return 0 if all(equal.values()) else 1


def multihost_phase(args) -> dict:
    """Two processes on gloo over loopback, each with a 2-slot virtual mesh
    of the card: each one's sweep must equal its one-process sweep bit for
    bit, and the two must agree.  Both are stopped, whatever happens."""
    import socket

    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    coord = f"127.0.0.1:{sock.getsockname()[1]}"
    sock.close()
    procs = []
    t0 = time.perf_counter()
    try:
        for rank in range(2):
            env = dict(os.environ, GK_VIRTUAL_DEVICES="2")
            env.pop("GK_MESH", None)
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__),
                 "--multihost-worker", str(rank), "--coordinator", coord,
                 "--templates", str(args.templates),
                 "--pods", str(args.pods)],
                env=env, cwd=ROOT, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True,
            ))
        outs = [p.communicate(timeout=MULTIHOST_TIMEOUT_S)[0]
                for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    lines = []
    for rank, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise AssertionError(f"multi-process rank {rank} exited "
                                 f"{p.returncode}:\n{out[-3000:]}")
        lines.append(json.loads(out.strip().splitlines()[-1]))
    if lines[0]["digest"] != lines[1]["digest"] or \
            lines[0]["candidates"] != lines[1]["candidates"]:
        raise AssertionError(f"the two processes disagree: {lines}")
    return {"seconds": time.perf_counter() - t0, "processes": lines}


def mesh_phase(args, client, driver, churn, rclient, rdriver, ref_churn):
    """Phase 9's counted run: the synthetic and the referential corpus at
    each width of MESH_WIDTHS on the virtual mesh of the one card (and at
    up to 4 real cards where more are visible): sweep parity and delta
    locality, every K4 (row_offset), K7 merge and K5 call recorded.  Then
    the sharded masks and counts and the multi-process sweep.  -> (the
    kernel rows, the counted run's launches)."""
    import torch

    from gatekeeper_tpu_torch.parallel import mesh as pm

    gdev = _dev()
    os.environ[pm.VIRTUAL_DEVICES_ENV] = str(max(MESH_WIDTHS))
    log("mesh_setup", filled_free_rows=fill_free(driver, churn))
    synth_ref = mesh_reference(client, driver, "synthetic")
    ref_ref = mesh_reference(rclient, rdriver, "referential")
    plans = len(rdriver._active_join_plans())
    layouts = [("virtual", w) for w in MESH_WIDTHS]
    if torch.cuda.device_count() > 1:
        layouts.append(("cards", min(torch.cuda.device_count(), 4)))
    # every mesh sweep's K4, K7 merge and K5 calls are recorded; the width
    # 1 references between them are not
    cap = Capture(names=("reduction", "joinkeys_merge", "delta"))
    gdev.reset_launches()
    with NoIR():
        for devices, width in layouts:
            if devices == "cards":
                del os.environ[pm.VIRTUAL_DEVICES_ENV]
            with cap:
                mesh_sweeps(client, driver, synth_ref, width,
                            f"synthetic/{devices}")
                mesh_churn(client, driver, width, f"synthetic/{devices}",
                           churn.grow, tail=True)
            synth_ref = mesh_reference(client, driver, "synthetic")
            with cap:
                mesh_sweeps(rclient, rdriver, ref_ref, width,
                            f"referential/{devices}", plans)
                mesh_churn(rclient, rdriver, width,
                           f"referential/{devices}", ref_churn.moving)
            ref_ref = mesh_reference(rclient, rdriver, "referential")
    launches = dict(gdev.launches)
    os.environ[pm.VIRTUAL_DEVICES_ENV] = str(max(MESH_WIDTHS))
    offsets = sorted({c[0][2] for c in cap.calls["reduction"]
                      if len(c[0]) > 2})
    # every recorded K4 is a shard's, with its row offset
    if len(offsets) < 2 or offsets[0] != 0 or \
            any(len(c[0]) < 3 for c in cap.calls["reduction"]):
        raise AssertionError(f"K4 row offsets on the mesh: {offsets}")
    log("mesh_launches", main_path=launches, row_offsets=offsets,
        merge_calls=len(cap.calls["joinkeys_merge"]))
    # K5 runs only here on the counted paths: a delta sweep's columns on
    # each owning shard
    rows = check_kernels(cap, REPS,
                         timed=("reduction", "joinkeys_merge", "delta"),
                         phase="kernel_mesh")
    del cap
    log("mesh_stall", **mesh_stall(client, driver, synth_ref))
    for width in MESH_WIDTHS:
        log("mesh_masks", **mesh_masks(client, driver, width))
    log("multihost", **multihost_phase(args))
    del os.environ[pm.VIRTUAL_DEVICES_ENV]
    driver.set_mesh(False)
    rdriver.set_mesh(False)
    return rows, launches


# ---- phase 10: the process (gatekeeper_tpu_torch.main.App) -----------------

# the process's traffic: phase 3's REVIEWS pods one at a time, then its
# batch pods from (client threads, requests each), then requests sent while
# an audit cycle holds the driver; its audit: warm cycles after the cold
# one, and cycles after each churn of d pods written through the store
PROCESS_BURST = (8, 32)
PROCESS_DURING_AUDIT = 64
PROCESS_WARM = 1
PROCESS_CHURN_D = (1, 16)
PROCESS_CHURN_CYCLES = 1
# the longest the App may take from construction to /readyz
PROCESS_READY_S = 600
# the kernels phase 10's run must launch: reviews (K1, K9 packing), full
# sweeps (K9, K4), delta sweeps (K9's delta mode) and the full sweep after
# churn (K6)
PROCESS_KERNELS = ("match", "program", "program_pack", "reduction",
                   "program_delta", "scatter")
POD_GVK = ("", "v1", "Pod")
# the background calibration every App runs at start
# (TorchDriver.calibrate_routing's default runs): one warm-up call of all
# its objects (K1, K9, K10), then CAL_RUNS timed calls of compute_masks
# and the render at one review and at CAL_LARGE, each K1 and K9 (K9 packs
# at one review, 8 rows, and past PACK_IN_K9_MAX_ROWS K10 packs after
# it); the numpy tier's and the interpreter's runs launch nothing
CAL_RUNS = 3
CAL_LARGE = 128
# the longest an App's background calibration may take to set its model
CAL_WAIT_S = 300
# the route ledger's reasons for a batch the breaker or an unavailable
# device diverted to a host tier: any the run did not inject (phases 9,
# 13 and 15) fails it
DIVERT_REASONS = ("device_failed", "breaker_open")


def calibration_launches() -> dict:
    """The launches of one calibrate_routing at the default runs."""
    n = CAL_RUNS
    return {"match": 2 * n + 1, "program_pack": n, "program": n + 1,
            "packbits": n + 1}


def check_calibration(evals: list) -> None:
    """``evals``, the launches of each compute_masks of one calibration,
    are the warm-up of them all and CAL_RUNS calls at one review, then
    at CAL_LARGE."""
    n = CAL_RUNS
    large = {"match": 1, "program": 1, "packbits": 1}
    want = [large] + [{"match": 1, "program_pack": 1}] * n + [large] * n
    if evals != want:
        raise AssertionError(f"the calibration's evaluations launched "
                             f"{evals}, not {want}")


def await_calibration(driver) -> float:
    """Wait until an App's background calibration has set ``driver``'s
    service model -> the seconds waited."""
    t0 = time.perf_counter()
    while driver._route_cal is None:
        if time.perf_counter() - t0 > CAL_WAIT_S:
            raise AssertionError(f"no calibration after {CAL_WAIT_S} s")
        time.sleep(0.05)
    return time.perf_counter() - t0


def forget_reviews(driver) -> None:
    """Empty ``driver``'s request and review memos, as its reset does: the
    next review of a pod it has answered evaluates on the card again."""
    with driver._lock:
        driver._request_memo.clear()
        driver._review_memo.clear()


# 'tier|reason' -> diverts a phase made on purpose (phase 9's injected
# mesh stall, phase 13's injected dispatch errors), which diverts()
# leaves out where a later phase checks it made none
INJECTED_DIVERTS: dict = {}


def diverts() -> dict:
    """'tier|reason' -> this process's route decisions of a divert
    reason (route_decisions_total), less INJECTED_DIVERTS."""
    from gatekeeper_tpu_torch.metrics.views import global_registry

    rows = global_registry().view_rows("route_decisions_total")
    got = {f"{t}|{r}": n for (t, r), n in rows.items()
           if r in DIVERT_REASONS}
    return {k: n - INJECTED_DIVERTS.get(k, 0) for k, n in got.items()
            if n - INJECTED_DIVERTS.get(k, 0)}


def view(name: str) -> dict:
    """This process's rows of the metric view ``name``."""
    from gatekeeper_tpu_torch.metrics.views import global_registry

    return global_registry().view_rows(name)


def shard_observations(path: str) -> int:
    """audit_shard_rows observations of ``path`` ("audit" or "review")
    so far: one a shard committed."""
    got = view("audit_shard_rows").get((path,))
    return got.count if got is not None else 0


def check_no_divert(where: str, *drivers) -> None:
    """No batch or sweep of this process was diverted, and each driver's
    breaker is closed."""
    got = diverts()
    states = [d.breaker.state for d in drivers]
    if got or any(s != "closed" for s in states):
        raise AssertionError(f"{where}: diverts {got}, breakers {states}")


def replica_diverts(port: int) -> dict:
    """A replica's route decisions of a divert reason, from its
    /metrics."""
    import re

    out = {}
    for ln in metrics_text(port).splitlines():
        m = re.match(r"\w*route_decisions_total\{([^}]*)\}\s+(\S+)", ln)
        if not m:
            continue
        labels = dict(re.findall(r'(\w+)="([^"]*)"', m.group(1)))
        if labels.get("reason") in DIVERT_REASONS and float(m.group(2)):
            out[f"{labels.get('tier')}|{labels['reason']}"] = float(
                m.group(2))
    return out


def fresh_pods(n: int, seed: int, tag: str, rate: float = 0.5) -> list:
    """``n`` synthetic pods named ``tag``-i, about ``rate`` of them
    flagged: content no App, replica or memo has seen."""
    from gatekeeper_tpu_torch.util import synthetic as syn

    pods = syn.make_pods(n, seed=seed, violation_rate=rate)
    for i, p in enumerate(pods):
        p["metadata"]["name"] = f"{tag}-{i}"
    return pods


def results_of(client, pods) -> list:
    """Phase 3's client's results for ``pods`` (the answers an App must
    give), in batches of at most the request memo's bound."""
    import copy

    out = []
    for i in range(0, len(pods), 64):
        out += [results_sig(r.results()) for r in
                client.review_batch(copy.deepcopy(pods[i:i + 64]))]
    return out


def results_sig(results) -> list:
    """A review's results as (constraint kind, name, message, action)."""
    return [(r.constraint["kind"], r.constraint["metadata"]["name"], r.msg,
             r.enforcement_action) for r in results]


def expected_response(sig) -> tuple:
    """(allowed, status message) of the webhook's answer to results
    ``sig``: the deny results' messages deny, nothing else does
    (webhook/policy.py _get_deny_messages)."""
    msgs = [f"[denied by {name}] {msg}" for _k, name, msg, action in sig
            if action == "deny"]
    return (not msgs, "\n".join(msgs) if msgs else None)


class KubeWriter:
    """A Churn target that writes through the App's API store; the App's
    sync controller delivers each change to its client."""

    def __init__(self, kube):
        self.kube = kube

    def add_data(self, obj):
        self.kube.apply(obj)

    def remove_data(self, obj):
        md = obj["metadata"]
        self.kube.delete(POD_GVK, md["name"], md.get("namespace", ""))


class ProcessSpy:
    """Wraps the App driver's review_batch, _review_batch_eval (the
    evaluation of a batch's memo misses) and compute_masks: each review
    batch's results by request uid and its size, the batches that
    evaluated misses, and the launches each evaluation made (the
    background calibration's too).  compute_masks runs under the driver's
    lock, so no sweep's launches fall inside it."""

    def __init__(self, driver):
        self.driver = driver
        self.sizes, self.results, self.per_eval = [], {}, []
        self.missed = []  # the review count of each batch's misses
        self._batch = driver.review_batch
        self._eval = driver._review_batch_eval
        self._masks = driver.compute_masks
        driver.review_batch = self.review_batch
        driver._review_batch_eval = self.review_batch_eval
        driver.compute_masks = self.compute_masks

    def review_batch(self, reviews, tracing=False):
        if tracing:
            raise AssertionError("a traced review: the interpreter walk")
        out = self._batch(reviews, tracing=tracing)
        self.sizes.append(len(reviews))
        for review, (results, _trace) in zip(reviews, out):
            uid = review["uid"]
            self.results[uid] = results_sig(results)
        return out

    def review_batch_eval(self, reviews, tracing, memo_reviews=None):
        self.missed.append(len(reviews))
        return self._eval(reviews, tracing, memo_reviews=memo_reviews)

    def compute_masks(self, reviews):
        before = dict(_dev().launches)
        out = self._masks(reviews)
        self.per_eval.append({k: v - before[k]
                              for k, v in _dev().launches.items()
                              if v != before[k]})
        return out


def _https(port: int):
    import http.client
    import ssl

    ctx = ssl.create_default_context()
    ctx.check_hostname = False
    ctx.verify_mode = ssl.CERT_NONE
    return http.client.HTTPSConnection("127.0.0.1", port, context=ctx,
                                       timeout=600)


def _admission(uid: str, pod: dict) -> bytes:
    md = pod["metadata"]
    return json.dumps({"request": {
        "uid": uid, "kind": {"group": "", "version": "v1", "kind": "Pod"},
        "name": md["name"], "namespace": md["namespace"],
        "operation": "CREATE", "userInfo": {"username": "chip-smoke"},
        "object": pod,
    }}).encode()


def admit(conn, uid: str, pod: dict) -> tuple:
    """One admission over ``conn`` -> (its response, milliseconds)."""
    body = _admission(uid, pod)
    t0 = time.perf_counter()
    conn.request("POST", "/v1/admit", body,
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    data = resp.read()
    ms = (time.perf_counter() - t0) * 1e3
    if resp.status != 200:
        raise AssertionError(f"{uid}: HTTP {resp.status}: {data[:200]!r}")
    return json.loads(data)["response"], ms


def check_answers(answers: dict, spy: ProcessSpy, want: dict) -> int:
    """Every answer equal to phase 3's results for its pod, none an error
    response, and the App's results equal to phase 3's -> denials."""
    denied = 0
    for uid, resp in answers.items():
        if resp.get("uid") != uid:
            raise AssertionError(f"{uid}: answered as {resp.get('uid')}")
        allowed, msg = expected_response(want[uid])
        status = resp.get("status") or {}
        if resp["allowed"] != allowed or status.get("message") != msg or \
                (not allowed and status.get("code") != 403):
            raise AssertionError(f"{uid}: {resp} is not phase 3's "
                                 f"({allowed}, {msg!r})")
        if spy.results.get(uid) != want[uid]:
            raise AssertionError(f"{uid}: the App's results differ from "
                                 f"phase 3's")
        denied += not allowed
    return denied


def process_store(churn, n_templates: int):
    """An API store as a restart finds it: the templates and constraints
    of phase 3's corpus, a Config that syncs Pods, the namespaces, and
    every pod phase 3's client holds now (the same seed's corpus, with
    phases 6 and 9's churn)."""
    from gatekeeper_tpu_torch.kube.inmem import InMemoryKube
    from gatekeeper_tpu_torch.util import synthetic as syn

    kube = InMemoryKube()
    templates, constraints = syn.make_templates(n_templates, SEED)
    pods = list(churn.live.values())
    for ns in sorted({p["metadata"]["namespace"] for p in pods}):
        kube.create({"apiVersion": "v1", "kind": "Namespace",
                     "metadata": {"name": ns}})
    kube.create({
        "apiVersion": "config.gatekeeper.sh/v1alpha1", "kind": "Config",
        "metadata": {"name": "config", "namespace": "gatekeeper-system"},
        "spec": {"sync": {"syncOnly": [
            {"group": "", "version": "v1", "kind": "Pod"}]}},
    })
    for obj in templates + constraints + pods:
        kube.create(obj)
    return kube, constraints, len(pods)


def _stored_pods(driver) -> int:
    with driver.store._lock:
        spaces = driver.store.tree.get("namespace") or {}
        return sum(len((gv.get("v1") or {}).get("Pod") or {})
                   for gv in spaces.values())


def stored_pod_rvs(driver) -> dict:
    """(namespace, name) -> resourceVersion of each pod a client holds."""
    with driver.store._lock:
        spaces = driver.store.tree.get("namespace") or {}
        return {(ns, name): str(obj["metadata"]["resourceVersion"])
                for ns, gv in spaces.items()
                for name, obj in ((gv.get("v1") or {}).get("Pod")
                                  or {}).items()}


def synced(app):
    """Wait until the controllers' queues are empty and the App's client
    holds every pod of its API store at the store's resourceVersion."""
    deadline = time.perf_counter() + 120
    while time.perf_counter() < deadline:
        if app.manager.drain(timeout=60) and stored_pod_rvs(
                app.client.driver) == app.kube.list_rvs(POD_GVK):
            return
        time.sleep(0.01)
    raise AssertionError("the App's client does not hold its store's pods")


def await_ready(app, conn, t_start: float, n_templates: int,
                n_constraints: int, n_pods: int) -> dict:
    """Poll the App until /readyz answers 200 with every template and
    constraint ingested and every pod stored -> the seconds since
    ``t_start`` at which each was first seen ("templates", "pods",
    "ready")."""
    driver = app.client.driver
    marks = {}
    deadline = t_start + PROCESS_READY_S
    while time.perf_counter() < deadline and "ready" not in marks:
        now = time.perf_counter() - t_start
        if "templates" not in marks and len(
                app.client.templates()) == n_templates and sum(
                len(v) for v in driver.constraints.values()) == \
                n_constraints:
            marks["templates"] = now
        if "pods" not in marks and _stored_pods(driver) == n_pods:
            marks["pods"] = now
        conn.request("GET", "/readyz")
        r = conn.getresponse()
        r.read()
        if r.status == 200 and "templates" in marks and "pods" in marks:
            marks["ready"] = time.perf_counter() - t_start
        time.sleep(0.05)
    if "ready" not in marks:
        raise AssertionError(f"the App is not ready after "
                             f"{PROCESS_READY_S} s: {marks}")
    return marks


def constraint_totals(kube, constraints) -> dict:
    """(kind, name) -> (status.totalViolations, totalViolationsExact)."""
    out = {}
    for c in constraints:
        st = kube.get(("constraints.gatekeeper.sh", "v1beta1", c["kind"]),
                      c["metadata"]["name"]).get("status") or {}
        out[(c["kind"], c["metadata"]["name"])] = (
            st.get("totalViolations"), st.get("totalViolationsExact"))
    return out


def _as_status(totals: dict) -> dict:
    return {k: (n, how == "exact") for k, (n, how) in totals.items()}


def cycle(app, label: str, record: list, want=None, constraints=None):
    """One audit cycle of the App -> its record; its totals must equal
    ``want`` (a sweep of the same inventory by phase 3's client)."""
    driver = app.client.driver
    t0 = time.perf_counter()
    ok = app.audit_manager.run_once_guarded()
    wall = time.perf_counter() - t0
    if not ok:
        raise AssertionError(f"audit cycle {label} failed")
    st = dict(driver.last_sweep_stats)
    rec = {"cycle": label, "s": wall,
           "path": "delta" if "delta_rows" in st else
           "cached" if "cached" in st else "full",
           **{k: st.get(k) for k in ("pack_ms", "device_ms", "render_ms",
                                     "delta_rows", "scatter_rows",
                                     "rendered_cells")}}
    if want is not None:
        got = constraint_totals(app.kube, constraints)
        if got != _as_status(want):
            bad = [k for k in got if got[k] != _as_status(want).get(k)]
            raise AssertionError(f"cycle {label}: totals differ from phase "
                                 f"3's sweep for {bad[:5]}")
    record.append(rec)
    return rec


RESTART_LOAD = """
import json, time
t0 = time.perf_counter()
import torch
from gatekeeper_tpu_torch import device
from gatekeeper_tpu_torch.ops.driver import TorchDriver
t1 = time.perf_counter()
torch.cuda.init()
t2 = time.perf_counter()
d = TorchDriver(device="cuda")
t3 = time.perf_counter()
print(json.dumps({"import_s": t1 - t0, "cuda_init_s": t2 - t1,
                  "construct_s": t3 - t2,
                  "kernels_load_s": d.kernels_load_s,
                  "nvcc_s": device.build_seconds,
                  "ready": d.wait_ready(timeout=0.0)}))
"""


def restart_kernels_load() -> dict:
    """What a restarted process pays to load the kernels: a fresh
    process builds a TorchDriver on the card with the build cache as
    this run left it (every library built), so no nvcc runs; -> its
    times."""
    out = subprocess.run([sys.executable, "-c", RESTART_LOAD], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    if out.returncode != 0:
        raise AssertionError(f"the restarted driver failed: {out.stderr}")
    got = json.loads(out.stdout.strip().splitlines()[-1])
    if got["nvcc_s"] or not got["ready"]:
        raise AssertionError(f"the restart rebuilt the kernels: {got}")
    return got


# ---- the device profiler in the App (--jax-profile-port, phase 10) --------

# capture (a): fresh one-pod admissions over HTTPS inside one window; (b)
# one forced full audit cycle.  Each window outlasts its traffic under
# the profiler and a full collection of this process (2.0-2.5 s at this
# size); a capture whose traffic is not done when its window closes
# fails the phase
PROFILE_ADMISSIONS = 64
PROFILE_ADMISSION_MS = 6000
PROFILE_CYCLE_MS = 6000
# K9's launchers (its sweep, review and delta modes), one K9 row
K9_LAUNCHERS = ("program", "program_pack", "program_delta")
# a full sweep's kernels, whose App medians (Kineto) must lie within
# PROFILE_RATIO of this run's CUDA-event medians at the same shapes
PROFILE_SWEEP = {"K1": "match", "K9": "program", "K4": "reduction"}
PROFILE_RATIO = (0.5, 2.0)
# ... where the CUDA-event median is at least this (ms): events around a
# kernel of a few microseconds (a small corpus's K4) time the launch gap
PROFILE_MIN_MS = 0.02


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


class ProfileCapture:
    """One GET /capture?ms=N on an App's device profiler, in a thread;
    ``open()`` returns once its window runs, ``close()`` checks the
    window is still open (the traffic fell inside it) and returns the
    trace."""

    def __init__(self, port: int, ms: int):
        import threading

        self.port, self.ms, self.result = port, ms, None
        self.thread = threading.Thread(target=self._run)

    def _run(self):
        import urllib.error
        import urllib.request

        url = f"http://127.0.0.1:{self.port}/capture?ms={self.ms}"
        try:
            with urllib.request.urlopen(url, timeout=600) as r:
                self.result = (r.status, json.loads(r.read()))
        except urllib.error.HTTPError as e:
            self.result = (e.code, json.loads(e.read()))

    def open(self) -> float:
        """Start the capture -> the seconds until its window opened."""
        t0 = time.perf_counter()
        self.thread.start()
        while not http_json(self.port, "/status")["capturing"]:
            if not self.thread.is_alive() or \
                    time.perf_counter() - t0 > 300:
                self._join()
                raise AssertionError(f"the capture's window never opened: "
                                     f"{self.result}")
            time.sleep(0.005)
        return time.perf_counter() - t0

    def _join(self):
        # the request's own timeout bounds the thread
        self.thread.join(timeout=660)
        if self.thread.is_alive():
            raise AssertionError("the capture's request did not return")

    def close(self, label: str) -> dict:
        if not http_json(self.port, "/status")["capturing"]:
            raise AssertionError(f"capture {label}: its traffic outlasted "
                                 f"its {self.ms} ms window")
        self._join()
        code, trace = self.result
        if code != 200:
            raise AssertionError(f"capture {label}: HTTP {code}: {trace}")
        import gzip

        out = os.path.join(ROOT, "build", "captures")
        os.makedirs(out, exist_ok=True)
        with gzip.open(os.path.join(out, f"capture_{label}.json.gz"),
                       "wt") as f:
            json.dump(trace, f)
        return trace["gk_summary"]


def profile_record(summary: dict, wall_s: float) -> dict:
    """A capture's summary as a log record: its busy shares (of the
    window and of ``wall_s``, its traffic's wall), its kernels and their
    medians, its five longest gaps with the spans open over each, and the
    spans' busy shares."""
    return {
        "window_ms": summary["window_ms"], "traffic_s": wall_s,
        "busy_ms": summary["device_busy_ms"],
        "busy_share_window": summary["busy_share"],
        "busy_share_traffic": summary["device_busy_ms"] / 1e3 / wall_s,
        "kernels": {k: v for k, v in summary["kernels"].items()
                    if v["count"]},
        "gaps": summary["gaps"],
        "spans": {r["name"]: {k: r[k] for k in ("count", "ms",
                                                "device_busy_ms",
                                                "busy_share")}
                  for r in summary["spans"]},
        "launches": summary["launches"],
        "profiler_start_ms": summary["profiler_start_ms"],
        "export_ms": summary["export_ms"],
        "alignment_error_us": summary["alignment_error_us"],
        "events": summary["events"], "dropped": summary["events_dropped"],
    }


def check_profiled_launches(label: str, summary: dict, moved: dict,
                            want: dict) -> None:
    """Kineto's kernel counts against the launch counters: K1's count
    equal to the window's match launches, K9's to its three launchers',
    each K in ``want`` exactly that often, and no launch of the run
    outside the window (``moved``, the counters around the capture)."""
    launches = summary["launches"]
    k9 = sum(launches.get(k, 0) for k in K9_LAUNCHERS)
    got = {k: v["count"] for k, v in summary["kernels"].items()}
    if got["K1"] != launches.get("match", 0) or got["K9"] != k9 or \
            any(got[k] != n for k, n in want.items()) or \
            {k: v for k, v in moved.items() if v} != launches:
        raise AssertionError(f"capture {label}: kernels {got} against the "
                             f"window's launches {launches} and the run's "
                             f"{moved}, want {want}")


def process_phase(args, client, driver, churn, pods, batch, review_sigs,
                  batch_sigs, event_ms) -> dict:
    """Phase 10's counted run: gatekeeper_tpu_torch.main.App, the process
    users deploy, on the card over the API store of phase 3's corpus at
    full size -> the launches of its run."""
    import threading

    from gatekeeper_tpu_torch import main as gmain
    from gatekeeper_tpu_torch.main import App, build_parser

    gdev = _dev()
    # the kernels' load as a restart pays it (in this process they are
    # loaded already, so the App's own load below is a memo hit)
    log("process_restart_kernels_load", **restart_kernels_load())
    # the reference: phase 3's client sweeps its own inventory, the one the
    # App's store is filled with
    force_full(driver)
    _resp, ref_totals = client.audit_capped(CAP)
    # pods the App has not seen, for the requests sent during an audit
    # cycle, with their answers from phase 3's client (outside the
    # counted run)
    during_pods = fresh_pods(PROCESS_DURING_AUDIT, SEED + 93, "during")
    during_sigs = results_of(client, during_pods)
    # and for the admissions of the profiler's capture (a)
    prof_pods = fresh_pods(PROFILE_ADMISSIONS, SEED + 91, "profiled")
    prof_sigs = results_of(client, prof_pods)
    t0 = time.perf_counter()
    kube, constraints, n_pods = process_store(churn, args.templates)
    log("process_store", seconds=time.perf_counter() - t0, pods=n_pods,
        templates=args.templates)
    cert_dir = os.path.join(ROOT, "build", "process_certs")
    # the snapshot directory phase 11 restarts from (empty: this start
    # restores nothing)
    snap_dir = os.path.join(ROOT, "build", "process_snapshots")
    shutil.rmtree(snap_dir, ignore_errors=True)
    flags = ["--driver", "torch", "--torch-device", DEVICE,
             "--port", "0", "--prometheus-port", "0", "--health-addr", ":0",
             "--audit-from-cache", "--audit-interval", "86400",
             "--constraint-violations-limit", str(CAP),
             "--log-level", "WARNING", "--cert-dir", cert_dir,
             "--snapshot-dir", snap_dir, "--snapshot-interval", "86400",
             "--jax-profile-port", str(free_port())]
    ref_launches = dict.fromkeys(gdev.launches, 0)
    gdev.reset_launches()
    t_start = time.perf_counter()
    app = App(build_parser().parse_args(flags), kube=kube)
    t_built = time.perf_counter()
    adriver = app.client.driver
    if adriver.device.type != DEVICE or app.rotator is None:
        raise AssertionError(f"the App runs on {adriver.device} with "
                             f"rotation {app.rotator}")
    spy = ProcessSpy(adriver)
    # the collector's pauses in each part of the run (the webhook server
    # freezes and disables it at start; its sweeper collects every 5 s)
    pauses = GcPauses()
    gc.callbacks.append(pauses)
    # the parts of the way to ready, until the pods are synced (phase
    # 11's restart reads the same)
    ready_split = Timed(*ready_spans(), pauses=pauses).__enter__()
    with Timed((gmain.CertRotator, "write_cert_files"),
               (gmain.UpgradeManager, "upgrade"), (gmain.Tracker, "run"),
               (gmain.Manager, "start"), (gmain.WebhookServer, "start"),
               (gmain.AuditManager, "start"),
               (gmain.MetricsExporter, "start"),
               pauses=pauses) as start_split:
        app.start()
    t_started = time.perf_counter()
    try:
        # the snapshot writer's background loop stops before any cycle
        # wakes it: the one write, timed, comes after the last cycle
        app.snapshotter.stop()
        if app.snapshot_restore_outcome != "none":
            raise AssertionError(f"the App restored "
                                 f"{app.snapshot_restore_outcome}")
        conn = _https(app.webhook_server.port)
        marks = await_ready(app, conn, t_start, args.templates,
                            len(constraints), n_pods)
        synced(app)
        ready_split.__exit__()
        log("process_ready", **pauses.take(), start_split=start_split.split(),
            ready_split=ready_split.split(),
            construct_s=t_built - t_start,
            kernels_load_s=adriver.kernels_load_s,
            kernels_first_build_s=gdev.build_seconds,
            start_s=t_started - t_built, templates_ingested_s=marks[
                "templates"], pods_synced_s=marks["pods"],
            ready_s=marks["ready"], pods=n_pods)
        # the App's background calibration, awaited before any counted
        # traffic: its evaluations are known and counted apart
        cal_wait_s = await_calibration(adriver)
        # the App's admissions on the card from here, whatever their
        # price (GK_DEVICE_MIN_CELLS=0 would skip the calibration checked
        # here)
        adriver.DEVICE_MIN_CELLS = 0
        cal_evals, spy.per_eval = spy.per_eval, []
        check_calibration(cal_evals)
        log("process_calibration", model=adriver._route_cal,
            waited_after_ready_s=cal_wait_s,
            launches=calibration_launches(),
            predicted_ms={n: adriver.predicted_batch_ms(n)
                          for n in (1, 8, 32, 64)}, **pauses.take())

        # the audit: a cold cycle (a full sweep) and warm ones, each
        # equal to phase 3's sweep of the same inventory
        cycles = []
        cycle(app, "cold", cycles, ref_totals, constraints)
        for i in range(PROCESS_WARM):
            cycle(app, f"warm{i}", cycles, ref_totals, constraints)
        log("process_audit", cycles=cycles, **pauses.take())
        if cycles[0]["path"] != "full":
            raise AssertionError(f"the cold cycle was {cycles[0]['path']}")

        # admission: phase 3's pods, one at a time over one connection
        want, answers = {}, {}
        lat = []
        for i, pod in enumerate(pods):
            uid = f"seq-{i}"
            want[uid] = review_sigs[i]
            answers[uid], ms = admit(conn, uid, pod)
            lat.append(ms)
        denied = check_answers(answers, spy, want)
        log("process_reviews", n=len(lat), p50_ms=statistics.median(lat),
            p99_ms=percentile(lat, 99), max_ms=max(lat), denied=denied,
            batches=len(spy.sizes), slowest_ms=sorted(lat)[-5:],
            **pauses.take())
        # the same pods again, one at a time over the same connection:
        # each a request-memo hit, measured in a pass of its own, with no
        # evaluation and the same answers
        evals0, missed0 = len(spy.per_eval), len(spy.missed)
        rep_want, rep_answers, rep_lat = {}, {}, []
        for i, pod in enumerate(pods):
            uid = f"repeat-{i}"
            rep_want[uid] = review_sigs[i]
            rep_answers[uid], ms = admit(conn, uid, pod)
            rep_lat.append(ms)
        check_answers(rep_answers, spy, rep_want)
        if len(spy.per_eval) != evals0 or len(spy.missed) != missed0:
            raise AssertionError("a repeated pod was evaluated again")
        want.update(rep_want)
        answers.update(rep_answers)
        log("process_reviews_repeated", n=len(rep_lat),
            p50_ms=statistics.median(rep_lat),
            p99_ms=percentile(rep_lat, 99), max_ms=max(rep_lat),
            **pauses.take())

        # a burst: phase 3's batch pods from client threads, each on its
        # own keep-alive connection
        n_threads, each = PROCESS_BURST
        burst, errors = {}, []
        sizes0 = len(spy.sizes)

        def client_thread(t):
            try:
                c = _https(app.webhook_server.port)
                for j in range(each):
                    i = t * each + j
                    uid = f"burst-{i}"
                    burst[uid] = admit(c, uid, batch[i])
                c.close()
            except Exception as e:  # surfaced below
                errors.append(repr(e))

        threads = [threading.Thread(target=client_thread, args=(t,))
                   for t in range(n_threads)]
        t0 = time.perf_counter()
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        burst_s = time.perf_counter() - t0
        if errors:
            raise AssertionError(f"burst clients failed: {errors[:3]}")
        want.update({f"burst-{i}": batch_sigs[i]
                     for i in range(n_threads * each)})
        answers.update({uid: r for uid, (r, _ms) in burst.items()})
        burst_lat = [ms for _r, ms in burst.values()]
        sizes = spy.sizes[sizes0:]
        mb = app.micro_batcher
        log("process_burst", clients=n_threads, requests=len(burst),
            seconds=burst_s, requests_per_s=len(burst) / burst_s,
            p50_ms=statistics.median(burst_lat),
            p99_ms=percentile(burst_lat, 99), max_ms=max(burst_lat),
            batches=len(sizes), batch_sizes=sorted(sizes),
            mean_batch=len(burst) / len(sizes),
            batcher={"adaptive": mb.adaptive, "target": mb._target_batch,
                     "deadline_ms": mb._deadline_s * 1e3,
                     "offered_rps": mb._load_rps},
            **pauses.take())

        # requests while an audit cycle holds the driver: a full sweep
        # (forced) in a thread, and PROCESS_DURING_AUDIT requests sent once
        # the sweep has begun
        entered = threading.Event()
        sweep = adriver.audit_capped

        def audit_capped(cap, tracing=False):
            entered.set()
            return sweep(cap, tracing=tracing)

        adriver.audit_capped = audit_capped
        force_full(adriver)
        during, audit_wall = [], []

        def audit_thread():
            t = time.perf_counter()
            cycle(app, "during_reviews", cycles, ref_totals, constraints)
            audit_wall.append(time.perf_counter() - t)

        th = threading.Thread(target=audit_thread)
        th.start()
        entered.wait(60)
        t0 = time.perf_counter()
        for i in range(PROCESS_DURING_AUDIT):
            uid = f"during-{i}"
            want[uid] = during_sigs[i]
            answers[uid], ms = admit(conn, uid, during_pods[i])
            during.append((time.perf_counter() - t0, ms))
        th.join()
        adriver.audit_capped = sweep
        if not audit_wall:
            raise AssertionError("the audit cycle during reviews failed")
        lat_d = [ms for _t, ms in during]
        log("process_reviews_during_audit", n=len(lat_d),
            p50_ms=statistics.median(lat_d), max_ms=max(lat_d),
            first_ms=lat_d[0], audit_cycle_s=audit_wall[0],
            audit_record=cycles[-1],
            answered_within_cycle=sum(1 for t, _ms in during
                                      if t < audit_wall[0]),
            slowest_ms=sorted(lat_d)[-5:], **pauses.take())
        denied = check_answers(answers, spy, want)
        # K1 and K9's review mode once for each review_batch call with a
        # miss; a call whose reviews all hit the memo launches nothing
        evals = spy.per_eval
        want_eval = {"match": 1, "program_pack": 1}
        bad = [e for e in evals if e != want_eval]
        if bad or len(evals) != len(spy.missed) or \
                len(spy.missed) > len(spy.sizes):
            raise AssertionError(f"a review evaluation launched {bad[:3]}: "
                                 f"K1 and K9's review mode once each for "
                                 f"each of {len(spy.missed)} review_batch "
                                 f"calls with a miss ({len(evals)} "
                                 f"evaluations)")
        log("process_admission", requests=len(answers), denied=denied,
            review_batch_calls=len(spy.sizes),
            calls_with_a_miss=len(spy.missed),
            reviews_missed=sum(spy.missed), evaluations=len(evals),
            launches_per_evaluation=want_eval)

        # the device profiler (--jax-profile-port): the card's memory,
        # then capture (a) over fresh one-pod admissions and capture (b)
        # over one forced full audit cycle, each trace's kernels held
        # against the launch counters over its window
        from gatekeeper_tpu_torch.obs.compilestats import tree_nbytes

        prof_port = app.device_profile_server.port
        mem = http_json(prof_port, "/memory")
        # the App's resident audit pack on the card (65,273,856 bytes at
        # 500 x 100k): the allocator holds at least that
        resident = int(tree_nbytes(adriver._audit_dev[1]))
        if mem["allocated_bytes"]["current"] < resident:
            raise AssertionError(f"/memory below the App's resident pack "
                                 f"of {resident} bytes: {mem}")
        log("process_profile_memory", resident_pack_bytes=resident, **mem)
        before, evals0 = dict(gdev.launches), len(spy.per_eval)
        cap = ProfileCapture(prof_port, PROFILE_ADMISSION_MS)
        open_s = cap.open()
        prof_want, prof_answers, lat_a = {}, {}, []
        t0 = time.perf_counter()
        for i, pod in enumerate(prof_pods):
            uid = f"profiled-{i}"
            prof_want[uid] = prof_sigs[i]
            prof_answers[uid], ms = admit(conn, uid, pod)
            lat_a.append(ms)
        wall_a = time.perf_counter() - t0
        summary = cap.close("a")
        moved = {k: n - before[k] for k, n in gdev.launches.items()}
        check_answers(prof_answers, spy, prof_want)
        n_evals = len(spy.per_eval) - evals0
        if n_evals != PROFILE_ADMISSIONS:
            raise AssertionError(f"capture (a): {n_evals} evaluations for "
                                 f"{PROFILE_ADMISSIONS} fresh pods")
        check_profiled_launches("a", summary, moved,
                                {"K1": n_evals, "K9": n_evals})
        log("process_profile_admissions", n=len(lat_a),
            p50_ms=statistics.median(lat_a), p99_ms=percentile(lat_a, 99),
            window_open_s=open_s, **profile_record(summary, wall_a))
        force_full(adriver)
        before = dict(gdev.launches)
        cap = ProfileCapture(prof_port, PROFILE_CYCLE_MS)
        open_s = cap.open()
        t0 = time.perf_counter()
        rec = cycle(app, "profiled", cycles, ref_totals, constraints)
        wall_b = time.perf_counter() - t0
        summary = cap.close("b")
        moved = {k: n - before[k] for k, n in gdev.launches.items()}
        if rec["path"] != "full":
            raise AssertionError(f"capture (b)'s cycle: {rec}")
        check_profiled_launches("b", summary, moved,
                                {"K1": 1, "K9": 1, "K4": 1})
        ratios = {k: summary["kernels"][k]["median_us"] / 1e3
                  / event_ms[name] for k, name in PROFILE_SWEEP.items()}
        if not all(PROFILE_RATIO[0] <= r <= PROFILE_RATIO[1]
                   for k, r in ratios.items()
                   if event_ms[PROFILE_SWEEP[k]] >= PROFILE_MIN_MS):
            raise AssertionError(f"capture (b): Kineto's medians over the "
                                 f"CUDA events' {event_ms}: {ratios}")
        # the device stage: audit.dispatch and audit.fetch together
        spans = {r["name"]: r for r in summary["spans"]}
        stage = [spans[n] for n in ("audit.dispatch", "audit.fetch")
                 if n in spans]
        stage_ms = sum(r["ms"] for r in stage)
        stage_busy = sum(r["device_busy_ms"] for r in stage)
        log("process_profile_cycle", cycle=rec, window_open_s=open_s,
            kineto_over_cuda_events=ratios, cuda_event_ms=event_ms,
            device_stage={"ms": stage_ms, "busy_ms": stage_busy,
                          "busy_share": stage_busy / stage_ms
                          if stage_ms else None},
            **profile_record(summary, wall_b))

        # churn written through the store, each d's cycles on the delta
        # path, each equal to phase 3's client's sweep after the same
        # changes
        churn.clients = [client, KubeWriter(kube)]
        for d in PROCESS_CHURN_D:
            for _ in range(PROCESS_CHURN_CYCLES):
                ops = churn.step(d)
                synced(app)
                # the reference's sweep launches on the same card inside
                # the App's counted window: its launches are not the App's
                before = dict(gdev.launches)
                _resp, want_totals = client.audit_capped(CAP)
                for k, n in gdev.launches.items():
                    ref_launches[k] += n - before[k]
                rec = cycle(app, f"churn{d}", cycles, want_totals,
                            constraints)
                rec.update(ops)
                if rec["path"] != "delta" or rec["delta_rows"] != d:
                    raise AssertionError(f"churn of {d}: {rec}")
        # and a full sweep of the churned store (K6 patches the resident
        # rows), equal to the last churn cycle's totals
        force_full(adriver)
        rec = cycle(app, "full_after_churn", cycles, want_totals,
                    constraints)
        if rec["path"] != "full" or not rec["scatter_rows"]:
            raise AssertionError(f"the full sweep after churn: {rec}")
        log("process_churn", cycles=[c for c in cycles
                                     if c["cycle"].startswith(("churn",
                                                               "full_"))],
            **pauses.take())
        launches = {k: n - ref_launches[k]
                    for k, n in gdev.launches.items()}
        families = sum(1 for ln in metrics_text(
            app.metrics_exporter.port).splitlines()
            if ln.startswith("# TYPE "))
        if app.audit_manager.consecutive_failures:
            raise AssertionError("an audit cycle failed")
        check_no_divert("the process", driver, adriver)
        # the snapshot of the inventory as the last cycle left it, for
        # phase 11's restart; the resident mask is what it must restore
        written = adriver._delta_state.mask_src.get()
        with MaskToHost() as m2h:
            t0 = time.perf_counter()
            snap_path = app.snapshotter.write_once()
            write_s = time.perf_counter() - t0
        if snap_path is None:
            raise AssertionError(f"no snapshot written: "
                                 f"{app.snapshotter.last_error}")
    finally:
        ready_split.__exit__()
        app.stop()
        gc.callbacks.remove(pauses)
    if not gc.isenabled():
        raise AssertionError("the collector is off after App.stop()")
    missing = [k for k in PROCESS_KERNELS if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels never launched by the process: "
                             f"{missing}")
    # K10 only in the calibration's calls past PACK_IN_K9_MAX_ROWS
    if launches["packbits"] != calibration_launches()["packbits"] or \
            launches["delta"]:
        raise AssertionError(f"K10 beside the calibration's, or K5, "
                             f"launched in the process: {launches}")
    # K9's delta mode: once for each of the App's delta cycles
    n_delta = sum(1 for c in cycles if c["path"] == "delta")
    if launches["program_delta"] != n_delta:
        raise AssertionError(f"K9's delta mode launched "
                             f"{launches['program_delta']} times for "
                             f"{n_delta} delta cycles of the App")
    log("process_launches", main_path=launches, metric_families=families,
        reference_sweeps=ref_launches,
        gc_enabled_after_stop=gc.isenabled(), device=str(adriver.device))
    from gatekeeper_tpu_torch.snapshot import format as snapfmt

    log("process_snapshot", write_s=write_s,
        bytes=snapfmt.dir_bytes(snap_path),
        files={f: os.path.getsize(os.path.join(snap_path, f))
               for f in sorted(os.listdir(snap_path))},
        mask_to_host_s=m2h.seconds, mask_shape=list(written.shape))
    return launches, {"kube": kube, "constraints": constraints,
                      "ready_s": marks["ready"], "flags": flags,
                      "written": written,
                      # each of phase 3's pods' answer, which phase 14's
                      # App over the wire must give again
                      "answers": [answers[f"seq-{i}"]
                                  for i in range(len(pods))]}


# ---- phase 11: the restart (snapshots, warm resume, the kernels' cache) ----

# pods changed in the store while the App is down
RESTART_D = 16
# the mesh restores' depth: a synthetic store of (templates, pods)
RESTART_MESH = (24, 10_000)
RESTART_MESH_D = 16


class RestoreSpy:
    """Every SnapshotLoader.restore while active: the loader (its stats
    and delta_restored), the outcome and the seconds."""

    def __init__(self):
        self.calls = []

    def __enter__(self):
        from gatekeeper_tpu_torch.snapshot.loader import SnapshotLoader

        self._orig = SnapshotLoader.restore
        orig, calls = self._orig, self.calls

        def restore(loader, *a, **kw):
            t0 = time.perf_counter()
            out = orig(loader, *a, **kw)
            calls.append({"loader": loader, "outcome": out,
                          "s": time.perf_counter() - t0})
            return out

        SnapshotLoader.restore = restore
        return self

    def __exit__(self, *exc):
        from gatekeeper_tpu_torch.snapshot.loader import SnapshotLoader

        SnapshotLoader.restore = self._orig
        return False


class MaskToHost:
    """The seconds of each SnapshotWriter._resolve_mask while active: the
    resident mask's way to the host, outside the driver lock."""

    def __enter__(self):
        from gatekeeper_tpu_torch.snapshot.writer import SnapshotWriter

        self._orig = SnapshotWriter.__dict__["_resolve_mask"]
        fn, self.seconds = self._orig.__func__, []

        def resolve(mask_src):
            t0 = time.perf_counter()
            try:
                return fn(mask_src)
            finally:
                self.seconds.append(time.perf_counter() - t0)

        SnapshotWriter._resolve_mask = staticmethod(resolve)
        return self

    def __exit__(self, *exc):
        from gatekeeper_tpu_torch.snapshot.writer import SnapshotWriter

        SnapshotWriter._resolve_mask = self._orig
        return False


class SweepSpy:
    """The (results, totals) of each audit_capped of a driver while
    active."""

    def __init__(self, driver):
        self.driver, self.sweeps = driver, []

    def __enter__(self):
        orig, sweeps = self.driver.audit_capped, self.sweeps

        def audit_capped(cap, tracing=False):
            out = orig(cap, tracing=tracing)
            sweeps.append(out[:2])
            return out

        self.driver.audit_capped = audit_capped
        return self

    def __exit__(self, *exc):
        del self.driver.audit_capped
        return False


def restart_app(flags, kube, n_templates: int, n_constraints: int,
                n_pods: int):
    """Construct and start an App over ``kube`` and wait until it serves,
    holds the store's pods and has calibrated its driver in the
    background -> (app, its marks: construction, start, the seconds from
    construction to each readiness mark, and the calibration's wait
    after them)."""
    from gatekeeper_tpu_torch.main import App, build_parser

    t_start = time.perf_counter()
    app = App(build_parser().parse_args(flags), kube=kube)
    t_built = time.perf_counter()
    try:
        app.start()
        t_started = time.perf_counter()
        conn = _https(app.webhook_server.port)
        marks = await_ready(app, conn, t_start, n_templates, n_constraints,
                            n_pods)
        conn.close()
        synced(app)
        marks["calibration_wait_s"] = await_calibration(app.client.driver)
    except BaseException:
        app.stop()
        raise
    marks.update(construct_s=t_built - t_start,
                 start_s=t_started - t_built)
    return app, marks


def _under_cap(results, totals) -> dict:
    """(kind, name) -> the sorted signatures of its results, for each
    constraint whose results are all listed (total at most the cap)."""
    from gatekeeper_tpu_torch.util import synthetic as syn

    by = {}
    for sig in syn.audit_result_sig(results):
        by.setdefault(sig[:2], []).append(sig)
    return {k: by.get(k, []) for k, (n, _how) in totals.items() if n <= CAP}


def restart_process(args, client, churn, process) -> dict:
    """The App restart from phase 10's snapshot, after churn -> the
    counted launches of the restored App's run."""
    import torch

    from gatekeeper_tpu_torch import main as gmain
    from gatekeeper_tpu_torch.snapshot.loader import SnapshotLoader
    from gatekeeper_tpu_torch.util import synthetic as syn

    gdev = _dev()
    kube, constraints = process["kube"], process["constraints"]
    written = process.pop("written")
    # 16 pods change while no App runs; the reference sweeps them first,
    # outside the counted run
    ops = churn.step(RESTART_D)
    n = (args.templates, len(constraints), len(kube.list_rvs(POD_GVK)))
    ref_resp, want_totals = client.audit_capped(CAP)
    want = _under_cap(ref_resp.results(), want_totals)
    pauses = GcPauses()
    gc.callbacks.append(pauses)
    gdev.reset_launches()
    try:
        with RestoreSpy() as spy, Timed(
                (SnapshotLoader, "_read"), (SnapshotLoader, "_install"),
                (SnapshotLoader, "_resync"),
                (SnapshotLoader, "_restore_delta"), (gmain.Tracker, "run"),
                (gmain.Manager, "start"), (gmain.WebhookServer, "start"),
                *ready_spans(), pauses=pauses) as split:
            app, warm = restart_app(process["flags"], kube, *n)
        ready_gc = pauses.take()
    finally:
        gc.callbacks.remove(pauses)
    try:
        adriver = app.client.driver
        # its background writer stops too: the first cycle runs alone
        app.snapshotter.stop()
        if app.snapshot_restore_outcome != "restored" or \
                len(spy.calls) != 1 or \
                not spy.calls[0]["loader"].delta_restored:
            raise AssertionError(f"the restart restored "
                                 f"{app.snapshot_restore_outcome}, "
                                 f"{spy.calls}")
        # the restored App's calibration, before its first cycle
        cal_launches = {k: v for k, v in gdev.launches.items() if v}
        if cal_launches != calibration_launches():
            raise AssertionError(f"the restored App's calibration launched "
                                 f"{cal_launches}")
        cycles = []
        with SweepSpy(adriver) as sweeps:
            rec = cycle(app, "first", cycles, want_totals, constraints)
        launches = dict(gdev.launches)
        if rec["path"] != "delta" or rec["delta_rows"] != RESTART_D:
            raise AssertionError(f"the restored App's first cycle: {rec}")
        results, totals = sweeps.sweeps[0]
        if _under_cap(results, totals) != want:
            raise AssertionError("the restored App's results differ from "
                                 "phase 3's client's after the same churn")
        # the restored mask, uploaded by that cycle's delta sweep, equal
        # on the card to the one phase 10's App held when it wrote
        restored = adriver._delta_state.mask_src.get()
        torch.cuda.synchronize()
        if restored.device.type != DEVICE or \
                not torch.equal(restored, written):
            raise AssertionError("the restored mask differs on the card")
        del written, restored
        # the same inventory through a forced full sweep of the App's own
        # driver: the same results and totals as the delta path's
        force_full(adriver)
        full_results, full_totals, _trace = adriver.audit_capped(CAP)
        if full_totals != totals or syn.audit_result_sig(
                full_results) != syn.audit_result_sig(results):
            raise AssertionError("the restored App's delta cycle differs "
                                 "from its full sweep")
    finally:
        app.stop()
    want_launch = {"match": 1, "program_delta": 1}
    got = {k: v - cal_launches.get(k, 0) for k, v in launches.items()
           if v != cal_launches.get(k, 0)}
    if got != want_launch:
        raise AssertionError(f"the restored App's first cycle launched "
                             f"{got}, not K1 and K9's delta mode once")
    loader = spy.calls[0]["loader"]
    process["warm_ready_s"] = warm["ready"]
    log("restart_app", restore_s=spy.calls[0]["s"], resync=loader.stats,
        delta_restored=loader.delta_restored, churn=ops,
        warm_marks=warm, cold_ready_s=process["ready_s"],
        start_split=split.split(), gc_until_ready=ready_gc,
        first_cycle=rec, launches=launches, calibration=cal_launches,
        model=adriver._route_cal, mask_equal_on_card=True)
    return launches


def _store_client(width: int):
    """An empty Client on the card at mesh width ``width``."""
    from gatekeeper_tpu_torch.client.client import Client
    from gatekeeper_tpu_torch.ops.driver import TorchDriver

    client = Client(driver=TorchDriver(device=DEVICE))
    client.driver.set_mesh(width > 1, width=width if width > 1 else None)
    return client


def _install(client, templates, constraints):
    for t in templates:
        client.add_template(t)
    for c in constraints:
        client.add_constraint(c)
    return client


def _stored(kube) -> list:
    return [o for gvk in kube.list_gvks() for o in kube.list(gvk)]


def restart_mesh() -> dict:
    """A basis written at width 2 of the virtual mesh, restored at width 2
    and at width 1 -> the counted launches of the two restores' first
    sweeps."""
    import shutil

    import torch

    from gatekeeper_tpu_torch.kube.inmem import InMemoryKube
    from gatekeeper_tpu_torch.parallel import mesh as pm
    from gatekeeper_tpu_torch.snapshot import SnapshotLoader, Snapshotter
    from gatekeeper_tpu_torch.util import synthetic as syn

    gdev = _dev()
    n_templates, n_pods = RESTART_MESH
    templates, constraints = syn.make_templates(n_templates, SEED)
    pods = syn.make_pods(n_pods, SEED + 21)
    kube = InMemoryKube()
    for p in pods:
        kube.create(p)
    snap_dir = os.path.join(ROOT, "build", "restart_mesh_snapshots")
    shutil.rmtree(snap_dir, ignore_errors=True)
    os.environ[pm.VIRTUAL_DEVICES_ENV] = "2"
    try:
        writer = _install(_store_client(2), templates, constraints)
        for o in _stored(kube):
            writer.add_data(o)
        writer.audit_capped(CAP)
        written = writer.driver._delta_state.mask_src.get()
        if not isinstance(written, pm.ShardedMask):
            raise AssertionError("the width-2 sweep's mask is not sharded")
        if Snapshotter(writer, snap_dir, interval_s=0.0).write_once() is None:
            raise AssertionError("the width-2 snapshot was not written")
        ops = Churn([KubeWriter(kube)], pods, SEED + 23).step(RESTART_MESH_D)
        ref = _install(_store_client(1), templates, constraints)
        for o in _stored(kube):
            ref.add_data(o)
        ref_resp, ref_totals = ref.audit_capped(CAP)
        # a capped list follows the pack's row order, which a fresh
        # client's differs from: compared where every result is listed
        want = _under_cap(ref_resp.results(), ref_totals)
        del ref
        gdev.reset_launches()
        records, sigs = {}, {}
        for width in (2, 1):
            client = _store_client(width)
            loader = SnapshotLoader(snap_dir)
            outcome = loader.restore(client, kube)
            resp, totals = client.audit_capped(CAP)
            st = dict(client.driver.last_sweep_stats)
            sigs[width] = syn.audit_result_sig(resp.results())
            if outcome != "restored" or \
                    loader.delta_restored is not (width == 2) or \
                    totals != ref_totals or \
                    _under_cap(resp.results(), totals) != want:
                raise AssertionError(f"the width-{width} restore: "
                                     f"{outcome}, {loader.delta_restored}, "
                                     f"{st}")
            if width == 2:
                if st.get("delta_rows") != RESTART_MESH_D:
                    raise AssertionError(f"width 2 after churn: {st}")
                restored = client.driver._delta_state.mask_src.get()
                torch.cuda.synchronize()
                if restored.rows != written.rows or any(
                        g.device != w.device or not torch.equal(g, w)
                        for g, w in zip(restored.slabs, written.slabs)):
                    raise AssertionError("the restored slabs differ")
            elif "delta_rows" in st:
                raise AssertionError(f"width 1 took the delta path: {st}")
            records[width] = {"outcome": outcome, "resync": loader.stats,
                              "delta_restored": loader.delta_restored,
                              "sweep": st}
            del client
        launches = dict(gdev.launches)
    finally:
        del os.environ[pm.VIRTUAL_DEVICES_ENV]
    # both restored the same pack: the same rows, the same capped lists
    if sigs[1] != sigs[2]:
        raise AssertionError("the width-1 and width-2 restores differ")
    missing = [k for k in ("match", "program", "delta", "reduction")
               if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels never launched by the mesh "
                             f"restores: {missing}")
    log("restart_mesh", templates=n_templates, pods=n_pods, churn=ops,
        widths=records, launches=launches, slabs_equal_on_card=True)
    return launches


def restart_referential() -> dict:
    """The referential parity corpus written, churned and restored with
    its join index under GK_JOIN_ASSERT=1 -> the counted launches of the
    restore and its first sweep."""
    import copy
    import shutil

    from gatekeeper_tpu_torch.client.client import Client
    from gatekeeper_tpu_torch.client.drivers import InterpDriver
    from gatekeeper_tpu_torch.kube.inmem import InMemoryKube
    from gatekeeper_tpu_torch.snapshot import SnapshotLoader, Snapshotter
    from gatekeeper_tpu_torch.util import synthetic as syn

    gdev = _dev()
    n_templates, n_objects = REF_PARITY
    templates, constraints = syn.make_referential_templates(n_templates,
                                                            SEED)
    kube = InMemoryKube()
    for o in syn.make_referential_objects(n_objects, SEED + 1):
        kube.create(o)
    snap_dir = os.path.join(ROOT, "build", "restart_ref_snapshots")
    shutil.rmtree(snap_dir, ignore_errors=True)
    os.environ["GK_JOIN_ASSERT"] = "1"
    try:
        writer = _install(_store_client(1), templates, constraints)
        for o in _stored(kube):
            writer.add_data(o)
        writer.audit_capped(CAP)
        if Snapshotter(writer, snap_dir, interval_s=0.0).write_once() is None:
            raise AssertionError("the referential snapshot was not written")
        del writer
        # ref_parity's churn through the store: an Ingress takes another's
        # host, a PVC's class dangles, a Pod joins the crowded team
        ings = [o for o in kube.list(("networking.k8s.io", "v1", "Ingress"))
                if o["spec"]["rules"][0]["host"].startswith("svc-")]
        ing = copy.deepcopy(ings[0])
        ing["spec"]["rules"] = [dict(ings[1]["spec"]["rules"][0])]
        pvc = kube.list(("", "v1", "PersistentVolumeClaim"))[0]
        pvc["spec"]["storageClassName"] = "missing-0"
        pod = kube.list(POD_GVK)[0]
        pod["metadata"]["labels"]["team"] = "crowded"
        for o in (ing, pvc, pod):
            kube.update(o)
        oracle = _install(Client(driver=InterpDriver()), templates,
                          constraints)
        for o in _stored(kube):
            oracle.add_data(o)
        gdev.reset_launches()
        client = _store_client(1)
        loader = SnapshotLoader(snap_dir)
        outcome = loader.restore(client, kube)
        js = client.driver._join_state
        resp, totals = client.audit_capped(CAP)
        launches = dict(gdev.launches)
        st = dict(client.driver.last_sweep_stats)
        if outcome != "restored" or not loader.delta_restored or \
                js is None or not js.built:
            raise AssertionError(f"the referential restore: {outcome}, "
                                 f"{loader.delta_restored}, {js}")
        if st.get("delta_rows", 0) < 3 or \
                st.get("join_affected_rows", 0) < 1:
            raise AssertionError(f"the first referential sweep: {st}")
        o_resp, o_totals = oracle.audit_capped(CAP)
        o_all = syn.audit_result_sig(oracle.audit().results())
        sig = syn.audit_result_sig(resp.results())
        exact = [k for k, (_n, how) in totals.items() if how == "exact"]
        if not sig or not set(sig) <= set(o_all) or not exact or any(
                totals[k][0] != o_totals[k][0] for k in exact) or \
                syn.audit_result_sig(client.audit().results()) != o_all:
            raise AssertionError("the restored referential sweep differs "
                                 "from the oracle")
    finally:
        del os.environ["GK_JOIN_ASSERT"]
    if launches["joinlookup_table"] == 0 or launches["joinkeys"] != 0 or \
            launches["program_delta"] == 0:
        raise AssertionError(f"the restored referential sweep launched "
                             f"{launches}: K8's table mode and K9's delta "
                             f"mode, no K7")
    log("restart_referential", templates=n_templates, objects=n_objects,
        resync=loader.stats, join_index_restored=True, sweep=st,
        results=len(sig), oracle_results=len(o_all),
        exact_totals=len(exact), launches=launches)
    return launches


CACHE_LOAD = """
import json, sys, time
t0 = time.perf_counter()
from gatekeeper_tpu_torch import device
from gatekeeper_tpu_torch.kube.inmem import InMemoryKube
from gatekeeper_tpu_torch.main import App, build_parser
from gatekeeper_tpu_torch.metrics.views import global_registry
t1 = time.perf_counter()
app = App(build_parser().parse_args([
    "--xla-cache-dir", sys.argv[1], "--cert-dir", sys.argv[2],
    "--log-level", "WARNING"]), kube=InMemoryKube())
t2 = time.perf_counter()
rows = global_registry().view_rows("cache_requests_total")
print(json.dumps({"import_s": t1 - t0, "construct_s": t2 - t1,
                  "kernels_load_s": app.client.driver.kernels_load_s,
                  "nvcc_s": device.build_seconds,
                  "build_dir": device.BUILD_DIR, "libraries": device.cache_log,
                  "hits": rows.get(("kernels", "hit"), 0),
                  "misses": rows.get(("kernels", "miss"), 0),
                  "device": str(app.client.driver.device)}))
"""


def kernel_cache() -> dict:
    """--xla-cache-dir in fresh processes (this one has its libraries
    loaded already): an empty directory builds and seals the ten, the next
    process loads them with no nvcc, and a broken seal is rebuilt ->
    each process's record."""
    import shutil

    from gatekeeper_tpu_torch import device

    cache_dir = os.path.join(ROOT, "build", "restart_kernel_cache")
    shutil.rmtree(cache_dir, ignore_errors=True)
    cert_dir = os.path.join(ROOT, "build", "restart_cache_certs")
    names = device.KERNEL_NAMES

    def one(label: str) -> dict:
        out = subprocess.run(
            [sys.executable, "-c", CACHE_LOAD, cache_dir, cert_dir],
            cwd=ROOT, capture_output=True, text=True, timeout=600)
        if out.returncode != 0:
            raise AssertionError(f"the {label} process failed: "
                                 f"{out.stderr[-2000:]}")
        got = json.loads(out.stdout.strip().splitlines()[-1])
        if got["build_dir"] != os.path.join(cache_dir, "torch_kernels") or \
                not got["device"].startswith("cuda"):
            raise AssertionError(f"the {label} process: {got}")
        return got

    cold = one("cold")
    if cold["libraries"] != dict.fromkeys(names, "built") or \
            cold["misses"] != len(names) or cold["hits"] or \
            not cold["nvcc_s"]:
        raise AssertionError(f"the empty cache did not build the ten: "
                             f"{cold}")
    warm = one("warm")
    if warm["libraries"] != dict.fromkeys(names, "sealed") or \
            warm["hits"] != len(names) or warm["misses"] or warm["nvcc_s"]:
        raise AssertionError(f"the warm cache ran nvcc: {warm}")
    # one library's seal broken: rebuilt, the others loaded
    broken = "packbits"
    lib = [f for f in os.listdir(os.path.join(cache_dir, "torch_kernels"))
           if f.startswith(f"gk_{broken}-") and f.endswith(".so")][0]
    with open(os.path.join(cache_dir, "torch_kernels",
                           lib + device.SEAL_SUFFIX), "w") as f:
        f.write("0" * 64)
    resealed = one("broken seal")
    want = dict.fromkeys(names, "sealed")
    want[broken] = "built"
    if resealed["libraries"] != want or resealed["misses"] != 1:
        raise AssertionError(f"the broken seal was not rebuilt: "
                             f"{resealed}")
    return {"cold": cold, "warm": warm, "broken_seal": resealed}


def restart_phase(args, client, churn, process) -> dict:
    """Phase 11 -> the launches of its counted runs (the restored App's
    first cycle, the mesh restores, the referential restore)."""
    launches = restart_process(args, client, churn, process)
    for part in (restart_mesh(), restart_referential()):
        for k, v in part.items():
            launches[k] += v
    log("kernel_cache", **kernel_cache())
    return launches


class Timed:
    """The wall of each call of the named methods while active (class
    attributes patched, then restored): "Class.method" -> seconds.  A
    target (cls, name, "by_type") is keyed by the class of the instance
    called.  With ``pauses`` (a GcPauses in gc.callbacks), ``gc_ms`` holds
    the collector's pauses inside each key's calls, whichever thread set
    them off (calls that overlap in time share a pause)."""

    def __init__(self, *targets, pauses=None):
        self.targets = targets
        self.pauses = pauses
        self.seconds = {}
        self.gc_ms = {}

    def _wrap(self, key, fn, by_type):
        def timed(*a, **kw):
            k = f"{type(a[0]).__name__}.{fn.__name__}" if by_type else key
            g0 = self.pauses.total_ms if self.pauses else 0.0
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                self.seconds[k] = self.seconds.get(k, 0.0) + (
                    time.perf_counter() - t0)
                if self.pauses:
                    self.gc_ms[k] = self.gc_ms.get(k, 0.0) + (
                        self.pauses.total_ms - g0)
        return timed

    def __enter__(self):
        self._saved = [(t[0], t[1], t[0].__dict__[t[1]], len(t) > 2)
                       for t in self.targets]
        for cls, name, fn, by_type in self._saved:
            setattr(cls, name,
                    self._wrap(f"{cls.__name__}.{name}", fn, by_type))
        return self

    def __exit__(self, *exc):
        for cls, name, fn, _by_type in self._saved:
            setattr(cls, name, fn)
        return False

    def split(self) -> dict:
        """key -> {"s": seconds, "gc_ms": pauses inside}."""
        return {k: {"s": v, "gc_ms": self.gc_ms.get(k)}
                for k, v in self.seconds.items()}


def ready_spans() -> tuple:
    """The parts of an App's way to ready that the restart compares with a
    cold start: Manager.start's calls (the engine reset of a cold start,
    each watch added, each controller's start, the readiness tracker's
    collect), the Config's reconcile and the sync controller's reconciles
    (in their threads), as Timed targets."""
    from gatekeeper_tpu_torch.client.client import Client
    from gatekeeper_tpu_torch.controllers.base import Controller
    from gatekeeper_tpu_torch.controllers.config import ConfigController
    from gatekeeper_tpu_torch.controllers.sync import SyncController
    from gatekeeper_tpu_torch.readiness.tracker import Tracker
    from gatekeeper_tpu_torch.watch.manager import Registrar

    return ((Client, "reset"), (Registrar, "add_watch"),
            (Controller, "start", "by_type"), (Tracker, "collect"),
            (ConfigController, "reconcile"), (SyncController, "reconcile"))


def metrics_text(port: int) -> str:
    """The App's /metrics as text."""
    import urllib.request

    with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                timeout=60) as r:
        return r.read().decode()


# ---- phase 12: the fleet (webhook replicas restoring one snapshot) ---------

# replicas on the one card, spawned by spawn_fleet all at once: one at a
# time (about 14 s each alone) would add ~30 s to a run that already
# takes two thirds of its 1,200 s
FLEET_REPLICAS = 3
# the stream command: reviews and the chunk each review_batch takes (past
# 32 rows K9 does not pack, so each chunk runs K1, K9 and K10)
FLEET_STREAM = (8192, 2048)
# the longest a replica may take from its spawn to its ready line
FLEET_SPAWN_S = 600
# the kernels each review_batch launches, once each: at the stream's chunk
# (K9 does not pack past 32 rows, so K10 packs after it), and on an
# admission batch of up to 32 reviews (K9 packs in its launch)
FLEET_KERNELS = {"match": 1, "program": 1, "packbits": 1}
FLEET_ADMISSION_KERNELS = {"match": 1, "program_pack": 1}
FLEET_ADMISSION_MAX = 32
# the least device memory a replica's CUDA context takes beside what its
# allocator reserves: a replica took 620-644 MiB of an NVIDIA H100 80GB
# HBM3 (700 W), nearly all of it its context; above two thirds of that,
# the three replicas' sum cannot be met by two contexts
FLEET_CONTEXT_MIB = 480
# the traced request's id, sent to the door as the caller's traceparent,
# and the seconds its replica half may take to join the door's trace
FLEET_TRACE_ID = "4bf92f3577b34da6a3ce929d0e0e4736"
FLEET_TRACE_WAIT_S = 20
# every replica's flags, the respawn's too: the defaults, the brownout
# ladder on
FLEET_FLAGS = ()
# the longest a respawned replica may take from its ready line to
# brownout level 0 with no edge alert firing
FLEET_CALM_S = 20

# a replica's process under replica_watch: chip_smoke is imported from the
# directory given first, then runs the replica's module
REPLICA_ENTRY = ("import sys; sys.path.insert(0, sys.argv.pop(1)); "
                 "import chip_smoke; chip_smoke.replica_watch()")
WATCH_CMD = "watch"
REPLICA_MODULE = "gatekeeper_tpu_torch.fleet.replica"


def replica_watch():
    """A fleet replica's process under phase 12's watch (REPLICA_ENTRY),
    which then runs the replica's module as ``python -m`` runs it.  It
    keeps the collector's pauses (a GcPauses with stamps), every
    TorchDriver.review_batch's review count with the launches that call
    made and whether it evaluated memo misses (_review_batch_eval), every
    background calibrate_routing with its model and launches (the driver's
    admissions forced onto the card once it landed), and, for
    FLEET_TRACE_ID's trace, whether the tracer kept it.  The command
    {"cmd": "watch"} on stdin is answered here with all of that, the
    launch counts, the driver's device, its breaker's state and the card
    memory the process's allocator holds; every other line goes on to the
    replica's command loop.  The answer also holds every reactor
    heartbeat over the edge objective's threshold (wall time, skew, and
    whether a calibration was in flight), the count of heartbeats, the
    reactor telemetry's snapshot, the edge objective's burn rates, the
    alerts the ladder reads, and the ladder's level."""
    import runpy
    import threading

    import torch

    from gatekeeper_tpu_torch import device as gdev
    from gatekeeper_tpu_torch.obs import brownout, reactorobs, slo
    from gatekeeper_tpu_torch.obs import trace as obstrace
    from gatekeeper_tpu_torch.ops.driver import TorchDriver

    pauses = GcPauses(keep=True)
    gc.callbacks.append(pauses)
    # each heartbeat's skew, as the reactor feeds it to the edge objective
    beats = {"n": 0, "slow": []}
    calibrating = [0]
    observe_edge = slo.observe_edge_latency

    def observed(lag_s):
        beats["n"] += 1
        if lag_s > slo.get_engine().edge_threshold_s:
            beats["slow"].append((time.time(), lag_s, calibrating[0] > 0))
        observe_edge(lag_s)

    slo.observe_edge_latency = observed
    # each step of the brownout ladder, with the signals it read, the
    # alerts it saw and every objective's burn rates
    engine, ladder = slo.get_engine(), brownout.get_controller()
    steps = []
    tick = brownout.BrownoutController.tick

    def ticked(self, now=None):
        level = self.level
        tick(self, now)
        if self.level != level:
            with engine._lock:
                latched = sorted(map(list, engine._alerts_active))
            steps.append({"wall": time.time(), "levels": [level, self.level],
                          "signals": dict(self.last_signals),
                          "alerts": latched,
                          "burn": {name: engine.burn_rates(name)
                                   for name in engine.objectives()}})

    brownout.BrownoutController.tick = ticked
    calls, devices, traced, cals, drivers = {}, set(), [], [], []
    # the driver evaluates one batch at a time under its own lock; this
    # one makes each call's launches, and the calibration's, its own
    lock = threading.Lock()
    review_batch = TorchDriver.review_batch
    review_batch_eval = TorchDriver._review_batch_eval
    calibrate = TorchDriver.calibrate_routing
    evals = [0]

    def counted(self, reviews, tracing=False):
        with lock:
            before = dict(gdev.launches)
            evals[0] = 0
            try:
                return review_batch(self, reviews, tracing=tracing)
            finally:
                made = {k: v - before[k] for k, v in gdev.launches.items()
                        if v != before[k]}
                key = json.dumps([len(reviews), made, evals[0]],
                                 sort_keys=True)
                calls[key] = calls.get(key, 0) + 1
                devices.add(str(self.device))
                if not any(d is self for d in drivers):
                    drivers.append(self)

    def evaluated(self, *a, **kw):
        evals[0] += 1
        return review_batch_eval(self, *a, **kw)

    def calibrated(self, *a, **kw):
        with lock:
            before = dict(gdev.launches)
            model = None
            calibrating[0] += 1
            t0 = time.time()
            try:
                model = calibrate(self, *a, **kw)
                if model is not None:
                    # the replica's admissions on the card from here,
                    # whatever their price (GK_DEVICE_MIN_CELLS=0 in its
                    # environment would skip the calibration checked here)
                    self.DEVICE_MIN_CELLS = 0
                return model
            finally:
                calibrating[0] -= 1
                cals.append({"model": model, "launches": {
                    k: v - before[k] for k, v in gdev.launches.items()
                    if v != before[k]}, "wall": [t0, time.time()]})
                if not any(d is self for d in drivers):
                    drivers.append(self)

    TorchDriver.review_batch = counted
    TorchDriver._review_batch_eval = evaluated
    TorchDriver.calibrate_routing = calibrated
    tracer = obstrace.get_tracer()
    complete = tracer.complete

    def kept(trace):
        complete(trace)
        if trace.trace_id == FLEET_TRACE_ID:
            with tracer._lock:
                held = any(t is trace for t in tracer._ring)
            traced.append({"held": held, "sample_rate": tracer.sample_rate,
                           "brownout_level": brownout.get_controller().level,
                           "spans": [s["name"] for s in trace.spans]})

    tracer.complete = kept

    def answer(cmd):
        with lock:
            got = [json.loads(k) + [n] for k, n in sorted(calls.items())]
        cuda = torch.cuda.is_initialized()
        with engine._lock:
            latched = sorted(map(list, engine._alerts_active))
        print(json.dumps({
            "event": "watch", "pid": os.getpid(), "calls": got,
            "launches": {k: v for k, v in gdev.launches.items() if v},
            "devices": sorted(devices), "cuda": cuda,
            "allocated_mib": (torch.cuda.memory_allocated() / 2**20
                              if cuda else 0.0),
            "reserved_mib": (torch.cuda.memory_reserved() / 2**20
                             if cuda else 0.0),
            "pauses": pauses.stamps, "traced": traced,
            "calibrations": list(cals),
            "breakers": [d.breaker.state for d in drivers],
            "heartbeats": {"n": beats["n"], "slow": list(beats["slow"])},
            "reactor": reactorobs.snapshot()["loops"],
            "edge_burn": engine.burn_rates(slo.EDGE_LATENCY),
            "alerts_latched": latched,
            "brownout": {"level": ladder.level,
                         "transitions": ladder.transitions,
                         "signals": dict(ladder.last_signals),
                         "steps": list(steps)},
            "reply_to": cmd.get("id")}), flush=True)

    class Commands:
        """The replica's stdin less the watch command."""

        def __init__(self, stdin):
            self.stdin = stdin

        def __iter__(self):
            for line in self.stdin:
                try:
                    cmd = json.loads(line)
                except ValueError:
                    cmd = None
                if isinstance(cmd, dict) and cmd.get("cmd") == WATCH_CMD:
                    answer(cmd)
                    continue
                yield line

    sys.stdin = Commands(sys.stdin)
    runpy.run_module(REPLICA_MODULE, run_name="__main__", alter_sys=True)


class WatchedSpawns:
    """While active, every replica the fleet's spawn helpers start runs
    its module (``-m gatekeeper_tpu_torch.fleet.replica``, the same
    arguments) under ``entry`` (replica_watch's by default): the helpers'
    subprocess module is swapped for one whose Popen rewrites the command
    and stamps the start (``started``: pid -> wall time)."""

    def __init__(self, entry: str = REPLICA_ENTRY):
        self.entry = entry
        self.started = {}

    def __enter__(self):
        from gatekeeper_tpu_torch.fleet import replica

        def popen(cmd, **kw):
            i = cmd.index("-m")
            if cmd[i + 1] != REPLICA_MODULE:
                raise AssertionError(f"not a replica's command: {cmd}")
            cmd = cmd[:i] + ["-c", self.entry, ROOT] + cmd[i + 2:]
            t = time.time()
            proc = subprocess.Popen(cmd, **kw)
            self.started[proc.pid] = t
            return proc

        self._saved = replica.subprocess
        replica.subprocess = types.SimpleNamespace(
            Popen=popen, PIPE=subprocess.PIPE,
            TimeoutExpired=subprocess.TimeoutExpired)
        return self

    def __exit__(self, *exc):
        from gatekeeper_tpu_torch.fleet import replica

        replica.subprocess = self._saved
        return False

    def ready_wall(self, handle) -> float:
        """The wall time of a replica's ready line."""
        return self.started[handle.proc.pid] + handle.spawn_s

    def pauses(self, handle, watched: dict) -> dict:
        """A replica's collector pauses before its ready line, from its
        watch."""
        return GcPauses.before(watched["pauses"], self.ready_wall(handle))

    def stalls(self, at: str, pairs, smi: str) -> dict:
        """Log each (handle, watch)'s stalls from its ready line on ->
        "replica id:pid" -> its report."""
        out = {f"{h.replica_id}:{h.proc.pid}":
               replica_stalls(h, w, self.ready_wall(h)) for h, w in pairs}
        log("fleet_stalls", at=at, replicas=out, card=smi)
        return out


def watch_replica(h) -> dict:
    """A replica's watch (replica_watch's answer)."""
    got = h.command({"cmd": WATCH_CMD}, timeout_s=120)
    if got.get("pid") != h.proc.pid:
        raise AssertionError(f"replica {h.replica_id}'s watch: {got}")
    return got


def replica_status(h) -> dict:
    """A replica's /statusz: the SLO engine's evaluation and the brownout
    ladder's status, as a probe reads them."""
    import urllib.request

    with urllib.request.urlopen(f"http://127.0.0.1:{h.port}/statusz",
                                timeout=60) as r:
        return json.loads(r.read())


def calm_of(status: dict) -> dict:
    """A /statusz payload -> the ladder's level and transitions and the
    edge objective's alerts that fire."""
    from gatekeeper_tpu_torch.obs.slo import EDGE_LATENCY

    edge = status["slo"]["objectives"][EDGE_LATENCY]
    return {"level": status["brownout"]["level"],
            "transitions": status["brownout"]["transitions"],
            "edge_alerts": sorted(p for p, on in edge["alerts"].items()
                                  if on),
            "edge_burn": edge["burn_rates"],
            "degraded": status["slo"]["degraded"]}


def await_calm(h, ready_wall: float) -> dict:
    """Read a replica's /statusz each half second until FLEET_CALM_S past
    its ready line (once, where that is past): every reading at brownout
    level 0 with no ladder step and no edge alert firing -> the last
    reading and their count."""
    n = 0
    while True:
        got = calm_of(replica_status(h))
        n += 1
        if got["level"] or got["transitions"] or got["edge_alerts"]:
            raise AssertionError(
                f"replica {h.replica_id}, {time.time() - ready_wall:.1f} s "
                f"after its ready line, browned out or alerts: {got}")
        if time.time() >= ready_wall + FLEET_CALM_S:
            return {**got, "readings": n,
                    "after_ready_s": time.time() - ready_wall}
        time.sleep(0.5)


def replica_stalls(h, watched: dict, ready_wall: float) -> dict:
    """A replica's watch -> its heartbeats over the edge objective's
    threshold from its ready line on, each with its skew, the collector
    pauses that overlapped it and whether a calibration was in flight;
    its collections after ready; the reactor telemetry's stalls and
    culprits, the edge objective's burn rates, the alerts the ladder
    reads, and the ladder's level.  A heartbeat is put down to the
    collector where a pause overlapped it, else to a calibration in
    flight, else to neither."""
    pauses = watched["pauses"]
    slow, causes = [], {"collector": 0, "calibration": 0, "neither": 0}
    for wall, skew, cal in watched["heartbeats"]["slow"]:
        if wall < ready_wall:
            continue
        gcs = [(ms, g) for t, ms, g in pauses
               if t >= wall - skew and t - ms / 1e3 <= wall]
        cause = "collector" if gcs else "calibration" if cal else "neither"
        causes[cause] += 1
        slow.append({"after_ready_s": round(wall - ready_wall, 3),
                     "skew_ms": round(skew * 1e3, 3), "calibrating": cal,
                     "gc": [[round(ms, 3), g] for ms, g in gcs]})
    after = [(ms, g) for t, ms, g in pauses if t >= ready_wall]
    out = {"replica": h.replica_id, "pid": h.proc.pid,
           "heartbeats": watched["heartbeats"]["n"],
           "over_50ms": len(slow), "causes": causes, "slow": slow[:24],
           "gc_after_ready": {
               "n": len(after), "gen2": sum(1 for _ms, g in after if g == 2),
               "ms": sum(ms for ms, _g in after),
               "max_ms": max((ms for ms, _g in after), default=0.0)},
           "calibrations": [c["wall"] for c in watched["calibrations"]],
           "reactor": [{k: loop[k] for k in ("loop", "stalls",
                                              "slow_callbacks", "culprits")}
                       for loop in watched["reactor"]],
           "edge_burn": watched["edge_burn"],
           "alerts_latched": watched["alerts_latched"],
           "brownout": watched["brownout"]}
    return out


def check_on_card(h, watched: dict) -> dict:
    """A replica's driver on the card, its allocator holding memory
    there -> what it holds."""
    if watched["devices"] != ["cuda:0"] or not watched["cuda"] or \
            watched["allocated_mib"] <= 0:
        raise AssertionError(
            f"replica {h.replica_id} is not on the card: devices "
            f"{watched['devices']}, cuda {watched['cuda']}, allocated "
            f"{watched['allocated_mib']} MiB")
    return {"devices": watched["devices"],
            "allocated_mib": watched["allocated_mib"],
            "reserved_mib": watched["reserved_mib"]}


def check_replica_launches(h, watched: dict, streams: int) -> dict:
    """A replica's watch: every review_batch that evaluated launched K1
    and K9 once (K9 packing, on an admission batch of up to
    FLEET_ADMISSION_MAX reviews; K9 then K10 on a stream chunk), one whose
    reviews all hit the request memo launched nothing, ``streams`` stream
    commands' chunks (their warm-up chunk included), its one background
    calibration the known launches (an attempt before any constraint
    none), no launch outside them, and its breaker closed -> its
    launches, its admission batches, memo-hit batches and chunks."""
    n, chunk = FLEET_STREAM
    want_chunks = streams * (1 + n // chunk + bool(n % chunk))
    total, batches, reviews, chunks, hits = {}, 0, 0, 0, 0
    for size, made, evaluated, count in watched["calls"]:
        if size == chunk and evaluated == 1:
            want, chunks = FLEET_KERNELS, chunks + count
        elif 0 < size <= FLEET_ADMISSION_MAX and evaluated == 1:
            want = FLEET_ADMISSION_KERNELS
            batches, reviews = batches + count, reviews + size * count
        elif 0 < size <= FLEET_ADMISSION_MAX and evaluated == 0:
            want, hits = {}, hits + count
        else:
            raise AssertionError(f"replica {h.replica_id}: {count} "
                                 f"review_batch calls of {size} with "
                                 f"{evaluated} evaluations")
        if made != want:
            raise AssertionError(
                f"replica {h.replica_id}: {count} review_batch calls of "
                f"{size} launched {made}, not {want}")
        for k, v in made.items():
            total[k] = total.get(k, 0) + v * count
    models = [c for c in watched["calibrations"] if c["model"]]
    if len(models) != 1 or models[0]["launches"] != calibration_launches() \
            or any(c["launches"] for c in watched["calibrations"]
                   if not c["model"]):
        raise AssertionError(f"replica {h.replica_id}'s calibrations: "
                             f"{watched['calibrations']}")
    for k, v in models[0]["launches"].items():
        total[k] = total.get(k, 0) + v
    if chunks != want_chunks or not batches or \
            total != watched["launches"]:
        raise AssertionError(
            f"replica {h.replica_id}: {chunks} stream chunks (not "
            f"{want_chunks}), {batches} admission batches, launches "
            f"{watched['launches']} against its batches' and "
            f"calibration's {total}")
    if watched["breakers"] != ["closed"]:
        raise AssertionError(f"replica {h.replica_id}'s breaker: "
                             f"{watched['breakers']}")
    return {"launches": total, "admission_batches": batches,
            "admission_reviews": reviews, "memo_hit_batches": hits,
            "stream_chunks": chunks, "model": models[0]["model"]}


def await_replica_calibration(h) -> dict:
    """Poll a replica's watch until its background calibration has set a
    model -> that watch."""
    t0 = time.perf_counter()
    while True:
        got = watch_replica(h)
        if any(c["model"] for c in got["calibrations"]):
            return got
        if time.perf_counter() - t0 > CAL_WAIT_S:
            raise AssertionError(f"replica {h.replica_id} never "
                                 f"calibrated: {got['calibrations']}")
        time.sleep(0.5)


def compute_apps() -> dict:
    """pid -> MiB of device memory, of each process nvidia-smi lists on
    the card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid,used_memory",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60)
    apps = {}
    for ln in out.stdout.strip().splitlines():
        pid, _, mib = ln.partition(",")
        if pid.strip().isdigit():
            apps[int(pid)] = float(mib.strip() or 0)
    return apps


def kernel_cache_counts(port: int) -> dict:
    """outcome -> count of the "kernels" cache in a replica's /metrics."""
    import re

    counts = {"hit": 0, "miss": 0}
    for ln in metrics_text(port).splitlines():
        m = re.match(r"\w*cache_requests_total\{([^}]*)\}\s+(\S+)", ln)
        if not m:
            continue
        labels = dict(re.findall(r'(\w+)="([^"]*)"', m.group(1)))
        if labels.get("cache") == "kernels":
            counts[labels.get("outcome", "")] = float(m.group(2))
    return counts


def _post(port: int, body: bytes, headers=None) -> tuple:
    """One plain-HTTP admission -> (status, headers, body, ms)."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        t0 = time.perf_counter()
        conn.request("POST", "/v1/admit", body=body, headers={
            "Content-Type": "application/json", **(headers or {})})
        resp = conn.getresponse()
        data = resp.read()
        return resp.status, dict(resp.getheaders()), data, (
            time.perf_counter() - t0) * 1e3
    finally:
        conn.close()


def _check_fleet_answer(uid: str, data: bytes, sig) -> bool:
    """A replica's or a door's body for request ``uid`` equal to phase
    3's results ``sig`` for its pod -> denied."""
    resp = json.loads(data)["response"]
    allowed, msg = expected_response(sig)
    status = resp.get("status") or {}
    if resp.get("uid") != uid or resp["allowed"] != allowed or \
            status.get("message") != msg or \
            (not allowed and status.get("code") != 403):
        raise AssertionError(f"{uid}: {resp} is not phase 3's "
                             f"({allowed}, {msg!r})")
    return not allowed


def fleet_requests(pods, batch) -> tuple:
    """Phase 3's 256 pods and its batch pods as admission bodies -> (the
    pods', the batch's): the same bytes for every replica and door."""
    return ([_admission(f"fleet-{i}", p) for i, p in enumerate(pods)],
            [_admission(f"fleet-batch-{i}", p) for i, p in enumerate(batch)])


def fleet_fresh(client, n: int, seed: int, tag: str, batch: bool = False):
    """``n`` pods no replica has seen as admission bodies, with phase 3's
    client's results for them -> (bodies, results)."""
    pods = fresh_pods(n, seed, tag)
    uid = "fleet-batch-{}" if batch else "fleet-{}"
    return ([_admission(uid.format(i), p) for i, p in enumerate(pods)],
            results_of(client, pods))


def fleet_pass(port: int, label: str, bodies, sigs, smi: str) -> tuple:
    """The bodies one at a time to ``port`` -> (their answers, denials);
    each answer equal to phase 3's; p50 and p99 logged."""
    out, lat, denied, rids = [], [], 0, {}
    for i, body in enumerate(bodies):
        st, hd, data, ms = _post(port, body)
        if st != 200:
            raise AssertionError(f"{label} {i}: HTTP {st}: {data[:200]!r}")
        denied += _check_fleet_answer(f"fleet-{i}", data, sigs[i])
        rid = hd.get("X-GK-Replica")
        rids[rid] = rids.get(rid, 0) + 1
        out.append(data)
        lat.append(ms)
    log("fleet_requests", path=label, n=len(lat),
        p50_ms=statistics.median(lat), p99_ms=percentile(lat, 99),
        max_ms=max(lat), denied=denied, replicas=rids, card=smi)
    return out, denied


def fleet_burst(port: int, label: str, bodies, sigs, smi: str) -> dict:
    """PROCESS_BURST's clients, each its requests one at a time on its
    own connections, to ``port`` -> the answers by index."""
    import threading

    n_threads, each = PROCESS_BURST
    got, errors, lat = {}, [], []

    def client_thread(t):
        try:
            for j in range(each):
                i = t * each + j
                st, _hd, data, ms = _post(port, bodies[i])
                if st != 200:
                    raise AssertionError(f"HTTP {st}")
                _check_fleet_answer(f"fleet-batch-{i}", data, sigs[i])
                got[i] = data
                lat.append(ms)
        except Exception as e:  # surfaced below
            errors.append(repr(e))

    threads = [threading.Thread(target=client_thread, args=(t,))
               for t in range(n_threads)]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    wall = time.perf_counter() - t0
    if errors:
        raise AssertionError(f"{label} burst: {errors[:3]}")
    log("fleet_burst", path=label, clients=n_threads, requests=len(got),
        seconds=wall, requests_per_s=len(got) / wall,
        p50_ms=statistics.median(lat), p99_ms=percentile(lat, 99),
        max_ms=max(lat), card=smi)
    return got


def fleet_stream(handles, smi: str) -> dict:
    """The stream command on one replica alone, then on every replica at
    once -> their replies."""
    import threading

    n, chunk = FLEET_STREAM
    cmd = {"cmd": "stream", "n": n, "chunk": chunk}
    alone = handles[0].command(cmd, timeout_s=FLEET_SPAWN_S)
    replies, errors = {}, []

    def one(h):
        try:
            replies[h.replica_id] = h.command(cmd, timeout_s=FLEET_SPAWN_S)
        except Exception as e:  # surfaced below
            errors.append(repr(e))

    threads = [threading.Thread(target=one, args=(h,)) for h in handles]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    if errors:
        raise AssertionError(f"the stream failed: {errors}")
    t0 = max(r["t0_wall"] for r in replies.values())
    t1 = min(r["t1_wall"] for r in replies.values())
    first = min(r["t0_wall"] for r in replies.values())
    last = max(r["t1_wall"] for r in replies.values())
    total = sum(r["n"] for r in replies.values())
    log("fleet_stream", n=n, chunk=chunk,
        alone={"replica": alone["replica_id"], "s": alone["s"],
               "reviews_per_s": alone["reviews_per_s"]},
        together={rid: {"s": r["s"], "reviews_per_s": r["reviews_per_s"]}
                  for rid, r in sorted(replies.items())},
        together_sum_reviews_per_s=sum(r["reviews_per_s"]
                                       for r in replies.values()),
        overlap_s=t1 - t0, span_s=last - first,
        together_reviews_per_s_over_span=total / (last - first),
        card=smi)
    return {"alone": alone, "together": replies}


def fleet_kernels(client, smi: str) -> Capture:
    """One review_batch of the stream's chunk of stored pods through phase
    3's client, recorded -> its Capture, for holding K1, K9 and K10
    against their plain versions at the shape the replicas' stream gives
    them (the replicas' own launches are counted in their processes)."""
    from gatekeeper_tpu_torch.fleet.replica import _stream_requests

    gdev = _dev()
    n, chunk = FLEET_STREAM
    reqs = _stream_requests(types.SimpleNamespace(client=client), k=chunk)
    if len(reqs) != chunk:
        raise AssertionError(f"{len(reqs)} stored pods for a chunk of "
                             f"{chunk}")
    gdev.reset_launches()
    with Capture(names=("match", "program_pack", "packbits")) as cap:
        t0 = time.perf_counter()
        client.driver.review_batch(reqs)
        wall = time.perf_counter() - t0
    got = {k: v for k, v in gdev.launches.items() if v}
    if got != FLEET_KERNELS:
        raise AssertionError(f"a review_batch of {chunk} launched {got}, "
                             f"not {FLEET_KERNELS}")
    log("fleet_parent_batch", reviews=chunk, seconds=wall, launches=got,
        card=smi)
    return cap


def _joined(door_port: int, trace_id: str, wait_s: float):
    """The door's /debug/fleet-traces entry for ``trace_id`` once it
    holds a replica's half -> (the entry or None, the last payload)."""
    import urllib.request

    payload = {}
    deadline = time.perf_counter() + wait_s
    while time.perf_counter() < deadline:
        with urllib.request.urlopen(
                f"http://127.0.0.1:{door_port}/debug/fleet-traces",
                timeout=120) as r:
            payload = json.loads(r.read())
        entry = next((t for t in payload["traces"]
                      if t["trace_id"] == trace_id
                      and len(t["processes"]) > 1), None)
        if entry is not None:
            return entry, payload
        time.sleep(0.5)
    return None, payload


def fleet_trace(door_port: int, collector_targets, live, body: bytes,
                watch, smi: str) -> dict:
    """One admission through the door with a caller's traceparent, then
    the door's /debug/fleet-traces -> the joined trace's stages.  The
    first trace that does not join within FLEET_TRACE_WAIT_S fails the
    phase, with what each side held: the door's wire spans (a retry onto
    another replica shows as a second proxy_connect), the replicas the
    collector could not fetch, whether the replica's tracer kept the
    trace (its watch), the replicas' brownout levels and this process's
    collector pauses in the wait.  Every live replica must report
    brownout level 0 with no edge alert firing (its ladder is on; at
    level 2 its tracer would keep 5% of traces)."""
    from gatekeeper_tpu_torch.fleet.frontdoor import WIRE_STAGES
    from gatekeeper_tpu_torch.obs import trace as obstrace
    from gatekeeper_tpu_torch.obs.fleetobs import TraceCollector

    collector = TraceCollector(collector_targets, timeout_s=10.0).install()
    watch.stalls("the trace", [(h, watch_replica(h)) for h in live], smi)
    calm = {h.replica_id: calm_of(replica_status(h)) for h in live}
    levels = {rid: c["level"] for rid, c in calm.items()}
    if any(c["level"] or c["edge_alerts"] for c in calm.values()):
        raise AssertionError(f"a replica browned out or its edge "
                             f"objective alerts: {calm}")
    pauses = GcPauses()
    gc.callbacks.append(pauses)
    try:
        t0 = time.perf_counter()
        st, hd, _data, _ms = _post(door_port, body, {
            "traceparent": f"00-{FLEET_TRACE_ID}-00f067aa0ba902b7-01"})
        if st != 200 or hd.get("X-GK-Trace-Id") != FLEET_TRACE_ID:
            raise AssertionError(f"the traced request: {st}, {hd}")
        rid = hd["X-GK-Replica"]
        entry, payload = _joined(door_port, FLEET_TRACE_ID,
                                 FLEET_TRACE_WAIT_S)
        wait_s = time.perf_counter() - t0
    finally:
        gc.callbacks.remove(pauses)
    kept = {h.replica_id: watch_replica(h)["traced"] for h in live}
    if entry is None:
        wire = [t for t in collector.tracer.traces()
                if t["trace_id"] == FLEET_TRACE_ID]
        raise AssertionError(
            f"the replica half of trace {FLEET_TRACE_ID} (answered by "
            f"{rid}) never joined the door's: door spans "
            f"{[(s['name'], s.get('attrs')) for t in wire for s in t['spans']]}"
            f", failed fetches {payload.get('failed_replicas')}, the "
            f"replicas' tracers {kept}, brownout levels {levels}, "
            f"this process's collector pauses {pauses.take()}")

    def stages(process):
        return {(s.get("attrs") or {}).get("stage") for s in entry["spans"]
                if s.get("process") == process} - {None}

    door, replica = stages("frontdoor"), stages(rid)
    dispatch = [s for s in entry["spans"] if s.get("process") == rid
                and s["name"] == "tpu.dispatch"]
    if not door or not door <= set(WIRE_STAGES) or \
            not {obstrace.PACK, obstrace.DISPATCH} <= replica or \
            not dispatch or dispatch[0]["attrs"].get("tier") != "torch" or \
            [k["held"] for k in kept[rid]] != [True]:
        raise AssertionError(f"the joined trace: door {door}, replica "
                             f"{replica}, dispatch {dispatch}, the "
                             f"replica's tracer {kept[rid]}")
    out = {"replica": rid, "door_stages": sorted(door),
           "replica_stages": sorted(replica), "joined_s": wait_s,
           "brownout_levels": levels,
           "gc": pauses.take(),
           "dispatch_ms": dispatch[0]["duration_ms"],
           "dispatch_rows": dispatch[0]["attrs"].get("rows"), "card": smi}
    log("fleet_trace", **out)
    return out


def fleet_phase(args, client, pods, review_sigs, batch, batch_sigs,
                process, smi: str):
    """Phase 12: three webhook replicas (python -m
    gatekeeper_tpu_torch.fleet.replica, --driver torch on the card)
    restore phase 10's snapshot and load phase 11's sealed kernels ->
    (the replicas' launches, each counted in its own process: every
    replica's last watch, the killed one's before its kill; the Capture
    of the parent's review at the stream's shape)."""
    import signal

    import torch

    from gatekeeper_tpu_torch.fleet import (EventFrontDoor, FrontDoor,
                                            ReplicaSupervisor, spawn_fleet)

    snap_dir = os.path.join(ROOT, "build", "process_snapshots")
    cache_dir = os.path.join(ROOT, "build", "restart_kernel_cache")
    # what the replicas inherit: the card they may see, and whether a
    # seal key is set (never its value)
    log("fleet_env", cuda_visible_devices=os.environ.get(
        "CUDA_VISIBLE_DEVICES"), seal_key_set=bool(os.environ.get(
            "GK_SEAL_KEY")))
    gdev = _dev()
    n_sealed = len(gdev.KERNEL_NAMES)
    bodies, batch_bodies = fleet_requests(pods, batch)
    # every pass that measures the device path sends pods its replicas
    # have not seen (a repeat replays from the request memo): the doors'
    # one-at-a-time passes and the event door's burst get pods of their
    # own, their answers from phase 3's client; the repeats are a pass
    # of their own
    fresh = {label: fleet_fresh(client, len(pods), SEED + seed, label)
             for label, seed in (("frontdoor", 92), ("evdoor", 91))}
    fresh["evdoor_burst"] = fleet_fresh(client, len(batch), SEED + 90,
                                        "evdoor-burst", batch=True)
    trace_body = fleet_fresh(client, 1, SEED + 89, "fleet-trace")[0][0]
    watch = WatchedSpawns()
    # the doors and the trace collector run in this process, which holds
    # phases 3-11's clients (5.6M objects; one full collection took 5.1 s
    # beside an NVIDIA H100), where a door's own process holds none of
    # them: frozen, they are out of the collector's generations while it
    # drives the fleet
    t0 = time.perf_counter()
    gc.collect()
    gc.freeze()
    log("fleet_gc_freeze", full_collection_ms=(time.perf_counter() - t0)
        * 1e3, frozen_objects=gc.get_freeze_count())
    handles, doors, sup, respawn, pids = [], [], None, None, []
    watched = {}  # pid -> the replica's last watch
    torch.cuda.synchronize()
    free0, total = torch.cuda.mem_get_info()
    apps0 = compute_apps()
    try:
        with watch:
            t0 = time.perf_counter()
            handles = spawn_fleet(FLEET_REPLICAS, snapshot_dir=snap_dir,
                                  cache_dir=cache_dir,
                                  extra_flags=FLEET_FLAGS,
                                  timeout_s=FLEET_SPAWN_S, sequential=False)
            spawn_wall = time.perf_counter() - t0
            pids = [h.proc.pid for h in handles]
            free1, _ = torch.cuda.mem_get_info()
            apps = compute_apps()
            # nvidia-smi lists this process's pid unless the card's
            # processes live in another pid namespace: then each replica
            # says where its driver runs and what its allocator holds
            visible = os.getpid() in apps0 or os.getpid() in apps
            ready = []
            for h in handles:
                if h.ready["restore_outcome"] != "restored" or \
                        h.ready["templates"] != args.templates:
                    raise AssertionError(f"replica {h.replica_id}: "
                                         f"{h.ready}")
                cache = kernel_cache_counts(h.metrics_port)
                if cache != {"hit": n_sealed, "miss": 0}:
                    raise AssertionError(f"replica {h.replica_id} built "
                                         f"kernels: {cache}")
                if visible and h.proc.pid not in apps:
                    raise AssertionError(f"replica {h.replica_id} (pid "
                                         f"{h.proc.pid}) is not on the "
                                         f"card: {apps}")
                # its background calibration, before any counted traffic
                t_cal = time.perf_counter()
                watched[h.proc.pid] = await_replica_calibration(h)
                card = check_on_card(h, watched[h.proc.pid])
                card["calibration_wait_s"] = time.perf_counter() - t_cal
                ready.append({"replica": h.replica_id, "pid": h.proc.pid,
                              "spawn_s": h.spawn_s, "ready_s": h.ready_s,
                              "device_mib": apps.get(h.proc.pid),
                              "kernel_cache": cache,
                              "namespaces_seeded":
                                  h.ready["namespaces_seeded"], **card})
            # every replica's context beside what its allocator reserves
            taken = (free0 - free1) / 2**20
            need = sum(r["reserved_mib"] for r in ready) + \
                FLEET_REPLICAS * FLEET_CONTEXT_MIB
            if taken < need:
                raise AssertionError(f"the replicas took {taken} MiB of the "
                                     f"card, less than {need}")
            watch.stalls("calibrated", [(h, watched[h.proc.pid])
                                        for h in handles], smi)
            log("fleet_ready", replicas=ready, spawn_wall_s=spawn_wall,
                sequential=False, pids_visible=visible,
                compute_apps_before=apps0, compute_apps_after=apps,
                device_mib_taken=taken, device_mib_least=need,
                device_mib_total=total / 2**20,
                cold_ready_s=process["ready_s"],
                warm_ready_s=process.get("warm_ready_s"), card=smi)

            # phase 3's pods to every replica: every body the same bytes,
            # each equal to phase 3's results; then the same pods to r0
            # again, each a request-memo hit, the same bytes; then pods
            # of their own through each door, each equal to phase 3's
            want, denied = fleet_pass(handles[0].port, "r0", bodies,
                                      review_sigs, smi)
            for h in handles[1:]:
                got, _ = fleet_pass(h.port, h.replica_id, bodies,
                                    review_sigs, smi)
                if got != want:
                    raise AssertionError(f"{h.replica_id}'s bodies differ")
            got, _ = fleet_pass(handles[0].port, "r0_repeated", bodies,
                                review_sigs, smi)
            if got != want:
                raise AssertionError("r0's repeated bodies differ")
            threaded = FrontDoor([h.backend() for h in handles]).start()
            doors.append(threaded)
            evdoor = EventFrontDoor([h.wire_backend()
                                     for h in handles]).start()
            doors.append(evdoor)
            for door, label in ((threaded, "frontdoor"),
                                (evdoor, "evdoor")):
                fleet_pass(door.port, label, *fresh[label], smi)
            for door, label, (b_bodies, b_sigs) in (
                    (threaded, "frontdoor", (batch_bodies, batch_sigs)),
                    (evdoor, "evdoor", fresh["evdoor_burst"])):
                fleet_burst(door.port, label, b_bodies, b_sigs, smi)

            # the stream command: one replica alone, then all at once;
            # then each replica's launches, counted in its process (the
            # one killed below included)
            fleet_stream(handles, smi)
            for h in handles:
                watched[h.proc.pid] = watch_replica(h)
            watch.stalls("after the stream", [(h, watched[h.proc.pid])
                                              for h in handles], smi)
            counted = {}
            for i, h in enumerate(handles):
                counted[h.replica_id] = check_replica_launches(
                    h, watched[h.proc.pid], streams=2 if i == 0 else 1)
            log("fleet_launches", at="after the stream", replicas=counted,
                card=smi)

            # self-heal: SIGKILL one replica under the supervisor
            sup = ReplicaSupervisor(snapshot_dir=snap_dir,
                                    cache_dir=cache_dir,
                                    extra_flags=FLEET_FLAGS,
                                    spawn_timeout_s=FLEET_SPAWN_S,
                                    probe_timeout_s=2.0, miss_threshold=3)
            for h in handles:
                sup.adopt(h)
            sup.start_monitor()
            victim = handles[1]
            free_a, _ = torch.cuda.mem_get_info()
            t0 = time.perf_counter()
            os.killpg(victim.proc.pid, signal.SIGKILL)
            # what one replica held: freed with its context, seconds
            # before its respawn can take a context again
            time.sleep(2.0)
            freed_mib = (torch.cuda.mem_get_info()[0] - free_a) / 2**20
            deadline = t0 + FLEET_SPAWN_S
            while time.perf_counter() < deadline:
                st = sup.status()[victim.replica_id]
                if st["restarts"] and st["state"] == "running":
                    break
                time.sleep(0.1)
            back_s = time.perf_counter() - t0
            status = sup.status()
            others = {rid: s["restarts"] for rid, s in status.items()
                      if rid != victim.replica_id}
            if status[victim.replica_id]["restarts"] != 1 or any(
                    others.values()):
                raise AssertionError(f"the respawns: {status}")
            respawn = next(h for h in sup.handles()
                           if h.replica_id == victim.replica_id)
            pids.append(respawn.proc.pid)
            cache = kernel_cache_counts(respawn.metrics_port)
            if respawn.ready["restore_outcome"] != "restored" or \
                    cache != {"hit": n_sealed, "miss": 0}:
                raise AssertionError(f"the respawn: {respawn.ready}, "
                                     f"{cache}")
            watched[respawn.proc.pid] = await_replica_calibration(respawn)
            fresh_card = check_on_card(respawn, watched[respawn.proc.pid])
            calm = await_calm(respawn, watch.ready_wall(respawn))
            watch.stalls("respawned", [(respawn,
                                        watch_replica(respawn))], smi)
            got, _ = fleet_pass(respawn.port, "respawned", bodies,
                                review_sigs, smi)
            if got != want:
                raise AssertionError("the respawned replica's bodies differ")
            drained = sup.drain(handles[2].replica_id, deadline_ms=2000.0)
            if drained.get("event") != "drained":
                raise AssertionError(f"the drain: {drained}")
            log("fleet_self_heal", replica=victim.replica_id,
                killed_to_running_s=back_s, device_mib_freed=freed_mib,
                last_restart_s=status[victim.replica_id]["last_restart_s"],
                ready_s=respawn.ready_s, spawn_s=respawn.spawn_s,
                respawned=fresh_card, calm=calm, restarts=status,
                drain=drained, card=smi)

            # one trace across the hop, through a door over the live
            # replicas (the drained one answers no admission)
            live = [h for h in sup.handles()
                    if h.replica_id != handles[2].replica_id]
            door = FrontDoor([h.backend() for h in live],
                             probe_interval_s=3600.0).start()
            doors.append(door)
            fleet_trace(door.port, sup.trace_targets, live, trace_body,
                        watch, smi)
            if {rid: s["restarts"] for rid, s in sup.status().items()
                    if rid != victim.replica_id} != others:
                raise AssertionError(f"a respawn the phase did not cause: "
                                     f"{sup.status()}")

            # every live replica's launches at the end, and no divert
            for h in sup.handles():
                watched[h.proc.pid] = watch_replica(h)
            # each replica's heartbeats over 50 ms since its ready line
            # (the killed one's to its last watch), a line each
            ends = watch.stalls("the end", [
                (h, watched[h.proc.pid]) for h in [victim] + sup.handles()],
                smi)
            for end in ends.values():
                log("fleet_stall_count", replica=end["replica"],
                    pid=end["pid"], over_50ms=end["over_50ms"],
                    heartbeats=end["heartbeats"], causes=end["causes"],
                    card=smi)
            counted = {}
            for h in sup.handles():
                streams = 0 if h is respawn else 2 if h is handles[0] \
                    else 1
                counted[h.replica_id] = check_replica_launches(
                    h, watched[h.proc.pid], streams)
                if replica_diverts(h.metrics_port):
                    raise AssertionError(
                        f"replica {h.replica_id} diverted batches: "
                        f"{replica_diverts(h.metrics_port)}")
            log("fleet_launches", at="the end", replicas=counted, card=smi)
    finally:
        for door in doors:
            door.stop()
        if sup is not None:
            sup.stop()
        for h in handles:
            h.stop()
        gc.unfreeze()
    # the replicas' contexts leave the card: their pids leave nvidia-smi's
    # list, and the device memory they took is free again (this process
    # allocated none since free0)
    deadline = time.perf_counter() + 30
    while True:
        apps = compute_apps()
        free2, _ = torch.cuda.mem_get_info()
        left = [p for p in apps if p in pids]
        held_mib = (free0 - free2) / 2**20
        if not left and held_mib < 256 or time.perf_counter() > deadline:
            break
        time.sleep(0.5)
    if held_mib >= 256:
        raise AssertionError(f"{held_mib} MiB of the card still taken "
                             f"after the replicas stopped")
    alive = []
    for pid in pids:
        try:
            os.kill(pid, 0)
            alive.append(pid)
        except ProcessLookupError:
            pass
    if left or alive:
        raise AssertionError(f"replicas left: on the card {left}, alive "
                             f"{alive}")
    launches = dict.fromkeys(gdev.LAUNCHERS, 0)
    for w in watched.values():
        for k, v in w["launches"].items():
            launches[k] += v
    log("fleet_stopped", pids=pids, compute_apps=apps,
        device_mib_still_taken=held_mib, launches=launches,
        gc_before_ready={f"{h.replica_id}:{h.proc.pid}":
                         watch.pauses(h, watched[h.proc.pid])
                         for h in handles + [respawn]}, card=smi)
    return launches, fleet_kernels(client, smi)



# ---- phase 13: the serving seam (the breaker, the memos, the model) ---------

# batch sizes whose predicted_batch_ms is printed beside measured
# review_batch walls of fresh pods, and the walls measured at each
SEAM_PREDICT = (1, 8, 64)
SEAM_WALLS = 8
# the flagged shares of those pods: the stored corpus's (the content the
# calibration times) and phase 3's admissions'
SEAM_RATES = (0.05, 0.5)
# one-pod reviews of the memo's pass (misses, then hits)
SEAM_MEMO_PODS = 64
# one-pod reviews of the breaker's pass: the failed ones (the breaker's
# threshold), those while it is open, and one after it closed
SEAM_BREAKER_OPEN = 4
# the breaker's cooldown and probe interval in the phase (5 s by
# default), and the longest its probe may take to close it
SEAM_PROBE_S = 0.5
SEAM_CLOSE_WAIT_S = 60


def made_by(fn):
    """Call ``fn`` -> (its result, its wall ms, the launches it made)."""
    launches = _dev().launches
    before = dict(launches)
    t0 = time.perf_counter()
    out = fn()
    ms = (time.perf_counter() - t0) * 1e3
    return out, ms, {k: v - before[k] for k, v in launches.items()
                     if v != before[k]}


def tier_ms(driver, n: int) -> dict:
    """Each tier's predicted ms for a batch of ``n`` reviews of every
    installed constraint, from the calibrated affine models."""
    per_review = max(driver._n_constraints_total(), 1)
    return {tier: floor + n * per for tier, floor, per
            in driver._tier_models(per_review)}


def review_launches(n: int) -> dict:
    """The launches of one evaluation of ``n`` reviews: K1 and K9 packing,
    or past PACK_IN_K9_MAX_ROWS rows K1, K9 and K10."""
    from gatekeeper_tpu_torch.ops import program
    from gatekeeper_tpu_torch.ops.pack import _bucket

    if _bucket(n, 8) <= program.PACK_IN_K9_MAX_ROWS:
        return {"match": 1, "program_pack": 1}
    return {"match": 1, "program": 1, "packbits": 1}


def serving_phase(client, driver, smi: str) -> dict:
    """Phase 13 on phase 3's client -> the launches of its run.  The
    calibration (its model, its wall and its launches) and its prediction
    beside measured walls; the request memo (misses, hits, a real
    constraint change); the breaker under injected dispatch errors (the
    fault plane's TPU_DISPATCH, Python exceptions raised before any
    launch, so the card's context stays sound)."""
    import copy

    from gatekeeper_tpu_torch import faults
    from gatekeeper_tpu_torch.faults import FaultRule

    gdev = _dev()
    gdev.reset_launches()
    check_no_divert("before the serving seam", driver)

    def one(pod):
        """One review of a copy of ``pod`` -> (its bytes, ms, launches)."""
        out, ms, made = made_by(lambda: client.review(copy.deepcopy(pod)))
        return _review_bytes([out])[0], ms, made

    # the calibration: its model, wall and launches, then its prediction
    # beside review_batch walls of fresh pods
    cal, cal_ms, made = made_by(driver.calibrate_routing)
    if made != calibration_launches() or cal is None:
        raise AssertionError(f"the calibration launched {made}: {cal}")
    model = []
    for rate, n in ((r, n) for r in SEAM_RATES for n in SEAM_PREDICT):
        pods = fresh_pods(n * SEAM_WALLS, SEED + 80 + n,
                          f"seam-wall-{rate}-{n}", rate)
        walls = []
        for j in range(SEAM_WALLS):
            batch = copy.deepcopy(pods[j * n:(j + 1) * n])
            _out, ms, made = made_by(lambda: client.review_batch(batch))
            if made != review_launches(n):
                raise AssertionError(f"a review_batch of {n} fresh pods "
                                     f"launched {made}")
            walls.append(ms)
        # the device tier's prediction: these batches are forced onto it
        predicted = tier_ms(driver, n)["device"]
        model.append({"rate": rate, "reviews": n, "predicted_ms": predicted,
                      "p50_ms": statistics.median(walls),
                      "ratio": predicted / statistics.median(walls),
                      "min_ms": min(walls), "max_ms": max(walls)})
    log("serving_calibration", model=cal, wall_ms=cal_ms,
        launches=calibration_launches(), predicted_vs_measured=model,
        card=smi)

    # the memo: fresh pods one at a time (each a miss, K1 and K9 once),
    # the same pods again (each a hit: no launch, the same bytes)
    pods = fresh_pods(SEAM_MEMO_PODS, SEED + 70, "seam-memo")
    first, miss_lat, hit_lat = [], [], []
    for pod in pods:
        got, ms, made = one(pod)
        if made != review_launches(1):
            raise AssertionError(f"a memo miss launched {made}")
        first.append(got)
        miss_lat.append(ms)
    for i, pod in enumerate(pods):
        got, ms, made = one(pod)
        if made or got != first[i]:
            raise AssertionError(f"a memo hit launched {made} or answered "
                                 f"otherwise")
        hit_lat.append(ms)
    # a real constraint change (the enforcement action of a constraint
    # that flagged these pods): each stored entry misses at its epoch and
    # is repaired, the changed constraint evaluated again on the host;
    # the repaired answers equal the card's after the memos are emptied
    kind, name = next(json.loads(b)[:2] for sig in first for b in sig
                      if json.loads(b)[3] == "deny")
    stored = driver.constraints[kind][name]
    changed = copy.deepcopy(stored)
    changed["spec"]["enforcementAction"] = "dryrun"
    client.add_constraint(changed)
    repaired_keys = []
    eval_one = driver._eval_one_key
    driver._eval_one_key = lambda k, n_, *a, **kw: (
        repaired_keys.append((k, n_)) or eval_one(k, n_, *a, **kw))
    try:
        repaired = [one(pod) for pod in pods]
    finally:
        del driver._eval_one_key
    forget_reviews(driver)
    evaluated = [one(pod) for pod in pods]
    client.add_constraint(copy.deepcopy(stored))
    if any(made for _b, _ms, made in repaired) or \
            set(repaired_keys) != {(kind, name)} or \
            len(repaired_keys) != len(pods) or \
            [b for b, _ms, _m in repaired] != [b for b, _ms, _m in evaluated] \
            or [b for b, _ms, _m in repaired] == first or \
            any(m != review_launches(1) for _b, _ms, m in evaluated):
        raise AssertionError(f"the memo after a change of {kind}/{name}: "
                             f"repaired {len(repaired_keys)} entries")
    log("serving_memo", pods=len(pods),
        miss_p50_ms=statistics.median(miss_lat),
        miss_p99_ms=percentile(miss_lat, 99),
        hit_p50_ms=statistics.median(hit_lat),
        hit_p99_ms=percentile(hit_lat, 99),
        changed=f"{kind}/{name}", repaired=len(repaired_keys),
        repaired_p50_ms=statistics.median(ms for _b, ms, _m in repaired),
        changed_answers=sum(b != f for (b, _ms, _m), f
                            in zip(repaired, first)), card=smi)

    # the breaker: its answers with the breaker closed, then the same pods
    # (the memos emptied) under injected dispatch errors
    br = driver.breaker
    br.cooldown_s = br.probe_interval_s = SEAM_PROBE_S
    n_fail = br.failure_threshold
    pods = fresh_pods(n_fail + SEAM_BREAKER_OPEN + 1, SEED + 60,
                      "seam-breaker")
    closed = [one(pod)[0] for pod in pods]
    forget_reviews(driver)
    plane = faults.install(seed=SEED)
    try:
        plane.add(faults.TPU_DISPATCH, FaultRule(mode="error"))
        t_inject = time.perf_counter()
        failed = [one(pod) for pod in pods[:n_fail]]
        open_s = time.perf_counter() - t_inject
        state_after = br.state
        diverted = [one(pod) for pod in pods[n_fail:-1]]
        counts = diverts()
        before = dict(gdev.launches)
        plane.clear(faults.TPU_DISPATCH)
        t_clear = time.perf_counter()
        while br.state != "closed":
            if time.perf_counter() - t_clear > SEAM_CLOSE_WAIT_S:
                raise AssertionError(f"the probe never closed the breaker: "
                                     f"{br.status()}")
            time.sleep(0.01)
        closed_s = time.perf_counter() - t_clear
        probe = {k: v - before[k] for k, v in gdev.launches.items()
                 if v != before[k]}
    finally:
        faults.uninstall()
    after = one(pods[-1])
    answers = [b for b, _ms, _m in failed + diverted] + [after[0]]
    want_counts = {"np|device_failed": n_fail,
                   "np|breaker_open": len(diverted)}
    if state_after != "open" or answers != closed or \
            any(m for _b, _ms, m in failed + diverted) or \
            counts != want_counts or probe != review_launches(1) or \
            after[2] != review_launches(1):
        raise AssertionError(
            f"the breaker: {state_after} after {n_fail} failures, answers "
            f"equal {answers == closed}, diverts {counts} (want "
            f"{want_counts}), launches while failing "
            f"{[m for _b, _ms, m in failed + diverted]}, the probe's "
            f"{probe}, after {after[2]}")
    log("serving_breaker", threshold=n_fail, inject_to_open_s=open_s,
        clear_to_closed_s=closed_s, diverts=counts,
        diverted_p50_ms=statistics.median(ms for _b, ms, _m in diverted),
        probe_launches=probe, after_launches=after[2],
        status=br.status(), card=smi)
    return dict(gdev.launches)


# ---- phase 14: the wire (the App against a real HTTP API server) -----------

# pods the child API server stores: a cut of phase 10's ~100,000 (App B's
# streamed audit renders every flagged cell through review_batch, the
# Apps ingest every pod over HTTP, and the phase shares the run's 1,200 s)
WIRE_PODS = 2_500
# App B's audit page (--audit-chunk-size)
WIRE_CHUNK = 500
# the longest the child may take to seed its store and listen
WIRE_SERVER_START_S = 300
# the kernels the phase's two Apps must launch: admissions (K1, K9's
# review mode), App A's full sweeps (K9, K4), App B's streamed audit
# batches of DEFAULT_REVIEW_BATCH reviews (K9 then K10)
WIRE_KERNELS = ("match", "program", "program_pack", "reduction", "packbits")
# the stage spans each of App A's full cycles must carry
WIRE_SPANS = ("audit.pack", "audit.dispatch", "audit.fetch", "audit.render")
# span and stat durations agree to the spans' rounding (0.0001 ms)
WIRE_SPAN_TOL_MS = 0.01
# the replay of App A's decision log (tools/replay_decisions_torch.py, in
# child processes on the card): its limit, and the tiers a replayed
# batch may take on the card (the device; price_host_tiers is off there)
REPLAY_TOOL = os.path.join("tools", "replay_decisions_torch.py")
REPLAY_TIMEOUT_S = 600

# the child API server: argv root, templates, pods, seed.  It seeds its
# store in its own process (the CRDs of deploy/gatekeeper.yaml, each
# template's constraint CRD as the template controller writes it, the
# namespaces, a Config that syncs Pods, the templates, their constraints,
# the pods), serves it, prints one JSON line, and stops when its stdin
# closes
WIRE_SERVER = r"""
import json, os, sys, time
t0 = time.perf_counter()
root = sys.argv[1]
n_templates, n_pods, seed = (int(a) for a in sys.argv[2:5])
sys.path.insert(0, root)
import yaml
from gatekeeper_tpu_torch.apis.templates import ConstraintTemplate
from gatekeeper_tpu_torch.client.crd import synthesize_crd
from gatekeeper_tpu_torch.kube.apiserver import KubeApiServer
from gatekeeper_tpu_torch.kube.inmem import InMemoryKube
from gatekeeper_tpu_torch.target.target import K8sValidationTarget
from gatekeeper_tpu_torch.util import synthetic as syn

kube = InMemoryKube()
with open(os.path.join(root, "deploy", "gatekeeper.yaml")) as f:
    for doc in yaml.safe_load_all(f):
        if doc and doc.get("kind") == "CustomResourceDefinition":
            kube.create(doc)
templates, constraints = syn.make_templates(n_templates, seed)
pods = syn.make_pods(n_pods, seed + 1)
match = K8sValidationTarget().match_schema()
for ns in sorted({p["metadata"]["namespace"] for p in pods}
                 | {"gatekeeper-system"}):
    kube.create({"apiVersion": "v1", "kind": "Namespace",
                 "metadata": {"name": ns}})
# Namespaces synced too: App A's snapshot then holds the namespace cache
# its admissions read, which the replay of its decision log restores
kube.create({
    "apiVersion": "config.gatekeeper.sh/v1alpha1", "kind": "Config",
    "metadata": {"name": "config", "namespace": "gatekeeper-system"},
    "spec": {"sync": {"syncOnly": [
        {"group": "", "version": "v1", "kind": "Pod"},
        {"group": "", "version": "v1", "kind": "Namespace"}]}},
})
for t in templates:
    kube.create(t)
    tmpl = ConstraintTemplate.from_dict(t)
    crd = synthesize_crd(tmpl.kind, tmpl.validation_schema, match)
    crd["status"] = {"conditions": [{"type": "Established",
                                     "status": "True"}]}
    kube.create(crd)
for obj in constraints + pods:
    kube.create(obj)
seeded = time.perf_counter() - t0
srv = KubeApiServer(kube=kube)
srv.start()
# a real API server sends without Nagle's delay (Go sets TCP_NODELAY on
# every connection); the stand-in's handler writes a response's headers
# and body apart, which a delayed ACK holds ~40 ms a request without it
import socket
httpd = srv._httpd
accept = httpd.get_request

def get_request():
    sock, addr = accept()
    sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    return sock, addr

httpd.get_request = get_request
print(json.dumps({"url": srv.url, "seed_s": seeded, "pods": len(pods),
                  "templates": len(templates)}), flush=True)
sys.stdin.read()
srv.stop()
"""


class WireServer:
    """The child API server of phase 14, stopped on every way out of the
    ``with``: its stdin closed, then killed if it has not ended."""

    def __init__(self, n_templates: int, n_pods: int):
        self.args = [sys.executable, "-c", WIRE_SERVER, ROOT,
                     str(n_templates), str(n_pods), str(SEED)]
        self.proc = None
        self.ready = None

    def __enter__(self) -> "WireServer":
        import selectors

        os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
        self.err = open(os.path.join(ROOT, "build", "wire_server.log"), "w")
        t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            self.args, cwd=ROOT, stdin=subprocess.PIPE,
            stdout=subprocess.PIPE, stderr=self.err, text=True)
        sel = selectors.DefaultSelector()
        sel.register(self.proc.stdout, selectors.EVENT_READ)
        try:
            if not sel.select(timeout=WIRE_SERVER_START_S):
                raise AssertionError(f"the API server did not listen within "
                                     f"{WIRE_SERVER_START_S} s")
            line = self.proc.stdout.readline()
        finally:
            sel.close()
        if not line:
            raise AssertionError(f"the API server exited "
                                 f"{self.proc.wait()}: {self._tail()}")
        self.ready = json.loads(line)
        self.ready["start_s"] = time.perf_counter() - t0
        return self

    def _tail(self) -> str:
        with open(self.err.name) as f:
            return f.read()[-2000:]

    def __exit__(self, *exc):
        try:
            self.proc.stdin.close()
            self.proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()
        finally:
            self.proc.stdout.close()
            self.err.close()


def http_json(port: int, path: str):
    """GET ``path`` of an App's metrics listener -> its JSON."""
    import urllib.request

    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=60) as r:
        return json.loads(r.read())


def metric_value(text: str, family: str, **labels) -> float:
    """The sum of the exposition's samples of ``family`` (any namespace
    prefix) whose labels include ``labels``."""
    import re

    total = 0.0
    pat = re.compile(r"^(?:\w+_)?" + re.escape(family)
                     + r"(?:\{([^}]*)\})?\s+(\S+)")
    for ln in text.splitlines():
        m = pat.match(ln)
        if not m:
            continue
        got = dict(re.findall(r'(\w+)="([^"]*)"', m.group(1) or ""))
        if all(got.get(k) == v for k, v in labels.items()):
            total += float(m.group(2))
    return total


def _answer_bytes(resp: dict) -> str:
    """An admission answer without its uid, as canonical JSON."""
    return json.dumps({k: v for k, v in resp.items() if k != "uid"},
                      sort_keys=True)


def audit_trace(port: int) -> dict:
    """The newest audit cycle's trace on an App's /debug/traces ->
    span name -> its duration in ms (summed over spans of one name)."""
    for tr in http_json(port, "/debug/traces?limit=20")["traces"]:
        if tr["root"] == "audit":
            out: dict = {}
            for sp in tr["spans"]:
                out[sp["name"]] = out.get(sp["name"], 0.0) + \
                    sp["duration_ms"]
            return out
    raise AssertionError("no audit trace on /debug/traces")


def wire_start(flags: list, n_templates: int, n_constraints: int,
               n_pods: int):
    """An App built from ``flags`` (its --api-server the child's URL: the
    kube is HttpKube), started, ready with every template, constraint and
    pod synced over the wire, its calibration landed -> (app, its HTTPS
    connection, the ready record)."""
    from gatekeeper_tpu_torch.main import App, build_parser

    t_start = time.perf_counter()
    app = App(build_parser().parse_args(flags))
    if type(app.kube).__name__ != "HttpKube" or \
            app.client.driver.device.type != DEVICE:
        raise AssertionError(f"the App runs over {type(app.kube)} on "
                             f"{app.client.driver.device}")
    app.start()
    conn = _https(app.webhook_server.port)
    marks = await_ready(app, conn, t_start, n_templates, n_constraints,
                        n_pods)
    if not app.manager.drain(timeout=120):
        raise AssertionError("the controllers' queues did not drain")
    cal_s = await_calibration(app.client.driver)
    return app, conn, {**marks, "calibration_waited_s": cal_s}


def decision_counts(log_dir: str) -> dict:
    """The admission records of a decision log by class."""
    from gatekeeper_tpu_torch.obs import decisionlog as dlog

    out: dict = {}
    for path in dlog.segment_paths(log_dir):
        with open(path) as f:
            for line in f:
                rec = json.loads(line) if line.strip() else {}
                if rec.get("kind") == dlog.KIND_ADMISSION:
                    out[rec.get("class")] = out.get(rec.get("class"), 0) + 1
    return out


def replay_decisions(log_dir: str, snap_dir: str, n_admitted: int) -> dict:
    """App A's sealed decision log replayed on the card by the port's
    replay tool in a child process, against the snapshot App A wrote
    (exit 0, no drift, every allow and deny record the tool does not
    skip replayed, every replayed batch served by the device), and the
    tool's selftest on the card in another (zero drift, the seeded
    GK_BUG_COMPAT drift flagged), the two together; both stopped on
    every way out -> the record."""
    counts = decision_counts(log_dir)
    decided = counts.get("allow", 0) + counts.get("deny", 0)
    if decided < n_admitted:
        raise AssertionError(f"App A's log holds {counts} for "
                             f"{n_admitted} admissions")
    env = {k: v for k, v in os.environ.items() if k != "GK_BUG_COMPAT"}
    runs = {
        "replay": [REPLAY_TOOL, "--log-dir", log_dir, "--snapshot-dir",
                   snap_dir, "--require-seal", "--json", "--torch-device",
                   DEVICE],
        "selftest": [REPLAY_TOOL, "--selftest", "--torch-device", DEVICE],
    }
    procs, out = {}, {"records": counts}
    t0 = time.perf_counter()
    try:
        for name, argv in runs.items():
            procs[name] = (subprocess.Popen(
                [sys.executable] + argv, cwd=ROOT, env=env, text=True,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE),
                time.perf_counter())
        for name, (proc, started) in procs.items():
            stdout, stderr = proc.communicate(timeout=REPLAY_TIMEOUT_S)
            out[name] = {"rc": proc.returncode,
                         "s": time.perf_counter() - started,
                         "stdout": stdout, "stderr": stderr[-2000:]}
    finally:
        for proc, _t in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    out["seconds"] = time.perf_counter() - t0
    rep, st = out["replay"], out["selftest"]
    if rep["rc"] != 0:
        raise AssertionError(f"the replay exited {rep['rc']}: {rep}")
    report = json.loads(rep.pop("stdout"))
    skipped = report["skipped_masked"] + report["skipped_transient"]
    tiers = {k.split("|")[0] for k in report["routes"]}
    if report["drift_count"] or report["replayed"] < decided - skipped \
            or report["replayed"] < n_admitted or tiers != {"device"}:
        raise AssertionError(f"the replay of App A's log: {report}")
    rep["report"] = report
    # the baseline replays through the recording engine (its memo
    # answers); the compat replay's fresh engine evaluates on the card
    import ast
    import re

    base = re.search(r"baseline replay: (\d+) replayed, (\d+) drift",
                     st["stdout"])
    compat = re.search(r"GK_BUG_COMPAT replay: (\d+) replayed, (\d+) "
                       r"drift, routes (\{.*\})", st["stdout"])
    routes = ast.literal_eval(compat.group(3)) if compat else {}
    if st["rc"] != 0 or "seeded drift flagged" not in st["stdout"] or \
            not base or base.group(2) != "0" or not compat or \
            compat.group(2) == "0" or not routes or \
            {k.split("|")[0] for k in routes} != {"device"}:
        raise AssertionError(f"the replay's selftest on the card: {st}")
    st["lines"] = st.pop("stdout").splitlines()
    return out


def wire_phase(args, pods, process) -> dict:
    """Phase 14: the port's App over the wire against a KubeApiServer in
    a child process, --driver torch on the card.  App A (--audit-from-
    cache) answers phase 3's pods over HTTPS byte for byte as phase 10's
    App did and runs two full audit cycles whose statuses, read back from
    the API server, equal a Client's audit_capped on the same inventory;
    its /metrics, /debug/costs and /debug/traces carry the audit's stage
    telemetry.  App B (--audit-chunk-size WIRE_CHUNK) streams its audit
    in continue-token pages through review_batch to the Client's uncapped
    totals, listing only violations the uncapped audit reports.  -> the
    launches of the two Apps."""
    from gatekeeper_tpu_torch.audit.manager import truncate
    from gatekeeper_tpu_torch.util import synthetic as syn

    gdev = _dev()
    n = min(WIRE_PODS, args.pods)
    # phase 13's diverts were injected: the Apps here must add none
    for k, moved in diverts().items():
        INJECTED_DIVERTS[k] = INJECTED_DIVERTS.get(k, 0) + moved
    # the reference, on the card before the counted run: a Client over
    # the inventory the child stores (the same seed's templates and pods)
    t0 = time.perf_counter()
    ref = syn.build_driver(args.templates, n, SEED)
    _resp, ref_totals = ref.audit_capped(CAP)
    ref_count, ref_listed = {}, set()
    for r in ref.audit().results():
        key = (r.constraint["kind"], r.constraint["metadata"]["name"])
        ref_count[key] = ref_count.get(key, 0) + 1
        md = (r.review.get("object") or {}).get("metadata") or {}
        ref_listed.add((key, md.get("name"), md.get("namespace") or "",
                        truncate(r.msg)))
    del ref, _resp
    gc.collect()
    _templates, constraints = syn.make_templates(args.templates, SEED)
    if any(how == "exact" and n_ != ref_count.get(k, 0)
           for k, (n_, how) in ref_totals.items()):
        raise AssertionError("the reference's exact capped totals differ "
                             "from its uncapped audit")
    log("wire_reference", seconds=time.perf_counter() - t0, pods=n,
        violations=sum(ref_count.values()),
        exact_totals=sum(1 for _n, h in ref_totals.values()
                         if h == "exact"))
    cert_dir = os.path.join(ROOT, "build", "wire_certs")
    # App A's decision log and the snapshot of the state that decided,
    # which the replay restores
    decision_dir = os.path.join(ROOT, "build", "wire_decisions")
    snap_dir = os.path.join(ROOT, "build", "wire_snapshots")
    for d in (decision_dir, snap_dir):
        shutil.rmtree(d, ignore_errors=True)
    record: dict = {"pods": n, "templates": args.templates}
    gdev.reset_launches()
    t_phase = time.perf_counter()
    with WireServer(args.templates, n) as server:
        record["server"] = server.ready
        common = ["--driver", "torch", "--torch-device", DEVICE,
                  "--api-server", server.ready["url"],
                  "--port", "0", "--prometheus-port", "0",
                  "--health-addr", ":0", "--audit-interval", "86400",
                  "--constraint-violations-limit", str(CAP),
                  "--log-level", "WARNING", "--cert-dir", cert_dir]

        # App A: from the cache, admissions and two full cycles, its
        # decisions sealed into a log, then a snapshot of the state that
        # decided them (no template, constraint or pod changed between)
        app, conn, ready = wire_start(
            common + ["--audit-from-cache", "--decision-log-dir",
                      decision_dir, "--decision-log-seal",
                      "--snapshot-dir", snap_dir,
                      "--snapshot-interval", "86400"],
            args.templates, len(constraints), n)
        adriver = app.client.driver
        adriver.DEVICE_MIN_CELLS = 0  # its admissions on the card
        try:
            # the one snapshot is written after the cycles, below
            app.snapshotter.stop()
            record["app_a_ready"] = ready
            lat = []
            for i, pod in enumerate(pods):
                resp, ms = admit(conn, f"wire-{i}", pod)
                lat.append(ms)
                if _answer_bytes(resp) != _answer_bytes(
                        process["answers"][i]):
                    raise AssertionError(f"pod {i}: {resp} is not phase "
                                         f"10's {process['answers'][i]}")
            record["admissions"] = {
                "n": len(lat), "p50_ms": statistics.median(lat),
                "p99_ms": percentile(lat, 99), "max_ms": max(lat)}
            port = app.metrics_exporter.port
            text0 = metrics_text(port)
            cycles = []
            for label in ("cold", "forced_full"):
                if label != "cold":
                    force_full(adriver)
                cells0 = metric_value(metrics_text(port),
                                      "render_cells_total")
                rec = cycle(app, label, cycles, ref_totals, constraints)
                st = dict(adriver.last_sweep_stats)
                moved = metric_value(metrics_text(port),
                                     "render_cells_total") - cells0
                spans = audit_trace(port)
                rec.update(render_cells_moved=moved, spans=spans,
                           fetch_ms=st.get("fetch_ms"),
                           render_plan_cells=st.get("render_plan_cells"),
                           render_interp_cells=st.get(
                               "render_interp_cells"))
                agree = {
                    "pack": abs(spans.get("audit.pack", -1.0)
                                - st["pack_ms"]),
                    "dispatch_fetch": abs(
                        spans.get("audit.dispatch", -1.0)
                        + spans.get("audit.fetch", -1.0) - st["device_ms"]),
                    "render": abs(spans.get("audit.render", -1.0)
                                  - st["render_ms"]),
                }
                rec["span_minus_stat_ms"] = agree
                if rec["path"] != "full" or \
                        any(s not in spans for s in WIRE_SPANS) or \
                        max(agree.values()) > WIRE_SPAN_TOL_MS or \
                        moved != st["render_plan_cells"] + \
                        st["render_interp_cells"] or \
                        moved > st["rendered_cells"] or \
                        (label == "cold" and not moved):
                    raise AssertionError(f"App A's cycle {label}: {rec}")
            record["app_a_cycles"] = cycles
            text1 = metrics_text(port)
            pack_moved = metric_value(text1, "tpu_pack_seconds_count",
                                      path="audit") - metric_value(
                text0, "tpu_pack_seconds_count", path="audit")
            costs = http_json(port, "/debug/costs?top=5")
            kinds = {c["kind"] for c in constraints}
            named = [t["template"] for t in costs.get("templates", ())]
            cost_series = sum(1 for ln in text1.splitlines()
                              if "cost_cells{" in ln and "template=" in ln)
            record["telemetry"] = {
                "tpu_pack_seconds_audit_moved": pack_moved,
                "debug_costs_templates": named,
                "cost_cells_series": cost_series}
            if pack_moved != len(cycles) or not named or \
                    not set(named) <= kinds or not cost_series:
                raise AssertionError(f"App A's telemetry: "
                                     f"{record['telemetry']}")
            if app.audit_manager.consecutive_failures:
                raise AssertionError("an App A audit cycle failed")
            check_no_divert("the wire, App A", adriver)
            if app.snapshotter.write_once() is None:
                raise AssertionError(f"App A wrote no snapshot: "
                                     f"{app.snapshotter.last_error}")
        finally:
            app.stop()
        del app, adriver
        if not gc.isenabled():
            raise AssertionError("the collector is off after App.stop()")
        record["replay"] = replay_decisions(decision_dir, snap_dir,
                                            len(pods))

        # App B: the streamed audit, paged over the wire
        app, conn, ready = wire_start(
            common + ["--audit-chunk-size", str(WIRE_CHUNK)],
            args.templates, len(constraints), n)
        bdriver = app.client.driver
        bdriver.DEVICE_MIN_CELLS = 0  # its audit's batches on the card
        try:
            record["app_b_ready"] = ready
            continued, pages, batches = [], [], []
            request, list_pages = app.kube._request, app.kube.list_pages
            review_batch = bdriver.review_batch

            def spy_request(method, path, *a, **kw):
                if method == "GET" and "continue=" in path:
                    continued.append(path)
                return request(method, path, *a, **kw)

            def spy_pages(gvk, *a, **kw):
                for page in list_pages(gvk, *a, **kw):
                    pages.append((gvk[2], len(page)))
                    yield page

            def spy_batch(reviews, tracing=False):
                batches.append(len(reviews))
                return review_batch(reviews, tracing=tracing)

            app.kube._request = spy_request
            app.kube.list_pages = spy_pages
            bdriver.review_batch = spy_batch
            t0 = time.perf_counter()
            if not app.audit_manager.run_once_guarded():
                raise AssertionError("App B's streamed audit failed")
            audit_s = time.perf_counter() - t0
            app.kube._request = request
            app.kube.list_pages = list_pages
            bdriver.review_batch = review_batch
            got_totals, listed, strays = {}, 0, []
            for c in constraints:
                key = (c["kind"], c["metadata"]["name"])
                st = app.kube.get(("constraints.gatekeeper.sh", "v1beta1",
                                   c["kind"]), key[1]).get("status") or {}
                got_totals[key] = st.get("totalViolations")
                for v in st.get("violations") or ():
                    listed += 1
                    if (key, v.get("name"), v.get("namespace") or "",
                            v.get("message")) not in ref_listed:
                        strays.append((key, v))
            pod_pages = [k for kind, k in pages if kind == "Pod"]
            record["app_b_audit"] = {
                "routes": bdriver.route_ledger.snapshot()["counts"],
                "s": audit_s, "pages": len(pod_pages),
                "largest_page": max(pod_pages, default=0),
                "continue_requests": len(continued),
                "review_batches": len(batches),
                "largest_batch": max(batches, default=0),
                "listed_violations": listed}
            want_totals = {k: ref_count.get(k, 0) for k in got_totals}
            routes = record["app_b_audit"]["routes"]
            if set(routes) != {"device|forced_device"}:
                raise AssertionError(f"App B's batches left the card: "
                                     f"{routes}")
            if got_totals != want_totals or strays or not listed or \
                    not continued or sum(pod_pages) != n or \
                    max(pod_pages) > WIRE_CHUNK:
                bad = [k for k in got_totals
                       if got_totals[k] != want_totals[k]]
                raise AssertionError(f"App B's streamed audit: "
                                     f"{record['app_b_audit']}, totals "
                                     f"differ for {bad[:5]}, strays "
                                     f"{strays[:3]}")
            check_no_divert("the wire, App B", bdriver)
        finally:
            app.stop()
        del app, bdriver
    record["seconds"] = time.perf_counter() - t_phase
    launches = dict(gdev.launches)
    missing = [k for k in WIRE_KERNELS if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels never launched over the wire: "
                             f"{missing}")
    log("wire", launches=launches, **record)
    return launches


# ---- phase 15: the tiers (the device, the numpy host tier, the interpreter) -

# unique one-pod reviews of each pass (routed live, the device forced)
TIER_REVIEWS = 256
# of them, a seeded sample held to the InterpDriver oracle
TIER_ORACLE = 32
# batch sizes routed live, each TIER_BATCH_REPS batches of fresh pods
TIER_BATCHES = (8, 64, 256)
TIER_BATCH_REPS = 3
# the reviews of each of the breaker's batches
TIER_BREAKER_BATCH = 8
TIERS = ("device", "np", "interp")
CAL_KEYS = {"rtt_ms", "device_cells_per_ms", "np_floor_ms",
            "np_cells_per_ms", "interp_cells_per_ms"}


class PinnedTier:
    """While active, ``driver``'s admissions take ``tier`` whatever their
    price: the card (DEVICE_MIN_CELLS = 0 on the instance), or, the host
    tiers serving where priced (price_host_tiers) and the calibration set
    aside, the priors pointed at the numpy tier (NP_MIN_CELLS = 0) or,
    the numpy tier off, at the interpreter; or, as "priced", the tier the
    calibration prices, host tiers included, as TpuDriver serves them.
    After it the card's routing again."""

    def __init__(self, driver, tier: str):
        self.driver, self.tier = driver, tier

    def __enter__(self):
        d = self.driver
        self.saved = (d._route_cal, d.np_serve_enabled, d.price_host_tiers)
        if self.tier == "device":
            d.DEVICE_MIN_CELLS = 0
        else:
            d.price_host_tiers = True
        if self.tier in ("np", "interp"):
            d._route_cal = None
            d.DEVICE_MIN_CELLS = 10**9
            d.NP_MIN_CELLS = 0
            d.np_serve_enabled = self.tier == "np"
        return self

    def __exit__(self, *exc):
        d = self.driver
        d._route_cal, d.np_serve_enabled, d.price_host_tiers = self.saved
        if self.tier != "priced":
            del d.DEVICE_MIN_CELLS
        if self.tier in ("np", "interp"):
            del d.NP_MIN_CELLS
        return False


def _lat(ms: list) -> dict:
    return ({"n": len(ms), "p50_ms": statistics.median(ms),
             "p99_ms": percentile(ms, 99)} if ms else {"n": 0})


def tiers_phase(args, client, driver, smi: str) -> dict:
    """Phase 15 on phase 3's client, its admissions priced again: the
    calibration of the three tiers and the host tiers' share of its wall;
    TIER_REVIEWS unique one-pod reviews routed live (the card serves every
    one, its pricing recorded), priced as TpuDriver serves them (the host
    tiers where priced cheapest) and pinned to each tier (the device
    forced, the numpy tier, the interpreter), in turns, the memos emptied
    before each (each review's bytes equal across the five, a seeded
    TIER_ORACLE of them equal to the InterpDriver oracle's; K1 and K9 once
    for each review the device served, nothing for the host tiers'
    ones); the numpy side's masks of all of them equal compute_masks' bit
    for bit; batches of TIER_BATCHES routed live and priced, in turns
    (the answers equal), each with its tier, both walls and every tier's
    prediction; with the breaker forced open a batch the numpy tier
    serves, and with the numpy tier off the interpreter -> the launches
    of its run."""
    import copy
    import random

    import numpy as np

    from gatekeeper_tpu_torch.util import synthetic as syn

    gdev = _dev()
    gdev.reset_launches()
    check_no_divert("before the tiers", driver)
    del driver.DEVICE_MIN_CELLS  # phase 3's forcing: the prior again
    if driver.DEVICE_MIN_CELLS == 0:
        raise AssertionError("GK_DEVICE_MIN_CELLS=0 forces every phase")
    if driver.price_host_tiers:
        raise AssertionError("the card's driver serves host tiers by price")

    def served(made, n):
        """The tier that served the last batch, of ``n`` reviews, its
        launches checked: K1 and K9 once on the card, none on the host."""
        tier, reason = driver.route_ledger.last()
        want = review_launches(n) if tier == "device" else {}
        if made != want:
            raise AssertionError(f"a batch of {n} served by {tier} "
                                 f"({reason}) launched {made}, not {want}")
        return tier, reason

    # the calibration, the host tiers' calls in it timed apart
    host_ms = {"np": 0.0, "interp": 0.0}

    def timed(tier, fn):
        def call(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                host_ms[tier] += (time.perf_counter() - t0) * 1e3
        return call

    driver._np_review = timed("np", driver._np_review)
    driver._interp_review_memo = timed("interp", driver._interp_review_memo)
    try:
        cal, cal_ms, made = made_by(driver.calibrate_routing)
    finally:
        del driver._np_review, driver._interp_review_memo
    if cal is None or set(cal) != CAL_KEYS or \
            made != calibration_launches():
        raise AssertionError(f"the calibration launched {made}: {cal}")
    log("tiers_calibration", **cal, wall_ms=cal_ms, launches=made,
        host_tiers_ms=host_ms,
        host_tiers_share=sum(host_ms.values()) / cal_ms,
        predicted_ms={n: tier_ms(driver, n)
                      for n in (1,) + TIER_BATCHES}, card=smi)

    # one-pod reviews, routed live, priced and pinned to each tier, in
    # turns (each mode first for a fifth of the pods: the first pays the
    # interning)
    pods = fresh_pods(TIER_REVIEWS, SEED + 50, "tier")
    modes = ("live", "priced") + TIERS
    live, priced = [], {t: [] for t in TIERS}
    pinned = {t: [] for t in TIERS}
    live_bytes, reasons = [], {"live": {}, "priced": {}}
    for i, pod in enumerate(pods):
        got = {}
        k = i % len(modes)
        for mode in modes[k:] + modes[:k]:
            forget_reviews(driver)
            if mode == "live":
                out, ms, made = made_by(
                    lambda: client.review(copy.deepcopy(pod)))
            else:
                with PinnedTier(driver, mode):
                    out, ms, made = made_by(
                        lambda: client.review(copy.deepcopy(pod)))
            tier, reason = served(made, 1)
            if mode in ("live", "priced"):
                key = f"{tier}|{reason}"
                reasons[mode][key] = reasons[mode].get(key, 0) + 1
            if mode == "live":
                if tier != "device":
                    raise AssertionError(f"a live review left the card "
                                         f"for {tier} ({reason})")
                live.append(ms)
            elif mode == "priced":
                priced[tier].append(ms)
            else:
                if tier != mode:
                    raise AssertionError(f"a review pinned to {mode} "
                                         f"left it")
                pinned[mode].append(ms)
            got[mode] = _review_bytes([out])[0]
        if any(got[m] != got["live"] for m in modes):
            raise AssertionError(f"pod {i}: the tiers answer otherwise: "
                                 f"{[m for m in modes if got[m] != got['live']]}")
        live_bytes.append(got["live"])
    forget_reviews(driver)
    # a seeded sample against the interpreter oracle of the same corpus
    # (inventory-free templates: no stored object is read)
    oracle = syn.build_oracle(args.templates, 0, SEED)
    sample = sorted(random.Random(SEED).sample(range(len(pods)),
                                               TIER_ORACLE))
    for i in sample:
        want = _review_bytes([oracle.review(copy.deepcopy(pods[i]))])[0]
        if live_bytes[i] != want:
            raise AssertionError(f"pod {i}: not the oracle's answer")
    del oracle
    # the numpy side's masks of every pod against the card's
    reviews = [driver.target.make_audit_review(
        copy.deepcopy(p), "v1", "Pod", p["metadata"]["name"],
        p["metadata"].get("namespace", "")) for p in pods]
    with driver._lock:
        ordered, mask, rej = driver.compute_masks(reviews)
        driver._np_side.sync(driver)
        n_ordered, n_mask, n_rej = driver._np_side.serve(driver, reviews)
    R = len(reviews)
    masks_equal = ([o[:2] for o in ordered] == [o[:2] for o in n_ordered]
                   and bool(np.array_equal(mask[:, :R], n_mask))
                   and bool(np.array_equal(rej[:, :R], n_rej)))
    if not masks_equal:
        raise AssertionError("the numpy side's masks differ from the "
                             "card's")
    predicted = tier_ms(driver, 1)
    log("tiers_reviews", live=_lat(live),
        priced={t: _lat(ms) for t, ms in priced.items()},
        priced_all=_lat(sum(priced.values(), [])),
        pinned={t: _lat(ms) for t, ms in pinned.items()},
        predicted_ms=predicted,
        predicted_over_pinned_p50={
            t: predicted[t] / statistics.median(ms)
            for t, ms in pinned.items()},
        reasons=reasons, oracle_sample=len(sample),
        masks_equal={"reviews": R, "flagged_cells": int(mask.sum()),
                     "autoreject_cells": int(rej.sum())}, card=smi)

    # batches routed live (the card) and priced, the memos emptied, in
    # turns
    batches = []
    for n in TIER_BATCHES:
        for rep in range(TIER_BATCH_REPS):
            batch = fresh_pods(n, SEED + 52 + n + rep,
                               f"tier-batch-{n}-{rep}")
            rec = {"reviews": n, "predicted_ms": tier_ms(driver, n)}
            got = {}
            for mode in (("live", "priced") if rep % 2 == 0
                         else ("priced", "live")):
                forget_reviews(driver)
                if mode == "live":
                    out, rec["ms"], made = made_by(
                        lambda: client.review_batch(copy.deepcopy(batch)))
                    rec["tier"], rec["reason"] = served(made, n)
                    if rec["tier"] != "device":
                        raise AssertionError(f"a live batch of {n} left "
                                             f"the card: {rec}")
                else:
                    with PinnedTier(driver, "priced"):
                        out, rec["priced_ms"], made = made_by(
                            lambda: client.review_batch(
                                copy.deepcopy(batch)))
                    rec["priced_tier"], _reason = served(made, n)
                got[mode] = _review_bytes(out)
            if got["live"] != got["priced"]:
                raise AssertionError(f"a batch of {n}: the priced route "
                                     f"answers otherwise than the card")
            batches.append(rec)
    forget_reviews(driver)
    log("tiers_batches", batches=batches, card=smi)

    # the breaker forced open on a batch priced for the card: the numpy
    # tier serves it, and with the numpy tier off the interpreter; each
    # answer equal to the card's
    br = driver.breaker
    cooldown = br.cooldown_s
    br.cooldown_s = 3600.0  # no probe closes it meanwhile
    diverts0 = diverts()
    pods = fresh_pods(2 * TIER_BREAKER_BATCH, SEED + 51, "tier-breaker")
    halves = (pods[:TIER_BREAKER_BATCH], pods[TIER_BREAKER_BATCH:])
    got = []
    try:
        with PinnedTier(driver, "device"):
            br.trip()
            for np_on, half in zip((True, False), halves):
                driver.np_serve_enabled = np_on
                out, _ms, made = made_by(
                    lambda: client.review_batch(copy.deepcopy(half)))
                got.append((driver.route_ledger.last(), made,
                            _review_bytes(out)))
    finally:
        driver.np_serve_enabled = True
        br.record_success()
        br.cooldown_s = cooldown
    moved = diverts()
    for k, n in moved.items():
        INJECTED_DIVERTS[k] = INJECTED_DIVERTS.get(k, 0) + n - \
            diverts0.get(k, 0)
    forget_reviews(driver)
    with PinnedTier(driver, "device"):
        card = [_review_bytes(client.review_batch(copy.deepcopy(h)))
                for h in halves]
    routes = [g[0] for g in got]
    if routes != [("np", "breaker_open"), ("interp", "breaker_open")] or \
            any(g[1] for g in got) or [g[2] for g in got] != card:
        raise AssertionError(f"the breaker's batches: {routes}, launches "
                             f"{[g[1] for g in got]}, answers equal "
                             f"{[g[2] for g in got] == card}")
    log("tiers_breaker", routes=routes, reviews=TIER_BREAKER_BATCH)
    check_no_divert("the tiers", driver)
    return dict(gdev.launches)


SPLIT_MODES = ("op_by_op", "k9")


def _split_mode(mode: str):
    import contextlib

    return OpByOp() if mode == "op_by_op" else contextlib.nullcontext()


def _split_order(i: int):
    """op-by-op, K9; K9, op-by-op; ... (each mode first in half the
    rounds)."""
    return SPLIT_MODES if i % 2 == 0 else SPLIT_MODES[::-1]


def _medians(rec: dict) -> dict:
    return {m: {k: statistics.median(v) for k, v in r.items()}
            for m, r in rec.items()}


def device_split(client, driver, churn: Churn) -> dict:
    """The device stage before and after K9 in one run: the op-by-op IR
    (OpByOp, with K2, K3) against the bytecode and K9, in turns, on each
    path of the synthetic corpus: SPLIT_ROUNDS forced full sweeps (whose
    totals must agree between the two), churn sweeps for each d, and
    SPLIT_REVIEWS unique one-pod reviews each (wall p50 and p99, and the
    same less the constraint side's re-pack)."""
    from gatekeeper_tpu_torch.util import synthetic as syn

    rec = {m: {} for m in SPLIT_MODES}

    def put(mode, key, value):
        rec[mode].setdefault(key, []).append(value)

    for i in range(SPLIT_ROUNDS):
        totals = {}
        for mode in _split_order(i):
            with _split_mode(mode):
                force_full(driver)
                _resp, totals[mode] = client.audit_capped(CAP)
            put(mode, "full_device_ms", driver.last_sweep_stats["device_ms"])
        if totals["op_by_op"] != totals["k9"]:
            raise AssertionError("full sweeps differ between op-by-op and K9")
        for d in CHURN_D:
            for mode in _split_order(i):
                churn.step(d)
                with _split_mode(mode):
                    client.audit_capped(CAP)
                st = driver.last_sweep_stats
                if st.get("delta_rows") != d:
                    raise AssertionError(f"split churn d={d}: {st}")
                put(mode, f"churn{d}_device_ms", st["device_ms"])
    pods = syn.make_pods(2 * SPLIT_REVIEWS, seed=SEED + 97,
                         violation_rate=0.5)
    lat = {m: [] for m in SPLIT_MODES}
    rest = {m: [] for m in SPLIT_MODES}
    for j, pod in enumerate(pods):
        pod["metadata"]["name"] = f"split-{j}"
        mode = _split_order(j // 2)[j % 2]
        side0 = dict(driver.side_stats)
        with _split_mode(mode):
            t0 = time.perf_counter()
            client.review(pod)
            ms = (time.perf_counter() - t0) * 1e3
        side = driver.side_stats
        lat[mode].append(ms)
        rest[mode].append(ms - (side["pack_ms"] + side["upload_ms"]
                                - side0["pack_ms"] - side0["upload_ms"]))
    out = {"rounds": SPLIT_ROUNDS, "device_ms": _medians(rec), "runs": rec}
    for mode in SPLIT_MODES:
        out[f"{mode}_reviews"] = {
            "n": len(lat[mode]), "p50_ms": statistics.median(lat[mode]),
            "p99_ms": percentile(lat[mode], 99),
            "without_side_p50_ms": statistics.median(rest[mode]),
            "without_side_p99_ms": percentile(rest[mode], 99)}
    return out


def review_split(client, driver) -> dict:
    """The admission review's time, step by step: TorchDriver.review_batch
    driven from here one step at a time, with a synchronise after each
    (nothing of it is in the package).  The steps: _review_pack (the pods
    packed and their columns extracted, the cached constraint side
    checked twice), _constraint_device (the side's placement, cached),
    the upload of the review arrays (state_from_numpy), then _eval with
    match_kernel (K1) and program_eval (K9) each wrapped in synchronises
    (the rest of _eval, binding the groups, is "bind"; K9 packs the two
    masks in its launch), the download of the packed array, the unpack,
    and _render_masked with the inventory.  Beside it, the bool download
    of the same two masks (torch.cat and .cpu(), the download before the
    pack), which must unpack to the same masks; the first batch of each size
    must render what client.review_batch does.  Median and p99 (nearest rank)
    of each step over REVIEW_SPLIT.  Then FRESH_REVIEWS reviews that each
    intern a fresh image string: each must re-pack the constraint side."""
    import numpy as np
    import torch

    from gatekeeper_tpu_torch.convert import state_from_numpy
    from gatekeeper_tpu_torch.ops import driver as driver_mod
    from gatekeeper_tpu_torch.ops.packbits import (
        packed_empty, unpack_review_masks)
    from gatekeeper_tpu_torch.util import synthetic as syn

    dev = driver.device
    kernel_ms = {}

    def synced(name, fn):
        def run(*a, **kw):
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize(dev)
            kernel_ms[name] = (time.perf_counter() - t0) * 1e3
            return out
        return run

    def sig(resps):
        return [[(r.constraint["metadata"]["name"], r.msg) for r in x[0]]
                for x in resps]

    steps = ("review_pack", "side_device", "upload", "match", "bind",
             "program", "download", "unpack", "render")
    saved = (driver_mod.match_kernel, driver_mod.program_eval)
    driver_mod.match_kernel = synced("match", saved[0])
    driver_mod.program_eval = synced("program", saved[1])
    out = {}
    try:
        for size, n in REVIEW_SPLIT:
            pods = syn.make_pods(size * n, seed=SEED + 200 + size,
                                 violation_rate=0.5)
            rec = {k: [] for k in steps + ("total", "bool_download")}
            for i in range(n):
                batch = pods[i * size:(i + 1) * size]
                for j, p in enumerate(batch):
                    p["metadata"]["name"] = f"split-{size}-{i}-{j}"
                reviews = [client.target.handle_review(p)[1] for p in batch]
                torch.cuda.synchronize(dev)
                t = [time.perf_counter()]

                def mark(name):
                    t.append(time.perf_counter())
                    rec[name].append((t[-1] - t[-2]) * 1e3)

                side, rv, cols, rows = driver._review_pack(reviews)
                mark("review_pack")
                placed = driver._constraint_device(side)
                torch.cuda.synchronize(dev)
                mark("side_device")
                rv_d = state_from_numpy(rv, dev)
                cols_d = state_from_numpy(cols, dev)
                torch.cuda.synchronize(dev)
                mark("upload")
                packed_d = packed_empty(side[1].arrays["valid"].shape[0],
                                        rows, dev)
                mask, rej = driver._eval(side, rv_d, cols_d, placed,
                                         pack_out=packed_d)
                t.append(time.perf_counter())
                eval_ms = (t[-1] - t[-2]) * 1e3
                rec["match"].append(kernel_ms["match"])
                rec["program"].append(kernel_ms["program"])
                rec["bind"].append(eval_ms - kernel_ms["match"]
                                   - kernel_ms["program"])
                packed = packed_d.cpu().numpy()
                mark("download")
                ordered, crow = side[0], side[4]
                m_np, r_np = unpack_review_masks([packed], rows, crow, rows)
                mark("unpack")
                resps = driver._render_masked(
                    reviews, ordered, m_np, r_np,
                    driver._inventory_for_render(),
                    memo=size <= driver.REQUEST_MEMO_BATCH_MAX)
                mark("render")
                rec["total"].append((t[-1] - t[0]) * 1e3)
                t0 = time.perf_counter()
                both = torch.cat([mask, rej], dim=0).cpu().numpy()
                rec["bool_download"].append(
                    (time.perf_counter() - t0) * 1e3)
                c = mask.shape[0]
                if not (np.array_equal(both[:c][crow][:, :rows], m_np)
                        and np.array_equal(both[c:][crow][:, :rows], r_np)):
                    raise AssertionError("review split: the packed masks "
                                         "differ from the bool download")
                if i == 0 and sig(resps) != sig(
                        driver.review_batch(reviews)):
                    raise AssertionError("review split: the steps render "
                                         "other results than review_batch")
            out[f"batch_{size}"] = {
                "n": n, "rows": rows, "C": int(mask.shape[0]),
                "packed_bytes": int(packed.nbytes),
                "bool_bytes": int(both.nbytes),
                **{k: {"p50_ms": statistics.median(v),
                       "p99_ms": percentile(v, 99)}
                   for k, v in rec.items()}}
    finally:
        driver_mod.match_kernel, driver_mod.program_eval = saved
    fresh = []
    for i in range(FRESH_REVIEWS):
        pod = syn.make_pods(1, seed=SEED + 300 + i, violation_rate=0.5)[0]
        pod["metadata"]["name"] = f"fresh-{i}"
        pod["spec"]["containers"][0]["image"] = f"fresh-{i}.example/app:1"
        side0 = dict(driver.side_stats)
        t0 = time.perf_counter()
        client.review(pod)
        wall = (time.perf_counter() - t0) * 1e3
        side = driver.side_stats
        rec = {"wall_ms": wall,
               **{k: side[k] - side0[k]
                  for k in ("repacks", "pack_ms", "uploads", "upload_ms")}}
        if rec["repacks"] < 1 or rec["uploads"] < 1:
            raise AssertionError(f"a fresh string did not re-pack: {rec}")
        fresh.append(rec)
    out["fresh_string_reviews"] = fresh
    return out


def ref_device_split(client, driver, churn: RefChurn) -> dict:
    """device_split for the referential corpus: SPLIT_ROUNDS forced full
    sweeps ('trace' joins; totals must agree) and key-moving churn sweeps
    for each d ('tables' joins) in each mode."""
    rec = {m: {} for m in SPLIT_MODES}
    for i in range(SPLIT_ROUNDS):
        totals = {}
        for mode in _split_order(i):
            with _split_mode(mode):
                force_full(driver)
                _resp, totals[mode] = client.audit_capped(CAP)
            rec[mode].setdefault("full_device_ms", []).append(
                driver.last_sweep_stats["device_ms"])
        if totals["op_by_op"] != totals["k9"]:
            raise AssertionError("referential full sweeps differ between "
                                 "op-by-op and K9")
        for d in REF_CHURN_D:
            for mode in _split_order(i):
                churn.moving(d)
                with _split_mode(mode):
                    client.audit_capped(CAP)
                st = driver.last_sweep_stats
                if "delta_rows" not in st:
                    raise AssertionError(f"split ref churn d={d}: {st}")
                rec[mode].setdefault(f"churn{d}_device_ms", []).append(
                    st["device_ms"])
    return {"rounds": SPLIT_ROUNDS, "device_ms": _medians(rec), "runs": rec}


# ---------------------------------------------------------------------------
# 16. the operator's drills on the card, over kernels baked as the image
# bakes them
# ---------------------------------------------------------------------------

# the kernels' build as Dockerfile.torch runs it (tests/test_torch_deploy.py
# holds the two equal): argv[1] is the directory the sealed libraries go
# into, <--xla-cache-dir>/torch_kernels
KERNEL_BAKE = ("import sys; from gatekeeper_tpu_torch import device; "
               "device.use_cache_dir(sys.argv[1]); "
               "device.build_kernels(force=True)")
BAKE_TIMEOUT_S = 600
# each drill: (name, tool, its flags, the replicas' cache flag, the wave it
# runs in).  A wave's drills run at once; the overload drill's burst runs
# in a wave of its own, its timing bounds unshared
DRILLS = (
    ("fleet_parity", "check_fleet_parity_torch.py", ["--edge", "both"], 0),
    ("self_heal", "check_self_heal_torch.py", [], 0),
    ("mesh_parity", "check_mesh_parity_torch.py", [], 0),
    ("join_parity", "check_join_parity_torch.py", [], 0),
    ("overload", "check_overload_torch.py", ["--edge", "both"], 1),
)
REPLICA_DRILLS = ("fleet_parity", "self_heal", "overload")
DRILL_TIMEOUT_S = 400
# where a drill's process and its replicas write what they launched
DRILL_OUT_ENV = "GK_SMOKE_DRILL_OUT"
# the baked kernels' directory (the image's /var/cache/gatekeeper)
DRILL_CACHE_ENV = "GK_SMOKE_DRILL_CACHE"
DRILL_ENTRY = ("import sys; sys.path.insert(0, sys.argv.pop(1)); "
               "import chip_smoke; chip_smoke.drill_watch()")
REPLICA_DRILL_ENTRY = ("import sys; sys.path.insert(0, sys.argv.pop(1)); "
                       "import chip_smoke; chip_smoke.replica_drill_watch()")


def _no_nvcc():
    raise RuntimeError("nvcc is not in this runtime (a drill's process "
                       "loads the baked kernels only)")


def _drill_record(role: str, extra: dict) -> None:
    """Write this process's record (its launches, its kernels' cache) to
    DRILL_OUT_ENV's directory, atomically."""
    from gatekeeper_tpu_torch import device as gdev
    from gatekeeper_tpu_torch.metrics.views import global_registry

    rows = global_registry().view_rows("cache_requests_total")
    rec = {"pid": os.getpid(), "role": role,
           "launches": {k: v for k, v in gdev.launches.items() if v},
           "cache_log": dict(gdev.cache_log),
           "hits": rows.get(("kernels", "hit"), 0),
           "misses": rows.get(("kernels", "miss"), 0),
           "build_dir": gdev.BUILD_DIR, **extra}
    path = os.path.join(os.environ[DRILL_OUT_ENV],
                        f"{role}-{os.getpid()}.json")
    with open(path + ".tmp", "w") as f:
        json.dump(rec, f)
    os.replace(path + ".tmp", path)


def drill_watch():
    """A drill's process under phase 16 (DRILL_ENTRY; argv: the tool,
    then its flags): the kernels load from the baked directory with nvcc
    refused, every replica the tool spawns runs under
    replica_drill_watch, and at exit the process writes its record (its
    own launches and the replicas it spawned); then the tool runs as
    ``python tool`` runs it."""
    import atexit
    import runpy

    from gatekeeper_tpu_torch import device as gdev

    gdev.use_cache_dir(os.path.join(os.environ[DRILL_CACHE_ENV],
                                    "torch_kernels"))
    gdev._nvcc = _no_nvcc
    spawns = WatchedSpawns(REPLICA_DRILL_ENTRY).__enter__()
    atexit.register(lambda: _drill_record(
        "drill", {"spawned": list(spawns.started)}))
    tool = sys.argv.pop(1)
    sys.argv[0] = tool
    runpy.run_path(tool, run_name="__main__")


def replica_drill_watch():
    """A drill's replica under phase 16 (REPLICA_DRILL_ENTRY), which then
    runs the replica's module: nvcc refused (the runtime image has none;
    its --xla-cache-dir is the baked directory), every
    TorchDriver.review_batch counted with the launches it made, and the
    process's record written once its kernels are loaded and after each
    batch and calibration (a replica the drill SIGKILLs keeps what it
    wrote)."""
    import runpy
    import threading

    from gatekeeper_tpu_torch import device as gdev
    from gatekeeper_tpu_torch.ops.driver import TorchDriver

    gdev._nvcc = _no_nvcc
    lock = threading.Lock()
    state = {"batches": 0, "batch_launches": {}, "devices": []}

    def write():
        _drill_record("replica", state)

    build = gdev._build

    def built(*a, **kw):
        out = build(*a, **kw)
        write()
        return out

    gdev._build = built
    review_batch = TorchDriver.review_batch
    calibrate = TorchDriver.calibrate_routing

    def counted(self, reviews, tracing=False):
        with lock:
            before = dict(gdev.launches)
            try:
                return review_batch(self, reviews, tracing=tracing)
            finally:
                state["batches"] += 1
                for k, v in gdev.launches.items():
                    if v != before[k]:
                        state["batch_launches"][k] = \
                            state["batch_launches"].get(k, 0) + v - before[k]
                if str(self.device) not in state["devices"]:
                    state["devices"].append(str(self.device))
                write()

    def calibrated(self, *a, **kw):
        with lock:
            try:
                return calibrate(self, *a, **kw)
            finally:
                write()

    TorchDriver.review_batch = counted
    TorchDriver.calibrate_routing = calibrated
    runpy.run_module(REPLICA_MODULE, run_name="__main__", alter_sys=True)


def bake_kernels(cache_root: str) -> dict:
    """KERNEL_BAKE in a child process into ``cache_root``/torch_kernels, as
    Dockerfile.torch runs it (no GK_SEAL_KEY) -> its record: the seconds,
    the ten sealed libraries, the directory's mode, and each library's
    dynamic dependencies (no libcudart: nvcc linked it statically)."""
    import stat

    from gatekeeper_tpu_torch import device as gdev

    shutil.rmtree(cache_root, ignore_errors=True)
    lib_dir = os.path.join(cache_root, "torch_kernels")
    env = dict(os.environ)
    env.pop("GK_SEAL_KEY", None)
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-c", KERNEL_BAKE, lib_dir],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=BAKE_TIMEOUT_S)
    bake_s = time.perf_counter() - t0
    if out.returncode != 0:
        raise AssertionError(f"the bake failed: {out.stderr[-2000:]}")
    libs = sorted(f for f in os.listdir(lib_dir) if f.endswith(".so"))
    names = sorted(f.split("-")[0][3:] for f in libs)
    seals = [f for f in os.listdir(lib_dir) if f.endswith(gdev.SEAL_SUFFIX)]
    if names != sorted(gdev.KERNEL_NAMES) or len(seals) != len(libs):
        raise AssertionError(f"the bake left {libs} and {seals}")
    mode = stat.S_IMODE(os.stat(lib_dir).st_mode)
    if mode != 0o700:
        raise AssertionError(f"the baked directory's mode is {oct(mode)}")
    needed = {}
    for f in libs:
        dyn = subprocess.run(["readelf", "-d", os.path.join(lib_dir, f)],
                             capture_output=True, text=True, check=True,
                             timeout=60).stdout
        needed[f.split("-")[0][3:]] = sorted(
            ln.rsplit("[", 1)[1].rstrip("]") for ln in dyn.splitlines()
            if "(NEEDED)" in ln)
    if any("cudart" in d for deps in needed.values() for d in deps):
        raise AssertionError(f"a baked library needs the CUDA runtime's "
                             f"shared library: {needed}")
    return {"seconds": bake_s, "libraries": len(libs), "mode": oct(mode),
            "needed": sorted({d for deps in needed.values() for d in deps})}


def runtime_env(cache_root: str, out_dir: str) -> dict:
    """The drills' environment as the runtime image has it: no directory
    holding nvcc on PATH, no CUDA_HOME, no GK_SEAL_KEY, this script's own
    settings (GK_MESH, GK_VIRTUAL_DEVICES) dropped."""
    env = dict(os.environ)
    for k in ("CUDA_HOME", "CUDA_PATH", "GK_SEAL_KEY", "GK_MESH",
              "GK_VIRTUAL_DEVICES", "GK_JOIN_ASSERT"):
        env.pop(k, None)
    env["PATH"] = os.pathsep.join(
        d for d in env.get("PATH", "").split(os.pathsep)
        if d and not os.path.exists(os.path.join(d, "nvcc")))
    if shutil.which("nvcc", path=env["PATH"]):
        raise AssertionError("nvcc is still on the drills' PATH")
    env[DRILL_CACHE_ENV] = cache_root
    env[DRILL_OUT_ENV] = out_dir
    return env


def _drill_launches(records: list, key: str = "launches") -> dict:
    total = {}
    for rec in records:
        for k, v in rec.get(key, {}).items():
            total[k] = total.get(k, 0) + v
    return total


def check_drill(name: str, records: list, cache_root: str) -> dict:
    """A drill's records: every process loaded the ten baked libraries
    sealed (ten hits, no miss, no build) from the baked directory, every
    replica it spawned wrote one and ran on cuda:0, and the kernels ran:
    K1 and K9 in the replicas' review batches for a replica drill, K1, K9
    and K4 for the mesh drill, K7 and K8 for the join drill -> the
    launches (the drill's process, the replicas' batches, the replicas'
    totals)."""
    from gatekeeper_tpu_torch import device as gdev

    n = len(gdev.KERNEL_NAMES)
    drills = [r for r in records if r["role"] == "drill"]
    replicas = [r for r in records if r["role"] == "replica"]
    if len(drills) != 1:
        raise AssertionError(f"{name}: {len(drills)} drill records")
    spawned = set(drills[0]["spawned"])
    if {r["pid"] for r in replicas} != spawned or \
            (name in REPLICA_DRILLS) != bool(spawned):
        raise AssertionError(
            f"{name}: replicas spawned {sorted(spawned)}, records of "
            f"{sorted(r['pid'] for r in replicas)}")
    for rec in records:
        if rec["cache_log"] != dict.fromkeys(gdev.KERNEL_NAMES, "sealed") \
                or rec["hits"] != n or rec["misses"] or \
                rec["build_dir"] != os.path.join(cache_root,
                                                 "torch_kernels"):
            raise AssertionError(f"{name}: a {rec['role']} did not load the "
                                 f"baked kernels sealed: {rec}")
    for rec in replicas:
        if rec["devices"] and rec["devices"] != ["cuda:0"]:
            raise AssertionError(f"{name}: a replica ran on "
                                 f"{rec['devices']}")
    own = _drill_launches(drills)
    batch = _drill_launches(replicas, "batch_launches")
    every = _drill_launches(replicas)
    if name in REPLICA_DRILLS:
        want, got = ("match", "program_pack"), batch
    elif name == "mesh_parity":
        want, got = ("match", "program", "reduction"), own
    else:
        want, got = ("joinkeys", "joinlookup"), own
    if any(not got.get(k) for k in want):
        raise AssertionError(f"{name} launched {got}: no {want} on the "
                             f"card")
    return {"drill": own, "replica_batches": batch, "replicas": every,
            "batches": sum(r["batches"] for r in replicas),
            "replica_processes": len(replicas)}


def drills_phase(smi: str) -> dict:
    """Phase 16 -> the launches of every drill's processes."""
    from gatekeeper_tpu_torch import device as gdev

    cache_root = os.path.join(ROOT, "build", "baked_kernels")
    out_root = os.path.join(ROOT, "build", "drill_records")
    shutil.rmtree(out_root, ignore_errors=True)
    log("bake", **bake_kernels(cache_root))
    import torch

    cards = torch.cuda.device_count()
    total = dict.fromkeys(gdev.LAUNCHERS, 0)
    procs = {}
    try:
        for wave in sorted({d[3] for d in DRILLS}):
            for name, tool, flags, w in DRILLS:
                if w != wave:
                    continue
                out_dir = os.path.join(out_root, name)
                os.makedirs(out_dir)
                env = runtime_env(cache_root, out_dir)
                if name in ("mesh_parity", "join_parity") and cards < 4:
                    env["GK_VIRTUAL_DEVICES"] = "4"
                if name in REPLICA_DRILLS:
                    flags = flags + ["--xla-cache-dir", cache_root]
                cmd = [sys.executable, "-c", DRILL_ENTRY, ROOT,
                       os.path.join(ROOT, "tools", tool),
                       "--torch-device", DEVICE] + flags
                with open(os.path.join(out_dir, "output.log"), "w") as f:
                    procs[name] = (time.perf_counter(), subprocess.Popen(
                        cmd, cwd=ROOT, env=env, stdout=f,
                        stderr=subprocess.STDOUT))
            # each drill's seconds from its start to its exit
            ended, deadline = {}, time.perf_counter() + DRILL_TIMEOUT_S
            while len(ended) < sum(1 for d in DRILLS if d[3] == wave):
                for name, _tool, _flags, w in DRILLS:
                    if w == wave and name not in ended and \
                            procs[name][1].poll() is not None:
                        ended[name] = time.perf_counter()
                if time.perf_counter() > deadline:
                    raise AssertionError(f"drills still running after "
                                         f"{DRILL_TIMEOUT_S} s: "
                                         f"{sorted(set(procs) - set(ended))}")
                time.sleep(0.05)
            for name, tool, _flags, w in DRILLS:
                if w != wave:
                    continue
                t0, proc = procs[name]
                rc, seconds = proc.returncode, ended[name] - t0
                out_dir = os.path.join(out_root, name)
                with open(os.path.join(out_dir, "output.log")) as f:
                    out = f.read()
                if rc != 0:
                    raise AssertionError(f"{tool} exited {rc}:"
                                         f"\n{out[-4000:]}")
                records = []
                for f in sorted(os.listdir(out_dir)):
                    if f.endswith(".json"):
                        with open(os.path.join(out_dir, f)) as fh:
                            records.append(json.load(fh))
                got = check_drill(name, records, cache_root)
                for part in ("drill", "replicas"):
                    for k, v in got[part].items():
                        total[k] += v
                log("drill", name=name, tool=tool, wave=wave, rc=0,
                    seconds=seconds, nvidia_smi=smi, **got,
                    said=[ln for ln in out.splitlines()
                          if "ok" in ln or "clean" in ln][-2:])
    finally:
        for _t0, proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    log("drills_card", nvidia_smi=smi)
    return total


def merge_rows(into: dict, rows: dict):
    """Fold check_kernels rows of another run into ``into``: calls checked
    add up, the largest error stays, a timed row replaces an untimed."""
    for name, row in rows.items():
        old = into.get(name)
        if old is None:
            into[name] = row
            continue
        row_calls = row["calls_checked"] + old["calls_checked"]
        err = max(row["max_abs_err"], old["max_abs_err"])
        if "ms" in row and "ms" not in old:
            into[name] = row
        into[name]["calls_checked"] = row_calls
        into[name]["max_abs_err"] = err


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--templates", type=int, default=500)
    ap.add_argument("--pods", type=int, default=100_000)
    ap.add_argument("--parity-templates", type=int, default=24)
    ap.add_argument("--parity-pods", type=int, default=2000)
    ap.add_argument("--ref-templates", type=int, default=6)
    ap.add_argument("--ref-objects", type=int, default=100_000)
    ap.add_argument("--profile", action="store_true",
                    help="profile one warm sweep with torch.profiler")
    ap.add_argument("--multihost-worker", type=int, default=None,
                    metavar="RANK", help=argparse.SUPPRESS)
    ap.add_argument("--coordinator", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    if not os.path.isdir(os.path.join(ROOT, "gatekeeper_tpu_torch")):
        print("chip_smoke: gatekeeper_tpu_torch/ is not beside this script",
              file=sys.stderr)
        return 1
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card visible", file=sys.stderr)
        return 1
    if args.multihost_worker is not None:
        return multihost_worker(args)
    # phases 3-8 drive the single-device paths, on a machine of several
    # cards too; phase 9 picks its mesh widths with set_mesh
    os.environ["GK_MESH"] = "0"
    sys.path.insert(0, ROOT)
    from gatekeeper_tpu_torch import device as gdev
    from gatekeeper_tpu_torch.ops.driver import TorchDriver
    from gatekeeper_tpu_torch.util import synthetic as syn

    # 1. the card
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    log("card", nvidia_smi=smi, torch_name=kind,
        count=torch.cuda.device_count(), torch=torch.__version__,
        cuda=torch.version.cuda)

    # 2. the kernels' build
    paths = gdev.build_kernels()
    build_s = gdev.build_seconds
    gdev.kernels()
    ptxas = {
        name: [ln.strip() for ln in gdev.build_log.get(name, "").splitlines()
               if "registers" in ln or "spill" in ln]
        for name in gdev.KERNEL_NAMES
    }
    # K7's two launchers compact on a grid of at least one block a SM
    from gatekeeper_tpu_torch.ops import joinkeys

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    grids = {"joinkeys": joinkeys.grid_size(torch.device(DEVICE, 0)),
             "joinkeys_merge": joinkeys.grid_size(torch.device(DEVICE, 0),
                                                  merge=True)}
    if min(grids.values()) < sms:
        raise AssertionError(f"K7's grids {grids} below {sms} SMs")
    log("build", seconds=build_s, libraries=sorted(paths),
        ptxas=ptxas, sms=sms, grids=grids)

    # 3. the main path
    t0 = time.perf_counter()
    client = syn.build_driver(args.templates, args.pods, SEED)
    driver = client.driver
    assert isinstance(driver, TorchDriver) and driver.device.type == DEVICE
    # the card serves this client's admissions whatever their price: the
    # phases that count its launches (3, 6, 9, 12 and 13) hold the device
    # path; phase 15 prices them
    driver.DEVICE_MIN_CELLS = 0
    build_s = time.perf_counter() - t0
    log("build_client", seconds=build_s, templates=args.templates,
        pods=args.pods)

    gdev.reset_launches()
    no_ir = NoIR().__enter__()
    with Capture() as cap:
        t0 = time.perf_counter()
        resp, totals = client.audit_capped(CAP)
        cold_s = time.perf_counter() - t0
    per_sweep = dict(gdev.launches)
    if per_sweep["program"] != 1 or per_sweep["program_pack"] != 0 or \
            per_sweep["packbits"] != 0:
        raise AssertionError(f"K9 launched {per_sweep['program']} times "
                             f"({per_sweep['program_pack']} packing) and "
                             f"K10 {per_sweep['packbits']} in one full sweep")
    results = resp.results()
    stats = dict(driver.last_sweep_stats)
    n_constraints = sum(len(v) for v in driver.constraints.values())
    assert len(totals) == n_constraints == args.templates
    assert results, "the sweep flagged nothing"
    per_constraint = {}
    for r in results:
        key = (r.constraint["kind"], r.constraint["metadata"]["name"])
        per_constraint[key] = per_constraint.get(key, 0) + 1
    assert max(per_constraint.values()) <= CAP
    log("cold_sweep", seconds=cold_s, results=len(results),
        flagged_constraints=sum(1 for n, _h in totals.values() if n),
        stats=stats, launches=per_sweep)

    cells = args.templates * args.pods
    stages = ("pack_ms", "device_ms", "render_ms")

    def warm_sweeps(phase):
        """WARM warm full sweeps of the unchanged store; each one's wall
        time, stages, and the garbage collector's pauses inside it."""
        sweeps = []
        for _ in range(WARM):
            # an unchanged store is otherwise served from the sweep cache
            driver._delta_state = None
            driver._audit_cache = None
            pauses.reset()
            t0 = time.perf_counter()
            resp2, totals2 = client.audit_capped(CAP)
            wall_s = time.perf_counter() - t0
            assert totals2 == totals
            assert len(resp2.results()) == len(results)
            st = driver.last_sweep_stats
            sweeps.append({"s": wall_s, **{k: st[k] for k in stages},
                           "gc_ms": pauses.ms, "gc_gen2": pauses.gen2})
        walls = [w["s"] for w in sweeps]
        med = {k: statistics.median(w[k] for w in sweeps) for k in stages}
        log(phase, n=WARM, median_s=statistics.median(walls),
            worst_s=max(walls), limit_s=SWEEP_LIMIT_S,
            worst_within_limit=max(walls) < SWEEP_LIMIT_S,
            median_stage_ms=med, sweeps=sweeps,
            constraint_evals_per_s=cells / statistics.median(walls),
            device_constraint_evals_per_s=cells / (med["device_ms"] / 1e3),
            rows=stats["rows"], padded_rows=stats["padded_rows"],
            mask_rows=stats["mask_rows"])

    pauses = GcPauses()
    gc.callbacks.append(pauses)
    warm_sweeps("warm_sweeps")
    # the same sweeps with every object alive now moved out of the
    # collector's generations: a pause that was a full collection over the
    # stored inventory leaves with it
    t0 = time.perf_counter()
    gc.collect()
    full_ms = (time.perf_counter() - t0) * 1e3
    gc.freeze()
    log("gc_freeze", full_collection_ms=full_ms,
        frozen_objects=gc.get_freeze_count())
    warm_sweeps("warm_sweeps_gc_frozen")
    gc.unfreeze()

    before_reviews = dict(gdev.launches)
    pods = syn.make_pods(REVIEWS, seed=SEED + 99, violation_rate=0.5)
    lat, side_ms, repacks, gc_ms, denied = [], [], 0, [], 0
    # each pod's results, which phase 10's App must answer again
    review_sigs = []
    for i, pod in enumerate(pods):
        pod["metadata"]["name"] = f"admission-{i}"
        side0 = dict(driver.side_stats)
        pauses.reset()
        t0 = time.perf_counter()
        out = client.review(pod)
        lat.append((time.perf_counter() - t0) * 1e3)
        side = driver.side_stats
        side_ms.append(side["pack_ms"] + side["upload_ms"]
                       - side0["pack_ms"] - side0["upload_ms"])
        repacks += side["repacks"] - side0["repacks"]
        gc_ms.append(pauses.ms)
        denied += bool(out.results())
        review_sigs.append(results_sig(out.results()))
    gc.callbacks.remove(pauses)
    launches = dict(gdev.launches)
    review_launches = {k: launches[k] - before_reviews[k] for k in launches}
    # K9 once per evaluation, in its review mode on a review: it packs the
    # masks, and K10 never launches on a review whose side has groups
    if review_launches["program_pack"] != len(pods) or \
            review_launches["program"] != 0 or \
            launches["program"] + launches["program_pack"] != \
            launches["match"]:
        raise AssertionError(f"K9 does not pack once per review: "
                             f"{review_launches}, {launches}")
    if review_launches["packbits"] != 0:
        raise AssertionError(f"K10 launched on reviews: {review_launches}")
    rest = [t - s for t, s in zip(lat, side_ms)]
    log("reviews", n=len(pods), p50_ms=statistics.median(lat),
        p99_ms=percentile(lat, 99), max_ms=max(lat), denied=denied,
        side_repacks=repacks,
        side_p50_ms=statistics.median(side_ms),
        side_p99_ms=percentile(side_ms, 99),
        without_side_p50_ms=statistics.median(rest),
        without_side_p99_ms=percentile(rest, 99),
        gc_pause_ms_total=sum(gc_ms), gc_pause_ms_max=max(gc_ms),
        launches=review_launches)
    missing = [k for k in PATH1_KERNELS + ("program_pack",)
               if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: "
                             f"{missing}")
    log("launches", main_path=launches, per_sweep=per_sweep,
        per_review={k: v / len(pods) for k, v in review_launches.items()})
    # the same pods again: each a request-memo hit (no launch, the same
    # results), measured in a pass of its own
    before_repeats = dict(gdev.launches)
    rep_lat = []
    for i, pod in enumerate(pods):
        t0 = time.perf_counter()
        out = client.review(pod)
        rep_lat.append((time.perf_counter() - t0) * 1e3)
        if results_sig(out.results()) != review_sigs[i]:
            raise AssertionError(f"the repeat of pod {i} answers otherwise")
    if dict(gdev.launches) != before_repeats:
        raise AssertionError("a repeated review launched a kernel")
    log("reviews_repeated", n=len(pods), p50_ms=statistics.median(rep_lat),
        p99_ms=percentile(rep_lat, 99), max_ms=max(rep_lat))
    check_no_divert("the main path", driver)

    if args.profile:
        from torch.profiler import ProfilerActivity, profile

        from gatekeeper_tpu_torch.obs import devprof

        torch.cuda.synchronize()
        # the process's one profiler session (an App's device profiler
        # answers 409 meanwhile)
        with devprof.exclusive(), profile(
                activities=[ProfilerActivity.CPU,
                            ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            client.audit_capped(CAP)
            torch.cuda.synchronize()
            prof_wall = time.perf_counter() - t0
        def dev_us(e):  # the attribute's name varies across versions
            return (getattr(e, "self_device_time_total", None)
                    or getattr(e, "self_cuda_time_total", 0) or 0)

        evs = sorted((e for e in prof.key_averages() if dev_us(e) > 0),
                     key=lambda e: -dev_us(e))
        busy_us = sum(dev_us(e) for e in evs)
        log("profile", wall_ms=prof_wall * 1e3, device_busy_ms=busy_us / 1e3,
            idle_share=1 - busy_us / 1e3 / (prof_wall * 1e3),
            top=[(e.key[:60], e.count, dev_us(e) / 1e3) for e in evs[:12]])
        os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
        prof.export_chrome_trace(
            os.path.join(ROOT, "chiprun_out", "sweep_trace.json"))

    no_ir.__exit__()
    # K1 and K9 on a one-pod review (after the counts were read)
    pod = syn.make_pods(1, seed=SEED + 98, violation_rate=1.0)[0]
    pod["metadata"]["name"] = "admission-recorded"
    with Capture(names=("match", "program_pack")) as review_cap:
        client.review(pod)
    # K9's packing call on every review of phase 3: the same pods again,
    # the memos emptied so each evaluates, recorded (the counted loop is
    # not, so its latencies carry no copies), then one batch of REVIEWS
    # pods (R = 256)
    forget_reviews(driver)
    with Capture(names=("program_pack", "packbits")) as fold_cap:
        for p in pods:
            client.review(p)
    batch = syn.make_pods(REVIEWS, seed=SEED + 96, violation_rate=0.5)
    for i, p in enumerate(batch):
        p["metadata"]["name"] = f"admission-batch-{i}"
    with Capture(names=("program_pack", "packbits")) as fold_batch_cap:
        batch_sigs = [results_sig(r.results())
                      for r in client.review_batch(batch)]
    if len(fold_cap.calls["program_pack"]) != len(pods) or \
            len(fold_batch_cap.calls["program_pack"]) != 1:
        raise AssertionError("K9 does not pack once per review evaluation")
    # K10 on the same masks: K9's calls again with no group, which K9 does
    # not launch for (the review of a side without groups); the calls,
    # not counted, give K10's row its times at R = 8 and R = 256
    k10_cap, k10_batch_cap = (k10_calls(c) for c in (fold_cap,
                                                      fold_batch_cap))

    # 4. each kernel against its plain version, on the main path's inputs;
    # K2 and K3 on the cells K9 ran them in (cell_calls)
    kernel_rows = check_kernels(cap, REPS, timed=PATH1_KERNELS)
    log("fused_audit_bound", **fused_audit_bound(kernel_rows))
    merge_rows(kernel_rows, check_kernels(
        cell_calls(cap), REPS, timed=("strpred", "setcount")))
    # admission is the latency path: K1 and K9 (packing) timed at a
    # review's call too
    merge_rows(kernel_rows, check_kernels(review_cap, REPS,
                                          timed=("match", "program_pack"),
                                          phase="kernel_review"))
    merge_rows(kernel_rows, check_kernels(cell_calls(review_cap), REPS,
                                          timed=()))
    del review_cap
    # K9's pack on every recorded review call, and K10 on the same masks,
    # timed at a review's call (C = 1024 group rows, R = 8) and at the
    # batch's (R = 256); K9's row carries K9 then K10 on the same inputs
    # (the chain before the fold) and the fused launch past the row limit
    for cap_, phase in ((fold_cap, "kernel_review"),
                        (fold_batch_cap, "kernel_batch")):
        merge_rows(kernel_rows, check_kernels(
            cap_, REPS, timed=("program_pack",), phase=phase))
    for cap_, phase in ((k10_cap, "kernel_review"),
                        (k10_batch_cap, "kernel_batch")):
        merge_rows(kernel_rows, check_kernels(
            cap_, REPS, timed=("packbits",), phase=phase))
    del fold_cap, fold_batch_cap, k10_cap, k10_batch_cap

    log("edges", checked=check_edges())
    log("match_live_selectors",
        **check_match_at_size(int(stats["mask_rows"]),
                              int(stats["padded_rows"])))
    # R off the thread's 8 reviews: the tail takes the byte path
    log("match_live_selectors_ragged",
        **check_match_at_size(int(stats["mask_rows"]), 4099))

    # 5. the sweep's reduction against the plain versions on the card
    from gatekeeper_tpu_torch.ops import driver as driver_mod

    (mask, K), _kw, packed = cap.calls["reduction"][0]
    assert packed.shape == (mask.shape[0], 1 + min(K, mask.shape[1]))
    assert packed.dtype == torch.int32 and bool((packed[:, 0] >= 0).all())
    with PlainVersions():
        side = driver._constraint_side()
        rv_d, cols_d = driver._audit_dev[1]
        plain_mask, _rej = driver._eval(
            side, rv_d, cols_d, driver._constraint_device(side))
        plain_packed = driver_mod.packed_reduction(plain_mask, K)
    torch.cuda.synchronize()
    if not torch.equal(plain_packed, packed):
        raise AssertionError("sweep reduction differs from the plain path")
    log("plain_path", equal=True, shape=list(packed.shape),
        candidates=int(packed[:, 0].sum().item()))
    del cap, plain_mask, plain_packed, packed, mask

    # 6. the incremental audit
    base_pods = syn.make_pods(args.pods, SEED + 1)
    churn = Churn([client], base_pods, SEED + 5)
    del base_pods
    gc.callbacks.append(pauses)
    gdev.reset_launches()
    # every call of K9's delta mode, K5 and K6 on this counted run is
    # recorded: a copy of the arguments before the call and of the result
    # after it, inside the sweep that makes it, from memory reserved here;
    # K1-K3 are recorded on the pass after it
    torch.empty(RECORD_RESERVE, dtype=torch.uint8, device=DEVICE)  # freed, kept
    with NoIR(), Capture(names=("program_delta", "delta",
                                "scatter")) as churn_cap:
        n_delta = churn_path(client, driver, churn, pauses)
    churn_launches = dict(gdev.launches)
    missing = [k for k in ("program_delta", "scatter", "match", "program")
               if churn_launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the incremental "
                             f"path: {missing}")
    # K9 once per evaluation, in its delta mode once per delta sweep (up
    # to the fold's row limit), and K5 only past that limit: on one card
    # the delta sweep's columns come from K9's launch
    want_k5 = sum(delta_launches(padded(d))["delta"] for d in CHURN_D) \
        * CHURN_SWEEPS
    if churn_launches["program"] + churn_launches["program_delta"] != \
            churn_launches["match"] or churn_launches["delta"] != want_k5 \
            or churn_launches["program_delta"] + want_k5 != n_delta:
        raise AssertionError(f"K9 is not one launch per evaluation, in its "
                             f"delta mode once per delta sweep ({n_delta}): "
                             f"{churn_launches}")
    log("churn_launches", main_path=churn_launches, delta_sweeps=n_delta)
    # K1 and K9 at the delta path's widths: one delta sweep for each d,
    # whose dirty rows pad to the same w = 8, 16 and 256 as the counted
    # run's
    with Capture(names=("match", "program")) as cap2:
        for d in CHURN_D:
            churn.step(d)
            client.audit_capped(CAP)
            assert driver.last_sweep_stats.get("delta_rows") == d
    gc.callbacks.remove(pauses)
    # K5 timed where it runs past the fold's row limit, at C = 1024 by w
    # (phase 9 times it at a shard's slab)
    past_limit = any(delta_launches(padded(d))["delta"] for d in CHURN_D)
    churn_rows = check_kernels(
        churn_cap, REPS,
        timed=("program_delta", "scatter") + (("delta",) if past_limit
                                              else ()))
    del churn_cap
    merge_rows(churn_rows, check_kernels(cap2, REPS, timed=()))
    merge_rows(churn_rows, check_kernels(cell_calls(cap2), REPS, timed=()))
    del cap2
    merge_rows(kernel_rows, churn_rows)
    log("device_split", **device_split(client, driver, churn))
    log("review_split", **review_split(client, driver))

    # 7. parity at a small size against the interpreter oracle
    t0 = time.perf_counter()
    small = syn.build_driver(args.parity_templates, args.parity_pods,
                             SEED)
    small.driver.DEVICE_MIN_CELLS = 0  # its reviews on the card
    oracle = syn.build_oracle(args.parity_templates, args.parity_pods,
                              SEED)
    s_resp, s_tot = small.audit_capped(CAP)
    o_resp, o_tot = oracle.audit_capped(CAP)
    s_sig = syn.audit_result_sig(s_resp.results())
    o_all = syn.audit_result_sig(oracle.audit().results())
    assert s_sig and set(s_sig) <= set(o_all), "capped results not exact"
    exact = [k for k, (_n, how) in s_tot.items() if how == "exact"]
    assert all(s_tot[k][0] == o_tot[k][0] for k in exact)
    assert syn.audit_result_sig(small.audit().results()) == o_all
    rpods = syn.make_pods(16, seed=SEED + 7, violation_rate=0.5)
    for i, p in enumerate(rpods):
        p["metadata"]["name"] = f"parity-{i}"

    def sig(resps):
        return [[(r.constraint["kind"], r.msg) for r in x.results()]
                for x in resps]

    assert sig(small.review_batch(rpods)) == sig(oracle.review_batch(rpods))
    # the uncapped audit after churn, through the delta path
    small_churn = Churn([small, oracle],
                        syn.make_pods(args.parity_pods, SEED + 1), SEED + 9)
    small_churn.step(16)
    u_sig = syn.audit_result_sig(small.audit().results())
    u_stats = dict(small.driver.last_sweep_stats)
    assert u_stats.get("delta_rows") == 16, u_stats
    assert u_sig == syn.audit_result_sig(oracle.audit().results())
    log("parity", seconds=time.perf_counter() - t0,
        templates=args.parity_templates, pods=args.parity_pods,
        results=len(s_sig), oracle_results=len(o_all),
        exact_totals=len(exact), uncapped_after_churn=len(u_sig),
        uncapped_stats=u_stats)
    del small, oracle, small_churn

    # 8. the referential audit
    t0 = time.perf_counter()
    rclient = syn.build_referential_driver(args.ref_templates,
                                           args.ref_objects, SEED)
    rdriver = rclient.driver
    assert rdriver.device.type == DEVICE
    ref_objs = syn.make_referential_objects(args.ref_objects, SEED + 1)
    log("build_referential", seconds=time.perf_counter() - t0,
        templates=args.ref_templates, objects=args.ref_objects,
        kinds={k: sum(1 for o in ref_objs if o["kind"] == k)
               for k in ("StorageClass", "Ingress", "PersistentVolumeClaim",
                         "Pod")})
    ref_churn = RefChurn(rclient, ref_objs, SEED + 11)
    del ref_objs
    gc.callbacks.append(pauses)
    gdev.reset_launches()
    with NoIR(), JoinIndexTimer(rdriver) as timer:
        cold_cap, delta_cap, _records = referential_path(
            rclient, rdriver, ref_churn, pauses, timer)
    ref_launches = dict(gdev.launches)
    gc.callbacks.remove(pauses)
    missing = [k for k in ("joinkeys", "joinlookup", "joinlookup_table",
                           "match", "program", "program_delta", "reduction",
                           "scatter")
               if ref_launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the referential "
                             f"path: {missing}")
    if ref_launches["program"] + ref_launches["program_delta"] != \
            ref_launches["match"]:
        raise AssertionError(f"K9 is not one launch per evaluation: "
                             f"{ref_launches}")
    log("ref_launches", main_path=ref_launches,
        plans=rdriver.join_plan_shapes())
    ref_rows = check_kernels(cold_cap, REPS, timed=("joinkeys", "joinlookup"))
    # K8's table mode, one launch for a delta sweep's lookups (the full
    # sweep's row above is its dense mode)
    merge_rows(ref_rows, check_kernels(delta_cap, REPS,
                                       timed=("joinlookup_table",),
                                       phase="kernel_table_mode"))
    merge_rows(kernel_rows, ref_rows)
    del cold_cap, delta_cap
    log("ref_device_split", **ref_device_split(rclient, rdriver, ref_churn))
    t0 = time.perf_counter()
    parity = ref_parity(*REF_PARITY)
    log("ref_parity", seconds=time.perf_counter() - t0, **parity)

    # 9. the sharded sweep
    t0 = time.perf_counter()
    mesh_rows, mesh_launches = mesh_phase(args, client, driver, churn,
                                          rclient, rdriver, ref_churn)
    missing = [k for k in ("match", "program", "reduction", "delta",
                           "scatter", "joinkeys", "joinkeys_merge",
                           "joinlookup") if mesh_launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the sharded "
                             f"sweep: {missing}")
    merge_rows(kernel_rows, mesh_rows)
    log("mesh", seconds=time.perf_counter() - t0)
    del rclient, rdriver, ref_churn
    gc.collect()

    # 10. the process: gatekeeper_tpu_torch.main.App on the card
    t0 = time.perf_counter()
    process_launches, process = process_phase(
        args, client, driver, churn, pods, batch, review_sigs, batch_sigs,
        {name: kernel_rows[name]["ms"] for name in PATH1_KERNELS})
    log("process", seconds=time.perf_counter() - t0)

    # 11. the restart: snapshots, warm resume and the kernels' cache
    t0 = time.perf_counter()
    restart_launches = restart_phase(args, client, churn, process)
    log("restart", seconds=time.perf_counter() - t0)

    # 12. the fleet: webhook replicas restoring phase 10's snapshot with
    # phase 11's sealed kernels; K1, K9 and K10 held at the stream's shape
    t0 = time.perf_counter()
    fleet_launches, fleet_cap = fleet_phase(
        args, client, pods, review_sigs, batch, batch_sigs, process, smi)
    merge_rows(kernel_rows, check_kernels(
        fleet_cap, REPS, timed=("match", "program_pack", "packbits"),
        phase="kernel_fleet"))
    del fleet_cap
    log("fleet", seconds=time.perf_counter() - t0)

    # 13. the serving seam: the calibration, the memo and the breaker
    t0 = time.perf_counter()
    serving_launches = serving_phase(client, driver, smi)
    log("serving", seconds=time.perf_counter() - t0)

    # 14. the wire: two Apps against an API server in a child process
    t0 = time.perf_counter()
    wire_launches = wire_phase(args, pods, process)
    log("wire_phase", seconds=time.perf_counter() - t0)

    # 15. the tiers: phase 3's admissions priced over three tiers
    t0 = time.perf_counter()
    tiers_launches = tiers_phase(args, client, driver, smi)
    log("tiers", seconds=time.perf_counter() - t0)

    # 16. the operator's drills on the card, over kernels baked as
    # Dockerfile.torch bakes them
    t0 = time.perf_counter()
    drills_launches = drills_phase(smi)
    log("drills", seconds=time.perf_counter() - t0, nvidia_smi=smi)
    for name, row in kernel_rows.items():
        row["launches"] = (launches[name] + churn_launches[name]
                           + ref_launches[name] + mesh_launches[name]
                           + process_launches[name]
                           + restart_launches[name] + fleet_launches[name]
                           + serving_launches[name] + wire_launches[name]
                           + tiers_launches[name] + drills_launches[name])
    log("checked", calls={k: r["calls_checked"]
                          for k, r in kernel_rows.items()})

    print(json.dumps({"kernels": [
        {k: row[k] for k in ("name", "route", "source", "replaces",
                             "launches", "max_abs_err", "ms", "plain_ms",
                             "bound_ms", "bound_by", "library_ms")}
        for row in kernel_rows.values()
    ]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
