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
     the synthetic corpus at 500 ConstraintTemplates x 100,000 Pods, a cold
     audit_capped(20), warm sweeps (each one's stages and garbage-collector
     pauses, then as many again with the collector's old objects frozen),
     and admission reviews of unique pods (each one's constraint-side
     re-pack split out); K1, K9, K4 and K9's review mode must have
     launched on that run, K9 exactly once per evaluation (once a sweep,
     and once a review in its review mode, where it packs the review's
     masks in the same launch), K10 never on a review (its side has
     groups) and never in a sweep, and vexpr.eval_program never (NoIR).
     Then the same reviews again and one batch of 256 pods, K9's packing
     calls recorded
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
  8. the referential audit, the third path: 24 referential templates
     (unique ingress hosts, required storage classes, per-team pod
     quotas) x 100,000 objects.  A cold sweep (K7 builds each join plan's
     key table, K8 looks each cell's count up), checked on the spot: each
     device table against the host join index of the same sweep, and the
     [C, 1+K] reduction against the all-plain path; warm forced full
     sweeps before and after gc.freeze(); churn sweeps through the join
     delta path, key-neutral and key-moving, for d in 1 and 16, each d
     closed by a forced full sweep that must equal it; one churn of a Pod
     of the crowded team, whose readers exceed DELTA_MAX_ROWS at this size,
     which must take the full path.  Each sweep logs its stages, rendered cells,
     results, join-affected rows and the join index's host time.  Each
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
     bit for bit, K1, K9 and K4 launched once a shard, K7 once a shard
     and its merge once a join plan; churn of d = 1 and 16 through the
     delta path, delta_rows the dirty rows (with the readers of the key
     groups they touch), delta_shards and K5's launches their owning
     shards (K9's delta mode none: each slab of the resident mask is
     gathered on its own shard), the synthetic corpus's added pods in the padded tail of the
     last slab, each d closed by a forced full sweep (K6 on the owning
     shards) that must equal it.  Every K4 call (row_offset) and K7 merge
     call of that run is held against its plain version and timed at its
     largest call, and K5 too, whose only launches on the counted paths
     these are.  Then reviews under the mesh: compute_masks of 4,096
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
     sync; a cold audit cycle and warm ones; phase 3's 256 pods as
     admission requests one at a time over one keep-alive HTTPS
     connection, its batch pods from 8 client threads of 32 requests, and
     64 requests sent while a forced full audit cycle holds the driver
     (each answer equal to phase 3's results for its pod, none an error,
     K1 and K9's review mode launched once for each review_batch call);
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

The line before the last holds the card's name and power limit as
nvidia-smi gives them, and the line before that the kernels' JSON; the
last line is {"ok": true, "device": {...}}.  Without a CUDA card, or run
from a directory that lacks the package, it prints no result and exits 1.
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


def log(phase: str, **fields):
    print(f"[{phase}] " + json.dumps(fields, sort_keys=True, default=str),
          flush=True)


class GcPauses:
    """A gc.callbacks hook: the pause time and the full (generation 2)
    collections since the last reset (``total_ms``: since it was made)."""

    def __init__(self):
        self._t0 = None
        self.total_ms = 0.0
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

    def take(self) -> dict:
        """The pauses since the last reset, then reset."""
        out = {"gc_ms": self.ms, "gc_max_ms": self.max_ms,
               "gc_gen2": self.gen2}
        self.reset()
        return out


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
    if rec["path"] != "full" or not results or rec["join_plans"] != 3:
        raise AssertionError(f"cold referential sweep: {rec}")
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
    for d in REF_CHURN_D:
        sweeps = []
        for kind in ("neutral", "moving"):
            for i in range(REF_CHURN_SWEEPS):
                ops = getattr(churn, kind)(d)
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
                if rec["path"] != "delta" or rec["delta_rows"] < d or \
                        rec["launches"] != want:
                    raise AssertionError(f"ref churn d={d}: {rec}, "
                                         f"want {want}")
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
    want = {"match": width, "program": width, "reduction": width}
    if plans:
        want.update(joinkeys=width * plans, joinkeys_merge=plans)
    recs = []
    for which in ("cold",) + ("warm",) * WARM:
        if which == "warm":
            force_full(driver)
        before = dict(_dev().launches)
        t0 = time.perf_counter()
        resp, totals = client.audit_capped(CAP)
        wall = time.perf_counter() - t0
        st = dict(driver.last_sweep_stats)
        got = {k: _dev().launches[k] - before[k] for k in want}
        equal = _equal_to(ref, resp, totals, driver)
        rec = {"config": label, "width": width, "sweep": which, "s": wall,
               "launches": got, "equal_to_width_1": equal,
               **{k: st.get(k) for k in (
                   "pack_ms", "device_ms", "render_ms", "shards",
                   "rows_per_shard", "padded_rows", "upload_bytes",
                   "join_plans")}}
        if not all(equal.values()) or got != want \
                or st.get("shards") != width or "delta_rows" in st:
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
    want = _review_bytes(client.review_batch(copy.deepcopy(pods)))
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
PROCESS_WARM = 3
PROCESS_CHURN_D = (1, 16)
PROCESS_CHURN_CYCLES = 2
# the longest the App may take from construction to /readyz
PROCESS_READY_S = 600
# the kernels phase 10's run must launch: reviews (K1, K9 packing), full
# sweeps (K9, K4), delta sweeps (K9's delta mode) and the full sweep after
# churn (K6)
PROCESS_KERNELS = ("match", "program", "program_pack", "reduction",
                   "program_delta", "scatter")
POD_GVK = ("", "v1", "Pod")


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
    """Wraps the App driver's review_batch and compute_masks: each review
    batch's results by request uid and its size, and the launches each
    review evaluation made.  compute_masks runs under the driver's lock, so
    no sweep's launches fall inside it."""

    def __init__(self, driver):
        self.driver = driver
        self.sizes, self.results, self.per_eval = [], {}, []
        self._batch = driver.review_batch
        self._masks = driver.compute_masks
        driver.review_batch = self.review_batch
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


def process_phase(args, client, driver, churn, pods, batch, review_sigs,
                  batch_sigs) -> dict:
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
             "--snapshot-dir", snap_dir, "--snapshot-interval", "86400"]
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
        log("process_burst", clients=n_threads, requests=len(burst),
            seconds=burst_s, requests_per_s=len(burst) / burst_s,
            p50_ms=statistics.median(burst_lat),
            p99_ms=percentile(burst_lat, 99), max_ms=max(burst_lat),
            batches=len(sizes), batch_sizes=sorted(sizes),
            mean_batch=len(burst) / len(sizes), **pauses.take())

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
            want[uid] = review_sigs[i]
            answers[uid], ms = admit(conn, uid, pods[i])
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
        evals = spy.per_eval
        want_eval = {"match": 1, "program_pack": 1}
        bad = [e for e in evals if e != want_eval]
        if bad or len(evals) != len(spy.sizes):
            raise AssertionError(f"a review evaluation launched {bad[:3]}: "
                                 f"K1 and K9's review mode once each for "
                                 f"each of {len(spy.sizes)} review_batch "
                                 f"calls ({len(evals)} evaluations)")
        log("process_admission", requests=len(answers), denied=denied,
            review_batch_calls=len(spy.sizes), evaluations=len(evals),
            launches_per_evaluation=want_eval)

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
    if launches["packbits"] or launches["delta"]:
        raise AssertionError(f"K10 or K5 launched in the process: "
                             f"{launches}")
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
                      "written": written}


# ---- phase 11: the restart (snapshots, warm resume, the kernels' cache) ----

# pods changed in the store while the App is down
RESTART_D = 16
# the mesh restores' depth: a synthetic store of (templates, pods)
RESTART_MESH = (24, 20_000)
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
    """Construct and start an App over ``kube`` and wait until it serves
    and holds the store's pods -> (app, its marks: construction, start,
    and the seconds from construction to each readiness mark)."""
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
    got = {k: v for k, v in launches.items() if v}
    if got != want_launch:
        raise AssertionError(f"the restored App's first cycle launched "
                             f"{got}, not K1 and K9's delta mode once")
    loader = spy.calls[0]["loader"]
    log("restart_app", restore_s=spy.calls[0]["s"], resync=loader.stats,
        delta_restored=loader.delta_restored, churn=ops,
        warm_marks=warm, cold_ready_s=process["ready_s"],
        start_split=split.split(), gc_until_ready=ready_gc,
        first_cycle=rec, launches=launches, mask_equal_on_card=True)
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
                    driver._inventory_for_render())
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
    ap.add_argument("--ref-templates", type=int, default=24)
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

    if args.profile:
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
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
    # recorded (the counted loop is not, so its latencies carry no copies),
    # then one batch of REVIEWS pods (R = 256)
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
        args, client, driver, churn, pods, batch, review_sigs, batch_sigs)
    log("process", seconds=time.perf_counter() - t0)

    # 11. the restart: snapshots, warm resume and the kernels' cache
    t0 = time.perf_counter()
    restart_launches = restart_phase(args, client, churn, process)
    log("restart", seconds=time.perf_counter() - t0)
    for name, row in kernel_rows.items():
        row["launches"] = (launches[name] + churn_launches[name]
                           + ref_launches[name] + mesh_launches[name]
                           + process_launches[name]
                           + restart_launches[name])
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
