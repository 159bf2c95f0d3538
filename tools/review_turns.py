#!/usr/bin/env python3
"""Time admission reviews of one checkout of gatekeeper_tpu_torch on a CUDA
card, so that two checkouts can be compared in turns on one card.

    python3 tools/review_turns.py --root DIR [--templates 500]
                                  [--pods 100000] [--reviews 256]
                                  [--sweeps 10] [--freeze]
                                  [--stream 8192] [--model]

DIR holds a checkout's gatekeeper_tpu_torch/ (this tree, or an earlier
commit unpacked with git archive into a git-ignored directory).  The script
builds DIR's kernels and drives DIR's TorchDriver as chip_smoke.py's phase 3
does: the synthetic store of 500 templates x 100,000 pods, a cold capped
sweep, then --reviews admission reviews of unique pods (the same seeded
pods as phase 3), each timed on the host clock around client.review.  It
prints one JSON line: the card as nvidia-smi names it with its power
limit, DIR, the p50, p99 (nearest rank) and max in ms, and the launches
per review, and the collector's pauses in the reviews (chip_smoke's
GcPauses).  --sweeps N then times N warm full capped sweeps of the
unchanged store (each forced full, as chip_smoke's warm sweeps are): the
median and worst wall, the median of each of last_sweep_stats'
pack_ms, device_ms and render_ms, and the collector's pauses inside
them.  --freeze moves every object alive after the cold sweep out of
the collector's generations (gc.freeze(), as chip_smoke's
warm_sweeps_gc_frozen does) before the reviews and sweeps, so a full
collection over the stored inventory lands in neither.  --stream N then times N reviews of the stored pods in chunks
of 2,048 through review_batch, after one warm-up chunk, as a fleet
replica's ``stream`` command does (reviews/s).  --model, where DIR's
driver has calibrate_routing, calibrates it and prints its
predicted_batch_ms beside the median wall of 8 review_batch calls of
fresh pods at 1, 8 and 64 reviews, for pods flagged at the stored
corpus's rate (0.05) and at 0.5.  Run it old, new, new, old in one
command to compare:

    for r in build/parent . . build/parent; do
        python3 tools/review_turns.py --root $r; done
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import os
import statistics
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke():
    """This tree's chip_smoke.py (DIR may hold an older one)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_here", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", required=True)
    ap.add_argument("--templates", type=int, default=500)
    ap.add_argument("--pods", type=int, default=100_000)
    ap.add_argument("--reviews", type=int, default=256)
    ap.add_argument("--sweeps", type=int, default=0)
    ap.add_argument("--freeze", action="store_true")
    ap.add_argument("--stream", type=int, default=0)
    ap.add_argument("--model", action="store_true")
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("review_turns: no CUDA card visible", file=sys.stderr)
        return 1
    cs = _chip_smoke()
    from gatekeeper_tpu_torch import device as gdev
    from gatekeeper_tpu_torch.util import synthetic as syn

    if not os.path.abspath(gdev.__file__).startswith(root + os.sep):
        raise AssertionError(f"imported {gdev.__file__}, not from {root}")
    gdev.build_kernels()
    gdev.kernels()
    client = syn.build_driver(args.templates, args.pods, cs.SEED)
    client.audit_capped(cs.CAP)
    if args.freeze:
        gc.collect()
        gc.freeze()
    pods = syn.make_pods(args.reviews, seed=cs.SEED + 99,
                         violation_rate=0.5)
    gdev.reset_launches()
    lat = []
    pauses = cs.GcPauses()
    gc.callbacks.append(pauses)
    try:
        for i, pod in enumerate(pods):
            pod["metadata"]["name"] = f"admission-{i}"
            t0 = time.perf_counter()
            client.review(pod)
            lat.append((time.perf_counter() - t0) * 1e3)
    finally:
        gc.callbacks.remove(pauses)
    out = {
        "root": args.root, "card": cs.nvidia_smi_line(),
        "torch_name": torch.cuda.get_device_name(0), "n": len(lat),
        "p50_ms": statistics.median(lat), "p99_ms": cs.percentile(lat, 99),
        "max_ms": max(lat),
        "launches_per_review": {k: v / len(lat)
                                for k, v in gdev.launches.items() if v},
        "gc": pauses.take(), "frozen": args.freeze,
    }
    if args.sweeps:
        out["sweeps"] = sweeps(client, args.sweeps, cs)
    if args.stream:
        out["stream"] = stream(client.driver, args.stream, 2048)
    if args.model:
        out["model"] = model(client.driver, syn, cs.SEED)
    print(json.dumps(out), flush=True)
    return 0


def sweeps(client, n: int, cs) -> dict:
    """n warm full capped sweeps of the unchanged store -> the walls'
    median and worst (ms), the median of each stage, and the collector's
    pauses inside them (the median of the walls of sweeps with none)."""
    driver = client.driver
    walls, stages = [], {"pack_ms": [], "device_ms": [], "render_ms": []}
    pauses, paused = cs.GcPauses(), []
    gc.callbacks.append(pauses)
    try:
        for _ in range(n):
            cs.force_full(driver)
            pauses.reset()
            t0 = time.perf_counter()
            client.audit_capped(cs.CAP)
            walls.append((time.perf_counter() - t0) * 1e3)
            paused.append(pauses.ms)
            for k, v in stages.items():
                v.append(driver.last_sweep_stats[k])
    finally:
        gc.callbacks.remove(pauses)
    calm = [w for w, g in zip(walls, paused) if not g]
    return {"n": n, "median_ms": statistics.median(walls),
            "worst_ms": max(walls),
            **{f"median_{k}": statistics.median(v)
               for k, v in stages.items()},
            "gc_ms": sum(paused), "sweeps_without_gc": len(calm),
            "median_ms_without_gc": statistics.median(calm) if calm
            else None}


def stream(driver, n: int, chunk: int) -> dict:
    """n admission reviews of the stored pods in chunks through
    review_batch, after one warm-up chunk -> the seconds and reviews/s."""
    objs = [rv["object"] for rv in driver._audit_pack.reviews
            if isinstance(rv, dict) and isinstance(rv.get("object"), dict)]
    objs = objs[:4096]
    reqs = [{"uid": f"stream-{i}",
             "kind": {"group": "", "version": "v1", "kind": o["kind"]},
             "name": o["metadata"]["name"],
             "namespace": o["metadata"].get("namespace", ""),
             "operation": "CREATE", "object": o}
            for i, o in enumerate(objs)]

    def batch_of(start: int, size: int) -> list:
        return [reqs[(start + j) % len(reqs)] for j in range(size)]

    driver.review_batch(batch_of(0, chunk))
    t0 = time.perf_counter()
    done = 0
    while done < n:
        size = min(chunk, n - done)
        driver.review_batch(batch_of(done, size))
        done += size
    s = time.perf_counter() - t0
    return {"n": n, "chunk": chunk, "s": s, "reviews_per_s": n / s}


def model(driver, syn, seed: int):
    """calibrate_routing, then predicted_batch_ms beside measured walls of
    fresh pods -> the model, its wall and the comparison; None where the
    driver has no calibrate_routing."""
    if not hasattr(driver, "calibrate_routing"):
        return None
    t0 = time.perf_counter()
    cal = driver.calibrate_routing()
    out = {"calibration": cal,
           "calibration_ms": (time.perf_counter() - t0) * 1e3, "walls": []}
    for rate in (0.05, 0.5):
        for n in (1, 8, 64):
            pods = syn.make_pods(8 * n, seed=seed + 300 + n,
                                 violation_rate=rate)
            walls = []
            for j in range(8):
                batch = []
                for k, p in enumerate(pods[j * n:(j + 1) * n]):
                    p["metadata"]["name"] = f"model-{rate}-{n}-{j}-{k}"
                    batch.append({
                        "uid": p["metadata"]["name"],
                        "kind": {"group": "", "version": "v1",
                                 "kind": "Pod"},
                        "name": p["metadata"]["name"],
                        "namespace": p["metadata"].get("namespace",
                                                       "default"),
                        "operation": "CREATE", "object": p})
                t1 = time.perf_counter()
                driver.review_batch(batch)
                walls.append((time.perf_counter() - t1) * 1e3)
            p50 = statistics.median(walls)
            pred = driver.predicted_batch_ms(n)
            out["walls"].append({"rate": rate, "reviews": n,
                                 "predicted_ms": pred, "p50_ms": p50,
                                 "ratio": pred / p50})
    return out


if __name__ == "__main__":
    sys.exit(main())
