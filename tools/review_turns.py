#!/usr/bin/env python3
"""Time admission reviews of one checkout of gatekeeper_tpu_torch on a CUDA
card, so that two checkouts can be compared in turns on one card.

    python3 tools/review_turns.py --root DIR [--templates 500]
                                  [--pods 100000] [--reviews 256]

DIR holds a checkout's gatekeeper_tpu_torch/ (this tree, or an earlier
commit unpacked with git archive into a git-ignored directory).  The script
builds DIR's kernels and drives DIR's TorchDriver as chip_smoke.py's phase 3
does: the synthetic store of 500 templates x 100,000 pods, a cold capped
sweep, then --reviews admission reviews of unique pods (the same seeded
pods as phase 3), each timed on the host clock around client.review.  It
prints one JSON line: the card as nvidia-smi names it with its power
limit, DIR, the p50, p99 (nearest rank) and max in ms, and the launches
per review.  Run it old, new, new, old in one command to compare:

    for r in build/parent . . build/parent; do
        python3 tools/review_turns.py --root $r; done
"""

from __future__ import annotations

import argparse
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
    pods = syn.make_pods(args.reviews, seed=cs.SEED + 99,
                         violation_rate=0.5)
    gdev.reset_launches()
    lat = []
    for i, pod in enumerate(pods):
        pod["metadata"]["name"] = f"admission-{i}"
        t0 = time.perf_counter()
        client.review(pod)
        lat.append((time.perf_counter() - t0) * 1e3)
    print(json.dumps({
        "root": args.root, "card": cs.nvidia_smi_line(),
        "torch_name": torch.cuda.get_device_name(0), "n": len(lat),
        "p50_ms": statistics.median(lat), "p99_ms": cs.percentile(lat, 99),
        "max_ms": max(lat),
        "launches_per_review": {k: v / len(lat)
                                for k, v in gdev.launches.items() if v},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
