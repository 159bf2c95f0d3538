#!/usr/bin/env python3
"""Time kernels of one checkout of gatekeeper_tpu_torch on a CUDA card, so
that two checkouts can be compared in turns on one card.

    python3 tools/kernel_turns.py --root DIR [--kernels match,program]
                                  [--per-group]
    python3 tools/kernel_turns.py --root DIR --corpus referential

DIR holds a checkout's gatekeeper_tpu_torch/ (this tree, or an earlier
commit unpacked with git archive into a git-ignored directory).  The script
builds DIR's kernels, drives DIR's TorchDriver through chip_smoke.py's main
path (500 templates x 100,000 pods, a cold capped sweep, then one one-pod
admission review), records the calls of the kernels named in --kernels
(any that chip_smoke.Capture records and this path launches: match,
program, reduction), and for the largest call of the sweep and of the
review checks each kernel against its plain version exactly and takes its
median time over CUDA events (chip_smoke.cuda_ms, with an in-place output
restored outside the events).  Where match is named, K1 is timed once more
at the sweep's shape on the seeded corpus whose selectors are live
(chip_smoke.check_match_at_size); with --per-group, K9 on each group of
the sweep alone too.  The checks and timings are this tree's
chip_smoke.kernel_specs(), so DIR's wrappers must take the arguments that
this tree's take; one that does not fails its call.  It prints one JSON
line: the card as nvidia-smi names it with its power limit, DIR, ptxas's
register and spill report for each kernel, the shapes and the times in ms.
Run it old, new, new, old in one command to compare:

    for r in build/parent . . build/parent; do
        python3 tools/kernel_turns.py --root $r; done

With --corpus referential it drives chip_smoke.py's referential path
instead (24 referential templates x 100,000 objects, REF_r14's templates)
and times the join kernels (default --kernels
joinkeys,joinkeys_merge,joinlookup): a full device sweep (the driver's
_audit_sweep, no render) records K7 and K8 ("full_"; K8 in the mode the
full sweep takes), one key-moving delta sweep of 16 objects records K8
on the host index's tables ("delta_", table mode), and a full sweep on a
width-2 mesh of the one card (GK_VIRTUAL_DEVICES) records K7's merge
("mesh_").

Two more names on the synthetic corpus.  ``scatter`` records K6 on a full
sweep after 256 changed pods with the delta path off ("churn_full_").
``review_chain`` times the review's device chain as one unit on batches
of 1, 16, 32, 64 and 256 pods (R = 8 to 256; "review_chain_<n>_pods"):
program_eval with the pack where the checkout's driver asks for it, else
K9 then K10 as an earlier checkout's driver runs them (its wrappers lack
the pack argument, so the trees compare only as chains); for the packing
checkout, K9 then K10 on the same inputs and the fused launch with its
row limit lifted are timed beside it.  ``delta_chain`` times the delta
sweep's program step as one unit after churn of 1, 16, 64, 128 and 256
pods (w = 8 to 256; "delta_chain_w<w>"): program_eval with ``delta``
(K9 writing the before | after columns in its launch) where the
checkout's driver asks for it, else K9 then K5 as the checkout's driver
runs them; for the folding checkout, K9 then K5 on the same inputs is
timed beside it, and past its row limit the fused launch with the limit
lifted.  With --corpus referential, ``joinlookup`` also times
the key-moving delta sweep's table-mode lookups as one chain
("delta_lookup_chain": each (plan, exclude_self) lookup in a launch of
its own where the checkout launches them so, one join_lookup_many launch
where it launches that), and its largest lookup alone
("delta_one_lookup").
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke():
    """This tree's chip_smoke.py (DIR may hold an older one)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_here", os.path.join(HERE, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# the review batches whose device chain review_chain times: a one-pod
# review (R = 8) and batches of 16, 32, 64 and 256 pods
CHAIN_PODS = (1, 16, 32, 64, 256)
# the churn whose delta sweep's program step delta_chain times: w = 8, 16,
# 64, 128 and 256
DELTA_CHAIN_D = (1, 16, 64, 128, 256)


def synthetic_runs(cs, syn, args, names) -> list:
    """A cold capped sweep, a one-pod review, with review_chain batches
    of CHAIN_PODS pods, with delta_chain a delta sweep after churn of each
    of DELTA_CHAIN_D pods, and with scatter a full sweep after 256 changed
    pods with the delta path off -> [(label, Capture)]."""
    client = syn.build_driver(args.templates, args.pods, cs.SEED)
    with cs.Capture(names=names) as sweep:
        client.audit_capped(cs.CAP)
    pod = syn.make_pods(1, seed=cs.SEED + 98, violation_rate=1.0)[0]
    pod["metadata"]["name"] = "admission-timed"
    with cs.Capture(names=names) as review:
        client.review(pod)
    runs = [("sweep", sweep), ("review", review)]
    if "review_chain" in names:
        for n in CHAIN_PODS:
            pods = syn.make_pods(n, seed=cs.SEED + 500 + n,
                                 violation_rate=0.5)
            for i, p in enumerate(pods):
                p["metadata"]["name"] = f"chain-{n}-{i}"
            with cs.Capture(names=("program", "program_pack",
                                   "packbits")) as cap:
                client.review_batch(pods)
            runs.append((f"chain{n}", cap))
    churn = None
    if "delta_chain" in names:
        driver = client.driver
        churn = cs.Churn([client], syn.make_pods(args.pods, cs.SEED + 1),
                         cs.SEED + 5)
        for d in DELTA_CHAIN_D:
            churn.step(d)
            with cs.Capture(names=("program", "program_delta",
                                   "delta")) as cap:
                client.audit_capped(cs.CAP)
            if driver.last_sweep_stats.get("delta_rows") != d:
                raise AssertionError(f"delta chain d={d}: "
                                     f"{driver.last_sweep_stats}")
            runs.append((f"delta{cs.padded(d)}", cap))
    if "scatter" in names:
        driver = client.driver
        churn = churn or cs.Churn(
            [client], syn.make_pods(args.pods, cs.SEED + 1), cs.SEED + 5)
        churn.step(256)
        driver.delta_enabled = False
        with cs.Capture(names=("scatter",)) as full:
            client.audit_capped(cs.CAP)
        driver.delta_enabled = True
        if not full.calls["scatter"]:
            raise AssertionError("the full sweep after churn ran no K6")
        runs.append(("churn_full", full))
    return runs


def review_chain(cs, cap, reps: int) -> dict:
    """The review's device chain as one unit, on the inputs of the
    recorded review: K9 packing in its launch where this checkout's
    driver asks it to (program_eval with ``pack``), else K9 then K10, as
    the checkout's driver ran them; checked against the plain versions.
    For a checkout that packs in K9, K9 then K10 on the same inputs and
    the fused launch with its row limit lifted are timed beside it."""
    import torch

    from gatekeeper_tpu_torch.ops import packbits, program

    if cap.calls["program_pack"]:
        [(a, kw, _out)] = cap.calls["program_pack"]
        p = cs._program_pack_prep(a, kw)
        reset = (lambda: cs._program_reset(p, "kernel"))
        reset()
        got = cs._program_pack_kernel(p)
        want = cs._program_pack_plain(p)
        torch.cuda.synchronize()
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError("review chain: K9's pack != plain")
        rec = {"chain": "k9_pack",
               "ms": cs.cuda_ms(lambda: cs._program_pack_kernel(p), reps,
                                setup=reset),
               "k9_then_k10_ms": cs.cuda_ms(lambda: cs._k9_then_k10(p),
                                            reps, setup=reset),
               "fused_forced_ms": cs.cuda_ms(lambda: cs._forced_fold(p),
                                             reps, setup=reset)}
    else:
        [(a, kw, _out)] = cap.calls["program"]
        [((_after, autoreject), _kw, _packed)] = cap.calls["packbits"]
        p = cs._program_prep(a, kw)

        def chain():
            program.program_eval_cuda(p["kernel"], p["groups"])
            return packbits.pack_review_masks_cuda(p["kernel"], autoreject)

        reset = (lambda: cs._program_reset(p, "kernel"))
        reset()
        got = chain()
        program.program_eval_plain(p["plain"], p["groups"])
        want = packbits.pack_review_masks_plain(p["plain"], autoreject)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError("review chain: K9 then K10 != plain")
        rec = {"chain": "k9_then_k10",
               "ms": cs.cuda_ms(chain, reps, setup=reset)}
    rec["shape"] = list(p["pre"].shape)
    return rec


def delta_chain(cs, cap, reps: int) -> dict:
    """The delta sweep's program step as one unit, on the inputs of the
    recorded delta sweep: K9 writing the columns in its launch where this
    checkout's driver asks it to (program_eval with ``delta``), else K9
    then K5, as the checkout's driver ran them; checked against the plain
    versions.  For a checkout that folds, K9 then K5 on the same inputs is
    timed beside it, and past its row limit (where program_eval runs K9
    then K5) the fused launch with the limit lifted."""
    import torch

    from gatekeeper_tpu_torch.ops import delta, program

    if cap.calls.get("program_delta"):
        [(a, kw, _out)] = cap.calls["program_delta"]
        p = cs._program_delta_prep(a, kw)
        chain, name = (lambda: cs._program_delta_kernel(p)[1]), "k9_delta"
    else:
        [(a, kw, _out)] = cap.calls["program"]
        [((resident, idx, _new), _kw, _cols)] = cap.calls["delta"]
        p = cs._program_prep(a, kw)
        p.update(resident=resident, idx=idx)
        chain, name = (lambda: cs._k9_then_k5(p)), "k9_then_k5"
    reset = (lambda: cs._program_reset(p, "kernel"))
    reset()
    got = chain()
    want = delta.delta_columns_plain(
        p["resident"], p["idx"],
        program.program_eval_plain(p["plain"], p["groups"]))
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        raise AssertionError(f"delta chain: {name} != plain")
    rec = {"chain": name, "ms": cs.cuda_ms(chain, reps, setup=reset)}
    if name == "k9_delta":
        rec["k9_then_k5_ms"] = cs.cuda_ms(lambda: cs._k9_then_k5(p), reps,
                                          setup=reset)
    if name == "k9_delta" and \
            p["pre"].shape[1] > program.DELTA_IN_K9_MAX_ROWS:
        rec["routed"] = "k9_then_k5"  # the driver's route past the limit

        def forced():
            with cs.FoldAtEveryR("DELTA_IN_K9_MAX_ROWS"):
                return cs._program_delta_kernel(p)[1]

        reset()
        if not torch.equal(forced(), want):
            raise AssertionError("delta chain: the forced fold != plain")
        rec["fused_forced_ms"] = cs.cuda_ms(forced, reps, setup=reset)
    rec["shape"] = list(p["pre"].shape)
    return rec


def lookup_chain(cs, cap, reps: int) -> dict:
    """A delta sweep's table-mode lookups as one unit: its recorded
    join_lookup_many call (one launch) where the checkout makes one, else
    its join_lookup calls (a launch each) in turn; checked against the
    plain version.  And the largest lookup alone (join_lookup_cuda)."""
    import torch

    from gatekeeper_tpu_torch.ops import joinlookup

    if cap.calls.get("joinlookup_table"):
        [((lookups,), _kw, _out)] = cap.calls["joinlookup_table"]
        chain = (lambda: joinlookup.join_lookup_many_cuda(lookups))
        name = "one_launch"
    else:
        lookups = [a for a, _kw, _out in cap.calls["joinlookup"]]
        chain = (lambda: [joinlookup.join_lookup_cuda(*lk)
                          for lk in lookups])
        name = "a_launch_a_lookup"
    got = chain()
    want = [joinlookup.join_lookup_plain(*lk) for lk in lookups]
    torch.cuda.synchronize()
    if not all(torch.equal(g, w) for g, w in zip(got, want)):
        raise AssertionError(f"delta lookup chain: {name} != plain")
    big = max(lookups, key=lambda lk: lk[2].numel())
    return {"chain": name, "lookups": len(lookups),
            "queries": [lk[2].numel() for lk in lookups],
            "ms": cs.cuda_ms(chain, reps),
            "one_lookup_ms": cs.cuda_ms(
                lambda: joinlookup.join_lookup_cuda(*big), reps)}


def referential_runs(cs, syn, args, names) -> list:
    """A full device sweep, a key-moving delta sweep of 16 objects, and a
    full sweep on a width-2 mesh of the one card, each without its render
    -> [(label, Capture)]."""
    from gatekeeper_tpu_torch.parallel import mesh as pm

    client = syn.build_referential_driver(args.templates, args.pods,
                                          cs.SEED)
    driver = client.driver
    churn = cs.RefChurn(client,
                        syn.make_referential_objects(args.pods, cs.SEED + 1),
                        cs.SEED + 11)
    K = driver._audit_topk(cs.CAP)
    with cs.Capture(names=names) as full:
        if driver._audit_sweep(K) is None:
            raise AssertionError("referential sweep: empty inventory")
    churn.moving(16)
    delta_names = names + ("joinlookup_table",) if "joinlookup" in names \
        else names
    with cs.Capture(names=delta_names) as delta:
        if driver._try_delta(K) is None:
            raise AssertionError("the key-moving churn took no delta sweep")
    os.environ[pm.VIRTUAL_DEVICES_ENV] = "2"
    driver.set_mesh(True, width=2)
    try:
        cs.force_full(driver)
        with cs.Capture(names=names) as mesh:
            driver._audit_sweep(K)
        if driver.last_sweep_stats.get("shards") != 2.0:
            raise AssertionError(f"mesh sweep: {driver.last_sweep_stats}")
    finally:
        driver.set_mesh(False)
        del os.environ[pm.VIRTUAL_DEVICES_ENV]
    return [("full", full), ("delta", delta), ("mesh", mesh)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", required=True)
    ap.add_argument("--corpus", choices=("synthetic", "referential"),
                    default="synthetic")
    ap.add_argument("--kernels", default=None,
                    help="default match,program (synthetic) or "
                    "joinkeys,joinkeys_merge,joinlookup (referential); "
                    "synthetic also takes scatter, program_pack and "
                    "review_chain, delta_chain")
    ap.add_argument("--templates", type=int, default=None,
                    help="default 500 (synthetic) or 24 (referential)")
    ap.add_argument("--pods", type=int, default=100_000,
                    help="pods, or the referential corpus's objects")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--per-group", action="store_true",
                    help="also time K9 on each group of the sweep alone")
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("kernel_turns: no CUDA card visible", file=sys.stderr)
        return 1
    cs = _chip_smoke()
    ref = args.corpus == "referential"
    if args.kernels is None:
        args.kernels = ("joinkeys,joinkeys_merge,joinlookup" if ref
                        else "match,program")
    if args.templates is None:
        args.templates = 24 if ref else 500
    names = tuple(args.kernels.split(","))
    specs = cs.kernel_specs()
    recorded = {name for _m, _f, name in cs.Capture.SITES}
    recorded |= {m for modes in cs.Capture.MODES.values()
                 for m in modes.values()}
    for name in names:
        if name in ("review_chain", "delta_chain") and not ref:
            continue
        if name not in specs or name not in recorded:
            ap.error(f"--kernels: {name} is not a kernel that chip_smoke "
                     f"records (one of {sorted(recorded)}) or "
                     f"review_chain or delta_chain")
    from gatekeeper_tpu_torch import device as gdev
    from gatekeeper_tpu_torch.ops import program
    from gatekeeper_tpu_torch.util import synthetic as syn

    if not os.path.abspath(gdev.__file__).startswith(root + os.sep):
        raise AssertionError(f"imported {gdev.__file__}, not from {root}")
    gdev.build_kernels()
    gdev.kernels()
    out = {"root": args.root, "card": cs.nvidia_smi_line(),
           "torch_name": torch.cuda.get_device_name(0),
           "ptxas": {lib: [ln.strip() for ln in
                           gdev.build_log.get(lib, "").splitlines()
                           if "registers" in ln or "spill" in ln]
                     for lib in {gdev._SIGNATURES.get(n, ("program",))[0]
                                 for n in names}},
           "shapes": {}, "ms": {}}
    out["corpus"] = args.corpus
    runs = (referential_runs if ref else synthetic_runs)(cs, syn, args,
                                                         names)
    for name in names:
        if name not in ("review_chain", "delta_chain") and not any(
                cap.calls.get(name) for _label, cap in runs):
            raise AssertionError(f"{name}: no call on the "
                                 f"{'/'.join(lb for lb, _c in runs)} runs")
    sweep = runs[0][1]
    for label, cap in runs:
        if label.startswith("chain"):
            out["ms"][f"review_chain_{label[5:]}_pods"] = review_chain(
                cs, cap, args.reps)
            continue
        if label.startswith("delta") and not ref:
            out["ms"][f"delta_chain_w{label[5:]}"] = delta_chain(
                cs, cap, args.reps)
            continue
        if label == "delta" and "joinlookup" in names:
            out["ms"]["delta_lookup_chain"] = lookup_chain(cs, cap,
                                                           args.reps)
        for name in names:
            if not cap.calls.get(name):
                continue
            spec = specs[name]
            reset = spec.reset or (lambda p, which: None)
            a, kw, _o = max(cap.calls[name], key=lambda c: spec.size(c[0]))
            p = spec.prep(a, kw)
            key = f"{label}_{name}"
            out["shapes"][key] = spec.work(p)[2]
            reset(p, "kernel")
            reset(p, "plain")
            got = cs._tensors(spec.kernel(p))
            want = cs._tensors(spec.plain(p))
            torch.cuda.synchronize()
            if not all(torch.equal(g, w) for g, w in zip(got, want)):
                raise AssertionError(f"{label} {name}: kernel != plain")
            out["ms"][key] = cs.cuda_ms(lambda: spec.kernel(p), args.reps,
                                        setup=lambda: reset(p, "kernel"))
            if args.per_group and name == "program" and label == "sweep":
                for gi, g in enumerate(p["groups"]):
                    out["ms"][f"{key}_group{gi}"] = cs.cuda_ms(
                        lambda: program.program_eval_cuda(p["kernel"], [g]),
                        args.reps, setup=lambda: reset(p, "kernel"))
            del p
    if "match" in names and sweep.calls["match"]:
        # K1 at the sweep's shape on the seeded corpus whose selectors are
        # live
        shape = out["shapes"]["sweep_match"]
        out["ms"]["live_selectors_match"] = cs.check_match_at_size(
            shape["C"], shape["R"])["ms"]
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
