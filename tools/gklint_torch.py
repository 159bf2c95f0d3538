#!/usr/bin/env python
"""gklint for the port: tools/gklint.py's analyzer, run with the port's
own copy of it (gatekeeper_tpu_torch/analysis/), whose path-scoped rules
name gatekeeper_tpu_torch/ paths.

Checks the concurrency, tracing, failure-policy, resource-hygiene and
registry invariants this codebase has paid for at runtime (rule catalog
with incident history: docs/static-analysis.md).  Wired into tier-1 via
tests/test_torch_gklint.py.

Usage:
  python tools/gklint_torch.py [paths...]    lint (default:
                                             gatekeeper_tpu_torch/)
  python tools/gklint_torch.py --list-rules  print the rule catalog
  python tools/gklint_torch.py --format=json machine-readable findings
  python tools/gklint_torch.py --write-baseline
                                             accept current findings
  python tools/gklint_torch.py --no-baseline ignore the committed baseline

Exit status: 0 clean, 1 unsuppressed findings, 2 usage error.

Suppressions:  # gklint: disable=<rule>[,<rule>] -- <reason>
(same line, or a standalone comment line above; reason is mandatory).
File-level:    # gklint: disable-file=<rule> -- <reason>
Baseline:      .gklint-baseline.json at the repo root absorbs accepted
findings by (rule, path, scope); prefer fixing or inline suppression.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from gatekeeper_tpu_torch import analysis  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="gklint", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    ap.add_argument("paths", nargs="*", default=None,
                    help="files/directories to lint (default: "
                         "gatekeeper_tpu_torch/)")
    ap.add_argument("--format", choices=("text", "json"), default="text")
    ap.add_argument("--baseline", default=None,
                    help="baseline file (default: <repo>/"
                         f"{analysis.BASELINE_NAME} when present)")
    ap.add_argument("--no-baseline", action="store_true",
                    help="report baseline-accepted findings too")
    ap.add_argument("--write-baseline", action="store_true",
                    help="write current findings to the baseline and exit 0")
    ap.add_argument("--list-rules", action="store_true")
    ap.add_argument("--select", default=None,
                    help="comma-separated rule ids to run exclusively")
    ap.add_argument("--root", default=REPO,
                    help="repo root for relative paths + doc cross-checks")
    args = ap.parse_args(argv)

    if args.list_rules:
        width = max(len(r) for r in analysis.RULES)
        for rule in sorted(analysis.RULES):
            print(f"{rule:<{width}}  {analysis.RULES[rule]}")
        return 0

    root = os.path.abspath(args.root)
    paths = args.paths or [os.path.join(root, "gatekeeper_tpu_torch")]
    select = None
    if args.select:
        select = {r.strip() for r in args.select.split(",") if r.strip()}
        unknown = select - set(analysis.RULES)
        if unknown:
            print(f"gklint: unknown rule(s): {', '.join(sorted(unknown))}",
                  file=sys.stderr)
            return 2

    findings = analysis.lint(root, paths, select=select)

    baseline_path = args.baseline or os.path.join(
        root, analysis.BASELINE_NAME
    )
    if args.write_baseline:
        if select is not None or args.paths:
            # a baseline written from a narrowed run would silently DROP
            # every accepted finding outside the subset; the next full
            # run then fails on findings that were deliberately banked
            print(
                "gklint: --write-baseline requires a full default run "
                "(no --select, no explicit paths) — the baseline is "
                "whole-repo state, not a per-subset overlay",
                file=sys.stderr,
            )
            return 2
        analysis.write_baseline(baseline_path, findings)
        print(f"gklint: baseline written to {baseline_path} "
              f"({len(findings)} finding(s))")
        return 0
    if not args.no_baseline and os.path.exists(baseline_path):
        findings = analysis.apply_baseline(
            findings, analysis.load_baseline(baseline_path)
        )

    if args.format == "json":
        print(json.dumps(
            {"findings": [f.to_json() for f in findings],
             "count": len(findings)},
            indent=2,
        ))
    else:
        for f in findings:
            print(f.render(), file=sys.stderr)
        if findings:
            print(f"gklint: {len(findings)} unsuppressed finding(s)",
                  file=sys.stderr)
        else:
            print("gklint: ok")
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
